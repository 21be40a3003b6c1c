"""ctypes wrapper for the repository's native PNG pack decoder
(``native/pngpack.cc``, built by ``make -C native``); own copy of
``salt_tpu/data/native_png.py``. Returns None when the library is absent
or a file fails, and the caller decodes with PIL instead (same output).
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

_LIB = None
_LIB_TRIED = False


def _native_lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    so = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                      "native", "libpngpack.so"))
    if os.path.exists(so):
        try:
            lib = ctypes.CDLL(so)
            lib.png_pack.restype = ctypes.c_int
            lib.png_pack.argtypes = [
                ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            _LIB = lib
        except OSError:
            _LIB = None
    return _LIB


def pack_pngs(paths: Sequence[str], h: int, w: int,
              mask_threshold: int = -1) -> Optional[np.ndarray]:
    """Decode ``paths`` into a packed [N, h, w] uint8 array on all cores,
    or None. ``mask_threshold``: -1 = raw grayscale (channel 0); >= 0 =
    binarize at the threshold (masks)."""
    lib = _native_lib()
    if lib is None or not paths:
        return None
    blob = b"\x00".join(os.fsencode(p) for p in paths) + b"\x00"
    out = np.empty((len(paths), h, w), dtype=np.uint8)
    rc = lib.png_pack(blob, len(paths),
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                      h, w, mask_threshold, 0)
    if rc != 0:
        return None
    return out
