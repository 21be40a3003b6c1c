"""Build and load the port's CUDA kernels.

Each source ``salt_tpu_torch/csrc/<name>.cu`` has a plain C interface and
is compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``salt_tpu_torch/build/`` (git-ignored), then loaded with ``ctypes``. A
library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
an unchanged one is reused. Builds run at first use,
from the sources in the checkout only; :func:`build` starts one ``nvcc``
per source, all at once, and waits for them together.

Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Iterable, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

#: kernel name -> source file under csrc/
SOURCES = {"preprocess": "preprocess.cu", "bitonic_sort": "bitonic_sort.cu",
           "conv3x3_pair": "conv3x3_pair.cu", "conv_valid": "conv_valid.cu",
           "matmul_wgmma": "matmul_wgmma.cu", "int8_quant": "int8_quant.cu",
           "int8_conv": "int8_conv.cu",
           "int8_conv_wgmma": "int8_conv_wgmma.cu"}

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": wall time of its nvcc, "log": nvcc/ptxas output}
BUILD_INFO: Dict[str, dict] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def library_path(name: str) -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in (SOURCES[name], *headers):
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile ``names`` (default: every kernel) in parallel; returns
    name -> library path. Raises with nvcc's output if any build fails."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}.",
                                   suffix=".so")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if it is missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name]
        lib = _LIBS[name] = ctypes.CDLL(path)
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of kernel library ``name``, with its
    argument types set (pointers and the stream as ``c_void_p``) and an
    ``int`` result, the launch's cudaError_t."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn
