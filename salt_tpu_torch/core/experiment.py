"""Experiment directory and flat-npz checkpoints, the format both
packages read and write (counterpart of ``salt_tpu/core/experiment.py``
:34-301).

A checkpoint is one ``np.savez`` archive whose keys are the '/'-joined
flax paths of the model variables, ``params/<module path>/<leaf>`` and
``batch_stats/<module path>/<leaf>`` (``_path_str`` of the JAX package
joins the same names). ``models.convert`` maps these keys to and from
the port's modules, so each package serves the other's ``best.npz``. A
``last.npz`` the port writes adds its own Adam state under
``torch_adam/`` (``train.state``).

Where the JAX ``Experiment`` takes pytrees, the port's takes the flat
``{key: ndarray}`` dicts directly (``TrainState.variables`` /
``last_arrays``), already on the host.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import hashlib
import io
import json
import os
import shutil
import struct
import tempfile
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
from numpy.lib import format as npy_format

from salt_tpu_torch.core.logging import get_logger

logger = get_logger()


def save_flat_npz(path: str, arrays: Dict[str, np.ndarray],
                  compressed: bool = False) -> str:
    """Write ``arrays`` atomically (temp file + ``os.replace``), creating
    the parent directory; an interrupted save leaves any previous file
    intact."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=parent or ".",
                               prefix=os.path.basename(path) + ".tmp.",
                               suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            (np.savez_compressed if compressed else np.savez)(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    return path


def _atomic_write_text(path: str, text: str) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=parent or ".",
                               prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def load_flat_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def read_flat_npz(path: str) -> Tuple[Dict[str, np.ndarray], str]:
    """:func:`load_flat_npz` and the file's SHA-256 hex digest (what
    ``pipeline/quality.py::file_sha256`` gives), from one read of the
    file. A stored (uncompressed) member's array is a read-only view of
    the bytes read, once its CRC-32 matches; a compressed one is inflated
    as ``np.load`` does. A damaged archive raises ``np.load``'s
    ``zipfile.BadZipFile``."""
    with open(path, "rb") as f:
        data = f.read()
    digest = hashlib.sha256(data).hexdigest()
    arrays = {}
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        for info in zf.infolist():
            key = info.filename.removesuffix(".npy")
            if info.compress_type != zipfile.ZIP_STORED:
                with zf.open(info) as member:
                    arrays[key] = npy_format.read_array(member)
                continue
            arrays[key] = _stored_npy(data, info)
    return arrays, digest


def _stored_npy(data: bytes, info: zipfile.ZipInfo) -> np.ndarray:
    """The array of the stored ``.npy`` member ``info`` of the zip archive
    ``data``, as a view of ``data``."""
    at = info.header_offset
    name_len, extra_len = struct.unpack("<HH", data[at + 26:at + 30])
    start = at + 30 + name_len + extra_len
    member = memoryview(data)[start:start + info.file_size]
    if zlib.crc32(member) != info.CRC:
        raise zipfile.BadZipFile(f"Bad CRC-32 for file {info.filename!r}")
    head = io.BytesIO(member[:1 << 16])
    version = npy_format.read_magic(head)
    read_header = (npy_format.read_array_header_1_0 if version == (1, 0)
                   else npy_format.read_array_header_2_0)
    shape, fortran_order, dtype = read_header(head)
    if dtype.hasobject:
        raise ValueError(f"{info.filename}: object arrays are not loaded")
    count = int(np.prod(shape, dtype=np.int64))
    return np.frombuffer(member, dtype, count, head.tell()).reshape(
        shape, order="F" if fortran_order else "C")


def checkpoint_path(experiment_dir: str, name: str = "network",
                    tag: str = "best") -> str:
    """``<dir>/checkpoints/<name>/<tag>.npz`` (the JAX ``Experiment``
    layout; CV folds are ``network_fold_<i>``)."""
    return os.path.join(experiment_dir, "checkpoints", name, f"{tag}.npz")


def add_fold_suffix(name: str, fold_id: int) -> str:
    """Per-fold artifact namespacing (reference: main.py:873-879)."""
    return f"{name}_fold_{fold_id}"


class Experiment:
    """Filesystem layout (the JAX package's)::

        <dir>/
          checkpoints/<name>/best.npz (+ best.json meta)
          checkpoints/<name>/last.npz (+ last.json meta; resume)
          outputs/<name>.npz          persisted predictions
          config.json, validation_results.json, channels_<name>.jsonl
    """

    def __init__(self, directory: str, overwrite: bool = False,
                 clone_from: str = ""):
        self.directory = directory
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._futures: Dict[tuple, concurrent.futures.Future] = {}
        self._orphans: List[concurrent.futures.Future] = []
        if clone_from and not os.path.exists(directory):
            logger.info("cloning experiment dir from %s", clone_from)
            shutil.copytree(clone_from, directory)
        if overwrite and os.path.exists(directory):
            shutil.rmtree(directory)
        os.makedirs(os.path.join(directory, "checkpoints"), exist_ok=True)
        os.makedirs(os.path.join(directory, "outputs"), exist_ok=True)

    # -- checkpoints ---------------------------------------------------
    def checkpoint_dir(self, name: str) -> str:
        d = os.path.join(self.directory, "checkpoints", name)
        os.makedirs(d, exist_ok=True)
        return d

    def checkpoint_path(self, name: str, tag: str = "best") -> str:
        return os.path.join(self.checkpoint_dir(name), f"{tag}.npz")

    def has_checkpoint(self, name: str, tag: str = "best") -> bool:
        self.flush_saves()
        return os.path.exists(self.checkpoint_path(name, tag))

    def train_finished(self, name: str,
                       epochs: Optional[int] = None) -> bool:
        """True when this model's fit ended cleanly and would not train
        further under ``epochs``: it early-stopped, or reached the
        budget (``ModelCheckpoint`` marks the last meta at train end)."""
        meta = self.load_meta(name, tag="last")
        if not (self.has_checkpoint(name) and meta.get("finished")):
            return False
        if meta.get("early_stopped"):
            return True
        return epochs is not None and int(meta.get("epoch", -1)) + 1 >= epochs

    def save_params(self, name: str, arrays: Dict[str, np.ndarray],
                    tag: str = "best", meta: Optional[dict] = None) -> str:
        """Write flat ``arrays`` as ``<tag>.npz`` (and ``meta`` as
        ``<tag>.json``), atomically."""
        path = save_flat_npz(self.checkpoint_path(name, tag), arrays)
        if meta is not None:
            _atomic_write_text(os.path.join(self.checkpoint_dir(name),
                                            f"{tag}.json"), json.dumps(meta))
        return path

    def save_params_async(self, name: str, arrays: Dict[str, np.ndarray],
                          tag: str = "best",
                          meta: Optional[dict] = None) -> None:
        """:meth:`save_params` from one background writer thread.
        ``arrays`` are host copies already, so training may go on; a
        still-queued save of the same (name, tag) is superseded. Readers
        flush first."""
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-writer")
        prev = self._futures.get((name, tag))
        if prev is not None and not prev.cancel():
            self._orphans.append(prev)
        self._futures[(name, tag)] = self._executor.submit(
            self.save_params, name, arrays, tag, meta)

    def flush_saves(self) -> None:
        """Wait for every pending write; re-raise the first writer error
        after all have finished."""
        futures = list(self._futures.values()) + self._orphans
        self._futures.clear()
        self._orphans.clear()
        first_err = None
        for f in futures:
            if f.cancelled():
                continue
            try:
                f.result()
            except Exception as e:     # re-raised below, after the others
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err

    def load_params(self, name: str, tag: str = "best"
                    ) -> Dict[str, np.ndarray]:
        self.flush_saves()
        return load_flat_npz(self.checkpoint_path(name, tag))

    def load_meta(self, name: str, tag: str = "best") -> dict:
        self.flush_saves()
        p = os.path.join(self.checkpoint_dir(name), f"{tag}.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    # -- outputs ---------------------------------------------------------
    def output_path(self, name: str) -> str:
        return os.path.join(self.directory, "outputs", f"{name}.npz")

    def save_predictions(self, name: str, ids: List[str],
                         images: np.ndarray) -> str:
        """Predictions keyed by image id (``outputs/<name>.npz``)."""
        return save_flat_npz(self.output_path(name),
                             {"ids": np.array(ids, dtype=object),
                              "images": np.asarray(images)}, compressed=True)

    def load_predictions(self, name: str) -> Dict[str, Any]:
        """``{"ids": [...], "images": ndarray}`` of ``outputs/<name>.npz``,
        as either package wrote it."""
        with np.load(self.output_path(name), allow_pickle=True) as data:
            return {"ids": list(data["ids"]), "images": data["images"]}

    def has_output(self, name: str) -> bool:
        return os.path.exists(self.output_path(name))

    def save_json(self, name: str, payload: Any) -> str:
        path = os.path.join(self.directory, f"{name}.json")
        _atomic_write_text(path, json.dumps(payload, indent=2, default=float))
        return path

    def load_json(self, name: str) -> Any:
        with open(os.path.join(self.directory, f"{name}.json")) as f:
            return json.load(f)
