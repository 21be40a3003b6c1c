"""The benchmark's inputs, made from ``--seed`` on the device in a few
large calls: 101x101 grayscale "seismic" images (noise about 128, std
28, horizontal banding, and in 65% of them an elliptic salt body 45
brighter) with their masks, a PNG writer for the served directory, and
the input cache that keeps one seed's files for its later runs.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

SIZE = 101
#: the share of images without salt
EMPTY = 0.35
#: seeds whose files the input cache keeps (a check's runs reuse its
#: seeds; the least recently used beyond these are removed)
CACHED_SEEDS = 8


@torch.no_grad()
def images_and_masks(n: int, seed: int, stream: int,
                     device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 images [n, 101, 101] and {0, 1} masks on ``device``; one
    ``(seed, stream)`` gives the same arrays."""
    g = torch.Generator(device).manual_seed(
        (seed * 1_000_003 + 7919 * stream + 17) % (1 << 63))

    def u(*shape):
        return torch.rand(shape, generator=g, device=device)

    yy = torch.arange(SIZE, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(SIZE, device=device, dtype=torch.float32)[None, :]
    base = 128 + 28 * torch.randn((n, SIZE, SIZE), generator=g,
                                  device=device)
    period, phase = 3 + 6 * u(n, 1, 1), 6 * u(n, 1, 1)
    base += 18 * torch.sin(yy / period + phase)
    has = u(n, 1, 1) > EMPTY
    cx, cy = 10 + (SIZE - 20) * u(n, 1, 1), 10 + (SIZE - 20) * u(n, 1, 1)
    rx, ry = 8 + 37 * u(n, 1, 1), 8 + 37 * u(n, 1, 1)
    ang = math.pi * u(n, 1, 1)
    dx, dy = xx - cx, yy - cy
    a = dx * torch.cos(ang) + dy * torch.sin(ang)
    b = -dx * torch.sin(ang) + dy * torch.cos(ang)
    blob = ((a / rx) ** 2 + (b / ry) ** 2 < 1) & has
    images = (base + 45 * blob).clamp(0, 255).to(torch.uint8)
    return images, blob.to(torch.uint8)


def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit grayscale PNG of ``img`` [H, W] uint8 (no row filter,
    zlib level 1: the noise compresses little at any level)."""
    h, w = img.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    raw = np.zeros((h, w + 1), np.uint8)
    raw[:, 1:] = img
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + chunk(b"IEND", b""))


def write_pngs(images: np.ndarray, ids: Sequence[str], directory: str,
               threads: int = 4) -> None:
    """``<directory>/<id>.png`` for each image (zlib runs outside the
    interpreter lock, so a few threads share the work)."""
    os.makedirs(directory, exist_ok=True)

    def write(i):
        with open(os.path.join(directory, f"{ids[i]}.png"), "wb") as f:
            f.write(png_bytes(images[i]))

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(write, range(len(ids))))


def image_ids(n: int, seed: int) -> list:
    """Ten-hex-digit ids in the form of the TGS set's, unique and sorted
    as the served directory lists them."""
    rng = np.random.RandomState(seed % (1 << 32))
    ids = set()
    while len(ids) < n:
        ids.update(f"{v:010x}" for v in rng.randint(0, 2 ** 40, size=n,
                                                    dtype=np.int64))
    return sorted(ids)[:n]


def cache_key(cell: str, seed: int, config: dict, traffic: dict) -> str:
    """The input cache's directory name of one seed of a cell: the
    cell, the seed, and a digest of the configuration and traffic that
    shape the files."""
    digest = hashlib.sha256(json.dumps([config, traffic], sort_keys=True)
                            .encode()).hexdigest()[:12]
    return f"{cell}.{seed}.{digest}"


def cached_dir(path: str, fill: Callable[[str], None],
               keep: int = CACHED_SEEDS) -> bool:
    """Make the directory ``path`` once: ``fill(d)`` writes its files into
    ``d`` (``<path>.part``, where a run cut short may have left one), each
    file is synced to disk, so that none of it is written back inside a
    window, and ``d`` is renamed to ``path``. Returns whether ``path`` was
    there already. Of the directories beside it, the ``keep`` most
    recently used stay."""
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    if os.path.isdir(path):
        os.utime(path)
        return True
    part = path + ".part"
    shutil.rmtree(part, ignore_errors=True)
    old = sorted((e for e in os.scandir(parent) if e.is_dir()),
                 key=lambda e: e.stat().st_mtime)
    for e in old[:max(0, len(old) - keep + 1)]:
        shutil.rmtree(e.path, ignore_errors=True)
    os.makedirs(part)
    fill(part)
    for d, _, files in os.walk(part):
        for name in files:
            fd = os.open(os.path.join(d, name), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
    os.rename(part, path)
    return False
