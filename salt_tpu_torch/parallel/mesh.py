"""Data parallelism over ``torch.distributed`` (counterpart of
``salt_tpu/parallel/mesh.py`` :21-49: ``make_mesh``, ``shard_batch``,
``pad_to_multiple``).

Where the JAX package shards the batch over a ``jax.sharding.Mesh`` and
GSPMD inserts the gradient and BatchNorm reductions, the port runs one
process per rank in a process group: gloo on the CPU, NCCL on the card
(one card: world size 1 there; a world above 1 runs on the CPU). Every
rank holds the whole host batch and the same generator, takes its slice
(:func:`shard_batch`) and:

- normalises with the statistics of the group's whole batch:
  ``models.blocks.BatchNorm2d``'s functional forward all-reduces the
  per-channel sum, then the sum of squares about the mean, and moves the
  running variance by the biased variance (``nn.SyncBatchNorm`` would
  move it by the unbiased one);
- all-reduces the gradients as their mean over ranks before Adam.

So :func:`data_parallel_train_step` equals the one-process step on the
whole batch for a loss that is a mean over images (the Lovász hinge per
image, the default), as ``tests/test_mesh_equivalence.py`` holds the JAX
mesh to.

:func:`all_reduce_sum` is differentiable (its backward all-reduces the
gradient) and maps under ``torch.func.vmap`` as one collective over the
whole mapped tensor, so the fold-parallel step's BatchNorm can reduce
over its data axis too (``parallel/fold_parallel.py``).
"""
from __future__ import annotations

import os
import pickle
import socket
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from salt_tpu_torch.core.device import resolve_device


@dataclass
class Mesh:
    """A process group seen from one rank: ``group`` None is the default
    group (the whole world)."""
    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group) if dist.is_initialized() else ""


def free_port() -> int:
    """A TCP port free on localhost now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(rank: int = 0, world_size: int = 1,
                       port: Optional[int] = None,
                       device="cuda") -> Mesh:
    """Join (or start) the default process group at
    ``tcp://localhost:<port>``: NCCL for ``device`` cuda, gloo for the
    CPU. On the card each rank takes card ``rank``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{port or free_port()}",
            rank=rank, world_size=world_size)
    return Mesh(dist.get_rank(), dist.get_world_size(), dev)


def make_mesh(n_devices: int = 0, device="cuda") -> Mesh:
    """The data-parallel mesh over the first ``n_devices`` ranks of the
    default group (0 = all; a world of one where none was started).
    Every rank must call it (a subgroup is a collective)."""
    if not dist.is_initialized():
        if n_devices > 1:
            raise ValueError(f"requested {n_devices} devices, have 1 (no "
                             "process group: init_process_group first)")
        return init_process_group(0, 1, device=device)
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    if n == world:
        return Mesh(rank, world, dev)
    group = dist.new_group(list(range(n)))
    return Mesh(rank if rank < n else -1, n, dev, group)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_batch(batch, mesh: Mesh):
    """This rank's slice of the leading (batch) axis of an array, a
    tensor, or a tuple / list of them; the axis must divide evenly."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh) for b in batch)
    if batch is None:
        return None
    n = batch.shape[0]
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not split over "
                         f"{mesh.size} ranks")
    per = n // mesh.size
    return batch[mesh.rank * per:(mesh.rank + 1) * per]


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks; the gradient is summed the same way
    (each rank's loss reaches every rank's input through the sum)."""

    @staticmethod
    def forward(x: torch.Tensor, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        if in_dims[0] is None:
            return _AllReduceSum.apply(x, group), None
        return _AllReduceSum.apply(x, group), in_dims[0]


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The differentiable sum of ``x`` over ``group``'s ranks."""
    return _AllReduceSum.apply(x, group)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Every tensor of ``tensors`` (one dtype and device) replaced in
    place by its mean over the mesh, in one collective (none without a
    process group)."""
    tensors = list(tensors)
    if not dist.is_initialized() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def all_gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' ``x`` (one shape each) concatenated in rank order."""
    if mesh.size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


def data_parallel_train_step(runner, state, images_u8: torch.Tensor,
                             masks_u8: torch.Tensor,
                             generator: torch.Generator, mesh: Mesh,
                             depths: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """One train step of the whole batch ``images_u8`` / ``masks_u8``
    [B, 101, 101] (every rank passes all of it and the same generator
    state) with this rank computing its slice: the step's draws are
    made for the whole batch in ``train_step``'s order and sliced, the
    forward's BatchNorm reduces over the mesh, the gradients are
    averaged over it, and each rank's Adam then takes the same step.
    Returns the loss of the whole batch (the ranks' mean)."""
    from salt_tpu_torch.models.blocks import (DropoutDraws,
                                              functional_batch_norm)
    model = state.model
    b, h, w = images_u8.shape
    params, draws = runner.draw_step(generator, b, h, w,
                                     runner.dropout_channels(model))
    params = type(params)(**{k: shard_batch(v, mesh)
                             for k, v in vars(params).items()})
    x, y = runner._train_inputs(shard_batch(images_u8, mesh),
                                shard_batch(masks_u8, mesh), params)
    model.train()
    # None is "no reduction" to BatchNorm; the default group is WORLD. In
    # a process group of one the reductions still run (through NCCL on
    # the card), and are the identity
    group = (mesh.group or dist.group.WORLD) if dist.is_initialized() \
        else None
    with functional_batch_norm(None, group):
        logits = model(x, DropoutDraws([shard_batch(d, mesh)
                                        for d in draws]),
                       depth=runner.depth_input(shard_batch(depths, mesh),
                                                x.shape[0]))
        loss = runner.train_loss(logits, y)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    all_reduce_mean_([p.grad for p in model.parameters()
                      if p.grad is not None], mesh)
    state.optimizer.step()
    state.step += 1
    loss = loss.detach().clone()
    all_reduce_mean_([loss], mesh)
    return loss


def predict_dataset(runner, model, images: np.ndarray, mesh: Mesh,
                    depths: Optional[np.ndarray] = None,
                    batch_size: int = 0, tta: bool = False) -> np.ndarray:
    """``runner.predict_dataset`` with the images split over the mesh:
    padded with zero images to a multiple of ``mesh.size`` batches, each
    rank predicting its slice, the slices gathered in order."""
    bs = batch_size or runner.config.training.batch_size_inference
    n = images.shape[0]
    total = pad_to_multiple(max(n, 1), bs * mesh.size)
    padded = np.zeros((total, *images.shape[1:]), images.dtype)
    padded[:n] = images
    d = None
    if depths is not None:
        d = np.zeros((total,), np.float32)
        d[:n] = np.asarray(depths, np.float32).reshape(-1)
    local = runner.predict_dataset(model, shard_batch(padded, mesh),
                                   shard_batch(d, mesh), bs, tta)
    out = all_gather_batch(torch.from_numpy(local).to(mesh.device), mesh)
    return out.cpu().numpy()[:n]


def _spawned(rank: int, world_size: int, port: int, fn: Callable,
             args: tuple, result_path: str) -> None:
    torch.set_num_threads(1)
    mesh = init_process_group(rank, world_size, port, "cpu")
    try:
        out = fn(mesh, *args)
        if rank == 0:
            with open(result_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_group(fn: Callable, world_size: int, *args):
    """Run ``fn(mesh, *args)`` on ``world_size`` new processes (spawned,
    gloo on the CPU, one torch thread each: a world above 1 runs only on
    the CPU) in one process group at a free localhost port and return
    rank 0's result; ``fn``, its arguments and its result must pickle. A
    failing rank raises here. The processes have ended on return."""
    import tempfile

    import torch.multiprocessing as mp
    env_threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "rank0.pkl")
            mp.start_processes(_spawned, args=(world_size, free_port(),
                                               fn, args, path),
                               nprocs=world_size, join=True,
                               start_method="spawn")
            with open(path, "rb") as f:
                return pickle.load(f)
    finally:
        if env_threads is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env_threads
