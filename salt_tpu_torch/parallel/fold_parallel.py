"""Fold-parallel ensemble training: the K CV folds trained as one step
(counterpart of ``salt_tpu/parallel/fold_parallel.py``:
``FoldParallelRunner`` :34-174, ``init_states`` :138-161, ``fold_state``
:170-174, ``_set_fold_lrs`` :176-182, ``_load_last_stacked`` :185-220,
``fit_fold_parallel`` :222-435).

The folds are independent programs over one architecture, so their
parameters stack on a leading fold axis and one step trains all of
them: ``torch.func.vmap`` over ``grad_and_value`` of a
``functional_call`` of the train form, one call a step for the K folds
(with K * B images, one dispatch of each op where the sequential loop
makes K). On one card that is the whole design; the fold splits and the
per-fold artifacts are the sequential loop's, so the ensemble is the
same.

What the vmapped step needs, and where it lives:

- the Lovász sort (``ops/sort_kernel.py``'s ``SortDescWithLabels``) has
  a ``vmap`` rule that sorts the K folds' rows in one launch of the
  kernel ([K, B, P] as [K * B, P]);
- BatchNorm computes its statistics itself
  (``models.blocks.functional_batch_norm``) and returns the new running
  ones, which are copied into the stacked buffers after the step; each
  fold's statistics come from its own images only;
- the augmentation runs outside the map on the K * B images at once (it
  is per image), and the channel dropout takes uniform draws made
  before the step (``models.blocks.DropoutDraws``): ``vmap`` cannot draw
  from a ``torch.Generator``. With ``align_with_sequential`` every fold
  gets the sequential loop's draws of that step;
- Adam is :func:`stacked_adam`, one update over the flat [K, N]
  parameters with a learning rate and a step count per fold; a fold
  whose ``active`` flag is off keeps its parameters, moments and BN
  statistics bit for bit (an early-stopped fold freezes).

Each fold's parameters and buffers are views into the stacked storage,
so fold k is an ordinary module (``StackedStates.fold``) that validation,
``ModelCheckpoint`` (``best.npz`` in the flat flax layout, ``last.npz``
with the port's ``torch_adam/...`` state) and ``--resume`` use as they
are.

The hybrid fold x data mesh (``parallel.fold_parallel_data_axis``): in
one process the data axis is 1 (-1, auto, resolves to 1), and a value
above the world size raises as in JAX. Under a process group of W ranks
(``parallel/mesh.py``; gloo on the CPU) the ranks form fold groups of
``n_data`` ranks each, as the JAX mesh's devices do: a group trains its
share of the folds, each rank a slice of every fold's batch, with the
gradients, the BN statistics and the loss reduced over the group's
ranks. Unlike JAX's shard_map step, the BN statistics are those of the
fold's whole batch, and the draws are the whole batch's, sliced.
"""
from __future__ import annotations

from dataclasses import fields
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from salt_tpu_torch.core.config import Config
from salt_tpu_torch.core.device import resolve_device
from salt_tpu_torch.core.logging import get_logger
from salt_tpu_torch.models.blocks import (BatchNorm2d, BatchStats,
                                          DropoutDraws,
                                          functional_batch_norm)
from salt_tpu_torch.ops.augment import AugmentParams
from salt_tpu_torch.parallel.mesh import Mesh, all_reduce_mean_
from salt_tpu_torch.train.state import TrainState, make_optimizer
from salt_tpu_torch.train.steps import SegmentationRunner

logger = get_logger()

BETAS = (0.9, 0.999)
EPS = 1e-8


def stacked_adam(params: torch.Tensor, grads: torch.Tensor,
                 exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
                 lrs: Sequence[float], steps: Sequence[int],
                 active: Sequence[bool], weight_decay: float) -> None:
    """One Adam update of K folds' flat [K, N] ``params`` and moments in
    place, ``torch.optim.Adam``'s single-tensor arithmetic (L2 added to
    the gradient, bias correction by the step) with fold k's learning
    rate ``lrs[k]`` and step count ``steps[k]`` (this step's, counted
    from 1). A fold with ``active[k]`` off keeps its values bit for
    bit."""
    b1, b2 = BETAS
    k = params.shape[0]
    steps = np.maximum(np.asarray(steps, np.float64), 1.0)
    bc1 = 1.0 - b1 ** steps
    bc2 = 1.0 - b2 ** steps
    # the per-fold scalars as torch's python-float scalars reach a kernel:
    # computed in double, rounded to the parameters' dtype
    cols = torch.tensor(np.stack([-np.asarray(lrs, np.float64) / bc1,
                                  np.sqrt(bc2),
                                  np.asarray(active, np.float64)]),
                        dtype=params.dtype).to(params.device)
    neg_step, bc2_sqrt, on = (c.view(k, 1) for c in cols)
    if weight_decay:
        grads = grads.add(params, alpha=weight_decay)
    m = exp_avg.lerp(grads, 1 - b1)
    v = exp_avg_sq.mul(b2).addcmul_(grads, grads, value=1 - b2)
    denom = (v.sqrt() / bc2_sqrt).add_(EPS)
    p = params + neg_step * (m / denom)
    if all(active):
        params.copy_(p)
        exp_avg.copy_(m)
        exp_avg_sq.copy_(v)
        return
    keep = on > 0
    params.copy_(torch.where(keep, p, params))
    exp_avg.copy_(torch.where(keep, m, exp_avg))
    exp_avg_sq.copy_(torch.where(keep, v, exp_avg_sq))


def _flat_layout(named: Sequence[Tuple[str, torch.Tensor]]):
    """(names, shapes, offsets, total) of tensors laid end to end."""
    names, shapes, offsets, off = [], [], [], 0
    for name, t in named:
        names.append(name)
        shapes.append(tuple(t.shape))
        offsets.append(off)
        off += t.numel()
    return names, shapes, offsets, off


def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    path, _, leaf = name.rpartition(".")
    return (model.get_submodule(path) if path else model), leaf


class StackedStates:
    """The train states of K folds on a leading fold axis: parameters,
    Adam moments and floating buffers (BatchNorm's running statistics)
    as flat [K, N] tensors, each fold's module holding views into them;
    a step count and a learning rate per fold (``_set_fold_lrs``'s [K]
    vector)."""

    def __init__(self, models: List[nn.Module], lr: float,
                 weight_decay: float = 0.0):
        self.models = models
        self.weight_decay = weight_decay
        k = len(models)
        self.steps = np.zeros((k,), np.int64)
        self.lrs = np.full((k,), lr, np.float64)
        if not models:
            return
        base = models[0]
        p_named = list(base.named_parameters())
        b_named = [(n, b) for n, b in base.named_buffers()
                   if b.is_floating_point()]
        self.param_layout = _flat_layout(p_named)
        self.buffer_layout = _flat_layout(b_named)
        like = p_named[0][1]
        self.params = torch.empty((k, self.param_layout[3]),
                                  dtype=like.dtype, device=like.device)
        self.buffers = torch.empty((k, self.buffer_layout[3]),
                                   dtype=like.dtype, device=like.device)
        with torch.no_grad():
            for i, model in enumerate(models):
                self._adopt(model, i, self.params, self.param_layout, True)
                self._adopt(model, i, self.buffers, self.buffer_layout,
                            False)
        self.exp_avg = torch.zeros_like(self.params)
        self.exp_avg_sq = torch.zeros_like(self.params)
        self.optimizers = [make_optimizer(m, lr, weight_decay)
                           for m in models]

    @property
    def n_folds(self) -> int:
        return len(self.models)

    @staticmethod
    def _views(flat: torch.Tensor, layout, fold: Optional[int] = None):
        names, shapes, offsets, _ = layout
        out = {}
        for name, shape, off in zip(names, shapes, offsets):
            n = int(np.prod(shape, dtype=np.int64))
            if fold is None:
                out[name] = flat[:, off:off + n].view(flat.shape[0], *shape)
            else:
                out[name] = flat[fold, off:off + n].view(shape)
        return out

    def _adopt(self, model: nn.Module, k: int, flat: torch.Tensor, layout,
               parameters: bool) -> None:
        """Copy ``model``'s tensors of ``layout`` into fold ``k`` of
        ``flat`` and make the module hold views of it."""
        for name, view in self._views(flat, layout, k).items():
            owner, leaf = _owner(model, name)
            if parameters:
                view.copy_(owner._parameters[leaf])
                owner._parameters[leaf] = nn.Parameter(view)
            else:
                view.copy_(owner._buffers[leaf])
                owner._buffers[leaf] = view

    def stacked_params(self) -> Dict[str, torch.Tensor]:
        return self._views(self.params, self.param_layout)

    def stacked_buffers(self) -> Dict[str, torch.Tensor]:
        return self._views(self.buffers, self.buffer_layout)

    def flat_grads(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        k = self.n_folds
        return torch.cat([grads[n].reshape(k, -1)
                          for n in self.param_layout[0]], dim=1)

    def set_buffers(self, new: Dict[str, torch.Tensor],
                    active: Sequence[bool]) -> None:
        """The step's new running statistics [K, ...] into the stacked
        buffers, for the active folds (a buffer the forward did not
        reach keeps its values)."""
        k = self.n_folds
        old = self.stacked_buffers()
        flat = torch.cat([new.get(n, old[n]).reshape(k, -1)
                          .to(self.buffers.dtype)
                          for n in self.buffer_layout[0]], dim=1)
        if all(active):
            self.buffers.copy_(flat)
        else:
            keep = torch.tensor(np.asarray(active), device=flat.device)
            self.buffers.copy_(torch.where(keep[:, None], flat,
                                           self.buffers))

    def fold(self, k: int) -> TrainState:
        """Fold k as a ``TrainState``: its module, and an Adam whose
        moments are views of the stacked ones (it is never stepped; it
        carries the state to ``last_arrays`` and back)."""
        model, opt = self.models[k], self.optimizers[k]
        m = self._views(self.exp_avg, self.param_layout, k)
        v = self._views(self.exp_avg_sq, self.param_layout, k)
        for name, p in model.named_parameters():
            opt.state[p] = {"step": torch.tensor(float(self.steps[k])),
                            "exp_avg": m[name], "exp_avg_sq": v[name]}
        state = TrainState(model, opt, int(self.steps[k]))
        return state.with_learning_rate(float(self.lrs[k]))

    def load_fold(self, k: int, arrays: Dict[str, np.ndarray],
                  source: str = "") -> None:
        """A ``last`` checkpoint (the port's or the JAX package's) into
        fold k: parameters, BN statistics, Adam moments, step and
        learning rate."""
        from salt_tpu_torch.models.convert import load_flax_flat
        state = self.fold(k)
        state.load_optimizer_arrays(arrays, source)
        load_flax_flat(state.model, {
            key: v for key, v in arrays.items()
            if key.startswith(("params/", "batch_stats/"))})
        m = self._views(self.exp_avg, self.param_layout, k)
        v = self._views(self.exp_avg_sq, self.param_layout, k)
        with torch.no_grad():
            for name, p in state.model.named_parameters():
                st = state.optimizer.state[p]
                m[name].copy_(st["exp_avg"])
                v[name].copy_(st["exp_avg_sq"])
        self.steps[k] = state.step
        self.lrs[k] = state.learning_rate


def _cat_params(parts: Sequence[AugmentParams]) -> AugmentParams:
    return AugmentParams(**{f.name: torch.cat([getattr(p, f.name)
                                               for p in parts])
                            for f in fields(AugmentParams)})


def _select(t: torch.Tensor, k: int, folds: Sequence[int],
            rows: slice) -> torch.Tensor:
    """Of [k * B, ...] (fold-major), the ``folds``' ``rows`` of each."""
    t = t.reshape(k, -1, *t.shape[1:])[list(folds)][:, rows]
    return t.reshape(-1, *t.shape[2:])


class FoldParallelRunner:
    """The fold-stacked train step over a ``SegmentationRunner``'s
    steps. Under a process group of W ranks the ranks form
    ``mesh_shape["fold"]`` fold groups of ``n_data`` ranks; ``folds`` are
    the folds this rank trains (all of them in one process)."""

    def __init__(self, config: Config, n_folds: int,
                 device: Union[str, torch.device] = "cuda"):
        self.config = config
        self.n_folds = n_folds
        self.device = resolve_device(device)
        world = dist.get_world_size() if dist.is_initialized() else 1
        rank = dist.get_rank() if dist.is_initialized() else 0

        def fold_span(avail: int) -> int:
            # the fold axis spans as many ranks as divide n_folds evenly
            for d in range(min(n_folds, avail), 0, -1):
                if n_folds % d == 0:
                    return d
            return 1

        knob = getattr(config.parallel, "fold_parallel_data_axis", 0)
        if knob == -1:
            # auto: the most ranks used, fold_span(W / d) * d
            best, n_data = 0, 1
            for d in range(1, world + 1):
                used = fold_span(world // d) * d
                if used > best:
                    best, n_data = used, d
        else:
            n_data = max(int(knob), 1)
        if world // n_data < 1:
            raise ValueError(
                f"fold_parallel_data_axis={n_data} exceeds the "
                f"{world} visible devices")
        self.n_data = n_data
        n_groups = fold_span(world // n_data)
        self.mesh_shape = {"fold": n_groups, "data": n_data}
        group_id, data_rank = divmod(rank, n_data)
        data_groups = ([dist.new_group(list(range(g * n_data,
                                                  (g + 1) * n_data)))
                        for g in range(n_groups)]
                       if n_data > 1 else [None] * n_groups)
        per = n_folds // n_groups
        #: the folds this rank trains (none on a rank the mesh leaves idle)
        self.folds = (list(range(group_id * per, (group_id + 1) * per))
                      if group_id < n_groups else [])
        self.data_mesh = Mesh(data_rank, n_data, self.device,
                              data_groups[group_id]
                              if group_id < n_groups else None)
        self.runner = SegmentationRunner(config, self.device)
        self._dropout_channels: Optional[List[int]] = None
        self._step = None

    # -- state -------------------------------------------------------------
    def init_states(self, seed: int = 1234,
                    identical: bool = False) -> StackedStates:
        """This rank's folds' states: fold k from ``init_state(seed +
        k)``; ``identical=True`` gives every fold ``init_state(seed)``
        (the sequential loop's: every fold calls init_state(seed))."""
        models = [self.runner.init_state(seed if identical else seed + k)
                  .model for k in self.folds]
        return self.stack(models)

    def stack(self, models: List[nn.Module]) -> StackedStates:
        """``models`` (this rank's folds, on the runner's device at their
        training precision) as one stacked state."""
        t = self.config.training
        states = StackedStates(models, t.lr, t.l2_reg_conv)
        self._step = None
        if models:
            base = models[0]
            self._base = base
            self._bn_names = {id(m): name for name, m in
                              base.named_modules()
                              if isinstance(m, BatchNorm2d)}
            self._dropout_channels = self.runner.dropout_channels(base)
        return states

    def fold_state(self, states: StackedStates, k: int) -> TrainState:
        """Local fold ``k``'s state (``StackedStates.fold``)."""
        return states.fold(k)

    def shard_fold_batch(self, *arrays):
        """[n_folds, B, ...] host arrays -> this rank's [K_local,
        B / n_data, ...] device tensors (None stays None)."""
        rows = self._rows(arrays[0].shape[1])
        return tuple(None if a is None else
                     self.runner.device_batch(
                         np.ascontiguousarray(a[self.folds][:, rows]))[0]
                     for a in arrays)

    def _rows(self, b: int) -> slice:
        if b % self.n_data:
            raise ValueError(f"a fold batch of {b} does not split over "
                             f"the data axis of {self.n_data}")
        per = b // self.n_data
        return slice(self.data_mesh.rank * per,
                     (self.data_mesh.rank + 1) * per)

    # -- the step -------------------------------------------------------------
    def draw(self, generator: torch.Generator, b: int, h: int = 101,
             w: int = 101, aligned: bool = False
             ) -> Tuple[AugmentParams, List[torch.Tensor]]:
        """One step's draws for this rank's part of every fold's [b, h, w]
        batch: (augmentation over K_local * B_local images, fold-major;
        each dropout site's uniform draws [K_local, B_local, C, 1, 1]).
        ``aligned``: every fold takes the draws the sequential step makes
        from ``generator`` (:meth:`SegmentationRunner.draw_step`); else
        one draw over all ``n_folds`` folds' images."""
        channels = self._dropout_channels or []
        k = self.n_folds
        n = b if aligned else k * b
        params, draws = self.runner.draw_step(generator, n, h, w, channels)
        if aligned:
            params = _cat_params([params] * k)
            draws = [d.repeat(k, 1, 1, 1) for d in draws]
        rows = self._rows(b)
        params = AugmentParams(**{
            f.name: _select(getattr(params, f.name), k, self.folds, rows)
            for f in fields(AugmentParams)})
        kl = len(self.folds)
        draws = [_select(d, k, self.folds, rows).reshape(kl, -1, c, 1, 1)
                 for d, c in zip(draws, channels)]
        return params, draws

    def _fold_loss(self, params, buffers, x, y, draws, depth):
        stats = BatchStats(self._bn_names)
        with functional_batch_norm(stats, self.data_mesh.group
                                   if self.n_data > 1 else None):
            logits = torch.func.functional_call(
                self._base, (params, buffers), (x,),
                {"generator": DropoutDraws(draws) if draws else None,
                 "depth": depth})
            loss = self.runner.train_loss(logits, y)
        return loss, stats.values

    def _step_fn(self, with_draws: bool, with_depth: bool):
        if self._step is None or self._step[0] != (with_draws, with_depth):
            fn = torch.func.vmap(
                torch.func.grad_and_value(self._fold_loss, has_aux=True),
                in_dims=(0, 0, 0, 0, 0 if with_draws else None,
                         0 if with_depth else None))
            self._step = ((with_draws, with_depth), fn)
        return self._step[1]

    def grads(self, states: StackedStates, x: torch.Tensor,
              y: torch.Tensor, draws: Sequence[torch.Tensor] = (),
              depths: Optional[torch.Tensor] = None):
        """The vmapped half of the step on network inputs ``x`` [K, B, 3,
        H, W] and targets ``y`` [K, B, H, W, 2]: (loss [K], flat
        gradients [K, N], new BN statistics {name: [K, C]}); over the
        data axis each is its mean over the fold group's ranks (the BN
        statistics are the group's whole batch's already)."""
        self._base.train()
        draws = list(draws)
        fn = self._step_fn(bool(draws), depths is not None)
        grads, (loss, stats) = fn(states.stacked_params(),
                                  states.stacked_buffers(), x, y,
                                  draws or None, depths)
        flat = states.flat_grads(grads)
        loss = loss.detach()
        if self.n_data > 1:
            all_reduce_mean_([flat], self.data_mesh)
            all_reduce_mean_([loss], self.data_mesh)
        return loss, flat, stats

    def train_step(self, states: StackedStates, images_u8: torch.Tensor,
                   masks_u8: torch.Tensor,
                   draws: Tuple[AugmentParams, List[torch.Tensor]],
                   active: Sequence[bool],
                   depths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step of this rank's folds on uint8 [K, B, h, w] images and
        masks (and depths [K, B, 1]) with :meth:`draw`'s draws; folds
        whose ``active`` flag is off keep their state bit for bit.
        Returns each fold's loss [K] (a tensor on the device)."""
        k, b, h, w = images_u8.shape
        if k == 0:
            return torch.zeros((0,), device=self.device)
        params, dropout = draws
        x, y = self.runner._train_inputs(images_u8.reshape(k * b, h, w),
                                         masks_u8.reshape(k * b, h, w),
                                         params)
        x = x.reshape(k, b, *x.shape[1:])
        y = y.reshape(k, b, *y.shape[1:])
        d = None
        if self.runner.use_depth:
            d = self.runner.depth_input(
                None if depths is None else depths.reshape(k * b, 1), k * b)
            d = d.reshape(k, b, 1)
        loss, flat, stats = self.grads(states, x, y, dropout, d)
        active = [bool(a) for a in active]
        states.steps += np.asarray(active, np.int64)
        with torch.no_grad():
            stacked_adam(states.params, flat, states.exp_avg,
                         states.exp_avg_sq, states.lrs, states.steps,
                         active, states.weight_decay)
            states.set_buffers(stats, active)
        return loss

    def gather(self, values: Sequence) -> list:
        """Every fold's value (in fold order) from this rank's folds'
        ``values``; over a process group, from data rank 0 of each fold
        group."""
        values = list(values)
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return values
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, (self.folds, self.data_mesh.rank,
                                       values))
        out = [None] * self.n_folds
        for folds, data_rank, vals in parts:
            if data_rank == 0:
                for k, v in zip(folds, vals):
                    out[k] = v
        return out


def _load_last_stacked(fp: FoldParallelRunner, experiment, names,
                       states: StackedStates):
    """Crash recovery: each of this rank's folds from its ``last``
    checkpoint (parameters, BN statistics, Adam state, step, learning
    rate), or fresh where a fold has none (partial resume: it starts at
    epoch 0 while its siblings restore). Returns the PER-FOLD (next
    epoch, meta): folds can sit at different epochs (an early-stopped
    fold froze where it stopped), and a single min() would apply
    already-run epochs again to folds restored ahead."""
    next_epochs, metas = [], []
    for i, k in enumerate(fp.folds):
        name = names[k]
        if not experiment.has_checkpoint(name, tag="last"):
            next_epochs.append(0)
            metas.append(None)
            continue
        states.load_fold(i, experiment.load_params(name, tag="last"),
                         experiment.checkpoint_path(name, "last"))
        meta = experiment.load_meta(name, tag="last")
        next_epochs.append(int(meta.get("epoch", -1)) + 1)
        metas.append(meta)
    return next_epochs, metas


def fit_fold_parallel(config: Config,
                      fold_data: List[Tuple[np.ndarray, np.ndarray,
                                            Optional[np.ndarray]]],
                      epochs: Optional[int] = None, seed: int = 1234,
                      valid_data: Optional[List[Tuple]] = None,
                      experiment=None, checkpoint_names=None,
                      align_with_sequential: bool = False,
                      device: Union[str, torch.device] = "cuda"):
    """Train K folds at once with the sequential loop's semantics per
    fold: the LR schedule (plateau / exponential, ``training.
    lr_schedule``), patience early stopping (a stopped fold freezes:
    parameters, BN statistics and Adam moments stay as the sequential
    run left them), ``best`` and ``last`` checkpoints, ``channels_
    <name>.jsonl`` and ``--resume`` (full, partial, and a no-op where
    every fold finished).

    ``fold_data[k]`` = (images_u8, masks_u8, depths or None) of fold k's
    train split; ``valid_data`` likewise. Returns (the stacked states of
    this rank's folds, the per-epoch history over all folds).

    ``align_with_sequential=True`` takes the sequential loop's randomness
    (the same init for every fold, each step's draws from the generator
    seeded as ``train.loop.fit`` seeds it, the same shuffle), so each
    fold equals the sequential ``fit`` up to the batched numerics."""
    from salt_tpu_torch.pipeline.api import _lr_schedule_callbacks
    from salt_tpu_torch.train.callbacks import (CallbackList, ChannelLogger,
                                                EarlyStopping,
                                                ModelCheckpoint)
    from salt_tpu_torch.train.loop import step_seed, validate

    cfg = config
    t = cfg.training
    if (t.lr_schedule or "none").lower() in ("lr_finder", "lr-finder"):
        raise ValueError("lr_finder is a per-batch single-fold diagnostic; "
                         "use the sequential path")
    k_all = len(fold_data)
    fp = FoldParallelRunner(config, k_all, device)
    local = fp.folds
    kl = len(local)
    # this rank writes a fold's artifacts only as its group's data rank 0
    writer = fp.data_mesh.rank == 0

    epochs = epochs if epochs is not None else t.epochs
    # per-fold callback stacks: the classes the sequential fit uses
    callbacks: List[CallbackList] = []
    checkpoints: List[Optional[ModelCheckpoint]] = []
    for k in local:
        items = list(_lr_schedule_callbacks(t))
        items.append(EarlyStopping(t.validation_metric_name, t.patience,
                                   t.minimize_validation_metric))
        ckpt = None
        if experiment is not None and checkpoint_names is not None \
                and writer:
            ckpt = ModelCheckpoint(
                experiment, checkpoint_names[k],
                metric_name=t.validation_metric_name,
                minimize=t.minimize_validation_metric,
                resume=cfg.execution.resume)
            items.insert(0, ckpt)
            items.append(ChannelLogger(
                experiment.directory +
                f"/channels_{checkpoint_names[k]}.jsonl"))
        checkpoints.append(ckpt)
        callbacks.append(CallbackList(items))

    states = fp.init_states(seed, identical=align_with_sequential)
    start_epoch = 0
    active = np.ones((kl,), bool)
    # the first epoch each fold trains: on resume, folds restored ahead
    # of start_epoch stay frozen until the loop reaches their epoch, so
    # no epoch is applied twice to a state that already saw it
    resume_from = np.zeros((kl,), np.int64)
    resume_meta: List[Optional[dict]] = [None] * kl
    if (cfg.execution.resume and experiment is not None
            and checkpoint_names is not None
            and any(experiment.has_checkpoint(n, tag="last")
                    for n in checkpoint_names)):
        next_epochs, metas = _load_last_stacked(fp, experiment,
                                                checkpoint_names, states)
        resume_from = np.asarray(next_epochs, np.int64)
        resume_meta = list(metas)
        # the restored learning rates carry each fold's schedule position
        unfinished = []
        for i, k in enumerate(local):
            if experiment.train_finished(checkpoint_names[k], epochs):
                # this fold's fit ended cleanly (early stop or the epoch
                # budget): keep it frozen and its artifacts as they are
                active[i] = False
                if checkpoints[i] is not None:
                    checkpoints[i].save_last = False
                unfinished.append(None)
            else:
                unfinished.append(int(resume_from[i]))
        unfinished = [e for e in fp.gather(unfinished) if e is not None]
        start_epoch = min(unfinished) if unfinished else epochs
        logger.info("fold-parallel resume from epoch %d (per-fold %s, "
                    "finished %s)", start_epoch, list(resume_from),
                    [not a for a in active])

    min_fold = min(d[0].shape[0] for d in fold_data)
    bs = min(t.batch_size_train, min_fold)
    if fp.n_data > 1:
        # the hybrid mesh: each fold's batch splits evenly over "data"
        if min_fold < fp.n_data:
            raise ValueError(
                f"fold_parallel_data_axis={fp.n_data} needs every fold "
                f"to hold at least that many examples (smallest fold "
                f"has {min_fold}) — shrink the data axis or the fold "
                "count")
        bs = max((bs // fp.n_data) * fp.n_data, fp.n_data)
    steps_per_epoch = min_fold // bs
    # the sequential fit shuffles with RandomState(seed) per fold; the
    # default decorrelates the folds' shuffles
    fold_rngs = [np.random.RandomState(seed if align_with_sequential
                                       else seed + 9973 * i)
                 for i in range(k_all)]
    generator = torch.Generator(device=fp.device)
    use_depth = fp.runner.use_depth
    history = []
    ctxs = [{"state": None, "learning_rate": float(states.lrs[i]),
             # on resume the epoch marker starts at the restored epoch, so
             # an immediate on_train_end cannot move the meta back to 0
             "epoch_id": max(int(resume_from[i]) - 1, 0),
             "batch_id": 0, "batch_loss": 0.0} for i in range(kl)]
    for i in range(kl):
        if resume_meta[i] is not None and resume_meta[i].get("early_stopped"):
            ctxs[i]["early_stopped"] = True
        callbacks[i].on_train_begin(ctxs[i])

    for epoch_id in range(start_epoch, epochs):
        epoch_active = active & (resume_from <= epoch_id)
        orders = []
        for i in range(k_all):
            idx = np.arange(fold_data[i][0].shape[0])
            if cfg.execution.shuffle:
                fold_rngs[i].shuffle(idx)
            orders.append(idx)
        losses = []
        for step in range(steps_per_epoch):
            sel = [orders[i][step * bs:(step + 1) * bs] for i in range(k_all)]
            imgs = np.stack([fold_data[i][0][sel[i]] for i in range(k_all)])
            msks = np.stack([fold_data[i][1][sel[i]] for i in range(k_all)])
            deps = None
            if use_depth:
                deps = np.stack([
                    np.zeros((bs, 1), np.float32) if fold_data[i][2] is None
                    else fold_data[i][2][sel[i]].reshape(-1, 1)
                    .astype(np.float32) for i in range(k_all)])
            di, dm, dd = fp.shard_fold_batch(imgs, msks, deps)
            generator.manual_seed(step_seed(seed, epoch_id, step))
            draws = fp.draw(generator, bs, *imgs.shape[2:],
                            aligned=align_with_sequential)
            losses.append(fp.train_step(states, di, dm, draws, epoch_active,
                                        dd))
        mean_loss = (torch.stack(losses).mean(dim=0).cpu().numpy()
                     if losses else np.full((kl,), np.nan))
        record = {"epoch": epoch_id,
                  "train_loss": [float(v) for v in
                                 fp.gather(mean_loss.tolist())],
                  "lr": [float(v) for v in fp.gather(states.lrs.tolist())],
                  "active": [bool(a) for a in
                             fp.gather(epoch_active.tolist())]}

        fold_scores: List[Optional[dict]] = [None] * kl
        for i in range(kl):
            if not epoch_active[i]:
                continue
            ctx = ctxs[i]
            ctx["epoch_id"] = epoch_id
            ctx["train_loss"] = float(mean_loss[i])
            ctx["learning_rate"] = float(states.lrs[i])
            ctx["state"] = fp.fold_state(states, i)
            if valid_data is not None:
                val = validate(fp.runner, ctx["state"],
                               *valid_data[local[i]], compute_loss=False)
                fold_scores[i] = val
                ctx["validation"] = val
            callbacks[i].on_epoch_end(ctx)
            new_lr = callbacks[i].new_learning_rate(ctx)
            if new_lr is not None:
                states.lrs[i] = new_lr
                ctx["learning_rate"] = float(new_lr)
            if callbacks[i].training_break(ctx):
                logger.info("fold %d early-stopped at epoch %d", local[i],
                            epoch_id)
                active[i] = False
                ctx["early_stopped"] = True
                if checkpoints[i] is not None:
                    # the clean-end marker now: a crash later in the run
                    # must not resume (and retrain) a fold that stopped
                    checkpoints[i]._save_last(ctx, finished=True,
                                              early_stopped=True)
        if valid_data is not None:
            record["val"] = fp.gather(fold_scores)
            logger.info("epoch %d fold IOUTs: %s", epoch_id,
                        [round(v["iout"], 4) if v else None
                         for v in record["val"]])
        history.append(record)
        if not any(fp.gather(active.tolist())):
            logger.info("all folds early-stopped at epoch %d", epoch_id)
            break

    for i in range(kl):
        ctxs[i]["state"] = fp.fold_state(states, i)
        callbacks[i].on_train_end(ctxs[i])
    return states, history
