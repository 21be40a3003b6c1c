"""The ``fit`` kind: the program's ``train/loop.py::fit`` on one fold of a
training set, as a CV run trains each fold.

Set-up: ``train_images`` images and masks made from the seed, split in
``n_cv_splits`` (fold ``fold`` the validation set); the seeded weights
loaded into the program's model (``models.convert.load_flax_flat``) and
its train state (``SegmentationRunner.train_state``). One ``fit`` call
of ``check_steps`` steps on rows of their own, with a validation of
``warmup_valid_images``: those steps are the ones the reference
follows, and the same train state goes on into the window. The window:
one ``fit`` call on the whole fold, from its call to its return, whose
only callback times every step from outside and stops it at the first
epoch end after ``--seconds``. With ``--trace 1`` one more epoch runs
under the profiler after the window.

Traffic keys: ``batch`` (``training.batch_size_train``),
``valid_batch`` (``training.batch_size_inference``), ``fold``,
``check_steps``, ``warmup_valid_images``, ``residual_scale``: the last
BatchNorm of every residual branch starts at that share of its scale, as
a run from scratch starts near the identity (zero-init-residual, Goyal
et al. 2017). In training mode BatchNorm normalizes by the batch, and a
random network at full scale is then chaotic: bf16 rounding moves its
first logits by 17% of their norm and fp8 by 70%; at a tenth, 3% and
27% (the CPU, ResNet-34).
"""
from __future__ import annotations

import copy
import json
import sys
import time

import numpy as np
import torch

from benchmark import inputs, reference, trace, weights
from benchmark.kinds.serve import port_config
from benchmark.reference import train as ref_train
from salt_tpu_torch.train.callbacks import Callback

#: Adam's first-moment decay (the program's and the reference's)
BETA1 = 0.9


def fit_config(cfg: dict, traffic: dict):
    c = port_config(cfg, {"quant_bits": 0, "batch": traffic["valid_batch"]})
    t = c.training
    t.batch_size_train = traffic["batch"]
    t.loss = cfg["loss"]
    t.lr = cfg["lr"]
    t.l2_reg_conv = cfg["l2_reg_conv"]
    t.validate_every_n_epochs = 1
    c.model.dropout_2d = 0.0
    c.execution.shuffle = True
    c.execution.resize_target_size = cfg["resize_target_size"]
    c.execution.pad_size = cfg["pad_size"]
    return c


class Timer(Callback):
    """The window's only callback: each step's wall time (from the epoch's
    start or the step before), the steps whose loss is not finite, each
    epoch's validation time (from its last step to its end), and the stop
    at the first epoch end after ``seconds``."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.steps = []
        self.nonfinite = 0
        self.validation_s = 0.0
        self.epochs = 0
        self.t_start = None
        self._last = None

    def on_epoch_begin(self, ctx):
        self._last = time.perf_counter()
        if self.t_start is None:
            self.t_start = self._last

    def on_batch_end(self, ctx):
        now = time.perf_counter()
        self.nonfinite += not np.isfinite(ctx["batch_loss"])
        self.steps.append(now - self._last)
        self._last = now

    def on_epoch_end(self, ctx):
        self.validation_s += time.perf_counter() - self._last
        self.epochs += 1

    def training_break(self, ctx) -> bool:
        return time.perf_counter() - self.t_start >= self.seconds


class Recorder(Callback):
    """The check steps' callback: each step's loss, Adam's first moments
    after the first step (zeros where a step left none) and the
    parameters after the last, on the host; and, from a hook on the
    model's 1x1 head (``head``, the reference's ``HEAD``), the first
    step's logits."""

    def __init__(self, state, steps: int, head: str):
        self.steps = steps
        self.losses, self.first_moment, self.params = [], None, None
        self.first_logits = None
        self._names = {id(p): n for n, p in state.model.named_parameters()}
        # the first forward of the first step ends in the 1x1 head
        self._hook = state.model.get_submodule(head).register_forward_hook(
            self._logits)

    def _logits(self, module, args, out):
        self.first_logits = out.detach().float().cpu()
        self._hook.remove()

    def on_batch_end(self, ctx):
        self.losses.append(ctx["batch_loss"])
        st = ctx["state"]
        if ctx["batch_id"] == 0:
            self.first_moment = {
                self._names[id(p)]: st.optimizer.state[p].get(
                    "exp_avg", torch.zeros_like(p)).detach().float().cpu()
                .clone() for p in st.model.parameters()}
        if ctx["batch_id"] == self.steps - 1:
            self.params = {n: p.detach().float().cpu().clone()
                           for n, p in st.model.named_parameters()}


def step_tail(steps_ms) -> tuple:
    """(the 95th percentile of every step's wall in the window, the
    count of steps it is taken over)."""
    return float(np.percentile(steps_ms, 95)), len(steps_ms)


def split(n: int, splits: int, fold: int, seed: int):
    """(train, validation) indices: a seeded permutation in ``splits``
    parts, part ``fold`` the validation set."""
    perm = np.random.RandomState(seed % (1 << 32)).permutation(n)
    parts = np.array_split(perm, splits)
    return (np.sort(np.concatenate(parts[:fold] + parts[fold + 1:])),
            np.sort(parts[fold]))


class Prepared:
    """One seed's set-up: the data, the seeded weights in the program's
    train state and in the fp32 reference model (on the host), and the
    check steps already run through ``fit`` (their recorder)."""

    def __init__(self, r):
        from salt_tpu_torch.models.convert import load_flax_flat
        from salt_tpu_torch.train.callbacks import CallbackList
        from salt_tpu_torch.train.loop import fit
        from salt_tpu_torch.train.steps import SegmentationRunner

        cfg, traffic, dev, seed = r.config, r.traffic, r.device, r.seed
        bs, k = traffic["batch"], traffic["check_steps"]
        self.images_d, self.masks_d = inputs.images_and_masks(
            cfg["train_images"], seed, 4, dev)
        calib, _ = inputs.images_and_masks(8, seed, 3, dev)
        self.images = self.images_d.cpu().numpy()
        self.masks = self.masks_d.cpu().numpy()
        self.train, self.valid = split(len(self.images), cfg["n_cv_splits"],
                                       traffic["fold"], seed)
        self.check_rows = self.train[:k * bs]
        warm = self.valid[:traffic["warmup_valid_images"]]
        ref_model = weights.make_folds(cfg, 1, seed, calib,
                                       traffic["residual_scale"])[0]
        arrays = weights.flat_arrays(ref_model)
        self.ref_model = ref_model.cpu()
        self.start = {n: p.detach().clone()
                      for n, p in self.ref_model.named_parameters()}
        del calib

        self.fit = fit
        self.runner = SegmentationRunner(fit_config(cfg, traffic), dev)
        model = self.runner.build()
        load_flax_flat(model, arrays)
        self.state = self.runner.train_state(model)
        self.seed = seed % (1 << 31)
        self.rec = Recorder(self.state, k, reference.for_config(cfg).HEAD)
        fit(self.runner, self.data(self.check_rows), self.data(warm),
            callbacks=CallbackList([self.rec]), state=self.state,
            epochs=1, seed=self.seed)
        sync(dev)

    def data(self, rows):
        return self.images[rows], self.masks[rows]

    def release(self):
        """Free the program's state on the device."""
        self.state = self.runner = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference(self, r, conv=None, loss_fn=None) -> dict:
        """The reference's check steps over the same rows."""
        return reference_steps(r, self.ref_model, self.images_d,
                               self.masks_d, self.check_rows, conv, loss_fn)

    def gaps(self, ref: dict, run: dict = None):
        """:func:`gaps` of the program's check steps (or of ``run``, a
        ``first_steps`` result) against ``ref``. The gradient as the
        program's Adam took it is its first moment after one step over
        ``1 - beta1``."""
        if run is None:
            grads = {k: v / (1 - BETA1)
                     for k, v in self.rec.first_moment.items()}
            run = {"losses": self.rec.losses, "first_grad": grads,
                   "params": self.rec.params,
                   "first_logits": self.rec.first_logits}
        return gaps(run, ref, self.start)


def run(r) -> None:
    from salt_tpu_torch.train.callbacks import CallbackList

    traffic, dev = r.traffic, r.device
    bs = traffic["batch"]
    prep = Prepared(r)
    tr, va = prep.train, prep.valid

    # -- the window ---------------------------------------------------------
    r.values["setup_s"] = r.elapsed()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    timer = Timer(r.seconds)
    t0 = time.perf_counter()
    prep.fit(prep.runner, prep.data(tr), prep.data(va),
             callbacks=CallbackList([timer]), state=prep.state,
             epochs=1 << 30, seed=prep.seed, start_epoch=1)
    sync(dev)
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    steps = np.asarray(timer.steps) * 1e3
    trained = len(steps) * bs
    p95, _ = step_tail(steps)
    r.values["train_images_per_s"] = trained / window_s
    r.values["peak_mem_gib"] = peak / 2 ** 30
    r.facts.update(memory_peak_bytes=peak, window_s=window_s,
                   train_step_p95_ms=p95,
                   trained_images=trained,
                   validated_images=timer.epochs * len(va),
                   validation_s=timer.validation_s, batch=bs)
    print(f"fit: {timer.epochs} epochs, {len(steps)} steps in "
          f"{window_s:.3f} s (the first epoch began after "
          f"{timer.t_start - t0:.3f} s); step ms median {np.median(steps):.3f} p95 "
          f"{p95:.3f} over {len(steps)} steps; "
          f"validation {timer.validation_s:.3f} s; slowest steps (ms, "
          f"index) {sorted(zip(steps.round(1), range(len(steps))))[-3:]}",
          file=sys.stderr)
    r.attempted = len(steps)
    r.failed = timer.nonfinite

    if r.trace_on:
        epoch = timer.epochs + 1
        r.trace = trace.traced_call(
            lambda: prep.fit(prep.runner, prep.data(tr), prep.data(va),
                             state=prep.state, epochs=epoch + 1,
                             seed=prep.seed, start_epoch=epoch),
            {"sort_calls": len(tr) // bs
             + -(-len(va) // traffic["valid_batch"])}, dev)
    prep.release()

    # -- correctness ----------------------------------------------------------
    g = prep.gaps(prep.reference(r))
    for name in COMPARED:
        r.checks[name] = (g[name], r.limits[name])
    r.checks["nonfinite_steps"] = (timer.nonfinite,
                                   r.limits["nonfinite_steps"])
    print(f"fit: losses {prep.rec.losses}; {json.dumps(g)}",
          file=sys.stderr)


def reference_steps(r, model, images_d, masks_d, rows, conv=None,
                    loss_fn=None) -> dict:
    """The reference's first ``check_steps`` steps over ``rows`` from a
    copy of ``model``, fp32 and TF32 off, on the run's device."""
    cfg, traffic = r.config, r.traffic
    model = copy.deepcopy(model).to(r.device)
    seed = r.seed % (1 << 31)
    batches = [rows[i] for i in ref_train.batch_order(
        len(rows), traffic["batch"], seed)]
    with weights.exact_fp32():
        return ref_train.first_steps(model, images_d, masks_d, batches, seed,
                                     cfg["lr"], cfg["l2_reg_conv"], conv,
                                     loss_fn)


def gaps(run: dict, ref: dict, start: dict) -> dict:
    """The numbers of ``run`` against ``ref`` (``first_steps`` results)
    from the parameters ``start``: the first step's logits' gap, the norm
    of their difference over the reference's (compared); the first
    gradient's norm gap of the worst leaf (compared) and of the median
    leaf; the parameter change's norm gap of the worst leaf (compared);
    the first step's loss gap and the worst step's, each over the larger
    of the reference's loss and 1 (the loss of all-zero logits). A leaf's
    gap is over the larger of its reference norm and the median leaf's.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's leave the change's comparison (``leaves_in_change`` counts the
    others): Adam moves them by round-off alone."""
    steps = [abs(p - q) / max(abs(q), 1.0)
             for p, q in zip(run["losses"], ref["losses"])]
    logits = ref["first_logits"].cpu().double()
    logit_gap = float((run["first_logits"].cpu().double() - logits).norm()
                      / logits.norm())
    ref_grads = {k: v.cpu() for k, v in ref["first_grad"].items()}
    grad = ref_train.norm_gaps({k: v.cpu() for k, v in
                                run["first_grad"].items()}, ref_grads)
    norms = {k: float(v.double().norm()) for k, v in ref_grads.items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    keep = [k for k, v in norms.items() if v >= floor]
    change = ref_train.norm_gaps(
        {k: run["params"][k].cpu() - start[k] for k in keep},
        {k: ref["params"][k].cpu() - start[k] for k in keep})
    return {"logit_gap_first": logit_gap,
            "grad_gap_worst": float(grad.max()),
            "update_norm_gap": float(change.max()),
            "grad_gap_median": float(np.median(grad)),
            "loss_gap_first": steps[0], "loss_gap": max(steps),
            "leaves_in_change": len(keep)}


#: the numbers ``gaps`` gives that a fit cell compares with its limits
COMPARED = ("logit_gap_first", "grad_gap_worst", "update_norm_gap")


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
