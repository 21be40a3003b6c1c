"""Typed configuration tree for salt_tpu_torch.

The port keeps its own copy of ``salt_tpu/core/config.py``: the same
sections, fields, defaults and loaders, so a ``config.json`` or YAML
written for one package configures the other identically. Comments that
cite JAX-side measurements describe the reference package.

The original replaces the reference's three-layer config (env vars -> neptune.yaml ->
giant literal CONFIG AttrDict -> module flags; reference: neptune.yaml:1-81,
main.py:36-44,71-292, common_blocks/utils.py:31-43) with one dataclass tree.
Every hyperparameter of the reference is represented; YAML files in the
reference's ``parameters:`` layout load directly via :func:`load_config`.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Optional

import yaml


@dataclass
class PathsConfig:
    # data paths (reference: neptune.yaml:8-13)
    train_images_dir: str = "data/raw/train"
    test_images_dir: str = "data/raw/test"
    metadata_filepath: str = "data/meta/metadata.csv"
    depths_filepath: str = "data/meta/depths.csv"
    auxiliary_metadata_filepath: str = "data/meta/auxiliary_metadata.csv"
    stacking_data_dir: str = "data/stacking_data"
    experiment_dir: str = "output/experiment"


@dataclass
class ExecutionConfig:
    # reference: neptune.yaml:16-29 + main.py:36-44 module flags
    experiment_name: str = "salt-tpu"
    overwrite: bool = False
    clone_experiment_dir_from: str = ""
    dev_mode: bool = False
    dev_mode_size: int = 100
    n_cv_splits: int = 6
    shuffle: bool = True
    seed: int = 1234            # reference: main.py:57 SEED=1234 for CV splits
    loader_mode: str = "resize_and_pad"   # 'crop_and_pad' | 'resize_and_pad' | 'resize'
    pad_method: str = "edge"              # 'edge' | 'reflect' | 'replicate' | 'zero'
    resize_target_size: int = 102
    pad_size: int = 13                    # 102 + 2*13 = 128
    image_source: str = "memory"          # packed-array dataset ('disk' kept for parity)
    use_depth: bool = False               # main.py:43 USE_DEPTH
    use_auxiliary_data: bool = False      # main.py:44 USE_AUXILIARY_DATA
    second_level: bool = False            # main.py:42 SECOND_LEVEL (stacking)
    fine_tuning: bool = False             # neptune.yaml:40
    resume: bool = False                  # continue from the 'last' checkpoint
    num_workers: int = 4                  # host prefetch threads
    prefetch_buffers: int = 2             # double-buffered device feed
    # persist decoded uint8 packs as memmappable .npy ("" = off): later
    # runs skip the PNG decode entirely (see data/bundle.py)
    pack_cache_dir: str = ""


@dataclass
class ImageConfig:
    # reference: neptune.yaml:32-34; raw TGS images are 101x101 grayscale
    h: int = 128
    w: int = 128
    channels: int = 3
    raw_h: int = 101
    raw_w: int = 101


@dataclass
class ModelConfig:
    # reference: neptune.yaml:37-48, models.py:15-64 registry defaults
    architecture: str = "UNetResNet"
    encoder_depth: int = 34
    num_classes: int = 2                  # network_output_channels
    activation: str = "sigmoid"           # network_activation
    num_filters: int = 32
    dropout_2d: float = 0.0
    use_hypercolumn: bool = True
    # "sum" = sliced-kernel per-branch convs (exact same math/params,
    # avoids materializing the concat); "concat" = literal reference
    # formulation. Checkpoint-compatible either way. These set the
    # PREDICT graphs; the train graph always uses "concat" (faster to
    # differentiate — see models/unet.py UNetTrunk docstring).
    hypercolumn_impl: str = "sum"
    decoder_impl: str = "sum"
    # reference-parity modes (models/blocks.py docstring): "same" uses
    # centered SAME padding; "reference" reproduces the reference's
    # asymmetric top+right replication pad (base.py:26-31).
    # "half_pixel" is jax.image.resize bilinear; "align_corners"
    # reproduces torch-0.3.1 nn.Upsample — needed when importing a
    # reference-trained full-model checkpoint (torch_import.py).
    conv_pad_mode: str = "same"
    upsample_mode: str = "half_pixel"
    pretrained: bool = False              # graft pretrained encoder weights at init
    # torch .pth/.pt or converted .npz encoder checkpoint; required when
    # pretrained=True (the reference auto-downloads ImageNet weights,
    # encoders.py:10-19 — this environment has no egress)
    pretrained_weights_path: str = ""
    pool0: bool = False
    # inference-only int8 conv quantization: 0 = off, 8 = int8 (not
    # ported: the model registry refuses it). Training always runs full
    # precision; checkpoints are identical either way.
    quant_bits: int = 0
    # inference-only 3x3 conv kernel for the 64-wide encoder, decoder and
    # head convs of the predict steps (ops/conv_pair.py, csrc/
    # conv3x3_pair.cu): "on", "auto" (= on for tensors on the card) or
    # "off" (cuDNN convs). Same math as the plain conv (fp32-accumulated
    # bf16); training always uses the plain convs, checkpoints identical
    # either way. Its times beside cuDNN's are in PERF.md.
    pallas_conv: str = "off"
    # scratch SaltUNet knobs (neptune.yaml:43-48)
    nr_outputs: int = 1
    n_filters: int = 16
    conv_kernel: int = 3
    pool_kernel: int = 3
    pool_stride: int = 2
    repeat_blocks: int = 4
    # LargeKernelMatters (models.py:42-46)
    kernel_size: int = 9
    internal_kernel_size: int = 1
    # StackingFCN (models.py:52-57)
    input_model_nr: int = 18
    filter_nr: int = 32


@dataclass
class TrainingConfig:
    # reference: neptune.yaml:52-74
    loss: str = "lovasz"                  # 'lovasz' | 'lovasz_size_weighted' | 'bce' | 'dice' | 'mixed_dice_bce' | 'mixed_dice_ce' | 'focal' | 'focal_weighted'
    epochs: int = 10000
    # Epoch budget for the stacking second level only (None = inherit
    # ``epochs``). The reference trains its SECOND_LEVEL to plateau
    # (neptune.yaml epochs_nr=10000 + patience); when a short --epochs
    # is used for the first level, the tiny StackingFCN head needs far
    # more steps at lr 1e-4 to converge — this knob decouples the two.
    stacking_epochs: Optional[int] = None
    # Learning rate for the stacking second level only (None = inherit
    # ``lr``). The reference shares one lr (1e-4) across both levels;
    # measured here (stack_probe, round 3): the tiny StackingFCN head
    # converges ~10x faster at 1e-3 with identical final IoU.
    stacking_lr: Optional[float] = None
    batch_size_train: int = 24
    batch_size_inference: int = 24
    lr: float = 1e-4
    momentum: float = 0.9
    patience: int = 20                    # early stopping
    validation_metric_name: str = "iout"
    minimize_validation_metric: bool = False
    lr_schedule: str = "plateau"          # 'plateau' | 'exponential' | 'lr_finder' | 'none'
    gamma: float = 0.95                   # exponential LR decay
    reduce_factor: float = 0.1            # plateau decay
    reduce_patience: int = 10
    min_lr: float = 1e-7
    l2_reg_conv: float = 1e-4             # weight decay (models.py:289-297)
    l2_reg_dense: float = 0.0
    dropout_conv: float = 0.0
    dropout_dense: float = 0.0
    use_batch_norm: bool = True
    dtype: str = "bfloat16"               # compute dtype on TPU (MXU-friendly)
    validate_every_n_epochs: int = 1
    log_every_n_steps: int = 50
    # input|prediction|target triptych PNGs every N epochs (0 = off) —
    # the reference's NeptuneMonitor image channel (callbacks.py:327-446,
    # image_every/image_nr wired at models.py:300-312)
    validation_images_every: int = 0
    validation_image_nr: int = 8
    # distillation (pipeline/distill.py — no reference counterpart; the
    # TPU-first route to the 5000 img/s serving target): weight of the
    # soft teacher-probability BCE vs the hard-mask ``loss`` term
    distill_alpha: float = 0.75


@dataclass
class PostprocessingConfig:
    # reference: neptune.yaml:79-80, main.py:282-292
    threshold_masks: float = 0.5
    use_tta: bool = False                 # route inference through network_tta
    tta_aggregation_method: str = "mean"  # 'mean' | 'max' | 'min' | 'gmean'
    tta_flip_ud: bool = False
    tta_flip_lr: bool = True              # reference tta_generator: flip_lr only
    tta_rotation: bool = False
    tta_color_shift_runs: int = 0


@dataclass
class ParallelConfig:
    """TPU sharding policy — the reference's only parallelism is
    single-node nn.DataParallel (reference: common_blocks/models.py:81-85);
    here data-parallelism runs over a jax Mesh with psum gradient reduction
    on ICI, and fold-ensembles may map onto disjoint device groups."""
    data_axis: str = "data"
    n_devices: int = 0                    # 0 = all visible devices
    fold_parallel: bool = False           # train CV folds on disjoint device groups
    # reproduce the sequential CV loop's randomness exactly in
    # fold-parallel mode (same init seed / aug keys / shuffle order per
    # fold — the configuration covered by the sequential-equivalence
    # test); False keeps per-fold seeds distinct for ensemble diversity
    fold_parallel_aligned: bool = False
    # HYBRID fold x data mesh: additionally shard each fold's batch over
    # this many devices (grads/BN-stats pmean'd on ICI inside the fold
    # group). 0/1 = off (one device per fold group); -1 = auto (fill the
    # devices the fold axis leaves idle, e.g. 6 folds on 8 chips ->
    # fold=2 x data=4). Lets a CV run use ALL chips when n_folds does
    # not divide the device count. Per-shard aug/dropout streams are
    # decorrelated by axis index (not sequential-identical; see
    # steps.py make_train_step).
    fold_parallel_data_axis: int = 0


@dataclass
class Config:
    paths: PathsConfig = field(default_factory=PathsConfig)
    execution: ExecutionConfig = field(default_factory=ExecutionConfig)
    image: ImageConfig = field(default_factory=ImageConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    postpro: PostprocessingConfig = field(default_factory=PostprocessingConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def replace(self, **sections: Any) -> "Config":
        return dataclasses.replace(self, **sections)

    def to_dict(self) -> dict:
        """Nested {section: {field: value}} dict (the native-YAML layout
        load_config reads back); persisted as <exp_dir>/config.json at
        fit time so inference entry points can reconstruct the trained
        model without the caller re-stating every model.* flag (the
        reference gets this for free from steppy's pickled transformers,
        reference: common_blocks/utils.py:462-467)."""
        return dataclasses.asdict(self)


def default_config() -> Config:
    return Config()


# neptune.yaml 'parameters:' key -> (section, field) mapping for flat-yaml loading
_FLAT_KEY_MAP = {
    "train_images_dir": ("paths", "train_images_dir"),
    "test_images_dir": ("paths", "test_images_dir"),
    "metadata_filepath": ("paths", "metadata_filepath"),
    "depths_filepath": ("paths", "depths_filepath"),
    "auxiliary_metadata_filepath": ("paths", "auxiliary_metadata_filepath"),
    "stacking_data_dir": ("paths", "stacking_data_dir"),
    "overwrite": ("execution", "overwrite"),
    "loader_mode": ("execution", "loader_mode"),
    "pad_method": ("execution", "pad_method"),
    "resize_target_size": ("execution", "resize_target_size"),
    "pad_size": ("execution", "pad_size"),
    "dev_mode_size": ("execution", "dev_mode_size"),
    "n_cv_splits": ("execution", "n_cv_splits"),
    "shuffle": ("execution", "shuffle"),
    "image_source": ("execution", "image_source"),
    "fine_tuning": ("execution", "fine_tuning"),
    "num_workers": ("execution", "num_workers"),
    "image_h": ("image", "h"),
    "image_w": ("image", "w"),
    "image_channels": ("image", "channels"),
    "network_output_channels": ("model", "num_classes"),
    "network_activation": ("model", "activation"),
    "architecture": ("model", "architecture"),
    "nr_network_outputs": ("model", "nr_outputs"),
    "n_filters": ("model", "n_filters"),
    "conv_kernel": ("model", "conv_kernel"),
    "pool_kernel": ("model", "pool_kernel"),
    "pool_stride": ("model", "pool_stride"),
    "repeat_blocks": ("model", "repeat_blocks"),
    "epochs_nr": ("training", "epochs"),
    "batch_size_train": ("training", "batch_size_train"),
    "batch_size_inference": ("training", "batch_size_inference"),
    "lr": ("training", "lr"),
    "momentum": ("training", "momentum"),
    "patience": ("training", "patience"),
    "validation_metric_name": ("training", "validation_metric_name"),
    "minimize_validation_metric": ("training", "minimize_validation_metric"),
    "gamma": ("training", "gamma"),
    "reduce_factor": ("training", "reduce_factor"),
    "reduce_patience": ("training", "reduce_patience"),
    "min_lr": ("training", "min_lr"),
    "use_batch_norm": ("training", "use_batch_norm"),
    "l2_reg_conv": ("training", "l2_reg_conv"),
    "l2_reg_dense": ("training", "l2_reg_dense"),
    "dropout_conv": ("training", "dropout_conv"),
    "dropout_dense": ("training", "dropout_dense"),
    "threshold_masks": ("postpro", "threshold_masks"),
    "tta_aggregation_method": ("postpro", "tta_aggregation_method"),
}

_BOOL_FIELDS = {"overwrite", "shuffle", "fine_tuning", "use_batch_norm",
                "minimize_validation_metric"}


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    """Load a config. Accepts either a nested salt_tpu YAML (top-level keys are
    section names) or a reference-style flat ``parameters:`` YAML
    (reference: neptune.yaml layout). ``CONFIG_PATH`` env var is honoured when
    ``path`` is None, matching reference: common_blocks/utils.py:37-43."""
    cfg = default_config()
    path = path or os.getenv("CONFIG_PATH")
    if path:
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        if "parameters" in raw:          # reference-style flat yaml
            for key, value in raw["parameters"].items():
                if key not in _FLAT_KEY_MAP:
                    continue
                section, name = _FLAT_KEY_MAP[key]
                if key in _BOOL_FIELDS:
                    value = bool(value)
                if name == "min_lr" or name == "lr":
                    value = float(value)
                setattr(getattr(cfg, section), name, value)
        else:                             # nested native yaml
            for section, values in raw.items():
                if not hasattr(cfg, section) or not isinstance(values, dict):
                    continue
                sub = getattr(cfg, section)
                for name, value in values.items():
                    if hasattr(sub, name):
                        setattr(sub, name, value)
    if overrides:
        for dotted, value in overrides.items():
            section, name = dotted.split(".", 1)
            setattr(getattr(cfg, section), name, value)
    return cfg
