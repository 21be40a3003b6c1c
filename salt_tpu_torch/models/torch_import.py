"""Pretrained encoders from torch checkpoints: the port's own copy of the
encoder half of ``salt_tpu/models/torch_import.py`` (``load_state_dict``
:33-46, ``convert_resnet_encoder`` :60-106, ``convert_densenet_encoder``
:109-150, ``convert_encoder`` :374-380, ``graft_encoder`` :418-435).

A checkpoint is converted to the JAX package's nested (params,
batch_stats) trees under the flax scope names, so both packages graft
the same leaves; :func:`graft_encoder` then writes those leaves into the
port's module through ``models.convert``'s flat-key mapping. Nothing is
downloaded: the checkpoint is a local file.

Supported naming schemes: torchvision ResNet (resnet18/34/50/101/152),
pretrainedmodels SENet (se_resnet*, se_resnext*: the ``layer0.`` stem,
per-block ``se_module.fc1/fc2`` 1x1-conv gates) and torchvision DenseNet
(``features.*``). Layout: conv weight [O, I, kh, kw] -> flax kernel
[kh, kw, I, O]; BatchNorm weight / bias -> params scale / bias, running
mean / var -> batch_stats mean / var.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from salt_tpu_torch.models.convert import from_flax_flat, to_flax_flat


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint as numpy arrays: ``.npz`` files (torch key names,
    numpy values) through numpy, anything else through
    ``torch.load(weights_only=True)``."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in sd.items()
            if hasattr(v, "detach")}


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _bn(sd: Dict[str, np.ndarray], prefix: str):
    params = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
    stats = {"mean": sd[f"{prefix}.running_mean"],
             "var": sd[f"{prefix}.running_var"]}
    return params, stats


def convert_resnet_encoder(sd: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    """torchvision-ResNet or pretrainedmodels-SENet state_dict ->
    (params, batch_stats) trees of the ``ResNetEncoder`` scope."""
    stem = "layer0." if any(k.startswith("layer0.") for k in sd) else ""
    params: dict = {"conv1": {"kernel": _conv(sd[f"{stem}conv1.weight"])}}
    bn_p, bn_s = _bn(sd, f"{stem}bn1")
    params["bn1"], stats = {"BatchNorm_0": bn_p}, {"bn1": {"BatchNorm_0": bn_s}}
    for stage in range(1, 5):
        i = 0
        while f"layer{stage}.{i}.conv1.weight" in sd:
            pre = f"layer{stage}.{i}"
            block_p: dict = {}
            block_s: dict = {}
            for conv_id in (1, 2, 3):
                ck = f"{pre}.conv{conv_id}.weight"
                if ck not in sd:
                    continue
                block_p[f"conv{conv_id}"] = {"kernel": _conv(sd[ck])}
                bp, bs = _bn(sd, f"{pre}.bn{conv_id}")
                block_p[f"bn{conv_id}"] = {"BatchNorm_0": bp}
                block_s[f"bn{conv_id}"] = {"BatchNorm_0": bs}
            if f"{pre}.downsample.0.weight" in sd:
                block_p["downsample_conv"] = {
                    "kernel": _conv(sd[f"{pre}.downsample.0.weight"])}
                bp, bs = _bn(sd, f"{pre}.downsample.1")
                block_p["downsample_bn"] = {"BatchNorm_0": bp}
                block_s["downsample_bn"] = {"BatchNorm_0": bs}
            if f"{pre}.se_module.fc1.weight" in sd:
                block_p["se"] = {
                    fc: {"kernel": _conv(sd[f"{pre}.se_module.{fc}.weight"]),
                         "bias": sd[f"{pre}.se_module.{fc}.bias"]}
                    for fc in ("fc1", "fc2")}
            params[f"layer{stage}_{i}"] = block_p
            if block_s:
                stats[f"layer{stage}_{i}"] = block_s
            i += 1
    return params, stats


def convert_densenet_encoder(sd: Dict[str, np.ndarray]
                             ) -> Tuple[dict, dict]:
    """torchvision-DenseNet state_dict (``features.*``) -> (params,
    batch_stats) trees of the ``DenseNetEncoder`` scope."""
    params: dict = {}
    stats: dict = {}

    def put_bn(torch_prefix: str, tree_name: str):
        bn_p, bn_s = _bn(sd, torch_prefix)
        params[tree_name] = {"BatchNorm_0": bn_p}
        stats[tree_name] = {"BatchNorm_0": bn_s}

    params["conv0"] = {"kernel": _conv(sd["features.conv0.weight"])}
    put_bn("features.norm0", "norm0")
    block = 1
    while f"features.denseblock{block}.denselayer1.conv1.weight" in sd:
        layer = 1
        while (f"features.denseblock{block}.denselayer{layer}.conv1.weight"
               in sd):
            pre = f"features.denseblock{block}.denselayer{layer}"
            name = f"denseblock{block}_{layer - 1}"   # 0-based flax naming
            lp: dict = {}
            ls: dict = {}
            for i in (1, 2):
                bn_p, bn_s = _bn(sd, f"{pre}.norm{i}")
                lp[f"norm{i}"] = {"BatchNorm_0": bn_p}
                ls[f"norm{i}"] = {"BatchNorm_0": bn_s}
                lp[f"conv{i}"] = {"kernel": _conv(sd[f"{pre}.conv{i}.weight"])}
            params[name] = lp
            stats[name] = ls
            layer += 1
        if f"features.transition{block}.conv.weight" in sd:
            put_bn(f"features.transition{block}.norm",
                   f"transition{block}_norm")
            params[f"transition{block}_conv"] = {
                "kernel": _conv(sd[f"features.transition{block}.conv.weight"])}
        block += 1
    return params, stats


def convert_encoder(sd: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    """Dispatch on the checkpoint's naming scheme: torchvision DenseNet
    (``features.*``), else the ResNet / SENet converter."""
    if any(k.startswith("features.") for k in sd):
        return convert_densenet_encoder(sd)
    return convert_resnet_encoder(sd)


def _flat(tree: dict, prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


def graft_encoder(model: nn.Module, enc_params: dict, enc_stats: dict,
                  scope: str = "encoder") -> int:
    """Write converted pretrained trees into ``model``'s ``scope``
    submodule after checking every leaf's key and shape against the
    model, as the JAX package's ``graft_encoder`` does: ``KeyError``
    where the model has no such scope or leaf, ``ValueError`` on a shape
    mismatch. Leaves the checkpoint lacks keep their values. Returns the
    number of arrays written."""
    have = to_flax_flat(model)
    scopes = sorted({k.split("/")[1] for k in have})
    if scope not in scopes:
        raise KeyError(f"model has no {scope!r} scope; params keys: {scopes}")
    flat = {**_flat(enc_params, f"params/{scope}"),
            **_flat(enc_stats, f"batch_stats/{scope}")}
    for key, value in sorted(flat.items()):
        if key not in have:
            raise KeyError(f"pretrained key {key} not in model")
        if have[key].shape != value.shape:
            raise ValueError(f"shape mismatch at {key}: model "
                             f"{have[key].shape}, checkpoint {value.shape}")
    # a BN scope converts only with all four of its leaves present
    merged = {k: v for k, v in have.items()
              if k.split("/", 2)[1] == scope}
    merged.update(flat)
    sd = {k: v for k, v in from_flax_flat(merged).items()
          if not k.endswith("num_batches_tracked")}
    with torch.no_grad():
        target = model.state_dict()
        for k, v in sd.items():
            target[k].copy_(v.to(target[k].dtype))
    return len(flat)
