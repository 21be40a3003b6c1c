"""Weights from the reference's torch checkpoints: the port's own copy of
``salt_tpu/models/torch_import.py``.

- Pretrained encoders (``load_state_dict`` :33-46,
  ``convert_resnet_encoder`` :60-106, ``convert_densenet_encoder``
  :109-150, ``convert_encoder`` :374-380, ``graft_encoder`` :418-435),
  which ``model.pretrained`` grafts at ``init_state``.
- Whole reference models (``convert_unet_resnet`` :195-222,
  ``convert_unet_resnet_with_depth`` :232-244, ``convert_lkm`` :289-308,
  ``convert_pspnet`` :311-343, ``convert_emptiness`` :346-358,
  ``convert_stacking_fcn`` :361-371, ``graft_model`` :408-415): a
  reference-trained checkpoint served or trained on by the port. Build
  the model with ``conv_pad_mode="reference"`` and
  ``upsample_mode="align_corners"`` to compute the reference's forward.

A checkpoint is converted to the JAX package's nested (params,
batch_stats) trees under the flax scope names, so both packages graft
the same leaves; :func:`graft_encoder` and :func:`graft_model` then
write those leaves into the port's module through ``models.convert``'s
flat-key mapping. Nothing is downloaded: the checkpoint is a local file.

Supported naming schemes: torchvision ResNet (resnet18/34/50/101/152),
pretrainedmodels SENet (se_resnet*, se_resnext*: the ``layer0.`` stem,
per-block ``se_module.fc1/fc2`` 1x1-conv gates) and torchvision DenseNet
(``features.*``); the reference's own module names above them. Layout:
conv weight [O, I, kh, kw] -> flax kernel [kh, kw, I, O]; Linear weight
[O, I] -> Dense kernel [I, O]; BatchNorm weight / bias -> params scale /
bias, running mean / var -> batch_stats mean / var.

    sd = load_state_dict("unet_resnet34.pth")
    model = build_model(cfg.model)     # conv_pad_mode="reference", ...
    graft_model(model, *convert_unet_resnet(sd))
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


def _linear(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


def _bn_after_conv(sd: Dict[str, np.ndarray], pre: str, conv: str
                   ) -> Tuple[dict, dict]:
    """The BatchNorm ``{pre}.batch_norm`` after the conv ``{pre}.{conv}``.
    The reference keeps the conv's bias under BatchNorm (``nn.Conv2d``'s
    default); the port's conv has none, so the bias folds into the
    running mean (mean' = mean - bias): exact in eval mode, and in train
    mode a bias before BatchNorm cancels in the batch mean."""
    bn_p, bn_s = _bn(sd, f"{pre}.batch_norm")
    if f"{pre}.{conv}.bias" in sd:
        bn_s = {"mean": bn_s["mean"] - sd[f"{pre}.{conv}.bias"],
                "var": bn_s["var"]}
    return bn_p, bn_s


def _cbr(sd: Dict[str, np.ndarray], pre: str) -> Tuple[dict, dict]:
    """The reference's ``Conv2dBnRelu`` -> ``ConvBnRelu`` trees."""
    bn_p, bn_s = _bn_after_conv(sd, pre, "conv")
    return ({"Conv_0": {"kernel": _conv(sd[f"{pre}.conv.weight"])},
             "BatchNorm_0": bn_p}, {"BatchNorm_0": bn_s})


def _decoder_block(sd: Dict[str, np.ndarray], pre: str) -> Tuple[dict, dict]:
    """The reference's scSE ``DecoderBlock`` -> ``DecoderBlock`` trees;
    the spatial SE's 1x1 conv [1, C, 1, 1] becomes ``Dense_0`` [C, 1]."""
    p: dict = {}
    s: dict = {}
    p["ConvBnRelu_0"], s["ConvBnRelu_0"] = _cbr(sd, f"{pre}.conv1")
    p["ConvBnRelu_1"], s["ConvBnRelu_1"] = _cbr(sd, f"{pre}.conv2")
    p["ChannelSELayer_0"] = {
        "Dense_0": {"kernel": _linear(sd[f"{pre}.channel_se.fc.0.weight"]),
                    "bias": sd[f"{pre}.channel_se.fc.0.bias"]},
        "Dense_1": {"kernel": _linear(sd[f"{pre}.channel_se.fc.2.weight"]),
                    "bias": sd[f"{pre}.channel_se.fc.2.bias"]}}
    w = sd[f"{pre}.spatial_se.fc.weight"]
    p["SpatialSELayer_0"] = {
        "Dense_0": {"kernel": w.reshape(w.shape[:2]).T,
                    "bias": sd[f"{pre}.spatial_se.fc.bias"]}}
    return p, s


def _encoder_sd(sd: Dict[str, np.ndarray], prefix: str = "encoders.encoder."
                ) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def convert_unet_resnet(sd: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    """A whole reference U-Net state_dict (``UNetResNet``,
    ``UNetSeResNet``, ``UNetSeResNetXt``, ``UNetDenseNet``: encoder,
    center, dec5..dec1, final) -> the ``UNetTrunk``'s (params,
    batch_stats) trees; the encoder by its naming scheme
    (:func:`convert_encoder`). Build the model with
    ``conv_pad_mode="reference"`` and ``upsample_mode="align_corners"``
    to compute the reference's forward."""
    enc_sd = _encoder_sd(sd)
    if not enc_sd:
        raise KeyError("state_dict has no 'encoders.encoder.*' keys — "
                       "not a full reference U-Net checkpoint")
    enc_p, enc_s = convert_encoder(enc_sd)
    params: dict = {"encoder": enc_p}
    stats: dict = {"encoder": enc_s}
    params["center_conv1"], stats["center_conv1"] = _cbr(sd, "center.0")
    params["center_conv2"], stats["center_conv2"] = _cbr(sd, "center.1")
    for k in range(1, 6):
        params[f"dec{k}"], stats[f"dec{k}"] = _decoder_block(sd, f"dec{k}")
    params["final_conv"], stats["final_conv"] = _cbr(sd, "final.0")
    params["head"] = {"kernel": _conv(sd["final.1.weight"]),
                      "bias": sd["final.1.bias"]}
    return params, stats


def _depth_gate(sd: Dict[str, np.ndarray], pre: str) -> dict:
    """The reference's ``DepthChannelExcitation`` (Linear(1 -> C) and a
    sigmoid) -> ``DepthChannelExcitation``'s ``Dense_0``."""
    return {"Dense_0": {"kernel": _linear(sd[f"{pre}.fc.0.weight"]),
                        "bias": sd[f"{pre}.fc.0.bias"]}}


def convert_unet_resnet_with_depth(sd: Dict[str, np.ndarray]
                                   ) -> Tuple[dict, dict]:
    """The reference's ``UNetResNetWithDepth`` -> the port's: the trunk
    under ``trunk`` without its final conv and head, which sit at the top
    after the depth gate, in the reference's order."""
    p, s = convert_unet_resnet(sd)
    final_p, final_s = p.pop("final_conv"), s.pop("final_conv")
    head = p.pop("head")
    params = {"trunk": p,
              "depth_gate": _depth_gate(sd, "depth_channel_excitation"),
              "final_conv": final_p, "head": head}
    return params, {"trunk": s, "final_conv": final_s}


def _deconv_cbr(sd: Dict[str, np.ndarray], pre: str) -> Tuple[dict, dict]:
    """The reference's ``DeconvConv2dBnRelu`` (ConvTranspose2d k 3,
    stride 2, padding 1, output_padding 1) -> ``DeconvConvBnRelu``.
    torch's transposed conv correlates the stride-dilated input with the
    spatially flipped kernel, in and out swapped, so [I, O, kh, kw]
    becomes flax's kernel [kh, kw, I, O] flipped; the block flips it back
    in its forward."""
    w = sd[f"{pre}.deconv.weight"]
    bn_p, bn_s = _bn_after_conv(sd, pre, "deconv")
    kernel = np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1)).copy()
    return ({"ConvTranspose_0": {"kernel": kernel}, "BatchNorm_0": bn_p},
            {"BatchNorm_0": bn_s})


def _cbr_list(sd: Dict[str, np.ndarray], pre: str, names) -> Tuple[dict, dict]:
    """``ConvBnRelu_0..n`` trees of the reference's Conv2dBnRelu blocks
    ``{pre}.{name}``, in the order ``names`` gives."""
    p: dict = {}
    s: dict = {}
    for i, name in enumerate(names):
        p[f"ConvBnRelu_{i}"], s[f"ConvBnRelu_{i}"] = _cbr(sd, f"{pre}.{name}")
    return p, s


def _gcn(sd: Dict[str, np.ndarray], pre: str) -> Tuple[dict, dict]:
    """The reference's ``GlobalConvolutionalNetwork``: the (k,1)+(1,k)
    and (1,k)+(k,1) branches, called conv1.0, conv1.1, conv2.0, conv2.1."""
    return _cbr_list(sd, pre, ("conv1.0", "conv1.1", "conv2.0", "conv2.1"))


def _br(sd: Dict[str, np.ndarray], pre: str) -> Tuple[dict, dict]:
    """The reference's ``BoundaryRefinement``: two Conv2dBnRelu."""
    return _cbr_list(sd, pre, ("conv.0", "conv.1"))


def convert_lkm(sd: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    """The reference's ``LargeKernelMatters`` -> the port's trees."""
    enc_p, enc_s = convert_resnet_encoder(_encoder_sd(sd))
    params: dict = {"encoder": enc_p}
    stats: dict = {"encoder": enc_s}
    for k in range(2, 6):
        params[f"gcn_{k}"], stats[f"gcn_{k}"] = _gcn(sd, f"gcn{k}")
        params[f"enc_br_{k}"], stats[f"enc_br_{k}"] = _br(sd, f"enc_br{k}")
    for k in range(2, 6):
        params[f"deconv{k}"], stats[f"deconv{k}"] = _deconv_cbr(
            sd, f"deconv{k}")
    for k in range(1, 5):
        params[f"dec_br{k}"], stats[f"dec_br{k}"] = _br(sd, f"dec_br{k}")
    params["final"] = {"kernel": _conv(sd["final.weight"]),
                       "bias": sd["final.bias"]}
    return params, stats


def convert_pspnet(sd: Dict[str, np.ndarray],
                   sizes=(1, 2, 3, 6)) -> Tuple[dict, dict]:
    """The reference's ``PSPNet`` -> the port's trees. ``psp.stages.{i}``
    is (AdaptiveAvgPool2d, Conv2d), so its conv sits at index 1 and goes
    to ``psp/stage_{size}``; each ``up{k}.conv`` is (Conv2d with a bias,
    BatchNorm2d, PReLU with one scalar, a 0-d ``prelu_alpha``)."""
    enc_p, enc_s = convert_resnet_encoder(_encoder_sd(sd))
    params: dict = {"encoder": enc_p}
    stats: dict = {"encoder": enc_s}
    psp: dict = {f"stage_{size}": {
        "kernel": _conv(sd[f"psp.stages.{i}.1.weight"])}
        for i, size in enumerate(sizes)}
    psp["bottleneck"] = {"kernel": _conv(sd["psp.bottleneck.weight"]),
                         "bias": sd["psp.bottleneck.bias"]}
    params["psp"] = psp
    for k in range(1, 5):
        pre = f"up{k}.conv"
        bn_p, bn_s = _bn(sd, f"{pre}.1")
        params[f"up{k}"] = {
            "Conv_0": {"kernel": _conv(sd[f"{pre}.0.weight"]),
                       "bias": sd[f"{pre}.0.bias"]},
            "BatchNorm_0": bn_p,
            "prelu_alpha": sd[f"{pre}.2.weight"].reshape(()),
        }
        stats[f"up{k}"] = {"BatchNorm_0": bn_s}
    params["final_conv"], stats["final_conv"] = _cbr(sd, "final.0")
    params["head"] = {"kernel": _conv(sd["final.1.weight"]),
                      "bias": sd["final.1.bias"]}
    return params, stats


def convert_emptiness(sd: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    """The reference's ``EmptinessClassifier`` -> the port's trees: the
    torchvision ResNet under ``encoder.*`` (its ImageNet ``fc.*``, which
    the reference replaces by an average pool and a 1x1 conv, is
    skipped) and ``classifier.1``."""
    enc_sd = {k: v for k, v in _encoder_sd(sd, "encoder.").items()
              if not k.startswith("fc")}
    enc_p, enc_s = convert_resnet_encoder(enc_sd)
    params = {"encoder": enc_p,
              "classifier": {"kernel": _conv(sd["classifier.1.weight"]),
                             "bias": sd["classifier.1.bias"]}}
    return params, {"encoder": enc_s}


def convert_stacking_fcn(sd: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    """The reference's ``StackingFCN`` / ``StackingFCNWithDepth`` -> the
    port's trees (the depth gate where the state_dict has one)."""
    params: dict = {}
    stats: dict = {}
    params["conv"], stats["conv"] = _cbr(sd, "conv.0")
    if "depth_channel_excitation.fc.0.weight" in sd:
        params["depth_gate"] = _depth_gate(sd, "depth_channel_excitation")
    params["final"] = {"kernel": _conv(sd["final.0.weight"]),
                       "bias": sd["final.0.bias"]}
    return params, stats


def _flat(tree: dict, prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


def _graft(model: nn.Module, have: Dict[str, np.ndarray], params: dict,
           stats: dict, scope: str = "") -> int:
    """Write the (params, batch_stats) trees, rooted at ``scope`` (the
    whole model where empty), into ``model`` after checking every leaf's
    key and shape against ``have``, the model's flat leaves (the JAX
    package's ``_check``): ``KeyError`` for a leaf the model lacks,
    ``ValueError`` on a shape mismatch. Leaves the trees lack keep their
    values; each written leaf takes the model leaf's dtype (``_merge``).
    Returns the number of arrays written."""
    root = f"/{scope}" if scope else ""
    flat = {**_flat(params, f"params{root}"),
            **_flat(stats, f"batch_stats{root}")}
    for key, value in sorted(flat.items()):
        if key not in have:
            raise KeyError(f"pretrained key {key} not in model")
        if have[key].shape != value.shape:
            raise ValueError(f"shape mismatch at {key}: model "
                             f"{have[key].shape}, checkpoint {value.shape}")
    # a BN scope converts only with all four of its leaves present
    merged = {k: v for k, v in have.items()
              if not scope or k.split("/", 2)[1] == scope}
    merged.update(flat)
    sd = {k: v for k, v in from_flax_flat(merged).items()
          if not k.endswith("num_batches_tracked")}
    with torch.no_grad():
        target = model.state_dict()
        for k, v in sd.items():
            target[k].copy_(v.to(target[k].dtype))
    return len(flat)


def graft_model(model: nn.Module, params: dict, stats: dict) -> int:
    """Replace ``model``'s whole parameter and batch-stat trees with
    converted weights (e.g. :func:`convert_unet_resnet` of a whole
    reference checkpoint), checked leaf by leaf as the JAX package's
    ``graft_model`` checks them (:func:`_graft`). Returns the number of
    arrays written."""
    return _graft(model, to_flax_flat(model), params, stats)


def graft_encoder(model: nn.Module, enc_params: dict, enc_stats: dict,
                  scope: str = "encoder") -> int:
    """Write converted pretrained trees into ``model``'s ``scope``
    submodule, checked leaf by leaf as the JAX package's
    ``graft_encoder`` checks them: ``KeyError`` also where the model has
    no such scope. Returns the number of arrays written."""
    have = to_flax_flat(model)
    scopes = sorted({k.split("/")[1] for k in have})
    if scope not in scopes:
        raise KeyError(f"model has no {scope!r} scope; params keys: {scopes}")
    return _graft(model, have, enc_params, enc_stats, scope)
