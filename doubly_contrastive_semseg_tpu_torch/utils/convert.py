"""JAX model variables → the port's torch ``state_dict``.

Takes the variables as nested dicts of numpy arrays (``params`` and
``batch_stats``, e.g. pulled with ``jax.device_get``); imports neither JAX
nor the JAX package. Conventions, the inverse of the JAX package's
``utils/torch_convert.py``: conv kernel HWIO → OIHW (a depthwise kernel
(kh, kw, 1, C) → (C, 1, kh, kw)), a transposed conv's flipped (kh, kw, I, O)
kernel → torch's (I, O, kh, kw), dense (I, O) → (O, I), BN
scale/bias/mean/var → weight/bias/running_mean/running_var, a PReLU's
``alpha`` → ``weight``, and the s2d stem kernel (4, 4, 12, 64) → the dense
(64, 3, 7, 7) ``conv1.weight``. The module paths of JAX's ``DCSSModel``
(``net/feature_extractor``), ``DeepLabDCSS`` (top-level ``backbone``,
``classifier``) and ``ENetDCSS`` (``net/initial_block``, ...) become the
reference's torch names, which the port's modules carry. A JAX model
initialised for training (``return_supcon_feature=True``) has
``projection/{fc1,fc2}``, which land on ``projection.{fc1,fc2}`` of a port
model built with ``projection=True``. A tree of gradients maps like a tree
of parameters.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..ops.input_pipeline import stem_dense_kernel_from_s2d

_BN_STATS = {"mean": "running_mean", "var": "running_var"}
_SEP = {"depthwise": "body.0", "pointwise": "body.1"}

# ENet: JAX module → the reference's, by block kind
_ENET_COMMON = {"ext_conv1": "ext_conv1.0", "ext_bn1": "ext_conv1.1", "ext_act1": "ext_conv1.2",
                "ext_conv3": "ext_conv3.0", "ext_bn3": "ext_conv3.1", "ext_act3": "ext_conv3.2",
                "out_act": "out_activation"}
_ENET = {
    "regular": {**_ENET_COMMON, "ext_conv2": "ext_conv2.0", "ext_bn2": "ext_conv2.1",
                "ext_act2": "ext_conv2.2"},
    "asymmetric": {**_ENET_COMMON, "ext_conv2a": "ext_conv2.0", "ext_bn2a": "ext_conv2.1",
                   "ext_act2a": "ext_conv2.2", "ext_conv2b": "ext_conv2.3",
                   "ext_bn2": "ext_conv2.4", "ext_act2": "ext_conv2.5"},
    "upsample": {"main_conv": "main_conv1.0", "main_bn": "main_conv1.1",
                 "ext_conv1": "ext_conv1.0", "ext_bn1": "ext_conv1.1", "ext_act1": "ext_conv1.2",
                 "ext_tconv": "ext_tconv1", "ext_bn2": "ext_tconv1_bnorm",
                 "ext_act2": "ext_tconv1_activation", "ext_conv2": "ext_conv2.0",
                 "ext_bn3": "ext_conv2.1", "out_act": "out_activation"},
    "initial_block": {"main": "main_branch", "bn": "batch_norm", "act": "out_activation"},
}


def _torch_module_name(part: str) -> str:
    m = re.fullmatch(r"layer(\d)_(\d+)", part)
    if m:
        return f"layer{m.group(1)}.{m.group(2)}"
    return {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(part, part)


def _conv_bn(path: Tuple[str, ...], conv: str, bn: str) -> str:
    """A JAX ``ConvBNReLU`` (``conv``, ``bn``; a separable ``conv`` holds
    ``depthwise`` and ``pointwise``) → the reference's Sequential."""
    if path[0] == "bn":
        return bn
    return conv + ("." + _SEP[path[1]] if len(path) > 1 else "")


def _deeplab_head(path: Tuple[str, ...], v3plus: bool) -> str:
    aspp = "classifier.aspp" if v3plus else "classifier.0"
    top, rest = path[0], path[1:]
    if top == "aspp":
        sub, rest = rest[0], rest[1:]
        if sub == "conv1x1":
            return _conv_bn(rest, f"{aspp}.convs.0.0", f"{aspp}.convs.0.1")
        if sub.startswith("aspp_conv"):
            i = int(sub[len("aspp_conv"):]) + 1
            return _conv_bn(rest, f"{aspp}.convs.{i}.0", f"{aspp}.convs.{i}.1")
        if sub == "image_pool":
            return _conv_bn(rest, f"{aspp}.convs.4.1", f"{aspp}.convs.4.2")
        return _conv_bn(rest, f"{aspp}.project.0", f"{aspp}.project.1")
    if top == "project":
        return _conv_bn(rest, "classifier.project.0", "classifier.project.1")
    if top == "fuse":
        return (_conv_bn(rest, "classifier.classifier.0", "classifier.classifier.1") if v3plus
                else _conv_bn(rest, "classifier.1", "classifier.2"))
    return "classifier.classifier.3" if v3plus else "classifier.4"


def _mobilenet(path: Tuple[str, ...], backbone: Mapping) -> str:
    if path[0] == "stem":
        return "low_level_features.0." + ("0" if path[1] == "conv" else "1")
    i = int(path[0][len("block"):])
    sect = "low_level_features" if i < 4 else "high_level_features"
    expand = "expand" in backbone[path[0]]
    dw, pj = (1, 2) if expand else (0, 1)
    sub = {"expand": "0", "depthwise": str(dw), "project": str(pj),
           "project_bn": str(pj + 1)}[path[1]]
    if path[1] in ("expand", "depthwise"):
        sub += ".0" if path[2] == "conv" else ".1"
    return f"{sect}.{i}.conv.{sub}"


def _xception(path: Tuple[str, ...]) -> str:
    top = path[0]
    m = re.fullmatch(r"block(\d+)", top)
    if m:
        n = int(m.group(1))
        if path[1] == "skip_conv":
            return f"{top}.skip"
        if path[1] == "skip_bn":
            return f"{top}.skipbn"
        k = 3 * int(path[1][len("sep"):]) + (0 if n in (1, 2) else 1)
        return f"{top}.rep." + {"depthwise": f"{k}.conv1", "bn_dw": f"{k}.bn",
                                "pointwise": f"{k}.pointwise", "bn_pw": str(k + 1)}[path[2]]
    if len(path) > 1:   # exit flow conv3..5: its outer BN is bn{n}
        n = top[len("conv"):]
        return {"depthwise": f"{top}.conv1", "bn_dw": f"{top}.bn",
                "pointwise": f"{top}.pointwise", "bn_pw": f"bn{n}"}[path[1]]
    return top


def _hrnet(path: Tuple[str, ...]) -> str:
    top = path[0]
    fixed = {"stem_conv0": "conv1", "stem_bn0": "bn1", "stem_conv1": "conv2",
             "stem_bn1": "bn2", "trans0": "transition1.0.0", "trans0_bn": "transition1.0.1",
             "trans1": "transition1.1.0.0", "trans1_bn": "transition1.1.0.1"}
    if top in fixed:
        return fixed[top]
    m = re.fullmatch(r"trans_s(\d)(_bn)?", top)
    if m:
        return f"transition{int(m.group(1)) - 1}." + ("1" if m.group(2) else "0")
    m = re.fullmatch(r"s(\d)_m(\d+)_b(\d+)_blk(\d+)", top)
    if m:
        return "stage{}.{}.branches.{}.{}.".format(*m.groups()) + path[1]
    m = re.fullmatch(r"s(\d)_m(\d+)_fuse", top)
    if m:
        pre = f"stage{m.group(1)}.{m.group(2)}.fuse_layers."
        u = re.fullmatch(r"up(\d)to(\d)(_bn)?", path[1])
        if u:
            return pre + f"{u.group(2)}.{u.group(1)}." + ("1" if u.group(3) else "0")
        d = re.fullmatch(r"down(\d)to(\d)_(\d)(_bn)?", path[1])
        return pre + f"{d.group(2)}.{d.group(1)}.{d.group(3)}." + ("1" if d.group(4) else "0")
    return ".".join(_torch_module_name(p) for p in path)


def _enet(path: Tuple[str, ...]) -> str:
    block = path[0]
    if block == "transposed_conv":
        return block
    kind = next((k for k in ("initial_block", "upsample", "asymmetric") if block.startswith(k)),
                "regular")
    return f"{block}.{_ENET[kind][path[1]]}"


def _module_name(path: Tuple[str, ...], params: Mapping) -> str:
    """The port's dotted module name of the JAX module at ``path``; the
    family and the branches it takes are read off ``params`` (a params or a
    batch-stats tree: every test below names a module with a BN)."""
    top = path[0]
    if top in ("weather_clf", "projection"):
        return ".".join(path)
    if top == "net":
        if "initial_block" in params["net"]:
            return "net." + _enet(path[1:])
        return ".".join(_torch_module_name(p) for p in path)
    if top == "classifier":
        return _deeplab_head(path[1:], "project" in params["classifier"])
    if top != "backbone":   # a block's own tree
        return ".".join(_torch_module_name(p) for p in path)
    backbone = params["backbone"]
    rest = path[1:]
    if "stem" in backbone:
        name = _mobilenet(rest, backbone)
    elif "block20" in backbone:
        name = _xception(rest)
    elif "stem_bn0" in backbone:
        name = _hrnet(rest)
    else:
        name = ".".join(_torch_module_name(p) for p in rest)
    return "backbone." + name


def _weight(path, value: np.ndarray) -> np.ndarray:
    if path[-2:] == ("feature_extractor", "conv1"):
        value = stem_dense_kernel_from_s2d(value)
    if path[-1] in ("ext_tconv", "transposed_conv"):   # un-flip, (I, O, kh, kw)
        return value[::-1, ::-1].transpose(2, 3, 0, 1)
    if value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    return value.T


def _walk(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, path + (k,))
        else:
            yield path, k, np.asarray(v, np.float32)


def from_jax_variables(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``DCSSModel``, ``DeepLabDCSS`` or
    ``ENetDCSS`` from the JAX model's ``params`` and ``batch_stats``
    trees."""
    layout = params or batch_stats
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf, value in _walk(params):
        prefix = _module_name(path, layout)
        if leaf == "kernel":
            value, leaf = _weight(path, value), "weight"
        elif leaf in ("scale", "alpha"):
            leaf = "weight"
        sd[f"{prefix}.{leaf}"] = torch.from_numpy(np.ascontiguousarray(value))
    for path, leaf, value in _walk(batch_stats):
        prefix = _module_name(path, layout)
        sd[f"{prefix}.{_BN_STATS[leaf]}"] = torch.from_numpy(np.array(value))
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return sd
