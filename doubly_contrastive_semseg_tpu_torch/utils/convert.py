"""JAX model variables → the port's torch ``state_dict``.

Takes the variables as nested dicts of numpy arrays (``params`` and
``batch_stats``, e.g. pulled with ``jax.device_get``); imports neither JAX
nor the JAX package. Conventions, the inverse of the JAX package's
``utils/torch_convert.py``: conv kernel HWIO → OIHW (a depthwise kernel
(kh, kw, 1, C) → (C, 1, kh, kw)), a transposed conv's flipped (kh, kw, I, O)
kernel → torch's (I, O, kh, kw), dense (I, O) → (O, I), BN
scale/bias/mean/var → weight/bias/running_mean/running_var, a PReLU's
``alpha`` → ``weight``, the pyramid ResNets' masked s2d stem kernel (4, 4,
12, 64) → the dense (64, 3, 7, 7) ``conv1.weight``, and the unmasked s2d
stems of the MobileNetV2 pyramid (``conv1_kernel``, (4, 4, 12, 32)) and the
EfficientNet pyramid (``stem_conv``, (2, 2, 12, 32)) → the dense 8×8 and
4×4 kernels they are. The module paths of JAX's ``DCSSModel``
(``net/feature_extractor``, every backbone), ``DeepLabDCSS`` (top-level
``backbone``, ``classifier``) and ``ENetDCSS`` (``net/initial_block``, ...)
become the reference's torch names where the port's modules carry them,
JAX's names in torch form elsewhere (``_feature_extractor``). A JAX model
initialised for training (``return_supcon_feature=True``) has
``projection/{fc1,fc2}``, which land on ``projection.{fc1,fc2}`` of a port
model built with ``projection=True``. JAX's ``StereoDCSS`` (top-level
``feature_extractor``, ``aggregation``, ``segmentation``, ``refinement``)
lands on the port's under the reference's names: the aggregation's
``fusionF/branchI_B`` → ``fusions.F.branches.I.B`` with ``mdconv`` →
``conv2``, ``fuseI_J_{conv,bn}K`` → ``fuse_layers.I.J[.K].{0,1}``,
``final_convI`` → ``final_conv.I``; a deformable conv's own ``kernel``
and ``bias`` → ``deform_conv.{weight,bias}``; ``SemRefine``'s ``bn0`` →
``bn``, ``enc_{img,disp,sem}`` → ``conv{1,2,3}.{0,1}``, the Dense gates
``{sem,disp}_att`` → the 1×1 convs ``{sem,disp}_attention.1``,
``final_{disp,sem}`` → ``final_conv_{disp,sem}``; ``HourglassRefinement``'s
``conv{1,2}/{conv,bn}`` → ``conv{1,2}.{0,1}``, ``final`` → ``final_conv``;
``PSMNetHGAggregation``'s ``dres{0,1}_{0,1}`` → ``dres{0,1}.{0,2}``,
``hg{1,2,3}/convK`` → ``dres{2,3,4}.convK`` (``.0`` where a ReLU follows:
``conv1``, ``conv3``, ``conv4``), ``classifI_{0,1}`` → ``classifI.{0,2}``,
each ``Conv3D``'s ``conv``, ``bn`` → ``0``, ``1``. The other 3-D
aggregations and ``StereoDRNetRefinement`` keep JAX's names, and so do
the legacy stereo feature extractors and heads (``_legacy_stereo``). A 3-D kernel
(kD, kH, kW, I, O) → (O, I, kD, kH, kW); a 3-D transposed conv's (the
hourglass's ``conv5``, ``conv6``, GCNet's ``trans1..5``) flipped kernel →
torch's (I, O, kD, kH, kW). A tree of gradients maps like a tree of
parameters.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..ops.input_pipeline import s2d_kernel_to_dense, stem_dense_kernel_from_s2d

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
    return {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1",
            "mdconv": "conv2"}.get(part, part)


def _conv_bn(path: Tuple[str, ...], conv: str, bn: str) -> str:
    """A JAX ``ConvBNReLU`` (``conv``, ``bn``; a separable ``conv`` holds
    ``depthwise`` and ``pointwise``) → the reference's Sequential."""
    if path[0] == "bn":
        return bn
    return conv + ("." + _SEP[path[1]] if len(path) > 1 else "")


def _aspp(path: Tuple[str, ...], aspp: str) -> str:
    """A JAX ``ASPP``'s module → the port's ``deeplab.ASPP`` at ``aspp``."""
    sub, rest = path[0], path[1:]
    if sub == "conv1x1":
        return _conv_bn(rest, f"{aspp}.convs.0.0", f"{aspp}.convs.0.1")
    if sub.startswith("aspp_conv"):
        i = int(sub[len("aspp_conv"):]) + 1
        return _conv_bn(rest, f"{aspp}.convs.{i}.0", f"{aspp}.convs.{i}.1")
    if sub == "image_pool":
        return _conv_bn(rest, f"{aspp}.convs.4.1", f"{aspp}.convs.4.2")
    return _conv_bn(rest, f"{aspp}.project.0", f"{aspp}.project.1")


def _deeplab_head(path: Tuple[str, ...], v3plus: bool) -> str:
    top, rest = path[0], path[1:]
    if top == "aspp":
        return _aspp(rest, "classifier.aspp" if v3plus else "classifier.0")
    if top == "project":
        return _conv_bn(rest, "classifier.project.0", "classifier.project.1")
    if top == "fuse":
        return (_conv_bn(rest, "classifier.classifier.0", "classifier.classifier.1") if v3plus
                else _conv_bn(rest, "classifier.1", "classifier.2"))
    return "classifier.classifier.3" if v3plus else "classifier.4"


def _inverted_residual(path: Tuple[str, ...], expand: bool) -> str:
    """A JAX ``InvertedResidual``'s module (``expand``, ``depthwise``, each
    with ``conv`` and ``bn``; ``project``, ``project_bn``) → its index in
    the reference's ``conv`` Sequential."""
    dw, pj = (1, 2) if expand else (0, 1)
    sub = {"expand": "0", "depthwise": str(dw), "project": str(pj),
           "project_bn": str(pj + 1)}[path[0]]
    if path[0] in ("expand", "depthwise"):
        sub += ".0" if path[1] == "conv" else ".1"
    return f"conv.{sub}"


def _mobilenet(path: Tuple[str, ...], backbone: Mapping) -> str:
    if path[0] == "stem":
        return "low_level_features.0." + ("0" if path[1] == "conv" else "1")
    i = int(path[0][len("block"):])
    sect = "low_level_features" if i < 4 else "high_level_features"
    return f"{sect}.{i}." + _inverted_residual(path[1:], "expand" in backbone[path[0]])


def _feature_extractor(path: Tuple[str, ...], fe: Mapping) -> str:
    """WeatherNet's backbones: the single-scale trio's ``stem[_d]/X`` →
    ``X[_d]``, ``trunk[_d]/layerS_B`` → ``layerS[_d].B``, ``attention_*`` →
    the conv ``.1`` of its Sequential, ``spp/X`` → ``spp.spp.X``,
    ``upsampleI`` → ``upsample.I``; the MobileNetV2 pyramid's
    ``ir*`` blocks as ``InvertedResidual``s; every other name (the pyramid
    ResNets, the EfficientNet pyramid, the hourglass's ladder) in torch
    form."""
    top, rest = path[0], path[1:]
    if top in ("stem", "stem_d"):
        return rest[0] + top[len("stem"):]
    if top in ("trunk", "trunk_d"):
        s, b = re.fullmatch(r"layer(\d)_(\d+)", rest[0]).groups()
        return ".".join((f"layer{s}{top[len('trunk'):]}", b)
                        + tuple(_torch_module_name(p) for p in rest[1:]))
    if top.startswith("attention_"):
        return top + ".1"
    if top == "spp":
        return "spp.spp." + ".".join(rest)
    m = re.fullmatch(r"upsample(\d)", top)
    if m:
        return f"upsample.{m.group(1)}." + ".".join(rest)
    if re.fullmatch(r"ir\d_\d+_\d+", top):
        return f"{top}." + _inverted_residual(rest, "expand" in fe[top])
    return ".".join(_torch_module_name(p) for p in path)


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


_SEM_REFINE = {"bn0": "bn", "enc_img": "conv1", "enc_disp": "conv2", "enc_sem": "conv3",
               "sem_att": "sem_attention.1", "disp_att": "disp_attention.1",
               "final_disp": "final_conv_disp", "final_sem": "final_conv_sem"}


def _sem_refine(path: Tuple[str, ...]) -> str:
    """JAX ``SemRefine``'s module → the reference's name."""
    top = _SEM_REFINE.get(path[0], path[0])
    if path[0].startswith("enc_"):   # a ConvBNLRelu: the Sequential's conv, BN
        return f"{top}." + ("0" if path[1] == "conv" else "1")
    return ".".join((top,) + path[1:])


def _aggregation(path: Tuple[str, ...]) -> str:
    """JAX ``AdaptiveAggregation``'s module → the reference's name."""
    m = re.fullmatch(r"final_conv(\d+)", path[0])
    if m:
        return f"final_conv.{m.group(1)}"
    f = path[0][len("fusion"):]
    m = re.fullmatch(r"branch(\d+)_(\d+)", path[1])
    if m:
        return ".".join((f"fusions.{f}.branches.{m.group(1)}.{m.group(2)}",)
                        + tuple(_torch_module_name(p) for p in path[2:]))
    i, j, kind, k = re.fullmatch(r"fuse(\d+)_(\d+)_(conv|bn)(\d+)", path[1]).groups()
    seq = f"{k}." if int(i) > int(j) else ""   # fine → coarse: a chain of Sequentials
    return f"fusions.{f}.fuse_layers.{i}.{j}.{seq}" + ("0" if kind == "conv" else "1")


_HOURGLASS_ENCODERS = {"conv": "0", "bn": "1"}


def _hourglass_refine(path: Tuple[str, ...]) -> str:
    """JAX ``HourglassRefinement``'s module → the reference's name."""
    if path[0] in ("conv1", "conv2") and len(path) == 2:   # a ConvBNLRelu
        return f"{path[0]}.{_HOURGLASS_ENCODERS[path[1]]}"
    return ".".join(("final_conv" if path[0] == "final" else path[0],) + path[1:])


def _psmnet_hg(path: Tuple[str, ...]) -> str:
    """JAX ``PSMNetHGAggregation``'s module → the reference's name."""
    top = path[0]
    m = re.fullmatch(r"(dres[01]|classif\d)_(\d)", top)
    if m:   # a Sequential: conv-BN pairs at 0 and 2 (dres), the bare conv at 2 (classif)
        seq = f"{m.group(1)}.{2 * int(m.group(2))}"
        return seq if len(path) == 1 else f"{seq}.{_HOURGLASS_ENCODERS[path[1]]}"
    hg, conv, part = path
    relu_after = conv in ("conv1", "conv3", "conv4")
    return (f"dres{int(hg[2:]) + 1}.{conv}" + (".0" if relu_after else "")
            + f".{_HOURGLASS_ENCODERS[part]}")


# a top-level module of each legacy stereo feature extractor and head that
# holds a BN (models/stereo_features.py, models/legacy_segmentation.py)
_LEGACY_STEREO_KEYS = frozenset(("down0", "firstconv0", "res0", "conv_start0", "out0_bn0",
                                 "fpn0_bn", "ir0_0", "aspp", "pre_bn"))


def _legacy_stereo(path: Tuple[str, ...], node: Mapping) -> str:
    """A JAX legacy stereo module (``models/stereo_features.py``,
    ``models/legacy_segmentation.py``) → the port's: JAX's path in torch
    form, but an ``ASPP`` as ``_aspp``, an ``InvertedResidual`` ``irG_B`` as
    ``_inverted_residual`` and the MobileNetV2 trunk's ``ConvBNReLU6``
    (``conv_in``, ``stem``) as the ``conv_bn_relu6`` Sequential."""
    out = []
    for i, part in enumerate(path):
        rest = path[i + 1:]
        if part == "aspp":
            return ".".join(out + [_aspp(rest, "aspp")])
        if re.fullmatch(r"ir\d_\d+", part):
            return ".".join(out + [part, _inverted_residual(rest, "expand" in node[part])])
        if part in ("conv_in", "stem") and "ir0_0" in node:
            return ".".join(out + [part, "0" if rest[0] == "conv" else "1"])
        out.append(part)
        node = node[part]
    return ".".join(out)


def _module_name(path: Tuple[str, ...], params: Mapping) -> str:
    """The port's dotted module name of the JAX module at ``path``; the
    family and the branches it takes are read off ``params`` (a params or a
    batch-stats tree: every test below names a module with a BN)."""
    top = path[0]
    if _LEGACY_STEREO_KEYS & set(params):
        return _legacy_stereo(path, params)
    if top in ("weather_clf", "projection"):
        return ".".join(path)
    if top == "net":
        if "initial_block" in params["net"]:
            return "net." + _enet(path[1:])
        if len(path) > 2 and path[1] == "feature_extractor":
            return "net.feature_extractor." + _feature_extractor(
                path[2:], params["net"]["feature_extractor"])
        return ".".join(_torch_module_name(p) for p in path)
    if top == "classifier":
        return _deeplab_head(path[1:], "project" in params["classifier"])
    if top == "feature_extractor":   # StereoDCSS's trunk
        return "feature_extractor." + _feature_extractor(path[1:], params[top])
    if top == "aggregation" and "hg1" in params[top]:
        return "aggregation." + _psmnet_hg(path[1:])
    if top == "aggregation" and "fusion0" in params[top]:
        return "aggregation." + _aggregation(path[1:])
    if top == "refinement" and "enc_img" in params[top]:
        return "refinement." + _sem_refine(path[1:])
    if top == "refinement" and "conv1a" in params[top]:
        return "refinement." + _hourglass_refine(path[1:])
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


def _is_transposed(path) -> bool:
    """ENet's transposed convs, the first conv of a ``deconv*`` step
    (``Conv2x(deconv=True)``) of the hourglass's, ``SemRefine``'s and
    GANet's ladders and of the MobileNetV2 trunk's ``up1``, ``up2``,
    ``SemRefine``'s bare ×2 deconvolutions and ``DeConv2D``'s ``deconv``."""
    return (path[-1] in ("ext_tconv", "transposed_conv", "deconv1", "deconv2", "deconv1_sem",
                         "deconv2_sem", "deconv")
            or (len(path) > 2 and path[-2:] == ("conv1", "conv")
                and (path[-3].startswith("deconv") or path[-3] in ("up1", "up2"))))


def _is_transposed_3d(path) -> bool:
    """The hourglass's ``conv5``, ``conv6`` and GCNet's ``trans1..5``."""
    return (path[-1] == "trans5"
            or (path[-1] == "conv" and re.fullmatch(r"conv[56]|trans\d", path[-2]) is not None))


def _weight(path, value: np.ndarray) -> np.ndarray:
    if value.ndim == 5:
        if _is_transposed_3d(path):   # un-flip, (I, O, kD, kH, kW)
            return value[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
        return value.transpose(4, 3, 0, 1, 2)
    if path[-2:] == ("feature_extractor", "conv1"):   # masked: the dense 7×7
        value = stem_dense_kernel_from_s2d(value)
    elif path[-1] == "stem_conv":                       # unmasked: the dense 4×4
        value = s2d_kernel_to_dense(value)
    if _is_transposed(path):   # un-flip, (I, O, kh, kw)
        return value[::-1, ::-1].transpose(2, 3, 0, 1)
    if path[-1] in ("sem_att", "disp_att"):   # a Dense gate: the 1×1 conv it is
        return value.T[:, :, None, None]
    if value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    return value.T


def _walk(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, path + (k,))
        else:
            yield path, k, np.asarray(v, np.float32)


def _is_deform_conv(params: Mapping, path) -> bool:
    """The JAX module at ``path`` is a ``DeformConv2d``, whose own
    ``kernel`` and ``bias`` sit beside its ``offset_conv``."""
    node = params
    for p in path:
        node = node[p]
    return "offset_conv" in node


def from_jax_variables(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``DCSSModel``, ``DeepLabDCSS``,
    ``ENetDCSS``, ``StereoDCSS`` or a legacy stereo feature extractor or
    head from the JAX model's ``params`` and ``batch_stats`` trees."""
    layout = params or batch_stats
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf, value in _walk(params):
        prefix = _module_name(path, layout)
        if leaf in ("kernel", "bias") and _is_deform_conv(params, path):
            prefix += ".deform_conv"
        if leaf == "conv1_kernel":   # the MobileNetV2 pyramid's unmasked s2d stem
            prefix, leaf = f"{prefix}.conv1", "weight"
            value = s2d_kernel_to_dense(value).transpose(3, 2, 0, 1)
        elif leaf == "kernel":
            value, leaf = _weight(path, value), "weight"
        elif leaf in ("scale", "alpha"):
            leaf = "weight"
        sd[f"{prefix}.{leaf}"] = torch.from_numpy(np.ascontiguousarray(value))
    for path, leaf, value in _walk(batch_stats):
        prefix = _module_name(path, layout)
        sd[f"{prefix}.{_BN_STATS[leaf]}"] = torch.from_numpy(np.array(value))
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return sd
