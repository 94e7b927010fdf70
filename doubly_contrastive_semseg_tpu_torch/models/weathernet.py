"""WeatherNet, the weather classifier, the SupCon projection head and the
model factory — port of the JAX package's ``models/weathernet.py``
(reference ``network/weathernet.py:14-105``, ``network/classifier.py``).

Outputs are dicts with the JAX package's keys, in its NHWC layout. Training
mode is the module's (``model.train()``), where JAX passes ``train=True``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..ops.input_pipeline import image_hw
from ..ops.interpolate import resize_bilinear, resize_bilinear_cols
from ..parallel.spatial import global_width, spatial_mean, split_active
from .blocks import BNReluConv, init_weights
from .efficientnet_pyramid import PyramidEfficientNet
from .mobilenetv2_pyramid import PyramidMobileNetV2
from .resnet_pyramid import PyramidResNet, resnet18_pyramid, resnet34_pyramid
from .resnet_pyramid_back import resnet18_pyramid_back
from .swiftnet_single import BACKBONES as SINGLE_SCALE
from .swiftnet_single import RGBDSwiftNet

# the backbones JAX builds without the fused stem and remat (weathernet.py:99-122)
_PLAIN = {"efficientnetb0": PyramidEfficientNet, "mobilenetv2": PyramidMobileNetV2,
          "resnet18_back": resnet18_pyramid_back, **SINGLE_SCALE}
# JAX's DCSSModel backbones (weathernet.py:88-122, build_model :209-212)
BACKBONES = ("resnet18", "resnet34") + tuple(_PLAIN)

# float64 (the port's alone) for exactness checks on the CPU, where no
# rounding-level difference may flip a ReLU gate: its parameters are float64
# too (one-process BatchNorm takes one dtype)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64}


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def two_view_pool(fine_feat: torch.Tensor) -> torch.Tensor:
    """(2B, h, w, D) → (B, 2, D): each view's global average pool, the
    projection head's input (reference ``utils/loss.py:114-120``)."""
    return two_views(fine_feat.mean(dim=(1, 2)))


def two_views(pooled: torch.Tensor) -> torch.Tensor:
    """(2B, D) pooled features of the two-view concat → (B, 2, D)."""
    bsz = pooled.shape[0] // 2
    return torch.stack([pooled[:bsz], pooled[bsz:]], dim=1)


class WeatherClassifier(nn.Module):
    """Global average pool → Linear(C → weather_num), a monitoring head
    (reference ``network/classifier.py:6-32``); C is the model's feature
    width (128, or the DeepLab backbone's). Takes NHWC features."""

    def __init__(self, in_features: int = 128, weather_num: int = 4):
        super().__init__()
        self.fc = nn.Linear(in_features, weather_num)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.classify(feats.mean(dim=(1, 2)))

    def classify(self, x: torch.Tensor) -> torch.Tensor:
        """The linear layer on (B, C) pooled features."""
        return nn.functional.linear(x, self.fc.weight.to(x.dtype),
                                    self.fc.bias.to(x.dtype)).float()


class ProjectionHead(nn.Module):
    """Linear → ReLU → Linear projection for image-level contrast (reference
    ``utils/loss.py:104-109``; dim_in 128 for SwiftNet and ENet, the
    backbone's width for DeepLab), the ``projection`` of a model built for a
    SupCon criterion; the eval path does not use it."""

    def __init__(self, in_features: int = 128, feat_dim: int = 128):
        super().__init__()
        self.fc1 = nn.Linear(in_features, in_features)
        self.fc2 = nn.Linear(in_features, feat_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(nn.functional.linear(x, self.fc1.weight.to(x.dtype),
                                            self.fc1.bias.to(x.dtype)))
        return nn.functional.linear(x, self.fc2.weight.to(x.dtype),
                                    self.fc2.bias.to(x.dtype)).float()


def feature_extractor(backbone: str, fuse_stem: bool = True, efficient: bool = True,
                      dtype: torch.dtype = torch.float32) -> nn.Module:
    """WeatherNet's backbone by name, as JAX routes it
    (``weathernet.py:88-122``): the pyramid ResNets take ``fuse_stem`` and
    ``efficient``, the six others neither."""
    if backbone in ("resnet18", "resnet34"):
        factory = resnet18_pyramid if backbone == "resnet18" else resnet34_pyramid
        return factory(fuse_stem=fuse_stem, efficient=efficient, dtype=dtype)
    if backbone in _PLAIN:
        return _PLAIN[backbone](dtype)
    raise NotImplementedError(f"backbone {backbone}")


class WeatherNet(nn.Module):
    """Pyramid backbone → 1×1 BNReluConv seg head → bilinear upsample to the
    input size (reference ``network/weathernet.py:60-98``)."""

    def __init__(self, backbone: str = "resnet18", num_classes: int = 19,
                 fuse_stem: bool = True, efficient: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.feature_extractor = feature_extractor(backbone, fuse_stem, efficient, dtype)
        self.segmentation = BNReluConv(128, num_classes, k=1, bias=True)

    def forward(self, image: torch.Tensor, return_supcon_feature: bool = False,
                depth: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """With ``return_supcon_feature`` the batch is the two-view concat
        (2B, H, W, 3) and only the first view (``fine_feat0``) feeds the seg
        head (reference ``weathernet.py:76-85``). ``depth`` reaches the RGB-D
        backbone only (zeros when not given, as in JAX). On a model axis of
        more than one rank, ``forward_split``."""
        if split_active():
            return self.forward_split(image, return_supcon_feature)[0]
        if isinstance(self.feature_extractor, RGBDSwiftNet):
            feat, additional = self.feature_extractor(image, depth)
        else:
            feat, additional = self.feature_extractor(image)
        feat0 = feat[:feat.shape[0] // 2] if return_supcon_feature else feat
        seg_beforeup = self.segmentation.nhwc_logits(feat0)
        return {
            "seg": resize_bilinear(seg_beforeup, image_hw(image)),
            "seg_beforeup": seg_beforeup,
            "fine_feat": nhwc(feat),
            "fine_feat0": nhwc(feat0),
            "skips_0": nhwc(additional["skips_0"]),
        }

    def features_split(self, image: torch.Tensor):
        """The backbone on a width-split image: ((H, W) of the whole image,
        this rank's columns of the (B, 128, h, w) features, w, the
        backbone's ``additional`` of this rank's columns). Raises, before
        any collective, for a backbone other than the pyramid ResNets and
        for what ``PyramidResNet.check_split`` refuses."""
        fe = self.feature_extractor
        if type(fe) is not PyramidResNet:
            raise NotImplementedError(
                f"WeatherNet: the width-split forward of {type(fe).__name__} is not ported "
                "(ROADMAP.md: the other model families under the model axis)")
        fe.check_split()
        h, w_local = image_hw(image)
        width = global_width(w_local, image.device)
        return ((h, width),) + fe.forward_split(image, width)

    def forward_split(self, image: torch.Tensor, return_supcon_feature: bool = False):
        """The eval forward on a width-split image (``parallel/spatial.py``,
        the JAX mesh's ``P(None, None, "model", None)``): this rank's
        columns of an NHWC or planar image → (the outputs, each map this
        rank's columns of it, ``seg`` of the whole image's size; the
        feature map's width). Raises as ``features_split`` does."""
        size, feat, wf, additional = self.features_split(image)
        feat0 = feat[:feat.shape[0] // 2] if return_supcon_feature else feat
        seg_beforeup = self.segmentation.forward_cols(feat0, wf)[0].permute(0, 2, 3, 1).float()
        return {
            "seg": resize_bilinear_cols(seg_beforeup, wf, size),
            "seg_beforeup": seg_beforeup,
            "fine_feat": nhwc(feat),
            "fine_feat0": nhwc(feat0),
            "skips_0": nhwc(additional["skips_0"]),
        }, wf


class DCSSModel(nn.Module):
    """WeatherNet plus the weather classifier and, with ``projection``, the
    SupCon projection head, with the JAX ``DCSSModel``'s outputs. ``image``
    is pixels in NHWC, planar or s2d layout (``ops/input_pipeline.py::
    to_nhwc``), as in JAX; parameters are float32 and activations run in
    ``dtype``. The JAX model's parameter tree holds ``projection`` exactly
    when it was initialised with ``return_supcon_feature=True``."""

    def __init__(self, backbone: str = "resnet18", num_classes: int = 19,
                 weather_num: int = 4, fuse_stem: bool = True,
                 efficient: bool = True, projection: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net = WeatherNet(backbone, num_classes, fuse_stem, efficient, dtype)
        self.weather_clf = WeatherClassifier(128, weather_num)
        self.projection = ProjectionHead(128, 128) if projection else None

    def forward(self, image: torch.Tensor, return_supcon_feature: bool = False,
                depth: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """``return_supcon_feature``: ``image`` is the two-view concat
        (2B, H, W, 3); ``supcon_proj`` is the (B, 2, 128) projection of the
        globally pooled features of both views (reference
        ``utils/loss.py:114-120``). ``depth``: the RGB-D backbone's."""
        if return_supcon_feature and self.projection is None:
            raise ValueError("DCSSModel: return_supcon_feature needs a model "
                             "built with projection=True")
        if split_active():
            return self.forward_split(image, return_supcon_feature)
        out = self.net(image, return_supcon_feature, depth)
        out["weather_logits"] = self.weather_clf(out["fine_feat0"])
        if return_supcon_feature:
            out["supcon_proj"] = self.projection(two_view_pool(out["fine_feat"]))
        return out

    def forward_split(self, image: torch.Tensor,
                      return_supcon_feature: bool = False) -> Dict[str, torch.Tensor]:
        """``WeatherNet.forward_split``'s outputs, plus ``weather_logits`` and
        ``supcon_proj`` from the global pools of the features
        (``spatial_mean`` over the model group), the same on every rank of
        it. ``forward`` takes this route on a model axis of more than one
        rank."""
        out, wf = self.net.forward_split(image, return_supcon_feature)
        out["weather_logits"] = self.weather_clf.classify(spatial_mean(out["fine_feat0"], wf))
        if return_supcon_feature:
            out["supcon_proj"] = self.projection(two_views(spatial_mean(out["fine_feat"], wf)))
        return out


def check_device(device, what: str) -> torch.device:
    """``device`` as a ``torch.device``; ``what`` (an entry point's name)
    raises if it asks for the card and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    return device


def build_model(cfg, device="cuda", seed: int = 0) -> nn.Module:
    """Model factory (reference ``utils/init_trainer.py:97-111``), routed as
    JAX's: ``--deeplab`` or a ``deeplabv3*`` name → ``DeepLabDCSS``,
    ``enet`` → ``ENetDCSS``, a WeatherNet backbone (``BACKBONES``) →
    ``DCSSModel``. Weights are drawn from ``torch.Generator`` seeded by
    ``seed``; the model is returned in eval mode. A SupCon criterion
    (``cfg.use_supcon``) adds the projection head. Runs on the card unless
    ``device`` asks for the CPU."""
    device = check_device(device, "build_model")
    dtype = _DTYPES[cfg.compute_dtype]
    if cfg.deeplab or cfg.model.startswith("deeplabv3"):
        from .deeplab import build_deeplab_dcss
        model = build_deeplab_dcss(cfg, dtype)
    elif cfg.model == "enet":
        from .enet import build_enet_dcss
        model = build_enet_dcss(cfg, dtype)
    elif cfg.model in BACKBONES:
        model = DCSSModel(backbone=cfg.model, num_classes=cfg.num_classes,
                          weather_num=cfg.weather_num, fuse_stem=cfg.fuse_stem,
                          efficient=cfg.efficient, projection=cfg.use_supcon, dtype=dtype)
    else:
        raise NotImplementedError(f"model {cfg.model}")
    init_weights(model, torch.Generator().manual_seed(seed))
    if dtype == torch.float64:
        model.double()
    return model.to(device=device, memory_format=torch.channels_last).eval()
