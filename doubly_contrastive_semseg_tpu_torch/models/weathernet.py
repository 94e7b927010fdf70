"""WeatherNet, the weather classifier, the SupCon projection head and the
model factory — port of the JAX package's ``models/weathernet.py``
(reference ``network/weathernet.py:14-105``, ``network/classifier.py``).

Outputs are dicts with the JAX package's keys, in its NHWC layout. Training
mode is the module's (``model.train()``), where JAX passes ``train=True``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ..ops.input_pipeline import image_hw
from ..ops.interpolate import resize_bilinear
from .blocks import BNReluConv, init_weights
from .resnet_pyramid import resnet18_pyramid, resnet34_pyramid

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def two_view_pool(fine_feat: torch.Tensor) -> torch.Tensor:
    """(2B, h, w, D) → (B, 2, D): each view's global average pool, the
    projection head's input (reference ``utils/loss.py:114-120``)."""
    pooled = fine_feat.mean(dim=(1, 2))
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
        x = feats.mean(dim=(1, 2))
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


class WeatherNet(nn.Module):
    """Pyramid backbone → 1×1 BNReluConv seg head → bilinear upsample to the
    input size (reference ``network/weathernet.py:60-98``)."""

    def __init__(self, backbone: str = "resnet18", num_classes: int = 19,
                 fuse_stem: bool = True, efficient: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if backbone == "resnet18":
            factory = resnet18_pyramid
        elif backbone == "resnet34":
            factory = resnet34_pyramid
        else:
            raise NotImplementedError(
                f"backbone {backbone!r} is not ported yet (see ROADMAP.md)")
        self.feature_extractor = factory(fuse_stem=fuse_stem, efficient=efficient,
                                         dtype=dtype)
        self.segmentation = BNReluConv(128, num_classes, k=1, bias=True)

    def forward(self, image: torch.Tensor,
                return_supcon_feature: bool = False) -> Dict[str, torch.Tensor]:
        """With ``return_supcon_feature`` the batch is the two-view concat
        (2B, H, W, 3) and only the first view (``fine_feat0``) feeds the seg
        head (reference ``weathernet.py:76-85``)."""
        feat, additional = self.feature_extractor(image)
        feat0 = feat[:feat.shape[0] // 2] if return_supcon_feature else feat
        seg_beforeup = self.seg_logits(feat0)
        return {
            "seg": resize_bilinear(seg_beforeup, image_hw(image)),
            "seg_beforeup": seg_beforeup,
            "fine_feat": nhwc(feat),
            "fine_feat0": nhwc(feat0),
            "skips_0": nhwc(additional["skips_0"]),
        }

    def seg_logits(self, feat: torch.Tensor) -> torch.Tensor:
        """The seg head's (B, h, w, classes) float32 logits of the decoder
        features (B, 128, h, w)."""
        return nhwc(self.segmentation(feat)).float()


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

    def forward(self, image: torch.Tensor,
                return_supcon_feature: bool = False) -> Dict[str, torch.Tensor]:
        """``return_supcon_feature``: ``image`` is the two-view concat
        (2B, H, W, 3); ``supcon_proj`` is the (B, 2, 128) projection of the
        globally pooled features of both views (reference
        ``utils/loss.py:114-120``)."""
        out = self.net(image, return_supcon_feature)
        out["weather_logits"] = self.weather_clf(out["fine_feat0"])
        if return_supcon_feature:
            if self.projection is None:
                raise ValueError("DCSSModel: return_supcon_feature needs a model "
                                 "built with projection=True")
            out["supcon_proj"] = self.projection(two_view_pool(out["fine_feat"]))
        return out


def build_model(cfg, device="cuda", seed: int = 0) -> nn.Module:
    """Model factory (reference ``utils/init_trainer.py:97-111``), routed as
    JAX's: ``--deeplab`` or a ``deeplabv3*`` name → ``DeepLabDCSS``,
    ``enet`` → ``ENetDCSS``, ``resnet18`` / ``resnet34`` → ``DCSSModel``.
    Weights are drawn from ``torch.Generator`` seeded by ``seed``; the model
    is returned in eval mode. A SupCon criterion (``cfg.use_supcon``) adds
    the projection head. Runs on the card unless ``device`` asks for the
    CPU. The names not ported yet raise ``NotImplementedError``
    (``config.check_ported``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    dtype = _DTYPES[cfg.compute_dtype]
    if cfg.deeplab or cfg.model.startswith("deeplabv3"):
        from .deeplab import build_deeplab_dcss
        model = build_deeplab_dcss(cfg, dtype)
    elif cfg.model == "enet":
        from .enet import build_enet_dcss
        model = build_enet_dcss(cfg, dtype)
    elif cfg.model in ("resnet18", "resnet34"):
        model = DCSSModel(backbone=cfg.model, num_classes=cfg.num_classes,
                          weather_num=cfg.weather_num, fuse_stem=cfg.fuse_stem,
                          efficient=cfg.efficient, projection=cfg.use_supcon, dtype=dtype)
    else:
        raise NotImplementedError(
            f"model {cfg.model!r} is not ported yet (see ROADMAP.md §1 item 4)")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device=device, memory_format=torch.channels_last).eval()
