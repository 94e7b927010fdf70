"""ENet (Paszke et al. 2016) with the doubly-contrastive output contract —
port of the JAX package's ``models/enet.py`` (reference ``network/enet.py:
5-641``).

InitialBlock (13-channel 3×3/s2 conv ‖ 3×3/s2 max-pool, −inf padding),
encoder stages 1–3 (downsampling, regular, dilated and asymmetric
bottlenecks with PReLU, one shared slope each), decoder stages 4–5 (max-
unpooling, ReLU) and the final ×2 transposed conv, at full resolution. The
2×2 max-pool keeps each window's argmax, ties to the first in row-major
window order as JAX's ``argmax`` breaks them; unpooling puts each value back
at that place. The SupCon split happens at the stage-3 output, as in the
reference (``enet.py:584-641``). ``fine_feat0`` is the first view's stage-3
features resized to 1/4 of the input, as in JAX (the reference resizes
them to the full output); pixel contrast takes the predictions down to it.
The input is raw pixels, as in JAX and the reference.

Module names are the reference's torch ``state_dict`` names
(``initial_block.main_branch``, ``{block}.ext_conv1.{0,1,2}``, ...,
``transposed_conv``), so the JAX package's ``convert_reference_enet`` reads
the port's ``net.*`` weights as they are.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.input_pipeline import to_nhwc
from ..ops.interpolate import resize_bilinear
from .blocks import Conv2d, ConvTranspose2d, Dropout, batch_norm
from .weathernet import ProjectionHead, WeatherClassifier, nhwc, two_view_pool


class PReLU(nn.Module):
    """x ≥ 0 ? x : a·x with one learnt slope a (init 0.25), cast to x's
    dtype, as JAX's ``Act``."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


def act(relu: bool) -> nn.Module:
    return nn.ReLU() if relu else PReLU()


def max_pool_2x2_with_indices(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """2×2/stride-2 max pool of (B, C, H, W) and each window's argmax 0..3
    in row-major order, the first on ties (JAX ``max_pool_2x2_with_indices``;
    torch ``MaxPool2d(return_indices=True)``)."""
    b, c, h, w = x.shape
    windows = (x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
               .reshape(b, c, h // 2, w // 2, 4))
    idx = windows.argmax(dim=-1)
    return windows.gather(-1, idx[..., None])[..., 0], idx


def max_unpool_2x2(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Each value of (B, C, h, w) back at its window's argmax of (B, C, 2h,
    2w), zeros elsewhere (JAX ``max_unpool_2x2``; torch ``MaxUnpool2d``)."""
    b, c, h, w = y.shape
    onehot = idx[..., None] == torch.arange(4, device=idx.device)
    scattered = y[..., None] * onehot.to(y.dtype)
    return (scattered.reshape(b, c, h, w, 2, 2).permute(0, 1, 2, 4, 3, 5)
            .reshape(b, c, 2 * h, 2 * w))


class InitialBlock(nn.Module):
    def __init__(self, out_channels: int = 16, relu: bool = False):
        super().__init__()
        self.main_branch = Conv2d(3, out_channels - 3, 3, stride=2, padding=1, bias=False)
        self.batch_norm = batch_norm(out_channels)
        self.out_activation = act(relu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ext = F.max_pool2d(x, 3, stride=2, padding=1)
        return self.out_activation(self.batch_norm(torch.cat([self.main_branch(x), ext], 1)))


class RegularBottleneck(nn.Module):
    """1×1 reduce → (3×3 | dilated 3×3 | 5×1 + 1×5) → 1×1 expand, each with
    BN and activation, spatial dropout, residual add, activation."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 1,
                 asymmetric: bool = False, dropout_prob: float = 0.0, relu: bool = False):
        super().__init__()
        inter = channels // 4
        k = kernel_size
        self.ext_conv1 = nn.Sequential(Conv2d(channels, inter, 1, bias=False),
                                       batch_norm(inter), act(relu))
        if asymmetric:
            p = k // 2
            self.ext_conv2 = nn.Sequential(
                Conv2d(inter, inter, (k, 1), padding=(p, 0), bias=False), batch_norm(inter),
                act(relu), Conv2d(inter, inter, (1, k), padding=(0, p), bias=False),
                batch_norm(inter), act(relu))
        else:
            p = dilation * (k // 2)
            self.ext_conv2 = nn.Sequential(
                Conv2d(inter, inter, k, padding=p, dilation=dilation, bias=False),
                batch_norm(inter), act(relu))
        self.ext_conv3 = nn.Sequential(Conv2d(inter, channels, 1, bias=False),
                                       batch_norm(channels), act(relu))
        self.ext_regul = Dropout(dropout_prob, spatial=True)
        self.out_activation = act(relu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ext = self.ext_regul(self.ext_conv3(self.ext_conv2(self.ext_conv1(x))))
        return self.out_activation(x + ext)


class DownsamplingBottleneck(nn.Module):
    """Main: 2×2 max-pool (indices kept), channels zero-padded; ext: 2×2/s2
    → 3×3 → 1×1 bottleneck; add."""

    def __init__(self, in_channels: int, out_channels: int, dropout_prob: float = 0.0,
                 relu: bool = False):
        super().__init__()
        inter = in_channels // 4
        self.pad = out_channels - in_channels
        self.ext_conv1 = nn.Sequential(Conv2d(in_channels, inter, 2, stride=2, bias=False),
                                       batch_norm(inter), act(relu))
        self.ext_conv2 = nn.Sequential(Conv2d(inter, inter, 3, padding=1, bias=False),
                                       batch_norm(inter), act(relu))
        self.ext_conv3 = nn.Sequential(Conv2d(inter, out_channels, 1, bias=False),
                                       batch_norm(out_channels), act(relu))
        self.ext_regul = Dropout(dropout_prob, spatial=True)
        self.out_activation = act(relu)

    def forward(self, x: torch.Tensor):
        main, idx = max_pool_2x2_with_indices(x)
        main = F.pad(main, (0, 0, 0, 0, 0, self.pad))
        ext = self.ext_regul(self.ext_conv3(self.ext_conv2(self.ext_conv1(x))))
        return self.out_activation(main + ext), idx


class UpsamplingBottleneck(nn.Module):
    """Main: 1×1 conv + BN, max-unpool; ext: 1×1 → 2×2/s2 transposed conv →
    1×1 bottleneck; add."""

    def __init__(self, in_channels: int, out_channels: int, dropout_prob: float = 0.0,
                 relu: bool = True):
        super().__init__()
        inter = in_channels // 4
        self.main_conv1 = nn.Sequential(Conv2d(in_channels, out_channels, 1, bias=False),
                                        batch_norm(out_channels))
        self.ext_conv1 = nn.Sequential(Conv2d(in_channels, inter, 1, bias=False),
                                       batch_norm(inter), act(relu))
        self.ext_tconv1 = ConvTranspose2d(inter, inter, 2, stride=2, bias=False)
        self.ext_tconv1_bnorm = batch_norm(inter)
        self.ext_tconv1_activation = act(relu)
        self.ext_conv2 = nn.Sequential(Conv2d(inter, out_channels, 1, bias=False),
                                       batch_norm(out_channels))
        self.ext_regul = Dropout(dropout_prob, spatial=True)
        self.out_activation = act(relu)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        main = max_unpool_2x2(self.main_conv1(x), idx)
        ext = self.ext_tconv1_activation(self.ext_tconv1_bnorm(self.ext_tconv1(
            self.ext_conv1(x))))
        ext = self.ext_regul(self.ext_conv2(ext))
        return self.out_activation(main + ext)


# stages 2 and 3 after downsample2_0: (name, RegularBottleneck keywords)
STAGE23 = [
    ("regular2_1", {}), ("dilated2_2", {"dilation": 2}),
    ("asymmetric2_3", {"kernel_size": 5, "asymmetric": True}), ("dilated2_4", {"dilation": 4}),
    ("regular2_5", {}), ("dilated2_6", {"dilation": 8}),
    ("asymmetric2_7", {"kernel_size": 5, "asymmetric": True}), ("dilated2_8", {"dilation": 16}),
    ("regular3_0", {}), ("dilated3_1", {"dilation": 2}),
    ("asymmetric3_2", {"kernel_size": 5, "asymmetric": True}), ("dilated3_3", {"dilation": 4}),
    ("regular3_4", {}), ("dilated3_5", {"dilation": 8}),
    ("asymmetric3_6", {"kernel_size": 5, "asymmetric": True}), ("dilated3_7", {"dilation": 16}),
]


class ENet(nn.Module):
    """ENet; ``forward`` takes an NCHW (channels_last) image tensor of raw
    pixels and returns the JAX ``ENet``'s outputs, NHWC."""

    def __init__(self, num_classes: int = 19, encoder_relu: bool = False,
                 decoder_relu: bool = True):
        super().__init__()
        er, dr = encoder_relu, decoder_relu
        self.initial_block = InitialBlock(16, er)
        self.downsample1_0 = DownsamplingBottleneck(16, 64, 0.01, er)
        for i in range(1, 5):
            setattr(self, f"regular1_{i}", RegularBottleneck(64, dropout_prob=0.01, relu=er))
        self.downsample2_0 = DownsamplingBottleneck(64, 128, 0.1, er)
        for name, kw in STAGE23:
            setattr(self, name, RegularBottleneck(128, dropout_prob=0.1, relu=er, **kw))
        self.upsample4_0 = UpsamplingBottleneck(128, 64, 0.1, dr)
        self.regular4_1 = RegularBottleneck(64, dropout_prob=0.1, relu=dr)
        self.regular4_2 = RegularBottleneck(64, dropout_prob=0.1, relu=dr)
        self.upsample5_0 = UpsamplingBottleneck(64, 16, 0.1, dr)
        self.regular5_1 = RegularBottleneck(16, dropout_prob=0.1, relu=dr)
        # reference enet.py:576-583: ConvTranspose2d(k=3, s=2, p=1) run with
        # output_size = 2× the input: output_padding 1 keeps rows 1..2H of
        # the full (2H + 1)-row result, JAX's VALID conv sliced from row 1
        self.transposed_conv = ConvTranspose2d(16, num_classes, 3, stride=2, padding=1,
                                               output_padding=1, bias=False)

    def forward(self, x: torch.Tensor, return_supcon_feature: bool = False):
        h, w = x.shape[-2:]
        x = self.initial_block(x)
        x, idx1 = self.downsample1_0(x)
        for i in range(1, 5):
            x = getattr(self, f"regular1_{i}")(x)
        x, idx2 = self.downsample2_0(x)
        for name, _ in STAGE23:
            x = getattr(self, name)(x)
        fine_feat = x
        if return_supcon_feature:
            bsz = fine_feat.shape[0] // 2
            x, idx1, idx2 = x[:bsz], idx1[:bsz], idx2[:bsz]
        feat0 = x
        x = self.regular4_2(self.regular4_1(self.upsample4_0(x, idx2)))
        x = self.regular5_1(self.upsample5_0(x, idx1))
        seg = nhwc(self.transposed_conv(x)).float()
        return {"seg": seg, "seg_beforeup": seg, "fine_feat": nhwc(fine_feat),
                "fine_feat0": resize_bilinear(nhwc(feat0), (h // 4, w // 4))}


class ENetDCSS(nn.Module):
    """ENet + the weather classifier + (with ``projection``) the SupCon
    projection head, with ``DCSSModel``'s contract. ``image`` is raw pixels
    in NHWC (or planar or s2d); activations run in ``dtype``."""

    def __init__(self, num_classes: int = 19, weather_num: int = 4,
                 projection: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.net = ENet(num_classes)
        self.weather_clf = WeatherClassifier(128, weather_num)
        self.projection = ProjectionHead(128, 128) if projection else None

    def _input(self, image: torch.Tensor) -> torch.Tensor:
        return to_nhwc(image).to(self.dtype).permute(0, 3, 1, 2)

    def seg_logits(self, image: torch.Tensor) -> torch.Tensor:
        """Serving's entry: ``forward``'s float32 ``seg_beforeup`` (ENet's
        full-resolution ``seg``), without the weather head."""
        return self.net(self._input(image))["seg_beforeup"]

    def forward(self, image: torch.Tensor,
                return_supcon_feature: bool = False) -> Dict[str, torch.Tensor]:
        out = self.net(self._input(image), return_supcon_feature)
        out["weather_logits"] = self.weather_clf(out["fine_feat0"])
        if return_supcon_feature:
            out["supcon_proj"] = self.projection(two_view_pool(out["fine_feat"]))
        return out


def build_enet_dcss(cfg, dtype: torch.dtype) -> ENetDCSS:
    return ENetDCSS(cfg.num_classes, cfg.weather_num, projection=cfg.use_supcon, dtype=dtype)
