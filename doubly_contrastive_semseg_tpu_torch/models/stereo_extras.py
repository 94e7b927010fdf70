"""The stereo aggregations and refinement heads — the port's copy of the JAX
package's ``models/stereo_extras.py``: the 3-D cost aggregations
(``Conv3D``, ``TransConv3D``, ``StereoNetAggregation``,
``PSMNetBasicAggregation``, ``PSMNetHGAggregation`` with its hourglass,
``GCNetAggregation``, ``:85-301``), GANet's ``BasicConv`` and ``Conv2x``
(``:309-367``, also the hourglass SwiftNet's disparity branch), the
``conv2d`` encoder helper, the warp-error refinements
``StereoDRNetRefinement`` and ``HourglassRefinement`` (``:377-449``),
``SemRefine`` with the nine published variants of ``REFINE_NEW_VARIANTS``
(``:499-664``), and the factories ``make_refinement`` and
``make_aggregation``.

Volumes are NCDHW, (B, C, D, H, W), the layout of torch's 3-D convolutions
(JAX's (B, D, H, W, C)); an aggregation returns (B, D', H', W') float32
with the disparity bins on axis 1, what ``soft_argmin_disparity`` reads.
A ``Conv3D`` is a 3×3×3 conv (padding 1, no bias) → BN → LeakyReLU(0.2),
ReLU or nothing; a ``TransConv3D`` is JAX's VALID ``ConvTranspose`` cut
by one row at the start of each spatial axis, which is torch's
``ConvTranspose3d(k=3, s=2, p=1, output_padding=1)`` with the kernel
flipped on all three axes (``utils/convert.py`` undoes the flip). GCNet's
last transposed conv is JAX's SAME one: the first 2n rows of the VALID
result (the reference's 2n − 1 is not followed).

Module names are the reference's where the JAX package's converters read
them: ``convert_reference_refinement`` (``conv`` and ``bn`` in a
``BasicConv``, ``conv1`` and ``conv2`` in a ``Conv2x``; in ``SemRefine``
the stem ``conv0`` and ``bn``, the encoders ``conv{1,2,3}.{0,1}``, the
gates ``{sem,disp}_attention.1``, the ladder ``conv_start``,
``conv{1..4}{a,b}``, ``deconv{1..4}{a,b}``, the bare transposed convs
``deconv1``, ``deconv2``, ``deconv1_sem``, ``deconv2_sem``, and the heads
``final_conv_disp``, ``final_conv_sem``; in ``HourglassRefinement`` the
encoders ``conv{1,2}.{0,1}``, the deformable ``conv_start``, ``conv3a``,
``conv4a`` and the head ``final_conv``) and ``convert_reference_psmnet_hg``
(``dres0.{0,2}``, ``dres1.{0,2}``, a conv-BN pair ``.{0,1}`` each, the
hourglasses ``dres{2,3,4}.conv{1..6}``, the classifiers
``classif{1,2,3}.{0,2}``). The other aggregations and
``StereoDRNetRefinement`` have no reference converter and keep JAX's
names. A 2-D transposed conv is torch's ``ConvTranspose2d(k=4, s=2,
p=1)``: JAX's SAME ``ConvTranspose`` with its kernel flipped.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_conv import DeformConv2d
from ..ops.input_pipeline import image_hw, to_nhwc
from ..ops.interpolate import resize_bilinear
from ..ops.stem import fused_stem_pool
from ..ops.warp import disp_warp
from .blocks import (Conv2d, Conv3d, ConvTranspose2d, ConvTranspose3d, TorchBatchNorm3d,
                     batch_norm, conv_kxk, max_pool_3x3_s2)


# ---- 3-D cost aggregation -----------------------------------------------------------

C3D = 32   # the 3-D aggregations' width (GCNet's first and last levels too)


def conv_bn_3d(in_features: int, features: int, stride: int = 1) -> nn.Sequential:
    """3×3×3 conv (padding 1, no bias) → BN: the reference's ``convbn_3d``."""
    return nn.Sequential(Conv3d(in_features, features, 3, stride=stride, padding=1, bias=False),
                         TorchBatchNorm3d(features))


class Conv3D(nn.Sequential):
    """``conv`` 3×3×3 at ``stride`` (padding 1, no bias) → ``bn`` → ``act``:
    LeakyReLU(0.2) (``leaky``), ReLU (``relu``) or nothing (``None``)
    (reference ``aggregation.py:8-21``; JAX ``Conv3D``)."""

    def __init__(self, in_features: int, features: int, stride: int = 1, act="leaky"):
        conv, bn = conv_bn_3d(in_features, features, stride)
        acts = {"leaky": [nn.LeakyReLU(0.2)], "relu": [nn.ReLU()], None: []}[act]
        super().__init__(OrderedDict([("conv", conv), ("bn", bn)] + [("act", m) for m in acts]))


def transposed_bn_3d(in_features: int, features: int) -> nn.Sequential:
    """×2 transposed 3×3×3 conv (torch ``p=1, output_padding=1``: JAX's
    VALID + ``[1:]``) → BN (the PSMNet hourglass's ``conv5``, ``conv6``)."""
    return nn.Sequential(ConvTranspose3d(in_features, features, 3, stride=2, padding=1,
                                         output_padding=1, bias=False),
                         TorchBatchNorm3d(features))


class TransConv3D(nn.Sequential):
    """``conv`` → ``bn`` of ``transposed_bn_3d`` → ReLU (reference
    ``trans_conv3x3_3d``)."""

    def __init__(self, in_features: int, features: int):
        conv, bn = transposed_bn_3d(in_features, features)
        super().__init__(OrderedDict([("conv", conv), ("bn", bn), ("act", nn.ReLU())]))


class ConvTranspose3dSame(ConvTranspose3d):
    """×2 transposed 3×3×3 conv with JAX's SAME rule: torch's full result
    (padding 0, 2n + 1 rows an axis) cut to its first 2n rows."""

    def __init__(self, in_features: int, features: int):
        super().__init__(in_features, features, 3, stride=2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d, h, w = x.shape[2:]
        return super().forward(x)[..., :2 * d, :2 * h, :2 * w]


def upsample_volume_4x(vol: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W) → (B, 4D, 4H, 4W) float32, trilinear ×4 with half-pixel
    centres (reference PSMNet ``F.interpolate(cost, scale_factor=4,
    'trilinear')``), as JAX computes it: bilinear on H and W in the
    volume's dtype, then linear on D with clipped neighbours."""
    d = vol.shape[1]
    v = F.interpolate(vol, size=(4 * vol.shape[2], 4 * vol.shape[3]), mode="bilinear",
                      align_corners=False)
    pos = (torch.arange(4 * d, dtype=torch.float32, device=vol.device) + 0.5) / 4.0 - 0.5
    lo = torch.floor(pos).long().clamp(0, d - 1)
    hi = (lo + 1).clamp(0, d - 1)
    frac = (pos - lo).clamp(0.0, 1.0)[:, None, None]
    return v[:, lo] * (1 - frac) + v[:, hi] * frac


class StereoNetAggregation(nn.Module):
    """Four ``Conv3D`` (LeakyReLU) and a biased 3×3×3 ``final`` conv to one
    channel over the difference volume (reference ``aggregation.py:70-92``):
    (B, C, D, h, w) → (B, D, h, w) float32 matching similarities."""

    def __init__(self, in_features: int = 128):
        super().__init__()
        for i in range(4):
            setattr(self, f"agg{i}", Conv3D(in_features if i == 0 else C3D, C3D))
        self.final = Conv3d(C3D, 1, 3, padding=1, bias=True)

    def forward(self, vol: torch.Tensor) -> torch.Tensor:
        x = vol
        for i in range(4):
            x = getattr(self, f"agg{i}")(x)
        return self.final(x)[:, 0].float()


class PSMNetBasicAggregation(nn.Module):
    """PSMNet's "basic" aggregation over the concat volume (reference
    ``aggregation.py:94-145``): two ``Conv3D``, four residual pairs, a
    classifier to one channel, upsampled ×4 trilinearly: (B, 2C, D, h, w)
    → (B, 4D, 4h, 4w) float32 matching costs."""

    def __init__(self, in_features: int = 256):
        super().__init__()
        c = C3D
        self.dres0_0 = Conv3D(in_features, c, act="relu")
        self.dres0_1 = Conv3D(c, c, act="relu")
        for i in range(1, 5):
            setattr(self, f"dres{i}_0", Conv3D(c, c, act="relu"))
            setattr(self, f"dres{i}_1", Conv3D(c, c, act=None))
        self.classify0 = Conv3D(c, c, act="relu")
        self.classify1 = Conv3d(c, 1, 3, padding=1, bias=False)

    def forward(self, vol: torch.Tensor) -> torch.Tensor:
        x = self.dres0_1(self.dres0_0(vol))
        for i in range(1, 5):
            x = x + getattr(self, f"dres{i}_1")(getattr(self, f"dres{i}_0")(x))
        return upsample_volume_4x(self.classify1(self.classify0(x))[:, 0])


class PSMNetHourglass(nn.Module):
    """PSMNet's 3-D hourglass (reference ``aggregation.py:147-192``): /2 →
    /4 → ×2 → ×4, the /2 level fused with ``postsqu`` on the way down and
    with ``presqu`` (else its own) on the way up. Returns (out, pre,
    post)."""

    def __init__(self):
        super().__init__()
        c = C3D
        self.conv1 = nn.Sequential(conv_bn_3d(c, 2 * c, 2), nn.ReLU())
        self.conv2 = conv_bn_3d(2 * c, 2 * c)
        self.conv3 = nn.Sequential(conv_bn_3d(2 * c, 2 * c, 2), nn.ReLU())
        self.conv4 = nn.Sequential(conv_bn_3d(2 * c, 2 * c), nn.ReLU())
        self.conv5 = transposed_bn_3d(2 * c, 2 * c)
        self.conv6 = transposed_bn_3d(2 * c, c)

    def forward(self, x, presqu, postsqu):
        pre = self.conv2(self.conv1(x))
        pre = torch.relu(pre if postsqu is None else pre + postsqu)
        up = self.conv5(self.conv4(self.conv3(pre)))
        post = torch.relu(up + (pre if presqu is None else presqu))
        return self.conv6(post), pre, post


class PSMNetHGAggregation(nn.Module):
    """PSMNet's stacked hourglass aggregation (reference
    ``aggregation.py:194-258``) over the concat volume: ``dres0``,
    ``dres1`` (residual), three chained hourglasses ``dres2..4`` reusing
    the first's ``pre`` and the previous one's ``post``, and a classifier
    after each whose costs add up. Returns a list of (B, 4D, 4h, 4w)
    float32 costs upsampled ×4: all three in training (the deep
    supervision), the last alone in eval."""

    def __init__(self, in_features: int = 256):
        super().__init__()
        c = C3D
        self.dres0 = nn.Sequential(conv_bn_3d(in_features, c), nn.ReLU(), conv_bn_3d(c, c),
                                   nn.ReLU())
        self.dres1 = nn.Sequential(conv_bn_3d(c, c), nn.ReLU(), conv_bn_3d(c, c))
        for i in (2, 3, 4):
            setattr(self, f"dres{i}", PSMNetHourglass())
        for i in (1, 2, 3):
            setattr(self, f"classif{i}", nn.Sequential(
                conv_bn_3d(c, c), nn.ReLU(), Conv3d(c, 1, 3, padding=1, bias=False)))

    def forward(self, vol: torch.Tensor) -> List[torch.Tensor]:
        x = self.dres0(vol)
        cost0 = x + self.dres1(x)
        out1, pre1, post1 = self.dres2(cost0, None, None)
        out1 = out1 + cost0
        out2, _, post2 = self.dres3(out1, pre1, post1)
        out2 = out2 + cost0
        out3, _, _ = self.dres4(out2, pre1, post2)
        out3 = out3 + cost0
        costs, prev = [], None
        for i, o in enumerate((out1, out2, out3), start=1):
            h = getattr(self, f"classif{i}")(o)[:, 0]
            prev = h if prev is None else h + prev
            costs.append(prev)
        return [upsample_volume_4x(c) for c in (costs if self.training else costs[-1:])]


class GCNetAggregation(nn.Module):
    """GCNet's encoder-decoder aggregation (reference
    ``aggregation.py:260-311``) over the concat volume: four stride-2
    ``Conv3D`` stages (each refined by two more), five ×2 transposed stages
    with additive skips, the last JAX's SAME one (``trans5``, the first 2n
    rows). (B, 2C, D, h, w) → (B, 2D, 2h, 2w) float32 matching costs. The
    skips meet only where D, h and w are multiples of 16."""

    def __init__(self, in_features: int = 256):
        super().__init__()
        self.conv1_0 = Conv3D(in_features, C3D, act="relu")
        self.conv1_1 = Conv3D(C3D, C3D, act="relu")
        self.conv2a = Conv3D(in_features, 64, stride=2, act="relu")
        for lvl, cin, cout in ((2, 64, 64), (3, 64, 64), (4, 64, 64), (5, 64, 128)):
            if lvl > 2:
                setattr(self, f"conv{lvl}a", Conv3D(cin, cout, stride=2, act="relu"))
            setattr(self, f"conv{lvl}b_0", Conv3D(cout, cout, act="relu"))
            setattr(self, f"conv{lvl}b_1", Conv3D(cout, cout, act="relu"))
        for i, (cin, cout) in enumerate(((128, 64), (64, 64), (64, 64), (64, C3D)), start=1):
            setattr(self, f"trans{i}", TransConv3D(cin, cout))
        self.trans5 = ConvTranspose3dSame(C3D, 1)

    def forward(self, vol: torch.Tensor) -> torch.Tensor:
        d, h, w = vol.shape[2:]
        if d % 16 or h % 16 or w % 16:
            raise ValueError(f"GCNet's volume of {d} disparities at {h}x{w} needs all three "
                             f"multiples of 16: max_disp and the image's sides multiples of 64")
        conv1 = self.conv1_1(self.conv1_0(vol))
        skips, x = [], vol
        for lvl in (2, 3, 4, 5):
            x = getattr(self, f"conv{lvl}a")(x)
            skips.append(getattr(self, f"conv{lvl}b_1")(getattr(self, f"conv{lvl}b_0")(x)))
        t = self.trans1(skips[3])
        for i, skip in ((2, skips[2]), (3, skips[1]), (4, skips[0])):
            t = getattr(self, f"trans{i}")(t + skip)
        return self.trans5(t + conv1)[:, 0].float()


class BasicConv(nn.Module):
    """3×3 conv at ``stride`` (padding 1), or the ×2 transposed conv with
    ``deconv``, → BN → ReLU."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 deconv: bool = False):
        super().__init__()
        if deconv:
            self.conv = ConvTranspose2d(in_features, features, 4, stride=2, padding=1,
                                        bias=False)
        else:
            self.conv = Conv2d(in_features, features, 3, stride=stride, padding=1, bias=False)
        self.bn = batch_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class Conv2x(nn.Module):
    """The U-net step: a stride-2 ``BasicConv`` (or the ×2 transposed one),
    concatenated with the skip (``features`` channels), then a fusing 3×3
    ``BasicConv``. ``mdconv`` is accepted and ignored, as in the reference
    (``network/feature.py:1020-1028``): ``conv2`` is always a plain conv."""

    def __init__(self, in_features: int, features: int, deconv: bool = False,
                 mdconv: bool = False):
        super().__init__()
        self.conv1 = BasicConv(in_features, features, stride=2, deconv=deconv)
        self.conv2 = BasicConv(2 * features, features)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        return self.conv2(torch.cat([x, skip.to(x.dtype)], dim=1))


def conv_bn_lrelu(in_features: int, features: int) -> nn.Sequential:
    """3×3 conv → BN → LeakyReLU(0.2), the refinement heads' ``conv2d``
    helper (reference ``refinement.py:12-17``; JAX ``_ConvBNLRelu``)."""
    return nn.Sequential(conv_kxk(in_features, features, 3), batch_norm(features),
                         nn.LeakyReLU(0.2))


def se_gate(channels: int) -> nn.Sequential:
    """The reference's ``attention``: global average pool → 1×1 conv →
    sigmoid (``refinement.py:809-814``); JAX's ``_se_gate`` Dense is the
    1×1 conv."""
    return nn.Sequential(nn.AdaptiveAvgPool2d(1), Conv2d(channels, channels, 1, bias=True),
                         nn.Sigmoid())


def _bare_deconv() -> ConvTranspose2d:
    """The heads' ×2 ``ConvTranspose2d(32, 32, 4, 2, 1)``, no BN or ReLU
    (reference ``refinement.py:336-345``)."""
    return ConvTranspose2d(32, 32, 4, stride=2, padding=1, bias=False)


_LADDER = ((32, 48), (48, 64), (64, 96), (96, 128))


def u_net_pass(module: nn.Module, x: torch.Tensor, rem: list, suffix: str) -> torch.Tensor:
    """One U-net pass of ``module``: down through ``conv{1..4}{suffix}`` (a
    single-input step in the a-pass, a ``Conv2x`` fed the skip in the
    b-pass), up through the ``Conv2x`` ``deconv{4..1}{suffix}``; ``rem``
    holds the skips of levels 0–4, each replaced by the step that last
    reached its level."""
    for i in range(1, 5):
        step = getattr(module, f"conv{i}{suffix}")
        x = step(x) if suffix == "a" else step(x, rem[i])
        rem[i] = x
    for i in range(4, 0, -1):
        x = getattr(module, f"deconv{i}{suffix}")(x, rem[i - 1])
        rem[i - 1] = x
    return x


class SemRefine(nn.Module):
    """The ``Refine_disp_sem`` / ``Refine_New*`` skeleton with its variants
    as fields (reference ``refinement.py:207-1093``; JAX ``SemRefine``): a
    7×7/s2 + max-pool stem over the raw left image, three encoders (image
    features, low-res disparity, semantic features) fused by concat or sum,
    a 4-level ``BasicConv``/``Conv2x`` U-net, an optional second pass
    (New10), the disparity head deconvolved ×4 and the semantic head.

    ``disp_in_channels`` and ``sem_in_channels`` are the encoders' input
    widths (``StereoDCSS`` feeds a one-channel disparity to every variant);
    ``sem_channels`` is the semantic head's width. The ladder halves the
    1/4-resolution grid four times, so H and W must be multiples of 64 for
    the skips to meet, as in JAX. At eval with ``fuse_stem`` the stem is K2
    (``ops/stem.py::fused_stem_pool``: its kernel on the card, its plain
    version on the CPU) with ``bn`` folded at eps 1e-5; otherwise conv →
    BN → ReLU → 3×3/s2 pool. The disparity head runs its deconv → deconv →
    3×3 chain: JAX's eval-time composed form of it is the same function.
    Returns ((B, H, W) float32 disparity, (B, h', w', sem_channels) float32
    semantic logits in NHWC)."""

    def __init__(self, enc_ch: int = 16, combine: str = "concat", input_attention: bool = False,
                 sem_head_full_res: bool = True, second_pass: bool = False,
                 disp_in_channels: int = 1, sem_in_channels: int = 128,
                 sem_channels: int = 128, raw_disp_head: bool = False, fuse_stem: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.combine, self.input_attention = combine, input_attention
        self.sem_head_full_res, self.second_pass = sem_head_full_res, second_pass
        self.raw_disp_head, self.fuse_stem, self.dtype = raw_disp_head, fuse_stem, dtype
        self.conv0 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn = batch_norm(64)
        if input_attention:
            self.sem_attention = se_gate(sem_in_channels)
            self.disp_attention = se_gate(disp_in_channels)
        self.conv1 = conv_bn_lrelu(64, enc_ch)
        self.conv2 = conv_bn_lrelu(disp_in_channels, enc_ch)
        self.conv3 = conv_bn_lrelu(sem_in_channels, enc_ch)
        self.conv_start = BasicConv(3 * enc_ch if combine == "concat" else enc_ch, 32)
        for i, (cin, cout) in enumerate(_LADDER, 1):
            setattr(self, f"conv{i}a", BasicConv(cin, cout, stride=2))
        for i, (cout, cin) in reversed(list(enumerate(_LADDER, 1))):
            setattr(self, f"deconv{i}a", Conv2x(cin, cout, deconv=True))
        if second_pass:   # New10: the b-pass (its "deformable" levels are plain)
            for i, (cin, cout) in enumerate(_LADDER, 1):
                setattr(self, f"conv{i}b", Conv2x(cin, cout, mdconv=i > 2))
            for i, (cout, cin) in reversed(list(enumerate(_LADDER, 1))):
                setattr(self, f"deconv{i}b", Conv2x(cin, cout, deconv=True))
        if sem_head_full_res:
            self.deconv1_sem, self.deconv2_sem = _bare_deconv(), _bare_deconv()
        self.final_conv_sem = conv_kxk(32, sem_channels, 3, bias=True)
        self.deconv1, self.deconv2 = _bare_deconv(), _bare_deconv()
        self.final_conv_disp = conv_kxk(32, 1, 3, bias=True)

    def stem(self, left: torch.Tensor) -> torch.Tensor:
        """Raw pixels in any layout → (B, 64, H/4, W/4)."""
        x = to_nhwc(left).to(self.dtype).contiguous()
        if self.fuse_stem and not self.training:
            scale, shift = self.bn.folded()
            return fused_stem_pool(x, self.conv0.weight, scale, shift).permute(0, 3, 1, 2)
        f = self.bn(self.conv0(x.permute(0, 3, 1, 2)))
        return max_pool_3x3_s2(torch.relu(f))

    def forward(self, low_disp: torch.Tensor, left: torch.Tensor, left_sem: torch.Tensor):
        """``low_disp`` (B, h, w) or (B, C, h, w) at 1/4 resolution, ``left``
        the raw image in any layout, ``left_sem`` (B, C, h, w)."""
        hw = image_hw(left)
        if low_disp.dim() == 3:
            low_disp = low_disp[:, None]
        scale = hw[1] / low_disp.shape[-1]
        f = self.stem(left)
        sem_in, disp_in = left_sem.to(self.dtype), low_disp.to(self.dtype)
        if self.input_attention:   # New9/12: gate the raw inputs first
            sem_in = sem_in * self.sem_attention(sem_in)
            disp_in = disp_in * self.disp_attention(disp_in)
        e1, e2, e3 = self.conv1(f), self.conv2(disp_in), self.conv3(sem_in)
        x = torch.cat([e1, e2, e3], dim=1) if self.combine == "concat" else e1 + e2 + e3
        x = self.conv_start(x)
        rem = [x, None, None, None, None]
        x = u_net_pass(self, x, rem, "a")
        if self.second_pass:
            x = u_net_pass(self, x, rem, "b")
        s = self.deconv2_sem(self.deconv1_sem(x)) if self.sem_head_full_res else x
        sem = self.final_conv_sem(s).float().permute(0, 2, 3, 1)
        delta = self.final_conv_disp(self.deconv2(self.deconv1(x))).float()
        if self.raw_disp_head:
            return delta[:, 0], sem
        base = resize_bilinear(low_disp[:, :1].float().permute(0, 2, 3, 1), hw)
        return torch.relu(delta[:, 0] + base[..., 0]) * scale, sem


def _warp_error_input(d: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """(B, 6, H, W) in ``dtype``: the warp error (the right view warped by
    the (B, 1, H, W) disparity ``d``, minus the left) beside the left view,
    formed in float32 from the (B, H, W, 3) views."""
    warped, _ = disp_warp(right.float(), d[:, 0])
    error = warped - left.float()
    return torch.cat([error, left.float()], dim=-1).permute(0, 3, 1, 2).to(dtype)


class StereoDRNetRefinement(nn.Module):
    """Warp-error-driven refinement (reference ``refinement.py:62-108``;
    JAX ``StereoDRNetRefinement``): 3×3 ``conv1`` over the warp error
    beside the left view and ``conv2`` over the upsampled disparity,
    concatenated, six dilated residual blocks (``res{i}_conv`` of
    relu(x) → ``res{i}_bn``), then ``final`` gives Δ: relu(d + Δ)."""

    DILATIONS = (1, 2, 4, 8, 1, 1)

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = conv_kxk(6, 16, 3)
        self.conv2 = conv_kxk(1, 16, 3)
        for i, dil in enumerate(self.DILATIONS):
            setattr(self, f"res{i}_conv", conv_kxk(32, 32, 3, dilation=dil))
            setattr(self, f"res{i}_bn", batch_norm(32))
        self.final = conv_kxk(32, 1, 3, bias=True)

    def forward(self, disp: torch.Tensor, left: torch.Tensor,
                right: torch.Tensor) -> torch.Tensor:
        """(B, h, w) disparity and the (B, H, W, 3) views → (B, H, W)."""
        from .stereo import upsample_disp

        d = upsample_disp(disp, left.shape[1:3])
        x = torch.cat([self.conv1(_warp_error_input(d, left, right, self.dtype)),
                       self.conv2(d.to(self.dtype))], dim=1)
        for i in range(len(self.DILATIONS)):
            x = x + getattr(self, f"res{i}_bn")(getattr(self, f"res{i}_conv")(torch.relu(x)))
        delta = self.final(torch.relu(x))
        return torch.relu(d + delta.float())[:, 0]


class HourglassRefinement(nn.Module):
    """Two-pass deformable U-net over the warp error (reference
    ``refinement.py:111-204``; JAX ``HourglassRefinement``): encoders
    ``conv1`` (warp error beside the left view) and ``conv2`` (upsampled
    disparity), the deformable ``conv_start``; the a-pass down through
    ``BasicConv`` ``conv1a``, ``conv2a`` and the stride-2 deformable
    ``conv3a``, ``conv4a`` (levels of 48, 64, 96, 128 channels), the twin
    ``Conv2x`` ladders (``conv3b``/``conv4b``'s ``mdconv`` ignored, as in
    the reference), then ``final_conv`` gives Δ: relu(d + Δ). The
    deformable convs take the gather form whatever ``StereoDCSS``'s
    ``deform_impl`` is, as in JAX. H and W must be multiples of 16."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = conv_bn_lrelu(6, 16)
        self.conv2 = conv_bn_lrelu(1, 16)
        self.conv_start = DeformConv2d(32, 32)
        self.conv1a = BasicConv(32, 48, stride=2)
        self.conv2a = BasicConv(48, 64, stride=2)
        self.conv3a = DeformConv2d(64, 96, stride=2)
        self.conv4a = DeformConv2d(96, 128, stride=2)
        for suffix in ("a", "b"):
            for i, (cout, cin) in reversed(list(enumerate(_LADDER, 1))):
                setattr(self, f"deconv{i}{suffix}", Conv2x(cin, cout, deconv=True))
        for i, (cin, cout) in enumerate(_LADDER, 1):
            setattr(self, f"conv{i}b", Conv2x(cin, cout, mdconv=i > 2))
        self.final_conv = conv_kxk(32, 1, 3, bias=True)

    def forward(self, disp: torch.Tensor, left: torch.Tensor,
                right: torch.Tensor) -> torch.Tensor:
        """(B, h, w) disparity and the (B, H, W, 3) views → (B, H, W)."""
        from .stereo import upsample_disp

        d = upsample_disp(disp, left.shape[1:3])
        x = torch.cat([self.conv1(_warp_error_input(d, left, right, self.dtype)),
                       self.conv2(d.to(self.dtype))], dim=1)
        x = self.conv_start(x)
        rem = [x, None, None, None, None]
        x = u_net_pass(self, x, rem, "a")
        x = u_net_pass(self, x, rem, "b")
        return torch.relu(d + self.final_conv(x).float())[:, 0]


# reference class → SemRefine fields (refinement.py:207-1093; JAX
# REFINE_NEW_VARIANTS, whose New2/New3 attention is the channel gate)
REFINE_NEW_VARIANTS: Dict[str, Dict] = {
    "disp_sem": dict(enc_ch=16, combine="concat", sem_head_full_res=False),
    "new1": dict(enc_ch=16, combine="concat", sem_head_full_res=True),
    "new2": dict(enc_ch=16, combine="concat", sem_head_full_res=True, input_attention=True),
    "new3": dict(enc_ch=16, combine="concat", sem_head_full_res=True, input_attention=True),
    "new4": dict(enc_ch=16, combine="sum", sem_head_full_res=False),
    "new5": dict(enc_ch=48, combine="concat", sem_head_full_res=False, disp_in_channels=48,
                 raw_disp_head=True),
    "new9": dict(enc_ch=48, combine="sum", sem_head_full_res=False, input_attention=True,
                 disp_in_channels=48, raw_disp_head=True),
    "new10": dict(enc_ch=32, combine="sum", sem_head_full_res=False, second_pass=True),
    "new12": dict(enc_ch=48, combine="concat", sem_head_full_res=False, input_attention=True,
                  disp_in_channels=48, raw_disp_head=True),
}


def make_refinement(kind: str, dtype: torch.dtype = torch.float32, **kw) -> nn.Module:
    """The refinement of ``kind``: ``stereonet``, ``stereodrnet``,
    ``hourglass`` or a ``SemRefine`` variant."""
    if kind == "stereonet":
        from .stereo import StereoNetRefinement

        return StereoNetRefinement(dtype=dtype, **kw)
    if kind == "stereodrnet":
        return StereoDRNetRefinement(dtype=dtype, **kw)
    if kind == "hourglass":
        return HourglassRefinement(dtype=dtype, **kw)
    if kind in REFINE_NEW_VARIANTS:
        return SemRefine(dtype=dtype, **{**REFINE_NEW_VARIANTS[kind], **kw})
    raise NotImplementedError(f"refinement {kind}")


def make_aggregation(kind: str, max_disp: int, **kw) -> nn.Module:
    """The aggregation of ``kind``: ``adaptive`` over ``max_disp``
    disparities at the finest scale, or a 3-D one (``stereonet``,
    ``psmnet_basic``, ``psmnet_hg``, ``gcnet``), whose width follows its
    volume's channels (``in_features``), not ``max_disp``."""
    if kind == "adaptive":
        from .stereo import AdaptiveAggregation

        return AdaptiveAggregation(max_disp, **kw)
    three_d = {"stereonet": StereoNetAggregation, "psmnet_basic": PSMNetBasicAggregation,
               "psmnet_hg": PSMNetHGAggregation, "gcnet": GCNetAggregation}
    if kind in three_d:
        return three_d[kind](**kw)
    raise NotImplementedError(f"aggregation {kind}")
