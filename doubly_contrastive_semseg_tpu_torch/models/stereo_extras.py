"""The stereo refinement heads — the port's copy of the JAX package's
``models/stereo_extras.py``: GANet's ``BasicConv`` and ``Conv2x``
(``:309-367``, also the hourglass SwiftNet's disparity branch), the
``conv2d`` encoder helper, ``SemRefine`` with the nine published variants
of ``REFINE_NEW_VARIANTS`` (``:499-664``), and the factories
``make_refinement`` and ``make_aggregation``. The 3-D aggregations,
``StereoDRNetRefinement`` and ``HourglassRefinement`` are ``ROADMAP.md`` §1
item 5b: the factories raise for them.

Module names are the reference's, as the JAX package's
``convert_reference_refinement`` reads them: ``conv`` and ``bn`` in a
``BasicConv``, ``conv1`` and ``conv2`` in a ``Conv2x``; in ``SemRefine``
the stem ``conv0`` and ``bn``, the encoders ``conv{1,2,3}.{0,1}``, the
gates ``{sem,disp}_attention.1``, the ladder ``conv_start``,
``conv{1..4}{a,b}``, ``deconv{1..4}{a,b}``, the bare transposed convs
``deconv1``, ``deconv2``, ``deconv1_sem``, ``deconv2_sem``, and the heads
``final_conv_disp``, ``final_conv_sem``. A transposed conv is torch's
``ConvTranspose2d(k=4, s=2, p=1)``: JAX's SAME ``ConvTranspose`` with its
kernel flipped, which ``utils/convert.py`` undoes.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ..ops.input_pipeline import image_hw, to_nhwc
from ..ops.interpolate import resize_bilinear
from ..ops.stem import fused_stem_pool
from .blocks import Conv2d, ConvTranspose2d, batch_norm, conv_kxk, max_pool_3x3_s2


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

    def _ladder(self, x: torch.Tensor, rem, suffix: str, first: str) -> torch.Tensor:
        """One U-net pass: down through ``{first}{1..4}{suffix}`` (a
        ``BasicConv`` in the a-pass, a ``Conv2x`` fed the skip in the
        b-pass), up through ``deconv{4..1}{suffix}``; ``rem`` holds the
        skips of levels 0–4, each replaced by the step that last reached
        its level."""
        for i in range(1, 5):
            step = getattr(self, f"{first}{i}{suffix}")
            x = step(x) if suffix == "a" else step(x, rem[i])
            rem[i] = x
        for i in range(4, 0, -1):
            x = getattr(self, f"deconv{i}{suffix}")(x, rem[i - 1])
            rem[i - 1] = x
        return x

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
        x = self._ladder(x, rem, "a", "conv")
        if self.second_pass:
            x = self._ladder(x, rem, "b", "conv")
        s = self.deconv2_sem(self.deconv1_sem(x)) if self.sem_head_full_res else x
        sem = self.final_conv_sem(s).float().permute(0, 2, 3, 1)
        delta = self.final_conv_disp(self.deconv2(self.deconv1(x))).float()
        if self.raw_disp_head:
            return delta[:, 0], sem
        base = resize_bilinear(low_disp[:, :1].float().permute(0, 2, 3, 1), hw)
        return torch.relu(delta[:, 0] + base[..., 0]) * scale, sem


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


# the kinds ROADMAP.md §1 item 5b has still to port
UNPORTED_REFINEMENTS = ("stereodrnet", "hourglass")
UNPORTED_AGGREGATIONS = ("stereonet", "psmnet_basic", "psmnet_hg", "gcnet")


def _not_ported(what: str, kind: str) -> NotImplementedError:
    if kind in UNPORTED_REFINEMENTS + UNPORTED_AGGREGATIONS:
        return NotImplementedError(f"{what} {kind!r} is not ported yet (ROADMAP.md §1 item 5b)")
    return NotImplementedError(f"{what} {kind}")


def make_refinement(kind: str, dtype: torch.dtype = torch.float32, **kw) -> nn.Module:
    """The refinement of ``kind``: ``stereonet``, or a ``SemRefine``
    variant; ``stereodrnet`` and ``hourglass`` raise (item 5b)."""
    if kind == "stereonet":
        from .stereo import StereoNetRefinement

        return StereoNetRefinement(dtype=dtype, **kw)
    if kind in REFINE_NEW_VARIANTS:
        return SemRefine(dtype=dtype, **{**REFINE_NEW_VARIANTS[kind], **kw})
    raise _not_ported("refinement", kind)


def make_aggregation(kind: str, max_disp: int, **kw) -> nn.Module:
    """The aggregation of ``kind``: ``adaptive`` over ``max_disp``
    disparities at the finest scale; the 3-D ones (``stereonet``,
    ``psmnet_basic``, ``psmnet_hg``, ``gcnet``) raise (item 5b)."""
    if kind == "adaptive":
        from .stereo import AdaptiveAggregation

        return AdaptiveAggregation(max_disp, **kw)
    raise _not_ported("aggregation", kind)
