"""Shared model blocks: port of the JAX package's ``models/blocks.py``.

Tensors inside the model are NCHW-shaped in ``torch.channels_last`` memory,
so their NHWC views (the public layout, as in the JAX package) cost no copy.

Dtypes: parameters stay float32. Activations run in the dtype the pyramid
hands the trunk (``compute_dtype``: bf16 on the card). Each conv casts its
weight to the activation dtype at the call; each eval BatchNorm folds its
running statistics into a float32 scale/shift, cast to the activation dtype
for the multiply-add. In training, BatchNorm is ``nn.BatchNorm2d``: it
normalises with the biased batch variance and folds the unbiased one into
the running variance, as the reference's torch BN does (the JAX package's
``TorchBatchNorm`` reproduces that by hand).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.blend import blend_kernel_supported, fused_upsample_blend
from ..ops.interpolate import adaptive_avg_pool, resize_bilinear, resize_bilinear_cols
from ..ops.seghead import fold_bn
from ..parallel import active as parallel_active
from ..parallel import data_rows, rand_rows, sync_batch_norm
from ..parallel.spatial import conv_reads, windowed

# torch BatchNorm momentum of the reference (network/utils.py:36)
TORCH_BN_MOMENTUM = 0.1


class TorchBatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1 unless given: JAX
    ``batch_norm``'s ``momentum`` and ``epsilon``, ``blocks.py:117-131``). In
    eval it applies the folded float32 scale/shift in the activation dtype;
    in training it is ``nn.BatchNorm2d`` itself, or, with several ranks,
    ``parallel.sync_batch_norm`` over the global batch."""

    def __init__(self, features: int, momentum: float = TORCH_BN_MOMENTUM,
                 eps: float = 1e-5):
        super().__init__(features, eps=eps, momentum=momentum)

    def folded(self):
        """(scale, shift), float32: eval BN is x·scale + shift."""
        return fold_bn(self.weight, self.bias, self.running_mean,
                       self.running_var, self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return sync_batch_norm(self, x) if parallel_active() else super().forward(x)
        scale, shift = self.folded()
        return torch.addcmul(shift.to(x.dtype)[:, None, None], x,
                             scale.to(x.dtype)[:, None, None])


def batch_norm(features: int, momentum: float = TORCH_BN_MOMENTUM,
               eps: float = 1e-5) -> TorchBatchNorm:
    return TorchBatchNorm(features, momentum, eps)


class TorchBatchNorm3d(nn.BatchNorm3d):
    """``TorchBatchNorm`` over (B, C, D, H, W) volumes."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=TORCH_BN_MOMENTUM)

    folded = TorchBatchNorm.folded

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return sync_batch_norm(self, x) if parallel_active() else super().forward(x)
        scale, shift = self.folded()
        return torch.addcmul(shift.to(x.dtype)[:, None, None, None], x,
                             scale.to(x.dtype)[:, None, None, None])


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose float32 parameters are cast to the input's dtype
    at the call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` whose float32 parameters are cast to the
    input's dtype at the call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` whose float32 parameters are cast to the input's dtype
    at the call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose3d(nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` whose float32 parameters are cast to the
    input's dtype at the call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose3d(x, self.weight.to(x.dtype), bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


def to_channels_last(module: nn.Module) -> nn.Module:
    """``module`` with its 4-D parameters in ``channels_last`` memory and
    its 5-D ones (3-D convs' weights) in ``channels_last_3d``, in place:
    ``module.to(memory_format=torch.channels_last)`` refuses a 5-D
    tensor."""
    formats = {4: torch.channels_last, 5: torch.channels_last_3d}
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() in formats:
                p.data = p.data.contiguous(memory_format=formats[p.dim()])
    return module


def conv_window(conv: nn.Conv2d, x: torch.Tensor, lo: int, hi: int, a: int,
                b: int) -> torch.Tensor:
    """Output columns [a, b) of ``conv`` (dilation 1) on the whole map, from
    ``x`` (B, C, H, w), the map's input columns [lo, hi) (``spatial.
    conv_reads``): zero columns pad the window only past the map's edges."""
    k, s, p = conv.kernel_size[1], conv.stride[1], conv.padding[1]
    x = F.pad(x, (lo - (s * a - p), s * (b - 1) - p + k - hi))
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x.contiguous(memory_format=torch.channels_last), conv.weight.to(x.dtype),
                    bias, conv.stride, (conv.padding[0], 0), 1, conv.groups)


def conv_cols(conv: nn.Conv2d, x: torch.Tensor, width: int):
    """``conv`` on a width-split map: from this rank's columns ``x`` (B, C,
    H, w) of a map ``width`` wide, (this rank's output columns, the output
    width), as ``parallel/spatial.py`` says."""
    if tuple(conv.dilation) != (1, 1):
        raise NotImplementedError("conv_cols: a dilated conv has no width-split route")
    k, s, p = conv.kernel_size[1], conv.stride[1], conv.padding[1]
    w_out = (width + 2 * p - k) // s + 1
    y = windowed(x, width, w_out, conv_reads(k, s, p, width),
                 lambda xw, lo, hi, a, b: conv_window(conv, xw, lo, hi, a, b), dim=3)
    if y is None:
        h_out = (x.shape[2] + 2 * conv.padding[0] - conv.kernel_size[0]) // conv.stride[0] + 1
        y = x.new_zeros((x.shape[0], conv.out_channels, h_out, 0))
    return y, w_out


def conv_kxk(in_features: int, features: int, k: int = 3, stride: int = 1,
             bias: bool = False, dilation: int = 1) -> Conv2d:
    """k×k conv with torch ``padding=dilation·(k//2)``."""
    return Conv2d(in_features, features, k, stride=stride, padding=dilation * (k // 2),
                  dilation=dilation, bias=bias)


class SeparableConv(nn.Module):
    """Depthwise k×k → pointwise 1×1 (JAX ``models/blocks.py:163``), under
    the reference's names for the DeepLab heads' separable convs
    (``AtrousSeparableConvolution``, ``network/_deeplab.py:92-116``):
    ``body.0`` the depthwise conv, ``body.1`` the pointwise."""

    def __init__(self, in_features: int, features: int, k: int = 3, stride: int = 1,
                 dilation: int = 1, bias: bool = False):
        super().__init__()
        self.body = nn.Sequential(
            Conv2d(in_features, in_features, k, stride=stride, padding=dilation * (k // 2),
                   dilation=dilation, groups=in_features, bias=bias),
            Conv2d(in_features, features, 1, bias=bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class Dropout(nn.Module):
    """Dropout at rate ``p`` in training, as flax's ``nn.Dropout``: an
    element is kept with probability 1 − p and scaled by 1/(1 − p). The
    keep mask is drawn in NHWC order from ``generator``, which the train
    step sets (``set_dropout_generator``) where JAX passes its dropout key;
    ``spatial`` draws one a (sample, channel), JAX's ``broadcast_dims=(1,
    2)`` (torch ``Dropout2d``)."""

    def __init__(self, p: float, spatial: bool = False):
        super().__init__()
        self.p, self.spatial = p, spatial
        self.generator = None

    def keep_mask(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W)-broadcastable bool mask, drawn as (B, H, W, C) or
        (B, 1, 1, C) uniforms ≥ p."""
        b, c, h, w = x.shape
        shape = (b, 1, 1, c) if self.spatial else (b, h, w, c)
        u = rand_rows(shape, self.generator, x.device, blocks=self.blocks(b))
        return (u >= self.p).permute(0, 3, 1, 2)

    @staticmethod
    def blocks(b: int) -> int:
        """The blocks of the batch's samples in ``b`` rows (two views: 2)
        with several ranks, whose masks are the global batch's rows."""
        return b // data_rows() if parallel_active() else 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        return torch.where(self.keep_mask(x), x / (1.0 - self.p), 0.0)


class DropConnect(Dropout):
    """Per-sample dropout at rate ``p`` (EfficientNet's drop-connect, JAX
    ``efficientnet_pyramid.py:102-108``): one keep draw a sample, a (B, 1,
    1, 1) mask; the kept samples are scaled by 1/(1 − p)."""

    def keep_mask(self, x: torch.Tensor) -> torch.Tensor:
        u = rand_rows((x.shape[0], 1, 1, 1), self.generator, x.device,
                      blocks=self.blocks(x.shape[0]))
        return u >= self.p


def set_dropout_generator(model: nn.Module, generator) -> None:
    """Every ``Dropout`` of ``model`` draws its masks from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch ``MaxPool2d(kernel=3, stride=2, padding=1)``."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


class BNReluConv(nn.Module):
    """BN → ReLU → conv, SwiftNet's pre-activation unit (reference
    ``network/utils.py:35-49``); the segmentation head with ``k=1,
    bias=True``. Modules ``norm`` and ``conv`` carry the reference names;
    ``bn_momentum`` is the BN's (JAX ``BNReluConv.bn_momentum``)."""

    def __init__(self, in_features: int, features: int, k: int = 3,
                 bias: bool = False, bn_momentum: float = TORCH_BN_MOMENTUM):
        super().__init__()
        self.norm = batch_norm(in_features, bn_momentum)
        self.conv = conv_kxk(in_features, features, k=k, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.relu(self.norm(x)))

    def forward_cols(self, x: torch.Tensor, width: int):
        """The unit on a width-split map (``conv_cols``): (this rank's
        output columns, the output width)."""
        return conv_cols(self.conv, torch.relu(self.norm(x)), width)

    def nhwc_logits(self, x: torch.Tensor) -> torch.Tensor:
        """The head's output as (B, h, w, features) float32: the seg
        logits of (B, C, h, w) features, as the models return them."""
        return self(x).permute(0, 2, 3, 1).float()


class PreActConv(BNReluConv):
    """The decoder's 3×3 BN → ReLU → conv (same names as ``BNReluConv``)."""

    def __init__(self, features: int, k: int = 3):
        super().__init__(features, features, k=k)


class UpsampleBlend(nn.Module):
    """Bilinear-upsample to the skip's size, add the skip, 3×3 pre-activation
    conv (reference ``_UpsampleBlend``, ``network/utils.py:79-102``; the JAX
    package's k=3, use_bn form).

    ``fuse_inference`` (off by default, as in the JAX package) runs the
    whole step as one fused op, ``ops/blend.py::fused_upsample_blend``,
    under the JAX guard: eval mode, x exactly half the skip's size, at least
    64 output rows, and ``blend_kernel_supported``. The tensor's device picks
    the route, as for the stem and the head: a CUDA tensor launches the
    kernel (``csrc/blend_mma.cu``), a CPU tensor takes its plain version (the
    JAX package instead keeps the unfused XLA step on the CPU backend).
    Otherwise the step runs unfused. Callers set the attribute on the
    modules; there is no config flag."""

    def __init__(self, features: int = 128, fuse_inference: bool = False):
        super().__init__()
        self.fuse_inference = fuse_inference
        self.blend_conv = PreActConv(features, k=3)

    def _fusable(self, x: torch.Tensor, skip: torch.Tensor) -> bool:
        hh, ww = skip.shape[-2:]
        return (self.fuse_inference and not self.training
                and x.shape[-2] * 2 == hh and x.shape[-1] * 2 == ww and hh >= 64
                and blend_kernel_supported(hh, ww, skip.shape[1]))

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        if self._fusable(x, skip):
            norm, conv = self.blend_conv.norm, self.blend_conv.conv
            out = fused_upsample_blend(
                x.permute(0, 2, 3, 1).contiguous(), skip.permute(0, 2, 3, 1).contiguous(),
                conv.weight, norm.weight, norm.bias, norm.running_mean,
                norm.running_var, eps=norm.eps, out_dtype=x.dtype)
            return out.permute(0, 3, 1, 2)
        hh, ww = skip.shape[-2:]
        x = resize_bilinear(x.permute(0, 2, 3, 1), (hh, ww)).permute(0, 3, 1, 2)
        return self.blend_conv(x + skip)


    def forward_cols(self, x: torch.Tensor, x_width: int, skip: torch.Tensor,
                     width: int) -> torch.Tensor:
        """The step on width-split maps: this rank's columns of ``x``, a map
        ``x_width`` wide, resized to the skip's global size
        (``resize_bilinear_cols``), added to this rank's columns of the
        skip, a map ``width`` wide, and blended with a 1-column halo. The
        fused route has no width-split form: the caller refuses
        ``fuse_inference`` (``PyramidResNet.check_split``)."""
        up = resize_bilinear_cols(x.permute(0, 2, 3, 1), x_width, (skip.shape[2], width))
        return self.blend_conv.forward_cols(up.permute(0, 3, 1, 2) + skip, width)[0]


class Upsample(nn.Module):
    """The single-scale SwiftNets' decoder step (reference ``_Upsample``,
    ``network/utils.py:52-77``; JAX ``blocks.py:352-372``): a 1×1
    pre-activation ``bottleneck`` of the skip to ``num_maps_in`` channels,
    the input bilinear-resized to the skip's size and added, then the 3×3
    pre-activation ``blend_conv``."""

    def __init__(self, skip_in: int, num_maps_in: int = 128, features: int = 128):
        super().__init__()
        self.bottleneck = BNReluConv(skip_in, num_maps_in, k=1)
        self.blend_conv = BNReluConv(num_maps_in, features, k=3)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        skip = self.bottleneck(skip)
        x = resize_bilinear(x.permute(0, 2, 3, 1), tuple(skip.shape[-2:])).permute(0, 3, 1, 2)
        return self.blend_conv(x + skip)


class SpatialPyramidPooling(nn.Module):
    """SwiftNet's SPP with aspect-aware grids (reference ``network/
    utils.py:105-156``; JAX ``blocks.py:375-413``): a 1×1 ``spp_bn`` to
    ``bt_size``, then ``num_levels`` levels each average-pooled to ``(g,
    max(1, round(g·W/H)))``, a 1×1 pre-activation conv to ``level_size`` and
    resized back, all concatenated and fused by a 1×1 ``spp_fuse``. The
    convs sit in the Sequential ``spp``, the reference's
    ``spp.{spp_bn, spp0, ..., spp_fuse}``."""

    def __init__(self, in_features: int, num_levels: int = 3, bt_size: int = 512,
                 level_size: int = 128, out_size: int = 128, grids=(6, 3, 2, 1),
                 bn_momentum: float = TORCH_BN_MOMENTUM):
        super().__init__()
        self.grids = tuple(grids[:num_levels])
        self.spp = nn.Sequential()
        self.spp.add_module("spp_bn", BNReluConv(in_features, bt_size, k=1,
                                                 bn_momentum=bn_momentum))
        for i in range(num_levels):
            self.spp.add_module(f"spp{i}", BNReluConv(bt_size, level_size, k=1,
                                                      bn_momentum=bn_momentum))
        self.spp.add_module("spp_fuse", BNReluConv(bt_size + num_levels * level_size,
                                                   out_size, k=1, bn_momentum=bn_momentum))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = tuple(x.shape[-2:])
        ar = hw[1] / hw[0]
        x = self.spp.spp_bn(x)
        levels = [x]
        for i, g in enumerate(self.grids):
            pooled = adaptive_avg_pool(x.permute(0, 2, 3, 1), (g, max(1, round(ar * g))))
            lvl = getattr(self.spp, f"spp{i}")(pooled.permute(0, 3, 1, 2))
            levels.append(resize_bilinear(lvl.permute(0, 2, 3, 1), hw).permute(0, 3, 1, 2))
        return self.spp.spp_fuse(torch.cat(levels, dim=1))


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Initialises parameters as the JAX package does, from ``generator``:
    convs (2-D and 3-D) truncated-normal fan-out with gain 2 (flax ``variance_scaling(2,
    "fan_out", "truncated_normal")``), dense layers lecun-normal with zero
    bias, BN scale 1 and bias 0, running mean 0 and var 1."""
    # std of a unit normal truncated to ±2, which variance_scaling divides out
    trunc_std = 0.87962566103423978
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Conv3d, nn.ConvTranspose3d)):
            fan_out = m.out_channels * math.prod(m.kernel_size)
            std = math.sqrt(2.0 / fan_out) / trunc_std
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / trunc_std
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            m.reset_parameters()
