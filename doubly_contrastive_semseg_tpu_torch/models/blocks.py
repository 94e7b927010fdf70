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
from ..ops.interpolate import resize_bilinear
from ..ops.seghead import fold_bn

# torch BatchNorm momentum of the reference (network/utils.py:36)
TORCH_BN_MOMENTUM = 0.1


class TorchBatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1). In eval it applies the
    folded float32 scale/shift in the activation dtype; in training it is
    ``nn.BatchNorm2d`` itself."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=TORCH_BN_MOMENTUM)

    def folded(self):
        """(scale, shift), float32: eval BN is x·scale + shift."""
        return fold_bn(self.weight, self.bias, self.running_mean,
                       self.running_var, self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        scale, shift = self.folded()
        return torch.addcmul(shift.to(x.dtype)[:, None, None], x,
                             scale.to(x.dtype)[:, None, None])


def batch_norm(features: int) -> TorchBatchNorm:
    return TorchBatchNorm(features)


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
        u = torch.rand(shape, generator=self.generator, device=x.device)
        return (u >= self.p).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        return torch.where(self.keep_mask(x), x / (1.0 - self.p), 0.0)


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
    bias=True``. Modules ``norm`` and ``conv`` carry the reference names."""

    def __init__(self, in_features: int, features: int, k: int = 3,
                 bias: bool = False):
        super().__init__()
        self.norm = batch_norm(in_features)
        self.conv = conv_kxk(in_features, features, k=k, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.relu(self.norm(x)))


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


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Initialises parameters as the JAX package does, from ``generator``:
    convs truncated-normal fan-out with gain 2 (flax ``variance_scaling(2,
    "fan_out", "truncated_normal")``), dense layers lecun-normal with zero
    bias, BN scale 1 and bias 0, running mean 0 and var 1."""
    # std of a unit normal truncated to ±2, which variance_scaling divides out
    trunc_std = 0.87962566103423978
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
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
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
