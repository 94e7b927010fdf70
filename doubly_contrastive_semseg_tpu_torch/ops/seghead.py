"""Fused serving head: eval BN → ReLU → 1×1 conv → ×4 bilinear → argmax.

Port of the JAX package's ``ops/seghead_pallas.py::
fused_seghead_upsample_argmax`` (the TPU kernel ``_kernel`` with
``_phases4``). The CUDA kernel is ``csrc/seghead.cu``; its note names the
bound (bytes) and the design. A tensor on the CPU takes the plain version,
``seghead_reference``; a CUDA tensor launches the kernel or raises.

Numerics, shared by kernel and plain version: BN folds to scale/shift in
float32; the post-ReLU activations and the conv weights are rounded to the
feature dtype (bf16 on the card, as the TPU kernel does) and contracted
with float32 accumulation; upsampling and argmax run in float32.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .input_pipeline import upsample4x_argmax

_DTYPES = (torch.float32, torch.bfloat16)
MAX_CLASSES = 32


def fold_bn(bn_scale, bn_bias, bn_mean, bn_var,
            eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm as float32 (scale, shift): x̂ = x·scale + shift."""
    a = bn_scale.float() * torch.rsqrt(bn_var.float() + eps)
    return a, bn_bias.float() - bn_mean.float() * a


def seghead_reference(feat, bn_scale, bn_bias, bn_mean, bn_var, conv_weight,
                      conv_bias, eps: float = 1e-5) -> torch.Tensor:
    """Plain semantics of the kernel: (B, h, w, 128) → (B, 4h, 4w) int8."""
    a, shift = fold_bn(bn_scale, bn_bias, bn_mean, bn_var, eps)
    act = torch.relu(feat.float() * a + shift).to(feat.dtype).float()
    w = conv_weight.reshape(conv_weight.shape[0], -1).to(feat.dtype).float()
    logits = torch.einsum("bhwk,ck->bhwc", act, w) + conv_bias.float()
    return upsample4x_argmax(logits).to(torch.int8)


def fused_seghead_upsample_argmax(feat, bn_scale, bn_bias, bn_mean, bn_var,
                                  conv_weight, conv_bias,
                                  eps: float = 1e-5) -> torch.Tensor:
    """(B, h, w, 128) decoder features → (B, 4h, 4w) int8 label map, equal to
    ``argmax(resize_bilinear(BNReluConv(feat), ×4))`` with eval BN; the
    full-resolution logits are never written. ``conv_weight`` is (C, 128)
    or (C, 128, 1, 1). Counts its launches in
    ``fused_seghead_upsample_argmax.launches``."""
    if feat.dim() != 4 or feat.shape[-1] != 128:
        raise ValueError(f"seghead: feat must be (B, h, w, 128), got {tuple(feat.shape)}")
    c = conv_weight.shape[0]
    if conv_weight.numel() != c * 128 or conv_bias.shape != (c,):
        raise ValueError("seghead: conv_weight must be (C, 128[, 1, 1]), conv_bias (C,)")
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"seghead: 1 <= C <= {MAX_CLASSES} classes, got {c}")
    if feat.device.type == "cpu":
        return seghead_reference(feat, bn_scale, bn_bias, bn_mean, bn_var,
                                 conv_weight, conv_bias, eps)
    if feat.device.type != "cuda":
        raise ValueError(f"seghead: unsupported device {feat.device}")
    if feat.dtype not in _DTYPES:
        raise TypeError(f"seghead: feat must be float32 or bfloat16, got {feat.dtype}")
    if not feat.is_contiguous() or feat.data_ptr() % 16:
        raise ValueError("seghead: feat must be contiguous NHWC, 16-byte aligned")
    for t in (bn_scale, bn_bias, bn_mean, bn_var, conv_weight, conv_bias):
        if t.device != feat.device:
            raise ValueError("seghead: all tensors must be on feat's device")
    b, h, w, _ = feat.shape
    a, shift = fold_bn(bn_scale.detach(), bn_bias.detach(), bn_mean.detach(),
                       bn_var.detach(), eps)
    ab = torch.stack([a, shift]).contiguous()
    cp = (c + 3) // 4 * 4
    wt = torch.zeros((128, cp), dtype=torch.float32, device=feat.device)
    wt[:, :c] = conv_weight.detach().reshape(c, 128).to(feat.dtype).float().t()
    bias = conv_bias.detach().float().contiguous()
    out = torch.empty((b, 4 * h, 4 * w), dtype=torch.int8, device=feat.device)
    lib = _lib()
    with torch.cuda.device(feat.device):
        status = lib.dcss_seghead(
            feat.data_ptr(), wt.data_ptr(), ab.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, h, w, c, int(feat.dtype == torch.bfloat16),
            torch.cuda.current_stream(feat.device).cuda_stream)
    _build.check(lib, status, "fused_seghead_upsample_argmax")
    fused_seghead_upsample_argmax.launches += 1
    return out


fused_seghead_upsample_argmax.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("seghead")
    fn = lib.dcss_seghead
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
