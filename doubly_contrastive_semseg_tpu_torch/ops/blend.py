"""Fused SwiftNet decoder step: conv3×3(ReLU(BN_eval(up2_bilinear(x) + skip))).

Port of the JAX package's ``ops/blend_pallas.py::fused_upsample_blend`` (the
TPU kernel ``_kernel``), one ``UpsampleBlend`` step of the decoder in eval
mode. The CUDA kernel is ``csrc/blend.cu``; its note names the bound
(operations) and the design. A tensor on the CPU takes the plain version,
``upsample_blend_reference``; a CUDA tensor launches the kernel or raises.
Tensors are NHWC, the channels_last view the model holds.

Numerics, shared by kernel and plain version:

- x and skip are rounded to bf16, as the TPU kernel copies them;
- the ×2 bilinear (half-pixel centres, edge clamp: torch's
  ``align_corners=False``) runs in bf16 as the Pallas body runs it: over
  rows, then over columns, each output a ¼/¾ blend of its two neighbours,
  rounded to bf16 after each multiply and each add; the skip is added and
  the sum, the pre-activation, rounded to bf16. (Rounding once, from a
  float32 bilinear, was the other choice; it moved a few elements past the
  2e-2 bar that the JAX package's tests hold this kernel to, measured
  against the Pallas kernel in interpret mode, while the per-op rounding
  equals the JAX tests' own dtype-matched reference);
- BN folds to a float32 scale/shift (``fold_bn``), applied as a float32
  multiply then add; the activation after the ReLU is rounded to bf16;
- the 3×3 conv (zero padding) contracts the bf16 activation with the conv
  weight rounded to bf16, accumulating in float32; the output is cast to
  ``out_dtype``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .seghead import fold_bn

_IN_DTYPES = (torch.float32, torch.bfloat16)
_OUT_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535


def blend_kernel_supported(out_h: int, w: int, c: int) -> bool:
    """The shapes the kernel takes (the TPU kernel's): output rows and
    columns multiples of 8, channels a multiple of 128."""
    return out_h % 8 == 0 and c % 128 == 0 and w % 8 == 0


def _up2_bf16(x: torch.Tensor) -> torch.Tensor:
    """×2 bilinear of a bf16 NHWC tensor, rows then columns: even outputs
    ¼·prev + ¾·centre, odd ¾·centre + ¼·next, edges repeated; torch rounds
    each bf16 multiply and add to bf16."""
    for dim in (1, 2):
        n = x.shape[dim]
        prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
        nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
        x = torch.stack([0.25 * prev + 0.75 * x, 0.75 * x + 0.25 * nxt],
                        dim + 1).flatten(dim, dim + 1)
    return x


def upsample_blend_reference(x, skip, conv_weight, bn_scale, bn_bias, bn_mean,
                             bn_var, eps: float = 1e-5,
                             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain semantics of the kernel: x (B, H/2, W/2, C), skip (B, H, W, C),
    ``conv_weight`` (C, C, 3, 3) → (B, H, W, C) in ``out_dtype``."""
    pre = _up2_bf16(x.to(torch.bfloat16)) + skip.to(torch.bfloat16)
    a, shift = fold_bn(bn_scale, bn_bias, bn_mean, bn_var, eps)
    act = torch.relu(pre.float() * a + shift).to(torch.bfloat16).float()
    y = F.conv2d(act.permute(0, 3, 1, 2), conv_weight.to(torch.bfloat16).float(),
                 padding=1)
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def _check_shapes(x, skip, conv_weight, bn) -> None:
    if x.dim() != 4 or skip.dim() != 4:
        raise ValueError("upsample_blend: x and skip must be NHWC, got "
                         f"{tuple(x.shape)} and {tuple(skip.shape)}")
    b, hh, ww, c = skip.shape
    if not blend_kernel_supported(hh, ww, c):
        raise ValueError(f"upsample_blend: skip {tuple(skip.shape)} needs H % 8 == 0, "
                         "W % 8 == 0 and C % 128 == 0")
    if tuple(x.shape) != (b, hh // 2, ww // 2, c) or b < 1:
        raise ValueError(f"upsample_blend: x must be (B, H/2, W/2, C) = "
                         f"{(b, hh // 2, ww // 2, c)}, got {tuple(x.shape)}")
    if tuple(conv_weight.shape) != (c, c, 3, 3):
        raise ValueError(f"upsample_blend: conv_weight must be {(c, c, 3, 3)}, "
                         f"got {tuple(conv_weight.shape)}")
    if any(tuple(t.shape) != (c,) for t in bn):
        raise ValueError(f"upsample_blend: BN tensors must be ({c},)")


def fused_upsample_blend(x, skip, conv_weight, bn_scale, bn_bias, bn_mean,
                         bn_var, eps: float = 1e-5,
                         out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``conv3×3(ReLU(BN_eval(up2_bilinear(x) + skip)))`` without writing
    the upsampled tensor or the activation. x: (B, H/2, W/2, C) and skip:
    (B, H, W, C), contiguous NHWC, float32 or bf16 (rounded to bf16);
    ``conv_weight``: (C, C, 3, 3), torch's layout; BN tensors (C,); H and W
    multiples of 8, C of 128 (``blend_kernel_supported``). Returns (B, H, W,
    C) contiguous NHWC in ``out_dtype``. No gradient flows through the
    kernel (eval only). Counts its launches in
    ``fused_upsample_blend.launches``."""
    bn = (bn_scale, bn_bias, bn_mean, bn_var)
    _check_shapes(x, skip, conv_weight, bn)
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"upsample_blend: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if x.device.type == "cpu":
        return upsample_blend_reference(x, skip, conv_weight, *bn, eps=eps,
                                        out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"upsample_blend: unsupported device {x.device}")
    for t in (skip, conv_weight, *bn):
        if t.device != x.device:
            raise ValueError("upsample_blend: all tensors must be on x's device")
    for name, t in (("x", x), ("skip", skip)):
        if t.dtype not in _IN_DTYPES:
            raise TypeError(f"upsample_blend: {name} must be float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"upsample_blend: {name} must be contiguous NHWC, 16-byte aligned")
    b, hh, ww, c = skip.shape
    if hh // 8 > _MAX_GRID_YZ or b * (c // 128) > _MAX_GRID_YZ:
        raise ValueError(f"upsample_blend: skip {tuple(skip.shape)} exceeds the launch grid")
    xb = x.to(torch.bfloat16)
    sb = skip.to(torch.bfloat16)
    # (C_out, C_in, 3, 3) → (9, C_in, C_out): tap-major, as the TPU kernel's w9
    w9 = conv_weight.detach().permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()
    a, shift = fold_bn(*(t.detach() for t in bn), eps)
    ab = torch.stack([a, shift]).contiguous()
    out = torch.empty((b, hh, ww, c), dtype=out_dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        status = lib.dcss_upsample_blend(
            xb.data_ptr(), sb.data_ptr(), w9.data_ptr(), ab.data_ptr(), out.data_ptr(),
            b, hh, ww, c, int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, status, "fused_upsample_blend")
    fused_upsample_blend.launches += 1
    return out


fused_upsample_blend.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("blend")
    fn = lib.dcss_upsample_blend
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
