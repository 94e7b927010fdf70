"""Fused ResNet stem: 7×7/s2 conv → folded BN → ReLU → 3×3/s2 max-pool.

Port of the JAX package's ``ops/stem_pallas.py::fused_stem_pool`` (the TPU
kernel ``_stem_kernel``). The CUDA kernel is ``csrc/stem_pool.cu``; its note
names the bound (operations) and the design. A tensor on the CPU takes the
plain version, ``stem_pool_reference``; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)


def stem_output_hw(h: int, w: int):
    """Pooled size: conv(7, s2, p3) then maxpool(3, s2, p1), as torch."""
    hc, wc = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return (hc - 1) // 2 + 1, (wc - 1) // 2 + 1


def stem_pool_reference(x: torch.Tensor, weight: torch.Tensor,
                        scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Plain semantics of the kernel. x: (B, H, W, 3); weight: (64, 3, 7, 7);
    scale, shift: (64,) folded BN. Returns (B, Hp, Wp, 64) in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), stride=2, padding=3)
    y = torch.relu(y * scale.to(y.dtype)[:, None, None]
                   + shift.to(y.dtype)[:, None, None])
    return F.max_pool2d(y, 3, stride=2, padding=1).permute(0, 2, 3, 1)


def fused_stem_pool(x: torch.Tensor, weight: torch.Tensor,
                    scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) contiguous NHWC level → (B, Hp, Wp, 64) contiguous NHWC,
    the pre-pool activation never written. Counts its launches in
    ``fused_stem_pool.launches``."""
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"fused_stem_pool: x must be (B, H, W, 3), got {tuple(x.shape)}")
    if tuple(weight.shape) != (64, 3, 7, 7):
        raise ValueError(f"fused_stem_pool: weight must be (64, 3, 7, 7), got {tuple(weight.shape)}")
    if scale.shape != (64,) or shift.shape != (64,):
        raise ValueError("fused_stem_pool: scale and shift must be (64,)")
    if x.device.type == "cpu":
        return stem_pool_reference(x, weight, scale, shift)
    if x.device.type != "cuda":
        raise ValueError(f"fused_stem_pool: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_stem_pool: x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_stem_pool: x must be contiguous NHWC")
    for t in (weight, scale, shift):
        if t.device != x.device:
            raise ValueError("fused_stem_pool: all tensors must be on x's device")
    b, h, w, _ = x.shape
    hp, wp = stem_output_hw(h, w)
    # (ky, kx, ci, co): a thread's output channels are contiguous
    w_k = weight.detach().permute(2, 3, 1, 0).contiguous().to(x.dtype)
    sc = scale.detach().float().contiguous()
    sh = shift.detach().float().contiguous()
    out = torch.empty((b, hp, wp, 64), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        status = lib.dcss_stem_pool(
            x.data_ptr(), w_k.data_ptr(), sc.data_ptr(), sh.data_ptr(), out.data_ptr(),
            b, h, w, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, status, "fused_stem_pool")
    fused_stem_pool.launches += 1
    return out


fused_stem_pool.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("stem_pool")
    fn = lib.dcss_stem_pool
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
