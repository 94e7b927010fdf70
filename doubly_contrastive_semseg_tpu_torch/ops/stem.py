"""Fused ResNet stem: 7×7/s2 conv → folded BN → ReLU → 3×3/s2 max-pool.

Port of the JAX package's ``ops/stem_pallas.py::fused_stem_pool`` (the TPU
kernel ``_stem_kernel``). Two CUDA kernels, chosen by dtype:

- bf16: ``csrc/stem_pool_tc.cu``, an implicit GEMM on tensor cores (bf16
  products, f32 sums: the TPU kernel's numerics). Its weights are packed by
  ``pack_stem_weight``; ``stem_im2col`` is the plain form of the columns it
  gathers.
- f32: ``csrc/stem_pool.cu`` on CUDA cores, in f32 throughout: bf16 products
  cannot hold an f32 input to its 1e-4 gate.

Each source's note names its bound and design. A tensor on the CPU takes the
plain version, ``stem_pool_reference``; a CUDA tensor launches its dtype's
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..parallel.spatial import windowed
from . import _build

_DTYPES = (torch.float32, torch.bfloat16)
# K order of the tensor-core kernel: k = ky * 22 + 1 + 3 * kx + ci, i.e. each
# kernel row's 21 taps after one zero tap (so that a pair of taps never spans
# two kernel rows and starts at an even element of the image), 154 taps
# zero-padded to 160 (10 k-steps of 16)
TAPS_PER_ROW = 22
STEM_K = 160


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


def pack_stem_weight(weight: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(64, 3, 7, 7) → (160, 64), the tensor-core kernel's B operand: row
    ky * 22 + 1 + 3 * kx + ci holds ``weight[:, ci, ky, kx]``; rows ky * 22
    and 154..159 are zero."""
    packed = torch.zeros(STEM_K, 64, dtype=dtype, device=weight.device)
    rows = packed[:7 * TAPS_PER_ROW].view(7, TAPS_PER_ROW, 64)
    rows[:, 1:] = weight.detach().permute(2, 3, 1, 0).reshape(7, 21, 64).to(dtype)
    return packed


def stem_weight_fragments(packed: torch.Tensor) -> torch.Tensor:
    """(160, 64) ``pack_stem_weight`` → the same values in the order of the
    kernel's mma B fragments: for k-step s, n-tile pair np and lane
    4 g + t, 8 values [h][j][e] = packed[16 s + 8 j + 2 t + e, 16 np + 8 h + g]
    (the m16n8k16 B fragments of n tiles 2 np and 2 np + 1)."""
    return packed.view(10, 2, 4, 2, 4, 2, 8).permute(0, 4, 6, 2, 5, 1, 3).contiguous()


def stem_im2col(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) → (B, Hc, Wc, 160): the input taps of every conv output
    in ``pack_stem_weight``'s row order, with the conv's zero padding; the
    columns of zero weight rows are 0. ``stem_im2col(x) @ pack_stem_weight(w)``
    is the stem conv."""
    b, h, w, _ = x.shape
    hc, wc = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = F.pad(x, (0, 0, 3, 3, 3, 3))
    zero_tap = x.new_zeros(b, hc, wc, 1)
    cols = []
    for ky in range(7):
        cols.append(zero_tap)
        cols += [xp[:, ky:ky + 2 * hc - 1:2, kx:kx + 2 * wc - 1:2] for kx in range(7)]
    cols.append(x.new_zeros(b, hc, wc, STEM_K - 7 * TAPS_PER_ROW))
    return torch.cat(cols, dim=-1)


def fused_stem_pool(x: torch.Tensor, weight: torch.Tensor,
                    scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) contiguous NHWC level → (B, Hp, Wp, 64) contiguous NHWC,
    the pre-pool activation never written. A bf16 CUDA tensor takes the
    tensor-core kernel, an f32 one the CUDA-core kernel. Counts every launch
    in ``fused_stem_pool.launches`` and each route's in ``.tc_launches``
    (bf16) and ``.cc_launches`` (f32)."""
    _check_shapes(x, weight, scale, shift)
    if x.device.type == "cpu":
        return stem_pool_reference(x, weight, scale, shift)
    if x.dtype == torch.bfloat16:
        return stem_pool_tensor_cores(x, weight, scale, shift)
    return stem_pool_cuda_cores(x, weight, scale, shift)


fused_stem_pool.launches = 0
fused_stem_pool.tc_launches = 0
fused_stem_pool.cc_launches = 0


def stem_reads(width: int):
    """(a, b) → [lo, hi): the input window of pooled columns [a, b) of a
    width-``width`` level through K2 unchanged. Pooled column q reads input
    columns 4q − 5 … 4q + 5 (conv 7×7/s2/p3, then pool 3×3/s2/p1), so [a, b)
    reads 4a − 5 … 4b + 1. lo = 4a − 8, a multiple of 4, keeps the stride
    phase of the whole level (local pooled column q − lo/4 is global q)
    and leaves the kernel's own borders to the two pooled columns before a;
    the window is then widened to a multiple of 8 columns, K2's aligned
    route, where the level allows. A window at a global edge takes no halo
    there, so the kernel's padding is the level's."""
    def reads(a: int, b: int):
        lo = max(0, 4 * a - 8)
        return lo, min(width, lo + -(-(4 * b + 2 - lo) // 8) * 8)
    return reads


def fused_stem_pool_cols(x: torch.Tensor, width: int, weight: torch.Tensor,
                         scale: torch.Tensor, shift: torch.Tensor, plain: bool = False):
    """``fused_stem_pool`` of a width-split level: from this rank's columns
    ``x`` (B, H, w, 3) of a level ``width`` wide, (this rank's pooled
    columns (B, Hp, wp, 64), the pooled width ``stem_output_hw``'s). K2
    runs unchanged on the window ``stem_reads`` gives and its output is
    cropped to this rank's columns; ``plain`` takes ``stem_pool_reference``
    on any device (the unfused stem)."""
    hp, w_out = stem_output_hw(x.shape[1], width)
    fn = stem_pool_reference if plain else fused_stem_pool

    def pooled(xw, lo, hi, a, b):
        return fn(xw.contiguous(), weight, scale, shift)[:, :, a - lo // 4:b - lo // 4]

    y = windowed(x, width, w_out, stem_reads(width), pooled, dim=2)
    return (x.new_zeros((x.shape[0], hp, 0, 64)) if y is None else y), w_out


def stem_pool_tensor_cores(x: torch.Tensor, weight: torch.Tensor,
                           scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Launches ``csrc/stem_pool_tc.cu`` on a bf16 CUDA tensor."""
    _check_shapes(x, weight, scale, shift)
    _check_cuda(x, weight, scale, shift, (torch.bfloat16,))
    w_k = stem_weight_fragments(pack_stem_weight(weight))
    sc, sh, out = _affine_and_out(x, scale, shift)
    lib = _lib("stem_pool_tc", "dcss_stem_pool_tc", 3)
    b, h, w, _ = x.shape
    with torch.cuda.device(x.device):
        status = lib.dcss_stem_pool_tc(
            x.data_ptr(), w_k.data_ptr(), sc.data_ptr(), sh.data_ptr(), out.data_ptr(),
            b, h, w, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, status, "fused_stem_pool (tensor cores)")
    fused_stem_pool.launches += 1
    fused_stem_pool.tc_launches += 1
    return out


def stem_pool_cuda_cores(x: torch.Tensor, weight: torch.Tensor,
                         scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Launches ``csrc/stem_pool.cu`` (f32 arithmetic) on an f32 or bf16 CUDA
    tensor: the f32 route, and the previous bf16 design kept for timing."""
    _check_shapes(x, weight, scale, shift)
    _check_cuda(x, weight, scale, shift, _DTYPES)
    # (ky, kx, ci, co): a thread's output channels are contiguous
    w_k = weight.detach().permute(2, 3, 1, 0).contiguous().to(x.dtype)
    sc, sh, out = _affine_and_out(x, scale, shift)
    lib = _lib("stem_pool", "dcss_stem_pool", 4)
    b, h, w, _ = x.shape
    with torch.cuda.device(x.device):
        status = lib.dcss_stem_pool(
            x.data_ptr(), w_k.data_ptr(), sc.data_ptr(), sh.data_ptr(), out.data_ptr(),
            b, h, w, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, status, "fused_stem_pool (CUDA cores)")
    fused_stem_pool.launches += 1
    fused_stem_pool.cc_launches += 1
    return out


def _check_shapes(x, weight, scale, shift) -> None:
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"fused_stem_pool: x must be (B, H, W, 3), got {tuple(x.shape)}")
    if tuple(weight.shape) != (64, 3, 7, 7):
        raise ValueError(f"fused_stem_pool: weight must be (64, 3, 7, 7), got {tuple(weight.shape)}")
    if scale.shape != (64,) or shift.shape != (64,):
        raise ValueError("fused_stem_pool: scale and shift must be (64,)")


def _check_cuda(x, weight, scale, shift, dtypes) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"fused_stem_pool: the kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"fused_stem_pool: this route takes {dtypes}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_stem_pool: x must be contiguous NHWC")
    for t in (weight, scale, shift):
        if t.device != x.device:
            raise ValueError("fused_stem_pool: all tensors must be on x's device")


def _affine_and_out(x, scale, shift):
    b, h, w, _ = x.shape
    hp, wp = stem_output_hw(h, w)
    return (scale.detach().float().contiguous(), shift.detach().float().contiguous(),
            torch.empty((b, hp, wp, 64), dtype=x.dtype, device=x.device))


def _lib(name: str, fn_name: str, n_ints: int) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
