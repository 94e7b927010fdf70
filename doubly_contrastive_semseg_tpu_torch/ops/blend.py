"""Fused SwiftNet decoder step: conv3×3(ReLU(BN_eval(up2_bilinear(x) + skip))).

Port of the JAX package's ``ops/blend_pallas.py::fused_upsample_blend`` (the
TPU kernel ``_kernel``), one ``UpsampleBlend`` step of the decoder in eval
mode. The CUDA kernel is ``csrc/blend_mma.cu`` (``mma.sync`` tensor cores fed
by ``ldmatrix``, a ``cp.async`` ring of half-tap weights); its note names
the bound (operations) and the design. A tensor on the CPU takes the plain
version, ``upsample_blend_reference``; a CUDA tensor launches the kernel or
raises. The weights, in the kernel's layout, and the folded BN are packed
once (``pack_blend``) and cached against the parameters' storage and
version counters (``packed_blend``), so an in-place update repacks them.
``blend_tiled`` emulates the kernel's tiling on the CPU for the tests.
``csrc/blend.cu`` (``wmma``, the first design) is reached only through
``_wmma_upsample_blend``, the tools' yardstick. Tensors are NHWC, the
channels_last view the model holds.

Numerics, shared by kernels and plain version:

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
from collections import OrderedDict
from typing import Dict

import torch
import torch.nn.functional as F

from . import _build
from .seghead import fold_bn

_IN_DTYPES = (torch.float32, torch.bfloat16)
_OUT_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535
_PACK_CACHE_SIZE = 8
# the kernel's tiling (csrc/blend_mma.cu): channels a chunk, output rows and
# columns a block, and the half-taps of a chunk of input channels
CK, TH, TW = 128, 8, 16
HALF_TAPS = 18


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


def _check_shapes(x, skip, conv_weight, bn, out_dtype=torch.float32) -> None:
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"upsample_blend: out_dtype must be float32 or bfloat16, got {out_dtype}")
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


def pack_blend(conv_weight, bn_scale, bn_bias, bn_mean, bn_var,
               eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """The kernel's operands, plain PyTorch on the parameters' device:
    ``w`` the conv weight rounded to bf16 as (C/128, C/128, 9, 2, 64, 128):
    [output chunk][input chunk][tap ky·3+kx][half][input channel][output
    channel], so each half-tap the kernel stages is one contiguous block;
    ``ab`` (2, C) f32, the folded BN scale and shift."""
    with torch.no_grad():
        n = conv_weight.shape[0] // CK
        w9 = conv_weight.permute(2, 3, 1, 0).to(torch.bfloat16)  # (3, 3, C_in, C_out)
        w = w9.reshape(9, n, 2, CK // 2, n, CK).permute(4, 1, 0, 2, 3, 5).contiguous()
        a, shift = fold_bn(bn_scale, bn_bias, bn_mean, bn_var, eps)
        return {"w": w, "ab": torch.stack([a, shift]).contiguous()}


_packs: "OrderedDict[tuple, tuple]" = OrderedDict()


def packed_blend(conv_weight, bn_scale, bn_bias, bn_mean, bn_var,
                 eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """``pack_blend`` of the parameters, cached by each parameter's
    ``data_ptr()``, version counter, dtype, device and shape: an in-place
    update (``copy_``, an optimizer step, BN running stats) bumps the
    version and repacks. An entry holds its parameters, so no other tensor
    can take their addresses while it is cached."""
    params = (conv_weight, bn_scale, bn_bias, bn_mean, bn_var)
    key = (eps,) + tuple((t.data_ptr(), t._version, t.dtype, t.device, tuple(t.shape))
                         for t in params)
    hit = _packs.get(key)
    if hit is not None:
        _packs.move_to_end(key)
        return hit[1]
    pack = pack_blend(*params, eps=eps)
    _packs[key] = (params, pack)
    if len(_packs) > _PACK_CACHE_SIZE:
        _packs.popitem(last=False)
    return pack


def blend_tiled(x, skip, conv_weight, bn_scale, bn_bias, bn_mean, bn_var,
                eps: float = 1e-5, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain emulation of ``csrc/blend_mma.cu``'s tiling, in float32 on the
    CPU: for each block's tile (8 output rows × 16 columns × 128 output
    channels) it forms the 10 × 18 halo'd activation of each 128-wide chunk
    of input channels as the kernel does (the bilinear's clamped source
    indices and ¼/¾ weights, each product and sum rounded to bf16; zero
    outside the image), accumulates the 9 taps × 2 halves of ``pack_blend``'s
    weights in the kernel's half-tap order, and stores only the columns
    inside the image (the ragged right edge)."""
    bn = (bn_scale, bn_bias, bn_mean, bn_var)
    _check_shapes(x, skip, conv_weight, bn, out_dtype)
    b, hh, ww, c = skip.shape
    h, w = hh // 2, ww // 2
    n = c // CK
    pack = pack_blend(conv_weight.cpu(), *(t.cpu() for t in bn), eps=eps)
    wp, (a, shift) = pack["w"].float(), pack["ab"]
    xb = x.detach().cpu().to(torch.bfloat16).float()
    sb = skip.detach().cpu().to(torch.bfloat16).float()

    def rb(t):
        return t.to(torch.bfloat16).float()

    def blend2(wa, p, q):
        return rb(rb(wa * p) + rb((1.0 - wa) * q))

    out = torch.empty((b, hh, ww, c), dtype=torch.float32)
    for i0 in range(0, hh, TH):
        for j0 in range(0, ww, TW):
            width = min(TW, ww - j0)
            R = torch.arange(i0 - 1, i0 + TH + 1)[:, None].expand(TH + 2, TW + 2)
            Q = torch.arange(j0 - 1, j0 + TW + 1)[None, :].expand(TH + 2, TW + 2)
            inside = ((R >= 0) & (R < hh) & (Q >= 0) & (Q < ww))[..., None]
            R, Q = R.clamp(0, hh - 1), Q.clamp(0, ww - 1)
            ky, kx = R // 2, Q // 2
            odd_r, odd_q = R % 2 == 1, Q % 2 == 1
            ya = torch.where(odd_r, ky, (ky - 1).clamp(min=0))
            yb = torch.where(odd_r, (ky + 1).clamp(max=h - 1), ky)
            xa = torch.where(odd_q, kx, (kx - 1).clamp(min=0))
            xc = torch.where(odd_q, (kx + 1).clamp(max=w - 1), kx)
            wya = torch.where(odd_r, 0.75, 0.25)[..., None]
            wxa = torch.where(odd_q, 0.75, 0.25)[..., None]
            for bi in range(b):
                acts = []
                for ci in range(n):
                    cs = slice(ci * CK, (ci + 1) * CK)
                    img = xb[bi, :, :, cs]
                    ra = blend2(wya, img[ya, xa], img[yb, xa])
                    rc = blend2(wya, img[ya, xc], img[yb, xc])
                    pre = rb(blend2(wxa, ra, rc) + sb[bi, R, Q, cs])
                    act = rb(torch.relu(pre * a[cs] + shift[cs]))
                    acts.append(torch.where(inside, act, torch.zeros(())))
                for co in range(n):
                    acc = torch.zeros(TH, TW, CK)
                    for s in range(n * HALF_TAPS):
                        ci, hs = divmod(s, HALF_TAPS)
                        tap, half = divmod(hs, 2)
                        dy, dx = divmod(tap, 3)
                        k = slice(half * (CK // 2), (half + 1) * (CK // 2))
                        acc += acts[ci][dy:dy + TH, dx:dx + TW, k] @ wp[co, ci, tap, half]
                    out[bi, i0:i0 + TH, j0:j0 + width, co * CK:(co + 1) * CK] = acc[:, :width]
    return out.to(out_dtype)


def fused_upsample_blend(x, skip, conv_weight, bn_scale, bn_bias, bn_mean,
                         bn_var, eps: float = 1e-5,
                         out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``conv3×3(ReLU(BN_eval(up2_bilinear(x) + skip)))`` without writing
    the upsampled tensor or the activation. x: (B, H/2, W/2, C) and skip:
    (B, H, W, C), contiguous NHWC, float32 or bf16 (rounded to bf16);
    ``conv_weight``: (C, C, 3, 3), torch's layout; BN tensors (C,); H and W
    multiples of 8, C of 128 (``blend_kernel_supported``). Returns (B, H, W,
    C) contiguous NHWC in ``out_dtype``. A CUDA tensor launches
    ``csrc/blend_mma.cu`` on the cached pack (``packed_blend``): with bf16
    inputs and unchanged parameters a call enqueues the kernel and nothing
    else. No gradient flows through the kernel (eval only). Counts its
    launches in ``fused_upsample_blend.launches``."""
    bn = (bn_scale, bn_bias, bn_mean, bn_var)
    _check_shapes(x, skip, conv_weight, bn, out_dtype)
    if x.device.type == "cpu":
        return upsample_blend_reference(x, skip, conv_weight, *bn, eps=eps,
                                        out_dtype=out_dtype)
    xb, sb = _cuda_inputs(x, skip, conv_weight, bn)
    return launch("mma", xb, sb, packed_blend(conv_weight, *bn, eps=eps), out_dtype)


fused_upsample_blend.launches = 0


def wmma_weights(conv_weight) -> torch.Tensor:
    """(C_out, C_in, 3, 3) → (9, C_in, C_out) bf16, tap-major as the TPU
    kernel's w9: the layout ``csrc/blend.cu`` reads."""
    return conv_weight.detach().permute(2, 3, 1, 0).reshape(
        9, conv_weight.shape[1], conv_weight.shape[0]).to(torch.bfloat16).contiguous()


def _wmma_upsample_blend(x, skip, conv_weight, bn_scale, bn_bias, bn_mean, bn_var,
                         eps: float = 1e-5,
                         out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The first design, ``csrc/blend.cu`` (``wmma``), on CUDA tensors, with
    the weights and BN packed on every call as it shipped: the tools'
    yardstick, on no path of the model. Counted in
    ``_wmma_upsample_blend.launches``."""
    bn = (bn_scale, bn_bias, bn_mean, bn_var)
    _check_shapes(x, skip, conv_weight, bn, out_dtype)
    xb, sb = _cuda_inputs(x, skip, conv_weight, bn)
    a, shift = fold_bn(*(t.detach() for t in bn), eps)
    return launch("wmma", xb, sb, {"w": wmma_weights(conv_weight),
                                   "ab": torch.stack([a, shift]).contiguous()}, out_dtype)


_wmma_upsample_blend.launches = 0


def _cuda_inputs(x, skip, conv_weight, bn):
    """x and skip as bf16, after the checks a kernel launch needs."""
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
    b, hh, _, c = skip.shape
    if hh // TH > _MAX_GRID_YZ or b * (c // CK) > _MAX_GRID_YZ:
        raise ValueError(f"upsample_blend: skip {tuple(skip.shape)} exceeds the launch grid")
    return x.to(torch.bfloat16), skip.to(torch.bfloat16)


def launch(route: str, xb: torch.Tensor, sb: torch.Tensor, pack: Dict[str, torch.Tensor],
           out_dtype: torch.dtype = torch.bfloat16, out: torch.Tensor = None) -> torch.Tensor:
    """One launch of the ``route`` kernel ("mma": ``csrc/blend_mma.cu`` on a
    ``pack_blend`` pack, counted in ``fused_upsample_blend.launches``;
    "wmma": ``csrc/blend.cu`` on ``wmma_weights``, counted in
    ``_wmma_upsample_blend.launches``) on checked bf16 CUDA inputs, into
    ``out`` (a new (B, H, W, C) tensor of ``out_dtype`` by default)."""
    b, hh, ww, c = sb.shape
    if out is None:
        out = torch.empty((b, hh, ww, c), dtype=out_dtype, device=sb.device)
    name, fn_name = {"mma": ("blend_mma", "dcss_upsample_blend_mma"),
                     "wmma": ("blend", "dcss_upsample_blend")}[route]
    lib = _lib(name, fn_name)
    with torch.cuda.device(sb.device):
        status = getattr(lib, fn_name)(
            xb.data_ptr(), sb.data_ptr(), pack["w"].data_ptr(), pack["ab"].data_ptr(),
            out.data_ptr(), b, hh, ww, c, int(out.dtype == torch.bfloat16),
            torch.cuda.current_stream(sb.device).cuda_stream)
    _build.check(lib, status, f"fused_upsample_blend ({route})")
    counted = fused_upsample_blend if route == "mma" else _wmma_upsample_blend
    counted.launches += 1
    return out


def _lib(name: str, fn_name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
