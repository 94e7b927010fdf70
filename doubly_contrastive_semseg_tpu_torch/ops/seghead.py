"""Fused serving head: eval BN → ReLU → 1×1 conv → ×4 bilinear → argmax.

Port of the JAX package's ``ops/seghead_pallas.py::
fused_seghead_upsample_argmax`` (the TPU kernel ``_kernel`` with
``_phases4``). Two CUDA kernels, chosen by dtype:

- bf16: ``csrc/seghead_tc.cu``, persistent blocks walking strips of the
  image with ``cp.async``-fed staging, the 1×1 on tensor cores and the ×4
  upsample-argmax in separable phases (``phases4``).
- f32: ``csrc/seghead.cu`` on CUDA cores, in f32 throughout.

Each source's note names its bound (bytes) and design. A tensor on the CPU
takes the plain version, ``seghead_reference``; a CUDA tensor launches its
dtype's kernel or raises. The folded BN and the weights in each kernel's
order are packed once (``pack_seghead``) and cached against the parameters'
storage and version counters, so an in-place update repacks them.

Numerics, shared by kernels and plain version: BN folds to scale/shift in
float32; the post-ReLU activations and the conv weights are rounded to the
feature dtype (bf16 on the card, as the TPU kernel does) and contracted
with float32 accumulation; upsampling and argmax run in float32, ties to
the first class.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Dict, List, Tuple

import torch

from ..parallel.spatial import windowed
from . import _build
from .input_pipeline import upsample4x_argmax

_DTYPES = (torch.float32, torch.bfloat16)
MAX_CLASSES = 32
CIN = 128
# the tensor-core kernel's work item: a strip of STRIP feature columns and
# a run of RUN feature rows (csrc/seghead_tc.cu)
STRIP, RUN = 64, 32
# the logit of a class that only pads the tensor-core kernel's n tiles
PAD_LOGIT = -1e30
_PACK_CACHE_SIZE = 8


def fold_bn(bn_scale, bn_bias, bn_mean, bn_var,
            eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm as float32 (scale, shift): x̂ = x·scale + shift."""
    a = bn_scale.float() * torch.rsqrt(bn_var.float() + eps)
    return a, bn_bias.float() - bn_mean.float() * a


def phases4(prev: torch.Tensor, cur: torch.Tensor, nxt: torch.Tensor) -> List[torch.Tensor]:
    """The 4 phases of a ×4 bilinear upsample (align_corners=False) along an
    axis, from each source pixel and its two neighbours (edge-replicated at
    the border), in the JAX kernel's delta form (``_phases4``): phase r sits
    at offset (r + 0.5) / 4 − 0.5 from ``cur``."""
    dp, dn = prev - cur, nxt - cur
    return [cur + 0.375 * dp, cur + 0.125 * dp, cur + 0.125 * dn, cur + 0.375 * dn]


def seghead_reference(feat, bn_scale, bn_bias, bn_mean, bn_var, conv_weight,
                      conv_bias, eps: float = 1e-5) -> torch.Tensor:
    """Plain semantics of the kernels: (B, h, w, 128) → (B, 4h, 4w) int8."""
    a, shift = fold_bn(bn_scale, bn_bias, bn_mean, bn_var, eps)
    act = torch.relu(feat.float() * a + shift).to(feat.dtype).float()
    w = conv_weight.reshape(conv_weight.shape[0], -1).to(feat.dtype).float()
    logits = torch.einsum("bhwk,ck->bhwc", act, w) + conv_bias.float()
    return upsample4x_argmax(logits).to(torch.int8)


def weight_fragments(padded: torch.Tensor) -> torch.Tensor:
    """(8·NT, 128) bf16 weights → (8, NT, 32, 4), the order of the tensor-core
    kernel's m16n8k16 B fragments: k-step s, n tile n, lane 4g + t holds
    ``padded[8n + g, 16s + 8h + 2t + e]`` at 2h + e."""
    nt = padded.shape[0] // 8
    return (padded.reshape(nt, 8, 8, 2, 4, 2).permute(2, 0, 1, 4, 3, 5)
            .reshape(8, nt, 32, 4).contiguous())


def pack_seghead(bn_scale, bn_bias, bn_mean, bn_var, conv_weight, conv_bias,
                 eps: float = 1e-5, dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The operands of both kernels, plain PyTorch on the parameters' device:
    ``ab`` (2, 128) f32 folded BN scale and shift; ``wfrag`` the weights,
    bf16, zero-padded to NT = ⌈C/8⌉ n tiles, in fragment order
    (``weight_fragments``); ``bias`` (8·NT,) f32, ``PAD_LOGIT`` on the padded
    classes; ``wt`` (128, ⌈C/4⌉·4) f32, the CUDA-core kernel's weights
    rounded to ``dtype``."""
    with torch.no_grad():
        a, shift = fold_bn(bn_scale, bn_bias, bn_mean, bn_var, eps)
        c = conv_weight.shape[0]
        w = conv_weight.reshape(c, CIN)
        nt = -(-c // 8)
        padded = torch.zeros(8 * nt, CIN, dtype=torch.bfloat16, device=w.device)
        padded[:c] = w.to(torch.bfloat16)
        bias = torch.full((8 * nt,), PAD_LOGIT, dtype=torch.float32, device=w.device)
        bias[:c] = conv_bias.float()
        wt = torch.zeros(CIN, -(-c // 4) * 4, dtype=torch.float32, device=w.device)
        wt[:, :c] = w.to(dtype).float().t()
        return {"ab": torch.stack([a, shift]).contiguous(), "wfrag": weight_fragments(padded),
                "bias": bias, "wt": wt}


_packs: "OrderedDict[tuple, tuple]" = OrderedDict()


def packed_head(bn_scale, bn_bias, bn_mean, bn_var, conv_weight, conv_bias,
                eps: float = 1e-5, dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """``pack_seghead`` of the parameters, cached by each parameter's
    ``data_ptr()``, version counter, dtype, device and shape: an in-place
    update (``copy_``, an optimizer step, BN running stats) bumps the
    version and repacks. An entry holds its parameters, so no other tensor
    can take their addresses while it is cached."""
    params = (bn_scale, bn_bias, bn_mean, bn_var, conv_weight, conv_bias)
    key = (eps, dtype) + tuple((t.data_ptr(), t._version, t.dtype, t.device, tuple(t.shape))
                               for t in params)
    hit = _packs.get(key)
    if hit is not None:
        _packs.move_to_end(key)
        return hit[1]
    pack = pack_seghead(*params, eps=eps, dtype=dtype)
    _packs[key] = (params, pack)
    if len(_packs) > _PACK_CACHE_SIZE:
        _packs.popitem(last=False)
    return pack


def fused_seghead_upsample_argmax(feat, bn_scale, bn_bias, bn_mean, bn_var,
                                  conv_weight, conv_bias,
                                  eps: float = 1e-5) -> torch.Tensor:
    """(B, h, w, 128) decoder features → (B, 4h, 4w) int8 label map, equal to
    ``argmax(resize_bilinear(BNReluConv(feat), ×4))`` with eval BN; the
    full-resolution logits are never written. ``conv_weight`` is (C, 128)
    or (C, 128, 1, 1). A bf16 CUDA tensor takes the tensor-core kernel, an
    f32 one the CUDA-core kernel. Counts every launch in
    ``fused_seghead_upsample_argmax.launches`` and each route's in
    ``.tc_launches`` (bf16) and ``.cc_launches`` (f32)."""
    params = (bn_scale, bn_bias, bn_mean, bn_var, conv_weight, conv_bias)
    _check_shapes(feat, conv_weight, conv_bias)
    if feat.device.type == "cpu":
        return seghead_reference(feat, *params, eps)
    if feat.dtype == torch.bfloat16:
        return seghead_tensor_cores(feat, *params, eps=eps)
    return seghead_cuda_cores(feat, *params, eps=eps)


fused_seghead_upsample_argmax.launches = 0
fused_seghead_upsample_argmax.tc_launches = 0
fused_seghead_upsample_argmax.cc_launches = 0


def seghead_reads(width: int):
    """(A, B) → [lo, hi): the feature window whose ×4 labels, through K1
    unchanged, are those of the whole width-``width`` map at label columns
    [A, B). Label column X = 4c + r blends feature columns c − 1, c (r < 2)
    or c, c + 1 (r ≥ 2), which K1 clamps at its borders: one feature column
    of halo on each inner side, lo ≤ (A − 2)/4 and hi ≥ (B + 2)/4, clipped
    to the map, whose own clamp then holds. Label columns map to feature
    columns 4 to 1, so the window's labels are cropped from 4·lo on."""
    def reads(a: int, b: int):
        return max(0, (a - 2) // 4), min(width, -(-(b + 2) // 4))
    return reads


def fused_seghead_cols(feat: torch.Tensor, width: int, bn_scale, bn_bias, bn_mean, bn_var,
                       conv_weight, conv_bias, eps: float = 1e-5) -> torch.Tensor:
    """``fused_seghead_upsample_argmax`` of width-split features: from this
    rank's columns ``feat`` (B, h, w, 128) of a map ``width`` wide, this
    rank's columns of the (B, 4h, 4·width) int8 label map (``parallel/
    spatial.py``'s rule), K1 run on the window ``seghead_reads`` gives."""
    params = (bn_scale, bn_bias, bn_mean, bn_var, conv_weight, conv_bias)

    def labels(fw, lo, hi, a, b):
        out = fused_seghead_upsample_argmax(fw.contiguous(), *params, eps=eps)
        return out[:, :, a - 4 * lo:b - 4 * lo].contiguous()

    y = windowed(feat, width, 4 * width, seghead_reads(width), labels, dim=2)
    if y is None:
        return torch.empty((feat.shape[0], 4 * feat.shape[1], 0), dtype=torch.int8,
                           device=feat.device)
    return y


def seghead_tensor_cores(feat, bn_scale, bn_bias, bn_mean, bn_var, conv_weight, conv_bias,
                         eps: float = 1e-5) -> torch.Tensor:
    """Launches ``csrc/seghead_tc.cu`` on a bf16 CUDA tensor."""
    params = (bn_scale, bn_bias, bn_mean, bn_var, conv_weight, conv_bias)
    _check_shapes(feat, conv_weight, conv_bias)
    _check_cuda(feat, params, (torch.bfloat16,))
    return launch("tc", feat, packed_head(*params, eps=eps), conv_weight.shape[0])


def seghead_cuda_cores(feat, bn_scale, bn_bias, bn_mean, bn_var, conv_weight, conv_bias,
                       eps: float = 1e-5) -> torch.Tensor:
    """Launches ``csrc/seghead.cu`` (f32 arithmetic) on an f32 or bf16 CUDA
    tensor: the f32 route, and the previous bf16 design kept for timing."""
    params = (bn_scale, bn_bias, bn_mean, bn_var, conv_weight, conv_bias)
    _check_shapes(feat, conv_weight, conv_bias)
    _check_cuda(feat, params, _DTYPES)
    return launch("cc", feat, packed_head(*params, eps=eps, dtype=feat.dtype),
                  conv_weight.shape[0])


def launch(route: str, feat: torch.Tensor, pack: Dict[str, torch.Tensor], c: int,
           out: torch.Tensor = None) -> torch.Tensor:
    """One launch of the ``route`` kernel ("tc": ``csrc/seghead_tc.cu``,
    "cc": ``csrc/seghead.cu``) on checked inputs and a ``pack_seghead``
    pack, into ``out`` (a new (B, 4h, 4w) int8 tensor by default); counted."""
    b, h, w, _ = feat.shape
    if out is None:
        out = torch.empty((b, 4 * h, 4 * w), dtype=torch.int8, device=feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    with torch.cuda.device(feat.device):
        if route == "tc":
            lib = _lib("seghead_tc", "dcss_seghead_tc", 4)
            status = lib.dcss_seghead_tc(
                feat.data_ptr(), pack["wfrag"].data_ptr(), pack["ab"].data_ptr(),
                pack["bias"].data_ptr(), out.data_ptr(), b, h, w, c, stream)
        else:
            lib = _lib("seghead", "dcss_seghead", 5)
            status = lib.dcss_seghead(
                feat.data_ptr(), pack["wt"].data_ptr(), pack["ab"].data_ptr(),
                pack["bias"].data_ptr(), out.data_ptr(), b, h, w, c,
                int(feat.dtype == torch.bfloat16), stream)
    _build.check(lib, status, f"fused_seghead_upsample_argmax ({route})")
    fn = fused_seghead_upsample_argmax
    fn.launches += 1
    setattr(fn, f"{route}_launches", getattr(fn, f"{route}_launches") + 1)
    return out


def _check_shapes(feat, conv_weight, conv_bias) -> None:
    if feat.dim() != 4 or feat.shape[-1] != CIN:
        raise ValueError(f"seghead: feat must be (B, h, w, 128), got {tuple(feat.shape)}")
    c = conv_weight.shape[0]
    if conv_weight.numel() != c * CIN or conv_bias.shape != (c,):
        raise ValueError("seghead: conv_weight must be (C, 128[, 1, 1]), conv_bias (C,)")
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"seghead: 1 <= C <= {MAX_CLASSES} classes, got {c}")


def _check_cuda(feat, params, dtypes) -> None:
    if feat.device.type != "cuda":
        raise ValueError(f"seghead: the kernel needs a CUDA tensor, got {feat.device}")
    if feat.dtype not in dtypes:
        raise TypeError(f"seghead: this route takes {dtypes}, got {feat.dtype}")
    if not feat.is_contiguous() or feat.data_ptr() % 16:
        raise ValueError("seghead: feat must be contiguous NHWC, 16-byte aligned")
    for t in params:
        if t.device != feat.device:
            raise ValueError("seghead: all tensors must be on feat's device")


def _lib(name: str, fn_name: str, n_ints: int) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
