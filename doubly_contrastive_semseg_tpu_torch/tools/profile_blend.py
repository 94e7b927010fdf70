"""The fused upsample-blend (K5) alone on the card: the kernel and the first
design against the plain version, times at the three decoder steps of an
eval forward, and ablations of the kernel's source.

    python3 -m doubly_contrastive_semseg_tpu_torch.tools.profile_blend

Builds only ``csrc/blend.cu`` (``wmma``, the first design) and
``csrc/blend_mma.cu`` (``mma.sync`` fed by ``ldmatrix``, the kernel of
``fused_upsample_blend``) and prints ptxas's registers and spills and the
new kernel's shared memory a block. Holds both to
``upsample_blend_reference`` at ``CHECK_SHAPES`` (the three decoder steps of
a 2048×1024 batch of 8, a ragged width tile, B = 1 and C = 256) for f32
output within 1e-3 × max|ref| and bf16 output within 1e-2 × max|ref| (the
kernels sum the 1152 products in another order than the plain version's
conv; bf16 output adds one rounding), each call counted on its route; and
checks that a call on bf16 inputs with unchanged parameters enqueues one
device operation, the kernel (its capture in a CUDA graph has one kernel
node, ``profile_stem.captured_ops``). Then times, at the three headline
shapes, with ``profile_stem.cuda_ms`` (launches enqueued behind a sleep kernel, so the
device is timed and not the host): the kernel alone (``ms``), the first
design alone on the same inputs (``wmma_ms``), the wrapper (``wrapper_ms``:
the pack cache's lookup and the launch), the plain version (``plain_ms``)
and the unfused PyTorch step (``unfused_ms``: ``UpsampleBlend`` unfused,
bilinear, add, BN, ReLU, cuDNN conv), with TFLOP/s and the products' share
of the card's ``mma.sync`` bf16 rate (652.5 TFLOP/s,
``tools/stem_variants.py``); then variants of ``blend_mma.cu`` with a piece
of its text replaced (no weight copies, no products, no activation
formation) and the other tile the design allows (16 × 16 pixels, 16 warps,
one block an SM), compiled into a temporary directory.
``chip_smoke.py`` phase 9 calls ``check_kernel``, ``device_ops`` and
``time_blend``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..models.blocks import UpsampleBlend
from ..ops import _build, blend
from .profile_stem import CU_GRAPH_NODE_TYPE_KERNEL, captured_ops, cuda_ms
from .stem_variants import _compile

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_TENSOR_FLOPS = 989e12
# mma.sync.m16n8k16 bf16 on this card, measured by tools/stem_variants.py
MMA_SYNC_BF16_FLOPS = 652.5e12

# the decoder steps of a 2048×1024 batch-8 forward that take the kernel
HEADLINE = [(8, 64, 128), (8, 128, 256), (8, 256, 512)]
CHECK_SHAPES = HEADLINE + [(2, 64, 72),        # a ragged width tile
                           (1, 16, 40),        # B = 1, ragged
                           (2, 16, 32, 256)]   # C = 256: two chunks each way
TOLERANCES = ((torch.float32, 1e-3), (torch.bfloat16, 1e-2))
ROUTES = {"mma": (blend.fused_upsample_blend, "fused_upsample_blend"),
          "wmma": (blend._wmma_upsample_blend, "_wmma_upsample_blend")}

_COPIES = ("        cp_async16(dst", "        if (false) cp_async16(dst")
_PRODUCTS = ("    products(acc,", "    if (false) products(acc,")
_HALO = ("      form_halo(act_s,", "      if (false) form_halo(act_s,")
# the other design the kernel's constants allow: 16 x 16 output pixels and
# 16 warps a block, one block an SM (half the weight copies an output pixel,
# a 1.27x halo where 8 x 16 has 1.41x, no second block to hide the halo)
_TILE16 = [("constexpr int TH = 8;", "constexpr int TH = 16;"),
           ("constexpr int WARPS = 8;", "constexpr int WARPS = 16;"),
           ("constexpr int BLOCKS_PER_SM = 2;", "constexpr int BLOCKS_PER_SM = 1;")]
VARIANTS = {"no weight copies": [_COPIES], "no products": [_PRODUCTS],
            "no activation formation": [_HALO], "16 x 16 tile": _TILE16}
CHECKED = ("as built", "16 x 16 tile")


def blend_inputs(gen, dev, b, hh, ww, c=128):
    """bf16 x (B, H/2, W/2, C) and skip (B, H, W, C), a conv weight of the
    init's scale and a random BN, on the card."""
    return dict(x=torch.randn(b, hh // 2, ww // 2, c, generator=gen).to(dev, torch.bfloat16),
                skip=torch.randn(b, hh, ww, c, generator=gen).to(dev, torch.bfloat16),
                conv_weight=(torch.randn(c, c, 3, 3, generator=gen) * (2.0 / (9 * c)) ** 0.5
                             ).to(dev),
                bn_scale=(torch.rand(c, generator=gen) * 0.3 + 0.5).to(dev),
                bn_bias=(torch.randn(c, generator=gen) * 0.1).to(dev),
                bn_mean=(torch.randn(c, generator=gen) * 0.1).to(dev),
                bn_var=(torch.rand(c, generator=gen) + 1.0).to(dev))


def check_kernel(gen, dev, log=print) -> float:
    """Both routes against ``upsample_blend_reference`` at ``CHECK_SHAPES``
    and both out dtypes; raises on a disagreement, a wrong shape or dtype,
    or a call that was not counted once on its route. Returns the kernel's
    max abs error at f32 output over the headline shapes."""
    err_headline = 0.0
    for shape in CHECK_SHAPES:
        b, hh, ww = shape[:3]
        c = shape[3] if len(shape) > 3 else 128
        a = blend_inputs(gen, dev, *shape)
        for out_dtype, rel_tol in TOLERANCES:
            ref = blend.upsample_blend_reference(**a, out_dtype=out_dtype)
            ref_max = ref.float().abs().max().item()
            for route, (fn, what) in ROUTES.items():
                before = fn.launches
                got = fn(**a, out_dtype=out_dtype)
                torch.cuda.synchronize()
                if fn.launches - before != 1:
                    raise RuntimeError(f"blend {what} made {fn.launches - before} launches")
                if got.shape != (b, hh, ww, c) or got.dtype != out_dtype:
                    raise RuntimeError(f"blend {what}: output {tuple(got.shape)} {got.dtype}")
                err = (got.float() - ref.float()).abs().max().item()
                log(f"  blend {route:4s} {str(out_dtype)[6:]:8s} x {tuple(a['x'].shape)} -> "
                    f"{tuple(got.shape)}: max abs err {err:.3e} = {err / ref_max:.2e} x max|ref| "
                    f"(tolerance {rel_tol})")
                if not err <= rel_tol * ref_max:
                    raise RuntimeError(f"blend {what} disagrees at {shape} {out_dtype}")
                if route == "mma" and out_dtype == torch.float32 and shape in HEADLINE:
                    err_headline = max(err_headline, err)
        del a, got, ref
    torch.cuda.empty_cache()
    return err_headline


def device_ops(gen, dev, log=print) -> list:
    """The device operations of one ``fused_upsample_blend`` call on bf16
    inputs with parameters already packed, read from the call's capture in
    a CUDA graph (``profile_stem.captured_ops``). Raises unless that is one
    kernel, ``blend_mma.cu``'s. Returns [(node type, kernel name)] (type
    0: kernel)."""
    a = blend_inputs(gen, dev, *HEADLINE[0])
    blend.fused_upsample_blend(**a)
    torch.cuda.synchronize()
    ops = captured_ops(lambda: blend.fused_upsample_blend(**a))
    log(f"  blend: a packed call captured as {len(ops)} device operation(s): {ops} "
        "(type 0: kernel)")
    if (len(ops) != 1 or ops[0][0] != CU_GRAPH_NODE_TYPE_KERNEL
            or "16blend_mma_kernel" not in ops[0][1]):
        raise RuntimeError(f"a packed fused_upsample_blend call enqueued {ops}, not one "
                           "blend_mma_kernel")
    return ops


def blend_work(b, hh, ww, c=128):
    """(flops, bytes) of one step: 2·B·H·W·9·C² and the bf16 x, skip, conv
    weight and output, each once."""
    return 2.0 * b * hh * ww * 9 * c * c, (b * hh * ww * c * 9 // 4 + 9 * c * c) * 2


def bound(flops, nbytes):
    """(bound ms, 'operations' or 'bytes')."""
    ops_s, bytes_s = flops / PEAK_BF16_TENSOR_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s > bytes_s else "bytes"


def unfused_step(a):
    """The unfused PyTorch step on ``a``: ``UpsampleBlend`` (channels_last,
    eval, ``fuse_inference`` off) with ``a``'s conv weight and BN."""
    step = UpsampleBlend(128).to(a["x"].device, memory_format=torch.channels_last).eval()
    with torch.no_grad():
        step.blend_conv.conv.weight.copy_(a["conv_weight"])
        norm = step.blend_conv.norm
        for name, key in (("weight", "bn_scale"), ("bias", "bn_bias"),
                          ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            getattr(norm, name).copy_(a[key])
    x, skip = a["x"].permute(0, 3, 1, 2), a["skip"].permute(0, 3, 1, 2)

    @torch.no_grad()
    def run():
        return step(x, skip)

    return run


def time_blend(gen, dev, log=print) -> dict:
    """Times at ``HEADLINE``, bf16 in and out, in turns (plain, unfused,
    first design, kernel, wrapper, then back): the kernel alone (``ms``),
    the first design alone (``wmma_ms``), the wrapper (``wrapper_ms``), the
    plain version (``plain_ms``) and the unfused PyTorch step
    (``unfused_ms``), each summed over the three shapes (``per_shape``
    keeps them apart); with the bound of the sum."""
    keys = ("plain_ms", "unfused_ms", "wmma_ms", "ms", "wrapper_ms")
    t = {k: 0.0 for k in keys}
    t["per_shape"], flops, nbytes = [], 0.0, 0
    for b, hh, ww in HEADLINE:
        a = blend_inputs(gen, dev, b, hh, ww)
        pack = blend.packed_blend(*(a[k] for k in ("conv_weight", "bn_scale", "bn_bias",
                                                   "bn_mean", "bn_var")))
        w_pack = {"w": blend.wmma_weights(a["conv_weight"]), "ab": pack["ab"]}
        out = torch.empty_like(a["skip"])
        calls = {"plain_ms": lambda: blend.upsample_blend_reference(**a),
                 "unfused_ms": unfused_step(a),
                 "wmma_ms": lambda: blend.launch("wmma", a["x"], a["skip"], w_pack, out=out),
                 "ms": lambda: blend.launch("mma", a["x"], a["skip"], pack, out=out),
                 "wrapper_ms": lambda: blend.fused_upsample_blend(**a)}
        times = {k: [] for k in keys}
        for k in keys + keys[::-1]:
            times[k].append(cuda_ms(calls[k], iters=20 if k in ("ms", "wmma_ms") else 10))
        one = {k: sum(v) / len(v) for k, v in times.items()}
        f, n = blend_work(b, hh, ww)
        one["bound_ms"] = bound(f, n)[0]
        flops, nbytes = flops + f, nbytes + n
        for k in keys:
            t[k] += one[k]
        t["per_shape"].append(one)
        log(f"  blend {(b, hh, ww, 128)}: kernel {one['ms']:.4f} ms ({f / one['ms'] / 1e9:.1f} "
            f"TFLOP/s, {one['ms'] / one['bound_ms']:.2f}x the bound); first design (wmma) "
            f"{one['wmma_ms']:.4f} ms ({one['wmma_ms'] / one['ms']:.2f}x); wrapper "
            f"{one['wrapper_ms']:.4f}; plain {one['plain_ms']:.4f}; unfused PyTorch step "
            f"{one['unfused_ms']:.4f}; bound {one['bound_ms']:.4f} ms ({f / 1e9:.1f} GFLOP, "
            f"{n / 1e6:.1f} MB)")
        del a, pack, w_pack, out, calls
    t["bound_ms"], t["bound_by"] = bound(flops, nbytes)
    t["tflops"] = flops / t["ms"] / 1e9
    t["mma_share"] = flops / (t["ms"] * 1e-3) / MMA_SYNC_BF16_FLOPS
    log(f"  blend, the three steps of a forward: kernel {t['ms']:.4f} ms ({t['tflops']:.1f} "
        f"TFLOP/s, {100 * t['mma_share']:.1f} % of the mma.sync rate, "
        f"{t['ms'] / t['bound_ms']:.2f}x the bound); first design (wmma) {t['wmma_ms']:.4f} ms "
        f"({t['wmma_ms'] / t['ms']:.2f}x slower); wrapper {t['wrapper_ms']:.4f}; plain "
        f"{t['plain_ms']:.4f}; unfused {t['unfused_ms']:.4f}; bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']})")
    torch.cuda.empty_cache()
    return t


def time_variants(gen, dev, log=print) -> dict:
    """Times, summed over ``HEADLINE``, of ``blend_mma.cu`` as built and with
    a piece of it replaced (``VARIANTS``). A variant that drops work gives
    wrong output: only the source as built and the 16 × 16 tile are
    checked."""
    inputs = []
    for b, hh, ww in HEADLINE:
        a = blend_inputs(gen, dev, b, hh, ww)
        pack = blend.packed_blend(*(a[k] for k in ("conv_weight", "bn_scale", "bn_bias",
                                                   "bn_mean", "bn_var")))
        inputs.append((a, pack, torch.empty_like(a["skip"])))
    source = (_build.CSRC / "blend_mma.cu").read_text()
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, edits) in enumerate({"as built": [], **VARIANTS}.items()):
            src = source
            for old, new in edits:
                if src.count(old) != 1:
                    raise RuntimeError(f"variant {name!r}: {old!r} is not once in the source")
                src = src.replace(old, new)
            fn = _compile(src, f"v{i}", Path(tmp)).dcss_upsample_blend_mma
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            times = []
            for a, pack, out in inputs:
                def call():
                    status = fn(a["x"].data_ptr(), a["skip"].data_ptr(), pack["w"].data_ptr(),
                                pack["ab"].data_ptr(), out.data_ptr(), *a["skip"].shape, 1,
                                stream)
                    if status != 0:
                        raise RuntimeError(f"variant {name!r}: CUDA error {status}")

                call()
                torch.cuda.synchronize()
                if name in CHECKED:
                    ref = blend.upsample_blend_reference(**a).float()
                    err = (out.float() - ref).abs().max().item()
                    if not err <= 1e-2 * ref.abs().max().item():
                        raise RuntimeError(f"blend_mma.cu variant {name!r} disagrees")
                times.append(cuda_ms(call, iters=20))
            res[name] = sum(times)
            log(f"  blend variant {name:24s} {', '.join(f'{x:.4f}' for x in times)} ms, "
                f"sum {res[name]:.4f} ms")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_blend: no CUDA device; this tool runs on the card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    for name, text in _build.build(["blend", "blend_mma"]).items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  ptxas[{name}]: {line.strip()}", flush=True)
    smem = _build.load("blend_mma").dcss_blend_mma_smem_bytes()
    print(f"  blend_mma: {smem} bytes of dynamic shared memory a block", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    log = lambda *a: print(*a, flush=True)  # noqa: E731
    err = check_kernel(gen, dev, log)
    ops = device_ops(gen, dev, log)
    t = time_blend(gen, dev, log)
    variants = time_variants(gen, dev, log)
    print(json.dumps({"card": card, "max_abs_err": err, "device_ops": ops, **t,
                      "variants_ms": variants}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
