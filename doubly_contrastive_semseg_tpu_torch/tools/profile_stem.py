"""The fused stem (K2) alone on the card: both routes against the plain
version, then per-level times.

    python3 -m doubly_contrastive_semseg_tpu_torch.tools.profile_stem

Builds only ``csrc/stem_pool.cu`` and ``csrc/stem_pool_tc.cu`` and prints
ptxas's register and spill report. Holds ``fused_stem_pool`` to
``stem_pool_reference`` at ``CHECK_SHAPES``: bf16 on the tensor-core route
within 2e-2 × max|ref| (bf16 rounding order: the kernel rounds once from
f32, the plain version after the conv, the scale and the shift), f32 on the
CUDA-core route within 1e-4 × max|ref| (TF32 off), each call counted on its
route; and the CUDA-core kernel on the same bf16 inputs (the previous
design) at 2e-2. Then times, at the three pyramid levels of a 2048×1024
batch of 8 in bf16, the tensor-core kernel, the CUDA-core kernel and the
plain version, with TFLOP/s and the ratio to the bound. ``chip_smoke.py``
phases 2 and 5 call ``check_routes`` and ``time_levels``; phase 16 calls
``check_routes`` at ``VAL_1080_SHAPES``, the shapes its eval pass gives K2.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from ..ops import _build, stem

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_TENSOR_FLOPS = 989e12

BATCH, HEIGHT, WIDTH = 8, 1024, 2048
CHECK_SHAPES = [(BATCH, HEIGHT, WIDTH), (BATCH, HEIGHT // 2, WIDTH // 2),
                (BATCH, HEIGHT // 4, WIDTH // 4),
                (BATCH, 270, 480),    # level 2 of 1920×1080: 135 conv rows → 68
                (2, 37, 53)]          # small, odd
# the three levels of a 1920×1080 eval batch of 8 and of 4 (the last batch
# of an ACDC val split of 12): 540 conv rows → 270, 270 → 135 (odd), 135 → 68
VAL_1080_SHAPES = [(BATCH, 1080, 1920), (BATCH, 540, 960), (BATCH, 270, 480),
                   (4, 1080, 1920), (4, 540, 960), (4, 270, 480)]
HEADLINE = 3                          # the first 3 shapes are the pyramid's levels


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``iters`` calls,
    enqueued behind a ~15 ms sleep kernel, so the events time the device and
    not the host's enqueueing (a level-2 stem kernel runs shorter than its
    wrapper's host work)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(30_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


CU_GRAPH_NODE_TYPE_KERNEL = 0


class _KernelNodeParams(ctypes.Structure):   # CUDA_KERNEL_NODE_PARAMS_v2
    _fields_ = [("func", ctypes.c_void_p), ("dims", ctypes.c_uint * 7),
                ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def captured_ops(fn) -> list:
    """The device operations that one call of ``fn`` enqueues, without a
    profiler: the call is captured in a CUDA graph, whose nodes are every
    operation it enqueued, and each node's type and, for a kernel, its
    (mangled) name are read through ``libcuda`` (``cuGraphGetNodes``,
    ``cuGraphNodeGetType``, ``cuGraphKernelNodeGetParams_v2``,
    ``cuFuncGetName``). ``fn`` must already have run once, so that nothing
    is built or loaded under capture. Returns [(node type, name or None)]
    (type 0: kernel); raises if a driver call fails."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")

    def call(name, *args):
        status = getattr(cu, name)(*args)
        if status != 0:
            raise RuntimeError(f"{name} failed with CUresult {status}")

    try:
        raw = ctypes.c_void_p(graph.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        call("cuGraphGetNodes", raw, None, ctypes.byref(n))
        nodes = (ctypes.c_void_p * n.value)()
        if n.value:
            call("cuGraphGetNodes", raw, nodes, ctypes.byref(n))
        ops = []
        for node in nodes:
            kind = ctypes.c_int(-1)
            call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
            name = None
            if kind.value == CU_GRAPH_NODE_TYPE_KERNEL:
                params = _KernelNodeParams()
                call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node),
                     ctypes.byref(params))
                text = ctypes.c_char_p()
                if params.func:
                    call("cuFuncGetName", ctypes.byref(text), ctypes.c_void_p(params.func))
                else:
                    call("cuKernelGetName", ctypes.byref(text), ctypes.c_void_p(params.kern))
                name = text.value.decode()
            ops.append((kind.value, name))
    finally:
        graph.reset()
    return ops


def stem_params(gen, dev):
    """A conv weight of the init's scale and a folded BN, on the card."""
    weight = (torch.randn(64, 3, 7, 7, generator=gen) * (2.0 / 147) ** 0.5).to(dev)
    scale = (torch.rand(64, generator=gen) + 0.5).to(dev)
    shift = (torch.randn(64, generator=gen) * 0.5).to(dev)
    return weight, scale, shift


def _err(got, ref, rel_tol):
    err = (got.float() - ref.float()).abs().max().item()
    return err, rel_tol * ref.float().abs().max().item()


def check_routes(gen, dev, log=print, shapes=CHECK_SHAPES) -> float:
    """Each route against ``stem_pool_reference`` at ``shapes``; raises
    on a disagreement or a call that took the wrong route. Returns the
    tensor-core route's max abs error over the first three shapes (a
    pyramid's levels)."""
    weight, scale, shift = stem_params(gen, dev)
    fn = stem.fused_stem_pool
    headline_err = 0.0
    for i, (b, h, w) in enumerate(shapes):
        x32 = torch.randn(b, h, w, 3, generator=gen).to(dev)
        cases = (("f32 CUDA cores", x32, 1e-4, fn, "cc_launches"),
                 ("bf16 tensor cores", x32.to(torch.bfloat16), 2e-2, fn, "tc_launches"),
                 ("bf16 CUDA cores (previous design)", x32.to(torch.bfloat16), 2e-2,
                  stem.stem_pool_cuda_cores, "cc_launches"))
        for name, x, rel_tol, call, route in cases:
            before = {k: getattr(fn, k) for k in ("tc_launches", "cc_launches")}
            got = call(x, weight, scale, shift)
            ref = stem.stem_pool_reference(x, weight, scale, shift)
            torch.cuda.synchronize()
            took = {k: getattr(fn, k) - v for k, v in before.items()}
            if took != {k: int(k == route) for k in took}:
                raise RuntimeError(f"stem {name} at {(b, h, w)} took the wrong route: {took}")
            if got.shape != ref.shape or got.dtype != x.dtype:
                raise RuntimeError(f"stem {name}: {tuple(got.shape)} {got.dtype} vs "
                                   f"{tuple(ref.shape)} {x.dtype}")
            err, bound = _err(got, ref, rel_tol)
            log(f"  stem {name:34s} {(b, h, w, 3)} -> {tuple(got.shape)}: max abs err "
                f"{err:.3e} (tolerance {bound:.3e} = {rel_tol} x max|ref|)")
            if not err <= bound:
                raise RuntimeError(f"stem {name} disagrees at {(b, h, w)}")
            if fn is call and x.dtype == torch.bfloat16 and i < HEADLINE:
                headline_err = max(headline_err, err)
    return headline_err


def time_levels(gen, dev, weight, scale, shift, log=print) -> dict:
    """Times of the three pyramid levels of a 2048×1024 batch of 8, bf16:
    the tensor-core kernel, the CUDA-core kernel on the same inputs, the
    plain version; the sums and the bound (bytes: input and output once;
    operations: 147 multiply-adds an output and channel, bf16 tensor
    cores)."""
    t = {"ms": 0.0, "cc_ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0, "levels": []}
    for lv in range(HEADLINE):
        b, h, w = CHECK_SHAPES[lv]
        x = torch.randn(b, h, w, 3, generator=gen).to(dev, torch.bfloat16)
        hp, wp = stem.stem_output_hw(h, w)
        hc, wc = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        nbytes = x.numel() * 2 + b * hp * wp * 64 * 2
        flops = 2.0 * b * hc * wc * 64 * 147
        bound = 1e3 * max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_TENSOR_FLOPS)
        # turns: plain, previous, new, new, previous, plain
        ms = {"tc": [], "cc": [], "plain": []}
        calls = {"tc": stem.stem_pool_tensor_cores, "cc": stem.stem_pool_cuda_cores,
                 "plain": stem.stem_pool_reference}
        for k in ("plain", "cc", "tc", "tc", "cc", "plain"):
            ms[k].append(cuda_ms(lambda: calls[k](x, weight, scale, shift)))
        lvl = {k: sum(v) / len(v) for k, v in ms.items()}
        log(f"  stem level {lv} {(b, h, w, 3)}: tensor cores {lvl['tc']:.4f} ms "
            f"({flops / lvl['tc'] / 1e9:.1f} TFLOP/s, {lvl['tc'] / bound:.2f}x the bound); "
            f"previous design (CUDA cores, same bf16 inputs) {lvl['cc']:.4f} ms "
            f"({flops / lvl['cc'] / 1e9:.1f} TFLOP/s); plain {lvl['plain']:.4f} ms; "
            f"bound {bound:.4f} ms ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
        t["ms"] += lvl["tc"]
        t["cc_ms"] += lvl["cc"]
        t["plain_ms"] += lvl["plain"]
        t["bytes"] += nbytes
        t["flops"] += flops
        t["levels"].append({"level": lv, "ms": lvl["tc"], "cc_ms": lvl["cc"],
                            "plain_ms": lvl["plain"], "bound_ms": bound})
    by_bytes = t["bytes"] / PEAK_BYTES_PER_S
    by_ops = t["flops"] / PEAK_BF16_TENSOR_FLOPS
    t["bound_ms"] = 1e3 * max(by_bytes, by_ops)
    t["bound_by"] = "bytes" if by_bytes > by_ops else "operations"
    log(f"  stem, the three levels: tensor cores {t['ms']:.4f} ms "
        f"({t['flops'] / t['ms'] / 1e9:.1f} TFLOP/s, {t['ms'] / t['bound_ms']:.2f}x the bound), "
        f"previous design {t['cc_ms']:.4f} ms ({t['cc_ms'] / t['ms']:.2f}x slower), plain "
        f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return t


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_stem: no CUDA device; this tool runs on the card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    for name, text in _build.build(["stem_pool", "stem_pool_tc"]).items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  ptxas[{name}]: {line.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    log = lambda *a: print(*a, flush=True)  # noqa: E731
    err = check_routes(gen, dev, log)
    t = time_levels(gen, dev, *stem_params(gen, dev), log=log)
    print(json.dumps({"card": card, "max_abs_err": err,
                      **{k: v for k, v in t.items() if k not in ("bytes", "flops")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
