"""The fused serving head (K1) alone on the card: both routes against the
plain version, times at the headline shape, and ablations of the
tensor-core source.

    python3 -m doubly_contrastive_semseg_tpu_torch.tools.profile_seghead

Builds only ``csrc/seghead.cu`` and ``csrc/seghead_tc.cu`` and prints
ptxas's register and spill report. Holds ``fused_seghead_upsample_argmax``
to ``seghead_reference`` at ``CHECK_SHAPES`` by label agreement: f32 on the
CUDA-core route at 0.9999, bf16 on the tensor-core route at 0.995 (the
kernel sums in another order than the plain version, and bf16 activations
leave near-ties that the order flips), the CUDA-core kernel on the same
bf16 inputs (the previous design) at 0.995, and all-negative logits (a
padded class must never win) on both routes at 0.999; each call counted on
its route. Then times, at the serving batch's shape (bf16 features (8, 256,
512, 128), 19 classes), with ``profile_stem.cuda_ms`` (launches enqueued
behind a sleep kernel, so the device is timed and not the host): the
tensor-core kernel alone, the CUDA-core kernel on the same inputs, the whole
wrapper, the plain version, and the unfused PyTorch head (BN → ReLU → cuDNN
1×1 → ``F.interpolate`` ×4 → argmax, the chain of the serving branch for
other sizes); then variants of the tensor-core source with a piece of its
text replaced: the copies alone (the staging's floor), without the 1×1,
without the upsample-argmax, and without the copies (the arithmetic
alone). ``chip_smoke.py`` phases 3 and 5 call ``check_routes`` and
``time_head``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..models.blocks import BNReluConv
from ..ops import _build, seghead
from ..ops.input_pipeline import upsample4x_argmax
from .profile_stem import cuda_ms
from .stem_variants import _compile

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

HEADLINE = (8, 256, 512)               # the features of a 2048×1024 serving batch of 8
CHECK_SHAPES = [HEADLINE,
                (8, 270, 480),         # 1920×1080 features: a ragged run and strip
                (3, 13, 29),           # small, odd
                (2, 45, 97)]           # a run of 13 rows, a strip of 33 columns
BARS = {torch.float32: 0.9999, torch.bfloat16: 0.995}
COUNTERS = ("tc_launches", "cc_launches")

_PRODUCTS = ("    products<NT>(stage", "    if (false) products<NT>(stage")
_ARGMAX = ("    if (q > 0)\n      upsample_argmax(", "    if (false)\n      upsample_argmax(")
_COPIES = ('  asm volatile("cp.async.cg', '  if (false) asm volatile("cp.async.cg')
VARIANTS = {"copies only": [_PRODUCTS, _ARGMAX], "no 1x1": [_PRODUCTS],
            "no upsample-argmax": [_ARGMAX], "no copies": [_COPIES]}


def head_inputs(gen, dev, b, h, w, c=19):
    """f32 features and a random eval BN and 1×1 conv, on the card."""
    return dict(feat=torch.randn(b, h, w, 128, generator=gen).to(dev),
                bn_scale=(torch.rand(128, generator=gen) + 0.5).to(dev),
                bn_bias=torch.randn(128, generator=gen).to(dev),
                bn_mean=torch.randn(128, generator=gen).to(dev),
                bn_var=(torch.rand(128, generator=gen) * 1.5 + 0.5).to(dev),
                conv_weight=torch.randn(c, 128, 1, 1, generator=gen).to(dev) * 0.1,
                conv_bias=torch.randn(c, generator=gen).to(dev))


def _agreement(call, a, route, what, log):
    """Runs ``call(**a)``, checks it took ``route`` and returns (labels,
    agreement with ``seghead_reference``)."""
    fn = seghead.fused_seghead_upsample_argmax
    before = {k: getattr(fn, k) for k in COUNTERS}
    got = call(**a)
    ref = seghead.seghead_reference(**a)
    torch.cuda.synchronize()
    took = {k: getattr(fn, k) - v for k, v in before.items()}
    if took != {k: int(k == route) for k in COUNTERS}:
        raise RuntimeError(f"head {what} took the wrong route: {took}")
    b, h, w, _ = a["feat"].shape
    if got.shape != (b, 4 * h, 4 * w) or got.dtype != torch.int8:
        raise RuntimeError(f"head {what}: output {tuple(got.shape)} {got.dtype}")
    return got, (got == ref).double().mean().item()


def check_routes(gen, dev, log=print, shapes=CHECK_SHAPES) -> float:
    """Each route against ``seghead_reference`` at ``shapes`` and with
    all-negative logits; raises on a disagreement or a call that took the
    wrong route. Returns the tensor-core route's share of labels that differ
    at the headline shape (the kernel's output is a label, so this is its
    error)."""
    fn = seghead.fused_seghead_upsample_argmax
    headline_dis = 0.0
    for b, h, w in shapes:
        args = head_inputs(gen, dev, b, h, w)
        cases = (("f32 CUDA cores", torch.float32, fn, "cc_launches"),
                 ("bf16 tensor cores", torch.bfloat16, fn, "tc_launches"),
                 ("bf16 CUDA cores (previous design)", torch.bfloat16,
                  seghead.seghead_cuda_cores, "cc_launches"))
        for what, dtype, call, route in cases:
            a = dict(args, feat=args["feat"].to(dtype))
            _, agree = _agreement(call, a, route, what, log)
            log(f"  head {what:34s} {(b, h, w, 128)}: label agreement {agree:.6f} "
                f"(bar {BARS[dtype]})")
            if not agree >= BARS[dtype]:
                raise RuntimeError(f"head {what} disagrees at {(b, h, w)}")
            if route == "tc_launches" and (b, h, w) == HEADLINE:
                headline_dis = 1.0 - agree
    # every logit negative: a class outside [0, C) must never win. At -1000
    # an f32 logit keeps only ~6e-5 of resolution, so near-ties flip more
    # often than at the shapes above: bar 0.999
    a = head_inputs(gen, dev, 2, 16, 24)
    a["conv_bias"] = torch.full((19,), -1000.0, device=dev)
    for what, dtype, route in (("f32 CUDA cores", torch.float32, "cc_launches"),
                               ("bf16 tensor cores", torch.bfloat16, "tc_launches")):
        got, agree = _agreement(fn, dict(a, feat=a["feat"].to(dtype)), route, what, log)
        log(f"  head {what} all-negative logits: labels in [{got.min().item()}, "
            f"{got.max().item()}], agreement {agree:.6f} (bar 0.999)")
        if not (0 <= got.min().item() and got.max().item() < 19 and agree >= 0.999):
            raise RuntimeError(f"head {what} with negative logits")
    return headline_dis


def unfused_head(a):
    """The unfused PyTorch head on ``a``'s features: the port's ``BNReluConv``
    (eval BN as ``addcmul``, ReLU, cuDNN 1×1 in the features' dtype) on the
    channels-last NCHW view, f32 logits, ``F.interpolate`` ×4 and argmax, as
    the serving branch for sizes the fused head does not take runs them."""
    c = a["conv_bias"].shape[0]
    seg = BNReluConv(128, c, k=1, bias=True).to(a["feat"].device).eval()
    with torch.no_grad():
        for p, k in ((seg.norm.weight, "bn_scale"), (seg.norm.bias, "bn_bias"),
                     (seg.norm.running_mean, "bn_mean"), (seg.norm.running_var, "bn_var"),
                     (seg.conv.weight, "conv_weight"), (seg.conv.bias, "conv_bias")):
            p.copy_(a[k].reshape(p.shape))
    x = a["feat"].permute(0, 3, 1, 2)

    @torch.no_grad()
    def run():
        return upsample4x_argmax(seg(x).permute(0, 2, 3, 1).float()).to(torch.int8)

    return run


def head_bound(b, h, w, c=19):
    """(bound ms, bound_by, bytes): bf16 features read once and int8 labels
    written once; the bf16 1×1 on tensor cores and the f32 bilinear (6
    operations a class and output pixel) on CUDA cores."""
    n_pix = b * h * w
    nbytes = n_pix * 128 * 2 + 16 * n_pix
    ops_s = (2.0 * n_pix * 128 * c / PEAK_BF16_TENSOR_FLOPS
             + 6.0 * 16 * n_pix * c / PEAK_F32_FLOPS)
    by_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(by_bytes, ops_s), "bytes" if by_bytes > ops_s else "operations", nbytes


def time_head(gen, dev, log=print) -> dict:
    """Times at ``HEADLINE``, bf16, in turns (plain, unfused, CUDA cores,
    tensor cores, wrapper, then back): the tensor-core kernel alone
    (``ms``), the CUDA-core kernel alone on the same inputs (``cc_ms``), the
    wrapper (``wrapper_ms``: the pack cache's lookup and the launch), the
    plain version (``plain_ms``) and the unfused PyTorch head
    (``unfused_ms``); with the bound."""
    b, h, w = HEADLINE
    a = head_inputs(gen, dev, b, h, w)
    a["feat"] = a["feat"].to(torch.bfloat16)
    params = {k: v for k, v in a.items() if k != "feat"}
    pack = seghead.packed_head(*params.values())
    out = torch.empty((b, 4 * h, 4 * w), dtype=torch.int8, device=dev)
    unfused = unfused_head(a)
    calls = {"plain_ms": lambda: seghead.seghead_reference(**a),
             "unfused_ms": unfused,
             "cc_ms": lambda: seghead.launch("cc", a["feat"], pack, 19, out),
             "ms": lambda: seghead.launch("tc", a["feat"], pack, 19, out),
             "wrapper_ms": lambda: seghead.fused_seghead_upsample_argmax(**a)}
    times = {k: [] for k in calls}
    for k in list(calls) + list(calls)[::-1]:
        times[k].append(cuda_ms(calls[k], iters=20 if k in ("ms", "wrapper_ms") else 10))
    t = {k: sum(v) / len(v) for k, v in times.items()}
    t["bound_ms"], t["bound_by"], nbytes = head_bound(b, h, w)
    agree = (unfused() == seghead.seghead_reference(**a)).double().mean().item()
    log(f"  head {(b, h, w, 128)} bf16: tensor cores {t['ms']:.4f} ms "
        f"({nbytes / t['ms'] / 1e9:.2f} TB/s, {t['ms'] / t['bound_ms']:.2f}x the bound); "
        f"previous design (CUDA cores, same inputs) {t['cc_ms']:.4f} ms "
        f"({t['cc_ms'] / t['ms']:.2f}x slower); wrapper {t['wrapper_ms']:.4f} ms; plain "
        f"{t['plain_ms']:.4f} ms; unfused PyTorch head (BN, ReLU, cuDNN 1x1, interpolate, "
        f"argmax) {t['unfused_ms']:.4f} ms (labels agree with the plain version on "
        f"{agree:.6f}); bound {t['bound_ms']:.4f} ms ({t['bound_by']}, {nbytes / 1e6:.1f} MB)")
    return t


def time_variants(gen, dev, log=print) -> dict:
    """Times of the tensor-core source as built and with a piece of it
    replaced (``VARIANTS``), at ``HEADLINE``, bf16. A variant that drops
    work gives wrong labels; only the unchanged source is checked."""
    b, h, w = HEADLINE
    a = head_inputs(gen, dev, b, h, w)
    a["feat"] = a["feat"].to(torch.bfloat16)
    pack = seghead.packed_head(*(v for k, v in a.items() if k != "feat"))
    ref = seghead.seghead_reference(**a)
    source = (_build.CSRC / "seghead_tc.cu").read_text()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(ref)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, edits) in enumerate({"as built": [], **VARIANTS}.items()):
            src = source
            for old, new in edits:
                if old not in src:
                    raise RuntimeError(f"variant {name!r}: {old!r} is not in the source")
                src = src.replace(old, new)
            fn = _compile(src, f"v{i}", Path(tmp)).dcss_seghead_tc
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

            def call():
                status = fn(a["feat"].data_ptr(), pack["wfrag"].data_ptr(), pack["ab"].data_ptr(),
                            pack["bias"].data_ptr(), out.data_ptr(), b, h, w, 19, stream)
                if status != 0:
                    raise RuntimeError(f"variant {name!r}: CUDA error {status}")

            call()
            torch.cuda.synchronize()
            if not edits and (out == ref).double().mean().item() < BARS[torch.bfloat16]:
                raise RuntimeError("the tensor-core source as built disagrees")
            res[name] = cuda_ms(call, iters=20)
            log(f"  head variant {name:20s} {res[name]:.4f} ms")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_seghead: no CUDA device; this tool runs on the card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    for name, text in _build.build(["seghead", "seghead_tc"]).items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  ptxas[{name}]: {line.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    log = lambda *a: print(*a, flush=True)  # noqa: E731
    dis = check_routes(gen, dev, log)
    t = time_head(gen, dev, log)
    variants = time_variants(gen, dev, log)
    print(json.dumps({"card": card, "headline_label_disagreement": dis, **t,
                      "variants_ms": variants}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
