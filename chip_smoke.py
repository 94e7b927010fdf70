#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``doubly_contrastive_semseg_tpu_torch/
csrc`` for sm_90a, holds each kernel against its plain PyTorch version on the
card, then serves SwiftNet-RN18 (full width: 3 pyramid levels, 128 decoder
features, 19 classes) at 2048×1024, batch 8, bf16 through ``build_model`` and
``make_serving_fn``, with weights and BN statistics drawn from a fixed seed.
It checks that the serving path launched each kernel, that its labels agree
with the plain path on the card and, on a small input, with the CPU path
(which the CPU tests hold against the JAX package), and times serving with
``bench.py``'s protocol. Any failure raises and exits non-zero; so does a
machine without CUDA or a directory without the package. The last line is
``{"ok": true, "device": {...}}``; the line before it lists each kernel's
launches, error and times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

BATCH, HEIGHT, WIDTH = 8, 1024, 2048


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def randomize_bn(model, gen) -> None:
    """Non-trivial BN affine and running statistics from ``gen``, so every
    BN fold is exercised; scales below 1 keep activations of order 1."""
    import torch

    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            with torch.no_grad():
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=gen) + 1.0)
                m.weight.copy_(torch.rand(c, generator=gen) * 0.3 + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)


def stem_phase(torch, stem, gen, dev):
    """K2 vs ``stem_pool_reference`` on the card, f32 (TF32 off) and bf16.
    Returns the bf16 max abs error over the headline levels."""
    shapes = [(BATCH, HEIGHT, WIDTH), (BATCH, HEIGHT // 2, WIDTH // 2),
              (BATCH, HEIGHT // 4, WIDTH // 4),
              (BATCH, 270, 480),    # level 2 of 1920×1080: 135 conv rows → 68
              (2, 37, 53)]          # small, odd
    weight = (torch.randn(64, 3, 7, 7, generator=gen) * (2.0 / 147) ** 0.5).to(dev)
    scale = (torch.rand(64, generator=gen) + 0.5).to(dev)
    shift = (torch.randn(64, generator=gen) * 0.5).to(dev)
    headline_err = 0.0
    for i, (b, h, w) in enumerate(shapes):
        x32 = torch.randn(b, h, w, 3, generator=gen).to(dev)
        for dtype, rel_tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            x = x32.to(dtype)
            got = stem.fused_stem_pool(x, weight, scale, shift)
            ref = stem.stem_pool_reference(x, weight, scale, shift)
            torch.cuda.synchronize()
            check(got.shape == ref.shape, f"stem shape {tuple(got.shape)} vs {tuple(ref.shape)}")
            err = (got.float() - ref.float()).abs().max().item()
            bound = rel_tol * ref.float().abs().max().item()
            log(f"  stem {str(dtype)[6:]:8s} {(b, h, w, 3)} -> {tuple(got.shape)}: "
                f"max abs err {err:.3e} (tolerance {bound:.3e} = {rel_tol} x max|ref|)")
            check(err <= bound, f"stem kernel disagrees at {(b, h, w)} {dtype}")
            if dtype == torch.bfloat16 and i < 3:
                headline_err = max(headline_err, err)
    return headline_err


def head_inputs(torch, gen, dev, b, h, w, c=19):
    return dict(feat=torch.randn(b, h, w, 128, generator=gen).to(dev),
                bn_scale=(torch.rand(128, generator=gen) + 0.5).to(dev),
                bn_bias=torch.randn(128, generator=gen).to(dev),
                bn_mean=torch.randn(128, generator=gen).to(dev),
                bn_var=(torch.rand(128, generator=gen) * 1.5 + 0.5).to(dev),
                conv_weight=torch.randn(c, 128, 1, 1, generator=gen).to(dev) * 0.1,
                conv_bias=torch.randn(c, generator=gen).to(dev))


def head_phase(torch, seghead, gen, dev):
    """K1 vs ``seghead_reference`` on the card. Returns the bf16 headline
    share of labels that differ (the kernel's output is a label, so this is
    its error)."""
    headline_dis = 0.0
    for b, h, w in [(BATCH, HEIGHT // 4, WIDTH // 4), (BATCH, 270, 480), (3, 13, 29)]:
        args = head_inputs(torch, gen, dev, b, h, w)
        for dtype, bar in ((torch.float32, 0.9999), (torch.bfloat16, 0.995)):
            a = dict(args, feat=args["feat"].to(dtype))
            got = seghead.fused_seghead_upsample_argmax(**a)
            ref = seghead.seghead_reference(**a)
            torch.cuda.synchronize()
            check(got.shape == (b, 4 * h, 4 * w) and got.dtype == torch.int8,
                  f"head output {tuple(got.shape)} {got.dtype}")
            agree = (got == ref).double().mean().item()
            log(f"  head {str(dtype)[6:]:8s} {(b, h, w, 128)} -> {tuple(got.shape)}: "
                f"label agreement {agree:.6f} (bar {bar})")
            check(agree >= bar, f"head kernel disagrees at {(b, h, w)} {dtype}")
            if dtype == torch.bfloat16 and h == HEIGHT // 4:
                headline_dis = 1.0 - agree
    # every logit negative: a class outside [0, C) must never win. At -1000
    # an f32 logit keeps only ~6e-5 of resolution, so near-ties flip more
    # often than at the shapes above: bar 0.999
    a = head_inputs(torch, gen, dev, 2, 16, 24)
    a["conv_bias"] = torch.full((19,), -1000.0, device=dev)
    got = seghead.fused_seghead_upsample_argmax(**a)
    ref = seghead.seghead_reference(**a)
    agree = (got == ref).double().mean().item()
    log(f"  head all-negative logits: max label {got.max().item()}, agreement {agree:.6f}")
    check(got.max().item() < 19 and got.min().item() >= 0 and agree >= 0.999,
          "head kernel with negative logits")
    return headline_dis


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    try:
        from doubly_contrastive_semseg_tpu_torch import Config, build_model, make_serving_fn
        from doubly_contrastive_semseg_tpu_torch.ops import _build, seghead, stem
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable here: {e}",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]

    # 1. card and build
    log(f"== 1. card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build_logs = _build.build(["stem_pool", "seghead"])
    log(f"  built csrc/stem_pool.cu and csrc/seghead.cu for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  ptxas[{name}]: {line.strip()}")
    gen = torch.Generator().manual_seed(0)

    # 2-3. each kernel against its plain version
    log("== 2. stem kernel (K2) vs stem_pool_reference")
    stem_err = stem_phase(torch, stem, gen, dev)
    log("== 3. head kernel (K1) vs seghead_reference")
    head_dis = head_phase(torch, seghead, gen, dev)

    # 4. the serving path at full width
    log(f"== 4. serving SwiftNet-RN18 {WIDTH}x{HEIGHT} batch {BATCH} bf16")
    model = build_model(Config(), device=dev, seed=0)
    randomize_bn(model, torch.Generator().manual_seed(1))
    model.to(dev)
    serve = make_serving_fn(model, device=dev)
    image = torch.randint(0, 256, (BATCH, HEIGHT, WIDTH, 3), generator=gen).to(
        device=dev, dtype=torch.bfloat16)
    stem.fused_stem_pool.launches = 0
    seghead.fused_seghead_upsample_argmax.launches = 0
    labels = serve(image)
    torch.cuda.synchronize()
    launches = {"fused_stem_pool": stem.fused_stem_pool.launches,
                "fused_seghead_upsample_argmax": seghead.fused_seghead_upsample_argmax.launches}
    log(f"  launches in one serve call: {launches}")
    check(launches == {"fused_stem_pool": 3, "fused_seghead_upsample_argmax": 1},
          "the serving path must launch the stem kernel 3 times and the head once")
    check(labels.shape == (BATCH, HEIGHT, WIDTH) and labels.dtype == torch.int8,
          f"labels {tuple(labels.shape)} {labels.dtype}")
    check(0 <= labels.min().item() and labels.max().item() < 19, "label range")

    # the same weights on the plain path, on the card
    plain = build_model(Config(fuse_stem=False), device=dev, seed=0)
    plain.load_state_dict(model.state_dict())
    head = plain.net.segmentation
    with torch.no_grad():
        feat_p = plain.forward_features(image)["fine_feat"]
        feat_k = model.forward_features(image)["fine_feat"]
        labels_p = seghead.seghead_reference(
            feat_p, head.norm.weight, head.norm.bias, head.norm.running_mean,
            head.norm.running_var, head.conv.weight, head.conv.bias)
    feat_dev = ((feat_k.float() - feat_p.float()).abs().max()
                / feat_p.float().abs().max()).item()
    agree = (labels == labels_p).float().mean().item()
    log(f"  fused vs plain path: features max deviation {feat_dev:.3e} of max|feat|, "
        f"label agreement {agree:.6f} (bar 0.99)")
    check(agree >= 0.99, "serving labels disagree with the plain path")
    del plain, feat_p, feat_k, labels_p

    # a small f32 input against the CPU path
    small = build_model(Config(compute_dtype="float32"), device=dev, seed=2)
    randomize_bn(small, torch.Generator().manual_seed(3))
    small.to(dev)
    cpu = build_model(Config(compute_dtype="float32"), device="cpu", seed=2)
    cpu.load_state_dict({k: v.cpu() for k, v in small.state_dict().items()})
    x_small = torch.randint(0, 256, (2, 128, 256, 3), generator=gen).float()
    lab_gpu = make_serving_fn(small, device=dev)(x_small.to(dev)).cpu()
    lab_cpu = make_serving_fn(cpu, device="cpu")(x_small)
    with torch.no_grad():
        seg_gpu = small(x_small.to(dev))["seg"].cpu()
        seg_cpu = cpu(x_small)["seg"]
    seg_err = (seg_gpu - seg_cpu).abs().max().item()
    agree_small = (lab_gpu == lab_cpu).float().mean().item()
    log(f"  small f32 input vs the CPU path: seg max abs err {seg_err:.3e} "
        f"(tolerance 1e-3), label agreement {agree_small:.6f} (bar 0.999)")
    check(torch.isfinite(seg_gpu).all().item() and seg_err <= 1e-3 and agree_small >= 0.999,
          "the card's forward disagrees with the CPU path")
    del small, cpu

    # bench.py's protocol: warm-up, then K in-order dispatches and one fence
    torch.backends.cudnn.benchmark = True
    for _ in range(3):
        serve(image)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters, windows = 20, []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = serve(image)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / iters)
    t0 = time.perf_counter()
    serve(image)
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    fps = [BATCH / t for t in windows]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del out
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], check=True, capture_output=True, text=True).stdout.strip()
    log(f"  serving: {BATCH * len(windows) / sum(windows):.2f} frames/s "
        f"(windows {', '.join(f'{f:.2f}' for f in fps)}), "
        f"{1000 * sum(windows) / len(windows):.2f} ms per batch; "
        f"single-batch latency {1000 * latency:.2f} ms; "
        f"peak memory {peak_gb:.2f} GB; sm clock, power, temp after: {clocks}")

    # 5. kernel times at the headline shapes, beside the plain versions
    log("== 5. kernel times (bf16, headline shapes)")
    kernels = []
    st = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0}
    w_stem = model.net.feature_extractor.conv1.weight
    for lv in range(3):
        h, w = HEIGHT >> lv, WIDTH >> lv
        x = torch.randn(BATCH, h, w, 3, generator=gen).to(dev, torch.bfloat16)
        sc, sh = model.net.feature_extractor.bn1_0.folded()
        k_ms = cuda_ms(lambda: stem.fused_stem_pool(x, w_stem, sc, sh))
        p_ms = cuda_ms(lambda: stem.stem_pool_reference(x, w_stem, sc, sh))
        hp, wp = stem.stem_output_hw(h, w)
        hc, wc = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        nbytes = x.numel() * 2 + BATCH * hp * wp * 64 * 2
        flops = 2.0 * BATCH * hc * wc * 64 * 147
        log(f"  stem level {lv} {(BATCH, h, w, 3)}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"bound {1e3 * max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_TENSOR_FLOPS):.4f} ms "
            f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
        st["ms"] += k_ms
        st["plain_ms"] += p_ms
        st["bytes"] += nbytes
        st["flops"] += flops
    stem_bound = 1e3 * max(st["bytes"] / PEAK_BYTES_PER_S, st["flops"] / PEAK_BF16_TENSOR_FLOPS)
    kernels.append({
        "name": "fused_stem_pool", "route": "cuda",
        "source": "doubly_contrastive_semseg_tpu_torch/csrc/stem_pool.cu",
        "replaces": "doubly_contrastive_semseg_tpu/ops/stem_pallas.py:123",
        "launches": launches["fused_stem_pool"], "max_abs_err": stem_err,
        "ms": st["ms"], "plain_ms": st["plain_ms"], "bound_ms": stem_bound,
        "bound_by": "bytes" if st["bytes"] / PEAK_BYTES_PER_S
        > st["flops"] / PEAK_BF16_TENSOR_FLOPS else "operations",
        "library_ms": None})

    a = head_inputs(torch, gen, dev, BATCH, HEIGHT // 4, WIDTH // 4)
    a["feat"] = a["feat"].to(torch.bfloat16)
    k_ms = cuda_ms(lambda: seghead.fused_seghead_upsample_argmax(**a))
    p_ms = cuda_ms(lambda: seghead.seghead_reference(**a))
    n_pix = BATCH * (HEIGHT // 4) * (WIDTH // 4)
    nbytes = n_pix * 128 * 2 + BATCH * HEIGHT * WIDTH
    # bf16 contraction on tensor cores + f32 bilinear blend (6 flops a class
    # and output pixel) on CUDA cores
    ops_s = (2.0 * n_pix * 128 * 19 / PEAK_BF16_TENSOR_FLOPS
             + 6.0 * BATCH * HEIGHT * WIDTH * 19 / PEAK_F32_FLOPS)
    head_bound = 1e3 * max(nbytes / PEAK_BYTES_PER_S, ops_s)
    log(f"  head {(BATCH, HEIGHT // 4, WIDTH // 4, 128)}: kernel {k_ms:.3f} ms, "
        f"plain {p_ms:.3f} ms, bound {head_bound:.4f} ms ({nbytes / 1e6:.1f} MB)")
    kernels.append({
        "name": "fused_seghead_upsample_argmax", "route": "cuda",
        "source": "doubly_contrastive_semseg_tpu_torch/csrc/seghead.cu",
        "replaces": "doubly_contrastive_semseg_tpu/ops/seghead_pallas.py:164",
        "launches": launches["fused_seghead_upsample_argmax"],
        "max_abs_err": head_dis, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": head_bound,
        "bound_by": "bytes" if nbytes / PEAK_BYTES_PER_S > ops_s else "operations",
        "library_ms": None})

    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
