"""Where the serving time goes, on the card.

    python3 -m doubly_contrastive_semseg_tpu_torch.tools.profile_serving

Serves SwiftNet-RN18 at 2048×1024, batch 8, bf16 (seeded random weights)
and prints, per batch:

- a stage split from CUDA events recorded by forward hooks: pyramid + level-0
  stem, the level-1 and level-2 stems, the trunk (``layer1..4`` and the 1×1
  skip bottlenecks, all levels), the decoder (``upsample_blends1..5``), and
  the head (weather classifier + fused serving head);
- from ``torch.profiler``: device time by kernel, and the device's busy and
  idle shares of the serving window;
- whether the decoder features reach the fused head as a view (no copy);
- frames/s over 3 unprofiled windows of ``ITERS`` in-order batches, each
  closed by one synchronise (``bench.py``'s protocol).

Hooks cost host time, so the stage split runs apart from the timed window.
"""

from __future__ import annotations

import subprocess
import time
from collections import defaultdict

import torch

from .. import Config, build_model, make_serving_fn

BATCH, HEIGHT, WIDTH = 8, 1024, 2048
ITERS = 10


def stage_split(model, serve, image, iters: int):
    """Mean ms per batch of each stage, from CUDA events at stage borders."""
    fe = model.net.feature_extractor
    marks = []

    def mark(name):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
        return hook

    handles = [fe.layer1.register_forward_pre_hook(mark("trunk_start")),
               fe.upsample_bottlenecks4.register_forward_hook(mark("trunk_end")),
               fe.upsample_blends1.register_forward_pre_hook(mark("decoder_start")),
               getattr(fe, f"upsample_blends{fe.num_skip_levels - 1}")
               .register_forward_hook(mark("decoder_end"))]
    totals = defaultdict(float)
    try:
        for _ in range(iters):
            marks.clear()
            mark("start")()
            serve(image)
            mark("end")()
            torch.cuda.synchronize()
            t = {}
            prev = marks[0][1]
            level = 0
            for name, ev in marks[1:]:
                ms = prev.elapsed_time(ev)
                if name == "trunk_start":
                    key = "pyramid + stem L0" if level == 0 else f"stem L{level}"
                elif name == "trunk_end":
                    key, level = "trunk", level + 1
                elif name == "decoder_end":
                    key = "decoder"
                elif name == "end":
                    key = "head"
                else:  # decoder_start: the skip sums before the first blend
                    key = "decoder"
                t[key] = t.get(key, 0.0) + ms
                prev = ev
            for k, v in t.items():
                totals[k] += v
    finally:
        for h in handles:
            h.remove()
    return {k: v / iters for k, v in totals.items()}


def frames_per_s(run, image, batch: int, iters: int = ITERS, windows: int = 3):
    """Frames/s of each of ``windows`` unprofiled windows of ``iters``
    in-order calls of ``run(image)``, each window closed by a synchronise."""
    fps = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            run(image)
        torch.cuda.synchronize()
        fps.append(batch * iters / (time.perf_counter() - t0))
    return fps


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    torch.backends.cudnn.benchmark = True
    model = build_model(Config(), device="cuda", seed=0)
    serve = make_serving_fn(model, device="cuda")
    gen = torch.Generator().manual_seed(0)
    image = torch.randint(0, 256, (BATCH, HEIGHT, WIDTH, 3),
                          generator=gen).to("cuda", torch.bfloat16)
    for _ in range(3):
        serve(image)
    torch.cuda.synchronize()
    # serve() hands K1 feat.permute(0, 2, 3, 1).contiguous(): a view of the
    # channels-last features, or a copy kernel before K1 if they are not
    views = []
    hook = model.net.feature_extractor.register_forward_hook(
        lambda _m, _i, out: views.append(out[0].permute(0, 2, 3, 1).is_contiguous()))
    serve(image)
    hook.remove()
    print("decoder features to the fused head: "
          + ("an NHWC view, no copy" if all(views) else "copied to NHWC before K1"))

    fps = frames_per_s(serve, image, BATCH)
    print(f"serving: {sum(fps) / len(fps):.2f} frames/s (windows of {ITERS} batches: "
          f"{', '.join(f'{f:.2f}' for f in fps)})")
    split = stage_split(model, serve, image, ITERS)
    total = sum(split.values())
    print(f"stage split, ms per batch of {BATCH} "
          f"({WIDTH}x{HEIGHT}, bf16; CUDA events at stage borders):")
    for k, v in split.items():
        print(f"  {k:18s} {v:8.3f} ms  {100 * v / total:5.1f} %")
    print(f"  {'total':18s} {total:8.3f} ms")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            serve(image)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profiler: {ITERS} batches in {wall_ms:.2f} ms wall; device busy "
          f"{busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f} %, idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f} %")
    print("device time by kernel, ms per batch:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"  {e.self_device_time_total / 1e3 / ITERS:8.3f} ms "
              f"x{e.count // ITERS:<4d} {e.key[:110]}")


if __name__ == "__main__":
    main()
