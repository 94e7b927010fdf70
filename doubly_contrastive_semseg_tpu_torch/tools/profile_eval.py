"""Where the eval time goes, on the card.

    python3 -m doubly_contrastive_semseg_tpu_torch.tools.profile_eval

Runs ``make_eval_step`` on SwiftNet-RN18 at 2048×1024, batch 8, bf16
(seeded random weights, random labels and weather ids), once with the fused
upsample-blend kernel on the decoder and once without, and prints for each:

- the stage split of ``tools/profile_serving.py`` (CUDA events at stage
  borders); here "head" is everything after the decoder: the seg head, the
  full-resolution logits, the argmax and the confusion matrices;
- from ``torch.profiler``: device time by kernel, and the device's busy
  and idle shares of the window.
"""

from __future__ import annotations

import subprocess
import time

import torch

from .. import Config, build_model
from ..train import init_eval_accum, make_eval_step
from .profile_serving import stage_split

BATCH, HEIGHT, WIDTH = 8, 1024, 2048
ITERS = 10


def set_fused(model, fused: bool) -> None:
    """Sets ``fuse_inference`` on every ``UpsampleBlend`` of the decoder."""
    fe = model.net.feature_extractor
    for i in range(1, fe.num_skip_levels):
        getattr(fe, f"upsample_blends{i}").fuse_inference = fused


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    torch.backends.cudnn.benchmark = True
    cfg = Config()
    model = build_model(cfg, device="cuda", seed=0)
    step = make_eval_step(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"left": torch.randint(0, 256, (BATCH, HEIGHT, WIDTH, 3), generator=gen,
                                   device="cuda", dtype=torch.uint8),
             "label": torch.randint(0, 19, (BATCH, HEIGHT, WIDTH), generator=gen,
                                    device="cuda", dtype=torch.uint8),
             "weather": torch.randint(0, 4, (BATCH,), generator=gen, device="cuda")}
    accum = init_eval_accum(cfg, device="cuda")

    def run(image):
        return step(dict(batch, left=image), accum)

    for fused in (True, False):
        set_fused(model, fused)
        for _ in range(3):
            run(batch["left"])
        torch.cuda.synchronize()
        name = "fused" if fused else "unfused"
        split = stage_split(model, run, batch["left"], ITERS)
        total = sum(split.values())
        print(f"{name}: stage split, ms per eval batch of {BATCH} ({WIDTH}x{HEIGHT}, bf16; "
              f"CUDA events at stage borders):")
        for k, v in split.items():
            print(f"  {k:18s} {v:8.3f} ms  {100 * v / total:5.1f} %")
        print(f"  {'total':18s} {total:8.3f} ms")

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                run(batch["left"])
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"{name}: profiler: {ITERS} batches in {wall_ms:.2f} ms wall; device busy "
              f"{busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f} %, idle "
              f"{100 * (1 - busy_ms / wall_ms):.1f} %")
        print(f"{name}: device time by kernel, ms per batch:")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
            print(f"  {e.self_device_time_total / 1e3 / ITERS:8.3f} ms "
                  f"x{e.count // ITERS:<4d} {e.key[:110]}")


if __name__ == "__main__":
    main()
