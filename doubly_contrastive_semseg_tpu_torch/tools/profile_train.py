"""Where the training-step time goes, on the card.

    python3 -m doubly_contrastive_semseg_tpu_torch.tools.profile_train

Runs the doubly-contrastive train step (``supcon_pixelcontrast_focal``,
SwiftNet-RN18, bf16, gradient checkpointing, seeded random weights and
batch) in two configurations: the flagship, 768² crops at batch 8 with two
views, and the dense-contrast step, 96² crops at batch 216, whose pixel
contrast (8208 rows) runs through the contrastive kernels. For each it
prints, per step:

- a split from CUDA events between the model's forward, the losses, the
  backward (with the checkpointed blocks' recompute) and the optimizer;
- from ``torch.profiler``: device time by kernel, and the device's busy and
  idle shares of a window of steps;
- the wall time of an unprofiled window of as many steps just before it,
  and the idle share that the profiled busy time leaves in it (inferred:
  the profiler slows the host, not the kernels).

The split runs the step's parts one by one, apart from the timed window.
"""

from __future__ import annotations

import subprocess
import time

import torch

from .. import Config, build_model
from ..losses import compute_total_loss
from ..train import TrainState, build_optimizer, ingest_batch, make_train_step, set_lr

CRITERION = "supcon_pixelcontrast_focal"
CONFIGS = (("flagship", 8, 768), ("dense-contrast", 216, 96))
ITERS = 5
# kernel names of csrc/row_stats.cu (K3) and csrc/pos_sweep.cu (K4)
CONTRASTIVE_KERNELS = ("tile_kernel", "reduce_a_kernel", "reduce_b_kernel", "layout_kernel",
                       "pos_sweep_kernel")


def make_batch(b: int, crop: int, gen: torch.Generator, device="cuda",
               n_classes: int = 19):
    """A two-view batch as the loader gives it, drawn from ``gen``: uint8
    images (2b, crop, crop, 3), int32 labels with an ignore block, EDT
    weights 0 at ignore pixels, weather ids and class weights."""
    label = torch.randint(0, n_classes, (b, crop, crop), generator=gen, dtype=torch.int32)
    label[:, : crop // 8, : crop // 8] = 255
    alphas = torch.rand(b, crop, crop, generator=gen) * 0.95 + 0.05
    alphas[label == 255] = 0.0
    batch = {"left": torch.randint(0, 256, (2 * b, crop, crop, 3), generator=gen,
                                   dtype=torch.uint8),
             "label": label, "label_distance_weight": alphas,
             "weather": torch.randint(0, 4, (b,), generator=gen, dtype=torch.int32),
             "class_weight": torch.rand(n_classes, generator=gen) * 1.5 + 0.5}
    return {k: v.to(device) for k, v in batch.items()}


def step_split(model, cfg, opt, batch, anchors, iters: int):
    """Mean ms per step of forward, losses, backward and optimizer."""
    names = ("forward", "losses", "backward", "optimizer")
    totals = dict.fromkeys(names, 0.0)
    for i in range(iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        model.train()
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        b = ingest_batch(batch)
        out = model(b["left"], return_supcon_feature=True)
        ev[1].record()
        total, _ = compute_total_loss(cfg, out, b, b["class_weight"], anchors)
        ev[2].record()
        total.backward()
        ev[3].record()
        set_lr(opt, cfg, i)
        opt.step()
        ev[4].record()
        torch.cuda.synchronize()
        for k, name in enumerate(names):
            totals[name] += ev[k].elapsed_time(ev[k + 1])
    return {k: v / iters for k, v in totals.items()}


def profile(name: str, b: int, crop: int) -> None:
    cfg = Config(criterion=CRITERION, dataset="acdc")
    model = build_model(cfg, device="cuda", seed=0)
    opt = build_optimizer(model, cfg, steps_per_epoch=200)
    state = TrainState(model, opt)
    train_step = make_train_step(model, cfg, opt)
    batch = make_batch(b, crop, torch.Generator().manual_seed(0))
    anchors = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(3):
        train_step(state, batch, anchors)
    torch.cuda.synchronize()

    split = step_split(model, cfg, opt, batch, anchors, ITERS)
    total = sum(split.values())
    print(f"== {name}: {crop}x{crop}, batch {b} x 2 views, bf16, efficient, {CRITERION}")
    print("split, ms per step (CUDA events between the parts):")
    for k, v in split.items():
        print(f"  {k:10s} {v:8.3f} ms  {100 * v / total:5.1f} %")
    print(f"  {'total':10s} {total:8.3f} ms")

    def window_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            train_step(state, batch, anchors)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    plain_wall_ms = window_ms()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_ms = window_ms()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels) // ITERS
    print(f"profiler: {ITERS} steps in {wall_ms:.2f} ms wall; device busy {busy_ms:.2f} ms "
          f"= {100 * busy_ms / wall_ms:.1f} %, idle {100 * (1 - busy_ms / wall_ms):.1f} %; "
          f"{launches} kernel launches a step")
    # the profiler slows the host, not the kernels: the same busy time over
    # the unprofiled window just before it estimates the idle share without it
    print(f"unprofiled: {ITERS} steps in {plain_wall_ms:.2f} ms wall "
          f"({plain_wall_ms / ITERS:.2f} ms a step); with the profiled window's busy time, "
          f"idle {100 * (1 - busy_ms / plain_wall_ms):.1f} % (inferred)")
    print("device time by kernel, ms per step:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"  {e.self_device_time_total / 1e3 / ITERS:8.3f} ms "
              f"x{e.count // ITERS:<5d} {e.key[:110]}")
    ours = [e for e in kernels
            if any(f"::{k}{c}" in e.key for k in CONTRASTIVE_KERNELS for c in "<(")]
    if ours:
        print("the contrastive kernels (K3: tile_kernel, reduce_a/b_kernel; K4: "
              "layout_kernel, pos_sweep_kernel), ms per step:")
        for e in ours:
            print(f"  {e.self_device_time_total / 1e3 / ITERS:8.3f} ms "
                  f"x{e.count // ITERS:<5d} {e.key[:110]}")
    del model, opt, state, train_step, batch
    torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device; this tool measures the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    torch.backends.cudnn.benchmark = True
    for name, b, crop in CONFIGS:
        profile(name, b, crop)


if __name__ == "__main__":
    main()
