#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``doubly_contrastive_semseg_tpu_torch/
csrc`` for sm_90a, holds each kernel against its plain PyTorch version on the
card (the stem and the seg head each on both routes, bf16 tensor cores and
f32 CUDA cores, through ``tools/profile_stem.py`` and
``tools/profile_seghead.py``, which also time them in phase 5 beside the
CUDA-core kernels on the same bf16 inputs), then serves SwiftNet-RN18 (full
width: 3 pyramid levels, 128 decoder features, 19 classes) at 2048×1024,
batch 8, bf16 through ``build_model`` and ``make_serving_fn``, with weights
and BN statistics drawn from a fixed seed. It checks that the serving path
launched each kernel (the stem 3 times and the head once, each on its
tensor-core route), that its
labels agree with the plain path on the card and, on a small input, with
the CPU path (which the CPU tests hold against the JAX package), serves two
sizes the fused head does not (1022×2046 bf16: no K1 launch; 254×510 f32
against the CPU path), and times serving with ``bench.py``'s protocol.

Then training: the contrastive kernels (K3 row stats, two passes on
split-TF32 tensor cores; K4 positive sweep over the label-sorted rows'
same-label columns, on the same products) against their plain versions
(K4 also against its plain emulation, on the dense step's anchor grid and
with one label, its layout kernel against a stable ``torch.sort``), their
bitwise repeat, K4's three launches of its own kernels and no host sync a
call, and their times beside the first ports they replaced, which each
must beat, through ``tools/profile_contrastive.py``, and the public losses'
values and gradients against autograd of the dense losses (phase 6); the flagship
doubly-contrastive train step at 768², batch 8 with two views, bf16, with
gradient checkpointing, whose losses take the plain route as in the JAX
package, so K3/K4 launch 0 times, plus one small f32 step on the card
against the CPU path, whole and block by block (phase 7); and the same step
at batch 216 on 96² crops, where
pixel contrast has 8208 ≥ 8192 rows and runs through K3 and K4, against the
same step on the plain route (phase 8).

Then eval: the fused upsample-blend kernel (K5, ``mma.sync`` fed by
``ldmatrix``) and its first design (``wmma``) against their plain version at
the three decoder steps of a 2048×1024 batch-8 forward, a ragged width,
B = 1 and C = 256, one device operation a packed K5 call, and their times,
K5 required faster than the first design, through ``tools/profile_blend.py``
(phase 9); and ``make_eval_step`` with K5
on the decoder over 3 batches of 2048×1024, batch 8, bf16, merged into the
``Evaluator`` with a ``val_results.txt`` report: K2 (on tensor cores) and
K5 launch 3 times a batch and K1 never, labels and confusion matrices agree
with the unfused path up to the flipped pixels, a 1920×1080 batch launches
K5 never, a small f32 batch agrees with the CPU's eval step, and eval
throughput fused and unfused (phase 10).

Then the data path the trainer runs with on-device augmentation
(``host_augment=False``): the jump-flood EDT kernel (JF, ``csrc/jfa.cu``)
bit for bit against its plain version on 8 synthetic 768² label crops and
the same with 5 % salt noise, 88 kernel nodes a call, and its time
(phase 11, ``tools/profile_jfa.py``); two epochs of 6 flagship train
steps fed by the port's synthetic dataset at 1024×2048 through
``DataLoader`` → ``to_device`` → ``augment_batch`` (768² crops, two views,
JF's 88 launches a step) → ``make_train_step``, timed by stage, the first
epoch generating the frames and the second finding them cached (phase
12); and the same dataset's val split, twice, through ``DataLoader`` →
``make_eval_step`` with K5 on the decoder → ``Evaluator`` (phase 13). Before anything else it
prints which of PIL, cv2 and scipy import (the port uses none of them);
phase 4 also serves the batch in the planar and space-to-depth layouts.

Then the default input path (``host_augment=True``), all of it host code:
the times on the card's host of ``read_png`` on a 1080×1920 frame by PNG
filter, the crop-and-scale at three box scales and the chamfer EDT weights
of a 768² crop (phase 14, ``tools/profile_host_data.py``); three epochs of
3 flagship steps (4 loader threads, 4, then 1) fed by the synthetic
1024×2048 dataset through the host train transforms (768² crops, two
views, EDT weights on the host, no kernel launched), timed by stage (phase
15); and an ACDC tree of 1080×1920 PNGs written with ``write_png`` (every
frame with the five filters in turns down its rows, night frames, the
file lists), read back exactly, trained on for two epochs of 3 steps (4
loader threads, then 1) through ``get_dataset("acdc")`` with gamma on, K2
held to its plain version at the levels of 1920×1080 batches of 8 and 4,
and the val split through ``make_eval_step`` into the ``Evaluator``, K2
launching 3 times a batch (phase 16).

Any failure raises and exits non-zero; so does a machine without CUDA or a
directory without the package. The last line is ``{"ok": true, "device":
{...}}``; the line before it lists each kernel's launches, error and times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np

BATCH, HEIGHT, WIDTH = 8, 1024, 2048
CRITERION = "supcon_pixelcontrast_focal"
TRAIN_BATCH, TRAIN_CROP = 8, 768       # the published recipe (JAX config.py:98, 241)
DENSE_BATCH, DENSE_CROP = 216, 96      # 216·19·2 = 8208 ≥ 8192 pixel-contrast rows
KERNEL_N, D_FEAT = 8192, 128
VAL_HEIGHT, VAL_WIDTH = 1080, 1920      # the JAX default val shape (config.py:104-105)
SYNTHETIC_HW, SYNTHETIC_SIZE = "1024x2048", 48   # crop_wh: the published 768²
HOST_SIZE = 24                          # host-augmented synthetic: 3 steps an epoch
ACDC_TRAIN, ACDC_VAL = 24, 12           # ACDC from PNG: 3 steps an epoch, val batches 8 + 4


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


def contrastive_phase(torch, contrastive, profile_contrastive, gen, dev):
    """K3 against its plain version at N = 8192, 8200, 300 (and odd D, N =
    1) on both schedules, bitwise repeat and launches a call
    (``profile_contrastive.check_row_stats``); K4 against its plain version
    and its plain emulation from K3's row stats at N = 8192, 8200, 300, the
    dense step's anchor grid (8208), one label and edge cases, its layout
    against a stable ``torch.sort``, bitwise repeat, its own three launches
    and no host sync a call
    (``profile_contrastive.check_pos_sweep``); the public losses' values and
    gradients against autograd of the dense losses; the kernel route alone
    at N = 65536; then K3 beside the three-sweep kernel and K4 beside the
    dense sweep they replace, timed, each required faster
    (``profile_contrastive.time_routes``, ``time_anchor_grid``). Returns
    the kernel line's numbers."""
    from doubly_contrastive_semseg_tpu_torch.losses.pixel_contrast import _masked_contrastive
    from doubly_contrastive_semseg_tpu_torch.losses.supcon import supcon_loss

    inputs = profile_contrastive.contrastive_inputs
    k3_err = profile_contrastive.check_row_stats(gen, dev, log)
    k4_check = profile_contrastive.check_pos_sweep(gen, dev, log)

    for n in (KERNEL_N, 2 * KERNEL_N):
        z, labels, valid = inputs(gen, dev, n, 19)
        feats = z.reshape(2, n // 2, D_FEAT).transpose(0, 1)   # (A, 2, D) views
        a_lab, a_val = labels[: n // 2], valid[: n // 2]
        cases = (
            ("supcon", lambda x, k: supcon_loss(x, a_lab % 4, use_kernel=k)),
            ("pixel contrast", lambda x, k: _masked_contrastive(x, a_lab, a_val, 0.07, 0.07,
                                                                use_kernel=k)))
        for name, fn in cases:
            res = []
            for use_kernel in (True, False):
                x = feats.detach().clone().requires_grad_(True)
                loss = fn(x, use_kernel)
                loss.backward()
                res.append((loss.item(), x.grad))
            torch.cuda.synchronize()
            g_err = (res[0][1] - res[1][1]).abs().max().item()
            g_tol = 1e-4 * res[1][1].abs().max().item()
            rel = abs(res[0][0] - res[1][0]) / abs(res[1][0])
            log(f"  {name} loss N={n}: kernel {res[0][0]:.7f}, dense {res[1][0]:.7f} "
                f"(rel {rel:.2e}); grad max abs err {g_err:.2e} (tolerance {g_tol:.2e})")
            check(rel <= 1e-5 and g_err <= g_tol, f"{name} kernel loss disagrees at N={n}")
            del res

    n = 8 * KERNEL_N   # the dense route would hold 17 GB N×N temporaries
    z, labels, valid = inputs(gen, dev, n, 19)
    x = z.reshape(2, n // 2, D_FEAT).transpose(0, 1).contiguous().requires_grad_(True)
    t0 = time.perf_counter()
    loss = contrastive.pixel_contrast_loss_kernel(x, labels[: n // 2], valid[: n // 2])
    loss.backward()
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(loss).item() and torch.isfinite(x.grad).all().item())
    log(f"  pixel contrast kernel route alone, N={n}: loss {loss.item():.6f}, "
        f"gradient finite: {finite}, {time.perf_counter() - t0:.2f} s forward + backward")
    check(finite, f"kernel route not finite at N={n}")
    del x, loss, z

    timing = profile_contrastive.time_routes(gen, dev, log)
    grid = profile_contrastive.time_anchor_grid(gen, dev, log)
    for n, t in timing.items():
        check(t["ms"] < t["three_sweep_ms"],
              f"K3 at N={n} is not faster than the three-sweep kernel")
    for what, t in [*timing.items(), ("the anchor grid", grid)]:
        check(t["k4_ms"] < t["k4_dense_ms"],
              f"K4 (layout, sweep and reduce) at {what} is not faster than the dense sweep")
    return k3_err, k4_check, timing[KERNEL_N]


def snapshot(model, prefixes):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.startswith(prefixes)}


def flagship_phase(torch, gen, dev):
    """7. The flagship step: 6 steps, finite losses, frozen heads unchanged,
    trunk and BN stats moved, no kernel of the port launched; prints the
    time per step, throughput and peak memory."""
    from doubly_contrastive_semseg_tpu_torch import Config, build_model
    from doubly_contrastive_semseg_tpu_torch.tools.profile_train import make_batch
    from doubly_contrastive_semseg_tpu_torch.ops import contrastive, seghead, stem
    from doubly_contrastive_semseg_tpu_torch.train import (
        TrainState, build_optimizer, make_train_step)

    log(f"== 7. flagship train step: SwiftNet-RN18 {TRAIN_CROP}x{TRAIN_CROP}, batch "
        f"{TRAIN_BATCH} x 2 views, bf16, efficient, {CRITERION}")
    torch.backends.cudnn.benchmark = True
    cfg = Config(criterion=CRITERION, dataset="acdc")
    model = build_model(cfg, device=dev, seed=0)
    opt = build_optimizer(model, cfg, steps_per_epoch=200)  # ACDC: 1600 images / 8
    state = TrainState(model, opt)
    train_step = make_train_step(model, cfg, opt)
    batch = make_batch(TRAIN_BATCH, TRAIN_CROP, gen, dev)
    frozen = ("net.segmentation.conv.", "net.segmentation.norm.weight",
              "net.segmentation.norm.bias", "weather_clf.", "projection.")
    before_frozen = snapshot(model, frozen)
    before_trunk = snapshot(model, ("net.feature_extractor.",))
    anchors = torch.Generator(device=dev).manual_seed(0)
    for fn in (contrastive.contrastive_row_stats, contrastive.pos_sweep_layout,
               contrastive.pixel_contrast_pos_sweep, stem.fused_stem_pool,
               seghead.fused_seghead_upsample_argmax):
        fn.launches = 0
    step_s, peak_gb = [], 0.0
    for i in range(6):
        if i == 2:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = train_step(state, batch, anchors)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        comps = {k: v.item() for k, v in metrics.items()}
        check(all(map(lambda v: v == v and abs(v) < float("inf"), comps.values())),
              f"flagship step {i}: a loss is not finite: {comps}")
        log(f"  step {i}: {1e3 * step_s[-1]:.1f} ms; " +
            ", ".join(f"{k} {v:.4f}" for k, v in comps.items()))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    flag_launches = {"contrastive_row_stats": contrastive.contrastive_row_stats.launches,
                     "pos_sweep_layout": contrastive.pos_sweep_layout.launches,
                     "pixel_contrast_pos_sweep": contrastive.pixel_contrast_pos_sweep.launches,
                     "fused_stem_pool": stem.fused_stem_pool.launches,
                     "fused_seghead_upsample_argmax":
                         seghead.fused_seghead_upsample_argmax.launches}
    timed = step_s[2:]
    ms_step = 1e3 * sum(timed) / len(timed)
    log(f"  launches in 6 steps: {flag_launches} (the JAX routing gives 0: "
        f"supcon N = {2 * TRAIN_BATCH}, pixel contrast N = {TRAIN_BATCH * 19 * 2} < 8192)")
    check(all(v == 0 for v in flag_launches.values()),
          "the flagship step must launch no kernel of this port")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], check=True, capture_output=True, text=True).stdout.strip()
    log(f"  flagship step: {ms_step:.2f} ms per step (steps 2-5: "
        f"{', '.join(f'{1e3 * t:.2f}' for t in timed)}), "
        f"{TRAIN_BATCH * 1e3 / ms_step:.2f} samples/s = {2 * TRAIN_BATCH * 1e3 / ms_step:.2f} "
        f"crops/s, peak memory {peak_gb:.2f} GB; sm clock, power, temp after: {clocks}")
    after = model.state_dict()
    check(all(torch.equal(v, after[k]) for k, v in before_frozen.items()),
          "a frozen parameter (seg head, weather_clf, projection) moved")
    moved = [k for k, v in before_trunk.items() if not torch.equal(v, after[k])]
    check(any(k.endswith(".weight") and "conv" in k for k in moved)
          and any(k.endswith("running_var") for k in moved),
          "trunk parameters and BN running stats must change")
    log(f"  frozen heads unchanged; {len(moved)} of {len(before_trunk)} trunk tensors moved")
    del model, opt, state, train_step, batch, metrics, before_trunk, after
    torch.cuda.empty_cache()


def rel_err(torch, got, want) -> float:
    """max|got - want| / max|want|, both moved to the CPU."""
    got, want = got.detach().cpu(), want.detach().cpu()
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def block_errors(torch, block, inputs, dev, gen):
    """One training-mode forward and backward of ``block`` (a CPU module) on
    the card and on the CPU, from the same inputs and output cotangent.
    Returns the largest error of the output, of each input's and each
    parameter's gradient (all relative to the tensor's max) and of the BN
    running stats."""
    import copy

    runs = []
    for where in (dev, "cpu"):
        m = copy.deepcopy(block).to(where).train()
        xs = [x.to(where).requires_grad_(True) for x in inputs]
        y = m(*xs)
        if not runs:
            cot = torch.randn(y.shape, generator=gen)
        y.backward(cot.to(where).contiguous(memory_format=torch.channels_last)
                   if y.dim() == 4 else cot.to(where))
        runs.append((y, [x.grad for x in xs],
                     {k: p.grad for k, p in m.named_parameters()},
                     {k: v for k, v in m.state_dict().items() if k.endswith("running_var")
                      or k.endswith("running_mean")}))
    (y_d, gx_d, gp_d, st_d), (y_c, gx_c, gp_c, st_c) = runs
    return {"output": rel_err(torch, y_d, y_c),
            "grads": max([rel_err(torch, g, w) for g, w in zip(gx_d, gx_c)]
                         + [rel_err(torch, gp_d[k], gp_c[k]) for k in gp_c]),
            "stats": max([rel_err(torch, st_d[k], st_c[k]) for k in st_c], default=0.0)}


def card_vs_cpu_phase(torch, gen, dev):
    """7b. One small f32 step (128², 2 × 2 views, reference_rng) on the card
    and on the CPU path, then the step's trainable blocks one at a time.

    The card's and the CPU's forwards differ by ~1e-6, enough to flip the
    odd ReLU whose input is that close to 0, and each flip moves the
    gradients of every tensor below it by up to a few % of their max (the
    CPU tests meet the same against JAX). So the whole step is held by its
    loss components (rtol 1e-4) and the gradients of the tensors no ReLU
    gate precedes on the way back from the loss (1e-3 × max|g|); every
    gradient is held to 1e-3 × max|g| block by block, where no gate flips:
    BasicBlocks (checkpointed, with and without a projection shortcut), an
    upsample blend, the seg head and the projection head, each with its
    output, input and parameter gradients and BN running stats."""
    from doubly_contrastive_semseg_tpu_torch import Config, build_model
    from doubly_contrastive_semseg_tpu_torch.tools.profile_train import make_batch
    from doubly_contrastive_semseg_tpu_torch.train import compute_loss

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    gate_free = ("net.segmentation.conv.weight", "net.segmentation.conv.bias",
                 "projection.fc2.weight", "projection.fc2.bias")
    cfg = Config(criterion=CRITERION, dataset="acdc", reference_rng=True,
                 compute_dtype="float32")
    small_batch = make_batch(2, 128, gen, "cpu")
    results = {}
    for where in (dev, "cpu"):
        b = {k: v.to(where) for k, v in small_batch.items()}
        m = build_model(cfg, device="cpu", seed=4).to(where).train()
        total, comps, _ = compute_loss(m, cfg, b, None)
        total.backward()
        results[where] = ({k: v.item() for k, v in comps.items()},
                          {k: p.grad.cpu() for k, p in m.named_parameters()
                           if p.grad is not None})
        del m, b
    (c_gpu, g_gpu), (c_cpu, g_cpu) = results[dev], results["cpu"]
    comp_rel = max(abs(c_gpu[k] - c_cpu[k]) / max(abs(c_cpu[k]), 1e-30) for k in c_cpu)
    max_rel = {k: rel_err(torch, g_gpu[k], g_cpu[k]) for k in g_cpu}
    gate_free_err = max(max_rel[k] for k in gate_free)
    worst = max(max_rel, key=max_rel.get)
    log(f"  small f32 step (128², 2 x 2 views) card vs CPU: loss components max rel "
        f"err {comp_rel:.2e} (tolerance 1e-4); gradients of the gate-free tensors "
        f"{gate_free_err:.2e} of max|g| (tolerance 1e-3); {len(g_cpu)} tensors, the "
        f"largest error {max_rel[worst]:.2e} of max|g| in {worst} (not held: see above)")
    check(set(g_gpu) == set(g_cpu) and set(gate_free) <= set(g_cpu)
          and comp_rel <= 1e-4 and gate_free_err <= 1e-3,
          "the card's train step disagrees with the CPU path")

    model = build_model(cfg, device="cpu", seed=4)
    fe = model.net.feature_extractor

    def nchw(*shape):
        return torch.randn(*shape, generator=gen).contiguous(memory_format=torch.channels_last)

    # inputs small enough that no ReLU input lies within the two forwards'
    # rounding of 0 (about 1e-6 of an N(0, 1) pre-activation: one in 3e5)
    cases = (("layer1.0", fe.layer1[0], [nchw(2, 64, 16, 16)]),
             ("layer2.0 (stride 2, projection shortcut)", fe.layer2[0], [nchw(2, 64, 16, 16)]),
             ("layer4.1", fe.layer4[1], [nchw(2, 512, 4, 4)]),
             ("upsample_blends1", fe.upsample_blends1,
              [nchw(2, 128, 8, 8), nchw(2, 128, 16, 16)]),
             ("segmentation", model.net.segmentation, [nchw(2, 128, 16, 16)]),
             ("projection", model.projection, [torch.randn(4, 2, 128, generator=gen)]))
    for name, block, inputs in cases:
        errs = block_errors(torch, block, inputs, dev, gen)
        log(f"  block {name} card vs CPU: output {errs['output']:.2e}, gradients "
            f"{errs['grads']:.2e}, running stats {errs['stats']:.2e} of max|.| "
            f"(tolerances 1e-4, 1e-3, 1e-4)")
        check(errs["output"] <= 1e-4 and errs["grads"] <= 1e-3 and errs["stats"] <= 1e-4,
              f"block {name}: the card disagrees with the CPU")
    torch.backends.cudnn.deterministic = False


def dense_phase(torch, gen, dev):
    """8. The dense-contrast step: 3 steps, each launching K3 (its two
    passes and their reduces: ``profile_contrastive.LAUNCHES``) and K4's
    layout and sweep once each; step 0's losses against the plain route on
    the same weights. Returns the launch counts of the 3 steps."""
    from doubly_contrastive_semseg_tpu_torch.tools.profile_contrastive import LAUNCHES
    from doubly_contrastive_semseg_tpu_torch import Config, build_model
    from doubly_contrastive_semseg_tpu_torch.tools.profile_train import make_batch
    from doubly_contrastive_semseg_tpu_torch.ops import contrastive
    from doubly_contrastive_semseg_tpu_torch.train import (
        TrainState, build_optimizer, compute_loss, make_train_step)

    cfg = Config(criterion=CRITERION, dataset="acdc")
    n_rows = DENSE_BATCH * 19 * 2
    log(f"== 8. dense-contrast train step: batch {DENSE_BATCH} x 2 views at "
        f"{DENSE_CROP}x{DENSE_CROP}, bf16, {CRITERION}; pixel contrast N = {n_rows}")
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True   # the two routes see one forward
    model = build_model(cfg, device=dev, seed=1)
    opt = build_optimizer(model, cfg, steps_per_epoch=200)
    state = TrainState(model, opt)
    train_step = make_train_step(model, cfg, opt)
    batch = make_batch(DENSE_BATCH, DENSE_CROP, gen, dev)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    with torch.no_grad():
        _, plain, _ = compute_loss(model, cfg, batch,
                                   torch.Generator(device=dev).manual_seed(5),
                                   use_kernel=False)
    model.load_state_dict(weights)
    del weights
    kernels = {"contrastive_row_stats": contrastive.contrastive_row_stats,
               "pos_sweep_layout": contrastive.pos_sweep_layout,
               "pixel_contrast_pos_sweep": contrastive.pixel_contrast_pos_sweep}
    for fn in kernels.values():
        fn.launches = 0
    anchors = torch.Generator(device=dev).manual_seed(5)
    for i in range(3):
        before = {k: fn.launches for k, fn in kernels.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = train_step(state, batch, anchors)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        comps = {k: v.item() for k, v in metrics.items()}
        d3, d_layout, d4 = (fn.launches - before[k] for k, fn in kernels.items())
        log(f"  step {i}: {1e3 * dt:.1f} ms, row-stats launches {d3}, positive sweep layouts "
            f"{d_layout} and sweeps {d4}; " + ", ".join(f"{k} {v:.5f}" for k, v in comps.items()))
        check(d3 == LAUNCHES and d_layout == 1 and d4 == 1,
              f"each dense step must launch K3 {LAUNCHES} times (2 passes, 2 reduces) and K4's "
              "layout and sweep once each")
        check(all(map(lambda v: v == v and abs(v) < float("inf"), comps.values())),
              f"dense step {i}: a loss is not finite")
        if i == 0:
            rel = {k: abs(comps[k] - plain[k].item()) / max(abs(plain[k].item()), 1e-30)
                   for k in plain}
            log("  step 0 vs the plain route on the same weights: "
                + ", ".join(f"{k} {plain[k].item():.6f} (rel {rel[k]:.2e})" for k in plain))
            check(max(rel.values()) <= 1e-4, "the kernel route disagrees with the plain route")
    dense_launches = {k: fn.launches for k, fn in kernels.items()}
    log(f"  launches in 3 steps: {dense_launches}")
    del model, opt, state, train_step, batch
    torch.backends.cudnn.deterministic = False
    return dense_launches


def blend_phase(torch, profile_blend, gen, dev):
    """9. K5 (``csrc/blend_mma.cu``) and the first design (``csrc/blend.cu``,
    ``wmma``) against the plain version on the card at the three decoder
    steps of a 2048×1024 batch-8 forward that take K5, a ragged width tile,
    B = 1 and C = 256, f32 output within 1e-3 × max|ref| and bf16 within
    1e-2; one device operation a packed call; then their times beside the
    plain version's, the bound and the unfused PyTorch step, through
    ``tools/profile_blend.py``. K5 must beat the first design summed over
    the three headline shapes. Returns K5's headline error and the times
    (sums over the three headline shapes)."""
    err = profile_blend.check_kernel(gen, dev, log)
    profile_blend.device_ops(gen, dev, log)
    t = profile_blend.time_blend(gen, dev, log)
    check(t["ms"] < t["wmma_ms"], f"K5 ({t['ms']:.4f} ms) is not faster than the first design "
          f"(wmma, {t['wmma_ms']:.4f} ms) over the three headline shapes")
    return err, t


def eval_batches(torch, dev, n, b, h, w, seed):
    """``n`` device-resident eval batches: uint8 frames, uint8 labels with
    about 10 % 255 holes, weather ids. Frames are spatially correlated, as
    a camera's are: a random grid of one value every 16 pixels, bilinearly
    upsampled. (On white-noise frames the random model's label map is so
    fragmented that about 1.8 % of the pixels lie on a class boundary,
    where bf16 rounding alone flips them.)"""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(n):
        coarse = torch.rand((b, 3, -(-h // 16), -(-w // 16)), generator=g, device=dev)
        left = torch.nn.functional.interpolate(coarse * 255, size=(h, w), mode="bilinear",
                                               align_corners=False)
        label = torch.randint(0, 19, (b, h, w), generator=g, device=dev, dtype=torch.uint8)
        label[torch.rand((b, h, w), generator=g, device=dev) < 0.1] = 255
        out.append({"left": left.round().to(torch.uint8).permute(0, 2, 3, 1).contiguous(),
                    "label": label,
                    "weather": torch.randint(0, 4, (b,), generator=g, device=dev)})
    return out


def flip_counts(torch, label, pa, pb, c=19):
    """Pixels with a valid label whose two predictions differ, and for each
    class the number of those pixels it touches (as label or either
    prediction): the most that its intersection or union can move."""
    flipped = (pa != pb) & (label.long() < c)
    gt, a, b = label.long()[flipped], pa.long()[flipped], pb.long()[flipped]
    eye = torch.eye(c, dtype=torch.bool, device=label.device)
    touched = (eye[gt] | eye[a] | eye[b]).sum(0)
    return int(flipped.sum().item()), touched.double().cpu()


def check_within_flips(torch, cm_a, cm_b, n_flips, touched, what):
    """The two accumulated (C, C) matrices differ only by the flipped
    pixels: L1 ≤ 2 per flip, and each class's intersection and union by at
    most the flips that touch it. Returns the largest IoU difference."""
    a, b = cm_a.double().cpu(), cm_b.double().cpu()
    l1 = (a - b).abs().sum().item()
    inter_a, inter_b = a.diagonal(), b.diagonal()
    union_a = a.sum(0) + a.sum(1) - inter_a
    union_b = b.sum(0) + b.sum(1) - inter_b
    iou_diff = (inter_a / union_a - inter_b / union_b).abs().nan_to_num(0.0).max().item()
    log(f"  {what}: {n_flips} flipped pixels, confusion L1 {l1:.0f} (bound {2 * n_flips}), "
        f"largest per-class IoU difference {iou_diff:.2e}")
    check(l1 <= 2 * n_flips and bool(((inter_a - inter_b).abs() <= touched).all())
          and bool(((union_a - union_b).abs() <= touched).all()),
          f"{what}: the confusion matrices differ by more than the flipped pixels")
    return iou_diff


def eval_phase(torch, gen, dev):
    """10. The eval path at full width: ``make_eval_step`` over 3 batches of
    2048×1024, batch 8, bf16, with K5 on the decoder; launches, the unfused
    path, ``Evaluator``, 1920×1080, the CPU, and throughput. Returns the
    launch counts of the 3 batches."""
    import os
    import tempfile

    from doubly_contrastive_semseg_tpu_torch import Config, build_model
    from doubly_contrastive_semseg_tpu_torch.metrics import Evaluator
    from doubly_contrastive_semseg_tpu_torch.ops import blend, seghead, stem
    from doubly_contrastive_semseg_tpu_torch.tools.profile_eval import set_fused
    from doubly_contrastive_semseg_tpu_torch.train import init_eval_accum, make_eval_step

    log(f"== 10. eval SwiftNet-RN18 {WIDTH}x{HEIGHT} batch {BATCH} bf16, fused blends")
    kernels = {"fused_stem_pool": stem.fused_stem_pool,
               "fused_seghead_upsample_argmax": seghead.fused_seghead_upsample_argmax,
               "fused_upsample_blend": blend.fused_upsample_blend}

    def counts():
        return {k: fn.launches for k, fn in kernels.items()}

    torch.backends.cudnn.benchmark = True
    cfg = Config()
    model = build_model(cfg, device=dev, seed=0)
    randomize_bn(model, torch.Generator().manual_seed(1))
    model.to(dev)
    set_fused(model, True)
    step = make_eval_step(model, cfg)
    batches = eval_batches(torch, dev, 3, BATCH, HEIGHT, WIDTH, seed=7)
    accum = init_eval_accum(cfg, device=dev)
    for fn in kernels.values():
        fn.launches = 0
    stem.fused_stem_pool.tc_launches = stem.fused_stem_pool.cc_launches = 0
    preds_fused = []
    for i, batch in enumerate(batches):
        before = counts()
        tc_before = stem.fused_stem_pool.tc_launches
        preds, accum = step(batch, accum)
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in counts().items()}
        tc = stem.fused_stem_pool.tc_launches - tc_before
        log(f"  batch {i}: launches {delta}; tensor-core stem {tc}")
        check(delta == {"fused_stem_pool": 3, "fused_seghead_upsample_argmax": 0,
                        "fused_upsample_blend": 3},
              "each 2048x1024 eval batch must launch K2 3 times, K5 3 times and K1 never")
        check(tc == 3, "each bf16 eval batch must take the tensor-core stem 3 times")
        check(preds.shape == (BATCH, HEIGHT, WIDTH) and preds.dtype == torch.int32
              and 0 <= preds.min().item() and preds.max().item() < 19, "eval preds")
        preds_fused.append(preds)
    eval_launches = counts()
    log(f"  launches in 3 batches: {eval_launches}; stem routes: tensor cores "
        f"{stem.fused_stem_pool.tc_launches}, CUDA cores {stem.fused_stem_pool.cc_launches}")
    check(stem.fused_stem_pool.cc_launches == 0, "the bf16 eval path took the CUDA-core stem")
    n_valid = sum(int((b["label"] < 19).sum().item()) for b in batches)
    check(accum["cm"].double().sum().item() == n_valid and accum["n_batches"].item() == 3
          and accum["cm_weather"].double().sum().item() == 3 * BATCH
          and accum["cm_weather_sem"].double().sum().item() == n_valid,
          "the accumulators must count every valid pixel and image once")

    # the same weights unfused
    set_fused(model, False)
    accum_u = init_eval_accum(cfg, device=dev)
    n_flips, touched, agree = 0, torch.zeros(19, dtype=torch.float64), []
    for batch, pf in zip(batches, preds_fused):
        pu, accum_u = step(batch, accum_u)
        agree.append((pu == pf).double().mean().item())
        nf, t = flip_counts(torch, batch["label"], pf, pu)
        n_flips, touched = n_flips + nf, touched + t
    log(f"  fused vs unfused labels: agreement {', '.join(f'{a:.6f}' for a in agree)} (bar 0.99)")
    check(min(agree) >= 0.99, "the fused eval path disagrees with the unfused one")
    check_within_flips(torch, accum["cm"], accum_u["cm"], n_flips, touched,
                       "fused vs unfused accumulated cm")
    del preds_fused, accum_u

    # Trainer.validate's merge and report (JAX trainer.py:372-380)
    host = {k: v.cpu() for k, v in accum.items()}
    evaluator = Evaluator(cfg.num_classes, cfg.weather_num)
    evaluator.merge_device_batch(host["cm"], host["cm_weather_sem"], host["cm_weather"],
                                 weather_acc=float(host["weather_acc_sum"])
                                 / max(float(host["n_batches"]), 1.0))
    score = evaluator.get_results()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "val_results.txt")
        weather_acc = evaluator.get_weather_results(path)
        miou = evaluator.Mean_Intersection_over_Union(path)
        evaluator.Mean_Intersection_over_Union_each_weather(path)
        with open(path) as f:
            report = f.read().splitlines()
    log(f"  Evaluator: {Evaluator.to_str(score).strip().replace(chr(10), ', ')}; weather "
        f"accuracy {weather_acc:.5f}; val_results.txt {len(report)} lines")
    # weather matrix (2 + 4 rows + purity + accuracy), class IoU (1 + 19),
    # per weather (4 x (1 + 19 + 1))
    check(len(report) == 8 + 20 + 4 * 21 and miou == miou and 0 <= miou <= 1,
          "the val_results.txt report")

    # 1920x1080: no decoder step passes the guard
    before = counts()
    b1080 = eval_batches(torch, dev, 1, BATCH, VAL_HEIGHT, VAL_WIDTH, seed=8)[0]
    set_fused(model, True)
    preds, _ = step(b1080, init_eval_accum(cfg, device=dev))
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in counts().items()}
    log(f"  {VAL_WIDTH}x{VAL_HEIGHT} batch {BATCH}: launches {delta}")
    check(delta == {"fused_stem_pool": 3, "fused_seghead_upsample_argmax": 0,
                    "fused_upsample_blend": 0} and preds.shape == (BATCH, VAL_HEIGHT, VAL_WIDTH),
          "a 1920x1080 eval batch must launch K2 3 times and K5 never")
    del b1080, preds

    # throughput, fused and unfused in turns (bench.py's windows)
    iters, fps, peak = 10, {True: [], False: []}, {}
    for fused in (False, True, True, False, False, True):
        set_fused(model, fused)
        for _ in range(3 if fused not in peak else 0):
            step(batches[0], accum)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            _, acc_t = step(batches[0], accum)
        torch.cuda.synchronize()
        fps[fused].append(BATCH * iters / (time.perf_counter() - t0))
        peak[fused] = max(peak.get(fused, 0.0), torch.cuda.max_memory_allocated() / 1e9)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], check=True, capture_output=True, text=True).stdout.strip()
    for fused in (True, False):
        f = fps[fused]
        log(f"  eval {'fused' if fused else 'unfused'}: {sum(f) / len(f):.2f} frames/s "
            f"(windows of {iters} batches: {', '.join(f'{x:.2f}' for x in f)}), "
            f"peak memory {peak[fused]:.2f} GB")
    log(f"  sm clock, power, temp after: {clocks}")
    del model, step, batches, accum, acc_t
    torch.cuda.empty_cache()

    # a small f32 input against the CPU path, blend 5 fused
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    cfg32 = Config(compute_dtype="float32")
    small = build_model(cfg32, device=dev, seed=2)
    randomize_bn(small, torch.Generator().manual_seed(3))
    small.to(dev)
    cpu = build_model(cfg32, device="cpu", seed=2)
    cpu.load_state_dict({k: v.cpu() for k, v in small.state_dict().items()})
    set_fused(small, True)
    set_fused(cpu, True)
    batch = {k: v.cpu() for k, v in eval_batches(torch, dev, 1, 2, 256, 256, seed=9)[0].items()}
    k5 = blend.fused_upsample_blend.launches
    p_gpu, a_gpu = make_eval_step(small, cfg32)({k: v.to(dev) for k, v in batch.items()},
                                               init_eval_accum(cfg32, device=dev))
    check(blend.fused_upsample_blend.launches - k5 == 1, "blend 5 must fuse at 2x256x256")
    p_cpu, a_cpu = make_eval_step(cpu, cfg32)(batch, init_eval_accum(cfg32, device="cpu"))
    agree = (p_gpu.cpu() == p_cpu).double().mean().item()
    nf, touched = flip_counts(torch, batch["label"], p_gpu.cpu(), p_cpu)
    with torch.no_grad():
        w_gpu = small(batch["left"].to(dev).float())["weather_logits"].argmax(-1).cpu()
        w_cpu = cpu(batch["left"].float())["weather_logits"].argmax(-1)
    w_flips = int((w_gpu != w_cpu).sum().item())
    log(f"  small f32 eval (2x256x256) vs the CPU: label agreement {agree:.6f} (bar 0.999), "
        f"weather argmax flips {w_flips}")
    check(agree >= 0.999, "the card's eval step disagrees with the CPU's")
    check_within_flips(torch, a_gpu["cm"], a_cpu["cm"], nf, touched, "card vs CPU cm")
    check((a_gpu["cm_weather"].cpu() - a_cpu["cm_weather"]).abs().sum().item() <= 2 * w_flips
          and a_gpu["n_batches"].item() == a_cpu["n_batches"].item() == 1,
          "the card's weather accumulators disagree with the CPU's")
    torch.backends.cudnn.deterministic = False
    del small, cpu
    return eval_launches


def host_libraries() -> str:
    """Which of PIL, cv2 and scipy import here, each tried in a fresh
    interpreter so that none of them loads into this one."""
    code = ("import importlib, json\nok = {}\nfor m in ('PIL', 'cv2', 'scipy'):\n"
            "    try:\n        importlib.import_module(m)\n        ok[m] = True\n"
            "    except Exception:\n        ok[m] = False\nprint(json.dumps(ok))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    return out.stdout.strip() or f"unknown ({out.stderr.strip()[-200:]})"


def s2d_pack(x):
    """(B, H, W, 3) → (B, H/2, W/2, 12), channel c*4 + i0*2 + j0 holding
    pixel (2y + i0, 2x + j0) of channel c (JAX ``s2d_pack``)."""
    b, h, w, _ = x.shape
    return (x.reshape(b, h // 2, 2, w // 2, 2, 3).permute(0, 1, 3, 5, 2, 4)
            .reshape(b, h // 2, w // 2, 12).contiguous())


def layouts_check(torch, serve, image, labels, stem, seghead):
    """4b. The serving batch in the planar (B, 3, H, W) and s2d layouts:
    the same labels as NHWC, K2 and K1 launched 3 and 1 times each."""
    for name, x in (("planar", image.permute(0, 3, 1, 2).contiguous()),
                    ("s2d", s2d_pack(image))):
        before = (stem.fused_stem_pool.launches, seghead.fused_seghead_upsample_argmax.launches)
        got = serve(x)
        torch.cuda.synchronize()
        k2 = stem.fused_stem_pool.launches - before[0]
        k1 = seghead.fused_seghead_upsample_argmax.launches - before[1]
        same = torch.equal(got, labels)
        log(f"  layout {name} {tuple(x.shape)}: labels {tuple(got.shape)} identical to NHWC: "
            f"{same}; launches K2 {k2}, K1 {k1}")
        check(same and k2 == 3 and k1 == 1,
              f"serving the {name} layout must give the NHWC labels through K2 3 times and K1 once")


def jfa_phase(torch, profile_jfa, gen, dev):
    """11. JF against its plain version, its device operations and times
    (``tools/profile_jfa.py``). Returns (max abs err, times)."""
    log("== 11. jump-flood EDT kernel (JF) vs nearest_diff_label_distance_reference")
    err = profile_jfa.check_kernel(gen, dev, log)
    profile_jfa.device_ops(dev, log)
    return err, profile_jfa.time_jfa(gen, dev, log)


def loader_train_phase(torch, dev):
    """12. The flagship step fed by the loader: synthetic frames →
    ``DataLoader`` → ``to_device`` → ``augment_batch`` → ``make_train_step``,
    2 epochs of 6 steps. Returns (the model, its config, the val dataset,
    JF's launches in the 12 steps)."""
    from doubly_contrastive_semseg_tpu_torch import Config, build_model
    from doubly_contrastive_semseg_tpu_torch.data import (DataLoader, augment_batch, get_dataset,
                                                          to_device)
    from doubly_contrastive_semseg_tpu_torch.ops import blend, contrastive, edt, seghead, stem
    from doubly_contrastive_semseg_tpu_torch.train import (TrainState, build_optimizer,
                                                           make_train_step)

    cfg = Config(dataset="synthetic", synthetic_hw=SYNTHETIC_HW, synthetic_size=SYNTHETIC_SIZE,
                 host_augment=False, criterion=CRITERION, batch_size=TRAIN_BATCH, num_workers=4)
    crop = cfg.crop_wh[0]
    check(crop == TRAIN_CROP and cfg.efficient and cfg.compute_dtype == "bfloat16",
          "the loader-fed step must run the flagship recipe")
    log(f"== 12. loader-fed flagship train step: synthetic {SYNTHETIC_HW} frames "
        f"(size {SYNTHETIC_SIZE}), {cfg.num_workers} loader workers, on-device crops {crop}², "
        f"batch {cfg.batch_size} x 2 views, bf16, efficient, {CRITERION}")
    torch.backends.cudnn.benchmark = True
    train_dst, val_dst = get_dataset(cfg, seed=cfg.random_seed)
    loader = DataLoader(train_dst, cfg.batch_size, shuffle=cfg.shuffle,
                        num_workers=cfg.num_workers, drop_last=True, seed=cfg.random_seed)
    class_weight = torch.ones(cfg.num_classes)   # JAX trainer.py:64-68 for synthetic data
    model = build_model(cfg, device=dev, seed=0)
    opt = build_optimizer(model, cfg, steps_per_epoch=len(loader))
    state = TrainState(model, opt)
    train_step = make_train_step(model, cfg, opt)
    aug_gen = torch.Generator(device=dev).manual_seed(cfg.random_seed + 1)
    anchors = torch.Generator(device=dev).manual_seed(0)
    jf = edt.nearest_diff_label_distance
    per_step = len(edt.jfa_launches(crop, crop))     # 88 at 768²
    others = (contrastive.contrastive_row_stats, contrastive.pos_sweep_layout,
              contrastive.pixel_contrast_pos_sweep, stem.fused_stem_pool,
              seghead.fused_seghead_upsample_argmax, blend.fused_upsample_blend)
    for fn in (jf, *others):
        fn.launches = 0
    # epoch 0 generates every frame; epoch 1 finds them in the dataset's
    # cache, so its wait is the loader's own cost (sampling, collate)
    n_steps = 0
    for epoch in range(2):
        loader.set_epoch(epoch)
        split, it = [], iter(loader)
        t_wait = time.perf_counter()
        for i in range(len(loader)):
            batch = next(it)
            t0 = time.perf_counter()
            if epoch == 0 and i == 2:
                torch.cuda.reset_peak_memory_stats()
            before = jf.launches
            db = to_device(batch, dev, class_weight)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            db.update(augment_batch(db["left"], db["label"], db["weather"], aug_gen, crop=crop,
                                    num_classes=cfg.num_classes, two_crop=cfg.use_supcon,
                                    use_gamma=cfg.use_gamma_correction))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            metrics = train_step(state, db, anchors)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            split.append((t0 - t_wait, t1 - t0, t2 - t1, t3 - t2))
            comps = {k: v.item() for k, v in metrics.items()}
            check(tuple(db["left"].shape) == (2 * cfg.batch_size, crop, crop, 3)
                  and tuple(db["label_distance_weight"].shape) == (cfg.batch_size, crop, crop),
                  "the augmented batch's shapes")
            check(all(map(lambda v: v == v and abs(v) < float("inf"), comps.values())),
                  f"loader-fed step {i}: a loss is not finite: {comps}")
            log(f"  epoch {epoch} step {i}: loader wait {1e3 * split[-1][0]:.1f} ms, to_device "
                f"{1e3 * split[-1][1]:.1f} ms, augmentation {1e3 * split[-1][2]:.1f} ms (JF "
                f"launches {jf.launches - before}), train step {1e3 * split[-1][3]:.1f} ms; "
                + ", ".join(f"{k} {v:.4f}" for k, v in comps.items()))
            check(jf.launches - before == per_step,
                  f"each {crop}² train step must launch JF {per_step} times")
            t_wait = time.perf_counter()
        check(next(it, None) is None, "the loader must end after len(loader) batches")
        n_steps += len(split)
        timed = split[2:]
        mean = [1e3 * sum(s[j] for s in timed) / len(timed) for j in range(4)]
        total = sum(mean)
        log(f"  epoch {epoch} ({'frames generated' if epoch == 0 else 'frames cached'}), steps "
            f"2-{len(split) - 1}: {total:.2f} ms a step = loader wait {mean[0]:.2f} + to_device "
            f"{mean[1]:.2f} + augmentation {mean[2]:.2f} + train step {mean[3]:.2f} ms; "
            f"{cfg.batch_size * 1e3 / total:.2f} samples/s "
            f"({cfg.batch_size * 1e3 / (total - mean[0]):.2f} without the wait)")
    other_launches = {fn.__name__: fn.launches for fn in others}
    log(f"  launches in {n_steps} steps: JF {jf.launches}, the others {other_launches} "
        f"(the flagship step takes the plain contrastive route and the unfused stem)")
    check(not any(other_launches.values()), "the loader-fed step must launch no kernel but JF")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], check=True, capture_output=True, text=True).stdout.strip()
    log(f"  peak memory {peak_gb:.2f} GB; sm clock, power, temp after: {clocks}")
    return model, cfg, val_dst, jf.launches


def loader_eval_phase(torch, dev, model, cfg, val_dst):
    """13. The val split through ``DataLoader`` → ``to_device`` →
    ``make_eval_step`` (K5 on the decoder) → ``Evaluator``."""
    from doubly_contrastive_semseg_tpu_torch.data import DataLoader, to_device
    from doubly_contrastive_semseg_tpu_torch.metrics import Evaluator
    from doubly_contrastive_semseg_tpu_torch.ops import blend, stem
    from doubly_contrastive_semseg_tpu_torch.tools.profile_eval import set_fused
    from doubly_contrastive_semseg_tpu_torch.train import init_eval_accum, make_eval_step

    loader = DataLoader(val_dst, cfg.val_batch_size, shuffle=False, num_workers=cfg.num_workers)
    log(f"== 13. loader-fed eval: the synthetic val split, {len(val_dst)} frames at "
        f"{SYNTHETIC_HW}, batches of {cfg.val_batch_size}, {cfg.compute_dtype}, fused blends")
    set_fused(model, True)
    step = make_eval_step(model, cfg)
    # pass 0 generates the frames and tunes cuDNN for both batch sizes;
    # pass 1 (frames cached in the dataset) is timed
    for epoch in range(2):
        accum = init_eval_accum(cfg, device=dev)
        frames, step_s = 0, 0.0
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        for i, batch in enumerate(loader):
            before = (stem.fused_stem_pool.launches, blend.fused_upsample_blend.launches)
            t0 = time.perf_counter()
            preds, accum = step(to_device(batch, dev), accum)
            torch.cuda.synchronize()
            step_s += time.perf_counter() - t0
            k2 = stem.fused_stem_pool.launches - before[0]
            k5 = blend.fused_upsample_blend.launches - before[1]
            b = batch["left"].shape[0]
            frames += b
            log(f"  pass {epoch} batch {i}: {b} frames {tuple(batch['left'].shape[1:3])}, "
                f"launches K2 {k2}, K5 {k5}")
            check(k2 == 3 and k5 == 3, "each loader-fed eval batch must launch K2 and K5 3 times")
        wall = time.perf_counter() - t_start
        check(frames == len(val_dst), "the eval loader must deliver every val frame once")
        log(f"  pass {epoch}: {frames / wall:.2f} frames/s end to end (loader included), "
            f"{frames / step_s:.2f} frames/s in to_device and the eval steps")
    host = {k: v.cpu() for k, v in accum.items()}
    evaluator = Evaluator(cfg.num_classes, cfg.weather_num)
    evaluator.merge_device_batch(host["cm"], host["cm_weather_sem"], host["cm_weather"],
                                 weather_acc=float(host["weather_acc_sum"])
                                 / max(float(host["n_batches"]), 1.0))
    miou = evaluator.Mean_Intersection_over_Union()
    check(miou == miou and 0 <= miou <= 1, f"mIoU {miou}")
    log(f"  loader-fed eval: mIoU {miou:.5f} over the {frames} frames of pass 1")


def host_data_phase(profile_host_data):
    """14. The host side of the default input path on this machine's CPU
    (``tools/profile_host_data.py``): PNG decoding of a 1080×1920 frame by
    filter, the crop-and-scale at three box scales, the chamfer and the EDT
    weights of a 768² crop."""
    log(f"== 14. host data path on the card's host ({profile_host_data.cpu_name()}): "
        "PNG decode, crop-and-scale, chamfer")
    with tempfile.TemporaryDirectory() as base:
        decode = profile_host_data.time_decode(base)
    log("  read_png of a 1080x1920 frame (RGB), ms by filter: "
        + ", ".join(f"{k[4:-3]} {v:.1f}" for k, v in decode.items() if k.startswith("rgb_"))
        + f"; the labelIds map (grey, Pillow's filter choice) {decode['label_adaptive_ms']:.1f} ms")
    tr = profile_host_data.time_transforms()
    log(f"  crop-and-scale to 768² (image bicubic + label nearest), ms at box scale 0.5 / 1 / 2: "
        f"{tr['crop_scale_0.5_ms']:.1f} / {tr['crop_scale_1_ms']:.1f} / "
        f"{tr['crop_scale_2_ms']:.1f}; chamfer of a 768² crop {tr['chamfer_ms']:.1f} ms, "
        f"LabelBoundaryTransform {tr['label_boundary_ms']:.1f} ms")
    log("  host data " + json.dumps({"cpu": profile_host_data.cpu_name(), **decode, **tr}))


def host_fed_steps(torch, dev, cfg, train_dst, what: str, workers=(4, 4)):
    """Flagship train steps fed by the host train transforms: ``DataLoader``
    → ``to_device`` → ``make_train_step``, one epoch for each entry of
    ``workers`` with that many loader threads, each step timed by stage,
    after one sample timed alone on this thread. Checks the two-view batch,
    the EDT weights (in [0, 1], 0 at ignore), finite losses and that no
    kernel launches (the host computes the EDT weights; the flagship losses
    take the plain route). Returns the model."""
    from doubly_contrastive_semseg_tpu_torch import build_model
    from doubly_contrastive_semseg_tpu_torch.data import DataLoader, to_device
    from doubly_contrastive_semseg_tpu_torch.ops import blend, contrastive, edt, seghead, stem
    from doubly_contrastive_semseg_tpu_torch.train import (TrainState, build_optimizer,
                                                           make_train_step)

    crop = cfg.crop_wh[0]
    train_dst[0]                      # a synthetic frame is generated (and kept) here
    t0 = time.perf_counter()
    train_dst[0]
    log(f"  one sample (two views) on this thread, no loader: "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms")
    class_weight = torch.ones(cfg.num_classes)
    model = build_model(cfg, device=dev, seed=0)
    opt = build_optimizer(model, cfg, steps_per_epoch=len(train_dst) // cfg.batch_size)
    state = TrainState(model, opt)
    train_step = make_train_step(model, cfg, opt)
    anchors = torch.Generator(device=dev).manual_seed(0)
    counted = (edt.nearest_diff_label_distance, contrastive.contrastive_row_stats,
               contrastive.pos_sweep_layout, contrastive.pixel_contrast_pos_sweep,
               stem.fused_stem_pool, seghead.fused_seghead_upsample_argmax,
               blend.fused_upsample_blend)
    for fn in counted:
        fn.launches = 0
    for epoch, n_workers in enumerate(workers):
        loader = DataLoader(train_dst, cfg.batch_size, shuffle=cfg.shuffle,
                            num_workers=n_workers, drop_last=True, seed=cfg.random_seed)
        loader.set_epoch(epoch)
        split, it = [], iter(loader)
        t_wait = time.perf_counter()
        for i in range(len(loader)):
            batch = next(it)
            t0 = time.perf_counter()
            b = cfg.batch_size
            w = batch["label_distance_weight"]
            check(batch["left"].shape == (2 * b, crop, crop, 3) and batch["left"].dtype == np.uint8
                  and batch["label"].shape == (b, crop, crop) and w.shape == (b, crop, crop)
                  and w.dtype == np.float32, f"{what}: the host-augmented batch's shapes")
            check(bool(np.isfinite(w).all()) and w.min() >= 0 and w.max() <= 1
                  and not w[batch["label"] == 255].any(),
                  f"{what}: EDT weights must lie in [0, 1] and be 0 at ignore pixels")
            db = to_device(batch, dev, class_weight)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            metrics = train_step(state, db, anchors)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            split.append((t0 - t_wait, t1 - t0, t2 - t1))
            comps = {k: v.item() for k, v in metrics.items()}
            check(all(map(lambda v: v == v and abs(v) < float("inf"), comps.values())),
                  f"{what} step {i}: a loss is not finite: {comps}")
            log(f"  epoch {epoch} step {i}: loader wait {1e3 * split[-1][0]:.1f} ms, to_device "
                f"{1e3 * split[-1][1]:.1f} ms, train step {1e3 * split[-1][2]:.1f} ms; "
                + ", ".join(f"{k} {v:.4f}" for k, v in comps.items()))
            t_wait = time.perf_counter()
        check(next(it, None) is None, "the loader must end after len(loader) batches")
        # step 0 of an epoch also waits for the loader's pipeline to fill
        timed = split[1:]
        mean = [1e3 * sum(s[j] for s in timed) / len(timed) for j in range(3)]
        total = sum(mean)
        log(f"  {what}, epoch {epoch} ({n_workers} loader threads), steps 1-{len(split) - 1}: "
            f"{total:.2f} ms a step = loader "
            f"wait {mean[0]:.2f} + to_device {mean[1]:.2f} + train step {mean[2]:.2f} ms; "
            f"{cfg.batch_size * 1e3 / total:.2f} samples/s "
            f"({cfg.batch_size * 1e3 / (total - mean[0]):.2f} without the wait); step 0 waited "
            f"{1e3 * split[0][0]:.1f} ms")
    launches = {fn.__name__: fn.launches for fn in counted}
    check(not any(launches.values()), f"{what}: no kernel may launch in host-fed steps: {launches}")
    return model


def host_augment_phase(torch, dev):
    """15. The default route: the synthetic 1024×2048 dataset through the
    host train transforms (768² crops, chamfer EDT weights, two views) into
    the flagship step."""
    from doubly_contrastive_semseg_tpu_torch import Config
    from doubly_contrastive_semseg_tpu_torch.data import get_dataset

    cfg = Config(dataset="synthetic", synthetic_hw=SYNTHETIC_HW, synthetic_size=HOST_SIZE,
                 criterion=CRITERION, batch_size=TRAIN_BATCH, num_workers=4)
    check(cfg.host_augment and cfg.crop_wh == (TRAIN_CROP, TRAIN_CROP) and cfg.use_supcon,
          "the host-augmented phase must run the default route at the published crop")
    log(f"== 15. host-augmented flagship train step: synthetic {SYNTHETIC_HW} frames (size "
        f"{HOST_SIZE}), host crops {TRAIN_CROP}², batch {cfg.batch_size} x 2 views, "
        f"{cfg.compute_dtype}, {CRITERION}; epoch 0 generates the frames with 4 loader "
        "threads, epochs 1 and 2 find them cached, with 4 threads and with 1")
    train_dst, _ = get_dataset(cfg, seed=cfg.random_seed)
    host_fed_steps(torch, dev, cfg, train_dst, "host-augmented synthetic", workers=(4, 4, 1))


def acdc_phase(torch, dev, profile_host_data, profile_stem):
    """16. ACDC from PNG files: an ACDC tree written with ``write_png``
    (1080×1920 frames with the five filters in turns down their rows,
    labelIds maps, night frames, the file lists), read back exactly,
    trained on through ``get_dataset`` (host transforms, gamma on), K2
    held to its plain version at the val split's shapes, and the val split
    evaluated through ``make_eval_step`` into the ``Evaluator``, K2
    launching 3 times a batch."""
    from doubly_contrastive_semseg_tpu_torch import Config
    from doubly_contrastive_semseg_tpu_torch.data import DataLoader, get_dataset, to_device
    from doubly_contrastive_semseg_tpu_torch.metrics import Evaluator
    from doubly_contrastive_semseg_tpu_torch.ops import stem
    from doubly_contrastive_semseg_tpu_torch.train import init_eval_accum, make_eval_step

    with tempfile.TemporaryDirectory() as base:
        t0 = time.perf_counter()
        root, lists = profile_host_data.write_acdc_tree(base, ACDC_TRAIN, ACDC_VAL)
        n = profile_host_data.check_acdc_tree(root, lists)
        hw = "x".join(map(str, profile_host_data.ACDC_HW))
        log(f"== 16. ACDC from PNG: {ACDC_TRAIN} train + {ACDC_VAL} val {hw} frames "
            f"written (frames: the five filters in turns down the rows; labels: Pillow's "
            f"filter choice; weathers fog, night, rain, snow) and all {n} "
            f"read back as written, {time.perf_counter() - t0:.1f} s")
        cfg = Config(dataset="acdc", data_root=root, filelist_root=lists, criterion=CRITERION,
                     batch_size=TRAIN_BATCH, num_workers=4, use_gamma_correction=True)
        check(cfg.host_augment and cfg.crop_wh == (TRAIN_CROP, TRAIN_CROP)
              and cfg.val_wh == (VAL_WIDTH, VAL_HEIGHT), "the ACDC phase's recipe")
        train_dst, val_dst = get_dataset(cfg, seed=cfg.random_seed)
        check(len(train_dst) == ACDC_TRAIN and len(val_dst) == ACDC_VAL, "the ACDC lists")
        model = host_fed_steps(torch, dev, cfg, train_dst, "ACDC from PNG", workers=(4, 1))

        check(cfg.val_batch_size == 8 and ACDC_VAL == 12, "the val batches of 8 and 4")
        log("  K2 at the shapes this val split gives it (the levels of 1920x1080 batches "
            "of 8 and 4) vs stem_pool_reference:")
        profile_stem.check_routes(torch.Generator().manual_seed(16), dev, log,
                                  shapes=profile_stem.VAL_1080_SHAPES)
        loader = DataLoader(val_dst, cfg.val_batch_size, shuffle=False,
                            num_workers=cfg.num_workers)
        step = make_eval_step(model, cfg)
        accum = init_eval_accum(cfg, device=dev)
        stem.fused_stem_pool.launches = 0
        frames, t_start, step_s = 0, time.perf_counter(), 0.0
        for i, batch in enumerate(loader):
            before = stem.fused_stem_pool.launches
            t0 = time.perf_counter()
            preds, accum = step(to_device(batch, dev), accum)
            torch.cuda.synchronize()
            step_s += time.perf_counter() - t0
            k2 = stem.fused_stem_pool.launches - before
            b = batch["left"].shape[0]
            frames += b
            log(f"  val batch {i}: {b} frames {tuple(batch['left'].shape[1:3])}, weathers "
                f"{batch['weather'].tolist()}, launches K2 {k2}")
            check(k2 == 3, "each ACDC val batch must launch K2 3 times")
            check(tuple(preds.shape) == (b, VAL_HEIGHT, VAL_WIDTH), "the val predictions' shape")
        wall = time.perf_counter() - t_start
    check(frames == ACDC_VAL, "the val loader must deliver every frame once")
    host = {k: v.cpu() for k, v in accum.items()}
    evaluator = Evaluator(cfg.num_classes, cfg.weather_num)
    evaluator.merge_device_batch(host["cm"], host["cm_weather_sem"], host["cm_weather"],
                                 weather_acc=float(host["weather_acc_sum"])
                                 / max(float(host["n_batches"]), 1.0))
    miou = evaluator.Mean_Intersection_over_Union()
    check(miou == miou and 0 <= miou <= 1, f"mIoU {miou}")
    check(float(host["cm"].sum()) > 0, "the confusion matrix counted no pixel")
    log(f"  ACDC val: {frames} frames, {frames / wall:.2f} frames/s end to end (PNG decode "
        f"included), {frames / step_s:.2f} in to_device and the eval steps; mIoU {miou:.5f}; "
        f"K2 launches {stem.fused_stem_pool.launches}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    try:
        from doubly_contrastive_semseg_tpu_torch import Config, build_model, make_serving_fn
        from doubly_contrastive_semseg_tpu_torch.ops import _build, contrastive, seghead, stem
        from doubly_contrastive_semseg_tpu_torch.tools import (
            profile_blend, profile_contrastive, profile_host_data, profile_jfa, profile_seghead,
            profile_stem)
        from doubly_contrastive_semseg_tpu_torch.train import (
            TrainState, build_optimizer, compute_loss, make_train_step)
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable here: {e}",
              file=sys.stderr)
        return 1
    log(f"== 0. host libraries importable here (the port uses none): {host_libraries()}")
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
    sources = ["stem_pool_tc", "stem_pool", "seghead_tc", "seghead", "row_stats", "pos_sweep",
               "contrastive", "blend", "blend_mma", "jfa"]
    build_logs = _build.build(sources)
    log(f"  built {', '.join(f'csrc/{n}.cu' for n in sources)} for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  ptxas[{name}]: {line.strip()}")
    gen = torch.Generator().manual_seed(0)

    # 2-3. each kernel against its plain version
    log("== 2. stem kernels (K2: bf16 tensor cores, f32 CUDA cores) vs stem_pool_reference")
    stem_err = profile_stem.check_routes(gen, dev, log)
    log("== 3. head kernels (K1: bf16 tensor cores, f32 CUDA cores) vs seghead_reference")
    head_dis = profile_seghead.check_routes(gen, dev, log)

    # 4. the serving path at full width
    log(f"== 4. serving SwiftNet-RN18 {WIDTH}x{HEIGHT} batch {BATCH} bf16")
    model = build_model(Config(), device=dev, seed=0)
    randomize_bn(model, torch.Generator().manual_seed(1))
    model.to(dev)
    serve = make_serving_fn(model, device=dev)
    image = torch.randint(0, 256, (BATCH, HEIGHT, WIDTH, 3), generator=gen).to(
        device=dev, dtype=torch.bfloat16)
    head_fn = seghead.fused_seghead_upsample_argmax
    for counter in ("launches", "tc_launches", "cc_launches"):
        setattr(stem.fused_stem_pool, counter, 0)
        setattr(head_fn, counter, 0)
    labels = serve(image)
    torch.cuda.synchronize()
    launches = {"fused_stem_pool": stem.fused_stem_pool.launches,
                "fused_seghead_upsample_argmax": head_fn.launches}
    routes = {"stem": {"tensor cores": stem.fused_stem_pool.tc_launches,
                       "CUDA cores": stem.fused_stem_pool.cc_launches},
              "head": {"tensor cores": head_fn.tc_launches, "CUDA cores": head_fn.cc_launches}}
    log(f"  launches in one serve call: {launches}; routes {routes}")
    check(launches == {"fused_stem_pool": 3, "fused_seghead_upsample_argmax": 1},
          "the serving path must launch the stem kernel 3 times and the head once")
    check(routes == {"stem": {"tensor cores": 3, "CUDA cores": 0},
                     "head": {"tensor cores": 1, "CUDA cores": 0}},
          "the bf16 serving path must take the tensor-core stem 3 times and head once")
    check(labels.shape == (BATCH, HEIGHT, WIDTH) and labels.dtype == torch.int8,
          f"labels {tuple(labels.shape)} {labels.dtype}")
    check(0 <= labels.min().item() and labels.max().item() < 19, "label range")
    layouts_check(torch, serve, image, labels, stem, seghead)

    # the same weights on the plain path, on the card
    plain = build_model(Config(fuse_stem=False), device=dev, seed=0)
    plain.load_state_dict(model.state_dict())
    head = plain.net.segmentation
    with torch.no_grad():
        feat_p = plain.net.feature_extractor(image)[0].permute(0, 2, 3, 1)
        feat_k = model.net.feature_extractor(image)[0].permute(0, 2, 3, 1)
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

    # sizes the fused head does not serve (4 × the features is not the
    # image): the argmax of the full-resolution logits, as in JAX
    odd = torch.randint(0, 256, (1, 1022, 2046, 3), generator=gen).to(dev, torch.bfloat16)
    before = (stem.fused_stem_pool.launches, seghead.fused_seghead_upsample_argmax.launches)
    lab_odd = serve(odd)
    torch.cuda.synchronize()
    k2_odd = stem.fused_stem_pool.launches - before[0]
    k1_odd = seghead.fused_seghead_upsample_argmax.launches - before[1]
    log(f"  1 x 1022 x 2046 bf16: labels {tuple(lab_odd.shape)} {lab_odd.dtype}, "
        f"launches K2 {k2_odd}, K1 {k1_odd}")
    check(lab_odd.shape == (1, 1022, 2046) and lab_odd.dtype == torch.int8 and k1_odd == 0
          and k2_odd == 3 and 0 <= lab_odd.min().item() and lab_odd.max().item() < 19,
          "serving 1022 x 2046 must give int8 labels through K2 3 times and K1 never")
    x_odd = torch.randint(0, 256, (1, 254, 510, 3), generator=gen).float()
    lab_gpu = make_serving_fn(small, device=dev)(x_odd.to(dev)).cpu()
    lab_cpu = make_serving_fn(cpu, device="cpu")(x_odd)
    agree_odd = (lab_gpu == lab_cpu).float().mean().item()
    log(f"  1 x 254 x 510 f32 vs the CPU path: labels {tuple(lab_gpu.shape)}, "
        f"agreement {agree_odd:.6f} (bar 0.999)")
    check(lab_gpu.shape == lab_cpu.shape == (1, 254, 510) and agree_odd >= 0.999,
          "serving 254 x 510 on the card disagrees with the CPU path")
    del small, cpu, odd, lab_odd

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
    sc, sh = model.net.feature_extractor.bn1_0.folded()
    st = profile_stem.time_levels(gen, dev, model.net.feature_extractor.conv1.weight, sc, sh,
                                  log)
    kernels.append({
        "name": "fused_stem_pool", "route": "cuda",
        "source": "doubly_contrastive_semseg_tpu_torch/csrc/stem_pool_tc.cu",
        "replaces": "doubly_contrastive_semseg_tpu/ops/stem_pallas.py:123",
        "launches": launches["fused_stem_pool"], "max_abs_err": stem_err,
        "ms": st["ms"], "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
        "bound_by": st["bound_by"], "library_ms": None})

    ht = profile_seghead.time_head(gen, dev, log)
    check(ht["ms"] < ht["cc_ms"], "the tensor-core head is not faster than the CUDA-core "
          "head on the same bf16 inputs")
    kernels.append({
        "name": "fused_seghead_upsample_argmax", "route": "cuda",
        "source": "doubly_contrastive_semseg_tpu_torch/csrc/seghead_tc.cu",
        "replaces": "doubly_contrastive_semseg_tpu/ops/seghead_pallas.py:164",
        "launches": launches["fused_seghead_upsample_argmax"],
        "max_abs_err": head_dis, "ms": ht["ms"], "plain_ms": ht["plain_ms"],
        "bound_ms": ht["bound_ms"], "bound_by": ht["bound_by"], "library_ms": None})

    del model, serve, image, labels
    torch.cuda.empty_cache()

    # 6. the contrastive kernels
    log("== 6. contrastive kernels (K3 row stats, K4 positive sweep) vs their plain "
        "versions, f32")
    k3_err, k4_check, k_times = contrastive_phase(torch, contrastive, profile_contrastive,
                                                  gen, dev)

    # 7-8. training
    flagship_phase(torch, gen, dev)
    card_vs_cpu_phase(torch, gen, dev)
    dense_launches = dense_phase(torch, gen, dev)

    kernels.append({
        "name": "contrastive_row_stats", "route": "cuda",
        "source": "doubly_contrastive_semseg_tpu_torch/csrc/row_stats.cu",
        "replaces": "doubly_contrastive_semseg_tpu/ops/contrastive_pallas.py:235",
        "launches": dense_launches["contrastive_row_stats"], "max_abs_err": k3_err,
        "ms": k_times["ms"], "plain_ms": k_times["plain_ms"],
        "bound_ms": k_times["bound_ms"], "bound_by": k_times["bound_by"],
        "library_ms": None})
    kernels.append({
        "name": "pos_sweep_layout", "route": "cuda",
        "source": "doubly_contrastive_semseg_tpu_torch/csrc/pos_sweep.cu",
        "replaces": "doubly_contrastive_semseg_tpu/ops/contrastive_pallas.py:510",
        "launches": dense_launches["pos_sweep_layout"],
        "max_abs_err": k4_check["layout_max_abs_err"],
        "ms": k_times["layout_ms"], "plain_ms": k_times["layout_plain_ms"],
        "bound_ms": k_times["layout_bound_ms"], "bound_by": k_times["layout_bound_by"],
        "library_ms": k_times["layout_library_ms"]})
    kernels.append({
        "name": "pixel_contrast_pos_sweep", "route": "cuda",
        "source": "doubly_contrastive_semseg_tpu_torch/csrc/pos_sweep.cu",
        "replaces": "doubly_contrastive_semseg_tpu/ops/contrastive_pallas.py:510",
        "launches": dense_launches["pixel_contrast_pos_sweep"],
        "max_abs_err": k4_check["max_abs_err"],
        "ms": k_times["k4_ms"], "plain_ms": k_times["k4_plain_ms"],
        "bound_ms": k_times["k4_bound_ms"], "bound_by": k_times["k4_bound_by"],
        "library_ms": None})

    # 9-10. eval
    log("== 9. blend kernel (K5) vs upsample_blend_reference")
    blend_err, blend_t = blend_phase(torch, profile_blend, gen, dev)
    eval_launches = eval_phase(torch, gen, dev)
    kernels.append({
        "name": "fused_upsample_blend", "route": "cuda",
        "source": "doubly_contrastive_semseg_tpu_torch/csrc/blend_mma.cu",
        "replaces": "doubly_contrastive_semseg_tpu/ops/blend_pallas.py:96",
        "launches": eval_launches["fused_upsample_blend"], "max_abs_err": blend_err,
        "ms": blend_t["ms"], "plain_ms": blend_t["plain_ms"], "bound_ms": blend_t["bound_ms"],
        "bound_by": blend_t["bound_by"], "library_ms": None})

    # 11-13. the loader-fed data path
    jf_err, jf_t = jfa_phase(torch, profile_jfa, gen, dev)
    model, cfg, val_dst, jf_launches = loader_train_phase(torch, dev)
    loader_eval_phase(torch, dev, model, cfg, val_dst)
    del model

    # 14-16. the default (host-augmented) input path
    host_data_phase(profile_host_data)
    host_augment_phase(torch, dev)
    acdc_phase(torch, dev, profile_host_data, profile_stem)
    kernels.append({
        "name": "nearest_diff_label_distance", "route": "cuda",
        "source": "doubly_contrastive_semseg_tpu_torch/csrc/jfa.cu",
        "replaces": "doubly_contrastive_semseg_tpu/ops/edt.py:88",
        "launches": jf_launches, "max_abs_err": jf_err, **jf_t})

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
