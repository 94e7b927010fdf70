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
against the CPU path, whole and block by block, each block with the CPU's
ReLU gates forced on the card (its inputs within rounding of 0 and the
gates the card would flip counted and logged, the unforced gradients
logged too) (phase 7); and the same step
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
prints which of PIL, cv2, scipy, sklearn, matplotlib, visdom and grain
import (the port reads JPEG files and runs ``ColorJitter``, the flips and
``RandomAffine`` through PIL, draws with sklearn and matplotlib, and uses
neither cv2, scipy nor grain); phase 4 also serves the batch in the planar
and space-to-depth layouts.

Then the default input path (``host_augment=True``), all of it host code:
the times on the card's host of ``read_png`` on a 1080×1920 frame by PNG
filter, the crop-and-scale at three box scales and the chamfer EDT weights
of a 768² crop (phase 14, ``tools/profile_host_data.py``); two epochs of
2 flagship steps (4 loader threads, then 1) fed by the synthetic
1024×2048 dataset through the host train transforms (768² crops, two
views, EDT weights on the host, no kernel launched), timed by stage (phase
15); and an ACDC tree of 1080×1920 PNGs written with ``write_png`` (every
frame with the five filters in turns down its rows, night frames, the
file lists), read back exactly, trained on for an epoch of 2 steps (1
loader thread) through ``get_dataset("acdc")`` with gamma on, K2
held to its plain version at the levels of 1920×1080 batches of 8 and 4,
and the val split through ``make_eval_step`` into the ``Evaluator``, K2
launching 3 times a batch (phase 16).

Then the runtime through the port's CLIs, with a generator of its own
(phase 17): ``main(argv)`` in process on the default host-augmented route
at the published recipe (synthetic 1024×2048 frames, 768² crops, batch 8 ×
2 views, bf16, ``supcon_pixelcontrast_focal``, ADAM, one loader thread, 2
epochs of 2 steps, validating each), its run directory, finite losses in
``metrics.jsonl``, K2 3 times a val batch and held to its plain version at
the val split's levels, and checkpoint save and restore times (a); a
``--resume latest_checkpoint --continue_training`` third epoch, the
restored optimizer state equal to the saved one and every group's lr the
schedule's (b); ``--test_only --resume score_best_checkpoint``, the
restored weights bit for bit the saved ones, K2 at the batch-1 levels (c);
``--no_host_augment``, JF 88 times a step, then the CLI as a subprocess
SIGTERM'd after its second step, which must exit with 143 within 60 s
leaving a ``rescue_checkpoint`` that resumes at the next epoch (d); the SGD
recipe for one epoch, every trained group moved and no frozen parameter
(e); and the inference CLI on 4 PNG frames of 1080×1920 from the best
checkpoint at bf16 and f32, K2 3 times an image and held at those levels,
its labels against the same checkpoint with the plain stem in process:
f32 on 0.999 of pixels, bf16 on 0.99 of those whose f32 top-two logit gap
exceeds twice the plain stem's bf16 logit error, in each frame and in its
last 16 rows (f).

Last, the DeepLab family and ENet (phase 18, its own generator):
``deeplabv3plus_resnet101`` at the published recipe (768², batch 8 × 2
views or the largest that fits, bf16, 4 steps), then one small f32 step on
the card against the CPU from the same weights and dropout masks, and its
dilated bottlenecks and ASPP one at a time, to phase 7b's tolerances (a);
the same model at the dense-contrast size (batch 216 on 96²), K3 4 and K4
3 launches a step at D = 2048, the kernel route's loss and dZ against the
plain route's on one step's anchors to a tolerance scaled by the logits'
size, then K3 and K4 alone at N = 8208 and D = 320, 480, 720 and 2048,
held to their plain versions and timed (b); its eval step and the
generic serving branch at 2048×1024 batch 8 bf16 with no K1, K2 or K5
launch, and f32 serving labels card vs CPU (c); every other ported DeepLab
name and ENet for one bf16 train step and one eval batch (d); and ``main
--model deeplabv3plus_resnet101`` for an epoch of 2 steps, ``--test_only``
on its checkpoint and ``inference`` on 2 PNGs (e).

Then the six other WeatherNet backbones (phase 19, its own generator):
``resnet18_single`` at full width (SPP at 3 levels of the (8, 4, 2, 1)
grids, 128 features, 19 classes), random weights, serving 2048×1024 × 8 bf16
through K1 once a batch, its labels against the plain head on the same
features on 0.99 of the decided pixels (PR 13's rule) and, at f32, on
0.9999 of the pixels, serving and eval frames/s (no K1, K2 or K5 launch in
eval); the published recipe step (768², batch 8 × 2 views, bf16, no kernel),
one small f32 step card vs CPU and its SPP (34 × 60, a 1080×1920 frame's
layer 4: unequal windows) and an upsample step one at a time, the CPU's
ReLU gates forced as in phase 7; the dense-contrast step (batch 216 on 96²), K3
4 and K4's layout and sweep once a step, the kernel route's loss and dZ
against the plain route's, then K3 and K4 alone at its N and D (a); each of ``resnet18_hourglass``,
``resnet18_rgbd``, ``resnet18_back``, ``mobilenetv2`` and ``efficientnetb0``
for two bf16 train steps at 2 × 2 views of 256², one eval batch (the
hourglass's disparity convs not called) and one f32 1024×512 serving batch
through K1 against the plain head (b); ``main --model resnet18_single`` for
an epoch of 2 steps and 4 val frames, and ``inference`` on 4 PNGs of
1080×1920 (c).

Then the datasets ``main`` took last (phase 20): trees of PNGs at the real
sizes written with ``write_png`` (Cityscapes with right frames and
Lost&Found with its black border, 1024×2048; ACDC, 1080×1920), read back as
written, then ``main`` at full width (``resnet18``, bf16, host crops, one
loader thread, an epoch of 2 steps, validation at 1920×1080, K2 3 times a
val batch) on ``cityscapes`` (a), ``acdc_city --weather_num 5`` with the
flagship criterion and its per-weather mIoU keys 0-4 (b), ``city_lost
--new_crop`` (``CropBlackArea``, 1024×512 crops, 20 classes), fused and
``--not_md_fusion`` (c); the runs that read a weather these datasets lack,
refused (d); and the inference CLI at f32 on 2 JPEGs of 1080×1920, whose
labels equal those of the same pixels saved as PNG (e); K2 held to its
plain version at these shapes.

Last, the grain loader and the tools (phase 21): ``main --loader grain
--no_host_augment`` at full width (synthetic 1024×2048 frames, 768² crops
on the card, ``main``'s batch 8 × 2 views, bf16, 2 epochs of 4 steps) in
process, the same run as a subprocess SIGKILLed once its third step has
logged (``--rescue_interval 2``), and the resume from its rescue
checkpoint: the rescue is mid-epoch at ``num_iter`` 2, the resume trains
epoch 0's last 2 steps and epoch 1's 4 on exactly the uninterrupted run's
samples, JF 88 times a step, within stated tolerances of its losses and
parameters (a); ``main --tsne`` on the flagship over 24 whole frames,
image mode, K2 3 times a batch, ``tsne.png`` (or, without sklearn or
matplotlib, ``run`` raising ``ImportError`` naming it), the feature pass in
both modes and one batch's features card vs CPU at f32 (b);
``model_complexity`` of the flagship at 768² and the EDT visualizer's PNGs
(c). Phase 0 also says whether sklearn, matplotlib, visdom and grain
import there, each in a fresh interpreter (the port needs none of them to
train).

Then stereo serving (phase 22): ``StereoDCSS`` at the JAX package's stereo
benchmark configuration (resnet18 trunk over both views, the correlation
volume at max_disp 192, adaptive aggregation with the window deformable
convs, soft-argmin, the ``disp_sem`` ``SemRefine`` head, 2048×1024, batch 2,
bf16; random weights with BN and the offset convs randomised) through
``build_stereo_model`` and ``make_stereo_serving_fn``, on NHWC and s2d
input: K2 4 times a batch (3 trunk levels, the refinement's stem) and K1
once, against the same weights with the plain stem and head on the card,
frames/s with ``bench.py``'s protocol and the peak memory (a); at f32 and
256×512 the card's CUDA-core routes against the CPU (b); the gather form
of the deformable convs against the window form at full width, the
offsets inside the window, with both times (c); ``inference --stereo`` on
two 375×1242 pairs padded to 384×1248 at f32 and bf16, its 16-bit PNGs
read back and held to the same forward in process (d).

Then the rest of stereo serving (phase 23), at the same widths (max_disp
192, the published channel counts), random weights with the BN (3-D too)
randomised and each deformable conv's offsets scaled to 1 px on average:
``psmnet_hg`` (the concat volume, PSMNet's stacked hourglass) with the
``hourglass`` refinement (warp error, three gather-form deformable convs)
and the seg head at 2048×1024, batch 2, bf16, NHWC and s2d: K2 3 times a
batch (no stem in the refinement) and K1 once, against the plain stem and
head, frames/s, peak memory and the times of the first Conv3d and of the
full-resolution deformable ``conv_start`` (a); ``stereonet``,
``psmnet_basic`` and ``gcnet`` with ``stereodrnet`` at 1280×384 (KITTI
padded to GCNet's multiple of 64), batch 1, bf16: ms a pair, peak memory
(b); f32 at 512×256 card vs CPU, each aggregation and each refinement (c);
``inference --stereo`` with ``psmnet_hg`` and ``hourglass`` on the KITTI-
sized pairs at f32 and bf16 (d).

Then stereo training (phase 24), on trees the script renders into a
temporary directory (right views rendered from the left by a disparity
that grows down the rows): ``main --dataset sceneflow --criterion none``
at the defaults (``StereoDCSS`` resnet18, max_disp 192, adaptive
aggregation with window deformable convs, the StereoNet refinement, bf16;
24 + 8 PNG pairs of 960×540 with PFM disparities of both byte orders;
288×576 crops at batch 8, validation at 960×576, 2 epochs), then its
``--continue_training`` resume (the next epoch, ``best_epe`` restored) and
``--test_only`` (no checkpoint written) (a); ``main --dataset kitti_2015
--train_semantic --resume`` (a)'s best checkpoint, the semantic-guided
refinement and the seg head on 16 + 8 pairs of 1242×375 with 16-bit
disparity PNGs (30 % valid) and Cityscapes-id labels (b); 3 steps of
``make_stereo_train_step`` for each 3-D aggregation at 512×256 × 2 bf16 (c);
one f32 step at 256×128 × 2 on the card against the CPU (losses,
disparity, BN statistics, the gate-free gradients) and blocks with the
CPU's ReLU gates forced, the StereoNet 3-D aggregation among them (d);
``inference --stereo --resume`` (b)'s checkpoint on two KITTI pairs at
bf16 and f32, its PNGs against the forward in process (e). K2 launches 3
times a val batch and an inference pair, on tensor cores at bf16, and
never in a train step; it is held against ``stem_pool_reference`` on
each route at the levels of the val batches (a, b) and of the inference
pairs (e); ms a step with the loader's wait, EPE, D1 and >1 px, peak
memory.

Then the legacy stereo modules (phase 25): every ``make_stereo_feature``
kind, both ``MobileNetV2Feature`` decoders, ``SegmentationBranches``,
``SegmentationDeeplabV3`` and ``SimpleSegmentation`` on the trunk's maps,
and ``DisparityFeature``, at 384×1248 × 1 bf16 (ms a forward, peak memory;
random offsets on GANet's deformable convs), then at f32 96×96 on the card
against the CPU; no kernel lies on this path and none launches.

Then ``--num_devices`` (phase 26): the one H100 is one card and NCCL
refuses two ranks on one device, so two ranks share ``cuda:0`` over gloo,
through the same step and collectives the trainers use
(``tools/check_parallel.py``): the flagship step at f64, f32 and bf16 and
the stereo step at f32 against one process on the global batch (f64: loss,
parameters and BN statistics within 1e-5 of max; f32: loss 1e-5, BN
statistics 1e-4; bf16: loss 1e-2), the dense-contrast step of 216 samples whose 8208
gathered anchor rows take K3 and K4 on each rank where each rank's 4104
would not, and the eval and stereo validation sums (K2 counted on each
rank); one NCCL world-size-1 run of ``main``'s rank entry; ``main
--num_devices 2`` on this one-card machine refused with ``ValueError``.

Last, the ``('data', 'model')`` grid (phase 27): the width-split eval
forward and serving of ``DCSSModel`` (resnet18) at 2048×1024 × 1 on (1, 2)
and (1, 4) grids of ranks sharing ``cuda:0`` over gloo, through
``tools/check_parallel.py``'s ``spatial`` case, at f32 and bf16 on (1, 2)
and at f32 on (1, 4) (``SPATIAL_DTYPES``: the script's time), against one
process: K2 and K1 first held to their plain versions at every window the
grids give them, then the f32 maps and weather logits within 1e-4 of max,
the weather logits equal on every rank, the bf16 labels on decided pixels
and the bf16 grid's distance from the f32 forward against one process's,
K2 ×3 a forward and K2 ×3 + K1 ×1 a serve on every rank on its dtype's
route, ms a forward and peak memory of each rank and of one process.

Any failure raises and exits non-zero; so does a machine without CUDA or a
directory without the package. The last line is ``{"ok": true, "device":
{...}}``; the line before it lists each kernel's launches, error and times.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import pathlib
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
HOST_SIZE = 16                          # host-augmented synthetic: 2 steps an epoch
ACDC_TRAIN, ACDC_VAL = 16, 12           # ACDC from PNG: 2 steps an epoch, val batches 8 + 4
RUNTIME_SIZE, INFER_FRAMES = 16, 4      # phase 17: 2 steps an epoch, a val split of 4 frames
DEEPLAB = "deeplabv3plus_resnet101"     # phase 18: the DeepLab family's flagship
DEEPLAB_STEPS = 4
DEEPLAB_SMALL = (4, 128)                # 18a's card-vs-CPU f32 step: batch, crop
OTHER_CROP = 256                        # 18d, 19b: the other names' train step
SWIFT = "resnet18_single"               # phase 19: the single-scale SwiftNet
SWIFT_FAMILY = ("resnet18_single", "resnet18_hourglass", "resnet18_rgbd", "resnet18_back",
                "mobilenetv2", "efficientnetb0")
# phase 20's trees: Cityscapes and Lost&Found frames of 1024x2048, ACDC's of
# 1080x1920 (the val frames cover the four weathers); 2 steps an epoch
CITY_TRAIN, CITY_VAL, ACDC20_TRAIN, ACDC20_VAL, LF_TRAIN, LF_VAL = 4, 2, 2, 4, 4, 2
JPEG_FRAMES = 2
# phase 22: the JAX package's stereo benchmark (scripts/bench_stereo.py:33-47, 59-61, 82):
# StereoDCSS, resnet18, max_disp 192, adaptive aggregation (window), disp_sem, 2 x 2048x1024
STEREO_BATCH, STEREO_MAX_DISP, STEREO_SHIFT = 2, 192, 24
STEREO_SMALL = (256, 512)               # 22b: f32, the card's kernel routes vs the CPU
KITTI_HW, KITTI_PAD = (375, 1242), (384, 1248)   # 22d: KITTI frames, padded as JAX pads them
OFFSET_STD = 0.12                       # 22: random offset convs, offsets well inside ±2 px
STEREO_DISP_BAR = 1.0                   # 22a, 22c: mean |Δdisparity| bar, pixels
# phase 25: the legacy stereo modules at KITTI's padded frame (a multiple of
# 48, which GANet's /3 U-net needs, and of 16), and the card-vs-CPU side
LEGACY_HW, LEGACY_SMALL = (384, 1248), 96
# phase 26: the dense-contrast step on two ranks (216 · 19 · 2 = 8208 rows)
PARALLEL_DENSE = (216, 96)
# phase 27: the width-split forward at the full frame, one image, and its grids
SPATIAL = (1, 1024, 2048)
SPATIAL_GRIDS = ((1, 2), (1, 4))
SPATIAL_DTYPES = {(1, 2): ("float32", "bfloat16"), (1, 4): ("float32",)}   # the script's time
SPATIAL_ITERS = 3
# phase 23: the 3-D aggregations and warp-error refinements at the same widths
KITTI_GCNET = (384, 1280)               # 23b: KITTI's 1242x375 padded to GCNet's multiple of 64
STEREO_3D_PAIRS = (("stereonet", "hourglass"), ("psmnet_basic", "stereodrnet"),
                   ("psmnet_hg", "stereodrnet"), ("gcnet", "hourglass"))   # 23c


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


_T0 = time.perf_counter()


def log(*args) -> None:
    """Prints ``args``; a phase's header line ("== ...") with the seconds
    since the script started in front, so the phases' times can be read."""
    if args and str(args[0]).startswith("== "):
        args = (f"[{time.perf_counter() - _T0:.1f} s]",) + args
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
        if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)):
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


class ReluGates:
    """Every ``torch.relu`` of a block's forward and backward (checkpointed
    recomputes included), in call order. ``record()`` keeps each input's
    gate (input > 0) and counts the inputs within ``NEAR`` x max|input| of
    0, which the card's and the CPU's rounding may put on either side;
    ``force()`` replays the recorded gates in the same order (input x gate,
    whose gradient passes where the recorded gate is open) and counts the
    inputs whose own sign disagrees with it: the gates the card would have
    flipped."""

    NEAR = 1e-5

    def __init__(self, torch):
        self.torch, self.real = torch, torch.relu
        self.gates, self.inputs, self.near, self.flips = [], 0, 0, 0

    def _recording(self, x):
        with self.torch.no_grad():
            self.gates.append((x > 0).cpu())
            self.inputs += x.numel()
            self.near += int((x.abs() <= self.NEAR * x.abs().max()).sum())
        return self.real(x)

    def _forced(self, x):
        i = self.calls
        self.calls += 1
        check(i < len(self.gates) and tuple(self.gates[i].shape) == tuple(x.shape),
              f"ReLU call {i} {tuple(x.shape)} does not replay the recorded calls")
        gate = self.gates[i].to(x.device)
        with self.torch.no_grad():
            self.flips += int(((x > 0) != gate).sum())
        return x * gate.to(x.dtype)

    def _patched(self, fn):
        @contextlib.contextmanager
        def ctx():
            self.torch.relu = fn
            try:
                yield self
            finally:
                self.torch.relu = self.real
        return ctx()

    def record(self):
        return self._patched(self._recording)

    def force(self):
        self.calls = 0
        return self._patched(self._forced)


def block_errors(torch, block, inputs, dev, gen):
    """One training-mode forward and backward of ``block`` (a CPU module) on
    the CPU, recording its ReLU gates, and on the card twice, as it runs
    and with the CPU's gates forced, from the same inputs and output
    cotangent. Returns the forced run's largest error of the output, of
    each input's and each parameter's gradient (all relative to the
    tensor's max) and of the BN running stats; the unforced run's gradient
    error; the ReLU inputs, those within rounding of 0 and the gates the
    card flips."""
    gates = ReluGates(torch)
    cot = []

    def run(where, ctx):
        m = copy.deepcopy(block).to(where).train()
        xs = [x.detach().to(where, copy=True).requires_grad_(True) for x in inputs]
        with ctx:
            y = m(*xs)
            if not cot:
                cot.append(torch.randn(y.shape, generator=gen))
            y.backward(cot[0].to(where).contiguous(memory_format=torch.channels_last)
                       if y.dim() == 4 else cot[0].to(where))
        return (y, [x.grad for x in xs], {k: p.grad for k, p in m.named_parameters()},
                {k: v for k, v in m.state_dict().items() if k.endswith("running_var")
                 or k.endswith("running_mean")})

    y_c, gx_c, gp_c, st_c = run("cpu", gates.record())
    _, gx_u, gp_u, _ = run(dev, contextlib.nullcontext())
    y_d, gx_d, gp_d, st_d = run(dev, gates.force())
    check(gates.calls == len(gates.gates), "the card ran fewer ReLUs than the CPU")

    def grads(gx, gp):
        return max([rel_err(torch, g, w) for g, w in zip(gx, gx_c)]
                   + [rel_err(torch, gp[k], gp_c[k]) for k in gp_c])

    return {"output": rel_err(torch, y_d, y_c), "grads": grads(gx_d, gp_d),
            "stats": max([rel_err(torch, st_d[k], st_c[k]) for k in st_c], default=0.0),
            "grads_unforced": grads(gx_u, gp_u), "relu_inputs": gates.inputs,
            "near_zero": gates.near, "flips": gates.flips}


def log_block(name, errs, what=""):
    """Logs a block's card-vs-CPU errors and ReLU counts; holds the forced
    run at 1e-4 (output, stats) and 1e-3 (gradients) of each max."""
    log(f"  block {name} card vs CPU, the CPU's ReLU gates forced: output "
        f"{errs['output']:.2e}, gradients {errs['grads']:.2e}, running stats "
        f"{errs['stats']:.2e} of max|.| (tolerances 1e-4, 1e-3, 1e-4); unforced gradients "
        f"{errs['grads_unforced']:.2e} (not held); ReLU inputs {errs['relu_inputs']}, within "
        f"{ReluGates.NEAR:g} x max of 0 on the CPU {errs['near_zero']}, gates the card "
        f"flips {errs['flips']}")
    check(errs["output"] <= 1e-4 and errs["grads"] <= 1e-3 and errs["stats"] <= 1e-4,
          f"{what}block {name}: the card disagrees with the CPU")


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
        log_block(name, block_errors(torch, block, inputs, dev, gen))
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


HOST_LIBRARIES = ("PIL", "cv2", "scipy", "sklearn", "matplotlib", "visdom", "grain")


def host_libraries() -> dict:
    """Which of ``HOST_LIBRARIES`` import here, each tried in a fresh
    interpreter of its own so that none of them loads into this one (or
    into another's try, all at once): {name: True, or the error's last
    line}."""
    procs = {m: subprocess.Popen([sys.executable, "-c", f"import {m}"], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for m in HOST_LIBRARIES}
    ok = {}
    try:
        for m, proc in procs.items():
            _, stderr = proc.communicate(timeout=120)
            err = stderr.strip().splitlines()
            ok[m] = True if proc.returncode == 0 else (err[-1][:160] if err
                                                       else f"exit {proc.returncode}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return ok


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
        "threads, epoch 1 finds them cached, with 1")
    train_dst, _ = get_dataset(cfg, seed=cfg.random_seed)
    host_fed_steps(torch, dev, cfg, train_dst, "host-augmented synthetic", workers=(4, 1))


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
        model = host_fed_steps(torch, dev, cfg, train_dst, "ACDC from PNG", workers=(1,))

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


def count_launches(stem, edt, contrastive, seghead, blend):
    """(reset, read) of every kernel wrapper's launch count."""
    fns = (stem.fused_stem_pool, edt.nearest_diff_label_distance,
           contrastive.contrastive_row_stats, contrastive.pos_sweep_layout,
           contrastive.pixel_contrast_pos_sweep, seghead.fused_seghead_upsample_argmax,
           blend.fused_upsample_blend)

    def reset():
        for fn in fns:
            fn.launches = 0
        stem.fused_stem_pool.tc_launches = stem.fused_stem_pool.cc_launches = 0

    def read():
        out = {fn.__name__: fn.launches for fn in fns}
        out["fused_stem_pool_tc"] = stem.fused_stem_pool.tc_launches
        return out

    return reset, read


def expect_launches(got, what, k2=0, jf=0, tc=None):
    """Only K2 (``tc`` of them on tensor cores: all unless given) and JF may
    launch, as many times as given."""
    want = {name: 0 for name in got}
    want.update(fused_stem_pool=k2, fused_stem_pool_tc=k2 if tc is None else tc,
                nearest_diff_label_distance=jf)
    log(f"  {what}: launches {got}")
    check(got == want, f"{what}: launches {got}, expected {want}")


def run_files(path):
    return sorted(os.path.relpath(os.path.join(dp, f), path)
                  for dp, _, fn in os.walk(path) for f in fn)


def scalars(path, tag):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    return [(r["step"], r["value"]) for r in rows if r["tag"] == tag]


def runtime_phase(torch, dev, card, profile_stem):
    """17. The runtime through the port's CLIs (``main``, ``inference``),
    in process and as a subprocess; its own generator. Returns K2's and
    JF's launches on these paths."""
    import logging
    import os
    import signal

    from doubly_contrastive_semseg_tpu_torch import inference as port_inference
    from doubly_contrastive_semseg_tpu_torch import Config, build_model
    from doubly_contrastive_semseg_tpu_torch.config import parse_args
    from doubly_contrastive_semseg_tpu_torch.data import SyntheticDataset, read_png, write_png
    from doubly_contrastive_semseg_tpu_torch.data.labels import TRAIN_ID_TO_COLOR
    from doubly_contrastive_semseg_tpu_torch.main import main as port_main
    from doubly_contrastive_semseg_tpu_torch.ops import blend, contrastive, edt, seghead, stem
    from doubly_contrastive_semseg_tpu_torch.ops.input_pipeline import pyramid_hw
    from doubly_contrastive_semseg_tpu_torch.train import CheckpointManager, Trainer
    from doubly_contrastive_semseg_tpu_torch.train.optimizer import build_lr_schedule
    from doubly_contrastive_semseg_tpu_torch.utils.params import label_params_for_optimizer
    from doubly_contrastive_semseg_tpu_torch.utils.pretrained import merge_state_dict

    gen = torch.Generator().manual_seed(17)   # phase 7 needs the shared draw order kept
    reset, read = count_launches(stem, edt, contrastive, seghead, blend)
    out = {}

    def levels(b, h, w):
        return [(b,) + pyramid_hw(h, w, lv) for lv in range(3)]

    def timed(what, cap_s, fn):
        t0 = time.perf_counter()
        res = fn()
        dt = time.perf_counter() - t0
        check(dt < cap_s, f"{what} took {dt:.1f} s, over its {cap_s} s limit")
        return res, dt

    def finite_losses(path, n):
        losses = scalars(path, "train/total_loss_print_freq")
        check(len(losses) == n and all(np.isfinite(v) for _, v in losses),
              f"{n} finite total_loss values in {path}/metrics.jsonl: {losses}")
        return [v for _, v in losses]

    h, w = (int(v) for v in SYNTHETIC_HW.split("x"))
    with tempfile.TemporaryDirectory() as base:
        common = ["--dataset", "synthetic", "--synthetic_hw", SYNTHETIC_HW,
                  "--synthetic_size", str(RUNTIME_SIZE), "--train_semantic",
                  "--criterion", CRITERION, "--batch_size", str(TRAIN_BATCH),
                  "--print_freq", "1", "--summary_freq", "1", "--run_root", base,
                  "--device", dev.type]

        # a. main(argv) on the default host-augmented route, the published recipe
        argv_a = common + ["--optimizer_policy", "ADAM", "--num_workers", "1", "--epochs", "2",
                           "--checkname", "a"]
        cfg = parse_args(argv_a)
        check(cfg.host_augment and cfg.crop_wh == (TRAIN_CROP, TRAIN_CROP) and cfg.efficient
              and cfg.compute_dtype == "bfloat16" and cfg.use_supcon,
              "phase 17a must run the published recipe on the card")
        log(f"== 17. the runtime through the port's CLIs. a. main: synthetic {SYNTHETIC_HW} "
            f"({RUNTIME_SIZE} train frames, 2 steps an epoch), host crops {TRAIN_CROP}², batch "
            f"{TRAIN_BATCH} x 2 views, bf16, {CRITERION}, ADAM, 1 loader thread, 2 epochs, "
            "validate each")
        reset()
        tr, dt = timed("17a", 300, lambda: port_main(argv_a))
        launches = read()
        n_val = len(tr.val_loader)
        expect_launches(launches, "17a main, 2 epochs", k2=3 * n_val * 2)
        out["k2_validate"] = launches["fused_stem_pool"]
        run = tr.saver.experiment_dir
        files = run_files(run)
        for f in ("args.json", "command.txt", "parameters.txt", "val_results.txt",
                  "metrics.jsonl", "checkpoints/latest_checkpoint",
                  "checkpoints/latest_checkpoint.meta.json", "checkpoints/score_best_checkpoint",
                  "checkpoints/score_best_checkpoint.meta.json"):
            check(f in files, f"17a: {f} missing from the run directory: {files}")
        with open(os.path.join(run, "val_results.txt")) as f:
            epochs = [ln for ln in f if ln.startswith("epoch ")]
        check(len(epochs) == 2, f"17a: 2 epoch lines in val_results.txt: {epochs}")
        finite_losses(run, 4)
        for epoch in range(2):
            steps = [s for s in tr.step_times if s[0] == epoch]
            log(f"  {card}: 17a epoch {epoch}: {tr.epoch_seconds[epoch]:.2f} s (train + "
                f"validate); ms a step (loader wait, step): "
                + ", ".join(f"({1e3 * s[1]:.1f}, {1e3 * s[2]:.1f})" for s in steps))
        for epoch, frames, wall in tr.val_times:
            log(f"  {card}: 17a val epoch {epoch}: {frames} frames {SYNTHETIC_HW}, "
                f"{frames / wall:.2f} frames/s end to end (loader included)")
        log("  K2 at the val split's levels (a batch of "
            f"{len(tr.val_dst)} at {SYNTHETIC_HW}) vs stem_pool_reference:")
        profile_stem.check_routes(gen, dev, log, shapes=levels(len(tr.val_dst), h, w))
        mgr = CheckpointManager(os.path.join(base, "timing"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = mgr.save("latest_checkpoint", tr.state, tr.cur_epochs)
        save_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        mgr.restore(path, tr.state, continue_training=True)
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        log(f"  {card}: checkpoint save {save_ms:.1f} ms, restore (continue_training) "
            f"{restore_ms:.1f} ms, file {os.path.getsize(path) / 1e6:.2f} MB")
        latest = os.path.join(tr.saver.checkpoint_dir, "latest_checkpoint")
        best = os.path.join(tr.saver.checkpoint_dir, "score_best_checkpoint")
        del tr, mgr

        # b. --resume <latest> --continue_training for a third epoch
        saved = torch.load(latest, map_location="cpu", weights_only=True)
        with open(latest + ".meta.json") as f:
            meta = json.load(f)
        argv_b = common + ["--optimizer_policy", "ADAM", "--num_workers", "1", "--epochs", "3",
                           "--checkname", "b", "--resume", latest, "--continue_training"]
        cfg_b = parse_args(argv_b)
        reset()

        def resume_b():
            trb = Trainer(cfg_b, device=cfg_b.device)
            check((trb.cur_epochs, trb.num_iter, trb.state.step)
                  == (meta["epoch"] + 1, meta["num_iter"] + 1, meta["num_iter"]),
                  f"17b: JAX's resume rule: epoch {trb.cur_epochs}, num_iter {trb.num_iter}, "
                  f"step {trb.state.step} from {meta}")
            osd = trb.optimizer.state_dict()
            for i, st in saved["optimizer"]["state"].items():
                for name, v in st.items():
                    check(torch.equal(v.cpu(), osd["state"][i][name].cpu()),
                          f"17b: optimizer state {i}.{name} differs after the restore")
            check([{k: g[k] for k in ("label", "base_lr", "steps_per_epoch")}
                   for g in osd["param_groups"]]
                  == [{k: g[k] for k in ("label", "base_lr", "steps_per_epoch")}
                      for g in saved["optimizer"]["param_groups"]], "17b: the optimizer's groups")
            sd = trb.model.state_dict()
            check(all(torch.equal(sd[k].cpu(), v) for k, v in saved["model"].items()),
                  "17b: the restored weights differ from the saved ones")
            log(f"  17b restored: epoch {trb.cur_epochs}, num_iter {trb.num_iter}, step "
                f"{trb.state.step} (meta {meta['epoch']}, {meta['num_iter']}); "
                f"{len(saved['optimizer']['state'])} optimizer states equal the saved ones")
            for epoch in range(trb.cur_epochs, cfg_b.epochs):     # main's loop
                trb.cur_epochs = epoch
                trb.train()
                trb.validate()
            return trb

        log("== 17b. --resume latest_checkpoint --continue_training, a third epoch")
        trb, dt = timed("17b", 200, resume_b)
        expect_launches(read(), "17b resumed epoch", k2=3 * len(trb.val_loader))
        finite_losses(trb.saver.experiment_dir, 2)
        for g in trb.optimizer.param_groups:
            want = build_lr_schedule(cfg_b, g["steps_per_epoch"], g["base_lr"])(trb.state.step - 1)
            check(g["lr"] == want, f"17b: group {g['label']} lr {g['lr']} vs schedule {want}")
        log(f"  {card}: 17b resumed epoch: {dt:.2f} s with the restore; lr "
            + ", ".join(f"{g['label']} {g['lr']:.6e}" for g in trb.optimizer.param_groups)
            + f" = the schedule at step {trb.state.step - 1}")
        del trb, saved

        # c. --test_only --resume <best>: batch-1 val shapes
        argv_c = common + ["--test_only", "--resume", best, "--checkname", "c"]
        log("== 17c. --test_only --resume score_best_checkpoint")
        reset()
        trc, dt = timed("17c", 120, lambda: port_main(argv_c))
        check(trc.cfg.val_batch_size == 1, "17c: --test_only validates in batches of 1")
        launches = read()
        expect_launches(launches, "17c test_only", k2=3 * len(trc.val_dst))
        out["k2_test_only"] = launches["fused_stem_pool"]
        best_sd = torch.load(best, map_location="cpu", weights_only=True)["model"]
        sd = trc.model.state_dict()
        check(sd.keys() == best_sd.keys() and all(torch.equal(sd[k].cpu(), v)
                                                   for k, v in best_sd.items()),
              "17c: the restored state_dict differs from the saved one")
        check(not os.path.exists(os.path.join(trc.saver.checkpoint_dir, "latest_checkpoint")),
              "17c: --test_only must not save a checkpoint")
        ((_, frames, wall),) = trc.val_times
        log(f"  {card}: 17c test_only: {frames} frames, {frames / wall:.2f} frames/s end to "
            f"end, {1.0 / (sum(trc.time_val) / len(trc.time_val)):.2f} frames/s in the eval "
            f"steps (first skipped); state_dict bit for bit the saved one")
        log("  K2 at the --test_only batch-1 levels vs stem_pool_reference:")
        profile_stem.check_routes(gen, dev, log, shapes=levels(1, h, w))
        del trc, sd, best_sd

        # d. --no_host_augment: JF counted in process, then SIGTERM'd in a subprocess
        argv_d = common + ["--no_host_augment", "--epochs", "1", "--checkname", "d"]
        log("== 17d. --no_host_augment: 1 epoch in process (JF counted), then a subprocess "
            "SIGTERM'd after its second step")
        reset()
        trd, dt = timed("17d", 120, lambda: port_main(argv_d))
        n_steps = len(trd.step_times)
        per_step = len(edt.jfa_launches(TRAIN_CROP, TRAIN_CROP))
        launches = read()
        expect_launches(launches, f"17d in process, {n_steps} steps",
                        k2=3 * len(trd.val_loader), jf=per_step * n_steps)
        out["jf_trainer"] = launches["nearest_diff_label_distance"]
        finite_losses(trd.saver.experiment_dir, n_steps)
        log(f"  {card}: 17d epoch {trd.epoch_seconds[0]:.2f} s; ms a step (loader wait, "
            "step): " + ", ".join(f"({1e3 * s[1]:.1f}, {1e3 * s[2]:.1f})"
                                  for s in trd.step_times))
        del trd
        argv_sig = common + ["--no_host_augment", "--epochs", "3", "--rescue_interval", "1",
                             "--checkname", "sigterm"]
        repo = os.path.dirname(os.path.abspath(__file__))
        proc = subprocess.Popen(
            [sys.executable, "-m", "doubly_contrastive_semseg_tpu_torch.main", *argv_sig],
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")})
        lines, t_start, t_kill = [], time.perf_counter(), None
        try:
            for line in proc.stdout:
                lines.append(line)
                if "][  2/  2]" in line:          # the second step's log line
                    t_kill = time.perf_counter()
                    proc.send_signal(signal.SIGTERM)
                    break
                check(time.perf_counter() - t_start < 240, "17d: the subprocess's second "
                      "step did not come within 240 s: " + "".join(lines[-10:]))
            rest, _ = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        check(t_kill is not None, "17d: the subprocess ended before its second step: "
              + "".join(lines[-20:]))
        exit_s = time.perf_counter() - t_kill
        lines += rest.splitlines(keepends=True)
        logged = sum("Epoch: [" in ln for ln in lines)
        log(f"  17d subprocess: SIGTERM {t_kill - t_start:.1f} s after its start, exit code "
            f"{proc.returncode} {exit_s:.2f} s later (limit 60 s); {logged} steps logged")
        check(proc.returncode == 143 and exit_s < 60,
              "17d: SIGTERM must exit with 143 within 60 s: " + "".join(lines[-20:]))
        (sig_run,) = [dp for dp, _, fn in os.walk(os.path.join(base, "synthetic", "sigterm"))
                      if "args.json" in fn]
        rescue = os.path.join(sig_run, "checkpoints", "rescue_checkpoint")
        with open(rescue + ".meta.json") as f:
            rmeta = json.load(f)
        check(torch.load(rescue, map_location="cpu", weights_only=True)["step"]
              == rmeta["num_iter"] and logged <= rmeta["num_iter"] <= logged + 1
              and not rmeta["mid_epoch"], f"17d: rescue meta {rmeta}, {logged} steps logged")
        trr = Trainer(parse_args(argv_sig + ["--checkname", "rescued", "--resume", rescue,
                                             "--continue_training"]), device=dev.type)
        check((trr.cur_epochs, trr.num_iter) == (rmeta["epoch"] + 1, rmeta["num_iter"] + 1),
              f"17d: the rescue resumes at the next epoch: {trr.cur_epochs}, {trr.num_iter} "
              f"from {rmeta}")
        log(f"  17d rescue_checkpoint: meta {rmeta}; the resume starts epoch {trr.cur_epochs} "
            f"at num_iter {trr.num_iter}")
        del trr

        # e. the SGD recipe, one epoch
        argv_e = common + ["--optimizer_policy", "SGD", "--no_host_augment", "--epochs", "1",
                           "--checkname", "e"]
        cfg_e = parse_args(argv_e)
        log("== 17e. the SGD recipe (lr x 0.1 / x 1 / x 10 groups, momentum 0.9), 1 epoch")
        init = {k: v.detach().clone() for k, v in
                build_model(cfg_e, device=dev, seed=cfg_e.random_seed).named_parameters()}
        reset()
        tre, dt = timed("17e", 120, lambda: port_main(argv_e))
        expect_launches(read(), "17e SGD", k2=3 * len(tre.val_loader),
                        jf=per_step * len(tre.step_times))
        finite_losses(tre.saver.experiment_dir, len(tre.step_times))
        labels = label_params_for_optimizer(tre.model, cfg_e)
        moved = {}
        for name, p in tre.model.named_parameters():
            moved.setdefault(labels[name], []).append(not torch.equal(p, init[name]))
        groups = [g["label"] for g in tre.optimizer.param_groups]
        log(f"  17e groups {groups} (sgd_specific holds the deform-conv offsets, which "
            "DCSSModel has none of); parameters moved by group: "
            + ", ".join(f"{k} {sum(v)}/{len(v)}" for k, v in moved.items()))
        check(groups == ["sgd_base", "sgd_semantic"] and all(any(moved[g]) for g in groups)
              and not any(moved["frozen"]), "17e: every trained group moves, no frozen one")
        del tre, init

        # f. inference on 4 frames of 1080x1920 from the best checkpoint
        frames_dir, outs = os.path.join(base, "frames"), {}
        os.makedirs(frames_dir)
        src = SyntheticDataset(size=INFER_FRAMES, image_hw=(VAL_HEIGHT, VAL_WIDTH), seed=17)
        for i in range(INFER_FRAMES):
            write_png(os.path.join(frames_dir, f"frame{i}.png"), src[i]["left"], "adaptive")
        log(f"== 17f. inference: {INFER_FRAMES} frames {VAL_WIDTH}x{VAL_HEIGHT} (write_png) "
            "from score_best_checkpoint through the CLI at bf16 and f32 (fused stem, K2), "
            "held against the plain stem's model in process")
        names = [f"frame{i}" for i in range(INFER_FRAMES)]
        for dtype in ("bfloat16", "float32"):
            reset()
            d = os.path.join(base, f"out_{dtype}")
            argv_f = ["--input", frames_dir, "--resume", best, "--device", dev.type,
                      "--compute_dtype", dtype, "--output_dir", d]
            res, _ = timed("17f", 120, lambda: port_inference.main(argv_f))
            launches = read()
            expect_launches(launches, f"17f inference, {dtype}", k2=3 * INFER_FRAMES,
                            tc=3 * INFER_FRAMES if dtype == "bfloat16" else 0)
            if dtype == "bfloat16":
                out["k2_inference"] = launches["fused_stem_pool"]
            preds = []
            for n in names:
                pred = read_png(os.path.join(d, f"{n}_pred.png"))
                color = read_png(os.path.join(d, f"{n}_color.png"))
                check(pred.shape == (VAL_HEIGHT, VAL_WIDTH) and color.shape
                      == (VAL_HEIGHT, VAL_WIDTH, 3) and int(pred.max()) < 19
                      and np.array_equal(color, TRAIN_ID_TO_COLOR[pred]),
                      f"17f: {n}'s _pred.png / _color.png")
                preds.append(pred)
            outs[dtype, True] = (np.stack(preds), res["forward_s"][1:])

        # the same checkpoint with the plain stem, in process, on the same frames
        state = torch.load(best, map_location=dev, weights_only=True)["model"]
        plain = {}
        for dtype in ("bfloat16", "float32"):
            plain[dtype] = build_model(Config(num_classes=19, compute_dtype=dtype,
                                              dataset="acdc", fuse_stem=False).finalize(),
                                       device=dev)
            merge_state_dict(plain[dtype], state, best)
            plain[dtype].eval()
        preds = {dtype: [] for dtype in plain}
        fwd = {dtype: [] for dtype in plain}
        gap, err = [], []
        reset()
        for n in names:
            x = torch.from_numpy(port_inference.load_image(
                os.path.join(frames_dir, f"{n}.png"), None, None)).to(dev, torch.float32)
            seg = {}
            for dtype, model in plain.items():
                t0 = time.perf_counter()
                with torch.no_grad():
                    seg[dtype] = model(x[None])["seg"][0].float()
                    preds[dtype].append(seg[dtype].argmax(-1).to(torch.uint8).cpu().numpy())
                fwd[dtype].append(time.perf_counter() - t0)
            top2 = seg["float32"].topk(2, dim=-1).values
            gap.append((top2[..., 0] - top2[..., 1]).cpu().numpy())
            err.append((seg["bfloat16"] - seg["float32"]).abs().amax(-1).cpu().numpy())
        expect_launches(read(), "17f plain stem in process, bf16 and f32")
        for dtype in plain:
            outs[dtype, False] = (np.stack(preds[dtype]), fwd[dtype][1:])
        gap, err = np.stack(gap), np.stack(err)
        del plain, state, seg

        def agree(a, b, mask=None):
            eq = outs[a][0] == outs[b][0]
            return float(eq.mean() if mask is None else eq[mask].mean())

        bf_fused, bf_plain = ("bfloat16", True), ("bfloat16", False)
        f32_fused, f32_plain = ("float32", True), ("float32", False)
        a = {"bf16 fused vs bf16 plain": agree(bf_fused, bf_plain),
             "f32 fused vs f32 plain": agree(f32_fused, f32_plain),
             "bf16 fused vs f32 plain": agree(bf_fused, f32_plain),
             "bf16 plain vs f32 plain": agree(bf_plain, f32_plain)}
        log(f"  17f label agreement over the {INFER_FRAMES} frames, all pixels: "
            + ", ".join(f"{k} {v:.6f}" for k, v in a.items()))
        log("  17f quantiles 0.5/0.99/0.999 of the f32 plain top-two logit gap: "
            + ", ".join(f"{q:.4f}" for q in np.quantile(gap, [0.5, 0.99, 0.999]))
            + "; of the bf16 plain logits' max abs error against f32: "
            + ", ".join(f"{q:.4f}" for q in np.quantile(err, [0.5, 0.99, 0.999])))
        for m in (0.1, 0.25):
            log(f"  17f pixels with the f32 gap >= {m}: share {float((gap >= m).mean()):.6f}, "
                f"bf16 fused vs bf16 plain {agree(bf_fused, bf_plain, gap >= m):.6f}, "
                f"bf16 plain vs f32 plain {agree(bf_plain, f32_plain, gap >= m):.6f}")
        check(a["f32 fused vs f32 plain"] >= 0.999,
              "17f: the fused stem's f32 labels disagree with the plain stem's")
        # two bf16 routes round differently, so a pixel whose top two f32
        # logits lie within bf16's rounding of each other may flip either
        # way. A pixel is decided where its f32 gap exceeds twice the plain
        # stem's bf16 logit error there (so bf16 plain must take f32's label:
        # K2 plays no part in the mask); there the fused stem's bf16 labels
        # must agree with the plain stem's on 0.99 of pixels, in each frame
        # and in its last 16 rows (the stem's edge tile)
        decided = gap > 2 * err
        eq = outs[bf_fused][0] == outs[bf_plain][0]
        per_frame = [float(eq[i][decided[i]].mean()) for i in range(INFER_FRAMES)]
        edge = float(eq[:, -16:][decided[:, -16:]].mean())
        log(f"  17f bf16 fused vs bf16 plain where the f32 gap > 2 x the plain bf16 error "
            f"({float(decided.mean()):.6f} of pixels; bf16 plain vs f32 there "
            f"{agree(bf_plain, f32_plain, decided):.6f}): frames "
            + ", ".join(f"{v:.6f}" for v in per_frame) + f", last 16 rows {edge:.6f} (bar 0.99)")
        check(decided.mean() >= 0.5, "17f: bf16's error leaves under half the pixels decided")
        check(min(per_frame + [edge]) >= 0.99,
              "17f: the fused stem's bf16 labels disagree with the plain stem's")
        for key in (bf_fused, bf_plain, f32_fused):
            fwd = outs[key][1]
            log(f"  {card}: 17f inference {key[0]}, fuse_stem {key[1]}: "
                f"{len(fwd) / sum(fwd):.2f} frames/s ({1e3 * sum(fwd) / len(fwd):.1f} ms a "
                "frame: forward, argmax and the labels' copy to the host; first skipped)")
        log("  K2 at the inference levels (batch 1, 1080x1920) vs stem_pool_reference:")
        profile_stem.check_routes(gen, dev, log, shapes=levels(1, VAL_HEIGHT, VAL_WIDTH))

        # the trainers left their rescue handlers and log files behind
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, signal.SIG_DFL if sig == signal.SIGTERM
                          else signal.default_int_handler)
        root = logging.getLogger()
        for hnd in list(root.handlers):
            root.removeHandler(hnd)
            hnd.close()
    torch.cuda.empty_cache()
    return out


def fixed_dropout_masks(torch, model, gen, cache):
    """Every ``Dropout`` of ``model`` keeps one mask, drawn on the CPU from
    ``gen`` at its first call and stored in ``cache`` under the module's
    name, so that two models sharing ``cache`` (the card's and the CPU's)
    drop the same elements."""
    from doubly_contrastive_semseg_tpu_torch.models.blocks import Dropout

    for name, m in model.named_modules():
        if isinstance(m, Dropout):
            def keep(x, name=name, m=m):
                if name not in cache:
                    b, c, h, w = x.shape
                    shape = (b, 1, 1, c) if m.spatial else (b, h, w, c)
                    cache[name] = (torch.rand(shape, generator=gen) >= m.p).permute(0, 3, 1, 2)
                return cache[name].to(x.device)
            m.keep_mask = keep


def finite(comps) -> bool:
    return all(v == v and abs(v) < float("inf") for v in comps.values())


def deeplab_train_phase(torch, dev, card, gen, reset, read):
    """18a. ``DEEPLAB`` at the published recipe (``DEEPLAB_STEPS`` steps;
    the largest batch that fits, from 8 down), then one small f32 step on
    the card against the CPU from the same weights and dropout masks, and
    its blocks one at a time, to the flagship's card-vs-CPU tolerances.
    Returns {"batch", "ms_step", "peak_gb"}."""
    from doubly_contrastive_semseg_tpu_torch import Config, build_model
    from doubly_contrastive_semseg_tpu_torch.tools.profile_train import make_batch
    from doubly_contrastive_semseg_tpu_torch.train import (
        TrainState, build_optimizer, compute_loss, make_train_step)

    cfg = Config(model=DEEPLAB, criterion=CRITERION, dataset="acdc")
    torch.backends.cudnn.benchmark = True
    b = TRAIN_BATCH
    while True:
        log(f"== 18a. {DEEPLAB} training: {TRAIN_CROP}² crops, batch {b} x 2 views, bf16, "
            f"{CRITERION}, {DEEPLAB_STEPS} steps")
        try:
            model = build_model(cfg, device=dev, seed=0)
            aspp = model.classifier.aspp
            check([c[0].dilation for c in aspp.convs[1:4]] == [(6, 6), (12, 12), (18, 18)]
                  and aspp.project[0].out_channels == 256 and len(model.backbone.layer3) == 23
                  and model.weather_clf.fc.in_features == 2048
                  and model.backbone.layer4[1].conv2.dilation == (2, 2),
                  "18a: ResNet-101 at output stride 16, ASPP 256 at rates 6/12/18, 2048 out")
            opt = build_optimizer(model, cfg, steps_per_epoch=200)
            state = TrainState(model, opt)
            step = make_train_step(model, cfg, opt)
            batch = make_batch(b, TRAIN_CROP, gen, dev)
            reset()
            times = []
            for i in range(DEEPLAB_STEPS):
                if i == 1:
                    torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics = step(state, batch, torch.Generator(device=dev).manual_seed(i))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                comps = {k: v.item() for k, v in metrics.items()}
                check(finite(comps), f"18a step {i}: a loss is not finite: {comps}")
                log(f"  step {i}: {1e3 * times[-1]:.1f} ms; "
                    + ", ".join(f"{k} {v:.4f}" for k, v in comps.items()))
            break
        except torch.cuda.OutOfMemoryError:
            model = opt = state = step = batch = metrics = None
            torch.cuda.empty_cache()
            check(b > 1, "18a: batch 1 x 2 views does not fit")
            log(f"  batch {b} x 2 views does not fit on the card: halving it")
            b //= 2
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect_launches(read(), f"18a {DEEPLAB}, {DEEPLAB_STEPS} steps (pixel contrast N = "
                    f"{b * 19 * 2} < 8192: the plain route)")
    ms_step = 1e3 * sum(times[1:]) / len(times[1:])
    steady = 1e3 * sum(times[2:]) / len(times[2:])
    log(f"  {card}: 18a {DEEPLAB} {TRAIN_CROP}² batch {b} x 2 views bf16: {ms_step:.2f} ms a "
        f"step over steps 2-{DEEPLAB_STEPS} ({', '.join(f'{1e3 * t:.2f}' for t in times[1:])}; "
        f"step 1 {1e3 * times[0]:.1f} tunes cuDNN), {steady:.2f} over steps 3-{DEEPLAB_STEPS}, "
        f"{b * 1e3 / steady:.2f} samples/s there; peak memory {peak_gb:.2f} GB")
    del model, opt, state, step, batch, metrics
    torch.cuda.empty_cache()

    # one small f32 step, card vs CPU, from the same weights and dropout masks
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    cfg32 = Config(model=DEEPLAB, criterion=CRITERION, dataset="acdc", reference_rng=True,
                   compute_dtype="float32")
    sb, scrop = DEEPLAB_SMALL
    small = make_batch(sb, scrop, gen, "cpu")
    base = build_model(cfg32, device="cpu", seed=4)
    masks, results = {}, {}
    for where in (dev, "cpu"):
        m = copy.deepcopy(base).to(where).train()
        fixed_dropout_masks(torch, m, gen, masks)
        total, comps, _ = compute_loss(m, cfg32, {k: v.to(where) for k, v in small.items()},
                                       None)
        total.backward()
        results[where] = ({k: v.item() for k, v in comps.items()},
                          {k: p.grad.cpu() for k, p in m.named_parameters()
                           if p.grad is not None})
        del m
    (c_gpu, g_gpu), (c_cpu, g_cpu) = results[dev], results["cpu"]
    gate_free = ("classifier.classifier.3.weight", "classifier.classifier.3.bias",
                 "projection.fc2.weight", "projection.fc2.bias")
    comp_rel = max(abs(c_gpu[k] - c_cpu[k]) / max(abs(c_cpu[k]), 1e-30) for k in c_cpu)
    max_rel = {k: rel_err(torch, g_gpu[k], g_cpu[k]) for k in g_cpu}
    gate_free_err = max(max_rel[k] for k in gate_free)
    worst = max(max_rel, key=max_rel.get)
    log(f"  small f32 step ({sb} x 2 views, {scrop}²) card vs CPU: loss components max rel "
        f"err {comp_rel:.2e} (tolerance 1e-4); gradients of the gate-free tensors "
        f"{gate_free_err:.2e} of max|g| (tolerance 1e-3); {len(g_cpu)} tensors, the "
        f"largest error {max_rel[worst]:.2e} of max|g| in {worst} (not held: phase 7b)")
    check(set(g_gpu) == set(g_cpu) and set(gate_free) <= set(g_cpu) and finite(c_gpu)
          and comp_rel <= 1e-4 and gate_free_err <= 1e-3,
          f"18a: the card's {DEEPLAB} step disagrees with the CPU path")

    def nchw(*shape):
        return torch.randn(*shape, generator=gen).contiguous(memory_format=torch.channels_last)

    fixed_dropout_masks(torch, base, gen, {})
    spread = nchw(4, 2048, 6, 6) + 3 * nchw(4, 2048, 1, 1)   # the pooling BN's batch spread
    cases = (("backbone.layer3.1 (dilation 1)", base.backbone.layer3[1], [nchw(4, 1024, 6, 6)]),
             ("backbone.layer4.1 (dilation 2)", base.backbone.layer4[1], [nchw(4, 2048, 6, 6)]),
             ("classifier.aspp (dropout mask fixed)", base.classifier.aspp, [spread]))
    for name, block, inputs in cases:
        log_block(name, block_errors(torch, block, inputs, dev, gen), "18a ")
    torch.backends.cudnn.deterministic = False
    del base, results, g_gpu, g_cpu
    return {"batch": b, "ms_step": ms_step, "steady_ms": steady, "peak_gb": peak_gb}


def deeplab_dense_phase(torch, dev, card, gen, reset, read, profile_contrastive):
    """18b. ``DEEPLAB`` at the dense-contrast size (batch ``DENSE_BATCH`` on
    ``DENSE_CROP``², 3 steps): K3 ``LAUNCHES`` times and K4's layout and
    sweep once a step at D = 2048; on one step's anchors, the kernel
    route's loss and dZ against the plain route's; then K3 and K4 alone at
    N = 8208 and D = 320, 480, 720, 2048 (``profile_contrastive.wide_d``).
    Returns the launches of the 3 steps and ``wide_d``'s numbers."""
    from doubly_contrastive_semseg_tpu_torch import Config, build_model
    from doubly_contrastive_semseg_tpu_torch.losses.pixel_contrast import (
        _hard_anchor_sampling, _masked_contrastive)
    from doubly_contrastive_semseg_tpu_torch.ops import contrastive
    from doubly_contrastive_semseg_tpu_torch.ops.interpolate import resize_nearest
    from doubly_contrastive_semseg_tpu_torch.tools.profile_contrastive import LAUNCHES
    from doubly_contrastive_semseg_tpu_torch.tools.profile_train import make_batch
    from doubly_contrastive_semseg_tpu_torch.train import (
        TrainState, build_optimizer, make_train_step)

    n_rows = DENSE_BATCH * 19 * 2
    log(f"== 18b. {DEEPLAB} dense-contrast step: batch {DENSE_BATCH} x 2 views at "
        f"{DENSE_CROP}², bf16; pixel contrast N = {n_rows}, D = 2048")
    cfg = Config(model=DEEPLAB, criterion=CRITERION, dataset="acdc")
    torch.backends.cudnn.benchmark = False   # cuDNN's heuristics: no 15 s of tuning
    model = build_model(cfg, device=dev, seed=1)
    opt = build_optimizer(model, cfg, steps_per_epoch=200)
    state = TrainState(model, opt)
    step = make_train_step(model, cfg, opt)
    batch = make_batch(DENSE_BATCH, DENSE_CROP, gen, dev)
    kernels = {"contrastive_row_stats": contrastive.contrastive_row_stats,
               "pos_sweep_layout": contrastive.pos_sweep_layout,
               "pixel_contrast_pos_sweep": contrastive.pixel_contrast_pos_sweep}
    reset()
    times = []
    for i in range(3):
        before = {k: fn.launches for k, fn in kernels.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, batch, torch.Generator(device=dev).manual_seed(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        comps = {k: v.item() for k, v in metrics.items()}
        d3, d_layout, d4 = (fn.launches - before[k] for k, fn in kernels.items())
        log(f"  step {i}: {1e3 * times[-1]:.1f} ms, K3 launches {d3}, K4 layouts {d_layout} "
            f"and sweeps {d4}; " + ", ".join(f"{k} {v:.5f}" for k, v in comps.items()))
        check(d3 == LAUNCHES and d_layout == 1 and d4 == 1,
              f"18b: each step must launch K3 {LAUNCHES} times and K4's layout and sweep once")
        check(finite(comps), f"18b step {i}: a loss is not finite")
    launches = read()
    check(all(v == 0 for k, v in launches.items() if k not in kernels),
          f"18b: only K3 and K4 may launch: {launches}")
    log(f"  {card}: 18b {1e3 * sum(times[1:]) / 2:.2f} ms a step over steps 2-3 "
        f"({', '.join(f'{1e3 * t:.2f}' for t in times)} for steps 1-3); launches in 3 steps "
        f"{launches}")

    # the kernel route against the plain route on one step's anchors (f32)
    model.train()
    with torch.no_grad():
        out = model(batch["left"].float(), return_supcon_feature=True)
        feats = out["fine_feat0"]
        b, h, w, d = feats.shape
        preds = resize_nearest(out["seg_beforeup"].argmax(-1), (h, w))
        labels = resize_nearest(batch["label"], (h, w))
        anchors, a_lab, a_val = _hard_anchor_sampling(
            feats.reshape(b, h * w, d).float(), labels.reshape(b, -1),
            preds.reshape(b, -1).to(labels.dtype), 19, torch.Generator(device=dev).manual_seed(7))
    del out, feats, preds
    res = []
    for use_kernel in (True, False):
        x = anchors.detach().clone().requires_grad_(True)
        loss = _masked_contrastive(x, a_lab, a_val, 0.07, 0.07, use_kernel=use_kernel)
        loss.backward()
        res.append((loss.item(), x.grad))
    z = torch.cat([anchors[:, 0], anchors[:, 1]]).float()
    _, _, _, m, nrm = contrastive.contrastive_row_stats(
        z, a_lab.repeat(2), a_val.repeat(2), neg_mode=True)
    valid = a_val.repeat(2).bool()
    # l̂ = (l − m)/n: an error in a logit, relative to the largest |l| (an
    # f32 sum of D = 2048 products errs by ~√D ulps, ≲ 1e-5 of it), moves
    # l̂ by up to kappa times as much; the loss and dZ are held to that
    kappa = (z.norm(dim=1).max() ** 2 / 0.07 / nrm[valid].min()).item()
    d_loss = abs(res[0][0] - res[1][0])
    d_grad = ((res[0][1] - res[1][1]).abs().max() / res[1][1].abs().max()).item()
    loss_tol, grad_tol = 1e-5 * kappa * max(abs(res[1][0]), 1.0), 1e-4 * kappa
    log(f"  anchors (N = {z.shape[0]}, D = {z.shape[1]}, {int(valid.sum())} valid rows): max "
        f"|logit| {z.norm(dim=1).max().item() ** 2 / 0.07:.4g}, smallest row norm "
        f"{nrm[valid].min().item():.4g}, kappa {kappa:.4g}; loss kernel {res[0][0]:.7f}, "
        f"plain {res[1][0]:.7f} (|diff| {d_loss:.2e}, tolerance 1e-5·kappa·max(|loss|, 1) = "
        f"{loss_tol:.2e}); dZ max abs err {d_grad:.2e} of max|dZ| (tolerance 1e-4·kappa = "
        f"{grad_tol:.2e})")
    check(d_loss <= loss_tol and d_grad <= grad_tol,
          "18b: the kernel route's loss or dZ disagrees with the plain route at D = 2048")
    del model, opt, state, step, batch, metrics, anchors, res, z
    torch.cuda.empty_cache()
    log(f"  K3 and K4 alone at N = {n_rows}, the DeepLab family's widths (f32):")
    wide = profile_contrastive.wide_d(gen, dev, log)
    return launches, wide


def deeplab_eval_phase(torch, dev, card, gen, reset, read):
    """18c. ``DEEPLAB`` at ``WIDTH``×``HEIGHT``, batch ``BATCH``, bf16: eval
    frames/s through ``make_eval_step`` and serving frames/s through the
    generic branch of ``make_serving_fn``, with no K1, K2 or K5 launch; the
    serving labels at f32 on a small input, card vs CPU, on 0.999 of the
    pixels. Returns {"eval_fps", "serve_fps"}."""
    from doubly_contrastive_semseg_tpu_torch import Config, build_model, make_serving_fn
    from doubly_contrastive_semseg_tpu_torch.train import init_eval_accum, make_eval_step

    log(f"== 18c. {DEEPLAB} eval and serving: {WIDTH}x{HEIGHT}, batch {BATCH}, bf16")
    torch.backends.cudnn.benchmark = True
    cfg = Config(model=DEEPLAB, dataset="acdc")
    model = build_model(cfg, device=dev, seed=2)
    randomize_bn(model.cpu(), gen)
    model.to(dev)
    image = torch.randint(0, 256, (BATCH, HEIGHT, WIDTH, 3), generator=gen,
                          dtype=torch.uint8).to(dev)
    batch = {"left": image,
             "label": torch.randint(0, 19, (BATCH, HEIGHT, WIDTH), generator=gen,
                                    dtype=torch.int32).to(dev),
             "weather": torch.randint(0, 4, (BATCH,), generator=gen, dtype=torch.int32).to(dev)}
    eval_step, serve = make_eval_step(model, cfg), make_serving_fn(model, device=dev)
    accum = init_eval_accum(cfg, dev)
    reset()
    for _ in range(2):
        preds, accum = eval_step(batch, accum)
        labels = serve(image)
    torch.cuda.synchronize()
    check(tuple(preds.shape) == (BATCH, HEIGHT, WIDTH) and labels.dtype == torch.int8
          and tuple(labels.shape) == (BATCH, HEIGHT, WIDTH)
          and float(accum["cm"].sum()) == 2 * BATCH * HEIGHT * WIDTH,
          "18c: eval predictions, confusion counts and serving labels")
    rates = {}
    for what, fn in (("eval", lambda: eval_step(batch, accum)), ("serve", lambda: serve(image))):
        windows = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            windows.append(5 * BATCH / (time.perf_counter() - t0))
        rates[what] = windows
    expect_launches(read(), "18c eval and serving (generic branch: no K1, K2, K5)")
    log(f"  {card}: 18c eval {BATCH * 3 / sum(BATCH / f for f in rates['eval']):.2f} frames/s "
        f"(windows {', '.join(f'{f:.2f}' for f in rates['eval'])}), serving "
        f"{BATCH * 3 / sum(BATCH / f for f in rates['serve']):.2f} frames/s (windows "
        f"{', '.join(f'{f:.2f}' for f in rates['serve'])})")
    del model, eval_step, serve, batch, image, accum, preds, labels
    torch.cuda.empty_cache()

    # f32 serving labels on a small input, card vs CPU
    torch.backends.cudnn.benchmark = False
    cfg32 = Config(model=DEEPLAB, compute_dtype="float32")
    cpu = build_model(cfg32, device="cpu", seed=3)
    randomize_bn(cpu, gen)
    card_model = copy.deepcopy(cpu).to(dev)
    x = torch.randint(0, 256, (2, 256, 512, 3), generator=gen).float()
    lab_gpu = make_serving_fn(card_model, device=dev)(x.to(dev)).cpu()
    lab_cpu = make_serving_fn(cpu, device="cpu")(x)
    agree = (lab_gpu == lab_cpu).float().mean().item()
    log(f"  f32 serving labels 2 x 256 x 512, card vs CPU: agreement {agree:.6f} (bar 0.999)")
    check(lab_gpu.shape == (2, 256, 512) and agree >= 0.999,
          "18c: the card's serving labels disagree with the CPU's")
    del cpu, card_model
    return {"eval_fps": rates["eval"], "serve_fps": rates["serve"]}


def other_models_phase(torch, dev, card, gen, reset, read):
    """18d. Every other ported DeepLab name and ``enet``, once: built on the
    card, one bf16 train step at 2 × 2 views of 256², one eval batch;
    finite outputs of JAX's contract shapes (``tests/test_models.py``)."""
    from doubly_contrastive_semseg_tpu_torch import Config, build_model
    from doubly_contrastive_semseg_tpu_torch.config import PORTED_MODELS
    from doubly_contrastive_semseg_tpu_torch.tools.profile_train import make_batch
    from doubly_contrastive_semseg_tpu_torch.train import (
        TrainState, build_optimizer, compute_loss, make_eval_step, init_eval_accum)

    names = [m for m in PORTED_MODELS if m == "enet"
             or (m.startswith("deeplabv3") and m != DEEPLAB)]
    log(f"== 18d. the other {len(names)} ported names: one bf16 train step (2 x 2 views, "
        f"{OTHER_CROP}²) and one eval batch each")
    torch.backends.cudnn.benchmark = False
    b, s = 2, OTHER_CROP
    batch = make_batch(b, s, gen, dev)
    reset()
    for name in names:
        t0 = time.perf_counter()
        cfg = Config(model=name, criterion=CRITERION, dataset="acdc")
        model = build_model(cfg, device=dev, seed=5)
        opt = build_optimizer(model, cfg, steps_per_epoch=200)
        model.train()
        opt.zero_grad(set_to_none=True)
        total, comps, out = compute_loss(model, cfg, batch, torch.Generator(device=dev).manual_seed(0))
        total.backward()
        opt.step()
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        ok = (shapes["seg"] == (b, s, s, 19) and shapes["fine_feat"][0] == 2 * b
              and shapes["fine_feat0"][0] == b and shapes["supcon_proj"] == (b, 2, 128)
              and shapes["weather_logits"] == (b, 4)
              and (name == "enet" or shapes["fine_feat0"][1:3] == shapes["seg_beforeup"][1:3]))
        comps = {k: v.item() for k, v in comps.items()}
        grads_ok = all(torch.isfinite(p.grad).all().item() for p in model.parameters()
                       if p.grad is not None)
        preds, accum = make_eval_step(model, cfg)(
            {"left": batch["left"][:b], "label": batch["label"], "weather": batch["weather"]},
            init_eval_accum(cfg, dev))
        torch.cuda.synchronize()
        log(f"  {name}: fine_feat {shapes['fine_feat']}, seg_beforeup {shapes['seg_beforeup']}, "
            f"loss {comps['total_loss']:.4f}, eval preds {tuple(preds.shape)}, "
            f"{time.perf_counter() - t0:.1f} s")
        check(ok and finite(comps) and grads_ok and tuple(preds.shape) == (b, s, s)
              and float(accum["cm"].sum()) == float((batch["label"] != 255).sum()),
              f"18d {name}: outputs {shapes}, losses {comps}, finite gradients {grads_ok}")
        del model, opt, out, total, preds, accum
        torch.cuda.empty_cache()
    expect_launches(read(), f"18d ({len(names)} models, pixel contrast N = {b * 38} < 8192)")
    del batch


def deeplab_cli_phase(torch, dev, card, batch_size, reset, read):
    """18e. ``main --model DEEPLAB``: one epoch of 2 steps (host crops, 1
    loader thread) and 4 val frames, then ``--test_only`` on its
    checkpoint; ``inference`` with that checkpoint on 2 PNGs of
    ``VAL_WIDTH``×``VAL_HEIGHT``. No kernel launches on these paths."""
    from doubly_contrastive_semseg_tpu_torch import inference as port_inference
    from doubly_contrastive_semseg_tpu_torch.data import SyntheticDataset, read_png, write_png
    from doubly_contrastive_semseg_tpu_torch.main import main as port_main

    with tempfile.TemporaryDirectory() as base:
        common = ["--dataset", "synthetic", "--synthetic_hw", SYNTHETIC_HW,
                  "--synthetic_size", str(batch_size * 2), "--train_semantic",
                  "--criterion", CRITERION, "--batch_size", str(batch_size),
                  "--print_freq", "1", "--summary_freq", "1", "--run_root", base,
                  "--device", dev.type, "--model", DEEPLAB]
        log(f"== 18e. main --model {DEEPLAB}: 1 epoch of 2 steps (batch {batch_size} x 2 "
            f"views, host crops), validate; --test_only; inference on 2 PNGs")
        reset()
        t0 = time.perf_counter()
        tr = port_main(common + ["--epochs", "1", "--num_workers", "1", "--checkname", "a"])
        dt = time.perf_counter() - t0
        losses = scalars(tr.saver.experiment_dir, "train/total_loss_print_freq")
        check(len(losses) == 2 and all(np.isfinite(v) for _, v in losses),
              f"18e: 2 finite losses in metrics.jsonl: {losses}")
        ((_, frames, wall),) = tr.val_times
        best = os.path.join(tr.saver.checkpoint_dir, "score_best_checkpoint")
        check(os.path.exists(best), "18e: main saved no score_best_checkpoint")
        log(f"  {card}: 18e main: {dt:.2f} s (epoch {tr.epoch_seconds[0]:.2f} s); ms a step "
            "(loader wait, step): " + ", ".join(f"({1e3 * s[1]:.1f}, {1e3 * s[2]:.1f})"
                                                for s in tr.step_times)
            + f"; val {frames} frames, {frames / wall:.2f} frames/s end to end; checkpoint "
            f"{os.path.getsize(best) / 1e6:.2f} MB")
        del tr
        trc = port_main(common + ["--test_only", "--resume", best, "--checkname", "c"])
        saved = torch.load(best, map_location="cpu", weights_only=True)["model"]
        sd = trc.model.state_dict()
        check(sd.keys() == saved.keys() and all(torch.equal(sd[k].cpu(), v)
                                                for k, v in saved.items()),
              "18e: --test_only restored other weights than the saved ones")
        ((_, frames, wall),) = trc.val_times
        log(f"  {card}: 18e --test_only: {frames} frames, {frames / wall:.2f} frames/s end to "
            "end; state_dict bit for bit the saved one")
        del trc, saved, sd
        frames_dir, out_dir = os.path.join(base, "frames"), os.path.join(base, "out")
        os.makedirs(frames_dir)
        src = SyntheticDataset(size=2, image_hw=(VAL_HEIGHT, VAL_WIDTH), seed=18)
        for i in range(2):
            write_png(os.path.join(frames_dir, f"frame{i}.png"), src[i]["left"], "adaptive")
        res = port_inference.main(["--input", frames_dir, "--resume", best, "--model", DEEPLAB,
                                   "--device", dev.type, "--output_dir", out_dir])
        for i in range(2):
            pred = read_png(os.path.join(out_dir, f"frame{i}_pred.png"))
            check(pred.shape == (VAL_HEIGHT, VAL_WIDTH) and int(pred.max()) < 19,
                  f"18e: inference's frame{i}_pred.png")
        log(f"  {card}: 18e inference: 2 frames, forward {res['forward_s'][1]:.4f} s for the "
            "second")
        expect_launches(read(), "18e main, --test_only, inference")


def decided_agreement(torch, feat, head, labels):
    """K1's labels against the plain head's on the same features: agreement
    on all pixels and on the decided ones, where the f32 head's top-two
    logit gap exceeds twice its logits' error at the features' dtype (PR
    13's rule: there the plain head at that dtype must take f32's label)."""
    from doubly_contrastive_semseg_tpu_torch.ops.seghead import fold_bn, seghead_reference

    norm, conv = head.norm, head.conv
    plain = seghead_reference(feat, norm.weight, norm.bias, norm.running_mean, norm.running_var,
                              conv.weight, conv.bias, eps=norm.eps)
    a, shift = fold_bn(norm.weight, norm.bias, norm.running_mean, norm.running_var, norm.eps)
    w = conv.weight.reshape(conv.weight.shape[0], -1).float()
    gap, err = [], []
    for i in range(feat.shape[0]):   # a frame at a time: full-resolution f32 logits
        act = torch.relu(feat[i:i + 1].float() * a + shift)
        logits = {}
        for rounded in (False, True):
            x = act.to(feat.dtype).float() if rounded else act
            wr = w.to(feat.dtype).float() if rounded else w
            lo = torch.einsum("bhwk,ck->bchw", x, wr) + conv.bias.float()[:, None, None]
            logits[rounded] = torch.nn.functional.interpolate(
                lo, scale_factor=4, mode="bilinear", align_corners=False)
        top2 = logits[False].topk(2, dim=1).values
        gap.append(top2[:, 0] - top2[:, 1])
        err.append((logits[True] - logits[False]).abs().amax(1))
    gap, err = torch.cat(gap), torch.cat(err)
    decided = gap > 2 * err
    eq = labels == plain
    return (eq.float().mean().item(), eq[decided].float().mean().item(),
            decided.float().mean().item())


def swift_serving_phase(torch, dev, card, gen, reset, read):
    """19a. ``SWIFT`` at full width, random weights: serving 2048×1024 × 8
    bf16 through K1 once a batch, its labels against the plain head on the
    same features (decided pixels, 0.99); f32 serving of two frames, K1's
    f32 route against the plain head on 0.9999 of the pixels; eval frames/s
    with no K1, K2 or K5 launch. Returns {"k1_bf16", "k1_f32", "serve_fps",
    "eval_fps"}."""
    from doubly_contrastive_semseg_tpu_torch import Config, build_model, make_serving_fn
    from doubly_contrastive_semseg_tpu_torch.ops.seghead import fused_seghead_upsample_argmax
    from doubly_contrastive_semseg_tpu_torch.train import init_eval_accum, make_eval_step

    log(f"== 19a. {SWIFT} serving and eval: {WIDTH}x{HEIGHT}, batch {BATCH}, bf16")
    torch.backends.cudnn.benchmark = True
    cfg = Config(model=SWIFT, dataset="acdc")
    model = build_model(cfg, device="cpu", seed=19)
    randomize_bn(model, gen)
    model.to(dev)
    fe = model.net.feature_extractor
    check([m.momentum for m in (fe.spp.spp.spp_bn.norm, fe.spp.spp.spp_fuse.norm)] == [0.005] * 2
          and fe.spp.grids == (8, 4, 2) and fe.spp.spp.spp0.conv.out_channels == 42
          and len(fe.upsample) == 3 and model.net.segmentation.conv.out_channels == 19,
          "19a: SwiftNet-RN18 single scale: SPP 3 levels of (8, 4, 2), 128 // 3 wide, BN "
          "momentum 0.005, 3 upsample steps, 19 classes")
    serve = make_serving_fn(model, device=dev)
    image = torch.randint(0, 256, (BATCH, HEIGHT, WIDTH, 3), generator=gen,
                          dtype=torch.uint8).to(dev)
    reset()
    labels = serve(image)
    torch.cuda.synchronize()
    got = read()
    log(f"  one serving batch: launches {got}")
    k1_batch = got["fused_seghead_upsample_argmax"]
    check(got["fused_seghead_upsample_argmax"] == 1 and
          all(v == 0 for k, v in got.items() if k != "fused_seghead_upsample_argmax"),
          "19a: a serving batch must launch K1 once and nothing else")
    with torch.no_grad():
        feat = fe(image)[0].permute(0, 2, 3, 1).contiguous()
    k1_bf16 = decided_agreement(torch, feat, model.net.segmentation, labels)
    log(f"  K1 bf16 vs the plain head on the same features: all pixels {k1_bf16[0]:.6f}, "
        f"decided pixels {k1_bf16[1]:.6f} ({k1_bf16[2]:.6f} of them; bar 0.99)")
    check(labels.shape == (BATCH, HEIGHT, WIDTH) and labels.dtype == torch.int8
          and k1_bf16[2] >= 0.5 and k1_bf16[1] >= 0.99,
          "19a: K1's bf16 labels disagree with the plain head's")
    head = model.net.segmentation
    k1_ms = cuda_ms(lambda: fused_seghead_upsample_argmax(
        feat, head.norm.weight, head.norm.bias, head.norm.running_mean, head.norm.running_var,
        head.conv.weight, head.conv.bias), iters=20)
    del feat

    rates = {}
    eval_step = make_eval_step(model, cfg)
    accum = init_eval_accum(cfg, dev)
    batch = {"left": image,
             "label": torch.randint(0, 19, (BATCH, HEIGHT, WIDTH), generator=gen,
                                    dtype=torch.int32).to(dev),
             "weather": torch.randint(0, 4, (BATCH,), generator=gen, dtype=torch.int32).to(dev)}
    reset()
    for what, fn in (("serve", lambda: serve(image)), ("eval", lambda: eval_step(batch, accum))):
        fn()
        windows = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            windows.append(5 * BATCH / (time.perf_counter() - t0))
        rates[what] = windows
    got = read()
    check(got["fused_seghead_upsample_argmax"] == 16 and
          all(v == 0 for k, v in got.items() if k != "fused_seghead_upsample_argmax"),
          f"19a: 16 serving batches launch K1 16 times, 16 eval batches nothing: {got}")
    serve_fps = BATCH * 3 / sum(BATCH / f for f in rates["serve"])
    log(f"  {card}: 19a K1 {k1_ms:.4f} ms on this batch's features, "
        f"{100 * k1_ms * serve_fps / (1e3 * BATCH):.2f} % of a serving batch's "
        f"{1e3 * BATCH / serve_fps:.2f} ms")
    log(f"  {card}: 19a serving {serve_fps:.2f} "
        f"frames/s (windows {', '.join(f'{f:.2f}' for f in rates['serve'])}), eval "
        f"{BATCH * 3 / sum(BATCH / f for f in rates['eval']):.2f} frames/s (windows "
        f"{', '.join(f'{f:.2f}' for f in rates['eval'])}); launches {got}")
    del model, serve, eval_step, batch, accum, image, labels
    torch.cuda.empty_cache()

    # f32: K1's CUDA-core route
    cfg32 = Config(model=SWIFT, compute_dtype="float32")
    model = build_model(cfg32, device="cpu", seed=20)
    randomize_bn(model, gen)
    model.to(dev)
    x = torch.randint(0, 256, (2, HEIGHT, WIDTH, 3), generator=gen).float().to(dev)
    reset()
    labels = make_serving_fn(model, device=dev)(x)
    got = read()
    with torch.no_grad():
        feat = model.net.feature_extractor(x)[0].permute(0, 2, 3, 1).contiguous()
    k1_f32 = decided_agreement(torch, feat, model.net.segmentation, labels)
    log(f"  f32, 2 frames: K1 vs the plain head on all pixels {k1_f32[0]:.6f} (bar 0.9999); "
        f"launches {got}")
    check(got["fused_seghead_upsample_argmax"] == 1 and k1_f32[0] >= 0.9999,
          "19a: K1's f32 labels disagree with the plain head's")
    del model, x, feat, labels
    torch.cuda.empty_cache()
    return {"k1_bf16": k1_bf16, "k1_f32": k1_f32, "k1_ms": k1_ms, "k1_batch": k1_batch,
            "serve_fps": rates["serve"],
            "eval_fps": rates["eval"]}


def swift_train_phase(torch, dev, card, gen, reset, read):
    """19a. ``SWIFT`` at the published recipe (768², batch 8 × 2 views,
    bf16, 6 steps, no kernel), then one small f32 step card vs CPU and its
    SPP and an upsample step one at a time, at phase 7b's tolerances.
    Returns {"ms_step", "peak_gb"}."""
    from doubly_contrastive_semseg_tpu_torch import Config, build_model
    from doubly_contrastive_semseg_tpu_torch.tools.profile_train import make_batch
    from doubly_contrastive_semseg_tpu_torch.train import (
        TrainState, build_optimizer, compute_loss, make_train_step)

    log(f"== 19a. {SWIFT} training: {TRAIN_CROP}² crops, batch {TRAIN_BATCH} x 2 views, bf16, "
        f"{CRITERION}, 6 steps")
    torch.backends.cudnn.benchmark = True
    cfg = Config(model=SWIFT, criterion=CRITERION, dataset="acdc")
    model = build_model(cfg, device=dev, seed=21)
    opt = build_optimizer(model, cfg, steps_per_epoch=200)
    state = TrainState(model, opt)
    step = make_train_step(model, cfg, opt)
    batch = make_batch(TRAIN_BATCH, TRAIN_CROP, gen, dev)
    reset()
    times = []
    for i in range(6):
        if i == 2:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, batch, torch.Generator(device=dev).manual_seed(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        comps = {k: v.item() for k, v in metrics.items()}
        check(finite(comps), f"19a step {i}: a loss is not finite: {comps}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect_launches(read(), f"19a {SWIFT}, 6 steps (pixel contrast N = "
                    f"{TRAIN_BATCH * 19 * 2} < 8192: the plain route)")
    ms_step = 1e3 * sum(times[2:]) / len(times[2:])
    log(f"  {card}: 19a {SWIFT} {TRAIN_CROP}² batch {TRAIN_BATCH} x 2 views bf16: {ms_step:.2f} "
        f"ms a step over steps 2-5 ({', '.join(f'{1e3 * t:.2f}' for t in times[2:])}; steps "
        f"0-1 {1e3 * times[0]:.1f}, {1e3 * times[1]:.1f}), {TRAIN_BATCH * 1e3 / ms_step:.2f} "
        f"samples/s, peak memory {peak_gb:.2f} GB; last losses "
        + ", ".join(f"{k} {v:.4f}" for k, v in comps.items()))
    del model, opt, state, step, batch, metrics
    torch.cuda.empty_cache()

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    cfg32 = Config(model=SWIFT, criterion=CRITERION, dataset="acdc", reference_rng=True,
                   compute_dtype="float32")
    small = make_batch(2, 128, gen, "cpu")
    base = build_model(cfg32, device="cpu", seed=22)
    results = {}
    for where in (dev, "cpu"):
        m = copy.deepcopy(base).to(where).train()
        total, comps, _ = compute_loss(m, cfg32, {k: v.to(where) for k, v in small.items()}, None)
        total.backward()
        results[where] = ({k: v.item() for k, v in comps.items()},
                          {k: p.grad.cpu() for k, p in m.named_parameters()
                           if p.grad is not None})
        del m
    (c_gpu, g_gpu), (c_cpu, g_cpu) = results[dev], results["cpu"]
    gate_free = ("net.segmentation.conv.weight", "net.segmentation.conv.bias",
                 "projection.fc2.weight", "projection.fc2.bias")
    comp_rel = max(abs(c_gpu[k] - c_cpu[k]) / max(abs(c_cpu[k]), 1e-30) for k in c_cpu)
    max_rel = {k: rel_err(torch, g_gpu[k], g_cpu[k]) for k in g_cpu}
    gate_free_err = max(max_rel[k] for k in gate_free)
    worst = max(max_rel, key=max_rel.get)
    log(f"  small f32 step (2 x 2 views, 128²) card vs CPU: loss components max rel err "
        f"{comp_rel:.2e} (tolerance 1e-4); gate-free gradients {gate_free_err:.2e} of max|g| "
        f"(tolerance 1e-3); {len(g_cpu)} tensors, the largest error {max_rel[worst]:.2e} of "
        f"max|g| in {worst} (not held: phase 7b)")
    check(set(g_gpu) == set(g_cpu) and finite(c_gpu) and comp_rel <= 1e-4
          and gate_free_err <= 1e-3, f"19a: the card's {SWIFT} step disagrees with the CPU path")

    def nchw(*shape):
        return torch.randn(*shape, generator=gen).contiguous(memory_format=torch.channels_last)

    # layer 4 of a 1080 x 1920 frame, 34 x 60, under grids of 8 x 14, 4 x 7,
    # 2 x 4: unequal windows; the CPU's ReLU gates forced on the card
    fe = base.net.feature_extractor
    spread = nchw(2, 512, 34, 60) + nchw(2, 512, 1, 1)
    cases = (("spp (34 x 60: unequal windows)", fe.spp, [spread]),
             ("upsample.0", fe.upsample[0], [nchw(2, 128, 4, 4), nchw(2, 256, 8, 8)]))
    for name, block, inputs in cases:
        log_block(name, block_errors(torch, block, inputs, dev, gen), "19a ")
    torch.backends.cudnn.deterministic = False
    del base, results
    return {"ms_step": ms_step, "peak_gb": peak_gb, "times": times}


def swift_dense_phase(torch, dev, card, gen, reset, read, profile_contrastive):
    """19a. ``SWIFT`` at the dense-contrast size (batch ``DENSE_BATCH`` on
    ``DENSE_CROP``², 3 steps, layer 4 at 3 × 3 under SPP grids of 8): K3
    ``LAUNCHES`` times and K4's layout and sweep once a step; on one step's
    anchors the kernel route's loss and dZ against the plain route's; then
    K3 and K4 alone at the step's N and D (``profile_contrastive.wide_d``).
    Returns the launches of the 3 steps, the ms a step and ``wide_d``'s
    numbers."""
    from doubly_contrastive_semseg_tpu_torch import Config, build_model
    from doubly_contrastive_semseg_tpu_torch.losses.pixel_contrast import (
        _hard_anchor_sampling, _masked_contrastive)
    from doubly_contrastive_semseg_tpu_torch.ops import contrastive
    from doubly_contrastive_semseg_tpu_torch.ops.interpolate import resize_nearest
    from doubly_contrastive_semseg_tpu_torch.tools.profile_contrastive import LAUNCHES
    from doubly_contrastive_semseg_tpu_torch.tools.profile_train import make_batch
    from doubly_contrastive_semseg_tpu_torch.train import (
        TrainState, build_optimizer, make_train_step)

    n_rows = DENSE_BATCH * 19 * 2
    log(f"== 19a. {SWIFT} dense-contrast step: batch {DENSE_BATCH} x 2 views at "
        f"{DENSE_CROP}², bf16; pixel contrast N = {n_rows}, D = {D_FEAT}")
    cfg = Config(model=SWIFT, criterion=CRITERION, dataset="acdc")
    torch.backends.cudnn.benchmark = False
    model = build_model(cfg, device=dev, seed=23)
    opt = build_optimizer(model, cfg, steps_per_epoch=200)
    state = TrainState(model, opt)
    step = make_train_step(model, cfg, opt)
    batch = make_batch(DENSE_BATCH, DENSE_CROP, gen, dev)
    kernels = {"contrastive_row_stats": contrastive.contrastive_row_stats,
               "pos_sweep_layout": contrastive.pos_sweep_layout,
               "pixel_contrast_pos_sweep": contrastive.pixel_contrast_pos_sweep}
    reset()
    times = []
    for i in range(3):
        before = {k: fn.launches for k, fn in kernels.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, batch, torch.Generator(device=dev).manual_seed(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        comps = {k: v.item() for k, v in metrics.items()}
        d3, d_layout, d4 = (fn.launches - before[k] for k, fn in kernels.items())
        log(f"  step {i}: {1e3 * times[-1]:.1f} ms, K3 launches {d3}, K4 layouts {d_layout} "
            f"and sweeps {d4}; " + ", ".join(f"{k} {v:.5f}" for k, v in comps.items()))
        check(d3 == LAUNCHES and d_layout == 1 and d4 == 1,
              f"19a: each dense step must launch K3 {LAUNCHES} times and K4's layout and sweep "
              "once")
        check(finite(comps), f"19a dense step {i}: a loss is not finite")
    launches = read()
    check(all(v == 0 for k, v in launches.items() if k not in kernels),
          f"19a dense: only K3 and K4 may launch: {launches}")
    ms = 1e3 * sum(times[1:]) / 2
    log(f"  {card}: 19a dense {ms:.2f} ms a step over steps 2-3 "
        f"({', '.join(f'{1e3 * t:.2f}' for t in times)} for steps 1-3); launches {launches}")

    model.train()
    with torch.no_grad():
        out = model(batch["left"].float(), return_supcon_feature=True)
        feats = out["fine_feat0"]
        b, h, w, d = feats.shape
        preds = resize_nearest(out["seg_beforeup"].argmax(-1), (h, w))
        labels = resize_nearest(batch["label"], (h, w))
        anchors, a_lab, a_val = _hard_anchor_sampling(
            feats.reshape(b, h * w, d).float(), labels.reshape(b, -1),
            preds.reshape(b, -1).to(labels.dtype), 19, torch.Generator(device=dev).manual_seed(7))
    del out, feats, preds
    res = []
    for use_kernel in (True, False):
        x = anchors.detach().clone().requires_grad_(True)
        loss = _masked_contrastive(x, a_lab, a_val, 0.07, 0.07, use_kernel=use_kernel)
        loss.backward()
        res.append((loss.item(), x.grad))
    d_loss = abs(res[0][0] - res[1][0]) / max(abs(res[1][0]), 1e-30)
    d_grad = ((res[0][1] - res[1][1]).abs().max() / res[1][1].abs().max()).item()
    log(f"  anchors (N = {2 * anchors.shape[0]}, D = {anchors.shape[-1]}): loss kernel "
        f"{res[0][0]:.7f}, plain {res[1][0]:.7f} (rel {d_loss:.2e}, tolerance 1e-4); dZ max abs "
        f"err {d_grad:.2e} of max|dZ| (tolerance 1e-3)")
    check(d_loss <= 1e-4 and d_grad <= 1e-3,
          "19a: the kernel route's loss or dZ disagrees with the plain route")
    del model, opt, state, step, batch, metrics, anchors, res
    torch.cuda.empty_cache()
    log(f"  K3 and K4 alone at the step's N = {n_rows}, D = {D_FEAT} (f32):")
    alone = profile_contrastive.wide_d(gen, dev, log, n=n_rows, ds=(D_FEAT,))[D_FEAT]
    return launches, ms, alone


def other_backbones_phase(torch, dev, card, gen, reset, read):
    """19b. The other five ported WeatherNet backbones once each: two bf16
    train steps at 2 × 2 views of ``OTHER_CROP``², one eval batch (the
    hourglass's calls none of its disparity convs), and one f32 serving
    batch of 1024×512 through K1, held to the plain head on 0.9999 of the
    pixels: 5 K1 launches in all. Returns the K1 launches."""
    from doubly_contrastive_semseg_tpu_torch import Config, build_model, make_serving_fn
    from doubly_contrastive_semseg_tpu_torch.tools.profile_train import make_batch
    from doubly_contrastive_semseg_tpu_torch.train import (
        build_optimizer, compute_loss, init_eval_accum, make_eval_step)

    names = [m for m in SWIFT_FAMILY if m != SWIFT]
    log(f"== 19b. the other {len(names)} WeatherNet backbones: two bf16 train steps (2 x 2 "
        f"views, {OTHER_CROP}²), one eval batch, one f32 1024x512 serving batch through K1")
    torch.backends.cudnn.benchmark = False
    b, s = 2, OTHER_CROP
    batch = make_batch(b, s, gen, dev)
    serve_x = torch.randint(0, 256, (1, 512, 1024, 3), generator=gen).float().to(dev)
    reset()
    for name in names:
        t0 = time.perf_counter()
        cfg = Config(model=name, criterion=CRITERION, dataset="acdc")
        model = build_model(cfg, device=dev, seed=24)
        opt = build_optimizer(model, cfg, steps_per_epoch=200)
        model.train()
        step_ms = []
        for i in range(2):   # the first step meets cuDNN's and the allocator's first calls
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            total, comps, out = compute_loss(model, cfg, batch,
                                             torch.Generator(device=dev).manual_seed(i))
            total.backward()
            opt.step()
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t1))
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        comps = {k: v.item() for k, v in comps.items()}
        grads_ok = all(torch.isfinite(p.grad).all().item() for p in model.parameters()
                       if p.grad is not None)
        fe = model.net.feature_extractor
        branch = []
        if name == "resnet18_hourglass":
            branch = [m for n in ["conv4a"] + [n for n, *_ in fe._LADDER]
                      for m in getattr(fe, n).modules()
                      if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
        calls = []
        hooks = [m.register_forward_hook(lambda *_: calls.append(1)) for m in branch]
        preds, accum = make_eval_step(model, cfg)(
            {"left": batch["left"][:b], "label": batch["label"], "weather": batch["weather"]},
            init_eval_accum(cfg, dev))
        for hk in hooks:
            hk.remove()
        # the same weights at f32 (no second draw of them: the hourglass has 83 M)
        with torch.device("meta"):
            model32 = build_model(Config(model=name, criterion=CRITERION, compute_dtype="float32"),
                                  device="meta")
        model32.load_state_dict(model.state_dict(), assign=True)
        del model, opt, out, total
        model = model32.to(memory_format=torch.channels_last).eval()
        randomize_bn(model, gen)
        before = read()["fused_seghead_upsample_argmax"]
        labels = make_serving_fn(model, device=dev)(serve_x)
        k1 = read()["fused_seghead_upsample_argmax"] - before
        with torch.no_grad():
            feat = model.net.feature_extractor(serve_x)[0].permute(0, 2, 3, 1).contiguous()
        agree = decided_agreement(torch, feat, model.net.segmentation, labels)[0]
        torch.cuda.synchronize()
        log(f"  {card}: 19b {name}: train step {step_ms[1]:.2f} ms (first {step_ms[0]:.1f}); "
            f"fine_feat {shapes['fine_feat']}, loss {comps['total_loss']:.4f}, eval "
            f"preds {tuple(preds.shape)}" + (f", disparity convs in eval {len(calls)} of "
                                             f"{len(branch)}" if branch else "")
            + f"; f32 serving K1 launches {k1}, labels vs the plain head {agree:.6f} (bar "
            f"0.9999); {time.perf_counter() - t0:.1f} s")
        check(shapes["seg"] == (b, s, s, 19) and shapes["fine_feat"] == (2 * b, s // 4, s // 4, 128)
              and shapes["supcon_proj"] == (b, 2, 128) and finite(comps) and grads_ok
              and tuple(preds.shape) == (b, s, s)
              and float(accum["cm"].sum()) == float((batch["label"] != 255).sum())
              and not calls and (name != "resnet18_hourglass" or len(branch) == 25),
              f"19b {name}: outputs {shapes}, losses {comps}, finite gradients {grads_ok}, "
              f"disparity convs in eval {len(calls)}")
        check(k1 == 1 and labels.shape == (1, 512, 1024) and agree >= 0.9999,
              f"19b {name}: f32 serving through K1")
        del model, feat, labels, preds, accum
        torch.cuda.empty_cache()
    got = read()
    log(f"  19b launches: {got}")
    check(got["fused_seghead_upsample_argmax"] == len(names) and
          all(v == 0 for k, v in got.items() if k != "fused_seghead_upsample_argmax"),
          f"19b: K1 once a model ({len(names)}) and nothing else: {got}")
    return got["fused_seghead_upsample_argmax"]


def swift_cli_phase(torch, dev, card, reset, read):
    """19c. ``main --model SWIFT``: one epoch of 2 steps (host crops, 1
    loader thread) and 4 val frames of 1024×2048; ``inference`` with its
    checkpoint on 4 PNGs of ``VAL_WIDTH``×``VAL_HEIGHT`` (layer 4 at 34 ×
    60: the SPP's unequal windows). No kernel launches on these paths."""
    from doubly_contrastive_semseg_tpu_torch import inference as port_inference
    from doubly_contrastive_semseg_tpu_torch.data import SyntheticDataset, read_png, write_png
    from doubly_contrastive_semseg_tpu_torch.main import main as port_main

    with tempfile.TemporaryDirectory() as base:
        argv = ["--dataset", "synthetic", "--synthetic_hw", SYNTHETIC_HW,
                "--synthetic_size", str(2 * TRAIN_BATCH), "--train_semantic",
                "--criterion", CRITERION, "--batch_size", str(TRAIN_BATCH),
                "--print_freq", "1", "--summary_freq", "1", "--run_root", base,
                "--device", dev.type, "--model", SWIFT, "--epochs", "1", "--num_workers", "1"]
        log(f"== 19c. main --model {SWIFT}: 1 epoch of 2 steps, validate; inference on "
            f"{INFER_FRAMES} PNGs of {VAL_WIDTH}x{VAL_HEIGHT}")
        reset()
        t0 = time.perf_counter()
        tr = port_main(argv)
        dt = time.perf_counter() - t0
        losses = scalars(tr.saver.experiment_dir, "train/total_loss_print_freq")
        check(len(losses) == 2 and all(np.isfinite(v) for _, v in losses),
              f"19c: 2 finite losses in metrics.jsonl: {losses}")
        ((_, frames, wall),) = tr.val_times
        best = os.path.join(tr.saver.checkpoint_dir, "score_best_checkpoint")
        check(os.path.exists(best), "19c: main saved no score_best_checkpoint")
        log(f"  {card}: 19c main: {dt:.2f} s (epoch {tr.epoch_seconds[0]:.2f} s); ms a step "
            "(loader wait, step): " + ", ".join(f"({1e3 * s[1]:.1f}, {1e3 * s[2]:.1f})"
                                                for s in tr.step_times)
            + f"; val {frames} frames, {frames / wall:.2f} frames/s end to end; checkpoint "
            f"{os.path.getsize(best) / 1e6:.2f} MB")
        del tr
        frames_dir, out_dir = os.path.join(base, "frames"), os.path.join(base, "out")
        os.makedirs(frames_dir)
        src = SyntheticDataset(size=INFER_FRAMES, image_hw=(VAL_HEIGHT, VAL_WIDTH), seed=19)
        for i in range(INFER_FRAMES):
            write_png(os.path.join(frames_dir, f"frame{i}.png"), src[i]["left"], "adaptive")
        res = port_inference.main(["--input", frames_dir, "--resume", best, "--model", SWIFT,
                                   "--device", dev.type, "--output_dir", out_dir])
        for i in range(INFER_FRAMES):
            pred = read_png(os.path.join(out_dir, f"frame{i}_pred.png"))
            check(pred.shape == (VAL_HEIGHT, VAL_WIDTH) and int(pred.max()) < 19,
                  f"19c: inference's frame{i}_pred.png")
        fwd = res["forward_s"][1:]
        log(f"  {card}: 19c inference: {INFER_FRAMES} frames, {len(fwd) / sum(fwd):.2f} "
            "frames/s (first skipped)")
        expect_launches(read(), "19c main, inference")


def new_datasets_phase(torch, dev, card, reset, read, profile_host_data, profile_stem):
    """20. The datasets ``main`` refused until now, on trees of PNGs at the
    real sizes written with ``write_png`` (five filters in turns down each
    frame), at full width (``resnet18``, bf16, host crops, 1 loader thread,
    an epoch of 2 steps, then validation at 1920x1080): ``cityscapes`` (a),
    ``acdc_city`` with ``--weather_num 5`` and the flagship criterion, its
    per-weather mIoU keys 0-4 (b), ``city_lost --new_crop`` (20 classes,
    ``CropBlackArea``, 1024x512 crops) fused and ``--not_md_fusion`` (c);
    the refusals of runs that read a weather these datasets lack (d); the
    inference CLI on JPEGs, at f32 equal to the same pixels as PNGs (e).
    K2 launches 3 times a val batch and an image and is held to its plain
    version at these shapes. Returns K2's launches by run."""
    import logging
    import re
    import signal

    from PIL import Image

    from doubly_contrastive_semseg_tpu_torch import inference as port_inference
    from doubly_contrastive_semseg_tpu_torch.data import (ACDC_City, Cityscapes, LostFound,
                                                          read_image, read_png, write_png)
    from doubly_contrastive_semseg_tpu_torch.main import main as port_main
    from doubly_contrastive_semseg_tpu_torch.metrics.evaluator import WEATHER_NAMES
    from doubly_contrastive_semseg_tpu_torch.ops.input_pipeline import pyramid_hw

    t20 = time.perf_counter()
    k2 = {}
    with tempfile.TemporaryDirectory() as base:
        t0 = time.perf_counter()
        lists = profile_host_data.write_cityscapes_tree(base, CITY_TRAIN, CITY_VAL)
        profile_host_data.write_acdc_tree(base, ACDC20_TRAIN, ACDC20_VAL)
        profile_host_data.write_lostfound_tree(base, LF_TRAIN, LF_VAL)
        log(f"== 20. the new datasets through main: trees written in "
            f"{time.perf_counter() - t0:.1f} s (Cityscapes {CITY_TRAIN} + {CITY_VAL} and "
            f"Lost&Found {LF_TRAIN} + {LF_VAL} frames of 1024x2048, ACDC {ACDC20_TRAIN} + "
            f"{ACDC20_VAL} of 1080x1920)")
        img, right, ids = profile_host_data.city_frame(100)
        s = Cityscapes(os.path.join(base, "cityscapes"), filelist_root=lists)[0]
        check(np.array_equal(s["left"], img) and np.array_equal(s["right"], right)
              and np.array_equal(s["label"], Cityscapes.encode_target(ids)),
              "20: a Cityscapes sample does not read back as written")
        img, ids = profile_host_data.lostfound_frame(200)
        s = LostFound(os.path.join(base, "city_lost"), filelist_root=lists)[0]
        check(np.array_equal(s["left"], img) and set(np.unique(s["label"])) == {0, 19, 255},
              "20: a Lost&Found sample does not read back as written")
        weathers = [r["weather"] for r in ACDC_City(os.path.join(base, "acdc_city"), mode="val",
                                                     filelist_root=lists).samples]
        check(sorted(set(weathers)) == [0, 1, 2, 3, 4], f"20: acdc_city val weathers {weathers}")

        common = ["--train_semantic", "--data_root", base, "--filelist_root", lists,
                  "--num_workers", "1", "--epochs", "1", "--print_freq", "1", "--summary_freq",
                  "1", "--run_root", os.path.join(base, "runs"), "--device", dev.type]

        def run(what, argv, batch):
            reset()
            t0 = time.perf_counter()
            tr = port_main(argv + common + ["--batch_size", str(batch)])
            dt = time.perf_counter() - t0
            n_val = len(tr.val_loader)
            expect_launches(read(), f"{what} main", k2=3 * n_val)
            k2[what] = 3 * n_val
            cfg = tr.cfg
            check(cfg.model == "resnet18" and cfg.compute_dtype == "bfloat16" and cfg.host_augment
                  and len(tr.train_loader) == 2, f"{what}: not the full-width bf16 run of 2 steps")
            losses = scalars(tr.saver.experiment_dir, "train/total_loss_print_freq")
            check(len(losses) == 2 and all(np.isfinite(v) for _, v in losses),
                  f"{what}: 2 finite losses in metrics.jsonl: {losses}")
            ((_, frames, wall),) = tr.val_times
            log(f"  {card}: {what} main {dt:.2f} s (epoch {tr.epoch_seconds[0]:.2f} s; train "
                f"{len(tr.train_dst)}, val {len(tr.val_dst)} frames; crops {cfg.crop_wh[0]}x"
                f"{cfg.crop_wh[1]}, batch {batch}{' x 2 views' if cfg.use_supcon else ''}, "
                f"{cfg.num_classes} classes); ms a step (loader wait, step): "
                + ", ".join(f"({1e3 * s[1]:.1f}, {1e3 * s[2]:.1f})" for s in tr.step_times)
                + f"; val {frames} frames, {frames / wall:.2f} frames/s end to end; losses "
                + ", ".join(f"{v:.4f}" for _, v in losses))
            return tr

        tr_a = run("20a cityscapes", ["--dataset", "cityscapes", "--criterion",
                                      "pixelcontrast_focal"], 2)
        best = os.path.join(tr_a.saver.checkpoint_dir, "score_best_checkpoint")
        check(os.path.exists(best), "20a: main saved no score_best_checkpoint")

        tr = run("20b acdc_city", ["--dataset", "acdc_city", "--weather_num", "5",
                                   "--criterion", CRITERION], 3)
        with open(tr.saver.save_file_return()) as f:
            miou = dict(re.findall(r"^mIoU in (\w+) : (\S+)$", f.read(), re.M))
        by_id = {w: miou.get(name) for w, name in WEATHER_NAMES.items()}
        cm = tr.evaluator.confusion_matrix_sem_weather
        log(f"  20b per-weather mIoU in val_results.txt: "
            + ", ".join(f"{w} ({WEATHER_NAMES[w]}) {v}" for w, v in by_id.items())
            + "; pixels a weather " + ", ".join(f"{int(cm[w].sum())}" for w in range(5)))
        check(tr.cfg.weather_num == 5 and all(v is not None for v in by_id.values())
              and all(cm[w].sum() > 0 for w in range(5)),
              "20b: val_results.txt lacks a weather's mIoU, or a weather has no pixels")

        for what, extra, batch in (("20c city_lost", [], 4),
                                   ("20c city_lost --not_md_fusion", ["--not_md_fusion"], 2)):
            tr = run(what, ["--dataset", "city_lost", "--new_crop", "--criterion",
                            "pixelcontrast_focal"] + extra, batch)
            check(tr.cfg.crop_wh == (1024, 512) and tr.cfg.num_classes == 20
                  and tr.model.net.segmentation.conv.out_channels == 20
                  and len(tr.train_dst) == LF_TRAIN + (0 if extra else CITY_TRAIN),
                  f"{what}: not the 20-class 1024x512 run on its samples")
        del tr

        # d. runs that read a weather label cityscapes and city_lost lack
        for argv in (["--dataset", "cityscapes", "--criterion", CRITERION],
                     ["--dataset", "city_lost", "--criterion", "pixelcontrast_focal",
                      "--no_host_augment"]):
            try:
                port_main(argv + common + ["--batch_size", "2"])
            except ValueError as e:
                check("carry no 'weather'" in str(e), f"20d: {e}")
                log(f"  20d {' '.join(argv)}: refused: {e}")
            else:
                raise RuntimeError(f"chip_smoke: 20d: {argv} ran without a weather label")

        # e. the inference CLI on JPEGs, against the same pixels as PNGs
        src = {k: os.path.join(base, k) for k in ("jpeg", "png", "out_jpeg", "out_png")}
        os.makedirs(src["jpeg"])
        os.makedirs(src["png"])
        decode_ms = []
        for i in range(JPEG_FRAMES):
            frame = profile_host_data.acdc_frame(300 + i)[0]
            jpg = os.path.join(src["jpeg"], f"frame{i}.jpg")
            Image.fromarray(frame).save(jpg, quality=90)
            t0 = time.perf_counter()
            pixels = read_image(jpg)
            decode_ms.append(1e3 * (time.perf_counter() - t0))
            check(np.array_equal(pixels, np.asarray(Image.open(jpg).convert("RGB"))),
                  "20e: read_image is not PIL's decode")
            write_png(os.path.join(src["png"], f"frame{i}.png"), pixels, "adaptive")
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        reset()
        res = {k: port_inference.main(["--input", src[k], "--resume", best, "--compute_dtype",
                                       "float32", "--device", dev.type, "--output_dir",
                                       src["out_" + k]]) for k in ("jpeg", "png")}
        torch.backends.cudnn.deterministic = False
        expect_launches(read(), "20e inference, f32", k2=3 * 2 * JPEG_FRAMES, tc=0)
        k2["20e inference"] = 3 * 2 * JPEG_FRAMES
        for i in range(JPEG_FRAMES):
            a, b = (read_png(os.path.join(src["out_" + k], f"frame{i}_pred.png"))
                    for k in ("jpeg", "png"))
            check(a.shape == (VAL_HEIGHT, VAL_WIDTH) and np.array_equal(a, b),
                  f"20e: frame{i}'s f32 labels from the JPEG differ from the PNG's")
        fwd = res["jpeg"]["forward_s"][1:]
        log(f"  {card}: 20e inference on {JPEG_FRAMES} JPEGs of {VAL_WIDTH}x{VAL_HEIGHT}, f32: "
            f"labels equal the same pixels' as PNGs; {len(fwd) / sum(fwd):.2f} frames/s "
            f"(forward, first skipped); PIL decode {', '.join(f'{v:.1f}' for v in decode_ms)} ms")

        def levels(b):
            return [(b,) + pyramid_hw(VAL_HEIGHT, VAL_WIDTH, lv) for lv in range(3)]

        log("  K2 at the val batches' levels (2, 4 and 6 frames at 1080x1920) and the "
            "inference's (1) vs stem_pool_reference:")
        profile_stem.check_routes(torch.Generator().manual_seed(20), dev, log,
                                  shapes=levels(1) + levels(2) + levels(4) + levels(6))

        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, signal.SIG_DFL if sig == signal.SIGTERM
                          else signal.default_int_handler)
        root = logging.getLogger()
        for hnd in list(root.handlers):
            root.removeHandler(hnd)
            hnd.close()
    torch.cuda.empty_cache()
    log(f"  {card}: phase 20 took {time.perf_counter() - t20:.1f} s")
    return k2


GRAIN_SIZE = 32                        # 21a: 4 steps of main's batch 8 an epoch
TSNE_SIZE = 24                         # 21b: 3 batches of 8, 24 image features
ADAM_STEP_BOUND = 0.1 / 0.001 ** 0.5   # |Adam update| <= lr (1 - b1) / sqrt(1 - b2)


def grain_tools_phase(torch, dev, card, reset, read, libs):
    """21. The grain loader's mid-epoch position and the tools, through
    ``main`` at full width (synthetic 1024x2048 frames, the flagship,
    ``main``'s batch 8, bf16): (a) ``--loader grain --no_host_augment
    --rescue_interval 2`` for 2 epochs of 4 steps in process, the same run
    as a subprocess SIGKILLed once its third step has logged, and the resume
    from its rescue checkpoint in process: the rescue is mid-epoch at
    num_iter 2, the resume trains epoch 0's last 2 steps then epoch 1's 4 on
    exactly the uninterrupted run's samples, JF 88 times a step, and ends
    within the stated tolerances of the uninterrupted run's losses and
    parameters; (b) ``main --tsne`` (image mode, 24 frames): K2 3 times a
    batch, ``tsne.png`` where sklearn and matplotlib import (else ``run``
    must raise ``ImportError`` naming the missing one, and the feature pass
    runs in both modes), one batch's features card vs CPU at f32; (c)
    ``model_complexity`` of the flagship at 768² and the EDT visualizer's
    PNGs. Returns K2's and JF's launches and the times."""
    import logging
    import signal

    from doubly_contrastive_semseg_tpu_torch import Config, build_model
    from doubly_contrastive_semseg_tpu_torch import visualize_balancing_weight as edt_viz
    from doubly_contrastive_semseg_tpu_torch.config import parse_args
    from doubly_contrastive_semseg_tpu_torch.main import main as port_main
    from doubly_contrastive_semseg_tpu_torch.ops import edt
    from doubly_contrastive_semseg_tpu_torch.tools.tsne import Viz
    from doubly_contrastive_semseg_tpu_torch.utils.complexity import model_complexity

    t21, out = time.perf_counter(), {}
    per_step = len(edt.jfa_launches(TRAIN_CROP, TRAIN_CROP))
    with tempfile.TemporaryDirectory() as base:
        grain = ["--dataset", "synthetic", "--synthetic_hw", SYNTHETIC_HW, "--synthetic_size",
                 str(GRAIN_SIZE), "--train_semantic", "--criterion", CRITERION,
                 "--loader", "grain", "--no_host_augment", "--epochs", "2", "--print_freq", "1",
                 "--summary_freq", "1", "--run_root", base, "--device", dev.type]
        cfg = parse_args(grain)
        check(cfg.batch_size == TRAIN_BATCH and cfg.compute_dtype == "bfloat16"
              and cfg.model == "resnet18" and cfg.crop_wh == (TRAIN_CROP, TRAIN_CROP),
              "phase 21a must run main's defaults at full width")
        log(f"== 21a. main --loader grain --no_host_augment: synthetic {SYNTHETIC_HW} "
            f"({GRAIN_SIZE} train frames: 4 steps an epoch, {cfg.num_workers} loader threads), "
            f"{TRAIN_CROP}² crops on the card, batch {TRAIN_BATCH} x 2 views, bf16, {CRITERION}, "
            "2 epochs; uninterrupted in process, then SIGKILLed in a subprocess after its third "
            "step (--rescue_interval 2), then resumed in process")
        reset()
        t0 = time.perf_counter()
        full = port_main(grain + ["--checkname", "full"])
        full_s = time.perf_counter() - t0
        launches = read()
        n_full = len(full.step_times)
        check(n_full == 8, f"21a: the uninterrupted run took {n_full} steps, not 8")
        expect_launches(launches, "21a uninterrupted, 8 steps", k2=3 * len(full.val_loader) * 2,
                        jf=per_step * n_full)
        out["jf_uninterrupted"] = launches["nearest_diff_label_distance"]
        log(f"  {card}: 21a uninterrupted: {full_s:.2f} s; ms a step (loader wait, step): "
            + ", ".join(f"({1e3 * w:.1f}, {1e3 * t:.1f})" for _, w, t in full.step_times))
        out["grain_steps_ms"] = [1e3 * t for _, _, t in full.step_times]

        repo = os.path.dirname(os.path.abspath(__file__))
        proc = subprocess.Popen(
            [sys.executable, "-m", "doubly_contrastive_semseg_tpu_torch.main", *grain,
             "--rescue_interval", "2", "--checkname", "killed"],
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")})
        lines, t_start, killed = [], time.perf_counter(), False
        try:
            for line in proc.stdout:
                lines.append(line)
                if "][  3/  4]" in line:          # step 3 logged: the rescue at 2 is written
                    proc.send_signal(signal.SIGKILL)
                    killed = True
                    break
                check(time.perf_counter() - t_start < 240, "21a: the subprocess's third step "
                      "did not come within 240 s: " + "".join(lines[-10:]))
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
        check(killed and proc.returncode == -signal.SIGKILL,
              f"21a: the subprocess must die of SIGKILL after step 3 (exit {proc.returncode}): "
              + "".join(lines[-20:]))
        (killed_run,) = [dp for dp, _, fn in os.walk(os.path.join(base, "synthetic", "killed"))
                         if "args.json" in fn]
        rescue = os.path.join(killed_run, "checkpoints", "rescue_checkpoint")
        with open(rescue + ".meta.json") as f:
            rmeta = json.load(f)
        with open(rescue + ".loader_state", "rb") as f:
            position = json.loads(f.read())
        log(f"  21a subprocess SIGKILLed {time.perf_counter() - t_start:.1f} s after its start; "
            f"rescue meta {rmeta}; loader state last_seen_indices "
            f"{position['last_seen_indices']}, worker_count {position['worker_count']}")
        check(rmeta["mid_epoch"] is True and rmeta["num_iter"] == 2 and rmeta["epoch"] == 0,
              f"21a: the rescue must be mid-epoch 0 at num_iter 2: {rmeta}")

        reset()
        t0 = time.perf_counter()
        res = port_main(grain + ["--checkname", "resumed", "--resume", rescue,
                                 "--continue_training", "--rescue_interval", "2"])
        res_s = time.perf_counter() - t0
        launches = read()
        n_res = len(res.step_times)
        expect_launches(launches, f"21a resumed, {n_res} steps", k2=3 * len(res.val_loader) * 2,
                        jf=per_step * n_res)
        out["jf_resumed"] = launches["nearest_diff_label_distance"]
        ep0 = [s for s in res.step_samples if s[0] == 0]
        check(len(ep0) == 2 and n_res == 6, f"21a: the resume must train epoch 0's 2 remaining "
              f"steps and epoch 1's 4, not {len(ep0)} and {n_res - len(ep0)}")
        check(res.step_samples == full.step_samples[2:],
              "21a: the resumed run's samples differ from the uninterrupted run's: "
              f"{res.step_samples} vs {full.step_samples[2:]}")
        log(f"  21a resumed: {res_s:.2f} s, {n_res} steps; samples of every step equal the "
            f"uninterrupted run's steps 3-8 (epoch 0: {ep0})")

        tag = "train/total_loss_print_freq"
        want = dict(scalars(full.saver.experiment_dir, tag))
        got = dict(scalars(res.saver.experiment_dir, tag))
        check(sorted(got) == list(range(3, 9)), f"21a: the resumed run logs num_iter {sorted(got)}")
        loss_err = max(abs(got[k] - want[k]) / abs(want[k]) for k in got)
        lr = max(g["base_lr"] for g in full.optimizer.param_groups)
        bound = 2 * ADAM_STEP_BOUND * lr * n_full
        sd_f, sd_r = full.model.state_dict(), res.model.state_dict()
        trained = {n for n, p in full.model.named_parameters() if p.requires_grad}
        p_err = max((sd_f[k].float() - sd_r[k].float()).abs().max().item() for k in trained)
        buf_err = max(((sd_f[k].float() - sd_r[k].float()).norm()
                       / sd_f[k].float().norm().clamp_min(1e-12)).item()
                      for k in sd_f if k not in trained and sd_f[k].is_floating_point())
        log(f"  21a resumed vs uninterrupted: losses of updates 3-8 max rel diff {loss_err:.3e} "
            f"(bar 5e-2); parameters max abs diff {p_err:.3e} (bar {bound:.3e}); BN statistics "
            f"max rel L2 diff {buf_err:.3e} (bar 0.25)")
        # not bits: cuDNN tunes (benchmark) in each process and the card's
        # atomics order sums differently, so the runs part after the first
        # update. An Adam update moves a parameter by at most lr (1 - b1) /
        # sqrt(1 - b2) = 3.16 lr (Kingma & Ba, sec. 2.1), so two runs that
        # part at update 1 end at most 2 x 3.16 lr x 8 apart; their losses,
        # bf16 (2^-8 a rounding), stay within a few % where a step on other
        # samples or another crop moves them by the spread between steps.
        # The BN running statistics fold in every step's batch moments, so
        # they carry the parameters' drift: the bar is a sanity bound, 8x
        # the 3.1e-2 that the same runs gave on the CPU (bf16, 4 threads).
        check(loss_err <= 5e-2 and p_err <= bound and buf_err <= 0.25,
              "21a: the resumed run strays from the uninterrupted one")
        del full, res, sd_f, sd_r

        # b. main --tsne, image mode (a SupCon criterion), on the flagship; the
        # whole frames (--no_host_augment): host crops in two views would give
        # 2B features for B weathers, which JAX's run() and the port's refuse
        tsne = ["--dataset", "synthetic", "--synthetic_hw", SYNTHETIC_HW, "--synthetic_size",
                str(TSNE_SIZE), "--criterion", CRITERION, "--no_host_augment", "--tsne",
                "--run_root", base, "--checkname", "tsne", "--device", dev.type]
        have = libs.get("sklearn") is True and libs.get("matplotlib") is True
        log(f"== 21b. main --tsne: synthetic {SYNTHETIC_HW} whole, {TSNE_SIZE} frames in batches of "
            f"{TRAIN_BATCH}, flagship bf16, image mode; sklearn and matplotlib "
            f"{'import' if have else 'do not both import'} here")
        reset()
        t0 = time.perf_counter()
        if have:
            viz = port_main(tsne)
            tsne_s = time.perf_counter() - t0
            png = os.path.join(viz.saver.experiment_dir, "tsne.png")
            check(os.path.isfile(png) and os.path.getsize(png) > 0, "21b: no tsne.png")
            log(f"  {card}: 21b main --tsne {tsne_s:.2f} s end to end; {png} "
                f"{os.path.getsize(png)} bytes")
        else:
            viz = Viz(parse_args(tsne), device=dev)
            try:
                viz.run()
            except ImportError as e:
                check(e.name in ("sklearn", "matplotlib") and libs.get(e.name) is not True,
                      f"21b: run() raised ImportError for {e.name!r}: {e}")
                log(f"  21b run() raised ImportError naming {e.name!r}, as phase 0 found")
            else:
                check(False, "21b: run() must raise ImportError without sklearn or matplotlib")
            viz.get_features(mode="image")        # the pass run() would have made
        n_batches = min(16, len(viz.loader))
        launches = read()
        expect_launches(launches, f"21b main --tsne, {n_batches} batches", k2=3 * n_batches)
        out["k2_tsne"] = launches["fused_stem_pool"]
        for mode in ("image", "pixel"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats, labels = viz.get_features(mode=mode)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check(np.isfinite(feats).all() and feats.shape[1] == 128
                  and len(labels) == len(feats) and len(feats) > 0,
                  f"21b: {mode} features {feats.shape}")
            log(f"  {card}: 21b get_features({mode}): {feats.shape[0]} features of "
                f"{feats.shape[1]} in {dt:.2f} s ({n_batches * TRAIN_BATCH / dt:.2f} frames/s "
                "with the loader)")
            if mode == "image" and have:
                from sklearn.manifold import TSNE
                t0 = time.perf_counter()
                TSNE(n_components=2, init="pca",
                     perplexity=min(30, max(2, len(feats) // 4))).fit_transform(feats)
                out["tsne_s"] = time.perf_counter() - t0
                log(f"  21b sklearn t-SNE over {len(feats)} features: {out['tsne_s']:.2f} s "
                    "on the host")
        # one batch (its first 2 frames: the CPU's share), card vs CPU at f32
        batch = next(iter(viz.loader))
        x = torch.as_tensor(batch["left"][:2]).float()
        f32 = Config(compute_dtype="float32", criterion=CRITERION)
        card32 = build_model(f32, device=dev)
        card32.load_state_dict(viz.model.state_dict())
        cpu32 = build_model(f32, device="cpu")
        cpu32.load_state_dict({k: v.cpu() for k, v in viz.model.state_dict().items()})
        torch.backends.cudnn.benchmark = False     # its f32 algorithms err more
        with torch.no_grad():
            fc = card32(x.to(dev))["fine_feat0"].float().cpu()
            fh = cpu32(x)["fine_feat0"].float()
        torch.backends.cudnn.benchmark = True
        scale = fh.abs().max().item()
        pix_err = (fc - fh).abs().max().item() / scale
        img_err = (fc.mean((1, 2)) - fh.mean((1, 2))).abs().max().item() / scale
        log(f"  21b fine_feat0 of 2 frames at f32, card vs CPU: per-image means max abs err "
            f"{img_err:.3e} of max|f| (bar 1e-4), pixels {pix_err:.3e} (bar 1e-2: a ReLU gate "
            "within rounding of 0 may flip)")
        check(img_err <= 1e-4 and pix_err <= 1e-2, "21b: the card's features disagree with the "
              "CPU's")
        del viz, card32, cpu32, fc, fh

        # c. model_complexity at 768² and the EDT visualizer
        log("== 21c. model_complexity of the flagship (bf16) at 768² on the card; the EDT "
            "visualizer")
        model = build_model(Config(), device=dev)
        t0 = time.perf_counter()
        cx = model_complexity(model, (1, TRAIN_CROP, TRAIN_CROP, 3), device=dev)
        log(f"  {card}: 21c model_complexity {json.dumps(cx)} in "
            f"{time.perf_counter() - t0:.2f} s")
        check(abs(cx["params_m"] * 1e6 - sum(p.numel() for p in model.parameters())) < 1
              and cx["flops_g"] > 0 and cx["bytes_accessed_g"] > 0, "21c: model_complexity")
        out["complexity"] = cx
        del model
        edt_argv = ["--dataset", "synthetic", "--synthetic_hw", SYNTHETIC_HW, "--synthetic_size",
                    "16", "--train_semantic", "--run_root", os.path.join(base, "edt")]
        t0 = time.perf_counter()
        if libs.get("matplotlib") is True:
            paths = edt_viz.main(edt_argv)
            check(len(paths) == 8 and all(os.path.getsize(p) > 0 for p in paths),
                  f"21c: EDT visualizer PNGs {paths}")
            log(f"  21c EDT visualizer: {len(paths)} PNGs ("
                + ", ".join(str(os.path.getsize(p)) for p in paths) + f" bytes) in "
                f"{time.perf_counter() - t0:.2f} s")
        else:
            panels = edt_viz.edt_panels(parse_args(edt_argv))
            check(len(panels) == 8 and all(np.isfinite(w).all() for _, _, w in panels),
                  "21c: EDT panels")
            log(f"  21c EDT visualizer: no matplotlib, {len(panels)} panels' arrays computed")

        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, signal.SIG_DFL if sig == signal.SIGTERM
                          else signal.default_int_handler)
        root = logging.getLogger()
        for hnd in list(root.handlers):
            root.removeHandler(hnd)
            hnd.close()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t21
    log(f"  {card}: phase 21 took {out['seconds']:.1f} s")
    return out


def stereo_pair(torch, gen, b, h, w):
    """(left, right) uint8 NHWC on the CPU: noise, the right view the left
    shifted ``STEREO_SHIFT`` columns (disparity 24) with fresh noise where
    it has no match."""
    left = torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8)
    right = torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8)
    right[:, :, :w - STEREO_SHIFT] = left[:, :, STEREO_SHIFT:]
    return left, right


def randomize_offsets(torch, model, gen) -> None:
    """Small random offset (and mask) convs from ``gen``: the deformable
    samples move, well inside the window form's ±2 px."""
    from doubly_contrastive_semseg_tpu_torch.ops.deform_conv import DeformConv2d

    for m in model.modules():
        if isinstance(m, DeformConv2d):
            with torch.no_grad():
                for t in (m.offset_conv.weight, m.offset_conv.bias):
                    t.copy_(torch.randn(t.shape, generator=gen) * OFFSET_STD)


class OffsetProbe:
    """Records max |offset| and the share of offsets of 0.05 px or more at
    each deformable conv's call, and its input."""

    def __init__(self, model):
        from doubly_contrastive_semseg_tpu_torch.ops.deform_conv import ModulatedDeformConv

        self.max, self.moving, self.inputs = 0.0, [], []
        self.handles = [m.register_forward_hook(self._hook) for m in model.modules()
                        if isinstance(m, ModulatedDeformConv)]

    def _hook(self, module, args, out):
        x, offset = args[0], args[1]
        self.max = max(self.max, offset.abs().max().item())
        self.moving.append((offset.abs() >= 0.05).float().mean().item())
        self.inputs.append((module, x, args[1], args[2]))

    def remove(self):
        for h in self.handles:
            h.remove()


def disp_gap(a, b):
    d = (a.float() - b.float()).abs()
    return d.mean().item(), d.max().item()


def stereo_phase(torch, dev, card, reset, read):
    """22. Stereo serving of ``StereoDCSS`` at the JAX stereo benchmark's
    configuration (module docstring): (a) 2048×1024 × 2 bf16, NHWC and s2d,
    K2 4 and K1 1 launches a batch on their tensor-core routes, against
    the plain stem and head (labels 0.99 on the decided pixels of
    ``decided_agreement``; mean |Δdisp| ``STEREO_DISP_BAR`` px), frames/s
    and peak memory; (b) f32 ``STEREO_SMALL`` card vs CPU
    (CUDA-core routes; disparity 1e-3 of max, labels 0.999); (c) gather vs
    window at full width with offsets inside ±2 px: the disparity
    (``STEREO_DISP_BAR``), each deformable conv on its own inputs at f32
    (1e-4 of max), both times; (d) ``inference --stereo`` at f32 and bf16 on two
    ``KITTI_HW`` pairs padded to ``KITTI_PAD``: K2 3 a pair, the PNGs read
    back exactly, within 1 LSB of the forward in process on 0.999 of the
    pixels. Returns the launches and times for the kernels line."""
    from doubly_contrastive_semseg_tpu_torch import build_stereo_model, make_stereo_serving_fn
    from doubly_contrastive_semseg_tpu_torch import inference as port_inference
    from doubly_contrastive_semseg_tpu_torch.data.png import read_png, write_png
    from doubly_contrastive_semseg_tpu_torch.models.stereo_extras import SemRefine
    from doubly_contrastive_semseg_tpu_torch.ops import seghead, stem

    t22 = time.perf_counter()
    gen = torch.Generator().manual_seed(22)
    kw = dict(max_disp=STEREO_MAX_DISP, refinement_type="disp_sem", deform_impl="window",
              train_semantic=True, backbone="resnet18")
    out = {}
    head_fn = seghead.fused_seghead_upsample_argmax

    def reset22():
        reset()
        head_fn.tc_launches = head_fn.cc_launches = 0

    log(f"== 22a. stereo serving: StereoDCSS resnet18, max_disp {STEREO_MAX_DISP}, adaptive "
        f"aggregation (window), disp_sem, {WIDTH}x{HEIGHT}, batch {STEREO_BATCH}, bf16")
    torch.backends.cudnn.benchmark = True
    model = build_stereo_model(device="cpu", seed=22, dtype="bfloat16", **kw)
    randomize_bn(model, gen)
    randomize_offsets(torch, model, gen)
    agg = model.aggregation
    check(len(agg.fusions) == 3 and agg.final_conv[0].out_channels == STEREO_MAX_DISP // 4
          and sum(type(f.branches[0][0]).__name__ == "DeformSimpleBottleneck"
                  for f in agg.fusions) == 2 and isinstance(model.refinement, SemRefine)
          and model.segmentation.conv.out_channels == 19,
          "22a: 3 fusions (2 deformable) over 48 disparities, SemRefine, 19 classes")
    model.to(dev)
    serve = make_stereo_serving_fn(model, device=dev)
    left, right = (v.to(dev) for v in stereo_pair(torch, gen, STEREO_BATCH, HEIGHT, WIDTH))
    probe = OffsetProbe(model)
    results = {}
    for layout, (xl, xr) in (("NHWC", (left, right)),
                             ("s2d", (s2d_pack(left), s2d_pack(right)))):
        reset22()
        disp, labels = serve(xl, xr)
        torch.cuda.synchronize()
        got = read()
        got["k1_tc"] = head_fn.tc_launches
        results[layout] = (disp, labels)
        if layout == "NHWC":
            out["launches_a"] = got
        log(f"  {layout} {tuple(xl.shape)}: disparity {tuple(disp.shape)} {disp.dtype} in "
            f"[{disp.min().item():.3f}, {disp.max().item():.3f}], labels {tuple(labels.shape)} "
            f"{labels.dtype}; launches {got}")
        check(got["fused_stem_pool"] == 4 and got["fused_stem_pool_tc"] == 4
              and got["fused_seghead_upsample_argmax"] == 1
              and got["k1_tc"] == 1
              and all(v == 0 for k, v in got.items() if k not in (
                  "fused_stem_pool", "fused_stem_pool_tc", "fused_seghead_upsample_argmax",
                  "k1_tc")),
              f"22a: a stereo serving batch ({layout}) must launch K2 4 times and K1 once, "
              f"on tensor cores, and nothing else")
        check(disp.shape == labels.shape == (STEREO_BATCH, HEIGHT, WIDTH)
              and disp.dtype == torch.float32 and labels.dtype == torch.int8
              and torch.isfinite(disp).all().item() and 0 <= labels.min().item()
              and labels.max().item() < 19, f"22a: outputs ({layout})")
    probe.remove()
    out["offsets"] = {"max_abs": probe.max, "moving_share": probe.moving}
    log(f"  offsets: max |offset| {probe.max:.4f} px (window radius 2), share of offsets "
        f">= 0.05 px per deformable conv {', '.join(f'{m:.4f}' for m in probe.moving)}")
    check(probe.max < 2.0 and min(probe.moving) > 0.1,
          "22a: the offsets must move the samples and stay inside the window")
    disp, labels = results["NHWC"]
    gap_layout = disp_gap(results["s2d"][0], disp)
    same_labels = (results["s2d"][1] == labels).float().mean().item()
    log(f"  s2d vs NHWC: |Δdisp| mean {gap_layout[0]:.3e} max {gap_layout[1]:.3e}, labels "
        f"{same_labels:.6f}")
    check(gap_layout[0] <= 1e-3 and same_labels >= 0.9999, "22a: s2d and NHWC disagree")
    del results

    # the plain path: the plain stem in the trunk and SemRefine, the plain
    # head (K1's plain version, f32 logits) on its left features
    plain = build_stereo_model(device="cpu", seed=22, dtype="bfloat16", fuse_stem=False, **kw)
    plain.load_state_dict(model.state_dict())
    plain.to(dev)
    head = model.segmentation
    reset()
    with torch.no_grad():
        out_p, feat_p = plain.disparity(left, right)
    torch.cuda.synchronize()
    got = read()
    gap = disp_gap(disp, out_p["disp"])
    feat_p = feat_p.permute(0, 2, 3, 1).contiguous()
    with torch.no_grad():
        feat = model.feature_extractor(left)[0].permute(0, 2, 3, 1).contiguous()
    feat_dev = ((feat.float() - feat_p.float()).abs().max() / feat_p.float().abs().max()).item()
    # the path's labels against the plain head on the plain path's features, on
    # all pixels and on those whose f32 top-two gap exceeds twice the logits'
    # bf16 rounding (``decided_agreement``); then K1 alone, on the kernels'
    # features
    path = decided_agreement(torch, feat_p, head, labels)
    k1_same = decided_agreement(torch, feat, head, labels)
    log(f"  {card}: 22a kernels (K2 x4, K1) vs the plain stem and head, same weights: "
        f"|Δdisp| mean {gap[0]:.4f} px (bar {STEREO_DISP_BAR}), max {gap[1]:.4f} px; left "
        f"features max deviation {feat_dev:.3e} of max|feat|; labels: all pixels "
        f"{path[0]:.6f}, decided pixels {path[1]:.6f} ({path[2]:.6f} of them; bar 0.99); K1 "
        f"vs the plain head on the same features: all pixels {k1_same[0]:.6f}, decided "
        f"pixels {k1_same[1]:.6f} ({k1_same[2]:.6f} of them); plain launches {got}")
    check(not any(got.values()), "22a: the plain path launched a kernel")
    check(gap[0] <= STEREO_DISP_BAR and path[2] >= 0.5 and path[1] >= 0.99
          and k1_same[1] >= 0.99, "22a: the kernels' path disagrees with the plain path")
    out["vs_plain"] = {"disp_mean_abs": gap[0], "disp_max_abs": gap[1],
                       "label_agreement": path[0], "decided_agreement": path[1],
                       "decided_share": path[2], "k1_decided_agreement": k1_same[1]}
    del plain, out_p, feat_p
    out["k1_ms"] = cuda_ms(lambda: head_fn(
        feat, head.norm.weight, head.norm.bias, head.norm.running_mean, head.norm.running_var,
        head.conv.weight, head.conv.bias), iters=20)
    sc, sh = model.refinement.bn.folded()
    x_stem = left.to(torch.bfloat16).contiguous()
    out["k2_refinement_ms"] = cuda_ms(lambda: stem.fused_stem_pool(
        x_stem, model.refinement.conv0.weight, sc, sh), iters=20)
    del feat, x_stem
    for _ in range(3):
        serve(left, right)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(20):
            serve(left, right)
        torch.cuda.synchronize()
        windows.append(20 * STEREO_BATCH / (time.perf_counter() - t0))
    got = read()
    check(got["fused_stem_pool"] == 240 and got["fused_seghead_upsample_argmax"] == 60,
          f"22a: 60 batches launch K2 240 and K1 60 times: {got}")
    fps = 3 * 20 * STEREO_BATCH / sum(20 * STEREO_BATCH / f for f in windows)
    out["fps"], out["fps_windows"] = fps, windows
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {card}: 22a stereo serving {fps:.2f} frames/s (windows "
        f"{', '.join(f'{f:.2f}' for f in windows)}), {1e3 * STEREO_BATCH / fps:.2f} ms a batch "
        f"of {STEREO_BATCH}; peak memory {out['peak_gb']:.2f} GB; K1 {out['k1_ms']:.4f} ms, "
        f"the refinement's K2 {out['k2_refinement_ms']:.4f} ms on this batch")

    log("== 22c. the deformable convs' gather form vs the window form, full width, bf16")
    probe = OffsetProbe(model)
    serve(left, right)
    probe.remove()
    times, conv_err = {}, []
    with torch.no_grad():
        for impl in ("window", "gather", "gather", "window"):   # in turns
            for module, x, offset, mask in probe.inputs:
                times.setdefault(impl, []).append(cuda_ms(
                    lambda: module(x, offset, mask, impl), iters=5, warmup=1))
        # each deformable conv's own inputs at f32: both forms compute the
        # same samples inside the radius, up to the order of the sums
        for module, x, offset, mask in probe.inputs:
            xf, mf = x.float(), mask.float()
            win, gat = module(xf, offset, mf, "window"), module(xf, offset, mf, "gather")
            conv_err.append(((win - gat).abs().max() / gat.abs().max()).item())
            del xf, mf, win, gat
    for m in model.modules():
        if hasattr(m, "impl"):
            m.impl = "gather"
    disp_g, _ = serve(left, right)
    for m in model.modules():
        if hasattr(m, "impl"):
            m.impl = "window"
    torch.cuda.synchronize()
    gap_g = disp_gap(disp_g, disp)
    n_conv = len(probe.inputs)
    t_win = [sum(times["window"][i::n_conv]) / 2 for i in range(n_conv)]
    t_gat = [sum(times["gather"][i::n_conv]) / 2 for i in range(n_conv)]
    out["deform"] = {"window_ms": t_win, "gather_ms": t_gat, "disp_mean_abs": gap_g[0],
                     "disp_max_abs": gap_g[1], "max_abs_offset": probe.max,
                     "conv_rel_err_f32": conv_err,
                     "shape": list(probe.inputs[0][1].shape)}
    log(f"  {card}: 22c max |offset| {probe.max:.4f} px; gather vs window |Δdisp| mean "
        f"{gap_g[0]:.4f} px (bar {STEREO_DISP_BAR}), max {gap_g[1]:.4f} px; each conv at f32 "
        f"on its own inputs, max |window - gather| / max |gather| "
        f"{', '.join(f'{e:.3e}' for e in conv_err)} (bar 1e-4); one deformable conv at "
        f"{tuple(probe.inputs[0][1].shape)}: window "
        f"{', '.join(f'{t:.3f}' for t in t_win)} ms, gather "
        f"{', '.join(f'{t:.3f}' for t in t_gat)} ms")
    check(probe.max < 2.0 and gap_g[0] <= STEREO_DISP_BAR and max(conv_err) <= 1e-4,
          "22c: the gather form disagrees with the window form inside the radius")
    del model, serve, probe, disp_g, left, right, disp, labels
    torch.cuda.empty_cache()

    log(f"== 22b. f32 {STEREO_SMALL[1]}x{STEREO_SMALL[0]}, batch 1: the card's CUDA-core "
        f"routes vs the CPU")
    cpu_model = build_stereo_model(device="cpu", seed=23, dtype="float32", **kw)
    randomize_bn(cpu_model, gen)
    randomize_offsets(torch, cpu_model, gen)
    card_model = copy.deepcopy(cpu_model).to(dev)
    xl, xr = (v.float() for v in stereo_pair(torch, gen, 1, *STEREO_SMALL))
    reset22()
    d_gpu, l_gpu = make_stereo_serving_fn(card_model, device=dev)(xl.to(dev), xr.to(dev))
    torch.cuda.synchronize()
    got = read()
    k1_cc = got["k1_cc"] = head_fn.cc_launches
    out["launches_b"] = got
    d_cpu, l_cpu = make_stereo_serving_fn(cpu_model, device="cpu")(xl, xr)
    err = (d_gpu.cpu() - d_cpu).abs().max().item()
    agree32 = (l_gpu.cpu() == l_cpu).float().mean().item()
    out["f32"] = {"disp_max_abs_err": err, "disp_max": d_cpu.abs().max().item(),
                  "label_agreement": agree32}
    log(f"  launches {got}, K1 on CUDA cores {k1_cc}; disparity max abs err {err:.3e} of "
        f"max {d_cpu.abs().max().item():.3f} (bar 1e-3 of max), label agreement "
        f"{agree32:.6f} (bar 0.999)")
    check(got["fused_stem_pool"] == 4 and got["fused_stem_pool_tc"] == 0
          and got["fused_seghead_upsample_argmax"] == 1 and k1_cc == 1,
          "22b: f32 serving must take K2's and K1's CUDA-core routes")
    check(torch.isfinite(d_gpu).all().item() and err <= 1e-3 * d_cpu.abs().max().item()
          and agree32 >= 0.999, "22b: the card disagrees with the CPU")
    del cpu_model, card_model

    log(f"== 22d. inference --stereo: 2 pairs of {KITTI_HW[1]}x{KITTI_HW[0]} padded to "
        f"{KITTI_PAD[1]}x{KITTI_PAD[0]}, default composition (StereoNet refinement), f32 "
        f"and bf16")
    oh, ow = KITTI_HW
    ph, pw = KITTI_PAD
    out["inference"] = {}
    with tempfile.TemporaryDirectory() as base:
        for side in ("left", "right"):
            os.makedirs(os.path.join(base, side))
        pairs = []
        for i in range(2):
            pair = [v[0].numpy() for v in stereo_pair(torch, gen, 1, oh, ow)]
            for side, img in zip(("left", "right"), pair):
                write_png(os.path.join(base, side, f"{i:06d}_10.png"), img)
            pairs.append(pair)
        for dtype in ("float32", "bfloat16"):
            # the CLI's composition: its defaults, as the call below parses them
            cfg = port_inference.build_parser().parse_args(
                ["--stereo", "--input", base, "--compute_dtype", dtype])
            model = build_stereo_model(cfg, device="cpu", seed=24)
            randomize_bn(model, gen)
            randomize_offsets(torch, model, gen)
            with torch.no_grad():   # keep the disparities inside 16 bits
                model.refinement.conv_out.weight.mul_(0.01)
                model.refinement.conv_out.bias.zero_()
            ckpt = os.path.join(base, f"stereo_{dtype}.pt")
            torch.save({"model": model.state_dict()}, ckpt)
            model.to(dev)
            reset()
            res = port_inference.main([
                "--stereo", "--input", os.path.join(base, "left"), "--right_input",
                os.path.join(base, "right"), "--resume", ckpt, "--output_dir",
                os.path.join(base, f"out_{dtype}"), "--val_img_height", str(ph),
                "--val_img_width", str(pw), "--compute_dtype", dtype])
            torch.cuda.synchronize()
            got = read()
            out["inference"][dtype] = {"launches": got}
            tc = 6 if dtype == "bfloat16" else 0
            expect_launches(got, f"22d inference --stereo {dtype}, 2 pairs", k2=6, tc=tc)
            exact, within, clipped = [], [], []
            for path, (lv, rv) in zip(res["paths"], pairs):
                disk = read_png(path)
                pad = ((ph - oh, 0), (0, pw - ow), (0, 0))
                xl, xr = (torch.from_numpy(np.pad(v, pad)).to(dev, torch.float32)[None]
                          for v in (lv, rv))
                with torch.no_grad():
                    d = model.disparity(xl, xr)[0]["disp"][0].cpu().numpy()
                ref = np.clip(d[ph - oh:, :ow] * 256.0, 0, 65535).astype(np.uint16)
                rt = os.path.join(base, "roundtrip.png")
                write_png(rt, ref, "adaptive")
                check(disk.dtype == np.uint16 and disk.shape == (oh, ow)
                      and np.array_equal(read_png(rt), ref), "22d: 16-bit PNG round trip")
                diff = np.abs(disk.astype(np.int32) - ref.astype(np.int32))
                exact.append(float((diff == 0).mean()))
                within.append(float((diff <= 1).mean()))
                clipped.append(float(((ref == 0) | (ref == 65535)).mean()))
            fps = 1.0 / float(np.mean(res["forward_s"][1:]))
            out["inference"][dtype].update(fps=fps, forward_s=res["forward_s"], exact=exact,
                                           within_1=within)
            log(f"  {card}: 22d {dtype}: {fps:.2f} frames/s from the second pair "
                f"(forward s {', '.join(f'{t:.4f}' for t in res['forward_s'])}); PNGs equal "
                f"to the forward in process on {', '.join(f'{e:.6f}' for e in exact)} of the "
                f"pixels, within 1 LSB on {', '.join(f'{e:.6f}' for e in within)} (bar "
                f"0.999); clipped to 0 or 65535: {', '.join(f'{c:.4f}' for c in clipped)}")
            check(min(within) >= 0.999 and max(clipped) < 0.5,
                  f"22d: inference --stereo {dtype} disagrees with the forward")
            del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t22
    log(f"  {card}: phase 22 took {out['seconds']:.1f} s")
    return out


def calm_offsets(torch, model, left, right):
    """Scales each deformable conv's offset conv, in call order, so that its
    offsets average 1 px on the pair (random offset convs over raw-pixel
    features move the samples by tens of pixels, off the image); returns
    the mean |offset| each had before."""
    from doubly_contrastive_semseg_tpu_torch.ops.deform_conv import DeformConv2d

    means = []
    for conv in [m for m in model.modules() if isinstance(m, DeformConv2d)]:
        seen = []
        hook = conv.deform_conv.register_forward_hook(
            lambda mod, args, out: seen.append(args[1].abs().mean().item()))
        with torch.no_grad():
            model.disparity(left, right)
        hook.remove()
        with torch.no_grad():
            conv.offset_conv.weight.div_(seen[0])
            conv.offset_conv.bias.div_(seen[0])
        means.append(seen[0])
    return means


def quiet_refinement(torch, model) -> None:
    """The warp-error refinement's output conv scaled by 0.01, its bias 0: a
    random refinement's Δ spans ±100 px and magnifies each rounding
    upstream ×30 (a trained one corrects a few px)."""
    conv = getattr(model.refinement, "final_conv", None) or model.refinement.final
    with torch.no_grad():
        conv.weight.mul_(0.01)
        conv.bias.zero_()


class FirstInput:
    """Keeps the arguments of ``module``'s first call."""

    def __init__(self, module):
        self.args = None
        self.handle = module.register_forward_hook(self._hook)

    def _hook(self, module, args, out):
        if self.args is None:
            self.args = args
        self.handle.remove()


def stereo_3d_phase(torch, dev, card, reset, read):
    """23. ``StereoDCSS`` with the 3-D aggregations and the warp-error
    refinements (module docstring), max_disp 192, random weights with the
    BN (3-D too) randomised, the offset convs scaled to 1 px
    (``calm_offsets``) and, except in (b), the refinement's output conv
    scaled down (``quiet_refinement``): (a) ``psmnet_hg`` + ``hourglass`` + ``train_semantic``
    at 2048×1024 × 2 bf16, NHWC and s2d, K2 3 and K1 1 launches a batch on
    their tensor-core routes, against the plain stem and head (mean
    |Δdisp| ``STEREO_DISP_BAR``, labels 0.99 on the decided pixels),
    frames/s (3 warm-up batches, 3 windows of 5), peak memory, and the
    times of the first Conv3d (on the concat volume) and of the
    full-resolution deformable ``conv_start``; (b) ``stereonet``,
    ``psmnet_basic`` and ``gcnet`` with ``stereodrnet``, disparity only, at
    ``KITTI_GCNET`` × 1 bf16: ms a batch, peak memory, K2 3 a batch; (c)
    f32 ``STEREO_SMALL`` card vs CPU for ``STEREO_3D_PAIRS`` (each
    aggregation, each refinement twice): disparity 1e-3 of max; (d)
    ``inference --stereo --aggregation_type psmnet_hg --refinement_type
    hourglass`` at f32 and bf16 on two ``KITTI_HW`` pairs padded to
    ``KITTI_PAD``: K2 3 a pair, the PNGs read back exactly and within 1 LSB
    of the forward in process on 0.999 of the pixels. Returns the launches
    and times for the kernels line."""
    from doubly_contrastive_semseg_tpu_torch import build_stereo_model, make_stereo_serving_fn
    from doubly_contrastive_semseg_tpu_torch import inference as port_inference
    from doubly_contrastive_semseg_tpu_torch.data.png import read_png, write_png
    from doubly_contrastive_semseg_tpu_torch.models.stereo_extras import (
        HourglassRefinement, PSMNetHGAggregation)
    from doubly_contrastive_semseg_tpu_torch.ops import seghead
    from doubly_contrastive_semseg_tpu_torch.ops.cost_volume import (
        cost_volume, soft_argmin_disparity)
    from doubly_contrastive_semseg_tpu_torch.ops.input_pipeline import to_nhwc

    t23 = time.perf_counter()
    gen = torch.Generator().manual_seed(23)
    head_fn = seghead.fused_seghead_upsample_argmax
    out = {}

    def reset23():
        reset()
        head_fn.tc_launches = head_fn.cc_launches = 0

    def small_pair():
        return (v.to(dev, torch.float32) for v in stereo_pair(torch, gen, 1, *STEREO_SMALL))

    kw = dict(max_disp=STEREO_MAX_DISP, aggregation_type="psmnet_hg", refinement_type="hourglass",
              train_semantic=True, backbone="resnet18")
    log(f"== 23a. stereo serving: StereoDCSS resnet18, max_disp {STEREO_MAX_DISP}, psmnet_hg, "
        f"hourglass refinement, {WIDTH}x{HEIGHT}, batch {STEREO_BATCH}, bf16")
    torch.backends.cudnn.benchmark = True
    model = build_stereo_model(device="cpu", seed=23, dtype="bfloat16", **kw)
    randomize_bn(model, gen)
    randomize_offsets(torch, model, gen)
    agg, ref = model.aggregation, model.refinement
    first_conv = agg.dres0[0][0]
    check(isinstance(agg, PSMNetHGAggregation) and first_conv.in_channels == 256
          and first_conv.out_channels == 32 and isinstance(ref, HourglassRefinement)
          and model.segmentation.conv.out_channels == 19,
          "23a: psmnet_hg on the 256-channel concat volume, 32 channels, hourglass, 19 classes")
    model.to(dev)
    out["offset_means_before"] = calm_offsets(torch, model, *small_pair())
    quiet_refinement(torch, model)
    serve = make_stereo_serving_fn(model, device=dev)
    left, right = (v.to(dev) for v in stereo_pair(torch, gen, STEREO_BATCH, HEIGHT, WIDTH))
    conv_in, start_in = FirstInput(first_conv), FirstInput(ref.conv_start)
    results = {}
    for layout, (xl, xr) in (("NHWC", (left, right)),
                             ("s2d", (s2d_pack(left), s2d_pack(right)))):
        reset23()
        disp, labels = serve(xl, xr)
        torch.cuda.synchronize()
        got = read()
        got["k1_tc"] = head_fn.tc_launches
        results[layout] = (disp, labels)
        if layout == "NHWC":
            out["launches_a"] = got
        log(f"  {layout} {tuple(xl.shape)}: disparity {tuple(disp.shape)} {disp.dtype} in "
            f"[{disp.min().item():.3f}, {disp.max().item():.3f}], labels {tuple(labels.shape)} "
            f"{labels.dtype}; launches {got}")
        check(got["fused_stem_pool"] == 3 and got["fused_stem_pool_tc"] == 3
              and got["fused_seghead_upsample_argmax"] == 1 and got["k1_tc"] == 1
              and all(v == 0 for k, v in got.items() if k not in (
                  "fused_stem_pool", "fused_stem_pool_tc", "fused_seghead_upsample_argmax",
                  "k1_tc")),
              f"23a: a stereo serving batch ({layout}) must launch K2 3 times and K1 once, "
              f"on tensor cores, and nothing else")
        check(disp.shape == labels.shape == (STEREO_BATCH, HEIGHT, WIDTH)
              and disp.dtype == torch.float32 and labels.dtype == torch.int8
              and torch.isfinite(disp).all().item() and 0 <= labels.min().item()
              and labels.max().item() < 19, f"23a: outputs ({layout})")
    disp, labels = results["NHWC"]
    gap_layout = disp_gap(results["s2d"][0], disp)
    same_labels = (results["s2d"][1] == labels).float().mean().item()
    log(f"  s2d vs NHWC: |Δdisp| mean {gap_layout[0]:.3e} max {gap_layout[1]:.3e}, labels "
        f"{same_labels:.6f}; mean |offset| before scaling to 1 px: "
        f"{', '.join(f'{m:.2f}' for m in out['offset_means_before'])} px")
    check(gap_layout[0] <= 1e-3 and same_labels >= 0.9999, "23a: s2d and NHWC disagree")
    del results

    plain = build_stereo_model(device="cpu", seed=23, dtype="bfloat16", fuse_stem=False, **kw)
    plain.load_state_dict(model.state_dict())
    plain.to(dev)
    reset()
    with torch.no_grad():
        out_p, feat_p = plain.disparity(left, right)
    torch.cuda.synchronize()
    got = read()
    gap = disp_gap(disp, out_p["disp"])
    with torch.no_grad():
        gap_low = disp_gap(model.disparity(left, right)[0]["disp_pyramid"][0],
                           out_p["disp_pyramid"][0])
    feat_p = feat_p.permute(0, 2, 3, 1).contiguous()
    path = decided_agreement(torch, feat_p, model.segmentation, labels)
    log(f"  {card}: 23a kernels (K2 x3, K1) vs the plain stem and head, same weights: "
        f"|Δdisp| mean {gap[0]:.4f} px (bar {STEREO_DISP_BAR}), max {gap[1]:.4f} px (the "
        f"aggregation's soft-argmin: mean {gap_low[0]:.4f}, max {gap_low[1]:.4f} px); labels: "
        f"all pixels {path[0]:.6f}, decided pixels {path[1]:.6f} ({path[2]:.6f} of them; bar "
        f"0.99); plain launches {got}")
    check(not any(got.values()), "23a: the plain path launched a kernel")
    check(gap[0] <= STEREO_DISP_BAR and path[2] >= 0.5 and path[1] >= 0.99,
          "23a: the kernels' path disagrees with the plain path")
    out["vs_plain"] = {"disp_mean_abs": gap[0], "disp_max_abs": gap[1],
                       "aggregation_disp_mean_abs": gap_low[0], "label_agreement": path[0],
                       "decided_agreement": path[1], "decided_share": path[2]}
    del plain, out_p, feat_p

    vol, = conv_in.args
    x_start, = start_in.args
    flops = 2 * vol.shape[0] * first_conv.out_channels * vol.shape[1] * 27 * vol[0, 0].numel()
    with torch.no_grad():
        out["conv3d_ms"] = cuda_ms(lambda: first_conv(vol), iters=5, warmup=1)
        out["conv_start_ms"] = cuda_ms(lambda: ref.conv_start(x_start), iters=3, warmup=1)
    out["conv3d_tflops"] = flops / out["conv3d_ms"] / 1e9
    log(f"  {card}: the first Conv3d on the concat volume {tuple(vol.shape)} {vol.dtype} "
        f"(channels_last_3d: {vol.is_contiguous(memory_format=torch.channels_last_3d)}) "
        f"{out['conv3d_ms']:.3f} ms, {flops / 1e12:.3f} TFLOP, {out['conv3d_tflops']:.1f} "
        f"TFLOP/s (bound at 989: {flops / 989e9:.3f} ms); deformable conv_start on "
        f"{tuple(x_start.shape)} {x_start.dtype} (gather form) {out['conv_start_ms']:.3f} ms")
    del vol, x_start, conv_in, start_in
    # the batch by stage, each timed alone on the previous stage's output
    with torch.no_grad():
        both = torch.cat([left, right])
        lf, rf = model.feature_extractor(both)[0].chunk(2)
        vol = cost_volume(lf, rf, STEREO_MAX_DISP // 4, "concat")
        costs = agg(vol)[-1]
        low = soft_argmin_disparity(costs, match_similarity=False)
        ln, rn = to_nhwc(left), to_nhwc(right)
        stages = {"trunk (both views)": lambda: model.feature_extractor(both),
                  "concat volume": lambda: cost_volume(lf, rf, STEREO_MAX_DISP // 4, "concat"),
                  "psmnet_hg (3-D convs, x4 upsampling)": lambda: agg(vol),
                  "soft-argmin": lambda: soft_argmin_disparity(costs, match_similarity=False),
                  "hourglass refinement": lambda: ref(low, ln, rn)}
        out["stage_ms"] = {k: cuda_ms(fn, iters=3, warmup=1) for k, fn in stages.items()}
    del both, lf, rf, vol, costs, low, stages
    log(f"  {card}: 23a stages alone, ms: "
        f"{', '.join(f'{k} {v:.2f}' for k, v in out['stage_ms'].items())}")
    for _ in range(3):
        serve(left, right)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(5):
            serve(left, right)
        torch.cuda.synchronize()
        windows.append(5 * STEREO_BATCH / (time.perf_counter() - t0))
    got = read()
    check(got["fused_stem_pool"] == 45 and got["fused_seghead_upsample_argmax"] == 15,
          f"23a: 15 batches launch K2 45 and K1 15 times: {got}")
    fps = 3 * 5 * STEREO_BATCH / sum(5 * STEREO_BATCH / f for f in windows)
    out["fps"], out["fps_windows"] = fps, windows
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {card}: 23a stereo serving {fps:.2f} frames/s (windows "
        f"{', '.join(f'{f:.2f}' for f in windows)}), {1e3 * STEREO_BATCH / fps:.2f} ms a batch "
        f"of {STEREO_BATCH}; peak memory {out['peak_gb']:.2f} GB")
    del model, serve, left, right, disp, labels
    torch.cuda.empty_cache()

    log(f"== 23b. the other 3-D aggregations with stereodrnet, disparity only, "
        f"{KITTI_GCNET[1]}x{KITTI_GCNET[0]}, batch 1, bf16")
    out["kitti"] = {}
    xl, xr = (v.to(dev) for v in stereo_pair(torch, gen, 1, *KITTI_GCNET))
    for kind in ("stereonet", "psmnet_basic", "gcnet"):
        model = build_stereo_model(device="cpu", seed=24, dtype="bfloat16",
                                   max_disp=STEREO_MAX_DISP, aggregation_type=kind,
                                   refinement_type="stereodrnet", train_semantic=False)
        randomize_bn(model, gen)
        model.to(dev)
        serve = make_stereo_serving_fn(model, device=dev)
        for _ in range(2):
            serve(xl, xr)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        for _ in range(5):
            disp, labels = serve(xl, xr)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        got = read()
        peak = torch.cuda.max_memory_allocated() / 1e9
        out["kitti"][kind] = {"ms": ms, "peak_gb": peak, "launches": got}
        log(f"  {card}: 23b {kind}: {ms:.2f} ms a pair, peak memory {peak:.2f} GB, disparity "
            f"in [{disp.min().item():.3f}, {disp.max().item():.3f}]")
        expect_launches(got, f"23b {kind}, 5 pairs", k2=15)
        check(labels is None and disp.shape == (1, *KITTI_GCNET)
              and torch.isfinite(disp).all().item(), f"23b: {kind} outputs")
        del model, serve, disp
    torch.cuda.empty_cache()

    log(f"== 23c. f32 {STEREO_SMALL[1]}x{STEREO_SMALL[0]}, batch 1: the card vs the CPU, each "
        f"3-D aggregation and warp-error refinement")
    out["f32"] = {}
    for kind, refinement in STEREO_3D_PAIRS:
        card_model = build_stereo_model(device="cpu", seed=25, dtype="float32",
                                        max_disp=STEREO_MAX_DISP, aggregation_type=kind,
                                        refinement_type=refinement, train_semantic=False)
        randomize_bn(card_model, gen)
        randomize_offsets(torch, card_model, gen)
        card_model.to(dev)
        xl, xr = small_pair()
        if refinement == "hourglass":
            calm_offsets(torch, card_model, xl, xr)
        quiet_refinement(torch, card_model)
        cpu_model = copy.deepcopy(card_model).cpu()
        reset()
        d_gpu, _ = make_stereo_serving_fn(card_model, device=dev)(xl, xr)
        torch.cuda.synchronize()
        got = read()
        d_cpu, _ = make_stereo_serving_fn(cpu_model, device="cpu")(xl.cpu(), xr.cpu())
        err = (d_gpu.cpu() - d_cpu).abs().max().item()
        top = d_cpu.abs().max().item()
        out["f32"][f"{kind} + {refinement}"] = {"disp_max_abs_err": err, "disp_max": top,
                                                "launches": got}
        log(f"  {kind} + {refinement}: disparity max abs err {err:.3e} of max {top:.3f} "
            f"({err / top:.3e}; bar 1e-3)")
        expect_launches(got, f"23c {kind} + {refinement} f32", k2=3, tc=0)
        check(torch.isfinite(d_gpu).all().item() and err <= 1e-3 * top,
              f"23c: {kind} + {refinement} on the card disagrees with the CPU")
        del card_model, cpu_model
    torch.cuda.empty_cache()

    log(f"== 23d. inference --stereo --aggregation_type psmnet_hg --refinement_type hourglass: "
        f"2 pairs of {KITTI_HW[1]}x{KITTI_HW[0]} padded to {KITTI_PAD[1]}x{KITTI_PAD[0]}, f32 "
        f"and bf16")
    oh, ow = KITTI_HW
    ph, pw = KITTI_PAD
    composition = ["--aggregation_type", "psmnet_hg", "--refinement_type", "hourglass"]
    out["inference"] = {}
    with tempfile.TemporaryDirectory() as base:
        for side in ("left", "right"):
            os.makedirs(os.path.join(base, side))
        pairs = []
        for i in range(2):
            pair = [v[0].numpy() for v in stereo_pair(torch, gen, 1, oh, ow)]
            for side, img in zip(("left", "right"), pair):
                write_png(os.path.join(base, side, f"{i:06d}_10.png"), img)
            pairs.append(pair)
        for dtype in ("float32", "bfloat16"):
            cfg = port_inference.build_parser().parse_args(
                ["--stereo", "--input", base, "--compute_dtype", dtype] + composition)
            model = build_stereo_model(cfg, device="cpu", seed=26)
            randomize_bn(model, gen)
            randomize_offsets(torch, model, gen)
            model.to(dev)
            calm_offsets(torch, model, *small_pair())
            quiet_refinement(torch, model)   # also keeps the disparities inside 16 bits
            ckpt = os.path.join(base, f"stereo_{dtype}.pt")
            torch.save({"model": model.state_dict()}, ckpt)
            reset()
            res = port_inference.main([
                "--stereo", "--input", os.path.join(base, "left"), "--right_input",
                os.path.join(base, "right"), "--resume", ckpt, "--output_dir",
                os.path.join(base, f"out_{dtype}"), "--val_img_height", str(ph),
                "--val_img_width", str(pw), "--compute_dtype", dtype] + composition)
            torch.cuda.synchronize()
            got = read()
            out["inference"][dtype] = {"launches": got}
            tc = 6 if dtype == "bfloat16" else 0
            expect_launches(got, f"23d inference --stereo {dtype}, 2 pairs", k2=6, tc=tc)
            exact, within, clipped = [], [], []
            for path, (lv, rv) in zip(res["paths"], pairs):
                disk = read_png(path)
                pad = ((ph - oh, 0), (0, pw - ow), (0, 0))
                xl, xr = (torch.from_numpy(np.pad(v, pad)).to(dev, torch.float32)[None]
                          for v in (lv, rv))
                with torch.no_grad():
                    d = model.disparity(xl, xr)[0]["disp"][0].cpu().numpy()
                ref = np.clip(d[ph - oh:, :ow] * 256.0, 0, 65535).astype(np.uint16)
                rt = os.path.join(base, "roundtrip.png")
                write_png(rt, ref, "adaptive")
                check(disk.dtype == np.uint16 and disk.shape == (oh, ow)
                      and np.array_equal(read_png(rt), ref), "23d: 16-bit PNG round trip")
                diff = np.abs(disk.astype(np.int32) - ref.astype(np.int32))
                exact.append(float((diff == 0).mean()))
                within.append(float((diff <= 1).mean()))
                clipped.append(float(((ref == 0) | (ref == 65535)).mean()))
            fps = 1.0 / float(np.mean(res["forward_s"][1:]))
            out["inference"][dtype].update(fps=fps, forward_s=res["forward_s"], exact=exact,
                                           within_1=within)
            log(f"  {card}: 23d {dtype}: {fps:.2f} frames/s from the second pair "
                f"(forward s {', '.join(f'{t:.4f}' for t in res['forward_s'])}); PNGs equal "
                f"to the forward in process on {', '.join(f'{e:.6f}' for e in exact)} of the "
                f"pixels, within 1 LSB on {', '.join(f'{e:.6f}' for e in within)} (bar "
                f"0.999); clipped to 0 or 65535: {', '.join(f'{c:.4f}' for c in clipped)}")
            check(min(within) >= 0.999 and max(clipped) < 0.5,
                  f"23d: inference --stereo {dtype} disagrees with the forward")
            del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t23
    log(f"  {card}: phase 23 took {out['seconds']:.1f} s")
    return out


SCENEFLOW_HW, SF_TRAIN, SF_VAL = (540, 960), 24, 8   # 24a: 3 steps an epoch, 1 val batch
KITTI_TRAIN, KITTI_VAL = 16, 8                        # 24b: 2 steps, 1 val batch
STEREO_TRAIN_BATCH = 8                                # main's default --batch_size
STEREO_STEP = (2, 256, 512)                           # 24c: batch, h, w (GCNet: multiples of 64)
STEREO_CPU_STEP = (2, 128, 256)                       # 24d: f32 card vs CPU
STEREO_24C = (("stereonet", "stereodrnet"), ("psmnet_basic", "hourglass"),
              ("psmnet_hg", "stereonet"), ("gcnet", "stereodrnet"))


def write_pfm(path, img, little_endian: bool) -> None:
    """A grey PFM file (``Pf``) of ``img`` (H, W), rows bottom to top; the
    scale's sign gives the byte order."""
    with open(path, "wb") as f:
        f.write(f"Pf\n{img.shape[1]} {img.shape[0]}\n{-1.0 if little_endian else 1.0}\n"
                .encode("ascii"))
        f.write(np.flipud(img).astype("<f4" if little_endian else ">f4").tobytes())


def rendered_pair(torch, gen, hw, d_low, d_high):
    """(left, right) uint8 (H, W, 3) and the left view's disparity (H, W)
    float32: a smooth texture with fine grain, a disparity that grows down
    the rows (a ground plane, d_low to d_high), and the right view rendered
    from the left by it, right[y, x] = left[y, x + d(y)] (bilinear, zeros
    past the frame)."""
    import torch.nn.functional as F

    h, w = hw
    coarse = torch.rand(1, 3, h // 8 + 2, w // 8 + 2, generator=gen) * 255
    left = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    left = (left + torch.randn(1, 3, h, w, generator=gen) * 24).clamp(0, 255).round()
    top = d_low + torch.rand((), generator=gen).item() * (d_high - d_low) / 2
    rows = top + torch.linspace(0, 1, h) * (d_high - top) * torch.rand((), generator=gen).item()
    disp = rows[:, None].expand(h, w).contiguous()
    xs = torch.arange(w, dtype=torch.float32)[None, :] + disp
    grid = torch.stack([xs / (w - 1) * 2 - 1,
                        torch.linspace(-1, 1, h)[:, None].expand(h, w)], dim=-1)[None]
    right = F.grid_sample(left, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    as_u8 = lambda x: x[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()  # noqa: E731
    return as_u8(left), as_u8(right), disp.numpy().astype(np.float32)


def write_stereo_trees(torch, base, gen):
    """``<base>/sceneflow``: ``SF_TRAIN`` + ``SF_VAL`` PNG pairs of
    ``SCENEFLOW_HW`` with PFM disparities (little- and big-endian in turns);
    ``<base>/kitti_2015``: ``KITTI_TRAIN`` + ``KITTI_VAL`` pairs of
    ``KITTI_HW`` with 16-bit disparity PNGs (v = 256 d, about 30 % of the
    pixels valid, 0 elsewhere) and Cityscapes-id label PNGs; the lists
    under ``<base>/filenames``. Returns the seconds it took."""
    from doubly_contrastive_semseg_tpu_torch.data.png import write_png

    t0 = time.perf_counter()
    lists = {}

    def put(root, rel, img):
        os.makedirs(os.path.join(base, root, os.path.dirname(rel)), exist_ok=True)
        write_png(os.path.join(base, root, rel), img)

    for split, n in (("train", SF_TRAIN), ("val", SF_VAL)):
        for i in range(n):
            left, right, disp = rendered_pair(torch, gen, SCENEFLOW_HW, 4.0, 150.0)
            stem = f"frames_finalpass/{split.upper()}/A/{i:04d}"
            rel_d = f"disparity/{split.upper()}/A/{i:04d}/left/0006.pfm"
            put("sceneflow", f"{stem}/left/0006.png", left)
            put("sceneflow", f"{stem}/right/0006.png", right)
            os.makedirs(os.path.join(base, "sceneflow", os.path.dirname(rel_d)), exist_ok=True)
            write_pfm(os.path.join(base, "sceneflow", rel_d), disp, little_endian=i % 2 == 0)
            lists.setdefault(("sceneflow", f"SceneFlow_finalpass_{split}"), []).append(
                f"{stem}/left/0006.png {stem}/right/0006.png {rel_d}")
    for split, n in (("train", KITTI_TRAIN), ("val", KITTI_VAL)):
        for i in range(n):
            left, right, disp = rendered_pair(torch, gen, KITTI_HW, 2.0, 100.0)
            raw = np.round(disp * 256).astype(np.uint16)
            raw[torch.rand(KITTI_HW, generator=gen).numpy() > 0.3] = 0
            ids = torch.randint(0, 34, (KITTI_HW[0] // 25 + 1, KITTI_HW[1] // 25 + 1),
                                generator=gen).numpy().astype(np.uint8)
            ids = np.repeat(np.repeat(ids, 25, 0), 25, 1)[:KITTI_HW[0], :KITTI_HW[1]]
            name = f"{split}_{i:06d}_10.png"
            for sub, img in (("image_2", left), ("image_3", right), ("disp_occ_0", raw),
                             ("semantic", np.ascontiguousarray(ids))):
                put("kitti_2015", f"training/{sub}/{name}", img)
            lists.setdefault(("kitti_2015", f"KITTI_2015_{split}"), []).append(
                " ".join(f"training/{sub}/{name}"
                         for sub in ("image_2", "image_3", "disp_occ_0", "semantic")))
    for (sub, name), lines in lists.items():
        os.makedirs(os.path.join(base, "filenames", sub), exist_ok=True)
        with open(os.path.join(base, "filenames", sub, f"{name}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return time.perf_counter() - t0


@contextlib.contextmanager
def stereo_calls(torch, read):
    """Wraps ``StereoTrainer.train`` and ``.validate``: for each call, the
    kernels it launched, its wall seconds (synchronised), the trainer's
    epoch, ``best_epe`` and ``num_iter`` at its start, and its result."""
    from doubly_contrastive_semseg_tpu_torch.train.trainer_stereo import StereoTrainer

    real = {"train": StereoTrainer.train, "validate": StereoTrainer.validate}
    calls = []

    def wrap(name):
        def run(self, *args, **kwargs):
            torch.cuda.synchronize()
            before = read()
            start = {"what": name, "epoch": self.cur_epochs, "best_epe": self.best_epe,
                     "num_iter": self.num_iter}
            t0 = time.perf_counter()
            res = real[name](self, *args, **kwargs)
            torch.cuda.synchronize()
            after = read()
            calls.append({**start, "s": time.perf_counter() - t0, "result": res,
                          "launches": {k: after[k] - before[k] for k in after}})
            return res
        return run

    StereoTrainer.train, StereoTrainer.validate = wrap("train"), wrap("validate")
    try:
        yield calls
    finally:
        StereoTrainer.train, StereoTrainer.validate = real["train"], real["validate"]


def stereo_step_log(calls, tr, what):
    """Checks the K2 launches of each train (0) and validate (3 a val
    batch on tensor cores) call; returns the step, wait and val figures."""
    for c in calls:
        k2 = 0 if c["what"] == "train" else 3 * len(tr.val_loader)
        expect_launches(c["launches"], f"{what} {c['what']} (epoch {c['epoch']})", k2=k2)
    steps = tr.step_times[1:]          # the first step tunes cuDNN
    return {"ms_step": 1e3 * float(np.mean([s for _, _, s in steps])) if steps else None,
            "ms_wait": 1e3 * float(np.mean([w for _, w, _ in steps])) if steps else None,
            "steps": len(tr.step_times), "val_batches": len(tr.val_loader),
            "val": [c["result"] for c in calls if c["what"] == "validate"],
            "val_s": [c["s"] for c in calls if c["what"] == "validate"],
            "k2": {what: [c["launches"]["fused_stem_pool"] for c in calls if c["what"] == what]
                   for what in ("train", "validate")}}


def stereo_train_phase(torch, dev, card, reset, read):
    """24. Stereo training through ``main`` and ``make_stereo_train_step``
    (module docstring): (a) ``--dataset sceneflow`` at the defaults on a
    rendered tree, 2 epochs, a ``--continue_training`` resume and
    ``--test_only``; (b) ``kitti_2015 --train_semantic`` from (a)'s best
    checkpoint; (c) 3 steps of each 3-D aggregation; (d) f32 card vs CPU,
    whole step and block by block; (e) ``inference --stereo --resume`` on
    (b)'s checkpoint. K2 launches 3 times a val batch and an inference
    pair, on tensor cores at bf16, and never in a train step. Returns the
    launches and figures for the kernels line."""
    from doubly_contrastive_semseg_tpu_torch import build_stereo_model
    from doubly_contrastive_semseg_tpu_torch import inference as port_inference
    from doubly_contrastive_semseg_tpu_torch.config import parse_args
    from doubly_contrastive_semseg_tpu_torch.data.png import read_png, write_png
    from doubly_contrastive_semseg_tpu_torch.main import main as port_main
    from doubly_contrastive_semseg_tpu_torch.models.stereo import (
        DeformSimpleBottleneck, SemanticGuidedRefinement, StereoNetRefinement)
    from doubly_contrastive_semseg_tpu_torch.ops.input_pipeline import pyramid_hw
    from doubly_contrastive_semseg_tpu_torch.tools import profile_stem
    from doubly_contrastive_semseg_tpu_torch.train import (
        TrainState, build_stereo_optimizer, make_stereo_train_step, stereo_loss)

    t24 = time.perf_counter()
    gen = torch.Generator().manual_seed(24)
    gen_k2 = torch.Generator().manual_seed(2424)
    out = {}

    def k2_at(what, batches):
        """K2 on each route against ``stem_pool_reference`` at the pyramid
        levels of the (pairs, h, w) batches ``what`` gave it: the trunk runs
        over both views, 2 x pairs frames."""
        shapes = [(2 * n,) + pyramid_hw(h, w, lv) for n, h, w in batches for lv in range(3)]
        log(f"  K2 at {what}'s levels vs stem_pool_reference:")
        profile_stem.check_routes(gen_k2, dev, log, shapes=shapes)
        return shapes

    def val_batches(tr):
        """The (pairs, h, w) of each distinct batch of ``tr``'s val loader."""
        n, bs = len(tr.val_dst), tr.val_loader.batch_size
        h, w = tr.val_dst[0]["left"].shape[:2]
        return sorted({(min(bs, n - i), h, w) for i in range(0, n, bs)})
    with tempfile.TemporaryDirectory() as base:
        tree_s = write_stereo_trees(torch, base, gen)
        log(f"== 24. stereo training. Trees written in {tree_s:.1f} s: SceneFlow {SF_TRAIN} + "
            f"{SF_VAL} pairs of {SCENEFLOW_HW[1]}x{SCENEFLOW_HW[0]} (PFM disparity, both byte "
            f"orders), KITTI {KITTI_TRAIN} + {KITTI_VAL} pairs of {KITTI_HW[1]}x{KITTI_HW[0]} "
            "(16-bit disparity PNGs, 30 % valid; Cityscapes-id labels); right views rendered "
            "from the left by the disparity")
        common = ["--data_root", base, "--filelist_root", os.path.join(base, "filenames"),
                  "--criterion", "none", "--print_freq", "1", "--no_build_summary",
                  "--batch_size", str(STEREO_TRAIN_BATCH), "--device", dev.type]

        # a. sceneflow at main's defaults
        argv_a = ["--dataset", "sceneflow", "--epochs", "2", "--run_root",
                  os.path.join(base, "a")] + common
        cfg = parse_args(argv_a)
        check(cfg.compute_dtype == "bfloat16" and cfg.batch_size == STEREO_TRAIN_BATCH
              and cfg.aggregation_type == "adaptive" and cfg.deform_impl == "window"
              and cfg.refinement_type == "semantic" and not cfg.train_semantic
              and cfg.model == "resnet18", "24a must run main's stereo defaults")
        log(f"== 24a. main --dataset sceneflow --criterion none: StereoDCSS resnet18, max_disp "
            f"192, adaptive (window deformable convs), StereoNet refinement, bf16; 288x576 "
            f"crops at batch {STEREO_TRAIN_BATCH}, validation 576x960 (36 rows padded on top) "
            f"at batch {cfg.val_batch_size}, 2 epochs, 4 loader threads")
        torch.cuda.reset_peak_memory_stats()
        reset()
        with stereo_calls(torch, read) as calls:
            tr = port_main(argv_a)
        peak = torch.cuda.max_memory_allocated() / 1e9
        a = stereo_step_log(calls, tr, "24a")
        check(isinstance(tr.model.refinement, StereoNetRefinement) and tr.model.max_disp == 192
              and len(tr.train_loader) == SF_TRAIN // STEREO_TRAIN_BATCH
              and tr.state.step == 2 * len(tr.train_loader), "24a: model and steps")
        losses = [m for _, m in tr.epoch_losses]
        check(all(np.isfinite(v) for m in losses for v in m.values()), f"24a losses {losses}")
        ckpts = sorted(os.listdir(tr.saver.checkpoint_dir))
        check("score_best_checkpoint" in ckpts and "latest_checkpoint" in ckpts,
              f"24a: checkpoints {ckpts}")
        out["a"] = {**a, "peak_gb": peak, "losses": losses}
        log(f"  {card}: 24a {a['steps']} steps: {a['ms_step']:.1f} ms a step from the second "
            f"(loader wait {a['ms_wait']:.1f} ms a step), losses by epoch {losses}; val "
            f"{a['val']} in {', '.join(f'{v:.2f}' for v in a['val_s'])} s; peak memory "
            f"{peak:.2f} GB")
        best = os.path.join(tr.saver.checkpoint_dir, "score_best_checkpoint")
        latest = os.path.join(tr.saver.checkpoint_dir, "latest_checkpoint")
        with open(latest + ".meta.json") as f:
            meta = json.load(f)

        reset()
        with stereo_calls(torch, read) as calls:
            again = port_main(argv_a[:2] + ["--epochs", "3", "--run_root",
                                            os.path.join(base, "a2"), "--resume", latest,
                                            "--continue_training"] + common)
        first = calls[0]
        out["a_resumed"] = stereo_step_log(calls, again, "24a resumed")
        log(f"  24a --continue_training: first call {first['what']} at epoch {first['epoch']}, "
            f"best_epe {first['best_epe']} (saved {meta['best_score']}), num_iter "
            f"{first['num_iter']} (saved {meta['num_iter']})")
        check(first["what"] == "train" and first["epoch"] == 2
              and first["best_epe"] == meta["best_score"] and first["num_iter"] ==
              meta["num_iter"] + 1 and len(calls) == 2, "24a: the resume's epoch and best_epe")

        reset()
        with stereo_calls(torch, read) as calls:
            test = port_main(argv_a[:2] + ["--run_root", os.path.join(base, "a3"), "--resume",
                                           best, "--test_only"] + common)
        out["a_test_only"] = stereo_step_log(calls, test, "24a --test_only")
        check([c["what"] for c in calls] == ["validate"]
              and os.listdir(test.saver.checkpoint_dir) == [],
              "24a --test_only: one validation and no checkpoint")
        log(f"  24a --test_only: val {calls[0]['result']} (batch {test.cfg.val_batch_size}, "
            f"{len(test.val_loader)} batches, K2 {calls[0]['launches']['fused_stem_pool']})")
        out["a_k2_shapes"] = k2_at("24a's validation and --test_only",
                                   val_batches(tr) + val_batches(test))
        del tr, again, test
        torch.cuda.empty_cache()

        # b. the README's chain: KITTI with the seg head, from (a)'s weights
        argv_b = ["--dataset", "kitti_2015", "--train_semantic", "--epochs", "1", "--run_root",
                  os.path.join(base, "b"), "--resume", best] + common
        log(f"== 24b. main --dataset kitti_2015 --train_semantic --resume <24a best>: semantic "
            f"refinement and seg head, 288x1152 crops at batch {STEREO_TRAIN_BATCH}, "
            "validation 384x1248, 1 epoch")
        torch.cuda.reset_peak_memory_stats()
        reset()
        with stereo_calls(torch, read) as calls:
            trb = port_main(argv_b)
        peak = torch.cuda.max_memory_allocated() / 1e9
        b = stereo_step_log(calls, trb, "24b")
        losses = [m for _, m in trb.epoch_losses]
        check(isinstance(trb.model.refinement, SemanticGuidedRefinement)
              and all(set(m) == {"disp_loss", "seg_loss", "total_loss"}
                      and all(np.isfinite(v) for v in m.values()) for m in losses),
              f"24b: the semantic refinement and finite disp and seg losses {losses}")
        out["b"] = {**b, "peak_gb": peak, "losses": losses}
        log(f"  {card}: 24b {b['steps']} steps: {b['ms_step']:.1f} ms a step from the second "
            f"(loader wait {b['ms_wait']:.1f} ms), losses {losses}; val {b['val']}; peak "
            f"memory {peak:.2f} GB")
        ckpt_b = os.path.join(trb.saver.checkpoint_dir, "score_best_checkpoint")
        out["b_k2_shapes"] = k2_at("24b's validation", val_batches(trb))
        del trb
        torch.cuda.empty_cache()

        # c. a train step of each 3-D aggregation, without cuDNN's autotuning:
        # on an H100 80GB HBM3 (700 W) it took 1.6-19.8 s of each first step
        torch.backends.cudnn.benchmark = False
        bsz, h, w = STEREO_STEP
        log(f"== 24c. make_stereo_train_step, 3 steps each, {w}x{h} x {bsz}, bf16, max_disp 192")
        pairs = [rendered_pair(torch, gen, (h, w), 4.0, 120.0) for _ in range(bsz)]
        batch = {k: torch.from_numpy(np.stack([p[i] for p in pairs])).to(dev)
                 for i, k in enumerate(("left", "right", "disp"))}
        cfg_c = parse_args(["--dataset", "kitti_2015", "--criterion", "none"])
        out["c"] = {}
        for agg, ref in STEREO_24C:
            model = build_stereo_model(device=dev, seed=24, max_disp=192, aggregation_type=agg,
                                       refinement_type=ref, train_semantic=False,
                                       dtype="bfloat16")
            optimizer = build_stereo_optimizer(model, cfg_c, 1)
            step = make_stereo_train_step(model, cfg_c, optimizer)
            state = TrainState(model, optimizer)
            torch.cuda.reset_peak_memory_stats()
            reset()
            comps, times = [], []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step(state, batch)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
                comps.append({k: v.item() for k, v in m.items()})
            launches = read()
            expect_launches(launches, f"24c {agg} + {ref}, 3 steps", k2=0)
            peak = torch.cuda.max_memory_allocated() / 1e9
            check(all(np.isfinite(v) for c in comps for v in c.values()),
                  f"24c {agg} + {ref}: losses {comps}")
            out["c"][f"{agg} + {ref}"] = {"ms": times, "peak_gb": peak, "launches": launches,
                                          "disp_loss": [c["disp_loss"] for c in comps]}
            log(f"  {card}: 24c {agg} + {ref}: ms a step {', '.join(f'{t:.1f}' for t in times)}"
                f", disp_loss "
                f"{', '.join('%.3f' % c['disp_loss'] for c in comps)}, peak memory {peak:.2f} GB")
            del model, optimizer, step, state
            torch.cuda.empty_cache()

        # d. f32 card vs CPU, the whole step and block by block; its own generator
        torch.backends.cudnn.deterministic = True
        gen_d = torch.Generator().manual_seed(2404)
        bsz, h, w = STEREO_CPU_STEP
        log(f"== 24d. f32 {w}x{h} x {bsz}: one train step on the card vs the CPU, then blocks "
            "with the CPU's ReLU gates forced")
        pairs = [rendered_pair(torch, gen_d, (h, w), 2.0, 40.0) for _ in range(bsz)]
        batch = {k: torch.from_numpy(np.stack([p[i] for p in pairs]))
                 for i, k in enumerate(("left", "right", "disp"))}
        batch["label"] = torch.randint(0, 19, (bsz, h, w), generator=gen_d).to(torch.uint8)
        out["d"] = {}
        for agg, ref, sem in (("stereonet", "stereonet", False), ("adaptive", "semantic", True)):
            cfg_d = parse_args(["--dataset", "kitti_2015", "--criterion", "none",
                                "--compute_dtype", "float32"] +
                               (["--train_semantic"] if sem else []))
            model = build_stereo_model(device="cpu", seed=25, max_disp=192, aggregation_type=agg,
                                       refinement_type=ref, train_semantic=sem, dtype="float32")
            randomize_bn(model, gen_d)
            randomize_offsets(torch, model, gen_d)
            res = {}
            for where in ("cpu", dev):
                m = copy.deepcopy(model).to(where).train()
                total, comps, outputs = stereo_loss(m, cfg_d, {k: v.to(where)
                                                               for k, v in batch.items()})
                total.backward()
                res[where] = ({k: v.item() for k, v in comps.items()},
                              outputs["disp"].detach().cpu(),
                              {k: v.cpu() for k, v in m.state_dict().items()
                               if k.endswith("running_mean") or k.endswith("running_var")},
                              {k: p.grad.cpu() for k, p in m.named_parameters()
                               if p.grad is not None})
                del m
            (c_cpu, d_cpu, s_cpu, g_cpu), (c_gpu, d_gpu, s_gpu, g_gpu) = res["cpu"], res[dev]
            comp_rel = max(abs(c_gpu[k] - c_cpu[k]) / max(abs(c_cpu[k]), 1e-30) for k in c_cpu)
            disp_rel = rel_err(torch, d_gpu, d_cpu)
            stats_rel = max(rel_err(torch, s_gpu[k], s_cpu[k]) for k in s_cpu)
            gate_free = [k for k in g_cpu if k.startswith(("refinement.conv_out.",
                                                           "segmentation.conv."))]
            gf_err = max(rel_err(torch, g_gpu[k], g_cpu[k]) for k in gate_free)
            top = max(g.abs().max().item() for g in g_cpu.values())
            # a gradient below 1e-4 of the largest is structurally zero (a bias
            # a soft-argmin or a train-mode BN cancels): its relative error is noise
            worst = max((k for k in g_cpu if g_cpu[k].abs().max().item() > 1e-4 * top),
                        key=lambda k: rel_err(torch, g_gpu[k], g_cpu[k]))
            out["d"][f"{agg} + {ref}"] = {"loss_rel": comp_rel, "disp_rel": disp_rel,
                                          "stats_rel": stats_rel, "gate_free_rel": gf_err}
            log(f"  24d {agg} + {ref}{' + train_semantic' if sem else ''}: losses {c_gpu} vs "
                f"{c_cpu}, max rel err {comp_rel:.2e} (1e-4); disparity {disp_rel:.2e} of max "
                f"(1e-4); BN running stats {stats_rel:.2e} (1e-4); gate-free gradients "
                f"({', '.join(gate_free)}) {gf_err:.2e} of max|g| (1e-3); the largest gradient "
                f"error {rel_err(torch, g_gpu[worst], g_cpu[worst]):.2e} in {worst} (not held: "
                "below a ReLU gate)")
            check(set(g_gpu) == set(g_cpu) and comp_rel <= 1e-4 and disp_rel <= 1e-4
                  and stats_rel <= 1e-4 and gf_err <= 1e-3,
                  f"24d {agg} + {ref}: the card's train step disagrees with the CPU")

            def nchw(*shape):
                return torch.randn(*shape, generator=gen_d).contiguous(
                    memory_format=torch.channels_last)

            hq, wq = h // 4, w // 4
            disp_in = torch.rand(bsz, hq, wq, generator=gen_d) * 10
            img = torch.rand(bsz, h, w, 3, generator=gen_d) * 255
            if sem:
                bottleneck = model.aggregation.fusions[1].branches[0][0]
                check(isinstance(bottleneck, DeformSimpleBottleneck), "24d: a deformable block")
                blocks = (("aggregation.fusions.1.branches.0.0 (deformable, window)",
                           bottleneck, [nchw(bsz, 48, hq, wq)]),
                          ("refinement (semantic-guided)", model.refinement,
                           [disp_in, img, nchw(bsz, 128, hq, wq)]),
                          ("segmentation", model.segmentation, [nchw(bsz, 128, hq, wq)]))
            else:
                # the 3-D aggregation on a small difference volume (its gates
                # are LeakyReLUs, which the recorder does not force)
                vol = torch.randn(bsz, 128, 12, 8, 16, generator=gen_d)
                blocks = (("aggregation (StereoNet, 3-D, (2, 128, 12, 8, 16))",
                           model.aggregation, [vol]),
                          ("refinement (StereoNet)", model.refinement, [disp_in, img]))
            for name, block, inputs in blocks:
                log_block(name, block_errors(torch, block, inputs, dev, gen_d), "24d ")
            del model
        torch.backends.cudnn.deterministic = False

        # e. inference --stereo on (b)'s checkpoint
        log("== 24e. inference --stereo --train_semantic --refinement_type semantic --resume "
            f"<24b best>: 2 KITTI pairs of {KITTI_HW[1]}x{KITTI_HW[0]} padded to "
            f"{KITTI_PAD[1]}x{KITTI_PAD[0]}, bf16 and f32")
        oh, ow = KITTI_HW
        ph, pw = KITTI_PAD
        kitti = os.path.join(base, "kitti_2015", "training")
        names = sorted(os.listdir(os.path.join(kitti, "image_2")))[:2]
        composition = ["--train_semantic", "--refinement_type", "semantic", "--max_disp", "192"]
        out["e"] = {}
        pair_dirs = {sub: os.path.join(base, "pairs", sub) for sub in ("image_2", "image_3")}
        for sub, d in pair_dirs.items():
            os.makedirs(d)
            for n in names:
                os.symlink(os.path.join(kitti, sub, n), os.path.join(d, n))
        out["e_k2_shapes"] = k2_at("24e's pairs", [(1, ph, pw)])
        for dtype in ("bfloat16", "float32"):
            args = ["--stereo", "--input", pair_dirs["image_2"], "--right_input",
                    pair_dirs["image_3"], "--resume", ckpt_b, "--output_dir",
                    os.path.join(base, f"out_{dtype}"), "--val_img_height", str(ph),
                    "--val_img_width", str(pw), "--compute_dtype", dtype,
                    "--device", dev.type] + composition
            reset()
            res = port_inference.main(args)
            torch.cuda.synchronize()
            got = read()
            expect_launches(got, f"24e inference --stereo {dtype}, 2 pairs", k2=6,
                            tc=6 if dtype == "bfloat16" else 0)
            model = build_stereo_model(port_inference.build_parser().parse_args(args), device=dev)
            port_inference.load_checkpoint(model, ckpt_b)
            within = []
            for path, n in zip(res["paths"], names):
                disk = read_png(path)
                pad = ((ph - oh, 0), (0, pw - ow), (0, 0))
                xl, xr = (torch.from_numpy(np.pad(read_png(os.path.join(kitti, sub, n), "RGB"),
                                                  pad)).to(dev, torch.float32)[None]
                          for sub in ("image_2", "image_3"))
                with torch.no_grad():
                    d = model.disparity(xl, xr)[0]["disp"][0].cpu().numpy()
                ref = np.clip(d[ph - oh:, :ow] * 256.0, 0, 65535).astype(np.uint16)
                check(disk.dtype == np.uint16 and disk.shape == (oh, ow), "24e: 16-bit PNGs")
                within.append(float((np.abs(disk.astype(np.int32) - ref) <= 1).mean()))
            fps = 1.0 / float(np.mean(res["forward_s"][1:]))
            out["e"][dtype] = {"launches": got, "within_1": within, "fps": fps}
            log(f"  {card}: 24e {dtype}: {fps:.2f} pairs/s from the second pair; PNGs within 1 "
                f"LSB of the forward in process on {', '.join(f'{v:.6f}' for v in within)} of "
                "the pixels (bar 0.999)")
            check(min(within) >= 0.999, f"24e: inference --stereo {dtype} disagrees")
            del model
    torch.backends.cudnn.benchmark = True
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t24
    log(f"  {card}: phase 24 took {out['seconds']:.1f} s")
    return out


def legacy_stereo_modules(torch, dtype):
    """{name: (module, inputs from the image)} of phase 25 in ``dtype``:
    the heads read the MobileNetV2 trunk's list, computed once."""
    from doubly_contrastive_semseg_tpu_torch.models import legacy_segmentation as ls
    from doubly_contrastive_semseg_tpu_torch.models import stereo_features as sf

    mods = {f"feature {k}": sf.make_stereo_feature(k, dtype=dtype)
            for k in sf.STEREO_FEATURES}
    mods["feature mobilenetv2 hourglass"] = sf.MobileNetV2Feature("hourglass", dtype=dtype)
    mods["feature ganet mdconv"] = sf.GANetFeature(feature_mdconv=True, dtype=dtype)
    mods["SegmentationBranches"] = ls.SegmentationBranches(dtype=dtype)
    mods["SegmentationDeeplabV3"] = ls.SegmentationDeeplabV3(dtype=dtype)
    for depth in (1, 2, 3):
        mods[f"SimpleSegmentation depth {depth}"] = ls.SimpleSegmentation(depth=depth,
                                                                          dtype=dtype)
    mods["DisparityFeature"] = ls.DisparityFeature(dtype=dtype)
    return mods


def legacy_call(name, module, img, feats, hw):
    """``module``'s forward on the image or on the trunk's maps ``feats``."""
    if name == "SegmentationDeeplabV3":
        return module(feats[5], hw)
    if name == "SimpleSegmentation" or name.startswith("SimpleSegmentation"):
        return module(feats[3])       # 32 channels at /8
    if name in ("SegmentationBranches", "DisparityFeature"):
        return module(feats)
    return module(img)


def flat(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def legacy_stereo_phase(torch, dev, card, reset, read):
    """25. The legacy stereo modules (module docstring): full width at
    384×1248 bf16, then f32 96×96 card vs CPU. Returns the times."""
    from doubly_contrastive_semseg_tpu_torch.models.blocks import init_weights
    from doubly_contrastive_semseg_tpu_torch.models.stereo_features import MobileNetV2Feature

    t25 = time.perf_counter()
    gen = torch.Generator().manual_seed(25)
    h, w = LEGACY_HW
    log(f"== 25. legacy stereo modules at {w}x{h} x 1 bf16 (ms a forward, peak memory), then "
        f"f32 {LEGACY_SMALL}x{LEGACY_SMALL} card vs CPU; {card}")
    out = {"bf16": {}, "f32": {}}

    def prepare(module, seed):
        init_weights(module, torch.Generator().manual_seed(seed))
        randomize_offsets(torch, module, torch.Generator().manual_seed(seed + 1))
        return module.eval()

    img = torch.randint(0, 256, (1, h, w, 3), generator=gen).float().div(255.0)
    trunk = prepare(MobileNetV2Feature(dtype=torch.bfloat16), 0).to(dev)
    reset()
    with torch.no_grad():
        feats = trunk(img.to(dev, torch.bfloat16))
        for i, (name, m) in enumerate(legacy_stereo_modules(torch, torch.bfloat16).items()):
            m = prepare(m, 10 + i).to(dev)
            x = img.to(dev, torch.bfloat16)
            y = flat(legacy_call(name, m, x, feats, (h, w)))
            check(all(torch.isfinite(t.float()).all().item() for t in y),
                  f"25: {name} gave a non-finite value")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: legacy_call(name, m, x, feats, (h, w)), iters=5, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 1e9
            out["bf16"][name] = {"ms": ms, "peak_gb": peak,
                                 "shapes": [tuple(t.shape) for t in y]}
            log(f"  {name}: {ms:.3f} ms a forward, peak {peak:.2f} GB, out "
                f"{[tuple(t.shape) for t in y]}")
            del m
    expect_launches(read(), "25a: the legacy stereo modules")

    s = LEGACY_SMALL
    small = torch.randint(0, 256, (2, s, s, 3), generator=gen).float().div(255.0)
    trunk32 = prepare(MobileNetV2Feature(), 0)
    with torch.no_grad():
        feats_cpu = trunk32(small)
        feats_dev = prepare(MobileNetV2Feature(), 0).to(dev)(small.to(dev))
        errs = {"feature mobilenetv2 (trunk)": max(rel_err(torch, a, b)
                                                   for a, b in zip(feats_dev, feats_cpu))}
        for i, (name, m) in enumerate(legacy_stereo_modules(torch, torch.float32).items()):
            m = prepare(m, 10 + i)
            want = flat(legacy_call(name, m, small, feats_cpu, (s, s)))
            got = flat(legacy_call(name, m.to(dev), small.to(dev), feats_dev, (s, s)))
            errs[name] = max(rel_err(torch, a, b) for a, b in zip(got, want))
    for name, e in errs.items():
        log(f"  f32 {name}: card vs CPU {e:.3e} of max (bar 1e-3)")
        check(e <= 1e-3, f"25b: {name} on the card disagrees with the CPU")
    out["f32"] = errs
    out["seconds"] = time.perf_counter() - t25
    log(f"  {card}: phase 25 took {out['seconds']:.1f} s")
    return out


def parallel_jobs(torch):
    """26's two-rank jobs on ``cuda:0`` over gloo against one process, and
    their checks: {"differences", "dense_launches", "eval_launches"}."""
    from doubly_contrastive_semseg_tpu_torch.tools import check_parallel as cp

    b, s = PARALLEL_DENSE
    jobs = [("flagship", {"dtype": "float64"}), ("flagship", {"dtype": "float32"}),
            ("flagship", {"dtype": "bfloat16"}),
            ("flagship", {"dtype": "float32", "b": b, "s": s}),
            ("stereo", {"dtype": "float32"}), ("eval", {}), ("stereo_eval", {})]
    t0 = time.perf_counter()
    many = cp.run_ranks(jobs, 2, "cuda", "gloo")
    t_many = time.perf_counter() - t0
    t0 = time.perf_counter()
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False     # as in the ranks: no tuning of each shape
    try:
        one = cp.run_one(jobs, "cuda")
    finally:
        torch.backends.cudnn.benchmark = benchmark
    t_one = time.perf_counter() - t0
    log(f"  {len(jobs)} jobs: two ranks {t_many:.1f} s (spawn included), one process "
        f"{t_one:.1f} s")
    out = {"differences": []}
    for (case, kw), m, o in zip(jobs, many, one):
        d = cp.differences(m, o)
        out["differences"].append({"case": case, **kw, **d})
        log(f"  {case} {kw}: {json.dumps(d)}; launches rank 0 "
            f"{ {k: v for k, v in m['launches'].items() if v} }, all ranks "
            f"{ {k: v for k, v in m['launches_all_ranks'].items() if v} }, one process "
            f"{ {k: v for k, v in o['launches'].items() if v} }")
        dt = kw.get("dtype")
        if dt == "float64":
            check(d["loss"] <= 1e-5 and d["bn_stats"] <= 1e-5 and d["params"] <= 1e-5,
                  f"26: {case} at f64 on two ranks differs from one process: {d}")
        elif dt == "float32":
            check(d["loss"] <= 1e-5 and d["bn_stats"] <= 1e-4,
                  f"26: {case} at f32 on two ranks differs from one process: {d}")
        elif dt == "bfloat16":
            check(d["loss"] <= 1e-2, f"26: the bf16 flagship loss on two ranks: {d}")
        elif case == "eval":
            check(d["accum"] == 0.0, f"26: the two-rank eval sums differ: {d}")
        else:
            check(d["sums"] <= 1e-5, f"26: the two-rank stereo validation sums differ: {d}")
    dense_m, dense_o = many[3], one[3]   # the f32 dense step
    for name in ("contrastive_row_stats", "pos_sweep_layout", "pixel_contrast_pos_sweep"):
        check(dense_m["launches"][name] >= 1 and dense_o["launches"][name] >= 1,
              f"26: {name} must launch on the {b * 19 * 2} gathered rows on each rank and in "
              "one process")
    check(all(m["launches"]["contrastive_row_stats"] == 0 for m in many[:3]),
          "26: the small flagship steps (152 rows) must not take K3")
    ev_m, ev_o = many[5], one[5]
    check(ev_m["launches_all_ranks"]["fused_stem_pool"] == 9
          and ev_m["launches"]["fused_stem_pool"] == 6
          and ev_o["launches"]["fused_stem_pool"] == 6,
          "26: K2 must launch 3 times a val batch on each rank that holds a frame "
          "(rank 0 both batches, rank 1 the first)")
    out["dense_launches"] = {"rank 0": dense_m["launches"],
                             "all ranks": dense_m["launches_all_ranks"]}
    out["eval_launches"] = {"rank 0": ev_m["launches"], "all ranks": ev_m["launches_all_ranks"]}
    return out


def parallel_phase(torch, dev, card, reset, read):
    """26. ``--num_devices`` on the one card (module docstring). Returns the
    launches and differences for the kernels line. The NCCL world-size-1
    run of ``main`` is a subprocess that runs beside the two-rank jobs: it
    has only to finish and write its checkpoint."""
    from doubly_contrastive_semseg_tpu_torch import main as port_main

    t26 = time.perf_counter()
    log(f"== 26. --num_devices: two ranks on cuda:0 over gloo against one process; {card}")
    # one NCCL rank of world size 1 through main's rank entry
    with tempfile.TemporaryDirectory() as root, tempfile.TemporaryDirectory() as logs:
        argv = ["--dataset", "synthetic", "--debug", "--synthetic_hw", "64x128",
                "--train_semantic", "--criterion", "supcon_pixelcontrast_focal", "--epochs",
                "1", "--batch_size", "2", "--val_batch_size", "2", "--num_workers", "2",
                "--no_build_summary", "--run_root", root]
        code = ("import sys; from doubly_contrastive_semseg_tpu_torch.main import run_rank; "
                "from doubly_contrastive_semseg_tpu_torch.parallel import free_init_method; "
                f"run_rank(0, 1, free_init_method(), None, {argv!r}); "
                "import torch.distributed as d; print('nccl world-size-1 ok')")
        t0 = time.perf_counter()
        paths = [os.path.join(logs, name) for name in ("stdout", "stderr")]
        with open(paths[0], "w") as fo, open(paths[1], "w") as fe:
            proc = subprocess.Popen([sys.executable, "-c", code], stdout=fo, stderr=fe,
                                    env={**os.environ, "PYTHONPATH": os.getcwd()})
        try:
            out = parallel_jobs(torch)
            proc.wait(timeout=max(1.0, 300 - (time.perf_counter() - t0)))
            stdout, stderr = (pathlib.Path(path).read_text() for path in paths)
            log(f"  NCCL world-size-1 main run (beside the jobs): exit {proc.returncode} in "
                f"{time.perf_counter() - t0:.1f} s; "
                f"{[ln for ln in stdout.splitlines() if ' took ' in ln or 'world-size' in ln]}")
            check(proc.returncode == 0 and "nccl world-size-1 ok" in stdout,
                  f"26: the NCCL rank failed:\n{stdout[-2000:]}\n{stderr[-2000:]}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        check(len(run_files(root)) > 0 and any(f.endswith("latest_checkpoint")
                                               for f in run_files(root)),
              "26: the NCCL rank wrote no checkpoint")
        try:
            port_main.main(argv + ["--num_devices", "2"])
        except ValueError as e:
            log(f"  main --num_devices 2 on this machine: ValueError({e})")
            check(f"{torch.cuda.device_count()} visible" in str(e), f"26: {e}")
        else:
            raise RuntimeError("chip_smoke: 26: main --num_devices 2 ran on a one-card machine")
    out["seconds"] = time.perf_counter() - t26
    log(f"  {card}: phase 26 took {out['seconds']:.1f} s")
    return out


def spatial_windows(h: int, w: int, m: int):
    """The (B, H, W) inputs K2 and K1 take on the ranks of a (1, m) grid at
    an h × w image: each rank's window of each pyramid level
    (``stem_reads``) and of the decoded features (``seghead_reads``)."""
    from doubly_contrastive_semseg_tpu_torch.ops.input_pipeline import pyramid_hw
    from doubly_contrastive_semseg_tpu_torch.ops.seghead import seghead_reads
    from doubly_contrastive_semseg_tpu_torch.ops.stem import stem_output_hw, stem_reads
    from doubly_contrastive_semseg_tpu_torch.parallel.spatial import ranges

    k2 = set()
    for lv in range(3):
        hh, ww = pyramid_hw(h, w, lv)
        for a, b in ranges(stem_output_hw(hh, ww)[1], m):
            lo, hi = stem_reads(ww)(a, b)
            k2.add((1, hh, hi - lo))
    k1 = set()
    for a, b in ranges(w, m):
        lo, hi = seghead_reads(w // 4)(a, b)
        k1.add((1, h // 4, hi - lo))
    return sorted(k2), sorted(k1)


def spatial_phase(torch, dev, card):
    """27. The width-split forward and serving (module docstring). Returns
    the per-rank launches and the measurements for the kernels line."""
    from doubly_contrastive_semseg_tpu_torch.tools import check_parallel as cp
    from doubly_contrastive_semseg_tpu_torch.tools import profile_seghead, profile_stem

    t27 = time.perf_counter()
    b, h, w = SPATIAL
    log(f"== 27. width-split DCSSModel (resnet18) forward and serving at {w}x{h} x {b}: grids "
        f"{SPATIAL_GRIDS} of ranks on cuda:0 over gloo ({SPATIAL_DTYPES}) against one "
        f"process; {card}")
    gen = torch.Generator().manual_seed(27)
    shapes = {}
    for _, m in SPATIAL_GRIDS:
        k2, k1 = spatial_windows(h, w, m)
        shapes[m] = {"k2": k2, "k1": k1}
    k2_all = sorted({s for v in shapes.values() for s in v["k2"]})
    k1_all = sorted({s for v in shapes.values() for s in v["k1"]})
    log(f"  K2 at the grids' level windows {k2_all} vs stem_pool_reference:")
    profile_stem.check_routes(gen, dev, log, shapes=k2_all)
    log(f"  K1 at the grids' feature windows {k1_all} vs seghead_reference:")
    profile_seghead.check_routes(gen, dev, log, shapes=k1_all)

    jobs = [("spatial", {"b": b, "h": h, "w": w, "dtype": dt, "time_iters": SPATIAL_ITERS})
            for dt in ("float32", "bfloat16")]
    out = {"window_shapes": shapes, "grids": {}}
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False     # as in the ranks: no tuning of each width
    try:
        t0 = time.perf_counter()
        one = cp.run_one(jobs, "cuda")
        log(f"  one process: {time.perf_counter() - t0:.1f} s")
        for shape in SPATIAL_GRIDS:
            t0 = time.perf_counter()
            pick = [i for i, (_, kw) in enumerate(jobs) if kw["dtype"] in SPATIAL_DTYPES[shape]]
            sub = [jobs[i] for i in pick]      # f32 first: spatial_results reads it as one[0]
            many = cp.run_grids([(shape, sub)], shape[0] * shape[1], "cuda", "gloo")[0]
            log(f"  grid {shape}: {time.perf_counter() - t0:.1f} s (spawn included)")
            out["grids"][str(shape)] = spatial_results(sub, many, [one[i] for i in pick], shape)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    keys = ("ms", "peak_gb", "forward_k2", "serving_k2", "serving_k1")
    out["one_process"] = {kw["dtype"]: {k: o["per_rank"][k][0] for k in keys}
                          for (_, kw), o in zip(jobs, one)}
    log(f"  one process: {json.dumps(out['one_process'])}")
    out["seconds"] = time.perf_counter() - t27
    log(f"  {card}: phase 27 took {out['seconds']:.1f} s")
    return out


def spatial_results(jobs, many, one, shape):
    """27's checks of one grid's results against one process's: f32 maps
    and weather logits within 1e-4 of max; bf16 labels on decided pixels,
    and the bf16 grid no further from the f32 forward than twice one
    process's bf16 forward (``jobs[0]`` is f32); K2 ×3 in the forward and ×3
    + K1 ×1 in serving on every rank and in one process, each on its
    dtype's route."""
    from doubly_contrastive_semseg_tpu_torch.tools import check_parallel as cp

    n = shape[0] * shape[1]
    res = {}
    for (_, kw), m, o in zip(jobs, many, one):
        dt = kw["dtype"]
        d = cp.differences(m, o)
        r = m["per_rank"]
        route = "tc" if dt == "bfloat16" else "cc"
        want = {"forward_k2": 3, f"forward_k2_{route}": 3, "forward_k1": 0, "serving_k2": 3,
                f"serving_k2_{route}": 3, "serving_k1": 1, f"serving_k1_{route}": 1}
        for who, counts in (("each rank", r), ("one process", o["per_rank"])):
            for k, v in want.items():
                check(counts[k] == [v] * len(counts[k]),
                      f"27: {shape} {dt}: {who}: {k} {counts[k]}, expected {v} each")
        log(f"  {shape} {dt}: {json.dumps({k: round(v, 9) for k, v in d.items()})}; "
            f"feature columns by rank {r['feat_cols']}; ms a forward by rank "
            f"{[round(x, 2) for x in r['ms']]} (one process {o['per_rank']['ms'][0]:.2f}); "
            f"peak GB by rank {[round(x, 3) for x in r['peak_gb']]} (one process "
            f"{o['per_rank']['peak_gb'][0]:.3f}); weather spread {r['weather_spread']}; "
            f"all-reduces a forward by rank {r['forward_all_reduce']} "
            f"({[round(x, 3) for x in r['forward_all_reduce_mb']]} MB)")
        check(r["weather_spread"] == [0.0] * n, f"27: {shape} {dt}: weather logits differ "
              f"between the ranks of a group: {r['weather_spread']}")
        if dt == "float32":
            bad = {k: d[k] for k in ("seg", "seg_beforeup", "fine_feat", "weather_logits")
                   if not d[k] <= 1e-4}
            check(not bad, f"27: {shape} f32 grid vs one process beyond 1e-4 of max: {bad}")
            check(d["labels_decided"] == 1.0, f"27: {shape} f32 labels on decided pixels: {d}")
        else:
            # decided: the top-two gap above twice the largest seg_beforeup
            # difference anywhere, so the share is low where that maximum is
            check(d["labels_decided"] >= 0.999 and d["decided"] >= 0.5,
                  f"27: {shape} bf16 labels (bar 0.999 on decided pixels, at least half of "
                  f"them decided): {d}")
            # the grid's bf16 rounding against one process's: each from the f32 forward
            f32 = one[0]
            grid_off, one_off = cp.differences(m, f32), cp.differences(o, f32)
            log(f"  {shape} bf16 against one process's f32 forward: grid "
                f"{json.dumps({k: round(v, 6) for k, v in grid_off.items()})}; one process "
                f"{json.dumps({k: round(v, 6) for k, v in one_off.items()})}")
            check(grid_off["seg_beforeup"] <= 2 * one_off["seg_beforeup"],
                  f"27: {shape} the bf16 grid is further from the f32 forward than twice one "
                  f"process's bf16 forward: {grid_off} vs {one_off}")
            d["vs_f32"] = {"grid": grid_off, "one_process": one_off}
        res[dt] = {"differences": d, "per_rank": r}
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    try:
        from doubly_contrastive_semseg_tpu_torch import Config, build_model, make_serving_fn
        from doubly_contrastive_semseg_tpu_torch.ops import (
            _build, blend, contrastive, edt, seghead, stem)
        from doubly_contrastive_semseg_tpu_torch.tools import (
            profile_blend, profile_contrastive, profile_host_data, profile_jfa, profile_seghead,
            profile_stem)
        from doubly_contrastive_semseg_tpu_torch.train import (
            TrainState, build_optimizer, compute_loss, make_train_step)
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable here: {e}",
              file=sys.stderr)
        return 1
    libs = host_libraries()
    log(f"== 0. host libraries importable here, each in a fresh interpreter (the port reads "
        f"JPEG and runs ColorJitter, the flips and RandomAffine through PIL, draws the t-SNE "
        f"with sklearn and matplotlib and the EDT panels with matplotlib, uses visdom where "
        f"it answers, and uses neither cv2, scipy nor grain; training needs none of them): "
        f"{json.dumps(libs)}")
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

    # 17. the runtime and its CLIs
    runtime = runtime_phase(torch, dev, card, profile_stem)
    kernels[0]["trainer_launches"] = {"validate, 2 epochs": runtime["k2_validate"],
                                      "test_only": runtime["k2_test_only"]}
    kernels[0]["inference_launches"] = runtime["k2_inference"]
    kernels[-1]["trainer_launches"] = runtime["jf_trainer"]

    # 18. the DeepLab family and ENet; its own generator
    t18 = time.perf_counter()
    gen18 = torch.Generator().manual_seed(18)
    reset, read = count_launches(stem, edt, contrastive, seghead, blend)
    train18 = deeplab_train_phase(torch, dev, card, gen18, reset, read)
    dense18, wide = deeplab_dense_phase(torch, dev, card, gen18, reset, read,
                                        profile_contrastive)
    deeplab_eval_phase(torch, dev, card, gen18, reset, read)
    other_models_phase(torch, dev, card, gen18, reset, read)
    deeplab_cli_phase(torch, dev, card, train18["batch"], reset, read)
    for i, (name, k) in ((2, ("contrastive_row_stats", "k3")),
                         (4, ("pixel_contrast_pos_sweep", "k4"))):
        kernels[i]["deeplab"] = {
            "launches": dense18[name], "n": DENSE_BATCH * 19 * 2,
            "by_d": {d: {"ms": t[f"{k}_ms"], "plain_ms": t[f"{k}_plain_ms"],
                         "bound_ms": t[f"{k}_bound_ms"], "bound_by": t[f"{k}_bound_by"],
                         "max_abs_err": t[f"{k}_err"]} for d, t in wide.items()}}
    kernels[3]["deeplab"] = {"launches": dense18["pos_sweep_layout"]}
    log(f"== 18. done in {time.perf_counter() - t18:.1f} s")

    # 19. the six other WeatherNet backbones; its own generator
    t19 = time.perf_counter()
    gen19 = torch.Generator().manual_seed(19)
    serve19 = swift_serving_phase(torch, dev, card, gen19, reset, read)
    train19 = swift_train_phase(torch, dev, card, gen19, reset, read)
    dense19, dense19_ms, alone19 = swift_dense_phase(torch, dev, card, gen19, reset, read,
                                                     profile_contrastive)
    k1_others = other_backbones_phase(torch, dev, card, gen19, reset, read)
    swift_cli_phase(torch, dev, card, reset, read)
    kernels[1]["weathernet_backbones"] = {
        SWIFT: {"launches_a_serving_batch": serve19["k1_batch"], "ms": serve19["k1_ms"],
                "bf16_agreement_decided": serve19["k1_bf16"][1],
                "f32_agreement": serve19["k1_f32"][0]},
        "other_five_f32_serving": k1_others}
    for i, name, k in ((2, "contrastive_row_stats", "k3"), (3, "pos_sweep_layout", None),
                       (4, "pixel_contrast_pos_sweep", "k4")):
        kernels[i][SWIFT] = {"launches": dense19[name], "n": DENSE_BATCH * 19 * 2}
        if k:
            kernels[i][SWIFT].update({key: alone19[f"{k}_{key}"] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by")})
    log(f"== 19. done in {time.perf_counter() - t19:.1f} s (recipe step {train19['ms_step']:.2f} "
        f"ms, dense step {dense19_ms:.2f} ms)")

    # 20. the cityscapes, acdc_city and city_lost datasets, JPEG inference
    kernels[0]["new_datasets_launches"] = new_datasets_phase(
        torch, dev, card, reset, read, profile_host_data, profile_stem)

    # 21. the grain loader's mid-epoch position and the tools
    p21 = grain_tools_phase(torch, dev, card, reset, read, libs)
    kernels[0]["tsne_launches"] = p21["k2_tsne"]
    kernels[-1]["grain_launches"] = {"uninterrupted": p21["jf_uninterrupted"],
                                     "resumed": p21["jf_resumed"]}

    # 22. stereo serving
    p22 = stereo_phase(torch, dev, card, reset, read)
    a22, b22 = p22["launches_a"], p22["launches_b"]
    kernels[0]["stereo"] = {
        "launches_a_serving_batch": a22["fused_stem_pool"],
        "tensor_core_launches": a22["fused_stem_pool_tc"],
        "f32_launches": b22["fused_stem_pool"],
        "inference_stereo_launches_2_pairs": {
            dtype: r["launches"]["fused_stem_pool"] for dtype, r in p22["inference"].items()},
        "refinement_stem_ms": p22["k2_refinement_ms"]}
    kernels[1]["stereo"] = {"launches_a_serving_batch": a22["fused_seghead_upsample_argmax"],
                            "tensor_core_launches": a22["k1_tc"],
                            "f32_cuda_core_launches": b22["k1_cc"], "ms": p22["k1_ms"],
                            "f32_label_agreement_vs_cpu": p22["f32"]["label_agreement"]}

    # 23. the 3-D aggregations and the warp-error refinements
    p23 = stereo_3d_phase(torch, dev, card, reset, read)
    a23 = p23["launches_a"]
    kernels[0]["stereo_3d"] = {
        "launches_a_serving_batch": a23["fused_stem_pool"],
        "tensor_core_launches": a23["fused_stem_pool_tc"],
        "kitti_launches_5_pairs": {k: r["launches"]["fused_stem_pool"]
                                   for k, r in p23["kitti"].items()},
        "f32_launches": {k: r["launches"]["fused_stem_pool"] for k, r in p23["f32"].items()},
        "inference_stereo_launches_2_pairs": {
            dtype: r["launches"]["fused_stem_pool"] for dtype, r in p23["inference"].items()}}
    kernels[1]["stereo_3d"] = {"launches_a_serving_batch": a23["fused_seghead_upsample_argmax"],
                               "tensor_core_launches": a23["k1_tc"]}

    # 24. stereo training
    p24 = stereo_train_phase(torch, dev, card, reset, read)
    kernels[0]["stereo_training"] = {
        run: {"val_batches": p24[key]["val_batches"], **p24[key]["k2"]}
        for run, key in (("sceneflow, 2 epochs", "a"), ("sceneflow resumed", "a_resumed"),
                         ("sceneflow test_only", "a_test_only"), ("kitti_2015", "b"))}
    kernels[0]["stereo_training"]["3-D aggregations, 3 steps each"] = {
        k: r["launches"]["fused_stem_pool"] for k, r in p24["c"].items()}
    kernels[0]["stereo_training"]["inference_stereo_launches_2_pairs"] = {
        dtype: r["launches"]["fused_stem_pool"] for dtype, r in p24["e"].items()}

    # 25. the legacy stereo feature extractors and RODSNet heads
    p25 = legacy_stereo_phase(torch, dev, card, reset, read)
    log(f"== 25. done: {json.dumps({k: round(v['ms'], 3) for k, v in p25['bf16'].items()})}")

    # 26. --num_devices: ranks, shards and the collectives
    p26 = parallel_phase(torch, dev, card, reset, read)
    kernels[0]["two_rank_validation"] = p26["eval_launches"]
    for i, name in ((2, "contrastive_row_stats"), (3, "pos_sweep_layout"),
                    (4, "pixel_contrast_pos_sweep")):
        kernels[i]["two_rank_dense_step"] = {
            "rows_gathered": PARALLEL_DENSE[0] * 19 * 2,
            "rank_0": p26["dense_launches"]["rank 0"][name],
            "all_ranks": p26["dense_launches"]["all ranks"][name]}

    # 27. the width-split forward and serving over grids of ranks
    p27 = spatial_phase(torch, dev, card)
    for i, what, keys in ((0, "spatial_forward", ("forward_k2", "forward_k2_tc", "forward_k2_cc")),
                          (0, "spatial_serving", ("serving_k2", "serving_k2_tc", "serving_k2_cc")),
                          (1, "spatial_serving", ("serving_k1", "serving_k1_tc", "serving_k1_cc"))):
        kernels[i][what] = {
            grid: {dt: {"launches_by_rank": {k: r["per_rank"][k] for k in keys},
                        "ms_a_forward_by_rank": r["per_rank"]["ms"],
                        "all_reduces_a_forward_by_rank": r["per_rank"]["forward_all_reduce"]}
                   for dt, r in g.items()}
            for grid, g in p27["grids"].items()}
        kernels[i][what]["one_process"] = p27["one_process"]
        kernels[i][what]["window_shapes"] = {m: v["k2" if i == 0 else "k1"]
                                             for m, v in p27["window_shapes"].items()}

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
