"""The published training recipe as ``main --no_host_augment`` feeds it:
each step takes a batch of raw frames from a pool in pinned host memory
through ``data/loader.py::to_device``, makes the two augmented views on the
card with ``data/device_augment.py::apply_augment`` (crop parameters drawn
by the benchmark from the seed; JF's boundary weights; γ on night frames),
and runs the step of ``train/steps.py::make_train_step`` with Adam.

Steps are dispatched ahead; the losses stay on the card and one sync
closes the window. ``train_samples_s`` is the samples of every step of the
window over its length, a sample being one raw frame taken through its two
views.

The first three steps run in set-up, through the same calls and feed on
frames that all differ; the benchmark keeps each step's loss, the first
gradient as Adam holds it after step 1, and the parameters' change over
the three as norms per leaf. After the window the reference replays those
three steps from the same weights and inputs."""

from __future__ import annotations

import gc
import time
from typing import Optional

import torch

from doubly_contrastive_semseg_tpu_torch.config import Config
from doubly_contrastive_semseg_tpu_torch.data.device_augment import apply_augment
from doubly_contrastive_semseg_tpu_torch.data.loader import to_device
from doubly_contrastive_semseg_tpu_torch.models import build_model
from doubly_contrastive_semseg_tpu_torch.ops import _build
from doubly_contrastive_semseg_tpu_torch.train.optimizer import build_optimizer
from doubly_contrastive_semseg_tpu_torch.train.state import TrainState
from doubly_contrastive_semseg_tpu_torch.train.steps import make_train_step

from ..harness import compare, env, flops, manifest, seeded, trace as tracing
from ..harness.record import Record, sync
from .serve import reference_shapes

CHECKED_STEPS = 3
PARTS = ("seg_loss", "supcon_loss", "pixelcontrast_loss")   # the loss's terms
TABLE = 4096            # crop parameters drawn in set-up, one row a step


def crop_table(seed: int, n: int, b: int, h: int, w: int, crop: int, device):
    """(n, 3, 2, b) float32 on the card: x0, y0, box of both views of every
    frame of each of ``n`` steps, with the recipe's law: scale ~ U(0.5, 2),
    box = ⌊scale · crop⌋, offsets ⌊u · (max(side − box, 0) + 1)⌋."""
    gen = seeded.generator(device, seed, "crops")
    u = torch.rand((n, 3, 2, b), generator=gen, device=device)
    box = torch.floor((u[:, 0] * 1.5 + 0.5) * crop)
    max_x = torch.clamp(torch.clamp(box, min=w) - box, min=0)
    max_y = torch.clamp(torch.clamp(box, min=h) - box, min=0)
    return torch.stack([torch.floor(u[:, 1] * (max_x + 1)), torch.floor(u[:, 2] * (max_y + 1)),
                        box], dim=1)


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The draws of step ``step`` (dropout masks, then the pixel-contrast
    anchor keys); the reference makes the same generator."""
    return seeded.generator(device, seed, "step", step)


class Feed:
    """Step ``i``'s host batch: ``b`` consecutive frames of the pool."""

    def __init__(self, pool: dict, b: int):
        self.pool, self.b = pool, b
        self.slots = pool["left"].shape[0] // b

    def frames(self, i: int) -> slice:
        s = (i % self.slots) * self.b
        return slice(s, s + self.b)

    def host_batch(self, i: int) -> dict:
        f = self.frames(i)
        return {"left": self.pool["left"][f], "label": self.pool["label"][f],
                "weather": self.pool["weather"][f]}


def held_leaves(model, optimizer):
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: p for g in optimizer.param_groups for p in g["params"]}


class Program:
    """The port's training objects of one run, built from the seed: the
    model (weights loaded from the seeded state dict), Adam, the step, the
    frame pool, the class weights and the crop table; ``step(i)`` runs
    step ``i`` through ``to_device``, ``apply_augment`` and the step."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.cuda = torch.device(device).type == "cuda"
        b, (h, w), crop = mix["batch"], mix["frame_hw"], mix["crop"]
        self.classes = config["widths"]["num_classes"]
        if self.cuda:
            if config.get("cuda_sources"):
                _build.build(config["cuda_sources"])
            torch.backends.cudnn.benchmark = True
        self.shapes = reference_shapes(config)
        cfg = Config(**config["program"]).finalize()
        self.model = build_model(cfg, device=device, seed=0)
        self.model.load_state_dict(seeded.state_dict(self.shapes, seed, device))
        self.optimizer = build_optimizer(self.model, cfg, mix["steps_per_epoch"])
        self.state = TrainState(self.model, self.optimizer)
        self.train_step = make_train_step(self.model, cfg, self.optimizer)
        self.pool = seeded.frame_pool(seed, mix["pool"], h, w, device, pin=self.cuda)
        # on the card, as the trainer holds it: a pageable copy a step would sync
        self.class_weight = seeded.class_weights(self.pool["class_counts"], self.classes,
                                                 cfg.epsilon).to(device)
        self.table = crop_table(seed, TABLE, b, h, w, crop, device)
        self.feed = Feed(self.pool, b)
        self.timing = False
        self.dispatch_ms = []

    def step(self, i: int) -> dict:
        mix = self.mix
        with torch.profiler.record_function("bench.to_device"):
            db = to_device(self.feed.host_batch(i), self.device, self.class_weight)
        with torch.profiler.record_function("bench.augment"):
            p = self.table[i % TABLE]
            db.update(apply_augment(db["left"], db["label"], db["weather"], (p[0], p[1], p[2]),
                                    crop=mix["crop"], num_classes=self.classes, two_crop=True,
                                    use_gamma=mix["gamma_night"]))
        gen = step_generator(self.device, self.seed, i)
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.train_step"):
            metrics = self.train_step(self.state, db, gen)
        if self.timing:
            self.dispatch_ms.append((time.perf_counter() - t0) * 1e3)
        return metrics

    def first_steps(self) -> dict:
        """Steps 0 to ``CHECKED_STEPS`` - 1, and what the check compares of
        them: each loss and its terms, the norm of each held leaf's first
        gradient (Adam's first moment after step 1 over 1 - β1) and of its
        change over the steps."""
        held = held_leaves(self.model, self.optimizer)
        start = {n: p.detach().clone() for n, p in held.items()}
        parts = [self.step(0)]
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        # a leaf the step did not update has no moment: the check counts it missing
        grads = {n: self.optimizer.state[p]["exp_avg"].norm() / (1 - beta1)
                 for n, p in held.items() if "exp_avg" in self.optimizer.state.get(p, {})}
        parts += [self.step(i) for i in range(1, CHECKED_STEPS)]
        changes = {n: (p.detach() - start[n]).norm() for n, p in held.items()}
        return {"loss": [float(m["total_loss"]) for m in parts],
                "parts": [{k: float(m[k]) for k in PARTS} for m in parts],
                "grad": {n: float(v) for n, v in grads.items()},
                "change": {n: float(v) for n, v in changes.items()}}

    def free(self) -> None:
        """Drops the program's model, optimizer and step before the
        reference runs."""
        del self.train_step, self.state, self.optimizer, self.model
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def reference(self, fp8: bool = False, fault=None) -> dict:
        return reference_steps(self.config, self.seed, self.pool, self.feed, self.table,
                               self.class_weight, self.mix, self.device, self.shapes, fp8, fault)


def run(cell: dict, config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device="cuda", overrides: Optional[dict] = None, t_start: Optional[float] = None,
        out_dir=None) -> Record:
    t_start = time.perf_counter() if t_start is None else t_start
    mix = dict(traffic, **(overrides or {}))
    rec = Record("train", cell, config, mix)
    cuda = torch.device(device).type == "cuda"

    # ---- set-up -------------------------------------------------------
    prog = Program(config, mix, seed, device)
    first = prog.first_steps()
    i = CHECKED_STEPS
    for _ in range(mix["warmup_steps"]):
        prog.step(i)
        i += 1
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    rec.e2e["setup_s"] = time.perf_counter() - t_start

    # ---- window -------------------------------------------------------
    prog.timing = trace
    start_i = i
    start = time.perf_counter()
    end = start + seconds
    loss = None
    while time.perf_counter() < end:
        loss = prog.step(i)["total_loss"]
        i += 1
    sync(device)
    stop = time.perf_counter()
    prog.timing = False
    if loss is not None and not bool(torch.isfinite(loss)):
        rec.failed = 1
    rec.window_s = stop - start
    rec.iterations = i - start_i
    rec.attempted = rec.iterations
    rec.e2e["train_samples_s"] = mix["batch"] * rec.iterations / rec.window_s
    rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    rec.e2e["peak_mem_gib"] = rec.memory_peak_bytes / 2 ** 30
    rec.host["dispatch_ms"] = prog.dispatch_ms

    # ---- traced window (per-layer metrics) ----------------------------
    if trace:
        n = mix["traced_steps"]

        def traced():
            for k in range(n):
                prog.step(i + k)
            sync(device)

        rec.trace = tracing.profile(traced, n, (out_dir or env.OUT) / f"{cell['name']}.trace.json")
        rec.flops_per_iteration = flops.model_flops(config, 2 * mix["batch"], mix["crop"],
                                                    mix["crop"], train=True)

    # ---- correctness, once the window has closed and the program is freed
    prog.free()
    rec.numbers = compare.train_gaps(first, prog.reference())
    rec.limits = manifest.limits(cell["name"])
    rec.correct = compare.verdict(rec.numbers, rec.limits)
    return rec


def reference_batches(seed: int, pool: dict, feed: Feed, table, device, n: int):
    for i in range(n):
        f = feed.frames(i)
        p = table[i % TABLE]
        yield {"images": pool["left"][f].to(device), "labels": pool["label"][f].to(device),
               "weather": pool["weather"][f].to(device), "params": (p[0], p[1], p[2]),
               "generator": step_generator(device, seed, i)}


def reference_steps(config: dict, seed: int, pool: dict, feed: Feed, table, class_weight,
                    mix: dict, device, shapes, fp8: bool = False, fault=None) -> dict:
    """The reference's first ``CHECKED_STEPS`` steps from the same weights,
    frames, crops and draws (``fault`` maps each batch, for the checks of
    the comparison itself)."""
    from ..reference import layers, plain_precision
    from ..reference import train as ref_train
    plain_precision()
    torch.backends.cudnn.benchmark = False
    mod = manifest.reference(config["reference"])
    # float32, or float64 where the configuration states it (the CPU tests')
    dtype = torch.float64 if config["program"]["compute_dtype"] == "float64" else torch.float32
    model = mod.build(config["widths"]["num_classes"], config["widths"]["weather_num"])
    model = model.to(device=device, dtype=dtype)
    model.load_state_dict(seeded.state_dict(shapes, seed, device))
    layers.set_fp8(model, fp8)
    batches = reference_batches(seed, pool, feed, table, device, CHECKED_STEPS)
    if fault is not None:
        batches = map(fault, batches)
    out = ref_train.steps(model, batches, config["optimizer"], mix["crop"],
                          config["widths"]["num_classes"], class_weight.to(device),
                          CHECKED_STEPS)
    del model
    gc.collect()
    return out

