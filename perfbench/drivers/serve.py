"""Offline labelling of recorded drive logs: batches of raw frames from a
pool in pinned host memory go through the port's serving entry,
``models/serving.py::make_serving_fn``, and their int8 label maps come back
into pinned host memory. The traffic file sets how many batches are in
flight: the next batch's upload runs on a stream of its own while this one
computes.

The traffic file gives the frame size, the batch and the pool; the
configuration gives the model. ``serve_fps`` counts the frames whose labels
reached host memory inside the window, over the window's length;
``serve_p95_ms`` is the 95th percentile, over those batches, of the time
from a batch's submission on the host clock until the host saw its labels
in host memory."""

from __future__ import annotations

import gc
import random
import statistics
import time
from typing import Optional

import torch

from doubly_contrastive_semseg_tpu_torch.config import Config
from doubly_contrastive_semseg_tpu_torch.models import build_model, make_serving_fn
from doubly_contrastive_semseg_tpu_torch.ops import _build

from ..harness import compare, env, flops, manifest, seeded, trace as tracing
from ..harness.record import Record, sync

KEEP = 8            # batches kept for the check, a uniform sample of those submitted


def program_model(config: dict, seed: int, device, ref_shapes):
    cfg = Config(**config["program"]).finalize()
    model = build_model(cfg, device=device, seed=0)
    model.load_state_dict(seeded.state_dict(ref_shapes, seed, device))
    return model.eval()


def reference_shapes(config: dict):
    ref = manifest.reference(config["reference"])
    with torch.device("meta"):
        model = ref.build(config["widths"]["num_classes"], config["widths"]["weather_num"])
    return seeded.shapes_of(model)


class Pipeline:
    """Submits batch i (its upload on the upload stream, the serve call,
    the copy of its labels to host memory) and observes completions, with
    at most ``in_flight`` batches submitted and not yet seen done."""

    def __init__(self, serve, pool, batch: int, in_flight: int, device, keep_seed: int):
        self.serve, self.pool, self.batch, self.in_flight = serve, pool, batch, in_flight
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        n, h, w, _ = pool.shape
        self.slots = n // batch
        self.dev_in = [torch.empty((batch, h, w, 3), dtype=torch.uint8, device=device)
                       for _ in range(in_flight)]
        self.in_free = [None] * in_flight
        pin = self.cuda
        self.ring = [torch.empty((batch, h, w), dtype=torch.int8, pin_memory=pin)
                     for _ in range(in_flight)]
        self.keep = [torch.empty((batch, h, w), dtype=torch.int8, pin_memory=pin)
                     for _ in range(KEEP)]
        self.kept = [None] * KEEP           # batch index held in each keep buffer
        self.rng = random.Random(keep_seed)
        self.up = torch.cuda.Stream(self.device) if self.cuda else None
        self.submitted = 0
        self.pending = []                   # (index, submit time, done event)
        self.done = []                      # (index, submit time, done time)
        self.dispatch_ms = []

    def frames(self, i: int) -> slice:
        s = (i % self.slots) * self.batch
        return slice(s, s + self.batch)

    def _target(self, i: int) -> torch.Tensor:
        # reservoir sampling over every submitted batch
        if i < KEEP:
            j = i
        else:
            j = self.rng.randrange(i + 1)
            if j >= KEEP:
                return self.ring[i % self.in_flight]
        self.kept[j] = i
        return self.keep[j]

    def submit(self) -> None:
        i = self.submitted
        j = i % self.in_flight
        t_submit = time.perf_counter()
        if self.cuda:
            with torch.cuda.stream(self.up):
                if self.in_free[j] is not None:
                    self.up.wait_event(self.in_free[j])
                self.dev_in[j].copy_(self.pool[self.frames(i)], non_blocking=True)
                uploaded = torch.cuda.Event()
                uploaded.record(self.up)
            torch.cuda.current_stream(self.device).wait_event(uploaded)
        else:
            self.dev_in[j].copy_(self.pool[self.frames(i)])
        t0 = time.perf_counter()
        labels = self.serve(self.dev_in[j])
        self.dispatch_ms.append((time.perf_counter() - t0) * 1e3)
        if self.cuda:
            read = torch.cuda.Event()
            read.record()
            self.in_free[j] = read
        self._target(i).copy_(labels, non_blocking=self.cuda)
        done = None
        if self.cuda:
            done = torch.cuda.Event()
            done.record()
        self.pending.append((i, t_submit, done))
        self.submitted += 1

    def wait_oldest(self) -> None:
        i, t_submit, done = self.pending.pop(0)
        if done is not None:
            done.synchronize()
        self.done.append((i, t_submit, time.perf_counter()))

    def run_for(self, seconds: float):
        """Keeps ``in_flight`` batches in flight for ``seconds``; returns
        (start, end)."""
        start = time.perf_counter()
        end = start + seconds
        while time.perf_counter() < end:
            self.submit()
            while len(self.pending) >= self.in_flight:
                self.wait_oldest()
        self.drain()
        return start, end

    def run_n(self, n: int) -> None:
        for _ in range(n):
            self.submit()
            while len(self.pending) >= self.in_flight:
                self.wait_oldest()
        self.drain()

    def drain(self) -> None:
        while self.pending:
            self.wait_oldest()


def run(cell: dict, config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device="cuda", overrides: Optional[dict] = None, t_start: Optional[float] = None,
        out_dir=None) -> Record:
    t_start = time.perf_counter() if t_start is None else t_start
    mix = dict(traffic, **(overrides or {}))
    rec = Record("serve", cell, config, mix)
    cuda = torch.device(device).type == "cuda"
    b, (h, w), n_pool = mix["batch"], mix["frame_hw"], mix["pool"]

    # ---- set-up -------------------------------------------------------
    if cuda:
        if config.get("cuda_sources"):
            _build.build(config["cuda_sources"])
        torch.backends.cudnn.benchmark = True
    shapes = reference_shapes(config)
    model = program_model(config, seed, device, shapes)
    serve = make_serving_fn(model, device=device)
    pool = seeded.frame_pool(seed, n_pool, h, w, device, pin=cuda)
    pipe = Pipeline(serve, pool["left"], b, mix["in_flight"], device, seeded.key(seed, "keep"))
    pipe.run_n(mix["warmup_batches"])
    sync(device)
    warm = len(pipe.done)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    rec.e2e["setup_s"] = time.perf_counter() - t_start

    # ---- window -------------------------------------------------------
    start, end = pipe.run_for(seconds)
    window = [(i, ts, td) for i, ts, td in pipe.done[warm:]]
    in_window = [(i, ts, td) for i, ts, td in window if td <= end]
    latencies = sorted((td - ts) * 1e3 for _, ts, td in in_window)
    rec.window_s = end - start
    rec.iterations = len(in_window)
    rec.attempted = len(window)
    rec.failed = 0
    rec.e2e["serve_fps"] = b * len(in_window) / rec.window_s
    rec.e2e["serve_p95_ms"] = (statistics.quantiles(latencies, n=20)[-1] if len(latencies) > 1
                               else float("nan"))
    rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    rec.e2e["peak_mem_gib"] = rec.memory_peak_bytes / 2 ** 30
    rec.host["dispatch_ms"] = pipe.dispatch_ms[warm:]

    # ---- traced window (per-layer metrics) ----------------------------
    if trace:
        n = mix["traced_batches"]
        rec.trace = tracing.profile(lambda: pipe.run_n(n), n,
                                    (out_dir or env.OUT) / f"{cell['name']}.trace.json")
        rec.flops_per_iteration = flops.model_flops(config, b, h, w, train=False)

    # ---- correctness, once the window has closed and the program is freed
    kept = [(j, i) for j, i in enumerate(pipe.kept) if i is not None]
    held = {i: pipe.keep[j] for j, i in kept}
    frames_of = {i: pipe.frames(i) for _, i in kept}
    del serve, model, pipe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rec.numbers = check(config, seed, pool, held, frames_of, device, shapes)
    rec.limits = manifest.limits(cell["name"])
    rec.correct = compare.verdict(rec.numbers, rec.limits)
    return rec


def reference_model(config: dict, seed: int, device, shapes, fp8: bool = False):
    from ..reference import layers, plain_precision
    plain_precision()
    torch.backends.cudnn.benchmark = False
    ref = manifest.reference(config["reference"]).build(config["widths"]["num_classes"],
                                                       config["widths"]["weather_num"])
    ref = ref.to(device)
    ref.load_state_dict(seeded.state_dict(shapes, seed, device))
    return layers.set_fp8(ref, fp8).eval()


@torch.no_grad()
def check(config: dict, seed: int, pool: dict, held: dict, frames_of: dict, device, shapes,
          fp8: bool = False) -> dict:
    """``label_gap`` and ``label_tail_gap`` of every kept batch against the
    reference run over its frames, one frame at a time: the worst frame's."""
    ref = reference_model(config, seed, device, shapes, fp8)
    by_frame = {}
    for i, labels in held.items():
        for k, f in enumerate(range(frames_of[i].start, frames_of[i].stop)):
            by_frame.setdefault(f, []).append(labels[k])
    worst = {"label_gap": None, "label_tail_gap": None}
    for f, served in sorted(by_frame.items()):
        image = pool["left"][f:f + 1].to(device)
        logits = ref(image)["seg_beforeup"][0]
        for lab in served:
            for k, v in compare.label_gaps(logits, lab.to(device)).items():
                worst[k] = v if worst[k] is None else max(worst[k], v)
    return worst

