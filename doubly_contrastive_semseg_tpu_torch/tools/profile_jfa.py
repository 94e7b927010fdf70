"""The jump-flood EDT kernel (``csrc/jfa.cu``) alone on the card: checks
against the plain version, device operations a call, and times.

    python3 -m doubly_contrastive_semseg_tpu_torch.tools.profile_jfa

Builds only ``csrc/jfa.cu`` and prints ptxas's report. Holds
``nearest_diff_label_distance`` on the card bit for bit to its plain
version, also on the card, at ``CHECK_CASES``: the labels of 8 synthetic
768² crops (the flagship train step's, ``data/device_augment.py``), the
same crops with 5 % salt noise, and small odd shapes in int32 and int64
(and one against the CPU's plain version, which the CPU tests hold to
JAX). Checks that one 768² call is 88 kernel nodes and nothing else in its
CUDA-graph capture, then times the kernel (behind a sleep kernel), the
plain version and the bound at the crops. ``chip_smoke.py`` phase 11
calls ``check_kernel``, ``device_ops`` and ``time_jfa``.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from ..data.device_augment import crop_labels, sample_crop_params
from ..data.synthetic import SyntheticDataset
from ..ops import _build, edt
from .profile_stem import CU_GRAPH_NODE_TYPE_KERNEL, captured_ops, cuda_ms

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12         # H100 SXM float32 outside the tensor cores
BATCH, CROP, FRAME_HW = 8, 768, (1024, 2048)
FLOPS_PER_CANDIDATE = 5        # (y - cy)^2 + (x - cx)^2: 2 subtractions, 2 products, 1 sum


def crop_batch(dev, seed: int = 0) -> torch.Tensor:
    """uint8 labels of ``BATCH`` synthetic frames (``FRAME_HW``) cropped to
    ``CROP``² on the card as the flagship train step crops them."""
    ds = SyntheticDataset(size=BATCH, image_hw=FRAME_HW, seed=seed)
    labels = torch.from_numpy(np.stack([ds[i]["label"] for i in range(BATCH)])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x0, y0, box = sample_crop_params(gen, BATCH, *FRAME_HW, CROP, two_crop=False)
    return crop_labels(labels, x0[0], y0[0], box[0], CROP)


def salted(labels: torch.Tensor, density: float = 0.05, seed: int = 1) -> torch.Tensor:
    gen = torch.Generator(device=labels.device).manual_seed(seed)
    salt = torch.rand(labels.shape, generator=gen, device=labels.device) < density
    noise = torch.randint(0, 19, labels.shape, generator=gen, device=labels.device,
                          dtype=labels.dtype)
    return torch.where(salt, noise, labels)


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype == torch.float32 and \
        torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_kernel(gen, dev, log=print) -> float:
    """The kernel against the plain version on the card (bitwise) at the
    crops, the salted crops and small cases; one small case also against
    the CPU's plain version. Counts the launches of each call. Raises on a
    difference; returns the largest absolute difference (0.0)."""
    crops = crop_batch(dev)
    small = torch.randint(0, 5, (2, 37, 53), generator=gen)
    cases = [("8 synthetic 768² crops, uint8", crops),
             ("the same, 5 % salt", salted(crops)),
             ("(2, 37, 53) int64, 5 labels", small.to(dev)),
             ("(3, 96, 96) int32, blocky", torch.randint(0, 4, (3, 12, 12), generator=gen)
              .repeat_interleave(8, 1).repeat_interleave(8, 2).to(torch.int32).to(dev)),
             ("(1, 1, 1)", torch.zeros((1, 1, 1), dtype=torch.uint8, device=dev)),
             ("(4, 3, 200) uint8, stripes", (torch.arange(200, device=dev) // 2 % 3)
              .to(torch.uint8).expand(4, 3, 200).contiguous())]
    fn = edt.nearest_diff_label_distance
    worst = 0.0
    for name, labels in cases:
        before = fn.launches
        got = fn(labels)
        want = edt.nearest_diff_label_distance_reference(labels)
        torch.cuda.synchronize()
        launches = fn.launches - before
        expect = len(edt.jfa_launches(*labels.shape[-2:]))
        err = (got - want).abs().max().item()
        same = _bitwise(got, want)
        log(f"  JF {name}: {launches} launches (expected {expect}), bitwise equal to the "
            f"plain version: {same} (max abs diff {err:.3e}), max distance {want.max().item():.3f}")
        if launches != expect or not same:
            raise RuntimeError(f"jump flood disagrees with its plain version on {name}")
        worst = max(worst, err)
    cpu = edt.nearest_diff_label_distance_reference(small)
    if not _bitwise(fn(small.to(dev)).cpu(), cpu):
        raise RuntimeError("jump flood on the card disagrees with the CPU's plain version")
    log("  JF (2, 37, 53) on the card bitwise equal to the CPU's plain version: True")
    return worst


def device_ops(dev, log=print) -> int:
    """Kernel nodes of one 768² call's CUDA-graph capture: one per (round,
    direction) update and nothing else. Returns their number."""
    labels = crop_batch(dev)
    edt.nearest_diff_label_distance(labels)          # built and loaded before capture
    torch.cuda.synchronize()
    ops = captured_ops(lambda: edt.nearest_diff_label_distance(labels))
    kernels = [name for kind, name in ops if kind == CU_GRAPH_NODE_TYPE_KERNEL]
    expect = len(edt.jfa_launches(CROP, CROP))
    log(f"  JF one {BATCH} x {CROP}² call: {len(ops)} device operations, {len(kernels)} "
        f"kernel nodes, all jfa_step: {all('jfa_step' in k for k in kernels)} "
        f"(expected {expect})")
    if len(ops) != expect or len(kernels) != expect or not all("jfa_step" in k for k in kernels):
        raise RuntimeError(f"a {CROP}² jump-flood call must be {expect} jfa_step kernels")
    return len(kernels)


def bound(labels: torch.Tensor):
    """(bound ms, 'bytes' or 'operations', bytes, flops) of one call: the
    labels read once and the float32 distances written once over the
    memory rate, against ``FLOPS_PER_CANDIDATE`` for every in-frame
    neighbour of every update over the float32 rate."""
    h, w = labels.shape[-2:]
    b = labels.numel() // (h * w)
    nbytes = labels.numel() * (labels.element_size() + 4)
    pairs = sum(max(h - abs(dy), 0) * max(w - abs(dx), 0) for dy, dx in edt.jfa_launches(h, w))
    flops = FLOPS_PER_CANDIDATE * b * pairs
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations",
            nbytes, flops)


def time_jfa(gen, dev, log=print) -> dict:
    """Kernel (the wrapper's 88 launches) and plain version at the crops, in
    turns (plain, kernel, kernel, plain), beside the bound."""
    labels = crop_batch(dev)
    ms = {"kernel": [], "plain": []}
    calls = {"kernel": lambda: edt.nearest_diff_label_distance(labels),
             "plain": lambda: edt.nearest_diff_label_distance_reference(labels)}
    for k in ("plain", "kernel", "kernel", "plain"):
        ms[k].append(cuda_ms(calls[k], iters=5 if k == "plain" else 20))
    t = {k: sum(v) / len(v) for k, v in ms.items()}
    bound_ms, bound_by, nbytes, flops = bound(labels)
    state_bytes = 50 * labels.numel() * len(edt.jfa_launches(CROP, CROP))
    log(f"  JF {BATCH} x {CROP}² (uint8 labels): kernel {t['kernel']:.4f} ms "
        f"(runs {', '.join(f'{x:.4f}' for x in ms['kernel'])}; "
        f"{t['kernel'] / bound_ms:.1f}x the bound; its state traffic, ~50 B a pixel an update, "
        f"{state_bytes / 1e9:.2f} GB, would take {1e3 * state_bytes / PEAK_BYTES_PER_S:.3f} ms "
        f"at the memory rate); plain {t['plain']:.4f} ms (runs "
        f"{', '.join(f'{x:.4f}' for x in ms['plain'])}); bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return {"ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_jfa: no CUDA device; this tool runs on the card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    for line in _build.build(["jfa"]).get("jfa", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(f"  ptxas[jfa]: {line.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    log = lambda *a: print(*a, flush=True)  # noqa: E731
    err = check_kernel(gen, dev, log)
    device_ops(dev, log)
    t = time_jfa(gen, dev, log)
    print(json.dumps({"card": card, "max_abs_err": err, **t}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
