"""The contrastive kernels alone on the card: the row statistics (K3) and
pixel contrast's positive sweep (K4) against their plain versions, then
their times beside the first ports they replace.

    python3 -m doubly_contrastive_semseg_tpu_torch.tools.profile_contrastive

Builds only ``csrc/row_stats.cu``, ``csrc/pos_sweep.cu`` and
``csrc/contrastive.cu`` and prints ptxas's register and spill report.
Holds ``contrastive_row_stats`` to ``contrastive_row_stats_reference`` in
f32 at ``CHECK_SHAPES``, both modes, with ``stat_errors``' tolerances,
checks that two calls give bitwise equal outputs and that a call makes
``LAUNCHES`` launches. Holds ``pixel_contrast_pos_sweep`` to
``pixel_contrast_sweep_reference`` and to ``pos_sweep_segmented`` at
``POS_CASES`` (q within 1e-5 × max|q_ref|, c exact and equal to the
segment size − 1 on valid rows) and its layout kernel to a stable
``torch.sort`` (bitwise); checks one layout and one sweep call a call, no
device operation but K4's three kernels (its capture in a CUDA graph,
``profile_stem.captured_ops``), bitwise repeat and no host sync
(``torch.cuda.set_sync_debug_mode("error")``).
Then times, at N = 8192 and 16384, D = 128, ``neg_mode``, 19 labels, in
turns: the two-pass K3, the three-sweep kernel it replaced and the plain
version; and K4 as the whole wrapper, the sweep and reduce alone, the
layout kernel alone, the layout's plain version, ``torch.sort`` alone, the
dense sweep it replaced and the plain version, with the bounds and the
executed products; K4 again on the dense step's anchor grid (N = 8208,
labels i mod 19). Last, times the sweep kernel as built and with pieces
of its source replaced (``SWEEP_VARIANTS``: no epilogue, one product, no
products, no staging, the prologue only), compiled into a
temporary directory. ``wide_d`` holds and times both at the
DeepLab family's widths (D = 320 to 2048) on the anchor grid.
``chip_smoke.py`` phase 6 calls ``check_row_stats``, ``check_pos_sweep``,
``time_routes`` and ``time_anchor_grid``, and phase 18b ``wide_d``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..ops import _build, contrastive
from .profile_stem import CU_GRAPH_NODE_TYPE_KERNEL, captured_ops, cuda_ms
from .stem_variants import _compile

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_TENSOR_FLOPS = 494.7e12

D_FEAT = 128
CHECK_SHAPES = [(8192, D_FEAT), (8200, D_FEAT), (300, D_FEAT),   # chip_smoke's gates
                (300, 37), (1000, 256), (129, 8), (1, D_FEAT)]   # D % 8 != 0, D max, N = 1
TIME_NS = (8192, 16384)
LAUNCHES = 4   # pass A, its reduce, pass B, its reduce
ANCHOR_N = 216 * 19 * 2   # the dense-contrast step's rows: (image, class) anchors, two views
DEEPLAB_DS = (320, 480, 720, 2048)   # MobileNetV2, HRNetV2-W32, -W48, ResNet and Xception
# K4's gates: (N, D, labels); chip_smoke's N = 8192, 8200, 300, the anchor
# grid and one label, then D % 8 != 0, N = 1, no valid row, negative labels
# at D max, a label with one valid row
POS_CASES = [(8192, D_FEAT, "random"), (8200, D_FEAT, "random"), (300, D_FEAT, "random"),
             (ANCHOR_N, D_FEAT, "anchor grid"), (8192, D_FEAT, "one label"),
             (300, 37, "random"), (1, D_FEAT, "random"), (300, D_FEAT, "all invalid"),
             (1000, 256, "negative"), (300, 64, "lone row"), (300, D_FEAT, "one label")]
SEGMENTED_MAX_N = 1000   # the largest one-label case the plain emulation is run on
OWN_KERNELS = ["layout_kernel", "pos_sweep_kernel", "reduce_kernel"]   # K4's launches a call


def contrastive_inputs(gen, dev, n, n_labels, d=D_FEAT):
    """(z, labels, valid) with about 10 % of the rows invalid."""
    z = (torch.randn(n, d, generator=gen) / d ** 0.5).to(dev)
    labels = torch.randint(0, n_labels, (n,), generator=gen).to(dev)
    valid = (torch.rand(n, generator=gen) >= 0.1).to(dev)
    return z, labels, valid


def stat_errors(got, ref, valid, scale=1.0):
    """Max abs error of each of (p, c, s, m, n) and whether each is within
    its tolerance: 1e-5·scale·max|ref| for p, m (valid rows; invalid rows
    must be -1e30 exactly), n; 1e-5·scale relative for s; exact for c."""
    errs, ok = {}, True
    for name, g, r in zip("pcsmn", got, ref):
        if name == "m":
            ok &= bool(torch.equal(g[~valid], r[~valid]))
            g, r = g[valid], r[valid]
        if g.numel() == 0:
            errs[name] = 0.0
            continue
        err = (g - r).abs()
        errs[name] = err.max().item()
        if name == "c":
            ok &= errs[name] == 0.0
        elif name == "s":
            ok &= bool((err <= 1e-5 * scale * r.abs() + 1e-30).all())
        else:
            ok &= errs[name] <= 1e-5 * scale * r.abs().max().item()
    return errs, ok


def check_row_stats(gen, dev, log=print) -> float:
    """K3 against its plain version at ``CHECK_SHAPES``, both modes; bitwise
    repeat; launches a call. Raises on a disagreement. Returns the largest
    error at N = 8192, D = 128."""
    headline_err = 0.0
    for n, d in CHECK_SHAPES:
        for neg_mode, n_labels in ((False, 4), (True, 19)):
            z, labels, valid = contrastive_inputs(gen, dev, n, n_labels, d)
            ref = contrastive.contrastive_row_stats_reference(z, labels, valid,
                                                              neg_mode=neg_mode)
            before = contrastive.contrastive_row_stats.launches
            got = contrastive.contrastive_row_stats(z, labels, valid, neg_mode=neg_mode)
            launches = contrastive.contrastive_row_stats.launches - before
            again = contrastive.contrastive_row_stats(z, labels, valid, neg_mode=neg_mode)
            torch.cuda.synchronize()
            errs, ok = stat_errors(got, ref, valid)
            line = ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            log(f"  row stats N={n} D={d} neg_mode={neg_mode}: max abs err {line}")
            if not ok:
                raise RuntimeError(f"contrastive_row_stats disagrees at N={n} D={d} "
                                   f"neg_mode={neg_mode}")
            if launches != LAUNCHES:
                raise RuntimeError(f"contrastive_row_stats made {launches} launches, "
                                   f"not {LAUNCHES}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise RuntimeError(f"contrastive_row_stats is not bitwise repeatable at N={n}")
            if (n, d) == (8192, D_FEAT):
                headline_err = max(headline_err, max(errs.values()))
    log(f"  row stats: {LAUNCHES} launches a call; two calls bitwise equal at every shape")
    return headline_err


def pos_sweep_inputs(gen, dev, n, d, kind):
    """(z, labels, valid, neg_mode) of a K4 case. "anchor grid": labels i
    mod 19 and each anchor's validity on both views, as the dense step
    gives them; "one label": every row valid with one label, where no
    negative exists and neg_mode's s is 0, so q would be 0 up to rounding:
    the sweep then takes supcon's s (``neg_mode`` False) to give q a scale."""
    z, labels, valid = contrastive_inputs(gen, dev, n, 19, d)
    if kind == "anchor grid":
        labels = torch.arange(n, device=dev) % 19
        valid = valid[: n // 2].repeat(2)
    elif kind == "one label":
        labels = torch.full_like(labels, 7)
        valid = torch.ones_like(valid)
    elif kind == "all invalid":
        valid = torch.zeros_like(valid)
    elif kind == "negative":
        labels = labels - 9
    elif kind == "lone row":
        labels = torch.where(labels == 18, 17, labels)
        labels[5], valid[5] = 18, True
    return z, labels.to(torch.int32), valid, kind != "one label"


def expected_counts(labels, valid):
    """c of each row: its label segment's size − 1 on valid rows, else 0."""
    keys, perm = contrastive.pos_sweep_layout_reference(labels, valid)
    _, counts = torch.unique_consecutive(keys, return_counts=True)
    seg = counts.repeat_interleave(counts)
    c = torch.empty(keys.shape[0], dtype=torch.float32, device=keys.device)
    c[perm] = torch.where(keys < contrastive.INVALID_KEY, seg - 1, 0).float()
    return c


def _q_err(got, want, scale=1.0):
    """(max abs error, tolerance 1e-5·scale·max|want|) of q."""
    return (got - want).abs().max().item(), 1e-5 * scale * want.abs().max().item()


def check_pos_sweep(gen, dev, log=print) -> dict:
    """K4 at ``POS_CASES``: the layout kernel's keys and perm bitwise equal
    to ``pos_sweep_layout_reference``'s (a stable ``torch.sort``); q and c
    against ``pixel_contrast_sweep_reference`` and ``pos_sweep_segmented``
    (but at one label past ``SEGMENTED_MAX_N`` rows, whose full square the
    emulation would walk in thousands of small ops); one layout and one
    sweep launch a call, bitwise repeat, no
    host sync, and no device operation but its own three kernels (layout,
    sweep, reduce); raises on a failure. Returns {"max_abs_err": q's error
    at N = 8192 random, "layout_max_abs_err": the layout's largest key or index
    difference there, "device_ops": the kernel names of the device
    operations of one call, from its capture in a CUDA graph}."""
    out = {"max_abs_err": 0.0}
    layout_fn, sweep_fn = contrastive.pos_sweep_layout, contrastive.pixel_contrast_pos_sweep
    for n, d, kind in POS_CASES:
        z, labels, valid, neg_mode = pos_sweep_inputs(gen, dev, n, d, kind)
        _, _, s, m, nrm = contrastive.contrastive_row_stats(z, labels, valid, neg_mode=neg_mode)
        before = (layout_fn.launches, sweep_fn.launches)
        q, c = sweep_fn(z, labels, valid, m, nrm, s)
        launches = (layout_fn.launches - before[0], sweep_fn.launches - before[1])
        q2, c2 = sweep_fn(z, labels, valid, m, nrm, s)
        q_ref, c_ref = contrastive.pixel_contrast_sweep_reference(z, labels, valid, m, nrm, s)
        layout = layout_fn(labels, valid)
        layout_ref = contrastive.pos_sweep_layout_reference(labels, valid)
        torch.cuda.synchronize()
        err, tol = _q_err(q, q_ref)
        same_layout = all(torch.equal(a, b) for a, b in zip(layout, layout_ref))
        ok = (same_layout and err <= tol and torch.equal(c, c_ref)
              and torch.equal(c, expected_counts(labels, valid)))
        line = (f"  positive sweep N={n} D={d} {kind}: layout equal to the stable sort's "
                f"{same_layout}; q max abs err {err:.2e} (tolerance {tol:.2e}), c exact "
                f"{torch.equal(c, c_ref)}")
        if kind != "one label" or n <= SEGMENTED_MAX_N:
            q_seg, c_seg = contrastive.pos_sweep_segmented(z, labels, valid, m, nrm, s)
            seg_err, _ = _q_err(q, q_seg)
            ok &= seg_err <= tol and torch.equal(c, c_seg)
            line += f"; vs pos_sweep_segmented {seg_err:.2e}, c exact {torch.equal(c, c_seg)}"
        log(line)
        if not ok:
            raise RuntimeError(f"pixel_contrast_pos_sweep disagrees at N={n} D={d} {kind}")
        if launches != (1, 1):
            raise RuntimeError(f"pixel_contrast_pos_sweep made {launches} (layout, sweep) "
                               "launches, not (1, 1)")
        if not (torch.equal(q, q2) and torch.equal(c, c2)):
            raise RuntimeError(f"pixel_contrast_pos_sweep is not bitwise repeatable at N={n}")
        if (n, kind) == (8192, "random"):
            out["max_abs_err"] = err
            out["layout_max_abs_err"] = max((a - b).abs().max().item()
                                            for a, b in zip(layout, layout_ref))
            torch.cuda.set_sync_debug_mode("error")
            try:
                contrastive.pixel_contrast_pos_sweep(z, labels, valid, m, nrm, s)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            ops = captured_ops(lambda: contrastive.pixel_contrast_pos_sweep(
                z, labels, valid, m, nrm, s))
            out["device_ops"] = [name for _, name in ops]
            kernels = sorted(next((k for k in OWN_KERNELS if f"{len(k)}{k}" in (name or "")),
                                  name or f"node type {kind}") for kind, name in ops)
            if (any(kind != CU_GRAPH_NODE_TYPE_KERNEL for kind, _ in ops)
                    or kernels != sorted(OWN_KERNELS)):
                raise RuntimeError(f"a positive-sweep call ran other device operations: {ops}")
            log(f"  positive sweep: no host sync in a call (sync debug mode \"error\"); "
                f"{len(ops)} device operations a call, all kernels: " + "; ".join(kernels))
    log("  positive sweep: 1 layout and 1 sweep launch a call; two calls bitwise equal at "
        "every case")
    return out


def _bound(flops, nbytes):
    """(bound ms, 'operations' or 'bytes'): an f32-accurate product runs on
    CUDA cores or as three TF32 tensor-core products, whichever is less."""
    ops_s = min(flops / PEAK_F32_FLOPS, 3 * flops / PEAK_TF32_TENSOR_FLOPS)
    bytes_s = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s > bytes_s else "bytes"


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def pos_sweep_gflop(labels, valid, d):
    """(needed, executed) GFLOP of K4: the positive pairs' products, 2·Σc·D
    f32 flops; and the tile products the kernel forms, each block's 32 rows
    against its column range in whole tiles of 64, D padded to 8, as three
    TF32 products."""
    keys, _ = contrastive.pos_sweep_layout_reference(labels, valid)
    begin, end, n_valid = contrastive.pos_sweep_column_ranges(keys)
    cols = ((end - begin + contrastive.POS_COLS - 1) // contrastive.POS_COLS
            * contrastive.POS_COLS)[n_valid > 0]
    dpad = -(-d // 8) * 8
    executed = 3 * 2.0 * contrastive.POS_ROWS * dpad * cols.sum().item()
    return 2.0 * d * expected_counts(labels, valid).sum().item() / 1e9, executed / 1e9


def time_pos_sweep(z, labels, valid, m, nrm, s, log=print, what="") -> dict:
    """K4's times on one input, in turns: the wrapper (layout, sweep and
    reduce), the sweep and reduce alone on a layout made beforehand, the
    layout kernel alone,
    the layout's plain version (keys, then a stable ``torch.sort``), the
    library's stable sort alone on the keys, the dense sweep it replaced
    (``_dense_pos_sweep``) and the plain version. Returns ``k4_ms`` (the
    wrapper), ``k4_kernel_ms``, ``k4_dense_ms``, ``k4_plain_ms``,
    ``k4_bound_ms``, ``k4_bound_by``, ``k4_needed_gflop``,
    ``k4_executed_gflop``, and the layout's ``layout_ms``,
    ``layout_plain_ms``, ``layout_library_ms``, ``layout_bound_ms``,
    ``layout_bound_by``."""
    n, d = z.shape
    zc = contrastive._checked_z(z, labels, valid)
    stats = contrastive._pos_stats(zc, m, nrm, s)
    keys, perm = contrastive.pos_sweep_layout(labels, valid)
    int_keys = torch.where(valid.bool(), labels.long(), contrastive.INVALID_KEY)
    q, c = contrastive.pixel_contrast_pos_sweep(z, labels, valid, m, nrm, s)
    calls = {
        "wrapper": lambda: contrastive.pixel_contrast_pos_sweep(z, labels, valid, m, nrm, s),
        "kernel": lambda: contrastive._pos_sweep_launch(zc, keys, perm, stats, 0.07),
        "layout": lambda: contrastive.pos_sweep_layout(labels, valid),
        "layout_plain": lambda: contrastive.pos_sweep_layout_reference(labels, valid),
        "sort": lambda: torch.sort(int_keys, stable=True),
        "dense": lambda: contrastive._dense_pos_sweep(z, labels, valid, m, nrm, s),
        "plain": lambda: contrastive.pixel_contrast_sweep_reference(z, labels, valid, m, nrm, s)}
    order = ("plain", "dense", "wrapper", "kernel", "layout", "layout_plain", "sort")
    ms = {k: [] for k in calls}
    for k in order + order[::-1]:
        ms[k].append(cuda_ms(calls[k]))
    t = {k: sum(v) / len(v) for k, v in ms.items()}
    needed, executed = pos_sweep_gflop(labels, valid, d)
    bound, by = _bound(needed * 1e9, _nbytes(z, labels, valid, m, nrm, s, q, c))
    layout_bound, layout_by = _bound(0.0, _nbytes(labels, valid, keys, perm))
    log(f"  N={n}{what}: positive sweep (K4) wrapper {t['wrapper']:.4f} ms = layout "
        f"{t['layout']:.4f} + sweep and reduce {t['kernel']:.4f} ({executed:.3f} GFLOP "
        f"executed on TF32 "
        f"tensor cores, {executed / t['kernel']:.1f} TFLOP/s; {t['wrapper'] / bound:.1f}x the "
        f"bound); dense sweep {t['dense']:.4f} ms ({t['dense'] / t['wrapper']:.1f}x the "
        f"wrapper); plain {t['plain']:.4f} ms; bound {bound:.4f} ms ({by}: {needed:.3f} GFLOP "
        f"f32 of positive pairs)")
    log(f"  N={n}{what}: layout kernel {t['layout']:.4f} ms; its plain version (keys, stable "
        f"torch.sort) {t['layout_plain']:.4f} ms, torch.sort alone {t['sort']:.4f} ms; bound "
        f"{layout_bound:.5f} ms ({layout_by})")
    return {"k4_ms": t["wrapper"], "k4_kernel_ms": t["kernel"], "k4_dense_ms": t["dense"],
            "k4_plain_ms": t["plain"], "k4_bound_ms": bound, "k4_bound_by": by,
            "k4_needed_gflop": needed, "k4_executed_gflop": executed,
            "layout_ms": t["layout"], "layout_plain_ms": t["layout_plain"],
            "layout_library_ms": t["sort"], "layout_bound_ms": layout_bound,
            "layout_bound_by": layout_by}


def time_routes(gen, dev, log=print) -> dict:
    """Times at ``TIME_NS``, D = 128, ``neg_mode``, 19 labels. Returns
    {N: {...}} with K3's ``ms`` (two-pass), ``three_sweep_ms``,
    ``plain_ms``, ``bound_ms``, ``bound_by``, ``executed_gflop``, and K4's
    (``time_pos_sweep``). Bounds are the functions': L is symmetric, so the
    row stats need N(N+1)/2 dot products and K4 one a positive pair, D
    multiply-adds (2·D flops) each; bytes are the inputs and outputs once."""
    out = {}
    for n in TIME_NS:
        z, labels, valid = contrastive_inputs(gen, dev, n, 19)
        stats = contrastive.contrastive_row_stats(z, labels, valid, neg_mode=True)
        _, _, s, m, nrm = stats
        k3_flops = float(n) * (n + 1) * D_FEAT
        calls = {
            "new": lambda: contrastive.contrastive_row_stats(z, labels, valid, neg_mode=True),
            "three": lambda: contrastive._three_sweep_row_stats(z, labels, valid,
                                                                neg_mode=True),
            "plain": lambda: contrastive.contrastive_row_stats_reference(z, labels, valid,
                                                                         neg_mode=True)}
        ms = {k: [] for k in calls}
        for k in ("plain", "three", "new", "new", "three", "plain"):
            ms[k].append(cuda_ms(calls[k]))
        t = {k: sum(v) / len(v) for k, v in ms.items()}
        nt = -(-n // contrastive.ROW_TILE)
        dpad = -(-D_FEAT // 8) * 8
        tile_flops = 2.0 * contrastive.ROW_TILE ** 2 * dpad * 3   # three TF32 products
        executed = {"new": 2 * nt * (nt + 1) // 2 * tile_flops,   # two passes
                    "three": 3 * 2.0 * n * n * D_FEAT}
        bound, by = _bound(k3_flops, _nbytes(z, labels, valid, *stats))
        log(f"  N={n}, D={D_FEAT}, neg_mode: two passes {t['new']:.4f} ms "
            f"({executed['new'] / 1e9:.1f} GFLOP executed on TF32 tensor cores, "
            f"{executed['new'] / t['new'] / 1e9:.1f} TFLOP/s; {t['new'] / bound:.2f}x the bound); "
            f"three sweeps {t['three']:.4f} ms ({executed['three'] / 1e9:.1f} GFLOP f32, "
            f"{executed['three'] / t['three'] / 1e9:.1f} TFLOP/s; {t['three'] / t['new']:.2f}x "
            f"the two-pass time); plain {t['plain']:.4f} ms; bound {bound:.4f} ms "
            f"({by}: {k3_flops / 1e9:.2f} GFLOP f32 work)")
        out[n] = {"ms": t["new"], "three_sweep_ms": t["three"],
                  "plain_ms": t["plain"], "bound_ms": bound, "bound_by": by,
                  "executed_gflop": executed["new"] / 1e9,
                  **time_pos_sweep(z, labels, valid, m, nrm, s, log)}
        del z, labels, valid, stats
    return out


def time_anchor_grid(gen, dev, log=print) -> dict:
    """K4's times (``time_pos_sweep``) on the dense step's anchor grid: N =
    ``ANCHOR_N``, labels i mod 19, each anchor's validity on both views."""
    z, labels, valid, _ = pos_sweep_inputs(gen, dev, ANCHOR_N, D_FEAT, "anchor grid")
    _, _, s, m, nrm = contrastive.contrastive_row_stats(z, labels, valid, neg_mode=True)
    return time_pos_sweep(z, labels, valid, m, nrm, s, log, " anchor grid")


def wide_d(gen, dev, log=print, n=ANCHOR_N, ds=DEEPLAB_DS) -> dict:
    """K3 and K4 at the DeepLab family's feature widths ``ds`` on the dense
    step's anchor grid (N = ``ANCHOR_N``, ``neg_mode``): each held to its
    plain version (``stat_errors``' and ``_q_err``'s tolerances, c exact),
    K3's ``LAUNCHES`` and K4's one layout and one sweep a call, then timed
    in turns beside the plain versions, with the bounds (K3 N(N+1)·D f32
    flops, K4 2·Σc·D). The tolerances, set at D = 128, grow by √(D/128):
    a logit sums D products in f32, in another order in the kernel (its
    TF32 split, tile by tile) than in the plain version, and the rounding
    of such sums grows as √D. Returns {D:
    {"k3_ms", "k3_plain_ms", "k3_bound_ms", "k3_bound_by", "k3_err", "k4_ms",
    "k4_plain_ms", "k4_bound_ms", "k4_bound_by", "k4_err"}}."""
    out = {}
    layout_fn, sweep_fn = contrastive.pos_sweep_layout, contrastive.pixel_contrast_pos_sweep
    for d in ds:
        z, labels, valid, _ = pos_sweep_inputs(gen, dev, n, d, "anchor grid")
        before = (contrastive.contrastive_row_stats.launches, layout_fn.launches,
                  sweep_fn.launches)
        stats = contrastive.contrastive_row_stats(z, labels, valid, neg_mode=True)
        _, _, s, m, nrm = stats
        q, c = sweep_fn(z, labels, valid, m, nrm, s)
        launches = (contrastive.contrastive_row_stats.launches - before[0],
                    layout_fn.launches - before[1], sweep_fn.launches - before[2])
        ref = contrastive.contrastive_row_stats_reference(z, labels, valid, neg_mode=True)
        q_ref, c_ref = contrastive.pixel_contrast_sweep_reference(z, labels, valid, m, nrm, s)
        torch.cuda.synchronize()
        scale = (d / D_FEAT) ** 0.5
        errs, ok3 = stat_errors(stats, ref, valid, scale)
        q_err, q_tol = _q_err(q, q_ref, scale)
        log(f"  D={d}, N={n} anchor grid: row stats max abs err "
            + ", ".join(f"{k} {v:.2e} (of max {(r[valid] if k == 'm' else r).abs().max():.3g})"
                        for (k, v), r in zip(errs.items(), ref))
            + f", within {1e-5 * scale:.2e} of the max (s: of each) {ok3}; positive sweep q "
            f"{q_err:.2e} (tolerance {q_tol:.2e}), c exact "
            f"{torch.equal(c, c_ref)}; launches (K3, K4 layout, K4 sweep) {launches}")
        if not (ok3 and q_err <= q_tol and torch.equal(c, c_ref)):
            raise RuntimeError(f"K3 or K4 disagrees with its plain version at D={d}")
        if launches != (LAUNCHES, 1, 1):
            raise RuntimeError(f"K3 and K4 made {launches} launches at D={d}")
        calls = {
            "k3": lambda: contrastive.contrastive_row_stats(z, labels, valid, neg_mode=True),
            "k3_plain": lambda: contrastive.contrastive_row_stats_reference(z, labels, valid,
                                                                            neg_mode=True),
            "k4": lambda: sweep_fn(z, labels, valid, m, nrm, s),
            "k4_plain": lambda: contrastive.pixel_contrast_sweep_reference(z, labels, valid,
                                                                           m, nrm, s)}
        ms = {k: [] for k in calls}
        for k in ("k3_plain", "k3", "k4_plain", "k4", "k4", "k4_plain", "k3", "k3_plain"):
            ms[k].append(cuda_ms(calls[k], iters=5))
        t = {k: sum(v) / len(v) for k, v in ms.items()}
        k3_bound, k3_by = _bound(float(n) * (n + 1) * d, _nbytes(z, labels, valid, *stats))
        needed, _ = pos_sweep_gflop(labels, valid, d)
        k4_bound, k4_by = _bound(needed * 1e9, _nbytes(z, labels, valid, m, nrm, s, q, c))
        log(f"  D={d}: K3 {t['k3']:.4f} ms (plain {t['k3_plain']:.4f}; bound {k3_bound:.4f} "
            f"ms, {k3_by}; {t['k3'] / k3_bound:.1f}x), K4 {t['k4']:.4f} ms (plain "
            f"{t['k4_plain']:.4f}; bound {k4_bound:.5f} ms, {k4_by}; "
            f"{t['k4'] / k4_bound:.1f}x)")
        out[d] = {"k3_ms": t["k3"], "k3_plain_ms": t["k3_plain"], "k3_bound_ms": k3_bound,
                  "k3_bound_by": k3_by, "k3_err": max(errs.values()), "k4_ms": t["k4"],
                  "k4_plain_ms": t["k4_plain"], "k4_bound_ms": k4_bound, "k4_bound_by": k4_by,
                  "k4_err": q_err}
        del z, labels, valid, stats, ref
    return out


_EPILOGUE = "    if (ch == nchunks - 1) {  // the tile's positives"
# the sweep kernel of csrc/pos_sweep.cu with one piece of its text replaced;
# each but "as built" drops work and gives wrong output
SWEEP_VARIANTS = {
    "as built": [],
    "no epilogue": [(_EPILOGUE, "    if (ch == nchunks - 1) q[0] += acc[0][0] + acc[3][3];\n"
                                "    if (false) {")],
    "one product (hi.hi)": [("          mma_tf32(acc[ni], al, bh[ni]);\n"
                             "          mma_tf32(acc[ni], ah, bl[ni]);\n", "")],
    "no products": [("      if (ks < ksteps) {", "      if (false) {")],
    "no staging": [("    if (it + 1 < items) {", "    if (false) {"),
                   ("  if (items > 0) {", "  if (false) {")],
    "prologue only": [("  const int items = my_tiles * nchunks;",
                       "  const int items = 0 * my_tiles * nchunks;")],
}


def sweep_ablations(gen, dev, log=print) -> dict:
    """The sweep kernel alone, as built and in ``SWEEP_VARIANTS`` (compiled
    into a temporary directory), on layouts made beforehand at N = 8192 and
    16384 (19 labels) and the anchor grid, D = 128. Returns {variant: {case:
    ms}}."""
    cases = {}
    for n, kind in ((8192, "random"), (16384, "random"), (ANCHOR_N, "anchor grid")):
        z, labels, valid, _ = pos_sweep_inputs(gen, dev, n, D_FEAT, kind)
        _, _, s, m, nrm = contrastive.contrastive_row_stats(z, labels, valid, neg_mode=True)
        keys, perm = contrastive.pos_sweep_layout(labels, valid)
        ref = contrastive.pixel_contrast_sweep_reference(z, labels, valid, m, nrm, s)
        cases[f"N={n} {kind}"] = (z, keys, perm, (m, nrm, s), ref)
    source = (_build.CSRC / "pos_sweep.cu").read_text()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, edits) in enumerate(SWEEP_VARIANTS.items()):
            src = source
            for old, new in edits:
                if old not in src:
                    raise RuntimeError(f"variant {name!r}: {old!r} is not in the source")
                src = src.replace(old, new)
            fn = _compile(src, f"pos_sweep_v{i}", Path(tmp)).dcss_pos_sweep
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float]
                           + [ctypes.c_void_p] * 4)
            out[name] = {}
            for case, (z, keys, perm, stats, (q_ref, c_ref)) in cases.items():
                q, c = torch.empty_like(q_ref), torch.empty_like(c_ref)
                scratch = torch.empty(2 * contrastive.POS_SPLIT * z.shape[0], device=z.device)

                def run():
                    status = fn(z.data_ptr(), perm.data_ptr(), keys.data_ptr(),
                                *(t.data_ptr() for t in stats), z.shape[0], z.shape[1],
                                1.0 / 0.07, scratch.data_ptr(), q.data_ptr(), c.data_ptr(),
                                stream)
                    if status != 0:
                        raise RuntimeError(f"variant {name!r}: CUDA error {status}")

                run()
                torch.cuda.synchronize()
                if name == "as built" and not (_q_err(q, q_ref)[0] <= _q_err(q, q_ref)[1]
                                               and torch.equal(c, c_ref)):
                    raise RuntimeError(f"the sweep kernel disagrees at {case}")
                out[name][case] = cuda_ms(run, iters=20)
            log(f"  sweep {name:22s} " + "; ".join(f"{k}: {v:.4f} ms"
                                                  for k, v in out[name].items()))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_contrastive: no CUDA device; this tool runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    for name, text in _build.build(["row_stats", "pos_sweep", "contrastive"]).items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  ptxas[{name}]: {line.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    log = lambda *a: print(*a, flush=True)  # noqa: E731
    err = check_row_stats(gen, dev, log)
    k4 = check_pos_sweep(gen, dev, log)
    t = time_routes(gen, dev, log)
    grid = time_anchor_grid(gen, dev, log)
    wide = wide_d(gen, dev, log)
    ablations = sweep_ablations(gen, dev, log)
    print(json.dumps({"card": card, "max_abs_err": err, "k4": k4, "times": t,
                      "anchor_grid": grid, "wide_d": wide, "sweep_ablations": ablations}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
