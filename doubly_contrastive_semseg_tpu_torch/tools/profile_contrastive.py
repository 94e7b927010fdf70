"""The contrastive row statistics (K3) alone on the card: the two-pass
kernel against the plain version, then its times beside the three-sweep
kernel it replaces.

    python3 -m doubly_contrastive_semseg_tpu_torch.tools.profile_contrastive

Builds only ``csrc/row_stats.cu`` and ``csrc/contrastive.cu`` and prints
ptxas's register and spill report. Holds ``contrastive_row_stats`` to
``contrastive_row_stats_reference`` in f32 at ``CHECK_SHAPES``, both modes,
with ``stat_errors``' tolerances, checks that two calls give bitwise equal
outputs and that a call makes ``LAUNCHES`` launches. Then times, at N =
8192 and 16384, D = 128, ``neg_mode``, in turns: the two-pass kernel, the
three-sweep kernel it replaced, the plain version, and K4's sweep beside
its plain version, with the bounds.
``chip_smoke.py`` phase 6 calls ``check_row_stats`` and ``time_routes``.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from ..ops import _build, contrastive
from .profile_stem import cuda_ms

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_TENSOR_FLOPS = 494.7e12

D_FEAT = 128
CHECK_SHAPES = [(8192, D_FEAT), (8200, D_FEAT), (300, D_FEAT),   # chip_smoke's gates
                (300, 37), (1000, 256), (129, 8), (1, D_FEAT)]   # D % 8 != 0, D max, N = 1
TIME_NS = (8192, 16384)
LAUNCHES = 4   # pass A, its reduce, pass B, its reduce


def contrastive_inputs(gen, dev, n, n_labels, d=D_FEAT):
    """(z, labels, valid) with about 10 % of the rows invalid."""
    z = (torch.randn(n, d, generator=gen) / d ** 0.5).to(dev)
    labels = torch.randint(0, n_labels, (n,), generator=gen).to(dev)
    valid = (torch.rand(n, generator=gen) >= 0.1).to(dev)
    return z, labels, valid


def stat_errors(got, ref, valid):
    """Max abs error of each of (p, c, s, m, n) and whether each is within
    its tolerance: 1e-5·max|ref| for p, m (valid rows; invalid rows must be
    -1e30 exactly), n; 1e-5 relative for s; exact for c."""
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
            ok &= bool((err <= 1e-5 * r.abs() + 1e-30).all())
        else:
            ok &= errs[name] <= 1e-5 * r.abs().max().item()
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


def _bound(flops, nbytes):
    """(bound ms, 'operations' or 'bytes'): an f32-accurate product runs on
    CUDA cores or as three TF32 tensor-core products, whichever is less."""
    ops_s = min(flops / PEAK_F32_FLOPS, 3 * flops / PEAK_TF32_TENSOR_FLOPS)
    bytes_s = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s > bytes_s else "bytes"


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def time_routes(gen, dev, log=print) -> dict:
    """Times at ``TIME_NS``, D = 128, ``neg_mode``, 19 labels. Returns
    {N: {...}} with K3's ``ms`` (two-pass), ``three_sweep_ms``,
    ``plain_ms``, ``bound_ms``, ``bound_by``, ``executed_gflop``, and K4's
    ``k4_ms``, ``k4_plain_ms``, ``k4_bound_ms``, ``k4_bound_by``. Bounds are
    the functions': L is symmetric, so the row stats need N(N+1)/2 dot
    products and K4's sweep one a positive pair, D multiply-adds each; bytes
    are the inputs and outputs once."""
    out = {}
    for n in TIME_NS:
        z, labels, valid = contrastive_inputs(gen, dev, n, 19)
        stats = contrastive.contrastive_row_stats(z, labels, valid, neg_mode=True)
        _, _, s, m, nrm = stats
        q, c4 = contrastive.pixel_contrast_pos_sweep(z, labels, valid, m, nrm, s)
        per_label = torch.bincount(labels[valid]).double()
        pos_pairs = (per_label * (per_label - 1)).sum().item()   # ordered: sum of c_i
        k3_flops = float(n) * (n + 1) * D_FEAT
        k4_flops = pos_pairs * D_FEAT
        calls = {
            "new": lambda: contrastive.contrastive_row_stats(z, labels, valid, neg_mode=True),
            "three": lambda: contrastive._three_sweep_row_stats(z, labels, valid,
                                                                neg_mode=True),
            "plain": lambda: contrastive.contrastive_row_stats_reference(z, labels, valid,
                                                                         neg_mode=True),
            "k4": lambda: contrastive.pixel_contrast_pos_sweep(z, labels, valid, m, nrm, s),
            "k4_plain": lambda: contrastive.pixel_contrast_sweep_reference(
                z, labels, valid, m, nrm, s)}
        ms = {k: [] for k in calls}
        for k in ("plain", "three", "new", "k4", "k4_plain", "k4_plain", "k4", "new", "three",
                  "plain"):
            ms[k].append(cuda_ms(calls[k]))
        t = {k: sum(v) / len(v) for k, v in ms.items()}
        nt = -(-n // contrastive.ROW_TILE)
        dpad = -(-D_FEAT // 8) * 8
        tile_flops = 2.0 * contrastive.ROW_TILE ** 2 * dpad * 3   # three TF32 products
        executed = {"new": 2 * nt * (nt + 1) // 2 * tile_flops,   # two passes
                    "three": 3 * 2.0 * n * n * D_FEAT}
        bound, by = _bound(k3_flops, _nbytes(z, labels, valid, *stats))
        k4_bound, k4_by = _bound(k4_flops, _nbytes(z, labels, valid, m, nrm, s, q, c4))
        log(f"  N={n}, D={D_FEAT}, neg_mode: two passes {t['new']:.4f} ms "
            f"({executed['new'] / 1e9:.1f} GFLOP executed on TF32 tensor cores, "
            f"{executed['new'] / t['new'] / 1e9:.1f} TFLOP/s; {t['new'] / bound:.2f}x the bound); "
            f"three sweeps {t['three']:.4f} ms ({executed['three'] / 1e9:.1f} GFLOP f32, "
            f"{executed['three'] / t['three'] / 1e9:.1f} TFLOP/s; {t['three'] / t['new']:.2f}x "
            f"the two-pass time); plain {t['plain']:.4f} ms; bound {bound:.4f} ms "
            f"({by}: {k3_flops / 1e9:.2f} GFLOP f32 work)")
        log(f"  N={n}: positive sweep (K4) {t['k4']:.4f} ms, plain {t['k4_plain']:.4f} ms, "
            f"bound {k4_bound:.4f} ms ({k4_by}: {pos_pairs:.0f} positive pairs, "
            f"{k4_flops / 1e9:.3f} GFLOP)")
        out[n] = {"ms": t["new"], "three_sweep_ms": t["three"],
                  "plain_ms": t["plain"], "bound_ms": bound, "bound_by": by,
                  "executed_gflop": executed["new"] / 1e9,
                  "k4_ms": t["k4"], "k4_plain_ms": t["k4_plain"], "k4_bound_ms": k4_bound,
                  "k4_bound_by": k4_by}
        del z, labels, valid, stats, q, c4
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
    for name, text in _build.build(["row_stats", "contrastive"]).items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  ptxas[{name}]: {line.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    log = lambda *a: print(*a, flush=True)  # noqa: E731
    err = check_row_stats(gen, dev, log)
    t = time_routes(gen, dev, log)
    print(json.dumps({"card": card, "max_abs_err": err, "times": t}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
