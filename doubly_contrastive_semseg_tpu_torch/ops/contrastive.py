"""Row-L2-normalised contrastive losses that never hold the N×N logits.

Port of the JAX package's ``ops/contrastive_pallas.py``. The TPU kernel
``contrastive_row_stats`` (K3: ``_max_kernel``, ``_norm_kernel``,
``_sums_kernel``) becomes ``csrc/row_stats.cu``: two passes over the
symmetric half of the logits on split-TF32 tensor cores, each followed by a
reduce launch. The fourth sweep of ``pixel_contrast_loss_pallas`` (K4:
``_pc_kernel``) becomes ``csrc/pos_sweep.cu``: the rows sorted by label on
the card by its layout kernel (``pos_sweep_layout``; plain version a stable
``torch.sort``), each tile of 32 sorted rows visiting only the columns of
its labels, on the same split-TF32 products, split over four blocks whose
partials a reduce launch adds in a fixed order. The first port
of both, ``csrc/contrastive.cu`` (every logit recomputed on CUDA cores in
each sweep), stays reachable only through ``_three_sweep_row_stats`` and
``_dense_pos_sweep``, the yardsticks the tools time the two kernels
against. Each source's note names its bound (operations) and its design.
K3 and K4 take any D ≥ 1, as the Pallas kernels do (the DeepLab family's
pixel contrast runs at D = 320 to 2048); ``csrc/contrastive.cu`` keeps its
D ≤ 256. A tensor on the CPU takes the plain versions,
``contrastive_row_stats_reference`` and ``pixel_contrast_sweep_reference``
(dense N×N, same masks and clamps); a CUDA tensor launches the kernel or
raises. ``row_stats_tiled`` and ``pos_sweep_segmented`` repeat the new
kernels' arithmetic in plain PyTorch (split-TF32 products; pass A's
partials merged by the exact shift; the sorted rows' column ranges found by
the kernel's warp search, the positives summed in its order), so the CPU
tests hold the algorithms.

Over L = Z Zᵀ/τ with l̂_ij = (l_ij − m_i)/n_i on valid pairs, the sweeps give
the row max m, the row norm n = max(‖l − m‖₂, 1e-12) over valid columns,
s = Σ exp(l̂) over the denominator (valid j ≠ i for supcon; valid columns of
another label in ``neg_mode``), p = Σ_pos l̂, c = #pos, and pixel contrast's
q = Σ_pos [l̂ − log(exp(l̂) + s)].

The backward is not a kernel in the JAX package either: it is a chunked
``lax.scan`` in XLA (``_dz_via_chunks``). ``dz_via_chunks`` here is the same
computation, 256 rows at a time, with the slab products in ``torch.matmul``.
Gradient flows through the row norm (``F.normalize``); the max shift is
detached. ``supcon_loss_kernel`` and ``pixel_contrast_loss_kernel`` are the
differentiable public losses, the counterparts of ``supcon_loss_pallas`` and
``pixel_contrast_loss_pallas``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from . import _build

NEG_BIG = -1e30
DENSE_MAX_D = 256  # csrc/contrastive.cu's limit; K3 and K4 take any D
BWD_CHUNK = 256  # rows a backward slab holds; live memory ≈ a few × chunk·N f32

ROW_TILE = 128   # rows and columns of a tile of csrc/row_stats.cu
POS_ROWS = 32    # sorted rows a block of csrc/pos_sweep.cu takes
POS_COLS = 64    # columns of a tile there
POS_SPLIT = 4    # blocks a row tile, each every 4th column tile of its range
POS_LANES = 32   # probes a round of its warp search
INVALID_KEY = 1 << 40   # an invalid row's sort key: above every int32 label

_SWEEP_MAX, _SWEEP_NORM, _SWEEP_SUMS, _SWEEP_SUMS_NEG, _SWEEP_POS = range(5)
_PASS_A, _REDUCE_A, _PASS_B, _REDUCE_B = range(4)


def _pair_masks(labels_r, valid_r, rows, labels, valid):
    """(vpair, same, pos, not_self) for the rows ``rows`` against every
    column, as bool (R, N)."""
    cols = torch.arange(labels.shape[0], device=labels.device)
    vpair = valid_r[:, None] & valid[None, :]
    same = (labels_r[:, None] == labels[None, :]) & vpair
    not_self = rows[:, None] != cols[None, :]
    return vpair, same, same & not_self, not_self


def _lhat(logits, vpair, m, n):
    return torch.where(vpair, (logits - m[:, None]) / n[:, None], 0.0)


def contrastive_row_stats_reference(z, labels, valid, temperature: float = 0.07,
                                    neg_mode: bool = False):
    """Plain semantics of K3: (p, c, s, m, n), each (N,) float32, from the
    dense N×N logits."""
    z = z.float()
    labels, valid = labels.to(torch.int32), valid.bool()
    rows = torch.arange(z.shape[0], device=z.device)
    vpair, same, pos, not_self = _pair_masks(labels, valid, rows, labels, valid)
    logits = (z @ z.t()) * (1.0 / temperature)
    m = torch.where(vpair, logits, NEG_BIG).amax(dim=1)
    d = torch.where(vpair, logits - m[:, None], 0.0)
    n = torch.sqrt((d * d).sum(dim=1)).clamp_min(1e-12)
    lhat = _lhat(logits, vpair, m, n)
    den = (vpair & ~same) if neg_mode else (vpair & not_self)
    s = torch.where(den, torch.exp(lhat), 0.0).sum(dim=1)
    p = torch.where(pos, lhat, 0.0).sum(dim=1)
    return p, pos.sum(dim=1).float(), s, m, n


def pixel_contrast_sweep_reference(z, labels, valid, m, n, s,
                                   temperature: float = 0.07):
    """Plain semantics of K4's sweep: (q, c), each (N,) float32."""
    z = z.float()
    labels, valid = labels.to(torch.int32), valid.bool()
    rows = torch.arange(z.shape[0], device=z.device)
    vpair, _, pos, _ = _pair_masks(labels, valid, rows, labels, valid)
    lhat = _lhat((z @ z.t()) * (1.0 / temperature), vpair, m, n)
    log_prob = lhat - torch.log(torch.exp(lhat) + s[:, None])
    return torch.where(pos, log_prob, 0.0).sum(dim=1), pos.sum(dim=1).float()


def _kernel_inputs(z, labels, valid, max_d: Optional[int] = None):
    z = _checked_z(z, labels, valid, max_d)
    return (z, labels.detach().to(torch.int32).contiguous(),
            valid.detach().to(torch.int32).contiguous())


def _checked_z(z, labels, valid, max_d: Optional[int] = None):
    """z, contiguous and 16-byte aligned, after checking the shapes, device
    and dtype every kernel of this module takes (and D ≤ ``max_d`` where a
    kernel has a limit)."""
    if z.dim() != 2 or z.shape[0] < 1 or z.shape[1] < 1:
        raise ValueError(f"contrastive: z must be (N >= 1, D >= 1), got {tuple(z.shape)}")
    if max_d is not None and z.shape[1] > max_d:
        raise ValueError(f"contrastive: this kernel takes D <= {max_d}, got {z.shape[1]}")
    if labels.shape != (z.shape[0],) or valid.shape != (z.shape[0],):
        raise ValueError("contrastive: labels and valid must be (N,)")
    if z.device.type != "cuda":
        raise ValueError(f"contrastive: unsupported device {z.device}")
    if z.dtype != torch.float32:
        raise TypeError(f"contrastive: z must be float32, got {z.dtype}")
    for t in (labels, valid):
        if t.device != z.device:
            raise ValueError("contrastive: all tensors must be on z's device")
    z = z.detach().contiguous()
    if z.data_ptr() % 16:
        z = z.clone()
    return z


def _sweep(lib, sweep, z, labels, valid, temperature, stats, n_out, what):
    outs = [torch.empty(z.shape[0], dtype=torch.float32, device=z.device)
            for _ in range(n_out)]
    ptrs = [t.data_ptr() if t is not None else None for t in stats]
    optrs = [t.data_ptr() for t in outs] + [None] * (3 - n_out)
    with torch.cuda.device(z.device):
        status = lib.dcss_contrastive_sweep(
            sweep, z.data_ptr(), labels.data_ptr(), valid.data_ptr(),
            z.shape[0], z.shape[1], 1.0 / temperature, *ptrs, *optrs,
            torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(lib, status, what)
    return outs


def row_stats_scratch_numel(n: int) -> int:
    """f32 elements of ``csrc/row_stats.cu``'s scratch: 4 fields of each
    (column tile, row) partial."""
    return 4 * -(-n // ROW_TILE) * n


def contrastive_row_stats(z, labels, valid, temperature: float = 0.07,
                          neg_mode: bool = False):
    """K3: (p, c, s, m, n), each (N,) float32, for z (N, D) float32, int
    labels (N,) and bool validity (N,): pass A (m, n), its reduce, pass B
    (s, p, c), its reduce. Counts each of the four launches in
    ``contrastive_row_stats.launches``."""
    if z.device.type == "cpu":
        return contrastive_row_stats_reference(z, labels, valid, temperature, neg_mode)
    z, labels, valid = _kernel_inputs(z, labels, valid)
    lib = _row_stats_lib()
    n = z.shape[0]
    f32 = dict(dtype=torch.float32, device=z.device)
    scratch = torch.empty(row_stats_scratch_numel(n), **f32)
    m, nrm, s, p, c = (torch.empty(n, **f32) for _ in range(5))
    steps = ((_PASS_A, (None, None), (None, None, None), "pass A"),
             (_REDUCE_A, (None, None), (m, nrm, None), "reduce A"),
             (_PASS_B, (m, nrm), (None, None, None), "pass B"),
             (_REDUCE_B, (None, None), (s, p, c), "reduce B"))
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        for step, ins, outs, what in steps:
            ptrs = [None if t is None else t.data_ptr() for t in (*ins, scratch, *outs)]
            status = lib.dcss_row_stats(
                step, z.data_ptr(), labels.data_ptr(), valid.data_ptr(), n, z.shape[1],
                1.0 / temperature, int(neg_mode), *ptrs, stream)
            _build.check(lib, status, f"contrastive_row_stats ({what})")
            contrastive_row_stats.launches += 1
    return p, c, s, m, nrm


contrastive_row_stats.launches = 0


def _three_sweep_row_stats(z, labels, valid, temperature: float = 0.07,
                           neg_mode: bool = False):
    """K3's first port, sweeps 0–3 of ``csrc/contrastive.cu`` (each
    recomputes every logit on CUDA cores), on a CUDA tensor: the yardstick
    the tools time the two-pass kernel against. No public path calls it."""
    z, labels, valid = _kernel_inputs(z, labels, valid, DENSE_MAX_D)
    lib = _lib()
    (m,) = _sweep(lib, _SWEEP_MAX, z, labels, valid, temperature,
                  (None, None, None), 1, "three-sweep row stats (max)")
    (n,) = _sweep(lib, _SWEEP_NORM, z, labels, valid, temperature,
                  (m, None, None), 1, "three-sweep row stats (norm)")
    s, p, c = _sweep(lib, _SWEEP_SUMS_NEG if neg_mode else _SWEEP_SUMS, z, labels,
                     valid, temperature, (m, n, None), 3, "three-sweep row stats (sums)")
    return p, c, s, m, n


def pos_sweep_layout_reference(labels, valid):
    """Plain semantics of K4's layout: (sorted keys, perm), int64 (N,), from
    a stable sort of key_i = label_i, or ``INVALID_KEY`` for an invalid row
    (above every int32 label: nothing is reserved). Rows of one label are
    contiguous and invalid rows come last."""
    keys = torch.where(valid.bool(), labels.long(), INVALID_KEY)
    return torch.sort(keys, stable=True)


def pos_sweep_layout(labels, valid):
    """K4's layout step, ``pos_sweep_layout_reference``'s (keys, perm)
    exactly. On a CUDA tensor one launch of ``csrc/pos_sweep.cu``'s layout
    kernel (each row placed by counting the rows before it in (key, index)
    order), counted in ``pos_sweep_layout.launches``, with no host sync;
    where the library's stable radix sort of int64 keys takes 25 launches."""
    if labels.device.type == "cpu":
        return pos_sweep_layout_reference(labels, valid)
    n = labels.shape[0]
    if n < 1 or valid.shape != (n,) or valid.device != labels.device:
        raise ValueError("pos_sweep_layout: labels and valid must be (N >= 1,) on one device")
    labels = labels.detach().to(torch.int32).contiguous()
    valid = valid.detach().bool().contiguous().view(torch.uint8)
    keys, perm = (torch.empty(n, dtype=torch.int64, device=labels.device) for _ in range(2))
    lib = _pos_sweep_lib()
    with torch.cuda.device(labels.device):
        status = lib.dcss_pos_sweep_layout(
            labels.data_ptr(), valid.data_ptr(), n, keys.data_ptr(), perm.data_ptr(),
            torch.cuda.current_stream(labels.device).cuda_stream)
    _build.check(lib, status, "pos_sweep_layout")
    pos_sweep_layout.launches += 1
    return keys, perm


pos_sweep_layout.launches = 0


def _pos_stats(z, m, n, s):
    stats = tuple(t.detach().float().contiguous() for t in (m, n, s))
    for t in stats:
        if t.shape != (z.shape[0],) or t.device != z.device:
            raise ValueError("pixel_contrast_pos_sweep: m, n, s must be (N,) on z's device")
    return stats


def _pos_sweep_launch(z, keys, perm, stats, temperature):
    """The sweep of ``csrc/pos_sweep.cu`` and the reduce of its partials on
    checked inputs and a layout from ``pos_sweep_layout``: (q, c) in the
    caller's row order."""
    n = z.shape[0]
    q, c = (torch.empty(n, dtype=torch.float32, device=z.device) for _ in range(2))
    scratch = torch.empty(2 * POS_SPLIT * n, dtype=torch.float32, device=z.device)
    lib = _pos_sweep_lib()
    with torch.cuda.device(z.device):
        status = lib.dcss_pos_sweep(
            z.data_ptr(), perm.data_ptr(), keys.data_ptr(),
            *(t.data_ptr() for t in stats), n, z.shape[1], 1.0 / temperature,
            scratch.data_ptr(), q.data_ptr(), c.data_ptr(),
            torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(lib, status, "pixel_contrast_pos_sweep")
    return q, c


def pixel_contrast_pos_sweep(z, labels, valid, m, n, s, temperature: float = 0.07):
    """K4: (q, c), each (N,) float32, given the ``neg_mode`` row stats (m, n,
    s) of ``contrastive_row_stats``. On a CUDA tensor: the layout step
    (``pos_sweep_layout``: one launch, and no library launch), then the
    sweep of ``csrc/pos_sweep.cu`` and the reduce of its partials (two
    launches of one C call), counted once in
    ``pixel_contrast_pos_sweep.launches``; no host sync."""
    if z.device.type == "cpu":
        return pixel_contrast_sweep_reference(z, labels, valid, m, n, s, temperature)
    z = _checked_z(z, labels, valid)
    stats = _pos_stats(z, m, n, s)
    keys, perm = pos_sweep_layout(labels, valid)
    q, c = _pos_sweep_launch(z, keys, perm, stats, temperature)
    pixel_contrast_pos_sweep.launches += 1
    return q, c


pixel_contrast_pos_sweep.launches = 0


def _dense_pos_sweep(z, labels, valid, m, n, s, temperature: float = 0.07):
    """K4's first port, sweep 4 of ``csrc/contrastive.cu`` (all N² logits on
    CUDA cores), on a CUDA tensor: the yardstick the tools time the
    segmented kernel against. No public path calls it."""
    z, labels, valid = _kernel_inputs(z, labels, valid, DENSE_MAX_D)
    return _sweep(_lib(), _SWEEP_POS, z, labels, valid, temperature, _pos_stats(z, m, n, s),
                  2, "dense positive sweep")


def _lib() -> ctypes.CDLL:
    lib = _build.load("contrastive")
    fn = lib.dcss_contrastive_sweep
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_float] + [ctypes.c_void_p] * 7)
        fn.restype = ctypes.c_int
    return lib


def _pos_sweep_lib() -> ctypes.CDLL:
    lib = _build.load("pos_sweep")
    fn, layout = lib.dcss_pos_sweep, lib.dcss_pos_sweep_layout
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float]
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        layout.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
        layout.restype = ctypes.c_int
    return lib


def _row_stats_lib() -> ctypes.CDLL:
    lib = _build.load("row_stats")
    fn = lib.dcss_row_stats
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 7)
        fn.restype = ctypes.c_int
    return lib


# ---- csrc/row_stats.cu's arithmetic in plain PyTorch ------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 stored mantissa bits), to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ bᵀ as the kernel forms it on TF32 tensor cores: each operand
    split as hi = tf32(x), lo = tf32(x − hi), and lo·hi + hi·lo + hi·hi
    (lo·lo dropped). Each TF32 product is exact in f32; the sums are f32."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a.float() - a_hi), tf32_round(b.float() - b_hi)
    return (a_lo @ b_hi.t() + a_hi @ b_lo.t()) + a_hi @ b_hi.t()


def merge_row_partials(m, s1, s2, k):
    """(m, n) of each row from its (T, N) pass-A partials, one a column
    tile: the tile's row max m_t, S1 = Σ(l − m_t), S2 = Σ(l − m_t)², k =
    #valid. Merged in tile order by the exact shift, as the reduce launch
    does: S2 += 2δS1 + kδ², S1 += kδ for δ = m_old − m_new ≤ 0; a partial
    with k = 0 is skipped."""
    big = torch.full_like(m[0], NEG_BIG)
    acc_m, acc_s1, acc_s2, acc_k = big, torch.zeros_like(big), torch.zeros_like(big), \
        torch.zeros_like(big)
    for mb, s1b, s2b, kb in zip(m, s1, s2, k):
        mn = torch.maximum(acc_m, mb)
        da, db = acc_m - mn, mb - mn
        both = (kb > 0) & (acc_k > 0)
        first = (kb > 0) & (acc_k == 0)
        # a skipped partial's δ² may overflow: where() drops those lanes
        m2 = (acc_s2 + da * (2 * acc_s1 + acc_k * da)) + (s2b + db * (2 * s1b + kb * db))
        m1 = (acc_s1 + acc_k * da) + (s1b + kb * db)
        acc_s2 = torch.where(both, m2, torch.where(first, s2b, acc_s2))
        acc_s1 = torch.where(both, m1, torch.where(first, s1b, acc_s1))
        acc_m = torch.where(both, mn, torch.where(first, mb, acc_m))
        acc_k = acc_k + kb
    return torch.where(acc_k > 0, acc_m, big), torch.sqrt(acc_s2).clamp_min(1e-12)


def row_stats_tiled(z, labels, valid, temperature: float = 0.07, neg_mode: bool = False,
                    tile: int = ROW_TILE):
    """K3's (p, c, s, m, n) by the kernel's arithmetic: split-TF32 logits;
    pass A's partials of each column tile merged in tile order
    (``merge_row_partials``); pass B's s, p, c summed tile by tile in tile
    order, with l̂ = (l − m)·(1/n). Which block of the symmetric schedule
    computes a (row, column tile) partial does not change it, so one
    row-major walk gives the same partials."""
    z = z.float()
    labels, valid = labels.to(torch.int32), valid.bool()
    rows = torch.arange(z.shape[0], device=z.device)
    vpair, same, pos, not_self = _pair_masks(labels, valid, rows, labels, valid)
    logits = split_tf32_matmul(z, z) * (1.0 / temperature)
    parts = []
    for t0 in range(0, z.shape[0], tile):
        l, v = logits[:, t0:t0 + tile], vpair[:, t0:t0 + tile]
        mt = torch.where(v, l, NEG_BIG).amax(dim=1)
        d = torch.where(v, l - mt[:, None], 0.0)
        parts.append((mt, d.sum(dim=1), (d * d).sum(dim=1), v.sum(dim=1).float()))
    m, n = merge_row_partials(*(torch.stack(f) for f in zip(*parts)))
    lhat = torch.where(vpair, (logits - m[:, None]) * (1.0 / n)[:, None], 0.0)
    den = (vpair & ~same) if neg_mode else (vpair & not_self)
    terms = (torch.where(den, torch.exp(lhat), 0.0), torch.where(pos, lhat, 0.0),
             pos.float())
    s, p, c = (sum(t[:, t0:t0 + tile].sum(dim=1) for t0 in range(0, z.shape[0], tile))
               for t in terms)
    return p, c, s, m, n


# ---- csrc/pos_sweep.cu's arithmetic in plain PyTorch ------------------------

def warp_lower_bound(keys, target, lo, hi):
    """For each entry, the first index in [lo, hi) whose sorted key is ≥
    target, or hi, as the kernel's warp finds it: each round probes
    ``POS_LANES`` keys ``step = ⌈(hi − lo)/32⌉`` apart and keeps the gap
    between the last probe below the target and the first at or above it."""
    lanes = torch.arange(POS_LANES, device=keys.device)
    last = max(keys.shape[0] - 1, 0)
    lo, hi = lo.clone(), hi.clone()
    while bool((lo < hi).any()):
        active = lo < hi
        step = (hi - lo + POS_LANES - 1) // POS_LANES
        p = lo[:, None] + lanes[None, :] * step[:, None]
        ge = (p >= hi[:, None]) | (keys[p.clamp(0, last)] >= target[:, None])
        none = ~ge.any(dim=1)
        f = ge.int().argmax(dim=1)   # the first probe at or above the target
        new_lo = torch.where(none, lo + (POS_LANES - 1) * step + 1,
                             torch.where(f == 0, lo, lo + (f - 1) * step + 1))
        new_hi = torch.where(none, hi, torch.where(f == 0, lo, torch.minimum(lo + f * step, hi)))
        lo, hi = torch.where(active, new_lo, lo), torch.where(active, new_hi, hi)
    return lo


def pos_sweep_column_ranges(sorted_keys, rows: int = POS_ROWS):
    """(begin, end, n_valid), each (⌈N/rows⌉,) int64, of each row tile of
    the sorted order: its valid rows (a prefix: invalid keys sort last), and
    the columns [begin, end) its block visits, from the start of its first
    row's label segment to the end of its last valid row's, by the kernel's
    warp search. A tile with no valid row has an empty range."""
    n = sorted_keys.shape[0]
    dev = sorted_keys.device
    r0 = torch.arange(0, n, rows, device=dev)
    idx = r0[:, None] + torch.arange(rows, device=dev)[None, :]
    kt = torch.where(idx < n, sorted_keys[idx.clamp(max=n - 1)], INVALID_KEY)
    n_valid = (kt < INVALID_KEY).sum(dim=1)
    first = kt[:, 0]
    last = kt.gather(1, (n_valid - 1).clamp(min=0)[:, None])[:, 0]
    begin = warp_lower_bound(sorted_keys, first, torch.zeros_like(r0), r0)
    end = warp_lower_bound(sorted_keys, last + 1, r0 + n_valid, torch.full_like(r0, n))
    empty = n_valid == 0
    return torch.where(empty, 0, begin), torch.where(empty, 0, end), n_valid


def pos_sweep_segmented(z, labels, valid, m, n, s, temperature: float = 0.07,
                        rows: int = POS_ROWS):
    """K4's (q, c) by ``csrc/pos_sweep.cu``'s steps: the stable sort
    (``pos_sweep_layout_reference``); each row tile's column range
    (``pos_sweep_column_ranges``); the split-TF32 logits of its rows
    against its range in tiles of ``POS_COLS``, every ``POS_SPLIT``-th tile
    to one block; on positives l̂ = (l − m)·(1/n) and l̂ − log(exp(l̂) + s),
    summed in the kernels' order (each lane's columns tile by tile, the 4
    lanes of a row as the xor-1-then-xor-2 shuffles add them, the block's
    two column warps, then the reduce adds the blocks' partials in split
    order); q and c scattered back to the caller's row order."""
    z = z.float()
    nn = z.shape[0]
    dev = z.device
    keys, perm = pos_sweep_layout_reference(labels, valid)
    begin, end, n_valid = pos_sweep_column_ranges(keys, rows)
    zs = z[perm]
    ms, rn, ss = m.float()[perm], 1.0 / n.float()[perm], s.float()[perm]
    q_sorted = torch.zeros(nn, dtype=torch.float32, device=dev)
    c_sorted = torch.zeros(nn, dtype=torch.float32, device=dev)
    for t, (b, e, nv) in enumerate(zip(begin.tolist(), end.tolist(), n_valid.tolist())):
        if nv == 0:
            continue
        ri = torch.arange(t * rows, t * rows + nv, device=dev)
        ntiles = -(-(e - b) // POS_COLS)
        cols = b + torch.arange(ntiles * POS_COLS, device=dev)
        cin = cols < nn
        cc = cols.clamp(max=nn - 1)
        zc = torch.where(cin[:, None], zs[cc], 0.0)
        logits = split_tf32_matmul(zs[ri], zc) * (1.0 / temperature)
        pos = (cin[None, :] & (keys[cc][None, :] == keys[ri][:, None])
               & (cols[None, :] != ri[:, None]))
        lh = (logits - ms[ri][:, None]) * rn[ri][:, None]
        term = torch.where(pos, lh - torch.log(torch.exp(lh) + ss[ri][:, None]), 0.0)
        # column of a tile = 32 wn + 8 ni + 2 lane_t + b
        term = term.reshape(nv, ntiles, 2, 4, 4, 2)
        lane = torch.zeros(nv, POS_SPLIT, 2, 4, dtype=torch.float32, device=dev)
        for u in range(ntiles):
            for ni in range(4):
                for bb in range(2):
                    lane[:, u % POS_SPLIT] += term[:, u, :, ni, :, bb]
        warp = (lane[..., 0] + lane[..., 1]) + (lane[..., 2] + lane[..., 3])
        block = warp[..., 0] + warp[..., 1]          # each split's partial
        q = torch.zeros(nv, dtype=torch.float32, device=dev)
        for sp in range(POS_SPLIT):                  # the reduce, in split order
            q = q + block[:, sp]
        q_sorted[ri] = q
        c_sorted[ri] = pos.sum(dim=1).float()
    q_out, c_out = torch.empty_like(q_sorted), torch.empty_like(c_sorted)
    q_out[perm] = q_sorted
    c_out[perm] = c_sorted
    return q_out, c_out


# ---- backward: chunked dZ = (G + Gᵀ) Z / τ --------------------------------

def dz_via_chunks(z, labels, valid, m, n, row_stats: Tuple[torch.Tensor, ...],
                  ghat_fn: Callable[..., torch.Tensor], inv_temp: float,
                  chunk: int = BWD_CHUNK):
    """∂loss/∂Z of a row-L2-normalised contrastive loss, ``chunk`` rows of
    the logits at a time (JAX ``_dz_via_chunks``). ``ghat_fn(lhat, pos,
    same, vpair, not_self, stats_chunk)`` gives the loss's ∂loss/∂L̂ for one
    slab of full rows; the shared chain through the normalisation is
    G = vpair · (Ĝ − L̂ · ⟨Ĝ, L̂⟩_row) / n, and dZ = (G + Gᵀ) Z / τ: the row
    side per slab, the column side summed over slabs."""
    z = z.float()
    labels, valid = labels.to(torch.int32), valid.bool()
    col_side = torch.zeros_like(z)
    row_side = torch.empty_like(z)
    for r0 in range(0, z.shape[0], chunk):
        r1 = min(r0 + chunk, z.shape[0])
        rows = torch.arange(r0, r1, device=z.device)
        zc = z[r0:r1]
        vpair, same, pos, not_self = _pair_masks(labels[r0:r1], valid[r0:r1], rows,
                                                 labels, valid)
        lhat = _lhat((zc @ z.t()) * inv_temp, vpair, m[r0:r1], n[r0:r1])
        ghat = ghat_fn(lhat, pos, same, vpair, not_self,
                       tuple(t[r0:r1] for t in row_stats))
        r = (ghat * lhat).sum(dim=1, keepdim=True)
        g = torch.where(vpair, (ghat - lhat * r) / n[r0:r1, None], 0.0)
        col_side += (g.t() @ zc) * inv_temp
        row_side[r0:r1] = (g @ z) * inv_temp
    return row_side + col_side


# ---- SupCon / SimCLR -------------------------------------------------------

class _SupconCore(torch.autograd.Function):
    """loss = mean_i −(τ/τ_b)·(p_i − c_i·log s_i)/max(c_i, 1) over the rows
    of z (JAX ``_supcon_core``)."""

    @staticmethod
    def forward(ctx, z, labels, valid, temperature, base_temperature):
        p, c, s, m, n = contrastive_row_stats(z, labels, valid, temperature)
        mlpp = (p - c * torch.log(s.clamp_min(1e-30))) / c.clamp_min(1.0)
        ctx.save_for_backward(z, labels, valid, c, s, m, n)
        ctx.temps = (temperature, base_temperature)
        return (-(temperature / base_temperature) * mlpp).mean()

    @staticmethod
    def backward(ctx, ct):
        z, labels, valid, c, s, m, n = ctx.saved_tensors
        t, tb = ctx.temps
        # ∂loss/∂L̂_ij = coef_i · (pos_ij − (c_i/s_i)·e^{l̂_ij}·[j≠i]·vpair_ij)
        coef = (ct * (-(t / tb)) / z.shape[0] / c.clamp_min(1.0)) * valid.float()
        inv_s = c / s.clamp_min(1e-30)

        def ghat_fn(lhat, pos, same, vpair, not_self, stats):
            coef_c, inv_s_c = stats
            e = torch.where(not_self & vpair, torch.exp(lhat), 0.0)
            return coef_c[:, None] * (pos.float() - inv_s_c[:, None] * e)

        dz = dz_via_chunks(z, labels, valid, m, n, (coef, inv_s), ghat_fn, 1.0 / t)
        return dz.to(z.dtype), None, None, None, None


def supcon_loss_kernel(features: torch.Tensor, labels: Optional[torch.Tensor] = None,
                       temperature: float = 0.07,
                       base_temperature: float = 0.07) -> torch.Tensor:
    """SupCon (labels given) or SimCLR (labels None) over (B, 2, D) two-view
    embeddings through K3, differentiable (JAX ``supcon_loss_pallas``)."""
    b = features.shape[0]
    z = torch.cat([features[:, 0], features[:, 1]], dim=0).float()
    lab = (torch.arange(b, device=z.device) if labels is None
           else labels.reshape(-1).to(device=z.device))
    lab = torch.cat([lab, lab]).to(torch.int32)
    valid = torch.ones(2 * b, dtype=torch.bool, device=z.device)
    return _SupconCore.apply(z, lab, valid, temperature, base_temperature)


# ---- pixel contrast --------------------------------------------------------

class _PixelContrastCore(torch.autograd.Function):
    """Pixel contrast's per-pair denominator exp(l̂_ij) + Σ_neg exp, over the
    rows of z, averaged over valid rows with positives (JAX ``_pc_core``)."""

    @staticmethod
    def forward(ctx, z, labels, valid, temperature, base_temperature):
        _, _, s, m, n = contrastive_row_stats(z, labels, valid, temperature,
                                              neg_mode=True)
        q, c = pixel_contrast_pos_sweep(z, labels, valid, m, n, s, temperature)
        per_anchor = -(temperature / base_temperature) * q / c.clamp_min(1.0)
        row_ok = valid.bool() & (c > 0)
        loss = torch.where(row_ok, per_anchor, 0.0).sum() / row_ok.sum().clamp_min(1)
        ctx.save_for_backward(z, labels, valid, c, s, m, n)
        ctx.temps = (temperature, base_temperature)
        return loss

    @staticmethod
    def backward(ctx, ct):
        z, labels, valid, c, s, m, n = ctx.saved_tensors
        t, tb = ctx.temps
        row_ok = valid.bool() & (c > 0)
        denom = row_ok.sum().clamp_min(1).float()
        # ∂loss/∂L̂_ij, with the per-pair denominator D_ij = e^{l̂_ij} + s_i:
        #   positives: w_i · (1 − e_ij/D_ij)
        #   negatives: −w_i · e_ij · t_i,  t_i = Σ_pos 1/D_ik (in the slab)
        w = torch.where(row_ok, ct * (-(t / tb)) / (denom * c.clamp_min(1.0)), 0.0)

        def ghat_fn(lhat, pos, same, vpair, not_self, stats):
            w_c, s_c = stats
            e = torch.exp(lhat)
            dmat = e + s_c[:, None]
            tt = torch.where(pos, 1.0 / dmat, 0.0).sum(dim=1, keepdim=True)
            neg = vpair & ~same
            return w_c[:, None] * (torch.where(pos, 1.0 - e / dmat, 0.0)
                                   - torch.where(neg, e * tt, 0.0))

        dz = dz_via_chunks(z, labels, valid, m, n, (w, s), ghat_fn, 1.0 / t)
        return dz.to(z.dtype), None, None, None, None


def pixel_contrast_loss_kernel(feats: torch.Tensor, labels: torch.Tensor,
                               valid: torch.Tensor, temperature: float = 0.07,
                               base_temperature: float = 0.07) -> torch.Tensor:
    """Pixel contrast over (A, V, D) anchor views with (A,) labels and (A,)
    validity, through K3's sweeps in ``neg_mode`` and K4's sweep,
    differentiable (JAX ``pixel_contrast_loss_pallas``)."""
    v = feats.shape[1]
    z = torch.cat([feats[:, i] for i in range(v)], dim=0).float()
    lab = labels.reshape(-1).to(torch.int32).repeat(v)
    val = valid.reshape(-1).bool().repeat(v)
    return _PixelContrastCore.apply(z, lab, val, temperature, base_temperature)
