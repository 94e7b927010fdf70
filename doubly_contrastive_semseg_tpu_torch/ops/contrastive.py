"""Row-L2-normalised contrastive losses that never hold the N×N logits.

Port of the JAX package's ``ops/contrastive_pallas.py``: the TPU kernels
``contrastive_row_stats`` (K3: ``_max_kernel``, ``_norm_kernel``,
``_sums_kernel``) and the fourth sweep of ``pixel_contrast_loss_pallas``
(K4: ``_pc_kernel``) become one CUDA kernel, ``csrc/contrastive.cu``, one
sweep a launch; its note names the bound (operations) and the design. A
tensor on the CPU takes the plain versions, ``contrastive_row_stats_reference``
and ``pixel_contrast_sweep_reference`` (dense N×N, same masks and clamps);
a CUDA tensor launches the kernel or raises.

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
MAX_D = 256
BWD_CHUNK = 256  # rows a backward slab holds; live memory ≈ a few × chunk·N f32

_SWEEP_MAX, _SWEEP_NORM, _SWEEP_SUMS, _SWEEP_SUMS_NEG, _SWEEP_POS = range(5)


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


def _kernel_inputs(z, labels, valid):
    if z.dim() != 2 or not 1 <= z.shape[1] <= MAX_D or z.shape[0] < 1:
        raise ValueError(f"contrastive: z must be (N >= 1, D <= {MAX_D}), "
                         f"got {tuple(z.shape)}")
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
    return (z, labels.detach().to(torch.int32).contiguous(),
            valid.detach().to(torch.int32).contiguous())


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


def contrastive_row_stats(z, labels, valid, temperature: float = 0.07,
                          neg_mode: bool = False):
    """K3: (p, c, s, m, n), each (N,) float32, for z (N, D) float32, int
    labels (N,) and bool validity (N,), by three sweeps that recompute the
    logits tile by tile. Counts each launch (three a call) in
    ``contrastive_row_stats.launches``."""
    if z.device.type == "cpu":
        return contrastive_row_stats_reference(z, labels, valid, temperature, neg_mode)
    z, labels, valid = _kernel_inputs(z, labels, valid)
    lib = _lib()
    (m,) = _sweep(lib, _SWEEP_MAX, z, labels, valid, temperature,
                  (None, None, None), 1, "contrastive_row_stats (max)")
    contrastive_row_stats.launches += 1
    (n,) = _sweep(lib, _SWEEP_NORM, z, labels, valid, temperature,
                  (m, None, None), 1, "contrastive_row_stats (norm)")
    contrastive_row_stats.launches += 1
    s, p, c = _sweep(lib, _SWEEP_SUMS_NEG if neg_mode else _SWEEP_SUMS, z, labels,
                     valid, temperature, (m, n, None), 3, "contrastive_row_stats (sums)")
    contrastive_row_stats.launches += 1
    return p, c, s, m, n


contrastive_row_stats.launches = 0


def pixel_contrast_pos_sweep(z, labels, valid, m, n, s, temperature: float = 0.07):
    """K4's fourth sweep: (q, c), each (N,) float32, given the ``neg_mode``
    row stats (m, n, s) of ``contrastive_row_stats``. Counts its launches in
    ``pixel_contrast_pos_sweep.launches``."""
    if z.device.type == "cpu":
        return pixel_contrast_sweep_reference(z, labels, valid, m, n, s, temperature)
    z, labels, valid = _kernel_inputs(z, labels, valid)
    stats = tuple(t.detach().float().contiguous() for t in (m, n, s))
    for t in stats:
        if t.shape != (z.shape[0],) or t.device != z.device:
            raise ValueError("pixel_contrast_pos_sweep: m, n, s must be (N,) on z's device")
    q, c = _sweep(_lib(), _SWEEP_POS, z, labels, valid, temperature, stats, 2,
                  "pixel_contrast_pos_sweep")
    pixel_contrast_pos_sweep.launches += 1
    return q, c


pixel_contrast_pos_sweep.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("contrastive")
    fn = lib.dcss_contrastive_sweep
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_float] + [ctypes.c_void_p] * 7)
        fn.restype = ctypes.c_int
    return lib


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
