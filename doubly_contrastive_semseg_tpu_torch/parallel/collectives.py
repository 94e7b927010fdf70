"""The collectives that make a multi-rank step the one-process step on the
global batch — what GSPMD does for the JAX package's mesh.

Each rank back-propagates a loss whose value is the global one and whose
gradient flows through its own rows only, so the gradients summed over the
ranks (``all_reduce_grads``) are the one-process gradient:

- a mean over pixels or samples: each rank's partial sum over the global
  count (``all_sum`` of the counts), its value made global by
  ``global_value``;
- a contrast over the batch (SupCon, pixel contrast): the inputs gathered
  in the global order (``gather_rows``, whose backward keeps this rank's
  rows of the gradient), the loss computed whole on every rank;
- BatchNorm in training (``sync_batch_norm``): the moments of the global
  batch from every rank's count, mean and centred sum of squares, the
  backward's two per-channel sums all-reduced; the running statistics fold
  the unbiased global variance, as the one-process ``nn.BatchNorm2d`` does.

Every collective is an all-reduce (a gather is a sum of zero-padded
slices), a broadcast or a barrier, which gloo offers on CUDA tensors too.
With one rank each function is the identity or the one-process call.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn

from .mesh import active, global_rows, row_index, world


def all_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (one axis's,
    ``World.group``; every rank by default), no gradient; ``t`` with one
    rank. A tensor on the CPU summed over every rank goes over the CPU
    group."""
    if not active():
        return t
    out = t.detach().clone()
    if group is None and not out.is_cuda:
        group = world().control
    dist.all_reduce(out, group=group)
    return out


def global_value(partial: torch.Tensor) -> torch.Tensor:
    """A tensor whose value is the sum of ``partial`` over the ranks and
    whose gradient is ``partial``'s."""
    if not active():
        return partial
    d = partial.detach()
    return partial + (all_sum(d) - d)


def global_mean(values: torch.Tensor) -> torch.Tensor:
    """The mean of ``values`` over every rank's entries (no gradient)."""
    if not active():
        return values.mean()
    s = all_sum(torch.stack([values.sum().float(),
                             torch.tensor(float(values.numel()), device=values.device)]))
    return s[0] / s[1]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, idx, n_global):
        buf = t.new_zeros((n_global,) + tuple(t.shape[1:]))
        buf[idx] = t
        dist.all_reduce(buf)
        ctx.save_for_backward(idx)
        return buf

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return grad[idx], None, None


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t`` (sample-major: its samples' rows one after
    another) in the global batch's order; the backward keeps this rank's
    rows. Bool tensors travel as int32. ``t`` with one rank."""
    if not active():
        return t
    idx = row_index(t.shape[0], device=t.device)
    n = global_rows(t.shape[0])
    if t.dtype == torch.bool:
        return _GatherRows.apply(t.to(torch.int32), idx, n).bool()
    return _GatherRows.apply(t, idx, n)


def all_reduce_grads(module: nn.Module) -> None:
    """Sums every parameter gradient over the ranks in one flat buffer
    (gradients that are None stay None: the graph is the same on every
    rank)."""
    if not active():
        return
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    o = 0
    for g in grads:
        g.copy_(flat[o:o + g.numel()].view(g.shape))
        o += g.numel()


def broadcast_module(module: nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank."""
    if not active():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable) on every rank, over the CPU group."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=world().control)
    return box[0]


def barrier() -> None:
    if active():
        dist.barrier(group=world().control)


def agree_max(value: int) -> int:
    """The largest of every rank's ``value``, over the CPU group."""
    if not active():
        return value
    t = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=world().control)
    return int(t.item())


class _SyncBatchNorm(torch.autograd.Function):
    """y = (x − μ)·rstd·γ + β with μ, rstd of the global batch; the
    backward all-reduces Σg and Σg·x̂ per channel."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, rstd, count):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xhat = (x.to(mean.dtype) - mean.view(shape)) * rstd.view(shape)
        y = xhat * weight.view(shape) + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.count = count
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        x, weight, mean, rstd = ctx.saved_tensors
        shape = (1, -1) + (1,) * (x.dim() - 2)
        dims = [0] + list(range(2, x.dim()))
        g = gy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean.view(shape)) * rstd.view(shape)
        sum_g, sum_gx = g.sum(dims), (g * xhat).sum(dims)
        tot = all_sum(torch.cat([sum_g, sum_gx]))
        c = sum_g.numel()
        dx = (weight * rstd).view(shape) * (g - tot[:c].view(shape) / ctx.count
                                            - xhat * (tot[c:].view(shape) / ctx.count))
        return dx.to(x.dtype), sum_gx.to(weight.dtype), sum_g.to(weight.dtype), None, None, None


def sync_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """``bn`` in training over the global batch: every rank's (count, mean,
    centred sum of squares) a channel combined in float64 (Chan's rule),
    the running statistics updated with the unbiased global variance. The
    arithmetic is float32 (float64 for a float64 ``x``)."""
    w = world()
    c = x.shape[1]
    dims = [0] + list(range(2, x.dim()))
    n_local = x.numel() // c
    cdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    with torch.no_grad():
        xf = x.to(cdt)
        stats = torch.zeros((w.size, 2 * c + 1), dtype=torch.float64, device=x.device)
        if n_local:
            m = xf.mean(dims)
            shape = (1, -1) + (1,) * (x.dim() - 2)
            stats[w.rank, 0] = n_local
            stats[w.rank, 1:c + 1] = m.double()
            stats[w.rank, c + 1:] = ((xf - m.view(shape)) ** 2).sum(dims).double()
        dist.all_reduce(stats)
        n = stats[:, :1]
        count = float(global_rows(x.shape[0]) * (n_local // x.shape[0]))   # no host sync
        mean = (n * stats[:, 1:c + 1]).sum(0) / count
        m2 = (stats[:, c + 1:] + n * (stats[:, 1:c + 1] - mean) ** 2).sum(0)
        var = m2 / count
        if bn.track_running_stats:
            bn.num_batches_tracked.add_(1)
            mom = bn.momentum if bn.momentum is not None else 1.0 / float(bn.num_batches_tracked)
            rdt = bn.running_mean.dtype
            bn.running_mean.mul_(1 - mom).add_(mom * mean.to(rdt))
            bn.running_var.mul_(1 - mom).add_(mom * (var * count / max(count - 1, 1)).to(rdt))
        mean, rstd = mean.to(cdt), torch.rsqrt(var + bn.eps).to(cdt)
    return _SyncBatchNorm.apply(x, bn.weight, bn.bias, mean, rstd, count)
