"""Width-split activations over the grid's ``model`` axis: the port's
counterpart of JAX placing an image with ``P(None, None, "model", None)``
on a ``('data', 'model')`` mesh (JAX ``parallel/mesh.py:14-16``), whose
halo exchanges GSPMD inserts. Here each layer of the width-split forward
asks for its own.

The rule, for every map of global width W on the m ranks of a model group:

- rank k owns the columns ``torch.tensor_split(range(W), m)[k]`` (``cols``),
  so a map's ranges are a function of (W, m, k) alone; an uneven split and
  an empty range are legal;
- a windowed op (a conv of width k, stride s and padding p, the stem's
  conv and pool, a resize) makes this rank's output columns [a, b) from the
  global input columns [lo, hi) that they read (``conv_reads``, the
  resizes' own windows), which ``fetch`` brings from the ranks that own
  them. Every rank computes every rank's window, so a stride-2 layer whose
  input and output ranges do not nest fetches what each rank needs;
- the op's padding applies only where [lo, hi) meets a global edge: zeros
  for the convs, the clamp of the resizes, the pyramid's replicate column;
  inside the map the window holds the real neighbours;
- a rank whose output range is empty computes nothing (no op runs on a
  zero-width tensor) and makes an empty output, but still joins every
  collective: each fetch is one all-reduce over the model group that every
  rank makes, whatever it owns;
- a reduction over the whole map (``spatial_mean``) is a model-group sum.

``shard_width`` and ``gather_width`` go between a whole map and this
rank's columns. Every collective is an all-reduce over the model group,
which gloo offers on CUDA tensors (several ranks may share one card).
Halos travel in float32 (float64 for a float64 map), which holds bf16
values and small integers (labels) exactly; a column reaches the sum from
its one owner and zeros from every other rank, so it arrives unchanged.
Without a model axis of more than one rank nothing here is reached.
``ALL_REDUCES`` counts this process's all-reduces and their bytes.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import split_sizes, world


ALL_REDUCES = {"calls": 0, "bytes": 0}


def _all_reduce(t: torch.Tensor, group) -> None:
    """``dist.all_reduce`` of ``t`` in place over ``group``, counted."""
    ALL_REDUCES["calls"] += 1
    ALL_REDUCES["bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, group=group)


def grid() -> Tuple[int, int, object]:
    """(m, k, group): this rank is the k-th of its model group's m ranks;
    ``group`` is that group's process group."""
    w = world()
    return w.axis_size("model"), w.axis_index("model"), w.group("model")


def split_active() -> bool:
    """A model axis of more than one rank: activations are width-split."""
    return world().axis_size("model") > 1


def cols(width: int, m: int, k: int) -> Tuple[int, int]:
    """[start, stop) of the columns rank k of m owns of a width-``width`` map
    (``torch.tensor_split``'s k-th chunk)."""
    sizes = split_sizes(width, m)
    start = sum(sizes[:k])
    return start, start + sizes[k]


def ranges(width: int, m: int) -> List[Tuple[int, int]]:
    """Every rank's ``cols`` of a width-``width`` map over m ranks."""
    return [cols(width, m, k) for k in range(m)]


def conv_reads(k: int, s: int, p: int, width: int) -> Callable[[int, int], Tuple[int, int]]:
    """(a, b) → [lo, hi): the input columns, clipped to the width-``width``
    map, that output columns [a, b) of a window k wide, of stride s and
    padding p read (columns s·a − p … s·(b − 1) − p + k − 1)."""
    def reads(a: int, b: int) -> Tuple[int, int]:
        return max(0, s * a - p), min(width, s * (b - 1) - p + k)
    return reads


def _wire_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def fetch(x: torch.Tensor, width: int, need: Sequence[Tuple[int, int]],
          dim: int) -> torch.Tensor:
    """The global columns ``need[k]`` = [lo, hi) of a width-``width`` map on
    its k-th rank, one tensor along ``dim``, from ``x``, this rank's own
    columns of it. ``need`` lists every rank's window, the same list on
    every rank. What a rank lacks of its window, left and right of its own
    columns, travels in one all-reduce over the model group, each column
    filled in by its owner; a fetch in which no rank lacks anything makes
    no collective."""
    m, k, group = grid()
    starts = ranges(width, m)
    s, e = starts[k]
    lo, hi = need[k]
    o0 = min(max(lo, s), e)
    own = x.narrow(dim, o0 - s, max(min(hi, e), o0) - o0)
    # each rank's (left, right) pieces outside its own columns
    pieces = [((lo_j, min(hi_j, s_j)), (max(lo_j, e_j), hi_j))
              for (lo_j, hi_j), (s_j, e_j) in zip(need, starts)]
    total = sum(max(0, h - l) for pair in pieces for l, h in pair)
    if total == 0:
        return own
    shape = list(x.shape)
    shape[dim] = total
    buf = torch.zeros(shape, dtype=_wire_dtype(x.dtype), device=x.device)
    off, mine = 0, []
    for j, pair in enumerate(pieces):
        for l, h in pair:
            n = max(0, h - l)
            a, b = max(l, s), min(h, e)
            if b > a:
                buf.narrow(dim, off + a - l, b - a).copy_(x.narrow(dim, a - s, b - a))
            if j == k:
                mine.append((off, n))
            off += n
    _all_reduce(buf, group)
    left, right = (buf.narrow(dim, o, n).to(x.dtype) for o, n in mine)
    return torch.cat([left, own, right], dim)


def windowed(x: torch.Tensor, width: int, out_width: int,
             reads: Callable[[int, int], Tuple[int, int]],
             op: Callable[[torch.Tensor, int, int, int, int], torch.Tensor],
             dim: int) -> Optional[torch.Tensor]:
    """This rank's output columns of a windowed op from a width-``width``
    map to a width-``out_width`` one: every rank's output range, the input
    columns each reads (``reads(a, b)`` → [lo, hi)) fetched, then
    ``op(window, lo, hi, a, b)`` on this rank's window. ``None`` where this
    rank's output range is empty (it joined the fetch all the same)."""
    m, k, _ = grid()
    out = ranges(out_width, m)
    need = [reads(a, b) if b > a else (0, 0) for a, b in out]
    xw = fetch(x, width, need, dim)
    a, b = out[k]
    return op(xw, *need[k], a, b) if b > a else None


def global_width(local: int, device=None) -> int:
    """The width of a map of which this rank holds ``local`` columns: the
    model group's sum (one all-reduce; ``local`` without a split)."""
    if not split_active():
        return local
    _, _, group = grid()
    t = torch.tensor([local], dtype=torch.float64, device=device)
    _all_reduce(t, group)
    return int(t.item())


def shard_width(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """This rank's columns of the whole map ``x`` along ``dim`` (2: NHWC),
    contiguous: JAX's ``device_put(x, NamedSharding(mesh, P(None, None,
    "model", None)))``. ``x`` as it is without a split."""
    if not split_active():
        return x
    m, k, _ = grid()
    a, b = cols(x.shape[dim], m, k)
    return x.narrow(dim, a, b - a).contiguous()


def gather_width(t: torch.Tensor, width: Optional[int] = None, dim: int = 2) -> torch.Tensor:
    """The whole width-``width`` map (found by ``global_width`` unless
    given) on every rank of the model group, from each rank's columns
    ``t`` along ``dim``."""
    if not split_active():
        return t
    width = global_width(t.shape[dim], t.device) if width is None else width
    return fetch(t, width, [(0, width)] * grid()[0], dim)


def spatial_mean(x: torch.Tensor, width: int) -> torch.Tensor:
    """(B, C) mean over the whole H × ``width`` map of this rank's columns
    ``x`` (B, H, w, C): the model group's sum of each rank's sum, in
    float32 (float64 for float64), returned in ``x``'s dtype."""
    acc = _wire_dtype(x.dtype)
    s = x.to(acc).sum(dim=(1, 2))
    if split_active():
        _all_reduce(s, grid()[2])
    return (s / (x.shape[1] * width)).to(x.dtype)
