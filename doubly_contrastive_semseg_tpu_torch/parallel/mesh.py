"""Ranks and the batch's share of each — the port's counterpart of the JAX
package's ``parallel/mesh.py`` (``make_mesh``, ``shard_batch``).

JAX runs one global program over a ``('data',)`` mesh: GSPMD shards the
batch and every BatchNorm moment, loss normaliser and random draw spans the
global batch. The port runs ``--num_devices`` N processes, one a rank, and
gives the same numbers:

- each rank holds its share of the one-process global batch
  (``shard_batch``): the same samples, split per sample (a two-view batch's
  views stay with their sample), unevenly where N does not divide the batch
  (``torch.tensor_split``'s sizes, JAX replicates such a batch);
- a random draw over the batch is drawn whole on every rank from the same
  generator and each rank keeps its rows (``rand_rows``);
- the collectives of ``collectives.py`` make BatchNorm, the losses and the
  eval sums global.

``make_mesh`` joins the process group: NCCL with ``cuda:rank`` on the card,
gloo on the CPU; ``backend="gloo"`` on the card lets several ranks share one
(the one-card check in ``chip_smoke.py``; NCCL refuses two ranks on a
device). Every collective the port issues is an all-reduce, a broadcast or a
barrier, the ones gloo offers on CUDA tensors. A second, gloo group on the
CPU (``World.control``) carries the flags and names the ranks agree on
without touching the card.

``make_mesh(..., axes=("data", "model"), shape=(d, m))`` lays the ranks
out as JAX's ``('data', 'model')`` mesh: rank r sits at (r // m, r % m),
the batch is split over ``data`` only (every rank of a ``model`` group, a
row of the grid, holds the same samples), and each row splits the width of
its activations (``spatial.py``). ``World.groups`` holds the process group
of each axis that contains this rank (``None``: the whole world).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class World:
    """The process's place among the ranks: ``rank`` of ``size``, its
    ``device``, the CPU ``control`` group, ``rows`` (each data index's
    samples of the batch ``shard_batch`` last split), ``stop`` (the
    launcher's shared signal number, 0 until a signal), and the grid:
    ``axes``, their ``shape``, this rank's ``coords`` and the process group
    of each axis that holds it (``groups``; ``None`` is the whole world)."""
    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    control: Optional[object] = None
    rows: Sequence[int] = ()
    stop: Optional[object] = None
    axes: Tuple[str, ...] = ("data",)
    shape: Optional[Tuple[int, ...]] = None    # None: (size,), one data axis
    coords: Optional[Tuple[int, ...]] = None   # None: (rank,)
    groups: Dict[str, object] = dataclasses.field(default_factory=dict)

    def axis_size(self, axis: str) -> int:
        """The ranks along ``axis`` (1 for an axis the grid does not have)."""
        if axis not in self.axes:
            return 1
        return self.shape[self.axes.index(axis)] if self.shape is not None else self.size

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 if the grid lacks it)."""
        if axis not in self.axes:
            return 0
        return self.coords[self.axes.index(axis)] if self.coords is not None else self.rank

    def group(self, axis: str):
        """The process group of this rank's ``axis`` (``None``: the world)."""
        return self.groups.get(axis)


_WORLD = World()


def world() -> World:
    return _WORLD


def active() -> bool:
    """More than one rank."""
    return _WORLD.size > 1


def make_mesh(rank: int, size: int, init_method: str, device: torch.device,
              backend: Optional[str] = None, stop=None, axes: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None) -> World:
    """Joins the ``size``-rank process group at ``init_method`` as ``rank``
    on ``device`` (``backend`` NCCL on a card, gloo on the CPU, unless
    given) and makes it the process's ``world()``. ``axes`` and ``shape``
    (JAX ``make_mesh``'s; ``(size,)`` by default) lay the ranks out as a
    grid, row-major: with ``("data", "model")`` and ``(d, m)`` rank r is at
    (r // m, r % m), and every rank joins a group for each row (its
    ``model`` group) and each column (its ``data`` group)."""
    global _WORLD
    axes = tuple(axes)
    shape = tuple(shape) if shape is not None else (size,)
    if len(axes) != len(shape) or "data" not in axes or math.prod(shape) != size:
        raise ValueError(f"make_mesh: axes {axes} of shape {shape} for {size} ranks")
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=rank)
    control = dist.new_group(backend="gloo") if backend != "gloo" else None
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    _WORLD = World(rank, size, device, control, (), stop, axes, shape, coords,
                   _axis_groups(rank, shape, axes))
    if axes == ("data",):
        _WORLD.shape = _WORLD.coords = None
    return _WORLD


def _axis_groups(rank: int, shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Dict[str, object]:
    """The group of each axis that holds ``rank``: the whole world (``None``)
    for an axis that spans it, else one ``new_group`` a line of the grid
    along that axis, every line made on every rank (``new_group`` is
    collective) in the same order."""
    ranks = np.arange(math.prod(shape)).reshape(shape)
    out = {}
    for i, axis in enumerate(axes):
        if shape[i] == ranks.size:
            out[axis] = None
            continue
        for line in np.moveaxis(ranks, i, -1).reshape(-1, shape[i]):
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                out[axis] = g
    return out


def leave() -> None:
    """Leaves the process group; ``world()`` is one rank again."""
    global _WORLD
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD = World()


def data_rows() -> int:
    """This rank's samples of the last split batch (``World.rows`` at its
    data index)."""
    return _WORLD.rows[_WORLD.axis_index("data")]


def split_sizes(n: int, size: int) -> list:
    """``torch.tensor_split``'s chunk sizes of ``n`` rows over ``size``
    ranks: the first ``n % size`` take one more."""
    return [n // size + (i < n % size) for i in range(size)]


def row_index(n_local: int, blocks: int = 1, device=None) -> torch.Tensor:
    """The global rows of this rank's ``n_local`` rows of a tensor laid out
    as ``blocks`` blocks (two views: 2) of the batch's samples, ``per``
    consecutive rows a sample: local (block j, sample s, q) is global
    ``(j·B + offset + s)·per + q``."""
    w = _WORLD
    i = w.axis_index("data")
    b, off = w.rows[i], sum(w.rows[:i])
    if b == 0:
        return torch.zeros(0, dtype=torch.long, device=device)
    per = n_local // (blocks * b)
    if per * blocks * b != n_local:
        raise ValueError(f"{n_local} rows are not {blocks} block(s) of this rank's {b} samples")
    total = sum(w.rows)
    idx = [torch.arange((j * total + off) * per, (j * total + off + b) * per)
           for j in range(blocks)]
    return torch.cat(idx).to(device)


def global_rows(n_local: int) -> int:
    """The rows across the ranks of a tensor with ``n_local`` on this one."""
    if not active():
        return n_local
    return n_local * sum(_WORLD.rows) // data_rows()


def rand_rows(shape, generator: Optional[torch.Generator], device, dim: int = 0,
              blocks: int = 1) -> torch.Tensor:
    """``torch.rand(shape)`` as one process would draw it for the global
    batch, this rank's rows of it along ``dim`` (laid out as ``row_index``
    says): the same generator consumption and values on every rank."""
    if not active():
        return torch.rand(shape, generator=generator, device=device)
    shape = list(shape)
    idx = row_index(shape[dim], blocks, device)
    shape[dim] = global_rows(shape[dim])
    u = torch.rand(shape, generator=generator, device=device)
    return u.index_select(dim, idx)


_SAMPLE_KEYS = ("label", "disp", "weather", "right", "left")


def shard_batch(batch: Dict) -> Dict:
    """This rank's share of a host batch (numpy arrays, lists of names): B
    samples split over the ``data`` axis as ``split_sizes`` says, each
    array's rows of its samples (both views of a two-view ``left`` of 2B
    rows), lists alike; ``world().rows`` records the split. The batch as it
    is with one rank."""
    if not active():
        return batch
    w = _WORLD
    n = next(len(batch[k]) for k in _SAMPLE_KEYS if batch.get(k) is not None)
    w.rows = tuple(split_sizes(n, w.axis_size("data")))
    out = {}
    for k, v in batch.items():
        rows = len(v) if isinstance(v, (list, tuple)) or np.ndim(v) > 0 else 0
        if rows == 0 or rows % n:
            out[k] = v
            continue
        idx = row_index(data_rows() * (rows // n), blocks=rows // n).numpy()
        out[k] = [v[i] for i in idx] if isinstance(v, (list, tuple)) else np.asarray(v)[idx]
    return out


def local_share() -> float:
    """This rank's share of the last batch's samples (1.0 with one rank)."""
    if not active():
        return 1.0
    return data_rows() / sum(_WORLD.rows)
