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
without touching the card. JAX's ``('data', 'model')`` mesh with
width-sharded activations is reached by no entry point and has no
counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class World:
    """The process's place among the ranks: ``rank`` of ``size``, its
    ``device``, the CPU ``control`` group, ``rows`` (each rank's samples of
    the batch ``shard_batch`` last split) and ``stop`` (the launcher's
    shared signal number, 0 until a signal)."""
    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    control: Optional[object] = None
    rows: Sequence[int] = ()
    stop: Optional[object] = None


_WORLD = World()


def world() -> World:
    return _WORLD


def active() -> bool:
    """More than one rank."""
    return _WORLD.size > 1


def make_mesh(rank: int, size: int, init_method: str, device: torch.device,
              backend: Optional[str] = None, stop=None) -> World:
    """Joins the ``size``-rank process group at ``init_method`` as ``rank``
    on ``device`` (``backend`` NCCL on a card, gloo on the CPU, unless
    given) and makes it the process's ``world()``."""
    global _WORLD
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=rank)
    control = dist.new_group(backend="gloo") if backend != "gloo" else None
    _WORLD = World(rank, size, device, control, (), stop)
    return _WORLD


def leave() -> None:
    """Leaves the process group; ``world()`` is one rank again."""
    global _WORLD
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD = World()


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
    b, off = w.rows[w.rank], sum(w.rows[:w.rank])
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
    w = _WORLD
    return n_local * sum(w.rows) // w.rows[w.rank]


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
    samples split as ``split_sizes`` says, each array's rows of its samples
    (both views of a two-view ``left`` of 2B rows), lists alike; ``world().
    rows`` records the split. The batch as it is with one rank."""
    if not active():
        return batch
    w = _WORLD
    n = next(len(batch[k]) for k in _SAMPLE_KEYS if batch.get(k) is not None)
    w.rows = tuple(split_sizes(n, w.size))
    out = {}
    for k, v in batch.items():
        rows = len(v) if isinstance(v, (list, tuple)) or np.ndim(v) > 0 else 0
        if rows == 0 or rows % n:
            out[k] = v
            continue
        idx = row_index(w.rows[w.rank] * (rows // n), blocks=rows // n).numpy()
        out[k] = [v[i] for i in idx] if isinstance(v, (list, tuple)) else np.asarray(v)[idx]
    return out


def local_share() -> float:
    """This rank's share of the last batch's samples (1.0 with one rank)."""
    if not active():
        return 1.0
    w = _WORLD
    return w.rows[w.rank] / sum(w.rows)
