"""The checkpointable loader behind ``--loader grain`` — port of the JAX
package's ``data/grain_loader.py`` (``GrainDataLoader``, ``make_loader``),
without Grain.

JAX runs ``grain.DataLoader`` over ``grain.IndexSampler(num_records=n,
shuffle=shuffle, num_epochs=1, seed=seed * 1_000_003 + epoch)`` with
``worker_count=num_workers`` processes and batches its records itself. The
port keeps what a run can observe of that:

- **order**: position ``i`` of an epoch reads record ``index_shuffle(i,
  n - 1, sampler seed)`` (``data/index_shuffle.py``, Grain's compiled
  permutation), whatever the worker count, or record ``i`` unshuffled;
- **batches**: ``batch_size`` records in order, the remainder dropped under
  ``drop_last``, collated by ``loader.py::collate``;
- **errors**: ``IndexSampler``'s, message for message (no records, a seed
  outside 32 bits, which ``--shuffle`` meets from ``--random_seed`` 4295);
- **state**: ``get_state()`` is the JSON bytes Grain's iterator returns at
  the same position (``version``, ``last_seen_indices``,
  ``last_worker_index``, ``worker_count``, the sampler's and the data
  source's reprs), ``set_state`` defers to the next ``__iter__`` and refuses
  a state whose worker count or reprs differ, as Grain does.

The samples are read by the threaded loader's pool (``loader.py``), which
prefetches ahead of the consumer; the position counts the records of the
batches handed out, as Grain counts the records its consumer has taken, and
an epoch read to its end counts every record, the dropped remainder too.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, List, Optional

import numpy as np

from .index_shuffle import shuffled_indices
from .loader import DataLoader

STATE_VERSION = 2
SEED_MULTIPLIER = 1_000_003


class IndexSampler:
    """Grain's ``IndexSampler`` for one unsharded epoch: its checks, its
    ``repr`` and its record order."""

    def __init__(self, num_records: int, shuffle: bool = False, seed: Optional[int] = None):
        if num_records <= 0:
            raise ValueError("Invalid number of records in Sampler. "
                             f"Got {num_records} records, but number of records "
                             "must be greater than 0.")
        if shuffle and seed is None:
            raise ValueError("Shuffling requires specifying a seed.")
        if shuffle and not isinstance(seed, int):
            raise TypeError(f"Expected seed of int type. Got seed with type {type(seed)}")
        if seed is not None and (seed < 0 or seed.bit_length() > 32):
            raise ValueError("Seed should be positive 32-bit integer.")
        self.num_records = num_records
        self.shuffle = shuffle
        self.seed = seed

    def __repr__(self) -> str:
        return (f"IndexSampler(num_records={self.num_records}, shard_options=NoSharding("
                "shard_index=0, shard_count=1, drop_remainder=False), "
                f"shuffle={self.shuffle}, num_epochs=1, seed={self.seed})")

    def record_keys(self) -> np.ndarray:
        if self.shuffle:
            return shuffled_indices(self.num_records, self.seed)
        return np.arange(self.num_records)


def source_repr(dataset) -> str:
    """JAX's ``_StableSource`` repr, which Grain writes into the state."""
    return f"{type(dataset).__name__}(len={len(dataset)})"


def position_state(consumed: int, worker_count: int, sampler: IndexSampler,
                   source: str) -> bytes:
    """Grain's ``DataLoaderIterator.get_state()`` after ``consumed`` records:
    worker ``i`` of ``w`` produced the records at positions ``i, i + w, …``,
    and ``last_seen_indices[i]`` is the last position it handed over (``i -
    w`` before its first); with no worker, one entry for the main process."""
    w = worker_count
    if w == 0:
        last_seen, last_worker = {"0": consumed - 1}, -1
    else:
        last_seen = {str(i): i - w + w * ((consumed - i + w - 1) // w) for i in range(w)}
        last_worker = (consumed - 1) % w if consumed else -1
    state = {"version": STATE_VERSION, "last_seen_indices": last_seen,
             "last_worker_index": last_worker, "worker_count": w,
             "sampler": repr(sampler), "data_source": source}
    return json.dumps(state, indent=4).encode()


def consumed_records(state: Dict) -> int:
    """The records taken before ``state`` (Grain's ``set_state`` restarts
    each worker past its last seen position)."""
    w, last_seen = state["worker_count"], state["last_seen_indices"]
    if w == 0:
        return last_seen["0"] + 1
    return sum((last_seen[str(i)] + w - i) // w for i in range(w))


class GrainDataLoader(DataLoader):
    """``DataLoader``'s interface (``__len__``, ``set_epoch``, iteration over
    collated batches) with Grain's order and a mid-epoch position."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, num_workers: int = 4,
                 drop_last: bool = False, seed: int = 0, prefetch: int = 2):
        super().__init__(dataset, batch_size, shuffle=shuffle, num_workers=num_workers,
                         drop_last=drop_last, seed=seed, prefetch=prefetch)
        self.worker_count = num_workers         # Grain's processes; reads take ≥ 1 thread
        self._live: Optional[List] = None       # [sampler, consumed] of the last iterator
        self._pending_state: Optional[bytes] = None

    def sampler(self) -> IndexSampler:
        return IndexSampler(len(self.dataset), shuffle=self.shuffle,
                            seed=self.seed * SEED_MULTIPLIER + self.epoch)

    def __iter__(self) -> Iterator[Dict]:
        sampler = self.sampler()
        start = 0
        if self._pending_state is not None:
            # mid-epoch resume: the checkpointed position (same epoch and
            # seed, which set_epoch restores)
            state = json.loads(self._pending_state.decode())
            self._validate(state, sampler)
            start = consumed_records(state)
            self._pending_state = None
        keys = sampler.record_keys()
        n, b = len(keys), self.batch_size
        batches = [keys[s:s + b] for s in range(start, n, b)]
        if self.drop_last and batches and len(batches[-1]) < b:
            batches.pop()
        live = [sampler, start]
        self._live = live
        return self._iter_positions(live, batches, n)

    def _iter_positions(self, live: List, batches: List[np.ndarray], n: int) -> Iterator[Dict]:
        it = self._iter_batches(batches)
        try:
            for idx, batch in zip(batches, it):
                live[1] += len(idx)
                yield batch
            live[1] = n
        finally:
            it.close()       # an abandoned iterator stops its threads

    def _validate(self, state: Dict, sampler: IndexSampler) -> None:
        """Grain's ``DataLoader._validate_state``, message for message."""
        if state["worker_count"] != self.worker_count:
            raise ValueError(
                "Worker count in checkpoint does not match dataloader worker count.\n"
                f"worker count in checkpoint: {state['worker_count']}\n"
                f"worker count in dataloader: {self.worker_count}")
        if state["sampler"] != repr(sampler):
            raise ValueError(
                "Sampler in checkpoint does not match dataloader sampler.\n"
                f"sampler in checkpoint: {state['sampler']}\n"
                f"sampler in dataloader: {sampler!r}\n"
                "Grain uses `repr(sampler)` to validate the sampler, so you "
                "may need to implement a custom `__repr__`.")
        if state["data_source"] != source_repr(self.dataset):
            raise ValueError(
                "DataSource in checkpoint does not match datasource in dataloader.\n"
                f"data source in checkpoint: {state['data_source']}\n"
                f"data source in dataloader: {source_repr(self.dataset)}\n"
                "Grain uses `repr(data_source)` to validate the source, so you "
                "may need to implement a custom `__repr__`.")

    # --- the checkpointable-iterator surface
    def get_state(self) -> Optional[bytes]:
        """The position of the live iterator (the last one made), or None
        before the first."""
        if self._live is None:
            return None
        sampler, consumed = self._live
        return position_state(consumed, self.worker_count, sampler, source_repr(self.dataset))

    def set_state(self, state: bytes) -> None:
        """Defers ``state`` to the next ``__iter__``: the restore runs before
        the epoch loop makes its iterator, and an iterator made earlier and
        abandoned must not take the position."""
        self._pending_state = state


def make_loader(kind: str, dataset, batch_size: int, **kw):
    """``'grain'``: ``GrainDataLoader``; anything else the threaded
    ``DataLoader`` (JAX ``grain_loader.py:119-126``)."""
    if kind == "grain":
        return GrainDataLoader(dataset, batch_size, **kw)
    return DataLoader(dataset, batch_size, **kw)
