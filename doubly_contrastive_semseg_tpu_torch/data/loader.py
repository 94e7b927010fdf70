"""Threaded prefetching data loader — port of the JAX package's
``data/loader.py`` (``collate``, ``DataLoader``), plus ``to_device``.

Replaces the reference's ``torch.utils.data.DataLoader(num_workers=4,
collate_fn=custom_collate)`` (``utils/init_trainer.py:86-93``) with the JAX
package's design: a thread pool (numpy and the resampling release the GIL
for their heavy loops, and threads need no fork), per-sample futures over a
sliding window of upcoming batches, so throughput scales with
``num_workers`` and the pool is never idle at a batch boundary, and a
bounded prefetch queue ahead of the device step. Batches are numpy arrays;
``to_device`` moves one to the card.

Collation handles the two-crop contrastive batches as the trainer does
(``trainer.py:66-72``): the two views' images are written into one
``(2B, H, W, 3)`` array; labels, weights and weather come from view 0.
"""

from __future__ import annotations

import math
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

ARRAY_KEYS = ("left", "right", "label", "weather", "label_distance_weight", "disp")
META_KEYS = ("left_name", "frame_name", "target_size", "target_size_feats")


def _stack(samples: List[Dict], skip: tuple = ()) -> Dict:
    out: Dict = {}
    for k in ARRAY_KEYS:
        if k not in skip and k in samples[0] and samples[0][k] is not None:
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
    for k in META_KEYS:
        if k in samples[0]:
            out[k] = [s[k] for s in samples]
    return out


def collate(samples: List) -> Dict:
    """Batch a list of samples; two-crop pairs become one 2B-image batch.

    The two-crop image batch is written once into its final
    ``(2B, H, W, 3)`` buffer rather than stacked and then concatenated: the
    images are by far the largest arrays of the batch, and collate runs
    serialised on the producer thread.
    """
    if isinstance(samples[0], (list, tuple)):
        b = len(samples)
        img0 = np.asarray(samples[0][0]["left"])
        left = np.empty((2 * b,) + img0.shape, img0.dtype)
        for i, s in enumerate(samples):
            left[i] = s[0]["left"]
            left[b + i] = s[1]["left"]
        out = _stack([s[0] for s in samples], skip=("left",))
        out["left"] = left
        return out
    return _stack(samples)


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = False,
                 seed: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _batch_indices(self) -> List[np.ndarray]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 1_000_003 + self.epoch)
            rng.shuffle(idx)
        batches = []
        for s in range(0, n, self.batch_size):
            b = idx[s:s + self.batch_size]
            if self.drop_last and len(b) < self.batch_size:
                continue
            batches.append(b)
        return batches

    def __iter__(self) -> Iterator[Dict]:
        return self._iter_batches(self._batch_indices())

    def _iter_batches(self, batches: List[np.ndarray]) -> Iterator[Dict]:
        """Collated batches of the samples at ``batches``' indices, in
        order, read by the thread pool."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: List[BaseException] = []
        # abandoned-iterator shutdown: without this, a consumer that breaks
        # early (or a bare next(iter(loader))) leaves the producer blocked on
        # q.put forever, leaking the worker pool + prefetched batches
        stop = threading.Event()
        pending: deque = deque()  # [futures] per in-flight batch

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # Cross-batch pipelining: per-sample futures over a sliding window
            # of upcoming batches, so the pool is never idle at a batch
            # boundary. The window keeps >= 2 x num_workers samples in
            # flight; with one worker, submission order is execution order.
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    window = max(self.prefetch + 1,
                                 math.ceil(2 * self.num_workers / max(1, self.batch_size)))
                    batch_iter = iter(batches)

                    def submit_next() -> None:
                        b = next(batch_iter, None)
                        if b is not None:
                            pending.append(
                                [pool.submit(self.dataset.__getitem__, i) for i in b])

                    for _ in range(window):
                        submit_next()
                    while pending:
                        futs = pending.popleft()
                        samples = [f.result() for f in futs]
                        if stop.is_set():
                            break
                        batch = collate(samples)
                        submit_next()  # refill before blocking on the queue
                        if not _put(batch):
                            break
                    for futs in pending:  # abandoned: drop unstarted work
                        for f in futs:
                            f.cancel()
            except BaseException as e:  # surfaced on the consumer side
                for futs in pending:
                    for f in futs:
                        f.cancel()
                err.append(e)
            finally:
                _put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # runs on GeneratorExit (close/GC of an abandoned iterator) too;
            # cancelling the samples not yet started lets the process exit
            # once the workers finish the ones they hold (tuple() copies the
            # deque without releasing the GIL)
            stop.set()
            for futs in tuple(pending):
                for f in futs:
                    f.cancel()


def to_device(batch: Dict, device, class_weight=None) -> Dict:
    """A host batch → tensors on ``device``, the counterpart of the JAX
    trainer's ``_device_batch`` (``parallel/mesh.py::shard_batch`` at world
    size 1). Every array moves: to the card as a pinned-memory copy that does
    not block the host. List metadata (names, target sizes) stays on the host
    as it is. ``class_weight`` (C,), when given, joins the batch as float32."""
    device = torch.device(device)
    pin = device.type == "cuda"
    out: Dict = {}
    for k, v in batch.items():
        if v is None:
            continue
        if isinstance(v, (list, tuple)):
            out[k] = v
            continue
        t = torch.as_tensor(np.asarray(v))
        if pin:
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=pin)
    if class_weight is not None:
        out["class_weight"] = torch.as_tensor(class_weight, dtype=torch.float32).to(device)
    return out
