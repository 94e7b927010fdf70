"""The port's ``--loader grain`` (``data/index_shuffle.py``,
``data/grain_loader.py``, the checkpoint sidecar) against Grain and the JAX
package's ``GrainDataLoader`` on the CPU.

- ``shuffled_indices`` / ``index_shuffle`` equal Grain's compiled
  ``index_shuffle`` permutation for permutation, n = 65,537 included (its
  16-bit block drops the last index's top bit, so Grain reads record 0's
  permutation image twice there, and so does the port);
- ``IndexSampler``'s errors are Grain's, message for message;
- two epochs of batches equal JAX's ``GrainDataLoader`` (``num_workers=0``)
  byte for byte, and the ``get_state()`` bytes equal Grain's at every
  position; the state of a multi-worker loader has the values a 3-process
  Grain loader reported (recorded below);
- a mid-epoch position round-trips through ``CheckpointManager``'s sidecar,
  survives an abandoned iterator, resumes the uninterrupted epoch's
  remaining batches and is cleared by an epoch-end save; a state of another
  sampler or source is refused as Grain refuses it.
"""

import gc
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
grain = pytest.importorskip("grain.python")

from grain._src.python.experimental.index_shuffle.python import (  # noqa: E402
    index_shuffle_module as grain_shuffle)

from doubly_contrastive_semseg_tpu.data import SyntheticDataset as JaxSynthetic  # noqa: E402
from doubly_contrastive_semseg_tpu.data import TwoCropTransform as JaxTwoCrop  # noqa: E402
from doubly_contrastive_semseg_tpu.data.grain_loader import (  # noqa: E402
    GrainDataLoader as JaxGrainLoader)
from doubly_contrastive_semseg_tpu.data.transforms import Compose as JaxCompose  # noqa: E402
from doubly_contrastive_semseg_tpu.data.transforms import ToArrays as JaxToArrays  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data import (  # noqa: E402
    Compose, SyntheticDataset, ToArrays, TwoCropTransform)
from doubly_contrastive_semseg_tpu_torch.data.grain_loader import (  # noqa: E402
    GrainDataLoader, IndexSampler, make_loader, position_state)
from doubly_contrastive_semseg_tpu_torch.data.index_shuffle import (  # noqa: E402
    index_shuffle, shuffled_indices)
from doubly_contrastive_semseg_tpu_torch.data.loader import DataLoader  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.train.checkpoints import CheckpointManager  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.train.state import TrainState  # noqa: E402

SEEDS = (0, 5, 1_000_004, 2**32 - 1)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", [1, 2, 3, 10, 97, 2975, 65537])
def test_shuffle_equals_grains_compiled_permutation(n):
    for seed in SEEDS:
        want = np.array([grain_shuffle.index_shuffle(i, max_index=n - 1, seed=seed, rounds=4)
                         for i in range(n)])
        np.testing.assert_array_equal(shuffled_indices(n, seed), want, err_msg=f"seed {seed}")
        for i in (0, n // 2, n - 1):
            assert index_shuffle(i, n - 1, seed, 4) == want[i]
    if n == 65537:      # the 16-bit block: the last position aliases position 0
        assert want[-1] == want[0] and len(set(want)) == n - 1
    else:
        assert sorted(want) == list(range(n))


def test_shuffle_other_rounds_and_wide_blocks():
    """Six rounds, and an index beyond max_index (Grain walks it too), and
    the 42-bit block of a large max_index, value for value."""
    for args in [(3, 9, 5, 6), (10, 9, 0, 4), (12345, 2**40, 77, 4), (7, 2**33 + 5, 9, 8)]:
        assert index_shuffle(*args) == grain_shuffle.index_shuffle(*args), args


def test_errors_equal_grains():
    cases = [dict(num_records=0, shuffle=True, seed=1),
             dict(num_records=5, shuffle=True, seed=2**32),
             dict(num_records=5, shuffle=False, seed=-1),
             dict(num_records=5, shuffle=True, seed=None),
             dict(num_records=5, shuffle=True, seed=1.5)]
    for kw in cases:
        with pytest.raises((ValueError, TypeError)) as want:
            grain.IndexSampler(shard_options=grain.NoSharding(), num_epochs=1, **kw)
        with pytest.raises(want.type) as got:
            IndexSampler(**kw)
        assert str(got.value) == str(want.value), kw
    # the compiled function refuses a seed outside 32 bits as a TypeError
    for seed in (2**32, -1):
        with pytest.raises(TypeError):
            grain_shuffle.index_shuffle(0, 9, seed, 4)
        with pytest.raises(TypeError):
            index_shuffle(0, 9, seed, 4)
    # JAX's loader: --shuffle from random_seed 4295 (seed * 1_000_003 > 2**32)
    with pytest.raises(ValueError, match="32-bit"):
        iter(GrainDataLoader(SyntheticDataset(size=4, image_hw=(8, 8)), 2, shuffle=True,
                             seed=4295, num_workers=0))
    assert repr(IndexSampler(7, shuffle=True, seed=3)) == repr(grain.IndexSampler(
        num_records=7, shard_options=grain.NoSharding(), shuffle=True, num_epochs=1, seed=3))


def _pair(shuffle, drop_last, two_crop, size=9, batch=4, seed=5):
    t, jt = Compose([ToArrays()]), JaxCompose([JaxToArrays()])
    if two_crop:
        t, jt = TwoCropTransform(t), JaxTwoCrop(jt)
    port = GrainDataLoader(SyntheticDataset(size=size, image_hw=(32, 40), transform=t), batch,
                           shuffle=shuffle, drop_last=drop_last, seed=seed, num_workers=0)
    jax = JaxGrainLoader(JaxSynthetic(size=size, image_hw=(32, 40), transform=jt), batch,
                         shuffle=shuffle, drop_last=drop_last, seed=seed, num_workers=0)
    return port, jax


def _equal_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], list):
                assert g[k] == w[k], k
            else:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                assert g[k].tobytes() == w[k].tobytes(), k


@pytest.mark.parametrize("shuffle,drop_last,two_crop",
                         [(True, True, True), (False, False, False), (True, False, False)])
def test_two_epochs_of_batches_and_states_equal_jax(shuffle, drop_last, two_crop):
    port, jax = _pair(shuffle, drop_last, two_crop)
    assert port.get_state() is None and jax.get_state() is None
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax.set_epoch(epoch)
        assert len(port) == len(jax)
        p_it, j_it = iter(port), iter(jax)
        got, want = [], []
        for j_batch in j_it:
            got.append(next(p_it))
            want.append(j_batch)
            assert port.get_state() == jax.get_state()     # same bytes, same position
        with pytest.raises(StopIteration):
            next(p_it)
        assert port.get_state() == jax.get_state()         # an epoch read to its end
        _equal_batches(got, want)
        if two_crop:
            assert got[0]["left"].shape == (8, 32, 40, 3) and got[0]["label"].shape == (4, 32, 40)
    state = json.loads(port.get_state())
    assert sorted(state) == ["data_source", "last_seen_indices", "last_worker_index",
                             "sampler", "version", "worker_count"]
    assert state["data_source"] == "SyntheticDataset(len=9)"


def test_multi_worker_state_has_grains_values():
    """Grain 0.2.15 with ``worker_count=3`` over 10 shuffled records (seed
    5), read one record at a time, reported these ``last_seen_indices`` and
    ``last_worker_index`` after each record (workers take positions in
    turns; -3, -2, -1 before any)."""
    grain_reported = [
        ({"0": -3, "1": -2, "2": -1}, -1), ({"0": 0, "1": -2, "2": -1}, 0),
        ({"0": 0, "1": 1, "2": -1}, 1), ({"0": 0, "1": 1, "2": 2}, 2),
        ({"0": 3, "1": 1, "2": 2}, 0), ({"0": 3, "1": 4, "2": 2}, 1),
        ({"0": 3, "1": 4, "2": 5}, 2), ({"0": 6, "1": 4, "2": 5}, 0),
        ({"0": 6, "1": 7, "2": 5}, 1), ({"0": 6, "1": 7, "2": 8}, 2),
        ({"0": 9, "1": 7, "2": 8}, 0)]
    sampler = IndexSampler(10, shuffle=True, seed=5)
    for consumed, (seen, last) in enumerate(grain_reported):
        state = json.loads(position_state(consumed, 3, sampler, "Src(len=10)"))
        assert (state["last_seen_indices"], state["last_worker_index"]) == (seen, last)
        assert state["worker_count"] == 3 and state["version"] == 2
    # the order Grain gave at those positions
    assert shuffled_indices(10, 5).tolist() == [4, 0, 5, 3, 7, 9, 8, 1, 2, 6]
    # a state of 3 workers resumes at its position (batches of 2: 2 taken)
    dl = GrainDataLoader(SyntheticDataset(size=10, image_hw=(8, 8)), 2, shuffle=True,
                         seed=0, num_workers=3)
    dl.seed, dl.epoch = 0, 5     # sampler seed 5
    full = [b["left_name"] for b in dl]
    dl.set_state(position_state(4, 3, dl.sampler(), "SyntheticDataset(len=10)"))
    assert [b["left_name"] for b in dl] == full[2:]


def _tiny_state():
    model = torch.nn.Linear(2, 1)
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=1e-3))


def test_mid_epoch_resume_through_the_checkpoint_sidecar(tmp_path):
    def make():
        ds = SyntheticDataset(size=12, image_hw=(16, 16), transform=Compose([ToArrays()]))
        dl = GrainDataLoader(ds, batch_size=2, shuffle=True, drop_last=True, seed=3,
                             num_workers=0)
        dl.set_epoch(2)
        return dl

    full = list(make())                      # the uninterrupted epoch: 6 batches
    dl1 = make()
    it = iter(dl1)
    for _ in range(2):                       # batches 0 and 1 handed out
        next(it)
    state = dl1.get_state()
    assert json.loads(state)["last_seen_indices"] == {"0": 3}
    it.close()

    ts = _tiny_state()
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save("rescue_checkpoint", ts, epoch=2, loader_state=state)
    with open(path + ".loader_state", "rb") as f:
        assert f.read() == state
    with open(path + ".meta.json") as f:
        assert json.load(f)["mid_epoch"] is True
    _, meta = mgr.restore(path, _tiny_state(), continue_training=True)
    assert meta["mid_epoch"] is True and meta["loader_state"] == state
    _, weights_only = mgr.restore(path, _tiny_state(), continue_training=False)
    assert "loader_state" not in weights_only

    dl2 = make()                             # a fresh process's loader
    next(iter(dl2))                          # an iterator made and abandoned first
    dl2.set_state(meta["loader_state"])      # applied at the next __iter__
    resumed = list(dl2)
    assert len(resumed) == len(full) - 2
    _equal_batches(resumed, full[2:])

    # an epoch-end save without a position clears the sidecar
    mgr.save("rescue_checkpoint", ts, epoch=3)
    _, meta2 = mgr.restore(path, _tiny_state(), continue_training=True)
    assert meta2["mid_epoch"] is False and "loader_state" not in meta2
    assert not (tmp_path / "rescue_checkpoint.loader_state").exists()


def test_a_state_of_another_sampler_or_source_is_refused():
    ds = SyntheticDataset(size=8, image_hw=(8, 8))
    dl = GrainDataLoader(ds, 2, shuffle=True, seed=1, num_workers=0)
    it = iter(dl)
    next(it)
    state = dl.get_state()
    it.close()
    for other, what in ((GrainDataLoader(ds, 2, shuffle=True, seed=2, num_workers=0), "Sampler"),
                        (GrainDataLoader(SyntheticDataset(size=10, image_hw=(8, 8)), 2,
                                         shuffle=True, seed=1, num_workers=0), "Sampler"),
                        (GrainDataLoader(ds, 2, shuffle=True, seed=1, num_workers=2),
                         "Worker count")):
        other.set_state(state)
        with pytest.raises(ValueError, match=what):
            iter(other)
    renamed = json.loads(state)
    renamed["data_source"] = "ACDC(len=8)"
    dl.set_state(json.dumps(renamed).encode())
    with pytest.raises(ValueError, match="DataSource in checkpoint"):
        iter(dl)


def test_an_abandoned_iterator_stops_its_threads_and_make_loader_routes():
    before = set(threading.enumerate())
    dl = GrainDataLoader(SyntheticDataset(size=16, image_hw=(8, 8)), 2, shuffle=True,
                         num_workers=3)
    next(iter(dl))
    gc.collect()

    def started():
        return [t for t in threading.enumerate() if t not in before and t.is_alive()]

    deadline = time.time() + 10
    while started() and time.time() < deadline:
        time.sleep(0.05)
    assert not started()
    ds = SyntheticDataset(size=4, image_hw=(8, 8))
    assert type(make_loader("grain", ds, 2)) is GrainDataLoader
    assert type(make_loader("thread", ds, 2, shuffle=True)) is DataLoader
