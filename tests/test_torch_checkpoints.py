"""The port's checkpoints (``train/checkpoints.py``) on the CPU.

A save → restore round trip with ``continue_training`` is bit for bit
(weights, BN statistics, Adam's moments and step counts, ``step``, the
groups' ``label``, ``base_lr`` and ``steps_per_epoch``); a weights-only
restore keeps a fresh optimizer and step; a restore merges by name and
shape; the ``.meta.json`` sidecar equals JAX's ``_meta`` for the same
inputs; a save that dies mid-write leaves the previous checkpoint whole.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from doubly_contrastive_semseg_tpu.train.checkpoints import _meta as jax_meta  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import Config, build_model  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.metrics import Evaluator  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.train import (CheckpointManager, TrainState,  # noqa: E402
                                                       build_optimizer, set_lr)
from doubly_contrastive_semseg_tpu_torch.train import checkpoints  # noqa: E402

CFG = dict(compute_dtype="float32", criterion="supcon_pixelcontrast_focal", train_semantic=True)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes at once,
    and torch's default of one thread a core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def trained_state(seed, policy="ADAM", steps=2, **cfg):
    """A CPU model and optimizer after ``steps`` updates of seeded gradients,
    with BN statistics changed too."""
    cfg = Config(optimizer_policy=policy, **{**CFG, **cfg})
    model = build_model(cfg, device="cpu", seed=seed)
    opt = build_optimizer(model, cfg, steps_per_epoch=5)
    gen = torch.Generator().manual_seed(seed)
    state = TrainState(model, opt)
    for _ in range(steps):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        set_lr(opt, cfg, state.step)
        opt.step()
        state.step += 1
    for name, buf in model.named_buffers():
        if buf.is_floating_point():
            buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    return cfg, state


@pytest.fixture(scope="module")
def saved():
    """An ADAM state after 2 updates; the tests below only read it."""
    return trained_state(0)[1]


def assert_same_optimizer(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert len(sa["param_groups"]) == len(sb["param_groups"])
    for ga, gb in zip(sa["param_groups"], sb["param_groups"]):
        assert ga == gb
    assert sa["state"].keys() == sb["state"].keys()
    for k in sa["state"]:
        for name, v in sa["state"][k].items():
            w = sb["state"][k][name]
            assert v.device == w.device and torch.equal(v, w), (k, name)


@pytest.mark.parametrize("policy", ["ADAM", "SGD"])
def test_round_trip_is_bit_for_bit(tmp_path, policy):
    cfg, saved = trained_state(0, policy)
    mgr = CheckpointManager(str(tmp_path / "checkpoints"))
    path = mgr.save("latest_checkpoint", saved, epoch=3, best_score=0.5, best_score_epoch=2)
    assert path == str(tmp_path / "checkpoints" / "latest_checkpoint")
    _, fresh = trained_state(1, policy, steps=0)
    restored, meta = mgr.restore(path, fresh, continue_training=True)
    assert restored is fresh and restored.step == saved.step == 2
    want, got = saved.model.state_dict(), restored.model.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype and torch.equal(want[k], got[k]), k
    assert_same_optimizer(saved.optimizer, restored.optimizer)
    labels = [g["label"] for g in restored.optimizer.param_groups]
    assert labels == (["random_init", "fine_tune"] if policy == "ADAM"
                      else ["sgd_base", "sgd_semantic"])
    assert all(g["steps_per_epoch"] == 5 and g["base_lr"] > 0
               for g in restored.optimizer.param_groups)
    assert meta == {"epoch": 3, "num_iter": 2, "score": {}, "best_score": 0.5,
                    "best_score_epoch": 2, "mid_epoch": False}
    # the next update of both optimizers is the same
    for state in (saved, restored):
        for p in state.model.parameters():
            p.grad = torch.ones_like(p)
        set_lr(state.optimizer, cfg, state.step)
        state.optimizer.step()
    for (k, a), b in zip(saved.model.named_parameters(), restored.model.parameters()):
        assert torch.equal(a, b), k


def test_weights_only_restore_keeps_a_fresh_optimizer_and_step(tmp_path, saved):
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save("score_best_checkpoint", saved, epoch=0)
    _, fresh = trained_state(1, steps=0)
    before = fresh.optimizer.state_dict()
    restored, _ = mgr.restore(path, fresh, continue_training=False)
    assert restored.step == 0 and not restored.optimizer.state_dict()["state"]
    assert restored.optimizer.state_dict()["param_groups"] == before["param_groups"]
    for k, v in saved.model.state_dict().items():
        assert torch.equal(v, restored.model.state_dict()[k]), k


def test_partial_restore_by_name_and_shape(tmp_path, saved):   # projection, 19 classes
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save("latest_checkpoint", saved, epoch=0)
    cfg = Config(compute_dtype="float32", num_classes=20)        # no projection
    model = build_model(cfg, device="cpu", seed=5)
    own = {k: v.clone() for k, v in model.state_dict().items()}
    mgr.restore(path, TrainState(model, build_optimizer(model, cfg, 5)))
    got, want = model.state_dict(), saved.model.state_dict()
    for k, v in got.items():
        if k.startswith("net.segmentation.conv."):               # (20, ...) vs (19, ...)
            assert torch.equal(v, own[k]), k
        else:
            assert torch.equal(v, want[k]), k
    assert not any(k.startswith("projection.") for k in got)


def test_meta_sidecar_equals_jax_meta(tmp_path, saved):
    ev = Evaluator(19, 4)
    rng = np.random.default_rng(0)
    ev.add_batch(rng.integers(0, 19, (2, 8, 8)), rng.integers(0, 19, (2, 8, 8)))
    score = ev.get_results()
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save("score_best_checkpoint", saved, 7, score, np.float64(0.25), 6)
    with open(path + ".meta.json") as f:
        got = json.load(f)
    want = jax_meta(7, SimpleNamespace(step=np.int32(2)), score, np.float64(0.25), 6,
                    mid_epoch=False)
    assert got == json.loads(json.dumps(want)) and list(got) == list(want)
    assert got == checkpoints._meta(7, 2, score, 0.25, 6)
    # the payload carries the same meta
    _, meta = mgr.restore(path, trained_state(1, steps=0)[1])
    assert meta == got


def test_a_save_killed_mid_write_leaves_the_previous_checkpoint(tmp_path, monkeypatch, saved):
    first = saved
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save("latest_checkpoint", first, epoch=0)
    with open(path, "rb") as f:
        first_bytes = f.read()
    with open(path + ".meta.json") as f:
        first_meta = f.read()
    _, second = trained_state(1, steps=0)

    def die(fd):                      # the bytes are in the temporary file
        raise KeyboardInterrupt("killed during the save")

    monkeypatch.setattr(checkpoints.os, "fsync", die)
    with pytest.raises(KeyboardInterrupt):
        mgr.save("latest_checkpoint", second, epoch=1)
    monkeypatch.undo()
    with open(path, "rb") as f:
        assert f.read() == first_bytes
    with open(path + ".meta.json") as f:
        assert f.read() == first_meta
    assert sorted(os.listdir(tmp_path)) == ["latest_checkpoint", "latest_checkpoint.meta.json"]
    restored, meta = mgr.restore(path, trained_state(2, steps=0)[1], continue_training=True)
    assert restored.step == 2 and meta["epoch"] == 0
    for k, v in first.model.state_dict().items():
        assert torch.equal(v, restored.model.state_dict()[k]), k
