"""Runs of a cell on the CPU at a tiny size with the timed path broken
underneath: the check must read ``correct`` false for each fault the cell
can have (a step that leaves the state unchanged; half of the batch left
out, the mean taken over the rest; an answer altered where it is
produced). The limits are the cells' own."""

import pytest
import torch

from perfbench.drivers import serve, train_step
from perfbench.tests.tiny import cell, cells, threads

threads()


def run_cpu(name, **sizes):
    c, config, mix = cell(name)
    mix.update(sizes)
    drv = train_step if mix["driver"] == "train_step" else serve
    return drv.run(c, config, mix, seed=2 ** 31 + 7, seconds=0.5, trace=False, device="cpu")


def frozen_step(real):
    def make(model, cfg, optimizer):
        from doubly_contrastive_semseg_tpu_torch.train.steps import compute_loss

        def step(state, batch, generator):
            with torch.no_grad():
                _, comps, _ = compute_loss(model, cfg, batch, generator)
            return comps
        return step
    return make


def half_batch_step(real):
    def make(model, cfg, optimizer):
        inner = real(model, cfg, optimizer)

        def step(state, batch, generator):
            b = batch["label"].shape[0]
            h = b // 2
            half = dict(batch)
            for k in ("label", "label_distance_weight", "weather"):
                half[k] = batch[k][:h]
            half["left"] = torch.cat([batch["left"][:h], batch["left"][b:b + h]])
            return inner(state, half, generator)
        return step
    return make


@pytest.mark.parametrize("name", cells("train_step"))
@pytest.mark.parametrize("fault", [frozen_step, half_batch_step], ids=["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(monkeypatch, name, fault):
    monkeypatch.setattr(train_step, "make_train_step", fault(train_step.make_train_step))
    # four frames a batch, so that half a batch still has two for the
    # batch statistics of a pooled 1x1 map (DeepLab's ASPP)
    rec = run_cpu(name, batch=4, pool=8)
    assert rec.correct is False, rec.numbers


def altered_answers(real):
    def make(model, device="cuda"):
        inner = real(model, device=device)

        def fn(image):
            labels = inner(image).clone()
            labels[:, labels.shape[1] // 2, labels.shape[2] // 2] += 1
            labels %= 19
            return labels
        return fn
    return make


@pytest.mark.parametrize("name", cells("serve"))
def test_an_altered_answer_is_not_correct(monkeypatch, name):
    monkeypatch.setattr(serve, "make_serving_fn", altered_answers(serve.make_serving_fn))
    rec = run_cpu(name)
    assert rec.correct is False, rec.numbers
