"""The port's tracing module (``utils/profiling.py``): ``span`` and ``count``
off and under a recording ``torch.profiler``, the ``dcss.*`` spans of the
serving entry, the models, the train step and the data layer as the CPU
profiler's trace holds them, and outputs bit-identical with tracing on and
off."""

import copy
import json

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from doubly_contrastive_semseg_tpu_torch import Config, build_model, make_serving_fn
from doubly_contrastive_semseg_tpu_torch.data.device_augment import apply_augment
from doubly_contrastive_semseg_tpu_torch.data.loader import to_device
from doubly_contrastive_semseg_tpu_torch.train import (TrainState, build_optimizer,
                                                        make_train_step)
from doubly_contrastive_semseg_tpu_torch.utils import profiling

B, H, W, C = 2, 64, 128, 19
CRITERION = "supcon_pixelcontrast_focal"


def _spans(prof, tmp_path):
    """The ``dcss.*`` user annotations of the profiler's Chrome trace, as
    (name, start µs, end µs) in order of start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
           for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e["name"].startswith("dcss.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _image(seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8))


def _model(name="resnet18", **kw):
    cfg = Config(compute_dtype="float32", dataset="synthetic", model=name, **kw).finalize()
    return cfg, build_model(cfg, device="cpu", seed=0)


@pytest.fixture(scope="module")
def rn18():
    """(config, model) of a SwiftNet-RN18 with the SupCon head, drawn once:
    each test takes a copy."""
    return _model(criterion=CRITERION, reference_rng=True)


def _recorded(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_span_and_count_are_noops_without_a_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(autograd_profiler, "record_function",
                        lambda name: calls.append(name))
    assert not autograd_profiler._is_profiler_enabled
    first, second = profiling.span("dcss.serve"), profiling.span("dcss.head")
    assert first is second
    with first:
        profiling.count("data.pinned_bytes", 7)
    assert calls == []


def test_the_flag_span_reads_follows_the_profiler():
    assert autograd_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert isinstance(profiling.span("dcss.x"), autograd_profiler.record_function)
    assert autograd_profiler._is_profiler_enabled is False
    assert not isinstance(profiling.span("dcss.x"), autograd_profiler.record_function)


def test_serving_a_pyramid_model_nests_its_layer_spans(tmp_path, rn18):
    serve = make_serving_fn(copy.deepcopy(rn18[1]), device="cpu")
    _, prof = _recorded(lambda: serve(_image()))
    spans = _spans(prof, tmp_path)
    (outer,) = _named(spans, "dcss.serve")
    inner = [s for s in spans if s is not outer]
    assert [s[0] for s in inner] == (["dcss.input"] + ["dcss.stem", "dcss.trunk"] * 3
                                     + ["dcss.decoder", "dcss.head"])
    assert all(_inside(s, outer) for s in inner)
    # the layers follow one another and do not overlap
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))


@pytest.mark.parametrize("name,layers", [
    ("deeplabv3plus_mobilenet", ["dcss.input", "dcss.trunk", "dcss.decoder"]),
    ("enet", [])])
def test_the_generic_serving_branch_spans_its_head(tmp_path, name, layers):
    _, model = _model(name)
    serve = make_serving_fn(model, device="cpu")
    _, prof = _recorded(lambda: serve(_image()))
    spans = _spans(prof, tmp_path)
    (outer,) = _named(spans, "dcss.serve")
    heads = _named(spans, "dcss.head")
    assert heads and all(_inside(h, outer) for h in heads)
    # DeepLab's layers and head span, then the serving argmax's head span
    assert [s[0] for s in spans if s is not outer and s[0] != "dcss.head"] == layers
    assert all(_inside(s, outer) for s in spans)


def _batch(seed=0, size=H):
    rng = np.random.default_rng(seed)
    label = rng.integers(0, C, (B, size, size)).astype(np.int32)
    label[:, :8, :8] = 255
    alphas = rng.uniform(0.05, 1.0, (B, size, size)).astype(np.float32)
    alphas[label == 255] = 0.0
    batch = {"left": rng.integers(0, 256, (2 * B, size, size, 3)).astype(np.uint8),
             "label": label, "label_distance_weight": alphas,
             "weather": rng.integers(0, 4, B).astype(np.int32),
             "class_weight": rng.uniform(0.5, 2.0, C).astype(np.float32)}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _train_program(rn18):
    cfg, model = rn18[0], copy.deepcopy(rn18[1])
    optimizer = build_optimizer(model, cfg, steps_per_epoch=4)
    return TrainState(model, optimizer), make_train_step(model, cfg, optimizer)


def test_a_train_step_spans_forward_loss_backward_optimizer(tmp_path, rn18):
    state, step = _train_program(rn18)
    _, prof = _recorded(lambda: step(state, _batch(), None))
    spans = _spans(prof, tmp_path)
    top = [s for s in spans if s[0] in ("dcss.forward", "dcss.loss", "dcss.backward",
                                        "dcss.optimizer", "dcss.allreduce")]
    assert [s[0] for s in top] == ["dcss.forward", "dcss.loss", "dcss.backward",
                                   "dcss.optimizer"]
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))
    loss = top[1]
    terms = [s[0] for s in spans if s[0].startswith("dcss.loss.")]
    assert terms == ["dcss.loss.supcon", "dcss.loss.pixel", "dcss.loss.seg"]
    assert all(_inside(s, loss) for s in spans if s[0].startswith("dcss.loss."))
    # the model's layer spans of the forward lie inside it
    forward = top[0]
    assert all(_inside(s, forward) for s in _named(spans, "dcss.input"))


def test_count_lands_in_the_chrome_trace(tmp_path):
    _, prof = _recorded(lambda: profiling.count("test.bytes", 4096))
    assert [s[0] for s in _spans(prof, tmp_path)] == ["dcss.count.test.bytes=4096"]


def test_to_device_spans_and_counts_what_it_pins(tmp_path):
    host = {"left": np.zeros((B, 8, 8, 3), np.uint8), "frame_name": ["a", "b"]}
    out, prof = _recorded(lambda: to_device(host, "cpu"))
    assert out["frame_name"] == ["a", "b"] and out["left"].shape == (B, 8, 8, 3)
    spans = _spans(prof, tmp_path)
    assert [s[0] for s in spans] == ["dcss.to_device", "dcss.count.data.pinned_bytes=0"]
    assert _inside(spans[1], spans[0])


def test_apply_augment_is_one_span(tmp_path):
    images = _image()
    labels = torch.randint(0, C, (B, H, W), dtype=torch.uint8)
    weather = torch.tensor([0, 1])
    box = torch.full((2, B), 32.0)
    zeros = torch.zeros((2, B))
    out, prof = _recorded(lambda: apply_augment(images, labels, weather, (zeros, zeros, box),
                                                crop=32, num_classes=C, use_gamma=True))
    assert out["left"].shape == (2 * B, 32, 32, 3)
    assert [s[0] for s in _spans(prof, tmp_path)] == ["dcss.augment"]


def _serve_outputs(rn18):
    serve = make_serving_fn(copy.deepcopy(rn18[1]), device="cpu")
    return lambda: [serve(_image(seed)) for seed in (0, 1)]


def _train_outputs(rn18):
    state, step = _train_program(rn18)
    model = state.model

    def run():
        metrics = [step(state, _batch(seed), torch.Generator().manual_seed(seed))
                   for seed in (0, 1)]
        return ([m[k] for m in metrics for k in sorted(m)]
                + [p.detach().clone() for p in model.parameters()])

    return run


@pytest.mark.parametrize("make", [_serve_outputs, _train_outputs], ids=["serve", "train"])
def test_outputs_are_bit_identical_with_tracing_on_and_off(make, rn18):
    off = make(rn18)()
    on, _ = _recorded(make(rn18))
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
