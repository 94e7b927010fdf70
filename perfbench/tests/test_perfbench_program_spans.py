"""The readers of the program's spans and counts on a hand-built Chrome
trace: nested ``dcss.*`` spans, kernels tied to their launches by
correlation id, a sync inside the program's spans and one outside them,
and two counts."""

import json

import pytest

from perfbench.harness import manifest, trace
from perfbench.harness.record import Record

ITERATIONS = 2


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _runtime(name, ts, corr=None):
    e = {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 2}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _kernel(corr, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


# (span, launch time, kernel µs): one launch in each layer's span, one
# outside every span of the program
LAUNCHES = [("dcss.input", 20, 100), ("dcss.stem", 60, 30), ("dcss.trunk", 110, 400),
            ("dcss.decoder", 210, 200), ("dcss.head", 260, 60), ("dcss.forward", 420, 800),
            ("dcss.loss.seg", 520, 300), ("dcss.backward", 620, 1600),
            ("dcss.to_device", 720, 50), (None, 950, 5000)]
SPANS = [_span("perfbench.window", 0, 1000),
         _span("dcss.serve", 10, 290), _span("dcss.input", 15, 40), _span("dcss.stem", 55, 40),
         _span("dcss.trunk", 100, 100), _span("dcss.decoder", 205, 45),
         _span("dcss.head", 255, 40),
         _span("dcss.forward", 400, 100), _span("dcss.loss", 500, 100),
         _span("dcss.loss.seg", 510, 50), _span("dcss.backward", 600, 100),
         _span("dcss.to_device", 700, 100),
         _span("dcss.count.data.pinned_bytes=1000000", 730, 0),
         _span("dcss.count.data.pinned_bytes=3000000", 740, 0)]


def _events():
    events = list(SPANS)
    for corr, (_, at, dur) in enumerate(LAUNCHES):
        events += [_runtime("cudaLaunchKernel", at, corr), _kernel(corr, 2000 + 10 * corr, dur)]
    # a sync inside the program's spans, and the benchmark's own outside them
    events += [_runtime("cudaStreamSynchronize", 30), _runtime("cudaEventSynchronize", 900)]
    return events


@pytest.fixture
def traced(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    return trace.read_chrome_trace(path, ITERATIONS)


def _rec(kind, tr):
    rec = Record(kind, {"name": "cell"}, {}, {})
    rec.trace = tr
    return rec


def _ms(*spans):
    """Device ms an iteration of the launches in ``spans``."""
    return sum(dur for name, _, dur in LAUNCHES if name in spans) * 1e-3 / ITERATIONS


@pytest.mark.parametrize("name,kind,want", [
    ("serve.input_ms", "serve", _ms("dcss.input")),
    ("serve.trunk_ms", "serve", _ms("dcss.trunk")),
    ("serve.decoder_ms", "serve", _ms("dcss.decoder")),
    ("serve.head_ms", "serve", _ms("dcss.head")),
    ("serve.input_ms.r101", "serve", _ms("dcss.input")),
    ("serve.head_ms.r101", "serve", _ms("dcss.head")),
    ("train.forward_ms", "train", _ms("dcss.forward")),
    ("train.loss_ms", "train", _ms("dcss.loss.seg")),
    ("train.backward_ms", "train", _ms("dcss.backward")),
    ("serve.syncs", "serve", 1 / ITERATIONS),
    ("serve.syncs.r101", "serve", 1 / ITERATIONS),
    ("train.syncs", "train", 1 / ITERATIONS),
    ("train.pinned_mb", "train", 4.0 / ITERATIONS)])
def test_reader_values(traced, name, kind, want):
    assert manifest.metric_reader(name)(_rec(kind, traced)) == pytest.approx(want)


def test_the_benchmarks_own_sync_is_left_out(traced):
    """Both syncs are in the trace; the reader counts the program's one."""
    names = [n for cat, n, _, _ in traced.host if cat == "cuda_runtime"]
    assert "cudaEventSynchronize" in names and "cudaStreamSynchronize" in names
    assert manifest.metric_reader("serve.syncs")(_rec("serve", traced)) == 1 / ITERATIONS


@pytest.mark.parametrize("name", ["serve.input_ms", "serve.syncs", "train.forward_ms",
                                  "train.syncs", "train.pinned_mb"])
def test_nothing_to_read_without_the_programs_spans(tmp_path, name):
    """A program without the spans and counts (the parent of the change
    that adds them) gives each reader nothing: None, no error."""
    events = [e for e in _events() if not e["name"].startswith("dcss.")]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = trace.read_chrome_trace(path, ITERATIONS)
    kind = name.split(".")[0]
    assert manifest.metric_reader(name)(_rec(kind, tr)) is None


@pytest.mark.parametrize("name", ["serve.head_ms", "serve.syncs", "train.loss_ms",
                                  "train.pinned_mb"])
def test_a_reader_of_the_other_kind_reads_nothing(traced, name):
    other = "train" if name.startswith("serve") else "serve"
    assert manifest.metric_reader(name)(_rec(other, traced)) is None
    assert manifest.metric_reader(name)(_rec(name.split(".")[0], None)) is None
