"""The roofline functions against the bounds worked out before the
benchmark existed (K1 0.0851 ms, K2 0.1047 ms, JF 0.0262 ms at the
2048×1024 batch of 8 and eight 768² crops), and the trace reduction."""

import json

import pytest

from perfbench.harness import manifest, trace
from perfbench.harness.record import PEAKS, Record
from perfbench.rooflines import jf, k1, k2


@pytest.mark.parametrize("fn, expect_ms, by", [
    (lambda: k1.bound_s(8, 1024, 2048, 19, PEAKS), 0.0851, "bytes"),
    (lambda: k2.bound_s(8, 1024, 2048, PEAKS), 0.1047, "operations"),
    (lambda: jf.bound_s(8, 768, 768, PEAKS), 0.0262, "operations"),
], ids=["k1", "k2", "jf"])
def test_bounds_at_the_known_shapes(fn, expect_ms, by):
    seconds, bound_by = fn()
    assert round(seconds * 1e3, 4) == expect_ms and bound_by == by


def test_jf_counts_88_launches_at_768():
    assert len(jf.launches(768, 768)) == 88
    flops, nbytes = jf.work(8, 768, 768)
    assert round(flops / 1e9, 3) == 1.755 and round(nbytes / 1e6, 1) == 23.6


def fake_trace(tmp_path):
    def launch(ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                "dur": 1, "args": {"correlation": corr}}

    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "bench.augment", "ts": 0, "dur": 8},
          {"ph": "X", "cat": "user_annotation", "name": "Optimizer.step#Adam.step", "ts": 30,
           "dur": 5},
          {"ph": "X", "cat": "cpu_op", "name": "aten::conv", "ts": 10, "dur": 20},
          launch(1, 1), launch(3, 2), launch(31, 3), launch(36, 4),
          {"ph": "X", "cat": "kernel", "name": "stem_pool_tc_kernel", "ts": 0, "dur": 10,
           "args": {"correlation": 1}},
          {"ph": "X", "cat": "kernel", "name": "implicit_convolve_sgemm", "ts": 5, "dur": 10,
           "args": {"correlation": 4}},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 40, "dur": 20,
           "args": {"correlation": 2}},
          {"ph": "X", "cat": "kernel", "name": "seghead_tc_kernel", "ts": 90, "dur": 10,
           "args": {"correlation": 3}}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.read_chrome_trace(path, iterations=2)


def test_trace_reduction(tmp_path):
    t = fake_trace(tmp_path)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(45e-6)
    assert t.launches() == 3
    gaps = t.idle_gaps(10)
    assert [round(g[1] * 1e6) for g in gaps] == [30, 25]
    assert gaps[1][0] == "aten::conv"
    assert t.top_ops(1)[0][0] == "Memcpy HtoD"


def test_device_time_of_the_ops_launched_in_a_span(tmp_path):
    """Each device op is tied to its launch by the correlation id, and is
    counted where the launch, not the op, lies inside the span."""
    t = fake_trace(tmp_path)
    assert t.device_ms(lambda n: n == "bench.augment") == pytest.approx(30e-3 / 2)
    assert t.device_ms(lambda n: n.startswith("Optimizer.step#")) == pytest.approx(10e-3 / 2)
    assert t.device_ms(lambda n: n == "bench.to_device") is None
    rec = Record("train", {"name": "x"}, {}, {})
    assert manifest.metric_reader("augment.ms")(rec) is None
    rec.trace = t
    assert manifest.metric_reader("augment.ms")(rec) == pytest.approx(30e-3 / 2)
    assert manifest.metric_reader("optim.ms")(rec) == pytest.approx(10e-3 / 2)


def test_readers_read_the_trace_and_nothing_else(tmp_path):
    rec = Record("serve", {"name": "x"}, {"widths": {"num_classes": 19}},
                 {"frame_hw": [1024, 2048], "batch": 8})
    reader = manifest.metric_reader("k2_roofline")
    assert reader(rec) is None
    rec.trace = fake_trace(tmp_path)
    bound, _ = k2.bound_s(8, 1024, 2048, PEAKS)
    assert reader(rec) == pytest.approx(100 * bound * 2 / 10e-6)
    assert manifest.metric_reader("jf_roofline")(rec) is None
    assert manifest.metric_reader("serve.launches")(rec) == 1.5
    assert manifest.metric_reader("conv.ms.serve")(rec) == pytest.approx(10e-3 / 2)
    assert manifest.metric_reader("device.idle_pct.serve")(rec) == pytest.approx(55.0)
    # a qualified metric with no reader of its own reads its quantity
    assert manifest.metric_reader("conv.ms.serve.r101")(rec) == pytest.approx(10e-3 / 2)
