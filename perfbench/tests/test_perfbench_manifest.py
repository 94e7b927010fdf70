"""BENCHMARK.json against the benchmark's contract, and the harness finding
every piece by name, a dummy cell added by files alone included."""

import json
import re
import shutil

import pytest

from perfbench.harness import manifest
from perfbench.harness.env import ROOT
from perfbench.harness.record import Record

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
MAN = manifest.load_manifest()
E2E = {m["name"]: m for m in MAN["end_to_end"]}


def reports(cell: str) -> set:
    return {m["name"] for m in manifest.cell_metrics(MAN, cell, False)}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["file"].startswith("perfbench/")
    assert entry["reduced"] == []
    cfg = manifest.config(MAN, entry["name"])
    assert cfg["source"] == entry["source"] and cfg["reduced"] == []
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])
    assert manifest.reference(cfg["reference"]).build


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda e: e["name"])
def test_cell_entry(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert all(NAME.match(cell[k]) for k in ("name", "config", "traffic"))
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    mix = manifest.traffic(cell["traffic"])
    assert manifest.driver(mix["driver"]).run
    assert manifest.limits(cell["name"])
    names = reports(cell["name"])
    assert "setup_s" in names and len(names) >= 2
    assert manifest.cell_metrics(MAN, cell["name"], True)


def test_cells_unique_and_configs_differ():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [x["name"] for x in MAN["workloads"] + MAN["configs"]]
    assert len(set(names)) == len(names)
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"], ids=lambda m: m["name"])
def test_metric_entry(metric):
    keys = {"name", "unit", "better", "source"} | ({"bound"} if metric in MAN["end_to_end"]
                                                    else {"layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
    if metric in MAN["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in E2E
        for cell in metric.get("workloads", []):
            assert metric["moves"] in reports(cell)
        assert callable(manifest.metric_reader(metric["name"]))


def test_end_to_end_metrics_are_the_issues():
    assert set(E2E) == {"train_samples_s", "serve_p95_ms", "serve_fps.r101",
                        "serve_p95_ms.r101", "peak_mem_gib", "setup_s"}
    assert {manifest.unqualified(n) for n in E2E} == {
        "train_samples_s", "serve_fps", "serve_p95_ms", "peak_mem_gib", "setup_s"}


def test_a_dummy_cell_is_added_by_files_alone(tmp_path):
    """A new traffic mix, limits file and per-layer metric reader, and new
    entries in a copy of BENCHMARK.json: the harness finds them by name,
    with no file of the benchmark edited."""
    bench = tmp_path / "perfbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "perfbench" / sub, bench / sub)
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "rn18.serve.b1", "config": "swiftnet_rn18",
                             "traffic": "serve_b1", "chips": 1, "why": "batch 1"})
    for m in man["end_to_end"]:
        if "serve_p95_ms" == m["name"]:
            m["workloads"].append("rn18.serve.b1")
    man["per_layer"].append({"name": "dummy.count", "unit": "ops/batch", "better": "lower",
                             "source": "program_counter", "layer": "serving entry",
                             "moves": "serve_p95_ms", "workloads": ["rn18.serve.b1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    mix = dict(manifest.traffic("serve_b8"), batch=1)
    (bench / "traffic" / "serve_b1.json").write_text(json.dumps(mix))
    (bench / "limits" / "rn18.serve.b1.json").write_text(json.dumps({"limits": {"label_gap": 1}}))
    (bench / "metrics" / "dummy.count.py").write_text("def read(rec):\n    return 7.0\n")

    loaded = manifest.load_manifest(tmp_path)
    cell = manifest.workload(loaded, "rn18.serve.b1")
    assert manifest.traffic(cell["traffic"], tmp_path)["batch"] == 1
    assert manifest.limits("rn18.serve.b1", tmp_path) == {"label_gap": 1.0}
    assert manifest.config(loaded, cell["config"], tmp_path)["reference"] == "swiftnet"
    per_layer = [m["name"] for m in manifest.cell_metrics(loaded, "rn18.serve.b1", True)]
    assert per_layer == ["dummy.count"]
    rec = Record("serve", cell, {}, mix)
    assert manifest.metric_reader("dummy.count", tmp_path)(rec) == 7.0
