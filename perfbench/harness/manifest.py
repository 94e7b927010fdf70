"""Finds every piece of the benchmark by its name in ``BENCHMARK.json``: a
cell's configuration file, its traffic mix, the driver that the mix names,
its correctness limits, the per-layer metrics' readers and the kernels'
roofline functions. Adding a cell adds files and entries; nothing here is
edited for it."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

from .env import ROOT


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    with open(root / "perfbench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def limits(workload_name: str, root: Path = ROOT) -> Dict[str, float]:
    """The correctness limits of a cell, each set from its two readings
    (``PERF.md``): ``perfbench/limits/<workload>.json``."""
    with open(root / "perfbench" / "limits" / f"{workload_name}.json") as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def driver(name: str):
    """The driver module a traffic mix names (``perfbench/drivers/<name>.py``)."""
    return importlib.import_module(f"perfbench.drivers.{name}")


def reference(name: str):
    """The plain reference module a configuration names."""
    return importlib.import_module(f"perfbench.reference.{name}")


def roofline(name: str):
    return importlib.import_module(f"perfbench.rooflines.{name}")


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def unqualified(name: str) -> str:
    """The quantity a metric named ``<quantity>.<qualifier>`` reports
    (``serve_fps.r101``: ``serve_fps``). A qualified metric reports its
    quantity in the cells it lists under a bound of its own; it needs an
    entry in ``BENCHMARK.json``, no code."""
    return name.rsplit(".", 1)[0]


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(rec)`` of ``perfbench/metrics/<name>.py``, or of the
    unqualified name's file where the metric has none of its own: the
    metric's value, or None where the run gave it nothing to read."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    if not path.exists():
        name = unqualified(name)
        path = root / "perfbench" / "metrics" / f"{name}.py"
    return _load_file(path, "perfbench_metric_" + name.replace(".", "_").replace("-", "_")).read


def cell_metrics(manifest: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics the cell reports: with ``trace`` its per-layer ones,
    else its end-to-end ones. A metric with a ``workloads`` key is the
    listed cells'; a per-layer metric without one is that of every cell
    that reports the end-to-end metric it moves."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    out = []
    for m in manifest["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in names:
            out.append(m)
    return out

