"""No JAX in a run: a fresh interpreter that runs the harness's CPU-side
code holds neither ``jax`` nor the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's); the
reference holds nothing of the port either. And without a card a run
fails and prints no result."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench.harness import env
from perfbench.harness.env import ROOT

RUN_TINY = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from perfbench.drivers import serve
from perfbench.harness import env
from perfbench.tests.tiny import cell
c, config, mix = cell("rn18.serve.b8")
serve.run(c, config, mix, seed=3, seconds=0.2, trace=False, device="cpu")
print(json.dumps(env.forbidden_modules()))
"""

IMPORT_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import perfbench.reference.swiftnet, perfbench.reference.deeplab
import perfbench.reference.losses, perfbench.reference.augment, perfbench.reference.train
perfbench.reference.swiftnet.build(); perfbench.reference.deeplab.build()
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0].startswith("doubly"))))
"""


def last_json(code: str):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_cpu_run_loads_no_jax():
    assert last_json(RUN_TINY.format(root=str(ROOT))) == []


def test_the_reference_loads_nothing_of_the_port():
    assert last_json(IMPORT_REFERENCE.format(root=str(ROOT))) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "doubly_contrastive_semseg_tpu_torch_extra", object())
    assert "doubly_contrastive_semseg_tpu" not in env.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in env.forbidden_modules()


@pytest.mark.parametrize("only_benchmark", [False, True], ids=["checkout", "benchmark_files"])
def test_without_a_card_a_run_fails_and_prints_nothing(tmp_path, only_benchmark):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    cwd = ROOT
    if only_benchmark:
        cwd = tmp_path
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                        ignore=shutil.ignore_patterns("out", "__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "rn18.serve.b8",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
