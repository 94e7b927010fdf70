"""The port imports no JAX: in a fresh interpreter whose import system
refuses ``jax``, ``jaxlib``, ``flax`` and the JAX package
``doubly_contrastive_semseg_tpu``, every module of
``doubly_contrastive_semseg_tpu_torch`` imports, and so does every module
that ``chip_smoke.py`` imports (at its top and inside its functions);
afterwards none of the refused packages is loaded."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "doubly_contrastive_semseg_tpu_torch"
REFUSED = ("jax", "jaxlib", "flax", "doubly_contrastive_semseg_tpu")

GUARD = r"""
import importlib, importlib.abc, json, sys
REFUSED = %r
attempts = []

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == r or name.startswith(r + ".") for r in REFUSED):
            attempts.append(name)
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, %r)
result = {}
for name in %r:
    try:
        importlib.import_module(name)
        result[name] = None
    except BaseException as e:
        result[name] = f"{type(e).__name__}: {e}"
loaded = sorted(m for m in sys.modules if any(m == r or m.startswith(r + ".") for r in REFUSED))
print(json.dumps({"result": result, "loaded": loaded, "attempts": attempts}))
"""


def port_modules():
    pkg_dir = os.path.join(REPO, PACKAGE)
    names = [PACKAGE]
    for info in pkgutil.walk_packages([pkg_dir], prefix=PACKAGE + "."):
        names.append(info.name)
    return sorted(names)


def chip_smoke_imports():
    """Every module ``chip_smoke.py`` names in an import statement."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = {"chip_smoke"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
            for a in node.names:      # submodules imported by name
                if os.path.exists(os.path.join(REPO, *node.module.split("."), a.name + ".py")):
                    names.add(f"{node.module}.{a.name}")
    return sorted(names)


MODULES = port_modules()
SMOKE = chip_smoke_imports()


@pytest.fixture(scope="module")
def guarded():
    script = GUARD % (REFUSED, REPO, sorted(set(MODULES) | set(SMOKE)))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_lists_cover_the_port_and_chip_smoke():
    assert len(MODULES) > 50 and f"{PACKAGE}.main" in MODULES
    assert f"{PACKAGE}.train.trainer" in MODULES and f"{PACKAGE}.inference" in MODULES
    assert "torch" in SMOKE and f"{PACKAGE}.tools.profile_stem" in SMOKE


def test_no_refused_package_is_loaded(guarded):
    assert guarded["loaded"] == []


def test_every_module_imports_without_jax(guarded):
    failed = {name: err for name, err in guarded["result"].items() if err is not None}
    assert set(guarded["result"]) == set(MODULES) | set(SMOKE)
    assert failed == {}, "\n".join(f"{name}: {err}" for name, err in sorted(failed.items()))
