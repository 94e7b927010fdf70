"""Builds the CUDA sources in ``csrc/`` with ``nvcc`` and loads them with
``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so one
``nvcc`` run takes seconds. It is compiled for ``sm_90a`` (Hopper) at first
use into ``_build/`` beside the package, under a name that carries a hash of
the source and flags, so an edited source is rebuilt and never mixed up with
a stale library. ``build`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compiles every named source that has no up-to-date library yet, with
    one ``nvcc`` process per source running in parallel. Returns the
    compiler's report (ptxas registers, shared memory, spills) of each
    source it compiled; raises with the report if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for name, target in targets.items():
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed, logs = [], {}
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, targets[name])
        else:
            os.unlink(tmp)
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    Every library exports ``dcss_error_string(int) -> const char*``."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        lib.dcss_error_string.argtypes = [ctypes.c_int]
        lib.dcss_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raises if a C entry point returned a CUDA error code."""
    if status != 0:
        msg = lib.dcss_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
