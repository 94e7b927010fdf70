"""The run's surroundings: the checkout's root, cache folders inside it, the
device check, the card's name and power limit, and the guard that no JAX
module was loaded."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "perfbench" / "out"
CACHE = OUT / "cache"

# top-level module names that no run may load, compared whole: the port's
# name starts with the JAX package's, so a prefix test would be wrong
FORBIDDEN = ("jax", "jaxlib", "flax", "doubly_contrastive_semseg_tpu")


class NoDevice(RuntimeError):
    """The cell asks for cards that this machine does not have."""


def set_cache_dirs() -> None:
    """Every compiler cache at a fixed folder inside the checkout, so only
    the first run of a checkout fills it. The port builds its CUDA
    libraries into its own ``_build/``, which is inside the checkout too."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    # libraries that would load JAX by themselves are told not to
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def require_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("CUDA is not available: this benchmark measures the card and never "
                       "falls back to the CPU")
    if torch.cuda.device_count() < n:
        raise NoDevice(f"the cell asks for {n} cards, this machine has "
                       f"{torch.cuda.device_count()}")


def forbidden_modules() -> list:
    """The forbidden top-level names present in ``sys.modules``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_info(device) -> dict:
    """The card's name (``torch.cuda.get_device_name``) and its power limit
    as ``nvidia-smi`` reads it, or the CPU's name for a test run."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "power_limit": "none"}
    limit = "not read"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", str(dev.index or 0)], capture_output=True, text=True,
                             timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            limit = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "power_limit": limit}
