"""Shared tiny sizes for the CPU tests of the harness."""

import copy

import torch

from perfbench.harness import manifest

TINY = {"frame_hw": [64, 128], "crop": 32, "batch": 2, "pool": 4, "warmup_steps": 1,
        "traced_steps": 1, "warmup_batches": 1, "traced_batches": 2}


def cell(name: str, dtype: str = None):
    """(cell, config, traffic at the tiny sizes) of ``name``, a cell of
    ``BENCHMARK.json`` or a pair "config/traffic" of files that no cell
    pairs yet; ``dtype`` replaces the program's compute dtype."""
    man = manifest.load_manifest()
    if "/" in name:
        cfg_name, mix_name = name.split("/")
        c = {"name": name.replace("/", "."), "config": cfg_name, "traffic": mix_name, "chips": 1}
    else:
        c = manifest.workload(man, name)
    config = copy.deepcopy(manifest.config(man, c["config"]))
    if dtype:
        config["program"]["compute_dtype"] = dtype
    return c, config, dict(manifest.traffic(c["traffic"]), **TINY)


def cells(driver: str):
    """The names of the cells whose traffic runs ``driver``."""
    man = manifest.load_manifest()
    return [w["name"] for w in man["workloads"]
            if manifest.traffic(w["traffic"])["driver"] == driver]


def threads():
    torch.set_num_threads(min(4, torch.get_num_threads()))
