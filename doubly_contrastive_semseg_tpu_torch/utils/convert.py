"""JAX ``DCSSModel`` variables → the port's torch ``state_dict``.

Takes the variables as nested dicts of numpy arrays (``params`` and
``batch_stats``, e.g. pulled with ``jax.device_get``); imports neither JAX
nor the JAX package. Conventions, the inverse of the JAX package's
``utils/torch_convert.py``: conv kernel HWIO → OIHW, dense (I, O) → (O, I),
BN scale/bias/mean/var → weight/bias/running_mean/running_var, and the s2d
stem kernel (4, 4, 12, 64) → the dense (64, 3, 7, 7) ``conv1.weight``.
A JAX model initialised for training (``return_supcon_feature=True``) has
``projection/{fc1,fc2}``, which land on ``projection.{fc1,fc2}`` of a port
model built with ``projection=True``. A tree of gradients maps like a tree
of parameters.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from ..ops.input_pipeline import stem_dense_kernel_from_s2d

_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _torch_module_name(part: str) -> str:
    m = re.fullmatch(r"layer(\d)_(\d+)", part)
    if m:
        return f"layer{m.group(1)}.{m.group(2)}"
    return {"downsample_conv": "downsample.0",
            "downsample_bn": "downsample.1"}.get(part, part)


def _weight(path, value: np.ndarray) -> np.ndarray:
    if path[-2:] == ("feature_extractor", "conv1"):
        value = stem_dense_kernel_from_s2d(value)
    if value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    return value.T


def _walk(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, path + (k,))
        else:
            yield path, k, np.asarray(v, np.float32)


def from_jax_variables(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for ``models.weathernet.DCSSModel`` from the JAX model's
    ``params`` and ``batch_stats`` trees."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf, value in _walk(params):
        prefix = ".".join(_torch_module_name(p) for p in path)
        if leaf == "kernel":
            value, leaf = _weight(path, value), "weight"
        elif leaf == "scale":
            leaf = "weight"
        sd[f"{prefix}.{leaf}"] = torch.from_numpy(np.array(value))
    for path, leaf, value in _walk(batch_stats):
        prefix = ".".join(_torch_module_name(p) for p in path)
        sd[f"{prefix}.{_BN_STATS[leaf]}"] = torch.from_numpy(np.array(value))
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return sd
