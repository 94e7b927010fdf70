"""Torch checkpoints of the reference onto the port's model — the port's
copy of the JAX package's ``utils/torch_convert.py`` (``load_pretrained``
:789, ``convert_torchvision_resnet`` :60, ``convert_reference_weathernet``
:99, the projection and weather heads :812-829).

The port keeps the reference's ``state_dict`` names, so the conversion is a
renaming: a torchvision ResNet's trunk lands under
``net.feature_extractor.`` with its one ``bn1`` fanned out to the three
pyramid levels' ``bn1_{0,1,2}`` (reference ``resnet_pyramid.py:388-393``);
a reference trainer checkpoint's ``model_state`` lands, routed as JAX
routes it (``torch_convert.py:797-803``), on the model's root for the
DeepLab family (``backbone.*``, ``classifier.*``), under ``net.`` for ENet
(``initial_block.*``, ...) and for WeatherNet; its ``supcon_projection`` on
``projection`` and its ``weather_clf`` on ``weather_clf``. Loading is partial, by name and shape,
like ``load_state_dict(strict=False)``: a tensor the model lacks is
skipped, one of another shape is skipped with a warning.
"""

from __future__ import annotations

import logging
from typing import Dict

import torch

FE = "net.feature_extractor."


def _tensors(sd: Dict) -> Dict[str, torch.Tensor]:
    """The tensors of ``sd`` without BN's ``num_batches_tracked`` counters,
    which JAX's conversion drops."""
    return {k: v for k, v in sd.items()
            if torch.is_tensor(v) and not k.endswith("num_batches_tracked")}


def convert_torchvision_resnet(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """torchvision ResNet-18/34 ``state_dict`` → the port's names: ``conv1``
    and ``layer1..4`` under ``net.feature_extractor.``, ``bn1`` fanned out to
    ``bn1_{0,1,2}``; ``fc`` has no counterpart and is dropped."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in _tensors(state_dict).items():
        if k.startswith("bn1."):
            for lvl in range(3):
                out[f"{FE}bn1_{lvl}.{k[len('bn1.'):]}"] = v
        elif k.startswith(("conv1.", "layer")):
            out[FE + k] = v
    return out


def convert_reference_weathernet(model_state: Dict) -> Dict[str, torch.Tensor]:
    """A reference WeatherNet ``model_state`` → the port's names: the
    pyramid trunk, its per-level stem BNs, the skip bottlenecks and the blend
    convs under ``net.feature_extractor.``, the seg head under
    ``net.segmentation.``."""
    fe = {k[len("feature_extractor."):]: v for k, v in _tensors(model_state).items()
          if k.startswith("feature_extractor.")}
    if "spp.spp.spp_bn.conv.weight" in fe:
        raise NotImplementedError("a single-scale SwiftNet checkpoint: that model family is "
                                  "not ported yet (ROADMAP.md §1 item 4)")
    out = convert_torchvision_resnet(fe)
    for k, v in fe.items():
        if k.startswith(("bn1_", "upsample_bottlenecks", "upsample_blends")):
            out[FE + k] = v
    for k, v in _tensors(model_state).items():
        if k.startswith("segmentation."):
            out["net." + k] = v
    return out


def convert_blob(blob: Dict) -> Dict[str, torch.Tensor]:
    """A loaded ``.pth``: a reference trainer checkpoint (``model_state`` of
    WeatherNet, DeepLab or ENet, with ``supcon_projection`` and
    ``weather_clf`` beside it where the run had them) or a torchvision
    ResNet ``state_dict``."""
    if not (isinstance(blob, dict) and "model_state" in blob):
        return convert_torchvision_resnet(blob)
    sd = blob["model_state"]
    if any(k.startswith("backbone.") for k in sd):         # the DeepLab family
        out = _tensors(sd)
    elif any(k.startswith("initial_block.") for k in sd):  # ENet
        out = {"net." + k: v for k, v in _tensors(sd).items()}
    else:
        out = convert_reference_weathernet(sd)
    if "supcon_projection" in blob:
        ps = blob["supcon_projection"]      # Sequential(Linear, ReLU, Linear)
        for i, fc in (("0", "fc1"), ("2", "fc2")):
            for p in ("weight", "bias"):
                out[f"projection.{fc}.{p}"] = ps[f"{i}.{p}"]
    if "weather_clf" in blob:
        for p in ("weight", "bias"):
            out[f"weather_clf.fc.{p}"] = blob["weather_clf"][f"fc.{p}"]
    return out


def merge_state_dict(model: torch.nn.Module, tensors: Dict[str, torch.Tensor],
                     source: str = "") -> int:
    """Copies each tensor onto the model's tensor of that name and shape,
    in place (JAX's merge by path, ``strict=False`` in torch): a name the
    model lacks is skipped, another shape skipped with a warning, and the
    model keeps its own tensors where ``tensors`` has none. Returns how many
    were copied."""
    own = model.state_dict()
    n = 0
    with torch.no_grad():
        for k, v in tensors.items():
            if k not in own:
                logging.debug("merge: skipping %s, which the model lacks", k)
            elif tuple(own[k].shape) != tuple(v.shape):
                logging.warning("merge: shape mismatch at %s: %s in the model, %s in %s", k,
                                tuple(own[k].shape), tuple(v.shape), source)
            else:
                own[k].copy_(v)
                n += 1
    logging.info("loaded %d tensors from %s", n, source)
    return n


def load_pretrained(model: torch.nn.Module, path: str) -> int:
    """Loads a torchvision ResNet ``.pth`` or a reference trainer checkpoint
    onto ``model`` (``--pretrained``); returns the number of tensors
    loaded."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    return merge_state_dict(model, convert_blob(blob), path)
