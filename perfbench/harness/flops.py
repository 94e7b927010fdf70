"""Model FLOPs counted on the plain reference at a cell's shapes, on the
meta device, so that they read the same whatever implements the model."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import manifest


def model_flops(config: dict, images: int, h: int, w: int, train: bool) -> float:
    """FLOPs of the eval forward of ``images`` h×w images, or with
    ``train`` of the two-view training forward and its backward (the
    images are both views; recompute is not counted)."""
    ref = manifest.reference(config["reference"])
    counter = FlopCounterMode(display=False)
    with torch.device("meta"):
        model = ref.build(config["widths"]["num_classes"], config["widths"]["weather_num"])
        x = torch.empty((images, h, w, 3), dtype=torch.float32)
        if train:
            with counter:
                out = model.train()(x, two_view=True)
                (out["seg"].sum() + out["supcon_proj"].sum() + out["fine_feat0"].sum()).backward()
        else:
            with counter, torch.no_grad():
                model.eval()(x)
    return float(counter.get_total_flops())
