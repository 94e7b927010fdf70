"""Serving entry point — port of the JAX package's ``models/serving.py``.

``make_serving_fn`` returns image → (B, H, W) int8 label map. The decoder
features go straight into the fused serving head
(``ops/seghead.py::fused_seghead_upsample_argmax``): on the card that is
the CUDA kernel, on the CPU its plain version (seg head, then
``upsample4x_argmax``). The model's seg logits at 1/4 and full resolution
are never computed on this path.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.seghead import fused_seghead_upsample_argmax
from .weathernet import DCSSModel


def make_serving_fn(model: DCSSModel, device="cuda") -> Callable:
    """Returns ``serve(image) -> (B, H, W) int8`` for a ``DCSSModel`` on
    ``device``; ``image`` is (B, H, W, 3) pixels (a tensor or an array),
    H and W multiples of 4. Runs on the card unless ``device`` asks for the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_serving_fn: CUDA is not available; pass "
                           "device='cpu' to serve on the CPU")
    model.eval()
    head = model.net.segmentation

    @torch.no_grad()
    def serve(image) -> torch.Tensor:
        x = torch.as_tensor(image, device=device)
        h, w = x.shape[1], x.shape[2]
        if h % 4 or w % 4:
            raise ValueError(f"serve: image size {(h, w)} must be a multiple "
                             "of 4 (the head upsamples 1/4-resolution logits ×4)")
        feat = model.forward_features(x)["fine_feat"]  # (B, h/4, w/4, 128)
        return fused_seghead_upsample_argmax(
            feat.contiguous(), head.norm.weight, head.norm.bias,
            head.norm.running_mean, head.norm.running_var,
            head.conv.weight, head.conv.bias, eps=head.norm.eps)

    return serve
