"""Serving entry point — port of the JAX package's ``models/serving.py``.

``make_serving_fn`` returns image → (B, H, W) int8 label map. When the
image is 4× the decoder features, the features go straight into the fused
serving head (``ops/seghead.py::fused_seghead_upsample_argmax``): on the
card that is the CUDA kernel, on the CPU its plain version (seg head, then
``upsample4x_argmax``), and the model's seg logits are never computed.
Other sizes take JAX's other branches: the ×4 upsample-argmax of the seg
head's logits when 4× their height is the image's, else the argmax of the
full-resolution logits.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.input_pipeline import image_hw, upsample4x_argmax
from ..ops.interpolate import resize_bilinear
from ..ops.seghead import fused_seghead_upsample_argmax
from .weathernet import DCSSModel


def make_serving_fn(model: DCSSModel, device="cuda", use_fused_head: bool = True) -> Callable:
    """Returns ``serve(image) -> (B, H, W) int8`` for a ``DCSSModel`` on
    ``device``; ``image`` is pixels (a tensor or an array) in NHWC, planar
    or s2d layout (``ops/input_pipeline.py::to_nhwc``).
    ``use_fused_head`` is JAX's ``use_pallas_head``: the fused head serves
    images that are 4× the features and have at least 10 feature rows.
    Runs on the card unless ``device`` asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_serving_fn: CUDA is not available; pass "
                           "device='cpu' to serve on the CPU")
    model.eval()
    head = model.net.segmentation

    @torch.no_grad()
    def serve(image) -> torch.Tensor:
        x = torch.as_tensor(image, device=device)
        size = image_hw(x)
        feat, _ = model.net.feature_extractor(x)   # (B, 128, h, w)
        h, w = feat.shape[2:]
        if use_fused_head and h >= 10 and (4 * h, 4 * w) == size:
            return fused_seghead_upsample_argmax(
                feat.permute(0, 2, 3, 1).contiguous(), head.norm.weight, head.norm.bias,
                head.norm.running_mean, head.norm.running_var,
                head.conv.weight, head.conv.bias, eps=head.norm.eps)
        seg_beforeup = model.net.seg_logits(feat)
        if 4 * h == size[0]:   # JAX tests the height only (serving.py:48)
            return upsample4x_argmax(seg_beforeup).to(torch.int8)
        return resize_bilinear(seg_beforeup, size).argmax(-1).to(torch.int8)

    return serve
