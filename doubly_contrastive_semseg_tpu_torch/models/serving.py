"""Serving entry point — port of the JAX package's ``models/serving.py``.

``make_serving_fn`` returns image → (B, H, W) int8 label map. For a
``DCSSModel`` (SwiftNet), when the image is 4× the decoder features, the
features go straight into the fused serving head (``ops/seghead.py::
fused_seghead_upsample_argmax``): on the card that is the CUDA kernel, on
the CPU its plain version (seg head, then ``upsample4x_argmax``), and the
model's seg logits are never computed. Other sizes, and every other model
(DeepLab, ENet: JAX's generic branch, ``serving.py:22-52``), take JAX's
other branches: the ×4 upsample-argmax of ``seg_beforeup`` when 4× its
height is the image's, else the argmax of the full-resolution ``seg``.

``make_stereo_serving_fn`` serves ``StereoDCSS`` (JAX ``serving.py:55-91``):
disparity and, with ``train_semantic``, the label map of the left view from
the same fused head on the shared trunk's left features.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.input_pipeline import image_hw, upsample4x_argmax
from ..ops.interpolate import resize_bilinear, resize_bilinear_cols
from ..ops.seghead import fused_seghead_cols, fused_seghead_upsample_argmax
from ..parallel.spatial import split_active
from ..utils.profiling import span
from .stereo import StereoDCSS
from .weathernet import DCSSModel, check_device


def _labels(head, feat: torch.Tensor, size, use_fused_head: bool = True) -> torch.Tensor:
    """(B, H, W) int8 labels of the (B, 128, h, w) features through the
    ``BNReluConv`` seg ``head``: the fused head (K1) when the image is 4×
    the features and there are at least 10 feature rows, else the ×4
    upsample-argmax of the logits when 4h is the image's height (JAX tests
    the height only, ``serving.py:48``), else the argmax of their bilinear
    resize to the image."""
    h, w = feat.shape[2:]
    if use_fused_head and h >= 10 and (4 * h, 4 * w) == tuple(size):
        return fused_seghead_upsample_argmax(
            feat.permute(0, 2, 3, 1).contiguous(), head.norm.weight, head.norm.bias,
            head.norm.running_mean, head.norm.running_var, head.conv.weight, head.conv.bias,
            eps=head.norm.eps)
    seg_beforeup = head.nhwc_logits(feat)
    if 4 * h == size[0]:
        return upsample4x_argmax(seg_beforeup).to(torch.int8)
    return resize_bilinear(seg_beforeup, size).argmax(-1).to(torch.int8)


def _labels_split(head, feat: torch.Tensor, width: int, size,
                  use_fused_head: bool = True) -> torch.Tensor:
    """``_labels`` on width-split features: from this rank's columns of the
    (B, 128, h, ``width``) features, this rank's columns of the label map.
    The branch is chosen on the global sizes (the height is not split): K1
    on a window of the features (``fused_seghead_cols``), else the ×4 or
    the image-size resize of the logits (``resize_bilinear_cols``) and its
    argmax."""
    h = feat.shape[2]
    if use_fused_head and h >= 10 and (4 * h, 4 * width) == tuple(size):
        return fused_seghead_cols(
            feat.permute(0, 2, 3, 1), width, head.norm.weight, head.norm.bias,
            head.norm.running_mean, head.norm.running_var, head.conv.weight, head.conv.bias,
            eps=head.norm.eps)
    logits = head.forward_cols(feat, width)[0].permute(0, 2, 3, 1).float()
    out = (4 * h, 4 * width) if 4 * h == size[0] else tuple(size)
    return resize_bilinear_cols(logits, width, out).argmax(-1).to(torch.int8)


def make_serving_fn(model: torch.nn.Module, device="cuda",
                    use_fused_head: bool = True) -> Callable:
    """Returns ``serve(image) -> (B, H, W) int8`` for a model of
    ``build_model`` on ``device``; ``image`` is pixels (a tensor or an
    array) in NHWC, planar or s2d layout (``ops/input_pipeline.py::
    to_nhwc``). ``use_fused_head`` is JAX's ``use_pallas_head``: for a
    ``DCSSModel`` the fused head serves images that are 4× the features and
    have at least 10 feature rows. Runs on the card unless ``device`` asks
    for the CPU.

    On a model axis of more than one rank (``parallel/spatial.py``) a
    ``DCSSModel`` is served width-split: ``image`` is this rank's columns
    of the image (NHWC or planar) and ``serve`` returns this rank's columns
    of the label map; K2 runs on each rank's window of each level and K1 on
    its window of the features, and no rank holds more of the image than
    its columns and their halo."""
    device = check_device(device, "make_serving_fn")
    model.eval()
    if not isinstance(model, DCSSModel):
        @torch.no_grad()
        def serve_generic(image) -> torch.Tensor:
            with span("dcss.serve"):
                out = model(torch.as_tensor(image, device=device))
                with span("dcss.head"):
                    if 4 * out["seg_beforeup"].shape[1] == out["seg"].shape[1]:
                        return upsample4x_argmax(out["seg_beforeup"]).to(torch.int8)
                    return out["seg"].argmax(-1).to(torch.int8)

        return serve_generic
    head = model.net.segmentation

    @torch.no_grad()
    def serve(image) -> torch.Tensor:
        with span("dcss.serve"):
            x = torch.as_tensor(image, device=device)
            if split_active():
                size, feat, wf, _ = model.net.features_split(x)
                with span("dcss.head"):
                    return _labels_split(head, feat, wf, size, use_fused_head)
            feat, _ = model.net.feature_extractor(x)   # (B, 128, h, w)
            with span("dcss.head"):
                return _labels(head, feat, image_hw(x), use_fused_head)

    return serve


def make_stereo_serving_fn(model: StereoDCSS, device="cuda") -> Callable:
    """Returns ``serve(left, right) -> (disparity (B, H, W) float32, labels
    (B, H, W) int8 or None)`` for a model of ``build_stereo_model`` on
    ``device``; the views are pixels (tensors or arrays) in NHWC, planar or
    s2d layout. The model's full-resolution ``seg`` logits are never
    computed: with ``train_semantic`` the labels come from the left view's
    trunk features as ``make_serving_fn`` takes them (K1 where the image is
    4× the features with at least 10 feature rows); a disparity-only model
    gives ``None``. Runs on the card unless ``device`` asks for the CPU."""
    device = check_device(device, "make_stereo_serving_fn")
    model.eval()

    @torch.no_grad()
    def serve(left, right):
        with span("dcss.serve"):
            xl = torch.as_tensor(left, device=device)
            xr = torch.as_tensor(right, device=device)
            out, left_feat = model.disparity(xl, xr)
            disp = out["disp"].float()
            if not model.train_semantic:
                return disp, None
            with span("dcss.head"):
                return disp, _labels(model.segmentation, left_feat, image_hw(xl))

    return serve
