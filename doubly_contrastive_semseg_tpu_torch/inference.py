"""Inference CLI of the port: semantic label maps of a folder of PNG and
JPEG images from a port checkpoint (JAX ``inference.py:169-240``), or with
``--stereo`` the disparity of paired left/right images (JAX
``inference.py:85-166``).

    python -m doubly_contrastive_semseg_tpu_torch.inference --input <image|dir> \\
        --resume run/.../checkpoints/score_best_checkpoint --output_dir output
    python -m doubly_contrastive_semseg_tpu_torch.inference --stereo --input <left dir> \\
        --right_input <right dir> [--resume <ckpt>] --output_dir output

Each image is read with ``data/images.py::read_image`` (a PNG with
``data/png.py::read_png``, a JPEG with PIL, as JAX reads both), resized
with Pillow's bilinear filter when ``--img_width`` and ``--img_height`` are
given (``FixedResize``'s numpy copy), run through the eval-mode forward (the fused stem, K2, on the card)
and the argmax of the full-resolution logits, as JAX's inference does, and
written with ``write_png`` as ``<stem>_pred.png`` (train ids) and, with
``--save_color`` (the default), ``<stem>_color.png`` (``ACDC.decode_target``).
The mean forward time skips the first image. Runs on the card unless
``--device cpu`` is given.

``--stereo`` builds ``StereoDCSS`` from the composition flags
(``--max_disp``, ``--train_semantic``, ``--backbone``,
``--aggregation_type``, ``--refinement_type``, ``--deform_impl``; the
defaults serve a disparity-only model through the StereoNet refinement),
reads the sorted left and right lists (``--right_input``, else ``--input``
with ``left`` replaced by ``right``), zero-pads each pair at the top and
the right to ``--val_img_height`` × ``--val_img_width``, runs the
disparity forward and crops back, and writes ``clip(disparity × 256, 0,
65535)`` as a 16-bit grey PNG named as the left image (the KITTI
submission format).
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .config import Config
from .data.acdc import ACDC
from .data.images import read_image
from .data.png import write_png
from .data.transforms import resize_bilinear_pil
from .models import build_model, build_stereo_model
from .utils.pretrained import merge_state_dict


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="semantic inference (PyTorch/CUDA port)")
    p.add_argument("--input", type=str, required=True, help="image file or directory")
    p.add_argument("--output_dir", type=str, default="output")
    p.add_argument("--resume", type=str, default=None, help="a port checkpoint file")
    p.add_argument("--model", type=str, default="resnet18")
    p.add_argument("--num_classes", type=int, default=19)
    p.add_argument("--img_width", type=int, default=None, help="resize width (default: native)")
    p.add_argument("--img_height", type=int, default=None)
    p.add_argument("--save_color", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--stereo", action="store_true", default=False)
    p.add_argument("--right_input", type=str, default=None)
    p.add_argument("--max_disp", type=int, default=192)
    p.add_argument("--train_semantic", action="store_true", default=False)
    p.add_argument("--backbone", default="resnet18",
                   choices=["resnet18", "resnet34", "efficientnetb0"])
    p.add_argument("--aggregation_type", default="adaptive",
                   choices=["adaptive", "stereonet", "psmnet_basic", "psmnet_hg", "gcnet"])
    p.add_argument("--refinement_type", default="semantic",
                   choices=["semantic", "stereonet", "stereodrnet", "hourglass", "disp_sem",
                            "new1", "new2", "new3", "new4", "new5", "new9", "new10", "new12"])
    p.add_argument("--deform_impl", default="window", choices=["window", "gather"])
    p.add_argument("--val_img_height", type=int, default=None)
    p.add_argument("--val_img_width", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return p


def list_images(root: str):
    if os.path.isfile(root):
        return [root]
    return sorted(sum([glob.glob(os.path.join(root, e))
                       for e in ("*.png", "*.jpg", "*.jpeg")], []))


def load_image(path: str, width: Optional[int], height: Optional[int]) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a PNG or JPEG, resized bilinearly to
    (width, height) when both are given."""
    img = read_image(path, mode="RGB")
    if width and height:
        img = resize_bilinear_pil(img, (width, height))
    return img


def load_checkpoint(model: torch.nn.Module, path: Optional[str]) -> None:
    """Loads a port checkpoint's ``{"model": state_dict}`` into ``model``."""
    if path:
        blob = torch.load(path, map_location=next(model.parameters()).device,
                          weights_only=True)
        merge_state_dict(model, blob["model"], path)


def report_times(times) -> None:
    if len(times) > 1:   # the first image builds and tunes (JAX: compiles)
        mean = float(np.mean(times[1:]))
        print(f"mean forward time: {mean:.4f}s ({1.0 / mean:.1f} FPS)", flush=True)


def stereo_main(args) -> dict:
    """Disparity of each left/right pair as a 16-bit PNG of disparity ×
    256 (reference ``inference.py:120-167``)."""
    lefts = list_images(args.input)
    rights = list_images(args.right_input or args.input.replace("left", "right"))
    if not lefts or len(lefts) != len(rights):
        raise SystemExit(f"need paired left/right lists, got {len(lefts)} vs {len(rights)}")
    model = build_stereo_model(args, device=args.device)
    load_checkpoint(model, args.resume)
    device = next(model.parameters()).device
    os.makedirs(args.output_dir, exist_ok=True)

    written, times = [], []
    for i, (lp, rp) in enumerate(zip(lefts, rights)):
        left, right = read_image(lp, mode="RGB"), read_image(rp, mode="RGB")
        oh, ow = left.shape[:2]
        top_pad = (args.val_img_height or oh) - oh
        right_pad = (args.val_img_width or ow) - ow
        pad = ((top_pad, 0), (0, right_pad), (0, 0))   # zero rows on top, columns right
        xl, xr = (torch.from_numpy(np.pad(v, pad)).to(device=device, dtype=torch.float32)[None]
                  for v in (left, right))
        t0 = time.perf_counter()
        with torch.no_grad():
            disp = model.disparity(xl, xr)[0]["disp"][0].cpu().numpy()
        dt = time.perf_counter() - t0
        times.append(dt)

        disp = disp[top_pad:, :disp.shape[1] - right_pad]   # crop back
        out = os.path.join(args.output_dir, os.path.basename(lp))
        write_png(out, np.clip(disp * 256.0, 0, 65535).astype(np.uint16), "adaptive")
        written.append(out)
        print(f"[{i + 1}/{len(lefts)}] {lp} -> {out} ({dt:.3f}s)", flush=True)
    report_times(times)
    return {"paths": written, "forward_s": times}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the CLI on ``argv``; returns {"paths", "forward_s"}: the
    written files and each image's (or pair's) forward time in seconds."""
    args = build_parser().parse_args(argv)
    if args.stereo:
        return stereo_main(args)
    cfg = Config(model=args.model, num_classes=args.num_classes,
                 compute_dtype=args.compute_dtype, dataset="acdc").finalize()
    model = build_model(cfg, device=args.device)
    load_checkpoint(model, args.resume)
    model.eval()
    device = next(model.parameters()).device

    paths = list_images(args.input)
    if not paths:
        raise SystemExit(f"no images under {args.input}")
    os.makedirs(args.output_dir, exist_ok=True)

    written, times = [], []
    for i, path in enumerate(paths):
        img = load_image(path, args.img_width, args.img_height)
        x = torch.from_numpy(img).to(device=device, dtype=torch.float32)[None]
        t0 = time.perf_counter()
        with torch.no_grad():
            pred = model(x)["seg"].argmax(-1).to(torch.int32)[0].cpu().numpy()
        dt = time.perf_counter() - t0
        times.append(dt)

        stem = os.path.splitext(os.path.basename(path))[0]
        # the argmax over num_classes never emits the ignore id: the grey
        # map is the raw train-id map
        out = os.path.join(args.output_dir, stem + "_pred.png")
        write_png(out, pred.astype(np.uint8), "adaptive")
        written.append(out)
        if args.save_color:
            out = os.path.join(args.output_dir, stem + "_color.png")
            write_png(out, ACDC.decode_target(pred.copy()).astype(np.uint8), "adaptive")
            written.append(out)
        print(f"[{i + 1}/{len(paths)}] {path} -> {stem}_pred.png ({dt:.3f}s)", flush=True)

    report_times(times)
    return {"paths": written, "forward_s": times}


if __name__ == "__main__":
    main()
