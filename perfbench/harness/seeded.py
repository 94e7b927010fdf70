"""Everything a run draws comes from ``--seed``: generators keyed by (seed,
purpose), the model's weights as a state dict made on the device in a few
large calls, and the pool of raw frames with labels and weather."""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch

# Cityscapes train-id colours (19 classes), the palette of the frames
PALETTE = (
    (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156), (190, 153, 153),
    (153, 153, 153), (250, 170, 30), (220, 220, 0), (107, 142, 35), (152, 251, 152),
    (70, 130, 180), (220, 20, 60), (255, 0, 0), (0, 0, 142), (0, 0, 70),
    (0, 60, 100), (0, 80, 100), (0, 0, 230), (119, 11, 32))
IGNORE = 255
NIGHT = 1          # the weather id whose frames get the gamma correction


def key(seed: int, *purpose) -> int:
    """A 63-bit generator seed for (``seed``, ``purpose``)."""
    digest = hashlib.sha256(repr((int(seed),) + purpose).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device, seed: int, *purpose) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(key(seed, *purpose))


def _kind(name: str, shape: Tuple[int, ...]) -> str:
    if name.endswith("num_batches_tracked"):
        return "count"
    if name.endswith("running_var"):
        return "var"
    if name.endswith("running_mean"):
        return "mean"
    if len(shape) == 1:
        return "gamma" if name.endswith("weight") else "beta"
    return "weight"


def state_dict(shapes: Dict[str, Tuple[Tuple[int, ...], int]], seed: int, device
               ) -> Dict[str, torch.Tensor]:
    """Float32 weights for ``shapes`` ({name: (shape, fan_in)}) drawn on
    ``device`` in two draws: He-normal convs and lecun-normal linears
    (N(0, 1) scaled by each tensor's fan-in), BN scales 1 + 0.1·N, shifts
    and running means 0.05·N, running variances U(0.5, 1.5), counts 0.
    The same seed gives the same tensors on both sides of a comparison."""
    gen = generator(device, seed, "weights")
    normal, uniform = [], []
    for name, (shape, fan_in) in shapes.items():
        kind = _kind(name, shape)
        n = math.prod(shape)
        if kind == "weight":
            gain = 2.0 if len(shape) == 4 else 1.0
            normal.append((name, shape, n, math.sqrt(gain / max(fan_in, 1)), 0.0))
        elif kind == "gamma":
            normal.append((name, shape, n, 0.1, 1.0))
        elif kind in ("beta", "mean"):
            normal.append((name, shape, n, 0.05, 0.0))
        elif kind == "var":
            uniform.append((name, shape, n, 1.0, 0.5))
    out: Dict[str, torch.Tensor] = {}
    for draw, entries in ((torch.randn, normal), (torch.rand, uniform)):
        if not entries:
            continue
        counts = torch.tensor([e[2] for e in entries], device=device)
        total = int(sum(e[2] for e in entries))
        scale = torch.repeat_interleave(torch.tensor([e[3] for e in entries], device=device),
                                        counts)
        shift = torch.repeat_interleave(torch.tensor([e[4] for e in entries], device=device),
                                        counts)
        flat = draw(total, generator=gen, device=device) * scale + shift
        for (name, shape, _, _, _), part in zip(entries, flat.split([e[2] for e in entries])):
            out[name] = part.view(shape)
    for name, (shape, _) in shapes.items():
        if _kind(name, shape) == "count":
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
    return out


def shapes_of(model: torch.nn.Module) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """{state-dict name: (shape, fan-in)} of a model (convs: in/groups·k·k;
    linears: in)."""
    fan = {}
    for mname, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            fan[f"{mname}.weight"] = m.in_channels // m.groups * math.prod(m.kernel_size)
        elif isinstance(m, torch.nn.Linear):
            fan[f"{mname}.weight"] = m.in_features
    return {k: (tuple(v.shape), fan.get(k, 0)) for k, v in model.state_dict().items()}


def frame_pool(seed: int, n: int, h: int, w: int, device, pin: bool
               ) -> Dict[str, torch.Tensor]:
    """``n`` raw frames on the host, made on ``device`` in blocks and copied
    out: ``left`` (n, h, w, 3) uint8 NHWC, ``label`` (n, h, w) uint8 (a
    base class, six rectangles of random classes, an ignore patch in the
    top-left eighth), ``weather`` (n,) int64 with every weather id equally
    often, in a seeded order, and ``class_counts`` (256,) float64, the
    labels' histogram. Pinned host memory on the card's machine."""
    gen = generator(device, seed, "frames")
    host = {"left": torch.empty((n, h, w, 3), dtype=torch.uint8, pin_memory=pin),
            "label": torch.empty((n, h, w), dtype=torch.uint8, pin_memory=pin)}
    palette = torch.tensor(PALETTE + ((0, 0, 0),) * (256 - len(PALETTE)),
                           dtype=torch.float32, device=device)
    yy = torch.arange(h, device=device).view(1, h, 1)
    xx = torch.arange(w, device=device).view(1, 1, w)
    counts = torch.zeros(256, dtype=torch.float64, device=device)
    block = 8
    for s in range(0, n, block):
        b = min(block, n - s)
        u = torch.rand((b, 6, 5), generator=gen, device=device)
        base = torch.randint(0, len(PALETTE), (b, 1, 1), generator=gen, device=device)
        label = base.expand(b, h, w).to(torch.uint8).clone()
        for r in range(6):
            y0 = (u[:, r, 0] * (h // 2)).long().view(b, 1, 1)
            x0 = (u[:, r, 1] * (w // 2)).long().view(b, 1, 1)
            y1 = y0 + 4 + (u[:, r, 2].view(b, 1, 1) * (h - 4 - y0)).long()
            x1 = x0 + 4 + (u[:, r, 3].view(b, 1, 1) * (w - 4 - x0)).long()
            cls = (u[:, r, 4] * len(PALETTE)).long().clamp(max=len(PALETTE) - 1)
            inside = (yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1)
            label = torch.where(inside, cls.view(b, 1, 1).to(torch.uint8), label)
        label[:, : h // 8, : w // 8] = IGNORE
        color = palette[label.long()]
        noise = torch.randn(color.shape, generator=gen, device=device) * 12.0
        host["left"][s:s + b].copy_((color + noise).clamp(0, 255).to(torch.uint8))
        host["label"][s:s + b].copy_(label)
        counts += torch.bincount(label.reshape(-1).long(), minlength=256).double()
    order = torch.randperm(n, generator=gen, device=device).cpu()
    host["weather"] = (order % 4).to(torch.int64)
    host["class_counts"] = counts.cpu()
    if pin:
        host["weather"] = host["weather"].pin_memory()
    return host


def class_weights(class_counts: torch.Tensor, num_classes: int, epsilon: float) -> torch.Tensor:
    """The recipe's balanced class weights of the pool's label histogram
    (``frame_pool``'s ``class_counts``), w = 1 / ln(1 + ε + pixel share of
    the class), float32 (C,)."""
    counts = class_counts[:num_classes].double()
    share = counts / counts.sum().clamp_min(1)
    return (1.0 / torch.log(1.0 + epsilon + share)).float()
