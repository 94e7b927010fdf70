"""The recipe's training augmentation, given its crop parameters: a random
square box scaled to 768² (Keys bicubic, a = −0.5, no antialiasing, the
mean colour outside the frame, clipped to [0, 255]), nearest labels (255
outside), γ = 0.4 on night frames, two views, and the boundary weights of
the first view's labels: exp(−d / 2σ), d the distance from each pixel to the
nearest pixel of another class by the label-carrying jump flood (JFA+1 with
8 directions a round, in (dy, dx) raster order), σ the population std of d
over the map, 0 at ignore. Plain float32 PyTorch; the resample contracts
dense weight matrices."""

from __future__ import annotations

from typing import Dict

import torch

MEAN_FILL = (73.15, 82.90, 72.3)
GAMMA = 0.4
NIGHT = 1
IGNORE = 255
BIG = 1e9


def keys_cubic(x: torch.Tensor) -> torch.Tensor:
    x = x.abs()
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x < 1.0, near, torch.where(x < 2.0, far, 0.0))


def weight_matrix(size: int, crop: int, origin: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """(n, crop, size) resample weights of each of the n crops along one
    axis: output o samples source position (o + ½)·box/crop + origin − ½;
    the taps' weights are normalised over the frame, and all zero where the
    position lies outside [−½, size − ½]."""
    s = crop / box
    o = torch.arange(crop, dtype=torch.float32, device=box.device)
    pos = (o[None, :] + 0.5) / s[:, None] + origin[:, None] - 0.5             # (n, crop)
    j = torch.arange(size, dtype=torch.float32, device=box.device)
    wts = keys_cubic(pos[..., None] - j)                                        # (n, crop, size)
    total = wts.sum(-1, keepdim=True)
    wts = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                      wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (pos >= -0.5) & (pos <= size - 0.5)
    return torch.where(inside[..., None], wts, 0.0)


def crop_images(images: torch.Tensor, x0, y0, box, crop: int) -> torch.Tensor:
    """(B, H, W, 3) → (B, crop, crop, 3) float32."""
    b, h, w, _ = images.shape
    wx = weight_matrix(w, crop, x0, box)
    wy = weight_matrix(h, crop, y0, box)
    cols = torch.einsum("bhwc,bow->bhoc", images.float(), wx)
    out = torch.einsum("bph,bhoc->bpoc", wy, cols)
    s = crop / box
    o = torch.arange(crop, dtype=torch.float32, device=images.device) + 0.5
    oy = o[None, :] / s[:, None] + y0[:, None]
    ox = o[None, :] / s[:, None] + x0[:, None]
    inside = ((oy >= 0) & (oy <= h))[:, :, None] & ((ox >= 0) & (ox <= w))[:, None, :]
    fill = torch.tensor(MEAN_FILL, dtype=torch.float32, device=images.device)
    return torch.where(inside[..., None], out, fill).clamp(0.0, 255.0)


def crop_labels(labels: torch.Tensor, x0, y0, box, crop: int) -> torch.Tensor:
    """(B, H, W) → (B, crop, crop): source ⌊origin + i·box/crop⌋ in float32."""
    b, h, w = labels.shape
    step = (box / crop)[:, None]
    i = torch.arange(crop, dtype=torch.float32, device=labels.device)[None, :]
    ys = torch.floor(y0[:, None] + i * step).long()
    xs = torch.floor(x0[:, None] + i * step).long()
    ok = ((ys >= 0) & (ys < h))[:, :, None] & ((xs >= 0) & (xs < w))[:, None, :]
    bi = torch.arange(b, device=labels.device)[:, None, None]
    out = labels[bi, ys.clamp(0, h - 1)[:, :, None], xs.clamp(0, w - 1)[:, None, :]]
    return torch.where(ok, out, torch.full_like(out, IGNORE))


def flood_steps(h: int, w: int):
    steps, s = [], 1
    while s < max(h, w):
        steps.append(s)
        s *= 2
    steps = steps[::-1] + [1]
    return [(ey * s, ex * s) for s in steps for ey in (-1, 0, 1) for ex in (-1, 0, 1)
            if (ey, ex) != (0, 0)]


def other_label_distance(labels: torch.Tensor) -> torch.Tensor:
    """(B, H, W) → (B, H, W) float32: the distance from each pixel to the
    nearest pixel of another label found by the jump flood, 0 where none.
    Each (round, direction) first offers a pixel the seed its neighbour
    holds (if of another label and strictly closer), then the neighbour
    itself (likewise); a neighbour outside the frame offers nothing."""
    b, h, w = labels.shape
    dev = labels.device
    yy = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1).expand(b, h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w).expand(b, h, w)
    lab = labels.long()
    big2 = torch.tensor(BIG, dtype=torch.float32) * torch.tensor(BIG, dtype=torch.float32)
    sy = torch.full((b, h, w), BIG, device=dev)
    sx = torch.full((b, h, w), BIG, device=dev)
    sl = torch.full((b, h, w), -1, dtype=torch.long, device=dev)
    sd = torch.full((b, h, w), float(big2), device=dev)
    for dy, dx in flood_steps(h, w):
        inside = ((yy - dy >= 0) & (yy - dy < h) & (xx - dx >= 0) & (xx - dx < w))

        def nb(t):
            return torch.roll(t, (dy, dx), dims=(1, 2))

        cy, cx, cl = nb(sy), nb(sx), nb(sl)
        cd = (yy - cy) ** 2 + (xx - cx) ** 2
        cd = torch.where(inside & (cy < BIG) & (cl != lab), cd, float(big2))
        take = cd < sd
        sy, sx = torch.where(take, cy, sy), torch.where(take, cx, sx)
        sl, sd = torch.where(take, cl, sl), torch.where(take, cd, sd)
        nl = nb(lab)
        d2 = float(dy * dy + dx * dx)
        take = inside & (nl != lab) & (d2 < sd)
        sy, sx = torch.where(take, yy - dy, sy), torch.where(take, xx - dx, sx)
        sl, sd = torch.where(take, nl, sl), torch.where(take, d2, sd)
    return torch.sqrt(torch.where(sd >= BIG, 0.0, sd))


def boundary_weights(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    d = other_label_distance(labels)
    d = torch.where((labels >= 0) & (labels < num_classes), d, 0.0)
    std = torch.std(d, dim=(-2, -1), keepdim=True, correction=0)
    std = torch.where(std == 0, 1.0, std)
    return torch.where(labels == IGNORE, 0.0, torch.exp(-d / (2.0 * std)))


def augment(images: torch.Tensor, labels: torch.Tensor, weather: torch.Tensor, params,
            crop: int, num_classes: int) -> Dict[str, torch.Tensor]:
    """Raw frames → the step's batch: ``left`` (2B, crop, crop, 3), and of
    the first view ``label`` and ``alpha``. ``params`` = (x0, y0, box),
    each (2, B)."""
    x0, y0, box = params
    night = (weather == NIGHT).view(-1, 1, 1, 1)
    views = []
    for v in range(2):
        im = crop_images(images, x0[v], y0[v], box[v], crop)
        bright = torch.clamp(im / 255.0, 0.0, 1.0) ** GAMMA * 255.0
        views.append(torch.where(night, bright, im))
    label = crop_labels(labels, x0[0], y0[0], box[0], crop)
    return {"left": torch.cat(views, 0), "label": label,
            "alpha": boundary_weights(label, num_classes)}
