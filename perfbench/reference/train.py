"""The recipe's training steps in the reference: augmentation, the
two-view forward in training mode, the loss, the backward and Adam with L2
decay folded into the gradient (β = (0.9, 0.99), ε = 1e-8), over the
parameter groups that the configuration names; frozen parameters are
left as they are. ``steps`` returns what the benchmark compares: each
step's loss, the first gradient as Adam takes it (decay included), and the
parameters' change over the steps, as norms per leaf."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

from . import augment, losses

BETAS = (0.9, 0.99)
EPS = 1e-8


def groups(model: torch.nn.Module, spec: dict) -> Dict[str, Tuple[float, float]]:
    """{parameter name: (lr, weight decay)} of the trained parameters: the
    first group of ``spec["groups"]`` whose prefixes start the name, none
    for a name under ``spec["frozen"]``."""
    out = {}
    for name, _ in model.named_parameters():
        if any(name.startswith(p) for p in spec["frozen"]):
            continue
        for g in spec["groups"]:
            if any(name.startswith(p) for p in g["prefixes"]):
                out[name] = (g["lr"], g["weight_decay"])
                break
    return out


def steps(model: torch.nn.Module, batches: Iterable[dict], spec: dict, crop: int,
          num_classes: int, class_weight: torch.Tensor, n_steps: int) -> dict:
    """Runs ``n_steps`` steps on ``batches`` (dicts of ``images`` (B, H, W,
    3) uint8, ``labels`` (B, H, W), ``weather`` (B,), ``params`` (x0, y0,
    box) and ``generator``, the step's draws). Returns ``loss`` (a float a
    step), ``grad`` and ``change`` ({name: norm} of the trained leaves)."""
    model.train()
    trained = groups(model, spec)
    params = dict(model.named_parameters())
    start = {n: params[n].detach().clone() for n in trained}
    m = {n: torch.zeros_like(params[n]) for n in trained}
    v = {n: torch.zeros_like(params[n]) for n in trained}
    out = {"loss": [], "parts": [], "grad": {}, "change": {}}
    for t, batch in zip(range(1, n_steps + 1), batches):
        aug = augment.augment(batch["images"], batch["labels"], batch["weather"], batch["params"],
                              crop, num_classes)
        model.zero_grad(set_to_none=True)
        res = model(aug["left"], two_view=True, generator=batch["generator"])
        parts = {}
        loss = losses.total(res, aug["label"], aug["alpha"], batch["weather"], class_weight,
                            batch["generator"], num_classes, parts)
        loss.backward()
        out["loss"].append(float(loss.detach()))
        out["parts"].append(parts)
        with torch.no_grad():
            for name, (lr, wd) in trained.items():
                p = params[name]
                g = p.grad + wd * p
                if t == 1:
                    out["grad"][name] = float(g.norm())
                m[name].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[name].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = (v[name] / (1 - BETAS[1] ** t)).sqrt() + EPS
                p.sub_(lr / (1 - BETAS[0] ** t) * m[name] / denom)
    with torch.no_grad():
        for name in trained:
            out["change"][name] = float((params[name] - start[name]).norm())
    return out


def half_batch(batch: dict) -> dict:
    """The fault that drops the second half of a batch: the step's means
    are then over the first half alone."""
    b = batch["images"].shape[0] // 2
    x0, y0, box = batch["params"]
    return dict(batch, images=batch["images"][:b], labels=batch["labels"][:b],
                weather=batch["weather"][:b], params=(x0[:, :b], y0[:, :b], box[:, :b]))
