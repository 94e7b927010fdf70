"""Convolution and linear layers of the reference, with one switch: in the
control, the reference is computed in float8 (e4m3, one scale a tensor),
the step below the bfloat16 that the configurations state: every layer's
inputs and weights are rounded before the float32 product, and every
module's output is stored rounded, as the program stores its activations
in bfloat16. The rounding passes gradients straight through."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0   # the largest finite float8 e4m3 value


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude maps to 448), back in ``x``'s dtype; the gradient passes as
    if unrounded."""
    with torch.no_grad():
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


class Conv2d(nn.Conv2d):
    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.fp8:
            x, w = fp8_round(x), fp8_round(w)
        return self._conv_forward(x, w, self.bias)


class Linear(nn.Linear):
    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.fp8:
            x, w = fp8_round(x), fp8_round(w)
        return F.linear(x, w, self.bias)


def _round_output(module, inputs, output):
    return fp8_round(output) if isinstance(output, torch.Tensor) else output


def set_fp8(model: nn.Module, on: bool) -> nn.Module:
    """Turns the control's float8 rounding on (for good) or leaves the
    model in float32."""
    if not on:
        return model
    for m in model.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.fp8 = True
        if m is not model:
            m.register_forward_hook(_round_output)
    return model


def conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1,
         bias: bool = False) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2), dilation=dilation,
                  bias=bias)


def bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def resize(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of an NCHW map, half-pixel centres."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


MEAN = (73.15, 82.90, 72.3)
STD = (47.67, 48.49, 47.73)


def normalize(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) pixels → (B, 3, H, W) float32 ``(x - mean) / std``, the
    constants of the published models. The models take it on in their
    parameters' dtype."""
    m = torch.tensor(MEAN, dtype=torch.float32, device=image.device)
    s = torch.tensor(STD, dtype=torch.float32, device=image.device)
    return ((image.float() - m) / s).permute(0, 3, 1, 2).contiguous()


class Projection(nn.Module):
    """Linear → ReLU → Linear, the SupCon projection head."""

    def __init__(self, cin: int, cout: int = 128):
        super().__init__()
        self.fc1 = Linear(cin, cin)
        self.fc2 = Linear(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))


class WeatherClassifier(nn.Module):
    """Global average pool → Linear, the weather monitor."""

    def __init__(self, cin: int, n: int = 4):
        super().__init__()
        self.fc = Linear(cin, n)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return self.fc(feat.mean(dim=(2, 3)))


def two_view_pool(feat: torch.Tensor) -> torch.Tensor:
    """(2B, C, h, w) → (B, 2, C): each view's global average pool."""
    pooled = feat.mean(dim=(2, 3))
    b = pooled.shape[0] // 2
    return torch.stack([pooled[:b], pooled[b:]], dim=1)
