"""Modulated deformable convolution (deformable conv v2) — port of the JAX
package's ``ops/deform_conv.py``, which replaces the reference's CUDA
extension (``network/deform_conv_torch1.10``). Plain PyTorch: the JAX
functions are XLA, not Pallas kernels. Autograd gives the backward.

Layout NCHW. ``offset`` is (B, G·K·2, Ho, Wo) with channel ``(g·K + k)·2 +
a``, a = 0 for y and 1 for x; ``mask`` is (B, G·K, Ho, Wo) with channel
``g·K + k``; the weight is torch's (Cout, Cin, kh, kw). Deformable group g
owns input channels [g·Cin/G, (g + 1)·Cin/G). Samples outside the image
read zero.

Two forms, as in JAX:

- ``modulated_deform_conv`` (``gather``): bilinear samples gathered at
  base + offset, then one product with the filter;
- ``modulated_deform_conv_window`` (``window``): offsets clamped to
  ``[-WINDOW_RADIUS, WINDOW_RADIUS]`` (2 px, as ``StereoDCSS`` uses it in
  JAX) and each sample written as a separable sum of hat
  weights over the integer window around its tap. Inside the clamp its
  forward equals the gather form. Its gradient is JAX's, which differs
  from the gather form's at integer offsets (where the zero-initialised
  offset convs start): the hat ``relu(1 − |f − j|)`` is differentiated with
  JAX's conventions, |·|' (0) = 1, relu'(0) = 0 and a clamp at its bound
  passing half the gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

WINDOW_RADIUS = 2


def _out_size(n: int, k: int, stride: int, padding: int, dilation: int) -> int:
    return (n + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def _bilinear_gather(xf: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                     h: int, w: int) -> torch.Tensor:
    """Samples of ``xf`` (B·H·W, c), an NHWC map flattened, at fractional
    (ys, xs) of shape (B, N) → (B, N, c) float32, zero outside the image."""
    b, n = ys.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    base = (torch.arange(b, device=ys.device) * (h * w))[:, None]
    out = 0.0
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yy, xx = y0 + dy, x0 + dx
        weight = ((1 - wy) if dy == 0 else wy) * ((1 - wx) if dx == 0 else wx)
        valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long() + base
        vals = xf.index_select(0, idx.reshape(-1)).view(b, n, -1)
        out = out + torch.where(valid[..., None], weight[..., None] * vals, 0.0)
    return out


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                          weight: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                          stride: int = 1, padding: int = 1, dilation: int = 1,
                          deform_groups: int = 1) -> torch.Tensor:
    """Deformable conv v2, the gather form: (B, Cin,
    H, W) → (B, Cout, Ho, Wo) in x's dtype. The samples and the product
    with the filter are float32, as JAX's promotion of its float32 bilinear
    weights makes them."""
    b, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    k, g = kh * kw, deform_groups
    cg = cin // g
    ho, wo = _out_size(h, kh, stride, padding, dilation), _out_size(w, kw, stride, padding, dilation)
    p = ho * wo
    dev = x.device

    oy = torch.arange(ho, device=dev) * stride - padding
    ox = torch.arange(wo, device=dev) * stride - padding
    ty = torch.arange(kh, device=dev) * dilation
    tx = torch.arange(kw, device=dev) * dilation
    base_y = (oy[:, None, None, None] + ty[None, None, :, None]).expand(ho, wo, kh, kw).reshape(p, k)
    base_x = (ox[None, :, None, None] + tx[None, None, None, :]).expand(ho, wo, kh, kw).reshape(p, k)

    off = offset.float().reshape(b, g, k, 2, p)
    ys = base_y.T[None, None] + off[:, :, :, 0]                      # (B, G, K, P)
    xs = base_x.T[None, None] + off[:, :, :, 1]
    xn = x.permute(0, 2, 3, 1)                                       # (B, H, W, Cin)
    cols = []
    for gi in range(g):
        xf = xn[..., gi * cg:(gi + 1) * cg].reshape(b * h * w, cg)
        sampled = _bilinear_gather(xf, ys[:, gi].transpose(1, 2).reshape(b, p * k),
                                   xs[:, gi].transpose(1, 2).reshape(b, p * k), h, w)
        cols.append(sampled.view(b, p, k, cg))
    col = cols[0] if g == 1 else torch.cat(cols, dim=-1)            # (B, P, K, Cin)
    m = mask.reshape(b, g, k, p).permute(0, 3, 2, 1)                 # (B, P, K, G)
    col = col * (m if g == 1 else m.repeat_interleave(cg, dim=3))
    rhs = weight.permute(2, 3, 1, 0).reshape(k * cin, cout).float()
    out = torch.matmul(col.reshape(b, p, k * cin), rhs).to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.reshape(b, ho, wo, cout).permute(0, 3, 1, 2)


def _abs(t: torch.Tensor) -> torch.Tensor:
    """|t| whose derivative at 0 is 1, as JAX differentiates ``abs``."""
    return torch.where(t >= 0, t, -t)


def _clamp(t: torch.Tensor, r: float) -> torch.Tensor:
    """t clamped to [-r, r], passing half the gradient at a bound, as JAX
    differentiates ``clip`` (torch's ``clamp`` passes all of it)."""
    lo = torch.full((), -r, dtype=t.dtype, device=t.device)
    return torch.minimum(torch.maximum(t, lo), -lo)


def _hat_weights(frac: torch.Tensor, radius: int) -> torch.Tensor:
    """frac (B, G, K, H, W) → (B, G, K, 2r+1, H, W): ``relu(1 − |frac − j|)``
    for the taps j = −r … r, the bilinear hat computed densely. The r + 1
    tap is left out: after the clamp its weight is identically 0."""
    taps = torch.arange(-radius, radius + 1, dtype=frac.dtype, device=frac.device)
    return torch.relu(1.0 - _abs(frac[:, :, :, None] - taps[:, None, None]))


def modulated_deform_conv_window(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                                 weight: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                                 padding: int = 1, dilation: int = 1,
                                 deform_groups: int = 1) -> torch.Tensor:
    """Deformable conv v2 at stride 1 as a dense local window: each sample
    at base + offset, the offset clamped to ``[-WINDOW_RADIUS,
    WINDOW_RADIUS]``, is the
    sum over the integer window around its tap of the shifted input times
    the per-pixel hat weights of y and x (``_hat_weights``; the mask folded
    into y's). The hat weights and the sums run in x's dtype, the product
    with the filter sums in float32; returns x's dtype (JAX
    ``modulated_deform_conv_window``)."""
    b, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    k, g, r = kh * kw, deform_groups, WINDOW_RADIUS
    cg, win = cin // g, 2 * r + 1
    if offset.shape[-2:] != (h, w):
        raise ValueError("window deform conv supports stride 1 only")
    # output (y, x) with tap (ty, tx) reads row y − padding + ty·dilation + oy:
    # pad so that every displacement in the window is an in-bounds slice
    tap_lo = -padding
    tap_hi = -padding + (kh - 1) * dilation
    pad_lo, pad_hi = r - tap_lo, tap_hi + r
    xg = F.pad(x, (pad_lo, pad_hi, pad_lo, pad_hi)).view(b, g, cg, h + pad_lo + pad_hi,
                                                        w + pad_lo + pad_hi)
    off = offset.float().view(b, g, k, 2, h, w)
    cy = _hat_weights(_clamp(off[:, :, :, 0], r), r)                 # (B, G, K, win, H, W)
    cx = _hat_weights(_clamp(off[:, :, :, 1], r), r)
    cy = cy * mask.view(b, g, k, 1, h, w)
    cy, cx = cy.to(x.dtype)[:, :, :, :, None], cx.to(x.dtype)[:, :, :, :, None]

    cols = []
    for kk in range(k):
        ty = tap_lo + (kk // kw) * dilation
        tx = tap_lo + (kk % kw) * dilation
        acc = None
        for j in range(win):
            dy = pad_lo + ty + j - r
            row = None
            for i in range(win):
                dx = pad_lo + tx + i - r
                term = cx[:, :, kk, i] * xg[..., dy:dy + h, dx:dx + w]
                row = term if row is None else row + term
            term = cy[:, :, kk, j] * row
            acc = term if acc is None else acc + term
        cols.append(acc.reshape(b, cin, h, w))
    # one product with the filter over the (tap, channel) columns
    col = torch.cat(cols, dim=1)                                     # (B, K·Cin, H, W)
    rhs = weight.permute(0, 2, 3, 1).reshape(cout, k * cin, 1, 1).to(x.dtype)
    out = F.conv2d(col, rhs)
    if bias is not None:
        out = out + bias.to(out.dtype)[:, None, None]
    return out


class ModulatedDeformConv(nn.Conv2d):
    """The deformable conv's own weight (and bias), under the reference's
    name ``deform_conv``; called with the offsets and mask."""

    def __init__(self, *args, deform_groups: int = 1, **kw):
        super().__init__(*args, **kw)
        self.deform_groups = deform_groups

    def forward(self, x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                impl: str = "gather") -> torch.Tensor:
        if impl == "window" and self.stride[0] == 1:
            return modulated_deform_conv_window(
                x, offset, mask, self.weight, self.bias, padding=self.padding[0],
                dilation=self.dilation[0], deform_groups=self.deform_groups)
        return modulated_deform_conv(
            x, offset, mask, self.weight, self.bias, stride=self.stride[0],
            padding=self.padding[0], dilation=self.dilation[0],
            deform_groups=self.deform_groups)


class DeformConv2d(nn.Module):
    """The offset (and mask) conv feeding the modulated deformable conv
    (reference ``network/deform.py:17-91``; JAX ``DeformConv2d``).

    ``offset_conv`` is grouped by ``deformable_groups`` and starts at zero
    (``reset_offsets``), so the module starts as a plain conv. Its output
    is split as the reference splits it, at 2/3 over all groups: offsets
    are the first G·K·2 channels and the mask the rest, so for G > 1 a
    group's mask comes from another group's conv channels; the mask is the
    doubled sigmoid, so it starts at 1 (the reference's ``modulation`` and
    ``double_mask``, both on wherever it builds this module).
    ``impl`` is ``gather`` or ``window`` (stride 1 only; otherwise the
    gather form runs, as in JAX). The activations' dtype is x's."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 2, dilation: int = 2, deformable_groups: int = 2,
                 impl: str = "gather"):
        super().__init__()
        g, k = deformable_groups, kernel_size * kernel_size
        self.impl = impl
        self.offset_conv = nn.Conv2d(in_features, g * k * 3, kernel_size, stride=stride,
                                     padding=padding, dilation=dilation, groups=g, bias=True)
        self.deform_conv = ModulatedDeformConv(in_features, features, kernel_size, stride=stride,
                                               padding=padding, dilation=dilation, bias=False,
                                               deform_groups=g)
        self.reset_offsets()

    def reset_offsets(self) -> None:
        """Zero the offset conv (JAX's zeros init, reference
        ``deform.py:66-70``)."""
        with torch.no_grad():
            self.offset_conv.weight.zero_()
            self.offset_conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        oc = self.offset_conv
        offset_mask = F.conv2d(x, oc.weight.to(x.dtype), oc.bias.to(x.dtype), oc.stride,
                               oc.padding, oc.dilation, oc.groups)
        off_ch = offset_mask.shape[1] * 2 // 3
        offset = offset_mask[:, :off_ch]
        mask = torch.sigmoid(offset_mask[:, off_ch:]) * 2.0
        return self.deform_conv(x, offset.float(), mask, self.impl)
