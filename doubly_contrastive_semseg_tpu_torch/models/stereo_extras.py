"""GANet's ``BasicConv`` and ``Conv2x`` — the port's copy of the two blocks
of the JAX package's ``models/stereo_extras.py`` (``_BasicConv``,
``_Conv2x``, ``:309-367``) that the hourglass SwiftNet's disparity branch
uses. The stereo route (``ROADMAP.md`` §1 item 5) extends this module.

Module names are the reference's (``network/feature.py:988-1041``):
``conv`` and ``bn`` in a ``BasicConv``, ``conv1`` and ``conv2`` in a
``Conv2x``. The transposed conv is torch's ``ConvTranspose2d(k=4, s=2,
p=1)``: JAX's SAME ``ConvTranspose`` with its kernel flipped, which
``utils/convert.py`` undoes.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .blocks import Conv2d, ConvTranspose2d, batch_norm


class BasicConv(nn.Module):
    """3×3 conv at ``stride`` (padding 1), or the ×2 transposed conv with
    ``deconv``, → BN → ReLU."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 deconv: bool = False):
        super().__init__()
        if deconv:
            self.conv = ConvTranspose2d(in_features, features, 4, stride=2, padding=1,
                                        bias=False)
        else:
            self.conv = Conv2d(in_features, features, 3, stride=stride, padding=1, bias=False)
        self.bn = batch_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class Conv2x(nn.Module):
    """The U-net step: a stride-2 ``BasicConv`` (or the ×2 transposed one),
    concatenated with the skip (``features`` channels), then a fusing 3×3
    ``BasicConv``."""

    def __init__(self, in_features: int, features: int, deconv: bool = False):
        super().__init__()
        self.conv1 = BasicConv(in_features, features, stride=2, deconv=deconv)
        self.conv2 = BasicConv(2 * features, features)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        return self.conv2(torch.cat([x, skip.to(x.dtype)], dim=1))
