"""Model complexity probe — port of the JAX package's ``utils/complexity.py``
(reference ``utils/get_model_complexity.py:1-13``, which used ptflops), with
JAX's keys.

- ``params_m``: the model's parameters, in millions. The JAX model of a
  pyramid ResNet counts 2,880 more: the masked-off taps of its 4×4×12×64
  space-to-depth stem, which the port stores as the dense 7×7×3×64 kernel.
- ``flops_g``: ``torch.utils.flop_counter.FlopCounterMode`` over one eval
  forward, in GFLOP: two a multiply-add of each convolution and matrix
  product, nothing for the elementwise work, the pooling and the
  resampling, which XLA's cost analysis adds (one an element, a little more
  for each interpolation tap).
- ``bytes_accessed_g``: the bytes of every input and output tensor of every
  ATen operation of that forward, in GB, summed from a ``TorchDispatchMode``.
  XLA's figure is taken after fusion, so an intermediate that a fused XLA
  loop keeps in registers counts there once or not at all and here at each
  operation that writes or reads it: the two are not comparable.

The count runs the plain version of each kernel on the forward (the stem as
conv → BN → ReLU → pool, the blends unfused): a kernel launched through
``ctypes`` is no ATen operation, so neither counter would see it, and the
plain versions do the same arithmetic.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

_FUSION_FLAGS = ("fuse_stem", "fuse_inference")


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of each ATen operation's tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten((args, kwargs, out))[0]:
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def model_complexity(model: torch.nn.Module, input_shape: Tuple[int, ...] = (1, 768, 768, 3),
                     device="cuda", **forward_kwargs) -> Dict[str, float]:
    """Returns {'params_m', 'flops_g', 'bytes_accessed_g'} of one eval forward
    of ``model`` (which must live on ``device``: the card unless the caller
    asks for the CPU) on a float32 zero image of ``input_shape`` (NHWC)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("model_complexity: CUDA is not available; pass device='cpu'")
    on = {p.device for p in model.parameters()}
    if any(d.type != device.type for d in on):
        raise ValueError(f"model_complexity: the model's parameters are on {on}, not {device}")
    x = torch.zeros(input_shape, dtype=torch.float32, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    fused = [(m, f, getattr(m, f)) for m in model.modules() for f in _FUSION_FLAGS
             if hasattr(m, f)]
    was_training = model.training
    flops, nbytes = FlopCounterMode(display=False), _BytesMode()
    try:
        for m, f, _ in fused:
            setattr(m, f, False)
        model.eval()
        with torch.no_grad(), flops, nbytes:
            model(x, **forward_kwargs)
    finally:
        for m, f, v in fused:
            setattr(m, f, v)
        model.train(was_training)
    return {
        "params_m": n_params / 1e6,
        "flops_g": flops.get_total_flops() / 1e9,
        "bytes_accessed_g": nbytes.bytes / 1e9,
    }
