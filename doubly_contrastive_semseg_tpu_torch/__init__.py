"""PyTorch/CUDA port of ``doubly_contrastive_semseg_tpu`` for NVIDIA Hopper.

The JAX package beside it is the reference. This package imports torch,
never JAX; its CUDA kernels live in ``csrc/`` and are built at first use.
"""

from .config import Config
from .models import (DCSSModel, StereoDCSS, build_model, build_stereo_model, make_serving_fn,
                     make_stereo_serving_fn)
