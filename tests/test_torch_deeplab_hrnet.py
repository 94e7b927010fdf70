"""HRNetV2 in the port's DeepLab vs the JAX package's: the whole model
(W32, V3+, in eval and train mode; HRNet's ASPP rates are [12, 24, 36] at
either output stride), the weights both ways, and one HRNet module in
training with gradients. W48 differs from W32 in its widths alone, which
``test_torch_deeplab.py``'s route test holds (720 channels out). Method and tolerances as in
``test_torch_deeplab.py``, whose helpers these are.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from doubly_contrastive_semseg_tpu.models.backbones import hrnetv2 as jhr  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models.backbones import hrnetv2  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import convert  # noqa: E402
from test_torch_deeplab import few_threads, fresh_torch_rng  # noqa: E402,F401 (autouse)
from test_torch_deeplab import check_block, check_forward  # noqa: E402


def test_forward_matches_jax(rng):
    check_forward(rng, "deeplabv3plus", "hrnetv2_32", 8, False)


class _JaxHRModule(jhr.nn.Module):
    """One HRNet module as JAX's ``HRNetV2`` wires it: each branch's basic
    blocks, then the exchange unit; returns branch ``pick``."""

    widths: tuple
    pick: int

    @jhr.nn.compact
    def __call__(self, a, b, c, train):
        ys = [a, b, c]
        for i, wi in enumerate(self.widths):
            for k in range(2):
                ys[i] = jhr.HRBasicBlock(wi, name=f"s3_m0_b{i}_blk{k}")(ys[i], train)
        return jhr.ExchangeUnit(self.widths, name="s3_m0_fuse")(ys, train)[self.pick]


@pytest.mark.parametrize("pick", [0, 2])
def test_hrnet_module_train_matches_jax(rng, pick):
    """Three branches at 1, 1/2 and 1/4: basic blocks, strided 3×3 chains
    down (two steps into branch 2), 1×1 and nearest replication up (×4
    into branch 0); one output at a time."""
    w = (8, 16, 32)
    xs = [rng.standard_normal((4, 16 >> i, 16 >> i, c)).astype(np.float32)
          for i, c in enumerate(w)]
    port = hrnetv2.HRModule(w, 2)

    def name(path):
        return convert._module_name(("backbone",) + path,
                                    {"backbone": {"stem_bn0": {}}})[len("backbone.stage3.0."):]

    check_block(rng, _JaxHRModule(w, pick), port, xs, name, (True,),
                call_port=lambda m, a, b, c: m([a, b, c])[pick])
