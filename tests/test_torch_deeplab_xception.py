"""AlignedXception in the port's DeepLab vs the JAX package's: the whole
model (V3+ at output stride 8, where block 20's last conv keeps dilation 1,
in eval and train mode; V3 at 16 with separable convs in eval mode), the
weights both ways, and the entry, middle and exit blocks in training with
gradients. Method and tolerances as in ``test_torch_deeplab.py``, whose
helpers these are.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from doubly_contrastive_semseg_tpu.models.backbones import xception as jxc  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models.backbones import xception  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import convert  # noqa: E402
from test_torch_deeplab import few_threads, fresh_torch_rng  # noqa: E402,F401 (autouse)
from test_torch_deeplab import check_block, check_forward  # noqa: E402


@pytest.mark.parametrize("arch,output_stride,separable,train", [
    ("deeplabv3plus", 8, False, True),
    ("deeplabv3", 16, True, False),
])
def test_forward_matches_jax(rng, arch, output_stride, separable, train):
    check_forward(rng, arch, "xception", output_stride, separable, train)


@pytest.mark.parametrize("skip,stride,dilation,start_with_relu,last_dilation", [
    ("conv", 2, 1, False, None), ("sum", 1, 2, True, None), ("conv", 1, 2, True, 1)])
def test_xception_block_train_matches_jax(rng, skip, stride, dilation, start_with_relu,
                                          last_dilation):
    cin, feats = (32, (48, 48, 48)) if skip == "conv" else (48, (48, 48, 48))
    x = rng.standard_normal((4, 8, 8, cin)).astype(np.float32)
    port = xception.XBlock(cin, feats, stride, dilation, skip, start_with_relu, last_dilation)
    n = 1 if not start_with_relu else 4

    def name(path):
        return convert._module_name(("backbone", f"block{n}") + path,
                                    {"backbone": {"block20": {}}})[len(f"backbone.block{n}."):]

    check_block(rng, jxc.XBlock(feats, stride, dilation, skip, start_with_relu, last_dilation),
                port, [x], name, (True,))
