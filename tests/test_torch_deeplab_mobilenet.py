"""MobileNetV2 in the port's DeepLab vs the JAX package's: the whole model
(V3+ at output stride 16 with separable convs in eval mode, V3 at 8 in
eval and train mode), the weights both ways, and the inverted-residual
block in training with gradients. Method and tolerances as in
``test_torch_deeplab.py``, whose helpers these are.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from doubly_contrastive_semseg_tpu.models.backbones import mobilenetv2 as jmb  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models.backbones import mobilenetv2  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import convert  # noqa: E402
from test_torch_deeplab import few_threads  # noqa: E402,F401 (autouse)
from test_torch_deeplab import check_block, check_forward  # noqa: E402


@pytest.mark.parametrize("arch,backbone,output_stride,separable,train", [
    ("deeplabv3plus", "mobilenetv2", 16, True, False),
    ("deeplabv3", "mobilenetv2", 8, False, True),
])
def test_forward_matches_jax(rng, arch, backbone, output_stride, separable, train):
    check_forward(rng, arch, backbone, output_stride, separable, train)


@pytest.mark.parametrize("cin,features,stride,dilation,t", [
    (32, 32, 1, 2, 6), (24, 32, 2, 1, 6), (32, 16, 1, 1, 1)])
def test_inverted_residual_train_matches_jax(rng, cin, features, stride, dilation, t):
    """The fork's padded block input: the expand's BN shifts the zero border
    that the depthwise conv then reads."""
    x = rng.standard_normal((4, 9, 9, cin)).astype(np.float32)
    port = mobilenetv2.InvertedResidual(cin, features, stride, dilation, t)
    layout = {"stem": {}, "block5": {"expand": {}} if t != 1 else {}}
    prefix = "backbone.high_level_features.5.conv."

    def name(path):
        return convert._module_name(("backbone", "block5") + path,
                                    {"backbone": layout})[len(prefix) - len("conv."):]

    check_block(rng, jmb.InvertedResidual(features, stride, dilation, t), port, [x], name,
                (True,))
