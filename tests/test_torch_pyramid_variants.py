"""The port's other pyramid backbones (``models/mobilenetv2_pyramid.py``,
``models/efficientnet_pyramid.py``, ``models/resnet_pyramid_back.py``) vs the
JAX package's, on the CPU in float32 at 128² (the pyramid's three levels
need a multiple of 128), JAX jitted. Method, helpers and tolerances as in
``test_torch_swiftnet_single.py``.

The MobileNetV2 and EfficientNet pyramids' stems are unmasked
space-to-depth kernels, dense 8×8 and 4×4 stride-2 kernels in the port:
each is held at the three image layouts JAX takes (NHWC, planar, s2d).
EfficientNet's drop-connect masks are JAX's, recorded from
``jax.random.bernoulli`` in call order.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.models import efficientnet_pyramid as jeff  # noqa: E402
from doubly_contrastive_semseg_tpu.models import resnet_pyramid_back as jback  # noqa: E402
from doubly_contrastive_semseg_tpu.ops.input_pipeline import s2d_pack  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models import efficientnet_pyramid  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models import resnet_pyramid_back  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops.input_pipeline import s2d_kernel_to_dense  # noqa: E402
from test_torch_deeplab import few_threads  # noqa: E402,F401 (autouse)
from test_torch_deeplab import close, port_from_jax  # noqa: E402
from test_torch_swiftnet_single import (  # noqa: E402
    check_eval, check_jax_block, jax_fns, port_config, random_variables, record_bernoulli)

SP = 128
PYRAMIDS = ("mobilenetv2", "efficientnetb0", "resnet18_back")


@pytest.mark.parametrize("name", PYRAMIDS)
def test_eval_forward_and_serving_match_jax(rng, monkeypatch, name):
    check_eval(rng, monkeypatch, name, SP)


@pytest.mark.parametrize("name,stem,k", [("mobilenetv2", "conv1", 8),
                                          ("efficientnetb0", "stem_conv", 4)])
def test_unmasked_stem_at_every_layout(rng, name, stem, k):
    """The s2d stem JAX stores unmasked is the dense k×k kernel with every
    tap live (slot (a, b, c·4 + 2i + j) → tap (2a + i, 2b + j)), and the
    model matches JAX's on an NHWC, a planar and an s2d-packed image."""
    jmodel, apply, _ = jax_fns(name)
    x = rng.uniform(0, 255, (2, SP, SP, 3)).astype(np.float32)
    params, stats = random_variables(jmodel, jnp.asarray(x), rng)
    port = port_from_jax(port_config(name), params, stats)
    fe = params["net"]["feature_extractor"]
    s2d = fe["conv1_kernel"] if stem == "conv1" else fe["stem_conv"]["kernel"]
    weight = getattr(port.net.feature_extractor, stem).weight.detach().numpy()
    assert weight.shape == (32, 3, k, k) and np.all(weight != 0)
    np.testing.assert_array_equal(weight, s2d_kernel_to_dense(s2d).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(weight[:, 1, 2 * 1 + 1, 2 * 0 + 0], s2d[1, 0, 1 * 4 + 2, :])
    v = {"params": params, "batch_stats": stats}
    for layout, image in (("NHWC", x), ("planar", x.transpose(0, 3, 1, 2)),
                          ("s2d", s2d_pack(x))):
        want = apply(v, jnp.asarray(image))
        with torch.no_grad():
            got = port(torch.from_numpy(np.ascontiguousarray(image)))
        for key in ("seg", "fine_feat"):
            close(got[key].numpy(), want[key], f"{layout} {key}")


# ---- blocks in training -------------------------------------------------------------

@pytest.mark.parametrize("cin,c,t,k,stride,hw,drop", [
    (16, 16, 6, 5, 1, (8, 8), 0.2 * 5 / 16),    # residual: drop-connect, JAX's masks
    (16, 24, 6, 3, 2, (9, 11), 0.0),            # stride 2 on odd sides: TF-SAME asymmetric
    (32, 16, 1, 3, 1, (8, 8), 0.0),             # no expansion (stage 0)
], ids=["residual drop-connect", "stride 2 odd", "no expand"])
def test_mbconv_train_matches_jax(rng, monkeypatch, cin, c, t, k, stride, hw, drop):
    """An MBConv block in training at batch 4 (BN momentum 0.01, eps 1e-3,
    swish, squeeze-excite with biased convs)."""
    x = rng.standard_normal((4,) + hw + (cin,)).astype(np.float32)
    masks = record_bernoulli(monkeypatch)
    port = efficientnet_pyramid.MBConv(cin, c, t, kernel=k, stride=stride, drop_connect=drop)
    check_jax_block(rng, jeff.MBConv(c, t, kernel=k, stride=stride, drop_connect=drop), port,
                    [x], "stage4_1", "stage4_1", jargs=(True,), masks=masks)
    assert len(masks) == (1 if drop else 0)
    if drop:
        assert masks[0].shape == (4, 1, 1, 1)


@pytest.mark.parametrize("cin,planes,stride,level", [(32, 64, 2, 1), (64, 64, 1, 2)])
def test_per_level_bn_block_train_matches_jax(rng, cin, planes, stride, level):
    """The "back" pyramid's block at one pyramid level: that level's BNs
    (and its downsample BN) normalise and move; the other levels' stay."""
    x = rng.standard_normal((4, 8, 8, cin)).astype(np.float32)
    port = resnet_pyramid_back.BasicBlockPerLevelBN(cin, planes, stride)
    before = {k: v.clone() for k, v in port.state_dict().items()}

    def call(m, a):
        return m(a, level)

    check_jax_block(rng, jback.BasicBlockPerLevelBN(planes, stride), port, [x], "layer2_0",
                    "layer2.0", jargs=(True, level), call_port=call, partial=True)
    others = [k for k in before if any(k.startswith(f"{p}_{lv}.") for lv in range(3)
                                       if lv != level for p in ("bn1", "bn2", "downsample_bn"))]
    assert len(others) == (20 if stride == 1 else 30)   # 5 tensors a BN
    assert all(torch.equal(port.state_dict()[k], before[k]) for k in others)
