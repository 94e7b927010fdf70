"""The port's resizes, pyramid and ×4 upsample-argmax vs their JAX
counterparts in ``ops/interpolate.py`` and ``ops/input_pipeline.py``, f32."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.ops import input_pipeline as jip  # noqa: E402
from doubly_contrastive_semseg_tpu.ops import interpolate as jinterp  # noqa: E402
from doubly_contrastive_semseg_tpu.models.resnet_pyramid import (  # noqa: E402
    IMAGENET_MEAN as JAX_MEAN, IMAGENET_STD as JAX_STD)
from doubly_contrastive_semseg_tpu_torch.ops import input_pipeline as tip  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops import interpolate as tinterp  # noqa: E402


@pytest.mark.parametrize("src,dst", [((6, 10), (12, 20)), ((6, 10), (24, 40)),
                                     ((8, 8), (13, 21)), ((12, 16), (6, 8))])
def test_resize_bilinear_matches_jax(rng, src, dst):
    x = rng.standard_normal((2, *src, 5)).astype(np.float32)
    want = np.asarray(jinterp.resize_bilinear(jnp.asarray(x), dst))
    got = tinterp.resize_bilinear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("hw", [(32, 48), (36, 20)])
def test_downsample_bicubic_direct_matches_jax(rng, level, hw):
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(jinterp.downsample_bicubic_direct(jnp.asarray(x), level))
    got = tinterp.downsample_bicubic_direct(torch.from_numpy(x), level).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_build_pyramid_matches_jax(rng):
    """Normalise, then each level directly from the full image (the JAX
    model reads the same levels in s2d form)."""
    assert tip.IMAGENET_MEAN == JAX_MEAN and tip.IMAGENET_STD == JAX_STD
    x = rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32)
    xn = (jnp.asarray(x) - jnp.asarray(JAX_MEAN)) / jnp.asarray(JAX_STD)
    want = jinterp.pyramid_subsample(xn, 3)
    got = tip.build_pyramid(torch.from_numpy(x), 3)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(8, 12), (5, 7)])
def test_upsample4x_argmax_matches_jax(rng, hw):
    logits = rng.standard_normal((2, *hw, 19)).astype(np.float32)
    want = np.asarray(jip.upsample4x_argmax(jnp.asarray(logits)))
    got = tip.upsample4x_argmax(torch.from_numpy(logits)).numpy()
    assert got.shape == want.shape == (2, 4 * hw[0], 4 * hw[1])
    # equal up to the order of the bilinear arithmetic, which can flip only
    # an exact tie
    assert (got == want).mean() > 0.999
    up = np.asarray(jinterp.resize_bilinear(jnp.asarray(logits), (4 * hw[0], 4 * hw[1])))
    np.testing.assert_array_equal(got, up.argmax(-1))
