"""The port's stem (dense 7×7 conv → BN → ReLU → pool, its plain version on
the CPU) vs the JAX fused Pallas stem in interpret mode, which reads the s2d
packing of the same image and the s2d form of the same dense kernel."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.ops.input_pipeline import (  # noqa: E402
    s2d_pack, stem_s2d_kernel_from_dense)
from doubly_contrastive_semseg_tpu.ops.stem_pallas import (  # noqa: E402
    fused_stem_pool as jax_fused_stem_pool)
from doubly_contrastive_semseg_tpu_torch.ops.input_pipeline import (  # noqa: E402
    stem_dense_kernel_from_s2d)
from doubly_contrastive_semseg_tpu_torch.ops.stem import (  # noqa: E402
    fused_stem_pool, stem_output_hw, stem_pool_reference)


# (batch, s2d rows, s2d cols) as in tests/test_stem_pallas.py: the dense
# image is twice that; (1, 108, 32) and (1, 140, 48) have ragged heights
@pytest.mark.parametrize("shape", [(1, 64, 32), (2, 128, 48),
                                   (1, 108, 32), (1, 140, 48)])
def test_stem_matches_jax_pallas(rng, shape):
    b, h2, w2 = shape
    image = rng.standard_normal((b, 2 * h2, 2 * w2, 3)).astype(np.float32)
    kernel = (rng.standard_normal((7, 7, 3, 64)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    shift = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jax_fused_stem_pool(
        jnp.asarray(s2d_pack(image)), jnp.asarray(stem_s2d_kernel_from_dense(kernel)),
        jnp.asarray(scale), jnp.asarray(shift), interpret=True))

    args = (torch.from_numpy(image), torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(scale), torch.from_numpy(shift))
    before = fused_stem_pool.launches
    got = fused_stem_pool(*args)  # a CPU tensor takes the plain version
    assert fused_stem_pool.launches == before
    np.testing.assert_array_equal(got.numpy(), stem_pool_reference(*args).numpy())
    assert got.shape == (b, *stem_output_hw(2 * h2, 2 * w2), 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("h,w", [(1080, 1920), (270, 480), (135, 240), (7, 5), (1, 1)])
def test_stem_output_size_matches_torch(h, w):
    """conv(7, s2, p3) then maxpool(3, s2, p1), odd sizes included: the
    1920×1080 level 2 (270 rows) pools 135 conv rows to 68."""
    x = torch.zeros((1, h, w, 3))
    y = stem_pool_reference(x, torch.zeros(64, 3, 7, 7), torch.ones(64), torch.zeros(64))
    assert tuple(y.shape[1:3]) == stem_output_hw(h, w)


def test_stem_kernel_dense_s2d_round_trip(rng):
    dense = rng.standard_normal((7, 7, 3, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        stem_dense_kernel_from_s2d(stem_s2d_kernel_from_dense(dense)), dense)


def test_stem_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        fused_stem_pool(torch.zeros(1, 8, 8, 4), torch.zeros(64, 3, 7, 7),
                        torch.ones(64), torch.zeros(64))
    with pytest.raises(ValueError):
        fused_stem_pool(torch.zeros(1, 8, 8, 3), torch.zeros(7, 7, 3, 64),
                        torch.ones(64), torch.zeros(64))
