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
    fused_stem_pool, pack_stem_weight, stem_im2col, stem_output_hw, stem_pool_cuda_cores,
    stem_pool_reference, stem_pool_tensor_cores, stem_weight_fragments)

COUNTERS = ("launches", "tc_launches", "cc_launches")


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


@pytest.mark.parametrize("shape", [(1, 37, 53), (2, 64, 96), (1, 270, 480)])
def test_im2col_times_packed_weight_is_the_stem(rng, shape):
    """The tensor-core kernel's GEMM in plain form: the columns it gathers,
    times the B operand the wrapper packs, then scale/shift/ReLU/pool, equal
    the stem at f32. This holds the tap order (ky * 22 + 1 + 3 kx + ci) and
    the zero rows that the kernel reads. Tolerance 1e-5 × max|ref|: the
    matmul sums the 147 products in another order than the convolution."""
    x = torch.from_numpy(rng.standard_normal(shape + (3,)).astype(np.float32))
    weight = torch.from_numpy((rng.standard_normal((64, 3, 7, 7)) * 0.1).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, 64).astype(np.float32))
    shift = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    packed = pack_stem_weight(weight, torch.float32)
    assert packed.shape == (160, 64)
    zero_rows = [22 * ky for ky in range(7)] + list(range(154, 160))
    assert not packed[zero_rows].any()
    assert torch.equal(packed[22 * 2 + 1 + 3 * 4 + 1], weight[:, 1, 2, 4])
    cols = stem_im2col(x)
    assert cols.shape == (shape[0], (shape[1] - 1) // 2 + 1, (shape[2] - 1) // 2 + 1, 160)
    y = torch.relu(cols @ packed * scale + shift)
    got = torch.nn.functional.max_pool2d(y.permute(0, 3, 1, 2), 3, stride=2, padding=1)
    want = stem_pool_reference(x, weight, scale, shift)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * want.abs().max().item())


def test_stem_weight_fragments_follow_the_mma_b_layout(rng):
    """The kernel reads uint4 (s * 4 + np) * 32 + lane; its word c holds
    rows k, k + 1 (k = 16 s + 2 (lane % 4) + 8 (c % 2)) of column
    8 (2 np + c // 2) + lane // 4: the m16n8k16 B fragments of two n tiles."""
    packed = torch.from_numpy(rng.standard_normal((160, 64)).astype(np.float32))
    frag = stem_weight_fragments(packed).reshape(-1, 2)
    for i in range(frag.shape[0]):
        q, c = divmod(i, 4)
        sn, lane = divmod(q, 32)
        k = 16 * (sn // 4) + 2 * (lane % 4) + 8 * (c % 2)
        n = 8 * (2 * (sn % 4) + c // 2) + lane // 4
        assert frag[i, 0] == packed[k, n] and frag[i, 1] == packed[k + 1, n], i


@pytest.mark.parametrize("shape", [(1, 64, 32), (1, 108, 32)])
def test_stem_bf16_matches_jax_pallas(rng, shape):
    """The port's plain version at bf16 against the Pallas stem in interpret
    mode at bf16. Tolerance 2e-2 × max|ref|: both take bf16 inputs and
    weights, but round at other places (the Pallas body from its f32 sums
    after the affine, the plain version after the conv, the scale and the
    shift)."""
    b, h2, w2 = shape
    image = rng.standard_normal((b, 2 * h2, 2 * w2, 3)).astype(np.float32)
    kernel = (rng.standard_normal((7, 7, 3, 64)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    shift = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jax_fused_stem_pool(
        jnp.asarray(s2d_pack(image), jnp.bfloat16),
        jnp.asarray(stem_s2d_kernel_from_dense(kernel), jnp.bfloat16),
        jnp.asarray(scale), jnp.asarray(shift), interpret=True).astype(jnp.float32))
    got = fused_stem_pool(torch.from_numpy(image).bfloat16(),
                          torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
                          torch.from_numpy(scale), torch.from_numpy(shift))
    assert got.dtype == torch.bfloat16
    assert got.shape == (b, *stem_output_hw(2 * h2, 2 * w2), 64)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensor_counts_no_launch(dtype):
    """A CPU tensor takes the plain version on either dtype and touches
    neither route's counter; the kernels' own launchers refuse it."""
    args = (torch.randn(1, 16, 24, 3).to(dtype), torch.randn(64, 3, 7, 7),
            torch.ones(64), torch.zeros(64))
    before = {k: getattr(fused_stem_pool, k) for k in COUNTERS}
    out = fused_stem_pool(*args)
    assert out.dtype == dtype
    assert {k: getattr(fused_stem_pool, k) for k in COUNTERS} == before
    for launcher in (stem_pool_tensor_cores, stem_pool_cuda_cores):
        with pytest.raises(ValueError):
            launcher(*args)
    assert {k: getattr(fused_stem_pool, k) for k in COUNTERS} == before
