"""The port's jump-flood EDT (``ops/edt.py``) vs the JAX package's.

On the CPU the port takes its plain versions, JAX's rolls and selects in
JAX's order, so the distances of ``nearest_diff_label_distance`` and
``distance_transform`` are held bit for bit against JAX on blocky label
maps with an ignore patch, thin stripes one and two pixels wide, and the
blocky maps with 5 % salt noise (``ADVICE.md``'s stress case). Squared
distances are sums of squares of small integers, exact in float32, and the
roots are IEEE, so nothing but the algorithm could make them differ.

``label_boundary_weights`` divides by the population std of each map,
which JAX sums in float32 in its own order: on the 88×120 maps JAX's σ is
3.3e-6 (relative) from the exact one and the port's 3e-8, and a weight
exp(−d/2σ) moves by at most d/2σ · e^(−d/2σ) ≤ 0.37 times that. So the
weights are held to JAX within 2e-6, and the port's σ to the float64 std
within 1e-6 (relative).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from scipy.ndimage import distance_transform_edt, zoom  # noqa: E402

from doubly_contrastive_semseg_tpu.ops import edt as jax_edt  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops import edt  # noqa: E402


def blocky(rng, shape=(88, 120), classes=5):
    base = rng.integers(0, classes, (shape[0] // 8 + 1, shape[1] // 8 + 1))
    labels = zoom(base, 8, order=0)[: shape[0], : shape[1]].astype(np.uint8)
    labels[:11, :13] = 255
    return labels


def stripes(shape=(40, 56)):
    """Vertical stripes 1 and 2 pixels wide of 3 labels, and a horizontal
    band: thin regions where seeds must cross other labels."""
    x = np.arange(shape[1])
    labels = np.broadcast_to(((x // 2) % 3 + (x % 7 == 0)) % 3, shape).astype(np.uint8).copy()
    labels[17:19] = 4
    return labels


def salted(rng, density=0.05):
    labels = blocky(rng)
    salt = rng.random(labels.shape) < density
    return np.where(salt, rng.integers(0, 5, labels.shape), labels).astype(np.uint8)


def label_maps(rng):
    return {"blocky": np.stack([blocky(rng), blocky(rng)]),
            "stripes": stripes()[None],
            "salt 0.05": np.stack([salted(rng), salted(rng)])}


def assert_bitwise(got: np.ndarray, want: np.ndarray, what: str):
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32, what
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
        f"{what}: max diff {np.abs(got - want).max()}"


@pytest.mark.parametrize("kind", ["blocky", "stripes", "salt 0.05"])
def test_nearest_diff_label_distance_bitwise_jax(rng, kind):
    labels = label_maps(rng)[kind]
    want = np.asarray(jax_edt.nearest_diff_label_distance(jnp.asarray(labels)))
    launches = edt.nearest_diff_label_distance.launches
    got = edt.nearest_diff_label_distance(torch.from_numpy(labels)).numpy()
    assert edt.nearest_diff_label_distance.launches == launches   # CPU: plain version
    assert_bitwise(got, want, kind)
    # int64 labels and a leading batch of one give the same distances
    got64 = edt.nearest_diff_label_distance(torch.from_numpy(labels[:1].astype(np.int64)))
    assert_bitwise(got64.numpy(), want[:1], f"{kind}, int64")


@pytest.mark.parametrize("kind", ["blocky", "stripes", "salt 0.05"])
def test_distance_transform_bitwise_jax(rng, kind):
    labels = label_maps(rng)[kind]
    mask = labels == labels.reshape(labels.shape[0], -1)[:, -1, None, None]
    want = np.asarray(jax_edt.distance_transform(jnp.asarray(mask)))
    got = edt.distance_transform(torch.from_numpy(mask)).numpy()
    assert_bitwise(got, want, kind)


def test_distance_transform_matches_scipy_where_jfa_is_exact(rng):
    """JFA+1 finds the exact nearest background pixel for a few seeds and
    for rectangles (no seed's Voronoi cell is cut off by another's): equal
    to ``scipy.ndimage.distance_transform_edt`` up to the float32 root."""
    masks = np.ones((3, 48, 64), bool)
    masks[0, 5, 7] = masks[0, 40, 60] = masks[0, 20, 33] = False      # 3 seeds
    masks[1, 10:30, 20:50] = False                                      # a block
    masks[2, :, :8] = False                                             # a band
    masks[2, 44:, :] = False
    got = edt.distance_transform(torch.from_numpy(masks)).numpy()
    for m, g in zip(masks, got):
        np.testing.assert_allclose(g, distance_transform_edt(m), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["blocky", "stripes", "salt 0.05"])
def test_label_boundary_weights_match_jax(rng, kind):
    labels = label_maps(rng)[kind]
    want = np.asarray(jax_edt.label_boundary_weights(jnp.asarray(labels), 5))
    got = edt.label_boundary_weights(torch.from_numpy(labels), 5).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(got == 0, labels == 255)
    # the port's σ against the float64 std of the same distances
    d = edt.nearest_diff_label_distance(torch.from_numpy(labels))
    summed = torch.where(torch.from_numpy(labels < 5), d, 0.0)
    sigma = torch.std(summed, dim=(-2, -1), correction=0)
    np.testing.assert_allclose(sigma.numpy(), summed.double().std(dim=(-2, -1), correction=0),
                               rtol=1e-6)


def test_label_boundary_weights_all_ignore_and_one_label():
    """σ = 0 (one label, or all ignore) is guarded to 1, as in JAX."""
    labels = np.stack([np.full((16, 24), 3, np.uint8), np.full((16, 24), 255, np.uint8)])
    want = np.asarray(jax_edt.label_boundary_weights(jnp.asarray(labels), 19))
    got = edt.label_boundary_weights(torch.from_numpy(labels), 19).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.stack([np.ones((16, 24)), np.zeros((16, 24))]))


@pytest.mark.parametrize("hw,launches", [((768, 768), 88), ((96, 96), 64), ((40, 56), 56),
                                         ((1, 1), 8)])
def test_launch_schedule(hw, launches):
    """One kernel launch per (round, direction): 11 rounds at 768², 8 at
    96² (steps 64 … 1 and the final 1), in JAX's direction order."""
    sched = edt.jfa_launches(*hw)
    rounds = edt.jfa_rounds(*hw)
    s = rounds[0]
    assert len(sched) == launches == 8 * len(rounds)
    assert sched[:8] == [(-s, -s), (-s, 0), (-s, s), (0, -s), (0, s), (s, -s), (s, 0), (s, s)]
    assert rounds[-1] == 1 and rounds == sorted(rounds, reverse=True)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        edt.jump_flood_cuda(torch.zeros((2, 8, 8), dtype=torch.uint8))
