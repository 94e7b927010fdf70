"""The port's serving head (its plain version on the CPU) vs the JAX fused
Pallas head in interpret mode and vs the f32 reference path."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.ops.interpolate import (  # noqa: E402
    resize_bilinear as jax_resize_bilinear)
from doubly_contrastive_semseg_tpu.ops.seghead_pallas import (  # noqa: E402
    fused_seghead_upsample_argmax as jax_fused_seghead)
from doubly_contrastive_semseg_tpu_torch.ops.seghead import (  # noqa: E402
    fused_seghead_upsample_argmax, seghead_reference)


def _head_args(rng, b, h, w, cin=128, c=19):
    return dict(
        feat=rng.standard_normal((b, h, w, cin)).astype(np.float32),
        bn_scale=rng.uniform(0.5, 1.5, cin).astype(np.float32),
        bn_bias=rng.standard_normal(cin).astype(np.float32),
        bn_mean=rng.standard_normal(cin).astype(np.float32),
        bn_var=rng.uniform(0.5, 2.0, cin).astype(np.float32),
        conv_weight=rng.standard_normal((cin, c)).astype(np.float32),  # (I, O)
        conv_bias=rng.standard_normal(c).astype(np.float32))


def _port(args, dtype=torch.float32):
    t = {k: torch.from_numpy(v) for k, v in args.items()}
    t["feat"] = t["feat"].to(dtype)
    t["conv_weight"] = t["conv_weight"].t().contiguous()  # (C, 128)
    before = fused_seghead_upsample_argmax.launches
    out = fused_seghead_upsample_argmax(**t)
    assert fused_seghead_upsample_argmax.launches == before  # CPU: plain version
    np.testing.assert_array_equal(out.numpy(), seghead_reference(**t).numpy())
    return out.numpy()


def _f32_reference(a, eps=1e-5):
    xhat = (a["feat"] - a["bn_mean"]) / np.sqrt(a["bn_var"] + eps) * a["bn_scale"] + a["bn_bias"]
    logits = np.einsum("bhwc,co->bhwo", np.maximum(xhat, 0.0), a["conv_weight"]) + a["conv_bias"]
    up = jax_resize_bilinear(jnp.asarray(logits),
                             (a["feat"].shape[1] * 4, a["feat"].shape[2] * 4))
    return np.asarray(jnp.argmax(up, axis=-1))


# (14, 24): h not a multiple of the TPU tile; (13, 30): w not a multiple of 8
@pytest.mark.parametrize("h,w", [(16, 24), (14, 24), (13, 30)])
def test_seghead_matches_jax_pallas(rng, h, w):
    a = _head_args(rng, 2, h, w)
    jax_kernel = np.asarray(jax_fused_seghead(
        *(jnp.asarray(a[k]) for k in ("feat", "bn_scale", "bn_bias", "bn_mean",
                                      "bn_var", "conv_weight", "conv_bias")),
        interpret=True))
    want32 = _f32_reference(a)
    got = _port(a)
    assert got.shape == (2, 4 * h, 4 * w) and got.dtype == np.int8
    # random-normal logits have thin argmax margins: the TPU kernel's bf16
    # rounding flips a small tail of near-ties (tests/test_seghead_pallas.py)
    assert (got == jax_kernel).mean() > 0.995
    assert (got == want32).mean() > 0.99
    # the port in bf16 rounds as the TPU kernel does
    assert (_port(a, torch.bfloat16) == jax_kernel).mean() > 0.995


def test_seghead_never_picks_a_class_out_of_range(rng):
    """Every logit negative (class bias -1000): the TPU kernel's padded
    classes (scored ~0) would win everywhere if their masking broke; the
    port has no padded classes and must agree with it."""
    a = _head_args(rng, 1, 16, 8)
    a.update(bn_scale=np.ones(128, np.float32), bn_bias=np.zeros(128, np.float32),
             bn_mean=np.zeros(128, np.float32), bn_var=np.ones(128, np.float32),
             conv_bias=np.full(19, -1000.0, np.float32))
    got = _port(a)
    assert got.max() < 19
    jax_kernel = np.asarray(jax_fused_seghead(
        *(jnp.asarray(a[k]) for k in ("feat", "bn_scale", "bn_bias", "bn_mean",
                                      "bn_var", "conv_weight", "conv_bias")),
        interpret=True))
    assert (got == jax_kernel).mean() > 0.995


def test_seghead_wrapper_rejects_bad_shapes():
    feat = torch.zeros(1, 4, 4, 64)
    with pytest.raises(ValueError):
        fused_seghead_upsample_argmax(feat, *([torch.ones(64)] * 4),
                                      torch.zeros(19, 64), torch.zeros(19))
    with pytest.raises(ValueError):
        fused_seghead_upsample_argmax(torch.zeros(1, 4, 4, 128), *([torch.ones(128)] * 4),
                                      torch.zeros(40, 128), torch.zeros(40))
