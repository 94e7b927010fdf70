"""The port's fused upsample-blend (``ops/blend.py``) on the CPU, where it
runs its plain version, vs the JAX package's Pallas kernel in interpret
mode on the same numpy-seeded inputs.

Tolerance: the one ``tests/test_blend_pallas.py`` holds the JAX kernel to
against a dtype-matched reference, elementwise rtol = atol = 2e-2, and mean
|diff| / mean |want| < 2e-2. The plain version rounds to bf16 where the
Pallas body does (x, skip, each bilinear product and sum, pre-activation,
activation, weights). Measured at these shapes: max |diff| 2.0e-3 to
2.6e-3 of max |want| at float32 output (6.3e-3 at bf16 output, one bf16
ulp), up to 0.95 of the elementwise bar, and mean |diff| / mean |want|
1.8e-3 to 2.1e-3. The JAX tests' own dtype-matched reference (bf16
``resize_bilinear``, bf16 add, f32 BN, bf16 conv with f32 accumulation)
differs from the interpret-mode kernel by the same amounts, and the plain
version agrees with that reference to 6e-7 of its max at 8×8 and 16×24:
the gap is the interpret mode's own arithmetic.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.ops import blend_pallas  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops import blend  # noqa: E402

C = 128


def blend_inputs(rng, b, hh, ww, c=C):
    return dict(
        x=rng.standard_normal((b, hh // 2, ww // 2, c)).astype(np.float32),
        skip=rng.standard_normal((b, hh, ww, c)).astype(np.float32),
        kernel=(rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32),  # HWIO
        scale=rng.uniform(0.5, 1.5, c).astype(np.float32),
        bias=rng.standard_normal(c).astype(np.float32),
        mean=rng.standard_normal(c).astype(np.float32),
        var=rng.uniform(0.5, 2.0, c).astype(np.float32))


def port_call(fn, a, out_dtype):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    return fn(t["x"], t["skip"], t["kernel"].permute(3, 2, 0, 1), t["scale"], t["bias"],
              t["mean"], t["var"], out_dtype=out_dtype)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(8, 8), (16, 24), (64, 64)])
def test_fused_blend_matches_jax_kernel(rng, hw, out_dtype):
    a = blend_inputs(rng, 2, *hw)
    want = np.asarray(blend_pallas.fused_upsample_blend(
        *(jnp.asarray(a[k]) for k in ("x", "skip", "kernel", "scale", "bias", "mean", "var")),
        out_dtype=getattr(jnp, out_dtype), interpret=True)).astype(np.float32)
    before = blend.fused_upsample_blend.launches
    got_t = port_call(blend.fused_upsample_blend, a, getattr(torch, out_dtype))
    assert blend.fused_upsample_blend.launches == before  # CPU: plain version only
    assert got_t.dtype == getattr(torch, out_dtype) and got_t.is_contiguous()
    got = got_t.float().numpy()
    assert got.shape == want.shape == (2, *hw, C)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    assert np.abs(got - want).mean() / np.abs(want).mean() < 2e-2


def test_reference_is_the_unfused_step_in_f32_on_bf16_values(rng):
    """With inputs and weights already bf16-exact and BN the identity, the
    plain version is interpolate → add → ReLU → conv in float32 up to the
    two bf16 roundings of the activation."""
    a = blend_inputs(rng, 1, 16, 16)
    bf = {k: torch.from_numpy(v).to(torch.bfloat16).float() for k, v in a.items()}
    c = torch.ones(C), torch.zeros(C), torch.zeros(C), torch.ones(C) - 1e-5
    got = blend.upsample_blend_reference(bf["x"], bf["skip"], bf["kernel"].permute(3, 2, 0, 1),
                                         *c, out_dtype=torch.float32)
    up = torch.nn.functional.interpolate(bf["x"].permute(0, 3, 1, 2), size=(16, 16),
                                         mode="bilinear", align_corners=False)
    act = torch.relu(up + bf["skip"].permute(0, 3, 1, 2))
    want = torch.nn.functional.conv2d(act, bf["kernel"].permute(3, 2, 0, 1), padding=1)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(),
                               rtol=2e-2, atol=2e-2)


def test_kernel_supported_matches_jax():
    for h in (8, 12, 16, 64, 68, 135, 270, 256):
        for w in (8, 24, 34, 72, 512, 480):
            for c in (64, 128, 192, 256):
                assert blend.blend_kernel_supported(h, w, c) == \
                    blend_pallas.blend_kernel_supported(h, w, c), (h, w, c)


@pytest.mark.parametrize("case", ["odd_rows", "narrow", "channels", "not_half", "weight", "bn"])
def test_unsupported_shapes_raise(rng, case):
    a = {k: torch.from_numpy(v) for k, v in blend_inputs(rng, 1, 16, 16).items()}
    w = a["kernel"].permute(3, 2, 0, 1)
    bn = [a["scale"], a["bias"], a["mean"], a["var"]]
    x, skip = a["x"], a["skip"]
    if case == "odd_rows":      # 12 output rows: not a multiple of 8
        x, skip = x[:, :6], skip[:, :12]
    elif case == "narrow":      # 12 output cols
        x, skip = x[:, :, :6], skip[:, :, :12]
    elif case == "channels":    # 64 channels
        x, skip, w, bn = x[..., :64], skip[..., :64], w[:64, :64], [t[:64] for t in bn]
    elif case == "not_half":    # x is not half the skip's size
        x = x[:, :4]
    elif case == "weight":      # a 1×1 kernel
        w = w[:, :, :1, :1]
    else:
        bn[0] = bn[0][:64]
    with pytest.raises(ValueError):
        blend.fused_upsample_blend(x, skip, w, *bn)
    with pytest.raises(TypeError, match="out_dtype"):
        blend.fused_upsample_blend(a["x"], a["skip"], a["kernel"].permute(3, 2, 0, 1),
                                   a["scale"], a["bias"], a["mean"], a["var"],
                                   out_dtype=torch.float16)
