"""The port's stereo ops (``ops/cost_volume.py``, ``ops/deform_conv.py``)
against the JAX package's, on the CPU in float32 on numpy-seeded inputs.

Tolerances, each of max|·| of the JAX tensor: cost volumes 1e-5,
soft-argmin 1e-6, deformable conv forwards 1e-5, their gradients (with
respect to x, offsets, mask and kernel, both forms, at random offsets and
at zero offsets) 1e-4. The correlation volume is held to both of JAX's
forms: the per-d shift-and-mean (D < 16) and the band of tile Gram
products (D ≥ 16), each also at a W with no 8-aligned divisor (JAX then
takes the whole row as its tile).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from doubly_contrastive_semseg_tpu.ops import cost_volume as jcv  # noqa: E402
from doubly_contrastive_semseg_tpu.ops import deform_conv as jdc  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops import cost_volume as cv  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops import deform_conv as dc  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import from_jax_variables  # noqa: E402
from test_torch_deeplab import close, few_threads  # noqa: E402,F401 (autouse)

B, G = 2, 2


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def features(rng, w, c=24, h=5):
    return [rng.standard_normal((B, h, w, c)).astype(np.float32) for _ in range(2)]


# ---- cost volumes ----------------------------------------------------------------

@pytest.mark.parametrize("w,d", [(32, 8), (36, 8), (32, 16), (36, 16), (24, 40)],
                         ids=["shift form", "shift form, ragged W", "band form",
                              "band form, whole-row tile", "D > W"])
def test_correlation_volume_matches_jax(rng, w, d):
    left, right = features(rng, w)
    want = jcv.correlation_cost_volume(jnp.asarray(left), jnp.asarray(right), d)
    got = cv.correlation_cost_volume(nchw(left), nchw(right), d)
    assert tuple(got.shape) == (B, d, 5, w)
    close(to_nhwc(got), want, "correlation", 1e-5)


@pytest.mark.parametrize("kind", ["difference", "concat"])
def test_feature_volumes_match_jax(rng, kind):
    left, right = features(rng, 20, c=6)
    want = np.asarray(jcv.cost_volume(jnp.asarray(left), jnp.asarray(right), 8, kind))
    got = cv.cost_volume(nchw(left), nchw(right), 8, kind)    # (B, C, D, H, W)
    close(got.permute(0, 3, 4, 2, 1).numpy(), want, kind, 1e-5)


def test_volume_pyramid_halves_the_range(rng):
    lefts = [features(rng, 32 // 2 ** i)[0] for i in range(3)]
    rights = [features(rng, 32 // 2 ** i)[1] for i in range(3)]
    want = jcv.cost_volume_pyramid([jnp.asarray(v) for v in lefts],
                                   [jnp.asarray(v) for v in rights], 16)
    got = cv.cost_volume_pyramid([nchw(v) for v in lefts], [nchw(v) for v in rights], 16)
    assert [g.shape[1] for g in got] == [16, 8, 4]
    for g, w in zip(got, want):
        close(to_nhwc(g), w, "pyramid", 1e-5)


@pytest.mark.parametrize("match_similarity", [True, False], ids=["similarity", "matching cost"])
def test_soft_argmin_matches_jax(rng, match_similarity):
    cost = rng.normal(0, 3, (B, 6, 10, 24)).astype(np.float32)
    want = jcv.soft_argmin_disparity(jnp.asarray(cost), match_similarity)
    got = cv.soft_argmin_disparity(nchw(cost), match_similarity)
    assert got.dtype == torch.float32
    close(got.numpy(), want, "soft-argmin", 1e-6)


# ---- deformable convolution ------------------------------------------------------

KW = dict(padding=2, dilation=2, deform_groups=G)


def deform_inputs(rng, offsets, h=8, w=8, c=4):
    x = rng.standard_normal((1, h, w, c)).astype(np.float32)
    kernel = rng.standard_normal((3, 3, c, c)).astype(np.float32)
    mask = rng.uniform(0.5, 1.5, (1, h, w, G * 9)).astype(np.float32)
    if offsets == "zero":
        off = np.zeros((1, h, w, G * 9 * 2), np.float32)
    else:
        off = rng.uniform(-1.5, 1.5, (1, h, w, G * 9 * 2)).astype(np.float32)
    return x, off, mask, kernel


def port_deform(impl, x, off, mask, kernel, requires_grad=False):
    ts = [nchw(x), nchw(off).contiguous(), nchw(mask).contiguous(),
          torch.from_numpy(kernel).permute(3, 2, 0, 1).contiguous()]
    for t in ts:
        t.requires_grad_(requires_grad)
    fn = dc.modulated_deform_conv if impl == "gather" else dc.modulated_deform_conv_window
    return fn(*ts, **KW), ts


def jax_fn(impl):
    fn = jdc.modulated_deform_conv if impl == "gather" else jdc.modulated_deform_conv_window
    return lambda *a: fn(*a, **KW)


def jax_deform(impl, *arrays):
    return jax_fn(impl)(*(jnp.asarray(a) for a in arrays))


@pytest.mark.parametrize("impl", ["gather", "window"])
def test_zero_offsets_equal_a_dense_conv(rng, impl):
    x, off, _, kernel = deform_inputs(rng, "zero")
    ones = np.ones((1, 8, 8, G * 9), np.float32)
    got, ts = port_deform(impl, x, off, ones, kernel)
    dense = F.conv2d(ts[0], ts[3], padding=2, dilation=2)
    close(to_nhwc(got), to_nhwc(dense), "vs dense conv", 1e-5)
    close(to_nhwc(got), jax_deform(impl, x, off, ones, kernel), "vs JAX", 1e-5)


@pytest.mark.parametrize("impl", ["gather", "window"])
def test_integer_offsets_shift_the_samples(rng, impl):
    x, off, _, kernel = deform_inputs(rng, "zero")
    off = off.reshape(1, 8, 8, G * 9, 2)
    off[..., 1] = 1.0                                       # every tap one column right
    off = off.reshape(1, 8, 8, -1)
    ones = np.ones((1, 8, 8, G * 9), np.float32)
    got, ts = port_deform(impl, x, off, ones, kernel)
    # tap t of output column x reads column x + 2t − 2 + 1: pad 1 left, 3 right
    shifted = F.conv2d(F.pad(ts[0], (1, 3, 2, 2)), ts[3], dilation=2)
    close(to_nhwc(got), to_nhwc(shifted), "vs shifted conv", 1e-5)
    close(to_nhwc(got), jax_deform(impl, x, off, ones, kernel), "vs JAX", 1e-5)


def test_window_equals_gather_inside_the_radius(rng):
    x, off, mask, kernel = deform_inputs(rng, "random")
    off = off * (1.9 / 1.5)                                  # inside ±2
    window, _ = port_deform("window", x, off, mask, kernel)
    gather, _ = port_deform("gather", x, off, mask, kernel)
    close(to_nhwc(window), to_nhwc(gather), "window vs gather", 1e-5)
    close(to_nhwc(window), jax_deform("window", x, off, mask, kernel), "vs JAX", 1e-5)


def test_window_clamps_offsets_beyond_the_radius(rng):
    x, off, mask, kernel = deform_inputs(rng, "random")
    big = np.where(rng.uniform(size=off.shape) < 0.5, 10.0, -7.5).astype(np.float32)
    capped = np.clip(big, -2.0, 2.0)
    got, _ = port_deform("window", x, big, mask, kernel)
    want, _ = port_deform("gather", x, capped, mask, kernel)
    close(to_nhwc(got), to_nhwc(want), "clamped vs gather at the bound", 1e-5)
    close(to_nhwc(got), jax_deform("window", x, big, mask, kernel), "vs JAX", 1e-5)


@pytest.mark.parametrize("impl", ["gather", "window"])
@pytest.mark.parametrize("offsets", ["random", "zero"])
def test_gradients_match_jax(rng, impl, offsets):
    """x, offsets, mask and kernel gradients under one random cotangent.
    At zero offsets the two forms' offset gradients differ (the hat's
    derivative at an integer), and each must give JAX's own."""
    x, off, mask, kernel = deform_inputs(rng, offsets)
    cot = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    fn = jax_fn(impl)
    want = jax.grad(lambda *a: jnp.sum(fn(*a) * cot), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, off, mask, kernel)))
    out, ts = port_deform(impl, x, off, mask, kernel, requires_grad=True)
    out.backward(nchw(cot))
    got = [to_nhwc(ts[0].grad), to_nhwc(ts[1].grad), to_nhwc(ts[2].grad),
           ts[3].grad.permute(2, 3, 1, 0).numpy()]
    for name, g, w in zip(("x", "offset", "mask", "kernel"), got, want):
        close(g, w, f"{impl} {offsets}: d{name}", 1e-4)


def test_window_and_gather_offset_gradients_differ_at_zero(rng):
    """Why the window form is not "clamp, then gather": at integer offsets
    its offset gradient is not the gather form's."""
    x, off, mask, kernel = deform_inputs(rng, "zero")
    grads = {}
    for impl in ("gather", "window"):
        out, ts = port_deform(impl, x, off, mask, kernel, requires_grad=True)
        out.sum().backward()
        grads[impl] = ts[1].grad
    gap = (grads["window"] - grads["gather"]).abs().max() / grads["gather"].abs().max()
    assert gap > 0.1


@pytest.mark.parametrize("impl", ["gather", "window"])
def test_module_splits_offsets_and_mask_across_groups(rng, impl):
    """``DeformConv2d`` with a random grouped offset conv: the reference's
    global 2/3 split of its output (a group's mask comes from the other
    group's conv channels), the doubled sigmoid, forward and gradients
    against JAX's module."""
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    jmod = jdc.DeformConv2d(4, impl=impl)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0),
                                                          jnp.asarray(x))["params"])
    params["offset_conv"]["kernel"] = rng.normal(0, 0.3, params["offset_conv"]["kernel"].shape
                                                 ).astype(np.float32)
    params["offset_conv"]["bias"] = rng.normal(0, 0.3, params["offset_conv"]["bias"].shape
                                               ).astype(np.float32)
    sd = from_jax_variables({"mdconv": params}, {})
    port = dc.DeformConv2d(4, 4, impl=impl)
    port.load_state_dict({k[len("conv2."):]: v for k, v in sd.items()}, strict=True)
    assert set(sd) == {"conv2.offset_conv.weight", "conv2.offset_conv.bias",
                       "conv2.deform_conv.weight"}
    cot = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    def run(p, v, c):
        y, vjp = jax.vjp(lambda p, v: jmod.apply({"params": p}, v), p, v)
        return y, vjp(c)

    y, (gp, gx) = run(params, jnp.asarray(x), jnp.asarray(cot))
    xt = nchw(x).requires_grad_(True)
    out = port(xt)
    out.backward(nchw(cot))
    close(to_nhwc(out), y, "output", 1e-5)
    close(to_nhwc(xt.grad), gx, "dx", 1e-4)
    close(port.offset_conv.weight.grad.permute(2, 3, 1, 0).numpy(),
          gp["offset_conv"]["kernel"], "offset conv kernel gradient", 1e-4)
    close(port.deform_conv.weight.grad.permute(2, 3, 1, 0).numpy(), gp["kernel"],
          "kernel gradient", 1e-4)
