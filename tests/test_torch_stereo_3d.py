"""The port's 3-D cost aggregations (``models/stereo_extras.py``) and
``ops/warp.py`` against the JAX package's, on the CPU in float32.

Weights go from JAX to the port: numpy draws of the shapes of JAX's
``init`` (``random_variables``: kernels He-normal, BN affine and running
statistics random), carried by ``from_jax_variables`` and loaded strictly.
Volumes are JAX's (B, D, H, W, C) and the port's (B, C, D, H, W); an
aggregation's output JAX's (B, H, W, D) and the port's (B, D, H, W).

Tolerances, each of max|·| of the JAX tensor: ``disp_warp`` and
``upsample_volume_4x`` 1e-6 (the same operations); eval outputs 1e-4; in
training a block's output and running statistics 1e-4, a whole
aggregation's 1e-2 (JAX's ``TorchBatchNorm`` takes a one-pass float32
variance). Backward (``check_training_grads``): each block's and each
aggregation's output, input and parameter gradients from one random
output cotangent, 1e-4 of max|·| (a gradient below ``ZERO_GRAD`` of the
module's largest, structurally zero, only held below it). Volumes are small (D, H, W of 4–16, 8 input channels) but keep
the published widths inside (32 to 128 channels); PSMNet's hourglass
needs D, H, W multiples of 4, GCNet multiples of 16.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.models import stereo_extras as jextras  # noqa: E402
from doubly_contrastive_semseg_tpu.ops.warp import disp_warp as jax_disp_warp  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.torch_convert import (  # noqa: E402
    convert_reference_psmnet_hg, jax_to_py)
from doubly_contrastive_semseg_tpu_torch.models import stereo_extras  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops.warp import disp_warp  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import from_jax_variables  # noqa: E402
from test_torch_deeplab import assert_same_tree, close, few_threads  # noqa: E402,F401
from test_torch_swiftnet_single import random_variables  # noqa: E402

CIN = 8   # the volume's channels
ZERO_GRAD = 1e-5


def port_state(key, params, stats):
    """A JAX block's variables as the port block's ``state_dict``, mapped
    as ``from_jax_variables`` maps the block at ``key`` of ``StereoDCSS``."""
    sd = from_jax_variables({key: params} if params else {}, {key: stats} if stats else {})
    return {k[len(key) + 1:]: v for k, v in sd.items()}


def ncdhw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 4, 1, 2, 3)


def to_port(a, raw=False) -> torch.Tensor:
    """A JAX volume (B, D, H, W, C) or map (B, H, W, C) as a contiguous
    port leaf tensor (B, C, D, H, W) or (B, C, H, W); a disparity (B, H, W),
    or any array when ``raw``, as it is."""
    perm = {5: (0, 4, 1, 2, 3), 4: (0, 3, 1, 2)}.get(a.ndim)
    return torch.from_numpy(np.ascontiguousarray(a if raw or perm is None
                                                 else np.transpose(a, perm)))


def from_port(t: torch.Tensor) -> np.ndarray:
    """A port volume (B, C, D, H, W), an aggregation's (B, D, H, W) or a
    map (B, C, H, W) in JAX's order; a disparity (B, H, W) as it is."""
    perm = {5: (0, 2, 3, 4, 1), 4: (0, 2, 3, 1)}.get(t.dim(), tuple(range(t.dim())))
    return t.detach().permute(*perm).numpy()


def check_module(rng, jmod, port, x, key, train, tol):
    """``jmod`` and ``port`` (the module at ``key`` of ``StereoDCSS``) on
    the volume ``x`` (B, D, H, W, C) from JAX's variables, in eval or in
    training: every output within ``tol`` of max|·|, and in training the
    running statistics within rtol ``tol``. Returns (params, stats)."""
    params, stats = random_variables(jmod, jnp.asarray(x), rng, jargs=(False,))
    port.load_state_dict(port_state(key, params, stats), strict=True)
    apply = jax.jit(jmod.apply, static_argnums=(2,), static_argnames="mutable")
    v = {"params": params, "batch_stats": stats}
    if train:
        want, new = apply(v, jnp.asarray(x), True, mutable="batch_stats")
    else:
        want = apply(v, jnp.asarray(x), False)
    port.train(train)
    with torch.no_grad():
        got = port(ncdhw(x))
    got, want = (got, want) if isinstance(got, list) else ([got], [want])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(from_port(g).shape) == tuple(w.shape)
        close(from_port(g), w, f"{key} output", tol)
    if train:
        sd = port.state_dict()
        for k, w in port_state(key, {}, jax_to_py(new["batch_stats"])).items():
            if not k.endswith("num_batches_tracked"):
                w = w.numpy()
                np.testing.assert_allclose(sd[k].numpy(), w, rtol=tol,
                                           atol=tol * np.abs(w).max(), err_msg=k)
    return params, stats


def check_training_grads(rng, jmod, port, key, xs, params, stats, listed=False, jit=True,
                         raw=()):
    """``jmod`` and ``port`` (the module at ``key`` of ``StereoDCSS``) in
    training from JAX's variables, on the inputs ``xs`` in JAX's layout (one
    list argument when ``listed``; those at the indices ``raw``, the
    refinements' NHWC images, go to the port as they are) and one random
    cotangent an output: each output, input gradient and parameter gradient
    within 1e-4 of max|·| of JAX's (module docstring), running stats rtol
    1e-4. ``jit`` compiles JAX's forward and backward (not the window
    deformable form, whose unrolled sums compile slower than they run)."""
    port.load_state_dict(port_state(key, params, stats), strict=True)

    def f(p, *a):
        return jmod.apply({"params": p, "batch_stats": stats}, *([list(a)] if listed else a),
                          True, mutable="batch_stats")

    def run(p, cot, *a):
        y, vjp_fn, new = jax.vjp(f, p, *a, has_aux=True)
        return y, vjp_fn(cot), new

    jx = [jnp.asarray(x) for x in xs]
    y_shape = jax.eval_shape(f, params, *jx)[0]
    cots = [rng.standard_normal(s.shape).astype(np.float32)
            for s in (y_shape if isinstance(y_shape, list) else [y_shape])]
    jcot = [jnp.asarray(c) for c in cots] if isinstance(y_shape, list) else jnp.asarray(cots[0])
    want, grads, new = (jax.jit(run) if jit else run)(params, jcot, *jx)
    want = want if isinstance(want, list) else [want]

    port.train()
    xt = [to_port(x, i in raw).requires_grad_(True) for i, x in enumerate(xs)]
    got = port(*([xt] if listed else xt))
    got = got if isinstance(got, list) else [got]
    assert len(got) == len(want)
    torch.autograd.backward(got, [to_port(c) for c in cots])
    for g, w in zip(got, want):
        close(from_port(g), w, f"{key} output")
    for i, x in enumerate(xt):
        close(x.grad.numpy() if i in raw else from_port(x.grad), grads[1 + i],
              f"{key} input {i} gradient")
    want_g = {k: v.numpy() for k, v in port_state(key, jax_to_py(grads[0]), {}).items()}
    got_g = dict(port.named_parameters())
    assert set(got_g) == set(want_g)
    top = max(np.abs(w).max() for w in want_g.values())
    for k, w in want_g.items():
        g = np.zeros_like(w) if got_g[k].grad is None else got_g[k].grad.numpy()
        if np.abs(w).max() <= ZERO_GRAD * top:   # a bias a train-mode BN's mean removes
            assert np.abs(g).max() <= ZERO_GRAD * top, k
        else:
            close(g, w, f"{key}.{k} gradient")
    sd = port.state_dict()
    for k, w in port_state(key, {}, jax_to_py(new["batch_stats"])).items():
        if not k.endswith("num_batches_tracked"):
            w = w.numpy()
            np.testing.assert_allclose(sd[k].numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                       err_msg=k)


# ---- ops -----------------------------------------------------------------------------

def test_disp_warp_matches_jax(rng):
    """Disparities from −3 to W + 3 px: samples left of column 0 and right
    of column W − 1 (zero, mask 0), integer and fractional ones."""
    b, h, w, c = 2, 5, 16, 3
    right = rng.standard_normal((b, h, w, c)).astype(np.float32)
    disp = rng.uniform(-3, w + 3, (b, h, w)).astype(np.float32)
    disp[0, 0, :4] = [0.0, 1.0, 2.0, 5.0]
    want, want_mask = jax_disp_warp(jnp.asarray(right), jnp.asarray(disp))
    got, mask = disp_warp(torch.from_numpy(right), torch.from_numpy(disp))
    assert tuple(got.shape) == tuple(mask.shape) == (b, h, w, c)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert 0 < mask.numpy().mean() < 1, "some samples must fall outside the frame"
    close(got.numpy(), want, "warped", 1e-6)


def test_upsample_volume_4x_matches_jax(rng):
    vol = rng.standard_normal((2, 5, 4, 6)).astype(np.float32)        # (B, D, H, W)
    want = jextras._upsample_volume_4x(jnp.asarray(vol))               # (B, 4H, 4W, 4D)
    got = stereo_extras.upsample_volume_4x(torch.from_numpy(vol))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 20, 16, 24)
    close(from_port(got), want, "upsampled volume", 1e-6)


# ---- blocks --------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("act,stride", [("leaky", 1), ("relu", 2), (None, 1)])
def test_conv3d_block_matches_jax(rng, act, stride, train):
    x = rng.standard_normal((2, 4, 6, 8, CIN)).astype(np.float32)
    check_module(rng, jextras.Conv3D(16, stride=stride, act=act),
                 stereo_extras.Conv3D(CIN, 16, stride=stride, act=act), x, "block", train, 1e-4)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_trans_conv3d_matches_jax(rng, train):
    """JAX's VALID ``ConvTranspose`` cut by ``[1:]`` against torch's
    ``output_padding=1`` form, odd sizes on each axis."""
    x = rng.standard_normal((2, 3, 5, 4, CIN)).astype(np.float32)
    check_module(rng, jextras.TransConv3D(16), stereo_extras.TransConv3D(CIN, 16), x,
                 "trans1", train, 1e-4)


def test_gcnet_same_transposed_conv_matches_jax(rng):
    """GCNet's ``trans5``: JAX's SAME ``ConvTranspose`` (the first 2n rows of
    the VALID result, not the reference's 2n − 1) alone."""
    import flax.linen as fnn

    jmod = fnn.ConvTranspose(1, (3, 3, 3), strides=(2, 2, 2), padding="SAME", use_bias=False)
    x = rng.standard_normal((2, 3, 5, 4, 32)).astype(np.float32)
    params = {"kernel": rng.standard_normal((3, 3, 3, 32, 1)).astype(np.float32)}
    want = jmod.apply({"params": params}, jnp.asarray(x))
    port = stereo_extras.ConvTranspose3dSame(32, 1)
    port.load_state_dict(port_state("trans5", params, {}), strict=True)
    with torch.no_grad():
        got = port(ncdhw(x))
    assert tuple(got.shape) == (2, 1, 6, 10, 8)
    close(from_port(got), want, "trans5", 1e-4)


# ---- aggregations --------------------------------------------------------------------

AGGREGATIONS = {
    "stereonet": ((2, 8, 8, 12), jextras.StereoNetAggregation, stereo_extras.StereoNetAggregation),
    "psmnet_basic": ((2, 4, 8, 12), jextras.PSMNetBasicAggregation,
                     stereo_extras.PSMNetBasicAggregation),
    "psmnet_hg": ((2, 8, 8, 12), jextras.PSMNetHGAggregation,
                  stereo_extras.PSMNetHGAggregation),
    "gcnet": ((2, 16, 16, 16), jextras.GCNetAggregation, stereo_extras.GCNetAggregation),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", list(AGGREGATIONS))
def test_aggregation_matches_jax(rng, kind, train):
    """Each aggregation in eval (1e-4) and in training (1e-2, running
    statistics too); ``psmnet_hg`` gives its last cost in eval and all
    three in training; its ``state_dict`` goes back through JAX's
    ``convert_reference_psmnet_hg`` to JAX's trees."""
    shape, jcls, pcls = AGGREGATIONS[kind]
    x = rng.standard_normal(shape + (CIN,)).astype(np.float32)
    port = pcls(CIN)
    params, stats = check_module(rng, jcls(), port, x, "aggregation", train,
                                 1e-2 if train else 1e-4)
    if kind == "psmnet_hg" and not train:
        back_p, back_s = convert_reference_psmnet_hg(
            {k: v.numpy() for k, v in port.state_dict().items()})
        assert_same_tree(back_p, params)
        assert_same_tree(back_s, stats)


def test_gcnet_refuses_sides_off_its_grid():
    with pytest.raises(ValueError, match="multiples of 16"):
        stereo_extras.GCNetAggregation(CIN)(torch.zeros(1, CIN, 16, 16, 24))


def test_factories_take_every_kind_and_refuse_others():
    """``make_aggregation`` and ``make_refinement`` build each kind JAX's
    factories build; an unknown kind raises ``NotImplementedError``."""
    for kind in ("adaptive", *AGGREGATIONS):
        stereo_extras.make_aggregation(kind, 48)
    for kind in ("stereonet", "stereodrnet", "hourglass", *stereo_extras.REFINE_NEW_VARIANTS):
        stereo_extras.make_refinement(kind)
    with pytest.raises(NotImplementedError, match="aggregation cost_filter"):
        stereo_extras.make_aggregation("cost_filter", 48)
    with pytest.raises(NotImplementedError, match="refinement new6"):
        stereo_extras.make_refinement("new6")


# ---- backward ------------------------------------------------------------------------

# kind: (volume shape without channels, the key the converter maps, the JAX and port blocks)
BLOCKS = {
    "conv3d leaky": ((2, 4, 6, 8), "block", lambda: (
        jextras.Conv3D(16, act="leaky"), stereo_extras.Conv3D(CIN, 16, act="leaky"))),
    "conv3d relu, stride 2": ((2, 4, 6, 8), "block", lambda: (
        jextras.Conv3D(16, stride=2, act="relu"),
        stereo_extras.Conv3D(CIN, 16, stride=2, act="relu"))),
    "conv3d, no activation": ((2, 4, 6, 8), "block", lambda: (
        jextras.Conv3D(16, act=None), stereo_extras.Conv3D(CIN, 16, act=None))),
    "trans_conv3d": ((2, 3, 5, 4), "trans1", lambda: (
        jextras.TransConv3D(16), stereo_extras.TransConv3D(CIN, 16))),
}


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_3d_block_gradients_match_jax(rng, kind):
    """The aggregations' 3-D blocks in training: output, input and
    parameter gradients and running stats (``check_training_grads``)."""
    shape, key, make = BLOCKS[kind]
    jmod, port = make()
    x = rng.standard_normal(shape + (CIN,)).astype(np.float32)
    params, stats = random_variables(jmod, jnp.asarray(x), rng, jargs=(False,))
    check_training_grads(rng, jmod, port, key, [x], params, stats)


@pytest.mark.parametrize("kind", ["stereonet", "psmnet_basic", "psmnet_hg"])
def test_aggregation_gradients_match_jax(rng, kind):
    """A whole aggregation in training (``psmnet_hg`` with its three
    costs), backward from one cotangent an output. GCNet is held block by
    block (``test_3d_block_gradients_match_jax``) and not whole: its five
    levels end at 1×1×1 on a 16³ volume, where a train-mode BN sees two
    values a channel, and its gradients differ from JAX's by up to 1.1e-1
    of max|g| there and 1.2e-2 on a 32³ volume (its outputs hold 1e-2,
    ``test_aggregation_matches_jax``)."""
    shape, jcls, pcls = AGGREGATIONS[kind]
    x = rng.standard_normal(shape + (CIN,)).astype(np.float32)
    jmod = jcls()
    params, stats = random_variables(jmod, jnp.asarray(x), rng, jargs=(False,))
    check_training_grads(rng, jmod, pcls(CIN), "aggregation", [x], params, stats)
