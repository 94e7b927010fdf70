"""The port's single-scale SwiftNets (``models/swiftnet_single.py``:
``resnet18_single``, ``resnet18_hourglass``, ``resnet18_rgbd``) vs the JAX
package's, on the CPU in float32 at 64², JAX un-jitted. The helpers below
serve ``test_torch_pyramid_variants.py`` and ``test_torch_backbones_train.py``
too.

Weights go from JAX to the port: numpy draws of the shapes of JAX's
``init`` (``jax.eval_shape``), BN affine and running statistics included,
carried by ``from_jax_variables`` onto a port model built on the meta
device and loaded strictly. The port's ``state_dict`` goes back through the
JAX package's own ``convert_reference_swiftnet_single`` to the same tree,
which proves that the trio keeps the reference's names.

Tolerances: eval outputs 1e-4 of max|·| of each tensor; serving labels equal
to JAX's CPU serving on ≥ 99.9 % of pixels. A block on its own in training
(``check_jax_block``: the same NHWC inputs, one random output cotangent,
JAX's variables carried by ``from_jax_variables`` in the context of a
``feature_extractor``): output, input and parameter gradients 1e-4 of
max|·|, BN running stats rtol 1e-4 with an atol of 1e-4 × the largest
entry.
"""

import functools
from typing import Mapping

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.config import parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu.models import blocks as jblocks  # noqa: E402
from doubly_contrastive_semseg_tpu.models import build_model as jax_build_model  # noqa: E402
from doubly_contrastive_semseg_tpu.models import stereo_extras as jextras  # noqa: E402
from doubly_contrastive_semseg_tpu.models import swiftnet_single as jss  # noqa: E402
from doubly_contrastive_semseg_tpu.models.serving import make_serving_fn as jax_serving  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.torch_convert import (  # noqa: E402
    convert_reference_swiftnet_single, jax_to_py)
from doubly_contrastive_semseg_tpu_torch import Config, make_serving_fn  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models import blocks, serving, stereo_extras  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models import swiftnet_single  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import from_jax_variables  # noqa: E402
from test_torch_deeplab import few_threads  # noqa: E402,F401 (autouse)
from test_torch_deeplab import assert_same_tree, close, port_from_jax  # noqa: E402

S, B = 64, 2
OUTPUTS = ("seg_beforeup", "fine_feat", "fine_feat0", "seg", "weather_logits")
TRIO = ("resnet18_single", "resnet18_hourglass", "resnet18_rgbd")


# ---- weights from JAX ---------------------------------------------------------

def fill(tree, rng):
    """numpy draws of a tree of shapes: kernels He-normal by fan-in, BN
    scales in [0.5, 0.8], biases and running means N(0, 0.1²), running
    variances in [1, 2]."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = fill(v, rng)
            continue
        shape = tuple(v.shape)
        if k in ("kernel", "conv1_kernel"):
            x = rng.normal(0.0, np.sqrt(2.0 / max(np.prod(shape[:-1]), 1)), shape)
        elif k == "scale":
            x = rng.uniform(0.5, 0.8, shape)
        elif k == "var":
            x = rng.uniform(1.0, 2.0, shape)
        else:   # bias, mean
            x = rng.normal(0.0, 0.1, shape)
        out[k] = x.astype(np.float32)
    return out


def random_variables(jmodel, x, rng, *args, jargs=(), **init_kw):
    """(params, batch_stats) of ``jmodel``'s ``init`` shapes at input ``x``
    (arrays ``args`` and static ``jargs`` follow it), drawn by ``fill``."""
    shapes = _init_shapes(jmodel, jax.ShapeDtypeStruct(x.shape, x.dtype),
                          tuple(jax.ShapeDtypeStruct(a.shape, a.dtype) for a in args),
                          jargs, tuple(sorted(init_kw.items())))
    return fill(shapes["params"], rng), fill(shapes.get("batch_stats", {}), rng)


@functools.lru_cache(maxsize=None)
def _init_shapes(jmodel, x, args, jargs, init_kw):
    return jax.eval_shape(lambda key, *a: jmodel.init(key, *a, *jargs, **dict(init_kw)),
                          jax.random.PRNGKey(0), x, *args)


@functools.lru_cache(maxsize=None)
def jax_model(name):
    return jax_build_model(parse_args(["--model", name, "--compute_dtype", "float32"]))


@functools.lru_cache(maxsize=None)
def jax_fns(name):
    """The JAX model of ``name`` with its ``apply`` (eval) and its CPU
    serving function, each jitted once a process."""
    jmodel = jax_model(name)
    return jmodel, jax.jit(jmodel.apply), jax.jit(jax_serving(jmodel))


def port_config(name, **kw):
    return Config(model=name, compute_dtype="float32", **kw)


class CountCalls:
    """Counts the calls of ``module`` path's forwards while active."""

    def __init__(self, modules):
        self.calls = 0
        self.handles = [m.register_forward_hook(self._hook) for m in modules]

    def _hook(self, *_):
        self.calls += 1

    def remove(self):
        for h in self.handles:
            h.remove()


def count_head(monkeypatch):
    """Counts the serving function's calls of the fused head (on the CPU
    its plain version, which counts no launch)."""
    calls = []
    real = serving.fused_seghead_upsample_argmax

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(serving, "fused_seghead_upsample_argmax", counted)
    return calls


def check_eval(rng, monkeypatch, name, size, batch=B):
    """The eval forward, all outputs, and serving labels of ``name`` against
    JAX at ``size``², weights by ``from_jax_variables``; serving through the
    fused head once. Returns (JAX model, params, stats, port model, input)."""
    jmodel, apply, serve = jax_fns(name)
    x = rng.uniform(0, 255, (batch, size, size, 3)).astype(np.float32)
    params, stats = random_variables(jmodel, jnp.asarray(x), rng)
    port = port_from_jax(port_config(name), params, stats)
    v = {"params": params, "batch_stats": stats}
    want = apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for k in OUTPUTS:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        close(got[k].numpy(), want[k], f"eval {k}")

    labels = np.asarray(serve(v, jnp.asarray(x)))
    calls = count_head(monkeypatch)
    served = make_serving_fn(port, device="cpu")(x)
    assert served.dtype == torch.int8 and tuple(served.shape) == (batch, size, size)
    assert (served.numpy() == labels).mean() >= 0.999
    assert len(calls) == 1, "the fused head (K1's route) serves images 4x the features"
    return jmodel, params, stats, port, x


# ---- blocks in training, weights from JAX --------------------------------------

def port_block_state(params, stats, name, prefix):
    """JAX block variables named ``name`` inside a ``feature_extractor`` →
    the port block's ``state_dict``, whose module sits at ``prefix`` there."""
    def wrap(tree):
        return {"net": {"feature_extractor": {name: tree}}} if tree else {}

    full = f"net.feature_extractor.{prefix}."
    sd = from_jax_variables(wrap(params), wrap(stats))
    return {k[len(full):]: v for k, v in sd.items()}


def check_jax_block(rng, jmod, port, inputs, name, prefix, jargs=(), jkw=None,
                    masks=None, call_port=None, jit=False, partial=False):
    """One block in training, JAX's against the port's, from JAX's
    variables (``random_variables``): the same NHWC ``inputs`` and output
    cotangent; output, input and parameter gradients within 1e-4 of max|·|
    (a gradient below 1e-5 of the block's largest, structurally zero, only
    held below it), running stats rtol 1e-4. ``masks``: a list that JAX's
    forward fills with its drop-connect draws (``record_bernoulli``), which
    the port's ``DropConnect``s then take in call order. ``jit`` compiles
    JAX's forward and backward (faster than eager for the SPP's many
    windows; not with ``masks``, which are read during the forward).
    ``partial``: JAX's block creates only some of the port block's modules
    (a per-level BN block run at one level); the others must get no
    gradient."""
    xs = [jnp.asarray(x) for x in inputs]
    jkw = jkw or {}
    params, stats = random_variables(jmod, xs[0], rng, *xs[1:], jargs=jargs, **jkw)
    port.load_state_dict(port_block_state(params, stats, name, prefix), strict=not partial)

    def f(p, *a):
        return jmod.apply({"params": p, "batch_stats": stats}, *a, *jargs, **jkw,
                          mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(5)})

    def run(p, cot, *a):
        y, vjp_fn, aux = jax.vjp(f, p, *a, has_aux=True)
        return y, vjp_fn(cot), aux

    y_shape = jax.eval_shape(f, params, *xs)[0].shape
    cot = rng.standard_normal(y_shape).astype(np.float32)
    if masks is not None:
        masks.clear()
    y, grads, aux = (jax.jit(run) if jit else run)(params, jnp.asarray(cot), *xs)
    if masks is not None:
        use_masks(port, masks)
    port.train()
    xt = [torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
          for x in inputs]
    out = (call_port or (lambda m, *a: m(*a)))(port, *xt)
    out.backward(torch.from_numpy(cot).permute(0, 3, 1, 2))
    close(out.detach().permute(0, 2, 3, 1).numpy(), y, "output")
    for i, x in enumerate(xt):
        close(x.grad.permute(0, 2, 3, 1).numpy(), grads[1 + i], f"input {i} gradient")
    got = dict(port.named_parameters())
    want = {k: v.numpy() for k, v in
            port_block_state(jax_to_py(grads[0]), {}, name, prefix).items()}
    assert set(got) >= set(want) if partial else set(got) == set(want)
    assert all(got[k].grad is None for k in set(got) - set(want))
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        g = np.zeros_like(w) if got[k].grad is None else got[k].grad.numpy()
        if np.abs(w).max() <= 1e-5 * top:   # a bias a train-mode BN's mean removes
            assert np.abs(g).max() <= 1e-5 * top, k
        else:
            close(g, w, k)
    sd = port.state_dict()
    for k, w in port_block_state({}, jax_to_py(aux["batch_stats"]), name, prefix).items():
        if not k.endswith("num_batches_tracked"):
            w = w.numpy()
            np.testing.assert_allclose(sd[k].numpy(), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(), err_msg=k)


def record_bernoulli(monkeypatch):
    """A list that fills with ``jax.random.bernoulli``'s draws, in call
    order (EfficientNet's drop-connect draws its masks inline with it); a
    caller clears it before the forward it reads (tracing JAX's ``init``
    draws too) and, under ``jax.jit``, returns its entries from the traced
    function."""
    masks = []
    real = jax.random.bernoulli

    def recorded(key, p=0.5, shape=None):
        m = real(key, p, shape)
        masks.append(m)
        return m

    monkeypatch.setattr(jax.random, "bernoulli", recorded)
    return masks


def use_masks(model, masks):
    """The port's ``DropConnect``s take JAX's recorded (B, 1, 1, 1) masks in
    call order."""
    it = iter(list(masks))

    def keep(x):
        return torch.from_numpy(np.array(next(it))).reshape(x.shape[0], 1, 1, 1)

    for m in model.modules():
        if isinstance(m, blocks.DropConnect):
            m.keep_mask = keep


# ---- the trio -------------------------------------------------------------------

@pytest.mark.parametrize("name", TRIO)
def test_eval_forward_and_serving_match_jax(rng, monkeypatch, name):
    """Eval outputs and serving labels against JAX, and the port's
    ``state_dict`` through JAX's ``convert_reference_swiftnet_single`` back
    to JAX's feature-extractor tree (the reference's names)."""
    _, params, stats, port, _ = check_eval(rng, monkeypatch, name, S)
    fe = {k[len("net.feature_extractor."):]: v.numpy()
          for k, v in port.state_dict().items() if k.startswith("net.feature_extractor.")}
    back_p, back_s = convert_reference_swiftnet_single(fe)
    assert_same_tree(back_p, params["net"]["feature_extractor"])
    assert_same_tree(back_s, stats["net"]["feature_extractor"])


def test_rgbd_default_zero_depth(rng):
    """Without ``depth`` the RGB-D model takes a zero depth map, as JAX's
    ``WeatherNet`` does; a given depth reaches its depth branch and matches
    JAX's."""
    jmodel, apply, _ = jax_fns("resnet18_rgbd")
    x = rng.uniform(0, 255, (B, S, S, 3)).astype(np.float32)
    depth = rng.uniform(0, 80, (B, S, S)).astype(np.float32)
    params, stats = random_variables(jmodel, jnp.asarray(x), rng)
    port = port_from_jax(port_config("resnet18_rgbd"), params, stats)
    v = {"params": params, "batch_stats": stats}
    with torch.no_grad():
        none = port(torch.from_numpy(x))
        zeros = port(torch.from_numpy(x), depth=torch.zeros(B, S, S))
        given = port(torch.from_numpy(x), depth=torch.from_numpy(depth))
    for k in OUTPUTS:
        assert torch.equal(none[k], zeros[k]), k
    want0 = apply(v, jnp.asarray(x))
    want = apply(v, jnp.asarray(x), depth=jnp.asarray(depth))
    close(none["seg"].numpy(), want0["seg"], "seg, no depth")
    close(given["seg"].numpy(), want["seg"], "seg, depth given")
    assert np.abs(np.asarray(want["seg"]) - np.asarray(want0["seg"])).max() > 1e-3


def test_hourglass_disparity_branch(rng):
    """The disparity branch: an eval forward calls none of its convs; asked
    (``disparity=True``) it gives JAX's ``disp_feat``; a train forward runs
    every one of them."""
    jmod = jss.HourglassSwiftNet()
    x = rng.uniform(0, 255, (B, S, S, 3)).astype(np.float32)
    params, stats = random_variables(jmod, jnp.asarray(x), rng)
    port = swiftnet_single.HourglassSwiftNet()
    port.load_state_dict(_fe_state(params, stats), strict=True)
    port.eval()
    branch = [port.conv4a] + [getattr(port, n) for n, *_ in port._LADDER]
    convs = [m for b in branch for m in b.modules() if isinstance(m, torch.nn.Conv2d)
             or isinstance(m, torch.nn.ConvTranspose2d)]
    assert len(convs) == 25
    counter = CountCalls(convs)
    with torch.no_grad():
        feat, extra = port(torch.from_numpy(x))
    assert counter.calls == 0 and "disp_feat" not in extra
    with torch.no_grad():
        _, extra = port(torch.from_numpy(x), disparity=True)
    assert counter.calls == 25
    want_feat, want = jax.jit(jmod.apply)({"params": params, "batch_stats": stats},
                                          jnp.asarray(x))
    close(extra["disp_feat"].permute(0, 2, 3, 1).numpy(), want["disp_feat"], "disp_feat")
    close(feat.permute(0, 2, 3, 1).numpy(), want_feat, "features")
    port.train()
    port(torch.from_numpy(x))
    assert counter.calls == 50
    counter.remove()


def _fe_state(params, stats):
    """A feature extractor's JAX variables → its port module's state_dict."""
    def wrap(tree):
        return {"net": {"feature_extractor": tree}}

    full = "net.feature_extractor."
    return {k[len(full):]: v for k, v in from_jax_variables(wrap(params), wrap(stats)).items()}


# ---- blocks -----------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(34, 60), (3, 3)], ids=["unequal windows", "grid above map"])
def test_spp_matches_jax(rng, hw):
    """The trio's SPP in training (BN momentum 0.005) at layer 4 of a
    1080×1920 frame (34 × 60: 34 is no multiple of 8, so the adaptive pool's
    windows are unequal) and of a 96² crop (3 × 3 under grids of 8, 4, 2),
    then in eval."""
    x = (rng.standard_normal((2,) + hw + (64,))
         + rng.standard_normal((2, 1, 1, 64))).astype(np.float32)
    jmod = jblocks.SpatialPyramidPooling(num_levels=3, bt_size=32, level_size=32 // 3,
                                         out_size=32, grids=(8, 4, 2, 1), bn_momentum=0.005)
    port = blocks.SpatialPyramidPooling(64, num_levels=3, bt_size=32, level_size=32 // 3,
                                        out_size=32, grids=(8, 4, 2, 1), bn_momentum=0.005)
    check_jax_block(rng, jmod, port, [x], "spp", "spp", jkw={"train": True}, jit=True)
    params, stats = random_variables(jmod, jnp.asarray(x), rng, train=False)
    port.load_state_dict(port_block_state(params, stats, "spp", "spp"))
    want = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    close(got.permute(0, 2, 3, 1).numpy(), want, "eval")


def test_upsample_matches_jax(rng):
    """The skip-bottleneck ``Upsample`` step in training, ×2 from 8×8."""
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    skip = rng.standard_normal((2, 16, 16, 48)).astype(np.float32)
    check_jax_block(rng, jblocks.Upsample(32, 32), blocks.Upsample(48, 32, 32), [x, skip],
                    "upsample1", "upsample.1", jkw={"train": True})


@pytest.mark.parametrize("deconv", [False, True])
def test_conv2x_matches_jax(rng, deconv):
    """GANet's ``Conv2x`` in training: the stride-2 conv, or the ×2
    transposed conv whose kernel JAX stores flipped."""
    cin, c = 24, 16
    hw = (4, 6) if deconv else (16, 12)
    x = rng.standard_normal((2,) + hw + (cin,)).astype(np.float32)
    skip_hw = (8, 12) if deconv else (8, 6)
    skip = rng.standard_normal((2,) + skip_hw + (c,)).astype(np.float32)
    name = "deconv3a" if deconv else "conv2b"
    check_jax_block(rng, jextras._Conv2x(c, deconv=deconv), stereo_extras.Conv2x(cin, c, deconv),
                    [x, skip], name, name, jargs=(True,))
