"""The port's stereo models (``models/stereo.py``, ``models/stereo_extras.py``)
against the JAX package's, on the CPU in float32 at 64 × 128 images.

Weights go from JAX to the port: numpy draws of the shapes of JAX's
``init`` (``random_variables``: kernels He-normal, offset convs included,
so the deformable samples move; BN affine and running statistics random),
carried by ``from_jax_variables`` and loaded strictly; the port's
``state_dict`` goes back through the JAX package's own
``convert_reference_adaptive_aggregation`` and
``convert_reference_refinement`` to the same trees (the reference's names).

Tolerances, each of max|·| of the JAX tensor: eval outputs 1e-4
(``SemRefine``'s disparity against JAX's eval-time composed head); a
bottleneck, the adaptive aggregation and the StereoNet and semantic-guided
refinements in training (``check_jax_block``, ``check_training_grads``): output, input and parameter gradients 1e-4,
running stats rtol 1e-4. ``max_disp`` 32 and 64 give D = 8
and 16 at 1/4 resolution, one of each of JAX's correlation forms.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.models import stereo as jstereo  # noqa: E402
from doubly_contrastive_semseg_tpu.models import stereo_extras as jextras  # noqa: E402
from doubly_contrastive_semseg_tpu.ops.input_pipeline import s2d_pack  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.torch_convert import (  # noqa: E402
    convert_reference_adaptive_aggregation, convert_reference_refinement)
from doubly_contrastive_semseg_tpu_torch.models import stereo, stereo_extras  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import from_jax_variables  # noqa: E402
from test_torch_deeplab import assert_same_tree, close, few_threads  # noqa: E402,F401
from test_torch_stereo_3d import check_training_grads  # noqa: E402
from test_torch_swiftnet_single import check_jax_block, random_variables  # noqa: E402

B, H, W = 2, 64, 128
h, w = H // 4, W // 4


def port_state(key, params, stats):
    """A JAX block's variables as the port block's ``state_dict``, mapped
    as ``from_jax_variables`` maps the block at ``key`` of ``StereoDCSS``."""
    sd = from_jax_variables({key: params}, {key: stats} if stats else {})
    return {k[len(key) + 1:]: v for k, v in sd.items()}


def numpy_state(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


# ---- aggregation ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["simple", "deform-window", "deform-gather"])
def test_bottleneck_in_training_matches_jax(rng, kind):
    impl = kind.split("-")[-1]
    if kind == "simple":
        jmod, port = jstereo.SimpleBottleneck(8), stereo.SimpleBottleneck(8)
    else:
        jmod = jstereo.DeformSimpleBottleneck(8, deform_impl=impl)
        port = stereo.DeformSimpleBottleneck(8, 8, deform_impl=impl)
    x = rng.standard_normal((B, 10, 12, 8)).astype(np.float32)
    check_jax_block(rng, jmod, port, [x], "blk", "blk", jargs=(True,), jit=impl != "window")


@pytest.mark.parametrize("scales,supervised,impl", [(1, True, "window"), (3, True, "gather"),
                                                    (3, False, "gather")],
                         ids=["1 scale", "3 scales", "3 scales, no intermediate supervision"])
def test_adaptive_aggregation_matches_jax(rng, scales, supervised, impl):
    """Eval outputs of every scale, the cross-scale fuse layers at 3
    scales, and the port's names through JAX's converter. The window form
    runs at one scale, as in ``StereoDCSS``; at three scales the gather
    form keeps JAX's eager run short."""
    vols = [rng.standard_normal((B, h >> i, w >> i, 16 >> i)).astype(np.float32)
            for i in range(scales)]
    kw = dict(num_scales=scales, num_fusions=3 if scales == 1 else 2, num_deform_blocks=2
              if scales == 1 else 1, intermediate_supervision=supervised, deform_impl=impl)
    jmod = jstereo.AdaptiveAggregation(**kw)
    params, stats = _agg_variables(jmod, vols, rng)
    # jitted, but not the window form, whose unrolled sums compile slower
    # than they run eagerly
    apply = jmod.apply if impl == "window" else jax.jit(jmod.apply, static_argnums=2)
    want = apply({"params": params, "batch_stats": stats}, [jnp.asarray(v) for v in vols], False)
    port = stereo.AdaptiveAggregation(16, **kw).eval()
    port.load_state_dict(port_state("aggregation", params, stats), strict=True)
    with torch.no_grad():
        got = port([nchw(v) for v in vols])
    assert len(got) == len(want) == (scales if supervised else 1)
    for g, wv in zip(got, want):
        close(g.permute(0, 2, 3, 1).numpy(), wv, "aggregation output")
    back_p, back_s = convert_reference_adaptive_aggregation(numpy_state(port))
    assert_same_tree(back_p, params)
    assert_same_tree(back_s, stats)


@pytest.mark.parametrize("scales,fusions,deform,impl", [(1, 3, 2, "window"),
                                                        (3, 1, 1, "gather")],
                         ids=["StereoDCSS's: 1 scale, 3 fusions", "3 scales, 1 fusion"])
def test_adaptive_aggregation_gradients_match_jax(rng, scales, fusions, deform, impl):
    """The adaptive aggregation in training: as ``StereoDCSS`` builds it
    (one scale, a simple fusion then two deformable ones, window form), and
    one fusion at three scales for the cross-scale fuse layers."""
    vols = [rng.standard_normal((B, h >> i, w >> i, 16 >> i)).astype(np.float32)
            for i in range(scales)]
    kw = dict(num_scales=scales, num_fusions=fusions, num_deform_blocks=deform,
              deform_impl=impl)
    jmod = jstereo.AdaptiveAggregation(**kw)
    params, stats = _agg_variables(jmod, vols, rng)
    check_training_grads(rng, jmod, stereo.AdaptiveAggregation(16, **kw), "aggregation", vols,
                         params, stats, listed=True, jit=impl != "window")


def _agg_variables(jmod, vols, rng):
    """``random_variables`` for a module whose first argument is a list."""
    from test_torch_swiftnet_single import fill

    shapes = jax.eval_shape(lambda k, v: jmod.init(k, v, False), jax.random.PRNGKey(0),
                            [jax.ShapeDtypeStruct(v.shape, v.dtype) for v in vols])
    return fill(shapes["params"], rng), fill(shapes["batch_stats"], rng)


# ---- refinements -------------------------------------------------------------------

def refinement_inputs(rng, disp_channels=1):
    disp = rng.uniform(0, 7, (B, h, w) if disp_channels == 1 else (B, h, w, disp_channels))
    img = rng.uniform(0, 255, (B, H, W, 3))
    sem = rng.standard_normal((B, h, w, 128))
    return [a.astype(np.float32) for a in (disp, img, sem)]


@pytest.mark.parametrize("kind", ["stereonet", "semantic"])
def test_stereo_refinements_match_jax(rng, kind):
    disp, img, sem = refinement_inputs(rng)
    if kind == "stereonet":
        jmod, port, args = jstereo.StereoNetRefinement(), stereo.StereoNetRefinement(), (disp, img)
    else:
        jmod, port = jstereo.SemanticGuidedRefinement(), stereo.SemanticGuidedRefinement()
        args = (disp, img, sem)
    params, stats = random_variables(jmod, jnp.asarray(disp), rng,
                                     *(jnp.asarray(a) for a in args[1:]), jargs=(False,))
    want = jmod.apply({"params": params, "batch_stats": stats},
                      *(jnp.asarray(a) for a in args), False)
    port.load_state_dict(port_state("refinement", params, stats), strict=True)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(disp), torch.from_numpy(img),
                   *([nchw(sem)] if kind == "semantic" else []))
    assert tuple(got.shape) == (B, H, W)
    close(got.numpy(), want, kind)


@pytest.mark.parametrize("kind", ["stereonet", "semantic"])
def test_stereo_refinement_gradients_match_jax(rng, kind):
    """The refinement in training, backward from one cotangent: output,
    disparity, image and feature gradients, parameter gradients and running
    stats (``check_training_grads``)."""
    disp, img, sem = refinement_inputs(rng)
    if kind == "stereonet":
        jmod, port, xs = jstereo.StereoNetRefinement(), stereo.StereoNetRefinement(), [disp, img]
    else:
        jmod, port = jstereo.SemanticGuidedRefinement(), stereo.SemanticGuidedRefinement()
        xs = [disp, img, sem]
    params, stats = random_variables(jmod, jnp.asarray(disp), rng,
                                     *(jnp.asarray(a) for a in xs[1:]), jargs=(False,))
    check_training_grads(rng, jmod, port, "refinement", xs, params, stats, raw=(1,))


@pytest.mark.parametrize("variant", list(stereo_extras.REFINE_NEW_VARIANTS))
def test_sem_refine_variants_match_jax(rng, variant):
    """Every variant at eval: the stem on raw pixels (s2d-packed for
    ``disp_sem``, as JAX's serving feeds it), the 48-channel disparity
    input of New5/9/12, the second pass of New10; disparity against JAX's
    eval-time composed head; the port's names through JAX's converter."""
    fields = stereo_extras.REFINE_NEW_VARIANTS[variant]
    disp, img, sem = refinement_inputs(rng, fields.get("disp_in_channels", 1))
    if variant == "disp_sem":
        img = s2d_pack(img)
    jmod = jextras.make_refinement(variant)
    jin = [jnp.asarray(a) for a in (disp, img, sem)]
    params, stats = random_variables(jmod, jin[0], rng, *jin[1:], jargs=(False,))
    want_disp, want_sem = jmod.apply({"params": params, "batch_stats": stats}, *jin, False)
    port = stereo_extras.make_refinement(variant).eval()
    port.load_state_dict(port_state("refinement", params, stats), strict=True)
    pd = torch.from_numpy(disp) if disp.ndim == 3 else nchw(disp)
    with torch.no_grad():
        got_disp, got_sem = port(pd, torch.from_numpy(img), nchw(sem))
    assert tuple(got_disp.shape) == (B, H, W)
    assert tuple(got_sem.shape) == tuple(want_sem.shape)
    close(got_disp.numpy(), want_disp, f"{variant} disparity")
    close(got_sem.numpy(), want_sem, f"{variant} semantic head")
    back_p, back_s = convert_reference_refinement(numpy_state(port))
    assert_same_tree(back_p, params)
    assert_same_tree(back_s, stats)


# ---- StereoDCSS ---------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_apply(**kw):
    jmodel = jstereo.StereoDCSS(**kw)
    return jmodel, jax.jit(jmodel.apply)


def leaves(tree):
    return sum(leaves(v) if isinstance(v, dict) else 1 for v in tree.values())


# the window form (the benchmark's) in one case: JAX's compile of its
# unrolled window sums takes most of a case's time
CASES = {
    "disp_sem, window, resnet18, D 8": dict(refinement_type="disp_sem", deform_impl="window",
                                            max_disp=32),
    "semantic, gather, resnet18, D 16, s2d": dict(refinement_type="semantic", max_disp=64),
    "stereonet, gather, resnet18": dict(refinement_type="stereonet", max_disp=32),
    "disp_sem, gather, resnet34": dict(refinement_type="disp_sem", backbone="resnet34",
                                       max_disp=32),
    "semantic, gather, efficientnetb0": dict(refinement_type="semantic",
                                             backbone="efficientnetb0", max_disp=32),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stereo_dcss_eval_matches_jax(rng, case):
    """The eval forward end to end: ``disp`` and ``seg_beforeup`` (and
    ``sem_refined``) at 1e-4; ``from_jax_variables`` carries every leaf of
    JAX's variables into a strict load; ``disp_sem``'s aggregation and
    refinement go back through JAX's converters to JAX's trees."""
    kw = {"deform_impl": "gather", "train_semantic": True, **CASES[case]}
    jmodel, apply = jax_apply(**kw)
    left, right = (rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32) for _ in range(2))
    if "s2d" in case:
        left, right = s2d_pack(left), s2d_pack(right)
    params, stats = random_variables(jmodel, jnp.asarray(left), rng, jnp.asarray(right))
    want = apply({"params": params, "batch_stats": stats}, jnp.asarray(left), jnp.asarray(right))
    sd = from_jax_variables(params, stats)
    assert len([k for k in sd if not k.endswith("num_batches_tracked")]) == \
        leaves(params) + leaves(stats)
    with torch.device("meta"):
        port = stereo.build_stereo_model(device="meta", dtype="float32", **kw)
    port.load_state_dict(sd, strict=True, assign=True)
    port = port.to(memory_format=torch.channels_last).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(left), torch.from_numpy(right))
    assert set(got) == set(want)
    keys = ["disp", "seg_beforeup"] + (["sem_refined"] if "sem_refined" in want else [])
    for k in keys:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        close(got[k].numpy(), want[k], f"{case}: {k}")
    close(got["disp_pyramid"][0].numpy(), want["disp_pyramid"][0], f"{case}: disp_pyramid")
    if case.startswith("disp_sem, window, resnet18"):
        for key, convert in (("aggregation", convert_reference_adaptive_aggregation),
                             ("refinement", convert_reference_refinement)):
            part = {k[len(key) + 1:]: v.numpy() for k, v in port.state_dict().items()
                    if k.startswith(key + ".")}
            back_p, back_s = convert(part)
            assert_same_tree(back_p, params[key])
            assert_same_tree(back_s, stats[key])


def test_semantic_without_train_semantic_takes_stereonet(rng):
    """JAX's routing quirk: ``semantic`` without ``train_semantic`` builds
    the StereoNet refinement and no seg head; the trees agree leaf for
    leaf."""
    jmodel = jstereo.StereoDCSS(max_disp=32, refinement_type="semantic", train_semantic=False,
                                deform_impl="gather")
    x = jnp.zeros((B, H, W, 3))
    params, stats = random_variables(jmodel, x, rng, x)
    port = stereo.build_stereo_model(device="cpu", max_disp=32, refinement_type="semantic",
                                     train_semantic=False, dtype="float32")
    assert isinstance(port.refinement, stereo.StereoNetRefinement)
    assert not hasattr(port, "segmentation") and "segmentation" not in params
    port.load_state_dict(from_jax_variables(params, stats), strict=True)


def test_build_stereo_model_keeps_offsets_at_zero():
    model = stereo.build_stereo_model(device="cpu", dtype="float32", seed=3)
    offsets = [m.offset_conv for m in model.modules()
               if isinstance(m, stereo.DeformConv2d)]
    assert len(offsets) == 2 and not model.training
    assert all(torch.count_nonzero(c.weight) == 0 and torch.count_nonzero(c.bias) == 0
               for c in offsets)
    again = stereo.build_stereo_model(device="cpu", dtype="float32", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  again.state_dict().values()))
