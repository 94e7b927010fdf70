"""The port's warp-error refinements (``StereoDRNetRefinement``,
``HourglassRefinement``), ``StereoDCSS`` with the 3-D aggregations, stereo
serving and ``inference --stereo`` against the JAX package's, on the CPU in
float32.

Weights go from JAX to the port through ``from_jax_variables``
(``random_variables``' numpy draws), and the hourglass's ``state_dict``
back through JAX's ``convert_reference_refinement``. The hourglass's
deformable convs get offset convs scaled down (``calm_offsets``) so that
their samples move by 0.3–1.8 px on average: He-normal offset convs over
raw-pixel features move them by 6–67 px on average and up to 685 px,
mostly off the 64-px image, where the gather's sensitivity to the
offsets' rounding alone gave 1.1e-4–1.9e-4 of the disparity's max.

Tolerances, each of max|·| of the JAX tensor: eval outputs and disparities
1e-4; a refinement in training (output and running statistics) 1e-2 (JAX's
one-pass BN variance), StereoDRNet's output, gradients and running
statistics 1e-4 (``check_training_grads``); serving labels equal on ≥ 99.9 % of pixels;
``inference --stereo``'s 16-bit PNG within 1 LSB on ≥ 99.9 % of pixels.
Images are 64 × 64 with ``max_disp`` 16 (4 disparities at 1/4), GCNet's at
``max_disp`` 64, its smallest legal volume (16 disparities at 16 × 16).
"""

import functools
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.models import stereo as jstereo  # noqa: E402
from doubly_contrastive_semseg_tpu.models import stereo_extras as jextras  # noqa: E402
from doubly_contrastive_semseg_tpu.models.serving import (  # noqa: E402
    make_stereo_serving_fn as jax_stereo_serving)
from doubly_contrastive_semseg_tpu.ops import deform_conv as jdeform  # noqa: E402
from doubly_contrastive_semseg_tpu.ops.input_pipeline import s2d_pack  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.torch_convert import (  # noqa: E402
    convert_reference_refinement, jax_to_py)
from doubly_contrastive_semseg_tpu_torch import (  # noqa: E402
    build_stereo_model, make_stereo_serving_fn)
from doubly_contrastive_semseg_tpu_torch import inference as port_inference  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data.png import read_png, write_png  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models import stereo, stereo_extras  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops.deform_conv import DeformConv2d  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import from_jax_variables  # noqa: E402
from test_torch_deeplab import assert_same_tree, close, few_threads  # noqa: E402,F401
from test_torch_stereo_3d import check_training_grads, port_state  # noqa: E402
from test_torch_swiftnet_single import count_head, random_variables  # noqa: E402

# the scale of the offset conv of each deformable conv of HourglassRefinement
OFFSET_SCALE = {"conv_start": 0.015, "conv3a": 0.05, "conv4a": 0.05}


def calm_offsets(refinement_params):
    for name, scale in OFFSET_SCALE.items():
        if name in refinement_params:
            oc = refinement_params[name]["offset_conv"]
            oc["kernel"] = oc["kernel"] * np.float32(scale)
    return refinement_params


def numpy_state(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


# ---- the refinements ------------------------------------------------------------------

B, H, W = 2, 32, 64


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", ["stereodrnet", "hourglass"])
def test_warp_refinement_matches_jax(rng, kind, train):
    """The refinement on a 1/4-resolution disparity and both views, in eval
    (1e-4) and in training (1e-2, running statistics too); the hourglass's
    ``state_dict`` back through ``convert_reference_refinement``."""
    disp = rng.uniform(0, 7, (B, H // 4, W // 4)).astype(np.float32)
    left, right = (rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32) for _ in range(2))
    jmod = jextras.make_refinement(kind)
    jin = [jnp.asarray(a) for a in (disp, left, right)]
    params, stats = random_variables(jmod, jin[0], rng, *jin[1:], jargs=(False,))
    params = calm_offsets(params)
    apply = jax.jit(jmod.apply, static_argnums=(4,), static_argnames="mutable")
    v = {"params": params, "batch_stats": stats}
    if train:
        want, new = apply(v, *jin, True, mutable="batch_stats")
    else:
        want = apply(v, *jin, False)
    port = stereo_extras.make_refinement(kind)
    port.load_state_dict(port_state("refinement", params, stats), strict=True)
    port.train(train)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (disp, left, right)))
    assert tuple(got.shape) == (B, H, W) and got.dtype == torch.float32
    close(got.numpy(), want, f"{kind} disparity", 1e-2 if train else 1e-4)
    if train:
        sd = port.state_dict()
        for k, w in port_state("refinement", {}, jax_to_py(new["batch_stats"])).items():
            if not k.endswith("num_batches_tracked"):
                w = w.numpy()
                np.testing.assert_allclose(sd[k].numpy(), w, rtol=1e-2,
                                           atol=1e-2 * np.abs(w).max(), err_msg=k)
    elif kind == "hourglass":
        back_p, back_s = convert_reference_refinement(numpy_state(port))
        assert_same_tree(back_p, params)
        assert_same_tree(back_s, stats)


def test_stereodrnet_refinement_gradients_match_jax(rng):
    """StereoDRNet's refinement in training, backward from one cotangent:
    output, input and parameter gradients and running stats at 1e-4 of
    max|·| (``check_training_grads``). The hourglass's whole backward
    differs from JAX's by up to 3.9e-2 of max|g| on these inputs, as its
    training outputs hold 1e-2 (JAX's one-pass BN variance moving its
    deformable samples); it is held block by block in
    ``test_hourglass_refinement_block_gradients_match_jax``."""
    disp = rng.uniform(0, 7, (B, H // 4, W // 4)).astype(np.float32)
    left, right = (rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32) for _ in range(2))
    jmod = jextras.make_refinement("stereodrnet")
    jin = [jnp.asarray(a) for a in (disp, left, right)]
    params, stats = random_variables(jmod, jin[0], rng, *jin[1:], jargs=(False,))
    check_training_grads(rng, jmod, stereo_extras.make_refinement("stereodrnet"), "refinement",
                         [disp, left, right], params, stats, raw=(1, 2))


class DeformTrainArg(jdeform.DeformConv2d):
    """JAX ``DeformConv2d`` called as ``check_training_grads`` calls a
    block, with a ``train`` flag it does not read."""

    def __call__(self, x, train):
        return super().__call__(x)


# HourglassRefinement's blocks: (name in the module, JAX block, port block,
# input shapes NHWC); the deformable convs in their gather form
HOURGLASS_BLOCKS = {
    "conv_start": (lambda: DeformTrainArg(32), lambda: DeformConv2d(32, 32),
                   [(B, 16, 32, 32)]),
    "conv1a": (lambda: jextras._BasicConv(48, stride=2),
               lambda: stereo_extras.BasicConv(32, 48, stride=2), [(B, 16, 32, 32)]),
    "conv3a": (lambda: DeformTrainArg(96, stride=2), lambda: DeformConv2d(64, 96, stride=2),
               [(B, 8, 16, 64)]),
    "conv4a": (lambda: DeformTrainArg(128, stride=2), lambda: DeformConv2d(96, 128, stride=2),
               [(B, 4, 8, 96)]),
    "deconv4a": (lambda: jextras._Conv2x(96, deconv=True),
                 lambda: stereo_extras.Conv2x(128, 96, deconv=True),
                 [(B, 2, 4, 128), (B, 4, 8, 96)]),
    "conv3b": (lambda: jextras._Conv2x(96, mdconv=True),
               lambda: stereo_extras.Conv2x(64, 96, mdconv=True),
               [(B, 8, 16, 64), (B, 4, 8, 96)]),
}


@pytest.mark.parametrize("name", list(HOURGLASS_BLOCKS))
def test_hourglass_refinement_block_gradients_match_jax(rng, name):
    """The hourglass refinement's backward block by block: its three
    deformable convs (gather form, offset convs scaled by
    ``OFFSET_SCALE``), a stride-2 encoder of the a-pass and the two kinds
    of ``Conv2x`` step of the U-net ladder (a ×2 deconv with its skip, a
    b-pass stride-2 step with its skip), each fed the same NHWC inputs:
    output, input and parameter gradients and running stats at 1e-4 of
    max|·| (``check_training_grads``, JAX un-jitted)."""
    make_jax, make_port, shapes = HOURGLASS_BLOCKS[name]
    jmod = make_jax()
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    params, stats = random_variables(jmod, jnp.asarray(xs[0]), rng,
                                     *[jnp.asarray(x) for x in xs[1:]], jargs=(False,))
    if name in OFFSET_SCALE:
        params = calm_offsets({name: params})[name]
    check_training_grads(rng, jmod, make_port(), name, xs, params, stats, jit=False)


def test_upsample_disp_matches_jax_call_site(rng):
    """The refinements' ``_upsample_disp`` is the port's ``upsample_disp``."""
    disp = rng.uniform(0, 7, (B, 8, 16)).astype(np.float32)
    want = jextras._upsample_disp(jnp.asarray(disp), (H, W))          # (B, H, W, 1)
    got = stereo.upsample_disp(torch.from_numpy(disp), (H, W))        # (B, 1, H, W)
    close(got.permute(0, 2, 3, 1).numpy(), want, "upsampled disparity", 1e-6)


# ---- StereoDCSS ----------------------------------------------------------------------

S = 64


@functools.lru_cache(maxsize=None)
def jax_apply(**kw):
    jmodel = jstereo.StereoDCSS(**kw)
    return jmodel, jax.jit(jmodel.apply)


def jax_variables(jmodel, left, right, rng):
    params, stats = random_variables(jmodel, jnp.asarray(left), rng, jnp.asarray(right))
    if "refinement" in params:
        calm_offsets(params["refinement"])
    return params, stats


def port_model(params, stats, **kw):
    """A port ``StereoDCSS`` holding JAX's variables (meta build, strict load)."""
    with torch.device("meta"):
        model = build_stereo_model(device="meta", dtype="float32", **kw)
    model.load_state_dict(from_jax_variables(params, stats), strict=True, assign=True)
    return model.eval()


# each aggregation with a refinement, each refinement twice, NHWC and s2d
CASES = {
    "stereonet + stereodrnet": dict(aggregation_type="stereonet",
                                    refinement_type="stereodrnet"),
    "psmnet_basic + hourglass, s2d": dict(aggregation_type="psmnet_basic",
                                          refinement_type="hourglass"),
    "psmnet_hg + stereodrnet, s2d": dict(aggregation_type="psmnet_hg",
                                         refinement_type="stereodrnet"),
    "gcnet + hourglass": dict(aggregation_type="gcnet", refinement_type="hourglass",
                              max_disp=64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stereo_dcss_3d_matches_jax(rng, case):
    """The eval forward end to end: ``disp``, ``disp_pyramid`` (the
    soft-argmin of the aggregated volume) and ``seg_beforeup`` at 1e-4;
    every leaf of JAX's variables carried into a strict load."""
    kw = {"max_disp": 16, "deform_impl": "gather", "train_semantic": True, **CASES[case]}
    jmodel, apply = jax_apply(**kw)
    left, right = (rng.uniform(0, 255, (1, S, S, 3)).astype(np.float32) for _ in range(2))
    if "s2d" in case:
        left, right = s2d_pack(left), s2d_pack(right)
    params, stats = jax_variables(jmodel, left, right, rng)
    want = apply({"params": params, "batch_stats": stats}, jnp.asarray(left), jnp.asarray(right))
    port = port_model(params, stats, **kw)
    with torch.no_grad():
        got = port(torch.from_numpy(left), torch.from_numpy(right))
    assert set(got) == set(want)
    for k in ("disp", "seg_beforeup"):
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        close(got[k].numpy(), want[k], f"{case}: {k}")
    low, want_low = got["disp_pyramid"][0], want["disp_pyramid"][0]
    assert tuple(low.shape) == tuple(want_low.shape)
    close(low.numpy(), want_low, f"{case}: disp_pyramid")


def test_stereo_serving_psmnet_hg_hourglass_matches_jax(rng, monkeypatch):
    """``make_stereo_serving_fn`` with ``psmnet_hg`` + ``hourglass`` +
    ``train_semantic`` on s2d pairs: the disparity against JAX's serving
    function at 1e-4, the labels on ≥ 99.9 % of pixels through the fused
    head's route once a batch."""
    kw = dict(max_disp=16, aggregation_type="psmnet_hg", refinement_type="hourglass",
              deform_impl="gather", train_semantic=True)
    jmodel = jstereo.StereoDCSS(**kw)
    left, right = (s2d_pack(rng.uniform(0, 255, (2, S, S, 3)).astype(np.float32))
                   for _ in range(2))
    params, stats = jax_variables(jmodel, left, right, rng)
    disp_j, labels_j = jax.jit(jax_stereo_serving(jmodel))(
        {"params": params, "batch_stats": stats}, jnp.asarray(left), jnp.asarray(right))
    disp_j, labels_j = np.array(disp_j), np.array(labels_j)
    model = port_model(params, stats, **kw)
    calls = count_head(monkeypatch)
    disp, labels = make_stereo_serving_fn(model, device="cpu")(left, right)
    assert disp.dtype == torch.float32 and tuple(disp.shape) == (2, S, S)
    assert labels.dtype == torch.int8 and tuple(labels.shape) == (2, S, S)
    assert len(calls) == 1, "the labels take the fused head's route once a batch"
    close(disp.numpy(), disp_j, "served disparity")
    assert (labels.numpy() == labels_j).mean() >= 0.999


def test_inference_stereo_3d_matches_jax_forward(tmp_path, rng):
    """``inference --stereo`` with ``psmnet_hg`` and ``stereodrnet`` from a
    port checkpoint on two 60 × 120 pairs padded to 64 × 128 and cropped
    back, against JAX's forward as JAX's CLI runs it (zero pad at the top
    and right, s2d pack, crop, ``disp × 256`` clipped to 16 bits). The
    refinement's output conv is scaled down so that the disparities stay
    inside the 16-bit range."""
    h, w = 64, 128
    kw = dict(max_disp=16, aggregation_type="psmnet_hg", refinement_type="stereodrnet",
              deform_impl="gather", train_semantic=False)
    jmodel = jstereo.StereoDCSS(**kw)
    x = jnp.zeros((1, h // 2, w // 2, 12))
    params, stats = random_variables(jmodel, x, rng, x)
    final = params["refinement"]["final"]
    final["kernel"] = final["kernel"] * np.float32(0.01)
    final["bias"] = np.zeros_like(final["bias"])
    forward = jax.jit(lambda xl, xr: jmodel.apply({"params": params, "batch_stats": stats},
                                                  xl, xr)["disp"])
    ckpt = tmp_path / "model.pt"
    torch.save({"model": from_jax_variables(params, stats)}, ckpt)

    oh, ow = 60, 120
    want = {}
    for side in ("left", "right"):
        os.makedirs(tmp_path / side)
    for i in range(2):
        pair = [rng.integers(0, 256, (oh, ow, 3)).astype(np.uint8) for _ in range(2)]
        for side, img in zip(("left", "right"), pair):
            write_png(tmp_path / side / f"{i:06d}_10.png", img)
        pad = ((h - oh, 0), (0, w - ow), (0, 0))
        xl, xr = (jnp.asarray(s2d_pack(np.pad(v.astype(np.float32), pad)[None])) for v in pair)
        disp = np.array(forward(xl, xr))[0][h - oh:, :ow]
        want[f"{i:06d}_10.png"] = np.clip(disp * 256.0, 0, 65535).astype(np.uint16)

    result = port_inference.main([
        "--stereo", "--input", str(tmp_path / "left"), "--resume", str(ckpt),
        "--output_dir", str(tmp_path / "out"), "--val_img_height", str(h),
        "--val_img_width", str(w), "--max_disp", "16", "--aggregation_type", "psmnet_hg",
        "--refinement_type", "stereodrnet", "--deform_impl", "gather",
        "--compute_dtype", "float32", "--device", "cpu"])
    assert [os.path.basename(p) for p in result["paths"]] == sorted(want)
    for path in result["paths"]:
        got = read_png(path)
        ref = want[os.path.basename(path)]
        assert got.dtype == np.uint16 and got.shape == (oh, ow)
        assert 0 < ref.max() < 65535, "the disparities must stay inside 16 bits"
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert (diff <= 1).mean() >= 0.999, diff.max()


def test_stereo_dcss_builds_every_kind_and_refuses_others():
    """Every ``--aggregation_type`` and ``--refinement_type`` JAX's
    ``inference.py`` accepts builds; an unknown one raises."""
    parser = port_inference.build_parser()
    kinds = {a.dest: a.choices for a in parser._actions
             if a.dest in ("aggregation_type", "refinement_type")}
    for agg in kinds["aggregation_type"]:
        stereo.StereoDCSS(max_disp=64, aggregation_type=agg, refinement_type="stereonet")
    for ref in kinds["refinement_type"]:
        stereo.StereoDCSS(max_disp=64, refinement_type=ref)
    with pytest.raises(NotImplementedError, match="aggregation cost_filter"):
        stereo.StereoDCSS(aggregation_type="cost_filter")
