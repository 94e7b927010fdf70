"""The port's DCSSModel eval forward vs the JAX DCSSModel on the same weights.

JAX variables (batch stats and BN affine randomised from a numpy seed, so the
BN folds are exercised) go through ``from_jax_variables`` into the port; the
port's ``net.*`` weights then go back through the JAX package's own torch
converter to the same JAX tree, which also proves the port keeps the
reference's state_dict names.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.models import DCSSModel as JaxDCSSModel  # noqa: E402
from doubly_contrastive_semseg_tpu.ops.input_pipeline import s2d_pack  # noqa: E402
from doubly_contrastive_semseg_tpu.models.weathernet import (  # noqa: E402
    ProjectionHead as JaxProjectionHead)
from doubly_contrastive_semseg_tpu.utils.torch_convert import (  # noqa: E402
    convert_reference_weathernet, jax_to_py)
from doubly_contrastive_semseg_tpu_torch import Config, DCSSModel, build_model  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import make_serving_fn  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models import ProjectionHead, WeatherNet  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops import fused_stem_pool  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import from_jax_variables  # noqa: E402

# divisible by 128, so all 6 skip levels of the pyramid decoder run
SHAPE = (1, 128, 256, 3)


def randomize_bn(params, stats, rng):
    """Random BN scale/bias and running mean/var over every BN of the tree
    (every node with a running mean). Scales below 1 keep the outputs of
    order 1, so the absolute tolerance means what it says."""
    for key, node in stats.items():
        if "mean" in node:
            c = node["mean"].shape
            node["mean"] = rng.normal(0.0, 0.1, c).astype(np.float32)
            node["var"] = rng.uniform(1.0, 2.0, c).astype(np.float32)
            params[key]["scale"] = rng.uniform(0.5, 0.8, c).astype(np.float32)
            params[key]["bias"] = rng.normal(0.0, 0.1, c).astype(np.float32)
        else:
            randomize_bn(params[key], node, rng)


def jax_variables(rng, shape=SHAPE):
    """Initialised f32 JAX DCSSModel and its numpy variables."""
    model = JaxDCSSModel(backbone="resnet18", num_classes=19, weather_num=4,
                         dtype=jnp.float32)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros(shape), train=False)
    params, stats = jax_to_py(v["params"]), jax_to_py(v["batch_stats"])
    randomize_bn(params, stats, rng)
    return model, params, stats


def port_model(params, stats, **cfg):
    model = build_model(Config(compute_dtype="float32", **cfg), device="cpu")
    model.load_state_dict(from_jax_variables(params, stats), strict=True)
    return model


@pytest.mark.parametrize("fuse_stem", [True, False])
def test_eval_forward_matches_jax(rng, fuse_stem):
    jmodel, params, stats = jax_variables(rng)
    x = rng.uniform(0, 255, SHAPE).astype(np.float32)
    want = jmodel.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x), train=False)
    model = port_model(params, stats, fuse_stem=fuse_stem)
    before = fused_stem_pool.launches
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert fused_stem_pool.launches == before  # CPU: plain version only
    for key in ("seg_beforeup", "fine_feat", "seg", "weather_logits"):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_state_dict_round_trips_through_jax_converter(rng):
    """port net.* → the JAX package's convert_reference_weathernet → the
    original JAX net tree, the stem's s2d kernel included."""
    _, params, stats = jax_variables(rng)
    model = port_model(params, stats)
    net_sd = {k[len("net."):]: v.numpy() for k, v in model.state_dict().items()
              if k.startswith("net.")}
    back_p, back_s = convert_reference_weathernet(net_sd)

    def assert_same_tree(a, b, path=""):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            if isinstance(a[k], dict):
                assert_same_tree(a[k], b[k], f"{path}/{k}")
            else:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                              err_msg=f"{path}/{k}")

    assert_same_tree(back_p, params["net"])
    assert_same_tree(back_s, stats["net"])


def test_training_built_model_round_trips(rng):
    """A JAX model initialised for training holds ``projection``: it loads
    strictly into a port model built for a SupCon criterion, ``net.*`` goes
    back through the JAX converter to the same tree, ``projection.*`` back
    to the JAX dense kernels, and the two-view forward's projection agrees."""
    jmodel = JaxDCSSModel(backbone="resnet18", num_classes=19, weather_num=4,
                          dtype=jnp.float32)
    x = rng.uniform(0, 255, (2,) + SHAPE[1:]).astype(np.float32)
    v = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True,
                    return_supcon_feature=True)
    params, stats = jax_to_py(v["params"]), jax_to_py(v["batch_stats"])
    randomize_bn(params, stats, rng)
    assert "projection" in params
    model = port_model(params, stats, criterion="supcon_pixelcontrast_focal")
    sd = model.state_dict()
    back_p, back_s = convert_reference_weathernet(
        {k[len("net."):]: t.numpy() for k, t in sd.items() if k.startswith("net.")})
    np.testing.assert_array_equal(back_p["segmentation"]["conv"]["kernel"],
                                  params["net"]["segmentation"]["conv"]["kernel"])
    np.testing.assert_array_equal(back_s["feature_extractor"]["layer2_0"]["bn1"]["var"],
                                  stats["net"]["feature_extractor"]["layer2_0"]["bn1"]["var"])
    for name in ("fc1", "fc2"):
        np.testing.assert_array_equal(sd[f"projection.{name}.weight"].numpy().T,
                                      params["projection"][name]["kernel"])
        np.testing.assert_array_equal(sd[f"projection.{name}.bias"].numpy(),
                                      params["projection"][name]["bias"])
    want = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                        train=False, return_supcon_feature=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x), return_supcon_feature=True)
    for key in ("supcon_proj", "seg_beforeup", "weather_logits"):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    with pytest.raises(RuntimeError, match="projection"):  # built without the head
        port_model(params, stats)


def test_projection_head_matches_jax(rng):
    x = rng.standard_normal((4, 2, 128)).astype(np.float32)
    jhead = JaxProjectionHead()
    v = jax_to_py(jhead.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    head = ProjectionHead(128, 128)
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            getattr(head, name).weight.copy_(torch.tensor(v[name]["kernel"].T))
            getattr(head, name).bias.copy_(torch.tensor(v[name]["bias"]))
        got = head(torch.from_numpy(x)).numpy()
    want = np.asarray(jhead.apply({"params": v}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_unported_backbone_raises():
    """Every WeatherNet backbone of JAX's builds; a name JAX's factory does
    not know raises ``NotImplementedError`` naming it, as there."""
    with pytest.raises(NotImplementedError, match="model resnet50"):
        build_model(Config(model="resnet50"), device="cpu")
    with pytest.raises(NotImplementedError, match="backbone resnet50"):
        WeatherNet("resnet50")


def test_default_model_bn_stats_match_jax_after_train_step(rng):
    """``DCSSModel()`` with its defaults against JAX ``DCSSModel()`` with its
    own, JAX's initial variables carried over: one training-mode forward
    and backward at (2, 64, 64, 3). Both default to ``efficient=True`` (the
    reference's hard-coded checkpointing), whose recompute updates each
    BasicBlock's bn1/bn2 twice; a default of False updates them once, which
    leaves ``layer1.0.bn1.running_mean`` 0.43 of its largest entry off.

    Held: the running stats of the stem BNs and of layer1 and layer2,
    within 1e-5 of the tensor's largest entry (measured: at most 1.6e-6).
    Not held here: layer3, layer4 and the decoder. At this size their
    coarsest pyramid level has 1 or 2 pixels a channel, so their batch
    variances come from 2 to 8 values and carry the two f32 forwards'
    difference up to 0.2 of their scale; ``test_torch_train.py`` holds
    every BN stat after a full train step at 128², 4 images."""
    shape = (2, 64, 64, 3)
    jmodel = JaxDCSSModel()
    v = jmodel.init(jax.random.PRNGKey(0), jnp.zeros(shape), train=False)
    params, stats = jax_to_py(v["params"]), jax_to_py(v["batch_stats"])
    x = rng.uniform(0, 255, shape).astype(np.float32)
    _, mutated = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                              train=True, mutable=["batch_stats"])
    held = ("net.feature_extractor.bn1_", "net.feature_extractor.layer1.",
            "net.feature_extractor.layer2.")
    want = {k: v.numpy() for k, v in
            from_jax_variables({}, jax_to_py(mutated["batch_stats"])).items()
            if k.startswith(held) and not k.endswith("num_batches_tracked")}

    model = DCSSModel()
    model.load_state_dict(from_jax_variables(params, stats), strict=True)
    model.train()
    out = model(torch.from_numpy(x))
    (out["seg"].sum() + out["weather_logits"].sum()).backward()
    got = model.state_dict()
    assert len(want) == 2 * (3 + 2 * 2 * 2 + 1) and "net.feature_extractor.layer1.0.bn1.running_mean" in want
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_image_layouts_give_the_same_seg(rng):
    """NHWC, planar (B, 3, H, W) and s2d (B, H/2, W/2, 12, JAX ``s2d_pack``)
    images, f32, (1, 64, 128): the port's ``seg`` is bitwise equal across
    the three, each within 1e-4 × max|logit| of JAX's ``seg`` for the same
    layout, and ``make_serving_fn`` gives the same labels for all three."""
    shape = (1, 64, 128, 3)
    jmodel, params, stats = jax_variables(rng, shape)
    x = rng.uniform(0, 255, shape).astype(np.float32)
    layouts = {"nhwc": x, "planar": np.ascontiguousarray(x.transpose(0, 3, 1, 2)),
               "s2d": s2d_pack(x)}
    model = port_model(params, stats)
    serve = make_serving_fn(model, device="cpu")
    segs, labels = {}, {}
    for name, img in layouts.items():
        want = np.asarray(jmodel.apply({"params": params, "batch_stats": stats},
                                       jnp.asarray(img), train=False)["seg"])
        with torch.no_grad():
            segs[name] = model(torch.from_numpy(img))["seg"].numpy()
        labels[name] = serve(torch.from_numpy(img))
        assert segs[name].shape == want.shape == (1, 64, 128, 19), name
        np.testing.assert_allclose(segs[name], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)
    for name in ("planar", "s2d"):
        np.testing.assert_array_equal(segs[name], segs["nhwc"], err_msg=name)
        assert torch.equal(labels[name], labels["nhwc"]), name
    assert labels["nhwc"].shape == (1, 64, 128)
