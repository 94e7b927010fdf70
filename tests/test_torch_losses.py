"""The port's training losses vs the JAX package's on the same numpy inputs:
focal in its four modes, cross-entropy, SupCon/SimCLR, hard-anchor sampling
(deterministic mode, since torch and JAX draw different random numbers),
pixel contrast and every branch of ``compute_total_loss``. All in f32 on
the CPU; tolerance rtol 1e-5 unless a test says otherwise."""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.config import CRITERIA  # noqa: E402
from doubly_contrastive_semseg_tpu.losses import combine as jcombine  # noqa: E402
from doubly_contrastive_semseg_tpu.losses import focal as jfocal  # noqa: E402
from doubly_contrastive_semseg_tpu.losses import pixel_contrast as jpc  # noqa: E402
from doubly_contrastive_semseg_tpu.losses import supcon as jsupcon  # noqa: E402
from doubly_contrastive_semseg_tpu.ops.interpolate import (  # noqa: E402
    resize_nearest as jax_resize_nearest)
from doubly_contrastive_semseg_tpu_torch import Config  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.losses import combine, focal  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.losses import pixel_contrast as pc  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.losses import supcon  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops import contrastive  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops.interpolate import resize_nearest  # noqa: E402

B, H, W, C, D = 2, 32, 48, 19, 16


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _seg_inputs(rng):
    logits = rng.standard_normal((B, H, W, C)).astype(np.float32) * 2
    target = rng.integers(0, C, (B, H, W)).astype(np.int32)
    target[:, :5, :7] = 255
    alphas = rng.uniform(0.05, 1.0, (B, H, W)).astype(np.float32)
    alphas[target == 255] = 0.0
    alphas[:, -3:, :] = 0.0  # some labelled pixels with weight 0 too
    class_weight = rng.uniform(0.5, 2.0, C).astype(np.float32)
    return logits, target, alphas, class_weight


@pytest.mark.parametrize("mode", ["full", "plain_focal", "no_class_weights", "no_EDT"])
@pytest.mark.parametrize("weighted", [True, False])
def test_focal_matches_jax(rng, mode, weighted):
    logits, target, alphas, cw = _seg_inputs(rng)
    cw = cw if weighted else None
    want, g_want = jax.value_and_grad(
        lambda x: jfocal.boundary_aware_focal_loss(
            x, jnp.asarray(target), jnp.asarray(alphas),
            None if cw is None else jnp.asarray(cw), mode=mode))(jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    got = focal.boundary_aware_focal_loss(x, _t(target), _t(alphas),
                                          None if cw is None else _t(cw), mode=mode)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_want), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(g_want)).max())


def test_focal_with_no_weighted_pixel_is_zero(rng):
    logits, target, alphas, cw = _seg_inputs(rng)
    got = focal.boundary_aware_focal_loss(_t(logits), _t(target), _t(alphas * 0), _t(cw),
                                          mode="plain_focal")
    want = jfocal.boundary_aware_focal_loss(jnp.asarray(logits), jnp.asarray(target),
                                            jnp.asarray(alphas * 0), jnp.asarray(cw),
                                            mode="plain_focal")
    assert got.item() == 0.0 == float(want)


def test_cross_entropy_matches_jax(rng):
    logits, target, _, _ = _seg_inputs(rng)
    want = jfocal.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(target))
    got = focal.cross_entropy_loss(_t(logits), _t(target))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    ref = torch.nn.functional.cross_entropy(_t(logits).permute(0, 3, 1, 2),
                                            _t(target).long(), ignore_index=255)
    np.testing.assert_allclose(got.item(), ref.item(), rtol=1e-5)


@pytest.mark.parametrize("with_labels", [True, False])
def test_supcon_dense_matches_jax(rng, with_labels):
    f = rng.standard_normal((12, 2, 32)).astype(np.float32)
    labels = rng.integers(0, 4, 12) if with_labels else None
    want, g_want = jax.value_and_grad(
        lambda x: jsupcon.supcon_loss(x, None if labels is None else jnp.asarray(labels),
                                      use_pallas=False))(jnp.asarray(f))
    x = _t(f).requires_grad_(True)
    before = contrastive.contrastive_row_stats.launches
    got = supcon.supcon_loss(x, None if labels is None else _t(labels))
    got.backward()
    assert contrastive.contrastive_row_stats.launches == before
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_want), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(g_want)).max())


def test_resize_nearest_matches_jax(rng):
    lab = rng.integers(0, 256, (2, 37, 53)).astype(np.int32)
    for size in ((9, 13), (37, 53), (74, 20)):
        np.testing.assert_array_equal(resize_nearest(_t(lab), size).numpy(),
                                      np.asarray(jax_resize_nearest(jnp.asarray(lab), size)))
    x = rng.standard_normal((2, 16, 24, 3)).astype(np.float32)  # NHWC
    np.testing.assert_array_equal(resize_nearest(_t(x), (5, 7)).numpy(),
                                  np.asarray(jax_resize_nearest(jnp.asarray(x), (5, 7))))


def _anchor_inputs(rng, b=3, p=60, c=5, d=8):
    feats = rng.standard_normal((b, p, d)).astype(np.float32)
    labels = rng.integers(0, c, (b, p)).astype(np.int32)
    labels[0, labels[0] == 1] = 255          # class 1 absent from image 0
    labels[1, :] = np.where(labels[1] == 2, 0, labels[1])
    labels[1, :2] = 2                        # exactly max_views pixels: invalid
    preds = np.where(rng.uniform(size=(b, p)) < 0.6, labels,
                     rng.integers(0, c, (b, p))).astype(np.int32)
    preds[2, labels[2] == 3] = 3             # class 3 all easy in image 2
    preds[2, labels[2] == 4] = 0             # class 4 all hard in image 2
    return feats, labels, preds, c


def test_hard_anchor_sampling_deterministic_matches_jax(rng):
    feats, labels, preds, c = _anchor_inputs(rng)
    jf, jl, jv = jpc._hard_anchor_sampling(
        jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(preds), c,
        jax.random.PRNGKey(0), deterministic_select=True)
    tf, tl, tv = pc._hard_anchor_sampling(_t(feats), _t(labels), _t(preds), c, None,
                                          deterministic_select=True)
    jv = np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert 0 < jv.sum() < jv.size
    # valid anchors draw from masks of >= 1 member each: no ties, same pixels
    np.testing.assert_array_equal(tf.numpy()[jv], np.asarray(jf)[jv])


def test_hard_anchor_sampling_random_keys_stay_in_masks(rng):
    feats, labels, preds, c = _anchor_inputs(rng)
    gen = torch.Generator().manual_seed(3)
    tf, tl, tv = pc._hard_anchor_sampling(_t(feats), _t(labels), _t(preds), c, gen)
    # every drawn pixel of a valid anchor carries the anchor's class
    for a in np.flatnonzero(tv.numpy()):
        b_img = a // c
        for view in range(2):
            hits = np.flatnonzero((feats[b_img] == tf.numpy()[a, view]).all(axis=1))
            assert len(hits) == 1 and labels[b_img, hits[0]] == tl[a].item()


@pytest.mark.parametrize("h,w", [(8, 12), (16, 24)])
def test_pixel_contrast_loss_matches_jax(rng, h, w):
    feats = rng.standard_normal((B, h, w, D)).astype(np.float32)
    labels = rng.integers(0, 6, (B, H, W)).astype(np.int32)
    labels[:, :6, :6] = 255
    logits = rng.standard_normal((B, h, w, C)).astype(np.float32)
    want, g_want = jax.value_and_grad(
        lambda x: jpc.pixel_contrast_loss(x, jnp.asarray(labels), jnp.asarray(logits),
                                          jax.random.PRNGKey(0),
                                          deterministic_select=True))(jnp.asarray(feats))
    x = _t(feats).requires_grad_(True)
    got = pc.pixel_contrast_loss(x, _t(labels), _t(logits), None,
                                 deterministic_select=True)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_want), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(g_want)).max())


def _loss_inputs(rng, h=8, w=12):
    logits, target, alphas, cw = _seg_inputs(rng)
    outputs = {
        "seg": logits,
        "seg_beforeup": rng.standard_normal((B, h, w, C)).astype(np.float32),
        "fine_feat0": rng.standard_normal((B, h, w, D)).astype(np.float32),
        "supcon_proj": rng.standard_normal((B, 2, D)).astype(np.float32),
    }
    batch = {"label": target, "label_distance_weight": alphas,
             "weather": rng.integers(0, 4, B).astype(np.int32)}
    return outputs, batch, cw


@pytest.mark.parametrize("criterion", CRITERIA)
@pytest.mark.parametrize("flags", [{}, {"no_class_weights": True}, {"no_EDT": True}])
def test_compute_total_loss_matches_jax(rng, criterion, flags):
    outputs, batch, cw = _loss_inputs(rng)
    jcfg = types.SimpleNamespace(**{"criterion": criterion, "num_classes": C,
                                    "ignore_index": 255, "reference_rng": True,
                                    "no_class_weights": False, "no_EDT": False, **flags})
    cfg = Config(criterion=criterion, reference_rng=True, **flags)
    want_total, want = jcombine.compute_total_loss(
        jcfg, {k: jnp.asarray(v) for k, v in outputs.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(cw),
        jax.random.PRNGKey(0))
    total, comps = combine.compute_total_loss(
        cfg, {k: _t(v) for k, v in outputs.items()}, {k: _t(v) for k, v in batch.items()},
        _t(cw), None)
    assert set(comps) == set(want)
    for k in want:
        np.testing.assert_allclose(comps[k].item(), float(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert total is comps["total_loss"]


def test_weather_classifier_metrics_match_jax(rng):
    logits = rng.standard_normal((6, 4)).astype(np.float32)
    gt = rng.integers(0, 4, 6).astype(np.int32)
    w_ce, w_acc = jcombine.weather_classifier_metrics(jnp.asarray(logits), jnp.asarray(gt))
    ce, acc = combine.weather_classifier_metrics(_t(logits), _t(gt))
    np.testing.assert_allclose(ce.item(), float(w_ce), rtol=1e-5)
    np.testing.assert_allclose(acc.item(), float(w_acc), rtol=1e-6)
