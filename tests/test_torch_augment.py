"""The port's on-device augmentation (``data/device_augment.py``) and the
loader-fed train slice vs the JAX package's.

JAX draws crop parameters from ``jax.random`` keys and the port from a
``torch.Generator``, so ``apply_augment`` is given JAX's own parameters,
drawn as JAX ``augment_batch`` draws them (``jax.random.split(rng, 2b)
.reshape(2, b, -1)`` → ``_sample_crop_params``). Tolerances:

- ``label``: exact.
- ``label_distance_weight``: 1e-6 on random label maps, 2e-6 on the
  synthetic frames' blocky ones, whose distances are larger. The EDT
  distances are bitwise equal (``test_torch_edt.py``); JAX sums σ in
  float32, a few 1e-6 (relative) from the exact σ, and a weight
  exp(−d/2σ) moves by up to 0.37 times that.
- ``left`` before gamma: within 1e-4 of the float64 contraction of JAX's
  own resampling weights (``jax.image``'s ``compute_weight_mat``), and
  within 2e-3 of JAX ``augment_batch``: JAX's vmapped contraction on the
  CPU is itself up to 1.4e-3 from that float64 value (measured), where
  JAX's unbatched ``_crop_image`` and the port are within 5e-5.
- ``left`` after gamma: the port's gamma equals JAX ``_gamma_night`` of
  the same pre-gamma crops within 1e-4. x^0.4 magnifies the pre-gamma
  difference without bound near 0, so it is not held against JAX
  ``augment_batch`` there.

The slice as a whole: both packages' synthetic loaders from one seed give
the same batch, both augment it from JAX's parameters, and one f32
supcon + pixel-contrast + focal train step from JAX's weights (carried by
``from_jax_variables``) at 64×80 frames and 32² crops gives loss
components within rtol 1e-4 of JAX ``make_train_step`` on JAX's augmented
batch (``reference_rng`` pins the pixel-contrast anchors on both sides).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat  # noqa: E402

from doubly_contrastive_semseg_tpu.config import parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu.data import device_augment as jax_aug  # noqa: E402
from doubly_contrastive_semseg_tpu.data.factory import get_dataset as jax_get_dataset  # noqa: E402
from doubly_contrastive_semseg_tpu.data.loader import DataLoader as JaxDataLoader  # noqa: E402
from doubly_contrastive_semseg_tpu.models import build_model as jax_build_model  # noqa: E402
from doubly_contrastive_semseg_tpu.train.optimizer import build_optimizer as jax_optimizer  # noqa: E402
from doubly_contrastive_semseg_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from doubly_contrastive_semseg_tpu.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from doubly_contrastive_semseg_tpu.utils import label_params_for_optimizer as jax_labels  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.torch_convert import jax_to_py  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import Config, build_model  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data import (  # noqa: E402
    DataLoader, apply_augment, augment_batch, get_dataset, sample_crop_params, to_device)
from doubly_contrastive_semseg_tpu_torch.ops import edt  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.train import (  # noqa: E402
    TrainState, build_optimizer, make_train_step)
from doubly_contrastive_semseg_tpu_torch.utils import from_jax_variables  # noqa: E402

B, H, W, CROP = 3, 64, 80, 32
CRITERION = "supcon_pixelcontrast_focal"


def jax_params(key, b, h, w, crop):
    """JAX ``augment_batch``'s crop parameters for ``key``: (x0, y0, box),
    each (2, b) float32."""
    keys = jax.random.split(key, 2 * b).reshape(2, b, -1)
    views = [jax.vmap(lambda k: jax_aug._sample_crop_params(k, h, w, crop, 0.5, 2.0))(keys[v])
             for v in range(2)]
    return tuple(np.stack([np.array(v[i]) for v in views]) for i in range(3))


def jax_augment(images, labels, weather, key, **kw):
    """JAX ``augment_batch``, its outputs copied to numpy before the port
    runs (JAX dispatches asynchronously)."""
    out = jax_aug.augment_batch(jnp.asarray(images), jnp.asarray(labels), jnp.asarray(weather),
                                key, **kw)
    return {k: np.array(v) for k, v in out.items()}


def float64_crops(images, params, crop):
    """JAX's resampling weights (``compute_weight_mat`` at JAX's scale and
    translation, float32) contracted in float64, then its mean fill outside
    the frame and its clip: what ``_crop_image`` computes, before rounding."""
    x0, y0, box = params
    out = []
    for v in range(x0.shape[0]):
        for b, img in enumerate(images):
            s = np.float32(crop) / box[v, b]
            wy = compute_weight_mat(img.shape[0], crop, jnp.float32(s), jnp.float32(-y0[v, b] * s),
                                    _fill_keys_cubic_kernel, False)
            wx = compute_weight_mat(img.shape[1], crop, jnp.float32(s), jnp.float32(-x0[v, b] * s),
                                    _fill_keys_cubic_kernel, False)
            o = np.einsum("hwc,ho,wp->opc", img.astype(np.float64),
                          np.asarray(wy, np.float64), np.asarray(wx, np.float64))
            oy = (np.arange(crop, dtype=np.float32) + 0.5) / s + y0[v, b]
            ox = (np.arange(crop, dtype=np.float32) + 0.5) / s + x0[v, b]
            inside = ((oy >= 0) & (oy <= img.shape[0]))[:, None] & \
                ((ox >= 0) & (ox <= img.shape[1]))[None, :]
            o = np.where(inside[..., None], o, np.array(jax_aug.MEAN_FILL, np.float64))
            out.append(np.clip(o, 0.0, 255.0))
    return np.stack(out)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(3)
    return (rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8),
            rng.integers(0, 19, (B, H, W)).astype(np.uint8),
            np.array([1, 0, 1], np.int32))


def _port(images, labels, weather, params, **kw):
    out = apply_augment(torch.from_numpy(images), torch.from_numpy(labels),
                        torch.from_numpy(weather), tuple(torch.from_numpy(p) for p in params), **kw)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("two_crop", [True, False])
def test_apply_augment_matches_jax(frames, seed, two_crop):
    images, labels, weather = frames
    key = jax.random.PRNGKey(seed)
    params = jax_params(key, B, H, W, CROP)
    want = jax_augment(images, labels, weather, key, crop=CROP, two_crop=two_crop,
                       use_gamma=False)
    launches = edt.nearest_diff_label_distance.launches
    got = _port(images, labels, weather, params, crop=CROP, two_crop=two_crop, use_gamma=False)
    assert edt.nearest_diff_label_distance.launches == launches   # CPU: plain version
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_array_equal(got["weather"], want["weather"])
    np.testing.assert_allclose(got["label_distance_weight"], want["label_distance_weight"],
                               rtol=0, atol=1e-6)
    views = params if two_crop else tuple(p[:1] for p in params)
    np.testing.assert_allclose(got["left"], float64_crops(images, views, CROP), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["left"], want["left"], rtol=0, atol=2e-3)
    assert got["left"].shape[0] == (2 if two_crop else 1) * B


@pytest.mark.parametrize("two_crop", [True, False])
def test_apply_augment_gamma_matches_jax(frames, two_crop):
    images, labels, weather = frames
    dark = (images // 5).astype(np.uint8)
    key = jax.random.PRNGKey(2)
    params = jax_params(key, B, H, W, CROP)
    plain = _port(dark, labels, weather, params, crop=CROP, two_crop=two_crop, use_gamma=False)
    got = _port(dark, labels, weather, params, crop=CROP, two_crop=two_crop, use_gamma=True)
    views = 2 if two_crop else 1
    wea = np.tile(weather, views)
    want = np.array(jax_aug._gamma_night(jnp.asarray(plain["left"]),
                                         jnp.asarray(wea)[:, None, None, None]))
    np.testing.assert_allclose(got["left"], want, rtol=0, atol=1e-4)
    night = wea == 1
    np.testing.assert_array_equal(got["left"][~night], plain["left"][~night])
    assert (got["left"][night].mean() > plain["left"][night].mean() + 5)
    ref = jax_augment(dark, labels, weather, key, crop=CROP, two_crop=two_crop, use_gamma=True)
    np.testing.assert_array_equal(got["label"], ref["label"])
    np.testing.assert_allclose(got["left"][~night], ref["left"][~night], rtol=0, atol=2e-3)


def test_sample_crop_params_law():
    """scale ~ U(0.5, 2): box = ⌊scale · crop⌋ in [⌊crop/2⌋, 2 crop),
    uniform; offsets integers, uniform over [0, max(side − box, 0)]."""
    crop, h, w, n = 96, 150, 200, 40000
    x0, y0, box = sample_crop_params(torch.Generator().manual_seed(0), n, h, w, crop)
    assert x0.shape == y0.shape == box.shape == (2, n) and box.dtype == torch.float32
    for t in (x0, y0, box):
        assert torch.equal(t, torch.floor(t))
    assert box.min() >= crop // 2 and box.max() < 2 * crop
    # box < crop  ⟺  scale < 1: a third of the draws; mean scale 1.25
    assert abs((box < crop).double().mean().item() - 1 / 3) < 0.01
    assert abs(((box + 0.5) / crop).double().mean().item() - 1.25) < 0.01
    for off, side in ((x0, w), (y0, h)):
        room = torch.clamp(side - box, min=0)
        assert bool((off >= 0).all()) and bool((off <= room).all())
        free = room > 0
        assert abs((off[free] / room[free]).double().mean().item() - 0.5) < 0.01
        assert bool((off[~free] == 0).all())
    a = sample_crop_params(torch.Generator().manual_seed(7), 4, h, w, crop, two_crop=False)
    b = sample_crop_params(torch.Generator().manual_seed(7), 4, h, w, crop, two_crop=False)
    c = sample_crop_params(torch.Generator().manual_seed(8), 4, h, w, crop, two_crop=False)
    assert all(torch.equal(p, q) for p, q in zip(a, b)) and a[2].shape == (1, 4)
    assert not all(torch.equal(p, q) for p, q in zip(a, c))


def test_augment_batch_contract(frames):
    """JAX's contract test for ``augment_batch`` on the port: shapes,
    ranges, ignore and weights, independent views, one generator seed
    giving one batch."""
    images, labels, weather = (torch.from_numpy(a) for a in frames)
    out = augment_batch(images, labels, weather, torch.Generator().manual_seed(0), crop=CROP,
                        two_crop=True, use_gamma=True)
    assert tuple(out["left"].shape) == (2 * B, CROP, CROP, 3) and out["left"].dtype == torch.float32
    assert tuple(out["label"].shape) == tuple(out["label_distance_weight"].shape) == (B, CROP, CROP)
    assert out["label"].dtype == torch.uint8
    lb, w = out["label"], out["label_distance_weight"]
    assert 0 <= out["left"].min() and out["left"].max() <= 255
    assert set(lb.unique().tolist()) <= set(range(19)) | {255}
    assert bool((w[lb != 255] > 0).all()) and w.max() <= 1.0001 and bool((w[lb == 255] == 0).all())
    assert not torch.equal(out["left"][0], out["left"][B])
    again = augment_batch(images, labels, weather, torch.Generator().manual_seed(0), crop=CROP,
                          two_crop=True, use_gamma=True)
    assert all(torch.equal(out[k], again[k]) for k in out)


def _jax_cfg():
    return parse_args(["--dataset", "synthetic", "--synthetic_hw", f"{H}x{W}",
                       "--synthetic_size", "4", "--no_host_augment", "--criterion", CRITERION,
                       "--batch_size", "2", "--compute_dtype", "float32", "--reference_rng"])


def test_loader_fed_train_step_matches_jax():
    jcfg = _jax_cfg()
    cfg = Config(dataset="synthetic", synthetic_hw=f"{H}x{W}", synthetic_size=4,
                 host_augment=False, criterion=CRITERION, batch_size=2,
                 compute_dtype="float32", reference_rng=True)
    # both loaders from one seed: the same first batch
    jbatch = next(iter(JaxDataLoader(jax_get_dataset(jcfg, seed=1)[0], 2, shuffle=True,
                                     num_workers=2, drop_last=True, seed=1)))
    batch = next(iter(DataLoader(get_dataset(cfg, seed=1)[0], 2, shuffle=True, num_workers=2,
                                 drop_last=True, seed=1)))
    for k in ("left", "label", "weather"):
        assert batch[k].tobytes() == jbatch[k].tobytes() and batch[k].dtype == jbatch[k].dtype
    assert batch["left_name"] == jbatch["left_name"]

    # both augmentations from JAX's parameters
    key = jax.random.fold_in(jax.random.PRNGKey(jcfg.random_seed + 1), 1)
    params = jax_params(key, 2, H, W, CROP)
    jaug = jax_augment(jbatch["left"], jbatch["label"], jbatch["weather"], key, crop=CROP,
                       num_classes=19, two_crop=True, use_gamma=False)
    db = to_device(batch, "cpu", class_weight=np.ones(19, np.float32))
    db.update(apply_augment(db["left"], db["label"], db["weather"],
                            tuple(torch.from_numpy(p) for p in params), crop=CROP,
                            num_classes=19, two_crop=True, use_gamma=False))
    np.testing.assert_array_equal(db["label"].numpy(), jaug["label"])
    np.testing.assert_allclose(db["label_distance_weight"].numpy(),
                               jaug["label_distance_weight"], rtol=0, atol=2e-6)
    np.testing.assert_allclose(db["left"].numpy(), jaug["left"], rtol=0, atol=2e-3)

    # one train step of each from JAX's weights
    jmodel = jax_build_model(jcfg)
    v = jax.jit(jmodel.init, static_argnames=("train", "return_supcon_feature"))(
        jax.random.PRNGKey(0), jnp.asarray(jaug["left"]), train=True,
        return_supcon_feature=True)
    params_tree, stats = jax_to_py(v["params"]), jax_to_py(v["batch_stats"])
    tx = jax_optimizer(jcfg, jax_labels(params_tree, jcfg), steps_per_epoch=2)
    jstate = JaxTrainState(params=params_tree, batch_stats=stats,
                           opt_state=tx.init(params_tree), step=jnp.zeros((), jnp.int32))
    jdb = {k: jnp.asarray(a) for k, a in jaug.items()}
    jdb["class_weight"] = jnp.ones((19,), jnp.float32)
    _, jmetrics = jax.jit(jax_make_train_step(jmodel, jcfg, tx))(jstate, jdb,
                                                                  jax.random.PRNGKey(1))
    jmetrics = {k: float(a) for k, a in jmetrics.items()}

    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(params_tree, stats), strict=True)
    opt = build_optimizer(model, cfg, steps_per_epoch=2)
    metrics = make_train_step(model, cfg, opt)(TrainState(model, opt), db, None)
    for k in ("total_loss", "seg_loss", "supcon_loss", "pixelcontrast_loss", "weather_loss",
              "weather_clf_acc"):
        np.testing.assert_allclose(metrics[k].item(), jmetrics[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert metrics["pixelcontrast_loss"].item() > 0 and metrics["supcon_loss"].item() > 0
