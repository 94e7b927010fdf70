"""The port's host train transforms (``data/transforms.py``,
``data/chamfer.py``) vs Pillow, cv2 and the JAX package's transforms.

Tolerances: none where the arithmetic is the library's. ``resize_bicubic_pil``
is Pillow's ``BICUBIC`` bit for bit; the crops, the two views and the gamma
table are JAX's bit for bit, from the same seed. The chamfer is OpenCV's
fixed-point ``distanceTransform_3x3``: it equals
``cv2.distanceTransform(mask, cv2.DIST_L2, 3)`` bit for bit with IPP off
(``cv2.ipp.setUseIPP(False)``, a per-thread switch), and so do the EDT
weights of ``LabelBoundaryTransform`` against JAX's. With IPP on (the
wheel's default), cv2 sums in float32 in an order set by the CPU; there the
distances are held within 1e-5 of their value (measured: 5.3e-6) and the
weights within 2e-5 absolute. A map of one label has no boundary: there
``LabelBoundaryTransform`` gives the IPP route's result bit for bit (every
weight 1), as JAX's runs do by default.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
from PIL import Image  # noqa: E402

from doubly_contrastive_semseg_tpu.config import parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu.data import loader as jax_loader  # noqa: E402
from doubly_contrastive_semseg_tpu.data import transforms as jt  # noqa: E402
from doubly_contrastive_semseg_tpu.data.factory import MEAN_RGB as JAX_MEAN_RGB  # noqa: E402
from doubly_contrastive_semseg_tpu.data.factory import get_dataset as jax_get_dataset  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import Config  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data import (  # noqa: E402
    Compose, DataLoader, GammaCorrection, LabelBoundaryTransform, RandomSquareCropAndScale,
    ReferenceRng, SetTargetSize, ThreadSafeRng, ToArrays, TwoCropTransform, get_dataset,
    iter_transform_rngs, label_chamfer_distance)
from doubly_contrastive_semseg_tpu_torch.data.chamfer import DIST_MAX  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data.factory import MEAN_RGB  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data.transforms import resize_bicubic_pil  # noqa: E402


class FixedPointCv2:
    """A transform wrapper that turns cv2's IPP dispatch off in the thread
    that runs it (the switch is per thread; the loaders run transforms on
    their workers), so JAX's ``LabelBoundaryTransform`` takes OpenCV's
    fixed-point chamfer."""

    def __init__(self, transform):
        self.transform = transform

    def __call__(self, sample):
        was = cv2.ipp.useIPP()
        cv2.ipp.setUseIPP(False)
        try:
            return self.transform(sample)
        finally:
            cv2.ipp.setUseIPP(was)


def cv2_distances(labels, use_ipp: bool):
    """cv2's per-class distances on each class's own pixels, as JAX's
    ``LabelBoundaryTransform`` gathers them."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(use_ipp)
    try:
        out = np.full(labels.shape, np.nan, np.float32)
        for c in np.unique(labels):
            mask = labels == c
            out[mask] = cv2.distanceTransform(mask.astype(np.uint8), cv2.DIST_L2, 3)[mask]
        return out
    finally:
        cv2.ipp.setUseIPP(was)


def blocky_labels(rng, h, w, n_classes=5, n_boxes=8):
    lab = np.full((h, w), rng.integers(0, n_classes), np.uint8)
    for _ in range(n_boxes):
        c = rng.integers(0, n_classes)
        y0, x0 = rng.integers(0, max(h // 2, 1)), rng.integers(0, max(w // 2, 1))
        lab[y0:rng.integers(y0 + 1, h + 1), x0:rng.integers(x0 + 1, w + 1)] = c
    return lab


def label_case(name, rng):
    if name == "blocky":
        return blocky_labels(rng, 57, 83)
    if name == "ignore":
        lab = blocky_labels(rng, 61, 44)
        lab[rng.random(lab.shape) < 0.05] = 255
        lab[:8, :11] = 255
        return lab
    if name == "one class":
        return np.full((23, 31), 7, np.uint8)
    if name == "thin lines":
        lab = np.zeros((40, 50), np.uint8)
        lab[:, ::4] = 1            # one-pixel columns
        lab[::5] = 2               # one-pixel rows across them
        lab[np.arange(40), np.arange(40)] = 3   # a one-pixel diagonal
        return lab
    if name == "noise":
        return rng.integers(0, 3, (29, 37)).astype(np.uint8)
    if name == "one row":
        return blocky_labels(rng, 1, 70)
    if name == "one column":
        return blocky_labels(rng, 70, 1)
    raise KeyError(name)


CASES = ["blocky", "ignore", "one class", "thin lines", "noise", "one row", "one column"]


@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("src,size", [((64, 80), (37, 29)),      # down (w, h)
                                      ((37, 51), (160, 90)),     # up
                                      ((48, 40), (60, 31)),      # mixed
                                      ((97, 101), (48, 48)),     # ~2x down: the widest taps
                                      ((33, 35), (96, 96)),      # ~3x up
                                      ((40, 40), (40, 40))])     # the same size
def test_resize_bicubic_matches_pil(rng, mode, src, size):
    """Bit for bit ``Image.resize(size, Image.BICUBIC)``."""
    shape = src + ((3,) if mode == "RGB" else ())
    img = rng.integers(0, 256, shape).astype(np.uint8)
    want = np.asarray(Image.fromarray(img, mode).resize(size, Image.BICUBIC))
    got = resize_bicubic_pil(img, size)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_chamfer_matches_cv2(case):
    """Each pixel's distance is cv2's for its class's mask: bit for bit on
    OpenCV's fixed-point route, within 1e-5 of the value on IPP's."""
    labels = label_case(case, np.random.default_rng(CASES.index(case)))
    got = label_chamfer_distance(labels)
    assert got.dtype == np.float32 and got.shape == labels.shape
    np.testing.assert_array_equal(got, cv2_distances(labels, use_ipp=False))
    ipp = cv2_distances(labels, use_ipp=True)
    far = got == np.float32(DIST_MAX) * np.float32(2 ** -16)   # no pixel of another label
    np.testing.assert_allclose(got[~far], ipp[~far], rtol=1e-5, atol=0)
    if case == "one class":
        assert far.all() and got[0, 0] == np.float32(65534.63)


def _jax_sample(img, lbl, weather):
    return {"left": Image.fromarray(img), "label": Image.fromarray(lbl),
            "weather": np.array([weather]), "left_name": "a/b.png", "frame_name": "b*"}


def _port_sample(img, lbl, weather):
    return {"left": img, "label": lbl, "weather": np.array([weather]),
            "left_name": "a/b.png", "frame_name": "b*"}


def _assert_same(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (np.ndarray, Image.Image)):
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k
        else:
            assert g == w, k


@pytest.mark.parametrize("reduce", [True, False])
@pytest.mark.parametrize("case", ["blocky", "ignore", "one class", "thin lines"])
def test_label_boundary_transform_matches_jax(case, reduce):
    """Bit for bit JAX's with cv2 on its fixed-point route; within 2e-5
    of JAX's with IPP (the default). A map of one class has no boundary:
    there the port gives JAX's result on the default route bit for bit
    (IPP's FLT_MAX distances, σ = inf, every weight exp(-0) = 1), which the
    fixed-point route does not (65534.63, σ = 0, weights exp(-32767) = 0)."""
    labels = label_case(case, np.random.default_rng(10 + CASES.index(case)))
    if case == "ignore":
        labels[labels == 4] = 19          # a label past num_classes: no class of its own
    img = np.zeros(labels.shape + (3,), np.uint8)
    got = LabelBoundaryTransform(19, reduce=reduce)(_port_sample(img, labels, 0))
    key = "label_distance_weight" if reduce else "label_distance_transform"
    with np.errstate(over="ignore"):
        ipp = jt.LabelBoundaryTransform(19, reduce=reduce)(_jax_sample(img, labels, 0))
    if case == "one class":
        _assert_same({key: got[key]}, {key: ipp[key]})
        fixed = FixedPointCv2(jt.LabelBoundaryTransform(19, reduce=reduce))(
            _jax_sample(img, labels, 0))
        if reduce:
            assert (got[key] == 1).all() and not fixed[key].any()
        else:
            assert (got[key].max(axis=0) == np.finfo(np.float32).max).all()
        return
    want = FixedPointCv2(jt.LabelBoundaryTransform(19, reduce=reduce))(
        _jax_sample(img, labels, 0))
    _assert_same({key: got[key]}, {key: want[key]})
    if reduce:
        assert (got[key][labels == 255] == 0).all()
        np.testing.assert_allclose(got[key], ipp[key], rtol=0, atol=2e-5)


def test_label_boundary_transform_all_ignore():
    """σ = 0 (every pixel ignore): the guard takes σ = 1, weights 0."""
    labels = np.full((9, 13), 255, np.uint8)
    got = LabelBoundaryTransform(19)({"label": labels})["label_distance_weight"]
    want = jt.LabelBoundaryTransform(19)({"label": Image.fromarray(labels)})["label_distance_weight"]
    np.testing.assert_array_equal(got, want)
    assert not got.any()


@pytest.mark.parametrize("lo,hi", [(0.5, 0.9), (1.1, 2.0), (0.5, 2.0)])
@pytest.mark.parametrize("frame", [(40, 64), (30, 22)])
def test_random_square_crop_and_scale_matches_jax(lo, hi, frame):
    """The same draws from the same seed give JAX's boxes: images bit for
    bit (bicubic, mean padding), labels bit for bit (nearest, 255 padding),
    scales below and above 1, frames wider and narrower than the crop."""
    rng = np.random.default_rng(hash((lo, frame)) % 1000)
    img = rng.integers(0, 256, frame + (3,)).astype(np.uint8)
    lbl = rng.integers(0, 19, frame).astype(np.uint8)
    port = RandomSquareCropAndScale((32, 32), mean=MEAN_RGB, min=lo, max=hi,
                                    rng=np.random.default_rng(5))
    ref = jt.RandomSquareCropAndScale((32, 32), mean=JAX_MEAN_RGB, min=lo, max=hi,
                                      rng=np.random.default_rng(5))
    for _ in range(6):
        got = port(_port_sample(img, lbl, 0))
        want = ref(_jax_sample(img, lbl, 0))
        _assert_same(got, want)
        assert got["left"].shape == (32, 32, 3) and got["label"].shape == (32, 32)
    assert MEAN_RGB == JAX_MEAN_RGB


def _pipeline(mod, rng, gamma, crop=(24, 24)):
    tech = [mod.RandomSquareCropAndScale(crop, mean=MEAN_RGB, rng=rng),
            mod.SetTargetSize(crop, (crop[0] // 4, crop[1] // 4)),
            mod.LabelBoundaryTransform(19)]
    if gamma:
        tech.append(mod.GammaCorrection())
    tech.append(mod.ToArrays())
    return mod.TwoCropTransform(mod.Compose(tech))


class _PortModule:
    RandomSquareCropAndScale = RandomSquareCropAndScale
    SetTargetSize = SetTargetSize
    LabelBoundaryTransform = LabelBoundaryTransform
    GammaCorrection = GammaCorrection
    ToArrays = ToArrays
    TwoCropTransform = TwoCropTransform
    Compose = Compose


@pytest.mark.parametrize("reference_rng", [False, True])
@pytest.mark.parametrize("weather", [0, 1])
def test_two_crop_pipeline_matches_jax(weather, reference_rng):
    """The whole host train pipeline, two views, gamma on: JAX's samples bit
    for bit, from a Generator or from the reference's legacy stream."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (36, 52, 3)).astype(np.uint8)
    lbl = blocky_labels(rng, 36, 52, n_classes=19)
    lbl[:5, :7] = 255

    def make_rng(mod):
        return mod.ReferenceRng(9) if reference_rng else mod.ThreadSafeRng(np.random.default_rng(9))
    port_rng = ReferenceRng(9) if reference_rng else ThreadSafeRng(np.random.default_rng(9))
    port = _pipeline(_PortModule, port_rng, gamma=True)
    ref = FixedPointCv2(_pipeline(jt, make_rng(jt), gamma=True))
    for _ in range(3):
        got = port(_port_sample(img, lbl, weather))
        want = ref(_jax_sample(img, lbl, weather))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _assert_same(g, w)
        assert not np.array_equal(got[0]["left"], got[1]["left"])


@pytest.mark.parametrize("weather", [0, 1, 3])
def test_gamma_correction_matches_jax(weather):
    img = np.arange(256 * 3, dtype=np.int64).reshape(16, 16, 3).astype(np.uint8)
    got = GammaCorrection()({"left": img, "weather": np.array([weather])})
    want = jt.GammaCorrection()({"left": Image.fromarray(img), "weather": np.array([weather])})
    np.testing.assert_array_equal(GammaCorrection().lut, jt.GammaCorrection().lut)
    np.testing.assert_array_equal(got["left"], np.asarray(want["left"]))
    assert (weather == 1) != np.array_equal(got["left"], img)


def test_reference_rng_and_iter_transform_rngs():
    a, b = ReferenceRng(4), jt.ReferenceRng(4)
    assert a.uniform(0.5, 2.0) == b.uniform(0.5, 2.0)
    assert a.integers(0, 100) == b.integers(0, 100)
    np.testing.assert_array_equal(a.permutation(9), b.permutation(9))
    crop_rng = ReferenceRng(1)
    pipe = _pipeline(_PortModule, crop_rng, gamma=False)
    assert list(iter_transform_rngs(pipe)) == [crop_rng]
    assert list(iter_transform_rngs(None)) == []


def _jax_cfg(**kw):
    argv = ["--dataset", "synthetic", "--synthetic_hw", "64x80", "--synthetic_size", "6",
            "--criterion", "supcon_pixelcontrast_focal"]
    for k, v in kw.items():
        argv += [f"--{k}", str(v)]
    return parse_args(argv)


def test_get_dataset_synthetic_host_augment_matches_jax():
    """``get_dataset`` with ``host_augment=True`` (the default): the same
    loader batches as JAX's, the two views collated into one 2B image
    batch, EDT weights and weather included (one loader worker, so the
    shared generator's draws go to the same samples)."""
    cfg = Config(dataset="synthetic", synthetic_hw="64x80", synthetic_size=6,
                 criterion="supcon_pixelcontrast_focal")
    jcfg = _jax_cfg()
    assert cfg.host_augment and jcfg.host_augment and cfg.crop_wh == jcfg.crop_wh == (96, 96)
    port_train, port_val = get_dataset(cfg, seed=2)
    jax_train, jax_val = jax_get_dataset(jcfg, seed=2)
    jax_train.transform = FixedPointCv2(jax_train.transform)
    kw = dict(batch_size=3, shuffle=True, num_workers=1, drop_last=True, seed=4)
    for epoch in (0, 1):
        got = DataLoader(port_train, **kw)
        want = jax_loader.DataLoader(jax_train, **kw)
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        got, want = list(got), list(want)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _assert_same(g, w)
            assert g["left"].shape == (6, 96, 96, 3) and g["label"].shape == (3, 96, 96)
            assert g["label_distance_weight"].dtype == np.float32
    for i in range(len(jax_val)):
        _assert_same(port_val[i], jax_val[i])
