"""The six transforms the JAX package exports and no pipeline calls
(``ColorJitter``, ``RandomHorizontalFlip``, ``RandomVerticalFlip``,
``RandomResizedCrop``, ``RandomAffine``, ``RandomErasing``), ported to
numpy samples in ``data/transforms.py``, vs JAX's on PIL samples.

No tolerance: on the same seeded ``np.random.Generator`` each gives JAX's
image and label bit for bit and leaves the generator where JAX's leaves it
(the next draw is equal), over several seeds: every ``ColorJitter`` op on,
in its drawn order; flips taken and not; ``RandomResizedCrop``'s tries and
both of its fallbacks; ``RandomAffine`` under rotation, translation, scale
and shear; ``RandomErasing`` with a value and with normal draws.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from PIL import Image  # noqa: E402

from doubly_contrastive_semseg_tpu.data import transforms as jt  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data import transforms as pt  # noqa: E402

HW = (37, 53)
SEEDS = range(5)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def sample(seed):
    rng = np.random.default_rng(100 + seed)
    img = rng.integers(0, 256, HW + (3,)).astype(np.uint8)
    img[5:20, 10:40] = (200, 40, 90)
    label = rng.integers(0, 19, HW).astype(np.uint8)
    label[20:, :25] = 255
    return img, label


def run_both(make, seed, pil_input=True):
    """The port's and JAX's transform (built by ``make(rng)``) on one
    sample from generators of one seed; returns both outputs as arrays."""
    img, label = sample(seed)
    g_rng, w_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    got = make(pt, g_rng)({"left": img.copy(), "label": label.copy()})
    jin = {"left": Image.fromarray(img), "label": Image.fromarray(label)} if pil_input \
        else {"left": img.copy(), "label": label.copy()}
    want = make(jt, w_rng)(jin)
    assert g_rng.random() == w_rng.random()              # the same draws were taken
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got, (img, label)


@pytest.mark.parametrize("seed", SEEDS)
def test_color_jitter_matches_jax(seed):
    got, (img, _) = run_both(lambda m, rng: m.ColorJitter(0.4, 0.5, 0.6, 0.2, rng=rng), seed)
    assert not np.array_equal(got["left"], img)
    run_both(lambda m, rng: m.ColorJitter(contrast=0.3, rng=rng), seed)
    with pytest.raises(ValueError, match="hue_factor"):
        pt.adjust_hue(Image.fromarray(img), 0.6)


@pytest.mark.parametrize("seed", SEEDS)
def test_flips_match_jax(seed):
    flipped = []
    for name in ("RandomHorizontalFlip", "RandomVerticalFlip"):
        got, (img, _) = run_both(lambda m, rng: getattr(m, name)(p=0.5, rng=rng), seed)
        flipped.append(not np.array_equal(got["left"], img))
    rng = np.random.default_rng(seed)
    assert flipped[0] == (rng.random() < 0.5)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", ["tries", "narrow fallback", "wide fallback"])
def test_random_resized_crop_matches_jax(seed, case):
    kw = {"tries": dict(size=(24, 16)), "narrow fallback": dict(size=20, ratio=(5.0, 6.0)),
          "wide fallback": dict(size=(12, 30), scale=(0.9, 1.0), ratio=(0.1, 0.2))}[case]
    got, _ = run_both(lambda m, rng: m.RandomResizedCrop(rng=rng, **kw), seed)
    size = kw["size"] if isinstance(kw["size"], tuple) else (kw["size"],) * 2
    assert got["left"].shape == (size[1], size[0], 3) and got["label"].shape == (size[1], size[0])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kw", [
    dict(degrees=25, translate=(0.1, 0.2), scale=(0.7, 1.3), shear=12),
    dict(degrees=(-5, 15), shear=(-8, 8, -4, 4), fillcolor=(10, 20, 30)),
    dict(degrees=0, translate=(0.2, 0.1), shear=(3, 9))], ids=["all", "4-shear", "no rotation"])
def test_random_affine_matches_jax(seed, kw):
    got, (img, label) = run_both(lambda m, rng: m.RandomAffine(rng=rng, **kw), seed)
    assert not np.array_equal(got["label"], label)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("value", [0.0, "random", 7.5])
def test_random_erasing_matches_jax(seed, value):
    run_both(lambda m, rng: m.RandomErasing(p=0.8, value=value, rng=rng), seed, pil_input=False)
