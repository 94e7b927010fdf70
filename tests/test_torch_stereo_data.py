"""The port's stereo data (``data/cityscapes.py::read_disp`` and the stereo
lists, ``data/stereo_transforms.py``, ``data/synthetic.py::
SyntheticStereoDataset``, ``train/trainer_stereo.py::_stereo_dataset``)
against the JAX package's, on the CPU.

No tolerance: every array is JAX's bit for bit (dtype, shape, bytes) and
every generator ends in JAX's state. The transforms run on the same seeded
``numpy.random.Generator`` in both packages. The stereo trainer's batches
are read from small SceneFlow- and KITTI-shaped trees written under
``tmp_path`` (PFM disparities of both byte orders, 16-bit disparity PNGs,
Cityscapes-id labels), one worker, with the batch drawn at construction
included: JAX's ``next(iter(train_loader))`` against the port's
``StereoTrainer``. The train split holds one batch, so JAX's read-ahead
draws no more than that batch.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from PIL import Image  # noqa: E402

from doubly_contrastive_semseg_tpu.config import parse_args as jax_parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu.data import cityscapes as jcity  # noqa: E402
from doubly_contrastive_semseg_tpu.data import stereo_transforms as jst  # noqa: E402
from doubly_contrastive_semseg_tpu.data.loader import DataLoader as JaxLoader  # noqa: E402
from doubly_contrastive_semseg_tpu.data.synthetic import (  # noqa: E402
    SyntheticStereoDataset as JaxSyntheticStereo)
from doubly_contrastive_semseg_tpu.train import trainer_stereo as jts  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.config import parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data import cityscapes, stereo_transforms as st  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data import write_png  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data.synthetic import SyntheticStereoDataset  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.train import StereoTrainer  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.train.trainer_stereo import _stereo_dataset  # noqa: E402

from test_torch_transforms import _assert_same  # noqa: E402
# the trainers reset the root logger and the signal handlers: put them back
from test_torch_trainer import restore_logging_and_signals  # noqa: E402,F401

SCENEFLOW_HW, KITTI_HW = (540, 960), (375, 1242)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def write_pfm(path, img, little_endian: bool) -> None:
    """A PFM file of ``img`` (H, W) or (H, W, 3), rows bottom to top."""
    img = np.asarray(img, np.float32)
    header = "PF" if img.ndim == 3 else "Pf"
    scale = -1.0 if little_endian else 1.0
    with open(path, "wb") as f:
        f.write(f"{header}\n{img.shape[1]} {img.shape[0]}\n{scale}\n".encode("ascii"))
        f.write(np.flipud(img).astype("<f4" if little_endian else ">f4").tobytes())


def same_array(got, want, what=""):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


def same_state(got_rng, want_rng):
    assert got_rng.bit_generator.state == want_rng.bit_generator.state


# ---- read_disp ------------------------------------------------------------------------

DISP_CASES = {
    "Pf little-endian": ("disp.pfm", "Pf", True),
    "Pf big-endian": ("disp.pfm", "Pf", False),
    "PF little-endian": ("disp.pfm", "PF", True),
    "PF big-endian": ("disp.pfm", "PF", False),
    "16-bit PNG": ("disp.png", 16, None),
    "8-bit PNG": ("disp.png", 8, None),
    "npy": ("disp.npy", None, None),
}


@pytest.mark.parametrize("name,kind,little", list(DISP_CASES.values()), ids=list(DISP_CASES))
def test_read_disp_matches_jax(tmp_path, rng, name, kind, little):
    """Bit for bit JAX's: the PFM's byte order from the scale's sign and its
    rows flipped; every PNG as v / 256 (``read_png``, 16-bit grey too)."""
    path = str(tmp_path / name)
    if kind in ("Pf", "PF"):
        shape = (7, 11, 3) if kind == "PF" else (7, 11)
        img = rng.uniform(-5, 300, shape).astype(np.float32)
        write_pfm(path, img, little)
        got = cityscapes.read_disp(path)
        np.testing.assert_array_equal(got, img)        # the rows come back in order
    elif kind == 16:
        img = rng.integers(0, 65536, (9, 13)).astype(np.uint16)
        img[:3] = 0                                     # no ground truth
        write_png(path, img, "adaptive")
        got = cityscapes.read_disp(path)
    elif kind == 8:
        write_png(path, rng.integers(0, 256, (9, 13)).astype(np.uint8), 2)
        got = cityscapes.read_disp(path)
    else:
        np.save(path, rng.uniform(0, 192, (9, 13)))
        got = cityscapes.read_disp(path)
    same_array(got, jcity.read_disp(path), name)
    assert got.dtype == np.float32


def test_read_disp_refuses_what_jax_refuses(tmp_path):
    bad = tmp_path / "bad.pfm"
    bad.write_bytes(b"P6\n1 1\n255\n\0\0\0")
    for read in (cityscapes.read_disp, jcity.read_disp):
        with pytest.raises(ValueError, match="not a PFM"):
            read(str(bad))
        with pytest.raises(ValueError, match="invalid disparity"):
            read(str(tmp_path / "disp.tiff"))


# ---- the transforms -----------------------------------------------------------------

def stereo_sample(rng, hw, float_images=False):
    def img():
        x = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
        return x.astype(np.float32) if float_images else x

    disp = rng.uniform(0, 64, hw).astype(np.float32)
    disp[: hw[0] // 3] = 0.0
    return {"left": img(), "right": img(), "disp": disp,
            "label": rng.integers(0, 19, hw).astype(np.uint8), "left_name": "a/b.png"}


def both(sample):
    return {k: np.copy(v) if isinstance(v, np.ndarray) else v for k, v in sample.items()}


CROP_CASES = {
    "random crop": ((40, 64), (24, 40), False),
    "centre crop": ((40, 64), (24, 40), True),
    "pad top and right": ((40, 64), (48, 80), False),
    "pad rows only": ((40, 64), (48, 64), True),
}


@pytest.mark.parametrize("hw,target,validate", list(CROP_CASES.values()), ids=list(CROP_CASES))
def test_stereo_random_crop_matches_jax(rng, hw, target, validate):
    """Every key of the crop or the pad (labels padded with 255), and the
    generator's state after it."""
    sample = stereo_sample(rng, hw, float_images=True)
    for seed in range(3):
        g_rng, w_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        got = st.StereoRandomCrop(*target, validate=validate, label_pad=255, rng=g_rng)(
            both(sample))
        want = jst.StereoRandomCrop(*target, validate=validate, label_pad=255, rng=w_rng)(
            both(sample))
        _assert_same(got, want)
        same_state(g_rng, w_rng)
        assert got["left"].shape[:2] == target
    if target[0] > hw[0]:
        assert (got["label"][: target[0] - hw[0]] == 255).all()
        assert (got["disp"][: target[0] - hw[0]] == 0).all()


def test_stereo_random_crop_refuses_pad_and_crop_in_one(rng):
    sample = stereo_sample(rng, (40, 64))
    for mod in (st, jst):
        with pytest.raises(ValueError, match="mixes pad and crop"):
            mod.StereoRandomCrop(48, 32)(both(sample))


def test_vertical_flip_matches_jax(rng):
    sample = stereo_sample(rng, (12, 20))
    flips = 0
    for seed in range(8):
        g_rng, w_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        got = st.StereoRandomVerticalFlip(rng=g_rng)(both(sample))
        want = jst.StereoRandomVerticalFlip(rng=w_rng)(both(sample))
        _assert_same(got, want)
        same_state(g_rng, w_rng)
        flips += not np.array_equal(got["left"], sample["left"])
    assert 0 < flips < 8


@pytest.mark.parametrize("name", ["RandomContrast", "RandomGamma", "RandomBrightness",
                                  "RandomHue", "RandomSaturation"])
def test_pair_photometrics_match_jax(rng, name):
    """One draw for both PIL views, over seeds that apply and skip."""
    sample = stereo_sample(rng, (24, 32))
    applied = 0
    for seed in range(6):
        pil = {k: Image.fromarray(sample[k]) for k in ("left", "right")}
        g_rng, w_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        got = getattr(st, name)(g_rng)(dict(pil))
        want = getattr(jst, name)(w_rng)(dict(pil))
        for k in ("left", "right"):
            same_array(np.asarray(got[k]), np.asarray(want[k]), f"{name} {k}")
        same_state(g_rng, w_rng)
        applied += got["left"] is not pil["left"]
    assert 0 < applied < 6


def test_random_color_matches_jax(rng):
    """uint8 arrays in, float32 arrays out, bit for bit JAX's, over seeds
    that take one photometric and all five in a drawn order; the draws
    on the one generator are JAX's (its state after each call)."""
    sample = stereo_sample(rng, (30, 44))
    one = 0
    for seed in range(10):
        g_rng, w_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        got = st.RandomColor(rng=g_rng)(both(sample))
        want = jst.RandomColor(rng=w_rng)(both(sample))
        _assert_same(got, want)
        same_state(g_rng, w_rng)
        one += np.random.default_rng(seed).random() < 0.5
        assert got["left"].dtype == np.float32
    assert 0 < one < 10


@pytest.mark.parametrize("reduce", [True, False])
def test_label_distance_transform_matches_jax(rng, reduce):
    labels = np.full((40, 56), 3, np.uint8)
    labels[5:25, 10:40] = 7
    labels[30:, :20] = 12
    labels[:4, :4] = 255
    labels[20:24, 44:50] = 0
    got = st.LabelDistanceTransform(19, reduce=reduce)({"label": labels})
    want = jst.LabelDistanceTransform(19, reduce=reduce)({"label": labels})
    _assert_same(got, want)
    key = "label_distance_alphas" if reduce else "label_distance_transform"
    assert len(np.unique(got[key])) > 3


# ---- the synthetic pairs ------------------------------------------------------------

@pytest.mark.parametrize("seed,hw,max_disp", [(0, (64, 96), 16), (1, (32, 48), 8)])
def test_synthetic_stereo_dataset_matches_jax(seed, hw, max_disp):
    got_dst = SyntheticStereoDataset(size=3, image_hw=hw, max_disp=max_disp, seed=seed)
    want_dst = JaxSyntheticStereo(size=3, image_hw=hw, max_disp=max_disp, seed=seed)
    assert len(got_dst) == len(want_dst) == 3
    for i in range(3):
        got, want = got_dst[i], want_dst[i]
        _assert_same(got, want)
        d = int(got["disp"].max())
        assert 2 <= d < max_disp - 2 and (got["disp"][:, :d] == 0).all()
        np.testing.assert_array_equal(got["right"][:, : hw[1] - d], got["left"][:, d:])


# ---- the stereo trainer's datasets and first batches --------------------------------

def frame(rng, hw):
    img = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
    img[: hw[0] // 2, : hw[1] // 3] //= 3
    return img


def write_stereo_tree(base, rng):
    """``<base>/sceneflow`` (540×960 PNG pairs, PFM disparities in both byte
    orders, no labels) and ``<base>/kitti_2015`` (375×1242 PNG pairs,
    16-bit disparity PNGs with about 30 % of pixels valid, Cityscapes-id
    labels), two train and two val frames each, with their lists under
    ``<base>/filenames``."""
    lists = {}
    for split in ("train", "val"):
        for i in range(2):
            stem = f"frames_finalpass/TRAIN/A/{split}{i:04d}"
            left, right = f"{stem}/left/0006.png", f"{stem}/right/0006.png"
            disp = f"disparity/TRAIN/A/{split}{i:04d}/left/0006.pfm"
            for rel, img in ((left, frame(rng, SCENEFLOW_HW)), (right, frame(rng, SCENEFLOW_HW))):
                os.makedirs(base / "sceneflow" / os.path.dirname(rel), exist_ok=True)
                write_png(base / "sceneflow" / rel, img, "adaptive")
            os.makedirs(base / "sceneflow" / os.path.dirname(disp), exist_ok=True)
            write_pfm(base / "sceneflow" / disp, rng.uniform(0.5, 180, SCENEFLOW_HW),
                      little_endian=i == 0)
            lists.setdefault(("sceneflow", f"SceneFlow_finalpass_{split}"), []).append(
                f"{left} {right} {disp}")

            kstem = f"training/image_2/{split}{i:04d}_10.png"
            kleft, kright = kstem, kstem.replace("image_2", "image_3")
            kdisp, klabel = kstem.replace("image_2", "disp_occ_0"), kstem.replace(
                "image_2", "semantic")
            raw = (rng.uniform(1, 120, KITTI_HW) * 256).astype(np.uint16)
            raw[rng.random(KITTI_HW) > 0.3] = 0
            ids = rng.integers(0, 34, KITTI_HW).astype(np.uint8)
            ids[100:200, 300:700] = 7
            for rel, img in ((kleft, frame(rng, KITTI_HW)), (kright, frame(rng, KITTI_HW)),
                             (kdisp, raw), (klabel, ids)):
                os.makedirs(base / "kitti_2015" / os.path.dirname(rel), exist_ok=True)
                write_png(base / "kitti_2015" / rel, img, "adaptive")
            lists.setdefault(("kitti_2015", f"KITTI_2015_{split}"), []).append(
                f"{kleft} {kright} {kdisp} {klabel}")
    for (sub, name), lines in lists.items():
        os.makedirs(base / "filenames" / sub, exist_ok=True)
        (base / "filenames" / sub / f"{name}.txt").write_text("\n".join(lines) + "\n")
    return base


@pytest.fixture(scope="module")
def stereo_tree(tmp_path_factory):
    return write_stereo_tree(tmp_path_factory.mktemp("stereo_tree"), np.random.default_rng(20))


def stereo_configs(tree, dataset, tmp_path, extra=()):
    argv = ["--dataset", dataset, "--data_root", str(tree), "--batch_size", "2",
            "--val_batch_size", "2", "--num_workers", "0", "--criterion", "none",
            "--compute_dtype", "float32", "--random_seed", "3", *extra]
    port = parse_args(argv + ["--filelist_root", str(tree / "filenames"), "--device", "cpu",
                              "--run_root", str(tmp_path), "--no_build_summary"])
    return port, jax_parse_args(argv)


@pytest.mark.parametrize("dataset,crop,val", [("sceneflow", (288, 576), (576, 960)),
                                              ("kitti_2015", (288, 1152), (384, 1248))])
def test_stereo_trainer_batches_match_jax(stereo_tree, tmp_path, monkeypatch,
                                          dataset, crop, val):
    """The port's ``StereoTrainer`` (its batch drawn at construction
    included) gives JAX's batches: epochs 0 and 1 of the train loader
    (``RandomColor`` → crop, on one generator), and the val batch (the
    centre pad-or-crop: SceneFlow's 540 rows padded to 576 on top, KITTI
    padded to 384×1248)."""
    monkeypatch.chdir(stereo_tree)                 # JAX reads ./filenames
    cfg, jcfg = stereo_configs(stereo_tree, dataset, tmp_path)
    trainer = StereoTrainer(cfg, device="cpu")
    jtrain, jval = jts._stereo_dataset(jcfg, "train"), jts._stereo_dataset(jcfg, "val")
    assert trainer.train_dst.samples == jtrain.samples
    assert trainer.val_dst.samples == jval.samples
    jloader = JaxLoader(jtrain, jcfg.batch_size, shuffle=True, num_workers=jcfg.num_workers,
                        drop_last=True, seed=jcfg.random_seed)
    next(iter(jloader))                            # JAX's batch at construction
    for epoch in (0, 1):
        trainer.train_loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got, want = list(trainer.train_loader), list(jloader)
        assert len(got) == len(want) == 1
        _assert_same(got[0], want[0])
        assert got[0]["left"].shape == (2,) + crop + (3,) and got[0]["left"].dtype == np.float32
        assert got[0]["disp"].shape == (2,) + crop
    got = next(iter(trainer.val_loader))
    _assert_same(got, next(iter(JaxLoader(jval, jcfg.val_batch_size, num_workers=1))))
    assert got["left"].shape == (2,) + val + (3,) and got["left"].dtype == np.uint8
    assert ("label" in got) == (dataset == "kitti_2015")
    valid = (got["disp"] > 0).mean()
    assert (0.2 < valid < 0.4) if dataset == "kitti_2015" else valid > 0.9


def test_stereo_dataset_shapes_follow_the_flags(stereo_tree, tmp_path, monkeypatch):
    """Flags off their defaults take over from the per-dataset shapes, in
    both packages; the synthetic route's sizes are JAX's."""
    monkeypatch.chdir(stereo_tree)
    extra = ["--img_height", "256", "--img_width", "512", "--val_img_height", "544",
             "--val_img_width", "960"]
    cfg, jcfg = stereo_configs(stereo_tree, "sceneflow", tmp_path, extra)
    for mode, shape in (("train", (256, 512)), ("val", (544, 960))):
        got, want = _stereo_dataset(cfg, mode)[0], jts._stereo_dataset(jcfg, mode)[0]
        _assert_same(got, want)
        assert got["left"].shape[:2] == want["left"].shape[:2] == shape
    for debug in (True, False):
        extra = ["--transfer_disparity"] + (["--debug"] if debug else [])
        cfg, jcfg = stereo_configs(stereo_tree, "synthetic", tmp_path, extra)
        for mode in ("train", "val"):
            got, want = _stereo_dataset(cfg, mode), jts._stereo_dataset(jcfg, mode)
            assert (len(got), got.image_hw, got.max_disp, got.seed) == \
                (len(want), want.image_hw, want.max_disp, want.seed)
