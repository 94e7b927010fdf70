"""The port's ACDC dataset (``data/acdc.py``) and its ``get_dataset`` route
vs the JAX package's, on a small ACDC tree written under ``tmp_path``.

No tolerance: samples (image, label, weather, names) are JAX's bit for bit,
and so are the loader batches of ``get_dataset("acdc")`` with the host
train transforms, the two views and gamma on night frames, with cv2's
chamfer on its fixed-point route in JAX's workers (see
``tests/test_torch_transforms.py`` for the IPP route's bound).
"""

import os
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from PIL import Image  # noqa: E402

from doubly_contrastive_semseg_tpu.config import parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu.data import acdc as jax_acdc  # noqa: E402
from doubly_contrastive_semseg_tpu.data import loader as jax_loader  # noqa: E402
from doubly_contrastive_semseg_tpu.data.factory import get_dataset as jax_get_dataset  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import Config  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data import DataLoader, get_dataset, write_png  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data import acdc, png  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.tools import profile_host_data  # noqa: E402

from test_torch_transforms import FixedPointCv2, _assert_same  # noqa: E402

HW = (30, 44)
# (split, weather, frame, filter the frame is written with; None: by PIL)
FRAMES = [("train", "fog", 41, 4), ("train", "night", 49, 3), ("train", "rain", 96, None),
          ("train", "snow", 102, 1), ("train", "night", 120, 2), ("val", "night", 761, 0),
          ("val", "fog", 769, [3, 4, 1, 2, 0] * 6), ("test", "snow", 247, 4)]


def write_tree(base, rng):
    """An ACDC-layout tree: ``<base>/acdc/rgb_anon_trainvaltest/...`` frames
    and ``gt_trainval/...`` labelIds, and ``<base>/filenames/acdc`` lists."""
    root = base / "acdc"
    lists = {}
    for split, weather, n, filt in FRAMES:
        rgb = f"rgb_anon_trainvaltest/rgb_anon/{weather}/{split}/GOPR0475/GOPR0475_frame_{n:06d}_rgb_anon.png"
        gt = f"gt_trainval/gt/{weather}/{split}/GOPR0475/GOPR0475_frame_{n:06d}_gt_labelIds.png"
        img = rng.integers(0, 256, HW + (3,)).astype(np.uint8)
        ids = rng.integers(0, 34, HW).astype(np.uint8)
        ids[:3, :5] = 255                       # past the table: clamped to the ignore row
        ids[3:12, 10:30] = 7                    # a road block
        for rel, arr in ((rgb, img), (gt, ids)):
            os.makedirs(root / os.path.dirname(rel), exist_ok=True)
            if filt is None:
                Image.fromarray(arr).save(root / rel)
            else:
                write_png(root / rel, arr, filt)
        line = f"{rgb} {weather}" if split == "test" else f"{rgb} {weather} {gt}"
        lists.setdefault(split, []).append(line)
    lists["train_small"] = lists["train"][:2]
    os.makedirs(base / "filenames" / "acdc")
    for split, lines in lists.items():
        (base / "filenames" / "acdc" / f"acdc_{split}.txt").write_text("\n".join(lines) + "\n")
    return root


@pytest.fixture
def tree(tmp_path):
    return write_tree(tmp_path, np.random.default_rng(7))


class Opts:
    def __init__(self, **kw):
        self.debug = kw.get("debug", False)
        self.weather_condition = kw.get("weather_condition")


def assert_same_datasets(got, want):
    assert len(got) == len(want)
    assert got.samples == want.samples
    for i in range(len(want)):
        _assert_same(got[i], want[i])


@pytest.mark.parametrize("mode", ["train", "val", "test"])
@pytest.mark.parametrize("opts", [dict(), dict(weather_condition="night"), dict(debug=True)])
def test_acdc_samples_match_jax(tree, mode, opts):
    """Image (PNG → RGB), label (labelIds → train ids), weather and names
    of every sample, the weather filter and the debug lists (``_small``
    where it exists, the full list where not)."""
    lists = str(tree.parent / "filenames")
    got = acdc.ACDC(str(tree), mode=mode, opts=Opts(**opts), filelist_root=lists)
    want = jax_acdc.ACDC(str(tree), mode=mode, opts=Opts(**opts), filelist_root=lists)
    assert_same_datasets(got, want)
    if opts.get("weather_condition"):
        assert {s["weather"] for s in got.samples} <= {1}
    if opts.get("debug") and mode == "train":
        assert len(got) == 2
    if mode == "test" and opts.get("weather_condition"):
        assert len(got) == 0          # the one test frame is a snow frame
        return
    s = got[0]
    assert s["left"].shape == HW + (3,) and s["left"].dtype == np.uint8
    assert ("label" in s) == (mode != "test")


def test_acdc_tables_match_jax():
    np.testing.assert_array_equal(acdc.CITYSCAPES_ID_TO_TRAIN_ID, jax_acdc.CITYSCAPES_ID_TO_TRAIN_ID)
    assert acdc.CITYSCAPES_ID_TO_TRAIN_ID.dtype == np.uint8
    assert acdc.COLOR_TO_EVAL_ID == jax_acdc.COLOR_TO_EVAL_ID
    assert acdc.WEATHER_DICT == jax_acdc.WEATHER_DICT
    assert acdc.WEATHER_DICT_WITH_SUNNY == jax_acdc.WEATHER_DICT_WITH_SUNNY
    ids = np.array([[0, 7, 26, 33, 34, 200, 255]], np.uint8)
    np.testing.assert_array_equal(acdc.ACDC.encode_target(ids), jax_acdc.ACDC.encode_target(ids))
    t = np.array([[0, 5, 18, 255]], np.uint8)
    np.testing.assert_array_equal(acdc.ACDC.decode_target(t), jax_acdc.ACDC.decode_target(t))
    for rgb in [(128, 64, 128), (153, 153, 153), (0, 0, 142), (0, 0, 0), (119, 11, 32)]:
        assert acdc.ACDC.convert_color_to_eval_id(rgb) == jax_acdc.ACDC.convert_color_to_eval_id(rgb)
    path = os.path.join(os.path.dirname(__file__), "..", "filenames", "acdc", "acdc_val.txt")
    assert acdc.read_text_lines(path) == jax_acdc.read_text_lines(path)


def test_get_dataset_acdc_host_augment_matches_jax(tree, monkeypatch):
    """``get_dataset("acdc")`` with the host train transforms (768² crops,
    EDT weights, gamma on the night frames, two views): JAX's loader
    batches bit for bit, and its val split through FixedResize and gamma
    (the lists under ./filenames, as JAX reads them)."""
    monkeypatch.chdir(tree.parent)
    cfg = Config(dataset="acdc", data_root=str(tree), criterion="supcon_pixelcontrast_focal",
                 use_gamma_correction=True, val_img_width=40, val_img_height=24)
    jcfg = parse_args(["--dataset", "acdc", "--data_root", str(tree), "--criterion",
                       "supcon_pixelcontrast_focal", "--use_gamma_correction",
                       "--val_img_width", "40", "--val_img_height", "24"])
    assert cfg.crop_wh == jcfg.crop_wh == (768, 768) and jcfg.data_root == str(tree)
    port_train, port_val = get_dataset(cfg, seed=1)
    jax_train, jax_val = jax_get_dataset(jcfg, seed=1)
    jax_train.transform = FixedPointCv2(jax_train.transform)
    kw = dict(batch_size=2, shuffle=True, num_workers=1, drop_last=True, seed=3)
    got, want = list(DataLoader(port_train, **kw)), list(jax_loader.DataLoader(jax_train, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_same(g, w)
        assert g["left"].shape == (4, 768, 768, 3) and g["label_distance_weight"].shape == (2, 768, 768)
    assert_same_datasets(port_val, jax_val)
    night = [i for i, s in enumerate(port_val.samples) if s["weather"] == 1]
    assert night and port_val[night[0]]["left"].shape == (24, 40, 3)
    test_cfg = Config(dataset="acdc", data_root=str(tree), use_test_data=True)
    assert len(get_dataset(test_cfg)[1]) == 1


def test_profile_tree_reads_back_like_pil(tmp_path):
    """The tree ``chip_smoke.py`` phase 16 writes (at a small size): every
    frame and label reads back as written through the port's ``ACDC`` and
    through JAX's (PIL), every frame with the five filters in turns down
    its rows, every label map filtered as Pillow filters it, a quarter
    night frames."""
    hw = (24, 40)
    root, lists = profile_host_data.write_acdc_tree(str(tmp_path), 6, 4, hw=hw)
    assert profile_host_data.check_acdc_tree(root, lists, hw=hw) == 10
    for mode in ("train", "val"):
        got = acdc.ACDC(root, mode=mode, filelist_root=lists)
        assert_same_datasets(got, jax_acdc.ACDC(root, mode=mode, filelist_root=lists))
    weathers = [s["weather"] for s in acdc.ACDC(root, mode="train", filelist_root=lists).samples]
    assert weathers == [0, 1, 2, 3, 0, 1]
    def scanlines(path):
        with open(path, "rb") as f:
            chunks = list(png._chunks(f.read()))
        return zlib.decompress(b"".join(body for kind, body in chunks if kind == b"IDAT"))

    for line in acdc.read_text_lines(os.path.join(lists, "acdc", "acdc_train.txt")):
        rgb, _, gt = line.split()
        kinds = np.frombuffer(scanlines(os.path.join(root, rgb)), np.uint8).reshape(hw[0], -1)[:, 0]
        np.testing.assert_array_equal(kinds, np.arange(hw[0]) % 5)
        Image.open(os.path.join(root, gt)).save(tmp_path / "pil.png")
        assert scanlines(os.path.join(root, gt)) == scanlines(tmp_path / "pil.png")
    ids = profile_host_data.acdc_frame(3, hw)[1]
    assert set(np.unique(ids)) <= {c.id for c in acdc.CLASSES if c.id >= 0}
