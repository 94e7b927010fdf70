"""The port's ``cityscapes``, ``acdc_city`` and ``city_lost`` datasets
(``data/cityscapes.py``, ``data/acdc_city.py``, ``data/citylostfound.py``),
``CropBlackArea`` and their ``get_dataset`` routes vs the JAX package's, on
a small tree of all three written under ``tmp_path``.

No tolerance: the samples of every mode (every key: images, right frames,
labels, weather, EDT weights, the two views, names) and their collated
batches are JAX's bit for bit, with cv2's chamfer on its fixed-point route
in JAX's transforms (``tests/test_torch_transforms.py`` holds the IPP
route to its bound), under the host crops and the on-device route,
``--new_crop`` and ``--not_md_fusion``; ``CropBlackArea`` is Pillow's on a
1024×2048 frame and on one smaller than its box. Runs that read a weather
label these datasets lack fail in both packages, and ``main`` runs an
epoch of each on the CPU.
"""

import logging
import os
import signal
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from PIL import Image  # noqa: E402

from doubly_contrastive_semseg_tpu.config import parse_args as jax_parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu.data import citylostfound as jax_clf  # noqa: E402
from doubly_contrastive_semseg_tpu.data import loader as jax_loader  # noqa: E402
from doubly_contrastive_semseg_tpu.data import transforms as jt  # noqa: E402
from doubly_contrastive_semseg_tpu.data.factory import get_dataset as jax_get_dataset  # noqa: E402
from doubly_contrastive_semseg_tpu.losses import combine as jax_combine  # noqa: E402
from doubly_contrastive_semseg_tpu.metrics import Evaluator as JaxEvaluator  # noqa: E402
from doubly_contrastive_semseg_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.config import CRITERIA, parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data import citylostfound, collate, get_dataset  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data import write_png  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data.acdc import ACDC  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data.cityscapes import Cityscapes  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data.transforms import (CropBlackArea,  # noqa: E402
                                                                 _resize_pil)
from doubly_contrastive_semseg_tpu_torch.main import main as port_main  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.train import Trainer  # noqa: E402

from test_torch_transforms import FixedPointCv2, _assert_same  # noqa: E402

CITY_HW, ACDC_HW, LF_HW = (40, 72), (36, 64), (48, 160)   # (h, w); Lost&Found meets the box


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _save(path, arr, how):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if how is None:
        Image.fromarray(arr).save(path)
    else:
        write_png(path, arr, how)


def write_tree(base, rng, n_train=2):
    """``<base>/{cityscapes,acdc,city_lost}`` and their lists under
    ``<base>/filenames``: ``n_train`` train frames of each dataset, one val
    frame (two of ACDC); Cityscapes train frames with right frames, val
    frames without; labelIds past 33 (clamped to the ignore id); ACDC
    frames of four weathers; Lost&Found labelIds 0, 1 and ≥ 2."""
    lists = {}

    def frame(hw):
        img = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
        img[: hw[0] // 2, : hw[1] // 3] //= 3                     # some structure
        return img

    for split, n in (("train", n_train), ("val", 1)):
        for i in range(n):
            stem = f"{split}/aachen/aachen_{i:06d}_000019"
            left, right = f"leftImg8bit/{stem}_leftImg8bit.png", f"rightImg8bit/{stem}_rightImg8bit.png"
            gt = f"gtFine/{stem}_gtFine_labelIds.png"
            ids = rng.integers(0, 34, CITY_HW).astype(np.uint8)
            ids[:4, :6] = 255
            ids[4:8, :6] = 40
            ids[10:30, 20:50] = 7
            _save(base / "cityscapes" / left, frame(CITY_HW), "adaptive" if i else None)
            if split == "train":
                _save(base / "cityscapes" / right, frame(CITY_HW), 2)
            _save(base / "cityscapes" / gt, ids, None if i else 4)
            lists.setdefault(("cityscapes", f"cityscapes_semantic_{split}"), []).append(
                f"{left} {right} disparity/{stem}_disparity.png {gt}")
    acdc = [("train", "fog"), ("train", "night")][:n_train] + [("val", "rain"), ("val", "snow")]
    for k, (split, weather) in enumerate(acdc):
        stem = f"{weather}/{split}/GOPR0475/GOPR0475_frame_{k:06d}"
        rgb, gt = f"rgb_anon_trainvaltest/rgb_anon/{stem}_rgb_anon.png", f"gt_trainval/gt/{stem}_gt_labelIds.png"
        ids = rng.integers(0, 34, ACDC_HW).astype(np.uint8)
        ids[5:25, 5:40] = 26
        _save(base / "acdc" / rgb, frame(ACDC_HW), k % 5)
        _save(base / "acdc" / gt, ids, "adaptive")
        lists.setdefault(("acdc", f"acdc_{split}"), []).append(f"{rgb} {weather} {gt}")
    for split, n in (("train", n_train), ("val", 1)):
        for i in range(n):
            stem = f"{split}/01_Hanns_Klemm_Str_45/01_Hanns_Klemm_Str_45_{i:06d}_{i:06d}"
            left, gt = f"leftImg8bit/{stem}_leftImg8bit.png", f"gtCoarse/{stem}_gtCoarse_labelIds.png"
            ids = rng.choice(np.array([0, 1, 1, 2, 5, 200], np.uint8), LF_HW)
            ids[30:, 100:] = 1
            img = frame(LF_HW)
            img[:30] = 0                                        # the black border
            _save(base / "city_lost" / left, img, "adaptive")
            _save(base / "city_lost" / gt, ids, None)
            lists.setdefault(("city_lost", f"lostfound_{split}"), []).append(
                f"{left} rightImg8bit/{stem}_rightImg8bit.png disparity/{stem}_disparity.png {gt}")
    for (sub, name), lines in lists.items():
        os.makedirs(base / "filenames" / sub, exist_ok=True)
        (base / "filenames" / sub / f"{name}.txt").write_text("\n".join(lines) + "\n")
    return base


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("city_tree"), np.random.default_rng(16))


def configs(tree, argv):
    """The port's and JAX's parsed configs of ``argv`` over ``tree`` (the
    port's lists named by ``--filelist_root``, JAX's read from ./filenames)."""
    common = ["--data_root", str(tree), "--reference_rng", "--val_img_width", "56",
              "--val_img_height", "32"]
    port = parse_args(argv + common + ["--filelist_root", str(tree / "filenames")])
    return port, jax_parse_args(argv + common)


def assert_same_sample(got, want):
    if isinstance(want, list):                   # TwoCropTransform's two views
        assert isinstance(got, list) and len(got) == len(want) == 2
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        _assert_same(got, want)


# flags, the train and val samples; pixelcontrast_focal: one view,
# supcon_pixelcontrast_focal (the default): two
SAMPLE_CASES = {
    "cityscapes": (["--dataset", "cityscapes", "--criterion", "pixelcontrast_focal"], 2, 1),
    "cityscapes device augment": (["--dataset", "cityscapes", "--no_host_augment"], 2, 1),
    "acdc_city": (["--dataset", "acdc_city", "--weather_num", "5", "--use_gamma_correction"], 4, 3),
    "acdc_city device augment": (["--dataset", "acdc_city", "--no_host_augment"], 4, 3),
    "city_lost": (["--dataset", "city_lost", "--criterion", "pixelcontrast_focal"], 4, 2),
    "city_lost new_crop": (["--dataset", "city_lost", "--new_crop"], 4, 2),
    "city_lost not_md_fusion new_crop": (
        ["--dataset", "city_lost", "--not_md_fusion", "--new_crop", "--no_host_augment",
         "--criterion", "pixelcontrast_focal"], 2, 1),
}


@pytest.mark.parametrize("argv,n_train,n_val", list(SAMPLE_CASES.values()), ids=list(SAMPLE_CASES))
def test_get_dataset_samples_and_batches_match_jax(tree, argv, n_train, n_val, monkeypatch):
    monkeypatch.chdir(tree)
    cfg, jcfg = configs(tree, argv)
    assert cfg.crop_wh == jcfg.crop_wh and cfg.num_classes == jcfg.num_classes
    got, want = get_dataset(cfg, seed=1), jax_get_dataset(jcfg, seed=1)
    want[0].transform = FixedPointCv2(want[0].transform)
    assert [len(d) for d in got] == [len(d) for d in want] == [n_train, n_val]
    for g_dst, w_dst in zip(got, want):
        assert g_dst.samples == w_dst.samples
        g_all, w_all = [g_dst[i] for i in range(len(w_dst))], [w_dst[i] for i in range(len(w_dst))]
        for g, w in zip(g_all, w_all):
            assert_same_sample(g, w)
        try:
            w_batch = jax_loader.collate(w_all)
        except ValueError:
            # uncropped ACDC and Cityscapes frames differ in size: JAX
            # cannot stack them, nor can the port
            assert cfg.dataset == "acdc_city" and not cfg.host_augment
            with pytest.raises(ValueError, match="same shape"):
                collate(g_all)
            continue
        _assert_same(collate(g_all), w_batch)
    train, val = got[0][0], got[1][0]
    view = train[0] if isinstance(train, list) else train
    if cfg.host_augment or cfg.dataset == "city_lost":
        assert view["left"].shape == (cfg.crop_wh[1], cfg.crop_wh[0], 3)
        assert view["label_distance_weight"].shape == view["label"].shape
    assert val["left"].shape == (32, 56, 3)
    assert ("weather" in view) == (cfg.dataset == "acdc_city")
    assert ("right" in view) == (cfg.dataset == "cityscapes")


def test_acdc_city_reads_both_roots_and_weathers(tree):
    """ACDC's frames first, then Cityscapes' as weather 4 (sunny); names
    as JAX forms them."""
    cfg, _ = configs(tree, ["--dataset", "acdc_city", "--weather_num", "5"])
    train, val = get_dataset(cfg)
    assert cfg.data_root == str(tree / "acdc_city")
    assert [s["weather"] for s in train.samples] == [0, 1, 4, 4]
    assert [s["weather"] for s in val.samples] == [2, 3, 4]
    assert train.samples[0]["left"].startswith(str(tree / "acdc") + os.sep)
    assert train.samples[2]["left"].startswith(str(tree / "cityscapes") + os.sep)
    assert train.samples[0]["frame_name"] == "GOPR0475_frame_000000*.png"


def test_cityscapes_route_refuses_stereo(tree):
    """The stereo lists and ``load_disp=True`` read the disparity column
    (``read_disp``: the PNG as v / 256, as JAX reads every PNG); on the
    semantic route ``cityscapes`` leaves it unread, as in JAX."""
    lists = tree / "filenames"
    assert "disp" not in Cityscapes(str(tree / "cityscapes"), filelist_root=str(lists))[0]
    os.makedirs(tree / "cityscapes" / "disparity" / "train" / "aachen", exist_ok=True)
    raw = np.random.default_rng(3).integers(0, 65536, CITY_HW).astype(np.uint16)
    rec = Cityscapes(str(tree / "cityscapes"), filelist_root=str(lists)).samples[0]
    write_png(rec["disp"], raw)
    got = Cityscapes(str(tree / "cityscapes"), filelist_root=str(lists), load_disp=True)[0]
    np.testing.assert_array_equal(got["disp"], raw.astype(np.float32) / 256)
    os.makedirs(lists / "kitti_2015", exist_ok=True)
    (lists / "kitti_2015" / "KITTI_2015_train.txt").write_text(
        (lists / "cityscapes" / "cityscapes_semantic_train.txt").read_text())
    kitti = Cityscapes(str(tree / "cityscapes"), dataset_name="kitti_2015",
                       filelist_root=str(lists))
    assert kitti.load_disp and kitti.samples == Cityscapes(
        str(tree / "cityscapes"), filelist_root=str(lists)).samples
    np.testing.assert_array_equal(kitti[0]["disp"], got["disp"])


def _box_image(hw, rng):
    img = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
    img[:30], img[:, :140] = 0, 0                         # the black border
    img[200:400, 300:900] = (128, 64, 128)
    label = rng.choice(np.array([0, 1, 7, 19, 255], np.uint8), hw)
    label[300:700, 500:1500] = 13
    return img, label


@pytest.mark.parametrize("hw", [(1024, 2048), (500, 1000)], ids=["full frame", "under the box"])
def test_crop_black_area_matches_pil(hw):
    """Bit for bit Pillow's ``crop`` + ``resize`` on a Lost&Found-sized
    frame and on a frame smaller than the box (Pillow pads the crop with
    zeros); the resize of the box region straight from the frame
    (``box=``) would differ: its edge taps read pixels outside the box."""
    img, label = _box_image(hw, np.random.default_rng(hw[0]))
    got = CropBlackArea()({"left": img.copy(), "label": label.copy()})
    want = jt.CropBlackArea()({"left": Image.fromarray(img), "label": Image.fromarray(label)})
    _assert_same(got, want)
    if hw == (1024, 2048):
        shortcut = _resize_pil(img, (hw[1], hw[0]), "bilinear", box=CropBlackArea.BOX)
        assert shortcut.shape == got["left"].shape and not np.array_equal(shortcut, got["left"])
    else:
        assert (got["left"][:, -(hw[1] * 1000 // 1890 - 1):] == 0).all()   # zero padding


def test_lostfound_tables_match_jax():
    """``_encode_lostfound``, the clamped Cityscapes table, the 21-colour
    palette and ``decode_target`` on every id 0-255."""
    ids = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(citylostfound._encode_lostfound(ids),
                                  jax_clf._encode_lostfound(ids))
    np.testing.assert_array_equal(citylostfound.TRAIN_ID_TO_COLOR_CLF, jax_clf.TRAIN_ID_TO_COLOR_CLF)
    assert citylostfound.TRAIN_ID_TO_COLOR_CLF.dtype == np.uint8
    train_ids = np.array([list(range(20)) + [255] * 12], np.uint8)
    np.testing.assert_array_equal(citylostfound.LostFound.decode_target(train_ids),
                                  jax_clf.LostFound.decode_target(train_ids))
    np.testing.assert_array_equal(ACDC.encode_target(ids), jax_clf.CITYSCAPES_ID_TO_TRAIN_ID[
        np.minimum(ids, len(jax_clf.CITYSCAPES_ID_TO_TRAIN_ID) - 1)])
    assert citylostfound.LostFound.weather_dict == jax_clf.LostFound.weather_dict


@pytest.mark.parametrize("argv", [
    ["--dataset", "cityscapes"], ["--dataset", "acdc_city"],
    ["--dataset", "acdc_city", "--weather_num", "5"], ["--dataset", "city_lost"],
    ["--dataset", "city_lost", "--new_crop"], ["--dataset", "cityscapes", "--new_crop"],
    ["--dataset", "city_lost", "--not_md_fusion", "--data_root", "/d/city_lost"]])
def test_crop_wh_and_finalize_match_jax(argv):
    got, want = parse_args(argv), jax_parse_args(argv)
    assert got.crop_wh == want.crop_wh
    assert (got.num_classes, got.weather_num, got.not_md_fusion) == \
        (want.num_classes, want.weather_num, want.not_md_fusion)
    assert os.path.basename(got.data_root) == os.path.basename(want.data_root)
    if "--data_root" in argv:
        assert got.data_root == want.data_root


class _Reached(Exception):
    """The step got past every weather read."""


class _Outputs(dict):
    def __getitem__(self, key):
        raise _Reached(key)


class _OneBatch(list):
    def set_epoch(self, epoch):
        pass


def jax_refuses(jcfg, batch) -> bool:
    """Whether JAX's train epoch fails for want of ``weather``: its
    ``_train_epoch`` on one batch, with the JAX loss dispatch in place of
    the step (stopped at the first model output it reads)."""
    def step(state, db, rng):
        jax_combine.compute_total_loss(jcfg, _Outputs(), db, None, None)

    stub = types.SimpleNamespace(
        cfg=jcfg, cur_epochs=0, num_iter=0, state=None, _rng=jax.random.PRNGKey(0),
        train_loader=_OneBatch([batch]), writer=types.SimpleNamespace(add_scalar=lambda *a: None),
        _current_lr=lambda: 0.0, _device_batch=dict,
        _augment=None if jcfg.host_augment else (lambda *a: {}), _train_step=step)
    try:
        JaxTrainer._train_epoch(stub)
    except KeyError as e:
        assert e.args == ("weather",)
        return True
    except _Reached:
        return False
    raise AssertionError("JAX's epoch ended without reaching the model's outputs")


def port_refuses(cfg) -> bool:
    """Whether the port's ``Trainer.train`` refuses the run (before its
    epoch, which is stubbed)."""
    def epoch():
        raise _Reached()

    try:
        Trainer.train(types.SimpleNamespace(cfg=cfg, _train_epoch=epoch))
    except ValueError as e:
        assert "carry no 'weather'" in str(e) and cfg.dataset in str(e)
        return True
    except _Reached:
        return False
    raise AssertionError("the port's train ran no epoch")


@pytest.mark.parametrize("dataset", ["cityscapes", "city_lost", "acdc_city"])
def test_runs_without_weather_fail_in_both(tree, dataset, monkeypatch):
    """Every criterion, with the host crops and on-device augmentation: the
    port refuses the runs JAX's epoch fails on (``KeyError: 'weather'``,
    the three SupCon-by-weather criteria, and every criterion under
    ``--no_host_augment``), and only those; a batch of each dataset's val
    split stands in for the train batch."""
    monkeypatch.chdir(tree)
    refused = []
    for host in (True, False):
        for crit in CRITERIA:
            argv = ["--dataset", dataset, "--criterion", crit] + ([] if host else ["--no_host_augment"])
            cfg, jcfg = configs(tree, argv)
            val = jax_get_dataset(jcfg)[1]
            want = jax_refuses(jcfg, jax_loader.collate([val[0]]))
            assert port_refuses(cfg) == want, (crit, host)
            if want:
                refused.append((crit, host))
    if dataset == "acdc_city":
        assert refused == []
    else:
        assert sorted(refused) == sorted(
            [(c, True) for c in ("supcon_focal", "supcon_pixelcontrast_focal",
                                 "supcon_crossentropy")] + [(c, False) for c in CRITERIA])


@pytest.fixture
def restore_logging_and_signals():
    """The trainer resets the root logger and installs SIGTERM/SIGINT
    handlers; put the test process's back."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    sigs = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for h in list(root.handlers):
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    for h in handlers:
        if h not in root.handlers:
            root.addHandler(h)
    root.setLevel(level)
    for s, h in sigs.items():
        signal.signal(s, h)


@pytest.fixture(scope="module")
def small_tree(tmp_path_factory):
    """One train frame of each dataset: the crops are full size (768²,
    1024×512), so each image costs seconds of CPU a step."""
    return write_tree(tmp_path_factory.mktemp("city_tree_small"), np.random.default_rng(17), 1)


@pytest.mark.parametrize("argv", [
    ["--dataset", "cityscapes", "--criterion", "pixelcontrast_focal", "--batch_size", "1"],
    ["--dataset", "acdc_city", "--weather_num", "5", "--criterion", "pixelcontrast_focal",
     "--batch_size", "2"],
    ["--dataset", "city_lost", "--new_crop", "--not_md_fusion", "--criterion", "plain_focal",
     "--batch_size", "1"],
], ids=["cityscapes", "acdc_city", "city_lost"])
def test_main_runs_an_epoch(small_tree, argv, tmp_path, restore_logging_and_signals):
    """``main`` on the CPU (the single-scale SwiftNet: the lightest on this
    CPU at the datasets' full crops): an epoch of one step and a
    validation, which writes ``val_results.txt``; for ``acdc_city`` its
    five weather sections are JAX ``Evaluator``'s on the same confusion
    matrices."""
    tree = small_tree
    cfg, _ = configs(tree, argv)
    tr = port_main(argv + ["--train_semantic", "--data_root", str(tree),
                           "--filelist_root", str(tree / "filenames"), "--val_img_width", "56",
                           "--val_img_height", "32", "--device", "cpu", "--compute_dtype",
                           "float32", "--model", "resnet18_single", "--num_workers", "1",
                           "--epochs", "1", "--no_build_summary", "--run_root", str(tmp_path),
                           "--print_freq", "1"])
    assert tr.num_iter == len(tr.train_loader) == 1
    path = os.path.join(tr.saver.experiment_dir, "val_results.txt")
    with open(path) as f:
        text = f.read()
    assert "epoch 0: mIoU" in text
    if cfg.dataset == "acdc_city":
        ev = tr.evaluator
        jev = JaxEvaluator(cfg.num_classes, cfg.weather_num)
        jev.confusion_matrix_sem_weather = ev.confusion_matrix_sem_weather.copy()
        jpath = str(tmp_path / "jax_results.txt")
        want = jev.Mean_Intersection_over_Union_each_weather(jpath)
        assert list(want) == ["0", "1", "2", "3", "4"]
        got = ev.Mean_Intersection_over_Union_each_weather(str(tmp_path / "port_results.txt"))
        assert list(got) == list(want)
        np.testing.assert_array_equal([got[k] for k in got], [want[k] for k in want])
        with open(jpath) as f:
            sections = f.read()
        assert sections in text and "mIoU in sunny" in sections
        assert ev.confusion_matrix_sem_weather[4].sum() > 0      # the Cityscapes frames
