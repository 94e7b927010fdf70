"""The port's host data path (``data/``) vs the JAX package's.

Synthetic samples, the loader's batches, the class weights and the two
datasets of ``get_dataset("synthetic")`` are held to JAX's byte for byte
(the weights to 1e-7: both are float32 of the same float64 frequencies).
``FixedResize`` is a numpy copy of Pillow's resampling, held to PIL itself
(the CPU tests import it; the port never does): bilinear images and nearest
labels exactly equal at a downscale, an upscale, mixed and the same size.
"""

import gc
import os
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from PIL import Image  # noqa: E402

from doubly_contrastive_semseg_tpu.config import parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu.data import acdc as jax_acdc  # noqa: E402
from doubly_contrastive_semseg_tpu.data import labels as jax_labels  # noqa: E402
from doubly_contrastive_semseg_tpu.data import loader as jax_loader  # noqa: E402
from doubly_contrastive_semseg_tpu.data import weights as jax_weights  # noqa: E402
from doubly_contrastive_semseg_tpu.data.factory import build_transforms as jax_build_transforms  # noqa: E402
from doubly_contrastive_semseg_tpu.data.factory import get_dataset as jax_get_dataset  # noqa: E402
from doubly_contrastive_semseg_tpu.data.synthetic import SyntheticDataset as JaxSynthetic  # noqa: E402
from doubly_contrastive_semseg_tpu.data.transforms import Compose as JaxCompose  # noqa: E402
from doubly_contrastive_semseg_tpu.data.transforms import FixedResize as JaxFixedResize  # noqa: E402
from doubly_contrastive_semseg_tpu.data.transforms import SetTargetSize as JaxSetTargetSize  # noqa: E402
from doubly_contrastive_semseg_tpu.data.transforms import ToArrays as JaxToArrays  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import Config  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data import (  # noqa: E402
    Compose, DataLoader, FixedResize, SetTargetSize, SyntheticDataset, ThreadSafeRng, ToArrays,
    build_transforms, collate, get_dataset, labels, to_device, weights)
from doubly_contrastive_semseg_tpu_torch.data.transforms import (  # noqa: E402
    resize_bilinear_pil, resize_nearest_pil)

HW = (64, 80)


def assert_same_sample(got, want, what=""):
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, (what, k)
            assert g.tobytes() == w.tobytes(), (what, k)
        else:
            assert g == w, (what, k)


def port_transform(mode, hw=HW):
    return Compose([ToArrays()]) if mode == "train" else \
        Compose([FixedResize((hw[1], hw[0])), ToArrays()])


def jax_transform(mode, hw=HW):
    return JaxCompose([JaxToArrays()]) if mode == "train" else \
        JaxCompose([JaxFixedResize((hw[1], hw[0])), JaxToArrays()])


@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("seed,hw", [(0, HW), (7, (48, 40)), (1, (33, 51))])
def test_synthetic_samples_byte_for_byte(mode, seed, hw):
    port = SyntheticDataset(size=70, image_hw=hw, transform=port_transform(mode, hw),
                            seed=seed, mode=mode)
    ref = JaxSynthetic(size=70, image_hw=hw, transform=jax_transform(mode, hw),
                       seed=seed, mode=mode)
    for i in (0, 1, 5, 63, 64, 69):   # 64 and 69 reuse frames 0 and 5
        got, want = port[i], ref[i]
        assert got["left"].dtype == np.uint8 and got["label"].dtype == np.uint8
        assert got["weather"].dtype == np.int32 and got["weather"].shape == ()
        assert_same_sample(got, want, f"{mode} seed {seed} index {i}")


def test_synthetic_without_transform_and_decode_target():
    port, ref = SyntheticDataset(size=4, image_hw=HW, seed=3), JaxSynthetic(size=4, image_hw=HW, seed=3)
    got, want = port[2], ref[2]
    assert np.array_equal(got["left"], np.asarray(want["left"]))
    assert np.array_equal(got["label"], np.asarray(want["label"]))
    np.testing.assert_array_equal(got["weather"], want["weather"])
    assert not got["left"].flags.writeable          # the shared frame cache
    np.testing.assert_array_equal(SyntheticDataset.decode_target(got["label"]),
                                  JaxSynthetic.decode_target(np.asarray(want["label"])))


def test_label_tables_match_jax():
    np.testing.assert_array_equal(labels.TRAIN_ID_TO_COLOR, jax_acdc.TRAIN_ID_TO_COLOR)
    assert labels.TRAIN_ID_TO_COLOR.dtype == jax_acdc.TRAIN_ID_TO_COLOR.dtype == np.uint8
    np.testing.assert_array_equal(labels.TRAIN_ID_TO_COLOR, jax_labels.TRAIN_ID_TO_COLOR)
    assert labels.WEATHER_DICT == jax_acdc.WEATHER_DICT
    assert labels.CLASSES == jax_labels.CLASSES
    np.testing.assert_array_equal(labels.ID_TO_TRAIN_ID, jax_labels.ID_TO_TRAIN_ID)
    assert labels.TRAIN_ID_TO_NAME == jax_labels.TRAIN_ID_TO_NAME
    ids = np.array([[0, 7, 26, 33, -1]])
    np.testing.assert_array_equal(labels.encode_target(ids), jax_labels.encode_target(ids))
    t = np.array([[0, 5, 18, 255]])
    np.testing.assert_array_equal(labels.decode_target(t), jax_labels.decode_target(t))


def _pil_resize(arr, size, resample):
    return np.asarray(Image.fromarray(arr).resize(size, resample))


@pytest.mark.parametrize("src,size", [((64, 80), (37, 29)),     # downscale (w, h)
                                      ((37, 51), (160, 90)),    # upscale
                                      ((48, 40), (60, 31)),     # mixed
                                      ((64, 80), (80, 64)),     # the same size
                                      ((108, 192), (64, 36))])  # 3x down, the val ratio
def test_fixed_resize_matches_pil(rng, src, size):
    """Bilinear images and nearest labels exactly PIL's (measured: 0 levels
    off at every pixel)."""
    img = rng.integers(0, 256, src + (3,)).astype(np.uint8)
    lbl = rng.integers(0, 20, src).astype(np.uint8)
    out = FixedResize(size)({"left": img.copy(), "label": lbl.copy()})
    np.testing.assert_array_equal(out["left"], _pil_resize(img, size, Image.BILINEAR))
    np.testing.assert_array_equal(out["label"], _pil_resize(lbl, size, Image.NEAREST))
    np.testing.assert_array_equal(resize_bilinear_pil(img[..., 0], size),
                                  _pil_resize(img[..., 0], size, Image.BILINEAR))
    np.testing.assert_array_equal(resize_nearest_pil(img, size), _pil_resize(img, size, Image.NEAREST))
    assert out["left"].shape == (size[1], size[0], 3) and out["left"].dtype == np.uint8


def test_fixed_resize_matches_jax_transform(rng):
    """The port's FixedResize on arrays against JAX's on PIL images."""
    img = rng.integers(0, 256, (50, 70, 3)).astype(np.uint8)
    lbl = rng.integers(0, 19, (50, 70)).astype(np.uint8)
    got = Compose([FixedResize((33, 21)), ToArrays()])({"left": img, "label": lbl})
    want = JaxCompose([JaxFixedResize((33, 21)), JaxToArrays()])(
        {"left": Image.fromarray(img), "label": Image.fromarray(lbl)})
    assert_same_sample(got, want)


def _batches(loader_cls, dataset, epoch, **kw):
    loader = loader_cls(dataset, **kw)
    loader.set_epoch(epoch)
    return list(loader)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_batches_match_jax(shuffle, drop_last):
    port = SyntheticDataset(size=11, image_hw=HW, transform=port_transform("train"), seed=2)
    ref = JaxSynthetic(size=11, image_hw=HW, transform=jax_transform("train"), seed=2)
    kw = dict(batch_size=4, shuffle=shuffle, num_workers=3, drop_last=drop_last, seed=5)
    for epoch in (0, 3):
        got = _batches(DataLoader, port, epoch, **kw)
        want = _batches(jax_loader.DataLoader, ref, epoch, **kw)
        assert len(got) == len(want) == (2 if drop_last else 3)
        assert len(DataLoader(port, **kw)) == len(got)
        for g, w in zip(got, want):
            assert_same_sample(g, w, f"epoch {epoch}")
        names = [n for b in got for n in b["left_name"]]
        assert (names != sorted(names, key=lambda s: int(s.split("/")[1][:-4]))) == shuffle
    assert got[-1]["left"].shape[0] == (4 if drop_last else 3)


def test_collate_two_crop_matches_jax(rng):
    """Two-view samples: both views' images in one (2B, ...) array, the
    rest from view 0."""
    def view(i, v):
        return {"left": rng.integers(0, 256, (8, 10, 3)).astype(np.uint8),
                "label": np.full((8, 10), i + v, np.uint8),
                "label_distance_weight": rng.random((8, 10)).astype(np.float32),
                "weather": np.int32(i % 4), "left_name": f"n{i}"}
    samples = [[view(i, 0), view(i, 1)] for i in range(3)]
    got, want = collate(samples), jax_loader.collate(samples)
    assert_same_sample(got, want)
    assert got["left"].shape == (6, 8, 10, 3)
    np.testing.assert_array_equal(got["left"][3], samples[0][1]["left"])
    np.testing.assert_array_equal(got["label"][:, 0, 0], [0, 1, 2])


def test_abandoned_iterator_shuts_down_producer():
    class Tiny:
        def __len__(self):
            return 64

        def __getitem__(self, i):
            return {"left": np.zeros((4, 4, 3), np.uint8), "label": np.zeros((4, 4), np.uint8)}

    before = threading.active_count()
    it = iter(DataLoader(Tiny(), batch_size=2, num_workers=2, prefetch=2))
    next(it)
    it.close()
    del it
    gc.collect()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "producer thread leaked"


def test_loader_surfaces_worker_errors():
    class Broken:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 4:
                raise KeyError("sample 4")
            return {"left": np.zeros((2, 2, 3), np.uint8)}

    with pytest.raises(KeyError, match="sample 4"):
        list(DataLoader(Broken(), batch_size=2, num_workers=2))


def test_class_weights_match_jax(tmp_path):
    port = SyntheticDataset(size=6, image_hw=HW, transform=port_transform("train"), seed=4)
    ref = JaxSynthetic(size=6, image_hw=HW, transform=jax_transform("train"), seed=4)
    f_got = weights.compute_class_frequencies(port, 19)
    f_want = jax_weights.compute_class_frequencies(ref, 19)
    np.testing.assert_array_equal(f_got, f_want)
    np.testing.assert_allclose(weights.balanced_class_weights(f_got, 0.1),
                               jax_weights.balanced_class_weights(f_want, 0.1), rtol=0, atol=1e-7)

    class TwoViews:   # a TwoCropTransform dataset: both views' labels count
        def __init__(self, d):
            self.d = d

        def __len__(self):
            return len(self.d)

        def __getitem__(self, i):
            s = self.d[i]
            flipped = dict(s, label=s["label"][:, ::-1].copy())
            return [s, flipped]
    np.testing.assert_array_equal(weights.compute_class_frequencies(TwoViews(port), 19),
                                  jax_weights.compute_class_frequencies(TwoViews(ref), 19))

    cfg = Config(dataset="cityscapes", data_root=str(tmp_path / "city"))
    w_first = weights.load_or_compute_class_weights(cfg, port)          # computes, caches
    assert (tmp_path / "city" / "cityscapes_classes_weights_19_new_raw.npy").is_file()
    w_cached = weights.load_or_compute_class_weights(cfg, None)         # reads the cache
    np.testing.assert_array_equal(w_first, w_cached)
    np.testing.assert_allclose(w_first, jax_weights.balanced_class_weights(f_want, 0.1),
                               rtol=0, atol=1e-7)


def _jax_cfg(**kw):
    argv = ["--dataset", "synthetic", "--synthetic_hw", "64x80", "--synthetic_size", "10"]
    for k, v in kw.items():
        argv += [f"--{k}"] if v is True else [f"--no_{k}"] if v is False else [f"--{k}", str(v)]
    return parse_args(argv)


def test_get_dataset_synthetic_matches_jax():
    jcfg = _jax_cfg(host_augment=False)
    cfg = Config(dataset="synthetic", synthetic_hw="64x80", synthetic_size=10, host_augment=False)
    assert cfg.crop_wh == jcfg.crop_wh == (96, 96) and cfg.val_wh == jcfg.val_wh
    assert Config(dataset="synthetic", synthetic_hw="1024x2048").crop_wh == (768, 768)
    for got_dst, want_dst in zip(get_dataset(cfg, seed=3), jax_get_dataset(jcfg, seed=3)):
        assert len(got_dst) == len(want_dst) and got_dst.seed == want_dst.seed
        for i in range(len(want_dst)):
            assert_same_sample(got_dst[i], want_dst[i], f"{want_dst.mode} {i}")
    cfg_debug = Config(dataset="synthetic", synthetic_hw="64x80", debug=True, host_augment=False)
    assert [len(d) for d in get_dataset(cfg_debug)] == [8, 2]


def test_get_dataset_raises_for_routes_not_ported(tmp_path):
    """The stereo lists load through ``Cityscapes`` with their disparity
    (JAX's ``get_dataset``: the semantic pipelines, which ``main`` never
    gives them), on either augmentation route; an unknown name raises."""
    from doubly_contrastive_semseg_tpu_torch.data import write_png
    from doubly_contrastive_semseg_tpu_torch.data.cityscapes import LIST_FILES

    frame = np.random.default_rng(5).integers(0, 256, (24, 40, 3)).astype(np.uint8)
    write_png(tmp_path / "l.png", frame)
    write_png(tmp_path / "r.png", np.ascontiguousarray(frame[:, ::-1]))
    write_png(tmp_path / "d.png", np.full((24, 40), 5 * 256, np.uint16))
    for name in ("kitti_2015", "kitti_mix", "sceneflow"):
        for mode in ("train", "val"):
            path = tmp_path / "lists" / LIST_FILES[name].format(mode=mode)
            os.makedirs(path.parent, exist_ok=True)
            path.write_text("l.png r.png d.png\n")
        for host_augment in (True, False):
            cfg = Config(dataset=name, host_augment=host_augment, data_root=str(tmp_path),
                         filelist_root=str(tmp_path / "lists"), val_img_width=40,
                         val_img_height=24)
            train, val = get_dataset(cfg)
            assert train.load_disp and train.dataset_name == name and len(train) == 1
            sample = val[0]
            assert sample["disp"].dtype == np.float32 and (sample["disp"] == 5.0).all()
            assert sample["right"].shape == sample["left"].shape == (24, 40, 3)
    with pytest.raises(ValueError, match="unknown dataset"):
        get_dataset(Config(dataset="nowhere", host_augment=False))


def test_to_device_on_the_cpu():
    port = SyntheticDataset(size=4, image_hw=HW, transform=port_transform("train"), seed=1)
    batch = next(iter(DataLoader(port, batch_size=4, num_workers=1)))
    db = to_device(batch, "cpu", class_weight=np.ones(19, np.float32))
    assert db["left"].dtype == torch.uint8 and tuple(db["left"].shape) == (4,) + HW + (3,)
    assert db["label"].dtype == torch.uint8 and db["weather"].dtype == torch.int32
    assert db["class_weight"].dtype == torch.float32 and tuple(db["class_weight"].shape) == (19,)
    assert db["left_name"] == batch["left_name"] and isinstance(db["frame_name"], list)
    np.testing.assert_array_equal(db["left"].numpy(), batch["left"])


def test_build_transforms_matches_jax(rng):
    """With ``host_augment=False`` the train transform only converts and
    the val transform resizes to the val size, as JAX's; with
    ``host_augment=True`` (and gamma) both are JAX's host pipelines: the
    two views of the same seed and the val sample of a night frame."""
    from test_torch_transforms import FixedPointCv2

    img = rng.integers(0, 256, (54, 96, 3)).astype(np.uint8)
    lbl = rng.integers(0, 19, (54, 96)).astype(np.uint8)
    cfg = Config(dataset="acdc", host_augment=False, val_img_width=64, val_img_height=36)
    jcfg = parse_args(["--dataset", "acdc", "--no_host_augment", "--val_img_width", "64",
                       "--val_img_height", "36"])
    for got_t, want_t in zip(build_transforms(cfg, cfg.crop_wh, seed=0),
                             jax_build_transforms(jcfg, jcfg.crop_wh, seed=0)):
        got = got_t({"left": img, "label": lbl, "weather": np.array([1])})
        want = want_t({"left": Image.fromarray(img), "label": Image.fromarray(lbl),
                       "weather": np.array([1])})
        assert_same_sample(got, want)
    cfg = Config(dataset="acdc", criterion="supcon_pixelcontrast_focal", use_gamma_correction=True,
                 val_img_width=64, val_img_height=36)
    jcfg = parse_args(["--dataset", "acdc", "--criterion", "supcon_pixelcontrast_focal",
                       "--use_gamma_correction", "--val_img_width", "64", "--val_img_height", "36"])
    for got_t, want_t in zip(build_transforms(cfg, (48, 48), seed=5),
                             jax_build_transforms(jcfg, (48, 48), seed=5)):
        got = got_t({"left": img, "label": lbl, "weather": np.array([1])})
        want = FixedPointCv2(want_t)({"left": Image.fromarray(img), "label": Image.fromarray(lbl),
                                      "weather": np.array([1])})
        for g, w in (zip(got, want) if isinstance(want, list) else [(got, want)]):
            assert_same_sample(g, w)


def test_set_target_size_matches_jax():
    got = SetTargetSize((96, 64), (24, 16))({"left": None})
    want = JaxSetTargetSize((96, 64), (24, 16))({"left": None})
    assert got == want and got["target_size"] == (64, 96)


def test_thread_safe_rng_concurrent_draws():
    """Four threads drawing from one wrapped generator get, together, the
    values one thread would get from the same seed: no draw lost or
    repeated."""
    shared = ThreadSafeRng(np.random.default_rng(11))
    out = [[] for _ in range(4)]

    def draw(k):
        for _ in range(500):
            out[k].append(float(shared.random()))

    threads = [threading.Thread(target=draw, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    want = np.random.default_rng(11).random(2000)
    np.testing.assert_array_equal(np.sort(np.concatenate(out)), np.sort(want))
