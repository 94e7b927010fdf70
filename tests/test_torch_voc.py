"""The port's image reader (``data/images.py::read_image``) and PASCAL VOC
dataset (``data/voc.py``) vs the JAX package's, on a small VOCdevkit
tree of JPEG frames and palette PNG masks written with PIL.

No tolerance: ``read_image`` gives PIL's pixels for JPEG (colour and
grey) and ``read_png``'s for PNG; ``VOCSegmentation``'s samples (frame,
mask indices, names) and ``decode_target`` are JAX's bit for bit.
"""

import builtins
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from PIL import Image  # noqa: E402

from doubly_contrastive_semseg_tpu.data import voc as jax_voc  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data import (Compose, FixedResize, ToArrays,  # noqa: E402
                                                      VOCSegmentation, read_image, read_png,
                                                      write_png)
from doubly_contrastive_semseg_tpu_torch.data import voc  # noqa: E402

from test_torch_transforms import _assert_same  # noqa: E402

HW = (45, 61)
NAMES = ("2007_000032", "2007_000039", "2007_000063")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def write_voc(root, rng):
    voc_dir = root / "VOC2012"
    for sub in ("ImageSets/Segmentation", "JPEGImages", "SegmentationClass"):
        os.makedirs(voc_dir / sub)
    palette = np.zeros((256, 3), np.uint8)
    palette[:21] = jax_voc.VOC_COLORMAP
    palette[255] = (224, 224, 192)
    for i, name in enumerate(NAMES):
        img = rng.integers(0, 256, HW + (3,)).astype(np.uint8)
        img[10:30, 5:50] = (20, 160, 90)
        frame = Image.fromarray(img) if i != 1 else Image.fromarray(img).convert("L")
        frame.save(voc_dir / "JPEGImages" / f"{name}.jpg", quality=90)
        idx = rng.integers(0, 21, HW).astype(np.uint8)
        idx[:3] = 255                                      # the boundary band
        mask = Image.fromarray(idx, "P")
        mask.putpalette(palette.ravel().tolist())
        mask.save(voc_dir / "SegmentationClass" / f"{name}.png")
    (voc_dir / "ImageSets" / "Segmentation" / "train.txt").write_text("\n".join(NAMES[:2]) + "\n")
    (voc_dir / "ImageSets" / "Segmentation" / "val.txt").write_text(NAMES[2] + "\n")
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_voc(tmp_path_factory.mktemp("voc"), np.random.default_rng(3))


@pytest.mark.parametrize("image_set", ["train", "val", "missing"])
def test_voc_samples_match_jax(root, image_set):
    got = VOCSegmentation(str(root), image_set=image_set)
    want = jax_voc.VOCSegmentation(str(root), image_set=image_set)
    assert (got.images, got.masks) == (want.images, want.masks)
    assert len(got) == {"train": 2, "val": 1, "missing": 0}[image_set]
    for i in range(len(want)):
        g, w = got[i], want[i]
        _assert_same(g, w)
        assert g["left"].shape == HW + (3,) and g["label"].shape == HW
        assert g["label"].max() == 255
    if image_set == "train":
        t = Compose([FixedResize((40, 24)), ToArrays()])
        s = VOCSegmentation(str(root), image_set="train", transform=t)[1]
        assert s["left"].shape == (24, 40, 3) and s["label"].dtype == np.uint8


def test_voc_tables_match_jax():
    np.testing.assert_array_equal(voc.VOC_COLORMAP, jax_voc.VOC_COLORMAP)
    t = np.array([list(range(21)) + [255]], np.uint8)
    np.testing.assert_array_equal(VOCSegmentation.decode_target(t),
                                  jax_voc.VOCSegmentation.decode_target(t))
    assert (VOCSegmentation.num_classes, VOCSegmentation.ignore_index) == (21, 255)


def test_read_image_is_pil_for_jpeg_and_read_png_for_png(root, tmp_path):
    jpg = root / "VOC2012" / "JPEGImages" / f"{NAMES[1]}.jpg"          # a grey JPEG
    np.testing.assert_array_equal(read_image(jpg), np.asarray(Image.open(jpg).convert("RGB")))
    np.testing.assert_array_equal(read_image(jpg, mode=None), np.asarray(Image.open(jpg)))
    assert read_image(jpg, mode=None).shape == HW
    png = root / "VOC2012" / "SegmentationClass" / f"{NAMES[0]}.png"
    np.testing.assert_array_equal(read_image(png, mode=None), read_png(png))
    np.testing.assert_array_equal(read_image(png), np.asarray(Image.open(png).convert("RGB")))
    upper = tmp_path / "FRAME.PNG"
    write_png(upper, np.full((4, 5, 3), 9, np.uint8))
    assert read_image(str(upper)).shape == (4, 5, 3)
    bad = tmp_path / "notes.jpeg"
    bad.write_text("not an image")
    with pytest.raises(ValueError, match="notes.jpeg: PIL cannot identify"):
        read_image(bad)


def test_read_image_names_pil_when_it_does_not_import(root, monkeypatch):
    real = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    png = root / "VOC2012" / "SegmentationClass" / f"{NAMES[0]}.png"
    assert read_image(png, mode=None).shape == HW                    # PNG needs no PIL
    jpg = root / "VOC2012" / "JPEGImages" / f"{NAMES[0]}.jpg"
    with pytest.raises(ImportError, match=f"{NAMES[0]}.jpg: .*needs PIL"):
        read_image(jpg)


def test_importing_the_port_loads_no_pil():
    """PIL is imported only inside the calls that need it: a fresh
    interpreter that imports every module of the port has not loaded it."""
    code = ("import importlib, pkgutil, sys\n"
            "import doubly_contrastive_semseg_tpu_torch as p\n"
            "for i in pkgutil.walk_packages(p.__path__, prefix=p.__name__ + '.'):\n"
            "    importlib.import_module(i.name)\n"
            "print(sorted(m for m in sys.modules if m == 'PIL' or m.startswith('PIL.')))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
