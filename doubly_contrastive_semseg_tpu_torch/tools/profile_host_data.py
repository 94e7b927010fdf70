"""The host side of the default training input path, timed on this machine's
CPU: PNG decoding, the crop-and-scale and the chamfer EDT weights.

    python3 -m doubly_contrastive_semseg_tpu_torch.tools.profile_host_data

Needs no card and no PIL or cv2. Writes 1080×1920 frames (ACDC's size)
with ``data/png.py::write_png``, one for each PNG filter, one with the
five filters in turns down its rows and one with Pillow's choice a row,
plus a grey labelIds map (Pillow's choice a row), into a temporary
directory, then times ``read_png`` on each (median of 3), the
host train transforms on a synthetic 1080×1920 frame (``RandomSquareCropAndScale``
at box scales 0.5, 1 and 2 of the 768² crop, ``label_chamfer_distance`` and
``LabelBoundaryTransform`` on a 768² crop) and prints one JSON object with
the CPU's name. ``chip_smoke.py`` phase 14 calls ``time_decode`` and
``time_transforms``; phase 16 writes its ACDC tree with ``write_acdc_tree``,
phase 20 its Cityscapes and Lost&Found trees with ``write_cityscapes_tree``
and ``write_lostfound_tree``.
"""

from __future__ import annotations

import json
import os
import platform
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

from ..data.acdc import ACDC
from ..data.chamfer import label_chamfer_distance
from ..data.labels import CLASSES
from ..data.png import read_png, write_png
from ..data.synthetic import SyntheticDataset
from ..data.transforms import CropBlackArea, LabelBoundaryTransform, RandomSquareCropAndScale

ACDC_HW = (1080, 1920)
CITY_HW = (1024, 2048)                  # Cityscapes' and Lost&Found's frames
CROP = 768
FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4,
           "mixed": [0, 1, 2, 3, 4] * (ACDC_HW[0] // 5), "adaptive": "adaptive"}
WEATHERS = ("fog", "night", "rain", "snow")
# train id → the first Cityscapes label id with it (ignore → 0, "unlabeled")
TRAIN_ID_TO_LABEL_ID = np.zeros(256, np.uint8)
for _c in reversed(CLASSES):
    if _c.id >= 0 and _c.train_id != 255:
        TRAIN_ID_TO_LABEL_ID[_c.train_id] = _c.id


def cpu_name() -> str:
    """The CPU's model name (``/proc/cpuinfo``, else ``lscpu``), its
    architecture and the CPUs this process may use."""
    name = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if name is None:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=10).stdout
            name = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                         if ln.lower().startswith("model name")), None)
        except (OSError, subprocess.SubprocessError):
            pass
    return f"{name or 'model not reported'} ({platform.machine()}), " \
        f"{len(os.sched_getaffinity(0))} CPUs"


def acdc_frame(index: int, hw=ACDC_HW) -> Tuple[np.ndarray, np.ndarray]:
    """A synthetic frame and its labelIds map (uint8, Cityscapes ids) whose
    ``ACDC.encode_target`` is the synthetic dataset's train-id label."""
    img, label = SyntheticDataset(size=index + 1, image_hw=hw)._frame(index)
    return img, TRAIN_ID_TO_LABEL_ID[label]


def write_acdc_tree(base: str, n_train: int, n_val: int, hw=ACDC_HW) -> Tuple[str, str]:
    """An ACDC-layout tree under ``base``: frames ``rgb_anon_trainvaltest/
    rgb_anon/<weather>/<split>/...`` and labelIds ``gt_trainval/...``,
    weathers fog, night, rain, snow in turns, and the lists
    ``filenames/acdc/acdc_{train,val}.txt``. Returns (data_root,
    filelist_root).

    Every frame has the five PNG filters in turns down its rows: which
    filters the real files use is not known, and an encoder that chooses a
    filter a row (Pillow, libpng) leaves Average or Paeth rows in a photo,
    which send a frame through ``read_png``'s diagonal walk, as these rows
    do. On these synthetic frames Pillow's own choice would take only
    cheap filters, so it is kept for the labelIds maps."""
    root = os.path.join(base, "acdc")
    jobs: List = []
    lists: Dict[str, List[str]] = {"train": [], "val": []}
    for split, n, offset in (("train", n_train, 0), ("val", n_val, n_train)):
        for k in range(n):
            i = offset + k
            weather = WEATHERS[i % 4]
            stem = f"{weather}/{split}/GOPR{i:04d}/GOPR{i:04d}_frame_{i:06d}"
            rgb = f"rgb_anon_trainvaltest/rgb_anon/{stem}_rgb_anon.png"
            gt = f"gt_trainval/gt/{stem}_gt_labelIds.png"
            lists[split].append(f"{rgb} {weather} {gt}")
            jobs.append((i, os.path.join(root, rgb), os.path.join(root, gt)))

    def write(job) -> None:
        i, rgb, gt = job
        img, ids = acdc_frame(i, hw)
        for path in (rgb, gt):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        write_png(rgb, img, FILTERS["mixed"][:hw[0]])
        write_png(gt, ids, "adaptive")

    with ThreadPoolExecutor(4) as pool:          # zlib releases the GIL
        list(pool.map(write, jobs))
    lists_root = os.path.join(base, "filenames")
    os.makedirs(os.path.join(lists_root, "acdc"), exist_ok=True)
    for split, lines in lists.items():
        with open(os.path.join(lists_root, "acdc", f"acdc_{split}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root, lists_root


def check_acdc_tree(root: str, lists_root: str, hw=ACDC_HW) -> int:
    """Every frame and label of the tree read back by ``ACDC`` (no
    transform) equals what ``write_acdc_tree`` wrote: the frame, and the
    synthetic train ids. Returns the number of samples checked."""
    n = 0
    for split in ("train", "val"):
        ds = ACDC(root, mode=split, filelist_root=lists_root)
        for k, rec in enumerate(ds.samples):
            i = int(os.path.basename(rec["left"]).split("_")[2])
            img, ids = acdc_frame(i, hw)
            s = ds[k]
            if not (np.array_equal(s["left"], img)
                    and np.array_equal(s["label"], ACDC.encode_target(ids))
                    and int(s["weather"][0]) == i % 4):
                raise RuntimeError(f"ACDC sample {rec['left']} does not read back as written")
            n += 1
    return n


def city_frame(index: int, hw=CITY_HW) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A synthetic Cityscapes sample: left frame, right frame (the left
    shifted by 24 columns) and labelIds, with a patch of ids past 33
    (which clamp to the ignore id)."""
    img, ids = acdc_frame(index, hw)
    ids[: hw[0] // 16, : hw[1] // 16] = 255
    return img, np.roll(img, -24, axis=1), ids


def lostfound_frame(index: int, hw=CITY_HW) -> Tuple[np.ndarray, np.ndarray]:
    """A synthetic Lost&Found frame and its gtCoarse labelIds: 1 (road)
    where the synthetic frame has road, obstacle ids 2 + (train id − 11)
    on its person-to-bicycle classes, 0 elsewhere, and black, id 0,
    outside ``CropBlackArea``'s box (its rectification border)."""
    img, label = SyntheticDataset(size=index + 1, image_hw=hw)._frame(index)
    img, ids = img.copy(), np.zeros(hw, np.uint8)
    ids[label == 0] = 1
    obstacle = (label >= 11) & (label <= 18)
    ids[obstacle] = 2 + label[obstacle] - 11
    x0, y0, x1, y1 = CropBlackArea.BOX
    border = np.ones(hw, bool)
    border[y0:y1, x0:x1] = False
    img[border], ids[border] = 0, 0
    return img, ids


def _write_tree(base: str, sub: str, jobs, lists: Dict[str, List[str]]) -> str:
    """Writes ``jobs`` ((path under ``<base>/<sub>``, array, filter), ...)
    four at a time, and the lists as ``<base>/filenames/<name>.txt``;
    returns the lists' root."""
    def write(job) -> None:
        rel, arr, filt = job
        path = os.path.join(base, sub, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_png(path, arr, filt)

    with ThreadPoolExecutor(4) as pool:          # zlib releases the GIL
        list(pool.map(write, jobs))
    lists_root = os.path.join(base, "filenames")
    for name, lines in lists.items():
        os.makedirs(os.path.dirname(os.path.join(lists_root, name)), exist_ok=True)
        with open(os.path.join(lists_root, name + ".txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return lists_root


def write_cityscapes_tree(base: str, n_train: int, n_val: int, hw=CITY_HW) -> str:
    """A Cityscapes-layout tree under ``<base>/cityscapes``:
    ``leftImg8bit``, ``rightImg8bit`` and ``gtFine`` labelIds of
    ``city_frame`` (frames with the five PNG filters in turns down their
    rows, labels with Pillow's choice), and the lists
    ``<base>/filenames/cityscapes/cityscapes_semantic_{train,val}.txt``
    (``left right disparity labelIds``; no disparity file is written).
    Returns the lists' root."""
    jobs, lists = [], {}
    for split, n, offset in (("train", n_train, 100), ("val", n_val, 100 + n_train)):
        for k in range(n):
            i = offset + k
            stem = f"{split}/aachen/aachen_{i:06d}_000019"
            left, right = f"leftImg8bit/{stem}_leftImg8bit.png", f"rightImg8bit/{stem}_rightImg8bit.png"
            gt = f"gtFine/{stem}_gtFine_labelIds.png"
            img, img_r, ids = city_frame(i, hw)
            rows = ([0, 1, 2, 3, 4] * (hw[0] // 5 + 1))[:hw[0]]
            jobs += [(left, img, rows), (right, img_r, rows), (gt, ids, "adaptive")]
            lists.setdefault(f"cityscapes/cityscapes_semantic_{split}", []).append(
                f"{left} {right} disparity/{stem}_disparity.png {gt}")
    return _write_tree(base, "cityscapes", jobs, lists)


def write_lostfound_tree(base: str, n_train: int, n_val: int, hw=CITY_HW) -> str:
    """A Lost&Found-layout tree under ``<base>/city_lost``: ``leftImg8bit``
    frames and ``gtCoarse`` labelIds of ``lostfound_frame``, and the lists
    ``<base>/filenames/city_lost/lostfound_{train,val}.txt`` (``left right
    disparity labelIds``). Returns the lists' root."""
    jobs, lists = [], {}
    for split, n, offset in (("train", n_train, 200), ("val", n_val, 200 + n_train)):
        for k in range(n):
            i = offset + k
            stem = f"{split}/04_Maurener_Weg_8/04_Maurener_Weg_8_{i:06d}_{i:06d}"
            left, gt = f"leftImg8bit/{stem}_leftImg8bit.png", f"gtCoarse/{stem}_gtCoarse_labelIds.png"
            img, ids = lostfound_frame(i, hw)
            rows = ([0, 1, 2, 3, 4] * (hw[0] // 5 + 1))[:hw[0]]
            jobs += [(left, img, rows), (gt, ids, "adaptive")]
            lists.setdefault(f"city_lost/lostfound_{split}", []).append(
                f"{left} rightImg8bit/{stem}_rightImg8bit.png disparity/{stem}_disparity.png {gt}")
    return _write_tree(base, "city_lost", jobs, lists)


def _median_ms(fn, repeats: int = 3) -> float:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def time_decode(base: str, hw=ACDC_HW) -> Dict[str, float]:
    """``read_png`` ms of one frame written with each filter, the five in
    turns and Pillow's choice (RGB, mode "RGB"), and of the labelIds map
    (grey, Pillow's choice)."""
    img, ids = acdc_frame(0, hw)
    out: Dict[str, float] = {}
    for name, filt in FILTERS.items():
        path = os.path.join(base, f"frame_{name}.png")
        write_png(path, img, filt[:hw[0]] if isinstance(filt, list) else filt)
        if not np.array_equal(read_png(path, mode="RGB"), img):
            raise RuntimeError(f"the {name}-filtered frame does not read back as written")
        out[f"rgb_{name}_ms"] = _median_ms(lambda: read_png(path, mode="RGB"))
    path = os.path.join(base, "labelIds.png")
    write_png(path, ids, "adaptive")
    out["label_adaptive_ms"] = _median_ms(lambda: read_png(path))
    return out


def time_transforms(hw=ACDC_HW, crop: int = CROP) -> Dict[str, float]:
    """ms of the crop-and-scale (image and label) at box scales 0.5, 1 and
    2 of the crop, and of the chamfer and the whole ``LabelBoundaryTransform``
    on a crop's labels."""
    img, label = SyntheticDataset(size=1, image_hw=hw, seed=0)._frame(0)
    sample = {"left": img, "label": label}
    out: Dict[str, float] = {}
    for scale in (0.5, 1.0, 2.0):
        t = RandomSquareCropAndScale((crop, crop), mean=(73, 82, 72), min=scale, max=scale,
                                     rng=np.random.default_rng(0))
        out[f"crop_scale_{scale:g}_ms"] = _median_ms(lambda: t(dict(sample)))
    cropped = RandomSquareCropAndScale((crop, crop), mean=(73, 82, 72), min=1.0, max=1.0,
                                       rng=np.random.default_rng(0))(dict(sample))
    out["chamfer_ms"] = _median_ms(lambda: label_chamfer_distance(cropped["label"]))
    lbt = LabelBoundaryTransform(19)
    out["label_boundary_ms"] = _median_ms(lambda: lbt({"label": cropped["label"]}))
    return out


def main() -> int:
    with tempfile.TemporaryDirectory() as base:
        result = {"cpu": cpu_name(), "frame_hw": list(ACDC_HW), **time_decode(base),
                  **time_transforms()}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
