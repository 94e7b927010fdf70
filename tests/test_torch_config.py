"""The port's flag surface (``config.py``) vs the JAX package's.

``parse_args`` in both packages gives equal values for every shared field,
and ``to_json`` agrees on the shared keys, at the defaults, the paper's
recipe (``scripts/train_weather.sh``), each ``--no_*`` flag, ``--test_only``
and datasets that change ``num_classes`` and ``data_root``; every model name
passes ``parallel.check_devices`` (the six WeatherNet backbones ported last
are built through ``main``). The one
difference by design: the default ``data_root`` lies under the home
directory in the port, where JAX names a fixed path; with ``--data_root``
given they agree. ``--num_devices 2`` is accepted on the CPU on every route
and refused with ``ValueError`` where fewer cards are visible, and the CLIs
raise without a card unless ``--device cpu`` is given.
"""

import dataclasses
import json
import os
import shlex

import pytest

torch = pytest.importorskip("torch")
from doubly_contrastive_semseg_tpu import config as jax_config  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import config as port_config  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import inference as port_inference  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import main as port_main  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.config import (  # noqa: E402
    MODELS, PORTED_MODELS, is_stereo_run, parse_args)
from doubly_contrastive_semseg_tpu_torch.parallel import check_devices  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ONLY = {"filelist_root", "device"}


def recipe_flags():
    """The flags ``scripts/train_weather.sh`` passes to ``main.py``."""
    with open(os.path.join(REPO, "scripts", "train_weather.sh")) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if ln.strip().startswith("python main.py"))
    return [t for t in shlex.split(line)[2:] if t != "$@"]


NO_FLAGS = sorted(a.option_strings[0] for a in jax_config.build_parser()._actions
                  if a.option_strings and a.option_strings[0].startswith("--no_"))

CASES = {
    "defaults": [],
    "train_weather.sh": recipe_flags(),
    "test_only": ["--test_only", "--resume", "x"],
    "city_lost": ["--dataset", "city_lost"],
    "cityscapes with data_root": ["--dataset", "cityscapes", "--data_root", "/data"],
    "acdc weather_num 5": ["--weather_num", "5", "--data_root", "/data/acdc"],
    "synthetic": ["--dataset", "synthetic", "--synthetic_hw", "1024x2048", "--no_host_augment"],
    **{flag: [flag] for flag in NO_FLAGS},
}


def test_every_no_flag_is_a_case():
    assert len(NO_FLAGS) == 8 and "--no_host_augment" in NO_FLAGS and "--no_shuffle" in NO_FLAGS


def test_shared_fields_and_flags():
    jax_fields = {f.name for f in dataclasses.fields(jax_config.Config)}
    port_fields = {f.name for f in dataclasses.fields(port_config.Config)}
    assert port_fields - jax_fields == PORT_ONLY and jax_fields <= port_fields
    jax_flags = {s for a in jax_config.build_parser()._actions for s in a.option_strings}
    port_flags = {s for a in port_config.build_parser()._actions for s in a.option_strings}
    assert port_flags - jax_flags == {"--filelist_root", "--device"}
    assert jax_flags <= port_flags
    assert port_config.CRITERIA == jax_config.CRITERIA
    assert port_config.DATASETS == jax_config.DATASETS
    assert port_config.MODELS == jax_config.MODELS


@pytest.mark.parametrize("argv", list(CASES.values()), ids=list(CASES))
def test_parse_args_matches_jax(argv):
    want = dataclasses.asdict(jax_config.parse_args(argv))
    got = dataclasses.asdict(port_config.parse_args(argv))
    if "--data_root" not in argv:
        # the one difference: the default root, before finalize's suffix
        home = os.path.join(os.path.expanduser("~"), "dataset")
        suffix = os.path.relpath(want["data_root"], jax_config.Config.data_root)
        assert got["data_root"] == os.path.normpath(os.path.join(home, suffix))
        del want["data_root"], got["data_root"]
    assert {k: got[k] for k in want} == want
    assert (got["device"], got["filelist_root"]) == ("cuda", "filenames")
    want_json = json.loads(jax_config.parse_args(argv).to_json())
    got_json = json.loads(port_config.parse_args(argv).to_json())
    shared = set(want) & set(want_json)
    assert {k: got_json[k] for k in shared} == {k: want_json[k] for k in shared}
    assert set(got_json) - set(want_json) == PORT_ONLY


def test_properties_match_jax():
    for argv in CASES.values():
        j, p = jax_config.parse_args(argv), port_config.parse_args(argv)
        assert (p.use_supcon, p.use_pixelcontrast, p.val_wh, p.ignore_index) == \
            (j.use_supcon, j.use_pixelcontrast, j.val_wh, j.ignore_index)
        if p.dataset in ("acdc", "synthetic", "cityscapes"):
            assert p.crop_wh == j.crop_wh


# (argv, whether main gives it the stereo trainer)
NOT_PORTED = {
    "kitti_2015": (["--dataset", "kitti_2015"], True),
    "sceneflow": (["--dataset", "sceneflow"], True),
    "synthetic disparity": (["--dataset", "synthetic", "--transfer_disparity"], True),
    "num_devices": (["--num_devices", "2"], False),
}


@pytest.mark.parametrize("argv,stereo", list(NOT_PORTED.values()), ids=list(NOT_PORTED))
def test_unported_routes_raise_naming_their_item(argv, stereo, tmp_path):
    """The stereo routes (JAX ``main.py:35-38``) go to the stereo trainer;
    on either route ``--num_devices 2`` passes ``check_devices`` on the CPU
    and, on ``cuda`` with fewer cards than ranks, ``main`` raises the
    ``ValueError`` naming both counts before the run writes anything."""
    cfg = parse_args(argv)
    assert is_stereo_run(cfg) == stereo
    argv = argv if "--num_devices" in argv else [*argv, "--num_devices", "2"]
    check_devices(parse_args([*argv, "--device", "cpu"]))
    n = max(2, torch.cuda.device_count() + 1)
    argv = [a if a != "2" else str(n) for a in argv] + ["--batch_size", str(n)]
    with pytest.raises(ValueError, match=f"--num_devices {n} needs {n} GPUs; {torch.cuda.device_count()} visible"):
        port_main.main([*argv, "--run_root", str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("model", [m for m in MODELS
                                   if m == "enet" or m.startswith("deeplabv3")])
def test_check_ported_accepts_the_deeplab_family_and_enet(model):
    """Every DeepLab name of JAX's ``MODELS`` and ``enet`` pass
    ``check_devices``, with ``--deeplab`` too for the DeepLab names, and
    ``--output_stride`` / ``--separable_conv`` reach the config."""
    argv = ["--model", model, "--output_stride", "8", "--separable_conv"]
    if model != "enet":
        argv.append("--deeplab")
    cfg = parse_args(argv)
    check_devices(cfg)
    assert model in PORTED_MODELS and cfg.output_stride == 8 and cfg.separable_conv


BACKBONES = {"resnet18_single": "SingleScaleSwiftNet", "resnet18_hourglass": "HourglassSwiftNet",
             "resnet18_rgbd": "RGBDSwiftNet", "resnet18_back": "PyramidResNetBack",
             "mobilenetv2": "PyramidMobileNetV2", "efficientnetb0": "PyramidEfficientNet"}


@pytest.mark.parametrize("model", list(BACKBONES))
def test_weathernet_backbones_pass_check_ported_and_build(model, tmp_path):
    """The six WeatherNet backbones of ``ROADMAP.md`` §1 item 4 pass
    ``check_devices``, and ``main --device cpu`` builds each (0 epochs: the
    ``Trainer`` alone, its model, data and run directory)."""
    import logging
    import signal

    cfg = parse_args(["--model", model])
    check_devices(cfg)
    assert model in PORTED_MODELS
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    sigs = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        trainer = port_main.main(["--model", model, "--device", "cpu", "--dataset", "synthetic",
                                  "--synthetic_size", "2", "--epochs", "0", "--num_workers", "1",
                                  "--compute_dtype", "float32", "--no_build_summary",
                                  "--run_root", str(tmp_path)])
    finally:   # the trainer takes over the root logger and the signal handlers
        for h in [h for h in root.handlers if h not in handlers]:
            root.removeHandler(h)
            h.close()
        root.setLevel(level)
        for sig, h in sigs.items():
            signal.signal(sig, h)
    fe = trainer.model.net.feature_extractor
    assert type(fe).__name__ == BACKBONES[model] and not trainer.model.training
    assert next(trainer.model.parameters()).device.type == "cpu"


def test_clis_need_the_card_or_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main.main(["--dataset", "synthetic", "--run_root", str(tmp_path)])
    assert not os.listdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_inference.main(["--input", str(tmp_path)])
    with pytest.raises(RuntimeError, match="--test_only requires"):
        port_main.main(["--test_only", "--device", "cpu", "--run_root", str(tmp_path)])
    with pytest.raises(SystemExit, match="need paired left/right lists"):
        port_inference.main(["--input", str(tmp_path), "--stereo", "--device", "cpu"])
