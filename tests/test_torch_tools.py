"""The port's tools against the JAX package's on the CPU: ``tools/tsne.py``
(``Viz``, ``main --tsne``), ``utils/misc.py``, ``utils/visualizer.py``,
``utils/complexity.py`` and ``visualize_balancing_weight.py``.

- ``Viz.get_features`` in image and pixel mode: JAX's features within 1e-4
  at f32 (the same variables, carried by ``from_jax_variables``, BN
  statistics drawn from a seed), labels equal;
- ``main --tsne`` runs ``Viz.run``, which writes ``tsne.png``; ``--resume``
  loads a checkpoint into ``Viz``'s model;
- ``misc`` returns JAX's values; the visualizer's files with visdom absent
  are JAX's byte for byte (the clock pinned in both);
- ``model_complexity``: ``params_m`` is JAX's less the 2,880 masked taps of
  JAX's s2d stem; ``flops_g`` against XLA's count, by the rule beside the
  check;
- the EDT visualizer's arrays are the root script's (JAX) arrays, bit for
  bit, with OpenCV's fixed-point chamfer in JAX's transforms.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from doubly_contrastive_semseg_tpu.config import parse_args as jax_parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu.data import get_dataset as jax_get_dataset  # noqa: E402
from doubly_contrastive_semseg_tpu.data.weights import (  # noqa: E402
    balanced_class_weights as jax_balanced, compute_class_frequencies as jax_frequencies)
from doubly_contrastive_semseg_tpu.models import build_model as jax_build_model  # noqa: E402
from doubly_contrastive_semseg_tpu.tools.tsne import Viz as JaxViz  # noqa: E402
from doubly_contrastive_semseg_tpu.utils import misc as jax_misc  # noqa: E402
from doubly_contrastive_semseg_tpu.utils import visualizer as jax_visualizer  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.complexity import (  # noqa: E402
    model_complexity as jax_model_complexity)
from doubly_contrastive_semseg_tpu_torch import build_model  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import visualize_balancing_weight as edt_viz  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.config import parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.main import main  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.tools.tsne import Viz  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import from_jax_variables  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import misc, visualizer  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils.complexity import model_complexity  # noqa: E402

from test_torch_transforms import FixedPointCv2  # noqa: E402
from test_torch_trainer import restore_logging_and_signals  # noqa: E402,F401

S2D_MASKED_TAPS = 4 * 4 * 12 * 64 - 7 * 7 * 3 * 64           # 2,880
# synthetic 128x160 frames, untransformed (no host crops): both packages'
# loaders give the same pixels; 8 frames in batches of 4
VIZ_ARGV = ["--dataset", "synthetic", "--debug", "--criterion", "none", "--train_semantic",
            "--no_host_augment", "--compute_dtype", "float32", "--no_efficient",
            "--batch_size", "4", "--num_workers", "1"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vizzes(tmp_path_factory):
    """JAX's and the port's ``Viz`` on the same variables: JAX's initial
    ones with the BN statistics drawn from a seed."""
    root = str(tmp_path_factory.mktemp("viz"))
    jviz = JaxViz(jax_parse_args(VIZ_ARGV + ["--run_root", root]))
    first = next(iter(jviz.loader))
    variables = jax.device_get(jviz._init_or_restore(jax.numpy.asarray(first["left"])))
    rng = np.random.default_rng(17)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(rng.uniform(0.5, 1.5, a.shape) if a.ndim and a.size
                             else a, np.float32), variables["batch_stats"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: a - 1.0 if "mean" in jax.tree_util.keystr(p) else a, stats)
    jviz.variables = {"params": variables["params"], "batch_stats": stats}
    viz = Viz(parse_args(VIZ_ARGV + ["--run_root", root, "--device", "cpu"]), device="cpu")
    viz.model.load_state_dict(from_jax_variables(jax.device_get(variables["params"]), stats),
                              strict=True)
    return jviz, viz


@pytest.mark.parametrize("mode", ["image", "pixel"])
def test_get_features_matches_jax(vizzes, mode):
    jviz, viz = vizzes
    want_f, want_l = jviz.get_features(mode=mode)
    want_f, want_l = np.array(want_f), np.array(want_l)
    got_f, got_l = viz.get_features(mode=mode)
    assert got_f.shape == want_f.shape and got_f.dtype == np.float32
    np.testing.assert_array_equal(got_l, want_l)
    scale = max(1.0, float(np.abs(want_f).max()))
    np.testing.assert_allclose(got_f, want_f, rtol=0, atol=1e-4 * scale)
    if mode == "image":
        assert got_f.shape == (8, 128)
    else:
        assert got_f.shape[0] > 8


def test_main_tsne_runs_viz_and_writes_the_scatter(tmp_path):
    # a SupCon criterion: image mode, 8 features (pixel mode's ~2,000 take
    # sklearn's t-SNE ten seconds here)
    tool = main(VIZ_ARGV + ["--tsne", "--criterion", "supcon_focal", "--run_root",
                            str(tmp_path), "--device", "cpu"])
    assert isinstance(tool, Viz)
    path = os.path.join(tool.saver.experiment_dir, "tsne.png")
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert not os.path.exists(os.path.join(tool.saver.experiment_dir, "checkpoints"))


def test_viz_resume_restores_through_the_checkpoint_manager(tmp_path):
    from doubly_contrastive_semseg_tpu_torch.train import CheckpointManager, TrainState

    argv = VIZ_ARGV + ["--run_root", str(tmp_path), "--device", "cpu"]
    model = build_model(parse_args(argv), device="cpu", seed=5)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))
    path = CheckpointManager(str(tmp_path / "ckpt")).save("latest_checkpoint", state, epoch=0)
    viz = Viz(parse_args(argv + ["--resume", path]), device="cpu")
    got = viz.model.state_dict()
    assert all(torch.equal(v, got[k]) for k, v in model.state_dict().items())
    assert not viz.model.training


def test_misc_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    for img in (rng.normal(size=(3, 5, 7)).astype(np.float32),
                rng.normal(size=(5, 7, 3)).astype(np.float32)):
        np.testing.assert_array_equal(misc.Denormalize(mean, std)(img),
                                      jax_misc.Denormalize(mean, std)(img))
    logits, target = rng.normal(size=(50, 10)), rng.integers(0, 10, 50)
    assert misc.accuracy(logits, target, (1, 3, 5)) == jax_misc.accuracy(logits, target, (1, 3, 5))
    path = tmp_path / "lines.txt"
    path.write_text("a b\n\n  c \n")
    assert misc.read_text_lines(str(path)) == jax_misc.read_text_lines(str(path)) == ["a b", "c"]
    misc.mkdir(str(tmp_path / "x" / "y"))
    assert (tmp_path / "x" / "y").is_dir()
    for name in ("net.feature_extractor.conv1.weight", "segmentation.conv.weight",
                 "offset_conv.weight", "deform.b", "weather_clf.fc.weight"):
        kv = (name, None)
        for f in ("filter_specific_params", "filter_semantic_params",
                  "filter_feature_extractor_params", "filter_base_params"):
            assert getattr(misc, f)(kv) == getattr(jax_misc, f)(kv), (name, f)


def test_visualizer_files_equal_jax(tmp_path, monkeypatch):
    class Clock:
        @staticmethod
        def time():
            return 1234.5

    for mod in (visualizer, jax_visualizer):
        monkeypatch.setattr(mod, "time", Clock)
    rng = np.random.default_rng(4)
    calls = [("vis_scalar", ("loss", 0, 1.5)), ("vis_scalar", ("loss", [1, 2], [1.25, 1.0])),
             ("vis_image", ("pred", rng.integers(0, 255, (3, 8, 10), np.uint8))),
             ("vis_image", ("pred", rng.integers(0, 255, (8, 10, 3), np.uint8))),
             ("vis_image", ("gray", rng.random((6, 6)).astype(np.float32))),
             ("vis_image", ("mask", rng.integers(0, 255, (1, 6, 6), np.uint8))),
             ("vis_table", ("opts", {"lr": 214, "momentum": 0.9}))]
    dirs = {}
    for name, mod in (("port", visualizer), ("jax", jax_visualizer)):
        d = tmp_path / name
        vis = mod.Visualizer(port=1, env="main", id="exp0", log_dir=str(d))
        assert vis.vis is None                  # no visdom here: the file backend
        for method, args in calls:
            getattr(vis, method)(*args)
        dirs[name] = d
    names = sorted(os.listdir(dirs["jax"]))
    assert sorted(os.listdir(dirs["port"])) == names and len(names) == 6
    for n in names:
        assert (dirs["port"] / n).read_bytes() == (dirs["jax"] / n).read_bytes(), n
    lines = [json.loads(ln) for ln in (dirs["port"] / "scalars.jsonl").read_text().splitlines()]
    assert [ln["y"] for ln in lines] == [1.5, 1.25, 1.0] and lines[0]["name"] == "[exp0]loss"


def _conv_taps(model, shape):
    """(every tap's FLOPs, the taps' FLOPs that fall inside the input) of the
    port model's convolutions on a zero image of ``shape``."""
    acc = [0, 0]

    def inside(n_in, n_out, k, s, p, d):
        return sum(sum(1 for j in range(k) if 0 <= o * s - p + j * d < n_in)
                   for o in range(n_out))

    def hook(mod, inp, out):
        b, _, h, w = inp[0].shape
        cout, cpg, kh, kw = mod.weight.shape
        oh, ow = out.shape[-2:]
        acc[0] += 2 * b * cout * cpg * kh * kw * oh * ow
        acc[1] += 2 * b * cout * cpg * (inside(h, oh, kh, mod.stride[0], mod.padding[0],
                                               mod.dilation[0])
                                        * inside(w, ow, kw, mod.stride[1], mod.padding[1],
                                                 mod.dilation[1]))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    stem = model.net.feature_extractor
    try:
        stem.fuse_stem = False            # the stem as its Conv2d, as the count runs it
        with torch.no_grad():
            model(torch.zeros(shape))
    finally:
        stem.fuse_stem = True
        for h in handles:
            h.remove()
    return acc


def test_model_complexity_against_xla():
    shape = (1, 128, 128, 3)
    argv = ["--dataset", "synthetic", "--compute_dtype", "float32"]
    want = jax_model_complexity(jax_build_model(jax_parse_args(argv)), shape)
    model = build_model(parse_args(argv + ["--device", "cpu"]), device="cpu")
    got = model_complexity(model, shape, device="cpu")
    assert sorted(got) == sorted(want) == ["bytes_accessed_g", "flops_g", "params_m"]
    assert round(got["params_m"] * 1e6) == round(want["params_m"] * 1e6) - S2D_MASKED_TAPS
    all_taps, inside = (v / 1e9 for v in _conv_taps(model, shape))
    # FlopCounterMode counts 2 FLOPs a multiply-add of every tap of every
    # convolution (all of the port's FLOPs at this size are convolutions);
    # XLA's cost analysis leaves out the taps that fall on padding, and adds
    # the masked taps of its s2d stem, the resizes (dense products in
    # jax.image.resize), and one FLOP an element of BN, ReLU, the adds and
    # the pooling. So XLA's count less the port's in-frame taps is that
    # extra work: positive, and at most 8 % of the in-frame taps' (4.9-6.0 %
    # at 64², 128², 256², 128x256 and 384² in CPU runs of both packages,
    # 5.3 % at this size; the most FlopCounterMode adds beside the
    # convolutions is the weather head's 1e-6 GFLOP).
    assert abs(got["flops_g"] - all_taps) <= 1e-5 * all_taps
    extra = want["flops_g"] - inside
    assert 0 < extra <= 0.08 * inside, (want["flops_g"], got["flops_g"], inside)
    assert got["bytes_accessed_g"] > 0 and np.isfinite(got["bytes_accessed_g"])
    assert not model.training and model.net.feature_extractor.fuse_stem


def test_edt_visualizer_arrays_equal_the_root_scripts(tmp_path):
    argv = ["--dataset", "synthetic", "--train_semantic", "--run_root", str(tmp_path)]
    got = edt_viz.edt_panels(parse_args(argv))
    # the root visualize_balancing_weight.py's arrays, line for line
    cfg = jax_parse_args(argv)
    train_dst, _ = jax_get_dataset(cfg, seed=cfg.random_seed)
    train_dst.transform = FixedPointCv2(train_dst.transform)
    freq = jax_frequencies(train_dst, cfg.num_classes, max_samples=min(16, len(train_dst)))
    class_w = jax_balanced(freq, cfg.epsilon)
    assert len(got) == min(8, len(train_dst)) == 8
    for i, (img, edt, weighted) in enumerate(got):
        sample = train_dst[i]
        if isinstance(sample, (list, tuple)):
            sample = sample[0]
        want_edt = np.asarray(sample["label_distance_weight"])
        lbl = np.asarray(sample["label"]).copy()
        lbl[lbl == 255] = 0
        for a, b in ((img, np.asarray(sample["left"], np.float32)), (edt, want_edt),
                     (weighted, want_edt * class_w[lbl])):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), i
    paths = edt_viz.main(argv)
    assert [os.path.basename(p) for p in paths] == [f"{i}_EDT.png" for i in range(8)]
    assert all(os.path.getsize(p) > 0 for p in paths)
