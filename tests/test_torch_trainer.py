"""The port's runtime (``main.py``, ``train/trainer.py``) on the CPU, against
the JAX package's ``Trainer`` where both run.

- (i) ``main`` for 2 epochs on the synthetic dataset writes the run
  directory's files; ``parameters.txt`` holds JAX's count less the 2,880
  masked-off taps of JAX's 4×4×12×64 s2d stem (the port stores the dense
  7×7×3×64 kernel);
- (ii) 2 epochs straight equal 1 epoch, then ``--resume latest_checkpoint
  --continue_training`` for 1, bit for bit: the final ``state_dict``, the
  optimizer state and the losses in ``metrics.jsonl``; the resume follows
  JAX's rule (the next epoch, ``num_iter`` one past the saved step);
- (iii) ``--test_only --pretrained x.pth`` in JAX and in the port give
  equal confusion matrices (or differ only at pixels whose top two logits
  lie within 1e-4) and equal ``val_results.txt``;
- (iv) from the same ``.pth`` and data (``--no_shuffle``, one loader
  thread, ``--reference_rng``), step 1's ``total_loss`` within rtol 1e-4 of
  JAX's Trainer, each epoch's ``base_lr`` within rtol 1e-6 (JAX's schedule
  is float32), and a rescue checkpoint resumes at JAX's epoch and
  ``num_iter``;
- (v) a SIGTERM'd CPU subprocess writes ``rescue_checkpoint`` and exits
  with 143 within its own timeout.
"""

import json
import logging
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from doubly_contrastive_semseg_tpu.config import parse_args as jax_parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu.train import Trainer as JaxTrainer  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import Config, build_model  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.config import parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.main import main  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.train import Trainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S2D_MASKED_TAPS = 4 * 4 * 12 * 64 - 7 * 7 * 3 * 64           # 2,880
COMMON = ["--dataset", "synthetic", "--synthetic_size", "2", "--train_semantic",
          "--criterion", "supcon_pixelcontrast_focal", "--compute_dtype", "float32",
          "--num_workers", "1", "--batch_size", "2", "--val_batch_size", "2",
          "--print_freq", "1", "--summary_freq", "1", "--no_build_summary", "--num_devices", "1"]
PORT = COMMON + ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes at once,
    and torch's default of one thread a core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def restore_logging_and_signals():
    """Both trainers reset the root logger and install SIGTERM/SIGINT
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


def run_dir(root):
    """The one ``<run_root>/<dataset>/<checkname>/<timestamp>`` under root."""
    (top,) = [os.path.join(dp) for dp, dn, fn in os.walk(root) if "args.json" in fn]
    return top


def scalars(path, tag):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    return [(r["step"], r["value"]) for r in rows if r["tag"] == tag]


def state_of(trainer):
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            trainer.optimizer.state_dict(), trainer.state.step)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """A reference-format trainer checkpoint of a port model (default
    init, BN statistics and affines drawn from a seed), covering every
    tensor both trainers' models hold."""
    cfg = Config(compute_dtype="float32", criterion="supcon_pixelcontrast_focal")
    model = build_model(cfg, device="cpu", seed=11)
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=g) + 1.0)
                m.weight.copy_(torch.rand(c, generator=g) * 0.3 + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.1)
    sd = model.state_dict()
    blob = {"model_state": {k[len("net."):]: v for k, v in sd.items() if k.startswith("net.")},
            "supcon_projection": {"0.weight": sd["projection.fc1.weight"],
                                  "0.bias": sd["projection.fc1.bias"],
                                  "2.weight": sd["projection.fc2.weight"],
                                  "2.bias": sd["projection.fc2.bias"]},
            "weather_clf": {"fc.weight": sd["weather_clf.fc.weight"],
                            "fc.bias": sd["weather_clf.fc.bias"]}}
    path = str(tmp_path_factory.mktemp("pth") / "reference.pth")
    torch.save(blob, path)
    return path


@pytest.fixture(scope="module")
def resumed_runs(tmp_path_factory):
    """Run A: 2 epochs straight; run B: 1 epoch, then a resume from its
    latest checkpoint for the second; all with on-device augmentation."""
    root = str(tmp_path_factory.mktemp("runs"))
    argv = PORT + ["--no_host_augment", "--run_root", root]
    a = main(argv + ["--epochs", "2", "--checkname", "a"])
    out = {"a": (run_dir(os.path.join(root, "synthetic", "a")), state_of(a))}
    b1 = main(argv + ["--epochs", "1", "--checkname", "b1"])
    out["b1"] = (run_dir(os.path.join(root, "synthetic", "b1")), state_of(b1))
    latest = os.path.join(out["b1"][0], "checkpoints", "latest_checkpoint")
    cfg = parse_args(argv + ["--epochs", "2", "--checkname", "b2", "--resume", latest,
                             "--continue_training"])
    b2 = Trainer(cfg, device="cpu")
    out["restored"] = (b2.cur_epochs, b2.num_iter, b2.state.step, state_of(b2))
    for epoch in range(b2.cur_epochs, cfg.epochs):
        b2.cur_epochs = epoch
        b2.train()
        b2.validate()
    out["b2"] = (run_dir(os.path.join(root, "synthetic", "b2")), state_of(b2))
    return out


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory, pth):
    """JAX's Trainer from ``pth``: 2 epochs of host-augmented steps (the
    run directory), and the (epoch, num_iter) its restore of a rescue
    checkpoint written after them gives."""
    root = str(tmp_path_factory.mktemp("jax"))
    argv = COMMON + ["--pretrained", pth, "--no_shuffle", "--reference_rng", "--epochs", "2",
                     "--run_root", root]
    tr = JaxTrainer(jax_parse_args(argv))
    for epoch in range(2):
        tr.cur_epochs = epoch
        tr.train()
    tr._write_rescue()
    rescue = os.path.join(tr.saver.checkpoint_dir, "rescue_checkpoint")
    resumed = JaxTrainer(jax_parse_args(argv + ["--checkname", "resumed", "--resume", rescue,
                                                "--continue_training"]))
    return tr.saver.experiment_dir, (resumed.cur_epochs, resumed.num_iter)


def test_main_writes_the_run_directory(resumed_runs, jax_trained):
    path = resumed_runs["a"][0]
    files = sorted(os.path.relpath(os.path.join(dp, f), path)
                   for dp, _, fn in os.walk(path) for f in fn)
    log = [f for f in files if f.endswith("_log.txt")]
    assert len(log) == 1 and log[0].startswith("resnet18_synthetic_")
    assert sorted(set(files) - set(log)) == [
        "args.json", "checkpoints/latest_checkpoint", "checkpoints/latest_checkpoint.meta.json",
        "checkpoints/score_best_checkpoint", "checkpoints/score_best_checkpoint.meta.json",
        "command.txt", "metrics.jsonl", "parameters.txt", "val_results.txt"]
    with open(os.path.join(path, "val_results.txt")) as f:
        epochs = [ln for ln in f if ln.startswith("epoch ")]
    assert [ln.split(":")[0] for ln in epochs] == ["epoch 0", "epoch 1"]
    with open(os.path.join(path, "args.json")) as f:
        args = json.load(f)
    assert args["epochs"] == 2 and args["device"] == "cpu" and not args["host_augment"]

    def count(p):
        with open(os.path.join(p, "parameters.txt")) as f:
            return int(f.read().split()[2])

    assert count(path) == count(jax_trained[0]) - S2D_MASKED_TAPS
    losses = scalars(path, "train/total_loss_print_freq")
    assert [s for s, _ in losses] == [1, 2]
    assert all(np.isfinite(v) for _, v in losses)
    assert [s for s, _ in scalars(path, "base_lr")] == [0, 1]


def test_epoch_boundary_resume_is_bit_for_bit(resumed_runs):
    cur_epochs, num_iter, step, restored = resumed_runs["restored"]
    with open(os.path.join(resumed_runs["b1"][0], "checkpoints",
                           "latest_checkpoint.meta.json")) as f:
        meta = json.load(f)
    # JAX trainer.py:124-129: the next epoch, num_iter = saved + 1
    assert meta["epoch"] == 0 and meta["num_iter"] == 1 and not meta["mid_epoch"]
    assert (cur_epochs, num_iter, step) == (1, 2, 1)
    sd_b1, opt_b1, _ = resumed_runs["b1"][1]
    for k, v in sd_b1.items():
        assert torch.equal(v, restored[0][k]), k
    sd_a, opt_a, step_a = resumed_runs["a"][1]
    sd_b, opt_b, step_b = resumed_runs["b2"][1]
    assert step_a == step_b == 2
    for k, v in sd_a.items():
        assert torch.equal(v, sd_b[k]), k
    assert opt_a["param_groups"] == opt_b["param_groups"]
    for i, s in opt_a["state"].items():
        for name, v in s.items():
            assert torch.equal(v, opt_b["state"][i][name]), (i, name)
    tag = "train/total_loss_print_freq"
    straight = [v for _, v in scalars(resumed_runs["a"][0], tag)]
    split = [v for _, v in scalars(resumed_runs["b1"][0], tag)] + \
        [v for _, v in scalars(resumed_runs["b2"][0], tag)]
    assert straight == split and len(straight) == 2
    # the resumed run logs num_iter 3 where the straight run has 2
    assert [s for s, _ in scalars(resumed_runs["b2"][0], tag)] == [3]


def test_test_only_matches_jax(tmp_path, pth):
    argv = ["--test_only", "--pretrained", pth]
    port = main(PORT + argv + ["--run_root", str(tmp_path / "port")])
    assert port.cfg.val_batch_size == 1
    jax_tr = JaxTrainer(jax_parse_args(COMMON + argv + ["--run_root", str(tmp_path / "jax")]))
    jax_tr.test()
    cm, cm_jax = port.evaluator.confusion_matrix, jax_tr.evaluator.confusion_matrix
    assert cm.sum() == cm_jax.sum() > 0 and (np.diag(cm) > 0).sum() >= 3
    if not np.array_equal(cm, cm_jax):
        # only pixels whose top two logits lie within 1e-4 may move
        ties = 0
        for batch in port.val_loader:
            with torch.no_grad():
                seg = port.model(torch.as_tensor(batch["left"]).float())["seg"]
            top2 = seg.topk(2, dim=-1).values
            ties += int(((top2[..., 0] - top2[..., 1]) < 1e-4).sum())
        assert np.abs(cm - cm_jax).sum() <= 2 * ties, (np.abs(cm - cm_jax).sum(), ties)
    else:
        np.testing.assert_array_equal(port.evaluator.confusion_matrix_sem_weather,
                                      jax_tr.evaluator.confusion_matrix_sem_weather)
        np.testing.assert_array_equal(port.evaluator.confusion_matrix_weather,
                                      jax_tr.evaluator.confusion_matrix_weather)
        with open(port.saver.results_file) as f, open(jax_tr.saver.results_file) as g:
            assert f.read() == g.read()
    assert not os.path.exists(port.saver.checkpoint_dir + "/latest_checkpoint")


def test_step_one_loss_base_lr_and_rescue_resume_match_jax(tmp_path, pth, jax_trained):
    jax_dir, jax_resumed = jax_trained
    argv = PORT + ["--pretrained", pth, "--no_shuffle", "--reference_rng", "--epochs", "2",
                   "--run_root", str(tmp_path)]
    port = main(argv)
    path = port.saver.experiment_dir
    tag = "train/total_loss_print_freq"
    (s1, got), (j1, want) = scalars(path, tag)[0], scalars(jax_dir, tag)[0]
    assert s1 == j1 == 1 and abs(got - want) <= 1e-4 * abs(want), (got, want)
    lr, lr_jax = scalars(path, "base_lr"), scalars(jax_dir, "base_lr")
    assert [e for e, _ in lr] == [e for e, _ in lr_jax] == [0, 1]
    for (_, a), (_, b) in zip(lr, lr_jax):
        assert abs(a - b) <= 1e-6 * b, (a, b)
    port._write_rescue()
    with open(os.path.join(port.saver.checkpoint_dir, "rescue_checkpoint.meta.json")) as f:
        meta = json.load(f)
    assert (meta["epoch"], meta["num_iter"], meta["mid_epoch"]) == (1, 2, False)
    resumed = Trainer(parse_args(argv + ["--checkname", "resumed", "--resume",
                                         os.path.join(port.saver.checkpoint_dir,
                                                      "rescue_checkpoint"),
                                         "--continue_training"]), device="cpu")
    # the threaded loader's rescue resumes at the next epoch, as in JAX
    assert (resumed.cur_epochs, resumed.num_iter) == jax_resumed == (2, 3)


def test_sigterm_writes_a_rescue_checkpoint_and_exits_143(tmp_path):
    cmd = [sys.executable, "-m", "doubly_contrastive_semseg_tpu_torch.main", *PORT,
           "--no_host_augment", "--epochs", "4", "--rescue_interval", "1",
           "--run_root", str(tmp_path)]
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(cmd, cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, deadline = [], time.time() + 240
    try:
        for line in proc.stdout:
            lines.append(line)
            if sum("Epoch: [" in ln for ln in lines) == 2:   # the second step's log line
                t_kill = time.time()
                proc.send_signal(signal.SIGTERM)
                break
            assert time.time() < deadline, "".join(lines[-20:])
        rest, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    waited = time.time() - t_kill
    assert proc.returncode == 143, "".join(lines[-20:]) + rest
    assert waited < 60 and "rescue checkpoint saved" in rest
    path = run_dir(str(tmp_path))
    with open(os.path.join(path, "checkpoints", "rescue_checkpoint.meta.json")) as f:
        meta = json.load(f)
    assert meta["epoch"] >= 1 and meta["num_iter"] >= 2 and not meta["mid_epoch"]
    blob = torch.load(os.path.join(path, "checkpoints", "rescue_checkpoint"), weights_only=True)
    assert blob["step"] == meta["num_iter"] and blob["meta"] == meta


@pytest.mark.parametrize("hw", [(3240, 1920), (2160, 1920), (1000, 3000), (1443, 777),
                                (300, 200), (720, 720)])
def test_thumbnail_matches_pil(hw):
    """``save_valid_img_in_results``' ``thumbnail((720, 720))`` of the
    stacked frames, bit for bit Pillow's (reduce + bicubic over a box)."""
    from PIL import Image

    from doubly_contrastive_semseg_tpu_torch.data.transforms import reduce_pil, thumbnail_pil

    rng = np.random.default_rng(hw[0])
    img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    img[: hw[0] // 2] = img[: hw[0] // 2] // 32 * 32
    pim = Image.fromarray(img)
    pim.thumbnail((720, 720))
    np.testing.assert_array_equal(thumbnail_pil(img, (720, 720)), np.asarray(pim))
    box = (1, 2, hw[1] - 3, hw[0] - 1)
    for factor in ((2, 2), (3, 2), (5, 7)):
        np.testing.assert_array_equal(reduce_pil(img, factor, box),
                                      np.asarray(Image.fromarray(img).reduce(factor, box=box)))


@pytest.mark.parametrize("alpha", [0.7, 0.3, 0.0, 1.0])
def test_blend_matches_pil(alpha):
    from PIL import Image

    from doubly_contrastive_semseg_tpu_torch.data.transforms import blend_pil

    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, 256, (50, 60, 3), dtype=np.uint8) for _ in range(2))
    want = Image.blend(Image.fromarray(a), Image.fromarray(b), alpha)
    np.testing.assert_array_equal(blend_pil(a, b, alpha), np.asarray(want))


@pytest.mark.parametrize("each", [False, True], ids=["overall", "each"])
def test_save_val_results_writes_the_dumps(tmp_path, pth, each):
    from doubly_contrastive_semseg_tpu_torch.data import read_png

    argv = PORT + ["--test_only", "--pretrained", pth, "--save_val_results",
                   "--run_root", str(tmp_path)] + (["--save_each_results"] if each else [])
    tr = main(argv)
    root = os.path.join(tr.saver.experiment_dir, "results")
    files = sorted(os.path.relpath(os.path.join(dp, f), root)
                   for dp, _, fn in os.walk(root) for f in fn)
    if each:
        assert files == sorted(f"{sub}/{i}.png" for i in range(2) for sub in (
            "left_image", "pred_sem", "overlay", "gray_pred_sem", "gt_sem"))
        assert read_png(os.path.join(root, "overlay", "0.png")).shape == (128, 160, 3)
    else:
        assert files == ["overall/0_overall.png", "overall/1_overall.png"]
        # frame, label and prediction stacked (384 x 160) fit 720 x 720 as they are
        assert read_png(os.path.join(root, "overall", "0_overall.png")).shape == (384, 160, 3)
