"""``main --device cpu --num_devices 2`` end to end: two gloo ranks train
the flagship criterion for two tiny synthetic epochs, are stopped by a
SIGTERM to the launcher and resumed, against ``--num_devices 1``
uninterrupted.

The runs take ``--loader grain --no_host_augment`` (the rescue keeps the
loader's position and the draws are keyed by the update, as in
``test_torch_kill_restart.py``), SGD, and ``--compute_dtype float64``, where
no rounding-level difference between the ranks' sums and one process's
flips a ReLU gate. Checked: the launcher exits 143 after the SIGTERM; one
rank wrote the one run directory (one log file, one ``rescue_checkpoint``
with the loader's position, no summary line twice); the resumed two-rank
run ends with every parameter and BN statistic within 1e-5 of max|·| of
the one-process run's, and with its validation history.
"""

import glob
import json
import os
import signal
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMMON = [
    "--dataset", "synthetic", "--debug", "--synthetic_hw", "64x64", "--model", "resnet18",
    "--train_semantic", "--criterion", "supcon_pixelcontrast_focal", "--no_host_augment",
    "--loader", "grain", "--num_workers", "0", "--epochs", "2", "--batch_size", "2",
    "--val_batch_size", "3", "--compute_dtype", "float64", "--optimizer_policy", "SGD",
    "--no_use_balanced_weights", "--print_freq", "1", "--random_seed", "7",
    "--no_build_summary", "--device", "cpu",
]


def _start(root, checkname, n, extra=(), stdout=subprocess.PIPE):
    cmd = [sys.executable, "-m", "doubly_contrastive_semseg_tpu_torch.main", *COMMON,
           "--num_devices", str(n), "--run_root", str(root), "--checkname", checkname, *extra]
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.Popen(cmd, cwd=str(root), env=env, stdout=stdout,
                            stderr=subprocess.STDOUT, text=True)


def _run_dir(root, checkname):
    (path,) = glob.glob(os.path.join(str(root), "synthetic", checkname, "*"))
    return path


def _final(root, checkname):
    path = os.path.join(_run_dir(root, checkname), "checkpoints", "latest_checkpoint")
    return torch.load(path, map_location="cpu", weights_only=True)


def test_two_ranks_sigterm_rescue_resume_match_one_process(tmp_path):
    with open(tmp_path / "one.log", "w") as one_log:
        one = _start(tmp_path, "one", 1, stdout=one_log)
        two = _start(tmp_path, "two", 2)
        seen, deadline = "", time.time() + 150
        try:
            for line in two.stdout:
                seen += line
                if "][  2/" in line:      # rank 0 logged step 2 of epoch 0
                    two.send_signal(signal.SIGTERM)
                    break
                assert time.time() < deadline, seen[-4000:]
            else:
                pytest.fail(f"never reached step 2:\n{seen[-4000:]}")
            seen += two.stdout.read()
        finally:
            two.wait(timeout=120)
            two.stdout.close()
        assert one.wait(timeout=150) == 0, (tmp_path / "one.log").read_text()[-4000:]
    assert two.returncode == 128 + signal.SIGTERM, seen[-4000:]

    run = _run_dir(tmp_path, "two")   # the one run directory, rank 0's
    assert len(glob.glob(os.path.join(run, "*_log.txt"))) == 1
    assert seen.count("writing rescue checkpoint") == 1, seen[-4000:]
    rescue = os.path.join(run, "checkpoints", "rescue_checkpoint")
    with open(rescue + ".meta.json") as f:
        meta = json.load(f)
    assert meta["mid_epoch"] is True and meta["epoch"] == 0 and 2 <= meta["num_iter"] < 4
    assert os.path.exists(rescue + ".loader_state")

    resumed = _start(tmp_path, "resumed", 2, extra=["--resume", rescue, "--continue_training"])
    out, _ = resumed.communicate(timeout=150)
    assert resumed.returncode == 0, out[-4000:]
    resumed_run = _run_dir(tmp_path, "resumed")
    with open(os.path.join(resumed_run, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    keys = [(ln["tag"], ln["step"]) for ln in lines]
    assert lines and len(keys) == len(set(keys))

    want, got = _final(tmp_path, "one"), _final(tmp_path, "resumed")
    assert want["step"] == got["step"] == 8
    assert want["model"].keys() == got["model"].keys()
    for k, v in want["model"].items():
        if v.is_floating_point():
            scale = max(float(v.abs().max()), 1e-30)
            assert float((got["model"][k] - v).abs().max()) <= 1e-5 * scale, k
        else:
            assert torch.equal(got["model"][k], v), k

    def val_history(path):
        with open(os.path.join(path, "val_results.txt")) as f:
            return f.read().splitlines()

    assert val_history(resumed_run) == val_history(_run_dir(tmp_path, "one"))
