"""Kill and restart of the port's ``main`` on the CPU — the counterpart of
``tests/test_kill_restart.py``.

A ``--loader grain --no_host_augment --rescue_interval 2`` run is SIGKILLed
(uncatchable: only the periodic rescue written before the kill can save it)
once its third step has logged; the rescue checkpoint is mid-epoch at
``num_iter`` 2, and a process resumed from it with ``--continue_training``
trains only epoch 0's remaining 2 batches, then epoch 1's 4, and ends with
parameters bit-equal to an uninterrupted run's and the same validation
history. The loader's position gives the samples, and the trainer keys the
crops and anchors by the update, so the resumed draws are the
uninterrupted run's.

The uninterrupted run and the killed one run at the same time, each in a
process of its own with one intra-op thread: with two, a process's first
step came out different in its last bits in 2 of 5 runs of this test on
the CPU, which no loader or checkpoint state explains (resuming again from
the same rescue checkpoint gave the uninterrupted run's losses).
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
    "--train_semantic", "--criterion", "none",
    "--no_host_augment", "--loader", "grain", "--num_workers", "0",
    "--epochs", "2", "--batch_size", "2", "--val_batch_size", "2",
    "--compute_dtype", "float32", "--no_use_balanced_weights",
    "--print_freq", "1", "--random_seed", "7", "--no_build_summary", "--device", "cpu",
]


def _start(root, checkname, extra=(), stdout=subprocess.PIPE):
    cmd = [sys.executable, "-m", "doubly_contrastive_semseg_tpu_torch.main", *COMMON,
           "--run_root", str(root), "--checkname", checkname, *extra]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.Popen(cmd, cwd=str(root), env=env, stdout=stdout,
                            stderr=subprocess.STDOUT, text=True)


def _run_dir(root, checkname):
    (path,) = glob.glob(os.path.join(str(root), "synthetic", checkname, "*"))
    return path


def _val_history(path):
    with open(os.path.join(path, "val_results.txt")) as f:
        return f.read()


def test_sigkill_and_restart_bit_faithful(tmp_path):
    # the uninterrupted run (2 epochs x 4 batches) and the killed one together
    with open(tmp_path / "full.log", "w") as full_log:
        full = _start(tmp_path, "full", stdout=full_log)
        killed = _start(tmp_path, "killed", extra=["--rescue_interval", "2"])
        seen, deadline = "", time.time() + 120
        try:
            for line in killed.stdout:
                seen += line
                if "][  3/" in line:      # step 3 logged: the rescue at 2 is written
                    os.kill(killed.pid, signal.SIGKILL)
                    break
                assert time.time() < deadline, seen[-4000:]
            else:
                pytest.fail(f"never reached step 3:\n{seen[-4000:]}")
        finally:
            killed.wait(timeout=60)
            killed.stdout.close()
        assert full.wait(timeout=120) == 0, (tmp_path / "full.log").read_text()[-4000:]
    assert killed.returncode == -signal.SIGKILL

    rescue = os.path.join(_run_dir(tmp_path, "killed"), "checkpoints", "rescue_checkpoint")
    with open(rescue + ".meta.json") as f:
        meta = json.load(f)
    assert meta["mid_epoch"] is True and meta["num_iter"] == 2 and meta["epoch"] == 0
    with open(rescue + ".loader_state", "rb") as f:
        state = json.loads(f.read())
    assert state["last_seen_indices"] == {"0": 3} and state["worker_count"] == 0

    # the restart continues epoch 0 at batch 2
    resumed = _start(tmp_path, "resumed", extra=["--resume", rescue, "--continue_training",
                                                 "--rescue_interval", "2"])
    out, _ = resumed.communicate(timeout=120)
    assert resumed.returncode == 0, out[-4000:]
    ep0 = [ln for ln in out.splitlines() if "Epoch: [  0/" in ln]
    ep1 = [ln for ln in out.splitlines() if "Epoch: [  1/" in ln]
    assert len(ep0) == 2 and len(ep1) == 4, out[-4000:]
    assert "][  1/  4]" in ep0[0]          # the resumed epoch counts its own batches

    # bit-faithful: the final parameters and BN statistics, and the
    # validation history, are the uninterrupted run's
    def final(checkname):
        path = os.path.join(_run_dir(tmp_path, checkname), "checkpoints", "latest_checkpoint")
        return torch.load(path, map_location="cpu", weights_only=True)

    want, got = final("full"), final("resumed")
    assert want["step"] == got["step"] == 8
    assert want["model"].keys() == got["model"].keys()
    for k, v in want["model"].items():
        assert torch.equal(v, got["model"][k]), k
    assert _val_history(_run_dir(tmp_path, "resumed")) == \
        _val_history(_run_dir(tmp_path, "full"))
