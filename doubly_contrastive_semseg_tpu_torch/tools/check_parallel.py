"""The ``--num_devices`` N steps against the one-process step on the global
batch: the flagship train step, the stereo train step and the eval step,
run by N ranks (``parallel/``) and by one process on the same numpy-seeded
batch, from the same seeded weights.

Each case returns the step's loss components and the model's ``state_dict``
after the update (parameters and BN running statistics), or the eval
accumulators summed over the ranks, and the kernels' launches in it: rank
0's (``launches``) and the ranks' sum (``launches_all_ranks``). The train cases update with SGD
through ``train/optimizer.py``'s groups and ``set_lr``: Adam's first
update is about lr·sign(g), which turns a rounding-level difference of a
near-zero gradient into a step of 2·lr, while SGD's is lr·g, so the
updated parameters hold the gradients to the same tolerance as the rest.

    python -m doubly_contrastive_semseg_tpu_torch.tools.check_parallel \\
        --device cpu --ranks 2

runs every case on the CPU with gloo and prints the largest differences as
one JSON line (on the card: ``--device cuda`` puts every rank on
``cuda:0`` over gloo, as ``chip_smoke.py`` does on its one card).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import parallel
from ..config import Config
from ..data.loader import to_device
from ..metrics.disparity import disparity_sums
from ..models import build_model, build_stereo_model
from ..train import (TrainState, build_optimizer, init_eval_accum, make_eval_step,
                     make_stereo_train_step, make_train_step)
from ..train.trainer import keyed_generator

C = 19


def flagship_config(criterion: str = "supcon_pixelcontrast_focal", dtype: str = "float32",
                    **kw) -> Config:
    return Config(compute_dtype=dtype, criterion=criterion, dataset="synthetic",
                  optimizer_policy="SGD", lr=0.05, **kw)


def flagship_batch(b: int = 4, s: int = 64, seed: int = 0, two_view: bool = True) -> Dict:
    """A global batch of ``b`` samples (two views of each with
    ``two_view``), labels with an ignored corner, EDT-like weights and
    weathers."""
    rng = np.random.default_rng(seed)
    label = rng.integers(0, C, (b, s, s)).astype(np.int32)
    label[:, : s // 8, : s // 8] = 255
    alphas = rng.uniform(0.05, 1.0, (b, s, s)).astype(np.float32)
    alphas[label == 255] = 0.0
    return {"left": rng.integers(0, 256, ((2 if two_view else 1) * b, s, s, 3)).astype(np.uint8),
            "label": label, "label_distance_weight": alphas,
            "weather": rng.integers(0, 4, b).astype(np.int32)}


def class_weight(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + 1).uniform(0.5, 2.0, C).astype(np.float32)


def _state(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().double().cpu() for k, v in model.state_dict().items()
            if v.is_floating_point()}



def flagship_step(device, criterion: str = "supcon_pixelcontrast_focal",
                  dtype: str = "float32", b: int = 4, s: int = 64, seed: int = 0,
                  state_path: Optional[str] = None, **cfg_kw) -> Dict:
    """One flagship train step of a seeded ``DCSSModel`` (resnet18; the
    ``state_dict`` saved at ``state_path`` instead, where given) on the
    global batch ``flagship_batch(b, s)`` or this rank's share of it;
    ``cfg_kw`` are further ``Config`` fields."""
    cfg = flagship_config(criterion, dtype, random_seed=seed, **cfg_kw)
    model = build_model(cfg, device=device, seed=seed)
    if state_path is not None:
        model.load_state_dict(torch.load(state_path, map_location=device), strict=True)
    opt = build_optimizer(model, cfg, steps_per_epoch=4)
    state = TrainState(model, opt)
    step = make_train_step(model, cfg, opt)
    batch = flagship_batch(b, s, seed, two_view=cfg.use_supcon)
    db = to_device(parallel.shard_batch(batch), device, class_weight(seed))
    metrics = step(state, db, keyed_generator(torch.device(device), seed, 0))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "state": _state(model)}


def stereo_batch(b: int = 4, h: int = 64, w: int = 128, seed: int = 0) -> Dict:
    """Pairs whose right view is the left shifted by 6 px, disparities 6
    with holes (0) and values past 192, labels with ignored pixels."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)
    right = np.zeros_like(left)
    right[:, :, :w - 6] = left[:, :, 6:]
    disp = np.full((b, h, w), 6.0, np.float32)
    disp[:, :, :6] = 0.0
    disp[:, :4, 20:30] = 250.0
    label = rng.integers(0, C, (b, h, w)).astype(np.int32)
    label[:, :8] = 255
    return {"left": left, "right": right, "disp": disp, "label": label}


def stereo_step(device, dtype: str = "float32", b: int = 4, seed: int = 0) -> Dict:
    """One stereo train step of a seeded ``StereoDCSS`` (StereoNet
    aggregation and refinement, ``--train_semantic``, ``max_disp`` 32)."""
    cfg = Config(compute_dtype=dtype, dataset="kitti_2015", criterion="none",
                 train_semantic=True, lr=0.05)
    model = build_stereo_model(device=device, seed=seed, max_disp=32, num_classes=C,
                               train_semantic=True, aggregation_type="stereonet",
                               refinement_type="stereonet", dtype=dtype)
    group = {"params": list(model.parameters()), "lr": cfg.lr, "base_lr": cfg.lr,
             "steps_per_epoch": 4, "label": "stereo"}
    opt = torch.optim.SGD([group], lr=cfg.lr)
    step = make_stereo_train_step(model, cfg, opt)
    db = to_device(parallel.shard_batch(stereo_batch(b, seed=seed)), device)
    metrics = step(TrainState(model, opt), db)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "state": _state(model)}


def eval_pass(device, batches=((3, 0), (1, 1)), s: int = 64, seed: int = 0) -> Dict:
    """The eval step over val batches of (frames, seed) — 3 frames, then a
    last batch of 1 that leaves a rank without a frame — summed over the
    ranks: the accumulators of ``init_eval_accum``."""
    cfg = flagship_config("plain_focal", random_seed=seed)
    model = build_model(cfg, device=device, seed=seed)
    step = make_eval_step(model, cfg)
    accum = init_eval_accum(cfg, device=device)
    for frames, bseed in batches:
        batch = flagship_batch(frames, s, seed + 10 + bseed, two_view=False)
        batch.pop("label_distance_weight")
        _, accum = step(to_device(parallel.shard_batch(batch), device), accum)
    return {"accum": {k: parallel.all_sum(v).cpu().clone() for k, v in accum.items()}}


def stereo_eval_sums(device, b: int = 3, seed: int = 0) -> Dict:
    """A stereo val batch of ``b`` pairs: the eval disparity's
    ``disparity_sums`` summed over the ranks."""
    model = build_stereo_model(device=device, seed=seed, max_disp=32, num_classes=C,
                               aggregation_type="stereonet", refinement_type="stereonet",
                               dtype="float32")
    db = to_device(parallel.shard_batch(stereo_batch(b, seed=seed)), device)
    with torch.no_grad():
        if len(db["disp"]):
            disp = model.disparity(db["left"].float(), db["right"].float())[0]["disp"]
            sums = disparity_sums(disp, db["disp"])
        else:
            sums = torch.zeros(4, device=device)
    return {"sums": parallel.all_sum(sums).cpu()}


CASES = {"flagship": flagship_step, "stereo": stereo_step, "eval": eval_pass,
         "stereo_eval": stereo_eval_sums}


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count in this process."""
    from ..ops import blend, contrastive, edt, seghead, stem

    return {fn.__name__: fn.launches for fn in (
        stem.fused_stem_pool, edt.nearest_diff_label_distance,
        contrastive.contrastive_row_stats, contrastive.pos_sweep_layout,
        contrastive.pixel_contrast_pos_sweep, seghead.fused_seghead_upsample_argmax,
        blend.fused_upsample_blend)}


def _run_job(case: str, kw: Dict, dev: torch.device) -> Dict:
    before = launch_counts()
    res = CASES[case](dev, **kw)
    res["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
    res["launches_all_ranks"] = {k: int(parallel.all_sum(torch.tensor(v)))
                                 for k, v in res["launches"].items()}
    return res


def _device(device: str, rank: int, backend: Optional[str]) -> torch.device:
    """``cuda:rank`` on the card (``cuda:0`` for every rank over gloo),
    else the CPU."""
    if device != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", 0 if backend == "gloo" else rank)


def _rank(rank: int, n: int, init_method: str, stop, jobs: Sequence, device: str, backend,
          out: str) -> None:
    dev = _device(device, rank, backend)
    parallel.make_mesh(rank, n, init_method, dev, backend, stop)
    try:
        torch.set_num_threads(min(torch.get_num_threads(), 2))
        if device == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        res = [_run_job(case, kw, dev) for case, kw in jobs]
        if rank == 0:
            torch.save(res, out)
    finally:
        parallel.leave()


def run_ranks(jobs: Sequence[Tuple[str, Dict]], n: int = 2, device: str = "cpu",
              backend: Optional[str] = None) -> List[Dict]:
    """Each (case, keywords) of ``jobs`` run by ``n`` spawned ranks, one
    spawn for all (on ``cuda`` with ``backend="gloo"`` every rank on
    ``cuda:0``); rank 0's results."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        parallel.spawn_ranks(_rank, n, (list(jobs), device, backend, out))
        return torch.load(out, weights_only=False)


def run_one(jobs: Sequence[Tuple[str, Dict]], device: str = "cpu") -> List[Dict]:
    """The same jobs in this process, one rank."""
    return [_run_job(case, kw, _device(device, 0, "gloo")) for case, kw in jobs]


def max_rel(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """For each key, max|a − b| over max|b| (the tensor's scale)."""
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    return {k: float((a[k].double() - b[k].double()).abs().max()
                     / max(float(b[k].double().abs().max()), 1e-30)) for k in b}


def differences(many: Dict, one: Dict) -> Dict[str, float]:
    """The largest relative difference (``max_rel``) of a many-rank result
    from the one-process one, by kind: ``loss`` (each component), ``params``,
    ``bn_stats``, ``accum``, ``sums``."""
    out = {}
    if "metrics" in one:
        out["loss"] = max(max_rel({k: torch.tensor(v) for k, v in many["metrics"].items()},
                                  {k: torch.tensor(v) for k, v in one["metrics"].items()})
                          .values())
        d = max_rel(many["state"], one["state"])
        stats = ("running_mean", "running_var")
        out["params"] = max(v for k, v in d.items() if not k.endswith(stats))
        out["bn_stats"] = max(v for k, v in d.items() if k.endswith(stats))
    if "accum" in one:
        out["accum"] = max(max_rel(many["accum"], one["accum"]).values())
    if "sums" in one:
        out["sums"] = max(max_rel({"s": many["sums"]}, {"s": one["sums"]}).values())
    return out


# every case at float64 (exact: no ReLU gate can flip) and the train steps at
# float32
JOBS = [("flagship", {"dtype": "float64"}), ("flagship", {"dtype": "float32"}),
        ("flagship", {"criterion": "plain_focal", "dtype": "float64"}),
        ("stereo", {"dtype": "float64"}), ("stereo", {"dtype": "float32"}),
        ("eval", {}), ("stereo_eval", {})]


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    p.add_argument("--ranks", type=int, default=2)
    args = p.parse_args(argv)
    backend = "gloo" if args.device == "cuda" else None
    many = run_ranks(JOBS, args.ranks, args.device, backend)
    one = run_one(JOBS, args.device)
    res = [{"case": case, **kw, **differences(m, o)}
           for (case, kw), m, o in zip(JOBS, many, one)]
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
