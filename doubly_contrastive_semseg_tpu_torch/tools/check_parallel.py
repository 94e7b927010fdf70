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

The ``spatial`` case is the width-split eval forward and serving of a
``DCSSModel`` on a ``('data', 'model')`` grid (``parallel/spatial.py``):
the outputs gathered whole, the labels, each rank's K2 and K1 launches and
the spread of ``weather_logits`` over a model group, against one process.
``--spatial --ranks 4`` runs ``spatial_plan``'s grids instead of the steps.
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
from ..models import build_model, build_stereo_model, make_serving_fn
from ..parallel import spatial
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


SPATIAL_KEYS = ("seg", "seg_beforeup", "fine_feat", "skips_0")


def spatial_image(b: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 255, (b, h, w, 3)).astype(np.float32)


def _whole(t: torch.Tensor, width: Optional[int] = None, split: bool = True,
           blocks: int = 1) -> torch.Tensor:
    """The whole batch of this rank's samples ``t`` (``blocks`` blocks of
    them: 2 for the two views): with ``split``, its columns of a map
    ``width`` wide gathered over the model group; then gathered over the
    data group (its samples' rows, zeros elsewhere, summed)."""
    if split:
        t = spatial.gather_width(t, width)
    w = parallel.world()
    if w.axis_size("data") == 1:
        return t
    idx = parallel.row_index(t.shape[0], blocks=blocks, device=t.device)
    buf = t.new_zeros((parallel.global_rows(t.shape[0]),) + tuple(t.shape[1:]), dtype=torch.float64)
    buf[idx] = t.double()
    return parallel.all_sum(buf, w.group("data")).to(t.dtype)


def _per_rank(values: Dict[str, float], device) -> Dict[str, List[float]]:
    """Every rank's ``values``, a list by rank under each name (one
    all-reduce)."""
    w = parallel.world()
    buf = torch.zeros((len(values), w.size), dtype=torch.float64, device=device)
    buf[:, w.rank] = torch.tensor(list(values.values()), dtype=torch.float64)
    return dict(zip(values, parallel.all_sum(buf).cpu().tolist()))


def spatial_case(device, h: int = 128, w: int = 256, b: int = 1, dtype: str = "float32",
                 seed: int = 0, state_path: Optional[str] = None, supcon: bool = False,
                 time_iters: int = 0) -> Dict:
    """The eval forward and the serving of a seeded ``DCSSModel`` (resnet18;
    the ``state_dict`` at ``state_path`` instead, where given) on
    ``spatial_image(b, h, w)``: on a grid each rank takes its samples
    (``shard_batch``) and its columns (``shard_width``), and the outputs
    come back whole (gathered over the model group, then the data group);
    in one process, the outputs as they are. With ``supcon`` the model has
    the projection head and the forward takes the two-view concat of
    ``spatial_image(b, h, w, seed)`` and of ``seed + 1``
    (``return_supcon_feature``; ``fine_feat0`` and ``supcon_proj`` too),
    serving the first view. Also each rank's K2 and K1 launches in the
    forward and in serving, its all-reduces and their MB in the forward,
    the spread of ``weather_logits`` over each model group (0: equal on its
    ranks), and with ``time_iters`` each rank's ms a forward and peak
    memory."""
    views = 2 if supcon else 1
    cfg = Config(compute_dtype=dtype, **({"criterion": "supcon_pixelcontrast_focal"}
                                         if supcon else {}))
    model = build_model(cfg, device=device, seed=seed)
    if state_path is not None:
        model.load_state_dict(torch.load(state_path, map_location=device), strict=True)
    image = np.concatenate([spatial_image(b, h, w, seed + v) for v in range(views)])
    image = parallel.shard_batch({"left": image, "label": np.zeros(b)})["left"]
    x = spatial.shard_width(torch.from_numpy(image)).to(device)
    counts = []
    with torch.no_grad():
        counts.append(_route_counts())
        out = model(x, return_supcon_feature=supcon)
        counts.append(_route_counts())
        labels = make_serving_fn(model, device)(x[:x.shape[0] // views])
        counts.append(_route_counts())
    per_rank = {f"{what}_{k}": counts[i + 1][k] - counts[i][k]
                for i, what in enumerate(("forward", "serving")) for k in counts[0]}
    for what in ("forward", "serving"):
        per_rank[f"{what}_all_reduce_mb"] = per_rank.pop(f"{what}_all_reduce_bytes") / 1e6
    wl = out["weather_logits"]
    ms, peak = float("nan"), float("nan")
    if time_iters:
        ms, peak = _time_forward(model, x, time_iters)
    wf = spatial.global_width(out["fine_feat"].shape[2], device)
    widths = {"seg": w, "seg_beforeup": wf, "fine_feat": wf, "fine_feat0": wf, "skips_0": None}
    one_view = ("seg", "seg_beforeup", "fine_feat0")   # the maps of the first view alone
    res = {k: _whole(out[k], widths[k], blocks=1 if k in one_view else views).cpu()
           for k in SPATIAL_KEYS + (("fine_feat0",) if supcon else ())}
    res["labels"] = _whole(labels).cpu()
    res["weather_logits"] = _whole(wl, split=False).cpu()
    if supcon:
        res["supcon_proj"] = _whole(out["supcon_proj"], split=False).cpu()
    per_rank.update(weather_spread=_spread(wl), ms=ms, peak_gb=peak,
                    supcon_spread=_spread(out["supcon_proj"]) if supcon else 0.0,
                    feat_cols=out["fine_feat"].shape[2], skips_0_cols=out["skips_0"].shape[2])
    res["per_rank"] = _per_rank(per_rank, device)
    return res


def _spread(t: torch.Tensor) -> float:
    """The largest difference between this rank's ``t`` and any other rank's
    of its model group (0: the same on every rank)."""
    t = t.flatten(1)[:, None]
    every = spatial.gather_width(t, spatial.grid()[0], dim=1)   # one column a rank
    return float((every - t).abs().max()) if every.numel() else 0.0


def _route_counts() -> Dict[str, int]:
    """K2's and K1's launches in this process, in all and by route (tc:
    tensor cores, bf16; cc: CUDA cores, f32), and the width split's
    all-reduces and their bytes."""
    from ..ops import seghead, stem

    out = {"all_reduce": spatial.ALL_REDUCES["calls"],
           "all_reduce_bytes": spatial.ALL_REDUCES["bytes"]}
    for name, fn in (("k2", stem.fused_stem_pool), ("k1", seghead.fused_seghead_upsample_argmax)):
        out.update({name: fn.launches, f"{name}_tc": fn.tc_launches, f"{name}_cc": fn.cc_launches})
    return out


def _time_forward(model, x, iters: int):
    """(ms a forward over ``iters`` after one warm-up, peak device memory
    in GB) on the card; the ranks' collectives keep them in step."""
    import time

    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x)
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters, torch.cuda.max_memory_allocated() / 1e9


CASES = {"flagship": flagship_step, "stereo": stereo_step, "eval": eval_pass,
         "stereo_eval": stereo_eval_sums, "spatial": spatial_case}


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


def _rank(rank: int, n: int, init_method: str, stop, plan: Sequence, device: str, backend,
          out: str) -> None:
    dev = _device(device, rank, backend)
    torch.set_num_threads(min(torch.get_num_threads(), 2))
    if device == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    res, init = [], init_method
    for i, (shape, jobs) in enumerate(plan):
        grid = {} if shape is None else {"axes": ("data", "model"), "shape": shape}
        parallel.make_mesh(rank, n, init, dev, backend, stop, **grid)
        try:
            res.append([_run_job(case, kw, dev) for case, kw in jobs])
            if i + 1 < len(plan):   # the next grid's rendezvous, picked just before its use
                init = parallel.broadcast_object(parallel.free_init_method() if rank == 0 else None)
        finally:
            parallel.leave()
    if rank == 0:
        torch.save(res, out)


def run_grids(plan: Sequence[Tuple[Optional[Tuple[int, int]], Sequence[Tuple[str, Dict]]]],
              n: int, device: str = "cpu", backend: Optional[str] = None) -> List[List[Dict]]:
    """Each (shape, jobs) of ``plan`` run by ``n`` spawned ranks, one spawn
    for all: the ranks laid out as a ``('data', 'model')`` grid of
    ``shape`` (one ``data`` axis for ``None``), a process group a grid, and
    each (case, keywords) of ``jobs`` run (on ``cuda`` with
    ``backend="gloo"`` every rank on ``cuda:0``); rank 0's results, a list
    a grid."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        parallel.spawn_ranks(_rank, n, ([(s, list(j)) for s, j in plan], device, backend, out))
        return torch.load(out, weights_only=False)


def run_ranks(jobs: Sequence[Tuple[str, Dict]], n: int = 2, device: str = "cpu",
              backend: Optional[str] = None) -> List[Dict]:
    """Each (case, keywords) of ``jobs`` run by ``n`` spawned ranks along
    one ``data`` axis, one spawn for all; rank 0's results."""
    return run_grids([(None, jobs)], n, device, backend)[0]


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
    if "per_rank" in one:
        out.update(spatial_differences(many, one))
    return out


def spatial_differences(many: Dict, one: Dict) -> Dict[str, float]:
    """A width-split ``spatial`` result against one process's: each map's,
    ``weather_logits``' and (two views) ``supcon_proj``'s ``max_rel``, the
    labels' agreement on all
    pixels and on the decided ones (where one process's top-two gap of the
    logits the labels come from exceeds twice the largest ``seg_beforeup``
    difference), and the decided share."""
    keys = [k for k in SPATIAL_KEYS + ("fine_feat0", "weather_logits", "supcon_proj") if k in one]
    out = max_rel({k: many[k] for k in keys}, {k: one[k] for k in keys})
    # the logits the labels are the argmax of: seg_beforeup resized to them
    logits = torch.nn.functional.interpolate(
        one["seg_beforeup"].permute(0, 3, 1, 2), size=tuple(one["labels"].shape[1:]),
        mode="bilinear", align_corners=False)
    top2 = logits.topk(2, dim=1).values
    err = float((many["seg_beforeup"] - one["seg_beforeup"]).abs().max())
    decided = (top2[:, 0] - top2[:, 1]) > 2 * err
    eq = many["labels"] == one["labels"]
    out.update(labels=float(eq.double().mean()), labels_decided=float(eq[decided].double().mean()),
               decided=float(decided.double().mean()))
    return out


# every case at float64 (exact: no ReLU gate can flip) and the train steps at
# float32
JOBS = [("flagship", {"dtype": "float64"}), ("flagship", {"dtype": "float32"}),
        ("flagship", {"criterion": "plain_focal", "dtype": "float64"}),
        ("stereo", {"dtype": "float64"}), ("stereo", {"dtype": "float32"}),
        ("eval", {}), ("stereo_eval", {})]


def spatial_plan(n: int) -> List[Tuple[Tuple[int, int], List[Tuple[str, Dict]]]]:
    """The width-split cases on ``n`` ranks: a (1, n) grid at JAX's 128×256,
    at 128×250 (an odd half width, which ``pyramid_hw`` pads) and on two
    views, and for an even ``n`` ≥ 4 a (2, n/2) grid on a batch of 2, of
    one view and of two."""
    plan = [((1, n), [("spatial", {}), ("spatial", {"w": 250}), ("spatial", {"supcon": True})])]
    if n >= 4 and n % 2 == 0:
        plan.append(((2, n // 2), [("spatial", {"b": 2}), ("spatial", {"b": 2, "supcon": True})]))
    return plan


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--spatial", action="store_true",
                   help="the width-split forward and serving cases (spatial_plan) instead")
    args = p.parse_args(argv)
    if args.device == "cuda":   # one process as the ranks: f32 convs without TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    backend = "gloo" if args.device == "cuda" else None
    plan = spatial_plan(args.ranks) if args.spatial else [(None, JOBS)]
    res = []
    for (shape, jobs), many in zip(plan, run_grids(plan, args.ranks, args.device, backend)):
        one = run_one(jobs, args.device)
        res += [{"case": case, "grid": shape, **kw, **differences(m, o)}
                for (case, kw), m, o in zip(jobs, many, one)]
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
