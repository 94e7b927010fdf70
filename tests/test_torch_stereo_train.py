"""The port's stereo training (``losses/disparity.py``,
``metrics/disparity.py``, ``train/steps.py::make_stereo_train_step``,
``train/optimizer.py::build_stereo_optimizer``, ``train/trainer_stereo.py``
and ``main``'s stereo routing) against the JAX package's, on the CPU in
float32.

Tolerances:
- the disparity loss, its smoothness term and the metrics: rtol 1e-6;
- one train step of ``StereoDCSS`` from JAX's variables (numpy draws of
  its ``init`` shapes, carried by ``from_jax_variables``), against JAX's
  own ``make_stereo_train_step`` (jitted, with an optax transformation
  that records the gradients ahead of Adam): the loss components rtol
  1e-4; the BN running statistics after the step rtol 1e-4 with an atol of
  1e-4 × the tensor's largest entry; the gradients of the tensors no ReLU
  gate precedes on the way back from the loss (the refinement's output
  conv, the seg head's conv) 1e-4 of max|g|, every other tensor's within
  ``GRAD_L2`` in L2: the two f32 forwards differ by ~1e-6, and a ReLU input
  that close to 0 opens in one framework and not the other, which moves
  every gradient below it (``test_torch_backbones_train.py``). Block by
  block, fed the same input, the gradients hold 1e-4 of max|g|: the
  bottlenecks, the refinements and the adaptive aggregation in
  ``test_torch_stereo_model.py`` and ``test_torch_stereo_warp_refine.py``,
  the 3-D blocks and aggregations in ``test_torch_stereo_3d.py``;
- JAX's updated variables carried by ``from_jax_variables`` load strictly
  into the port's model, leaf for leaf;
- Adam: the port's optimizer against ``optax.adam(b1=0.9, b2=0.99)`` on
  the same gradients for three steps of the cosine schedule, rtol 1e-5.

JAX runs each step jitted once a process (``jax_step``); the adaptive
aggregation takes its ``gather`` deformable convs, whose compile is the
longest of the three cases.
"""

import functools
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.config import parse_args as jax_parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu.losses import disparity as jloss  # noqa: E402
from doubly_contrastive_semseg_tpu.metrics import disparity as jmetrics  # noqa: E402
from doubly_contrastive_semseg_tpu.models import stereo as jstereo  # noqa: E402
from doubly_contrastive_semseg_tpu.train.optimizer import (  # noqa: E402
    build_lr_schedule as jax_lr_schedule)
from doubly_contrastive_semseg_tpu.train.state import TrainState as JaxState  # noqa: E402
from doubly_contrastive_semseg_tpu.train.steps import (  # noqa: E402
    make_stereo_train_step as jax_stereo_step)
from doubly_contrastive_semseg_tpu.utils.torch_convert import jax_to_py  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import inference as port_inference  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.config import parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data.png import read_png, write_png  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data.synthetic import SyntheticStereoDataset  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.losses import disparity as ploss  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.main import main as port_main  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.metrics import disparity as pmetrics  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models import build_stereo_model  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models.blocks import to_channels_last  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.parallel import check_devices  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.train import (  # noqa: E402
    StereoTrainer, TrainState, build_stereo_optimizer, make_stereo_train_step, set_lr)
from doubly_contrastive_semseg_tpu_torch.utils import from_jax_variables  # noqa: E402
from test_torch_deeplab import assert_stats_match, close, few_threads  # noqa: E402,F401
from test_torch_swiftnet_single import random_variables  # noqa: E402
# the trainers reset the root logger and the signal handlers: put them back
from test_torch_trainer import restore_logging_and_signals  # noqa: E402,F401

B, H, W = 2, 64, 128
LR = 1e-3
GRAD_L2 = 0.05
ZERO_GRAD = 1e-4


# ---- the loss and the metrics ----------------------------------------------------------

def t(a):
    return torch.from_numpy(np.asarray(a))


def gt_disp(rng, shape, valid_share=0.7, top=210.0):
    """Ground truth with holes (0), values past 192 and negatives."""
    gt = rng.uniform(-2, top, shape).astype(np.float32)
    gt[rng.random(shape) > valid_share] = 0.0
    return gt


LOSS_CASES = {
    "full resolution, out-of-range gt": (1, False, 0.7),
    "1/4 prediction upsampled, x4": (4, False, 0.7),
    "1/2 prediction upsampled, alphas": (2, True, 0.7),
    "no valid pixel": (4, True, 0.0),
}


@pytest.mark.parametrize("factor,with_alphas,valid", list(LOSS_CASES.values()),
                         ids=list(LOSS_CASES))
@pytest.mark.parametrize("levels", [1, 2, 3, 5])
def test_disparity_loss_matches_jax(rng, factor, with_alphas, valid, levels):
    """Pyramids of 1–5 predictions, the first ``factor`` × coarser (resized
    and scaled by the width ratio), ``alphas`` on the error, rtol 1e-6."""
    gt = gt_disp(rng, (B, 24, 40), valid)
    preds = [rng.uniform(0, 200 / (factor if i == 0 else 1),
                         (B, 24 // (factor if i == 0 else 1), 40 // (factor if i == 0 else 1)))
             .astype(np.float32) for i in range(levels)]
    alphas = rng.uniform(0, 8, gt.shape).astype(np.float32) if with_alphas else None
    want = jloss.disparity_loss([jnp.asarray(p) for p in preds], jnp.asarray(gt),
                                alphas=None if alphas is None else jnp.asarray(alphas))
    got = ploss.disparity_loss([t(p) for p in preds], t(gt),
                               alphas=None if alphas is None else t(alphas))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=0)
    if valid == 0.0:
        assert got.item() == 0.0
    small = jloss.disparity_loss([jnp.asarray(p) for p in preds], jnp.asarray(gt), max_disp=32)
    np.testing.assert_allclose(
        ploss.disparity_loss([t(p) for p in preds], t(gt), max_disp=32).item(), float(small),
        rtol=1e-6)


def test_smoothness_loss_matches_jax(rng):
    disp = rng.uniform(0, 50, (B, 16, 24)).astype(np.float32)
    img = rng.uniform(0, 1, (B, 16, 24, 3)).astype(np.float32)
    for d in (disp, disp[..., None]):
        np.testing.assert_allclose(ploss.smoothness_loss(t(d), t(img)).item(),
                                   float(jloss.smoothness_loss(jnp.asarray(d), jnp.asarray(img))),
                                   rtol=1e-6)


@pytest.mark.parametrize("valid", [0.7, 0.0], ids=["with ground truth", "no valid pixel"])
def test_disparity_metrics_match_jax(rng, valid):
    gt = gt_disp(rng, (B, 20, 30), valid, top=100.0)
    pred = (gt + rng.normal(0, 4, gt.shape)).astype(np.float32)
    mask = rng.random(gt.shape) > 0.5
    for name, args in (("epe_metric", ()), ("d1_metric", ()), ("thres_metric", (1.0,)),
                       ("thres_metric", (3.0,))):
        want = getattr(jmetrics, name)(jnp.asarray(pred), jnp.asarray(gt), *args)
        got = getattr(pmetrics, name)(t(pred), t(gt), *args)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, err_msg=name)
        if valid == 0.0:
            assert got.item() == float(want) == 0.0, name
        want = getattr(jmetrics, name)(jnp.asarray(pred), jnp.asarray(gt), *args,
                                       valid=jnp.asarray(mask))
        got = getattr(pmetrics, name)(t(pred), t(gt), *args, valid=t(mask))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, err_msg=name)


# ---- one train step against JAX's --------------------------------------------------------

STEP_CASES = {
    "stereonet + stereonet": dict(aggregation_type="stereonet", refinement_type="stereonet",
                                  train_semantic=False, max_disp=32),
    "psmnet_basic + stereodrnet": dict(aggregation_type="psmnet_basic",
                                       refinement_type="stereodrnet", train_semantic=False,
                                       max_disp=16),
    "adaptive (gather) + semantic, train_semantic": dict(
        aggregation_type="adaptive", refinement_type="semantic", train_semantic=True,
        deform_impl="gather", max_disp=32),
}
GATE_FREE = ("refinement.conv_out.weight", "refinement.conv_out.bias",
             "refinement.final.weight", "refinement.final.bias",
             "segmentation.conv.weight", "segmentation.conv.bias")


def record_grads():
    """An optax transformation that passes the gradients on and keeps them
    as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


def stereo_argv(train_semantic):
    return (["--dataset", "kitti_2015", "--criterion", "none", "--compute_dtype", "float32",
             "--lr", str(LR), "--epochs", "2"] + (["--train_semantic"] if train_semantic else []))


@functools.lru_cache(maxsize=None)
def jax_step(case):
    """JAX's model and its ``make_stereo_train_step``, jitted once a
    process, with ``record_grads`` ahead of ``optax.adam``."""
    kw = STEP_CASES[case]
    jmodel = jstereo.StereoDCSS(dtype=jnp.float32, **kw)
    jcfg = jax_parse_args(stereo_argv(kw["train_semantic"]))
    tx = optax.chain(record_grads(), optax.adam(jax_lr_schedule(jcfg, 1), b1=0.9, b2=0.99))
    return jmodel, tx, jax.jit(jax_stereo_step(jmodel, jcfg, tx))


def stereo_batch(rng, with_label):
    """A pair whose right view is the left shifted by 6 px, disparity 6
    with holes and values past 192."""
    left = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    right = np.zeros_like(left)
    right[:, :, :W - 6] = left[:, :, 6:]
    disp = np.full((B, H, W), 6.0, np.float32)
    disp[:, :, :6] = 0.0
    disp[:, :4, 20:30] = 250.0
    batch = {"left": left, "right": right, "disp": disp}
    if with_label:
        label = rng.integers(0, 19, (B, H, W)).astype(np.uint8)
        label[:, :8, :8] = 255
        batch["label"] = label
    return batch


def port_from_jax(params, stats, kw):
    with torch.device("meta"):
        model = build_stereo_model(device="meta", dtype="float32", **kw)
    model.load_state_dict(from_jax_variables(params, stats), strict=True, assign=True)
    return to_channels_last(model)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_stereo_train_step_matches_jax(rng, case):
    """One step of ``make_stereo_train_step`` in both packages from the same
    variables and batch (module docstring for the tolerances); JAX's
    updated variables load strictly into the port's model."""
    kw = STEP_CASES[case]
    jmodel, tx, step = jax_step(case)
    batch = stereo_batch(rng, kw["train_semantic"])
    params, stats = random_variables(jmodel, jnp.asarray(batch["left"], jnp.float32), rng,
                                     jnp.asarray(batch["right"], jnp.float32), train=True)
    jstate = JaxState(params=params, batch_stats=stats, opt_state=tx.init(params),
                      step=jnp.zeros((), jnp.int32))
    new_state, want = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))
    want = {k: float(v) for k, v in want.items()}
    grads = jax_to_py(new_state.opt_state[0])
    new_stats = jax_to_py(new_state.batch_stats)

    cfg = parse_args(stereo_argv(kw["train_semantic"]) + ["--device", "cpu"])
    port = port_from_jax(params, stats, kw)
    optimizer = build_stereo_optimizer(port, cfg, 1)
    got = make_stereo_train_step(port, cfg, optimizer)(TrainState(port, optimizer),
                                                        {k: t(v) for k, v in batch.items()})
    assert set(got) == set(want) == ({"disp_loss", "total_loss"} |
                                     ({"seg_loss"} if kw["train_semantic"] else set()))
    for k in want:
        np.testing.assert_allclose(got[k].item(), want[k], rtol=1e-4, atol=1e-7, err_msg=k)
    assert_stats_match(port, new_stats, 1e-4)

    want_g = {k: v.numpy() for k, v in from_jax_variables(grads, {}).items()}
    got_g = dict(port.named_parameters())
    assert set(got_g) == set(want_g)
    top = max(np.abs(w).max() for w in want_g.values())
    checked = 0
    for k, w in want_g.items():
        g = np.zeros_like(w) if got_g[k].grad is None else got_g[k].grad.numpy()
        if np.abs(w).max() <= ZERO_GRAD * top:
            # structurally zero: a bias whose shift a train-mode BN below removes,
            # or an offset conv the samples' rounding does not reach
            assert np.abs(g).max() <= ZERO_GRAD * top, k
            continue
        if k in GATE_FREE:
            close(g, w, k, 1e-4)
            checked += 1
        assert np.linalg.norm(g - w) <= GRAD_L2 * np.linalg.norm(w), k
    assert checked == (4 if kw["train_semantic"] else 2)

    # the updated JAX variables carried into a fresh port model, leaf for leaf
    carried = from_jax_variables(jax_to_py(new_state.params), new_stats)
    fresh = port_from_jax(jax_to_py(new_state.params), new_stats, kw)
    sd = fresh.state_dict()
    assert set(carried) == set(sd) == set(port.state_dict())
    for k, v in carried.items():
        assert torch.equal(sd[k], v), k


def test_adam_matches_optax(rng):
    """The port's one-group Adam (0.9, 0.99) on the cosine schedule against
    ``optax.adam(schedule, b1=0.9, b2=0.99)`` fed the same gradients, three
    steps (rtol 1e-5); gradients of mixed scales, one tensor's zero."""
    cfg = parse_args(stereo_argv(False) + ["--device", "cpu", "--last_lr", "1e-5"])
    jcfg = jax_parse_args(stereo_argv(False) + ["--last_lr", "1e-5"])
    model = torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.Linear(7, 3))
    params = {k: v.detach().numpy().copy() for k, v in model.named_parameters()}
    optimizer = build_stereo_optimizer(model, cfg, steps_per_epoch=2)
    assert len(optimizer.param_groups) == 1 and optimizer.param_groups[0]["weight_decay"] == 0
    tx = optax.adam(jax_lr_schedule(jcfg, 2), b1=0.9, b2=0.99)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    for step in range(3):
        g = {k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(-4, 2)).astype(np.float32)
             for k, v in params.items()}
        g["1.bias"][:] = 0.0
        for k, p in model.named_parameters():
            p.grad = t(g[k])
        set_lr(optimizer, cfg, step)
        optimizer.step()
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-8, err_msg=f"step {step} {k}")


def test_stereo_train_step_loss_decreases():
    """JAX's ``test_stereo_train_step_loss_decreases`` on the port: the
    synthetic pairs, StereoNet aggregation and refinement, 6 steps of the
    stereo trainer's Adam from lr 1e-3; the disparity loss falls and stays
    finite."""
    cfg = parse_args(["--dataset", "synthetic", "--train_semantic", "--criterion", "none",
                      "--compute_dtype", "float32", "--lr", "1e-3", "--device", "cpu"])
    ds = SyntheticStereoDataset(size=2, image_hw=(32, 48), max_disp=8)
    batch = {k: torch.stack([torch.from_numpy(ds[i][k]) for i in range(2)])
             for k in ("left", "right", "disp", "label")}
    model = build_stereo_model(device="cpu", max_disp=16, dtype="float32",
                               aggregation_type="stereonet", refinement_type="stereonet")
    optimizer = build_stereo_optimizer(model, cfg, steps_per_epoch=1)
    step = make_stereo_train_step(model, cfg, optimizer)
    state = TrainState(model, optimizer)
    losses = [step(state, batch)["disp_loss"].item() for _ in range(6)]
    assert losses[-1] < losses[0], losses
    assert all(np.isfinite(losses)) and state.step == 6


# ---- main on the synthetic disparity route ---------------------------------------------

SYNTHETIC = ["--dataset", "synthetic", "--transfer_disparity", "--criterion", "none",
             "--refinement_type", "stereonet", "--debug", "--device", "cpu",
             "--compute_dtype", "float32", "--batch_size", "4", "--val_batch_size", "2",
             "--num_workers", "1", "--no_build_summary", "--print_freq", "1"]


def checkpoints(trainer):
    return sorted(os.listdir(trainer.saver.checkpoint_dir))


def test_main_trains_the_synthetic_disparity_route(tmp_path):
    """``main`` runs the ``StereoTrainer`` (JAX ``main.py:35-47``): 2 epochs
    of 2 steps write both checkpoints; ``--continue_training --resume``
    starts at the next epoch with ``num_iter`` and ``best_epe`` restored;
    ``--test_only --resume`` validates and writes no checkpoint; a missing
    ``--resume`` path raises; the checkpoint serves through ``inference
    --stereo --resume``, its disparity the trainer's model's."""
    tr = port_main(SYNTHETIC + ["--epochs", "2", "--run_root", str(tmp_path / "a")])
    assert isinstance(tr, StereoTrainer) and tr.state.step == tr.num_iter == 4
    assert tr.model.max_disp == 32 and type(tr.model.refinement).__name__ == \
        "StereoNetRefinement" and not hasattr(tr.model, "segmentation")
    assert checkpoints(tr) == ["latest_checkpoint", "latest_checkpoint.meta.json",
                               "score_best_checkpoint", "score_best_checkpoint.meta.json"]
    assert np.isfinite(tr.best_epe) and all(np.isfinite(list(m.values())).all()
                                            for _, m in tr.epoch_losses)
    latest = os.path.join(tr.saver.checkpoint_dir, "latest_checkpoint")
    best = os.path.join(tr.saver.checkpoint_dir, "score_best_checkpoint")

    resume = ["--resume", latest, "--continue_training"]
    restored = StereoTrainer(parse_args(SYNTHETIC + ["--epochs", "3", "--run_root",
                                                     str(tmp_path / "b0")] + resume),
                             device="cpu")
    assert (restored.cur_epochs, restored.num_iter, restored.state.step) == (2, 4 + 1, 4)
    assert restored.best_epe == tr.best_epe
    again = port_main(SYNTHETIC + ["--epochs", "3", "--run_root", str(tmp_path / "b")] + resume)
    assert again.num_iter == 4 + 1 + 2 and again.state.step == 4 + 2
    assert [e for e, _ in again.epoch_losses] == [2]
    assert again.best_epe <= tr.best_epe

    test = port_main(SYNTHETIC + ["--run_root", str(tmp_path / "c"), "--resume", best,
                                  "--test_only"])
    assert test.cur_epochs == 0 and test.num_iter == 0 and checkpoints(test) == []
    with pytest.raises(RuntimeError, match="no checkpoint found"):
        port_main(SYNTHETIC + ["--run_root", str(tmp_path / "d"), "--resume",
                               str(tmp_path / "missing")])

    # the checkpoint in inference --stereo, with the trainer's composition flags
    ds = tr.val_dst
    for side in ("left", "right"):
        os.makedirs(tmp_path / "pairs" / side)
        write_png(tmp_path / "pairs" / side / "0.png", ds[0][side].astype(np.uint8))
    blob = torch.load(best, weights_only=True)["model"]
    res = port_inference.main([
        "--stereo", "--device", "cpu", "--compute_dtype", "float32", "--max_disp", "32",
        "--refinement_type", "stereonet", "--input", str(tmp_path / "pairs" / "left"),
        "--resume", best, "--output_dir", str(tmp_path / "out")])
    model = build_stereo_model(port_inference.build_parser().parse_args(
        ["--stereo", "--input", "x", "--max_disp", "32", "--refinement_type", "stereonet",
         "--compute_dtype", "float32"]), device="cpu")
    model.load_state_dict(blob, strict=True)
    x = [torch.from_numpy(ds[0][s].astype(np.uint8)).float()[None] for s in ("left", "right")]
    with torch.no_grad():
        want = model.disparity(*x)[0]["disp"][0].numpy()
    got = read_png(res["paths"][0])
    assert np.abs(got.astype(np.int32) - np.clip(want * 256, 0, 65535).astype(np.int32)).max() <= 1


def test_num_devices_still_raises(tmp_path):
    """``--num_devices`` above the visible cards raises on ``cuda`` before
    the run writes anything; two ranks are accepted on the CPU, and a train
    batch smaller than the ranks is refused."""
    n = max(2, torch.cuda.device_count() + 1)
    argv = [a for a in SYNTHETIC if a not in ("--device", "cpu")]
    with pytest.raises(ValueError, match=f"needs {n} GPUs; {torch.cuda.device_count()} visible"):
        port_main(argv + ["--run_root", str(tmp_path), "--num_devices", str(n),
                          "--batch_size", str(n)])
    assert not os.listdir(tmp_path)
    check_devices(parse_args(SYNTHETIC + ["--num_devices", "2", "--batch_size", "2"]))
    with pytest.raises(ValueError, match="a train batch of 1 samples leaves a rank without one"):
        check_devices(parse_args(SYNTHETIC + ["--num_devices", "2", "--batch_size", "1"]))
