"""The port's doubly-contrastive train step vs the JAX package's, from the
same weights on the same batch.

The JAX model is built for training (``efficient=True``, f32,
``return_supcon_feature=True``) at 128², B = 2 with two views, and its
variables go into the port through ``from_jax_variables``.
``reference_rng`` pins the pixel-contrast anchors to the first raster
indices on both sides, since the two frameworks draw different random
numbers. Checked:

- one step's loss components (rtol 1e-4), the BN running stats after its
  forward and backward (the JAX side's closed-form double update of the
  checkpointed bn1/bn2 against the port's reentrant recompute), and every
  parameter's gradient against ``jax.value_and_grad`` of the loss of JAX
  ``make_train_step`` (tolerances below);
- after two steps of JAX ``make_train_step`` and of the port's: BN running
  stats, the frozen groups (seg head, weather classifier, projection)
  bit-identical, every other parameter within the Adam allowance below,
  and the two steps' displacement of all trained parameters together
  within 10 % of JAX's in L2 (measured: 2.8 %);
- the optimizer alone: the same gradients through the port's groups and
  the optax chain for four updates, every update to rtol 1e-5 (this is the
  test that holds betas, eps, bias correction, L2 decay and the per-group
  lr; the train-step test above cannot, see the allowance below);
- the parameter groups and the lr schedules of every group and policy.

Running stats: rtol 1e-4 with an atol of 1e-4 × the tensor's largest entry,
since running means near 0 make a per-element rtol meaningless.

Gradients: the two f32 forwards differ by ~1e-5 of the activations' scale
(other summation orders, the JAX pyramid's composed filters). A ReLU whose
input lies that close to 0 then opens in one framework and not in the
other: each 128² batch has a few, and each moves the gradient of every
tensor below it by up to a few % of its max (measured: 2e-2 to 1.6e-1 of
max|g| in the worst tensor over six batches, 3e-3 to 7e-3 in L2). So the
tensors no ReLU gate precedes on the way back from the loss (the seg head's
conv, the projection's fc2) are held to 1e-4 × max|g|, and every tensor to
2e-2 in L2 norm. ``test_torch_blocks.py`` holds each block's gradients to
1e-4 × max|g| on inputs where no gate can flip.

Adam allowance: Adam's update is about lr·sign(g) while its moments are
young, so an element whose gradient is within rounding of zero (or within
a flipped gate's reach, above) may step either way in the two frameworks:
up to 2·lr_group apart per step, so 4·lr_group after two steps. The
two-step test runs at lr 1e-5 so that those steps leave the second step's
batch moments, and so the running stats, within their tolerance (at the
recipe's 4e-4 they drift to 1.4e-3 of the largest entry). An optimizer
that did nothing would stay within that per-element allowance, which is
why the displacement is also held as a whole and the optimizer on its own.
"""

import dataclasses
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from doubly_contrastive_semseg_tpu.config import parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu.losses import compute_total_loss as jax_total_loss  # noqa: E402
from doubly_contrastive_semseg_tpu.models import build_model as jax_build_model  # noqa: E402
from doubly_contrastive_semseg_tpu.train.optimizer import build_lr_schedule as jax_schedule  # noqa: E402
from doubly_contrastive_semseg_tpu.train.optimizer import build_optimizer as jax_optimizer  # noqa: E402
from doubly_contrastive_semseg_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from doubly_contrastive_semseg_tpu.train.steps import ingest_batch as jax_ingest  # noqa: E402
from doubly_contrastive_semseg_tpu.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from doubly_contrastive_semseg_tpu.utils import label_params_for_optimizer as jax_labels  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.torch_convert import jax_to_py  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import Config, build_model  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops import contrastive  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.train import (  # noqa: E402
    TrainState, build_optimizer, compute_loss, make_train_step, set_lr)
from doubly_contrastive_semseg_tpu_torch.utils import from_jax_variables  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils.convert import _torch_module_name  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils.params import label_params_for_optimizer  # noqa: E402

B, S, C = 2, 128, 19
CRITERION = "supcon_pixelcontrast_focal"
STEPS_PER_EPOCH = 4
FROZEN = ("net.segmentation.", "weather_clf.", "projection.")
LR_2STEP = 1e-5
DISPLACEMENT_TOL = 0.1
GATE_FREE = ("net.segmentation.conv.weight", "net.segmentation.conv.bias",
             "projection.fc2.weight", "projection.fc2.bias")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    label = rng.integers(0, C, (B, S, S)).astype(np.int32)
    label[:, :16, :16] = 255
    alphas = rng.uniform(0.05, 1.0, (B, S, S)).astype(np.float32)
    alphas[label == 255] = 0.0
    return {"left": rng.integers(0, 256, (2 * B, S, S, 3)).astype(np.uint8),
            "label": label, "label_distance_weight": alphas,
            "weather": rng.integers(0, 4, B).astype(np.int32),
            "class_weight": rng.uniform(0.5, 2.0, C).astype(np.float32)}


def _port_cfg(**kw):
    return Config(compute_dtype="float32", criterion=CRITERION, dataset="synthetic",
                  reference_rng=True, **kw)


@pytest.fixture(scope="module")
def setup():
    jcfg = parse_args(["--dataset", "synthetic", "--criterion", CRITERION,
                       "--batch_size", str(B), "--compute_dtype", "float32",
                       "--reference_rng"])
    assert jcfg.efficient
    jmodel = jax_build_model(jcfg)
    batch = _batch()
    v = jax.jit(jmodel.init, static_argnames=("train", "return_supcon_feature"))(
        jax.random.PRNGKey(0), jnp.asarray(batch["left"], jnp.float32), train=True,
        return_supcon_feature=True)
    params, stats = jax_to_py(v["params"]), jax_to_py(v["batch_stats"])
    return types.SimpleNamespace(jcfg=jcfg, jmodel=jmodel, batch=batch,
                                 params=params, stats=stats)


@pytest.fixture(scope="module")
def group_model():
    """One port model for the group and schedule tests: its parameter names
    do not depend on the optimizer flags."""
    return build_model(_port_cfg(), device="cpu")


def _port_model(s):
    model = build_model(_port_cfg(), device="cpu")
    model.load_state_dict(from_jax_variables(s.params, s.stats), strict=True)
    return model.train()


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _named(tree):
    """{port name: array} of a JAX tree of parameters or gradients."""
    return {k: v.numpy() for k, v in from_jax_variables(tree, {}).items()}


def _stats(model):
    return {k: v.numpy().copy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _assert_stats_match(got, stats_tree):
    want = {k: v.numpy() for k, v in from_jax_variables({}, stats_tree).items()
            if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[k]).max(), err_msg=k)


def test_one_step_losses_grads_and_bn_stats_match_jax(setup):
    s = setup

    def loss_fn(params, batch_stats, batch):  # the loss of JAX make_train_step
        batch = jax_ingest(batch)
        outputs, mutated = s.jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, batch["left"], train=True,
            return_supcon_feature=True, mutable=["batch_stats"])
        total, comps = jax_total_loss(s.jcfg, outputs, batch, batch["class_weight"],
                                      jax.random.PRNGKey(1))
        return total, (comps, mutated["batch_stats"])

    (_, (want, new_stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        s.params, s.stats, {k: jnp.asarray(v) for k, v in s.batch.items()})

    model = _port_model(s)
    total, comps, _ = compute_loss(model, _port_cfg(), _torch_batch(s.batch), None)
    total.backward()
    for k in want:
        np.testing.assert_allclose(comps[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert comps["supcon_loss"].item() > 0 and comps["pixelcontrast_loss"].item() > 0

    want_g = _named(jax_to_py(grads))
    got_g = dict(model.named_parameters())
    assert set(got_g) == set(want_g)
    for k, w in want_g.items():
        # the weather head is outside the total: no gradient in the port, 0 in JAX
        g = np.zeros_like(w) if got_g[k].grad is None else got_g[k].grad.numpy()
        if k in GATE_FREE:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=k)
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w), k
    assert not np.any(want_g["weather_clf.fc.weight"])
    _assert_stats_match(_stats(model), jax_to_py(new_stats))


def test_two_train_steps_match_jax(setup):
    s = setup
    jcfg = dataclasses.replace(s.jcfg, lr=LR_2STEP)
    labels = jax_labels(s.params, jcfg)
    tx = jax_optimizer(jcfg, labels, steps_per_epoch=STEPS_PER_EPOCH)
    jstate = JaxTrainState(params=s.params, batch_stats=s.stats,
                           opt_state=tx.init(s.params), step=jnp.zeros((), jnp.int32))
    jstep = jax.jit(jax_make_train_step(s.jmodel, jcfg, tx))
    batches = [_batch(1), _batch(2)]
    for b in batches:
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                 jax.random.PRNGKey(1))

    cfg = _port_cfg(lr=LR_2STEP)
    model = _port_model(s)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = build_optimizer(model, cfg, steps_per_epoch=STEPS_PER_EPOCH)
    state = TrainState(model, opt)
    step = make_train_step(model, cfg, opt)
    launches = contrastive.contrastive_row_stats.launches
    for b in batches:
        metrics = step(state, _torch_batch(b), None)
    assert state.step == 2
    assert contrastive.contrastive_row_stats.launches == launches  # CPU: plain route
    for k in ("total_loss", "seg_loss", "supcon_loss", "pixelcontrast_loss",
              "weather_loss", "weather_clf_acc"):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-4,
                                   err_msg=k)

    _assert_stats_match(_stats(model), jax_to_py(jstate.batch_stats))
    want = _named(jax_to_py(jstate.params))
    label = label_params_for_optimizer(model, cfg)
    lr = {"random_init": cfg.lr, "fine_tune": cfg.lr / 4}
    moved, d_port, d_jax = 0, [], []
    for k, p in model.named_parameters():
        got = p.detach().numpy()
        if k.startswith(FROZEN):
            assert label[k] == "frozen"
            np.testing.assert_array_equal(got, before[k].numpy(), err_msg=k)
            np.testing.assert_array_equal(got, want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got, want[k], rtol=0, atol=4 * lr[label[k]],
                                       err_msg=k)
            moved += int(not torch.equal(p.detach(), before[k]))
            d_port.append((got - before[k].numpy()).ravel())
            d_jax.append((want[k] - before[k].numpy()).ravel())
    assert moved > 50
    d_port, d_jax = np.concatenate(d_port), np.concatenate(d_jax)
    # the two steps' displacement as a whole: an optimizer that does nothing
    # gives 1, one that steps the wrong way 2
    assert np.linalg.norm(d_port - d_jax) <= DISPLACEMENT_TOL * np.linalg.norm(d_jax)


def _tree_like(tree, fn):
    return {k: _tree_like(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@pytest.mark.parametrize("flags", [{}, {"optimizer_policy": "SGD", "train_semantic": True}])
def test_optimizer_updates_match_optax(setup, flags):
    """The same gradients through the port's optimizer groups and the JAX
    optax chain for four updates, one epoch each, so the cosine lr changes
    every update. Gradient scales change between updates and span 1e-6 to 1
    across tensors, so Adam's betas, bias correction and eps and the L2
    decay each move the updates by far more than the tolerance. The port
    runs in float64, so its update is read exactly off the parameters; the
    JAX updates are f32, hence rtol 1e-5."""
    rng = np.random.default_rng(7)
    jcfg = types.SimpleNamespace(**{**vars(setup.jcfg), "optimizer_policy": "ADAM",
                                    "train_semantic": False, "epochs": 4, **flags})
    cfg = _port_cfg(epochs=4, **flags)
    jparams = _tree_like(setup.params,
                         lambda x: rng.normal(0.0, 1e-3, x.shape).astype(np.float32))
    tx = jax_optimizer(jcfg, jax_labels(jparams, jcfg), steps_per_epoch=1)
    jopt = tx.init(jparams)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(jparams, setup.stats), strict=True)
    model.double()
    opt = build_optimizer(model, cfg, steps_per_epoch=1)
    lr = {g["label"]: g["base_lr"] for g in opt.param_groups}
    label = label_params_for_optimizer(model, cfg)
    params = dict(model.named_parameters())
    for step in range(4):
        grads = _tree_like(jparams, lambda x: (rng.normal(0.0, 1.0, x.shape)
                                               * 10.0 ** rng.uniform(-6, 0)).astype(np.float32))
        updates, jopt = tx.update(grads, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = {k: p.detach().clone() for k, p in params.items()}
        for k, g in _named(grads).items():
            params[k].grad = torch.from_numpy(g).double()
        set_lr(opt, cfg, step)
        opt.step()
        for k, u in _named(updates).items():
            got = (params[k].detach() - before[k]).numpy()
            if label[k] == "frozen":
                assert not np.any(got) and not np.any(u), k
            else:
                np.testing.assert_allclose(got, u, rtol=1e-5, atol=1e-5 * lr[label[k]],
                                           err_msg=f"{k} update {step}")


def _port_labels_from_jax(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _port_labels_from_jax(v, path + (k,))
        else:
            leaf = {"kernel": "weight", "scale": "weight"}.get(k, k)
            yield ".".join(_torch_module_name(p) for p in path) + "." + leaf, v


@pytest.mark.parametrize("flags", [
    {}, {"train_seg_head": True, "train_projection": True, "train_weather_clf": True},
    {"optimizer_policy": "SGD"}, {"optimizer_policy": "SGD", "train_semantic": True}])
def test_param_groups_match_jax(setup, group_model, flags):
    jcfg = types.SimpleNamespace(**{**vars(setup.jcfg), "optimizer_policy": "ADAM",
                                    "train_semantic": False, **flags})
    want = dict(_port_labels_from_jax(jax_labels(setup.params, jcfg)))
    cfg = _port_cfg(**flags)
    model = group_model
    assert label_params_for_optimizer(model, cfg) == want
    opt = build_optimizer(model, cfg, steps_per_epoch=STEPS_PER_EPOCH)
    in_groups = {id(p) for g in opt.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        assert (id(p) in in_groups) == (want[name] != "frozen"), name


@pytest.mark.parametrize("policy", ["cos_annealing", "poly", "step", "cos"])
@pytest.mark.parametrize("optimizer_policy", ["ADAM", "SGD"])
def test_lr_schedule_per_group_matches_jax(setup, group_model, policy, optimizer_policy):
    cfg = _port_cfg(lr_policy=policy, optimizer_policy=optimizer_policy, epochs=5,
                    step_size=3, train_semantic=True)
    jcfg = types.SimpleNamespace(**{**vars(setup.jcfg), "lr_policy": policy, "epochs": 5,
                                    "step_size": 3})
    opt = build_optimizer(group_model, cfg, steps_per_epoch=STEPS_PER_EPOCH)
    factor = {"random_init": 1.0, "fine_tune": 0.25, "sgd_base": 1.0, "sgd_semantic": 10.0}
    assert {g["label"] for g in opt.param_groups} <= set(factor)
    for step in (0, 1, 3, 4, 9, 12, 19, 20, 25):
        set_lr(opt, cfg, step)
        for g in opt.param_groups:
            want = float(jax_schedule(jcfg, STEPS_PER_EPOCH,
                                      base_lr=cfg.lr * factor[g["label"]])(step))
            np.testing.assert_allclose(g["lr"], want, rtol=1e-5,
                                       err_msg=f"{g['label']} step {step}")
    if policy == "cos_annealing":
        set_lr(opt, cfg, 5 * STEPS_PER_EPOCH)  # every group ends at the shared last_lr
        assert all(abs(g["lr"] - cfg.last_lr) < 1e-12 for g in opt.param_groups)
