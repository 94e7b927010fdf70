"""One ``supcon_pixelcontrast_focal`` train step of the single-scale trio
and the per-level-BN pyramid (``resnet18_back``) in the port vs the JAX
package; the MobileNetV2 and EfficientNet pyramids' steps are in
``test_torch_pyramid_train.py``, the six backbones' optimizer groups and
``--pretrained`` in ``test_torch_backbones_groups.py``. Helpers from
``test_torch_swiftnet_single.py``.

The step (``check_train_step``): JAX's loss (``make_train_step``'s:
``ingest_batch``, the model in training with two views, ``compute_total_loss``
with ``reference_rng``'s anchors, EfficientNet's drop-connect masks carried
into the port) under ``jax.value_and_grad``, jitted, against the port's
``compute_loss`` and backward, from the same variables, at batch 4 × 2
views. Held: the loss components to rtol 1e-4; the BN running stats after
the step to rtol 1e-4 with an atol of 1e-4 × the tensor's largest entry
(the hourglass's disparity-branch BNs included: it runs in training);
the gradients of the tensors no ReLU gate precedes on the way back from the
loss (the seg head's conv, the projection's fc2) to 1e-3 of max|g|, and
every tensor's to ``GRAD_L2`` in L2: the two f32 forwards differ by ~1e-6
of the activations' scale, a ReLU input that close to 0 opens in one
framework and not the other, and each such flip moves the gradients of every
tensor below it (``test_torch_train.py``); blocks hold every gradient to
1e-4 of max|g| (``test_torch_swiftnet_single.py``,
``test_torch_pyramid_variants.py``).
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.config import parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu.losses import compute_total_loss as jax_total_loss  # noqa: E402
from doubly_contrastive_semseg_tpu.train.steps import ingest_batch as jax_ingest  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.torch_convert import jax_to_py  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import Config  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.losses import compute_total_loss  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.train import compute_loss, ingest_batch  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import from_jax_variables  # noqa: E402
from test_torch_deeplab import few_threads  # noqa: E402,F401 (autouse)
from test_torch_deeplab import assert_stats_match, close, port_from_jax  # noqa: E402
from test_torch_swiftnet_single import (  # noqa: E402
    jax_model, port_config, random_variables, record_bernoulli, use_masks)

C, B_TRAIN = 19, 4
CRITERION = "supcon_pixelcontrast_focal"
GATE_FREE = ("net.segmentation.conv.weight", "net.segmentation.conv.bias",
             "projection.fc2.weight", "projection.fc2.bias")
GRAD_L2 = 0.15
ZERO_GRAD = 1e-4


def batch_of(rng, b, s):
    label = rng.integers(0, C, (b, s, s)).astype(np.int32)
    label[:, :8, :8] = 255
    alphas = rng.uniform(0.05, 1.0, (b, s, s)).astype(np.float32)
    alphas[label == 255] = 0.0
    return {"left": rng.integers(0, 256, (2 * b, s, s, 3)).astype(np.uint8),
            "label": label, "label_distance_weight": alphas,
            "weather": rng.integers(0, 4, b).astype(np.int32),
            "class_weight": rng.uniform(0.5, 2.0, C).astype(np.float32)}


def check_train_step(rng, monkeypatch, name, size, tol=1e-4, depth=False):
    """One train step of ``name`` at ``size``², JAX's against the port's
    (module docstring): loss components to rtol ``tol``, BN running stats
    to ``tol`` of scale. ``depth``: the RGB-D model gets a random depth map
    a view, in both (the train step gives it none: zeros). Returns the port
    model after its backward and JAX's drop-connect masks."""
    jcfg = parse_args(["--dataset", "synthetic", "--model", name, "--criterion", CRITERION,
                       "--batch_size", str(B_TRAIN), "--compute_dtype", "float32",
                       "--reference_rng"])
    cfg = port_config(name, criterion=CRITERION, dataset="synthetic", reference_rng=True)
    jmodel = jax_model(name)
    batch = batch_of(rng, B_TRAIN, size)
    params, stats = random_variables(jmodel, jnp.asarray(batch["left"], jnp.float32), rng,
                                     train=True, return_supcon_feature=True)
    masks = record_bernoulli(monkeypatch)
    d = rng.uniform(0, 80, (2 * B_TRAIN, size, size)).astype(np.float32) if depth else None

    def loss_fn(p, jbatch):
        masks.clear()
        jbatch = jax_ingest(jbatch)
        outputs, mut = jmodel.apply({"params": p, "batch_stats": stats}, jbatch["left"],
                                    train=True, return_supcon_feature=True,
                                    depth=None if d is None else jnp.asarray(d),
                                    mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(2)})
        total, comps = jax_total_loss(jcfg, outputs, jbatch, jbatch["class_weight"],
                                      jax.random.PRNGKey(1))
        return total, (comps, mut, list(masks))

    (_, (want, mut, drawn)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})

    port = port_from_jax(cfg, params, stats).train()
    use_masks(port, drawn)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if depth:   # compute_loss's forward, with the depth map
        tbatch = ingest_batch(tbatch)
        out = port(tbatch["left"], return_supcon_feature=True, depth=torch.from_numpy(d))
        total, comps = compute_total_loss(cfg, out, tbatch, tbatch["class_weight"], None)
    else:
        total, comps, _ = compute_loss(port, cfg, tbatch, None)
    total.backward()
    for k in want:
        np.testing.assert_allclose(comps[k].item(), float(want[k]), rtol=tol, atol=1e-7,
                                   err_msg=k)
    assert comps["supcon_loss"].item() > 0 and comps["pixelcontrast_loss"].item() > 0
    assert_stats_match(port, jax_to_py(mut["batch_stats"]), tol)

    want_g = {k: v.numpy() for k, v in from_jax_variables(jax_to_py(grads), {}).items()}
    got_g = dict(port.named_parameters())
    assert set(got_g) == set(want_g)
    top = max(np.abs(w).max() for w in want_g.values())
    for k, w in want_g.items():
        g = np.zeros_like(w) if got_g[k].grad is None else got_g[k].grad.numpy()
        if np.abs(w).max() <= ZERO_GRAD * top:
            # structurally zero: a bias whose shift a train-mode BN below removes
            assert np.abs(g).max() <= ZERO_GRAD * top, k
            continue
        if k in GATE_FREE:
            close(g, w, k, max(tol, 1e-3))
        assert np.linalg.norm(g - w) <= GRAD_L2 * np.linalg.norm(w), k
    return port, drawn


@pytest.mark.parametrize("name,size", [("resnet18_single", 64), ("resnet18_hourglass", 64),
                                       ("resnet18_rgbd", 64), ("resnet18_back", 128)])
def test_train_step_matches_jax(rng, monkeypatch, name, size):
    """The RGB-D model with a depth map (its zero-depth step:
    ``test_rgbd_zero_depth_train_step``)."""
    port, _ = check_train_step(rng, monkeypatch, name, size, depth=name == "resnet18_rgbd")
    if name == "resnet18_hourglass":
        fe = port.net.feature_extractor
        # the branch ran (its BNs moved with JAX's, above) and no loss reads it
        assert fe.deconv1b.conv2.bn.num_batches_tracked.item() == 1
        assert fe.conv4a.conv.weight.grad is None


def test_rgbd_zero_depth_train_step(rng, monkeypatch):
    """The RGB-D train step as the trainer runs it, without depth: the depth
    branch sees zeros, so its maps are constant but near the borders, and
    JAX's ``TorchBatchNorm`` takes their small variance as E[x²] − E[x]² in
    one f32 pass (``ROADMAP.md`` §3), which moves its losses by more than
    1e-4. So the step is held to JAX at 1e-2 (losses, running stats, the
    gate-free gradients), and the port's float32 losses to its own float64
    run at 1e-4."""
    port, _ = check_train_step(rng, monkeypatch, "resnet18_rgbd", 64, tol=1e-2)
    cfg = port_config("resnet18_rgbd", criterion=CRITERION, dataset="synthetic",
                      reference_rng=True)
    batch = {k: torch.from_numpy(v) for k, v in batch_of(rng, B_TRAIN, 64).items()}
    losses = {}
    for dt in (torch.float32, torch.float64):
        m = copy.deepcopy(port).to(dt).train()
        m.net.feature_extractor.dtype = dt
        b = dict(batch, left=batch["left"].to(dt))
        _, comps, _ = compute_loss(m, cfg, b, None)
        losses[dt] = {k: v.item() for k, v in comps.items()}
    for k, v in losses[torch.float64].items():
        np.testing.assert_allclose(losses[torch.float32][k], v, rtol=1e-4, atol=1e-7, err_msg=k)
