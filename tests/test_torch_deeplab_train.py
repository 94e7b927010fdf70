"""The DeepLab family's training in the port vs the JAX package: one
``supcon_pixelcontrast_focal`` train step of ``deeplabv3plus_resnet50``
(loss components, whole-model gradients, BN running stats), and the
blocks of the ResNet backbone and the heads on their own in training
(outputs, input and parameter gradients, running stats), at batch 4.
Method and tolerances as in ``test_torch_deeplab.py``, whose helpers these
are.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402

from doubly_contrastive_semseg_tpu.config import parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu.losses import compute_total_loss as jax_total_loss  # noqa: E402
from doubly_contrastive_semseg_tpu.models import build_model as jax_build_model  # noqa: E402
from doubly_contrastive_semseg_tpu.models import deeplab as jdl  # noqa: E402
from doubly_contrastive_semseg_tpu.models.backbones import resnet as jresnet  # noqa: E402
from doubly_contrastive_semseg_tpu.train.steps import ingest_batch as jax_ingest  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.torch_convert import jax_to_py  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import Config, build_model  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models import deeplab  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models.backbones import resnet  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.train import compute_loss  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import convert  # noqa: E402
from test_torch_deeplab import few_threads  # noqa: E402,F401 (autouse)
from test_torch_deeplab import (B_TRAIN, C, CRITERION, GATE_FREE, S, TRAIN_TOL,  # noqa: E402
                                aspp_dropout, assert_stats_match, check_block, close,
                                dropout_masks, jax_tree_from_port, port_from_jax, port_named,
                                randomize_bn)


# ---- blocks in training, gradients included ---------------------------------

def _in_context(prefix, context):
    """The port name of a block's own JAX path, read as the path under
    ``prefix`` of a whole model laid out as ``context``."""
    def name(path):
        return convert._module_name(prefix + path, context)
    return name


@pytest.mark.parametrize("cin,planes,stride,dilation", [(256, 64, 1, 2), (256, 128, 2, 1)])
def test_bottleneck_train_matches_jax(rng, cin, planes, stride, dilation):
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    check_block(rng, jresnet.Bottleneck(planes, stride, dilation),
                resnet.Bottleneck(cin, planes, stride, dilation), [x],
                lambda path: ".".join(convert._torch_module_name(p) for p in path), (True,))


@pytest.mark.parametrize("separable", [False, True])
def test_aspp_train_matches_jax(rng, separable):
    """ASPP with JAX's dropout mask, at batch 4: the image pooling's BN
    normalises B values a channel, and at B = 2 its output is ±1 whatever
    the input, so its true input gradient is 0 and both frameworks give
    rounding noise over |a − b|."""
    x = (rng.standard_normal((4, 6, 6, 64)) + 3 * rng.standard_normal((4, 1, 1, 64))
         ).astype(np.float32)
    port = deeplab.ASPP(64, (1, 2, 3), separable=separable)
    name = _in_context(("classifier", "aspp"), {"classifier": {"project": {}, "aspp": {}}})
    check_block(rng, jdl.ASPP((1, 2, 3), separable=separable), port, [x],
                lambda path: name(path)[len("classifier.aspp."):], (True,),
                dropouts={port.project[3]: ("drop",)})


@pytest.mark.parametrize("separable", [False, True])
def test_v3plus_head_train_matches_jax(rng, separable):
    """The V3+ head (project, ASPP with JAX's dropout mask, resize, fuse,
    classifier) on its two inputs."""
    low = rng.standard_normal((4, 12, 12, 24)).astype(np.float32)
    out = (rng.standard_normal((4, 3, 3, 32)) + 3 * rng.standard_normal((4, 1, 1, 32))
           ).astype(np.float32)
    port = deeplab.DeepLabHeadV3Plus(32, 24, C, (1, 2, 3), separable)

    class JaxHead(fnn.Module):
        @fnn.compact
        def __call__(self, lo, hi, train):
            return jdl.DeepLabHeadV3Plus(C, (1, 2, 3), separable, name="classifier")(
                {"low_level": lo, "out": hi}, train)

    name = _in_context((), {"classifier": {"project": {}}})
    check_block(rng, JaxHead(), port, [low, out],
                lambda path: name(path)[len("classifier."):], (True,),
                call_port=lambda m, lo, hi: m({"low_level": lo, "out": hi}),
                dropouts={port.aspp.project[3]: ("classifier", "aspp", "drop")})


# ---- one train step ----------------------------------------------------------

def _batch(rng, b):
    label = rng.integers(0, C, (b, S, S)).astype(np.int32)
    label[:, :8, :8] = 255
    alphas = rng.uniform(0.05, 1.0, (b, S, S)).astype(np.float32)
    alphas[label == 255] = 0.0
    return {"left": rng.integers(0, 256, (2 * b, S, S, 3)).astype(np.uint8),
            "label": label, "label_distance_weight": alphas,
            "weather": rng.integers(0, 4, b).astype(np.int32),
            "class_weight": rng.uniform(0.5, 2.0, C).astype(np.float32)}


def test_train_step_matches_jax(rng):
    """One ``supcon_pixelcontrast_focal`` step of ``deeplabv3plus_resnet50``
    at batch 4 × 2 views: JAX's loss (``make_train_step``'s, its dropout
    mask carried into the port) and ``jax.value_and_grad`` against the
    port's ``compute_loss`` and backward. Pixel-contrast anchors are the
    first raster indices on both sides (``reference_rng``)."""
    name = "deeplabv3plus_resnet50"
    jcfg = parse_args(["--dataset", "synthetic", "--model", name, "--criterion", CRITERION,
                       "--batch_size", str(B_TRAIN), "--compute_dtype", "float32",
                       "--reference_rng"])
    cfg = Config(model=name, compute_dtype="float32", criterion=CRITERION,
                 dataset="synthetic", reference_rng=True)
    model = build_model(cfg, device="cpu")
    randomize_bn(model, rng)
    batch = _batch(rng, B_TRAIN)
    jmodel = jax_build_model(jcfg)
    params, stats = jax_tree_from_port(model, jmodel, jnp.asarray(batch["left"], jnp.float32),
                                       train=True, return_supcon_feature=True)

    def loss_fn(p, jbatch):
        jbatch = jax_ingest(jbatch)
        outputs, mut = jmodel.apply({"params": p, "batch_stats": stats}, jbatch["left"],
                                    train=True, return_supcon_feature=True,
                                    mutable=["batch_stats", "intermediates"],
                                    capture_intermediates=True,
                                    rngs={"dropout": jax.random.PRNGKey(2)})
        total, comps = jax_total_loss(jcfg, outputs, jbatch, jbatch["class_weight"],
                                      jax.random.PRNGKey(1))
        return total, (comps, mut)

    (_, (want, mut)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})

    port = port_from_jax(cfg, params, stats).train()
    dropout_masks(port, mut["intermediates"], {aspp_dropout(port): ("classifier", "aspp",
                                                                   "drop")})
    total, comps, _ = compute_loss(port, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                                   None)
    total.backward()
    for k in want:
        np.testing.assert_allclose(comps[k].item(), float(want[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert comps["supcon_loss"].item() > 0 and comps["pixelcontrast_loss"].item() > 0
    assert_stats_match(port, jax_to_py(mut["batch_stats"]), TRAIN_TOL)

    want_g = port_named(jax_to_py(grads), lambda path: convert._module_name(path, params))
    got_g = dict(port.named_parameters())
    assert set(got_g) == set(want_g)
    for k, w in want_g.items():
        g = np.zeros_like(w) if got_g[k].grad is None else got_g[k].grad.numpy()
        if k in GATE_FREE:
            close(g, w, k, TRAIN_TOL / 2)
        assert np.linalg.norm(g - w) <= 0.15 * np.linalg.norm(w), k
    assert not np.any(want_g["weather_clf.fc.weight"])
