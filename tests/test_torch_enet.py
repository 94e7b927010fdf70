"""The port's ENet (``models/enet.py``) vs the JAX package's ``ENetDCSS``,
on the CPU at 64², float32, and its max-pool with indices and unpool on
windows with ties.

Weights as in ``test_torch_deeplab.py``: the port model's tensors (BN
randomised) become the JAX tree, which ``from_jax_variables`` maps back
strictly, and the port's ``net.*`` ``state_dict`` goes through the JAX
package's ``convert_reference_enet`` to the same tree (PReLU slopes and
both transposed convs included). Eval outputs within 1e-4 of max|·|.

In training (batch 4 × 2 views; each spatial dropout's mask is JAX's, read
off ``capture_intermediates``: a (sample, channel) is kept where its output
is non-zero anywhere): the encoder's outputs (``fine_feat``,
``fine_feat0``, the weather and projection heads) and its BN running stats
within 1e-3 of the largest entry, for the reason ``test_torch_deeplab.py``
gives (JAX's one-pass f32 batch variance, carried through 8×8 maps: 1.4e-4
measured). The decoder unpools at the encoder's argmax, which such a
difference flips where a window's top two are that close, so it is held
block by block instead: each bottleneck kind on its own in training, the
same input (and pool indices) into both, one random output cotangent,
output and gradients within 1e-4 of max|·| (a PReLU slope's, one sum over
the map whose terms cancel, within 1e-3). Pool and unpool are exact:
ties keep the first of the window in row-major order, JAX's ``argmax``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402

from doubly_contrastive_semseg_tpu.models import enet as jenet  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.torch_convert import (  # noqa: E402
    convert_reference_enet, jax_to_py)
from doubly_contrastive_semseg_tpu_torch import Config, build_model, make_serving_fn  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models import enet  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models.blocks import Dropout  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import convert  # noqa: E402
from test_torch_deeplab import few_threads  # noqa: E402,F401 (autouse)
from test_torch_deeplab import (assert_same_tree, assert_stats_match, check_block,  # noqa: E402
                                close, dropout_masks, jax_tree_from_port, port_from_jax,
                                randomize_bn)

S, B = 64, 2
OUTPUTS = ("seg", "seg_beforeup", "fine_feat", "fine_feat0", "weather_logits")
ENCODER_OUTPUTS = ("fine_feat", "fine_feat0", "weather_logits", "supcon_proj")
TRAIN_TOL = 1e-3


def _setup(rng, b):
    cfg = Config(model="enet", compute_dtype="float32", criterion="supcon_pixelcontrast_focal")
    model = build_model(cfg, device="cpu")
    randomize_bn(model, rng)
    jmodel = jenet.ENetDCSS()
    x = rng.uniform(0, 255, (2 * b, S, S, 3)).astype(np.float32)
    params, stats = jax_tree_from_port(model, jmodel, jnp.asarray(x), train=True,
                                       return_supcon_feature=True)
    return cfg, model, jmodel, x, params, stats


def test_forward_matches_jax_and_names_round_trip(rng):
    cfg, model, jmodel, x, params, stats = _setup(rng, B)
    net_sd = {k[len("net."):]: v.numpy() for k, v in model.state_dict().items()
              if k.startswith("net.")}
    back_p, back_s = convert_reference_enet(net_sd)
    assert_same_tree(back_p, params["net"])
    assert_same_tree(back_s, stats["net"])
    port = port_from_jax(cfg, params, stats)
    want = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x[:B]))
    with torch.no_grad():
        got = port(torch.from_numpy(x[:B]))
    for k in OUTPUTS:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        close(got[k].numpy(), want[k], f"eval {k}")
    # JAX's generic serving branch: seg_beforeup is seg, so the argmax of seg
    labels = make_serving_fn(port, device="cpu")(torch.from_numpy(x[:B]))
    np.testing.assert_array_equal(labels.numpy(), np.argmax(np.asarray(want["seg"]), -1))


def test_train_forward_matches_jax(rng):
    cfg, model, jmodel, x, params, stats = _setup(rng, 4)
    want, mut = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             train=True, return_supcon_feature=True,
                             mutable=["batch_stats", "intermediates"],
                             capture_intermediates=True, rngs={"dropout": jax.random.PRNGKey(3)})
    port = port_from_jax(cfg, params, stats).train()
    drops = {m: ("net", name.split(".")[1], "ext_drop")
             for name, m in port.named_modules() if isinstance(m, Dropout)}
    assert len(drops) == 27
    dropout_masks(port, mut["intermediates"], drops)
    with torch.no_grad():
        got = port(torch.from_numpy(x), return_supcon_feature=True)
    for k in OUTPUTS + ("supcon_proj",):
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        if k in ENCODER_OUTPUTS:
            close(got[k].numpy(), want[k], f"train {k}", TRAIN_TOL)
    encoder = {k: v for k, v in jax_to_py(mut["batch_stats"])["net"].items()
               if not k.startswith(("upsample", "regular4", "regular5"))}
    assert len(encoder) == 23
    assert_stats_match(port, {"net": encoder}, TRAIN_TOL)


@pytest.mark.parametrize("kind", ["regular", "dilated", "asymmetric", "decoder"])
def test_regular_bottleneck_train_matches_jax(rng, kind):
    kw = {"regular": {}, "dilated": {"dilation": 2},
          "asymmetric": {"kernel_size": 5, "asymmetric": True}, "decoder": {"relu": True}}[kind]
    x = rng.standard_normal((4, 8, 8, 64)).astype(np.float32)
    port = enet.RegularBottleneck(64, dropout_prob=0.1, **kw)
    name = (lambda path: convert._module_name(("net", f"{kind}2_1") + path,
                                              {"net": {"initial_block": {}}})
            [len(f"net.{kind}2_1."):])
    check_block(rng, jenet.RegularBottleneck(64, dropout_prob=0.1, **kw), port, [x], name,
                call_port=lambda m, a: m(a), jkw={"train": True},
                dropouts={port.ext_regul: ("ext_drop",)})


def test_downsampling_bottleneck_train_matches_jax(rng):
    x = rng.standard_normal((4, 8, 8, 16)).astype(np.float32)
    port = enet.DownsamplingBottleneck(16, 64, 0.1)

    class JaxOut(fnn.Module):    # the block's output; its indices are checked above
        @fnn.compact
        def __call__(self, a, train):
            return jenet.DownsamplingBottleneck(16, 64, dropout_prob=0.1,
                                                name="downsample1_0")(a, train=train)[0]

    name = (lambda path: convert._module_name(("net",) + path, {"net": {"initial_block": {}}})
            [len("net.downsample1_0."):])
    check_block(rng, JaxOut(), port, [x], name, (True,), call_port=lambda m, a: m(a)[0],
                dropouts={port.ext_regul: ("downsample1_0", "ext_drop")})


def test_upsampling_bottleneck_train_matches_jax(rng):
    """Given the same input and pool indices (ties included)."""
    x = rng.standard_normal((4, 4, 4, 64)).astype(np.float32)
    _, idx = jenet.max_pool_2x2_with_indices(jnp.asarray(_tied(rng, (4, 8, 8, 16))))
    idx_t = torch.from_numpy(np.asarray(idx)).permute(0, 3, 1, 2)
    port = enet.UpsamplingBottleneck(64, 16, 0.1)

    class JaxUp(fnn.Module):
        @fnn.compact
        def __call__(self, a, train):
            return jenet.UpsamplingBottleneck(16, dropout_prob=0.1, name="upsample5_0")(
                a, idx, train=train)

    name = (lambda path: convert._module_name(("net",) + path, {"net": {"initial_block": {}}})
            [len("net.upsample5_0."):])
    check_block(rng, JaxUp(), port, [x], name, (True,), call_port=lambda m, a: m(a, idx_t),
                dropouts={port.ext_regul: ("upsample5_0", "ext_drop")})


def _tied(rng, shape):
    """Small integers: most 2×2 windows hold a repeated value, many tie at
    their max, and some windows are constant."""
    x = rng.integers(0, 3, shape).astype(np.float32)
    x[:, :4, :4] = 1.0
    return x


def test_max_pool_with_indices_and_unpool_match_jax_on_ties(rng):
    x = _tied(rng, (2, 8, 12, 5))                                  # NHWC
    pooled, idx = jenet.max_pool_2x2_with_indices(jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got_p, got_i = enet.max_pool_2x2_with_indices(xt)
    np.testing.assert_array_equal(got_p.permute(0, 2, 3, 1).numpy(), np.asarray(pooled))
    np.testing.assert_array_equal(got_i.permute(0, 2, 3, 1).numpy(), np.asarray(idx))
    windows = x.reshape(2, 4, 2, 6, 2, 5).transpose(0, 1, 3, 2, 4, 5).reshape(2, 4, 6, 4, 5)
    tied = (windows == windows.max(axis=3, keepdims=True)).sum(axis=3) > 1
    assert tied.mean() > 0.2 and np.all(np.asarray(idx)[tied] < 3)
    y = rng.standard_normal((2, 4, 6, 5)).astype(np.float32)
    want = jenet.max_unpool_2x2(jnp.asarray(y), idx)
    got = enet.max_unpool_2x2(torch.from_numpy(y).permute(0, 3, 1, 2), got_i)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))
