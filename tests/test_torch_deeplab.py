"""The port's DeepLabV3 / V3+ (``models/deeplab.py``) vs the JAX package's
``DeepLabDCSS``, on the CPU at 64², batch 2, float32: the ResNet-50/101
models' forwards, the generic serving branch and the factory's routes;
``test_torch_deeplab_train.py`` holds the train step and the blocks in
training, ``test_torch_deeplab_{mobilenet,xception,hrnet}.py`` the other
backbones. The helpers below serve all four and ``test_torch_enet.py``.

Weights go both ways. The port model's weights (BN affine and running
statistics randomised from a numpy seed, so the folds and the batch
statistics are exercised) become a JAX variables tree shaped by
``jax.eval_shape`` of JAX's ``init``; ``from_jax_variables`` maps that tree
back onto a fresh port model, strictly and bit for bit; and the port's
``state_dict`` goes through the JAX package's own
``convert_reference_deeplab`` to the same tree (the heads' separable convs
aside, which that converter does not map), which proves that the port keeps
the reference's names. JAX runs eagerly (un-jitted), which compiles far
less than one jit of the whole model.

Tolerances. Eval outputs: 1e-4 of max|·| of each tensor. Each block on
its own in training (the same NHWC input, one random output cotangent):
output, input and parameter gradients 1e-4 of max|·|, BN running stats
rtol 1e-4 with an atol of 1e-4 × the tensor's largest entry (one block has
few ReLUs, so no gate flips between the two f32 forwards,
``test_torch_blocks.py``). The whole model in training: outputs and running
stats ``TRAIN_TOL`` = 1e-2 of the largest entry. JAX's ``TorchBatchNorm``
takes its batch variance in one f32 pass, E[x²] − E[x]², even in float64
(at ResNet-50's stem BN on these inputs: 4.6e-6 of max|·| from a float64
two-pass reference; the port 4.7e-7), and the batch statistics of 4×4 maps
carry that through the trunk, the port in float64 as in float32: at batch
4, ResNet-50's ``out`` differs by 4.4e-4 of its max and the V3+ logits by
7.1e-4, ResNet-101's by 2.1e-3 and 4.0e-3 (measured; its case here runs
in eval mode, ResNet-50's in both). The train step: loss components
rtol 1e-4; gradients 5e-3 of max|g| on the tensors no ReLU gate precedes
(measured up to 2.0e-3, the projection's fc2 bias) and 0.15 in L2 on every
tensor (measured up to 6.4e-2): a flipped gate moves every tensor below it
(``test_torch_train.py``), and on these 4×4 maps the port's own float32
gradients differ from its float64 ones by up to 3.2e-2 in L2.

Training checks run at batch 4 (``B_TRAIN``): at batch 2 ASPP's
image-pooling BN normalises 2 values a channel, its output is ±1 whatever
its input, and its gradient is rounding noise in both frameworks. ASPP's
dropout mask is JAX's, read off ``capture_intermediates`` (kept where the
dropout output is non-zero; where its input is 0 either choice gives the
same output and, behind the ReLU, the same gradient).
"""

import functools
from typing import Mapping

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.config import parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu.models import build_model as jax_build_model  # noqa: E402
from doubly_contrastive_semseg_tpu.models import deeplab as jdl  # noqa: E402
from doubly_contrastive_semseg_tpu.models.serving import make_serving_fn as jax_serving  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.torch_convert import (  # noqa: E402
    convert_reference_deeplab, jax_to_py)
from doubly_contrastive_semseg_tpu_torch import Config, build_model, make_serving_fn  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.config import MODELS  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models import deeplab  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops import blend, seghead, stem  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import convert, from_jax_variables  # noqa: E402

S, B, C = 64, 2, 19
B_TRAIN = 4   # ASPP's image-pooling BN needs more than 2 values a channel
CRITERION = "supcon_pixelcontrast_focal"
TRAIN_TOL = 1e-2
ZERO_GRAD = 1e-5
SCALAR_GRAD = 1e-3
GATE_FREE = ("classifier.classifier.3.weight", "classifier.classifier.3.bias",
             "projection.fc2.weight", "projection.fc2.bias")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes at once,
    and torch's default of one thread a core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---- weights both ways ------------------------------------------------------

def randomize_bn(model, rng):
    """Random BN affine and running statistics on every BN of the port
    model, in place (scales below 1 keep deep trunks' outputs of order 1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 0.8, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.1, c).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.1, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(1.0, 2.0, c).astype(np.float32)))


_PORT_LEAF = {"kernel": "weight", "scale": "weight", "alpha": "weight", "bias": "bias",
              "mean": "running_mean", "var": "running_var"}


def _jax_leaf(t: np.ndarray, leaf: str, path) -> np.ndarray:
    """A port tensor in the JAX layout of ``leaf`` (the inverse of
    ``from_jax_variables``' conversions)."""
    if leaf != "kernel":
        return t
    if path[-1] in ("ext_tconv", "transposed_conv"):
        return np.ascontiguousarray(t.transpose(2, 3, 0, 1)[::-1, ::-1])
    return np.ascontiguousarray(t.transpose(2, 3, 1, 0) if t.ndim == 4 else t.T)


def tree_from_port(model, shapes, port_name):
    """(params, batch_stats) shaped as ``shapes`` (``jax.eval_shape`` of a
    JAX ``init``), each leaf the port model's tensor named
    ``port_name(module path)`` in the JAX layout; checks that the map is one
    to one and the shapes agree."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    used = set()

    def fill(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, Mapping):
                out[k] = fill(v, path + (k,))
            else:
                name = f"{port_name(path)}.{_PORT_LEAF[k]}"
                out[k] = _jax_leaf(sd[name], k, path)
                assert out[k].shape == tuple(v.shape), name
                used.add(name)
        return out

    params, stats = fill(shapes["params"]), fill(shapes.get("batch_stats", {}))
    assert used == {k for k in sd if not k.endswith("num_batches_tracked")}
    return params, stats


def port_named(tree, port_name):
    """{port name: array} of a JAX tree of parameters or gradients."""
    out = {}

    def walk(node, path=()):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                v = np.asarray(v)
                if k == "kernel":
                    v = (v[::-1, ::-1].transpose(2, 3, 0, 1)
                         if path[-1] in ("ext_tconv", "transposed_conv")
                         else v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T)
                out[f"{port_name(path)}.{_PORT_LEAF[k]}"] = v
    walk(tree)
    return out


def jax_tree_from_port(model, jmodel, x, **init_kw):
    """(params, batch_stats) for the whole JAX model ``jmodel`` holding the
    port model's tensors, named as ``from_jax_variables`` names them."""
    shapes = jax.eval_shape(functools.partial(jmodel.init, **init_kw),
                            jax.random.PRNGKey(0), x)
    return tree_from_port(model, shapes,
                          lambda path: convert._module_name(path, shapes["params"]))


def check_block(rng, jmod, port, inputs, port_name, jargs=(), call_port=None,
                dropouts=None, jkw=None):
    """One block in training, JAX's against the port's: BN randomised on
    the port, its tensors into the JAX tree, the same NHWC ``inputs`` and one
    random output cotangent; output, input and parameter gradients within
    1e-4 of max|·| (a gradient below ``ZERO_GRAD`` of the block's largest,
    structurally zero, only held below it; a one-element one, ENet's PReLU
    slope, to ``SCALAR_GRAD``), running stats rtol 1e-4. ``jargs`` and ``jkw`` follow
    the inputs into the JAX block; ``dropouts`` as in ``dropout_masks``."""
    randomize_bn(port, rng)
    xs = [jnp.asarray(x) for x in inputs]
    jkw = jkw or {}
    shapes = jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a, *jargs, **jkw),
                            *xs)
    params, stats = tree_from_port(port, shapes, port_name)

    def f(p, *a):
        return jmod.apply({"params": p, "batch_stats": stats}, *a, *jargs, **jkw,
                          mutable=["batch_stats", "intermediates"],
                          capture_intermediates=bool(dropouts),
                          rngs={"dropout": jax.random.PRNGKey(5)})

    y, vjp_fn, aux = jax.vjp(f, params, *xs, has_aux=True)
    cot = rng.standard_normal(y.shape).astype(np.float32)
    grads = vjp_fn(jnp.asarray(cot))
    if dropouts:
        dropout_masks(port, aux["intermediates"], dropouts)
    port.train()
    xt = [torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
          for x in inputs]
    out = (call_port or (lambda m, *a: m(*a)))(port, *xt)
    out.backward(torch.from_numpy(cot).permute(0, 3, 1, 2))
    close(out.detach().permute(0, 2, 3, 1).numpy(), y, "output")
    for i, x in enumerate(xt):
        close(x.grad.permute(0, 2, 3, 1).numpy(), grads[1 + i], f"input {i} gradient")
    got = dict(port.named_parameters())
    want = port_named(jax_to_py(grads[0]), port_name)
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        g = np.zeros_like(w) if got[k].grad is None else got[k].grad.numpy()
        if np.abs(w).max() <= ZERO_GRAD * top:
            # a structurally zero gradient (a bias that a train-mode BN's
            # mean removes): rounding noise on both sides
            assert np.abs(g).max() <= ZERO_GRAD * top, k
        elif w.size == 1:
            # a PReLU slope: one sum over the whole map, whose terms cancel
            # (measured 1.1e-4 between runs on other thread counts)
            close(g, w, k, SCALAR_GRAD)
        else:
            close(g, w, k)
    sd = port.state_dict()
    for k, w in port_named(jax_to_py(aux["batch_stats"]), port_name).items():
        np.testing.assert_allclose(sd[k].numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)


def port_from_jax(cfg, params, stats):
    """A fresh port model of ``cfg``, built on the meta device (no init
    draws) and loaded strictly through ``from_jax_variables``, in eval mode
    and channels_last as ``build_model`` returns it."""
    with torch.device("meta"):
        model = build_model(cfg, device="meta")
    model.load_state_dict(from_jax_variables(params, stats), strict=True, assign=True)
    return model.to(memory_format=torch.channels_last).eval()


def assert_same_tree(a, b, path=""):
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for k in a:
        if isinstance(a[k], Mapping):
            assert_same_tree(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{path}/{k}")


def close(got, want, what, scale=1e-4):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=scale * max(np.abs(want).max(), 1e-30), err_msg=what)


def assert_stats_match(model, stats_tree, tol=1e-4):
    want = {k: v.numpy() for k, v in from_jax_variables({}, stats_tree).items()
            if not k.endswith("num_batches_tracked")}
    sd = model.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(sd[k].numpy(), w, rtol=tol, atol=tol * np.abs(w).max(),
                                   err_msg=k)


def dropout_masks(model, intermediates, dropouts):
    """Makes each of the port's ``dropouts`` ({port Dropout: JAX path of its
    nn.Dropout}) use JAX's mask, read off the captured dropout output."""
    for drop, path in dropouts.items():
        node = intermediates
        for p in path:
            node = node[p]
        out = np.asarray(node["__call__"][0])                        # NHWC
        keep = torch.from_numpy(out != 0).permute(0, 3, 1, 2)
        if drop.spatial:
            keep = keep.any(dim=(2, 3), keepdim=True)
        drop.keep_mask = lambda x, keep=keep: keep


def aspp_dropout(model):
    head = model.classifier
    aspp = head.aspp if isinstance(head, deeplab.DeepLabHeadV3Plus) else head[0]
    return aspp.project[3]


# ---- forward ---------------------------------------------------------------

OUTPUTS = ("seg_beforeup", "fine_feat", "fine_feat0", "seg", "weather_logits")


def check_forward(rng, arch, backbone, output_stride, separable, train=True):
    """The eval forward of one configuration against JAX, the weights both
    ways, and with ``train`` the train forward (outputs, supcon projection,
    BN running statistics)."""
    name = f"{arch}_{'mobilenet' if backbone == 'mobilenetv2' else backbone}"
    cfg = Config(model=name, compute_dtype="float32", output_stride=output_stride,
                 separable_conv=separable, criterion=CRITERION)
    model = build_model(cfg, device="cpu")
    randomize_bn(model, rng)
    jmodel = jdl.DeepLabDCSS(arch=arch, backbone=backbone, output_stride=output_stride,
                             separable=separable)
    x = rng.uniform(0, 255, (2 * B_TRAIN, S, S, 3)).astype(np.float32)
    params, stats = jax_tree_from_port(model, jmodel, jnp.asarray(x), train=True,
                                       return_supcon_feature=True)
    if not separable:
        sd = {k: v.numpy() for k, v in model.state_dict().items()
              if k.startswith(("backbone.", "classifier."))}
        back_p, back_s = convert_reference_deeplab(sd)
        assert_same_tree(back_p, {k: params[k] for k in ("backbone", "classifier")})
        assert_same_tree(back_s, stats)
    port = port_from_jax(cfg, params, stats)
    for k, v in port.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k

    want = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x[:B]))
    with torch.no_grad():
        got = port(torch.from_numpy(x[:B]))
    for k in OUTPUTS:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        close(got[k].numpy(), want[k], f"eval {k}")
    if not train:
        return

    want, mut = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             train=True, return_supcon_feature=True,
                             mutable=["batch_stats", "intermediates"],
                             capture_intermediates=True, rngs={"dropout": jax.random.PRNGKey(3)})
    port.train()
    dropout_masks(port, mut["intermediates"], {aspp_dropout(port): ("classifier", "aspp",
                                                                   "drop")})
    with torch.no_grad():
        got = port(torch.from_numpy(x), return_supcon_feature=True)
    for k in OUTPUTS + ("supcon_proj",):
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        close(got[k].numpy(), want[k], f"train {k}", TRAIN_TOL)
    assert_stats_match(port, jax_to_py(mut["batch_stats"]), TRAIN_TOL)


@pytest.mark.parametrize("arch,backbone,output_stride,separable,train", [
    ("deeplabv3plus", "resnet50", 16, False, True),
    ("deeplabv3", "resnet50", 8, True, True),
    ("deeplabv3plus", "resnet101", 8, True, False),
])
def test_resnet_forward_matches_jax(rng, arch, backbone, output_stride, separable, train):
    check_forward(rng, arch, backbone, output_stride, separable, train)


# ---- serving, routes -----------------------------------------------------------

@pytest.mark.parametrize("name", ["deeplabv3plus_resnet50", "deeplabv3_resnet50"])
def test_generic_serving_matches_jax(rng, name):
    """JAX ``make_serving_fn``'s generic branch at f32: V3+ (``seg_beforeup``
    at 1/4: its ×4 upsample-argmax) and V3 (1/16: the argmax of ``seg``);
    labels equal, and no kernel of the SwiftNet routes launched."""
    cfg = Config(model=name, compute_dtype="float32")
    model = build_model(cfg, device="cpu")
    randomize_bn(model, rng)
    jcfg = parse_args(["--model", name, "--compute_dtype", "float32"])
    jmodel = jax_build_model(jcfg)
    x = rng.uniform(0, 255, (B, S, S, 3)).astype(np.float32)
    params, stats = jax_tree_from_port(model, jmodel, jnp.asarray(x))
    want = np.asarray(jax_serving(jmodel)({"params": params, "batch_stats": stats},
                                          jnp.asarray(x)))
    before = (seghead.fused_seghead_upsample_argmax.launches, stem.fused_stem_pool.launches,
              blend.fused_upsample_blend.launches)
    got = make_serving_fn(port_from_jax(cfg, params, stats), device="cpu")(x)
    assert got.dtype == torch.int8 and tuple(got.shape) == (B, S, S)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (seghead.fused_seghead_upsample_argmax.launches, stem.fused_stem_pool.launches,
            blend.fused_upsample_blend.launches) == before


def test_build_model_routes_every_deeplab_name():
    """Each DeepLab name of JAX's ``MODELS`` (read the same way under
    ``--deeplab``) gives its head and backbone, with the backbone's width in
    the weather and projection heads (built on the meta device: shapes
    only); ``build_model`` itself on two of them, and its refusal of a
    non-DeepLab name under ``--deeplab``, as JAX's."""
    widths = {"resnet50": 2048, "resnet101": 2048, "mobilenet": 320, "xception": 2048,
              "hrnetv2_32": 480, "hrnetv2_48": 720}
    for name in (m for m in MODELS if m.startswith("deeplabv3")):
        arch, bb = name.split("_", 1)
        cfg = Config(model=name, deeplab=True, compute_dtype="float32", criterion=CRITERION)
        with torch.device("meta"):
            model = deeplab.build_deeplab_dcss(cfg, torch.float32)
        head = deeplab.DeepLabHeadV3Plus if arch == "deeplabv3plus" else deeplab.DeepLabHead
        assert isinstance(model.classifier, head)
        assert model.weather_clf.fc.in_features == widths[bb] == model.projection.fc1.in_features
    for name in ("deeplabv3plus_mobilenet", "deeplabv3_mobilenet"):
        model = build_model(Config(model=name, compute_dtype="float32"), device="cpu")
        assert isinstance(model, deeplab.DeepLabDCSS) and not model.training
        assert model.projection is None and model.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="deeplab model resnet18"):
        build_model(Config(model="resnet18", deeplab=True), device="cpu")
