"""The port's trainable blocks vs the JAX package's, one block at a time, in
training mode: the same weights (through ``from_jax_variables``), the same
numpy input and the same output cotangent, then the output, the updated BN
running stats, and the gradients of the input and of every parameter.

One block has few ReLUs, so on these inputs no ReLU input lies within the
two f32 forwards' rounding (~1e-7) of 0 and no gate flips between the
frameworks (the whole-model check in ``test_torch_train.py`` explains why
that matters): gradients are held to 1e-4 × max|g| of each tensor,
outputs to 1e-4 × max|y|, running stats to rtol 1e-4 with an atol of
1e-4 × the tensor's largest entry.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.models import blocks as jblocks  # noqa: E402
from doubly_contrastive_semseg_tpu.models import resnet_pyramid as jrp  # noqa: E402
from doubly_contrastive_semseg_tpu.models import weathernet as jwn  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.torch_convert import jax_to_py  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models import blocks, resnet_pyramid, weathernet  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import from_jax_variables  # noqa: E402


def _randomize_bn(params, stats, rng):
    for key, node in stats.items():
        if "mean" in node:
            c = node["mean"].shape
            node["mean"] = rng.normal(0.0, 0.1, c).astype(np.float32)
            node["var"] = rng.uniform(1.0, 2.0, c).astype(np.float32)
            params[key]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            params[key]["bias"] = rng.normal(0.0, 0.3, c).astype(np.float32)
        else:
            _randomize_bn(params[key], node, rng)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                               err_msg=what)


def _check(jmod, jargs, port, rng, inputs, call_port, **jkw):
    """Runs the JAX module (params from ``jmod.init``, BN randomised) and
    ``port`` (loaded with the same variables) on ``inputs`` (NHWC numpy)
    with one random output cotangent; compares everything."""
    v = jmod.init(jax.random.PRNGKey(0), *[jnp.asarray(x) for x in inputs], *jargs, **jkw)
    params, stats = jax_to_py(v["params"]), jax_to_py(v.get("batch_stats", {}))
    _randomize_bn(params, stats, rng)

    def f(p, *xs):
        return jmod.apply({"params": p, "batch_stats": stats}, *xs, *jargs,
                          mutable=["batch_stats"], **jkw)

    y, vjp_fn, upd = jax.vjp(f, params, *[jnp.asarray(x) for x in inputs], has_aux=True)
    cot = rng.standard_normal(y.shape).astype(np.float32)
    grads = vjp_fn(jnp.asarray(cot))

    port.load_state_dict(from_jax_variables(params, stats), strict=True)
    port.train()
    xs = [_nchw(x) for x in inputs]
    out = call_port(port, *xs)
    out.backward(torch.from_numpy(cot).permute(0, 3, 1, 2))
    _close(out.detach().permute(0, 2, 3, 1).numpy(), y, "output")
    for i, x in enumerate(xs):
        _close(x.grad.permute(0, 2, 3, 1).numpy(), grads[1 + i], f"input {i} gradient")
    want_g = from_jax_variables(jax_to_py(grads[0]), {})
    got = dict(port.named_parameters())
    assert set(got) == set(want_g)
    for k, w in want_g.items():
        _close(got[k].grad.numpy(), w.numpy(), k)
    want_s = from_jax_variables({}, jax_to_py(upd["batch_stats"]))
    sd = port.state_dict()
    for k, w in want_s.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-4 * np.abs(w.numpy()).max(), err_msg=k)


@pytest.mark.parametrize("cin,planes,stride", [(64, 64, 1), (64, 128, 2)])
@pytest.mark.parametrize("efficient", [False, True])
def test_basic_block_train_matches_jax(rng, cin, planes, stride, efficient):
    """Checkpointed (efficient) blocks fold bn1/bn2's moments into the
    running stats twice, JAX's ``update_passes=2`` with one level."""
    x = rng.standard_normal((2, 16, 16, cin)).astype(np.float32)
    jmod = jrp.BasicBlock(planes=planes, stride=stride,
                          bn_update_passes=2 if efficient else 1)
    port = resnet_pyramid.BasicBlock(cin, planes, stride, efficient=efficient)
    _check(jmod, (True, 0, 1), port, rng, [x], lambda m, x: m(x))
    # forward and, when checkpointed, the recompute in the backward
    assert int(port.bn1.num_batches_tracked) == (2 if efficient else 1)
    if port.downsample is not None:  # never checkpointed
        assert int(port.downsample[1].num_batches_tracked) == 1


def test_upsample_blend_train_matches_jax(rng):
    x = rng.standard_normal((2, 6, 8, 128)).astype(np.float32)
    skip = rng.standard_normal((2, 12, 16, 128)).astype(np.float32)

    _check(jblocks.UpsampleBlend(128), (), blocks.UpsampleBlend(128), rng, [x, skip],
           lambda m, x, s: m(x, s), train=True)


def test_seg_head_train_matches_jax(rng):
    x = rng.standard_normal((2, 12, 16, 128)).astype(np.float32)

    _check(jblocks.BNReluConv(19, k=1, bias=True), (),
           blocks.BNReluConv(128, 19, k=1, bias=True), rng, [x], lambda m, x: m(x),
           train=True)


def test_projection_head_grad_matches_jax(rng):
    x = rng.standard_normal((4, 2, 128)).astype(np.float32)
    jhead = jwn.ProjectionHead()
    params = jax_to_py(jhead.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    y, vjp_fn = jax.vjp(lambda p, xx: jhead.apply({"params": p}, xx), params, jnp.asarray(x))
    cot = rng.standard_normal(y.shape).astype(np.float32)
    gp, gx = vjp_fn(jnp.asarray(cot))
    head = weathernet.ProjectionHead(128, 128)
    head.load_state_dict(from_jax_variables(params, {}), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = head(xt)
    out.backward(torch.from_numpy(cot))
    _close(xt.grad.numpy(), gx, "input gradient")
    for k, w in from_jax_variables(jax_to_py(gp), {}).items():
        _close(dict(head.named_parameters())[k].grad.numpy(), w.numpy(), k)
