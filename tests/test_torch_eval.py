"""The port's eval step (``train/steps.py::make_eval_step``) vs the JAX
package's on the same weights and batches, and the fused upsample-blend
inside the model's decoder.

Two f32 forwards differ by ~1e-5 of the logits' scale, so a pixel whose two
best classes lie that close flips its argmax (``ROADMAP.md`` §3): preds are
held to ≥ 99.9 % agreement, and the semantic confusion matrices to the
flips (each flipped pixel with a valid label moves one count from one cell
to another, so the matrices differ by at most 2 × flips in L1, and not at
all where nothing flipped). The weather head's four logits have no such
near-ties here: its accumulators are held exactly.
"""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.train.steps import init_eval_accum as jax_init_accum  # noqa: E402
from doubly_contrastive_semseg_tpu.train.steps import make_eval_step as jax_make_eval_step  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import Config, build_model  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models import blocks  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops import fused_upsample_blend  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.tools.profile_eval import set_fused  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.train import init_eval_accum, make_eval_step  # noqa: E402

from test_torch_model import jax_variables, port_model  # noqa: E402

SHAPE = (2, 128, 256, 3)
C, W = 19, 4


def eval_batch(rng, shape=SHAPE):
    b, h, w, _ = shape
    label = rng.integers(0, C, (b, h, w)).astype(np.uint8)
    label[rng.random((b, h, w)) < 0.1] = 255
    return {"left": rng.integers(0, 256, shape).astype(np.uint8), "label": label,
            "weather": rng.integers(0, W, (b,)).astype(np.int32)}


@pytest.fixture(scope="module")
def jax_vars():
    """The JAX model and its variables (BN randomised), built once: the
    weights do not depend on the input shape."""
    return jax_variables(np.random.default_rng(0), SHAPE)


def test_eval_step_matches_jax(rng, jax_vars):
    jmodel, params, stats = jax_vars
    cfg = types.SimpleNamespace(num_classes=C, weather_num=W, dataset="acdc")
    jax_step = jax_make_eval_step(jmodel, cfg)
    step = make_eval_step(port_model(params, stats), Config(compute_dtype="float32"))
    accum_j, accum = jax_init_accum(cfg), init_eval_accum(Config(), device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in accum.items()} == \
        {k: (tuple(v.shape), "torch.float32") for k, v in accum_j.items()}
    flips = 0
    for _ in range(2):
        batch = eval_batch(rng)
        preds_j, accum_j = jax_step(params, stats, {k: jnp.asarray(v) for k, v in batch.items()},
                                    accum_j)
        preds, accum = step({k: torch.from_numpy(v) for k, v in batch.items()}, accum)
        assert preds.dtype == torch.int32 and tuple(preds.shape) == SHAPE[:3]
        differ = preds.numpy() != np.asarray(preds_j)
        assert differ.mean() <= 1e-3
        flips += int((differ & (batch["label"] < C)).sum())
    got = {k: v.numpy() for k, v in accum.items()}
    want = {k: np.asarray(v) for k, v in accum_j.items()}
    for k in ("cm_weather", "weather_acc_sum", "n_batches"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["n_batches"] == 2 and want["cm"].sum() == (got["cm"].sum())
    for k in ("cm", "cm_weather_sem"):
        l1 = np.abs(got[k] - want[k]).sum()
        assert l1 <= 2 * flips, (k, l1, flips)
        if flips == 0:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_eval_step_without_label_or_weather_dataset(rng):
    """No label: only the weather accumulators move. Not a weather dataset:
    only ``cm``."""
    model = build_model(Config(compute_dtype="float32"), device="cpu", seed=3)
    batch = {k: torch.from_numpy(v) for k, v in eval_batch(rng, (1, 64, 64, 3)).items()}
    zero = init_eval_accum(Config(), device="cpu")
    _, acc = make_eval_step(model, Config())({"left": batch["left"],
                                              "weather": batch["weather"]}, zero)
    assert acc["cm"].sum() == 0 and acc["cm_weather_sem"].sum() == 0
    assert acc["cm_weather"].sum() == 1 and acc["n_batches"] == 1
    _, acc = make_eval_step(model, Config(dataset="cityscapes"))(batch, zero)
    assert acc["cm"].sum() == (batch["label"] < C).sum()
    assert acc["cm_weather_sem"].sum() == acc["cm_weather"].sum() == acc["n_batches"] == 0
    assert all(v.sum() == 0 for v in zero.values())  # the input accum is not modified


def test_fused_blend_in_the_decoder(rng, jax_vars, monkeypatch):
    """At 1×256×256 the decoder's blends output 4², 8², 16², 32² and 64²:
    only the last passes the JAX guard (≥ 64 rows, multiples of 8), so the
    fused step runs once a forward. On the CPU it is the kernel's plain
    version (bf16 inside), so the labels match the unfused f32 model's to
    ≥ 0.99. The weights come from JAX through ``from_jax_variables``: the
    fused step reads ``upsample_blends5.blend_conv.{conv,norm}``, which the
    converter already fills."""
    model = port_model(*jax_vars[1:])
    x = torch.from_numpy(rng.uniform(0, 255, (1, 256, 256, 3)).astype(np.float32))
    with torch.no_grad():
        want = model(x)["seg"].argmax(-1)
    calls = []

    def spy(*args, **kw):
        calls.append(tuple(args[1].shape))
        return fused_upsample_blend(*args, **kw)

    monkeypatch.setattr(blocks, "fused_upsample_blend", spy)
    set_fused(model, True)
    before = fused_upsample_blend.launches
    with torch.no_grad():
        got = model(x)["seg"].argmax(-1)
    assert calls == [(1, 64, 64, 128)]
    assert fused_upsample_blend.launches == before  # CPU: plain version only
    assert (got == want).float().mean().item() >= 0.99
    model.train()  # training mode never fuses
    with torch.no_grad():
        model(x)
    assert len(calls) == 1
