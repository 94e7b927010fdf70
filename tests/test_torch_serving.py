"""The port's serving function on the CPU vs the JAX one on the same
converted weights, and the entry points' device rule."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.models.serving import (  # noqa: E402
    make_serving_fn as jax_make_serving_fn)
from doubly_contrastive_semseg_tpu_torch import Config, build_model, make_serving_fn  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops import (  # noqa: E402
    fused_seghead_upsample_argmax, fused_stem_pool)

from test_torch_model import jax_variables, port_model  # noqa: E402

SHAPE = (2, 128, 256, 3)


def test_serving_matches_jax(rng):
    jmodel, params, stats = jax_variables(rng, SHAPE)
    x = rng.uniform(0, 255, SHAPE).astype(np.float32)
    want = np.asarray(jax_make_serving_fn(jmodel)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    serve = make_serving_fn(port_model(params, stats), device="cpu")
    counts = (fused_stem_pool.launches, fused_seghead_upsample_argmax.launches)
    got = serve(x).numpy()
    # the CPU path runs the plain versions and launches no kernel
    assert counts == (fused_stem_pool.launches, fused_seghead_upsample_argmax.launches)
    assert got.shape == want.shape == SHAPE[:3] and got.dtype == np.int8
    assert (got == want.astype(np.int8)).mean() >= 0.999


def test_serving_matches_full_forward_argmax(rng):
    """The head path (no full-res logits) equals argmax of the model's own
    ``seg`` output."""
    model = build_model(Config(compute_dtype="float32"), device="cpu")
    serve = make_serving_fn(model, device="cpu")
    x = torch.from_numpy(rng.uniform(0, 255, (1, 128, 128, 3)).astype(np.float32))
    with torch.no_grad():
        want = model(x)["seg"].argmax(-1)
    assert (serve(x).long() == want).float().mean() >= 0.999
    # 122 rows: the ×4 head would make 124, so the full-resolution argmax
    got = serve(x[:, :122])
    with torch.no_grad():
        want = model(x[:, :122])["seg"].argmax(-1)
    assert got.shape == (1, 122, 128) and got.dtype == torch.int8
    assert torch.equal(got.long(), want)


def test_serving_size_not_multiple_of_4_matches_jax(rng):
    """(1, 126, 250): 4 × the features is 128 × 252, so both take the
    argmax of the full-resolution logits."""
    shape = (1, 126, 250, 3)
    jmodel, params, stats = jax_variables(rng, shape)
    x = rng.uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(jax_make_serving_fn(jmodel)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    got = make_serving_fn(port_model(params, stats), device="cpu")(x).numpy()
    assert got.shape == want.shape == shape[:3] and got.dtype == np.int8
    assert (got == want.astype(np.int8)).mean() >= 0.999


def test_serving_without_fused_head(rng):
    """``use_fused_head=False`` takes the ×4 upsample-argmax of the seg
    logits: the argmax of the model's own ``seg``."""
    model = build_model(Config(compute_dtype="float32"), device="cpu", seed=3)
    x = torch.from_numpy(rng.uniform(0, 255, (1, 128, 256, 3)).astype(np.float32))
    counts = (fused_stem_pool.launches, fused_seghead_upsample_argmax.launches)
    got = make_serving_fn(model, device="cpu", use_fused_head=False)(x)
    assert counts == (fused_stem_pool.launches, fused_seghead_upsample_argmax.launches)
    with torch.no_grad():
        want = model(x)["seg"].argmax(-1)
    assert got.shape == (1, 128, 256) and got.dtype == torch.int8
    assert torch.equal(got.long(), want)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(Config())
    model = build_model(Config(compute_dtype="float32"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_serving_fn(model)
