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
    with pytest.raises(ValueError, match="multiple of 4"):
        serve(x[:, :122])  # the ×4 head cannot make 122 rows


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(Config())
    model = build_model(Config(compute_dtype="float32"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_serving_fn(model)
