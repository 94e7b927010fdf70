"""``--num_devices`` N (``parallel/``) against one process on the global
batch, on the CPU: two gloo ranks spawned by ``parallel.spawn_ranks``
through ``tools/check_parallel.py``, one spawn a test.

Held, each of max|·| of the one-process tensor:

- the flagship ``supcon_pixelcontrast_focal`` step (random pixel-contrast
  anchors drawn whole on each rank, SupCon and the anchors gathered) and
  ``plain_focal``, and the stereo step (StereoNet aggregation and
  refinement, disparities with holes, ``--train_semantic`` labels) at
  float64: the loss components, every BN running mean and variance and
  every parameter after one SGD update at 1e-5 (measured: 1e-7 and below);
- the same steps at float32: the loss at 1e-5 and the running statistics
  at 1e-4. Their parameters are not held at float32: the ranks' BN moments
  differ from one process's in the last bits, which flips a few ReLU gates
  (measured: 2.7e-2 of a tensor's max on the flagship step's BN biases,
  3.1e-1 on the stereo step's), and float64 shows the gradients are the
  same function;
- the flagship loss of two ranks against JAX's ``make_mesh(2)`` loss on the
  same variables and batch (``--reference_rng`` anchors), rtol 1e-4;
- the eval step's confusion matrices, ``n_batches`` and ``weather_acc_sum``
  over a val batch of 3 frames and a last batch of 1 (one rank empty):
  equal; a stereo val batch's EPE, D1 and >1 px sums at 1e-6.

The processes run with 2 torch threads.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from doubly_contrastive_semseg_tpu_torch.tools import check_parallel as cp  # noqa: E402
from test_torch_deeplab import few_threads  # noqa: E402,F401

F64_TOL = 1e-5


def held(res, loss, params=None, bn_stats=None):
    assert res["loss"] <= loss, res
    if params is not None:
        assert res["params"] <= params, res
    if bn_stats is not None:
        assert res["bn_stats"] <= bn_stats, res


def jax_mesh_loss(variables, b, s):
    """JAX ``compute_total_loss`` of the training forward from ``variables``
    (params, batch_stats) on a 2-device mesh (JAX ``parallel/mesh.py::
    shard_batch``) of ``check_parallel.flagship_batch(b, s)``."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from doubly_contrastive_semseg_tpu.config import parse_args
    from doubly_contrastive_semseg_tpu.losses import compute_total_loss
    from doubly_contrastive_semseg_tpu.models import build_model as jax_build_model
    from doubly_contrastive_semseg_tpu.parallel.mesh import (make_mesh, replicate_sharding,
                                                             shard_batch)
    from doubly_contrastive_semseg_tpu.train.steps import ingest_batch

    params, stats = variables
    jcfg = parse_args(["--dataset", "synthetic", "--criterion", "supcon_pixelcontrast_focal",
                       "--batch_size", str(b), "--compute_dtype", "float32",
                       "--reference_rng"])
    jmodel = jax_build_model(jcfg)
    mesh = make_mesh(2)
    batch = cp.flagship_batch(b, s)
    db = shard_batch(batch, mesh)
    db["class_weight"] = jax.device_put(jnp.asarray(cp.class_weight()), replicate_sharding(mesh))

    def loss_fn(params, stats, batch):
        batch = ingest_batch(batch)
        outputs, _ = jmodel.apply({"params": params, "batch_stats": stats}, batch["left"],
                                  train=True, return_supcon_feature=True,
                                  mutable=["batch_stats"])
        return compute_total_loss(jcfg, outputs, batch, batch["class_weight"],
                                  jax.random.PRNGKey(1))[0]

    return float(jax.jit(loss_fn)(params, stats, db))


def test_flagship_step_matches_one_process_and_jax_mesh(tmp_path):
    """The flagship and ``plain_focal`` steps, two ranks against one process
    (float64 and float32), and the two-rank loss against JAX's 2-device
    mesh."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from doubly_contrastive_semseg_tpu.models import build_model as jax_build_model
    from doubly_contrastive_semseg_tpu.config import parse_args
    from doubly_contrastive_semseg_tpu_torch.utils import from_jax_variables
    from test_torch_swiftnet_single import random_variables

    b, s = 4, 64
    jcfg = parse_args(["--dataset", "synthetic", "--criterion", "supcon_pixelcontrast_focal",
                       "--compute_dtype", "float32"])
    rng = np.random.default_rng(0)
    params, stats = random_variables(
        jax_build_model(jcfg), jnp.zeros((2 * b, s, s, 3), jnp.float32), rng, train=True,
        return_supcon_feature=True)
    state_path = str(tmp_path / "jax_variables.pt")
    torch.save(from_jax_variables(params, stats), state_path)

    jobs = [("flagship", {"dtype": "float64"}), ("flagship", {"dtype": "float32"}),
            ("flagship", {"criterion": "plain_focal", "dtype": "float64"}),
            ("flagship", {"criterion": "plain_focal", "dtype": "float32"}),
            ("flagship", {"dtype": "float32", "reference_rng": True, "state_path": state_path})]
    many = cp.run_ranks(jobs)
    one = cp.run_one(jobs[:4])
    for (case, kw), m, o in zip(jobs, many, one):
        res = cp.differences(m, o)
        if kw["dtype"] == "float64":
            held(res, F64_TOL, F64_TOL, F64_TOL)
        else:
            held(res, 1e-5, bn_stats=1e-4)
    assert many[0]["metrics"]["supcon_loss"] > 0 and many[0]["metrics"]["pixelcontrast_loss"] > 0
    want = jax_mesh_loss((params, stats), b, s)
    np.testing.assert_allclose(many[4]["metrics"]["total_loss"], want, rtol=1e-4)


def test_stereo_step_matches_one_process():
    """The stereo step (its trunk's BN moments over both views of the global
    batch, the disparity and semantic losses over its valid pixels), two
    ranks against one process."""
    jobs = [("stereo", {"dtype": "float64"}), ("stereo", {"dtype": "float32"})]
    for (case, kw), m, o in zip(jobs, cp.run_ranks(jobs), cp.run_one(jobs)):
        res = cp.differences(m, o)
        if kw["dtype"] == "float64":
            held(res, F64_TOL, F64_TOL, F64_TOL)
        else:
            held(res, 1e-5, bn_stats=1e-4)
        assert set(m["metrics"]) == {"disp_loss", "seg_loss", "total_loss"}


def test_eval_sums_match_one_process():
    """Val batches of 3 frames and of 1 (rank 1 without a frame): the
    summed accumulators equal one process's, ``n_batches`` counting global
    batches; a stereo val batch's metric sums."""
    jobs = [("eval", {}), ("stereo_eval", {})]
    many, one = cp.run_ranks(jobs), cp.run_one(jobs)
    for k, want in one[0]["accum"].items():
        np.testing.assert_array_equal(many[0]["accum"][k].numpy(), want.numpy(), err_msg=k)
    assert float(one[0]["accum"]["n_batches"]) == 2.0 and one[0]["accum"]["cm"].sum() > 0
    np.testing.assert_allclose(many[1]["sums"].numpy(), one[1]["sums"].numpy(), rtol=1e-6)
    assert float(one[1]["sums"][3]) > 0


def test_shard_rows_and_draws():
    """``row_index`` and ``rand_rows`` on a fake split of 5 samples over 2
    ranks (3 + 2): a two-view tensor's rows, a sample-major one's, and the
    draws of rank 1 those of one process's global draw."""
    from doubly_contrastive_semseg_tpu_torch import parallel

    w = parallel.world()
    saved = (w.rank, w.size, w.rows)
    try:
        w.rank, w.size, w.rows = 1, 2, (3, 2)
        assert parallel.row_index(4, blocks=2).tolist() == [3, 4, 8, 9]
        assert parallel.row_index(6).tolist() == [9, 10, 11, 12, 13, 14]
        assert parallel.global_rows(6) == 15
        g = torch.Generator().manual_seed(3)
        got = parallel.rand_rows((4, 7), g, "cpu", blocks=2)
        want = torch.rand((10, 7), generator=torch.Generator().manual_seed(3))[[3, 4, 8, 9]]
        assert torch.equal(got, want)
        batch = parallel.shard_batch({"left": np.arange(10), "label": np.arange(5),
                                      "left_name": list("abcde"), "scalar": np.int32(3)})
        assert batch["left"].tolist() == [3, 4, 8, 9] and batch["label"].tolist() == [3, 4]
        assert batch["left_name"] == ["d", "e"] and w.rows == (3, 2) and batch["scalar"] == 3
        batch = parallel.shard_batch({"label": np.arange(1)})
        assert w.rows == (1, 0) and len(batch["label"]) == 0
    finally:
        w.rank, w.size, w.rows = saved
    assert parallel.split_sizes(7, 3) == [3, 2, 2]
    assert [len(c) for c in torch.arange(7).tensor_split(3)] == [3, 2, 2]
    assert not os.environ.get("WORLD_SIZE")
