"""The width-split forward and serving of ``DCSSModel`` (resnet18) over a
``('data', 'model')`` grid of ranks (``parallel/spatial.py``), the port's
counterpart of JAX's ``test_parallel.py::
test_spatial_sharding_inference_parity``, on the CPU: four gloo ranks
spawned once through ``tools/check_parallel.py`` for a (1, 4) and a (2, 2)
grid, the weights JAX's (random BN statistics) through
``from_jax_variables``.

Held (measured on this CPU at f32, in brackets):

- JAX's own case, a (1, 4) grid at 128×256: the gathered ``seg`` against
  JAX's unsharded eval forward's (``DCSSModel.apply(train=False)``, the
  first view of its two-view call: see ``runs``) at JAX's rtol
  3e-4 / atol 3e-4, and against the port's one-process forward within 1e-5
  of max|seg| [6.5e-7]; the deepest map (level 2, stage 4) is 2 columns,
  so ranks 2 and 3 own none of ``skips_0``;
- a (2, 2) grid on a batch of 2 [9.3e-7] and the odd width 128×250, whose
  half width 125 ``pyramid_hw`` pads to 126 at level 1 and whose decoder
  resizes 32 → 63 and 63 → 250 columns [9.3e-7], at the same bounds;
- the two-view forward (``return_supcon_feature``) of a model with the
  projection head on a (1, 4) and a (2, 2) grid: ``fine_feat0`` [4.7e-7,
  5.0e-7] and ``supcon_proj`` [1.2e-7, 1.5e-7], the projection of both
  views' model-group pools, against one process's within 1e-5 of max, and
  ``supcon_proj``, ``seg`` and ``weather_logits`` against JAX's at its
  bound;
- ``weather_logits`` from the model-group mean: equal on every rank of a
  group, within 1e-5 of one process [1.2e-7] and JAX's bound of JAX's;
- the serving labels (K1's plain version on each rank's window) equal to
  the one-process serve's on every decided pixel (the top-two gap of the
  logits above twice the largest ``seg_beforeup`` difference; [all pixels
  equal]);
- the rules of ``spatial.py`` on one process, each rank's output computed
  from the window its rule fetches, float64, to 1e-12 of max: ranges,
  convs of every (k, s, p) of the path against ``F.conv2d`` (uneven and
  empty ranges; stride-2 ranges that do not nest), the bilinear resizes and
  the pyramid's bicubic levels against ``F.interpolate`` and
  ``build_pyramid`` (global edges versus shard edges: zero padding, the
  clamp, the replicate column of ``pyramid_hw``'s level 1), K2's windows
  (its stride phase: a left end that is a multiple of 4) and K1's (its 4 to
  1 column crop) against their plain versions on the whole map;
- the refusals: training, another backbone and ``fuse_inference`` raise;
- a (N, 1) grid shards the batch and draws rows as one data axis does, bit
  for bit.
"""

import contextlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu_torch import (Config, build_model, make_serving_fn,  # noqa: E402
                                                parallel)
from doubly_contrastive_semseg_tpu_torch.models.blocks import Conv2d, conv_cols  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops import input_pipeline, seghead, stem  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops.interpolate import (  # noqa: E402
    resize_bilinear, resize_bilinear_cols)
from doubly_contrastive_semseg_tpu_torch.parallel import spatial  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.tools import check_parallel as cp  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import from_jax_variables  # noqa: E402
from test_torch_deeplab import few_threads  # noqa: E402,F401
from test_torch_model import JaxProjectionHead, jax_to_py, jax_variables  # noqa: E402

H, W, W_ODD = 128, 256, 250
JAX_TOL = dict(rtol=3e-4, atol=3e-4)      # JAX's own bound for its sharded forward
ONE_TOL = 1e-5                            # of max|·| of the one-process output


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's unsharded eval forward, then the grids' and one process's
    ``spatial`` results on the same weights: {case: (grid, one process)},
    and "jax": {width or "supcon": JAX outputs}. One JAX model with the
    projection head (random BN statistics); its two-view eval forward on
    ``spatial_image(2, H, W, 0)`` and ``(2, H, W, 1)`` gives ``supcon_proj``
    and, from the first view alone, the plain eval forward's ``seg`` and
    ``weather_logits`` of ``spatial_image(b, H, W)`` (whose b = 1 sample is
    the first of b = 2). The grids without views load the weights less the
    projection head."""
    rng = np.random.default_rng(0)
    # initialised at the odd case's shape, whose eager ops then compile once
    jmodel, plain, stats = jax_variables(rng, (1, H, W_ODD, 3))
    head = JaxProjectionHead().init(jax.random.PRNGKey(1), jnp.zeros((1, 2, 128)))
    params = dict(plain, projection=jax_to_py(head["params"]))
    variables = {"params": params, "batch_stats": stats}
    views = np.concatenate([cp.spatial_image(2, H, W, s) for s in (0, 1)])
    out = jmodel.apply(variables, jnp.asarray(views), train=False, return_supcon_feature=True)
    want = {"supcon": {k: np.array(out[k]) for k in ("seg", "weather_logits", "supcon_proj")}}
    want[W] = {k: want["supcon"][k] for k in ("seg", "weather_logits")}
    out = jmodel.apply(variables, jnp.asarray(cp.spatial_image(1, H, W_ODD)), train=False)
    want[W_ODD] = {k: np.array(out[k]) for k in ("seg", "weather_logits")}
    tmp = tmp_path_factory.mktemp("spatial")
    path, spath = str(tmp / "jax_variables.pt"), str(tmp / "jax_variables_supcon.pt")
    torch.save(from_jax_variables(plain, stats), path)
    torch.save(from_jax_variables(params, stats), spath)
    plan = [((1, 4), [("spatial", {"state_path": path}),
                      ("spatial", {"w": W_ODD, "state_path": path}),
                      ("spatial", {"supcon": True, "state_path": spath})]),
            ((2, 2), [("spatial", {"b": 2, "state_path": path}),
                      ("spatial", {"b": 2, "supcon": True, "state_path": spath})])]
    many = cp.run_grids(plan, 4)
    one = [cp.run_one(jobs) for _, jobs in plan]
    return {"jax_case": (many[0][0], one[0][0]), "odd": (many[0][1], one[0][1]),
            "supcon_1x4": (many[0][2], one[0][2]), "grid_2x2": (many[1][0], one[1][0]),
            "supcon_2x2": (many[1][1], one[1][1]), "jax": want}


def held_to_jax_and_one(many, one, want, rows=slice(None)):
    """Each of JAX's outputs in ``want`` at JAX's bound, every output
    within ``ONE_TOL`` of one process's."""
    for k in want:
        np.testing.assert_allclose(many[k].numpy(), want[k][rows], **JAX_TOL, err_msg=k)
    d = cp.spatial_differences(many, one)
    maps = [k for k in d if k not in ("labels", "labels_decided", "decided")]
    assert set(cp.SPATIAL_KEYS + ("weather_logits",)) <= set(maps), d
    for k in maps:
        assert d[k] <= ONE_TOL, (k, d)
    return d


def test_jax_case_on_a_1x4_grid(runs):
    """JAX's case: 128×256 on a (1, 4) grid; ranks 2 and 3 own no column of
    the deepest map and still join every collective."""
    many, one = runs["jax_case"]
    assert tuple(many["seg"].shape) == (1, H, W, 19)
    held_to_jax_and_one(many, one, runs["jax"][W], slice(0, 1))
    assert many["per_rank"]["skips_0_cols"] == [1, 1, 0, 0]
    assert many["per_rank"]["feat_cols"] == [16, 16, 16, 16]


def test_2x2_grid_with_a_batch_of_2(runs):
    """Two data rows of one sample each, every row width-split over 2."""
    many, one = runs["grid_2x2"]
    assert tuple(many["seg"].shape) == (2, H, W, 19)
    held_to_jax_and_one(many, one, runs["jax"][W])
    assert many["per_rank"]["feat_cols"] == [32, 32, 32, 32]


def test_uneven_width_with_the_pyramid_pad(runs):
    """128×250: 63 feature columns over 4 ranks (16, 16, 16, 15), level 1
    padded to 126 on the rank owning the right edge, non-integer resizes."""
    many, one = runs["odd"]
    assert tuple(many["seg"].shape) == (1, H, W_ODD, 19)
    held_to_jax_and_one(many, one, runs["jax"][W_ODD])
    assert many["per_rank"]["feat_cols"] == [16, 16, 16, 15]


@pytest.mark.parametrize("case, rows", [("supcon_1x4", slice(0, 1)), ("supcon_2x2", slice(None))])
def test_two_views_with_the_projection(runs, case, rows):
    """``return_supcon_feature`` on a (1, 4) and a (2, 2) grid: each rank
    takes both views of its samples, ``fine_feat0`` is the first view's
    columns, and ``supcon_proj`` projects both views' global pools (model
    group sums), the same on every rank: against JAX's and one process's."""
    many, one = runs[case]
    n = 1 if rows.stop == 1 else 2
    assert tuple(many["supcon_proj"].shape) == (n, 2, 128)
    assert tuple(many["fine_feat"].shape[:1]) == (2 * n,)
    assert tuple(many["fine_feat0"].shape[:1]) == (n,)
    d = held_to_jax_and_one(many, one, runs["jax"]["supcon"], rows)
    assert {"fine_feat0", "supcon_proj"} <= set(d)
    assert many["per_rank"]["supcon_spread"] == [0.0] * 4


@pytest.mark.parametrize("case", ["jax_case", "odd", "grid_2x2", "supcon_2x2"])
def test_global_pools_equal_on_every_rank(runs, case):
    many, one = runs[case]
    assert many["per_rank"]["weather_spread"] == [0.0] * 4
    d = cp.max_rel({"w": many["weather_logits"]}, {"w": one["weather_logits"]})
    assert d["w"] <= ONE_TOL


@pytest.mark.parametrize("case", ["jax_case", "odd", "grid_2x2", "supcon_2x2"])
def test_serving_labels_match_one_process(runs, case):
    """The grid's labels, each rank's columns through K1's window (the ×4
    upsample-argmax of the logits at 250, whose 4 × 63 is not the image's
    width, as one process and JAX do), against one process's."""
    many, one = runs[case]
    assert many["labels"].shape == one["labels"].shape and many["labels"].dtype == torch.int8
    d = cp.spatial_differences(many, one)
    assert d["labels_decided"] == 1.0 and d["decided"] >= 0.99, d


# ---- the rules of spatial.py, one rank at a time ---------------------------

@contextlib.contextmanager
def fake_grid(d, m, rank):
    """``world()`` as rank ``rank`` of a (d, m) grid, without a process
    group."""
    w = parallel.world()
    saved = (w.rank, w.size, w.axes, w.shape, w.coords, w.rows)
    w.rank, w.size, w.axes, w.shape = rank, d * m, ("data", "model"), (d, m)
    w.coords = (rank // m, rank % m)
    try:
        yield w
    finally:
        w.rank, w.size, w.axes, w.shape, w.coords, w.rows = saved


def across_ranks(fn, whole, dim, m):
    """``fn(own columns)`` on each of m ranks, ``fetch`` served from the
    whole map (``whole``, of the op's input), concatenated along ``dim``
    of the output: the op's whole output if every rank's window is right."""
    outs = []
    for k in range(m):
        def fetch(x, width, need, d):
            lo, hi = need[k]
            return whole.narrow(d, lo, hi - lo)
        with fake_grid(1, m, k), pytest.MonkeyPatch.context() as mp:
            mp.setattr(spatial, "fetch", fetch)
            a, b = spatial.cols(whole.shape[dim], m, k)
            outs.append(fn(whole.narrow(dim, a, b - a)))
    return outs


def close(got, want, tol=1e-12):
    assert got.shape == want.shape, (tuple(got.shape), tuple(want.shape))
    err = (got.double() - want.double()).abs().max().item()
    assert err <= tol * max(want.double().abs().max().item(), 1.0), err


@pytest.mark.parametrize("width, m", [(13, 4), (10, 3), (2, 4), (9, 2), (64, 4)])
def test_column_ranges_and_conv_windows(width, m):
    """``cols`` is ``tensor_split``'s; every (k, s, p) conv of the path,
    rank by rank (uneven, empty ranges; stride-2 ranges that do not nest),
    against ``F.conv2d`` on the whole map."""
    chunks = [c.tolist() for c in torch.arange(width).tensor_split(m)]
    assert [list(range(a, b)) for a, b in spatial.ranges(width, m)] == chunks
    g = torch.Generator().manual_seed(width)
    x = torch.randn(2, 5, 6, width, generator=g, dtype=torch.float64)
    for k, s, p in ((3, 1, 1), (3, 2, 1), (1, 2, 0), (1, 1, 0), (7, 2, 3)):
        conv = Conv2d(5, 4, k, stride=s, padding=p, bias=True).double()
        with torch.no_grad():
            want = conv(x)
            outs = across_ranks(lambda own: conv_cols(conv, own, width)[0], x, 3, m)
        assert [o.shape[3] for o in outs] == [b - a for a, b in spatial.ranges(want.shape[3], m)]
        close(torch.cat(outs, 3), want)


@pytest.mark.parametrize("width, m", [(13, 4), (63, 4), (2, 4), (32, 3)])
def test_resize_windows(width, m):
    """Bilinear resizes of the decoder (×2, 32 → 63), the seg's (63 → 250)
    and shrinking ones, rank by rank, against ``F.interpolate``."""
    g = torch.Generator().manual_seed(width)
    x = torch.randn(2, 7, width, 3, generator=g, dtype=torch.float64)
    for size in ((14, 2 * width), (11, 4 * width - 2), (5, width // 2 + 1), (7, 1)):
        outs = across_ranks(lambda own: resize_bilinear_cols(own, width, size), x, 2, m)
        close(torch.cat(outs, 2), resize_bilinear(x, size))


@pytest.mark.parametrize("h, w, m", [(36, 50, 4), (32, 64, 3), (24, 44, 4)])
def test_pyramid_stem_and_head_windows(h, w, m):
    """``build_pyramid_cols`` (its odd half widths padded at level 1 by the
    rank owning the right edge), K2's windows (``stem_pool_reference`` on
    the CPU) and K1's (``seghead_reference``), rank by rank, against the
    whole map's."""
    g = torch.Generator().manual_seed(h + w)
    image = torch.rand(2, h, w, 3, generator=g, dtype=torch.float64) * 255
    whole = input_pipeline.build_pyramid(image, 3, torch.float64)
    for k in range(m):
        with fake_grid(1, m, k), pytest.MonkeyPatch.context() as mp:
            xn = input_pipeline.normalize(image)
            mp.setattr(spatial, "fetch",
                       lambda x, width, need, d: xn.narrow(d, need[k][0], need[k][1] - need[k][0]))
            a, b = spatial.cols(w, m, k)
            levels = input_pipeline.build_pyramid_cols(image[:, :, a:b], w, 3, torch.float64)
        for lv, (got, lw) in enumerate(levels):
            la, lb = spatial.cols(lw, m, k)
            assert lw == whole[lv].shape[2]
            close(got, whole[lv][:, :, la:lb])
    wt = torch.randn(64, 3, 7, 7, generator=g, dtype=torch.float64) * 0.1
    sc, sh = torch.rand(64, generator=g, dtype=torch.float64), torch.randn(64, generator=g,
                                                                          dtype=torch.float64)
    x = whole[1]
    outs = across_ranks(lambda own: stem.fused_stem_pool_cols(own, x.shape[2], wt, sc, sh)[0],
                        x, 2, m)
    close(torch.cat(outs, 2), stem.stem_pool_reference(x, wt, sc, sh))
    feat = torch.randn(2, 3, w // 4, 128, generator=g)
    head = (torch.rand(128, generator=g) + 0.5, torch.randn(128, generator=g),
            torch.randn(128, generator=g), torch.rand(128, generator=g) + 0.5,
            torch.randn(19, 128, generator=g) * 0.1, torch.randn(19, generator=g))
    outs = across_ranks(lambda own: seghead.fused_seghead_cols(own, feat.shape[2], *head),
                        feat, 2, m)
    got = torch.cat(outs, 2)
    assert [o.shape[2] for o in outs] == [b - a for a, b in spatial.ranges(w // 4 * 4, m)]
    assert torch.equal(got, seghead.seghead_reference(feat, *head))


# ---- refusals and the data axis --------------------------------------------

def test_refusals_name_what_is_missing():
    """Training, another backbone and ``fuse_inference`` raise on a model
    axis before any collective; none falls back."""
    x = torch.rand(1, 64, 64, 3) * 255
    model = build_model(Config(compute_dtype="float32"), device="cpu")
    single = build_model(Config(compute_dtype="float32", model="resnet18_single"), device="cpu")
    with fake_grid(1, 2, 1):
        with pytest.raises(ValueError, match="eval mode only"):
            model.train()(x)
        model.eval()
        with pytest.raises(NotImplementedError, match="ResNetSingle|not ported"):
            single(x)
        model.net.feature_extractor.upsample_blends1.fuse_inference = True
        with pytest.raises(ValueError, match="fuse_inference"):
            model(x)
        with pytest.raises(ValueError, match="fuse_inference"):
            make_serving_fn(model, "cpu")(x)


@pytest.mark.parametrize("grid", [(2, 1), (2, 2)])
def test_grid_shards_rows_as_one_data_axis(grid):
    """On a (2, 1) grid (today's two ranks) and on rank 3 of a (2, 2) grid,
    whose data index is 1, ``row_index``, ``rand_rows`` and ``shard_batch``
    give rank 1's rows of a one-axis world, bit for bit."""
    d, m = grid
    with fake_grid(d, m, d * m - 1) as w:
        w.rows = (3, 2)
        assert parallel.row_index(4, blocks=2).tolist() == [3, 4, 8, 9]
        assert parallel.global_rows(6) == 15
        got = parallel.rand_rows((4, 7), torch.Generator().manual_seed(3), "cpu", blocks=2)
        want = torch.rand((10, 7), generator=torch.Generator().manual_seed(3))[[3, 4, 8, 9]]
        assert torch.equal(got, want)
        batch = parallel.shard_batch({"left": np.arange(10), "label": np.arange(5),
                                      "left_name": list("abcde")})
        assert batch["left"].tolist() == [3, 4, 8, 9] and batch["left_name"] == ["d", "e"]
        assert w.rows == (3, 2) and parallel.local_share() == 0.4


def test_check_devices_counts_the_grid():
    """``check_devices`` with a grid shape counts d·m ranks (here, without a
    card, ``cuda`` refuses 4 ranks) and asks a train batch of d samples."""
    cfg = Config(device="cuda", batch_size=2)
    with pytest.raises(ValueError, match="needs 4 GPUs"):
        parallel.check_devices(cfg, shape=(2, 2))
    cfg = Config(device="cpu", batch_size=1)
    with pytest.raises(ValueError, match="leaves a rank without one"):
        parallel.check_devices(cfg, shape=(2, 2))
    parallel.check_devices(Config(device="cpu", batch_size=2), shape=(2, 2))
    parallel.check_devices(Config(device="cpu", batch_size=1), shape=(1, 4))
