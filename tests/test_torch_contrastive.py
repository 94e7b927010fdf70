"""The port's contrastive kernels' plain versions and its differentiable
losses vs the JAX package's Pallas kernels in interpret mode.

The same numpy-seeded embeddings, labels and validity go through
``contrastive_row_stats(..., interpret=True)``, ``supcon_loss_pallas`` and
``pixel_contrast_loss_pallas`` (values, and ``jax.grad`` through their
custom VJPs) and through the port on the CPU, where each wrapper takes its
plain version and the custom backward (``dz_via_chunks``) runs as on the
card. N is not a multiple of 128 and some rows are invalid. Tolerances:
values rtol 1e-5 (the sums run in another order); gradients 1e-4 × max|g|.
The CUDA row-stats kernel cannot run here, so its arithmetic is held in
plain PyTorch (``row_stats_tiled``: split-TF32 products, per-tile partials
merged by the exact shift) against the plain version and the Pallas
kernels, with c and invalid rows' m exact; so is the positive-sweep
kernel's (``pos_sweep_segmented``: label-sorted rows, column ranges by the
kernel's warp search, split-TF32 logits, positives summed in its order),
with q within 1e-5 × max|q| and c exact, and its column ranges against a
numpy ``argsort``/``searchsorted`` oracle.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.ops import contrastive_pallas as jcp  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops import contrastive as cp  # noqa: E402


def _inputs(rng, n, d, n_labels, invalid_share=0.1):
    z = rng.standard_normal((n, d)).astype(np.float32) / np.sqrt(d)
    labels = rng.integers(0, n_labels, n).astype(np.int32)
    valid = rng.uniform(size=n) >= invalid_share
    return z, labels, valid


def _launches():
    return (cp.contrastive_row_stats.launches, cp.pos_sweep_layout.launches,
            cp.pixel_contrast_pos_sweep.launches)


def _close(got, want, rtol=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30), err_msg=what)


@pytest.mark.parametrize("n,d", [(200, 64), (300, 128)])
@pytest.mark.parametrize("neg_mode", [False, True])
def test_row_stats_match_pallas(rng, n, d, neg_mode):
    z, labels, valid = _inputs(rng, n, d, 4 if not neg_mode else 19)
    want = jcp.contrastive_row_stats(jnp.asarray(z), jnp.asarray(labels),
                                     jnp.asarray(valid), neg_mode=neg_mode,
                                     interpret=True)
    before = _launches()
    got = cp.contrastive_row_stats(torch.from_numpy(z), torch.from_numpy(labels),
                                   torch.from_numpy(valid), neg_mode=neg_mode)
    assert _launches() == before  # CPU: plain version only
    for name, g, w in zip("pcsmn", got, want):
        w = np.asarray(w)
        if name == "c":
            np.testing.assert_array_equal(g.numpy(), w)
        elif name == "m":
            # invalid rows: m = -1e30 on both sides; compare the valid ones
            np.testing.assert_array_equal(g.numpy()[~valid], w[~valid])
            _close(g.numpy()[valid], w[valid], what=name)
        else:
            _close(g.numpy(), w, what=name)
    assert np.all(np.isfinite(got[4].numpy()))


@pytest.mark.parametrize("n,d", [(200, 64), (300, 128)])
def test_pixel_contrast_sweep_matches_pallas(rng, n, d):
    z, labels, valid = _inputs(rng, n, d, 19)
    zj, lj, vj = jnp.asarray(z), jnp.asarray(labels), jnp.asarray(valid)
    _, _, s, m, nrm = jcp.contrastive_row_stats(zj, lj, vj, neg_mode=True,
                                                interpret=True)
    loss_j = jcp._pc_core_fwd(zj, lj.astype(jnp.float32), vj.astype(jnp.float32),
                              0.07, 0.07, 128, True)[0]
    zt, lt, vt = torch.from_numpy(z), torch.from_numpy(labels), torch.from_numpy(valid)
    _, _, s_t, m_t, n_t = cp.contrastive_row_stats(zt, lt, vt, neg_mode=True)
    q, c = cp.pixel_contrast_sweep_reference(zt, lt, vt, m_t, n_t, s_t)
    before = _launches()
    q2, c2 = cp.pixel_contrast_pos_sweep(zt, lt, vt, m_t, n_t, s_t)
    assert _launches() == before
    np.testing.assert_array_equal(q2.numpy(), q.numpy())
    # the JAX sweep's q through the loss it forms
    row_ok = valid & (c.numpy() > 0)
    per_anchor = -q.numpy() / np.maximum(c.numpy(), 1.0)
    _close(per_anchor[row_ok].sum() / row_ok.sum(), float(loss_j), what="loss from q")
    _close(s_t.numpy(), np.asarray(s), what="s")


@pytest.mark.parametrize("b,d", [(100, 64), (150, 128)])
@pytest.mark.parametrize("with_labels", [True, False])
def test_supcon_loss_and_grad_match_pallas(rng, b, d, with_labels):
    f = (rng.standard_normal((b, 2, d)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, 4, b) if with_labels else None
    lj = None if labels is None else jnp.asarray(labels)
    want, g_want = jax.value_and_grad(
        lambda x: jcp.supcon_loss_pallas(x, lj, interpret=True))(jnp.asarray(f))
    ft = torch.from_numpy(f).requires_grad_(True)
    lt = None if labels is None else torch.from_numpy(labels)
    before = _launches()
    got = cp.supcon_loss_kernel(ft, lt)
    got.backward()
    assert _launches() == before
    _close(got.item(), float(want), what="loss")
    g_want = np.asarray(g_want)
    np.testing.assert_allclose(ft.grad.numpy(), g_want, rtol=0,
                               atol=1e-4 * np.abs(g_want).max())


@pytest.mark.parametrize("a,d", [(100, 64), (150, 128)])
def test_pixel_contrast_loss_and_grad_match_pallas(rng, a, d):
    feats = (rng.standard_normal((a, 2, d)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, 19, a).astype(np.int32)
    valid = rng.uniform(size=a) >= 0.1
    want, g_want = jax.value_and_grad(
        lambda x: jcp.pixel_contrast_loss_pallas(
            x, jnp.asarray(labels), jnp.asarray(valid), interpret=True))(jnp.asarray(feats))
    ft = torch.from_numpy(feats).requires_grad_(True)
    before = _launches()
    got = cp.pixel_contrast_loss_kernel(ft, torch.from_numpy(labels), torch.from_numpy(valid))
    got.backward()
    assert _launches() == before
    _close(got.item(), float(want), what="loss")
    g_want = np.asarray(g_want)
    np.testing.assert_allclose(ft.grad.numpy(), g_want, rtol=0,
                               atol=1e-4 * np.abs(g_want).max())
    # invalid anchors get exactly zero gradient on both sides
    assert np.all(ft.grad.numpy()[~valid] == 0) and np.all(g_want[~valid] == 0)


def test_kernel_losses_match_dense_port_losses(rng):
    """The kernel route's custom backward vs autograd of the port's dense
    losses (the route the CPU takes by default)."""
    from doubly_contrastive_semseg_tpu_torch.losses.pixel_contrast import _masked_contrastive
    from doubly_contrastive_semseg_tpu_torch.losses.supcon import supcon_loss

    f = torch.from_numpy((rng.standard_normal((90, 2, 32)) / 6).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 5, 90))
    valid = torch.from_numpy(rng.uniform(size=90) >= 0.2)
    for fn in (lambda x, k: supcon_loss(x, labels, use_kernel=k),
               lambda x, k: _masked_contrastive(x, labels, valid, 0.07, 0.07, use_kernel=k)):
        res = []
        for use_kernel in (True, False):
            x = f.clone().requires_grad_(True)
            loss = fn(x, use_kernel)
            loss.backward()
            res.append((loss.item(), x.grad.numpy()))
        _close(res[0][0], res[1][0], what="loss")
        np.testing.assert_allclose(res[0][1], res[1][1], rtol=0,
                                   atol=1e-4 * np.abs(res[1][1]).max())


def _check_stats(got, want, valid):
    """(p, c, s, m, n) against (p, c, s, m, n): c and invalid rows' m
    exact, the rest rtol 1e-5 of the largest |want|."""
    for name, g, w in zip("pcsmn", got, want):
        g, w = np.asarray(g), np.asarray(w)
        if name == "c":
            np.testing.assert_array_equal(g, w)
        elif name == "m":
            np.testing.assert_array_equal(g[~valid], w[~valid])
            if valid.any():
                _close(g[valid], w[valid], what=name)
        else:
            _close(g, w, what=name)


@pytest.mark.parametrize("n,d", [(200, 64), (200, 128), (300, 64), (300, 128)])
@pytest.mark.parametrize("neg_mode", [False, True])
def test_row_stats_tiled_matches_reference_and_pallas(rng, n, d, neg_mode):
    """The two-pass kernel's arithmetic (split-TF32 logits, pass-A partials
    of 128-column tiles merged by the exact shift, pass-B sums tile by
    tile) against the dense plain version and the Pallas kernels. Row 0 is
    invalid, so its every pair is."""
    z, labels, valid = _inputs(rng, n, d, 4 if not neg_mode else 19)
    valid[0] = False
    zt, lt, vt = torch.from_numpy(z), torch.from_numpy(labels), torch.from_numpy(valid)
    got = [t.numpy() for t in cp.row_stats_tiled(zt, lt, vt, neg_mode=neg_mode)]
    ref = cp.contrastive_row_stats_reference(zt, lt, vt, neg_mode=neg_mode)
    _check_stats(got, [t.numpy() for t in ref], valid)
    want = jcp.contrastive_row_stats(jnp.asarray(z), jnp.asarray(labels), jnp.asarray(valid),
                                     neg_mode=neg_mode, interpret=True)
    _check_stats(got, want, valid)
    assert got[3][0] == np.float32(cp.NEG_BIG) and got[4][0] == np.float32(1e-12)


@pytest.mark.parametrize("neg_mode", [False, True])
def test_row_stats_tiled_single_valid_row(rng, neg_mode):
    """One valid row, in the second column tile: its only valid column is
    itself, so m = l_ii, n is clamped at 1e-12 and s, p, c are 0; every
    other row is invalid (m = -1e30 exactly)."""
    z, labels, _ = _inputs(rng, 200, 64, 19)
    valid = np.zeros(200, bool)
    valid[150] = True
    zt, lt, vt = torch.from_numpy(z), torch.from_numpy(labels), torch.from_numpy(valid)
    got = [t.numpy() for t in cp.row_stats_tiled(zt, lt, vt, neg_mode=neg_mode)]
    _check_stats(got, [t.numpy() for t in cp.contrastive_row_stats_reference(
        zt, lt, vt, neg_mode=neg_mode)], valid)
    _check_stats(got, jcp.contrastive_row_stats(jnp.asarray(z), jnp.asarray(labels),
                                                jnp.asarray(valid), neg_mode=neg_mode,
                                                interpret=True), valid)
    assert got[4][150] == np.float32(1e-12)
    assert got[0][150] == got[1][150] == got[2][150] == 0.0


def test_merge_row_partials_matches_direct(rng):
    """Per-tile (m, S1, S2, k) merged in tile order by the exact shift equal
    the max and the norm about it over all valid columns; tiles with no
    valid column (m = -1e30) are skipped without overflow."""
    n, tiles, width = 50, 6, 16
    vals = torch.from_numpy((rng.standard_normal((n, tiles * width)) * 14).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=(n, tiles * width)) < 0.6)
    mask[3] = False                     # a row with no valid column
    mask[4, width:] = False             # only its first tile is valid
    mask[5, : 5 * width] = False        # only its last tile
    mask[6] = False
    mask[6, 2 * width + 3] = True       # one valid column
    parts = []
    for t in range(tiles):
        v, l = mask[:, t * width:(t + 1) * width], vals[:, t * width:(t + 1) * width]
        mt = torch.where(v, l, cp.NEG_BIG).amax(dim=1)
        dd = torch.where(v, l - mt[:, None], 0.0)
        parts.append((mt, dd.sum(1), (dd * dd).sum(1), v.sum(1).float()))
    m, nrm = cp.merge_row_partials(*(torch.stack(f) for f in zip(*parts)))
    want_m = torch.where(mask, vals, cp.NEG_BIG).amax(dim=1)
    dd = torch.where(mask, vals.double() - want_m.double()[:, None], 0.0)
    want_n = torch.sqrt((dd * dd).sum(1)).clamp_min(1e-12)
    assert torch.equal(m, want_m)
    assert m[3] == np.float32(cp.NEG_BIG) and nrm[3] == np.float32(1e-12)
    assert nrm[6] == np.float32(1e-12) and torch.isfinite(nrm).all()
    _close(nrm.numpy(), want_n.numpy(), what="n")


def test_split_tf32_products():
    """TF32 rounding is to nearest with ties away from zero on 10 stored
    mantissa bits; the three-product split is as accurate as f32 where one
    TF32 product is not."""
    half_ulp = 1.0 + 2.0 ** -11          # halfway between two TF32 values
    x = torch.tensor([half_ulp, -half_ulp, 1.0 + 2.0 ** -12, 3.0], dtype=torch.float32)
    np.testing.assert_array_equal(cp.tf32_round(x).numpy(),
                                  np.float32([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 3.0]))
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((64, 128)) / np.sqrt(128)).astype(np.float32)
    b = (rng.standard_normal((96, 128)) / np.sqrt(128)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    scale = np.abs(exact).max()
    err3 = np.abs(cp.split_tf32_matmul(at, bt).double().numpy() - exact).max() / scale
    err1 = np.abs((cp.tf32_round(at) @ cp.tf32_round(bt).t()).double().numpy()
                  - exact).max() / scale
    err_f32 = np.abs((at @ bt.t()).double().numpy() - exact).max() / scale
    assert err3 <= 4 * err_f32 + 1e-7 and err1 > 30 * err3


def test_kernel_wrappers_refuse_bad_shapes():
    """K3 and K4 take any D >= 1; csrc/contrastive.cu, the tools' yardstick,
    keeps D <= 256."""
    lab = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="D <= 256"):
        cp._kernel_inputs(torch.zeros(4, 300), lab, lab.bool(), cp.DENSE_MAX_D)
    with pytest.raises(ValueError, match="D >= 1"):
        cp._kernel_inputs(torch.zeros(4, 0), lab, lab.bool())
    with pytest.raises(ValueError, match="device"):   # past the shape checks at D = 2048
        cp._kernel_inputs(torch.zeros(4, 2048), lab, lab.bool())


# ---- K4: the segmented positive sweep's arithmetic -------------------------

def _pc_loss_from_sweep(q, c, valid):
    """Pixel contrast's loss from (q, c) as ``_pc_core_fwd`` forms it (τ = τ_b)."""
    q, c = np.asarray(q, np.float64), np.asarray(c, np.float64)
    row_ok = valid & (c > 0)
    if not row_ok.any():
        return 0.0
    return float((-q / np.maximum(c, 1.0))[row_ok].sum() / row_ok.sum())


def _check_pos_sweep(z, labels, valid, neg_mode=True):
    """``pos_sweep_segmented`` against the plain version (q within 1e-5 ×
    max|q|, c exact; c = segment size − 1 on valid rows, 0 elsewhere) and,
    through the loss it forms, against JAX ``_pc_core_fwd`` in interpret
    mode (rtol 1e-5), given K3's stats in ``neg_mode`` (or, with ``neg_mode``
    False, supcon's s, which the sweep takes as well; JAX not compared).
    Returns q."""
    zt, lt, vt = torch.from_numpy(z), torch.from_numpy(labels), torch.from_numpy(valid)
    _, _, s, m, nrm = cp.contrastive_row_stats(zt, lt, vt, neg_mode=neg_mode)
    before = _launches()
    q, c = cp.pos_sweep_segmented(zt, lt, vt, m, nrm, s)
    assert _launches() == before
    q_ref, c_ref = cp.pixel_contrast_sweep_reference(zt, lt, vt, m, nrm, s)
    np.testing.assert_array_equal(c.numpy(), c_ref.numpy())
    seg = np.array([(labels[valid] == lab).sum() - 1 if ok else 0
                    for lab, ok in zip(labels, valid)], np.float32)
    np.testing.assert_array_equal(c.numpy(), seg)
    scale = np.abs(q_ref.numpy()).max()
    np.testing.assert_allclose(q.numpy(), q_ref.numpy(), rtol=0, atol=1e-5 * scale)
    assert np.all(q.numpy()[seg == 0] == 0)
    if not neg_mode:
        return q.numpy()
    zj = jnp.asarray(z)
    loss_j = jcp._pc_core_fwd(zj, jnp.asarray(labels, jnp.float32),
                              jnp.asarray(valid, jnp.float32), 0.07, 0.07, 128, True)[0]
    _close(_pc_loss_from_sweep(q.numpy(), c.numpy(), valid), float(loss_j), what="loss from q")
    return q.numpy()


@pytest.mark.parametrize("n,d", [(200, 64), (200, 128), (300, 64), (300, 128)])
def test_pos_sweep_segmented_matches_reference_and_pallas(rng, n, d):
    """The segmented kernel's arithmetic on random labels, N not a multiple
    of the 32-row tile, 10 % of the rows invalid."""
    _check_pos_sweep(*_inputs(rng, n, d, 19))


def _pos_case(rng, case):
    """(z, labels, valid) of one edge case of the segmented sweep."""
    n, d = {"n1": (1, 64), "d37": (300, 37), "ragged": (97, 64)}.get(case, (304, 64))
    z, labels, valid = _inputs(rng, n, d, 19)
    if case == "anchor_grid":        # the dense step's anchors: class c of image b, two views
        labels = (np.arange(n) % 19).astype(np.int32)
        valid = np.tile(rng.uniform(size=n // 2) >= 0.1, 2)
    elif case == "one_label":         # the walk degenerates to the full square
        labels[:] = 7
        valid[:] = True
    elif case == "negative_labels":
        labels = rng.integers(-6, 3, n).astype(np.int32)
    elif case == "all_invalid":
        valid[:] = False
    elif case == "lone_row":          # label 18 has one valid row: c = q = 0 there
        labels[labels == 18] = 17
        labels[5], valid[5] = 18, True
    return z, labels, valid


@pytest.mark.parametrize("case", ["anchor_grid", "one_label", "negative_labels", "all_invalid",
                                  "lone_row", "n1", "d37", "ragged"])
def test_pos_sweep_segmented_edge_cases(rng, case):
    z, labels, valid = _pos_case(rng, case)
    if case == "one_label":
        # no negatives: s = 0 and every term l̂ − log(exp(l̂)) is 0 in exact
        # arithmetic, so q is rounding noise (≤ a few ulp of |l̂| ≤ 1 a term);
        # the full-square walk is held with supcon's s, which gives q a scale,
        # and the neg_mode loss on both sides to that noise
        _check_pos_sweep(z, labels, valid, neg_mode=False)
        zt, lt, vt = torch.from_numpy(z), torch.from_numpy(labels), torch.from_numpy(valid)
        _, _, s, m, nrm = cp.contrastive_row_stats(zt, lt, vt, neg_mode=True)
        q, c = cp.pos_sweep_segmented(zt, lt, vt, m, nrm, s)
        loss_j = jcp._pc_core_fwd(jnp.asarray(z), jnp.asarray(labels, jnp.float32),
                                  jnp.asarray(valid, jnp.float32), 0.07, 0.07, 128, True)[0]
        assert abs(_pc_loss_from_sweep(q.numpy(), c.numpy(), valid)) <= 1e-6
        assert abs(float(loss_j)) <= 1e-6
        return
    q = _check_pos_sweep(z, labels, valid)
    if case == "lone_row":
        assert q[5] == 0
    if case in ("all_invalid", "n1"):
        assert np.all(q == 0)


_LAYOUT_CASES = ["random", "anchor_grid", "one_label", "all_invalid", "n1", "wide_keys"]


def _layout_case(rng, case):
    """(labels, valid) of one layout case."""
    n = {"n1": 1, "wide_keys": 5000}.get(case, 8208)
    labels = rng.integers(0, 19, n).astype(np.int32)
    valid = rng.uniform(size=n) >= 0.1
    if case == "anchor_grid":
        labels = (np.arange(n) % 19).astype(np.int32)
    elif case == "one_label":
        labels[:] = 0
    elif case == "all_invalid":
        valid[:] = False
    elif case == "wide_keys":         # int32 extremes, many one-row labels
        labels = rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64).astype(np.int32)
        labels[: n // 2] = labels[n // 2:][rng.integers(0, n // 2, n // 2)]
        labels[:2] = [-2 ** 31, 2 ** 31 - 1]
    return labels, valid


@pytest.mark.parametrize("case", _LAYOUT_CASES)
def test_pos_sweep_layout_place_keys_order_as_stable_sort(rng, case):
    """The layout kernel places row i at #{j : key'_j < key'_i} for its
    composite key' = (label ^ 2^31 as unsigned, or 2^32 when invalid) << 31
    | i. Built here in numpy as the kernel builds it, those places are the
    stable sort's (``pos_sweep_layout_reference``) and the keys unique."""
    labels, valid = _layout_case(rng, case)
    n = labels.shape[0]
    k = np.where(valid, (labels.view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64),
                 np.uint64(1) << np.uint64(32))
    place_key = (k << np.uint64(31)) | np.arange(n, dtype=np.uint64)
    assert np.unique(place_key).size == n
    perm = np.empty(n, np.int64)
    perm[np.argsort(np.argsort(place_key))] = np.arange(n)   # row at each place
    keys, want_perm = cp.pos_sweep_layout_reference(torch.from_numpy(labels),
                                                    torch.from_numpy(valid))
    np.testing.assert_array_equal(perm, want_perm.numpy())
    np.testing.assert_array_equal(np.where(valid, labels.astype(np.int64), cp.INVALID_KEY)[perm],
                                  keys.numpy())


@pytest.mark.parametrize("case", _LAYOUT_CASES)
def test_pos_sweep_column_ranges_match_searchsorted(rng, case):
    """Each 32-row tile's valid rows and column range by the kernel's warp
    search equal a numpy oracle: ``argsort`` (stable) of the keys, and
    ``searchsorted`` of the first and last valid row's key."""
    labels, valid = _layout_case(rng, case)
    n = labels.shape[0]
    keys = np.where(valid, labels.astype(np.int64), cp.INVALID_KEY)
    perm = np.argsort(keys, kind="stable")
    ks = keys[perm]
    want = []
    for r0 in range(0, n, cp.POS_ROWS):
        kt = ks[r0:r0 + cp.POS_ROWS]
        nv = int((kt < cp.INVALID_KEY).sum())
        want.append((0, 0, 0) if nv == 0 else
                    (np.searchsorted(ks, kt[0], "left"), np.searchsorted(ks, kt[nv - 1], "right"),
                     nv))
    got_keys, got_perm = cp.pos_sweep_layout(torch.from_numpy(labels), torch.from_numpy(valid))
    np.testing.assert_array_equal(got_perm.numpy(), perm)
    np.testing.assert_array_equal(got_keys.numpy(), ks)
    got = torch.stack(cp.pos_sweep_column_ranges(got_keys), dim=1).numpy()
    np.testing.assert_array_equal(got, np.array(want, np.int64).reshape(-1, 3))


def test_pos_sweep_wrapper_takes_plain_version_on_cpu(rng):
    """On a CPU tensor the wrapper returns the plain version itself and
    launches nothing."""
    z, labels, valid = _inputs(rng, 150, 32, 5)
    zt, lt, vt = torch.from_numpy(z), torch.from_numpy(labels), torch.from_numpy(valid)
    _, _, s, m, nrm = cp.contrastive_row_stats(zt, lt, vt, neg_mode=True)
    before = _launches()
    got = cp.pixel_contrast_pos_sweep(zt, lt, vt, m, nrm, s)
    assert _launches() == before
    for g, w in zip(got, cp.pixel_contrast_sweep_reference(zt, lt, vt, m, nrm, s)):
        assert torch.equal(g, w)


# ---- the DeepLab family's widths: any D, as the Pallas kernels take ----------

@pytest.mark.parametrize("d", [330, 2048])
@pytest.mark.parametrize("neg_mode", [False, True])
def test_row_stats_tiled_wide_d_matches_reference_and_pallas(rng, d, neg_mode):
    """K3's arithmetic at D = 2048 (ResNet and Xception features) and D = 330
    (not a multiple of 4: the kernels' 4-byte staging) against the plain
    version and the Pallas kernels, which pad D to a multiple of 128."""
    z, labels, valid = _inputs(rng, 160, d, 4 if not neg_mode else 19)
    zt, lt, vt = torch.from_numpy(z), torch.from_numpy(labels), torch.from_numpy(valid)
    got = [t.numpy() for t in cp.row_stats_tiled(zt, lt, vt, neg_mode=neg_mode)]
    _check_stats(got, [t.numpy() for t in cp.contrastive_row_stats_reference(
        zt, lt, vt, neg_mode=neg_mode)], valid)
    _check_stats(got, jcp.contrastive_row_stats(jnp.asarray(z), jnp.asarray(labels),
                                                jnp.asarray(valid), neg_mode=neg_mode,
                                                interpret=True), valid)


@pytest.mark.parametrize("d", [330, 2048])
def test_pos_sweep_segmented_wide_d_matches_reference_and_pallas(rng, d):
    """K4's arithmetic at D = 2048 and D = 330 against the plain version and,
    through the loss, JAX ``_pc_core_fwd`` in interpret mode."""
    _check_pos_sweep(*_inputs(rng, 160, d, 19))
