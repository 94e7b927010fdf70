"""The port's contrastive kernels' plain versions and its differentiable
losses vs the JAX package's Pallas kernels in interpret mode.

The same numpy-seeded embeddings, labels and validity go through
``contrastive_row_stats(..., interpret=True)``, ``supcon_loss_pallas`` and
``pixel_contrast_loss_pallas`` (values, and ``jax.grad`` through their
custom VJPs) and through the port on the CPU, where each wrapper takes its
plain version and the custom backward (``dz_via_chunks``) runs as on the
card. N is not a multiple of 128 and some rows are invalid. Tolerances:
values rtol 1e-5 (the sums run in another order); gradients 1e-4 × max|g|.
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
    return (cp.contrastive_row_stats.launches, cp.pixel_contrast_pos_sweep.launches)


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


def test_kernel_wrappers_refuse_bad_shapes():
    z = torch.zeros(4, 300)
    lab = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="D <= 256"):
        cp._kernel_inputs(z, lab, lab.bool())
