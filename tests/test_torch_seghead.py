"""The port's serving head (its plain version on the CPU) vs the JAX fused
Pallas head in interpret mode and vs the f32 reference path; a plain
emulation of the tensor-core kernel's tiling (``csrc/seghead_tc.cu``), its
separable ×4 phases, its weight packing and the pack cache."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.ops.interpolate import (  # noqa: E402
    resize_bilinear as jax_resize_bilinear)
from doubly_contrastive_semseg_tpu.ops.seghead_pallas import (  # noqa: E402
    _phases4 as jax_phases4, fused_seghead_upsample_argmax as jax_fused_seghead)
from doubly_contrastive_semseg_tpu_torch.ops import seghead  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.ops.seghead import (  # noqa: E402
    fused_seghead_upsample_argmax, seghead_reference)

_ARG_ORDER = ("feat", "bn_scale", "bn_bias", "bn_mean", "bn_var", "conv_weight", "conv_bias")


def _head_args(rng, b, h, w, cin=128, c=19):
    return dict(
        feat=rng.standard_normal((b, h, w, cin)).astype(np.float32),
        bn_scale=rng.uniform(0.5, 1.5, cin).astype(np.float32),
        bn_bias=rng.standard_normal(cin).astype(np.float32),
        bn_mean=rng.standard_normal(cin).astype(np.float32),
        bn_var=rng.uniform(0.5, 2.0, cin).astype(np.float32),
        conv_weight=rng.standard_normal((cin, c)).astype(np.float32),  # (I, O)
        conv_bias=rng.standard_normal(c).astype(np.float32))


def _port(args, dtype=torch.float32):
    t = {k: torch.from_numpy(v) for k, v in args.items()}
    t["feat"] = t["feat"].to(dtype)
    t["conv_weight"] = t["conv_weight"].t().contiguous()  # (C, 128)
    counters = ("launches", "tc_launches", "cc_launches")
    before = [getattr(fused_seghead_upsample_argmax, k) for k in counters]
    out = fused_seghead_upsample_argmax(**t)
    # CPU: the plain version, no route counted
    assert [getattr(fused_seghead_upsample_argmax, k) for k in counters] == before
    np.testing.assert_array_equal(out.numpy(), seghead_reference(**t).numpy())
    return out.numpy()


def _f32_reference(a, eps=1e-5):
    xhat = (a["feat"] - a["bn_mean"]) / np.sqrt(a["bn_var"] + eps) * a["bn_scale"] + a["bn_bias"]
    logits = np.einsum("bhwc,co->bhwo", np.maximum(xhat, 0.0), a["conv_weight"]) + a["conv_bias"]
    up = jax_resize_bilinear(jnp.asarray(logits),
                             (a["feat"].shape[1] * 4, a["feat"].shape[2] * 4))
    return np.asarray(jnp.argmax(up, axis=-1))


# (14, 24): h not a multiple of the TPU tile; (13, 30): w not a multiple of 8
@pytest.mark.parametrize("h,w", [(16, 24), (14, 24), (13, 30)])
def test_seghead_matches_jax_pallas(rng, h, w):
    a = _head_args(rng, 2, h, w)
    jax_kernel = np.asarray(jax_fused_seghead(
        *(jnp.asarray(a[k]) for k in ("feat", "bn_scale", "bn_bias", "bn_mean",
                                      "bn_var", "conv_weight", "conv_bias")),
        interpret=True))
    want32 = _f32_reference(a)
    got = _port(a)
    assert got.shape == (2, 4 * h, 4 * w) and got.dtype == np.int8
    # random-normal logits have thin argmax margins: the TPU kernel's bf16
    # rounding flips a small tail of near-ties (tests/test_seghead_pallas.py)
    assert (got == jax_kernel).mean() > 0.995
    assert (got == want32).mean() > 0.99
    # the port in bf16 rounds as the TPU kernel does
    assert (_port(a, torch.bfloat16) == jax_kernel).mean() > 0.995


def test_seghead_never_picks_a_class_out_of_range(rng):
    """Every logit negative (class bias -1000): the TPU kernel's padded
    classes (scored ~0) would win everywhere if their masking broke; the
    port has no padded classes and must agree with it."""
    a = _head_args(rng, 1, 16, 8)
    a.update(bn_scale=np.ones(128, np.float32), bn_bias=np.zeros(128, np.float32),
             bn_mean=np.zeros(128, np.float32), bn_var=np.ones(128, np.float32),
             conv_bias=np.full(19, -1000.0, np.float32))
    got = _port(a)
    assert got.max() < 19
    jax_kernel = np.asarray(jax_fused_seghead(
        *(jnp.asarray(a[k]) for k in ("feat", "bn_scale", "bn_bias", "bn_mean",
                                      "bn_var", "conv_weight", "conv_bias")),
        interpret=True))
    assert (got == jax_kernel).mean() > 0.995


def test_seghead_wrapper_rejects_bad_shapes():
    feat = torch.zeros(1, 4, 4, 64)
    with pytest.raises(ValueError):
        fused_seghead_upsample_argmax(feat, *([torch.ones(64)] * 4),
                                      torch.zeros(19, 64), torch.zeros(19))
    with pytest.raises(ValueError):
        fused_seghead_upsample_argmax(torch.zeros(1, 4, 4, 128), *([torch.ones(128)] * 4),
                                      torch.zeros(40, 128), torch.zeros(40))


# ---- the tensor-core kernel (csrc/seghead_tc.cu) in plain PyTorch ---------

def _jax_kernel(a):
    return np.asarray(jax_fused_seghead(*(jnp.asarray(a[k]) for k in _ARG_ORDER),
                                        interpret=True))


def _unpack_fragments(wfrag):
    """Inverse of ``seghead.weight_fragments``: (8, NT, 32, 4) → (8·NT, 128)."""
    nt = wfrag.shape[1]
    return wfrag.reshape(8, nt, 8, 4, 2, 2).permute(1, 2, 0, 4, 3, 5).reshape(8 * nt, 128)


def _upsample4_phases(v):
    """(C, rows, cols) logit rows → the 4 column phases of each, interleaved:
    (C, rows, 4·cols) from (C, rows, cols + 2) with one halo column a side."""
    left, own, right = v[..., :-2], v[..., 1:-1], v[..., 2:]
    return torch.stack(seghead.phases4(left, own, right), dim=-1).flatten(-2)


def tc_emulation(feat, pack):
    """The tensor-core kernel's arithmetic and tiling in plain PyTorch: work
    items of STRIP columns × RUN rows, the strip's pixels and a halo column
    a side with clamped addresses, two logit rows a step into a ring of four
    rows, activations bf16(relu(x·scale + shift)), bf16 weights with f32
    sums, separable phases (vertical first) and the argmax over all packed
    classes (padded ones carry ``PAD_LOGIT``). feat: (B, h, w, 128) bf16."""
    b, h, w, _ = feat.shape
    scale, shift = pack["ab"]
    wts = _unpack_fragments(pack["wfrag"]).float()
    out = torch.full((b, 4 * h, 4 * w), -1, dtype=torch.int8)
    for img in range(b):
        for r0 in range(0, h, seghead.RUN):
            for j0 in range(0, w, seghead.STRIP):
                nrows = min(seghead.RUN, h - r0)
                cols = torch.arange(j0 - 1, j0 + seghead.STRIP + 1).clamp(0, w - 1)
                ring = {}
                for q in range(1 + (nrows + 1) // 2):
                    for j in (2 * q, 2 * q + 1):
                        x = feat[img, min(max(r0 - 1 + j, 0), h - 1), cols].float()
                        act = torch.relu(x * scale + shift).to(torch.bfloat16).float()
                        ring[j % 4] = (act @ wts.t() + pack["bias"]).t()   # (8·NT, 66)
                    if q == 0:
                        continue
                    for jo in (2 * q - 1, 2 * q):
                        if jo > nrows:
                            continue
                        rows = seghead.phases4(ring[(jo - 1) % 4], ring[jo % 4],
                                               ring[(jo + 1) % 4])
                        up = _upsample4_phases(torch.stack(rows, dim=1))  # (8·NT, 4, 256)
                        ncols = min(seghead.STRIP, w - j0)
                        i = r0 + jo - 1
                        out[img, 4 * i:4 * i + 4, 4 * j0:4 * (j0 + ncols)] = (
                            up.argmax(0)[:, :4 * ncols].to(torch.int8))
    assert (out >= 0).all()   # every output pixel written
    return out


def _bf16_args(rng, b, h, w):
    """Head arguments whose features are bf16 values (as the kernels see
    them), and the torch tensors of the same (conv weight (C, 128))."""
    a = _head_args(rng, b, h, w)
    a["feat"] = np.asarray(torch.from_numpy(a["feat"]).to(torch.bfloat16).float())
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    t["feat"] = t["feat"].to(torch.bfloat16)
    t["conv_weight"] = t["conv_weight"].t().contiguous()
    return a, t


# (1, 1) and (10, 7): smaller than a strip and a run; (13, 29): a ragged
# run; (33, 70): two runs and two strips, both cut by the image edge
@pytest.mark.parametrize("h,w", [(1, 1), (10, 7), (13, 29), (33, 70)])
def test_tc_tiling_emulation_matches_reference_and_jax(rng, h, w):
    a, t = _bf16_args(rng, 2, h, w)
    params = [t[k] for k in _ARG_ORDER[1:]]
    got = tc_emulation(t["feat"], seghead.pack_seghead(*params))
    ref = seghead_reference(t["feat"], *params)
    assert got.shape == (2, 4 * h, 4 * w)
    assert (got == ref).double().mean().item() >= 0.9999
    if h >= 10:   # the JAX kernel takes at least TILE_H + 2 feature rows
        assert (got.numpy() == _jax_kernel(a)).mean() >= 0.9999


@pytest.mark.parametrize("h,w", [(1, 1), (5, 9), (12, 17)])
def test_phases4_matches_jax_and_interpolate(rng, h, w):
    x = torch.from_numpy(rng.standard_normal((3, h, w)).astype(np.float32))
    tol = 1e-6 * x.abs().max().item()
    pad = torch.nn.functional.pad(x[None], (1, 1, 1, 1), mode="replicate")[0]
    rows = seghead.phases4(pad[:, :-2], pad[:, 1:-1], pad[:, 2:])   # each (3, h, w + 2)
    jax_rows = jax_phases4(*(jnp.asarray(pad[:, k:k + h].numpy()) for k in range(3)))
    for r, jr in zip(rows, jax_rows):
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=tol)
    up = _upsample4_phases(torch.stack(rows, dim=2).flatten(1, 2))    # (3, 4h, 4w)
    want = torch.nn.functional.interpolate(x[None], scale_factor=4, mode="bilinear",
                                           align_corners=False)[0]
    assert (up - want).abs().max().item() <= tol


@pytest.mark.parametrize("c", [1, 8, 19, 32])
def test_weight_packing_round_trip(rng, c):
    w = torch.from_numpy(rng.standard_normal((c, 128, 1, 1)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    ones, zeros = torch.ones(128), torch.zeros(128)
    pack = seghead.pack_seghead(ones, zeros, zeros, ones, w, bias)
    nt = -(-c // 8)
    assert pack["wfrag"].shape == (8, nt, 32, 4) and pack["wfrag"].dtype == torch.bfloat16
    back = _unpack_fragments(pack["wfrag"])
    assert torch.equal(back[:c], w.reshape(c, 128).to(torch.bfloat16))
    assert not back[c:].any()
    assert torch.equal(pack["bias"][:c], bias)
    assert (pack["bias"][c:] == seghead.PAD_LOGIT).all()
    # the CUDA-core kernel's weights, rounded to the feature dtype
    assert torch.equal(pack["wt"][:, :c], w.reshape(c, 128).to(torch.bfloat16).float().t())
    wt32 = seghead.pack_seghead(ones, zeros, zeros, ones, w, bias, dtype=torch.float32)["wt"]
    assert torch.equal(wt32[:, :c], w.reshape(c, 128).t()) and not wt32[:, c:].any()
    # fragment order: lane 4g + t of k-step s, n tile n holds W[8n + g, 16s + 2t (+1)]
    # and W[8n + g, 16s + 8 + 2t (+1)]
    s, n, g, t4 = 3, nt - 1, 5, 2
    row = back[8 * n + g]
    assert torch.equal(pack["wfrag"][s, n, 4 * g + t4],
                       row[[16 * s + 2 * t4, 16 * s + 2 * t4 + 1,
                            16 * s + 8 + 2 * t4, 16 * s + 9 + 2 * t4]])


def test_padded_classes_never_win(rng):
    """Every real logit near -1000: the padded classes' PAD_LOGIT keeps them
    out of the argmax, where a padding of 0 would win everywhere."""
    a, t = _bf16_args(rng, 1, 12, 20)
    t["conv_bias"] = torch.full((19,), -1000.0)
    params = [t[k] for k in _ARG_ORDER[1:]]
    pack = seghead.pack_seghead(*params)
    got = tc_emulation(t["feat"], pack)
    assert got.max().item() < 19
    assert (got == seghead_reference(t["feat"], *params)).double().mean().item() >= 0.999
    pack["bias"][19:] = 0.0
    assert (tc_emulation(t["feat"], pack) >= 19).all()


def test_pack_cache_follows_in_place_updates(rng):
    _, t = _bf16_args(rng, 1, 2, 2)
    params = [t[k] for k in _ARG_ORDER[1:]]
    first = seghead.packed_head(*params)
    assert seghead.packed_head(*params) is first
    assert seghead.packed_head(*params, dtype=torch.float32) is not first
    t["conv_weight"].copy_(t["conv_weight"] * 2.0)
    second = seghead.packed_head(*params)
    assert second is not first
    torch.testing.assert_close(_unpack_fragments(second["wfrag"])[:19].float(),
                               2.0 * _unpack_fragments(first["wfrag"])[:19].float())
    assert seghead.packed_head(*params) is second
    t["bn_var"].add_(1.0)   # a BN running-stat update
    third = seghead.packed_head(*params)
    assert third is not second and not torch.equal(third["ab"], second["ab"])
    assert torch.equal(third["wfrag"], second["wfrag"])
