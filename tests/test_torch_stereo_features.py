"""The port's legacy stereo feature extractors (``models/stereo_features.py``)
and RODSNet-era heads (``models/legacy_segmentation.py``) against the JAX
package's, on the CPU in float32, JAX un-jitted.

The cases are those of ``tests/test_stereo_features.py``. Weights go from
JAX to the port: numpy draws of the shapes of JAX's ``init``
(``test_torch_swiftnet_single.fill``), carried by ``from_jax_variables``
and loaded strictly. The deformable convs' offset convs, zero at JAX's
init, are drawn too and scaled by ``OFFSET_SCALE``, so the deformable
samples move (measured on GANet at 48²: 0.07–0.09 px on average, up to
0.24 px) and the bilinear gather between the taps is exercised. The heads
are fed random feature lists of the MobileNetV2 trunk's shapes rather than
a trunk pass.

Tolerances, each of max|·| of the JAX tensor: eval outputs 1e-4; in
training a block's output and running statistics 1e-4, a whole
extractor's 1e-2 (JAX's ``TorchBatchNorm`` takes a one-pass float32
variance).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.models import legacy_segmentation as jlegacy  # noqa: E402
from doubly_contrastive_semseg_tpu.models import stereo_features as jfeat  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.torch_convert import jax_to_py  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models import (  # noqa: E402
    legacy_segmentation, stereo_features)
from doubly_contrastive_semseg_tpu_torch.utils import from_jax_variables  # noqa: E402
from test_torch_deeplab import close, few_threads  # noqa: E402,F401
from test_torch_swiftnet_single import fill  # noqa: E402

B = 2
OFFSET_SCALE = 0.1
# the MobileNetV2 trunk's list at side s: (divisor, channels)
MOBILE_TAPS = ((1, 16), (2, 16), (4, 24), (8, 32), (16, 96), (16, 320))


def variables(jmod, rng, *args, **kw):
    """(params, batch_stats) of ``fill`` draws of JAX's init shapes, each
    deformable conv's offset conv scaled by ``OFFSET_SCALE``."""
    shapes = jax.eval_shape(lambda key: jmod.init(key, *args, train=False, **kw),
                            jax.random.PRNGKey(0))
    params, stats = fill(shapes["params"], rng), fill(shapes.get("batch_stats", {}), rng)

    def calm(tree):
        for k, v in tree.items():
            if k == "offset_conv":
                v["kernel"] = v["kernel"] * np.float32(OFFSET_SCALE)
            elif isinstance(v, dict):
                calm(v)

    calm(params)
    return params, stats


def to_torch(x):
    if isinstance(x, (list, tuple)):
        return [to_torch(a) for a in x]
    return torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) else x


def port_state(params, stats, key=None):
    """JAX's variables as the port module's ``state_dict``; a block is
    carried in the context of ``key``, its name in an extractor."""
    if key is None:
        return from_jax_variables(params, stats)
    sd = from_jax_variables({key: params} if params else {}, {key: stats})
    return {k[len(key) + 1:]: v for k, v in sd.items()}


def check(rng, jmod, port, args, kw=None, train=False, tol=None, key=None):
    """``jmod`` and ``port`` on the numpy ``args`` from JAX's variables
    (``port_state``): every output within ``tol`` of max|·| (1e-4 in eval,
    1e-2 in training), and in training the running statistics at rtol
    ``tol``."""
    kw = kw or {}
    tol = tol or (1e-2 if train else 1e-4)
    jargs = [[jnp.asarray(a) for a in x] if isinstance(x, list) else
             jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in args]
    params, stats = variables(jmod, rng, *jargs, **kw)
    port.load_state_dict(port_state(params, stats, key), strict=True)
    v = {"params": params, "batch_stats": stats}
    if train:
        want, new = jmod.apply(v, *jargs, train=True, mutable="batch_stats", **kw)
    else:
        want = jmod.apply(v, *jargs, train=False, **kw)
    port.train(train)
    with torch.no_grad():
        got = port(*to_torch(list(args)))
    got, want = (got, want) if isinstance(got, list) else ([got], [want])
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == tuple(w.shape), (i, g.shape, w.shape)
        close(g.numpy(), w, f"output {i}", tol)
    if train:
        sd = port.state_dict()
        for k, w in port_state({}, jax_to_py(new["batch_stats"]), key).items():
            if not k.endswith("num_batches_tracked"):
                w = w.numpy()
                np.testing.assert_allclose(sd[k].numpy(), w, rtol=tol,
                                           atol=tol * np.abs(w).max(), err_msg=k)
    return got


def image(rng, h, w):
    return rng.uniform(0, 1, (B, h, w, 3)).astype(np.float32)


def mobile_feats(rng, s):
    return [rng.standard_normal((B, s // d, s // d, c)).astype(np.float32)
            for d, c in MOBILE_TAPS]


@pytest.mark.parametrize("kind,div", [("stereonet", 8), ("psmnet", 4), ("gcnet", 2)])
def test_plain_feature_extractors(rng, kind, div):
    """StereoNet, PSMNet (SPP windows capped at its 16² map) and GCNet at
    64², eval, 32 channels at 1/``div``."""
    got = check(rng, jfeat.make_stereo_feature(kind), stereo_features.make_stereo_feature(kind),
                [image(rng, 64, 64)])
    assert tuple(got[0].shape) == (B, 64 // div, 64 // div, 32)


@pytest.mark.parametrize("mdconv", [False, True], ids=["plain", "mdconv"])
def test_ganet_feature_list(rng, mdconv):
    """GANet's six maps at 48² (its /3 stem, then four halvings), with the
    deformable ``conv_start2``, ``conv3a``, ``conv4a`` under
    ``feature_mdconv``."""
    got = check(rng, jfeat.GANetFeature(feature_mdconv=mdconv),
                stereo_features.GANetFeature(feature_mdconv=mdconv), [image(rng, 48, 48)])
    assert len(got) == 6 and tuple(got[-1].shape) == (B, 16, 16, 32)


def test_feature_pyramids(rng):
    """AANet's pyramid on a 32-channel map, then an FPN of width 64 over
    its three levels."""
    x = rng.standard_normal((B, 16, 16, 32)).astype(np.float32)
    outs = check(rng, jfeat.FeaturePyramid(), stereo_features.FeaturePyramid(32), [x])
    assert [tuple(o.shape) for o in outs] == [(B, 16, 16, 32), (B, 8, 8, 64), (B, 4, 4, 128)]
    levels = [o.numpy() for o in outs]
    outs = check(rng, jfeat.FeaturePyramidNetwork(out_channels=64),
                 stereo_features.FeaturePyramidNetwork((32, 64, 128), out_channels=64),
                 [levels])
    assert [tuple(o.shape)[1:] for o in outs] == [(16, 16, 64), (8, 8, 64), (4, 4, 64)]


@pytest.mark.parametrize("decoder", ["none", "hourglass"])
def test_mobilenetv2_feature_stages(rng, decoder):
    """The MobileNetV2 trunk's six maps at 64² (and the hourglass's seventh,
    24 channels at /4)."""
    got = check(rng, jfeat.MobileNetV2Feature(decoder=decoder),
                stereo_features.MobileNetV2Feature(decoder=decoder), [image(rng, 64, 64)])
    shapes = [(B, 64 // d, 64 // d, c) for d, c in MOBILE_TAPS]
    if decoder == "hourglass":
        shapes.append((B, 16, 16, 24))
    assert [tuple(g.shape) for g in got] == shapes


def test_legacy_segmentation_heads(rng):
    """``SegmentationBranches`` (classes at 1/2), ``SegmentationDeeplabV3``
    (resized to 64²) and ``SimpleSegmentation`` of depth 1–3 on random
    maps of the trunk's shapes at 64²."""
    feats = mobile_feats(rng, 64)
    got = check(rng, jlegacy.SegmentationBranches(num_classes=19),
                legacy_segmentation.SegmentationBranches(num_classes=19), [feats])
    assert tuple(got[0].shape) == (B, 32, 32, 19) and got[0].dtype == torch.float32
    got = check(rng, jlegacy.SegmentationDeeplabV3(num_classes=19),
                legacy_segmentation.SegmentationDeeplabV3(num_classes=19), [feats[5], (64, 64)])
    assert tuple(got[0].shape) == (B, 64, 64, 19)
    x = rng.standard_normal((B, 16, 16, 32)).astype(np.float32)
    for depth in (1, 2, 3):
        got = check(rng, jlegacy.SimpleSegmentation(num_classes=19, depth=depth),
                    legacy_segmentation.SimpleSegmentation(num_classes=19, depth=depth), [x])
        assert tuple(got[0].shape) == (B, 16, 16, 19)


def test_disparity_feature_head(rng):
    """``DisparityFeature`` on random maps of the trunk's shapes at 96²:
    the ASPP decoder to full resolution, then GANet's deformable U-net, 32
    channels at 1/3."""
    got = check(rng, jlegacy.DisparityFeature(), legacy_segmentation.DisparityFeature(),
                [mobile_feats(rng, 96)])
    assert tuple(got[0].shape) == (B, 32, 32, 32)


class NHWCResBlock(stereo_features.ResBlock):
    """``ResBlock`` (NCHW inside the extractors) on NHWC maps."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("which", ["res_block", "ganet_mdconv"])
def test_training_forward_matches_jax(rng, which):
    """In training: a projecting ``_ResBlock`` alone at 1e-4, and the
    deformable GANet extractor whole at 1e-2, outputs and running stats."""
    if which == "res_block":
        x = rng.standard_normal((B, 16, 16, 32)).astype(np.float32)
        check(rng, jfeat._ResBlock(64, stride=2), NHWCResBlock(32, 64, stride=2),
              [x], train=True, tol=1e-4, key="res0")
    else:
        check(rng, jfeat.GANetFeature(feature_mdconv=True),
              stereo_features.GANetFeature(feature_mdconv=True), [image(rng, 48, 48)],
              train=True)


def test_make_stereo_feature_table():
    """The factory's five kinds, the keyword it passes on, and its error."""
    assert set(stereo_features.STEREO_FEATURES) == {"stereonet", "psmnet", "gcnet", "ganet",
                                                    "mobilenetv2"}
    for kind, cls in stereo_features.STEREO_FEATURES.items():
        assert type(stereo_features.make_stereo_feature(kind)) is cls
    m = stereo_features.make_stereo_feature("mobilenetv2", dtype=torch.bfloat16,
                                            decoder="hourglass")
    assert m.dtype == torch.bfloat16 and hasattr(m, "up2")
    with pytest.raises(NotImplementedError, match="stereo feature aanet"):
        stereo_features.make_stereo_feature("aanet")
