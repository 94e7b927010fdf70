"""``--pretrained`` loading (``utils/pretrained.py``) vs the JAX package's.

A seeded torchvision-shaped ResNet-18 ``.pth`` and a reference-format
trainer checkpoint (``model_state`` with ``supcon_projection`` and
``weather_clf``) go through JAX's ``load_pretrained`` and then
``from_jax_variables``, and through the port's ``load_pretrained``, onto
models that start from the same variables: every tensor is equal, and both
count the same tensors loaded. So do reference DeepLab and ENet trainer
checkpoints, which JAX routes to ``convert_reference_deeplab`` and
``convert_reference_enet``. Other families' checkpoints onto the flagship
load or raise as JAX's do (the single-scale SwiftNets' own, in
``test_torch_swiftnet_single.py``).
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.config import parse_args as jax_parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu.models import DCSSModel as JaxDCSSModel  # noqa: E402
from doubly_contrastive_semseg_tpu.models import build_model as jax_build_model  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.torch_convert import jax_to_py  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.torch_convert import \
    load_pretrained as jax_load_pretrained  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import Config, build_model  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import from_jax_variables, load_pretrained  # noqa: E402
from test_torch_deeplab import jax_tree_from_port, port_from_jax  # noqa: E402

BLOCKS = {1: (64, 64), 2: (64, 128), 3: (128, 256), 4: (256, 512)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes at once,
    and torch's default of one thread a core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def torchvision_resnet18(seed):
    """A state dict with torchvision ResNet-18's names and shapes."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def bn(name, c):
        sd[f"{name}.weight"] = torch.rand(c, generator=g) + 0.5
        sd[f"{name}.bias"] = torch.randn(c, generator=g) * 0.1
        sd[f"{name}.running_mean"] = torch.randn(c, generator=g) * 0.1
        sd[f"{name}.running_var"] = torch.rand(c, generator=g) + 0.5
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)

    sd["conv1.weight"] = torch.randn((64, 3, 7, 7), generator=g)
    bn("bn1", 64)
    for s, (c_in, c_out) in BLOCKS.items():
        for b in range(2):
            i = c_in if b == 0 else c_out
            sd[f"layer{s}.{b}.conv1.weight"] = torch.randn((c_out, i, 3, 3), generator=g)
            bn(f"layer{s}.{b}.bn1", c_out)
            sd[f"layer{s}.{b}.conv2.weight"] = torch.randn((c_out, c_out, 3, 3), generator=g)
            bn(f"layer{s}.{b}.bn2", c_out)
            if b == 0 and c_in != c_out:
                sd[f"layer{s}.{b}.downsample.0.weight"] = torch.randn((c_out, c_in, 1, 1),
                                                                      generator=g)
                bn(f"layer{s}.{b}.downsample.1", c_out)
    sd["fc.weight"] = torch.randn((1000, 512), generator=g)
    sd["fc.bias"] = torch.randn(1000, generator=g)
    return sd


def reference_checkpoint(seed):
    """A reference trainer checkpoint: WeatherNet's ``model_state`` (the
    port's ``net.*`` names without ``net.``), the SupCon projection as a
    ``Sequential(Linear, ReLU, Linear)`` and the weather classifier."""
    cfg = Config(compute_dtype="float32", criterion="supcon_pixelcontrast_focal")
    model = build_model(cfg, device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed)
    sd = {k: (torch.rand(v.shape, generator=g) + 0.5 if v.is_floating_point() else v)
          for k, v in model.state_dict().items()}
    return {
        "model_state": {k[len("net."):]: v for k, v in sd.items() if k.startswith("net.")},
        "supcon_projection": {"0.weight": sd["projection.fc1.weight"],
                              "0.bias": sd["projection.fc1.bias"],
                              "2.weight": sd["projection.fc2.weight"],
                              "2.bias": sd["projection.fc2.bias"]},
        "weather_clf": {"fc.weight": sd["weather_clf.fc.weight"],
                        "fc.bias": sd["weather_clf.fc.bias"]},
        "epoch": 12, "optimizer_state": {"note": "ignored"},
    }


@pytest.fixture(scope="module")
def jax_start():
    """The f32 JAX DCSSModel's variables for training (with projection)."""
    model = JaxDCSSModel(backbone="resnet18", num_classes=19, weather_num=4, dtype=jnp.float32)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3)), train=True,
                   return_supcon_feature=True)
    return jax_to_py(v["params"]), jax_to_py(v["batch_stats"])


@pytest.mark.parametrize("kind", ["torchvision", "reference"])
def test_load_pretrained_matches_jax(tmp_path, jax_start, kind):
    blob = torchvision_resnet18(3) if kind == "torchvision" else reference_checkpoint(4)
    path = str(tmp_path / f"{kind}.pth")
    torch.save(blob, path)
    params, stats = jax_start
    p, s, n_jax = jax_load_pretrained(params, stats, path)
    want = from_jax_variables(p, s)

    model = build_model(Config(compute_dtype="float32", criterion="supcon_pixelcontrast_focal"),
                        device="cpu", seed=9)
    model.load_state_dict(from_jax_variables(params, stats), strict=True)
    n = load_pretrained(model, path)
    assert n == n_jax > 100
    got = model.state_dict()
    assert set(got) == set(want)
    start, changed = from_jax_variables(params, stats), 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
        changed += not torch.equal(w, start[k])
    assert changed == n


def reference_family_checkpoint(cfg, seed):
    """A reference trainer checkpoint of the DeepLab family (``model_state``
    with the port's names) or of ENet (the port's ``net.*`` names without
    ``net.``), with the projection and weather heads beside it."""
    model = build_model(cfg, device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed)
    sd = {k: (torch.rand(v.shape, generator=g) + 0.5 if v.is_floating_point() else v)
          for k, v in model.state_dict().items()}
    strip = "net." if cfg.model == "enet" else ""
    return {
        "model_state": {k[len(strip):]: v for k, v in sd.items()
                        if not k.startswith(("projection.", "weather_clf."))},
        "supcon_projection": {"0.weight": sd["projection.fc1.weight"],
                              "0.bias": sd["projection.fc1.bias"],
                              "2.weight": sd["projection.fc2.weight"],
                              "2.bias": sd["projection.fc2.bias"]},
        "weather_clf": {"fc.weight": sd["weather_clf.fc.weight"],
                        "fc.bias": sd["weather_clf.fc.bias"]},
    }


@pytest.mark.parametrize("name", ["deeplabv3plus_resnet50", "deeplabv3_mobilenet", "enet"])
def test_load_pretrained_deeplab_and_enet_match_jax(tmp_path, name):
    """A reference DeepLab (V3+ ResNet, V3 MobileNet) or ENet checkpoint
    through JAX's ``load_pretrained`` (``convert_reference_deeplab`` /
    ``convert_reference_enet``) and ``from_jax_variables``, and through the
    port's: the same tensors, the same count. Both start from the same
    variables (a port model's, laid out for JAX as ``test_torch_deeplab.py``
    does)."""
    cfg = Config(model=name, compute_dtype="float32", criterion="supcon_pixelcontrast_focal")
    jmodel = jax_build_model(jax_parse_args(["--model", name, "--compute_dtype", "float32"]))
    params, stats = jax_tree_from_port(build_model(cfg, device="cpu", seed=9), jmodel,
                                       jnp.zeros((4, 64, 64, 3)), train=True,
                                       return_supcon_feature=True)
    path = str(tmp_path / f"{name}.pth")
    torch.save(reference_family_checkpoint(cfg, 4), path)
    p, s, n_jax = jax_load_pretrained(params, stats, path)
    want = from_jax_variables(p, s)

    model = port_from_jax(cfg, params, stats)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    n = load_pretrained(model, path)
    assert n == n_jax > 100
    got = model.state_dict()
    assert set(got) == set(want)
    changed = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
        changed += not torch.equal(w, start[k])
    assert changed == n


def test_other_model_families_raise(tmp_path, jax_start):
    """Other families' checkpoints onto the flagship: one without
    ``conv1.weight`` (an EfficientNet's) raises ``KeyError`` in both
    loaders; a single-scale SwiftNet's lands, in JAX, on the trio's
    ``stem``/``trunk``/``spp`` tree, so only its seg head reaches the
    pyramid, in both."""
    params, stats = jax_start
    model = build_model(Config(compute_dtype="float32", criterion="supcon_pixelcontrast_focal"),
                        device="cpu")
    model.load_state_dict(from_jax_variables(params, stats), strict=True)
    path = str(tmp_path / "x.pth")
    torch.save({"model_state": {"feature_extractor._conv_stem.weight": torch.zeros(32, 3, 3, 3)}},
               path)
    with pytest.raises(KeyError, match="conv1.weight"):
        jax_load_pretrained(params, stats, path)
    with pytest.raises(KeyError, match="conv1.weight"):
        load_pretrained(model, path)
    g = torch.Generator().manual_seed(5)
    single = {"feature_extractor.spp.spp.spp_bn.conv.weight": torch.rand(128, 512, 1, 1,
                                                                          generator=g),
              "feature_extractor.conv1.weight": torch.rand(64, 3, 7, 7, generator=g),
              "segmentation.conv.weight": torch.rand(19, 128, 1, 1, generator=g),
              "segmentation.conv.bias": torch.rand(19, generator=g)}
    torch.save({"model_state": single}, path)
    _, _, n_jax = jax_load_pretrained(params, stats, path)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert load_pretrained(model, path) == n_jax == 2
    moved = {k for k, v in model.state_dict().items() if not torch.equal(v, before[k])}
    assert moved == {"net.segmentation.conv.weight", "net.segmentation.conv.bias"}
