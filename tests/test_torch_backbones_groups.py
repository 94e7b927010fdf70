"""The six WeatherNet backbones ported last (``resnet18_single``,
``resnet18_hourglass``, ``resnet18_rgbd``, ``resnet18_back``,
``mobilenetv2``, ``efficientnetb0``): ADAM's parameter groups against
JAX's labels, and ``--pretrained`` (``utils/pretrained.py``) against JAX's
``load_pretrained``, on the CPU; helpers from
``test_torch_swiftnet_single.py``.

``--pretrained`` loads exactly what JAX loads: JAX converts a checkpoint to
its own module paths and merges by path and shape, so a single-scale
SwiftNet's lands only on the trio's ``stem``/``trunk``/``spp`` tree and a
pyramid's (or torchvision's) only on the pyramids' names; where the port's
names coincide (the trio keeps the reference's ``conv1``, ``layer*``) it
drops what JAX cannot reach. A checkpoint without ``conv1.weight`` (an
EfficientNet's) raises ``KeyError`` in both.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.config import parse_args  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.params import \
    label_params_for_optimizer as jax_labels  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.torch_convert import \
    load_pretrained as jax_load_pretrained  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import build_model  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import from_jax_variables, load_pretrained  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils.params import label_params_for_optimizer  # noqa: E402
from test_torch_deeplab import few_threads  # noqa: E402,F401 (autouse)
from test_torch_deeplab import port_from_jax  # noqa: E402
from test_torch_swiftnet_single import jax_model, port_config, random_variables  # noqa: E402

S = 64
CRITERION = "supcon_pixelcontrast_focal"
PYRAMIDS = ("mobilenetv2", "efficientnetb0", "resnet18_back")
SIX = ("resnet18_single", "resnet18_hourglass", "resnet18_rgbd", "resnet18_back",
       "mobilenetv2", "efficientnetb0")


def assert_loads_as_jax(path, params, stats, model):
    """JAX's ``load_pretrained`` + ``from_jax_variables`` and the port's
    ``load_pretrained`` from the same start: the same tensors, the same
    count. Returns the count."""
    p, s, n_jax = jax_load_pretrained(params, stats, path)
    want = from_jax_variables(p, s)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    n = load_pretrained(model, path)
    assert n == n_jax
    got = model.state_dict()
    assert set(got) == set(want)
    changed = 0
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], w), k
            changed += not torch.equal(w, start[k])
    assert changed == n
    return n


@pytest.mark.parametrize("name", SIX)
def test_param_groups_match_jax(name):
    """ADAM's groups by JAX's module paths: the pyramids' stem and trunk
    ``fine_tune`` (the MobileNetV2 pyramid's ``conv1_kernel`` and ``bn1_*``
    too, by name), the EfficientNet pyramid's none; the single-scale trio's
    stems and trunks sit under JAX's ``stem``/``trunk`` and are
    ``random_init``, but for the hourglass's ``conv1b``. JAX's label tree
    goes through ``from_jax_variables`` as constant arrays, one code a
    label."""
    jcfg = parse_args(["--model", name, "--criterion", CRITERION])
    cfg = port_config(name, criterion=CRITERION)
    params, stats = random_variables(jax_model(name), jnp.zeros((4, 128, 128, 3)),
                                 np.random.default_rng(0), train=True,
                                 return_supcon_feature=True)
    codes = ("fine_tune", "random_init", "frozen")
    coded = jax.tree_util.tree_map(lambda p, lab: np.full(p.shape, codes.index(lab), np.float32),
                                   params, jax_labels(params, jcfg))
    want = {k: codes[int(v.flatten()[0])] for k, v in from_jax_variables(coded, {}).items()}
    got = label_params_for_optimizer(port_from_jax(cfg, params, stats), cfg)
    assert got == want
    fine = {k for k, v in got.items() if v == "fine_tune"}
    fe = "net.feature_extractor."
    if name in ("resnet18_single", "resnet18_rgbd", "efficientnetb0"):
        assert not fine
    elif name == "resnet18_hourglass":
        assert fine and all(k.startswith(fe + "conv1b.") for k in fine)
    else:
        assert fe + "conv1.weight" in fine and fe + "bn1_2.weight" in fine


# ---- --pretrained: the pyramids ---------------------------------------------------------------------

def own_reference(name, seed):
    """A reference-format checkpoint of ``name`` under the port's names, the
    stem as the reference's dense 7×7 (32 filters for MobileNetV2)."""
    with torch.device("meta"):
        model = build_model(port_config(name), device="meta")
    g = torch.Generator().manual_seed(seed)
    state = {k[len("net."):]: (torch.rand(v.shape, generator=g) + 0.5
                               if v.is_floating_point() else torch.tensor(0))
             for k, v in model.state_dict().items() if k.startswith("net.")}
    if name == "mobilenetv2":
        state["feature_extractor.conv1.weight"] = torch.rand((32, 3, 7, 7), generator=g)
    return {"model_state": state}


@pytest.mark.parametrize("name", PYRAMIDS)
@pytest.mark.parametrize("kind", ["torchvision", "resnet18", "own"])
def test_load_pretrained_matches_jax(tmp_path, rng, name, kind):
    """A torchvision ResNet-18, a reference pyramid RN18 checkpoint and the
    model's own family's through JAX's ``load_pretrained`` and
    ``from_jax_variables`` and through the port's: the same tensors, the
    same count, where JAX skips a tensor (another name or shape) the port
    skips it, and where JAX raises (an EfficientNet checkpoint has no
    ``conv1.weight``) the port raises the same ``KeyError``."""
    from test_torch_pretrained import reference_checkpoint, torchvision_resnet18

    blob = {"torchvision": lambda: torchvision_resnet18(3),
            "resnet18": lambda: reference_checkpoint(4),
            "own": lambda: own_reference(name, 5)}[kind]()
    path = str(tmp_path / "ckpt.pth")
    torch.save(blob, path)
    jmodel = jax_model(name)
    params, stats = random_variables(jmodel, jnp.zeros((4, 128, 128, 3)), rng, train=True,
                                     return_supcon_feature=True)
    cfg = port_config(name, criterion="supcon_pixelcontrast_focal")
    model = port_from_jax(cfg, params, stats)
    if kind == "own" and name == "efficientnetb0":
        with pytest.raises(KeyError, match="conv1.weight"):
            jax_load_pretrained(params, stats, path)
        with pytest.raises(KeyError, match="conv1.weight"):
            load_pretrained(model, path)
        return
    n = assert_loads_as_jax(path, params, stats, model)
    assert n > 0 or (kind == "torchvision" and name != "resnet18_back")


# ---- --pretrained: the single-scale trio -----------------------------------------------------------------

def reference_single_scale(name, seed):
    """A reference trainer checkpoint of a single-scale SwiftNet, built from
    the port's module names (the reference's) with random tensors, plus
    ``conv_final`` for the hourglass (the reference builds it, never calls
    it)."""
    with torch.device("meta"):
        model = build_model(port_config(name, criterion=CRITERION),
                            device="meta")
    g = torch.Generator().manual_seed(seed)
    sd = {k: (torch.rand(v.shape, generator=g) + 0.5 if v.is_floating_point()
              else torch.tensor(0)) for k, v in model.state_dict().items()}
    state = {k[len("net."):]: v for k, v in sd.items() if k.startswith("net.")}
    if name == "resnet18_hourglass":
        state["feature_extractor.conv_final.weight"] = torch.rand(1, 64, 3, 3, generator=g)
    return {"model_state": state,
            "weather_clf": {"fc.weight": sd["weather_clf.fc.weight"],
                            "fc.bias": sd["weather_clf.fc.bias"]}}


@pytest.mark.parametrize("ckpt,target", [
    ("resnet18_hourglass", "resnet18_hourglass"), ("resnet18_rgbd", "resnet18_single"),
    ("resnet18_single", "resnet18"), ("torchvision", "resnet18_rgbd")])
def test_load_pretrained_single_scale_matches_jax(tmp_path, rng, ckpt, target):
    """``--pretrained`` with a single-scale SwiftNet checkpoint: JAX's
    ``load_pretrained`` (``convert_reference_weathernet`` →
    ``convert_reference_swiftnet_single``) and ``from_jax_variables`` give
    the same tensors as the port's, and count as many, onto a model of the
    same family, of a sibling and of the pyramid; a torchvision ResNet onto
    a single-scale model loads what JAX loads (nothing)."""
    from test_torch_pretrained import torchvision_resnet18

    jmodel = jax_model(target)
    x = jnp.zeros((2, S, S, 3))
    params, stats = random_variables(jmodel, x, rng, train=True, return_supcon_feature=True)
    blob = torchvision_resnet18(3) if ckpt == "torchvision" else reference_single_scale(ckpt, 4)
    path = str(tmp_path / "ckpt.pth")
    torch.save(blob, path)
    model = port_from_jax(port_config(target, criterion=CRITERION), params, stats)
    n = assert_loads_as_jax(path, params, stats, model)
    assert n > (200 if ckpt == target else 0) or ckpt == "torchvision"
