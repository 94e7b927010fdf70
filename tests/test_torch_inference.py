"""The port's inference CLI (``inference.py``) vs the JAX package's
semantic inference on the same weights, on the CPU at float32.

Two PNG frames written with ``write_png`` go through the port's CLI from a
port checkpoint; JAX's model, holding the same weights (through its
``load_pretrained`` of the reference-format blob the port's weights came
from), takes the argmax of its full-resolution logits as JAX's
``inference.py`` does. ``_pred.png`` equals JAX's labels and
``_color.png`` JAX's ``ACDC.decode_target`` of them, at the native size
and resized with Pillow's bilinear filter (``--img_width/--img_height``).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from doubly_contrastive_semseg_tpu.data.acdc import ACDC as JaxACDC  # noqa: E402
from doubly_contrastive_semseg_tpu.models import DCSSModel as JaxDCSSModel  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.torch_convert import jax_to_py  # noqa: E402
from doubly_contrastive_semseg_tpu.utils.torch_convert import \
    load_pretrained as jax_load_pretrained  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import Config, build_model  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data.png import read_png, write_png  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.inference import main  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.train import (CheckpointManager, TrainState,  # noqa: E402
                                                       build_optimizer)

HW = (64, 96)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes at once,
    and torch's default of one thread a core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Two frames, a port checkpoint and the JAX variables of its weights."""
    base = tmp_path_factory.mktemp("inference")
    rng = np.random.default_rng(0)
    frames = []
    for i in range(2):
        img = rng.integers(0, 256, HW + (3,), dtype=np.uint8)
        img[: HW[0] // 2, : HW[1] // 2] //= 4           # some structure
        write_png(str(base / f"frame{i}.png"), img, "adaptive")
        frames.append(img)
    cfg = Config(compute_dtype="float32")
    model = build_model(cfg, device="cpu", seed=21)
    g = torch.Generator().manual_seed(22)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=g) + 1.0)
                m.weight.copy_(torch.rand(c, generator=g) * 0.3 + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.1)
    ckpt = CheckpointManager(str(base / "checkpoints")).save(
        "score_best_checkpoint", TrainState(model, build_optimizer(model, cfg, 1)), epoch=0)
    sd = model.state_dict()
    blob = {"model_state": {k[len("net."):]: v for k, v in sd.items() if k.startswith("net.")},
            "weather_clf": {"fc.weight": sd["weather_clf.fc.weight"],
                            "fc.bias": sd["weather_clf.fc.bias"]}}
    torch.save(blob, str(base / "reference.pth"))
    jmodel = JaxDCSSModel(backbone="resnet18", num_classes=19, weather_num=4, dtype=jnp.float32)
    v = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1,) + HW + (3,)), train=False)
    params, stats, n = jax_load_pretrained(jax_to_py(v["params"]), jax_to_py(v["batch_stats"]),
                                           str(base / "reference.pth"))
    assert n == len([k for k in sd if not k.endswith("num_batches_tracked")
                     and not k.startswith("projection.")])
    return base, frames, ckpt, jmodel, {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("size", [None, (80, 48)], ids=["native", "resized"])
def test_inference_matches_jax(setup, size):
    base, frames, ckpt, jmodel, variables = setup
    out = base / f"out_{size}"
    argv = ["--input", str(base), "--resume", ckpt, "--output_dir", str(out),
            "--compute_dtype", "float32", "--device", "cpu"]
    if size:
        argv += ["--img_width", str(size[0]), "--img_height", str(size[1])]
    result = main(argv)
    assert len(result["paths"]) == 4 and len(result["forward_s"]) == 2
    for i, img in enumerate(frames):
        if size:
            img = np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))
        logits = jmodel.apply(variables, jnp.asarray(img, jnp.float32)[None], train=False)["seg"]
        want = np.array(jnp.argmax(logits, axis=-1).astype(jnp.int32))[0]
        pred = read_png(str(out / f"frame{i}_pred.png"))
        color = read_png(str(out / f"frame{i}_color.png"))
        assert pred.shape == img.shape[:2] and pred.dtype == np.uint8
        assert len(np.unique(want)) >= 2
        np.testing.assert_array_equal(pred, want.astype(np.uint8))
        np.testing.assert_array_equal(color, JaxACDC.decode_target(want.copy()).astype(np.uint8))


def test_no_color_and_png_only(setup, tmp_path):
    base, _, ckpt, _, _ = setup
    out = tmp_path / "out"
    result = main(["--input", str(base / "frame0.png"), "--resume", ckpt, "--no-save_color",
                   "--output_dir", str(out), "--compute_dtype", "float32", "--device", "cpu"])
    assert result["paths"] == [str(out / "frame0_pred.png")]
    assert os.listdir(out) == ["frame0_pred.png"]
    jpg = tmp_path / "frame.jpg"
    jpg.write_bytes(b"not read")
    with pytest.raises(NotImplementedError, match="PNG files only"):
        main(["--input", str(jpg), "--output_dir", str(out), "--device", "cpu"])
