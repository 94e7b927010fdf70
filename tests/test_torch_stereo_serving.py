"""Stereo serving of the port (``make_stereo_serving_fn``, ``inference
--stereo``) against the JAX package's, on the CPU in float32.

- ``make_stereo_serving_fn`` against JAX's on the same weights
  (``random_variables``, offset convs included) at 64 × 128: disparity to
  1e-4 of max|·|, labels equal on ≥ 99.9 % of pixels, the labels through
  the fused head's route (K1's plain version on the CPU) once a batch.
- ``inference --stereo`` from a port checkpoint on two 60 × 120 pairs
  padded to 64 × 128 and cropped back, against JAX's forward as JAX's CLI
  runs it (zero pad at the top and right, s2d pack, crop, ``disp × 256``
  clipped to 16 bits): the 16-bit values within 1 LSB on ≥ 99.9 % of
  pixels. The StereoNet head's output conv is scaled down so that the
  disparities stay inside the 16-bit range.
- The entry points need the card unless asked for the CPU.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu.models.serving import (  # noqa: E402
    make_stereo_serving_fn as jax_stereo_serving)
from doubly_contrastive_semseg_tpu.models.stereo import StereoDCSS as JaxStereoDCSS  # noqa: E402
from doubly_contrastive_semseg_tpu.ops.input_pipeline import s2d_pack  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import (  # noqa: E402
    build_stereo_model, make_stereo_serving_fn)
from doubly_contrastive_semseg_tpu_torch import inference as port_inference  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.data.png import read_png, write_png  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.models import serving  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.utils import from_jax_variables  # noqa: E402
from test_torch_deeplab import close, few_threads  # noqa: E402,F401 (autouse)
from test_torch_swiftnet_single import count_head, random_variables  # noqa: E402

B, H, W = 2, 64, 128


def port_model(params, stats, **kw):
    """A port ``StereoDCSS`` holding JAX's variables (meta build, strict load)."""
    with torch.device("meta"):
        model = build_stereo_model(device="meta", dtype="float32", **kw)
    model.load_state_dict(from_jax_variables(params, stats), strict=True, assign=True)
    return model.to(memory_format=torch.channels_last).eval()


def test_stereo_serving_matches_jax(rng, monkeypatch):
    kw = dict(max_disp=32, refinement_type="disp_sem", deform_impl="gather",
              train_semantic=True)
    jmodel = JaxStereoDCSS(**kw)
    left, right = (rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32) for _ in range(2))
    params, stats = random_variables(jmodel, jnp.asarray(left), rng, jnp.asarray(right))
    disp_j, labels_j = jax.jit(jax_stereo_serving(jmodel))(
        {"params": params, "batch_stats": stats}, jnp.asarray(left), jnp.asarray(right))
    disp_j, labels_j = np.array(disp_j), np.array(labels_j)

    model = port_model(params, stats, **kw)
    calls = count_head(monkeypatch)
    disp, labels = make_stereo_serving_fn(model, device="cpu")(left, right)
    assert disp.dtype == torch.float32 and tuple(disp.shape) == (B, H, W)
    assert labels.dtype == torch.int8 and tuple(labels.shape) == (B, H, W)
    assert len(calls) == 1, "the labels take the fused head's route once a batch"
    close(disp.numpy(), disp_j, "served disparity")
    assert (labels.numpy() == labels_j).mean() >= 0.999


def test_disparity_only_model_serves_no_labels(monkeypatch):
    model = build_stereo_model(device="cpu", max_disp=32, refinement_type="stereonet",
                               train_semantic=False, dtype="float32")
    calls = count_head(monkeypatch)
    x = torch.rand(1, H, W, 3) * 255
    disp, labels = make_stereo_serving_fn(model, device="cpu")(x, x)
    assert labels is None and not calls and tuple(disp.shape) == (1, H, W)


def test_inference_stereo_matches_jax_forward(tmp_path, rng):
    kw = dict(max_disp=32, refinement_type="semantic", deform_impl="gather",
              train_semantic=False)                     # the CLI's composition: StereoNet
    jmodel = JaxStereoDCSS(**kw)
    x = jnp.zeros((1, H // 2, W // 2, 12))
    params, stats = random_variables(jmodel, x, rng, x)
    out_conv = params["refinement"]["conv_out"]
    out_conv["kernel"] = out_conv["kernel"] * 0.01
    out_conv["bias"] = np.zeros_like(out_conv["bias"])
    forward = jax.jit(lambda xl, xr: jmodel.apply({"params": params, "batch_stats": stats},
                                                  xl, xr)["disp"])
    ckpt = tmp_path / "model.pt"
    torch.save({"model": from_jax_variables(params, stats)}, ckpt)

    oh, ow = 60, 120
    want = {}
    for side in ("left", "right"):
        os.makedirs(tmp_path / side)
    for i in range(2):
        pair = [rng.integers(0, 256, (oh, ow, 3)).astype(np.uint8) for _ in range(2)]
        for side, img in zip(("left", "right"), pair):
            write_png(tmp_path / side / f"{i:06d}_10.png", img)
        pad = ((H - oh, 0), (0, W - ow), (0, 0))
        xl, xr = (jnp.asarray(s2d_pack(np.pad(v.astype(np.float32), pad)[None])) for v in pair)
        disp = np.array(forward(xl, xr))[0][H - oh:, :ow]
        want[f"{i:06d}_10.png"] = np.clip(disp * 256.0, 0, 65535).astype(np.uint16)

    result = port_inference.main([
        "--stereo", "--input", str(tmp_path / "left"), "--resume", str(ckpt),
        "--output_dir", str(tmp_path / "out"), "--val_img_height", str(H),
        "--val_img_width", str(W), "--max_disp", "32", "--deform_impl", "gather",
        "--compute_dtype", "float32", "--device", "cpu"])
    assert [os.path.basename(p) for p in result["paths"]] == sorted(want)
    for path in result["paths"]:
        got = read_png(path)
        ref = want[os.path.basename(path)]
        assert got.dtype == np.uint16 and got.shape == (oh, ow)
        assert 0 < ref.max() < 65535, "the disparities must stay inside 16 bits"
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert (diff <= 1).mean() >= 0.999, diff.max()


def test_stereo_entry_points_need_the_card_or_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_stereo_model(max_disp=32)
    model = build_stereo_model(device="cpu", max_disp=32, dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_stereo_serving_fn(model)
    for side in ("left", "right"):
        os.makedirs(tmp_path / side)
        write_png(tmp_path / side / "0.png", np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_inference.main(["--stereo", "--input", str(tmp_path / "left")])
    assert serving.make_stereo_serving_fn is make_stereo_serving_fn
