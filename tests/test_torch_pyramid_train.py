"""One ``supcon_pixelcontrast_focal`` train step of the MobileNetV2 and the
EfficientNet-B0 pyramids in the port vs the JAX package, at 128², batch 4
× 2 views: method and tolerances as in ``test_torch_backbones_train.py``.
EfficientNet's drop-connect masks are the ones JAX's step draws (inline
``jax.random.bernoulli``, recorded and returned from the jitted step), in
call order: every residual MBConv block, on each of the three pyramid
levels.
"""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from test_torch_backbones_train import check_train_step  # noqa: E402
from test_torch_deeplab import few_threads  # noqa: E402,F401 (autouse)
from doubly_contrastive_semseg_tpu_torch.models.blocks import DropConnect  # noqa: E402


@pytest.mark.parametrize("name", ["mobilenetv2", "efficientnetb0"])
def test_train_step_matches_jax(rng, monkeypatch, name):
    port, drawn = check_train_step(rng, monkeypatch, name, 256 if name == "mobilenetv2" else 128)
    drops = [m for m in port.modules() if isinstance(m, DropConnect)]
    if name == "efficientnetb0":
        # residual blocks 2..15 of 16 (block 0 is not residual), 3 levels each
        assert len(drops) == 9 and len(drawn) == 3 * len(drops)
        assert any(not bool(m.all()) for m in drawn)
    else:
        assert not drops and not drawn
