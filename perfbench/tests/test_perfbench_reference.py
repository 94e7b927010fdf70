"""The plain reference against the port at a small float32 size on the CPU:
the augmentation, the two-view training forward and loss, the first three
steps of Adam, and the served labels. The reference imports nothing of the
port; this test imports both."""

import pytest
import torch

from perfbench.drivers import serve, train_step
from perfbench.harness import compare, seeded
from perfbench.reference import augment as ref_augment
from perfbench.tests.tiny import cell, cells, threads

from doubly_contrastive_semseg_tpu_torch.data.device_augment import apply_augment

threads()


def test_augmentation_matches_the_port():
    _, config, mix = cell("rn18.train.recipe768")
    pool = seeded.frame_pool(5, 4, 64, 128, "cpu", pin=False)
    table = train_step.crop_table(5, 3, 2, 64, 128, 32, "cpu")
    for i in range(3):
        p = (table[i, 0], table[i, 1], table[i, 2])
        im, lb, wt = pool["left"][:2], pool["label"][:2], pool["weather"][:2].clone()
        wt[0] = seeded.NIGHT
        got = apply_augment(im, lb, wt, p, crop=32, num_classes=19, two_crop=True,
                            use_gamma=True)
        ref = ref_augment.augment(im, lb, wt, p, 32, 19)
        assert torch.equal(got["label"], ref["label"])
        # the two sum the bicubic taps in different orders; γ = 0.4 steepens
        # differences near black, so the bar is 1e-2 of a grey level
        assert torch.allclose(got["left"], ref["left"], atol=1e-2, rtol=0)
        assert torch.allclose(got["label_distance_weight"], ref["alpha"], atol=1e-6, rtol=1e-6)


def test_flood_matches_the_port_on_random_maps():
    from doubly_contrastive_semseg_tpu_torch.ops.edt import nearest_diff_label_distance
    gen = torch.Generator().manual_seed(0)
    labels = torch.randint(0, 3, (2, 37, 53), generator=gen).to(torch.uint8)
    assert torch.equal(ref_augment.other_label_distance(labels),
                       nearest_diff_label_distance(labels))


def program_and_reference(name: str, dtype: str, seed: int = 11):
    _, config, mix = cell(name, dtype=dtype)
    prog = train_step.Program(config, mix, seed, "cpu")
    ref = mod_of(config).build().to(torch.float64 if dtype == "float64" else torch.float32)
    ref.load_state_dict(seeded.state_dict(prog.shapes, seed, "cpu"))
    return config, mix, prog, ref


def mod_of(config):
    from perfbench.harness import manifest
    return manifest.reference(config["reference"])


# DeepLab's training pair is held too, though no cell runs it yet (PERF.md §7)
@pytest.mark.parametrize("name", ["rn18.train.recipe768", "deeplabv3plus_r101/train_recipe768"])
def test_training_forward_and_loss_match_the_port(name):
    """The two-view training forward in float64 (the port's exactness
    dtype; its heads hand float32 logits on, so 1e-6), and the loss of the
    same outputs, batch and draws through both sides' loss code."""
    from doubly_contrastive_semseg_tpu_torch.config import Config
    from doubly_contrastive_semseg_tpu_torch.losses import compute_total_loss
    from doubly_contrastive_semseg_tpu_torch.models.blocks import set_dropout_generator
    from perfbench.reference import losses as ref_losses
    config, mix, prog, ref = program_and_reference(name, "float64")
    f, p = prog.feed.frames(0), prog.table[0]
    images, labels, weather = prog.pool["left"][f], prog.pool["label"][f], prog.pool["weather"][f]
    aug = ref_augment.augment(images, labels, weather, (p[0], p[1], p[2]), mix["crop"], 19)
    prog.model.train()
    ref.train()
    set_dropout_generator(prog.model, train_step.step_generator("cpu", 11, 0))
    got = prog.model(aug["left"], return_supcon_feature=True)
    want = ref(aug["left"], two_view=True, generator=train_step.step_generator("cpu", 11, 0))
    for key in ("seg_beforeup", "fine_feat0"):
        a, b = got[key].double(), want[key].permute(0, 2, 3, 1).double()
        assert (a - b).abs().max() <= 1e-6 * b.abs().max(), key
    assert torch.allclose(got["supcon_proj"].double(), want["supcon_proj"].double(), rtol=1e-6,
                          atol=1e-6 * want["supcon_proj"].abs().max().item())
    batch = {"label": aug["label"].to(torch.int32), "label_distance_weight": aug["alpha"],
             "weather": weather}
    cfg = Config(**config["program"]).finalize()
    total, _ = compute_total_loss(cfg, got, batch, prog.class_weight,
                                  train_step.step_generator("cpu", 11, 1))
    ref_total = ref_losses.total(want, aug["label"], aug["alpha"], weather, prog.class_weight,
                                 train_step.step_generator("cpu", 11, 1), 19)
    assert abs(float(total) - float(ref_total)) <= 1e-5 * abs(float(ref_total))


def test_first_three_steps_match_the_port():
    """The whole check at a tiny size in float64: step 1's loss to the
    float32 of the losses; the gradients and changes within a few per cent
    (the tiny maps' batch statistics, over a handful of values, amplify the
    losses' float32 rounding)."""
    _, config, mix = cell("rn18.train.recipe768", dtype="float64")
    prog = train_step.Program(config, mix, 11, "cpu")
    first = prog.first_steps()
    prog.free()
    ref = prog.reference()
    assert abs(first["loss"][0] - ref["loss"][0]) <= 1e-5 * ref["loss"][0]
    gaps = compare.train_gaps(first, ref)
    assert gaps["loss_gap"] < 1e-3 and gaps["grad_gap"] < 3e-2 and gaps["change_gap"] < 5e-2, gaps


@pytest.mark.parametrize("name", cells("serve"))
def test_served_labels_match_the_port_in_float32(name):
    _, config, mix = cell(name, dtype="float32")
    shapes = serve.reference_shapes(config)
    model = serve.program_model(config, 3, "cpu", shapes)
    fn = serve.make_serving_fn(model, device="cpu")
    pool = seeded.frame_pool(3, 2, 64, 128, "cpu", pin=False)
    labels = fn(pool["left"])
    ref = serve.reference_model(config, 3, "cpu", shapes)
    with torch.no_grad():
        for f in range(2):
            logits = ref(pool["left"][f:f + 1])["seg_beforeup"][0]
            assert compare.label_gaps(logits, labels[f])["label_gap"] < 1e-4
