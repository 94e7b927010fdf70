"""The port's metrics (``metrics/``) vs the JAX package's on the same
numpy-seeded inputs: each confusion function exactly, and the
``Evaluator``'s results and ``val_results.txt`` text byte for byte. Labels
carry 255 holes and predictions fall outside [0, C).

``iou_from_confusion``: the per-class IoU and the overall accuracy exactly;
the three means (mean accuracy, mean IoU, frequency-weighted accuracy) to
one float32 ulp. They are float32 sums over the classes, and XLA's CPU
reduction adds in an order of its own: against 2000 random vectors,
``jnp.nanmean`` differed from a left-to-right sum, from torch's and from a
float64 sum rounded once, each in some cases, by one ulp."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from doubly_contrastive_semseg_tpu import metrics as jm  # noqa: E402
from doubly_contrastive_semseg_tpu_torch import metrics as tm  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.metrics import evaluator as tev  # noqa: E402
from doubly_contrastive_semseg_tpu_torch.metrics import meters as tmeters  # noqa: E402

C, W = 19, 4


def labels(rng, shape=(3, 16, 24)):
    gt = rng.integers(0, C, shape).astype(np.int32)
    gt[rng.random(shape) < 0.2] = 255
    pred = rng.integers(-2, C + 3, shape).astype(np.int32)  # clipped into range
    return gt, pred


def both(fn_j, fn_t, *arrays, **kw):
    want = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw)
    return got, want


def test_confusion_matrix_matches_jax(rng):
    gt, pred = labels(rng)
    got, want = both(jm.confusion_matrix, tm.confusion_matrix, gt, pred, num_classes=C)
    assert got.dtype == torch.float32 and tuple(got.shape) == (C, C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum().item() == (gt < C).sum()


def test_confusion_matrix_per_weather_matches_jax(rng):
    gt, pred = labels(rng, (4, 8, 8))
    weather = np.array([2, 0, 2, W], np.int32)  # the last id is out of range
    got, want = both(jm.confusion_matrix_per_weather, tm.confusion_matrix_per_weather,
                     gt, pred, weather, num_classes=C, weather_num=W)
    assert got.dtype == torch.float32 and tuple(got.shape) == (W, C, C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_weather_confusion_matrix_matches_jax(rng):
    gt = rng.integers(0, W, 64).astype(np.int32)
    logits = rng.standard_normal((64, W)).astype(np.float32)
    (cm, acc), (cm_j, acc_j) = both(jm.weather_confusion_matrix,
                                    tm.weather_confusion_matrix, gt, logits, weather_num=W)
    assert cm.dtype == acc.dtype == torch.float32 and tuple(cm.shape) == (W, W)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(cm_j))
    assert acc.item() == float(acc_j)


def test_iou_from_confusion_matches_jax(rng):
    gt, pred = labels(rng, (2, 32, 32))
    cm = np.array(jm.confusion_matrix(jnp.asarray(gt), jnp.asarray(pred), C))
    cm[3] = 0.0      # class 3 never in the ground truth...
    cm[:, 3] = 0.0   # ...nor predicted: IoU NaN, out of the means
    cm[5] = 0.0      # class 5 only predicted: IoU 0, accuracy NaN
    got = tm.iou_from_confusion(torch.from_numpy(cm))
    want = jm.iou_from_confusion(jnp.asarray(cm))
    assert set(got) == set(want)
    for k in ("Class IoU", "Overall Acc"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("Mean Acc", "Mean IoU", "FreqW Acc"):
        np.testing.assert_array_max_ulp(got[k].numpy(), np.asarray(want[k]), maxulp=1)
    assert np.isnan(got["Class IoU"][3].item()) and np.isfinite(got["Mean IoU"].item())


def matrices(rng):
    cm = rng.integers(0, 500, (C, C)).astype(np.float32)
    cm[7] = 0.0
    cm[:, 7] = 0.0
    cm_w = rng.integers(0, 50, (W, C, C)).astype(np.float32)
    cm_w[1] = 0.0    # a weather with no pixels
    cm_weather = rng.integers(0, 20, (W, W)).astype(np.float32)
    return cm, cm_w, cm_weather


@pytest.mark.parametrize("gan_based", [False, True])
def test_evaluator_report_is_byte_identical(rng, tmp_path, gan_based):
    cm, cm_w, cm_weather = matrices(rng)
    gt, pred = labels(rng, (2, 8, 8))
    weather_logits = rng.standard_normal((2, W))
    texts, results = [], []
    for name, mod in (("jax", jm), ("port", tm)):
        ev = mod.Evaluator(C, W)
        ev.merge_device_batch(cm, cm_w, cm_weather, weather_acc=0.625)
        ev.add_batch(gt, pred % C, gt_weather=np.array([0, 3]))
        ev.add_batch_weather(np.array([1, 2]), weather_logits)
        path = tmp_path / f"{name}_val_results.txt"
        res = ev.get_results()
        scalars = (ev.Pixel_Accuracy(), ev.Pixel_Accuracy_Class(),
                   ev.Mean_Intersection_over_Union(str(path)),
                   ev.Frequency_Weighted_Intersection_over_Union(),
                   ev.Mean_Intersection_over_Union_each_weather(str(path)),
                   ev.get_weather_results(str(path), gan_based=gan_based),
                   mod.Evaluator.to_str(res))
        texts.append(path.read_bytes())
        results.append((res, scalars))
    assert texts[0] == texts[1] and len(texts[0]) > 1000
    np.testing.assert_equal(results[1], results[0])


def test_evaluator_names_and_empty_weather_match_jax():
    from doubly_contrastive_semseg_tpu.metrics import evaluator as jev

    assert tev.CITYSCAPES_CLASS_NAMES == jev.CITYSCAPES_CLASS_NAMES
    assert tev.WEATHER_NAMES == jev.WEATHER_NAMES
    for mod in (jm, tm):  # no weather counts: the mean of the batch accuracies
        ev = mod.Evaluator(C, W)
        ev.merge_device_batch(np.eye(C), weather_acc=0.5)
        ev.merge_device_batch(np.eye(C), weather_acc=0.25)
        assert ev.get_weather_results() == 0.375


def test_meters_match_jax(monkeypatch):
    from doubly_contrastive_semseg_tpu.metrics import meters as jmeters

    out = []
    for mod in (jmeters, tmeters):
        am, tam = mod.AverageMeter(), mod.TimeAverageMeter()
        for i, v in enumerate((1.0, 2.5, 4.0)):
            am.update("loss", v)
            am.update("acc", v / 10)
            tam.update(v, n=i + 1)
        am.reset("acc")
        ticks = iter((10.0, 10.25))
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        with mod.Timer() as t:
            pass
        out.append((am.get_results("loss"), am.get_results("acc"), tam.val, tam.sum,
                    tam.count, tam.avg, t.elapsed))
        am.reset_all()
        assert am.get_results("loss") == 0.0
    assert out[0] == out[1] == (2.5, 0.0, 4.0, 18.0, 6, 3.0, 0.25)
