"""The port's classification metrics (``irp_tpu_torch/ops/metrics.py``)
against the JAX package's, dict for dict, and against sklearn: 10
classes, one of them absent from the labels and one never predicted, so
that each zero-division rule is reached."""

import numpy as np
import pytest

from irp_tpu.ops import metrics as jax_metrics
from irp_tpu_torch.ops import metrics

NAMES = [f"class{i}" for i in range(10)]
ABSENT, NEVER_PREDICTED = 3, 7


def _labels_preds(seed, n=400):
    rng = np.random.default_rng(seed)
    labels = rng.choice([c for c in range(10) if c != ABSENT], n)
    preds = np.where(rng.uniform(size=n) < 0.6, labels,
                     rng.integers(0, 10, n))
    preds[preds == NEVER_PREDICTED] = (NEVER_PREDICTED + 1) % 10
    assert ABSENT not in labels and NEVER_PREDICTED not in preds
    assert ABSENT in preds  # predicted, never true: recall and F1 are 0
    return labels, preds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_confusion_matrix_and_report_equal_jax(seed):
    labels, preds = _labels_preds(seed)
    cm = metrics.confusion_matrix(labels, preds, 10)
    want_cm = jax_metrics.confusion_matrix(labels, preds, 10)
    assert cm.dtype == want_cm.dtype and np.array_equal(cm, want_cm)
    for got, want in zip(metrics.precision_recall_f1(cm),
                         jax_metrics.precision_recall_f1(want_cm)):
        assert np.array_equal(got, want)
    report = metrics.classification_report(labels, preds, NAMES)
    assert report == jax_metrics.classification_report(labels, preds, NAMES)
    assert list(report) == NAMES + ["accuracy", "macro avg", "weighted avg"]
    assert report[NAMES[ABSENT]]["recall"] == 0.0
    assert report[NAMES[ABSENT]]["support"] == 0
    assert report[NAMES[NEVER_PREDICTED]]["precision"] == 0.0
    assert report[NAMES[NEVER_PREDICTED]]["f1-score"] == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_confusion_matrix_and_report_match_sklearn(seed):
    sk = pytest.importorskip("sklearn.metrics")
    labels, preds = _labels_preds(seed)
    np.testing.assert_array_equal(
        metrics.confusion_matrix(labels, preds, 10),
        sk.confusion_matrix(labels, preds, labels=range(10)))
    ours = metrics.classification_report(labels, preds, NAMES)
    theirs = sk.classification_report(labels, preds, labels=range(10),
                                      target_names=NAMES, output_dict=True,
                                      zero_division=0)
    for name in NAMES + ["macro avg", "weighted avg"]:
        for key in ("precision", "recall", "f1-score"):
            np.testing.assert_allclose(ours[name][key], theirs[name][key],
                                       atol=1e-12)
        assert ours[name]["support"] == theirs[name]["support"]
    np.testing.assert_allclose(ours["accuracy"], np.mean(labels == preds))
