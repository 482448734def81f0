"""Classification metrics in numpy (the JAX package's ``ops/metrics.py``).

Replacements for ``sklearn.metrics.confusion_matrix`` and
``classification_report`` as the reference's final evaluation uses them:
the same dict keys (``"f1-score"``, ``"macro avg"``, ``"weighted avg"``)
and the same zero-division rule (0 where a denominator is 0).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def confusion_matrix(labels, preds, num_classes: int) -> np.ndarray:
    """(num_classes, num_classes) counts; rows = true, cols = predicted."""
    labels = np.asarray(labels, np.int64)
    preds = np.asarray(preds, np.int64)
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (labels, preds), 1)
    return cm


def precision_recall_f1(cm: np.ndarray):
    """Per-class precision, recall, F1 and support from a confusion
    matrix."""
    tp = np.diag(cm).astype(np.float64)
    pred_pos = cm.sum(axis=0).astype(np.float64)
    true_pos = cm.sum(axis=1).astype(np.float64)
    precision = np.divide(tp, pred_pos, out=np.zeros_like(tp),
                          where=pred_pos > 0)
    recall = np.divide(tp, true_pos, out=np.zeros_like(tp),
                       where=true_pos > 0)
    denom = precision + recall
    f1 = np.divide(2 * precision * recall, denom, out=np.zeros_like(tp),
                   where=denom > 0)
    return precision, recall, f1, cm.sum(axis=1)


def classification_report(labels, preds,
                          target_names: Sequence[str]) -> Dict:
    """sklearn-compatible dict: per-class precision/recall/f1-score/support
    plus accuracy and the macro and weighted averages."""
    n = len(target_names)
    cm = confusion_matrix(labels, preds, n)
    precision, recall, f1, support = precision_recall_f1(cm)
    total = int(cm.sum())
    report: Dict = {}
    for i, name in enumerate(target_names):
        report[name] = {
            "precision": float(precision[i]),
            "recall": float(recall[i]),
            "f1-score": float(f1[i]),
            "support": int(support[i]),
        }
    report["accuracy"] = float(np.trace(cm) / total) if total else 0.0
    w = support / max(total, 1)
    report["macro avg"] = {
        "precision": float(precision.mean()),
        "recall": float(recall.mean()),
        "f1-score": float(f1.mean()),
        "support": total,
    }
    report["weighted avg"] = {
        "precision": float((precision * w).sum()),
        "recall": float((recall * w).sum()),
        "f1-score": float((f1 * w).sum()),
        "support": total,
    }
    return report
