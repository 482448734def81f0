"""Epoch loops (the JAX package's ``train/loop.py``): ``train_epoch`` over
a batch iterator, the capped and full evaluations reduced exactly on the
host from f32 logits, best-weight snapshots, and ``train_model``'s early
stopping on validation accuracy.
"""

from __future__ import annotations

import inspect
import math
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from irp_tpu_torch.data.pipeline import CachedDataset, iter_host_batches


def host_weighted_ce(logits: np.ndarray, labels: np.ndarray,
                     class_weights=None) -> float:
    """torch CrossEntropyLoss(weight=w)'s reduction, in float64 on the
    host."""
    logits = logits.astype(np.float64)
    m = logits.max(axis=1, keepdims=True)
    logp = logits - m - np.log(np.exp(logits - m).sum(axis=1, keepdims=True))
    ce = -logp[np.arange(len(labels)), labels]
    if class_weights is None:
        return float(ce.mean()) if len(ce) else 0.0
    w = np.asarray(class_weights, np.float64)[labels]
    return float((w * ce).sum() / max(w.sum(), 1e-12))


@dataclass
class EvalResult:
    loss: float
    accuracy: float  # percent
    preds: np.ndarray
    labels: np.ndarray
    logits: np.ndarray


def _result(logits: np.ndarray, labels: np.ndarray,
            class_weights) -> EvalResult:
    preds = logits.argmax(axis=1)
    acc = 100.0 * float((preds == labels).mean()) if len(labels) else 0.0
    return EvalResult(loss=host_weighted_ce(logits, labels, class_weights),
                      accuracy=acc, preds=preds, labels=labels,
                      logits=logits)


def set_mode(model, training: bool) -> None:
    """Train or eval mode, then, for a ResNet, the frozen prefix's BN
    folded once for its fused forward (``ResNet.cache_folded_weights``:
    the identity blocks' for K1, the stem's and the blocks 0's): a mode
    switch drops that cache, and the frozen weights do not change until
    the next load.  The other families have no fused blocks."""
    model.train(training)
    cache = getattr(model.backbone, "cache_folded_weights", None)
    if cache is not None:
        cache()


def train_epoch(state, run_step: Callable, batches: Iterator,
                max_steps: Optional[int] = None) -> Tuple[object, float,
                                                          float]:
    """One epoch of ``run_step(state, batch, i) -> metrics`` over
    ``batches``; the metrics stay on the device until the end.  Returns
    (state, mean loss, mean accuracy in percent)."""
    losses, accs = [], []
    for i, batch in enumerate(batches):
        if max_steps is not None and i >= max_steps:
            break
        metrics = run_step(state, batch, i)
        losses.append(metrics["loss"])
        accs.append(metrics["accuracy"])
    if not losses:
        return state, 0.0, 0.0
    loss = float(torch.stack(losses).mean())
    acc = float(torch.stack(accs).mean()) * 100.0
    return state, loss, acc


def evaluate(model, eval_step: Callable, cached: CachedDataset, device,
             batch_size: int = 64, max_samples: Optional[int] = 512,
             class_weights=None) -> EvalResult:
    """Capped evaluation over host batches (wrap-padded tail, padding
    dropped before the reduction)."""
    all_logits, all_labels = [], []
    seen = 0
    for images, labels, n_valid in iter_host_batches(
            cached, batch_size, shuffle=False, pad_final=True):
        x = torch.from_numpy(images).to(device)
        logits = eval_step(model, x).cpu().numpy()[:n_valid]
        if max_samples is not None and seen + n_valid > max_samples:
            n_valid = max_samples - seen
            logits, labels = logits[:n_valid], labels[:n_valid]
        all_logits.append(logits)
        all_labels.append(labels[:n_valid])
        seen += n_valid
        if max_samples is not None and seen >= max_samples:
            break
    logits = (np.concatenate(all_logits) if all_logits
              else np.zeros((0, 1), np.float32))
    labels = (np.concatenate(all_labels) if all_labels
              else np.zeros((0,), int))
    return _result(logits, labels, class_weights)


def evaluate_hbm(model, eval_epoch: Callable, hbm_eval,
                 class_weights=None) -> EvalResult:
    """Evaluate against a device-resident eval set (``HBMEvalSet``): one
    logits copy to the host, the wrap padding undone exactly."""
    logits = hbm_eval.scatter_logits(eval_epoch(model, hbm_eval))
    return _result(logits, hbm_eval.labels, class_weights)


def evaluate_full(model, eval_step: Callable, cached: CachedDataset, device,
                  batch_size: int = 64, class_weights=None) -> EvalResult:
    """Uncapped evaluation."""
    return evaluate(model, eval_step, cached, device, batch_size,
                    max_samples=None, class_weights=class_weights)


def snapshot_weights(model) -> dict:
    """A copy of the model's parameters and buffers on its device."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def restore_weights(model, snapshot: dict) -> None:
    model.load_state_dict(snapshot)


def _accepts_state(cb) -> bool:
    """Does the on_epoch_end callback take a ``state`` parameter?"""
    try:
        params = inspect.signature(cb).parameters
    except (TypeError, ValueError):
        return False
    return "state" in params or any(
        p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values())


def train_model(state, run_epoch: Callable, eval_fn: Callable,
                max_epochs: int, patience: int = 4, logger=None,
                on_epoch_end: Optional[Callable] = None,
                verbose: bool = False, start_epoch: int = 0,
                snapshot_fn: Callable = None):
    """Early-stopped multi-epoch fit.

    ``run_epoch(state, epoch) -> (state, train_loss, train_acc_pct)``;
    ``eval_fn(state) -> EvalResult | None`` (None: no validation set, so
    no early stopping and the last epoch's weights are returned);
    ``on_epoch_end(epoch, val_acc[, state=]) -> True to stop``;
    ``start_epoch``: the loop runs epochs [start_epoch, max_epochs);
    ``snapshot_fn(state) -> weights`` chooses what the best-epoch snapshot
    holds (the EMA view when EMA is on).  Returns (state with the best
    weights, history, best val accuracy).
    """
    snapshot_fn = snapshot_fn or (lambda s: snapshot_weights(s.model))
    history = {"train_loss": [], "train_acc": [], "val_loss": [],
               "val_acc": []}
    best_val_acc = -math.inf
    best_snapshot = None
    no_improve = 0

    for epoch in range(start_epoch, max_epochs):
        state, train_loss, train_acc = run_epoch(state, epoch)
        val = eval_fn(state)

        history["train_loss"].append(train_loss)
        history["train_acc"].append(train_acc)
        history["val_loss"].append(val.loss if val else math.nan)
        history["val_acc"].append(val.accuracy if val else math.nan)

        if verbose:
            val_str = (f"val {val.loss:.4f}/{val.accuracy:.2f}%"
                       if val else "no val")
            print(f"Epoch {epoch + 1}/{max_epochs}  "
                  f"train {train_loss:.4f}/{train_acc:.2f}%  {val_str}")
        if logger is not None:
            metrics = {"train_loss": train_loss, "train_acc": train_acc}
            if val is not None:
                metrics.update({"val_loss": val.loss,
                                "val_acc": val.accuracy})
            logger.log_metrics(metrics, step=epoch)

        if val is not None:
            if val.accuracy > best_val_acc:
                best_val_acc = val.accuracy
                best_snapshot = snapshot_fn(state)
                no_improve = 0
            else:
                no_improve += 1

        if on_epoch_end is not None:
            val_acc = val.accuracy if val is not None else math.nan
            if _accepts_state(on_epoch_end):
                stop = on_epoch_end(epoch, val_acc, state=state)
            else:
                stop = on_epoch_end(epoch, val_acc)
            if stop:
                break
        if val is not None and no_improve >= patience:
            if verbose:
                print(f"Early stopping after {epoch + 1} epochs")
            break

    if best_snapshot is not None:
        restore_weights(state.model, best_snapshot)
    return state, history, best_val_acc
