"""Final-model training, full test evaluation and reporting (the JAX
package's ``train/final.py``).

- The best trial's parameters come from the study; ``recommended_epochs``
  from the best trial's tracking run (joined through its
  ``tracking_run_id`` user attribute), else 0.8 x its ``max_epochs``,
  else 10.
- The model retrains on ALL train data: uncapped epochs, no validation
  (the last epoch's weights, or the EMA's), the schedule stepped once per
  epoch (``scheduler_step='epoch'``, the reference's quirk kept).
- Every epoch writes ``checkpoint_epoch_<epoch>.npz`` and a full-state
  checkpoint, so ``resume=True`` continues a killed run exactly.
- The whole test set is evaluated (K2 crops every batch on the card);
  per-class precision, recall and F1, the confusion matrix and the
  correct/incorrect galleries go to the tracking run with
  ``final_model.npz`` and ``final_model.pth``.
- :func:`display_model_visualizations` finds those figures back.
- ``mesh=`` a process mesh trains data-parallel, and with a model axis
  tensor-parallel too (``train/fit.py``): every rank runs
  ``train_final_model`` alike; the checkpoints hold whole tensors (the
  ranks' slices gathered) and the artifacts come from the whole model
  ``fit`` returns; only world rank 0 writes the checkpoints, the
  tracking run, the figures and the artifacts, and every rank reads the
  same checkpoint on ``resume``.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from irp_tpu_torch import tracking
from irp_tpu_torch.config import DatasetInfo, ModelConfig, TrainConfig
from irp_tpu_torch.data.pipeline import CachedDataset
from irp_tpu_torch.ops.metrics import classification_report, confusion_matrix
from irp_tpu_torch.train.checkpoint import (export_torch_pth,
                                            latest_checkpoint,
                                            save_checkpoint, save_model_npz)
from irp_tpu_torch.train.fit import fit
from irp_tpu_torch.train.loop import evaluate_full
from irp_tpu_torch.utils.viz import plot_confusion_matrix, plot_image_grid

# TrainConfig fields the final stage sets itself: a searched key of the
# same name does not override them
FINAL_PINNED = frozenset({
    "learning_rate", "weight_decay", "batch_size", "max_epochs", "patience",
    "aug_intensity", "train_samples_per_epoch", "eval_samples",
    "scheduler_step", "seed"})


class _QuietRun:
    """The tracking run of a rank other than 0: it records nothing."""

    class info:  # noqa: N801 — Run.info's shape
        run_id = None

    def log_params(self, *args, **kwargs) -> None:
        pass

    log_metrics = log_artifact = log_params

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@dataclass
class FinalResult:
    state: object
    test_acc: float
    test_loss: float
    report: dict
    run_id: str
    history: dict


def recommended_epochs_from_study(study, fallback_factor: float = 0.8,
                                  client: Optional[object] = None) -> int:
    """``recommended_epochs`` from the best trial's tracking run; else
    ``fallback_factor`` x its ``max_epochs``; else 10."""
    best = study.best_trial
    run_id = best.user_attrs.get("tracking_run_id")
    if run_id:
        try:
            client = client or tracking.TrackingClient()
            run = client.get_run(run_id)
            return int(run["params"]["recommended_epochs"])
        except Exception as e:  # noqa: BLE001 — the JAX package's fallback
            print(f"Could not retrieve early stopping info: {e}")
    max_epochs = best.params.get("max_epochs")
    if max_epochs is None:
        print("best trial has no max_epochs param; defaulting to 10 epochs")
        return 10
    return int(max_epochs * fallback_factor)


def visualize_classifications(preds: np.ndarray, labels: np.ndarray,
                              images_u8, class_names: Sequence[str],
                              save_dir: str, max_incorrect: int = 10):
    """Correct/incorrect prediction galleries: one correct sample per
    class and up to ``max_incorrect`` errors, from the uint8 cache.  Only
    the drawn rows of ``images_u8`` (a memmap is fine) are read."""
    os.makedirs(save_dir, exist_ok=True)
    paths = []

    correct_imgs, correct_titles = [], []
    for c, name in enumerate(class_names):
        hits = np.nonzero((labels == c) & (preds == c))[0]
        if len(hits):
            correct_imgs.append(np.asarray(images_u8[hits[0]]))
            correct_titles.append(f"true/pred: {name}")
    if correct_imgs:
        paths.append(plot_image_grid(
            correct_imgs, correct_titles,
            os.path.join(save_dir, "correct_classifications.png"),
            suptitle="Correct classifications (1 per class)"))

    wrong = np.nonzero(preds != labels)[0][:max_incorrect]
    if len(wrong):
        imgs = [np.asarray(images_u8[i]) for i in wrong]
        titles = [f"true: {class_names[labels[i]]}\npred: "
                  f"{class_names[preds[i]]}" for i in wrong]
        paths.append(plot_image_grid(
            imgs, titles,
            os.path.join(save_dir, "incorrect_classifications.png"),
            suptitle="Incorrect classifications"))
    return paths


def final_configs(study, info: DatasetInfo, final_epochs: int,
                  model_base: ModelConfig = ModelConfig(),
                  train_base: TrainConfig = TrainConfig()):
    """The final run's (ModelConfig, TrainConfig): the best trial's
    parameters laid over the bases with ``dataclasses.replace``, the
    final stage's pins, then the searched keys that name other
    TrainConfig fields (the best trial won with them)."""
    bp = study.best_trial.params
    model_cfg = dataclasses.replace(
        model_base, num_classes=info.num_classes,
        dropout_rate=bp.get("dropout_rate", model_base.dropout_rate))
    train_cfg = dataclasses.replace(
        train_base,
        learning_rate=bp["learning_rate"],
        weight_decay=bp["weight_decay"],
        batch_size=bp["batch_size"],
        max_epochs=final_epochs,
        patience=final_epochs + 1,  # no early stop in the final run
        aug_intensity=bp.get("augmentation_intensity", "medium"),
        train_samples_per_epoch=None,
        eval_samples=None,
        scheduler_step="epoch",
        seed=42)
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    extra = {k: v for k, v in bp.items()
             if k in fields and k not in FINAL_PINNED}
    if extra:
        train_cfg = dataclasses.replace(train_cfg, **extra)
    return model_cfg, train_cfg


def _recipe(train_cfg: TrainConfig) -> dict:
    """The off-by-default recipe knobs that are set, for the run's
    params."""
    recipe = {k: v for k, v in
              (("mixup_alpha", train_cfg.mixup_alpha),
               ("cutmix_alpha", train_cfg.cutmix_alpha),
               ("label_smoothing", train_cfg.label_smoothing),
               ("ema_decay", train_cfg.ema_decay)) if v}
    if train_cfg.grad_accum_steps > 1:
        recipe["grad_accum_steps"] = train_cfg.grad_accum_steps
    if train_cfg.optimizer != "adam":
        recipe["optimizer"] = train_cfg.optimizer
    if train_cfg.schedule != "onecycle":
        recipe["schedule"] = train_cfg.schedule
    return recipe


def train_final_model(study, train_cached: CachedDataset,
                      test_cached: CachedDataset, info: DatasetInfo,
                      model_base: ModelConfig = ModelConfig(),
                      train_base: TrainConfig = TrainConfig(),
                      device=None, mode: str = "hbm",
                      epochs_factor: float = 1.2,
                      checkpoint_dir: Optional[str] = None,
                      experiment: str = "animals10",
                      verbose: bool = True,
                      resume: bool = False,
                      mesh=None) -> Optional[FinalResult]:
    """Retrain with the best hyperparameters on all the train data, then
    evaluate the whole test set; runs on the CUDA device unless
    ``device='cpu'``.

    ``epochs_factor`` is accepted as the JAX package (and the reference)
    accept it, and unused: the run trains exactly ``recommended_epochs``.
    ``train_base`` seeds every TrainConfig field the study does not
    search.  ``resume=True`` (needs ``checkpoint_dir``) continues from the
    newest full-state checkpoint there: the optimizer's moments and the
    schedule's position carry over.  ``mesh``: as :func:`fit`'s (the
    module docstring).
    """
    if study is None or not study.get_trials():
        print("No valid study available. Cannot train final model.")
        return None

    bp = study.best_trial.params
    if verbose:
        print("Training final model with best hyperparameters:")
        for k, v in bp.items():
            print(f"  {k}: {v}")
    final_epochs = recommended_epochs_from_study(study)
    if verbose:
        print(f"Training for {final_epochs} epochs")
    model_cfg, train_cfg = final_configs(study, info, final_epochs,
                                         model_base, train_base)

    leader = mesh is None or mesh.is_leader
    if leader:
        tracking.set_experiment(experiment)
    with (tracking.start_run(run_name="final_model_full_training")
          if leader else _QuietRun()) as run:
        run.log_params({**bp, **_recipe(train_cfg),
                        "final_epochs": final_epochs, "mode": mode,
                        "bn_stats_mode": model_cfg.bn_stats_mode})

        # image_size rides in every npz artifact so that serving crops as
        # training evaluated
        npz_meta = {"image_size": model_cfg.image_size}
        on_epoch_end = None
        restore_from, start_epoch = None, 0
        if resume and not checkpoint_dir:
            raise ValueError("resume=True requires checkpoint_dir (there "
                             "is nowhere to restore from)")
        if checkpoint_dir:
            if leader:
                os.makedirs(checkpoint_dir, exist_ok=True)
            if resume:
                restore_from, start_epoch = latest_checkpoint(checkpoint_dir)
                if verbose and restore_from:
                    print(f"Resuming from {restore_from} "
                          f"(epoch {start_epoch})")

            pmesh = mesh if mesh is not None and mesh.is_process else None

            def on_epoch_end(epoch, val_acc, state=None):
                # every rank calls: a model axis's slices are gathered
                # whole, and world rank 0 writes
                if state is not None:
                    save_model_npz(
                        os.path.join(checkpoint_dir,
                                     f"checkpoint_epoch_{epoch:03d}.npz"),
                        state.model, meta=npz_meta, mesh=pmesh)
                    save_checkpoint(checkpoint_dir, state, step=epoch,
                                    mesh=pmesh)
                return False

        result = fit(train_cached, None, info, model_cfg, train_cfg,
                     logger=run, mode=mode, verbose=verbose,
                     on_epoch_end=on_epoch_end, restore_from=restore_from,
                     start_epoch=start_epoch, device=device, mesh=mesh)
        model = result.state.model
        if verbose:
            print("\nEvaluating final model on test set...")
        test = evaluate_full(model, result.eval_step, test_cached,
                             result.device, batch_size=train_cfg.batch_size,
                             class_weights=np.asarray(info.class_weights))
        report = classification_report(test.labels, test.preds,
                                       info.class_names)
        if verbose:
            print(f"\nFinal Test Results:\n  Loss: {test.loss:.4f}\n"
                  f"  Accuracy: {test.accuracy:.2f}%")
        if not leader:
            return FinalResult(state=result.state, test_acc=test.accuracy,
                               test_loss=test.loss, report=report,
                               run_id=None, history=result.history)

        # the tracking store keeps copies: the local files go with the
        # temporary directory
        with tempfile.TemporaryDirectory(prefix="irp_final_") as tmp:
            run.log_artifact(save_model_npz(
                os.path.join(tmp, "final_model.npz"), model, meta=npz_meta))
            run.log_artifact(export_torch_pth(
                os.path.join(tmp, "final_model.pth"), model))
            if checkpoint_dir:
                save_model_npz(os.path.join(checkpoint_dir,
                                            "final_model.npz"),
                               model, meta=npz_meta)

            run.log_metrics({"test_acc": test.accuracy,
                             "test_loss": test.loss})
            for name in info.class_names:
                run.log_metrics({
                    f"test_f1_{name}": report[name]["f1-score"],
                    f"test_precision_{name}": report[name]["precision"],
                    f"test_recall_{name}": report[name]["recall"],
                })

            cm = confusion_matrix(test.labels, test.preds, info.num_classes)
            run.log_artifact(plot_confusion_matrix(
                cm, info.class_names, os.path.join(tmp,
                                                   "confusion_matrix.png"),
                title="Final Model Confusion Matrix (Test Set)"))
            for p in visualize_classifications(test.preds, test.labels,
                                               test_cached.images,
                                               info.class_names, tmp):
                run.log_artifact(p)

        return FinalResult(state=result.state, test_acc=test.accuracy,
                           test_loss=test.loss, report=report,
                           run_id=run.info.run_id, history=result.history)


def display_model_visualizations(experiment: str = "animals10",
                                 run_name: str = "final_model_full_training",
                                 out_dir: Optional[str] = None):
    """The PNG artifacts of the newest run named ``run_name``: their paths
    in the tracking store, or copies in ``out_dir``."""
    import shutil

    client = tracking.TrackingClient()
    runs = client.search_runs(experiment, run_name=run_name)
    if not runs:
        print(f"No runs named {run_name!r} in experiment {experiment!r}")
        return []
    latest = max(runs, key=lambda r: int(r["info"].get("start_time", 0)))
    run_id = latest["info"].get("run_id") or latest["info"].get("run_uuid")
    paths = [client.artifact_path(run_id, a)
             for a in client.list_artifacts(run_id) if a.endswith(".png")]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        copied = []
        for p in paths:
            dst = os.path.join(out_dir, os.path.basename(p))
            shutil.copy2(p, dst)
            copied.append(dst)
        return copied
    return paths
