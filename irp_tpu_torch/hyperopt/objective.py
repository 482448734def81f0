"""K-fold hyperopt objective with the three-tier pruning ladder (the JAX
package's ``hyperopt/objective.py``).

- The 7-dim search space: lr 1e-5..1e-2 log, batch {8, 16, 32}, wd
  1e-6..1e-3 log, dropout 0..0.5, augmentation {low, medium, high},
  patience 3..6, max_epochs 10..20 (``suggest_space``).
- Tier 1: per-epoch reports on fold 0 to the study's pruner.
- Tier 2: fold 0's best accuracy below ``first_fold_min_acc`` prunes.
- Tier 3: the running fold average below ``progressive_factor`` x the
  median of at least ``progressive_min_trials`` completed values prunes.
- The value: the best per-epoch cross-fold mean accuracy (over epochs
  every fold reached), returned as the one-sided t-distribution lower
  bound at ``confidence``; ``recommended_epochs`` and the tracking run id
  are recorded for the final trainer.
- Out of device memory in a fit: -inf.

Every fold-fit reads its pixels from one device-resident pool per sweep
(``HBMFoldPool``), with three fallbacks to the per-fit upload: a fold the
pool cannot serve (``select_fold``'s ValueError, or a prefix shorter than
one batch), the pool itself out of memory, and a fit out of memory while
the pool is resident.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
from scipy import stats

from irp_tpu_torch import tracking
from irp_tpu_torch._kernels import resolve_device
from irp_tpu_torch.config import (DatasetInfo, HyperoptConfig, ModelConfig,
                                  TrainConfig)
from irp_tpu_torch.data.kfold import create_stratified_kfolds
from irp_tpu_torch.data.pipeline import CachedDataset, HBMFoldPool
from irp_tpu_torch.hyperopt.study import Trial, TrialPruned
from irp_tpu_torch.train.fit import fit
from irp_tpu_torch.utils.errors import is_oom_error


@dataclass
class HyperoptContext:
    """Everything a trial needs, prepared once per sweep.

    ``train_base`` is the sweep-wide recipe: the searched
    hyperparameters replace its fields per trial, the rest (mixing, label
    smoothing, EMA, ...) rides through.  ``device``: the card unless
    'cpu'.  ``train_samples_per_epoch`` / ``eval_samples`` cap each
    fold-fit's epochs.  ``space_fn`` replaces the search space.
    ``reuse_hbm_pool``: serve every fold-fit from one resident pool (else
    one upload per fold-fit).  ``mesh`` (``parallel/mesh.py``): the mesh
    every fold-fit runs on, in place of ``device`` (a parallel sweep
    gives each worker a one-device mesh; ``hyperopt/parallel.py``).
    """

    cached: CachedDataset  # the whole train cache, decoded once
    info: DatasetInfo
    hcfg: HyperoptConfig
    model_base: ModelConfig = ModelConfig()
    train_base: TrainConfig = TrainConfig()
    device: object = None
    mode: str = "hbm"
    train_samples_per_epoch: Optional[int] = 1024
    eval_samples: Optional[int] = 512
    verbose: bool = False
    space_fn: object = None
    reuse_hbm_pool: bool = True
    mesh: object = None

    def __post_init__(self):
        shards = list(self.cached.shard_paths or ())
        hist = {}
        for p in shards:
            ids = np.nonzero(np.isin(
                self.cached.shard_ids,
                [i for i, q in enumerate(self.cached.shard_paths)
                 if q == p]))[0]
            hist[p] = collections.Counter(
                self.info.class_names[lab] for lab in self.cached.labels[ids])
        self._histograms = hist
        self._shards = shards
        self._fold_cache: Dict[tuple, List[List[str]]] = {}
        self._hbm_pool = None
        self.hbm_pool_stats: Optional[Dict] = None  # set on release

    def hbm_pool(self, device) -> HBMFoldPool:
        """The sweep's fold pool on ``device`` (over ``mesh``'s data axis
        when it is a process mesh), built at first use."""
        if self._hbm_pool is None:
            pmesh = (self.mesh if self.mesh is not None
                     and self.mesh.is_process else None)
            self._hbm_pool = HBMFoldPool(self.cached, device,
                                         seed=self.hcfg.seed, mesh=pmesh)
        return self._hbm_pool

    def release_hbm_pool(self) -> None:
        """Drop the pool's device tensors and give the cached blocks back
        to the card (after the sweep, and before a retry after an OOM);
        ``hbm_pool_stats`` keeps its upload size."""
        pool, self._hbm_pool = self._hbm_pool, None
        if pool is not None:
            self.hbm_pool_stats = {"upload_bytes": pool.upload_bytes,
                                   "last_dropped": pool.last_dropped}
            pool.release()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def folds(self, k: int, seed: int) -> List[List[str]]:
        key = (k, seed)
        if key not in self._fold_cache:
            self._fold_cache[key] = create_stratified_kfolds(
                self._shards, k=k, seed=seed, histograms=self._histograms)
        return self._fold_cache[key]


# The 7 searched keys, consumed by name below.  Any OTHER key a space_fn
# suggests that names a TrainConfig field is laid over the trial's
# TrainConfig, except the fields the context pins.
_REFERENCE_SPACE_KEYS = frozenset((
    "learning_rate", "batch_size", "weight_decay", "dropout_rate",
    "augmentation_intensity", "patience", "max_epochs"))
_PINNED_KEYS = frozenset(("seed", "train_samples_per_epoch", "eval_samples"))
_TRAIN_FIELD_NAMES = frozenset(
    f.name for f in dataclasses.fields(TrainConfig))


def suggest_space(trial: Trial) -> Dict:
    """The 7-dim search space."""
    return {
        "learning_rate": trial.suggest_float("learning_rate", 1e-5, 1e-2,
                                             log=True),
        "batch_size": trial.suggest_categorical("batch_size", [8, 16, 32]),
        "weight_decay": trial.suggest_float("weight_decay", 1e-6, 1e-3,
                                            log=True),
        "dropout_rate": trial.suggest_float("dropout_rate", 0.0, 0.5),
        "augmentation_intensity": trial.suggest_categorical(
            "augmentation_intensity", ["low", "medium", "high"]),
        "patience": trial.suggest_int("patience", 3, 6),
        "max_epochs": trial.suggest_int("max_epochs", 10, 20),
    }


def quick_space(trial: Trial) -> Dict:
    """The smoke-test space of the CLIs' --quick: 2 epochs, batch 16, low
    augmentation."""
    return {
        "learning_rate": trial.suggest_float("learning_rate", 1e-4, 5e-3,
                                             log=True),
        "batch_size": trial.suggest_categorical("batch_size", [16]),
        "weight_decay": trial.suggest_float("weight_decay", 1e-6, 1e-4,
                                            log=True),
        "dropout_rate": trial.suggest_float("dropout_rate", 0.0, 0.3),
        "augmentation_intensity": trial.suggest_categorical(
            "augmentation_intensity", ["low"]),
        "patience": trial.suggest_int("patience", 3, 3),
        "max_epochs": trial.suggest_int("max_epochs", 2, 2),
    }


def objective_kfold(trial: Trial, ctx: HyperoptContext) -> float:
    """One trial: k fold-fits with the three pruning tiers; returns the
    lower confidence bound of the best epoch's cross-fold accuracy."""
    hp = (ctx.space_fn or suggest_space)(trial)
    pinned = sorted(_PINNED_KEYS & set(hp))
    if pinned:
        raise ValueError(f"the search space suggests {pinned}, which the "
                         "HyperoptContext pins; set them there")
    k = ctx.hcfg.k_folds
    folds = ctx.folds(k, ctx.hcfg.seed)
    device = (ctx.mesh.device if ctx.mesh is not None
              else resolve_device(ctx.device))

    with tracking.start_run(
            run_name=f"optuna_trial_{trial.number}_kfold") as run:
        recipe = {k_: v for k_, v in
                  (("mixup_alpha", ctx.train_base.mixup_alpha),
                   ("cutmix_alpha", ctx.train_base.cutmix_alpha),
                   ("label_smoothing", ctx.train_base.label_smoothing),
                   ("ema_decay", ctx.train_base.ema_decay))
                  if v}  # off-by-default knobs: logged only when set
        if ctx.train_base.grad_accum_steps > 1:
            recipe["grad_accum_steps"] = ctx.train_base.grad_accum_steps
        if ctx.train_base.optimizer != "adam":
            recipe["optimizer"] = ctx.train_base.optimizer
        if ctx.train_base.schedule != "onecycle":
            recipe["schedule"] = ctx.train_base.schedule
        # hp after recipe: a searched dimension wins in the trial's log,
        # as the overlay below makes it win in the config
        run.log_params({**recipe, **hp, "k_folds": k})

        fold_accuracies: List[float] = []
        epoch_accuracies: Dict[int, List[float]] = {}
        use_pool = ctx.mode == "hbm" and ctx.reuse_hbm_pool

        for fold_idx in range(k):
            val_shards = folds[fold_idx]
            train_shards = [s for i in range(k) if i != fold_idx
                            for s in folds[i]]
            hbm_view = None
            if use_pool:
                try:
                    hbm_view = ctx.hbm_pool(device).select_fold(train_shards)
                except ValueError as e:
                    # the fold holds no sample: the per-fit upload serves
                    # this fold, the pool stays for the others
                    warnings.warn(
                        f"HBM fold pool: select_fold failed for fold "
                        f"{fold_idx} ({e}); falling back to the per-fit "
                        f"upload for this fold", stacklevel=2)
                    hbm_view = None
                except RuntimeError as e:
                    if not is_oom_error(e):
                        raise
                    # the whole cache does not fit (a fold subset may):
                    # per-fit uploads for the rest of the sweep
                    warnings.warn(
                        f"HBM fold pool: building the pool or selecting "
                        f"fold {fold_idx} ran out of memory ({e}); "
                        "releasing the pool, per-fit uploads serve the "
                        "rest of the sweep", stacklevel=2)
                    ctx.reuse_hbm_pool = False
                    use_pool = False
                if not use_pool:
                    ctx.release_hbm_pool()
                if hbm_view is not None and \
                        hbm_view.local_count < hp["batch_size"]:
                    # a prefix shorter than one batch: the per-fit upload
                    # wrap-pads
                    hbm_view = None
            if hbm_view is not None:
                train_cached = ctx.cached.subset_by_shards(
                    train_shards, with_images=False)
            else:
                train_cached = ctx.cached.subset_by_shards(train_shards)
            val_cached = ctx.cached.subset_by_shards(val_shards)

            model_cfg = dataclasses.replace(
                ctx.model_base, num_classes=ctx.info.num_classes,
                dropout_rate=hp["dropout_rate"])
            train_cfg = dataclasses.replace(
                ctx.train_base,
                learning_rate=hp["learning_rate"],
                weight_decay=hp["weight_decay"],
                batch_size=hp["batch_size"],
                max_epochs=hp["max_epochs"],
                patience=hp["patience"],
                aug_intensity=hp["augmentation_intensity"],
                train_samples_per_epoch=ctx.train_samples_per_epoch,
                eval_samples=ctx.eval_samples,
                seed=ctx.hcfg.seed)
            extra = {key: v for key, v in hp.items()
                     if key not in _REFERENCE_SPACE_KEYS
                     and key in _TRAIN_FIELD_NAMES}
            if extra:
                train_cfg = dataclasses.replace(train_cfg, **extra)

            def on_epoch_end(epoch, val_acc, _fold=fold_idx):
                epoch_accuracies.setdefault(epoch, []).append(val_acc)
                if _fold == 0:
                    # tier 1: per-epoch pruning on fold 0
                    trial.report(val_acc, epoch)
                    if trial.should_prune():
                        raise TrialPruned(
                            f"epoch {epoch + 1}: val_acc {val_acc:.2f}%")
                return False

            # this fold's epoch entries so far, to drop a failed attempt's
            pre_lens = {ep: len(v) for ep, v in epoch_accuracies.items()}
            retry = False
            try:
                result = fit(train_cached, val_cached, ctx.info, model_cfg,
                             train_cfg, logger=run,
                             on_epoch_end=on_epoch_end, mode=ctx.mode,
                             verbose=ctx.verbose, device=device,
                             hbm_train=hbm_view, mesh=ctx.mesh)
            except RuntimeError as e:
                if not is_oom_error(e):
                    raise
                if not use_pool:
                    return float("-inf")
                # the pool (the whole cache) is the likeliest hog; a -inf
                # here would repeat for every trial
                warnings.warn(
                    f"fit() OOMed with the HBM fold pool resident ({e}); "
                    "releasing the pool for the rest of the sweep and "
                    "retrying this fold via the per-fit upload",
                    stacklevel=2)
                retry = True
            if retry:
                # out of the except block, so that the failed fit's frames
                # and tensors are gone before the cache is emptied
                ctx.reuse_hbm_pool = False
                use_pool = False
                hbm_view = None
                ctx.release_hbm_pool()
                train_cached = ctx.cached.subset_by_shards(train_shards)
                for ep, v in epoch_accuracies.items():
                    del v[pre_lens.get(ep, 0):]
                try:
                    result = fit(train_cached, val_cached, ctx.info,
                                 model_cfg, train_cfg, logger=run,
                                 on_epoch_end=on_epoch_end, mode=ctx.mode,
                                 verbose=ctx.verbose, device=device,
                                 hbm_train=None, mesh=ctx.mesh)
                except RuntimeError as e2:
                    if is_oom_error(e2):
                        return float("-inf")
                    raise
            best_val_acc = result.best_val_acc

            fold_accuracies.append(best_val_acc)
            if fold_idx == 0:
                # tier 2: the first fold's floor
                if best_val_acc < ctx.hcfg.first_fold_min_acc:
                    run.log_params({"pruned_first_fold": True})
                    run.log_metrics({"first_fold_acc": best_val_acc})
                    raise TrialPruned(
                        f"first fold best {best_val_acc:.2f}% < "
                        f"{ctx.hcfg.first_fold_min_acc:.2f}%")
            else:
                avg = sum(fold_accuracies) / len(fold_accuracies)
                run.log_metrics(
                    {f"avg_acc_after_{fold_idx + 1}_folds": avg})
                completed = [t.value for t in trial.study.get_trials()
                             if t.state == "COMPLETE"
                             and t.value is not None]
                if len(completed) >= ctx.hcfg.progressive_min_trials:
                    median = float(np.median(completed))
                    # tier 3: progressive, below a share of the median
                    if avg < median * ctx.hcfg.progressive_factor:
                        run.log_params({"pruned_progressive": True,
                                        "pruned_after_fold": fold_idx + 1})
                        run.log_metrics({"avg_acc_at_pruning": avg,
                                         "median_value_at_pruning": median})
                        raise TrialPruned(
                            f"fold {fold_idx + 1}: avg {avg:.2f}% below "
                            f"85% of median {median:.2f}%")

        # per-epoch cross-fold aggregation, over epochs every fold reached
        epoch_avg, epoch_std = {}, {}
        for epoch, accs in epoch_accuracies.items():
            if len(accs) == k:
                epoch_avg[epoch] = float(np.mean(accs))
                run.log_metrics({"epoch_avg_val_acc": epoch_avg[epoch]},
                                step=epoch)
                if k > 1:
                    epoch_std[epoch] = float(np.std(accs))
                    run.log_metrics({"epoch_std_val_acc": epoch_std[epoch]},
                                    step=epoch)

        if not epoch_avg:
            return float("-inf")

        best_epoch = max(epoch_avg, key=epoch_avg.get)
        best_avg = epoch_avg[best_epoch]
        run.log_metrics({"best_avg_epoch": best_epoch,
                         "best_avg_val_acc": best_avg})
        run.log_params({"recommended_epochs": best_epoch + 1})

        trial.set_user_attr("tracking_run_id", run.info.run_id)

        if best_epoch in epoch_std:
            t_crit = stats.t.ppf(ctx.hcfg.confidence, df=k - 1)
            lower = best_avg - t_crit * epoch_std[best_epoch] / math.sqrt(k)
            run.log_metrics({"best_std_val_acc": epoch_std[best_epoch],
                             "lower_confidence_bound": lower})
            return float(lower)
        return float(best_avg)
