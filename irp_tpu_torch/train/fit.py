"""``fit``: the fine-tune end to end (the JAX package's ``train/fit.py``).

Data, model, optimizer, steps and loops wired together: the ResNet
classifier from the seed (or a pretrained backbone), the train set
resident on the device (mode 'hbm') or streamed through pinned memory
('stream'), one epoch of sampler windows per epoch, eval on the capped
validation set each epoch, early stopping with the best weights restored.

Data parallelism: ``mesh=`` a process mesh (``parallel/mesh.py``, one
process per device after ``parallel.distributed.initialize`` or under
``torchrun``) splits every global batch over the ranks; every rank runs
this function with the same arguments, holds its rows of the resident
sets, and decides early stopping on the validation accuracy of the whole
set, so every rank stops on the same epoch.  Only world rank 0 logs to
``logger``; the caller writes files on world rank 0 only.

Tensor parallelism: a process mesh with a model axis
(``MeshConfig(data=D, model=M)``, D x M ranks) also splits the head and
the ViT and ConvNeXt blocks over each model group
(``parallel/mesh.py::shard_variables``).  The ranks of one model group
hold the same rows of each batch; the data-axis sums run over the data
groups.  The optimizer's moments and the best-epoch snapshot are each
rank's slices, and a resumed checkpoint's whole tensors are sliced as
they load; the returned model is gathered whole on every rank
(``unshard_variables``).

Resume: ``restore_from`` / ``start_epoch`` continue a run from a
``train/checkpoint.py`` file (every rank reads the same file).  Every epoch's random draws come from
generators seeded by (seed, epoch), the skipped epochs' reshuffles are
replayed and the sampler is fast-forwarded, so a resumed run draws what an
uninterrupted one draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from irp_tpu_torch._kernels import resolve_device
from irp_tpu_torch.config import DatasetInfo, ModelConfig, TrainConfig
from irp_tpu_torch.data.pipeline import (CachedDataset, EpochSampler,
                                         HBMDataset, HBMEvalSet,
                                         iter_host_batches,
                                         prefetch_to_device)
from irp_tpu_torch.models.classifier import init_classifier
from irp_tpu_torch.models.convert import (load_torch_checkpoint,
                                          merge_pretrained)
from irp_tpu_torch.models.resnet import sync_batch_stats
from irp_tpu_torch.parallel.distributed import all_reduce_sum, broadcast
from irp_tpu_torch.parallel.mesh import shard_variables, unshard_variables
from irp_tpu_torch.train.loop import (_result, evaluate, evaluate_hbm,
                                      restore_weights, set_mode,
                                      snapshot_weights, train_epoch,
                                      train_model)
from irp_tpu_torch.train.state import create_train_state
from irp_tpu_torch.train.step import (StepConfig, epoch_step, eval_epoch,
                                      eval_step, train_step)
from irp_tpu_torch.utils.monitor import DeviceTimer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the reshuffle seed of epoch e is seed + RESHUFFLE_STRIDE * e
RESHUFFLE_STRIDE = 1000003


def compute_steps_per_epoch(train_cfg: TrainConfig, n_train: int) -> int:
    """Steps per epoch: the override, else the whole set's batches capped
    at ``train_samples_per_epoch // batch_size``."""
    if train_cfg.steps_per_epoch_override is not None:
        return max(int(train_cfg.steps_per_epoch_override), 1)
    full = max(n_train // train_cfg.batch_size, 1)
    if train_cfg.train_samples_per_epoch is None:
        return full
    cap = max(train_cfg.train_samples_per_epoch // train_cfg.batch_size, 1)
    return min(full, cap)


def resolve_fit_mode(train_cached: CachedDataset,
                     val_cached: Optional[CachedDataset],
                     train_cfg: TrainConfig, device,
                     headroom: float = 0.6,
                     budget_bytes: Optional[int] = None,
                     data_shards: int = 1) -> str:
    """'hbm' when this device's 1/``data_shards`` of the uint8 train set
    (twice, while a per-epoch reshuffle gathers it into a second buffer)
    and of the padded eval set fit in ``headroom`` of the device's free
    memory (``torch.cuda.mem_get_info``), else 'stream'.  A CPU device,
    which reports no budget, gets 'hbm'; ``budget_bytes`` overrides the
    budget."""
    device = torch.device(device)
    d = max(int(data_shards), 1)
    budget = budget_bytes
    if budget is None:
        if device.type != "cuda":
            return "hbm"
        budget = torch.cuda.mem_get_info(device)[0]
    if train_cached.images is None or len(train_cached) == 0:
        return "hbm"
    px = train_cached.images.shape[1]
    per_img = px * px * 3
    need = -(-len(train_cached) // d) * per_img
    if train_cfg.hbm_reshuffle:
        need *= 2
    if val_cached is not None and len(val_cached) > 0:
        n_eval = len(val_cached)
        if train_cfg.eval_samples is not None:
            n_eval = min(n_eval, train_cfg.eval_samples)
        bs = train_cfg.batch_size
        need += -(-n_eval // bs) * bs // d * per_img
    return "hbm" if need <= headroom * budget else "stream"


def epoch_rngs(seed: int, epoch: int, device):
    """The generators of one epoch, derived from (seed, epoch) alone: a
    torch generator on ``device`` (per-image augmentation draws, dropout
    masks) and a numpy generator (per-step mixing draws)."""
    words = np.random.SeedSequence([seed, epoch]).generate_state(2,
                                                                 np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(words[0] >> np.uint64(1)))
    return gen, np.random.default_rng(int(words[1]))


@dataclass
class FitResult:
    state: object
    history: dict
    best_val_acc: float
    steps_per_epoch: int
    eval_step: object
    device: torch.device
    mesh: object = None


def fit(train_cached: CachedDataset, val_cached: Optional[CachedDataset],
        info: DatasetInfo, model_cfg: ModelConfig, train_cfg: TrainConfig,
        logger=None, on_epoch_end=None, mode: str = "hbm",
        verbose: bool = False, use_class_weights: bool = True,
        restore_from: Optional[str] = None, start_epoch: int = 0,
        device=None, hbm_train=None, mesh=None) -> FitResult:
    """Fine-tune a classifier on ``train_cached``; validate on
    ``val_cached`` (None: no validation, no early stopping, the last
    epoch's weights).  Runs on the CUDA device unless ``device='cpu'``.

    ``mode``: 'hbm' keeps the train set on the device, 'stream' feeds host
    batches, 'auto' picks by :func:`resolve_fit_mode`.  With
    ``fused_frozen_blocks`` 'auto' on a card, the frozen identity
    bottlenecks run through K1 in every train and eval forward; the eval
    crop runs through K2.  ``history`` holds per epoch the train loss and
    accuracy (percent), the val loss and accuracy, and ``train_ms``, the
    train epoch's time on the device (eval excluded).

    ``hbm_train``: a train set already on the device (an
    :class:`~irp_tpu_torch.data.pipeline.HBMFoldView`), read in place of a
    new :class:`HBMDataset` upload; it needs mode 'hbm' or 'auto'.
    ``train_cached`` may then be the metadata-only subset
    (``subset_by_shards(with_images=False)``), which still gives the
    steps per epoch.

    ``mesh``: a process mesh for data (and tensor) parallelism (module
    docstring), or a local mesh of one device (the same as
    ``device``).  A local mesh of several devices raises: data-parallel
    training runs one process per device.
    """
    if hbm_train is not None and mode not in ("hbm", "auto"):
        raise ValueError("hbm_train requires mode='hbm'")
    if mesh is not None and not mesh.is_process and mesh.size > 1:
        raise ValueError(
            f"data-parallel training runs one process per device: start "
            f"one process per device (parallel.distributed.initialize, or "
            f"torchrun with initialize(auto=True)) and pass make_mesh() "
            f"there; {mesh} is a local mesh of {mesh.size} devices, which "
            f"serves inference only")
    pmesh = mesh if mesh is not None and mesh.is_process else None
    d = 1 if pmesh is None else pmesh.size
    leader = mesh is None or mesh.is_leader
    if not leader:
        logger = None  # rank 0 logs
    dev = resolve_device(device if mesh is None else mesh.device)
    if hbm_train is not None:
        if torch.device(hbm_train.device).type != dev.type:
            raise ValueError(f"hbm_train lies on {hbm_train.device}, the "
                             f"fit runs on {dev}")
        if getattr(hbm_train, "mesh", None) is not pmesh:
            raise ValueError("hbm_train was built on a different mesh")
        mode = "hbm"  # already resident: nothing left to decide
    if mode == "auto":
        mode = resolve_fit_mode(train_cached, val_cached, train_cfg, dev,
                                data_shards=d)
        if pmesh is not None:
            # every rank must take one mode: 'stream' if any rank's
            # memory asks for it
            votes = torch.tensor([float(mode == "stream")], device=dev)
            mode = ("stream" if float(all_reduce_sum(votes,
                                                     pmesh.world_group))
                    else "hbm")
        if verbose:
            print(f"fit: mode=auto resolved to '{mode}'")
    if mode not in ("hbm", "stream"):
        raise ValueError(f"unknown mode: {mode}")
    accum = int(train_cfg.grad_accum_steps)
    if accum < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {accum}")
    if train_cfg.batch_size % (d * accum):
        raise ValueError(
            f"batch_size={train_cfg.batch_size} must be divisible by "
            f"data_shards*grad_accum_steps ({d}*{accum}): each device "
            f"needs a whole micro-batch per accumulation step")
    seed = train_cfg.seed
    model = init_classifier(model_cfg,
                            torch.Generator().manual_seed(seed), device=dev)
    if model_cfg.pretrained_path:
        merge_pretrained(model,
                         load_torch_checkpoint(model_cfg.pretrained_path))
    if pmesh is not None:
        [model] = shard_variables(pmesh, model)
        sync_batch_stats(model, pmesh.group)
    if hbm_train is not None:
        cache_px = hbm_train.px
    elif train_cached.images is None:
        raise ValueError("train_cached has no images (metadata-only "
                         "subset); pass hbm_train or a full subset")
    else:
        cache_px = train_cached.images.shape[1] if len(train_cached) else 0
    if cache_px and model_cfg.image_size > cache_px:
        raise ValueError(
            f"model_cfg.image_size={model_cfg.image_size} exceeds the "
            f"decode-cache resolution ({cache_px}px)")

    steps_per_epoch = compute_steps_per_epoch(train_cfg, len(train_cached))
    state = create_train_state(model, train_cfg, model_cfg, steps_per_epoch)
    if restore_from is not None:
        from irp_tpu_torch.train.checkpoint import restore_checkpoint

        restore_checkpoint(restore_from, state, mesh=pmesh)

    cw_np = (np.asarray(info.class_weights, np.float32)
             if use_class_weights else None)
    cw = None if cw_np is None else torch.from_numpy(cw_np).to(dev)
    dtype = _DTYPES[model_cfg.compute_dtype]
    # bf16 training also augments in bf16; f32 stays f32
    step_cfg = StepConfig(
        intensity=train_cfg.aug_intensity, out_size=model_cfg.image_size,
        compute_dtype=dtype,
        label_smoothing=train_cfg.label_smoothing,
        mixup_alpha=train_cfg.mixup_alpha,
        cutmix_alpha=train_cfg.cutmix_alpha, grad_accum=accum,
        dropout_rate=model_cfg.dropout_rate)
    batch = train_cfg.batch_size
    train_ms = []

    if mode == "hbm":
        hbm = (hbm_train if hbm_train is not None
               else HBMDataset(train_cached, dev, shuffle_seed=seed,
                               mesh=pmesh))
        if start_epoch > 0 and train_cfg.hbm_reshuffle:
            # replay the skipped epochs' reshuffles: they compose
            for past in range(1, start_epoch):
                hbm.local_reshuffle(seed + RESHUFFLE_STRIDE * past)
        sampler = EpochSampler(hbm, batch, seed=seed)
        for _ in range(start_epoch):
            sampler.epoch_offsets(steps_per_epoch)

        def run_epoch(state, epoch):
            gen, mix_rng = epoch_rngs(seed, epoch, dev)
            set_mode(model, True)
            with DeviceTimer(dev) as timer:
                if epoch > 0 and train_cfg.hbm_reshuffle:
                    hbm.local_reshuffle(seed + RESHUFFLE_STRIDE * epoch)
                offsets = sampler.epoch_offsets(steps_per_epoch)
                metrics = epoch_step(state, hbm, offsets, sampler.per_device,
                                     step_cfg, cw, gen, mix_rng, pmesh)
            train_ms.append(timer.ms())
            loss = float(metrics["loss"].mean())
            acc = float(metrics["accuracy"].mean()) * 100.0
            return state, loss, acc
    else:
        def run_epoch(state, epoch):
            gen, mix_rng = epoch_rngs(seed, epoch, dev)
            set_mode(model, True)
            # drop_last: a wrap-padded batch would weigh its repeats twice;
            # a set smaller than one batch keeps its one padded batch
            drop_last = len(train_cached) >= batch
            batches = prefetch_to_device(
                iter_host_batches(train_cached, batch, shuffle=True,
                                  seed=seed + epoch, drop_last=drop_last,
                                  pad_final=not drop_last), dev,
                mesh=pmesh)

            def run_step(state, b, i):
                images, labels, _ = b
                return train_step(state, images, labels, step_cfg, cw, gen,
                                  mix_rng, mesh=pmesh)

            with DeviceTimer(dev) as timer:
                out = train_epoch(state, run_step, batches,
                                  max_steps=steps_per_epoch)
            train_ms.append(timer.ms())
            return out

    def run_eval_step(m, images_u8):
        return eval_step(m, images_u8, model_cfg.image_size, dtype)

    hbm_eval = None
    if mode == "hbm" and val_cached is not None and len(val_cached) > 0:
        hbm_eval = HBMEvalSet(val_cached, dev, batch,
                              max_samples=train_cfg.eval_samples, mesh=pmesh)

    def eval_fn(state):
        if val_cached is None or len(val_cached) == 0:
            return None
        set_mode(model, False)
        with state.eval_view() as m:
            if hbm_eval is not None:
                return evaluate_hbm(
                    m, lambda mm, he: eval_epoch(mm, he, model_cfg.image_size,
                                                 dtype, pmesh),
                    hbm_eval, cw_np)
            res = evaluate(m, run_eval_step, val_cached, dev,
                           batch_size=batch,
                           max_samples=train_cfg.eval_samples,
                           class_weights=cw_np)
            if pmesh is None:
                return res
            # every rank scored the whole set: world rank 0's logits
            # decide, so that every rank stops on the same epoch
            logits = broadcast(torch.from_numpy(res.logits).to(dev), 0,
                               pmesh.world_group)
            return _result(logits.cpu().numpy(), res.labels, cw_np)

    def snapshot(state):
        with state.eval_view() as m:
            return snapshot_weights(m)

    state, history, best = train_model(
        state, run_epoch, eval_fn, train_cfg.max_epochs,
        patience=train_cfg.patience, logger=logger,
        on_epoch_end=on_epoch_end, verbose=verbose, start_epoch=start_epoch,
        snapshot_fn=snapshot)
    history["train_ms"] = train_ms
    if train_cfg.ema_decay > 0 and (val_cached is None
                                    or len(val_cached) == 0):
        # no validation, no best restore: hand back the final EMA weights
        restore_weights(model, snapshot(state))
    if pmesh is not None:
        sync_batch_stats(model, None)
        unshard_variables(pmesh, model)
    set_mode(model, False)
    return FitResult(state=state, history=history, best_val_acc=best,
                     steps_per_epoch=steps_per_epoch,
                     eval_step=run_eval_step, device=dev, mesh=mesh)
