"""Training state and optimizer (the JAX package's ``train/state.py``).

The optimizer is the JAX package's optax chain as the torch optimizer that
computes it over the trainable parameters (``trainable_mask``):

- 'adam': ``torch.optim.Adam(weight_decay=wd)``, g + wd * p enters the
  moments (optax ``add_decayed_weights`` then ``adam``);
- 'adamw': ``torch.optim.AdamW``, decay after the Adam direction;
- 'sgd': ``torch.optim.SGD``, momentum 0.9 over g + wd * p, dampening 0;

with the group's learning rate set before each step to lr times the
schedule's shape at the step count (peak 1.0, ``_schedule_shape``), as
optax scales the update by the schedule and by -lr.  lr and wd are plain
attributes written at run time (:func:`set_opt_hyperparams`), the
schedule's value is a host float, so a step never waits on the device.
Frozen parameters are not in the optimizer at all.

``ema_decay`` > 0 tracks an EMA of the post-update trainable parameters
(``Optimizer.ema``, as the JAX package's ``_params_ema`` chain slot; a
frozen parameter's EMA is the parameter itself) and of the running
statistics of every BatchNorm that updates them
(``TrainState.ema_batch_stats``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from irp_tpu_torch.config import ModelConfig, TrainConfig
from irp_tpu_torch.models.classifier import (is_trainable,
                                             resolve_trainable_stages)
from irp_tpu_torch.models.resnet import BatchNorm2d
from irp_tpu_torch.ops.schedules import (constant, cosine_anneal,
                                         onecycle_cosine)

OPTIMIZERS = ("adam", "adamw", "sgd")
SCHEDULES = ("onecycle", "cosine", "constant")
ADAM_B1, ADAM_B2, ADAM_EPS, SGD_MOMENTUM = 0.9, 0.999, 1e-8, 0.9


def trainable_mask(model: torch.nn.Module,
                   model_cfg: ModelConfig) -> Dict[str, bool]:
    """Parameter name -> whether it trains: the head always, backbone
    stages per ``trainable_stages`` by the family's stage names
    (``models/classifier.py::backbone_stage``), nothing of the backbone
    when ``head_only``."""
    stages = () if model_cfg.head_only else resolve_trainable_stages(
        model_cfg)
    return {name: is_trainable(name, stages, model_cfg.family)
            for name, _ in model.named_parameters()}


def _schedule_shape(schedule: str, total_steps: int, steps_per_epoch: int,
                    scheduler_step: str) -> Callable[[int], float]:
    """The lr curve at peak 1.0; in 'epoch' mode it advances once per
    epoch (``count // steps_per_epoch``)."""
    if schedule == "cosine":
        base = cosine_anneal(1.0, total_steps)
    elif schedule == "constant":
        base = constant(1.0)
    else:
        base = onecycle_cosine(1.0, total_steps)
    if scheduler_step == "epoch":
        return lambda count: base(count // max(steps_per_epoch, 1))
    return base


class Optimizer:
    """adam / adamw / sgd over the named trainable parameters, with the
    state the JAX package keeps in opt_state: the step count, the Adam
    moments ``mu``/``nu`` (torch's ``exp_avg``/``exp_avg_sq``) or the SGD
    ``trace`` (``momentum_buffer``), and the EMA."""

    _SLOTS = {"mu": "exp_avg", "nu": "exp_avg_sq", "trace": "momentum_buffer"}

    def __init__(self, kind: str, params: Dict[str, torch.nn.Parameter],
                 shape: Callable[[int], float], learning_rate: float,
                 weight_decay: float, ema_decay: float = 0.0):
        if kind not in OPTIMIZERS:
            raise ValueError(f"TrainConfig.optimizer must be one of "
                             f"{OPTIMIZERS}, got {kind!r}")
        self.kind = kind
        self.params = dict(params)
        self.shape = shape
        self.learning_rate = float(learning_rate)
        self.weight_decay = float(weight_decay)
        self.count = 0
        self.ema_decay = float(ema_decay)
        plist = list(self.params.values()) or [torch.zeros(0)]
        cuda = all(p.is_cuda for p in plist)
        if kind == "sgd":
            self.torch_opt = torch.optim.SGD(
                plist, lr=self.learning_rate, momentum=SGD_MOMENTUM,
                weight_decay=self.weight_decay, foreach=True)
        else:
            cls = torch.optim.Adam if kind == "adam" else torch.optim.AdamW
            self.torch_opt = cls(plist, lr=self.learning_rate,
                                 betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS,
                                 weight_decay=self.weight_decay,
                                 **({"fused": True} if cuda
                                    else {"foreach": True}))
        self.ema = ({n: p.detach().clone() for n, p in self.params.items()}
                    if self.ema_decay > 0 else None)

    @property
    def moments(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{'mu', 'nu'} or {'trace'} -> state_dict name -> tensor (zeros
        before the first step)."""
        kinds = ("trace",) if self.kind == "sgd" else ("mu", "nu")
        out = {}
        for kind in kinds:
            slot = self._SLOTS[kind]
            out[kind] = {}
            for n, p in self.params.items():
                t = self.torch_opt.state.get(p, {}).get(slot)
                out[kind][n] = torch.zeros_like(p) if t is None else t
        return out

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad`` (None counts as 0)."""
        for p in self.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        group = self.torch_opt.param_groups[0]
        group["lr"] = self.learning_rate * float(self.shape(self.count))
        group["weight_decay"] = self.weight_decay
        if self.params:
            self.torch_opt.step()
        self.count += 1
        if self.ema is not None and self.params:
            names = list(self.params)
            ema = [self.ema[n] for n in names]
            torch._foreach_lerp_(ema, [self.params[n].detach()
                                       for n in names], 1.0 - self.ema_decay)

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def state_dict(self) -> dict:
        return {"count": self.count, "learning_rate": self.learning_rate,
                "weight_decay": self.weight_decay,
                "moments": {k: {n: t.detach().cpu().clone()
                                for n, t in v.items()}
                            for k, v in self.moments.items()},
                "ema": (None if self.ema is None else
                        {n: t.detach().cpu().clone()
                         for n, t in self.ema.items()})}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore the count, lr, wd, moments and EMA (tensors copied into
        this optimizer's own, on their device)."""
        kinds = set(self.moments)
        if set(state["moments"]) != kinds:
            raise ValueError(f"optimizer state holds "
                             f"{sorted(state['moments'])}, this "
                             f"{self.kind} optimizer {sorted(kinds)}")
        if (state.get("ema") is None) != (self.ema is None):
            raise ValueError("optimizer state and optimizer disagree on "
                             "the EMA")
        self.count = int(state["count"])
        self.learning_rate = float(state["learning_rate"])
        self.weight_decay = float(state["weight_decay"])
        fused = bool(self.torch_opt.defaults.get("fused"))
        for n, p in self.params.items():
            slots = self.torch_opt.state[p]
            for kind in kinds:
                slots[self._SLOTS[kind]] = torch.empty_like(p).copy_(
                    state["moments"][kind][n])
            if self.kind != "sgd":
                # torch keeps Adam's step on the device only when fused
                slots["step"] = torch.tensor(
                    float(self.count), dtype=torch.float32,
                    device=p.device if fused else "cpu")
        if self.ema is not None:
            for n, t in self.ema.items():
                t.copy_(state["ema"][n])


def make_optimizer(model: torch.nn.Module, train_cfg: TrainConfig,
                   model_cfg: ModelConfig,
                   steps_per_epoch: int) -> Optimizer:
    """The torch-equivalent optimizer over the trainable parameters, on
    ``train_cfg``'s schedule (total steps = epochs x steps per epoch, or
    epochs in 'epoch' mode), with its lr and wd."""
    if train_cfg.scheduler_step == "epoch":
        total = train_cfg.max_epochs
    else:
        total = steps_per_epoch * train_cfg.max_epochs
    if train_cfg.schedule not in SCHEDULES:
        raise ValueError(f"TrainConfig.schedule must be one of {SCHEDULES}, "
                         f"got {train_cfg.schedule!r}")
    mask = trainable_mask(model, model_cfg)
    params = {n: p for n, p in model.named_parameters() if mask[n]}
    shape = _schedule_shape(train_cfg.schedule, total, steps_per_epoch,
                            train_cfg.scheduler_step)
    return Optimizer(train_cfg.optimizer, params, shape,
                     train_cfg.learning_rate, train_cfg.weight_decay,
                     train_cfg.ema_decay)


def set_opt_hyperparams(opt: Optimizer, learning_rate: float,
                        weight_decay: float) -> Optimizer:
    """Write a run's lr and wd into the optimizer."""
    opt.learning_rate = float(learning_rate)
    opt.weight_decay = float(weight_decay)
    return opt


def _updating_stats(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The running buffers of every BatchNorm that updates them in train
    mode, by state_dict name (ResNet's and EfficientNet's BNs outside the
    frozen stages, or all of them under ``bn_stats_mode='all'``; none for
    ViT and ConvNeXt)."""
    out = {}
    for mname, mod in model.named_modules():
        if isinstance(mod, BatchNorm2d) and not mod.frozen:
            out[f"{mname}.running_mean"] = mod.running_mean
            out[f"{mname}.running_var"] = mod.running_var
    return out


class TrainState:
    """The model, its optimizer and the EMA of the BN statistics."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer):
        self.model = model
        self.optimizer = optimizer
        self.ema_decay = optimizer.ema_decay
        self.ema_batch_stats = None
        stats = _updating_stats(model)
        if self.ema_decay > 0 and stats:
            # none to track where no BatchNorm collects statistics (ViT,
            # ConvNeXt, a frozen EfficientNet or ResNet)
            self.ema_batch_stats = {n: t.detach().clone()
                                    for n, t in stats.items()}

    @property
    def step(self) -> int:
        return self.optimizer.count

    def apply_gradients(self) -> None:
        """One optimizer update from the parameters' grads, then the EMA of
        the BN statistics (``with_batch_stats``)."""
        self.optimizer.step()
        self.with_batch_stats()

    @torch.no_grad()
    def with_batch_stats(self) -> None:
        if self.ema_batch_stats is None:
            return
        d = self.ema_decay
        live = _updating_stats(self.model)
        names = list(self.ema_batch_stats)
        ema = [self.ema_batch_stats[n] for n in names]
        torch._foreach_add_(ema, torch._foreach_mul(
            torch._foreach_sub([live[n] for n in names], ema), 1.0 - d))

    @contextlib.contextmanager
    def eval_view(self):
        """The model with the EMA weights and BN statistics swapped in (as
        is when EMA is off), swapped back on exit."""
        if self.optimizer.ema is None:
            yield self.model
            return
        pairs = [(self.optimizer.params[n].data, t)
                 for n, t in self.optimizer.ema.items()]
        if self.ema_batch_stats is not None:
            live = _updating_stats(self.model)
            pairs += [(live[n], t) for n, t in self.ema_batch_stats.items()]
        self._swap(pairs)
        try:
            yield self.model
        finally:
            self._swap(pairs)

    @staticmethod
    @torch.no_grad()
    def _swap(pairs) -> None:
        for a, b in pairs:
            tmp = a.clone()
            a.copy_(b)
            b.copy_(tmp)

    def state_dict(self) -> dict:
        return {"model": {k: v.detach().cpu().clone()
                          for k, v in self.model.state_dict().items()},
                "optimizer": self.optimizer.state_dict(),
                "ema_batch_stats": (None if self.ema_batch_stats is None else
                                    {n: t.cpu().clone() for n, t in
                                     self.ema_batch_stats.items()})}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema_batch_stats is not None:
            src = state.get("ema_batch_stats")
            for n, t in self.ema_batch_stats.items():
                # a checkpoint without it seeds the EMA from the live stats
                t.copy_(src[n] if src is not None
                        else state["model"][n])


def create_train_state(model: torch.nn.Module, train_cfg: TrainConfig,
                       model_cfg: ModelConfig,
                       steps_per_epoch: int = 1) -> TrainState:
    return TrainState(model, make_optimizer(model, train_cfg, model_cfg,
                                            steps_per_epoch))


def ema_params(state: TrainState) -> Optional[Dict[str, torch.Tensor]]:
    """The EMA of the trainable parameters, or None when EMA is off."""
    return state.optimizer.ema
