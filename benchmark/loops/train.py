"""Training on a device-resident set: the calls ``fit``'s resident path
makes (``irp_tpu_torch.train.fit``).

Set-up makes the images, labels and weights from the seed, builds the
program's model, optimizer and resident set (``HBMDataset``), and drives
that one training state through the first ``checked_steps`` steps of the
first epoch with ``epoch_step``, the window's own call; what those steps
produce is held against the plain reference (``reference/train.py``)
once the window has closed.  The window goes on with the rest of that
epoch, then whole epochs (each after the resident set's on-device
reshuffle and the sampler's new offsets, as ``fit`` does), until
``--seconds`` have passed at the end of one.

Traffic parameters: ``images``, ``source_px``, ``class_counts``,
``batch_size``, ``intensity``, ``optimizer``, ``schedule``,
``learning_rate``, ``weight_decay``, ``nominal_epochs`` (the schedule's
length), ``checked_steps``, ``traced_steps``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from benchmark import synth, tracing
from benchmark.loops import common
from benchmark.reference import train as ref_train
from benchmark.roofline import counts

_PARTS = ("augment", "forward", "backward", "optimizer")
_STATS = ("running_mean", "running_var")


class _Marks:
    """Timestamps at the step's boundaries: CUDA events on a card, the
    host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def __call__(self, tag):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = common.now()
        self.marks.append((tag, ev))

    def _ms(self, a, b):
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def split_ms(self) -> dict:
        """Per step: start (or the previous step's end) -> forward
        pre-hook -> backward pre-hook -> optimizer pre-hook -> optimizer
        post-hook."""
        out = {p: [] for p in _PARTS}
        order = ("fwd", "bwd", "opt", "end")
        begin, seen = None, []
        for tag, ev in self.marks:
            if tag == "start":
                begin, seen = ev, []
                continue
            seen.append((tag, ev))
            if tag == "end":
                if begin is not None and tuple(t for t, _ in seen) == order:
                    evs = [begin] + [e for _, e in seen]
                    for i, part in enumerate(_PARTS):
                        out[part].append(self._ms(evs[i], evs[i + 1]))
                begin, seen = ev, []
        return out


def _hooks(state, marks):
    model, opt = state.model, state.optimizer.torch_opt
    return [model.register_forward_pre_hook(lambda *a: marks("fwd")),
            model.register_full_backward_pre_hook(lambda *a: marks("bwd")),
            opt.register_step_pre_hook(lambda *a: marks("opt")),
            opt.register_step_post_hook(lambda *a: marks("end"))]


def _norms(tensors: dict) -> dict:
    out = {}
    for k, t in tensors.items():
        out.update(ref_train.leaf_norms(k, t.detach().float()))
    return out


def inputs(cell, phases=None):
    """The run's inputs from its seed: images (host uint8), labels, class
    weights, weights (on the device) and the seeds of its streams."""
    phases = phases or (lambda name: None)
    cfg, tr, dev, seed = (cell.config["model"], cell.traffic, cell.device,
                          cell.seed)
    seeds = {"shuffle": common.seed_of(seed, common.SHUFFLE),
             "sampler": common.seed_of(seed, common.SAMPLER),
             "draws": common.seed_of(seed, common.DRAWS)}
    images = synth.images(tr["images"], tr["source_px"],
                          common.seed_of(seed, common.IMAGES), dev)
    labels = synth.labels(tr["class_counts"], seed)
    cw = synth.class_weights(tr["class_counts"])
    phases("images")
    w0 = common.weights(cfg, seed, images[:64], dev)
    phases("weights")
    return images, labels, cw, w0, seeds


def compare(prog: dict, ref: dict):
    """The compared numbers of two runs of the checked steps (``losses``,
    ``first_grad``, ``first_grad_tensors`` and ``change`` as
    ``reference.train.follow`` returns them), and the widest gaps behind
    them."""
    med_grad = float(np.median(list(ref["first_grad"].values())))
    # leaves the loss cannot move (the key's bias under the softmax) move
    # under Adam by rounding alone: left out of the change
    still = [name for name, g in ref["first_grad"].items()
             if g < 1e-3 * med_grad]
    grad = common.leaf_gaps(prog["first_grad"], ref["first_grad"])
    # the norms' gap sees only the part of an error along the gradient;
    # rounding moves it mostly across, which the norm of the difference
    # sees
    diff = ref_train.diff_norms(prog["first_grad_tensors"],
                                ref["first_grad_tensors"])
    grad_diff = sorted(((d / max(ref["first_grad"][k], med_grad, 1e-30), k)
                        for k, d in diff.items()), reverse=True)

    def part(changes, stats):
        return {k: v for k, v in changes.items()
                if k.endswith(_STATS) == stats}

    update = common.leaf_gaps(part(prog["change"], False),
                              part(ref["change"], False), still)
    bn = common.leaf_gaps(part(prog["change"], True),
                          part(ref["change"], True))
    checks = {"loss_gap": max(abs(p - r) / abs(r) for p, r in
                              zip(prog["losses"], ref["losses"])),
              "grad_gap": grad[0][0], "update_gap": update[0][0],
              "grad_diff": grad_diff[0][0]}
    if bn:
        checks["bn_stats_gap"] = bn[0][0]
    notes = {"losses (program, reference)": [prog["losses"],
                                             ref["losses"]],
             "left out of the update": still,
             "widest gradient gaps": grad[:4],
             "widest gradient differences": grad_diff[:4],
             "widest update gaps": update[:4],
             "widest BatchNorm statistics gaps": bn[:4]}
    return checks, notes


def run(cell) -> dict:
    from irp_tpu_torch.data.pipeline import (CachedDataset, EpochSampler,
                                             HBMDataset)
    from irp_tpu_torch.models.classifier import Classifier
    from irp_tpu_torch.config import TrainConfig
    from irp_tpu_torch.train.fit import RESHUFFLE_STRIDE
    from irp_tpu_torch.train.loop import set_mode
    from irp_tpu_torch.train.state import create_train_state
    from irp_tpu_torch.train.step import StepConfig, epoch_step

    cfg, tr, dev = cell.config["model"], cell.traffic, cell.device
    b, n = tr["batch_size"], tr["images"]
    phases = common.Phases(cell.t_start, cell.device)
    images, labels, cw, w0, seeds = inputs(cell, phases)

    model_cfg = common.model_config(cfg)
    model = Classifier(model_cfg).to(device=dev,
                                     memory_format=torch.channels_last)
    model.load_state_dict(w0)
    phases("model")
    set_mode(model, True)
    phases("train mode")
    steps_per_epoch = n // b
    state = create_train_state(model, TrainConfig(
        learning_rate=tr["learning_rate"], weight_decay=tr["weight_decay"],
        optimizer=tr["optimizer"], schedule=tr["schedule"], batch_size=b,
        max_epochs=tr["nominal_epochs"], aug_intensity=tr["intensity"]),
        model_cfg, steps_per_epoch)
    phases("optimizer")
    names = [str(i) for i in range(n)]
    hbm = HBMDataset(CachedDataset(images, labels, names,
                                   tuple(f"class{i}" for i in
                                         range(len(tr["class_counts"])))),
                     dev, shuffle_seed=seeds["shuffle"])
    sampler = EpochSampler(hbm, b, seed=seeds["sampler"])
    phases("resident set")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seeds["draws"])
    step_cfg = StepConfig(intensity=tr["intensity"],
                          out_size=cfg["image_size"],
                          compute_dtype=getattr(torch, cfg["compute_dtype"]),
                          dropout_rate=cfg["dropout_rate"])
    cw_t = torch.from_numpy(cw).to(dev)

    def steps(offs):
        return epoch_step(state, hbm, offs, b, step_cfg, cw_t, gen, None)

    # the checked steps: the first of the first epoch, then the rest
    offsets = sampler.epoch_offsets(steps_per_epoch)
    k = tr["checked_steps"]
    first = steps(offsets[:1])
    moments = state.optimizer.moments["mu"]
    prog_first = {name: (m / (1 - ref_train.ADAM_B1)).float().cpu()
                  for name, m in moments.items()}
    prog_grad = _norms(prog_first)
    rest = steps(offsets[1:k])
    prog_losses = [float(x) for x in torch.cat([first["loss"],
                                                 rest["loss"]])]
    sd = model.state_dict()
    prog_change = _norms({name: sd[name].float() - w0[name].float()
                          for name in sd if sd[name].is_floating_point()
                          and (name in state.optimizer.params
                               or not torch.equal(sd[name], w0[name]))})
    common.sync(dev)
    phases("checked steps")
    t0 = common.now()
    setup_s = t0 - cell.t_start

    marks = _Marks(dev)
    hooks = _hooks(state, marks) if cell.trace else []
    window_losses, done, epoch = [], 0, 0
    pending = offsets[k:]
    with warnings.catch_warnings():
        # the classifier's input carries no gradient, which the backward
        # pre-hook warns of
        warnings.filterwarnings("ignore", "Full backward hook")
        while True:
            if cell.trace:
                marks("start")
            window_losses.append(steps(pending)["loss"])
            done += len(pending)
            common.sync(dev)
            if common.now() - t0 >= cell.seconds:
                break
            epoch += 1
            hbm.local_reshuffle(seeds["shuffle"] + RESHUFFLE_STRIDE * epoch)
            pending = sampler.epoch_offsets(steps_per_epoch)
    window_s = common.now() - t0
    for h in hooks:
        h.remove()
    profile = None
    if cell.trace:
        with tracing.traced(dev) as profile:
            steps(sampler.epoch_offsets(tr["traced_steps"]))
    losses = torch.cat(window_losses).float().cpu().numpy()
    memory_peak = common.memory_peak(dev)
    del state, model, hbm, first, rest, moments, sd
    common.free(dev)

    ref = ref_train.follow(cfg, tr, w0, images, labels, cw, seeds, k, dev)
    checks, notes = compare({"losses": prog_losses, "first_grad": prog_grad,
                             "first_grad_tensors": prog_first,
                             "change": prog_change}, ref)
    blocks = counts.k1_blocks(cfg, b)
    return {
        "setup_s": setup_s, "window_s": window_s, "steps": done,
        "images": done * b, "attempted": done,
        "failed": int(np.sum(~np.isfinite(losses))),
        "checks": checks, "memory_peak_bytes": memory_peak,
        "profile": profile, "hook_ms": marks.split_ms(),
        "train_flops_per_image": counts.train_flops(cfg),
        "k1_blocks_per_forward": len(blocks),
        "k1_bound_ms_per_forward": sum(counts.k1_bound_ms(*x)
                                       for x in blocks),
        "notes": {"set-up s": phases.done, **notes},
    }
