"""What the loops share: the program's model configuration from a
configuration file, the seeds of a run's streams, the weights, and the
clock."""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch

from benchmark import synth
from benchmark.reference import augment, families
from benchmark.reference import models as ref_models
from benchmark.reference.precision import no_tf32

# streams drawn from a run's seed
IMAGES, SHUFFLE, SAMPLER, DRAWS = 10, 12, 13, 14


def seed_of(seed: int, stream: int) -> int:
    return synth.sub_seed(seed, stream) & 0x7FFF_FFFF


def model_config(cfg: dict):
    """The program's ``ModelConfig`` for a configuration's ``model``."""
    from irp_tpu_torch.config import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg.items() if k in fields})


def weights(cfg: dict, seed: int, calibration_images, device) -> dict:
    """The run's weights on ``device``: made from the seed, then, where
    the family has running statistics, those measured on
    ``calibration_images`` (centre-cropped, normalized, float32, TF32
    off), as a trained network's are."""
    w = synth.weights(ref_models.specs(cfg), seed, device)
    calibrate = getattr(families.load(cfg), "calibrate", None)
    if calibrate:
        x = augment.eval_crop(torch.from_numpy(calibration_images).to(device),
                              cfg["image_size"])
        with no_tf32():
            calibrate(w, cfg, x)
    return w


class Phases:
    """Seconds of each part of set-up, from the process's start."""

    def __init__(self, t_start: float, device):
        self.last = t_start
        self.done = {}
        if torch.device(device).type == "cuda":
            torch.cuda.init()
            torch.empty(1, device=device)
        self("interpreter, imports, CUDA context")

    def __call__(self, name: str) -> None:
        t = now()
        self.done[name] = round(t - self.last, 3)
        self.last = t


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def leaf_gaps(prog: dict, ref: dict, skip=()) -> list:
    """Per leaf, the gap between the program's and the reference's norm,
    against the larger of the reference's norm of that leaf and of the
    median leaf; over the leaves either side has, but ``skip``; largest
    first, as (gap, leaf, program's norm, reference's norm).  A leaf one
    side lacks counts as 0 there."""
    names = (set(prog) | set(ref)) - set(skip)
    kept = [ref[k] for k in ref if k not in skip]
    med = statistics.median(kept) if kept else 0.0
    out = [(abs(prog.get(k, 0.0) - ref.get(k, 0.0))
            / max(ref.get(k, 0.0), med, 1e-30), k, prog.get(k, 0.0),
            ref.get(k, 0.0)) for k in names]
    return sorted(out, reverse=True)
