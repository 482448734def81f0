"""Learning-rate schedules (the JAX package's ``ops/schedules.py``).

Each schedule is a host function ``count -> float``: the optimizer reads
its value once per step on the host, so no step waits on the device for
it.  The curves are optax's, which the JAX package wraps:

- :func:`onecycle_cosine`: torch OneCycleLR with cosine annealing and
  torch's defaults (``optax.cosine_onecycle_schedule``: warm up from
  ``max_lr / div_factor`` over ``pct_start`` of the steps, then down to
  ``max_lr / (div_factor * final_div_factor)``);
- :func:`cosine_anneal`: torch CosineAnnealingLR(eta_min=0);
- :func:`constant`.

Values are computed in float32, op for op as optax computes them, so the
port's lr is the JAX package's to an ulp.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

Schedule = Callable[[int], float]
_F = np.float32


def onecycle_cosine(max_lr: float, total_steps: int,
                    pct_start: float = 0.3, div_factor: float = 25.0,
                    final_div_factor: float = 1e4) -> Schedule:
    """OneCycleLR(cos) with torch's defaults.  Cycles shorter than 4 steps
    are clamped to 4 (a shorter one has zero-width segments)."""
    steps = max(int(total_steps), 4)
    bounds = (0, int(pct_start * steps), steps)
    values = np.cumprod([max_lr / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)]).astype(_F)

    def schedule(count: int) -> float:
        for i in range(2):
            lo, hi = bounds[i], bounds[i + 1]
            if lo <= count < hi:
                pct = _F(count - lo) / _F(hi - lo)
                start, end = values[i], values[i + 1]
                return float(end + (start - end) / _F(2.0)
                             * (np.cos(_F(math.pi) * pct) + _F(1.0)))
        return float(values[-1])

    return schedule


def cosine_anneal(max_lr: float, total_steps: int) -> Schedule:
    """``lr_t = max_lr * (1 + cos(pi * t / T)) / 2``, held at 0 after T."""
    steps = _F(max(int(total_steps), 1))

    def schedule(count: int) -> float:
        t = min(_F(count), steps)
        decay = _F(0.5) * (_F(1.0) + np.cos(_F(math.pi) * t / steps))
        return float(_F(max_lr) * decay)

    return schedule


def constant(lr: float) -> Schedule:
    return lambda count: float(_F(lr))
