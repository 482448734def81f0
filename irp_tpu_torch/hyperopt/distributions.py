"""Search-space distributions with an internal uniform representation.

Numeric params map to an internal real line (log-space for log params) so
the TPE sampler can fit 1-D Parzen estimators uniformly; categoricals keep
index form.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Any, Sequence, Tuple


@dataclass(frozen=True)
class FloatDistribution:
    low: float
    high: float
    log: bool = False
    step: float | None = None

    kind = "float"

    def to_internal(self, value: float) -> float:
        return math.log(value) if self.log else float(value)

    def from_internal(self, x: float) -> float:
        v = math.exp(x) if self.log else float(x)
        if self.step is not None:
            v = self.low + round((v - self.low) / self.step) * self.step
        return min(max(v, self.low), self.high)

    @property
    def internal_bounds(self) -> Tuple[float, float]:
        if self.log:
            return math.log(self.low), math.log(self.high)
        return self.low, self.high


@dataclass(frozen=True)
class IntDistribution:
    low: int
    high: int
    log: bool = False
    step: int = 1

    kind = "int"

    def to_internal(self, value: int) -> float:
        return math.log(value) if self.log else float(value)

    def from_internal(self, x: float) -> int:
        v = math.exp(x) if self.log else x
        v = int(round((v - self.low) / self.step)) * self.step + self.low
        return min(max(v, self.low), self.high)

    @property
    def internal_bounds(self) -> Tuple[float, float]:
        if self.log:
            return math.log(self.low), math.log(self.high)
        # half-open +-0.5 so rounding gives every integer (incl. the
        # endpoints) equal probability under a uniform internal draw
        return self.low - 0.5 + 1e-9, self.high + 0.5 - 1e-9


@dataclass(frozen=True)
class CategoricalDistribution:
    choices: tuple

    kind = "categorical"

    def __init__(self, choices: Sequence[Any]):
        object.__setattr__(self, "choices", tuple(choices))

    def to_internal(self, value: Any) -> float:
        return float(self.choices.index(value))

    def from_internal(self, x: float) -> Any:
        return self.choices[int(x)]


def dump_distribution(dist) -> str:
    if isinstance(dist, FloatDistribution):
        return json.dumps({"kind": "float", "low": dist.low,
                           "high": dist.high, "log": dist.log,
                           "step": dist.step})
    if isinstance(dist, IntDistribution):
        return json.dumps({"kind": "int", "low": dist.low, "high": dist.high,
                           "log": dist.log, "step": dist.step})
    if isinstance(dist, CategoricalDistribution):
        return json.dumps({"kind": "categorical",
                           "choices": list(dist.choices)})
    raise TypeError(f"unknown distribution {dist!r}")


def load_distribution(s: str):
    d = json.loads(s)
    kind = d.pop("kind")
    if kind == "float":
        return FloatDistribution(**d)
    if kind == "int":
        return IntDistribution(**d)
    if kind == "categorical":
        return CategoricalDistribution(d["choices"])
    raise ValueError(f"unknown distribution kind {kind}")
