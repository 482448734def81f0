"""The traced window's share (%) in which no device operation ran,
from torch.profiler's device records."""

from benchmark.metrics._util import idle_share_pct


def read(record):
    return idle_share_pct(record)
