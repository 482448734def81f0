"""Mean device ms a step spends in the augment part of train_step, from
CUDA events recorded by hooks on the real step (loops/train.py)."""

from benchmark.metrics._util import mean


def read(record):
    return mean(record["hook_ms"]["augment"])
