"""Training: checkpoints, and the fine-tune ``fit`` with its state, steps
and loops."""

from irp_tpu_torch.train.fit import FitResult, fit

__all__ = ["FitResult", "fit"]
