"""Card-only checks of the training slice; they import neither JAX nor
the JAX package, so they run on a machine with the card alone:
``python -m pytest -m gpu tests/test_torch_train_card.py``.  Without a
CUDA device they skip.

- The optimizer on the card (torch's fused Adam / AdamW, SGD's foreach
  ops) against the same optimizer on the CPU: six steps from the same
  gradients, parameters within 1e-6.
"""

import numpy as np
import pytest
import torch

from irp_tpu_torch.config import ModelConfig, TrainConfig
from irp_tpu_torch.models.classifier import init_classifier
from irp_tpu_torch.train import state as tstate


def _optimizer(kind, device):
    cfg = ModelConfig(depth=18, num_classes=3, image_size=32,
                      compute_dtype="float32")
    model = init_classifier(cfg, torch.Generator().manual_seed(0),
                            device=device)
    tc = TrainConfig(optimizer=kind, schedule="onecycle", learning_rate=3e-3,
                     weight_decay=1e-2, max_epochs=2, ema_decay=0.9)
    return model, tstate.make_optimizer(model, tc, cfg, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["adam", "adamw", "sgd"])
def test_card_optimizer_matches_cpu(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    models = {}
    for device in ("cpu", "cuda"):
        model, opt = _optimizer(kind, device)
        rng = np.random.default_rng(0)
        for _ in range(6):
            for p in opt.params.values():
                # in the parameter's layout, as autograd gives it
                p.grad = torch.empty_like(p).copy_(torch.from_numpy(
                    rng.normal(0, 1e-2, tuple(p.shape)).astype(np.float32)))
            opt.step()
        models[device] = model
    if kind != "sgd":
        assert opt.torch_opt.defaults["fused"]
    for (n, a), b in zip(models["cpu"].state_dict().items(),
                         models["cuda"].state_dict().values()):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-6, msg=n)
