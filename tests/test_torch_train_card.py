"""Card-only checks of the training slice; they import neither JAX nor
the JAX package, so they run on a machine with the card alone:
``python -m pytest -m gpu tests/test_torch_train_card.py``.  Without a
CUDA device they skip.

- The optimizer on the card (torch's fused Adam / AdamW, SGD's foreach
  ops) against the same optimizer on the CPU: six steps from the same
  gradients, parameters within 1e-6.
- The frozen prefix's span counts K1's 10 launches and the epilogue's 10
  per ResNet50 forward.
- The frozen prefix's epilogue kernel (``csrc/frozen_epilogue.cu``)
  against its plain version at the cell's shapes, B=8.
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


@pytest.mark.gpu
def test_frozen_span_counts_k1_launches_on_the_card():
    """``train.forward.frozen`` (models/resnet.py::forward_frozen) counts
    K1's launches: the 10 frozen identity blocks of ResNet50, once per
    forward, and the epilogue's: the stem's and three in each of the
    three blocks 0; the span's device time lies inside the step's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from irp_tpu_torch.train.loop import set_mode
    from irp_tpu_torch.train.step import StepConfig, train_step
    from irp_tpu_torch.utils import monitor

    cfg = ModelConfig(depth=50, num_classes=10, image_size=224,
                      fused_frozen_blocks="auto")
    model = init_classifier(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    set_mode(model, True)
    state = tstate.create_train_state(model, TrainConfig(batch_size=8),
                                      cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randint(0, 256, (8, 256, 256, 3), dtype=torch.uint8,
                           device="cuda", generator=gen)
    labels = torch.arange(8, device="cuda") % 10
    step_cfg = StepConfig(out_size=224, compute_dtype=torch.bfloat16)
    train_step(state, images, labels, step_cfg, generator=gen)  # builds K1
    with monitor.tracing() as records:
        for _ in range(2):
            train_step(state, images, labels, step_cfg, generator=gen)
    frozen = [r for r in records if r["name"] == "train.forward.frozen"]
    steps = [r for r in records if r["name"] == "train.step"]
    assert [r["counts"] for r in frozen] == [
        {"k1_launches": 10, "epilogue_launches": 10}] * 2
    for f, s in zip(frozen, steps):
        assert 0 < f["device_ms"] < s["device_ms"]


# (y shape, residual, pool): the epilogue's ten sites in a ResNet50/224
# forward at B=8 (the stem; conv1, conv2 and the tail of the blocks 0 of
# layers 1-3), then odd and small maps and C=8, the kernel's narrowest
EPILOGUE_CASES = [((8, 112, 112, 64), False, True)] + [
    (shape, tail, False) for hw, m, s in ((56, 64, 1), (56, 128, 2),
                                          (28, 256, 2))
    for shape, tail in (((8, hw, hw, m), False),
                        ((8, hw // s, hw // s, m), False),
                        ((8, hw // s, hw // s, 4 * m), True))] + [
    ((3, 7, 5, 16), False, True), ((2, 1, 1, 8), False, True),
    ((2, 6, 4, 8), False, True), ((3, 7, 5, 24), True, False),
    ((1, 3, 3, 8), False, False)]


@pytest.mark.gpu
def test_epilogue_kernel_bit_equal_to_plain_on_card():
    """Each entry point of ``csrc/frozen_epilogue.cu`` (the op's three
    forms: pooled, with a residual, plain) against
    ``frozen_epilogue_plain``, bit for bit: both add in f32 in the same
    order with no contraction and round to bf16 once (to nearest even),
    and the max of bf16 values is exact.  Each launch is counted and its
    ``cudaGetLastError`` checked (the wrapper raises on a nonzero code);
    the synchronize brings a fault during the run to light here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from irp_tpu_torch.ops import cuda_resnet as ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, tail, pool in EPILOGUE_CASES:
        c = shape[3]

        def rand(*s):
            return torch.randn(s, generator=gen, device="cuda")

        y = (rand(*shape) * 3).to(torch.bfloat16)
        b = rand(c)
        before = ops.frozen_epilogue.launches
        if pool:
            got = ops.frozen_epilogue(y, b, pool=True)
            want = ops.frozen_epilogue_plain(y, b, pool=True)
        elif tail:
            r = (rand(*shape) * 3).to(torch.bfloat16)
            b_r = rand(c)
            got = ops.frozen_epilogue(y, b, r, b_r)
            want = ops.frozen_epilogue_plain(y, b, r, b_r)
        else:
            got = ops.frozen_epilogue(y, b)
            want = ops.frozen_epilogue_plain(y, b)
        torch.cuda.synchronize()
        assert ops.frozen_epilogue.launches == before + 1
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert torch.equal(got, want), (shape, tail, pool)
