"""``ModelConfig.remat_trainable_blocks`` in the port: each trainable
block's activations are recomputed in the backward
(``torch.utils.checkpoint``), as the JAX package's ``nn.remat`` does.

- On the CPU, one train step with the flag on runs each trainable block
  twice (forward and recompute) and equals the step with it off: the
  loss, every gradient and the BN running mean and variance
  after the step (the recompute must not move them a second time), to
  1e-6 relative.
- On the card (gpu-marked; this file imports no JAX, so it runs there),
  at ResNet50/224 and B=64, the peak allocated memory of a step is lower
  with the flag on.
"""

import dataclasses

import numpy as np
import pytest
import torch

from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.models.classifier import init_classifier
from irp_tpu_torch.train.step import StepConfig, loss_and_grads

torch.set_num_threads(1)


def _step(cfg, images, labels, device="cpu", dtype=torch.float32):
    model = init_classifier(cfg, torch.Generator().manual_seed(0),
                            device=device)
    model.train()
    calls = []
    model.backbone.layer4[0].register_forward_pre_hook(
        lambda *_: calls.append(1))
    x = torch.from_numpy(images).to(device)
    y = torch.from_numpy(labels).to(device)
    # dropout rate 0: the head draws no masks
    loss, _ = loss_and_grads(model, x, y,
                             StepConfig(compute_dtype=dtype,
                                        dropout_rate=0.0))
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    bufs = {n: b.detach().clone() for n, b in model.named_buffers()
            if "running" in n}
    return float(loss), grads, bufs, len(calls)


@pytest.mark.parametrize("bn_stats_mode", ["trainable_only", "all"])
def test_remat_step_equals_the_plain_step(bn_stats_mode):
    rng = np.random.default_rng(0)
    images = rng.normal(0, 1, (4, 56, 56, 3)).astype(np.float32)
    labels = np.array([0, 1, 2, 1])
    cfg = ModelConfig(depth=18, num_classes=3, image_size=56,
                      compute_dtype="float32", precision="highest",
                      bn_stats_mode=bn_stats_mode,
                      trainable_stages=("layer3", "layer4"))
    loss0, g0, b0, calls0 = _step(cfg, images, labels)
    loss1, g1, b1, calls1 = _step(dataclasses.replace(
        cfg, remat_trainable_blocks=True), images, labels)
    # the block ran again in the backward with the flag, once without
    assert (calls0, calls1) == (1, 2)
    assert abs(loss1 - loss0) <= 1e-6 * abs(loss0)
    assert g1.keys() == g0.keys() and len(g0) > 0
    for name, g in g0.items():
        scale = float(g.abs().max()) or 1.0
        assert float((g1[name] - g).abs().max()) <= 1e-6 * scale, name
    moved = 0
    for name, b in b0.items():
        scale = float(b.abs().max()) or 1.0
        assert float((b1[name] - b).abs().max()) <= 1e-6 * scale, name
        moved += int("layer4" in name and "running_mean" in name
                     and float(b.abs().max()) > 0)
    assert moved > 0  # layer4's BN moved its statistics in the step


@pytest.mark.gpu
def test_remat_lowers_peak_memory_on_the_card():
    """The peak of the trainable part of a step: layer4, the head, the
    loss and the backward, from the frozen prefix's output.  The frozen
    prefix runs without autograd, so remat leaves it alone; its no-grad
    transients (the stem's f32 BatchNorm at 112 x 112) can set the whole
    step's peak, which is printed beside."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        rng.normal(0, 1, (64, 224, 224, 3)).astype(np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 10, 64)).cuda()
    peaks = {}
    for remat in (False, True):
        cfg = ModelConfig(num_classes=10, remat_trainable_blocks=remat)
        model = init_classifier(cfg, torch.Generator().manual_seed(0),
                                device="cuda")
        model.train()
        x = images.permute(0, 3, 1, 2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            frozen = model.backbone.forward_frozen(x)
        torch.cuda.synchronize()
        frozen_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        logits = model.head(model.backbone.forward_trainable(frozen), 0.0)
        torch.nn.functional.cross_entropy(logits, labels).backward()
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated() - base,
                        frozen_peak)
        del model, frozen, logits
        torch.cuda.empty_cache()
    print(f"trainable part's peak above its input, bytes (off, on): "
          f"{peaks[False][0]}, {peaks[True][0]}; frozen forward's peak: "
          f"{peaks[False][1]}, {peaks[True][1]}")
    assert peaks[True][0] < peaks[False][0], peaks
