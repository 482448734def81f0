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
- The train-mode BatchNorm kernels (``csrc/bn_train.cu``) against their
  plain versions at ResNet50 layer4's ten BN sites at B=256 and at ragged
  maps: the moments within f32 summation order, y bit-equal given the
  same moments, the running buffers bit-equal to the plain update (and
  untouched when held), and dx, dweight and dbias no farther from an f64
  evaluation than twice the formula's own f32 error; ``train.forward``
  counts 10 of the op's launches a ResNet50 forward and 0 in ViT-B/16;
  under ``remat_trainable_blocks`` the recompute runs the op again with
  the running buffers held.
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


# (site, (N, C, H, W)): ResNet50/224 layer4's ten train-mode BatchNorms at
# B=256, then ragged maps: C=96 (12 vectors, a slab of the whole row) with
# a constant channel and NCHW memory, a slab cut short (C=1152, 144
# vectors), rows that are not a multiple of a block's, one row
BN_SITES = [("layer4.0.bn1", (256, 512, 14, 14)),
            ("layer4.0.bn2", (256, 512, 7, 7)),
            ("layer4.0.bn3", (256, 2048, 7, 7)),
            ("layer4.0.downsample.1", (256, 2048, 7, 7))] + [
    (f"layer4.{j}.bn{k}", (256, 2048 if k == 3 else 512, 7, 7))
    for j in (1, 2) for k in (1, 2, 3)] + [
    ("c96_nchw_constant_channel", (3, 96, 5, 7)),
    ("c1152", (5, 1152, 3, 3)), ("c24_ragged_rows", (7, 24, 3, 5)),
    ("one_row", (1, 8, 1, 1))]


def _rel_err(got, want) -> float:
    want = want.double()
    return float((got.double() - want).norm() / want.norm().clamp_min(
        1e-300))


@pytest.mark.gpu
@pytest.mark.parametrize("site,shape", BN_SITES, ids=[s for s, _ in BN_SITES])
def test_bn_train_kernels_against_plain_on_card(site, shape):
    """``csrc/bn_train.cu`` at one map against the plain versions of
    ``ops/cuda_batch_norm.py`` on the same card tensors: the moments agree
    to within 1e-5 of E|x| and E[x^2] per channel (f32 sums in two
    orders, some 16 rounding levels deep each); y is bit-equal to the
    formula given the same moments (the same f32 ops, no contraction,
    rsqrtf); the running buffers are bit-equal to the plain update from
    the kernel's moments, and unchanged when held; each of dx, dweight
    and dbias is within twice the formula's own f32 error of an f64
    evaluation (norm of the difference over the norm)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from irp_tpu_torch.models.layers import at_least_f32
    from irp_tpu_torch.ops import cuda_batch_norm as bn

    eps, momentum = 1e-5, 0.1
    gen = torch.Generator(device="cuda").manual_seed(len(site) * 7919)
    n, c, h, w = shape

    def rand(*s):
        return torch.randn(s, generator=gen, device="cuda")

    x = rand(n, c, h, w) * 1.5 + 0.3
    fmt = torch.contiguous_format if "nchw" in site else torch.channels_last
    if "constant" in site:
        x[:, 5] = 0.3
    x = x.to(torch.bfloat16).contiguous(memory_format=fmt)
    dy = rand(n, c, h, w).to(torch.bfloat16).contiguous(memory_format=fmt)
    weight = torch.rand(c, generator=gen, device="cuda") + 0.5
    bias = rand(c)
    running = (rand(c), torch.rand(c, generator=gen, device="cuda") + 0.5)

    xl = bn._nhwc_memory(x)
    moved = [t.clone() for t in running]
    moments = bn._stats_cuda(xl, *moved, momentum, True)
    held = [t.clone() for t in running]
    bn._stats_cuda(xl, *held, momentum, False)
    _, plain = bn.batch_norm_train_plain(x, weight, bias, eps)
    torch.cuda.synchronize()
    xf = x.float()
    dims = (0, 2, 3)
    assert bool(((moments[0] - plain[0]).abs()
                 <= 1e-5 * xf.abs().mean(dims)).all()), site
    assert bool(((moments[1] - plain[1]).abs()
                 <= 1e-5 * (xf * xf).mean(dims)).all()), site
    want = [t.clone() for t in running]
    bn.update_running_stats(*want, moments[0], moments[1], momentum)
    assert all(torch.equal(a, b) for a, b in zip(moved, want)), site
    assert all(torch.equal(a, b) for a, b in zip(held, running)), site

    y = bn._normalize_cuda(xl, plain, weight, bias, eps)
    y_plain = bn.normalize_plain(xf, plain[0], plain[1], weight, bias,
                                 eps).to(torch.bfloat16)
    assert torch.equal(y, y_plain), site

    def formula(xin, w_, b_):
        xq = at_least_f32(xin)
        mean, ex2 = bn.batch_moments(xq)
        return bn.normalize_plain(xq, mean, ex2 - mean * mean, w_, b_,
                                  eps).to(xin.dtype)

    def op(xin, w_, b_):
        return bn.batch_norm_train(xin, w_, b_, *[t.clone() for t in running],
                                   momentum, eps)

    def grads(fn, dtype):
        pdt = torch.float64 if dtype == torch.float64 else torch.float32
        xin = x.to(dtype).clone().requires_grad_(True)
        w_ = weight.to(pdt).clone().requires_grad_(True)
        b_ = bias.to(pdt).clone().requires_grad_(True)
        out = fn(xin, w_, b_)
        out.backward(dy.to(out.dtype))
        return xin.grad, w_.grad, b_.grad

    launches = (bn.batch_norm_train.launches,
                bn.batch_norm_train.backward_launches)
    got = grads(op, torch.bfloat16)
    torch.cuda.synchronize()
    assert (bn.batch_norm_train.launches,
            bn.batch_norm_train.backward_launches) == (launches[0] + 1,
                                                       launches[1] + 1)
    assert got[0].dtype == torch.bfloat16
    f32 = grads(formula, torch.bfloat16)
    f64 = grads(formula, torch.float64)
    for name, g, p, r in zip(("dx", "dweight", "dbias"), got, f32, f64):
        assert _rel_err(g, r) <= 2 * _rel_err(p, r), (site, name,
                                                       _rel_err(g, r),
                                                       _rel_err(p, r))


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["resnet50", "vit_b16"])
def test_forward_span_counts_bn_train_launches_on_the_card(family):
    """``train.forward`` counts the train-mode BatchNorm op's launches:
    ResNet50's layer4 holds its ten trainable BNs, once a forward and once
    a backward; ViT-B/16 has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from irp_tpu_torch.ops.cuda_batch_norm import batch_norm_train
    from irp_tpu_torch.train.loop import set_mode
    from irp_tpu_torch.train.step import StepConfig, train_step
    from irp_tpu_torch.utils import monitor

    cfg = (ModelConfig(depth=50, num_classes=10, image_size=224,
                       fused_frozen_blocks="auto") if family == "resnet50"
           else ModelConfig(family="vit", patch_size=16, embed_dim=768,
                            num_layers=12, num_heads=12, mlp_dim=3072,
                            num_classes=10, image_size=224,
                            trainable_stages=("block11", "ln")))
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
    train_step(state, images, labels, step_cfg, generator=gen)  # builds
    backward = batch_norm_train.backward_launches
    with monitor.tracing() as records:
        for _ in range(2):
            train_step(state, images, labels, step_cfg, generator=gen)
    want = 10 if family == "resnet50" else 0
    assert [r["counts"] for r in records if r["name"] == "train.forward"] \
        == [{"bn_train_launches": want}] * 2
    assert batch_norm_train.backward_launches - backward == 2 * want


@pytest.mark.gpu
def test_bn_op_under_remat_matches_the_plain_step_on_the_card():
    """``remat_trainable_blocks`` recomputes each layer4 block in the
    backward with its BN statistics held (``models/resnet.py::
    remat_call``): through the train-mode BatchNorm op the recompute runs
    the op's ten forwards a second time and its backwards once; the loss
    and the running buffers equal the plain step's (the first forward is
    the same), and the gradients agree to bf16 rounding (cuDNN's weight
    gradients may sum in another order run to run)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from irp_tpu_torch.ops.cuda_batch_norm import batch_norm_train
    from irp_tpu_torch.train.step import StepConfig, loss_and_grads

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((8, 64, 64, 3), generator=gen, device="cuda")
    y = torch.arange(8, device="cuda") % 10
    cfg = ModelConfig(depth=50, num_classes=10, image_size=64)
    runs = []
    for remat in (False, True):
        model = init_classifier(
            dataclasses.replace(cfg, remat_trainable_blocks=remat),
            torch.Generator().manual_seed(0), device="cuda")
        model.train()
        before = (batch_norm_train.launches,
                  batch_norm_train.backward_launches)
        loss, _ = loss_and_grads(model, x, y, StepConfig(
            compute_dtype=torch.bfloat16, dropout_rate=0.0))
        torch.cuda.synchronize()
        runs.append((float(loss), {
            n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}, {
            n: b.detach().clone() for n, b in model.named_buffers()
            if "running" in n}, (
            batch_norm_train.launches - before[0],
            batch_norm_train.backward_launches - before[1])))
    (loss0, g0, b0, n0), (loss1, g1, b1, n1) = runs
    assert (n0, n1) == ((10, 10), (20, 10))
    assert loss1 == loss0
    assert b1.keys() == b0.keys()
    for name, b in b0.items():
        assert torch.equal(b1[name], b), name
    assert g1.keys() == g0.keys() and len(g0) > 0
    for name, g in g0.items():
        scale = float(g.abs().max()) or 1.0
        assert float((g1[name] - g).abs().max()) <= 2.0 ** -5 * scale, name
