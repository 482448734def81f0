"""The train-mode BatchNorm op (``ops/cuda_batch_norm.py``) on the CPU,
where its plain versions run; the kernels (``csrc/bn_train.cu``) are held
to them on the card by ``tests/test_torch_train_card.py``.

- The plain form of the hand-written backward equals autograd of the
  formula ``BatchNorm2d`` runs as PyTorch ops, in f64: random inputs; a
  channel whose ``E[x^2] - E[x]^2`` falls below 0 (the clamp drops the
  variance's term of dx there); ``hold_stats`` leaving the running buffers
  untouched; EfficientNet-B5's eps and momentum.
- The op (``batch_norm_train``, an autograd Function) runs on the card
  alone and raises on a CPU tensor.  On the card (``gpu``, skipped
  without one): its y bit-equal to the formula given its moments and its
  gradients within bf16 rounding; under ``torch.utils.checkpoint`` (as
  ``remat_blocks`` runs it) the gradients are the same and the running
  buffers move once.
- ``BatchNorm2d`` takes the op only for a bf16 CUDA input with no
  ``group``: CPU inputs, f64 inputs and a set group keep the formula, and
  ``bn_train_launches`` (counted on the card alone) reads 0.
- The kernels' tiling fills the card at layer4's shapes and holds
  ragged ones.
"""

import contextlib
import copy
import types

import numpy as np
import pytest
import torch

from irp_tpu_torch.models.resnet import BatchNorm2d
from irp_tpu_torch.ops import cuda_batch_norm as bn

torch.set_num_threads(1)

# (name, shape, eps, momentum, hold_stats, clipped channel)
F64_CASES = {
    "random": ((4, 16, 5, 3), 1e-5, 0.1, False, False),
    "clipped": ((4, 16, 5, 3), 1e-5, 0.1, False, True),
    "hold_stats": ((4, 16, 5, 3), 1e-5, 0.1, True, False),
    "efficientnet_b5": ((3, 24, 4, 4), 1e-3, 0.01, False, False),
}


def _clipped_value(n: int) -> float:
    """A constant whose n copies give a negative E[x^2] - E[x]^2 in f64
    (rounding alone), so that the clamp clips it."""
    for v in np.linspace(0.1, 3.0, 300):
        x = torch.full((n,), float(v), dtype=torch.float64)
        if float((x * x).mean() - x.mean() * x.mean()) < 0:
            return float(v)
    raise AssertionError("no constant clips at this n")


def _inputs(shape, clipped: bool, dtype=torch.float64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    x = torch.randn(shape, generator=gen, dtype=torch.float64) * 1.7 + 0.4
    if clipped:
        x[:, 3] = _clipped_value(n * h * w)
    weight = torch.rand(c, generator=gen, dtype=torch.float64) + 0.5
    bias = torch.randn(c, generator=gen, dtype=torch.float64)
    dy = torch.randn(shape, generator=gen, dtype=torch.float64)
    return (x.to(dtype), weight.float(), bias.float(), dy.to(dtype))


def _module(c, eps, momentum, dtype, weight, bias, seed=1):
    gen = torch.Generator().manual_seed(seed)
    m = BatchNorm2d(c, dtype)
    m.eps, m.momentum = eps, momentum
    with torch.no_grad():
        m.weight.copy_(weight)
        m.bias.copy_(bias)
        m.running_mean.copy_(torch.randn(c, generator=gen))
        m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return m.train()


def _formula(m, x, dy):
    """y, dx, dweight, dbias and the running buffers of ``m`` (the
    formula as PyTorch ops, differentiated by autograd)."""
    x = x.clone().requires_grad_(True)
    m.zero_grad()
    y = m(x)
    y.backward(dy.to(y.dtype))
    return (y.detach(), x.grad, m.weight.grad.clone(), m.bias.grad.clone(),
            m.running_mean.clone(), m.running_var.clone())


def _plain_formula(m, x, dy):
    """The same formula from the plain versions, differentiated by
    autograd: what ``BatchNorm2d`` runs off the op, on any device."""
    x = x.clone().requires_grad_(True)
    m.zero_grad()
    xf = x.float()
    mean, ex2 = bn.batch_moments(xf)
    var_raw = ex2 - mean * mean
    bn.update_running_stats(m.running_mean, m.running_var, mean, var_raw,
                            m.momentum)
    y = bn.normalize_plain(xf, mean, var_raw, m.weight, m.bias,
                           m.eps).to(x.dtype)
    y.backward(dy)
    return (y.detach(), x.grad, m.weight.grad.clone(), m.bias.grad.clone(),
            m.running_mean.clone(), m.running_var.clone())


def _op(m, x, dy, update=True):
    """The same through ``batch_norm_train`` on the module's tensors."""
    x = x.clone().requires_grad_(True)
    m.zero_grad()
    y = bn.batch_norm_train(x, m.weight, m.bias, m.running_mean,
                            m.running_var, m.momentum, m.eps, update)
    y.backward(dy.to(y.dtype))
    return (y.detach(), x.grad, m.weight.grad.clone(), m.bias.grad.clone(),
            m.running_mean.clone(), m.running_var.clone())


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.parametrize("case", sorted(F64_CASES))
def test_plain_backward_equals_autograd_of_the_formula_f64(case):
    """The hand-written backward in plain PyTorch against autograd of the
    formula, in f64; the running buffers the formula leaves are
    :func:`update_running_stats`'s from the plain moments, or untouched
    when held."""
    shape, eps, momentum, hold, clipped = F64_CASES[case]
    x, weight, bias, dy = _inputs(shape, clipped)
    c = shape[1]
    ref = _module(c, eps, momentum, torch.float64, weight, bias)
    ref.hold_stats = hold
    start = (ref.running_mean.clone(), ref.running_var.clone())
    y, dx, dw, db, rm, rv = _formula(ref, x, dy)

    y_p, moments = bn.batch_norm_train_plain(x, weight.double(),
                                             bias.double(), eps)
    if clipped:
        assert moments[1, 3] < 0  # the clamp clips this channel
    dx_p, dw_p, db_p = bn.batch_norm_train_backward_plain(
        dy, x, moments, weight.double(), eps)
    torch.testing.assert_close(y_p, y, rtol=0, atol=1e-13)
    scale = float(dx.abs().max())
    torch.testing.assert_close(dx_p, dx, rtol=0, atol=1e-12 * scale)
    torch.testing.assert_close(dw_p.float(), dw, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(db_p.float(), db, rtol=1e-6, atol=1e-6)

    if hold:
        assert torch.equal(rm, start[0]) and torch.equal(rv, start[1])
    else:
        want = [t.clone() for t in start]
        bn.update_running_stats(*want, moments[0], moments[1], momentum)
        assert not torch.equal(rm, start[0])
        assert torch.equal(rm, want[0]) and torch.equal(rv, want[1])


def test_op_raises_off_the_card():
    """No fallback: the op runs its kernels or raises, and a CPU tensor
    has none."""
    x, weight, bias, _ = _inputs((2, 8, 3, 3), False, torch.bfloat16)
    m = _module(8, 1e-5, 0.1, torch.bfloat16, weight, bias)
    before = (bn.batch_norm_train.launches,
              bn.batch_norm_train.backward_launches)
    with pytest.raises(ValueError, match="CUDA"):
        bn.batch_norm_train(x, m.weight, m.bias, m.running_mean,
                            m.running_var, m.momentum, m.eps)
    assert (bn.batch_norm_train.launches,
            bn.batch_norm_train.backward_launches) == before


@pytest.mark.gpu
def test_op_in_bf16_matches_the_formula():
    """The op's Function on the card against the formula: y bit-equal to
    the plain normalisation given the moments of its own statistics
    kernel, the running buffers bit-equal to the plain update from them,
    and the gradients within the bf16 rounding of dx and the f32
    summation order of dw and db of autograd's through the formula."""
    _needs_card()
    x, weight, bias, dy = (t.cuda() for t in _inputs(
        (4, 16, 6, 5), False, torch.bfloat16))
    start = _module(16, 1e-5, 0.1, torch.bfloat16, weight, bias).cuda()
    want = _plain_formula(copy.deepcopy(start), x, dy)
    got = _op(copy.deepcopy(start), x, dy)
    held = [start.running_mean.clone(), start.running_var.clone()]
    moments = bn._stats_cuda(bn._nhwc_memory(x), *held, start.momentum,
                             False)
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    assert torch.equal(got[0], bn.normalize_plain(
        x.float(), moments[0], moments[1], weight.cuda(), bias.cuda(),
        start.eps).to(torch.bfloat16))
    moved = [start.running_mean.clone(), start.running_var.clone()]
    bn.update_running_stats(*moved, moments[0], moments[1], start.momentum)
    assert torch.equal(got[4], moved[0]) and torch.equal(got[5], moved[1])
    ulp = 2.0 ** -8 * float(want[1].float().abs().max())
    assert float((got[1].float() - want[1].float()).abs().max()) <= ulp
    for g, w in zip(got[2:4], want[2:4]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_op_under_checkpoint_moves_the_running_buffers_once():
    """A per-channel scale and the op recomputed in the backward on the
    card (``torch.utils.checkpoint`` with the statistics held in the
    recompute, as ``models/resnet.py::remat_call`` does): the same
    gradients as the plain run, bit for bit, and the running buffers moved
    by the first forward alone."""
    _needs_card()
    x, weight, bias, dy = (t.cuda() for t in _inputs(
        (2, 8, 5, 5), False, torch.bfloat16))
    gen = torch.Generator().manual_seed(3)
    scale0 = (torch.rand(8, generator=gen) + 0.5).to(torch.bfloat16).cuda()
    runs = []
    for remat in (False, True):
        m = _module(8, 1e-5, 0.1, torch.bfloat16, weight, bias).cuda()
        scale = scale0.clone().requires_grad_(True)
        holding = []

        def block(t):
            return bn.batch_norm_train(t * scale[:, None, None], m.weight,
                                       m.bias, m.running_mean,
                                       m.running_var, m.momentum, m.eps,
                                       not holding)

        def contexts():
            @contextlib.contextmanager
            def hold():
                holding.append(True)
                try:
                    yield
                finally:
                    holding.pop()
            return contextlib.nullcontext(), hold()

        xi = x.clone().requires_grad_(True)
        launches = bn.batch_norm_train.launches
        y = (torch.utils.checkpoint.checkpoint(
            block, xi, use_reentrant=False, context_fn=contexts)
            if remat else block(xi))
        y.backward(dy)
        runs.append((xi.grad, scale.grad, m.weight.grad, m.bias.grad,
                     m.running_mean.clone(), m.running_var.clone()))
        assert bn.batch_norm_train.launches - launches == 1 + remat
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
def test_batchnorm_keeps_the_formula_on_the_cpu(dtype):
    """On the CPU BatchNorm2d runs the formula (autograd's graph, not the
    op's Function) at every dtype, and counts no launch."""
    dt = getattr(torch, dtype)
    x, weight, bias, _ = _inputs((2, 8, 3, 3), False, dt)
    m = _module(8, 1e-5, 0.1, dt, weight, bias)
    before = (bn.batch_norm_train.launches,
              bn.batch_norm_train.backward_launches)
    y = m(x.requires_grad_(True))
    assert "BatchNormTrain" not in type(y.grad_fn).__name__
    y.sum().backward()
    assert (bn.batch_norm_train.launches,
            bn.batch_norm_train.backward_launches) == before


def test_batchnorm_takes_the_op_only_for_bf16_cuda_without_a_group():
    """The routing rule, on stand-ins for a tensor's device and dtype: a
    bf16 CUDA input takes the op; f32, f64 and CPU inputs, a set group and
    a non-bf16 compute dtype keep the formula."""
    def t(is_cuda, dtype):
        return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype)

    m = BatchNorm2d(8)
    assert m.takes_op(t(True, torch.bfloat16))
    for x in (t(False, torch.bfloat16), t(True, torch.float32),
              t(True, torch.float64)):
        assert not m.takes_op(x)
    m.group = object()
    assert not m.takes_op(t(True, torch.bfloat16))
    assert not BatchNorm2d(8, torch.float32).takes_op(t(True, torch.bfloat16))


# (rows, C): ResNet50's layer4 at B=256 (bn1 of block 0; every other
# 512-channel BN; the 2048-channel ones), then EfficientNet's widths and
# ragged maps
PLAN_SHAPES = [(50176, 512), (12544, 512), (12544, 2048), (50, 96),
               (7, 1152), (1, 8), (3 * 5 * 7, 96), (401, 24)]


@pytest.mark.parametrize("rows,c", PLAN_SHAPES)
def test_bn_plan_tiles_the_map(rows, c):
    """Every vector of the map falls in one lane of one slab, the blocks
    hold at most 256 threads, every split has a row, and at layer4's
    shapes the reductions run at least one block an SM of an H100 (132)
    and the elementwise passes many more."""
    plan = bn.bn_plan(rows, c, 132)
    cvec = c // 8
    assert plan.sw * plan.rp <= bn.THREADS and plan.sw <= bn.MAX_SW
    assert plan.slabs * plan.sw >= cvec > (plan.slabs - 1) * plan.sw
    per_split = -(-rows // plan.splits)
    assert 1 <= plan.splits <= rows and (plan.splits - 1) * per_split < rows
    if rows * c >= 12544 * 512:
        assert plan.splits * plan.slabs >= 132
        elementwise = -(-rows // (plan.rp * 4)) * plan.slabs
        assert elementwise >= 4 * 132
