"""The frozen ResNet prefix with its BN folded (irp_tpu_torch/models/
resnet.py: the stem and the frozen stages' blocks 0; ops/cuda_resnet.py:
the epilogue op ``irp_tpu_torch::frozen_epilogue``), on the CPU.

- Each plain epilogue equals the unfused sequence it replaces (conv,
  inference BN, then ReLU, the residual add or the max-pool): to f64's
  rounding in f64; in bf16 within 1 bf16 ulp plus a bound on the conv's
  rounding of the weights.
- A ResNet50/64 forward with 'on' matches 'off' and the JAX package's
  fused forward at the fused path's bar (rtol/atol 0.05, as
  tests/test_torch_model.py holds K1).
- The eligibility table: what takes no fold counts no epilogue pass and
  runs today's forward bit for bit, as do 'auto' on a CPU tensor and
  'off'.
- The fold cache: what it holds, what drops it, and a cached forward
  bit-equal to a per-call fold.
- A ResNet50 forward with 'on' calls the epilogue op 10 times, with
  'off' never; ``train.forward.frozen``'s ``epilogue_launches`` counts
  the card's launches alone, so it reads 0 here (10 on the card:
  tests/test_torch_train_card.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from irp_tpu.config import ModelConfig as JaxModelConfig
from irp_tpu.models.classifier import get_classifier as jax_get
from irp_tpu.models.classifier import init_classifier as jax_init
from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.models.classifier import get_classifier
from irp_tpu_torch.models.convert import jax_variables_to_state_dict
from irp_tpu_torch.models.layers import Conv2d
from irp_tpu_torch.models.resnet import (BatchNorm2d, FoldCache, ResNet,
                                         folded_conv)
from irp_tpu_torch.ops import cuda_resnet as ops
from irp_tpu_torch.utils import monitor

torch.set_num_threads(1)

CL = torch.channels_last


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _conv_bn(gen, cin, cout, k, stride, dtype):
    """A bias-free conv and an inference BN with statistics and affine
    away from 0 and 1, in ``dtype`` compute and channels_last memory;
    f64 parameters for f64, so that the fold too is in f64."""
    conv = Conv2d(cin, cout, k, stride, k // 2, compute_dtype=dtype)
    bn = BatchNorm2d(cout, dtype, frozen=True)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                          * (2.0 / (cin * k * k)) ** 0.5)
        bn.weight.copy_(torch.rand(cout, generator=gen) * 1.5 + 0.25)
        bn.bias.copy_(torch.randn(cout, generator=gen) * 0.5)
        bn.running_mean.copy_(torch.randn(cout, generator=gen) * 0.5)
        bn.running_var.copy_(torch.rand(cout, generator=gen) * 2.0 + 0.1)
    pdt = torch.float64 if dtype == torch.float64 else torch.float32
    return (conv.to(pdt, memory_format=CL).eval(), bn.to(pdt).eval())


def _site(name, dtype, seed):
    """(unfused, folded, bound) for one epilogue site on random inputs:
    the two outputs as NHWC f64 arrays, and ``bound`` the conv's
    weight-rounding bound at each output element (f64), carried through
    the site's ReLU, add or max-pool, which do not widen it."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((2, 16, 9, 11), generator=gen).to(dtype)
    x = x.contiguous(memory_format=CL)
    if name == "stem":
        sites = [_conv_bn(gen, 16, 24, 7, 2, dtype)]
    elif name == "conv_relu":
        sites = [_conv_bn(gen, 16, 24, 3, 2, dtype)]
    else:  # a block 0's tail: conv3 and the downsample conv
        sites = [_conv_bn(gen, 16, 32, 1, 1, dtype),
                 _conv_bn(gen, 16, 32, 1, 1, dtype)]
    with torch.no_grad():
        ys = [bn(conv(x)) for conv, bn in sites]
        folds = [folded_conv(conv, bn, dtype) for conv, bn in sites]
        zs = [F.conv2d(x, w, None, conv.stride, conv.padding)
              for (conv, _), (w, _) in zip(sites, folds)]
        bounds = [F.conv2d(x.double().abs(), w.double().abs(), None,
                           conv.stride, conv.padding)
                  for (conv, _), (w, _) in zip(sites, folds)]
    if name == "stem":
        want = F.max_pool2d(F.relu(ys[0]), 3, 2, 1)
        got = ops.frozen_epilogue(_nhwc(zs[0]).contiguous(), folds[0][1],
                                  pool=True)
        bound = F.max_pool2d(bounds[0], 3, 2, 1)
    elif name == "conv_relu":
        want = F.relu(ys[0])
        got = ops.frozen_epilogue(_nhwc(zs[0]).contiguous(), folds[0][1])
        bound = bounds[0]
    else:
        want = F.relu(ys[0] + ys[1])
        got = ops.frozen_epilogue(_nhwc(zs[0]).contiguous(), folds[0][1],
                                  _nhwc(zs[1]).contiguous(), folds[1][1])
        bound = bounds[0] + bounds[1]
    return (_nhwc(want).double(), got.double(), _nhwc(bound))


SITES = ("stem", "conv_relu", "tail")


@pytest.mark.parametrize("name", SITES)
def test_plain_epilogue_equals_unfused_sequence_f64(name):
    """In f64 the folded conv and the epilogue give the unfused sequence
    to f64's rounding: the fold only reorders exact arithmetic."""
    want, got, _ = _site(name, torch.float64, 1)
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", SITES)
def test_plain_epilogue_equals_unfused_sequence_bf16(name):
    """In bf16 the two differ by where the weights round (bf16(w) * s
    after the conv, bf16(w * s) before it) and where the outputs round:
    within 1 bf16 ulp of the unfused output plus 2**-7 of the conv of
    |x| and |folded weights| (two bf16 roundings of each product and of
    the conv's output)."""
    want, got, bound = _site(name, torch.bfloat16, 2)
    assert got.shape == want.shape
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(2 ** -126)))
                  - 7)
    excess = (got - want).abs() - (ulp + 2.0 ** -7 * bound)
    assert float(excess.max()) <= 0
    assert float((got - want).abs().max()) > 0  # the fold does round


def test_pooled_epilogue_is_maxpool_of_relu_bit_for_bit():
    """relu(max(window) + b) is maxpool(relu(y + b)) exactly, after the
    rounding to bf16 too, odd sizes and the padded edge included."""
    gen = torch.Generator().manual_seed(3)
    y = (torch.randn((2, 9, 7, 16), generator=gen) * 3).to(torch.bfloat16)
    b = torch.randn(16, generator=gen)
    want = F.max_pool2d(_nchw(torch.relu(y.float() + b).to(torch.bfloat16)),
                        3, 2, 1)
    got = ops.frozen_epilogue(y, b, pool=True)
    assert got.shape == (2, 5, 4, 16) == (2, ops.pooled_size(9),
                                          ops.pooled_size(7), 16)
    assert torch.equal(got, _nhwc(want))


def test_epilogue_rejects_bad_arguments():
    y = torch.zeros(2, 4, 4, 8, dtype=torch.bfloat16)
    b = torch.zeros(8)
    with pytest.raises(ValueError, match="b must be"):
        ops.frozen_epilogue(y, torch.zeros(4))
    with pytest.raises(ValueError, match="r must be"):
        ops.frozen_epilogue(y, b, y[:1], b)
    with pytest.raises(ValueError, match="no residual"):
        ops.frozen_epilogue(y, b, y, b, pool=True)
    with pytest.raises(ValueError, match="together"):
        ops.frozen_epilogue(y, b, y)


def _perturbed_variables(cfg: JaxModelConfig, seed: int):
    """JAX variables with every BN's affine and statistics away from 0/1
    (identity BN would hide a wrong fold)."""
    _, variables = jax_init(cfg, jax.random.PRNGKey(seed),
                            image_size=cfg.image_size)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'mean'" in name:
            return rng.normal(0, 0.2, leaf.shape).astype(np.float32)
        if "'var'" in name:
            return rng.uniform(0.3, 2.0, leaf.shape).astype(np.float32)
        if "bn" in name and "'scale'" in name:
            return rng.uniform(0.4, 1.6, leaf.shape).astype(np.float32)
        if "bn" in name and "'bias'" in name:
            return rng.normal(0, 0.2, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, variables)


class _EpilogueCalls(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the epilogue op's calls under it (its launch counter counts
    the card's alone)."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.name() == "irp_tpu_torch::frozen_epilogue":
            self.calls += 1
        return func(*args, **(kwargs or {}))


def _torch_model(cfg: JaxModelConfig, variables, mode: str):
    model = get_classifier(ModelConfig(**dataclasses.asdict(
        dataclasses.replace(cfg, fused_frozen_blocks=mode))), device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg.depth))
    return model.eval()


def _logits(model, x_nhwc):
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous(
        memory_format=CL)
    with torch.inference_mode():
        return model(x).float().numpy()


@pytest.fixture(scope="module")
def depth50():
    """ResNet50/64 bf16 variables, inputs and the JAX package's logits
    with its fused kernel on (Pallas interpret mode on the CPU)."""
    cfg = JaxModelConfig(depth=50, num_classes=4, image_size=64,
                         fused_frozen_blocks="on")
    variables = _perturbed_variables(cfg, 11)
    x = np.random.default_rng(11).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    fwd = jax.jit(lambda v, xx: jax_get(cfg).apply(v, xx, train=False))
    return cfg, variables, x, np.asarray(fwd(variables, jnp.asarray(x)))


def test_depth50_on_matches_off_and_jax_fused(depth50):
    cfg, variables, x, want = depth50
    on = _torch_model(cfg, variables, "on")
    with _EpilogueCalls() as counter:
        got = _logits(on, x)
    assert counter.calls == 10
    off = _logits(_torch_model(cfg, variables, "off"), x)
    np.testing.assert_allclose(got, off, rtol=0.05, atol=0.05)
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)


def _folds(model):
    return [m for m in model.modules()
            if isinstance(m, FoldCache) and m.foldable]


def _resnet(mode, **kwargs):
    model = ResNet(fused_frozen_blocks=mode, **kwargs)
    model.init_weights(torch.Generator().manual_seed(0))
    return model.to(memory_format=CL).eval()


@pytest.mark.parametrize("kwargs", [
    dict(depth=18), dict(depth=50, groups=2, width_per_group=32),
    dict(depth=50, bn_stats_mode="all"), dict(depth=50, frozen_prefix=0),
    dict(depth=50, dtype=torch.float32),
], ids=["depth18", "groups2", "bn_all", "prefix0", "f32"])
def test_ineligible_configs_fold_nothing(kwargs):
    """What K1's rule refuses takes no fold with 'on': no foldable module,
    nothing cached, no epilogue pass, and the forward of 'off'."""
    model = _resnet("on", **kwargs)
    assert _folds(model) == []
    model.cache_folded_weights()
    assert all(m._folded is None for m in model.modules()
               if isinstance(m, FoldCache))
    x = torch.randn((2, 3, 32, 32), generator=torch.Generator()
                    .manual_seed(1)).contiguous(memory_format=CL)
    off = _resnet("off", **kwargs)
    with torch.no_grad():
        with _EpilogueCalls() as counter:
            got = model(x)
        assert counter.calls == 0
        assert torch.equal(got, off(x))


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_auto_on_the_cpu_and_off_run_the_unfolded_forward(mode):
    """An eligible ResNet50: 'auto' folds on CUDA inputs alone and 'off'
    never; on a CPU tensor both run today's forward, bit for bit."""
    model = _resnet(mode, depth=50)
    assert len(_folds(model)) == 14  # the stem, 3 blocks 0, 10 K1 blocks
    model.cache_folded_weights()
    x = torch.randn((2, 3, 32, 32), generator=torch.Generator()
                    .manual_seed(2)).contiguous(memory_format=CL)
    ref = ResNet(depth=50, fused_frozen_blocks="off")
    ref.load_state_dict(model.state_dict())
    ref = ref.to(memory_format=CL).eval()
    with torch.no_grad():
        with _EpilogueCalls() as counter:
            got = model(x)
        assert counter.calls == 0
        assert torch.equal(got, ref(x))


def test_fold_cache_holds_the_stem_and_blocks_0_and_is_dropped():
    """The cache holds the stem's (w, b) and each block 0's four (w, b)
    pairs; a cached forward is bit-equal to a per-call fold; train(),
    load_state_dict and a device or dtype move drop the cache; the
    state_dict keeps its keys."""
    model = _resnet("on", depth=50)
    keys = list(model.state_dict())
    x = torch.randn((2, 3, 32, 32), generator=torch.Generator()
                    .manual_seed(3)).contiguous(memory_format=CL)
    with torch.no_grad():
        per_call = model(x)
    model.cache_folded_weights()
    assert list(model.state_dict()) == keys
    stem = model._folded
    assert stem[0].shape == model.conv1.weight.shape
    assert stem[0].dtype == torch.bfloat16 and stem[1].dtype == torch.float32
    assert stem[0].is_contiguous(memory_format=CL)
    for name in ("layer1", "layer2", "layer3"):
        block = getattr(model, name)[0]
        convs = (block.conv1, block.conv2, block.conv3, block.downsample[0])
        assert [tuple(t.shape) for t in block._folded] == [
            s for conv in convs for s in (tuple(conv.weight.shape),
                                          (conv.out_channels,))]
    with torch.no_grad():
        assert torch.equal(model(x), per_call)
    for drop in (lambda m: m.train(), lambda m: m.load_state_dict(
            m.state_dict()), lambda m: m.to(torch.float32)):
        model.eval().cache_folded_weights()
        drop(model)
        assert all(m._folded is None for m in _folds(model))


@pytest.mark.parametrize("mode,passes", [("on", 10), ("off", 0)])
def test_frozen_span_counts_epilogue_passes(mode, passes):
    """Each frozen forward calls the epilogue op once for the stem and
    three times in each of ResNet50's three blocks 0 with 'on', never
    with 'off'; ``train.forward.frozen`` counts the card's launches, 0
    here, as its ``k1_launches`` does."""
    model = _resnet(mode, depth=50).train()
    model.cache_folded_weights()
    x = torch.randn((2, 3, 32, 32), generator=torch.Generator()
                    .manual_seed(4)).contiguous(memory_format=CL)
    with monitor.tracing(device="cpu") as records, torch.no_grad():
        for _ in range(2):
            with _EpilogueCalls() as counter:
                model.forward_frozen(x)
            assert counter.calls == passes
    frozen = [r["counts"] for r in records
              if r["name"] == "train.forward.frozen"]
    assert frozen == [{"k1_launches": 0, "epilogue_launches": 0}] * 2
