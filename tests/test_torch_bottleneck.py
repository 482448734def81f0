"""Port parity: fused identity bottleneck (irp_tpu_torch/ops/cuda_resnet.py)
against the JAX package's Pallas kernel (interpret mode on the CPU),
BatchNorm folding, and the fused_frozen_blocks='on' rejection rules.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irp_tpu.ops import pallas_resnet as jax_ops
from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.models.classifier import Classifier
from irp_tpu_torch.ops import cuda_resnet

torch.set_num_threads(1)


def _rand_block(rng, c, m, hw=8):
    """x, w1, b1, w2, b2, w3, b3 as float32 numpy (the JAX tests' mix)."""
    return (rng.normal(size=(2, hw, hw, c)).astype(np.float32),
            (rng.normal(size=(c, m)) * 0.1).astype(np.float32),
            rng.normal(size=(m,)).astype(np.float32),
            (rng.normal(size=(3, 3, m, m)) * 0.1).astype(np.float32),
            rng.normal(size=(m,)).astype(np.float32),
            (rng.normal(size=(m, c)) * 0.1).astype(np.float32),
            rng.normal(size=(c,)).astype(np.float32))


def _as_bf16(args):
    """Activations and weights to bf16, biases stay f32."""
    return [a.astype(jnp.bfloat16) if a.ndim >= 2 else a
            for a in map(jnp.asarray, args)], \
        [torch.from_numpy(a).to(torch.bfloat16) if a.ndim >= 2
         else torch.from_numpy(a) for a in args]


def test_plain_matches_pallas_kernel_f32():
    args = _rand_block(np.random.default_rng(0), 32, 8)
    want = jax_ops.fused_identity_bottleneck(*map(jnp.asarray, args),
                                             interpret=True)
    got = cuda_resnet.reference_identity_bottleneck(
        *map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_plain_matches_pallas_kernel_bf16():
    args = _rand_block(np.random.default_rng(1), 32, 8)
    jax_args, torch_args = _as_bf16(args)
    want = np.asarray(jax_ops.fused_identity_bottleneck(
        *jax_args, interpret=True).astype(jnp.float32))
    got = cuda_resnet.reference_identity_bottleneck(*torch_args)
    assert got.dtype == torch.bfloat16
    rel = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert rel <= 2.0 ** -7


def test_cpu_wrapper_runs_plain_version_without_launch():
    args = [torch.from_numpy(a) for a in
            _rand_block(np.random.default_rng(2), 32, 8)]
    before = cuda_resnet.fused_identity_bottleneck.launches
    got = cuda_resnet.fused_identity_bottleneck(*args)
    assert torch.equal(got, cuda_resnet.reference_identity_bottleneck(*args))
    assert cuda_resnet.fused_identity_bottleneck.launches == before


def test_wrapper_rejects_mismatched_shapes():
    x, w1, b1, w2, b2, w3, b3 = [torch.from_numpy(a) for a in
                                 _rand_block(np.random.default_rng(3), 32, 8)]
    with pytest.raises(ValueError, match="w3"):
        cuda_resnet.fused_identity_bottleneck(x, w1, b1, w2, b2, w3.T, b3)
    with pytest.raises(ValueError, match="b2"):
        cuda_resnet.fused_identity_bottleneck(x, w1, b1, w2, b3, w3, b3)


def _bn_params(rng, n):
    return (rng.uniform(0.5, 2.0, n).astype(np.float32),
            rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32),
            rng.uniform(0.5, 2.0, n).astype(np.float32))


def test_fold_bn_into_conv_matches_jax():
    rng = np.random.default_rng(4)
    kernel = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    bn = _bn_params(rng, 6)
    want_w, want_b = jax_ops.fold_bn_into_conv(jnp.asarray(kernel),
                                               *map(jnp.asarray, bn))
    got_w, got_b = cuda_resnet.fold_bn_into_conv(
        torch.from_numpy(kernel), *map(torch.from_numpy, bn))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                               rtol=1e-6, atol=1e-6)


def test_folded_conv_equals_conv_then_bn():
    rng = np.random.default_rng(5)
    kernel = torch.from_numpy(rng.normal(size=(3, 3, 4, 6)).astype(
        np.float32))
    scale, bias, mean, var = map(torch.from_numpy, _bn_params(rng, 6))
    x = torch.from_numpy(rng.normal(size=(2, 4, 5, 5)).astype(np.float32))
    conv = torch.nn.functional.conv2d(x, kernel.permute(3, 2, 0, 1),
                                      padding=1)
    bshape = (1, -1, 1, 1)
    want = ((conv - mean.view(bshape)) / torch.sqrt(var.view(bshape) + 1e-5)
            * scale.view(bshape) + bias.view(bshape))
    wf, bf = cuda_resnet.fold_bn_into_conv(kernel, scale, bias, mean, var)
    got = torch.nn.functional.conv2d(x, wf.permute(3, 2, 0, 1), padding=1) \
        + bf.view(bshape)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("kwargs,match", [
    (dict(depth=50, compute_dtype="float32"), "compute_dtype"),
    (dict(depth=18), "bottleneck"),
    (dict(depth=50, groups=32, width_per_group=4), "variants"),
    (dict(depth=50, bn_stats_mode="all"), "bn_stats_mode"),
    (dict(depth=50, precision="highest"), "precision"),
])
def test_fused_on_rejects_ineligible_config(kwargs, match):
    """'on' means forced: configs the kernel cannot serve raise, as in the
    JAX package, instead of running unfused."""
    cfg = ModelConfig(num_classes=3, image_size=64,
                      fused_frozen_blocks="on", **kwargs)
    with pytest.raises(ValueError, match=match):
        Classifier(cfg)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(6)
    # a partial last band (14 = 3 * 4 + 2), fewer pixels than a tile (3x3)
    for hw, c, m in ((8, 64, 64), (14, 256, 64), (4, 128, 128), (3, 64, 128),
                     (7, 1024, 256)):
        args = _rand_block(rng, c, m, hw)
        _, torch_args = _as_bf16(args)
        torch_args = [t.cuda() for t in torch_args]
        got = cuda_resnet.fused_identity_bottleneck(*torch_args)
        want = cuda_resnet.reference_identity_bottleneck(*torch_args)
        rel = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        assert rel <= 2.0 ** -6, (hw, c, m, rel)


def _bf16_map(seed, shape=(2, 7, 5, 24)):
    """A bf16 NHWC map with +-inf and a NaN among normal values."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x.reshape(-1)[:3] = (np.inf, -np.inf, np.nan)
    return torch.from_numpy(x).to(torch.bfloat16)


def test_relu_copy_plain_is_relu():
    """The copy floor's plain version: max(x, 0) elementwise, NaN kept
    (tools/bench_fused_block.py::copy_floor computes jnp.maximum(x, 0))."""
    x = _bf16_map(0)
    got = cuda_resnet.relu_copy(x)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    want = np.maximum(x.float().numpy(), 0)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_relu_copy_cpu_runs_plain_version_without_launch():
    x = _bf16_map(1)
    before = cuda_resnet.relu_copy.launches
    assert torch.equal(cuda_resnet.relu_copy(x).view(torch.int16),
                       cuda_resnet.relu_copy_plain(x).view(torch.int16))
    assert cuda_resnet.relu_copy.launches == before


@pytest.mark.gpu
def test_relu_copy_kernel_bit_exact_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    # 8-element vectors plus a scalar tail (numel % 8 == 3), and a large
    # map that takes several grid-stride rounds
    for shape in ((3, 7, 5, 3), (32, 56, 56, 256)):
        x = _bf16_map(2, shape).cuda()
        before = cuda_resnet.relu_copy.launches
        got = cuda_resnet.relu_copy(x)
        assert cuda_resnet.relu_copy.launches == before + 1
        assert torch.equal(got.view(torch.int16),
                           cuda_resnet.relu_copy_plain(x).view(torch.int16))
