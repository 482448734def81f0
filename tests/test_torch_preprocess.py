"""Port parity: eval crop + normalize (irp_tpu_torch/ops/cuda_image.py,
ops/preprocess.py) against the JAX package's eval_preprocess_batch and
its Pallas kernel (interpret mode on the CPU).

Inputs are numpy arrays made from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irp_tpu.ops.pallas_image import _norm_rows as jax_norm_rows
from irp_tpu.ops.pallas_image import pallas_eval_preprocess
from irp_tpu.ops.preprocess import eval_preprocess_batch as jax_eval_batch
from irp_tpu_torch.ops import cuda_image
from irp_tpu_torch.ops.preprocess import eval_preprocess_batch

torch.set_num_threads(1)

CASES = [(256, 224), (80, 64)]


def _images(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _bf16_ulps(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| in units of bf16's last place at |want|."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(want), 2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return float(np.max(np.abs(got - want) / ulp))


@pytest.mark.parametrize("s,out", CASES)
def test_f32_matches_jax_eval_batch(s, out):
    x = _images(0, (2, s, s, 3))
    want = np.asarray(jax_eval_batch(jnp.asarray(x), out, jnp.float32))
    got = eval_preprocess_batch(torch.from_numpy(x), out, torch.float32)
    assert got.shape == (2, out, out, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("s,out", CASES)
def test_bf16_matches_pallas_kernel(s, out):
    x = _images(1, (2, s, s, 3))
    want = pallas_eval_preprocess(jnp.asarray(x), out, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = eval_preprocess_batch(torch.from_numpy(x), out)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got.float().numpy(), want) <= 1.0


def test_non_square_source_crop_offsets():
    """(H, W) offsets are taken per axis, as the JAX center_crop does."""
    x = _images(2, (3, 70, 90, 3))
    want = np.asarray(jax_eval_batch(jnp.asarray(x), 64, jnp.float32))
    got = eval_preprocess_batch(torch.from_numpy(x), 64, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_norm_rows_match_jax():
    for width in (1, 5, 224):
        want = [np.asarray(r) for r in jax_norm_rows(
            width, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225))]
        got = cuda_image._norm_rows(width, (0.485, 0.456, 0.406),
                                    (0.229, 0.224, 0.225))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_cpu_tensor_runs_plain_version_without_launch():
    x = torch.from_numpy(_images(3, (2, 80, 80, 3)))
    before = cuda_image.eval_preprocess.launches
    got = cuda_image.eval_preprocess(x, 64)
    want = cuda_image.eval_preprocess_plain(x, 64)
    assert torch.equal(got, want)
    assert cuda_image.eval_preprocess.launches == before


@pytest.mark.parametrize("bad,match", [
    (np.zeros((2, 80, 80, 3), np.float32), "uint8"),
    (np.zeros((2, 80, 80), np.uint8), "uint8"),
    (np.zeros((2, 60, 80, 3), np.uint8), "smaller"),
])
def test_rejects_malformed_input(bad, match):
    with pytest.raises(ValueError, match=match):
        eval_preprocess_batch(torch.from_numpy(bad), 64)
