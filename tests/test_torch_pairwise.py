"""Port parity: the pairwise-distance kernel's wrapper
(irp_tpu_torch/ops/cuda_image.py::pairwise_dist, its plain version on the
CPU) against the JAX package's Pallas kernel in interpret mode, and the
port's kNN over it (irp_tpu_torch/data/outliers.py::knn) against the JAX
package's knn.

Inputs are numpy arrays made from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irp_tpu.data import outliers as jax_outliers
from irp_tpu.ops.pallas_image import pallas_pairwise_dist
from irp_tpu_torch.data import outliers
from irp_tpu_torch.ops import cuda_image

torch.set_num_threads(1)


def _points(seed, n, d, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, d)) * scale
            ).astype(np.float32)


def _scale(a, b):
    """max(|a_i|^2 + |b_j|^2): the size of the terms the f32 sum cancels."""
    return float((a * a).sum(1).max() + (b * b).sum(1).max())


@pytest.mark.parametrize("m,n,d,block_m", [
    (200, None, 32, 64),   # square (b = a), M not a multiple of the block
    (100, 50, 16, 64),     # rectangular
    (37, 300, 50, 16),     # the PCA-50 width, ragged M
    (64, 129, 2, 64),      # the LOF width
])
def test_plain_version_matches_pallas_kernel(m, n, d, block_m):
    a = _points(m * 7 + d, m, d, scale=3.0)
    b = None if n is None else _points(n * 11 + d, n, d, scale=3.0)
    want = np.asarray(pallas_pairwise_dist(
        jnp.asarray(a), None if b is None else jnp.asarray(b),
        block_m=block_m, interpret=True))
    got = cuda_image.pairwise_dist(torch.from_numpy(a),
                                   None if b is None else torch.from_numpy(b))
    assert got.shape == want.shape == (m, m if n is None else n)
    assert got.dtype == torch.float32
    # the same f32 formula with different summation orders: a few ulps of
    # the largest term, 1e-5 relative to it
    tol = 1e-5 * _scale(a, a if b is None else b)
    assert np.abs(got.numpy() - want).max() <= tol
    assert (got.numpy() >= 0).all()


def test_norms_passed_in_are_used():
    a, b = _points(1, 20, 5), _points(2, 30, 5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    a_sq, b_sq = (ta * ta).sum(1), (tb * tb).sum(1)
    want = cuda_image.pairwise_dist(ta, tb)
    got = cuda_image.pairwise_dist(ta, tb, a_sq, b_sq)
    assert torch.equal(got, want)
    shifted = cuda_image.pairwise_dist(ta, tb, a_sq + 1.0, b_sq)
    assert torch.allclose(shifted, want + 1.0, atol=1e-5)


def test_cpu_tensor_runs_plain_version_without_launch():
    a = torch.from_numpy(_points(3, 10, 4))
    before = cuda_image.pairwise_dist.launches
    assert torch.equal(cuda_image.pairwise_dist(a),
                       cuda_image.pairwise_dist_plain(a))
    assert cuda_image.pairwise_dist.launches == before


@pytest.mark.parametrize("a,b,match", [
    (torch.zeros(4, 3, dtype=torch.float64), None, "float32"),
    (torch.zeros(4), None, "2-D"),
    (torch.zeros(4, 3), torch.zeros(5, 2), "widths differ"),
])
def test_rejects_malformed_input(a, b, match):
    with pytest.raises(ValueError, match=match):
        cuda_image.pairwise_dist(a, b)


@pytest.mark.parametrize("n,d,k,block", [
    (130, 5, 4, 64),     # ragged last block (64 + 64 + 2)
    (300, 50, 15, 128),  # the UMAP width and k
    (200, 2, 30, 64),    # the LOF width and per-class k, ragged last block
    (7, 3, 10, 4),       # k > n - 1: capped at n - 1
])
def test_knn_matches_jax(n, d, k, block):
    x = _points(n + d, n, d)
    i_want, d_want = jax_outliers.knn(x, k, block=block)
    i_got, d_got = outliers.knn(x, k, block=block, device="cpu")
    assert i_got.shape == i_want.shape == (n, min(k, n - 1))
    assert i_got.dtype == np.int32 and d_got.dtype == np.float32
    np.testing.assert_array_equal(i_got, i_want)
    np.testing.assert_allclose(d_got, d_want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [0, 1])
def test_knn_fewer_than_two_points(n):
    x = _points(4, n, 3)
    i_want, d_want = jax_outliers.knn(x, 5)
    i_got, d_got = outliers.knn(x, 5, device="cpu")
    assert i_got.shape == i_want.shape == (n, 0)
    assert d_got.shape == d_want.shape == (n, 0)
    assert i_got.dtype == np.int32 and d_got.dtype == np.float32


def test_knn_ties_at_zero_agree_tie_aware():
    """Duplicated points tie at distance 0 (the kernel clamps at 0 before
    the top-k), and a tie may fill the last slot with either point: the
    sorted distances match JAX, and each returned index is a point at its
    reported distance (no self)."""
    base = _points(5, 40, 3)
    x = np.concatenate([base, base[:10]])  # 10 exact duplicates
    i_want, d_want = jax_outliers.knn(x, 6)
    i_got, d_got = outliers.knn(x, 6, device="cpu")
    np.testing.assert_allclose(d_got, d_want, rtol=1e-5, atol=1e-5)
    true_sq = ((x[:, None, :].astype(np.float64)
                - x[i_got].astype(np.float64)) ** 2).sum(-1)
    # squared distances carry the f32 cancellation error of |a|^2 + |b|^2
    assert np.abs(d_got.astype(np.float64) ** 2 - true_sq).max() \
        <= 1e-5 * _scale(x, x)
    assert not (i_got == np.arange(len(x))[:, None]).any()


def test_knn_hands_contiguous_row_blocks_to_the_kernel(monkeypatch):
    """A column-major input (the spectral init's column slice is one)
    still reaches the kernel as contiguous row blocks, which it needs."""
    seen = []

    def checked(a, b, a_sq, b_sq):
        seen.append(a.is_contiguous() and b.is_contiguous())
        return cuda_image.pairwise_dist_plain(a, b, a_sq, b_sq)

    x = np.asfortranarray(_points(7, 50, 2))
    i_want, _ = outliers.knn(np.ascontiguousarray(x), 4, block=16,
                             device="cpu")
    monkeypatch.setattr(outliers, "pairwise_dist", checked)
    i_got, _ = outliers.knn(x, 4, block=16, device="cpu")
    assert seen == [True] * 4
    np.testing.assert_array_equal(i_got, i_want)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for m, n, d in ((1024, 26_179, 50), (1024, 26_179, 2), (5, 7, 70),
                    (129, 130, 33)):
        a = torch.from_numpy(_points(m, m, d, 3.0)).cuda()
        b = torch.from_numpy(_points(n, n, d, 3.0)).cuda()
        before = cuda_image.pairwise_dist.launches
        got = cuda_image.pairwise_dist(a, b)
        want = cuda_image.pairwise_dist_plain(a, b)
        assert cuda_image.pairwise_dist.launches == before + 1
        scale = float((a * a).sum(1).max() + (b * b).sum(1).max())
        assert float((got - want).abs().max()) <= 1e-5 * scale
