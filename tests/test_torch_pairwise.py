"""Port parity: the distance formula of the fused distance + top-k kernel
(irp_tpu_torch/ops/cuda_image.py::pairwise_dist_plain) against the JAX
package's Pallas kernel in interpret mode; the kernel's wrapper
(pairwise_topk, its plain version on the CPU); and the port's kNN over it
(irp_tpu_torch/data/outliers.py::knn) against the JAX package's knn,
ties included.

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
    got = cuda_image.pairwise_dist_plain(
        torch.from_numpy(a), None if b is None else torch.from_numpy(b))
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
    want_d, want_i = cuda_image.pairwise_topk(ta, tb, 7)
    got_d, got_i = cuda_image.pairwise_topk(ta, tb, 7, a_sq, b_sq)
    assert torch.equal(got_d, want_d) and torch.equal(got_i, want_i)
    # a shift of every |a_i|^2 moves every distance and no order
    shifted_d, shifted_i = cuda_image.pairwise_topk(ta, tb, 7, a_sq + 1.0,
                                                    b_sq)
    assert torch.equal(shifted_i, want_i)
    assert torch.allclose(shifted_d, want_d + 1.0, atol=1e-5)


def test_cpu_tensor_runs_plain_version_without_launch():
    a = torch.from_numpy(_points(3, 10, 4))
    before = cuda_image.pairwise_topk.launches
    got = cuda_image.pairwise_topk(a, None, 3, self_offset=0)
    want = cuda_image.pairwise_topk_plain(a, None, 3, self_offset=0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert cuda_image.pairwise_topk.launches == before


@pytest.mark.parametrize("a,b,k,match", [
    (torch.zeros(4, 3, dtype=torch.float64), None, 2, "float32"),
    (torch.zeros(4), None, 2, "2-D"),
    (torch.zeros(4, 3), torch.zeros(5, 2), 2, "widths differ"),
    (torch.zeros(4, 3), None, 0, "k must be"),
])
def test_rejects_malformed_input(a, b, k, match):
    with pytest.raises(ValueError, match=match):
        cuda_image.pairwise_topk(a, b, k)


def test_self_offset_excludes_exactly_one_column_a_row():
    """Rows 10..29 of x against all 40 points with self_offset=10: row i
    keeps every column but i + 10; with no offset it keeps its own."""
    x = torch.from_numpy(_points(8, 40, 3))
    d, idx = cuda_image.pairwise_topk(x[10:30], x, 39, self_offset=10)
    for i in range(20):
        assert sorted(idx[i].tolist()) == [j for j in range(40)
                                           if j != i + 10]
    assert (d[:, 1:] >= d[:, :-1]).all()
    # no offset: a row's nearest point is itself, at the f32 residue of
    # |a|^2 + |a|^2 - 2 a.a
    d, idx = cuda_image.pairwise_topk(x[10:30], x, 1)
    assert idx[:, 0].tolist() == list(range(10, 30))
    assert float(d.max()) <= 1e-5 * _scale(x.numpy(), x.numpy())


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


def test_knn_integer_grid_equals_jax_index_for_index():
    """The first 200 points of a 20 x 20 integer grid: every distance is
    exact in f32 and most of them tie, so a top-k that orders ties in any
    other way than lower index first picks other neighbours."""
    grid = np.stack(np.meshgrid(np.arange(20), np.arange(20), indexing="ij"),
                    -1).reshape(-1, 2).astype(np.float32)[:200]
    i_want, d_want = jax_outliers.knn(grid, 15, block=64)
    i_got, d_got = outliers.knn(grid, 15, block=64, device="cpu")
    np.testing.assert_array_equal(d_got, d_want)
    np.testing.assert_array_equal(i_got, i_want)


def test_knn_ties_at_zero_agree_tie_aware():
    """Duplicated points: each of the 10 duplicates ties its twin at
    distance 0, and every other row sees the twins at equal distances.
    Among neighbours whose reported distances are equal, the lower index
    comes first; where JAX's distances tie exactly too, the indices are
    JAX's.  The two f32 formulas differ in one place: JAX selects before
    it clamps, so a duplicate's residue |a|^2 + |b|^2 - 2 a.b may be
    negative and sort ahead of exact zeros, while the port clamps at 0
    first (as the kernel does).  Here each point has at most one
    duplicate, so the two orders agree."""
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
    tie = d_got[:, 1:] == d_got[:, :-1]
    assert tie.any()
    assert (i_got[:, 1:][tie] > i_got[:, :-1][tie]).all()
    jax_tie = d_want[:, 1:] == d_want[:, :-1]
    assert jax_tie.any()
    np.testing.assert_array_equal(i_got[:, 1:][jax_tie],
                                  i_want[:, 1:][jax_tie])
    np.testing.assert_array_equal(i_got[:, :-1][jax_tie],
                                  i_want[:, :-1][jax_tie])


def test_knn_hands_contiguous_row_blocks_to_the_kernel(monkeypatch):
    """A column-major input (the spectral init's column slice is one)
    still reaches the kernel as contiguous row blocks, which it needs."""
    seen = []

    def checked(a, b, k, a_sq, b_sq, self_offset):
        seen.append(a.is_contiguous() and b.is_contiguous())
        return cuda_image.pairwise_topk_plain(a, b, k, a_sq, b_sq,
                                              self_offset)

    x = np.asfortranarray(_points(7, 50, 2))
    i_want, _ = outliers.knn(np.ascontiguousarray(x), 4, block=16,
                             device="cpu")
    monkeypatch.setattr(outliers, "pairwise_topk", checked)
    i_got, _ = outliers.knn(x, 4, block=16, device="cpu")
    assert seen == [True] * 4
    np.testing.assert_array_equal(i_got, i_want)
