"""Card-only gates of the port's kernels K1-K4: each wrapper against its
plain version on the card, at the shapes and batches of its paths and at
the edges of its tiling.  The module imports neither JAX nor the JAX
package, so it runs on a machine with the card alone (the suite's
conftest configures JAX, hence ``--noconftest`` there):
``python -m pytest -m gpu --noconftest tests/test_torch_kernels_card.py``.
Without a CUDA device each kernel test skips.  The paths' shapes and the
bars come from ``chip_smoke.py``, whose kernels phase holds the same
kernels at those shapes.  One test, run on the CPU too, holds the card's
test modules to importing no JAX.
"""

import ast
import os

import numpy as np
import pytest
import torch

from chip_smoke import (BOTTLENECK_SHAPES, K1_TOL, K3_AGREEMENT, K3_SHAPES,
                        K3_TOL)
from irp_tpu_torch.ops import cuda_image, cuda_resnet

# the modules of the card's gpu run (README); what they import beyond
# these files (chip_smoke, irp_tpu_torch) tests/test_torch_isolation.py
# holds to the same rule
CARD_MODULES = ("test_torch_kernels_card.py", "test_torch_train_card.py",
                "test_torch_bn_train.py", "test_torch_train_remat.py")


@pytest.mark.parametrize("name", CARD_MODULES)
def test_card_module_imports_no_jax(name):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), name)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    imported = [a.name for node in ast.walk(tree)
                if isinstance(node, ast.Import) for a in node.names] + [
        node.module or "" for node in ast.walk(tree)
        if isinstance(node, ast.ImportFrom)]
    assert not [m for m in imported if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "irp_tpu")], name


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.gpu
def test_bottleneck_kernel_matches_plain_on_card():
    """K1 within K1_TOL of its plain version (max|kernel - plain| over
    max|plain|), activations and weights bf16, biases f32."""
    _needs_card()
    rng = np.random.default_rng(6)
    # the whole image in one unit (8x8, 4x4, 3x3: fewer pixels than a tile,
    # 7x7), ragged last bands (13 = 8 + 5, 17 = 6 + 6 + 5), M=512, a band
    # the kernel narrows to fit shared memory (24x24 at M=512: 4 -> 2),
    # and ResNet50's three shapes at B=1 and B=3, the sweep's B=8 and 16
    # and the train and serve paths' B=32
    cases = [(2, 8, 64, 64), (2, 14, 256, 64), (2, 4, 128, 128),
             (2, 3, 64, 128), (2, 7, 1024, 256), (2, 13, 1024, 256),
             (3, 17, 512, 128), (2, 7, 2048, 512), (1, 24, 2048, 512)]
    cases += [(b, hw, c, m) for b in (1, 3, 8, 16, 32)
              for _, hw, _, c, m, _ in BOTTLENECK_SHAPES]
    for b, hw, c, m in cases:
        x, w1, b1, w2, b2, w3, b3 = (
            rng.normal(size=(b, hw, hw, c)), rng.normal(size=(c, m)) * 0.1,
            rng.normal(size=(m,)), rng.normal(size=(3, 3, m, m)) * 0.1,
            rng.normal(size=(m,)), rng.normal(size=(m, c)) * 0.1,
            rng.normal(size=(c,)))
        args = [torch.from_numpy(a.astype(np.float32)).cuda()
                for a in (x, w1, b1, w2, b2, w3, b3)]
        args = [a.to(torch.bfloat16) if a.ndim >= 2 else a for a in args]
        got = cuda_resnet.fused_identity_bottleneck(*args).float()
        want = cuda_resnet.reference_identity_bottleneck(*args).float()
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= K1_TOL, (b, hw, c, m, rel)


@pytest.mark.gpu
def test_relu_copy_kernel_bit_exact_on_card():
    """K4 bit for bit against max(x, 0) on maps holding +-inf and a NaN,
    one launch a call."""
    _needs_card()
    # 8-element vectors plus a scalar tail (numel % 8 == 3), a tail
    # (numel % 8 == 5) behind more blocks than one wave, and the
    # bottleneck's three ResNet50 shapes at B=32
    shapes = [(3, 7, 5, 3), (31, 57, 55, 93)] + [
        (32, h, w, c) for _, h, w, c, _, _ in BOTTLENECK_SHAPES]
    for shape in shapes:
        x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
        x.reshape(-1)[:3] = (np.inf, -np.inf, np.nan)
        x = torch.from_numpy(x).to(torch.bfloat16).cuda()
        before = cuda_resnet.relu_copy.launches
        got = cuda_resnet.relu_copy(x)
        assert cuda_resnet.relu_copy.launches == before + 1
        assert torch.equal(got.view(torch.int16),
                           cuda_resnet.relu_copy_plain(x).view(torch.int16))


@pytest.mark.gpu
def test_preprocess_kernel_matches_plain_on_card():
    """K2 0 bf16 ulp from its plain version (equal values), in bf16 and
    f32, at the cache geometry (16-byte loads and stores) and where the
    kernel reads one byte at a time: a 250-wide source, a non-square one
    with an odd crop offset, and a 7-pixel output row.  The cache
    geometry at the paths' batches: the sweep's 8 and 16, the train and
    final runs' 32, serving's 64 and predict_cli's 256, and a ragged 3."""
    _needs_card()
    for (b, h, w), out in (((8, 256, 256), 224), ((2, 250, 250), 224),
                           ((3, 70, 90), 64), ((3, 71, 93), 64),
                           ((2, 20, 20), 7), ((3, 256, 256), 224),
                           ((16, 256, 256), 224), ((32, 256, 256), 224),
                           ((64, 256, 256), 224), ((256, 256, 256), 224)):
        x = torch.from_numpy(np.random.default_rng(4).integers(
            0, 256, (b, h, w, 3), np.uint8)).cuda()
        for dtype in (torch.bfloat16, torch.float32):
            got = cuda_image.eval_preprocess(x, out, dtype=dtype)
            want = cuda_image.eval_preprocess_plain(x, out, dtype=dtype)
            assert got.dtype == dtype
            assert torch.equal(got, want), (b, h, w, out, dtype)


def _points(seed, n, d, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).normal(
        size=(n, d)) * scale).astype(np.float32)).cuda()


def _grid(n, d):
    """n points of an integer grid in d dimensions: exact f32 distances."""
    side = int(np.ceil(n ** (1.0 / d)))
    pts = np.stack(np.meshgrid(*[np.arange(side)] * d, indexing="ij"), -1)
    return torch.from_numpy(pts.reshape(-1, d)[:n].astype(np.float32)).cuda()


def _agree(got, want, a, b):
    """Share of equal indices, and the largest squared-distance gap over
    max(|a_i|^2 + |b_j|^2)."""
    scale = float((a * a).sum(1).max() + (b * b).sum(1).max())
    return (float((got[1] == want[1]).float().mean()),
            float((got[0] - want[0]).abs().max()) / max(scale, 1e-30))


@pytest.mark.gpu
def test_pairwise_topk_kernel_matches_plain_on_card():
    """K3 against its plain version (cuBLAS f32, no TF32) at the kNN's
    shapes and the edges of its tiling: k = 1 and 128, M not a multiple
    of the row tile, N below one column tile, splits shorter than k,
    self_offset -1 and > 0.  At least K3_AGREEMENT equal indices and
    squared distances within K3_TOL * max(|a_i|^2 + |b_j|^2); on an
    integer grid (exact distances) the indices are equal; among exact
    duplicates the lower index comes first; k = 129 raises."""
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    topk, plain = cuda_image.pairwise_topk, cuda_image.pairwise_topk_plain
    # (m, n, d, k, self_offset); a is b[off:off + m] where that fits,
    # else points of its own; the kNN's shapes (K3_SHAPES) at offset 0
    cases = [(1024, 26_179, 2, 75, 1024), (570, 2618, 2, 30, 2048),
             (200, 300, 50, 1, -1), (129, 50, 3, 20, -1),
             (129, 150, 3, 20, 60), (65, 2618, 2, 128, 0),
             (33, 5000, 64, 128, -1), (300, 1000, 128, 32, 100),
             (1000, 26_179, 50, 15, 25_179)]
    cases += [(m, n, d, k, 0) for _, m, n, d, k in K3_SHAPES]
    for m, n, d, k, off in cases:
        b = _points(n + d, n, d, 3.0)
        a = (b[off:off + m].contiguous() if 0 <= off <= n - m
             else _points(m + d, m, d, 3.0))
        before = topk.launches
        got = topk(a, b, k, self_offset=off)
        want = plain(a, b, k, self_offset=off)
        assert topk.launches == before + 1
        share, gap = _agree(got, want, a, b)
        assert share >= K3_AGREEMENT and gap <= K3_TOL, (m, n, d, k, off)
    for m, n, d, k in ((200, 1000, 2, 15), (100, 700, 3, 75)):
        g = _grid(n, d)
        got = topk(g[:m].contiguous(), g, k, self_offset=0)
        want = plain(g[:m].contiguous(), g, k, self_offset=0)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    base = _points(9, 2000, 52)
    dup = torch.cat([base, base[:300], base[:150]])
    got = topk(dup, dup, 8, self_offset=0)
    share, gap = _agree(got, plain(dup, dup, 8, self_offset=0), dup, dup)
    assert share >= K3_AGREEMENT and gap <= K3_TOL
    tie = got[0][:, 1:] == got[0][:, :-1]
    assert int(tie.sum()) > 0
    assert bool((got[1][:, 1:][tie] > got[1][:, :-1][tie]).all())
    with pytest.raises(ValueError, match="128"):
        topk(a, b, 129)
