"""Operation and byte counts against hand counts, and K1's bound against
the program's own benchmark tool at its three layer shapes."""

import json
import os

import pytest

from benchmark import harness
from benchmark.roofline import counts

ROOT = os.path.dirname(harness.BENCH_DIR)


def _model(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)["model"]


def test_resnet50_layer_and_total():
    cfg = _model("resnet50")
    prods = counts.products(cfg)
    # layer1.0: conv1 1x1 64->64 at 56x56, conv2 3x3 64->64, conv3 1x1
    # 64->256, downsample 1x1 64->256
    layer1 = [f for stage, f, _ in prods if stage == "layer1"][:4]
    assert layer1 == [2 * 56 * 56 * 64 * 64, 2 * 56 * 56 * 64 * 64 * 9,
                      2 * 56 * 56 * 256 * 64, 2 * 56 * 56 * 256 * 64]
    # torchvision's published 4.09 GMAC, plus the head
    head = 2 * 2048 * 512 + 2 * 512 * 10
    assert counts.forward_flops(cfg) - head == pytest.approx(8.18e9,
                                                             rel=0.005)


def test_resnet50_training_step():
    cfg = _model("resnet50")
    prods = counts.products(cfg)
    frozen = sum(f for s, f, _ in prods if s not in ("layer4", "head"))
    l4 = [(f, g) for s, f, g in prods if s == "layer4"]
    head = sum(f for s, f, _ in prods if s == "head")
    # layer4.0's conv1 and downsample read layer3's output, which carries
    # no gradient: forward and weight gradient only
    assert sum(not g for _, g in l4) == 2
    want = frozen + sum(f * (3 if g else 2) for f, g in l4) + 3 * head
    assert counts.train_flops(cfg) == want


def test_vit_b16_block_and_total():
    cfg = _model("vit_b16")
    s, e, m = 197, 768, 3072
    block = (2 * s * e * 3 * e + 2 * s * s * e + 2 * s * s * e
             + 2 * s * e * e + 2 * s * e * m + 2 * s * m * e)
    prods = counts.products(cfg)
    assert [f for st, f, _ in prods if st == "block0"] == [block]
    assert prods[0] == ("embed", 2 * 196 * e * 3 * 16 * 16, True)
    head = 2 * 768 * 512 + 2 * 512 * 10
    # torchvision's published 17.56 GMAC
    assert counts.forward_flops(cfg) - head == pytest.approx(35.13e9,
                                                             rel=0.005)
    assert counts.train_flops(cfg) == counts.forward_flops(cfg) + 2 * (
        block + head)


def test_k1_bound_matches_the_programs_tool():
    from irp_tpu_torch.tools import bench_fused_block as tool

    for b, h, w, c, m, _ in tool.SHAPES:
        assert counts.k1_bound_ms(b, h, w, c, m) == pytest.approx(
            tool.k1_bound(b, h, w, c, m)[0], rel=1e-12)


def test_k1_blocks_of_resnet50():
    blocks = counts.k1_blocks(_model("resnet50"), 256)
    assert blocks == ([(256, 56, 56, 256, 64)] * 2
                      + [(256, 28, 28, 512, 128)] * 3
                      + [(256, 14, 14, 1024, 256)] * 5)
    assert counts.k1_blocks(_model("vit_b16"), 256) == []
