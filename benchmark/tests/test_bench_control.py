"""The control, the reference one precision below the configuration's
(float8 operands), reads past the limits: at a tiny size on the CPU
against the tiny cells' limits, and on a card at the cells' own size
against their own (marked ``gpu``; it decides inside the test whether
there is a card)."""

import os

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny
from benchmark.tools import control

ROOT = os.path.dirname(harness.BENCH_DIR)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_tree(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("name", ["tiny_resnet.train", "tiny_vit.train"])
def test_control_fails_at_a_tiny_size(root, name):
    cell = harness.load_cell(name, 11, 1.0, False, "cpu", root)
    for r in control.train_readings(cell):
        assert not harness.judge(cell, r["checks"]), r


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [3100000004, 3100000005, 3100000006])
@pytest.mark.parametrize("name", ["resnet50.train.b256",
                                  "vit_b16.train.b256"])
def test_control_fails_at_the_cells_size(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.load_cell(name, seed, 1.0, False, "cuda", ROOT)
    reading = control.train_readings(cell)[0]
    assert not harness.judge(cell, reading["checks"]), reading
