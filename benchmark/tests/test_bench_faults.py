"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, every other part of a run driven at a
tiny size on the CPU, once for each fault a cell can have.  (One chip:
no exchange between chips to leave out.)"""

import pytest
import torch

from benchmark.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_tree(str(tmp_path_factory.mktemp("bench")))


def _state_unchanged(monkeypatch):
    from irp_tpu_torch.train import state

    def step(self):
        self.count += 1  # the count moves, the parameters do not

    monkeypatch.setattr(state.Optimizer, "step", step)


def _half_batch(monkeypatch):
    from irp_tpu_torch.train import step

    real = step.train_step

    def half(state, images, labels, cfg, *args, **kwargs):
        h = images.shape[0] // 2
        return real(state, images[:h], labels[:h], cfg, *args, **kwargs)

    monkeypatch.setattr(step, "train_step", half)


def _leaf_moved_double(monkeypatch):
    from irp_tpu_torch.train import state

    real = state.Optimizer.step

    def step(self):
        name = sorted(self.params)[-1]
        before = self.params[name].detach().clone()
        real(self)
        with torch.no_grad():
            p = self.params[name]
            p += p - before

    monkeypatch.setattr(state.Optimizer, "step", step)


TRAIN = [_state_unchanged, _half_batch, _leaf_moved_double]


@pytest.mark.parametrize("cell", ["tiny_resnet.train", "tiny_vit.train"])
@pytest.mark.parametrize("fault", TRAIN, ids=lambda f: f.__name__[1:])
def test_training_fault_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    result = tiny.run(root, cell, seconds=0.5)
    assert not result["correct"], result["checks"]
