"""Cells added from files alone run at a tiny size on the CPU, end to end
through the harness, and the program agrees with the plain reference
there (float32 on both sides)."""

import json

import numpy as np
import pytest
import torch

from benchmark import harness, synth
from benchmark.loops import common
from benchmark.reference import augment, models
from benchmark.tests import tiny

CELLS = ["tiny_resnet.train", "tiny_vit.train"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_tree(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_and_is_correct(root, cell, trace):
    result = tiny.run(root, cell, trace=trace)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    # a CPU run has no device trace: those metrics are left out, not 0
    cfg = harness.load_cell(cell, 1, 1.0, trace, "cpu", root)
    assert set(result["metrics"]) == {m["name"] for m in cfg.metrics
                                      if m["source"] != "device_trace"}
    assert list(result)[-1] == "checks"
    json.dumps(result)  # the printed line is plain JSON
    if trace:
        assert "breakdown" in result and "window_s" in result["device"]


def test_printed_line(root, capsys):
    result = tiny.run(root, "tiny_vit.train")
    harness.print_result(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks" and "notes" not in line
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("name", ["tiny_resnet", "tiny_vit"])
def test_program_forward_equals_reference(root, name):
    from irp_tpu_torch.infer import Predictor
    from irp_tpu_torch.models.classifier import Classifier

    cfg = harness._load_json(f"{root}/benchmark/configs/{name}.json")["model"]
    x = synth.images(12, 40, 5, "cpu")
    w = common.weights(cfg, 5, x, "cpu")
    program = Classifier(common.model_config(cfg))
    program.load_state_dict(w)
    got = Predictor(model=program, batch_size=8, device="cpu").predict_probs(x)
    crop = augment.eval_crop(torch.from_numpy(x), cfg["image_size"])
    with torch.no_grad():
        ref = torch.softmax(models.head(w, models.features(w, cfg, crop)),
                            dim=-1).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6)


def test_weights_cover_the_programs_state_dict(root):
    from irp_tpu_torch.models.classifier import Classifier

    for name in ("tiny_resnet", "tiny_vit"):
        cfg = harness._load_json(f"{root}/benchmark/configs/{name}.json")
        w = synth.weights(models.specs(cfg["model"]), 3, "cpu")
        program = Classifier(common.model_config(cfg["model"]))
        assert {k: tuple(v.shape) for k, v in w.items()} == {
            k: tuple(v.shape) for k, v in program.state_dict().items()}


def test_same_seed_same_inputs():
    a = synth.images(3, 40, 2**33 + 1, "cpu")
    assert np.array_equal(a, synth.images(3, 40, 2**33 + 1, "cpu"))
    assert not np.array_equal(a, synth.images(3, 40, 2**33 + 2, "cpu"))
    counts = [5, 3, 2]
    assert np.bincount(synth.labels(counts, 7)).tolist() == counts
