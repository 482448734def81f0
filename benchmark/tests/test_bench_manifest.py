"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix, limit file and metric resolved by name."""

import json
import os
import re

import pytest

from benchmark import harness
from benchmark.reference import families

ROOT = os.path.dirname(harness.BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_shape_and_names(manifest):
    assert set(manifest) == KEYS
    assert manifest["paths"] == ["benchmark"]
    assert manifest["command"][1] == "benchmark/run.py"
    assert 1 <= manifest["run_seconds"] <= 51
    names = []
    for section, keys in (
            ("configs", {"name", "source", "file", "reduced", "why"}),
            ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for entry in manifest[section]:
            assert set(entry) == keys, entry
            assert NAME.match(entry["name"]) and _line(entry["why"])
            names.append(entry["name"])
    for section in ("end_to_end", "per_layer"):
        for m in manifest[section]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert len(names) == len(set(names))


def test_budget_fits_the_full_check(manifest):
    runs = 2 + 14 * 24
    total = runs * (manifest["run_seconds"] + 60) + 24 * 180 + 1200
    assert total <= 43200


def test_bounds(manifest):
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in manifest["end_to_end"])


def test_every_cell_resolves(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    for w in manifest["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in configs
        for trace in (False, True):
            cell = harness.load_cell(w["name"], 1, 1.0, trace, "cpu", ROOT)
            assert cell.metrics, (w["name"], trace)
            harness.loop(cell)
            for m in cell.metrics:
                assert callable(harness.reader(cell, m["name"]))
            assert set(cell.limits) <= {"loss_gap", "grad_gap",
                                        "grad_diff",
                                        "update_gap", "bn_stats_gap",
                                        "prob_gap", "unanswered"}
        e2e = {m["name"] for m in manifest["end_to_end"]
               if "workloads" not in m or w["name"] in m["workloads"]}
        assert "setup_s" in e2e and len(e2e) >= 2


def test_per_layer_metrics_move_a_metric_their_cells_report(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert _line(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_config_files(manifest):
    for c in manifest["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        from benchmark.loops import common

        common.model_config(cfg["model"])  # every field is the program's
        families.load(cfg["model"])


def _family_files():
    folder = os.path.join(harness.BENCH_DIR, "reference", "families")
    return sorted(f[:-3] for f in os.listdir(folder)
                  if f.endswith(".py") and not f.startswith("_"))


@pytest.mark.parametrize("family", _family_files())
def test_family_module_gives_what_the_harness_reads(family):
    mod = families.load({"family": family})
    for name in ("specs", "num_features", "stage_of", "features",
                 "products"):
        assert callable(getattr(mod, name)), (family, name)


def test_a_family_without_a_file_names_the_file_to_add():
    with pytest.raises(ValueError, match="families/no_such_net.py"):
        families.load({"family": "no_such_net"})
