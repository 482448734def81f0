"""The port's device monitor (``irp_tpu_torch/utils/monitor.py``), as
``tests/test_monitor.py`` holds the JAX package's: the shape of the
memory stats, a trace written and a disabled trace that writes nothing."""

import json
import os

import pytest
import torch

from irp_tpu_torch.utils import monitor

torch.set_num_threads(1)


def test_device_memory_stats_shape(capsys):
    stats = monitor.device_memory_stats()
    assert len(stats) >= 1
    if torch.cuda.is_available():
        for dev, entry in stats.items():
            assert dev.startswith("cuda:")
            assert set(entry) == {"gb_in_use", "peak_gb_in_use", "gb_limit"}
            assert 0 <= entry["gb_in_use"] <= entry["peak_gb_in_use"] \
                <= entry["gb_limit"]
    else:
        # no CUDA: one entry without stats, as the JAX package reports a
        # backend that exposes none
        assert stats == {"cpu": {}}
    monitor.print_device_memory()
    assert "memory stats unavailable" in capsys.readouterr().out or \
        torch.cuda.is_available()


@pytest.mark.gpu
def test_device_memory_stats_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = monitor.device_memory_stats()["cuda:0"]
    x = torch.empty(256 * 1024 ** 2, dtype=torch.uint8, device="cuda")
    after = monitor.device_memory_stats()["cuda:0"]
    assert after["gb_in_use"] >= before["gb_in_use"] + 0.24
    assert after["peak_gb_in_use"] >= after["gb_in_use"]
    assert after["gb_limit"] > 1
    del x


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with monitor.profile_trace(str(tmp_path), enabled=True):
        torch.ones(8, 8) @ torch.ones(8, 8)
    (name,) = os.listdir(tmp_path)
    assert name.startswith("trace_") and name.endswith(".json")
    with open(tmp_path / name) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]


def test_profile_trace_disabled_noop(tmp_path):
    with monitor.profile_trace(str(tmp_path / "t"), enabled=False):
        pass
    assert not os.path.exists(tmp_path / "t")


def test_profile_session_events_are_the_blocks():
    torch.ones(3).mul(2)  # before the session: not recorded
    with monitor.profile_session() as prof:
        torch.ones(4, 4) @ torch.ones(4, 4)
    names = {e.name for e in prof.events()}
    assert "aten::mm" in names and "aten::mul" not in names
