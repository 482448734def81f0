"""The port's device monitor (``irp_tpu_torch/utils/monitor.py``), as
``tests/test_monitor.py`` holds the JAX package's: the shape of the
memory stats, a trace written and a disabled trace that writes nothing;
and the port's own spans: off they are one shared no-op, on (a profiler
recording, or ``tracing``) they nest per thread and reach the profiler,
and ``tracing`` gives them back;
``DeviceTimer`` times ``fit``'s epochs."""

import importlib
import json
import os
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from irp_tpu_torch.config import DatasetInfo, ModelConfig, TrainConfig
from irp_tpu_torch.data.pipeline import CachedDataset
from irp_tpu_torch.models.classifier import init_classifier
from irp_tpu_torch.train.loop import set_mode
from irp_tpu_torch.train.state import create_train_state
from irp_tpu_torch.train.step import StepConfig, train_step
from irp_tpu_torch.utils import monitor

# the module (the package's ``fit`` is the function)
fit_module = importlib.import_module("irp_tpu_torch.train.fit")

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


def _tiny_step():
    """A ResNet18 train step at 32 px on the CPU, ready to call."""
    cfg = ModelConfig(depth=18, num_classes=3, image_size=32,
                      compute_dtype="float32", dropout_rate=0.0)
    model = init_classifier(cfg, torch.Generator().manual_seed(0), "cpu")
    set_mode(model, True)
    state = create_train_state(model, TrainConfig(batch_size=2), cfg)
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 40, 40, 3), dtype=np.uint8))
    labels = torch.tensor([0, 2])
    gen = torch.Generator().manual_seed(1)
    return lambda: train_step(state, images, labels,
                              StepConfig(out_size=32,
                                         compute_dtype=torch.float32),
                              generator=gen)


def test_spans_off_are_one_shared_noop(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span that is off touched the profiler "
                             "or the device")

    for name in ("Event", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(monitor, "DeviceTimer", refuse)
    assert monitor.span("train.step") is monitor.NO_SPAN
    step = _tiny_step()
    step()  # every span of a real step, off
    tracemalloc.start()
    try:
        for _ in range(3):  # the first rounds warm the interpreter
            before = tracemalloc.get_traced_memory()[0]
            for _ in range(10000):
                with monitor.span("train.step") as s:
                    s.count("items", 2)
            grew = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    # nothing accumulates: a record kept per span would be ~1 MB here
    assert grew < 64
    assert monitor._SINK is None and not monitor._ON


def test_spans_nest_per_thread_and_come_back_in_order():
    def other():
        with monitor.span("other.thread"):
            pass

    with monitor.tracing(device="cpu") as records:
        with monitor.span("a") as a:
            a.count("items", 3)
            a.count("items", 1)
            with monitor.span("b"):
                t = threading.Thread(target=other)
                t.start()
                t.join(timeout=30)
                with monitor.span("c"):
                    pass
            with monitor.span("d"):
                pass
    assert not t.is_alive()
    names = [r["name"] for r in records]
    assert names == ["a", "b", "other.thread", "c", "d"]
    by_seq = {r["seq"]: r for r in records}
    parent = {r["name"]: by_seq[r["parent"]]["name"]
              if r["parent"] is not None else None for r in records}
    # the other thread's span has no open span of its own thread above it
    assert parent == {"a": None, "b": "a", "other.thread": None, "c": "b",
                      "d": "a"}
    assert records[0]["counts"] == {"items": 4}
    for r in records:
        assert r["device_ms"] is not None and r["device_ms"] >= 0
        assert r["host_ms"] >= 0
    assert records[0]["host_ms"] >= records[1]["host_ms"]
    # after the block nothing is collected
    with monitor.span("after"):
        pass
    assert len(records) == 5


def test_tracing_without_device_times(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a range with no profiler to record it")

    # no profiler records here: the span opens no record_function range
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with monitor.tracing(device_times=False) as records:
        with monitor.span("x"):
            pass
    assert [(r["name"], r["device_ms"]) for r in records] == [("x", None)]


def test_span_names_reach_the_profiler():
    # a recording profiler alone turns spans on; they collect nothing
    with monitor.profile_session() as prof:
        with monitor.span("train.step"):
            assert monitor.span("x") is not monitor.NO_SPAN
            with monitor.span("train.forward"):
                torch.ones(4, 4) @ torch.ones(4, 4)
    assert monitor.span("train.step") is monitor.NO_SPAN
    assert monitor._SINK is None and not monitor._ON
    events = {e.name: e for e in prof.events()}
    assert {"train.step", "train.forward", "aten::mm"} <= set(events)
    outer, inner = events["train.step"], events["train.forward"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end


def test_profile_trace_shows_the_train_steps_spans(tmp_path):
    step = _tiny_step()
    with monitor.profile_trace(str(tmp_path), enabled=True):
        step()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"train.step", "train.augment", "train.forward",
            "train.forward.frozen", "train.backward",
            "train.optimizer"} <= names
    assert not monitor._ON  # off again after the block


def test_device_timer_times_fits_epochs(monkeypatch):
    timed = []

    class Recording(monitor.DeviceTimer):
        __slots__ = ()

        def ms(self):
            timed.append(super().ms())
            return timed[-1]

    monkeypatch.setattr(fit_module, "DeviceTimer", Recording)
    n = 8
    images = np.random.default_rng(0).integers(0, 256, (n, 40, 40, 3),
                                               dtype=np.uint8)
    labels = (np.arange(n) % 2).astype(np.int32)
    cached = CachedDataset(images, labels, [str(i) for i in range(n)],
                           ("a", "b"))
    info = DatasetInfo(num_classes=2, class_names=("a", "b"),
                       class_weights=(1.0, 1.0), class_counts=(4, 4),
                       total_samples=n)
    res = fit_module.fit(cached, None, info,
                         ModelConfig(depth=18, num_classes=2, image_size=32,
                                     compute_dtype="float32"),
                         TrainConfig(batch_size=4, max_epochs=2, seed=1),
                         device="cpu")
    assert res.history["train_ms"] == timed and len(timed) == 2
    assert all(ms > 0 for ms in timed)
