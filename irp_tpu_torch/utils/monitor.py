"""Device memory and profiling helpers (the JAX package's
``utils/monitor.py``).

:func:`device_memory_stats` reports each visible CUDA device's memory in
GB under the JAX package's names (``gb_in_use``, ``peak_gb_in_use``,
``gb_limit``) from ``torch.cuda.memory_stats`` and ``mem_get_info``;
without CUDA there is one CPU entry with an empty dict, as the JAX
package reports a backend without memory stats.  :func:`profile_session`
wraps ``torch.profiler`` behind a discarded warm-up step, and
:func:`profile_trace` writes its Chrome trace into a directory.

Spans (:func:`span`) mark the stages of the program where the work
happens (the train step's ``train.*``).  They are off unless a
``torch.profiler`` session is recording (:func:`profile_session`,
:func:`profile_trace` or any other) or a :func:`tracing` block is open:
then each span is, while a profiler records, a
``torch.profiler.record_function`` range, on the clock of the profiler's
device events, and inside :func:`tracing` a record of its host and
device time (:class:`DeviceTimer`).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List

import torch
from torch.autograd import profiler as _profiler

_GB = 1024 ** 3
_WARMUP_KERNELS = 16

# open tracing() blocks: spans are on while > 0, or while a profiler
# records (_profiler._is_profiler_enabled)
_ON = 0
# the innermost open tracing() block's collector, or None
_SINK = None
# each thread's open spans, innermost last
_LOCAL = threading.local()


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-device memory in GB: what PyTorch's allocator holds in tensors
    now (``gb_in_use``) and at most since the last peak reset
    (``peak_gb_in_use``), and the device's total memory (``gb_limit``)."""
    if not torch.cuda.is_available():
        return {"cpu": {}}
    out = {}
    for i in range(torch.cuda.device_count()):
        raw = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "gb_in_use": raw.get("allocated_bytes.all.current", 0) / _GB,
            "peak_gb_in_use": raw.get("allocated_bytes.all.peak", 0) / _GB,
            "gb_limit": total / _GB}
    return out


def print_device_memory() -> None:
    for dev, stats in device_memory_stats().items():
        if stats:
            parts = ", ".join(f"{k}: {v:.2f} GB" for k, v in stats.items())
            print(f"{dev}: {parts}")
        else:
            print(f"{dev}: memory stats unavailable")


@contextlib.contextmanager
def profile_session(on_trace_ready=None):
    """``torch.profiler`` (CPU and, where there is one, the CUDA device)
    over the block, yielding the profiler; its ``events()`` after the
    block are the block's.

    The profiler runs one warm-up step of a few trivial device kernels
    before the block's: on a process that has run a while, the tracer
    can drop the first kernels of a session (seen on an H100 machine),
    and the warm-up step's records are the ones discarded."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=on_trace_ready) as prof:
        if cuda:
            x = torch.zeros(8, device="cuda")
            for _ in range(_WARMUP_KERNELS):
                x.add_(1)
            torch.cuda.synchronize()
        prof.step()
        yield prof
        if cuda:
            torch.cuda.synchronize()
        prof.step()


@contextlib.contextmanager
def profile_trace(log_dir: str = "/tmp/torch_trace", enabled: bool = True):
    """:func:`profile_session` over the block, written as
    ``log_dir/trace_<pid>_<ns>.json``, a Chrome trace (chrome://tracing,
    Perfetto); the program's spans (:func:`span`) are on while the
    profiler records, so the trace shows its stages.  ``enabled=False``
    does nothing."""
    if not enabled:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile_session(lambda p: p.export_chrome_trace(path)):
        yield


class DeviceTimer:
    """Milliseconds of a stretch of device work on ``device``: a pair of
    timing CUDA events on the current stream on a card, the host clock on
    the CPU.  Entering and leaving record the pair without waiting;
    :meth:`ms` waits for the second."""

    __slots__ = ("cuda", "start", "end")

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
        else:
            self.end = time.perf_counter_ns()

    def ms(self) -> float:
        if self.cuda:
            self.end.synchronize()
            return self.start.elapsed_time(self.end)
        return (self.end - self.start) / 1e6


class _NoSpan:
    """The span while spans are off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def count(self, key: str, n: int) -> None:
        pass


NO_SPAN = _NoSpan()


class _Sink:
    """What one :func:`tracing` block collects."""

    def __init__(self, device):
        self.device = device  # None: no device times
        self.seq = itertools.count()
        self.spans: list = []


class _Span:
    __slots__ = ("name", "parent", "seq", "sink", "rf", "timer", "t0", "t1",
                 "counts")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _profiler._is_profiler_enabled:  # a range only a profiler reads
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        stack = _open_spans()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.sink = sink = _SINK
        self.counts = {}
        self.timer = None
        if sink is not None:
            self.seq = next(sink.seq)
            if sink.device is not None:
                self.timer = DeviceTimer(sink.device).__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.timer is not None:
            self.timer.__exit__()
        _open_spans().remove(self)
        if self.sink is not None:
            self.sink.spans.append(self)
        if self.rf is not None:
            self.rf.__exit__(*exc)

    def count(self, key: str, n: int) -> None:
        """Add ``n`` to the span's count ``key``."""
        self.counts[key] = self.counts.get(key, 0) + n

    def record(self) -> dict:
        parent = self.parent
        same = parent is not None and parent.sink is self.sink
        return {"seq": self.seq, "name": self.name,
                "parent": parent.seq if same else None,
                "host_ms": (self.t1 - self.t0) / 1e6,
                "device_ms": (None if self.timer is None
                              else self.timer.ms()),
                "counts": dict(self.counts)}


def _open_spans() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def span(name: str):
    """A stage of the program, as a context manager: ``with
    span("train.forward.frozen") as s: ... s.count("k1_launches", n)``.

    Off (no profiler recording and no :func:`tracing` block open) it
    returns :data:`NO_SPAN`, shared and doing nothing: no allocation, no
    event, no synchronize.  On, it is the child of the span this thread
    has open, and a ``torch.profiler.record_function(name)`` range while
    a profiler records; inside :func:`tracing` it is also recorded
    there, with a pair of timing events when device times are asked
    for."""
    if _ON or _profiler._is_profiler_enabled:
        return _Span(name)
    return NO_SPAN


@contextlib.contextmanager
def tracing(device_times: bool = True, device=None):
    """Spans on over the block; yields a list that holds, after the
    block, one dict per span closed inside it, in the order they opened:
    ``seq`` (that order), ``name``, ``parent`` (the ``seq`` of the span
    it opened in, None at the top), ``host_ms``, ``device_ms`` and
    ``counts``.

    ``device_times``: time each span on ``device`` (default: the CUDA
    device where there is one, else the CPU, timed by the host clock)
    with :class:`DeviceTimer`, resolved after the block by one
    synchronize; False leaves ``device_ms`` None.  Nothing is written to
    disk.  An inner block collects its own spans alone."""
    dev = None
    if device_times:
        dev = torch.device(device if device is not None else
                           "cuda" if torch.cuda.is_available() else "cpu")
    global _ON, _SINK
    sink, outer = _Sink(dev), _SINK
    out: List[dict] = []
    _ON += 1
    _SINK = sink
    try:
        yield out
    finally:
        _ON -= 1
        _SINK = outer
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out.extend(s.record() for s in sorted(sink.spans, key=lambda s: s.seq))
