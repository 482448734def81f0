"""Device memory and profiling helpers (the JAX package's
``utils/monitor.py``).

:func:`device_memory_stats` reports each visible CUDA device's memory in
GB under the JAX package's names (``gb_in_use``, ``peak_gb_in_use``,
``gb_limit``) from ``torch.cuda.memory_stats`` and ``mem_get_info``;
without CUDA there is one CPU entry with an empty dict, as the JAX
package reports a backend without memory stats.  :func:`profile_session`
wraps ``torch.profiler`` behind a discarded warm-up step, and
:func:`profile_trace` writes its Chrome trace into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch

_GB = 1024 ** 3
_WARMUP_KERNELS = 16


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
    Perfetto).  ``enabled=False`` does nothing."""
    if not enabled:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile_session(lambda p: p.export_chrome_trace(path)):
        yield
