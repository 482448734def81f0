"""A traced window: ``torch.profiler`` over a block of the run, reduced to
summaries (no trace file is written).

The session opens with one warm-up step of a few trivial kernels whose
records are discarded: late in a long process the tracer can drop the
first kernels of a session.  The reduction gives the device's busy time
(the union of its kernels' and copies' spans), each device operation's
time and count by name, and the idle gaps between device work, each
labelled by the innermost host operation open at its middle ("host" when
none was: Python between calls).
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch

_WARMUP_KERNELS = 16
TOP = 10


@contextlib.contextmanager
def traced(device):
    """Profile the block; yields a dict filled on exit with the
    reduction (:func:`reduce_events`) and ``window_s``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    out: dict = {}
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 ) as prof:
        if cuda:
            x = torch.zeros(8, device=device)
            for _ in range(_WARMUP_KERNELS):
                x.add_(1)
            torch.cuda.synchronize(device)
        prof.step()
        t0 = time.perf_counter()
        yield out
        if cuda:
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
        prof.step()
    out.update(reduce_events(prof.events()))
    out["window_s"] = window_s


def reduce_events(events) -> dict:
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                dev.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((e.time_range.start, e.time_range.end, e.name))
    dev.sort()
    host.sort()
    by_name_s: dict = {}
    by_name_n: dict = {}
    busy, gaps = 0.0, []
    cur_start = cur_end = None
    for start, end, name in dev:
        by_name_s[name] = by_name_s.get(name, 0.0) + (end - start) / 1e6
        by_name_n[name] = by_name_n.get(name, 0) + 1
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
                gaps.append((cur_end, start))
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    starts = [h[0] for h in host]
    idle: dict = {}
    for g0, g1 in gaps:
        label = _innermost(host, starts, (g0 + g1) / 2)
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e6
    return {
        "busy_s": busy / 1e6,
        "device_s": by_name_s,
        "device_n": by_name_n,
        "device_ops": sorted(([n, s] for n, s in by_name_s.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                            key=lambda kv: -kv[1])[:TOP],
    }


def _innermost(host, starts, t, reach: int = 4096) -> str:
    """The host operation open at ``t`` that started last (the innermost
    of nested ones); 'host' when none is open."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - reach, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host"


def kernel_time(profile: dict, key: str):
    """(seconds, launches) of the device operations whose name holds
    ``key``."""
    secs = sum(s for n, s in profile["device_s"].items() if key in n)
    count = sum(c for n, c in profile["device_n"].items() if key in n)
    return secs, count
