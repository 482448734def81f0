"""The program's spans (``irp_tpu_torch/utils/monitor.py``) read against
a ``torch.profiler`` session and against the records of
``monitor.tracing()``.

:func:`attribute` gives each device kernel or copy of the session to the
innermost program span open on the host when it was launched, and each
idle gap of the device to the span open at the gap's middle ("outside"
when none is).  A kernel's launch is the runtime or driver call
(``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync`` and kin)
that shares its correlation id, the id the profiler's own trace links
them by (not every version of PyTorch gives the profiler's events their
linked correlation id).  A launch's host time is compared with the
spans' intervals alone, whatever thread launched it: autograd launches the backward's kernels from a thread of its own while
``train.backward`` is open on the main thread.  The spans' intervals are
their ``record_function`` ranges in the same session, so spans and
kernels lie on the profiler's clock.

:func:`summary` and :func:`per_step_ms` read ``monitor.tracing()``'s
records (device times from CUDA events on a card, the host clock on the
CPU).
"""

from __future__ import annotations

import bisect
import json
import os

OUTSIDE = "outside"
STEP = "train.step"
GROUPS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "kernel_groups.json")


def kernel_groups(path: str = GROUPS_FILE):
    """(groups, other): the ordered (name, lowercase patterns) pairs of
    ``kernel_groups.json``, and the name of what none matches."""
    with open(path) as f:
        data = json.load(f)
    return ([(g["name"], [p.lower() for p in g["patterns"]])
             for g in data["groups"]], data["other"])


def group_of(kernel: str, groups) -> str:
    """The first group one of whose patterns the kernel's name holds."""
    found, other = groups
    low = kernel.lower()
    for name, patterns in found:
        if any(p in low for p in patterns):
            return name
    return other


def _chains(intervals):
    """(times, chains): from ``times[i]`` on, the spans open are
    ``chains[i]``, outermost first.  ``intervals``: (start, end, name)."""
    marks = []
    for i, (s, e, _) in enumerate(intervals):
        marks.append((s, 1, -e, i))  # at one time: ends first, outer first
        marks.append((e, 0, 0, i))
    marks.sort()
    times, chains, open_ = [], [], []
    for t, is_start, _, i in marks:
        if is_start:
            open_.append(i)
        else:
            open_.remove(i)
        times.append(t)
        chains.append(tuple(intervals[j][2] for j in open_))
    return times, chains


def _chain_at(times, chains, t) -> tuple:
    k = bisect.bisect_right(times, t) - 1
    return chains[k] if k >= 0 else ()


def attribute(events, span_names, groups=None) -> dict:
    """Device work and idle time of a profiler session by program span.

    ``events``: the session's ``prof.events()`` (or objects with their
    ``name``, ``device_type``, ``is_user_annotation``, ``time_range`` and
    ``id``); ``span_names``: the names the program's spans took.  A
    kernel whose launch is not found counts as launched outside every
    span (``launch_found`` says how many were found).  Per-step figures
    divide by the number of ``train.step`` spans; without device work
    they are None.
    """
    from torch.autograd import DeviceType

    groups = groups or kernel_groups()
    dev, spans, launches = [], [], {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                dev.append(e)
        elif e.device_type == DeviceType.CPU:
            if e.name in span_names:
                spans.append((e.time_range.start, e.time_range.end, e.name))
            elif e.name.startswith("cu"):  # the runtime's and driver's calls
                launches[e.id] = e.time_range.start
    times, chains = _chains(spans)
    steps = sum(1 for s in spans if s[2] == STEP)
    by_span_group: dict = {}
    in_steps = found = 0
    for k in dev:
        t = launches.get(k.id)
        found += t is not None
        chain = () if t is None else _chain_at(times, chains, t)
        in_steps += STEP in chain
        span = chain[-1] if chain else OUTSIDE
        row = by_span_group.setdefault(span, {})
        group = group_of(k.name, groups)
        row[group] = row.get(group, 0.0) + (k.time_range.end
                                            - k.time_range.start) / 1e3
    idle_by_span: dict = {}
    step_idle = 0.0
    for g0, g1 in _gaps(dev):
        chain = _chain_at(times, chains, (g0 + g1) / 2)
        span = chain[-1] if chain else OUTSIDE
        idle_by_span[span] = idle_by_span.get(span, 0.0) + (g1 - g0) / 1e3
        if STEP in chain:
            step_idle += (g1 - g0) / 1e3
    per_step = steps and dev
    return {
        "steps": steps,
        "device_ops": len(dev),
        "launch_found": found,
        "launches_per_step": in_steps / steps if per_step else None,
        "step_idle_ms": step_idle / steps if per_step else None,
        "idle_ms_by_span": dict(sorted(idle_by_span.items(),
                                       key=lambda kv: -kv[1])),
        "device_ms_per_step_by_span_group": {
            span: {g: ms / steps for g, ms in sorted(
                row.items(), key=lambda kv: -kv[1])}
            for span, row in by_span_group.items()} if per_step else {},
    }


def _gaps(dev) -> list:
    """The intervals (us) between the device's busy stretches."""
    out, cur_end = [], None
    for start, end in sorted((k.time_range.start, k.time_range.end)
                             for k in dev):
        if cur_end is not None and start > cur_end:
            out.append((cur_end, start))
        cur_end = end if cur_end is None else max(cur_end, end)
    return out


def summary(records) -> dict:
    """Per span name, from ``monitor.tracing()``'s records: how many,
    the mean device ms, the mean host ms and the mean host self ms (its
    host time less its children's), and each count summed."""
    children: dict = {}
    for r in records:
        if r["parent"] is not None:
            children[r["parent"]] = children.get(r["parent"], 0.0) \
                + r["host_ms"]
    out: dict = {}
    for r in records:
        s = out.setdefault(r["name"], {"n": 0, "device_ms": 0.0,
                                       "host_ms": 0.0, "host_self_ms": 0.0,
                                       "counts": {}})
        s["n"] += 1
        if r["device_ms"] is None or s["device_ms"] is None:
            s["device_ms"] = None
        else:
            s["device_ms"] += r["device_ms"]
        s["host_ms"] += r["host_ms"]
        s["host_self_ms"] += r["host_ms"] - children.get(r["seq"], 0.0)
        for k, v in r["counts"].items():
            s["counts"][k] = s["counts"].get(k, 0) + v
    for s in out.values():
        for k in ("device_ms", "host_ms", "host_self_ms"):
            if s[k] is not None:
                s[k] /= s["n"]
    return out


def per_step_ms(records, name: str):
    """The device ms of the spans ``name`` over the ``train.step`` spans
    (None without steps or device times)."""
    steps = sum(1 for r in records if r["name"] == STEP)
    times = [r["device_ms"] for r in records if r["name"] == name]
    if not steps or not times or None in times:
        return None
    return sum(times) / steps
