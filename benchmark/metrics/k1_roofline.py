"""K1's share (%) of its roofline in the traced window: the bound of
its launches (roofline/counts.py: k1_bound_ms of each identity block of a
forward, times the forwards) over its device time from the profiler."""

from benchmark.tracing import kernel_time


def read(record):
    prof = record.get("profile")
    per_forward = record.get("k1_blocks_per_forward", 0)
    if not prof or not per_forward:
        return None
    secs, launches = kernel_time(prof, "identity_bottleneck")
    if not launches or launches % per_forward or secs <= 0:
        return None
    forwards = launches // per_forward
    return 100.0 * forwards * record["k1_bound_ms_per_forward"] / 1e3 / secs
