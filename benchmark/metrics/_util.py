"""Arithmetic the metric readers share."""

import statistics


def mean(values):
    return statistics.fmean(values) if values else None


def idle_share_pct(record):
    """The traced window's share in which no device operation ran."""
    prof = record.get("profile")
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
