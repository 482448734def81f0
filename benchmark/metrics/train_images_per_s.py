"""Trained images over the window's time, the window being whole
epoch_step calls (host clock, ended by a device synchronize)."""


def read(record):
    return record["images"] / record["window_s"]
