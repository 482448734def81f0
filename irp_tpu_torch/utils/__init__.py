"""Utilities: figures, device memory and profiling."""
