"""Preprocessing and the wrappers of the hand-written kernels."""
