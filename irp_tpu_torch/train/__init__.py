"""Weights artifacts."""
