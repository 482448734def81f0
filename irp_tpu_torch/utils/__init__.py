"""Utilities: figures."""
