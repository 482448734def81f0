"""Peaks of the card, and the operations and bytes of the work, counted
from shapes: the yardstick for rooflines and for shares of the peak."""
