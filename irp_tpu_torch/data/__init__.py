"""Image decoding."""
