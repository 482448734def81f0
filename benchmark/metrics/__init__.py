"""One reader per metric: read(record) -> value or None."""
