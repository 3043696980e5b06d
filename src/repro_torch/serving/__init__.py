"""Serving layer: so far the grouped-UDF dispatch backend."""
