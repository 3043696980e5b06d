"""Serving layer: prefill/decode steps, greedy generation, the grouped
model batcher and the grouped-UDF dispatch backend."""
