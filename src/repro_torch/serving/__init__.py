"""Serving layer: prefill/decode steps, greedy generation, the grouped
model batcher, the grouped-UDF dispatch backend, and the network front
end (the SSE-flavored wire protocol and its server and client)."""
from repro_torch.serving.serve_step import make_serve_fns, greedy_generate  # noqa: F401,E402
