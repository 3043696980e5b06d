"""Microseconds of the model UDF's prefill (the pass and its sample,
``udf.prefill``) per prompt token over the steady part of the window
(``udf.prefill_tokens``)."""
from harness.program_trace import seconds_per


def read(run):
    return seconds_per(run, ("udf.prefill",), "udf.prefill_tokens", 1e6)
