"""Mean time of one decode step of the model UDF (the serving step and
its sample, ``udf.decode``), in ms, over the steady part of the window."""
from harness.program_trace import span_mean


def read(run):
    return span_mean(run, "udf.decode", 1e3)
