"""Milliseconds of the model UDF's per-image host work per image served
over the steady part of the window: building the prompts
(``udf.prompts``) and stamping the labels (``udf.stamp``), over
``udf.rows``."""
from harness.program_trace import seconds_per


def read(run):
    return seconds_per(run, ("udf.prompts", "udf.stamp"), "udf.rows", 1e3)
