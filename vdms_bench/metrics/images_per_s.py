"""Images in the queries completed, over the whole window: from the
first submit to the last result of a query sent before the deadline."""
from harness.window import images


def read(run):
    return images(run, run.queries) / run.window_s
