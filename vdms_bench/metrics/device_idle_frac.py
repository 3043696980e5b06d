"""Share of the traced slice in which no kernel, copy or set ran on the
device (one minus the union of the device's intervals over the slice)."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 1.0 - run.trace["busy_s"] / run.trace["window_s"]
