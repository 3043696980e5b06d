"""Device allocations (``cudaMalloc`` calls of the caching allocator,
the program's ``device.mallocs`` counter) per group the device backend
ran over the steady part of the window."""
from harness.program_trace import delta


def read(run):
    d = delta(run)
    if d is None or "device.mallocs" not in d[1]:
        return None
    before, after = run.backend
    groups = after["groups_run"] - before["groups_run"]
    if groups <= 0:
        return None
    return d[1]["device.mallocs"] / groups
