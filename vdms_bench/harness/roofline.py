"""A kernel's share of its roofline over the launches a traced slice
caught: the least time the card could take for each launch's work
(the longest of its bytes at the HBM rate, its products at the
tensor-core rate and its other operations at the float32 rate), summed,
over the device time those launches took, in %."""
from harness.work import bound_s


def share(run, name: str, work_of) -> float | None:
    """``work_of(shape)`` gives ``(bytes, products, other, itemsize)``."""
    launches = (run.trace or {}).get("launches", {}).get(name, [])
    took = sum(t for _, t in launches)
    if not launches or took <= 0:
        return None
    least = sum(bound_s(*work_of(shape)) for shape, _ in launches)
    return 100.0 * least / took
