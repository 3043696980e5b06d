"""Milliseconds the engine's host boundary took per image over the
steady part of the window: the launches' copies to the device
(``boundary.in``) and the results' copies to the host (``boundary.out``,
one an image), over the images that came back."""
from harness.program_trace import delta


def read(run):
    d = delta(run)
    if d is None:
        return None
    s_in = d[0].get("boundary.in", (0, 0.0))[1]
    n_out, s_out = d[0].get("boundary.out", (0, 0.0))
    return 1e3 * (s_in + s_out) / n_out if n_out > 0 else None
