"""Mean time an image waited in the device backend's inbox before its
micro-batch started, in ms, over the steady part of the window (the
program's ``device.wait``)."""
from harness.program_trace import span_mean


def read(run):
    return span_mean(run, "device.wait", 1e3)
