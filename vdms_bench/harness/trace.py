"""A steady slice of a traced run under ``torch.profiler``, reduced to
what the readers and the result's ``breakdown`` need: the union of the
device's busy intervals, each probed kernel launch's device time beside
its shape, the device operations that took most time, and the longest
idle stretches of the device by what the host was doing meanwhile."""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import time

from harness.hooks import PREFIX
from harness.stats import gaps, union_length

TOP = 10


class Slice:
    """The profiler over CPU ops of every thread and the device's
    activity.  Built at the start of a traced run: the profiler's first
    preparation in a process takes seconds (about 13 on the H100's host),
    so it is paid in set-up; ``with s.record():`` then records the slice
    itself, and ``s.reduce()`` reads it afterwards.  One profile a
    process: a second one records nothing there."""

    def __init__(self):
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile, schedule
        # the engine launches from its own threads: record them all
        self._prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self._prof.start()
        self.wall_s = 0.0

    @contextlib.contextmanager
    def record(self):
        self._prof.step()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.wall_s = time.perf_counter() - t0
            self._prof.step()
            self._prof.stop()

    def close(self) -> None:
        """Stops a profiler that never recorded (a run that failed
        before its slice)."""
        if self._prof.profiler is not None and self.wall_s == 0.0:
            self._prof.stop()

    def reduce(self) -> dict:
        from torch.autograd import DeviceType
        events = self._prof.events()
        device, host, probes = [], [], []
        for e in events:
            span = (e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                # a probe's range as the device ran it: from its first
                # kernel's start to its last kernel's end
                if e.name.startswith(PREFIX):
                    probes.append((*span, e.name))
                elif not e.is_user_annotation:
                    device.append((*span, e.name))
            elif not e.name.startswith((PREFIX, "ProfilerStep")):
                host.append((*span, e.name))
        busy_us = union_length([(s, t) for s, t, _ in device])
        by_name = collections.defaultdict(float)
        for s, t, name in device:
            by_name[name] += t - s
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        launches = collections.defaultdict(list)
        for s, t, label in probes:
            _, name, shape = label.split("|", 2)
            if t > s:
                launches[name].append((json.loads(shape), (t - s) * 1e-6))
        return {
            "busy_s": busy_us * 1e-6,
            "window_s": self.wall_s,
            "launches": dict(launches),
            "device_ops": [[n, us * 1e-6] for n, us in device_ops],
            "idle_gaps": _idle_by_host(device, host),
        }


def _idle_by_host(device, host) -> list:
    """The device's idle stretches inside the slice, summed by the name
    of the innermost host operation running at each stretch's middle
    (``"host python"`` where none ran): the ``TOP`` largest sums."""
    if not device:
        return []
    lo = min(s for s, _, _ in device)
    hi = max(t for _, t, _ in device)
    idle = gaps([(s, t) for s, t, _ in device], lo, hi)
    idle = sorted(idle, key=lambda g: g[0] - g[1])[:500]
    host = sorted(host)
    starts = [s for s, _, _ in host]
    longest = max((t - s for s, t, _ in host), default=0.0)
    sums = collections.defaultdict(float)
    for a, b in idle:
        mid = (a + b) / 2
        best = None
        i = bisect.bisect_right(starts, mid)
        j = bisect.bisect_left(starts, mid - longest)
        for s, t, name in host[j:i]:
            if s <= mid <= t and (best is None or t - s < best[0]):
                best = (t - s, name)
        sums[best[1] if best else "host python"] += (b - a) * 1e-6
    top = sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name, s] for name, s in top]
