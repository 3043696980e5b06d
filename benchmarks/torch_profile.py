#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes on one CUDA card.

``python3 benchmarks/torch_profile.py`` from the root of a checkout (needs
a CUDA card; exits 2 without one).  It drives three queries of
``chip_smoke.py`` through the port's ``VDMSAsyncEngine(device="cuda")``:
IQ3's native blur and the C2 pipeline over 64 synthetic 250x250 faces,
and the device-backend chain (resize → crop → normalize → blur pinned to
the device, batch 32) over 256.  Each runs twice to warm up, then once
under ``torch.profiler`` with CPU and CUDA activities.  For each query it
prints the host wall time of the profiled run, the device's busy time
(the union of its kernel, copy and memset intervals), the idle share
``1 - busy / wall`` and the device activities that took the most time;
the report goes to ``chiprun_out/torch_profile.json``.  The profiler
slows the host side, so these wall times run longer than chip_smoke.py's
unprofiled warm times.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP = 6


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, start, end = 0.0, None, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    return total if end is None else total + end - start


def profile_query(eng, query, launches) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    chip_smoke.run_query(eng, query)
    torch.cuda.synchronize()
    before = {k: c.count for k, c in launches.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        res = eng.execute(query, timeout=600)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    if res["stats"]["failed"]:
        raise RuntimeError(f"query failed: {res['stats']}")
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for s, e, name in spans:
        by_name[name][0] += 1
        by_name[name][1] += e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    busy = busy_us([(s, e) for s, e, _ in spans]) if spans else None
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": None if busy is None else busy / 1e3,
        "idle_share": None if busy is None else 1.0 - busy / wall_us,
        "device_activities": len(spans),
        "kernel_launches": {k: c.count - before[k]
                            for k, c in launches.items()},
        "top": [{"name": n[:90], "count": c, "ms": t / 1e3}
                for n, (c, t) in top],
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_profile: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke
    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.core.remote import TransportModel
    from repro_torch.dataio.synthetic import synthetic_faces
    from repro_torch.kernels import _build
    from repro_torch.kernels import gaussian_blur as gb
    from repro_torch.kernels import preprocess as pp

    _build.build_all()
    smi = chip_smoke.nvidia_smi_line()
    print(f"card: {smi}", flush=True)
    launches = {"gaussian_blur": gb.launches,
                "fused_resize_crop_normalize": pp.launches}
    transport = TransportModel(network_latency_s=0.002, service_time_s=0.001)
    cases = [
        ("iq3_blur_native", 64, {}, chip_smoke.IQ3_BLUR),
        ("c2_native", 64, {}, chip_smoke.C2_PIPE),
        ("device_backend_chain", 256,
         dict(dispatch="cost", device_backend=True, device_batch_size=32,
              device_max_wait_ms=50.0,
              cost_overrides=chip_smoke.DEVICE_PINNED),
         chip_smoke.DEVICE_PIPE),
    ]
    report = {"card": smi, "torch": torch.__version__, "cases": {}}
    for name, n_faces, kw, ops in cases:
        eng = VDMSAsyncEngine(device="cuda", num_remote_servers=2,
                              transport=transport, **kw)
        try:
            chip_smoke.ingest_faces(eng, synthetic_faces(n_faces, 250, seed=0),
                                    "lfw")
            out = profile_query(eng, chip_smoke.find("lfw", ops), launches)
        finally:
            eng.shutdown()
        report["cases"][name] = out
        busy = out["device_busy_ms"]
        print(f"{name}: wall {out['wall_ms']:.3f} ms, device busy "
              + ("not measured (no device activity traced)" if busy is None
                 else f"{busy:.3f} ms, idle share {out['idle_share']:.4f}")
              + f", {out['device_activities']} device activities, "
              f"kernel launches {out['kernel_launches']}", flush=True)
        for t in out["top"]:
            print(f"    {t['ms']:10.3f} ms  x{t['count']:<6d} {t['name']}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "torch_profile.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
