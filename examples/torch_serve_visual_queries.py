#!/usr/bin/env python3
"""Serving example on the PyTorch port: visual queries whose pipeline
includes real model inference — an assigned-architecture LM registered
as a UDF (prefill + decode through the serving layer), the "ML model
inside the query" scenario the paper motivates.

On the CUDA card the UDF is qwen3-0.6b at full width (28 layers,
d_model 1024, seeded random weights); on the CPU (``--device cpu``) it
is the reduced qwen3, or the tree a caller passes as ``params``.

Under repeated traffic (the serving steady state) the engine's result
cache turns the model-in-the-loop pipeline into (eid, pipeline-signature)
lookups: the second wave of identical queries skips the whole pipeline
and the example prints the hit-rate / latency evidence.

  PYTHONPATH=src python examples/torch_serve_visual_queries.py [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.boundary import to_host  # noqa: E402
from repro_torch.core.engine import VDMSAsyncEngine  # noqa: E402
from repro_torch.core.remote import TransportModel  # noqa: E402
from repro_torch.core.udf import register_model_udf  # noqa: E402
from repro_torch.dataio import synthetic_video  # noqa: E402
from repro_torch.visual.ops import downsample  # noqa: E402

UDF = "lm_activity"
QUERY = [{"FindVideo": {
    "constraints": {"category": ["==", "activity"]},
    "operations": [
        {"type": "downsample", "fx": 2.0, "fy": 2.0},
        {"type": "udf", "port": 5555, "options": {"id": UDF}},
    ]}}]
# a stamped pixel is the label's intensity; any other differs from the
# downsampled clip by float rounding alone
STAMP_TOL = 1e-3


def stamped_pixels(out: np.ndarray, clip: np.ndarray) -> int:
    """The pixels of ``out`` that the label stamp changed from the
    downsampled ``clip``, or -1 if any changed pixel is not the stamp's
    intensity (1.0)."""
    plain = to_host(downsample(torch.from_numpy(clip)))
    changed = np.abs(out - plain) > STAMP_TOL
    if not np.all(np.abs(out[changed] - 1.0) <= STAMP_TOL):
        return -1
    return int(changed.sum())


def main(argv=None, *, params=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clips", type=int, default=6)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--cold-sessions", type=int, default=2)
    ap.add_argument("--warm-sessions", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    a = ap.parse_args(argv)

    # an assigned-arch LM (qwen3-0.6b: full width on the card, reduced
    # on the CPU) as an activity-classification UDF — prefill + decode
    # per entity batch
    reduced = torch.device(a.device).type == "cpu"
    t0 = time.time()
    register_model_udf(UDF, arch="qwen3-0.6b", reduced=reduced,
                       steps=a.steps, device=a.device, params=params)
    setup_s = time.time() - t0

    engine = VDMSAsyncEngine(
        device=a.device,
        num_remote_servers=2,
        transport=TransportModel(network_latency_s=0.002, service_time_s=0.0),
        coalesce_window_ms=5,   # cross-session remote coalescing
        cache_capacity=512,     # (eid, pipeline-signature) result cache
    )
    try:
        clips = {}
        for i in range(a.clips):
            clip = synthetic_video(a.frames, a.size, seed=i)
            clips[engine.add_entity("video", clip, {"category": "activity",
                                                    "clip": i})] = clip

        t0 = time.time()
        # concurrent sessions share the native pool and remote pool
        # fairly; each returns a future immediately
        futs = [engine.submit(QUERY) for _ in range(a.cold_sessions)]
        results = [f.result(timeout=600) for f in futs]
        t_cold = time.time() - t0
        entities = {eid: to_host(v)
                    for eid, v in results[0]["entities"].items()}
        failed = sum(r["stats"]["failed"] for r in results)
        print(f"processed {sum(len(r['entities']) for r in results)} clips "
              f"across {len(futs)} concurrent sessions in "
              f"{t_cold:.1f}s (failed={failed})")
        clip = next(iter(entities.values()))
        print("output clip shape:", clip.shape,
              "(frames carry the LM-predicted label stamp)")
        stamps = {eid: stamped_pixels(out, clips[eid])
                  for eid, out in entities.items()}

        # repeated-query traffic: the same query arrives again (the
        # serving steady state) and is answered from the result cache —
        # no LM inference, no remote dispatch, no Queue_1 work
        t0 = time.time()
        futs = [engine.submit(QUERY) for _ in range(a.warm_sessions)]
        warm = [f.result(timeout=600) for f in futs]
        t_warm = time.time() - t0
        hits = sum(r["stats"]["cache_full_hits"] for r in warm)
        cs = engine.cache_stats()
        print(f"repeat wave: {len(warm)} sessions in {t_warm*1e3:.1f} ms "
              f"({hits} full cache hits; cold wave took {t_cold:.1f}s -> "
              f"{t_cold/max(t_warm, 1e-9):.0f}x)")
        print(f"cache: hit_rate={cs['hit_rate']:.2f} "
              f"(full={cs['hits']} prefix={cs['prefix_hits']} "
              f"miss={cs['misses']}) size={cs['size']}/{cs['capacity']}")
        return {"setup_s": setup_s, "cold_s": t_cold, "failed": failed,
                "clips": sum(len(r["entities"]) for r in results),
                "shape": clip.shape, "entities": entities,
                "stamped_pixels": stamps, "warm_s": t_warm,
                "warm_sessions": len(warm),
                "warm_failed": sum(r["stats"]["failed"] for r in warm),
                "warm_hits": hits, "cache": cs}
    finally:
        engine.shutdown()


if __name__ == "__main__":
    main()
