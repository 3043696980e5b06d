#!/usr/bin/env python3
"""Quickstart on the PyTorch port: stand up VDMS-Async on the CUDA card,
ingest images, run a mixed native/remote pipeline (the paper's Fig 8
query) — blocking and as an async session with per-entity streaming —
then inspect results.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core.boundary import to_host  # noqa: E402
from repro_torch.core.engine import VDMSAsyncEngine  # noqa: E402
from repro_torch.core.remote import TransportModel  # noqa: E402
from repro_torch.dataio import synthetic_faces  # noqa: E402

# the paper's running example (Fig 8): constraints + a pipeline of
# Resize (native) -> FaceDetect+Box (remote) -> Threshold (native)
QUERY = [{"FindImage": {
    "constraints": {"category": ["==", "celebrity"],
                    "age": [">=", 21, "<=", 40]},
    "operations": [
        {"type": "resize", "width": 64, "height": 80},
        {"type": "remote", "url": "http://remote/facedetect",
         "options": {"id": "facedetect_box"}},
        {"type": "threshold", "value": 0.35},
    ]}}]


def ingest(engine, faces) -> None:
    """LFW-like face images with the example's metadata."""
    for i, img in enumerate(faces):
        engine.add_entity("image", img, {
            "category": "celebrity", "name": f"person_{i}",
            "age": 18 + (i * 7) % 50})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--faces", type=int, default=64)
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--servers", type=int, default=4)
    a = ap.parse_args(argv)

    # engine with simulated remote servers (each a worker thread with a
    # network/compute cost model), its native ops on the device
    engine = VDMSAsyncEngine(
        device=a.device,
        num_remote_servers=a.servers,
        transport=TransportModel(network_latency_s=0.002, service_time_s=0.005),
        fuse_native=True,
    )
    try:
        ingest(engine, synthetic_faces(a.faces, size=a.size))

        res = engine.execute(QUERY, timeout=120)
        entities = {eid: to_host(v) for eid, v in res["entities"].items()}
        print(f"matched {res['stats']['matched']} entities, "
              f"failed {res['stats']['failed']}, "
              f"took {res['stats']['duration_s']:.2f}s")
        some = next(iter(entities.values()))
        values = sorted(np.unique(some).tolist())
        print(f"output entity shape: {some.shape} "
              f"(values in {{0,1}} after threshold: {values[:4]})")

        # the same query as an async session: submit() returns a future
        # immediately; entities stream back as their pipelines finish
        streamed = []
        future = engine.submit(QUERY,
                               on_entity=lambda e: streamed.append(e.eid))
        print(f"submitted query {future.query_id}; doing other work ...")
        res2 = future.result(timeout=120)
        print(f"session {future.query_id} done: {len(res2['entities'])} "
              f"entities, {len(streamed)} streamed callbacks")
        utilization = engine.utilization()
        print("engine utilization:", utilization)
        return {"matched": res["stats"]["matched"],
                "failed": res["stats"]["failed"],
                "duration_s": res["stats"]["duration_s"],
                "shape": some.shape, "values": values,
                "entities": entities,
                "session_entities": {eid: to_host(v) for eid, v
                                     in res2["entities"].items()},
                "session_failed": res2["stats"]["failed"],
                "streamed": len(streamed), "utilization": utilization}
    finally:
        engine.shutdown()


if __name__ == "__main__":
    main()
