"""Baseline executors the paper compares against (section 6.3).

All share the engine's metadata/storage/op substrate and the SAME
transport model for remote ops, so benchmark deltas isolate the
*execution architecture*:

- SyncExecutor      (VDMS):        one thread, run-to-completion per
                                   entity; blocks on every remote op.
- PooledExecutor    (PostgreSQL):  P worker processes-worth of threads;
                                   each runs full pipelines synchronously
                                   — parallel, but every worker still
                                   idle-waits on its remote calls.
- FrameExecutor     (Scanner):     frame-level computation graph: videos
                                   are exploded into frames, every op runs
                                   frame-by-frame with a worker pool, and
                                   frames are re-assembled (no async
                                   native/remote overlap).

Devices: each executor runs its ops on one torch device (``device``, the
CUDA card by default; a CUDA request on a host without one raises when
the executor is built).  An entity's data crosses the host boundary
(:mod:`repro_torch.core.boundary`) as it does in the engine: to the
device when its run starts, back to a host array when it ends
(``FrameExecutor``: per frame).  A native op that leaves a CUDA tensor
is waited for (its stream synchronised) before the next op starts —
VDMS's run-to-completion, and what the reference's ``block_until_ready``
does.  The baselines and the engine so run the same ops on the same
card.
"""
from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core.boundary import resolve_device, to_device, to_host
from repro_torch.core.entity import ERD, Entity
from repro_torch.core.event_loop import BusyMeter
from repro_torch.core.pipeline import Operation, run_op
from repro_torch.core.remote import RemoteServerPool


def _run_native(op: Operation, data):
    """One native op, run to completion: a CUDA result's stream is
    synchronised before the caller moves on."""
    out = run_op(op, data)
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.current_stream(out.device).synchronize()
    return out


class _SyncRemote:
    """Blocking remote call against the shared pool (one reply queue)."""

    def __init__(self, pool: RemoteServerPool):
        self.pool = pool

    def call(self, entity, op: Operation):
        reply: queue.Queue = queue.Queue()
        self.pool.dispatch(entity, op, reply)
        while True:
            tag, req, payload = reply.get()
            status, result = self.pool.handle_response(tag, req, payload)
            if status == "done":
                return result
            if status == "failed":
                raise RuntimeError(f"remote op failed: {payload}")
            # requeued -> keep waiting on the same reply queue


class SyncExecutor:
    """VDMS: synchronous run-to-completion, one entity at a time."""

    def __init__(self, pool: RemoteServerPool, device: str = "cuda"):
        self.device = resolve_device(device)
        self.remote = _SyncRemote(pool)
        self.meter = BusyMeter()

    def run(self, entities: list[Entity],
            erd: ERD | None = None) -> list[Entity]:
        erd = erd or ERD()
        for ent in entities:
            self.meter.start()
            ent.data = to_device(ent.data, self.device)
            for op in ent.ops:
                if op.is_native:
                    ent.data = _run_native(op, ent.data)
                else:
                    self.meter.stop()          # idle-wait on the remote
                    ent.data = self.remote.call(ent, op)
                    self.meter.start()
                ent.op_index += 1
                erd.update(ent, f"sync:{op.name}")
            ent.data = to_host(ent.data)
            self.meter.stop()
        return entities


class PooledExecutor:
    """PostgreSQL-style: P parallel workers, each fully synchronous."""

    def __init__(self, pool: RemoteServerPool, workers: int = 8,
                 device: str = "cuda"):
        self.device = resolve_device(device)
        self.pool = pool
        self.workers = workers
        self.meter = BusyMeter()

    def run(self, entities: list[Entity],
            erd: ERD | None = None) -> list[Entity]:
        erd = erd or ERD()
        remote = _SyncRemote(self.pool)

        def work(ent: Entity):
            ent.data = to_device(ent.data, self.device)
            for op in ent.ops:
                if op.is_native:
                    ent.data = _run_native(op, ent.data)
                else:
                    ent.data = remote.call(ent, op)
                ent.op_index += 1
                erd.update(ent, f"pool:{op.name}")
            ent.data = to_host(ent.data)
            return ent

        self.meter.start()
        with ThreadPoolExecutor(max_workers=self.workers) as ex:
            list(ex.map(work, entities))
        self.meter.stop()
        return entities


class FrameExecutor:
    """Scanner-style frame graph: ops applied frame-by-frame, results
    written row-wise, then re-assembled; parallel over frames."""

    def __init__(self, pool: RemoteServerPool, workers: int = 8,
                 device: str = "cuda"):
        self.device = resolve_device(device)
        self.pool = pool
        self.workers = workers
        self.meter = BusyMeter()

    def run(self, entities: list[Entity],
            erd: ERD | None = None) -> list[Entity]:
        erd = erd or ERD()
        remote = _SyncRemote(self.pool)

        def frame_work(args):
            frame, ops, ent = args
            shim = Entity(eid=ent.eid, kind="image",
                          data=to_device(frame, self.device), ops=list(ops))
            for op in ops:
                if op.is_native:
                    shim.data = run_op(op, shim.data)
                else:
                    shim.data = remote.call(shim, op)
            return to_host(shim.data)

        self.meter.start()
        with ThreadPoolExecutor(max_workers=self.workers) as ex:
            for ent in entities:
                data = to_host(ent.data)
                frames = data if ent.kind == "video" else data[None]
                rows = list(ex.map(frame_work,
                                   [(f, ent.ops, ent) for f in frames]))
                try:
                    out = np.stack(rows)
                except ValueError:   # ops changed per-frame shape
                    out = rows
                ent.data = out if ent.kind == "video" else rows[0]
                ent.op_index = len(ent.ops)
                erd.update(ent, "frame:done")
        self.meter.stop()
        return entities
