"""Network front-end launcher: put a VDMS-Async engine on the wire.

  PYTHONPATH=src python -m repro_torch.launch.serve --port 7710 \
      --num-remote-servers 2 --admission shed --max-inflight 256
  PYTHONPATH=src python -m repro_torch.launch.serve --shards 4 --device cpu

Builds an engine (optionally a sharded cluster with ``--shards N``),
wraps it in :class:`repro_torch.serving.frontend.WireFrontend`, and serves
the SSE-flavored wire protocol (:mod:`repro_torch.serving.wire`) until
interrupted: ``submit`` frames return query tokens, per-entity results
stream back as they complete, overload answers 429-style frames with
``retry_after_s``, and client disconnects cancel their in-flight
queries.

Every engine, or every shard of a cluster, runs its pipelines on
``--device``: the CUDA card by default (the launcher raises on a host
without one), or ``--device cpu``.  The batched prefill/decode *model*
launcher is ``repro_torch.launch.model_serve``.
"""
from __future__ import annotations

import argparse
import time


def build_engine(args):
    """Engine (or cluster) per the CLI knobs.  Split out so tests can
    build the exact launcher configuration in-process."""
    kw = dict(device=args.device,
              num_remote_servers=args.num_remote_servers,
              num_native_workers=args.num_native_workers,
              admission=args.admission)
    if args.admission != "none":
        kw["max_inflight_entities"] = args.max_inflight
        if args.tenants:
            weights = {}
            for spec in args.tenants.split(","):
                name, _, w = spec.partition("=")
                weights[name] = float(w) if w else 1.0
            kw["admission_tenants"] = weights
        if args.cost_cap_s > 0:
            kw["admission_cost_aware"] = True
            kw["admission_cost_cap_s"] = args.cost_cap_s
    if args.shards > 1:
        from repro_torch.cluster.engine import ShardedEngine
        return ShardedEngine(num_shards=args.shards,
                             replica_factor=args.replica_factor, **kw)
    from repro_torch.core.engine import VDMSAsyncEngine
    return VDMSAsyncEngine(**kw)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="serve the VDMS-Async wire protocol")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda",
                    help="the torch device every engine or shard runs its "
                         "pipelines on: cuda (the default), cuda:<i> or cpu")
    ap.add_argument("--port", type=int, default=7710)
    ap.add_argument("--num-remote-servers", type=int, default=2)
    ap.add_argument("--num-native-workers", type=int, default=None)
    ap.add_argument("--shards", type=int, default=1,
                    help="> 1 fronts a ShardedEngine cluster")
    ap.add_argument("--replica-factor", type=int, default=1)
    ap.add_argument("--admission", default="none",
                    choices=("none", "queue", "shed"))
    ap.add_argument("--max-inflight", type=int, default=256)
    ap.add_argument("--tenants", default="",
                    help="comma-separated tenant=weight quota table, "
                         "e.g. 'gold=3,bronze=1'")
    ap.add_argument("--cost-cap-s", type=float, default=0.0,
                    help="> 0 enables cost-aware admission against this "
                         "work-seconds budget")
    args = ap.parse_args(argv)

    from repro_torch.serving.frontend import WireFrontend

    engine = build_engine(args)
    front = WireFrontend(engine, host=args.host, port=args.port).start()
    print(f"[serve] wire front-end on {front.address[0]}:"
          f"{front.address[1]} (admission={args.admission}, "
          f"shards={args.shards}, device={args.device})", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        print("[serve] shutting down")
    finally:
        front.close()
        engine.shutdown()


if __name__ == "__main__":
    main()
