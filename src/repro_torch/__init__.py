"""PyTorch/CUDA port of the VDMS-Async visual query engine, its
baselines, its sharded cluster and wire front end, and the
model-serving path behind its model UDF.

The package mirrors the JAX package ``repro`` module for module and is
held against it by the ``tests/test_torch_*.py`` parity tests; it
imports neither JAX nor anything of ``repro``.  Entry points run on the
CUDA card unless the caller asks for the CPU (``device="cpu"``).

Ten methods carry other names than their counterparts in ``repro``:
``VDMSAsyncEngine._expand_plan``, ``QueryPlanner.expand_plan``,
``MetadataStore.find_ids``, ``ResultCache.longest_cached_prefix``,
``OpCostTracker.mean_cost_estimate``,
``RemoteServerPool.backlog_estimate_s``, ``RemoteServer.pending_load``,
``ShardedEngine._assign_eid`` (``_new_eid``),
``ShardedEngine.owner_preference`` (``ring_preference``) and
``HashRing.shard_count`` (``num_shards``).  The repo's analyzer
(``python -m repro.analysis``) resolves an ``obj.method()`` call only
when one class in ``src/`` defines that method name; shared names would
hide the lock-order edges it finds through those calls, in both
packages (the last three keep ``ClusterQuery._cv`` above
``ShardedEngine._lock`` and ``HashRing._lock``).
"""
