"""PyTorch/CUDA port of the VDMS-Async visual query engine.

The package mirrors the JAX package ``repro`` module for module and is
held against it by the ``tests/test_torch_*.py`` parity tests; it
imports neither JAX nor anything of ``repro``.  Entry points run on the
CUDA card unless the caller asks for the CPU (``device="cpu"``).

Seven methods carry other names than their counterparts in ``repro``:
``VDMSAsyncEngine._expand_plan``, ``QueryPlanner.expand_plan``,
``MetadataStore.find_ids``, ``ResultCache.longest_cached_prefix``,
``OpCostTracker.mean_cost_estimate``,
``RemoteServerPool.backlog_estimate_s`` and ``RemoteServer.pending_load``.
The repo's analyzer (``python -m repro.analysis``) resolves an
``obj.method()`` call only when one class in ``src/`` defines that
method name; shared names would hide the lock-order edges it finds
through those calls, in both packages.
"""
