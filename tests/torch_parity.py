"""Helpers shared by the engine-stack parity tests (``tests/test_torch_{
sessions,dispatch,admission,resilience,device_backend,device_fusion,
result_cache,coalescing,straggler,storage_query}.py``).

Each of those files ports one of the JAX package's own engine test
files to ``repro_torch``: the same scenario, data from the same seeds,
the same assertions.  Where the scenario's answer is fixed, the file
also runs it on the JAX package's engine and compares the two answers
here: byte for byte for pipelines of index and comparison ops, within
``TOL`` (one float op) or ``PIPE_TOL`` (a whole float chain) otherwise.

The port's engine runs with ``device="cpu"`` and, where a device
backend is asked for, ``device_backend="cpu"``: the plain versions of
K1 and K2 stand in for the kernels there.  The port's UDFs take and
return torch tensors (``repro_torch/core/udf.py``); the JAX package's
take arrays.  UDF names carry a ``t_`` prefix so that they never meet
the reference tests' names in a worker process that runs both.
"""
from __future__ import annotations

import time

import numpy as np

from repro.core.engine import VDMSAsyncEngine as RefEngine
from repro.core.remote import TransportModel as RefTransport
from repro_torch.core.boundary import to_host
from repro_torch.core.engine import VDMSAsyncEngine
from repro_torch.core.remote import TransportModel

# absolute tolerances on float32 values of magnitude <= ~3: one float
# op (resize, normalize, blur), and a whole chain of them
TOL = 1e-5
PIPE_TOL = 1e-4

FAST = dict(network_latency_s=0.001, service_time_s=0.002)
SLOW = dict(network_latency_s=0.001, service_time_s=0.05)


def port_engine(transport=None, **kw) -> VDMSAsyncEngine:
    """The port's engine on the CPU; ``transport`` is a dict of
    ``TransportModel`` fields (default ``FAST``), 2 remote servers
    unless given."""
    kw.setdefault("num_remote_servers", 2)
    return VDMSAsyncEngine(device="cpu",
                           transport=TransportModel(**(transport or FAST)),
                           **kw)


def ref_engine(transport=None, **kw) -> RefEngine:
    """The JAX package's engine with the same knobs."""
    kw.setdefault("num_remote_servers", 2)
    return RefEngine(transport=RefTransport(**(transport or FAST)), **kw)


def add_images(eng, n, size, category, seed, props=None):
    """``n`` uniform (size, size, 3) float32 images from
    ``default_rng(seed)``, as the reference files' ``_add_images``;
    ``props(i)`` adds properties.  Returns the eids."""
    rng = np.random.default_rng(seed)
    ids = []
    for i in range(n):
        img = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
        extra = props(i) if props else {"idx": i}
        ids.append(eng.add_entity("image", img,
                                  {"category": category, **extra}))
    return ids


def find(category, ops, kind="FindImage"):
    return [{kind: {"constraints": {"category": ["==", category]},
                    "operations": ops}}]


def entities(res) -> dict:
    """A response's entities as host arrays, in response order."""
    return {eid: to_host(v) for eid, v in res["entities"].items()}


def assert_same(got, want, atol=None):
    """Two responses (or entity dicts) hold the same eids in the same
    order and the same arrays: equal bytes when ``atol`` is None, else
    within ``atol``."""
    g = entities(got) if "entities" in got else got
    w = entities(want) if "entities" in want else want
    assert list(g) == list(w)
    for eid in w:
        assert g[eid].shape == w[eid].shape, eid
        assert g[eid].dtype == w[eid].dtype, eid
        if atol is None:
            np.testing.assert_array_equal(g[eid], w[eid])
        else:
            np.testing.assert_allclose(g[eid], w[eid], atol=atol, rtol=0)


def run(make, scenario):
    """``scenario(engine)`` on an engine from ``make()``, shut down
    after."""
    eng = make()
    try:
        return scenario(eng)
    finally:
        eng.shutdown()


def wait(pred, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True
