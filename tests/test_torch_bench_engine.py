"""The port's engine benches (``benchmarks/torch_{dispatch_bench,
admission_bench,resilience_bench,hotpath,frontend_bench}.py``) on the
CPU, held against the JAX package's benches and engine.

Only the benches' arm functions run here (``run_static_hash``,
``run_mixed``, ``run_storm``, …), which write nothing; no bench's
``run()`` or ``main()``.  The gates asserted are those fixed by
construction: the recorded digests, identical and close responses, the
admission ledger's bounds, completion and leaks, the cache's
miss/hit split, the overload frame.  The gates read off wall clocks
(shed p99 within 3×, the storm's p99 factor) are the card's (phase 21
of ``chip_smoke.py``) and each bench's ``--check-baseline``.

Tolerances: bytes for the index/comparison workloads; 1e-5 absolute
between the port's and the reference's float responses (a resize and a
blur sum in another library's order).
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from benchmarks import (admission_bench, dispatch_bench, frontend_bench,
                        hotpath, resilience_bench)
from benchmarks import torch_admission_bench as t_adm
from benchmarks import torch_dispatch_bench as t_dsp
from benchmarks import torch_frontend_bench as t_fe
from benchmarks import torch_hotpath as t_hot
from benchmarks import torch_resilience_bench as t_res
from torch_parity import add_images, entities, find, ref_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _recorded(name):
    with open(os.path.join(ROOT, "benchmarks", name)) as f:
        return json.load(f)["sha256"]


DISPATCH_SHA = _recorded("dispatch_static_baseline.json")
ADMISSION_SHA = _recorded("admission_static_baseline.json")

# (port arm, reference arm, the digest's key in their rows, recorded)
HASHES = {
    "dispatch": (lambda: t_dsp.run_static_hash(device="cpu"),
                 dispatch_bench.run_static_hash, "static_response_sha256",
                 DISPATCH_SHA),
    "admission": (lambda: t_adm.run_static_hash(device="cpu"),
                  admission_bench.run_static_hash, "none_response_sha256",
                  ADMISSION_SHA),
    "resilience": (lambda: t_res.run_identity(device="cpu"),
                   resilience_bench.run_identity, "static_response_sha256",
                   DISPATCH_SHA),
    "frontend": (lambda: t_fe.run_wire_identity(device="cpu"),
                 frontend_bench.run_wire_identity, "wire_response_sha256",
                 DISPATCH_SHA),
}


@pytest.mark.parametrize("bench", sorted(HASHES))
def test_static_hash_equals_the_recorded_digest_beside_the_reference(bench):
    port_arm, ref_arm, key, recorded = HASHES[bench]
    (got,), (want,) = port_arm(), ref_arm()
    assert recorded.startswith(("778564da", "f9acbed1"))
    assert got[key] == want[key] == recorded
    assert got["name"] == want["name"]
    assert set(want) <= set(got)
    assert got["baseline_sha256"] == recorded
    assert got["derived"] == want["derived"] == 1.0


def test_dispatch_gates_fail_closed_without_a_baseline(monkeypatch):
    monkeypatch.setattr(t_dsp, "DISPATCH_BASELINE",
                        os.path.join(ROOT, "benchmarks", "absent.json"))
    (row,) = t_dsp.run_static_hash(device="cpu")
    assert row["baseline_sha256"] is None
    others = [{"name": f"dispatch_{k}_n0"}
              for k in ("mixed", "device", "device_fused")]
    (msg,) = t_dsp.gates(others + [row])
    assert msg.startswith("no recorded baseline")


# ---------------------------------------------------------- run_mixed
def _np_heavy(img, iters=8, dim=192):
    """The reference bench's ``dispatch_heavy`` (a closure inside its
    ``_register_ops``), verbatim."""
    a = np.resize(np.asarray(img, np.float32), (dim, dim))
    a = a / (np.linalg.norm(a) + 1e-6)
    for _ in range(iters):
        a = a @ a.T
        a = a / (np.abs(a).max() + 1e-6)
    h, w, c = np.asarray(img).shape
    bias = np.resize(a, (h, w, 1)).astype(np.float32)
    return np.clip(np.asarray(img) + 1e-3 * bias, 0.0, 1.0)


def test_heavy_udf_matches_the_reference_numpy_body():
    rng = np.random.default_rng(0)
    for shape in ((32, 32, 3), (20, 28, 3)):
        img = rng.uniform(0, 1, shape).astype(np.float32)
        got = t_dsp.heavy(torch.from_numpy(img)).numpy()
        np.testing.assert_allclose(got, _np_heavy(img), rtol=0, atol=1e-7)


@pytest.fixture(scope="module")
def qwen_tree():
    import jax
    from repro.configs import get_arch
    from repro.models import get_model
    return get_model(get_arch("qwen3-0.6b", reduced=True)).init(
        jax.random.PRNGKey(0))


def test_run_mixed_arms_identical_and_native_arm_equals_the_reference(
        qwen_tree):
    from repro.core.udf import register_model_udf, register_udf
    from repro_torch.configs import get_arch
    from repro_torch.interop import params_from_jax
    params = params_from_jax(qwen_tree, get_arch("qwen3-0.6b", reduced=True),
                             device="cpu")
    n = 4
    (row,) = t_dsp.run_mixed(n_images=n, size=48, lm_steps=2, device="cpu",
                             params=params, return_entities=True)
    assert row["name"] == f"dispatch_mixed_n{n}"
    assert row["responses_identical"]
    # every placement of the warm-up query (2 images) and the timed one
    assert row["placements"] == {"native": 2 * (n + 2), "remote": n + 2,
                                 "batcher": n + 2}
    assert row["batcher_groups"] >= 1
    # the reference engine, all-native, with the reference bench's UDFs
    # (its model UDF inits the same PRNGKey(0) tree)
    register_udf("dispatch_heavy", _np_heavy)
    register_model_udf("dispatch_lm", "qwen3-0.6b", steps=2)
    eng = ref_engine(dict(network_latency_s=0.015, service_time_s=0.0005),
                     num_remote_servers=4, dispatch_policy="least_loaded",
                     num_native_workers=2, dispatch="native")
    try:
        add_images(eng, n, 48, "dsp", 11)
        want = entities(eng.execute(find("dsp", t_dsp.MIXED_PIPE),
                                    timeout=600))
    finally:
        eng.shutdown()
    got = row["entities"]["native"]
    assert list(got) == list(want)
    for eid in want:
        np.testing.assert_allclose(got[eid], want[eid], rtol=0, atol=TOL)


# --------------------------------------------- device and fused arms
def _ref_device_arm(pipe, fuse, n, size):
    """The reference engine through the knobs of the device arm
    (``fuse`` None: the blur alone pinned onto the device) or of the
    fused arm (every op pinned, ``device_fuse_segments=fuse``)."""
    pin = {"device": 1e-6, "native": 10.0, "remote": 10.0, "batcher": 10.0}
    kw = dict(dispatch="cost", device_backend="cpu", device_batch_size=8,
              num_native_workers=2)
    if fuse is None:
        kw.update(device_max_wait_ms=150.0, cost_overrides={"blur": pin})
    else:
        kw.update(device_max_wait_ms=25.0, device_fuse_segments=fuse,
                  cost_overrides={o["type"]: pin for o in pipe})
    eng = ref_engine(dict(network_latency_s=0.002, service_time_s=0.001),
                     **kw)
    try:
        add_images(eng, n, size, "dsp", 11)
        return entities(eng.execute(find("dsp", pipe), timeout=600))
    finally:
        eng.shutdown()


DEVICE_PIPE = [{"type": "resize", "width": 64, "height": 64},
               {"type": "blur", "ksize": 9, "sigma_x": 2.0}]
FUSED_PIPE = [{"type": "resize", "width": 64, "height": 64},
              {"type": "crop", "x": 8, "y": 8, "width": 48, "height": 48},
              {"type": "normalize", "mean": 0.45, "std": 0.22},
              {"type": "blur", "ksize": 9, "sigma_x": 2.0}]


@pytest.mark.parametrize("arm", ["device", "fused"])
def test_device_arms_within_tolerance_of_the_reference(arm):
    n = 8
    if arm == "device":
        (row,) = t_dsp.run_device(n_images=n, size=72, device="cpu",
                                  return_entities=True)
        assert row["device_platform"] == "cpu"
        assert row["placements"]["device"] == n + 8    # + the warm-up
        pairs = [("device", _ref_device_arm(DEVICE_PIPE, None, n, 72))]
    else:
        (row,) = t_dsp.run_device_fused(n_images=n, size=72, device="cpu",
                                        return_entities=True)
        assert row["fused_segments"] > 0 and row["segment_ops"] == 4
        pairs = [("fused", _ref_device_arm(FUSED_PIPE, True, n, 72)),
                 ("unfused", _ref_device_arm(FUSED_PIPE, False, n, 72))]
    assert row["responses_close"]
    assert max(row["max_abs_err"].values()) <= TOL
    for key, want in pairs:
        got = row["entities"][key]
        assert list(got) == list(want)
        for eid in want:
            np.testing.assert_allclose(got[eid], want[eid], rtol=0,
                                       atol=TOL)


# ------------------------------------------------------------ storms
def test_admission_storm_bounds_in_flight_and_answers_every_query():
    (row,) = t_adm.run_storm(fanout=4, max_inflight=8, storm_factor=10,
                             service_ms=3.0, servers=4, device="cpu")
    assert row["name"] == "admission_storm_x10_cap8"
    assert row["shed_inflight_bounded"] and row["queue_inflight_bounded"]
    assert row["storm_queries"] == 20
    assert row["none"]["completed"] == 20 and row["none"]["shed"] == 0
    assert row["queue"]["completed"] == 20 and row["queue"]["shed"] == 0
    assert row["shed"]["completed"] + row["shed"]["shed"] == 20
    assert row["shed"]["completed"] >= 1
    assert row["shed"]["peak_inflight"] <= 8
    assert t_adm.gates([row] + t_adm.run_static_hash(device="cpu"),
                       timing=False) == []


def test_resilience_storm_completes_without_leaks():
    (row,) = t_res.run_storm(n_queries=24, n_images=8, device="cpu")
    assert row["name"] == "resilience_storm_q24"
    assert row["completion_rate"] == 1.0 and row["failed_entities"] == 0
    assert row["admission_leaks"] == 0
    assert row["peak_inflight"] <= row["inflight_cap"] == 16
    assert sum(row["injected"]["injected"].values()) > 0
    assert math.isfinite(row["p99_factor"])
    assert t_res.gates(t_res.run_identity(device="cpu") + [row],
                       timing=False) == []


# ------------------------------------------------------------ hot path
def test_cache_split_equals_the_reference_and_responses_match():
    (got,) = t_hot.run_cache(n_images=8, size=48, device="cpu")
    (want,) = hotpath.run_cache(n_images=8, size=48)
    for key in ("name", "cold_misses", "warm_hits", "full_hits",
                "hit_rate", "warm_hit_rate"):
        assert got[key] == want[key], key
    assert got["identical_to_cache_off"] and want["identical_to_cache_off"]


def test_coalesced_responses_identical_to_per_entity_dispatch():
    (row,) = t_hot.run_coalesce(fanout=16, sessions=2, size=32,
                                device="cpu")
    assert row["name"] == "hotpath_coalesce_f16x2"
    assert row["identical_to_per_entity"]
    assert row["requests_per_entity"] == 3 * 16     # warm-up + 2 sessions
    assert row["requests_coalesced"] < row["requests_per_entity"]
    assert row["coalesced_entities"] > 0
    assert t_hot.gates(t_hot.run_cache(n_images=4, size=32, device="cpu")
                       + [row]) == []


# ------------------------------------------------------------ front end
def test_wire_overhead_responses_identical():
    (row,) = t_fe.run_wire_overhead(n_images=8, size=32, repeats=2,
                                    device="cpu")
    assert row["name"] == "frontend_wire_overhead_n8"
    assert row["responses_identical"]


def test_overload_gate_answers_with_retry_after_and_serves_the_cache():
    (row,) = t_fe.run_overload_gate(device="cpu")
    assert row["overload_answered"]
    assert 0 < row["retry_after_s"] < float("inf")
    assert row["cache_served_while_saturated"]
    assert row["cache_full_hits"] == 4
    assert row["gate_ok"] and row["derived"] == 1.0
