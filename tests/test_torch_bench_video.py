"""The port's video suite (``benchmarks/torch_video_suite.py``: C1–C3
and cputrace, paper Figs 18–28) on the CPU at 2 videos × 3 frames.

- Each suite's rows carry the reference's names and keys
  (``benchmarks/video_suite.py``, ``benchmarks/cpu_trace.py``) and every
  system's response is within ``VIDEO_TOL`` (1e-5) of the port's async
  engine's (in practice equal: the same ops on the same device).
- The port's async engine's outputs are within 1e-5 of the JAX
  package's engine on the same ``video_set``, query by query: the
  reference's ``common.run_async_engine`` returns no outputs, so its
  engine is driven here through ``tests/torch_parity.py``.
- The real-size run's rows at a small (H, W): the suffix, and H ≠ W.
"""
import numpy as np
import pytest

from benchmarks import torch_common as tc
from benchmarks import torch_video_suite as tv
from torch_parity import ref_engine

N, FRAMES = 2, 3
TOL = 1e-5

C1_KEYS = {"name", "us_per_call", "derived", "sync_s", "scanner_s",
           "async_s", "frames_per_s"}
C2_KEYS = {"name", "us_per_call", "derived", "sync_s", "pool_s",
           "scanner_s", "async_s"}
C3_KEYS = {"name", "us_per_call", "derived", "sync_s", "async_s"}
CPUTRACE_NAMES = ["cputrace_sync_vdms", "cputrace_postgres_pool",
                  "cputrace_scanner_frames", "cputrace_vdms_async"]


def _within(rows):
    for r in rows:
        errs = r["max_abs_err"]
        for err in (errs.values() if isinstance(errs, dict) else [errs]):
            assert err <= TOL, r["name"]
    assert tv.gates(rows, "cpu") == []


def test_video_set_equals_the_reference_data():
    from repro.dataio import synthetic_video
    got = tc.video_set(N, frames=FRAMES)
    want = np.stack([synthetic_video(FRAMES, 48, seed=i) for i in range(N)])
    np.testing.assert_array_equal(got, want)
    assert tc.video_set(1, frames=2, size=(24, 40)).shape == (1, 2, 24, 40, 3)


def test_c1_rows_every_system_within_tolerance():
    rows = tv.run_c1("cpu", N, FRAMES)
    assert [r["name"] for r in rows] == [f"video_c1_{q}"
                                         for q in tc.video_queries()]
    for r in rows:
        assert C1_KEYS <= set(r)
        assert set(r["max_abs_err"]) == {"sync", "frame"}
    _within(rows)


def test_c2_and_c3_rows_every_system_within_tolerance():
    rows = tv.run_c2("cpu", N, FRAMES) + tv.run_c3("cpu", N, FRAMES,
                                                   clients=(2,))
    assert [r["name"] for r in rows] == ["video_c2_pipeline",
                                         "video_c3_2clients"]
    assert C2_KEYS <= set(rows[0]) and C3_KEYS <= set(rows[1])
    assert set(rows[0]["max_abs_err"]) == {"sync", "pool", "frame"}
    _within(rows)


def test_cputrace_rows_busy_fractions():
    rows = tv.run_cputrace("cpu", N, FRAMES)
    assert [r["name"] for r in rows] == CPUTRACE_NAMES
    for r in rows:
        assert 0.0 <= r["derived"] <= 1.0 + 1e-6, r
    assert rows[-1]["speedup_vs_sync"] > 0
    _within(rows)


def test_real_size_rows_carry_their_size():
    q = dict(list(tc.video_queries().items())[:1])
    rows = (tv.run_c1("cpu", 1, 2, queries=q, size=(40, 56))
            + tv.run_c2("cpu", 1, 2, size=(40, 56)))
    assert [r["name"] for r in rows] == ["video_c1_VQ1_select_40x56",
                                         "video_c2_pipeline_40x56"]
    _within(rows)


def _reference_outputs(data, ops):
    """The JAX package's engine over ``data`` as videos: arrays in
    ingest order."""
    eng = ref_engine(num_remote_servers=2, num_native_workers=1,
                     fair_scheduling=False)
    try:
        eids = [eng.add_entity("video", v, {"category": "bench", "idx": i})
                for i, v in enumerate(data)]
        res = eng.execute([{"FindVideo": {
            "constraints": {"category": ["==", "bench"]},
            "operations": ops}}], timeout=600)
        assert res["stats"]["failed"] == 0
        return [np.asarray(res["entities"][e]) for e in eids]
    finally:
        eng.shutdown()


QUERIES = {**tc.video_queries(), "C2": tc.video_c2_pipeline(),
           "cputrace": tv.CPUTRACE_OPS}


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_async_outputs_match_the_reference_engine(query):
    ops = QUERIES[query]
    size = 64 if query == "cputrace" else 48
    data = tc.video_set(N, frames=FRAMES, size=size)
    got = tc.run_async_engine(data, ops, device="cpu", video=True,
                              transport=tc.TransportModel(
                                  network_latency_s=0.001,
                                  service_time_s=0.002))["outputs"]
    want = _reference_outputs(data, ops)
    assert len(got) == len(want) == N
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


@pytest.mark.parametrize("full", [False, True])
def test_run_harness_video_suite_is_the_suites_own_plan(monkeypatch, full):
    """``torch_run``'s video suite runs ``run_all``'s plan (no copy of
    its sizes), without cputrace, which ``torch_run`` runs as its own
    suite; the suites come in ``SUITES``' order."""
    from benchmarks import torch_run
    calls = []

    def run_all(device, **kw):
        calls.append((device, kw))
        return {"c1": [{"name": "a"}], "c2": [{"name": "b"}],
                "seconds": {"c1": 0.0, "c2": 0.0}}

    monkeypatch.setattr(tv, "run_all", run_all)
    suites = torch_run.suites("cpu", full)
    assert tuple(suites) == torch_run.SUITES
    assert [r["name"] for r in suites["video"]()] == ["a", "b"]
    assert calls == [("cpu", dict(full=full, real=full, cputrace=False))]
