"""The readers of the program's own spans and counters
(``harness/program_trace.py`` and the metrics built on it) on the CPU:
each cell's small configuration runs through an engine, the readers
take the differences of the device backend's ``trace`` block between
the window's two snapshots, and each gives a finite, non-negative value
(the CUDA-only allocation count gives none).  And the model UDF's own
report of the calls it served holds what ``ServeRecorder`` captures on
the same run."""
import math
import time

import numpy as np
import pytest
import torch

import _paths  # noqa: F401
from harness import cell, spec
from harness.hooks import ServeRecorder
from test_vdmsbench_cell import _few_threads, _small  # noqa: F401

SEED = 2**33 + 5
NEW = {"find_ms", "boundary_ms_per_image", "batch_wait_ms",
       "device_mallocs_per_group", "udf_host_ms_per_image",
       "prefill_us_per_token", "decode_step_ms"}
CUDA_ONLY = {"device_mallocs_per_group"}
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _entries(bench, name):
    return [m for m in spec.metrics(bench, name, True) if m["name"] in NEW]


@pytest.mark.parametrize("name", CELLS)
def test_the_new_readers_read_each_cell(name):
    bench, cfg, mix = _small(name)
    wanted = _entries(bench, name)
    assert wanted, name
    # the per-layer readers, run where an untraced run runs its
    # end-to-end ones: over the window's start and end snapshots
    res = cell.run(name, SEED, 0.3, False, t_start=time.monotonic(),
                   device="cpu", bench=dict(bench, end_to_end=wanted),
                   config=cfg, traffic=mix, program_reduced=True)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert set(got) == {m["name"] for m in wanted} - CUDA_ONLY
    for metric, v in got.items():
        assert math.isfinite(v["value"]) and v["value"] >= 0, (metric, v)


def test_the_readers_give_nothing_without_the_programs_trace():
    """A program without the ``trace`` block (one that keeps no spans)
    leaves every new metric out."""
    stats = {"groups_run": 3, "entities_run": 9}
    run = cell.Run(cell="x", config={}, traffic={}, seconds=1.0,
                   setup_s=0.0, window_s=1.0, steady_s=1.0, queries=[],
                   udf_calls=[], backend=(dict(stats), dict(stats)),
                   trace=None, model=None)
    for metric in NEW:
        assert spec.reader(metric).read(run) is None, metric


def test_the_readers_take_differences():
    def snap(n, s, rows, mallocs):
        return {"groups_run": n, "entities_run": rows,
                "trace": {"spans": {"query.find": [n, s],
                                    "boundary.in": [n, s],
                                    "boundary.out": [rows, 2 * s],
                                    "device.wait": [rows, 4 * s],
                                    "udf.prompts": [n, s],
                                    "udf.stamp": [n, s],
                                    "udf.prefill": [n, s],
                                    "udf.decode": [3 * n, 3 * s]},
                          "counters": {"udf.rows": rows,
                                       "udf.prefill_tokens": 3 * rows,
                                       "device.mallocs": mallocs}}}
    run = cell.Run(cell="x", config={}, traffic={}, seconds=1.0,
                   setup_s=0.0, window_s=1.0, steady_s=1.0, queries=[],
                   udf_calls=[],
                   backend=(snap(2, 1.0, 20, 7), snap(6, 3.0, 60, 15)),
                   trace=None, model=None)
    want = {"find_ms": 1e3 * 2.0 / 4, "boundary_ms_per_image":
            1e3 * (2.0 + 4.0) / 40, "batch_wait_ms": 1e3 * 8.0 / 40,
            "device_mallocs_per_group": 8 / 4,
            "udf_host_ms_per_image": 1e3 * 4.0 / 40,
            "prefill_us_per_token": 1e6 * 2.0 / 120,
            "decode_step_ms": 1e3 * 6.0 / 12}
    for metric, value in want.items():
        assert spec.reader(metric).read(run) == pytest.approx(value), metric


def test_the_routes_report_is_what_the_serve_recorder_captures():
    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.core.udf import (register_model_udf, served_calls,
                                      unregister_udf)
    name = "t_vdmsbench_report"
    arch = "rwkv6-1.6b"
    recorder = ServeRecorder()
    with recorder.registering():
        register_model_udf(name, arch=arch, steps=4, reduced=True,
                           device="cpu")
    recorder.wrap_device_route(name)
    eng = VDMSAsyncEngine(
        device="cpu", dispatch="cost", device_backend="cpu",
        device_batch_size=8, device_max_wait_ms=50.0,
        cost_overrides={name: {"device": 1e-6, "native": 10.0,
                               "remote": 10.0, "batcher": 10.0}})
    try:
        rng = np.random.default_rng(3)
        for i in range(12):
            eng.add_entity("image", rng.uniform(0, 1, (20, 20, 3))
                           .astype(np.float32), {"group": i // 6})
        futs = [eng.submit([{"FindImage": {
            "constraints": {"group": ["==", g]},
            "operations": [{"type": "udf", "options": {"id": name}}]}}])
            for g in range(2)]
        assert all(f.result(120)["stats"]["failed"] == 0 for f in futs)
        captured = recorder.host_calls()
        reported = served_calls(name)
    finally:
        eng.shutdown()
        unregister_udf(name)
    assert len(captured) == len(reported) >= 1
    assert sum(c["rows"] for c in reported) == 12
    for cap, rep in zip(captured, reported):
        assert rep["rows"] == cap["rows"]
        assert rep["passes"] == cap["passes"]
        assert torch.equal(rep["prompt"].to(torch.int64), cap["prompt"])
        assert torch.equal(rep["tokens"].to(torch.int64), cap["tokens"])
