"""The port's four examples (``examples/torch_*.py``) on the CPU, each
held against the JAX package where the answer is fixed.

- quickstart: the Fig 8 query over 16 faces, both as the example runs
  it and on the JAX engine with the same faces, metadata and query:
  the same matches, failures, eids and arrays, bit for bit (the resize
  is a product of interpolation matrices in both packages, with the
  same float32 sums; a difference would flip a thresholded pixel);
- serve_visual_queries: reduced qwen3-0.6b on the JAX package's weights
  (``interop.params_from_jax``) against the JAX engine running the
  reference example's UDF over the same clips: the same labels stamped
  at the same pixels, every other pixel within ``CLIP_TOL``; the warm
  wave's 24 full cache hits;
- train_lm: reduced, 6 steps with a checkpoint every 3, then a rerun
  that resumes; ``register_100m``'s config equal to the reference
  example's (both registries restored after, so that ``qwen3-100m``
  does not leak into other tests of the worker);
- scaleout_bench: one printed line per kappa, each the row
  ``benchmarks/torch_suite.run_kappa`` returned.
"""
import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base, get_arch as ref_arch
from repro.core.engine import VDMSAsyncEngine as RefEngine
from repro.core.remote import TransportModel as RefTransport
from repro.core.udf import register_model_udf as ref_register_model_udf
from repro.dataio import synthetic_faces, synthetic_video
from repro.models import get_model as ref_model
from repro_torch.configs import base as port_base, get_arch
from repro_torch.interop import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the clips' bilinear downsample: the packages sum the interpolation
# products over a (T, H, W, C) clip in other orders, one float32 ulp
# (1.2e-7) apart; the stamped pixels are the label's 1.0 in both
CLIP_TOL = 1e-6


def _load(name):
    """``examples/<name>.py`` as a module (the directory is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_answer(query, ingest, **engine_kw):
    eng = RefEngine(**engine_kw)
    try:
        ingest(eng)
        res = eng.execute(query, timeout=600)
    finally:
        eng.shutdown()
    return res


def _same(got: dict, want: dict, atol=None):
    """The same eids in the same order and the same arrays: bit for bit,
    or within ``atol``."""
    assert list(got) == list(want)
    for eid, arr in want.items():
        arr = np.asarray(arr)
        assert got[eid].shape == arr.shape and got[eid].dtype == arr.dtype
        if atol is None:
            np.testing.assert_array_equal(got[eid], arr)
        else:
            np.testing.assert_allclose(got[eid], arr, rtol=0, atol=atol)


def test_quickstart_equals_the_reference_engine():
    ex = _load("torch_quickstart")
    out = ex.main(["--device", "cpu", "--faces", "16"])
    want = _ref_answer(
        ex.QUERY, lambda eng: ex.ingest(eng, synthetic_faces(16, size=96)),
        num_remote_servers=4, fuse_native=True,
        transport=RefTransport(network_latency_s=0.002, service_time_s=0.005))
    assert out["matched"] == want["stats"]["matched"] > 0
    assert out["failed"] == want["stats"]["failed"] == 0
    _same(out["entities"], want["entities"])
    _same(out["session_entities"], want["entities"])
    assert out["session_failed"] == 0
    assert out["streamed"] == out["matched"]
    assert out["shape"] == (80, 64, 3)
    assert set(out["values"]) <= {0.0, 1.0}
    assert out["utilization"]["remote_processed"] == 2 * out["matched"]


def test_serve_visual_queries_equals_the_reference_engine():
    ex = _load("torch_serve_visual_queries")
    # the reference example's UDF, on the weights it initialises
    ref_register_model_udf(ex.UDF, arch="qwen3-0.6b", reduced=True, steps=3)
    cfg = get_arch("qwen3-0.6b", reduced=True)
    jparams = ref_model(ref_arch("qwen3-0.6b", reduced=True)).init(
        jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    out = ex.main(["--device", "cpu"], params=params)

    def ingest(eng):
        for i in range(6):
            eng.add_entity("video", synthetic_video(4, 64, seed=i),
                           {"category": "activity", "clip": i})

    want = _ref_answer(
        ex.QUERY, ingest, num_remote_servers=2, coalesce_window_ms=5,
        cache_capacity=512,
        transport=RefTransport(network_latency_s=0.002, service_time_s=0.0))
    assert want["stats"]["failed"] == out["failed"] == 0
    assert out["clips"] == 2 * 6
    _same(out["entities"], want["entities"], atol=CLIP_TOL)
    for eid, clip in want["entities"].items():
        np.testing.assert_array_equal(out["entities"][eid] == 1.0,
                                      np.asarray(clip) == 1.0)
    assert out["shape"] == (4, 32, 32, 3)
    assert all(n > 0 for n in out["stamped_pixels"].values()), \
        out["stamped_pixels"]
    assert out["warm_failed"] == 0
    assert out["warm_hits"] == 4 * 6
    assert out["cache"]["hits"] == 24 and out["cache"]["size"] == 6


def test_train_lm_checkpoints_and_resumes(tmp_path):
    ex = _load("torch_train_lm")
    ckpt = str(tmp_path / "ckpt")
    args = ["--device", "cpu", "--batch", "2", "--seq", "32",
            "--save-every", "3", "--ckpt-dir", ckpt]
    first = ex.main(args + ["--steps", "6"])
    assert first["start_step"] == 0 and first["steps"] == 6
    assert np.all(np.isfinite(first["losses"]))
    assert sorted(os.listdir(ckpt)) == ["step_00000003", "step_00000006"]
    again = ex.main(args + ["--steps", "8"])
    assert again["start_step"] == 6 and again["steps"] == 2
    assert np.all(np.isfinite(again["losses"]))
    assert "step_00000006" in os.listdir(ckpt)


def test_register_100m_equals_the_reference():
    ex = _load("torch_train_lm")
    ref = _load("train_lm")
    saved = (dict(port_base._REGISTRY), dict(ref_base._REGISTRY))
    try:
        assert ex.register_100m() == ref.register_100m() == "qwen3-100m"
        got = dataclasses.asdict(get_arch("qwen3-100m"))
        want = dataclasses.asdict(ref_arch("qwen3-100m"))
        assert got == want
        assert got["d_model"] == 768 and got["num_layers"] == 12
        assert get_arch("qwen3-100m", reduced=True) == get_arch("qwen3-100m")
    finally:
        for reg, old in zip((port_base._REGISTRY, ref_base._REGISTRY), saved):
            reg.clear()
            reg.update(old)
    with pytest.raises(KeyError):
        get_arch("qwen3-100m")


def test_scaleout_bench_prints_each_kappa_row(capsys):
    ex = _load("torch_scaleout_bench")
    out = ex.main(["--device", "cpu", "--kappas", "1", "2", "--images", "8"])
    lines = capsys.readouterr().out.strip().splitlines()
    rows = out["rows"]
    assert [r["name"] for r in rows] == ["scaleout_k1", "scaleout_k2"]
    assert len(lines) == 1 + len(rows)
    for line, r in zip(lines[1:], rows):
        k, wall, gain, eff = line.split()
        assert int(k) == int(r["name"].split("_k")[1])
        assert wall == f"{r['wall_s']:.3f}"
        assert gain == f"{r['gain']:.2f}" and eff == f"{r['derived']:.2f}"
        assert r["gain"] == pytest.approx(rows[0]["wall_s"] / r["wall_s"])


@pytest.mark.parametrize("name,args", [
    ("torch_quickstart", []), ("torch_serve_visual_queries", []),
    ("torch_train_lm", ["--steps", "1"]),
    ("torch_scaleout_bench", ["--kappas", "1"])])
def test_examples_default_to_the_card(name, args, tmp_path):
    """Without ``--device`` each example asks for the CUDA card, and on a
    host without one it raises: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    if name == "torch_train_lm":
        args = args + ["--ckpt-dir", str(tmp_path / "ckpt")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(args)
    assert not (tmp_path / "ckpt").exists()
