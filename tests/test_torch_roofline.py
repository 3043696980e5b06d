"""The roofline suite on the port's dry run (``benchmarks/torch_{roofline,
report,hillclimb}.py``) against the reference's (``benchmarks/{roofline,
report,hillclimb}.py``).

- ``analytic_cell`` keeps the reference's arithmetic: over every arch x
  shape x pod its counts (FLOPs, HBM bytes, collective bytes, the model
  FLOPs and their ratio) equal the reference's within 1e-12, and each
  term is its count over the H100's rate;
- ``build_table``, ``run``, ``table`` and ``summary`` run over records
  that the port's ``run_cell`` writes (a subprocess under ``fake``
  groups): the ``decode_32k`` cells of the six families of
  ``tests/test_torch_dryrun.py`` on both production meshes, and the
  ``long_500k`` cells those families skip.  The reference's own
  ``build_table`` and ``table`` read the same records (their keys carry
  over), so the rows and lines are held against the reference's, the
  analytic columns scaled by the ratio of the two cards' rates;
- ``hillclimb``: ``VARIANTS`` equal to the reference's; the
  ``dense_decode`` cell's two variants through ``run_cell_variants``,
  and ``hybrid_prefill``'s ``cache_heads_f8`` through ``run_variant``,
  each record's input bytes equal to the reference's ``run_cell`` at
  the same rules and dtype on an ``Auto`` mesh of 256 forced host
  devices (a JAX subprocess: ``jax.make_mesh`` on JAX 0.9 builds
  ``Explicit`` axes, on which the reference's own hillclimb template
  fails), and ``kv_cache_f8``'s bytes the baseline's less half its
  parameter bytes (the variant casts the parameters, as the
  reference's does).
"""
import json
import os
import subprocess
import sys

import pytest

from benchmarks import hillclimb as ref_hillclimb
from benchmarks import report as ref_report
from benchmarks import roofline as ref_roofline
from benchmarks import torch_hillclimb, torch_report, torch_roofline, torch_run
from repro.configs import ALL_ARCHS as REF_ARCHS, SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_arch
from repro_torch.configs import ALL_ARCHS, SHAPES, get_arch
from repro_torch.kernels.work import HBM_BYTES_S, NVLINK_BYTES_S, PEAK_FLOPS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["qwen3-0.6b", "internvl2-1b", "zamba2-2.7b", "rwkv6-1.6b",
            "granite-moe-1b-a400m", "whisper-small"]
MESHES = ("16x16", "2x16x16")
# the TPU v5e's rates in the reference against the H100's
RATE = {"compute_s": ref_roofline.PEAK_FLOPS / PEAK_FLOPS,
        "memory_s": ref_roofline.HBM_BW / HBM_BYTES_S,
        "collective_s": ref_roofline.ICI_BW / NVLINK_BYTES_S}
COUNTS = ("flops", "hbm_bytes", "coll_bytes", "model_flops_per_dev",
          "useful_ratio")
TIMEOUT_S = 300

_RECORDS = """
import json, os, sys
from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch import costs, dryrun
from repro_torch.launch.mesh import make_production_mesh
out, families = sys.argv[1], sys.argv[2].split(",")
for mp in (False, True):
    with dryrun.fake_group(512 if mp else 256):
        mesh = make_production_mesh(multi_pod=mp)
        if not mp:   # rank 0's bfloat16 parameters in dense_decode's cell
            _, args = dryrun.build_cell(get_arch("qwen1.5-32b"),
                                        SHAPES["decode_32k"], mesh)
            print("PARAMS", costs.nbytes(args[0]))
            del args
        for arch in families:
            for shape in ("decode_32k", "long_500k"):
                rec = dryrun.run_cell(arch, shape, multi_pod=mp, mesh=mesh,
                                      verbose=False)
                if shape == "long_500k" and rec["status"] != "skipped":
                    continue
                rec.pop("traceback", None)
                tag = f"{arch}__{shape}__{rec['mesh']}"
                with open(os.path.join(out, tag + ".json"), "w") as f:
                    json.dump(rec, f)
"""

# the reference's run_cell at each dense_decode variant on an Auto mesh
_REFERENCE_VARIANTS = """
import json
from repro.launch import dryrun   # forces 512 host devices
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro.distributed.sharding import default_rules
from benchmarks.hillclimb import VARIANTS

mesh = jax.make_mesh((16, 16), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:256])
out = {}
for cell, names in (("dense_decode", ("baseline", "kv_cache_f8")),
                    ("hybrid_prefill", ("cache_heads_f8",))):
    arch, shape = VARIANTS[cell]["arch"], VARIANTS[cell]["shape"]
    for name in names:
        v = VARIANTS[cell]["variants"][name]
        rules = default_rules()
        rules.update(v.get("rules") or {})
        rec = dryrun.run_cell(arch, shape, multi_pod=False, mesh=mesh,
                              rules=rules, verbose=False,
                              dtype=getattr(jnp, v.get("dtype") or "bfloat16"))
        out[f"{cell}/{name}"] = [rec["status"],
                                 rec.get("input_bytes_per_device"),
                                 rec.get("error")]
print("RESULT " + json.dumps(out))
"""


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
                + ROOT, JAX_PLATFORMS="cpu", PYTHONWARNINGS="ignore")


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    """The port's records, the reference's dense_decode bytes (both in
    subprocesses, at once) and the port's dense_decode variants."""
    records = tmp_path_factory.mktemp("dryrun_torch")
    procs = {
        "records": subprocess.Popen(
            [sys.executable, "-c", _RECORDS, str(records),
             ",".join(FAMILIES)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=_env(), cwd=ROOT),
        "ref": subprocess.Popen(
            [sys.executable, "-c", _REFERENCE_VARIANTS],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(), cwd=ROOT)}
    hill = tmp_path_factory.mktemp("hillclimb_torch")
    port_rows = torch_hillclimb.run_cell_variants(
        "dense_decode", timeout=TIMEOUT_S, out_dir=str(hill))
    hybrid = torch_hillclimb.VARIANTS["hybrid_prefill"]
    f8 = torch_hillclimb.run_variant(
        hybrid["arch"], hybrid["shape"], hybrid["variants"]["cache_heads_f8"],
        timeout=TIMEOUT_S)
    outs = {}
    for name, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        assert p.returncode == 0, f"{name}: {stderr[-3000:]}"
        outs[name] = stdout
    line = [ln for ln in outs["ref"].splitlines() if ln.startswith("RESULT ")]
    params = [ln for ln in outs["records"].splitlines()
              if ln.startswith("PARAMS ")]
    with open(hill / "dense_decode.json") as f:
        written = json.load(f)
    return {"dir": str(records), "ref_variants": json.loads(line[-1][7:]),
            "port_variants": port_rows, "written": written,
            "hybrid_f8": f8,
            "param_bytes": int(params[-1].split()[1])}


@pytest.mark.parametrize("pod", [1, 2])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_analytic_cell_equals_the_reference(arch, shape, pod):
    got = torch_roofline.analytic_cell(get_arch(arch), SHAPES[shape],
                                       pod=pod)
    want = ref_roofline.analytic_cell(ref_arch(arch), REF_SHAPES[shape],
                                      pod=pod)
    for key in COUNTS:
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0), key
    assert got["compute_s"] == got["flops"] / PEAK_FLOPS
    assert got["memory_s"] == got["hbm_bytes"] / HBM_BYTES_S
    assert got["collective_s"] == got["coll_bytes"] / NVLINK_BYTES_S
    for term, ratio in RATE.items():
        assert got[term] == pytest.approx(want[term] * ratio, rel=1e-12)
    terms = {t: got[t] for t in RATE}
    assert got["bottleneck"] == max(terms, key=terms.get).replace("_s", "")
    assert got["roofline_fraction"] == got["compute_s"] / max(terms.values())


def test_the_port_orders_cells_as_the_reference():
    assert ALL_ARCHS == REF_ARCHS and list(SHAPES) == list(REF_SHAPES)


@pytest.mark.parametrize("mesh", MESHES)
def test_build_table_rows_match_records_and_the_reference(suite, mesh):
    recs = torch_roofline.load_dryrun(suite["dir"])
    rows = torch_roofline.build_table(suite["dir"], mesh)
    want = ref_roofline.build_table(suite["dir"], mesh)
    assert [(r["arch"], r["shape"]) for r in rows] == sorted(
        (a, s) for a, s, m in recs if m == mesh)
    assert len(rows) == len(want) == 2 * len(FAMILIES) - 2
    pod = 2 if mesh == "2x16x16" else 1
    for row, ref in zip(rows, want):
        rec = recs[(row["arch"], row["shape"], mesh)]
        assert row["status"] == ref["status"] == rec["status"]
        if rec["status"] != "ok":
            assert row["reason"] == ref["reason"] == rec["reason"]
            continue
        assert row["counted_compute_s"] == rec["compute_term_s"]
        assert row["counted_memory_s"] == rec["memory_term_s"]
        assert row["counted_collective_s"] == rec["collective_term_s"]
        assert row["counted_bottleneck"] == rec["bottleneck"]
        for kind in ("compute", "memory", "collective"):
            assert row[f"counted_{kind}_s"] == ref[f"parsed_{kind}_s"]
            assert row[f"adj_{kind}_s"] == pytest.approx(
                ref[f"adj_{kind}_s"] * RATE[f"{kind}_s"], rel=1e-12)
        a = torch_roofline.analytic_cell(get_arch(row["arch"]),
                                         SHAPES[row["shape"]], pod=pod)
        assert row["adj_bottleneck"] == a["bottleneck"]
        assert row["roofline_fraction"] == a["roofline_fraction"]
        assert row["useful_ratio"] == a["useful_ratio"]
        assert row["gib_per_dev"] == ref["gib_per_dev"] \
            == rec["input_bytes_per_device"] / 2 ** 30


def test_run_emits_the_reference_s_row_names(suite):
    rows = torch_roofline.run(suite["dir"])
    table = torch_roofline.build_table(suite["dir"])
    assert [r["name"] for r in rows] == [f"roofline_{t['arch']}_{t['shape']}"
                                         for t in table]
    for r, t in zip(rows, table):
        if t["status"] != "ok":
            assert r["us_per_call"] == 0.0 and r["skipped"] == t["reason"]
            continue
        step = max(t["adj_compute_s"], t["adj_memory_s"],
                   t["adj_collective_s"])
        assert r["us_per_call"] == step * 1e6
        assert r["derived"] == t["roofline_fraction"]
        assert r["bottleneck"] == t["adj_bottleneck"]
        assert r["counted_bottleneck"] == t["counted_bottleneck"]


@pytest.mark.parametrize("mesh", MESHES)
def test_report_table_one_line_per_cell_in_the_reference_s_order(suite,
                                                                 mesh):
    got = torch_report.table(suite["dir"], mesh).splitlines()
    want = ref_report.table(suite["dir"], mesh).splitlines()
    assert len(got) == len(want) == 2 + 2 * len(FAMILIES) - 2
    assert got[0] == want[0].replace("parsed", "counted")
    order = [(a, s) for a in ALL_ARCHS for s in SHAPES
             if os.path.exists(os.path.join(
                 suite["dir"], f"{a}__{s}__{mesh}.json"))]
    assert [tuple(ln.split(" | ")[:2]) for ln in got[2:]] == [
        (f"| {a}", s) for a, s in order]
    for g, w in zip(got[2:], want[2:]):
        if "skipped" in w:
            assert g == w
        else:   # arch, shape, GiB/dev and the counted terms and bound
            assert g.split(" | ")[:5] == w.split(" | ")[:5]


def test_summary_counts_each_mesh(suite):
    got = torch_report.summary(suite["dir"]).splitlines()
    want = ref_report.summary(suite["dir"]).splitlines()
    assert len(got) == len(want) == 2
    n_ok, n_skip = len(FAMILIES), len(FAMILIES) - 2
    for g, w, mesh in zip(got, want, MESHES):
        assert g.startswith(f"- **{mesh}**: {n_ok} ran OK, {n_skip} "
                            "skipped-by-design, 0 errors; run time med/max ")
        assert w.startswith(f"- **{mesh}**: {n_ok} compiled OK, {n_skip} ")


def test_skipped_cells_give_the_reference_s_reasons(suite):
    recs = torch_roofline.load_dryrun(suite["dir"])
    skipped = {(a, s, m): r["reason"] for (a, s, m), r in recs.items()
               if r["status"] == "skipped"}
    assert len(skipped) == 2 * (len(FAMILIES) - 2)
    for (a, s, _), reason in skipped.items():
        assert reason == ref_arch(a).supports_shape(REF_SHAPES[s])[1]


def test_variants_equal_the_reference():
    assert torch_hillclimb.VARIANTS == ref_hillclimb.VARIANTS


def test_dense_decode_variants_input_bytes_equal_the_reference(suite):
    rows = {r["variant"]: r for r in suite["port_variants"]}
    assert suite["written"] == suite["port_variants"]
    assert list(rows) == list(torch_hillclimb.VARIANTS["dense_decode"]
                              ["variants"])
    for name in rows:
        status, want, error = suite["ref_variants"][f"dense_decode/{name}"]
        assert status == "ok", error
        rec = rows[name]
        assert rec["status"] == "ok" and rec["cell"] == "dense_decode"
        assert rec["arch"] == "qwen1.5-32b" and rec["chips"] == 256
        assert rec["input_bytes_per_device"] == want
    # bfloat16 -> float8 parameters; the cache keeps its dtype
    assert rows["kv_cache_f8"]["input_bytes_per_device"] == \
        rows["baseline"]["input_bytes_per_device"] - suite["param_bytes"] // 2


def test_torch_run_adds_the_roofline_suite_when_the_records_exist(suite,
                                                                  tmp_path):
    assert "roofline" not in torch_run.suites(
        "cpu", False, dryrun_dir=str(tmp_path / "none"))
    suites = torch_run.suites("cpu", False, dryrun_dir=suite["dir"])
    assert list(suites)[-1] == "roofline"
    assert suites["roofline"]() == torch_roofline.run(suite["dir"])


def test_float8_parameters_against_a_bfloat16_cache_run_as_the_reference(
        suite):
    """``hybrid_prefill``'s ``cache_heads_f8``: zamba2's prefill with
    float8 parameters and its bfloat16 cache (K3's route takes the mixed
    operands in bfloat16, as the reference's flash forward takes them
    in float32) partitions to the reference's input bytes."""
    status, want, error = suite["ref_variants"]["hybrid_prefill/cache_heads_f8"]
    assert status == "ok", error
    rec = suite["hybrid_f8"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["input_bytes_per_device"] == want
    assert rec["kernel_breakdown"]["flash_attention"]["launches"] > 0
