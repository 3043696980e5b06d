"""Importing the harness, every metric reader and the references pulls
in neither JAX nor the JAX package (top-level names compared whole, so
``repro_torch`` is not ``repro``), and the references import nothing of
the program."""
import json
import os
import subprocess
import sys

import _paths

_PROBE = r"""
import glob, importlib, importlib.util, json, os, sys
sys.path.insert(0, {src!r}); sys.path.insert(0, {bench!r})
for name in ("reference", "reference.common", "reference.image_ops",
             "reference.stamp", "reference.rwkv6"):
    importlib.import_module(name)
before = sorted(m for m in sys.modules if m.split(".")[0] == "repro_torch")
for name in ("harness.cell", "harness.checks", "harness.clients",
             "harness.collection", "harness.hooks", "harness.roofline",
             "harness.seeds", "harness.spec", "harness.stats",
             "harness.trace", "harness.weights", "harness.window",
             "harness.work"):
    importlib.import_module(name)
for path in sorted(glob.glob(os.path.join({bench!r}, "metrics", "*.py"))):
    spec = importlib.util.spec_from_file_location("m", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import repro_torch.core.engine, repro_torch.core.udf  # what a run loads
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro"))
print(json.dumps({{"before": before, "bad": bad}}))
"""


def test_harness_and_reference_load_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = _PROBE.format(src=os.path.join(_paths.ROOT, "src"),
                         bench=_paths.BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=240, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert got["before"] == []


def test_the_top_level_comparison_is_whole():
    from harness.cell import FORBIDDEN
    names = ["repro_torch", "repro_torch.core", "jaxtyping", "reprolib"]
    assert [n for n in names if n.split(".")[0] in FORBIDDEN] == []
    assert [n for n in ["repro", "repro.x", "jax.numpy", "flax"]
            if n.split(".")[0] in FORBIDDEN] == ["repro", "repro.x",
                                                 "jax.numpy", "flax"]
