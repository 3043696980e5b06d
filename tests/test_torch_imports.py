"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package, and on a host without a CUDA card its entry points
refuse a CUDA request before any thread starts instead of falling back
to the CPU."""
import glob
import os
import subprocess
import sys
import threading

import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                      "repro_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (beyond kernels.work, in main())
for bench in {benches!r}:
    importlib.import_module("benchmarks." + bench)
import importlib.util
for path in {examples!r}:   # loaded as modules: their main() is not run
    spec = importlib.util.spec_from_file_location("example", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib", "repro."))
             or k == "repro")
print(len(names), bad, ",".join(names))
"""
# the scale-out slice's modules, which the walk must reach
SCALE_OUT = {"repro_torch.cluster", "repro_torch.cluster.engine",
             "repro_torch.cluster.gather", "repro_torch.cluster.ring",
             "repro_torch.distributed.elastic", "repro_torch.serving.wire",
             "repro_torch.serving.frontend", "repro_torch.launch.serve",
             "repro_torch.core.executors"}
# the training slice's modules
TRAINING = {"repro_torch.training", "repro_torch.training.optimizer",
            "repro_torch.training.train_step", "repro_torch.checkpoint",
            "repro_torch.checkpoint.ckpt", "repro_torch.dataio.loader",
            "repro_torch.launch.train", "repro_torch.kernels.flash_vjp",
            "repro_torch.configs.minicpm_2b", "repro_torch.configs.granite_8b",
            "repro_torch.configs.qwen1p5_32b"}
# the distribution slice's modules
DISTRIBUTION = {"repro_torch.distributed", "repro_torch.distributed.sharding",
                "repro_torch.distributed.compression",
                "repro_torch.distributed.elastic", "repro_torch.launch.mesh",
                "repro_torch.launch.specs", "repro_torch.launch.model_serve"}

# the port's benches: every benchmarks/torch_*.py
BENCHES = sorted(os.path.basename(p)[:-3] for p in glob.glob(
    os.path.join(ROOT, "benchmarks", "torch_*.py")))
NEW_BENCHES = {"torch_common", "torch_video_suite", "torch_dispatch_bench",
               "torch_admission_bench", "torch_resilience_bench",
               "torch_hotpath", "torch_frontend_bench",
               "torch_serving_bench", "torch_run", "torch_roofline",
               "torch_report", "torch_hillclimb"}
# the port's examples: every examples/torch_*.py
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "torch_*.py")))
NEW_EXAMPLES = {"torch_quickstart", "torch_serve_visual_queries",
                "torch_train_lm", "torch_scaleout_bench"}

# the dry run's modules
DRY_RUN = {"repro_torch.kernels.work", "repro_torch.launch.costs",
           "repro_torch.launch.dryrun"}


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    assert NEW_BENCHES <= set(BENCHES), NEW_BENCHES - set(BENCHES)
    examples = {os.path.basename(p)[:-3] for p in EXAMPLES}
    assert NEW_EXAMPLES <= examples, NEW_EXAMPLES - examples
    code = _PROBE.format(src=os.path.join(ROOT, "src"), root=ROOT,
                         benches=BENCHES, examples=EXAMPLES)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    n, bad, names = out.stdout.strip().split(" ", 2)
    assert int(n) >= 30          # every module of the slice was imported
    walked = set(names.split(","))
    assert SCALE_OUT <= walked, SCALE_OUT - walked
    assert TRAINING <= walked, TRAINING - walked
    assert DISTRIBUTION <= walked, DISTRIBUTION - walked
    assert DRY_RUN <= walked, DRY_RUN - walked
    assert bad == "[]", bad
    # chip_smoke.main's, the benches' and the examples' own imports, as
    # listed there
    for path in (["chip_smoke.py"] + EXAMPLES
                 + [os.path.join("benchmarks", b + ".py") for b in BENCHES]):
        src = open(os.path.join(ROOT, path)).read()
        for bad in ("import jax", "from jax", "from repro.", "import repro\n",
                    "from repro import", "from benchmarks.common",
                    "from benchmarks import common"):
            assert bad not in src, (path, bad)


def test_cuda_requests_raise_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.query.device_backend import DeviceBackend
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VDMSAsyncEngine()                      # device="cuda" by default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VDMSAsyncEngine(device="cpu", dispatch="cost", device_backend=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VDMSAsyncEngine(device="cpu", dispatch="cost", device_backend="gpu")
    with pytest.raises(RuntimeError, match="none"):
        DeviceBackend()
    with pytest.raises(ValueError, match="device must be"):
        VDMSAsyncEngine(device="meta")
    assert set(threading.enumerate()) == before
