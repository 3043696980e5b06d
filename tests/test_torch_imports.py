"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package, and on a host without a CUDA card its entry points
refuse a CUDA request before any thread starts instead of falling back
to the CPU."""
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
import chip_smoke  # noqa: F401  (its own imports live in main())
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib", "repro."))
             or k == "repro")
print(len(names), bad)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    code = _PROBE.format(src=os.path.join(ROOT, "src"), root=ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 30          # every module of the slice was imported
    assert bad == "[]", bad
    # chip_smoke.main's own imports, as listed there
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert "import jax" not in src and "from repro." not in src


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
