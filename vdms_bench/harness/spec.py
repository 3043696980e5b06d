"""What the harness finds by name: ``BENCHMARK.json`` at the root of the
checkout, and under ``vdms_bench/`` one file per configuration
(``BENCHMARK.json`` names it), per traffic mix (``traffic/<name>.json``),
per cell's correctness limits (``limits/<cell>.json``) and per metric
(``metrics/<metric>.py``, a module with ``read(run) -> float | None``,
and for a kernel's roofline ``PROBE = (module, function)`` and
``shape(*args, **kwargs)``: the launching function a traced run wraps).
A later change adds a cell, a mix or a metric by adding such files and
an entry in ``BENCHMARK.json``; nothing here changes."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{_name(name)}.json")
                      .read_text())


def limits(cell: str) -> dict:
    return json.loads((BENCH_DIR / "limits" / f"{_name(cell)}.json")
                      .read_text())


def metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's metrics of one kind: end-to-end without a trace,
    per-layer with one; an entry with a ``workloads`` list applies to
    those cells only."""
    kind = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in kind if cell in m.get("workloads", [cell])]


def reader(metric: str):
    """The module ``metrics/<metric>.py``."""
    path = BENCH_DIR / "metrics" / f"{_name(metric)}.py"
    spec = importlib.util.spec_from_file_location(
        "vdms_bench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
