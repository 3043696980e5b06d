"""BENCHMARK.json and the files it names keep to the benchmark's
contract: names, units and lines of the allowed characters, every
configuration, traffic mix, limits file and metric reader found by
name, and the bounds and lengths in range."""
import json
import os
import re


import _paths  # noqa: F401
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.benchmark()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vdms_bench"]
    assert BENCH["command"] == ["python3", "vdms_bench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 65536


def test_every_name_and_unit_uses_the_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [w["config"] for w in BENCH["workloads"]]
             + [m["name"] for m in METRICS]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for name in names:
        assert NAME.match(name), name
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + BENCH["command"]):
        assert _line(text), text


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_every_file_a_cell_needs_is_found_by_name():
    cells = {w["name"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("vdms_bench/")
        cfg = spec.config(BENCH, c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert spec.traffic(w["traffic"])["pipeline"]
        assert spec.limits(w["name"])
        for trace in (False, True):
            for m in spec.metrics(BENCH, w["name"], trace):
                assert callable(spec.reader(m["name"]).read)
    for m in METRICS:
        assert set(m.get("workloads", [])) <= cells


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in spec.metrics(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics(BENCH, w["name"], True)
        for m in spec.metrics(BENCH, w["name"], True):
            assert m["moves"] in e2e


def test_limits_cover_every_number_the_check_reads():
    model = {"failed_queries", "find_errors", "image_err", "unmatched",
             "logit_gap"}
    for w in BENCH["workloads"]:
        pipeline = spec.traffic(w["traffic"])["pipeline"]
        want = model if any(o["type"] == "model_udf" for o in pipeline) \
            else {"failed_queries", "find_errors", "image_err"}
        assert set(spec.limits(w["name"])) == want


def test_a_check_of_24_cells_fits_its_time_limit():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, dirnames, files in os.walk(spec.BENCH_DIR):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), spec.ROOT)
            assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_json_files_parse():
    for sub in ("configs", "traffic", "limits"):
        for f in os.listdir(spec.BENCH_DIR / sub):
            json.loads((spec.BENCH_DIR / sub / f).read_text())
