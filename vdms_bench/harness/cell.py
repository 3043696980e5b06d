"""One run of one cell: set-up, a warm-up round at the cell's own shapes,
the measured window of closed-loop clients, the metrics, and then, with
the program's state freed, the correctness check against the plain
reference.  Everything the run does comes from the cell's files (see
:mod:`harness.spec`) and ``--seed``."""
from __future__ import annotations

import dataclasses
import gc
import itertools
import math
import sys
import time

import numpy as np
import torch

import reference
from harness import checks, clients, collection, spec, weights
from harness.hooks import KernelProbe, ServeRecorder
from harness.seeds import stream

PIN = {"device": 1e-6, "native": 10.0, "remote": 10.0, "batcher": 10.0}
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoChip(RuntimeError):
    """The host has no CUDA card, or fewer than the cell asks for."""


@dataclasses.dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``)."""
    cell: str
    config: dict
    traffic: dict
    seconds: float
    setup_s: float
    window_s: float
    steady_s: float          # the window up to a traced run's slice
    queries: list            # one record per query (harness.clients)
    udf_calls: list          # the model route's calls in the window
    backend: tuple           # device backend stats at t0 and steady_s
    trace: dict | None       # harness.trace.Slice.reduce() of a traced run
    model: object            # the configuration's reference module


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def check_program_config(model_cfg: dict, reduced: bool) -> None:
    """The program's configuration of the arch must be the file's: every
    key the file gives that the program's config has."""
    from repro_torch.configs import get_arch
    arch = get_arch(model_cfg["arch"], reduced=reduced)
    for key, want in model_cfg.items():
        if hasattr(arch, key) and getattr(arch, key) != want:
            raise ValueError(f"the program's {arch.name} has {key}="
                             f"{getattr(arch, key)!r}, the configuration "
                             f"file {want!r}")


def _query(groups, pipeline, udf_name, category):
    ops = [{"type": "udf", "options": {"id": udf_name}}
           if op["type"] == checks.MODEL_OP else dict(op) for op in pipeline]
    cons = (["==", groups[0]] if len(groups) == 1 else ["in", list(groups)])
    return [{"FindImage": {"constraints": {"category": ["==", category],
                                           "group": cons},
                           "operations": ops}}]


def client_streams(traffic, n_groups, seed, udf_name, category, tag):
    """Each client's endless stream of ``(query, meta)``: every query the
    same size (``groups_per_query`` distinct groups of the collection),
    the groups drawn uniformly from stream ``tag`` of the seed."""
    k = traffic["groups_per_query"]
    out = []
    for c in range(traffic["clients"]):
        rng = np.random.default_rng(stream(seed, f"{tag}/{c}"))

        def gen(rng=rng):
            while True:
                groups = sorted(int(g) for g in
                                rng.choice(n_groups, size=k, replace=False))
                yield (_query(groups, traffic["pipeline"], udf_name,
                              category), {"groups": groups})
        out.append(gen())
    return out


def run(cell: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", bench: dict | None = None,
        config: dict | None = None, traffic: dict | None = None,
        limits: dict | None = None, program_reduced: bool = False,
        control: bool = False, log=sys.stderr) -> dict:
    """The result line's object for one run of ``cell``.  ``config``,
    ``traffic`` and ``limits`` stand in for the cell's files, and
    ``program_reduced`` registers the program's reduced configuration
    (the tests' small sizes on the CPU).  With ``control``, the result
    also holds the control's numbers on the same sample beside the same
    limits (``"control"``: the reference in TF32 in the program's place)
    and whether they keep to them (``"control_correct"``)."""
    bench = bench if bench is not None else spec.benchmark()
    entry = spec.workload(bench, cell)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoChip("torch sees no CUDA device")
        if torch.cuda.device_count() < entry["chips"]:
            raise NoChip(f"the cell asks for {entry['chips']} cards, "
                         f"torch sees {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config if config is not None else spec.config(bench,
                                                         entry["config"])
    mix = traffic if traffic is not None else spec.traffic(entry["traffic"])
    lim = limits if limits is not None else spec.limits(cell)
    pipeline = mix["pipeline"]
    if checks.has_model(pipeline) and pipeline[-1]["type"] != checks.MODEL_OP:
        raise ValueError("the model UDF must be the pipeline's last operation")
    per_layer = spec.metrics(bench, cell, True)
    wanted = per_layer if trace else spec.metrics(bench, cell, False)
    readers = {m["name"]: spec.reader(m["name"]) for m in wanted}

    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.core.udf import register_model_udf, unregister_udf
    model_cfg = cfg["model"]
    check_program_config(model_cfg, program_reduced)
    ref = reference.model(cfg["reference"])
    dev = torch.device(device)
    coll = cfg["collection"]

    def stage(name):
        print(f"set-up {name} at {time.monotonic() - t_start:.3f} s",
              file=log, flush=True)

    stage("imports")
    if trace:
        from harness.trace import Slice
        profiler = Slice()
        stage("profiler")
    params = weights.make(ref.layout(model_cfg), seed, dev)
    stage("weights")
    faces = collection.faces(coll["images"], coll["size"], seed, dev)
    stage("faces")
    faces_np = faces.numpy()
    engine = VDMSAsyncEngine(
        device=device, dispatch="cost",
        device_backend=True if dev.type == "cuda" else "cpu",
        device_batch_size=mix["device_batch_size"],
        device_max_wait_ms=mix["device_max_wait_ms"],
        cost_overrides={(cfg["udf"]["name"] if op["type"] == checks.MODEL_OP
                         else op["type"]): PIN for op in pipeline})
    probe = None
    try:
        # the store holds the whole collection: the engine takes no
        # capacity knob, and its default keeps 2 GiB
        engine.store.capacity = coll["store_bytes"]
        gs = coll["group_size"]
        eids = [engine.add_entity("image", faces_np[i],
                                  {"category": coll["category"],
                                   "group": i // gs})
                for i in range(coll["images"])]
        n_groups = coll["images"] // gs
        eids_of_group = {g: eids[g * gs:(g + 1) * gs]
                         for g in range(n_groups)}
        index_of = {e: i for i, e in enumerate(eids)}
        stage("ingest")
        udf = cfg["udf"]
        recorder = ServeRecorder()
        with recorder.registering():
            register_model_udf(udf["name"], arch=model_cfg["arch"],
                               steps=udf["steps"], reduced=program_reduced,
                               labels=tuple(udf["labels"]), device=device,
                               params=params)
        recorder.wrap_device_route(udf["name"])
        stage("registered")
        if trace:
            probes = {name: (*m.PROBE, m.shape)
                      for name, m in readers.items() if hasattr(m, "PROBE")}
            probe = KernelProbe(probes)
            probe.install()

        warm = client_streams(mix, n_groups, seed, udf["name"],
                              coll["category"], "warmup")
        for rec in clients.run_closed_loop(
                engine, [itertools.islice(s, mix["warmup_rounds"])
                         for s in warm], lambda t0: math.inf):
            if not rec["ok"]:
                raise RuntimeError(f"warm-up query failed: {rec['error']}")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        recorder.calls.clear()
        before = dict(engine.dispatch_stats()["device"])
        setup_s = time.monotonic() - t_start
        print(f"set-up {setup_s:.3f} s", file=log, flush=True)

        reservoir = clients.Reservoir(mix["sample_queries"],
                                      stream(seed, "sample"))
        steady = {}

        def during(t0):
            # a traced run's per-layer spans and counters are read over
            # the part of the window before the slice, which the
            # profiler's own cost does not slow
            if not trace:
                return
            time.sleep(max(0.0, t0 + mix["trace_lead"] * seconds
                           - time.perf_counter()))
            steady["stats"] = dict(engine.dispatch_stats()["device"])
            steady["s"] = time.perf_counter() - t0
            with profiler.record():
                time.sleep(mix["trace_slice"] * seconds)

        annotate = torch.profiler.record_function if trace else None
        records = clients.run_closed_loop(
            engine, client_streams(mix, n_groups, seed, udf["name"],
                                   coll["category"], "window"),
            lambda t0: t0 + seconds, reservoir, annotate, during)
        after = dict(engine.dispatch_stats()["device"])
        if not records:
            raise RuntimeError("the window sent no query")
        window_s = max(r["t_done"] for r in records)
        memory_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)
        t0 = records[0]["t0"]
        calls = recorder.host_calls()
        for c in calls:
            c["start"] -= t0
        red = profiler.reduce() if trace else None
        run_ = Run(cell=cell, config=cfg, traffic=mix, seconds=seconds,
                   setup_s=setup_s, window_s=window_s,
                   steady_s=steady.get("s", window_s), queries=records,
                   udf_calls=calls,
                   backend=(before, steady.get("stats", after)), trace=red,
                   model=ref)
        units = {m["name"]: m["unit"] for m in wanted}
        metrics = {}
        for name, module in readers.items():
            value = module.read(run_)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": units[name]}
    finally:
        if trace:
            profiler.close()
        if probe is not None:
            probe.remove()
        engine.shutdown()
        unregister_udf(cfg["udf"]["name"])
    del params, engine
    recorder.calls.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    failed = sum(1 for r in records if not r["ok"])
    sample = checks.Sample(reservoir.kept, eids_of_group, index_of)
    model = {"cfg": model_cfg, "labels": udf["labels"]}
    numbers, sequences = checks.evaluate(sample, faces, pipeline, dev,
                                         calls, model)
    numbers["failed_queries"] = failed
    low = checks.control(sample, faces, pipeline, dev, model) \
        if control else None
    if checks.has_model(pipeline):
        ref_params = weights.make(ref.layout(model_cfg), seed, dev)
        numbers["logit_gap"] = checks.logit_gaps(
            sequences, ref_params, model_cfg, ref.forward, dev)
        if control:
            low["logit_gap"] = checks.logit_gaps(
                sequences, ref_params, model_cfg, ref.forward, dev, True)
        del ref_params
    compared, correct = checks.judge(numbers, lim)
    correct = correct and bool(sample.items)
    result = {
        "correct": correct,
        "attempted": len(records),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": entry["chips"],
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if red is not None:
        result["device"]["busy_s"] = red["busy_s"]
        result["device"]["window_s"] = red["window_s"]
        result["breakdown"] = {"device_ops": red["device_ops"],
                               "idle_gaps": red["idle_gaps"]}
    if control:
        # the control stands in for the image operations and the model;
        # the run's queries and Find are the program's
        low.update(failed_queries=failed, find_errors=sample.find_errors)
        result["control"], result["control_correct"] = checks.judge(low, lim)
    result["checks"] = compared
    return result
