#!/usr/bin/env python3
"""Multi-backend dispatch benchmarks on the PyTorch port: cost-model
routing against all-native and the paper's static placement, the device
backend, segment fusion, and the static-response hash.

``python3 benchmarks/torch_dispatch_bench.py [--device cuda|cpu]
[--smoke|--full] [--check-baseline]`` from the root of a checkout.  The
port's counterpart of ``benchmarks/dispatch_bench.py``, with its
workloads, functions, row names and keys; the port's engine runs on
``device`` (the CUDA card by default):

- ``run_mixed``: resize → remote ``dispatch_heavy`` (normalised matrix
  powers, in torch on the image's device) → the model UDF
  ``dispatch_lm`` → threshold, under ``dispatch="native"``,
  ``"static"`` and ``"cost"`` (the heavy op pinned remote, the model op
  on the ``GroupBatcher`` backend).  ``dispatch_lm`` is qwen3-0.6b
  through ``register_model_udf``: at full width (28 layers, d 1024) on
  the card, reduced on the CPU, as the reference registers it.  The
  three responses must be identical (``responses_identical``);
- ``run_device``: resize → blur all-native against blur pinned onto the
  device backend (the blur kernel K1 over each micro-batch);
  ``responses_close`` within ``rtol`` 1e-5, ``atol`` 1e-6;
- ``run_device_fused``: resize → crop → normalize → blur pinned onto
  the device, per op against one fused segment (the fused preprocess
  kernel K2, then K1); ``responses_close``;
- ``run_static_hash``: crop → remote flip → rotate → threshold over 8
  seeded 32×32 images on a default engine and a ``dispatch="static"``
  one; the digest must equal the recorded
  ``benchmarks/dispatch_static_baseline.json`` (``778564da…``).

``--check-baseline`` exits 2 unless every gate of the reference's holds
(a missing baseline file fails too); there is no ``--update-baseline``.
The payload goes with the card's name and power limit to
``chiprun_out/torch_dispatch.json``.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.torch_common import (DISPATCH_BASELINE,  # noqa: E402
                                     bench_args, compare_close,
                                     entities_equal, finish,
                                     recorded_sha256, response_sha256,
                                     write_payload)
from repro_torch.core.engine import VDMSAsyncEngine  # noqa: E402
from repro_torch.core.remote import TransportModel  # noqa: E402

_REGISTERED = None     # (lm_steps, device, reduced, params) registered


def heavy(img, iters=8, dim=192):
    """``dispatch_heavy``: the reference's numpy UDF in torch on the
    image's device — ``np.resize`` (the flattened image repeated) to
    ``dim`` × ``dim``, normalised, ``iters`` squarings ``a @ a.T``
    each rescaled by its largest magnitude, then ``1e-3`` of the result
    (resized the same way to the image's height and width) added to the
    image, clipped to [0, 1]."""
    def np_resize(x, n):
        flat = x.reshape(-1)
        return flat.repeat(-(-n // flat.numel()))[:n]

    a = np_resize(img.to(torch.float32), dim * dim).reshape(dim, dim)
    a = a / (torch.linalg.vector_norm(a) + 1e-6)
    for _ in range(iters):
        a = a @ a.T
        a = a / (a.abs().max() + 1e-6)
    h, w, _ = img.shape
    bias = np_resize(a, h * w).reshape(h, w, 1)
    return torch.clip(img + 1e-3 * bias, 0.0, 1.0)


def _register_ops(lm_steps, device, reduced=None, params=None):
    """Register ``dispatch_heavy`` and the model UDF ``dispatch_lm`` (and
    its batched and device routes) once per process and setting, then
    warm both model paths outside the timed arms: the batched one at
    every group size the arms meet, the per-entity one once.  The model
    is qwen3-0.6b, reduced on the CPU and at full width on the card
    unless ``reduced`` says otherwise; ``params`` is a tree on
    ``device`` (``interop.params_from_jax``), else the port's seeded
    init."""
    global _REGISTERED
    from repro_torch.core.udf import (get_batched_udf, get_udf,
                                      register_model_udf, register_udf)
    dev = torch.device(device)
    reduced = dev.type == "cpu" if reduced is None else reduced
    key = (lm_steps, str(dev), reduced, id(params))
    if _REGISTERED == key:
        return
    register_udf("dispatch_heavy", heavy)
    register_model_udf("dispatch_lm", "qwen3-0.6b", steps=lm_steps,
                       reduced=reduced, device=dev, params=params)
    img = torch.zeros((32, 32, 3), dtype=torch.float32, device=dev)
    get_udf("dispatch_lm")(img)
    for n in (8, 6, 4, 2):
        get_batched_udf("dispatch_lm")([img] * n)
    _REGISTERED = key


def _fill(eng, n, size, category="dsp"):
    rng = np.random.default_rng(11)
    for i in range(n):
        img = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
        eng.add_entity("image", img, {"category": category, "idx": i})


def _find(category, pipe):
    return [{"FindImage": {"constraints": {"category": ["==", category]},
                           "operations": pipe}}]


def _timed(eng, n_images, size, warm_n, pipe):
    """Fill, warm with ``warm_n`` images, then time one query."""
    _fill(eng, n_images, size)
    _fill(eng, warm_n, size, category="warm")
    eng.execute(_find("warm", pipe), timeout=600)
    t0 = time.monotonic()
    res = eng.execute(_find("dsp", pipe), timeout=600)
    dt = time.monotonic() - t0
    assert res["stats"]["failed"] == 0, res["stats"]
    return dt, res["entities"], eng.dispatch_stats()


# ------------------------------------------------------- mixed workload
MIXED_PIPE = [
    {"type": "resize", "width": 32, "height": 32},
    {"type": "remote", "url": "http://svc/heavy",
     "options": {"id": "dispatch_heavy"}},
    {"type": "udf", "options": {"id": "dispatch_lm"}},
    {"type": "threshold", "value": 0.4},
]


def run_mixed(n_images=16, size=48, lm_steps=2, *, device="cuda",
              reduced=None, params=None, return_entities=False):
    """The mixed workload under the three placement modes.  With
    ``return_entities`` the row also carries each arm's response
    (``"entities"``, host arrays), for comparison with another
    engine's.  ``setup_s``: registering and warming the model UDF (0
    when this process already had)."""
    t0 = time.monotonic()
    _register_ops(lm_steps, device, reduced, params)
    setup_s = time.monotonic() - t0
    # WAN-ish transport: the remote-tagged op is transport-bound
    transport = TransportModel(network_latency_s=0.015,
                               service_time_s=0.0005)
    pinned = {
        "dispatch_heavy": {"remote": 1e-6, "native": 10.0, "batcher": 10.0},
        "dispatch_lm": {"batcher": 1e-6, "native": 10.0, "remote": 10.0},
    }

    def arm(mode):
        eng = VDMSAsyncEngine(device=device, num_remote_servers=4,
                              transport=transport,
                              dispatch_policy="least_loaded",
                              num_native_workers=2, dispatch=mode,
                              cost_overrides=(pinned if mode == "cost"
                                              else None),
                              batcher_max_wait_ms=150.0)
        try:
            return _timed(eng, n_images, size, 2, MIXED_PIPE)
        finally:
            eng.shutdown()

    t_native, ents_native, _ = arm("native")
    t_static, ents_static, _ = arm("static")
    t_cost, ents_cost, stats_cost = arm("cost")
    identical = (entities_equal(ents_native, ents_static)
                 and entities_equal(ents_native, ents_cost))
    row = {
        "name": f"dispatch_mixed_n{n_images}",
        "us_per_call": t_cost / n_images * 1e6,
        "derived": t_native / t_cost,
        "speedup_vs_static": t_static / t_cost,
        "n_images": n_images,
        "native_s": t_native,
        "static_s": t_static,
        "cost_s": t_cost,
        "entities_per_s_cost": n_images / t_cost,
        "setup_s": setup_s,
        "placements": stats_cost.get("placements", {}),
        "handoffs": stats_cost.get("handoffs", 0),
        "batcher_groups": stats_cost.get("batcher", {}).get("groups_run", 0),
        "responses_identical": identical,
    }
    if return_entities:
        row["entities"] = {"native": ents_native, "static": ents_static,
                           "cost": ents_cost}
    return [row]


# ------------------------------------------------------- device arm
def run_device(n_images=16, size=72, ksize=9, *, device="cuda",
               return_entities=False):
    """All-native against blur pinned onto the device backend."""
    transport = TransportModel(network_latency_s=0.002,
                               service_time_s=0.001)
    pipe = [
        {"type": "resize", "width": 64, "height": 64},
        {"type": "blur", "ksize": ksize, "sigma_x": 2.0},
    ]
    pinned = {"blur": {"device": 1e-6, "native": 10.0,
                       "remote": 10.0, "batcher": 10.0}}

    def arm(mode):
        on_device = mode == "device"
        eng = VDMSAsyncEngine(
            device=device, num_remote_servers=2, transport=transport,
            num_native_workers=2,
            dispatch=("cost" if on_device else "native"),
            device_backend=(torch.device(device).type if on_device
                            else False),
            device_batch_size=8, device_max_wait_ms=150.0,
            cost_overrides=(pinned if on_device else None))
        try:
            # warm with a full micro-batch so the timed arm reuses the
            # (op, batch shape) set-up
            return _timed(eng, n_images, size, 8, pipe)
        finally:
            eng.shutdown()

    t_native, ents_native, _ = arm("native")
    t_device, ents_device, stats_dev = arm("device")
    close, max_abs = compare_close(ents_native, ents_device)
    identical = entities_equal(ents_native, ents_device)
    dev = stats_dev.get("device", {})
    row = {
        "name": f"dispatch_device_n{n_images}",
        "us_per_call": t_device / n_images * 1e6,
        "derived": t_native / t_device,
        "n_images": n_images,
        "native_s": t_native,
        "device_s": t_device,
        "entities_per_s_device": n_images / t_device,
        "placements": stats_dev.get("placements", {}),
        "device_groups": dev.get("groups_run", 0),
        "device_compiles": dev.get("compiles", 0),
        "device_platform": dev.get("platform", "?"),
        "device_calibrated": dev.get("calibrated", False),
        "responses_close": close,
        "responses_identical": identical,
        "max_abs_err": max_abs,
    }
    if return_entities:
        row["entities"] = {"native": ents_native, "device": ents_device}
    return [row]


# ---------------------------------------------------- fused-segment arm
def run_device_fused(n_images=16, size=72, ksize=9, *, device="cuda",
                     return_entities=False):
    """Per-op device execution against one fused segment over resize →
    crop → normalize → blur, all pinned onto the device."""
    transport = TransportModel(network_latency_s=0.002,
                               service_time_s=0.001)
    pipe = [
        {"type": "resize", "width": 64, "height": 64},
        {"type": "crop", "x": 8, "y": 8, "width": 48, "height": 48},
        {"type": "normalize", "mean": 0.45, "std": 0.22},
        {"type": "blur", "ksize": ksize, "sigma_x": 2.0},
    ]
    pinned = {o["type"]: {"device": 1e-6, "native": 10.0,
                          "remote": 10.0, "batcher": 10.0}
              for o in pipe}

    def arm(fuse):
        eng = VDMSAsyncEngine(
            device=device, num_remote_servers=2, transport=transport,
            num_native_workers=2,
            dispatch="cost", device_backend=torch.device(device).type,
            device_fuse_segments=fuse,
            device_batch_size=8, device_max_wait_ms=25.0,
            cost_overrides=pinned)
        try:
            return _timed(eng, n_images, size, 8, pipe)
        finally:
            eng.shutdown()

    t_unfused, ents_unfused, stats_unf = arm(False)
    t_fused, ents_fused, stats_fus = arm(True)
    close, max_abs = compare_close(ents_unfused, ents_fused)
    dev_f = stats_fus.get("device", {})
    dev_u = stats_unf.get("device", {})
    row = {
        "name": f"dispatch_device_fused_n{n_images}",
        "us_per_call": t_fused / n_images * 1e6,
        "derived": t_unfused / t_fused,
        "device_fused_speedup_vs_unfused": t_unfused / t_fused,
        "n_images": n_images,
        "segment_ops": len(pipe),
        "unfused_s": t_unfused,
        "fused_s": t_fused,
        "entities_per_s_fused": n_images / t_fused,
        "fused_segments": dev_f.get("fused_segments", 0),
        "fused_groups": dev_f.get("groups_run", 0),
        "unfused_groups": dev_u.get("groups_run", 0),
        "fused_h2d_bytes": dev_f.get("h2d_bytes", 0),
        "unfused_h2d_bytes": dev_u.get("h2d_bytes", 0),
        "padding_waste_frac": dev_f.get("padding_waste_frac", 0.0),
        "device_platform": dev_f.get("platform", "?"),
        "responses_close": close,
        "max_abs_err": max_abs,
    }
    if return_entities:
        row["entities"] = {"unfused": ents_unfused, "fused": ents_fused}
    return [row]


# ------------------------------------------------- static-response hash
STATIC_PIPE = [
    {"type": "crop", "x": 4, "y": 4, "width": 24, "height": 24},
    {"type": "remote", "url": "http://svc/flip", "options": {"id": "flip"}},
    {"type": "rotate", "k": 1},
    {"type": "threshold", "value": 0.5},
]


def run_static_hash(*, device="cuda"):
    """Hash the ``dispatch="static"`` response on the bit-exact workload
    (index permutations and comparisons only) and compare it with a
    default-knob engine's."""
    transport = TransportModel(network_latency_s=0.001,
                               service_time_s=0.001)

    def response(**kw):
        eng = VDMSAsyncEngine(device=device, num_remote_servers=2,
                              transport=transport, **kw)
        try:
            _fill(eng, 8, 32)
            return eng.execute(_find("dsp", STATIC_PIPE), timeout=600)
        finally:
            eng.shutdown()

    ref = response()                       # engine exactly as it ships
    static = response(dispatch="static")   # knob spelled out
    identical = entities_equal(ref["entities"], static["entities"])
    digest = response_sha256(static["entities"])
    recorded = recorded_sha256(DISPATCH_BASELINE)
    return [{
        "name": "dispatch_static_hash",
        "us_per_call": 0.0,
        "derived": 1.0 if identical else 0.0,
        "static_response_sha256": digest,
        "baseline_sha256": recorded,
        "static_matches_default_engine": identical,
        "static_matches_baseline": (recorded is None or digest == recorded),
    }]


def run(smoke=True, device="cuda", report=True):
    """Every arm at the reference's smoke or full sizes; writes the
    payload to ``chiprun_out/torch_dispatch.json``."""
    if smoke:
        rows = (run_mixed(n_images=16, size=48, lm_steps=2, device=device)
                + run_device(n_images=16, size=72, device=device)
                + run_device_fused(n_images=16, size=72, device=device)
                + run_static_hash(device=device))
    else:
        rows = (run_mixed(n_images=32, size=64, lm_steps=4, device=device)
                + run_device(n_images=32, size=96, ksize=13, device=device)
                + run_device_fused(n_images=32, size=96, ksize=13,
                                   device=device)
                + run_static_hash(device=device))
    by = _by_kind(rows)
    if report:
        write_payload("dispatch", {
            "smoke": smoke,
            "speedup_vs_native": by["mixed"]["derived"],
            "speedup_vs_static": by["mixed"]["speedup_vs_static"],
            "responses_identical": by["mixed"]["responses_identical"],
            "device_speedup_vs_native": by["device"]["derived"],
            "device_responses_close": by["device"]["responses_close"],
            "device_platform": by["device"]["device_platform"],
            "device_fused_speedup_vs_unfused":
                by["fused"]["device_fused_speedup_vs_unfused"],
            "device_fused_responses_close": by["fused"]["responses_close"],
            "static_response_sha256": by["hash"]["static_response_sha256"],
            "static_matches_baseline": by["hash"]["static_matches_baseline"],
            "rows": rows,
        }, device)
    return rows


def _by_kind(rows) -> dict:
    def one(prefix):
        return next(r for r in rows if r["name"].startswith(prefix))
    return {"mixed": one("dispatch_mixed"),
            "device": one("dispatch_device_n"),
            "fused": one("dispatch_device_fused"),
            "hash": one("dispatch_static_hash")}


def gates(rows) -> list[str]:
    """The reference's ``--check-baseline`` gates, as messages of the
    ones that failed (empty: all hold)."""
    by = _by_kind(rows)
    h = by["hash"]
    if h["baseline_sha256"] is None:
        return [f"no recorded baseline at {DISPATCH_BASELINE}"]
    failures = []
    if not h["static_matches_baseline"]:
        failures.append(f"static response hash "
                        f"{h['static_response_sha256']} != recorded "
                        f"baseline {h['baseline_sha256']}")
    if not (h["static_matches_default_engine"]
            and by["mixed"]["responses_identical"]):
        failures.append("dispatch modes returned differing responses")
    if not by["device"]["responses_close"]:
        failures.append("device-arm response diverged beyond float "
                        "tolerance from the all-native response")
    if not by["fused"]["responses_close"]:
        failures.append("fused-segment response diverged beyond float "
                        "tolerance from the per-op device response")
    return failures


def headline(rows) -> list[str]:
    """The numbers each arm stands for, a line an arm."""
    by = _by_kind(rows)
    m, d, f, h = by["mixed"], by["device"], by["fused"], by["hash"]
    return [
        f"{m['name']}: the model UDF registered and warmed in "
        f"{m['setup_s']:.3f} s; native {m['native_s']:.4f} s, static "
        f"{m['static_s']:.4f} s, cost {m['cost_s']:.4f} s (native/cost "
        f"{m['derived']:.3f}, static/cost {m['speedup_vs_static']:.3f}); "
        f"placements {m['placements']}, batcher groups "
        f"{m['batcher_groups']}; identical {m['responses_identical']}",
        f"{d['name']}: native {d['native_s']:.4f} s, device "
        f"{d['device_s']:.4f} s ({d['derived']:.3f}); groups "
        f"{d['device_groups']}, platform {d['device_platform']}, "
        f"max_abs_err {d['max_abs_err']}",
        f"{f['name']}: per op {f['unfused_s']:.4f} s, fused "
        f"{f['fused_s']:.4f} s ({f['derived']:.3f}); fused segments "
        f"{f['fused_segments']}, max_abs_err {f['max_abs_err']}",
        f"{h['name']} {h['static_response_sha256']}"]


def main(argv=None) -> int:
    args = bench_args(__doc__.splitlines()[0], argv)
    rows = run(smoke=not args.full, device=args.device)
    return finish(rows, gates(rows), args, headline(rows))


if __name__ == "__main__":
    sys.exit(main())
