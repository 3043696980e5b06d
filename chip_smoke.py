#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA
card: ``python3 chip_smoke.py`` from the root of a checkout.

Phases (any failed check exits non-zero, before the result line):

1. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and identify the card;
2. the bit-exact ``dispatch_static_hash`` workload (crop → remote flip →
   rotate → threshold over 8 seeded 32x32 images) on
   ``VDMSAsyncEngine(device="cuda")`` must hash to the recorded value;
3. the native path at LFW scale: 64 synthetic 250x250 faces through
   IQ3's blur and the C2 pipeline, checked against the plain versions on
   the host and an engine on the CPU;
4. the device backend: 256 faces through resize → crop → normalize →
   blur pinned onto the device (the fused preprocess kernel, then the
   blur kernel), against the same query run all-native on the card;
5. each kernel against its plain version on the card at the shapes of
   the main paths, with times, bounds and a library yardstick;
6. the model path at the full width of zamba2-2.7b (54 layers,
   d_model 2560, seeded random weights): ``launch.model_serve.run`` over
   16 requests of 512 tokens + 16 generated; prefill + decode logits
   against the no-cache forward; and one engine query over 16 images
   whose only op is a ``register_model_udf`` model UDF, through the
   per-entity, batcher and device-backend arms, which must stamp
   identical labels.

Launch counts are zeroed just before phase 2 and read just after
phase 4 (the engine's image path: K1 and K2 must have launched), and
zeroed again just before phase 6 and read just after it (the model
path: the SSD kernel K4 must have launched).  Phase 5's launches, which
only compare kernels with their plain versions, count in neither.  The
last lines are the card's name and power limit, one
``{"kernels": [...]}`` line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STATIC_SHA256 = "778564da3d5f5530f0f4761d6af9f4c901796a91ff38620f2b75dd8cfa03a1b0"

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and fp32 (non-tensor) peak
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12

K1_TOL = 1e-5       # blur kernel vs plain, absolute (same tap order)
K2_TOL = 1e-4       # fused preprocess vs composed ops, absolute
PIPE_TOL = 1e-4     # whole-pipeline comparisons, absolute
NATIVE_TOL = 1e-5   # native blur on the card vs plain on the host
# SSD kernel vs plain, float32, absolute: chunk sums of up to 128
# products in another order than cuBLAS, on outputs up to about 10
K4_TOL = 5e-4
# ... in bfloat16: the same, plus one bfloat16 rounding step of the output
K4_BF16_ATOL, K4_BF16_RTOL = 5e-2, 2.0 ** -7
# full-width prefill + decode logits vs the no-cache forward, absolute:
# the JAX package's 3e-4 at reduced width, widened for 54 layers of
# float32 products of length up to 10240 summed in other orders
MODEL_TOL = 1e-3

ARCH = "zamba2-2.7b"
MODEL_UDF = "lm"

# a few ms of device sleep ahead of each timed call (outlasts the host
# time to enqueue the slowest timed function, the plain blur)
SLEEP_CYCLES = 5_000_000


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


IQ3_BLUR = [{"type": "blur", "ksize": 5, "sigma_x": 1.5}]
C2_PIPE = [  # benchmarks/common.py::image_c2_pipeline
    {"type": "resize", "width": 48, "height": 48},
    {"type": "remote", "url": "u", "options": {"id": "facedetect_box"}},
    {"type": "remote", "url": "u", "options": {"id": "manipulation"}},
    {"type": "rotate", "k": 1},
]


def fill(eng, n, size, category, seed=11):
    """``benchmarks/dispatch_bench.py::_fill``: seeded uniform images."""
    import numpy as np
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
        eng.add_entity("image", img, {"category": category, "idx": i})


def ingest_faces(eng, faces, category) -> list[str]:
    return [eng.add_entity("image", img, {"category": category, "idx": i})
            for i, img in enumerate(faces)]


def find(category, ops):
    return [{"FindImage": {"constraints": {"category": ["==", category]},
                           "operations": ops}}]


def response_hash(entities) -> str:
    import numpy as np
    h = hashlib.sha256()
    for eid in entities:
        arr = np.ascontiguousarray(np.asarray(entities[eid]))
        h.update(eid.encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def max_err(a: dict, b: dict) -> float:
    import numpy as np
    if list(a) != list(b):
        raise SmokeFailure("responses name different entities")
    return max(float(np.max(np.abs(np.asarray(a[k], np.float64)
                                   - np.asarray(b[k], np.float64))))
               for k in a)


def run_query(eng, query, timeout=600):
    """Execute ``query`` twice on ``eng``: the first run pays the
    engine's first-use costs (CUDA context and library handles of each
    worker thread, kernel loading), the second is warm.  Returns the
    warm response and ``{"cold_s", "warm_s"}`` host wall times."""
    times = []
    for _ in range(2):
        t0 = time.monotonic()
        res = eng.execute(query, timeout=timeout)
        times.append(time.monotonic() - t0)
        if res["stats"]["failed"]:
            raise SmokeFailure(f"query failed: {res['stats']}")
    return res, {"cold_s": times[0], "warm_s": times[1]}


def fmt(t: dict) -> str:
    return f"cold {t['cold_s'] * 1e3:.3f} ms, warm {t['warm_s'] * 1e3:.3f} ms"


# --------------------------------------------------------------- phases
def phase_static_hash(VDMSAsyncEngine, TransportModel, device="cuda"):
    print("phase 2: static hash on the card", flush=True)
    transport = TransportModel(network_latency_s=0.001, service_time_s=0.001)
    pipe = [
        {"type": "crop", "x": 4, "y": 4, "width": 24, "height": 24},
        {"type": "remote", "url": "http://svc/flip",
         "options": {"id": "flip"}},
        {"type": "rotate", "k": 1},
        {"type": "threshold", "value": 0.5},
    ]
    eng = VDMSAsyncEngine(device=device, num_remote_servers=2,
                          transport=transport)
    try:
        fill(eng, 8, 32, "dsp")
        res, dt = run_query(eng, find("dsp", pipe))
    finally:
        eng.shutdown()
    digest = response_hash(res["entities"])
    print(f"  sha256 {digest}; {fmt(dt)}", flush=True)
    check(res["stats"]["failed"] == 0, "static-hash query: failed == 0")
    check(digest == STATIC_SHA256, "static hash equals the recorded 778564da…")
    return {"sha256": digest, "query": dt}


def phase_native(VDMSAsyncEngine, TransportModel, faces, launches,
                 device="cuda"):
    import numpy as np
    import torch
    from repro_torch.kernels.ref import gaussian_blur_ref
    print("phase 3: native path at LFW scale (64 x 250x250x3)", flush=True)
    transport = TransportModel(network_latency_s=0.002, service_time_s=0.001)
    blur_q = find("lfw", IQ3_BLUR)
    c2_q = find("lfw", C2_PIPE)
    out = {}
    results = {}
    for dev in (device, "cpu"):
        eng = VDMSAsyncEngine(device=dev, num_remote_servers=2,
                              transport=transport)
        try:
            eids = ingest_faces(eng, faces, "lfw")
            k1_before = launches["gaussian_blur"].count
            blur_res, blur_s = run_query(eng, blur_q)
            k1_blur = launches["gaussian_blur"].count - k1_before
            c2_res, c2_s = run_query(eng, c2_q)
        finally:
            eng.shutdown()
        check(blur_res["stats"]["failed"] == 0
              and c2_res["stats"]["failed"] == 0,
              f"IQ3 blur and C2 on device={dev}: failed == 0")
        results[dev] = (blur_res["entities"], c2_res["entities"])
        out[dev] = {"iq3_blur": blur_s, "c2": c2_s,
                    "k1_launches": k1_blur}
        print(f"  device={dev}: IQ3 blur {fmt(blur_s)}; C2 {fmt(c2_s)}; "
              f"K1 launches {k1_blur}", flush=True)
    check(device == "cpu" or out[device]["k1_launches"] >= len(faces),
          f"native blur launched K1 >= {len(faces)} times")
    ref = gaussian_blur_ref(torch.from_numpy(faces), 5, 1.5).numpy()
    got = np.stack([results[device][0][eid] for eid in eids])
    err = float(np.max(np.abs(got - ref)))
    out["iq3_max_abs_err_vs_plain_host"] = err
    check(err <= NATIVE_TOL,
          f"IQ3 blur on the card vs plain on the host: {err:.3g} <= {NATIVE_TOL}")
    err = max_err(results[device][1], results["cpu"][1])
    out["c2_max_abs_err_vs_cpu_engine"] = err
    check(err <= PIPE_TOL,
          f"C2 on the card vs the CPU engine: {err:.3g} <= {PIPE_TOL}")
    return out


DEVICE_PIPE = [
    {"type": "resize", "width": 256, "height": 256},
    {"type": "crop", "x": 16, "y": 16, "width": 224, "height": 224},
    {"type": "normalize", "mean": 0.45, "std": 0.22},
    {"type": "blur", "ksize": 9, "sigma_x": 2.0},
]
# cost overrides that place every op of DEVICE_PIPE on the device backend
DEVICE_PINNED = {o["type"]: {"device": 1e-6, "native": 10.0,
                             "remote": 10.0, "batcher": 10.0}
                 for o in DEVICE_PIPE}


def phase_device(VDMSAsyncEngine, TransportModel, faces, launches,
                 device="cuda"):
    print("phase 4: device backend (256 x 250x250x3, batch 32)", flush=True)
    transport = TransportModel(network_latency_s=0.002, service_time_s=0.001)
    query = find("lfw", DEVICE_PIPE)
    # True: every visible card (one here); "cpu" for a rehearsal
    backend = True if device == "cuda" else device
    eng = VDMSAsyncEngine(device=device, num_remote_servers=2,
                          transport=transport, dispatch="cost",
                          device_backend=backend, device_batch_size=32,
                          device_max_wait_ms=50.0,
                          cost_overrides=DEVICE_PINNED)
    try:
        ingest_faces(eng, faces, "lfw")
        before = {k: c.count for k, c in launches.items()}
        dev_res, dev_s = run_query(eng, query)
        rose = {k: c.count - before[k] for k, c in launches.items()}
        stats = eng.dispatch_stats()
    finally:
        eng.shutdown()
    eng = VDMSAsyncEngine(device=device, num_remote_servers=2,
                          transport=transport, dispatch="native")
    try:
        ingest_faces(eng, faces, "lfw")
        nat_res, nat_s = run_query(eng, query)
    finally:
        eng.shutdown()
    dev = stats["device"]
    print(f"  device arm {fmt(dev_s)}; all-native arm {fmt(nat_s)}; "
          f"launches {rose}; placements "
          f"{stats.get('placements')}; fused_segments "
          f"{dev['fused_segments']}, groups {dev['groups_run']}, "
          f"compiles {dev['compiles']}", flush=True)
    check(dev_res["stats"]["failed"] == 0 and nat_res["stats"]["failed"] == 0,
          "device and all-native arms: failed == 0")
    check(dev["platform"] == device, f"device backend runs on {device}")
    check(dev["fused_segments"] > 0, "fused_segments > 0")
    check(device == "cpu" or rose["fused_resize_crop_normalize"] > 0,
          "device arm launched the fused preprocess kernel")
    check(device == "cpu" or rose["gaussian_blur"] > 0,
          "device arm launched the blur kernel")
    err = max_err(dev_res["entities"], nat_res["entities"])
    check(err <= PIPE_TOL,
          f"device arm vs all-native on the card: {err:.3g} <= {PIPE_TOL}")
    return {"device_arm": dev_s, "native_arm": nat_s,
            "launches": rose, "max_abs_err_vs_native": err,
            "fused_segments": dev["fused_segments"],
            "groups_run": dev["groups_run"], "compiles": dev["compiles"],
            "placements": stats.get("placements")}


def time_ms(fn, flush, reps=30):
    """Median device time of ``fn()`` in ms: CUDA events around each
    call, the L2 cache flushed before each (the caller finds its inputs
    cold), and a device-side sleep enqueued ahead of the start event so
    the host has queued all of ``fn``'s work before the clock starts —
    without it an idle card would time the wrapper's host overhead."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ssd_inputs(rng, B, T, H, P, G, N, dtype):
    """x ~ N(0,1), dt = softplus(N(0,1)) / 2, A = -exp(0.3 N), B, C ~
    0.5 N, D = |0.1 N|, h0 ~ 0.1 N (the JAX package's kernel-test
    inputs), drawn with numpy and moved to the card."""
    import numpy as np
    import torch

    def n(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).cuda()

    x = n((B, T, H, P)).to(dtype)
    dt = torch.nn.functional.softplus(n((B, T, H))) * 0.5
    A = -torch.exp(n((H,), 0.3))
    Bm, Cm = n((B, T, G, N), 0.5).to(dtype), n((B, T, G, N), 0.5).to(dtype)
    return x, dt, A, Bm, Cm, n((H,), 0.1).abs(), n((B, H, P, N), 0.1)


def ssd_work(B, T, H, P, G, N, chunk, itemsize):
    """Bytes and operations of one SSD call.  Bytes: x and y in their
    type, B and C by group (never repeated to heads), dt, A, D and both
    states in float32, each once.  Operations, per (batch, head) chunk
    of n steps: the causal half of C Bᵀ (n(n+1)/2 dots of N, then the
    decay and dt factors), its product with x (n(n+1)/2 * P), the
    inter-chunk C·h and D skip (n * (2NP + 4P)) and the state update
    (n * (2NP + 3P) + NP)."""
    c = min(chunk, max(T, 8))
    nbytes = (2 * B * T * H * P + 2 * B * T * G * N) * itemsize \
        + (B * T * H + 2 * H + 2 * B * H * P * N) * 4
    flops = 0
    for t0 in range(0, T, c):
        n = min(c, T - t0)
        pairs = n * (n + 1) // 2
        flops += pairs * (2 * N + 3) + pairs * 2 * P
        flops += n * (2 * N * P + 4 * P) + n * (2 * N * P + 3 * P) + N * P
    return nbytes, flops * B * H


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / FP32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels():
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import preprocess as pp
    from repro_torch.kernels import ref
    from repro_torch.kernels.gaussian_blur import gaussian_blur_cuda
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_cuda
    from repro_torch.kernels.ref import gaussian_blur_ref, gaussian_kernel_1d
    print("phase 5: kernels against their plain versions", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    rows, entries = [], {}

    def blur_case(shape, ksize, sigma):
        x = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).cuda()
        got = gaussian_blur_cuda(x, ksize, sigma)
        want = gaussian_blur_ref(x, ksize, sigma)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= K1_TOL, f"K1 {shape} k{ksize}: max_abs_err {err:.3g} <= {K1_TOL}")
        c = shape[-1]
        taps = torch.from_numpy(gaussian_kernel_1d(ksize, sigma)).cuda()
        wy = taps.view(1, 1, ksize, 1).expand(c, 1, ksize, 1).contiguous()
        wx = taps.view(1, 1, 1, ksize).expand(c, 1, 1, ksize).contiguous()
        pad = ksize // 2

        def library():  # composition: reflect pad + two depthwise conv2d
            y = x.permute(0, 3, 1, 2)
            y = F.pad(y, (pad, pad, pad, pad), mode="reflect")
            y = F.conv2d(y, wy, groups=c)
            return F.conv2d(y, wx, groups=c).permute(0, 2, 3, 1)

        lib_err = float((library() - want).abs().max())
        n, h, w, _ = shape
        nbytes = 2 * n * h * w * c * 4
        flops = 4 * ksize * n * h * w * c
        return {
            "shape": list(shape), "ksize": ksize, "sigma": sigma,
            "max_abs_err": err,
            "ms": time_ms(lambda: gaussian_blur_cuda(x, ksize, sigma), flush),
            "plain_ms": time_ms(lambda: gaussian_blur_ref(x, ksize, sigma), flush),
            "library_ms": time_ms(library, flush),
            "library_call": "F.pad(reflect) + 2 x depthwise F.conv2d "
                            "(a composition; no single torch call)",
            "library_max_abs_err": lib_err,
            "bytes": nbytes, "flops": flops,
            "bound_ms": max(nbytes / HBM_BYTES_S, flops / FP32_FLOP_S) * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_S
                         >= flops / FP32_FLOP_S else "operations"),
        }

    def preprocess_case(n, size, kw):
        x = torch.from_numpy(
            rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)).cuda()
        got = pp.fused_resize_crop_normalize_cuda(x, **kw)
        want = pp.fused_resize_crop_normalize_ref(x, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= K2_TOL, f"K2 {tuple(x.shape)}: max_abs_err {err:.3g} <= {K2_TOL}")
        ry, rx = pp._cropped_matrices(
            size, size, kw["resize_h"], kw["resize_w"],
            pp._canonical_method(kw["method"]), kw["crop_x"], kw["crop_y"],
            kw["crop_w"], kw["crop_h"])
        ry_t, rx_t = torch.from_numpy(ry.copy()).cuda(), torch.from_numpy(rx.copy()).cuda()

        def library():  # one einsum: the cropped resize
            return torch.einsum("oh,nhwc,pw->nopc", ry_t, x, rx_t)

        hc, wc, c = got.shape[1], got.shape[2], 3
        nbytes = (x.numel() + got.numel() + ry.size + rx.size) * 4
        nnz_y, nnz_x = int((ry != 0).sum()), int((rx != 0).sum())
        flops = (2 * n * c * (nnz_y * size + hc * nnz_x)
                 + 2 * n * hc * wc * c)
        dense_flops = 2 * n * c * (hc * size * size + hc * wc * size)
        return {
            "shape": [n, size, size, 3], "params": kw,
            "max_abs_err": err,
            "ms": time_ms(lambda: pp.fused_resize_crop_normalize_cuda(x, **kw), flush),
            "plain_ms": time_ms(
                lambda: pp.fused_resize_crop_normalize_ref(x, **kw), flush),
            "library_ms": time_ms(library, flush),
            "library_call": "torch.einsum('oh,nhwc,pw->nopc') of the "
                            "cropped matrices (no normalize)",
            "bytes": nbytes, "flops": flops, "dense_flops": dense_flops,
            "dense_fp32_ms": dense_flops / FP32_FLOP_S * 1e3,
            "bound_ms": max(nbytes / HBM_BYTES_S, flops / FP32_FLOP_S) * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_S
                         >= flops / FP32_FLOP_S else "operations"),
        }

    def ssd_case(B, T, H, P, G, N, dtype=torch.float32, chunk=128):
        x, dt, A, Bm, Cm, D, h0 = ssd_inputs(rng, B, T, H, P, G, N, dtype)
        c = min(chunk, max(T, 8))
        y, h = mamba2_ssd_cuda(x, dt, A, Bm, Cm, D, h0, chunk=chunk)
        y_p, h_p = ref.mamba2_ssd_chunked(x, dt, A, Bm, Cm, D, h0, chunk=c)
        torch.cuda.synchronize()
        dy, dh = (y.float() - y_p.float()).abs(), (h - h_p).abs()
        err = max(float(dy.max()), float(dh.max()))
        what = (f"K4 {(B, T, H, P)} G={G} N={N} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3g}")
        if dtype == torch.float32:
            check(err <= K4_TOL, f"{what} <= {K4_TOL}")
        else:
            excess = max(float((dy - K4_BF16_RTOL * y_p.float().abs()).max()),
                         float((dh - K4_BF16_RTOL * h_p.abs()).max()))
            check(excess <= K4_BF16_ATOL,
                  f"{what}; beyond {K4_BF16_RTOL:.4g} relative: "
                  f"{excess:.3g} <= {K4_BF16_ATOL}")
        nbytes, flops = ssd_work(B, T, H, P, G, N, chunk, x.element_size())
        bound_ms, bound_by = bound(nbytes, flops)
        return {
            "shape": [B, T, H, P], "G": G, "N": N, "chunk": c,
            "dtype": str(dtype), "max_abs_err": err,
            "ms": time_ms(lambda: mamba2_ssd_cuda(x, dt, A, Bm, Cm, D, h0,
                                                  chunk=chunk), flush),
            "plain_ms": time_ms(lambda: ref.mamba2_ssd_chunked(
                x, dt, A, Bm, Cm, D, h0, chunk=c), flush, reps=10),
            "library_ms": None,
            "library_call": "none: no single PyTorch call computes SSD",
            "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }

    def ssd_model_layout():
        """x, B and C as the model hands them over: strided slices of one
        packed in-projection (B=2, T=130, H=80, P=N=64)."""
        Bsz, T, H, P, N = 2, 130, 80, 64, 64
        x, dt, A, Bm, Cm, D, h0 = ssd_inputs(rng, Bsz, T, H, P, 1, N,
                                             torch.float32)
        packed = torch.cat([x.reshape(Bsz, T, H * P), Bm.reshape(Bsz, T, N),
                            Cm.reshape(Bsz, T, N)], dim=-1)
        xv, bv, cv = torch.split(packed, [H * P, N, N], dim=-1)
        y, h = mamba2_ssd_cuda(xv.reshape(Bsz, T, H, P), dt, A,
                               bv.reshape(Bsz, T, 1, N),
                               cv.reshape(Bsz, T, 1, N), D, h0)
        y_p, h_p = ref.mamba2_ssd_chunked(x, dt, A, Bm, Cm, D, h0)
        torch.cuda.synchronize()
        err = max(float((y - y_p).abs().max()), float((h - h_p).abs().max()))
        check(err <= K4_TOL, f"K4 on strided slices of a packed in-projection: "
              f"max_abs_err {err:.3g} <= {K4_TOL}")
        return {"shape": [Bsz, T, H, P], "strided": True, "max_abs_err": err}

    entries["gaussian_blur"] = blur_case((32, 224, 224, 3), 9, 2.0)
    rows.append(entries["gaussian_blur"])
    rows.append(blur_case((1, 250, 250, 3), 5, 1.5))
    rows.append(blur_case((1, 1080, 1920, 3), 5, 1.5))
    entries["fused_resize_crop_normalize"] = preprocess_case(
        32, 250, dict(resize_h=256, resize_w=256, method="bilinear",
                      crop_x=16, crop_y=16, crop_w=224, crop_h=224,
                      mean=0.45, std=0.22))
    rows.append(entries["fused_resize_crop_normalize"])
    # K4 at launch.model_serve's prefill shape (16 x 512 tokens, zamba2's
    # 80 heads of 64, state 64, one group), the model UDF's 3-token
    # prompts, grouped B/C, and bfloat16
    entries["mamba2_ssd"] = ssd_case(16, 512, 80, 64, 1, 64)
    rows.append(entries["mamba2_ssd"])
    rows.append(ssd_case(16, 3, 80, 64, 1, 64))
    rows.append(ssd_case(16, 512, 80, 64, 8, 64))
    rows.append(ssd_case(16, 512, 80, 64, 1, 64, torch.bfloat16))
    for r in rows:
        print("  " + json.dumps({k: r[k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")}), flush=True)
    rows.append(ssd_model_layout())
    return entries, rows


def kernels_line(entries, path_launches):
    """The ``{"kernels": [...]}`` entries: each kernel's phase-5 row at
    its main shape, with its launches on the path that runs it."""
    meta = {
        "gaussian_blur": ("src/repro_torch/kernels/csrc/gaussian_blur.cu",
                          "src/repro/kernels/gaussian_blur.py:44"),
        "fused_resize_crop_normalize": (
            "src/repro_torch/kernels/csrc/preprocess.cu",
            "src/repro/kernels/preprocess.py:79"),
        "mamba2_ssd": ("src/repro_torch/kernels/csrc/mamba2_ssd.cu",
                       "src/repro/kernels/mamba2_ssd.py:68"),
    }
    kernels = []
    for name, e in entries.items():
        source, replaces = meta[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path_launches[name],
            "max_abs_err": e["max_abs_err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": e["library_ms"],
            "library_call": e["library_call"], "shape": e["shape"]})
    return kernels


def phase_model(launches, device="cuda", reduced=False, requests=16,
                prompt_len=512, gen=16, n_images=16):
    """The model path: ``launch.model_serve.run``, the forward-consistency
    check and the model UDF through the engine's three arms.  ``device``
    and ``reduced`` let a host without a card rehearse it."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.core.remote import TransportModel
    from repro_torch.core.udf import register_model_udf
    from repro_torch.distributed.sharding import REPLICATED
    from repro_torch.launch import model_serve
    from repro_torch.models import get_model
    from repro_torch.visual.font import draw_text
    cfg = get_arch(ARCH, reduced=reduced)
    on_card = device == "cuda"
    print(f"phase 6: model path, {cfg.name} ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.param_count() / 1e9:.3f} B params)",
          flush=True)
    out = {"arch": cfg.name, "params": cfg.param_count()}
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # -- the launcher: prefill + decode, twice (the first pays set-up)
    serve = []
    for run_i in range(2):
        r = model_serve.run(ARCH, reduced=reduced, requests=requests,
                            prompt_len=prompt_len, gen=gen, device=device)
        gen_toks = r.pop("generated")
        r["generated_ok"] = bool(gen_toks.shape == (requests, gen)
                                 and (gen_toks >= 0).all()
                                 and (gen_toks < cfg.vocab_size).all())
        r["prefill_ms"], r["decode_ms"] = r["prefill_s"] * 1e3, \
            r["decode_s"] * 1e3
        serve.append(r)
        print(f"  model_serve {'cold' if run_i == 0 else 'warm'}: "
              f"{requests} x {prompt_len} tokens, prefill "
              f"{r['prefill_ms']:.3f} ms, {gen} decode steps "
              f"{r['decode_ms']:.3f} ms, {r['tokens_per_s']:.3f} tokens/s",
              flush=True)
        check(r["generated_ok"], f"generated tokens: shape ({requests}, "
              f"{gen}), inside the vocabulary")
    out["serve"] = serve

    # -- prefill + decode against the no-cache forward
    api = get_model(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(1))
    S, extra = 16, 4
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, S + extra)).astype(np.int32)).to(device)
    full, _ = api.forward(params, {"tokens": toks}, REPLICATED)
    lg, cache = api.prefill(params, {"tokens": toks[:, :S]}, REPLICATED,
                            S + extra + 1)
    errs = [float((lg - full[:, S - 1]).abs().max())]
    for i in range(extra):
        lg, cache = api.decode_step(params, toks[:, S + i:S + i + 1], cache,
                                    S + i, REPLICATED)
        errs.append(float((lg - full[:, S + i]).abs().max()))
    finite = bool(torch.isfinite(full).all())
    out["forward_consistency"] = {"max_abs_err": max(errs), "per_step": errs,
                                  "logit_absmax": float(full.abs().max())}
    print(f"  prefill + {extra} decode steps vs forward: max_abs_err "
          f"{max(errs):.3g} (logits up to {float(full.abs().max()):.3g})",
          flush=True)
    check(finite and full.shape == (2, S + extra, cfg.padded_vocab),
          "forward logits finite, shape (2, 20, padded vocab)")
    check(max(errs) <= MODEL_TOL,
          f"prefill/decode logits vs forward: {max(errs):.3g} <= {MODEL_TOL}")
    del params, full, cache, lg

    # -- the model UDF through the engine's three arms
    register_model_udf(MODEL_UDF, arch=ARCH, reduced=reduced, device=device)
    query = find("lm", [{"type": "udf", "options": {"id": MODEL_UDF}}])
    off = {"native": 10.0, "remote": 10.0}
    arms = {
        "per_entity": dict(dispatch="native"),
        "batcher": dict(dispatch="cost", cost_overrides={
            MODEL_UDF: {**off, "batcher": 1e-6}}),
        "device_backend": dict(
            dispatch="cost", device_backend=True if on_card else device,
            cost_overrides={MODEL_UDF: {**off, "batcher": 10.0,
                                        "device": 1e-6}}),
    }
    transport = TransportModel(network_latency_s=0.001, service_time_s=0.001)
    responses, out["arms"] = {}, {}
    for arm, kw in arms.items():
        eng = VDMSAsyncEngine(device=device, num_remote_servers=1,
                              transport=transport, **kw)
        try:
            fill(eng, n_images, 32, "lm")
            k4 = launches["mamba2_ssd"].count
            res, dt = run_query(eng, query)
            stats = eng.dispatch_stats()
        finally:
            eng.shutdown()
        responses[arm] = res["entities"]
        out["arms"][arm] = {"query": dt, "placements": stats.get("placements"),
                            "k4_launches": launches["mamba2_ssd"].count - k4}
        print(f"  {arm} arm: {n_images} images, {fmt(dt)}; placements "
              f"{stats.get('placements')}; K4 launches "
              f"{out['arms'][arm]['k4_launches']}", flush=True)
    # which label each image carries: the stamp that reproduces it
    rng = np.random.default_rng(11)    # fill()'s images
    labels = []
    for eid in responses["per_entity"]:
        img = torch.from_numpy(rng.uniform(0, 1, (32, 32, 3))
                               .astype(np.float32))
        got = responses["per_entity"][eid]
        diff = {lab: float(np.abs(draw_text(img, lab, 4, 4).numpy() - got)
                           .max()) for lab in ("WALK", "RUN", "JUMP", "SIT")}
        labels.append(min(diff, key=diff.get))
    out["labels"] = labels
    print(f"  labels (per entity): {labels}", flush=True)
    for arm in ("batcher", "device_backend"):
        same = list(responses[arm]) == list(responses["per_entity"]) and all(
            np.array_equal(responses[arm][e], responses["per_entity"][e])
            for e in responses["per_entity"])
        check(same, f"{arm} arm stamps the per-entity arm's labels exactly")
    if on_card:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        print(f"  peak device memory {out['peak_memory_bytes'] / 2**30:.3f} "
              "GiB", flush=True)
    return out


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        raise SmokeFailure("nvidia-smi printed nothing")
    return out[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    t_start = time.monotonic()
    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.core.remote import TransportModel
    from repro_torch.dataio.synthetic import synthetic_faces
    from repro_torch.kernels import _build
    from repro_torch.kernels import gaussian_blur as gb
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import preprocess as pp

    print("phase 1: build and identify", flush=True)
    t0 = time.monotonic()
    paths = _build.build_all()
    build_s = time.monotonic() - t0
    for name, path in paths.items():
        report = [ln.strip() for ln in path.with_suffix(".log").read_text()
                  .splitlines() if "registers" in ln or "spill" in ln]
        print(f"  built {name} -> {path.name}: " + " | ".join(report),
              flush=True)
    print(f"  build {build_s:.3f} s", flush=True)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"  card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {count} device(s)", flush=True)

    faces64 = synthetic_faces(64, 250, seed=0)
    faces256 = synthetic_faces(256, 250, seed=1)
    launches = {"gaussian_blur": gb.launches,
                "fused_resize_crop_normalize": pp.launches,
                "mamba2_ssd": ssd.launches}
    engine_path = ("gaussian_blur", "fused_resize_crop_normalize")

    # ---- the engine's image path: counts zeroed just before, read just after
    for c in launches.values():
        c.reset()
    details = {"build_s": build_s, "card": smi}
    details["static_hash"] = phase_static_hash(VDMSAsyncEngine, TransportModel)
    details["native"] = phase_native(VDMSAsyncEngine, TransportModel,
                                     faces64, launches)
    details["device"] = phase_device(VDMSAsyncEngine, TransportModel,
                                     faces256, launches)
    main_launches = {k: launches[k].count for k in engine_path}
    print(f"  engine-path launches: {main_launches}", flush=True)
    for name, n in main_launches.items():
        check(n > 0, f"{name} launched on the engine path ({n})")

    entries, rows = phase_kernels()
    details["kernels"] = rows

    # ---- the model path: counts zeroed just before, read just after
    for c in launches.values():
        c.reset()
    details["model"] = phase_model(launches)
    model_launches = {k: c.count for k, c in launches.items()}
    print(f"  model-path launches: {model_launches}", flush=True)
    check(model_launches["mamba2_ssd"] > 0,
          f"mamba2_ssd launched on the model path "
          f"({model_launches['mamba2_ssd']})")
    kernels = kernels_line(entries, {
        **main_launches, "mamba2_ssd": model_launches["mamba2_ssd"]})
    details["seconds"] = time.monotonic() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1, default=str)
    print(f"total {details['seconds']:.3f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
