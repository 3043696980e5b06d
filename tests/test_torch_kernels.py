"""Kernel layer of the PyTorch port held against the JAX package.

On the CPU the port's kernel wrappers take their plain versions, so these
tests hold the plain versions (and the resize matrices the fused
preprocess kernel consumes) against the JAX package's Pallas kernels,
run in interpret mode, and its references.  The CUDA kernels themselves
run only on a card: ``tests/test_torch_cuda.py`` holds them against the
plain versions there (it imports no JAX, so it runs on a card's host).

Tolerances (absolute, float32 images in [0, 1]):
- blur: 1e-6 — the same taps summed in the same order; only the
  compiler's rounding of the reference can differ;
- resize matrices: 1e-6 — the same float32 formula, a few ulps apart
  where XLA and numpy order a reduction differently; nearest: exact;
- fused preprocess: 1e-5 — two matrix products in another order than
  XLA's;
- Mamba2 SSD: 2e-4 in float32 (the JAX package's own tolerance for its
  chunked and Pallas paths against the sequential oracle,
  ``tests/test_kernels.py``), 5e-2 in bfloat16 (the same);
- RWKV6 WKV: 2e-4 in float32 and 5e-2 in bfloat16 (the JAX package's
  own tolerances for its chunked and Pallas paths against the sequential
  oracle, ``tests/test_kernels.py``); state continuity 1e-4 (the same);
- attention: 1e-5 — the same float32 softmax over the same products;
  the flash routes against the Pallas kernel: 2e-5 in float32 and 2e-2
  (absolute and relative) in bfloat16, the JAX package's tolerances for
  its flash kernel against the naive oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import preprocess as jpp
from repro.kernels import ref as jref
from repro.kernels.gaussian_blur import gaussian_blur_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.flash_vjp import flash_attention as jax_flash_vjp
from repro.kernels.mamba2_ssd import mamba2_ssd_pallas
from repro.kernels.rwkv6_scan import rwkv6_scan_pallas
from repro_torch.kernels import flash_vjp as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import preprocess as tpp
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

BLUR_TOL = 1e-6
RESIZE_TOL = 1e-6
PREPROCESS_TOL = 1e-5
SSD_TOL = 2e-4
SSD_BF16_TOL = 5e-2
WKV_TOL = 2e-4
WKV_BF16_TOL = 5e-2
ATTN_TOL = 1e-5
FLASH_TOL = 2e-5
FLASH_BF16_TOL = 2e-2


def _uniform(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


# ----------------------------------------------------------------- blur
@pytest.mark.parametrize("shape", [(2, 40, 32, 3), (1, 17, 23, 3)])
@pytest.mark.parametrize("ksize,sigma", [(3, 1.0), (5, 0.0), (7, 2.5)])
def test_blur_plain_matches_pallas_and_ref(shape, ksize, sigma):
    img = _uniform(ksize, shape)
    pallas = np.asarray(gaussian_blur_pallas(jnp.asarray(img), ksize, sigma,
                                             block_rows=8, interpret=True))
    jax_ref = np.asarray(jref.gaussian_blur_ref(jnp.asarray(img), ksize, sigma))
    got = tops.gaussian_blur(torch.from_numpy(img), ksize, sigma).numpy()
    np.testing.assert_allclose(got, pallas, atol=BLUR_TOL, rtol=0)
    np.testing.assert_allclose(got, jax_ref, atol=BLUR_TOL, rtol=0)


def test_blur_taps_and_reflect_padding_match():
    for ksize, sigma in [(3, 1.0), (5, 0.0), (9, 2.0), (4, 1.2)]:
        np.testing.assert_array_equal(tref.gaussian_kernel_1d(ksize, sigma),
                                      jref.gaussian_kernel_1d(ksize, sigma))
    # reflect-101, also when the pad exceeds the axis (repeated reflection)
    for n, pad in [(5, 2), (3, 4), (2, 3), (1, 2)]:
        x = np.arange(n, dtype=np.float32)
        want = np.asarray(jref._reflect101_pad(jnp.asarray(x), pad, axis=0))
        np.testing.assert_array_equal(x[tref.reflect101_index(n, pad)], want)


def test_blur_preserves_mean_and_batches():
    img = _uniform(3, (3, 32, 32, 3))
    out = tops.gaussian_blur(torch.from_numpy(img), 5, 1.5)
    assert abs(float(out.mean()) - float(img.mean())) < 1e-2
    one = tops.gaussian_blur(torch.from_numpy(img[1]), 5, 1.5)
    np.testing.assert_array_equal(out[1].numpy(), one.numpy())


@pytest.mark.parametrize("shape,ksize,sigma", [
    ((1, 30, 140, 2), 65, 0.0),    # past the fast route's 63 taps
    ((1, 20, 23, 1), 99, 12.0),
    ((1, 12, 9, 3), 127, 0.0),     # pad 63: past H and W, repeated
    ((2, 16, 18, 64), 5, 1.5),     # (ksize // 2) * C = 128 floats of halo
    ((1, 3, 4, 3), 11, 2.0),       # pad 5 >= H and >= W
    ((1, 1, 5, 2), 64, 0.0),       # one row, an even window
])
def test_blur_plain_matches_jax_at_any_window(shape, ksize, sigma):
    """The windows and channel counts that the CUDA kernel's general
    route serves: the plain version against the JAX package's
    reference (under ``jit``: one compile, where run op by op every
    slice of the window compiles apart)."""
    img = _uniform(ksize, shape)
    blur = jax.jit(jref.gaussian_blur_ref, static_argnums=(1, 2))
    want = np.asarray(blur(jnp.asarray(img), ksize, sigma))
    got = tops.gaussian_blur(torch.from_numpy(img), ksize, sigma).numpy()
    np.testing.assert_allclose(got, want, atol=BLUR_TOL, rtol=0)


# --------------------------------------------------------------- resize
METHODS = ["nearest", "linear", "bilinear", "cubic", "lanczos3", "lanczos5"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n_in,n_out", [(9, 23), (23, 9), (250, 256),
                                        (250, 48), (17, 17), (1, 5), (7, 1)])
def test_resize_matrix_matches_jax(method, n_in, n_out):
    want = jpp.resize_matrix(n_in, n_out, method)
    got = tpp.resize_matrix(n_in, n_out, method)
    assert got.shape == want.shape == (n_out, n_in)
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0)


def test_band_limits_cover_every_nonzero():
    for method in ("linear", "lanczos3"):
        m = tpp.resize_matrix(250, 48, method)
        lo, hi = tpp.band_limits(m)
        cols = np.arange(m.shape[1])[None, :]
        outside = (cols < lo[:, None]) | (cols > hi[:, None])
        assert not np.any(m[outside])
        assert np.all(m[np.arange(m.shape[0]), lo] != 0)
    lo, hi = tpp.band_limits(np.zeros((2, 3), np.float32))
    assert list(lo) == [0, 0] and list(hi) == [-1, -1]


# ----------------------------------------------------------- preprocess
PREPROCESS_CASES = [
    # (N, H, W), resize (h, w), crop (x, y, w, h), method
    ((2, 31, 29), (40, 36), (3, 5, 20, 24), "bilinear"),     # odd sizes
    ((1, 40, 48), (24, 20), (10, 12, 30, 30), "bilinear"),   # clamped crop
    ((2, 64, 50), (16, 12), (0, 0, 16, 12), "linear"),       # downsample
    ((1, 20, 20), (33, 27), (-4, 50, 8, 9), "cubic"),        # start clamps
]


@pytest.mark.parametrize("shape,res,crop,method", PREPROCESS_CASES)
def test_fused_preprocess_plain_matches_pallas(shape, res, crop, method):
    img = _uniform(sum(shape), shape + (3,))
    kw = dict(resize_h=res[0], resize_w=res[1], method=method,
              crop_x=crop[0], crop_y=crop[1], crop_w=crop[2],
              crop_h=crop[3], mean=0.45, std=0.22)
    want = np.asarray(jpp.fused_resize_crop_normalize_pallas(
        jnp.asarray(img), interpret=True, **kw))
    got = tops.fused_preprocess(torch.from_numpy(img), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=PREPROCESS_TOL, rtol=0)
    # the folded matrices the CUDA kernel consumes give the same result
    ry, rx = tpp._cropped_matrices(shape[1], shape[2], res[0], res[1],
                                   tpp._canonical_method(method), *crop[:2],
                                   *crop[2:])
    folded = (np.einsum("oh,nhwc,pw->nopc", ry.astype(np.float64), img,
                        rx.astype(np.float64)) - np.float32(0.45)) \
        / np.float32(0.22)
    np.testing.assert_allclose(got, folded, atol=PREPROCESS_TOL, rtol=0)


def _k2_mirror(img, tables, plan, mean, std):
    """The CUDA kernel's order in float64, CTA by CTA with its index
    arithmetic (``csrc/preprocess.cu``): on the tiled route each tile's
    vertical pass over the tap table's windows into a shared tile, then
    its horizontal pass and the affine; on the direct route each
    thread's 2 x 2 windows; on the wide route its two passes.  Checks
    that every read lies inside the image and the tile, and that every
    output is written once."""
    (ys, yt), (xs, xt) = tables
    n, hi, wi, c = img.shape
    hc, py = yt.shape
    wc, px = xt.shape
    if plan["route"] == "direct":
        return _k2_direct_mirror(img, tables, plan, mean, std)
    if plan["route"] == "wide":
        return _k2_wide_mirror(img, tables, plan, mean, std)
    rows_, cols_, cb_, ld = (plan[k] for k in ("rows", "cols", "cb", "ld"))
    ncg = -(-c // cb_)
    assert plan["grid"] == (-(-wc // cols_), -(-hc // rows_), n * ncg)
    flat = img.astype(np.float64).reshape(-1)
    out = np.zeros(n * hc * wc * c)
    written = np.zeros(out.size, np.int64)
    rowf, orow = wi * c, wc * c
    for bz in range(n * ncg):
        nn = bz // ncg
        c0 = (bz - nn * ncg) * cb_
        cb = min(cb_, c - c0)
        packed = cb == c
        for by in range(plan["grid"][1]):
            i0 = by * rows_
            rows = min(rows_, hc - i0)
            for bx in range(plan["grid"][0]):
                j0 = bx * cols_
                cols = min(cols_, wc - j0)
                xlo = xs[j0]
                width = (xs[j0 + cols - 1] + px - xlo) * cb
                assert width <= ld
                g = np.arange(width)
                off = g if packed else (g // cb) * c + g % cb
                base = nn * hi * rowf + xlo * c + c0
                tile = np.zeros((rows, ld))
                for r in range(rows):
                    i = i0 + r
                    idx = [base + off + (ys[i] + p) * rowf for p in range(py)]
                    assert min(a.min() for a in idx) >= 0
                    assert max(a.max() for a in idx) < flat.size
                    tile[r, :width] = sum(np.float64(yt[i, p]) * flat[idx[p]]
                                          for p in range(py))
                f = np.arange(cols * cb)
                jj, cc = f // cb, f % cb
                j = j0 + jj
                t = (xs[j] - xlo) * cb + cc
                assert t.min() >= 0 and (t + (px - 1) * cb).max() < width
                o = (nn * hc + i0) * orow + j0 * c + c0 \
                    + (f if packed else jj * c + cc)
                for r in range(rows):
                    acc = sum(xt[j, p].astype(np.float64) * tile[r, t + p * cb]
                              for p in range(px))
                    out[o + r * orow] = (acc - np.float32(mean)) \
                        / np.float32(std)
                    written[o + r * orow] += 1
    assert np.all(written == 1)
    return out.reshape(n, hc, wc, c)


def _k2_wide_mirror(img, tables, plan, mean, std):
    """The wide route: a vertical pass over the scratch image's columns
    ``xlo .. x1 - 1``, a thread per scratch float, then a horizontal pass
    and the affine, a thread per output float."""
    (ys, yt), (xs, xt) = tables
    n, hi, wi, c = img.shape
    hc, py = yt.shape
    wc, px = xt.shape
    xlo, x1 = plan["xlo"], plan["x1"]
    assert 0 <= xlo and x1 <= wi and x1 - xlo >= px
    rowt, rowf = (x1 - xlo) * c, wi * c
    flat = img.astype(np.float64).reshape(-1)
    tmp = np.zeros((n, hc, rowt))
    f = np.arange(rowt)
    for nn in range(n):
        for i in range(hc):
            idx = (nn * hi + ys[i]) * rowf + xlo * c + f
            assert idx.min() >= 0 and idx.max() + (py - 1) * rowf < flat.size
            tmp[nn, i] = sum(np.float64(yt[i, p]) * flat[idx + p * rowf]
                             for p in range(py))
    f = np.arange(wc * c)
    j, cc = f // c, f % c
    t = (xs[j] - xlo) * c + cc
    assert t.min() >= 0 and (t + (px - 1) * c).max() < rowt
    acc = sum(xt[j, p].astype(np.float64) * tmp[:, :, t + p * c]
              for p in range(px))
    out = (acc - np.float32(mean)) / np.float32(std)
    return out.reshape(n, hc, wc, c)


def _k2_direct_mirror(img, tables, plan, mean, std):
    (ys, yt), (xs, xt) = tables
    n, hi, wi, c = img.shape
    hc, wc = yt.shape[0], xt.shape[0]
    assert yt.shape[1] == xt.shape[1] == 2
    rows, rowc, rowf = tpp.DIRECT_ROWS, wc * c, wi * c
    assert plan["grid"] == (-(-rowc // tpp.THREADS), -(-hc // rows), n)
    flat = img.astype(np.float64).reshape(-1)
    out = np.zeros(n * hc * rowc)
    written = np.zeros(out.size, np.int64)
    f = np.arange(plan["grid"][0] * tpp.THREADS)
    f = f[f < rowc]
    j, cc = f // c, f % c
    for nn in range(n):
        for by in range(plan["grid"][1]):
            i0 = by * rows
            base = nn * hi * rowf + xs[j] * c + cc
            for r in range(rows):
                i = min(i0 + r, hc - 1)
                s0 = base + ys[i] * rowf
                assert s0.min() >= 0 and (s0 + rowf + c).max() < flat.size
                t0 = yt[i, 0] * flat[s0] + yt[i, 1] * flat[s0 + rowf]
                t1 = yt[i, 0] * flat[s0 + c] + yt[i, 1] * flat[s0 + rowf + c]
                v = xt[j, 0] * t0 + xt[j, 1] * t1
                if i0 + r < hc:
                    o = (nn * hc + i0 + r) * rowc + f
                    out[o] = (v - np.float32(mean)) / np.float32(std)
                    written[o] += 1
    assert np.all(written == 1)
    return out.reshape(n, hc, wc, c)


TAP_GEOMETRIES = [
    # (H, W), resize (h, w), crop (x, y, w, h)
    ((250, 250), (256, 256), (16, 16, 224, 224)),    # the device backend's
    ((64, 50), (16, 12), (0, 0, 16, 12)),            # antialiased downsample
    ((40, 48), (24, 20), (10, 12, 30, 30)),          # clamped crop
    ((20, 20), (33, 27), (-4, 50, 8, 9)),            # start clamps
    ((31, 29), (40, 36), (3, 5, 20, 24)),            # odd sizes
    ((9, 9), (9, 5), (0, 0, 9, 5)),                  # one axis unchanged
]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("geometry", TAP_GEOMETRIES)
def test_tap_tables_rebuild_the_cropped_matrices(method, geometry):
    """K2's tap tables stand for exactly the cropped interpolation
    matrices: rebuilt dense, they equal them bit for bit; the windows are
    monotone and lie inside the image."""
    (h, w), (rh, rw), (cx, cy, cw, ch) = geometry
    m = tpp._canonical_method(method)
    dense = tpp._cropped_matrices(h, w, rh, rw, m, cx, cy, cw, ch)
    for mat, (start, taps), n_in in zip(
            dense, tpp._tables(h, w, rh, rw, m, cx, cy, cw, ch), (h, w)):
        np.testing.assert_array_equal(
            tpp.dense_from_taps(start, taps, n_in), mat)
        assert taps.dtype == np.float32 and start.dtype == np.int32
        assert np.all(np.diff(start) >= 0)
        assert start.min() >= 0 and start.max() + taps.shape[1] <= n_in
        lo, hi = tpp.band_limits(mat)
        assert taps.shape[1] == max(1, int((hi - lo + 1).max()))


K2_MIRROR_CASES = [(shape + (3,), res, crop, method, None)
                   for shape, res, crop, method in PREPROCESS_CASES] + [
    # any channel count
    ((2, 31, 29, 1), (40, 36), (3, 5, 20, 24), "bilinear", None),
    ((1, 40, 48, 5), (24, 20), (10, 12, 30, 30), "lanczos3", None),
    ((2, 64, 50, 8), (16, 12), (0, 0, 16, 12), "linear", None),
    # tiles the kernel takes elsewhere: strips, segments, channel groups
    ((2, 31, 29, 5), (40, 36), (3, 5, 20, 24), "bilinear",
     dict(rows=3, cols=7, cb=2)),
    ((1, 40, 48, 8), (24, 20), (10, 12, 30, 30), "cubic",
     dict(rows=1, cols=1, cb=3)),
    # the wide route: a window over 1,024 columns, one over 1,024 rows,
    # and a small geometry sent through it
    ((1, 8, 2100, 1), (4, 2), (0, 0, 2, 4), "lanczos3", None),
    ((1, 2200, 6, 2), (2, 6), (0, 0, 6, 2), "linear", None),
    ((1, 40, 48, 5), (24, 20), (10, 12, 30, 30), "lanczos3",
     dict(route="wide")),
]


@pytest.mark.parametrize("shape,res,crop,method,tiles", K2_MIRROR_CASES)
def test_k2_tiled_order_matches_pallas(shape, res, crop, method, tiles):
    """The fused kernel's order and tiling, mirrored in float64 on the
    host, against the Pallas kernel in interpret mode, at any channel
    count and under the kernel's launch plan (or the tiles given, on the
    tiled route)."""
    img = _uniform(sum(shape), shape)
    kw = dict(resize_h=res[0], resize_w=res[1], method=method,
              crop_x=crop[0], crop_y=crop[1], crop_w=crop[2],
              crop_h=crop[3], mean=0.45, std=0.22)
    want = np.asarray(jpp.fused_resize_crop_normalize_pallas(
        jnp.asarray(img), interpret=True, **kw))
    tables = tpp._tables(shape[1], shape[2], res[0], res[1],
                         tpp._canonical_method(method), *crop)
    (_, yt), (xs, xt) = tables
    n, c = shape[0], shape[3]
    plan = tpp.launch_plan(n, yt.shape[0], xt.shape[0], c, xs, yt.shape[1],
                           xt.shape[1])
    if tiles and tiles.get("route") == "wide":
        plan = {"route": "wide", "xlo": int(xs[0]),
                "x1": int(xs[-1]) + xt.shape[1]}
    elif tiles:
        rows, cols, cb = tiles["rows"], tiles["cols"], tiles["cb"]
        span = max(xs[min(j + cols, xt.shape[0]) - 1] + xt.shape[1] - xs[j]
                   for j in range(0, xt.shape[0], cols))
        plan = {**tiles, "route": "tiled", "ld": int(span) * cb,
                "grid": (-(-xt.shape[0] // cols), -(-yt.shape[0] // rows),
                         n * -(-c // cb))}
    got = _k2_mirror(img, tables, plan, 0.45, 0.22)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=PREPROCESS_TOL, rtol=0)
    # the plain version, at the same channel count
    plain = tops.fused_preprocess(torch.from_numpy(img), **kw).numpy()
    np.testing.assert_allclose(plain, want, atol=PREPROCESS_TOL, rtol=0)


@pytest.mark.parametrize("n,size,res,crop,method,c", [
    (32, (250, 250), (256, 256), (16, 16, 224, 224), "bilinear", 3),
    (1, (250, 250), (256, 256), (16, 16, 224, 224), "bilinear", 3),
    (1, (1080, 1920), (224, 224), (0, 0, 224, 224), "lanczos3", 3),
    (4, (250, 250), (256, 256), (16, 16, 224, 224), "bilinear", 8),
    (2, (1080, 1920), (224, 224), (0, 0, 224, 224), "lanczos3", 64),
    (1, (250, 250), (224, 224), (0, 0, 224, 224), "linear", 3),
    (32, (250, 250), (256, 256), (16, 16, 224, 224), "cubic", 3),
    (1, (1080, 1920), (8, 8), (0, 0, 8, 8), "lanczos3", 3),
    (2, (2200, 6), (2, 6), (0, 0, 6, 2), "linear", 300),
])
def test_k2_launch_plan_picks_the_route_and_fits_its_tile(n, size, res,
                                                          crop, method, c):
    """A bilinear upsample (two taps a window) takes the direct route, a
    thread per output float of 4 rows; a window over 1,024 taps on either
    axis the wide route, two passes through a scratch image of the input
    columns the windows cover; other windows the tiled route, whose
    launch fills two CTAs an SM even for one image and whose tile rows
    fit the kernel's 4 floats a thread."""
    (_, yt), (xs, xt) = tpp._tables(*size, *res, method, *crop)
    plan = tpp.launch_plan(n, yt.shape[0], xt.shape[0], c, xs, yt.shape[1],
                           xt.shape[1])
    if method == "bilinear":
        assert plan["route"] == "direct"
        assert plan["grid"] == (-(-224 * c // 256), 56, n)
    elif max(yt.shape[1], xt.shape[1]) > tpp.TILE_FLOATS:
        assert plan == {"route": "wide", "xlo": int(xs.min()),
                        "x1": int((xs + xt.shape[1]).max())}
        assert 0 <= plan["xlo"] and plan["x1"] <= size[1]
    else:
        assert plan["route"] == "tiled"
        gx, gy, gz = plan["grid"]
        assert gx * gy * gz >= tpp.TARGET_CTAS
        assert plan["rows"] <= tpp.MAX_ROWS
        assert plan["ld"] <= tpp.TILE_FLOATS


# ---------------------------------------------------------- mamba2 SSD
def _ssd_inputs(seed, B, T, H, P, G, N, *, state=True, skip=True):
    """The JAX package's test inputs (``tests/test_kernels.py``), drawn
    with numpy: x ~ N(0,1), dt = softplus(N(0,1)) / 2, A = -exp(0.3 N),
    B, C ~ 0.5 N, D = |0.1 N|, h0 ~ 0.1 N."""
    rng = np.random.default_rng(seed)

    def n(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = n((B, T, H, P))
    dt = (np.log1p(np.exp(n((B, T, H)))) * 0.5).astype(np.float32)
    A = (-np.exp(n((H,), 0.3))).astype(np.float32)
    Bm, Cm = n((B, T, G, N), 0.5), n((B, T, G, N), 0.5)
    D = np.abs(n((H,), 0.1)) if skip else None
    h0 = n((B, H, P, N), 0.1) if state else None
    return x, dt, A, Bm, Cm, D, h0


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


@pytest.mark.parametrize("B,T,H,P,G,N,chunk", [(2, 100, 4, 16, 2, 8, 32),
                                               (1, 64, 2, 8, 1, 16, 16)])
def test_mamba2_plain_matches_pallas_and_ref(B, T, H, P, G, N, chunk):
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(T + N, B, T, H, P, G, N)
    jargs = [_j(a) for a in (x, dt, A, Bm, Cm, D, h0)]
    y_ref, h_ref = jref.mamba2_ssd_ref(*jargs)
    y_pl, h_pl = mamba2_ssd_pallas(*jargs, chunk=chunk, interpret=True)
    targs = [_t(a) for a in (x, dt, A, Bm, Cm, D, h0)]
    y, h = tops.mamba2_ssd(*targs, chunk=chunk)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    for got, want in ((y, y_ref), (y, y_pl), (h, h_ref), (h, h_pl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=SSD_TOL, rtol=0)
    # the port's sequential oracle is the JAX package's
    y_sq, h_sq = tref.mamba2_ssd_ref(*targs)
    np.testing.assert_allclose(y_sq.numpy(), np.asarray(y_ref), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(h_sq.numpy(), np.asarray(h_ref), atol=1e-5,
                               rtol=0)


def test_mamba2_plain_matches_pallas_bf16():
    B, T, H, P, G, N = 1, 64, 2, 16, 1, 8
    x, dt, A, Bm, Cm, _, _ = _ssd_inputs(321, B, T, H, P, G, N,
                                         state=False, skip=False)
    bf = jnp.bfloat16
    y_ref, h_ref = jref.mamba2_ssd_ref(_j(x, bf), _j(dt), _j(A), _j(Bm, bf),
                                       _j(Cm, bf))
    y_pl, h_pl = mamba2_ssd_pallas(_j(x, bf), _j(dt), _j(A), _j(Bm, bf),
                                   _j(Cm, bf), chunk=32, interpret=True)
    tb = torch.bfloat16
    y, h = tops.mamba2_ssd(_t(x, tb), _t(dt), _t(A), _t(Bm, tb), _t(Cm, tb),
                           chunk=32)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    for want in (y_ref, y_pl):
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=SSD_BF16_TOL, rtol=0)
    for want in (h_ref, h_pl):
        np.testing.assert_allclose(h.numpy(), np.asarray(want),
                                   atol=SSD_BF16_TOL, rtol=0)


@pytest.mark.parametrize("T", [1, 3, 9, 130])
def test_mamba2_chunk_rule_and_ragged_tails(T):
    """``min(chunk, max(T, 8))``: a 3-token prompt runs as one 8-step
    chunk; every tail length gives the sequential result."""
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(T, 2, T, 4, 8, 2, 8)
    targs = [_t(a) for a in (x, dt, A, Bm, Cm, D, h0)]
    y, h = tops.mamba2_ssd(*targs)
    y_sq, h_sq = tref.mamba2_ssd_ref(*targs)
    np.testing.assert_allclose(y.numpy(), y_sq.numpy(), atol=SSD_TOL, rtol=0)
    np.testing.assert_allclose(h.numpy(), h_sq.numpy(), atol=SSD_TOL, rtol=0)
    y_j, h_j = jref.mamba2_ssd_chunked_jnp(*[_j(a) for a in
                                             (x, dt, A, Bm, Cm, D, h0)])
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=SSD_TOL,
                               rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), atol=SSD_TOL,
                               rtol=0)


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("H,Hkv", [(8, 2), (4, 4)])
def test_decode_attention_matches_jax(H, Hkv):
    B, S, D = 2, 96, 16
    rng = np.random.default_rng(H * 10 + Hkv)
    q, kc, vc = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, 1, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    lens = np.array([40, 96], np.int32)
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens)))
    got = tops.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL, rtol=0)
    # an int length as the model passes it, and the naive route
    got = tops.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc), 40)
    naive = tref.naive_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), causal=False,
                                 kv_len=40)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=ATTN_TOL,
                               rtol=0)


@pytest.mark.parametrize("causal,q_offset,kv_len", [(True, 0, None),
                                                    (False, 0, None),
                                                    (True, 5, 29)])
def test_naive_attention_matches_jax(causal, q_offset, kv_len):
    B, Sq, Sk, H, Hkv, D = 2, 24, 40, 4, 2, 16
    rng = np.random.default_rng(Sq + q_offset)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    jl = None if kv_len is None else jnp.full((B,), kv_len)
    want = np.asarray(jref.naive_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_len=jl, q_offset=q_offset))
    got = tref.naive_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               kv_len=kv_len, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL, rtol=0)
    # the explicit chunked route gives the JAX package's chunked result
    want = np.asarray(jref.flash_attention_jnp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_block=16, kv_block=16, kv_len=jl, q_offset=q_offset))
    # (the port's chunked route takes no kv_len: the cache tail past the
    # causal edge, kv_len 29 here, is masked by causality alone)
    got, _ = tref.flash_attention_chunked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_block=16, kv_block=16, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL, rtol=0)
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               impl="chunked", q_offset=q_offset)
    want = tref.naive_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATTN_TOL,
                               rtol=0)


ATTN_CASES = [  # tests/test_kernels.py: B, Sq, Sk, H, Hkv, D, causal
    (2, 128, 128, 4, 2, 32, True),
    (1, 96, 96, 4, 4, 16, True),
    (2, 64, 192, 6, 2, 32, False),
    (1, 100, 100, 2, 1, 64, True),   # non-multiple of block
]


def _attn_inputs(seed, B, Sq, Sk, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_routes_match_pallas(case, dtype):
    """The port's plain flash routes — ``ops.flash_attention`` on the CPU
    (the chunked route) and the ``flash_vjp`` forward — against the
    Pallas kernel in interpret mode."""
    B, Sq, Sk, H, Hkv, D, causal = case
    q, k, v = _attn_inputs(sum(case[:6]), B, Sq, Sk, H, Hkv, D)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(flash_attention_pallas(
        *(jnp.asarray(a, jd) for a in (q, k, v)), causal=causal,
        block_q=32, block_k=64, interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    tol = FLASH_BF16_TOL if dtype == "bfloat16" else FLASH_TOL
    for got in (tops.flash_attention(tq, tk, tv, causal=causal,
                                     q_block=32, kv_block=64),
                tflash.flash_attention(tq, tk, tv, 0, causal, None, 32, 64)):
        assert got.dtype == td and tuple(got.shape) == (B, Sq, H, D)
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("Sq,Sk,q_offset", [(40, 130, 17), (9, 64, 55),
                                            (64, 64, 0)])
def test_flash_vjp_forward_with_offset_matches_jax(Sq, Sk, q_offset):
    """Prefill into a longer cache (``q_offset > 0``, which the Pallas
    kernel cannot take): the port's ``flash_vjp`` forward and its
    log-sum-exp against the JAX package's ``flash_vjp``."""
    from repro.kernels.flash_vjp import _fwd_impl as jax_fwd_impl
    q, k, v = _attn_inputs(Sq + q_offset, 2, Sq, Sk, 4, 2, 16)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jax_flash_vjp(jq, jk, jv, q_offset, True, None, 16, 32))
    _, want_lse = jax_fwd_impl(jq, jk, jv, True, None, 16, 32, q_offset)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tflash.flash_attention(tq, tk, tv, q_offset, True, None, 16, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=FLASH_TOL, rtol=0)
    out, lse = tref.flash_attention_chunked(tq, tk, tv, q_block=16,
                                            kv_block=32, q_offset=q_offset)
    np.testing.assert_array_equal(out.numpy(), got.numpy())
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=FLASH_TOL, rtol=0)
    # the same function as the naive route with the offset
    naive = tref.naive_attention(tq, tk, tv, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=FLASH_TOL,
                               rtol=0)


@pytest.mark.parametrize("Sq,Sk,q_offset", [(1100, 1100, 0), (40, 1105, 1065),
                                            (130, 1040, 0)])
def test_flash_vjp_forward_at_head_dim_80_matches_jax(Sq, Sk, q_offset):
    """zamba2's head dim 80 on the route beyond 1024 positions: the
    port's ``flash_vjp`` forward (GQA, with and without an offset into a
    longer cache) against the JAX package's."""
    q, k, v = _attn_inputs(Sq + Sk, 1, Sq, Sk, 4, 2, 80)
    want = np.asarray(jax_flash_vjp(*(jnp.asarray(a) for a in (q, k, v)),
                                    q_offset, True, None, 512, 1024))
    got = tflash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 q_offset, True, None, 512, 1024)
    np.testing.assert_allclose(got.numpy(), want, atol=FLASH_TOL, rtol=0)


# ------------------------------------------------------------- RWKV6 WKV
def _wkv_inputs(seed, B, T, H, K, *, state=True):
    """The JAX package's test inputs, drawn with numpy: r, k ~ 0.5 N,
    v ~ N, w = sigmoid(N) / 2 + 0.45, u ~ 0.1 N, s0 ~ 0.1 N."""
    rng = np.random.default_rng(seed)

    def n(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    r, k, v = n((B, T, H, K), 0.5), n((B, T, H, K), 0.5), n((B, T, H, K))
    w = (0.5 / (1 + np.exp(-n((B, T, H, K)))) + 0.45).astype(np.float32)
    return r, k, v, w, n((H, K), 0.1), n((B, H, K, K), 0.1) if state else None


@pytest.mark.parametrize("B,T,H,K,chunk", [(2, 96, 3, 16, 32),
                                           (1, 50, 2, 8, 16)])
def test_rwkv6_plain_matches_pallas_and_ref(B, T, H, K, chunk):
    args = _wkv_inputs(T, B, T, H, K)
    jargs = [_j(a) for a in args]
    o_ref, s_ref = jref.rwkv6_scan_ref(*jargs)
    o_ch, s_ch = jref.rwkv6_chunked_jnp(*jargs, chunk=chunk)
    o_pl, s_pl = rwkv6_scan_pallas(*jargs, chunk=chunk, interpret=True)
    targs = [_t(a) for a in args]
    y, s = tops.rwkv6_scan(*targs, chunk=chunk)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    for got, want in ((y, o_ref), (y, o_ch), (y, o_pl), (s, s_ref),
                      (s, s_ch), (s, s_pl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=WKV_TOL, rtol=0)
    # the port's sequential oracle is the JAX package's
    o_sq, s_sq = tref.rwkv6_scan_ref(*targs)
    np.testing.assert_allclose(o_sq.numpy(), np.asarray(o_ref), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(s_sq.numpy(), np.asarray(s_ref), atol=1e-5,
                               rtol=0)


def test_rwkv6_plain_matches_pallas_bf16():
    B, T, H, K = 1, 64, 2, 16
    r, k, v, w, u, _ = _wkv_inputs(11, B, T, H, K, state=False)
    bf = jnp.bfloat16
    jargs = [_j(a, bf) for a in (r, k, v, w)] + [_j(u)]
    o_ref, s_ref = jref.rwkv6_scan_ref(*jargs)
    o_pl, s_pl = rwkv6_scan_pallas(*jargs, chunk=32, interpret=True)
    tb = torch.bfloat16
    y, s = tops.rwkv6_scan(*[_t(a, tb) for a in (r, k, v, w)], _t(u),
                           chunk=32)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    for want in (o_ref, o_pl):
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=WKV_BF16_TOL, rtol=0)
    for want in (s_ref, s_pl):
        np.testing.assert_allclose(s.numpy(), np.asarray(want),
                                   atol=WKV_BF16_TOL, rtol=0)


@pytest.mark.parametrize("split", [32, 21])
def test_rwkv6_state_continuity(split):
    """Scanning [a;b] equals scanning a then b from a's final state, on
    the chunked route (a split inside a chunk too), as the sequential
    scan does in the JAX package."""
    B, T, H, K = 1, 64, 2, 8
    r, k, v, w, u, _ = (_t(a) for a in _wkv_inputs(5, B, T, H, K,
                                                    state=False))
    o_full, s_full = tops.rwkv6_scan(r, k, v, w, u, chunk=16)
    o1, s1 = tops.rwkv6_scan(r[:, :split], k[:, :split], v[:, :split],
                             w[:, :split], u, chunk=16)
    o2, s2 = tops.rwkv6_scan(r[:, split:], k[:, split:], v[:, split:],
                             w[:, split:], u, s1, chunk=16)
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(),
                               o_full.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), atol=1e-4, rtol=0)
    o_j, s_j = jref.rwkv6_scan_ref(*(_j(a.numpy()) for a in (r, k, v, w, u)))
    np.testing.assert_allclose(o_full.numpy(), np.asarray(o_j), atol=WKV_TOL,
                               rtol=0)
    np.testing.assert_allclose(s_full.numpy(), np.asarray(s_j), atol=WKV_TOL,
                               rtol=0)


def _wkv_sub_chunks(r, k, v, w, u, s0, tile=16, sub=16):
    """The WKV6 kernel's arithmetic in float64 torch: tiles of ``tile``
    steps carry the state; inside a tile, sub-chunks of ``sub`` steps.
    A diagonal sub x sub block takes the exact cube, exp(lwp_t - lw_s) for
    s < t; an off-diagonal block (sub-chunk i after j) the product
    (r_i o exp(lwp_i - lw_b)) (k_j o exp(lw_b - lw_j))^T with b the last
    step of j, both exponents <= 0.  Across tiles the readout takes the
    tile's start and the update its end as reference points.  At
    ``tile == sub`` every off-diagonal block goes through the state, as
    the CUDA kernel computes it."""
    B, T, H, K = r.shape
    f = torch.float64
    rf, kf, vf = (a.to(f) for a in (r, k, v))
    logw = torch.log(torch.clamp(w.to(f), min=1e-30))
    S = s0.to(f).clone()
    uf = u.to(f)
    ys = []
    for t0 in range(0, T, tile):
        sl = slice(t0, min(T, t0 + tile))
        rc, kc, vc, lc = (a[:, sl].transpose(1, 2) for a in (rf, kf, vf, logw))
        n = rc.shape[2]
        lw = torch.cumsum(lc, dim=2)
        lwp = torch.nn.functional.pad(lw, (0, 0, 1, 0))[:, :, :-1]  # lw_{t-1}
        y = torch.einsum("bhtk,bhkv->bhtv", rc * torch.exp(lwp), S)
        att = torch.zeros(B, H, n, n, dtype=f)
        for i0 in range(0, n, sub):
            ti = slice(i0, min(n, i0 + sub))
            for j0 in range(0, i0 + 1, sub):
                sj = slice(j0, min(n, j0 + sub))
                if j0 == i0:
                    d = lwp[:, :, ti, None, :] - lw[:, :, None, sj, :]
                    m = ti.stop - ti.start
                    tri = torch.tril(torch.ones(m, m, dtype=torch.bool), -1)
                    assert bool((d[..., tri, :] <= 0).all())
                    cube = torch.where(tri[..., None], torch.exp(d), 0.0)
                    blk = torch.einsum("bhtk,bhtsk,bhsk->bhts", rc[:, :, ti],
                                       cube, kc[:, :, sj])
                    blk = blk + torch.diag_embed(torch.einsum(
                        "bhtk,bhtk->bht", rc[:, :, ti] * uf[None, :, None],
                        kc[:, :, ti]))
                else:
                    lb = lw[:, :, sj.stop - 1:sj.stop]
                    ea, eb = lwp[:, :, ti] - lb, lb - lw[:, :, sj]
                    assert bool((ea <= 0).all() and (eb <= 0).all())
                    blk = torch.einsum("bhtk,bhsk->bhts",
                                       rc[:, :, ti] * torch.exp(ea),
                                       kc[:, :, sj] * torch.exp(eb))
                att[:, :, ti, sj] = blk
        y = y + att @ vc
        lb = lw[:, :, -1:]
        S = torch.exp(lb[:, :, 0, :, None]) * S + torch.einsum(
            "bhsk,bhsv->bhkv", kc * torch.exp(lb - lw), vc)
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, 1).float(), S.float()


@pytest.mark.parametrize("T,shift", [(37, 0.0), (50, 0.0),
                                     (37, np.log(8.0) + 4.0),
                                     (64, np.log(8.0) + 4.0)])
@pytest.mark.parametrize("tile", [16, 64])
def test_rwkv6_sub_chunk_factorisation_matches_ref_and_pallas(T, shift, tile):
    """The kernel's design on the host: 16-step sub-chunks with reference
    points at their ends, held against the sequential scan of both
    packages and the Pallas kernel in interpret mode, at the model's
    decays (w = exp(-exp(-4 + N))) and at log w about -8 a step, with T no
    multiple of 16."""
    B, H, K = 2, 3, 16
    rng = np.random.default_rng(T)

    def n(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    r, k, v = n((B, T, H, K), 0.5), n((B, T, H, K), 0.5), n((B, T, H, K))
    w = np.exp(-np.exp(-4.0 + shift + n((B, T, H, K)))).astype(np.float32)
    u, s0 = n((H, K), 0.1), n((B, H, K, K), 0.1)
    args = (r, k, v, w, u, s0)
    y, s = _wkv_sub_chunks(*(_t(a) for a in args), tile=tile)
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    y_t, s_t = tref.rwkv6_scan_ref(*(_t(a) for a in args))
    o_ref, s_ref = jref.rwkv6_scan_ref(*(_j(a) for a in args))
    o_pl, s_pl = rwkv6_scan_pallas(*(_j(a) for a in args), chunk=16,
                                   interpret=True)
    for got, want in ((y, y_t), (y, o_ref), (y, o_pl), (s, s_t), (s, s_ref),
                      (s, s_pl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=WKV_TOL, rtol=0)


def test_wrappers_refuse_devices_without_a_path():
    with pytest.raises(ValueError, match="CUDA tensor"):
        from repro_torch.kernels.gaussian_blur import gaussian_blur_cuda
        gaussian_blur_cuda(torch.zeros(1, 4, 4, 3), 3, 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpp.fused_resize_crop_normalize_cuda(
            torch.zeros(1, 4, 4, 3), resize_h=4, resize_w=4, crop_x=0,
            crop_y=0, crop_w=4, crop_h=4)
    with pytest.raises(ValueError, match="meta"):
        tops.gaussian_blur(torch.zeros(1, 4, 4, 3, device="meta"), 3, 1.0)
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_cuda
    x, dt, A, Bm, Cm, D, h0 = (_t(a) for a in _ssd_inputs(0, 1, 8, 2, 4, 1,
                                                           4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        mamba2_ssd_cuda(x, dt, A, Bm, Cm, D, h0)
    with pytest.raises(ValueError, match="meta"):
        tops.mamba2_ssd(x.to("meta"), dt, A, Bm, Cm)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda
    r, k, v, w, u, s0 = (_t(a) for a in _wkv_inputs(0, 1, 8, 2, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        rwkv6_scan_cuda(r, k, v, w, u, s0)
    with pytest.raises(ValueError, match="meta"):
        tops.rwkv6_scan(r.to("meta"), k, v, w, u)
    q, kk, vv = (torch.from_numpy(a) for a in _attn_inputs(0, 1, 8, 8, 2, 1,
                                                          16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, kk, vv)
    with pytest.raises(ValueError, match="meta"):
        tops.flash_attention(q.to("meta"), kk, vv)
    with pytest.raises(ValueError, match="meta"):
        tflash.flash_attention(q.to("meta"), kk, vv)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tops.flash_attention(q, kk, vv, impl="no-such-route")


def _packed(width, dtype=torch.float32, B=2, T=9, offset=0):
    """A packed projection (B, T, width) as the models hand slices of it
    over, optionally starting ``offset`` values into its storage."""
    flat = torch.zeros(B * T * width + offset, dtype=dtype)
    return flat[offset:].view(B, T, width)


@pytest.mark.parametrize("case,passes", [
    # the model's in-projection: x (8 heads of 64) then B and C (64 each),
    # float32 rows of 2,560 bytes: every slice starts and steps on 16 bytes
    ("x slice", True), ("B slice", True), ("C slice", True),
    # a bf16 packing whose rows are 1,288 bytes: steps off 16 bytes
    ("bf16 rows of 1288 bytes", False),
    # a slice that starts one float past a 16-byte boundary
    ("slice at an odd float", False),
    # a contiguous tensor whose storage starts off 16 bytes: a fresh copy
    ("contiguous, base off 16 bytes", False),
    # heads out of order: not the kernels' layout
    ("heads transposed", False),
    # size-1 batch and sequence: their strides are never stepped
    ("one token of one sequence", True),
])
def test_strided_passes_aligned_slices_and_copies_the_rest(case, passes):
    """``_build.strided`` hands a tensor to the K3/K4 kernels uncopied only
    when their 16-byte ``cp.async`` staging can read it in place: unit
    feature stride, head stride ``inner``, and a base pointer and batch
    and sequence strides on 16 bytes (a size-1 dimension's stride is
    never stepped and passed as 0)."""
    from repro_torch.kernels import _build
    H, P, N = 8, 64, 64
    if case in ("x slice", "B slice", "C slice"):
        p = _packed(H * P + 2 * N)
        xv, bv, cv = torch.split(p, [H * P, N, N], dim=-1)
        t, inner = {"x slice": (xv.reshape(2, 9, H, P), P),
                    "B slice": (bv.reshape(2, 9, 1, N), N),
                    "C slice": (cv.reshape(2, 9, 1, N), N)}[case]
    elif case == "bf16 rows of 1288 bytes":
        p = _packed(H * P + 2 * N + 4, torch.bfloat16)
        t, inner = p[..., :H * P].reshape(2, 9, H, P), P
    elif case == "slice at an odd float":
        p = _packed(H * P + 2 * N + 4)
        t, inner = p[..., 1:1 + N].reshape(2, 9, 1, N), N
    elif case == "contiguous, base off 16 bytes":
        t, inner = _packed(H * P, offset=1).view(2, 9, H, P), P
        assert t.is_contiguous()
    elif case == "heads transposed":
        t, inner = torch.zeros(2, 9, P, H).transpose(2, 3), P
    else:
        t, inner = torch.zeros(1, 1, 4 * P + 1)[..., :H * P // 2].reshape(
            1, 1, H // 2, P), P
        t = t.as_strided(t.shape, (7, 3, P, 1))
    assert t.data_ptr() % 16 == 0 or not passes
    got = _build.strided(t, inner)
    assert (got.data_ptr() == t.data_ptr()) == passes
    assert torch.equal(got, t)
    assert got.stride(3) == 1 and (got.shape[2] == 1
                                   or got.stride(2) == inner)
    assert got.data_ptr() % 16 == 0
    item = got.element_size()
    assert all(s * item % 16 == 0 for s in _build.outer(got))
