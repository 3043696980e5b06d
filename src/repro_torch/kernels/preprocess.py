"""Fused resize→crop→normalize preprocessing kernel (CUDA) and the host
helpers it shares with the resize op.

Every resize method of the query engine is a *linear* map per axis:
``resize(img) = Ry @ img @ Rx^T`` for interpolation matrices
``Ry (H_out, H_in)`` / ``Rx (W_out, W_in)``.  :func:`resize_matrix`
builds those matrices in numpy, antialiasing taps included, with the
arithmetic of ``jax.image.resize`` (``compute_weight_mat`` of
``jax/_src/image/scale.py``) so the port resizes exactly as the JAX
package does.  Crop then *slices rows out of the matrices* instead of
the image, and normalize folds into a trailing affine:

    out = (Ry[cy:cy+ch] @ img @ Rx[cx:cx+cw]^T - mean) / std

The CUDA kernel (``csrc/preprocess.cu``) computes that per image and
channel in one launch; the cropped rows of the resize are never
computed and no intermediate image reaches device memory.  Both
matrices are banded (a few taps per output pixel), so the wrapper hands
the kernel each one as a tap table (:func:`tap_table`): per output row
(or column) the first input index and ``P`` weights, ``P`` the widest
band, padded with exact zeros — the same sums as the dense products,
minus the exact zeros.  :func:`launch_plan` sizes the kernel's tiles
from the tables and the batch.

:func:`fused_resize_crop_normalize_ref` is the plain version: the three
native-table ops composed, as in the JAX package.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build

_METHODS = {"nearest": "nearest",
            "linear": "linear", "bilinear": "linear",
            "trilinear": "linear", "triangle": "linear",
            "cubic": "cubic", "bicubic": "cubic", "tricubic": "cubic",
            "lanczos3": "lanczos3", "lanczos5": "lanczos5"}

_EPS32 = float(np.finfo(np.float32).eps)


def _canonical_method(method: str) -> str:
    try:
        return _METHODS[method]
    except KeyError:
        raise ValueError(f'Unknown resize method "{method}"') from None


def _triangle(x):
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x):
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1)
    out = np.where(x >= 1,
                   ((np.float32(-0.5) * x + np.float32(2.5)) * x
                    - np.float32(4)) * x + np.float32(2), out)
    return np.where(x >= 2, np.float32(0), out)


def _lanczos(radius: float):
    def fill(x):
        r = np.float32(radius)
        pi = np.float32(np.pi)
        y = r * np.sin(pi * x) * np.sin(pi * x / r)
        den = np.where(x != 0, np.float32(np.pi ** 2) * (x * x),
                       np.float32(1))
        out = np.where(x > np.float32(1e-3), y / den, np.float32(1))
        return np.where(x > r, np.float32(0), out)
    return fill


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic,
            "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}


@functools.lru_cache(maxsize=256)
def _resize_matrix_cached(n_in: int, n_out: int, method: str) -> np.ndarray:
    if n_in == n_out:
        # jax.image.resize skips an axis whose size does not change
        out = np.eye(n_in, dtype=np.float32)
    elif method == "nearest":
        # the index gather of jax's nearest resize, computed in float32
        # as jax computes it (float64 picks other indices)
        pos = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
               * np.float32(n_in) / np.float32(n_out))
        out = np.zeros((n_out, n_in), np.float32)
        out[np.arange(n_out), np.floor(pos).astype(np.int32)] = 1.0
    else:
        out = _weight_matrix(n_in, n_out, method)
    out.setflags(write=False)
    return out


def _weight_matrix(n_in: int, n_out: int, method: str) -> np.ndarray:
    """``compute_weight_mat`` of jax's resize, transposed to (out, in)."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        # jax takes 1/scale in double precision, then rounds it once
        inv_scale = np.float32(1.0 / (n_out / n_in))
        # antialias: the kernel widens when downsampling
        kernel_scale = np.maximum(inv_scale, np.float32(1.0))
        sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                    * inv_scale - np.float32(0.0) * inv_scale
                    - np.float32(0.5))
        x = (np.abs(sample_f[None, :]
                    - np.arange(n_in, dtype=np.float32)[:, None])
             / kernel_scale)
        weights = _KERNELS[method](x).astype(np.float32)
        total = np.sum(weights, axis=0, keepdims=True, dtype=np.float32)
        weights = np.where(
            np.abs(total) > np.float32(1000.0 * _EPS32),
            weights / np.where(total != 0, total, np.float32(1)),
            np.float32(0))
        inside = ((sample_f >= np.float32(-0.5))
                  & (sample_f <= np.float32(n_in - 0.5)))
        weights = np.where(inside[None, :], weights, np.float32(0))
    return np.ascontiguousarray(weights.T.astype(np.float32))


def resize_matrix(n_in: int, n_out: int, method: str = "bilinear"):
    """Exact (n_out, n_in) interpolation matrix of ``jax.image.resize``
    along one axis, antialiasing taps included (read-only, cached)."""
    return _resize_matrix_cached(int(n_in), int(n_out),
                                 _canonical_method(method))


@functools.lru_cache(maxsize=64)
def _cropped_matrices(h_in: int, w_in: int, h_res: int, w_res: int,
                      method: str, cx: int, cy: int, cw: int, ch: int):
    """Interpolation matrices with the crop window folded in (clamped
    exactly like ``visual.ops.crop``: the window is shrunk to the image
    and the start clamped inside it)."""
    ch = min(ch, h_res)
    cw = min(cw, w_res)
    cy = max(0, min(cy, h_res - ch))
    cx = max(0, min(cx, w_res - cw))
    ry = resize_matrix(h_in, h_res, method)[cy:cy + ch]
    rx = resize_matrix(w_in, w_res, method)[cx:cx + cw]
    return ry, rx


def band_limits(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """First and last nonzero column of every row of ``m`` (int32); an
    all-zero row gets ``(0, -1)``, an empty band."""
    nz = m != 0
    any_nz = nz.any(axis=1)
    lo = np.where(any_nz, nz.argmax(axis=1), 0)
    hi = np.where(any_nz, m.shape[1] - 1 - nz[:, ::-1].argmax(axis=1), -1)
    return lo.astype(np.int32), hi.astype(np.int32)


def tap_table(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``m`` (rows, n_in) as ``(start, taps)``: row i equals ``taps[i]``
    (float32, ``P`` wide, ``P`` the widest band of ``m``) at columns
    ``start[i] .. start[i] + P - 1`` and zero elsewhere.  Starts never
    decrease and every window lies inside ``[0, n_in)``, so a row whose
    band runs into the last column starts early, its taps shifted, and
    an all-zero row starts where the row before it did."""
    lo, hi = band_limits(m)
    rows, n_in = m.shape
    p = max(1, int((hi - lo + 1).max(initial=0)))
    start = np.maximum.accumulate(np.where(hi >= lo, lo, 0))
    start = np.minimum(start, n_in - p).astype(np.int32)
    taps = np.ascontiguousarray(
        m[np.arange(rows)[:, None], start[:, None] + np.arange(p)])
    # the windows must hold every nonzero (bands that step backwards
    # would break this; the kernel's shared tiles rely on it)
    if not np.array_equal(dense_from_taps(start, taps, n_in), m):
        raise ValueError("interpolation matrix bands are not monotone")
    return start, taps


def dense_from_taps(start: np.ndarray, taps: np.ndarray,
                    n_in: int) -> np.ndarray:
    """The (rows, n_in) matrix a tap table stands for."""
    out = np.zeros((taps.shape[0], n_in), np.float32)
    out[np.arange(taps.shape[0])[:, None],
        start[:, None] + np.arange(taps.shape[1])] = taps
    return out


# ------------------------------------------------------------ the kernel
launches = _build.LaunchCounter("fused_resize_crop_normalize")

THREADS = 256                 # a CTA of csrc/preprocess.cu
DIRECT_ROWS = 4               # output rows a thread of the direct route sums
MAX_ROWS = 8                  # output rows a strip holds at most
TILE_FLOATS = 4 * THREADS     # floats a tile row holds at most: 4 a thread
TARGET_CTAS = 2 * 132         # two CTAs an SM of an H100 (the kernel's
#                               occupancy), at the least


@functools.lru_cache(maxsize=64)
def _tables(h_in: int, w_in: int, h_res: int, w_res: int, method: str,
            cx: int, cy: int, cw: int, ch: int):
    """Both tap tables of a geometry: ``(y_start, y_taps), (x_start,
    x_taps)``."""
    ry, rx = _cropped_matrices(h_in, w_in, h_res, w_res, method,
                               cx, cy, cw, ch)
    return tap_table(ry), tap_table(rx)


@functools.lru_cache(maxsize=64)
def _device_operands(h_in: int, w_in: int, h_res: int, w_res: int,
                     method: str, cx: int, cy: int, cw: int, ch: int,
                     device: str):
    """Both tap tables on ``device`` (one host→device copy per distinct
    geometry): y starts, y taps, x starts, x taps."""
    (ys, yt), (xs, xt) = _tables(h_in, w_in, h_res, w_res, method,
                                 cx, cy, cw, ch)
    return tuple(torch.from_numpy(a).to(device) for a in (ys, yt, xs, xt))


def launch_plan(n: int, hc: int, wc: int, c: int, x_start: np.ndarray,
                py: int, px: int) -> dict:
    """How the kernel runs.  Two taps on both axes (every bilinear
    upsample) take the direct route: a thread per output float of a row,
    ``DIRECT_ROWS`` rows each.  A window over ``TILE_FLOATS`` taps on
    either axis takes the wide route (below).  Any other taps take the
    tiled route: a CTA owns ``rows`` output rows by ``cols`` output
    columns of ``cb`` channels of one image; a row of its tile holds
    ``ld`` floats (the widest ``span`` of input columns a segment reads,
    times ``cb``).  Strips start at 8 rows and segments at the whole
    width; a tile row over ``TILE_FLOATS`` narrows the segments, then the
    channel groups; a launch of fewer than ``TARGET_CTAS`` CTAs shortens
    strips to 4 rows, then narrows segments to about 64 floats, then
    shortens strips to 1 row.  The wide route runs two plain passes
    through a scratch image of the input columns ``xlo .. x1 - 1`` that
    the windows cover."""
    if py == 2 and px == 2:
        return {"route": "direct",
                "grid": (-(-wc * c // THREADS), -(-hc // DIRECT_ROWS), n)}

    def span(cols):   # widest run of input columns a segment reads
        j0 = np.arange(0, wc, cols)
        j1 = np.minimum(j0 + cols, wc) - 1
        return int((x_start[j1] + px - x_start[j0]).max())

    def ctas(rows, cols, cb):
        return n * -(-hc // rows) * -(-wc // cols) * -(-c // cb)

    if px > TILE_FLOATS or py > TILE_FLOATS:
        return {"route": "wide", "xlo": int(x_start[0]),
                "x1": int(x_start[-1]) + px}
    rows, cols, cb = min(MAX_ROWS, hc), wc, c
    while span(cols) * cb > TILE_FLOATS:
        if cols > 1:
            cols = -(-cols // 2)
        else:
            cb = -(-cb // 2)
    while ctas(rows, cols, cb) < TARGET_CTAS:
        if rows > 4:
            rows //= 2
        elif cols * cb > 64 and cols > 1:
            cols = -(-cols // 2)
        elif rows > 1:
            rows //= 2
        else:
            break
    return {"route": "tiled", "rows": rows, "cols": cols, "cb": cb,
            "ld": span(cols) * cb,
            "grid": (-(-wc // cols), -(-hc // rows), n * -(-c // cb))}


@functools.lru_cache(maxsize=256)
def _plan(geometry: tuple, n: int, c: int) -> dict:
    (_, yt), (xs, xt) = _tables(*geometry)
    return launch_plan(n, yt.shape[0], xt.shape[0], c, xs, yt.shape[1],
                       xt.shape[1])


def fused_resize_crop_normalize_cuda(
    img: torch.Tensor,   # (N, H, W, C) or (H, W, C), float32, on CUDA
    *,
    resize_h: int, resize_w: int, method: str = "bilinear",
    crop_x: int, crop_y: int, crop_w: int, crop_h: int,
    mean: float = 0.0, std: float = 1.0,
) -> torch.Tensor:
    """Launch the fused kernel on the current CUDA stream."""
    if not img.is_cuda:
        raise ValueError("fused_resize_crop_normalize_cuda takes a CUDA "
                         f"tensor, got one on {img.device}")
    _build.refuse_grad("fused_resize_crop_normalize", img)
    if img.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 images, got {img.dtype}")
    squeeze = img.ndim == 3
    if squeeze:
        img = img[None]
    if img.ndim != 4:
        raise ValueError(f"expected (N,H,W,C) or (H,W,C), got {tuple(img.shape)}")
    n, hi, wi, c = img.shape
    img = img.contiguous()
    geometry = (hi, wi, resize_h, resize_w, _canonical_method(method),
                crop_x, crop_y, crop_w, crop_h)
    (_, yt), (xs, xt) = _tables(*geometry)
    hc, wc = yt.shape[0], xt.shape[0]
    out = torch.empty((n, hc, wc, c), dtype=torch.float32, device=img.device)
    if not out.numel():
        return out[0] if squeeze else out
    plan = _plan(geometry, n, c)
    y_start, y_taps, x_start, x_taps = _device_operands(
        *geometry, str(img.device))
    lib = _build.load("preprocess")
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        if plan["route"] == "wide":
            tmp = torch.empty(n * hc * (plan["x1"] - plan["xlo"]) * c,
                              dtype=torch.float32, device=img.device)
            err = lib.repro_preprocess_wide_f32(
                img.data_ptr(), tmp.data_ptr(), out.data_ptr(),
                y_start.data_ptr(), y_taps.data_ptr(), x_start.data_ptr(),
                x_taps.data_ptr(), n, hi, wi, c, hc, wc, yt.shape[1],
                xt.shape[1], plan["xlo"], plan["x1"], float(mean),
                float(std), stream)
        else:
            err = lib.repro_preprocess_taps_f32(
                img.data_ptr(), out.data_ptr(), y_start.data_ptr(),
                y_taps.data_ptr(), x_start.data_ptr(), x_taps.data_ptr(),
                n, hi, wi, c, hc, wc, yt.shape[1], xt.shape[1],
                int(plan["route"] == "direct"),
                *(plan.get(k, 0) for k in ("rows", "cols", "cb", "ld")),
                float(mean), float(std), stream)
    _build.check(err, "fused_resize_crop_normalize")
    launches.add()
    return out[0] if squeeze else out


_build.declare("preprocess", "preprocess.cu", {
    "repro_preprocess_taps_f32": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
    "repro_preprocess_wide_f32": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]})


def fused_resize_crop_normalize_ref(
    img, *, resize_h: int, resize_w: int, method: str = "bilinear",
    crop_x: int, crop_y: int, crop_w: int, crop_h: int,
    mean: float = 0.0, std: float = 1.0,
):
    """Plain version: the three composed native-table ops, over
    ``(..., H, W, C)``."""
    from repro_torch.visual.ops import crop, normalize, resize
    img = resize(img, width=resize_w, height=resize_h, method=method)
    img = crop(img, x=crop_x, y=crop_y, width=crop_w, height=crop_h)
    return normalize(img, mean=mean, std=std)
