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
matrices are banded (a few taps per output pixel), so the wrapper also
hands the kernel each row's first and last nonzero column, and the
kernel sums only inside those bands — the same sums as the dense
products, minus the exact zeros.

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


# ------------------------------------------------------------ the kernel
launches = _build.LaunchCounter("fused_resize_crop_normalize")

_MAX_C = 4          # per-thread accumulators of csrc/preprocess.cu


@functools.lru_cache(maxsize=64)
def _device_operands(h_in: int, w_in: int, h_res: int, w_res: int,
                     method: str, cx: int, cy: int, cw: int, ch: int,
                     device: str):
    """The cropped matrices and their band limits, on ``device`` (one
    host→device copy per distinct geometry)."""
    ry, rx = _cropped_matrices(h_in, w_in, h_res, w_res, method,
                               cx, cy, cw, ch)
    ry_lo, ry_hi = band_limits(ry)
    rx_lo, rx_hi = band_limits(rx)
    return tuple(torch.tensor(a, device=device)
                 for a in (ry, rx, ry_lo, ry_hi, rx_lo, rx_hi))


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
    if img.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 images, got {img.dtype}")
    squeeze = img.ndim == 3
    if squeeze:
        img = img[None]
    if img.ndim != 4:
        raise ValueError(f"expected (N,H,W,C) or (H,W,C), got {tuple(img.shape)}")
    n, hi, wi, c = img.shape
    if not 1 <= c <= _MAX_C:
        raise ValueError(f"the kernel takes 1..{_MAX_C} channels, got {c}")
    img = img.contiguous()
    ry, rx, ry_lo, ry_hi, rx_lo, rx_hi = _device_operands(
        hi, wi, resize_h, resize_w, _canonical_method(method),
        crop_x, crop_y, crop_w, crop_h, str(img.device))
    hc, wc = ry.shape[0], rx.shape[0]
    out = torch.empty((n, hc, wc, c), dtype=torch.float32, device=img.device)
    if out.numel():
        lib = _build.load("preprocess")
        with torch.cuda.device(img.device):
            stream = torch.cuda.current_stream(img.device).cuda_stream
            err = lib.repro_preprocess_f32(
                img.data_ptr(), ry.data_ptr(), rx.data_ptr(),
                ry_lo.data_ptr(), ry_hi.data_ptr(),
                rx_lo.data_ptr(), rx_hi.data_ptr(), out.data_ptr(),
                n, hi, wi, c, hc, wc, float(mean), float(std), stream)
        _build.check(err, "fused_resize_crop_normalize")
        launches.add()
    return out[0] if squeeze else out


_build.declare("preprocess", "preprocess.cu", {
    "repro_preprocess_f32": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
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
