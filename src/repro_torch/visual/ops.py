"""Native visual operations (the paper's OpenCV-equivalent set), in
PyTorch.

Each op takes (img (..., H, W, C) float32 in [0,1], **params) and returns
an image: one function serves a single entity (H, W, C) and the device
backend's stacked batch (B, H, W, C) alike.  Ops are pure functions:
none writes into its input.  The Gaussian blur routes through the kernel
wrapper (the CUDA kernel on the card, the plain version on the CPU).

Parity with the JAX package (``repro.visual.ops``):

- ``crop`` clamps its start so the window stays inside the image, as
  ``lax.dynamic_slice`` does;
- ``resize``/``upsample``/``downsample`` are the products with the
  interpolation matrices of ``jax.image.resize``
  (:func:`repro_torch.kernels.preprocess.resize_matrix`);
- ``threshold``, ``flip``, ``rotate``, ``crop`` and ``caption`` move or
  compare values without arithmetic, so they match bit for bit.

Covers IQ1-IQ9 / VQ1-VQ9 from the paper's benchmark suite.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.preprocess import _canonical_method, resize_matrix
from repro_torch.visual.font import draw_text


# ------------------------------------------------------------- resizing
@functools.lru_cache(maxsize=256)
def _matrix(n_in: int, n_out: int, method: str, device: str) -> torch.Tensor:
    return torch.tensor(resize_matrix(n_in, n_out, method), device=device)


@functools.lru_cache(maxsize=256)
def _nearest_index(n_in: int, n_out: int, device: str) -> torch.Tensor:
    idx = resize_matrix(n_in, n_out, "nearest").argmax(axis=1)
    return torch.tensor(idx, dtype=torch.long, device=device)


def resize_hw(img, height: int, width: int, method: str = "bilinear"):
    """``jax.image.resize`` of the (H, W) axes of (..., H, W, C)."""
    method = _canonical_method(method)
    h_in, w_in = img.shape[-3], img.shape[-2]
    dev = str(img.device)
    if method == "nearest":
        if h_in != height:
            img = img.index_select(-3, _nearest_index(h_in, height, dev))
        if w_in != width:
            img = img.index_select(-2, _nearest_index(w_in, width, dev))
        return img
    if not img.is_floating_point():
        img = img.to(torch.float32)
    if h_in != height:
        ry = _matrix(h_in, height, method, dev).to(img.dtype)
        img = torch.einsum("oh,...hwc->...owc", ry, img)
    if w_in != width:
        rx = _matrix(w_in, width, method, dev).to(img.dtype)
        img = torch.einsum("pw,...hwc->...hpc", rx, img)
    return img


def resize_2d(x, height: int, width: int, method: str = "linear"):
    """``jax.image.resize`` of a (..., H, W) map."""
    return resize_hw(x[..., None], height, width, method)[..., 0]


# ----------------------------------------------------------------- ops
def crop(img, *, x: int, y: int, width: int, height: int):
    H, W = img.shape[-3], img.shape[-2]
    h, w = min(height, H), min(width, W)
    # dynamic_slice semantics: the start is clamped into the image
    y0 = max(0, min(y, H - h))
    x0 = max(0, min(x, W - w))
    return img[..., y0:y0 + h, x0:x0 + w, :]


def resize(img, *, width: int, height: int, method: str = "bilinear"):
    return resize_hw(img, height, width, method)


def rotate(img, *, k: int = 1):
    """Rotate by k*90 degrees counterclockwise."""
    return torch.rot90(img, k % 4, dims=(-3, -2))


def flip(img, *, axis: str = "horizontal"):
    return torch.flip(img, dims=(-2,) if axis == "horizontal" else (-3,))


def grayscale(img):
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype,
                     device=img.device)
    g = torch.tensordot(img, w, dims=([-1], [0]))
    return g[..., None].expand(g.shape + (img.shape[-1],)).contiguous()


def blur(img, *, ksize: int = 5, sigma_x: float = 0.0, sigma_y: float = 0.0):
    return kops.gaussian_blur(img, ksize, sigma_x, sigma_y or None)


def threshold(img, *, value: float = 0.5, max_value: float = 1.0):
    return torch.where(img > value, max_value, 0.0).to(img.dtype)


def upsample(img, *, fx: float = 2.0, fy: float = 2.0):
    H, W = img.shape[-3], img.shape[-2]
    return resize_hw(img, int(H * fy), int(W * fx), "bilinear")


def downsample(img, *, fx: float = 2.0, fy: float = 2.0):
    H, W = img.shape[-3], img.shape[-2]
    return resize_hw(img, max(int(H / fy), 1), max(int(W / fx), 1),
                     "bilinear")


def normalize(img, *, mean: float = 0.0, std: float = 1.0):
    """Affine channel normalization ``(img - mean) / std`` — the
    standard model-preprocessing tail.  Scalar parameters only (op
    params must stay hashable for pipeline signatures)."""
    return ((img - float(np.float32(mean))) / float(np.float32(std))
            ).to(img.dtype)


def caption(img, *, text: str = "", x: int = 4, y: int = 4,
            intensity: float = 1.0):
    return draw_text(img, text, x, y, intensity)


def _grid(img):
    H, W = img.shape[-3], img.shape[-2]
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    return ys, xs


def box(img, *, x: int, y: int, width: int, height: int,
        thickness: int = 2, color=(0.0, 1.0, 0.0)):
    """Draw a rectangle outline (used by the face-detect pipeline)."""
    ys, xs = _grid(img)
    inside = (ys >= y) & (ys < y + height) & (xs >= x) & (xs < x + width)
    inner = ((ys >= y + thickness) & (ys < y + height - thickness)
             & (xs >= x + thickness) & (xs < x + width - thickness))
    border = inside & ~inner
    col = torch.tensor(color, dtype=img.dtype, device=img.device)
    return torch.where(border[..., None], col, img)


def circle_mask(img, *, cx: int, cy: int, r: int, keep_inside: bool = True):
    """Circular mask centred at (cx, cy): blacks out the other region."""
    ys, xs = _grid(img)
    d2 = (ys.to(torch.float32) - cy) ** 2 + (xs.to(torch.float32) - cx) ** 2
    inside = d2 <= float(r) ** 2
    keep = inside if keep_inside else ~inside
    return torch.where(keep[..., None], img, 0.0).to(img.dtype)


NATIVE_OPS = {
    "crop": crop,
    "resize": resize,
    "rotate": rotate,
    "flip": flip,
    "grayscale": grayscale,
    "blur": blur,
    "threshold": threshold,
    "normalize": normalize,
    "upsample": upsample,
    "downsample": downsample,
    "caption": caption,
    "box": box,
    "circle_mask": circle_mask,
}


def apply_native_op(name: str, img, params: dict):
    if name not in NATIVE_OPS:
        raise KeyError(f"unknown native op {name!r}; have {sorted(NATIVE_OPS)}")
    return NATIVE_OPS[name](img, **params)
