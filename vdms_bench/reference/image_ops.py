"""Plain image operations over (B, H, W, C) float32 batches, with the
semantics the queries name: ``resize`` is ``jax.image.resize``'s
(half-pixel centres, a triangle kernel widened when it shrinks,
weights normalised over the taps that fall inside), ``crop`` clamps
its window into the image as ``lax.dynamic_slice`` does, ``normalize``
is ``(x - mean) / std`` and ``blur`` is OpenCV's separable Gaussian with
reflect-101 borders.  Written from those definitions, not from the
program's code."""
from __future__ import annotations

import numpy as np
import torch

from reference.common import matmul

_LINEAR = ("linear", "bilinear", "triangle", "trilinear")


def resize_weights(n_in: int, n_out: int, method: str = "bilinear"
                   ) -> np.ndarray:
    """(n_out, n_in) weights of one axis of the resize, in float64."""
    if n_in == n_out:
        return np.eye(n_in)
    if method == "nearest":
        pos = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
               * np.float32(n_in) / np.float32(n_out))
        w = np.zeros((n_out, n_in))
        w[np.arange(n_out), np.floor(pos).astype(np.int64)] = 1.0
        return w
    if method not in _LINEAR:
        raise ValueError(f"resize method {method!r} has no reference")
    inv = n_in / n_out
    width = max(inv, 1.0)
    centre = (np.arange(n_out) + 0.5) * inv - 0.5
    dist = np.abs(centre[:, None] - np.arange(n_in)[None, :]) / width
    w = np.maximum(0.0, 1.0 - dist)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return np.where(inside[:, None], w, 0.0)


def resize(x, *, width, height, method="bilinear", precision="fp32"):
    B, H, W, C = x.shape
    dev = x.device
    wy = torch.tensor(resize_weights(H, height, method), dtype=torch.float32,
                      device=dev)
    wx = torch.tensor(resize_weights(W, width, method), dtype=torch.float32,
                      device=dev)
    # rows: (height, H) @ (H, B*W*C); then columns the same way
    y = matmul(wy, x.permute(1, 0, 2, 3).reshape(H, -1), precision)
    y = y.reshape(height, B, W, C).permute(2, 1, 0, 3).reshape(W, -1)
    y = matmul(wx, y, precision)
    return y.reshape(width, B, height, C).permute(1, 2, 0, 3).contiguous()


def crop(img, *, x, y, width, height):
    H, W = img.shape[1], img.shape[2]
    h, w = min(height, H), min(width, W)
    top = max(0, min(y, H - h))
    left = max(0, min(x, W - w))
    return img[:, top:top + h, left:left + w, :]


def normalize(x, *, mean=0.0, std=1.0):
    return (x - float(np.float32(mean))) / float(np.float32(std))


def gaussian_taps(ksize: int, sigma: float) -> list[float]:
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2
    w = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return [float(v) for v in (w / w.sum()).astype(np.float32)]


def _reflect101(n: int, pad: int) -> np.ndarray:
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.abs(idx) % period
    return np.where(idx < n, idx, period - idx)


def blur(x, *, ksize=5, sigma_x=0.0, sigma_y=0.0):
    ky = gaussian_taps(ksize, sigma_y or sigma_x)
    kx = gaussian_taps(ksize, sigma_x)
    pad = ksize // 2
    H, W = x.shape[1], x.shape[2]
    rows = torch.from_numpy(_reflect101(H, pad)).to(x.device)
    xp = x.index_select(1, rows)
    out = sum(ky[i] * xp[:, i:i + H] for i in range(ksize))
    cols = torch.from_numpy(_reflect101(W, pad)).to(x.device)
    xp = out.index_select(2, cols)
    return sum(kx[i] * xp[:, :, i:i + W] for i in range(ksize))


OPS = {"resize": resize, "crop": crop, "normalize": normalize, "blur": blur}


def apply(op: dict, x: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """One query operation (a dict as the query language writes it) over
    the batch ``x``."""
    kind = op["type"]
    if kind not in OPS:
        raise ValueError(f"operation {kind!r} has no reference")
    kw = {k: v for k, v in op.items() if k != "type"}
    if kind == "resize":
        kw["precision"] = precision
    return OPS[kind](x.to(torch.float32), **kw)


def prompt_range(img: torch.Tensor, vocab: int, slack: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The model UDF's prompt of each (H, W, C) image of a batch (B, H,
    W, C): per channel, ``trunc(x * 255)`` summed, its float32 mean,
    clipped to the vocabulary and truncated.  Returned as the lowest and
    highest token that ``x`` moved by ``slack / 255`` in either
    direction could give, (B, C) int64 each: a pixel whose
    ``x * 255`` lies that close to an integer may truncate either way
    under float32 rounding of the resize."""
    npix = img.shape[1] * img.shape[2]
    q = img.to(torch.float32) * 255.0
    out = []
    for shift in (-slack, slack):
        total = torch.trunc(q + shift).clamp(min=0).to(torch.int64).sum((1, 2))
        mean = total.to(torch.float32) / float(npix)
        out.append(torch.clamp(mean, 0, vocab - 1).to(torch.int64))
    return out[0], out[1]


def prompt(img: torch.Tensor, vocab: int) -> torch.Tensor:
    lo, _ = prompt_range(img, vocab, 0.0)
    return lo
