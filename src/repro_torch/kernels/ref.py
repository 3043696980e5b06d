"""Plain PyTorch versions of the kernels: the CPU execution path and the
oracle each CUDA kernel is held against on the card.

Only the Gaussian blur lives here so far (the attention and scan
oracles belong to the model layer).
"""
from __future__ import annotations

import numpy as np
import torch


# ===================================================================
# gaussian blur (separable, reflect-101 borders a la OpenCV)
# ===================================================================
def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    if sigma <= 0:  # OpenCV convention
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    w = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (w / w.sum()).astype(np.float32)


def reflect101_index(n: int, pad: int) -> np.ndarray:
    """Source index of every position of a length-``n`` axis padded by
    ``pad`` on both sides with reflect-101 borders (``dcb|abcd|cba``),
    repeating the reflection when ``pad`` exceeds ``n - 1`` exactly as
    ``numpy.pad(mode="reflect")`` does."""
    j = np.abs(np.arange(-pad, n + pad))
    if n == 1:
        return np.zeros_like(j)
    period = 2 * (n - 1)
    j = j % period
    return np.where(j < n, j, period - j)


def _reflect101_pad(x: torch.Tensor, pad: int, axis: int) -> torch.Tensor:
    idx = torch.from_numpy(reflect101_index(x.shape[axis], pad))
    return x.index_select(axis, idx.to(x.device))


def gaussian_blur_ref(img: torch.Tensor, ksize: int, sigma_x: float,
                      sigma_y: float | None = None) -> torch.Tensor:
    """img: (..., H, W, C) float; separable blur along H then W, each
    pass summed tap by tap in float32 in the order of the taps."""
    if sigma_y is None:
        sigma_y = sigma_x
    kx = [float(v) for v in gaussian_kernel_1d(ksize, sigma_x)]
    ky = [float(v) for v in gaussian_kernel_1d(ksize, sigma_y)]
    pad = ksize // 2
    dtype = img.dtype
    x = img.to(torch.float32)
    h, w = x.shape[-3], x.shape[-2]
    # vertical (H axis = -3)
    xp = _reflect101_pad(x, pad, axis=-3)
    out = sum(ky[i] * xp.narrow(-3, i, h) for i in range(ksize))
    # horizontal (W axis = -2)
    xp = _reflect101_pad(out, pad, axis=-2)
    out = sum(kx[i] * xp.narrow(-2, i, w) for i in range(ksize))
    return out.to(dtype)
