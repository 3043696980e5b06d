"""Public wrappers around the CUDA kernels.

The tensor's device picks the implementation (the JAX package's
``impl="auto"``): a tensor on the CPU takes the plain PyTorch version,
a CUDA tensor launches the hand-written kernel — and a kernel that
cannot take it raises; nothing falls back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import preprocess as pp
from repro_torch.kernels import ref
from repro_torch.kernels.gaussian_blur import gaussian_blur_cuda


def _on_cuda(img: torch.Tensor) -> bool:
    if img.is_cuda:
        return True
    if img.device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain path for tensors on {img.device}")


# ----------------------------------------------------------------- blur
def gaussian_blur(img, ksize: int, sigma_x: float, sigma_y: float | None = None):
    """img (..., H, W, C); OpenCV-compatible separable Gaussian blur."""
    if not _on_cuda(img):
        return ref.gaussian_blur_ref(img, ksize, sigma_x, sigma_y)
    lead = img.shape[:-3]
    out = gaussian_blur_cuda(img.reshape((-1,) + tuple(img.shape[-3:])),
                             ksize, sigma_x, sigma_y)
    return out.reshape(lead + out.shape[-3:])


# ----------------------------------------------------------- preprocess
def fused_preprocess(img, *, resize_h: int, resize_w: int,
                     method: str = "bilinear",
                     crop_x: int, crop_y: int, crop_w: int, crop_h: int,
                     mean: float = 0.0, std: float = 1.0):
    """img (..., H, W, C): fused resize→crop→normalize in one launch on
    CUDA, the composed native-table ops on the CPU.  See
    repro_torch.kernels.preprocess for the folding trick."""
    kw = dict(resize_h=resize_h, resize_w=resize_w, method=method,
              crop_x=crop_x, crop_y=crop_y, crop_w=crop_w, crop_h=crop_h,
              mean=mean, std=std)
    if not _on_cuda(img):
        return pp.fused_resize_crop_normalize_ref(img, **kw)
    lead = img.shape[:-3]
    out = pp.fused_resize_crop_normalize_cuda(
        img.reshape((-1,) + tuple(img.shape[-3:])), **kw)
    return out.reshape(lead + out.shape[-3:])
