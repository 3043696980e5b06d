"""Separable Gaussian blur CUDA kernel (``csrc/gaussian_blur.cu``).

The kernel reads the image once, reflect-101 indexing the borders
itself, so no padded copy of the image is ever written: one CTA blurs
one (image, row tile, column tile) output tile, staging the tile and
its ``ksize - 1`` halo in shared memory, running the vertical taps into
a second shared buffer and the horizontal taps from there.  Taps come
from :func:`repro_torch.kernels.ref.gaussian_kernel_1d` and are summed
in the order of :func:`repro_torch.kernels.ref.gaussian_blur_ref`, with
separately rounded multiplies and adds, so the two agree to the bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gaussian_kernel_1d

launches = _build.LaunchCounter("gaussian_blur")

MAX_KSIZE = 63      # taps held in the kernel's parameter block

_build.declare("gaussian_blur", "gaussian_blur.cu", {
    "repro_gaussian_blur_f32": [ctypes.c_void_p, ctypes.c_void_p]
    + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_void_p]})


def gaussian_blur_cuda(
    img: torch.Tensor,  # (N, H, W, C) or (H, W, C), float32, on CUDA
    ksize: int,
    sigma_x: float,
    sigma_y: float | None = None,
) -> torch.Tensor:
    """Launch the blur kernel on the current CUDA stream."""
    if not img.is_cuda:
        raise ValueError("gaussian_blur_cuda takes a CUDA tensor, got one "
                         f"on {img.device}")
    if img.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 images, got {img.dtype}")
    if not 1 <= ksize <= MAX_KSIZE:
        raise ValueError(f"ksize must be in 1..{MAX_KSIZE}, got {ksize}")
    if sigma_y is None:
        sigma_y = sigma_x
    squeeze = img.ndim == 3
    if squeeze:
        img = img[None]
    if img.ndim != 4:
        raise ValueError(f"expected (N,H,W,C) or (H,W,C), got {tuple(img.shape)}")
    img = img.contiguous()
    n, h, w, c = img.shape
    out = torch.empty_like(img)
    if out.numel():
        ky = (ctypes.c_float * ksize)(
            *map(float, gaussian_kernel_1d(ksize, sigma_y)))
        kx = (ctypes.c_float * ksize)(
            *map(float, gaussian_kernel_1d(ksize, sigma_x)))
        lib = _build.load("gaussian_blur")
        with torch.cuda.device(img.device):
            stream = torch.cuda.current_stream(img.device).cuda_stream
            err = lib.repro_gaussian_blur_f32(
                img.data_ptr(), out.data_ptr(), n, h, w, c,
                ctypes.cast(ky, ctypes.c_void_p),
                ctypes.cast(kx, ctypes.c_void_p), ksize, stream)
        _build.check(err, "gaussian_blur")
        launches.add()
    return out[0] if squeeze else out
