"""Separable Gaussian blur CUDA kernel (``csrc/gaussian_blur.cu``), the
counterpart of the Pallas kernel ``gaussian_blur_pallas``
(``_blur_kernel``) in ``src/repro/kernels/gaussian_blur.py``.

The kernel reads the image once, reflect-101 indexing the borders
itself (only where a load crosses an edge), so no padded copy of the
image is ever written.  One CTA blurs one strip of rows of one segment
of a row of one image, sized by the image so that a single 224x224 or
250x250 image (the engine blurs most images one a launch, where latency
and not bytes bound it) still launches at least 132 CTAs; a batch keeps
taller strips, where the bytes bound it.  Each thread walks down one
float column keeping the vertical window of ``ksize`` rows in registers,
its loads a group of rows ahead, and each group of vertical rows goes
through a shared row buffer to the horizontal taps.  Taps come from
:func:`repro_torch.kernels.ref.gaussian_kernel_1d` and are summed in the
order of :func:`repro_torch.kernels.ref.gaussian_blur_ref`, vertical
pass first, with separately rounded multiplies and adds, so the two
agree to the bit.
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


def halo_fits(ksize: int, c: int) -> bool:
    """Whether a row segment of the kernel (256 threads, one float column
    each) holds its halo of (ksize // 2) * C floats a side and at least
    one output float."""
    return 256 - 2 * (ksize // 2) * c >= 1


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
    if not halo_fits(ksize, c):
        raise ValueError(f"the kernel takes (ksize // 2) * C floats of halo "
                         f"within its segment, not ksize {ksize} at C={c}")
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
