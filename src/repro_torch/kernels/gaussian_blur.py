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

That route holds up to ``MAX_KSIZE`` taps in its parameter block and
needs a 256-float row segment to hold its halo of ``(ksize // 2) * C``
floats a side (:func:`halo_fits`).  Every other window and channel
count takes the kernel's general route, also on the card and also
bit-exact: a vertical and a horizontal pass through a scratch image,
one float a thread, the taps in device memory.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gaussian_kernel_1d

launches = _build.LaunchCounter("gaussian_blur")

MAX_KSIZE = 63      # taps the fast route holds in its parameter block

_build.declare("gaussian_blur", "gaussian_blur.cu", {
    "repro_gaussian_blur_f32": [ctypes.c_void_p, ctypes.c_void_p]
    + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_void_p],
    "repro_gaussian_blur_any_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]})


def halo_fits(ksize: int, c: int) -> bool:
    """Whether a row segment of the kernel (256 threads, one float column
    each) holds its halo of (ksize // 2) * C floats a side and at least
    one output float."""
    return 256 - 2 * (ksize // 2) * c >= 1


def fast_route(ksize: int, c: int) -> bool:
    """Whether a blur takes the kernel's fast route (taps in the
    parameter block, window in registers) rather than its general one."""
    return ksize <= MAX_KSIZE and halo_fits(ksize, c)


@functools.lru_cache(maxsize=64)
def _device_taps(ksize: int, sigma_y: float, sigma_x: float, device: str):
    """(2, ksize) float32 taps, vertical then horizontal, on ``device``
    (one host-to-device copy per distinct window)."""
    return torch.from_numpy(np.stack([gaussian_kernel_1d(ksize, sigma_y),
                                      gaussian_kernel_1d(ksize, sigma_x)])
                            ).to(device)


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
    _build.refuse_grad("gaussian_blur", img)
    if img.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 images, got {img.dtype}")
    ksize = int(ksize)
    if ksize < 1:
        raise ValueError(f"ksize must be >= 1, got {ksize}")
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
    if not out.numel():
        return out[0] if squeeze else out
    lib = _build.load("gaussian_blur")
    if fast_route(ksize, c):
        ky = (ctypes.c_float * ksize)(
            *map(float, gaussian_kernel_1d(ksize, sigma_y)))
        kx = (ctypes.c_float * ksize)(
            *map(float, gaussian_kernel_1d(ksize, sigma_x)))
        with torch.cuda.device(img.device):
            stream = torch.cuda.current_stream(img.device).cuda_stream
            err = lib.repro_gaussian_blur_f32(
                img.data_ptr(), out.data_ptr(), n, h, w, c,
                ctypes.cast(ky, ctypes.c_void_p),
                ctypes.cast(kx, ctypes.c_void_p), ksize, stream)
    else:
        taps = _device_taps(ksize, float(sigma_y), float(sigma_x),
                            str(img.device))
        tmp = torch.empty_like(img)
        with torch.cuda.device(img.device):
            stream = torch.cuda.current_stream(img.device).cuda_stream
            err = lib.repro_gaussian_blur_any_f32(
                img.data_ptr(), tmp.data_ptr(), out.data_ptr(), n, h, w, c,
                taps.data_ptr(), ksize, stream)
    _build.check(err, "gaussian_blur")
    launches.add()
    return out[0] if squeeze else out
