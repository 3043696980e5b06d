"""Public wrappers around the CUDA kernels.

The tensor's device picks the implementation (the JAX package's
``impl="auto"``): a tensor on the CPU takes the plain PyTorch version,
a CUDA tensor launches the hand-written kernel — and a kernel that
cannot take it raises; nothing falls back to the plain version.  A
``meta`` tensor (the dry run) takes the kernel's meta route where the
model path has one (K3, K4, K5): outputs of the kernel's shapes and a
record of its launch and work in the active ``launch.costs`` counter;
the image kernels (K1, K2) have none and raise, as any other device
does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_vjp
from repro_torch.kernels import preprocess as pp
from repro_torch.kernels import ref
from repro_torch.kernels.gaussian_blur import gaussian_blur_cuda
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.kernels import rwkv6_scan as wkv


def _on_cuda(img: torch.Tensor) -> bool:
    if img.is_cuda:
        return True
    if img.device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain path for tensors on {img.device}")


# ----------------------------------------------------------------- attn
def flash_attention(q, k, v, *, causal=True, sm_scale=None, impl="auto",
                    q_block=512, kv_block=1024, q_offset=0):
    """(B,Sq,H,D) x (B,Sk,Hkv,D) -> (B,Sq,H,D); GQA via Hkv | H.

    ``impl``: ``"auto"`` launches the flash kernel (K3) for a CUDA
    tensor and takes the chunked route for a CPU tensor; ``"chunked"``
    and ``"naive"`` are the explicit plain routes.  ``q_block`` and
    ``kv_block`` tile the chunked route; the kernel tiles by its own."""
    if impl == "auto":
        if q.is_meta or _on_cuda(q):
            return flash_vjp.flash_attention(q, k, v, q_offset, causal,
                                             sm_scale)
        impl = "chunked"
    if impl == "naive":
        return ref.naive_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                   q_offset=q_offset)
    if impl == "chunked":
        return ref.flash_attention_chunked(
            q, k, v, causal=causal, sm_scale=sm_scale, q_block=q_block,
            kv_block=kv_block, q_offset=q_offset)[0]
    raise ValueError(f"unknown attention impl {impl!r}")


def decode_attention(q, k_cache, v_cache, cache_len, *, sm_scale=None):
    """Single-token attention against a cache: q (B,1,H,D).  Plain code
    on every device, as in the JAX package."""
    return ref.decode_attention_ref(q, k_cache, v_cache, cache_len,
                                    sm_scale=sm_scale)


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


# ----------------------------------------------------------------- rwkv
def rwkv6_scan(r, k, v, w, u, state=None, *, chunk: int = 64):
    """Chunked RWKV6 WKV scan: r/k/w (B,T,H,K), v (B,T,H,V) -> (y in r's
    dtype, final state (B,H,K,V) float32).  A CPU tensor takes the
    chunked closed form (what the JAX package runs off the TPU), a CUDA
    tensor the WKV6 kernel (K5); both under ``rwkv6_scan.RwkvWKV``, whose
    backward is the closed-form gradient of the chunked form: the
    backward kernel on a CUDA tensor, its plain version on a CPU one."""
    return wkv.rwkv6_scan(r, k, v, w, u, state, chunk=chunk)


# ---------------------------------------------------------------- mamba
def mamba2_ssd(x, dt, A, Bm, Cm, D=None, state=None, *, chunk: int = 128):
    """Chunked Mamba2 SSD scan: x (B,T,H,P) -> (y in x's dtype, final
    state (B,H,P,N) float32).  The chunk follows the TPU wrapper's rule
    ``min(chunk, max(T, 8))`` on both routes: the kernel (K4) on a CUDA
    tensor, the chunked form on a CPU tensor, both under
    ``mamba2_ssd.MambaSSD``, whose backward is the closed-form gradient
    of the chunked form: the backward kernel on a CUDA tensor, its plain
    version on a CPU one."""
    return ssd.mamba2_ssd(x, dt, A, Bm, Cm, D, state, chunk=chunk)
