"""Kernel layer of the PyTorch port held against the JAX package.

On the CPU the port's kernel wrappers take their plain versions, so these
tests hold the plain versions (and the resize matrices the fused
preprocess kernel consumes) against the JAX package's Pallas kernels,
run in interpret mode, and its references.  The CUDA kernels themselves
run only on a card: ``tests/test_torch_cuda.py`` holds them against the
plain versions there (it imports no JAX, so it runs on a card's host).

Tolerances (absolute, float32 images in [0, 1]):
- blur: 1e-6 — the same taps summed in the same order; only the
  compiler's rounding of the reference can differ;
- resize matrices: 1e-6 — the same float32 formula, a few ulps apart
  where XLA and numpy order a reduction differently; nearest: exact;
- fused preprocess: 1e-5 — two matrix products in another order than
  XLA's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import preprocess as jpp
from repro.kernels import ref as jref
from repro.kernels.gaussian_blur import gaussian_blur_pallas
from repro_torch.kernels import ops as tops
from repro_torch.kernels import preprocess as tpp
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

BLUR_TOL = 1e-6
RESIZE_TOL = 1e-6
PREPROCESS_TOL = 1e-5


def _uniform(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


# ----------------------------------------------------------------- blur
@pytest.mark.parametrize("shape", [(2, 40, 32, 3), (1, 17, 23, 3)])
@pytest.mark.parametrize("ksize,sigma", [(3, 1.0), (5, 0.0), (7, 2.5)])
def test_blur_plain_matches_pallas_and_ref(shape, ksize, sigma):
    img = _uniform(ksize, shape)
    pallas = np.asarray(gaussian_blur_pallas(jnp.asarray(img), ksize, sigma,
                                             block_rows=8, interpret=True))
    jax_ref = np.asarray(jref.gaussian_blur_ref(jnp.asarray(img), ksize, sigma))
    got = tops.gaussian_blur(torch.from_numpy(img), ksize, sigma).numpy()
    np.testing.assert_allclose(got, pallas, atol=BLUR_TOL, rtol=0)
    np.testing.assert_allclose(got, jax_ref, atol=BLUR_TOL, rtol=0)


def test_blur_taps_and_reflect_padding_match():
    for ksize, sigma in [(3, 1.0), (5, 0.0), (9, 2.0), (4, 1.2)]:
        np.testing.assert_array_equal(tref.gaussian_kernel_1d(ksize, sigma),
                                      jref.gaussian_kernel_1d(ksize, sigma))
    # reflect-101, also when the pad exceeds the axis (repeated reflection)
    for n, pad in [(5, 2), (3, 4), (2, 3), (1, 2)]:
        x = np.arange(n, dtype=np.float32)
        want = np.asarray(jref._reflect101_pad(jnp.asarray(x), pad, axis=0))
        np.testing.assert_array_equal(x[tref.reflect101_index(n, pad)], want)


def test_blur_preserves_mean_and_batches():
    img = _uniform(3, (3, 32, 32, 3))
    out = tops.gaussian_blur(torch.from_numpy(img), 5, 1.5)
    assert abs(float(out.mean()) - float(img.mean())) < 1e-2
    one = tops.gaussian_blur(torch.from_numpy(img[1]), 5, 1.5)
    np.testing.assert_array_equal(out[1].numpy(), one.numpy())


# --------------------------------------------------------------- resize
METHODS = ["nearest", "linear", "bilinear", "cubic", "lanczos3", "lanczos5"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n_in,n_out", [(9, 23), (23, 9), (250, 256),
                                        (250, 48), (17, 17), (1, 5), (7, 1)])
def test_resize_matrix_matches_jax(method, n_in, n_out):
    want = jpp.resize_matrix(n_in, n_out, method)
    got = tpp.resize_matrix(n_in, n_out, method)
    assert got.shape == want.shape == (n_out, n_in)
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0)


def test_band_limits_cover_every_nonzero():
    for method in ("linear", "lanczos3"):
        m = tpp.resize_matrix(250, 48, method)
        lo, hi = tpp.band_limits(m)
        cols = np.arange(m.shape[1])[None, :]
        outside = (cols < lo[:, None]) | (cols > hi[:, None])
        assert not np.any(m[outside])
        assert np.all(m[np.arange(m.shape[0]), lo] != 0)
    lo, hi = tpp.band_limits(np.zeros((2, 3), np.float32))
    assert list(lo) == [0, 0] and list(hi) == [-1, -1]


# ----------------------------------------------------------- preprocess
PREPROCESS_CASES = [
    # (N, H, W), resize (h, w), crop (x, y, w, h), method
    ((2, 31, 29), (40, 36), (3, 5, 20, 24), "bilinear"),     # odd sizes
    ((1, 40, 48), (24, 20), (10, 12, 30, 30), "bilinear"),   # clamped crop
    ((2, 64, 50), (16, 12), (0, 0, 16, 12), "linear"),       # downsample
    ((1, 20, 20), (33, 27), (-4, 50, 8, 9), "cubic"),        # start clamps
]


@pytest.mark.parametrize("shape,res,crop,method", PREPROCESS_CASES)
def test_fused_preprocess_plain_matches_pallas(shape, res, crop, method):
    img = _uniform(sum(shape), shape + (3,))
    kw = dict(resize_h=res[0], resize_w=res[1], method=method,
              crop_x=crop[0], crop_y=crop[1], crop_w=crop[2],
              crop_h=crop[3], mean=0.45, std=0.22)
    want = np.asarray(jpp.fused_resize_crop_normalize_pallas(
        jnp.asarray(img), interpret=True, **kw))
    got = tops.fused_preprocess(torch.from_numpy(img), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=PREPROCESS_TOL, rtol=0)
    # the folded matrices the CUDA kernel consumes give the same result
    ry, rx = tpp._cropped_matrices(shape[1], shape[2], res[0], res[1],
                                   tpp._canonical_method(method), *crop[:2],
                                   *crop[2:])
    folded = (np.einsum("oh,nhwc,pw->nopc", ry.astype(np.float64), img,
                        rx.astype(np.float64)) - np.float32(0.45)) \
        / np.float32(0.22)
    np.testing.assert_allclose(got, folded, atol=PREPROCESS_TOL, rtol=0)


def test_wrappers_refuse_devices_without_a_path():
    with pytest.raises(ValueError, match="CUDA tensor"):
        from repro_torch.kernels.gaussian_blur import gaussian_blur_cuda
        gaussian_blur_cuda(torch.zeros(1, 4, 4, 3), 3, 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpp.fused_resize_crop_normalize_cuda(
            torch.zeros(1, 4, 4, 3), resize_h=4, resize_w=4, crop_x=0,
            crop_y=0, crop_w=4, crop_h=4)
    with pytest.raises(ValueError, match="meta"):
        tops.gaussian_blur(torch.zeros(1, 4, 4, 3, device="meta"), 3, 1.0)
