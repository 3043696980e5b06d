"""The PyTorch port on a CUDA card: each hand-written kernel against its
plain version, and the engine's main path through the kernels.  Every
test here is marked ``cuda`` and skips on a host without a card; on a
card's host run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``
(this file imports no JAX, so it needs only the port).

Tolerances (absolute, float32 images in [0, 1]): blur kernel exact on
both of its routes (the same taps in the same order, rounded
separately), fused preprocess kernel 1e-4 (tap-table sums in another
order than the composed products).
Mamba2 SSD kernel: 5e-4 in float32 (chunk sums of up to 128 products in
another order than cuBLAS, on outputs of magnitude up to about 10), and
in bfloat16 5e-2 plus one bfloat16 rounding step (2^-7 relative), since
the two versions may round a float32 value on either side of a
bfloat16 boundary.  WKV6 kernel: the same, 5e-4 in float32 (sums over
64 decayed steps in another order) and 5e-2 plus one bfloat16 step.
Flash-attention kernel: 2e-5 in float32 (the JAX package's flash
tolerance), its log-sum-exp 1e-4; in bfloat16 both versions compute in
float32 from the same inputs and round the output once, so they may
land one bfloat16 step apart: 2^-7 relative plus 5e-3 absolute, a
sixth of a typical output (about 0.03 for a row over 4096 keys).

K4's and K5's autograd Functions: the forward within the kernel's own
tolerance above, the gradients (the backward kernels') within 1e-5 of
each gradient's largest magnitude of autograd through the plain chunked
form on the card (the same float32 gradient in closed form, summed in
another order; a bfloat16 gradient one bfloat16 step, 2^-7 relative,
beyond that).  The backward kernels alone against their plain versions:
see their sections below.  Reduced zamba2 and rwkv6 trained on the card
agree with the host in loss (1e-5) and gradient norm (1e-4).

Reduced granite-moe, whisper and internvl2 on the card agree with the
same model on the host to 3e-4 (the JAX package's tolerance between
its prefill or decode and its forward).

The scale-out path on the card: a 2-shard cluster with a device backend
on each shard against one CUDA engine (1e-4, the fused preprocess
kernel's tolerance), the wire in front of a CUDA engine and the codec on
CUDA tensors (exact), and the baseline executors against the engine on
a remote blur (exact: the same kernel on the same images).
"""
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import preprocess as pp
from repro_torch.kernels import ref

STATIC_SHA256 = "778564da3d5f5530f0f4761d6af9f4c901796a91ff38620f2b75dd8cfa03a1b0"
SSD_TOL = 5e-4
SSD_BF16_ATOL, SSD_BF16_RTOL = 5e-2, 2.0 ** -7
WKV_TOL = 5e-4
FLASH_TOL, FLASH_LSE_TOL = 2e-5, 1e-4
FLASH_BF16_ATOL, FLASH_BF16_RTOL = 5e-3, 2.0 ** -7

PREPROCESS_CASES = [
    # (N, H, W), resize (h, w), crop (x, y, w, h), method
    ((2, 31, 29), (40, 36), (3, 5, 20, 24), "bilinear"),     # odd sizes
    ((1, 40, 48), (24, 20), (10, 12, 30, 30), "bilinear"),   # clamped crop
    ((2, 64, 50), (16, 12), (0, 0, 16, 12), "linear"),       # downsample
    ((1, 20, 20), (33, 27), (-4, 50, 8, 9), "cubic"),        # start clamps
    ((3, 250, 250), (256, 256), (16, 16, 224, 224), "bilinear"),
    ((1, 1080, 1920), (224, 224), (0, 0, 224, 224), "lanczos3"),
    ((1, 250, 250), (256, 256), (16, 16, 224, 224), "bilinear"),
    ((32, 250, 250), (256, 256), (16, 16, 224, 224), "bilinear"),
    # the wide route: windows of 1,440 columns, of 1,650 rows
    ((1, 1080, 1920), (8, 8), (0, 0, 8, 8), "lanczos3"),
    ((2, 2200, 6), (2, 6), (0, 0, 6, 2), "linear"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _uniform(seed, shape, device):
    x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ksize,sigma", [
    ((3, 37, 45, 3), 5, 1.5), ((2, 70, 33, 1), 9, 2.0),
    ((1, 5, 4, 4), 31, 0.0), ((2, 224, 224, 3), 9, 2.0),
    ((1, 1080, 1920, 3), 5, 1.5), ((1, 9, 11, 3), 4, 1.0),
    # the engine's per-entity images: a 224-wide row of 3 floats is 2,688
    # bytes, a multiple of 16, a 250-wide row 3,000 bytes, which is not
    ((1, 224, 224, 3), 9, 2.0), ((1, 250, 250, 3), 5, 1.5),
    ((1, 224, 224, 4), 9, 2.0), ((1, 251, 250, 3), 9, 2.0),
    # every window: odd sizes with their own, an even size and a size past
    # 15 with the tap count at run time; a 1-row image
    ((2, 61, 37, 3), 3, 0.0), ((1, 40, 70, 3), 15, 3.0),
    ((1, 33, 29, 2), 6, 1.2), ((1, 90, 64, 3), 21, 4.0),
    ((1, 1, 17, 3), 5, 1.5), ((1, 128, 128, 3), 7, 2.0),
    ((2, 47, 53, 3), 13, 2.5),
    # the general route: windows past 63 taps, halos of (ksize // 2) * C
    # > 127 floats, pads as large as the image or larger
    ((1, 40, 70, 3), 64, 0.0), ((2, 37, 45, 3), 65, 10.0),
    ((1, 250, 250, 3), 99, 0.0), ((1, 30, 20, 2), 127, 20.0),
    ((1, 224, 224, 64), 5, 1.5), ((2, 12, 10, 8), 33, 0.0),
    ((1, 1, 1, 3), 65, 0.0),
    # the fast route with a pad past H and W
    ((1, 3, 4, 3), 11, 2.0), ((1, 2, 3, 1), 9, 0.0)])
def test_blur_kernel_matches_plain(cuda, shape, ksize, sigma):
    from repro_torch.kernels.gaussian_blur import gaussian_blur_cuda, launches
    x = _uniform(ksize, shape, cuda)
    before = launches.count
    got = gaussian_blur_cuda(x, ksize, sigma)
    want = ref.gaussian_blur_ref(x, ksize, sigma)
    torch.cuda.synchronize()
    assert launches.count == before + 1
    assert torch.equal(got, want)
    # one image of a batch, read at an offset from the allocation
    batch = _uniform(sum(shape), (3,) + shape[1:], cuda)
    assert torch.equal(gaussian_blur_cuda(batch[1], ksize, sigma),
                       ref.gaussian_blur_ref(batch[1], ksize, sigma))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,res,crop,method", PREPROCESS_CASES)
def test_preprocess_kernel_matches_plain(cuda, shape, res, crop, method):
    x = _uniform(sum(shape), shape + (3,), cuda)
    kw = dict(resize_h=res[0], resize_w=res[1], method=method,
              crop_x=crop[0], crop_y=crop[1], crop_w=crop[2],
              crop_h=crop[3], mean=0.45, std=0.22)
    before = pp.launches.count
    got = pp.fused_resize_crop_normalize_cuda(x, **kw)
    want = pp.fused_resize_crop_normalize_ref(x, **kw)
    torch.cuda.synchronize()
    assert pp.launches.count == before + 1
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 2, 4, 5, 8])
@pytest.mark.parametrize("shape,res,crop,method", [
    ((2, 250, 250), (256, 256), (16, 16, 224, 224), "bilinear"),
    ((1, 64, 50), (16, 12), (0, 0, 16, 12), "linear"),
    ((1, 40, 48), (24, 20), (10, 12, 30, 30), "lanczos3"),
])
def test_preprocess_kernel_takes_any_channel_count(cuda, c, shape, res, crop,
                                                   method):
    """K2 at 1-8 channels (the dense-matrix kernel before the tap
    tables took at most 4), also on an image read at an offset from its
    allocation."""
    kw = dict(resize_h=res[0], resize_w=res[1], method=method,
              crop_x=crop[0], crop_y=crop[1], crop_w=crop[2],
              crop_h=crop[3], mean=0.45, std=0.22)
    x = _uniform(c + sum(shape), shape + (c,), cuda)
    for img in (x, x[-1]):
        before = pp.launches.count
        got = pp.fused_resize_crop_normalize_cuda(img, **kw)
        want = pp.fused_resize_crop_normalize_ref(img, **kw)
        torch.cuda.synchronize()
        assert pp.launches.count == before + 1
        assert got.shape == want.shape and got.shape[-1] == c
        assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape,res,crop,method", [
    ((1, 8, 2100, 1), (4, 2), (0, 0, 2, 4), "lanczos3"),
    ((2, 2200, 6, 300), (2, 6), (0, 0, 6, 2), "linear"),
    ((1, 1500, 40, 3), (3, 40), (0, 0, 40, 3), "cubic"),
    ((8, 1080, 1920, 1), (64, 8), (0, 0, 8, 64), "lanczos3"),
])
def test_preprocess_kernel_takes_any_window(cuda, shape, res, crop, method):
    """K2's wide route, for windows of over 1,024 columns or rows: one
    channel, 300 channels, a tall window beside a short one, and a batch
    of 8 to 64 x 8."""
    kw = dict(resize_h=res[0], resize_w=res[1], method=method,
              crop_x=crop[0], crop_y=crop[1], crop_w=crop[2],
              crop_h=crop[3], mean=0.45, std=0.22)
    geometry = (shape[1], shape[2], res[0], res[1],
                pp._canonical_method(method), *crop)
    assert pp._plan(geometry, shape[0], shape[3])["route"] == "wide"
    x = _uniform(sum(shape), shape, cuda)
    before = pp.launches.count
    got = pp.fused_resize_crop_normalize_cuda(x, **kw)
    want = pp.fused_resize_crop_normalize_ref(x, **kw)
    torch.cuda.synchronize()
    assert pp.launches.count == before + 1
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_their_kernels_cannot_take(cuda):
    """No wrapper falls back to its plain version on the card: what its
    kernel cannot take raises."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_cuda)
    from repro_torch.kernels.gaussian_blur import gaussian_blur_cuda
    q = torch.zeros(1, 8, 2, 96, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_cuda(q.half(), q.half(), q.half())
    lse = torch.zeros(1, 8, 2, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_backward_cuda(q, q, q, q, lse, q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_backward_cuda(*[q.half()] * 4, lse, q.half())
    q = q[..., :64]
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_backward_cuda(q, q, q, q, lse, q.bfloat16())
    with pytest.raises(ValueError, match="inconsistent shapes"):
        flash_attention_backward_cuda(q, q, q, q, lse[:, :4], q)
    img = torch.zeros(1, 8, 8, 3, device=cuda)
    with pytest.raises(ValueError, match="ksize"):
        gaussian_blur_cuda(img, 0, 1.0)
    with pytest.raises(TypeError, match="float32"):
        gaussian_blur_cuda(img.double(), 5, 1.0)
    with pytest.raises(TypeError, match="float32"):
        pp.fused_resize_crop_normalize_cuda(
            img.double(), resize_h=4, resize_w=4, crop_x=0, crop_y=0,
            crop_w=4, crop_h=4)
    with pytest.raises(ValueError, match="expected"):
        pp.fused_resize_crop_normalize_cuda(
            img[0, 0], resize_h=4, resize_w=4, crop_x=0, crop_y=0,
            crop_w=4, crop_h=4)


@pytest.mark.cuda
def test_engine_static_hash_and_device_backend_on_the_card(cuda):
    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.kernels import gaussian_blur as gb
    eng = VDMSAsyncEngine(device="cuda", num_remote_servers=2)
    try:
        rng = np.random.default_rng(11)
        for i in range(8):
            img = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
            eng.add_entity("image", img, {"category": "dsp", "idx": i})
        res = eng.execute([{"FindImage": {
            "constraints": {"category": ["==", "dsp"]}, "operations": [
                {"type": "crop", "x": 4, "y": 4, "width": 24, "height": 24},
                {"type": "remote", "url": "u", "options": {"id": "flip"}},
                {"type": "rotate", "k": 1},
                {"type": "threshold", "value": 0.5}]}}], timeout=120)
    finally:
        eng.shutdown()
    h = hashlib.sha256()
    for eid, arr in res["entities"].items():
        assert isinstance(arr, np.ndarray)
        arr = np.ascontiguousarray(arr)
        h.update(eid.encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    assert h.hexdigest() == STATIC_SHA256

    pipe = [{"type": "resize", "width": 64, "height": 64},
            {"type": "crop", "x": 8, "y": 8, "width": 48, "height": 48},
            {"type": "normalize", "mean": 0.45, "std": 0.22},
            {"type": "blur", "ksize": 9, "sigma_x": 2.0}]
    pinned = {o["type"]: {"device": 1e-6, "native": 10.0, "remote": 10.0,
                          "batcher": 10.0} for o in pipe}
    query = [{"FindImage": {"constraints": {"category": ["==", "d"]},
                            "operations": pipe}}]
    out = {}
    for mode in ("native", "cost"):
        kw = (dict(device_backend=True, cost_overrides=pinned)
              if mode == "cost" else {})
        eng = VDMSAsyncEngine(device="cuda", dispatch=mode, **kw)
        try:
            for i in range(6):
                img = np.random.default_rng(i).uniform(
                    0, 1, (72, 72, 3)).astype(np.float32)
                eng.add_entity("image", img, {"category": "d"})
            k1, k2 = gb.launches.count, pp.launches.count
            out[mode] = eng.execute(query, timeout=120)["entities"]
            assert gb.launches.count > k1
            if mode == "cost":
                assert pp.launches.count > k2
                assert eng.dispatch_stats()["device"]["fused_segments"] > 0
        finally:
            eng.shutdown()
    for eid in out["native"]:
        np.testing.assert_allclose(out["cost"][eid], out["native"][eid],
                                   atol=1e-4, rtol=0)


def _ssd_inputs(seed, B, T, H, P, G, N, device, dtype=torch.float32):
    """x ~ N(0,1), dt = softplus(N(0,1)) / 2, A = -exp(0.3 N), B, C ~
    0.5 N, D = |0.1 N|, h0 ~ 0.1 N (the JAX package's kernel-test
    inputs), drawn with numpy."""
    rng = np.random.default_rng(seed)

    def n(shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(device)

    x = n((B, T, H, P)).to(dtype)
    dt = torch.nn.functional.softplus(n((B, T, H))) * 0.5
    A = -torch.exp(n((H,), 0.3))
    Bm, Cm = n((B, T, G, N), 0.5).to(dtype), n((B, T, G, N), 0.5).to(dtype)
    return x, dt, A, Bm, Cm, n((H,), 0.1).abs(), n((B, H, P, N), 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,P,G,N,chunk", [
    (2, 100, 4, 16, 2, 8, 32), (1, 64, 2, 8, 1, 16, 16),
    (16, 3, 80, 64, 1, 64, 128),        # the model UDF's 3-token prompts
    (2, 300, 16, 64, 4, 64, 128),       # G > 1, ragged tail
    (2, 512, 80, 64, 1, 64, 128), (1, 77, 3, 40, 3, 24, 64)])
def test_ssd_kernel_matches_plain(cuda, B, T, H, P, G, N, chunk):
    from repro_torch.kernels.mamba2_ssd import launches, mamba2_ssd_cuda
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(T + N, B, T, H, P, G, N, cuda)
    before = launches.count
    y, h = mamba2_ssd_cuda(x, dt, A, Bm, Cm, D, h0, chunk=chunk)
    y_p, h_p = ref.mamba2_ssd_chunked(x, dt, A, Bm, Cm, D, h0,
                                      chunk=min(chunk, max(T, 8)))
    torch.cuda.synchronize()
    assert launches.count == before + 1
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert float((y - y_p).abs().max()) <= SSD_TOL
    assert float((h - h_p).abs().max()) <= SSD_TOL
    # no state and no D, through the public wrapper
    y, h = ops.mamba2_ssd(x, dt, A, Bm, Cm, chunk=chunk)
    y_p, h_p = ref.mamba2_ssd_chunked(x, dt, A, Bm, Cm,
                                      chunk=min(chunk, max(T, 8)))
    assert float((y - y_p).abs().max()) <= SSD_TOL
    assert float((h - h_p).abs().max()) <= SSD_TOL


@pytest.mark.cuda
def test_ssd_kernel_bf16_and_strided_operands(cuda):
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_cuda
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(5, 4, 200, 8, 64, 2, 64, cuda,
                                          torch.bfloat16)
    y, h = mamba2_ssd_cuda(x, dt, A, Bm, Cm, D, h0)
    y_p, h_p = ref.mamba2_ssd_chunked(x, dt, A, Bm, Cm, D, h0)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), y_p.float(), atol=SSD_BF16_ATOL,
                               rtol=SSD_BF16_RTOL)
    torch.testing.assert_close(h, h_p, atol=SSD_BF16_ATOL, rtol=SSD_BF16_RTOL)
    # x, B and C as the model passes them: slices of one packed tensor
    Bsz, T, H, P, G, N = 2, 130, 8, 64, 1, 64
    xs, dt, A, Bm, Cm, D, h0 = _ssd_inputs(6, Bsz, T, H, P, G, N, cuda)
    packed = torch.cat([xs.reshape(Bsz, T, H * P), Bm.reshape(Bsz, T, N),
                        Cm.reshape(Bsz, T, N)], dim=-1)
    xv, bv, cv = torch.split(packed, [H * P, N, N], dim=-1)
    xv, bv, cv = (xv.reshape(Bsz, T, H, P), bv.reshape(Bsz, T, G, N),
                  cv.reshape(Bsz, T, G, N))
    assert not xv.is_contiguous()
    y, h = mamba2_ssd_cuda(xv, dt, A, bv, cv, D, h0)
    y_p, h_p = ref.mamba2_ssd_chunked(xs, dt, A, Bm, Cm, D, h0)
    assert float((y - y_p).abs().max()) <= SSD_TOL
    assert float((h - h_p).abs().max()) <= SSD_TOL


@pytest.mark.cuda
def test_reduced_zamba2_on_the_card_goes_through_the_kernel(cuda):
    """Prefill + decode of reduced zamba2 on the card launches the SSD
    kernel once per Mamba2 layer and agrees with the same model on the
    host; the three model-UDF routes stamp identical images."""
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.core.udf import register_model_udf
    from repro_torch.distributed.sharding import REPLICATED
    from repro_torch.kernels.mamba2_ssd import launches
    from repro_torch.models import get_model
    from repro_torch.models.lm import tree_map
    cfg = get_arch("zamba2-2.7b", reduced=True)
    api = get_model(cfg)
    host = api.init(torch.Generator().manual_seed(0))
    card = tree_map(lambda a: a.to(cuda), host)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32))
    before = launches.count
    lg, cache = api.prefill(card, {"tokens": toks.to(cuda)}, REPLICATED, 24)
    assert launches.count - before == cfg.num_layers
    lg, _ = api.decode_step(card, toks[:, -1:].to(cuda), cache, 20,
                            REPLICATED)
    lh, hcache = api.prefill(host, {"tokens": toks}, REPLICATED, 24)
    lh, _ = api.decode_step(host, toks[:, -1:], hcache, 20, REPLICATED)
    assert float((lg.cpu() - lh).abs().max()) <= 3e-4

    register_model_udf("cuda_lm", arch="zamba2-2.7b", reduced=True,
                       params=card)
    pinned = {"cuda_lm": {"batcher": 1e-6, "native": 10.0, "remote": 10.0}}
    on_device = {"cuda_lm": {"device": 1e-6, "native": 10.0, "remote": 10.0,
                             "batcher": 10.0}}
    query = [{"FindImage": {"constraints": {"category": ["==", "m"]},
                            "operations": [{"type": "udf",
                                            "options": {"id": "cuda_lm"}}]}}]
    out = {}
    for arm, kw in (("per_entity", dict(dispatch="native")),
                    ("batcher", dict(dispatch="cost", cost_overrides=pinned)),
                    ("device", dict(dispatch="cost", device_backend=True,
                                    cost_overrides=on_device))):
        eng = VDMSAsyncEngine(device="cuda", **kw)
        try:
            rng = np.random.default_rng(3)
            for i in range(4):
                eng.add_entity("image", rng.uniform(0, 1, (32, 32, 3)).astype(
                    np.float32), {"category": "m"})
            before = launches.count
            res = eng.execute(query, timeout=300)
            assert launches.count > before
        finally:
            eng.shutdown()
        assert res["stats"]["failed"] == 0
        out[arm] = res["entities"]
    for eid in out["per_entity"]:
        for arm in ("batcher", "device"):
            np.testing.assert_array_equal(out[arm][eid],
                                          out["per_entity"][eid])


def _wkv_inputs(seed, B, T, H, K, device, dtype=torch.float32, shift=0.0):
    """r, k ~ 0.5 N, v ~ N, u ~ 0.1 N, s0 ~ 0.1 N, and the model's decay
    w = exp(-exp(-4 + shift + N(0, 1))), drawn with numpy."""
    rng = np.random.default_rng(seed)

    def n(shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(device)

    r, k, v = n((B, T, H, K), 0.5), n((B, T, H, K), 0.5), n((B, T, H, K))
    w = torch.exp(-torch.exp(-4.0 + shift + n((B, T, H, K))))
    return (r.to(dtype), k.to(dtype), v.to(dtype), w, n((H, K), 0.1),
            n((B, H, K, K), 0.1))


# lengths on both sides of the kernel's 16-step sub-chunks, at the model's
# decays and at log w about -8 a step (against the sequential scan, where
# a factored decay that overflows would show), in float32 and bfloat16
_EDGES = [(2, T, 4, 64, dtype, shift) for T in (1, 16, 17, 31, 33, 65)
          for dtype, shift in ((torch.float32, 0.0), (torch.float32, 6.08),
                               (torch.bfloat16, 0.0))]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,K,dtype,shift", [
    (16, 512, 32, 64, torch.float32, 0.0),     # model_serve's prefill
    (16, 512, 32, 64, torch.bfloat16, 0.0),
    (8, 3, 32, 64, torch.float32, 0.0),        # the model UDF's prompts
    (2, 100, 3, 16, torch.float32, 0.0),       # ragged tail
    (2, 200, 4, 64, torch.float32, 6.08),      # log w about -8 a step
    (16, 40, 66, 64, torch.float32, 0.0),      # 1,056 CTAs: over one wave
    (3, 37, 5, 40, torch.float32, 0.0),        # K = V = 40: partial tiles
] + _EDGES)
def test_wkv_kernel_matches_plain(cuda, B, T, H, K, dtype, shift):
    from repro_torch.kernels.rwkv6_scan import launches, rwkv6_scan_cuda
    r, k, v, w, u, s0 = _wkv_inputs(T + K, B, T, H, K, cuda, dtype, shift)
    before = launches.count
    y, s = rwkv6_scan_cuda(r, k, v, w, u, s0)
    plain = ref.rwkv6_scan_ref if shift else ref.rwkv6_chunked
    y_p, s_p = plain(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert launches.count == before + 1
    assert y.dtype == dtype and s.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())
    _wkv_close(y, y_p)
    _wkv_close(s, s_p)
    # no state, through the public wrapper, and two calls carrying it
    y, s = ops.rwkv6_scan(r, k, v, w, u)
    y_p, s_p = plain(r, k, v, w, u)
    _wkv_close(y, y_p)
    _wkv_close(s, s_p)
    half = T // 2 or 1
    y1, s1 = ops.rwkv6_scan(r[:, :half], k[:, :half], v[:, :half],
                            w[:, :half], u)
    y2, s2 = ops.rwkv6_scan(r[:, half:], k[:, half:], v[:, half:],
                            w[:, half:], u, s1)
    _wkv_close(torch.cat([y1, y2], 1), y)
    _wkv_close(s2, s)


def _wkv_close(got, want):
    if got.dtype == torch.float32:
        assert float((got - want.float()).abs().max()) <= WKV_TOL
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=SSD_BF16_ATOL, rtol=SSD_BF16_RTOL)


def _attn(seed, B, Sq, Sk, H, Hkv, D, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(device).to(dtype)
                 for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,q_offset,causal,dtype", [
    (2, 128, 128, 4, 2, 32, 0, True, torch.float32),     # GQA
    (2, 64, 192, 6, 2, 32, 0, False, torch.float32),     # not causal
    (1, 100, 100, 2, 1, 64, 0, True, torch.float32),     # ragged
    (2, 40, 130, 4, 2, 16, 17, True, torch.float32),     # q_offset
    (1, 512, 4113, 16, 8, 128, 3584, True, torch.float32),
    (2, 1100, 1105, 16, 8, 128, 0, True, torch.bfloat16),
    # whisper-small's encoder over 1,500 frames and its cross-attention
    # of 32 decoder rows against them (neither causal, partial tiles),
    # and granite-moe-1b-a400m past 1024 slots (GQA 16/8 at D 64)
    (16, 1500, 1500, 12, 12, 64, 0, False, torch.float32),
    (16, 32, 1500, 12, 12, 64, 0, False, torch.float32),
    (2, 1536, 1553, 16, 8, 64, 0, True, torch.float32),
])
def test_flash_kernel_matches_plain(cuda, B, Sq, Sk, H, Hkv, D, q_offset,
                                    causal, dtype):
    from repro_torch.kernels import flash_vjp
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     launches)
    q, k, v = _attn(Sq + Sk, B, Sq, Sk, H, Hkv, D, cuda, dtype)
    before = launches.count
    out, lse = flash_attention_cuda(q, k, v, q_offset=q_offset,
                                    causal=causal)
    out_p, lse_p = ref.flash_attention_chunked(q, k, v, causal=causal,
                                               q_offset=q_offset)
    torch.cuda.synchronize()
    assert launches.count == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(out, out_p, atol=FLASH_TOL, rtol=0)
    else:
        torch.testing.assert_close(out.float(), out_p.float(),
                                   atol=FLASH_BF16_ATOL, rtol=FLASH_BF16_RTOL)
    assert float((lse - lse_p).abs().max()) <= FLASH_LSE_TOL
    # the public routes launch the kernel too
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert launches.count == before + 2
    torch.testing.assert_close(got.float(), out.float(), atol=0, rtol=0)
    # under autograd the kernel runs through the recomputing backward's
    # Function; called bare it refuses, since its output has no grad_fn
    qg = q.detach().requires_grad_()
    got = flash_vjp.flash_attention(qg, k, v, q_offset, causal)
    assert launches.count == before + 3 and got.grad_fn is not None
    torch.testing.assert_close(got.float(), out.float(), atol=0, rtol=0)
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_attention_cuda(qg, k, v, q_offset=q_offset, causal=causal)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kernel,S", [("rwkv6-1.6b", "rwkv6_scan", 20),
                                           ("qwen3-0.6b", "flash_attention",
                                            1100)])
def test_reduced_model_on_the_card_goes_through_its_kernel(cuda, arch,
                                                           kernel, S):
    """Prefill + decode of a reduced rwkv6 (the WKV6 kernel in every
    layer) and of a reduced qwen3 beyond 1024 positions (the flash kernel
    in every layer) on the card agree with the same model on the host,
    and ``model_serve.run`` on the card launches the kernel."""
    import importlib
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import REPLICATED
    from repro_torch.launch.model_serve import run
    from repro_torch.models import get_model
    from repro_torch.models.lm import tree_map
    launches = importlib.import_module(f"repro_torch.kernels.{kernel}").launches
    cfg = get_arch(arch, reduced=True)
    api = get_model(cfg)
    host = api.init(torch.Generator().manual_seed(0))
    card = tree_map(lambda a: a.to(cuda), host)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32))
    before = launches.count
    lg, cache = api.prefill(card, {"tokens": toks.to(cuda)}, REPLICATED,
                            S + 4)
    assert launches.count - before == cfg.num_layers
    lg, _ = api.decode_step(card, toks[:, -1:].to(cuda), cache, S,
                            REPLICATED)
    lh, hcache = api.prefill(host, {"tokens": toks}, REPLICATED, S + 4)
    lh, _ = api.decode_step(host, toks[:, -1:], hcache, S, REPLICATED)
    assert float((lg.cpu() - lh).abs().max()) <= 3e-4
    full, _ = api.forward(card, {"tokens": toks.to(cuda)}, REPLICATED)
    fh, _ = api.forward(host, {"tokens": toks}, REPLICATED)
    assert float((full.cpu() - fh).abs().max()) <= 3e-4
    before = launches.count
    out = run(arch, reduced=True, requests=2, prompt_len=S, gen=2)
    assert launches.count > before
    assert out["generated"].shape == (2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,S,replace,flash_per_prefill", [
    ("granite-moe-1b-a400m", 1030, {}, "decoder"),
    ("whisper-small", 24, {"encoder_seq_len": 1100}, "encoder+decoder"),
    ("internvl2-1b", 1030, {}, "decoder"),
])
def test_reduced_moe_encdec_and_vlm_on_the_card(cuda, arch, S, replace,
                                                 flash_per_prefill):
    """Reduced granite-moe and internvl2 beyond 1024 positions (K3
    causal in every layer of a prefill), and reduced whisper over 1,100
    frames (K3 not causal in every encoder layer and every decoder
    cross-attention): prefill + a decode step on the card agree with the
    same model on the host; ``model_serve.run`` on the card launches K3
    where its route calls for it (whisper's reduced 32 frames take the
    plain route, granite's and internvl2's prompts here go past 1024
    slots)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import REPLICATED
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.model_serve import run
    from repro_torch.models import get_model
    from repro_torch.models.lm import tree_map
    from repro_torch.models.registry import token_start
    cfg = get_arch(arch, reduced=True).replace(**replace)
    api = get_model(cfg)
    host = api.init(torch.Generator().manual_seed(0))
    card = tree_map(lambda a: a.to(cuda), host)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32))}
    P = token_start(cfg)
    if P:
        batch["patch_embeds"] = torch.from_numpy((rng.standard_normal(
            (2, P, cfg.d_model)) * 0.1).astype(np.float32))
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy((rng.standard_normal(
            (2, cfg.encoder_seq_len, cfg.d_model)) * 0.1).astype(np.float32))
    want = cfg.num_layers + (cfg.num_encoder_layers
                             if flash_per_prefill == "encoder+decoder" else 0)
    before = fa.launches.count
    lg, cache = api.prefill(card, {k: v.to(cuda) for k, v in batch.items()},
                            REPLICATED, P + S + 4)
    assert fa.launches.count - before == want
    step = batch["tokens"][:, -1:]
    lg, _ = api.decode_step(card, step.to(cuda), cache, P + S, REPLICATED)
    lh, hcache = api.prefill(host, batch, REPLICATED, P + S + 4)
    lh, _ = api.decode_step(host, step, hcache, P + S, REPLICATED)
    assert float((lg.cpu() - lh).abs().max()) <= 3e-4
    before = fa.launches.count
    out = run(arch, reduced=True, requests=2, prompt_len=S, gen=2)
    assert (fa.launches.count > before) == (flash_per_prefill == "decoder")
    assert out["generated"].shape == (2, 2)


@pytest.mark.cuda
def test_reduced_zamba2_at_head_dim_80_beyond_1024_slots_on_the_card(cuda):
    """Reduced zamba2 with the full model's attention head dim (80):
    prefill into a cache of more than 1024 slots and a decode step on
    the card go through K3 at D = 80 (by launch count) and agree with
    the same model on the host."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import REPLICATED
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.models import get_model
    from repro_torch.models.lm import tree_map
    cfg = get_arch("zamba2-2.7b", reduced=True).replace(head_dim=80)
    api = get_model(cfg)
    host = api.init(torch.Generator().manual_seed(0))
    card = tree_map(lambda a: a.to(cuda), host)
    S = 1100
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32))
    before = fa.launches.count, ssd.launches.count
    lg, cache = api.prefill(card, {"tokens": toks.to(cuda)}, REPLICATED,
                            S + 4)
    assert fa.launches.count > before[0] and ssd.launches.count > before[1]
    lg, _ = api.decode_step(card, toks[:, -1:].to(cuda), cache, S,
                            REPLICATED)
    lh, hcache = api.prefill(host, {"tokens": toks}, REPLICATED, S + 4)
    lh, _ = api.decode_step(host, toks[:, -1:], hcache, S, REPLICATED)
    assert float((lg.cpu() - lh).abs().max()) <= 3e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32-mma.sync-3xTF32", "bf16-wgmma"])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,q_offset,causal", [
    (1, 130, 130, 8, 8, 16, 0, True),      # D 16, group 1, 130 rows
    (2, 130, 130, 4, 2, 32, 0, True),      # D 32, group 2
    (1, 130, 130, 8, 1, 64, 0, True),      # D 64, group 8
    (1, 130, 130, 16, 2, 128, 0, True),    # D 128, group 8
    (2, 1, 40, 4, 2, 64, 39, True),        # one row at the end of 40 keys
    (1, 40, 40, 2, 1, 128, 0, True),       # fewer keys than one tile
    (1, 130, 40, 4, 4, 32, 0, False),      # the same, not causal
    (2, 77, 200, 8, 4, 128, 123, True),    # q_offset, ragged rows
    (1, 130, 130, 8, 2, 80, 0, True),      # D 80 (zamba2), group 4
    (2, 77, 200, 8, 4, 80, 123, True),     # D 80, q_offset, ragged rows
    (1, 130, 40, 4, 4, 80, 0, False),      # D 80, not causal
    (1, 1100, 1105, 4, 2, 80, 0, True),    # D 80 beyond 1024 positions
])
def test_flash_kernel_tilings(cuda, dtype, B, Sq, Sk, H, Hkv, D, q_offset,
                              causal):
    """Both routes of K3 at every head size, group sizes 1, 2 and 8, row
    counts that are no multiple of either q tile (64 f32, 128 bf16), key
    counts shorter than one key tile, and an offset that puts the causal
    edge inside a tile: the masks work in each accumulator layout."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     launches)
    q, k, v = _attn(Sq * D + Sk, B, Sq, Sk, H, Hkv, D, cuda, dtype)
    before = launches.count
    out, lse = flash_attention_cuda(q, k, v, q_offset=q_offset,
                                    causal=causal)
    out_p, lse_p = ref.flash_attention_chunked(q, k, v, causal=causal,
                                               q_offset=q_offset)
    torch.cuda.synchronize()
    assert launches.count == before + 1
    assert bool(torch.isfinite(out.float()).all())
    if dtype == torch.float32:
        torch.testing.assert_close(out, out_p, atol=FLASH_TOL, rtol=0)
    else:
        torch.testing.assert_close(out.float(), out_p.float(),
                                   atol=FLASH_BF16_ATOL, rtol=FLASH_BF16_RTOL)
    assert float((lse - lse_p).abs().max()) <= FLASH_LSE_TOL


@pytest.mark.cuda
def test_flash_kernel_reads_aligned_slices_in_place(cuda):
    """q, k and v as slices of one packed qkv projection go in uncopied
    (16-byte aligned strides); a slice one value off is copied first."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    B, S, H, Hkv, D = 2, 150, 8, 2, 64
    for dtype in (torch.float32, torch.bfloat16):
        for extra in (0, 1):
            rng = np.random.default_rng(extra)
            packed = torch.from_numpy(rng.standard_normal(
                (B, S, (H + 2 * Hkv) * D + extra)).astype(np.float32)).to(
                    cuda).to(dtype)
            q, k, v = torch.split(packed[..., extra:],
                                  [H * D, Hkv * D, Hkv * D], dim=-1)
            q, k, v = (q.reshape(B, S, H, D), k.reshape(B, S, Hkv, D),
                       v.reshape(B, S, Hkv, D))
            assert (_build.strided(k, D).data_ptr() == k.data_ptr()) \
                == (extra == 0)
            out, lse = flash_attention_cuda(q, k, v)
            out_p, lse_p = ref.flash_attention_chunked(q, k, v)
            if dtype == torch.float32:
                torch.testing.assert_close(out, out_p, atol=FLASH_TOL, rtol=0)
            else:
                torch.testing.assert_close(out.float(), out_p.float(),
                                           atol=FLASH_BF16_ATOL,
                                           rtol=FLASH_BF16_RTOL)
            assert float((lse - lse_p).abs().max()) <= FLASH_LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,P,G,N,chunk,dtype", [
    (2, 100, 4, 16, 2, 8, 16, torch.float32),     # chunk 16, ragged tail
    (1, 77, 3, 40, 3, 24, 32, torch.float32),     # P 40, N 24, chunk 32
    (2, 150, 8, 64, 8, 64, 64, torch.float32),    # G 8, chunk 64, ragged
    (2, 300, 16, 64, 4, 64, 128, torch.float32),  # chunk 128, ragged
    (4, 3, 8, 64, 1, 64, 128, torch.float32),     # T 3
    (1, 50, 2, 12, 1, 6, 16, torch.float32),      # rows of 24 bytes: no
                                                  # 16-byte copies
    (2, 150, 8, 64, 8, 64, 64, torch.bfloat16),
    (1, 77, 3, 40, 3, 24, 32, torch.bfloat16),
    (4, 3, 8, 64, 1, 64, 128, torch.bfloat16),
])
def test_ssd_kernel_tilings(cuda, B, T, H, P, G, N, chunk, dtype):
    """K4's tiles of up to 32 steps under every chunk the wrapper takes,
    grouped B/C, P and N that are no multiple of 16, and bf16 inputs
    (exact in TF32: C Bᵀ in one pass)."""
    from repro_torch.kernels.mamba2_ssd import launches, mamba2_ssd_cuda
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(T + P + N, B, T, H, P, G, N, cuda,
                                          dtype)
    before = launches.count
    y, h = mamba2_ssd_cuda(x, dt, A, Bm, Cm, D, h0, chunk=chunk)
    y_p, h_p = ref.mamba2_ssd_chunked(x, dt, A, Bm, Cm, D, h0,
                                      chunk=min(chunk, max(T, 8)))
    torch.cuda.synchronize()
    assert launches.count == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    if dtype == torch.float32:
        assert float((y - y_p).abs().max()) <= SSD_TOL
        assert float((h - h_p).abs().max()) <= SSD_TOL
    else:
        torch.testing.assert_close(y.float(), y_p.float(), atol=SSD_BF16_ATOL,
                                   rtol=SSD_BF16_RTOL)
        torch.testing.assert_close(h, h_p, atol=SSD_BF16_ATOL,
                                   rtol=SSD_BF16_RTOL)


@pytest.mark.cuda
def test_ssd_kernel_bf16_strided_slices(cuda):
    """bf16 x, B and C as slices of one packed in-projection, read in
    place, against the plain version on the same slices."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_cuda
    Bsz, T, H, P, G, N = 2, 130, 8, 64, 1, 64
    xs, dt, A, Bm, Cm, D, h0 = _ssd_inputs(7, Bsz, T, H, P, G, N, cuda,
                                           torch.bfloat16)
    packed = torch.cat([xs.reshape(Bsz, T, H * P), Bm.reshape(Bsz, T, N),
                        Cm.reshape(Bsz, T, N)], dim=-1)
    xv, bv, cv = torch.split(packed, [H * P, N, N], dim=-1)
    xv, bv, cv = (xv.reshape(Bsz, T, H, P), bv.reshape(Bsz, T, G, N),
                  cv.reshape(Bsz, T, G, N))
    assert not xv.is_contiguous()
    assert _build.strided(xv, P).data_ptr() == xv.data_ptr()
    y, h = mamba2_ssd_cuda(xv, dt, A, bv, cv, D, h0)
    y_p, h_p = ref.mamba2_ssd_chunked(xs, dt, A, Bm, Cm, D, h0)
    torch.testing.assert_close(y.float(), y_p.float(), atol=SSD_BF16_ATOL,
                               rtol=SSD_BF16_RTOL)
    torch.testing.assert_close(h, h_p, atol=SSD_BF16_ATOL, rtol=SSD_BF16_RTOL)


# ------------------------------------- the scale-out path on the card
DEVICE_PIPE = [{"type": "resize", "width": 64, "height": 64},
               {"type": "crop", "x": 8, "y": 8, "width": 48, "height": 48},
               {"type": "normalize", "mean": 0.45, "std": 0.22},
               {"type": "blur", "ksize": 9, "sigma_x": 2.0}]
DEVICE_PINNED = {o["type"]: {"device": 1e-6, "native": 10.0, "remote": 10.0,
                             "batcher": 10.0} for o in DEVICE_PIPE}


def _faces(eng, n, size=72, category="d"):
    for i in range(n):
        img = np.random.default_rng(i).uniform(
            0, 1, (size, size, 3)).astype(np.float32)
        eng.add_entity("image", img, {"category": category, "idx": i})


def _query(ops, category="d"):
    return [{"FindImage": {"constraints": {"category": ["==", category]},
                           "operations": ops}}]


@pytest.mark.cuda
def test_sharded_device_chain_on_the_card_equals_one_engine(cuda):
    """A 2-shard cluster, each shard with its own device backend, runs
    the resize → crop → normalize → blur chain through K2 and K1 and
    answers what one CUDA engine answers (1e-4)."""
    from repro_torch.cluster import ShardedEngine
    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.kernels import gaussian_blur as gb
    kw = dict(device="cuda", dispatch="cost", device_backend=True,
              cost_overrides=DEVICE_PINNED)
    out = {}
    for name, make in (("cluster", lambda: ShardedEngine(num_shards=2, **kw)),
                       ("engine", lambda: VDMSAsyncEngine(**kw))):
        eng = make()
        try:
            _faces(eng, 10)
            k1, k2 = gb.launches.count, pp.launches.count
            out[name] = eng.execute(_query(DEVICE_PIPE), timeout=120)
            assert gb.launches.count > k1 and pp.launches.count > k2
        finally:
            eng.shutdown()
    assert list(out["cluster"]["entities"]) == list(out["engine"]["entities"])
    assert out["cluster"]["stats"]["failed"] == 0
    for eid, arr in out["engine"]["entities"].items():
        np.testing.assert_allclose(out["cluster"]["entities"][eid], arr,
                                   atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_wire_frontend_in_front_of_a_cuda_engine(cuda):
    """Over a real socket the wire answers what ``execute`` answers, and
    every streamed entity frame carries the entity's response bytes."""
    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.serving.frontend import WireClient, WireFrontend
    from repro_torch.serving.wire import from_jsonable
    eng = VDMSAsyncEngine(device="cuda", num_remote_servers=2)
    try:
        _faces(eng, 6, size=40)
        q = _query([{"type": "blur", "ksize": 5, "sigma_x": 1.5},
                    {"type": "remote", "url": "u", "options": {"id": "flip"}}])
        want = eng.execute(q, timeout=120)
        front = WireFrontend(eng).start()
        try:
            with WireClient(front.address) as c:
                fut = c.submit(q)
                got = fut.result(120)
        finally:
            front.close()
    finally:
        eng.shutdown()
    assert list(got["entities"]) == list(want["entities"])
    for eid, arr in want["entities"].items():
        assert got["entities"][eid].dtype == arr.dtype
        assert np.array_equal(got["entities"][eid], arr)
    streamed = {p["eid"]: from_jsonable(p["data"])
                for e, p in fut.frames if e == "entity"}
    assert sorted(streamed) == sorted(want["entities"])
    for eid, arr in streamed.items():
        assert np.array_equal(arr, want["entities"][eid])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(), (3,), (2, 5, 3)])
def test_wire_codes_a_cuda_tensor_through_the_host(cuda, shape):
    from repro_torch.core.boundary import to_host
    from repro_torch.serving.wire import from_jsonable, to_jsonable
    t = _uniform(0, shape, cuda)
    assert to_jsonable(t) == to_jsonable(to_host(t))
    assert to_jsonable({"a": [t]}) == {"a": [to_jsonable(to_host(t))]}
    back = from_jsonable(to_jsonable(t))
    assert back.shape == shape and np.array_equal(back, to_host(t))


@pytest.mark.cuda
def test_the_way_out_copies_a_group_still_being_written(cuda):
    """The boundary's way out on a 256-image group that queued kernels
    are still writing: ``to_host_many`` orders its pinned copies after
    them and gives the per-entity ``to_host`` arrays, bit for bit.  The
    group (154 MB) is cut into two stacks under ``OUT_COPY_BYTES``; a CPU
    tensor of the same shape is a run of its own."""
    from repro_torch.core.boundary import OUT_COPY_BYTES, to_host, to_host_many
    src = _uniform(0, (256, 224, 224, 3), cuda)
    group = torch.zeros_like(src)
    on_host = src[0].cpu()
    torch.cuda.synchronize()
    group.copy_(src)
    for _ in range(1000):       # ≈ 0.1 s of device work, queued in ≈ 10 ms
        group.add_(0.5)
    datas = [group[i] for i in range(256)] + [on_host]
    assert not torch.cuda.current_stream().query()
    got, copies = to_host_many(datas)
    want = [to_host(d) for d in datas]
    assert copies == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    assert got[7].min() >= 500.0
    assert torch.from_numpy(got[0]).is_pinned()
    assert got[0].base is not got[255].base
    assert max(got[0].base.nbytes, got[255].base.nbytes) <= OUT_COPY_BYTES


@pytest.mark.cuda
def test_executors_on_the_card_agree_with_the_engine_on_iq3(cuda):
    """IQ3 (a remote blur): the sync, pooled and frame executors on the
    card answer what the engine on the card answers, bit for bit (the
    same kernel on the same images), and each launches the blur kernel."""
    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.core.entity import Entity
    from repro_torch.core.executors import (FrameExecutor, PooledExecutor,
                                            SyncExecutor)
    from repro_torch.core.pipeline import parse_operations
    from repro_torch.core.remote import RemoteServerPool, TransportModel
    from repro_torch.kernels import gaussian_blur as gb
    fast = TransportModel(network_latency_s=0.001, service_time_s=0.002)
    iq3 = [{"type": "remote", "url": "u",
            "options": {"id": "blur", "ksize": 5, "sigma_x": 1.5}}]
    imgs = [np.random.default_rng(i).uniform(0, 1, (64, 64, 3))
            .astype(np.float32) for i in range(6)]
    eng = VDMSAsyncEngine(device="cuda", num_remote_servers=2, transport=fast)
    try:
        eids = [eng.add_entity("image", img, {"category": "iq3"})
                for img in imgs]
        res = eng.execute(_query(iq3, "iq3"), timeout=120)
    finally:
        eng.shutdown()
    pool = RemoteServerPool(2, fast)
    try:
        for ex in (SyncExecutor(pool, device="cuda"),
                   PooledExecutor(pool, workers=3, device="cuda"),
                   FrameExecutor(pool, workers=2, device="cuda")):
            ents = [Entity(str(i), "image", img.copy(),
                           ops=parse_operations(iq3))
                    for i, img in enumerate(imgs)]
            k1 = gb.launches.count
            ex.run(ents)
            assert gb.launches.count - k1 >= len(imgs), type(ex).__name__
            for eid, ent in zip(eids, ents):
                assert isinstance(ent.data, np.ndarray)
                assert np.array_equal(ent.data, res["entities"][eid])
    finally:
        pool.shutdown()


# ------------------------------------------------------------- training
@pytest.mark.cuda
def test_kernels_without_a_backward_refuse_a_gradient(cuda):
    """K1, K2, K4 and K5 have no backward on the card: an input that
    requires a gradient, with grad mode on, raises rather than return an
    output with no grad_fn; under ``torch.no_grad`` they run."""
    from repro_torch.kernels.gaussian_blur import gaussian_blur_cuda
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_cuda
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda
    img = torch.rand(1, 16, 16, 3, device=cuda, requires_grad=True)
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(0, 1, 16, 2, 16, 1, 16, cuda)
    r, k, v, w, u, s0 = _wkv_inputs(0, 1, 16, 2, 16, cuda)
    calls = {
        "gaussian_blur": lambda: gaussian_blur_cuda(img, 5, 1.5),
        "fused_resize_crop_normalize": lambda: pp.fused_resize_crop_normalize_cuda(
            img, resize_h=8, resize_w=8, crop_x=0, crop_y=0, crop_w=8,
            crop_h=8),
        "mamba2_ssd": lambda: mamba2_ssd_cuda(x.requires_grad_(), dt, A, Bm,
                                              Cm, D, h0),
        "rwkv6_scan": lambda: rwkv6_scan_cuda(r, k, v, w.requires_grad_(), u,
                                              s0),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match="no backward"):
            call()
        with torch.no_grad():
            call()
    # the public routes too: the same wrappers
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.gaussian_blur(img, 5, 1.5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-1.6b"])
def test_train_launcher_refuses_the_scan_families_on_the_card(cuda, arch):
    """No longer refused: the launcher trains the hybrid and rwkv
    families on the card, K4 or K5 forward and under remat beneath their
    Functions' backward; and one step from one state (the host's, copied
    to the card: the card's generator draws other numbers) agrees with
    the same step on the host in loss (1e-5 relative) and gradient norm
    (1e-4: float32 sums in other orders, the kernels' 3xTF32 products of
    about 22 bits)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import REPLICATED
    from repro_torch.kernels import mamba2_ssd, rwkv6_scan
    from repro_torch.launch import train
    from repro_torch.models import get_model
    from repro_torch.models.lm import tree_map
    from repro_torch.training import TrainConfig, make_train_step
    from repro_torch.training.train_step import init_train_state
    counter = (mamba2_ssd if arch == "zamba2-2.7b" else rwkv6_scan).launches
    cfg = get_arch(arch, reduced=True)
    before = counter.count
    run = train.run(arch, reduced=True, steps=2, batch=2, seq=24,
                    log_every=100)
    assert counter.count - before == 2 * 2 * cfg.num_layers  # fwd + remat
    assert np.isfinite(run["losses"]).all()
    api = get_model(cfg)
    step = make_train_step(api, TrainConfig(
        compute_dtype="float32", grad_reduce_dtype="float32"), REPLICATED)
    host = init_train_state(api, torch.Generator().manual_seed(0))
    card = tree_map(lambda a: a.to(cuda, copy=True), host)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    card, mc = step(card, {"tokens": toks.to(cuda)})
    host, mh = step(host, {"tokens": toks})
    np.testing.assert_allclose(float(mc["loss"]), float(mh["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mc["grad_norm"]),
                               float(mh["grad_norm"]), rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype,with_state", [
    ("ssd", torch.float32, False), ("ssd", torch.float32, True),
    ("ssd", torch.bfloat16, False), ("wkv", torch.float32, False),
    ("wkv", torch.float32, True), ("wkv", torch.bfloat16, False)])
def test_scan_functions_hold_autograd_through_the_plain_form(cuda, kind,
                                                             dtype,
                                                             with_state):
    """K4's and K5's Functions on the card: the forward is the kernel
    (one launch, output within the kernel's own tolerance of the plain
    version); the backward launches the scan's backward kernel once; both
    equal autograd through the plain chunked form on
    the same tensors (1e-5 of each gradient's largest magnitude; a
    bfloat16 gradient one bfloat16 step, 2^-7 relative, beyond that),
    each gradient in its input's dtype.  SSD's reference runs on float32
    copies and rounds each gradient once: the plain forward casts a
    bfloat16 x once a use, so autograd through it rounds dx twice, where
    the backward kernel rounds once."""
    from repro_torch.kernels import mamba2_ssd, rwkv6_scan
    if kind == "ssd":
        x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(7, 2, 300, 8, 64, 2, 64, cuda,
                                              dtype)
        inputs = [x, dt, A, Bm, Cm, D] + ([h0] if with_state else [])
        counter = mamba2_ssd.launches

        def fn(*t):
            return mamba2_ssd.mamba2_ssd(*t)

        def plain(*t):
            return ref.mamba2_ssd_chunked(*t)
        tol = (SSD_TOL, 0.0) if dtype == torch.float32 else (SSD_BF16_ATOL,
                                                             SSD_BF16_RTOL)
    else:
        r, k, v, w, u, s0 = _wkv_inputs(7, 2, 300, 8, 64, cuda, dtype)
        inputs = [r, k, v, w, u] + ([s0] if with_state else [])
        counter = rwkv6_scan.launches
        fn, plain = rwkv6_scan.rwkv6_scan, ref.rwkv6_chunked
        tol = (WKV_TOL, 0.0) if dtype == torch.float32 else (SSD_BF16_ATOL,
                                                             SSD_BF16_RTOL)
    rng = np.random.default_rng(8)
    dy = torch.from_numpy(rng.standard_normal(tuple(inputs[0].shape))
                          .astype(np.float32)).to(cuda, dtype)
    dh = torch.from_numpy(rng.standard_normal(
        (2, 8, 64, 64)).astype(np.float32)).to(cuda)

    def run(forward, wide=False):
        leaves = [(t.detach().float() if wide else t.detach())
                  .requires_grad_() for t in inputs]
        y, h = forward(*leaves)
        outs, cts = ([y, h], [dy, dh]) if with_state else ([y], [dy])
        grads = torch.autograd.grad(outs, leaves,
                                    [c.to(o.dtype) for c, o in zip(cts, outs)])
        return (y.detach().to(inputs[0].dtype),
                [g.to(t.dtype) for g, t in zip(grads, inputs)])

    before = counter.count
    backward_before = (mamba2_ssd.backward_launches.count,
                       rwkv6_scan.backward_launches.count)
    y, got = run(fn)
    assert counter.count == before + 1
    assert (mamba2_ssd.backward_launches.count,
            rwkv6_scan.backward_launches.count) == (
        backward_before[0] + (kind == "ssd"),
        backward_before[1] + (kind == "wkv"))
    y_p, want = run(plain, wide=kind == "ssd")
    assert counter.count == before + 1
    torch.testing.assert_close(y.float(), y_p.float(), atol=tol[0],
                               rtol=tol[1])
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == inputs[i].dtype
        top = float(w.float().abs().max())
        rtol = 2.0 ** -7 if g.dtype == torch.bfloat16 else 0.0
        torch.testing.assert_close(g.float(), w.float(), atol=1e-5 * top,
                                   rtol=rtol, msg=f"gradient {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,q_offset,causal,dtype", [
    (2, 1100, 1100, 4, 2, 128, 0, True, torch.float32),
    (1, 600, 1700, 4, 4, 64, 1100, True, torch.float32),
    (2, 300, 700, 6, 2, 32, 0, False, torch.float32),
    (1, 1100, 1100, 4, 4, 64, 0, True, torch.bfloat16),
    # zamba2's shared attention (D 80, MHA), qwen3's heads in bfloat16
    # (D 128, GQA 16/8), minicpm's (D 64, MHA), head dim 16
    (1, 700, 700, 4, 4, 80, 0, True, torch.float32),
    (1, 600, 600, 16, 8, 128, 0, True, torch.bfloat16),
    (2, 333, 333, 6, 6, 64, 0, True, torch.bfloat16),
    (2, 200, 200, 4, 1, 16, 0, True, torch.float32),
    # cross-attention: not causal, Sq != Sk, in bfloat16 and at D 80
    (2, 32, 300, 6, 6, 64, 0, False, torch.bfloat16),
    (1, 150, 70, 2, 2, 80, 0, False, torch.float32),
    # a prefill into a cache whose tail no query sees (q_offset + Sq <
    # Sk), with a q tile cut short; one query row, at an offset and at 0
    (1, 100, 1000, 4, 2, 64, 500, True, torch.float32),
    (1, 77, 900, 4, 4, 128, 400, True, torch.bfloat16),
    (2, 1, 300, 4, 2, 128, 299, True, torch.float32),
    (2, 1, 300, 4, 2, 64, 0, True, torch.bfloat16),
    # the bfloat16 route's edges: head dims 16, 32 and 80 (the 32- and
    # 64-byte swizzles, and 80 padded to 128 columns); Sq and Sk that no
    # TMA box divides, so boxes are cut short; causal offsets whose first
    # q tile starts inside a key block; four q heads a kv head at D 128
    (2, 200, 200, 4, 1, 16, 0, True, torch.bfloat16),
    (1, 333, 517, 6, 3, 32, 184, True, torch.bfloat16),
    (1, 700, 700, 4, 4, 80, 0, True, torch.bfloat16),
    (1, 150, 70, 2, 2, 80, 0, False, torch.bfloat16),
    (2, 77, 333, 4, 2, 64, 100, True, torch.bfloat16),
    (1, 130, 1000, 8, 2, 128, 437, True, torch.bfloat16),
    (1, 300, 300, 8, 2, 128, 0, True, torch.bfloat16),
    # the float32 route's edges (64-row tiles and pieces, head dims padded
    # to 32-column chunks): Sq and Sk that no piece divides at D 16, 32, 80
    # and 128; causal offsets whose first q tile starts inside a key
    # block; four q heads a kv head at D 128; one query row; cross-
    # attention, not causal
    (2, 77, 333, 4, 2, 16, 100, True, torch.float32),
    (1, 333, 517, 6, 3, 32, 184, True, torch.float32),
    (1, 130, 1000, 8, 2, 128, 437, True, torch.float32),
    (1, 300, 300, 8, 2, 128, 0, True, torch.float32),
    (2, 100, 100, 2, 2, 80, 37, True, torch.float32),
    (2, 1, 300, 4, 1, 80, 0, True, torch.float32),
    (2, 32, 300, 6, 6, 128, 0, False, torch.float32),
])
def test_flash_function_backward_on_the_card(cuda, B, Sq, Sk, H, Hkv, D,
                                             q_offset, causal, dtype):
    """The backward kernel over K3's output and log-sum-exp against
    autograd through the plain chunked forward, on the card: one launch
    of the forward kernel and one of the backward kernel, gradients in
    the inputs' dtype; dk and dv exactly 0 for keys no query sees.
    Float32: 2e-4, the reference's tolerance for its flash gradients;
    bfloat16: 2e-2 absolute and relative (its bfloat16 flash
    tolerance)."""
    from repro_torch.kernels import flash_vjp
    from repro_torch.kernels.flash_attention import (backward_launches,
                                                     launches)
    q, k, v = _attn(Sq + 7 * Sk, B, Sq, Sk, H, Hkv, D, cuda, dtype)
    do = _attn(1, B, Sq, Sq, H, H, D, cuda, dtype)[0]
    grads = []
    for route in ("kernel", "plain"):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        before = launches.count, backward_launches.count
        if route == "kernel":
            out = flash_vjp.flash_attention(*leaves, q_offset, causal)
            assert launches.count == before[0] + 1
        else:
            out = ref.flash_attention_chunked(*leaves, causal=causal,
                                              q_offset=q_offset)[0]
        out.backward(do)
        assert backward_launches.count == before[1] + (route == "kernel")
        grads.append([t.grad for t in leaves])
    if dtype == torch.bfloat16:
        # a bfloat16 decoder's queries against float32 encoder keys run
        # the kernel in float32, as the plain forward does
        mixed = flash_vjp.flash_attention(q, k.float(), v.float(), q_offset,
                                          causal)
        want = flash_vjp.flash_attention(q.float(), k.float(), v.float(),
                                         q_offset, causal)
        assert mixed.dtype == torch.bfloat16
        torch.testing.assert_close(mixed, want.to(torch.bfloat16), atol=0,
                                   rtol=0)
    seen = q_offset + Sq if causal else Sk
    for got, want in zip(*grads):
        assert got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=2e-4, rtol=0)
        else:
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                       rtol=2e-2)
    for got in grads[0][1:]:
        assert bool((got[:, seen:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["strided do", "bf16 q, f32 k and v"])
def test_flash_backward_kernel_takes_strided_do_and_mixed_dtypes(cuda, case):
    """The backward kernel's wrapper takes an output cotangent that is
    not contiguous (a slice, as autograd may hand it), and the Function
    runs a bfloat16 q against float32 k and v in float32, returning dq
    in bfloat16 and dk, dv in float32; both against autograd through
    the plain chunked forward on the same tensors."""
    from repro_torch.kernels import flash_vjp
    from repro_torch.kernels.flash_attention import backward_launches
    B, Sq, Sk, H, Hkv, D = 2, 300, 300, 4, 2, 64
    q, k, v = _attn(5, B, Sq, Sk, H, Hkv, D, cuda)
    wide = _attn(6, B, Sq, Sq, H, H, 2 * D, cuda)[0]
    do = wide[..., :D]
    assert not do.is_contiguous()
    if case != "strided do":
        q, do = q.to(torch.bfloat16), do.to(torch.bfloat16)
    grads = []
    for fn in (lambda *t: flash_vjp.flash_attention(*t),
               lambda *t: ref.flash_attention_chunked(*t)[0]):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        before = backward_launches.count
        fn(*leaves).backward(do)
        grads.append(([t.grad for t in leaves],
                      backward_launches.count - before))
    (got, n_kernel), (want, n_plain) = grads
    assert (n_kernel, n_plain) == (1, 0)
    assert [g.dtype for g in got] == [q.dtype, k.dtype, v.dtype]
    for g, w in zip(got, want):
        if g.dtype == torch.float32 and case == "strided do":
            torch.testing.assert_close(g, w, atol=2e-4, rtol=0)
        else:   # dq rounded to bfloat16; the output's rounding in delta
            torch.testing.assert_close(g.float(), w.float(), atol=2e-2,
                                       rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", [(64, torch.bfloat16),
                                     (128, torch.bfloat16),
                                     (64, torch.float32),
                                     (80, torch.float32)])
def test_flash_backward_bf16_reads_strided_operands(cuda, D, dtype):
    """Both routes step q, k, v and dO by their own sequence strides (the
    bfloat16 route's tensor maps, the float32 route's pre-pass): slices
    of packed projections (q, k and v of one (B, S, H + 2 Hkv, D) tensor,
    dO of a wider one) go in without a copy and give the gradients of
    their contiguous copies bit for bit, within the card's gradient
    tolerance of ``flash_backward`` (bfloat16 2e-2, float32 2e-4)."""
    from repro_torch.kernels import _build, flash_vjp
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_cuda)
    B, S, H, Hkv = 2, 300, 8, 2
    rng = np.random.default_rng(29)

    def n(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda).to(dtype)
    qkv = n((B, S, H + 2 * Hkv, D))
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:]
    do = n((B, S, H + 3, D))[:, :, :H]
    for t in (q, k, v, do):
        assert not t.is_contiguous() and _build.strided(t, D) is t
    out, lse = flash_attention_cuda(q, k, v, q_offset=37)
    got = flash_attention_backward_cuda(q, k, v, out, lse, do, q_offset=37)
    packed = [t.contiguous() for t in (q, k, v, do)]
    want = flash_attention_backward_cuda(*packed[:3], out, lse, packed[3],
                                         q_offset=37)
    plain = flash_vjp.flash_backward(*packed[:3], out, lse, packed[3],
                                     q_offset=37)
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w)
        if dtype == torch.float32:
            torch.testing.assert_close(g, p, atol=2e-4, rtol=0)
        else:
            torch.testing.assert_close(g.float(), p.float(), atol=2e-2,
                                       rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("D,Hkv,dtype", [(64, 36, torch.bfloat16),
                                         (128, 8, torch.bfloat16),
                                         (80, 4, torch.bfloat16),
                                         (64, 36, torch.float32),
                                         (128, 8, torch.float32),
                                         (80, 4, torch.float32)])
def test_flash_backward_bf16_launches_are_bit_equal(cuda, D, Hkv, dtype):
    """Two launches of the backward on the same tensors give the same dq,
    dk and dv bit for bit, in both routes: both passes sum in a fixed
    order and use no atomics (a resumed training step equals the straight
    run); the float32 route's pre-pass writes the same images."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_cuda)
    H = 36 if D == 64 else 16
    q, k, v = _attn(29, 1, 1100, 1100, H, Hkv, D, cuda, dtype)
    do = _attn(30, 1, 1100, 1100, H, H, D, cuda, dtype)[0]
    out, lse = flash_attention_cuda(q, k, v)
    first = flash_attention_backward_cuda(q, k, v, out, lse, do)
    second = flash_attention_backward_cuda(q, k, v, out, lse, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_backward_library_reports_the_mirrors_geometry(cuda):
    """The built backward library's fixed rows, walk rows and skipping
    unit of each route and head dim are the ones ``backward_walks`` and
    ``backward_tiles`` mirror (``bwd_fixed_rows``, ``bwd_walk_rows``,
    ``bwd_unit_rows``), and the scratch it takes is the one the wrapper
    allocates (``backward_scratch_floats``: the float32 route's images,
    the bfloat16 route's delta)."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    lib = _build.load("flash_attention_backward")
    for dtype in (torch.float32, torch.bfloat16):
        for D in fa.HEAD_DIMS:
            assert fa.backward_geometry(lib, D, dtype) == (
                fa.bwd_fixed_rows(dtype), fa.bwd_walk_rows(D, dtype),
                fa.bwd_unit_rows(dtype),
                fa.bwd_walk_rows(D, dtype, keys=False)), (dtype, D)
            for B, Sq, Sk, H, Hkv in ((2, 4096, 4096, 16, 8),
                                      (1, 1, 300, 4, 2), (3, 77, 900, 6, 3)):
                got = ctypes.c_longlong()
                assert lib.repro_flash_attention_backward_scratch(
                    fa._DTYPES[dtype], B, Sq, Sk, H, Hkv, D,
                    ctypes.byref(got)) == 0
                assert got.value == fa.backward_scratch_floats(
                    B, Sq, Sk, H, Hkv, D, dtype), (dtype, D, Sq, Sk)


@pytest.mark.cuda
def test_tf32_wgmma_reads_the_top_19_bits(cuda):
    """The tf32 ``wgmma`` the float32 backward is built on
    (``tf32_probe``: one SS product from 128-byte swizzled K-major tiles,
    one RS product with A in the tf32 register layout): each float32 word
    is read as TF32 from its top 19 bits, the low 13 ignored (truncation,
    which is why the pre-pass stores big with them clear), and both
    products equal float64 products of the truncated operands up to
    float32 accumulation (which shows the fragment layouts and the
    descriptors right)."""
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention_backward")
    rng = np.random.default_rng(30)
    a = rng.standard_normal((64, 8)).astype(np.float32)
    b = rng.standard_normal((32, 8)).astype(np.float32)
    a[0] = 0
    a[0, 0] = 1 + 2.0 ** -11 + 2.0 ** -12   # rounds up, truncates down
    b[0] = 0
    b[0, 0] = 1.0
    outs = []
    for x in (a, b):
        outs.append(torch.from_numpy(x).to(cuda))
    d_ss = torch.empty((64, 32), device=cuda)
    d_rs = torch.empty((64, 32), device=cuda)
    assert lib.repro_flash_attention_backward_tf32_probe(
        outs[0].data_ptr(), outs[1].data_ptr(), d_ss.data_ptr(),
        d_rs.data_ptr(), torch.cuda.current_stream(cuda).cuda_stream) == 0
    torch.cuda.synchronize()

    def trunc(x):
        return (torch.from_numpy(x).view(torch.int32) & -0x2000).view(
            torch.float32).double()
    want = trunc(a) @ trunc(b).T
    for d in (d_ss, d_rs):
        d = d.cpu().double()
        assert float(d[0, 0]) == 1.0
        torch.testing.assert_close(d, want, atol=1e-5, rtol=1e-6)


@pytest.mark.cuda
def test_reduced_qwen3_train_step_on_the_card_matches_the_host(cuda):
    """One float32 train step of reduced qwen3 at 1,100 tokens: K3 runs
    forward and again under remat in every layer, and the step agrees
    with the same step on the host: loss 1e-5 relative; each leaf of
    ``m`` within 5e-5 of that leaf's largest magnitude and each of
    ``v`` within 1e-4 (a wrong gradient on any one leaf shows there;
    every leaf differs by about 5e-6 relative, the clip scale from the
    two float32 norms, and ``v = g^2`` by twice that: measured on an
    H100, 7.5e-6 and 1.5e-5); each parameter
    within ``lr · (1e-3 + |Δm| / ((1 - b1) · eps))`` (AdamW's first
    step moves an element by ``lr · g / (|g| + eps)``, whose slope
    ``1/eps`` amplifies the gradients' float32 differences where a
    gradient is near eps; ``Δm / (1 - b1)`` is that difference)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import REPLICATED
    from repro_torch.kernels.flash_attention import launches
    from repro_torch.models import get_model
    from repro_torch.models.lm import tree_leaves, tree_map
    from repro_torch.training import TrainConfig, make_train_step
    from repro_torch.training.train_step import init_train_state
    cfg = get_arch("qwen3-0.6b", reduced=True)
    api = get_model(cfg)
    step = make_train_step(api, TrainConfig(
        learning_rate=1e-3, warmup_steps=5, compute_dtype="float32",
        grad_reduce_dtype="float32"), REPLICATED)
    host = init_train_state(api, torch.Generator().manual_seed(0))
    card = tree_map(lambda a: a.to(cuda), host)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 1100)).astype(np.int32))
    before = launches.count
    card, mc = step(card, {"tokens": toks.to(cuda)})
    assert launches.count - before == 2 * cfg.num_layers
    host, mh = step(host, {"tokens": toks})
    assert abs(float(mc["loss"]) / float(mh["loss"]) - 1) <= 1e-5
    lr = mh["lr"]
    leaves = {(name, k): tree_leaves(st[k]) for name, st in
              (("card", card), ("host", host)) for k in ("params", "m", "v")}
    for k, tol in (("m", 5e-5), ("v", 1e-4)):
        for got, want in zip(leaves["card", k], leaves["host", k]):
            top = float(want.abs().max())
            assert float((got.cpu() - want).abs().max()) <= tol * top, k
    for pc, ph, mc_, mh_ in zip(leaves["card", "params"],
                                leaves["host", "params"],
                                leaves["card", "m"], leaves["host", "m"]):
        allowed = lr * (1e-3 + (mc_.cpu() - mh_).abs() / (0.1 * 1e-8))
        assert bool(((pc.cpu() - ph).abs() <= allowed + 1e-7).all())


# ---- the engine-stack twins of tests/test_torch_device_fusion.py
FUSION_EXACT_PIPE = [
    {"type": "crop", "x": 2, "y": 2, "width": 16, "height": 16},
    {"type": "rotate", "k": 1},
    {"type": "flip", "axis": "horizontal"},
    {"type": "threshold", "value": 0.5},
]
FUSION_PREPROCESS_PIPE = [
    {"type": "resize", "width": 20, "height": 24},
    {"type": "crop", "x": 2, "y": 3, "width": 12, "height": 10},
    {"type": "normalize", "mean": 0.4, "std": 0.25},
    {"type": "blur", "ksize": 3, "sigma_x": 1.0},
]


def _all_device(pipe):
    return {o["type"]: {"device": 1e-9, "native": 10.0, "remote": 10.0,
                        "batcher": 10.0} for o in pipe}


def _fusion_run(device, pipe, n=6, size=24, **kw):
    """``tests/test_device_fusion.py``'s scenario: ``n`` seeded images
    through ``pipe``; returns (entities, dispatch stats, K1 and K2
    launches during the query)."""
    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.core.remote import TransportModel
    from repro_torch.kernels import gaussian_blur as gb
    eng = VDMSAsyncEngine(device=device, num_remote_servers=2,
                          transport=TransportModel(network_latency_s=0.001,
                                                   service_time_s=0.002),
                          **kw)
    try:
        rng = np.random.default_rng(5)
        for i in range(n):
            img = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
            eng.add_entity("image", img, {"category": "fuse", "idx": i})
        k1, k2 = gb.launches.count, pp.launches.count
        res = eng.execute([{"FindImage": {
            "constraints": {"category": ["==", "fuse"]},
            "operations": pipe}}], timeout=120)
        rose = (gb.launches.count - k1, pp.launches.count - k2)
        stats = eng.dispatch_stats()
    finally:
        eng.shutdown()
    assert res["stats"]["failed"] == 0
    return res["entities"], stats, rose


@pytest.mark.cuda
def test_fused_segment_on_the_card_matches_per_op_and_native(cuda):
    """The whole bit-exact pipeline as one fused device segment on the
    card: byte-identical to the per-op device path, the native engine
    on the card and the native engine on the host."""
    pins = _all_device(FUSION_EXACT_PIPE)
    dev = dict(dispatch="cost", device_backend="cuda", cost_overrides=pins,
               device_max_wait_ms=50.0)
    host, _, _ = _fusion_run("cpu", FUSION_EXACT_PIPE)
    nat, _, _ = _fusion_run("cuda", FUSION_EXACT_PIPE)
    per, per_st, _ = _fusion_run("cuda", FUSION_EXACT_PIPE,
                                 device_fuse_segments=False, **dev)
    fus, fus_st, _ = _fusion_run("cuda", FUSION_EXACT_PIPE, **dev)
    for got in (nat, per, fus):
        assert list(got) == list(host)
        for eid in host:
            np.testing.assert_array_equal(got[eid], host[eid])
    d = fus_st["device"]
    assert d["platform"] == "cuda"
    assert d["entities_run"] == 6 and d["ops_run"] == 24
    assert d["fused_segments"] >= 1
    assert d["h2d_bytes"] < per_st["device"]["h2d_bytes"]


@pytest.mark.cuda
def test_fused_preprocess_chain_on_the_card_matches_native(cuda):
    """resize→crop→normalize→blur fused on the card: K2 for the chain
    and K1 for the blur, within 1e-4 (the fused preprocess kernel's
    tolerance) of the native engine on the card; per op, K2 stays
    unlaunched."""
    pins = _all_device(FUSION_PREPROCESS_PIPE)
    dev = dict(dispatch="cost", device_backend="cuda", cost_overrides=pins,
               device_max_wait_ms=50.0)
    nat, _, _ = _fusion_run("cuda", FUSION_PREPROCESS_PIPE, size=32)
    fus, st, (k1, k2) = _fusion_run("cuda", FUSION_PREPROCESS_PIPE, size=32,
                                    **dev)
    assert st["device"]["fused_segments"] >= 1
    assert k1 > 0 and k2 > 0
    _, _, (k1_per, k2_per) = _fusion_run("cuda", FUSION_PREPROCESS_PIPE,
                                         size=32, device_fuse_segments=False,
                                         **dev)
    assert k1_per > 0 and k2_per == 0
    for eid in nat:
        np.testing.assert_allclose(fus[eid], nat[eid], atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_cancel_mid_fused_batch_on_the_card_releases_admission_slots(cuda):
    """``test_cancel_mid_fused_batch_drains_and_releases_admission_slots``
    on the card: the device inbox drains, no admission slot leaks, and a
    query needing every slot then completes."""
    import time

    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.core.remote import TransportModel
    eng = VDMSAsyncEngine(device="cuda", num_remote_servers=2,
                          transport=TransportModel(network_latency_s=0.001,
                                                   service_time_s=0.002),
                          dispatch="cost", device_backend="cuda",
                          cost_overrides=_all_device(FUSION_EXACT_PIPE),
                          device_max_wait_ms=100.0, admission="shed",
                          max_inflight_entities=16)
    query = [{"FindImage": {"constraints": {"category": ["==", "fuse"]},
                            "operations": FUSION_EXACT_PIPE}}]
    try:
        rng = np.random.default_rng(5)
        for i in range(10):
            img = rng.uniform(0, 1, (24, 24, 3)).astype(np.float32)
            eng.add_entity("image", img, {"category": "fuse", "idx": i})
        fut = eng.submit(query)
        time.sleep(0.02)
        assert fut.cancel()
        deadline = time.monotonic() + 10
        while (eng.loop.queue1.qsize() or eng.device_backend.pending()
               or eng.admission_stats()["inflight"]) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.device_backend.pending() == 0
        assert eng.admission_stats()["inflight"] == 0
        res = eng.execute(query, timeout=60)
        assert res["stats"]["matched"] == 10
        assert res["stats"]["failed"] == 0
    finally:
        eng.shutdown()


# ------------------------------------------------------- K5's backward
# the backward kernel against its plain version on the same tensors:
# float32 gradients 1e-5 of the gradient's largest magnitude plus 1e-4
# relative (tests/test_torch_scan_grads.py's float32 tolerance: the same
# float32 gradient by the closed form, summed in another order); a
# bfloat16 gradient one bfloat16 step, 2^-7 relative plus 1e-3 of its
# largest magnitude (both round the float32 gradient once)
WKV_BWD_TOL, WKV_BWD_RTOL = 1e-5, 1e-4
WKV_BWD_BF16_TOL, WKV_BWD_BF16_RTOL = 1e-3, 2.0 ** -7


def _wkv_bwd_inputs(seed, B, T, H, K, V, device, dtype, decay="model"):
    """r, k ~ 0.5 N, v, dy, ds ~ N, u ~ 0.1 N, s0 ~ 0.1 N, drawn with
    numpy, r, k, v, dy and u in ``dtype``; the decays the model's
    (exp(-exp(-4 + N))), near 0 (U(0.02, 0.1)), near 1 (U(0.999, 1),
    some exactly 1) or cut by the clamp (the model's, a fifth of them 0
    or 1e-31)."""
    rng = np.random.default_rng(seed)

    def n(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    shape = (B, T, H, K)
    if decay == "near0":
        w = rng.uniform(0.02, 0.1, shape)
    elif decay == "near1":
        w = np.where(rng.uniform(size=shape) < 0.1, 1.0,
                     rng.uniform(0.999, 1.0, shape))
    else:
        w = np.exp(-np.exp(-4.0 + n(shape)))
        if decay == "clamp":
            cut = rng.uniform(size=shape)
            w = np.where(cut < 0.1, 0.0, np.where(cut < 0.2, 1e-31, w))
    t = {name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
         for name, a in (("r", n(shape, 0.5)), ("k", n(shape, 0.5)),
                         ("v", n((B, T, H, V))), ("w", w.astype(np.float32)),
                         ("u", n((H, K), 0.1)), ("s0", n((B, H, K, V), 0.1)),
                         ("dy", n((B, T, H, V))), ("ds", n((B, H, K, V))))}
    for name in ("r", "k", "v", "dy", "u"):    # u too, as a bf16 model's
        t[name] = t[name].to(dtype)
    return t


def _wkv_bwd_close(got, want, what, decays=None):
    """Each gradient within the tolerances above of the plain version's.
    With ``decays`` (the decays near 0), dw is held as w·dw = dlogw: dw =
    dlogw / w multiplies dlogw's float32 rounding, a difference of sums
    of terms up to 1/w larger than it, by 1/w in every implementation (the
    plain version at chunk 16 and at chunk 64 differ by 1.3 times the
    tolerance at w in (0.02, 0.1) on the CPU)."""
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        if w is None:
            assert g is None, (what, name)
            continue
        if name == "dw" and decays is not None:
            g, w = g * decays, w * decays
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        assert bool(torch.isfinite(g.float()).all()), (what, name)
        top = float(w.float().abs().max()) or 1.0
        if g.dtype == torch.bfloat16:
            atol, rtol = WKV_BWD_BF16_TOL * top, WKV_BWD_BF16_RTOL
        else:
            atol, rtol = WKV_BWD_TOL * top, WKV_BWD_RTOL
        torch.testing.assert_close(
            g.float(), w.float(), atol=atol, rtol=rtol,
            msg=lambda m, name=name: f"{what}: {name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,K,V,dtype,decay,state,dy,ds", [
    # rwkv6-1.6b's training microbatch, y's cotangent only, both types
    (2, 4096, 32, 64, 64, torch.bfloat16, "model", False, True, False),
    (2, 4096, 32, 64, 64, torch.float32, "model", False, True, False),
    # with and without s0 and either cotangent
    (2, 130, 3, 64, 64, torch.float32, "model", True, True, True),
    (2, 130, 3, 64, 64, torch.bfloat16, "model", True, False, True),
    (1, 45, 2, 64, 64, torch.float32, "model", False, False, True),
    (1, 45, 2, 64, 64, torch.float32, "model", True, True, False),
    # 1-, 3- and 17-token calls; a ragged tail; K and V apart, no multiple
    # of 16 (the walks' column groups cut short, no 16-byte copies)
    (3, 1, 4, 64, 64, torch.float32, "model", True, True, True),
    (2, 3, 4, 64, 64, torch.bfloat16, "model", True, True, True),
    (2, 17, 4, 64, 64, torch.float32, "model", True, True, True),
    (2, 100, 3, 16, 40, torch.float32, "model", True, True, True),
    (1, 37, 5, 40, 24, torch.bfloat16, "model", True, True, True),
    (1, 33, 2, 8, 64, torch.float32, "model", False, True, True),
    # decays near 0, near 1 (some exactly 1) and cut by the clamp
    (2, 90, 3, 64, 64, torch.float32, "near0", True, True, True),
    (2, 90, 3, 64, 64, torch.float32, "near1", True, True, True),
    (2, 90, 3, 64, 64, torch.float32, "clamp", True, True, True),
])
def test_wkv_backward_kernel_matches_plain(cuda, B, T, H, K, V, dtype, decay,
                                           state, dy, ds):
    """The backward kernel (one launch) against
    ``ref.rwkv6_chunked_backward`` on the same tensors on the card, each
    gradient in its input's dtype; a second launch gives equal bits (no
    atomics); where the clamp cuts the decay, dw is 0."""
    from repro_torch.kernels.rwkv6_scan import (backward_launches,
                                                rwkv6_scan_backward_cuda)
    t = _wkv_bwd_inputs(T + K + V, B, T, H, K, V, cuda, dtype, decay)
    args = (t["r"], t["k"], t["v"], t["w"], t["u"],
            t["s0"] if state else None, t["dy"] if dy else None,
            t["ds"] if ds else None)
    before = backward_launches.count
    got = rwkv6_scan_backward_cuda(*args)
    torch.cuda.synchronize()
    assert backward_launches.count == before + 1
    # the clamp's log-decays of -69 a step: the plain version at the
    # kernel's 16-step block, whose cumulative sums are as short
    want = ref.rwkv6_chunked_backward(*args, chunk=16 if decay == "clamp"
                                      else 64)
    _wkv_bwd_close(got, want, f"{(B, T, H, K, V)} {dtype} {decay}",
                   t["w"] if decay == "near0" else None)
    again = rwkv6_scan_backward_cuda(*args)
    for g, a in zip(got, again):
        assert (g is None and a is None) or torch.equal(g, a)
    if decay == "clamp":
        assert bool((got[3][t["w"] < 1e-30] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_backward_kernel_reads_strided_operands(cuda, dtype):
    """r, k, v and dy read in place through their batch and time strides
    (slices of wider buffers, as a packed projection gives), and a dy
    whose rows are no 16-byte multiple apart (copied): the same
    gradients as contiguous copies."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_backward_cuda
    B, T, H, K = 2, 70, 4, 64
    t = _wkv_bwd_inputs(3, B, T, H, K, K, cuda, dtype)
    packed = torch.cat([t["r"], t["k"], t["v"]], dim=2)     # (B,T,3H,K)
    r, k, v = packed[:, :, :H], packed[:, :, H:2 * H], packed[:, :, 2 * H:]
    wide = torch.zeros((B, T + 5, H, K), dtype=dtype, device=cuda)
    wide[:, 2:T + 2] = t["dy"]
    dy = wide[:, 2:T + 2]
    assert not dy.is_contiguous() and not r.is_contiguous()
    got = rwkv6_scan_backward_cuda(r, k, v, t["w"], t["u"], t["s0"], dy,
                                   t["ds"])
    want = rwkv6_scan_backward_cuda(
        *(x.contiguous() for x in (r, k, v)), t["w"], t["u"], t["s0"],
        dy.contiguous(), t["ds"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    odd = torch.zeros((B, T, H, K + 1), dtype=dtype, device=cuda)
    odd[..., :K] = t["dy"]
    got = rwkv6_scan_backward_cuda(t["r"], t["k"], t["v"], t["w"], t["u"],
                                   t["s0"], odd[..., :K], t["ds"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_wkv_backward_wrapper_refuses_what_its_kernel_cannot_take(cuda):
    """Head sizes past 64, float16 operands, a CPU operand, inconsistent
    cotangent shapes and a chunk out of range raise; nothing launches."""
    from repro_torch.kernels.rwkv6_scan import (backward_launches,
                                                rwkv6_scan_backward_cuda)
    t = _wkv_bwd_inputs(0, 1, 20, 2, 64, 64, cuda, torch.float32)
    args = [t["r"], t["k"], t["v"], t["w"], t["u"], None, t["dy"], None]
    before = backward_launches.count
    big = _wkv_bwd_inputs(0, 1, 20, 2, 80, 64, cuda, torch.float32)
    with pytest.raises(ValueError, match="K <= 64"):
        rwkv6_scan_backward_cuda(big["r"], big["k"], big["v"], big["w"],
                                 big["u"], None, big["dy"], None)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rwkv6_scan_backward_cuda(*[a.half() for a in args[:3]], *args[3:])
    with pytest.raises(ValueError, match="is on cpu"):
        rwkv6_scan_backward_cuda(*args[:6], t["dy"].cpu(), None)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        rwkv6_scan_backward_cuda(*[a if a is None else a.cpu()
                                   for a in args])
    with pytest.raises(ValueError, match="inconsistent shapes"):
        rwkv6_scan_backward_cuda(*args[:6], t["dy"][:, :10], None)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        rwkv6_scan_backward_cuda(*args[:7], t["ds"][:, :1])
    with pytest.raises(ValueError, match="chunk"):
        rwkv6_scan_backward_cuda(*args, chunk=65)
    assert backward_launches.count == before


@pytest.mark.cuda
def test_wkv_backward_library_reports_the_mirrors_geometry(cuda):
    """The built library's block length, sub-block length and walk width
    are the ones the wrapper sizes its scratch by and ``backward_blocks``
    / ``backward_walks`` mirror."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv6_scan as wkv
    assert wkv.kernel_geometry(_build.load("rwkv6_scan_backward")) == (
        wkv.BWD_BLOCK, wkv.BWD_SUB, wkv.BWD_WALK_THREADS)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,K,V,dtype", [
    (2, 70, 3, 7, 5, torch.float32),
    (1, 83, 2, 13, 61, torch.bfloat16),
    (2, 19, 2, 62, 30, torch.float32),
])
def test_wkv_backward_kernel_takes_rows_of_any_width(cuda, B, T, H, K, V,
                                                     dtype):
    """K and V no multiple of 4 (rows staged value by value, no 16- or
    8-byte loads and stores) against the plain version on the same
    tensors, with s0 and both cotangents; the tolerances of
    ``test_wkv_backward_kernel_matches_plain``."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_backward_cuda
    t = _wkv_bwd_inputs(T + K + V, B, T, H, K, V, cuda, dtype)
    args = (t["r"], t["k"], t["v"], t["w"], t["u"], t["s0"], t["dy"],
            t["ds"])
    got = rwkv6_scan_backward_cuda(*args)
    torch.cuda.synchronize()
    _wkv_bwd_close(got, ref.rwkv6_chunked_backward(*args),
                   f"{(B, T, H, K, V)} {dtype}")


# ------------------------------------------------------- K4's backward
# the backward kernel against its plain version on the same tensors:
# float32 gradients 1e-5 of the gradient's largest magnitude plus 1e-4
# relative (tests/test_torch_scan_grads.py's float32 tolerance: the same
# float32 gradient by the closed form, summed in another order and the
# products in 3xTF32); a bfloat16 gradient one bfloat16 step, 2^-7
# relative plus 1e-3 of its largest magnitude (both round the float32
# gradient once)
SSD_BWD_TOL, SSD_BWD_RTOL = 1e-5, 1e-4
SSD_BWD_BF16_TOL, SSD_BWD_BF16_RTOL = 1e-3, 2.0 ** -7


def _ssd_bwd_inputs(seed, B, T, H, P, G, N, device, dtype, decay="model"):
    """``_ssd_inputs`` with the cotangents dy (in x's dtype) and dh
    (float32), and dt scaled for decays near 0 (A dt about -1e-4 a step)
    or strong (about -1.6 a step: la reaches -100 over a 64-step block
    and exp(la) underflows across it)."""
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(seed, B, T, H, P, G, N, device,
                                          dtype)
    rng = np.random.default_rng(seed + 1)
    if decay == "near0":
        dt = torch.from_numpy(rng.uniform(0.5, 1.5, (B, T, H)).astype(
            np.float32)).to(device) * 1e-4 / -A
    elif decay == "strong":
        dt = torch.from_numpy(rng.uniform(1.2, 2.0, (B, T, H)).astype(
            np.float32)).to(device) / -A
    dy = torch.from_numpy(rng.standard_normal((B, T, H, P)).astype(
        np.float32)).to(device, dtype)
    dh = torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(
        np.float32)).to(device)
    return {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm, "D": D, "h0": h0,
            "dy": dy, "dh": dh}


def _ssd_bwd_close(got, want, what):
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD", "dh0"), got,
                          want):
        if w is None:
            assert g is None, (what, name)
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        assert bool(torch.isfinite(g.float()).all()), (what, name)
        top = float(w.float().abs().max()) or 1.0
        if g.dtype == torch.bfloat16:
            atol, rtol = SSD_BWD_BF16_TOL * top, SSD_BWD_BF16_RTOL
        else:
            atol, rtol = SSD_BWD_TOL * top, SSD_BWD_RTOL
        torch.testing.assert_close(
            g.float(), w.float(), atol=atol, rtol=rtol,
            msg=lambda m, name=name: f"{what}: {name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,P,G,N,dtype,decay,state,D,dy,dh", [
    # zamba2-2.7b's training microbatch, y's cotangent only, both types
    (1, 4096, 80, 64, 1, 64, torch.float32, "model", False, True, True,
     False),
    (1, 4096, 80, 64, 1, 64, torch.bfloat16, "model", False, True, True,
     False),
    # with and without the initial state, D and either cotangent
    (2, 130, 4, 64, 2, 64, torch.float32, "model", True, True, True, True),
    (2, 130, 4, 64, 2, 64, torch.bfloat16, "model", True, False, False,
     True),
    (1, 45, 2, 64, 1, 64, torch.float32, "model", False, False, False, True),
    (1, 45, 2, 64, 1, 64, torch.float32, "model", True, True, True, False),
    # 1-, 3- and 17-token calls; ragged tails; grouped B/C; P and N no
    # multiple of 4 or 8 (no vector loads, the tiles cut short)
    (3, 1, 4, 64, 2, 64, torch.float32, "model", True, True, True, True),
    (2, 3, 4, 64, 4, 64, torch.bfloat16, "model", True, True, True, True),
    (2, 17, 6, 64, 3, 64, torch.float32, "model", True, True, True, True),
    (2, 300, 16, 64, 4, 64, torch.float32, "model", True, True, True, True),
    (1, 77, 3, 40, 3, 24, torch.float32, "model", True, True, True, True),
    (1, 37, 2, 6, 1, 10, torch.bfloat16, "model", True, True, True, True),
    # decays near 0 and strong
    (2, 150, 3, 64, 1, 64, torch.float32, "near0", True, True, True, True),
    (2, 150, 3, 64, 1, 64, torch.float32, "strong", True, True, True, True),
    # groups of heads no multiple of the 8-head slice: 3 heads a group,
    # a head a group (P 40, N 24), 12 heads a group (two slices of 6,
    # summed by the group-sum pass) and 24 (three of 8)
    (1, 130, 6, 64, 2, 64, torch.float32, "model", True, True, True, True),
    (1, 130, 6, 64, 2, 64, torch.bfloat16, "model", True, False, True,
     False),
    (2, 77, 5, 40, 5, 24, torch.float32, "model", True, True, True, True),
    (2, 77, 5, 40, 5, 24, torch.bfloat16, "model", False, True, True, True),
    (1, 200, 24, 64, 2, 64, torch.float32, "model", True, True, True, True),
    (2, 100, 24, 64, 1, 64, torch.bfloat16, "model", False, True, True,
     False),
])
def test_ssd_backward_kernel_matches_plain(cuda, B, T, H, P, G, N, dtype,
                                           decay, state, D, dy, dh):
    """The backward kernel (one launch) against
    ``ref.mamba2_ssd_chunked_backward`` on the same tensors on the card,
    each gradient in its input's dtype; a second launch gives equal bits
    (no atomics).  The plain version runs at the kernel's 64-step block:
    the chunked form is exact at any length, and strong decays' la sums
    keep float32's bits only relative to their own size (in every
    implementation), so equal blocks round alike."""
    from repro_torch.kernels.mamba2_ssd import (backward_launches,
                                                mamba2_ssd_backward_cuda)
    t = _ssd_bwd_inputs(T + P + N, B, T, H, P, G, N, cuda, dtype, decay)
    args = (t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["D"] if D else None,
            t["h0"] if state else None, t["dy"] if dy else None,
            t["dh"] if dh else None)
    before = backward_launches.count
    got = mamba2_ssd_backward_cuda(*args)
    torch.cuda.synchronize()
    assert backward_launches.count == before + 1
    want = ref.mamba2_ssd_chunked_backward(*args, chunk=64)
    _ssd_bwd_close(got, want, f"{(B, T, H, P, G, N)} {dtype} {decay}")
    again = mamba2_ssd_backward_cuda(*args)
    for g, a in zip(got, again):
        assert (g is None and a is None) or torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_kernel_reads_strided_operands(cuda, dtype):
    """x, B and C read in place as strided slices of one packed
    in-projection (as the model hands them over), dy through its strides
    (a slice of a wider buffer, as the gated norm's backward may give),
    and a dy whose rows are no 16-byte multiple apart (copied): the same
    gradients as contiguous copies."""
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_backward_cuda
    B, T, H, P, N = 2, 130, 8, 64, 64
    t = _ssd_bwd_inputs(5, B, T, H, P, 1, N, cuda, dtype)
    packed = torch.cat([t["x"].reshape(B, T, H * P),
                        t["Bm"].reshape(B, T, N),
                        t["Cm"].reshape(B, T, N)], dim=-1)
    xv, bv, cv = torch.split(packed, [H * P, N, N], dim=-1)
    x, Bm, Cm = (xv.reshape(B, T, H, P), bv.reshape(B, T, 1, N),
                 cv.reshape(B, T, 1, N))
    wide = torch.zeros((B, T + 5, H, P), dtype=dtype, device=cuda)
    wide[:, 2:T + 2] = t["dy"]
    dy = wide[:, 2:T + 2]
    assert not dy.is_contiguous() and not Bm.is_contiguous()
    rest = (t["D"], t["h0"])
    got = mamba2_ssd_backward_cuda(x, t["dt"], t["A"], Bm, Cm, *rest, dy,
                                   t["dh"])
    want = mamba2_ssd_backward_cuda(
        x.contiguous(), t["dt"], t["A"], Bm.contiguous(), Cm.contiguous(),
        *rest, dy.contiguous(), t["dh"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    odd = torch.zeros((B, T, H, P + 1), dtype=dtype, device=cuda)
    odd[..., :P] = t["dy"]
    got = mamba2_ssd_backward_cuda(x, t["dt"], t["A"], Bm, Cm, *rest,
                                   odd[..., :P], t["dh"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_ssd_function_backward_runs_only_the_kernel(cuda, monkeypatch):
    """On CUDA tensors the Function's backward is the backward kernel,
    one launch a call: neither the plain backward nor autograd through
    the plain forward runs (both made to raise here)."""
    from repro_torch.kernels import mamba2_ssd
    t = _ssd_bwd_inputs(9, 1, 200, 4, 64, 1, 64, cuda, torch.float32)

    def refuse(*a, **k):
        raise AssertionError("the plain backward ran on the card")

    monkeypatch.setattr(ref, "mamba2_ssd_chunked_backward", refuse)
    monkeypatch.setattr(ref, "recomputed_vjp", refuse)
    leaves = [t[k].detach().requires_grad_()
              for k in ("x", "dt", "A", "Bm", "Cm", "D")]
    before = mamba2_ssd.backward_launches.count
    y, _ = mamba2_ssd.mamba2_ssd(*leaves)
    y.backward(t["dy"])
    assert mamba2_ssd.backward_launches.count == before + 1
    assert all(bool(torch.isfinite(v.grad).all()) for v in leaves)


@pytest.mark.cuda
def test_ssd_backward_wrapper_refuses_what_its_kernel_cannot_take(cuda):
    """Head sizes or states past 64, float16 operands, a CPU operand and
    inconsistent cotangent shapes raise; nothing launches."""
    from repro_torch.kernels.mamba2_ssd import (backward_launches,
                                                mamba2_ssd_backward_cuda)
    t = _ssd_bwd_inputs(0, 1, 20, 2, 64, 1, 64, cuda, torch.float32)
    args = [t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["D"], None, t["dy"],
            None]
    before = backward_launches.count
    big = _ssd_bwd_inputs(0, 1, 20, 2, 80, 1, 64, cuda, torch.float32)
    with pytest.raises(ValueError, match="P <= 64"):
        mamba2_ssd_backward_cuda(big["x"], big["dt"], big["A"], big["Bm"],
                                 big["Cm"], None, None, big["dy"], None)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mamba2_ssd_backward_cuda(args[0].half(), *args[1:3],
                                 *[a.half() for a in args[3:5]], *args[5:])
    with pytest.raises(ValueError, match="is on cpu"):
        mamba2_ssd_backward_cuda(*args[:7], t["dy"].cpu(), None)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        mamba2_ssd_backward_cuda(*[a if a is None else a.cpu()
                                   for a in args])
    with pytest.raises(ValueError, match="inconsistent shapes"):
        mamba2_ssd_backward_cuda(*args[:7], t["dy"][:, :10], None)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        mamba2_ssd_backward_cuda(*args[:8], t["dh"][:, :1])
    assert backward_launches.count == before


@pytest.mark.cuda
def test_ssd_backward_library_reports_the_mirrors_geometry(cuda):
    """The built library's block length and walk width are the ones the
    wrapper sizes its scratch by and ``backward_blocks`` /
    ``backward_walks`` mirror."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba2_ssd as m
    assert m.kernel_geometry(_build.load("mamba2_ssd_backward")) == (
        m.BWD_BLOCK, m.BWD_WALK_THREADS, m.BWD_SLICE)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_kernel_gives_equal_bits_over_persistent_ctas(cuda,
                                                                    dtype):
    """More items than persistent CTAs (the card's SM count, as the
    launch takes it): 2 x 21 blocks x 4 slices of 8 heads = 168 items,
    some CTA taking two.  Two launches give equal bits (a CTA's items
    run in a fixed order, no atomics), within the plain version's
    tolerances."""
    from repro_torch.kernels import mamba2_ssd as m
    B, T, H, P, G, N = 2, 1300, 32, 64, 1, 64
    grid = torch.cuda.get_device_properties(cuda).multi_processor_count
    ctas = m.backward_items(B, T, H, G, grid)
    assert len(ctas) == grid and max(len(c) for c in ctas) > 1
    t = _ssd_bwd_inputs(31, B, T, H, P, G, N, cuda, dtype)
    args = [t[k] for k in ("x", "dt", "A", "Bm", "Cm", "D", "h0", "dy",
                           "dh")]
    got = m.mamba2_ssd_backward_cuda(*args)
    again = m.mamba2_ssd_backward_cuda(*args)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    _ssd_bwd_close(got, ref.mamba2_ssd_chunked_backward(*args, chunk=64),
                   f"{(B, T, H, P, G, N)} {dtype} over {grid} CTAs")


@pytest.mark.cuda
def test_ssd_backward_kernel_at_the_training_shape_reports_da_share(cuda):
    """zamba2-2.7b's training microbatch (1 x 4,096, 80 heads of 64, one
    group of state 64, float32), y's cotangent only: each gradient
    against autograd through the plain chunked forward at the Function's
    chunk 128 on float32 copies of the same tensors, within 1e-5 of its
    largest magnitude (``chip_smoke.py``'s scan-gradient gate); the
    share of the gate each gradient takes is printed, dA's the least
    margin of the card's checks."""
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_backward_cuda
    t = _ssd_bwd_inputs(41, 1, 4096, 80, 64, 1, 64, cuda, torch.float32)
    inputs = [t[k] for k in ("x", "dt", "A", "Bm", "Cm", "D")]
    got = mamba2_ssd_backward_cuda(*inputs, None, t["dy"], None)
    leaves = [v.detach().clone().requires_grad_() for v in inputs]
    want = torch.autograd.grad(
        ref.mamba2_ssd_chunked(*leaves, chunk=128)[0], leaves, t["dy"])
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        gate = SSD_BWD_TOL * float(w.abs().max())
        share = float((g - w).abs().max()) / gate
        print(f"{name}: {share:.4f} of its gate {gate:.4g}")
        assert share <= 1.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_kernel_holds_chunk_128_at_strong_decays(cuda, dtype):
    """At strong decays (la about -1.6 a step, -200 over the Function's
    128-step chunk) the kernel, tiling by its 64-step blocks, against an
    independently blocked reference: the plain version at the Function's
    chunk 128 on the same tensors, with the initial state, D and both
    cotangents, grouped B/C and a ragged tail.  Tolerances as
    ``test_ssd_backward_kernel_matches_plain``'s.  Autograd through the
    plain forward is no yardstick here: its dA sums dt times the reverse
    sum of la's gradient, weighting terms that cancel by la itself, and
    strays past the float32 gate here, where both blockings of the closed
    form agree."""
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_backward_cuda
    t = _ssd_bwd_inputs(21, 2, 300, 4, 64, 2, 64, cuda, dtype, "strong")
    args = [t[k] for k in ("x", "dt", "A", "Bm", "Cm", "D", "h0", "dy",
                           "dh")]
    _ssd_bwd_close(mamba2_ssd_backward_cuda(*args),
                   ref.mamba2_ssd_chunked_backward(*args, chunk=128),
                   f"strong decays {dtype} against chunk 128")
