"""The yardstick of ``chip_smoke.py``: each kernel row's bound (the least
time an H100 could take for the same work) from its shapes alone.

``chip_smoke.bound`` takes the longest of three times: the bytes at
3.35 TB/s, the matrix products at the tensor-core rate for the operand
type (989 TF/s bf16; float32 as 3xTF32 at 495/3 TF/s) and the other
operations at 67 TF/s outside the tensor cores.  The values pinned here
are the rows of ``PERF.md`` §6, to the microsecond's thousandth.
``chip_smoke`` imports only the standard library at its top level, so
this runs on a host without a card.
"""
import pytest

import chip_smoke as cs

F32, BF16 = "torch.float32", "torch.bfloat16"


def _attn(B, Sq, Sk, H, Hkv, D, q_offset, itemsize, dtype):
    return cs.bound(*cs.attn_work(B, Sq, Sk, H, Hkv, D, q_offset, True,
                                  itemsize), dtype)


def _ssd(B, T, H, P, G, N, itemsize, dtype):
    return cs.bound(*cs.ssd_work(B, T, H, P, G, N, itemsize), dtype)


def _grad(work, *args, dtype):
    return cs.bound(*work(*args), dtype)


def _blur(shape, ksize):
    nbytes, flops = cs.blur_work(shape, ksize)
    return cs.bound(nbytes, 0, flops, F32)


def _wkv(B, T, H, K, itemsize, dtype):
    return cs.bound(*cs.wkv_work(B, T, H, K, K, itemsize), dtype)


def _preprocess(shape=(32, 250, 250, 3), kw=None):
    """K2, by default at the device backend's batch: 32 faces of 250x250
    resized to 256x256 (bilinear) and cropped to 224x224 at (16, 16)."""
    from repro_torch.kernels import preprocess as pp
    kw = kw or cs.K2_MAIN
    n, h, w, c = shape
    geometry = (h, w, kw["resize_h"], kw["resize_w"],
                pp._canonical_method(kw["method"]), kw["crop_x"],
                kw["crop_y"], kw["crop_w"], kw["crop_h"])
    ry, rx = pp._cropped_matrices(*geometry)
    (_, yt), (_, xt) = pp._tables(*geometry)
    nbytes, flops = cs.preprocess_work(n, h, w, c, yt.shape[0],
                                       xt.shape[0], yt.shape[1],
                                       xt.shape[1], int((ry != 0).sum()),
                                       int((rx != 0).sum()))
    return cs.bound(nbytes, 0, flops, F32)


@pytest.mark.parametrize("row,want_ms,want_by", [
    # K3 at the long-context prefill: q (4,4096,16,128) against 4113
    # slots of 8 kv heads, causal; 274.9 GFLOP of products
    ("K3 f32", 1.666333, "products"),
    ("K3 f32 at q_offset 3584", 0.390502, "products"),
    ("K3 bf16", 0.278003, "products"),
    # K4 at zamba2's prefill (16,512,80,64), G=1, N=64: its 384 MB
    # outlast the 10.9 GFLOP of products counted at chunk length 1
    ("K4 f32", 0.114718, "bytes"),
    ("K4 f32 at G=8", 0.123482, "bytes"),
    ("K4 bf16", 0.064010, "bytes"),
    ("K4 f32 at the UDF's 3 tokens", 0.013119, "bytes"),
    # K1 and K2 run no matrix product, and K5's readout and update (4.3
    # GFLOP of products) and decay take less than its bytes
    ("K1 (32,224,224,3) k9", 0.011503, "bytes"),
    ("K1 (1,224,224,3) k9", 0.000359, "bytes"),
    ("K1 (1,250,250,3) k5", 0.000448, "bytes"),
    ("K1 (1,1080,1920,3) k5", 0.014856, "bytes"),
    ("K2 (32,250,250,3)", 0.012917, "bytes"),
    ("K5 f32", 0.105173, "bytes"),
    ("K5 f32 at the UDF's 3 tokens", 0.002800, "bytes"),
    ("K5 bf16", 0.065108, "bytes"),
    # K3 at zamba2's attention past 1024 slots: q (2,1536,32,80) against
    # 1553 slots, causal
    ("K3 f32 at head dim 80", 0.146515, "products"),
    ("K3 bf16 at head dim 80", 0.024444, "products"),
    # K1's general route: 99 taps a pass outlast the image's bytes; a
    # 64-channel map at 5 taps does not
    ("K1 (1,250,250,3) k99", 0.001108, "other"),
    ("K1 (1,224,224,64) k5", 0.007669, "bytes"),
    # K2 at one image, a 1080p frame to 224 (lanczos3), 8 channels, and
    # the 1080p frame to 8 x 8 (lanczos3, windows of 1,440 columns)
    ("K2 (1,250,250,3)", 0.000405, "bytes"),
    ("K2 (1,1080,1920,3) lanczos3", 0.007630, "bytes"),
    ("K2 (4,250,250,8)", 0.004307, "bytes"),
    ("K2 (1,1080,1920,3) lanczos3 to 8x8", 0.007450, "bytes"),
    # K1 at C1's IQ3: one 64x64 face a launch in the remote servers
    ("K1 (1,64,64,3) k5", 0.000029, "bytes"),
    # forward + backward at the training shapes: K3 at qwen3's
    # microbatch (f32) and minicpm's (bf16), 14D a visible pair and head;
    # K3 at zamba2's shared attention (1,4096,32,80) f32; K4 at zamba2's
    # (1,4096,80,64) f32, 14NP a step; K5 at rwkv6's (2,4096,32,64) in
    # bf16 and f32, whose bytes outlast its 14KV a step
    ("K3 fwd+bwd f32 (2,4096,16,8,128)", 2.916084, "products"),
    ("K3 fwd+bwd bf16 (1,4096,36,64)", 0.273659, "products"),
    ("K3 fwd+bwd f32 (1,4096,32,80)", 1.822552, "products"),
    ("K4 fwd+bwd f32 (1,4096,80,64)", 0.114899, "products"),
    ("K5 fwd+bwd bf16 (2,4096,32,64)", 0.120200, "bytes"),
    ("K5 fwd+bwd f32 (2,4096,32,64)", 0.200330, "bytes"),
])
def test_bound_of_each_kernel_row(row, want_ms, want_by):
    got = {
        "K3 f32": lambda: _attn(4, 4096, 4113, 16, 8, 128, 0, 4, F32),
        "K3 f32 at q_offset 3584": lambda: _attn(4, 512, 4113, 16, 8, 128,
                                                 3584, 4, F32),
        "K3 bf16": lambda: _attn(4, 4096, 4113, 16, 8, 128, 0, 2, BF16),
        "K4 f32": lambda: _ssd(16, 512, 80, 64, 1, 64, 4, F32),
        "K4 f32 at G=8": lambda: _ssd(16, 512, 80, 64, 8, 64, 4, F32),
        "K4 bf16": lambda: _ssd(16, 512, 80, 64, 1, 64, 2, BF16),
        "K4 f32 at the UDF's 3 tokens": lambda: _ssd(16, 3, 80, 64, 1, 64,
                                                     4, F32),
        "K1 (32,224,224,3) k9": lambda: _blur((32, 224, 224, 3), 9),
        "K1 (1,224,224,3) k9": lambda: _blur((1, 224, 224, 3), 9),
        "K1 (1,250,250,3) k5": lambda: _blur((1, 250, 250, 3), 5),
        "K1 (1,1080,1920,3) k5": lambda: _blur((1, 1080, 1920, 3), 5),
        "K2 (32,250,250,3)": _preprocess,
        "K5 f32": lambda: _wkv(16, 512, 32, 64, 4, F32),
        "K5 f32 at the UDF's 3 tokens": lambda: _wkv(8, 3, 32, 64, 4, F32),
        "K5 bf16": lambda: _wkv(16, 512, 32, 64, 2, BF16),
        "K3 f32 at head dim 80": lambda: _attn(2, 1536, 1553, 32, 32, 80, 0,
                                               4, F32),
        "K3 bf16 at head dim 80": lambda: _attn(2, 1536, 1553, 32, 32, 80,
                                                0, 2, BF16),
        "K1 (1,250,250,3) k99": lambda: _blur((1, 250, 250, 3), 99),
        "K1 (1,224,224,64) k5": lambda: _blur((1, 224, 224, 64), 5),
        "K2 (1,250,250,3)": lambda: _preprocess((1, 250, 250, 3)),
        "K2 (1,1080,1920,3) lanczos3": lambda: _preprocess(
            (1, 1080, 1920, 3), cs.K2_1080P),
        "K2 (4,250,250,8)": lambda: _preprocess((4, 250, 250, 8)),
        "K2 (1,1080,1920,3) lanczos3 to 8x8": lambda: _preprocess(
            (1, 1080, 1920, 3), cs.K2_WIDE),
        "K1 (1,64,64,3) k5": lambda: _blur((1, 64, 64, 3), 5),
        "K3 fwd+bwd f32 (2,4096,16,8,128)": lambda: _grad(
            cs.attn_grad_work, 2, 4096, 4096, 16, 8, 128, 0, True, 4,
            dtype=F32),
        "K3 fwd+bwd bf16 (1,4096,36,64)": lambda: _grad(
            cs.attn_grad_work, 1, 4096, 4096, 36, 36, 64, 0, True, 2,
            dtype=BF16),
        "K3 fwd+bwd f32 (1,4096,32,80)": lambda: _grad(
            cs.attn_grad_work, 1, 4096, 4096, 32, 32, 80, 0, True, 4,
            dtype=F32),
        "K4 fwd+bwd f32 (1,4096,80,64)": lambda: _grad(
            cs.ssd_grad_work, 1, 4096, 80, 64, 1, 64, 4, dtype=F32),
        "K5 fwd+bwd bf16 (2,4096,32,64)": lambda: _grad(
            cs.wkv_grad_work, 2, 4096, 32, 64, 64, 2, dtype=BF16),
        "K5 fwd+bwd f32 (2,4096,32,64)": lambda: _grad(
            cs.wkv_grad_work, 2, 4096, 32, 64, 64, 4, dtype=F32),
    }[row]()
    assert got[1] == want_by
    assert got[0] == pytest.approx(want_ms, abs=5e-7)


@pytest.mark.parametrize("args,dtype,want_ms,want_nbytes", [
    # qwen3-0.6b's training microbatch (f32, GQA 16/8), minicpm-2b's
    # (bf16, MHA), zamba2-2.7b's shared attention (f32, D 80) and a rank
    # of phase 18's qwen3 step (f32, 4 kv heads): all bound by products
    ((2, 4096, 4096, 16, 8, 128, 0, True, 4), F32, 2.082917, 403701760),
    ((1, 4096, 4096, 36, 36, 64, 0, True, 2), BF16, 0.195471, 152174592),
    ((1, 4096, 4096, 32, 32, 80, 0, True, 4), F32, 1.301823, 336592896),
    ((1, 2048, 2048, 8, 4, 128, 0, True, 4), F32, 0.130214, 50462720),
])
def test_bound_of_the_backward_kernel_alone(args, dtype, want_ms,
                                            want_nbytes):
    """The backward kernel's bound (``attn_bwd_work``: 10D products a
    visible pair and head) at the four shapes its paths give it."""
    nbytes, products, other = cs.attn_bwd_work(*args)
    B, Sq, Sk, H, Hkv, D = args[:6]
    pairs = Sq * (Sq + 1) // 2
    assert products == 10 * pairs * D * H * B and other == 4 * pairs * H * B
    assert nbytes == want_nbytes
    got_ms, by = cs.bound(nbytes, products, other, dtype)
    assert by == "products"
    assert got_ms == pytest.approx(want_ms, abs=5e-7)


def test_blur_bound_of_one_engine_image():
    """The all-native arm blurs one 224x224x3 image a launch: its bytes,
    read once and written once in float32."""
    nbytes, flops = cs.blur_work((1, 224, 224, 3), 9)
    assert nbytes == 1_204_224
    assert flops == 4 * 9 * 224 * 224 * 3


def test_products_are_priced_at_the_tensor_core_rate():
    """The same work is bound three ways: by bytes, by products at the
    type's tensor-core rate, by other operations at the fp32 rate."""
    assert cs.bound(3.35e12, 0, 0, F32) == (1e3, "bytes")
    assert cs.bound(0, 495e12 / 3, 0, F32) == pytest.approx((1e3, "products"))
    assert cs.bound(0, 989e12, 0, BF16) == pytest.approx((1e3, "products"))
    assert cs.bound(0, 0, 67e12, BF16) == pytest.approx((1e3, "other"))
    # the K3 f32 row's products: 274.9 GFLOP, 4.10 ms at the fp32 FMA rate
    # of the earlier count, 1.67 ms as 3xTF32
    _, products, other = cs.attn_work(4, 4096, 4113, 16, 8, 128, 0, True, 4)
    assert products == pytest.approx(274.9e9, rel=1e-3)
    assert other < products / 100


def test_scans_count_their_products_per_step():
    """SSD's chunked form is exact at any chunk length and its products
    grow with it, so they are counted at length 1: per step C·B and its
    x, the readout and the state update.  WKV6's readout and update are
    products the same way; its decay is not."""
    B, T, H, P, N = 16, 512, 80, 64, 64
    _, products, other = cs.ssd_work(B, T, H, P, 1, N, 4)
    assert products == (2 * N + 2 * P + 4 * N * P) * B * T * H
    assert products == pytest.approx(10.905e9, rel=1e-4)
    # the chunked form at the kernel's 32-step tiles needs more: the
    # causal half of C Bᵀ and its x over 528 pairs a tile
    pairs = 32 * 33 // 2
    tiled = (pairs * 2 * (N + P) + 32 * 4 * N * P) * (T // 32) * B * H
    assert tiled > products
    _, products, other = cs.wkv_work(16, 512, 32, 64, 64, 2)
    assert products == 4 * 64 * 64 * 16 * 512 * 32
    assert other == (64 * 64 + 3 * 64 + 2 * 64) * 16 * 512 * 32


@pytest.mark.parametrize("arch,batch,dtype,tflop,least_ms", [
    ("qwen3-0.6b", 4, F32, 107.674696, 652.573915),
    ("minicpm-2b", 1, BF16, 100.892179, 102.014337),
    ("zamba2-2.7b", 1, F32, 108.258184, 656.110208),
    ("rwkv6-1.6b", 4, BF16, 188.531884, 190.628801),
])
def test_train_step_products_of_each_family(arch, batch, dtype, tflop,
                                            least_ms):
    """A remat training step's products at 4,096 tokens a row (the least
    step times of ``PERF.md`` §5): dense blocks; zamba2's Mamba2 layers,
    their scans (18NP a step: forward, recompute, backward) and its
    shared attention at each of 9 applications; rwkv6's time and channel
    mix and its scans (18KV a step)."""
    from repro_torch.configs import get_arch
    products = cs.train_step_products(get_arch(arch), batch, 4096)
    assert products / 1e12 == pytest.approx(tflop, abs=5e-7)
    assert products / cs.PRODUCT_FLOP_S[dtype] * 1e3 == pytest.approx(
        least_ms, abs=5e-6)


def test_scan_gradients_count_their_products_per_step():
    """Forward 4NP (4KV) and backward 10NP (10KV) a step, with SSD's
    C·B and x terms on both passes."""
    B, T, H, P, N = 1, 4096, 80, 64, 64
    _, products, _ = cs.ssd_grad_work(B, T, H, P, 1, N, 4)
    assert products == (4 * N + 4 * P + 14 * N * P) * B * T * H
    _, fwd, _ = cs.ssd_work(B, T, H, P, 1, N, 4)
    assert products - fwd == (2 * N + 2 * P + 10 * N * P) * B * T * H
    _, products, _ = cs.wkv_grad_work(2, 4096, 32, 64, 64, 2)
    assert products == 14 * 64 * 64 * 2 * 4096 * 32
