"""The port's per-op cost counter (``repro_torch.launch.costs``), the
counterpart of ``tests/test_hlo_costs.py``: FLOPs of a product chain,
the collective bytes of ``ShardingCtx``'s collectives under a ``fake``
process group, the live-bytes peak, and the kernels' ``meta`` routes
(shapes and dtypes of the CPU route forward and backward, one launch
of exactly their work formula each, and no route for other devices).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_vjp
from repro_torch.kernels import ops as kops
from repro_torch.kernels import work
from repro_torch.launch import costs

M, K, N, P = 16, 24, 32, 8


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_product_chain_flops_equal_the_hand_count(device):
    x = torch.ones((M, K), device=device)
    w1, w2 = torch.ones((K, N), device=device), torch.ones((N, P),
                                                           device=device)
    b = torch.ones((4, M, K), device=device)
    with costs.CostCounter() as c:
        y = torch.tanh(x @ w1) @ w2
        z = torch.bmm(b, w1.expand(4, K, N))
        torch.nn.functional.linear(x, w1.t())
    assert c.flops == 2 * M * K * N + 2 * M * N * P + 4 * 2 * M * K * N \
        + 2 * M * K * N
    assert y.shape == (M, P) and z.shape == (4, M, N)
    assert c.collective_bytes == 0 and c.kernel_breakdown == {}


def test_hbm_bytes_are_operands_and_results_of_data_moving_ops():
    a = torch.empty((64, 32), device="meta")
    b = torch.empty((64, 32), device="meta")
    with costs.CostCounter() as c:
        s = a + b                  # reads 2, writes 1
        v = s.view(32, 64).t()     # views move nothing
        s.copy_(a)                 # overwrites s: reads a, writes s
        torch.empty_like(v)        # an allocation moves nothing
    assert c.hbm_bytes == 64 * 32 * 4 * (3 + 2)


def test_live_bytes_peak_follows_storages_and_their_views():
    n = 1024
    a = torch.empty(n, device="meta")
    c = costs.CostCounter()
    c.track({"a": a, "again": [a, a.view(2, n // 2)]})
    assert c.live_bytes == c.peak_bytes == 4 * n
    with c:
        b = a * 2
        v = b.view(2, n // 2)      # same storage as b
        del b
        d = v + 1                  # a, b (through v) and d live
        del v
        e = d * 3                  # b freed with its last view
        del d, e
    assert c.peak_bytes == 3 * 4 * n
    assert c.live_bytes == 4 * n


def test_collective_bytes_of_the_sharding_collectives_by_kind():
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_host_mesh
    with fake_group(4):
        sh = ShardingCtx(mesh=make_host_mesh(model=4))
        assert sh.axis("model").nccl      # a fake group takes NCCL's route
        x = torch.empty((2, 8, 16), device="meta", requires_grad=True)
        nb = 2 * 8 * 16 * 4
        with costs.CostCounter() as c:
            r = sh.reduce(x)
        assert dict(c.collective_breakdown) == {"all_reduce": nb}
        assert r.shape == x.shape
        with costs.CostCounter() as c:
            g = sh.gather(x, -1, summed=True)
        assert dict(c.collective_breakdown) == {"all_gather": nb}
        assert g.shape == (2, 8, 64)
        with costs.CostCounter() as c:
            (gx,) = torch.autograd.grad(g, x, torch.empty_like(g))
        # the gather's backward: the reduce-scatter of the full gradient
        assert dict(c.collective_breakdown) == {"reduce_scatter": 4 * nb}
        assert gx.shape == x.shape
        with costs.CostCounter() as c:
            out = sh.axis("model").reduce_scatter(g.detach(), 1)
        assert dict(c.collective_breakdown) == {"reduce_scatter": 4 * nb}
        assert out.shape == (2, 2, 64)


# ------------------------------------------------------ the meta routes
def _attn(dtype, Sq=40, Sk=40, H=4, Hkv=2, D=16, q_offset=0, causal=True):
    def mk(shape):
        return torch.randn(shape).to(dtype)
    q, k, v = mk((2, Sq, H, D)), mk((2, Sk, Hkv, D)), mk((2, Sk, Hkv, D))

    def run(*t):
        return flash_vjp.flash_attention(*t, q_offset, causal, None, 16, 16)
    cost = work.attn_work(2, Sq, Sk, H, Hkv, D, q_offset, causal,
                          q.element_size())
    return "flash_attention", run, (q, k, v), cost


def _ssd(dtype, T=24, H=4, P=8, G=2, N=8):
    x = torch.randn((2, T, H, P)).to(dtype)
    dt = torch.rand((2, T, H)) * 0.5
    A = -torch.rand(H)
    Bm, Cm = (torch.randn((2, T, G, N)).to(dtype) for _ in range(2))
    D = torch.rand(H)

    def run(*t):
        return kops.mamba2_ssd(*t, chunk=8)
    cost = work.ssd_work(2, T, H, P, G, N, x.element_size())
    return "mamba2_ssd", run, (x, dt, A, Bm, Cm, D), cost


def _wkv(dtype, T=24, H=2, K=8):
    r, k, v = (torch.randn((2, T, H, K)).to(dtype) for _ in range(3))
    w = torch.rand((2, T, H, K)) * 0.5 + 0.4
    u = torch.randn((H, K)) * 0.1

    def run(*t):
        return kops.rwkv6_scan(*t, chunk=8)
    cost = work.wkv_work(2, T, H, K, K, r.element_size())
    return "rwkv6_scan", run, (r, k, v, w, u), cost


CASES = [(make, dtype) for make in (_attn, _ssd, _wkv)
         for dtype in (torch.float32, torch.bfloat16)]


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _forward_backward(run, inputs):
    leaves = [t.detach().requires_grad_(t.is_floating_point())
              for t in inputs]
    outs = _outputs(run(*leaves))
    loss = sum(o.float().sum() for o in outs)
    grads = torch.autograd.grad(loss, [t for t in leaves if t.requires_grad])
    return outs, grads


def _layout(ts):
    return [(tuple(t.shape), t.dtype) for t in ts]


@pytest.mark.parametrize("make,dtype", CASES)
def test_meta_route_gives_the_cpu_route_shapes_forward_and_backward(make,
                                                                    dtype):
    torch.manual_seed(0)
    _, run, inputs, _ = make(dtype)
    outs, grads = _forward_backward(run, inputs)
    meta = [t.to("meta") for t in inputs]
    m_outs, m_grads = _forward_backward(run, meta)
    assert all(t.is_meta for t in list(m_outs) + list(m_grads))
    assert _layout(m_outs) == _layout(outs)
    assert _layout(m_grads) == _layout(grads)


@pytest.mark.parametrize("make,dtype", CASES)
def test_meta_route_records_one_launch_of_its_work_formula(make, dtype):
    name, run, inputs, (nbytes, products, _) = make(dtype)
    meta = [t.to("meta") for t in inputs]
    with costs.CostCounter() as c:
        run(*meta)
    assert c.kernel_breakdown == {
        name: {"launches": 1, "flops": products, "bytes": nbytes}}
    # no plain version ran: the kernel's products are all the FLOPs
    assert c.flops == products
    # on the CPU the plain route runs and nothing is recorded
    with costs.CostCounter() as c:
        run(*inputs)
    assert c.kernel_breakdown == {} and c.flops > 0


@pytest.mark.parametrize("q_dtype,kv_dtype,wide", [
    (torch.float8_e4m3fn, torch.bfloat16, torch.bfloat16),
    (torch.float8_e4m3fn, torch.float8_e4m3fn, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.float32)])
def test_meta_flash_route_runs_mixed_dtypes_in_the_wider(q_dtype, kv_dtype,
                                                         wide):
    """Mixed operands (float8 parameters' queries against a bfloat16
    cache, as the hillclimb's float8 variants give) run the kernel in
    the wider type, a float8 counting as bfloat16; the output keeps the
    queries' type, as the reference's ``astype(q.dtype)``."""
    name, run, (q, k, v), _ = _attn(torch.float32)
    meta = (q.to("meta", q_dtype), k.to("meta", kv_dtype),
            v.to("meta", kv_dtype))
    with costs.CostCounter() as c:
        out = run(*meta)
    nbytes, products, _ = work.attn_work(2, 40, 40, 4, 2, 16, 0, True,
                                         wide.itemsize)
    assert c.kernel_breakdown == {
        name: {"launches": 1, "flops": products, "bytes": nbytes}}
    assert out.dtype == q_dtype and out.shape == q.shape


def test_meta_flash_route_counts_only_the_visible_pairs():
    name, run, inputs, _ = _attn(torch.float32, Sq=8, Sk=40, q_offset=32)
    with costs.CostCounter() as c:
        run(*[t.to("meta") for t in inputs])
    pairs = sum(33 + i for i in range(8))
    assert c.kernel_breakdown[name]["flops"] == 4 * pairs * 16 * 4 * 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_flash_backward_records_one_launch_of_its_work_formula(dtype):
    """On meta tensors the Function's backward is one launch of the
    backward kernel's work (``work.attn_bwd_work``) beside the forward's
    one launch: no plain einsum block runs, so the two kernels' products
    are all the FLOPs; the gradients have the inputs' shapes and dtypes.
    On the CPU the plain backward runs and records nothing."""
    _, run, inputs, (f_bytes, f_products, _) = _attn(dtype)
    meta = [t.to("meta") for t in inputs]
    with costs.CostCounter() as c:
        _, grads = _forward_backward(run, meta)
    b_bytes, b_products, _ = work.attn_bwd_work(2, 40, 40, 4, 2, 16, 0, True,
                                                dtype.itemsize)
    assert c.kernel_breakdown == {
        "flash_attention": {"launches": 1, "flops": f_products,
                            "bytes": f_bytes},
        "flash_attention_backward": {"launches": 1, "flops": b_products,
                                     "bytes": b_bytes}}
    assert c.flops == f_products + b_products
    assert _layout(grads) == _layout(inputs)
    with costs.CostCounter() as c:
        _forward_backward(run, inputs)
    assert c.kernel_breakdown == {} and c.flops > 0


def test_meta_flash_backward_counts_only_the_visible_pairs():
    """A prefill of 8 rows at offset 32 into 40 keys: 10D products per
    visible pair and head; the keys past the causal edge read for no
    pair, but dk and dv written for all 40."""
    _, run, inputs, _ = _attn(torch.float32, Sq=8, Sk=40, q_offset=32)
    with costs.CostCounter() as c:
        _forward_backward(run, [t.to("meta") for t in inputs])
    row = c.kernel_breakdown["flash_attention_backward"]
    pairs = sum(33 + i for i in range(8))
    assert row["flops"] == 10 * pairs * 16 * 4 * 2
    assert row["bytes"] == ((4 * 8 * 4 + 2 * (40 + 40) * 2) * 16 * 2 * 4
                            + 2 * 2 * 8 * 4 * 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_meta_wkv_backward_records_one_launch_of_its_work_formula(
        dtype, with_state):
    """On meta tensors the WKV6 Function's backward is one launch of the
    backward kernel's work (``work.wkv_bwd_work``, with the initial state
    and the final state's cotangent when present) beside the forward's
    one launch: no plain chunked form runs, so the two kernels' products
    are all the FLOPs; the gradients have the inputs' shapes and dtypes.
    On the CPU the plain backward runs and records nothing."""
    _, run, inputs, (f_bytes, f_products, _) = _wkv(dtype)
    if with_state:
        inputs = inputs + (torch.randn((2, 2, 8, 8)) * 0.1,)
    meta = [t.to("meta") for t in inputs]
    with costs.CostCounter() as c:
        _, grads = _forward_backward(run, meta)
    b_bytes, b_products, _ = work.wkv_bwd_work(2, 24, 2, 8, 8, dtype.itemsize,
                                               with_state, True)
    assert c.kernel_breakdown == {
        "rwkv6_scan": {"launches": 1, "flops": f_products, "bytes": f_bytes},
        "rwkv6_scan_backward": {"launches": 1, "flops": b_products,
                                "bytes": b_bytes}}
    assert c.flops == f_products + b_products
    assert _layout(grads) == _layout(inputs)
    with costs.CostCounter() as c:
        _forward_backward(run, inputs)
    assert c.kernel_breakdown == {} and c.flops > 0


def test_wkv_backward_work_at_the_training_shape():
    """rwkv6-1.6b's training microbatch (2 x 4,096, 32 heads of 64) in
    bfloat16, y's cotangent only: r, k, v, dy read and dr, dk, dv written
    in bfloat16, w read and dw written in float32 (369.1 MB, 0.110 ms at
    3.35 TB/s); 10KV products a step (10.7 GFLOP)."""
    nbytes, products, other = work.wkv_bwd_work(2, 4096, 32, 64, 64, 2)
    elems = 2 * 4096 * 32 * 64
    assert nbytes == 7 * elems * 2 + 2 * elems * 4 + 2 * 32 * 64 * 4
    assert products == 10 * 64 * elems
    assert other == (64 * 64 + 6 * 64 + 4 * 64) * 2 * 4096 * 32
    with_states = work.wkv_bwd_work(2, 4096, 32, 64, 64, 2, True, True)[0]
    assert with_states - nbytes == 3 * 2 * 32 * 64 * 64 * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_meta_ssd_backward_records_one_launch_of_its_work_formula(
        dtype, with_state):
    """On meta tensors the SSD Function's backward is one launch of the
    backward kernel's work (``work.ssd_bwd_work``, with the initial state
    when present; a sum of both outputs gives the final state a
    cotangent) beside the forward's one launch: the chunked form is not
    recomputed op by op, so the two kernels' products are all the FLOPs;
    the gradients have the inputs' shapes and dtypes.  On the CPU the
    plain backward runs and records nothing."""
    _, run, inputs, (f_bytes, f_products, _) = _ssd(dtype)
    if with_state:
        inputs = inputs + (torch.randn((2, 4, 8, 8)) * 0.1,)
    meta = [t.to("meta") for t in inputs]
    with costs.CostCounter() as c:
        _, grads = _forward_backward(run, meta)
    b_bytes, b_products, _ = work.ssd_bwd_work(2, 24, 4, 8, 2, 8,
                                               dtype.itemsize, with_state,
                                               True)
    assert c.kernel_breakdown == {
        "mamba2_ssd": {"launches": 1, "flops": f_products, "bytes": f_bytes},
        "mamba2_ssd_backward": {"launches": 1, "flops": b_products,
                                "bytes": b_bytes}}
    assert c.flops == f_products + b_products
    assert _layout(grads) == _layout(inputs)
    with costs.CostCounter() as c:
        _forward_backward(run, inputs)
    assert c.kernel_breakdown == {} and c.flops > 0


def test_ssd_backward_work_at_the_training_shape():
    """zamba2-2.7b's training microbatch (1 x 4,096, 80 heads of 64, one
    group of state 64), y's cotangent only: x, dy read and dx written,
    B, C read and dB, dC written by group, in their type; dt read and ddt
    written, A, D read and dA, dD written in float32 (258.5 MB in
    float32, 130.5 MB in bfloat16: 0.077 and 0.039 ms at 3.35 TB/s);
    2N + 2P + 10NP products a step (13.5 GFLOP: 0.082 ms at 495/3 TF/s),
    the backward half of ``ssd_grad_work``'s."""
    steps, elems, grouped = 4096 * 80, 4096 * 80 * 64, 4096 * 64
    for itemsize in (4, 2):
        nbytes, products, other = work.ssd_bwd_work(1, 4096, 80, 64, 1, 64,
                                                    itemsize)
        assert nbytes == (3 * elems + 4 * grouped) * itemsize \
            + 2 * steps * 4 + 4 * 80 * 4
        assert products == (2 * 64 + 2 * 64 + 10 * 64 * 64) * steps
        assert other == (3 + 7 * 64 + 64 * 64) * steps
    _, grad_products, _ = work.ssd_grad_work(1, 4096, 80, 64, 1, 64, 4)
    _, fwd_products, _ = work.ssd_work(1, 4096, 80, 64, 1, 64, 4)
    assert products == grad_products - fwd_products
    assert round(products / 1e9, 1) == 13.5
    with_states = work.ssd_bwd_work(1, 4096, 80, 64, 1, 64, 4, True, True)[0]
    assert with_states - work.ssd_bwd_work(1, 4096, 80, 64, 1, 64, 4)[0] \
        == 3 * 80 * 64 * 64 * 4


@pytest.mark.parametrize("q_dtype,kv_dtype,wide", [
    (torch.float8_e4m3fn, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.float32)])
def test_meta_flash_backward_runs_mixed_dtypes_in_the_wider(q_dtype,
                                                            kv_dtype, wide):
    """The mixed-dtype backward runs the kernel in the forward's wider
    type (a float8 counting as bfloat16) and returns each gradient in its
    input's dtype."""
    _, run, (q, k, v), _ = _attn(torch.float32)
    meta = (q.to("meta", q_dtype), k.to("meta", kv_dtype),
            v.to("meta", kv_dtype))
    with costs.CostCounter() as c:
        _, grads = _forward_backward(run, meta)
    nbytes, products, _ = work.attn_bwd_work(2, 40, 40, 4, 2, 16, 0, True,
                                             wide.itemsize)
    assert c.kernel_breakdown["flash_attention_backward"] == {
        "launches": 1, "flops": products, "bytes": nbytes}
    assert [g.dtype for g in grads] == [q_dtype, kv_dtype, kv_dtype]


@pytest.mark.parametrize("sq,sk,off,causal", [
    (1, 1, 0, True), (7, 7, 0, True), (8, 40, 32, True), (8, 40, 35, True),
    (40, 8, 0, True), (5, 9, 2, True), (6, 11, 0, False)])
def test_visible_pairs_closed_form_equals_the_row_sum(sq, sk, off, causal):
    want = (sum(min(sk, off + i + 1) for i in range(sq)) if causal
            else sq * sk)
    assert work.visible_pairs(sq, sk, off, causal) == want


class _Elsewhere(torch.Tensor):
    """A tensor on a device with neither a kernel nor a plain path."""

    @staticmethod
    def __new__(cls, t):
        return torch.Tensor._make_wrapper_subclass(
            cls, t.shape, dtype=t.dtype, device=torch.device("xla"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} ran on a tensor with no route")


@pytest.mark.parametrize("make", [_attn, _ssd, _wkv])
def test_a_tensor_on_another_device_raises(make):
    _, run, inputs, _ = make(torch.float32)
    with pytest.raises(ValueError, match="no kernel and no plain path"):
        run(*[_Elsewhere(t) for t in inputs])
    if make is _attn:
        with pytest.raises(ValueError, match="no kernel and no plain path"):
            kops.flash_attention(*[_Elsewhere(t) for t in inputs])


def test_image_kernels_have_no_meta_route():
    img = torch.empty((1, 16, 16, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel and no plain path"):
        kops.gaussian_blur(img, 5, 1.5)
    with pytest.raises(ValueError, match="no kernel and no plain path"):
        kops.fused_preprocess(img, resize_h=8, resize_w=8, crop_x=0,
                              crop_y=0, crop_w=8, crop_h=8)


def test_one_copy_of_the_rates_serves_the_bounds():
    import chip_smoke
    assert chip_smoke.PRODUCT_FLOP_S is work.PRODUCT_FLOP_S
    assert chip_smoke.attn_work is work.attn_work
    assert work.PEAK_FLOPS == 989e12 and work.HBM_BYTES_S == 3.35e12
    assert np.isclose(work.PRODUCT_FLOP_S["torch.float32"], 495e12 / 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_flash_backward_holds_its_scratch_live(dtype):
    """The meta backward holds the scratch its wrapper allocates live
    beside dq, dk and dv while it records the launch: the float32
    route's pre-pass images (``backward_scratch_floats``, about 3.5
    times the operands' bytes), the bfloat16 route's delta.  The peak is
    their sum; the scratch is gone after; the work recorded is
    ``work.attn_bwd_work``, which the images do not change."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, H, Hkv, D = 2, 40, 70, 4, 2, 80
    q, out, do = (torch.empty((B, Sq, H, D), dtype=dtype, device="meta")
                  for _ in range(3))
    k, v = (torch.empty((B, Sk, Hkv, D), dtype=dtype, device="meta")
            for _ in range(2))
    lse = torch.empty((B, Sq, H), device="meta")
    with costs.CostCounter() as c:
        grads = fa.flash_attention_backward_meta(q, k, v, out, lse, do)
    scratch = 4 * fa.backward_scratch_floats(B, Sq, Sk, H, Hkv, D, dtype)
    held = sum(g.numel() * g.element_size() for g in grads)
    assert c.peak_bytes == held + scratch
    assert c.live_bytes == held
    if dtype == torch.float32:
        assert scratch > 3.5 * 4 * (2 * q.numel() + 2 * k.numel())
    nbytes, products, _ = work.attn_bwd_work(B, Sq, Sk, H, Hkv, D, 0, True,
                                             dtype.itemsize)
    assert c.kernel_breakdown == {"flash_attention_backward": {
        "launches": 1, "flops": products, "bytes": nbytes}}
