"""FlashAttention forward CUDA kernel (``csrc/flash_attention.cu``) on
Hopper's tensor cores; the operand type picks the route.

- bfloat16: ``wgmma``.  One CTA per (128-row q tile, head, batch): a
  producer warp keeps 128-key tiles of K and V in flight by TMA, two
  warpgroups of 64 rows take ``S = Q Kᵀ`` with both operands in shared
  memory, then ``P`` (rounded to bf16) from registers against V.  At
  head dim 80 the tiles are padded to 128 columns, which TMA fills with
  zeros past column 80.
- float32: ``mma.sync`` in 3xTF32 (each operand split into two halves
  rounded to TF32, about 22 bits of it).  One CTA per (64-row q tile, head, batch),
  four warps of 16 rows, 64-key tiles (32 at D = 128) staged by
  ``cp.async``.

Both walk double-buffered key tiles up to the causal edge, with the
running max, sum and output in registers, masked with the finite
``-1e30`` of the JAX package's ``flash_vjp`` (padded keys and, when
causal, keys past
``q_offset + row``).  GQA reads kv head ``h // (H/Hkv)``; q, k and v go
in through their batch and sequence strides, which with the base
pointers must be 16-byte aligned (:func:`_build.strided` copies
otherwise).  The kernel also writes the log-sum-exp ``lse`` (B, Sq, H)
for the recomputing backward.  The plain version is
:func:`repro_torch.kernels.ref.flash_attention_chunked`.

The recomputing backward (``csrc/flash_attention_bwd.cu``,
:func:`flash_attention_backward_cuda`) takes q, k, v, the forward's
output and log-sum-exp and the output's cotangent, and returns dq, dk
and dv in their dtype.  Two deterministic passes: a dQ pass (one CTA per
q block and head, walking key tiles; ``delta = rowsum(dO·O)`` is
written before it) and a dK/dV pass (one CTA per key block and kv head,
walking the q tiles of its G heads that can see the block).  Both run on
``wgmma``, fed walk tiles by TMA from producer warps:

- bfloat16: 128 fixed rows, two consumer warpgroups of 64; the dQ pass
  writes delta.
- float32, in 3xTF32: Hopper's tf32 ``wgmma`` reads its shared-memory
  operands K-major only, so a pre-pass (a third launch) writes each
  operand once as images (:func:`backward_image`): both TF32 halves
  (:func:`split_tf32`), in the kernel's swizzled pieces, and Q, dO and K
  also transposed with the sequence permuted in groups of 8; it writes
  delta too.  Each pass then holds 64 fixed rows a CTA, and two consumer
  warpgroups take the walk's tiles in turn, each fed piece by piece
  through its own ring, their partial gradients summed in a fixed order
  at the end.  The images take :func:`backward_scratch_floats` floats
  (about 3.5 times the operands'), which the wrapper allocates.  What
  bounds it is the products (14D a visible pair and head, three TF32
  products each).

:func:`backward_walks` and :func:`backward_tiles` give each route's launch
geometry, which the built library reports (:func:`backward_geometry`).
The plain version is :func:`repro_torch.kernels.flash_vjp.flash_backward`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, work

launches = _build.LaunchCounter("flash_attention")
backward_launches = _build.LaunchCounter("flash_attention_backward")

HEAD_DIMS = (16, 32, 64, 80, 128)   # the kernel's compiled head sizes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_build.declare("flash_attention", "flash_attention.cu", {
    "repro_flash_attention": [ctypes.c_int] + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_longlong] * 6
    + [ctypes.c_void_p]})
_build.declare("flash_attention_backward", "flash_attention_bwd.cu", {
    "repro_flash_attention_backward": [ctypes.c_int] + [ctypes.c_void_p] * 10
    + [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_longlong] * 10
    + [ctypes.c_void_p],
    "repro_flash_attention_backward_geometry": [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
    "repro_flash_attention_backward_scratch": [ctypes.c_int] * 7
    + [ctypes.POINTER(ctypes.c_longlong)],
    "repro_flash_attention_backward_tf32_probe": [ctypes.c_void_p] * 5})

IMAGE_TILE = 64      # rows of a float32 image tile
IMAGE_CHUNK = 32     # head-dim columns of a piece (128 bytes)
IMAGE_PIECE = 4096   # floats of a piece: two halves of 64 x 32


def bwd_fixed_rows(dtype) -> int:
    """Rows of the backward kernel's fixed tile: 128 in bfloat16 (64 for
    each of two consumer warpgroups), 64 in float32 (both consumer
    warpgroups against the same rows, taking the walk's tiles in turn)."""
    return 128 if dtype == torch.bfloat16 else 64


def bwd_walk_rows(D: int, dtype, keys: bool = True) -> int:
    """Rows of the backward kernel's walk tiles at head dim ``D`` in the
    dK/dV pass (``keys``) or the dQ pass: the bfloat16 route's, the same in
    both; the float32 route's, 64 but 32 in the dK/dV pass at D >= 80."""
    if dtype == torch.bfloat16:
        return 64 if D >= 80 else 128
    return 32 if keys and D >= 80 else 64


def bwd_unit_rows(dtype) -> int:
    """Fixed rows of the unit that skips a walk tile past the causal edge:
    a consumer warpgroup of 64, in both routes."""
    return 64


def backward_scratch_floats(batch, Sq, Sk, H, Hkv, D, dtype) -> int:
    """Float32 scratch the backward's route for ``dtype`` takes, as
    ``repro_flash_attention_backward_scratch`` computes it: bfloat16, delta
    (B, Sq, H); float32, the pre-pass's images, four of q's side (Q and dO,
    natural and transposed) and three of k's (K, V, K transposed), each
    (B, heads, 64-row tiles, 32-column chunks) pieces of 4,096 floats, and
    (lse log2e, delta) of each q row of the tiles."""
    if dtype != torch.float32:
        return batch * Sq * H
    nc = -(-D // IMAGE_CHUNK)
    tq, tk = -(-Sq // IMAGE_TILE), -(-Sk // IMAGE_TILE)
    return (4 * batch * H * tq * nc * IMAGE_PIECE
            + 3 * batch * Hkv * tk * nc * IMAGE_PIECE
            + batch * H * tq * IMAGE_TILE * 2)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` (float32) as two halves with ``big + small == x`` exactly,
    as the pre-pass writes them (``tc::split_exact``): big rounded to the
    nearest TF32 value (ties away from zero; truncated where rounding
    would carry into infinity's exponent), its low 13 bits clear; small
    the rest (a zero with x's sign), which a TF32 product reads truncated
    to its top 19 bits."""
    u = x.contiguous().view(torch.int32)
    r = (u + 0x1000) & -0x2000
    r = torch.where((r & 0x7F800000) == 0x7F800000, u & -0x2000, r)
    big = r.view(torch.float32)
    small = x - big
    return big, torch.where(small == 0, torch.copysign(
        torch.zeros_like(small), x), small)


def _swizzle(r, f):
    """Float offset of (row r, float f) in a 128-byte swizzled half: the
    16-byte chunk f // 4 moved to f // 4 xor r % 8."""
    return r * 32 + ((f // 4) ^ (r % 8)) * 4 + f % 4


@functools.lru_cache(maxsize=2)
def image_index(transposed: bool) -> torch.Tensor:
    """Where each float of a half of an image piece comes from (a
    permutation of 2,048): natural, the flat (row, column) of the piece's
    64 x 32 block; transposed, the flat (column, row) of its 32 x 64
    block, in two atom columns of 32 sequence rows, those stored 0, 2, 4,
    6, 1, 3, 5, 7 in each group of 8 (the k order in which the kernel
    passes an accumulator to the A operand)."""
    idx = torch.empty(2048, dtype=torch.long)
    if not transposed:
        r, f = torch.meshgrid(torch.arange(64), torch.arange(32), indexing="ij")
        idx[_swizzle(r, f).flatten()] = (r * 32 + f).flatten()
    else:
        kc, rr, pos = torch.meshgrid(torch.arange(2), torch.arange(32),
                                     torch.arange(32), indexing="ij")
        s = pos % 8
        row = kc * 32 + pos - s + torch.where(s < 4, 2 * s, 2 * s - 7)
        idx[(kc * 1024 + _swizzle(rr, pos)).flatten()] = (rr * 64 + row).flatten()
    return idx


def backward_image(x: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    """The float32 route's pre-pass image of ``x`` (B, S, heads, D), the
    plain version of what ``fa_bwd_prep`` writes: (B, heads, T, NC, 2,
    2048) float32, T tiles of 64 rows, NC chunks of 32 head-dim columns,
    big then small halves (:func:`split_tf32`), each half laid out by
    :func:`image_index`; rows past S and columns past D zero."""
    B, S, Hx, D = x.shape
    nc, nt = -(-D // IMAGE_CHUNK), -(-S // IMAGE_TILE)
    X = torch.zeros(B, Hx, nt * IMAGE_TILE, nc * IMAGE_CHUNK,
                    dtype=torch.float32, device=x.device)
    X[:, :, :S, :D] = x.float().permute(0, 2, 1, 3)
    X = X.view(B, Hx, nt, IMAGE_TILE, nc, IMAGE_CHUNK)
    order = (0, 1, 2, 4, 5, 3) if transposed else (0, 1, 2, 4, 3, 5)
    flat = X.permute(*order).reshape(B, Hx, nt, nc, 2048)
    big, small = split_tf32(flat[..., image_index(transposed).to(x.device)])
    return torch.stack((big, small), dim=4)


def image_operand(img: torch.Tensor, S: int, D: int,
                  transposed: bool = False) -> torch.Tensor:
    """The inverse of :func:`backward_image`: (B, S, heads, D) from an
    image, each float put back from where :func:`image_index` took it, big
    + small."""
    B, Hx, nt, nc = img.shape[:4]
    flat = torch.empty_like(img[..., 0, :])
    flat[..., image_index(transposed).to(img.device)] = img[..., 0, :] + \
        img[..., 1, :]
    if transposed:
        X = flat.view(B, Hx, nt, nc, IMAGE_CHUNK, IMAGE_TILE).permute(
            0, 1, 2, 5, 3, 4)
    else:
        X = flat.view(B, Hx, nt, nc, IMAGE_TILE, IMAGE_CHUNK).permute(
            0, 1, 2, 4, 3, 5)
    X = X.reshape(B, Hx, nt * IMAGE_TILE, nc * IMAGE_CHUNK)[:, :, :S, :D]
    return X.permute(0, 2, 1, 3)


def backward_geometry(lib, D: int, dtype) -> tuple[int, int, int, int]:
    """The built backward library's own fixed rows, dK/dV walk rows,
    skipping unit and dQ walk rows at head dim ``D`` for ``dtype``'s
    route, which :func:`bwd_fixed_rows`, :func:`bwd_walk_rows` and
    :func:`bwd_unit_rows` must equal."""
    out = (ctypes.c_int * 4)()
    _build.check(lib.repro_flash_attention_backward_geometry(
        _DTYPES[dtype], D, out), "flash_attention_backward geometry")
    return tuple(out)


def flash_attention_cuda(
    q: torch.Tensor,    # (B, Sq, H, D) float32 | bfloat16, on CUDA
    k: torch.Tensor,    # (B, Sk, Hkv, D), q's dtype
    v: torch.Tensor,    # (B, Sk, Hkv, D), q's dtype
    *,
    q_offset: int = 0,
    causal: bool = True,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the flash-attention kernel on the current CUDA stream.
    Returns ``out`` (B, Sq, H, D) in q's dtype and ``lse`` (B, Sq, H) in
    float32.  Query row i sits at position ``q_offset + i``."""
    if not q.is_cuda:
        raise ValueError("flash_attention_cuda takes CUDA tensors, got q on "
                         f"{q.device}")
    _build.refuse_grad("flash_attention (call it through "
                       "flash_vjp.flash_attention for a gradient)", q, k, v)
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16 q, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k and v must have q's dtype {q.dtype}, got "
                        f"{k.dtype} and {v.dtype}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"expected q (B,Sq,H,D) and k (B,Sk,Hkv,D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    batch, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (batch, Sk, Hkv, D) or v.shape != k.shape:
        raise ValueError("flash_attention_cuda: inconsistent shapes")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"kv heads Hkv={Hkv} must divide heads H={H}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if batch > 65535 or H > 65535:
        raise ValueError(f"batch {batch} or heads {H} exceed the grid's 65535")
    scale = float(sm_scale if sm_scale is not None else D ** -0.5)
    out = torch.empty((batch, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((batch, Sq, H), dtype=torch.float32, device=q.device)
    if batch == 0 or Sq == 0:
        return out, lse
    if Sk == 0:
        raise ValueError("flash_attention_cuda needs at least one key")
    q, k, v = (_build.strided(t, D) for t in (q, k, v))
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), batch, Sq, Sk, H, Hkv, D,
            q_offset, int(bool(causal)), scale, *_build.outer(q),
            *_build.outer(k), *_build.outer(v), stream)
    _build.check(err, "flash_attention")
    launches.add()
    return out, lse


def flash_attention_meta(q, k, v, *, q_offset: int = 0, causal: bool = True,
                         sm_scale: float | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's route for ``meta`` tensors: ``out`` and ``lse`` of
    :func:`flash_attention_cuda`'s shapes and dtypes, no values, and one
    launch of the kernel's work (:func:`work.attn_work`) in the active
    cost counter, where the card would launch it.  An operand on
    another device raises, as the CUDA wrapper's does."""
    for name, t in (("k", k), ("v", v)):
        if not t.is_meta:
            raise ValueError(f"{name} is on {t.device}, q on meta")
    batch, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if batch and Sq:
        nbytes, products, _ = work.attn_work(batch, Sq, Sk, H, Hkv, D,
                                              int(q_offset), causal,
                                              q.element_size())
        work.record_kernel("flash_attention", nbytes, products)
    return (torch.empty((batch, Sq, H, D), dtype=q.dtype, device="meta"),
            torch.empty((batch, Sq, H), dtype=torch.float32, device="meta"))


def backward_walks(Sq, Sk, q_offset, causal, D, dtype):
    """The backward kernel's grid and walks for ``dtype``'s route, as
    ``csrc/flash_attention_bwd.cu`` computes them.  ``keys``: for each
    key block (:func:`bwd_fixed_rows`) of the dK/dV pass, its first q
    tile (from the causal start ``max(0, k0 - q_offset)``, tile 0 when
    not causal) and the number of q tiles it walks for each q head of
    its kv head (0 when no query sees the block); ``queries``: for each q
    block of the dQ pass, the number of key tiles it walks (up to the
    causal edge of its last row)."""
    W, R = bwd_walk_rows(D, dtype), bwd_fixed_rows(dtype)
    keys = []
    for k0 in range(0, Sk, R):
        first = max(0, k0 - q_offset) if causal else 0
        start = first // W
        keys.append((start, -(-Sq // W) - start if first < Sq else 0))
    W = bwd_walk_rows(D, dtype, keys=False)
    queries = []
    for q0 in range(0, Sq, R):
        rows = min(R, Sq - q0)
        end = min(Sk, q_offset + q0 + rows) if causal else Sk
        queries.append(-(-end // W))
    return keys, queries


def backward_tiles(Sq, Sk, q_offset, causal, D, dtype):
    """Every (keys, queries) rectangle a unit of the backward kernel
    (:func:`bwd_unit_rows`: a consumer warpgroup) computes,
    for one head: ``("dkdv" | "dq", key range, query range)`` for each
    unit's rows against each tile of its CTA's walk that the unit does
    not skip (rows all past Sk or Sq, or all before the tile's causal
    edge)."""
    W, U = bwd_walk_rows(D, dtype), bwd_unit_rows(dtype)
    R = bwd_fixed_rows(dtype)
    keys, queries = backward_walks(Sq, Sk, q_offset, causal, D, dtype)
    for kb, (start, n) in enumerate(keys):
        for x0 in range(kb * R, (kb + 1) * R, U):
            for i0 in range(start * W, (start + n) * W, W):
                if x0 < Sk and (not causal
                                or x0 <= q_offset + min(i0 + W, Sq) - 1):
                    yield ("dkdv", range(x0, min(x0 + U, Sk)),
                           range(i0, min(i0 + W, Sq)))
    W = bwd_walk_rows(D, dtype, keys=False)
    for qb, n in enumerate(queries):
        for x0 in range(qb * R, (qb + 1) * R, U):
            for k0 in range(0, n * W, W):
                if x0 < Sq and (not causal
                                or k0 <= q_offset + min(x0 + U, Sq) - 1):
                    yield ("dq", range(k0, min(k0 + W, Sk)),
                           range(x0, min(x0 + U, Sq)))


def flash_attention_backward_cuda(
    q: torch.Tensor,     # (B, Sq, H, D) float32 | bfloat16, on CUDA
    k: torch.Tensor,     # (B, Sk, Hkv, D), q's dtype
    v: torch.Tensor,     # (B, Sk, Hkv, D), q's dtype
    out: torch.Tensor,   # (B, Sq, H, D), the forward's output, q's dtype
    lse: torch.Tensor,   # (B, Sq, H) float32, the forward's log-sum-exp
    do: torch.Tensor,    # (B, Sq, H, D), out's cotangent, q's dtype
    *,
    q_offset: int = 0,
    causal: bool = True,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the recomputing backward on the current CUDA stream (the
    dQ pass, then the dK/dV pass; in float32 the pre-pass before them,
    into a scratch of :func:`backward_scratch_floats`).  Returns ``(dq, dk,
    dv)`` in q's dtype; dk and dv are 0 for keys no query sees.  Query
    row i sits at position ``q_offset + i``."""
    if not q.is_cuda:
        raise ValueError("flash_attention_backward_cuda takes CUDA tensors, "
                         f"got q on {q.device}")
    _build.refuse_grad("flash_attention_backward (no double backward)",
                       q, k, v, out, do)
    for name, t in (("k", k), ("v", v), ("out", out), ("lse", lse),
                    ("do", do)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16 q, got {q.dtype}")
    for name, t in (("k", k), ("v", v), ("out", out), ("do", do)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must have q's dtype {q.dtype}, got "
                            f"{t.dtype}")
    if lse.dtype != torch.float32:
        raise TypeError(f"lse must be float32, got {lse.dtype}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"expected q (B,Sq,H,D) and k (B,Sk,Hkv,D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    batch, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if (tuple(k.shape) != (batch, Sk, Hkv, D) or v.shape != k.shape
            or out.shape != q.shape or do.shape != q.shape
            or tuple(lse.shape) != (batch, Sq, H)):
        raise ValueError("flash_attention_backward_cuda: inconsistent shapes")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"kv heads Hkv={Hkv} must divide heads H={H}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if batch > 65535 or H > 65535:
        raise ValueError(f"batch {batch} or heads {H} exceed the grid's 65535")
    scale = float(sm_scale if sm_scale is not None else D ** -0.5)
    dev = q.device
    dq = torch.empty((batch, Sq, H, D), dtype=q.dtype, device=dev)
    dk = torch.empty((batch, Sk, Hkv, D), dtype=q.dtype, device=dev)
    dv = torch.empty((batch, Sk, Hkv, D), dtype=q.dtype, device=dev)
    if batch == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    if Sk == 0:
        raise ValueError("flash_attention_backward_cuda needs at least one key")
    q, k, v, out, do = (_build.strided(t, D) for t in (q, k, v, out, do))
    lse = lse.contiguous()
    scratch = torch.empty(backward_scratch_floats(batch, Sq, Sk, H, Hkv, D,
                                                  q.dtype),
                          dtype=torch.float32, device=dev)
    lib = _build.load("flash_attention_backward")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_flash_attention_backward(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), batch, Sq, Sk, H,
            Hkv, D, q_offset, int(bool(causal)), scale, *_build.outer(q),
            *_build.outer(k), *_build.outer(v), *_build.outer(out),
            *_build.outer(do), stream)
    _build.check(err, "flash_attention_backward")
    backward_launches.add()
    return dq, dk, dv


def flash_attention_backward_meta(q, k, v, out, lse, do, *, q_offset: int = 0,
                                  causal: bool = True,
                                  sm_scale: float | None = None
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """The backward's route for ``meta`` tensors: dq, dk and dv of
    :func:`flash_attention_backward_cuda`'s shapes and dtypes, no values,
    the float32 scratch its wrapper allocates (:func:`backward_scratch_floats`:
    delta in bfloat16, the pre-pass's images in float32) live beside them,
    and one launch of the kernel's work (:func:`work.attn_bwd_work`) in
    the active cost counter.  An operand on another device raises."""
    for name, t in (("k", k), ("v", v), ("out", out), ("lse", lse),
                    ("do", do)):
        if not t.is_meta:
            raise ValueError(f"{name} is on {t.device}, q on meta")
    batch, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    grads = tuple(torch.empty(t.shape, dtype=q.dtype, device="meta")
                  for t in (q, k, v))
    if batch and Sq:
        scratch = torch.empty(backward_scratch_floats(batch, Sq, Sk, H, Hkv,
                                                      D, q.dtype),
                              dtype=torch.float32, device="meta")
        nbytes, products, _ = work.attn_bwd_work(batch, Sq, Sk, H, Hkv, D,
                                                 int(q_offset), causal,
                                                 q.element_size())
        work.record_kernel("flash_attention_backward", nbytes, products)
        del scratch
    return grads
