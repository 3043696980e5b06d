"""The flash-attention backward kernel's launch geometry, on the CPU.

``csrc/flash_attention_bwd.cu`` cannot run here, so what decides which
(key, query) pairs it visits is mirrored in Python beside its wrapper
(``flash_attention.backward_walks`` and ``backward_tiles``): per key
block of the dK/dV pass (128 keys in bfloat16, 64 in float32), the
first q tile and the walk; per q block of the dQ pass, the key tiles;
and the skipping of tiles past the causal edge by each unit of fixed
rows (a consumer warpgroup of 64).  Over random ``(Sq, Sk, q_offset,
causal)``, every head dim and both routes, each pass's tiles must cover
every visible pair (``work.visible_pairs`` counts them) and no tile may
lie wholly past the causal edge.  The float32 route's pre-pass images
are mirrored too (``split_tf32``, ``image_index``, ``backward_image``,
``backward_scratch_floats``): the split is exact, the layout a
bijection the mirror inverts.  The arithmetic itself is held on the
card (``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import work


def _visible(Sq, Sk, q_offset, causal):
    """(Sk, Sq) booleans: key j seen by query row i."""
    keys = np.arange(Sk)[:, None]
    rows = np.arange(Sq)[None, :]
    return keys <= q_offset + rows if causal else np.ones((Sk, Sq), bool)


def _cases():
    rng = np.random.default_rng(26)
    cases = [(1, 300, 299, True, 128), (1, 300, 0, True, 64),
             (100, 1000, 500, True, 64), (77, 900, 400, True, 128),
             (300, 700, 0, False, 32), (150, 70, 0, False, 80),
             (256, 256, 0, True, 16), (129, 129, 0, True, 80),
             (40, 130, 17, True, 16),
             # a key block whose first query is the last row of a q tile
             (300, 400, 1, True, 64), (200, 300, 97, True, 128)]
    for _ in range(16):
        Sq = int(rng.integers(1, 600))
        causal = bool(rng.integers(0, 2))
        q_offset = int(rng.integers(0, 400)) if causal else 0
        Sk = int(rng.integers(1, 900)) if not causal else \
            int(rng.integers(1, q_offset + Sq + 200))
        D = int(rng.choice(fa.HEAD_DIMS))
        cases.append((Sq, Sk, q_offset, causal, D))
    return cases


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,Sk,q_offset,causal,D", _cases())
def test_backward_tiles_cover_every_visible_pair_and_none_past_the_edge(
        Sq, Sk, q_offset, causal, D, dtype):
    visible = _visible(Sq, Sk, q_offset, causal)
    assert int(visible.sum()) == work.visible_pairs(Sq, Sk, q_offset,
                                                    causal)
    covered = {"dkdv": np.zeros_like(visible), "dq": np.zeros_like(visible)}
    for kind, keys, rows in fa.backward_tiles(Sq, Sk, q_offset, causal, D,
                                              dtype):
        assert len(keys if kind == "dkdv" else rows) <= fa.bwd_unit_rows(
            dtype)
        tile = visible[keys.start:keys.stop, rows.start:rows.stop]
        assert tile.size and tile.any(), (kind, keys, rows)
        covered[kind][keys.start:keys.stop, rows.start:rows.stop] = True
    for kind, seen in covered.items():
        assert not (visible & ~seen).any(), kind


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,Sk,q_offset,causal,D", _cases()[:11])
def test_backward_walks_start_at_the_causal_edge(Sq, Sk, q_offset, causal,
                                                 D, dtype):
    """A key block's walk starts at the q tile of its first key's first
    query and runs to Sq; a block no query sees walks nothing (its dK
    and dV are written as zeros); a q block walks the key tiles up to
    its last row's causal edge."""
    W, R = fa.bwd_walk_rows(D, dtype), fa.bwd_fixed_rows(dtype)
    Wq = fa.bwd_walk_rows(D, dtype, keys=False)
    keys, queries = fa.backward_walks(Sq, Sk, q_offset, causal, D, dtype)
    assert len(keys) == -(-Sk // R)
    assert len(queries) == -(-Sq // R)
    for kb, (start, n) in enumerate(keys):
        k0 = kb * R
        first = max(0, k0 - q_offset) if causal else 0
        if first >= Sq:
            assert n == 0
        else:
            assert start * W <= first < (start + 1) * W
            assert (start + n) * W >= Sq > (start + n - 1) * W
    for qb, n in enumerate(queries):
        last = min(Sq, (qb + 1) * R) - 1
        end = min(Sk, q_offset + last + 1) if causal else Sk
        assert n * Wq >= end > (n - 1) * Wq


def test_backward_wrapper_takes_only_cuda_tensors():
    """No fallback inside the wrapper: a CPU tensor raises (the Function
    routes CPU tensors to ``flash_backward`` before it)."""
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_backward_cuda(q, q, q, q, torch.zeros(1, 8, 2), q)


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_the_routes_tile_as_their_kernels_do(D):
    """The geometry each route's kernel is built with
    (``csrc/flash_attention_bwd.cu``: ``TfCfg`` and ``WgCfg``, reported by
    ``repro_flash_attention_backward_geometry`` and held against the
    built library on the card): 64 fixed rows in float32, walk tiles of
    64 rows but 32 in the dK/dV pass at D >= 80; 128 fixed rows in
    bfloat16, walk tiles of 128 rows at D <= 64 and 64 beyond, in both
    passes; a warpgroup of 64 rows the skipping unit of both.  The
    float32 numbers are also read from the source."""
    assert (fa.bwd_fixed_rows(torch.float32),
            fa.bwd_fixed_rows(torch.bfloat16)) == (64, 128)
    assert fa.bwd_walk_rows(D, torch.float32) == (32 if D >= 80 else 64)
    assert fa.bwd_walk_rows(D, torch.float32, keys=False) == 64
    for keys in (True, False):
        assert fa.bwd_walk_rows(D, torch.bfloat16, keys) == (
            128 if D <= 64 else 64)
    assert (fa.bwd_unit_rows(torch.float32),
            fa.bwd_unit_rows(torch.bfloat16)) == (64, 64)
    src = (Path(fa.__file__).parent / "csrc" / "flash_attention_bwd.cu"
           ).read_text()
    cfg = src[src.index("struct TfCfg {"):]
    cfg = cfg[:cfg.index("};")]
    assert int(re.search(r"int R = (\d+);", cfg).group(1)) == \
        fa.bwd_fixed_rows(torch.float32)
    w = re.search(r"int W = KEYS && D >= (\d+) \? (\d+) : (\d+);", cfg)
    for keys in (True, False):
        assert (int(w.group(2)) if keys and D >= int(w.group(1))
                else int(w.group(3))) == fa.bwd_walk_rows(D, torch.float32,
                                                          keys)
    assert int(re.search(r"constexpr int TILE = (\d+);", src).group(1)) == \
        fa.IMAGE_TILE
    assert int(re.search(r"constexpr int PIECE_F = (\d+);", src).group(1)) \
        == fa.IMAGE_PIECE == 2 * fa.IMAGE_TILE * fa.IMAGE_CHUNK


def _floats(rng, n):
    """Random normals, and tiny, subnormal, huge and exact values: zeros,
    powers of two, the largest finite floats (whose rounding to TF32
    would carry into infinity), values just past a TF32 tie."""
    x = np.concatenate([
        rng.standard_normal(n).astype(np.float32),
        (rng.standard_normal(n) * 1e-40).astype(np.float32),
        (rng.standard_normal(n) * 1e30).astype(np.float32),
        np.array([0.0, -0.0, 1.0, -2.0, 2.0 ** -126, 2.0 ** -149, 1e-45,
                  3.4028235e38, -3.4028235e38, 3.4e38, 1 + 2.0 ** -11,
                  1 + 3 * 2.0 ** -12, -(1 + 2.0 ** -11), 65504.0],
                 dtype=np.float32)])
    return torch.from_numpy(x)


def test_split_tf32_is_exact_with_big_in_tf32():
    """big + small == x bit for bit over random, tiny, subnormal and huge
    finite floats; big has its low 13 bits clear (a TF32 value) and is
    the nearest TF32 value (ties away from zero) but where that rounding
    would overflow; small is at most half a TF32 step of x."""
    x = _floats(np.random.default_rng(30), 20_000)
    big, small = fa.split_tf32(x)
    assert torch.equal((big + small).view(torch.int32), x.view(torch.int32))
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(torch.isfinite(big).all() and torch.isfinite(small).all())
    # a TF32 step of x: 2^-10 of its leading bit, 2^-136 for subnormals
    step = torch.ldexp(torch.ones_like(x),
                       torch.clamp(torch.frexp(x)[1] - 11, min=-136))
    near = x.abs() < 3.4e38   # rounding to TF32 stays finite
    assert bool((small[near].abs() <= step[near] / 2).all())
    assert bool((small[~near].abs() < step[~near]).all())
    assert bool((big[~near].abs() <= x[~near].abs()).all())
    assert int((~near).sum()) >= 3


@pytest.mark.parametrize("transposed", [False, True])
def test_image_index_is_a_bijection_the_mirror_inverts(transposed):
    """Each half of a piece takes each of its 2,048 floats once; an
    operand through :func:`backward_image` and back through
    :func:`image_operand` is the operand bit for bit, at ragged lengths
    and at every head dim (16 and 80 padded to 32 and 96 columns with
    zeros); the transposed layout holds each group of 8 sequence rows in
    the order 0, 2, 4, 6, 1, 3, 5, 7 along K."""
    idx = fa.image_index(transposed)
    assert torch.equal(idx.sort().values, torch.arange(2048))
    rng = np.random.default_rng(31)
    for S, D in ((1, 16), (77, 80), (64, 128), (130, 32), (200, 64)):
        x = torch.from_numpy(rng.standard_normal((2, S, 3, D)).astype(
            np.float32))
        img = fa.backward_image(x, transposed)
        nt, nc = -(-S // 64), -(-D // 32)
        assert img.shape == (2, 3, nt, nc, 2, 2048)
        assert torch.equal(fa.image_operand(img, S, D, transposed), x)
        # the padding is zeros: the image holds x's floats and nothing else
        assert int((img != 0).sum()) <= 2 * int((x != 0).sum())
    if transposed:
        # K position 8s + j of atom column 0, head-dim row 0: sequence row
        # 8s + (0, 2, 4, 6, 1, 3, 5, 7)[j]
        order = [idx[fa._swizzle(0, f)].item() for f in range(8)]
        assert order == [0, 2, 4, 6, 1, 3, 5, 7]
    else:
        assert [idx[fa._swizzle(r, 5)].item() for r in range(8)] == \
            [r * 32 + 5 for r in range(8)]


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D", [
    (2, 4096, 4096, 16, 8, 128), (1, 1, 300, 4, 2, 16),
    (1, 77, 900, 4, 4, 80), (3, 130, 70, 6, 3, 32)])
def test_backward_scratch_is_the_images(B, Sq, Sk, H, Hkv, D):
    """The float32 route's scratch is its seven images (four of q's side,
    three of k's) and the (lse log2e, delta) pairs of every q row of the
    tiles, as :func:`backward_image` shapes them; the bfloat16 route's is
    delta (B, Sq, H)."""
    q = torch.empty(B, Sq, H, D, device="meta")
    k = torch.empty(B, Sk, Hkv, D, device="meta")
    nq = fa.backward_image(q).numel()
    nk = fa.backward_image(k).numel()
    assert nq == fa.backward_image(q, True).numel()
    assert fa.backward_scratch_floats(B, Sq, Sk, H, Hkv, D, torch.float32) \
        == 4 * nq + 3 * nk + B * H * -(-Sq // 64) * 64 * 2
    assert fa.backward_scratch_floats(B, Sq, Sk, H, Hkv, D,
                                      torch.bfloat16) == B * Sq * H
