"""The flash-attention backward kernel's launch geometry, on the CPU.

``csrc/flash_attention_bwd.cu`` cannot run here, so what decides which
(key, query) pairs it visits is mirrored in Python beside its wrapper
(``flash_attention.backward_walks`` and ``backward_tiles``): per
128-key block of the dK/dV pass, the first q tile and the walk; per
128-row q block of the dQ pass, the key tiles; and the skipping of
tiles past the causal edge by each unit of fixed rows (a warp of the
float32 route, a warpgroup of the bfloat16 route, whose walk tiles are
wider too).  Over random ``(Sq, Sk, q_offset, causal)``, every head dim
and both routes, each pass's tiles must cover every visible pair
(``work.visible_pairs`` counts them) and no tile may lie wholly past
the causal edge.  The arithmetic itself is held on the card
(``tests/test_torch_cuda.py``).
"""
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
    W = fa.bwd_walk_rows(D, dtype)
    keys, queries = fa.backward_walks(Sq, Sk, q_offset, causal, D, dtype)
    assert len(keys) == -(-Sk // fa.BWD_ROWS)
    assert len(queries) == -(-Sq // fa.BWD_ROWS)
    for kb, (start, n) in enumerate(keys):
        k0 = kb * fa.BWD_ROWS
        first = max(0, k0 - q_offset) if causal else 0
        if first >= Sq:
            assert n == 0
        else:
            assert start * W <= first < (start + 1) * W
            assert (start + n) * W >= Sq > (start + n - 1) * W
    for qb, n in enumerate(queries):
        last = min(Sq, (qb + 1) * fa.BWD_ROWS) - 1
        end = min(Sk, q_offset + last + 1) if causal else Sk
        assert n * W >= end > (n - 1) * W


def test_backward_wrapper_takes_only_cuda_tensors():
    """No fallback inside the wrapper: a CPU tensor raises (the Function
    routes CPU tensors to ``flash_backward`` before it)."""
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_backward_cuda(q, q, q, q, torch.zeros(1, 8, 2), q)


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_the_routes_tile_as_their_kernels_do(D):
    """The geometry each route's kernel is built with
    (``csrc/flash_attention_bwd.cu``: ``Cfg`` and ``WgCfg``, reported by
    ``repro_flash_attention_backward_geometry`` and held against the
    built library on the card): 128 fixed rows in both; walk tiles of
    64 rows in float32 (32 at D 128), of 128 rows in bfloat16 at D <= 64
    and 64 beyond; warps of 16 rows and warpgroups of 64."""
    assert fa.BWD_ROWS == 128
    assert fa.bwd_walk_rows(D, torch.float32) == (32 if D == 128 else 64)
    assert fa.bwd_walk_rows(D, torch.bfloat16) == (128 if D <= 64 else 64)
    assert (fa.bwd_unit_rows(torch.float32),
            fa.bwd_unit_rows(torch.bfloat16)) == (16, 64)
