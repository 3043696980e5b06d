"""Host-side logic of ``chip_smoke.py`` that a host without a card can
check: which kernels ``--ab`` compares by default, and the attention
mask behind K3's library time at a cache offset.

Tolerance: the masked ``scaled_dot_product_attention`` against the plain
flash forward, 1e-5 absolute (the same float32 softmax over the same
products, as ``tests/test_torch_kernels.py`` holds attention routes).
"""
import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke as cs
from repro_torch.kernels import _build, ref


def _copy_csrc(tmp_path):
    old = tmp_path / "old_csrc"
    shutil.copytree(_build.CSRC, old)
    return old


def test_ab_compares_no_kernel_of_identical_sources(tmp_path):
    assert cs.changed_kernels(_copy_csrc(tmp_path)) == []


@pytest.mark.parametrize("edit,want", [
    ("rwkv6_scan.cu", ["rwkv6_scan"]),
    ("gaussian_blur.cu", ["gaussian_blur"]),
    # the shared header: every kernel that includes it
    ("tc.cuh", ["flash_attention", "mamba2_ssd", "rwkv6_scan"]),
    ("preprocess.cu", ["preprocess"]),
])
def test_ab_compares_the_kernels_whose_sources_differ(tmp_path, edit, want):
    import repro_torch.kernels.flash_attention  # noqa: F401  (declares)
    import repro_torch.kernels.gaussian_blur  # noqa: F401
    import repro_torch.kernels.mamba2_ssd  # noqa: F401
    import repro_torch.kernels.preprocess  # noqa: F401
    import repro_torch.kernels.rwkv6_scan  # noqa: F401
    old = _copy_csrc(tmp_path)
    (old / edit).write_text((old / edit).read_text() + "\n// older\n")
    assert sorted(cs.changed_kernels(old)) == want
    (old / edit).unlink()       # a source the old commit lacks differs too
    assert sorted(cs.changed_kernels(old)) == want


@pytest.mark.parametrize("Sq,Sk,q_offset", [(8, 29, 21), (5, 40, 12)])
def test_offset_mask_gives_the_prefill_into_a_cache(Sq, Sk, q_offset):
    rng = np.random.default_rng(Sq + Sk)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, Sq, 4, 16), (2, Sk, 2, 16), (2, Sk, 2, 16)))
    mask = cs.offset_mask(Sq, Sk, q_offset, device="cpu")
    got = F.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in (q, k, v)), attn_mask=mask,
        enable_gqa=True).transpose(1, 2)
    want, _ = ref.flash_attention_chunked(q, k, v, causal=True,
                                          q_offset=q_offset)
    assert float((got - want).abs().max()) <= 1e-5
