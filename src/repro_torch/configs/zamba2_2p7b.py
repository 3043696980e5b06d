"""zamba2-2.7b [hybrid] — Mamba2 trunk + weight-tied shared attention blocks.

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000 ssm_state=64.
[arXiv:2411.15242; hf]  Two shared transformer blocks are applied in
alternation every 6 Mamba2 layers (9 applications over 54 layers).
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242; hf",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    mamba_expand=2,
    mamba_head_dim=64,
    mamba_conv_width=4,
    mamba_ngroups=1,
    shared_attn_every=6,
    num_shared_blocks=2,
    attention="hybrid",
    tie_embeddings=True,
    sharding_overrides={"cache_seq": None, "cache_heads": "model"},
)

REDUCED = FULL.replace(
    name="zamba2-2.7b-reduced",
    num_layers=6,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    ssm_state=16,
    mamba_head_dim=32,
    shared_attn_every=3,
    num_shared_blocks=2,
    vocab_pad_multiple=64,
)

register(FULL, REDUCED)
