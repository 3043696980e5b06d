"""internvl2-1b [vlm] — InternViT frontend (STUB) + Qwen2-0.5B-like LM.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
[arXiv:2404.16821; hf]  The vision tower is a stub per the assignment:
``input_specs()`` supplies precomputed patch embeddings (already projected
to d_model) which are prepended to the token embeddings.
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821; hf",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,  # Qwen2 backbone uses QKV bias
    frontend="vit_stub",
    num_patches=256,
    attention="full",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

REDUCED = FULL.replace(
    name="internvl2-1b-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    num_patches=8,
    vocab_pad_multiple=64,
)

register(FULL, REDUCED)
