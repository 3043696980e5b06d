"""qwen3-0.6b [dense] — qk_norm, GQA.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936 head_dim=128.
[hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    source="hf:Qwen/Qwen3-8B; hf",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    attention="full",
    tie_embeddings=True,
)

REDUCED = FULL.replace(
    name="qwen3-0.6b-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    vocab_pad_multiple=64,
)

register(FULL, REDUCED)
