"""granite-8b [dense] — llama-arch code model.

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
[arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="granite-8b",
    family="dense",
    source="arXiv:2405.04324; hf",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=10_000_000.0,
    attention="full",
    train_sharding_overrides={"embed": "data"},  # ZeRO-3: 2D-shard weights + moments
)

REDUCED = FULL.replace(
    name="granite-8b-reduced",
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
