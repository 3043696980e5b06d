"""qwen1.5-32b [dense] — QKV bias, MHA.

64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064.
[hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B; hf",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    attention="full",
    train_sharding_overrides={"embed": "data"},  # ZeRO-3: 2D-shard weights + moments
    # hillclimbed: bf16 MHA cache at 32k x 128 is 5.5 TB global (> pod HBM);
    # f8 KV restores feasibility and halves the decode memory term
    serve_cache_dtype="float8_e4m3fn",
)

REDUCED = FULL.replace(
    name="qwen1.5-32b-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    vocab_pad_multiple=64,
)

register(FULL, REDUCED)
