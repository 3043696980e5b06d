"""granite-moe-1b-a400m [moe] — 32 experts, top-8.

24L d_model=1024 16H (GQA kv=8) expert d_ff=512 vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    num_experts=32,
    num_experts_per_tok=8,
    tie_embeddings=True,
    attention="full",
    # hillclimbed EP layout (same rationale as qwen3-moe; section Perf)
    train_sharding_overrides={"experts": "model", "expert_ff": "data"},
    prefill_sharding_overrides={"experts": "model", "expert_ff": "data"},
)

REDUCED = FULL.replace(
    name="granite-moe-1b-a400m-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=64,
    vocab_size=512,
    num_experts=8,
    num_experts_per_tok=2,
    moe_capacity_factor=4.0,  # no-drop in reduced tests
    vocab_pad_multiple=64,
)

register(FULL, REDUCED)
