"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8, qk_norm.

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936.
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B; hf",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    num_experts_per_tok=8,
    qk_norm=True,
    rope_theta=1_000_000.0,
    attention="full",
    # hillclimbed (EXPERIMENTS.md section Perf): ZeRO-3 dense weights + EP on
    # the TP axis with ZeRO-sharded expert storage — collective term 9x down
    train_sharding_overrides={"embed": "data", "experts": "model",
                              "expert_ff": "data"},
    prefill_sharding_overrides={"experts": "model", "expert_ff": "data"},
)

REDUCED = FULL.replace(
    name="qwen3-moe-235b-a22b-reduced",
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
