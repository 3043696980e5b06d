"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay.

24L d_model=2048 d_ff=7168 vocab=65536.  [arXiv:2404.05892; unverified]
Time-mix (WKV6) state is (heads, head_k, head_v) per sequence — decode is
O(1) in sequence length, so all long-context cells run.
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    source="arXiv:2404.05892; unverified",
    num_layers=24,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,
    rwkv_decay_lora=64,
    rwkv_mix_lora=32,
    attention="none",
    pos_scheme="none",
)

REDUCED = FULL.replace(
    name="rwkv6-1.6b-reduced",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    rwkv_head_dim=16,
    rwkv_decay_lora=16,
    rwkv_mix_lora=8,
    vocab_pad_multiple=64,
)

register(FULL, REDUCED)
