"""minicpm-2b [dense] — llama-like with mup-style depth/width scaling; WSD schedule.

40L d_model=2304 36H (kv=36, MHA) d_ff=5760 vocab=122753.
[arXiv:2404.06395; hf]  scale_emb=12, scale_depth=1.4, dim_model_base=256;
trained with the Warmup-Stable-Decay schedule (training/optimizer.py).
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="minicpm-2b",
    family="dense",
    source="arXiv:2404.06395; hf",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    scale_depth=1.4,
    scale_emb=12.0,
    dim_model_base=256,
    tie_embeddings=True,
    attention="full",
)

REDUCED = FULL.replace(
    name="minicpm-2b-reduced",
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
