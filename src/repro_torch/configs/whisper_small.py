"""whisper-small [audio] — encoder-decoder; conv frontend is a STUB.

12L (enc) + 12L (dec) d_model=768 12H (kv=12) d_ff=3072 vocab=51865.
[arXiv:2212.04356; unverified]  ``input_specs()`` supplies precomputed
mel-frame embeddings (post conv-frontend, 1500 x d_model) per the
assignment; positions are sinusoidal so arbitrary cache lengths lower.
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="whisper-small",
    family="audio",
    source="arXiv:2212.04356; unverified",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    is_encoder_decoder=True,
    num_encoder_layers=12,
    encoder_seq_len=1500,
    frontend="audio_stub",
    pos_scheme="sinusoidal",
    attention="full",
    norm_eps=1e-5,
)

REDUCED = FULL.replace(
    name="whisper-small-reduced",
    num_layers=2,
    num_encoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    encoder_seq_len=32,
    vocab_pad_multiple=64,
)

register(FULL, REDUCED)
