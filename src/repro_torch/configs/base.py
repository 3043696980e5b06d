"""Architecture and input-shape configuration.

One ``ArchConfig`` per ported architecture lives in
``repro_torch/configs/<id>.py`` with the *exact* published dimensions;
each also provides a reduced same-family config for CPU tests.  The
fields are those of the JAX package's ``ArchConfig``, so a config reads
the same in both packages.

Every assigned architecture of the JAX package is ported:
``zamba2-2.7b`` (hybrid), ``qwen3-0.6b``, ``minicpm-2b``, ``granite-8b``
and ``qwen1.5-32b`` (dense), ``rwkv6-1.6b`` (ssm, the rwkv family),
``granite-moe-1b-a400m`` and ``qwen3-moe-235b-a22b`` (moe),
``whisper-small`` (audio, the encoder-decoder) and ``internvl2-1b``
(vlm, the ``vit_stub`` frontend).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional


def pad_to(x: int, multiple: int) -> int:
    return int(math.ceil(x / multiple) * multiple)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An input-shape cell: ``train_*`` runs ``train_step``,
    ``prefill_*`` the prefill half of serving, ``decode_*`` / ``long_*``
    ``serve_step`` (one new token against a cache of ``seq_len``)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""

    # trunk dims
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0          # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    pos_scheme: str = "rope"  # rope | sinusoidal | none
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # depth-scaled residual (MiniCPM "scale_depth"); 0 disables
    scale_depth: float = 0.0
    # mup-style embedding/logit scaling (MiniCPM); 1.0 disables
    scale_emb: float = 1.0
    dim_model_base: int = 0  # for MiniCPM logit scaling; 0 disables

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.001

    # SSM (Mamba2)
    ssm_state: int = 0
    mamba_expand: int = 2
    mamba_head_dim: int = 64
    mamba_conv_width: int = 4
    mamba_ngroups: int = 1

    # RWKV6
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    rwkv_mix_lora: int = 32

    # hybrid (zamba2): shared attention block applied every N trunk layers,
    # cycling over `num_shared_blocks` weight-tied blocks.
    shared_attn_every: int = 0
    num_shared_blocks: int = 2

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1_500

    # modality frontend stubs
    frontend: str = "none"  # none | vit_stub | audio_stub
    num_patches: int = 0

    # attention flavour for long-context applicability
    attention: str = "full"  # full | none (ssm) | hybrid

    # per-arch logical-rule overrides (meshes arrive with the
    # distribution slice; carried as data so configs stay identical)
    sharding_overrides: Optional[Mapping[str, Any]] = None
    train_sharding_overrides: Optional[Mapping[str, Any]] = None
    prefill_sharding_overrides: Optional[Mapping[str, Any]] = None

    # vocab padding multiple for TP-divisible embedding shards
    vocab_pad_multiple: int = 512

    # serving KV/state-cache dtype
    serve_cache_dtype: str = "bfloat16"

    # ---- derived -----------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, self.vocab_pad_multiple)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mamba_nheads(self) -> int:
        return self.mamba_d_inner // self.mamba_head_dim

    @property
    def rwkv_nheads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def supports_shape(self, shape: ShapeConfig) -> tuple[bool, str]:
        """Whether a cell (arch x shape) runs, and the reason if not (the
        JAX package's rule): ``long_500k`` needs sub-quadratic sequence
        mixing, so the full-attention archs skip it."""
        if shape.name == "long_500k" and self.attention == "full":
            return False, ("full O(L^2) attention infeasible at 524288; "
                           "skipped by design")
        return True, ""

    def param_count(self) -> int:
        """Analytic parameter count (embedding included, unpadded vocab):
        the JAX package's formula, approximate for rwkv (it leaves out
        ``c_r`` and the LoRAs) and for the encoder-decoder (it counts the
        GELU MLP as three matrices and leaves out biases and norms), kept
        so that the configs stay equal."""
        d, hd = self.d_model, self.resolved_head_dim
        qdim = self.num_heads * hd
        kvdim = self.num_kv_heads * hd
        attn = d * qdim + 2 * d * kvdim + qdim * d  # q,k,v,o
        if self.qkv_bias:
            attn += qdim + 2 * kvdim
        mlp = 3 * d * self.d_ff  # gate/up/down (SwiGLU)
        if self.family == "ssm" and self.name.startswith("rwkv"):
            # time-mix: r,k,v,g,o ~ 5 d^2 + decay lora; channel-mix ~ 2*d*ff
            total = self.num_layers * (5 * d * d + 2 * d * self.d_ff)
        elif self.family == "hybrid":
            di = self.mamba_d_inner
            mamba_l = d * (2 * di + 2 * self.mamba_ngroups * self.ssm_state
                           + self.mamba_nheads) + di * d
            total = self.num_layers * mamba_l
            # shared blocks (weight-tied): count once each
            total += self.num_shared_blocks * (attn + mlp)
        elif self.is_moe:
            expert = 3 * d * self.d_ff
            router = d * self.num_experts
            total = self.num_layers * (attn + self.num_experts * expert
                                       + router)
        else:
            total = self.num_layers * (attn + mlp)
        if self.is_encoder_decoder:
            # encoder self-attn+mlp, decoder gets extra cross-attn
            total += self.num_encoder_layers * (attn + mlp)
            total += self.num_layers * attn  # cross-attention
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(total)

    def active_param_count(self) -> int:
        """Parameters one token touches: of a MoE, only its top-k
        experts (the JAX package's formula)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        hd = self.resolved_head_dim
        attn = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d)
        expert = 3 * d * self.d_ff
        router = d * self.num_experts
        total = self.num_layers * (attn + self.num_experts_per_tok * expert
                                   + router)
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(total)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# registry ------------------------------------------------------------
_REGISTRY: dict[str, "ArchEntry"] = {}


@dataclasses.dataclass
class ArchEntry:
    full: ArchConfig
    reduced: ArchConfig


def register(full: ArchConfig, reduced: ArchConfig) -> ArchConfig:
    _REGISTRY[full.name] = ArchEntry(full=full, reduced=reduced)
    return full


def get_arch(name: str, reduced: bool = False) -> ArchConfig:
    import repro_torch.configs as _c  # noqa: F401  (triggers registration)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    e = _REGISTRY[name]
    return e.reduced if reduced else e.full


def list_archs() -> list[str]:
    import repro_torch.configs as _c  # noqa: F401

    return sorted(_REGISTRY)
