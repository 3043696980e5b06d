"""Architecture configs, one per assigned architecture.  Importing this package registers
them with ``repro_torch.configs.base``; select one with
``get_arch("<id>")``.
"""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    ShapeConfig,
    get_arch,
    list_archs,
)

# registration side-effects — one module per ported architecture
from repro_torch.configs import (  # noqa: F401
    zamba2_2p7b,
    internvl2_1b,
    qwen3_0p6b,
    minicpm_2b,
    granite_8b,
    qwen1p5_32b,
    rwkv6_1p6b,
    qwen3_moe_235b_a22b,
    granite_moe_1b_a400m,
    whisper_small,
)

ALL_ARCHS = [
    "zamba2-2.7b",
    "internvl2-1b",
    "qwen3-0.6b",
    "minicpm-2b",
    "granite-8b",
    "qwen1.5-32b",
    "rwkv6-1.6b",
    "qwen3-moe-235b-a22b",
    "granite-moe-1b-a400m",
    "whisper-small",
]
