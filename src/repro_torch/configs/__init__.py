"""Architecture registry of the port: importing this package registers
the configurations it serves, every one of the reference's
(``ALL_ARCHS``, the reference's tuple): qwen3-0.6b, rwkv6-1.6b, slice
8a's olmo-1b, granite-34b, minitron-4b, mixtral-8x22b, qwen2-moe-a2.7b
and pixtral-12b, and slice 8b's jamba-1.5-large and whisper-base."""
from repro_torch.configs import (granite_34b, jamba_1_5_large,  # noqa: F401
                                 minitron_4b, mixtral_8x22b, olmo_1b,
                                 pixtral_12b, qwen2_moe_a2_7b, qwen3_0_6b,
                                 rwkv6_1_6b, whisper_base)
from repro_torch.configs.base import ModelConfig, get_config, list_archs
from repro_torch.configs.shapes import reduce_for_smoke

ALL_ARCHS = (
    "olmo-1b", "granite-34b", "qwen3-0.6b", "minitron-4b", "mixtral-8x22b",
    "qwen2-moe-a2.7b", "jamba-1.5-large", "whisper-base", "rwkv6-1.6b",
    "pixtral-12b",
)

__all__ = ["ALL_ARCHS", "ModelConfig", "get_config", "list_archs",
           "reduce_for_smoke"]
