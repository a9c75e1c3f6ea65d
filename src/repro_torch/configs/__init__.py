"""Architecture registry of the port: importing this package registers
the configurations it serves (qwen3-0.6b, rwkv6-1.6b, and slice 8a's
olmo-1b, granite-34b, minitron-4b, mixtral-8x22b, qwen2-moe-a2.7b and
pixtral-12b).  ``ALL_ARCHS`` is the reference's tuple, the two that come
with slice 8b included."""
from repro_torch.configs import (granite_34b, minitron_4b,  # noqa: F401
                                 mixtral_8x22b, olmo_1b, pixtral_12b,
                                 qwen2_moe_a2_7b, qwen3_0_6b, rwkv6_1_6b)
from repro_torch.configs.base import (LATER_SLICES, ModelConfig, get_config,
                                      list_archs)
from repro_torch.configs.shapes import reduce_for_smoke

ALL_ARCHS = (
    "olmo-1b", "granite-34b", "qwen3-0.6b", "minitron-4b", "mixtral-8x22b",
    "qwen2-moe-a2.7b", "jamba-1.5-large", "whisper-base", "rwkv6-1.6b",
    "pixtral-12b",
)

__all__ = ["ALL_ARCHS", "LATER_SLICES", "ModelConfig", "get_config",
           "list_archs", "reduce_for_smoke"]
