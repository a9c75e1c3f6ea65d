"""Architecture registry of the port: importing this package registers
the configurations it serves (qwen3-0.6b, rwkv6-1.6b)."""
from repro_torch.configs import qwen3_0_6b, rwkv6_1_6b  # noqa: F401
from repro_torch.configs.base import (LATER_SLICES, ModelConfig, get_config,
                                      list_archs)
from repro_torch.configs.shapes import reduce_for_smoke

__all__ = ["LATER_SLICES", "ModelConfig", "get_config", "list_archs",
           "reduce_for_smoke"]
