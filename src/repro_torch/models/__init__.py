"""The model zoo of the port: the decoder-only transformer with attention
layers (dense MLPs or MoE) and RWKV-6 layers, for serving and training:
every arch of ``repro_torch.configs.list_archs()``."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
