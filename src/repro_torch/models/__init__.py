"""The model zoo of the port: the decoder-only transformer with
attention and dense MLPs (qwen3-0.6b), for serving."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
