"""Input checks shared by the kernels' launch wrappers."""
from __future__ import annotations

import torch


def expect(t: torch.Tensor, name: str, dtypes, shape, device) -> None:
  """Raise ValueError unless ``t`` is a contiguous tensor of one of
  ``dtypes`` and of ``shape`` on ``device``."""
  if t.device != device:
    raise ValueError(f"{name} is on {t.device}, not {device}")
  if t.dtype not in dtypes:
    raise ValueError(f"{name}: expected {dtypes}, got {t.dtype}")
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                     f"{tuple(t.shape)}")
  if not t.is_contiguous():
    raise ValueError(f"{name} must be contiguous")
