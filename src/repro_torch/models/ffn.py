"""Feed-forward block: the dense SwiGLU MLP (the port of
``repro.models.ffn.init_mlp`` / ``apply_mlp``).  MoE comes with slice 8."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (Device, dense_init, frozen,
                                       model_dtype)


def swiglu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
  """``(silu(x @ wg) * (x @ wi)) @ wo``, each weight cast to x's dtype at
  use (a no-op for weights already stored in it)."""
  dt = x.dtype
  h = x @ wi.to(dt)
  g = x @ wg.to(dt)
  return (F.silu(g) * h) @ wo.to(dt)


class MLP(nn.Module):
  """SwiGLU.  Weights are (d_in, d_out), the reference's layout, stored in
  the model dtype, or in ``dtype`` when given (a trainable model's)."""

  def __init__(self, cfg: ModelConfig, d_ff: int, device: Device = None,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    if cfg.mlp_variant != "swiglu":
      raise NotImplementedError(
          f"mlp_variant {cfg.mlp_variant!r} comes with slice 8 of the port")
    d, dt = cfg.d_model, dtype or model_dtype(cfg)
    self.wi = frozen(torch.empty((d, d_ff), dtype=dt, device=device))
    self.wg = frozen(torch.empty((d, d_ff), dtype=dt, device=device))
    self.wo = frozen(torch.empty((d_ff, d), dtype=dt, device=device))

  def init_(self, gen: torch.Generator) -> "MLP":
    """Draw the reference's initialization (values differ: another RNG)."""
    d, d_ff = self.wi.shape
    self.wi.copy_(dense_init(gen, d, d_ff))
    self.wg.copy_(dense_init(gen, d, d_ff))
    self.wo.copy_(dense_init(gen, d_ff, d, scale=0.5))
    return self

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, self.wi, self.wg, self.wo)
