"""Shared model components: device and dtype, initializers, norms, RoPE
(the port of ``repro.models.common``: rmsnorm and layernorm).

Every function keeps the reference's float32 internals and casts back to
its input's dtype at the end, so bf16 activations round where the
reference rounds them.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import exact

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None, what: str = "the model"
                   ) -> torch.device:
  """``device``, CUDA when None; raises when CUDA is asked for and there
  is none (nothing moves to the CPU on its own)."""
  dev = torch.device("cuda" if device is None else device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(f"{what} runs on CUDA by default and no CUDA device "
                       "is available; pass device='cpu' to run on the CPU")
  return dev


def model_dtype(cfg: ModelConfig) -> torch.dtype:
  return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def frozen(t: torch.Tensor) -> nn.Parameter:
  """A parameter the serving path never differentiates."""
  return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# initializers (float32 draws, as the reference's; callers cast)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float = 1.0) -> torch.Tensor:
  """(d_in, d_out) normal / sqrt(d_in), on ``gen``'s device."""
  std = scale / math.sqrt(d_in)
  return torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                     device=gen.device) * std


def embed_init(gen: torch.Generator, vocab: int, d: int) -> torch.Tensor:
  return torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                     device=gen.device) * 0.02


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def apply_norm(scale: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-5,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
  """rmsnorm, or layernorm with the population variance (``jnp.var``),
  in float32; the result takes x's dtype."""
  xf = x.float()
  if cfg.norm == "rmsnorm":
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)
  if cfg.norm != "layernorm":
    raise NotImplementedError(
        f"norm {cfg.norm!r} comes with slice 8 of the port (the rest of "
        "the model zoo)")
  centered = xf - torch.mean(xf, dim=-1, keepdim=True)
  var = torch.mean(centered * centered, dim=-1, keepdim=True)
  return (centered * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


class Norm(nn.Module):
  """Pre-norm over d_model with a float32 scale (and a float32 bias for
  layernorm): the reference's ``make_norm_params`` and ``apply_norm`` as
  one module."""

  def __init__(self, cfg: ModelConfig, device: Device = None):
    super().__init__()
    self.cfg = cfg
    self.scale = frozen(torch.ones(cfg.d_model, dtype=torch.float32,
                                   device=device))
    self.bias = None
    if cfg.norm == "layernorm":
      self.bias = frozen(torch.zeros(cfg.d_model, dtype=torch.float32,
                                     device=device))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return apply_norm(self.scale, x, self.cfg, bias=self.bias)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
  """RMSNorm over the head dim (qwen3 qk-norm)."""
  xf = x.float()
  var = torch.mean(xf * xf, dim=-1, keepdim=True)
  return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, d: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
  """cos, sin of shape (..., 1, d // 2) for positions (...): computed once
  and shared by every layer of a step."""
  half = d // 2
  exponent = exact.div(-torch.arange(half, dtype=torch.float32,
                                     device=positions.device), half)
  freq = torch.pow(theta, exponent)
  ang = positions[..., None].float() * freq
  return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
  half = x.shape[-1] // 2
  x1, x2 = x[..., :half], x[..., half:]
  out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
  return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
  """x: (..., S, H, D) or (..., H, D) with positions (..., S) / (...)."""
  cos, sin = rope_tables(positions, x.shape[-1], theta)
  return apply_rope(x, cos, sin)
