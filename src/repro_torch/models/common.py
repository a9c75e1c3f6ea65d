"""Shared model components: device and dtype, initializers, norms
(rmsnorm, layernorm and olmo's non-parametric layernorm), RoPE and
sinusoidal positions, and the MLP activations (the port of
``repro.models.common``).

Every function keeps the reference's float32 internals and casts back to
its input's dtype at the end, so bf16 activations round where the
reference rounds them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
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

def make_norm_params(cfg: ModelConfig, d: Optional[int] = None,
                     device: Device = None) -> Dict[str, torch.Tensor]:
  """A pre-norm's float32 parameters: ``scale`` (rmsnorm), ``scale`` and
  ``bias`` (layernorm), none (olmo's non-parametric ``layernorm_np``)."""
  d = d or cfg.d_model
  if cfg.norm == "rmsnorm":
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}
  if cfg.norm == "layernorm":
    return {"scale": torch.ones(d, dtype=torch.float32, device=device),
            "bias": torch.zeros(d, dtype=torch.float32, device=device)}
  if cfg.norm == "layernorm_np":
    return {}
  raise ValueError(cfg.norm)


def apply_norm(scale: Optional[torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig, eps: float = 1e-5,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
  """rmsnorm, or layernorm with the population variance (``jnp.var``),
  scaled and shifted unless it is ``layernorm_np``; in float32, the result
  in x's dtype."""
  xf = x.float()
  if cfg.norm == "rmsnorm":
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)
  centered = xf - torch.mean(xf, dim=-1, keepdim=True)
  var = torch.mean(centered * centered, dim=-1, keepdim=True)
  y = centered * torch.rsqrt(var + eps)
  if cfg.norm == "layernorm":
    y = y * scale + bias
  return y.to(x.dtype)


class Norm(nn.Module):
  """Pre-norm over d_model: the reference's ``make_norm_params`` and
  ``apply_norm`` as one module, its parameters (none for
  ``layernorm_np``) in float32."""

  def __init__(self, cfg: ModelConfig, device: Device = None):
    super().__init__()
    self.cfg = cfg
    params = make_norm_params(cfg, device=device)
    self.scale = frozen(params["scale"]) if "scale" in params else None
    self.bias = frozen(params["bias"]) if "bias" in params else None

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


def sinusoidal_positions(n: int, d: int, device: Device = None
                         ) -> torch.Tensor:
  """(n, d) float32: sin on the even columns, cos on the odd ones."""
  pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
  div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                  * (-math.log(10000.0) / d))
  pe = torch.zeros((n, d), dtype=torch.float32, device=device)
  pe[:, 0::2] = torch.sin(pos * div)
  pe[:, 1::2] = torch.cos(pos * div)
  return pe


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def mlp_act(x: torch.Tensor, variant: str) -> torch.Tensor:
  """The reference's activations.  ``jax.nn.gelu`` is the tanh form by
  default, ``F.gelu`` the erf form (they differ by up to 4e-4), so gelu
  asks for the tanh form."""
  if variant == "gelu":
    return F.gelu(x, approximate="tanh")
  if variant == "relu2":
    r = F.relu(x)
    return r * r
  if variant == "swiglu":  # applied to the gate half only; see ffn.py
    return F.silu(x)
  raise ValueError(variant)
