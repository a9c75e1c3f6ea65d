"""RWKV-6 ("Finch") time mix and channel mix (the port of the RWKV half of
``repro.models.ssm``): parameters, token shift, the prefill path through
K7 and the per-token decode path.

Matmul weights are stored in the model dtype (the reference stores float32
and casts at every use: the same rounding); ``w0``, ``u`` and ``ln_x`` stay
float32 and are used as float32; the ``mix``/``cmix`` lerps are stored
float32 and cast to the activations' dtype at use, as the reference does.
Mamba comes with slice 8 of the port (``transformer.check_supported``
names it).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.models.common import (Device, dense_init, frozen,
                                       model_dtype)

Cache = Dict[str, torch.Tensor]

# the float32 leaves of RWKVMix; every other leaf is a matmul weight
FLOAT32_LEAVES = ("mix", "w0", "u", "ln_x", "cmix")


class RWKVMix(nn.Module):
  """One RWKV-6 layer's parameters: the time mix (r, k, v, g projections,
  the data-dependent decay's LoRA, the bonus u, the per-head group norm)
  and the channel mix (``cm_*``), the reference's ``init_rwkv`` leaves."""

  def __init__(self, cfg: ModelConfig, device: Device = None):
    super().__init__()
    d, dff = cfg.d_model, cfg.d_ff
    h, hd = cfg.n_heads, cfg.head_dim
    e, rank, dt = h * hd, max(d // 16, 1), model_dtype(cfg)
    f32 = torch.float32

    def weight(*shape):
      return frozen(torch.empty(shape, dtype=dt, device=device))

    self.mix = frozen(torch.full((5, d), 0.5, dtype=f32, device=device))
    self.wr, self.wk, self.wv, self.wg = (weight(d, e) for _ in range(4))
    self.wo = weight(e, d)
    self.w0 = frozen(torch.empty(e, dtype=f32, device=device))
    self.w_lora_a = weight(d, rank)
    self.w_lora_b = weight(rank, e)
    self.u = frozen(torch.empty((h, hd), dtype=f32, device=device))
    self.ln_x = frozen(torch.ones((h, hd), dtype=f32, device=device))
    self.cmix = frozen(torch.full((2, d), 0.5, dtype=f32, device=device))
    self.cm_wr = weight(d, d)
    self.cm_wk = weight(d, dff)
    self.cm_wv = weight(dff, d)

  def init_(self, gen: torch.Generator) -> "RWKVMix":
    """Draw the reference's initialization (values differ: another RNG)."""
    d, e = self.wr.shape
    rank, dff = self.w_lora_a.shape[1], self.cm_wk.shape[1]
    self.mix.fill_(0.5)
    for wt in (self.wr, self.wk, self.wv, self.wg):
      wt.copy_(dense_init(gen, d, e))
    self.wo.copy_(dense_init(gen, e, d, scale=0.5))
    self.w0.copy_(-6.0 + 0.3 * torch.randn(
        e, generator=gen, dtype=torch.float32, device=gen.device))
    self.w_lora_a.copy_(dense_init(gen, d, rank))
    self.w_lora_b.copy_(dense_init(gen, rank, e, scale=0.1))
    self.u.copy_(0.3 * torch.randn(self.u.shape, generator=gen,
                                   dtype=torch.float32, device=gen.device))
    self.ln_x.fill_(1.0)
    self.cmix.fill_(0.5)
    self.cm_wr.copy_(dense_init(gen, d, d))
    self.cm_wk.copy_(dense_init(gen, d, dff))
    self.cm_wv.copy_(dense_init(gen, dff, d, scale=0.5))
    return self


def _token_shift(x: torch.Tensor) -> torch.Tensor:
  """x (B, L, d) -> the previous token at each position (zeros at t = 0)."""
  return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _rwkv_wkv_inputs(p: RWKVMix, x: torch.Tensor, x_prev: torch.Tensor):
  """The lerps and projections shared by prefill and decode: r, k, v, the
  gate g (x's dtype) and the decay w (float32)."""
  mix = p.mix.to(x.dtype)
  dx = x_prev - x
  xr, xk, xv, xg, xw = (x + dx * mix[i] for i in range(5))
  r, k, v = xr @ p.wr, xk @ p.wk, xv @ p.wv
  g = F.silu(xg @ p.wg)
  # data-dependent decay (the v6 "Finch" feature)
  lora = torch.tanh(xw @ p.w_lora_a) @ p.w_lora_b
  w = torch.exp(-torch.exp(p.w0 + lora.float()))
  return r, k, v, g, w


def _group_norm(out: torch.Tensor, ln_x: torch.Tensor) -> torch.Tensor:
  """Per-head RMS norm of the WKV output over its last dim (eps 1e-6)."""
  var = torch.mean(out * out, dim=-1, keepdim=True)
  return out * torch.rsqrt(var + 1e-6) * ln_x


def apply_rwkv_time_mix(p: RWKVMix, x: torch.Tensor, cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """x (B, L, d) -> (time-mix output (B, L, d), final WKV state (B, H, D,
  D) float32), from a zero state; the recurrence runs K7 on the card."""
  b, l, _ = x.shape
  h, hd = cfg.n_heads, cfg.head_dim
  r, k, v, g, w = _rwkv_wkv_inputs(p, x, _token_shift(x))

  def heads(t):  # (B, L, H * hd) -> (B, H, L, hd), a view
    return t.view(b, l, h, hd).transpose(1, 2)

  out, s_final = wkv_ops.wkv6(heads(r), heads(k), heads(v), heads(w), p.u,
                              chunk=cfg.ssm_chunk)
  out = _group_norm(out, p.ln_x[None, :, None, :])
  out = out.transpose(1, 2).reshape(b, l, h * hd).to(x.dtype) * g
  return out @ p.wo, s_final


def rwkv_channel_decode(p: RWKVMix, x: torch.Tensor, prev: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
  """The channel mix of x (..., d) given the previous token ``prev``."""
  cmix = p.cmix.to(x.dtype)
  dx = prev - x
  xr = x + dx * cmix[0]
  xk = x + dx * cmix[1]
  r = torch.sigmoid(xr @ p.cm_wr)
  k = torch.square(torch.relu(xk @ p.cm_wk))
  return r * (k @ p.cm_wv)


def apply_rwkv_channel_mix(p: RWKVMix, x: torch.Tensor,
                           cfg: ModelConfig) -> torch.Tensor:
  """x (B, L, d) -> (B, L, d)."""
  return rwkv_channel_decode(p, x, _token_shift(x), cfg)


def rwkv_decode_step(p: RWKVMix, x: torch.Tensor, cache: Cache,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
  """One token x (B, d) through the time mix only (the caller runs the
  channel mix with ``cm_prev``).  The cache {"s" (B, H, D, D) float32,
  "tm_prev" (B, d), "cm_prev" (B, d)} is updated in place."""
  b = x.shape[0]
  h, hd = cfg.n_heads, cfg.head_dim
  r, k, v, g, w = _rwkv_wkv_inputs(p, x, cache["tm_prev"])

  def heads(t):
    return t.reshape(b, h, hd).float()

  o, s_new = wkv_ops.wkv6_decode_step(heads(r), heads(k), heads(v),
                                      heads(w), p.u, cache["s"])
  o = _group_norm(o, p.ln_x[None])
  o = o.reshape(b, h * hd).to(x.dtype) * g
  cache["s"].copy_(s_new)
  cache["tm_prev"].copy_(x)
  return o @ p.wo, cache


def init_rwkv_cache(cfg: ModelConfig, batch: int,
                    device: Device = None) -> Cache:
  dt = model_dtype(cfg)
  return {
      "s": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                       dtype=torch.float32, device=device),
      "tm_prev": torch.zeros((batch, cfg.d_model), dtype=dt, device=device),
      "cm_prev": torch.zeros((batch, cfg.d_model), dtype=dt, device=device),
  }
