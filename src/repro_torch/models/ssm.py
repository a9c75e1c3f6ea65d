"""RWKV-6 ("Finch") time mix and channel mix (the port of the RWKV half of
``repro.models.ssm``): parameters, token shift, the full-sequence path
through K7 (prefill, and training through K7's autograd function) and the
per-token decode path.

Matmul weights are stored in the model dtype for serving (the reference
stores float32 and casts at every use: the same rounding), or in a
trainable model's ``param_dtype``, and every matmul casts its weight to
the activations' dtype at use, which for a serving model's weights does
nothing; ``w0``, ``u`` and ``ln_x`` stay float32 and are used as float32;
the ``mix``/``cmix`` lerps are stored float32 and cast to the activations'
dtype at use, as the reference does.  (Under ``param_dtype="bfloat16"``
the reference's ``make_train_state`` also rounds the 2-D lerps, ``u`` and
``ln_x`` to bf16; the port keeps these float32 leaves as serving keeps
them.)  The functions take a layer's leaves by name, from an
:class:`RWKVMix` or from :func:`transformer.param_tree`'s per-layer dict,
so serving and training run the same code.  Mamba comes with slice 8b
of the port (``transformer.check_supported`` names it).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

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
  and the channel mix (``cm_*``), the reference's ``init_rwkv`` leaves.
  The matmul weights are in the model dtype, or in ``dtype`` when given;
  the ``FLOAT32_LEAVES`` in float32."""

  def __init__(self, cfg: ModelConfig, device: Device = None,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    d, dff = cfg.d_model, cfg.d_ff
    h, hd = cfg.n_heads, cfg.head_dim
    e, rank, dt = h * hd, max(d // 16, 1), dtype or model_dtype(cfg)
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

  def __getitem__(self, name: str) -> torch.Tensor:
    """A leaf by name, as :func:`transformer.param_tree`'s dicts give it."""
    return getattr(self, name)


# a layer's leaves: the module, or its dict in a parameter tree
Leaves = Union[RWKVMix, Mapping[str, torch.Tensor]]


class _Sigmoid(torch.autograd.Function):
  """The reference's sigmoid as XLA evaluates it: 1 / (1 + e^-x) one op at
  a time, each rounded to x's dtype, and its gradient g (y (1 - y)), also
  one op at a time.  ``torch.sigmoid`` rounds once, and in bf16 that moves
  the gate and the channel mix's r by an ulp in about half their elements,
  which rwkv's group norm can amplify into the gradients."""

  @staticmethod
  def forward(ctx, x: torch.Tensor) -> torch.Tensor:
    y = torch.reciprocal(1 + torch.exp(-x))
    ctx.save_for_backward(y)
    return y

  @staticmethod
  def backward(ctx, g: torch.Tensor) -> torch.Tensor:
    (y,) = ctx.saved_tensors
    return g * (y * (1 - y))


def _silu(x: torch.Tensor) -> torch.Tensor:
  """``jax.nn.silu``'s rounding: x times the sigmoid above."""
  return x * _Sigmoid.apply(x)


def _token_shift(x: torch.Tensor) -> torch.Tensor:
  """x (B, L, d) -> the previous token at each position (zeros at t = 0)."""
  return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _rwkv_wkv_inputs(p: Leaves, x: torch.Tensor, x_prev: torch.Tensor):
  """The lerps and projections shared by prefill, training and decode: r,
  k, v, the gate g (x's dtype) and the decay w (float32)."""
  dt = x.dtype
  mix = p["mix"].to(dt)
  # x_prev - x once a lerp, as the reference writes it: in bf16 the
  # gradient then sums its parts in the reference's order
  xr, xk, xv, xg, xw = (x + (x_prev - x) * mix[i] for i in range(5))
  r, k, v = xr @ p["wr"].to(dt), xk @ p["wk"].to(dt), xv @ p["wv"].to(dt)
  g = _silu(xg @ p["wg"].to(dt))
  # data-dependent decay (the v6 "Finch" feature)
  lora = torch.tanh(xw @ p["w_lora_a"].to(dt)) @ p["w_lora_b"].to(dt)
  w = torch.exp(-torch.exp(p["w0"] + lora.float()))
  return r, k, v, g, w


def _group_norm(out: torch.Tensor, ln_x: torch.Tensor) -> torch.Tensor:
  """Per-head RMS norm of the WKV output over its last dim (eps 1e-6)."""
  var = torch.mean(out * out, dim=-1, keepdim=True)
  return out * torch.rsqrt(var + 1e-6) * ln_x


def apply_rwkv_time_mix(p: Leaves, x: torch.Tensor, cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """x (B, L, d) -> (time-mix output (B, L, d), final WKV state (B, H, D,
  D) float32), from a zero state; the recurrence runs K7 on the card, and
  K7's backward when a leaf or x needs a gradient."""
  b, l, _ = x.shape
  h, hd = cfg.n_heads, cfg.head_dim
  r, k, v, g, w = _rwkv_wkv_inputs(p, x, _token_shift(x))

  def heads(t):  # (B, L, H * hd) -> (B, H, L, hd), a view
    return t.view(b, l, h, hd).transpose(1, 2)

  out, s_final = wkv_ops.wkv6(heads(r), heads(k), heads(v), heads(w), p["u"],
                              chunk=cfg.ssm_chunk)
  out = _group_norm(out, p["ln_x"][None, :, None, :])
  out = out.transpose(1, 2).reshape(b, l, h * hd).to(x.dtype) * g
  return out @ p["wo"].to(x.dtype), s_final


def rwkv_channel_decode(p: Leaves, x: torch.Tensor, prev: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
  """The channel mix of x (..., d) given the previous token ``prev``."""
  dt = x.dtype
  cmix = p["cmix"].to(dt)
  xr = x + (prev - x) * cmix[0]
  xk = x + (prev - x) * cmix[1]
  r = _Sigmoid.apply(xr @ p["cm_wr"].to(dt))
  k = torch.square(torch.relu(xk @ p["cm_wk"].to(dt)))
  return r * (k @ p["cm_wv"].to(dt))


def apply_rwkv_channel_mix(p: Leaves, x: torch.Tensor,
                           cfg: ModelConfig) -> torch.Tensor:
  """x (B, L, d) -> (B, L, d)."""
  return rwkv_channel_decode(p, x, _token_shift(x), cfg)


def rwkv_decode_step(p: Leaves, x: torch.Tensor, cache: Cache,
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
                                      heads(w), p["u"], cache["s"])
  o = _group_norm(o, p["ln_x"][None])
  o = o.reshape(b, h * hd).to(x.dtype) * g
  cache["s"].copy_(s_new)
  cache["tm_prev"].copy_(x)
  return o @ p["wo"].to(x.dtype), cache


def init_rwkv_cache(cfg: ModelConfig, batch: int,
                    device: Device = None) -> Cache:
  dt = model_dtype(cfg)
  return {
      "s": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                       dtype=torch.float32, device=device),
      "tm_prev": torch.zeros((batch, cfg.d_model), dtype=dt, device=device),
      "cm_prev": torch.zeros((batch, cfg.d_model), dtype=dt, device=device),
  }
