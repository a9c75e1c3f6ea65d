"""Attention of the serving path (the port of ``repro.models.attention``):
prefill attention and cross-attention through K6, and decode attention
over the cache, through K5 when the cache is int8.

Layouts are the reference's: q (B, S, H, D) and k/v (B, S, Hkv, D) for
prefill (k/v (B, Sk, Hkv, D) for cross-attention); q (B, H, D) and
caches (B, Hkv, S, D) for decode.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.quant_decode_attn import ops as decode_ops

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
  """q (B, S, H, D); k/v (B, S, Hkv, D) -> (B, S, H, D) in q's dtype.

  GQA: H % Hkv == 0.  Sliding window (Mistral-style): token i attends to
  [i - window + 1, i].  K6 accumulates in f32; the result is cast back to
  the model dtype here, as the reference's model attention does.
  """
  return flash_ops.flash_attention(q, k, v, causal=causal,
                                   window=window).to(q.dtype)


def cross_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
  """q (B, Sq, H, D) over k/v (B, Sk, Hkv, D), every key visible (the
  reference's ``causal=False, window=0``) -> (B, Sq, H, D) in q's dtype,
  through K6."""
  return flash_attention(q, k, v, causal=False, window=0)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     ring: bool = False) -> torch.Tensor:
  """Single-token attention over a cache.

  q: (B, H, D); caches: (B, Hkv, S, D) (int8 codes when scales are given,
  with per-(B, Hkv, S) scales).  length: (B,) int32 tokens written so far,
  on q's device.  ring=True means the cache is a sliding-window ring
  buffer (all slots valid once length >= S).
  """
  s = k_cache.shape[2]
  if ring:
    length = torch.clamp_max(length, s)
  if k_scale is not None:
    out = decode_ops.quant_decode_attn(q, k_cache, k_scale, v_cache,
                                       v_scale, length)
    return out.to(q.dtype)
  b, h, d = q.shape
  hkv = k_cache.shape[1]
  qg = q.reshape(b, hkv, h // hkv, d).float()
  scores = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float())
  scores = scores * (1.0 / (d ** 0.5))
  pos = torch.arange(s, device=q.device)[None, None, None, :]
  scores = torch.where(pos < length[:, None, None, None], scores, NEG_INF)
  p = torch.softmax(scores, dim=-1)
  out = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
  return out.reshape(b, h, d).to(q.dtype)
