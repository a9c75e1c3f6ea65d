"""Plain torch version of the prefill flash-attention kernel (the port of
``repro.kernels.flash_attention.ref``): dense masked softmax attention.

It runs wherever its input lives; the wrapper in ``ops.py`` uses it for
CPU tensors only.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
  """q/k/v (BH, S, D) -> (BH, S, D) float32."""
  s = q.shape[1]
  scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
  qpos = torch.arange(s, device=q.device)[:, None]
  kpos = torch.arange(s, device=q.device)[None, :]
  mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
  if causal:
    mask = mask & (qpos >= kpos)
  if window:
    mask = mask & (kpos > qpos - window)
  scores = torch.where(mask[None], scores, NEG_INF)
  p = torch.softmax(scores, dim=-1)
  return torch.einsum("bqk,bkd->bqd", p, v.float())
