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


def flash_attention_bf16_order(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, sm_scale: float,
                               causal: bool, window: int, block_k: int,
                               walkers: int) -> torch.Tensor:
  """The bf16 CUDA kernel's arithmetic order in plain torch: q/k/v (BH, S,
  D) bf16 -> (BH, S, D) float32.

  Scores are f32 sums of exact bf16 products and are scaled after; an
  online softmax walks the ``block_k``-key tiles, the tiles split between
  ``walkers`` that merge at the end; P enters PV as hi = bf16(p) plus
  lo = bf16(p - hi), accumulated in f32.  Nothing on the main path calls
  it: it shows on the CPU that this order keeps the kernel within its
  tolerance of ``flash_attention_ref``.
  """
  bh, s, d = q.shape
  qf, kf, vf = q.float(), k.float(), v.float()
  dev = q.device
  qpos = torch.arange(s, device=dev)[:, None]
  n_tiles = -(-s // block_k)
  parts = []
  for w in range(walkers):
    m = torch.full((bh, s, 1), NEG_INF, device=dev)
    l = torch.zeros((bh, s, 1), device=dev)
    acc = torch.zeros((bh, s, d), device=dev)
    for t in range(w, n_tiles, walkers):
      kpos = torch.arange(t * block_k, min(s, (t + 1) * block_k),
                          device=dev)[None, :]
      ok = torch.ones((s, kpos.shape[1]), dtype=torch.bool, device=dev)
      if causal:
        ok = ok & (qpos >= kpos)
      if window:
        ok = ok & (kpos > qpos - window)
      sc = torch.einsum("bqd,bkd->bqk", qf, kf[:, kpos[0]]) * sm_scale
      sc = torch.where(ok[None], sc, NEG_INF)
      m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
      m_safe = torch.where(m_new > NEG_INF / 2, m_new, 0.0)
      alpha = torch.where(m > NEG_INF / 2, torch.exp(m - m_safe), 0.0)
      p = torch.where(sc > NEG_INF / 2, torch.exp(sc - m_safe), 0.0)
      hi = p.to(torch.bfloat16).float()
      lo = (p - hi).to(torch.bfloat16).float()
      vt = vf[:, kpos[0]]
      acc = acc * alpha + hi @ vt + lo @ vt
      l = l * alpha + p.sum(-1, keepdim=True)
      m = m_new
    parts.append((m, l, acc))
  m, l, acc = parts[0]
  for m1, l1, acc1 in parts[1:]:
    m_new = torch.maximum(m, m1)
    m_safe = torch.where(m_new > NEG_INF / 2, m_new, 0.0)
    a0 = torch.where(m > NEG_INF / 2, torch.exp(m - m_safe), 0.0)
    a1 = torch.where(m1 > NEG_INF / 2, torch.exp(m1 - m_safe), 0.0)
    l, acc, m = l * a0 + l1 * a1, acc * a0 + acc1 * a1, m_new
  return acc / torch.clamp_min(l, 1e-30)
