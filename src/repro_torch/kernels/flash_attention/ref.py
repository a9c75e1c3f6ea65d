"""Plain torch versions of the flash-attention kernels (the port of
``repro.kernels.flash_attention.ref``): dense masked softmax attention,
each row's log-sum-exp, and the backward from that log-sum-exp.

It runs wherever its input lives; the wrapper in ``ops.py`` uses it for
CPU tensors only.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(s: int, causal: bool, window: int, device) -> torch.Tensor:
  """(S, S) bool, True where query i attends to key j."""
  qpos = torch.arange(s, device=device)[:, None]
  kpos = torch.arange(s, device=device)[None, :]
  mask = torch.ones((s, s), dtype=torch.bool, device=device)
  if causal:
    mask = mask & (qpos >= kpos)
  if window:
    mask = mask & (kpos > qpos - window)
  return mask


def _scores(q, k, sm_scale, causal, window):
  scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
  mask = _mask(q.shape[1], causal, window, q.device)
  return torch.where(mask[None], scores, NEG_INF), mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
  """q/k/v (BH, S, D) -> (BH, S, D) float32."""
  scores, _ = _scores(q, k, sm_scale, causal, window)
  p = torch.softmax(scores, dim=-1)
  return torch.einsum("bqk,bkd->bqd", p, v.float())


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            sm_scale: float, causal: bool = True,
                            window: int = 0) -> torch.Tensor:
  """Each row's log-sum-exp of its scaled, masked scores: q/k (BH, S, D)
  -> (BH, S) float32 (the forward kernel's ``lse``)."""
  scores, _ = _scores(q, k, sm_scale, causal, window)
  return torch.logsumexp(scores, dim=-1)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor,
                            sm_scale: float, causal: bool = True,
                            window: int = 0):
  """The backward kernel's formulas, dense: q/k/v/o/do (BH, S, D) and lse
  (BH, S) -> dq, dk, dv (BH, S, D) float32.

      P = exp(S * scale - lse) (0 where masked),  dV = P^T dO,
      D = rowsum(dO * O),  dS = P (dO V^T - D),
      dQ = scale dS K,  dK = scale dS^T Q
  """
  qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
  scores, mask = _scores(q, k, sm_scale, causal, window)
  p = torch.where(mask[None], torch.exp(scores - lse.float()[..., None]),
                  0.0)
  dv = torch.einsum("bqk,bqd->bkd", p, dof)
  dp = torch.einsum("bqd,bkd->bqk", dof, vf)
  delta = (dof * o.float()).sum(-1, keepdim=True)
  ds = p * (dp - delta)
  dq = torch.einsum("bqk,bkd->bqd", ds, kf) * sm_scale
  dk = torch.einsum("bqk,bqd->bkd", ds, qf) * sm_scale
  return dq, dk, dv


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
