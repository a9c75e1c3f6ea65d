"""Plain torch version of the quantized-KV decode attention kernel (the
port of ``repro.kernels.quant_decode_attn.ref``).

Dequantize, score, mask at or past ``length``, softmax, PV.  The softmax
is written out with the kernel's guards (masked probabilities are exactly
0, the output is ``acc / max(l, 1e-30)``), so a row with no valid
position gives 0 instead of NaN; on every row with one it is the
reference's softmax.  It runs wherever its input lives; the wrapper in
``ops.py`` uses it for CPU tensors only.
"""
from __future__ import annotations

import torch


def quant_decode_attn_ref(q: torch.Tensor, k_codes: torch.Tensor,
                          k_scale: torch.Tensor, v_codes: torch.Tensor,
                          v_scale: torch.Tensor, length: torch.Tensor,
                          sm_scale: float) -> torch.Tensor:
  """q (BH, G, D), int8 KV (BH, S, D), scales (BH, S), length (BH,)
  -> (BH, G, D) float32."""
  k = k_codes.float() * k_scale[..., None]
  v = v_codes.float() * v_scale[..., None]
  s = torch.einsum("bgd,bsd->bgs", q.float(), k) * sm_scale
  pos = torch.arange(k.shape[1], device=k.device)[None, None, :]
  valid = pos < length[:, None, None]
  s = torch.where(valid, s, float("-inf"))
  m = s.amax(dim=-1, keepdim=True)
  m = torch.where(torch.isfinite(m), m, 0.0)
  p = torch.where(valid, torch.exp(s - m), 0.0)
  l = p.sum(dim=-1, keepdim=True)
  return torch.einsum("bgs,bsd->bgd", p, v) / torch.clamp_min(l, 1e-30)


def quant_decode_attn_split(q: torch.Tensor, k_codes: torch.Tensor,
                            k_scale: torch.Tensor, v_codes: torch.Tensor,
                            v_scale: torch.Tensor, length: torch.Tensor,
                            sm_scale: float, split: int,
                            max_splits: int) -> torch.Tensor:
  """The CUDA kernel's split-and-merge (flash decoding) in plain torch,
  same layout as ``quant_decode_attn_ref``.

  The cache's capacity S is cut into ``split``-position chunks, dealt
  round-robin to ``min(max_splits, ceil(S / split))`` blocks.  Each block
  runs an online softmax over its chunks' positions below ``length``; a
  block with none keeps the empty partial (-inf, 0, 0).  The merge
  rescales each partial by exp(m - max m), skipping empty ones, and
  divides by max(l, 1e-30).  Nothing on the main path calls it: it shows
  on the CPU that the split keeps the kernel's function.
  """
  bh, g, d = q.shape
  s = k_codes.shape[1]
  n = torch.clamp(length.long(), 0, s)[:, None, None]
  qf, dev = q.float(), q.device
  n_chunks = -(-s // split)
  blocks = max(1, min(max_splits, n_chunks))
  neg = torch.full((bh, g, 1), float("-inf"), device=dev)
  parts = []
  for rank in range(blocks):
    m, l = neg, torch.zeros((bh, g, 1), device=dev)
    acc = torch.zeros((bh, g, d), device=dev)
    for lo in range(rank * split, s, blocks * split):
      hi = min(s, lo + split)
      k = k_codes[:, lo:hi].float() * k_scale[:, lo:hi, None]
      v = v_codes[:, lo:hi].float() * v_scale[:, lo:hi, None]
      sc = torch.einsum("bgd,bsd->bgs", qf, k) * sm_scale
      valid = torch.arange(lo, hi, device=dev)[None, None, :] < n
      sc = torch.where(valid, sc, float("-inf"))
      m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
      live = torch.isfinite(m_new)   # rows with a position here or before
      safe = torch.where(live, m_new, 0.0)
      alpha = torch.where(torch.isfinite(m), torch.exp(m - safe), 0.0)
      p = torch.where(valid, torch.exp(sc - safe), 0.0)
      l = l * alpha + p.sum(-1, keepdim=True)
      acc = acc * alpha + torch.einsum("bgs,bsd->bgd", p, v)
      m = m_new
    parts.append((m, l, acc))
  m_all, l_all, acc_all = neg, torch.zeros((bh, g, 1), device=dev), \
      torch.zeros((bh, g, d), device=dev)
  for m, l, acc in parts:
    m_new = torch.maximum(m_all, m)
    safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    a = torch.where(torch.isfinite(m_all), torch.exp(m_all - safe), 0.0)
    b = torch.where(torch.isfinite(m), torch.exp(m - safe), 0.0)
    l_all, acc_all, m_all = l_all * a + l * b, acc_all * a + acc * b, m_new
  return acc_all / torch.clamp_min(l_all, 1e-30)
