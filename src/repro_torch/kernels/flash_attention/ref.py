"""Plain torch versions of the flash-attention kernels (the port of
``repro.kernels.flash_attention.ref``): dense masked softmax attention,
each row's log-sum-exp, and the backward from that log-sum-exp.

It runs wherever its input lives; the wrapper in ``ops.py`` uses it for
CPU tensors only.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(sq: int, sk: int, causal: bool, window: int,
          device) -> torch.Tensor:
  """(Sq, Sk) bool, True where query i attends to key j (causal and
  window masks compare the two positions as they are, so they are asked
  for with Sq = Sk only)."""
  qpos = torch.arange(sq, device=device)[:, None]
  kpos = torch.arange(sk, device=device)[None, :]
  mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
  if causal:
    mask = mask & (qpos >= kpos)
  if window:
    mask = mask & (kpos > qpos - window)
  return mask


def _scores(q, k, sm_scale, causal, window):
  scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
  mask = _mask(q.shape[1], k.shape[1], causal, window, q.device)
  return torch.where(mask[None], scores, NEG_INF), mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
  """q (BH, Sq, D), k/v (BH, Sk, D) -> (BH, Sq, D) float32."""
  scores, _ = _scores(q, k, sm_scale, causal, window)
  p = torch.softmax(scores, dim=-1)
  return torch.einsum("bqk,bkd->bqd", p, v.float())


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            sm_scale: float, causal: bool = True,
                            window: int = 0) -> torch.Tensor:
  """Each row's log-sum-exp of its scaled, masked scores: q (BH, Sq, D),
  k (BH, Sk, D) -> (BH, Sq) float32 (the forward kernel's ``lse``)."""
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


def flash_attention_bwd_bf16_order(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   do: torch.Tensor, lse: torch.Tensor,
                                   sm_scale: float, causal: bool,
                                   window: int, step: int):
  """The bf16 backward kernels' arithmetic in plain torch: q (B, S, H, D)
  and k, v (B, S, Hkv, D) bf16, o and do (B, S, H, D) f32, lse (B, H, S)
  -> dq (B, S, H, D) and dk, dv (B, S, Hkv, D) bf16.

  dO enters as hi = bf16(dO) plus lo = bf16(dO - hi), and so do P and dS,
  each product of bf16 terms summed in f32; of P^T dO the products hi hi,
  hi lo and lo hi are taken, lo lo is dropped.  dK and dV take the queries
  and dQ the keys ``step`` at a time, as the kernels' stages do, each
  stage's products 16 rows deep (the tensor cores' depth) added in turn in
  f32 (dK and dV per query head, then summed over the group); the results
  are rounded to bf16 once.  Nothing
  on the main path calls it: it shows on the CPU that this arithmetic
  keeps the kernels within their tolerance of ``flash_attention_bwd_ref``.
  """
  b, s, h, d = q.shape
  grp = h // k.shape[2]
  dev = q.device

  def heads_first(x):  # (B, S, heads, D) -> (B, H, S, D), f32, kv repeated
    x = x.float().permute(0, 2, 1, 3)
    return torch.repeat_interleave(x, h // x.shape[1], dim=1)

  def split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()

  qf, kf, vf = heads_first(q), heads_first(k), heads_first(v)
  doh, dol = split(heads_first(do))
  delta = (heads_first(do) * heads_first(o)).sum(-1)       # (B, H, S)
  lse = lse.float()
  pos = torch.arange(s, device=dev)

  def p_ds(rows, cols):
    """P and dS of the queries ``rows`` against the keys ``cols``."""
    ok = torch.ones((len(pos[rows]), len(pos[cols])), dtype=torch.bool,
                    device=dev)
    qpos, kpos = pos[rows][:, None], pos[cols][None, :]
    if causal:
      ok = ok & (qpos >= kpos)
    if window:
      ok = ok & (kpos > qpos - window)
    kt, vt = kf[:, :, cols].transpose(-1, -2), vf[:, :, cols].transpose(-1, -2)
    sc = qf[:, :, rows] @ kt * sm_scale
    p = torch.where(ok, torch.exp(sc - lse[:, :, rows, None]), 0.0)
    dp = doh[:, :, rows] @ vt + dol[:, :, rows] @ vt
    return p, p * (dp - delta[:, :, rows, None])

  # the masked pairs add exact zeros to dK, dV and dQ: only the keys some
  # query of a range attends to, and the queries that attend to some key
  # of a range, are walked
  def live_keys(q_lo, q_hi):
    return (max(0, q_lo - window + 1) if window else 0,
            min(s, q_hi) if causal else s)

  def live_queries(k_lo, k_hi):
    return (k_lo if causal else 0,
            min(s, k_hi - 1 + window) if window else s)

  dk = torch.zeros((b, h, s, d), device=dev)
  dv = torch.zeros((b, h, s, d), device=dev)
  for q0 in range(0, s, step):
    q1 = min(s, q0 + step)
    k_lo, k_hi = live_keys(q0, q1)
    p, ds = p_ds(slice(q0, q1), slice(k_lo, k_hi))
    for c0 in range(0, q1 - q0, 16):
      rows = slice(q0 + c0, q0 + c0 + 16)
      lo, hi = live_keys(q0 + c0, min(q1, q0 + c0 + 16))
      keys = slice(lo - k_lo, hi - k_lo)
      ph, pl = split(p[:, :, c0:c0 + 16, keys].transpose(-1, -2))
      sh, sl = split(ds[:, :, c0:c0 + 16, keys].transpose(-1, -2))
      dv[:, :, lo:hi] += ph @ doh[:, :, rows]
      dk[:, :, lo:hi] += sh @ qf[:, :, rows]
      dv[:, :, lo:hi] += ph @ dol[:, :, rows]
      dk[:, :, lo:hi] += sl @ qf[:, :, rows]
      dv[:, :, lo:hi] += pl @ doh[:, :, rows]
  dq = torch.zeros((b, h, s, d), device=dev)
  for k0 in range(0, s, step):
    k1 = min(s, k0 + step)
    q_lo, q_hi = live_queries(k0, k1)
    _, ds = p_ds(slice(q_lo, q_hi), slice(k0, k1))
    for c0 in range(0, k1 - k0, 16):
      cols = slice(k0 + c0, k0 + c0 + 16)
      lo, hi = live_queries(k0 + c0, min(k1, k0 + c0 + 16))
      sh, sl = split(ds[:, :, lo - q_lo:hi - q_lo, c0:c0 + 16])
      dq[:, :, lo:hi] += sh @ kf[:, :, cols]
      dq[:, :, lo:hi] += sl @ kf[:, :, cols]

  def back(x, heads):  # (B, H, S, D) f32 -> (B, S, heads, D) bf16
    x = x.reshape(b, heads, h // heads, s, d).sum(2)
    return x.permute(0, 2, 1, 3).to(torch.bfloat16)
  hkv = h // grp
  return back(dq * sm_scale, h), back(dk * sm_scale, hkv), back(dv, hkv)
