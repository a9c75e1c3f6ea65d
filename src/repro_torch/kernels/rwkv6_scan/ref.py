"""Plain torch versions of the WKV6 recurrence (the port of
``repro.kernels.rwkv6_scan.ref.wkv6_ref`` and of the chunked form
``repro.models.ssm.wkv6_chunked``).

Per head, with the state S (D x D) indexed S[d_k, d_v]:

    a_t = k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) a_t)
    S_t = diag(w_t) S_{t-1} + a_t

``wkv6_ref`` is the sequential scan (the correctness oracle);
``wkv6_chunked`` evaluates the same function chunk by chunk in the stable
log-decay form that the CUDA kernel computes, and is what the port's model
runs on the CPU; ``wkv6_split`` follows the kernel's own schedule (a head's
chunks split over blocks, factorised scores).  All run wherever their input
lives.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
  """r/k/v/w (B, H, T, D), u (H, D), s0 (B, H, D, D) -> (out (B, H, T, D)
  float32, final state (B, H, D, D) float32), one token at a time."""
  s = s0.float()
  uf = u.float()[None, :, :, None]
  outs = []
  for t in range(r.shape[2]):
    rt, kt, vt, wt = (x[:, :, t].float() for x in (r, k, v, w))
    at = kt[..., :, None] * vt[..., None, :]
    s_plus = s + uf * at
    outs.append(torch.einsum("bhd,bhde->bhe", rt, s_plus))
    s = wt[..., :, None] * s + at
  return torch.stack(outs, dim=2), s


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                 chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
  """The stable chunked form.  Inside a chunk ``la`` is the inclusive
  cumsum of log w, so every exponent below is a difference of a monotone
  sum and is <= 0.  T is padded to a chunk multiple with identity tokens
  (w = 1, r = k = v = 0), which leave the state untouched.

  r/k/v/w (B, H, T, D), u (H, D), s0 (B, H, D, D) -> (out (B, H, T, D)
  float32, final state float32)."""
  b, h, t, dd = r.shape
  pad = (-t) % chunk
  r, k, v, w = (x.float() for x in (r, k, v, w))
  if pad:
    r, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (r, k, v))
    w = F.pad(w, (0, 0, 0, pad), value=1.0)
  nc = (t + pad) // chunk
  mask = (torch.arange(chunk, device=r.device)[:, None]
          > torch.arange(chunk, device=r.device)[None, :])
  uf = u.float()[None, :, None, :]
  s = s0.float()
  outs = []
  for c in range(nc):
    sl = slice(c * chunk, (c + 1) * chunk)
    rc, kc, vc, wc = r[:, :, sl], k[:, :, sl], v[:, :, sl], w[:, :, sl]
    logw = torch.log(torch.clamp_min(wc, 1e-30))
    la = torch.cumsum(logw, dim=2)                       # inclusive
    la_prev = la - logw
    la_last = la[:, :, -1:, :]
    # carried-state term
    o = torch.einsum("bhtd,bhde->bhte", rc * torch.exp(la_prev), s)
    # intra-chunk pairwise term, strictly causal
    decay = torch.exp(la_prev[:, :, :, None, :] - la[:, :, None, :, :])
    scores = torch.einsum("bhtd,bhjd,bhtjd->bhtj", rc, kc, decay)
    scores = torch.where(mask, scores, 0.0)
    o = o + torch.einsum("bhtj,bhjd->bhtd", scores, vc)
    # current-token bonus
    o = o + torch.sum(rc * uf * kc, dim=-1, keepdim=True) * vc
    outs.append(o)
    # state update
    kd = kc * torch.exp(la_last - la)
    s = (torch.exp(la_last[:, :, 0, :])[..., None] * s
         + torch.einsum("bhtd,bhte->bhde", kd, vc))
  return torch.cat(outs, dim=2)[:, :, :t], s


def wkv6_split(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
               chunk: int, max_blocks: int, sub: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The CUDA kernel's schedule in plain torch, same layout as
  ``wkv6_chunked``; the sizes are the kernel's constants (the tests read
  them from its source).

  A head's chunks are split into contiguous ranges over min(``max_blocks``,
  chunks) blocks.  Pass 1: each range's state contribution dS, summed from
  its end with every exponent <= 0, and its decay A (the summed la_last).
  Pass 2: block i's entering state folds blocks 0 .. i - 1 into s0 in rank
  order, S = exp(A_j) S + dS_j; the last block's exp(A) S_in + dS is the
  final state.  Pass 3: each block runs its chunks from its entering state
  with the scores cut into ``sub``-row sub-chunks: one exp per (t, j, d) on
  the diagonal blocks, and off it r~ = r exp(la_prev - E_{I-1}) and k~ =
  k exp(E_J - la) times exp(E_{I-1} - E_J), with E_J the la of sub-chunk
  J's last row; r exp(la_prev) and k exp(la_last - la) are r~ and k~ times
  one more factor <= 1.  Nothing on the main path calls it: it shows on
  the CPU that the split keeps the kernel's function.
  """
  b, h, t, dd = r.shape
  pad = (-t) % chunk
  r, k, v, w = (x.float() for x in (r, k, v, w))
  if pad:
    r, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (r, k, v))
    w = F.pad(w, (0, 0, 0, pad), value=1.0)
  nc = (t + pad) // chunk
  blocks = max(1, min(max_blocks, nc))
  base, extra = divmod(nc, blocks)
  ranges = [range(i * base + min(i, extra),
                  (i + 1) * base + min(i + 1, extra)) for i in range(blocks)]
  uf = u.float()[None, :, None, :]

  def tiles(c):
    sl = slice(c * chunk, (c + 1) * chunk)
    la = torch.cumsum(torch.log(torch.clamp_min(w[:, :, sl], 1e-30)), dim=2)
    la_prev = F.pad(la, (0, 0, 1, 0))[:, :, :-1]
    return r[:, :, sl], k[:, :, sl], v[:, :, sl], la, la_prev

  # pass 1
  parts = []
  for rng in ranges:
    ds = torch.zeros((b, h, dd, dd), device=r.device)
    a = torch.zeros((b, h, 1, dd), device=r.device)
    for c in reversed(rng):
      _, kc, vc, la, _ = tiles(c)
      last = la[:, :, -1:]
      ds = ds + torch.einsum("bhtd,bhte->bhde",
                             kc * torch.exp(last + a - la), vc)
      a = a + last
    parts.append((ds, torch.exp(a[:, :, 0])[..., None]))
  # pass 2
  s_in, s = [], s0.float()
  for ds, decay in parts:
    s_in.append(s)
    s = decay * s + ds
  s_final = s
  # pass 3
  ends = [min(j * sub + sub, chunk) - 1 for j in range(-(-chunk // sub))]
  outs = []
  for rng, s in zip(ranges, s_in):
    for c in rng:
      rc, kc, vc, la, la_prev = tiles(c)
      e = la[:, :, ends]                                 # (B, H, n_sub, D)
      rq = torch.empty_like(rc)
      kd = torch.empty_like(kc)
      scores = torch.zeros((b, h, chunk, chunk), device=r.device)
      for i, end in enumerate(ends):
        rows = slice(i * sub, end + 1)
        e_prev = e[:, :, i - 1:i] if i else torch.zeros_like(e[:, :, :1])
        r_t = rc[:, :, rows] * torch.exp(la_prev[:, :, rows] - e_prev)
        k_t = kc[:, :, rows] * torch.exp(e[:, :, i:i + 1] - la[:, :, rows])
        decay = torch.exp(torch.clamp_max(
            la_prev[:, :, rows, None] - la[:, :, None, rows], 0.0))
        diag = torch.einsum("bhtd,bhjd,bhtjd->bhtj", rc[:, :, rows],
                            kc[:, :, rows], decay)
        scores[:, :, rows, rows] = torch.tril(diag, diagonal=-1)
        for j in range(i):
          cols = slice(j * sub, ends[j] + 1)
          kt_j = kc[:, :, cols] * torch.exp(e[:, :, j:j + 1] - la[:, :, cols])
          g = torch.exp(e_prev - e[:, :, j:j + 1])
          scores[:, :, rows, cols] = torch.einsum("bhtd,bhjd->bhtj", r_t,
                                                  kt_j * g)
        rq[:, :, rows] = r_t * torch.exp(e_prev)
        kd[:, :, rows] = k_t * torch.exp(la[:, :, -1:] - e[:, :, i:i + 1])
      o = (torch.einsum("bhtd,bhde->bhte", rq, s)
           + torch.einsum("bhtj,bhjd->bhtd", scores, vc)
           + torch.sum(rc * uf * kc, dim=-1, keepdim=True) * vc)
      outs.append(o)
      s = (torch.exp(la[:, :, -1])[..., None] * s
           + torch.einsum("bhtd,bhte->bhde", kd, vc))
  return torch.cat(outs, dim=2)[:, :, :t], s_final
