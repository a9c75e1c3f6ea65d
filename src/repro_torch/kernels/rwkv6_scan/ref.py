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
runs on the CPU.  Both run wherever their input lives.
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
