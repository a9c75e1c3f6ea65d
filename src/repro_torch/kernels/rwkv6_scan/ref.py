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
chunks split over blocks, factorised scores); ``wkv6_chunked_bwd`` is the
gradient of ``wkv6_chunked`` (a reverse sweep over the chunks).  All run
wherever their input lives.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# log w is taken of max(w, W_FLOOR).  torch.maximum's gradient is the
# reference's (jnp.maximum): half of it at a tie, none below the floor.
W_FLOOR = 1e-30


def _log_w(w: torch.Tensor) -> torch.Tensor:
  # the floor is filled on w's device: no host copy (a CUDA graph captures
  # the plain forms too)
  return torch.log(torch.maximum(w, w.new_full((), W_FLOOR)))


def _wide(x: torch.Tensor) -> torch.Tensor:
  """float32, or float64 kept (gradcheck runs the plain forms in it)."""
  return x if x.dtype == torch.float64 else x.float()


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
  r, k, v, w = (_wide(x) for x in (r, k, v, w))
  if pad:
    r, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (r, k, v))
    w = F.pad(w, (0, 0, 0, pad), value=1.0)
  nc = (t + pad) // chunk
  mask = (torch.arange(chunk, device=r.device)[:, None]
          > torch.arange(chunk, device=r.device)[None, :])
  uf = _wide(u)[None, :, None, :]
  s = _wide(s0)
  outs = []
  for c in range(nc):
    sl = slice(c * chunk, (c + 1) * chunk)
    rc, kc, vc, wc = r[:, :, sl], k[:, :, sl], v[:, :, sl], w[:, :, sl]
    logw = _log_w(wc)
    la = torch.cumsum(logw, dim=2)                       # inclusive
    la_prev = la - logw
    la_last = la[:, :, -1:, :]
    # carried-state term
    o = torch.einsum("bhtd,bhde->bhte", rc * torch.exp(la_prev), s)
    # intra-chunk pairwise term, strictly causal; the pairs j >= t, which
    # the mask drops, get exp(-inf) = 0 (exp of their positive exponent can
    # overflow, and its gradient times the mask's 0 would be nan)
    decay = torch.exp(torch.where(
        mask[:, :, None], la_prev[:, :, :, None, :] - la[:, :, None, :, :],
        -torch.inf))
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


def wkv6_chunked_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                     dout: torch.Tensor, ds_final: Optional[torch.Tensor],
                     chunk: int) -> Tuple[torch.Tensor, ...]:
  """The gradient of :func:`wkv6_chunked` as the backward kernel computes
  it: ``dout`` (B, H, T, D) and ``ds_final`` (B, H, D, D, None for zero)
  -> (dr, dk, dv, dw (B, H, T, D), du (H, D), ds0 (B, H, D, D)), all
  float32, T padded as the forward pads it.

  A forward pass keeps each chunk's incoming state S; a reverse sweep over
  the chunks carries dS, from ``ds_final`` to ``ds0``.  Per chunk, with
  lp = la_prev, la the inclusive cumsum of log w, lam the la of its last
  row, M_tj = sum_d r_td k_jd e^(lp_td - la_jd) (j < t), rd_t = r_t . (u
  k_t), dM_tj = dO_t . v_j (j < t), drd_t = dO_t . v_t and kd = k e^(lam -
  la):

    dv = M^T dO + rd dO + kd dS^T
    dr = e^lp (dO S^T) + (dM * decay) k + drd u k
    dk = (dM * decay)^T r + e^(lam - la) (V dS^T) + drd u r
    du = sum_t drd_t r_t k_t
    dS_in = e^lam dS + (r e^lp)^T dO

  and the decay's gradient without another pass over the (t, j) plane:
  d lp = r (dr - drd u k), d la = -k (dk - drd u r), d lam = e^lam
  rowsum(S dS) + sum_j kd_j (V dS^T)_j, so d log w_s = sum_{t >= s} d la_t
  + sum_{t > s} d lp_t + d lam (a reverse cumsum in the chunk), and dw = d
  log w / w above the floor (half of it at the floor, none below).  Every
  exponent is <= 0, as in the forward.  The kernel factors the (t, j)
  plane's decays by sub-chunks as the forward kernel does; here they are
  taken whole.
  """
  b, h, t, dd = r.shape
  pad = (-t) % chunk
  r, k, v, w, dout = (_wide(x) for x in (r, k, v, w, dout))
  if pad:
    r, k, v, dout = (F.pad(x, (0, 0, 0, pad)) for x in (r, k, v, dout))
    w = F.pad(w, (0, 0, 0, pad), value=1.0)
  nc = (t + pad) // chunk
  mask = (torch.arange(chunk, device=r.device)[:, None]
          > torch.arange(chunk, device=r.device)[None, :])
  uf = _wide(u)[None, :, None, :]

  def decays(c):
    sl = slice(c * chunk, (c + 1) * chunk)
    wc = w[:, :, sl]
    logw = _log_w(wc)
    la = torch.cumsum(logw, dim=2)
    return sl, wc, la, la - logw, la[:, :, -1:, :]

  starts, s = [], _wide(s0)
  for c in range(nc):
    sl, _, la, _, lam = decays(c)
    starts.append(s)
    s = (torch.exp(lam[:, :, 0, :])[..., None] * s
         + torch.einsum("bhtd,bhte->bhde", k[:, :, sl] * torch.exp(lam - la),
                        v[:, :, sl]))
  ds = torch.zeros_like(s) if ds_final is None else _wide(ds_final)
  du = torch.zeros(u.shape, dtype=r.dtype, device=r.device)
  grads = []
  for c in reversed(range(nc)):
    sl, wc, la, lp, lam = decays(c)
    rc, kc, vc, doc, s_in = r[:, :, sl], k[:, :, sl], v[:, :, sl], \
        dout[:, :, sl], starts[c]
    decay = torch.exp(torch.where(mask[:, :, None], lp[:, :, :, None, :]
                                  - la[:, :, None, :, :], -torch.inf))
    m = torch.where(mask, torch.einsum("bhtd,bhjd,bhtjd->bhtj", rc, kc,
                                       decay), 0.0)
    g = torch.einsum("bhte,bhje->bhtj", doc, vc)
    dm = torch.where(mask, g, 0.0)
    drd = torch.diagonal(g, dim1=2, dim2=3)[..., None]   # (B, H, C, 1)
    rd = torch.sum(rc * uf * kc, dim=-1, keepdim=True)
    e_k = torch.exp(lam - la)
    kd = kc * e_k
    x_ds = torch.einsum("bhje,bhde->bhjd", vc, ds)       # V dS^T
    dv = (torch.einsum("bhtj,bhte->bhje", m, doc) + rd * doc
          + torch.einsum("bhjd,bhde->bhje", kd, ds))
    dr_n = (torch.exp(lp) * torch.einsum("bhte,bhde->bhtd", doc, s_in)
            + torch.einsum("bhtj,bhjd,bhtjd->bhtd", dm, kc, decay))
    dk_n = (torch.einsum("bhtj,bhtd,bhtjd->bhjd", dm, rc, decay)
            + e_k * x_ds)
    dr, dk = dr_n + drd * uf * kc, dk_n + drd * uf * rc
    du = du + torch.sum(drd * rc * kc, dim=(0, 2))
    dlp, dla = rc * dr_n, -kc * dk_n
    dlam = (torch.exp(lam) * torch.sum(s_in * ds, dim=-1)[:, :, None, :]
            + torch.sum(kd * x_ds, dim=2, keepdim=True))

    def rcumsum(x):
      return torch.flip(torch.cumsum(torch.flip(x, (2,)), dim=2), (2,))
    dlogw = rcumsum(dla) + rcumsum(dlp) - dlp + dlam
    dw = torch.where(wc > W_FLOOR, dlogw / wc,
                     torch.where(wc == W_FLOOR, 0.5 * dlogw / wc, 0.0))
    grads.append((dr, dk, dv, dw))
    ds = (torch.exp(lam[:, :, 0, :])[..., None] * ds
          + torch.einsum("bhtd,bhte->bhde", rc * torch.exp(lp), doc))
  dr, dk, dv, dw = (torch.cat(parts[::-1], dim=2)[:, :, :t]
                    for parts in zip(*grads))
  return dr, dk, dv, dw, du, ds


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
    la = torch.cumsum(_log_w(w[:, :, sl]), dim=2)
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
