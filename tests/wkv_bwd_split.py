"""K7's backward kernel's schedule in plain torch, for the port's CPU
tests (``test_torch_rwkv_train.py``): it shows that the kernel's split of
the WKV6 gradient (chunk-parallel local sums, the folds across chunks,
each chunk's gradients with the plane factored by sub-chunks) keeps the
function of ``ref.wkv6_chunked_bwd``, the plain backward."""
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan.ref import W_FLOOR, _log_w, _wide


def _padded_rows(c: int) -> int:
  """A chunk's rows as the backward kernel tiles them: 16, 32 or 64."""
  return 16 if c <= 16 else (32 if c <= 32 else 64)


def wkv6_bwd_split(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                   dout: torch.Tensor, ds_final: Optional[torch.Tensor],
                   chunk: int, part: int) -> Tuple[torch.Tensor, ...]:
  """The backward kernel's schedule in plain torch: the same function as
  ``ref.wkv6_chunked_bwd``, same layout; ``part`` is the kernel's
  sub-chunk (the tests read it from its source).

  Each chunk is padded with identity tokens to the kernel's 16, 32 or 64
  rows.  Launch 1: every chunk's local sums U_c = kd^T V and W_c = (r
  e^lp)^T dO, its e^lam and its share of du.  Launch 2: the folds, S_{c+1}
  = e^lam_c S_c + U_c from s0 and dS_{c-1} = e^lam_c dS_c + W_c from
  ds_final, and du summed over the chunks.  Launch 3: each chunk's
  gradients from S_c and dS_c alone, the (t, j) plane cut into
  ``part``-row sub-chunks: off the diagonal blocks e^(lp_t - la_j) =
  e^(lp_t - E_{I-1}) e^(E_{I-1} - E_J) e^(E_J - la_j) (E_J the la of
  sub-chunk J's last row), on them one exp per (t, j < t, d); every
  exponent <= 0.
  """
  b, h, t, dd = r.shape
  cp = _padded_rows(chunk)
  nc = -(-t // chunk)
  pad = nc * chunk - t
  r, k, v, w, dout = (_wide(x) for x in (r, k, v, w, dout))
  if pad:
    r, k, v, dout = (F.pad(x, (0, 0, 0, pad)) for x in (r, k, v, dout))
    w = F.pad(w, (0, 0, 0, pad), value=1.0)

  def rows(x, value=0.0):  # (B, H, T, D) -> (nc, B, H, cp, D)
    x = x.reshape(b, h, nc, chunk, dd).permute(2, 0, 1, 3, 4)
    return F.pad(x, (0, 0, 0, cp - chunk), value=value)
  rc, kc, vc, doc = rows(r), rows(k), rows(v), rows(dout)
  la = torch.cumsum(_log_w(rows(w, 1.0)), dim=3)
  lp = F.pad(la, (0, 0, 1, 0))[:, :, :, :-1]
  lam = la[:, :, :, -1:]
  uf = _wide(u)[None, :, None, :]
  drd = torch.sum(doc * vc, dim=-1, keepdim=True)       # dO_t . v_t
  # launch 1
  ul = torch.einsum("cbhtd,cbhte->cbhde", kc * torch.exp(lam - la), vc)
  wl = torch.einsum("cbhtd,cbhte->cbhde", rc * torch.exp(lp), doc)
  decay = torch.exp(lam[:, :, :, 0])[..., None]
  du = torch.sum(drd * rc * kc, dim=3)                  # (nc, B, H, D)
  # launch 2
  s_in, s = [], _wide(s0)
  for c in range(nc):
    s_in.append(s)
    s = decay[c] * s + ul[c]
  ds_out = [None] * nc
  ds = torch.zeros_like(s) if ds_final is None else _wide(ds_final)
  for c in reversed(range(nc)):
    ds_out[c] = ds
    ds = decay[c] * ds + wl[c]
  du = du.sum(dim=(0, 1))
  # launch 3
  n_parts = cp // part
  ends = [q * part + part - 1 for q in range(n_parts)]
  grads = []
  for c in range(nc):
    rq, kq, vq, dq, laq, lpq = (x[c] for x in (rc, kc, vc, doc, la, lp))
    s_c, ds_c = s_in[c], ds_out[c]
    e = laq[:, :, ends]                                  # (B, H, parts, D)
    e_prev = F.pad(e, (0, 0, 1, 0))[:, :, :-1]           # E_{I-1}, E_{-1} = 0
    sub = [slice(q * part, (q + 1) * part) for q in range(n_parts)]
    k_t = torch.cat([kq[:, :, sl] * torch.exp(e[:, :, q:q + 1] - laq[:, :, sl])
                     for q, sl in enumerate(sub)], dim=2)
    r_t = torch.cat([rq[:, :, sl] * torch.exp(lpq[:, :, sl]
                                               - e_prev[:, :, q:q + 1])
                     for q, sl in enumerate(sub)], dim=2)
    m = torch.zeros((b, h, cp, cp), dtype=r.dtype, device=r.device)
    g_full = torch.einsum("bhte,bhje->bhtj", dq, vq)     # dO V^T
    dm = torch.tril(g_full, diagonal=-1)
    drd_c = torch.diagonal(g_full, dim1=2, dim2=3)[..., None]
    lower = torch.tril(torch.ones(part, part, dtype=torch.bool,
                                  device=r.device), diagonal=-1)
    for qi, si in enumerate(sub):
      for qj in range(qi):
        g = torch.exp(e_prev[:, :, qi:qi + 1] - e[:, :, qj:qj + 1])
        m[:, :, si, sub[qj]] = torch.einsum("bhtd,bhjd->bhtj", r_t[:, :, si],
                                            k_t[:, :, sub[qj]] * g)
      dec = torch.exp(torch.where(lower[:, :, None], lpq[:, :, si, None, :]
                                  - laq[:, :, None, si, :], -torch.inf))
      m[:, :, si, si] = torch.einsum("bhtd,bhjd,bhtjd->bhtj", rq[:, :, si],
                                     kq[:, :, si], dec)
    rd = torch.sum(rq * uf * kq, dim=-1, keepdim=True)
    e_lam = torch.exp(lam[c] - laq)
    dv = (torch.einsum("bhtj,bhte->bhje", m, dq) + rd * dq
          + torch.einsum("bhjd,bhde->bhje", kq * e_lam, ds_c))
    x_ds = torch.einsum("bhje,bhde->bhjd", vq, ds_c)
    dr_n = torch.exp(lpq) * torch.einsum("bhte,bhde->bhtd", dq, s_c)
    dk_n = e_lam * x_ds
    for qi, si in enumerate(sub):
      for qj in range(qi):
        g = torch.exp(e_prev[:, :, qi:qi + 1] - e[:, :, qj:qj + 1])
        blk = dm[:, :, si, sub[qj]]
        dr_n[:, :, si] += torch.exp(lpq[:, :, si] - e_prev[:, :, qi:qi + 1]) \
            * torch.einsum("bhtj,bhjd->bhtd", blk, k_t[:, :, sub[qj]] * g)
        dk_n[:, :, sub[qj]] += torch.exp(e[:, :, qj:qj + 1]
                                         - laq[:, :, sub[qj]]) \
            * torch.einsum("bhtj,bhtd->bhjd", blk, r_t[:, :, si] * g)
      dec = torch.exp(torch.where(lower[:, :, None], lpq[:, :, si, None, :]
                                  - laq[:, :, None, si, :], -torch.inf))
      blk = dm[:, :, si, si]
      dr_n[:, :, si] += torch.einsum("bhtj,bhjd,bhtjd->bhtd", blk,
                                     kq[:, :, si], dec)
      dk_n[:, :, si] += torch.einsum("bhtj,bhtd,bhtjd->bhjd", blk,
                                     rq[:, :, si], dec)
    dr = dr_n + drd_c * uf * kq
    dk = dk_n + drd_c * uf * rq
    dlp, dla = rq * dr_n, -kq * dk_n
    dlam = (torch.exp(lam[c]) * torch.sum(s_c * ds_c, dim=-1)[:, :, None, :]
            + torch.sum(kq * e_lam * x_ds, dim=2, keepdim=True))
    later = torch.flip(torch.cumsum(torch.flip(dla + dlp, (2,)), dim=2),
                       (2,)) - dla - dlp                 # sum over t > s
    dlogw = dla + later + dlam
    wq = rows(w, 1.0)[c]
    dw = torch.where(wq > W_FLOOR, dlogw / wq,
                     torch.where(wq == W_FLOOR, 0.5 * dlogw / wq, 0.0))
    grads.append(tuple(x[:, :, :chunk] for x in (dr, dk, dv, dw)))
  dr, dk, dv, dw = (torch.cat(parts, dim=2)[:, :, :t]
                    for parts in zip(*grads))
  return dr, dk, dv, dw, du, ds
