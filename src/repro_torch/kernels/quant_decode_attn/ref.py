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
