"""Public wrapper for prefill flash attention (the API of
``repro.kernels.flash_attention.ops``).

A CUDA tensor launches the hand-written kernel (``kernel.py``), which
reads the (B, S, H, D) layout and the GQA grouping in place; a CPU tensor
runs the plain torch version (``ref.py``) on a repeated, head-major copy,
as the reference's wrapper does.  There is no other choice and no
fallback: a CUDA input whose kernel cannot build or launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              window: int = 0) -> torch.Tensor:
  """The plain version: (B, S, H, D) x (B, S, Hkv, D) -> (B, S, H, D) f32."""
  b, s, h, d = q.shape
  g = h // k.shape[2]
  if g > 1:
    k = torch.repeat_interleave(k, g, dim=2)
    v = torch.repeat_interleave(v, g, dim=2)

  def flat(x):  # (B, S, H, D) -> (B*H, S, D)
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)

  out = _ref.flash_attention_ref(flat(q), flat(k), flat(v),
                                 1.0 / (d ** 0.5), causal=causal,
                                 window=window)
  return out.reshape(b, h, s, d).permute(0, 2, 1, 3)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
  """GQA attention (B, S, H, D) x (B, S, Hkv, D) -> (B, S, H, D) f32."""
  if q.shape[2] % k.shape[2]:
    raise ValueError(f"H = {q.shape[2]} is not a multiple of "
                     f"Hkv = {k.shape[2]}")
  if q.device.type == "cpu":
    return flash_attention_reference(q, k, v, causal=causal, window=window)
  return _kernel.flash_attention(q, k, v, 1.0 / (q.shape[-1] ** 0.5),
                                 causal=causal, window=window)
