"""Public wrappers for quantized-KV decode attention (the API of
``repro.kernels.quant_decode_attn.ops``).

``quant_decode_attn`` takes GQA-shaped decode inputs, q (B, H, D) and an
int8 cache (B, Hkv, S, D) with per-(position, head) scales.  A CUDA
tensor launches the hand-written kernel (``kernel.py``); a CPU tensor
runs the plain torch version (``ref.py``).  There is no other choice and
no fallback: a CUDA input whose kernel cannot build or launch raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import exact
from repro_torch.kernels.quant_decode_attn import kernel as _kernel
from repro_torch.kernels.quant_decode_attn import ref as _ref


def quantize_kv(k: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
  """(B, Hkv, S, D) f32 -> int8 codes + per-(b, h, s) f32 scales.

  Both divisions go through ``exact.div``: on CUDA, dividing by a Python
  scalar multiplies by its reciprocal, which can move a scale by an ulp
  and flip a code.  ``torch.round`` rounds half to even, as ``jnp.round``.
  """
  def q(x):
    absmax = torch.clamp_min(x.abs().amax(dim=-1), 1e-12)
    scale = exact.div(absmax, 127.0)
    codes = torch.clamp(torch.round(exact.div(x, scale[..., None])),
                        -128, 127)
    return codes.to(torch.int8), scale
  kc, ks = q(k)
  vc, vs = q(v)
  return kc, ks, vc, vs


def quant_decode_attn_reference(q: torch.Tensor, k_codes: torch.Tensor,
                                k_scale: torch.Tensor,
                                v_codes: torch.Tensor, v_scale: torch.Tensor,
                                length: torch.Tensor) -> torch.Tensor:
  """The plain version in the public layout -> (B, H, D) f32."""
  b, h, d = q.shape
  _, hkv, s, _ = k_codes.shape
  g = h // hkv
  out = _ref.quant_decode_attn_ref(
      q.reshape(b * hkv, g, d), k_codes.reshape(b * hkv, s, d),
      k_scale.reshape(b * hkv, s), v_codes.reshape(b * hkv, s, d),
      v_scale.reshape(b * hkv, s),
      torch.repeat_interleave(length.to(torch.int32), hkv),
      1.0 / (d ** 0.5))
  return out.reshape(b, h, d)


def quant_decode_attn(q: torch.Tensor, k_codes: torch.Tensor,
                      k_scale: torch.Tensor, v_codes: torch.Tensor,
                      v_scale: torch.Tensor,
                      length: torch.Tensor) -> torch.Tensor:
  """q (B, H, D) x int8 cache (B, Hkv, S, D) -> (B, H, D) f32.

  length: (B,) int32 current fill per sequence (positions at or past it
  are masked).
  """
  if q.shape[1] % k_codes.shape[1]:
    raise ValueError(f"H = {q.shape[1]} is not a multiple of "
                     f"Hkv = {k_codes.shape[1]}")
  if q.device.type == "cpu":
    return quant_decode_attn_reference(q, k_codes, k_scale, v_codes,
                                       v_scale, length)
  return _kernel.quant_decode_attn(q, k_codes, k_scale, v_codes, v_scale,
                                   length, 1.0 / (q.shape[-1] ** 0.5))
