"""Plain torch version of the pow2 (LightPE) matmul kernel (the port of
``repro.kernels.pow2_matmul.ref``): decode the codes to exact float32
weights with the per-column scale folded in, then one float32 matmul.
It runs wherever its input lives; the wrapper in ``ops.py`` uses it for
CPU tensors only.  The kernel instead multiplies by the scale after the K
sum, as the TPU kernel does, so the two differ by rounding.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import pow2_decode_codes, unpack_nibbles


def decode_weights(codes: torch.Tensor, scale: torch.Tensor,
                   k_terms: int) -> torch.Tensor:
  """codes (packed for k=1) + per-output-channel scale -> f32 (K, N)."""
  if k_terms == 1:
    codes = unpack_nibbles(codes)
  vals = pow2_decode_codes(codes, k_terms)
  return vals * scale.reshape(1, -1)


def pow2_matmul_ref(x: torch.Tensor, codes: torch.Tensor,
                    scale: torch.Tensor, k_terms: int) -> torch.Tensor:
  w = decode_weights(codes, scale, k_terms)
  return torch.matmul(x.to(torch.float32), w)
