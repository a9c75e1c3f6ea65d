"""Public wrappers for the pow2 (LightPE) matmul (the API of
``repro.kernels.pow2_matmul.ops``).

``quantize_weights`` is the offline packing step (what a checkpoint-
conversion tool runs); ``pow2_matmul`` is the serving-time op.  A CUDA
tensor launches the hand-written kernel (``kernel.py``); a CPU tensor runs
the plain torch version (``ref.py``).  There is no other choice and no
fallback: a CUDA input whose kernel cannot build or launch raises.  The
kernel handles any M, K and N itself, so nothing is padded.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import quant
from repro_torch.kernels.pow2_matmul import kernel as _kernel
from repro_torch.kernels.pow2_matmul import ref as _ref


@dataclasses.dataclass(frozen=True)
class Pow2Weights:
  """Packed LightPE weights: device-resident codes + per-channel scales."""
  codes: torch.Tensor   # uint8 (K, N//2) for k=1, (K, N) for k=2
  scale: torch.Tensor   # f32 (N,)
  k_terms: int
  k: int
  n: int

  @property
  def hbm_bytes(self) -> int:
    return self.codes.numel() + 4 * self.scale.numel()


def quantize_weights(w: torch.Tensor, k_terms: int = 1) -> Pow2Weights:
  """Quantize a dense (K, N) weight matrix to packed LightPE codes."""
  kdim, n = w.shape
  q = quant.pow2_quantize(w, k=k_terms, channel_axis=1)  # per-output-channel
  codes = q.codes
  if k_terms == 1:
    assert n % 2 == 0, "LightPE-1 packing needs even N"
    codes = quant.pack_nibbles(codes)
  return Pow2Weights(codes=codes, scale=q.scale.reshape(-1),
                     k_terms=k_terms, k=kdim, n=n)


def _matmul(x: torch.Tensor, weights: Pow2Weights, fn) -> torch.Tensor:
  lead = x.shape[:-1]
  out = fn(x.reshape(-1, x.shape[-1]), weights.codes, weights.scale,
           weights.k_terms)
  return out.reshape(*lead, weights.n)


def pow2_matmul(x: torch.Tensor, weights: Pow2Weights) -> torch.Tensor:
  """(..., K) f32/bf16 @ LightPE (K, N) -> (..., N) float32 through K4
  (the plain version for a CPU tensor)."""
  if x.device.type == "cpu":
    return _matmul(x, weights, _ref.pow2_matmul_ref)
  return _matmul(x, weights, _kernel.pow2_matmul)


def pow2_matmul_reference(x: torch.Tensor,
                          weights: Pow2Weights) -> torch.Tensor:
  """The plain version on any device."""
  return _matmul(x, weights, _ref.pow2_matmul_ref)
