"""Public wrappers for the W8A8 int8 matmul (the API of
``repro.kernels.int8_matmul.ops``).

``quantize_weights`` is the offline packing step (int8 codes with one
float32 scale per output column); ``int8_matmul`` is the serving-time op:
dynamic per-row int8 activation quantization, then K3.  A CUDA tensor
launches the hand-written kernel (``kernel.py``); a CPU tensor runs the
plain torch version (``ref.py``).  There is no other choice and no
fallback: a CUDA input whose kernel cannot build or launch raises.  The
kernel handles any M, K and N itself, so nothing is padded.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import exact, quant
from repro_torch.kernels.int8_matmul import kernel as _kernel
from repro_torch.kernels.int8_matmul import ref as _ref


@dataclasses.dataclass(frozen=True)
class Int8Weights:
  codes: torch.Tensor   # int8 (K, N)
  scale: torch.Tensor   # f32 (N,) per output channel
  k: int
  n: int

  @property
  def hbm_bytes(self) -> int:
    return self.codes.numel() + 4 * self.scale.numel()


def quantize_weights(w: torch.Tensor) -> Int8Weights:
  q = quant.int_quantize(w, bits=8, channel_axis=1)
  return Int8Weights(q.codes, q.scale.reshape(-1), w.shape[0], w.shape[1])


def quantize_activations(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Dynamic per-row symmetric int8 activation quantization.

  Both divisions are true divisions (``exact.div``), as the reference
  computes them with XLA's algebraic simplifier off (the repo's tests run
  it so).  Values stay in x's dtype between the steps: for bf16 x the
  absmax, its clamp, the scale, the quotient and its rounding are bf16
  (no upcast), and the scales are returned as bf16.
  """
  absmax = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-12)
  scale = exact.div(absmax, 127.0)
  codes = torch.clamp(torch.round(exact.div(x, scale)), -128, 127)
  return codes.to(torch.int8), scale.reshape(x.shape[:-1])


def _matmul(x: torch.Tensor, weights: Int8Weights, fn) -> torch.Tensor:
  lead = x.shape[:-1]
  xq, xs = quantize_activations(x.reshape(-1, x.shape[-1]))
  out = fn(xq, weights.codes, xs.reshape(-1), weights.scale)
  return out.reshape(*lead, weights.n)


def int8_matmul(x: torch.Tensor, weights: Int8Weights) -> torch.Tensor:
  """(..., K) f32/bf16 @ int8 (K, N) -> (..., N) f32: dynamic activation
  quantization, then K3 (the plain version for a CPU tensor)."""
  if x.device.type == "cpu":
    return _matmul(x, weights, _ref.int8_matmul_ref)
  return _matmul(x, weights, _kernel.int8_matmul)


def int8_matmul_reference(x: torch.Tensor,
                          weights: Int8Weights) -> torch.Tensor:
  """The plain version on any device."""
  return _matmul(x, weights, _ref.int8_matmul_ref)
