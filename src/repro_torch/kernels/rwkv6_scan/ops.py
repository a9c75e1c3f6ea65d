"""Public wrappers for the WKV6 recurrence (the API of
``repro.kernels.rwkv6_scan.ops``).

A CUDA tensor launches the hand-written chunked kernel (``kernel.py``),
which reads the strided (B, H, T, D) views and masks the ragged end itself;
a CPU tensor runs the plain chunked form (``ref.wkv6_chunked``), which pads
T to a chunk multiple as the reference does.  There is no other choice and
no fallback: a CUDA input whose kernel cannot build or launch raises.
``wkv6_reference`` (the sequential scan) and ``wkv6_decode_step`` (the
per-token update) are plain torch wherever their input lives.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.rwkv6_scan import kernel as _kernel
from repro_torch.kernels.rwkv6_scan import ref as _ref

DEFAULT_CHUNK = 64


def _zero_state(r: torch.Tensor) -> torch.Tensor:
  b, h, _, d = r.shape
  return torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: Optional[torch.Tensor] = None,
         chunk: int = DEFAULT_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
  """WKV6 over (B, H, T, D) inputs; u (H, D); s0 (B, H, D, D) or None (a
  zero state).  Returns (out (B, H, T, D) float32, final state float32)."""
  if r.device.type == "cpu":
    return _ref.wkv6_chunked(r, k, v, w, u,
                             _zero_state(r) if s0 is None else s0, chunk)
  return _kernel.wkv6(r, k, v, w, u, s0, chunk=chunk)


def wkv6_reference(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor,
                   s0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The sequential scan, the correctness oracle."""
  return _ref.wkv6_ref(r, k, v, w, u, _zero_state(r) if s0 is None else s0)


def wkv6_decode_step(rt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                     wt: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Single-token update: (B, H, D) inputs and state (B, H, D, D) ->
  (out (B, H, D), new state)."""
  at = kt[..., :, None] * vt[..., None, :]
  s_plus = state + u[None, :, :, None] * at
  ot = torch.einsum("bhd,bhde->bhe", rt, s_plus)
  return ot, wt[..., :, None] * state + at
