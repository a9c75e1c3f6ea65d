"""Public wrappers for the WKV6 recurrence (the API of
``repro.kernels.rwkv6_scan.ops``).

``wkv6`` dispatches in one of three ways, and in no other: a CPU tensor
runs the plain chunked form (``ref.wkv6_chunked``, which pads T to a chunk
multiple as the reference does), differentiated by autograd when a
gradient is asked for; a CUDA tensor that needs a gradient goes through
:class:`WKV6`, the hand-written forward kernel (``kernel.py``, which reads
the strided (B, H, T, D) views and masks the ragged end itself) and its
hand-written backward; any other CUDA tensor runs the forward kernel
alone.  There is no fallback in either direction: a CUDA input whose
kernel cannot build or launch raises, and a CPU input never reaches a
kernel.  ``wkv6_reference`` (the sequential scan), ``wkv6_bwd_reference``
(the plain chunked backward) and ``wkv6_decode_step`` (the per-token
update) are plain torch wherever their input lives.
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


class WKV6(torch.autograd.Function):
  """K7 with a gradient, for CUDA tensors: the forward kernel, and the
  backward kernel from the same inputs (it reruns the state pass)."""

  @staticmethod
  def forward(ctx, r, k, v, w, u, s0, chunk: int):
    out, s_final = _kernel.wkv6(r, k, v, w, u, s0, chunk=chunk)
    ctx.save_for_backward(r, k, v, w, u, s0)
    ctx.chunk = chunk
    ctx.set_materialize_grads(False)
    return out, s_final

  @staticmethod
  def backward(ctx, dout, ds_final):
    r, k, v, w, u, s0 = ctx.saved_tensors
    if dout is None:
      dout = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
    elif dout.stride(-1) != 1:
      dout = dout.contiguous()
    if ds_final is not None:
      ds_final = ds_final.contiguous()
    dr, dk, dv, dw, du, ds0 = _kernel.wkv6_bwd(
        r, k, v, w, u, s0, dout, ds_final, chunk=ctx.chunk)
    return dr, dk, dv, dw, du, None if s0 is None else ds0, None


def _needs_grad(*xs) -> bool:
  return torch.is_grad_enabled() and any(
      x is not None and x.requires_grad for x in xs)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: Optional[torch.Tensor] = None,
         chunk: int = DEFAULT_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
  """WKV6 over (B, H, T, D) inputs; u (H, D); s0 (B, H, D, D) or None (a
  zero state).  Returns (out (B, H, T, D) float32, final state float32)."""
  if r.device.type == "cpu":
    return _ref.wkv6_chunked(r, k, v, w, u,
                             _zero_state(r) if s0 is None else s0, chunk)
  if _needs_grad(r, k, v, w, u, s0):
    return WKV6.apply(r, k, v, w, u, s0, chunk)
  return _kernel.wkv6(r, k, v, w, u, s0, chunk=chunk)


def wkv6_bwd_reference(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor,
                       s0: Optional[torch.Tensor], dout: torch.Tensor,
                       ds_final: Optional[torch.Tensor] = None,
                       chunk: int = DEFAULT_CHUNK
                       ) -> Tuple[torch.Tensor, ...]:
  """The plain chunked backward (``ref.wkv6_chunked_bwd``): (dr, dk, dv,
  dw (B, H, T, D), du (H, D), ds0 (B, H, D, D)), float32."""
  return _ref.wkv6_chunked_bwd(r, k, v, w, u,
                               _zero_state(r) if s0 is None else s0, dout,
                               ds_final, chunk)


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
