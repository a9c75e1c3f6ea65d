"""Public wrapper for flash attention (the API of
``repro.kernels.flash_attention.ops``), differentiable.

A CUDA tensor launches the hand-written kernels (``kernel.py``), which
read the (B, S, H, D) layout and the GQA grouping in place: the forward
alone when no input needs a gradient (serving), else through
:class:`FlashAttention`, an autograd function whose forward keeps each
row's log-sum-exp and whose backward is K6's backward kernel.  A CPU
tensor runs the plain torch version (``ref.py``) on a repeated,
head-major copy, as the reference's wrapper does, differentiated by
autograd.  There is no other choice and no fallback: a CUDA input whose
kernel cannot build or launch raises, in either direction.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref


def _flat(x: torch.Tensor) -> torch.Tensor:
  """(B, S, H, D) -> (B*H, S, D)."""
  b, s, h, d = x.shape
  return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _unflat(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
  """(B*H, S, D) -> (B, S, H, D)."""
  return x.reshape(b, h, *x.shape[1:]).permute(0, 2, 1, 3)


def _repeat_kv(q, k, v):
  g = q.shape[2] // k.shape[2]
  if g > 1:
    k = torch.repeat_interleave(k, g, dim=2)
    v = torch.repeat_interleave(v, g, dim=2)
  return k, v


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              window: int = 0) -> torch.Tensor:
  """The plain version: (B, S, H, D) x (B, S, Hkv, D) -> (B, S, H, D) f32."""
  b, s, h, d = q.shape
  k, v = _repeat_kv(q, k, v)
  out = _ref.flash_attention_ref(_flat(q), _flat(k), _flat(v),
                                 1.0 / (d ** 0.5), causal=causal,
                                 window=window)
  return _unflat(out, b, h)


def flash_attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                                  causal: bool = True,
                                  window: int = 0) -> torch.Tensor:
  """The plain log-sum-exp of each row: (B, H, S) float32."""
  b, s, h, d = q.shape
  k, _ = _repeat_kv(q, k, k)
  lse = _ref.flash_attention_lse_ref(_flat(q), _flat(k), 1.0 / (d ** 0.5),
                                     causal=causal, window=window)
  return lse.reshape(b, h, s)


def flash_attention_bwd_reference(q, k, v, out, dout, lse,
                                  causal: bool = True, window: int = 0):
  """The plain backward: dq (B, S, H, D) and dk, dv (B, S, Hkv, D), f32,
  from the forward's inputs, output, the output's gradient and lse (B, H,
  S); each KV head's gradient sums its group's query heads."""
  b, s, h, d = q.shape
  hkv = k.shape[2]
  kr, vr = _repeat_kv(q, k, v)
  dq, dk, dv = _ref.flash_attention_bwd_ref(
      _flat(q), _flat(kr), _flat(vr), _flat(out), _flat(dout),
      lse.reshape(b * h, s), 1.0 / (d ** 0.5), causal=causal, window=window)

  def group_sum(x):
    return _unflat(x, b, h).reshape(b, s, hkv, h // hkv, d).sum(3)
  return _unflat(dq, b, h), group_sum(dk), group_sum(dv)


class FlashAttention(torch.autograd.Function):
  """K6 with a gradient, for CUDA tensors: the forward kernel with each
  row's log-sum-exp, and the backward kernel from it."""

  @staticmethod
  def forward(ctx, q, k, v, causal: bool, window: int):
    scale = 1.0 / (q.shape[-1] ** 0.5)
    out, lse = _kernel.flash_attention(q, k, v, scale, causal=causal,
                                       window=window, return_lse=True)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.window, ctx.scale = causal, window, scale
    return out

  @staticmethod
  def backward(ctx, dout):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _kernel.flash_attention_bwd(
        q, k, v, out, dout.contiguous(), lse, ctx.scale,
        causal=ctx.causal, window=ctx.window)
    return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
  """GQA attention (B, S, H, D) x (B, S, Hkv, D) -> (B, S, H, D) f32."""
  if q.shape[2] % k.shape[2]:
    raise ValueError(f"H = {q.shape[2]} is not a multiple of "
                     f"Hkv = {k.shape[2]}")
  if q.device.type == "cpu":
    return flash_attention_reference(q, k, v, causal=causal, window=window)
  if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                  or v.requires_grad):
    return FlashAttention.apply(q, k, v, causal, window)
  return _kernel.flash_attention(q, k, v, 1.0 / (q.shape[-1] ** 0.5),
                                 causal=causal, window=window)
