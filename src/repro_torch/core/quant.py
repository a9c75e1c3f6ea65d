"""Quantization schemes of QUIDAM's processing elements (the port of
``repro.core.quant``): LightNN-style sums of powers of two (LightPE-1/-2),
symmetric integer codes (INT4/8/16) and FP32 passthrough.

Every quantizer keeps the reference's contract:

    q = quantize(w)          # codes + scale, tensors on w's device
    w_hat = dequantize(q)    # exact float reconstruction of the codes
    w_fake = fake_quant(w)   # dequantize(quantize(w)) with a straight-
                             # through estimator, for QAT

and gives the reference's codes and scales bit for bit, on the CPU and on
a CUDA card alike:

  * every division goes through ``exact.div`` (on CUDA a Python-number
    divisor is otherwise multiplied by its reciprocal);
  * the nearest codebook point is ``argmin`` over the codebook in the
    reference's order (descending for k=1, ``meshgrid(..., "ij")`` order
    with m1 <= m2 for k=2), so a magnitude at a midpoint takes the earlier
    entry as ``jnp.argmin`` does; the argmin runs over chunks of elements
    so that the (elements, 8 or 36) error tensor stays bounded;
  * ``torch.round`` rounds half to even, as ``jnp.round``; round, then
    clip;
  * powers of two are built from their bits, never from ``exp2``/``pow``;
  * the straight-through estimator computes ``real + (quant -
    real).detach()``, the reference's sum, which can differ from ``quant``
    in the last bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import exact

# Exponent range of the paper: m in {0, 1, ..., 7}.
POW2_M_MAX = 7

_TINY = float(np.finfo(np.float32).tiny)

# elements whose codebook errors are taken at once: 2^22 x 36 x 4 bytes
# = 604 MB for k=2, whatever the size of the leaf
ARGMIN_CHUNK = 1 << 22


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _channel_absmax(w: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
  """Per-channel (or per-tensor when axis is None) absmax, >= float32 tiny;
  the reduced dims are kept (the reference's ``keepdims=True``)."""
  if axis is None:
    s = w.abs().amax()
  else:
    red = tuple(i for i in range(w.dim()) if i != axis % w.dim())
    s = w.abs().amax(dim=red, keepdim=True) if red else w.abs()
  return torch.clamp_min(s, _TINY)


def _ste(real: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
  """Straight-through estimator: forward=quant, backward=identity."""
  return real + (quant - real).detach()


def _pow2_neg(m: torch.Tensor) -> torch.Tensor:
  """2^-m, exact float32, for int32 m in 0..7: built from its bits (the
  biased exponent 127 - m, a zero mantissa), with no host copy, so it can
  run inside a CUDA graph."""
  return ((127 - m) << 23).view(torch.float32)


# ---------------------------------------------------------------------------
# sum-of-powers-of-two (LightPE) codes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Pow2Quantized:
  """Packed power-of-two code.

  codes: uint8 tensor, same shape as w.
    k=1: bit3 = sign, bits2..0 = m           (valid range 0..15)
    k=2: bit6 = sign, bits5..3 = m1, 2..0 = m2 (m1 <= m2)
  scale: broadcastable float32 scale (per channel or scalar), on the
    codes' device.
  k: number of power-of-two terms (1 or 2).
  """
  codes: torch.Tensor
  scale: torch.Tensor
  k: int


def pow2_codebook(k: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
  """All positive codebook values for k terms, and their (m1, m2) codes.

  k=1: 8 values 2^-m, m = 0..7 (descending).  k=2: 36 values 2^-m1 +
  2^-m2 with m1 <= m2, in ``meshgrid(..., indexing="ij")`` order (not
  sorted).  Returns (values float32, code_low_bits uint8) on ``device``.
  """
  if k == 1:
    ms = np.arange(POW2_M_MAX + 1)
    vals, codes = 2.0 ** (-ms), ms
  else:
    m1, m2 = np.meshgrid(np.arange(POW2_M_MAX + 1),
                         np.arange(POW2_M_MAX + 1), indexing="ij")
    keep = (m1 <= m2).reshape(-1)
    m1 = m1.reshape(-1)[keep]
    m2 = m2.reshape(-1)[keep]
    vals = 2.0 ** (-m1.astype(np.float64)) + 2.0 ** (-m2.astype(np.float64))
    codes = m1 * 8 + m2
  return (torch.as_tensor(vals.astype(np.float32), device=device),
          torch.as_tensor(codes.astype(np.uint8), device=device))


def _nearest_codes(mag: torch.Tensor, vals: torch.Tensor,
                   codes: torch.Tensor) -> torch.Tensor:
  """The code of the nearest codebook value for every element of ``mag``:
  ``codes[argmin(|mag[..., None] - vals|)]``, first index on ties, taken
  over chunks of ``ARGMIN_CHUNK`` elements."""
  flat = mag.reshape(-1)
  out = torch.empty(flat.shape, dtype=codes.dtype, device=mag.device)
  for lo in range(0, flat.numel(), ARGMIN_CHUNK):
    err = torch.abs(flat[lo:lo + ARGMIN_CHUNK, None] - vals)
    out[lo:lo + ARGMIN_CHUNK] = codes[torch.argmin(err, dim=-1)]
  return out.reshape(mag.shape)


def pow2_quantize(w: torch.Tensor, k: int = 1,
                  channel_axis: Optional[int] = 0,
                  scale: Optional[torch.Tensor] = None) -> Pow2Quantized:
  """Quantize weights to s * (+/- sum_{i<k} 2^-m_i), exact codebook argmin."""
  assert k in (1, 2), "paper defines LightPE-1 (k=1) and LightPE-2 (k=2)"
  w = w.to(torch.float32)
  if scale is None:
    scale = _channel_absmax(w, channel_axis)
  a = exact.div(w, scale)
  sign_neg = a < 0
  mag = torch.abs(a)
  low = _nearest_codes(mag, *pow2_codebook(k, w.device))
  sign_bit = 8 if k == 1 else 64
  return Pow2Quantized(low + sign_neg.to(torch.uint8) * sign_bit, scale, k)


def pow2_decode_codes(codes: torch.Tensor, k: int) -> torch.Tensor:
  """Decode uint8 codes to exact float32 in [-2, 2] (pre-scale values)."""
  c = codes.to(torch.int32)
  if k == 1:
    sign = torch.where((c & 8) != 0, -1.0, 1.0)
    return sign * _pow2_neg(c & 7)
  sign = torch.where((c & 64) != 0, -1.0, 1.0)
  return sign * (_pow2_neg((c >> 3) & 7) + _pow2_neg(c & 7))


def pow2_dequantize(q: Pow2Quantized) -> torch.Tensor:
  return pow2_decode_codes(q.codes, q.k) * q.scale


def pow2_fake_quant(w: torch.Tensor, k: int = 1,
                    channel_axis: Optional[int] = 0) -> torch.Tensor:
  """QAT forward: dequant(quant(w)) with straight-through gradients."""
  q = pow2_quantize(w.detach(), k=k, channel_axis=channel_axis)
  return _ste(w, pow2_dequantize(q).to(w.dtype))


# ---------------------------------------------------------------------------
# symmetric integer codes (INT4 / INT8 / INT16)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IntQuantized:
  codes: torch.Tensor   # int8 or int16 (int4 stored unpacked in int8)
  scale: torch.Tensor   # float32, broadcastable, on the codes' device
  bits: int


def int_quantize(w: torch.Tensor, bits: int = 8,
                 channel_axis: Optional[int] = 0,
                 scale: Optional[torch.Tensor] = None) -> IntQuantized:
  assert bits in (4, 8, 16)
  w = w.to(torch.float32)
  qmax = 2 ** (bits - 1) - 1
  if scale is None:
    scale = exact.div(_channel_absmax(w, channel_axis), float(qmax))
  codes = torch.clamp(torch.round(exact.div(w, scale)), -qmax - 1, qmax)
  dtype = torch.int8 if bits <= 8 else torch.int16
  return IntQuantized(codes.to(dtype), scale, bits)


def int_dequantize(q: IntQuantized) -> torch.Tensor:
  return q.codes.to(torch.float32) * q.scale


def int_fake_quant(w: torch.Tensor, bits: int = 8,
                   channel_axis: Optional[int] = 0) -> torch.Tensor:
  q = int_quantize(w.detach(), bits=bits, channel_axis=channel_axis)
  return _ste(w, int_dequantize(q).to(w.dtype))


# ---------------------------------------------------------------------------
# activation quantization (8-bit for LightPEs per the paper)
# ---------------------------------------------------------------------------

def act_fake_quant(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
  """Dynamic per-tensor symmetric activation fake-quant (QAT).

  The reference's tiny is a float32 numpy scalar, which promotes a bf16 or
  f16 absmax to float32: the scale and the rounding are float32 (float64
  for float64 x), and only the result returns to x's dtype.
  """
  qmax = 2 ** (bits - 1) - 1
  dt = torch.promote_types(x.dtype, torch.float32)
  absmax = x.detach().abs().amax().to(dt)
  s = exact.div(torch.clamp_min(absmax, _TINY), float(qmax))
  q = torch.clamp(torch.round(exact.div(x.to(dt), s)), -qmax - 1, qmax) * s
  return _ste(x, q.to(x.dtype))


# ---------------------------------------------------------------------------
# packing (storage formats; kernels consume these)
# ---------------------------------------------------------------------------

def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
  """Pack pairs of 4-bit codes (uint8 each, <16) along the last axis:
  column 2j is the low nibble of byte j, column 2j+1 the high one."""
  assert codes.shape[-1] % 2 == 0
  lo = codes[..., 0::2].to(torch.uint8)
  hi = codes[..., 1::2].to(torch.uint8)
  return lo | (hi << 4)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
  lo = packed & 0xF
  hi = (packed >> 4) & 0xF
  return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1],
                                               packed.shape[-1] * 2)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
  """Pack int4 values (int8 in [-8, 7]) into uint8 pairs."""
  u = (codes.to(torch.int32) & 0xF).to(torch.uint8)
  return pack_nibbles(u)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
  u = unpack_nibbles(packed).to(torch.int32)
  return torch.where(u >= 8, u - 16, u).to(torch.int8)


# ---------------------------------------------------------------------------
# unified dispatch keyed by PE type name (see core.pe)
# ---------------------------------------------------------------------------

def fake_quant_for_pe(w: torch.Tensor, pe_type: str,
                      channel_axis: Optional[int] = 0) -> torch.Tensor:
  """Weight fake-quant matching a QUIDAM PE type's numerics."""
  if pe_type == "FP32":
    return w
  if pe_type == "INT16":
    return int_fake_quant(w, 16, channel_axis)
  if pe_type == "INT8":
    return int_fake_quant(w, 8, channel_axis)
  if pe_type == "INT4":
    return int_fake_quant(w, 4, channel_axis)
  if pe_type == "LightPE-1":
    return pow2_fake_quant(w, 1, channel_axis)
  if pe_type == "LightPE-2":
    return pow2_fake_quant(w, 2, channel_axis)
  raise ValueError(f"unknown PE type {pe_type!r}")


def act_fake_quant_for_pe(x: torch.Tensor, pe_type: str) -> torch.Tensor:
  """Activation fake-quant matching a PE type (paper: 8b acts on LightPEs)."""
  if pe_type == "FP32":
    return x
  if pe_type == "INT16":
    return act_fake_quant(x, 16)
  return act_fake_quant(x, 8)
