"""Launch wrappers for the CUDA flash-attention kernels
(``csrc/flash_attention.cu``, built and loaded through ``ctypes``): K6's
forward, optionally with each row's log-sum-exp, and its backward.

The forward takes q (B, Sq, H, D) and k/v (B, Sk, Hkv, D) on one CUDA
device, float32 or bf16, in any strides whose last dim is contiguous (Sk
!= Sq in full attention only: cross-attention), allocates the f32
output, launches on the current stream and raises if the launch was
refused.  bf16 runs on the tensor cores and its tiles
arrive by 16-byte asynchronous copies, so bf16 bases must be 16-byte
aligned and their batch, sequence and head strides multiples of 8
elements (the model's q, k and the ``kv[:, :, 1]`` view of v are).
The backward takes q, k, v of one length S, the forward's f32 output, its
gradient and the lse, and returns dq, dk and dv in the inputs' dtype;
for bf16 inputs it runs on the tensor cores too, and allocates the
gradient's bf16 hi and lo parts as scratch beside the f32 ``delta``.
``LAUNCHES`` counts each wrapper's launches, so a run that zeroes it
before driving the model can show that prefill and training went
through them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch import _build
from repro_torch.kernels import _checks

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}


def reset_launch_counts() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
  lib = _build.load("flash_attention")
  p, i64 = ctypes.c_void_p, ctypes.c_int64
  lib.fa_forward.argtypes = ([p, p, p, p] + [i64] * 15
                             + [ctypes.c_float, ctypes.c_int, i64,
                                ctypes.c_int, p, p])
  lib.fa_forward.restype = ctypes.c_int
  lib.fa_backward.argtypes = ([p] * 11 + [i64] * 14
                              + [ctypes.c_float, ctypes.c_int, i64,
                                 ctypes.c_int, p])
  lib.fa_backward.restype = ctypes.c_int
  return lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
  """Raise ValueError on what the kernel does not take."""
  for name, t in (("q", q), ("k", k), ("v", v)):
    if t.device.type != "cuda":
      raise ValueError(f"{name}: expected a CUDA tensor, got one on "
                       f"{t.device}")
    if t.device != q.device:
      raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if t.dtype not in DTYPES or t.dtype != q.dtype:
      raise ValueError(f"{name}: expected float32 or bfloat16 like q, got "
                       f"{t.dtype}")
    if t.dim() != 4 or t.stride(-1) != 1:
      raise ValueError(f"{name}: expected (B, S, heads, D) with a "
                       f"contiguous last dim, got shape {tuple(t.shape)} "
                       f"strides {t.stride()}")
  b, s, h, d = q.shape
  if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
    raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                     f"{tuple(q.shape)}")
  hkv = k.shape[2]
  if hkv == 0 or h % hkv:
    raise ValueError(f"H = {h} is not a multiple of Hkv = {hkv}")
  if d not in HEAD_DIMS:
    raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
  if q.dtype == torch.bfloat16:
    for name, t in (("q", q), ("k", k), ("v", v)):
      if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
        raise ValueError(f"{name}: bf16 tiles are copied 16 bytes at a "
                         f"time: the base must be 16-byte aligned and the "
                         f"strides multiples of 8, got strides "
                         f"{t.stride()}")


def check_lengths(q: torch.Tensor, k: torch.Tensor, causal: bool,
                  window: int) -> None:
  """Raise ValueError for causal or windowed attention at S_k != S_q:
  their masks compare a query's position with a key's."""
  if (causal or window) and k.shape[1] != q.shape[1]:
    raise ValueError(f"causal or windowed attention takes as many keys as "
                     f"queries: S_q = {q.shape[1]}, S_k = {k.shape[1]}")


def _strides(*ts):
  return [st for t in ts for st in t.stride()[:3]]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float, causal: bool = True, window: int = 0,
                    return_lse: bool = False):
  """K6: (B, Sq, H, D) x (B, Sk, Hkv, D) -> (B, Sq, H, D) float32, and
  with ``return_lse`` also each row's log-sum-exp of its scaled scores,
  (B, H, Sq) float32, for :func:`flash_attention_bwd`.  Causal and
  windowed attention take Sk = Sq."""
  check_inputs(q, k, v)
  if window < 0:
    raise ValueError(f"window must be >= 0, got {window}")
  check_lengths(q, k, causal, window)
  b, s, h, d = q.shape
  sk = k.shape[1]
  out = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
  lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
         if return_lse else None)
  with torch.cuda.device(q.device):
    stream = torch.cuda.current_stream().cuda_stream
    status = _lib().fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, sk, h, k.shape[2], d, *_strides(q, k, v),
        float(sm_scale), int(bool(causal)), int(window),
        int(q.dtype == torch.bfloat16),
        lse.data_ptr() if return_lse else None, stream)
  if status != 0:
    raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                       f"{status}")
  LAUNCHES["flash_attention"] += 1
  return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, sm_scale: float,
                        causal: bool = True, window: int = 0):
  """K6's backward: dq (B, S, H, D) and dk, dv (B, S, Hkv, D), contiguous,
  in q's dtype, from the forward's inputs, its f32 output ``out``, the
  output's gradient ``dout`` (f32, (B, S, H, D)) and ``lse``."""
  check_inputs(q, k, v)
  if window < 0:
    raise ValueError(f"window must be >= 0, got {window}")
  b, s, h, d = q.shape
  if k.shape[1] != s:
    raise ValueError(f"the backward takes as many keys as queries: S_q = "
                     f"{s}, S_k = {k.shape[1]}")
  hkv = k.shape[2]
  for name, t, shape in (("out", out, (b, s, h, d)),
                         ("dout", dout, (b, s, h, d)),
                         ("lse", lse, (b, h, s))):
    _checks.expect(t, name, (torch.float32,), shape, q.device)
  delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
  dout_split = None
  if q.dtype == torch.bfloat16:
    # dout's bf16 hi and lo parts, which the tensor cores read; the
    # pre-pass reads out and dout 16 bytes at a time
    dout_split = torch.empty((2, b, s, h, d), dtype=torch.bfloat16,
                             device=q.device)
    if dout.data_ptr() % 16:
      dout = dout.clone()
    if out.data_ptr() % 16:
      out = out.clone()
  dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
  dk = torch.empty((b, s, hkv, d), dtype=q.dtype, device=q.device)
  dv = torch.empty((b, s, hkv, d), dtype=q.dtype, device=q.device)
  with torch.cuda.device(q.device):
    stream = torch.cuda.current_stream().cuda_stream
    status = _lib().fa_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        None if dout_split is None else dout_split.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, hkv, d,
        *_strides(q, k, v),
        float(sm_scale), int(bool(causal)), int(window),
        int(q.dtype == torch.bfloat16), stream)
  if status != 0:
    raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                       f"error {status}")
  LAUNCHES["flash_attention_bwd"] += 1
  return dq, dk, dv
