"""Launch wrapper for the CUDA prefill flash-attention kernel
(``csrc/flash_attention.cu``, built and loaded through ``ctypes``).

The wrapper takes q (B, S, H, D) and k/v (B, S, Hkv, D) on one CUDA
device, float32 or bf16, in any strides whose last dim is contiguous,
allocates the f32 output, launches on the current stream and raises if
the launch was refused.  bf16 runs on the tensor cores and its tiles
arrive by 16-byte asynchronous copies, so bf16 bases must be 16-byte
aligned and their batch, sequence and head strides multiples of 8
elements (the model's q, k and the ``kv[:, :, 1]`` view of v are).
``LAUNCHES`` counts its launches, so a run that zeroes it before driving
the model can show that prefill went through it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch import _build

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES: Dict[str, int] = {"flash_attention": 0}


def reset_launch_counts() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
  lib = _build.load("flash_attention")
  p, i64 = ctypes.c_void_p, ctypes.c_int64
  lib.fa_forward.argtypes = ([p, p, p, p] + [i64] * 14
                             + [ctypes.c_float, ctypes.c_int, i64,
                                ctypes.c_int, p])
  lib.fa_forward.restype = ctypes.c_int
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
  if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != d:
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
  """K6: (B, S, H, D) x (B, S, Hkv, D) -> (B, S, H, D) float32."""
  check_inputs(q, k, v)
  if window < 0:
    raise ValueError(f"window must be >= 0, got {window}")
  b, s, h, d = q.shape
  out = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
  with torch.cuda.device(q.device):
    stream = torch.cuda.current_stream().cuda_stream
    status = _lib().fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, k.shape[2], d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(sm_scale), int(bool(causal)), int(window),
        int(q.dtype == torch.bfloat16), stream)
  if status != 0:
    raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                       f"{status}")
  LAUNCHES["flash_attention"] += 1
  return out
