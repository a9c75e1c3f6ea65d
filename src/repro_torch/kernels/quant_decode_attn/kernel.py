"""Launch wrapper for the CUDA quantized-KV decode attention kernel
(``csrc/quant_decode_attn.cu``, built and loaded through ``ctypes``).

The wrapper takes one decode token's q (B, H, D), an int8 cache
(B, Hkv, S, D) with its f32 scales (B, Hkv, S) and the per-row fill
``length`` (B,) int32, all contiguous on one CUDA device; it allocates the
f32 output, launches on the current stream and raises if the launch was
refused.  ``length`` stays on the device: the kernel reads it there, so a
call captures into a CUDA graph whose replays follow it.  The kernel
splits the cache into chunks of ``kSplit`` positions dealt to at most
``kMaxSplits`` blocks per (batch, kv head), one thread-block cluster that
merges its partials in shared memory.  A block takes all G = H / Hkv
query heads of its kv head for G up to 8 (``GROUPS`` holds 1, 2, 3, 4, 6
and 8); a group of 16 or 48 (granite-34b's multi-query heads) is split
into sub-groups of 8 on a third grid axis, each reading the same codes.
``LAUNCHES`` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch import _build
from repro_torch.kernels._checks import expect

HEAD_DIMS = (16, 32, 64, 128)
# H / Hkv the kernel takes: every group the model zoo uses (qwen3 2,
# minitron 3, pixtral 4, mixtral 6, granite 48, and 1), and 8 and 16
GROUPS = (1, 2, 3, 4, 6, 8, 16, 48)

LAUNCHES: Dict[str, int] = {"quant_decode_attn": 0}


def reset_launch_counts() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
  lib = _build.load("quant_decode_attn")
  p, i64 = ctypes.c_void_p, ctypes.c_int64
  lib.qda_forward.argtypes = ([p] * 7 + [i64] * 5
                              + [ctypes.c_float, ctypes.c_int, p])
  lib.qda_forward.restype = ctypes.c_int
  return lib


def _expect(t: torch.Tensor, name: str, dtypes, shape, device) -> None:
  expect(t, name, dtypes, shape, device)
  if t.data_ptr() % 16:
    raise ValueError(f"{name} must be 16-byte aligned")


def check_inputs(q, k_codes, k_scale, v_codes, v_scale, length) -> None:
  """Raise ValueError on what the kernel does not take."""
  if q.device.type != "cuda":
    raise ValueError(f"q: expected a CUDA tensor, got one on {q.device}")
  if q.dim() != 3 or k_codes.dim() != 4:
    raise ValueError(f"expected q (B, H, D) and codes (B, Hkv, S, D), got "
                     f"{tuple(q.shape)} and {tuple(k_codes.shape)}")
  b, h, d = q.shape
  _, hkv, s, _ = k_codes.shape
  _expect(q, "q", (torch.float32, torch.bfloat16), (b, h, d), q.device)
  for name, t in (("k_codes", k_codes), ("v_codes", v_codes)):
    _expect(t, name, (torch.int8,), (b, hkv, s, d), q.device)
  for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
    _expect(t, name, (torch.float32,), (b, hkv, s), q.device)
  _expect(length, "length", (torch.int32,), (b,), q.device)
  if hkv == 0 or h % hkv or h // hkv not in GROUPS:
    raise ValueError(f"H / Hkv = {h} / {hkv} must be one of {GROUPS}")
  if d not in HEAD_DIMS:
    raise ValueError(f"head dim {d} not in {HEAD_DIMS}")


def quant_decode_attn(q: torch.Tensor, k_codes: torch.Tensor,
                      k_scale: torch.Tensor, v_codes: torch.Tensor,
                      v_scale: torch.Tensor, length: torch.Tensor,
                      sm_scale: float) -> torch.Tensor:
  """K5: q (B, H, D) x int8 cache (B, Hkv, S, D) -> (B, H, D) float32."""
  check_inputs(q, k_codes, k_scale, v_codes, v_scale, length)
  b, h, d = q.shape
  _, hkv, s, _ = k_codes.shape
  out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
  with torch.cuda.device(q.device):
    stream = torch.cuda.current_stream().cuda_stream
    status = _lib().qda_forward(
        q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        v_codes.data_ptr(), v_scale.data_ptr(), length.data_ptr(),
        out.data_ptr(), b, hkv, h // hkv, s, d, float(sm_scale),
        int(q.dtype == torch.bfloat16), stream)
  if status != 0:
    raise RuntimeError(f"quant_decode_attn kernel launch failed: CUDA "
                       f"error {status}")
  LAUNCHES["quant_decode_attn"] += 1
  return out
