"""Launch wrapper for the CUDA W8A8 int8 matmul kernel
(``csrc/int8_matmul.cu``, built and loaded through ``ctypes``).

The wrapper takes int8 codes x (M, K) and w (K, N), the per-row scales of
x (M,) float32 or bf16 and the per-column scales of w (N,) float32, all
contiguous on one CUDA device; it allocates the float32 (M, N) output,
launches on the current stream and raises if the launch was refused.
``LAUNCHES`` counts its launches: one a call, whichever of the source's
two kernels ``path`` names runs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch import _build
from repro_torch.kernels._checks import expect

# M at or below it runs the decode path (kDecodeMaxM of the CUDA source)
DECODE_MAX_M = 16

LAUNCHES: Dict[str, int] = {"int8_matmul": 0}


def reset_launch_counts() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
  lib = _build.load("int8_matmul")
  p, i64 = ctypes.c_void_p, ctypes.c_int64
  lib.i8mm_forward.argtypes = [p] * 5 + [i64] * 3 + [ctypes.c_int, p]
  lib.i8mm_forward.restype = ctypes.c_int
  lib.i8mm_plan.argtypes = [i64] * 3 + [ctypes.POINTER(ctypes.c_int)]
  lib.i8mm_plan.restype = None
  return lib


def path(m: int) -> str:
  """Which kernel of the source an (m, K) x runs."""
  return "decode" if m <= DECODE_MAX_M else "tensor-core"


def describe(m: int, k: int, n: int) -> str:
  """The kernel, tile and split of K that the source picks for a shape
  (asks the built library, so only where the kernels build)."""
  plan = (ctypes.c_int * 3)()
  _lib().i8mm_plan(m, k, n, plan)
  kind, rows, splits = plan
  if kind == 0:
    return (f"decode path, x rows staged {rows}, K split over {splits} "
            f"blocks")
  return (f"tensor-core path, {rows} x 128 tiles, K split over {splits} "
          f"block{'s' if splits > 1 else ''}")


def check_inputs(x, w, x_scale, w_scale) -> None:
  """Raise ValueError on what the kernel does not take."""
  if x.device.type != "cuda":
    raise ValueError(f"x: expected a CUDA tensor, got one on {x.device}")
  if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
    raise ValueError(f"expected x (M, K) and w (K, N), got "
                     f"{tuple(x.shape)} and {tuple(w.shape)}")
  m, k = x.shape
  n = w.shape[1]
  expect(x, "x", (torch.int8,), (m, k), x.device)
  expect(w, "w", (torch.int8,), (k, n), x.device)
  expect(x_scale, "x_scale", (torch.float32, torch.bfloat16), (m,),
         x.device)
  expect(w_scale, "w_scale", (torch.float32,), (n,), x.device)


def int8_matmul(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
  """K3: int8 (M, K) @ int8 (K, N) -> (M, N) float32, each int32 sum
  times x_scale[row], then times w_scale[col]."""
  check_inputs(x, w, x_scale, w_scale)
  m, k = x.shape
  n = w.shape[1]
  out = torch.empty((m, n), dtype=torch.float32, device=x.device)
  if out.numel() == 0:
    return out
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream().cuda_stream
    status = _lib().i8mm_forward(
        x.data_ptr(), w.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), m, k, n, int(x_scale.dtype == torch.bfloat16),
        stream)
  if status != 0:
    raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error "
                       f"{status}")
  LAUNCHES["int8_matmul"] += 1
  return out
