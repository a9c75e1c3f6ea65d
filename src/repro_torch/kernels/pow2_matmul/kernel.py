"""Launch wrapper for the CUDA pow2 (LightPE) matmul kernel
(``csrc/pow2_matmul.cu``, built and loaded through ``ctypes``).

The wrapper takes x (M, K) float32 or bf16, the uint8 codes (K, N/2)
packed nibbles for k=1 or (K, N) bytes for k=2, and the per-column scale
(N,) float32, all contiguous on one CUDA device; it allocates the float32
(M, N) output, launches on the current stream and raises if the launch
was refused.  ``LAUNCHES`` counts its launches: one a call, whichever of
the source's three kernels ``path`` names runs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch import _build
from repro_torch.kernels._checks import expect

DTYPES = (torch.float32, torch.bfloat16)
# M at or below it runs the decode path (kDecodeMaxM of the CUDA source)
DECODE_MAX_M = 16

LAUNCHES: Dict[str, int] = {"pow2_matmul": 0}


def reset_launch_counts() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
  lib = _build.load("pow2_matmul")
  p, i64 = ctypes.c_void_p, ctypes.c_int64
  lib.p2mm_forward.argtypes = [p] * 4 + [i64] * 3 + [ctypes.c_int] * 2 + [p]
  lib.p2mm_forward.restype = ctypes.c_int
  return lib


def path(m: int, dtype: torch.dtype) -> str:
  """Which kernel of the source an (m, K) x of ``dtype`` runs."""
  if m <= DECODE_MAX_M:
    return "decode"
  return "tensor-core" if dtype == torch.bfloat16 else "cuda-core"


def check_inputs(x, codes, scale, k_terms: int) -> None:
  """Raise ValueError on what the kernel does not take."""
  if x.device.type != "cuda":
    raise ValueError(f"x: expected a CUDA tensor, got one on {x.device}")
  if k_terms not in (1, 2):
    raise ValueError(f"k_terms must be 1 or 2, got {k_terms}")
  if x.dim() != 2 or codes.dim() != 2 or scale.dim() != 1:
    raise ValueError(f"expected x (M, K), codes (K, N or N/2) and scale "
                     f"(N,), got {tuple(x.shape)}, {tuple(codes.shape)} "
                     f"and {tuple(scale.shape)}")
  m, k = x.shape
  n = scale.shape[0]
  if k_terms == 1 and n % 2:
    raise ValueError(f"k_terms=1 packs column pairs: N = {n} is odd")
  expect(x, "x", DTYPES, (m, k), x.device)
  expect(codes, "codes", (torch.uint8,),
         (k, n // 2 if k_terms == 1 else n), x.device)
  expect(scale, "scale", (torch.float32,), (n,), x.device)


def pow2_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                k_terms: int) -> torch.Tensor:
  """K4: x (M, K) @ decode(codes) (K, N), summed in float32, then times
  scale[col] -> (M, N) float32."""
  check_inputs(x, codes, scale, k_terms)
  m, k = x.shape
  n = scale.shape[0]
  out = torch.empty((m, n), dtype=torch.float32, device=x.device)
  if out.numel() == 0:
    return out
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream().cuda_stream
    status = _lib().p2mm_forward(
        x.data_ptr(), codes.data_ptr(), scale.data_ptr(), out.data_ptr(),
        m, k, n, k_terms, int(x.dtype == torch.bfloat16), stream)
  if status != 0:
    raise RuntimeError(f"pow2_matmul kernel launch failed: CUDA error "
                       f"{status}")
  LAUNCHES["pow2_matmul"] += 1
  return out
