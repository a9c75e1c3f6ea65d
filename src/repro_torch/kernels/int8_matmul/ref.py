"""Plain torch version of the W8A8 int8 matmul kernel (the port of
``repro.kernels.int8_matmul.ref``).

The int32 accumulator is taken as a float64 matrix product: every product
of two int8 codes and every partial sum is an integer below 2^53 (at most
128^2 x K), so the sum is exact in any order, on the CPU and on a CUDA
card alike (where no integer matmul exists).  Its float32 rounding equals
the reference's int32 -> float32 cast.  The epilogue is the reference's
two float32 multiplies, left to right.  It runs wherever its input lives;
the wrapper in ``ops.py`` uses it for CPU tensors only.
"""
from __future__ import annotations

import torch


def int8_matmul_ref(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
                    w_scale: torch.Tensor) -> torch.Tensor:
  """int8 x (M, K) @ int8 w (K, N) -> f32 (M, N), scaled per row of x
  (``x_scale`` f32 or bf16) and per column of w (``w_scale`` f32)."""
  acc = torch.matmul(x.to(torch.float64), w.to(torch.float64))
  return (acc.to(torch.float32) * x_scale.reshape(-1, 1).to(torch.float32)
          * w_scale.reshape(1, -1).to(torch.float32))
