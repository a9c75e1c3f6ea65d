"""Plain torch version of the pow2 (LightPE) matmul kernel (the port of
``repro.kernels.pow2_matmul.ref``): decode the codes to exact float32
weights with the per-column scale folded in, then one float32 matmul.
It runs wherever its input lives; the wrapper in ``ops.py`` uses it for
CPU tensors only.  The kernel instead multiplies by the scale after the K
sum, as the TPU kernel does, so the two differ by rounding;
``pow2_matmul_kernel_order`` repeats the kernel's own order on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import pow2_decode_codes, unpack_nibbles


def decode_weights(codes: torch.Tensor, scale: torch.Tensor,
                   k_terms: int) -> torch.Tensor:
  """codes (packed for k=1) + per-output-channel scale -> f32 (K, N)."""
  if k_terms == 1:
    codes = unpack_nibbles(codes)
  vals = pow2_decode_codes(codes, k_terms)
  return vals * scale.reshape(1, -1)


def pow2_matmul_ref(x: torch.Tensor, codes: torch.Tensor,
                    scale: torch.Tensor, k_terms: int) -> torch.Tensor:
  w = decode_weights(codes, scale, k_terms)
  return torch.matmul(x.to(torch.float32), w)


def _fma_sum(x: torch.Tensor, w: torch.Tensor, rows) -> torch.Tensor:
  """sum over ``rows`` of x[:, k] * w[k] in float32, one fused multiply-add
  at a time in the order given (the product is exact in float64)."""
  acc = torch.zeros((x.shape[0], w.shape[1]))
  for k in rows:
    acc = (acc.double() + x[:, k:k + 1].double() * w[k:k + 1].double()).float()
  return acc


def pow2_matmul_kernel_order(x: torch.Tensor, codes: torch.Tensor,
                             scale: torch.Tensor, k_terms: int, *,
                             decode_max_m: int, dec_tile_k: int,
                             dec_lanes: int, max_splits: int,
                             tc_tile_k: int) -> torch.Tensor:
  """K4's arithmetic in the CUDA kernel's order, on the CPU.  The sizes
  are the kernel's constants (the tests read them from its source).

  * M <= ``decode_max_m``: the K tiles of ``dec_tile_k`` rows are split
    into contiguous ranges over min(``max_splits``, tiles) blocks; in a
    block, lane g fuses x * w over the rows k with k % ``dec_lanes`` == g
    in order, the lanes' sums are added in lane order and the blocks' in
    rank order.
  * larger M, bf16 x: bf16 operands (the weights are exact in bf16), each
    ``tc_tile_k``-row tile's product summed in float32 and added tile by
    tile (the tensor cores' order inside a tile is the hardware's).
  * larger M, float32 x: one float32 product.

  Then one multiply by the column's scale.  Nothing on the main path calls
  it: it shows on the CPU that the kernel's order keeps the function.
  """
  w = pow2_decode_codes(unpack_nibbles(codes) if k_terms == 1 else codes,
                        k_terms).float()
  m, kdim = x.shape
  if m <= decode_max_m:
    tiles = -(-kdim // dec_tile_k)
    splits = max(1, min(max_splits, tiles))
    base, extra = divmod(tiles, splits)
    acc = torch.zeros((m, w.shape[1]))
    for rank in range(splits):
      first = rank * base + min(rank, extra)
      lo = first * dec_tile_k
      hi = min(kdim, (first + base + (rank < extra)) * dec_tile_k)
      lanes = [_fma_sum(x.float(), w, [k for k in range(lo, hi)
                                       if k % dec_lanes == g])
               for g in range(dec_lanes)]
      part = lanes[0]
      for lane in lanes[1:]:
        part = part + lane
      acc = part if rank == 0 else acc + part
  elif x.dtype == torch.bfloat16:
    wb = w.to(torch.bfloat16)
    assert torch.equal(wb.float(), w)
    acc = torch.zeros((m, w.shape[1]))
    for lo in range(0, kdim, tc_tile_k):
      hi = min(kdim, lo + tc_tile_k)
      acc = acc + torch.matmul(x[:, lo:hi].float(), wb[lo:hi].float())
  else:
    acc = torch.matmul(x.float(), w)
  return acc * scale.reshape(1, -1)
