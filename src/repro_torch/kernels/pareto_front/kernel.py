"""Launch wrappers for the CUDA dominance-count kernels
(``csrc/pareto_front.cu``, built and loaded through ``ctypes``).

Each wrapper takes the feature-major ``(D, N)`` float64 objectives on a
CUDA device, already padded with +inf to its tile multiple, allocates the
int32 counts, launches on the current stream and raises if the launch
was refused.  ``LAUNCHES`` counts the launches of each kernel: a run that
zeroes it before driving the sweep can show which kernels the sweep went
through.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict

import torch

from repro_torch import _build

# K2's i and j tile (kPairTile in the CUDA source)
PAIR_TILE = 256
# K2's blocks an SM that pair_splits aims for
PAIR_BLOCKS_PER_SM = 2

LAUNCHES: Dict[str, int] = {"block_dominance_counts": 0,
                            "dominance_counts": 0}
# worker threads of a threaded stream launch concurrently
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
  lib = _build.load("pareto_front")
  p, i64 = ctypes.c_void_p, ctypes.c_int64
  lib.pf_block_dominance_counts.argtypes = [p, i64, i64, i64, p, p]
  lib.pf_block_dominance_counts.restype = ctypes.c_int
  lib.pf_dominance_counts.argtypes = [p, i64, i64, i64, p, p]
  lib.pf_dominance_counts.restype = ctypes.c_int
  return lib


def _check_input(obj_t: torch.Tensor, multiple: int) -> None:
  if obj_t.device.type != "cuda":
    raise ValueError(f"expected a CUDA tensor, got one on {obj_t.device}")
  if obj_t.dtype != torch.float64:
    raise ValueError(f"expected float64 objectives, got {obj_t.dtype}")
  if obj_t.dim() != 2 or not obj_t.is_contiguous():
    raise ValueError("expected contiguous (D, N) objectives")
  d, n = obj_t.shape
  if d not in (2, 3, 4):
    raise ValueError(f"the kernels take 2 to 4 objectives, got {d}")
  if n % multiple:
    raise ValueError(f"N = {n} is not a multiple of {multiple}")


def _launched(name: str, status: int) -> None:
  if status != 0:
    raise RuntimeError(f"{name} kernel launch failed: CUDA error {status}")
  with _COUNT_LOCK:
    LAUNCHES[name] += 1


def block_dominance_counts(obj_t: torch.Tensor, block: int) -> torch.Tensor:
  """K1: (D, N) -> (N,) int32 dominators within each point's block."""
  if not 1 <= block <= 1024:
    raise ValueError(f"block must be in [1, 1024], got {block}")
  _check_input(obj_t, block)
  d, n = obj_t.shape
  counts = torch.empty(n, dtype=torch.int32, device=obj_t.device)
  with torch.cuda.device(obj_t.device):
    stream = torch.cuda.current_stream().cuda_stream
    status = _lib().pf_block_dominance_counts(
        obj_t.data_ptr(), d, n, block, counts.data_ptr(), stream)
  _launched("block_dominance_counts", status)
  return counts


def pair_splits(n: int, sms: int) -> int:
  """K2's splits of the j tiles at N points on a card of ``sms`` SMs: the
  fewest that give (N / 256 i tiles) x splits >= 2 blocks an SM, at most
  one j tile a split."""
  tiles = max(1, n // PAIR_TILE)
  want = -(-PAIR_BLOCKS_PER_SM * sms // tiles)
  return max(1, min(tiles, want))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
  return torch.cuda.get_device_properties(index).multi_processor_count


def dominance_counts(obj_t: torch.Tensor) -> torch.Tensor:
  """K2: (D, N) -> (N,) int32 global dominance counts; the j tiles split
  over ``pair_splits(N, the card's SMs)`` blocks an i tile."""
  _check_input(obj_t, PAIR_TILE)
  d, n = obj_t.shape
  splits = pair_splits(n, _sm_count(obj_t.device.index))
  counts = torch.empty(n, dtype=torch.int32, device=obj_t.device)
  with torch.cuda.device(obj_t.device):
    stream = torch.cuda.current_stream().cuda_stream
    status = _lib().pf_dominance_counts(obj_t.data_ptr(), d, n, splits,
                                        counts.data_ptr(), stream)
  _launched("dominance_counts", status)
  return counts
