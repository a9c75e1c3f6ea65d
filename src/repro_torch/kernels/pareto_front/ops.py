"""Public wrappers for the Pareto dominance kernels (the API of
``repro.kernels.pareto_front.ops``).

A CUDA tensor launches the hand-written kernel (``kernel.py``); a CPU
tensor runs the plain torch version (``ref.py``).  There is no other
choice and no fallback: a CUDA input whose kernel cannot build or launch
raises.  All objectives are MINIMIZED; callers negate maximize columns
first.  Comparisons run in the input dtype; the kernels take float64.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pareto_front import kernel as _kernel
from repro_torch.kernels.pareto_front import ref as _ref


def _pad_feature_major(obj: torch.Tensor, multiple: int) -> torch.Tensor:
  """(N, D) -> contiguous (D, N_padded) with +inf pad points (they
  dominate nothing, so real counts are unchanged)."""
  n, d = obj.shape
  padded = n + (-n) % multiple
  obj_t = torch.full((d, padded), float("inf"), dtype=obj.dtype,
                     device=obj.device)
  obj_t[:, :n] = obj.T
  return obj_t


def dominance_counts(obj: torch.Tensor) -> torch.Tensor:
  """(N, D) -> (N,) int32 global dominance counts (0 == on the front)."""
  if obj.device.type == "cpu":
    return _ref.dominance_counts_ref(obj)
  n = obj.shape[0]
  obj_t = _pad_feature_major(obj, _kernel.PAIR_TILE)
  return _kernel.dominance_counts(obj_t)[:n]


def pareto_front_mask(obj: torch.Tensor) -> torch.Tensor:
  """(N,) bool exact non-dominated mask via pairwise dominance counts.

  O(N^2) compares: meant for candidate sets that already passed
  :func:`block_prefilter_mask`, not raw million-row sweeps.
  """
  return dominance_counts(obj) == 0


def block_prefilter_mask(obj: torch.Tensor, block: int = 128) -> torch.Tensor:
  """(N,) bool block-decomposed front *superset* mask.

  Every global front point is non-dominated within its own block, and
  every dominated point is dominated by some front point (transitivity),
  so the union of per-block fronts is an exact superset of the global
  front.  Cost is O(N * block), never O(N^2).
  """
  n = obj.shape[0]
  if n == 0:
    return torch.zeros(0, dtype=torch.bool, device=obj.device)
  obj_t = _pad_feature_major(obj, block)
  if obj.device.type == "cpu":
    counts = _ref.block_dominance_counts_ref(obj_t.T, block)
  else:
    counts = _kernel.block_dominance_counts(obj_t, block)
  return counts[:n] == 0
