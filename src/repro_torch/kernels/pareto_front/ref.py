"""Plain torch versions of the Pareto dominance-count kernels (ports of
``repro.kernels.pareto_front.ref``).

All objectives are MINIMIZED.  Point ``j`` dominates point ``i`` iff
``obj[j] <= obj[i]`` on every axis and ``obj[j] < obj[i]`` on at least
one (ties and duplicates dominate nobody).  These run wherever their
input lives; the wrappers in ``ops.py`` use them for CPU tensors only.
"""
from __future__ import annotations

import torch


def dominance_counts_ref(obj: torch.Tensor) -> torch.Tensor:
  """(N, D) objectives -> (N,) int32: how many points dominate each row."""
  le = (obj[None, :, :] <= obj[:, None, :]).all(dim=-1)  # [i, j]: j <= i
  lt = (obj[None, :, :] < obj[:, None, :]).any(dim=-1)   # [i, j]: j < i
  return (le & lt).sum(dim=1, dtype=torch.int32)


def pareto_mask_ref(obj: torch.Tensor) -> torch.Tensor:
  """(N,) bool: rows no other row dominates (the exact front)."""
  return dominance_counts_ref(obj) == 0


def block_dominance_counts_ref(obj: torch.Tensor, block: int) -> torch.Tensor:
  """Per-block dominance counts: dominators are only sought within each
  row's own ``block``-sized slab (N must divide evenly; ops.py pads)."""
  n, d = obj.shape
  b = obj.reshape(n // block, block, d)
  le = (b[:, None, :, :] <= b[:, :, None, :]).all(dim=-1)
  lt = (b[:, None, :, :] < b[:, :, None, :]).any(dim=-1)
  return (le & lt).sum(dim=2, dtype=torch.int32).reshape(-1)
