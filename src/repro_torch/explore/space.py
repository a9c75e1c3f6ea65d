"""Declarative design-space specification + deterministic columnar sampling
(host numpy copy of ``repro.explore.space``'s table samplers).

A :class:`DesignSpace` is one :class:`Axis` per hardware knob (defaults
from ``HW_RANGES``, Sec. 3.3), a set of PE types and optional constraint
predicates.  ``sample_table`` and its lazy twin ``iter_tables`` draw the
same design points, bit for bit, as the reference for the same seed and
method (``random`` / ``grid`` / ``stratified``): the seeded numpy
``RandomState`` streams are the determinism contract.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np

from repro_torch.core.dataflow import AcceleratorConfig
from repro_torch.core.pe import PAPER_PE_TYPES
from repro_torch.core.ppa import HW_RANGES
from repro_torch.core.table import ConfigTable

# canonical axis order == AcceleratorConfig field order == the RNG call
# order of the reference sampler (determinism contract, do not reorder)
AXIS_ORDER = ("pe_rows", "pe_cols", "sp_if", "sp_fw", "sp_ps", "gbuf_kb",
              "bandwidth_gbps")

Constraint = Callable[[AcceleratorConfig], bool]


class VectorConstraint:
  """A constraint with a columnar mask over a :class:`ConfigTable` beside
  its per-config predicate; plain callables remain valid constraints but
  are evaluated row by row."""

  def __init__(self, scalar: Constraint,
               mask: Callable[[ConfigTable], np.ndarray]):
    self._scalar = scalar
    self.mask = mask

  def __call__(self, cfg: AcceleratorConfig) -> bool:
    return bool(self._scalar(cfg))


@dataclasses.dataclass(frozen=True)
class Axis:
  """One discrete hardware knob: a name and its allowed values."""
  name: str
  values: Tuple[float, ...]

  def __post_init__(self):
    if self.name not in AXIS_ORDER:
      raise ValueError(f"unknown axis {self.name!r}; one of {AXIS_ORDER}")
    if not self.values:
      raise ValueError(f"axis {self.name!r} has no values")


_METHODS = ("random", "grid", "stratified")


class DesignSpace:
  """The declarative spec every exploration entry point consumes."""

  def __init__(self, pe_types: Sequence[str] = PAPER_PE_TYPES,
               axes: Optional[Mapping[str, Sequence[float]]] = None,
               constraints: Sequence[Constraint] = ()):
    self.pe_types = tuple(pe_types)
    overrides = dict(axes or {})
    unknown = set(overrides) - set(AXIS_ORDER)
    if unknown:
      raise ValueError(f"unknown axes {sorted(unknown)}; one of {AXIS_ORDER}")
    self.axes: Tuple[Axis, ...] = tuple(
        Axis(name, tuple(overrides.get(name, HW_RANGES[name])))
        for name in AXIS_ORDER)
    self.constraints = tuple(constraints)

  def size(self) -> int:
    """Cardinality of the unconstrained space (all PE types)."""
    return math.prod(len(a.values) for a in self.axes) * len(self.pe_types)

  def __repr__(self) -> str:
    dims = "x".join(str(len(a.values)) for a in self.axes)
    return (f"DesignSpace({len(self.pe_types)} PE types x {dims} grid, "
            f"{len(self.constraints)} constraints, size={self.size():,})")

  # -- construction helpers ------------------------------------------------

  def _table_mask(self, table: ConfigTable) -> np.ndarray:
    """Constraint mask over a candidate table."""
    mask = np.ones(len(table), np.bool_)
    for c in self.constraints:
      if hasattr(c, "mask"):
        mask &= np.asarray(c.mask(table), np.bool_)
      else:
        idx = np.flatnonzero(mask)
        scalar = np.asarray([bool(c(table.config_at(int(i)))) for i in idx])
        mask[idx] &= scalar
    return mask

  def _make_table(self, pe_type: str, cols: Dict[str, np.ndarray]
                  ) -> ConfigTable:
    n = len(cols[AXIS_ORDER[0]])
    cast = {name: (np.asarray(v, np.float64) if name == "bandwidth_gbps"
                   else np.asarray(v).astype(np.int64))
            for name, v in cols.items()}
    return ConfigTable.full(pe_type, n, cast)

  def _empty_table(self, pe_type: str) -> ConfigTable:
    return self._make_table(
        pe_type, {a.name: np.asarray(a.values)[:0] for a in self.axes})

  # -- sampling ------------------------------------------------------------

  def sample_type_table(self, pe_type: str, n: int, seed: int = 0,
                        method: str = "random") -> ConfigTable:
    """n deterministic design points of one PE type (fewer when
    constraints filter grid/stratified points)."""
    parts = list(self.iter_type_tables(pe_type, n, seed=seed, method=method,
                                       chunk_size=max(n, 1024)))
    return ConfigTable.concat(parts) if parts else self._empty_table(pe_type)

  def sample_table(self, n_per_type: int, seed: int = 0,
                   method: str = "random") -> ConfigTable:
    """n_per_type points of every PE type (per-type seeds ``seed + 100*i``)."""
    return ConfigTable.concat([
        self.sample_type_table(t, n_per_type, seed=seed + 100 * i,
                               method=method)
        for i, t in enumerate(self.pe_types)])

  def iter_type_tables(self, pe_type: str, n: int, seed: int = 0,
                       method: str = "random", chunk_size: int = 65536
                       ) -> Iterator[ConfigTable]:
    """Lazy twin of :meth:`sample_type_table`: chunks of <= chunk_size rows
    whose concatenation is bit-identical to the one-shot table."""
    if pe_type not in self.pe_types:
      raise ValueError(f"{pe_type!r} not in this space's {self.pe_types}")
    if chunk_size <= 0:
      raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    if method not in _METHODS:
      raise ValueError(f"unknown sampling method {method!r}; "
                       f"one of {_METHODS}")
    if method == "random":
      return self._iter_random_table(pe_type, n, seed, chunk_size)
    if method == "grid":
      return self._iter_grid_table(pe_type, n, chunk_size)
    return self._iter_stratified_table(pe_type, n, seed, chunk_size)

  def iter_tables(self, n_per_type: int, seed: int = 0,
                  method: str = "random", chunk_size: int = 65536
                  ) -> Iterator[ConfigTable]:
    """Lazy twin of :meth:`sample_table`; chunks arrive per PE type, in
    type order."""
    for i, t in enumerate(self.pe_types):
      yield from self.iter_type_tables(t, n_per_type, seed=seed + 100 * i,
                                       method=method, chunk_size=chunk_size)

  def _axis_rngs(self, seed: int) -> List[np.random.RandomState]:
    """One independent RandomState per axis, derived from (seed, axis
    index): the i-th value of an axis is the same for every batching."""
    return [np.random.RandomState(
        np.asarray([seed % (2 ** 32), 0x9E3779B9 ^ ai], np.uint32))
            for ai in range(len(self.axes))]

  def _iter_random_table(self, pe_type: str, n: int, seed: int,
                         chunk_size: int) -> Iterator[ConfigTable]:
    """Fixed per-axis RNG sequences, filtered row-local by constraints,
    truncated to the first n passing rows."""
    if n <= 0:
      return
    rngs = self._axis_rngs(seed)
    have = 0
    drawn = 0
    max_draws = max(1000 * n, 1000)
    while have < n:
      batch = min(chunk_size, max_draws - drawn)
      if batch <= 0:
        raise ValueError(
            f"constraints rejected all but {have}/{n} of {drawn} draws; the "
            f"constrained space is (nearly) empty for {pe_type}")
      cols = {a.name: np.asarray(a.values)[
          rng.randint(0, len(a.values), size=batch)]
          for a, rng in zip(self.axes, rngs)}
      drawn += batch
      cand = self._make_table(pe_type, cols)
      mask = self._table_mask(cand)
      kept = cand if mask.all() else cand.select(mask)
      if len(kept) > n - have:
        kept = kept.select(slice(0, n - have))
      have += len(kept)
      if len(kept):
        yield kept

  def _grid_flat_indices(self, n: int, total: int, lo: int, hi: int,
                         prev_last: int) -> np.ndarray:
    """Flat grid indices for linspace positions [lo, hi), deduplicated
    like the one-shot ``np.unique(np.linspace(...))``."""
    if n >= total:
      return np.arange(lo, hi, dtype=np.int64)
    pos = np.arange(lo, hi, dtype=np.int64)
    if n == 1:
      flat = np.zeros(pos.shape, np.int64)
    else:
      # mirror np.linspace(0, total-1, n): arange * step, endpoint pinned
      flat = (pos * ((total - 1) / (n - 1))).astype(np.int64)
      flat[pos == n - 1] = total - 1
    keep = np.empty(flat.shape, np.bool_)
    if flat.size:
      keep[0] = flat[0] != prev_last
      keep[1:] = flat[1:] != flat[:-1]
    return flat[keep]

  def _iter_grid_table(self, pe_type: str, n: int, chunk_size: int
                       ) -> Iterator[ConfigTable]:
    sizes = [len(a.values) for a in self.axes]
    total = math.prod(sizes)
    n_pos = total if n >= total else max(n, 0)
    prev_last = -1
    for lo in range(0, n_pos, chunk_size):
      flat = self._grid_flat_indices(n, total, lo,
                                     min(lo + chunk_size, n_pos), prev_last)
      if not flat.size:
        continue
      prev_last = int(flat[-1])
      idx = flat.copy()
      cols: Dict[str, np.ndarray] = {}
      for a, size in zip(reversed(self.axes), reversed(sizes)):
        cols[a.name] = np.asarray(a.values)[idx % size]
        idx //= size
      table = self._make_table(pe_type, cols)
      table = table.select(self._table_mask(table))
      if len(table):
        yield table

  def _iter_stratified_table(self, pe_type: str, n: int, seed: int,
                             chunk_size: int) -> Iterator[ConfigTable]:
    rng = np.random.RandomState(seed)
    idx_cols: Dict[str, np.ndarray] = {}
    for a in self.axes:  # AXIS_ORDER: fixed RNG consumption order
      bins = (np.arange(n) * len(a.values)) // n
      idx_cols[a.name] = bins[rng.permutation(n)].astype(np.uint16)
    for lo in range(0, n, chunk_size):
      sl = slice(lo, lo + chunk_size)
      table = self._make_table(
          pe_type, {a.name: np.asarray(a.values)[idx_cols[a.name][sl]]
                    for a in self.axes})
      table = table.select(self._table_mask(table))
      if len(table):
        yield table
