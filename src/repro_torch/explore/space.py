"""Declarative design-space specification + deterministic sampling (host
numpy copy of ``repro.explore.space``).

A :class:`DesignSpace` is one :class:`Axis` per hardware knob (defaults
from ``HW_RANGES``, Sec. 3.3), a set of PE types and optional constraint
predicates.  The list samplers (``sample`` / ``sample_type``: per-point
configs), ``sample_table`` and its lazy twin ``iter_tables`` draw the
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


def vector_constraint(scalar: Constraint,
                      mask: Callable[[ConfigTable], np.ndarray]
                      ) -> VectorConstraint:
  """Pair a scalar predicate with its vectorized table mask, e.g.::

      vector_constraint(lambda c: c.n_pe <= 256,
                        lambda t: t.n_pe <= 256)
  """
  return VectorConstraint(scalar, mask)


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

  def axis(self, name: str) -> Axis:
    for a in self.axes:
      if a.name == name:
        return a
    raise KeyError(name)

  def size(self) -> int:
    """Cardinality of the unconstrained space (all PE types)."""
    return self.per_type_grid_size() * len(self.pe_types)

  def per_type_grid_size(self) -> int:
    """Cardinality of one PE type's unconstrained axis grid."""
    return math.prod(len(a.values) for a in self.axes)

  def __repr__(self) -> str:
    dims = "x".join(str(len(a.values)) for a in self.axes)
    return (f"DesignSpace({len(self.pe_types)} PE types x {dims} grid, "
            f"{len(self.constraints)} constraints, size={self.size():,})")

  # -- subgrid diffing -------------------------------------------------------

  def with_axes(self, **overrides) -> "DesignSpace":
    """A copy of this space with the given axes' value tuples replaced
    (PE types and constraints carried over)."""
    axes = {a.name: a.values for a in self.axes}
    axes.update({name: tuple(vals) for name, vals in overrides.items()})
    return DesignSpace(self.pe_types, axes, self.constraints)

  def axis_delta(self, base) -> Optional[Tuple[str, Tuple[float, ...]]]:
    """The single-axis edit turning ``base`` into this space, if any.

    Returns ``(axis_name, added_values)`` when exactly one axis differs
    and the base axis' values appear in this axis' values in the same
    relative order (an in-order supersequence), which keeps the
    :meth:`grid_rank` remap of base points strictly monotone.  ``base``
    may be another DesignSpace or a ``{axis: values}`` mapping.  None when
    the spaces are identical, differ on more than one axis, drop values,
    or break the order condition.
    """
    if isinstance(base, DesignSpace):
      if (self.pe_types != base.pe_types
          or len(self.constraints) != len(base.constraints)):
        return None
      base_axes = {a.name: a.values for a in base.axes}
    else:
      base_axes = {name: tuple(vals) for name, vals in dict(base).items()}
      if set(base_axes) != {a.name for a in self.axes}:
        return None
    diff: Optional[Tuple[str, Tuple[float, ...]]] = None
    for a in self.axes:
      bv = base_axes[a.name]
      if tuple(a.values) == bv:
        continue
      if diff is not None:
        return None  # more than one axis edited
      it = iter(a.values)
      if not all(any(v == w for w in it) for v in bv):
        return None  # a base value was dropped or reordered
      base_set = set(bv)
      added = tuple(v for v in a.values if v not in base_set)
      if len(added) + len(bv) != len(a.values):
        return None  # duplicated values
      diff = (a.name, added)
    return diff

  def grid_rank(self, table: ConfigTable) -> np.ndarray:
    """Canonical global row ids: each row's mixed-radix rank in this
    space's full-grid enumeration (PE-type-major, axes in AXIS_ORDER with
    the last axis fastest — the ``method="grid"`` visit order), a pure
    function of the row's values."""
    try:
      code_to_type = np.asarray(
          [self.pe_types.index(nm) for nm in table.pe_type_names], np.int64)
    except ValueError:
      raise ValueError("table contains PE types outside this space")
    rank = code_to_type[np.asarray(table.pe_code, np.int64)]
    for a in self.axes:
      vals = np.asarray(a.values)
      col = np.asarray(getattr(table, a.name))
      order = np.argsort(vals, kind="stable")
      pos = np.clip(np.searchsorted(vals[order], col), 0, len(vals) - 1)
      ai = order[pos]
      if not np.array_equal(vals[ai], col.astype(vals.dtype)):
        raise ValueError(f"axis {a.name!r}: table values outside this space")
      rank = rank * len(vals) + ai
    return rank.astype(np.int64)

  # -- construction helpers ------------------------------------------------

  def _make(self, pe_type: str, values: Dict[str, float]) -> AcceleratorConfig:
    kw = {name: (float(v) if name == "bandwidth_gbps" else int(v))
          for name, v in values.items()}
    return AcceleratorConfig(pe_type=pe_type, **kw)

  def _passes(self, cfg: AcceleratorConfig) -> bool:
    return all(c(cfg) for c in self.constraints)

  def table_mask(self, table: ConfigTable) -> np.ndarray:
    """Constraint mask over a candidate table.  VectorConstraints filter
    whole columns; plain predicates fall back to row-by-row configs."""
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

  # -- list sampling (per-point configs) ------------------------------------

  def sample_type(self, pe_type: str, n: int, seed: int = 0,
                  method: str = "random") -> List[AcceleratorConfig]:
    """n deterministic configs of one PE type (may return fewer than n for
    grid/stratified when constraints filter points)."""
    if pe_type not in self.pe_types:
      raise ValueError(f"{pe_type!r} not in this space's {self.pe_types}")
    if method == "random":
      return self._sample_random(pe_type, n, seed)
    if method == "grid":
      return self._sample_grid(pe_type, n)
    if method == "stratified":
      return self._sample_stratified(pe_type, n, seed)
    raise ValueError(f"unknown sampling method {method!r}; "
                     f"one of {_METHODS}")

  def sample(self, n_per_type: int, seed: int = 0, method: str = "random"
             ) -> List[AcceleratorConfig]:
    """n_per_type configs for every PE type (per-type seeds
    ``seed + 100*i``)."""
    out: List[AcceleratorConfig] = []
    for i, t in enumerate(self.pe_types):
      out.extend(self.sample_type(t, n_per_type, seed=seed + 100 * i,
                                  method=method))
    return out

  def _sample_random(self, pe_type: str, n: int, seed: int
                     ) -> List[AcceleratorConfig]:
    rng = np.random.RandomState(seed)
    out: List[AcceleratorConfig] = []
    tries = 0
    max_tries = max(1000 * n, 1000)
    while len(out) < n:
      if tries >= max_tries:
        raise ValueError(
            f"constraints rejected {tries} straight samples; the "
            f"constrained space is (nearly) empty for {pe_type}")
      cfg = self._make(pe_type,
                       {a.name: rng.choice(a.values) for a in self.axes})
      tries += 1
      if self._passes(cfg):
        out.append(cfg)
    return out

  def _sample_grid(self, pe_type: str, n: int) -> List[AcceleratorConfig]:
    sizes = [len(a.values) for a in self.axes]
    total = math.prod(sizes)
    if n >= total:
      flat = np.arange(total, dtype=np.int64)
    else:
      flat = np.unique(np.linspace(0, total - 1, n).astype(np.int64))
    out = []
    for idx in flat:
      values = {}
      for a, size in zip(reversed(self.axes), reversed(sizes)):
        values[a.name] = a.values[int(idx % size)]
        idx //= size
      cfg = self._make(pe_type, values)
      if self._passes(cfg):
        out.append(cfg)
    return out

  def _sample_stratified(self, pe_type: str, n: int, seed: int
                         ) -> List[AcceleratorConfig]:
    rng = np.random.RandomState(seed)
    cols: Dict[str, np.ndarray] = {}
    for a in self.axes:  # AXIS_ORDER: fixed RNG consumption order
      bins = (np.arange(n) * len(a.values)) // n  # even per-value coverage
      cols[a.name] = np.asarray(a.values)[bins][rng.permutation(n)]
    out = []
    for i in range(n):
      cfg = self._make(pe_type, {name: cols[name][i] for name in cols})
      if self._passes(cfg):
        out.append(cfg)
    return out

  # -- columnar sampling -----------------------------------------------------

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
      mask = self.table_mask(cand)
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
      table = table.select(self.table_mask(table))
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
      table = table.select(self.table_mask(table))
      if len(table):
        yield table
