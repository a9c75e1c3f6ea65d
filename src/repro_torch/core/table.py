"""ConfigTable: struct-of-arrays design points, and JointTable, the lazy
architecture x HW cross product of co-exploration (host numpy copies of
``repro.core.table``).

PE types are stored as small integer codes into a per-table name
vocabulary (``pe_type_names``); per-PE constants expand to per-row
arrays via :meth:`ConfigTable.pe_const` lookups.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Mapping, Sequence, Tuple

import numpy as np

from repro_torch.core import pe as pe_lib
from repro_torch.core.dataflow import AcceleratorConfig

# column order mirrors AcceleratorConfig's field order (minus pe_type)
INT_COLUMNS = ("pe_rows", "pe_cols", "sp_if", "sp_fw", "sp_ps", "gbuf_kb")
FLOAT_COLUMNS = ("bandwidth_gbps",)
COLUMNS = INT_COLUMNS + FLOAT_COLUMNS


@dataclasses.dataclass(eq=False)
class ConfigTable:
  """N design points as parallel columns (one row == one AcceleratorConfig).

  ``pe_code[i]`` indexes ``pe_type_names``; integer knobs are int64 columns
  and ``bandwidth_gbps`` is float64.
  """
  pe_code: np.ndarray
  pe_type_names: Tuple[str, ...]
  pe_rows: np.ndarray
  pe_cols: np.ndarray
  sp_if: np.ndarray
  sp_fw: np.ndarray
  sp_ps: np.ndarray
  gbuf_kb: np.ndarray
  bandwidth_gbps: np.ndarray

  # per-row PEType constants the batch oracle/dataflow formulas consume
  PE_CONST_FIELDS = ("act_bits", "weight_bits", "psum_bits", "arith_gates",
                     "mac_energy_pj", "critical_path_ns")

  def __post_init__(self):
    self.pe_code = np.asarray(self.pe_code, np.int64)
    for name in INT_COLUMNS:
      setattr(self, name, np.asarray(getattr(self, name), np.int64))
    self.bandwidth_gbps = np.asarray(self.bandwidth_gbps, np.float64)
    self.pe_type_names = tuple(self.pe_type_names)
    for name in self.pe_type_names:
      pe_lib.pe_type(name)  # validate the vocabulary eagerly
    n = self.pe_code.shape[0]
    for name in COLUMNS:
      col = getattr(self, name)
      if col.shape != (n,):
        raise ValueError(f"column {name!r} has shape {col.shape}, "
                         f"expected ({n},)")
    if n and (self.pe_code.min() < 0
              or self.pe_code.max() >= len(self.pe_type_names)):
      raise ValueError("pe_code out of range for pe_type_names")

  def __len__(self) -> int:
    return int(self.pe_code.shape[0])

  @property
  def n_pe(self) -> np.ndarray:
    return self.pe_rows * self.pe_cols

  def pe_type_strings(self) -> np.ndarray:
    """Per-row PE type names (the ResultFrame ``pe_type`` column)."""
    return np.asarray(self.pe_type_names)[self.pe_code]

  def pe_const(self, field: str) -> np.ndarray:
    """Per-row PEType constant expanded from the type vocabulary."""
    vocab = np.asarray(
        [float(getattr(pe_lib.pe_type(t), field)) for t in self.pe_type_names],
        np.float64)
    return vocab[self.pe_code]

  def numeric_columns(self) -> Dict[str, np.ndarray]:
    """All-float64 column dict (knobs + ``n_pe`` + per-row PE constants)."""
    cols = {name: getattr(self, name).astype(np.float64) for name in COLUMNS}
    cols["n_pe"] = self.n_pe.astype(np.float64)
    for field in self.PE_CONST_FIELDS:
      cols[field] = self.pe_const(field)
    return cols

  def hw_features(self) -> np.ndarray:
    """(N, 4) power/area feature matrix: SP_if, SP_ps, SP_fw, #PE."""
    return np.stack([
        self.sp_if.astype(np.float64), self.sp_ps.astype(np.float64),
        self.sp_fw.astype(np.float64), self.n_pe.astype(np.float64)], axis=1)

  def latency_hw_features(self) -> np.ndarray:
    """(N, 6) latency hardware features: SP_if, SP_ps, SP_fw, rows, cols,
    GBS."""
    return np.stack([
        self.sp_if.astype(np.float64), self.sp_ps.astype(np.float64),
        self.sp_fw.astype(np.float64), self.pe_rows.astype(np.float64),
        self.pe_cols.astype(np.float64), self.gbuf_kb.astype(np.float64)],
        axis=1)

  @classmethod
  def from_columns(cls, pe_type: Sequence[str],
                   columns: Mapping[str, np.ndarray]) -> "ConfigTable":
    """Build from a per-row PE-type name sequence + named value columns."""
    missing = set(COLUMNS) - set(columns)
    if missing:
      raise ValueError(f"missing columns {sorted(missing)}")
    names = np.asarray(pe_type)
    vocab, codes = np.unique(names, return_inverse=True)
    return cls(pe_code=codes, pe_type_names=tuple(str(t) for t in vocab),
               **{name: np.asarray(columns[name]) for name in COLUMNS})

  @classmethod
  def from_configs(cls, cfgs: Sequence[AcceleratorConfig]) -> "ConfigTable":
    cfgs = list(cfgs)
    return cls.from_columns(
        [c.pe_type for c in cfgs],
        {name: np.asarray([getattr(c, name) for c in cfgs])
         for name in COLUMNS})

  @classmethod
  def full(cls, pe_type: str, n: int, columns: Mapping[str, np.ndarray]
           ) -> "ConfigTable":
    """Single-PE-type table (the per-type sampling case)."""
    return cls(pe_code=np.zeros(n, np.int64), pe_type_names=(pe_type,),
               **{name: np.asarray(columns[name]) for name in COLUMNS})

  def config_at(self, i: int) -> AcceleratorConfig:
    """Materialize one row as a dataclass."""
    return AcceleratorConfig(
        pe_type=self.pe_type_names[int(self.pe_code[i])],
        **{name: int(getattr(self, name)[i]) for name in INT_COLUMNS},
        bandwidth_gbps=float(self.bandwidth_gbps[i]))

  def to_configs(self) -> List[AcceleratorConfig]:
    return [self.config_at(i) for i in range(len(self))]

  def __iter__(self) -> Iterator[AcceleratorConfig]:
    return (self.config_at(i) for i in range(len(self)))

  def select(self, index) -> "ConfigTable":
    """Sub-table by boolean mask, slice, or integer index array."""
    idx = index if isinstance(index, slice) else np.asarray(index)
    return ConfigTable(
        pe_code=self.pe_code[idx], pe_type_names=self.pe_type_names,
        **{name: getattr(self, name)[idx] for name in COLUMNS})

  def chunks(self, chunk_size: int) -> Iterator["ConfigTable"]:
    """Bounded-memory iteration: successive row slices of <= chunk_size."""
    if chunk_size <= 0:
      raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    for lo in range(0, len(self), chunk_size):
      yield self.select(slice(lo, lo + chunk_size))

  @classmethod
  def concat(cls, tables: Sequence["ConfigTable"]) -> "ConfigTable":
    tables = list(tables)
    if not tables:
      raise ValueError("cannot concat zero tables")
    vocab = sorted({t for tbl in tables for t in tbl.pe_type_names})
    code_of = {t: i for i, t in enumerate(vocab)}
    codes = np.concatenate([
        np.asarray([code_of[t] for t in tbl.pe_type_names],
                   np.int64)[tbl.pe_code]
        for tbl in tables])
    return cls(pe_code=codes, pe_type_names=tuple(vocab),
               **{name: np.concatenate([getattr(t, name) for t in tables])
                  for name in COLUMNS})

  def groups_by_type(self) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (pe_type_name, row-index array) for each type present."""
    for code, name in enumerate(self.pe_type_names):
      idx = np.flatnonzero(self.pe_code == code)
      if idx.size:
        yield name, idx

  def cross(self, n_archs: int) -> "JointTable":
    """Cross product with ``n_archs`` integer-coded architectures."""
    return JointTable(hw=self, n_archs=n_archs)

  def row_keys(self) -> List[bytes]:
    """Per-row identity keys: equal keys iff equal design points (PE type
    name + every knob value), independent of each table's ``pe_code``
    vocabulary.  O(n) Python-level keys, for population-scale dedup
    checks (the guided search's evaluated points), not million-row
    sweeps."""
    vals = np.ascontiguousarray(np.stack(
        [getattr(self, name).astype(np.float64) for name in COLUMNS],
        axis=1))
    names = self.pe_type_strings()
    return [str(names[i]).encode() + b"|" + vals[i].tobytes()
            for i in range(len(self))]

  def __repr__(self) -> str:
    return (f"ConfigTable({len(self)} rows, "
            f"pe_types={list(self.pe_type_names)})")


# ---------------------------------------------------------------------------
# joint HW x NN cross product
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class JointTable:
  """The cross product of ``n_archs`` architectures x a HW ConfigTable.

  Joint rows are ordered arch-major — row ``i`` pairs architecture
  ``i // len(hw)`` with HW design point ``i % len(hw)`` — matching the
  scalar ``co_explore`` loop order (per PE type: for arch, for hw).  The
  HW columns are stored once; ``arch_ids()`` / ``hw_indices()`` are pure
  index arithmetic and :meth:`materialize` tiles the columns only when a
  caller genuinely needs a flat ``n_archs * n_hw``-row ConfigTable.
  Architectures live outside the table as integer codes (the
  ResultFrame's ``arch_lookup`` maps them back to objects).
  """
  hw: ConfigTable
  n_archs: int

  def __post_init__(self):
    self.n_archs = int(self.n_archs)
    if self.n_archs < 0:
      raise ValueError(f"n_archs must be >= 0, got {self.n_archs}")

  def __len__(self) -> int:
    return self.n_archs * len(self.hw)

  @property
  def n_hw(self) -> int:
    return len(self.hw)

  @property
  def pe_type_names(self) -> Tuple[str, ...]:
    return self.hw.pe_type_names

  def arch_ids(self) -> np.ndarray:
    """Per-joint-row architecture code (arch-major repeat)."""
    return np.repeat(np.arange(self.n_archs, dtype=np.int64), self.n_hw)

  def hw_indices(self) -> np.ndarray:
    """Per-joint-row index into the underlying HW table."""
    return np.tile(np.arange(self.n_hw, dtype=np.int64), self.n_archs)

  def pe_type_strings(self) -> np.ndarray:
    return np.tile(self.hw.pe_type_strings(), self.n_archs)

  def pair_at(self, i: int) -> Tuple[int, AcceleratorConfig]:
    """(arch_id, hw config) of joint row ``i``."""
    i = int(i)
    if not 0 <= i < len(self):
      raise IndexError(f"joint row {i} out of range for {len(self)} rows")
    return i // self.n_hw, self.hw.config_at(i % self.n_hw)

  def config_at(self, i: int) -> AcceleratorConfig:
    """HW half of joint row ``i`` (ResultFrame design-point protocol)."""
    return self.pair_at(i)[1]

  def select(self, index) -> ConfigTable:
    """HW columns of the selected joint rows as a flat ConfigTable (used
    by ResultFrame.select; arch codes ride along in the frame's
    ``arch_id`` column, so only the HW half is gathered here)."""
    if isinstance(index, slice):
      index = np.arange(len(self))[index]
    idx = np.asarray(index)
    if idx.dtype == np.bool_:
      idx = np.flatnonzero(idx)
    return self.hw.select(idx % max(self.n_hw, 1))

  def block_slices(self, chunk_size: int
                   ) -> Iterator[Tuple[slice, slice]]:
    """Tile the arch x HW cross product into (arch_slice, hw_slice)
    blocks of <= chunk_size joint rows — the streaming engine's unit of
    work.  HW chunks span as many rows as fit; the arch axis splits into
    blocks of ``chunk_size // hw_chunk`` so a 100M-pair sweep is visited
    as a few hundred bounded blocks, never materialized."""
    if chunk_size <= 0:
      raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    n_hw = self.n_hw
    if not n_hw or not self.n_archs:
      return
    hw_chunk = min(n_hw, chunk_size)
    arch_block = max(1, chunk_size // hw_chunk)
    for a_lo in range(0, self.n_archs, arch_block):
      a_sl = slice(a_lo, min(a_lo + arch_block, self.n_archs))
      for h_lo in range(0, n_hw, hw_chunk):
        yield a_sl, slice(h_lo, min(h_lo + hw_chunk, n_hw))

  def block_indices(self, arch_slice: slice, hw_slice: slice) -> np.ndarray:
    """Joint row ids of one block, flattened arch-major — i.e. in the
    exact row order ``co_evaluate_table`` emits for the block's
    sub-table/sub-stack."""
    a = np.arange(arch_slice.start, arch_slice.stop, dtype=np.int64)
    h = np.arange(hw_slice.start, hw_slice.stop, dtype=np.int64)
    return (a[:, None] * self.n_hw + h[None, :]).reshape(-1)

  def materialize(self) -> ConfigTable:
    """Flat ``n_archs * n_hw``-row ConfigTable (numpy tiling, no Python
    per-pair objects) — the escape hatch for consumers of plain tables."""
    return self.hw.select(self.hw_indices())

  def to_configs(self) -> List[AcceleratorConfig]:
    """Per-joint-row HW configs (the all-Python escape hatch; completes
    the ConfigTable protocol ResultFrame.to_points relies on)."""
    return self.hw.to_configs() * self.n_archs

  def __repr__(self) -> str:
    return (f"JointTable({self.n_archs} archs x {self.n_hw} hw rows = "
            f"{len(self)} pairs, pe_types={list(self.hw.pe_type_names)})")
