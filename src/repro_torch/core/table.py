"""ConfigTable: struct-of-arrays design points (host numpy copy of
``repro.core.table.ConfigTable``).

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

  def __repr__(self) -> str:
    return (f"ConfigTable({len(self)} rows, "
            f"pe_types={list(self.pe_type_names)})")
