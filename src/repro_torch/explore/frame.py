"""Columnar exploration results (host numpy copy of
``repro.explore.frame``).

A :class:`ResultFrame` holds latency / power / area / pe_type as parallel
numpy arrays, plus extra columns such as co-exploration's ``top1`` and
``arch_id``; ``pareto_mask`` and ``stable_topk_indices`` are the exact
host selections the streaming reducers merge chunks with, and
``normalize(ref="best-int16")`` the paper's normalization of every
figure to the best INT16 design.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.dataflow import AcceleratorConfig
from repro_torch.core.table import ConfigTable, JointTable

BASE_COLUMNS = ("latency_s", "power_mw", "area_mm2")

# numeric columns derivable from the base metrics alone (plus, on joint
# frames, the top1/top1_err pair derived from the arch accuracies) — the
# contract the fused device program mirrors op for op (see
# explore/device.py)
DERIVED_COLUMNS = ("perf", "perf_per_area", "energy_mj")

# derived columns where "bigger is better" (auto-negated inside pareto())
_MAXIMIZE_COLUMNS = frozenset({"perf", "perf_per_area", "top1"})

# normalization-anchor aliases: metric name -> (column, maximize)
_REF_ALIASES = {
    "perf_per_area": ("perf_per_area", True),
    "perf": ("perf", True),
    "energy": ("energy_mj", False),
    "energy_mj": ("energy_mj", False),
    "area": ("area_mm2", False),
    "area_mm2": ("area_mm2", False),
    "latency": ("latency_s", False),
    "latency_s": ("latency_s", False),
}


@dataclasses.dataclass
class DesignPoint:
  """One evaluated (hardware config, network) pair (row view of a frame)."""
  cfg: AcceleratorConfig
  network: str
  latency_s: float
  power_mw: float
  area_mm2: float

  @property
  def perf(self) -> float:
    return 1.0 / max(self.latency_s, 1e-12)

  @property
  def perf_per_area(self) -> float:
    return self.perf / max(self.area_mm2, 1e-12)

  @property
  def energy_mj(self) -> float:
    return self.power_mw * self.latency_s  # mW * s = mJ


# ---------------------------------------------------------------------------
# Pareto machinery (vectorized)
# ---------------------------------------------------------------------------

def _pareto_mask_2d(obj: np.ndarray) -> np.ndarray:
  """Exact 2-D front via one lexsort + prefix minima, O(n log n)."""
  n = obj.shape[0]
  order = np.lexsort((obj[:, 1], obj[:, 0]))  # by x asc, then y asc
  xs, ys = obj[order, 0], obj[order, 1]
  new_x = np.empty(n, np.bool_)
  new_x[0] = True
  new_x[1:] = xs[1:] != xs[:-1]
  group_first = np.flatnonzero(new_x)
  group_id = np.cumsum(new_x) - 1
  # min y over all strictly-smaller-x points (dominates if <= our y) and
  # min y within our own x group (dominates if < our y)
  prefix_min = np.minimum.accumulate(ys)
  before = np.full(group_first.shape, np.inf)
  before[1:] = prefix_min[group_first[1:] - 1]
  keep = (ys < before[group_id]) & (ys == ys[group_first][group_id])
  mask = np.empty(n, np.bool_)
  mask[order] = keep
  return mask


def _pareto_elim_nd(obj: np.ndarray) -> np.ndarray:
  """General-dimension front by elimination in ascending objective-sum
  order (the smallest-sum survivor is provably non-dominated), compacting
  the survivor arrays each step."""
  n = obj.shape[0]
  order = np.argsort(obj.sum(axis=1), kind="stable")
  o = obj[order]
  pos = np.arange(n)
  front = np.zeros(n, np.bool_)
  while pos.size:
    head = pos[0]
    front[order[head]] = True
    rest = pos[1:]
    sub = o[rest]
    x = o[head]
    dominated = np.all(sub >= x, axis=1) & np.any(sub > x, axis=1)
    pos = rest[~dominated]
  return front


# block size for the divide-and-conquer N-D front
_ND_BLOCK = 4096


def _pareto_mask_nd(obj: np.ndarray) -> np.ndarray:
  """Block-decomposed general-dimension front: per-block elimination,
  then recursive elimination over the surviving candidates."""
  n = obj.shape[0]
  if n <= _ND_BLOCK:
    return _pareto_elim_nd(obj)
  cand = np.concatenate([
      lo + np.flatnonzero(_pareto_elim_nd(obj[lo:lo + _ND_BLOCK]))
      for lo in range(0, n, _ND_BLOCK)])
  if cand.size == n:  # degenerate: every block all-front; no progress
    return _pareto_elim_nd(obj)
  mask = np.zeros(n, np.bool_)
  mask[cand[_pareto_mask_nd(obj[cand])]] = True
  return mask


def stable_topk_indices(key: np.ndarray, k: int,
                        tie: Optional[np.ndarray] = None) -> np.ndarray:
  """Indices of the k smallest ``key`` values in stable-sort order
  (ascending key, ties by ascending ``tie`` — default the index itself),
  via argpartition + sort-of-k; exactly ``np.argsort(key,
  kind="stable")[:k]`` with ``tie=None``."""
  key = np.asarray(key)
  n = key.shape[0]
  k = max(int(k), 0)
  if k == 0:
    return np.zeros(0, np.int64)
  tie_of = np.arange(n) if tie is None else np.asarray(tie)
  if k >= n:
    sel = np.arange(n)
    return sel[np.lexsort((tie_of, key))]
  part = np.argpartition(key, k - 1)[:k]
  if np.isnan(key[part]).any():  # NaN partitions unreliably; full sort
    return np.lexsort((tie_of, key))[:k]
  thresh = key[part].max()
  strict = np.flatnonzero(key < thresh)
  ties = np.flatnonzero(key == thresh)
  need = k - strict.size
  # boundary ties resolve exactly like the stable sort: smallest tie wins
  ties = ties[np.argsort(tie_of[ties], kind="stable")[:need]]
  sel = np.concatenate([strict, ties])
  return sel[np.lexsort((tie_of[sel], key[sel]))]


def pareto_mask(objectives: np.ndarray) -> np.ndarray:
  """Boolean mask of non-dominated rows; all objectives are MINIMIZED."""
  obj = np.asarray(objectives, np.float64)
  if obj.ndim != 2:
    raise ValueError(f"objectives must be 2-D, got shape {obj.shape}")
  if obj.shape[0] == 0:
    return np.zeros(0, np.bool_)
  if obj.shape[1] == 1:
    return obj[:, 0] == obj[:, 0].min()
  if obj.shape[1] == 2:
    return _pareto_mask_2d(obj)
  return _pareto_mask_nd(obj)


def summary_stats(values: np.ndarray) -> Dict[str, float]:
  """Fig. 9 violin summary: min / q1 / median / q3 / max / mean (NaN for
  every statistic of an empty input)."""
  v = np.asarray(values, np.float64)
  if v.size == 0:
    return {k: float("nan")
            for k in ("min", "q1", "median", "q3", "max", "mean")}
  return {
      "min": float(v.min()), "q1": float(np.percentile(v, 25)),
      "median": float(np.median(v)), "q3": float(np.percentile(v, 75)),
      "max": float(v.max()), "mean": float(v.mean()),
  }


@dataclasses.dataclass
class Normalized:
  """Metrics normalized against a reference design (paper's best-INT16)."""
  perf_per_area: np.ndarray
  energy: np.ndarray
  ref_index: Optional[int] = None

  def __iter__(self) -> Iterator[np.ndarray]:  # (ppa, energy) unpacking
    return iter((self.perf_per_area, self.energy))


# ---------------------------------------------------------------------------
# the frame
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class ResultFrame:
  """Struct-of-arrays over evaluated design points; design points ride
  along as per-point ``cfgs`` or as a columnar ``table``.

  Co-exploration frames carry architectures as an integer ``arch_id``
  extra column plus the shared ``arch_lookup`` tuple (one entry per
  distinct architecture); :meth:`arch_at` maps a row back to its
  architecture object."""
  latency_s: np.ndarray
  power_mw: np.ndarray
  area_mm2: np.ndarray
  pe_type: np.ndarray
  cfgs: Tuple[AcceleratorConfig, ...] = ()
  network: str = "net"
  extra: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
  meta: Dict[str, float] = dataclasses.field(default_factory=dict)
  table: Optional[Union[ConfigTable, JointTable]] = None
  arch_lookup: Tuple[object, ...] = ()

  def __post_init__(self):
    self.latency_s = np.asarray(self.latency_s, np.float64)
    self.power_mw = np.asarray(self.power_mw, np.float64)
    self.area_mm2 = np.asarray(self.area_mm2, np.float64)
    self.pe_type = np.asarray(self.pe_type)
    self.cfgs = tuple(self.cfgs)
    self.arch_lookup = tuple(self.arch_lookup)
    n = len(self.latency_s)
    for name, arr in (("power_mw", self.power_mw),
                      ("area_mm2", self.area_mm2),
                      ("pe_type", self.pe_type)):
      if len(arr) != n:
        raise ValueError(f"column {name!r} has {len(arr)} rows, expected {n}")
    if self.cfgs and len(self.cfgs) != n:
      raise ValueError(f"{len(self.cfgs)} cfgs for {n} rows")
    if self.table is not None and len(self.table) != n:
      raise ValueError(f"{len(self.table)}-row table for {n} rows")
    if self.arch_lookup:
      ids = self.extra.get("arch_id")
      if ids is None:
        raise ValueError("arch_lookup given without an 'arch_id' column")
      self.extra["arch_id"] = ids = np.asarray(ids, np.int64)
      if ids.size and (ids.min() < 0 or ids.max() >= len(self.arch_lookup)):
        raise ValueError("arch_id out of range for arch_lookup")

  def __len__(self) -> int:
    return int(self.latency_s.shape[0])

  @property
  def perf(self) -> np.ndarray:
    return 1.0 / np.maximum(self.latency_s, 1e-12)

  @property
  def perf_per_area(self) -> np.ndarray:
    return self.perf / np.maximum(self.area_mm2, 1e-12)

  @property
  def energy_mj(self) -> np.ndarray:
    return self.power_mw * self.latency_s  # mW * s = mJ

  def column(self, name: str) -> np.ndarray:
    if name in BASE_COLUMNS or name in DERIVED_COLUMNS:
      return getattr(self, name)
    if name == "pe_type":
      return self.pe_type
    if name == "top1_err":
      return 1.0 - self.extra["top1"]
    if name in self.extra:
      return self.extra[name]
    raise KeyError(f"unknown column {name!r}; have base={BASE_COLUMNS}, "
                   f"derived=(perf, perf_per_area, energy_mj, top1_err), "
                   f"extra={tuple(self.extra)}")

  def by_type(self, pe_type: str) -> np.ndarray:
    return self.pe_type == pe_type

  @classmethod
  def from_points(cls, points: Sequence[DesignPoint],
                  network: Optional[str] = None) -> "ResultFrame":
    pts = list(points)
    return cls(
        latency_s=np.asarray([p.latency_s for p in pts], np.float64),
        power_mw=np.asarray([p.power_mw for p in pts], np.float64),
        area_mm2=np.asarray([p.area_mm2 for p in pts], np.float64),
        pe_type=np.asarray([p.cfg.pe_type for p in pts]),
        cfgs=tuple(p.cfg for p in pts),
        network=network if network is not None
        else (pts[0].network if pts else "net"))

  def to_points(self) -> List[DesignPoint]:
    if not self.cfgs and self.table is not None:
      cfgs = self.table.to_configs()
    else:
      cfgs = self.cfgs
    return [DesignPoint(cfg, self.network, float(l), float(p), float(a))
            for cfg, l, p, a in zip(cfgs, self.latency_s,
                                    self.power_mw, self.area_mm2)]

  def config_at(self, i: int) -> AcceleratorConfig:
    """The i-th design point, from ``cfgs`` or the columnar ``table``."""
    if self.cfgs:
      return self.cfgs[i]
    if self.table is not None:
      return self.table.config_at(i)
    raise ValueError("frame carries neither cfgs nor a ConfigTable")

  def arch_at(self, i: int) -> object:
    """The i-th row's architecture object (``arch_lookup[arch_id[i]]``)."""
    if not self.arch_lookup:
      raise ValueError("frame carries no arch_lookup (not a co-exploration "
                       "frame)")
    return self.arch_lookup[int(self.extra["arch_id"][i])]

  def select(self, index: Union[np.ndarray, Sequence[int]]) -> "ResultFrame":
    """Sub-frame by boolean mask or integer index array."""
    idx = np.asarray(index)
    if idx.dtype == np.bool_:
      idx = np.flatnonzero(idx)
    cfgs = tuple(self.cfgs[i] for i in idx) if self.cfgs else ()
    return ResultFrame(
        self.latency_s[idx], self.power_mw[idx], self.area_mm2[idx],
        self.pe_type[idx], cfgs, self.network,
        {k: v[idx] for k, v in self.extra.items()}, dict(self.meta),
        self.table.select(idx) if self.table is not None else None,
        self.arch_lookup)

  @staticmethod
  def _merge_arch_lookups(frames: Sequence["ResultFrame"]
                          ) -> Tuple[Tuple[object, ...], Optional[np.ndarray]]:
    """Union the frames' arch lookups; returns (merged lookup, remapped
    arch_id column or None when ids can pass through unchanged)."""
    lookups = [f.arch_lookup for f in frames]
    if not any(lookups):
      return (), None
    if any(not lu and len(f) for lu, f in zip(lookups, frames)):
      raise ValueError("cannot concat coded-arch frames with frames that "
                       "have arch_id but no arch_lookup")
    first = next(lu for lu in lookups if lu)
    if all(lu == first or not len(f) for lu, f in zip(lookups, frames)):
      return first, None  # identical lookups: ids are already aligned
    merged: List[object] = []
    index: Dict[object, int] = {}
    parts: List[np.ndarray] = []
    for f in frames:
      remap = np.empty(len(f.arch_lookup), np.int64)
      for j, arch in enumerate(f.arch_lookup):
        if arch not in index:
          index[arch] = len(merged)
          merged.append(arch)
        remap[j] = index[arch]
      parts.append(remap[np.asarray(f.extra["arch_id"], np.int64)]
                   if len(f) else np.zeros(0, np.int64))
    return tuple(merged), np.concatenate(parts)

  @classmethod
  def concat(cls, frames: Sequence["ResultFrame"]) -> "ResultFrame":
    frames = list(frames)
    if not frames:
      raise ValueError("cannot concat zero frames")
    keys = set(frames[0].extra)
    if any(set(f.extra) != keys for f in frames):
      raise ValueError("frames have mismatched extra columns")
    cfgs = sum((f.cfgs for f in frames), ()) \
        if all(f.cfgs or not len(f) for f in frames) else ()
    # JointTables flatten to plain ConfigTables across a concat
    tables = [f.table.materialize() if isinstance(f.table, JointTable)
              else f.table for f in frames]
    table = ConfigTable.concat(tables) \
        if all(t is not None for t in tables) else None
    extra = {k: np.concatenate([f.extra[k] for f in frames]) for k in keys}
    arch_lookup, remapped = cls._merge_arch_lookups(frames)
    if remapped is not None:
      extra["arch_id"] = remapped
    return cls(
        np.concatenate([f.latency_s for f in frames]),
        np.concatenate([f.power_mw for f in frames]),
        np.concatenate([f.area_mm2 for f in frames]),
        np.concatenate([f.pe_type for f in frames]),
        cfgs, frames[0].network, extra, table=table,
        arch_lookup=arch_lookup)

  def pareto(self, cols: Sequence[str] = ("perf_per_area", "energy_mj"),
             maximize: Optional[Sequence[str]] = None) -> np.ndarray:
    """Non-dominated mask over the given columns.  Columns in `maximize`
    (default: perf/perf_per_area/top1) are negated; the rest minimized."""
    mx = _MAXIMIZE_COLUMNS if maximize is None else frozenset(maximize)
    obj = np.stack([-self.column(c) if c in mx else self.column(c)
                    for c in cols], axis=1)
    return pareto_mask(obj)

  def reference_index(self, metric: str = "perf_per_area",
                      pe_type: Optional[str] = "INT16") -> int:
    """Row index of the paper's normalization anchor: the best design under
    `metric` among `pe_type` rows (None = whole frame)."""
    if metric not in _REF_ALIASES:
      raise ValueError(f"unknown reference metric {metric!r}; "
                       f"one of {sorted(_REF_ALIASES)}")
    col, maximize = _REF_ALIASES[metric]
    if pe_type is None:
      rows = np.arange(len(self))
    else:
      rows = np.flatnonzero(self.pe_type == pe_type)
      if rows.size == 0:
        raise ValueError(
            f"design space contains no {pe_type} points to normalize by")
    vals = self.column(col)[rows]
    local = int(np.argmax(vals)) if maximize else int(np.argmin(vals))
    return int(rows[local])

  def normalize(self, ref: Union[str, int, Tuple[float, float]]
                = "best-int16") -> Normalized:
    """(normalized perf/area, normalized energy).

    ref: "best-int16" (paper default: best-perf/area INT16 design), a row
    index, or an explicit (perf_per_area_ref, energy_mj_ref) pair.
    """
    ref_index: Optional[int] = None
    if isinstance(ref, str):
      if ref != "best-int16":
        raise ValueError(f"unknown normalization reference {ref!r}")
      ref_index = self.reference_index("perf_per_area", "INT16")
    elif isinstance(ref, (int, np.integer)):
      ref_index = int(ref)
    if ref_index is not None:
      ppa_ref = float(self.perf_per_area[ref_index])
      en_ref = float(self.energy_mj[ref_index])
    else:
      ppa_ref, en_ref = float(ref[0]), float(ref[1])
    return Normalized(self.perf_per_area / ppa_ref,
                      self.energy_mj / en_ref, ref_index)

  def stats(self, col: str, mask: Optional[np.ndarray] = None
            ) -> Dict[str, float]:
    vals = self.column(col)
    if mask is not None:
      vals = vals[mask]
    return summary_stats(vals)

  def top_k(self, k: int, by: str = "perf_per_area",
            maximize: Optional[bool] = None) -> "ResultFrame":
    """Sub-frame of the k best rows under one column (best-first order)."""
    if maximize is None:
      maximize = by in _MAXIMIZE_COLUMNS
    vals = self.column(by)
    return self.select(stable_topk_indices(-vals if maximize else vals, k))
