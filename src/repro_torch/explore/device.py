"""The fused per-chunk sweep programs, in torch.

The port of ``repro.explore.device``: one chunk's evaluate ->
derive-columns -> reduce pipeline runs on the device, and only
O(survivors) rows come back to the host.  A plain sweep's chunk is one
group of design points; a co-exploration block is one group per
architecture, (A, H) grids of architectures x HW rows:

  pareto    an exact-superset non-dominated prefilter (the minimum for
            one varying objective, the 2-D staircase elimination per
            group for two, the K1 block dominance kernel over the
            flattened chunk for three or more; in a joint block the
            arch-constant ``top1``/``top1_err`` objectives tie within a
            group and are projected out first), survivors compacted into
            a fixed-size index list without a host sync, then gathered
  top-k     a stable sort on the key column (ties resolve to the lowest
            index == the lowest global row id, like
            ``stable_topk_indices``)
  stats     one (count, mean, M2, min, max) Welford partial per chunk
  histogram fixed-edge bin counts (identical binning to ``np.histogram``)

The host accumulators stay the cross-chunk merge, so fronts and top-k
are bit-identical to the host stream.  Every program also keeps the full
metric arrays on the device; only when a pareto survivor count overflows
``DevicePlan.cap`` does the host fetch them and fold the full chunk.

Exactness on a device is checked once, by :func:`ensure_exact`, before a
backend uses it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import oracle
from repro_torch.core.dataflow import ConvLayer
from repro_torch.core.exact import div, floor_div
from repro_torch.core.table import ConfigTable
from repro_torch.explore.frame import BASE_COLUMNS, DERIVED_COLUMNS, ResultFrame

# columns the fused programs can materialize (frame.column equivalents);
# top1/top1_err additionally need the joint path's per-arch accuracies
DEVICE_COLUMNS = BASE_COLUMNS + DERIVED_COLUMNS
JOINT_COLUMNS = DEVICE_COLUMNS + ("top1", "top1_err")

# columns constant along the HW axis of a joint block (functions of the
# architecture only): the grouped prefilter may project them out
ARCH_CONSTANT_COLUMNS = frozenset({"top1", "top1_err"})

# default survivor capacity per pareto reducer per chunk; counts above it
# fall back to the full chunk for that chunk
DEFAULT_SURVIVOR_CAP = 4096

# staircase elimination rounds: each round removes everything dominated
# by one more front point; the mask is a front superset after any number
STAIRCASE_ROUNDS = 32

# block size for the (>=3 variable objectives) dominance prefilter (K1)
PREFILTER_BLOCK = 128


# ---------------------------------------------------------------------------
# host <-> device movement
# ---------------------------------------------------------------------------

def h2d(array: np.ndarray, device: torch.device) -> torch.Tensor:
  """A host array on ``device``: zero-copy on the CPU, an asynchronous
  copy from pinned memory on CUDA (a pageable copy would make the host
  wait for the whole stream)."""
  # repro: ignore[JIT003] host staging; programs pass only constant edges
  t = torch.from_numpy(np.ascontiguousarray(array))
  if device.type == "cpu":
    return t
  return t.pin_memory().to(device, non_blocking=True)


def to_host(tensors: Sequence[torch.Tensor]
            ) -> Tuple[List[torch.Tensor], Optional["torch.cuda.Event"]]:
  """Start copying device tensors into pinned host memory; returns the
  host tensors and the event that marks the copies done (None when the
  tensors already live on the CPU)."""
  if not tensors or tensors[0].device.type == "cpu":
    return list(tensors), None
  device = tensors[0].device
  host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
          for t in tensors]
  for h, t in zip(host, tensors):
    h.copy_(t, non_blocking=True)
  event = torch.cuda.Event()
  event.record(torch.cuda.current_stream(device))
  return host, event


# ---------------------------------------------------------------------------
# the exactness probe
# ---------------------------------------------------------------------------

_PROBED: Dict[str, Dict[str, Dict]] = {}


def probe_exactness(device) -> Dict[str, Dict]:
  """Run sentinels of every known exactness hazard on ``device``.

  ``checks`` holds the forms the port relies on, each compared bit for
  bit with numpy (or, for the oracle as a whole, with the same formulas
  on the CPU, which the tests hold to the numpy reference):
    F1/F3  division through ``exact.div`` / ``exact.floor_div``
    F4     separate multiply and add, multiply chains
    F2/F6  the oracle with its host-precomputed sqrt / decoder columns
    F5     the stable top-k on tied keys
    F7     the fixed-size survivor compaction
  ``raw_mismatches`` counts, for information, how often the forms the
  port avoids differ from numpy on this device.
  """
  device = torch.device(device)
  rng = np.random.RandomState(1234)
  x = rng.uniform(0.5, 1e6, 4096)
  y = x[::-1].copy()
  xi = np.floor(x)
  words = np.concatenate([2.0 ** np.arange(1, 40), np.arange(1.0, 4097.0)])
  tx, ty, txi, tw = (torch.from_numpy(a).to(device)
                     for a in (x, y, xi, words))

  def same(got: torch.Tensor, want: np.ndarray) -> bool:
    return bool(np.array_equal(got.cpu().numpy(), want))

  def mismatches(got: torch.Tensor, want: np.ndarray) -> int:
    # repro: ignore[EXA003] a host count of mismatching elements, not a result
    return int((got.cpu().numpy() != want).sum())

  checks = {
      "F1 div(float, tensor)": same(div(1000.0, tx), 1000.0 / x),
      "F3 div(tensor, float)": same(div(tx, 3.0), x / 3.0),
      "F3 floor_div(tensor, float)": same(floor_div(txi, 7.0),
                                          np.floor_divide(xi, 7.0)),
      "F4 a*b + c*d": same(0.028 * tx + 0.006 * ty, 0.028 * x + 0.006 * y),
      "F4 a*b*c": same(tx * 0.3 * 0.7, x * 0.3 * 0.7),
  }
  # F2/F6 (and every formula): the oracle on this device vs the CPU
  space_rng = np.random.RandomState(7)
  table = ConfigTable(
      pe_code=np.arange(64) % 6,
      pe_type_names=("FP32", "INT16", "INT8", "INT4", "LightPE-1",
                     "LightPE-2"),
      **{name: space_rng.choice(vals, 64) for name, vals in (
          ("pe_rows", (8, 12, 16, 32)), ("pe_cols", (8, 14, 16, 32)),
          ("sp_if", (6, 12, 64)), ("sp_fw", (64, 224, 448)),
          ("sp_ps", (8, 24, 64)), ("gbuf_kb", (64, 128, 512)),
          ("bandwidth_gbps", (6.4, 12.8, 25.6)))})
  layers = (ConvLayer("a", A=32, C=3, F=16, K=3, S=1, P=1),
            ConvLayer("b", A=16, C=64, F=128, K=1, S=2, P=0),
            ConvLayer("c", A=56, C=256, F=512, K=7, S=2, P=3))
  inputs = oracle.batch_inputs(table)
  want = oracle.characterize_batch(
      {k: torch.from_numpy(v) for k, v in inputs.items()}, layers)
  got = oracle.characterize_batch(
      {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}, layers)
  checks["F2/F6 oracle vs CPU"] = all(
      same(getattr(got, f), getattr(want, f).numpy())
      for f in ("clock_mhz", "area_mm2", "power_mw", "latency_s",
                "energy_mj", "utilization"))
  tied = np.repeat(rng.randint(0, 7, 512).astype(np.float64), 3)
  checks["F5 stable top-k"] = same(
      _stable_topk_indices(torch.from_numpy(tied).to(device), 100, False),
      np.argsort(tied, kind="stable")[:100])
  mask = rng.uniform(size=5000) < 0.3
  idx, count = _compact(torch.from_numpy(mask).to(device), 1024)
  want_idx = np.flatnonzero(mask)
  checks["F7 sized compaction"] = (
      int(count) == want_idx.size
      and same(idx[:min(want_idx.size, 1024)], want_idx[:1024]))

  raw = {
      "F1 float / tensor": mismatches(1000.0 / tx, 1000.0 / x),
      "F3 tensor / float": mismatches(tx / 3.0, x / 3.0),
      # repro: ignore[EXA005] the raw F3 form the probe counts
      "F3 tensor // float": mismatches(torch.div(txi, 7.0,
                                                 rounding_mode="floor"),
                                       np.floor_divide(xi, 7.0)),
      # repro: ignore[EXA002] the raw F2 form the probe counts
      "F2 sqrt": mismatches(torch.sqrt(tx), np.sqrt(x)),
      # repro: ignore[EXA002] the raw F6 form the probe counts
      "F6 ceil(log2(words))": mismatches(torch.ceil(torch.log2(tw)),
                                         np.ceil(np.log2(words))),
      "F5 topk on ties": mismatches(
          # repro: ignore[EXA007] the raw F5 form the probe counts
          torch.topk(-torch.from_numpy(tied).to(device), 100).indices,
          np.argsort(tied, kind="stable")[:100]),
  }
  return {"checks": checks, "raw_mismatches": raw}


def ensure_exact(device) -> Dict[str, Dict]:
  """:func:`probe_exactness` once per device; raises when a form the
  port relies on is not bit-exact there."""
  key = str(torch.device(device))
  if key not in _PROBED:
    report = probe_exactness(device)
    failed = [name for name, ok in report["checks"].items() if not ok]
    if failed:
      raise RuntimeError(f"exact float64 arithmetic does not hold on {key}: "
                         f"{failed} differ from numpy")
    _PROBED[key] = report
  return _PROBED[key]


# ---------------------------------------------------------------------------
# plans: what the reducers need from the device
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParetoSpec:
  cols: Tuple[str, ...]
  maximize: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class TopKSpec:
  col: str
  k: int
  maximize: bool


@dataclasses.dataclass(frozen=True)
class StatsSpec:
  col: str


@dataclasses.dataclass(frozen=True)
class HistSpec:
  col: str
  lo: float
  hi: float
  bins: int


@dataclasses.dataclass(frozen=True)
class DevicePlan:
  """Per-reducer device requests."""
  specs: Tuple[Tuple[str, object], ...]  # (reducer name, spec)
  cap: int = DEFAULT_SURVIVOR_CAP

  def __iter__(self):
    return iter(self.specs)


def build_plan(reducers: Dict[str, object], joint: bool,
               cap: int = DEFAULT_SURVIVOR_CAP) -> Optional[DevicePlan]:
  """A DevicePlan covering every reducer, or None when any reducer (or
  any referenced column) is not device-fusable; ``joint`` plans may also
  read ``top1``/``top1_err``."""
  allowed = set(JOINT_COLUMNS if joint else DEVICE_COLUMNS)
  specs = []
  for name, r in reducers.items():
    spec = getattr(r, "device_spec", lambda: None)()
    if spec is None:
      return None
    cols = spec.cols if isinstance(spec, ParetoSpec) else (spec.col,)
    if not set(cols) <= allowed:
      return None
    specs.append((name, spec))
  return DevicePlan(specs=tuple(specs), cap=int(cap))


# ---------------------------------------------------------------------------
# device-side column + prefilter machinery
# ---------------------------------------------------------------------------

def _derive_columns(lat, pwr, area, accs: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
  """The frame.column formulas, op for op (survivor values stay
  bit-identical to the host frame's derived columns).  All grids are
  (G, M): one group per arch for joint blocks (``accs`` holds the
  groups' accuracies), a single group otherwise."""
  cols = {"latency_s": lat, "power_mw": pwr, "area_mm2": area}
  perf = div(1.0, torch.clamp(lat, min=1e-12))
  cols["perf"] = perf
  cols["perf_per_area"] = div(perf, torch.clamp(area, min=1e-12))
  cols["energy_mj"] = pwr * lat
  if accs is not None:
    top1 = accs[:, None].expand(lat.shape)
    cols["top1"] = top1
    cols["top1_err"] = 1.0 - top1
  return cols


def _staircase_mask(x: torch.Tensor, y: torch.Tensor,
                    rounds: int = STAIRCASE_ROUNDS) -> torch.Tensor:
  """(G, M) bool superset of each group's 2-D front (minimize x then y).

  Champion elimination: every round picks the lowest-x not-yet-processed
  survivor per group and removes everything it dominates.  Only truly
  dominated points are removed, so the mask is a front superset after
  any number of rounds; more rounds make it tighter.
  """
  alive = torch.ones(x.shape, dtype=torch.bool, device=x.device)
  processed = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
  for _ in range(rounds):
    key = torch.where(alive & ~processed, x, float("inf"))
    i = torch.argmin(key, dim=1, keepdim=True)  # first index on ties
    cx = torch.gather(x, 1, i)
    cy = torch.gather(y, 1, i)
    dom = (cx <= x) & (cy <= y) & ((cx < x) | (cy < y))
    alive = alive & ~dom
    processed.scatter_(1, i, True)
  return alive


def _pareto_prefilter(cols, spec: ParetoSpec, grouped: bool) -> torch.Tensor:
  """(G, M) bool exact-superset mask of the chunk front for ``spec``.

  Grouped (joint) blocks project out arch-constant objectives: rows of
  one group tie on them, so dominance within a group on the remaining
  axes is full dominance.  The K1 block filter compares across groups
  too, so it keeps every axis of the spec.
  """
  from repro_torch.kernels.pareto_front import ops as pf_ops
  mx = set(spec.maximize)
  objs = {c: (-cols[c] if c in mx else cols[c]) for c in spec.cols}
  var = [objs[c] for c in spec.cols
         if not (grouped and c in ARCH_CONSTANT_COLUMNS)]
  if not var:  # all objectives tie within every group
    return torch.ones(next(iter(objs.values())).shape, dtype=torch.bool,
                      device=cols["latency_s"].device)
  if len(var) == 1:
    v = var[0]
    return v == v.min(dim=1, keepdim=True).values
  if len(var) == 2:
    return _staircase_mask(var[0], var[1])
  obj = torch.stack([o.reshape(-1) for o in objs.values()], dim=1)
  return pf_ops.block_prefilter_mask(obj, block=PREFILTER_BLOCK).reshape(
      var[0].shape)


def _compact(mask: torch.Tensor, cap: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(indices of the first ``cap`` True entries, padded with len(mask);
  number of True entries).  A fixed-size scatter: unlike
  ``torch.nonzero`` it never waits for the device, so chunks keep
  dispatching ahead."""
  n = mask.numel()
  pos = torch.cumsum(mask, 0) - 1
  slot = torch.where(mask & (pos < cap), pos, cap)  # slot cap: discarded
  idx = torch.full((cap + 1,), n, dtype=torch.int64, device=mask.device)
  idx.scatter_(0, slot, torch.arange(n, device=mask.device))
  # repro: ignore[EXA003] a bool count is exact in any order
  return idx[:cap], mask.sum()


def _take_fill(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """values[idx] with 0.0 where idx == len(values) (the padding)."""
  n = values.numel()
  return torch.where(idx < n, values[idx.clamp(max=n - 1)], 0.0)


def _stable_topk_indices(key: torch.Tensor, k: int,
                         maximize: bool) -> torch.Tensor:
  """Indices of the k best keys, ties to the lowest index.  ``topk``
  breaks ties in no set order; a stable ascending sort does."""
  order_key = -key if maximize else key
  return torch.sort(order_key, stable=True).indices[:k]


def _histogram_counts(v: torch.Tensor, lo: float, hi: float,
                      bins: int) -> torch.Tensor:
  """np.histogram-identical fixed-edge binning (half-open bins, last
  closed; values pre-clipped into range like HistogramAccumulator).
  Counts by ``scatter_add_``: ``bincount`` reads the input's maximum
  back to the host on CUDA."""
  # repro: ignore[JIT003] the edges are constants of the plan (lo, hi, bins)
  edges = np.linspace(float(lo), float(hi), int(bins) + 1)
  v = torch.clamp(v.reshape(-1), float(edges[0]), float(edges[-1]))
  idx = torch.searchsorted(h2d(edges, v.device), v, right=True) - 1
  idx = torch.clamp(idx, 0, bins - 1)
  counts = torch.zeros(bins, dtype=torch.int64, device=v.device)
  return counts.scatter_add_(0, idx, torch.ones_like(idx))


def _reduce_outputs(cols, plan: DevicePlan,
                    grouped: bool) -> Dict[str, Dict[str, object]]:
  """Per-reducer outputs of the fused program: tensors still on the
  device, plus plain ints."""
  n = cols["latency_s"].numel()
  base = {c: cols[c].reshape(-1) for c in BASE_COLUMNS}
  out: Dict[str, Dict[str, object]] = {}
  for name, spec in plan:
    if isinstance(spec, ParetoSpec):
      mask = _pareto_prefilter(cols, spec, grouped).reshape(-1)
      idx, count = _compact(mask, plan.cap)
      out[name] = {"count": count, "idx": idx,
                   **{c: _take_fill(b, idx) for c, b in base.items()}}
    elif isinstance(spec, TopKSpec):
      idx = _stable_topk_indices(cols[spec.col].reshape(-1), min(spec.k, n),
                                 spec.maximize)
      out[name] = {"idx": idx, **{c: b[idx] for c, b in base.items()}}
    elif isinstance(spec, StatsSpec):
      v = cols[spec.col].reshape(-1)
      # Welford partials are outside the bit-identity contract (stats
      # are merge-order-dependent on the host path too)
      mean = v.mean()  # repro: ignore[EXA003] Welford partial (R3)
      # a single-row chunk has zero spread by definition; (v - mean)**2
      # would turn a non-finite value into a NaN M2 partial
      m2 = torch.zeros((), dtype=v.dtype, device=v.device) if n == 1 \
          else ((v - mean) ** 2).sum()  # repro: ignore[EXA003] R3, as above
      out[name] = {"n": n, "mean": mean, "m2": m2,
                   "min": v.min(), "max": v.max()}
    elif isinstance(spec, HistSpec):
      out[name] = {"counts": _histogram_counts(cols[spec.col], spec.lo,
                                               spec.hi, spec.bins)}
    else:  # pragma: no cover - build_plan only emits the specs above
      raise TypeError(f"unknown device spec {spec!r}")
  return out


def make_eval_fn(layers: Tuple[ConvLayer, ...],
                 plan: Optional[DevicePlan]) -> Callable:
  """Plain-sweep program: inputs bundle (tensors on one device) ->
  (lat, pwr, area)[, reductions]."""

  def run(inputs):
    ch = oracle.characterize_batch(inputs, layers)
    full = (ch.latency_s, ch.power_mw, ch.area_mm2)
    if plan is None:
      return full
    cols = _derive_columns(ch.latency_s[None, :], ch.power_mw[None, :],
                           ch.area_mm2[None, :])
    return full, _reduce_outputs(cols, plan, grouped=False)

  return run


def make_joint_fn(plan: Optional[DevicePlan]) -> Callable:
  """Joint-sweep program over the distinct-layer factorization:
  (inputs, unique_cols, slot_ids, valid, accs) ->
  (lat (A, H), pwr (H,), area (H,))[, reductions], every argument a
  tensor on one device (``accs``, the block's (A,) accuracies, is read
  by fused plans only)."""

  def run(inputs, unique_cols, slot_ids, valid, accs):
    ch = oracle.characterize_joint_dedup(inputs, unique_cols, slot_ids,
                                         valid)
    full = (ch.latency_s, ch.power_mw, ch.area_mm2)
    if plan is None:
      return full
    lat = ch.latency_s
    cols = _derive_columns(lat, ch.power_mw[None, :].expand(lat.shape),
                           ch.area_mm2[None, :].expand(lat.shape), accs=accs)
    return full, _reduce_outputs(cols, plan, grouped=True)

  return run


def joint_chunk_frame(lat: np.ndarray, pwr: np.ndarray, area: np.ndarray,
                      hw: ConfigTable, network: str, arch_lo: int,
                      accs: np.ndarray,
                      arch_lookup: Tuple[object, ...]) -> ResultFrame:
  """The full joint chunk frame (``co_evaluate_table``'s, with the
  ``arch_id``/``top1`` columns a streamed block carries), built from the
  (A, H) / (H,) metric arrays: shared by the non-fused pending path and
  the fused overflow fallback."""
  n_archs = lat.shape[0]
  joint = hw.cross(n_archs)
  ids = joint.arch_ids()
  return ResultFrame(
      lat.reshape(-1), np.tile(pwr, n_archs), np.tile(area, n_archs),
      joint.pe_type_strings(), (), network, table=joint,
      extra={"arch_id": ids + arch_lo,
             "top1": np.asarray(accs, np.float64)[ids]},
      arch_lookup=arch_lookup)


# ---------------------------------------------------------------------------
# pending chunks: dispatched device work, resolved later on the host
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FusedChunk:
  """Resolved fused-chunk result: one payload per reducer plus row
  counts — ``n_transferred`` is how many evaluated rows crossed the
  device boundary; ``n_overflows`` counts pareto reducers whose survivor
  count blew the plan cap and fell back to the full chunk frame."""
  payloads: Dict[str, tuple]
  n_rows: int
  n_transferred: int = 0
  n_overflows: int = 0


class _PendingBase:
  """A dispatched device chunk.  Construction enqueues the work and the
  copies of its results to the host; ``resolve()`` waits for them.
  ``device`` and ``stream`` name where the work was enqueued, so a
  helper thread (the resilience watchdog) resolves it there."""

  _event: Optional["torch.cuda.Event"] = None
  device: Optional[torch.device] = None
  stream: Optional["torch.cuda.Stream"] = None

  def _start_copy(self, tensors: Sequence[torch.Tensor]
                  ) -> List[torch.Tensor]:
    host, self._event = to_host(tensors)
    if tensors:
      self.device = tensors[0].device
      if self.device.type == "cuda":
        self.stream = torch.cuda.current_stream(self.device)
    return host

  def resolve(self):
    raise NotImplementedError

  def is_ready(self) -> bool:
    """Non-blocking: True once the chunk's results have reached the
    host (always, for a chunk that ran on the CPU)."""
    return self._event is None or self._event.query()

  def _wait(self) -> None:
    if self._event is not None:
      self._event.synchronize()


class PendingFrame(_PendingBase):
  """Non-fused device chunk: resolves to the ordinary (frame, idx); a
  joint block (``accs`` given) to its joint chunk frame."""

  def __init__(self, full: Tuple[torch.Tensor, ...], table: ConfigTable,
               indices: np.ndarray, network: str, arch_lo: int = 0,
               accs: Optional[np.ndarray] = None,
               arch_lookup: Tuple[object, ...] = ()):
    self._host = self._start_copy(full)
    self.table = table
    self.indices = indices
    self.network = network
    self.arch_lo = int(arch_lo)
    self.accs = accs
    self.arch_lookup = tuple(arch_lookup)

  def resolve(self) -> Tuple[ResultFrame, np.ndarray]:
    self._wait()
    lat, pwr, area = (h.numpy() for h in self._host)
    if self.accs is not None:
      return joint_chunk_frame(lat, pwr, area, self.table, self.network,
                               self.arch_lo, self.accs,
                               self.arch_lookup), self.indices
    return ResultFrame(lat, pwr, area, self.table.pe_type_strings(), (),
                       self.network, table=self.table), self.indices


class PendingFused(_PendingBase):
  """Fused device chunk: resolves to a :class:`FusedChunk`.  A joint
  block (``accs`` given) carries its (A, H) grid's HW width ``n_hw``,
  first architecture ``arch_lo`` and the sweep's ``arch_lookup``, and
  its survivor frames get the ``arch_id``/``top1`` columns."""

  def __init__(self, outputs, plan: DevicePlan, table: ConfigTable,
               indices: np.ndarray, network: str,
               n_hw: Optional[int] = None, arch_lo: int = 0,
               accs: Optional[np.ndarray] = None,
               arch_lookup: Tuple[object, ...] = ()):
    self._full, reduced = outputs
    self.plan = plan
    self.table = table
    self.indices = np.asarray(indices, np.int64)
    self.network = network
    self.n_hw = len(table) if n_hw is None else int(n_hw)
    self.arch_lo = int(arch_lo)
    self.accs = accs
    self.arch_lookup = tuple(arch_lookup)
    self._joint = accs is not None
    slots = [(name, key) for name, out in reduced.items()
             for key, v in out.items() if isinstance(v, torch.Tensor)]
    host = self._start_copy([reduced[name][key] for name, key in slots])
    self._reduced = {name: dict(out) for name, out in reduced.items()}
    for (name, key), h in zip(slots, host):
      self._reduced[name][key] = h

  def _extras(self, local: np.ndarray) -> Dict[str, np.ndarray]:
    if not self._joint:
      return {}
    arch_local = local // self.n_hw
    return {"arch_id": arch_local + self.arch_lo,
            "top1": np.asarray(self.accs, np.float64)[arch_local]}

  def _mini_frame(self, local: np.ndarray, rows) -> ResultFrame:
    lat, pwr, area = (np.asarray(r, np.float64) for r in rows)
    hw_local = local % self.n_hw if self._joint else local
    sub = self.table.select(hw_local)
    return ResultFrame(lat, pwr, area, sub.pe_type_strings(), (),
                       self.network, extra=self._extras(local), table=sub,
                       arch_lookup=self.arch_lookup)

  def full_frame(self) -> Tuple[ResultFrame, np.ndarray]:
    """The chunk's ordinary full frame (device -> host fetch)."""
    lat, pwr, area = (t.cpu().numpy() for t in self._full)
    if self._joint:
      return joint_chunk_frame(lat, pwr, area, self.table, self.network,
                               self.arch_lo, self.accs,
                               self.arch_lookup), self.indices
    return (ResultFrame(lat, pwr, area, self.table.pe_type_strings(), (),
                        self.network, table=self.table), self.indices)

  def resolve(self) -> FusedChunk:
    self._wait()
    payloads: Dict[str, tuple] = {}
    full = None
    transferred = 0
    overflows = 0
    for name, spec in self.plan:
      out = self._reduced[name]
      if isinstance(spec, ParetoSpec):
        count = int(out["count"])
        if count > self.plan.cap:  # rare: fetch the full chunk instead
          overflows += 1
          if full is None:
            full = self.full_frame()
            transferred += len(self.indices)
          payloads[name] = ("rows",) + full
          continue
        local = out["idx"].numpy()[:count]
        transferred += count
        payloads[name] = ("rows", self._mini_frame(local, [
            out[c].numpy()[:count] for c in BASE_COLUMNS]),
            self.indices[local])
      elif isinstance(spec, TopKSpec):
        local = out["idx"].numpy()
        transferred += local.size
        payloads[name] = ("rows", self._mini_frame(local, [
            out[c].numpy() for c in BASE_COLUMNS]), self.indices[local])
      elif isinstance(spec, StatsSpec):
        payloads[name] = ("stats", {k: int(v) if k == "n" else float(v)
                                    for k, v in out.items()})
      else:
        payloads[name] = ("hist", out["counts"].numpy().astype(np.int64))
    return FusedChunk(payloads=payloads, n_rows=len(self.indices),
                      n_transferred=transferred, n_overflows=overflows)
