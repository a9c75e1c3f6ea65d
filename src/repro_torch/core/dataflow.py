"""Row-stationary (RS) dataflow model: the scalar model per design point
on the host, and its batch twin over design points in torch.

The port of ``repro.core.dataflow``: a ``rows x cols`` PE grid running
row-stationary dataflow (Chen et al., ISCA'16), per-PE scratchpads, a
global buffer and DRAM behind a finite-bandwidth link.

:func:`simulate_layer`, :func:`layer_energy_pj` and
:func:`simulate_network` are host Python, op for op the reference's
scalar model: the polynomial models' training sets come from them.  In
the batch path (``*_batch``) hardware columns arrive as float64 tensors
on one device, layer features as Python floats; its formulas repeat the
reference's elementwise operations one for one, in the same order, so
every output is bit-identical to the reference's numpy batch path.
Divisions there go through :mod:`repro_torch.core.exact` (see there for
why).

The joint path of co-exploration runs the same formulas with layer
features as ``(n_layers, 1)`` float64 tensors against ``(n_hw,)`` HW
columns: :class:`LayerStack` packs every architecture's layers (host
numpy), :meth:`LayerStack.dedup_slots` factors them into the distinct
layer shapes, and :func:`simulate_network_stack_dedup` evaluates each
distinct layer once and sums per (architecture, slot) in slot order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import pe as pe_lib
from repro_torch.core.exact import div, floor_div


@dataclasses.dataclass(frozen=True)
class ConvLayer:
  """One conv (or 1x1-conv-as-matmul) workload layer.

  A: input feature-map spatial dim (assumed square A x A)
  C: input channels;  F: output channels (filter count)
  K: kernel size;     S: stride;     P: padding
  rs/ds: ResNet regular / dotted (projection) skip-connection indicators.
  """
  name: str
  A: int
  C: int
  F: int
  K: int = 1
  S: int = 1
  P: int = 0
  rs: int = 0
  ds: int = 0

  @property
  def out_dim(self) -> int:
    return (self.A + 2 * self.P - self.K) // self.S + 1

  @property
  def macs(self) -> int:
    e = self.out_dim
    return e * e * self.K * self.K * self.C * self.F

  @property
  def weight_count(self) -> int:
    return self.K * self.K * self.C * self.F

  @property
  def ifmap_count(self) -> int:
    return self.A * self.A * self.C

  @property
  def ofmap_count(self) -> int:
    e = self.out_dim
    return e * e * self.F

  def features(self) -> Tuple[float, ...]:
    """The layer-side features of the paper's 12-dim latency vector."""
    return (float(self.A), float(self.C), float(self.F), float(self.K),
            float(self.S), float(self.P), float(self.rs), float(self.ds))


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
  """The hardware half of QUIDAM's input space (Fig. 2)."""
  pe_type: str = "INT16"
  pe_rows: int = 16
  pe_cols: int = 16
  sp_if: int = 12      # ifmap scratchpad entries (words)
  sp_fw: int = 224     # filter scratchpad entries
  sp_ps: int = 24      # psum scratchpad entries
  gbuf_kb: int = 128   # global buffer (KiB)
  bandwidth_gbps: float = 12.8  # DRAM link bandwidth

  @property
  def n_pe(self) -> int:
    return self.pe_rows * self.pe_cols

  @property
  def pe(self) -> pe_lib.PEType:
    return pe_lib.pe_type(self.pe_type)

  def hw_features(self) -> Tuple[float, ...]:
    return (float(self.sp_if), float(self.sp_ps), float(self.sp_fw),
            float(self.n_pe))

  def latency_hw_features(self) -> Tuple[float, ...]:
    return (float(self.sp_if), float(self.sp_ps), float(self.sp_fw),
            float(self.pe_rows), float(self.pe_cols), float(self.gbuf_kb))


@dataclasses.dataclass
class LayerStats:
  """Per-layer dataflow simulation output."""
  cycles: float
  compute_cycles: float
  dram_stall_cycles: float
  utilization: float
  macs: int
  # access counts (words) per memory level
  spad_reads: float
  spad_writes: float
  gbuf_reads: float
  gbuf_writes: float
  dram_reads: float
  dram_writes: float


def simulate_layer(cfg: AcceleratorConfig, layer: ConvLayer,
                   clock_mhz: float) -> LayerStats:
  """Cycle-approximate RS dataflow simulation of one layer."""
  pe = cfg.pe
  E = max(layer.out_dim, 1)
  K, C, F = layer.K, layer.C, layer.F

  # ---- spatial mapping -------------------------------------------------
  # columns host output rows (E), rows host filter rows (K)
  col_folds = math.ceil(E / cfg.pe_cols)
  cols_used = min(E, cfg.pe_cols)
  k_rows = min(K, cfg.pe_rows)
  row_folds = math.ceil(K / cfg.pe_rows)
  # leftover row capacity replicates additional (channel, filter) tiles
  sets_per_col = max(cfg.pe_rows // k_rows, 1) if row_folds == 1 else 1
  spatial_util = (k_rows * sets_per_col * cols_used) / cfg.n_pe
  if row_folds > 1:
    spatial_util = (cfg.pe_rows * cols_used) / cfg.n_pe

  # ---- scratchpad-bounded tiling ----------------------------------------
  f_tile = max(1, min(F, cfg.sp_ps))
  # filter spad holds K * C_tile * F_tile weights (one filter row per pass)
  c_tile = max(1, min(C, cfg.sp_fw // max(K * f_tile, 1)))
  # ifmap spad needs a K-deep sliding window per channel in flight
  c_tile = max(1, min(c_tile, max(cfg.sp_if // max(K, 1), 1) * sets_per_col))
  n_c_passes = math.ceil(C / c_tile)
  n_f_passes = math.ceil(F / f_tile)
  # replication across spare row capacity processes extra channel tiles
  n_c_passes_eff = math.ceil(n_c_passes / sets_per_col)
  passes = n_c_passes_eff * n_f_passes * col_folds * row_folds

  # ---- compute cycles ----------------------------------------------------
  # per pass, each active PE performs E * K * c_tile * f_tile MACs, 1
  # MAC/cycle; pipeline fill ~ K + cols_used
  per_pass = E * K * c_tile * f_tile + (K + cols_used)
  compute_cycles = passes * per_pass
  ideal_cycles = layer.macs / cfg.n_pe
  compute_cycles = max(compute_cycles, ideal_cycles)
  utilization = min(1.0, ideal_cycles / max(compute_cycles, 1.0)) \
      * min(1.0, spatial_util + 1e-9)

  # ---- access counts -----------------------------------------------------
  macs = layer.macs
  # every MAC reads act + weight from its spads; the running psum lives in
  # an accumulator register and spills to the psum spad once per K MACs
  spad_reads = (2.0 + 1.0 / max(K, 1)) * macs
  spad_writes = macs / max(K, 1)
  # ifmap: DRAM -> gbuf once if it fits, else per filter-pass; gbuf ->
  # array once per filter pass (row-stationary reuses within a pass)
  ifmap_words = layer.ifmap_count
  gbuf_bits = cfg.gbuf_kb * 1024 * 8
  ifmap_fits = ifmap_words * pe.act_bits <= 0.5 * gbuf_bits
  dram_if = ifmap_words * (1 if ifmap_fits else n_f_passes)
  gbuf_if_reads = ifmap_words * n_f_passes * row_folds
  # weights: streamed from DRAM once per E-fold when they do not fit
  weight_words = layer.weight_count
  weights_fit = weight_words * pe.weight_bits <= 0.25 * gbuf_bits
  dram_w = weight_words * (1 if weights_fit else col_folds)
  gbuf_w_reads = weight_words * col_folds
  # psums: spill/refill between channel tiles
  of_words = layer.ofmap_count
  psum_spills = max(n_c_passes_eff - 1, 0)
  dram_of = of_words  # final writeback
  gbuf_reads = gbuf_if_reads + gbuf_w_reads + of_words * psum_spills
  gbuf_writes = of_words * (psum_spills + 1.0)
  dram_reads = dram_if + dram_w
  dram_writes = float(dram_of)

  # ---- bandwidth bound ---------------------------------------------------
  cycle_s = 1e-6 / clock_mhz
  dram_bits = (dram_if * pe.act_bits + dram_w * pe.weight_bits
               + dram_of * pe.psum_bits)
  dram_time_s = dram_bits / 8.0 / (cfg.bandwidth_gbps * 1e9)
  dram_cycles = dram_time_s / cycle_s
  # compute/communication overlap: stalls only for the non-overlapped excess
  dram_stall = max(0.0, dram_cycles - 0.85 * compute_cycles)
  cycles = compute_cycles + dram_stall

  return LayerStats(
      cycles=cycles, compute_cycles=compute_cycles,
      dram_stall_cycles=dram_stall, utilization=utilization, macs=macs,
      spad_reads=spad_reads, spad_writes=spad_writes,
      gbuf_reads=gbuf_reads, gbuf_writes=gbuf_writes,
      dram_reads=float(dram_reads), dram_writes=dram_writes)


def layer_energy_pj(cfg: AcceleratorConfig, layer: ConvLayer,
                    stats: LayerStats, clock_mhz: float,
                    leakage_mw: float) -> float:
  """Eyeriss-style hierarchical energy model (pJ) for one layer."""
  pe = cfg.pe
  e = pe_lib.ENERGY_PJ
  mac_e = stats.macs * pe.mac_energy_pj
  # two operand reads + one psum read per K MACs; psum-wide writes
  k = max(layer.K, 1)
  spad_read_bits = stats.macs * (pe.act_bits + pe.weight_bits
                                 + pe.psum_bits / k)
  spad_write_bits = stats.spad_writes * pe.psum_bits
  spad_e = (spad_read_bits + spad_write_bits) * e["spad_access_per_bit"]
  gbuf_bits = (stats.gbuf_reads + stats.gbuf_writes) * (
      (pe.act_bits + pe.weight_bits + pe.psum_bits) / 3.0)
  gbuf_e = gbuf_bits * e["gbuf_access_per_bit"]
  dram_bits = (stats.dram_reads * (pe.act_bits + pe.weight_bits) / 2.0
               + stats.dram_writes * pe.psum_bits)
  dram_e = dram_bits * e["dram_access_per_bit"]
  time_s = stats.cycles / (clock_mhz * 1e6)
  leak_e = leakage_mw * 1e-3 * time_s * 1e12  # mW * s -> pJ
  return mac_e + spad_e + gbuf_e + dram_e + leak_e


def simulate_network(cfg: AcceleratorConfig, layers: Sequence[ConvLayer],
                     clock_mhz: float, leakage_mw: float
                     ) -> Tuple[float, float, List[LayerStats]]:
  """Returns (total_latency_s, total_energy_mj, per-layer stats)."""
  total_cycles = 0.0
  total_energy_pj = 0.0
  all_stats: List[LayerStats] = []
  for layer in layers:
    st = simulate_layer(cfg, layer, clock_mhz)
    total_cycles += st.cycles
    total_energy_pj += layer_energy_pj(cfg, layer, st, clock_mhz, leakage_mw)
    all_stats.append(st)
  latency_s = total_cycles / (clock_mhz * 1e6)
  return latency_s, total_energy_pj * 1e-9, all_stats  # pJ -> mJ


Feature = Union[float, torch.Tensor]


@dataclasses.dataclass
class LayerStatsBatch:
  """Per-layer simulation output for N design points.  Fields that
  depend on the layer alone stay Python floats (``(n_layers, 1)``
  tensors on the joint path); x * s and x * t with ``t`` a tensor filled
  with ``s`` round identically, so this matches the reference's
  broadcast arrays bit for bit."""
  cycles: torch.Tensor
  compute_cycles: torch.Tensor
  dram_stall_cycles: torch.Tensor
  utilization: torch.Tensor
  macs: Feature
  spad_writes: Feature
  gbuf_reads: torch.Tensor
  gbuf_writes: torch.Tensor
  dram_reads: torch.Tensor
  dram_writes: Feature


def _layer_feats(layer: ConvLayer) -> Dict[str, float]:
  """The layer-side constants the batch formulas consume."""
  return {
      "E": float(max(layer.out_dim, 1)),
      "K": float(layer.K), "C": float(layer.C), "F": float(layer.F),
      "macs": float(layer.macs),
      "ifmap_words": float(layer.ifmap_count),
      "weight_words": float(layer.weight_count),
      "of_words": float(layer.ofmap_count),
  }


def _at_least_one(x: Feature) -> Feature:
  """``max(x, 1.0)`` of a Python float or elementwise of a tensor."""
  return max(x, 1.0) if isinstance(x, float) else torch.clamp(x, min=1.0)


def _quotient(a: Feature, b: Feature) -> Feature:
  """``a / b``: Python's division of two floats, :func:`exact.div` once a
  tensor is involved."""
  if isinstance(a, float) and isinstance(b, float):
    return a / b  # repro: ignore[EXA005] two Python floats: host division
  return div(a, b)


def _simulate_layer_feats(c: Dict[str, torch.Tensor],
                          f: Dict[str, Feature],
                          clock_mhz: torch.Tensor) -> LayerStatsBatch:
  """The batch RS-dataflow formulas over HW columns ``c`` x layer
  features ``f``: Python floats (one layer) or ``(n_layers, 1)`` tensors
  broadcasting against ``(n_hw,)`` columns (reference:
  ``dataflow._simulate_layer_feats``)."""
  pe_rows, pe_cols, n_pe = c["pe_rows"], c["pe_cols"], c["n_pe"]
  E, K, C, F = f["E"], f["K"], f["C"], f["F"]
  k_safe = _at_least_one(K)

  # ---- spatial mapping -------------------------------------------------
  col_folds = torch.ceil(div(E, pe_cols))
  cols_used = torch.clamp(pe_cols, max=E)
  k_rows = torch.clamp(pe_rows, max=K)
  row_folds = torch.ceil(div(K, pe_rows))
  one_fold = row_folds == 1
  sets_per_col = torch.where(
      one_fold, torch.clamp(floor_div(pe_rows, k_rows), min=1.0), 1.0)
  spatial_util = torch.where(one_fold,
                             div(k_rows * sets_per_col * cols_used, n_pe),
                             div(pe_rows * cols_used, n_pe))

  # ---- scratchpad-bounded tiling ----------------------------------------
  f_tile = torch.clamp(torch.clamp(c["sp_ps"], max=F), min=1.0)
  c_tile = torch.clamp(torch.clamp(
      floor_div(c["sp_fw"], torch.clamp(K * f_tile, min=1.0)), max=C),
      min=1.0)
  c_tile = torch.clamp(torch.minimum(
      c_tile, torch.clamp(floor_div(c["sp_if"], k_safe), min=1.0)
      * sets_per_col), min=1.0)
  n_c_passes = torch.ceil(div(C, c_tile))
  n_f_passes = torch.ceil(div(F, f_tile))
  n_c_passes_eff = torch.ceil(div(n_c_passes, sets_per_col))
  passes = n_c_passes_eff * n_f_passes * col_folds * row_folds

  # ---- compute cycles ----------------------------------------------------
  per_pass = E * K * c_tile * f_tile + (K + cols_used)
  compute_cycles = passes * per_pass
  ideal_cycles = div(f["macs"], n_pe)
  compute_cycles = torch.maximum(compute_cycles, ideal_cycles)
  utilization = torch.clamp(
      div(ideal_cycles, torch.clamp(compute_cycles, min=1.0)), max=1.0) \
      * torch.clamp(spatial_util + 1e-9, max=1.0)

  # ---- access counts -----------------------------------------------------
  macs = f["macs"]
  spad_writes = _quotient(macs, k_safe)
  ifmap_words = f["ifmap_words"]
  gbuf_bits = c["gbuf_kb"] * 1024 * 8
  ifmap_fits = ifmap_words * c["act_bits"] <= 0.5 * gbuf_bits
  dram_if = ifmap_words * torch.where(ifmap_fits, 1.0, n_f_passes)
  gbuf_if_reads = ifmap_words * n_f_passes * row_folds
  weight_words = f["weight_words"]
  weights_fit = weight_words * c["weight_bits"] <= 0.25 * gbuf_bits
  dram_w = weight_words * torch.where(weights_fit, 1.0, col_folds)
  gbuf_w_reads = weight_words * col_folds
  of_words = f["of_words"]
  psum_spills = torch.clamp(n_c_passes_eff - 1.0, min=0.0)
  dram_of = of_words
  gbuf_reads = gbuf_if_reads + gbuf_w_reads + of_words * psum_spills
  gbuf_writes = of_words * (psum_spills + 1.0)
  dram_reads = dram_if + dram_w

  # ---- bandwidth bound ---------------------------------------------------
  cycle_s = div(1e-6, clock_mhz)
  dram_bits = (dram_if * c["act_bits"] + dram_w * c["weight_bits"]
               + dram_of * c["psum_bits"])
  dram_time_s = div(div(dram_bits, 8.0), c["bandwidth_gbps"] * 1e9)
  dram_cycles = div(dram_time_s, cycle_s)
  dram_stall = torch.clamp(dram_cycles - 0.85 * compute_cycles, min=0.0)
  cycles = compute_cycles + dram_stall

  return LayerStatsBatch(
      cycles=cycles, compute_cycles=compute_cycles,
      dram_stall_cycles=dram_stall, utilization=utilization, macs=macs,
      spad_writes=spad_writes, gbuf_reads=gbuf_reads,
      gbuf_writes=gbuf_writes, dram_reads=dram_reads, dram_writes=dram_of)


def _layer_energy_feats(c: Dict[str, torch.Tensor], f: Dict[str, Feature],
                        stats: LayerStatsBatch, clock_mhz: torch.Tensor,
                        leakage_mw: torch.Tensor) -> torch.Tensor:
  """Hierarchical energy formulas (pJ per design point; reference:
  ``dataflow._layer_energy_feats``), broadcasting like
  :func:`_simulate_layer_feats`."""
  e = pe_lib.ENERGY_PJ
  mac_e = stats.macs * c["mac_energy_pj"]
  k = _at_least_one(f["K"])
  spad_read_bits = stats.macs * (c["act_bits"] + c["weight_bits"]
                                 + div(c["psum_bits"], k))
  spad_write_bits = stats.spad_writes * c["psum_bits"]
  spad_e = (spad_read_bits + spad_write_bits) * e["spad_access_per_bit"]
  gbuf_bits = (stats.gbuf_reads + stats.gbuf_writes) * div(
      c["act_bits"] + c["weight_bits"] + c["psum_bits"], 3.0)
  gbuf_e = gbuf_bits * e["gbuf_access_per_bit"]
  dram_bits = (div(stats.dram_reads * (c["act_bits"] + c["weight_bits"]),
                   2.0)
               + stats.dram_writes * c["psum_bits"])
  dram_e = dram_bits * e["dram_access_per_bit"]
  time_s = div(stats.cycles, clock_mhz * 1e6)
  leak_e = leakage_mw * 1e-3 * time_s * 1e12  # mW * s -> pJ
  return mac_e + spad_e + gbuf_e + dram_e + leak_e


def simulate_network_batch(c: Dict[str, torch.Tensor],
                           layers: Sequence[ConvLayer],
                           clock_mhz: torch.Tensor, leakage_mw: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
  """``(latency_s, energy_mj, utilization)`` per design point; utilization
  is the cycle-weighted mean over layers."""
  total_cycles = 0.0
  total_energy_pj = 0.0
  util_weighted = 0.0
  for layer in layers:
    f = _layer_feats(layer)
    st = _simulate_layer_feats(c, f, clock_mhz)
    total_cycles = total_cycles + st.cycles
    total_energy_pj = total_energy_pj + _layer_energy_feats(
        c, f, st, clock_mhz, leakage_mw)
    util_weighted = util_weighted + st.utilization * st.cycles
  latency_s = div(total_cycles, clock_mhz * 1e6)
  utilization = div(util_weighted, torch.clamp(total_cycles, min=1e-12))
  return latency_s, total_energy_pj * 1e-9, utilization  # pJ -> mJ


# ---------------------------------------------------------------------------
# joint HW x NN batching: all architectures x all design points at once
# ---------------------------------------------------------------------------

# Padded layer slots use a benign 1x1x1 layer so every formula stays
# finite; the validity mask zeroes their contribution before accumulation
# (x + 0.0 == x exactly, so padding never perturbs a bit).
_PAD_LAYER = ConvLayer("pad", A=1, C=1, F=1, K=1, S=1, P=0)

# ConvLayer int fields packed into the stack, in feature order
_STACK_FIELDS = ("A", "C", "F", "K", "S", "P", "rs", "ds")


@dataclasses.dataclass(eq=False)
class LayerStack:
  """Padded per-architecture layer features: ``(n_archs, max_layers)``
  int64 tensors per ConvLayer field plus a validity mask.

  Built once per co-exploration sweep (``from_layer_lists``), on the
  host in numpy; the derived quantities every dataflow formula needs
  (out_dim, MAC count, tensor word counts) are precomputed as float64
  arrays.
  """
  A: np.ndarray
  C: np.ndarray
  F: np.ndarray
  K: np.ndarray
  S: np.ndarray
  P: np.ndarray
  rs: np.ndarray
  ds: np.ndarray
  valid: np.ndarray

  def __post_init__(self):
    for name in _STACK_FIELDS:
      setattr(self, name, np.asarray(getattr(self, name), np.int64))
    self.valid = np.asarray(self.valid, np.bool_)
    shape = self.A.shape
    if len(shape) != 2:
      raise ValueError(f"LayerStack fields must be 2-D, got shape {shape}")
    for name in _STACK_FIELDS + ("valid",):
      if getattr(self, name).shape != shape:
        raise ValueError(f"field {name!r} has shape "
                         f"{getattr(self, name).shape}, expected {shape}")
    # derived float64 tensors (all integer-valued, exact in float64)
    a, c, f, k = (x.astype(np.float64) for x in (self.A, self.C, self.F,
                                                 self.K))
    s, p = self.S.astype(np.float64), self.P.astype(np.float64)
    out = np.floor((a + 2.0 * p - k) / np.maximum(s, 1.0)) + 1.0
    self._E = np.maximum(out, 1.0)
    self._macs = out * out * k * k * c * f
    self._ifmap_words = a * a * c
    self._weight_words = k * k * c * f
    self._of_words = out * out * f

  @property
  def n_archs(self) -> int:
    return int(self.A.shape[0])

  @property
  def max_layers(self) -> int:
    return int(self.A.shape[1])

  def n_layers(self) -> np.ndarray:
    """Per-architecture true layer count."""
    return self.valid.sum(axis=1)

  @classmethod
  def from_layer_lists(cls, layer_lists: Sequence[Sequence[ConvLayer]]
                       ) -> "LayerStack":
    """Pack one ConvLayer list per architecture, right-padded to the
    longest network."""
    lists = [list(ls) for ls in layer_lists]
    n_max = max((len(ls) for ls in lists), default=0) or 1
    padded = [ls + [_PAD_LAYER] * (n_max - len(ls)) for ls in lists]
    cols = {name: np.asarray([[getattr(l, name) for l in ls]
                              for ls in padded], np.int64)
            for name in _STACK_FIELDS}
    valid = np.asarray([[True] * len(ls) + [False] * (n_max - len(ls))
                        for ls in lists], np.bool_)
    return cls(valid=valid, **cols)

  def slice_archs(self, lo: int, hi: int) -> "LayerStack":
    """Arch-range sub-stack (the streaming engine's unit of work).

    Row ``a`` of the slice is bit-identical to row ``lo + a`` of the full
    stack — padding columns are preserved, so per-slot accumulation order
    (and therefore every latency/energy sum) is unchanged.
    """
    sl = slice(lo, hi)
    return LayerStack(valid=self.valid[sl],
                      **{name: getattr(self, name)[sl]
                         for name in _STACK_FIELDS})

  def layers_of(self, arch_id: int) -> List[ConvLayer]:
    """Materialize one architecture's ConvLayer list (scalar escape)."""
    out = []
    for li in range(self.max_layers):
      if not self.valid[arch_id, li]:
        break
      out.append(ConvLayer(
          f"a{arch_id}l{li}",
          **{name: int(getattr(self, name)[arch_id, li])
             for name in _STACK_FIELDS}))
    return out

  def features(self) -> np.ndarray:
    """(n_archs, max_layers, 8) float64 layer-feature tensor in the
    paper's latency-model order (== ConvLayer.features())."""
    return np.stack([getattr(self, name).astype(np.float64)
                     for name in _STACK_FIELDS], axis=2)

  def feats_at(self, li: int) -> Dict[str, np.ndarray]:
    """Layer slot ``li`` as ``(n_archs, 1)`` broadcastable feature
    columns (the array twin of :func:`_layer_feats`)."""
    sl = slice(li, li + 1)
    return {
        "E": self._E[:, sl], "K": self.K[:, sl].astype(np.float64),
        "C": self.C[:, sl].astype(np.float64),
        "F": self.F[:, sl].astype(np.float64),
        "macs": self._macs[:, sl],
        "ifmap_words": self._ifmap_words[:, sl],
        "weight_words": self._weight_words[:, sl],
        "of_words": self._of_words[:, sl],
    }

  def fingerprint(self) -> str:
    """Content hash of the stack."""
    import hashlib
    h = hashlib.sha256()
    for name in _STACK_FIELDS + ("valid",):
      h.update(np.ascontiguousarray(getattr(self, name)).tobytes())
    return h.hexdigest()[:16]

  def dedup_slots(self) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Distinct-layer factorization: ``(unique_cols, slot_ids)``.

    Architectures drawn from one search space share most of their layers,
    so the ``n_archs x max_layers`` slot grid typically references only a
    few dozen *distinct* layer shapes.  ``unique_cols`` holds one
    ``(n_distinct, 1)`` float64 column per ConvLayer field (broadcastable
    against ``(n_hw,)`` HW columns exactly like :meth:`feats_at` rows);
    ``slot_ids[a, li]`` maps each slot to its distinct row.  The joint
    oracle simulates each distinct layer once per HW chunk and *gathers*
    per slot — per-slot accumulation order is unchanged, so results stay
    bit-identical to the slot-by-slot evaluation (see
    :func:`simulate_network_stack_dedup`).
    """
    feats = np.stack([getattr(self, n).reshape(-1) for n in _STACK_FIELDS],
                     axis=1)
    uniq, inv = np.unique(feats, axis=0, return_inverse=True)
    slot_ids = inv.reshape(self.A.shape).astype(np.int32)
    cols = {n: uniq[:, i:i + 1].astype(np.float64)
            for i, n in enumerate(_STACK_FIELDS)}
    return cols, slot_ids

  def __repr__(self) -> str:
    return (f"LayerStack({self.n_archs} archs x <= {self.max_layers} "
            f"layers)")


def unique_layer_feats(cols: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
  """Derived feature columns for :meth:`LayerStack.dedup_slots` rows (as
  ``(n_distinct, 1)`` tensors): the expressions LayerStack precomputes in
  ``__post_init__``, products left to right, so bit-identical to its
  :meth:`LayerStack.feats_at` values."""
  a, c, f, k = cols["A"], cols["C"], cols["F"], cols["K"]
  s, p = cols["S"], cols["P"]
  out = torch.floor(div(a + 2.0 * p - k, torch.clamp(s, min=1.0))) + 1.0
  return {"E": torch.clamp(out, min=1.0), "K": k, "C": c, "F": f,
          "macs": out * out * k * k * c * f,
          "ifmap_words": a * a * c,
          "weight_words": k * k * c * f,
          "of_words": out * out * f}


def _accumulate_slots(clock_mhz, n_slots, slot):
  """Sum (cycles, energy pJ, utilization x cycles) over layer slots in
  slot order, masked where a slot is padding; ``slot(li)`` returns the
  slot's (valid mask, cycles, energy, utilization x cycles) grids.  The
  totals then become ``(latency_s, energy_mj, utilization)``."""
  total_cycles = 0.0
  total_energy_pj = 0.0
  util_weighted = 0.0
  for li in range(n_slots):
    v, cyc, e_pj, util_cyc = slot(li)
    total_cycles = total_cycles + torch.where(v, cyc, 0.0)
    total_energy_pj = total_energy_pj + torch.where(v, e_pj, 0.0)
    util_weighted = util_weighted + torch.where(v, util_cyc, 0.0)
  latency_s = div(total_cycles, clock_mhz * 1e6)
  utilization = div(util_weighted, torch.clamp(total_cycles, min=1e-12))
  return latency_s, total_energy_pj * 1e-9, utilization  # pJ -> mJ


def simulate_network_stack_dedup(c: Dict[str, torch.Tensor],
                                 unique_cols: Dict[str, torch.Tensor],
                                 slot_ids: torch.Tensor, valid: torch.Tensor,
                                 clock_mhz: torch.Tensor,
                                 leakage_mw: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
  """Distinct-layer twin of :func:`simulate_network_stack`: the dataflow
  and energy formulas run once per *distinct* layer (``(n_distinct,
  n_hw)`` grids), and each (arch, slot) gathers its distinct row, so the
  per-slot accumulation order, and every bit, is that of the slot-by-slot
  evaluation.

  ``unique_cols`` and ``slot_ids`` (int64) come from
  :meth:`LayerStack.dedup_slots`, ``valid`` is the stack's mask, all as
  tensors on ``c``'s device.  Returns ``(latency_s, energy_mj,
  utilization)`` shaped ``(n_archs, n_hw)``.
  """
  f = unique_layer_feats(unique_cols)
  st = _simulate_layer_feats(c, f, clock_mhz)
  e_pj = _layer_energy_feats(c, f, st, clock_mhz, leakage_mw)
  cyc = st.cycles
  util_cyc = st.utilization * cyc

  def slot(li):
    ids = slot_ids[:, li]
    return valid[:, li:li + 1], cyc[ids], e_pj[ids], util_cyc[ids]

  return _accumulate_slots(clock_mhz, slot_ids.shape[1], slot)


def simulate_network_stack(c: Dict[str, torch.Tensor], stack: LayerStack,
                           clock_mhz: torch.Tensor, leakage_mw: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
  """Every architecture of ``stack`` x every design point of ``c``, one
  batched pass per layer slot.  Returns ``(latency_s, energy_mj,
  utilization)`` shaped ``(n_archs, n_hw)``; row ``a`` is bit-identical
  to ``simulate_network_batch(c, stack.layers_of(a), ...)``: padded
  slots contribute exactly 0.0 and the per-slot accumulation order is
  the per-layer loop's."""
  device = clock_mhz.device
  valid = torch.from_numpy(stack.valid).to(device)

  def slot(li):
    f = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in stack.feats_at(li).items()}
    st = _simulate_layer_feats(c, f, clock_mhz)
    e_pj = _layer_energy_feats(c, f, st, clock_mhz, leakage_mw)
    return valid[:, li:li + 1], st.cycles, e_pj, st.utilization * st.cycles

  return _accumulate_slots(clock_mhz, stack.max_layers, slot)
