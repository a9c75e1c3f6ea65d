"""Synthesis oracle: exact float64 PPA per design point and per table.

The port of ``repro.core.oracle``, in two forms.

The scalar oracle (:func:`characterize` and the per-target functions
:func:`clock_mhz` ... :func:`power_mw`) is host Python, op for op the
reference's, so its outputs are bit-equal to it.  It is the slow,
exact path the paper's polynomial models are fitted on and replace
(:mod:`repro_torch.core.ppa`), and the baseline of the speedup claim.

The batch oracle evaluates a whole ConfigTable.  Its work splits in two:

  host   :func:`batch_inputs` builds every column the formulas read, in
         numpy: the knobs, the per-row PE constants, the uint64 layout
         variation hashes, and every transcendental term (log2, pow,
         sqrt and the decoder depth ``ceil(log2(words))``).  These are
         pure functions of the config columns, and torch's ``sqrt`` and
         CUDA's ``log2`` are not correctly rounded to numpy's bits, so
         they are computed once here with the reference's own numpy
         expressions.
  device the formulas below, in float64 torch on whatever device the
         columns live, op for op as the reference writes them, with
         every division through :mod:`repro_torch.core.exact`.

The batch result is bit-identical to ``repro.core.oracle.
characterize_batch`` on the numpy path; like the reference's, it agrees
with the scalar oracle within about 1e-9, not bit for bit.  The joint
form (:func:`characterize_joint`, :func:`characterize_joint_dedup`)
characterizes every architecture of a co-exploration against every
design point, bit-identical to the reference's numpy
``characterize_joint``.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import pe as pe_lib
from repro_torch.core.dataflow import (AcceleratorConfig, ConvLayer,
                                       LayerStack, layer_energy_pj,
                                       simulate_layer, simulate_network,
                                       simulate_network_batch,
                                       simulate_network_stack,
                                       simulate_network_stack_dedup)
from repro_torch.core.exact import div

# Characterization-model version (the reference's): part of a fitted
# polynomial model's cache key, so a cache fitted against other oracle
# outputs refits.  v2: the column-hashed variation below.
ORACLE_VERSION = 2

# FIFO depth per the Eyeriss-style template (4 FIFOs per PE, Fig. 3).
FIFO_DEPTH = 4
FLOP_BIT_UM2 = 2.0          # latch-based FIFO storage cell
NOC_GATES_PER_PE = 300      # X-bus router slice + links at 21-bit mean width
PSUM_AMORTIZE = 3.0         # psum spad is touched once per K MACs
ARRAY_CTRL_GATES = 12_000   # top-level controller, address generators

# the scratchpads and the global buffer, each with the column holding its
# depth in words: ("sp_if", ...) for the PE scratchpads
SPADS = (("sp_if", "act_bits"), ("sp_fw", "weight_bits"),
         ("sp_ps", "psum_bits"))


_MASK64 = (1 << 64) - 1


@functools.lru_cache(maxsize=None)
def _name_const(name: str) -> int:
  """Stable 64-bit constant for a salt / PE-type name (one-time hash)."""
  return int.from_bytes(hashlib.sha256(name.encode()).digest()[:8], "little")


# ---------------------------------------------------------------------------
# scalar oracle (host Python, one design point per call)
# ---------------------------------------------------------------------------
# Layout variation hashes the design point's key columns: salt and PE-type
# names enter as one-time SHA-256 constants, then each knob is chained
# through a splitmix64 finalizer.  The same mixer runs on Python ints here
# and on uint64 columns in :func:`_variation_batch`.

def _mix64(z: int) -> int:
  """splitmix64 finalizer on a Python int (mod 2^64)."""
  z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
  z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
  return z ^ (z >> 31)


def _variation_key_ints(cfg: AcceleratorConfig) -> Tuple[int, ...]:
  return (_name_const(cfg.pe_type), cfg.pe_rows, cfg.pe_cols, cfg.sp_if,
          cfg.sp_fw, cfg.sp_ps, cfg.gbuf_kb,
          int.from_bytes(struct.pack("<d", float(cfg.bandwidth_gbps)),
                         "little"))


def _variation(cfg: AcceleratorConfig, salt: str, pct: float) -> float:
  """Deterministic pseudo-random multiplier in [1-pct, 1+pct]."""
  h = _name_const(salt)
  for v in _variation_key_ints(cfg):
    h = _mix64(h ^ v)
  u = (h / 2**64) * 2.0 - 1.0
  return 1.0 + pct * u


def _sram_area_um2(bits: float, words: float = 64.0) -> float:
  """CACTI-flavoured small-SRAM area: cells + sqrt-periphery + decoder
  steps (ceil(log2 words) levels) + fixed."""
  if bits <= 0:
    return 0.0
  decoder = 6.0 * pe_lib.decoder_levels(words) * math.sqrt(max(bits, 1.0)) \
      / 8.0
  return bits * pe_lib.SRAM_BIT_UM2 + 3.0 * math.sqrt(bits) + decoder + 15.0


def clock_mhz(cfg: AcceleratorConfig) -> float:
  """Post-synthesis clock estimate: arithmetic critical path + a control
  and wire term that grows with the array size and scratchpad depth."""
  pe = cfg.pe
  ctrl_ns = 0.028 * math.log2(max(cfg.n_pe, 2)) \
      + 0.006 * math.log2(max(cfg.sp_fw + cfg.sp_if + cfg.sp_ps, 2))
  period_ns = pe.critical_path_ns + ctrl_ns
  period_ns *= _variation(cfg, "clk", 0.004)
  return 1000.0 / period_ns


def pe_area_um2(cfg: AcceleratorConfig) -> float:
  """One PE: arithmetic + 3 scratchpads + 4 FIFOs + local control."""
  pe = cfg.pe
  arith = pe.arith_gates * pe_lib.GATE_AREA_UM2
  spad = (_sram_area_um2(cfg.sp_if * pe.act_bits, cfg.sp_if)
          + _sram_area_um2(cfg.sp_fw * pe.weight_bits, cfg.sp_fw)
          + _sram_area_um2(cfg.sp_ps * pe.psum_bits, cfg.sp_ps))
  fifo_bits = FIFO_DEPTH * (2 * pe.act_bits + pe.weight_bits + pe.psum_bits)
  fifo = fifo_bits * FLOP_BIT_UM2
  ctrl = 0.04 * (arith + spad) + 220 * pe_lib.GATE_AREA_UM2
  return arith + spad + fifo + ctrl


def array_area_mm2(cfg: AcceleratorConfig) -> float:
  """PE-array subsystem (array + NoC + control, excluding the global
  buffer): the polynomial area model's target."""
  pe = cfg.pe
  pe_area = pe_area_um2(cfg) * cfg.n_pe
  word = (pe.act_bits + pe.weight_bits + pe.psum_bits) / 3.0
  noc = NOC_GATES_PER_PE * (word / 21.0) * cfg.n_pe * pe_lib.GATE_AREA_UM2
  top = ARRAY_CTRL_GATES * pe_lib.GATE_AREA_UM2
  # routing congestion: the placer needs slack area ~ 1/(1 - congestion)
  congestion = 0.30 * (cfg.n_pe / 1024.0) ** 0.7
  route = 1.0 / (1.0 - min(congestion, 0.45))
  um2 = (pe_area + noc + top) * route * _variation(cfg, "area", 0.005)
  return um2 * 1e-6


def gbuf_area_mm2(cfg: AcceleratorConfig) -> float:
  """Global-buffer SRAM macro area (closed form, banking overhead incl.)."""
  return _sram_area_um2(cfg.gbuf_kb * 1024 * 8, cfg.gbuf_kb * 512) \
      * 1.15 * 1e-6


def area_mm2(cfg: AcceleratorConfig) -> float:
  """Full accelerator: PE array subsystem + global buffer macro."""
  return array_area_mm2(cfg) + gbuf_area_mm2(cfg)


def leakage_mw(cfg: AcceleratorConfig) -> float:
  """Array static power ~ gate-area equivalent (gbuf leakage lives in
  :func:`gbuf_power_mw`)."""
  pe = cfg.pe
  word = (pe.act_bits + pe.weight_bits + pe.psum_bits) / 3.0
  logic_um2 = (pe.arith_gates + NOC_GATES_PER_PE * word / 21.0) \
      * pe_lib.GATE_AREA_UM2 * cfg.n_pe \
      + ARRAY_CTRL_GATES * pe_lib.GATE_AREA_UM2
  sram_bits = cfg.n_pe * (cfg.sp_if * pe.act_bits + cfg.sp_fw * pe.weight_bits
                          + cfg.sp_ps * pe.psum_bits)
  leak = (logic_um2 / pe_lib.GATE_AREA_UM2) * pe_lib.GATE_LEAKAGE_UW \
      + sram_bits * 0.00035
  return leak * 1e-3  # uW -> mW


def array_power_mw(cfg: AcceleratorConfig) -> float:
  """PE-array characterization power (DC default activity), excluding the
  global buffer: the polynomial power model's target."""
  pe = cfg.pe
  f_hz = clock_mhz(cfg) * 1e6
  e = pe_lib.ENERGY_PJ
  spad_pj = e["spad_access_per_bit"] * (
      pe.act_bits * pe_lib.sram_access_scale(cfg.sp_if)
      + pe.weight_bits * pe_lib.sram_access_scale(cfg.sp_fw)
      + (2.0 / PSUM_AMORTIZE) * pe.psum_bits
      * pe_lib.sram_access_scale(cfg.sp_ps))
  per_pe_pj = (pe.mac_energy_pj + spad_pj
               + FIFO_DEPTH * 0.25 * e["fifo_access_per_bit"])
  activity = 0.62  # DC default toggling assumption
  dyn_pe_mw = cfg.n_pe * per_pe_pj * activity * f_hz * 1e-9
  gbuf_word_bits = (pe.act_bits + pe.weight_bits + pe.psum_bits) / 3.0
  noc_mw = cfg.n_pe * 0.004 * (f_hz * 1e-9) * gbuf_word_bits
  dyn = dyn_pe_mw + noc_mw
  # self-heating feedback: leakage rises with power density
  density = dyn / max(array_area_mm2(cfg), 1e-6)  # mW / mm^2
  leak = leakage_mw(cfg) * (1.0 + 0.9 * density / (density + 40.0))
  return dyn * _variation(cfg, "pwr", 0.005) + leak


def gbuf_power_mw(cfg: AcceleratorConfig) -> float:
  """Global-buffer macro power: ports scale with the array edge
  (~sqrt(#PE)); per-bit energy scales with capacity; plus SRAM leakage."""
  pe = cfg.pe
  f_hz = clock_mhz(cfg) * 1e6
  e = pe_lib.ENERGY_PJ
  gbuf_word_bits = (pe.act_bits + pe.weight_bits + pe.psum_bits) / 3.0
  gbuf_pj_bit = e["gbuf_access_per_bit"] * pe_lib.sram_access_scale(
      cfg.gbuf_kb * 16.0)
  dyn = math.sqrt(cfg.n_pe) * gbuf_word_bits * gbuf_pj_bit * 0.62 \
      * f_hz * 1e-9
  leak = cfg.gbuf_kb * 8192 * 0.00035 * 1e-3
  return dyn + leak


def power_mw(cfg: AcceleratorConfig) -> float:
  """Full accelerator characterization power."""
  return array_power_mw(cfg) + gbuf_power_mw(cfg)


@dataclasses.dataclass
class Characterization:
  """Everything the paper extracts from DC + VCS for one design point."""
  clock_mhz: float
  area_mm2: float
  power_mw: float
  latency_s: float
  energy_mj: float
  per_layer_cycles: List[float]
  per_layer_energy_mj: List[float]
  utilization: float


def characterize(cfg: AcceleratorConfig,
                 layers: Sequence[ConvLayer]) -> Characterization:
  """Synthesize + simulate one (hardware, network) pair: the slow path
  the polynomial models are trained on and replace."""
  clk = clock_mhz(cfg)
  leak = leakage_mw(cfg)
  latency_s, energy_mj, stats = simulate_network(cfg, layers, clk, leak)
  per_cyc = [s.cycles for s in stats]
  per_e = [layer_energy_pj(cfg, l, s, clk, leak) * 1e-9
           for l, s in zip(layers, stats)]
  util = (sum(s.utilization * s.cycles for s in stats)
          / max(sum(per_cyc), 1e-12))
  return Characterization(
      clock_mhz=clk, area_mm2=area_mm2(cfg), power_mw=power_mw(cfg),
      latency_s=latency_s, energy_mj=energy_mj,
      per_layer_cycles=per_cyc, per_layer_energy_mj=per_e,
      utilization=util)


def characterize_layer_latency(cfg: AcceleratorConfig, layer: ConvLayer
                               ) -> float:
  """Ground-truth single-layer latency in seconds (latency-model target)."""
  clk = clock_mhz(cfg)
  st = simulate_layer(cfg, layer, clk)
  return st.cycles / (clk * 1e6)


# ---------------------------------------------------------------------------
# host half: variation hashes + transcendental columns (numpy)
# ---------------------------------------------------------------------------


def _mix64_batch(z: np.ndarray) -> np.ndarray:
  """splitmix64 finalizer across a uint64 column (wraps mod 2^64)."""
  z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
  z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
  return z ^ (z >> np.uint64(31))


def _variation_batch(table, salt: str, pct: float) -> np.ndarray:
  """Deterministic per-row multiplier in [1-pct, 1+pct]."""
  type64 = np.asarray([_name_const(t) for t in table.pe_type_names],
                      np.uint64)[table.pe_code]
  h = np.full(len(table), _name_const(salt), np.uint64)
  cols = (type64,
          table.pe_rows.astype(np.uint64), table.pe_cols.astype(np.uint64),
          table.sp_if.astype(np.uint64), table.sp_fw.astype(np.uint64),
          table.sp_ps.astype(np.uint64), table.gbuf_kb.astype(np.uint64),
          table.bandwidth_gbps.astype(np.float64).view(np.uint64))
  for v in cols:
    h = _mix64_batch(h ^ v)
  # same IEEE op sequence as the reference: /2^64, *2, -1, *pct, +1
  u = h / 2.0**64
  return ((u * 2.0) - 1.0) * pct + 1.0


def _decoder_levels(words: np.ndarray) -> np.ndarray:
  return np.maximum(np.ceil(np.log2(np.maximum(words, 2.0))), 1.0)


def batch_inputs(table) -> Dict[str, np.ndarray]:
  """Every float64 column the device formulas read, computed on the host.

  Beyond the reference's bundle (numeric columns, three variation
  columns, log2/pow terms) this precomputes, per scratchpad ``sp`` and
  for the global buffer ``gbuf``:

    ``dec_<sp>``       decoder depth of the spad (words = depth)
    ``acc_sqrt_<sp>``  ``sqrt(max(words, 1) / 64)`` of the access scale
    ``bits_sqrt_<sp>`` ``sqrt(max(bits, 1))`` of the area model; bits are
                       whole numbers, so this also equals the reference's
                       ``sqrt(max(bits, 0))`` wherever the area is kept
  plus ``dec_gbuf_area`` (words = gbuf_kb * 512), ``dec_gbuf`` and
  ``acc_sqrt_gbuf`` (words = gbuf_kb * 16) and ``sqrt_n_pe``.
  """
  cols = table.numeric_columns()
  cols["var_clk"] = _variation_batch(table, "clk", 0.004)
  cols["var_area"] = _variation_batch(table, "area", 0.005)
  cols["var_pwr"] = _variation_batch(table, "pwr", 0.005)
  cols["log2_n_pe"] = np.log2(np.maximum(cols["n_pe"], 2.0))
  cols["log2_sp_words"] = np.log2(
      np.maximum(cols["sp_fw"] + cols["sp_if"] + cols["sp_ps"], 2.0))
  cols["congestion"] = 0.30 * np.power(cols["n_pe"] / 1024.0, 0.7)
  for sp, bits_col in SPADS:
    words = cols[sp]
    cols[f"dec_{sp}"] = _decoder_levels(words)
    cols[f"acc_sqrt_{sp}"] = np.sqrt(np.maximum(words, 1.0) / 64.0)
    cols[f"bits_sqrt_{sp}"] = np.sqrt(np.maximum(words * cols[bits_col],
                                                 1.0))
  gbuf = cols["gbuf_kb"]
  cols["dec_gbuf_area"] = _decoder_levels(gbuf * 512)
  cols["bits_sqrt_gbuf"] = np.sqrt(np.maximum(gbuf * 1024 * 8, 1.0))
  cols["dec_gbuf"] = _decoder_levels(gbuf * 16.0)
  cols["acc_sqrt_gbuf"] = np.sqrt(np.maximum(gbuf * 16.0, 1.0) / 64.0)
  cols["sqrt_n_pe"] = np.sqrt(cols["n_pe"])
  return cols


# ---------------------------------------------------------------------------
# device half: the formulas (torch, float64)
# ---------------------------------------------------------------------------

def _sram_access_scale(c, name: str) -> torch.Tensor:
  return 0.47 + 0.45 * c[f"acc_sqrt_{name}"] + 0.022 * c[f"dec_{name}"]


def _sram_area_cols(bits: torch.Tensor, dec: torch.Tensor,
                    bits_sqrt: torch.Tensor) -> torch.Tensor:
  decoder = div(6.0 * dec * bits_sqrt, 8.0)
  area = bits * pe_lib.SRAM_BIT_UM2 + 3.0 * bits_sqrt + decoder + 15.0
  return torch.where(bits <= 0, 0.0, area)


def _word_bits(c) -> torch.Tensor:
  return div(c["act_bits"] + c["weight_bits"] + c["psum_bits"], 3.0)


def _clock_cols(c) -> torch.Tensor:
  ctrl_ns = 0.028 * c["log2_n_pe"] + 0.006 * c["log2_sp_words"]
  period_ns = (c["critical_path_ns"] + ctrl_ns) * c["var_clk"]
  return div(1000.0, period_ns)


def _pe_area_cols(c) -> torch.Tensor:
  arith = c["arith_gates"] * pe_lib.GATE_AREA_UM2
  spad = None
  for sp, bits_col in SPADS:
    a = _sram_area_cols(c[sp] * c[bits_col], c[f"dec_{sp}"],
                        c[f"bits_sqrt_{sp}"])
    spad = a if spad is None else spad + a
  fifo_bits = FIFO_DEPTH * (2 * c["act_bits"] + c["weight_bits"]
                            + c["psum_bits"])
  fifo = fifo_bits * FLOP_BIT_UM2
  ctrl = 0.04 * (arith + spad) + 220 * pe_lib.GATE_AREA_UM2
  return arith + spad + fifo + ctrl


def _array_area_cols(c) -> torch.Tensor:
  pe_area = _pe_area_cols(c) * c["n_pe"]
  noc = NOC_GATES_PER_PE * div(_word_bits(c), 21.0) * c["n_pe"] \
      * pe_lib.GATE_AREA_UM2
  top = ARRAY_CTRL_GATES * pe_lib.GATE_AREA_UM2
  route = div(1.0, 1.0 - torch.clamp(c["congestion"], max=0.45))
  um2 = (pe_area + noc + top) * route * c["var_area"]
  return um2 * 1e-6


def _gbuf_area_cols(c) -> torch.Tensor:
  return _sram_area_cols(c["gbuf_kb"] * 1024 * 8, c["dec_gbuf_area"],
                         c["bits_sqrt_gbuf"]) * 1.15 * 1e-6


def _leakage_cols(c) -> torch.Tensor:
  logic_um2 = (c["arith_gates"] + div(NOC_GATES_PER_PE * _word_bits(c),
                                      21.0)) \
      * pe_lib.GATE_AREA_UM2 * c["n_pe"] \
      + ARRAY_CTRL_GATES * pe_lib.GATE_AREA_UM2
  sram_bits = c["n_pe"] * (c["sp_if"] * c["act_bits"]
                           + c["sp_fw"] * c["weight_bits"]
                           + c["sp_ps"] * c["psum_bits"])
  leak = div(logic_um2, pe_lib.GATE_AREA_UM2) * pe_lib.GATE_LEAKAGE_UW \
      + sram_bits * 0.00035
  return leak * 1e-3


def _array_power_cols(c, clock, array_area) -> torch.Tensor:
  f_hz = clock * 1e6
  e = pe_lib.ENERGY_PJ
  spad_pj = e["spad_access_per_bit"] * (
      c["act_bits"] * _sram_access_scale(c, "sp_if")
      + c["weight_bits"] * _sram_access_scale(c, "sp_fw")
      + (2.0 / PSUM_AMORTIZE) * c["psum_bits"]
      * _sram_access_scale(c, "sp_ps"))
  per_pe_pj = (c["mac_energy_pj"] + spad_pj
               + FIFO_DEPTH * 0.25 * e["fifo_access_per_bit"])
  activity = 0.62
  dyn_pe_mw = c["n_pe"] * per_pe_pj * activity * f_hz * 1e-9
  noc_mw = c["n_pe"] * 0.004 * (f_hz * 1e-9) * _word_bits(c)
  dyn = dyn_pe_mw + noc_mw
  density = div(dyn, torch.clamp(array_area, min=1e-6))
  leak = _leakage_cols(c) * (1.0 + div(0.9 * density, density + 40.0))
  return dyn * c["var_pwr"] + leak


def _gbuf_power_cols(c, clock) -> torch.Tensor:
  f_hz = clock * 1e6
  gbuf_pj_bit = pe_lib.ENERGY_PJ["gbuf_access_per_bit"] \
      * _sram_access_scale(c, "gbuf")
  dyn = c["sqrt_n_pe"] * _word_bits(c) * gbuf_pj_bit * 0.62 \
      * f_hz * 1e-9
  leak = c["gbuf_kb"] * 8192 * 0.00035 * 1e-3
  return dyn + leak


@dataclasses.dataclass
class BatchCharacterization:
  """Per-row characterization of N design points (device tensors)."""
  clock_mhz: torch.Tensor
  area_mm2: torch.Tensor
  power_mw: torch.Tensor
  latency_s: torch.Tensor
  energy_mj: torch.Tensor
  utilization: torch.Tensor

  def __len__(self) -> int:
    return int(self.clock_mhz.shape[0])


def hw_batch_targets(c) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
  """(clock_mhz, power_mw, area_mm2, leakage_mw): the workload-independent
  half of :func:`characterize_batch`."""
  clock = _clock_cols(c)
  array_area = _array_area_cols(c)
  area = array_area + _gbuf_area_cols(c)
  power = _array_power_cols(c, clock, array_area) + _gbuf_power_cols(c, clock)
  leak = _leakage_cols(c)
  return clock, power, area, leak


def characterize_batch(inputs: Dict[str, torch.Tensor],
                       layers: Sequence[ConvLayer]) -> BatchCharacterization:
  """One characterization per row of an inputs bundle (the tensors of
  :func:`batch_inputs`, on one device)."""
  clock, power, area, leak = hw_batch_targets(inputs)
  latency_s, energy_mj, utilization = simulate_network_batch(
      inputs, layers, clock, leak)
  return BatchCharacterization(
      clock_mhz=clock, area_mm2=area, power_mw=power,
      latency_s=latency_s, energy_mj=energy_mj, utilization=utilization)


# ---------------------------------------------------------------------------
# joint HW x NN characterization: every architecture x every design point
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JointCharacterization:
  """Characterization of ``n_archs x n_hw`` (architecture, HW) pairs.

  Clock / power / area depend only on the hardware and are ``(n_hw,)``;
  the workload-dependent targets are ``(n_archs, n_hw)`` (arch-major,
  the :class:`repro_torch.core.table.JointTable` row order when
  flattened)."""
  clock_mhz: torch.Tensor
  area_mm2: torch.Tensor
  power_mw: torch.Tensor
  latency_s: torch.Tensor
  energy_mj: torch.Tensor
  utilization: torch.Tensor

  @property
  def n_archs(self) -> int:
    return int(self.latency_s.shape[0])

  @property
  def n_hw(self) -> int:
    return int(self.latency_s.shape[1])


def characterize_joint(inputs: Dict[str, torch.Tensor],
                       stack: LayerStack) -> JointCharacterization:
  """One characterization per (architecture, design point) pair, the
  HW-only targets (clock/area/power) once per design point; row ``a`` of
  the workload targets is bit-identical to ``characterize_batch(inputs,
  stack.layers_of(a))``."""
  clock, power, area, leak = hw_batch_targets(inputs)
  latency_s, energy_mj, utilization = simulate_network_stack(
      inputs, stack, clock, leak)
  return JointCharacterization(
      clock_mhz=clock, area_mm2=area, power_mw=power,
      latency_s=latency_s, energy_mj=energy_mj, utilization=utilization)


def characterize_joint_dedup(inputs: Dict[str, torch.Tensor],
                             unique_cols: Dict[str, torch.Tensor],
                             slot_ids: torch.Tensor, valid: torch.Tensor
                             ) -> JointCharacterization:
  """Distinct-layer twin of :func:`characterize_joint`: the same outputs,
  bit for bit, with the dataflow formulas evaluated once per distinct
  layer shape instead of once per (arch, slot) (see
  :func:`repro_torch.core.dataflow.simulate_network_stack_dedup`).  The
  form the joint device path runs."""
  clock, power, area, leak = hw_batch_targets(inputs)
  latency_s, energy_mj, utilization = simulate_network_stack_dedup(
      inputs, unique_cols, slot_ids, valid, clock, leak)
  return JointCharacterization(
      clock_mhz=clock, area_mm2=area, power_mw=power,
      latency_s=latency_s, energy_mj=energy_mj, utilization=utilization)
