"""Synthesis oracle, batched: exact float64 PPA for a whole ConfigTable.

The port of ``repro.core.oracle``'s batch path.  The work splits in two:

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

The result is bit-identical to ``repro.core.oracle.characterize_batch``
on the numpy path.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import pe as pe_lib
from repro_torch.core.dataflow import ConvLayer, simulate_network_batch
from repro_torch.core.exact import div

FIFO_DEPTH = 4
FLOP_BIT_UM2 = 2.0
NOC_GATES_PER_PE = 300
PSUM_AMORTIZE = 3.0
ARRAY_CTRL_GATES = 12_000

# the scratchpads and the global buffer, each with the column holding its
# depth in words: ("sp_if", ...) for the PE scratchpads
SPADS = (("sp_if", "act_bits"), ("sp_fw", "weight_bits"),
         ("sp_ps", "psum_bits"))


# ---------------------------------------------------------------------------
# host half: variation hashes + transcendental columns (numpy)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _name_const(name: str) -> int:
  """Stable 64-bit constant for a salt / PE-type name (one-time hash)."""
  return int.from_bytes(hashlib.sha256(name.encode()).digest()[:8], "little")


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


def _sram_area_um2(bits: torch.Tensor, dec: torch.Tensor,
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
    a = _sram_area_um2(c[sp] * c[bits_col], c[f"dec_{sp}"],
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
  return _sram_area_um2(c["gbuf_kb"] * 1024 * 8, c["dec_gbuf_area"],
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
