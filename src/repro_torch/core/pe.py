"""QUIDAM processing-element (PE) types and hardware unit inventory.

Mirrors Fig. 3 of the paper: each PE has four FIFOs (ifmap, filter, input
psum, output psum), three scratchpads (ifmap / filter / psum), and an
arithmetic unit that differs per PE type:

  FP32       32b float multiplier + 32b float adder
  INT16      16b integer multiplier + 32b integer adder
  LightPE-1  8b activations x 4b pow2 weights: one shifter  + 24b adder
  LightPE-2  8b activations x 8b (7 used) codes: two shifters + 2 adders

The numbers here parameterize :mod:`repro_torch.core.oracle` (the stand-in for
Synopsys DC + VCS @ FreePDK45).  Gate counts follow standard textbook
estimates (array multiplier ~ n^2 full adders; FP32 mult ~ 24x24 mantissa
array + normalization; barrel shifter ~ n log n muxes); per-op energies are
anchored to Horowitz, "Computing's energy problem" (ISSCC 2014), scaled to
45 nm.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# NAND2-equivalent gate-area at 45nm (FreePDK45 NAND2X1 ~ 0.798 um^2).
GATE_AREA_UM2 = 0.798
# 6T SRAM bit cell at 45nm, with periphery overhead folded into the
# sqrt-term of the CACTI-like model below.
SRAM_BIT_UM2 = 0.57
# Leakage per NAND2-equivalent gate (uW) at 45nm, 25C.
GATE_LEAKAGE_UW = 0.0025
# Dynamic switching energy per gate-toggle (pJ) at 1.0V 45nm, activity ~0.15.
GATE_DYN_PJ = 0.0009

def decoder_levels(words: float) -> int:
  """Address-decoder depth = ceil(log2(words)) — a *step* function of the
  scratchpad size; synthesis area/power/latency jump at power-of-two
  boundaries, which is what makes real PPA surfaces polynomial-hostile."""
  import math
  return max(int(math.ceil(math.log2(max(words, 2.0)))), 1)


def sram_access_scale(words: float) -> float:
  """Per-bit access-energy scale factor vs array depth.

  Bitline/wordline capacitance grows with the array edge (~sqrt of the cell
  count) and each decoder level adds a step; normalized to ~1.0 at 64 words.
  """
  import math
  return (0.47 + 0.45 * math.sqrt(max(words, 1.0) / 64.0)
          + 0.022 * decoder_levels(words))


# Horowitz ISSCC'14 per-op energies (pJ), 45nm:
ENERGY_PJ: Dict[str, float] = {
    "add_int8": 0.03,
    "add_int16": 0.05,
    "add_int24": 0.08,
    "add_int32": 0.1,
    "add_fp32": 0.9,
    "mul_int8": 0.2,
    "mul_int16": 0.8,   # ~quadratic in width between int8 (0.2) and int32 (3.1)
    "mul_fp32": 3.7,
    "shift_8": 0.024,   # 8b barrel shifter ~ comparable to int8 add
    # memory, per 16-bit word unless noted:
    "spad_access_per_bit": 0.006,   # register-file-like small spad
    "gbuf_access_per_bit": 0.025,   # 100KB-class SRAM
    "dram_access_per_bit": 1.3,     # LPDDR
    "fifo_access_per_bit": 0.004,
}


@dataclasses.dataclass(frozen=True)
class PEType:
  """Static description of one QUIDAM PE variant."""
  name: str
  act_bits: int
  weight_bits: int          # storage bits per weight (code width)
  psum_bits: int
  # arithmetic unit inventory -> NAND2-equivalent gates
  arith_gates: int
  # energy per MAC-equivalent (pJ): multiply/shift + accumulate add
  mac_energy_pj: float
  # critical path of the arithmetic unit (ns) -> bounds the clock
  critical_path_ns: float
  # number of power-of-two terms when weights are pow2 codes (0 = integer/fp)
  pow2_terms: int = 0

  @property
  def is_light(self) -> bool:
    return self.pow2_terms > 0


def _mult_gates(n: int) -> int:
  """Array multiplier with partial-product reduction: ~10 NAND2-eq gates
  per bit^2 (n^2 AND + ~n^2 FA at 6 gates + reduction tree wiring)."""
  return 10 * n * n


def _adder_gates(n: int) -> int:
  return 7 * n  # ripple-ish CLA mix, ~7 gates/bit


def _shifter_gates(width: int, stages: int) -> int:
  return 3 * width * stages  # barrel shifter: width muxes per log-stage


def _fp32_mult_gates() -> int:
  # 24x24 mantissa array + exponent add + rounding/normalize
  return _mult_gates(24) + _adder_gates(10) + 900


def _fp32_add_gates() -> int:
  # align shifter + 27b add + LZD + normalize shifter
  return _shifter_gates(27, 5) * 2 + _adder_gates(27) + 700


# --- the four paper PE types (plus INT8/INT4 companions used by the wider
# framework; the paper's Table 1 lists INT4/8/16/FP32 support) -------------

FP32 = PEType(
    name="FP32", act_bits=32, weight_bits=32, psum_bits=32,
    arith_gates=_fp32_mult_gates() + _fp32_add_gates(),
    mac_energy_pj=ENERGY_PJ["mul_fp32"] + ENERGY_PJ["add_fp32"],
    critical_path_ns=3.364,  # calibrated: Table 3 -> 275 MHz nominal
)

INT16 = PEType(
    name="INT16", act_bits=16, weight_bits=16, psum_bits=32,
    arith_gates=_mult_gates(16) + _adder_gates(32),
    mac_energy_pj=ENERGY_PJ["mul_int16"] + ENERGY_PJ["add_int32"],
    critical_path_ns=3.237,  # Table 3 -> 285 MHz
)

INT8 = PEType(
    name="INT8", act_bits=8, weight_bits=8, psum_bits=24,
    arith_gates=_mult_gates(8) + _adder_gates(24),
    mac_energy_pj=ENERGY_PJ["mul_int8"] + ENERGY_PJ["add_int24"],
    critical_path_ns=2.60,
)

INT4 = PEType(
    name="INT4", act_bits=8, weight_bits=4, psum_bits=20,
    arith_gates=_mult_gates(4) + _adder_gates(20),
    mac_energy_pj=0.08 + ENERGY_PJ["add_int24"],
    critical_path_ns=2.40,
)

LIGHTPE1 = PEType(
    name="LightPE-1", act_bits=8, weight_bits=4, psum_bits=24,
    arith_gates=_shifter_gates(16, 3) + _adder_gates(24),
    mac_energy_pj=ENERGY_PJ["shift_8"] + ENERGY_PJ["add_int24"],
    critical_path_ns=1.926,  # shift + accumulate; Table 3 -> 455 MHz
    pow2_terms=1,
)

LIGHTPE2 = PEType(
    name="LightPE-2", act_bits=8, weight_bits=8, psum_bits=24,
    arith_gates=2 * _shifter_gates(16, 3) + 2 * _adder_gates(24),
    mac_energy_pj=2 * ENERGY_PJ["shift_8"] + ENERGY_PJ["add_int24"]
                  + ENERGY_PJ["add_int16"],
    critical_path_ns=2.027,  # two shifts + adder tree; Table 3 -> 435 MHz
    pow2_terms=2,
)

PE_TYPES: Dict[str, PEType] = {
    p.name: p for p in (FP32, INT16, INT8, INT4, LIGHTPE1, LIGHTPE2)
}

# The four the paper's figures sweep:
PAPER_PE_TYPES: Tuple[str, ...] = ("FP32", "INT16", "LightPE-1", "LightPE-2")


def pe_type(name: str) -> PEType:
  try:
    return PE_TYPES[name]
  except KeyError as e:
    raise ValueError(
        f"unknown PE type {name!r}; known: {sorted(PE_TYPES)}") from e
