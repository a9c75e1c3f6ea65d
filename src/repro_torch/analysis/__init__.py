"""repro_torch.analysis: the exactness lint of the PyTorch port.

The port's headline guarantee — the exact sweep, the joint oracle, the
fronts and top-k, the polynomial sum (P1), ``sgd_update`` and AdamW are
bit-identical between the card, the CPU and the reference — rests on
seven forms that ``explore.device.probe_exactness`` finds off numpy's
bits on the card (F1-F7), and on the no-fallback rule (a plain version
runs only for a CPU tensor).  No runtime test can police every sweep;
this package is the AST-level backstop, the port's counterpart of
``repro.analysis``: a rule registry with per-rule codes, inline
suppressions (``# repro: ignore[RULE-ID] reason``, the reference's
marker), a baseline for grandfathered findings (``baseline.json`` beside
this file, the reference's format), and a CLI::

    python -m repro_torch.analysis [paths...] [--format text|json|sarif]
                                   [--baseline FILE|none]

Rule packs (see :mod:`repro_torch.analysis.rules` and README's port
section for the catalog):

  DET*  determinism    — numpy's and torch's global RNGs, unseeded
                         generators, wall-clock reads, set-order
                         iteration, ad-hoc seed arithmetic
  EXA*  exactness      — F1-F7 in the float64 modules (core/oracle,
                         core/dataflow, core/ppa, core/exact,
                         explore/device) and the f32 bit-equal optimizer
  JIT*  graph-purity   — print / global state / host numpy / host syncs
                         in the device programs
  CON*  contract       — kernel packages ship csrc/ + kernel.py + ops.py +
                         ref.py and both tests; streaming reducers keep
                         the fold/result/device_spec surface
  ROB*  robustness     — swallowed errors, unbounded waits, direct device
                         enumeration, fallbacks (the no-fallback rule)

The engine is pure stdlib (ast + json): it imports neither torch nor
numpy, nor the reference package, so it runs on any CPU runner.
"""
from repro_torch.analysis.engine import (Baseline, Finding, Module, Report,
                                         scan_paths)
from repro_torch.analysis.registry import RULES, Rule, register

__all__ = ["Baseline", "Finding", "Module", "Report", "scan_paths",
           "RULES", "Rule", "register"]
