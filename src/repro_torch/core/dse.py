"""Design-space exploration — COMPATIBILITY SHIM over
``repro_torch.explore`` (the port of ``repro.core.dse``).

The exploration surface lives in :mod:`repro_torch.explore` (declarative
DesignSpace, OracleBackend/PolynomialBackend, columnar ResultFrame,
ExplorationSession).  This module keeps the old names working as thin
delegations:

  DesignPoint             -> repro_torch.explore.DesignPoint (re-export)
  evaluate_with_oracle    -> OracleBackend().evaluate(...).to_points()
  evaluate_with_models    -> PolynomialBackend(models).evaluate(...)
  pareto_front            -> repro_torch.explore.pareto_mask
  best_int16_reference    -> ResultFrame.reference_index
  normalized_metrics      -> ResultFrame.normalize
  distribution_stats      -> repro_torch.explore.summary_stats
  DesignSpaceExplorer     -> ExplorationSession + PolynomialBackend.fit

The polynomial models evaluate on ``device`` (CUDA unless the caller
asks for another).  New code should import from
:mod:`repro_torch.explore` directly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import ppa as ppa_lib
from repro_torch.core.dataflow import AcceleratorConfig, ConvLayer
from repro_torch.core.pe import PAPER_PE_TYPES
from repro_torch.explore.backend import (DeviceLike, OracleBackend,
                                         PolynomialBackend)
from repro_torch.explore.frame import (DesignPoint, ResultFrame,
                                       pareto_mask, summary_stats)
from repro_torch.explore.session import ExplorationSession
from repro_torch.explore.space import DesignSpace

__all__ = [
    "DesignPoint", "DesignSpaceExplorer", "ExplorationResult",
    "best_int16_reference", "distribution_stats", "evaluate_with_models",
    "evaluate_with_oracle", "normalized_metrics", "pareto_front",
]


def evaluate_with_oracle(cfgs: Sequence[AcceleratorConfig],
                         layers: Sequence[ConvLayer],
                         network: str) -> List[DesignPoint]:
  """Slow path: full characterization per design (synthesis stand-in)."""
  return OracleBackend().evaluate(cfgs, layers, network).to_points()


def evaluate_with_models(models: Dict[str, ppa_lib.PPAModels],
                         cfgs: Sequence[AcceleratorConfig],
                         layers: Sequence[ConvLayer],
                         network: str,
                         device: DeviceLike = None) -> List[DesignPoint]:
  """Fast path: pre-characterized polynomial PPA models (batched)."""
  return PolynomialBackend(models, device=device).evaluate(
      cfgs, layers, network).to_points()


def pareto_front(objectives: np.ndarray) -> np.ndarray:
  """Boolean mask of non-dominated rows; all objectives are MINIMIZED."""
  return pareto_mask(objectives)


def best_int16_reference(points: Sequence[DesignPoint],
                         metric: str = "perf_per_area") -> DesignPoint:
  """The paper's normalization anchor: best INT16 config under `metric`."""
  points = list(points)
  frame = ResultFrame.from_points(points)
  return points[frame.reference_index(metric)]


def normalized_metrics(points: Sequence[DesignPoint],
                       ref: Optional[DesignPoint] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
  """(normalized perf/area, normalized energy) vs best-INT16-perf/area."""
  frame = ResultFrame.from_points(points)
  if ref is None:
    norm = frame.normalize(ref="best-int16")
  else:
    norm = frame.normalize(ref=(ref.perf_per_area, ref.energy_mj))
  return norm.perf_per_area, norm.energy


def distribution_stats(values: np.ndarray) -> Dict[str, float]:
  """Fig. 9 violin summary: min / q1 / median / q3 / max / mean."""
  return summary_stats(values)


# ---------------------------------------------------------------------------
# the explorer (legacy facade)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExplorationResult:
  points: List[DesignPoint]
  seconds_model: float
  seconds_oracle_per_design: float

  @property
  def speedup(self) -> float:
    n = max(len(self.points), 1)
    per_model = self.seconds_model / n
    return self.seconds_oracle_per_design / max(per_model, 1e-12)


class DesignSpaceExplorer:
  """Fit-once / evaluate-many QUIDAM DSE entry point (legacy facade over
  ExplorationSession; fits share the process-wide PolynomialBackend cache)."""

  def __init__(self, pe_types: Sequence[str] = PAPER_PE_TYPES,
               degree: int = 5, n_train: int = 240, seed: int = 0,
               layers: Optional[Sequence[ConvLayer]] = None,
               device: DeviceLike = None):
    self.pe_types = tuple(pe_types)
    self.backend = PolynomialBackend.fit(self.pe_types, degree=degree,
                                         n_train=n_train, layers=layers,
                                         seed=seed, device=device)
    self.session = ExplorationSession(self.backend,
                                      DesignSpace(pe_types=self.pe_types))

  @property
  def models(self) -> Dict[str, ppa_lib.PPAModels]:
    return self.backend.models

  def explore(self, layers: Sequence[ConvLayer], network: str,
              n_per_type: int = 200, seed: int = 17,
              measure_oracle: int = 3) -> ExplorationResult:
    frame = self.session.explore(layers, network, n_per_type=n_per_type,
                                 seed=seed, measure_oracle=measure_oracle)
    return ExplorationResult(
        frame.to_points(), frame.meta["eval_seconds"],
        frame.meta.get("oracle_seconds_per_design", 0.0))
