"""HW x NN co-exploration — COMPATIBILITY SHIM over
``repro_torch.explore`` (the port of ``repro.core.coexplore``).

The joint exploration of the paper's Sec. 4.5 / Fig. 12 runs through
:meth:`repro_torch.explore.ExplorationSession.co_explore`.  This module
keeps the old list-of-CoPoint API: :func:`co_explore` scores sampled HW
x the given architectures through the polynomial models (on ``device``,
CUDA unless the caller asks for another), and
:func:`normalize_and_front` is Fig. 12's processing.  Frames use the
coded-architecture form (integer ``arch_id`` column + ``arch_lookup``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core import ppa as ppa_lib
from repro_torch.core.cnn import ArchChoice
from repro_torch.core.dataflow import AcceleratorConfig
from repro_torch.core.pe import PAPER_PE_TYPES
from repro_torch.explore.backend import DeviceLike, PolynomialBackend
from repro_torch.explore.frame import ResultFrame, pareto_mask
from repro_torch.explore.session import ExplorationSession
from repro_torch.explore.space import DesignSpace

__all__ = ["CoPoint", "co_explore", "normalize_and_front"]


@dataclasses.dataclass
class CoPoint:
  """One (hardware, architecture) pair in the joint space."""
  cfg: AcceleratorConfig
  arch: ArchChoice
  top1: float
  latency_s: float
  power_mw: float
  area_mm2: float

  @property
  def energy_mj(self) -> float:
    return self.power_mw * self.latency_s

  @property
  def top1_err(self) -> float:
    return 1.0 - self.top1


def _to_frame(points: Sequence[CoPoint]) -> ResultFrame:
  """CoPoint list -> coded-arch ResultFrame (integer ``arch_id`` column +
  shared ``arch_lookup``)."""
  pts = list(points)
  lookup: List[ArchChoice] = []
  index: Dict[ArchChoice, int] = {}
  ids = np.empty(len(pts), np.int64)
  for i, p in enumerate(pts):
    if p.arch not in index:
      index[p.arch] = len(lookup)
      lookup.append(p.arch)
    ids[i] = index[p.arch]
  return ResultFrame(
      latency_s=np.asarray([p.latency_s for p in pts]),
      power_mw=np.asarray([p.power_mw for p in pts]),
      area_mm2=np.asarray([p.area_mm2 for p in pts]),
      pe_type=np.asarray([p.cfg.pe_type for p in pts]),
      cfgs=tuple(p.cfg for p in pts), network="coexplore",
      extra={"top1": np.asarray([p.top1 for p in pts], np.float64),
             "arch_id": ids},
      arch_lookup=tuple(lookup))


def co_explore(models: Dict[str, ppa_lib.PPAModels],
               arch_accs: Sequence[Tuple[ArchChoice, float]],
               n_hw_per_type: int = 20, seed: int = 3,
               image_size: int = 32,
               pe_types: Sequence[str] = PAPER_PE_TYPES,
               device: DeviceLike = None) -> List[CoPoint]:
  """Random HW samples x evaluated archs -> joint design points."""
  session = ExplorationSession(PolynomialBackend(models, device=device),
                               DesignSpace(pe_types=tuple(pe_types)))
  frame = session.co_explore(arch_accs, n_hw_per_type=n_hw_per_type,
                             seed=seed, image_size=image_size,
                             vectorized=False)
  lookup = frame.arch_lookup
  return [CoPoint(cfg, lookup[int(aid)], float(t1), float(l), float(p),
                  float(a))
          for cfg, aid, t1, l, p, a in zip(
              frame.cfgs, frame.extra["arch_id"], frame.extra["top1"],
              frame.latency_s, frame.power_mw, frame.area_mm2)]


def normalize_and_front(points: Sequence[CoPoint]
                        ) -> Dict[str, np.ndarray]:
  """Fig. 12 processing: normalize energy/area to the min-energy/min-area
  INT16 pair; Pareto front on (top1_err, energy) and (top1_err, area)."""
  frame = _to_frame(points)
  e_ref = float(frame.energy_mj[frame.reference_index("energy")])
  a_ref = float(frame.area_mm2[frame.reference_index("area")])
  err = frame.column("top1_err")
  energy = frame.energy_mj / e_ref
  area = frame.area_mm2 / a_ref
  front_e = pareto_mask(np.stack([err, energy], axis=1))
  front_a = pareto_mask(np.stack([err, area], axis=1))
  return {"err": err, "energy": energy, "area": area,
          "types": frame.pe_type, "front_energy": front_e,
          "front_area": front_a}
