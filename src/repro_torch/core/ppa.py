"""Quantization-aware polynomial PPA models (paper Sec. 3.3, Eq. 2, Fig. 5).

The port of ``repro.core.ppa``.  A K-degree multivariate polynomial
F(x) = sum_j c_j prod_i x_i^{q_ij}, sum_i q_ij <= K, is fit per PE type:

  power  : x = (SP_if, SP_ps, SP_fw, #PE)                      [4-dim]
  area   : x = (SP_if, SP_ps, SP_fw, #PE)                      [4-dim]
  latency: x = (SP_if, SP_ps, SP_fw, PE_rows, PE_cols, GBS,
                A, C, F, K, S, P [, RS, DS])                    [12(+2)-dim]

Degree is selected with k-fold cross validation comparing MAPE and RMSPE
jointly (Fig. 5; the paper selects degree 5).

The fit stays on the host in numpy, op for op the reference's
(relative-error-weighted ridge regression, ``np.linalg.solve``), on
datasets from the scalar oracle, so the coefficients are byte-equal to
the reference's.  :meth:`PolyModel.predict` is the reference's numpy
prediction too: the fit's own cross validation scores with it.

Evaluating fitted models over many designs is what replaces
characterization, and it runs on a torch device
(:meth:`PolyModel.predict_on`, the ``PPAModels.predict_*`` methods):

  * the features ``xs = x / col_scale`` (through ``exact.div``) and their
    powers are elementwise float64 products in the reference's order, so
    the monomial matrix phi, laid out monomial-major as (m, rows), is
    bit-equal to the reference's on every device;
  * the sum ``sum_j phi_j c_j`` runs in a fixed order, j = 0..m-1, as a
    separate multiply and add per term (no matmul, no FMA), so it gives
    the same bits on the CPU and on a card.  The reference's BLAS
    ``phi @ coef`` sums in an order of its own: per row the two differ by
    at most ``2 gamma_m sum_j |phi_j c_j|`` (``gamma_m = m u / (1 - m u)``,
    ``u = 2^-53``);
  * the raw sums come back to the host, and everything after them (the
    target scale, the log target's ``exp``, the floors, a network's
    per-layer sum) is the reference's numpy.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import oracle
from repro_torch.core.dataflow import (AcceleratorConfig, ConvLayer,
                                       simulate_layer)
from repro_torch.core.exact import div

Device = Union[str, torch.device]


# ---------------------------------------------------------------------------
# polynomial feature expansion
# ---------------------------------------------------------------------------

def monomial_exponents(n_features: int, degree: int,
                       max_vars: Optional[int] = None) -> np.ndarray:
  """All exponent vectors q with sum(q) <= degree (incl. the constant term).

  max_vars caps the number of distinct variables per monomial — used for
  the 12/14-feature latency model, where the full degree-5 basis (6k+
  monomials) is statistically and numerically untenable.
  """
  rows: List[Tuple[int, ...]] = []
  for total in range(degree + 1):
    for combo in itertools.combinations_with_replacement(
        range(n_features), total):
      q = [0] * n_features
      for i in combo:
        q[i] += 1
      if max_vars is not None and sum(1 for v in q if v > 0) > max_vars:
        continue
      rows.append(tuple(q))
  uniq = sorted(set(rows))
  return np.asarray(uniq, dtype=np.int32)


def poly_features(x: np.ndarray, exponents: np.ndarray,
                  col_scale: np.ndarray) -> np.ndarray:
  """Feature matrix Phi[n, m] = prod_i (x[n, i]/s_i)^{q[m, i]} (numpy)."""
  xs = x / col_scale
  n, d = xs.shape
  m = exponents.shape[0]
  # precompute powers[p, :, i] then gather per monomial column
  max_deg = int(exponents.max()) if exponents.size else 0
  powers = np.ones((max_deg + 1, n, d), dtype=np.float64)
  for p in range(1, max_deg + 1):
    powers[p] = powers[p - 1] * xs
  out = np.ones((n, m), dtype=np.float64)
  for i in range(d):
    qi = exponents[:, i]
    active = qi > 0
    if np.any(active):
      out[:, active] *= powers[qi[active], :, i].T
  return out


def poly_features_t(x: torch.Tensor, exponents: np.ndarray,
                    col_scale: torch.Tensor) -> torch.Tensor:
  """Monomial-major feature matrix phi[m, n] on ``x``'s device: the
  transpose of :func:`poly_features`, bit for bit (the same correctly
  rounded quotients and products, in the same order)."""
  xs = div(x.T, col_scale[:, None])  # (d, n): each feature contiguous
  d, n = xs.shape
  m = exponents.shape[0]
  max_deg = int(exponents.max()) if exponents.size else 0
  powers = [torch.ones_like(xs)]
  for _ in range(max_deg):
    powers.append(powers[-1] * xs)
  powers = torch.stack(powers)  # (max_deg + 1, d, n)
  out = torch.ones((m, n), dtype=torch.float64, device=x.device)
  for i in range(d):
    active = np.flatnonzero(exponents[:, i] > 0)
    if active.size:
      rows = torch.as_tensor(active, device=x.device)
      deg = torch.as_tensor(exponents[active, i].astype(np.int64),
                            device=x.device)
      out[rows] = out[rows] * powers[deg, i]
  return out


def poly_sum(phi: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
  """``sum_j phi[j] * coef[j]`` in the fixed order j = 0..m-1, one
  rounded multiply and one rounded add per term: the same bits on every
  device (a matmul, ``addcmul`` or a compiled kernel would sum in an
  order, or contract into FMAs, of its own)."""
  acc = torch.zeros(phi.shape[1], dtype=torch.float64, device=phi.device)
  for j in range(phi.shape[0]):
    acc = acc + phi[j] * coef[j]
  return acc


# ---------------------------------------------------------------------------
# metrics (paper's model-selection criteria)
# ---------------------------------------------------------------------------

def mape(y_true: np.ndarray, y_pred: np.ndarray) -> float:
  denom = np.maximum(np.abs(y_true), 1e-30)
  return float(np.mean(np.abs((y_pred - y_true) / denom)) * 100.0)


def rmspe(y_true: np.ndarray, y_pred: np.ndarray) -> float:
  denom = np.maximum(np.abs(y_true), 1e-30)
  return float(np.sqrt(np.mean(((y_pred - y_true) / denom) ** 2)) * 100.0)


def r2(y_true: np.ndarray, y_pred: np.ndarray) -> float:
  ss_res = float(np.sum((y_true - y_pred) ** 2))
  ss_tot = float(np.sum((y_true - np.mean(y_true)) ** 2))
  return 1.0 - ss_res / max(ss_tot, 1e-30)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PolyModel:
  degree: int
  exponents: np.ndarray
  col_scale: np.ndarray
  coef: np.ndarray
  y_scale: float
  log_target: bool = False

  def finish(self, raw: np.ndarray) -> np.ndarray:
    """Raw polynomial sums -> target units (host numpy, as the
    reference)."""
    if self.log_target:
      return np.exp(np.clip(raw, -60.0, 60.0)) * self.y_scale
    return raw * self.y_scale

  def predict(self, x: np.ndarray) -> np.ndarray:
    """Host numpy prediction, the reference's (``phi @ coef``): the
    fit's cross validation scores with it."""
    phi = poly_features(np.asarray(x, np.float64), self.exponents,
                        self.col_scale)
    return self.finish(phi @ self.coef)

  def raw_on(self, x: torch.Tensor) -> torch.Tensor:
    """Raw sums ``sum_j phi_j c_j`` for the float64 rows of ``x``, on
    ``x``'s device (fixed-order sum, :func:`poly_sum`)."""
    scale = torch.as_tensor(self.col_scale, dtype=torch.float64,
                            device=x.device)
    coef = torch.as_tensor(self.coef, dtype=torch.float64, device=x.device)
    return poly_sum(poly_features_t(x, self.exponents, scale), coef)

  def predict_on(self, x: np.ndarray, device: Device) -> np.ndarray:
    """:meth:`predict` with the features and the sum on ``device``."""
    xt = torch.as_tensor(np.asarray(x, np.float64), device=device)
    return self.finish(self.raw_on(xt).cpu().numpy())


def fit_poly(x: np.ndarray, y: np.ndarray, degree: int,
             max_vars: Optional[int] = None,
             ridge: float = 1e-8, log_target: bool = False) -> PolyModel:
  """Ridge fit of a degree-K polynomial.

  log_target=True fits log(y) (used for latency, whose dynamic range
  spans 4+ orders of magnitude across layers).  Raw fits are
  relative-error weighted so MAPE/RMSPE are the effective training
  criteria.
  """
  x = np.asarray(x, np.float64)
  y = np.asarray(y, np.float64)
  col_scale = np.maximum(np.max(np.abs(x), axis=0), 1e-12)
  exps = monomial_exponents(x.shape[1], degree, max_vars)
  phi = poly_features(x, exps, col_scale)
  if log_target:
    y_scale = float(np.maximum(np.exp(np.mean(np.log(np.maximum(y, 1e-30)))),
                               1e-30))
    t = np.log(np.maximum(y, 1e-30) / y_scale)
    w = np.ones_like(t)
  else:
    y_scale = float(np.maximum(np.mean(np.abs(y)), 1e-30))
    t = y / y_scale
    # minimize sum_n w_n (phi_n c - t_n)^2 with w ~ 1/t (relative error)
    w = 1.0 / np.maximum(np.abs(t), 1e-3)
  tw = t * w
  phiw = phi * w[:, None]
  gram = phiw.T @ phiw
  gram[np.diag_indices_from(gram)] += ridge * np.trace(gram) / gram.shape[0]
  coef = np.linalg.solve(gram, phiw.T @ tw)
  return PolyModel(degree, exps, col_scale, coef, y_scale, log_target)


def kfold_cv(x: np.ndarray, y: np.ndarray, degree: int, k: int = 5,
             max_vars: Optional[int] = None, seed: int = 0,
             log_target: bool = False) -> Tuple[float, float]:
  """k-fold CV -> (MAPE, RMSPE), the joint criteria of Fig. 5."""
  rng = np.random.RandomState(seed)
  n = x.shape[0]
  idx = rng.permutation(n)
  folds = np.array_split(idx, k)
  mapes, rmspes = [], []
  for f in range(k):
    test = folds[f]
    train = np.concatenate([folds[g] for g in range(k) if g != f])
    model = fit_poly(x[train], y[train], degree, max_vars,
                     log_target=log_target)
    pred = model.predict(x[test])
    mapes.append(mape(y[test], pred))
    rmspes.append(rmspe(y[test], pred))
  return float(np.mean(mapes)), float(np.mean(rmspes))


def select_degree(x: np.ndarray, y: np.ndarray,
                  degrees: Sequence[int] = tuple(range(1, 9)),
                  k: int = 5, max_vars: Optional[int] = None,
                  seed: int = 0, log_target: bool = False
                  ) -> Tuple[int, Dict[int, Tuple[float, float]]]:
  """Sweep degrees, return (best_degree, {degree: (MAPE, RMSPE)})."""
  scores: Dict[int, Tuple[float, float]] = {}
  for d in degrees:
    scores[d] = kfold_cv(x, y, d, k=k, max_vars=max_vars, seed=seed,
                         log_target=log_target)
  # joint criterion: both metrics low -> minimize MAPE + RMSPE
  best = min(scores, key=lambda d: scores[d][0] + scores[d][1])
  return best, scores


# ---------------------------------------------------------------------------
# datasets (characterize designs with the scalar synthesis oracle)
# ---------------------------------------------------------------------------

# DSE sampling ranges (Sec. 3.3: "vary global buffer size, #PE per row and
# column, bit precision, PE type, and individual scratchpad sizes").
HW_RANGES = {
    "pe_rows": (8, 10, 12, 14, 16, 20, 24, 28, 32),
    "pe_cols": (8, 10, 12, 14, 16, 20, 24, 28, 32),
    "sp_if": (6, 8, 12, 16, 24, 32, 48, 64),
    "sp_fw": (64, 96, 128, 160, 224, 288, 352, 448),
    "sp_ps": (8, 12, 16, 24, 32, 48, 64),
    "gbuf_kb": (64, 96, 128, 192, 256, 384, 512),
    "bandwidth_gbps": (6.4, 12.8, 25.6),
}


def sample_configs(pe_type: str, n: int, seed: int = 0
                   ) -> List[AcceleratorConfig]:
  rng = np.random.RandomState(seed)
  cfgs = []
  for _ in range(n):
    cfgs.append(AcceleratorConfig(
        pe_type=pe_type,
        pe_rows=int(rng.choice(HW_RANGES["pe_rows"])),
        pe_cols=int(rng.choice(HW_RANGES["pe_cols"])),
        sp_if=int(rng.choice(HW_RANGES["sp_if"])),
        sp_fw=int(rng.choice(HW_RANGES["sp_fw"])),
        sp_ps=int(rng.choice(HW_RANGES["sp_ps"])),
        gbuf_kb=int(rng.choice(HW_RANGES["gbuf_kb"])),
        bandwidth_gbps=float(rng.choice(HW_RANGES["bandwidth_gbps"])),
    ))
  return cfgs


def hw_feature_matrix(cfgs) -> np.ndarray:
  """(N, 4) power/area features from a config sequence or a ConfigTable."""
  if hasattr(cfgs, "hw_features"):  # ConfigTable
    return cfgs.hw_features()
  return np.asarray([c.hw_features() for c in cfgs], np.float64)


def power_area_dataset(cfgs: Sequence[AcceleratorConfig]
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """(X[4], array power mW, array area mm2) via the scalar oracle.

  Targets are the PE-array subsystem: the 4-feature vector cannot see
  GBS, so the global buffer composes separately as a closed-form SRAM
  macro (oracle.gbuf_power_mw / gbuf_area_mm2)."""
  x = hw_feature_matrix(cfgs)
  p = np.asarray([oracle.array_power_mw(c) for c in cfgs])
  a = np.asarray([oracle.array_area_mm2(c) for c in cfgs])
  return x, p, a


def latency_feature_row(cfg: AcceleratorConfig, layer: ConvLayer
                        ) -> Tuple[float, ...]:
  return cfg.latency_hw_features() + layer.features()


def latency_dataset(cfgs: Sequence[AcceleratorConfig],
                    layers: Sequence[ConvLayer]
                    ) -> Tuple[np.ndarray, np.ndarray]:
  """Layer-level (X[14], latency_s) pairs — the paper's training
  granularity."""
  rows, ys = [], []
  for cfg in cfgs:
    clk = oracle.clock_mhz(cfg)
    for layer in layers:
      st = simulate_layer(cfg, layer, clk)
      rows.append(latency_feature_row(cfg, layer))
      ys.append(st.cycles / (clk * 1e6))
  return np.asarray(rows, np.float64), np.asarray(ys, np.float64)


# ---------------------------------------------------------------------------
# per-PE-type PPA model bundle
# ---------------------------------------------------------------------------

LATENCY_MAX_VARS = 2   # basis pruning for the 14-feature latency model
LATENCY_DEGREE = 4     # CV-selected on held-out layers (deg-4/mv-2
                       # minimizes MAPE+RMSPE)


@dataclasses.dataclass
class PPAModels:
  """Power/area/latency polynomial models for one PE type (one model set
  per PE type; Sec. 3.3).  Predictions evaluate on ``device``."""
  pe_type: str
  degree: int
  power: PolyModel
  area: PolyModel
  latency: PolyModel

  def predict_power_mw(self, cfgs, device: Device) -> np.ndarray:
    """Configs sequence or ConfigTable -> array-PE-subsystem power (mW)."""
    return self.power.predict_on(hw_feature_matrix(cfgs), device)

  def predict_area_mm2(self, cfgs, device: Device) -> np.ndarray:
    """Configs sequence or ConfigTable -> array-PE-subsystem area (mm^2)."""
    return self.area.predict_on(hw_feature_matrix(cfgs), device)

  def predict_network_latency_s(self, cfgs, layers: Sequence[ConvLayer],
                                device: Device) -> np.ndarray:
    """Sum of per-layer latency predictions (layer-level strategy); accepts
    a config sequence or a ConfigTable."""
    if hasattr(cfgs, "latency_hw_features"):  # ConfigTable
      hw = cfgs.latency_hw_features()
    else:
      hw = np.asarray([c.latency_hw_features() for c in cfgs], np.float64)
    lf = np.asarray([l.features() for l in layers], np.float64)
    return self.predict_network_latency_feats(hw, lf, device)

  def predict_network_latency_feats(self, hw: np.ndarray, lf: np.ndarray,
                                    device: Device) -> np.ndarray:
    """Network latency from feature matrices: ``hw`` is (n_cfgs, 6)
    latency hardware features, ``lf`` is (n_layers, 8) layer features.
    The (config, layer) rows are tiled on ``device`` in the reference's
    order (config-major); the per-network sum is numpy's, on the host."""
    n_c, n_l = hw.shape[0], lf.shape[0]
    hw_t = torch.as_tensor(np.asarray(hw, np.float64), device=device)
    lf_t = torch.as_tensor(np.asarray(lf, np.float64), device=device)
    rows = torch.cat([hw_t.repeat_interleave(n_l, dim=0),
                      lf_t.repeat(n_c, 1)], dim=1)
    raw = self.latency.raw_on(rows).cpu().numpy()
    pred = np.maximum(self.latency.finish(raw), 1e-12)
    return pred.reshape(n_c, n_l).sum(axis=1)


def fit_ppa_models(pe_type: str, degree: int = 5, n_train: int = 300,
                   layers: Optional[Sequence[ConvLayer]] = None,
                   seed: int = 0) -> PPAModels:
  """Characterize n_train sampled designs with the scalar oracle and fit
  the models (host numpy)."""
  cfgs = sample_configs(pe_type, n_train, seed=seed)
  x, p, a = power_area_dataset(cfgs)
  power = fit_poly(x, p, degree)
  area = fit_poly(x, a, degree)
  if layers is None:
    from repro_torch.core.workloads import get_network
    layers = get_network("resnet20") + get_network("vgg16")
  # fewer configs for the (config x layer) latency dataset
  lat_cfgs = cfgs[: max(150, n_train // 2)]
  lx, ly = latency_dataset(lat_cfgs, layers)
  latency = fit_poly(lx, ly, min(degree, LATENCY_DEGREE),
                     max_vars=LATENCY_MAX_VARS, log_target=True)
  return PPAModels(pe_type, degree, power, area, latency)
