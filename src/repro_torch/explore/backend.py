"""Evaluation backends: how a design point gets its PPA numbers.

The port of ``repro.explore.backend``:

  OracleBackend        slow, exact: the scalar synthesis stand-in
                       (``oracle.characterize``), one host Python call
                       per design point
  TorchOracleBackend   the same oracle array-at-a-time on a torch device
                       (the port of ``VectorOracleBackend``'s device
                       path): each chunk's inputs are built on the host
                       (:func:`oracle.batch_inputs`), packed into one
                       pinned buffer and copied to the device without
                       blocking; the formulas and the fused reduction run
                       eagerly in float64 there.  Bit-identical to the
                       reference's numpy batch path on every device that
                       passes :func:`repro_torch.explore.device.ensure_exact`;
                       co-exploration (``co_evaluate_table``) runs the
                       distinct-layer joint oracle the same way
  PolynomialBackend    fast: QUIDAM's fit-once / evaluate-many polynomial
                       models (:mod:`repro_torch.core.ppa`), fitted on the
                       host, memoized in-process, saved and loaded in the
                       reference's ``.npz`` format, evaluated on a device

All compose the global buffer the same way: the polynomial targets cover
the PE-array subsystem only (the paper's 4-feature vector cannot see
GBS), so the buffer adds on as a pre-characterized SRAM macro via
:func:`gbuf_overheads` (memoized, scalar) / :func:`gbuf_overheads_table`
(the batch formulas, on a device).

The device backends run on CUDA unless the caller asks for another
device; they never move to the CPU on their own.  Inside a fleet pin
(:func:`repro_torch.explore.fleet.pin`) a :class:`TorchOracleBackend`
places, launches and records its chunk on the pinned device instead of
its own, on that device's current stream.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import os
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import oracle
from repro_torch.core import ppa as ppa_lib
from repro_torch.core.dataflow import AcceleratorConfig, ConvLayer, LayerStack
from repro_torch.core.pe import PAPER_PE_TYPES
from repro_torch.core.table import ConfigTable
from repro_torch.explore import device as device_lib
from repro_torch.explore import fleet
from repro_torch.explore.frame import ResultFrame

try:  # Protocol is typing-only
  from typing import Protocol
except ImportError:  # pragma: no cover - py<3.8
  Protocol = object  # type: ignore[assignment]

Configs = Union[Sequence[AcceleratorConfig], ConfigTable]
DeviceLike = Optional[Union[str, torch.device]]


class EvaluationBackend(Protocol):
  """Anything that turns (configs, workload) into a ResultFrame.

  ``cfgs`` may be a sequence of per-point dataclasses or a columnar
  :class:`ConfigTable`.  Backends that implement the optional
  ``evaluate_table(table, layers, network)`` method (and advertise
  ``prefers_table = True``) get handed ConfigTables directly by
  :class:`~repro_torch.explore.ExplorationSession`, keeping
  million-point sweeps columnar end to end.
  """
  name: str

  def evaluate(self, cfgs: Configs, layers: Sequence[ConvLayer],
               network: str = "net") -> ResultFrame:
    ...


def resolve_device(device: DeviceLike, owner: str) -> torch.device:
  """``device``, or CUDA when it is None; raises when that is CUDA and
  there is no card (never drops to the CPU)."""
  dev = torch.device("cuda" if device is None else device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(f"{owner} runs on CUDA by default and no CUDA device "
                       "is available; pass device='cpu' to run on the CPU")
  return dev


def place_inputs(inputs: Dict[str, np.ndarray], device: torch.device
                 ) -> Dict[str, torch.Tensor]:
  """One (columns, rows) float64 buffer holding every input column, on
  ``device``; returns per-column row views of it."""
  keys = sorted(inputs)
  n = len(next(iter(inputs.values())))
  # pinned on CUDA: the copy then runs without blocking the host, and the
  # caching allocator keeps the buffer until the copy is done
  pinned = device.type == "cuda"
  host = torch.empty((len(keys), n), dtype=torch.float64, pin_memory=pinned)
  packed = host.numpy()
  for i, k in enumerate(keys):
    packed[i] = inputs[k]
  on_device = host.to(device, non_blocking=True) if pinned else host
  return {k: on_device[i] for i, k in enumerate(keys)}


# ---------------------------------------------------------------------------
# shared global-buffer composition
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=65536)
def _gbuf_cached(cfg: AcceleratorConfig) -> Tuple[float, float]:
  return oracle.gbuf_power_mw(cfg), oracle.gbuf_area_mm2(cfg)


def gbuf_overheads(cfgs: Configs, device: DeviceLike = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
  """(power_mw, area_mm2) of the global-buffer SRAM macro per config:
  memoized scalar oracle calls for a config sequence, the batch formulas
  on ``device`` for a ConfigTable."""
  if isinstance(cfgs, ConfigTable):
    return gbuf_overheads_table(cfgs, device)
  pwr = np.empty(len(cfgs))
  area = np.empty(len(cfgs))
  for i, c in enumerate(cfgs):
    pwr[i], area[i] = _gbuf_cached(c)
  return pwr, area


def gbuf_overheads_table(table: ConfigTable, device: DeviceLike = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
  """:func:`gbuf_overheads` over a ConfigTable: the batch oracle's global
  buffer formulas on ``device`` (CUDA by default), bit-identical to the
  reference's numpy batch path."""
  dev = resolve_device(device, "gbuf_overheads_table")
  c = place_inputs(oracle.batch_inputs(table), dev)
  pwr = oracle._gbuf_power_cols(c, oracle._clock_cols(c))
  area = oracle._gbuf_area_cols(c)
  return pwr.cpu().numpy(), area.cpu().numpy()


# ---------------------------------------------------------------------------
# oracle backends (exact): scalar loop + the device sibling
# ---------------------------------------------------------------------------

class OracleBackend:
  """Full characterization per design — the synthesis stand-in (host)."""
  name = "oracle"

  def evaluate(self, cfgs: Configs, layers: Sequence[ConvLayer],
               network: str = "net") -> ResultFrame:
    cfgs = list(cfgs)
    lat = np.empty(len(cfgs))
    pwr = np.empty(len(cfgs))
    area = np.empty(len(cfgs))
    for i, cfg in enumerate(cfgs):
      ch = oracle.characterize(cfg, layers)
      lat[i], pwr[i], area[i] = ch.latency_s, ch.power_mw, ch.area_mm2
    return ResultFrame(lat, pwr, area,
                       np.asarray([c.pe_type for c in cfgs]),
                       tuple(cfgs), network)


class TorchOracleBackend:
  """The synthesis stand-in, array-at-a-time over ConfigTables, on one
  torch device (``"cuda"`` by default; tests pass ``device="cpu"``)."""
  name = "torch-oracle"
  prefers_table = True

  def __init__(self, chunk_size: int = 65536,
               device: Optional[Union[str, torch.device]] = None):
    if chunk_size <= 0:
      raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    self.device = resolve_device(device, "TorchOracleBackend")
    self.chunk_size = chunk_size
    device_lib.ensure_exact(self.device)

  def target(self) -> torch.device:
    """Where this thread's dispatches go: the fleet's pin when one is
    set (checked for exactness once per device), else the backend's own
    device."""
    pinned = fleet.pinned_device()
    if pinned is None:
      return self.device
    dev = torch.device(pinned)
    device_lib.ensure_exact(dev)
    return dev

  @contextlib.contextmanager
  def _on_target(self):
    """Run a dispatch on :meth:`target`: under ``torch.cuda.device`` for
    a CUDA target, so launches and recorded events use that device's
    current stream."""
    dev = self.target()
    if dev.type != "cuda":
      yield dev
      return
    with torch.cuda.device(dev):
      yield dev

  def _place(self, inputs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return place_inputs(inputs, self.target())

  def _dispatch(self, table: ConfigTable, layers: Sequence[ConvLayer],
                plan=None):
    run = device_lib.make_eval_fn(tuple(layers), plan)
    return run(self._place(oracle.batch_inputs(table)))

  def place_dedup(self, dedup: Tuple[Dict[str, np.ndarray], np.ndarray]
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """A :meth:`LayerStack.dedup_slots` factorization on :meth:`target`
    (unique columns float64, slot ids int64); tensors already there pass
    through, tensors on another device are copied over."""
    dev = self.target()
    unique_cols, slot_ids = dedup
    if isinstance(slot_ids, torch.Tensor):
      here = slot_ids.device
      if here.type == dev.type and dev.index in (None, here.index):
        return unique_cols, slot_ids
      return ({k: v.to(dev) for k, v in unique_cols.items()},
              slot_ids.to(dev))
    return ({k: device_lib.h2d(v, dev) for k, v in unique_cols.items()},
            device_lib.h2d(slot_ids.astype(np.int64), dev))

  def _co_dispatch(self, hw: ConfigTable, stack: LayerStack, dedup=None,
                   plan=None, accs: Optional[np.ndarray] = None):
    """The joint program on one block: every arch of ``stack`` x every
    row of ``hw``.  ``dedup`` is the block's distinct-layer
    factorization, on the host or a device (default: the stack's
    own)."""
    dev = self.target()
    unique_cols, slot_ids = self.place_dedup(
        stack.dedup_slots() if dedup is None else dedup)
    valid = device_lib.h2d(stack.valid, dev)
    accs_t = None if accs is None else device_lib.h2d(
        np.asarray(accs, np.float64), dev)
    run = device_lib.make_joint_fn(plan)
    return run(self._place(oracle.batch_inputs(hw)), unique_cols, slot_ids,
               valid, accs_t)

  # -- one-shot evaluation ----------------------------------------------------

  def evaluate(self, cfgs: Configs, layers: Sequence[ConvLayer],
               network: str = "net") -> ResultFrame:
    """Config lists are converted to a table; the frame keeps whichever
    design-point representation came in."""
    if isinstance(cfgs, ConfigTable):
      return self.evaluate_table(cfgs, layers, network)
    cfgs = list(cfgs)
    frame = self.evaluate_table(ConfigTable.from_configs(cfgs), layers,
                                network)
    frame.cfgs = tuple(cfgs)
    return frame

  def evaluate_table(self, table: ConfigTable, layers: Sequence[ConvLayer],
                     network: str = "net") -> ResultFrame:
    n = len(table)
    lat = np.empty(n)
    pwr = np.empty(n)
    area = np.empty(n)
    lo = 0
    with self._on_target():
      for chunk in table.chunks(self.chunk_size):
        l, p, a = (t.cpu().numpy() for t in self._dispatch(chunk, layers))
        hi = lo + len(chunk)
        lat[lo:hi], pwr[lo:hi], area[lo:hi] = l, p, a
        lo = hi
    return ResultFrame(lat, pwr, area, table.pe_type_strings(), (),
                       network, table=table)

  def co_evaluate_table(self, hw: ConfigTable, stack: LayerStack,
                        network: str = "coexplore") -> ResultFrame:
    """Joint HW x NN sweep: every stack architecture against every HW row,
    through the distinct-layer joint oracle in HW chunks of
    ``chunk_size // n_archs`` rows; clock/power/area once per HW row,
    latency/energy once per pair.  Returns the arch-major joint frame
    (row ``a * n_hw + h``) with a lazy JointTable and an ``arch_id``
    extra column (the caller attaches ``top1`` and ``arch_lookup``)."""
    n_hw, n_archs = len(hw), stack.n_archs
    lat = np.empty((n_archs, n_hw))
    pwr = np.empty(n_hw)
    area = np.empty(n_hw)
    hw_chunk = max(1, self.chunk_size // max(n_archs, 1))
    with self._on_target():
      dedup = self.place_dedup(stack.dedup_slots())
      lo = 0
      for chunk in hw.chunks(hw_chunk):
        l, p, a = (t.cpu().numpy()
                   for t in self._co_dispatch(chunk, stack, dedup))
        hi = lo + len(chunk)
        lat[:, lo:hi], pwr[lo:hi], area[lo:hi] = l, p, a
        lo = hi
    joint = hw.cross(n_archs)
    return ResultFrame(
        lat.reshape(-1), np.tile(pwr, n_archs), np.tile(area, n_archs),
        joint.pe_type_strings(), (), network, table=joint,
        extra={"arch_id": joint.arch_ids()})

  # -- streaming entry points: asynchronous dispatch --------------------------

  def eval_pending(self, table: ConfigTable, layers: Sequence[ConvLayer],
                   network: str, idx: np.ndarray) -> device_lib.PendingFrame:
    """Dispatch one streaming chunk; resolves to (frame, idx)."""
    with self._on_target():
      return device_lib.PendingFrame(self._dispatch(table, layers), table,
                                     idx, network)

  def fused_eval_pending(self, table: ConfigTable,
                         layers: Sequence[ConvLayer], network: str,
                         plan: device_lib.DevicePlan,
                         idx: np.ndarray) -> device_lib.PendingFused:
    """Dispatch one fused evaluate+reduce chunk; resolves to per-reducer
    payloads with O(survivors) device->host transfer."""
    with self._on_target():
      return device_lib.PendingFused(self._dispatch(table, layers, plan),
                                     plan, table, idx, network)

  def co_eval_pending(self, hw: ConfigTable, stack: LayerStack, network: str,
                      idx: np.ndarray, arch_lo: int, accs: np.ndarray,
                      arch_lookup: Tuple[object, ...],
                      dedup=None) -> device_lib.PendingFrame:
    """Joint twin of :meth:`eval_pending`: resolves to the block's joint
    frame with its ``arch_id``/``top1`` columns."""
    with self._on_target():
      return device_lib.PendingFrame(
          self._co_dispatch(hw, stack, dedup), hw, idx, network,
          arch_lo=arch_lo, accs=np.asarray(accs, np.float64),
          arch_lookup=arch_lookup)

  def fused_co_eval_pending(self, hw: ConfigTable, stack: LayerStack,
                            network: str, plan: device_lib.DevicePlan,
                            idx: np.ndarray, arch_lo: int, accs: np.ndarray,
                            arch_lookup: Tuple[object, ...],
                            dedup=None) -> device_lib.PendingFused:
    """Joint twin of :meth:`fused_eval_pending`."""
    accs = np.asarray(accs, np.float64)
    with self._on_target():
      return device_lib.PendingFused(
          self._co_dispatch(hw, stack, dedup, plan, accs), plan, hw, idx,
          network, n_hw=len(hw), arch_lo=arch_lo, accs=accs,
          arch_lookup=arch_lookup)


# ---------------------------------------------------------------------------
# polynomial backend (fast, fit-once)
# ---------------------------------------------------------------------------

def _layers_fingerprint(layers: Optional[Sequence[ConvLayer]]) -> str:
  if layers is None:
    return "default-workloads"
  blob = repr(tuple((l.name, l.features()) for l in layers))
  return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _fit_key(pe_types: Tuple[str, ...], degree: int, n_train: int,
             seed: int, layers: Optional[Sequence[ConvLayer]]
             ) -> Tuple[str, ...]:
  # oracle.ORACLE_VERSION is part of the fingerprint: a cache fitted
  # against older oracle outputs must refit, not silently load
  return (",".join(pe_types), str(degree), str(n_train), str(seed),
          _layers_fingerprint(layers), f"oracle-v{oracle.ORACLE_VERSION}")


# in-process fit-once cache: identical fit requests share one model bundle
_FIT_CACHE: Dict[Tuple[str, ...], Dict[str, ppa_lib.PPAModels]] = {}

_TARGETS = ("power", "area", "latency")
_FORMAT_VERSION = 1


class PolynomialBackend:
  """QUIDAM's 3-4-orders-of-magnitude fast path over the PPA models.

  Fits run on the host (numpy; coefficients byte-equal to the
  reference's) and evaluation on ``device``, CUDA unless the caller asks
  for another: each PE type's rows go through the models in chunks, the
  polynomial features and their fixed-order sums on the device, the
  rest on the host (:mod:`repro_torch.core.ppa`).  The joint HW x NN
  path (``co_evaluate_table``) predicts latency per (arch, HW) pair from
  a ``LayerStack``'s feature tensors.
  """
  name = "polynomial"

  def __init__(self, models: Dict[str, ppa_lib.PPAModels],
               loaded_from: Optional[str] = None, device: DeviceLike = None):
    self.device = resolve_device(device, "PolynomialBackend")
    device_lib.ensure_exact(self.device)
    self.models = dict(models)
    self.loaded_from = loaded_from

  @property
  def pe_types(self) -> Tuple[str, ...]:
    return tuple(self.models)

  # -- fitting --------------------------------------------------------------

  @classmethod
  def fit(cls, pe_types: Sequence[str] = PAPER_PE_TYPES, degree: int = 5,
          n_train: int = 240, layers: Optional[Sequence[ConvLayer]] = None,
          seed: int = 0, device: DeviceLike = None) -> "PolynomialBackend":
    """Characterize + fit once per PE type (seed offset i per type);
    identical requests reuse the in-process cache."""
    resolve_device(device, "PolynomialBackend")
    pe_types = tuple(pe_types)
    key = _fit_key(pe_types, degree, n_train, seed, layers)
    if key not in _FIT_CACHE:
      _FIT_CACHE[key] = {
          t: ppa_lib.fit_ppa_models(t, degree=degree, n_train=n_train,
                                    layers=layers, seed=seed + i)
          for i, t in enumerate(pe_types)}
    return cls(_FIT_CACHE[key], loaded_from=None, device=device)

  @classmethod
  def fit_or_load(cls, path: str, pe_types: Sequence[str] = PAPER_PE_TYPES,
                  degree: int = 5, n_train: int = 240,
                  layers: Optional[Sequence[ConvLayer]] = None,
                  seed: int = 0, device: DeviceLike = None
                  ) -> "PolynomialBackend":
    """Load fitted models from ``path`` when its fit fingerprint matches;
    otherwise fit fresh and save."""
    resolve_device(device, "PolynomialBackend")
    want = "|".join(_fit_key(tuple(pe_types), degree, n_train, seed, layers))
    if os.path.exists(path):
      try:
        with np.load(path) as data:
          if str(data["meta/fit_key"]) == want:
            return cls._from_npz(data, path, device)
      # a corrupt, stale or foreign cache file: refit and overwrite below
      # repro: ignore[ROB001] the refit below is the handling
      except (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile):
        pass
    backend = cls.fit(pe_types, degree, n_train, layers, seed, device)
    backend.save(path, fit_key=want)
    return backend

  # -- persistence ----------------------------------------------------------

  def save(self, path: str, fit_key: str = "") -> None:
    """Serialize every PolyModel exactly, in the reference's format
    (float64 ``.npz``, format version 1, the same keys)."""
    arrays: Dict[str, np.ndarray] = {
        "meta/version": np.asarray(_FORMAT_VERSION),
        "meta/pe_types": np.asarray(list(self.models)),
        "meta/fit_key": np.asarray(fit_key),
    }
    for t, bundle in self.models.items():
      arrays[f"{t}/degree"] = np.asarray(bundle.degree)
      for target in _TARGETS:
        model: ppa_lib.PolyModel = getattr(bundle, target)
        base = f"{t}/{target}"
        arrays[f"{base}/exponents"] = model.exponents
        arrays[f"{base}/col_scale"] = model.col_scale
        arrays[f"{base}/coef"] = model.coef
        arrays[f"{base}/degree"] = np.asarray(model.degree)
        arrays[f"{base}/y_scale"] = np.asarray(model.y_scale)
        arrays[f"{base}/log_target"] = np.asarray(model.log_target)
    d = os.path.dirname(path)
    if d:
      os.makedirs(d, exist_ok=True)
    np.savez(path, **arrays)

  @classmethod
  def load(cls, path: str, device: DeviceLike = None) -> "PolynomialBackend":
    with np.load(path) as data:
      return cls._from_npz(data, path, device)

  @classmethod
  def _from_npz(cls, data, path: str,
                device: DeviceLike = None) -> "PolynomialBackend":
    version = int(data["meta/version"])
    if version != _FORMAT_VERSION:
      raise ValueError(f"{path}: unsupported model-bundle version {version}")
    models = {}
    for t in data["meta/pe_types"]:
      t = str(t)
      parts = {}
      for target in _TARGETS:
        base = f"{t}/{target}"
        parts[target] = ppa_lib.PolyModel(
            degree=int(data[f"{base}/degree"]),
            exponents=data[f"{base}/exponents"],
            col_scale=data[f"{base}/col_scale"],
            coef=data[f"{base}/coef"],
            y_scale=float(data[f"{base}/y_scale"]),
            log_target=bool(data[f"{base}/log_target"]))
      models[t] = ppa_lib.PPAModels(pe_type=t, degree=int(data[f"{t}/degree"]),
                                    **parts)
    return cls(models, loaded_from=path, device=device)

  # -- evaluation -----------------------------------------------------------

  def _check_types(self, present) -> None:
    missing = set(present) - set(self.models)
    if missing:
      raise KeyError(f"backend has no models for PE types {sorted(missing)}; "
                     f"fitted types: {sorted(self.models)}")

  def evaluate(self, cfgs: Configs, layers: Sequence[ConvLayer],
               network: str = "net") -> ResultFrame:
    """Batched prediction, grouped by PE type (one model set per type);
    the global buffer from the memoized scalar oracle.  ConfigTables take
    the columnar path."""
    if isinstance(cfgs, ConfigTable):
      return self.evaluate_table(cfgs, layers, network)
    cfgs = list(cfgs)
    by_type: Dict[str, List[int]] = {}
    for i, c in enumerate(cfgs):
      by_type.setdefault(c.pe_type, []).append(i)
    self._check_types(by_type)
    lat = np.zeros(len(cfgs))
    pwr = np.zeros(len(cfgs))
    area = np.zeros(len(cfgs))
    for pe_type, idxs in by_type.items():
      sub = [cfgs[i] for i in idxs]
      m = self.models[pe_type]
      lat[idxs] = np.maximum(
          m.predict_network_latency_s(sub, layers, self.device), 1e-9)
      gb_p, gb_a = gbuf_overheads(sub)
      pwr[idxs] = np.maximum(m.predict_power_mw(sub, self.device), 1e-3) \
          + gb_p
      area[idxs] = np.maximum(m.predict_area_mm2(sub, self.device), 1e-6) \
          + gb_a
    return ResultFrame(lat, pwr, area,
                       np.asarray([c.pe_type for c in cfgs]),
                       tuple(cfgs), network)

  def evaluate_table(self, table: ConfigTable, layers: Sequence[ConvLayer],
                     network: str = "net",
                     chunk_size: int = 32768) -> ResultFrame:
    """Columnar prediction over a ConfigTable, per-PE-type model sets, in
    bounded-memory chunks (the latency feature matrix is rows x layers
    wide — chunking caps it at ``chunk_size * len(layers)`` rows); the
    global buffer from the batch formulas on the device."""
    self._check_types(t for t, _ in table.groups_by_type())
    n = len(table)
    lat = np.zeros(n)
    pwr = np.zeros(n)
    area = np.zeros(n)
    for pe_type, idxs in table.groups_by_type():
      m = self.models[pe_type]
      for lo in range(0, idxs.size, chunk_size):
        sel = idxs[lo:lo + chunk_size]
        sub = table.select(sel)
        lat[sel] = np.maximum(
            m.predict_network_latency_s(sub, layers, self.device), 1e-9)
        gb_p, gb_a = gbuf_overheads_table(sub, self.device)
        pwr[sel] = np.maximum(m.predict_power_mw(sub, self.device), 1e-3) \
            + gb_p
        area[sel] = np.maximum(m.predict_area_mm2(sub, self.device),
                               1e-6) + gb_a
    return ResultFrame(lat, pwr, area, table.pe_type_strings(), (),
                       network, table=table)

  def co_evaluate_table(self, hw: ConfigTable, stack: LayerStack,
                        network: str = "coexplore",
                        chunk_size: int = 32768) -> ResultFrame:
    """Joint HW x NN sweep through the fitted models.

    Power and area (plus the global-buffer macro) are predicted once per
    HW row; latency per (arch, HW) pair from the stack's feature tensors,
    one fixed-order sum per arch per HW chunk of ``chunk_size //
    max_layers`` rows.  Returns the same arch-major joint frame as
    :meth:`TorchOracleBackend.co_evaluate_table`.
    """
    self._check_types(t for t, _ in hw.groups_by_type())
    n_hw, n_archs = len(hw), stack.n_archs
    lat = np.zeros((n_archs, n_hw))
    pwr = np.zeros(n_hw)
    area = np.zeros(n_hw)
    feats = stack.features()
    n_layers = stack.n_layers()
    hw_chunk = max(1, chunk_size // max(stack.max_layers, 1))
    for pe_type, idxs in hw.groups_by_type():
      m = self.models[pe_type]
      for lo in range(0, idxs.size, hw_chunk):
        sel = idxs[lo:lo + hw_chunk]
        sub = hw.select(sel)
        gb_p, gb_a = gbuf_overheads_table(sub, self.device)
        pwr[sel] = np.maximum(m.predict_power_mw(sub, self.device), 1e-3) \
            + gb_p
        area[sel] = np.maximum(m.predict_area_mm2(sub, self.device),
                               1e-6) + gb_a
        hw_feats = sub.latency_hw_features()
        for a in range(n_archs):
          lf = feats[a, :int(n_layers[a])]
          lat[a, sel] = np.maximum(
              m.predict_network_latency_feats(hw_feats, lf, self.device),
              1e-9)
    joint = hw.cross(n_archs)
    return ResultFrame(
        lat.reshape(-1), np.tile(pwr, n_archs), np.tile(area, n_archs),
        joint.pe_type_strings(), (), network, table=joint,
        extra={"arch_id": joint.arch_ids()})
