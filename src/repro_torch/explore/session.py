"""ExplorationSession: the facade over the plain design-space sweep, HW x
NN co-exploration and guided search (the port of
``repro.explore.session``: ``evaluate``, ``explore``, ``co_explore`` and
``optimize``).

A session binds a backend (how points are scored) to a
:class:`DesignSpace` (which points exist).  ``explore`` picks between two
sampling materializations: the per-point config list, and the columnar
:class:`ConfigTable` for backends that prefer it (``prefers_table``);
``co_explore`` between the nested arch x HW loop of scalar evaluations
and the joint table path (``co_evaluate_table``).  ``stream=True`` runs
the constant-memory streaming engine and returns a StreamResult of
reducer outputs; with ``vectorized="auto"``, a one-shot sweep of
``STREAM_AUTO_MIN_ROWS`` rows (or pairs) or more on a table backend also
goes through the engine, with a CollectAccumulator: the identical full
frame comes out.  ``optimize`` runs the NSGA-II search of
:mod:`repro_torch.explore.search`, one generation a chunk.

Streams and searches take the reference's fault tolerance (``policy``,
``resume_from``, ``checkpoint_every``; :mod:`repro_torch.explore.
resilience`).  Streams also take a thread pool (``workers``), a result
store (``store``: :mod:`repro_torch.explore.store`, store hits and delta
sweeps) and a device fleet (``pool``: :mod:`repro_torch.explore.fleet`);
each gives the same fronts and top-k as the run without it.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.dataflow import AcceleratorConfig, ConvLayer
from repro_torch.explore import search
from repro_torch.explore.backend import OracleBackend
from repro_torch.explore.frame import ResultFrame
from repro_torch.explore.space import DesignSpace
from repro_torch.explore.streaming import (STREAM_AUTO_MIN_ROWS,
                                           CollectAccumulator, Reducer,
                                           StreamResult, stream_co_explore,
                                           stream_explore)


def _check_stream_only(stream: bool, reducers, policy, resume_from, pool,
                       store) -> None:
  if reducers is not None and not stream:
    raise ValueError("reducers only apply to the streaming engine; "
                     "pass stream=True")
  if (policy is not None or resume_from is not None
      or pool is not None) and not stream:
    raise ValueError("policy/resume_from/pool apply to the streaming "
                     "engine; pass stream=True")
  if store is not None and not stream:
    raise ValueError("store applies to the streaming engine; "
                     "pass stream=True")


def hw_evaluator(backend, layers: Sequence[ConvLayer], network: str):
  """The HW-only search's ``evaluate(table, idx, arch)`` hook: one
  ``eval_pending`` dispatch a generation on a backend that has it (a
  :class:`TorchOracleBackend`: the whole generation on the card, one
  pending handle), else ``evaluate_table``, else ``evaluate``."""
  use_device = hasattr(backend, "eval_pending")
  use_table = hasattr(backend, "evaluate_table")
  layer_key = tuple(layers)

  def evaluate(table, idx, arch):
    if use_device:
      return backend.eval_pending(table, layer_key, network, idx)
    if use_table:
      return backend.evaluate_table(table, layers, network), idx
    return backend.evaluate(table.to_configs(), layers, network), idx

  return evaluate


def joint_evaluator(backend, archs: Sequence[object], accs: np.ndarray,
                    arch_layers: Sequence[Sequence[ConvLayer]],
                    network: str):
  """The joint search's ``evaluate(table, idx, arch)`` hook: rows grouped
  by architecture gene, one ``evaluate_table`` (else ``evaluate``) per
  distinct architecture of the generation, reassembled in genome row
  order with ``top1``/``arch_id`` columns and ``arch_lookup``."""
  use_table = hasattr(backend, "evaluate_table")
  archs = tuple(archs)

  def evaluate(table, idx, arch):
    parts: List[ResultFrame] = []
    rows: List[np.ndarray] = []
    for aid in np.unique(arch):
      sel = np.flatnonzero(arch == aid)
      sub = table.select(sel)
      if use_table:
        f = backend.evaluate_table(sub, arch_layers[aid], network)
      else:
        f = backend.evaluate(sub.to_configs(), arch_layers[aid], network)
      f.extra["top1"] = np.full(len(f), accs[aid])
      f.extra["arch_id"] = np.full(len(f), aid, np.int64)
      f.arch_lookup = archs
      parts.append(f)
      rows.append(sel)
    frame = ResultFrame.concat(parts)
    perm = np.concatenate(rows)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    return frame.select(inv), idx

  return evaluate


def joint_features(accs: np.ndarray):
  """The joint search's surrogate features: the knob bundle of
  :func:`search.default_features` plus the architecture gene as its
  accuracy (the quantity the top1_err objective depends on), not as a
  raw id."""
  def features(table, arch):
    base = search.default_features(table, None)
    return np.concatenate([base, accs[arch][:, None]], axis=1)

  return features


class ExplorationSession:
  """Binds a backend (how points are scored) to a design space (default:
  the paper's space over the backend's PE types, where it names any)."""

  def __init__(self, backend, space: Optional[DesignSpace] = None):
    self.backend = backend
    if space is None:
      pe_types = getattr(backend, "pe_types", None)
      space = DesignSpace(pe_types=pe_types) if pe_types else DesignSpace()
    self.space = space

  def evaluate(self, cfgs: Sequence[AcceleratorConfig],
               layers: Sequence[ConvLayer],
               network: str = "net") -> ResultFrame:
    """Score explicit configs through the session's backend."""
    return self.backend.evaluate(cfgs, layers, network)

  def explore(self, layers: Sequence[ConvLayer], network: str,
              n_per_type: int = 200, seed: int = 17,
              method: str = "random", measure_oracle: int = 0,
              vectorized: Union[bool, str] = "auto", stream: bool = False,
              reducers: Optional[Dict[str, Reducer]] = None,
              chunk_size: int = 65536, workers: Optional[int] = None,
              policy=None, resume_from=None, checkpoint_every: int = 1,
              store=None, pool=None) -> Union[ResultFrame, StreamResult]:
    """Sample the space and evaluate ``network``; optionally time the
    scalar oracle on the first ``measure_oracle`` configs for the paper's
    speedup claim.

    vectorized: "auto" samples a ConfigTable when the backend advertises
    ``prefers_table``; True forces the table path for any backend with
    ``evaluate_table``; False keeps the per-point config list.

    stream=True runs the streaming engine over ``reducers`` (default: the
    paper's perf/area vs energy front) in chunks of ``chunk_size`` rows.

    frame.meta carries eval_seconds, eval_us_per_design and, when
    measured, oracle_seconds_per_design and speedup.

    ``policy`` / ``resume_from`` / ``checkpoint_every`` (stream=True
    only) enable chunk retry, degradation along the chunk's ladder and
    journaled resume — see :mod:`repro_torch.explore.resilience`.
    ``workers`` sets the stream's thread pool (default
    :func:`~repro_torch.explore.streaming.default_workers`), ``pool``
    shards it over a :class:`~repro_torch.explore.fleet.DevicePool`, and
    ``store`` (a :class:`~repro_torch.explore.store.ResultStore` or its
    directory) serves finished sweeps and runs one-axis edits of stored
    grid sweeps as delta sweeps (``resume_from`` is then the store's
    journal).
    """
    _check_stream_only(stream, reducers, policy, resume_from, pool, store)
    if stream:
      if measure_oracle:
        raise ValueError("measure_oracle is a one-shot feature; "
                         "pass stream=False")
      if store is not None:
        from repro_torch.explore.store import cached_stream_explore
        return cached_stream_explore(self.backend, self.space, layers,
                                     network, n_per_type=n_per_type,
                                     seed=seed, method=method,
                                     reducers=reducers,
                                     chunk_size=chunk_size, workers=workers,
                                     policy=policy,
                                     checkpoint_every=checkpoint_every,
                                     store=store, pool=pool)
      return stream_explore(self.backend, self.space, layers, network,
                            n_per_type=n_per_type, seed=seed, method=method,
                            reducers=reducers, chunk_size=chunk_size,
                            workers=workers, policy=policy,
                            resume_from=resume_from,
                            checkpoint_every=checkpoint_every, pool=pool)
    if vectorized == "auto":
      use_table = bool(getattr(self.backend, "prefers_table", False))
    else:
      use_table = bool(vectorized)
    if use_table and not hasattr(self.backend, "evaluate_table"):
      raise ValueError(f"backend {self.backend.name!r} has no "
                       "evaluate_table; pass vectorized=False")
    if (use_table and vectorized == "auto" and not measure_oracle
        and n_per_type * len(self.space.pe_types) >= STREAM_AUTO_MIN_ROWS):
      return self._explore_streamed_frame(layers, network, n_per_type, seed,
                                          method, chunk_size, workers)
    if use_table:
      cfgs = self.space.sample_table(n_per_type, seed=seed, method=method)
    else:
      cfgs = self.space.sample(n_per_type, seed=seed, method=method)
    t0 = time.perf_counter()
    frame = self.backend.evaluate(cfgs, layers, network)
    t_eval = time.perf_counter() - t0
    n = max(len(frame), 1)
    frame.meta["eval_seconds"] = t_eval
    frame.meta["eval_us_per_design"] = t_eval / n * 1e6
    if measure_oracle:
      k = min(measure_oracle, len(cfgs))
      sample = cfgs.select(slice(0, k)).to_configs() \
          if use_table else cfgs[:k]
      t1 = time.perf_counter()
      OracleBackend().evaluate(sample, layers, network)
      per_design = (time.perf_counter() - t1) / max(k, 1)
      frame.meta["oracle_seconds_per_design"] = per_design
      frame.meta["speedup"] = per_design / max(t_eval / n, 1e-12)
    return frame

  @staticmethod
  def _collected_frame(res: StreamResult) -> ResultFrame:
    """Unwrap a CollectAccumulator run: the identical full frame, tagged
    with how it was produced."""
    frame = res["frame"]
    frame.meta["streamed"] = 1.0
    return frame

  def _explore_streamed_frame(self, layers, network, n_per_type, seed,
                              method, chunk_size, workers) -> ResultFrame:
    """The auto above-threshold path: chunked evaluation through the
    engine, identical full frame out (CollectAccumulator)."""
    res = stream_explore(self.backend, self.space, layers, network,
                         n_per_type=n_per_type, seed=seed, method=method,
                         reducers={"frame": CollectAccumulator()},
                         chunk_size=chunk_size, workers=workers)
    frame = self._collected_frame(res)
    frame.meta["eval_seconds"] = res.seconds
    frame.meta["eval_us_per_design"] = res.seconds / max(len(frame), 1) * 1e6
    return frame

  def optimize(self, layers: Optional[Sequence[ConvLayer]] = None,
               network: str = "search", *,
               arch_accs: Optional[Sequence[Tuple[object, float]]] = None,
               objectives: Optional[Sequence[str]] = None,
               maximize: Optional[Sequence[str]] = None,
               population: int = 32, generations: int = 12, seed: int = 17,
               image_size: int = 32, surrogate: bool = False,
               surrogate_pool: int = 4, crossover_rate: float = 0.9,
               mutation_rate: Optional[float] = None,
               reducers: Optional[Dict[str, Reducer]] = None,
               policy=None, resume_from=None, checkpoint_every: int = 1
               ) -> StreamResult:
    """Guided multi-objective search (:mod:`repro_torch.explore.search`)
    instead of enumeration: an NSGA-II-style optimizer whose generations
    evaluate as single chunks through this session's backend, fronts
    folding through the chunk-order-invariant ParetoAccumulator — the
    same :class:`StreamResult` the streaming engine returns, same-seed
    reruns bit-identical.

    Two modes, like :meth:`explore` / :meth:`co_explore`:

      * HW-only (pass ``layers``): searches the DesignSpace for one
        workload; default objectives ``("perf_per_area", "energy_mj")``
        (the paper's front axes).  On a backend with ``eval_pending``
        (``TorchOracleBackend``) each generation is one dispatch on its
        device (:func:`hw_evaluator`).
      * joint (pass ``arch_accs``): the architecture choice becomes one
        more integer gene, and each generation evaluates grouped by
        architecture through ``evaluate_table`` (:func:`joint_evaluator`);
        default objectives ``("top1_err", "energy_mj", "area_mm2")`` (the
        Fig. 12 front).  A backend flagged ``jit`` is refused, as in the
        reference; the port's backends have no such flag.

    ``surrogate=True`` adds online polynomial screening (models refit on
    all evaluated points each generation, on the host) — proposals are
    pre-ranked by expected hypervolume gain before spending budget.
    ``meta`` carries evaluations / generations / hypervolume.
    """
    if (layers is None) == (arch_accs is None):
      raise ValueError("pass exactly one of layers= (HW-only search) or "
                       "arch_accs= (joint search)")
    if arch_accs is None:
      if objectives is None:
        objectives = ("perf_per_area", "energy_mj")
      return search.guided_search(
          self.space, hw_evaluator(self.backend, layers, network),
          objectives, maximize=maximize,
          population=population, generations=generations, seed=seed,
          surrogate=surrogate, surrogate_pool=surrogate_pool,
          crossover_rate=crossover_rate, mutation_rate=mutation_rate,
          reducers=reducers, policy=policy, resume_from=resume_from,
          checkpoint_every=checkpoint_every)

    from repro_torch.core.supernet import arch_to_layers
    if objectives is None:
      objectives = ("top1_err", "energy_mj", "area_mm2")
    if getattr(self.backend, "jit", False):
      raise ValueError(
          "joint optimize() needs a non-jit backend: each generation "
          "evaluates per-architecture layer lists, which would thrash "
          "the bounded jit program cache; use VectorOracleBackend() or "
          "PolynomialBackend")
    archs = [arch for arch, _ in arch_accs]
    accs = np.asarray([float(acc) for _, acc in arch_accs], np.float64)
    arch_layers = [arch_to_layers(arch, image_size=image_size)
                   for arch in archs]
    return search.guided_search(
        self.space,
        joint_evaluator(self.backend, archs, accs, arch_layers, network),
        objectives, maximize=maximize,
        population=population, generations=generations, seed=seed,
        surrogate=surrogate, surrogate_pool=surrogate_pool,
        features=joint_features(accs), crossover_rate=crossover_rate,
        mutation_rate=mutation_rate, n_archs=len(archs),
        reducers=reducers, policy=policy, resume_from=resume_from,
        checkpoint_every=checkpoint_every)

  def co_explore(self, arch_accs: Sequence[Tuple[object, float]],
                 n_hw_per_type: int = 20, seed: int = 3,
                 image_size: int = 32, method: str = "random",
                 vectorized: Union[bool, str] = "auto", stream: bool = False,
                 reducers: Optional[Dict[str, Reducer]] = None,
                 chunk_size: int = 65536, workers: Optional[int] = None,
                 policy=None, resume_from=None, checkpoint_every: int = 1,
                 store=None, pool=None) -> Union[ResultFrame, StreamResult]:
    """Sampled HW x evaluated architectures -> joint frame (Fig. 12).

    Rows carry a ``top1`` float column and an integer ``arch_id`` column
    resolving through ``frame.arch_lookup`` (one entry per architecture,
    in ``arch_accs`` order); the 3-objective joint front is
    ``frame.pareto(("top1_err", "energy_mj", "area_mm2"))``.

    vectorized: "auto" takes the joint table path when the backend
    advertises ``prefers_table`` and implements ``co_evaluate_table``;
    True forces it for any backend with ``co_evaluate_table``; False
    keeps the nested arch x HW loop of ``backend.evaluate`` calls.  Both
    emit rows in the same (pe_type, arch, hw) order, though
    ``method="random"`` samples other HW per path (as :meth:`explore`).

    stream=True runs the streaming engine over lazy JointTable blocks
    (default reducer: the 3-objective joint front); with "auto", sweeps
    of ``STREAM_AUTO_MIN_ROWS`` pairs or more go through the engine with
    a CollectAccumulator, the identical joint frame out.  ``policy`` /
    ``resume_from`` / ``checkpoint_every`` / ``workers`` / ``store`` /
    ``pool`` as :meth:`explore` (no delta sweeps: a joint sweep's
    identity includes its architectures).
    """
    from repro_torch.core.dataflow import LayerStack
    from repro_torch.core.supernet import arch_to_layers
    _check_stream_only(stream, reducers, policy, resume_from, pool, store)
    if stream:
      if not hasattr(self.backend, "co_evaluate_table"):
        raise ValueError(f"backend {self.backend.name!r} has no "
                         "co_evaluate_table; streaming needs the joint path")
      if store is not None:
        from repro_torch.explore.store import cached_stream_co_explore
        return cached_stream_co_explore(self.backend, self.space, arch_accs,
                                        n_hw_per_type=n_hw_per_type,
                                        seed=seed, image_size=image_size,
                                        method=method, reducers=reducers,
                                        chunk_size=chunk_size,
                                        workers=workers, policy=policy,
                                        checkpoint_every=checkpoint_every,
                                        store=store, pool=pool)
      return stream_co_explore(self.backend, self.space, arch_accs,
                               n_hw_per_type=n_hw_per_type, seed=seed,
                               image_size=image_size, method=method,
                               reducers=reducers, chunk_size=chunk_size,
                               workers=workers, policy=policy,
                               resume_from=resume_from,
                               checkpoint_every=checkpoint_every, pool=pool)
    if vectorized == "auto":
      use_joint = bool(getattr(self.backend, "prefers_table", False)) \
          and hasattr(self.backend, "co_evaluate_table")
    else:
      use_joint = bool(vectorized)
    if use_joint and not hasattr(self.backend, "co_evaluate_table"):
      raise ValueError(f"backend {self.backend.name!r} has no "
                       "co_evaluate_table; pass vectorized=False")
    n_pairs_est = len(arch_accs) * n_hw_per_type * len(self.space.pe_types)
    if (use_joint and vectorized == "auto"
        and n_pairs_est >= STREAM_AUTO_MIN_ROWS):
      res = stream_co_explore(self.backend, self.space, arch_accs,
                              n_hw_per_type=n_hw_per_type, seed=seed,
                              image_size=image_size, method=method,
                              reducers={"frame": CollectAccumulator()},
                              chunk_size=chunk_size, workers=workers)
      return self._collected_frame(res)
    archs = [arch for arch, _ in arch_accs]
    accs = np.asarray([float(acc) for _, acc in arch_accs], np.float64)
    arch_layers = [arch_to_layers(arch, image_size=image_size)
                   for arch in archs]
    frames: List[ResultFrame] = []
    if use_joint:
      stack = LayerStack.from_layer_lists(arch_layers)
      for ti, pe_type in enumerate(self.space.pe_types):
        hw = self.space.sample_type_table(pe_type, n_hw_per_type,
                                          seed=seed + 17 * ti, method=method)
        f = self.backend.co_evaluate_table(hw, stack, network="coexplore")
        f.extra["top1"] = accs[f.extra["arch_id"]]
        f.arch_lookup = tuple(archs)
        frames.append(f)
      return ResultFrame.concat(frames)
    for ti, pe_type in enumerate(self.space.pe_types):
      cfgs = self.space.sample_type(pe_type, n_hw_per_type,
                                    seed=seed + 17 * ti, method=method)
      for aid, layers in enumerate(arch_layers):
        f = self.backend.evaluate(cfgs, layers, network="coexplore")
        f.extra["top1"] = np.full(len(f), accs[aid])
        f.extra["arch_id"] = np.full(len(f), aid, np.int64)
        f.arch_lookup = tuple(archs)
        frames.append(f)
    return ResultFrame.concat(frames)
