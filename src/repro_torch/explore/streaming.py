"""Streaming sweep engine: constant-memory exploration with online
Pareto / top-k / stats / histogram reduction (the port of
``repro.explore.streaming``).

Chunks come from ``DesignSpace.iter_tables`` (a plain sweep) or from
``JointTable.block_slices`` (co-exploration: arch blocks x HW chunks of
the lazy cross product); each is dispatched to the device as a pending
handle, and a window of ``DISPATCH_AHEAD`` handles
stays in flight so host sampling overlaps device execution.  Every
accumulator is chunk-order invariant and emits survivors in global row
order, so streamed fronts and top-k are bit-identical to the one-shot
frame's ``pareto``/``top_k`` on the same sweep.

``workers > 1`` evaluates chunks on a thread pool (the host halves,
sampling and hashing, release the GIL in numpy); ``pool=`` shards them
over a :class:`repro_torch.explore.fleet.DevicePool`.  Either way the
engine folds in chunk-index order through a reorder buffer, so a
threaded or fleet run folds exactly what a single-threaded one does,
stats included (the reference folds threaded chunks as they finish,
which can move a stats mean in its last bit).

Fault tolerance (:mod:`repro_torch.explore.resilience`): each chunk
carries its ladder of rungs, a ``policy`` walks it on failures, and
``resume_from`` journals reducer snapshots under a content-addressed key
so a killed sweep resumes where its last checkpoint left it.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor, wait
from typing import (Callable, Dict, Iterable, Iterator, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.explore.frame import (_MAXIMIZE_COLUMNS, ResultFrame,
                                       pareto_mask, stable_topk_indices)
from repro_torch.explore.resilience import (ChunkError, ChunkTask,
                                            ResiliencePolicy, Rung,
                                            SweepJournal,
                                            arch_accs_fingerprint,
                                            reducers_fingerprint,
                                            space_fingerprint, sweep_key)
from repro_torch.explore.space import DesignSpace

# a chunk producer, the engine's unit of work: it returns the evaluated
# (frame, global row ids) pair, or a pending handle with .resolve()
Task = Callable[[], object]

# how many device chunks stay in flight: chunk n+ahead is sampled and
# dispatched while the device still runs chunk n
DISPATCH_AHEAD = 2

# every wait on the worker pool is bounded and re-armed in a loop, so a
# slow chunk never wedges the submitting thread invisibly
POOL_WAIT_SECONDS = 60.0

# explore(vectorized="auto") switches to the streaming engine
# (CollectAccumulator: identical full frame out) at this many rows
STREAM_AUTO_MIN_ROWS = 1_000_000


def default_workers(backend=None) -> int:
  """Thread-pool width: 1 for a backend on CUDA (its chunks dispatch
  asynchronously with a ``DISPATCH_AHEAD`` window, so one submitting
  thread already overlaps host and device work, as the reference gives
  its ``jit=True`` backend one), otherwise one per core up to 8."""
  device = getattr(backend, "device", None)
  if device is not None and getattr(device, "type", None) == "cuda":
    return 1
  return max(1, min(8, os.cpu_count() or 1))


def _empty_frame() -> ResultFrame:
  z = np.zeros(0)
  return ResultFrame(z, z, z, np.zeros(0, dtype="<U1"))


# ---------------------------------------------------------------------------
# reducers
# ---------------------------------------------------------------------------

class Reducer:
  """Online reduction over evaluated chunks.

  ``fold(frame, indices)`` consumes one chunk (``indices`` are the
  chunk's global row ids); ``result()`` emits the reduction.  Fusable
  reducers also implement ``device_spec()`` (what the fused device
  program computes per chunk) and ``fold_payload(payload)``.
  """

  def fold(self, frame: ResultFrame, indices: np.ndarray) -> None:
    raise NotImplementedError

  def result(self):
    raise NotImplementedError

  def device_spec(self):
    """The fused-device request, or None when this reducer needs full
    chunks."""
    return None

  def fold_payload(self, payload) -> None:
    """Consume one fused-chunk payload; the default handles the
    ``("rows", frame, indices)`` form of every row-keeping reducer."""
    kind, frame, indices = payload
    if kind != "rows":
      raise ValueError(f"{type(self).__name__} cannot fold {kind!r}")
    self.fold(frame, indices)

  def snapshot(self) -> Dict[str, object]:
    """Journal-serializable copy of the accumulator state (see
    :class:`repro_torch.explore.resilience.SweepJournal`): a deep copy of
    ``__dict__``.  Accumulator state is host numpy arrays, scalars,
    frames and lists (never a ``torch.Tensor``: fused payloads reach the
    host before they fold), all picklable and isolated from later
    in-place folds by the copy."""
    return {"cls": type(self).__name__,
            "state": copy.deepcopy(self.__dict__)}

  def restore(self, snap: Dict[str, object]) -> None:
    """Adopt a :meth:`snapshot`; folding the not-yet-journaled chunks on
    top is bit-identical to an uninterrupted run."""
    if snap.get("cls") != type(self).__name__:
      raise ValueError(f"snapshot of {snap.get('cls')!r} cannot restore "
                       f"a {type(self).__name__}")
    self.__dict__.update(copy.deepcopy(snap["state"]))

  def fingerprint(self) -> str:
    """Content key for the journal's reducer-plan component: two
    reducers with equal fingerprints accept each other's snapshots (the
    reference's strings, so keys agree across the two packages)."""
    return type(self).__name__

  def remap_indices(self, ranker: Callable[[ResultFrame], np.ndarray]
                    ) -> None:
    """Rewrite the retained survivors' global row ids via ``ranker`` (a
    frame -> int64 ids function).  Delta sweeps
    (:mod:`repro_torch.explore.store`) restore a cached accumulator whose
    ids were assigned in the base space's enumeration and re-address
    them in the edited space before folding the new subgrid; a strictly
    monotone remap leaves every selection and tie-break unchanged.
    Default: no retained ids (stats and histogram state is id-free)."""


class ParetoAccumulator(Reducer):
  """Online non-dominated front over the given columns: per-chunk
  ``pareto_mask``, then a front-vs-front merge with the running front.
  ``result()`` is a survivors-only frame in global row order."""

  def __init__(self, cols: Sequence[str] = ("perf_per_area", "energy_mj"),
               maximize: Optional[Sequence[str]] = None):
    self.cols = tuple(cols)
    self._mx = _MAXIMIZE_COLUMNS if maximize is None else frozenset(maximize)
    self._obj: Optional[np.ndarray] = None
    self._idx = np.zeros(0, np.int64)
    self._frame: Optional[ResultFrame] = None

  def _objectives(self, frame: ResultFrame) -> np.ndarray:
    return np.stack([-frame.column(c) if c in self._mx else frame.column(c)
                     for c in self.cols], axis=1).astype(np.float64)

  def fold(self, frame: ResultFrame, indices: np.ndarray) -> None:
    if not len(frame):
      return
    obj = self._objectives(frame)
    keep = np.flatnonzero(pareto_mask(obj))
    cand_obj = obj[keep]
    cand_idx = np.asarray(indices, np.int64)[keep]
    cand_frame = frame.select(keep)
    if self._frame is not None:
      cand_obj = np.concatenate([self._obj, cand_obj])
      cand_idx = np.concatenate([self._idx, cand_idx])
      cand_frame = ResultFrame.concat([self._frame, cand_frame])
    sel = np.flatnonzero(pareto_mask(cand_obj))
    self._obj = cand_obj[sel]
    self._idx = cand_idx[sel]
    self._frame = cand_frame.select(sel)

  @property
  def indices(self) -> np.ndarray:
    """Global row ids of the current front, ascending."""
    return np.sort(self._idx)

  def device_spec(self):
    from repro_torch.explore.device import ParetoSpec
    return ParetoSpec(self.cols,
                      tuple(c for c in self.cols if c in self._mx))

  def remap_indices(self, ranker) -> None:
    if self._frame is not None and len(self._frame):
      self._idx = np.asarray(ranker(self._frame), np.int64)

  def fingerprint(self) -> str:
    mx = ",".join(sorted(c for c in self.cols if c in self._mx))
    return f"Pareto(cols={','.join(self.cols)};mx={mx})"

  def result(self) -> ResultFrame:
    if self._frame is None:
      return _empty_frame()
    return self._frame.select(np.argsort(self._idx, kind="stable"))


class TopKAccumulator(Reducer):
  """Online k-best rows under one column (ties broken by global row id);
  ``result()`` is a best-first frame equal to ``frame.top_k(k, by)``."""

  def __init__(self, k: int, by: str = "perf_per_area",
               maximize: Optional[bool] = None):
    if k <= 0:
      raise ValueError(f"k must be positive, got {k}")
    self.k = int(k)
    self.by = by
    self.maximize = by in _MAXIMIZE_COLUMNS if maximize is None else maximize
    self._key = np.zeros(0, np.float64)
    self._idx = np.zeros(0, np.int64)
    self._frame: Optional[ResultFrame] = None

  def fold(self, frame: ResultFrame, indices: np.ndarray) -> None:
    if not len(frame):
      return
    vals = np.asarray(frame.column(self.by), np.float64)
    key = -vals if self.maximize else vals
    idx = np.asarray(indices, np.int64)
    loc = stable_topk_indices(key, self.k, tie=idx)
    cand_key = np.concatenate([self._key, key[loc]])
    cand_idx = np.concatenate([self._idx, idx[loc]])
    sub = frame.select(loc)
    cand_frame = sub if self._frame is None \
        else ResultFrame.concat([self._frame, sub])
    sel = stable_topk_indices(cand_key, self.k, tie=cand_idx)
    self._key = cand_key[sel]
    self._idx = cand_idx[sel]
    self._frame = cand_frame.select(sel)

  @property
  def indices(self) -> np.ndarray:
    """Global row ids of the current k-best, best-first."""
    return self._idx.copy()

  def device_spec(self):
    from repro_torch.explore.device import TopKSpec
    return TopKSpec(self.by, self.k, self.maximize)

  def remap_indices(self, ranker) -> None:
    if self._frame is not None and len(self._frame):
      self._idx = np.asarray(ranker(self._frame), np.int64)

  def fingerprint(self) -> str:
    return f"TopK(k={self.k};by={self.by};mx={self.maximize})"

  def result(self) -> ResultFrame:
    return self._frame if self._frame is not None else _empty_frame()


class StatsAccumulator(Reducer):
  """Streaming count/mean/std/min/max of one column (Chan's parallel
  Welford merge: exact min/max/count, float-associativity-level mean and
  std)."""

  def __init__(self, col: str):
    self.col = col
    self.n = 0
    self._mean = 0.0
    self._m2 = 0.0
    self._min = np.inf
    self._max = -np.inf

  def fold(self, frame: ResultFrame, indices: np.ndarray) -> None:
    v = np.asarray(frame.column(self.col), np.float64)
    if not v.size:
      return
    mean_b = float(v.mean())
    m2_b = 0.0 if v.size == 1 else float(((v - mean_b) ** 2).sum())
    self._merge(v.size, mean_b, m2_b, float(v.min()), float(v.max()))

  def _merge(self, n_b: int, mean_b: float, m2_b: float, min_b: float,
             max_b: float) -> None:
    if not self.n:
      # adopt the first partial directly (NaN-free for +-inf means)
      self.n = n_b
      self._mean = mean_b
      self._m2 += m2_b
      self._min = min(self._min, min_b)
      self._max = max(self._max, max_b)
      return
    delta = mean_b - self._mean
    total = self.n + n_b
    self._m2 += m2_b + delta * delta * self.n * n_b / total
    self._mean += delta * n_b / total
    self.n = total
    self._min = min(self._min, min_b)
    self._max = max(self._max, max_b)

  def device_spec(self):
    from repro_torch.explore.device import StatsSpec
    return StatsSpec(self.col)

  def fingerprint(self) -> str:
    return f"Stats(col={self.col})"

  def fold_payload(self, payload) -> None:
    kind, data = payload[0], payload[1]
    if kind != "stats":
      return super().fold_payload(payload)
    if data["n"]:
      self._merge(data["n"], data["mean"], data["m2"], data["min"],
                  data["max"])

  def result(self) -> Dict[str, float]:
    if not self.n:
      return {k: float("nan")
              for k in ("count", "mean", "std", "min", "max")}
    return {"count": float(self.n), "mean": self._mean,
            "std": float(np.sqrt(self._m2 / self.n)),
            "min": self._min, "max": self._max}


class HistogramAccumulator(Reducer):
  """Streaming fixed-range histogram of one column; values outside
  ``(lo, hi)`` are clipped into the edge bins.  :meth:`quantile`
  interpolates linearly within bins (approximate: the error is bounded
  by the bin width)."""

  def __init__(self, col: str, lo: float, hi: float, bins: int = 64):
    if not hi > lo:
      raise ValueError(f"need hi > lo, got ({lo}, {hi})")
    if bins <= 0:
      raise ValueError(f"bins must be positive, got {bins}")
    self.col = col
    self.edges = np.linspace(float(lo), float(hi), int(bins) + 1)
    self.counts = np.zeros(int(bins), np.int64)

  def fold(self, frame: ResultFrame, indices: np.ndarray) -> None:
    v = np.asarray(frame.column(self.col), np.float64)
    if not v.size:
      return
    v = np.clip(v, self.edges[0], self.edges[-1])
    self.counts += np.histogram(v, bins=self.edges)[0]

  def device_spec(self):
    from repro_torch.explore.device import HistSpec
    return HistSpec(self.col, float(self.edges[0]), float(self.edges[-1]),
                    len(self.counts))

  def fingerprint(self) -> str:
    return (f"Hist(col={self.col};lo={self.edges[0]!r};"
            f"hi={self.edges[-1]!r};bins={len(self.counts)})")

  def fold_payload(self, payload) -> None:
    kind, data = payload[0], payload[1]
    if kind != "hist":
      return super().fold_payload(payload)
    self.counts += np.asarray(data, np.int64)

  def quantile(self, q: float) -> float:
    """Approximate q-quantile from the bin counts (linear within bins)."""
    total = int(self.counts.sum())
    if not total:
      return float("nan")
    target = np.clip(q, 0.0, 1.0) * total
    cum = np.cumsum(self.counts)
    b = int(np.searchsorted(cum, target, side="left"))
    b = min(b, len(self.counts) - 1)
    below = cum[b] - self.counts[b]
    frac = (target - below) / max(self.counts[b], 1)
    return float(self.edges[b]
                 + np.clip(frac, 0.0, 1.0) * (self.edges[b + 1]
                                              - self.edges[b]))

  def result(self) -> Dict[str, np.ndarray]:
    return {"counts": self.counts.copy(), "edges": self.edges.copy()}


class CollectAccumulator(Reducer):
  """Keeps every chunk and reassembles the full frame in global row
  order — NOT constant-memory.  This is how ``vectorized="auto"`` runs
  big sweeps through the engine while keeping the one-shot return type
  bit-exactly."""

  def __init__(self):
    self._frames = []
    self._idx = []

  def fold(self, frame: ResultFrame, indices: np.ndarray) -> None:
    if not len(frame):
      return
    self._frames.append(frame)
    self._idx.append(np.asarray(indices, np.int64))

  def remap_indices(self, ranker) -> None:
    self._idx = [np.asarray(ranker(f), np.int64) for f in self._frames]

  def result(self) -> ResultFrame:
    if not self._frames:
      return _empty_frame()
    big = self._frames[0] if len(self._frames) == 1 \
        else ResultFrame.concat(self._frames)
    idx = np.concatenate(self._idx)
    return big.select(np.argsort(idx, kind="stable"))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StreamResult:
  """Outcome of a streaming sweep: one entry per reducer (by name) plus
  run stats."""
  results: Dict[str, object]
  n_rows: int
  seconds: float
  meta: Dict[str, float]

  def __getitem__(self, name: str):
    return self.results[name]


def new_counters() -> Dict[str, int]:
  """A fresh run-stats dict in the shape the journal checkpoints."""
  return {"n_rows": 0, "n_chunks": 0, "n_transferred": 0,
          "n_overflows": 0, "n_retries": 0, "n_demotions": 0}


def fold_chunk(reducers: Dict[str, Reducer], counters: Dict[str, int],
               result) -> None:
  """Resolve (if pending) and fold one completed chunk into every
  reducer, updating ``counters``."""
  if hasattr(result, "resolve"):
    result = result.resolve()
  counters["n_chunks"] += 1
  payloads = getattr(result, "payloads", None)
  if payloads is not None:  # a device FusedChunk
    counters["n_rows"] += result.n_rows
    counters["n_transferred"] += result.n_transferred
    counters["n_overflows"] += result.n_overflows
    for name, payload in payloads.items():
      reducers[name].fold_payload(payload)
    return
  frame, indices = result
  counters["n_rows"] += len(frame)
  counters["n_transferred"] += len(frame)
  for r in reducers.values():
    r.fold(frame, indices)


def run_stream(tasks: Iterable[Task], reducers: Dict[str, Reducer],
               workers: int = 1, dispatch_ahead: int = DISPATCH_AHEAD,
               policy: Optional[ResiliencePolicy] = None,
               resume_from=None, journal_key: str = "",
               checkpoint_every: int = 1, pool=None) -> StreamResult:
  """Drain ``tasks`` (each producing one evaluated chunk), folding every
  reducer in chunk-index order.  Pending handles wait in a window of
  ``dispatch_ahead`` before they are resolved, so the host prepares the
  next chunks while the device runs earlier ones.

  ``workers > 1`` executes tasks on a thread pool with an in-flight
  window of ``2 x workers`` tasks, so peak memory stays O(window x
  chunk).  Results pass a reorder buffer (the oldest task is waited for
  first) and then the same dispatch window as one worker, so a threaded
  run folds the same chunks in the same order, bit for bit, stats
  included; folds happen on the calling thread only.  On CUDA each
  worker thread dispatches on its own current stream.

  ``pool`` — a :class:`repro_torch.explore.fleet.DevicePool`: the sweep
  goes to :func:`repro_torch.explore.fleet.run_fleet`, which shards
  chunks over the pool's devices (health tracking, straggler
  speculation, resharding, the silent-corruption sentinel) and folds in
  the same order.

  Failure semantics:

  * ``policy`` — a :class:`ResiliencePolicy` executing each
    :class:`ChunkTask` through retry + its ladder; its retry/demotion
    totals land in ``meta``.
  * a fatally failing chunk raises :class:`ChunkError` carrying the
    chunk's global index (tasks not yet started are cancelled).
  * ``resume_from`` — a :class:`SweepJournal` (or its directory path).
    Reducer snapshots plus the set of folded chunk indices are recorded
    under ``journal_key`` every ``checkpoint_every`` folds *and* on the
    way out of a fatal error; a checkpoint holds only chunks already
    folded (the dispatch window's are recomputed after a resume).  On
    entry, a matching record restores the reducers and already-folded
    chunks are skipped before dispatch.
  """
  if pool is not None:
    from repro_torch.explore.fleet import run_fleet
    return run_fleet(tasks, reducers, pool, policy=policy,
                     dispatch_ahead=dispatch_ahead, resume_from=resume_from,
                     journal_key=journal_key,
                     checkpoint_every=checkpoint_every)
  workers = max(1, int(workers))
  t0 = time.perf_counter()
  journal = None
  done_chunks: set = set()
  counters = new_counters()
  n_resumed = 0
  if resume_from is not None:
    journal = resume_from if isinstance(resume_from, SweepJournal) \
        else SweepJournal(resume_from)
    state = journal.load_state(journal_key)
    if state is not None:
      done_chunks = set(state["done"])
      for name, r in reducers.items():
        r.restore(state["reducers"][name])
      counters.update(state["counters"])
      n_resumed = len(done_chunks)
  base_retries = counters["n_retries"]
  base_demotions = counters["n_demotions"]
  since_ckpt = 0

  def totals() -> Tuple[int, int]:
    extra_r = policy.n_retries if policy is not None else 0
    extra_d = policy.n_demotions if policy is not None else 0
    return base_retries + extra_r, base_demotions + extra_d

  def checkpoint(force: bool = False) -> None:
    nonlocal since_ckpt
    if journal is None:
      return
    since_ckpt += 1
    if not force and since_ckpt < max(int(checkpoint_every), 1):
      return
    counters["n_retries"], counters["n_demotions"] = totals()
    journal.record(journal_key, {
        "done": set(done_chunks),
        "reducers": {name: r.snapshot() for name, r in reducers.items()},
        "counters": dict(counters)})
    since_ckpt = 0

  def execute(task):
    return policy.execute(task) if policy is not None else task()

  def fail(index, exc):
    """Flush the journal, then surface the failing chunk's global
    index (a bare re-raise would lose it)."""
    checkpoint(force=True)
    if isinstance(exc, ChunkError):
      raise exc
    raise ChunkError(index, f"{type(exc).__name__}: {exc}") from exc

  def finish(index, result) -> None:
    try:
      fold_chunk(reducers, counters, result)
    except Exception as e:
      fail(index, e)
    done_chunks.add(index)
    checkpoint()

  def indexed() -> Iterator[Tuple[int, Task]]:
    """(global chunk index, task) pairs, skipping already-folded chunks
    before they are materialized or dispatched."""
    for i, task in enumerate(tasks):
      index = getattr(task, "index", i)
      if index not in done_chunks:
        yield index, task

  def in_order() -> Iterator[Tuple[int, object]]:
    """(index, executed task) in chunk-index order; a failing task
    raises :class:`ChunkError` when its turn comes."""
    if workers == 1:
      for index, task in indexed():
        try:
          yield index, execute(task)
        except Exception as e:
          fail(index, e)
      return
    with ThreadPoolExecutor(max_workers=workers) as executor:
      inflight: "deque" = deque()  # (index, future), submission order

      def oldest() -> Tuple[int, object]:
        index, fut = inflight.popleft()
        while not wait([fut], timeout=POOL_WAIT_SECONDS).done:
          pass
        try:
          return index, fut.result()
        except Exception as e:
          fail(index, e)

      try:
        for index, task in indexed():
          inflight.append((index, executor.submit(execute, task)))
          if len(inflight) >= 2 * workers:
            yield oldest()
        while inflight:
          yield oldest()
      finally:
        # fatal (or abandoned): drop queued tasks so the pool shuts down
        # promptly instead of grinding through the in-flight window
        for _, fut in inflight:
          fut.cancel()

  window: "deque" = deque()
  for index, res in in_order():
    if hasattr(res, "resolve"):
      window.append((index, res))
      if len(window) > max(int(dispatch_ahead), 0):
        finish(*window.popleft())
    else:
      finish(index, res)
  while window:
    finish(*window.popleft())
  checkpoint(force=True)
  seconds = time.perf_counter() - t0
  n_retries, n_demotions = totals()
  meta = {"seconds": seconds, "workers": float(workers),
          "n_chunks": float(counters["n_chunks"]),
          "rows_transferred": float(counters["n_transferred"]),
          "rows_per_sec": counters["n_rows"] / max(seconds, 1e-12),
          "n_retries": float(n_retries),
          "n_demotions": float(n_demotions),
          "n_resumed_chunks": float(n_resumed),
          "n_overflows": float(counters["n_overflows"])}
  if policy is not None:
    meta["n_leaked_watchdogs"] = float(policy.watchdogs.n_live())
    if policy.breaker is not None:
      meta.update(policy.breaker.meta())
  return StreamResult(
      results={name: r.result() for name, r in reducers.items()},
      n_rows=counters["n_rows"], seconds=seconds, meta=meta)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def default_explore_reducers() -> Dict[str, Reducer]:
  """The paper's default plain-sweep reduction plan."""
  return {"pareto": ParetoAccumulator()}


def default_co_reducers() -> Dict[str, Reducer]:
  """The paper's default 3-objective joint-front reduction plan."""
  return {"pareto": ParetoAccumulator(("top1_err", "energy_mj",
                                       "area_mm2"))}


def explore_sweep_key(space: DesignSpace, reducers: Dict[str, Reducer], *,
                      n_per_type: int, seed: int, method: str,
                      chunk_size: int, network: str) -> str:
  """The content-addressed journal key of a plain streamed sweep."""
  return sweep_key("explore", space_fingerprint(space),
                   reducers_fingerprint(reducers),
                   {"n_per_type": n_per_type, "seed": seed,
                    "method": method, "chunk_size": chunk_size,
                    "network": network})


def co_explore_sweep_key(space: DesignSpace, reducers: Dict[str, Reducer],
                         arch_accs, *, n_hw_per_type: int, seed: int,
                         image_size: int, method: str,
                         chunk_size: int) -> str:
  """The content-addressed journal key of a streamed co-exploration."""
  archs = tuple(arch for arch, _ in arch_accs)
  accs = np.asarray([float(acc) for _, acc in arch_accs], np.float64)
  return sweep_key("co-explore", space_fingerprint(space),
                   reducers_fingerprint(reducers),
                   {"n_hw_per_type": n_hw_per_type, "seed": seed,
                    "image_size": image_size, "method": method,
                    "chunk_size": chunk_size,
                    "archs": arch_accs_fingerprint(archs, accs)})


def explore_tasks(backend, space: DesignSpace, layers, network: str,
                  n_per_type: int, seed: int, method: str, chunk_size: int,
                  reducers: Dict[str, Reducer],
                  row_ids: Optional[Callable[[object, int], np.ndarray]]
                  = None) -> Iterator[ChunkTask]:
  """The chunk tasks of a plain streamed sweep.  Each carries the rungs
  its backend offers, best first: ``fused-device`` (a backend with
  ``fused_eval_pending``, when every reducer is fusable), then ``device``
  (one with ``eval_pending``); any other backend evaluates each chunk
  with its ``evaluate_table``.  The last rung is the backend's own
  (on the card under a card backend): unlike the reference's ladder,
  none ends on the host (see :mod:`repro_torch.explore.resilience`).

  ``row_ids(chunk, offset)`` overrides the global row ids (default: the
  one-shot sample order ``arange(offset, offset + len)``); delta sweeps
  (:mod:`repro_torch.explore.store`) pass the edited space's canonical
  grid ranks.  The exploration service and the store's drivers consume
  these same tasks."""
  if not hasattr(backend, "evaluate_table"):
    raise ValueError(f"backend {backend.name!r} has no evaluate_table; "
                     "streaming requires the columnar path")
  plan = None
  if hasattr(backend, "fused_eval_pending"):
    from repro_torch.explore.device import build_plan
    plan = build_plan(reducers, joint=False)
  device_mode = hasattr(backend, "eval_pending")
  layers = tuple(layers)

  def make_task(chunk, idx, ci) -> ChunkTask:
    rungs = []
    if plan is not None:
      rungs.append(Rung(
          "fused-device",
          lambda: backend.fused_eval_pending(chunk, layers, network, plan,
                                             idx),
          layer="device"))
    if device_mode:
      rungs.append(Rung(
          "device",
          lambda: backend.eval_pending(chunk, layers, network, idx),
          layer="device"))
    else:
      rungs.append(Rung(
          "evaluate_table",
          lambda: (backend.evaluate_table(chunk, layers, network), idx),
          layer="backend"))
    return ChunkTask(index=ci, rungs=tuple(rungs))

  def gen() -> Iterator[ChunkTask]:
    offset = 0
    for ci, chunk in enumerate(
        space.iter_tables(n_per_type, seed=seed, method=method,
                          chunk_size=chunk_size)):
      if row_ids is None:
        idx = np.arange(offset, offset + len(chunk), dtype=np.int64)
      else:
        idx = np.asarray(row_ids(chunk, offset), np.int64)
      offset += len(chunk)
      yield make_task(chunk, idx, ci)

  return gen()


def stream_explore(backend, space: DesignSpace, layers, network: str = "net",
                   n_per_type: int = 200, seed: int = 17,
                   method: str = "random",
                   reducers: Optional[Dict[str, Reducer]] = None,
                   chunk_size: int = 65536, workers: Optional[int] = None,
                   policy: Optional[ResiliencePolicy] = None,
                   resume_from=None, checkpoint_every: int = 1,
                   pool=None) -> StreamResult:
  """Sample -> evaluate -> reduce a plain HW sweep in bounded memory.
  Global row ids follow the one-shot sample order, so survivors match the
  one-shot frame row for row.  ``policy`` walks each chunk's ladder on
  failures; ``resume_from`` journals and restores the sweep under
  :func:`explore_sweep_key` (the backend is not part of the key, so a
  journal written on the card resumes on the CPU).  ``workers``
  (default :func:`default_workers`) and ``pool`` as :func:`run_stream`."""
  if reducers is None:
    reducers = default_explore_reducers()
  key = ""
  if resume_from is not None:
    key = explore_sweep_key(space, reducers, n_per_type=n_per_type,
                            seed=seed, method=method, chunk_size=chunk_size,
                            network=network)
  return run_stream(explore_tasks(backend, space, layers, network,
                                  n_per_type, seed, method, chunk_size,
                                  reducers), reducers,
                    workers=default_workers(backend) if workers is None
                    else workers,
                    policy=policy, resume_from=resume_from, journal_key=key,
                    checkpoint_every=checkpoint_every, pool=pool)


def co_explore_tasks(backend, space: DesignSpace, arch_accs,
                     n_hw_per_type: int, seed: int, image_size: int,
                     method: str, chunk_size: int,
                     reducers: Dict[str, Reducer]) -> Iterator[ChunkTask]:
  """The chunk tasks of a streamed co-exploration: per PE type (HW
  sampled with ``seed + 17 * ti``), the arch x HW cross product in
  ``JointTable.block_slices`` blocks, global row ids from
  ``block_indices``, so rows replicate the one-shot joint frame's
  (pe_type, arch, hw) order.  Rungs as :func:`explore_tasks`:
  ``fused-device`` (``fused_co_eval_pending``, when every reducer is
  fusable), then ``device`` (``co_eval_pending``); any other backend
  evaluates each block with its ``co_evaluate_table``."""
  from repro_torch.core.dataflow import LayerStack
  from repro_torch.core.supernet import arch_to_layers
  if not hasattr(backend, "co_evaluate_table"):
    raise ValueError(f"backend {backend.name!r} has no co_evaluate_table; "
                     "streaming requires the joint columnar path")
  archs = tuple(arch for arch, _ in arch_accs)
  accs = np.asarray([float(acc) for _, acc in arch_accs], np.float64)
  stack = LayerStack.from_layer_lists(
      [arch_to_layers(a, image_size=image_size) for a in archs])
  plan = None
  if hasattr(backend, "fused_co_eval_pending"):
    from repro_torch.explore.device import build_plan
    plan = build_plan(reducers, joint=True)
  device_mode = hasattr(backend, "co_eval_pending")
  if device_mode:
    # one distinct-layer factorization for the whole sweep, placed on the
    # device once: every block gathers from the same unique rows
    unique_cols, slot_ids = backend.place_dedup(stack.dedup_slots())

  def make_task(hw_sub, sub_stack, a_sl, idx, ci) -> ChunkTask:
    a_lo = a_sl.start
    rungs = []
    if plan is not None:
      rungs.append(Rung(
          "fused-device",
          lambda: backend.fused_co_eval_pending(
              hw_sub, sub_stack, "coexplore", plan, idx, a_lo, accs[a_sl],
              archs, dedup=(unique_cols, slot_ids[a_sl])),
          layer="device"))
    if device_mode:
      rungs.append(Rung(
          "device",
          lambda: backend.co_eval_pending(
              hw_sub, sub_stack, "coexplore", idx, a_lo, accs[a_sl], archs,
              dedup=(unique_cols, slot_ids[a_sl])),
          layer="device"))
    else:
      def run():
        f = backend.co_evaluate_table(hw_sub, sub_stack, network="coexplore")
        f.extra["arch_id"] = f.extra["arch_id"] + a_lo
        f.extra["top1"] = accs[f.extra["arch_id"]]
        f.arch_lookup = archs
        return f, idx
      rungs.append(Rung("co_evaluate_table", run, layer="backend"))
    return ChunkTask(index=ci, rungs=tuple(rungs))

  def gen() -> Iterator[ChunkTask]:
    offset = 0
    ci = 0
    for ti, pe_type in enumerate(space.pe_types):
      hw = space.sample_type_table(pe_type, n_hw_per_type,
                                   seed=seed + 17 * ti, method=method)
      joint = hw.cross(stack.n_archs)
      for a_sl, h_sl in joint.block_slices(chunk_size):
        idx = offset + joint.block_indices(a_sl, h_sl)
        yield make_task(hw.select(h_sl),
                        stack.slice_archs(a_sl.start, a_sl.stop),
                        a_sl, idx, ci)
        ci += 1
      offset += len(joint)

  return gen()


def stream_co_explore(backend, space: DesignSpace, arch_accs,
                      n_hw_per_type: int = 20, seed: int = 3,
                      image_size: int = 32, method: str = "random",
                      reducers: Optional[Dict[str, Reducer]] = None,
                      chunk_size: int = 65536,
                      workers: Optional[int] = None,
                      policy: Optional[ResiliencePolicy] = None,
                      resume_from=None, checkpoint_every: int = 1,
                      pool=None) -> StreamResult:
  """Joint HW x NN co-exploration in bounded memory: the arch x HW cross
  product is visited in ``JointTable.block_slices`` blocks (HW sampled
  once per PE type; the product never materializes).  Chunk frames carry
  the one-shot joint frame's ``top1`` / ``arch_id`` / ``arch_lookup``
  columns and global row ids.  Default reducers: the paper's
  3-objective (top1_err, energy_mj, area_mm2) joint front.  ``policy``,
  ``resume_from``, ``workers`` and ``pool`` as :func:`stream_explore`,
  under :func:`co_explore_sweep_key`."""
  if reducers is None:
    reducers = default_co_reducers()
  key = ""
  if resume_from is not None:
    key = co_explore_sweep_key(space, reducers, arch_accs,
                               n_hw_per_type=n_hw_per_type, seed=seed,
                               image_size=image_size, method=method,
                               chunk_size=chunk_size)
  return run_stream(co_explore_tasks(backend, space, arch_accs,
                                     n_hw_per_type, seed, image_size,
                                     method, chunk_size, reducers), reducers,
                    workers=default_workers(backend) if workers is None
                    else workers,
                    policy=policy, resume_from=resume_from, journal_key=key,
                    checkpoint_every=checkpoint_every, pool=pool)
