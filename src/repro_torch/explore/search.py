"""Guided multi-objective search over the streaming evaluator (the port
of ``repro.explore.search``, whole).

The joint space (110k+ architectures x an unbounded HW grid) is too
large to enumerate; the exhaustive sweeps of
:mod:`repro_torch.explore.streaming` spend their budget uniformly.  This
module is the search layer: an NSGA-II-style evolutionary optimizer
whose unit of work is *one generation == one chunk* of the evaluate
pipeline, plus a surrogate mode that fits
:func:`repro_torch.core.ppa.fit_poly` models online and screens
proposals by expected hypervolume gain.

Everything here is host numpy, op for op the reference's, so a search
is bit-identical to the reference's wherever the evaluations are:

  * every random draw routes through a ``np.random.RandomState`` seeded
    by :func:`repro_torch.core.seeding.derive_seed` (one labelled stream
    per generation), so same-seed reruns are bit-identical;
  * populations are materialized as :class:`~repro_torch.core.table.
    ConfigTable` columns via the :class:`~repro_torch.explore.space.
    DesignSpace` axes — mutation and crossover operate on per-axis
    *value indices*, so children always lie on the discrete grid, and
    constraint predicates re-apply through ``DesignSpace.table_mask``
    after every variation;
  * each generation evaluates as a single chunk through the caller's
    ``evaluate`` hook (the session wires this to
    ``TorchOracleBackend.eval_pending``: one dispatch on the card a
    generation, bit-equal to the numpy oracle);
  * evaluated generations fold into the chunk-order-invariant
    :class:`~repro_torch.explore.streaming.ParetoAccumulator` with global
    row ids in evaluation order, so the reported front is *exact*;
  * the surrogate screen predicts with :meth:`PolyModel.predict` (the
    reference's ``phi @ coef`` in numpy), never with the card's
    fixed-order sum, whose last bits differ (P1): near-tie hypervolume
    gains would rank otherwise and the trajectory would leave the
    reference's.

Selection ranks and fronts on the host (successive
:func:`~repro_torch.explore.frame.pareto_mask` peels); no kernel runs
here.

Entry point: :meth:`repro_torch.explore.ExplorationSession.optimize`, or
:func:`guided_search` directly with a custom ``evaluate`` hook.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.seeding import derive_seed
from repro_torch.core.table import ConfigTable
from repro_torch.explore.frame import (_MAXIMIZE_COLUMNS, ResultFrame,
                                       pareto_mask)
from repro_torch.explore.resilience import (ChunkError, ChunkTask,
                                            ResiliencePolicy, Rung,
                                            SweepJournal,
                                            reducers_fingerprint,
                                            space_fingerprint, sweep_key)
from repro_torch.explore.space import DesignSpace
from repro_torch.explore.streaming import (ParetoAccumulator, Reducer,
                                           StreamResult)

__all__ = [
    "crowding_distance", "guided_search", "hypervolume",
    "nondominated_ranks", "objective_matrix",
]

# surrogate screening thins the archive front to this many points before
# the per-candidate hypervolume-gain loop (a proposal heuristic only —
# the reported front/hypervolume always use the full archive)
_SCREEN_FRONT_CAP = 64

# variation-repair retries before a generation accepts fewer candidates
# (the constrained-or-exhausted-space escape hatch)
_REPAIR_TRIES = 64


# ---------------------------------------------------------------------------
# front quality: exact hypervolume (minimization convention)
# ---------------------------------------------------------------------------

def hypervolume(points: np.ndarray, ref: Sequence[float]) -> float:
  """Exact dominated hypervolume of ``points`` against reference ``ref``.

  All objectives are MINIMIZED (the :func:`pareto_mask` convention);
  only points strictly below ``ref`` in every coordinate contribute.
  Dimension-sweep ("slicing") algorithm: exact in any dimension,
  O(n log n) in 2-D, O(n^2 log n)-ish per extra dimension — intended
  for front-sized inputs, not million-row sweeps.
  """
  pts = np.asarray(points, np.float64)
  if pts.ndim != 2:
    raise ValueError(f"points must be 2-D, got shape {pts.shape}")
  r = np.asarray(ref, np.float64).reshape(-1)
  if r.shape[0] != pts.shape[1]:
    raise ValueError(f"ref has {r.shape[0]} coords for "
                     f"{pts.shape[1]}-objective points")
  if pts.shape[0] == 0:
    return 0.0
  pts = pts[np.all(pts < r, axis=1)]
  if pts.shape[0] == 0:
    return 0.0
  front = np.unique(pts[pareto_mask(pts)], axis=0)
  return float(_hv(front, r))


def _hv(front: np.ndarray, ref: np.ndarray) -> float:
  """Recursive slicing on a deduplicated non-dominated set."""
  d = front.shape[1]
  if d == 1:
    return float(ref[0] - front[:, 0].min())
  if d == 2:
    # ascending x => strictly descending y on a strict 2-D front
    order = np.argsort(front[:, 0], kind="stable")
    x = front[order, 0]
    y = front[order, 1]
    prev_y = np.concatenate([[ref[1]], y[:-1]])
    return float(np.sum((ref[0] - x) * (prev_y - y)))
  order = np.argsort(front[:, -1], kind="stable")
  z = front[order, -1]
  total = 0.0
  for i in range(z.shape[0]):
    z_hi = z[i + 1] if i + 1 < z.shape[0] else ref[-1]
    if z_hi <= z[i]:
      continue  # zero-thickness slab: merged into the next slice
    sub = front[order[: i + 1], :-1]
    if sub.shape[0] > 1:
      sub = np.unique(sub[pareto_mask(sub)], axis=0)
    total += (z_hi - z[i]) * _hv(sub, ref[:-1])
  return total


def objective_matrix(frame: ResultFrame, cols: Sequence[str],
                     maximize: Optional[Sequence[str]] = None) -> np.ndarray:
  """(n, d) minimized objective matrix — identical column signs to
  :class:`~repro_torch.explore.streaming.ParetoAccumulator` (columns in
  ``maximize``, default the frame's perf/perf_per_area/top1 set, are
  negated)."""
  mx = _MAXIMIZE_COLUMNS if maximize is None else frozenset(maximize)
  return np.stack([-frame.column(c) if c in mx else frame.column(c)
                   for c in cols], axis=1).astype(np.float64)


# ---------------------------------------------------------------------------
# NSGA-II machinery: ranks, crowding, selection, variation
# ---------------------------------------------------------------------------

def nondominated_ranks(obj: np.ndarray) -> np.ndarray:
  """Rank 0 = the Pareto front, rank 1 = the front of the rest, ... —
  successive :func:`pareto_mask` peels (the block-decomposed N-D host
  routine underneath), so million-row rank sorts stay vectorized."""
  obj = np.asarray(obj, np.float64)
  n = obj.shape[0]
  ranks = np.zeros(n, np.int64)
  alive = np.arange(n)
  r = 0
  while alive.size:
    m = pareto_mask(obj[alive])
    if not m.any():  # pragma: no cover - only reachable on NaN objectives
      ranks[alive] = r
      break
    ranks[alive[m]] = r
    alive = alive[~m]
    r += 1
  return ranks


def crowding_distance(obj: np.ndarray, ranks: np.ndarray) -> np.ndarray:
  """Per-front crowding distance (inf at each front's per-objective
  boundaries; interior points sum normalized neighbour gaps).  Sorts are
  stable, so equal-objective ties resolve by row index — deterministic."""
  obj = np.asarray(obj, np.float64)
  ranks = np.asarray(ranks, np.int64)
  crowd = np.zeros(obj.shape[0], np.float64)
  for r in np.unique(ranks):
    rows = np.flatnonzero(ranks == r)
    if rows.size <= 2:
      crowd[rows] = np.inf
      continue
    for j in range(obj.shape[1]):
      v = obj[rows, j]
      order = np.argsort(v, kind="stable")
      crowd[rows[order[0]]] = np.inf
      crowd[rows[order[-1]]] = np.inf
      span = float(v[order[-1]] - v[order[0]])
      if span > 0.0:
        crowd[rows[order[1:-1]]] += (v[order[2:]] - v[order[:-2]]) / span
  return crowd


def _tournament(rank: np.ndarray, crowd: np.ndarray,
                rng: np.random.RandomState, n_picks: int) -> np.ndarray:
  """Binary tournament on (rank asc, crowding desc); ties keep the first
  contestant, so the draw sequence alone fixes the outcome."""
  pick = rng.randint(0, rank.shape[0], size=(n_picks, 2))
  a, b = pick[:, 0], pick[:, 1]
  b_wins = (rank[b] < rank[a]) | ((rank[b] == rank[a])
                                  & (crowd[b] > crowd[a]))
  return np.where(b_wins, b, a)


def _draw(rng: np.random.RandomState, n: int,
          card: np.ndarray) -> np.ndarray:
  """n uniform genomes: one value-index per gene, per-gene cardinalities
  ``card`` (vectorized across genes of different cardinality)."""
  u = rng.rand(n, card.shape[0])
  return np.minimum((u * card[None, :]).astype(np.int64), card - 1)


def _vary(genome: np.ndarray, rank: np.ndarray, crowd: np.ndarray,
          rng: np.random.RandomState, card: np.ndarray, n_out: int,
          crossover_rate: float, mutation_rate: float) -> np.ndarray:
  """Tournament parents -> uniform crossover -> per-gene reset mutation.
  Every gene stays a valid value index of its axis by construction."""
  picks = _tournament(rank, crowd, rng, 2 * n_out)
  pa = genome[picks[:n_out]]
  pb = genome[picks[n_out:]]
  crossed = rng.rand(n_out) < crossover_rate
  take_b = (rng.rand(n_out, card.shape[0]) < 0.5) & crossed[:, None]
  child = np.where(take_b, pb, pa)
  mutate = rng.rand(n_out, card.shape[0]) < mutation_rate
  return np.where(mutate, _draw(rng, n_out, card), child)


# ---------------------------------------------------------------------------
# genome <-> ConfigTable
# ---------------------------------------------------------------------------

def _cardinalities(space: DesignSpace, n_archs: Optional[int]) -> np.ndarray:
  card = [len(space.pe_types)] + [len(a.values) for a in space.axes]
  if n_archs is not None:
    card.append(n_archs)
  return np.asarray(card, np.int64)


def _decode_table(space: DesignSpace, genome: np.ndarray) -> ConfigTable:
  """Genome rows -> ConfigTable (gene 0 = PE type index, genes 1..7 =
  per-axis value indices; a trailing arch gene, when present, is not the
  table's concern)."""
  names = np.asarray(space.pe_types)[genome[:, 0]]
  cols = {a.name: np.asarray(a.values)[genome[:, 1 + i]]
          for i, a in enumerate(space.axes)}
  return ConfigTable.from_columns(names, cols)


def _genome_keys(genome: np.ndarray) -> list:
  """Per-row identity keys (bytes of the int64 gene vector) for the
  evaluated-points archive — exact, vocabulary-independent."""
  g = np.ascontiguousarray(genome, np.int64)
  return [g[i].tobytes() for i in range(g.shape[0])]


def _repair(space: DesignSpace, genome: np.ndarray,
            rng: np.random.RandomState, seen, card: np.ndarray
            ) -> np.ndarray:
  """Make every row constraint-valid and never-evaluated (archive +
  within-batch dedup) by redrawing offending rows; rows still bad after
  ``_REPAIR_TRIES`` redraws are dropped — the optimizer then runs a
  smaller generation rather than re-spending budget on known points."""
  genome = np.ascontiguousarray(genome, np.int64)
  good = np.zeros(len(genome), np.bool_)
  for attempt in range(_REPAIR_TRIES + 1):
    ok = space.table_mask(_decode_table(space, genome))
    keys = _genome_keys(genome)
    fresh = np.ones(len(genome), np.bool_)
    batch = set()
    for i in range(len(keys)):
      if keys[i] in seen or keys[i] in batch:
        fresh[i] = False
      else:
        batch.add(keys[i])
    good = ok & fresh
    bad = np.flatnonzero(~good)
    if not bad.size or attempt == _REPAIR_TRIES:
      break
    genome = genome.copy()
    genome[bad] = _draw(rng, bad.size, card)
  return genome[good]


# ---------------------------------------------------------------------------
# surrogate mode: online polynomial models + hypervolume-gain screening
# ---------------------------------------------------------------------------

def default_features(table: ConfigTable,
                     arch: Optional[np.ndarray]) -> np.ndarray:
  """Surrogate feature matrix: the same all-float64 knob + PE-constant
  bundle the batch formulas consume (``ConfigTable.numeric_columns``
  order), plus the raw arch gene when searching the joint space."""
  cols = table.numeric_columns()
  feats = [cols[k] for k in sorted(cols)]
  if arch is not None:
    feats.append(np.asarray(arch, np.float64))
  return np.stack(feats, axis=1)


def _fit_surrogates(x: np.ndarray, y: np.ndarray):
  """One :func:`repro_torch.core.ppa.fit_poly` model per objective
  (degree-2, max 2 variables per monomial — the QAPPA power/area basis
  shape; ridge keeps early small-sample fits well-posed), fitted on the
  host in numpy."""
  from repro_torch.core.ppa import fit_poly
  return [fit_poly(x, y[:, j], degree=2, max_vars=2)
          for j in range(y.shape[1])]


def _screen_front(archive_obj: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
  """(thinned archive front, hypervolume reference point) for proposal
  screening.  The reference sits 10% beyond the archive's per-objective
  worst, so every evaluated point contributes volume."""
  lo = archive_obj.min(axis=0)
  hi = archive_obj.max(axis=0)
  ref = hi + 0.1 * np.maximum(hi - lo, 1e-12)
  front = np.unique(archive_obj[pareto_mask(archive_obj)], axis=0)
  if front.shape[0] > _SCREEN_FRONT_CAP:
    sel = np.linspace(0, front.shape[0] - 1, _SCREEN_FRONT_CAP)
    front = front[sel.astype(np.int64)]
  return front, ref


def _hv_gain_screen(pred: np.ndarray, front: np.ndarray, ref: np.ndarray,
                    k: int) -> np.ndarray:
  """Indices of the ``k`` candidates with the largest expected
  hypervolume gain (predicted objectives vs. the archive front); ties
  break by candidate order — deterministic."""
  base = hypervolume(front, ref)
  gains = np.empty(pred.shape[0], np.float64)
  for i in range(pred.shape[0]):
    gains[i] = hypervolume(np.concatenate([front, pred[i:i + 1]]),
                           ref) - base
  return np.argsort(-gains, kind="stable")[:k]


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def guided_search(space: DesignSpace,
                  evaluate: Callable,
                  objectives: Sequence[str],
                  *,
                  maximize: Optional[Sequence[str]] = None,
                  population: int = 32,
                  generations: int = 12,
                  seed: int = 17,
                  surrogate: bool = False,
                  surrogate_pool: int = 4,
                  features: Callable = default_features,
                  crossover_rate: float = 0.9,
                  mutation_rate: Optional[float] = None,
                  n_archs: Optional[int] = None,
                  reducers: Optional[Dict[str, Reducer]] = None,
                  policy: Optional[ResiliencePolicy] = None,
                  resume_from=None,
                  checkpoint_every: int = 1
                  ) -> StreamResult:
  """NSGA-II-style search over a DesignSpace, one generation per chunk.

  ``evaluate(table, idx, arch)`` scores one generation: ``table`` is the
  generation's ConfigTable, ``idx`` its global row ids (evaluation
  order), ``arch`` the per-row architecture gene (``None`` unless
  ``n_archs`` is set).  It returns ``(ResultFrame, idx)`` or an
  asynchronous handle with ``.resolve()`` (the device path's
  PendingFrame), exactly like a streaming-engine task.

  Every generation folds into ``reducers`` (default: one
  :class:`ParetoAccumulator` over ``objectives``) before selection, so
  the returned front is chunk-order invariant and in global row order —
  the same exactness story as the streaming engine.  ``surrogate=True``
  additionally fits per-objective polynomial models on all evaluated
  points and screens a ``surrogate_pool x population`` proposal pool by
  expected hypervolume gain before spending evaluation budget.

  Returns a :class:`StreamResult`; ``meta`` carries evaluations /
  generations / hypervolume (+ its reference point) alongside the usual
  run stats.  Same seed, same inputs -> bit-identical result.

  A generation is the search's chunk: ``policy`` retries a failing
  ``evaluate`` under the resilience ladder, and ``resume_from`` (a
  :class:`SweepJournal` or its directory) checkpoints the complete loop
  state — archive, surrogate training set, population, reducers — after
  every generation, restoring it on re-entry.  Each generation's RNG is
  ``derive_seed("search-gen", seed, g)``, a pure function of ``(seed,
  g)``, so the resumed trajectory (and final front) is bit-identical to
  an uninterrupted run.  ``generations`` is deliberately *not* part of
  the journal key: resuming with a larger budget extends a finished run
  from its last durable generation.
  """
  objectives = tuple(objectives)
  if not objectives:
    raise ValueError("need at least one objective column")
  if population < 2:
    raise ValueError(f"population must be >= 2, got {population}")
  if generations < 1:
    raise ValueError(f"generations must be >= 1, got {generations}")
  if surrogate_pool < 2:
    raise ValueError(f"surrogate_pool must be >= 2, got {surrogate_pool}")
  if n_archs is not None and n_archs < 1:
    raise ValueError(f"n_archs must be >= 1, got {n_archs}")
  card = _cardinalities(space, n_archs)
  if mutation_rate is None:
    mutation_rate = 1.0 / card.shape[0]
  if reducers is None:
    reducers = {"pareto": ParetoAccumulator(objectives, maximize)}

  t0 = time.perf_counter()
  seen = set()  # evaluated-genome archive (membership only; never iterated)
  xs, ys = [], []
  models = None
  pop_genome = None
  pop_obj = None
  offset = 0
  gens_run = 0
  g_start = 0
  n_resumed = 0
  base_retries = 0
  base_demotions = 0
  journal = None
  jkey = ""
  if resume_from is not None:
    journal = resume_from if isinstance(resume_from, SweepJournal) \
        else SweepJournal(resume_from)
    jkey = sweep_key(
        "guided-search", space_fingerprint(space),
        reducers_fingerprint(reducers),
        {"objectives": objectives,
         "maximize": None if maximize is None else tuple(maximize),
         "population": population, "seed": seed, "surrogate": surrogate,
         "surrogate_pool": surrogate_pool,
         "crossover_rate": crossover_rate, "mutation_rate": mutation_rate,
         "n_archs": n_archs})
    state = journal.load(jkey)
    if state is not None:
      g_start = state["g_next"]
      seen = set(state["seen"])
      xs = list(state["xs"])
      ys = list(state["ys"])
      pop_genome = state["pop_genome"]
      pop_obj = state["pop_obj"]
      offset = state["offset"]
      gens_run = state["gens_run"]
      base_retries = state.get("n_retries", 0)
      base_demotions = state.get("n_demotions", 0)
      n_resumed = gens_run
      for name, r in reducers.items():
        if name in state["reducers"]:
          r.restore(state["reducers"][name])
      if surrogate and xs:
        # surrogate models refit deterministically from the journaled
        # training set — no fitted state needs serializing
        models = _fit_surrogates(np.concatenate(xs), np.concatenate(ys))
  since_ckpt = 0

  def checkpoint(g_next: int, force: bool = False) -> None:
    nonlocal since_ckpt
    if journal is None:
      return
    since_ckpt += 1
    if not force and since_ckpt < max(int(checkpoint_every), 1):
      return
    extra_r = policy.n_retries if policy is not None else 0
    extra_d = policy.n_demotions if policy is not None else 0
    journal.record(jkey, {
        "g_next": g_next, "seen": set(seen), "xs": list(xs),
        "ys": list(ys), "pop_genome": pop_genome, "pop_obj": pop_obj,
        "offset": offset, "gens_run": gens_run,
        "n_retries": base_retries + extra_r,
        "n_demotions": base_demotions + extra_d,
        "reducers": {name: r.snapshot() for name, r in reducers.items()}})
    since_ckpt = 0

  for g in range(g_start, generations):
    rng = np.random.RandomState(derive_seed("search-gen", seed, g))
    screening = surrogate and models is not None
    if pop_genome is None:
      cand = _draw(rng, population, card)
    else:
      rank = nondominated_ranks(pop_obj)
      crowd = crowding_distance(pop_obj, rank)
      n_out = population * (surrogate_pool if screening else 1)
      cand = _vary(pop_genome, rank, crowd, rng, card, n_out,
                   crossover_rate, mutation_rate)
    cand = _repair(space, cand, rng, seen, card)
    if not len(cand):
      break  # constrained/deduplicated space exhausted: stop early
    if screening and len(cand) > population:
      table = _decode_table(space, cand)
      arch = cand[:, -1] if n_archs is not None else None
      x = features(table, arch)
      pred = np.stack([m.predict(x) for m in models], axis=1)
      front, ref = _screen_front(np.concatenate(ys))
      cand = cand[_hv_gain_screen(pred, front, ref, population)]
    elif len(cand) > population:
      cand = cand[:population]

    table = _decode_table(space, cand)
    arch = cand[:, -1].copy() if n_archs is not None else None
    idx = np.arange(offset, offset + len(cand), dtype=np.int64)
    try:
      if policy is not None:
        out = policy.execute(ChunkTask(index=g, rungs=(
            Rung("evaluate", lambda: evaluate(table, idx, arch),
                 layer="backend"),)))
      else:
        out = evaluate(table, idx, arch)
      if hasattr(out, "resolve"):
        out = out.resolve()
    except Exception as e:
      # surface the failing generation; the journal already holds every
      # completed generation, so a re-run with resume_from continues here
      checkpoint(g, force=True)
      if isinstance(e, ChunkError):
        raise
      raise ChunkError(g, f"{type(e).__name__}: {e}") from e
    frame, idx = out
    offset += len(frame)
    for r in reducers.values():
      r.fold(frame, idx)
    obj = objective_matrix(frame, objectives, maximize)
    for key in _genome_keys(cand):
      seen.add(key)
    ys.append(obj)
    if surrogate:
      xs.append(features(table, arch))
      models = _fit_surrogates(np.concatenate(xs), np.concatenate(ys))
    if pop_genome is None:
      pop_genome, pop_obj = cand, obj
    else:
      allg = np.concatenate([pop_genome, cand])
      allo = np.concatenate([pop_obj, obj])
      rank = nondominated_ranks(allo)
      crowd = crowding_distance(allo, rank)
      order = np.lexsort((np.arange(allo.shape[0]), -crowd, rank))
      keep = np.sort(order[:population])
      pop_genome, pop_obj = allg[keep], allo[keep]
    gens_run += 1
    checkpoint(g + 1)

  checkpoint(generations, force=True)
  seconds = time.perf_counter() - t0
  n_retries = base_retries + (policy.n_retries if policy is not None else 0)
  n_demotions = base_demotions \
      + (policy.n_demotions if policy is not None else 0)
  all_obj = np.concatenate(ys) if ys else np.zeros((0, len(objectives)))
  meta = {"seconds": seconds, "workers": 1.0,
          "n_chunks": float(gens_run),
          "rows_transferred": float(offset),
          "rows_per_sec": offset / max(seconds, 1e-12),
          "evaluations": float(offset),
          "generations": float(gens_run),
          "population": float(population),
          "surrogate": float(bool(surrogate)),
          "n_retries": float(n_retries),
          "n_demotions": float(n_demotions),
          "n_resumed_chunks": float(n_resumed)}
  if all_obj.shape[0]:
    front, ref = _screen_front(all_obj)
    meta["hypervolume"] = hypervolume(
        all_obj[pareto_mask(all_obj)], ref)
    for j, col in enumerate(objectives):
      meta[f"hv_ref_{col}"] = float(ref[j])
  return StreamResult(
      results={name: r.result() for name, r in reducers.items()},
      n_rows=offset, seconds=seconds, meta=meta)
