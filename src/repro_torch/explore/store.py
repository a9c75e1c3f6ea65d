"""Content-addressed, crash-safe result store + delta sweeps (the port of
``repro.explore.store``).

An exploration service re-answers the same questions: the same sweep
re-submitted by another client, or a sweep over a space that differs
from a finished one by a handful of new axis values.  This module
amortizes both:

  store   :class:`ResultStore` — finished sweeps (reducer snapshots +
          run counters) keyed by the same content-addressed
          :func:`~repro_torch.explore.resilience.sweep_key`
          fingerprints the journal uses, minus the chunking parameters
          (reductions are chunk-order invariant, so chunk_size/workers
          are not part of a *result's* identity).  Entries are written
          atomically (tempfile + rename) with an embedded sha256
          self-checksum; corrupt or truncated entries are detected on
          load, quarantined, and transparently recomputed.
  delta   when a full-grid sweep's :class:`DesignSpace` differs from a
          stored one by one edited axis (an in-order value
          supersequence, see :meth:`DesignSpace.axis_delta`), only the
          new subgrid is evaluated and folded into the cached
          accumulators.  The cached survivors are re-addressed with
          :meth:`DesignSpace.grid_rank` — canonical value-determined
          ranks whose old->new remap is strictly monotone — so every
          selection and tie-break matches a from-scratch sweep and the
          merged fronts are bit-identical.

Keys are equal as hex to the reference's, and entries load through
:class:`~repro_torch.explore.resilience.SnapshotUnpickler`: the classes
a snapshot holds resolve to the port's whichever package wrote them, and
any other global is refused as corruption.  So a store directory the
JAX package filled serves the port.  The reverse does not hold: the
reference's plain ``pickle.loads`` would import ``repro_torch`` to read
the port's entries.

Entry points: :func:`cached_stream_explore` /
:func:`cached_stream_co_explore` (standalone drivers, also reachable via
``ExplorationSession.explore(..., stream=True, store=...)``), and the
:class:`~repro_torch.explore.service.ExplorationService`, which consults
the store at admission time.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import pickle
import threading
import time
from typing import Dict, List, Optional, Tuple

try:
  import fcntl
except ImportError:  # non-posix: single-process use keeps working
  fcntl = None

import numpy as np

from repro_torch.explore.resilience import (ResiliencePolicy, SweepJournal,
                                            arch_accs_fingerprint,
                                            load_snapshot,
                                            reducers_fingerprint,
                                            space_fingerprint, sweep_key)
from repro_torch.explore.space import DesignSpace
from repro_torch.explore.streaming import (Reducer, StreamResult,
                                           default_co_reducers,
                                           default_explore_reducers,
                                           default_workers, explore_tasks,
                                           run_stream, stream_co_explore,
                                           stream_explore)

STORE_VERSION = 1

# entry layout: magic | sha256 hexdigest of payload | newline | payload
_MAGIC = b"RSTO1\n"
_SHA_LEN = 64


class ResultStore:
  """Durable cache of finished sweeps, plus the in-progress journal.

  One binary file per result key under ``dir_path``; each file embeds a
  sha256 self-checksum over its pickled payload, is written atomically
  (tempfile + fsync + ``os.replace``), and is verified on every load —
  a mismatch (truncation, bit rot, a foreign class, a concurrent
  writer's partial state) moves the file into ``quarantine/`` and
  reports a miss, so the caller recomputes instead of trusting bad
  bytes.  A :class:`SweepJournal` under ``journal/`` carries in-progress
  checkpoints, and an append-log index of manifests makes finished
  sweeps discoverable for delta-sweep base matching.
  """

  INDEX_KEY = "index"

  def __init__(self, dir_path):
    self.dir = str(dir_path)
    os.makedirs(self.dir, exist_ok=True)
    self.quarantine_dir = os.path.join(self.dir, "quarantine")
    self._journal = SweepJournal(os.path.join(self.dir, "journal"))
    self.lock_path = os.path.join(self.dir, "manifest.lock")
    self.n_hits = 0
    self.n_misses = 0
    self.n_quarantined = 0
    self._lock = threading.Lock()

  @property
  def journal(self) -> SweepJournal:
    """The in-progress checkpoint journal co-located with the store."""
    return self._journal

  def path(self, key: str) -> str:
    return os.path.join(self.dir, f"result-{key[:32]}.bin")

  def put(self, key: str, state: Dict[str, object]) -> None:
    payload = pickle.dumps(
        {"version": STORE_VERSION, "key": key, "state": state},
        protocol=pickle.HIGHEST_PROTOCOL)
    digest = hashlib.sha256(payload).hexdigest().encode("ascii")
    path = self.path(key)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
      f.write(_MAGIC + digest + b"\n" + payload)
      f.flush()
      os.fsync(f.fileno())
    os.replace(tmp, path)

  def get(self, key: str) -> Optional[Dict[str, object]]:
    path = self.path(key)
    try:
      with open(path, "rb") as f:
        data = f.read()
    except FileNotFoundError:
      with self._lock:
        self.n_misses += 1
      return None
    state = self._verify(key, data)
    with self._lock:
      if state is None:
        self.n_quarantined += 1
        self.n_misses += 1
      else:
        self.n_hits += 1
    if state is None:
      self._quarantine(path)
    return state

  def _verify(self, key: str, data: bytes) -> Optional[Dict[str, object]]:
    header = len(_MAGIC) + _SHA_LEN + 1
    if len(data) < header or not data.startswith(_MAGIC):
      return None
    digest = data[len(_MAGIC):len(_MAGIC) + _SHA_LEN]
    payload = data[header:]
    if hashlib.sha256(payload).hexdigest().encode("ascii") != digest:
      return None
    try:
      rec = load_snapshot(payload)
    except Exception:
      return None
    if (not isinstance(rec, dict) or rec.get("version") != STORE_VERSION
        or rec.get("key") != key):
      return None
    return rec.get("state")

  def _quarantine(self, path: str) -> None:
    os.makedirs(self.quarantine_dir, exist_ok=True)
    base = os.path.basename(path)
    for i in range(10_000):
      dst = os.path.join(self.quarantine_dir, f"{base}.{i}")
      if not os.path.exists(dst):
        try:
          os.replace(path, dst)
        except FileNotFoundError:
          return  # a concurrent loader quarantined it first
        return

  def __contains__(self, key: str) -> bool:
    return os.path.exists(self.path(key))

  def stats(self) -> Dict[str, int]:
    with self._lock:
      return {"n_hits": self.n_hits, "n_misses": self.n_misses,
              "n_quarantined": self.n_quarantined}

  # -- manifest index (delta-sweep base discovery) --------------------------
  #
  # The index is one shared append log — the only store file several
  # *processes* mutate concurrently (results themselves are
  # content-addressed: concurrent writers of the same key write identical
  # bytes, and os.replace keeps each file internally consistent).  An
  # fcntl advisory lock serializes index access across processes (and,
  # because each acquisition opens its own file description, across
  # threads).  Reads take the lock too: ``replay`` truncates trailing
  # garbage *in place*, which must never race a concurrent append.

  @contextlib.contextmanager
  def _manifest_lock(self):
    if fcntl is None:
      yield
      return
    with open(self.lock_path, "a+b") as f:
      fcntl.flock(f.fileno(), fcntl.LOCK_EX)
      try:
        yield
      finally:
        fcntl.flock(f.fileno(), fcntl.LOCK_UN)

  def put_final(self, key: str, state: Dict[str, object],
                manifest: Optional[Dict[str, object]] = None) -> None:
    """Store a finished sweep and (optionally) index its manifest so
    later sweeps over edited spaces can find it as a delta base."""
    self.put(key, state)
    if manifest is not None:
      entry = dict(manifest)
      entry["key"] = key
      with self._manifest_lock():
        self._journal.append(self.INDEX_KEY, entry)

  def manifests(self) -> List[Dict[str, object]]:
    """Indexed manifests, newest last, deduplicated by key (last wins).
    A kill mid-append costs at most the entry being written."""
    seen: Dict[str, Dict[str, object]] = {}
    with self._manifest_lock():
      entries = self._journal.replay(self.INDEX_KEY)
    for entry in entries:
      seen[entry["key"]] = entry
    return list(seen.values())

  def compact_manifests(self) -> int:
    """Rewrite the manifest index keeping only the latest entry per key;
    atomic, under the manifest lock.  Returns the number of superseded
    entries dropped."""
    with self._manifest_lock():
      entries = self._journal.replay(self.INDEX_KEY)
      seen: Dict[str, Dict[str, object]] = {}
      for entry in entries:
        seen[entry["key"]] = entry
      dropped = len(entries) - len(seen)
      if dropped:
        self._journal.rewrite(self.INDEX_KEY, list(seen.values()))
    return dropped


# ---------------------------------------------------------------------------
# result keys (chunking-free: a *result's* identity, not a checkpoint's)
# ---------------------------------------------------------------------------

def explore_result_key(space: DesignSpace, reducers: Dict[str, Reducer], *,
                       network: str, n_per_type: int, seed: int,
                       method: str) -> str:
  """Finished-result key of a plain sweep.  ``chunk_size``/``workers``
  are excluded; full-grid enumerations normalize ``n_per_type`` to the
  grid size and drop the seed (grid sampling never consumes it), so any
  request that enumerates the same point set hits the same entry."""
  params: Dict[str, object] = {"network": network, "method": method}
  if method == "grid":
    params["n_per_type"] = int(min(n_per_type, space.per_type_grid_size()))
  else:
    params["n_per_type"] = int(n_per_type)
    params["seed"] = int(seed)
  return sweep_key("explore-final", space_fingerprint(space),
                   reducers_fingerprint(reducers), params)


def co_explore_result_key(space: DesignSpace, reducers: Dict[str, Reducer],
                          arch_accs, *, n_hw_per_type: int, seed: int,
                          image_size: int, method: str) -> str:
  """Finished-result key of a co-exploration (chunking excluded)."""
  archs = tuple(arch for arch, _ in arch_accs)
  accs = np.asarray([float(acc) for _, acc in arch_accs], np.float64)
  return sweep_key("co-explore-final", space_fingerprint(space),
                   reducers_fingerprint(reducers),
                   {"n_hw_per_type": int(n_hw_per_type), "seed": int(seed),
                    "image_size": int(image_size), "method": method,
                    "archs": arch_accs_fingerprint(archs, accs)})


def _space_manifest(space: DesignSpace) -> Dict[str, object]:
  return {"pe_types": list(space.pe_types),
          "axes": {a.name: list(a.values) for a in space.axes},
          "n_constraints": len(space.constraints)}


def _explore_manifest(space: DesignSpace, network: str, method: str,
                      reducers_fp: str, full_grid: bool) -> Dict[str, object]:
  return {"kind": "explore", "network": network, "method": method,
          "reducers_fp": reducers_fp, "full_grid": bool(full_grid),
          "space": _space_manifest(space)}


def find_delta_base(store: ResultStore, space: DesignSpace, *, network: str,
                    reducers_fp: str
                    ) -> Optional[Tuple[str, str, Tuple[float, ...]]]:
  """Newest indexed full-grid sweep that ``space`` extends by one axis
  edit, as ``(base_key, axis_name, added_values)`` — or None."""
  for entry in reversed(store.manifests()):
    if (entry.get("kind") != "explore" or not entry.get("full_grid")
        or entry.get("network") != network
        or entry.get("reducers_fp") != reducers_fp
        or entry.get("method") != "grid"):
      continue
    m = entry.get("space", {})
    if (tuple(m.get("pe_types", ())) != space.pe_types
        or m.get("n_constraints") != len(space.constraints)):
      continue
    axes = {name: tuple(vals) for name, vals in m.get("axes", {}).items()}
    delta = space.axis_delta(axes)
    if delta is not None and entry["key"] in store:
      return entry["key"], delta[0], delta[1]
  return None


def delta_sweep_key(space: DesignSpace, reducers_fp: str, base_key: str,
                    network: str) -> str:
  """The journal key of a delta sweep over ``space`` from ``base_key``."""
  return sweep_key("explore-delta", space_fingerprint(space), reducers_fp,
                   {"base": base_key, "network": network})


def delta_tasks(backend, space: DesignSpace, axis: str,
                added: Tuple[float, ...], layers, network: str,
                chunk_size: int, reducers: Dict[str, Reducer]):
  """The chunk tasks of a delta sweep: the subgrid of ``space`` holding
  only the ``added`` values of ``axis``, its rows addressed by
  ``space``'s canonical grid ranks."""
  sub = space.with_axes(**{axis: added})
  return explore_tasks(
      backend, sub, layers, network, sub.per_type_grid_size(), 0, "grid",
      chunk_size, reducers,
      row_ids=lambda chunk, offset: space.grid_rank(chunk))


# ---------------------------------------------------------------------------
# cached drivers
# ---------------------------------------------------------------------------

def _snapshot_state(reducers: Dict[str, Reducer],
                    res: StreamResult) -> Dict[str, object]:
  return {"reducers": {n: r.snapshot() for n, r in reducers.items()},
          "n_rows": int(res.n_rows),
          "n_chunks": int(res.meta.get("n_chunks", 0))}


def _cached_result(reducers: Dict[str, Reducer], state: Dict[str, object],
                   seconds: float) -> StreamResult:
  n_chunks = float(state.get("n_chunks", 0))
  n_rows = int(state.get("n_rows", 0))
  return StreamResult(
      results={n: r.result() for n, r in reducers.items()},
      n_rows=n_rows, seconds=seconds,
      meta={"seconds": seconds, "workers": 0.0, "n_chunks": n_chunks,
            "rows_transferred": 0.0,
            "rows_per_sec": n_rows / max(seconds, 1e-12),
            "n_retries": 0.0, "n_demotions": 0.0,
            "n_resumed_chunks": n_chunks, "n_overflows": 0.0,
            "store_hit": 1.0})


def _restore_delta_base(store: ResultStore, base_key: str,
                        reducers: Dict[str, Reducer],
                        space: DesignSpace) -> Optional[Dict[str, object]]:
  """Restore a delta base into ``reducers`` and re-address its survivors
  with the edited space's canonical grid ranks.  None (and reducers
  untouched — the caller falls back to a full sweep) when the entry is
  gone/corrupt or its frames cannot be re-ranked."""
  state = store.get(base_key)
  if state is None:
    return None
  snaps = state.get("reducers", {})
  if set(snaps) != set(reducers):
    return None
  fresh = {n: r.snapshot() for n, r in reducers.items()}
  try:
    for name, r in reducers.items():
      r.restore(snaps[name])
    ranker = lambda frame: space.grid_rank(frame.table)  # noqa: E731
    for r in reducers.values():
      r.remap_indices(ranker)
  except Exception:
    for name, r in reducers.items():
      r.restore(fresh[name])
    return None
  return state


def cached_stream_explore(backend, space: DesignSpace, layers,
                          network: str = "net", n_per_type: int = 200,
                          seed: int = 17, method: str = "random",
                          reducers: Optional[Dict[str, Reducer]] = None,
                          chunk_size: int = 65536,
                          workers: Optional[int] = None,
                          policy: Optional[ResiliencePolicy] = None,
                          checkpoint_every: int = 1,
                          store=None, delta: bool = True,
                          pool=None) -> StreamResult:
  """:func:`~repro_torch.explore.streaming.stream_explore` through the
  store: an identical finished sweep is a store hit (no evaluation at
  all); a full-grid sweep one axis-edit away from a stored one runs as a
  delta sweep over just the new subgrid; anything else runs from scratch
  (journaled under the store's journal, so kills resume).  All three
  paths yield bit-identical reductions; ``meta`` carries ``store_hit`` /
  ``delta_sweep`` so callers can see which ran."""
  if store is None:
    raise ValueError("cached_stream_explore requires store=")
  if not isinstance(store, ResultStore):
    store = ResultStore(store)
  if reducers is None:
    reducers = default_explore_reducers()
  rfp = reducers_fingerprint(reducers)
  rkey = explore_result_key(space, reducers, network=network,
                            n_per_type=n_per_type, seed=seed, method=method)
  t0 = time.perf_counter()
  state = store.get(rkey)
  if state is not None:
    for name, r in reducers.items():
      r.restore(state["reducers"][name])
    return _cached_result(reducers, state, time.perf_counter() - t0)

  full_grid = (method == "grid"
               and int(n_per_type) >= space.per_type_grid_size())
  manifest = _explore_manifest(space, network, method, rfp, full_grid)
  base = None
  if delta and full_grid:
    base = find_delta_base(store, space, network=network, reducers_fp=rfp)
  if base is not None:
    base_key, axis, added = base
    base_state = _restore_delta_base(store, base_key, reducers, space)
    if base_state is not None:
      res = run_stream(
          delta_tasks(backend, space, axis, added, layers, network,
                      chunk_size, reducers), reducers,
          workers=default_workers(backend) if workers is None else workers,
          policy=policy, resume_from=store.journal,
          journal_key=delta_sweep_key(space, rfp, base_key, network),
          checkpoint_every=checkpoint_every, pool=pool)
      res.meta["delta_sweep"] = 1.0
      res.meta["n_delta_rows"] = float(res.n_rows)
      res.n_rows += int(base_state.get("n_rows", 0))
      store.put_final(rkey, _snapshot_state(reducers, res), manifest)
      return res

  res = stream_explore(backend, space, layers, network,
                       n_per_type=n_per_type, seed=seed, method=method,
                       reducers=reducers, chunk_size=chunk_size,
                       workers=workers, policy=policy,
                       resume_from=store.journal,
                       checkpoint_every=checkpoint_every, pool=pool)
  store.put_final(rkey, _snapshot_state(reducers, res), manifest)
  return res


def cached_stream_co_explore(backend, space: DesignSpace, arch_accs,
                             n_hw_per_type: int = 20, seed: int = 3,
                             image_size: int = 32, method: str = "random",
                             reducers: Optional[Dict[str, Reducer]] = None,
                             chunk_size: int = 65536,
                             workers: Optional[int] = None,
                             policy: Optional[ResiliencePolicy] = None,
                             checkpoint_every: int = 1,
                             store=None, pool=None) -> StreamResult:
  """:func:`~repro_torch.explore.streaming.stream_co_explore` through the
  store: a hit on an identical finished co-exploration, otherwise run
  (journaled) and record.  No delta path: the joint sweep's identity
  includes the architecture set."""
  if store is None:
    raise ValueError("cached_stream_co_explore requires store=")
  if not isinstance(store, ResultStore):
    store = ResultStore(store)
  if reducers is None:
    reducers = default_co_reducers()
  rkey = co_explore_result_key(space, reducers, arch_accs,
                               n_hw_per_type=n_hw_per_type, seed=seed,
                               image_size=image_size, method=method)
  t0 = time.perf_counter()
  state = store.get(rkey)
  if state is not None:
    for name, r in reducers.items():
      r.restore(state["reducers"][name])
    return _cached_result(reducers, state, time.perf_counter() - t0)
  res = stream_co_explore(backend, space, arch_accs,
                          n_hw_per_type=n_hw_per_type, seed=seed,
                          image_size=image_size, method=method,
                          reducers=reducers, chunk_size=chunk_size,
                          workers=workers, policy=policy,
                          resume_from=store.journal,
                          checkpoint_every=checkpoint_every, pool=pool)
  store.put_final(rkey, _snapshot_state(reducers, res))
  return res
