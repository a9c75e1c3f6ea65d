"""Elastic device-fleet execution for streaming sweeps (the port of
``repro.explore.fleet``).

The streaming engine (:mod:`repro_torch.explore.streaming`) keeps one
submitting thread and a small in-flight window, all on one device.  This
module shards streaming chunks over every device of a pool: each chunk
is pinned to one device and runs the same fused evaluate+reduce program
there; the host merge is unchanged.  Chunk-partition bit-identity (every
reducer is chunk-order invariant, every chunk a pure function of
``(space, chunk_index, seed)``) makes any sharding, resharding or
re-execution sound, and the port folds in chunk-index order through a
reorder buffer, so the results equal a solo single-device run bit for
bit, stats included.

A fleet fails in ways one device never does, so the execution layer is
built around a health registry and three mitigations:

  DevicePool   per-device health: EWMA chunk latencies (via
               :class:`repro_torch.train.fault_tolerance.
               StragglerMonitor`), consecutive-failure counts, and a
               per-device :class:`~repro_torch.explore.resilience.
               CircuitBreaker`, so one sick device is quarantined
               instead of tripping the whole rung.  Quarantined (or
               lost) devices rejoin through the breaker's half-open
               probe.
  stragglers   the slowest in-flight shard is speculatively re-dispatched
               to an idle healthy device; the first result wins and the
               other is discarded (``n_speculative``).
  elasticity   on device loss or quarantine the pool shrinks, orphaned
               chunks re-enter the queue and are resharded onto the
               surviving devices (``n_resharded``).
  SDC sentinel silent data corruption raises nothing — the only detector
               is recomputation.  With ``sdc_check_every > 0`` device
               results are buffered per device (deferred fold); every
               check window a seeded sample chunk is recomputed on the
               CPU and compared value for value.  The parity contract
               makes a device's float64 results bit-identical to the
               CPU's, so ANY mismatch is corruption, not roundoff: the
               device is quarantined and its buffered chunks replay on
               healthy devices (``n_corruption_checks`` /
               ``n_corruptions_detected``).

Two deliberate divergences from the reference, both because the port's
chunk ladders end on the card, never on the host (H12 in ROADMAP.md):

  * with every device of the pool quarantined, :func:`run_fleet` raises
    :class:`~repro_torch.explore.resilience.ChunkError`; the reference
    runs the chunk on its host numpy rung instead.
  * the SDC sentinel recomputes its sample chunk under an explicit pin
    to ``torch.device("cpu")`` (the backend's own ladder, placed on the
    CPU); that result is compared, never folded.

Placement rides on a thread-local pin: :func:`pin` marks the submitting
thread's target device, and ``TorchOracleBackend`` places a chunk's
inputs there, launches its program (K1 included) under
``torch.cuda.device`` on that device's current stream, and records its
pending handle's event there.

:func:`visible_devices` is the one sanctioned device enumeration of the
port: every other module reaches devices through it or a
:class:`DevicePool`, so health tracking and quarantine cannot be
bypassed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.seeding import derive_seed
from repro_torch.explore.resilience import (ChunkError, ChunkTask,
                                            CircuitBreaker, ResiliencePolicy,
                                            SweepJournal, SweepKilled)
from repro_torch.train.fault_tolerance import StragglerMonitor

# where the SDC sentinel recomputes its sample chunks
SENTINEL_DEVICE = torch.device("cpu")


# ---------------------------------------------------------------------------
# sanctioned device enumeration
# ---------------------------------------------------------------------------

def visible_devices() -> Tuple[torch.device, ...]:
  """Every CUDA device of this process, as ``torch.device("cuda", i)``.
  The one sanctioned call site of ``torch.cuda.device_count()`` in the
  port: every other module reaches devices through here or a
  :class:`DevicePool`.  Raises when there is no card (it never offers the
  CPU instead)."""
  # repro: ignore[ROB004] no CUDA counts zero cards, and `if not n` raises
  n = torch.cuda.device_count() if torch.cuda.is_available() else 0
  if not n:
    raise RuntimeError("no CUDA device is visible; build a DevicePool with "
                       "an explicit devices= list to run on the CPU")
  return tuple(torch.device("cuda", i) for i in range(n))


def device_topology() -> Dict[str, object]:
  """Provenance-stamp description of the fleet (platform, count, kinds);
  an empty topology when no card is visible."""
  try:
    devs = visible_devices()
  except RuntimeError:
    return {"platform": "none", "n_devices": 0, "device_kinds": []}
  kinds = sorted({torch.cuda.get_device_name(d) for d in devs})
  return {"platform": "gpu", "n_devices": len(devs), "device_kinds": kinds}


# ---------------------------------------------------------------------------
# thread-local device pinning
# ---------------------------------------------------------------------------

_TLS = threading.local()


def pinned_device():
  """The device the current thread's dispatches are pinned to (or None:
  the backend's own device)."""
  return getattr(_TLS, "device", None)


@contextlib.contextmanager
def pin(device):
  """Pin this thread's backend dispatches to ``device``.  Pins nest; the
  previous pin is restored on exit."""
  prev = getattr(_TLS, "device", None)
  _TLS.device = device
  try:
    yield device
  finally:
    _TLS.device = prev


# ---------------------------------------------------------------------------
# the health registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceHealth:
  """Mutable per-device record inside a :class:`DevicePool`."""
  device: object
  breaker: CircuitBreaker
  n_chunks: int = 0            # completed chunks
  n_failures: int = 0          # consecutive failures (resets on success)
  n_dispatched: int = 0
  outstanding: int = 0         # checked-out, not yet checked-in
  n_losses: int = 0            # injected/observed device-lost events

  @property
  def ewma_key(self) -> str:
    return str(id(self))


class DevicePool:
  """Health registry + admission control for a device fleet.

  One pool is shared by every consumer multiplexed over the fleet
  (:func:`run_fleet` sweeps, exploration-service sessions), so the
  quarantine decision reflects the *device*, not any single session's
  luck.  ``devices`` defaults to :func:`visible_devices`; an explicit
  list may name the same device more than once (slots), which is how
  the tests run a pool of several CPU slots.

  ``checkout()`` admits a dispatch on the healthiest available device
  (fewest outstanding shards, breaker willing); ``checkin()`` releases
  it; ``record_latency`` / ``record_success`` / ``record_failure`` feed
  the health state.  ``quarantine()`` force-opens a device's breaker
  (device loss, SDC divergence) — the device rejoins later through the
  breaker's ordinary half-open probe.  Thread-safe.

  ``sdc_check_every`` arms the silent-corruption sentinel in
  :func:`run_fleet`: N > 0 defers folds and re-checks one seeded chunk
  per N buffered results per device; 0 disables buffering entirely.
  """

  def __init__(self, devices: Optional[Iterable[object]] = None, *,
               ewma_alpha: float = 0.25, speculation_factor: float = 4.0,
               sdc_check_every: int = 0, seed: int = 0,
               breaker_threshold: int = 3, breaker_cooldown: int = 8,
               breaker_jitter: int = 2):
    devs = tuple(visible_devices() if devices is None else devices)
    if not devs:
      raise ValueError("DevicePool needs at least one device")
    if speculation_factor <= 1.0:
      raise ValueError(
          f"speculation_factor must exceed 1.0, got {speculation_factor}")
    if sdc_check_every < 0:
      raise ValueError(
          f"sdc_check_every must be >= 0, got {sdc_check_every}")
    self.seed = int(seed)
    self.speculation_factor = float(speculation_factor)
    self.sdc_check_every = int(sdc_check_every)
    self._monitor = StragglerMonitor(alpha=float(ewma_alpha))
    self._health: List[DeviceHealth] = [
        DeviceHealth(d, CircuitBreaker(
            threshold=breaker_threshold, cooldown=breaker_cooldown,
            jitter=breaker_jitter,
            seed=derive_seed("fleet-device", seed, i)))
        for i, d in enumerate(devs)]
    self._lock = threading.Lock()
    # fleet-wide mitigation counters (shared by every consumer)
    self.n_speculative = 0
    self.n_resharded = 0
    self.n_corruption_checks = 0
    self.n_corruptions_detected = 0

  # -- topology -------------------------------------------------------------

  @property
  def n_devices(self) -> int:
    return len(self._health)

  def device(self, i: int):
    return self._health[i].device

  def devices(self) -> Tuple[object, ...]:
    return tuple(h.device for h in self._health)

  # -- admission ------------------------------------------------------------

  def checkout(self, require_idle: bool = False,
               exclude: Tuple[int, ...] = ()) -> Optional[int]:
    """Admit one dispatch: returns the index of the healthiest available
    device (fewest outstanding shards; its breaker consulted exactly
    once), or None when every device refuses.  ``require_idle``
    restricts to devices with nothing in flight (speculation targets)."""
    with self._lock:
      order = sorted(range(len(self._health)),
                     key=lambda i: (self._health[i].outstanding, i))
      for i in order:
        h = self._health[i]
        if i in exclude or (require_idle and h.outstanding):
          continue
        if h.breaker.allow_device():
          h.outstanding += 1
          h.n_dispatched += 1
          return i
    return None

  def checkin(self, i: int) -> None:
    with self._lock:
      self._health[i].outstanding = max(0, self._health[i].outstanding - 1)

  # -- health feed ----------------------------------------------------------

  def record_latency(self, i: int, seconds: float) -> None:
    with self._lock:
      h = self._health[i]
      h.n_chunks += 1
      self._monitor.record(h.ewma_key, float(seconds))

  def record_success(self, i: int) -> None:
    h = self._health[i]
    with self._lock:
      h.n_failures = 0
    h.breaker.record_success()

  def record_failure(self, i: int) -> None:
    h = self._health[i]
    with self._lock:
      h.n_failures += 1
    h.breaker.record_failure()

  def quarantine(self, i: int) -> None:
    """Force-open a device's breaker (loss / corruption); it rejoins via
    the ordinary half-open probe after the seeded cooldown."""
    self._health[i].breaker.trip()

  def lose_device(self, i: int) -> None:
    """A device vanished mid-sweep: quarantine it and count the loss."""
    with self._lock:
      self._health[i].n_losses += 1
    self.quarantine(i)

  # -- fleet statistics -----------------------------------------------------

  def ewma(self, i: int) -> Optional[float]:
    st = self._monitor.hosts.get(self._health[i].ewma_key)
    return float(st.ewma) if st is not None and st.count else None

  def fleet_latency(self) -> Optional[float]:
    """Fleet-median EWMA chunk latency — the straggler reference point
    (a shard is speculated past ``speculation_factor`` x this)."""
    with self._lock:
      med = self._monitor.fleet_median()
    return float(med) if med > 0.0 else None

  def note_speculation(self, n: int = 1) -> None:
    with self._lock:
      self.n_speculative += int(n)

  def note_reshard(self, n: int = 1) -> None:
    with self._lock:
      self.n_resharded += int(n)

  def note_corruption_check(self, n: int = 1) -> None:
    with self._lock:
      self.n_corruption_checks += int(n)

  def note_corruption(self, n: int = 1) -> None:
    with self._lock:
      self.n_corruptions_detected += int(n)

  def counters(self) -> Dict[str, int]:
    """Snapshot of the fleet mitigation counters (cumulative over the
    pool's lifetime; runs diff two snapshots for per-run meta)."""
    with self._lock:
      return {"n_speculative": self.n_speculative,
              "n_resharded": self.n_resharded,
              "n_corruption_checks": self.n_corruption_checks,
              "n_corruptions_detected": self.n_corruptions_detected,
              "n_device_losses": sum(h.n_losses for h in self._health)}

  def meta(self) -> Dict[str, object]:
    """Snapshot for ``StreamResult.meta`` merging: counters plus the
    per-device breaker states and health stats."""
    out: Dict[str, object] = {k: float(v) for k, v in self.counters().items()}
    states = [h.breaker.state for h in self._health]
    out["fleet_devices"] = float(self.n_devices)
    out["fleet_device_states"] = states
    out["n_quarantined_devices"] = float(
        sum(1 for s in states if s != "closed"))
    out["fleet_device_chunks"] = [float(h.n_chunks) for h in self._health]
    out["fleet_device_ewma_s"] = [
        e if e is not None else -1.0
        for e in (self.ewma(i) for i in range(self.n_devices))]
    return out


# ---------------------------------------------------------------------------
# fleet execution
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Shard:
  """One in-flight dispatch: a chunk pinned to one pool device."""
  index: int
  task: ChunkTask
  dev: Optional[int]           # pool device index; None = a host task
  handle: object               # pending handle or immediate result
  t0: float
  immediate: bool              # result needs no resolve()
  slow: bool = False           # injected-slow fault fired at dispatch
  corrupt: bool = False        # injected-corrupt fault fired at dispatch
  speculated: bool = False     # a twin has been launched
  twin: Optional["_Shard"] = None


def _handle_ready(shard: _Shard) -> bool:
  if shard.immediate:
    return True
  fn = getattr(shard.handle, "is_ready", None)
  if fn is None:
    return False
  try:
    return bool(fn())
  except Exception:
    return False


def _corrupt_result(result):
  """Deterministic stand-in for silent device corruption: bump every
  transferred survivor's latency by one ulp (and histogram counts /
  stats means by one quantum).  No exception, values still plausible —
  exactly the failure mode only recomputation can catch."""
  payloads = getattr(result, "payloads", None)
  if payloads is None:
    frame, _ = result
    frame.latency_s = np.nextafter(frame.latency_s, np.inf)
    return result
  for payload in payloads.values():
    kind = payload[0]
    if kind == "rows":
      payload[1].latency_s = np.nextafter(payload[1].latency_s, np.inf)
    elif kind == "hist":
      counts = np.asarray(payload[1])
      if counts.size:
        counts[0] += 1
    elif kind == "stats":
      payload[1]["mean"] = np.nextafter(payload[1].get("mean", 0.0), np.inf)
  return result


def _frame_rows_match(ref_frame, ref_idx: np.ndarray, frame,
                      ids: np.ndarray) -> bool:
  """Do the transferred survivor rows (values at global ids) match the
  reference evaluation bit for bit?"""
  ref_idx = np.asarray(ref_idx, np.int64)
  ids = np.asarray(ids, np.int64)
  if not ids.size:
    return True
  order = np.argsort(ref_idx, kind="stable")
  pos = np.clip(np.searchsorted(ref_idx[order], ids), 0, ref_idx.size - 1)
  pos = order[pos]
  if not np.array_equal(ref_idx[pos], ids):
    return False
  return all(np.array_equal(np.asarray(frame.column(c), np.float64),
                            np.asarray(ref_frame.column(c), np.float64)[pos])
             for c in ("latency_s", "power_mw", "area_mm2"))


def _results_match(result, reference) -> bool:
  """Compare a device chunk result with the sentinel's recomputation of
  the same chunk.  Row-carrying payloads (pareto / top-k survivors, full
  frames) are compared value for value — exact by the parity contract,
  so any mismatch is corruption.  Stats partials are merge-order
  dependent and histogram payloads carry no row ids; both are skipped —
  every default reduction plan ships row payloads, which carry all
  transferred values."""
  ref_frame, ref_idx = reference
  payloads = getattr(result, "payloads", None)
  if payloads is None:
    frame, ids = result
    return _frame_rows_match(ref_frame, ref_idx, frame, ids)
  for payload in payloads.values():
    if payload[0] == "rows":
      if not _frame_rows_match(ref_frame, ref_idx, payload[1], payload[2]):
        return False
  return True


def run_fleet(tasks: Iterable[ChunkTask], reducers: Dict[str, object],
              pool: DevicePool, *,
              policy: Optional[ResiliencePolicy] = None,
              dispatch_ahead: Optional[int] = None,
              resume_from=None, journal_key: str = "",
              checkpoint_every: int = 1):
  """Drain ``tasks`` across the pool's devices, folding every reducer in
  chunk-index order — the fleet analogue of
  :func:`repro_torch.explore.streaming.run_stream` (same journaling,
  same failure semantics, same ``StreamResult`` shape) with health-aware
  sharding, straggler speculation, elastic resharding, and the SDC
  sentinel layered on top.  Results wait in a reorder buffer until every
  earlier chunk has folded, so the folds, stats included, equal a solo
  single-device run's bit for bit.  A chunk with a device rung that no
  device of the pool admits raises :class:`ChunkError` (H13).
  """
  # deferred: streaming imports this module lazily (pool= routing)
  from repro_torch.explore.streaming import (DISPATCH_AHEAD, StreamResult,
                                             fold_chunk, new_counters)
  if dispatch_ahead is None:
    dispatch_ahead = DISPATCH_AHEAD
  t0 = time.perf_counter()
  plan = policy.fault_plan if policy is not None else None
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
  base_fleet = pool.counters()
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

  def fail(index, exc):
    checkpoint(force=True)
    if isinstance(exc, ChunkError):
      raise exc
    raise ChunkError(index, f"{type(exc).__name__}: {exc}") from exc

  def execute(task):
    if policy is not None:
      return policy.execute(task)
    return task()

  def recompute_on_cpu(task: ChunkTask):
    """The sentinel's reference: the chunk's terminal rung under an
    explicit pin to the CPU.  Compared, never folded."""
    with pin(SENTINEL_DEVICE):
      if policy is not None:
        out = policy.execute_from(task, len(task.rungs) - 1)
      else:
        out = task.rungs[-1].fn()
      if hasattr(out, "resolve"):
        out = out.resolve()
    return out

  # the reorder buffer: results wait here until every earlier chunk of
  # the source order has folded
  order: "deque" = deque()          # chunk indices in source order
  ready: Dict[int, object] = {}     # index -> result awaiting its turn

  def fold_in_order() -> None:
    while order and order[0] in ready:
      index = order.popleft()
      try:
        fold_chunk(reducers, counters, ready.pop(index))
      except Exception as e:
        fail(index, e)
      done_chunks.add(index)
      checkpoint()

  def accept(index, result) -> None:
    ready[index] = result
    fold_in_order()

  def indexed(ts) -> Iterator[Tuple[int, ChunkTask]]:
    for i, t in enumerate(ts):
      index = getattr(t, "index", i)
      if index in done_chunks:
        continue
      order.append(index)
      yield index, t

  source = indexed(tasks)
  queue: "deque" = deque()        # requeued (orphaned / replayed) chunks
  inflight: List[_Shard] = []
  # dev index -> [(chunk index, task, resolved result)] awaiting the
  # sentinel's validation before folding (sdc_check_every > 0 only)
  buffers: Dict[int, List[Tuple[int, ChunkTask, object]]] = {}
  sdc_rng = np.random.RandomState(derive_seed("fleet-sdc", pool.seed))
  window_cap = max(1, pool.n_devices) * max(int(dispatch_ahead), 1)

  def next_item() -> Optional[Tuple[int, ChunkTask]]:
    if queue:
      return queue.popleft()
    if len(inflight) + len(ready) >= window_cap:
      return None  # the reorder buffer is full: wait for the oldest
    return next(source, None)

  def dispatch(index: int, task: ChunkTask) -> None:
    has_device_rung = any(r.layer == "device"
                          for r in getattr(task, "rungs", ()))
    dev = pool.checkout() if has_device_rung else None
    if has_device_rung and dev is None:
      # every device quarantined: the port's ladders end on the device
      # (H12), so there is no host rung to fall back to (H13)
      fail(index, ChunkError(index, f"every device of the pool "
                             f"({pool.n_devices}) is quarantined"))
    slow = corrupt = False
    if dev is not None and plan is not None:
      kind = plan.check_fleet(dev, index)
      if kind == "device-lost":
        # the device vanished at this chunk boundary: quarantine it,
        # orphan its in-flight shards, reshard everything onto the rest
        pool.checkin(dev)
        pool.lose_device(dev)
        requeued = 1  # the chunk we were about to dispatch
        for s in [s for s in inflight if s.dev == dev]:
          inflight.remove(s)
          pool.checkin(dev)
          if s.twin is not None:
            # a twin on another device carries the chunk — don't
            # requeue, or the chunk would fold twice
            s.twin.twin = None
            continue
          queue.appendleft((s.index, s.task))
          requeued += 1
        buf = buffers.pop(dev, [])
        for i, t, _ in reversed(buf):
          queue.appendleft((i, t))
        pool.note_reshard(requeued + len(buf))
        queue.appendleft((index, task))
        return
      slow = kind == "slow"
      corrupt = kind == "corrupt"
    start = time.perf_counter()
    try:
      if dev is not None:
        with pin(pool.device(dev)):
          out = execute(task)
      else:
        out = execute(task)
    except SweepKilled as e:
      if dev is not None:
        pool.checkin(dev)
      fail(index, e)
    except Exception as e:
      if dev is not None:
        pool.checkin(dev)
        pool.record_failure(dev)
      fail(index, e)
    inflight.append(_Shard(index, task, dev, out, start,
                           immediate=not hasattr(out, "resolve"),
                           slow=slow, corrupt=corrupt))

  def try_speculate() -> None:
    """Twin the slowest straggler onto an idle healthy device.  A shard
    counts as a straggler when its injected-slow fault fired, or when it
    is unready past ``speculation_factor`` x the fleet-median EWMA
    latency.  The first result wins; the other is discarded."""
    fleet_lat = pool.fleet_latency()
    now = time.perf_counter()
    for shard in inflight:
      if shard.speculated or shard.twin is not None or shard.dev is None:
        continue
      straggling = shard.slow
      if not straggling:
        if fleet_lat is None or _handle_ready(shard):
          continue
        straggling = (now - shard.t0) > pool.speculation_factor * fleet_lat
      if not straggling:
        continue
      alt = pool.checkout(require_idle=True, exclude=(shard.dev,))
      if alt is None:
        continue
      shard.speculated = True
      try:
        with pin(pool.device(alt)):
          out = execute(shard.task)
      except SweepKilled as e:
        pool.checkin(alt)
        fail(shard.index, e)
      except Exception:
        # the speculation failed, the original is still in flight —
        # mitigation must never make things worse
        pool.checkin(alt)
        pool.record_failure(alt)
        continue
      twin = _Shard(shard.index, shard.task, alt, out, now,
                    immediate=not hasattr(out, "resolve"),
                    corrupt=shard.corrupt)
      twin.twin = shard
      shard.twin = twin
      inflight.append(twin)
      pool.note_speculation()
      return

  def validate(dev: int, force: bool = False) -> None:
    """The SDC sentinel: once a device has ``sdc_check_every`` buffered
    results (or at the final flush), recompute one seeded sample chunk
    on the CPU and compare.  A match releases the whole buffer to the
    reorder buffer; a divergence quarantines the device and replays its
    chunks."""
    buf = buffers.get(dev)
    if not buf:
      return
    if not force and len(buf) < pool.sdc_check_every:
      return
    pick = int(sdc_rng.randint(len(buf)))
    index, task, result = buf[pick]
    pool.note_corruption_check()
    try:
      reference = recompute_on_cpu(task)
    except Exception as e:
      fail(index, e)
    if _results_match(result, reference):
      released = list(buf)
      buf.clear()
      for i, _, r in released:
        accept(i, r)
      return
    pool.note_corruption()
    pool.quarantine(dev)
    pool.note_reshard(len(buf))
    for i, t, _ in reversed(buf):
      queue.appendleft((i, t))
    buf.clear()

  def finish(shard: _Shard) -> None:
    inflight.remove(shard)
    twin = shard.twin
    if twin is not None:
      # keep-first: the twin's result is abandoned; its device work
      # drains harmlessly
      if twin in inflight:
        inflight.remove(twin)
      if twin.dev is not None:
        pool.checkin(twin.dev)
      shard.twin = twin.twin = None
    try:
      result = shard.handle if shard.immediate else shard.handle.resolve()
    except SweepKilled as e:
      if shard.dev is not None:
        pool.checkin(shard.dev)
      fail(shard.index, e)
    except Exception as e:
      if shard.dev is not None:
        pool.checkin(shard.dev)
        pool.record_failure(shard.dev)
      fail(shard.index, e)
    if shard.dev is None:
      accept(shard.index, result)
      return
    pool.checkin(shard.dev)
    pool.record_latency(shard.dev, time.perf_counter() - shard.t0)
    pool.record_success(shard.dev)
    if shard.corrupt:
      result = _corrupt_result(result)
    if pool.sdc_check_every > 0:
      buffers.setdefault(shard.dev, []).append(
          (shard.index, shard.task, result))
      validate(shard.dev)
    else:
      accept(shard.index, result)

  while True:
    while len(inflight) < window_cap:
      item = next_item()       # requeued chunks first, then the source
      if item is None:
        break
      dispatch(*item)
    if inflight:
      try_speculate()
      shard = next((s for s in inflight if _handle_ready(s)), None)
      finish(shard if shard is not None else inflight[0])
      continue
    if queue:
      continue                 # device-lost replays still pending
    if any(buffers.values()):
      for dev in list(buffers):
        validate(dev, force=True)
      continue  # a failed validation requeues chunks
    # nothing in flight, queued or buffered: every dispatched chunk has
    # passed the reorder buffer, and the source is spent
    break

  checkpoint(force=True)
  seconds = time.perf_counter() - t0
  n_retries, n_demotions = totals()
  fleet_now = pool.counters()
  meta = {"seconds": seconds, "workers": 1.0,
          "n_chunks": float(counters["n_chunks"]),
          "rows_transferred": float(counters["n_transferred"]),
          "rows_per_sec": counters["n_rows"] / max(seconds, 1e-12),
          "n_retries": float(n_retries),
          "n_demotions": float(n_demotions),
          "n_resumed_chunks": float(n_resumed),
          "n_overflows": float(counters["n_overflows"])}
  # per-run deltas of the (pool-lifetime) mitigation counters
  meta.update({k: float(fleet_now[k] - base_fleet[k]) for k in fleet_now})
  pool_meta = pool.meta()
  for k in ("fleet_devices", "fleet_device_states",
            "n_quarantined_devices", "fleet_device_chunks",
            "fleet_device_ewma_s"):
    meta[k] = pool_meta[k]
  if policy is not None:
    meta["n_leaked_watchdogs"] = float(policy.watchdogs.n_live())
    if policy.breaker is not None:
      meta.update(policy.breaker.meta())
  return StreamResult(
      results={name: r.result() for name, r in reducers.items()},
      n_rows=counters["n_rows"], seconds=seconds, meta=meta)
