"""Fault tolerance for long exploration runs: retry, degradation,
checkpoint/resume, and deterministic fault injection (the port of
``repro.explore.resilience``, whole).

A 10M-pair streamed co-exploration or a long guided-search run must
survive the transient failures any long-lived service sees: device
errors, out-of-memory, hung resolutions, worker exceptions, whole-process
kills.  Everything here leans on one structural fact: a chunk is a pure
function of ``(space, chunk_index, seed)``, so re-evaluating it — on any
rung of the ladder, in any later process — is bit-identical.  That turns
fault tolerance into bookkeeping:

  retry        :class:`RetryPolicy` — seeded, bounded exponential
               backoff around each rung dispatch, built on the single
               retry primitive :func:`repro_torch.train.fault_tolerance.
               retrying` (injectable ``sleep`` — tests never wall-wait)
  degradation  :class:`ResiliencePolicy` — a per-chunk fallback ladder
               (each rung a :class:`Rung` inside a :class:`ChunkTask`);
               exhausted retries or a watchdogged/hung resolution demote
               to the next rung.  Every demotion is counted and surfaced
               in ``StreamResult.meta``.
  resume       reducer ``snapshot()/restore()`` state serialized by a
               :class:`SweepJournal` — a content-addressed checkpoint
               store keyed by (design-space hash, oracle version,
               reducer plan, sweep params).  ``run_stream`` /
               ``stream_explore`` / ``stream_co_explore`` /
               ``guided_search`` accept ``resume_from=`` and skip
               chunks already folded; chunk-order invariance of the
               reducers makes the resumed final fronts bit-identical to
               an uninterrupted run.
  injection    :class:`FaultPlan` — seeded schedules of raise / hang /
               kill-at-chunk-k faults installable at the task, device,
               and backend layers; the tests drive every path above
               through it deterministically.

**The terminal rung differs from the reference's, on purpose.**  The
reference's ladders end at a ``numpy`` rung on the host, which "has no
device failure modes".  The port's ladders (built in
:mod:`repro_torch.explore.streaming`) end at the backend's own unfused
``device`` rung: ``fused-device -> device`` on a torch backend, the
backend's ``evaluate_table`` otherwise.  A CPU rung under a card backend
would be a fallback that hides the device, so:

  * under a card backend, a chunk that fails on every card rung raises
    :class:`ChunkError`; it never moves to the CPU;
  * the same ladder under ``device="cpu"`` runs on the CPU;
  * :meth:`ResiliencePolicy.execute_from` moves only along the ladder it
    is given, and the circuit breaker skips, and counts, only the
    non-terminal rungs (H16: with the breaker open, chunks go straight
    to the terminal rung, the card's own under a card backend);
  * results stay bit-identical on every rung, because every rung is the
    same exact oracle (``parity_max_rel_err == 0.0``).

The journal is backend-agnostic: snapshots hold host numpy arrays and
Python values only, never a ``torch.Tensor``, so a sweep checkpointed on
the card resumes on the CPU and the reverse.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
import io
import os
import pickle
import struct
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import oracle
from repro_torch.core.seeding import derive_seed
from repro_torch.train.fault_tolerance import StepFailure, retrying


# ---------------------------------------------------------------------------
# failure taxonomy
# ---------------------------------------------------------------------------

class FaultInjected(RuntimeError):
  """A :class:`FaultPlan`-injected transient fault.  Subclasses
  RuntimeError so the default retry policy treats it exactly like a real
  transient device error."""


class SweepKilled(Exception):
  """A :class:`FaultPlan`-injected process death.  Deliberately NOT a
  RuntimeError: no retry policy or ladder rung may absorb it — it must
  abort the run the way a real kill would, leaving only the journal."""


class ChunkTimeout(RuntimeError):
  """A pending chunk resolution exceeded the watchdog timeout."""


class InjectedHang(ChunkTimeout):
  """Deterministic stand-in for a hung resolution: raised at the
  resolve point *instead of* blocking, so tests exercise the demotion
  path without consuming the watchdog's wall-clock budget."""


class ChunkError(RuntimeError):
  """A chunk failed fatally.  Carries the chunk's global index so a
  caller (or operator) knows exactly where the sweep stopped."""

  def __init__(self, chunk_index: int, message: str = ""):
    self.chunk_index = int(chunk_index)
    detail = f": {message}" if message else ""
    super().__init__(f"chunk {self.chunk_index} failed{detail}")


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

FAULT_KINDS = ("raise", "hang", "kill", "slow", "corrupt", "device-lost")
FAULT_LAYERS = ("task", "device", "backend", "fleet")

# fleet-layer faults fire at shard granularity inside the fleet's
# dispatch loop, not in the per-chunk ladder: a slow shard triggers
# speculation, a corrupt shard exercises the SDC sentinel, a lost device
# exercises elastic resharding (see repro_torch.explore.fleet)
FLEET_FAULT_KINDS = ("slow", "corrupt", "device-lost")

# wildcard chunk for fleet faults: fires at ANY chunk dispatched on the
# targeted device (until ``times`` is spent) — how a persistently sick
# device is modeled
ANY_CHUNK = -1


@dataclasses.dataclass(frozen=True)
class Fault:
  """One scheduled fault: ``kind`` fires at chunk ``chunk`` when the
  ladder touches ``layer``, at most ``times`` times (a transient with
  ``times <= max_retries`` is healed by retry alone; a larger budget
  forces a demotion).  Fleet-layer faults additionally carry the
  targeted pool ``device`` index (None: any device) and may use the
  ``ANY_CHUNK`` wildcard."""
  kind: str
  chunk: int
  layer: str = "task"
  times: int = 1
  device: Optional[int] = None

  def __post_init__(self):
    if self.kind not in FAULT_KINDS:
      raise ValueError(f"unknown fault kind {self.kind!r}")
    if self.layer not in FAULT_LAYERS:
      raise ValueError(f"unknown fault layer {self.layer!r}")
    if self.times <= 0:
      raise ValueError(f"times must be positive, got {self.times}")
    if (self.kind in FLEET_FAULT_KINDS) != (self.layer == "fleet"):
      raise ValueError(f"fault kind {self.kind!r} and layer {self.layer!r} "
                       "mismatch: slow/corrupt/device-lost are fleet-layer "
                       "faults (and only those are)")
    if self.layer != "fleet":
      if self.device is not None:
        raise ValueError("device targeting is fleet-layer only")
      if self.chunk < 0:
        raise ValueError("the ANY_CHUNK wildcard is fleet-layer only")


class FaultPlan:
  """A deterministic schedule of injected faults.

  Installed on a :class:`ResiliencePolicy`; the policy consults the plan
  at each rung dispatch (``check``) and each pending resolution
  (``check_resolve``).  Thread-safe (the watchdog resolves on helper
  threads) and exactly reproducible: the same plan against the same
  sweep fires the same faults at the same chunks.
  """

  def __init__(self, faults: Iterable[Fault] = ()):
    self.faults: Tuple[Fault, ...] = tuple(faults)
    self._remaining = [f.times for f in self.faults]
    self.n_fired = 0
    self._lock = threading.Lock()

  @classmethod
  def seeded(cls, seed: int, n_chunks: int, p_raise: float = 0.25,
             p_hang: float = 0.0, p_kill: float = 0.0,
             layer: str = "device", times: int = 1) -> "FaultPlan":
    """Random-but-reproducible schedule: per chunk, independent draws
    decide whether a raise / hang / kill fault is planted (hangs always
    target the device layer — that is where resolutions block)."""
    rng = np.random.RandomState(derive_seed("fault-plan", seed))
    faults: List[Fault] = []
    for chunk in range(int(n_chunks)):
      u = rng.random_sample(3)
      if u[0] < p_raise:
        faults.append(Fault("raise", chunk, layer, times))
      if u[1] < p_hang:
        faults.append(Fault("hang", chunk, "device", times))
      if u[2] < p_kill:
        faults.append(Fault("kill", chunk, layer, times))
    return cls(faults)

  def _fire(self, layer: str, chunk: int,
            kinds: Tuple[str, ...]) -> Optional[str]:
    with self._lock:
      for i, f in enumerate(self.faults):
        if (f.chunk == chunk and f.layer == layer and f.kind in kinds
            and self._remaining[i] > 0):
          self._remaining[i] -= 1
          self.n_fired += 1
          return f.kind
    return None

  def check(self, layer: str, chunk: int) -> None:
    """Dispatch-point hook: raises the scheduled fault, if any."""
    kind = self._fire(layer, chunk, ("kill", "raise"))
    if kind == "kill":
      raise SweepKilled(f"injected kill at {layer} layer, chunk {chunk}")
    if kind == "raise":
      raise FaultInjected(f"injected fault at {layer} layer, chunk {chunk}")

  def check_resolve(self, layer: str, chunk: int) -> None:
    """Resolution-point hook: a scheduled hang raises
    :class:`InjectedHang` instead of blocking."""
    if self._fire(layer, chunk, ("hang",)):
      raise InjectedHang(f"injected hang at {layer} layer, chunk {chunk}")

  def check_fleet(self, device: int, chunk: int) -> Optional[str]:
    """Shard-dispatch hook for the fleet layer: returns the fired fault
    kind (``slow`` / ``corrupt`` / ``device-lost``) when a fleet fault
    targets this (device, chunk) pair — device None and the
    ``ANY_CHUNK`` wildcard match anything — else None.  The fleet
    executor acts on the kind; nothing is raised here."""
    with self._lock:
      for i, f in enumerate(self.faults):
        if f.layer != "fleet" or self._remaining[i] <= 0:
          continue
        if f.chunk not in (chunk, ANY_CHUNK):
          continue
        if f.device is not None and f.device != int(device):
          continue
        self._remaining[i] -= 1
        self.n_fired += 1
        return f.kind
    return None

  @classmethod
  def seeded_fleet(cls, seed: int, n_chunks: int, n_devices: int,
                   p_slow: float = 0.0, p_corrupt: float = 0.0,
                   p_lost: float = 0.0, times: int = 1) -> "FaultPlan":
    """Random-but-reproducible fleet chaos: at every chunk boundary,
    independent draws decide whether a seeded random device is slowed,
    corrupted, or lost at that chunk."""
    rng = np.random.RandomState(derive_seed("fleet-fault-plan", seed))
    faults: List[Fault] = []
    for chunk in range(int(n_chunks)):
      u = rng.random_sample(3)
      dev = int(rng.randint(max(1, int(n_devices))))
      if u[0] < p_slow:
        faults.append(Fault("slow", chunk, "fleet", times, device=dev))
      if u[1] < p_corrupt:
        faults.append(Fault("corrupt", chunk, "fleet", times, device=dev))
      if u[2] < p_lost:
        faults.append(Fault("device-lost", chunk, "fleet", times,
                            device=dev))
    return cls(faults)


# ---------------------------------------------------------------------------
# retry policy (thin, injectable wrapper over train.fault_tolerance)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RetryPolicy:
  """Bounded exponential-backoff retry for one rung dispatch.

  Delegates to :func:`repro_torch.train.fault_tolerance.retrying`, so
  there is exactly one retry semantics in the stack.  ``sleep`` is
  injectable; tests pass a no-op and never wall-wait."""
  max_retries: int = 2
  base_delay: float = 0.01
  backoff: float = 2.0
  sleep: Callable[[float], None] = time.sleep
  retry_exceptions: Tuple = (RuntimeError,)

  def call(self, fn: Callable[[], object],
           on_retry: Optional[Callable[[int, Exception], None]] = None):
    """Run ``fn`` with retries; raises
    :class:`~repro_torch.train.fault_tolerance.StepFailure` on
    exhaustion.
    ``on_retry(attempt, exc)`` fires only for failures that will
    actually be retried, so it counts re-executions exactly."""
    def note(attempt: int, exc: Exception) -> None:
      if on_retry is not None and attempt < self.max_retries:
        on_retry(attempt, exc)
    return retrying(fn, max_retries=self.max_retries, on_failure=note,
                    retry_exceptions=self.retry_exceptions,
                    sleep=self.sleep, base_delay=self.base_delay,
                    backoff=self.backoff)()


# ---------------------------------------------------------------------------
# the degradation ladder
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Rung:
  """One way to evaluate a chunk.  ``fn`` returns either the plain
  ``(frame, indices)`` pair or a pending handle with ``resolve()``;
  ``layer`` is the :class:`FaultPlan` layer this rung dispatches
  through."""
  name: str
  fn: Callable[[], object]
  layer: str = "backend"


@dataclasses.dataclass(frozen=True)
class ChunkTask:
  """A chunk plus its fallback ladder, best rung first.  Calling the
  task directly (no policy installed) runs the best rung only — the
  zero-overhead healthy path the engine used before resilience."""
  index: int
  rungs: Tuple[Rung, ...]

  def __call__(self):
    return self.rungs[0].fn()


BREAKER_STATES = ("closed", "open", "half-open")


class CircuitBreaker:
  """Device-rung circuit breaker for the degradation ladder.

  The per-chunk ladder already heals individual device failures by
  demotion, but when the device rung is *persistently* sick (a wedged
  runtime, a device stuck in a crash loop) every chunk still pays the full
  retry + watchdog budget before falling back.  The breaker converts
  that into a fleet-level decision: after ``threshold`` consecutive
  device-rung failures it **opens** and new chunks skip the non-terminal
  device rungs (straight to the ladder's terminal rung — bit-identical
  by the parity contract; in the port that rung is the backend's own
  unfused one, never a CPU rung under a card backend).  After a seeded
  cooldown — ``cooldown`` chunks plus a deterministic jitter drawn from ``seed`` so concurrent services
  don't re-probe in lockstep — it goes **half-open** and lets exactly
  one probe chunk try the device rung; success closes the breaker,
  failure re-opens it.  Every transition is recorded (and surfaced in
  ``StreamResult.meta``) as ``(event_count, from_state, to_state)``.

  Thread-safe; one breaker is shared by all sessions multiplexed over a
  device executor so the open/closed decision reflects the device, not
  any single session's luck.
  """

  def __init__(self, threshold: int = 3, cooldown: int = 8,
               jitter: int = 2, seed: int = 0):
    if threshold < 1:
      raise ValueError(f"threshold must be >= 1, got {threshold}")
    if cooldown < 1:
      raise ValueError(f"cooldown must be >= 1, got {cooldown}")
    if jitter < 0:
      raise ValueError(f"jitter must be >= 0, got {jitter}")
    self.threshold = int(threshold)
    self.cooldown = int(cooldown)
    self.jitter = int(jitter)
    self._rng = np.random.RandomState(derive_seed("circuit-breaker", seed))
    self.state = "closed"
    self.n_opens = 0
    self.n_short_circuits = 0
    self.n_probes = 0
    self.transitions: List[Tuple[int, str, str]] = []
    self._failures = 0
    self._cooldown_left = 0
    self._probing = False
    self._events = 0
    self._lock = threading.Lock()

  def _to(self, state: str) -> None:
    self.transitions.append((self._events, self.state, state))
    self.state = state

  def _arm_cooldown(self) -> None:
    extra = int(self._rng.randint(0, self.jitter + 1)) if self.jitter else 0
    self._cooldown_left = self.cooldown + extra

  def allow_device(self) -> bool:
    """Consulted once per chunk ladder that has device rungs: may this
    chunk dispatch on the device?  While open, each refusal counts down
    the cooldown; when it reaches zero the breaker turns half-open and
    admits a single probe."""
    with self._lock:
      self._events += 1
      if self.state == "closed":
        return True
      if self.state == "open":
        self._cooldown_left -= 1
        if self._cooldown_left > 0:
          self.n_short_circuits += 1
          return False
        self._to("half-open")
        self._probing = False
      # half-open: one probe in flight at a time
      if self._probing:
        self.n_short_circuits += 1
        return False
      self._probing = True
      self.n_probes += 1
      return True

  def record_failure(self) -> None:
    """A device-rung dispatch or resolution failed (demotion/timeout)."""
    with self._lock:
      self._events += 1
      if self.state == "half-open":
        self._probing = False
        self._to("open")
        self.n_opens += 1
        self._arm_cooldown()
      elif self.state == "closed":
        self._failures += 1
        if self._failures >= self.threshold:
          self._to("open")
          self.n_opens += 1
          self._arm_cooldown()

  def trip(self) -> None:
    """Force the breaker open immediately — the fleet layer's verdicts
    (device lost, SDC divergence) are not "consecutive failures" to be
    counted but standing evidence; the device still rejoins through the
    ordinary half-open probe after the seeded cooldown."""
    with self._lock:
      self._events += 1
      self._failures = 0
      self._probing = False
      if self.state != "open":
        self._to("open")
        self.n_opens += 1
      self._arm_cooldown()

  def record_success(self) -> None:
    """A device-rung chunk completed (dispatch + resolution)."""
    with self._lock:
      self._events += 1
      if self.state == "half-open":
        self._probing = False
        self._failures = 0
        self._to("closed")
      elif self.state == "closed":
        self._failures = 0

  def meta(self) -> Dict[str, object]:
    """Snapshot for ``StreamResult.meta`` merging."""
    with self._lock:
      return {
          "breaker_state": self.state,
          "n_breaker_opens": float(self.n_opens),
          "n_breaker_short_circuits": float(self.n_short_circuits),
          "n_breaker_probes": float(self.n_probes),
          "breaker_transitions": list(self.transitions),
      }


class WatchdogRegistry:
  """Bookkeeping for the watchdog helper threads of
  :meth:`ResiliencePolicy._timed_resolve`.

  A watchdogged resolution that outlives its bounded join used to be
  abandoned: the daemon thread kept running with no reference anywhere —
  invisible to shutdown, impossible to count, a genuine leak under a
  long-lived service that demotes often.  The registry keeps every live
  watchdog referenced, reaps the ones that have since finished, and
  reports the still-running remainder as ``n_leaked_watchdogs`` in
  ``StreamResult.meta`` (0 on every healthy run — asserted in tests).
  Thread-safe."""

  def __init__(self):
    self._threads: List[threading.Thread] = []
    self._lock = threading.Lock()
    self.n_spawned = 0
    self.n_reaped = 0

  def _reap_locked(self) -> None:
    live = [t for t in self._threads if t.is_alive()]
    self.n_reaped += len(self._threads) - len(live)
    self._threads = live

  def track(self, t: threading.Thread) -> None:
    with self._lock:
      self.n_spawned += 1
      self._threads.append(t)
      self._reap_locked()

  def n_live(self) -> int:
    """Reap finished watchdogs, then count the still-running ones."""
    with self._lock:
      self._reap_locked()
      return len(self._threads)

  def drain(self, timeout: float = 0.1) -> int:
    """Bounded-join every live watchdog (service shutdown); returns how
    many are still running afterwards."""
    with self._lock:
      threads = list(self._threads)
    for t in threads:
      t.join(timeout)
    return self.n_live()


class ResiliencePolicy:
  """Executes :class:`ChunkTask` ladders with retry, demotion, and an
  optional resolution watchdog.

  Per rung: dispatch under :class:`RetryPolicy`; if retries exhaust (or
  a pending resolution later fails/hangs), demote to the next rung.  A
  failure on the terminal rung is fatal (the engine raises
  :class:`ChunkError`): the port's terminal rung is the backend's own
  unfused rung, on the card under a card backend.  Demotion preserves
  bit-identity: whichever rung computes a chunk, the exact-codegen
  parity contract makes the folded rows identical.  ``n_retries`` /
  ``n_demotions`` are totalled here and surfaced in
  ``StreamResult.meta``.  :class:`SweepKilled` is never absorbed.
  """

  def __init__(self, retry: Optional[RetryPolicy] = None,
               fault_plan: Optional[FaultPlan] = None,
               resolve_timeout: Union[None, float,
                                      Callable[[], Optional[float]]] = None,
               breaker: Optional[CircuitBreaker] = None):
    self.retry = RetryPolicy() if retry is None else retry
    self.fault_plan = fault_plan
    # either a fixed budget or a callable evaluated at each resolve —
    # the service layer passes ``lambda: min(base, deadline.remaining())``
    # so per-request deadlines reach the watchdog without new plumbing
    self.resolve_timeout = resolve_timeout
    self.breaker = breaker
    self.watchdogs = WatchdogRegistry()
    self.n_retries = 0
    self.n_demotions = 0
    self.demotions: List[Tuple[int, str, str]] = []  # (chunk, rung, why)
    self._lock = threading.Lock()

  # -- accounting -----------------------------------------------------------

  def _note_retry(self) -> None:
    with self._lock:
      self.n_retries += 1

  def _note_demotion(self, chunk: int, rung: str, why: str) -> None:
    with self._lock:
      self.n_demotions += 1
      self.demotions.append((chunk, rung, why))

  # -- execution ------------------------------------------------------------

  def execute(self, task):
    """Run a task through its ladder.  Plain callables (no ladder) pass
    straight through so legacy task iterables keep working."""
    if not isinstance(task, ChunkTask):
      return task()
    return self._run_ladder(task, 0)

  def execute_from(self, task, start: int):
    """Run a task's ladder from rung ``start`` onward (clamped to the
    ladder: it moves only along the rungs the task carries, never to a
    rung of another device).  The breaker is not consulted, matching
    demotion semantics."""
    if not isinstance(task, ChunkTask):
      return task()
    return self._run_ladder(task, max(0, min(int(start),
                                             len(task.rungs) - 1)))

  def _attempt(self, task: ChunkTask, rung: Rung) -> Callable[[], object]:
    def attempt():
      if self.fault_plan is not None:
        self.fault_plan.check("task", task.index)
        if rung.layer != "task":
          self.fault_plan.check(rung.layer, task.index)
      return rung.fn()
    return attempt

  def _run_ladder(self, task: ChunkTask, start: int):
    last: Optional[Exception] = None
    skip_device = False
    if (self.breaker is not None and start == 0
        and any(r.layer == "device" for r in task.rungs)):
      skip_device = not self.breaker.allow_device()
    for r in range(start, len(task.rungs)):
      rung = task.rungs[r]
      # the breaker guards the rungs it can route past: the non-terminal
      # device rungs.  The terminal rung is the ladder's safe harbor (the
      # reference's host rung, the port's own unfused rung) and feeds it
      # nothing, or its successes would reset a failing fused rung's
      # streak on every chunk
      guarded = (rung.layer == "device" and r + 1 < len(task.rungs)
                 and self.breaker is not None)
      if skip_device and guarded:
        continue  # breaker open: route straight past the device rungs
      try:
        out = self.retry.call(self._attempt(task, rung),
                              on_retry=lambda a, e: self._note_retry())
      except StepFailure as e:
        if guarded:
          self.breaker.record_failure()
        if r + 1 < len(task.rungs):
          self._note_demotion(task.index, rung.name, "dispatch")
          last = e
          continue
        raise
      if hasattr(out, "resolve") and r + 1 < len(task.rungs):
        return _GuardedPending(self, task, r, out)
      if guarded:
        self.breaker.record_success()
      return out
    raise StepFailure(f"chunk {task.index}: every ladder rung "
                      "exhausted") from last  # pragma: no cover

  def _timed_resolve(self, handle):
    """Resolve a pending handle under the watchdog: the resolution runs
    on a daemon helper thread and a bounded join decides whether it hung
    (the abandoned thread keeps draining the device queue harmlessly —
    its result is discarded and the chunk recomputed on a lower rung).
    Torch's current CUDA device and stream are per thread, so the helper
    resolves on the handle's own device and stream (its ``device`` and
    ``stream`` attributes, where it has them)."""
    timeout = (self.resolve_timeout() if callable(self.resolve_timeout)
               else self.resolve_timeout)
    if timeout is None:
      return handle.resolve()
    if timeout <= 0.0:
      # deadline already spent: abandon without starting a helper thread
      raise ChunkTimeout("resolution budget exhausted before resolve")
    box: List[Tuple[str, object]] = []

    def run():
      try:
        with _handle_context(handle):
          box.append(("ok", handle.resolve()))
      except BaseException as e:  # relayed to the watchdog thread below
        box.append(("err", e))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    if not box:
      # the helper is still running: keep it referenced (and countable)
      # instead of abandoning it — see WatchdogRegistry
      self.watchdogs.track(t)
      raise ChunkTimeout(
          f"resolution exceeded the {timeout}s watchdog")
    tag, val = box[0]
    if tag == "err":
      raise val
    return val


def _handle_context(handle) -> contextlib.AbstractContextManager:
  """The CUDA device and stream a pending handle was dispatched on, as a
  context for a helper thread (a no-op for host handles)."""
  device = getattr(handle, "device", None)
  if device is None or torch.device(device).type != "cuda":
    return contextlib.nullcontext()
  stack = contextlib.ExitStack()
  stack.enter_context(torch.cuda.device(device))
  stream = getattr(handle, "stream", None)
  if stream is not None:
    stack.enter_context(torch.cuda.stream(stream))
  return stack


class _GuardedPending:
  """Wraps a device pending handle issued by a non-terminal rung: the
  resolution goes through the fault plan and the watchdog, and any
  transient failure demotes to the remaining rungs synchronously."""

  def __init__(self, policy: ResiliencePolicy, task: ChunkTask,
               rung_pos: int, handle):
    self._policy = policy
    self._task = task
    self._pos = rung_pos
    self._handle = handle

  def is_ready(self) -> bool:
    """Non-blocking readiness (fleet straggler polling): delegates to
    the wrapped handle; handles without readiness report False."""
    fn = getattr(self._handle, "is_ready", None)
    if fn is None:
      return False
    try:
      return bool(fn())
    except Exception:
      return False

  def resolve(self):
    policy, task = self._policy, self._task
    rung = task.rungs[self._pos]
    demotable = (ChunkTimeout, StepFailure) + policy.retry.retry_exceptions
    try:
      if policy.fault_plan is not None:
        policy.fault_plan.check_resolve(rung.layer, task.index)
      val = policy._timed_resolve(self._handle)
    except SweepKilled:
      raise
    except demotable:
      # hung or failed resolution: recompute on the remaining rungs —
      # the chunk is a pure function of its index, so whichever rung
      # finishes it, the folded rows are bit-identical
      if rung.layer == "device" and policy.breaker is not None:
        policy.breaker.record_failure()
      policy._note_demotion(task.index, rung.name, "resolve")
      out = policy._run_ladder(task, self._pos + 1)
      if hasattr(out, "resolve"):
        out = out.resolve()
      return out
    if rung.layer == "device" and policy.breaker is not None:
      policy.breaker.record_success()
    return val


# ---------------------------------------------------------------------------
# content-addressed checkpoint journal
# ---------------------------------------------------------------------------

JOURNAL_VERSION = 1

# the classes a reducer snapshot holds, by module under the package root:
# the reference writes them as ``repro.<module>``, the port as
# ``repro_torch.<module>``; both load as the port's
SNAPSHOT_CLASSES = {
    "explore.frame": ("ResultFrame", "DesignPoint"),
    "core.table": ("ConfigTable", "JointTable"),
    "core.dataflow": ("AcceleratorConfig", "ConvLayer"),
    "core.cnn": ("ArchChoice",)}
_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric")
_NUMPY_NAMES = ("_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer")
_BUILTIN_NAMES = ("set", "frozenset", "slice", "range", "complex",
                  "bytearray")


class SnapshotUnpickler(pickle.Unpickler):
  """Loads journal records and store entries written by either package,
  and nothing else.  ``repro.<module>.<Class>`` and
  ``repro_torch.<module>.<Class>`` both resolve to the port's class for
  the classes a snapshot holds (:data:`SNAPSHOT_CLASSES`), so loading an
  entry the reference wrote never imports the reference; numpy arrays,
  scalars and dtypes and a few builtin containers load as themselves.
  Any other global raises ``pickle.UnpicklingError``, which callers
  treat like a corrupt record."""

  def find_class(self, module: str, name: str):
    root, _, sub = module.partition(".")
    if root in ("repro", "repro_torch") and \
        name in SNAPSHOT_CLASSES.get(sub, ()):
      return getattr(importlib.import_module(f"repro_torch.{sub}"), name)
    if (module in _NUMPY_MODULES and name in _NUMPY_NAMES) or (
        module == "numpy.dtypes" and name.endswith("DType")):
      return super().find_class(module, name)
    if module == "builtins" and name in _BUILTIN_NAMES:
      return super().find_class(module, name)
    raise pickle.UnpicklingError(
        f"{module}.{name} is not a class a snapshot holds")


def load_snapshot(payload: bytes):
  """``pickle.loads`` through :class:`SnapshotUnpickler`."""
  return SnapshotUnpickler(io.BytesIO(payload)).load()


def _sha(parts: Iterable[str]) -> str:
  h = hashlib.sha256()
  for p in parts:
    h.update(p.encode("utf-8"))
    h.update(b"\x00")
  return h.hexdigest()


def space_fingerprint(space) -> str:
  """Content hash of a DesignSpace's sampling identity: PE types, axis
  names/values, and the constraint count.  (Constraint *bodies* are
  opaque callables; swapping one while keeping the count is on the
  caller, exactly like swapping the evaluate hook of a search.)"""
  parts = ["space", ",".join(space.pe_types)]
  for axis in space.axes:
    parts.append(axis.name + "=" + ",".join(repr(v) for v in axis.values))
  parts.append(f"n_constraints={len(space.constraints)}")
  return _sha(parts)


def reducers_fingerprint(reducers: Dict[str, object]) -> str:
  """Content hash of a reducer plan: names plus each reducer's own
  ``fingerprint()`` (class + the parameters that shape its state)."""
  return _sha(f"{name}={reducers[name].fingerprint()}"
              for name in sorted(reducers))


def arch_accs_fingerprint(archs: Sequence[object],
                          accs: Sequence[float]) -> str:
  """Content hash of a co-exploration's (architecture, accuracy) input."""
  parts = ["arch-accs"]
  parts.extend(repr(a) for a in archs)
  parts.extend(repr(float(x)) for x in accs)
  return _sha(parts)


def sweep_key(kind: str, space_fp: str, reducers_fp: str,
              params: Dict[str, object]) -> str:
  """The journal key: (design-space hash, oracle version, reducer plan,
  sweep parameters).  Backend identity is deliberately excluded — the
  parity contract makes checkpoints portable between the card and the
  CPU (and between this package and the reference: equal inputs give
  equal keys)."""
  parts = [f"journal-v{JOURNAL_VERSION}", kind, space_fp,
           f"oracle-v{oracle.ORACLE_VERSION}", reducers_fp]
  parts.extend(f"{k}={params[k]!r}" for k in sorted(params))
  return _sha(parts)


class SweepJournal:
  """Durable checkpoint store for resumable sweeps: one pickle file per
  journal key under ``dir_path``, written atomically (tmp +
  ``os.replace``) so a kill mid-write leaves the previous durable
  record intact.  ``load`` returns None — a fresh start, never an
  error — on missing, corrupt, or key/version-mismatched records.

  This journal is the foundation the ROADMAP's exploration-as-a-service
  sweep-cache builds on: the key is content-addressed, so a *finished*
  sweep's record doubles as a cache hit for an identical future sweep.
  Records load through :class:`SnapshotUnpickler`, so a journal the
  reference wrote under the same key resumes in the port without
  importing the reference.
  """

  def __init__(self, dir_path):
    self.dir = str(dir_path)
    os.makedirs(self.dir, exist_ok=True)

  def path(self, key: str) -> str:
    return os.path.join(self.dir, f"sweep-{key[:32]}.pkl")

  def record(self, key: str, state: Dict[str, object]) -> None:
    payload = {"version": JOURNAL_VERSION, "key": key, "state": state}
    tmp = self.path(key) + ".tmp"
    with open(tmp, "wb") as f:
      pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
      f.flush()
      os.fsync(f.fileno())
    os.replace(tmp, self.path(key))

  def load(self, key: str) -> Optional[Dict[str, object]]:
    try:
      with open(self.path(key), "rb") as f:
        payload = load_snapshot(f.read())
    except FileNotFoundError:
      return None
    except Exception:  # truncated/corrupt record -> fresh start
      return None
    if (payload.get("version") != JOURNAL_VERSION
        or payload.get("key") != key):
      return None
    return payload.get("state")

  # -- append-log records ---------------------------------------------------
  #
  # ``record``/``load`` replace the whole snapshot atomically — safe, but
  # one fsync'd rewrite of the entire reducer state per checkpoint.  The
  # exploration service checkpoints many interleaved sessions, so it uses
  # an append-only log instead: each entry is a complete snapshot framed
  # as ``magic | u64 length | sha256(payload) | payload``, appended and
  # fsync'd.  A kill mid-append leaves at most one partial trailing frame;
  # ``replay`` detects it (short frame, bad digest, or bad magic),
  # truncates the file back to the last valid record, and returns the
  # surviving entries — recovery, never an exception.

  _LOG_MAGIC = b"SWPJ"
  _LOG_HEADER = len(_LOG_MAGIC) + 8 + 32  # magic + length + sha256 digest

  def log_path(self, key: str) -> str:
    return os.path.join(self.dir, f"sweep-{key[:32]}.log")

  def append(self, key: str, state: Dict[str, object]) -> None:
    payload = pickle.dumps(
        {"version": JOURNAL_VERSION, "key": key, "state": state},
        protocol=pickle.HIGHEST_PROTOCOL)
    frame = (self._LOG_MAGIC + struct.pack("<Q", len(payload))
             + hashlib.sha256(payload).digest() + payload)
    with open(self.log_path(key), "ab") as f:
      f.write(frame)
      f.flush()
      os.fsync(f.fileno())

  def replay(self, key: str) -> List[Dict[str, object]]:
    """All valid states in append order, truncating trailing garbage."""
    try:
      with open(self.log_path(key), "rb") as f:
        data = f.read()
    except FileNotFoundError:
      return []
    states: List[Dict[str, object]] = []
    off = 0
    good_end = 0
    n_magic = len(self._LOG_MAGIC)
    while off < len(data):
      header = data[off:off + self._LOG_HEADER]
      if len(header) < self._LOG_HEADER or header[:n_magic] != self._LOG_MAGIC:
        break
      (length,) = struct.unpack("<Q", header[n_magic:n_magic + 8])
      digest = header[n_magic + 8:self._LOG_HEADER]
      payload = data[off + self._LOG_HEADER:off + self._LOG_HEADER + length]
      if (len(payload) < length
          or hashlib.sha256(payload).digest() != digest):
        break
      try:
        rec = load_snapshot(payload)
      except Exception:
        break
      if rec.get("version") != JOURNAL_VERSION or rec.get("key") != key:
        break
      states.append(rec["state"])
      off += self._LOG_HEADER + length
      good_end = off
    if good_end < len(data):
      with open(self.log_path(key), "r+b") as f:
        f.truncate(good_end)
    return states

  def rewrite(self, key: str, states: List[Dict[str, object]]) -> None:
    """Atomically replace ``key``'s append log with ``states`` (in
    order) — the compaction primitive: callers replay, drop superseded
    entries, and rewrite.  Atomic tmp + ``os.replace`` like ``record``,
    so a kill mid-compaction leaves the previous log intact."""
    tmp = self.log_path(key) + ".tmp"
    with open(tmp, "wb") as f:
      for state in states:
        payload = pickle.dumps(
            {"version": JOURNAL_VERSION, "key": key, "state": state},
            protocol=pickle.HIGHEST_PROTOCOL)
        f.write(self._LOG_MAGIC + struct.pack("<Q", len(payload))
                + hashlib.sha256(payload).digest() + payload)
      f.flush()
      os.fsync(f.fileno())
    os.replace(tmp, self.log_path(key))

  def load_last(self, key: str) -> Optional[Dict[str, object]]:
    """Latest valid append-log state for ``key`` (None if none)."""
    states = self.replay(key)
    return states[-1] if states else None

  def load_state(self, key: str) -> Optional[Dict[str, object]]:
    """Best available checkpoint across both storage styles: the atomic
    snapshot (``record``) and the append log (``append``).  When both
    exist — e.g. a sweep started under ``run_stream`` and continued in
    the service — the one with more folded chunks wins."""
    candidates = [s for s in (self.load(key), self.load_last(key))
                  if s is not None]
    if not candidates:
      return None
    return max(candidates, key=lambda s: len(s.get("done", ())))
