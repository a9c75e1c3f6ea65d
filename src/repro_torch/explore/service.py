"""The exploration service: concurrent sessions over one shared device
executor (the port of ``repro.explore.service``).

Many overlapping consumers — interactive sweeps, co-explorations, guided
searches — share one device executor.  The :class:`ExplorationService`
multiplexes them with the fixed-slot scheduler shape of
:class:`repro_torch.serve.engine.ServeEngine` (session slots instead of
decode slots): a bounded submission queue feeds a small set of active
sessions, and each scheduler pass gives every active session one unit of
work — dispatch one chunk into its bounded ``dispatch_ahead`` window or
resolve its oldest pending chunk — so sessions interleave fairly
through the same asynchronous dispatch ``run_stream`` uses.  A session
folds its chunks in the order it dispatched them, chunk-index order.

Failure behavior, layer by layer:

  admission   a full queue raises a typed :class:`AdmissionRejected` at
              submit time (backpressure, not buffering); per-session
              ``chunk_budget`` bounds how much executor time one request
              can consume, failing over to a typed
              :class:`BudgetExhausted` with progress journaled.
  deadlines   a per-request :class:`Deadline` (monotonic, injectable
              clock) is threaded into the
              :class:`~repro_torch.explore.resilience.ResiliencePolicy`
              resolve-time watchdog as ``min(base, remaining)``; an
              expired or cancelled session abandons its in-flight
              chunks without poisoning neighboring sessions, and its
              journal keeps the finished chunks for a later resume.
  breaker     one :class:`~repro_torch.explore.resilience.CircuitBreaker`
              is shared by all sessions: persistent device-rung failures
              open it, and new chunks route past the device rungs to the
              backend's terminal rung for a seeded cooldown, then
              half-open probes.  The reference's terminal rung is a host
              numpy rung; the port's is the backend's own (H16): the
              card's unfused ``device`` rung under a card backend, the
              CPU under ``device="cpu"``.  There is no CPU rung under a
              card backend.  Results stay bit-identical either way;
              transitions land in every session's ``StreamResult.meta``.
  store       with a :class:`~repro_torch.explore.store.ResultStore`
              attached, finished sweeps are served from the store
              (``store_hit``), one-axis-edited full-grid sweeps run as
              delta sweeps over just the new subgrid, and in-progress
              sessions checkpoint into the store's append-log journal —
              a kill (:class:`~repro_torch.explore.resilience.
              SweepKilled`) aborts the whole service the way a process
              death would, and resubmitting the same work replays from
              the store.
  pool        with a :class:`~repro_torch.explore.fleet.DevicePool`
              attached, each chunk with a device rung is pinned to the
              pool's healthiest device, whose health the chunk's outcome
              feeds.

Everything rests on the same structural facts as ``run_stream``: chunks
are pure functions of their index and reducers are chunk-order
invariant, so any interleaving, demotion, breaker reroute, resume, or
delta merge yields bit-identical reductions.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple, Union

from repro_torch.explore import fleet
from repro_torch.explore.resilience import (ChunkError, ChunkTask,
                                            CircuitBreaker, FaultPlan,
                                            ResiliencePolicy, RetryPolicy,
                                            Rung, SweepJournal, SweepKilled,
                                            reducers_fingerprint)
from repro_torch.explore.space import DesignSpace
from repro_torch.explore.store import (ResultStore, _cached_result,
                                       _explore_manifest,
                                       _restore_delta_base, _snapshot_state,
                                       co_explore_result_key,
                                       delta_sweep_key, delta_tasks,
                                       explore_result_key, find_delta_base)
from repro_torch.explore.streaming import (DISPATCH_AHEAD, Reducer,
                                           StreamResult,
                                           co_explore_sweep_key,
                                           co_explore_tasks,
                                           default_co_reducers,
                                           default_explore_reducers,
                                           explore_sweep_key, explore_tasks,
                                           fold_chunk, new_counters)

# how long SessionHandle.result / service joins wait per condition poll —
# every wait in this module is bounded (the ROB002 idiom)
_POLL_SECONDS = 0.05
_JOIN_SECONDS = 5.0


class AdmissionRejected(RuntimeError):
  """The submission queue is full — typed backpressure, not buffering."""

  def __init__(self, queued: int, max_queued: int):
    self.queued = int(queued)
    self.max_queued = int(max_queued)
    super().__init__(f"submission queue full ({queued}/{max_queued}); "
                     "retry after a session completes")


class BudgetExhausted(RuntimeError):
  """A session spent its per-request chunk budget.  Progress up to the
  budget is journaled — resubmitting with a larger budget resumes."""

  def __init__(self, session: int, budget: int):
    self.session = int(session)
    self.budget = int(budget)
    super().__init__(f"session {session} exhausted its {budget}-chunk "
                     "budget (progress journaled; resubmit to resume)")


class DeadlineExceeded(RuntimeError):
  """A session's wall-clock deadline expired.  In-flight chunks are
  abandoned, finished chunks are journaled for resume."""

  def __init__(self, session: int, deadline: "Deadline"):
    self.session = int(session)
    super().__init__(f"session {session} exceeded its "
                     f"{deadline.seconds}s deadline "
                     "(progress journaled; resubmit to resume)")


class SessionCancelled(RuntimeError):
  """The client cancelled the session; progress is journaled."""

  def __init__(self, session: int):
    self.session = int(session)
    super().__init__(f"session {session} cancelled "
                     "(progress journaled; resubmit to resume)")


class Deadline:
  """A monotonic wall-clock budget, started at construction.

  The clock is injectable so tests can expire deadlines without
  wall-waiting; the default is ``time.monotonic``, deliberately not
  ``time.time``, which NTP can step backwards.  Shared by the
  exploration service and :class:`repro_torch.serve.engine.ServeEngine`
  request eviction.
  """

  def __init__(self, seconds: float,
               clock: Callable[[], float] = time.monotonic):
    self.seconds = float(seconds)
    self.clock = clock
    self._t0 = clock()

  def remaining(self) -> float:
    return self.seconds - (self.clock() - self._t0)

  def expired(self) -> bool:
    return self.remaining() <= 0.0

  def __repr__(self) -> str:
    return f"Deadline({self.seconds}s, {self.remaining():.3f}s left)"


# session lifecycle: queued -> running -> one terminal state
SESSION_STATES = ("queued", "running", "done", "failed", "cancelled",
                  "expired")


class SessionHandle:
  """The client's view of a submitted session."""

  def __init__(self, session: "_Session"):
    self._s = session

  @property
  def session_id(self) -> int:
    return self._s.sid

  @property
  def kind(self) -> str:
    return self._s.kind

  @property
  def status(self) -> str:
    return self._s.state

  def cancel(self) -> None:
    """Request cooperative cancellation; the scheduler journals progress
    and abandons in-flight work at its next pass over the session."""
    self._s.cancel_requested = True

  def result(self, timeout: Optional[float] = 60.0) -> StreamResult:
    """The session's StreamResult; raises the session's typed error for
    failed/expired/cancelled sessions, TimeoutError if the session is
    still live after ``timeout`` (bounded — never an unbounded wait)."""
    s = self._s
    t0 = time.monotonic()
    with s.cond:
      while s.state in ("queued", "running"):
        if timeout is not None and time.monotonic() - t0 >= timeout:
          raise TimeoutError(
              f"session {s.sid} still {s.state} after {timeout}s; "
              "drain() the service or start() its scheduler thread")
        s.cond.wait(_POLL_SECONDS)
    if s.error is not None:
      raise s.error
    return s.result


class _Session:
  """Scheduler-internal state shared by sweep and search sessions."""

  def __init__(self, sid: int, kind: str, policy: ResiliencePolicy,
               deadline: Optional[Deadline], chunk_budget: Optional[int],
               journal: Optional[SweepJournal], journal_key: str):
    self.sid = sid
    self.kind = kind
    self.policy = policy
    self.deadline = deadline
    self.chunk_budget = chunk_budget
    self.journal = journal
    self.journal_key = journal_key
    self.state = "queued"
    self.cancel_requested = False
    self.error: Optional[BaseException] = None
    self.result: Optional[StreamResult] = None
    self.cond = threading.Condition()
    self.t0: Optional[float] = None
    self.n_dispatched = 0  # fresh chunks this run (budget unit)
    self.meta_extra: Dict[str, float] = {}

  def finalize(self, state: str, error: Optional[BaseException] = None,
               result: Optional[StreamResult] = None) -> None:
    with self.cond:
      self.state = state
      self.error = error
      self.result = result
      self.cond.notify_all()


class _SweepSession(_Session):
  """An explore/co-explore sweep interleaved chunk-by-chunk."""

  def __init__(self, sid: int, kind: str, policy: ResiliencePolicy,
               deadline: Optional[Deadline], chunk_budget: Optional[int],
               journal: Optional[SweepJournal], journal_key: str,
               reducers: Dict[str, Reducer], tasks,
               dispatch_ahead: int, checkpoint_every: int,
               result_key: str = "", manifest=None):
    super().__init__(sid, kind, policy, deadline, chunk_budget, journal,
                     journal_key)
    self.reducers = reducers
    self.task_iter = iter(tasks)
    self.next_task: Optional[ChunkTask] = None
    self.exhausted = False
    self.window: deque = deque()
    self.dispatch_ahead = max(int(dispatch_ahead), 0)
    self.checkpoint_every = max(int(checkpoint_every), 1)
    self.result_key = result_key
    self.manifest = manifest
    self.counters = new_counters()
    self.done_chunks: set = set()
    self.n_resumed = 0
    self._since_ckpt = 0
    self._base_retries = 0
    self._base_demotions = 0

  def adopt_checkpoint(self, state: Dict[str, object]) -> None:
    self.done_chunks = set(state["done"])
    for name, r in self.reducers.items():
      r.restore(state["reducers"][name])
    self.counters.update(state["counters"])
    self.n_resumed = len(self.done_chunks)
    self._base_retries = self.counters["n_retries"]
    self._base_demotions = self.counters["n_demotions"]

  def totals(self) -> Tuple[int, int]:
    return (self._base_retries + self.policy.n_retries,
            self._base_demotions + self.policy.n_demotions)

  def checkpoint(self, force: bool = False) -> None:
    if self.journal is None:
      return
    self._since_ckpt += 1
    if not force and self._since_ckpt < self.checkpoint_every:
      return
    r, d = self.totals()
    self.counters["n_retries"], self.counters["n_demotions"] = r, d
    self.journal.append(self.journal_key, {
        "done": set(self.done_chunks),
        "reducers": {n: r_.snapshot() for n, r_ in self.reducers.items()},
        "counters": dict(self.counters)})
    self._since_ckpt = 0

  def pull_task(self) -> Optional[ChunkTask]:
    """Next not-yet-folded task, or None when the sweep is exhausted."""
    if self.next_task is not None:
      task, self.next_task = self.next_task, None
      return task
    while not self.exhausted:
      task = next(self.task_iter, None)
      if task is None:
        self.exhausted = True
        return None
      if task.index not in self.done_chunks:
        return task
    return None


class _EvalRequest:
  """One blocking evaluate handoff from a search thread to the
  scheduler (the shared-executor proxy)."""

  __slots__ = ("table", "layers", "network", "event", "box")

  def __init__(self, table, layers, network):
    self.table = table
    self.layers = layers
    self.network = network
    self.event = threading.Event()
    self.box: Optional[Tuple[str, object]] = None


class _ProxyBackend:
  """The backend a service-hosted search sees: every ``evaluate_table``
  becomes a blocking handoff through the service's shared executor, so
  search evaluations interleave with sweep chunks under the same
  retry/fault/breaker policy and the same fairness pass."""

  name = "service-proxy"
  prefers_table = True

  def __init__(self, session: "_SearchSession"):
    self._session = session

  def evaluate_table(self, table, layers, network="net"):
    return self._session.call_through(table, layers, network)


class _SearchSession(_Session):
  """A guided search running on its own thread, its evaluations proxied
  through the scheduler; deadline/cancel/budget surface as typed errors
  raised *inside* the search (cooperative cancellation)."""

  def __init__(self, sid: int, policy: ResiliencePolicy,
               deadline: Optional[Deadline], chunk_budget: Optional[int],
               journal: Optional[SweepJournal], run_search):
    super().__init__(sid, "search", policy, deadline, chunk_budget,
                     journal, "")
    self._run_search = run_search  # (proxy backend) -> StreamResult
    self.requests: deque = deque()
    self.thread: Optional[threading.Thread] = None
    self.thread_done = threading.Event()
    self.thread_result: Optional[Tuple[str, object]] = None
    self.flag: Optional[Tuple[str, BaseException]] = None

  def start_thread(self) -> None:
    proxy = _ProxyBackend(self)

    def target():
      try:
        self.thread_result = ("ok", self._run_search(proxy))
      except BaseException as e:
        self.thread_result = ("err", e)
      finally:
        self.thread_done.set()

    self.thread = threading.Thread(
        target=target, daemon=True, name=f"search-session-{self.sid}")
    self.thread.start()

  def call_through(self, table, layers, network):
    """Search-thread side of the handoff: enqueue and poll (bounded
    waits), surfacing cancellation/deadline as typed errors so the
    search unwinds cooperatively with its generations journaled."""
    req = _EvalRequest(table, layers, network)
    self.requests.append(req)
    while not req.event.wait(_POLL_SECONDS):
      if self.flag is not None:
        raise self.flag[1]
    tag, val = req.box
    if tag == "err":
      raise val
    return val


class ExplorationService:
  """Concurrent exploration sessions over one shared executor.

  ``slots`` bounds how many sessions interleave at once (the
  ``ServeEngine`` fixed-slot shape); ``max_queued`` bounds the
  submission queue behind them — a submit beyond that raises
  :class:`AdmissionRejected`.  ``drain()`` runs the scheduler on the
  calling thread until all work finishes (deterministic — what the
  chaos tests drive); ``start()``/``stop()`` run it on a background
  thread instead.  See the module docstring for the failure model.
  """

  def __init__(self, backend, *, slots: int = 2, max_queued: int = 8,
               store: Optional[Union[ResultStore, str]] = None,
               retry: Optional[RetryPolicy] = None,
               fault_plan: Optional[FaultPlan] = None,
               breaker: Optional[CircuitBreaker] = None,
               resolve_timeout: Optional[float] = None,
               dispatch_ahead: int = DISPATCH_AHEAD,
               checkpoint_every: int = 1, pool=None):
    if slots < 1:
      raise ValueError(f"slots must be >= 1, got {slots}")
    if max_queued < 0:
      raise ValueError(f"max_queued must be >= 0, got {max_queued}")
    self.backend = backend
    # one DevicePool shared by every session: quarantine decisions
    # reflect the device, not any single session's luck
    self.pool = pool
    self.store = (ResultStore(store)
                  if store is not None and not isinstance(store, ResultStore)
                  else store)
    self.retry = retry
    self.fault_plan = fault_plan
    self.breaker = breaker
    self.resolve_timeout = resolve_timeout
    self.dispatch_ahead = dispatch_ahead
    self.checkpoint_every = checkpoint_every
    self.slots: List[Optional[_Session]] = [None] * int(slots)
    self.queue: deque = deque()
    self.max_queued = int(max_queued)
    self.stats = {"n_admitted": 0, "n_rejected": 0, "n_completed": 0,
                  "n_failed": 0, "n_store_hits": 0, "n_delta_sweeps": 0}
    self._uid = 0
    self._lock = threading.RLock()
    self._thread: Optional[threading.Thread] = None
    self._stop = threading.Event()

  # -- policy / deadline plumbing -------------------------------------------

  def _as_deadline(self, deadline) -> Optional[Deadline]:
    if deadline is None or isinstance(deadline, Deadline):
      return deadline
    return Deadline(float(deadline))

  def _session_policy(self, deadline: Optional[Deadline]
                      ) -> ResiliencePolicy:
    base = self.resolve_timeout
    if deadline is None:
      resolve = base
    else:
      def resolve() -> float:
        rem = max(deadline.remaining(), 0.0)
        return rem if base is None else min(base, rem)
    return ResiliencePolicy(retry=self.retry, fault_plan=self.fault_plan,
                            resolve_timeout=resolve, breaker=self.breaker)

  # -- admission ------------------------------------------------------------

  def _admit_or_reject(self) -> None:
    self._admit()  # free slots absorb the queue before capacity is judged
    if len(self.queue) >= self.max_queued:
      self.stats["n_rejected"] += 1
      raise AdmissionRejected(len(self.queue), self.max_queued)

  def _next_sid(self) -> int:
    self._uid += 1
    return self._uid

  def _enqueue(self, session: _Session) -> SessionHandle:
    self.queue.append(session)
    self.stats["n_admitted"] += 1
    return SessionHandle(session)

  def _store_hit_session(self, kind: str, reducers: Dict[str, Reducer],
                         state: Dict[str, object]) -> SessionHandle:
    """A finished sweep served straight from the store: the session is
    born terminal, no executor time at all."""
    t0 = time.perf_counter()
    for name, r in reducers.items():
      r.restore(state["reducers"][name])
    res = _cached_result(reducers, state, time.perf_counter() - t0)
    s = _Session(self._next_sid(), kind, ResiliencePolicy(retry=self.retry),
                 None, None, None, "")
    res.meta["session"] = float(s.sid)
    s.finalize("done", result=res)
    self.stats["n_admitted"] += 1
    self.stats["n_store_hits"] += 1
    self.stats["n_completed"] += 1
    return SessionHandle(s)

  # -- submission: plain sweep ----------------------------------------------

  def submit_explore(self, space: DesignSpace, layers, network: str = "net",
                     *, n_per_type: int = 200, seed: int = 17,
                     method: str = "random",
                     reducers: Optional[Dict[str, Reducer]] = None,
                     chunk_size: int = 65536, deadline=None,
                     chunk_budget: Optional[int] = None) -> SessionHandle:
    """Submit a plain streamed sweep.  With a store attached: an
    identical finished sweep returns as a store hit, a one-axis-edited
    full-grid sweep runs as a delta-sweep, and progress journals under
    the store for kill-resume."""
    with self._lock:
      deadline = self._as_deadline(deadline)
      if reducers is None:
        reducers = default_explore_reducers()
      rfp = reducers_fingerprint(reducers)
      result_key = ""
      manifest = None
      full_grid = (method == "grid"
                   and int(n_per_type) >= space.per_type_grid_size())
      if self.store is not None:
        result_key = explore_result_key(space, reducers, network=network,
                                        n_per_type=n_per_type, seed=seed,
                                        method=method)
        state = self.store.get(result_key)
        if state is not None:
          return self._store_hit_session("explore", reducers, state)
        manifest = _explore_manifest(space, network, method, rfp, full_grid)
      self._admit_or_reject()

      journal = self.store.journal if self.store is not None else None
      meta_extra: Dict[str, float] = {}
      tasks = None
      journal_key = ""
      if self.store is not None and full_grid:
        base = find_delta_base(self.store, space, network=network,
                               reducers_fp=rfp)
        if base is not None:
          base_key, axis, added = base
          base_state = _restore_delta_base(self.store, base_key, reducers,
                                           space)
          if base_state is not None:
            journal_key = delta_sweep_key(space, rfp, base_key, network)
            tasks = delta_tasks(self.backend, space, axis, added, layers,
                                network, chunk_size, reducers)
            meta_extra = {"delta_sweep": 1.0,
                          "n_base_rows":
                              float(base_state.get("n_rows", 0))}
            self.stats["n_delta_sweeps"] += 1
      if tasks is None:
        journal_key = explore_sweep_key(
            space, reducers, n_per_type=n_per_type, seed=seed,
            method=method, chunk_size=chunk_size, network=network)
        tasks = explore_tasks(self.backend, space, layers, network,
                              n_per_type, seed, method, chunk_size,
                              reducers)
      s = _SweepSession(self._next_sid(), "explore",
                        self._session_policy(deadline), deadline,
                        chunk_budget, journal, journal_key, reducers, tasks,
                        self.dispatch_ahead, self.checkpoint_every,
                        result_key=result_key, manifest=manifest)
      s.meta_extra = meta_extra
      if journal is not None:
        ckpt = journal.load_state(journal_key)
        if ckpt is not None:
          s.adopt_checkpoint(ckpt)
      return self._enqueue(s)

  # -- submission: co-exploration -------------------------------------------

  def submit_co_explore(self, space: DesignSpace, arch_accs, *,
                        n_hw_per_type: int = 20, seed: int = 3,
                        image_size: int = 32, method: str = "random",
                        reducers: Optional[Dict[str, Reducer]] = None,
                        chunk_size: int = 65536, deadline=None,
                        chunk_budget: Optional[int] = None) -> SessionHandle:
    """Submit a streamed joint co-exploration (store hit + journaled
    resume with a store attached; no delta path — the joint identity
    includes the architecture set)."""
    with self._lock:
      deadline = self._as_deadline(deadline)
      if reducers is None:
        reducers = default_co_reducers()
      result_key = ""
      if self.store is not None:
        result_key = co_explore_result_key(
            space, reducers, arch_accs, n_hw_per_type=n_hw_per_type,
            seed=seed, image_size=image_size, method=method)
        state = self.store.get(result_key)
        if state is not None:
          return self._store_hit_session("co-explore", reducers, state)
      self._admit_or_reject()
      journal = self.store.journal if self.store is not None else None
      journal_key = co_explore_sweep_key(
          space, reducers, arch_accs, n_hw_per_type=n_hw_per_type,
          seed=seed, image_size=image_size, method=method,
          chunk_size=chunk_size)
      tasks = co_explore_tasks(self.backend, space, arch_accs,
                               n_hw_per_type, seed, image_size, method,
                               chunk_size, reducers)
      s = _SweepSession(self._next_sid(), "co-explore",
                        self._session_policy(deadline), deadline,
                        chunk_budget, journal, journal_key, reducers, tasks,
                        self.dispatch_ahead, self.checkpoint_every,
                        result_key=result_key)
      if journal is not None:
        ckpt = journal.load_state(journal_key)
        if ckpt is not None:
          s.adopt_checkpoint(ckpt)
      return self._enqueue(s)

  # -- submission: guided search --------------------------------------------

  def submit_search(self, space: DesignSpace, layers=None, *,
                    arch_accs=None, network: str = "search",
                    objectives=None, maximize=None, population: int = 32,
                    generations: int = 12, seed: int = 17,
                    image_size: int = 32, surrogate: bool = False,
                    reducers: Optional[Dict[str, Reducer]] = None,
                    deadline=None,
                    chunk_budget: Optional[int] = None) -> SessionHandle:
    """Submit a guided search (HW-only via ``layers=`` or joint via
    ``arch_accs=``).  The search runs on its own thread but every
    generation's evaluation is handed through the service's shared
    executor — one more session in the fairness pass, under the same
    retry/fault/breaker policy.  Its generations journal under the
    store (guided_search's own checkpointing), so kills resume."""
    with self._lock:
      deadline = self._as_deadline(deadline)
      self._admit_or_reject()
      resume_from = self.store.journal if self.store is not None else None
      ckpt_every = self.checkpoint_every

      def run_search(proxy) -> StreamResult:
        from repro_torch.explore.session import ExplorationSession
        sess = ExplorationSession(proxy, space)
        return sess.optimize(
            layers=layers, network=network, arch_accs=arch_accs,
            objectives=objectives, maximize=maximize,
            population=population, generations=generations, seed=seed,
            image_size=image_size, surrogate=surrogate, reducers=reducers,
            resume_from=resume_from, checkpoint_every=ckpt_every)

      s = _SearchSession(self._next_sid(), self._session_policy(deadline),
                         deadline, chunk_budget,
                         resume_from, run_search)
      return self._enqueue(s)

  # -- the scheduler --------------------------------------------------------

  def _admit(self) -> None:
    for i, s in enumerate(self.slots):
      if s is None and self.queue:
        nxt = self.queue.popleft()
        nxt.state = "running"
        nxt.t0 = time.perf_counter()
        self.slots[i] = nxt
        if isinstance(nxt, _SearchSession):
          nxt.start_thread()

  def _kill_everything(self, exc: SweepKilled) -> None:
    """A SweepKilled is a process death: journal every active session's
    progress, fail every session (queued included) so no handle hangs,
    and unblock any search threads."""
    for s in list(self.slots) + list(self.queue):
      if s is None:
        continue
      if isinstance(s, _SweepSession):
        try:
          s.checkpoint(force=True)
        except Exception:
          # best-effort on the way down, but never silent
          self.stats["n_checkpoint_errors"] = \
              self.stats.get("n_checkpoint_errors", 0) + 1
      if isinstance(s, _SearchSession):
        s.flag = ("failed", exc)
      if s.state in ("queued", "running"):
        s.finalize("failed", error=exc)
    self.slots = [None] * len(self.slots)
    self.queue.clear()

  def _tick(self) -> bool:
    """One fair pass: every active session gets one unit of work.
    Returns True while any session is active or queued."""
    self._admit()
    progressed = False
    for i, s in enumerate(self.slots):
      if s is None:
        continue
      try:
        progressed = self._step(s) or progressed
      except SweepKilled as e:
        self._kill_everything(e)
        raise
      if s.state != "running":
        self.slots[i] = None
        if s.state == "done":
          self.stats["n_completed"] += 1
        else:
          self.stats["n_failed"] += 1
    return any(s is not None for s in self.slots) or bool(self.queue)

  def _step(self, s: _Session) -> bool:
    if isinstance(s, _SearchSession):
      return self._step_search(s)
    return self._step_sweep(s)

  # -- sweep stepping -------------------------------------------------------

  def _abandon_window(self, s: _SweepSession) -> None:
    # in-flight device work is simply dropped — like a watchdogged
    # resolution, the abandoned dispatches drain harmlessly; checked-out
    # pool devices must still be released
    if self.pool is not None:
      for _, _, dev, _ in s.window:
        if dev is not None:
          self.pool.checkin(dev)
    s.window.clear()

  def _step_sweep(self, s: _SweepSession) -> bool:
    if s.cancel_requested:
      s.checkpoint(force=True)
      self._abandon_window(s)
      s.finalize("cancelled", error=SessionCancelled(s.sid))
      return True
    if s.deadline is not None and s.deadline.expired():
      s.checkpoint(force=True)
      self._abandon_window(s)
      s.finalize("expired", error=DeadlineExceeded(s.sid, s.deadline))
      return True
    # resolve first when the window is full
    if len(s.window) > s.dispatch_ahead:
      return self._finish_oldest(s)
    task = s.pull_task()
    if task is None:
      if s.window:
        return self._finish_oldest(s)
      self._complete_sweep(s)
      return True
    if s.chunk_budget is not None and s.n_dispatched >= s.chunk_budget:
      s.next_task = task  # not consumed: a resume re-pulls it
      s.checkpoint(force=True)
      self._abandon_window(s)
      s.finalize("failed", error=BudgetExhausted(s.sid, s.chunk_budget))
      return True
    dev = None
    if self.pool is not None and \
        any(r.layer == "device" for r in getattr(task, "rungs", ())):
      dev = self.pool.checkout()
    t_dispatch = time.perf_counter()
    try:
      if dev is not None:
        with fleet.pin(self.pool.device(dev)):
          out = s.policy.execute(task)
      else:
        out = s.policy.execute(task)
    except SweepKilled:
      if dev is not None:
        self.pool.checkin(dev)
      s.checkpoint(force=True)
      raise
    except Exception as e:
      if dev is not None:
        self.pool.checkin(dev)
        self.pool.record_failure(dev)
      self._fail_sweep(s, task.index, e)
      return True
    s.n_dispatched += 1
    if hasattr(out, "resolve"):
      s.window.append((task.index, out, dev, t_dispatch))
    else:
      if dev is not None:
        self._release(dev, t_dispatch, ok=True)
      self._fold(s, task.index, out)
    return True

  def _release(self, dev: int, t_dispatch: float, ok: bool) -> None:
    """Return a checked-out pool device, feeding the health registry."""
    self.pool.checkin(dev)
    if ok:
      self.pool.record_latency(dev, time.perf_counter() - t_dispatch)
      self.pool.record_success(dev)
    else:
      self.pool.record_failure(dev)

  def _finish_oldest(self, s: _SweepSession) -> bool:
    index, pending, dev, t_dispatch = s.window.popleft()
    try:
      self._fold(s, index, pending)
    except SweepKilled:
      if dev is not None:
        self.pool.checkin(dev)
      s.checkpoint(force=True)
      raise
    if dev is not None:
      self._release(dev, t_dispatch, ok=s.state != "failed")
    return True

  def _fold(self, s: _SweepSession, index: int, result) -> None:
    try:
      fold_chunk(s.reducers, s.counters, result)
    except SweepKilled:
      raise
    except Exception as e:
      self._fail_sweep(s, index, e)
      return
    s.done_chunks.add(index)
    s.checkpoint()

  def _fail_sweep(self, s: _SweepSession, index: int,
                  exc: Exception) -> None:
    s.checkpoint(force=True)
    self._abandon_window(s)
    err = exc if isinstance(exc, ChunkError) \
        else ChunkError(index, f"{type(exc).__name__}: {exc}")
    err.__cause__ = exc
    s.finalize("failed", error=err)

  def _complete_sweep(self, s: _SweepSession) -> None:
    s.checkpoint(force=True)
    seconds = time.perf_counter() - (s.t0 or time.perf_counter())
    n_retries, n_demotions = s.totals()
    meta = {"seconds": seconds, "workers": 1.0,
            "n_chunks": float(s.counters["n_chunks"]),
            "rows_transferred": float(s.counters["n_transferred"]),
            "rows_per_sec": s.counters["n_rows"] / max(seconds, 1e-12),
            "n_retries": float(n_retries),
            "n_demotions": float(n_demotions),
            "n_resumed_chunks": float(s.n_resumed),
            "n_overflows": float(s.counters["n_overflows"]),
            "session": float(s.sid),
            "service_slots": float(len(self.slots))}
    meta["n_leaked_watchdogs"] = float(s.policy.watchdogs.n_live())
    meta.update(s.meta_extra)
    if self.breaker is not None:
      meta.update(self.breaker.meta())
    if self.pool is not None:
      meta.update(self.pool.meta())
    res = StreamResult(
        results={n: r.result() for n, r in s.reducers.items()},
        n_rows=s.counters["n_rows"], seconds=seconds, meta=meta)
    if "n_base_rows" in s.meta_extra:
      res.meta["n_delta_rows"] = float(res.n_rows)
      res.n_rows += int(s.meta_extra["n_base_rows"])
    if self.store is not None and s.result_key:
      self.store.put_final(s.result_key,
                           _snapshot_state(s.reducers, res), s.manifest)
    s.finalize("done", result=res)

  # -- search stepping ------------------------------------------------------

  def _step_search(self, s: _SearchSession) -> bool:
    if s.flag is None and s.cancel_requested:
      s.flag = ("cancelled", SessionCancelled(s.sid))
    if s.flag is None and s.deadline is not None and s.deadline.expired():
      s.flag = ("expired", DeadlineExceeded(s.sid, s.deadline))
    if s.requests:
      req = s.requests.popleft()
      if s.flag is not None:
        req.box = ("err", s.flag[1])
        req.event.set()
        return True
      if s.chunk_budget is not None and s.n_dispatched >= s.chunk_budget:
        s.flag = ("failed", BudgetExhausted(s.sid, s.chunk_budget))
        req.box = ("err", s.flag[1])
        req.event.set()
        return True
      task = ChunkTask(index=s.n_dispatched, rungs=(Rung(
          "evaluate_table",
          lambda: self.backend.evaluate_table(req.table, req.layers,
                                              req.network),
          layer="backend"),))
      s.n_dispatched += 1
      try:
        out = s.policy.execute(task)
      except SweepKilled as e:
        req.box = ("err", e)
        req.event.set()
        raise
      except Exception as e:
        req.box = ("err", e)
      else:
        req.box = ("ok", out)
      req.event.set()
      return True
    if s.thread_done.is_set():
      s.thread.join(_JOIN_SECONDS)  # bounded: the thread already signalled
      tag, val = s.thread_result
      if tag == "ok":
        res: StreamResult = val
        res.meta["session"] = float(s.sid)
        res.meta["n_retries"] = res.meta.get("n_retries", 0.0) \
            + float(s.policy.n_retries)
        res.meta["n_demotions"] = res.meta.get("n_demotions", 0.0) \
            + float(s.policy.n_demotions)
        if self.breaker is not None:
          res.meta.update(self.breaker.meta())
        s.finalize("done", result=res)
      else:
        state, err = s.flag if s.flag is not None else ("failed", val)
        # the search surfaces proxy errors wrapped in ChunkError — the
        # typed service error is the one the client should see
        s.finalize(state, error=err if s.flag is not None else val)
      return True
    return False  # thread busy between evaluations: nothing to do

  # -- driving --------------------------------------------------------------

  def drain(self) -> int:
    """Run the scheduler on the calling thread until every session has
    reached a terminal state; returns how many sessions completed
    successfully during the drain.  Deterministic for a fixed submission
    order (the chaos-test mode).  :class:`SweepKilled` propagates after
    all progress is journaled — the process-death simulation."""
    with self._lock:
      before = self.stats["n_completed"]
      while True:
        busy = self._tick()
        if not busy:
          break
        # a pass with live sessions but no progress means every active
        # session is a search thread computing between evaluations —
        # yield briefly instead of spinning
        if not any(isinstance(s, _SweepSession) for s in self.slots
                   if s is not None):
          time.sleep(0.001)
      return self.stats["n_completed"] - before

  def start(self) -> None:
    """Run the scheduler on a background daemon thread."""
    with self._lock:
      if self._thread is not None and self._thread.is_alive():
        return
      self._stop.clear()

      def loop():
        while not self._stop.is_set():
          with self._lock:
            try:
              busy = self._tick()
            except SweepKilled:
              return  # everything already failed + journaled
          if not busy:
            self._stop.wait(_POLL_SECONDS)

      self._thread = threading.Thread(target=loop, daemon=True,
                                      name="exploration-service")
      self._thread.start()

  def stop(self, timeout: float = _JOIN_SECONDS) -> None:
    """Stop the background scheduler (bounded join — ROB002)."""
    self._stop.set()
    t = self._thread
    if t is not None:
      t.join(timeout)

  def service_meta(self) -> Dict[str, object]:
    """Service-level observability: admission/completion counters plus
    breaker and store state."""
    meta: Dict[str, object] = dict(self.stats)
    meta["n_queued"] = len(self.queue)
    meta["n_active"] = sum(1 for s in self.slots if s is not None)
    meta["slots"] = len(self.slots)
    if self.pool is not None:
      meta.update(self.pool.meta())
    if self.breaker is not None:
      meta.update(self.breaker.meta())
    if self.store is not None:
      meta.update({f"store_{k}": v for k, v in self.store.stats().items()})
    return meta
