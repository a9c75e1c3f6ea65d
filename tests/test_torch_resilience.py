"""The port's fault tolerance against the JAX package's, on the CPU: the
retry primitive, seeded fault plans, the circuit breaker, the
degradation ladder and its watchdog, the checkpoint journal, the
content-addressed journal keys, and kill-and-resume of streamed sweeps.

Host logic (retry delays, fault schedules, breaker transitions,
fingerprints and keys) must equal the reference's exactly; a sweep killed
at any chunk boundary and resumed must reproduce the uninterrupted run
(and the reference's numpy run) row for row.  The port's ladders end on
the backend's own unfused rung, never on a host rung under a card
backend: a stand-in backend whose device is ``cuda`` shows that without
a card.  Seeds are fixed integers.
"""
import pickle
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.explore as R
from repro.core.cnn import SEARCH_SPACE as REF_SEARCH_SPACE
from repro.core.cnn import ArchChoice as RefArch
from repro.core.workloads import get_network as ref_get_network
from repro.explore import resilience as RR
from repro.explore import streaming as RS
from repro.train import fault_tolerance as RFT

import repro_torch.explore as P
from repro_torch.core.cnn import ArchChoice
from repro_torch.core.workloads import get_network
from repro_torch.explore import resilience as PR
from repro_torch.explore import streaming as PS
from repro_torch.train import fault_tolerance as PFT

METRICS = ("latency_s", "power_mw", "area_mm2")
JOINT3 = ("top1_err", "energy_mj", "area_mm2")


def flaky(n_failures: int, result="ok", exc=RuntimeError):
  state = {"calls": 0}

  def fn():
    state["calls"] += 1
    if state["calls"] <= n_failures:
      raise exc(f"transient #{state['calls']}")
    return result

  fn.state = state
  return fn


def no_wait(mod):
  return mod.RetryPolicy(sleep=lambda s: None)


# ---------------------------------------------------------------------------
# the retry primitive
# ---------------------------------------------------------------------------

def _retry_trace(ft, n_failures, max_retries, base_delay, backoff):
  delays, attempts = [], []
  fn = flaky(n_failures)
  try:
    out = ft.retrying(fn, max_retries=max_retries, sleep=delays.append,
                      on_failure=lambda a, e: attempts.append(a),
                      base_delay=base_delay, backoff=backoff)()
  except ft.StepFailure as e:
    out = ("StepFailure", str(e), type(e.__cause__).__name__)
  return out, delays, attempts, fn.state["calls"]


@pytest.mark.parametrize("n_failures", [0, 1, 2, 3, 7])
@pytest.mark.parametrize("max_retries,base_delay,backoff",
                         [(2, 0.01, 2.0), (0, 0.5, 3.0), (4, 0.25, 1.5)])
def test_retrying_equals_the_reference(n_failures, max_retries, base_delay,
                                       backoff):
  args = (n_failures, max_retries, base_delay, backoff)
  assert _retry_trace(PFT, *args) == _retry_trace(RFT, *args)


def test_retrying_passes_non_retryable_errors_through():
  delays = []
  fn = flaky(1, exc=ValueError)
  with pytest.raises(ValueError):
    PFT.retrying(fn, max_retries=5, sleep=delays.append)()
  assert fn.state["calls"] == 1 and delays == []
  assert issubclass(PFT.StepFailure, RuntimeError)


@pytest.mark.parametrize("n_failures", [0, 1, 2, 5])
def test_retry_policy_counts_equal_the_reference(n_failures):
  def trace(mod):
    seen, delays = [], []
    pol = mod.RetryPolicy(max_retries=2, sleep=delays.append)
    try:
      out = pol.call(flaky(n_failures), on_retry=lambda a, e: seen.append(a))
    except Exception as e:  # StepFailure of either package
      out = type(e).__name__
    return out, seen, delays
  assert trace(PR) == trace(RR)


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

def _faults(plan):
  return [(f.kind, f.chunk, f.layer, f.times, f.device) for f in plan.faults]


@pytest.mark.parametrize("seed", [0, 1, 11, 12, 2 ** 31 - 1])
@pytest.mark.parametrize("probs", [(0.25, 0.0, 0.0), (0.3, 0.2, 0.1),
                                   (0.9, 0.5, 0.05)])
def test_seeded_fault_plans_equal_the_reference(seed, probs):
  p_raise, p_hang, p_kill = probs
  kw = dict(p_raise=p_raise, p_hang=p_hang, p_kill=p_kill, times=2)
  got = PR.FaultPlan.seeded(seed, 60, **kw)
  want = RR.FaultPlan.seeded(seed, 60, **kw)
  assert _faults(got) == _faults(want)
  kw = dict(p_slow=probs[0], p_corrupt=probs[1], p_lost=probs[2])
  assert _faults(PR.FaultPlan.seeded_fleet(seed, 40, 4, **kw)) == \
      _faults(RR.FaultPlan.seeded_fleet(seed, 40, 4, **kw))


def test_fault_plan_budget_scoping_and_types():
  plan = PR.FaultPlan([PR.Fault("raise", 3, "device", times=2),
                       PR.Fault("kill", 0, "task"),
                       PR.Fault("hang", 0, "device")])
  plan.check("backend", 3)  # wrong layer
  plan.check("device", 2)  # wrong chunk
  for _ in range(2):
    with pytest.raises(PR.FaultInjected):
      plan.check("device", 3)
  plan.check("device", 3)  # budget spent: silent
  with pytest.raises(PR.SweepKilled):
    plan.check("task", 0)
  with pytest.raises(PR.InjectedHang):
    plan.check_resolve("device", 0)
  assert plan.n_fired == 4
  assert not issubclass(PR.SweepKilled, RuntimeError)
  assert issubclass(PR.FaultInjected, RuntimeError)
  assert issubclass(PR.InjectedHang, PR.ChunkTimeout)


def test_check_fleet_equals_the_reference():
  def trace(mod):
    plan = mod.FaultPlan([mod.Fault("slow", 2, "fleet", device=1),
                          mod.Fault("corrupt", mod.ANY_CHUNK, "fleet",
                                    times=2),
                          mod.Fault("device-lost", 5, "fleet")])
    return [plan.check_fleet(d, c) for c in range(7) for d in range(3)]
  assert trace(PR) == trace(RR)


@pytest.mark.parametrize("args", [
    ("explode", 0), ("raise", 0, "cloud"), ("raise", 0, "task", 0),
    ("slow", 0, "task"), ("raise", 0, "fleet"), ("raise", 0, "device", 1, 2),
    ("raise", -1, "device")])
def test_fault_validation_equals_the_reference(args):
  with pytest.raises(ValueError) as want:
    RR.Fault(*args)
  with pytest.raises(ValueError) as got:
    PR.Fault(*args)
  assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the circuit breaker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 7])
def test_circuit_breaker_transitions_equal_the_reference(seed):
  def trace(mod):
    br = mod.CircuitBreaker(threshold=2, cooldown=3, jitter=2, seed=seed)
    rng = np.random.RandomState(seed)
    out = []
    for step in range(200):
      u = rng.randint(10)
      if u < 4:
        out.append(br.allow_device())
      elif u < 7:
        br.record_failure()
      elif u < 9:
        br.record_success()
      else:
        br.trip()
      out.append(br.state)
    return out, br.meta()
  assert trace(PR) == trace(RR)


@pytest.mark.parametrize("kw", [dict(threshold=0), dict(cooldown=0),
                                dict(jitter=-1)])
def test_circuit_breaker_validation(kw):
  with pytest.raises(ValueError):
    PR.CircuitBreaker(**kw)


# ---------------------------------------------------------------------------
# the degradation ladder (fake rungs)
# ---------------------------------------------------------------------------

class _FakePending:
  def __init__(self, fn, device=None):
    self._fn = fn
    self.device = device

  def resolve(self):
    return self._fn()


def policy_of(mod=PR, **kw):
  kw.setdefault("retry", mod.RetryPolicy(max_retries=1, sleep=lambda s: None))
  return mod.ResiliencePolicy(**kw)


def _ladder_trace(mod, rungs_spec, index=7, start=None, **kw):
  pol = policy_of(mod, **kw)
  rungs = tuple(mod.Rung(name, fn(), layer=layer)
                for name, fn, layer in rungs_spec)
  task = mod.ChunkTask(index, rungs)
  try:
    out = pol.execute(task) if start is None else pol.execute_from(task, start)
    if hasattr(out, "resolve"):
      out = ("resolved", out.resolve())
  except Exception as e:
    out = ("raised", type(e).__name__)
  return out, pol.n_retries, pol.n_demotions, pol.demotions


LADDERS = {
    "healed": [("a", lambda: flaky(1, "healed"), "backend")],
    "demoted": [("fused-device", lambda: flaky(99), "device"),
                ("device", lambda: lambda: "fallback", "device")],
    "all-dead": [("a", lambda: flaky(99), "device"),
                 ("b", lambda: flaky(99), "device")],
    "killed": [("a", lambda: flaky(1, exc=RR.SweepKilled), "device"),
               ("b", lambda: lambda: "nope", "device")],
    "resolve-fails": [
        ("fused-device", lambda: lambda: _FakePending(flaky(99)), "device"),
        ("device", lambda: lambda: "recomputed", "device")],
    "three-rungs": [("x", lambda: flaky(99), "device"),
                    ("y", lambda: flaky(3), "device"),
                    ("z", lambda: lambda: "z", "backend")],
}


@pytest.mark.parametrize("name", sorted(LADDERS))
@pytest.mark.parametrize("start", [None, 1, 9])
def test_ladder_walk_equals_the_reference(name, start):
  spec = LADDERS[name]
  if name == "killed":  # each package's own SweepKilled
    spec_p = [("a", lambda: flaky(1, exc=PR.SweepKilled), "device"),
              spec[1]]
  else:
    spec_p = spec
  assert _ladder_trace(PR, spec_p, start=start) == \
      _ladder_trace(RR, spec, start=start)


def test_plain_callable_passes_through():
  assert policy_of().execute(lambda: 42) == 42
  assert policy_of().execute_from(lambda: 43, 5) == 43


def test_terminal_rung_pending_is_not_guarded():
  pend = _FakePending(lambda: "direct")
  task = PR.ChunkTask(0, (PR.Rung("device", lambda: pend, layer="device"),))
  assert policy_of().execute(task) is pend


def test_injected_hang_demotes_without_waiting():
  plan = PR.FaultPlan([PR.Fault("hang", 2, "device")])
  task = PR.ChunkTask(2, (
      PR.Rung("fused-device", lambda: _FakePending(lambda: "fused"),
              layer="device"),
      PR.Rung("device", lambda: "unfused", layer="device")))
  pol = policy_of(fault_plan=plan, resolve_timeout=5.0)
  assert pol.execute(task).resolve() == "unfused"
  assert pol.demotions == [(2, "fused-device", "resolve")]
  assert plan.n_fired == 1 and pol.watchdogs.n_spawned == 0


def test_watchdog_resolves_on_a_helper_thread_and_counts_leaks():
  """A resolution that outlives the watchdog's budget demotes; its helper
  thread stays registered until it ends (a bounded wait, released by the
  test, stands in for a slow resolution)."""
  release = threading.Event()
  seen = {}

  def slow():
    seen["thread"] = threading.current_thread().name
    release.wait(10.0)
    return "too-late"

  task = PR.ChunkTask(0, (
      PR.Rung("fused-device", lambda: _FakePending(slow,
                                                   torch.device("cpu")),
              layer="device"),
      PR.Rung("device", lambda: "rescued", layer="device")))
  pol = policy_of(resolve_timeout=0.05)
  assert pol.execute(task).resolve() == "rescued"
  assert pol.demotions == [(0, "fused-device", "resolve")]
  assert seen["thread"] != threading.current_thread().name
  assert pol.watchdogs.n_live() == 1
  release.set()
  assert pol.watchdogs.drain(timeout=10.0) == 0
  assert pol.watchdogs.n_spawned == 1 and pol.watchdogs.n_reaped == 1

  fast = PR.ChunkTask(1, (
      PR.Rung("fused-device", lambda: _FakePending(lambda: "fast"),
              layer="device"),
      PR.Rung("device", lambda: "unused", layer="device")))
  assert pol.execute(fast).resolve() == "fast"
  spent = policy_of(resolve_timeout=lambda: 0.0)
  assert spent.execute(fast).resolve() == "unused"
  assert spent.watchdogs.n_spawned == 0


# ---------------------------------------------------------------------------
# the checkpoint journal
# ---------------------------------------------------------------------------

def test_journal_round_trip_and_atomic_record(tmp_path):
  j = PR.SweepJournal(tmp_path)
  state = {"done": {0, 1}, "counters": {"n_rows": 64}}
  j.record("k" * 64, state)
  assert j.load("k" * 64) == state
  assert not list(tmp_path.glob("*.tmp"))
  j.record("k" * 64, {"done": {0, 1, 2}})
  assert j.load("k" * 64) == {"done": {0, 1, 2}}
  assert j.path("k" * 64) == RR.SweepJournal(tmp_path).path("k" * 64)


@pytest.mark.parametrize("garbage", [b"\x80truncated garbage", b"",
                                     b"not a pickle"])
def test_corrupt_or_truncated_records_are_fresh_starts(tmp_path, garbage):
  j = PR.SweepJournal(tmp_path)
  assert j.load("a" * 64) is None
  j.record("a" * 64, {"done": set()})
  with open(j.path("a" * 64), "wb") as f:
    f.write(garbage)
  assert j.load("a" * 64) is None
  good = pickle.dumps({"version": 1, "key": "a" * 64, "state": {"x": 1}})
  with open(j.path("a" * 64), "wb") as f:
    f.write(good[:len(good) // 2])
  assert j.load("a" * 64) is None


def test_key_and_version_mismatch_rejected(tmp_path):
  j = PR.SweepJournal(tmp_path)
  key, other = "a" * 64, "b" * 64
  with open(j.path(key), "wb") as f:
    pickle.dump({"version": 1, "key": other, "state": {}}, f)
  assert j.load(key) is None
  with open(j.path(key), "wb") as f:
    pickle.dump({"version": 999, "key": key, "state": {}}, f)
  assert j.load(key) is None


def test_append_log_replays_and_truncates_a_partial_frame(tmp_path):
  j = PR.SweepJournal(tmp_path)
  key = "c" * 64
  assert j.replay(key) == [] and j.load_last(key) is None
  for n in range(3):
    j.append(key, {"done": set(range(n + 1))})
  size = (tmp_path / f"sweep-{key[:32]}.log").stat().st_size
  with open(j.log_path(key), "ab") as f:
    f.write(b"SWPJ\x05")  # a kill mid-append
  states = j.replay(key)
  assert [len(s["done"]) for s in states] == [1, 2, 3]
  assert (tmp_path / f"sweep-{key[:32]}.log").stat().st_size == size
  # a corrupted digest ends the log there
  data = bytearray(open(j.log_path(key), "rb").read())
  data[-1] ^= 0xFF
  open(j.log_path(key), "wb").write(bytes(data))
  assert [len(s["done"]) for s in j.replay(key)] == [1, 2]
  j.rewrite(key, [{"done": {9}}])
  assert j.load_last(key) == {"done": {9}}
  # load_state: the style with more folded chunks wins
  j.record(key, {"done": {1, 2}})
  assert j.load_state(key) == {"done": {1, 2}}
  j.append(key, {"done": {1, 2, 3}})
  assert j.load_state(key) == {"done": {1, 2, 3}}
  # the reference's log frames are byte-compatible
  assert RR.SweepJournal(tmp_path).load_last(key) == {"done": {1, 2, 3}}


# ---------------------------------------------------------------------------
# fingerprints and journal keys: equal to the reference's as hex strings
# ---------------------------------------------------------------------------

def _spaces(mod):
  yield mod.DesignSpace()
  yield mod.DesignSpace(pe_types=("INT8", "LightPE-1"))
  yield mod.DesignSpace(pe_types=("INT8",),
                        axes={"pe_rows": (4, 8), "bandwidth_gbps": (1.5,)})
  yield mod.DesignSpace(constraints=(
      mod.vector_constraint(lambda c: c.pe_rows <= 16,
                            lambda t: t.pe_rows <= 16),))


@pytest.mark.parametrize("i", range(4))
def test_space_fingerprints_equal_the_reference(i):
  assert PR.space_fingerprint(list(_spaces(P))[i]) == \
      RR.space_fingerprint(list(_spaces(R))[i])


def _plans(mod):
  return [
      mod.streaming.default_explore_reducers(),
      mod.streaming.default_co_reducers(),
      {"pareto": mod.ParetoAccumulator(("perf_per_area", "energy_mj"),
                                       maximize=("perf_per_area",)),
       "top": mod.TopKAccumulator(7, by="energy_mj"),
       "top_mx": mod.TopKAccumulator(3, by="latency_s", maximize=True),
       "stats": mod.StatsAccumulator("energy_mj"),
       "hist": mod.HistogramAccumulator("area_mm2", 0.0, 200.0, bins=64),
       "all": mod.CollectAccumulator()},
  ]


@pytest.mark.parametrize("i", range(3))
def test_reducer_fingerprints_equal_the_reference(i):
  got, want = _plans(P)[i], _plans(R)[i]
  assert {k: r.fingerprint() for k, r in got.items()} == \
      {k: r.fingerprint() for k, r in want.items()}
  assert PR.reducers_fingerprint(got) == RR.reducers_fingerprint(want)


def _arch_accs(arch_cls, n=4, seed=7):
  rng = np.random.RandomState(seed)
  archs = [arch_cls(tuple((int(rng.choice(r)), int(rng.choice(c)))
                          for r, c in REF_SEARCH_SPACE)) for _ in range(n)]
  return list(zip(archs, rng.uniform(0.5, 0.95, n)))


@pytest.mark.parametrize("params", [
    dict(n_per_type=200, seed=17, method="random", chunk_size=65536,
         network="resnet20"),
    dict(n_per_type=40, seed=4, method="grid", chunk_size=32,
         network="net")])
def test_explore_sweep_keys_equal_the_reference(params):
  for i in range(3):
    assert PS.explore_sweep_key(P.DesignSpace(), _plans(P)[i], **params) == \
        RS.explore_sweep_key(R.DesignSpace(), _plans(R)[i], **params)


@pytest.mark.parametrize("params", [
    dict(n_hw_per_type=10, seed=3, image_size=16, method="random",
         chunk_size=13),
    dict(n_hw_per_type=2500, seed=3, image_size=32, method="grid",
         chunk_size=262144)])
def test_co_explore_sweep_keys_equal_the_reference(params):
  got = PS.co_explore_sweep_key(P.DesignSpace(), _plans(P)[1],
                                _arch_accs(ArchChoice), **params)
  want = RS.co_explore_sweep_key(R.DesignSpace(), _plans(R)[1],
                                 _arch_accs(RefArch), **params)
  assert got == want
  assert PR.arch_accs_fingerprint(*zip(*_arch_accs(ArchChoice))) == \
      RR.arch_accs_fingerprint(*zip(*_arch_accs(RefArch)))


def test_sweep_key_sensitivity_equals_the_reference():
  for mod in (PR, RR):
    base = dict(kind="explore", space_fp="s", reducers_fp="r",
                params={"seed": 3, "chunk_size": 64})
    k0 = mod.sweep_key(**base)
    assert mod.sweep_key("co-explore", "s", "r", base["params"]) != k0
    assert mod.sweep_key("explore", "s", "r",
                         {"seed": 4, "chunk_size": 64}) != k0
  assert PR.sweep_key(**base) == RR.sweep_key(**base)


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

def _tensors_in(obj, seen=None):
  """Every torch.Tensor reachable from ``obj`` (containers, dataclasses,
  object ``__dict__`` s, numpy arrays' bases)."""
  seen = set() if seen is None else seen
  if id(obj) in seen:
    return []
  seen.add(id(obj))
  if isinstance(obj, torch.Tensor):
    return [obj]
  found = []
  if isinstance(obj, np.ndarray):
    return _tensors_in(obj.base, seen) if obj.base is not None else []
  if isinstance(obj, dict):
    for k, v in obj.items():
      found += _tensors_in(k, seen) + _tensors_in(v, seen)
  elif isinstance(obj, (list, tuple, set, frozenset)):
    for v in obj:
      found += _tensors_in(v, seen)
  elif hasattr(obj, "__dict__"):
    found += _tensors_in(vars(obj), seen)
  return found


def test_the_scan_sees_a_tensor():
  assert _tensors_in({"a": [np.zeros(2), {"b": torch.zeros(1)}]})
  assert _tensors_in(torch.zeros(3).numpy())


def test_reducer_snapshot_restore_is_isolated_and_class_checked():
  frame = P.ResultFrame(np.array([1.0, 2.0]), np.array([3.0, 1.0]),
                        np.array([1.0, 1.0]), np.array(["INT8", "INT8"]))
  acc = P.ParetoAccumulator(("latency_s", "power_mw"))
  acc.fold(frame, np.array([0, 1]))
  snap = acc.snapshot()
  acc.fold(P.ResultFrame(np.array([0.5]), np.array([0.5]), np.array([1.0]),
                         np.array(["INT8"])), np.array([2]))
  fresh = P.ParetoAccumulator(("latency_s", "power_mw"))
  fresh.restore(snap)
  np.testing.assert_array_equal(fresh.indices, [0, 1])
  with pytest.raises(ValueError):
    P.StatsAccumulator("energy_mj").restore(snap)


# ---------------------------------------------------------------------------
# streamed sweeps: kill at every chunk boundary, resume, compare
# ---------------------------------------------------------------------------

def co_reducers(mod):
  return {"pareto": mod.ParetoAccumulator(JOINT3),
          "top": mod.TopKAccumulator(7, by="energy_mj"),
          "stats": mod.StatsAccumulator("energy_mj")}


def run_co(sess, arch_accs, mod=P, **kw):
  return sess.co_explore(arch_accs, n_hw_per_type=10, seed=3, image_size=16,
                         stream=True, reducers=co_reducers(mod),
                         chunk_size=13, **kw)


def assert_same(got, want, names=("pareto", "top")):
  for name in names:
    assert len(got[name]) == len(want[name]), name
    for col in METRICS:
      np.testing.assert_array_equal(got[name].column(col),
                                    want[name].column(col),
                                    err_msg=f"{name} {col}")
  np.testing.assert_array_equal(got["pareto"].extra["arch_id"],
                                want["pareto"].extra["arch_id"])
  for k, v in want["stats"].items():
    assert got["stats"][k] == pytest.approx(v, rel=1e-12), k


@pytest.fixture(scope="module")
def co_setup():
  sess = P.ExplorationSession(P.TorchOracleBackend(device="cpu"))
  arch_accs = _arch_accs(ArchChoice)
  ref_sess = R.ExplorationSession(R.VectorOracleBackend(chunk_size=512))
  want = run_co(ref_sess, _arch_accs(RefArch), mod=R, workers=1)
  return sess, arch_accs, run_co(sess, arch_accs), want


def test_co_stream_equals_the_reference(co_setup):
  _, _, base, want = co_setup
  assert_same(base, want)
  assert base.meta["n_chunks"] == want.meta["n_chunks"] >= 10


def test_co_stream_killed_at_every_chunk_resumes_identically(co_setup,
                                                             tmp_path):
  sess, arch_accs, base, _ = co_setup
  n_chunks = int(base.meta["n_chunks"])
  for k in range(n_chunks):
    jdir = tmp_path / f"kill-{k}"
    pol = PR.ResiliencePolicy(retry=no_wait(PR), fault_plan=PR.FaultPlan(
        [PR.Fault("kill", k, "task")]))
    with pytest.raises(PR.ChunkError) as err:
      run_co(sess, arch_accs, policy=pol, resume_from=jdir)
    assert err.value.chunk_index == k
    assert isinstance(err.value.__cause__, PR.SweepKilled)
    res = run_co(sess, arch_accs, resume_from=jdir)
    assert_same(res, base)
    # chunks still in the dispatch window at the kill were not folded,
    # so they are not in the journal: they run again
    assert res.meta["n_resumed_chunks"] == float(max(0, k - PS.DISPATCH_AHEAD))
    assert res.meta["n_chunks"] == float(n_chunks)
    assert res.n_rows == base.n_rows


def test_explore_stream_killed_at_every_chunk_resumes_identically(tmp_path):
  layers = get_network("resnet20")[:3]
  sess = P.ExplorationSession(P.TorchOracleBackend(device="cpu"))
  kw = dict(n_per_type=24, seed=4, stream=True, chunk_size=16)

  def reducers():
    return {"pareto": P.ParetoAccumulator(),
            "pareto3": P.ParetoAccumulator(("latency_s", "energy_mj",
                                            "area_mm2")),
            "top": P.TopKAccumulator(5, by="energy_mj"),
            "stats": P.StatsAccumulator("energy_mj"),
            "hist": P.HistogramAccumulator("area_mm2", 0.0, 200.0, bins=8)}

  base = sess.explore(layers, "net", reducers=reducers(), **kw)
  ref = R.ExplorationSession(R.VectorOracleBackend()).explore(
      ref_get_network("resnet20")[:3], "net", workers=1, reducers={
          "pareto": R.ParetoAccumulator(), "top": R.TopKAccumulator(
              5, by="energy_mj")}, **kw)
  for name in ("pareto", "top"):
    for col in METRICS:
      np.testing.assert_array_equal(base[name].column(col),
                                    ref[name].column(col))
  n_chunks = int(base.meta["n_chunks"])
  assert n_chunks == 8  # per PE type, 16 rows then 8
  for k in range(n_chunks):
    jdir = tmp_path / f"kill-{k}"
    pol = PR.ResiliencePolicy(retry=no_wait(PR), fault_plan=PR.FaultPlan(
        [PR.Fault("kill", k, "task")]))
    with pytest.raises(PR.ChunkError):
      sess.explore(layers, "net", reducers=reducers(), policy=pol,
                   resume_from=jdir, **kw)
    journal = PR.SweepJournal(jdir)
    state = journal.load(PS.explore_sweep_key(
        sess.space, reducers(), n_per_type=24, seed=4, method="random",
        chunk_size=16, network="net"))
    assert not _tensors_in(state)
    assert state["done"] == set(range(max(0, k - PS.DISPATCH_AHEAD)))
    res = sess.explore(layers, "net", reducers=reducers(), resume_from=jdir,
                       **kw)
    for name in ("pareto", "pareto3", "top"):
      for col in METRICS:
        np.testing.assert_array_equal(res[name].column(col),
                                      base[name].column(col))
    np.testing.assert_array_equal(res["hist"]["counts"],
                                  base["hist"]["counts"])
    assert res["stats"] == base["stats"]


def test_finished_journal_resumes_everything(co_setup, tmp_path):
  sess, arch_accs, base, _ = co_setup
  first = run_co(sess, arch_accs, resume_from=tmp_path)
  res = run_co(sess, arch_accs, resume_from=tmp_path)
  assert_same(first, base)
  assert_same(res, base)
  assert res.meta["n_resumed_chunks"] == base.meta["n_chunks"]
  for p in tmp_path.glob("sweep-*.pkl"):
    p.write_bytes(b"not a pickle")
  res = run_co(sess, arch_accs, resume_from=tmp_path)
  assert_same(res, base)
  assert res.meta["n_resumed_chunks"] == 0.0


def test_transient_faults_healed_in_place(co_setup):
  sess, arch_accs, base, _ = co_setup
  plan = PR.FaultPlan([PR.Fault("raise", 2, "task"),
                       PR.Fault("raise", 5, "task")])
  res = run_co(sess, arch_accs,
               policy=PR.ResiliencePolicy(retry=no_wait(PR), fault_plan=plan))
  assert_same(res, base)
  assert (res.meta["n_retries"], res.meta["n_demotions"]) == (2.0, 0.0)
  assert res.meta["n_leaked_watchdogs"] == 0.0


def test_fault_free_policy_counts_nothing(co_setup):
  sess, arch_accs, base, _ = co_setup
  pol = PR.ResiliencePolicy(retry=no_wait(PR), resolve_timeout=30.0,
                            breaker=PR.CircuitBreaker())
  res = run_co(sess, arch_accs, policy=pol)
  assert_same(res, base)
  assert res.meta["n_retries"] == res.meta["n_demotions"] == 0.0
  assert res.meta["n_leaked_watchdogs"] == 0.0
  assert res.meta["breaker_state"] == "closed"
  assert pol.watchdogs.n_spawned == 0  # every guarded handle resolved in time


# ---------------------------------------------------------------------------
# the port's ladders: device rungs only, and fatal when they all fail
# ---------------------------------------------------------------------------

def test_device_faults_demote_along_the_cpu_ladder():
  layers = get_network("resnet20")[:4]
  sess = P.ExplorationSession(P.TorchOracleBackend(device="cpu"))

  def go(policy=None):
    return sess.explore(layers, "net", n_per_type=40, seed=4, stream=True,
                        chunk_size=32, policy=policy, reducers={
                            "pareto": P.ParetoAccumulator(),
                            "top": P.TopKAccumulator(5, by="energy_mj")})

  ref = go()
  # three failures exhaust the fused rung (max_retries=2); the unfused
  # device rung then computes the chunk, bit-identically
  plan = PR.FaultPlan([PR.Fault("raise", 1, "device", times=3),
                       PR.Fault("hang", 3, "device")])
  pol = PR.ResiliencePolicy(retry=no_wait(PR), fault_plan=plan)
  res = go(pol)
  assert pol.demotions == [(1, "fused-device", "dispatch"),
                           (3, "fused-device", "resolve")]
  assert res.meta["n_retries"] == 2.0 and res.meta["n_demotions"] == 2.0
  for name in ("pareto", "top"):
    for col in METRICS:
      np.testing.assert_array_equal(res[name].column(col),
                                    ref[name].column(col))
  # a chunk that fails on every rung is fatal: there is no host rung
  pol = PR.ResiliencePolicy(retry=no_wait(PR), fault_plan=PR.FaultPlan(
      [PR.Fault("raise", 1, "device", times=99)]))
  with pytest.raises(PR.ChunkError) as err:
    go(pol)
  assert err.value.chunk_index == 1
  assert pol.demotions == [(1, "fused-device", "dispatch")]


def test_open_breaker_skips_to_the_terminal_device_rung():
  layers = get_network("resnet20")[:2]
  sess = P.ExplorationSession(P.TorchOracleBackend(device="cpu"))

  def go(policy=None):
    return sess.explore(layers, "net", n_per_type=20, seed=2, stream=True,
                        chunk_size=10, policy=policy)

  ref = go()
  breaker = PR.CircuitBreaker(threshold=1, cooldown=3, jitter=0)
  pol = PR.ResiliencePolicy(retry=no_wait(PR), breaker=breaker,
                            fault_plan=PR.FaultPlan(
                                [PR.Fault("raise", 0, "device", times=3)]))
  res = go(pol)
  assert breaker.n_opens == 1 and breaker.n_short_circuits >= 1
  assert res.meta["breaker_state"] in ("open", "half-open", "closed")
  for col in METRICS:
    np.testing.assert_array_equal(res["pareto"].column(col),
                                  ref["pareto"].column(col))


class _CardStandIn:
  """A backend that says it lives on a CUDA card, for checking which
  rungs a card backend's ladder holds (nothing here is ever called on a
  card: every dispatch fails, as a broken device would)."""
  name = "card-stand-in"
  device = torch.device("cuda")

  def __init__(self):
    self.calls = []

  def _fail(self, what):
    self.calls.append(what)
    raise RuntimeError(f"{what}: device lost")

  def evaluate_table(self, *a, **k):
    self.calls.append("evaluate_table")
    raise AssertionError("a card ladder must not reach a host rung")

  co_evaluate_table = evaluate_table

  def eval_pending(self, *a, **k):
    self._fail("device")

  def fused_eval_pending(self, *a, **k):
    self._fail("fused-device")

  co_eval_pending = eval_pending
  fused_co_eval_pending = fused_eval_pending

  def place_dedup(self, dedup):
    return dedup


def test_a_card_backend_ladder_names_no_cpu_rung():
  backend = _CardStandIn()
  layers = get_network("resnet20")[:2]
  tasks = list(PS.explore_tasks(backend, P.DesignSpace(), layers, "net",
                                n_per_type=8, seed=0, method="random",
                                chunk_size=16,
                                reducers=PS.default_explore_reducers()))
  co_tasks = list(PS.co_explore_tasks(
      backend, P.DesignSpace(), _arch_accs(ArchChoice, n=2), n_hw_per_type=4,
      seed=3, image_size=16, method="random", chunk_size=16,
      reducers=PS.default_co_reducers()))
  for task in tasks + co_tasks:
    assert [r.name for r in task.rungs] == ["fused-device", "device"]
    assert {r.layer for r in task.rungs} == {"device"}
  pol = PR.ResiliencePolicy(retry=no_wait(PR))
  with pytest.raises(PR.ChunkError) as err:
    PS.run_stream(iter(tasks), PS.default_explore_reducers(), policy=pol)
  assert err.value.chunk_index == 0
  assert pol.demotions == [(0, "fused-device", "dispatch")]
  assert "evaluate_table" not in backend.calls
  assert backend.calls == ["fused-device"] * 3 + ["device"] * 3
