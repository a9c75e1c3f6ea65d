"""The port's exploration service against the JAX package's, on the CPU:
admission, deadlines, budgets, cancellation, the shared breaker, store
hits and delta sweeps through sessions, concurrent-session chaos, and
``benchmarks/service_perf.py``'s recipe at its smoke scale.

Case for case with ``tests/test_service.py``'s service, breaker and
chaos tests where the case ports (its store, journal-log and delta cases
are in ``tests/test_torch_store.py``).  The invariant: any path through
the service — interleaved sessions, store hits, delta merges, breaker
reroutes, kill-resume — gives fronts and top-k bit-identical to a solo
run, and to the reference's numpy run; stats count/min/max exactly and
mean/std to a relative 1e-12 (R3).

One case diverges on purpose (H16 in ROADMAP.md): the reference's open
breaker routes chunks to its host numpy rung, the port's to the
backend's terminal rung (the unfused ``device`` rung), so the sick
stand-in backend here fails only its fused rung.
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import repro.explore as R
from repro.core.cnn import SEARCH_SPACE as REF_SEARCH_SPACE
from repro.core.workloads import get_network as ref_get_network

import repro_torch.explore as P
from repro_torch.core.cnn import ArchChoice
from repro_torch.core.ppa import HW_RANGES
from repro_torch.core.workloads import get_network
from repro_torch.explore.space import AXIS_ORDER

METRICS = ("latency_s", "power_mw", "area_mm2")
NETWORK = "resnet20"


def no_wait(mod=P):
  return mod.RetryPolicy(sleep=lambda s: None)


@pytest.fixture(scope="module")
def layers():
  return get_network(NETWORK)[:4]


@pytest.fixture(scope="module")
def ref_layers():
  return ref_get_network(NETWORK)[:4]


def _arch_accs(arch_cls):
  rng = np.random.RandomState(7)
  archs = [arch_cls(tuple((int(rng.choice(r)), int(rng.choice(c)))
                          for r, c in REF_SEARCH_SPACE)) for _ in range(4)]
  return list(zip(archs, rng.uniform(0.5, 0.95, len(archs))))


@pytest.fixture(scope="module")
def arch_accs():
  return _arch_accs(ArchChoice)


def backend():
  return P.TorchOracleBackend(chunk_size=256, device="cpu")


def sweep_reducers(mod=P):
  return {"pareto": mod.ParetoAccumulator(("latency_s", "power_mw")),
          "top": mod.TopKAccumulator(9, by="power_mw"),
          "stats": mod.StatsAccumulator("latency_s"),
          "hist": mod.HistogramAccumulator("power_mw", 0.0, 5e4, bins=32)}


def assert_frames_equal(got, want):
  for name in ("pareto", "top"):
    for col in METRICS[:2]:
      assert np.array_equal(getattr(got[name], col),
                            getattr(want[name], col)), (name, col)


def assert_stats_equal(got, want):
  gs, ws = got["stats"], want["stats"]
  assert gs["count"] == ws["count"]
  assert gs["min"] == ws["min"] and gs["max"] == ws["max"]
  assert_allclose(gs["mean"], ws["mean"], rtol=1e-12)
  assert_allclose(gs["std"], ws["std"], rtol=1e-12)
  assert np.array_equal(got["hist"]["counts"], want["hist"]["counts"])


def submit_sweep(svc, space, layers, seed=1, n=1200, **kw):
  return svc.submit_explore(space, layers, NETWORK, n_per_type=n,
                            seed=seed, chunk_size=256,
                            reducers=sweep_reducers(), **kw)


def solo_sweep(space, layers, seed=1, n=1200):
  return P.stream_explore(backend(), space, layers, network=NETWORK,
                          n_per_type=n, seed=seed, chunk_size=256,
                          reducers=sweep_reducers(), workers=2)


# ---------------------------------------------------------------------------
# Deadline
# ---------------------------------------------------------------------------

class TestDeadline:

  def test_fake_clock(self):
    t = {"now": 100.0}
    dl = P.Deadline(5.0, clock=lambda: t["now"])
    assert dl.remaining() == 5.0 and not dl.expired()
    t["now"] = 104.0
    assert dl.remaining() == pytest.approx(1.0)
    t["now"] = 105.0
    assert dl.expired()

  def test_real_clock_counts_down(self):
    dl = P.Deadline(60.0)
    assert 0.0 < dl.remaining() <= 60.0
    assert not dl.expired()


# ---------------------------------------------------------------------------
# circuit breaker (unit level, fake rungs shaped like the port's ladder)
# ---------------------------------------------------------------------------

def device_task(index, fused_fn, terminal="terminal"):
  return P.ChunkTask(index, (P.Rung("fused-device", fused_fn,
                                    layer="device"),
                             P.Rung("device", lambda: terminal,
                                    layer="device")))


class TestCircuitBreaker:

  def test_opens_after_consecutive_failures(self):
    br = P.CircuitBreaker(threshold=2, cooldown=3, jitter=0)
    br.allow_device(); br.record_failure()
    assert br.state == "closed"
    br.allow_device(); br.record_failure()
    assert br.state == "open" and br.n_opens == 1

  def test_success_resets_failure_streak(self):
    br = P.CircuitBreaker(threshold=2, cooldown=3, jitter=0)
    br.record_failure()
    br.record_success()
    br.record_failure()
    assert br.state == "closed"

  def test_open_short_circuits_device_rung(self):
    """H16: an open breaker routes past the fused rung to the terminal
    rung (the reference's host numpy rung; the port's own unfused one)."""
    br = P.CircuitBreaker(threshold=1, cooldown=10, jitter=0)
    pol = P.ResiliencePolicy(retry=no_wait(), breaker=br)
    calls = {"n": 0}

    def dead():
      calls["n"] += 1
      raise RuntimeError("wedged")

    assert pol.execute(device_task(0, dead)) == "terminal"
    assert br.state == "open"
    n_after_open = calls["n"]
    assert pol.execute(device_task(1, dead)) == "terminal"
    assert calls["n"] == n_after_open
    assert pol.n_demotions == 1

  def test_terminal_rung_does_not_reset_the_streak(self):
    """The terminal rung is the ladder's safe harbor and feeds the
    breaker nothing: a fused rung failing on every chunk opens it after
    ``threshold`` chunks, as the reference's does over its numpy rung."""
    got = P.CircuitBreaker(threshold=2, cooldown=10, jitter=0)
    want = R.CircuitBreaker(threshold=2, cooldown=10, jitter=0)

    def dead():
      raise RuntimeError("wedged")

    ppol = P.ResiliencePolicy(retry=no_wait(), breaker=got)
    rpol = R.ResiliencePolicy(retry=no_wait(R), breaker=want)
    for i in range(4):
      assert ppol.execute(device_task(i, dead)) == "terminal"
      assert rpol.execute(R.ChunkTask(i, (
          R.Rung("device", dead, layer="device"),
          R.Rung("numpy", lambda: "terminal")))) == "terminal"
      assert got.meta() == want.meta()
    assert got.state == "open" and ppol.n_demotions == rpol.n_demotions == 2

  def test_cooldown_probe_success_closes(self):
    br = P.CircuitBreaker(threshold=1, cooldown=2, jitter=0)
    br.allow_device(); br.record_failure()
    assert br.state == "open"
    assert not br.allow_device()
    assert br.allow_device()
    assert br.state == "half-open" and br.n_probes == 1
    br.record_success()
    assert br.state == "closed"

  def test_probe_failure_reopens(self):
    br = P.CircuitBreaker(threshold=1, cooldown=1, jitter=0)
    br.allow_device(); br.record_failure()
    assert br.allow_device()
    br.record_failure()
    assert br.state == "open" and br.n_opens == 2

  def test_transitions_and_meta(self):
    br = P.CircuitBreaker(threshold=1, cooldown=1, jitter=0)
    br.allow_device(); br.record_failure()
    br.allow_device(); br.record_success()
    states = [(f, t) for _, f, t in br.transitions]
    assert states == [("closed", "open"), ("open", "half-open"),
                      ("half-open", "closed")]
    meta = br.meta()
    assert meta["breaker_state"] == "closed"
    assert meta["n_breaker_opens"] == 1.0
    assert meta["n_breaker_probes"] == 1.0

  def test_seeded_jitter_is_deterministic(self):
    def opens(mod, seed):
      br = mod.CircuitBreaker(threshold=1, cooldown=2, jitter=3, seed=seed)
      br.record_failure()
      n = 0
      while not br.allow_device():
        n += 1
      return n
    assert opens(P, 0) == opens(P, 0) == opens(R, 0)

  def test_validation(self):
    with pytest.raises(ValueError):
      P.CircuitBreaker(threshold=0)
    with pytest.raises(ValueError):
      P.CircuitBreaker(cooldown=0)


# ---------------------------------------------------------------------------
# the service: admission, fairness, deadlines, budgets, store hits
# ---------------------------------------------------------------------------

class TestService:

  def test_concurrent_sessions_match_solo(self, layers, ref_layers):
    space = P.DesignSpace()
    refs = [solo_sweep(space, layers, seed=s) for s in (1, 2, 3)]
    svc = P.ExplorationService(backend(), slots=3)
    handles = [submit_sweep(svc, space, layers, seed=s) for s in (1, 2, 3)]
    assert svc.drain() == 3
    for s, h, ref in zip((1, 2, 3), handles, refs):
      res = h.result()
      assert_frames_equal(res, ref)
      assert_stats_equal(res, ref)
      assert res.n_rows == ref.n_rows
      # and the reference's numpy stream
      want = R.stream_explore(R.VectorOracleBackend(chunk_size=256),
                              R.DesignSpace(), ref_layers, network=NETWORK,
                              n_per_type=1200, seed=s, chunk_size=256,
                              reducers=sweep_reducers(R), workers=1)
      assert_frames_equal(res, want)
      assert_stats_equal(res, want)

  def test_fair_interleaving(self, layers):
    space = P.DesignSpace()
    ref = solo_sweep(space, layers, seed=1)
    svc = P.ExplorationService(backend(), slots=2, max_queued=8)
    handles = [submit_sweep(svc, space, layers, seed=1) for _ in range(4)]
    assert svc.drain() == 4
    for h in handles:
      assert_frames_equal(h.result(), ref)

  def test_admission_rejected_typed(self, layers):
    space = P.DesignSpace()
    svc = P.ExplorationService(backend(), slots=1, max_queued=1)
    submit_sweep(svc, space, layers, seed=1)
    submit_sweep(svc, space, layers, seed=2)
    with pytest.raises(P.AdmissionRejected) as err:
      submit_sweep(svc, space, layers, seed=3)
    assert err.value.queued == 1 and err.value.max_queued == 1
    assert svc.service_meta()["n_rejected"] == 1
    assert svc.drain() == 2

  def test_budget_exhausted_then_resumed(self, layers, tmp_path):
    space = P.DesignSpace()
    ref = solo_sweep(space, layers, seed=1, n=3000)
    svc = P.ExplorationService(backend(), slots=1, store=str(tmp_path))
    h = submit_sweep(svc, space, layers, seed=1, n=3000, chunk_budget=3)
    svc.drain()
    with pytest.raises(P.BudgetExhausted):
      h.result()
    assert h.status == "failed"
    svc2 = P.ExplorationService(backend(), slots=1, store=str(tmp_path))
    h2 = submit_sweep(svc2, space, layers, seed=1, n=3000)
    svc2.drain()
    res = h2.result()
    # the budget stops dispatch at 3 chunks; the dispatch window's
    # chunks were not folded, so the journal holds 3 - DISPATCH_AHEAD
    assert res.meta["n_resumed_chunks"] == float(
        3 - P.streaming.DISPATCH_AHEAD)
    assert_frames_equal(res, ref)
    assert_stats_equal(res, ref)

  def test_deadline_expiry_spares_neighbors(self, layers):
    space = P.DesignSpace()
    ref = solo_sweep(space, layers, seed=2)
    t = {"now": 0.0}
    svc = P.ExplorationService(backend(), slots=2)
    doomed = submit_sweep(svc, space, layers, seed=1, n=3000,
                          deadline=P.Deadline(5.0, clock=lambda: t["now"]))
    healthy = submit_sweep(svc, space, layers, seed=2)
    t["now"] = 10.0
    svc.drain()
    with pytest.raises(P.DeadlineExceeded):
      doomed.result()
    assert doomed.status == "expired"
    assert_frames_equal(healthy.result(), ref)

  def test_deadline_threads_into_resolve_timeout(self):
    t = {"now": 0.0}
    svc = P.ExplorationService(backend(), resolve_timeout=60.0)
    pol = svc._session_policy(P.Deadline(5.0, clock=lambda: t["now"]))
    assert pol.resolve_timeout() == 5.0
    t["now"] = 3.0
    assert pol.resolve_timeout() == pytest.approx(2.0)
    t["now"] = 99.0
    assert pol.resolve_timeout() == 0.0

  def test_cancel_is_cooperative(self, layers):
    space = P.DesignSpace()
    svc = P.ExplorationService(backend(), slots=1)
    h = submit_sweep(svc, space, layers, seed=1)
    h.cancel()
    svc.drain()
    with pytest.raises(P.SessionCancelled):
      h.result()
    assert h.status == "cancelled"

  def test_store_hit_bit_identical(self, layers, tmp_path):
    space = P.DesignSpace()
    svc = P.ExplorationService(backend(), slots=1, store=str(tmp_path))
    h1 = submit_sweep(svc, space, layers, seed=1)
    svc.drain()
    ref = h1.result()
    h2 = submit_sweep(svc, space, layers, seed=1)
    res = h2.result()
    assert res.meta["store_hit"] == 1.0
    assert_frames_equal(res, ref)
    assert_stats_equal(res, ref)
    assert svc.service_meta()["n_store_hits"] == 1

  def test_store_hits_bypass_admission(self, layers, tmp_path):
    space = P.DesignSpace()
    svc = P.ExplorationService(backend(), slots=1, max_queued=1,
                               store=str(tmp_path))
    h = submit_sweep(svc, space, layers, seed=1)
    svc.drain()
    h.result()
    submit_sweep(svc, space, layers, seed=2)
    submit_sweep(svc, space, layers, seed=3)
    hit = submit_sweep(svc, space, layers, seed=1)
    assert hit.status == "done"

  def test_background_thread_mode(self, layers):
    space = P.DesignSpace()
    ref = solo_sweep(space, layers, seed=1)
    svc = P.ExplorationService(backend(), slots=2)
    svc.start()
    try:
      h = submit_sweep(svc, space, layers, seed=1)
      assert_frames_equal(h.result(timeout=120.0), ref)
    finally:
      svc.stop()

  def test_result_timeout_is_bounded(self, layers):
    space = P.DesignSpace()
    svc = P.ExplorationService(backend(), slots=1)
    h = submit_sweep(svc, space, layers, seed=1)
    with pytest.raises(TimeoutError):
      h.result(timeout=0.2)

  def test_search_session_matches_solo(self, layers):
    space = P.DesignSpace()
    sess = P.ExplorationSession(backend(), space)
    ref = sess.optimize(layers=layers, network=NETWORK, population=12,
                        generations=3, seed=9)
    svc = P.ExplorationService(backend(), slots=2)
    hs = svc.submit_search(space, layers, network=NETWORK, population=12,
                           generations=3, seed=9)
    he = submit_sweep(svc, space, layers, seed=1)
    svc.drain()
    res = hs.result()
    for col in METRICS[:2]:
      assert np.array_equal(getattr(res["pareto"], col),
                            getattr(ref["pareto"], col)), col
    assert he.result().n_rows > 0

  def test_search_deadline_cancels_cooperatively(self, layers):
    space = P.DesignSpace()
    t = {"now": 0.0}
    svc = P.ExplorationService(backend(), slots=1)
    h = svc.submit_search(space, layers, network=NETWORK, population=12,
                          generations=50, seed=9,
                          deadline=P.Deadline(5.0, clock=lambda: t["now"]))
    t["now"] = 10.0
    svc.drain()
    with pytest.raises(P.DeadlineExceeded):
      h.result()
    assert h.status == "expired"

  def test_co_explore_sessions(self, layers, arch_accs, tmp_path):
    space = P.DesignSpace()
    cols = ("top1_err", "energy_mj", "area_mm2")
    co_red = lambda: {"pareto": P.ParetoAccumulator(cols)}  # noqa: E731
    ref = P.stream_co_explore(backend(), space, arch_accs, n_hw_per_type=10,
                              seed=3, image_size=16, reducers=co_red(),
                              chunk_size=64, workers=2)
    svc = P.ExplorationService(backend(), slots=2, store=str(tmp_path))
    h = svc.submit_co_explore(space, arch_accs, n_hw_per_type=10, seed=3,
                              image_size=16, reducers=co_red(),
                              chunk_size=64)
    svc.drain()
    res = h.result()
    for col in METRICS:
      assert np.array_equal(getattr(res["pareto"], col),
                            getattr(ref["pareto"], col)), col
    assert np.array_equal(res["pareto"].extra["arch_id"],
                          ref["pareto"].extra["arch_id"])
    h2 = svc.submit_co_explore(space, arch_accs, n_hw_per_type=10, seed=3,
                               image_size=16, reducers=co_red(),
                               chunk_size=64)
    assert h2.result().meta["store_hit"] == 1.0

  def test_sessions_over_a_pool(self, layers, arch_accs):
    """Sessions pinned over a pool of CPU slots, a 3-D front among their
    reducers (the K1 branch), equal their solo runs."""
    space = P.DesignSpace()

    def reds():
      out = sweep_reducers()
      out["pareto3"] = P.ParetoAccumulator(("latency_s", "energy_mj",
                                            "area_mm2"))
      return out

    pool = P.DevicePool(devices=["cpu"] * 3)
    svc = P.ExplorationService(backend(), slots=2, pool=pool)
    handles = [svc.submit_explore(space, layers, NETWORK, n_per_type=700,
                                  seed=s, chunk_size=256, reducers=reds())
               for s in (1, 2)]
    svc.drain()
    for s, h in zip((1, 2), handles):
      got = h.result()
      want = P.stream_explore(backend(), space, layers, network=NETWORK,
                              n_per_type=700, seed=s, chunk_size=256,
                              reducers=reds(), workers=1)
      assert_frames_equal(got, want)
      for col in METRICS:
        np.testing.assert_array_equal(got["pareto3"].column(col),
                                      want["pareto3"].column(col))
      assert got["stats"] == want["stats"]
      assert got.meta["fleet_devices"] == 3.0
    assert sum(pool.meta()["fleet_device_chunks"]) == \
        sum(h.result().meta["n_chunks"] for h in handles)


# ---------------------------------------------------------------------------
# chaos: concurrent sessions under injected faults, kills, sick devices
# ---------------------------------------------------------------------------

class _SickFusedBackend:
  """A backend whose fused rung always fails; its unfused ``device`` rung
  (the terminal rung of the port's ladder, H16) and ``evaluate_table``
  delegate to the real CPU backend, so rerouted results stay exact."""

  name = "sick-fused"
  prefers_table = True

  def __init__(self):
    self._inner = backend()
    self.device = self._inner.device
    self.n_device_calls = 0

  def evaluate_table(self, table, layers, network="net"):
    return self._inner.evaluate_table(table, layers, network)

  def fused_eval_pending(self, chunk, layers, network, plan, idx):
    self.n_device_calls += 1
    raise RuntimeError("device runtime wedged")

  def eval_pending(self, chunk, layers, network, idx):
    return self._inner.eval_pending(chunk, layers, network, idx)


class TestServiceChaos:

  def test_sessions_race_under_faults_bit_identical(self, layers):
    space = P.DesignSpace()
    refs = {s: solo_sweep(space, layers, seed=s) for s in (1, 2, 3)}
    plan = P.FaultPlan.seeded(seed=11, n_chunks=12, p_raise=0.4,
                              layer="task", times=2)
    svc = P.ExplorationService(backend(), slots=3, retry=no_wait(),
                               fault_plan=plan)
    handles = {s: submit_sweep(svc, space, layers, seed=s)
               for s in (1, 2, 3)}
    assert svc.drain() == 3
    for s, h in handles.items():
      res = h.result()
      assert_frames_equal(res, refs[s])
      assert_stats_equal(res, refs[s])
    assert plan.n_fired > 0

  def test_kill_mid_drain_then_resume(self, layers, tmp_path):
    space = P.DesignSpace()
    refs = {s: solo_sweep(space, layers, seed=s, n=2500) for s in (1, 2)}
    plan = P.FaultPlan([P.Fault("kill", 4, "task")])
    svc = P.ExplorationService(backend(), slots=2, store=str(tmp_path),
                               fault_plan=plan)
    h1 = submit_sweep(svc, space, layers, seed=1, n=2500)
    h2 = submit_sweep(svc, space, layers, seed=2, n=2500)
    with pytest.raises(P.SweepKilled):
      svc.drain()
    assert h1.status == "failed" and h2.status == "failed"
    svc2 = P.ExplorationService(backend(), slots=2, store=str(tmp_path))
    g1 = submit_sweep(svc2, space, layers, seed=1, n=2500)
    g2 = submit_sweep(svc2, space, layers, seed=2, n=2500)
    svc2.drain()
    for g, s in ((g1, 1), (g2, 2)):
      res = g.result()
      assert res.meta["n_resumed_chunks"] > 0
      assert_frames_equal(res, refs[s])
      assert_stats_equal(res, refs[s])

  def test_sick_device_opens_breaker(self, layers):
    """H16: persistently failing fused rungs open the shared breaker;
    later chunks go straight to the terminal ``device`` rung (no more
    fused calls, no more demotions) and results stay bit-identical."""
    space = P.DesignSpace()
    ref = solo_sweep(space, layers, seed=1, n=4000)
    sick = _SickFusedBackend()
    br = P.CircuitBreaker(threshold=2, cooldown=1000, jitter=0)
    svc = P.ExplorationService(sick, slots=1, retry=no_wait(), breaker=br)
    h = submit_sweep(svc, space, layers, seed=1, n=4000)
    svc.drain()
    res = h.result()
    assert res.meta["breaker_state"] == "open"
    assert res.meta["n_breaker_opens"] == 1.0
    assert res.meta["n_breaker_short_circuits"] > 0
    assert any(f == "closed" and t == "open"
               for _, f, t in res.meta["breaker_transitions"])
    assert sick.n_device_calls < res.meta["n_chunks"] * 2
    assert res.meta["n_demotions"] < res.meta["n_chunks"]
    assert_frames_equal(res, ref)
    assert_stats_equal(res, ref)

  def test_breaker_shared_across_sessions(self, layers):
    space = P.DesignSpace()
    sick = _SickFusedBackend()
    br = P.CircuitBreaker(threshold=2, cooldown=10_000, jitter=0)
    svc = P.ExplorationService(sick, slots=1, retry=no_wait(), breaker=br)
    ha = submit_sweep(svc, space, layers, seed=1)
    svc.drain()
    calls_after_a = sick.n_device_calls
    hb = submit_sweep(svc, space, layers, seed=2)
    svc.drain()
    assert sick.n_device_calls == calls_after_a
    assert hb.result().meta["breaker_state"] == "open"
    assert_frames_equal(ha.result(), solo_sweep(space, layers, seed=1))


# ---------------------------------------------------------------------------
# benchmarks/service_perf.py's recipe at its smoke scale
# ---------------------------------------------------------------------------

SMOKE_TAKE = {"pe_rows": 3, "pe_cols": 3, "sp_if": 2, "sp_fw": 2,
              "sp_ps": 2, "gbuf_kb": 1, "bandwidth_gbps": 1}


def _service_perf(mod, make_backend, layers, tmp_path):
  """The recipe of ``benchmarks/service_perf.py`` at
  ``SERVICE_BENCH_SCALE=smoke`` (chunk 512, 500 random designs a type in
  the chaos phase), for either package; returns the record's counts and
  bit-identity flags."""
  axes = {name: HW_RANGES[name][:SMOKE_TAKE[name]] for name in AXIS_ORDER}
  base_space = mod.DesignSpace(axes=axes)
  edited = dict(axes)
  edited["pe_rows"] = HW_RANGES["pe_rows"][:SMOKE_TAKE["pe_rows"] + 1]
  edited_space = mod.DesignSpace(axes=edited)

  def reducers():
    return {"pareto": mod.ParetoAccumulator(("latency_s", "power_mw")),
            "top": mod.TopKAccumulator(50, by="power_mw")}

  def identical(got, want):
    return all(
        np.array_equal(getattr(got["pareto"], c), getattr(want["pareto"], c))
        and np.array_equal(getattr(got["top"], c), getattr(want["top"], c))
        for c in METRICS)

  def grid_submit(svc, space):
    return svc.submit_explore(space, layers, NETWORK,
                              n_per_type=space.per_type_grid_size(),
                              method="grid", chunk_size=512,
                              reducers=reducers())

  svc = mod.ExplorationService(make_backend(), slots=2, store=str(tmp_path))
  h_cold = grid_submit(svc, base_space)
  svc.drain()
  cold = h_cold.result()
  hit = grid_submit(svc, base_space).result()
  h_delta = grid_submit(svc, edited_space)
  svc.drain()
  delta = h_delta.result()
  kw = {} if mod is P else {"workers": 1}
  scratch = mod.stream_explore(make_backend(), edited_space, layers,
                               network=NETWORK,
                               n_per_type=edited_space.per_type_grid_size(),
                               method="grid", reducers=reducers(),
                               chunk_size=512, **kw)
  space = mod.DesignSpace()
  refs = {s: mod.stream_explore(make_backend(), space, layers,
                                network=NETWORK, n_per_type=500, seed=s,
                                reducers=reducers(), chunk_size=512, **kw)
          for s in (1, 2)}
  plan = mod.FaultPlan.seeded(seed=5, n_chunks=16, p_raise=0.5,
                              layer="task", times=2)
  chaos = mod.ExplorationService(make_backend(), slots=2,
                                 retry=no_wait(mod), fault_plan=plan,
                                 breaker=mod.CircuitBreaker(threshold=2))
  handles = {s: chaos.submit_explore(space, layers, NETWORK, n_per_type=500,
                                     seed=s, chunk_size=512,
                                     reducers=reducers())
             for s in (1, 2)}
  chaos.drain()
  record = {
      "n_pairs": int(scratch.n_rows), "base_rows": int(cold.n_rows),
      "delta_rows": int(delta.meta.get("n_delta_rows", 0)),
      "store_hit_taken": hit.meta.get("store_hit") == 1.0,
      "store_hit_bit_identical": identical(hit, cold),
      "delta_sweep_taken": delta.meta.get("delta_sweep") == 1.0,
      "delta_bit_identical": identical(delta, scratch)
      and delta.n_rows == scratch.n_rows,
      "chaos_faults_fired": int(plan.n_fired),
      "chaos_bit_identical": all(identical(handles[s].result(), refs[s])
                                 for s in (1, 2))}
  service = svc.service_meta()
  return record, {k: service[k] for k in (
      "n_admitted", "n_completed", "n_store_hits", "n_delta_sweeps",
      "store_n_hits", "store_n_misses", "store_n_quarantined")}, \
      (cold, hit, delta)


def test_service_perf_smoke_equals_the_reference_record(layers, ref_layers,
                                                        tmp_path):
  """``results/BENCH_service_smoke.json``'s counts (288 base rows, 96
  delta rows, 384 pairs, one store hit, 6 chaos faults, every identity
  flag true) from the port, and the same fronts as the reference's run
  of the recipe."""
  got, svc_meta, frames = _service_perf(P, backend, layers, tmp_path / "p")
  want, ref_meta, ref_frames = _service_perf(
      R, lambda: R.VectorOracleBackend(chunk_size=512), ref_layers,
      tmp_path / "r")
  assert got == want == {
      "n_pairs": 384, "base_rows": 288, "delta_rows": 96,
      "store_hit_taken": True, "store_hit_bit_identical": True,
      "delta_sweep_taken": True, "delta_bit_identical": True,
      "chaos_faults_fired": 6, "chaos_bit_identical": True}
  assert svc_meta == ref_meta == {
      "n_admitted": 3, "n_completed": 3, "n_store_hits": 1,
      "n_delta_sweeps": 1, "store_n_hits": 2, "store_n_misses": 2,
      "store_n_quarantined": 0}
  for a, b in zip(frames, ref_frames):
    for name in ("pareto", "top"):
      for col in METRICS:
        np.testing.assert_array_equal(a[name].column(col),
                                      b[name].column(col))
