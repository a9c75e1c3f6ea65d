"""The port's device fleet and worker pool against the JAX package's, on
the CPU.

Case for case with ``tests/test_fleet.py`` where the case ports:
``DevicePool`` admission, quarantine and the half-open probe; fleet-layer
fault injection; chaos at every chunk boundary; the SDC sentinel;
watchdog accounting.  Fronts and top-k must be bit-identical to a solo
single-device run and, on real sweeps, to the reference's numpy path.
The port folds fleet and threaded results in chunk-index order, so stats
are bit-identical to the solo run too (the reference holds them to a
relative 1e-12: its fleet folds in completion order).

Two cases diverge from the reference on purpose (H13 in ROADMAP.md): a
pool whose every device is quarantined raises ``ChunkError`` (the
reference runs the chunk on its host numpy rung), and the SDC sentinel
recomputes its sample chunk under a pin to the CPU.  The reference's
eight forced XLA devices become a pool of eight explicit CPU slots.
"""
import random
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.explore as R
from repro.core.workloads import get_network as ref_get_network
from repro.train import fault_tolerance as RFT

import repro_torch.explore as P
from repro_torch.core.cnn import SEARCH_SPACE, ArchChoice
from repro_torch.core.workloads import get_network
from repro_torch.explore import fleet as PF
from repro_torch.explore import streaming as PS
from repro_torch.explore.frame import ResultFrame
from repro_torch.explore.resilience import ANY_CHUNK, WatchdogRegistry
from repro_torch.train import fault_tolerance as PFT

METRICS = ("latency_s", "power_mw", "area_mm2")
ROWS = 6


def no_wait() -> P.RetryPolicy:
  return P.RetryPolicy(sleep=lambda s: None)


def chunk_result(i: int, n: int = ROWS):
  """Pure function of the chunk index — the fleet bit-identity premise."""
  rng = np.random.RandomState(1000 + i)
  frame = ResultFrame(rng.rand(n), rng.rand(n), rng.rand(n),
                      ["pe"] * n, (), "net")
  return frame, np.arange(i * n, (i + 1) * n, dtype=np.int64)


def fleet_tasks(n_chunks: int):
  """ChunkTasks shaped like the port's card ladder: a ``fused-device``
  and a terminal ``device`` rung, both pure functions of the index (the
  parity the SDC sentinel relies on holds by construction)."""
  return [P.ChunkTask(i, (
      P.Rung("fused-device", lambda i=i: chunk_result(i), layer="device"),
      P.Rung("device", lambda i=i: chunk_result(i), layer="device")))
      for i in range(n_chunks)]


def make_pool(n_devices: int = 4, **kw) -> P.DevicePool:
  kw.setdefault("speculation_factor", 4.0)
  return P.DevicePool(devices=[f"fake{i}" for i in range(n_devices)], **kw)


def reducer_set():
  return {"pareto": P.ParetoAccumulator(),
          "top": P.TopKAccumulator(k=5, by="latency_s"),
          "stats": P.StatsAccumulator("latency_s")}


def solo_result(n_chunks: int):
  return P.run_stream(fleet_tasks(n_chunks), reducer_set())


def assert_fronts_identical(res, ref):
  for name in ("pareto", "top"):
    a, b = res.results[name], ref.results[name]
    for col in METRICS:
      assert np.array_equal(getattr(a, col), getattr(b, col)), (name, col)
  # the port folds in chunk-index order: stats are bit-identical too
  assert res.results["stats"] == ref.results["stats"]
  assert res.n_rows == ref.n_rows


# ---------------------------------------------------------------------------
# pinning
# ---------------------------------------------------------------------------

class TestPin:

  def test_pin_nests_and_restores(self):
    assert PF.pinned_device() is None
    with PF.pin("d0"):
      assert PF.pinned_device() == "d0"
      with PF.pin("d1"):
        assert PF.pinned_device() == "d1"
      assert PF.pinned_device() == "d0"
    assert PF.pinned_device() is None

  def test_pin_is_thread_local(self):
    seen = []
    with PF.pin("main-dev"):
      t = threading.Thread(target=lambda: seen.append(PF.pinned_device()))
      t.start()
      t.join(5.0)
    assert seen == [None]

  def test_backend_places_on_the_pin(self):
    """A CPU pin sends a backend's placement and program to the CPU; the
    pending handle carries the pinned device."""
    backend = P.TorchOracleBackend(device="cpu")
    table = P.DesignSpace().sample_table(3, seed=1)
    layers = tuple(get_network("resnet20")[:2])
    plain = backend.eval_pending(table, layers, "net",
                                 np.arange(len(table))).resolve()[0]
    with PF.pin(torch.device("cpu")):
      assert backend.target() == torch.device("cpu")
      handle = backend.eval_pending(table, layers, "net",
                                    np.arange(len(table)))
    assert handle.device == torch.device("cpu")
    for col in METRICS:
      np.testing.assert_array_equal(handle.resolve()[0].column(col),
                                    plain.column(col))

  def test_visible_devices_raises_without_a_card(self, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
      PF.visible_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
      P.DevicePool()
    assert P.device_topology() == {"platform": "none", "n_devices": 0,
                                   "device_kinds": []}


# ---------------------------------------------------------------------------
# the health registry
# ---------------------------------------------------------------------------

class TestDevicePool:

  def test_validation(self):
    with pytest.raises(ValueError):
      P.DevicePool(devices=[])
    with pytest.raises(ValueError):
      make_pool(speculation_factor=1.0)
    with pytest.raises(ValueError):
      make_pool(sdc_check_every=-1)

  def test_checkout_balances_outstanding(self):
    pool = make_pool(3)
    picks = [pool.checkout() for _ in range(6)]
    assert sorted(picks[:3]) == [0, 1, 2]   # one each before any repeats
    assert sorted(picks[3:]) == [0, 1, 2]
    for i in picks:
      pool.checkin(i)

  def test_require_idle_excludes_busy_devices(self):
    pool = make_pool(2)
    a = pool.checkout()
    alt = pool.checkout(require_idle=True, exclude=(a,))
    assert alt is not None and alt != a
    assert pool.checkout(require_idle=True) is None  # both now busy

  def test_quarantine_skips_device_until_probe(self):
    pool = make_pool(2, breaker_cooldown=3, breaker_jitter=0)
    pool.quarantine(0)
    assert pool.meta()["n_quarantined_devices"] == 1.0
    picks = []
    for _ in range(3):
      i = pool.checkout()
      picks.append(i)
      pool.checkin(i)
    assert picks == [1, 1, 0]

  def test_all_quarantined_checkout_returns_none(self):
    pool = make_pool(2, breaker_cooldown=50, breaker_jitter=0)
    pool.quarantine(0)
    pool.quarantine(1)
    assert pool.checkout() is None

  def test_lost_device_rejoins_via_half_open_probe(self):
    pool = make_pool(2, breaker_cooldown=2, breaker_jitter=0)
    pool.lose_device(0)
    assert pool.counters()["n_device_losses"] == 1
    seen = set()
    for _ in range(8):
      i = pool.checkout()
      if i is None:
        continue
      seen.add(i)
      pool.record_success(i)
      pool.checkin(i)
    assert 0 in seen

  def test_latency_feed_and_fleet_median(self):
    pool = make_pool(2, ewma_alpha=0.5)
    assert pool.fleet_latency() is None
    for _ in range(4):
      pool.record_latency(0, 1.0)
      pool.record_latency(1, 3.0)
    assert pool.ewma(0) == pytest.approx(1.0)
    med = pool.fleet_latency()
    assert med is not None and 1.0 <= med <= 3.0

  def test_meta_shape(self):
    pool = make_pool(3)
    meta = pool.meta()
    assert meta["fleet_devices"] == 3.0
    assert len(meta["fleet_device_states"]) == 3
    assert len(meta["fleet_device_ewma_s"]) == 3
    for key in ("n_speculative", "n_resharded", "n_corruption_checks",
                "n_corruptions_detected", "n_device_losses"):
      assert meta[key] == 0.0

  def test_pool_admission_equals_the_reference(self):
    """The same checkout / failure / quarantine script drives both pools
    through the same picks, breaker states and counters (the seeded
    per-device breakers are equal)."""
    def script(mod):
      pool = mod.DevicePool(devices=["a", "b", "c"], breaker_cooldown=4,
                            breaker_jitter=2, breaker_threshold=2, seed=3)
      trace = []
      for step in range(40):
        i = pool.checkout(require_idle=step % 7 == 0)
        trace.append(i)
        if i is None:
          continue
        if step % 5 == 1:
          pool.record_failure(i)
        else:
          pool.record_latency(i, 0.01 * (i + 1))
          pool.record_success(i)
        if step == 11:
          pool.lose_device(i)
        pool.checkin(i)
      meta = pool.meta()
      return trace, meta["fleet_device_states"], pool.counters(), \
          meta["fleet_device_chunks"]
    assert script(P) == script(R)


class TestStragglerMonitor:

  def test_monitor_equals_the_reference(self):
    """The fleet's EWMA source: records, medians and stragglers equal the
    reference's on the same seeded step times."""
    rng = np.random.RandomState(4)
    got, want = PFT.StragglerMonitor(), RFT.StragglerMonitor()
    for _ in range(30):
      for h in range(5):
        t = float(rng.exponential(1.0 + 3.0 * (h == 3)))
        got.record(f"h{h}", t)
        want.record(f"h{h}", t)
    assert got.fleet_median() == want.fleet_median()
    assert got.stragglers() == want.stragglers()
    for h in want.hosts:
      assert vars(got.hosts[h]) == vars(want.hosts[h])


# ---------------------------------------------------------------------------
# fleet fault injection
# ---------------------------------------------------------------------------

class TestFleetFaults:

  def test_kind_layer_validation(self):
    with pytest.raises(ValueError):
      P.Fault("slow", 0, "device")
    with pytest.raises(ValueError):
      P.Fault("raise", 0, "fleet")
    with pytest.raises(ValueError):
      P.Fault("raise", 0, "device", device=1)
    with pytest.raises(ValueError):
      P.Fault("raise", ANY_CHUNK, "device")

  def test_check_fleet_targets_device_and_chunk(self):
    plan = P.FaultPlan([P.Fault("slow", 3, "fleet", device=1)])
    assert plan.check_fleet(0, 3) is None
    assert plan.check_fleet(1, 2) is None
    assert plan.check_fleet(1, 3) == "slow"
    assert plan.check_fleet(1, 3) is None
    assert plan.n_fired == 1

  def test_any_chunk_wildcard_models_sick_device(self):
    plan = P.FaultPlan([P.Fault("corrupt", ANY_CHUNK, "fleet", times=3,
                                device=2)])
    assert [plan.check_fleet(2, c) for c in (7, 11, 13, 17)] == \
        ["corrupt", "corrupt", "corrupt", None]

  def test_seeded_fleet_reproducible(self):
    mk = lambda: P.FaultPlan.seeded_fleet(9, 40, 4, p_slow=0.3,  # noqa
                                          p_corrupt=0.2, p_lost=0.1)
    a, b = mk(), mk()
    assert a.faults == b.faults and len(a.faults) > 0
    assert all(f.layer == "fleet" for f in a.faults)
    assert P.FaultPlan.seeded_fleet(10, 40, 4, p_slow=0.3).faults != a.faults


# ---------------------------------------------------------------------------
# fleet execution: healthy path
# ---------------------------------------------------------------------------

class TestFleetHealthy:

  def test_fronts_match_solo_run(self):
    ref = solo_result(10)
    res = P.run_stream(fleet_tasks(10), reducer_set(), pool=make_pool(4))
    assert_fronts_identical(res, ref)

  def test_meta_carries_fleet_counters(self):
    res = P.run_stream(fleet_tasks(6), reducer_set(), pool=make_pool(2),
                       policy=P.ResiliencePolicy(retry=no_wait()))
    for key in ("n_speculative", "n_resharded", "n_corruption_checks",
                "fleet_devices", "fleet_device_states",
                "n_quarantined_devices"):
      assert key in res.meta
    assert res.meta["n_leaked_watchdogs"] == 0.0
    assert res.meta["fleet_devices"] == 2.0
    assert res.meta["n_chunks"] == 6.0

  def test_sdc_sentinel_zero_and_nonzero_overhead_paths(self):
    ref = solo_result(8)
    off = P.run_stream(fleet_tasks(8), reducer_set(),
                       pool=make_pool(3, sdc_check_every=0))
    on = P.run_stream(fleet_tasks(8), reducer_set(),
                      pool=make_pool(3, sdc_check_every=1))
    assert_fronts_identical(off, ref)
    assert_fronts_identical(on, ref)
    assert off.meta["n_corruption_checks"] == 0.0
    assert on.meta["n_corruption_checks"] > 0.0
    assert on.meta["n_corruptions_detected"] == 0.0

  def test_all_devices_quarantined_raises_chunk_error(self):
    """H13: the port's ladders end on the device, so a pool with no
    admissible device has no host rung to fall to: ChunkError, where
    the reference runs the chunk on its numpy rung."""
    pool = make_pool(2, breaker_cooldown=100, breaker_jitter=0)
    pool.quarantine(0)
    pool.quarantine(1)
    with pytest.raises(P.ChunkError, match="quarantined") as err:
      P.run_stream(fleet_tasks(5), reducer_set(), pool=pool)
    assert err.value.chunk_index == 0

  def test_resume_from_journal(self, tmp_path):
    ref = solo_result(7)
    jr = P.SweepJournal(tmp_path)
    key = "f" * 64
    half = P.run_fleet(fleet_tasks(7)[:3], reducer_set(), make_pool(2),
                       resume_from=jr, journal_key=key)
    assert half.meta["n_chunks"] == 3.0
    res = P.run_fleet(fleet_tasks(7), reducer_set(), make_pool(2),
                      resume_from=jr, journal_key=key)
    assert res.meta["n_resumed_chunks"] == 3.0
    assert_fronts_identical(res, ref)

  def test_tasks_without_a_device_rung_run_unpinned(self):
    """A backend whose ladder has no device rung (the polynomial backend's
    ``evaluate_table``) runs through the fleet without a checkout."""
    tasks = [P.ChunkTask(i, (P.Rung("evaluate_table",
                                    lambda i=i: chunk_result(i),
                                    layer="backend"),))
             for i in range(5)]
    pool = make_pool(2, breaker_cooldown=100, breaker_jitter=0)
    pool.quarantine(0)
    pool.quarantine(1)
    res = P.run_stream(tasks, reducer_set(), pool=pool)
    assert_fronts_identical(res, solo_result(5))
    assert res.meta["fleet_device_chunks"] == [0.0, 0.0]


# ---------------------------------------------------------------------------
# chaos: faults at every chunk boundary stay bit-identical
# ---------------------------------------------------------------------------

N_CHAOS_CHUNKS = 8


class TestFleetChaos:

  @pytest.mark.parametrize("kind", ["slow", "corrupt", "device-lost"])
  def test_single_fault_at_every_chunk_boundary(self, kind):
    ref = solo_result(N_CHAOS_CHUNKS)
    for chunk in range(N_CHAOS_CHUNKS):
      plan = P.FaultPlan([P.Fault(kind, chunk, "fleet")])
      pool = make_pool(4, sdc_check_every=1)
      res = P.run_stream(
          fleet_tasks(N_CHAOS_CHUNKS), reducer_set(), pool=pool,
          policy=P.ResiliencePolicy(retry=no_wait(), fault_plan=plan))
      assert_fronts_identical(res, ref)
      assert res.meta["n_leaked_watchdogs"] == 0.0
      if kind == "device-lost":
        assert plan.n_fired == 1
        assert res.meta["n_device_losses"] == 1.0
        assert res.meta["n_resharded"] >= 1.0
      if kind == "corrupt" and plan.n_fired:
        assert res.meta["n_corruptions_detected"] == 1.0
        assert res.meta["n_corruption_checks"] >= 1.0
        assert res.meta["n_resharded"] >= 1.0

  def test_straggler_speculation_fires_at_the_tail(self):
    ref = solo_result(6)
    plan = P.FaultPlan([P.Fault("slow", 5, "fleet")])
    res = P.run_stream(fleet_tasks(6), reducer_set(), pool=make_pool(3),
                       policy=P.ResiliencePolicy(retry=no_wait(),
                                                 fault_plan=plan))
    assert_fronts_identical(res, ref)
    assert res.meta["n_speculative"] >= 1.0

  def test_silently_corrupting_device_quarantined_and_replayed(self):
    ref = solo_result(N_CHAOS_CHUNKS)
    plan = P.FaultPlan([P.Fault("corrupt", ANY_CHUNK, "fleet", times=100,
                                device=1)])
    pool = make_pool(3, sdc_check_every=1, breaker_cooldown=50,
                     breaker_jitter=0)
    res = P.run_stream(
        fleet_tasks(N_CHAOS_CHUNKS), reducer_set(), pool=pool,
        policy=P.ResiliencePolicy(retry=no_wait(), fault_plan=plan))
    assert_fronts_identical(res, ref)
    assert res.meta["n_corruptions_detected"] >= 1.0
    assert "open" in res.meta["fleet_device_states"]

  def test_combined_chaos_run(self):
    n = 12
    ref = solo_result(n)
    plan = P.FaultPlan([P.Fault("slow", n - 1, "fleet"),
                        P.Fault("device-lost", 4, "fleet"),
                        P.Fault("corrupt", 7, "fleet")])
    res = P.run_stream(fleet_tasks(n), reducer_set(),
                       pool=make_pool(4, sdc_check_every=1),
                       policy=P.ResiliencePolicy(retry=no_wait(),
                                                 fault_plan=plan))
    assert_fronts_identical(res, ref)
    assert res.meta["n_device_losses"] == 1.0
    assert res.meta["n_resharded"] >= 1.0
    assert res.meta["n_corruptions_detected"] == 1.0
    assert res.meta["n_leaked_watchdogs"] == 0.0

  def test_seeded_chaos_storm(self):
    n = 16
    ref = solo_result(n)
    plan = P.FaultPlan.seeded_fleet(23, n, 4, p_slow=0.25, p_corrupt=0.25,
                                    p_lost=0.15)
    assert len(plan.faults) > 0
    res = P.run_stream(fleet_tasks(n), reducer_set(),
                       pool=make_pool(4, sdc_check_every=1),
                       policy=P.ResiliencePolicy(retry=no_wait(),
                                                 fault_plan=plan))
    assert_fronts_identical(res, ref)
    assert res.meta["n_leaked_watchdogs"] == 0.0


# ---------------------------------------------------------------------------
# watchdog thread accounting
# ---------------------------------------------------------------------------

class _FakePending:
  def __init__(self, fn):
    self._fn = fn

  def resolve(self):
    return self._fn()


class TestWatchdogRegistry:

  def test_tracks_and_reaps(self):
    reg = WatchdogRegistry()
    gate = threading.Event()
    t = threading.Thread(target=gate.wait, daemon=True)
    t.start()
    reg.track(t)
    assert reg.n_live() == 1 and reg.n_spawned == 1
    gate.set()
    assert reg.drain(timeout=5.0) == 0
    assert reg.n_reaped == 1

  def test_hung_resolution_is_tracked_not_abandoned(self):
    gate = threading.Event()

    def block():
      gate.wait(30.0)
      return "too-late"

    task = P.ChunkTask(0, (P.Rung("fused-device",
                                  lambda: _FakePending(block),
                                  layer="device"),
                           P.Rung("device", lambda: "rescued",
                                  layer="device")))
    pol = P.ResiliencePolicy(retry=no_wait(), resolve_timeout=0.05)
    assert pol.execute(task).resolve() == "rescued"
    assert pol.watchdogs.n_live() == 1
    gate.set()
    assert pol.watchdogs.drain(timeout=5.0) == 0

  def test_run_stream_reports_zero_leaks_when_healthy(self):
    res = P.run_stream(fleet_tasks(4), {"pareto": P.ParetoAccumulator()},
                       policy=P.ResiliencePolicy(retry=no_wait()))
    assert res.meta["n_leaked_watchdogs"] == 0.0


# ---------------------------------------------------------------------------
# real sweeps through the fleet: eight explicit CPU slots
# ---------------------------------------------------------------------------

def _sweep_reducers(mod):
  return {"pareto": mod.ParetoAccumulator(),
          "pareto3": mod.ParetoAccumulator(("latency_s", "energy_mj",
                                            "area_mm2")),
          "top": mod.TopKAccumulator(9, by="energy_mj"),
          "stats": mod.StatsAccumulator("power_mw"),
          "hist": mod.HistogramAccumulator("area_mm2", 0.0, 200.0, bins=16)}


def _assert_sweeps_equal(got, want, names=("pareto", "pareto3", "top")):
  for name in names:
    for col in METRICS:
      np.testing.assert_array_equal(got[name].column(col),
                                    want[name].column(col), err_msg=name)
  assert got.n_rows == want.n_rows


def test_eight_cpu_slot_fleet_bit_identity():
  """The reference's eight forced XLA devices, as eight explicit CPU
  slots: a fused ``TorchOracleBackend`` sweep through the pool under a
  lost device, a straggler and a corrupting device equals the
  reference's solo numpy sweep (and the port's solo sweep, stats
  included)."""
  layers = get_network("resnet20")[:4]
  solo_ref = R.stream_explore(R.VectorOracleBackend(), R.DesignSpace(),
                              ref_get_network("resnet20")[:4],
                              n_per_type=120, seed=13, chunk_size=50,
                              reducers=_sweep_reducers(R), workers=1)
  backend = P.TorchOracleBackend(device="cpu")
  solo = P.stream_explore(backend, P.DesignSpace(), layers, n_per_type=120,
                          seed=13, chunk_size=50,
                          reducers=_sweep_reducers(P), workers=1)
  pool = P.DevicePool(devices=[torch.device("cpu")] * 8, sdc_check_every=2)
  plan = P.FaultPlan([P.Fault("device-lost", 1, "fleet"),
                      P.Fault("slow", 3, "fleet"),
                      P.Fault("corrupt", 2, "fleet")])
  res = P.stream_explore(
      backend, P.DesignSpace(), layers, n_per_type=120, seed=13,
      chunk_size=50, reducers=_sweep_reducers(P), pool=pool,
      policy=P.ResiliencePolicy(retry=no_wait(), fault_plan=plan))
  # the sentinel samples one chunk of two, so a corrupted chunk may fold
  # unseen (as in the reference); the fronts hold either way here
  _assert_sweeps_equal(res, solo_ref)
  _assert_sweeps_equal(res, solo)
  assert res.meta["fleet_devices"] == 8.0
  assert res.meta["n_device_losses"] == 1.0
  assert res.meta["n_corruption_checks"] >= 1.0
  assert res.meta["n_leaked_watchdogs"] == 0.0
  assert res.meta["n_chunks"] == solo.meta["n_chunks"]
  # without the corrupting fault every reducer, stats included, is the
  # solo run's bit for bit
  clean = P.stream_explore(
      backend, P.DesignSpace(), layers, n_per_type=120, seed=13,
      chunk_size=50, reducers=_sweep_reducers(P),
      pool=P.DevicePool(devices=[torch.device("cpu")] * 8,
                        sdc_check_every=2),
      policy=P.ResiliencePolicy(retry=no_wait(), fault_plan=P.FaultPlan(
          [P.Fault("device-lost", 1, "fleet"),
           P.Fault("slow", 3, "fleet")])))
  _assert_sweeps_equal(clean, solo)
  assert clean["stats"] == solo["stats"]
  np.testing.assert_array_equal(clean["hist"]["counts"],
                                solo["hist"]["counts"])
  assert clean.meta["n_corruptions_detected"] == 0.0


def test_co_explore_through_the_fleet():
  """A streamed co-exploration through a pool of CPU slots: the global
  distinct-layer factorization follows the pin, and the joint fronts
  equal the solo run's."""
  rng = np.random.RandomState(2)
  archs = [ArchChoice(tuple((int(rng.choice(r)), int(rng.choice(c)))
                            for r, c in SEARCH_SPACE)) for _ in range(5)]
  arch_accs = list(zip(archs, rng.uniform(0.5, 0.95, len(archs))))
  backend = P.TorchOracleBackend(device="cpu")
  cols = ("top1_err", "energy_mj", "area_mm2")

  def run(**kw):
    return P.stream_co_explore(
        backend, P.DesignSpace(), arch_accs, n_hw_per_type=12, seed=3,
        image_size=16, chunk_size=40,
        reducers={"pareto": P.ParetoAccumulator(cols),
                  "pareto3": P.ParetoAccumulator(("latency_s", "energy_mj",
                                                  "area_mm2")),
                  "top": P.TopKAccumulator(6, by="energy_mj")}, **kw)

  solo = run(workers=1)
  res = run(pool=P.DevicePool(devices=["cpu"] * 3, sdc_check_every=2))
  _assert_sweeps_equal(res, solo)
  assert res.meta["n_corruption_checks"] >= 1.0
  np.testing.assert_array_equal(res["pareto"].extra["arch_id"],
                                solo["pareto"].extra["arch_id"])


# ---------------------------------------------------------------------------
# the worker pool: threads fold in chunk-index order
# ---------------------------------------------------------------------------

def _jittered_tasks(n_chunks: int, seed: int):
  """Tasks that finish in a seeded shuffled order: each sleeps a seeded
  random time before returning its (pure) chunk."""
  rng = random.Random(seed)
  delays = [rng.uniform(0.0, 0.02) for _ in range(n_chunks)]

  def make(i):
    def run():
      time.sleep(delays[i])
      return chunk_result(i, n=ROWS + i % 5)
    return run
  return [P.ChunkTask(i, (P.Rung("device", make(i), layer="device"),))
          for i in range(n_chunks)]


@pytest.mark.parametrize("workers", [2, 3, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_threaded_run_stream_is_bit_equal_to_one_worker(workers, seed):
  """Completion order is shuffled; the reorder buffer folds in index
  order, so every reducer, stats included, is bit-equal to one worker."""
  n = 24
  order = []
  lock = threading.Lock()

  class Recording(P.StatsAccumulator):
    def fold(self, frame, indices):
      with lock:
        order.append(int(indices[0]))
      super().fold(frame, indices)

  def reducers():
    return {"pareto": P.ParetoAccumulator(),
            "top": P.TopKAccumulator(k=7, by="power_mw"),
            "stats": P.StatsAccumulator("latency_s"),
            "rec": Recording("area_mm2"),
            "hist": P.HistogramAccumulator("power_mw", 0.0, 1.0, bins=8)}

  one = P.run_stream(_jittered_tasks(n, seed), reducers())
  one_order = list(order)
  order.clear()
  many = P.run_stream(_jittered_tasks(n, seed), reducers(), workers=workers)
  assert order == one_order == [chunk_result(i, ROWS + i % 5)[1][0]
                                for i in range(n)]
  assert many.meta["workers"] == float(workers)
  for name in ("pareto", "top"):
    for col in METRICS:
      np.testing.assert_array_equal(many[name].column(col),
                                    one[name].column(col))
  assert many["stats"] == one["stats"] and many["rec"] == one["rec"]
  np.testing.assert_array_equal(many["hist"]["counts"], one["hist"]["counts"])


def test_threaded_stream_equals_reference_and_one_worker():
  """A fused ``TorchOracleBackend`` sweep at workers=4 equals workers=1
  bit for bit (stats included) and the reference's numpy sweep."""
  layers = get_network("resnet20")[:3]
  backend = P.TorchOracleBackend(device="cpu")
  kw = dict(n_per_type=90, seed=21, chunk_size=32)
  one = P.stream_explore(backend, P.DesignSpace(), layers,
                         reducers=_sweep_reducers(P), workers=1, **kw)
  four = P.stream_explore(backend, P.DesignSpace(), layers,
                          reducers=_sweep_reducers(P), workers=4, **kw)
  ref = R.stream_explore(R.VectorOracleBackend(), R.DesignSpace(),
                         ref_get_network("resnet20")[:3],
                         reducers=_sweep_reducers(R), workers=1, **kw)
  _assert_sweeps_equal(four, one)
  _assert_sweeps_equal(four, ref)
  assert four["stats"] == one["stats"]
  np.testing.assert_array_equal(four["hist"]["counts"], ref["hist"]["counts"])


def test_threaded_kill_journals_like_one_worker(tmp_path):
  """A kill under workers=4 leaves the same journal as workers=1 (the
  dispatch window's chunks unfolded), and the resume is identical."""
  layers = get_network("resnet20")[:2]
  backend = P.TorchOracleBackend(device="cpu")
  kw = dict(n_per_type=40, seed=2, chunk_size=16)
  base = P.stream_explore(backend, P.DesignSpace(), layers,
                          reducers=_sweep_reducers(P), workers=1, **kw)
  states = []
  for workers in (1, 4):
    jdir = tmp_path / f"w{workers}"
    pol = P.ResiliencePolicy(retry=no_wait(), fault_plan=P.FaultPlan(
        [P.Fault("kill", 5, "task")]))
    with pytest.raises(P.ChunkError) as err:
      P.stream_explore(backend, P.DesignSpace(), layers,
                       reducers=_sweep_reducers(P), workers=workers,
                       policy=pol, resume_from=jdir, **kw)
    assert err.value.chunk_index == 5
    key = PS.explore_sweep_key(P.DesignSpace(), _sweep_reducers(P),
                               n_per_type=40, seed=2, method="random",
                               chunk_size=16, network="net")
    states.append(P.SweepJournal(jdir).load(key)["done"])
    res = P.stream_explore(backend, P.DesignSpace(), layers,
                           reducers=_sweep_reducers(P), workers=workers,
                           resume_from=jdir, **kw)
    _assert_sweeps_equal(res, base)
    assert res["stats"] == base["stats"]
  assert states[0] == states[1] == set(range(5 - PS.DISPATCH_AHEAD))


def test_default_workers():
  """One thread for a backend on CUDA, as the reference gives its jit
  backend one; otherwise one per core up to 8."""
  class OnCuda:
    device = torch.device("cuda")
  want = max(1, min(8, __import__("os").cpu_count() or 1))
  assert PS.default_workers(OnCuda()) == 1
  assert PS.default_workers(P.TorchOracleBackend(device="cpu")) == want
  assert PS.default_workers(None) == want
  assert PS.default_workers(R.VectorOracleBackend()) == \
      R.streaming.default_workers(R.VectorOracleBackend()) == want
