"""The port's guided search against the JAX package's, on the CPU:
``derive_seed``, the exact hypervolume, the NSGA-II building blocks,
``guided_search`` on analytic problems, ``ExplorationSession.optimize``
through the oracle, and the search's kill-and-resume.

The search is host numpy in both packages, seeded through
``derive_seed``, and the port's oracle is bit-equal to the reference's
numpy path, so everything here is held exactly: equal seeds, bit-equal
hypervolumes and objectives, identical fronts, row ids and ``meta`` (all
but the wall-clock keys).  The reference runs ``VectorOracleBackend()``
(numpy); the port runs ``TorchOracleBackend(device="cpu")``.  The smoke
scale is ``benchmarks/search_perf.py``'s (``SEARCH_BENCH_SCALE=smoke``):
8 Table-4 archs from ``RandomState(0)``, population 16, 6 generations;
the expected values are computed here from the reference, never copied
from its record.
"""
import math
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.explore as R
from repro.core import seeding as ref_seeding
from repro.core.cnn import SEARCH_SPACE
from repro.core.cnn import ArchChoice as RefArch
from repro.core.workloads import get_network as ref_get_network
from repro.explore import search as RSE

import repro_torch.explore as P
from repro_torch.core import seeding
from repro_torch.core.cnn import ArchChoice
from repro_torch.core.workloads import get_network
from repro_torch.explore import resilience as PR
from repro_torch.explore import search as PSE
from repro_torch.explore import session as session_mod
from repro_torch.explore.frame import ResultFrame

INTS = ("pe_rows", "pe_cols", "sp_if", "sp_fw", "sp_ps", "gbuf_kb")
GRID = 33
OBJ2 = ("latency_s", "power_mw")
JOINT3 = ("top1_err", "energy_mj", "area_mm2")
METRICS = ("latency_s", "power_mw", "area_mm2")
TIMING = ("seconds", "rows_per_sec")


# ---------------------------------------------------------------------------
# derive_seed
# ---------------------------------------------------------------------------

SEED_PARTS = [(), (0,), (-1,), (2 ** 64 + 5,), (-(2 ** 70),), (7, 3),
              (3, 7), (0.0,), (-0.0,), (float("inf"),), (float("nan"),),
              (1.5, -2.25), (True,), (False, 1), ("abc",), ("", "x", 9),
              (1, 2.0, "three", True)]


@pytest.mark.parametrize("label", ["search-gen", "fault-plan", "x"])
@pytest.mark.parametrize("parts", SEED_PARTS, ids=repr)
def test_derive_seed_equals_the_reference(label, parts):
  for bits in (1, 8, 31, 32, 63):
    assert seeding.derive_seed(label, *parts, bits=bits) == \
        ref_seeding.derive_seed(label, *parts, bits=bits)


@pytest.mark.parametrize("args,kw", [
    (("",), {}), ((None,), {}), ((b"lbl",), {}), (("l",), {"bits": 0}),
    (("l",), {"bits": 64}), (("l", [1]), {}), (("l", None), {})])
def test_derive_seed_errors_equal_the_reference(args, kw):
  with pytest.raises((ValueError, TypeError)) as want:
    ref_seeding.derive_seed(*args, **kw)
  with pytest.raises((ValueError, TypeError)) as got:
    seeding.derive_seed(*args, **kw)
  assert type(got.value) is type(want.value)
  assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# hypervolume, ranks, crowding
# ---------------------------------------------------------------------------

def test_known_hypervolumes():
  hv = PSE.hypervolume
  assert hv([[0.0, 0.0]], (1.0, 1.0)) == 1.0
  assert hv([[0.0, 0.5], [0.5, 0.0]], (1.0, 1.0)) == 0.75
  assert hv([[0.0, 0.5], [0.5, 0.0], [0.6, 0.6]], (1.0, 1.0)) == 0.75
  assert hv([[1.0, 0.0], [2.0, -1.0]], (1.0, 1.0)) == 0.0
  assert hv(np.zeros((0, 2)), (1.0, 1.0)) == 0.0
  assert hv([[0.0, 0.0, 0.0]], (1.0, 1.0, 1.0)) == 1.0
  pts = [[0.0, 0.0, 0.5], [0.5, 0.0, 0.0]]
  assert hv(pts, (1.0, 1.0, 1.0)) == 0.75
  assert hv(pts + pts, (1.0, 1.0, 1.0)) == 0.75
  with pytest.raises(ValueError):
    hv(np.zeros(3), (1.0,))
  with pytest.raises(ValueError):
    hv(np.zeros((2, 3)), (1.0, 1.0))


def _point_sets(d, seed):
  rng = np.random.RandomState(seed)
  pts = rng.rand(30, d)
  pts[rng.randint(0, 30, 5), 0] = 0.5             # ties on one axis
  pts[3] = pts[17]                                 # a duplicated row
  pts[rng.randint(0, 30, 4)] = np.round(pts[rng.randint(0, 30, 4)], 1)
  return pts


@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hypervolume_bit_equal_to_the_reference(d, seed):
  pts = _point_sets(d, seed)
  for ref in (np.full(d, 1.0), np.full(d, 1.25), np.linspace(0.6, 1.3, d)):
    got = PSE.hypervolume(pts, ref)
    want = RSE.hypervolume(pts, ref)
    assert got == want and type(got) is float


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 5])
def test_ranks_crowding_and_objectives_equal_the_reference(d, seed):
  obj = _point_sets(d, seed)
  ranks = PSE.nondominated_ranks(obj)
  np.testing.assert_array_equal(ranks, RSE.nondominated_ranks(obj))
  crowd = PSE.crowding_distance(obj, ranks)
  np.testing.assert_array_equal(crowd, RSE.crowding_distance(obj, ranks))
  assert ranks.dtype == np.int64 and ranks.min() == 0
  rng = np.random.RandomState(seed)
  cols = [rng.rand(12) for _ in range(3)]
  cols[0][[2, 5]] = cols[0][7]
  names = np.array(["INT8"] * 12)
  pf, rf = ResultFrame(*cols, names), R.ResultFrame(*cols, names)
  for want_cols, mx in ((("perf", "latency_s"), None),
                        (("perf_per_area", "energy_mj", "area_mm2"), None),
                        (("latency_s", "power_mw"), ("power_mw",))):
    np.testing.assert_array_equal(PSE.objective_matrix(pf, want_cols, mx),
                                  RSE.objective_matrix(rf, want_cols, mx))


def test_tournament_draw_and_vary_equal_the_reference():
  card = np.array([4, 7, 3, 33, 2, 9, 5, 24], np.int64)
  for seed in range(3):
    g = PSE._draw(np.random.RandomState(seed), 20, card)
    np.testing.assert_array_equal(
        g, RSE._draw(np.random.RandomState(seed), 20, card))
    rank = np.random.RandomState(seed).randint(0, 3, 20)
    crowd = np.random.RandomState(seed + 9).rand(20)
    crowd[::4] = np.inf
    np.testing.assert_array_equal(
        PSE._vary(g, rank, crowd, np.random.RandomState(seed), card, 40,
                  0.9, 0.125),
        RSE._vary(g, rank, crowd, np.random.RandomState(seed), card, 40,
                  0.9, 0.125))


# ---------------------------------------------------------------------------
# guided_search on analytic problems (the reference test's ZDT hooks)
# ---------------------------------------------------------------------------

def unit_space(mod):
  axes = {name: tuple(range(GRID)) for name in INTS}
  axes["bandwidth_gbps"] = tuple(np.linspace(0.0, 1.0, GRID))
  return mod.DesignSpace(pe_types=("INT8",), axes=axes)


def zdt1_for(frame_cls, arch_weight=0.0):
  def zdt1(table, idx, arch):
    cols = [np.asarray(getattr(table, n), np.float64) / (GRID - 1)
            for n in INTS]
    x = np.stack(cols + [table.bandwidth_gbps], axis=1)
    f1 = x[:, 0]
    if arch is not None:
      f1 = f1 + arch_weight * arch
    g = 1.0 + 9.0 * x[:, 1:].mean(axis=1)
    f2 = g * (1.0 - np.sqrt(np.minimum(f1, 1.0) / g))
    return frame_cls(f1, f2, np.ones(len(table)), table.pe_type_strings(),
                     table=table), idx
  return zdt1


class _Recorder:
  """Captures every folded (frame, indices) generation."""

  def __init__(self, base):
    self.base = base
    self.chunks = []

  def make(self):
    rec = self

    class Rec(self.base):
      def fold(self, frame, indices):
        rec.chunks.append((frame, np.asarray(indices, np.int64).copy()))

      def result(self):
        return len(rec.chunks)

    return Rec()


def _search_pair(port_kw=None, **kw):
  """The same search through both packages: (port result, port front
  ids, port generations), (reference ...)."""
  out = []
  for mod, se, frame_cls in ((P, PSE, ResultFrame), (R, RSE, R.ResultFrame)):
    acc = mod.ParetoAccumulator(OBJ2)
    rec = _Recorder(mod.streaming.Reducer)
    extra = dict(kw)
    if mod is P and port_kw:
      extra.update(port_kw)
    res = se.guided_search(
        unit_space(mod), zdt1_for(frame_cls, 0.05), OBJ2,
        reducers={"pareto": acc, "rec": rec.make()}, **extra)
    out.append((res, acc.indices, rec.chunks))
  return out


def _assert_same_search(port, ref):
  (pres, pidx, pchunks), (rres, ridx, rchunks) = port, ref
  assert pres.n_rows == rres.n_rows
  np.testing.assert_array_equal(pidx, ridx)
  for col in METRICS:
    np.testing.assert_array_equal(pres["pareto"].column(col),
                                  rres["pareto"].column(col))
  for knob in INTS + ("bandwidth_gbps",):
    np.testing.assert_array_equal(getattr(pres["pareto"].table, knob),
                                  getattr(rres["pareto"].table, knob))
  assert {k: v for k, v in pres.meta.items() if k not in TIMING} == \
      {k: v for k, v in rres.meta.items() if k not in TIMING}
  assert len(pchunks) == len(rchunks)
  for (pf, pi), (rf, ri) in zip(pchunks, rchunks):
    np.testing.assert_array_equal(pi, ri)
    assert pf.table.row_keys() == rf.table.row_keys()


@pytest.mark.parametrize("surrogate", [False, True],
                         ids=["evolutionary", "surrogate"])
@pytest.mark.parametrize("n_archs", [None, 3])
def test_guided_search_equals_the_reference(surrogate, n_archs):
  _assert_same_search(*_search_pair(population=12, generations=5, seed=11,
                                    surrogate=surrogate, surrogate_pool=2,
                                    n_archs=n_archs))


def test_guided_search_constraints_and_exhaustion_equal_the_reference():
  def space(mod, cons):
    axes = {name: (1,) for name in INTS}
    axes["pe_rows"] = (1, 2, 3, 4, 5, 6)
    axes["bandwidth_gbps"] = (0.25, 1.0)
    c = (mod.vector_constraint(lambda c: c.pe_rows <= 4,
                               lambda t: t.pe_rows <= 4),) if cons else ()
    return mod.DesignSpace(pe_types=("INT8",), axes=axes, constraints=c)

  for cons in (False, True):
    got = PSE.guided_search(space(P, cons), zdt1_for(ResultFrame), OBJ2,
                            population=3, generations=10, seed=0)
    want = RSE.guided_search(space(R, cons), zdt1_for(R.ResultFrame), OBJ2,
                             population=3, generations=10, seed=0)
    assert got.n_rows == want.n_rows <= (8 if cons else 12)
    assert got.meta["generations"] == want.meta["generations"] < 10
    for col in OBJ2:
      np.testing.assert_array_equal(got["pareto"].column(col),
                                    want["pareto"].column(col))


@pytest.mark.parametrize("kw", [
    dict(objectives=()), dict(population=1), dict(generations=0),
    dict(surrogate_pool=1), dict(n_archs=0)])
def test_parameter_validation_equals_the_reference(kw):
  def call(mod, se, frame_cls):
    args = dict(objectives=OBJ2, population=8, generations=2)
    args.update(kw)
    return se.guided_search(unit_space(mod), zdt1_for(frame_cls),
                            args.pop("objectives"), **args)
  with pytest.raises(ValueError) as want:
    call(R, RSE, R.ResultFrame)
  with pytest.raises(ValueError) as got:
    call(P, PSE, ResultFrame)
  assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# session.optimize through the oracle, at the benchmark's smoke scale
# ---------------------------------------------------------------------------

SMOKE = dict(n_archs=8, population=16, generations=6, seed=7)


def _bench_arch_accs(arch_cls, n):
  rng = np.random.RandomState(0)
  archs = [arch_cls(tuple((int(rng.choice(r)), int(rng.choice(c)))
                          for r, c in SEARCH_SPACE)) for _ in range(n)]
  return list(zip(archs, rng.uniform(0.5, 0.95, size=n)))


def _bench(session, se, arch_accs):
  """``benchmarks/search_perf.py`` at the smoke scale through ``session``:
  the guided, surrogate and random arms, their fronts and the exact
  hypervolumes under the shared reference point."""
  kw = dict(arch_accs=arch_accs, objectives=JOINT3,
            population=SMOKE["population"], seed=SMOKE["seed"])
  res = session.optimize(generations=SMOKE["generations"], **kw)
  budget = int(res.meta["evaluations"])
  sur = session.optimize(generations=SMOKE["generations"], surrogate=True,
                         **kw)
  kw.update(population=budget, seed=SMOKE["seed"] + 1)
  rand = session.optimize(generations=1, **kw)
  arms = {"guided": res, "surrogate": sur, "random": rand}
  mats = {n: se.objective_matrix(r["pareto"], JOINT3)
          for n, r in arms.items()}
  union = np.concatenate(list(mats.values()))
  lo, hi = union.min(axis=0), union.max(axis=0)
  ref = hi + 0.1 * np.maximum(hi - lo, 1e-12)
  return arms, {n: se.hypervolume(m, ref) for n, m in mats.items()}


@pytest.fixture(scope="module")
def bench_pair():
  port = P.ExplorationSession(P.TorchOracleBackend(device="cpu"),
                              P.DesignSpace())
  ref = R.ExplorationSession(R.VectorOracleBackend(), R.DesignSpace())
  return (_bench(port, PSE, _bench_arch_accs(ArchChoice, SMOKE["n_archs"])),
          _bench(ref, RSE, _bench_arch_accs(RefArch, SMOKE["n_archs"])))


@pytest.mark.parametrize("arm", ["guided", "surrogate", "random"])
def test_joint_optimize_equals_the_reference(bench_pair, arm):
  (parms, phv), (rarms, rhv) = bench_pair
  got, want = parms[arm], rarms[arm]
  assert got.n_rows == want.n_rows
  assert len(got["pareto"]) == len(want["pareto"])
  for col in METRICS + ("top1", "arch_id"):
    np.testing.assert_array_equal(got["pareto"].column(col),
                                  want["pareto"].column(col))
  assert got["pareto"].arch_lookup == tuple(
      ArchChoice(a.stages) for a in want["pareto"].arch_lookup)
  assert phv[arm] == rhv[arm] > 0.0
  assert {k: v for k, v in got.meta.items() if k not in TIMING} == \
      {k: v for k, v in want.meta.items() if k not in TIMING}


def test_joint_optimize_beats_random_as_the_reference(bench_pair):
  (_, phv), (_, rhv) = bench_pair
  assert phv == rhv
  assert phv["guided"] / phv["random"] >= 1.0  # the smoke scale's bar


@pytest.mark.parametrize("surrogate", [False, True])
def test_hw_optimize_equals_the_reference(surrogate):
  layers = get_network("resnet20")
  backend = P.TorchOracleBackend(device="cpu")
  calls = {"n": 0}
  dispatch = backend.eval_pending

  def counted(*a, **k):
    calls["n"] += 1
    return dispatch(*a, **k)

  backend.eval_pending = counted
  kw = dict(population=SMOKE["population"], generations=SMOKE["generations"],
            seed=17, surrogate=surrogate)
  got = P.ExplorationSession(backend).optimize(layers, "resnet20", **kw)
  want = R.ExplorationSession(R.VectorOracleBackend()).optimize(
      ref_get_network("resnet20"), "resnet20", **kw)
  assert calls["n"] == got.meta["generations"] == SMOKE["generations"]
  for col in METRICS:
    np.testing.assert_array_equal(got["pareto"].column(col),
                                  want["pareto"].column(col))
  assert {k: v for k, v in got.meta.items() if k not in TIMING} == \
      {k: v for k, v in want.meta.items() if k not in TIMING}
  # a backend with neither eval_pending nor evaluate_table: evaluate
  scalar = P.ExplorationSession(P.OracleBackend()).optimize(
      layers[:3], population=8, generations=2, seed=1)
  assert scalar.meta["evaluations"] == 16.0


def test_optimize_modes_and_refusals():
  session = P.ExplorationSession(P.TorchOracleBackend(device="cpu"))
  with pytest.raises(ValueError, match="exactly one"):
    session.optimize()
  with pytest.raises(ValueError, match="exactly one"):
    session.optimize(get_network("resnet20")[:1], arch_accs=[(None, 0.5)])

  class JitBackend:
    name = "jit"
    jit = True

    def evaluate_table(self, *a):
      raise AssertionError("unreachable")

  with pytest.raises(ValueError) as got:
    P.ExplorationSession(JitBackend()).optimize(
        arch_accs=_bench_arch_accs(ArchChoice, 2))
  with pytest.raises(ValueError) as want:
    R.ExplorationSession(R.VectorOracleBackend(jit=True)).optimize(
        arch_accs=_bench_arch_accs(RefArch, 2))
  assert str(got.value) == str(want.value)


@pytest.mark.parametrize("call,option", [
    (call, option) for call in ("explore", "co_explore")
    for option in ("workers", "store", "pool")] + [
    (call, option) for call in ("stream_explore", "stream_co_explore")
    for option in ("workers", "pool")])
def test_slice6_options_raise_until_ported(call, option, tmp_path):
  """The reference's thread-pool, store and fleet options (ported with
  slice 6) run on each entry point and give the fronts and top-k of the
  run without them; a stored result is then served as a store hit."""
  backend = P.TorchOracleBackend(device="cpu")
  session = P.ExplorationSession(backend)
  layers = get_network("resnet20")[:1]
  arch_accs = _bench_arch_accs(ArchChoice, 1)
  cols = ("top1_err", "energy_mj", "area_mm2") if "co_explore" in call \
      else ("perf_per_area", "energy_mj")

  def reducers():
    return {"pareto": P.ParetoAccumulator(cols),
            "top": P.TopKAccumulator(7, by="energy_mj")}

  calls = {
      "explore": lambda **k: session.explore(layers, "net", stream=True,
                                             reducers=reducers(), **k),
      "co_explore": lambda **k: session.co_explore(
          arch_accs, stream=True, reducers=reducers(), **k),
      "stream_explore": lambda **k: P.stream_explore(
          backend, session.space, layers, reducers=reducers(), **k),
      "stream_co_explore": lambda **k: P.stream_co_explore(
          backend, session.space, arch_accs, reducers=reducers(), **k)}
  values = {"workers": lambda: 2,
            "store": lambda: P.ResultStore(tmp_path),
            "pool": lambda: P.DevicePool(devices=["cpu"] * 2)}
  want = calls[call](workers=1)
  runs = [calls[call](**{option: values[option]()})]
  if option == "store":
    runs.append(calls[call](store=values["store"]()))
    assert runs[1].meta["store_hit"] == 1.0
  for got in runs:
    assert got.n_rows == want.n_rows
    for name in ("pareto", "top"):
      for col in METRICS:
        np.testing.assert_array_equal(got[name].column(col),
                                      want[name].column(col))


def test_policy_and_resume_need_the_stream(tmp_path):
  session = P.ExplorationSession(P.TorchOracleBackend(device="cpu"))
  with pytest.raises(ValueError, match="stream=True"):
    session.explore(get_network("resnet20")[:1], "net",
                    policy=PR.ResiliencePolicy())
  with pytest.raises(ValueError, match="stream=True"):
    session.co_explore(_bench_arch_accs(ArchChoice, 1), resume_from=tmp_path)


# ---------------------------------------------------------------------------
# the search's fault tolerance: generation == chunk
# ---------------------------------------------------------------------------

GENS = 6


def _run(se=PSE, mod=P, frame_cls=ResultFrame, **kw):
  kw.setdefault("population", 12)
  kw.setdefault("generations", GENS)
  return se.guided_search(unit_space(mod), zdt1_for(frame_cls), OBJ2,
                          seed=3, **kw)


def _kill_at(g):
  return PR.ResiliencePolicy(retry=PR.RetryPolicy(sleep=lambda s: None),
                             fault_plan=PR.FaultPlan([PR.Fault("kill", g,
                                                               "task")]))


def _same_front(a, b):
  for col in OBJ2:
    np.testing.assert_array_equal(a["pareto"].column(col),
                                  b["pareto"].column(col))


def test_search_killed_at_every_generation_resumes_identically(tmp_path):
  ref = _run()
  _same_front(ref, _run(RSE, R, R.ResultFrame))
  for g in range(GENS):
    jdir = tmp_path / f"kill-{g}"
    with pytest.raises(PR.ChunkError) as err:
      _run(policy=_kill_at(g), resume_from=jdir)
    assert err.value.chunk_index == g
    res = _run(resume_from=jdir)
    _same_front(res, ref)
    assert res.meta["n_resumed_chunks"] == float(g)
    assert res.meta["evaluations"] == ref.meta["evaluations"]
    assert res.meta["hypervolume"] == ref.meta["hypervolume"]


def test_finished_search_extends_from_its_journal(tmp_path):
  _run(generations=3, resume_from=tmp_path)
  longer = _run(resume_from=tmp_path)
  ref = _run()
  assert longer.meta["n_resumed_chunks"] == 3.0
  assert longer.meta["evaluations"] == ref.meta["evaluations"]
  _same_front(longer, ref)


def test_search_journal_key_equals_the_reference(tmp_path):
  for name, (se, mod, frame_cls) in {
      "port": (PSE, P, ResultFrame),
      "ref": (RSE, R, R.ResultFrame)}.items():
    _run(se, mod, frame_cls, generations=2, surrogate=True,
         resume_from=tmp_path / name)
  keys = {}
  for name in ("port", "ref"):
    (path,) = (tmp_path / name).glob("sweep-*.pkl")
    with open(path, "rb") as f:
      payload = pickle.load(f)
    keys[name] = payload["key"]
    assert payload["state"]["g_next"] == 2
  assert keys["port"] == keys["ref"]


def test_unexpected_failure_wrapped_with_its_generation():
  calls = {"n": 0}
  zdt1 = zdt1_for(ResultFrame)

  def evaluate(table, idx, arch):
    if calls["n"] == 2:
      raise OSError("device fell off the bus")
    calls["n"] += 1
    return zdt1(table, idx, arch)

  with pytest.raises(PR.ChunkError) as err:
    PSE.guided_search(unit_space(P), evaluate, OBJ2, population=12,
                      generations=4, seed=3)
  assert err.value.chunk_index == 2
  assert "OSError" in str(err.value)


def test_surrogate_search_resumes_identically(tmp_path):
  kw = dict(surrogate=True, surrogate_pool=2)
  ref = _run(**kw)
  with pytest.raises(PR.ChunkError):
    _run(policy=_kill_at(3), resume_from=tmp_path, **kw)
  res = _run(resume_from=tmp_path, **kw)
  _same_front(res, ref)
  assert res.meta["n_resumed_chunks"] == 3.0
  _same_front(res, _run(RSE, R, R.ResultFrame, **kw))


def test_transient_generation_faults_are_retried():
  ref = _run()
  plan = PR.FaultPlan([PR.Fault("raise", 1, "task"),
                       PR.Fault("raise", 4, "backend", times=2)])
  res = _run(policy=PR.ResiliencePolicy(
      retry=PR.RetryPolicy(sleep=lambda s: None), fault_plan=plan))
  _same_front(res, ref)
  assert (res.meta["n_retries"], res.meta["n_demotions"]) == (3.0, 0.0)
  assert math.isclose(res.meta["hypervolume"], ref.meta["hypervolume"],
                      rel_tol=0.0, abs_tol=0.0)


def test_joint_optimize_killed_and_resumed_on_the_oracle(tmp_path):
  session = P.ExplorationSession(P.TorchOracleBackend(device="cpu"))
  kw = dict(arch_accs=_bench_arch_accs(ArchChoice, 4), population=8,
            generations=4, seed=5, image_size=16)
  ref = session.optimize(**kw)
  with pytest.raises(PR.ChunkError) as err:
    session.optimize(policy=_kill_at(2), resume_from=tmp_path, **kw)
  assert err.value.chunk_index == 2
  res = session.optimize(resume_from=tmp_path, **kw)
  assert res.meta["n_resumed_chunks"] == 2.0
  for col in METRICS + ("arch_id", "top1"):
    np.testing.assert_array_equal(res["pareto"].column(col),
                                  ref["pareto"].column(col))


def test_session_evaluators_are_the_optimize_hooks():
  assert session_mod.hw_evaluator is not None
  layers = get_network("resnet20")[:2]
  backend = P.TorchOracleBackend(device="cpu")
  table = P.DesignSpace().sample_table(3, seed=0)
  idx = np.arange(len(table))
  frame, got_idx = session_mod.hw_evaluator(backend, layers,
                                            "n")(table, idx, None).resolve()
  np.testing.assert_array_equal(got_idx, idx)
  want = backend.evaluate_table(table, layers, "n")
  for col in METRICS:
    np.testing.assert_array_equal(frame.column(col), want.column(col))
