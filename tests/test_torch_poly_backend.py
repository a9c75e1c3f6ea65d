"""The port's polynomial method against the JAX package: the
PolynomialBackend (fit, ``.npz`` both ways, list and table evaluation),
the best-INT16 normalization and the figures built on it, the fronts,
the list samplers and grid helpers, the session, and the ``dse`` shim.

Predictions are not bit-equal to the reference's: it sums ``phi @ coef``
with BLAS, the port in a fixed order (``repro_torch.core.ppa``).  Each row
is held to the bound that difference allows, computed here from the
reference's own features and coefficients (``Bounds``); no fixed rtol.
A reduced fit (degree 3, 40 designs a type, five resnet20 layers) keeps
the file fast.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.dse as ref_dse
import repro.explore as R
from repro.core import ppa as ref_ppa
from repro.core.pe import PE_TYPES
from repro.core.table import COLUMNS
from repro.core.workloads import get_network

import repro_torch.core.dse as dse
import repro_torch.explore as P
from repro_torch import convert
from repro_torch.core import oracle
from repro_torch.core.dataflow import AcceleratorConfig as PortConfig
from repro_torch.explore import backend as backend_mod
from repro_torch.explore import session as session_mod

U = 2.0 ** -53
METRICS = ("latency_s", "power_mw", "area_mm2")
FIT = dict(degree=3, n_train=40, seed=0)


def gamma(m: int) -> float:
  return m * U / (1.0 - m * U)


def port_cfgs(cfgs):
  return [PortConfig(*dataclasses.astuple(c)) for c in cfgs]


def port_table(table):
  cols = {name: getattr(table, name) for name in COLUMNS + ("pe_code",)}
  return convert.table_from_columns(cols, table.pe_type_names)


def raw_bound(model, x):
  """Per row, ``2 gamma_m sum_j |phi_j c_j|``: how far two orders of the
  same float64 sum can fall apart (from the reference's phi)."""
  phi = ref_ppa.poly_features(np.asarray(x, np.float64), model.exponents,
                              model.col_scale)
  return 2.0 * gamma(len(model.coef)) * np.abs(phi * model.coef).sum(axis=1)


@dataclasses.dataclass
class Bounds:
  """Per-row bounds of a frame evaluated by the port against the
  reference's: ``lat`` bounds ``|log(port / ref)|`` (each layer's raw
  bound plus 4u for the host's exp and scale, the worst layer's, plus the
  two per-network sums' own roundings); ``pwr`` and ``area`` bound
  ``|port - ref|`` (the raw bound scaled by y_scale, plus 4u of the value
  for the scale's and the global buffer add's roundings on each side)."""
  lat: np.ndarray
  pwr: np.ndarray
  area: np.ndarray

  @classmethod
  def of(cls, models, cfgs, layers, want):
    pe = np.asarray([c.pe_type for c in cfgs])
    hw4 = np.asarray([c.hw_features() for c in cfgs], np.float64)
    hw6 = np.asarray([c.latency_hw_features() for c in cfgs], np.float64)
    lf = np.asarray([l.features() for l in layers], np.float64)
    n, n_l = len(cfgs), len(layers)
    lat, pwr, area = np.empty(n), np.empty(n), np.empty(n)
    for t in np.unique(pe):
      idx = np.flatnonzero(pe == t)
      m = models[str(t)]
      rows = np.concatenate([np.repeat(hw6[idx], n_l, axis=0),
                             np.tile(lf, (idx.size, 1))], axis=1)
      per_layer = raw_bound(m.latency, rows) + 4.0 * U
      lat[idx] = per_layer.reshape(idx.size, n_l).max(axis=1) \
          + 3.0 * gamma(n_l)
      for out, model, col in ((pwr, m.power, want.power_mw),
                              (area, m.area, want.area_mm2)):
        out[idx] = raw_bound(model, hw4[idx]) * model.y_scale * (1 + 2 * U) \
            + 4.0 * U * np.abs(col[idx])
    return cls(lat, pwr, area)

  def check(self, got, want):
    assert np.all(np.abs(np.log(got.latency_s / want.latency_s)) <= self.lat)
    assert np.all(np.abs(got.power_mw - want.power_mw) <= self.pwr)
    assert np.all(np.abs(got.area_mm2 - want.area_mm2) <= self.area)

  def relative(self, want) -> float:
    """The frame's largest per-row relative bound over the three
    metrics."""
    return float(max(np.expm1(self.lat).max(),
                     (self.pwr / want.power_mw).max(),
                     (self.area / want.area_mm2).max()))


def assert_within(got, want, rel):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert np.all(np.abs(got - want) <= rel * np.abs(want))


def assert_fronts_match(got, want, rel, cols=("perf_per_area", "energy_mj")):
  """Equal fronts as row sets; where a near tie splits them, every row
  on one front only lies within ``rel`` of a row of the other front."""
  a = set(np.flatnonzero(got.pareto(cols)).tolist())
  b = set(np.flatnonzero(want.pareto(cols)).tolist())
  obj = np.stack([want.column(c) for c in cols], axis=1)
  for r in a ^ b:
    other = np.asarray(sorted(b if r in a else a))
    close = np.all(np.abs(obj[other] - obj[r]) <= rel * np.abs(obj[other]),
                   axis=1)
    assert close.any(), f"row {r} is on one front only and near no other"


@pytest.fixture(scope="module")
def layers():
  return get_network("resnet20")[:5]


@pytest.fixture(scope="module")
def players(layers):
  return convert.layers_from_tuples(dataclasses.astuple(l) for l in layers)


@pytest.fixture(scope="module")
def ref_backend(layers):
  return R.PolynomialBackend.fit(layers=layers, **FIT)


@pytest.fixture(scope="module")
def backend(players):
  return P.PolynomialBackend.fit(layers=players, device="cpu", **FIT)


@pytest.fixture(scope="module")
def cfgs():
  return R.DesignSpace().sample(30, seed=23)


@pytest.fixture(scope="module")
def frames(ref_backend, backend, cfgs, layers, players):
  want = ref_backend.evaluate(cfgs, layers, "resnet20")
  got = backend.evaluate(port_cfgs(cfgs), players, "resnet20")
  return got, want, Bounds.of(ref_backend.models, cfgs, layers, want)


# ---------------------------------------------------------------------------
# fitting and the .npz format
# ---------------------------------------------------------------------------

def test_fit_coefficients_equal(backend, ref_backend):
  assert backend.pe_types == ref_backend.pe_types
  for t in ref_backend.pe_types:
    for target in ("power", "area", "latency"):
      got = getattr(backend.models[t], target)
      want = getattr(ref_backend.models[t], target)
      assert np.array_equal(got.coef, want.coef), (t, target)
      assert np.array_equal(got.col_scale, want.col_scale)
      assert got.y_scale == want.y_scale


def test_fit_key_equal(layers, players):
  want = R.backend._fit_key(("INT16",), 3, 40, 0, layers)
  assert backend_mod._fit_key(("INT16",), 3, 40, 0, players) == want
  assert backend_mod._fit_key(("INT16",), 3, 40, 0, None) == \
      R.backend._fit_key(("INT16",), 3, 40, 0, None)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_npz_round_trips_both_ways(writer, backend, ref_backend, layers,
                                   players, tmp_path):
  path = str(tmp_path / "models.npz")
  key = "|".join(R.backend._fit_key(ref_backend.pe_types, 3, 40, 0, layers))
  (ref_backend if writer == "reference" else backend).save(path, fit_key=key)
  other = str(tmp_path / "other.npz")
  (backend if writer == "reference" else ref_backend).save(other,
                                                           fit_key=key)
  with np.load(path) as a, np.load(other) as b:
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
      assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
  got = P.PolynomialBackend.load(path, device="cpu")
  want = R.PolynomialBackend.load(path)
  for t in want.pe_types:
    for target in ("power", "area", "latency"):
      g, w = getattr(got.models[t], target), getattr(want.models[t], target)
      assert np.array_equal(g.coef, w.coef) and g.y_scale == w.y_scale
  # each side accepts the other's file as its own fit (equal fit keys)
  kw = dict(pe_types=ref_backend.pe_types, **FIT)
  assert P.PolynomialBackend.fit_or_load(path, layers=players, device="cpu",
                                         **kw).loaded_from == path
  assert R.PolynomialBackend.fit_or_load(path, layers=layers,
                                         **kw).loaded_from == path


def test_bumped_oracle_version_forces_refit(players, tmp_path, monkeypatch):
  path = str(tmp_path / "cache.npz")
  kw = dict(pe_types=("INT16",), degree=2, n_train=30, layers=players,
            seed=0, device="cpu")
  assert P.PolynomialBackend.fit_or_load(path, **kw).loaded_from is None
  assert P.PolynomialBackend.fit_or_load(path, **kw).loaded_from == path
  monkeypatch.setattr(oracle, "ORACLE_VERSION", oracle.ORACLE_VERSION + 1)
  monkeypatch.setattr(backend_mod, "_FIT_CACHE", {})
  assert P.PolynomialBackend.fit_or_load(path, **kw).loaded_from is None
  assert P.PolynomialBackend.fit_or_load(path, **kw).loaded_from == path


def test_corrupt_cache_refits(players, tmp_path):
  path = tmp_path / "cache.npz"
  path.write_bytes(b"not a zip file")
  got = P.PolynomialBackend.fit_or_load(
      str(path), pe_types=("INT16",), degree=2, n_train=30, layers=players,
      device="cpu")
  assert got.loaded_from is None
  assert P.PolynomialBackend.load(str(path), device="cpu").pe_types == \
      ("INT16",)


def test_default_device_is_cuda_and_never_falls_back(backend, players,
                                                     monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  for make in (lambda: P.PolynomialBackend(backend.models),
               lambda: P.PolynomialBackend(backend.models, device="cuda"),
               lambda: P.PolynomialBackend.fit(("INT16",), layers=players,
                                               **FIT),
               lambda: P.gbuf_overheads_table(
                   P.DesignSpace().sample_table(2, seed=0))):
    with pytest.raises(RuntimeError, match="no CUDA device"):
      make()
  assert P.PolynomialBackend(backend.models, device="cpu").device.type == \
      "cpu"


# ---------------------------------------------------------------------------
# evaluation: list and table paths, held to the per-row bound
# ---------------------------------------------------------------------------

def test_evaluate_list_within_bound(frames, cfgs):
  got, want, bounds = frames
  bounds.check(got, want)
  np.testing.assert_array_equal(got.pe_type, want.pe_type)
  assert got.cfgs == tuple(port_cfgs(cfgs))
  assert bounds.relative(want) < 1e-9


@pytest.mark.parametrize("chunk_size", [7, 32768])
def test_evaluate_table_within_bound(ref_backend, backend, layers, players,
                                     chunk_size):
  table = R.DesignSpace().sample_table(40, seed=5)
  want = ref_backend.evaluate_table(table, layers, "resnet20")
  got = backend.evaluate_table(port_table(table), players, "resnet20",
                               chunk_size=chunk_size)
  Bounds.of(ref_backend.models, table.to_configs(), layers, want).check(
      got, want)
  np.testing.assert_array_equal(got.pe_type, want.pe_type)
  assert got.table is not None and len(got.table) == len(table)


def test_gbuf_overheads_equal():
  table = R.DesignSpace(pe_types=tuple(PE_TYPES)).sample_table(20, seed=3)
  want = R.gbuf_overheads_table(table)
  got = P.gbuf_overheads_table(port_table(table), device="cpu")
  for g, w in zip(got, want):
    assert np.array_equal(g, w)
  cfgs = table.to_configs()[:15]
  want = R.gbuf_overheads(cfgs)
  got = P.gbuf_overheads(port_cfgs(cfgs))
  for g, w in zip(got, want):
    assert np.array_equal(g, w)


def test_missing_pe_type_raises(backend, players):
  sub = P.PolynomialBackend({"INT16": backend.models["INT16"]}, device="cpu")
  space = R.DesignSpace(pe_types=("FP32",))
  with pytest.raises(KeyError, match="no models for PE types"):
    sub.evaluate(port_cfgs(space.sample(2, seed=0)), players)
  with pytest.raises(KeyError, match="no models for PE types"):
    sub.evaluate_table(port_table(space.sample_table(2, seed=0)), players)


# ---------------------------------------------------------------------------
# normalization, figures and fronts
# ---------------------------------------------------------------------------

def test_normalize_best_int16_within_bound(frames):
  got, want, bounds = frames
  rel = 4.0 * bounds.relative(want)
  assert got.reference_index() == want.reference_index()
  for metric in ("perf", "energy", "area", "latency"):
    assert got.reference_index(metric, None) == \
        want.reference_index(metric, None)
  g, w = got.normalize("best-int16"), want.normalize("best-int16")
  assert g.ref_index == w.ref_index
  assert_within(g.perf_per_area, w.perf_per_area, rel)
  assert_within(g.energy, w.energy, rel)
  ppa_n, en_n = g
  assert ppa_n is g.perf_per_area and en_n is g.energy
  assert_within(got.normalize(3).energy, want.normalize(3).energy, rel)
  pair = (float(want.perf_per_area[0]), float(want.energy_mj[0]))
  assert_within(got.normalize(pair).perf_per_area,
                want.normalize(pair).perf_per_area, rel)
  with pytest.raises(ValueError, match="unknown normalization"):
    got.normalize("best-fp32")
  with pytest.raises(ValueError, match="no INT16 points"):
    got.select(~got.by_type("INT16")).normalize()


def test_figures_within_bound(frames):
  """Fig. 4's spreads, Fig. 9's per-type summaries and Table 2's per-type
  best perf/area and energy, as the reference's benchmarks compute them."""
  got, want, bounds = frames
  rel = 4.0 * bounds.relative(want)
  (g_ppa, g_en), (w_ppa, w_en) = got.normalize(), want.normalize()
  assert_within(g_ppa.max() / g_ppa.min(), w_ppa.max() / w_ppa.min(),
                2 * rel)
  for t in R.DesignSpace().pe_types:
    m = got.by_type(t)
    np.testing.assert_array_equal(m, want.by_type(t))
    assert_within(g_ppa[m].max(), w_ppa[m].max(), rel)
    assert_within(g_en[m].min(), w_en[m].min(), rel)
    for g, w in ((P.summary_stats(g_ppa[m]), R.summary_stats(w_ppa[m])),
                 (got.stats("energy_mj", m), want.stats("energy_mj", m))):
      assert g.keys() == w.keys()
      assert_within([g[k] for k in w], [w[k] for k in w], rel)
  assert all(np.isnan(v) for v in P.summary_stats(np.zeros(0)).values())


def test_fronts_match(frames):
  got, want, bounds = frames
  rel = 4.0 * bounds.relative(want)
  assert_fronts_match(got, want, rel)
  assert_fronts_match(got, want, rel, ("latency_s", "energy_mj"))


def test_points_round_trip(frames):
  got, want, _ = frames
  pts = got.to_points()
  assert [dataclasses.astuple(p.cfg) for p in pts] == \
      [dataclasses.astuple(p.cfg) for p in want.to_points()]
  back = P.ResultFrame.from_points(pts)
  for c in METRICS:
    np.testing.assert_array_equal(back.column(c), got.column(c))
  assert back.network == "resnet20"
  p, w = pts[4], want.to_points()[4]
  assert_within([p.perf_per_area, p.energy_mj],
                [w.perf_per_area, w.energy_mj], 1e-9)


# ---------------------------------------------------------------------------
# list samplers and the grid helpers
# ---------------------------------------------------------------------------

SMALL_AXES = {"pe_rows": (8, 16), "sp_if": (6, 12, 24), "gbuf_kb": (64, 128)}


@pytest.mark.parametrize("method", ["random", "grid", "stratified"])
def test_list_samplers_equal(method):
  n_pe = lambda c: c.pe_rows * c.pe_cols <= 400
  want = R.DesignSpace(constraints=(n_pe,)).sample(17, seed=4, method=method)
  got = P.DesignSpace(constraints=(n_pe,)).sample(17, seed=4, method=method)
  assert [dataclasses.astuple(c) for c in got] == \
      [dataclasses.astuple(c) for c in want]
  assert P.DesignSpace().sample_type("INT16", 9, seed=1, method=method) == \
      port_cfgs(R.DesignSpace().sample_type("INT16", 9, seed=1,
                                            method=method))


def test_grid_rank_axis_delta_with_axes():
  ref_space = R.DesignSpace(axes=SMALL_AXES)
  space = P.DesignSpace(axes=SMALL_AXES)
  assert space.per_type_grid_size() == ref_space.per_type_grid_size()
  assert space.axis("sp_if") == P.space.Axis("sp_if", (6, 12, 24))
  table = ref_space.sample_table(50, seed=2, method="grid")
  np.testing.assert_array_equal(space.grid_rank(port_table(table)),
                                ref_space.grid_rank(table))
  edits = [dict(sp_if=(6, 8, 12, 24)), dict(sp_if=(24, 12, 6)),
           dict(sp_if=(6, 12)), dict(sp_if=(6, 8, 12, 24), gbuf_kb=(64,)),
           {}]
  for edit in edits:
    want = ref_space.with_axes(**edit)
    got = space.with_axes(**edit)
    assert [a.values for a in got.axes] == [a.values for a in want.axes]
    assert got.axis_delta(space) == want.axis_delta(ref_space)
    base = {a.name: a.values for a in ref_space.axes}
    assert got.axis_delta(base) == want.axis_delta(base)
  with pytest.raises(ValueError, match="outside this space"):
    P.DesignSpace(axes=dict(SMALL_AXES, sp_if=(6,))).grid_rank(
        port_table(table))


def test_table_mask_equal():
  vec = R.vector_constraint(lambda c: c.n_pe <= 256, lambda t: t.n_pe <= 256)
  pvec = P.vector_constraint(lambda c: c.n_pe <= 256, lambda t: t.n_pe <= 256)
  plain = lambda c: c.sp_if * 4 <= c.sp_ps
  table = R.DesignSpace().sample_table(60, seed=8)
  want = R.DesignSpace(constraints=(vec, plain)).table_mask(table)
  got = P.DesignSpace(constraints=(pvec, plain)).table_mask(
      port_table(table))
  np.testing.assert_array_equal(got, want)
  assert 0 < got.sum() < got.size


# ---------------------------------------------------------------------------
# the session: evaluate, explore's routes, measure_oracle
# ---------------------------------------------------------------------------

def test_session_evaluate_and_default_space(ref_backend, backend, layers,
                                            players):
  sess = P.ExplorationSession(backend)
  assert sess.space.pe_types == backend.pe_types
  one = P.ExplorationSession(P.PolynomialBackend(
      {"INT16": backend.models["INT16"]}, device="cpu"))
  assert one.space.pe_types == ("INT16",)
  cfgs = R.DesignSpace().sample(6, seed=31)
  want = R.ExplorationSession(ref_backend).evaluate(cfgs, layers)
  got = sess.evaluate(port_cfgs(cfgs), players)
  Bounds.of(ref_backend.models, cfgs, layers, want).check(got, want)


@pytest.mark.parametrize("vectorized", [True, False, "auto"])
def test_explore_routes_within_bound(ref_backend, backend, layers, players,
                                     vectorized):
  want = R.ExplorationSession(ref_backend).explore(
      layers, "resnet20", n_per_type=12, seed=9, vectorized=vectorized)
  got = P.ExplorationSession(backend).explore(
      players, "resnet20", n_per_type=12, seed=9, vectorized=vectorized)
  assert (got.table is not None) == (want.table is not None) \
      == (vectorized is True)
  cfgs = want.table.to_configs() if want.table is not None else want.cfgs
  Bounds.of(ref_backend.models, cfgs, layers, want).check(got, want)
  assert got.meta["eval_seconds"] > 0 and "speedup" not in got.meta


@pytest.mark.parametrize("vectorized", [True, False])
def test_explore_measure_oracle(backend, players, vectorized):
  frame = P.ExplorationSession(backend).explore(
      players, "resnet20", n_per_type=5, seed=2, measure_oracle=5,
      vectorized=vectorized)
  assert frame.meta["oracle_seconds_per_design"] > 0
  assert frame.meta["speedup"] > 0
  with pytest.raises(ValueError, match="one-shot"):
    P.ExplorationSession(backend).explore(players, "net", stream=True,
                                          measure_oracle=5)


def test_explore_without_table_path_raises(players):
  with pytest.raises(ValueError, match="no evaluate_table"):
    P.ExplorationSession(P.OracleBackend()).explore(players, "net",
                                                    n_per_type=2,
                                                    vectorized=True)


def test_oracle_backend_equal(layers, players):
  cfgs = R.DesignSpace().sample(3, seed=6)
  want = R.OracleBackend().evaluate(cfgs, layers)
  got = P.OracleBackend().evaluate(port_cfgs(cfgs), players)
  for c in METRICS:
    np.testing.assert_array_equal(got.column(c), want.column(c))


def test_stream_through_the_polynomial_backend(backend, players):
  """No device rungs: each chunk runs the backend's evaluate_table, and
  the streamed front is the one-shot table frame's."""
  sess = P.ExplorationSession(backend)
  full = sess.explore(players, "net", n_per_type=20, seed=4,
                      vectorized=True)
  res = sess.explore(players, "net", n_per_type=20, seed=4, stream=True,
                     chunk_size=13,
                     reducers={"pareto": P.ParetoAccumulator(),
                               "all": P.CollectAccumulator()})
  front = full.select(full.pareto())
  for c in METRICS:
    np.testing.assert_array_equal(res["pareto"].column(c), front.column(c))
    np.testing.assert_array_equal(res["all"].column(c), full.column(c))
  assert res.meta["n_chunks"] == float(len(list(sess.space.iter_tables(
      20, seed=4, chunk_size=13))))


def test_auto_threshold_routes_through_engine(layers, players, monkeypatch):
  backend = P.TorchOracleBackend(chunk_size=64, device="cpu")
  sess = P.ExplorationSession(backend)
  base = sess.explore(players, "net", n_per_type=25, seed=4)
  assert "streamed" not in base.meta
  monkeypatch.setattr(session_mod, "STREAM_AUTO_MIN_ROWS", 50)
  auto = sess.explore(players, "net", n_per_type=25, seed=4)
  assert auto.meta["streamed"] == 1.0
  want = R.ExplorationSession(R.VectorOracleBackend(chunk_size=64)).explore(
      layers, "net", n_per_type=25, seed=4)
  for col in METRICS:
    np.testing.assert_array_equal(getattr(auto, col), getattr(base, col))
    np.testing.assert_array_equal(getattr(auto, col), getattr(want, col))
  assert auto.table is not None
  assert auto.config_at(3) == base.config_at(3)


# ---------------------------------------------------------------------------
# the dse compatibility shim
# ---------------------------------------------------------------------------

def test_dse_shim(ref_backend, backend, layers, players):
  assert dse.__all__ == ref_dse.__all__
  assert all(hasattr(dse, name) for name in dse.__all__)
  cfgs = R.DesignSpace().sample(4, seed=12)
  pts = dse.evaluate_with_oracle(port_cfgs(cfgs), players, "n")
  want = ref_dse.evaluate_with_oracle(cfgs, layers, "n")
  assert [(p.latency_s, p.power_mw, p.area_mm2) for p in pts] == \
      [(p.latency_s, p.power_mw, p.area_mm2) for p in want]
  mpts = dse.evaluate_with_models(backend.models, port_cfgs(cfgs), players,
                                  "n", device="cpu")
  ref_pts = ref_dse.evaluate_with_models(ref_backend.models, cfgs, layers,
                                         "n")
  assert_within([p.energy_mj for p in mpts], [p.energy_mj for p in ref_pts],
                1e-9)
  ref = dse.best_int16_reference(pts)
  assert dataclasses.astuple(ref.cfg) == \
      dataclasses.astuple(ref_dse.best_int16_reference(want).cfg)
  for g, w in zip(dse.normalized_metrics(pts),
                  ref_dse.normalized_metrics(want)):
    np.testing.assert_array_equal(g, w)
  obj = np.random.RandomState(0).uniform(size=(40, 3))
  np.testing.assert_array_equal(dse.pareto_front(obj),
                                ref_dse.pareto_front(obj))
  assert dse.distribution_stats(obj[:, 0]) == \
      ref_dse.distribution_stats(obj[:, 0])
  explorer = dse.DesignSpaceExplorer(("INT16",), degree=2, n_train=30,
                                     layers=players, device="cpu")
  res = explorer.explore(players, "n", n_per_type=4, measure_oracle=2)
  assert len(res.points) == 4 and res.speedup > 0
  assert set(explorer.models) == {"INT16"}
