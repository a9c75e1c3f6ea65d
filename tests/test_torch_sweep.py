"""The port's streamed sweep (sampling, fused device reduction, streaming
reducers) against the JAX package's numpy path on the CPU.

The reference is ``VectorOracleBackend()`` (numpy) with the host
reducers; the port runs ``TorchOracleBackend(device="cpu")``, whose
fused chunk program takes the plain versions of its kernels there.
Fronts and top-k must be identical in row ids and values, histogram
counts equal, stats within a relative 1e-12.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.explore as R
from repro.core.workloads import get_network
from repro.explore import streaming as RS

import repro_torch.explore as P
from repro_torch import convert
from repro_torch.core.table import COLUMNS
from repro_torch.explore import device as device_lib
from repro_torch.explore import streaming as PS
from repro_torch.kernels.pareto_front import kernel

METRICS = ("latency_s", "power_mw", "area_mm2")
COLS3 = ("latency_s", "energy_mj", "area_mm2")


@pytest.fixture(scope="module")
def layers():
  return get_network("resnet20")[:5]


@pytest.fixture(scope="module")
def port_layers(layers):
  return convert.layers_from_tuples(dataclasses.astuple(l) for l in layers)


@pytest.fixture(scope="module")
def backend():
  return P.TorchOracleBackend(device="cpu")


def reducers(m, top_k=9):
  """test_device_sweep.py's reducer set plus a 3-objective front."""
  return {"pareto": m.ParetoAccumulator(),
          "pareto3": m.ParetoAccumulator(COLS3),
          "top": m.TopKAccumulator(top_k, by="energy_mj"),
          "stats": m.StatsAccumulator("power_mw"),
          "hist": m.HistogramAccumulator("area_mm2", 0.0, 200.0, bins=32)}


def assert_same_frames(a, b, ctx=""):
  assert len(a) == len(b), ctx
  for col in METRICS:
    np.testing.assert_array_equal(a.column(col), b.column(col),
                                  err_msg=f"{ctx} {col}")
  np.testing.assert_array_equal(a.pe_type, b.pe_type, err_msg=ctx)


def assert_same_streams(got_red, got, want_red, want):
  for name in ("pareto", "pareto3", "top"):
    assert_same_frames(got[name], want[name], name)
    np.testing.assert_array_equal(got_red[name].indices,
                                  want_red[name].indices, err_msg=name)
  np.testing.assert_array_equal(got["hist"]["counts"], want["hist"]["counts"])
  for k, v in want["stats"].items():
    assert got["stats"][k] == pytest.approx(v, rel=1e-12), k


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["random", "grid", "stratified"])
def test_sample_table_column_identical(method):
  want = R.DesignSpace().sample_table(70, seed=9, method=method)
  got = P.DesignSpace().sample_table(70, seed=9, method=method)
  assert got.pe_type_names == want.pe_type_names
  for name in ("pe_code",) + COLUMNS:
    np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                  err_msg=name)


@pytest.mark.parametrize("method", ["random", "grid", "stratified"])
@pytest.mark.parametrize("chunk_size", [1, 37, 1000])
def test_iter_tables_chunk_identical(method, chunk_size):
  want = list(R.DesignSpace().iter_tables(50, seed=3, method=method,
                                          chunk_size=chunk_size))
  got = list(P.DesignSpace().iter_tables(50, seed=3, method=method,
                                         chunk_size=chunk_size))
  assert [len(t) for t in got] == [len(t) for t in want]
  for g, w in zip(got, want):
    assert g.pe_type_names == w.pe_type_names
    for name in ("pe_code",) + COLUMNS:
      np.testing.assert_array_equal(getattr(g, name), getattr(w, name))


def test_constraints_filter_like_the_reference():
  def small(cfg):
    return cfg.pe_rows * cfg.pe_cols <= 256
  want = R.DesignSpace(constraints=(small,)).sample_table(40, seed=2)
  got = P.DesignSpace(constraints=(small,)).sample_table(40, seed=2)
  vec = P.DesignSpace(constraints=(P.space.VectorConstraint(
      small, lambda t: t.n_pe <= 256),)).sample_table(40, seed=2)
  for name in COLUMNS:
    np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(getattr(vec, name), getattr(want, name))


# ---------------------------------------------------------------------------
# the fused stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk_size", [53, 260, 4096])
def test_fused_stream_matches_reference_host_stream(layers, port_layers,
                                                    backend, chunk_size):
  want_red, got_red = reducers(RS), reducers(PS)
  want = RS.stream_explore(R.VectorOracleBackend(), R.DesignSpace(), layers,
                           n_per_type=90, seed=4, reducers=want_red,
                           chunk_size=chunk_size)
  got = PS.stream_explore(backend, P.DesignSpace(), port_layers,
                          n_per_type=90, seed=4, reducers=got_red,
                          chunk_size=chunk_size)
  assert_same_streams(got_red, got, want_red, want)
  assert got.n_rows == want.n_rows == 360
  assert got.meta["n_chunks"] == want.meta["n_chunks"]
  assert got.meta["rows_transferred"] < got.n_rows  # O(survivors)
  assert got.meta["n_overflows"] == 0 and got.meta["n_demotions"] == 0


def test_session_stream_and_one_shot_match_reference(layers, port_layers,
                                                     backend):
  ref_session = R.ExplorationSession(R.VectorOracleBackend(), R.DesignSpace())
  session = P.ExplorationSession(backend, P.DesignSpace())
  want = ref_session.explore(layers, "net", n_per_type=60, seed=6,
                             vectorized=True)
  got = session.explore(port_layers, "net", n_per_type=60, seed=6)
  assert_same_frames(got, want, "one-shot")
  assert got.meta["eval_us_per_design"] > 0
  assert dataclasses.astuple(got.config_at(5)) == \
      dataclasses.astuple(want.config_at(5))
  res = session.explore(port_layers, "net", n_per_type=60, seed=6,
                        stream=True, reducers=reducers(PS, top_k=5),
                        chunk_size=70)
  # streamed survivors == the one-shot frame's pareto/top_k, row for row
  assert_same_frames(res["pareto"], want.select(want.pareto()), "pareto")
  assert_same_frames(res["pareto3"], want.select(want.pareto(COLS3)),
                     "pareto3")
  assert_same_frames(res["top"], want.top_k(5, by="energy_mj"), "top")
  with pytest.raises(ValueError, match="stream=True"):
    session.explore(port_layers, "net", reducers=reducers(PS))


def test_cap_overflow_falls_back_to_the_full_chunk(layers, port_layers,
                                                   backend):
  want_red, got_red = reducers(RS), reducers(PS)
  want = RS.stream_explore(R.VectorOracleBackend(), R.DesignSpace(), layers,
                           n_per_type=80, seed=11, reducers=want_red,
                           chunk_size=120)
  plan = device_lib.build_plan(got_red, joint=False,
                               cap=2)  # < every chunk's front
  tasks = [
      (lambda c=c, idx=idx: backend.fused_eval_pending(
          c, port_layers, "net", plan, idx))
      for c, idx in _chunks(80, 11, 120)]
  got = PS.run_stream(tasks, got_red)
  assert got.meta["n_overflows"] > 0
  assert_same_streams(got_red, got, want_red, want)


def _chunks(n_per_type, seed, chunk_size):
  offset = 0
  for chunk in P.DesignSpace().iter_tables(n_per_type, seed=seed,
                                           chunk_size=chunk_size):
    yield chunk, np.arange(offset, offset + len(chunk))
    offset += len(chunk)


class _Collect(PS.Reducer):
  """Keeps whole chunks: not fusable, so the stream takes the plain
  device rung (eval_pending)."""

  def __init__(self):
    self.parts = []

  def fold(self, frame, indices):
    self.parts.append((frame, np.asarray(indices)))

  def result(self):
    return self.parts


def test_unfusable_reducers_take_the_plain_device_rung(layers, port_layers,
                                                       backend):
  want = R.VectorOracleBackend().evaluate_table(
      R.DesignSpace().sample_table(30, seed=8), layers)
  collect = _Collect()
  res = PS.stream_explore(backend, P.DesignSpace(), port_layers,
                          n_per_type=30, seed=8, reducers={"all": collect},
                          chunk_size=25)
  assert res.meta["rows_transferred"] == res.n_rows == 120
  frames = [f for f, _ in collect.parts]
  idx = np.concatenate([i for _, i in collect.parts])
  np.testing.assert_array_equal(idx, np.arange(120))
  for col in METRICS:
    np.testing.assert_array_equal(
        np.concatenate([f.column(col) for f in frames]), want.column(col))
  pending = backend.eval_pending(P.DesignSpace().sample_table(2, seed=8),
                                 port_layers, "net", np.arange(8))
  assert pending.is_ready()  # a CPU chunk is done once dispatched
  assert len(pending.resolve()[0]) == 8


def test_ladder_carries_device_rungs_only(port_layers, backend):
  tasks = list(PS.explore_tasks(backend, P.DesignSpace(), port_layers, "net",
                                n_per_type=5, seed=1, method="random",
                                chunk_size=8, reducers=reducers(PS)))
  assert [r.name for r in tasks[0].rungs] == ["fused-device", "device"]
  tasks = list(PS.explore_tasks(backend, P.DesignSpace(), port_layers, "net",
                                n_per_type=5, seed=1, method="random",
                                chunk_size=8, reducers={"all": _Collect()}))
  assert [r.name for r in tasks[0].rungs] == ["device"]
  assert [t.index for t in tasks] == list(range(len(tasks)))


def test_failing_chunk_raises_with_its_index():
  def boom():
    raise ValueError("bad chunk")
  with pytest.raises(PS.ChunkError, match="chunk 0 failed"):
    PS.run_stream([boom], {})


def test_three_objective_front_goes_through_the_block_prefilter(
    port_layers, backend, monkeypatch):
  calls = []
  from repro_torch.kernels.pareto_front import ops
  real = ops.block_prefilter_mask

  def spy(obj, block=128):
    calls.append((tuple(obj.shape), block))
    return real(obj, block)

  monkeypatch.setattr(ops, "block_prefilter_mask", spy)
  kernel.reset_launch_counts()
  PS.stream_explore(backend, P.DesignSpace(), port_layers, n_per_type=40,
                    seed=2, reducers={"p3": PS.ParetoAccumulator(COLS3)},
                    chunk_size=64)
  assert calls and all(b == device_lib.PREFILTER_BLOCK for _, b in calls)
  assert sum(n for (n, _), _ in calls) == 160
  assert kernel.LAUNCHES["block_dominance_counts"] == 0  # CPU: plain version


# ---------------------------------------------------------------------------
# the device-side pieces that replace jax primitives
# ---------------------------------------------------------------------------

def test_stable_topk_breaks_ties_like_a_stable_sort():
  key = np.repeat(np.random.RandomState(0).randint(0, 5, 400), 3).astype(
      np.float64)
  t = torch.from_numpy(key)
  naive = torch.topk(-t, 50).indices.numpy()
  want = np.argsort(key, kind="stable")[:50]
  assert not np.array_equal(naive, want)  # topk: ties in no set order
  np.testing.assert_array_equal(
      device_lib._stable_topk_indices(t, 50, maximize=False).numpy(), want)
  np.testing.assert_array_equal(
      device_lib._stable_topk_indices(t, 50, maximize=True).numpy(),
      np.argsort(-key, kind="stable")[:50])


@pytest.mark.parametrize("density,cap", [(0.3, 1024), (0.3, 10), (0.0, 8)])
def test_sized_compaction(density, cap):
  mask = np.random.RandomState(1).uniform(size=3000) < density
  idx, count = device_lib._compact(torch.from_numpy(mask), cap)
  assert idx.shape == (cap,) and int(count) == int(mask.sum())
  want = np.full(cap, mask.size)
  hits = np.flatnonzero(mask)[:cap]
  want[:hits.size] = hits
  np.testing.assert_array_equal(idx.numpy(), want)
  # torch.nonzero returns every hit at its own size (and waits for the
  # device to know it)
  assert torch.nonzero(torch.from_numpy(mask)).shape[0] != cap


def test_histogram_counts_match_numpy_histogram():
  rng = np.random.RandomState(3)
  v = np.concatenate([rng.uniform(-10, 210, 5000),
                      np.linspace(0.0, 200.0, 33)])  # values on the edges
  got = device_lib._histogram_counts(torch.from_numpy(v), 0.0, 200.0, 32)
  edges = np.linspace(0.0, 200.0, 33)
  want = np.histogram(np.clip(v, edges[0], edges[-1]), bins=edges)[0]
  np.testing.assert_array_equal(got.numpy(), want)


def test_staircase_is_a_front_superset():
  from repro_torch.explore.frame import pareto_mask
  rng = np.random.RandomState(2)
  x = rng.uniform(size=(5, 200))
  y = rng.uniform(size=(5, 200))
  keep = device_lib._staircase_mask(torch.from_numpy(x),
                                    torch.from_numpy(y)).numpy()
  for g in range(5):
    front = pareto_mask(np.stack([x[g], y[g]], axis=1))
    assert not (front & ~keep[g]).any(), g


def test_cpu_probe_reports_every_hazard():
  report = device_lib.ensure_exact("cpu")
  assert all(report["checks"].values())
  assert set(report["checks"]) >= {"F1 div(float, tensor)",
                                   "F2/F6 oracle vs CPU", "F5 stable top-k",
                                   "F7 sized compaction"}
  assert report["raw_mismatches"]["F1 float / tensor"] > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_quantile_equals_the_reference(seed):
  """G1: ``HistogramAccumulator.quantile`` over a grid of q (the clipped
  ends included) equals the reference's on the same counts, and both are
  NaN on an empty histogram."""
  rng = np.random.RandomState(seed)
  got = P.HistogramAccumulator("power_mw", 0.0, 50.0, bins=16)
  want = R.HistogramAccumulator("power_mw", 0.0, 50.0, bins=16)
  assert np.isnan(got.quantile(0.5)) and np.isnan(want.quantile(0.5))
  counts = rng.randint(0, 40, 16).astype(np.int64)
  counts[rng.randint(0, 16, 4)] = 0       # empty bins inside the range
  got.counts[:] = counts
  want.counts[:] = counts
  for q in np.concatenate([np.linspace(-0.25, 1.25, 61), [0.0, 1.0]]):
    assert got.quantile(q) == want.quantile(q), q


@pytest.mark.parametrize("method", ["random", "grid"])
def test_config_table_iterates_like_the_reference(method):
  """G2: ``list(table)`` yields ``config_at(i)`` row for row, equal to
  the reference's configs."""
  got = list(P.DesignSpace().sample_table(20, seed=5, method=method))
  want = list(R.DesignSpace().sample_table(20, seed=5, method=method))
  assert len(got) == len(want) == 80
  assert [dataclasses.astuple(c) for c in got] == \
      [dataclasses.astuple(c) for c in want]
