"""The port's HW x NN co-exploration against the JAX package's numpy path
on the CPU: the Table-4 search space and its workload bridge, the
LayerStack, the joint oracle, the JointTable, the session's one-shot,
nested-loop and streamed co-exploration, the polynomial joint path, and
the ``coexplore`` shim.

The reference is ``VectorOracleBackend()`` (numpy; its jax path does not
run on this jax) with the host reducers, ``workers=1``; the port runs
``TorchOracleBackend(device="cpu")``, whose fused joint program takes the
plain versions of its kernels there.  The joint oracle must be
bit-identical; fronts and top-k identical row for row, ``arch_id``,
``top1`` and ``arch_lookup`` included; histogram counts equal; stats
within a relative 1e-12.  Polynomial predictions are held per pair to
the bound of ``tests/test_torch_poly_backend.py``.  Architectures come
from ``RandomState`` with fixed seeds, accuracies from ``uniform(0.5,
0.95)``: 12 archs x 40 HW a PE type at image size 16.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.explore as R
from repro.core import cnn as ref_cnn
from repro.core import coexplore as ref_coexplore
from repro.core import oracle as ref_oracle
from repro.core.dataflow import LayerStack as RefLayerStack
from repro.core.supernet import arch_to_layers as ref_arch_to_layers
from repro.core.table import COLUMNS
from repro.explore import streaming as RS

import repro_torch.explore as P
from repro_torch import convert
from repro_torch.core import cnn, coexplore, oracle, prng, supernet
from repro_torch.core.seeding import derive_seed
from repro_torch.core.dataflow import AcceleratorConfig as PortConfig
from repro_torch.core.dataflow import LayerStack
from repro_torch.core.table import JointTable
from repro_torch.explore import device as device_lib
from repro_torch.explore import session as session_mod
from repro_torch.explore import streaming as PS
from repro_torch.kernels.pareto_front import kernel

from test_torch_package import PORT_FILES, _forbidden, _imported_modules
from test_torch_poly_backend import Bounds

METRICS = ("latency_s", "power_mw", "area_mm2")
JOINT3 = ("top1_err", "energy_mj", "area_mm2")
COLS3 = ("latency_s", "energy_mj", "area_mm2")
N_ARCHS = 12
N_HW = 40
IMAGE = 16
POLY_FIT = dict(degree=3, n_train=40, seed=0)


def draw_stages(n, seed):
  """Per-stage (repeats, channels) of ``n`` Table-4 architectures, drawn
  as ``benchmarks/framework_perf.py`` draws them."""
  rng = np.random.RandomState(seed)
  stages = [tuple((int(rng.choice(reps)), int(rng.choice(chs)))
                  for reps, chs in ref_cnn.SEARCH_SPACE) for _ in range(n)]
  return stages, rng.uniform(0.5, 0.95, size=n)


@pytest.fixture(scope="module")
def plain():
  return draw_stages(N_ARCHS, seed=0)


@pytest.fixture(scope="module")
def ref_arch_accs(plain):
  stages, accs = plain
  return [(ref_cnn.ArchChoice(s), float(a)) for s, a in zip(stages, accs)]


@pytest.fixture(scope="module")
def arch_accs(plain):
  return convert.arch_accs_from_plain(*plain)


@pytest.fixture(scope="module")
def stacks(plain):
  stages, _ = plain
  want = RefLayerStack.from_layer_lists(
      [ref_arch_to_layers(ref_cnn.ArchChoice(s), image_size=IMAGE)
       for s in stages])
  got = LayerStack.from_layer_lists(
      [supernet.arch_to_layers(cnn.ArchChoice(s), image_size=IMAGE)
       for s in stages])
  return got, want


@pytest.fixture(scope="module")
def backend():
  return P.TorchOracleBackend(device="cpu")


def port_table(table):
  cols = {name: getattr(table, name) for name in COLUMNS + ("pe_code",)}
  return convert.table_from_columns(cols, table.pe_type_names)


def port_inputs(table):
  return {k: torch.from_numpy(v)
          for k, v in oracle.batch_inputs(port_table(table)).items()}


def assert_same_frames(got, want, ctx=""):
  """Equal values row for row, PE types, and architecture columns (the
  lookups compared by their stages: each package has its ArchChoice)."""
  assert len(got) == len(want), ctx
  for col in METRICS:
    np.testing.assert_array_equal(got.column(col), want.column(col),
                                  err_msg=f"{ctx} {col}")
  np.testing.assert_array_equal(got.pe_type, want.pe_type, err_msg=ctx)
  assert set(got.extra) == set(want.extra), ctx
  for key in want.extra:
    np.testing.assert_array_equal(got.extra[key], want.extra[key],
                                  err_msg=f"{ctx} {key}")
  assert [a.stages for a in got.arch_lookup] == \
      [a.stages for a in want.arch_lookup], ctx


# ---------------------------------------------------------------------------
# the search space and the workload bridge
# ---------------------------------------------------------------------------

def test_search_space_is_a_copy():
  assert cnn.SEARCH_SPACE == ref_cnn.SEARCH_SPACE
  assert cnn.MAX_PLAN == ref_cnn.MAX_PLAN
  assert cnn.SPACE_SIZE == ref_cnn.SPACE_SIZE == supernet.space_size()
  assert cnn.max_arch().as_plan() == ref_cnn.max_arch().as_plan()
  key = derive_seed("supernet-eval", 1, 0)
  assert cnn.sample_arch(prng.PRNGKey(key)).stages == \
      ref_cnn.sample_arch(jax.random.PRNGKey(key)).stages


@pytest.mark.parametrize("image_size", [16, 32])
def test_arch_to_layers_equal(image_size):
  stages, _ = draw_stages(20, seed=5)
  archs = [ref_cnn.max_arch()] + [ref_cnn.ArchChoice(s) for s in stages]
  for arch in archs:
    want = [dataclasses.astuple(l)
            for l in ref_arch_to_layers(arch, image_size=image_size)]
    got = [dataclasses.astuple(l) for l in supernet.arch_to_layers(
        cnn.ArchChoice(arch.stages), image_size=image_size)]
    assert got == want


def test_arch_accs_from_plain(plain, ref_arch_accs, arch_accs):
  assert [(a.stages, acc) for a, acc in arch_accs] == \
      [(a.stages, acc) for a, acc in ref_arch_accs]
  with pytest.raises(ValueError, match="accuracies"):
    convert.arch_accs_from_plain(plain[0], plain[1][:-1])


# ---------------------------------------------------------------------------
# the LayerStack and the joint oracle
# ---------------------------------------------------------------------------

def test_layer_stack_fields_equal(stacks):
  got, want = stacks
  for name in ("A", "C", "F", "K", "S", "P", "rs", "ds", "valid"):
    np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
  assert (got.n_archs, got.max_layers) == (want.n_archs, want.max_layers)
  np.testing.assert_array_equal(got.n_layers(), want.n_layers())
  np.testing.assert_array_equal(got.features(), want.features())
  for li in range(want.max_layers):
    for key, col in want.feats_at(li).items():
      np.testing.assert_array_equal(got.feats_at(li)[key], col)
  assert got.fingerprint() == want.fingerprint()
  for a in (0, N_ARCHS - 1):
    assert [dataclasses.astuple(l) for l in got.layers_of(a)] == \
        [dataclasses.astuple(l) for l in want.layers_of(a)]
  sub_got, sub_want = got.slice_archs(3, 8), want.slice_archs(3, 8)
  np.testing.assert_array_equal(sub_got.features(), sub_want.features())
  np.testing.assert_array_equal(sub_got.valid, sub_want.valid)


def test_dedup_slots_equal(stacks):
  got, want = stacks
  (got_cols, got_ids), (want_cols, want_ids) = (got.dedup_slots(),
                                                want.dedup_slots())
  np.testing.assert_array_equal(got_ids, want_ids)
  assert got_ids.dtype == want_ids.dtype
  assert set(got_cols) == set(want_cols)
  for key, col in want_cols.items():
    np.testing.assert_array_equal(got_cols[key], col)
  # fewer distinct layers than slots: the point of the factorization
  assert len(want_cols["A"]) < want.valid.sum()


def test_stack_pads_short_networks():
  layers = [supernet.arch_to_layers(cnn.max_arch(), image_size=8),
            supernet.arch_to_layers(cnn.max_arch(), image_size=8)[:1]]
  ref_layers = [[ref_arch_to_layers(ref_cnn.max_arch(), image_size=8)[0]]]
  got = LayerStack.from_layer_lists(layers)
  assert got.n_layers().tolist() == [13, 1]
  assert not got.valid[1, 1:].any()
  one = LayerStack.from_layer_lists(layers[1:])
  want = RefLayerStack.from_layer_lists(ref_layers)
  np.testing.assert_array_equal(one.features(), want.features())
  with pytest.raises(ValueError, match="2-D"):
    LayerStack(*[np.zeros(3)] * 9)


@pytest.mark.parametrize("pe_type", ["FP32", "INT16", "LightPE-1",
                                     "LightPE-2"])
def test_joint_oracle_bit_equal(stacks, pe_type):
  got_stack, want_stack = stacks
  hw = R.DesignSpace().sample_type_table(pe_type, N_HW, seed=13)
  want = ref_oracle.characterize_joint(hw, want_stack)
  inputs = port_inputs(hw)
  cols, ids = got_stack.dedup_slots()
  dedup = oracle.characterize_joint_dedup(
      inputs, {k: torch.from_numpy(v) for k, v in cols.items()},
      torch.from_numpy(ids.astype(np.int64)),
      torch.from_numpy(got_stack.valid))
  slots = oracle.characterize_joint(inputs, got_stack)
  fields = ("clock_mhz", "area_mm2", "power_mw", "latency_s", "energy_mj",
            "utilization")
  for got in (dedup, slots):
    assert (got.n_archs, got.n_hw) == (N_ARCHS, N_HW)
    rel = max(float(np.max(np.abs(getattr(got, f).numpy()
                                  / getattr(want, f) - 1.0)))
              for f in fields)
    assert rel == 0.0  # parity_max_rel_err
    for f in fields:
      np.testing.assert_array_equal(getattr(got, f).numpy(),
                                    getattr(want, f), err_msg=f)
  # a row of the joint oracle is the one-network batch oracle
  one = oracle.characterize_batch(inputs, got_stack.layers_of(4))
  for f in ("latency_s", "energy_mj", "utilization"):
    np.testing.assert_array_equal(getattr(dedup, f)[4].numpy(),
                                  getattr(one, f).numpy())


# ---------------------------------------------------------------------------
# the JointTable
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def joints():
  hw = R.DesignSpace().sample_table(25, seed=2)
  return port_table(hw).cross(N_ARCHS), hw.cross(N_ARCHS)


@pytest.mark.parametrize("chunk_size", [97, 1000, 10**6])
def test_block_slices_and_indices_equal(joints, chunk_size):
  got, want = joints
  got_blocks = list(got.block_slices(chunk_size))
  want_blocks = list(want.block_slices(chunk_size))
  assert got_blocks == want_blocks
  for a_sl, h_sl in want_blocks:
    np.testing.assert_array_equal(got.block_indices(a_sl, h_sl),
                                  want.block_indices(a_sl, h_sl))
  every = np.concatenate([got.block_indices(a, h) for a, h in got_blocks])
  np.testing.assert_array_equal(np.sort(every), np.arange(len(got)))


def test_joint_table_rows_equal(joints):
  got, want = joints
  assert isinstance(got, JointTable)
  assert (len(got), got.n_hw, got.pe_type_names) == \
      (len(want), want.n_hw, want.pe_type_names)
  np.testing.assert_array_equal(got.arch_ids(), want.arch_ids())
  np.testing.assert_array_equal(got.hw_indices(), want.hw_indices())
  np.testing.assert_array_equal(got.pe_type_strings(),
                                want.pe_type_strings())
  for i in (0, 26, len(want) - 1):
    aid, cfg = got.pair_at(i)
    assert (aid, dataclasses.astuple(cfg)) == \
        (want.pair_at(i)[0], dataclasses.astuple(want.pair_at(i)[1]))
    assert dataclasses.astuple(got.config_at(i)) == \
        dataclasses.astuple(want.config_at(i))
  with pytest.raises(IndexError):
    got.pair_at(len(got))
  for index in (np.asarray([0, 30, 299]), slice(5, 60, 7)):
    for name in COLUMNS:
      np.testing.assert_array_equal(getattr(got.select(index), name),
                                    getattr(want.select(index), name))
  for name in COLUMNS + ("pe_code",):
    np.testing.assert_array_equal(getattr(got.materialize(), name),
                                  getattr(want.materialize(), name))
  with pytest.raises(ValueError, match="positive"):
    next(got.block_slices(0))


# ---------------------------------------------------------------------------
# the frame's architecture columns
# ---------------------------------------------------------------------------

def _coded(lookup, ids, top1):
  n = len(ids)
  z = np.arange(1.0, n + 1.0)
  return P.ResultFrame(z, z, z, np.asarray(["INT16"] * n), (), "coexplore",
                       extra={"arch_id": np.asarray(ids),
                              "top1": np.asarray(top1)},
                       arch_lookup=tuple(lookup))


def test_concat_remaps_arch_ids_like_the_reference():
  a, b, c = (cnn.ArchChoice(((1, 40),)), cnn.ArchChoice(((2, 48),)),
             cnn.ArchChoice(((1, 56),)))
  ra, rb, rc = (ref_cnn.ArchChoice(x.stages) for x in (a, b, c))
  parts = [([a, b], [1, 0, 1], [0.6, 0.7, 0.6]), ([c, a], [0, 1], [0.8, 0.6])]
  got = P.ResultFrame.concat([_coded(*p) for p in parts])
  ref_parts = [([ra, rb], [1, 0, 1], [0.6, 0.7, 0.6]),
               ([rc, ra], [0, 1], [0.8, 0.6])]
  want = R.ResultFrame.concat([
      R.ResultFrame(np.arange(1.0, len(i) + 1.0), np.arange(1.0, len(i) + 1),
                    np.arange(1.0, len(i) + 1), np.asarray(["INT16"] * len(i)),
                    (), "coexplore", extra={"arch_id": np.asarray(i),
                                            "top1": np.asarray(t)},
                    arch_lookup=tuple(lu))
      for lu, i, t in ref_parts])
  assert_same_frames(got, want)
  assert [got.arch_at(i).stages for i in range(len(got))] == \
      [want.arch_at(i).stages for i in range(len(want))]
  np.testing.assert_array_equal(got.column("top1_err"),
                                want.column("top1_err"))
  sub = got.select(np.asarray([4, 0]))
  assert sub.arch_at(0) == a and sub.extra["arch_id"].tolist() == [0, 1]
  with pytest.raises(ValueError, match="out of range"):
    _coded([a], [1], [0.5])
  with pytest.raises(ValueError, match="without an 'arch_id'"):
    P.ResultFrame(np.ones(1), np.ones(1), np.ones(1), np.asarray(["FP32"]),
                  arch_lookup=(a,))
  with pytest.raises(ValueError, match="not a co-exploration"):
    P.ResultFrame(np.ones(1), np.ones(1), np.ones(1),
                  np.asarray(["FP32"])).arch_at(0)
  with pytest.raises(ValueError, match="mismatched extra"):
    P.ResultFrame.concat([_coded(*parts[0]), P.ResultFrame(
        np.ones(1), np.ones(1), np.ones(1), np.asarray(["FP32"]))])


# ---------------------------------------------------------------------------
# session.co_explore: one-shot, nested loop, streamed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vectorized", [True, False])
def test_session_co_explore_equal(backend, arch_accs, ref_arch_accs,
                                  vectorized):
  want = R.ExplorationSession(R.VectorOracleBackend(), R.DesignSpace()) \
      .co_explore(ref_arch_accs, n_hw_per_type=N_HW, seed=3,
                  image_size=IMAGE, vectorized=vectorized)
  got = P.ExplorationSession(backend, P.DesignSpace()).co_explore(
      arch_accs, n_hw_per_type=N_HW, seed=3, image_size=IMAGE,
      vectorized=vectorized)
  assert len(got) == N_ARCHS * N_HW * 4
  assert_same_frames(got, want, f"vectorized={vectorized}")
  for i in (0, 481, len(want) - 1):
    assert dataclasses.astuple(got.config_at(i)) == \
        dataclasses.astuple(want.config_at(i))
    assert got.arch_at(i).stages == want.arch_at(i).stages
  np.testing.assert_array_equal(got.pareto(JOINT3), want.pareto(JOINT3))


def test_session_auto_routes_like_the_reference(backend, arch_accs,
                                                ref_arch_accs, monkeypatch):
  session = P.ExplorationSession(backend, P.DesignSpace())
  one_shot = session.co_explore(arch_accs, n_hw_per_type=N_HW, seed=3,
                                image_size=IMAGE)
  want = R.ExplorationSession(R.VectorOracleBackend(), R.DesignSpace()) \
      .co_explore(ref_arch_accs, n_hw_per_type=N_HW, seed=3,
                  image_size=IMAGE, vectorized=True)
  assert_same_frames(one_shot, want, "auto")
  assert "streamed" not in one_shot.meta
  monkeypatch.setattr(session_mod, "STREAM_AUTO_MIN_ROWS", 1000)
  streamed = session.co_explore(arch_accs, n_hw_per_type=N_HW, seed=3,
                                image_size=IMAGE, chunk_size=97)
  assert streamed.meta["streamed"] == 1.0
  assert_same_frames(streamed, want, "auto-streamed")


def test_session_co_explore_refusals(backend, arch_accs, tmp_path):
  session = P.ExplorationSession(backend, P.DesignSpace())
  # workers, store and pool (ported with slice 6) run, with the fronts
  # of the stream without them
  kw = dict(n_hw_per_type=N_HW, seed=3, image_size=IMAGE, stream=True,
            chunk_size=97)
  want = session.co_explore(arch_accs, workers=1, **kw)
  for kwargs in ({"workers": 2}, {"store": P.ResultStore(tmp_path)},
                 {"pool": P.DevicePool(devices=["cpu"] * 2)}):
    got = session.co_explore(arch_accs, **kwargs, **kw)
    assert_same_frames(got["pareto"], want["pareto"], str(kwargs))
    # store and pool are refused outside the stream, as in the reference
    if "workers" not in kwargs:
      with pytest.raises(ValueError, match="stream=True"):
        session.co_explore(arch_accs, **kwargs)
  with pytest.raises(ValueError, match="stream=True"):
    session.co_explore(arch_accs, reducers=PS.default_co_reducers())
  # policy and resume_from (ported with slice 5b) apply to the stream
  for kwargs in ({"policy": object()}, {"resume_from": "x"}):
    with pytest.raises(ValueError, match="stream=True"):
      session.co_explore(arch_accs, **kwargs)
  plain = P.ExplorationSession(P.OracleBackend(), P.DesignSpace())
  with pytest.raises(ValueError, match="co_evaluate_table"):
    plain.co_explore(arch_accs, vectorized=True)
  with pytest.raises(ValueError, match="co_evaluate_table"):
    plain.co_explore(arch_accs, stream=True)


def co_reducers(m, top_k=17):
  """The joint front, a latency/energy/area front (K1's branch), Fig.
  12's (top1_err, energy) front, top-k, stats and a histogram of the
  per-arch accuracy column."""
  return {"pareto": m.ParetoAccumulator(JOINT3),
          "pareto3": m.ParetoAccumulator(COLS3),
          "fig12": m.ParetoAccumulator(("top1_err", "energy_mj")),
          "top": m.TopKAccumulator(top_k, by="energy_mj"),
          "stats": m.StatsAccumulator("energy_mj"),
          "hist": m.HistogramAccumulator("top1_err", 0.0, 0.5, bins=16)}


def assert_same_co_streams(got_red, got, want_red, want):
  for name in ("pareto", "pareto3", "fig12", "top"):
    assert_same_frames(got[name], want[name], name)
    np.testing.assert_array_equal(got_red[name].indices,
                                  want_red[name].indices, err_msg=name)
  np.testing.assert_array_equal(got["hist"]["counts"], want["hist"]["counts"])
  for k, v in want["stats"].items():
    assert got["stats"][k] == pytest.approx(v, rel=1e-12), k
  assert got.n_rows == want.n_rows == N_ARCHS * N_HW * 4


def _ref_stream(ref_arch_accs, chunk_size):
  want_red = co_reducers(RS)
  want = RS.stream_co_explore(R.VectorOracleBackend(), R.DesignSpace(),
                              ref_arch_accs, n_hw_per_type=N_HW, seed=3,
                              image_size=IMAGE, reducers=want_red,
                              chunk_size=chunk_size, workers=1)
  return want_red, want


@pytest.mark.parametrize("chunk_size", [97, 1000, 10**6])
def test_stream_co_explore_matches_reference(backend, arch_accs,
                                             ref_arch_accs, chunk_size):
  want_red, want = _ref_stream(ref_arch_accs, chunk_size)
  got_red = co_reducers(PS)
  got = PS.stream_co_explore(backend, P.DesignSpace(), arch_accs,
                             n_hw_per_type=N_HW, seed=3, image_size=IMAGE,
                             reducers=got_red, chunk_size=chunk_size)
  assert_same_co_streams(got_red, got, want_red, want)
  assert got.meta["n_chunks"] == want.meta["n_chunks"]
  assert got.meta["rows_transferred"] < got.n_rows  # O(survivors)
  assert got.meta["n_overflows"] == 0


def test_stream_co_explore_overflow_falls_back_exactly(
    backend, arch_accs, ref_arch_accs, monkeypatch):
  monkeypatch.setattr(device_lib, "build_plan",
                      functools.partial(device_lib.build_plan, cap=8))
  want_red, want = _ref_stream(ref_arch_accs, 1000)
  got_red = co_reducers(PS)
  got = PS.stream_co_explore(backend, P.DesignSpace(), arch_accs,
                             n_hw_per_type=N_HW, seed=3, image_size=IMAGE,
                             reducers=got_red, chunk_size=1000)
  assert got.meta["n_overflows"] > 0
  assert_same_co_streams(got_red, got, want_red, want)


def test_session_stream_equals_one_shot_fronts(backend, arch_accs):
  session = P.ExplorationSession(backend, P.DesignSpace())
  frame = session.co_explore(arch_accs, n_hw_per_type=N_HW, seed=3,
                             image_size=IMAGE)
  res = session.co_explore(arch_accs, n_hw_per_type=N_HW, seed=3,
                           image_size=IMAGE, stream=True, chunk_size=977)
  assert list(res.results) == ["pareto"]  # the default joint front
  assert_same_frames(res["pareto"], frame.select(frame.pareto(JOINT3)))


def test_grouped_prefilter_branches(backend, arch_accs, monkeypatch):
  """Two varying objectives take the staircase; three (K1) see the
  flattened block with every column of the spec; arch-constant
  objectives alone keep every row."""
  calls = []
  from repro_torch.kernels.pareto_front import ops
  real = ops.block_prefilter_mask

  def spy(obj, block=128):
    calls.append(tuple(obj.shape))
    return real(obj, block)

  monkeypatch.setattr(ops, "block_prefilter_mask", spy)
  kernel.reset_launch_counts()
  red = {"pareto": PS.ParetoAccumulator(JOINT3)}
  PS.stream_co_explore(backend, P.DesignSpace(), arch_accs,
                       n_hw_per_type=N_HW, seed=3, image_size=IMAGE,
                       reducers=red, chunk_size=200)
  assert calls == []
  four = ("top1_err",) + COLS3
  res = PS.stream_co_explore(backend, P.DesignSpace(), arch_accs,
                             n_hw_per_type=N_HW, seed=3, image_size=IMAGE,
                             reducers={"p4": PS.ParetoAccumulator(four)},
                             chunk_size=200)
  assert len(calls) == res.meta["n_chunks"]
  assert all(d == 4 for _, d in calls)
  assert sum(n for n, _ in calls) == res.n_rows
  assert kernel.LAUNCHES["block_dominance_counts"] == 0  # CPU: plain version
  cols = {"top1": torch.full((2, 3), 0.7), "latency_s": torch.ones(2, 3)}
  spec = device_lib.ParetoSpec(("top1",), ("top1",))
  assert device_lib._pareto_prefilter(cols, spec, grouped=True).all()


def test_joint_plans_and_ladders(backend, arch_accs):
  red = co_reducers(PS)
  assert device_lib.build_plan(red, joint=False) is None  # top1_err
  plan = device_lib.build_plan(red, joint=True)
  assert [name for name, _ in plan] == list(red)
  tasks = list(PS.co_explore_tasks(backend, P.DesignSpace(), arch_accs,
                                   n_hw_per_type=5, seed=3, image_size=IMAGE,
                                   method="random", chunk_size=16,
                                   reducers=red))
  assert [r.name for r in tasks[0].rungs] == ["fused-device", "device"]
  assert [t.index for t in tasks] == list(range(len(tasks)))
  frame, idx = tasks[1].rungs[1].fn().resolve()
  assert len(frame) == len(idx) and frame.arch_lookup == \
      tuple(a for a, _ in arch_accs)
  with pytest.raises(ValueError, match="co_evaluate_table"):
    list(PS.co_explore_tasks(P.OracleBackend(), P.DesignSpace(), arch_accs,
                             5, 3, IMAGE, "random", 16, red))


def test_backend_co_evaluate_table_equal(backend, stacks):
  got_stack, want_stack = stacks
  hw = R.DesignSpace().sample_table(N_HW, seed=19)
  want = R.VectorOracleBackend(chunk_size=97).co_evaluate_table(hw,
                                                                want_stack)
  got = P.TorchOracleBackend(chunk_size=97, device="cpu").co_evaluate_table(
      port_table(hw), got_stack)
  assert_same_frames(got, want)
  assert isinstance(got.table, JointTable)


# ---------------------------------------------------------------------------
# the polynomial joint path and the coexplore shim
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def poly(tmp_path_factory):
  """The reference's fit, carried into the port through its .npz."""
  from repro.core.workloads import get_network
  ref = R.PolynomialBackend.fit(layers=get_network("resnet20")[:5],
                                **POLY_FIT)
  path = str(tmp_path_factory.mktemp("poly") / "models.npz")
  ref.save(path)
  return P.PolynomialBackend.load(path, device="cpu"), ref


def assert_pairs_within_bound(got, want, models, layer_lists):
  """Arch-major joint rows, each arch's held to the per-row bound of its
  one-network prediction (``Bounds``)."""
  n_hw = len(want) // len(layer_lists)
  for a, layers in enumerate(layer_lists):
    rows = np.arange(a * n_hw, (a + 1) * n_hw)
    want_a, got_a = want.select(rows), got.select(rows)
    cfgs = [want.config_at(i) for i in rows]
    Bounds.of(models, cfgs, layers, want_a).check(got_a, want_a)


def test_poly_co_evaluate_table_within_bound(poly, stacks):
  port, ref = poly
  got_stack, want_stack = stacks
  hw = R.DesignSpace().sample_table(30, seed=29)
  want = ref.co_evaluate_table(hw, want_stack)
  got = port.co_evaluate_table(port_table(hw), got_stack, chunk_size=40)
  np.testing.assert_array_equal(got.extra["arch_id"], want.extra["arch_id"])
  np.testing.assert_array_equal(got.pe_type, want.pe_type)
  assert_pairs_within_bound(
      got, want, ref.models,
      [want_stack.layers_of(a) for a in range(N_ARCHS)])
  whole = port.co_evaluate_table(port_table(hw), got_stack)
  for col in METRICS:  # the chunking moves no bit
    np.testing.assert_array_equal(whole.column(col), got.column(col))


def test_poly_session_co_explore_within_bound(poly, arch_accs, ref_arch_accs):
  port, ref = poly
  want = R.ExplorationSession(ref, R.DesignSpace()).co_explore(
      ref_arch_accs, n_hw_per_type=10, seed=3, image_size=IMAGE,
      vectorized=True)
  got = P.ExplorationSession(port, P.DesignSpace()).co_explore(
      arch_accs, n_hw_per_type=10, seed=3, image_size=IMAGE,
      vectorized=True)
  np.testing.assert_array_equal(got.extra["top1"], want.extra["top1"])
  layer_lists = [ref_arch_to_layers(a, image_size=IMAGE)
                 for a, _ in ref_arch_accs]
  for t in range(4):  # each PE type's block of the concat
    rows = np.arange(t * N_ARCHS * 10, (t + 1) * N_ARCHS * 10)
    assert_pairs_within_bound(got.select(rows), want.select(rows),
                              ref.models, layer_lists)
  res = P.ExplorationSession(port, P.DesignSpace()).co_explore(
      arch_accs, n_hw_per_type=10, seed=3, image_size=IMAGE, stream=True,
      chunk_size=50)
  np.testing.assert_array_equal(
      res["pareto"].column("latency_s"),
      got.select(got.pareto(JOINT3)).column("latency_s"))


def test_normalize_and_front_equal(backend, arch_accs, ref_arch_accs):
  frame = R.ExplorationSession(R.VectorOracleBackend(), R.DesignSpace()) \
      .co_explore(ref_arch_accs, n_hw_per_type=N_HW, seed=3,
                  image_size=IMAGE)
  ref_points, points = [], []
  for i in range(len(frame)):
    cfg, arch = frame.config_at(i), frame.arch_at(i)
    values = (float(frame.extra["top1"][i]), float(frame.latency_s[i]),
              float(frame.power_mw[i]), float(frame.area_mm2[i]))
    ref_points.append(ref_coexplore.CoPoint(cfg, arch, *values))
    points.append(coexplore.CoPoint(
        PortConfig(*dataclasses.astuple(cfg)),
        cnn.ArchChoice(arch.stages), *values))
  want = ref_coexplore.normalize_and_front(ref_points)
  got = coexplore.normalize_and_front(points)
  assert set(got) == set(want)
  for key in want:
    np.testing.assert_array_equal(got[key], want[key], err_msg=key)
  assert 0 < want["front_energy"].sum() < len(frame)
  assert points[7].energy_mj == ref_points[7].energy_mj
  assert points[7].top1_err == ref_points[7].top1_err


def test_coexplore_shim_within_bound(poly, arch_accs, ref_arch_accs):
  port, ref = poly
  want = ref_coexplore.co_explore(ref.models, ref_arch_accs[:4],
                                  n_hw_per_type=6, seed=3, image_size=IMAGE)
  got = coexplore.co_explore(port.models, arch_accs[:4], n_hw_per_type=6,
                             seed=3, image_size=IMAGE, device="cpu")
  assert len(got) == len(want) == 4 * 6 * 4
  for g, w in zip(got, want):
    assert dataclasses.astuple(g.cfg) == dataclasses.astuple(w.cfg)
    assert (g.arch.stages, g.top1) == (w.arch.stages, w.top1)

  def as_frame(pts, m):
    return m.ResultFrame([p.latency_s for p in pts],
                         [p.power_mw for p in pts],
                         [p.area_mm2 for p in pts],
                         [p.cfg.pe_type for p in pts],
                         tuple(p.cfg for p in pts))

  layer_lists = [ref_arch_to_layers(a, image_size=IMAGE)
                 for a, _ in ref_arch_accs[:4]]
  for t in range(4):  # per PE type: 4 archs x 6 HW, arch-major
    rows = range(t * 24, (t + 1) * 24)
    assert_pairs_within_bound(as_frame([got[i] for i in rows], P),
                              as_frame([want[i] for i in rows], R),
                              ref.models, layer_lists)


def test_co_explore_entry_points_default_to_cuda(poly, arch_accs,
                                                  monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  port, _ = poly
  with pytest.raises(RuntimeError, match="no CUDA device"):
    coexplore.co_explore(port.models, arch_accs[:1], n_hw_per_type=1)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    P.PolynomialBackend(port.models)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    P.ExplorationSession(P.TorchOracleBackend()).co_explore(arch_accs[:1])


def test_new_modules_import_neither_jax_nor_the_reference():
  names = {"cnn.py", "supernet.py", "coexplore.py"}
  new = [p for p in PORT_FILES
         if p.name in names and p.parent.name == "core"]
  assert len(new) == 3
  for path in new:
    assert not [m for m in _imported_modules(path) if _forbidden(m)], path
