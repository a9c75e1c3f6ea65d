"""The port's result store, its keys and its delta sweeps against the JAX
package's, on the CPU.

Case for case with ``tests/test_service.py``'s store, journal-log and
delta-sweep tests where the case ports: atomic sha256-framed entries,
quarantine, manifests and their lock, kill-mid-append recovery, and
delta sweeps bit-identical to a from-scratch sweep whatever the
chunking.  Beyond the reference's cases: result keys equal the
reference's as hex, and entries cross packages one way (H15 in
ROADMAP.md) — an entry the reference wrote loads in the port, through a
restricted unpickler that never imports the reference, and an entry
naming any other class is quarantined as corrupt.  Fronts and top-k are
held bit for bit; stats count/min/max exactly and mean/std to a
relative 1e-12 (R3).
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import repro.explore as R
from repro.core.cnn import SEARCH_SPACE as REF_SEARCH_SPACE
from repro.core.cnn import ArchChoice as RefArch
from repro.core.workloads import get_network as ref_get_network
from repro.explore import store as RST

import repro_torch.explore as P
from repro_torch.core.cnn import ArchChoice
from repro_torch.core.ppa import HW_RANGES
from repro_torch.core.workloads import get_network
from repro_torch.explore import resilience as PR
from repro_torch.explore import store as PST
from repro_torch.explore.space import AXIS_ORDER

METRICS = ("latency_s", "power_mw", "area_mm2")
NETWORK = "resnet20"
GRID_N = 10**9  # "the whole grid", whatever its size
REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def layers():
  return get_network(NETWORK)[:4]


@pytest.fixture(scope="module")
def ref_layers():
  return ref_get_network(NETWORK)[:4]


def backend():
  return P.TorchOracleBackend(chunk_size=256, device="cpu")


def sweep_reducers(mod=P):
  return {"pareto": mod.ParetoAccumulator(("latency_s", "power_mw")),
          "top": mod.TopKAccumulator(9, by="power_mw"),
          "stats": mod.StatsAccumulator("latency_s"),
          "hist": mod.HistogramAccumulator("power_mw", 0.0, 5e4, bins=32)}


def small_grid_space(extra_on=None, mod=P):
  """A few-hundred-point grid space; ``extra_on`` grows one axis by one
  value (an in-order supersequence — the delta-sweep precondition)."""
  axes = {name: HW_RANGES[name][:2] for name in AXIS_ORDER}
  axes[AXIS_ORDER[0]] = HW_RANGES[AXIS_ORDER[0]][:3]
  if extra_on is not None:
    axes[extra_on] = HW_RANGES[extra_on][:len(axes[extra_on]) + 1]
  return mod.DesignSpace(axes=axes)


def assert_frames_equal(got, want):
  for name in ("pareto", "top"):
    for col in METRICS:
      assert np.array_equal(getattr(got[name], col),
                            getattr(want[name], col)), (name, col)


def assert_stats_equal(got, want):
  gs, ws = got["stats"], want["stats"]
  assert gs["count"] == ws["count"]
  assert gs["min"] == ws["min"] and gs["max"] == ws["max"]
  assert_allclose(gs["mean"], ws["mean"], rtol=1e-12)
  assert_allclose(gs["std"], ws["std"], rtol=1e-12)
  assert np.array_equal(got["hist"]["counts"], want["hist"]["counts"])


def grid_sweep(space, layers, chunk_size=128, **kw):
  return P.stream_explore(backend(), space, layers, network=NETWORK,
                          n_per_type=GRID_N, method="grid",
                          reducers=sweep_reducers(), chunk_size=chunk_size,
                          **kw)


# ---------------------------------------------------------------------------
# result store: atomic writes, checksums, quarantine
# ---------------------------------------------------------------------------

class TestResultStore:

  def test_roundtrip(self, tmp_path):
    store = P.ResultStore(tmp_path)
    store.put("k1", {"done": {1, 2}, "n_rows": 7})
    assert "k1" in store
    assert store.get("k1") == {"done": {1, 2}, "n_rows": 7}
    assert store.stats()["n_hits"] == 1

  def test_miss_counts(self, tmp_path):
    store = P.ResultStore(tmp_path)
    assert store.get("nope") is None
    assert store.stats() == {"n_hits": 0, "n_misses": 1,
                             "n_quarantined": 0}

  def test_no_tmp_file_left(self, tmp_path):
    store = P.ResultStore(tmp_path)
    store.put("k1", {"x": 1})
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]

  @pytest.mark.parametrize("damage", ["truncate", "flip", "garbage"])
  def test_corruption_quarantined(self, tmp_path, damage):
    store = P.ResultStore(tmp_path)
    store.put("k1", {"x": list(range(100))})
    path = store.path("k1")
    blob = open(path, "rb").read()
    if damage == "truncate":
      open(path, "wb").write(blob[:len(blob) // 2])
    elif damage == "flip":
      open(path, "wb").write(blob[:-3] + bytes([blob[-3] ^ 0xFF])
                             + blob[-2:])
    else:
      open(path, "wb").write(b"not a store entry at all")
    assert store.get("k1") is None
    assert "k1" not in store
    assert store.stats()["n_quarantined"] == 1
    assert os.listdir(store.quarantine_dir)
    store.put("k1", {"x": 1})
    assert store.get("k1") == {"x": 1}

  def test_wrong_key_payload_rejected(self, tmp_path):
    store = P.ResultStore(tmp_path)
    store.put("aaaa", {"x": 1})
    os.replace(store.path("aaaa"), store.path("bbbb"))
    assert store.get("bbbb") is None

  def test_manifest_index(self, tmp_path):
    store = P.ResultStore(tmp_path)
    store.put_final("k1", {"x": 1}, manifest={"kind": "explore", "v": 1})
    store.put_final("k2", {"x": 2}, manifest={"kind": "explore", "v": 2})
    store.put_final("k1", {"x": 3}, manifest={"kind": "explore", "v": 3})
    entries = store.manifests()
    assert [e["key"] for e in entries] == ["k1", "k2"]
    assert entries[0]["v"] == 3

  def test_compact_manifests_keeps_latest_per_key(self, tmp_path):
    store = P.ResultStore(tmp_path)
    for v in range(5):
      store.put_final("k1", {"x": v}, manifest={"v": v})
    store.put_final("k2", {"x": 9}, manifest={"v": 9})
    before = store.manifests()
    assert store.compact_manifests() == 4
    assert store.compact_manifests() == 0
    after = store.manifests()
    assert sorted((e["key"], e["v"]) for e in after) == \
        sorted((e["key"], e["v"]) for e in before)
    assert len(store.journal.replay(store.INDEX_KEY)) == 2

  def test_concurrent_writers_two_processes(self, tmp_path):
    n_each = 40
    script = textwrap.dedent("""
        import sys
        from repro_torch.explore import ResultStore
        store = ResultStore(sys.argv[1])
        who, n = sys.argv[2], int(sys.argv[3])
        for i in range(n):
            store.put_final(f"{who}-{i:04d}", {"x": i},
                            manifest={"who": who, "i": i})
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), env.get("PYTHONPATH", "")]
    ).rstrip(os.pathsep)
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(tmp_path), who, str(n_each)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for who in ("a", "b")]
    for p in procs:
      _, err = p.communicate(timeout=120)
      assert p.returncode == 0, err.decode()[-2000:]
    store = P.ResultStore(tmp_path)
    entries = store.manifests()
    assert len(entries) == 2 * n_each
    for who in ("a", "b"):
      assert sorted(e["i"] for e in entries if e["who"] == who) == \
          list(range(n_each))
    assert store.get("a-0000") == {"x": 0}
    assert store.get(f"b-{n_each - 1:04d}") == {"x": n_each - 1}

  def test_entry_layout_equals_the_reference(self, tmp_path):
    """Magic, digest framing and payload: the port writes the
    reference's bytes for the same plain state."""
    state = {"done": {3, 1}, "n_rows": 7, "arr": np.arange(5.0)}
    P.ResultStore(tmp_path / "p").put("k" * 64, state)
    R.ResultStore(tmp_path / "r").put("k" * 64, state)
    name = os.path.basename(P.ResultStore(tmp_path / "p").path("k" * 64))
    assert name == os.path.basename(R.ResultStore(tmp_path / "r")
                                    .path("k" * 64))
    assert (tmp_path / "p" / name).read_bytes() == \
        (tmp_path / "r" / name).read_bytes()


# ---------------------------------------------------------------------------
# cross-package entries (H15)
# ---------------------------------------------------------------------------

class _Foreign:
  """A class no snapshot holds."""


class TestCrossPackage:

  def test_foreign_class_entry_quarantined(self, tmp_path):
    """An entry that pickles any class outside the snapshot classes is
    refused by the restricted unpickler and quarantined, with a valid
    checksum and all."""
    store = P.ResultStore(tmp_path)
    store.put("k1", {"x": _Foreign()})
    assert store.get("k1") is None
    assert store.stats()["n_quarantined"] == 1
    assert os.listdir(store.quarantine_dir)
    store.put("k2", {"x": os.system})  # a global function is no better
    assert store.get("k2") is None

  def test_unpickler_maps_reference_classes(self):
    frame = R.ResultFrame(np.ones(2), np.ones(2), np.ones(2),
                          np.asarray(["INT8", "INT8"]))
    got = PR.load_snapshot(pickle.dumps({"f": frame, "s": {1, 2},
                                         "z": frozenset("ab")},
                                        protocol=pickle.HIGHEST_PROTOCOL))
    assert type(got["f"]) is P.ResultFrame
    assert got["s"] == {1, 2} and got["z"] == frozenset("ab")
    with pytest.raises(pickle.UnpicklingError):
      PR.load_snapshot(pickle.dumps(R.RetryPolicy(sleep=print)))

  def test_reference_entry_serves_the_port(self, tmp_path, layers,
                                           ref_layers):
    """A store the reference filled (a 3-objective front over a table
    frame, top-k, stats, histogram) is a store hit for the port, equal
    to the reference's result and to the port's own sweep."""
    kw = dict(network=NETWORK, n_per_type=150, seed=5, chunk_size=64)

    def reds(mod):
      out = sweep_reducers(mod)
      out["pareto3"] = mod.ParetoAccumulator(("latency_s", "energy_mj",
                                              "area_mm2"))
      return out

    want = R.cached_stream_explore(R.VectorOracleBackend(), R.DesignSpace(),
                                   ref_layers, reducers=reds(R), workers=1,
                                   store=str(tmp_path), **kw)
    got = P.cached_stream_explore(backend(), P.DesignSpace(), layers,
                                  reducers=reds(P), store=str(tmp_path),
                                  **kw)
    assert got.meta["store_hit"] == 1.0
    assert got.n_rows == want.n_rows
    own = P.stream_explore(backend(), P.DesignSpace(), layers,
                           reducers=reds(P), **kw)
    for res in (want, own):
      assert_frames_equal(got, res)
      for col in METRICS:
        np.testing.assert_array_equal(got["pareto3"].column(col),
                                      res["pareto3"].column(col))
      assert_stats_equal(got, res)
    assert type(got["pareto3"].table) is P.ConfigTable

  def test_reference_entry_loads_without_importing_the_reference(
      self, tmp_path, ref_layers):
    """In a fresh process the port loads the reference's co-exploration
    entry (frames with a JointTable and ArchChoice lookups) and
    ``repro`` is never imported."""
    rng = np.random.RandomState(7)
    archs = [RefArch(tuple((int(rng.choice(r)), int(rng.choice(c)))
                           for r, c in REF_SEARCH_SPACE)) for _ in range(3)]
    accs = rng.uniform(0.5, 0.95, len(archs))
    ref = R.cached_stream_co_explore(
        R.VectorOracleBackend(), R.DesignSpace(), list(zip(archs, accs)),
        n_hw_per_type=6, seed=3, image_size=16, chunk_size=32, workers=1,
        store=str(tmp_path))
    np.save(tmp_path / "want.npy", np.stack(
        [ref["pareto"].column(c) for c in METRICS]))
    np.save(tmp_path / "archs.npy", np.asarray(
        [sum(arch.stages, ()) for arch in archs]))
    np.save(tmp_path / "accs.npy", accs)
    script = textwrap.dedent("""
        import sys
        import numpy as np
        from repro_torch.core.cnn import ArchChoice
        from repro_torch.explore import (DesignSpace, ResultStore,
                                         TorchOracleBackend,
                                         cached_stream_co_explore)
        d = sys.argv[1]
        flat = np.load(d + "/archs.npy")
        archs = [ArchChoice(tuple((int(r[2 * i]), int(r[2 * i + 1]))
                                  for i in range(len(r) // 2)))
                 for r in flat]
        accs = np.load(d + "/accs.npy")
        res = cached_stream_co_explore(
            TorchOracleBackend(device="cpu"), DesignSpace(),
            list(zip(archs, accs)), n_hw_per_type=6, seed=3, image_size=16,
            chunk_size=32, store=ResultStore(d))
        assert res.meta["store_hit"] == 1.0, res.meta
        want = np.load(d + "/want.npy")
        cols = ("latency_s", "power_mw", "area_mm2")
        got = np.stack([res["pareto"].column(c) for c in cols])
        assert np.array_equal(got, want)
        front = res["pareto"]
        assert type(front.table).__module__ == "repro_torch.core.table"
        assert all(type(a).__module__ == "repro_torch.core.cnn"
                   for a in front.arch_lookup)
        assert "repro" not in sys.modules, sorted(
            m for m in sys.modules if m.split(".")[0] == "repro")
        print("H15-OK", len(front))
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "H15-OK" in proc.stdout


# ---------------------------------------------------------------------------
# result keys: equal to the reference's as hex
# ---------------------------------------------------------------------------

class TestKeys:

  @pytest.mark.parametrize("method,n,seed", [
      ("random", 200, 17), ("grid", GRID_N, 4), ("grid", 50, 9),
      ("stratified", 33, 2)])
  def test_explore_result_key_equals_the_reference(self, method, n, seed):
    for extra in (None, AXIS_ORDER[3]):
      got = PST.explore_result_key(
          small_grid_space(extra, P), sweep_reducers(P), network=NETWORK,
          n_per_type=n, seed=seed, method=method)
      want = RST.explore_result_key(
          small_grid_space(extra, R), sweep_reducers(R), network=NETWORK,
          n_per_type=n, seed=seed, method=method)
      assert got == want

  def test_co_explore_result_key_equals_the_reference(self):
    rng = np.random.RandomState(1)
    plans = [tuple((int(rng.choice(r)), int(rng.choice(c)))
                   for r, c in REF_SEARCH_SPACE) for _ in range(4)]
    accs = rng.uniform(0.5, 0.95, 4)
    kw = dict(n_hw_per_type=20, seed=3, image_size=16, method="random")
    got = PST.co_explore_result_key(
        P.DesignSpace(), {"pareto": P.ParetoAccumulator(
            ("top1_err", "energy_mj", "area_mm2"))},
        list(zip([ArchChoice(p) for p in plans], accs)), **kw)
    want = RST.co_explore_result_key(
        R.DesignSpace(), {"pareto": R.ParetoAccumulator(
            ("top1_err", "energy_mj", "area_mm2"))},
        list(zip([RefArch(p) for p in plans], accs)), **kw)
    assert got == want

  def test_delta_journal_key_and_manifest_equal_the_reference(self):
    space_p = small_grid_space(AXIS_ORDER[2], P)
    space_r = small_grid_space(AXIS_ORDER[2], R)
    rfp = PR.reducers_fingerprint(sweep_reducers(P))
    assert rfp == R.resilience.reducers_fingerprint(sweep_reducers(R))
    assert PST.delta_sweep_key(space_p, rfp, "b" * 64, NETWORK) == \
        R.sweep_key("explore-delta",
                    R.resilience.space_fingerprint(space_r), rfp,
                    {"base": "b" * 64, "network": NETWORK})
    assert PST._explore_manifest(space_p, NETWORK, "grid", rfp, True) == \
        RST._explore_manifest(space_r, NETWORK, "grid", rfp, True)


# ---------------------------------------------------------------------------
# append-log journal: kill-mid-append recovery
# ---------------------------------------------------------------------------

def _state(n):
  return {"done": set(range(n)), "reducers": {}, "counters": {"n_rows": n}}


class TestJournalLog:

  def test_append_replay_roundtrip(self, tmp_path):
    j = P.SweepJournal(tmp_path)
    for n in (1, 2, 3):
      j.append("k", _state(n))
    states = j.replay("k")
    assert [len(s["done"]) for s in states] == [1, 2, 3]
    assert j.load_last("k")["counters"]["n_rows"] == 3

  def test_kill_mid_append_recovers_prefix(self, tmp_path):
    j = P.SweepJournal(tmp_path)
    j.append("k", _state(1))
    j.append("k", _state(2))
    intact = os.path.getsize(j.log_path("k"))
    with open(j.log_path("k"), "ab") as f:
      f.write(b"SWPJ" + b"\x99")
    states = j.replay("k")
    assert [len(s["done"]) for s in states] == [1, 2]
    assert os.path.getsize(j.log_path("k")) == intact
    j.append("k", _state(3))
    assert len(j.replay("k")) == 3

  @pytest.mark.parametrize("tear", ["payload", "digest", "garbage"])
  def test_torn_tail_variants(self, tmp_path, tear):
    j = P.SweepJournal(tmp_path)
    j.append("k", _state(1))
    good = open(j.log_path("k"), "rb").read()
    if tear == "payload":
      torn = good + good[:len(good) - 5]
    elif tear == "digest":
      bad = bytearray(good)
      bad[len(b"SWPJ") + 8] ^= 0xFF
      torn = good + bytes(bad)
    else:
      torn = good + b"\x00" * 7
    open(j.log_path("k"), "wb").write(torn)
    assert len(j.replay("k")) == 1
    assert os.path.getsize(j.log_path("k")) == len(good)

  def test_corruption_mid_log_drops_suffix(self, tmp_path):
    j = P.SweepJournal(tmp_path)
    for n in (1, 2, 3):
      j.append("k", _state(n))
    blob = bytearray(open(j.log_path("k"), "rb").read())
    blob[len(blob) // 3] ^= 0xFF
    open(j.log_path("k"), "wb").write(bytes(blob))
    assert 0 < len(j.replay("k")) < 3

  def test_load_state_prefers_more_progress(self, tmp_path):
    j = P.SweepJournal(tmp_path)
    j.record("k", _state(5))
    j.append("k", _state(2))
    assert len(j.load_state("k")["done"]) == 5
    j.append("k", _state(9))
    assert len(j.load_state("k")["done"]) == 9

  def test_reference_log_replays_in_the_port(self, tmp_path):
    """The reference's append log (and snapshot record) load in the port
    through the restricted unpickler."""
    rj = R.SweepJournal(tmp_path)
    for n in (1, 4):
      rj.append("k", _state(n))
    rj.record("k", _state(3))
    pj = P.SweepJournal(tmp_path)
    assert [len(s["done"]) for s in pj.replay("k")] == [1, 4]
    assert len(pj.load_state("k")["done"]) == 4


# ---------------------------------------------------------------------------
# delta sweeps: one-axis edits evaluate only the new subgrid
# ---------------------------------------------------------------------------

class TestDeltaSweep:

  @pytest.mark.parametrize("axis,chunks", [
      (AXIS_ORDER[1], (128, 64, 256)),
      (AXIS_ORDER[4], (96, 128, 32)),
      (AXIS_ORDER[6], (64, 32, 128)),
  ])
  def test_delta_bit_identical_across_partitions(self, layers, ref_layers,
                                                 tmp_path, axis, chunks):
    """base + delta over the new subgrid == from scratch over the edited
    space (and the reference's scratch sweep), however each was
    chunked."""
    c_base, c_delta, c_scratch = chunks
    base, edited = small_grid_space(), small_grid_space(extra_on=axis)
    store = P.ResultStore(tmp_path)
    kw = dict(network=NETWORK, n_per_type=GRID_N, method="grid")
    P.cached_stream_explore(backend(), base, layers, reducers=sweep_reducers(),
                            chunk_size=c_base, store=store, **kw)
    res = P.cached_stream_explore(backend(), edited, layers,
                                  reducers=sweep_reducers(),
                                  chunk_size=c_delta, store=store, **kw)
    assert res.meta["delta_sweep"] == 1.0
    assert res.meta["n_delta_rows"] < res.n_rows
    scratch = grid_sweep(edited, layers, chunk_size=c_scratch)
    ref = R.stream_explore(R.VectorOracleBackend(), small_grid_space(
        extra_on=axis, mod=R), ref_layers, reducers=sweep_reducers(R),
        chunk_size=c_scratch, workers=1, **kw)
    for want in (scratch, ref):
      assert res.n_rows == want.n_rows
      assert_frames_equal(res, want)
      assert_stats_equal(res, want)

  def test_delta_result_is_stored_and_chains(self, layers, tmp_path):
    a1, a2 = AXIS_ORDER[1], AXIS_ORDER[5]
    base = small_grid_space()
    edited1 = small_grid_space(extra_on=a1)
    axes2 = {a.name: a.values for a in edited1.axes}
    axes2[a2] = tuple(HW_RANGES[a2][:len(axes2[a2]) + 1])
    edited2 = P.DesignSpace(axes=axes2)
    store = P.ResultStore(tmp_path)
    kw = dict(network=NETWORK, n_per_type=GRID_N, method="grid",
              chunk_size=128, store=store)
    for space in (base, edited1):
      P.cached_stream_explore(backend(), space, layers,
                              reducers=sweep_reducers(), **kw)
    res = P.cached_stream_explore(backend(), edited2, layers,
                                  reducers=sweep_reducers(), **kw)
    assert res.meta["delta_sweep"] == 1.0
    scratch = grid_sweep(edited2, layers)
    assert_frames_equal(res, scratch)
    assert_stats_equal(res, scratch)

  def test_corrupt_base_falls_back_to_full_sweep(self, layers, tmp_path):
    axis = AXIS_ORDER[1]
    base, edited = small_grid_space(), small_grid_space(extra_on=axis)
    store = P.ResultStore(tmp_path)
    kw = dict(network=NETWORK, n_per_type=GRID_N, method="grid",
              chunk_size=128, store=store)
    P.cached_stream_explore(backend(), base, layers,
                            reducers=sweep_reducers(), **kw)
    for name in os.listdir(tmp_path):
      if name.startswith("result-"):
        open(os.path.join(tmp_path, name), "wb").write(b"rot")
    res = P.cached_stream_explore(backend(), edited, layers,
                                  reducers=sweep_reducers(), **kw)
    assert "delta_sweep" not in res.meta
    assert_frames_equal(res, grid_sweep(edited, layers))

  def test_unrelated_spaces_do_not_delta(self, layers, tmp_path):
    base = small_grid_space()
    edited = small_grid_space(extra_on=AXIS_ORDER[1])
    axes = {a.name: a.values for a in edited.axes}
    axes[AXIS_ORDER[2]] = tuple(HW_RANGES[AXIS_ORDER[2]][:3])
    both = P.DesignSpace(axes=axes)
    store = P.ResultStore(tmp_path)
    kw = dict(network=NETWORK, n_per_type=GRID_N, method="grid",
              chunk_size=128, store=store)
    P.cached_stream_explore(backend(), base, layers,
                            reducers=sweep_reducers(), **kw)
    res = P.cached_stream_explore(backend(), both, layers,
                                  reducers=sweep_reducers(), **kw)
    assert "delta_sweep" not in res.meta

  def test_cached_driver_and_session_wiring(self, layers, tmp_path):
    axis = AXIS_ORDER[1]
    base, edited = small_grid_space(), small_grid_space(extra_on=axis)
    store = P.ResultStore(tmp_path)
    r1 = P.cached_stream_explore(backend(), base, layers, network=NETWORK,
                                 n_per_type=GRID_N, method="grid",
                                 reducers=sweep_reducers(), chunk_size=128,
                                 workers=2, store=store)
    assert r1.meta.get("store_hit") != 1.0
    sess = P.ExplorationSession(backend(), edited)
    r2 = sess.explore(layers, NETWORK, n_per_type=GRID_N, method="grid",
                      stream=True, reducers=sweep_reducers(),
                      chunk_size=96, store=store)
    assert r2.meta["delta_sweep"] == 1.0
    scratch = grid_sweep(edited, layers)
    assert_frames_equal(r2, scratch)
    assert_stats_equal(r2, scratch)
    r3 = sess.explore(layers, NETWORK, n_per_type=GRID_N, method="grid",
                      stream=True, reducers=sweep_reducers(),
                      chunk_size=96, store=store)
    assert r3.meta["store_hit"] == 1.0
    assert_frames_equal(r3, scratch)

  def test_store_requires_stream(self, layers, tmp_path):
    sess = P.ExplorationSession(backend())
    with pytest.raises(ValueError, match="stream=True"):
      sess.explore(layers, NETWORK, store=P.ResultStore(tmp_path))

  def test_delta_through_a_pool_and_workers(self, layers, tmp_path):
    """A delta sweep sharded over a pool of CPU slots, and one on four
    worker threads, equal the scratch sweep bit for bit."""
    axis = AXIS_ORDER[4]
    base, edited = small_grid_space(), small_grid_space(extra_on=axis)
    scratch = grid_sweep(edited, layers, workers=1)
    for i, kw in enumerate(({"pool": P.DevicePool(devices=["cpu"] * 3)},
                            {"workers": 4})):
      store = P.ResultStore(tmp_path / str(i))
      for space in (base, edited):
        res = P.cached_stream_explore(
            backend(), space, layers, network=NETWORK, n_per_type=GRID_N,
            method="grid", reducers=sweep_reducers(), chunk_size=64,
            store=store, **kw)
      assert res.meta["delta_sweep"] == 1.0
      assert_frames_equal(res, scratch)
      assert_stats_equal(res, scratch)
