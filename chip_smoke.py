#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's design-space sweep on one CUDA card.

Run from the root of a checkout on a machine with an H100 (or another
sm_90a card), the CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch`` (into ``build/``),
checks exact float64 arithmetic on the card, holds each kernel against
its plain torch version at the sweep's shapes and times both, runs the
paper's full design space at 1,000,000 designs through
``ExplorationSession(TorchOracleBackend()).explore(..., stream=True)``
and checks that sweep against the same code on the CPU.  Any failure
raises, so the exit code is non-zero; without a CUDA device, or without
the package beside it, the script stops before printing any result.
The last line of its output is one JSON object naming the device.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet: HBM3 bandwidth and the FP64 (non-tensor-core)
# rate; a float64 compare is counted as one FP64 operation
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP64_PER_S = 34e12

K1_SHAPE = (3, 65536, 128)  # D, N (one sweep chunk), block
K2_SHAPE = (3, 4096)        # D, N (the survivor cap)
SWEEP_PER_TYPE = 250_000    # x 4 paper PE types = 1,000,000 designs
SWEEP_CHUNK = 65536


def log(msg: str = "") -> None:
  print(msg, flush=True)


def cuda_ms(fn, samples: int = 25, inner: int = 10, warmup: int = 3) -> float:
  """Median device time of one ``fn()`` call, from CUDA events around
  ``inner`` back-to-back calls (so host launch overhead overlaps)."""
  import torch
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(samples):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(inner):
      fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end) / inner)
  return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float):
  t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
  t_ops = n_ops / PEAK_FP64_PER_S * 1e3
  return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def planted_objectives(d: int, n: int, seed: int):
  """Seeded float64 objectives with planted exact ties and duplicates."""
  import numpy as np
  rng = np.random.RandomState(seed)
  obj = rng.uniform(size=(n, d))
  obj[rng.randint(0, n, n // 8), 0] = 0.5           # ties on one axis
  dup = rng.randint(0, n, (n // 16, 2))
  obj[dup[:, 0]] = obj[dup[:, 1]]                    # duplicated points
  rows = rng.randint(0, n, n // 32)
  obj[rows] = np.round(obj[rows], 2)                 # coarse grid: more ties
  return obj


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_setup():
  import torch
  from repro_torch import _build
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
      f"python {sys.version.split()[0]}")
  log(f"[setup] card {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")
  t0 = time.perf_counter()
  built = _build.build_all()
  log(f"[build] {len(built)} source(s) compiled in "
      f"{time.perf_counter() - t0:.2f} s: {sorted(built)}")
  for line in _build.build_log("pareto_front").splitlines():
    if "registers" in line or "spill" in line or "Compiling" in line:
      log(f"[build] {line.strip()}")
  return smi


def phase_probe():
  from repro_torch.explore import device as device_lib
  report = device_lib.ensure_exact("cuda")
  for name, ok in report["checks"].items():
    log(f"[probe] {name}: {'exact' if ok else 'NOT EXACT'}")
  for name, count in report["raw_mismatches"].items():
    log(f"[probe] avoided form {name}: {count} mismatches vs numpy")
  return report


def phase_kernels():
  """Each kernel vs its plain version on the card, at the sweep's shapes."""
  import torch
  from repro_torch.kernels.pareto_front import kernel, ops, ref
  results = {}
  d, n, block = K1_SHAPE
  obj = torch.from_numpy(planted_objectives(d, n, seed=1)).cuda()
  obj_t = ops._pad_feature_major(obj, block)
  got = kernel.block_dominance_counts(obj_t, block)
  want = ref.block_dominance_counts_ref(obj_t.T, block)
  torch.cuda.synchronize()
  err = int((got.long() - want.long()).abs().max())
  if err:
    raise AssertionError(f"K1 counts differ from the plain version: {err}")
  ms = cuda_ms(lambda: kernel.block_dominance_counts(obj_t, block))
  plain_ms = cuda_ms(lambda: ref.block_dominance_counts_ref(obj_t.T, block))
  b_ms, b_by = bound_ms(d * n * 8 + n * 4, n * block * 2 * d)
  results["block_dominance_counts"] = dict(
      name="block_dominance_counts (K1)", route="cuda",
      source="src/repro_torch/kernels/pareto_front/csrc/pareto_front.cu",
      replaces="src/repro/kernels/pareto_front/kernel.py:97",
      on_main_path=True, max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
      bound_ms=b_ms, bound_by=b_by, library_ms=None)
  log(f"[K1] D={d} N={n} block={block}: counts equal "
      f"({int((got == 0).sum())} block survivors); kernel {ms:.4f} ms, "
      f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

  d, n = K2_SHAPE
  obj = torch.from_numpy(planted_objectives(d, n, seed=2)).cuda()
  obj_t = ops._pad_feature_major(obj, kernel.PAIR_TILE)
  got = kernel.dominance_counts(obj_t)
  want = ref.dominance_counts_ref(obj)
  torch.cuda.synchronize()
  err = int((got.long() - want.long()).abs().max())
  if err:
    raise AssertionError(f"K2 counts differ from the plain version: {err}")
  ms = cuda_ms(lambda: kernel.dominance_counts(obj_t))
  plain_ms = cuda_ms(lambda: ref.dominance_counts_ref(obj), inner=2)
  b_ms, b_by = bound_ms(d * n * 8 + n * 4, n * n * 2 * d)
  results["dominance_counts"] = dict(
      name="dominance_counts (K2)", route="cuda",
      source="src/repro_torch/kernels/pareto_front/csrc/pareto_front.cu",
      replaces="src/repro/kernels/pareto_front/kernel.py:75",
      on_main_path=False, max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
      bound_ms=b_ms, bound_by=b_by, library_ms=None)
  log(f"[K2] D={d} N={n}: counts equal ({int((got == 0).sum())} on the "
      f"front); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
      f"bound {b_ms:.4f} ms ({b_by})")
  return results


def sweep_reducers():
  from repro_torch.explore import (HistogramAccumulator, ParetoAccumulator,
                                   StatsAccumulator, TopKAccumulator)
  return {"pareto": ParetoAccumulator(),
          "pareto3": ParetoAccumulator(("latency_s", "energy_mj",
                                        "area_mm2")),
          "top": TopKAccumulator(100, by="energy_mj"),
          "stats": StatsAccumulator("perf_per_area"),
          "hist": HistogramAccumulator("area_mm2", 0.0, 200.0, bins=64)}


def phase_sweep(layers):
  """The main path: 1,000,000 designs of the paper's space, streamed."""
  import numpy as np
  import torch
  from repro_torch.explore import (DesignSpace, ExplorationSession,
                                   TorchOracleBackend)
  from repro_torch.kernels.pareto_front import kernel
  session = ExplorationSession(TorchOracleBackend(chunk_size=SWEEP_CHUNK),
                               DesignSpace())
  kernel.reset_launch_counts()
  res = session.explore(layers, "resnet20", n_per_type=SWEEP_PER_TYPE,
                        stream=True, reducers=sweep_reducers(),
                        chunk_size=SWEEP_CHUNK)
  torch.cuda.synchronize()
  launches = dict(kernel.LAUNCHES)
  m = res.meta
  log(f"[sweep] {res.n_rows} designs in {int(m['n_chunks'])} chunks, "
      f"{m['seconds']:.3f} s: {m['rows_per_sec']:.1f} rows/s; "
      f"rows_transferred/n_rows = "
      f"{m['rows_transferred'] / res.n_rows:.6f}; "
      f"n_overflows {int(m['n_overflows'])}; "
      f"n_demotions {int(m['n_demotions'])}")
  energy = res["top"].energy_mj
  log(f"[sweep] fronts: 2-D {len(res['pareto'])}, 3-D {len(res['pareto3'])}; "
      f"top-100 energy {energy[0]:.6g}..{energy[-1]:.6g} mJ; "
      f"perf/area mean {res['stats']['mean']:.6g}; "
      f"hist total {int(res['hist']['counts'].sum())}")
  log(f"[sweep] kernel launches during the sweep: {launches}")
  if res.n_rows != 4 * SWEEP_PER_TYPE:
    raise AssertionError(f"swept {res.n_rows} rows")
  if launches["block_dominance_counts"] != int(m["n_chunks"]):
    raise AssertionError("K1 did not launch once per chunk: "
                         f"{launches} for {int(m['n_chunks'])} chunks")
  if m["n_demotions"] != 0:
    raise AssertionError(f"{m['n_demotions']} demotions")
  if int(res["hist"]["counts"].sum()) != res.n_rows:
    raise AssertionError("histogram lost rows")
  for name in ("pareto", "pareto3", "top"):
    f = res[name]
    if not len(f) or not all(np.isfinite(f.column(c)).all() for c in
                             ("latency_s", "power_mw", "area_mm2")):
      raise AssertionError(f"{name}: empty or non-finite survivors")
  return res, launches


def phase_breakdown(layers):
  """Where one chunk's time goes.  Each stage runs between two syncs and
  reports its host wall time and the time between CUDA events around it
  on the stream (which includes the gaps where the card waits for the
  host).  The oracle formulas are also captured as one CUDA graph: its
  replay time is their device time without launch gaps."""
  import numpy as np
  import torch
  from repro_torch.core import oracle
  from repro_torch.explore import DesignSpace, TorchOracleBackend
  from repro_torch.explore import device as device_lib
  from repro_torch.explore.device import build_plan
  from repro_torch.explore.streaming import fold_chunk, new_counters
  backend = TorchOracleBackend(chunk_size=SWEEP_CHUNK)
  chunk = next(DesignSpace().iter_tables(SWEEP_PER_TYPE, seed=17,
                                         chunk_size=SWEEP_CHUNK))
  plan = build_plan(sweep_reducers())
  rows = []

  def stage(name, fn):
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    rows.append((name, (time.perf_counter() - t0) * 1e3,
                 start.elapsed_time(end)))
    return out

  for _ in range(2):  # the first pass warms caches; report the second
    rows.clear()
    inputs = stage("host batch_inputs", lambda: oracle.batch_inputs(chunk))
    placed = stage("pack + copy to device", lambda: backend._place(inputs))
    ch = stage("oracle formulas",
               lambda: oracle.characterize_batch(placed, layers))
    cols = stage("derive columns", lambda: device_lib._derive_columns(
        ch.latency_s[None, :], ch.power_mw[None, :], ch.area_mm2[None, :]))
    for name, spec in plan:
      one = device_lib.DevicePlan(specs=((name, spec),), cap=plan.cap)
      stage(f"reduce {name}", lambda: device_lib._reduce_outputs(cols, one))
    pend = stage("fused chunk (dispatch)", lambda: backend.fused_eval_pending(
        chunk, layers, "resnet20", plan, np.arange(len(chunk))))
    fused = stage("fused chunk (resolve)", pend.resolve)
    stage("host fold into the reducers", lambda: fold_chunk(
        sweep_reducers(), new_counters(), fused))
  for name, host_ms, event_ms in rows:
    log(f"[breakdown] {name}: host {host_ms:.3f} ms, events {event_ms:.3f} ms")

  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    oracle.characterize_batch(placed, layers)  # warm-up before capture
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    captured = oracle.characterize_batch(placed, layers)
  graph_ms = cuda_ms(graph.replay, samples=10, inner=3)
  for f in ("latency_s", "power_mw", "area_mm2"):
    if not torch.equal(getattr(captured, f), getattr(ch, f)):
      raise AssertionError(f"graph replay changed {f}")
  eager_ms = next(e for name, _, e in rows if name == "oracle formulas")
  log(f"[breakdown] oracle formulas as one CUDA graph replay: {graph_ms:.3f} "
      f"ms on the card (eager: {eager_ms:.3f} ms between events, so the "
      f"card is busy {graph_ms / eager_ms:.1%} of that stage)")


def _frames_equal(a, b) -> bool:
  import numpy as np
  return (len(a) == len(b)
          and all(np.array_equal(a.column(c), b.column(c))
                  for c in ("latency_s", "power_mw", "area_mm2"))
          and np.array_equal(a.pe_type, b.pe_type))


def phase_parity(layers, sweep):
  """The card against the port's plain path on the CPU."""
  import numpy as np
  import torch
  from repro_torch.core.table import ConfigTable
  from repro_torch.explore import DesignSpace, TorchOracleBackend
  from repro_torch.explore.streaming import stream_explore
  from repro_torch.kernels.pareto_front import ops
  space = DesignSpace()
  chunks = space.iter_tables(SWEEP_PER_TYPE, seed=17, chunk_size=SWEEP_CHUNK)
  table = ConfigTable.concat([next(chunks), next(chunks)])
  gpu = TorchOracleBackend(chunk_size=SWEEP_CHUNK).evaluate_table(table,
                                                                  layers)
  cpu = TorchOracleBackend(chunk_size=SWEEP_CHUNK,
                           device="cpu").evaluate_table(table, layers)
  rel = max(float(np.max(np.abs(getattr(gpu, c) / getattr(cpu, c) - 1.0)))
            for c in ("latency_s", "power_mw", "area_mm2"))
  log(f"[parity] evaluate_table, first two sweep chunks ({len(table)} rows): "
      f"parity_max_rel_err = {rel!r}")
  if rel != 0.0 or not _frames_equal(gpu, cpu):
    raise AssertionError("cuda and cpu evaluate_table differ")

  streams = {}
  for dev in ("cuda", "cpu"):
    streams[dev] = stream_explore(
        TorchOracleBackend(chunk_size=SWEEP_CHUNK, device=dev), space, layers,
        "resnet20", n_per_type=25_000, seed=5, reducers=sweep_reducers(),
        chunk_size=SWEEP_CHUNK)
  g, c = streams["cuda"], streams["cpu"]
  for name in ("pareto", "pareto3", "top"):
    if not _frames_equal(g[name], c[name]):
      raise AssertionError(f"fused stream {name} differs between cuda and cpu")
  if not np.array_equal(g["hist"]["counts"], c["hist"]["counts"]):
    raise AssertionError("fused stream histograms differ")
  for k, v in c["stats"].items():
    if not abs(g["stats"][k] - v) <= 1e-12 * abs(v):
      raise AssertionError(f"stats {k}: {g['stats'][k]!r} vs {v!r}")
  log(f"[parity] 100,000-design fused stream: fronts "
      f"({len(g['pareto'])}, {len(g['pareto3'])}) and top-"
      f"{len(g['top'])} identical, histogram equal, stats within 1e-12")

  front = sweep["pareto3"]
  obj = torch.from_numpy(np.stack(
      [front.latency_s, front.energy_mj, front.area_mm2], axis=1)).cuda()
  counts = ops.dominance_counts(obj)
  if int(counts.max()) != 0:
    raise AssertionError("K2 finds a dominated point on the streamed front")
  log(f"[parity] K2: all {len(front)} points of the streamed 3-D front have "
      "dominance count 0")
  return rel


def main() -> int:
  if not (ROOT / "src" / "repro_torch").is_dir():
    sys.exit("chip_smoke.py: src/repro_torch is not beside this script; "
             "run it from a checkout of the repository")
  sys.path.insert(0, str(ROOT / "src"))
  import torch
  if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device is available")
  from repro_torch.core.workloads import get_network
  t0 = time.perf_counter()
  smi = phase_setup()
  phase_probe()
  kernels = phase_kernels()
  layers = get_network("resnet20")
  sweep, launches = phase_sweep(layers)
  phase_breakdown(layers)
  phase_parity(layers, sweep)
  for name, entry in kernels.items():
    entry["launches"] = launches[name]
  log(f"[done] {time.perf_counter() - t0:.1f} s; each kernel held against "
      "its plain version on the card, with its launches during the sweep:")
  log(json.dumps({"kernels": list(kernels.values())}))
  log(smi)
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
