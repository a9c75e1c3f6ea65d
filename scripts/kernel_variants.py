#!/usr/bin/env python3
"""Time design variants of the K1, K2, K3, K4, K7 and K7-bwd CUDA kernels
side by side on one card, in one process.

Each variant is the kernel's own source with one constant or one rule
changed (the shipped source is the first variant of each list: K7's
cluster size chosen from the clusters the card holds, then fixed sizes;
K4's tensor-core tile shapes; K3's tile and split of K chosen by shape,
then one rule of that choice, its K tile or ring, or a rule of its decode
path changed, each also at K = 0, the launch and epilogue alone; K1's
kernel, the same kernel without its pair loop (its floor), and the
designs of ``k1_designs.cu`` beside this script: the same pair tests with
several points and lanes a thread, and ranks with bit masks or packed rank
lanes), built with the port's nvcc flags into ``build/variants/`` and
called through its C entry.  Every variant's output is held to the
kernel's plain version before it is timed, and the variants are timed in
turns (first to last, then last to first) as CUDA-graph replays.  K7 also
reports how many clusters of its blocks the card holds at once
(``cudaOccupancyMaxActiveClusters``).  K2 (D=3, N=4,096) and K7's
backward (the rwkv6-1.6b training shape, B=8, H=32, T=512, D=64, bf16)
have the shipped source alone; with ``--parent`` another tree (a parent
commit unpacked by ``git archive``) adds its source of each named kernel
as a variant, so a change and its parent are timed in turns on one card.

    PYTHONPATH=src python3 scripts/kernel_variants.py [K1 K2 K3 K4 K7 K7-bwd]
        [--parent build/parent]

With kernel names, only their variants are built and timed.  Needs a
CUDA card and nvcc; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch import _build
from repro_torch.kernels.int8_matmul import ref as i8_ref
from repro_torch.kernels.pareto_front import kernel as pf_kernel
from repro_torch.kernels.pareto_front import ref as pf_ref
from repro_torch.kernels.pow2_matmul import ref as p2_ref
from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref

OUT = _build.BUILD_DIR.parent / "variants"
KERNELS = _build.PACKAGE / "kernels"
K7_TS = (300, 512, 2048)              # B = 1, H = 32, D = 64, chunk 64
K7_BLOCKS = (8, 7, 5, 4)              # fixed cluster sizes
K7_BWD_SHAPE = (8, 32, 512, 64)       # B, H, T, D; chunk 64, bf16 r/k/v
K2_SHAPE = (3, 4096)                  # D, N (the survivor cap)
CSRC = {"K1": "pareto_front", "K2": "pareto_front", "K3": "int8_matmul",
        "K4": "pow2_matmul", "K7": "rwkv6_scan", "K7-bwd": "rwkv6_scan"}
K4_TILES = ((128, 96, 256), (128, 64, 256), (64, 96, 128), (64, 192, 128))
# K3: qwen3-0.6b's four (K, N) of a layer, a decode token and a prompt;
# K = 0 times the launch and the epilogue alone
K3_KN = ((1024, 2048), (2048, 1024), (1024, 3072), (3072, 1024), (0, 3072))
K3_MS = (512, 1)
K3_VARIANTS = (  # (name, {constant: value}) changed in the shipped source
    ("128-row tiles always", {"kTcMinTiles": 0}),
    ("64-row tiles always", {"kTcMinTiles": 1 << 20}),
    ("128 x 128 tiles, no split", {"kTcMinTiles": 0, "kTcMaxSplits": 1}),
    ("no split", {"kTcMaxSplits": 1}),
    ("split to 132 blocks", {"kTcMinBlocks": 132}),
    ("64-byte K tiles", {"kTcBK": 64}),
    ("a ring of 3 tiles", {"kTcStages": 3}),
    ("decode split over 4 blocks", {"kMaxSplits": 4}),
    ("decode ring of 2 stages", {"kDecStages": 2}))
K1_SHAPE = (3, 65536, 128)            # D, N (one sweep chunk), block
# K1's shipped kernel (one thread a point) against the designs of
# k1_designs.cu beside this script: (name, C entry, {constant: value})
K1_DESIGNS = (
    ("4 points a thread, 4 lanes", "k1_points", {}),
    ("4 points a thread, 2 lanes", "k1_points", {"kLanesPerPoint": 2}),
    ("4 points a thread, 1 lane", "k1_points", {"kLanesPerPoint": 1}),
    ("2 points a thread, 2 lanes", "k1_points", {"kPointsPerThread": 2,
                                                 "kLanesPerPoint": 2}),
    ("2 points a thread, 1 lane", "k1_points", {"kPointsPerThread": 2,
                                                "kLanesPerPoint": 1}),
    ("ranks, bit masks", "k1_ranks", {}),
    ("ranks, packed lanes", "k1_ranks", {"kMaskMaxBlock": 0}))
OCCUPANCY = '''
extern "C" int k7_active_clusters(int blocks, int* out) {
  auto k = wkv6_kernel<__nv_bfloat16, 64>;
  const size_t smem = Layout<__nv_bfloat16, 64>(64).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1024);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, k, &cfg);
}
'''


def replace_constants(src: str, values) -> str:
  for name, value in values.items():
    src, n = re.subn(rf"constexpr int {name} = \d+;",
                     f"constexpr int {name} = {value};", src)
    assert n == 1, name
  return src


def build(name: str, text: str) -> ctypes.CDLL:
  OUT.mkdir(parents=True, exist_ok=True)
  src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
  src.write_text(text)
  proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                         str(src)], capture_output=True, text=True)
  if proc.returncode:
    raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
  return ctypes.CDLL(str(lib))


def graph_ms(fn, inner: int = 10, samples: int = 25) -> float:
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(2):
      fn()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(inner):
      fn()
  graph.replay()
  torch.cuda.synchronize()
  times = []
  for _ in range(samples):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end) / inner)
  return statistics.median(times)


def k7_calls(lib):
  lib.wkv6_forward.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int64] * 20
                               + [ctypes.c_int, ctypes.c_void_p])
  gen = torch.Generator().manual_seed(0)
  calls = {}
  for t in K7_TS:
    b, h, d = 1, 32, 64

    def heads(x, t=t):
      return x.view(b, t, h, d).transpose(1, 2)
    r, k, v = (heads(torch.randn(b, t, h * d, generator=gen).cuda()
                     .bfloat16()) for _ in range(3))
    w = heads(torch.exp(-torch.exp(torch.randn(b, t, h * d, generator=gen)
                                   - 3.0)).cuda())
    u = torch.randn(h, d, generator=gen).cuda() * 0.3
    out = torch.empty(b, t, h, d, device="cuda")
    s_out = torch.empty(b, h, d, d, device="cuda")

    def call(t=t, r=r, k=k, v=v, w=w, u=u, out=out, s_out=s_out):
      status = lib.wkv6_forward(
          r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
          u.data_ptr(), None, out.data_ptr(), s_out.data_ptr(), b, h, t, d,
          64, *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
          *w.stride()[:3], out.stride(0), out.stride(2), out.stride(1), 1,
          torch.cuda.current_stream().cuda_stream)
      assert status == 0, status
    call()
    want_o, want_s = wkv_ref.wkv6_chunked(
        r, k, v, w, u, torch.zeros(b, h, d, d, device="cuda"), 64)
    got_o = out.permute(0, 2, 1, 3)
    for got, want in ((got_o, want_o), (s_out, want_s)):
      assert float((got - want).abs().max()) <= 1e-4 * float(
          want.abs().max())
    calls[f"T={t}"] = call
  return calls


def k4_calls(lib):
  lib.p2mm_forward.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
                               + [ctypes.c_int] * 2 + [ctypes.c_void_p])
  gen = torch.Generator().manual_seed(1)
  x = torch.randn(512, 1024, generator=gen).cuda().bfloat16()
  scale = torch.rand(3072, generator=gen).cuda()
  out = torch.empty(512, 3072, device="cuda")
  calls = {}
  for k_terms in (1, 2):
    codes = torch.randint(0, 256 if k_terms == 1 else 128,
                          (1024, 3072 // 2 if k_terms == 1 else 3072),
                          dtype=torch.uint8, generator=gen).cuda()

    def call(k_terms=k_terms, codes=codes):
      status = lib.p2mm_forward(
          x.data_ptr(), codes.data_ptr(), scale.data_ptr(), out.data_ptr(),
          512, 1024, 3072, k_terms, 1, torch.cuda.current_stream()
          .cuda_stream)
      assert status == 0, status
    call()
    want = p2_ref.pow2_matmul_ref(x, codes, scale, k_terms)
    assert float((out - want).abs().max()) <= 1e-5 * float(want.abs().max())
    calls[f"M=512 k={k_terms}"] = call
  return calls


def k3_calls(lib):
  """K3 at each (K, N) of K3_KN and M of K3_MS on seeded codes, bf16 x
  scales, each output equal to the plain version."""
  lib.i8mm_forward.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3
                               + [ctypes.c_int, ctypes.c_void_p])
  gen = torch.Generator().manual_seed(3)
  calls = {}
  for m in K3_MS:
    for k, n in K3_KN:
      x = torch.randint(-128, 128, (m, k), dtype=torch.int8,
                        generator=gen).cuda()
      w = torch.randint(-128, 128, (k, n), dtype=torch.int8,
                        generator=gen).cuda()
      xs = (torch.rand(m, generator=gen) * 0.1).cuda().bfloat16()
      ws = (torch.rand(n, generator=gen) * 0.01).cuda()
      out = torch.empty(m, n, device="cuda")

      def call(m=m, k=k, n=n, x=x, w=w, xs=xs, ws=ws, out=out):
        status = lib.i8mm_forward(
            x.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            out.data_ptr(), m, k, n, 1,
            torch.cuda.current_stream().cuda_stream)
        assert status == 0, status
      call()
      assert torch.equal(out, i8_ref.int8_matmul_ref(x, w, xs, ws))
      calls[f"M={m} K={k} N={n}"] = call
  return calls


def k1_calls(lib, entry="pf_block_dominance_counts", check=True):
  """K1 at K1_SHAPE on seeded objectives with ties and duplicates, counts
  equal to the plain version (unless not ``check``)."""
  fn = getattr(lib, entry)
  fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 2
  d, n, block = K1_SHAPE
  gen = torch.Generator().manual_seed(1)
  obj = torch.rand(d, n, generator=gen, dtype=torch.float64)
  obj[0, torch.randint(0, n, (n // 8,), generator=gen)] = 0.5
  obj[:, torch.randint(0, n, (n // 32,), generator=gen)] = torch.round(
      obj[:, torch.randint(0, n, (n // 32,), generator=gen)] * 100) / 100
  obj = obj.cuda().contiguous()
  counts = torch.empty(n, dtype=torch.int32, device="cuda")

  def call():
    status = fn(obj.data_ptr(), d, n, block, counts.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    assert status == 0, status
  call()
  assert not check or torch.equal(
      counts, pf_ref.block_dominance_counts_ref(obj.T, block))
  return {f"D={d} N={n} block={block}": call}


def k7_bwd_calls(lib):
  """K7's backward at K7_BWD_SHAPE on seeded inputs (zero s0 and
  ds_final), through the C entry ``wkv6_backward`` as ``kernel.wkv6_bwd``
  calls it (its scratch holds a parent's, b h chunks d^2 floats), dr, dk,
  dv, du and ds0 within 1e-4 (+ 2^-8 for bf16) of each one's largest
  |value| of the plain version."""
  p, i64 = ctypes.c_void_p, ctypes.c_int64
  lib.wkv6_backward.argtypes = [p] * 15 + [i64] * 23 + [ctypes.c_int, p]
  b, h, t, d = K7_BWD_SHAPE
  gen = torch.Generator().manual_seed(29)

  def heads(x):
    return x.view(b, t, h, d).transpose(1, 2)
  r, k, v = (heads(torch.randn(b, t, h * d, generator=gen).cuda()
                   .bfloat16()) for _ in range(3))
  w = heads(torch.exp(-torch.exp(torch.randn(b, t, h * d, generator=gen)
                                 - 3.0)).cuda())
  u = torch.randn(h, d, generator=gen).cuda() * 0.3
  dout = heads(torch.randn(b, t, h * d, generator=gen).cuda())
  grads = [torch.empty(b, t, h, d, dtype=dt, device="cuda")
           for dt in (r.dtype, r.dtype, r.dtype, torch.float32)]
  du = torch.empty(b, h, d, device="cuda")
  ds0 = torch.empty(b, h, d, d, device="cuda")
  scratch = torch.empty(wkv_kernel.bwd_scratch_floats(b, h, t, d, 64),
                        device="cuda")
  g = grads[0]

  def call():
    status = lib.wkv6_backward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), None, dout.data_ptr(), None,
        *(x.data_ptr() for x in grads), du.data_ptr(), ds0.data_ptr(),
        scratch.data_ptr(), b, h, t, d, 64, *r.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *w.stride()[:3],
        *dout.stride()[:3], g.stride(0), g.stride(2), g.stride(1), 1,
        torch.cuda.current_stream().cuda_stream)
    assert status == 0, status
  call()
  want = wkv_ops.wkv6_bwd_reference(r, k, v, w, u, None, dout, None, 64)
  got = [x.permute(0, 2, 1, 3) for x in grads[:3]] + [du.sum(0), ds0]
  for i, (x, y) in enumerate(zip(got, [*want[:3], *want[4:]])):
    tol = 1e-4 + (2.0 ** -8 if x.dtype == torch.bfloat16 else 0.0)
    assert float((x.float() - y).abs().max()) <= tol * float(
        y.abs().max()), i
  return {f"B={b} H={h} T={t} D={d} bf16": call}


def k2_calls(lib, split: bool = True):
  """K2 at K2_SHAPE on seeded objectives with ties, counts equal to the
  plain version; ``split``: the C entry takes kernel.pair_splits' count
  of j splits (PR 11's design takes none)."""
  fn = lib.pf_dominance_counts
  fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int64] * (3 if split else 2)
                 + [ctypes.c_void_p] * 2)
  d, n = K2_SHAPE
  gen = torch.Generator().manual_seed(2)
  obj = torch.round(torch.rand(n, d, generator=gen, dtype=torch.float64)
                    * 64) / 64
  obj_t = obj.T.contiguous().cuda()
  counts = torch.empty(n, dtype=torch.int32, device="cuda")
  extra = (pf_kernel.pair_splits(n, torch.cuda.get_device_properties(0)
                                 .multi_processor_count),) if split else ()

  def call():
    status = fn(obj_t.data_ptr(), d, n, *extra, counts.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    assert status == 0, status
  call()
  assert torch.equal(counts.cpu(), pf_ref.dominance_counts_ref(obj))
  return {f"D={d} N={n}" + (f", {extra[0]} splits" if split else ""): call}


def _named(values) -> str:
  return ", ".join(f"{name} = {value}" for name, value in values.items())


def parent_job(kernel: str, parent: Path):
  """{variant name: (source text, calls function)}: ``kernel`` as the
  tree ``parent`` has it."""
  name = CSRC[kernel]
  src = (parent / "src/repro_torch/kernels" / name / "csrc"
         / f"{name}.cu").read_text()
  calls = {"K1": k1_calls, "K3": k3_calls, "K4": k4_calls, "K7": k7_calls,
           "K7-bwd": k7_bwd_calls}.get(kernel)
  if kernel == "K2":
    split = re.search(r"pf_dominance_counts\([^)]*splits", src) is not None
    calls = lambda lib: k2_calls(lib, split)  # noqa: E731
  return {f"{kernel} parent ({parent})": (src, calls)}


def jobs_of(kernel: str):
  """{variant name: (source text, calls function)} of one kernel."""
  if kernel == "K7-bwd":
    return {"K7-bwd shipped": (
        (KERNELS / "rwkv6_scan/csrc/rwkv6_scan.cu").read_text(),
        k7_bwd_calls)}
  if kernel == "K2":
    return {"K2 shipped (j tiles split over pair_splits blocks)": (
        (KERNELS / "pareto_front/csrc/pareto_front.cu").read_text(),
        k2_calls)}
  if kernel == "K7":
    k7 = (KERNELS / "rwkv6_scan/csrc/rwkv6_scan.cu").read_text()
    # a fixed size n: at most n blocks, and the first (largest) n is taken
    first = k7.replace("if (best_cost < 0 || cost < best_cost) {",
                       "if (best_cost < 0) {")
    assert first != k7
    jobs = {"K7 shipped (cluster size chosen)": (k7 + OCCUPANCY, k7_calls)}
    jobs.update({f"K7 {n} blocks a cluster": (replace_constants(
        first, {"kMaxBlocks": n}) + OCCUPANCY, k7_calls) for n in K7_BLOCKS})
    return jobs
  if kernel == "K4":
    k4 = (KERNELS / "pow2_matmul/csrc/pow2_matmul.cu").read_text()
    jobs = {}
    for bm, bn, threads in K4_TILES:
      jobs[f"K4 tile {bm}x{bn}"] = (replace_constants(
          k4, {"kTcBM": bm, "kTcBN": bn, "kTcThreads": threads}), k4_calls)
    return jobs
  if kernel == "K3":
    k3 = (KERNELS / "int8_matmul/csrc/int8_matmul.cu").read_text()
    jobs = {"K3 shipped (tile and split by shape)": (k3, k3_calls)}
    jobs.update({f"K3 {label} ({_named(values)})": (
        replace_constants(k3, values), k3_calls)
                 for label, values in K3_VARIANTS})
    return jobs
  k1 = (KERNELS / "pareto_front/csrc/pareto_front.cu").read_text()
  jobs = {"K1 shipped (float64 compares, one thread a point)": (k1,
                                                                k1_calls)}
  # the kernel with no pair test: its loads, stores and launch alone
  floor = k1.replace("for (int j = 0; j < b; ++j) c +=",
                     "for (int j = 0; j < 0; ++j) c +=")
  assert floor != k1
  jobs["K1 floor: no pair test (not held to the plain version)"] = (
      floor, lambda lib: k1_calls(lib, check=False))
  designs = (Path(__file__).resolve().parent / "k1_designs.cu").read_text()
  for label, entry, values in K1_DESIGNS:
    jobs[f"K1 {entry}: {label}"] = (
        replace_constants(designs, values),
        lambda lib, entry=entry: k1_calls(lib, entry))
  return jobs


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("kernels", nargs="*", metavar="KERNEL",
                  help=f"any of {', '.join(CSRC)} (default K1 K3 K4 K7)")
  ap.add_argument("--parent", type=Path,
                  help="a tree whose source of each kernel is a variant")
  args = ap.parse_args()
  unknown = set(args.kernels) - set(CSRC)
  if unknown:
    ap.error(f"unknown kernels: {sorted(unknown)}")
  if not torch.cuda.is_available():
    sys.exit("kernel_variants.py: no CUDA device is available")
  jobs = {}
  for kernel in args.kernels or ["K1", "K3", "K4", "K7"]:
    jobs.update(jobs_of(kernel))
    if args.parent is not None:
      jobs.update(parent_job(kernel, args.parent.resolve()))
  names = list(jobs)
  with ThreadPoolExecutor(len(names)) as pool:
    libs = dict(zip(names, pool.map(
        lambda i: build(f"variant{i}", jobs[names[i]][0]),
        range(len(names)))))
  calls = {name: jobs[name][1](lib) for name, lib in libs.items()}
  times = {name: {shape: [] for shape in calls[name]} for name in names}
  for order in (names, names[::-1]):
    for name in order:
      for shape, call in calls[name].items():
        times[name][shape].append(graph_ms(call))
  for name in names:
    line = "; ".join(f"{shape} {t[0]:.4f} / {t[1]:.4f} ms"
                     for shape, t in times[name].items())
    held = "" if "not held" in name else " (held to the plain version)"
    print(f"[variants] {name}: {line}{held}")
  shipped_k7 = libs.get("K7 shipped (cluster size chosen)")
  if shipped_k7 is not None:
    shipped_k7.k7_active_clusters.argtypes = [ctypes.c_int,
                                              ctypes.POINTER(ctypes.c_int)]
    for blocks in sorted(K7_BLOCKS, reverse=True):
      active = ctypes.c_int(0)
      assert shipped_k7.k7_active_clusters(blocks, ctypes.byref(active)) == 0
      print(f"[variants] K7 (bf16, D=64, chunk 64): the card holds "
            f"{active.value} clusters of {blocks} blocks at once")
  print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
  return 0


if __name__ == "__main__":
  sys.exit(main())
