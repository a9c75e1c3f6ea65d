#!/usr/bin/env python3
"""Serving speed of two checkouts of the port, run in turn on one card.

Eager serving is bound by the host, whose pace drifts from run to run, so
one run of each checkout cannot tell a change from the drift.  This
serves the traffic of chip_smoke.py's ``[serve]`` phase (full-width
qwen3-0.6b, bf16, int8 KV cache, seed-0 weights, eight requests of 32 new
tokens) once in each of ``2 * pairs`` fresh processes, alternating the
checkouts as A B B A A B ..., and prints for every run tokens/s, the
medians of the prefill and decode calls (CUDA events and host clock) and
the host time the decode steps spend inside the K5 wrapper; then each
checkout's medians, in how many pairs B served faster, and whether the
runs gave the same greedy tokens (within a checkout and between them;
both compute in bf16, so kernels that round differently can flip a
near-tie).  It also prints ptxas' register and spill report of each
checkout's attention kernels, from its build.

    python3 scripts/serve_pairs.py --a PARENT/src --b src [--pairs 10]

Each ``src`` loads and builds its own kernels under its own checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(src: str) -> None:
  """One serving run of the checkout whose package lies in ``src``."""
  sys.path.insert(0, src)
  sys.path.insert(1, str(ROOT))
  import dataclasses

  import torch

  import chip_smoke
  import repro_torch
  from repro_torch import _build
  from repro_torch.configs import get_config
  from repro_torch.kernels.quant_decode_attn import ops as qda_ops
  from repro_torch.models import build_model
  assert Path(repro_torch.__file__).resolve().is_relative_to(
      Path(src).resolve()), repro_torch.__file__

  k5_host = []
  k5_call = qda_ops.quant_decode_attn

  def timed_k5(*args, **kwargs):
    t0 = time.perf_counter()
    out = k5_call(*args, **kwargs)
    k5_host.append(time.perf_counter() - t0)
    return out
  qda_ops.quant_decode_attn = timed_k5

  cfg = dataclasses.replace(get_config("qwen3-0.6b"), kv_quant="int8")
  model = build_model(cfg)
  params = model.init(0)
  prompts = chip_smoke.serve_prompts(cfg.vocab_size)
  chip_smoke.serve_once(model, params, prompts[:2])  # loads every kernel
  k5_host.clear()
  out, wall, pre, dec, launches = chip_smoke.serve_once(model, params,
                                                        prompts)
  n_tokens = sum(len(t) for t in out.values())
  print(json.dumps({
      "tokens_per_s": n_tokens / wall,
      "prefill_events_ms": statistics.median(r[1] for r in pre),
      "prefill_host_ms": statistics.median(r[0] for r in pre),
      "decode_events_ms": statistics.median(r[1] for r in dec),
      "decode_host_ms": statistics.median(r[0] for r in dec),
      "k5_host_ms_per_step": sum(k5_host) * 1e3 / len(dec),
      "k5_host_us_per_call": statistics.median(k5_host) * 1e6,
      "launches": launches,
      "tokens": [[int(x) for x in out[u]] for u in sorted(out)],
      "ptxas": {**_build.ptxas_report("flash_attention"),
                **_build.ptxas_report("quant_decode_attn")},
      "device": torch.cuda.get_device_name(0)}))


def run(src: str) -> dict:
  env = dict(os.environ, PYTHONPATH="")
  proc = subprocess.run([sys.executable, __file__, "--child", src],
                        capture_output=True, text=True, env=env)
  if proc.returncode != 0:
    sys.exit(f"serving {src} failed:\n{proc.stdout}\n{proc.stderr}")
  return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--a", help="src directory of checkout A")
  ap.add_argument("--b", help="src directory of checkout B")
  ap.add_argument("--pairs", type=int, default=10)
  ap.add_argument("--child", help=argparse.SUPPRESS)
  args = ap.parse_args()
  if args.child:
    child(args.child)
    return 0
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip()
  print(f"[pairs] {smi}; A = {args.a}, B = {args.b}, {args.pairs} pairs in "
        f"ABBA order", flush=True)
  runs = {"A": [], "B": []}
  faster = 0
  for i in range(args.pairs):
    order = ("A", "B") if i % 2 == 0 else ("B", "A")
    pair = {}
    for which in order:
      r = run(args.a if which == "A" else args.b)
      if not runs[which]:
        print(f"[pairs] {which} ptxas: {json.dumps(r['ptxas'])}")
      runs[which].append(r)
      pair[which] = r
      print(f"[pairs] pair {i + 1} {which}: {r['tokens_per_s']:.2f} tokens/s; "
            f"decode per token: events {r['decode_events_ms']:.3f} ms, host "
            f"{r['decode_host_ms']:.3f} ms; prefill per request: events "
            f"{r['prefill_events_ms']:.3f} ms; K5 wrapper host "
            f"{r['k5_host_ms_per_step']:.3f} ms a decode step "
            f"({r['k5_host_us_per_call']:.2f} us a call); launches "
            f"{r['launches']}", flush=True)
    faster += pair["B"]["tokens_per_s"] > pair["A"]["tokens_per_s"]
  for which in ("A", "B"):
    rs = runs[which]
    print(f"[pairs] {which} medians of {len(rs)}: "
          + ", ".join(f"{key} {statistics.median(r[key] for r in rs):.3f}"
                      for key in ("tokens_per_s", "decode_events_ms",
                                  "decode_host_ms", "prefill_events_ms",
                                  "k5_host_ms_per_step",
                                  "k5_host_us_per_call")))
  print(f"[pairs] B served faster in {faster} of {args.pairs} pairs")
  distinct = {w: len({json.dumps(r["tokens"]) for r in runs[w]})
              for w in ("A", "B")}
  a, b = runs["A"][0]["tokens"], runs["B"][0]["tokens"]
  diff = [(u, i) for u, (ta, tb) in enumerate(zip(a, b))
          for i, (x, y) in enumerate(zip(ta, tb)) if x != y]
  print(f"[pairs] distinct token sets among the runs: A {distinct['A']}, "
        f"B {distinct['B']}; A's first run and B's differ in {len(diff)} of "
        f"{sum(map(len, a))} tokens"
        + (f", first at request {diff[0][0] + 1}, token {diff[0][1] + 1}"
           if diff else ""))
  return 0


if __name__ == "__main__":
  sys.exit(main())
