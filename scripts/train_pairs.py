#!/usr/bin/env python3
"""Training speed of two checkouts of the port, run in turn on one card.

An eager training step is bound by the host, whose pace drifts from run to
run, so one run of each checkout cannot tell a change from the drift.
This trains what chip_smoke.py's ``[train]`` phase trains (full-width
qwen3-0.6b through ``repro_torch.launch.train``'s recipe, 8 x 512 tokens
a step, seed 0) for ``--steps`` steps once in each of ``2 * pairs`` fresh
processes, alternating the checkouts as A B B A A B ..., and prints for
every run the median host time of a step (steps 2 on; each step ends in
a synchronize), tokens/s, the losses and K6's launches; then each
checkout's medians and in how many pairs B trained faster.

    python3 scripts/train_pairs.py --a PARENT/src --b src [--pairs 3]

Each ``src`` loads and builds its own kernels under its own checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

BATCH, SEQ = 8, 512


def child(src: str, steps: int) -> None:
  """One training run of the checkout whose package lies in ``src``."""
  sys.path.insert(0, src)
  import torch
  from repro_torch.configs import get_config
  from repro_torch.kernels.flash_attention import kernel as fa_kernel
  from repro_torch.launch import train as launch_train
  with tempfile.TemporaryDirectory() as ckpt:
    trainer = launch_train.make_trainer(
        get_config("qwen3-0.6b"), launch_train.recipe(steps), steps, BATCH,
        SEQ, ckpt)
    fa_kernel.reset_launch_counts()
    hist = trainer.run(steps)
  torch.cuda.synchronize()
  ms = statistics.median(r["sec"] for r in hist[1:]) * 1e3
  print(json.dumps({
      "step_ms": ms, "tokens_per_s": BATCH * SEQ / (ms / 1e3),
      "losses": [round(r["loss"], 4) for r in hist],
      "launches": dict(fa_kernel.LAUNCHES),
      "device": torch.cuda.get_device_name(0)}))


def run(src: str, steps: int) -> dict:
  env = dict(os.environ, PYTHONPATH="")
  proc = subprocess.run([sys.executable, __file__, "--child", src,
                         "--steps", str(steps)],
                        capture_output=True, text=True, env=env)
  if proc.returncode != 0:
    sys.exit(f"training {src} failed:\n{proc.stdout}\n{proc.stderr}")
  return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--a", help="src directory of checkout A")
  ap.add_argument("--b", help="src directory of checkout B")
  ap.add_argument("--pairs", type=int, default=3)
  ap.add_argument("--steps", type=int, default=30)
  ap.add_argument("--child", help=argparse.SUPPRESS)
  args = ap.parse_args()
  if args.child:
    child(args.child, args.steps)
    return 0
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip()
  print(f"[train-pairs] {smi}; A = {args.a}, B = {args.b}, {args.pairs} "
        f"pairs of {args.steps} steps in ABBA order", flush=True)
  runs = {"A": [], "B": []}
  faster = 0
  for i in range(args.pairs):
    order = ("A", "B") if i % 2 == 0 else ("B", "A")
    pair = {}
    for which in order:
      r = run(args.a if which == "A" else args.b, args.steps)
      runs[which].append(r)
      pair[which] = r
      print(f"[train-pairs] pair {i + 1} {which}: step {r['step_ms']:.2f} ms "
            f"(host, median of steps 2-{args.steps}), "
            f"{r['tokens_per_s']:,.1f} tokens/s; losses {r['losses'][0]} -> "
            f"{r['losses'][-1]}; launches {r['launches']}", flush=True)
    faster += pair["B"]["step_ms"] < pair["A"]["step_ms"]
  for which in ("A", "B"):
    rs = runs[which]
    print(f"[train-pairs] {which} medians of {len(rs)}: step "
          f"{statistics.median(r['step_ms'] for r in rs):.2f} ms, "
          f"{statistics.median(r['tokens_per_s'] for r in rs):,.1f} "
          f"tokens/s")
  print(f"[train-pairs] B trained faster in {faster} of {args.pairs} pairs")
  return 0


if __name__ == "__main__":
  sys.exit(main())
