#!/usr/bin/env python3
"""Host time of one eager call of the serving attention kernels (K5, K6).

Serving runs eager: a decode step launches about 2,400 device operations
and the card idles most of the step, so what a kernel costs the host per
call moves tokens/s as much as its device time does.  This times, on one
CUDA card, ``calls`` back-to-back eager calls of each wrapper at its
serving shape (K6: one 512-token prefill layer of qwen3-0.6b; K5: one
decode step's layer over a 2,048-position int8 cache filled to 513), with
one synchronize at the end, and prints microseconds per call: the host's
launch cost when it exceeds the kernel's device time.

    PYTHONPATH=src python3 scripts/kernel_host_cost.py [--calls N]

Point PYTHONPATH at another checkout's ``src`` to time that tree's
kernels the same way.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch


def per_call_us(fn, calls: int, repeats: int = 5) -> float:
  """Median over ``repeats`` of the host microseconds per call of
  ``calls`` back-to-back calls of ``fn`` ended by one synchronize."""
  fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(repeats):
    t0 = time.perf_counter()
    for _ in range(calls):
      fn()
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) / calls * 1e6)
  return statistics.median(times)


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--calls", type=int, default=500)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit("kernel_host_cost.py: no CUDA device is available")
  from repro_torch.kernels.flash_attention import ops as fa
  from repro_torch.kernels.quant_decode_attn import ops as qda
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  rng = np.random.RandomState(0)

  def randn(shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        device="cuda", dtype=dtype)

  q = randn((1, 512, 16, 128), torch.bfloat16)
  kv = randn((1, 512, 2, 8, 128), torch.bfloat16)
  k, v = kv[:, :, 0], kv[:, :, 1]
  k6 = per_call_us(lambda: fa.flash_attention(q, k, v, causal=True),
                   args.calls)
  qd = randn((1, 16, 128), torch.bfloat16)
  cache = qda.quantize_kv(randn((1, 8, 2048, 128), torch.float32),
                          randn((1, 8, 2048, 128), torch.float32))
  lens = torch.full((1,), 513, dtype=torch.int32, device="cuda")
  k5 = per_call_us(lambda: qda.quant_decode_attn(qd, *cache, lens),
                   args.calls)
  print(f"[host-cost] {smi}: {args.calls} eager calls, median of 5: K6 "
        f"(1, 512, 16, 8, 128) bf16 causal {k6:.2f} us a call; K5 "
        f"(1, 16, 8, 2048, 128) length 513 {k5:.2f} us a call", flush=True)
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
