"""Serving launcher: continuous batching with an optionally int8-quantized
KV cache, on one card (the port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b

It serves a narrow copy of the architecture (``--smoke``, always on, as
in the reference): any decoder of ``configs.list_archs()``, MoE
(qwen2-moe-a2.7b, mixtral-8x22b), the vlm's text backbone (pixtral-12b)
and jamba-1.5-large's hybrid (one block of its 8-layer pattern, where
the others take 4 layers) included. ``--kv-quant`` has no effect on
rwkv6-1.6b, which keeps no KV cache. whisper-base raises ValueError: it
serves through ``Model.prefill(params, {"tokens", "enc_frames"},
max_len)`` and ``Model.decode_step``, and the engine, as the
reference's, feeds tokens only. ``--device`` defaults to ``cuda`` and
the launcher raises without a card; pass ``--device cpu`` to run on the
CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models.model import build_model
from repro_torch.serve.engine import EngineConfig, ServeEngine


def main(argv: Optional[List[str]] = None) -> dict:
  ap = argparse.ArgumentParser()
  ap.add_argument("--arch", default="qwen3-0.6b")
  ap.add_argument("--requests", type=int, default=8)
  ap.add_argument("--new-tokens", type=int, default=16)
  ap.add_argument("--kv-quant", default="int8", choices=["none", "int8"])
  ap.add_argument("--smoke", action="store_true", default=True)
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)

  cfg = get_config(args.arch)
  if cfg.family == "encdec":
    raise ValueError(f"{cfg.name} is an encoder-decoder: ServeEngine feeds "
                     "a batch of tokens only, as the reference's does; serve "
                     "it through Model.prefill(params, {'tokens', "
                     "'enc_frames'}, max_len) and Model.decode_step")
  if args.smoke:
    cfg = reduce_for_smoke(cfg, d_model=128, vocab_size=2048,
                           n_layers=max(4, len(cfg.layer_kinds())))
  cfg = dataclasses.replace(cfg, kv_quant=args.kv_quant)
  model = build_model(cfg, device=args.device)
  params = model.init(0)
  engine = ServeEngine(model, params, EngineConfig(
      batch_slots=4, max_len=256, prompt_bucket=32), device=args.device)
  rng = np.random.RandomState(0)
  t0 = time.time()
  for i in range(args.requests):
    engine.submit(rng.randint(0, cfg.vocab_size, size=10 + i),
                  max_new_tokens=args.new_tokens)
  results = engine.run_until_drained()
  dt = time.time() - t0
  total = sum(len(v) for v in results.values())
  print(f"served {len(results)} requests / {total} tokens in {dt:.1f}s "
        f"(kv_quant={args.kv_quant}, device={model.device})")
  return results


if __name__ == "__main__":
  main()
