"""Small same-family configurations for CPU tests (the port's copy of
``repro.configs.shapes.reduce_for_smoke``)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


def reduce_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
  """Tiny same-family config for CPU smoke tests."""
  period = len(cfg.layer_kinds())
  base = dict(
      n_layers=2 * period,
      d_model=64,
      n_heads=4 if cfg.n_heads else 0,
      n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_heads else 0,
      head_dim=16,
      d_ff=128,
      vocab_size=512,
      attn_chunk=64,
      loss_chunk_tokens=256,
      moe_group_size=64,
      ssm_chunk=16,
      dtype="float32",
  )
  if cfg.family == "ssm":
    base.update(n_heads=4, head_dim=16)
  if cfg.n_experts:
    base.update(n_experts=4, n_experts_active=min(cfg.n_experts_active, 2),
                d_ff_expert=128,
                d_ff_shared=128 if cfg.n_shared_experts else 0)
  if cfg.family == "encdec":
    base.update(n_encoder_layers=2, encoder_seq=32)
  if cfg.family == "vlm":
    base.update(n_image_tokens=8)
  if cfg.sliding_window:
    base.update(sliding_window=32)
  base.update(overrides)
  return dataclasses.replace(cfg, **base)
