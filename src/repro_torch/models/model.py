"""Model facade: ``build_model(cfg) -> Model`` with the reference's API
for the decoder family, attention (qwen3-0.6b) and RWKV-6 (rwkv6-1.6b)
layers (the port of ``repro.models.model``).

  init(seed)                        -> params (a Transformer module)
  from_state(state)                 -> params from a state dict
  init_cache(batch, max_len)        -> decode cache
  prefill(params, tokens, max_len)  -> (last logits, cache)
  decode_step(params, tok, cache)   -> (logits, cache)

A Model lives on one device: CUDA unless the caller passes
``device="cpu"``; it raises when CUDA is asked for and there is none.
Prefill and decode run eagerly under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.common import Device, resolve_device


class Model:
  def __init__(self, cfg: ModelConfig, device: Device = None):
    transformer.check_supported(cfg)
    self.cfg = cfg
    self.device = resolve_device(device, "build_model")

  def init(self, seed: int = 0) -> transformer.Transformer:
    """Random parameters on the model's device from ``seed``."""
    return transformer.init_params(self.cfg, seed, self.device)

  def from_state(self, state: Mapping[str, torch.Tensor]
                 ) -> transformer.Transformer:
    """Parameters on the model's device from a state dict (for example
    ``convert.params_from_jax``'s)."""
    params = transformer.Transformer(self.cfg, self.device)
    params.load_state_dict(dict(state))
    return params

  def train_loss(self, *args, **kwargs):
    return transformer.train_loss(*args, **kwargs)

  @torch.inference_mode()
  def init_cache(self, batch: int, max_len: int) -> transformer.Cache:
    return transformer.init_cache(self.cfg, batch, max_len, self.device)

  @torch.inference_mode()
  def prefill(self, params: transformer.Transformer, tokens: torch.Tensor,
              max_len: int):
    """tokens (B, S) -> (last logits (B, V), cache)."""
    return transformer.prefill(params, tokens, self.cfg, max_len)

  @torch.inference_mode()
  def decode_step(self, params: transformer.Transformer,
                  tokens: torch.Tensor, cache: transformer.Cache):
    return transformer.decode_step(params, tokens, cache, self.cfg)


def build_model(cfg: ModelConfig, device: Device = None) -> Model:
  return Model(cfg, device)
