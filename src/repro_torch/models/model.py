"""Model facade: ``build_model(cfg) -> Model`` with the reference's API
for the decoder family, attention (qwen3-0.6b) and RWKV-6 (rwkv6-1.6b)
layers (the port of ``repro.models.model``).

  init(seed[, param_dtype])         -> params (a Transformer module)
  from_state(state[, param_dtype])  -> params from a state dict
  train_loss(params, batch, remat)  -> (loss, metrics)
  init_cache(batch, max_len)        -> decode cache
  prefill(params, tokens, max_len)  -> (last logits, cache)
  decode_step(params, tok, cache)   -> (logits, cache)

A Model lives on one device: CUDA unless the caller passes
``device="cpu"``; it raises when CUDA is asked for and there is none.
Prefill and decode run eagerly under ``torch.inference_mode()``.
``param_dtype`` ("float32" or "bfloat16") makes trainable parameters;
``train_loss`` takes them (or :func:`transformer.param_tree`'s tree of
them, fake-quantized for QAT) and records the autograd graph.  Training
rwkv6 comes with slice 7c.
"""
from __future__ import annotations

from typing import Mapping, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.common import Device, resolve_device


class Model:
  def __init__(self, cfg: ModelConfig, device: Device = None):
    transformer.check_supported(cfg)
    self.cfg = cfg
    self.device = resolve_device(device, "build_model")

  def init(self, seed: int = 0, param_dtype: Optional[str] = None
           ) -> transformer.Transformer:
    """Random parameters on the model's device from ``seed``: a serving
    model, or a trainable one in ``param_dtype``."""
    return transformer.init_params(self.cfg, seed, self.device, param_dtype)

  def from_state(self, state: Mapping[str, torch.Tensor],
                 param_dtype: Optional[str] = None
                 ) -> transformer.Transformer:
    """Parameters on the model's device from a state dict (for example
    ``convert.params_from_jax``'s), trainable when ``param_dtype`` is
    given."""
    params = transformer.Transformer(self.cfg, self.device, param_dtype)
    params.load_state_dict(dict(state))
    return params

  def train_loss(self, params: Union[transformer.Transformer,
                                     transformer.Tree],
                 batch: Mapping[str, torch.Tensor], remat: bool = True):
    """(xent + 0.01 aux, {"xent", "aux", "tokens"}) of a batch of tokens
    and labels (B, S) on the model's device."""
    if isinstance(params, transformer.Transformer):
      params = transformer.param_tree(params)
    return transformer.train_loss(params, batch, self.cfg, remat=remat)

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
