"""Model facade: ``build_model(cfg) -> Model`` with the reference's API
(the port of ``repro.models.model``): decoder LMs with attention layers
and dense MLPs or MoE (qwen3, olmo, granite, minitron, mixtral,
qwen2-moe, pixtral's text backbone), RWKV-6 layers (rwkv6-1.6b) or
jamba's hybrid of attention and Mamba layers, all ``transformer``'s; and
whisper's encoder-decoder, ``encdec``'s.

  init(seed[, param_dtype])         -> params (a Transformer or EncDec)
  from_state(state[, param_dtype])  -> params from a state dict
  train_loss(params, batch, remat)  -> (loss, metrics)
  init_cache(batch, max_len)        -> decode cache
  prefill(params, batch, max_len)   -> (last logits, cache)
  decode_step(params, tok, cache)   -> (logits, cache)

``prefill`` takes a tensor of tokens (B, S) or a batch dict, as the
reference's does; an encoder-decoder's takes the dict ``{"tokens",
"enc_frames"}`` only.

A Model lives on one device: CUDA unless the caller passes
``device="cpu"``; it raises when CUDA is asked for and there is none.
Prefill and decode run eagerly under ``torch.inference_mode()``.
``param_dtype`` ("float32" or "bfloat16") makes trainable parameters;
``train_loss`` takes them (or :func:`transformer.param_tree`'s tree of
them, fake-quantized for QAT) and records the autograd graph, for
attention and RWKV layers; jamba's Mamba layers and the encoder-decoder
serve only, and their training raises, naming slice 8c.
"""
from __future__ import annotations

from typing import Mapping, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.common import Device, resolve_device

Params = Union[transformer.Transformer, encdec.EncDec]


class Model:
  def __init__(self, cfg: ModelConfig, device: Device = None):
    self.cfg = cfg
    self.device = resolve_device(device, "build_model")
    self._impl = encdec if cfg.family == "encdec" else transformer

  def init(self, seed: int = 0, param_dtype: Optional[str] = None) -> Params:
    """Random parameters on the model's device from ``seed``: a serving
    model, or a trainable one in ``param_dtype``."""
    return self._impl.init_params(self.cfg, seed, self.device, param_dtype)

  def from_state(self, state: Mapping[str, torch.Tensor],
                 param_dtype: Optional[str] = None) -> Params:
    """Parameters on the model's device from a state dict (for example
    ``convert.params_from_jax``'s), trainable when ``param_dtype`` is
    given."""
    cls = (encdec.EncDec if self._impl is encdec
           else transformer.Transformer)
    params = cls(self.cfg, self.device, param_dtype)
    params.load_state_dict(dict(state))
    return params

  def train_loss(self, params: Union[transformer.Transformer,
                                     transformer.Tree],
                 batch: Mapping[str, torch.Tensor], remat: bool = True):
    """(xent + 0.01 aux, {"xent", "aux", "tokens"}) of a batch of tokens
    and labels (B, S), and for a vlm optionally ``img_embeds`` (B, I, d),
    on the model's device."""
    if isinstance(params, transformer.Transformer):
      params = transformer.param_tree(params)
    return self._impl.train_loss(params, batch, self.cfg, remat=remat)

  @torch.inference_mode()
  def init_cache(self, batch: int, max_len: int) -> transformer.Cache:
    return self._impl.init_cache(self.cfg, batch, max_len, self.device)

  @torch.inference_mode()
  def prefill(self, params: Params,
              batch: Union[torch.Tensor, Mapping[str, torch.Tensor]],
              max_len: int):
    """tokens (B, S), or ``{"tokens": ...}`` (and ``"enc_frames"`` (B, T,
    d) for an encoder-decoder) -> (last logits (B, V), cache)."""
    if self._impl is encdec:
      if not isinstance(batch, Mapping):
        raise ValueError(f"{self.cfg.name} is an encoder-decoder: its "
                         "prefill takes {'tokens', 'enc_frames'}, not a "
                         "tensor of tokens")
      return encdec.prefill(params, batch, self.cfg, max_len)
    tokens = batch["tokens"] if isinstance(batch, Mapping) else batch
    return transformer.prefill(params, tokens, self.cfg, max_len)

  @torch.inference_mode()
  def decode_step(self, params: Params, tokens: torch.Tensor,
                  cache: transformer.Cache):
    return self._impl.decode_step(params, tokens, cache, self.cfg)


def build_model(cfg: ModelConfig, device: Device = None) -> Model:
  return Model(cfg, device)
