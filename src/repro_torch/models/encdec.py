"""Encoder-decoder transformer, whisper's backbone (the port of
``repro.models.encdec``), for serving.

The conv audio frontend is a stub, as in the reference: the input is
precomputed frame embeddings (B, T, d).  The encoder is bidirectional
attention blocks over sinusoidal positions (K6 with ``causal=False``);
each decoder block is causal self-attention (K6 in prefill, K5 over an
int8 cache in decode), cross-attention over the encoder states and an
MLP, over learned positions.  Prefill computes each layer's cross K/V
from the encoder states once and keeps them dense in the model dtype,
(B, Hkv, T, D); its cross-attention runs K6 with S_q != S_k, and decode
attends over the kept K/V through the plain ``decode_attention`` path, as
the reference does (no int8, no K5).  Training comes with slice 8c of
the port: ``train_loss`` raises.

Differences from the reference, none of them in the numbers: the blocks
are ``ModuleList``s walked in Python (the reference scans stacked
blocks); decode updates the self-attention cache in place; the encoder
states' projection for cross-attention computes K and V only (the
reference also computes a q it drops).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.attention import (cross_attention, decode_attention,
                                          flash_attention)
from repro_torch.models.common import (Device, Norm, dense_init, embed_init,
                                       frozen, model_dtype, rms_head_norm,
                                       sinusoidal_positions)
from repro_torch.models.ffn import MLP
from repro_torch.models.transformer import (Attention, apply_attn_decode,
                                            init_attn_cache, lm_head_weight,
                                            prefill_attn_cache)

Cache = Dict[str, Any]


class EncBlock(nn.Module):
  """Bidirectional self-attention and an MLP, each pre-normed."""

  def __init__(self, cfg: ModelConfig, device: Device = None,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.attn_norm = Norm(cfg, device)
    self.attn = Attention(cfg, device, dtype)
    self.ffn_norm = Norm(cfg, device)
    self.ffn = MLP(cfg, cfg.d_ff, device, dtype)

  def init_(self, gen: torch.Generator) -> "EncBlock":
    self.attn.init_(gen)
    self.ffn.init_(gen)
    return self


class DecBlock(nn.Module):
  """Causal self-attention (``self``), cross-attention (``cross``) and an
  MLP, each pre-normed; the reference's leaf names."""

  def __init__(self, cfg: ModelConfig, device: Device = None,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.self_norm = Norm(cfg, device)
    self.self = Attention(cfg, device, dtype)
    self.cross_norm = Norm(cfg, device)
    self.cross = Attention(cfg, device, dtype)
    self.ffn_norm = Norm(cfg, device)
    self.ffn = MLP(cfg, cfg.d_ff, device, dtype)

  def init_(self, gen: torch.Generator) -> "DecBlock":
    self.self.init_(gen)
    self.cross.init_(gen)
    self.ffn.init_(gen)
    return self


class EncDec(nn.Module):
  """The token embedding, the learned decoder positions (``max_position``
  rows), ``n_encoder_layers`` encoder blocks and their final norm,
  ``n_layers`` decoder blocks, the final norm and the LM head, the
  reference's ``init_params`` leaves; matmul weights in the model dtype,
  norms in float32.  Serving only: a ``param_dtype`` raises."""

  def __init__(self, cfg: ModelConfig, device: Device = None,
               param_dtype: Optional[str] = None):
    super().__init__()
    if param_dtype is not None:
      transformer.check_trainable(cfg)
    self.cfg = cfg
    d, dt = cfg.d_model, model_dtype(cfg)
    self.embed = frozen(torch.empty((cfg.padded_vocab, d), dtype=dt,
                                    device=device))
    self.pos_embed = frozen(torch.empty((cfg.max_position, d), dtype=dt,
                                        device=device))
    self.enc_blocks = nn.ModuleList(EncBlock(cfg, device)
                                    for _ in range(cfg.n_encoder_layers))
    self.enc_norm = Norm(cfg, device)
    self.dec_blocks = nn.ModuleList(DecBlock(cfg, device)
                                    for _ in range(cfg.n_layers))
    self.final_norm = Norm(cfg, device)
    self.lm_head = frozen(torch.empty((d, cfg.padded_vocab), dtype=dt,
                                      device=device))

  @torch.no_grad()
  def init_(self, gen: torch.Generator) -> "EncDec":
    """Draw the reference's initialization, one float32 tensor at a time
    (the values differ from the reference's: another generator)."""
    cfg = self.cfg
    self.embed.copy_(embed_init(gen, cfg.padded_vocab, cfg.d_model))
    self.pos_embed.copy_(embed_init(gen, cfg.max_position, cfg.d_model))
    for block in (*self.enc_blocks, *self.dec_blocks):
      block.init_(gen)
    self.lm_head.copy_(dense_init(gen, cfg.d_model, cfg.padded_vocab))
    return self


def init_params(cfg: ModelConfig, seed: int, device: torch.device,
                param_dtype: Optional[str] = None) -> EncDec:
  """A randomly initialized model on ``device`` from ``seed``."""
  gen = torch.Generator(device=device).manual_seed(seed)
  return EncDec(cfg, device, param_dtype).init_(gen)


def _q(p: Attention, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
  """x (..., d) -> q (..., H, D), qk-normed when the config says so."""
  q = (x @ p.wq.to(x.dtype)).reshape(*x.shape[:-1], cfg.n_heads,
                                     cfg.head_dim)
  return rms_head_norm(q, p.q_norm) if cfg.qk_norm else q


def _kv(p: Attention, x: torch.Tensor, cfg: ModelConfig
        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """x (B, T, d) -> k, v (B, T, Hkv, D), views of one projection."""
  kv = (x @ p.wkv.to(x.dtype)).reshape(*x.shape[:-1], 2, cfg.n_kv_heads,
                                       cfg.head_dim)
  k, v = kv[..., 0, :, :], kv[..., 1, :, :]
  return (rms_head_norm(k, p.k_norm) if cfg.qk_norm else k), v


def encode(params: EncDec, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
  """frames (B, T, d) -> encoder states (B, T, d) in the model dtype."""
  x = frames.to(model_dtype(cfg))
  x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)
  for block in params.enc_blocks:
    h = block.attn_norm(x)
    a = block.attn
    out = flash_attention(_q(a, h, cfg), *_kv(a, h, cfg), causal=False)
    x = x + out.reshape(*h.shape[:-1], -1) @ a.wo.to(x.dtype)
    x = x + block.ffn(block.ffn_norm(x))
  return params.enc_norm(x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Device = None) -> Cache:
  """Each decoder layer's self-attention cache, and its cross K/V
  (B, Hkv, encoder_seq, D) in the model dtype, which prefill fills."""
  shape = (batch, cfg.n_kv_heads, cfg.encoder_seq, cfg.head_dim)
  dt = model_dtype(cfg)
  return {"layers": [{"self": init_attn_cache(cfg, batch, max_len, device),
                      "cross_k": torch.zeros(shape, dtype=dt, device=device),
                      "cross_v": torch.zeros(shape, dtype=dt, device=device)}
                     for _ in range(cfg.n_layers)],
          "length": 0}


def prefill(params: EncDec, batch: Mapping[str, torch.Tensor],
            cfg: ModelConfig, max_len: int) -> Tuple[torch.Tensor, Cache]:
  """Encode ``batch["enc_frames"]`` (B, T, d), consume the prompt
  ``batch["tokens"]`` (B, S) and build the decoder's caches; returns
  (the last position's logits (B, V), cache)."""
  enc = encode(params, batch["enc_frames"], cfg)
  tokens = batch["tokens"]
  b, s = tokens.shape
  dt = model_dtype(cfg)
  x = F.embedding(tokens, params.embed).to(dt) + params.pos_embed[:s].to(dt)
  layers = []
  for block in params.dec_blocks:
    h = block.self_norm(x)
    sa = block.self
    q, (k, v) = _q(sa, h, cfg), _kv(sa, h, cfg)
    out = flash_attention(q, k, v, causal=True)
    x = x + out.reshape(b, s, -1) @ sa.wo.to(x.dtype)
    ca = block.cross
    ek, ev = _kv(ca, enc, cfg)
    out = cross_attention(_q(ca, block.cross_norm(x), cfg), ek, ev)
    x = x + out.reshape(b, s, -1) @ ca.wo.to(x.dtype)
    layers.append({"self": prefill_attn_cache(cfg, k, v, max_len),
                   "cross_k": ek.permute(0, 2, 1, 3).to(dt).contiguous(),
                   "cross_v": ev.permute(0, 2, 1, 3).to(dt).contiguous()})
    x = x + block.ffn(block.ffn_norm(x))
  x = params.final_norm(x)
  logits = x[:, -1] @ lm_head_weight(params, cfg).to(x.dtype)
  return logits[:, :cfg.vocab_size], {"layers": layers, "length": s}


def decode_step(params: EncDec, tokens: torch.Tensor, cache: Cache,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
  """tokens (B,) against the self-attention cache, updated in place, and
  the fixed cross K/V -> (logits (B, V), cache)."""
  length = int(cache["length"])
  b = tokens.shape[0]
  dev, dt = tokens.device, model_dtype(cfg)
  x = F.embedding(tokens, params.embed).to(dt) + \
      params.pos_embed[length].to(dt)[None]
  lens = torch.full((b,), length + 1, dtype=torch.int32, device=dev)
  enc_len = torch.full((b,), cfg.encoder_seq, dtype=torch.int32, device=dev)
  for block, c in zip(params.dec_blocks, cache["layers"]):
    out, _ = apply_attn_decode(block.self, block.self_norm(x), c["self"],
                               length, cfg, None, lens)
    x = x + out
    ca = block.cross
    out = decode_attention(_q(ca, block.cross_norm(x), cfg), c["cross_k"],
                           c["cross_v"], enc_len)
    x = x + out.reshape(b, -1) @ ca.wo.to(x.dtype)
    x = x + block.ffn(block.ffn_norm(x))
  x = params.final_norm(x)
  logits = x @ lm_head_weight(params, cfg).to(x.dtype)
  cache["length"] = length + 1
  return logits[:, :cfg.vocab_size], cache


def train_loss(params: Any, batch: Mapping[str, torch.Tensor],
               cfg: ModelConfig, remat: bool = True):
  """Raises: the encoder-decoder's training comes with slice 8c."""
  transformer.check_trainable(cfg)
