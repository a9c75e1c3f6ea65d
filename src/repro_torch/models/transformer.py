"""Decoder-only LM for serving (the port of ``repro.models.transformer``):
parameters as ``nn.Module``s and two layer kinds.  Attention layers (with
a dense SwiGLU MLP) keep a per-layer KV cache, optionally int8 (QUIDAM's
precision axis applied to serving), and run prefill through K6 and decode
through K5.  RWKV-6 layers (time mix + channel mix, attention-free) keep a
recurrent state and run prefill through K7 and decode through the
per-token WKV6 update.

Differences from the reference, none of them in the numbers:
  * the reference scans over stacked blocks; here the layers are a
    ``ModuleList`` walked in Python, and its sharding constraints have no
    counterpart on one card;
  * matmul weights are stored in the model dtype (the reference stores
    float32 and casts at every use: the same rounding); norm scales stay
    float32;
  * ``decode_step`` updates the cache in place (the reference returns a
    new one) so a step allocates no second cache, and the cache's
    ``length`` is a Python int, so that no step waits on the card for it.

Mamba, MoE, encoder-decoder and training raise ``NotImplementedError``
naming the slice of the port that brings them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.quant_decode_attn.ops import quantize_kv
from repro_torch.models import ssm
from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.common import (Device, Norm, apply_rope,
                                       dense_init, embed_init, frozen,
                                       model_dtype, rms_head_norm,
                                       rope_tables)
from repro_torch.models.ffn import MLP

Cache = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
  """Raise NotImplementedError for what this slice of the port lacks."""
  reasons = []
  if cfg.family == "hybrid":
    reasons.append("mamba layers come with slice 8 (the rest of the zoo)")
  if cfg.family == "encdec":
    reasons.append("encoder-decoder models come with slice 8")
  if cfg.n_experts:
    reasons.append("MoE layers come with slice 8")
  if cfg.pos_embed not in ("rope", "none"):
    reasons.append(f"{cfg.pos_embed} positions come with slice 8")
  if cfg.norm not in ("rmsnorm", "layernorm"):
    reasons.append(f"{cfg.norm} comes with slice 8")
  # an rwkv layer has no MLP: its channel mix ignores mlp_variant
  if cfg.family != "ssm" and cfg.mlp_variant != "swiglu":
    reasons.append(f"{cfg.mlp_variant} MLPs come with slice 8")
  if reasons:
    raise NotImplementedError(f"{cfg.name}: " + "; ".join(reasons))


# ---------------------------------------------------------------------------
# attention sub-layer
# ---------------------------------------------------------------------------

class Attention(nn.Module):
  """GQA projections, (d_in, d_out) like the reference, with qk-norm."""

  def __init__(self, cfg: ModelConfig, device: Device = None):
    super().__init__()
    self.cfg = cfg
    d, dt = cfg.d_model, model_dtype(cfg)
    e, ekv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    self.wq = frozen(torch.empty((d, e), dtype=dt, device=device))
    self.wkv = frozen(torch.empty((d, 2 * ekv), dtype=dt, device=device))
    self.wo = frozen(torch.empty((e, d), dtype=dt, device=device))
    if cfg.qk_norm:
      self.q_norm = frozen(torch.ones(cfg.head_dim, device=device))
      self.k_norm = frozen(torch.ones(cfg.head_dim, device=device))

  def init_(self, gen: torch.Generator) -> "Attention":
    d, e = self.wq.shape
    self.wq.copy_(dense_init(gen, d, e))
    self.wkv.copy_(dense_init(gen, d, self.wkv.shape[1]))
    self.wo.copy_(dense_init(gen, e, d, scale=0.5))
    return self


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig):
  lead = x.shape[:-1]
  q = (x @ p.wq).reshape(*lead, cfg.n_heads, cfg.head_dim)
  kv = (x @ p.wkv).reshape(*lead, 2, cfg.n_kv_heads, cfg.head_dim)
  k, v = kv[..., 0, :, :], kv[..., 1, :, :]
  if cfg.qk_norm:
    q = rms_head_norm(q, p.q_norm)
    k = rms_head_norm(k, p.k_norm)
  return q, k, v


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------

def _cache_len(cfg: ModelConfig, max_len: int) -> int:
  return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    device: Device = None) -> Cache:
  s = _cache_len(cfg, max_len)
  shape = (batch, cfg.n_kv_heads, s, cfg.head_dim)
  if cfg.kv_quant == "int8":
    return {
        "k_codes": torch.zeros(shape, dtype=torch.int8, device=device),
        "v_codes": torch.zeros(shape, dtype=torch.int8, device=device),
        "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
        "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
    }
  dt = model_dtype(cfg)
  return {"k": torch.zeros(shape, dtype=dt, device=device),
          "v": torch.zeros(shape, dtype=dt, device=device)}


def _quant_kv_token(k: torch.Tensor, v: torch.Tensor):
  """(B, Hkv, D) -> int8 codes + scales (per b, h)."""
  return quantize_kv(k.float(), v.float())


def _cache_write_token(cache: Cache, k: torch.Tensor, v: torch.Tensor,
                       pos: int, cfg: ModelConfig) -> Cache:
  """Write one token's (B, Hkv, D) K/V at ``pos``, in place."""
  s = (cache["k_codes"] if cfg.kv_quant == "int8" else cache["k"]).shape[2]
  slot = pos % s if cfg.sliding_window else min(pos, s - 1)
  if cfg.kv_quant == "int8":
    kc, ks, vc, vs = _quant_kv_token(k, v)
    cache["k_codes"][:, :, slot] = kc
    cache["v_codes"][:, :, slot] = vc
    cache["k_scale"][:, :, slot] = ks
    cache["v_scale"][:, :, slot] = vs
  else:
    cache["k"][:, :, slot] = k
    cache["v"][:, :, slot] = v
  return cache


def apply_attn_decode(p: Attention, x: torch.Tensor, cache: Cache,
                      length: int, cfg: ModelConfig,
                      rope_cs: Optional[Tuple[torch.Tensor, torch.Tensor]],
                      lens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
  """x: (B, d) single token; length: tokens so far.  ``rope_cs`` (None
  without RoPE) and ``lens``, the (B,) fill after this token, are the
  step's, shared by every layer."""
  b = x.shape[0]
  q, k, v = _project_qkv(p, x, cfg)            # (B, H / Hkv, hd)
  if rope_cs is not None:
    q = apply_rope(q, *rope_cs)
    k = apply_rope(k, *rope_cs)
  cache = _cache_write_token(cache, k, v, length, cfg)
  ring = bool(cfg.sliding_window)
  if cfg.kv_quant == "int8":
    out = decode_attention(q, cache["k_codes"], cache["v_codes"], lens,
                           cache["k_scale"], cache["v_scale"], ring=ring)
  else:
    out = decode_attention(q, cache["k"], cache["v"], lens, ring=ring)
  out = out.reshape(b, cfg.n_heads * cfg.head_dim)
  return out @ p.wo, cache


def prefill_attn_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                       max_len: int) -> Cache:
  """Bulk-build a cache from full-seq K/V (B, S, Hkv, D) after prefill."""
  s = k.shape[1]
  cap = _cache_len(cfg, max_len)
  kh = k.permute(0, 2, 1, 3).contiguous()   # (B, Hkv, S, D)
  vh = v.permute(0, 2, 1, 3).contiguous()
  if cfg.sliding_window and s > cap:
    # keep the last `window` positions; ring alignment: slot = pos % cap
    shift = s % cap
    kh = torch.roll(kh[:, :, -cap:], shift, dims=2)
    vh = torch.roll(vh[:, :, -cap:], shift, dims=2)
  pad = cap - kh.shape[2]
  if pad < 0:
    raise ValueError(f"a prompt of {s} tokens does not fit max_len {cap}")
  if pad:
    kh = F.pad(kh, (0, 0, 0, pad))
    vh = F.pad(vh, (0, 0, 0, pad))
  if cfg.kv_quant == "int8":
    kc, ks, vc, vs = quantize_kv(kh.float(), vh.float())
    return {"k_codes": kc, "v_codes": vc, "k_scale": ks, "v_scale": vs}
  dt = model_dtype(cfg)
  return {"k": kh.to(dt), "v": vh.to(dt)}


# ---------------------------------------------------------------------------
# one layer = token mixer + ffn (pre-norm)
# ---------------------------------------------------------------------------

class Layer(nn.Module):
  """Attention + dense MLP, or an RWKV layer, whose channel mix lives in
  its ``mix`` (``cm_*``), with no ``ffn``."""

  def __init__(self, cfg: ModelConfig, device: Device = None):
    super().__init__()
    self.kind = cfg.layer_kinds()[0]
    self.mix_norm = Norm(cfg, device)
    if self.kind == "rwkv":
      self.mix = ssm.RWKVMix(cfg, device)
    else:
      self.mix = Attention(cfg, device)
    self.ffn_norm = Norm(cfg, device)
    if self.kind != "rwkv":
      self.ffn = MLP(cfg, cfg.d_ff, device)

  def init_(self, gen: torch.Generator) -> "Layer":
    self.mix.init_(gen)
    if self.kind != "rwkv":
      self.ffn.init_(gen)
    return self


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

class Transformer(nn.Module):
  """Embedding, the layer stack, the final norm and the LM head (the
  embedding's transpose when tied)."""

  def __init__(self, cfg: ModelConfig, device: Device = None):
    super().__init__()
    check_supported(cfg)
    self.cfg = cfg
    dt = model_dtype(cfg)
    self.embed = frozen(torch.empty((cfg.padded_vocab, cfg.d_model),
                                    dtype=dt, device=device))
    self.final_norm = Norm(cfg, device)
    self.layers = nn.ModuleList(Layer(cfg, device)
                                for _ in range(cfg.n_layers))
    if not cfg.tie_embeddings:
      self.lm_head = frozen(torch.empty((cfg.d_model, cfg.padded_vocab),
                                        dtype=dt, device=device))

  def init_(self, gen: torch.Generator) -> "Transformer":
    """Draw the reference's initialization, one float32 tensor at a time
    (the values differ from the reference's: another generator)."""
    cfg = self.cfg
    self.embed.copy_(embed_init(gen, cfg.padded_vocab, cfg.d_model))
    for layer in self.layers:
      layer.init_(gen)
    if not cfg.tie_embeddings:
      self.lm_head.copy_(dense_init(gen, cfg.d_model, cfg.padded_vocab))
    return self


def init_params(cfg: ModelConfig, seed: int,
                device: torch.device) -> Transformer:
  """A randomly initialized model on ``device``, drawn from a generator
  there seeded with ``seed``."""
  gen = torch.Generator(device=device).manual_seed(seed)
  return Transformer(cfg, device).init_(gen)


def lm_head_weight(params: Transformer, cfg: ModelConfig) -> torch.Tensor:
  if cfg.tie_embeddings:
    return params.embed.T
  return params.lm_head


def train_loss(*args, **kwargs):
  raise NotImplementedError("training comes with slice 7b of the port")


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Device = None) -> Cache:
  check_supported(cfg)
  if cfg.family == "ssm":
    layers = [ssm.init_rwkv_cache(cfg, batch, device)
              for _ in range(cfg.n_layers)]
  else:
    layers = [init_attn_cache(cfg, batch, max_len, device)
              for _ in range(cfg.n_layers)]
  return {"layers": layers, "length": 0}


def decode_step(params: Transformer, tokens: torch.Tensor, cache: Cache,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
  """tokens (B,) -> (logits (B, V), cache).  One token for the batch; the
  cache is updated in place and returned."""
  length = int(cache["length"])
  b = tokens.shape[0]
  dev = tokens.device
  x = F.embedding(tokens, params.embed)
  rope_cs = None
  if cfg.pos_embed == "rope":
    pos = torch.full((b,), length, dtype=torch.int32, device=dev)
    rope_cs = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
  lens = None
  if cfg.family != "ssm":
    lens = torch.full((b,), length + 1, dtype=torch.int32, device=dev)
  layer_caches: List[Cache] = cache["layers"]
  for layer, c in zip(params.layers, layer_caches):
    h = layer.mix_norm(x)
    if layer.kind == "rwkv":
      out, _ = ssm.rwkv_decode_step(layer.mix, h, c, cfg)
      x = x + out
      h2 = layer.ffn_norm(x)
      x = x + ssm.rwkv_channel_decode(layer.mix, h2, c["cm_prev"], cfg)
      c["cm_prev"].copy_(h2)
      continue
    out, _ = apply_attn_decode(layer.mix, h, c, length, cfg, rope_cs, lens)
    x = x + out
    x = x + layer.ffn(layer.ffn_norm(x))
  x = params.final_norm(x)
  logits = x @ lm_head_weight(params, cfg)
  cache["length"] = length + 1
  return logits[:, :cfg.vocab_size], cache


def prefill(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int) -> Tuple[torch.Tensor, Cache]:
  """Run the full prompt, build the cache; returns (last logits, cache)."""
  b, s = tokens.shape
  x = F.embedding(tokens, params.embed)
  rope_cs = None
  if cfg.pos_embed == "rope":
    positions = torch.arange(s, device=tokens.device)
    rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
  layer_caches = []
  for layer in params.layers:
    h = layer.mix_norm(x)
    if layer.kind == "rwkv":
      # from a zero state; the cache keeps K7's final state and the last
      # normed inputs of both mixes
      out, s_final = ssm.apply_rwkv_time_mix(layer.mix, h, cfg)
      x = x + out
      h2 = layer.ffn_norm(x)
      x = x + ssm.apply_rwkv_channel_mix(layer.mix, h2, cfg)
      layer_caches.append({"s": s_final, "tm_prev": h[:, -1].clone(),
                           "cm_prev": h2[:, -1].clone()})
      continue
    q, k, v = _project_qkv(layer.mix, h, cfg)
    if rope_cs is not None:
      q = apply_rope(q, *rope_cs)
      k = apply_rope(k, *rope_cs)
    out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    x = x + out.reshape(b, s, -1) @ layer.mix.wo
    layer_caches.append(prefill_attn_cache(cfg, k, v, max_len))
    x = x + layer.ffn(layer.ffn_norm(x))
  x = params.final_norm(x)
  logits = x[:, -1, :] @ lm_head_weight(params, cfg)
  cache = {"layers": layer_caches, "length": s}
  return logits[:, :cfg.vocab_size], cache

