"""Decoder-only LM (the port of ``repro.models.transformer``): parameters
as ``nn.Module``s and three layer kinds for serving, and the training
forward and loss for two of them.  Attention layers keep a per-layer KV cache,
optionally int8 (QUIDAM's precision axis applied to serving), and run
prefill through K6 and decode through K5; training runs them through K6
and its backward.  Their feed-forward is a dense MLP (swiglu, gelu or
relu2) or, on the layers ``cfg.block_pattern()`` marks, a capacity-routed
MoE whose aux loss enters the train loss.  RWKV-6 layers (time mix +
channel mix, attention-free) keep a recurrent state and run prefill
through K7 and decode through the per-token WKV6 update; training runs
them through K7 and its backward.  Mamba layers (jamba's hybrid, an
attention layer and seven Mamba layers a block) keep a recurrent state
and a conv window, and serve through ``ssm``'s eager scan; they train
with slice 8c.  Norms are rmsnorm, layernorm or olmo's non-parametric
layernorm; positions RoPE, a learned table or sinusoids; a vlm's
training batch may open with image embeddings.

Differences from the reference, none of them in the numbers:
  * the reference scans over stacked blocks; here the layers are a
    ``ModuleList`` walked in Python, and its sharding constraints have no
    counterpart on one card;
  * a serving model stores its matmul weights in the model dtype (the
    reference stores float32 and casts at every use: the same rounding); a
    trainable one stores them in its ``param_dtype`` (float32, the
    reference's, or bfloat16) and every matmul casts its weight to the
    activations' dtype at use, which for a serving model's weights does
    nothing; norm scales stay float32;
  * ``decode_step`` updates the cache in place (the reference returns a
    new one) so a step allocates no second cache, and the cache's
    ``length`` is a Python int, so that no step waits on the card for it;
  * training walks the layers as :func:`param_tree`'s per-layer list of
    leaves; :func:`stack_blocks` and :func:`unstack_blocks` go to and from
    the reference's tree, whose ``blocks/sub{i}`` leaves are stacked on
    ``n_blocks``.

Encoder-decoder models are ``models.encdec``'s.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.quant_decode_attn.ops import quantize_kv
from repro_torch.models import ssm
from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.common import (Device, Norm, apply_norm,
                                       apply_rope, dense_init, embed_init,
                                       frozen, model_dtype, rms_head_norm,
                                       rope_tables, sinusoidal_positions)
from repro_torch.models.ffn import MLP, MoE, apply_mlp, apply_moe

Cache = Dict[str, Any]
Tree = Dict[str, Any]

PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_trainable(cfg: ModelConfig) -> None:
  """Raise NotImplementedError for what serves in the port but does not
  train yet: Mamba layers (jamba's hybrid) and encoder-decoder models,
  whose training comes with slice 8c."""
  if cfg.family == "encdec" or "mamba" in cfg.layer_kinds():
    raise NotImplementedError(f"{cfg.name} serves in the port since slice "
                              "8b; its training comes with slice 8c")


# ---------------------------------------------------------------------------
# attention sub-layer
# ---------------------------------------------------------------------------

class Attention(nn.Module):
  """GQA projections, (d_in, d_out) like the reference, with qk-norm; the
  weights in the model dtype, or in ``dtype`` when given."""

  def __init__(self, cfg: ModelConfig, device: Device = None,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.cfg = cfg
    d, dt = cfg.d_model, dtype or model_dtype(cfg)
    e, ekv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    self.wq = frozen(torch.empty((d, e), dtype=dt, device=device))
    self.wkv = frozen(torch.empty((d, 2 * ekv), dtype=dt, device=device))
    self.wo = frozen(torch.empty((e, d), dtype=dt, device=device))
    if cfg.qk_norm:
      self.q_norm = frozen(torch.ones(cfg.head_dim, device=device))
      self.k_norm = frozen(torch.ones(cfg.head_dim, device=device))
    else:
      self.q_norm = self.k_norm = None

  def init_(self, gen: torch.Generator) -> "Attention":
    d, e = self.wq.shape
    self.wq.copy_(dense_init(gen, d, e))
    self.wkv.copy_(dense_init(gen, d, self.wkv.shape[1]))
    self.wo.copy_(dense_init(gen, e, d, scale=0.5))
    return self


def _project_qkv(x: torch.Tensor, cfg: ModelConfig, wq: torch.Tensor,
                 wkv: torch.Tensor, q_norm: Optional[torch.Tensor],
                 k_norm: Optional[torch.Tensor]):
  lead = x.shape[:-1]
  q = (x @ wq.to(x.dtype)).reshape(*lead, cfg.n_heads, cfg.head_dim)
  kv = (x @ wkv.to(x.dtype)).reshape(*lead, 2, cfg.n_kv_heads, cfg.head_dim)
  k, v = kv[..., 0, :, :], kv[..., 1, :, :]
  if cfg.qk_norm:
    q = rms_head_norm(q, q_norm)
    k = rms_head_norm(k, k_norm)
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
  q, k, v = _project_qkv(x, cfg, p.wq, p.wkv, p.q_norm, p.k_norm)
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
  return out @ p.wo.to(out.dtype), cache


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
  """One entry of :func:`layer_pattern`: attention or Mamba with a dense
  MLP or, where ``is_moe``, a MoE; or an RWKV layer, whose channel mix
  lives in its ``mix`` (``cm_*``), with no ``ffn``."""

  def __init__(self, cfg: ModelConfig, kind: str, is_moe: bool,
               device: Device = None, dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.kind, self.is_moe = kind, is_moe
    self.mix_norm = Norm(cfg, device)
    if kind == "rwkv":
      self.mix = ssm.RWKVMix(cfg, device, dtype)
    elif kind == "mamba":
      self.mix = ssm.MambaMix(cfg, device, dtype)
    else:
      self.mix = Attention(cfg, device, dtype)
    self.ffn_norm = Norm(cfg, device)
    if self.is_moe:
      self.ffn = MoE(cfg, device, dtype)
    elif kind != "rwkv":
      self.ffn = MLP(cfg, cfg.d_ff, device, dtype)

  def init_(self, gen: torch.Generator) -> "Layer":
    self.mix.init_(gen)
    if self.kind != "rwkv":
      self.ffn.init_(gen)
    return self

  def feed_forward(self, h: torch.Tensor) -> torch.Tensor:
    """The serving path's ffn on (B, S, d) or, for decode, (B, d)."""
    if not self.is_moe:
      return self.ffn(h)
    if h.dim() == 2:
      return self.ffn(h[:, None, :])[0][:, 0, :]
    return self.ffn(h)[0]


def layer_pattern(cfg: ModelConfig) -> List[Tuple[str, bool]]:
  """(kind, is_moe) of each of the ``n_layers`` layers: layer ``l`` is
  position ``l % P`` of the block pattern of ``P`` layers; an rwkv layer
  is never MoE (it builds no ffn, as the reference's ``init_layer``)."""
  pattern = [(kind, is_moe and kind != "rwkv")
             for kind, is_moe in cfg.block_pattern()]
  return [pattern[l % len(pattern)] for l in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

class Transformer(nn.Module):
  """Embedding, the layer stack, the final norm and the LM head (the
  embedding's transpose when tied).

  With ``param_dtype`` None it is a serving model: frozen leaves, matmul
  weights in the model dtype.  With ``param_dtype`` "float32" or
  "bfloat16" it is trainable: every leaf requires grad, the matmul
  weights, embedding and LM head are stored in ``param_dtype`` (the
  reference's ``make_train_state`` casts exactly its leaves of two or
  more dims) and the norm scales in float32."""

  def __init__(self, cfg: ModelConfig, device: Device = None,
               param_dtype: Optional[str] = None):
    super().__init__()
    if param_dtype is not None:
      check_trainable(cfg)
      if param_dtype not in PARAM_DTYPES:
        raise ValueError(f"param_dtype must be one of {sorted(PARAM_DTYPES)}"
                         f", got {param_dtype!r}")
    self.cfg = cfg
    dt = (model_dtype(cfg) if param_dtype is None
          else PARAM_DTYPES[param_dtype])
    self.embed = frozen(torch.empty((cfg.padded_vocab, cfg.d_model),
                                    dtype=dt, device=device))
    self.final_norm = Norm(cfg, device)
    self.layers = nn.ModuleList(Layer(cfg, kind, is_moe, device, dt)
                                for kind, is_moe in layer_pattern(cfg))
    if not cfg.tie_embeddings:
      self.lm_head = frozen(torch.empty((cfg.d_model, cfg.padded_vocab),
                                        dtype=dt, device=device))
    if cfg.pos_embed == "learned":
      self.pos_embed = frozen(torch.empty((cfg.max_position, cfg.d_model),
                                          dtype=dt, device=device))
    if param_dtype is not None:
      self.requires_grad_(True)

  @torch.no_grad()
  def init_(self, gen: torch.Generator) -> "Transformer":
    """Draw the reference's initialization, one float32 tensor at a time
    (the values differ from the reference's: another generator)."""
    cfg = self.cfg
    self.embed.copy_(embed_init(gen, cfg.padded_vocab, cfg.d_model))
    for layer in self.layers:
      layer.init_(gen)
    if not cfg.tie_embeddings:
      self.lm_head.copy_(dense_init(gen, cfg.d_model, cfg.padded_vocab))
    if cfg.pos_embed == "learned":
      self.pos_embed.copy_(embed_init(gen, cfg.max_position, cfg.d_model))
    return self


def init_params(cfg: ModelConfig, seed: int, device: torch.device,
                param_dtype: Optional[str] = None) -> Transformer:
  """A randomly initialized model on ``device``, drawn from a generator
  there seeded with ``seed`` (trainable when ``param_dtype`` is given)."""
  gen = torch.Generator(device=device).manual_seed(seed)
  return Transformer(cfg, device, param_dtype).init_(gen)


def lm_head_weight(params: Transformer, cfg: ModelConfig) -> torch.Tensor:
  if cfg.tie_embeddings:
    return params.embed.T
  return params.lm_head


def _add_positions(pos_embed: Optional[torch.Tensor], x: torch.Tensor,
                   positions: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
  """x (B, S, d) plus the learned table's rows at ``positions`` or the
  sinusoids of S positions; RoPE and no positions add nothing here."""
  if cfg.pos_embed == "learned":
    return x + pos_embed[positions].to(x.dtype)
  if cfg.pos_embed == "sinusoidal":
    pe = sinusoidal_positions(int(positions.shape[-1]), cfg.d_model,
                              x.device)
    return x + pe.to(x.dtype)
  return x


# ---------------------------------------------------------------------------
# parameter trees: the model's leaves by layer, and the reference's layout
# ---------------------------------------------------------------------------

def nest(flat: Mapping[str, Any]) -> Tree:
  """``{"layers.3.mix.wq": leaf, "embed": leaf, ...}`` (a state dict's
  names) as nested dicts, ``layers`` as a list of per-layer dicts."""
  tree: Tree = {}
  layers: Dict[int, Tree] = {}
  for name, leaf in flat.items():
    parts = name.split(".")
    node = tree
    if parts[0] == "layers":
      node = layers.setdefault(int(parts[1]), {})
      parts = parts[2:]
    for part in parts[:-1]:
      node = node.setdefault(part, {})
    node[parts[-1]] = leaf
  if layers:
    tree["layers"] = [layers[i] for i in range(len(layers))]
  return tree


def flatten(tree: Tree, is_leaf: Callable[[Any], bool] = lambda _: False
            ) -> Dict[str, Any]:
  """The inverse of :func:`nest`: dotted names to leaves; a node for which
  ``is_leaf`` holds is kept whole."""
  out: Dict[str, Any] = {}

  def walk(node, prefix):
    if isinstance(node, dict) and not is_leaf(node):
      for k, v in node.items():
        walk(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(node, list):
      for i, v in enumerate(node):
        walk(v, f"{prefix}.{i}")
    else:
      out[prefix] = node
  walk(tree, "")
  return out


def _zip_map(fn, trees):
  """``fn`` over the leaves of same-shaped nested dicts, leaf by leaf."""
  if isinstance(trees[0], dict):
    return {k: _zip_map(fn, [t[k] for t in trees]) for k in trees[0]}
  return fn(trees)


def _unzip(node, unstack, n: int) -> List[Any]:
  """A nested dict of stacked leaves as ``n`` nested dicts of slices."""
  if isinstance(node, dict):
    parts = {k: _unzip(v, unstack, n) for k, v in node.items()}
    return [{k: parts[k][i] for k in node} for i in range(n)]
  return list(unstack(node))


def stack_blocks(cfg: ModelConfig, tree: Tree,
                 stack: Callable = torch.stack) -> Tree:
  """A :func:`nest`-ed tree in the reference's layout: layer ``l = b * P +
  i`` of a pattern of ``P`` kinds goes to ``blocks/sub{i}``, each leaf
  stacked on a leading ``n_blocks`` axis by ``stack`` (``torch.stack``,
  which autograd follows, or ``np.stack``)."""
  period = len(cfg.block_pattern())
  out = {k: v for k, v in tree.items() if k != "layers"}
  out["blocks"] = {f"sub{i}": _zip_map(stack, tree["layers"][i::period])
                   for i in range(period)}
  return out


def unstack_blocks(cfg: ModelConfig, tree: Tree,
                   unstack: Callable = torch.unbind) -> Tree:
  """The inverse of :func:`stack_blocks`: the reference's tree (``unstack``
  splits a leaf on its first axis: ``torch.unbind``, or ``list`` for a
  numpy array) as a :func:`nest`-ed tree."""
  period = len(cfg.block_pattern())
  out = {k: v for k, v in tree.items() if k != "blocks"}
  layers: List[Any] = [None] * (cfg.n_blocks * period)
  for i in range(period):
    for b, layer in enumerate(_unzip(tree["blocks"][f"sub{i}"], unstack,
                                     cfg.n_blocks)):
      layers[b * period + i] = layer
  out["layers"] = layers
  return out


def param_tree(params: Transformer) -> Tree:
  """The model's own parameters (no copies) as a :func:`nest`-ed tree,
  the form the training forward walks."""
  return nest(dict(params.named_parameters()))


# ---------------------------------------------------------------------------
# training: the full-sequence forward and the chunked vocab loss
# ---------------------------------------------------------------------------

def _norm(p: Optional[Tree], x: torch.Tensor, cfg: ModelConfig
          ) -> torch.Tensor:
  """A pre-norm from its tree node, absent for ``layernorm_np``, which
  has no parameters."""
  p = p or {}
  return apply_norm(p.get("scale"), x, cfg, bias=p.get("bias"))


def apply_attn_train(p: Tree, x: torch.Tensor, cfg: ModelConfig,
                     rope_cs: Optional[Tuple[torch.Tensor, torch.Tensor]]
                     ) -> torch.Tensor:
  """Full-sequence causal attention through K6 and its backward (the plain
  version on the CPU).  x: (B, S, d)."""
  b, s, _ = x.shape
  q, k, v = _project_qkv(x, cfg, p["wq"], p["wkv"], p.get("q_norm"),
                         p.get("k_norm"))
  if rope_cs is not None:
    q = apply_rope(q, *rope_cs)
    k = apply_rope(k, *rope_cs)
  out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
  out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
  return out @ p["wo"].to(x.dtype)


def apply_layer_train(p: Tree, x: torch.Tensor, cfg: ModelConfig,
                      kind: str, is_moe: bool, rope_cs
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  """One pre-norm layer: attention + a dense MLP or a MoE, or the RWKV
  time mix + channel mix (no ffn); returns (x, aux loss)."""
  aux = torch.zeros((), dtype=torch.float32, device=x.device)
  if kind == "rwkv":
    out, _ = ssm.apply_rwkv_time_mix(p["mix"],
                                     _norm(p.get("mix_norm"), x, cfg), cfg)
    x = x + out
    return x + ssm.apply_rwkv_channel_mix(
        p["mix"], _norm(p.get("ffn_norm"), x, cfg), cfg), aux
  x = x + apply_attn_train(p["mix"], _norm(p.get("mix_norm"), x, cfg), cfg,
                           rope_cs)
  h = _norm(p.get("ffn_norm"), x, cfg)
  if is_moe:
    out, aux = apply_moe(p["ffn"], h, cfg)
    return x + out, aux
  return x + apply_mlp(p["ffn"], h, cfg), aux


def backbone(tree: Tree, x: torch.Tensor, cfg: ModelConfig, rope_cs,
             remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
  """Embedded inputs -> final hidden states; returns (x, aux_loss).  With
  ``remat`` each layer is checkpointed (the reference's ``jax.checkpoint``
  of a block): its activations are recomputed in the backward."""
  aux = torch.zeros((), dtype=torch.float32, device=x.device)
  for p, (kind, is_moe) in zip(tree["layers"], layer_pattern(cfg)):
    if remat:
      x, a = torch.utils.checkpoint.checkpoint(
          apply_layer_train, p, x, cfg, kind, is_moe, rope_cs,
          use_reentrant=False)
    else:
      x, a = apply_layer_train(p, x, cfg, kind, is_moe, rope_cs)
    aux = aux + a
  return _norm(tree.get("final_norm"), x, cfg), aux


def chunked_xent(tree: Tree, x: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Softmax cross-entropy over the padded vocab, ``loss_chunk_tokens``
  tokens at a time: x (B, S, d), labels and mask (B, S) -> (the masked
  mean, the token count, at least 1).  Each chunk's logits are f32 with
  -1e30 on the padded vocab columns."""
  b, s, d = x.shape
  w = (tree["embed"].T if cfg.tie_embeddings else tree["lm_head"]
       ).to(x.dtype)
  n = b * s
  chunk = min(cfg.loss_chunk_tokens, n)
  pad = (-n) % chunk
  xf = F.pad(x.reshape(n, d), (0, 0, 0, pad))
  lf = F.pad(labels.reshape(n).long(), (0, pad))
  mf = F.pad(mask.reshape(n).float(), (0, pad))
  vocab_bias = torch.where(
      torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size,
      0.0, -1e30).float()
  losses, counts = [], []
  for c in range(xf.shape[0] // chunk):
    rows = slice(c * chunk, (c + 1) * chunk)
    logits = (xf[rows] @ w).float() + vocab_bias
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, lf[rows, None])[:, 0]
    losses.append(torch.sum((logz - gold) * mf[rows]))
    counts.append(torch.sum(mf[rows]))
  total = torch.sum(torch.stack(losses))
  denom = torch.clamp_min(torch.sum(torch.stack(counts)), 1.0)
  return total / denom, denom


def train_loss(tree: Tree, batch: Mapping[str, torch.Tensor],
               cfg: ModelConfig, remat: bool = True
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
  """``tree`` (:func:`param_tree`'s form), ``batch`` tokens and labels (B,
  S) and, for a vlm, optionally ``img_embeds`` (B, I, d) -> (xent + 0.01
  aux, {"xent", "aux", "tokens"}).  Image embeddings go first, with zero
  labels and mask, and positions run over the whole sequence."""
  check_trainable(cfg)
  tokens, labels = batch["tokens"], batch["labels"]
  x = F.embedding(tokens, tree["embed"]).to(model_dtype(cfg))
  mask = torch.ones(labels.shape, dtype=torch.float32, device=x.device)
  if cfg.family == "vlm" and "img_embeds" in batch:
    img = batch["img_embeds"].to(x.dtype)
    b, n_img = img.shape[:2]
    x = torch.cat([img, x], dim=1)
    labels = torch.cat([torch.zeros((b, n_img), dtype=labels.dtype,
                                    device=x.device), labels], dim=1)
    mask = torch.cat([torch.zeros((b, n_img), dtype=torch.float32,
                                  device=x.device), mask], dim=1)
  positions = torch.arange(x.shape[1], device=x.device)
  rope_cs = None
  if cfg.pos_embed == "rope":
    rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
  x = _add_positions(tree.get("pos_embed"), x, positions, cfg)
  x, aux = backbone(tree, x, cfg, rope_cs, remat=remat)
  loss, denom = chunked_xent(tree, x, labels, mask, cfg)
  return loss + 0.01 * aux, {"xent": loss, "aux": aux, "tokens": denom}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Device = None) -> Cache:
  make = {"attn": lambda: init_attn_cache(cfg, batch, max_len, device),
          "mamba": lambda: ssm.init_mamba_cache(cfg, batch, device),
          "rwkv": lambda: ssm.init_rwkv_cache(cfg, batch, device)}
  return {"layers": [make[kind]() for kind, _ in layer_pattern(cfg)],
          "length": 0}


def decode_step(params: Transformer, tokens: torch.Tensor, cache: Cache,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
  """tokens (B,) -> (logits (B, V), cache).  One token for the batch; the
  cache is updated in place and returned."""
  length = int(cache["length"])
  b = tokens.shape[0]
  dev = tokens.device
  x = F.embedding(tokens, params.embed).to(model_dtype(cfg))
  if cfg.pos_embed == "learned":
    x = x + params.pos_embed[length].to(x.dtype)[None]
  rope_cs = None
  if cfg.pos_embed == "rope":
    pos = torch.full((b,), length, dtype=torch.int32, device=dev)
    rope_cs = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
  lens = None
  if "attn" in cfg.layer_kinds():
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
    if layer.kind == "mamba":
      out, _ = ssm.mamba_decode_step(layer.mix, h, c, cfg)
    else:
      out, _ = apply_attn_decode(layer.mix, h, c, length, cfg, rope_cs,
                                 lens)
    x = x + out
    x = x + layer.feed_forward(layer.ffn_norm(x))
  x = params.final_norm(x)
  logits = x @ lm_head_weight(params, cfg).to(x.dtype)
  cache["length"] = length + 1
  return logits[:, :cfg.vocab_size], cache


def prefill(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int) -> Tuple[torch.Tensor, Cache]:
  """Run the full prompt, build the cache; returns (last logits, cache)."""
  b, s = tokens.shape
  x = F.embedding(tokens, params.embed).to(model_dtype(cfg))
  positions = torch.arange(s, device=tokens.device)
  x = _add_positions(getattr(params, "pos_embed", None), x, positions, cfg)
  rope_cs = None
  if cfg.pos_embed == "rope":
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
    if layer.kind == "mamba":
      out, c = ssm.mamba_prefill(layer.mix, h, cfg)
      x = x + out
      layer_caches.append(c)
      x = x + layer.feed_forward(layer.ffn_norm(x))
      continue
    mix = layer.mix
    q, k, v = _project_qkv(h, cfg, mix.wq, mix.wkv, mix.q_norm, mix.k_norm)
    if rope_cs is not None:
      q = apply_rope(q, *rope_cs)
      k = apply_rope(k, *rope_cs)
    out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    x = x + out.reshape(b, s, -1) @ mix.wo.to(x.dtype)
    layer_caches.append(prefill_attn_cache(cfg, k, v, max_len))
    x = x + layer.feed_forward(layer.ffn_norm(x))
  x = params.final_norm(x)
  logits = x[:, -1, :] @ lm_head_weight(params, cfg).to(x.dtype)
  cache = {"layers": layer_caches, "length": s}
  return logits[:, :cfg.vocab_size], cache

