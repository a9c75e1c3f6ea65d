"""Model configuration schema and registry (the port's copy of
``repro.configs.base``).

Field names, defaults, the derived properties and the parameter and FLOP
accounting are the reference's, so a configuration compares field by
field with its original, and any of the reference's configurations,
rebuilt here field by field, counts the same parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

VOCAB_PAD_MULTIPLE = 256  # Megatron-style padding of the vocab


@dataclasses.dataclass(frozen=True)
class ModelConfig:
  """One architecture; the fields of the reference's ModelConfig."""
  name: str
  family: str                 # dense | moe | hybrid | ssm | encdec | vlm
  n_layers: int
  d_model: int
  n_heads: int                # 0 => attention-free architecture
  n_kv_heads: int
  head_dim: int
  d_ff: int
  vocab_size: int

  # block variations
  mlp_variant: str = "swiglu"          # swiglu | gelu | relu2
  norm: str = "rmsnorm"                # rmsnorm | layernorm | layernorm_np
  qk_norm: bool = False
  pos_embed: str = "rope"              # rope | learned | sinusoidal | none
  rope_theta: float = 10_000.0
  tie_embeddings: bool = False
  sliding_window: int = 0              # 0 = full attention
  max_position: int = 1 << 20

  # MoE
  n_experts: int = 0
  n_experts_active: int = 0
  n_shared_experts: int = 0
  d_ff_expert: int = 0
  d_ff_shared: int = 0
  moe_period: int = 1
  moe_offset: int = 0
  capacity_factor: float = 1.25
  moe_group_size: int = 512

  # hybrid / ssm
  attn_period: int = 0
  mamba_d_state: int = 16
  mamba_d_conv: int = 4
  mamba_expand: int = 2
  ssm_chunk: int = 128

  # encoder-decoder / vlm frontends
  n_encoder_layers: int = 0
  encoder_seq: int = 1500
  n_image_tokens: int = 0

  # numerics
  kv_quant: str = "none"               # none | int8 (serving KV cache)
  dtype: str = "bfloat16"
  attn_chunk: int = 512
  loss_chunk_tokens: int = 8192

  source: str = ""

  @property
  def padded_vocab(self) -> int:
    m = VOCAB_PAD_MULTIPLE
    return -(-self.vocab_size // m) * m

  @property
  def d_inner(self) -> int:
    return self.mamba_expand * self.d_model

  def layer_kinds(self) -> List[str]:
    """Per-layer kind within one block (the repeating pattern)."""
    if self.family == "ssm":
      return ["rwkv"]
    if self.family == "hybrid" and self.attn_period > 1:
      return ["attn"] + ["mamba"] * (self.attn_period - 1)
    return ["attn"]

  def block_pattern(self) -> List[Tuple[str, bool]]:
    """[(kind, is_moe)] for one block of the layer stack."""
    kinds = self.layer_kinds()
    assert self.n_layers % len(kinds) == 0, (self.name, self.n_layers)
    return [(kind, self.n_experts > 0
             and i % self.moe_period == self.moe_offset)
            for i, kind in enumerate(kinds)]

  @property
  def n_blocks(self) -> int:
    return self.n_layers // len(self.layer_kinds())

  # ---- parameter / FLOP accounting ---------------------------------------
  def param_count(self, active_only: bool = False) -> int:
    """Analytic parameter count; active_only counts top-k experts only."""
    d, dff = self.d_model, self.d_ff
    n = 0
    emb = self.padded_vocab * d
    n += emb if self.tie_embeddings else 2 * emb
    if self.pos_embed == "learned":
      n += self.max_position * d
    dt_rank = max(d // 16, 1)
    for kind, is_moe in self.block_pattern():
      per = 0
      if kind == "attn":
        per += d * self.n_heads * self.head_dim          # q
        per += 2 * d * self.n_kv_heads * self.head_dim   # kv
        per += self.n_heads * self.head_dim * d          # o
      elif kind == "mamba":
        di = self.d_inner
        per += d * 2 * di                                # in_proj (x, z)
        per += di * self.mamba_d_conv                    # depthwise conv
        per += di * (dt_rank + 2 * self.mamba_d_state)   # x_proj
        per += dt_rank * di                              # dt_proj
        per += di * self.mamba_d_state                   # A_log
        per += di * d                                    # out_proj
      elif kind == "rwkv":
        per += 5 * d * d                  # r, k, v, gate, out (time mix)
        per += 2 * d * dt_rank            # data-dependent decay lora
      ff_mats = 3 if self.mlp_variant == "swiglu" else 2
      if is_moe:
        e = self.n_experts if not active_only else self.n_experts_active
        per += e * ff_mats * d * self.d_ff_expert
        if self.n_shared_experts:
          per += ff_mats * d * self.d_ff_shared
        per += d * self.n_experts         # router
      elif kind == "rwkv":
        per += 2 * d * dff + d * d        # channel mix: k, v + receptance
      else:
        per += ff_mats * d * dff
      per *= self.n_blocks
      n += per
    if self.family == "encdec":
      # encoder blocks (self-attn + mlp) and decoder cross-attention
      enc = self.n_encoder_layers * (
          4 * d * self.n_heads * self.head_dim
          + (3 if self.mlp_variant == "swiglu" else 2) * d * dff)
      cross = self.n_layers * 4 * d * self.n_heads * self.head_dim
      n += enc + cross
    return n

  def train_flops_per_token(self) -> float:
    """MODEL_FLOPS = 6 * N(active) per token (fwd+bwd)."""
    return 6.0 * self.param_count(active_only=True)


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
  def deco(fn):
    _REGISTRY[name] = fn
    return fn
  return deco


def get_config(name: str) -> ModelConfig:
  if name not in _REGISTRY:
    import repro_torch.configs  # noqa: F401  (registers the configs)
  if name in _REGISTRY:
    return _REGISTRY[name]()
  raise ValueError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")


def list_archs() -> List[str]:
  import repro_torch.configs  # noqa: F401
  return sorted(_REGISTRY)
