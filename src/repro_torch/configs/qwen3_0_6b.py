"""qwen3-0.6b [dense]: 28L d1024 16H (GQA kv=8) ff3072 vocab151936.

QK-RMSNorm inside attention, SwiGLU, RoPE (theta 1e6), tied embeddings,
head_dim 128 decoupled from d_model.  [hf:Qwen/Qwen3-0.6B (family per
hf:Qwen/Qwen3-8B card)]
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen3-0.6b")
def qwen3_0_6b() -> ModelConfig:
  return ModelConfig(
      name="qwen3-0.6b", family="dense",
      n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
      d_ff=3072, vocab_size=151936,
      mlp_variant="swiglu", norm="rmsnorm", qk_norm=True,
      pos_embed="rope", rope_theta=1e6, tie_embeddings=True,
      source="hf:Qwen/Qwen3-8B",
  )
