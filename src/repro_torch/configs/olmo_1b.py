"""olmo-1b [dense]: 16L d2048 16H (GQA kv=16) ff8192 vocab50304.

Non-parametric LayerNorm, SwiGLU, RoPE, tied embeddings.
[arXiv:2402.00838; hf:allenai/OLMo-1B]
"""
from repro_torch.configs.base import ModelConfig, register


@register("olmo-1b")
def olmo_1b() -> ModelConfig:
  return ModelConfig(
      name="olmo-1b", family="dense",
      n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
      d_ff=8192, vocab_size=50304,
      mlp_variant="swiglu", norm="layernorm_np", pos_embed="rope",
      tie_embeddings=True,
      source="arXiv:2402.00838",
  )
