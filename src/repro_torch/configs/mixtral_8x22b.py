"""mixtral-8x22b [moe]: 56L d6144 48H (GQA kv=8) ff16384, 8 experts top-2.

SwiGLU experts, RoPE (theta 1e6), sliding-window attention (4096), which
bounds the KV cache to a ring of 4,096 positions.
[arXiv:2401.04088; hf:mistralai/Mixtral-8x22B-v0.1]
"""
from repro_torch.configs.base import ModelConfig, register


@register("mixtral-8x22b")
def mixtral_8x22b() -> ModelConfig:
  return ModelConfig(
      name="mixtral-8x22b", family="moe",
      n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
      d_ff=16384, vocab_size=32768,
      mlp_variant="swiglu", norm="rmsnorm", pos_embed="rope",
      rope_theta=1e6, sliding_window=4096,
      n_experts=8, n_experts_active=2, d_ff_expert=16384,
      moe_period=1, moe_offset=0,
      source="arXiv:2401.04088",
  )
