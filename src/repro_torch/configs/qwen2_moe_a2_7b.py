"""qwen2-moe-a2.7b [moe]: 24L d2048 16H (kv=16) 60 routed experts top-4
+ 4 shared experts (shared intermediate 5632 = 4 x 1408), ff_expert 1408,
vocab 151936.  [hf:Qwen/Qwen1.5-MoE-A2.7B]
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-moe-a2.7b")
def qwen2_moe_a2_7b() -> ModelConfig:
  return ModelConfig(
      name="qwen2-moe-a2.7b", family="moe",
      n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
      d_ff=1408, vocab_size=151936,
      mlp_variant="swiglu", norm="rmsnorm", pos_embed="rope",
      n_experts=60, n_experts_active=4, n_shared_experts=4,
      d_ff_expert=1408, d_ff_shared=5632,
      moe_period=1, moe_offset=0,
      source="hf:Qwen/Qwen1.5-MoE-A2.7B",
  )
