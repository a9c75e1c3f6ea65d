"""jamba-1.5-large-398b [hybrid]: 72L d8192 64H (GQA kv=8) ff24576,
Mamba:attention 7:1 interleave, MoE 16 experts top-2 on every other layer.

No positional embeddings (Mamba carries position); SwiGLU experts.
long_500k RUNS: 63/72 layers are O(1)-state Mamba, the 9 attention layers
keep full KV (sharded over the mesh).  [arXiv:2403.19887 + Jamba-1.5
arXiv:2408.12570; hf:ai21labs/AI21-Jamba-1.5-Large]
"""
from repro_torch.configs.base import ModelConfig, register


@register("jamba-1.5-large")
def jamba_1_5_large() -> ModelConfig:
  return ModelConfig(
      name="jamba-1.5-large", family="hybrid",
      n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
      d_ff=24576, vocab_size=65536,
      mlp_variant="swiglu", norm="rmsnorm", pos_embed="none",
      n_experts=16, n_experts_active=2, d_ff_expert=24576,
      moe_period=2, moe_offset=1,
      attn_period=8, mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
      source="arXiv:2403.19887",
  )
