"""rwkv6-1.6b "Finch" [ssm]: 24L d2048 (attention-free) ff7168 vocab65536.

Data-dependent per-channel decay (WKV6), 32 heads of 64; time-mix +
channel-mix per layer; O(1) recurrent state per sequence.
[arXiv:2404.05892; hf:RWKV/rwkv-6-world-1b6]
"""
from repro_torch.configs.base import ModelConfig, register


@register("rwkv6-1.6b")
def rwkv6_1_6b() -> ModelConfig:
  return ModelConfig(
      name="rwkv6-1.6b", family="ssm",
      n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
      d_ff=7168, vocab_size=65536,
      mlp_variant="gelu", norm="layernorm", pos_embed="none",
      ssm_chunk=64,
      source="arXiv:2404.05892",
  )
