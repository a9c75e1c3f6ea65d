"""minitron-4b [dense]: 32L d3072 24H (GQA kv=8) ff9216 vocab256000.

Pruned Nemotron: squared-ReLU MLP, RoPE, untied 256k embedding.
[arXiv:2407.14679; hf:nvidia/Minitron-4B-Base]
"""
from repro_torch.configs.base import ModelConfig, register


@register("minitron-4b")
def minitron_4b() -> ModelConfig:
  return ModelConfig(
      name="minitron-4b", family="dense",
      n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
      d_ff=9216, vocab_size=256000,
      mlp_variant="relu2", norm="layernorm", pos_embed="rope",
      source="arXiv:2407.14679",
  )
