"""granite-34b [dense]: 88L d6144 48H (MQA kv=1) ff24576 vocab49152.

GPTBigCode/llama-arch code model: MQA, GELU MLP, learned positions.
[arXiv:2405.04324; hf:ibm-granite/granite-34b-code-base]
"""
from repro_torch.configs.base import ModelConfig, register


@register("granite-34b")
def granite_34b() -> ModelConfig:
  return ModelConfig(
      name="granite-34b", family="dense",
      n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
      d_ff=24576, vocab_size=49152,
      mlp_variant="gelu", norm="layernorm", pos_embed="learned",
      max_position=65536,  # the reference's table, beyond the 8k training
                            # context
      source="arXiv:2405.04324",
  )
