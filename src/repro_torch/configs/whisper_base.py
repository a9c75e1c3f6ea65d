"""whisper-base [audio]: 6L enc + 6L dec, d512 8H ff2048 vocab51865.

Encoder-decoder; the conv1d audio frontend is a STUB — input_specs()
provides precomputed frame embeddings (B, 1500, d).  GELU MLP, learned
decoder positions, sinusoidal encoder positions.
[arXiv:2212.04356; hf:openai/whisper-base]
"""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-base")
def whisper_base() -> ModelConfig:
  return ModelConfig(
      name="whisper-base", family="encdec",
      n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
      d_ff=2048, vocab_size=51865,
      mlp_variant="gelu", norm="layernorm", pos_embed="learned",
      n_encoder_layers=6, encoder_seq=1500, max_position=65536,
      source="arXiv:2212.04356",
  )
