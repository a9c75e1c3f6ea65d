"""pixtral-12b [vlm]: 40L d5120 32H (GQA kv=8) ff14336 vocab131072.

Mistral-Nemo decoder backbone; the Pixtral-ViT frontend is not modelled:
training takes precomputed patch embeddings (``img_embeds``) prepended to
the text sequence, and serving is text-only, as in the reference.  [hf:mistralai/Pixtral-12B-2409]
"""
from repro_torch.configs.base import ModelConfig, register


@register("pixtral-12b")
def pixtral_12b() -> ModelConfig:
  return ModelConfig(
      name="pixtral-12b", family="vlm",
      n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
      d_ff=14336, vocab_size=131072,
      mlp_variant="swiglu", norm="rmsnorm", pos_embed="rope",
      rope_theta=1e6, n_image_tokens=256,
      source="hf:mistralai/Pixtral-12B-2409",
  )
