"""K6: prefill flash attention (hand-written CUDA, plain torch version,
public wrapper)."""
