"""K5: single-token decode attention over an int8 KV cache (hand-written
CUDA, plain torch version, public wrapper)."""
