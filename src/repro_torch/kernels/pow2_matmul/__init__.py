"""K4: matmul against packed sum-of-powers-of-two (LightPE) weights
(hand-written CUDA, plain torch version, public wrapper)."""
