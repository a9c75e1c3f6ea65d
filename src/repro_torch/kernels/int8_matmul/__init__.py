"""K3: W8A8 int8 matmul with an int32 accumulator and a scaled float32
epilogue (hand-written CUDA, plain torch version, public wrapper)."""
