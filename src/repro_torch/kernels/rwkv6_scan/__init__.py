"""K7: the chunked WKV6 (RWKV-6) recurrence (hand-written CUDA, plain
torch versions, public wrapper)."""
