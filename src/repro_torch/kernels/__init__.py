"""Hand-written CUDA kernels for Hopper, each beside its plain torch
version (``ref.py``) and its public wrappers (``ops.py``)."""
