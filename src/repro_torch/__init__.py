"""repro_torch: the QUIDAM design-space sweep in PyTorch, with its Pareto
dominance kernels hand-written in CUDA for Hopper.

A second package beside the JAX reference ``repro``; it imports nothing
from it.  Entry points run on the first CUDA device unless the caller
passes ``device="cpu"``.
"""
