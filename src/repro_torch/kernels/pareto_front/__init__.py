from repro_torch.kernels.pareto_front.ops import (block_prefilter_mask,
                                                  dominance_counts,
                                                  pareto_front_mask)

__all__ = ["dominance_counts", "pareto_front_mask", "block_prefilter_mask"]
