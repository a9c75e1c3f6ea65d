"""Rule packs — importing this module registers every rule."""
from repro_torch.analysis.rules import (contract, determinism,  # noqa: F401
                                        exactness, graph_purity, robustness)
