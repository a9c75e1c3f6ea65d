"""Data substrate: deterministic synthetic token and image pipelines."""
from repro_torch.data.synthetic import (CifarLike, CifarLikeConfig,
                                        DataCursor, MarkovTokenStream,
                                        TokenStreamConfig, token_batches)

__all__ = ["CifarLike", "CifarLikeConfig", "DataCursor", "MarkovTokenStream",
           "TokenStreamConfig", "token_batches"]
