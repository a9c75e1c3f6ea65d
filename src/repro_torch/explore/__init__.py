"""The exploration API of the port: design space, torch backend, fused
device sweep, streaming reducers and the session facade."""
from repro_torch.explore.backend import TorchOracleBackend
from repro_torch.explore.frame import ResultFrame, pareto_mask
from repro_torch.explore.session import ExplorationSession
from repro_torch.explore.space import DesignSpace
from repro_torch.explore.streaming import (HistogramAccumulator,
                                           ParetoAccumulator,
                                           StatsAccumulator, StreamResult,
                                           TopKAccumulator, run_stream,
                                           stream_explore)

__all__ = ["DesignSpace", "ExplorationSession", "HistogramAccumulator",
           "ParetoAccumulator", "ResultFrame", "StatsAccumulator",
           "StreamResult", "TopKAccumulator", "TorchOracleBackend",
           "pareto_mask", "run_stream", "stream_explore"]
