"""The exploration API of the port: design space, backends (the scalar
oracle, the exact oracle on a torch device, the polynomial PPA models),
fused device sweep, streaming reducers, the columnar result frame with
its best-INT16 normalization, HW x NN co-exploration (``JointTable``,
``LayerStack``, ``stream_co_explore``), and the session facade."""
from repro_torch.core.dataflow import LayerStack
from repro_torch.core.table import ConfigTable, JointTable
from repro_torch.explore.backend import (OracleBackend, PolynomialBackend,
                                         TorchOracleBackend, gbuf_overheads,
                                         gbuf_overheads_table)
from repro_torch.explore.frame import (DesignPoint, Normalized, ResultFrame,
                                       pareto_mask, stable_topk_indices,
                                       summary_stats)
from repro_torch.explore.session import ExplorationSession
from repro_torch.explore.space import (AXIS_ORDER, Axis, DesignSpace,
                                       VectorConstraint, vector_constraint)
from repro_torch.explore.streaming import (STREAM_AUTO_MIN_ROWS,
                                           CollectAccumulator,
                                           HistogramAccumulator,
                                           ParetoAccumulator, Reducer,
                                           StatsAccumulator, StreamResult,
                                           TopKAccumulator, run_stream,
                                           stream_co_explore, stream_explore)

__all__ = ["AXIS_ORDER", "Axis", "CollectAccumulator", "ConfigTable",
           "DesignPoint", "DesignSpace", "ExplorationSession",
           "HistogramAccumulator", "JointTable", "LayerStack", "Normalized",
           "OracleBackend", "ParetoAccumulator", "PolynomialBackend",
           "Reducer", "ResultFrame", "STREAM_AUTO_MIN_ROWS",
           "StatsAccumulator", "StreamResult", "TopKAccumulator",
           "TorchOracleBackend", "VectorConstraint", "gbuf_overheads",
           "gbuf_overheads_table", "pareto_mask", "run_stream",
           "stable_topk_indices", "stream_co_explore", "stream_explore",
           "summary_stats", "vector_constraint"]
