"""The exploration API of the port: design space, backends (the scalar
oracle, the exact oracle on a torch device, the polynomial PPA models),
fused device sweep, streaming reducers, the columnar result frame with
its best-INT16 normalization, HW x NN co-exploration (``JointTable``,
``LayerStack``, ``stream_co_explore``), guided NSGA-II search
(``guided_search``, ``hypervolume``), fault tolerance (retry, the
degradation ladder, journaled resume, fault injection), the device fleet
(``DevicePool``, ``run_fleet``), the result store with delta sweeps
(``ResultStore``, ``cached_stream_explore``), the exploration service
(``ExplorationService``), and the session facade."""
from repro_torch.core.dataflow import LayerStack
from repro_torch.core.table import ConfigTable, JointTable
from repro_torch.explore.backend import (EvaluationBackend, OracleBackend,
                                         PolynomialBackend,
                                         TorchOracleBackend, gbuf_overheads,
                                         gbuf_overheads_table)
from repro_torch.explore.fleet import (DevicePool, device_topology,
                                       run_fleet, visible_devices)
from repro_torch.explore.frame import (DesignPoint, Normalized, ResultFrame,
                                       pareto_mask, stable_topk_indices,
                                       summary_stats)
from repro_torch.explore.resilience import (ChunkError, ChunkTask,
                                            CircuitBreaker, Fault,
                                            FaultInjected, FaultPlan,
                                            InjectedHang, ResiliencePolicy,
                                            RetryPolicy, Rung, SweepJournal,
                                            SweepKilled, sweep_key)
from repro_torch.explore.search import (crowding_distance, guided_search,
                                        hypervolume, nondominated_ranks,
                                        objective_matrix)
from repro_torch.explore.service import (AdmissionRejected, BudgetExhausted,
                                         Deadline, DeadlineExceeded,
                                         ExplorationService,
                                         SessionCancelled, SessionHandle)
from repro_torch.explore.session import ExplorationSession
from repro_torch.explore.space import (AXIS_ORDER, Axis, DesignSpace,
                                       VectorConstraint, vector_constraint)
from repro_torch.explore.store import (ResultStore, cached_stream_co_explore,
                                       cached_stream_explore)
from repro_torch.explore.streaming import (STREAM_AUTO_MIN_ROWS,
                                           CollectAccumulator,
                                           HistogramAccumulator,
                                           ParetoAccumulator, Reducer,
                                           StatsAccumulator, StreamResult,
                                           TopKAccumulator, run_stream,
                                           stream_co_explore, stream_explore)

__all__ = [
    "AXIS_ORDER", "AdmissionRejected", "Axis", "BudgetExhausted",
    "ChunkError", "ChunkTask", "CircuitBreaker", "CollectAccumulator",
    "ConfigTable", "Deadline", "DeadlineExceeded", "DesignPoint",
    "DesignSpace", "DevicePool", "EvaluationBackend", "ExplorationService",
    "ExplorationSession", "Fault", "FaultInjected", "FaultPlan",
    "HistogramAccumulator", "InjectedHang", "JointTable", "LayerStack",
    "Normalized", "OracleBackend", "ParetoAccumulator", "PolynomialBackend",
    "Reducer", "ResiliencePolicy", "ResultFrame", "ResultStore",
    "RetryPolicy", "Rung", "STREAM_AUTO_MIN_ROWS", "SessionCancelled",
    "SessionHandle", "StatsAccumulator", "StreamResult", "SweepJournal",
    "SweepKilled", "TopKAccumulator", "TorchOracleBackend",
    "VectorConstraint", "cached_stream_co_explore", "cached_stream_explore",
    "crowding_distance", "device_topology", "gbuf_overheads",
    "gbuf_overheads_table", "guided_search", "hypervolume",
    "nondominated_ranks", "objective_matrix", "pareto_mask", "run_fleet",
    "run_stream", "stable_topk_indices", "stream_co_explore",
    "stream_explore", "summary_stats", "sweep_key", "vector_constraint",
    "visible_devices",
]
