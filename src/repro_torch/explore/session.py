"""ExplorationSession: the facade over the plain design-space sweep (the
port of ``repro.explore.session``'s ``explore``).

``explore(..., stream=False)`` samples a ConfigTable and evaluates it in
one shot into a full ResultFrame; ``stream=True`` runs the
constant-memory streaming engine and returns a StreamResult of reducer
outputs, with the evaluate+reduce pipeline fused on the device whenever
every reducer allows it.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Union

from repro_torch.core.dataflow import ConvLayer
from repro_torch.explore.frame import ResultFrame
from repro_torch.explore.space import DesignSpace
from repro_torch.explore.streaming import (Reducer, StreamResult,
                                           stream_explore)


class ExplorationSession:
  """Binds a backend (how points are scored) to a design space."""

  def __init__(self, backend, space: Optional[DesignSpace] = None):
    self.backend = backend
    self.space = DesignSpace() if space is None else space

  def explore(self, layers: Sequence[ConvLayer], network: str,
              n_per_type: int = 200, seed: int = 17,
              method: str = "random", stream: bool = False,
              reducers: Optional[Dict[str, Reducer]] = None,
              chunk_size: int = 65536) -> Union[ResultFrame, StreamResult]:
    """Sample the space and evaluate ``network``.

    stream=False: one-shot full frame (``frame.meta`` carries
    eval_seconds and eval_us_per_design).  stream=True: the streaming
    engine over ``reducers`` (default: the paper's perf/area vs energy
    front) in chunks of ``chunk_size`` rows.
    """
    if reducers is not None and not stream:
      raise ValueError("reducers only apply to the streaming engine; "
                       "pass stream=True")
    if stream:
      return stream_explore(self.backend, self.space, layers, network,
                            n_per_type=n_per_type, seed=seed, method=method,
                            reducers=reducers, chunk_size=chunk_size)
    table = self.space.sample_table(n_per_type, seed=seed, method=method)
    t0 = time.perf_counter()
    frame = self.backend.evaluate(table, layers, network)
    t_eval = time.perf_counter() - t0
    frame.meta["eval_seconds"] = t_eval
    frame.meta["eval_us_per_design"] = t_eval / max(len(frame), 1) * 1e6
    return frame
