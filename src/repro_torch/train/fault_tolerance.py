"""Fault tolerance (the port of ``repro.train.fault_tolerance``):
:class:`StragglerMonitor`, which the trainer feeds and the device fleet's
health registry reads; :class:`ElasticMeshPlanner`, which re-factorizes a
(data, model) mesh after failures; and :class:`StepFailure` and
:func:`retrying`, the single retry primitive of the trainer's steps and
of the exploration resilience ladder's ``RetryPolicy``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class HostStats:
  ewma: float = 0.0
  var: float = 0.0
  count: int = 0


class StragglerMonitor:
  """EWMA-based straggler detection over per-host step durations."""

  def __init__(self, alpha: float = 0.2, z_threshold: float = 3.0,
               min_samples: int = 5):
    self.alpha = alpha
    self.z = z_threshold
    self.min_samples = min_samples
    self.hosts: Dict[str, HostStats] = {}

  def record(self, host: str, step_seconds: float) -> None:
    st = self.hosts.setdefault(host, HostStats())
    if st.count == 0:
      st.ewma = step_seconds
    delta = step_seconds - st.ewma
    st.ewma += self.alpha * delta
    st.var = (1 - self.alpha) * (st.var + self.alpha * delta * delta)
    st.count += 1

  def fleet_median(self) -> float:
    vals = sorted(s.ewma for s in self.hosts.values() if s.count)
    return vals[len(vals) // 2] if vals else 0.0

  def stragglers(self) -> List[str]:
    """Hosts whose EWMA step time exceeds fleet median by z * fleet std."""
    med = self.fleet_median()
    if med <= 0:
      return []
    devs = [abs(s.ewma - med) for s in self.hosts.values()
            if s.count >= self.min_samples]
    if not devs:
      return []
    mad = sorted(devs)[len(devs) // 2] or 1e-9
    out = []
    for h, s in self.hosts.items():
      if s.count >= self.min_samples and (s.ewma - med) / (1.4826 * mad) \
          > self.z:
        out.append(h)
    return sorted(out)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
  data: int
  model: int
  pods: int
  microbatch_scale: int   # grad-accum multiplier to keep the global batch

  @property
  def devices(self) -> int:
    return self.pods * self.data * self.model


class ElasticMeshPlanner:
  """Re-factorize the mesh after failures.

  Policy: keep the TP ("model") degree, shrink DP to the largest size that
  fits the healthy-device count and divides the global batch, and scale
  gradient accumulation so the global batch is unchanged.
  """

  def __init__(self, model_parallel: int, global_batch: int,
               batch_per_dp: int):
    self.model_parallel = model_parallel
    self.global_batch = global_batch
    self.batch_per_dp = batch_per_dp

  def plan(self, healthy_devices: int,
           pods: int = 1) -> Optional[MeshPlan]:
    per_pod = healthy_devices // pods
    dp = per_pod // self.model_parallel
    if dp < 1:
      return None
    while dp > 1 and (self.global_batch % (dp * pods)) != 0:
      dp -= 1
    orig_dp = self.global_batch // self.batch_per_dp
    scale = max(1, int(math.ceil(orig_dp / (dp * pods))))
    return MeshPlan(data=dp, model=self.model_parallel, pods=pods,
                    microbatch_scale=scale)


class StepFailure(RuntimeError):
  pass


def retrying(step_fn: Callable, max_retries: int = 2,
             on_failure: Optional[Callable[[int, Exception], None]] = None,
             retry_exceptions: Tuple = (RuntimeError,),
             sleep: Callable[[float], None] = time.sleep,
             base_delay: float = 0.01, backoff: float = 2.0) -> Callable:
  """Wrap a step function with bounded retries on transient errors.

  ``sleep`` is injectable so unit tests never wall-wait; the delay before
  retry ``attempt`` is ``base_delay * backoff**attempt``, and no sleep
  happens after the final attempt (there is nothing left to wait for).
  """

  def wrapped(*args, **kwargs):
    last: Optional[Exception] = None
    for attempt in range(max_retries + 1):
      try:
        return step_fn(*args, **kwargs)
      except retry_exceptions as e:
        last = e
        if on_failure:
          on_failure(attempt, e)
        if attempt < max_retries:
          sleep(base_delay * (backoff ** attempt))
    raise StepFailure(
        f"step failed after {max_retries + 1} attempts") from last

  return wrapped
