"""Straggler detection and bounded retries on transient errors (the
port of ``repro.train.fault_tolerance``'s :class:`StragglerMonitor`,
which the device fleet's health registry reads, and of
:class:`StepFailure` and :func:`retrying`, the single retry primitive
the exploration resilience ladder builds its ``RetryPolicy`` on).

The trainer's re-meshing half of the reference module (``MeshPlan``,
``ElasticMeshPlanner``) comes with slice 7b.
"""
from __future__ import annotations

import dataclasses
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
