"""Bounded retries on transient errors (the port of the retry half of
``repro.train.fault_tolerance``: :class:`StepFailure` and
:func:`retrying`, the single retry primitive the exploration resilience
ladder builds its ``RetryPolicy`` on).

The trainer half of the reference module (``StragglerMonitor``,
``ElasticMeshPlanner``) comes with slice 7.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple


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
