"""The exploration service's request budget (the port of
``repro.explore.service``; for now only :class:`Deadline`, which the
serving engine uses to evict late requests)."""
from __future__ import annotations

import time
from typing import Callable


class Deadline:
  """A monotonic wall-clock budget, started at construction.

  The clock is injectable so tests can expire deadlines without
  wall-waiting; the default is ``time.monotonic``, deliberately not
  ``time.time``, which NTP can step backwards.
  """

  def __init__(self, seconds: float,
               clock: Callable[[], float] = time.monotonic):
    self.seconds = float(seconds)
    self.clock = clock
    self._t0 = clock()

  def remaining(self) -> float:
    return self.seconds - (self.clock() - self._t0)

  def expired(self) -> bool:
    return self.remaining() <= 0.0

  def __repr__(self) -> str:
    return f"Deadline({self.seconds}s, {self.remaining():.3f}s left)"
