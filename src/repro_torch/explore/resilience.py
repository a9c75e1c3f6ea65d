"""The chunk-task types of the streaming engine (from
``repro.explore.resilience``): a chunk with its ladder of ways to
evaluate it, and the error a fatal chunk raises.  Retry and degradation
policies are not ported yet, so a task runs its best rung only."""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple


class ChunkError(RuntimeError):
  """A chunk failed fatally.  Carries the chunk's global index so a
  caller knows exactly where the sweep stopped."""

  def __init__(self, chunk_index: int, message: str = ""):
    self.chunk_index = int(chunk_index)
    detail = f": {message}" if message else ""
    super().__init__(f"chunk {self.chunk_index} failed{detail}")


@dataclasses.dataclass(frozen=True)
class Rung:
  """One way to evaluate a chunk.  ``fn`` returns a pending handle with
  ``resolve()`` (or a plain ``(frame, indices)`` pair)."""
  name: str
  fn: Callable[[], object]
  layer: str = "backend"


@dataclasses.dataclass(frozen=True)
class ChunkTask:
  """A chunk plus its ladder, best rung first.  Calling the task runs
  the best rung only."""
  index: int
  rungs: Tuple[Rung, ...]

  def __call__(self):
    return self.rungs[0].fn()
