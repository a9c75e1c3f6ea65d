"""The Table-4 search space of the paper's co-exploration (the part of
``repro.core.cnn`` the joint sweep needs): per VGG stage, the repeat and
channel choices, and :class:`ArchChoice`, one point of that space.

The CNN models, their initialisers and training, and :func:`sample_arch`
(which draws from a jax PRNG key, a stream no torch generator
reproduces) come with slice 7.  Draw architectures with
``np.random.RandomState`` instead::

    rng = np.random.RandomState(0)
    arch = ArchChoice(tuple((int(rng.choice(reps)), int(rng.choice(chs)))
                            for reps, chs in SEARCH_SPACE))
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

# Table 4 search space: (repeat choices, channel choices) per stage.
SEARCH_SPACE: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...] = (
    ((1, 2), (40, 48, 56, 64)),
    ((1, 2), (80, 96, 112, 128)),
    ((1, 2, 3), (160, 192, 224, 256)),
    ((1, 2, 3), (320, 384, 448, 512)),
    ((1, 2, 3), (320, 384, 448, 512)),
)

MAX_PLAN = tuple((max(reps), max(chs)) for reps, chs in SEARCH_SPACE)
SPACE_SIZE = 1
for _reps, _chs in SEARCH_SPACE:
  SPACE_SIZE *= len(_reps) * len(_chs)         # = 110,592


@dataclasses.dataclass(frozen=True)
class ArchChoice:
  """One point of the Table-4 space: per-stage (repeats, channels)."""
  stages: Tuple[Tuple[int, int], ...]

  def as_plan(self) -> List[Tuple[int, int]]:
    return [(c, r) for (r, c) in self.stages]


def sample_arch(key) -> ArchChoice:
  """Not ported: the reference draws from a jax PRNG key."""
  raise NotImplementedError(
      "sample_arch draws from a jax PRNG key and comes with slice 7 (the "
      "supernet); draw ArchChoice stages with np.random.RandomState")


def max_arch() -> ArchChoice:
  return ArchChoice(MAX_PLAN)
