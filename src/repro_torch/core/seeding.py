"""One documented seed-derivation helper (the port of
``repro.core.seeding``, bit for bit: the same labels and components give
the same seeds in both packages, so a seeded search, fault plan or
breaker draws the same streams).

Ad-hoc child-seed arithmetic (``seed * 7 + split``, ``seed + 999``,
``seed * 1_000_003 + step``) has two failure modes:

  * **collisions** — linear maps intersect: ``seed*7 + split`` gives the
    same RNG stream for ``(seed=0, split=7)`` and ``(seed=1, split=0)``,
    so two "independent" datasets silently share every sample;
  * **overflow/clipping** — ``% 2**31`` folds distinct (seed, step)
    pairs onto each other in structured ways, and unreduced products
    overflow numpy's int64 seed range for large steps.

:func:`derive_seed` replaces all of it: a labelled splitmix64 chain over
the components.  The label keeps unrelated consumers (e.g. the Markov
stream vs the image sampler) on disjoint streams even for identical
numeric components; splitmix64's avalanche makes structurally related
inputs (seed, seed+1) statistically unrelated outputs.  Deterministic
across platforms and Python versions (string labels hash via SHA-256,
never ``hash()``).
"""
from __future__ import annotations

import hashlib
import struct
from typing import Union

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15  # splitmix64 stream increment

Component = Union[int, float, str, bool]


def _mix64(z: int) -> int:
  """splitmix64 finalizer (mod 2^64): full avalanche on every input bit."""
  z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
  z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
  return z ^ (z >> 31)


def _component64(part: Component) -> int:
  if isinstance(part, bool):
    return int(part)
  if isinstance(part, int):
    return part & _MASK64
  if isinstance(part, float):
    return int.from_bytes(struct.pack("<d", part), "little")
  if isinstance(part, str):
    return int.from_bytes(hashlib.sha256(part.encode()).digest()[:8],
                          "little")
  raise TypeError(f"derive_seed components must be int/float/str/bool, "
                  f"got {type(part).__name__}: {part!r}")


def derive_seed(label: str, *parts: Component, bits: int = 31) -> int:
  """A child seed in ``[0, 2**bits)`` from a label and components.

  ``label`` names the consumer (e.g. ``"markov-step"``) and keeps its
  stream disjoint from every other consumer's even when the numeric
  components coincide.  Components may be ints (any sign/size), floats
  (hashed by bit pattern), bools or strings.  Order matters:
  ``derive_seed(l, a, b) != derive_seed(l, b, a)`` in general.

  ``bits`` defaults to 31 — safe for ``np.random.RandomState``,
  ``torch.manual_seed`` and C ``int`` seed APIs alike; raise it (max 63)
  for consumers that accept wider seeds.
  """
  if not isinstance(label, str) or not label:
    raise ValueError("derive_seed needs a non-empty string label naming "
                     "the consumer")
  if not 1 <= bits <= 63:
    raise ValueError(f"bits must be in [1, 63], got {bits}")
  h = _component64(label)
  for part in parts:
    h = _mix64(((h + _GOLDEN) & _MASK64) ^ _component64(part))
  return h >> (64 - bits)
