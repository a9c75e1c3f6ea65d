"""The part of ``jax.random`` that :func:`repro_torch.core.cnn.sample_arch`
draws from: legacy ``PRNGKey`` keys, ``split`` and scalar ``randint``,
on the host, bit for bit as jax computes them with its defaults
(``jax_default_prng_impl="threefry2x32"``,
``jax_threefry_partitionable=True``).

A key is a ``(2,)`` uint32 array.  ``PRNGKey(seed)`` puts the seed's high
and low 32 bits in it (seeds below 2**31, as every caller gives).
``split`` hashes the 64-bit counters ``0..n-1`` (high words 0) with
Threefry-2x32 under the key, and the two hashed words of counter ``i``
are the ``i``-th new key.  ``randint`` splits its key in two, hashes
counter 0 under each (``bits1 ^ bits2``: one 32-bit word apiece), and
folds the two words into ``[minval, maxval)`` by jax's double-width
modulus.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def threefry2x32(key: np.ndarray, x0: int, x1: int) -> Tuple[int, int]:
  """Threefry-2x32 (20 rounds) of one counter pair under ``key``, on
  Python ints (the draws here are scalars; numpy's per-call cost would
  be most of the time)."""
  k0, k1 = int(key[0]), int(key[1])
  ks = (k0, k1, k0 ^ k1 ^ _PARITY)
  a, b = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
  for i in range(5):
    for r in _ROTATIONS[i % 2]:
      a = (a + b) & _M32
      b = (((b << r) | (b >> (32 - r))) & _M32) ^ a
    a = (a + ks[(i + 1) % 3]) & _M32
    b = (b + ks[(i + 2) % 3] + i + 1) & _M32
  return a, b


def PRNGKey(seed: int) -> np.ndarray:
  """The legacy key of an integer seed in ``[0, 2**31)``."""
  seed = int(seed)
  if not 0 <= seed < 2 ** 31:
    raise ValueError(f"PRNGKey takes seeds in [0, 2**31), got {seed}")
  return np.array([0, seed], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
  """``num`` new keys, shape ``(num, 2)``."""
  return np.array([threefry2x32(key, 0, i) for i in range(num)], np.uint32)


def randint(key: np.ndarray, minval: int, maxval: int) -> int:
  """One int32 draw in ``[minval, maxval)`` (scalar shape)."""
  k1, k2 = split(key)
  higher, lower = (a ^ b for a, b in (threefry2x32(k1, 0, 0),
                                      threefry2x32(k2, 0, 0)))
  span = max(maxval - minval, 1)
  mult = ((2 ** 16 % span) ** 2 & _M32) % span   # uint32 products wrap
  offset = (((higher % span) * mult & _M32) + lower % span) & _M32
  return int(minval) + offset % span
