"""Deterministic synthetic data (the port of ``repro.data.synthetic``,
host numpy copied op for op over the port's own ``derive_seed``: the
same seeds give the same bytes in both packages).

Token streams: a seeded order-1 Markov chain over the vocab with Zipfian
marginals, structured enough that a language model's loss genuinely
decreases, fully reproducible, and resumable from a (seed, step) cursor.

Image classes: procedural class-conditional Gabor textures standing in for
CIFAR-10/100 in the paper's accuracy experiments (no download).
Images are NHWC float32, as the CNNs of :mod:`repro_torch.core.cnn` take
them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.core.seeding import derive_seed


# ---------------------------------------------------------------------------
# token stream
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TokenStreamConfig:
  vocab_size: int = 4096
  branching: int = 8          # successors per state (lower = easier)
  seed: int = 0


class MarkovTokenStream:
  """Order-1 Markov chain with Zipf marginals; O(vocab * branching) table."""

  def __init__(self, cfg: TokenStreamConfig):
    self.cfg = cfg
    rng = np.random.RandomState(cfg.seed)
    v, b = cfg.vocab_size, cfg.branching
    self.successors = rng.randint(0, v, size=(v, b)).astype(np.int32)
    # Zipf-ish successor weights shared across states
    w = 1.0 / np.arange(1, b + 1) ** 1.1
    self.weights = (w / w.sum()).astype(np.float64)

  def sample_batch(self, batch: int, seq_len: int, step: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic (tokens, labels) for a global step."""
    rng = np.random.RandomState(derive_seed("markov-step", self.cfg.seed,
                                            step))
    v, b = self.cfg.vocab_size, self.cfg.branching
    toks = np.empty((batch, seq_len + 1), np.int32)
    toks[:, 0] = rng.randint(0, v, size=batch)
    choices = rng.choice(b, size=(batch, seq_len), p=self.weights)
    for t in range(seq_len):
      toks[:, t + 1] = self.successors[toks[:, t], choices[:, t]]
    return toks[:, :-1], toks[:, 1:]


@dataclasses.dataclass
class DataCursor:
  """Resumable pipeline position (checkpointed with the train state)."""
  step: int = 0
  shard: int = 0
  n_shards: int = 1


def token_batches(stream: MarkovTokenStream, batch: int, seq_len: int,
                  cursor: DataCursor) -> Iterator[Dict[str, np.ndarray]]:
  """Host-sharded batch iterator: host `shard` of `n_shards` yields its
  slice of the global batch; the cursor advances for resumability."""
  per_host = batch // cursor.n_shards
  lo = cursor.shard * per_host
  while True:
    toks, labels = stream.sample_batch(batch, seq_len, cursor.step)
    cursor.step += 1   # cursor now names the NEXT batch (resume-correct)
    yield {"tokens": toks[lo: lo + per_host],
           "labels": labels[lo: lo + per_host]}


# ---------------------------------------------------------------------------
# procedural image classes (cifar_like)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CifarLikeConfig:
  n_classes: int = 10
  image_size: int = 32
  noise: float = 0.35
  seed: int = 0


class CifarLike:
  """Class-conditional Gabor textures + color tint + noise.

  Each class has a characteristic (orientation, frequency, phase, tint);
  samples add jitter and pixel noise.  Linear classifiers reach ~50-70%,
  small convnets >90% — enough headroom for the paper's relative-accuracy
  comparisons (FP32 vs INT16 vs LightPE QAT).
  """

  def __init__(self, cfg: CifarLikeConfig):
    self.cfg = cfg
    rng = np.random.RandomState(derive_seed("cifar-classes", cfg.seed))
    c = cfg.n_classes
    self.theta = rng.uniform(0, np.pi, c)
    self.freq = rng.uniform(2.0, 8.0, c)
    self.phase = rng.uniform(0, 2 * np.pi, c)
    self.tint = rng.uniform(0.3, 1.0, (c, 3))

  def sample(self, n: int, split_seed: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    cfg = self.cfg
    rng = np.random.RandomState(derive_seed("cifar-split", cfg.seed,
                                            split_seed))
    labels = rng.randint(0, cfg.n_classes, n)
    s = cfg.image_size
    yy, xx = np.meshgrid(np.linspace(-1, 1, s), np.linspace(-1, 1, s),
                         indexing="ij")
    imgs = np.empty((n, s, s, 3), np.float32)
    for i, c in enumerate(labels):
      th = self.theta[c] + rng.normal(0, 0.08)
      fq = self.freq[c] * (1 + rng.normal(0, 0.05))
      ph = self.phase[c] + rng.normal(0, 0.3)
      u = xx * np.cos(th) + yy * np.sin(th)
      pattern = np.sin(fq * np.pi * u + ph) * \
          np.exp(-(xx ** 2 + yy ** 2))
      img = pattern[..., None] * self.tint[c][None, None, :]
      img += rng.normal(0, cfg.noise, img.shape)
      imgs[i] = img
    return imgs.astype(np.float32), labels.astype(np.int32)
