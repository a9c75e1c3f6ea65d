"""The port's synthetic data against the JAX package's: ``CifarLike``
images and labels and ``MarkovTokenStream`` batches are host numpy over
the same ``derive_seed``, so they must be bit-equal (not close) over
several seeds, splits and sizes; the ``token_batches`` cursor must shard,
advance and resume as the reference's does."""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.data import synthetic as ref

from repro_torch.data import synthetic as port


_CONFIGS = {"CifarLike": "CifarLikeConfig",
            "MarkovTokenStream": "TokenStreamConfig"}


def _pair(cls, **kw):
  """The port's and the reference's ``cls`` under the same config."""
  return tuple(getattr(m, cls)(getattr(m, _CONFIGS[cls])(**kw))
               for m in (port, ref))


def test_config_defaults_are_a_copy():
  for name in ("CifarLikeConfig", "TokenStreamConfig", "DataCursor"):
    assert dataclasses.asdict(getattr(port, name)()) == \
        dataclasses.asdict(getattr(ref, name)())


@pytest.mark.parametrize("seed,size,n_classes",
                         [(0, 16, 10), (0, 32, 10), (3, 8, 100), (11, 13, 7)])
def test_cifar_like_class_tables_equal(seed, size, n_classes):
  got, want = _pair("CifarLike", seed=seed, image_size=size,
                    n_classes=n_classes)
  for attr in ("theta", "freq", "phase", "tint"):
    np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))


@pytest.mark.parametrize("seed,size,split", list(itertools.product(
    (0, 5), (8, 16, 32), (0, 7, 10_000_019))))
def test_cifar_like_sample_bit_equal(seed, size, split):
  got, want = _pair("CifarLike", seed=seed, image_size=size)
  gi, gl = got.sample(12, split_seed=split)
  wi, wl = want.sample(12, split_seed=split)
  assert gi.dtype == wi.dtype == np.float32 and gl.dtype == wl.dtype
  assert gi.shape == (12, size, size, 3)
  np.testing.assert_array_equal(gi, wi)
  np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("seed,vocab,branching", [(0, 4096, 8), (1, 512, 4),
                                                   (9, 97, 3)])
def test_markov_tables_equal(seed, vocab, branching):
  got, want = _pair("MarkovTokenStream", seed=seed, vocab_size=vocab,
                    branching=branching)
  np.testing.assert_array_equal(got.successors, want.successors)
  np.testing.assert_array_equal(got.weights, want.weights)


@pytest.mark.parametrize("seed,step", list(itertools.product(
    (0, 2), (0, 1, 999))))
def test_markov_sample_batch_bit_equal(seed, step):
  got, want = _pair("MarkovTokenStream", seed=seed, vocab_size=512,
                    branching=4)
  for a, b in zip(got.sample_batch(6, 33, step), want.sample_batch(6, 33, step)):
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shard,n_shards,start", [(0, 1, 0), (1, 2, 0),
                                                  (2, 4, 17)])
def test_token_batches_cursor(shard, n_shards, start):
  got_s, want_s = _pair("MarkovTokenStream", vocab_size=256)
  gc = port.DataCursor(step=start, shard=shard, n_shards=n_shards)
  wc = ref.DataCursor(step=start, shard=shard, n_shards=n_shards)
  gi = port.token_batches(got_s, 8, 16, gc)
  wi = ref.token_batches(want_s, 8, 16, wc)
  for k in range(3):
    g, w = next(gi), next(wi)
    assert g.keys() == w.keys()
    for key in g:
      assert g[key].shape == (8 // n_shards, 16)
      np.testing.assert_array_equal(g[key], w[key])
    assert gc.step == wc.step == start + k + 1
  # a resumed cursor yields the batch the uninterrupted one yields next
  resumed = port.token_batches(got_s, 8, 16, dataclasses.replace(gc))
  np.testing.assert_array_equal(next(resumed)["tokens"], next(gi)["tokens"])
