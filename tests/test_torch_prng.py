"""The port's jax-style PRNG (``repro_torch.core.prng``) against
``jax.random`` under this jax's defaults (threefry2x32, partitionable),
and the port's ``sample_arch`` against the reference's: keys, ``split``
words and ``randint`` draws must be bit-equal, and ``sample_arch`` must
pick the same architecture for 1,000 ``supernet-eval`` keys (the
supernet's evaluated archs) and 1,000 keys from ``RandomState(0)`` (its
training archs)."""
import jax
import numpy as np
import pytest

from repro.core import cnn as ref_cnn
from repro.core.seeding import derive_seed

from repro_torch.core import cnn, prng

EDGE_SEEDS = (0, 1, 2 ** 31 - 1)
CHUNK = 100


def test_jax_defaults_are_the_ported_ones():
  assert jax.config.jax_default_prng_impl == "threefry2x32"
  assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", EDGE_SEEDS)
def test_prng_key_equal(seed):
  np.testing.assert_array_equal(prng.PRNGKey(seed), jax.random.PRNGKey(seed))
  assert prng.PRNGKey(seed).dtype == np.uint32


@pytest.mark.parametrize("bad", [-1, 2 ** 31])
def test_prng_key_refuses_seeds_out_of_range(bad):
  with pytest.raises(ValueError):
    prng.PRNGKey(bad)


@pytest.mark.parametrize("seed", EDGE_SEEDS)
@pytest.mark.parametrize("num", [1, 2, 5, 9])
def test_split_bits_equal(seed, num):
  got = prng.split(prng.PRNGKey(seed), num)
  want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
  assert got.dtype == np.uint32 and got.shape == (num, 2)
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", EDGE_SEEDS)
def test_split_of_a_split_equal(seed):
  got = prng.split(prng.split(prng.PRNGKey(seed), 5)[3])
  want = jax.random.split(jax.random.split(jax.random.PRNGKey(seed), 5)[3])
  np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("seed", EDGE_SEEDS)
@pytest.mark.parametrize("lo,hi", [(0, 2), (0, 3), (0, 4), (-7, 9),
                                   (5, 100_003), (0, 2 ** 31 - 1), (4, 4)])
def test_randint_equal(seed, lo, hi):
  want = int(jax.random.randint(jax.random.PRNGKey(seed), (), lo, hi))
  assert prng.randint(prng.PRNGKey(seed), lo, hi) == want


def _eval_seeds(chunk):
  return [derive_seed("supernet-eval", 1, i)
          for i in range(chunk * CHUNK, (chunk + 1) * CHUNK)]


def _train_seeds(chunk):
  rng = np.random.RandomState(0)
  seeds = [rng.randint(2 ** 31) for _ in range(10 * CHUNK)]
  return seeds[chunk * CHUNK:(chunk + 1) * CHUNK]


@pytest.mark.parametrize("chunk", range(10))
@pytest.mark.parametrize("seeds", [_eval_seeds, _train_seeds],
                         ids=["supernet-eval", "RandomState0"])
def test_sample_arch_equal(seeds, chunk):
  for s in seeds(chunk):
    want = ref_cnn.sample_arch(jax.random.PRNGKey(s))
    assert cnn.sample_arch(prng.PRNGKey(s)) == cnn.ArchChoice(want.stages), s
