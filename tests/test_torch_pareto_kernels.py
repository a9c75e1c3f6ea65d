"""The port's Pareto dominance kernels (K1 block, K2 pairwise) against the
JAX package's Pallas kernels (interpret mode) and plain jnp versions.

On the CPU the port's wrappers run their plain torch versions; these must
give int-equal counts to the reference on float64 inputs with exact ties,
duplicates, +inf rows and N not a multiple of the block.  The CUDA
kernels themselves run only on a card (tests marked ``gpu``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.explore.frame import pareto_mask
from repro.kernels.pareto_front import kernel as ref_kernel
from repro.kernels.pareto_front import ops as ref_ops
from repro.kernels.pareto_front import ref as ref_ref

from repro_torch import _build
from repro_torch.kernels.pareto_front import kernel, ops, ref


def objectives(n: int, d: int, seed: int) -> np.ndarray:
  """float64 points with ties, duplicates, +inf entries and values 1 ulp
  apart (distinct only in float64).  Values stay in [1, 2]: XLA on the
  CPU flushes subnormals to zero, which would change the reference's
  answers, not the port's."""
  rng = np.random.RandomState(seed)
  obj = 1.0 + rng.uniform(size=(n, d))
  obj[rng.randint(0, n, n // 5), 0] = 1.25                # ties on an axis
  rows = rng.randint(0, n, n // 10)
  obj[rows] = np.round(obj[rows], 1)                       # coarse grid
  near = rng.randint(0, n, n // 6)
  obj[near] = np.nextafter(obj[rng.randint(0, n, near.size)], 3.0)
  obj[n // 3] = obj[2 * n // 3]                            # duplicates
  obj[rng.randint(0, n, 3), rng.randint(0, d)] = np.inf    # +inf entries
  return obj


CASES = [(64, 2), (300, 3), (513, 4), (257, 3)]


@pytest.mark.parametrize("n,d", CASES)
def test_dominance_counts_match_pallas_and_ref(n, d):
  obj = objectives(n, d, seed=n + d)
  got = ops.dominance_counts(torch.from_numpy(obj)).numpy()
  with jax.enable_x64(True):
    pallas = np.asarray(ref_ops.dominance_counts(obj, interpret=True))
    plain = np.asarray(ref_ref.dominance_counts_ref(obj))
    front = np.asarray(ref_ref.pareto_mask_ref(obj))
  assert got.dtype == np.int32
  np.testing.assert_array_equal(got, pallas)
  np.testing.assert_array_equal(got, plain)
  np.testing.assert_array_equal(
      ops.pareto_front_mask(torch.from_numpy(obj)).numpy(), front)
  finite = np.isfinite(obj).all(axis=1)
  np.testing.assert_array_equal(  # the host front on the finite rows
      ops.pareto_front_mask(torch.from_numpy(obj[finite])).numpy(),
      pareto_mask(obj[finite]))


@pytest.mark.parametrize("n,d", CASES)
@pytest.mark.parametrize("block", [128, 64])
def test_block_prefilter_matches_pallas_and_jnp(n, d, block):
  obj = objectives(n, d, seed=7 * n + d)
  got = ops.block_prefilter_mask(torch.from_numpy(obj), block=block).numpy()
  with jax.enable_x64(True):
    pallas = np.asarray(ref_ops.block_prefilter_mask(
        obj, block=block, use_pallas=True, interpret=True))
    jnp_path = np.asarray(ref_ops.block_prefilter_mask(obj, block=block))
  np.testing.assert_array_equal(got, pallas)
  np.testing.assert_array_equal(got, jnp_path)
  with jax.enable_x64(True):
    front = np.asarray(ref_ref.pareto_mask_ref(obj))
  assert not (front & ~got).any()  # a front superset


@pytest.mark.parametrize("n,d", CASES)
def test_block_counts_match_reference_counts(n, d):
  obj = objectives(n, d, seed=3 * n + d)
  obj_t = ops._pad_feature_major(torch.from_numpy(obj), 128)
  assert obj_t.is_contiguous() and obj_t.shape == (d, n + (-n) % 128)
  assert torch.isinf(obj_t[:, n:]).all()
  got = ref.block_dominance_counts_ref(obj_t.T, 128).numpy()
  padded = obj_t.T.numpy()
  with jax.enable_x64(True):
    want = np.asarray(ref_ref.block_dominance_counts_ref(padded, 128))
  np.testing.assert_array_equal(got, want)


def objectives_with_nan(n: int, d: int, seed: int) -> np.ndarray:
  """objectives() plus -inf entries, NaN entries, a point of NaN only and
  duplicated NaN and -inf points."""
  obj = objectives(n, d, seed)
  rng = np.random.RandomState(seed + 1)
  obj[rng.randint(0, n, max(1, n // 50)), rng.randint(0, d)] = -np.inf
  obj[rng.randint(0, n, max(1, n // 40)), rng.randint(0, d)] = np.nan
  obj[n // 2] = np.nan
  obj[n // 4] = obj[n // 5] = obj[rng.randint(0, n)]
  obj[n - 1] = -np.inf
  return obj


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("block", [64, 128, 256])
def test_block_counts_treat_nan_as_the_pallas_kernel(block, d):
  """A NaN compares false both ways: in the Pallas kernel and the plain
  version alike, a point with a NaN dominates nothing and nothing
  dominates it."""
  n = 3 * block + 5
  obj = objectives_with_nan(n, d, seed=block + d)
  obj_t = ops._pad_feature_major(torch.from_numpy(obj), block)
  got = ref.block_dominance_counts_ref(obj_t.T, block).numpy()
  with jax.enable_x64(True):
    want = np.asarray(ref_kernel.block_dominance_counts_pallas(
        obj_t.numpy(), interpret=True, block=block))
  np.testing.assert_array_equal(got, want)
  assert (got[:n][np.isnan(obj).any(axis=1)] == 0).all()


def test_empty_input():
  empty = torch.zeros((0, 3), dtype=torch.float64)
  assert ops.block_prefilter_mask(empty).shape == (0,)
  assert ops.dominance_counts(empty).shape == (0,)


def test_cpu_tensors_never_reach_the_cuda_kernel():
  kernel.reset_launch_counts()
  obj = torch.from_numpy(objectives(300, 3, seed=1))
  ops.block_prefilter_mask(obj)
  ops.dominance_counts(obj)
  assert kernel.LAUNCHES == {"block_dominance_counts": 0,
                             "dominance_counts": 0}


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
  bad = torch.zeros((3, 256), dtype=torch.float64)
  with pytest.raises(ValueError, match="CUDA tensor"):
    kernel.block_dominance_counts(bad, 128)
  with pytest.raises(ValueError, match="CUDA tensor"):
    kernel.dominance_counts(bad)
  with pytest.raises(ValueError, match="block"):
    kernel.block_dominance_counts(bad, 2048)


@pytest.mark.parametrize("n,sms,want", [
    (4096, 132, 16), (65536, 132, 2), (256, 132, 1), (512, 132, 2),
    (1 << 20, 132, 1), (4096, 114, 15), (8192, 132, 9)])
def test_pair_splits_cover_the_card_twice(n, sms, want):
  """K2's j tiles split over the fewest blocks that put two blocks on
  every SM, never more than a split a j tile; the tile is the CUDA
  source's."""
  assert kernel.PAIR_TILE == _build.csrc_constant("pareto_front",
                                                   "kPairTile")
  splits = kernel.pair_splits(n, sms)
  assert splits == want
  tiles = n // kernel.PAIR_TILE
  assert 1 <= splits <= tiles
  assert tiles * splits >= kernel.PAIR_BLOCKS_PER_SM * sms or splits == tiles


def test_missing_nvcc_raises(tmp_path, monkeypatch):
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
  monkeypatch.setattr(_build.shutil, "which", lambda name: None)
  monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
  _build.load.cache_clear()
  try:
    with pytest.raises(RuntimeError, match="nvcc not found"):
      _build.load("pareto_front")
  finally:
    _build.load.cache_clear()


def test_build_targets_are_keyed_on_source_content():
  srcs = _build.sources()
  assert [s.name for s in srcs] == ["flash_attention.cu", "int8_matmul.cu",
                                    "pareto_front.cu", "pow2_matmul.cu",
                                    "quant_decode_attn.cu", "rwkv6_scan.cu"]
  for src in srcs:
    target = _build._target(src)
    assert target.parent == _build.BUILD_DIR
    assert target.name.startswith(f"lib{src.stem}-")
