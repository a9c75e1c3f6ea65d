"""The port on a CUDA card: each hand-written kernel against its plain
torch version, and the device sweep against the same code on the CPU.

Every test here carries the ``gpu`` marker and skips without a card (the
CUDA kernels have no CPU mode).  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.workloads import get_network
from repro_torch.explore import (DesignSpace, HistogramAccumulator,
                                 ParetoAccumulator, StatsAccumulator,
                                 TopKAccumulator, TorchOracleBackend,
                                 stream_explore)
from repro_torch.kernels.pareto_front import kernel, ops, ref

pytestmark = pytest.mark.gpu

METRICS = ("latency_s", "power_mw", "area_mm2")


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernels have no CPU mode")
  return torch.device("cuda")


def _objectives(n, d, seed):
  rng = np.random.RandomState(seed)
  obj = 1.0 + rng.uniform(size=(n, d))
  obj[rng.randint(0, n, n // 5), 0] = 1.25
  rows = rng.randint(0, n, n // 10)
  obj[rows] = np.round(obj[rows], 1)
  obj[n // 3] = obj[2 * n // 3]
  obj[rng.randint(0, n, 3), rng.randint(0, d)] = np.inf
  return obj


@pytest.mark.parametrize("n,d", [(65536, 3), (1000, 2), (4097, 4), (1, 3)])
@pytest.mark.parametrize("block", [128, 64])
def test_block_kernel_matches_plain_version(cuda, n, d, block):
  obj = torch.from_numpy(_objectives(n, d, seed=n + d)).to(cuda)
  kernel.reset_launch_counts()
  got = ops.block_prefilter_mask(obj, block=block)
  obj_t = ops._pad_feature_major(obj, block)
  want = ref.block_dominance_counts_ref(obj_t.T, block)[:n] == 0
  assert torch.equal(got, want)
  assert kernel.LAUNCHES["block_dominance_counts"] == 1


@pytest.mark.parametrize("n,d", [(4096, 3), (300, 2), (513, 4)])
def test_pairwise_kernel_matches_plain_version(cuda, n, d):
  obj = torch.from_numpy(_objectives(n, d, seed=2 * n + d)).to(cuda)
  kernel.reset_launch_counts()
  assert torch.equal(ops.dominance_counts(obj), ref.dominance_counts_ref(obj))
  assert kernel.LAUNCHES["dominance_counts"] == 1


def test_kernels_reject_unsupported_objective_counts(cuda):
  obj_t = torch.zeros((5, 256), dtype=torch.float64, device=cuda)
  with pytest.raises(ValueError, match="2 to 4 objectives"):
    kernel.dominance_counts(obj_t)
  with pytest.raises(ValueError, match="float64"):
    kernel.block_dominance_counts(obj_t[:3].float().contiguous(), 128)


def test_evaluate_table_bit_identical_to_cpu(cuda):
  layers = get_network("vgg16")
  table = DesignSpace().sample_table(3000, seed=1)
  gpu = TorchOracleBackend(chunk_size=5000).evaluate_table(table, layers)
  cpu = TorchOracleBackend(chunk_size=5000, device="cpu").evaluate_table(
      table, layers)
  for c in METRICS:
    np.testing.assert_array_equal(getattr(gpu, c), getattr(cpu, c))


def test_fused_stream_identical_to_cpu(cuda):
  layers = get_network("resnet20")

  def reducers():
    return {"pareto": ParetoAccumulator(),
            "pareto3": ParetoAccumulator(("latency_s", "energy_mj",
                                          "area_mm2")),
            "top": TopKAccumulator(20, by="energy_mj"),
            "stats": StatsAccumulator("perf_per_area"),
            "hist": HistogramAccumulator("area_mm2", 0.0, 200.0, bins=64)}

  runs = {dev: stream_explore(TorchOracleBackend(chunk_size=3000, device=dev),
                              DesignSpace(), layers, n_per_type=5000, seed=3,
                              reducers=reducers(), chunk_size=3000)
          for dev in ("cuda", "cpu")}
  g, c = runs["cuda"], runs["cpu"]
  for name in ("pareto", "pareto3", "top"):
    for col in METRICS:
      np.testing.assert_array_equal(g[name].column(col), c[name].column(col))
  np.testing.assert_array_equal(g["hist"]["counts"], c["hist"]["counts"])
  for k, v in c["stats"].items():
    assert g["stats"][k] == pytest.approx(v, rel=1e-12)
