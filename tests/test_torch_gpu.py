"""The port on a CUDA card: each hand-written kernel against its plain
torch version, and the device sweep, co-exploration (the joint oracle,
the grouped prefilter, fused joint chunks), the polynomial PPA models,
the serving engine (qwen3-0.6b and rwkv6-1.6b), the deploy codecs and
guided search with its fault tolerance (journals that move between card
and CPU, the watchdog on a CUDA handle), and the QAT CNNs, their SGD
step and the weight-sharing supernet against the same code on the CPU;
K6's backward kernel against its plain version, and autograd through K6.

Every test here carries the ``gpu`` marker and skips without a card (the
CUDA kernels have no CPU mode).  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.cnn import SEARCH_SPACE, ArchChoice
from repro_torch.core.supernet import arch_to_layers
from repro_torch.core.workloads import get_network
from repro_torch.explore import (ChunkError, DesignSpace,
                                 ExplorationSession, Fault, FaultPlan,
                                 HistogramAccumulator, LayerStack,
                                 ParetoAccumulator, PolynomialBackend,
                                 ResiliencePolicy, RetryPolicy,
                                 StatsAccumulator, TopKAccumulator,
                                 TorchOracleBackend, stream_co_explore,
                                 stream_explore)
from repro_torch.explore.streaming import DISPATCH_AHEAD
from repro_torch.explore import device as device_lib
from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.int8_matmul import kernel as i8_kernel
from repro_torch.kernels.int8_matmul import ops as i8
from repro_torch.kernels.int8_matmul import ref as i8_ref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.pareto_front import kernel, ops, ref
from repro_torch.kernels.pow2_matmul import kernel as p2_kernel
from repro_torch.kernels.pow2_matmul import ops as p2
from repro_torch.kernels.quant_decode_attn import kernel as qda_kernel
from repro_torch.kernels.quant_decode_attn import ops as qda
from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_scan import ops as wkv
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
from repro_torch.models import build_model
from repro_torch.quant import QuantPolicy, pack_params
from repro_torch.serve import EngineConfig, ServeEngine

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


def _objectives_with_nan(n, d, seed):
  """_objectives plus -inf entries, NaN entries, a point of NaN only, and
  duplicated NaN and -inf points."""
  obj = _objectives(n, d, seed)
  rng = np.random.RandomState(seed + 1)
  obj[rng.randint(0, n, max(1, n // 50)), rng.randint(0, d)] = -np.inf
  obj[rng.randint(0, n, max(1, n // 40)), rng.randint(0, d)] = np.nan
  obj[n // 2] = np.nan
  obj[n // 4] = obj[n // 5] = obj[rng.randint(0, n)]
  obj[n - 1] = -np.inf
  return obj


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("block", [64, 128, 256, 1024])
def test_block_kernel_counts_nan_and_inf_as_the_plain_version(cuda, block,
                                                               d):
  """K1's ranks: 8-bit lanes up to 128, 16-bit lanes above; a point with a
  NaN dominates nothing and nothing dominates it."""
  n = 3 * block + 5
  obj = torch.from_numpy(_objectives_with_nan(n, d, seed=block + d)).to(cuda)
  obj_t = ops._pad_feature_major(obj, block)
  kernel.reset_launch_counts()
  got = kernel.block_dominance_counts(obj_t, block)
  assert kernel.LAUNCHES["block_dominance_counts"] == 1
  assert torch.equal(got, ref.block_dominance_counts_ref(obj_t.T, block))
  assert (got[:n][torch.isnan(obj).any(dim=1)] == 0).all()


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


# ---------------------------------------------------------------------------
# co-exploration: the joint oracle, the grouped prefilter and the fused
# joint chunk on the card against the same code on the CPU
# ---------------------------------------------------------------------------

def _joint_stack(n_archs, seed, image_size=16):
  """Table-4 architectures from ``RandomState(seed)`` plus a one-layer
  network, and their accuracies."""
  rng = np.random.RandomState(seed)
  archs = [ArchChoice(tuple((int(rng.choice(reps)), int(rng.choice(chs)))
                            for reps, chs in SEARCH_SPACE))
           for _ in range(n_archs - 1)]
  lists = [arch_to_layers(a, image_size=image_size) for a in archs]
  lists.append(lists[0][:1])
  return LayerStack.from_layer_lists(lists), rng.uniform(0.5, 0.95, n_archs)


def _joint_reducers():
  return {"pareto": ParetoAccumulator(("top1_err", "energy_mj", "area_mm2")),
          "pareto3": ParetoAccumulator(("latency_s", "energy_mj",
                                        "area_mm2")),
          "fig12": ParetoAccumulator(("top1_err", "energy_mj")),
          "top": TopKAccumulator(25, by="energy_mj"),
          "stats": StatsAccumulator("energy_mj"),
          "hist": HistogramAccumulator("top1_err", 0.0, 0.5, bins=16)}


@pytest.mark.parametrize("chunk_size", [97, 4096])
def test_joint_oracle_on_the_card_equals_the_cpu(cuda, chunk_size):
  """co_evaluate_table's HW chunks cut every arch's row (97 // 9 = 10 HW
  rows a chunk); one row of the stack is a one-layer network."""
  stack, _ = _joint_stack(9, seed=3)
  assert stack.n_layers().min() == 1
  hw = DesignSpace().sample_table(60, seed=4)
  got = TorchOracleBackend(chunk_size=chunk_size).co_evaluate_table(hw, stack)
  want = TorchOracleBackend(chunk_size=chunk_size,
                            device="cpu").co_evaluate_table(hw, stack)
  for c in METRICS:
    np.testing.assert_array_equal(got.column(c), want.column(c), err_msg=c)
  np.testing.assert_array_equal(got.extra["arch_id"], want.extra["arch_id"])


def test_grouped_prefilter_k1_branch_matches_plain_version(cuda):
  """Three varying objectives of a joint block go through K1 over the
  flattened (A x H) rows, every column of the spec stacked."""
  stack, accs = _joint_stack(12, seed=5)
  hw = DesignSpace(pe_types=("INT16",)).sample_table(700, seed=6)
  spec = device_lib.ParetoSpec(("top1_err", "latency_s", "energy_mj",
                                "area_mm2"), ())
  masks = []
  for dev in (cuda, torch.device("cpu")):
    backend = TorchOracleBackend(device=dev)
    _, reduced = backend._co_dispatch(
        hw, stack, plan=device_lib.DevicePlan((("p", spec),)), accs=accs)
    full = backend._co_dispatch(hw, stack, accs=accs)
    lat = full[0]
    cols = device_lib._derive_columns(
        lat, full[1][None, :].expand(lat.shape),
        full[2][None, :].expand(lat.shape),
        accs=torch.from_numpy(accs).to(dev))
    kernel.reset_launch_counts()
    masks.append(device_lib._pareto_prefilter(cols, spec, grouped=True).cpu())
    launches = kernel.LAUNCHES["block_dominance_counts"]
    assert launches == (1 if dev.type == "cuda" else 0)
    assert int(reduced["p"]["count"]) == int(masks[-1].sum())
  assert torch.equal(masks[0], masks[1])
  assert 0 < int(masks[0].sum()) < masks[0].numel()


@pytest.mark.parametrize("cap", [device_lib.DEFAULT_SURVIVOR_CAP, 8])
def test_fused_joint_chunk_on_the_card_equals_the_cpu(cuda, cap):
  """A fused joint block's payloads (survivors with their arch columns,
  the overflow fallback at a cap of 8, stats, histogram) card vs CPU."""
  stack, accs = _joint_stack(10, seed=7)
  hw = DesignSpace().sample_table(50, seed=8)
  plan = device_lib.build_plan(_joint_reducers(), joint=True, cap=cap)
  idx = 1000 + np.arange(len(hw) * stack.n_archs)
  archs = tuple(range(20))
  chunks = [TorchOracleBackend(device=dev).fused_co_eval_pending(
      hw, stack, "coexplore", plan, idx, 5, accs, archs).resolve()
      for dev in (cuda, "cpu")]
  g, c = chunks
  assert (g.n_rows, g.n_transferred, g.n_overflows) == \
      (c.n_rows, c.n_transferred, c.n_overflows)
  assert (c.n_overflows > 0) == (cap == 8)
  for name in ("pareto", "pareto3", "fig12", "top"):
    (_, gf, gi), (_, cf, ci) = g.payloads[name], c.payloads[name]
    np.testing.assert_array_equal(gi, ci)
    for col in METRICS + ("arch_id", "top1"):
      np.testing.assert_array_equal(gf.column(col), cf.column(col))
  np.testing.assert_array_equal(g.payloads["hist"][1], c.payloads["hist"][1])
  for k, v in c.payloads["stats"][1].items():
    assert g.payloads["stats"][1][k] == pytest.approx(v, rel=1e-12)


def test_stream_co_explore_on_the_card_equals_the_cpu(cuda):
  archs = (ArchChoice(((1, 40), (2, 96), (1, 160), (3, 320), (2, 512))),
           ArchChoice(((2, 64), (1, 80), (3, 256), (1, 384), (1, 320))),
           ArchChoice(((1, 48), (1, 112), (2, 192), (2, 448), (3, 384))))
  arch_accs = list(zip(archs, (0.61, 0.83, 0.77)))
  res = {}
  for dev in ("cuda", "cpu"):
    res[dev] = stream_co_explore(
        TorchOracleBackend(device=dev), DesignSpace(), arch_accs,
        n_hw_per_type=45, seed=3, image_size=16, reducers=_joint_reducers(),
        chunk_size=40)  # 45 HW rows a type: every arch's row cut in two
  g, c = res["cuda"], res["cpu"]
  assert g.meta["n_chunks"] == c.meta["n_chunks"] == 3 * 2 * 4
  for name in ("pareto", "pareto3", "fig12", "top"):
    for col in METRICS + ("arch_id", "top1"):
      np.testing.assert_array_equal(g[name].column(col), c[name].column(col))
  np.testing.assert_array_equal(g["hist"]["counts"], c["hist"]["counts"])


def test_poly_co_evaluate_table_across_the_chunk_edge(cuda, poly_models):
  """The joint polynomial path over more HW rows than one chunk of
  ``32,768 // max_layers``: card and CPU bit-equal."""
  gpu, cpu = _poly_pair(poly_models, cuda)
  stack, _ = _joint_stack(3, seed=9)
  edge = 32768 // stack.max_layers
  hw = DesignSpace(pe_types=("INT16",)).sample_table(edge + 3, seed=10)
  got = gpu.co_evaluate_table(hw, stack)
  want = cpu.co_evaluate_table(hw, stack)
  for c in METRICS:
    np.testing.assert_array_equal(got.column(c), want.column(c), err_msg=c)


# ---------------------------------------------------------------------------
# K6 and K5 (serving).  The kernels and their plain versions read the same
# inputs and both accumulate in float32 (matmul TF32 is off by default);
# they differ only in the order of the sums, hence 1e-4 of the largest
# |output| for float32 and bf16 inputs alike.
# ---------------------------------------------------------------------------

def _rel_err(got, want) -> float:
  return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def _normal(rng, shape, device, dtype=torch.float32):
  return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
      device=device, dtype=dtype)


# (b, s, h, hkv, d, causal, window): the serving shape, windowed, ragged S,
# G = 1, 2, 4 and 8, non-causal, every head dim; S at the 64-row tile
# edges and one past the serving bucket; D = 64 with G = 2
FLASH_CASES = [(1, 512, 16, 8, 128, True, 0), (1, 512, 16, 8, 128, True, 128),
               (1, 300, 8, 2, 64, True, 0), (2, 96, 4, 4, 32, False, 0),
               (1, 70, 8, 1, 16, True, 24), (1, 63, 16, 8, 128, True, 0),
               (1, 64, 16, 8, 128, True, 0), (1, 65, 16, 8, 128, True, 0),
               (1, 513, 16, 8, 128, True, 0), (2, 200, 8, 4, 64, True, 0)]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(cuda, case, dtype):
  b, s, h, hkv, d, causal, window = case
  rng = np.random.RandomState(s + h)
  q = _normal(rng, (b, s, h, d), cuda, dtype)
  kv = _normal(rng, (b, s, 2, hkv, d), cuda, dtype)
  k, v = kv[:, :, 0], kv[:, :, 1]  # strided views, as the model passes v
  fa_kernel.reset_launch_counts()
  got = fa.flash_attention(q, k, v, causal=causal, window=window)
  assert fa_kernel.LAUNCHES["flash_attention"] == 1
  want = fa.flash_attention_reference(q, k, v, causal=causal, window=window)
  torch.cuda.synchronize()
  assert got.dtype == torch.float32 and got.shape == (b, s, h, d)
  assert _rel_err(got, want) < 1e-4


# K6's backward: the kernels against the plain backward on the same q, k,
# v, output, output gradient and lse.  Everything inside is float32, so
# float32 inputs are held to 1e-5 of each gradient's largest |value|;
# bf16 inputs add the final bf16 rounding of dq, dk and dv (unit roundoff
# 2^-8) and f32 sums of at most S * G terms, each 2^-24 (a larger bound).
FLASH_BWD_CASES = [(2, 512, 16, 8, 128, True, 0),
                   (1, 512, 16, 8, 128, True, 128),
                   (1, 63, 16, 8, 128, True, 0), (1, 65, 16, 8, 128, True, 0),
                   (1, 513, 16, 8, 128, True, 0), (2, 200, 8, 4, 64, True, 0),
                   (1, 300, 8, 4, 64, True, 0), (2, 96, 4, 4, 32, False, 0),
                   (1, 70, 8, 1, 16, True, 24)]


def _bwd_bound(dtype, s, g):
  return 1e-5 if dtype == torch.float32 else 2.0 ** -8 + s * g * 2.0 ** -24


@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernel_matches_plain_version(cuda, case, dtype):
  b, s, h, hkv, d, causal, window = case
  rng = np.random.RandomState(s + h + 1)
  q = _normal(rng, (b, s, h, d), cuda, dtype)
  kv = _normal(rng, (b, s, 2, hkv, d), cuda, dtype)
  k, v = kv[:, :, 0], kv[:, :, 1]
  dout = _normal(rng, (b, s, h, d), cuda)
  out, lse = fa_kernel.flash_attention(q, k, v, 1.0 / d ** 0.5, causal,
                                       window, return_lse=True)
  want_lse = fa.flash_attention_lse_reference(q, k, causal, window)
  assert _rel_err(lse, want_lse) < 1e-5
  fa_kernel.reset_launch_counts()
  got = fa_kernel.flash_attention_bwd(q, k, v, out, dout, lse, 1.0 / d ** 0.5,
                                      causal, window)
  assert fa_kernel.LAUNCHES["flash_attention_bwd"] == 1
  want = fa.flash_attention_bwd_reference(q, k, v, out, dout, lse, causal,
                                          window)
  torch.cuda.synchronize()
  for name, x, y in zip(("dq", "dk", "dv"), got, want):
    assert x.dtype == dtype and x.shape == y.shape, name
    assert _rel_err(x.float(), y) < _bwd_bound(dtype, s, h // hkv), name


def test_flash_backward_kernel_is_deterministic(cuda):
  rng = np.random.RandomState(23)
  b, s, h, hkv, d = 2, 513, 16, 8, 128
  q = _normal(rng, (b, s, h, d), cuda, torch.bfloat16)
  kv = _normal(rng, (b, s, 2, hkv, d), cuda, torch.bfloat16)
  k, v = kv[:, :, 0], kv[:, :, 1]
  dout = _normal(rng, (b, s, h, d), cuda)
  out, lse = fa_kernel.flash_attention(q, k, v, 1.0 / d ** 0.5,
                                       return_lse=True)
  first = fa_kernel.flash_attention_bwd(q, k, v, out, dout, lse,
                                        1.0 / d ** 0.5)
  again = fa_kernel.flash_attention_bwd(q, k, v, out, dout, lse,
                                        1.0 / d ** 0.5)
  for x, y in zip(first, again):
    assert torch.equal(x, y)


def test_flash_attention_gradient_goes_through_the_kernels(cuda):
  """Autograd through ``ops.flash_attention`` on the card launches K6 with
  its lse and K6's backward, and equals autograd through the plain
  version; without a gradient, the output is the serving kernel's, bit
  for bit."""
  rng = np.random.RandomState(5)
  b, s, h, hkv, d = 1, 130, 8, 4, 64
  q = _normal(rng, (b, s, h, d), cuda).requires_grad_()
  kv = _normal(rng, (b, s, 2, hkv, d), cuda).requires_grad_()
  dout = _normal(rng, (b, s, h, d), cuda)
  fa_kernel.reset_launch_counts()
  out = fa.flash_attention(q, kv[:, :, 0], kv[:, :, 1])
  got = torch.autograd.grad(out, (q, kv), dout)
  assert fa_kernel.LAUNCHES == {"flash_attention": 1,
                                "flash_attention_bwd": 1}
  ref_out = fa.flash_attention_reference(q, kv[:, :, 0], kv[:, :, 1])
  want = torch.autograd.grad(ref_out, (q, kv), dout)
  for x, y in zip(got, want):
    assert _rel_err(x, y) < 1e-5
  with torch.no_grad():
    plain = fa_kernel.flash_attention(q, kv[:, :, 0], kv[:, :, 1],
                                      1.0 / d ** 0.5)
  assert torch.equal(out.detach(), plain)


# (b, h, hkv, s, d, lengths): lengths 1, mid and S of the serving cache and
# at the 128-position chunk edges; G = 1, 2, 4 and 8; ragged S; a batch
# whose rows hold 0 and S positions; a cache of 32 chunks (4 a block)
DECODE_CASES = [(1, 16, 8, 2048, 128, (1,)), (1, 16, 8, 2048, 128, (300,)),
                (1, 16, 8, 2048, 128, (2048,)), (2, 8, 2, 70, 16, (70, 9)),
                (1, 4, 4, 96, 32, (37,)), (1, 16, 2, 600, 64, (599,)),
                (1, 16, 8, 2048, 128, (127,)), (1, 16, 8, 2048, 128, (128,)),
                (1, 16, 8, 2048, 128, (129,)),
                (1, 16, 8, 2048, 128, (2047,)),
                (2, 16, 8, 2048, 128, (0, 2048)),
                (1, 64, 8, 300, 128, (300,)),
                (1, 16, 8, 4096, 128, (3000,))]


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain_version(cuda, case, dtype):
  b, h, hkv, s, d, lengths = case
  rng = np.random.RandomState(s + h)
  q = _normal(rng, (b, h, d), cuda, dtype)
  cache = qda.quantize_kv(_normal(rng, (b, hkv, s, d), cuda),
                          _normal(rng, (b, hkv, s, d), cuda))
  lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
  qda_kernel.reset_launch_counts()
  got = qda.quant_decode_attn(q, *cache, lens)
  assert qda_kernel.LAUNCHES["quant_decode_attn"] == 1
  want = qda.quant_decode_attn_reference(q, *cache, lens)
  torch.cuda.synchronize()
  assert got.dtype == torch.float32 and got.shape == (b, h, d)
  assert _rel_err(got, want) < 1e-4


def test_decode_kernel_gives_zero_for_an_empty_cache(cuda):
  rng = np.random.RandomState(0)
  q = _normal(rng, (1, 4, 32), cuda)
  cache = qda.quantize_kv(_normal(rng, (1, 2, 40, 32), cuda),
                          _normal(rng, (1, 2, 40, 32), cuda))
  out = qda.quant_decode_attn(q, *cache,
                              torch.zeros(1, dtype=torch.int32, device=cuda))
  assert torch.equal(out, torch.zeros_like(out))


def test_decode_kernel_replays_in_a_cuda_graph_as_length_changes(cuda):
  """One K5 call captured as a CUDA graph reads ``length`` on the device:
  each replay after an in-place change of ``length`` equals the plain
  version at the new length."""
  rng = np.random.RandomState(4)
  b, h, hkv, s, d = 2, 16, 8, 2048, 128
  q = _normal(rng, (b, h, d), cuda, torch.bfloat16)
  cache = qda.quantize_kv(_normal(rng, (b, hkv, s, d), cuda),
                          _normal(rng, (b, hkv, s, d), cuda))
  lens = torch.tensor([513, 5], dtype=torch.int32, device=cuda)
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    qda.quant_decode_attn(q, *cache, lens)
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    out = qda.quant_decode_attn(q, *cache, lens)
  for new in ([513, 5], [514, 0], [2048, 129], [1, 2047], [127, 128]):
    lens.copy_(torch.tensor(new, dtype=torch.int32))
    graph.replay()
    want = qda.quant_decode_attn_reference(q, *cache, lens)
    torch.cuda.synchronize()
    assert _rel_err(out, want) < 1e-4, new


def test_quantize_kv_on_the_card_equals_the_cpu(cuda):
  rng = np.random.RandomState(1)
  k = _normal(rng, (1, 8, 512, 128), "cpu") * 3
  v = _normal(rng, (1, 8, 512, 128), "cpu")
  for got, want in zip(qda.quantize_kv(k.to(cuda), v.to(cuda)),
                       qda.quantize_kv(k, v)):
    assert torch.equal(got.cpu(), want)


def test_attention_wrappers_refuse_what_the_kernels_do_not_take(cuda):
  q = torch.zeros((1, 64, 4, 32), device=cuda)
  kv = torch.zeros((1, 64, 2, 32), device=cuda)
  with pytest.raises(ValueError, match="expected a CUDA tensor"):
    fa_kernel.flash_attention(q, kv.cpu(), kv, 0.1)
  with pytest.raises(ValueError, match="head dim"):
    fa_kernel.flash_attention(q[..., :24], kv[..., :24], kv[..., :24], 0.1)
  with pytest.raises(ValueError, match="like q"):
    fa_kernel.flash_attention(q, kv.bfloat16(), kv, 0.1)
  with pytest.raises(ValueError, match="multiple"):
    fa.flash_attention(q[:, :, :3], kv, kv)
  # bf16 tiles arrive in 16-byte copies: a base off 16 bytes, or a stride
  # that is not a multiple of 8 elements, is refused
  qb, kvb = q.bfloat16(), kv.bfloat16()
  off = torch.zeros(qb.numel() + 1, dtype=torch.bfloat16,
                    device=cuda)[1:].view(qb.shape)
  with pytest.raises(ValueError, match="16-byte aligned"):
    fa_kernel.flash_attention(off, kvb, kvb, 0.1)
  wide = torch.zeros((1, 64, 4, 36), dtype=torch.bfloat16,
                     device=cuda)[..., :32]
  with pytest.raises(ValueError, match="multiples of 8"):
    fa_kernel.flash_attention(wide, kvb, kvb, 0.1)
  codes = torch.zeros((1, 2, 64, 32), dtype=torch.int8, device=cuda)
  scales = torch.zeros((1, 2, 64), device=cuda)
  lens = torch.ones(1, dtype=torch.int32, device=cuda)
  with pytest.raises(ValueError, match="is on cpu"):
    qda_kernel.quant_decode_attn(q[:, 0], codes, scales, codes, scales,
                                 lens.cpu(), 0.1)
  with pytest.raises(ValueError, match="contiguous"):
    qda_kernel.quant_decode_attn(q[:, 0], codes.transpose(2, 3).contiguous()
                                 .transpose(2, 3), scales, codes, scales,
                                 lens, 0.1)
  with pytest.raises(ValueError, match="must be one of"):
    qda_kernel.quant_decode_attn(q[:, 0, :3], codes[:, :1].contiguous(),
                                 scales[:, :1].contiguous(),
                                 codes[:, :1].contiguous(),
                                 scales[:, :1].contiguous(), lens, 0.1)
  with pytest.raises(ValueError, match="int32"):
    qda_kernel.quant_decode_attn(q[:, 0], codes, scales, codes, scales,
                                 lens.long(), 0.1)


@pytest.mark.parametrize("kv_quant", ["int8", "none"])
def test_serve_engine_on_the_card_matches_the_cpu(cuda, kv_quant):
  # The card's K and V differ from the CPU's in the last bits (other sum
  # orders), so a value within an ulp of a rounding boundary can take the
  # neighbouring int8 code: decode over an int8 cache is held to 1e-3 of
  # the largest |logit| (the serving smoke's bound), the rest to 1e-4.
  decode_tol = 1e-3 if kv_quant == "int8" else 1e-4
  cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen3-0.6b")),
                            kv_quant=kv_quant)
  cpu_model = build_model(cfg, device="cpu")
  cpu_params = cpu_model.init(0)
  gpu_model = build_model(cfg)
  gpu_params = gpu_model.from_state(cpu_params.state_dict())
  toks = torch.from_numpy(
      np.random.RandomState(2).randint(0, 512, (1, 40)).astype(np.int32))
  want, want_cache = cpu_model.prefill(cpu_params, toks, 64)
  got, got_cache = gpu_model.prefill(gpu_params, toks.to(cuda), 64)
  assert _rel_err(got.cpu(), want) < 1e-4
  nxt = want.argmax(-1).to(torch.int32)
  want, _ = cpu_model.decode_step(cpu_params, nxt, want_cache)
  got, _ = gpu_model.decode_step(gpu_params, nxt.to(cuda), got_cache)
  assert _rel_err(got.cpu(), want) < decode_tol

  rng = np.random.RandomState(3)
  prompts = [rng.randint(0, 512, n) for n in (5, 9, 16, 20)]
  ecfg = EngineConfig(batch_slots=2, max_len=64, prompt_bucket=16)
  runs = {}
  for device, model, params in (("cpu", cpu_model, cpu_params),
                                ("cuda", gpu_model, gpu_params)):
    engine = ServeEngine(model, params, ecfg, device=device)
    for p in prompts:
      engine.submit(p, max_new_tokens=6)
    fa_kernel.reset_launch_counts()
    qda_kernel.reset_launch_counts()
    runs[device] = engine.run_until_drained()
  assert runs["cuda"] == runs["cpu"]
  assert fa_kernel.LAUNCHES["flash_attention"] == cfg.n_layers * 4
  assert qda_kernel.LAUNCHES["quant_decode_attn"] == (
      cfg.n_layers * 4 * 5 if kv_quant == "int8" else 0)


# ---------------------------------------------------------------------------
# K7 (rwkv6 prefill).  The kernel and its plain chunked version read the
# same inputs and both compute in float32; they differ in the order of the
# sums and in expf, hence 1e-4 of the largest |value|.
# ---------------------------------------------------------------------------

def _wkv_inputs(rng, b, t, h, d, device, dtype, s0, tiny_w=False):
  """r/k/v/w as the model passes them: (B, H, T, D) views of (B, T, H, D)
  projections; w float32 in (0, 1) from the model's exp(-exp(.)), or with
  ``tiny_w`` drawn from 1e-30 (the kernel's clamp) to 0.9999 with a tenth
  of the entries at either end."""
  def heads(x):
    return x.view(b, t, h, d).transpose(1, 2)
  r, k, v = (heads(_normal(rng, (b, t, h * d), device, dtype) * s)
             for s in (0.5, 0.5, 1.0))
  w = heads(torch.exp(-torch.exp(_normal(rng, (b, t, h * d), device) - 1.0)))
  if tiny_w:
    ws = rng.uniform(1e-30, 0.9999, (b, t, h * d)).astype(np.float32)
    pick = rng.uniform(size=ws.shape)
    ws[pick < 0.05] = 1e-30
    ws[pick > 0.95] = 0.9999
    w = heads(torch.from_numpy(ws).to(device))
  u = _normal(rng, (h, d), device) * 0.3
  state = _normal(rng, (b, h, d, d), device) * 0.1 if s0 else None
  return r, k, v, w, u, state


# (b, t, h, d, chunk, s0, tiny_w): the serving shape, ragged T, every head
# dim; more chunks than K7's 8-block cluster (a block owns 2 and 8), T
# below one chunk, and w down to 1e-30
WKV_CASES = [(1, 512, 32, 64, 64, False, False),
             (1, 512, 32, 64, 64, True, False),
             (2, 300, 4, 64, 64, True, False), (1, 40, 4, 16, 16, True, False),
             (2, 100, 3, 32, 32, False, False), (1, 1, 2, 64, 64, True, False),
             (1, 1100, 4, 64, 64, True, False),
             (1, 4096, 2, 64, 64, False, False),
             (2, 40, 4, 64, 64, True, False),
             (1, 512, 32, 64, 64, True, True), (1, 1100, 4, 32, 32, True, True)]


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_matches_plain_version(cuda, case, dtype):
  b, t, h, d, chunk, s0, tiny_w = case
  rng = np.random.RandomState(t + h + d)
  r, k, v, w, u, state = _wkv_inputs(rng, b, t, h, d, cuda, dtype, s0,
                                     tiny_w)
  wkv_kernel.reset_launch_counts()
  got_o, got_s = wkv.wkv6(r, k, v, w, u, state, chunk=chunk)
  assert wkv_kernel.LAUNCHES["wkv6"] == 1
  zero = torch.zeros((b, h, d, d), device=cuda)
  want_o, want_s = wkv_ref.wkv6_chunked(r, k, v, w, u,
                                        zero if state is None else state,
                                        chunk)
  torch.cuda.synchronize()
  assert got_o.dtype == got_s.dtype == torch.float32
  assert got_o.shape == (b, h, t, d) and got_s.shape == (b, h, d, d)
  assert _rel_err(got_o, want_o) < 1e-4
  assert _rel_err(got_s, want_s) < 1e-4
  assert torch.isfinite(got_o).all() and torch.isfinite(got_s).all()


def _replays_bit_equal(call):
  """Two eager calls give the same bits (no atomics), and the call
  captured as a CUDA graph replays to the same bits."""
  first = [x.clone() for x in call()]
  assert all(torch.equal(a, b) for a, b in zip(first, call()))
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    call()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    out = call()
  for x in out:
    x.zero_()
  graph.replay()
  torch.cuda.synchronize()
  assert all(torch.equal(a, b) for a, b in zip(first, out))


@pytest.mark.parametrize("t", [512, 2048])
def test_wkv6_kernel_is_deterministic_and_replays_in_a_cuda_graph(cuda, t):
  """K7's cluster launch: bit-equal run to run and under graph replay."""
  rng = np.random.RandomState(t)
  args = _wkv_inputs(rng, 1, t, 8, 64, cuda, torch.bfloat16, True)
  wkv_kernel.reset_launch_counts()
  _replays_bit_equal(lambda: wkv_kernel.wkv6(*args))
  assert wkv_kernel.LAUNCHES["wkv6"] >= 3


def test_wkv6_kernel_refuses_what_it_does_not_take(cuda):
  rng = np.random.RandomState(0)
  r, k, v, w, u, state = _wkv_inputs(rng, 1, 16, 2, 64, cuda,
                                     torch.float32, True)
  with pytest.raises(ValueError, match="expected a CUDA tensor"):
    wkv_kernel.wkv6(r.cpu(), k, v, w, u, state)
  with pytest.raises(ValueError, match="u is on cpu"):
    wkv_kernel.wkv6(r, k, v, w, u.cpu(), state)
  with pytest.raises(ValueError, match="like r"):
    wkv_kernel.wkv6(r, k.bfloat16(), v, w, u, state)
  with pytest.raises(ValueError, match="w: expected float32"):
    wkv_kernel.wkv6(r, k, v, w.bfloat16(), u, state)
  with pytest.raises(ValueError, match="head dim"):
    wkv_kernel.wkv6(*(x[..., :48] for x in (r, k, v, w)), u[:, :48])
  with pytest.raises(ValueError, match="chunk"):
    wkv_kernel.wkv6(r, k, v, w, u, state, chunk=65)
  with pytest.raises(ValueError, match="s0: expected shape"):
    wkv_kernel.wkv6(r, k, v, w, u, state[:, :1])
  with pytest.raises(ValueError, match="contiguous last dim"):
    wkv_kernel.wkv6(r.transpose(2, 3), k, v, w, u, state)


def test_rwkv6_full_width_two_layers_on_the_card_match_the_cpu(cuda):
  """rwkv6-1.6b at full width, float32, depth cut to 2 layers, TF32 off:
  a prefill (K7 on the card) and 3 decode steps, the card against the
  CPU on the same weights; logits within 1e-4 of the largest |logit|."""
  torch.backends.cuda.matmul.allow_tf32 = False
  cfg = dataclasses.replace(get_config("rwkv6-1.6b"), dtype="float32",
                            n_layers=2)
  cpu_model = build_model(cfg, device="cpu")
  cpu_params = cpu_model.init(0)
  gpu_model = build_model(cfg)
  gpu_params = gpu_model.from_state(cpu_params.state_dict())
  toks = torch.from_numpy(np.random.RandomState(5).randint(
      0, cfg.vocab_size, (1, 70)).astype(np.int32))
  wkv_kernel.reset_launch_counts()
  want, want_cache = cpu_model.prefill(cpu_params, toks, 128)
  got, got_cache = gpu_model.prefill(gpu_params, toks.to(cuda), 128)
  assert wkv_kernel.LAUNCHES["wkv6"] == cfg.n_layers
  assert _rel_err(got.cpu(), want) < 1e-4
  for g, c in zip(got_cache["layers"], want_cache["layers"]):
    assert _rel_err(g["s"].cpu(), c["s"]) < 1e-4
  for _ in range(3):
    nxt = want.argmax(-1).to(torch.int32)
    assert torch.equal(got.argmax(-1).cpu(), nxt.long())
    want, _ = cpu_model.decode_step(cpu_params, nxt, want_cache)
    got, _ = gpu_model.decode_step(gpu_params, nxt.to(cuda), got_cache)
    assert _rel_err(got.cpu(), want) < 1e-4
  assert wkv_kernel.LAUNCHES["wkv6"] == cfg.n_layers


def test_rwkv_serve_engine_on_the_card_matches_the_cpu(cuda):
  cfg = reduce_for_smoke(get_config("rwkv6-1.6b"))
  cpu_model = build_model(cfg, device="cpu")
  cpu_params = cpu_model.init(0)
  gpu_model = build_model(cfg)
  gpu_params = gpu_model.from_state(cpu_params.state_dict())
  rng = np.random.RandomState(3)
  prompts = [rng.randint(0, 512, n) for n in (5, 9, 16, 20)]
  ecfg = EngineConfig(batch_slots=2, max_len=64, prompt_bucket=16)
  runs = {}
  for device, model, params in (("cpu", cpu_model, cpu_params),
                                ("cuda", gpu_model, gpu_params)):
    engine = ServeEngine(model, params, ecfg, device=device)
    for p in prompts:
      engine.submit(p, max_new_tokens=6)
    wkv_kernel.reset_launch_counts()
    runs[device] = engine.run_until_drained()
  assert runs["cuda"] == runs["cpu"]
  assert wkv_kernel.LAUNCHES["wkv6"] == cfg.n_layers * len(prompts)


# ---------------------------------------------------------------------------
# K3 and K4 (the deploy codecs).  K3 is exact: an int32 sum and the
# reference's two float32 multiplies, so atol 0.  K4 sums in float32 and
# multiplies by the scale after the sum, where its plain version folds the
# scale into the weights: 1e-5 of the largest |output|.
# ---------------------------------------------------------------------------

# (m, k, n): qwen3-0.6b's ffn/wi at decode and prefill, ragged M, K and N,
# N not a multiple of 4 (byte loads), K not a multiple of 4, and M = 1;
# M at and just past the decode-path threshold of K3 and K4 (16), and K
# not a multiple of their 64-row K tile on both of their paths; the other
# three (K, N) of a qwen3-0.6b layer at a decode token and a 512-token
# prompt; K not a multiple of 32 (one s8 mma step) on K3's tensor-core
# path; and K3's split of K over a cluster with 17 K tiles, the last one
# partial, over 4 blocks on the tensor-core path and over 8 on the decode
# path
CODEC_CASES = [(1, 1024, 3072), (512, 1024, 3072), (5, 1000, 70),
               (5, 1000, 72), (130, 999, 66), (1, 64, 2), (65, 3072, 1024),
               (16, 1024, 3072), (17, 1024, 3072), (40, 1056, 256),
               (3, 1056, 3072), (1, 1024, 2048), (512, 1024, 2048),
               (1, 2048, 1024), (512, 2048, 1024), (1, 3072, 1024),
               (512, 3072, 1024), (40, 1000, 72), (512, 1040, 1024)]


@pytest.mark.parametrize("xs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CODEC_CASES, ids=str)
def test_int8_kernel_equals_plain_version(cuda, case, xs_dtype):
  m, k, n = case
  rng = np.random.RandomState(m + k + n)
  xq = torch.from_numpy(rng.randint(-128, 128, (m, k)).astype(np.int8))
  wq = torch.from_numpy(rng.randint(-128, 128, (k, n)).astype(np.int8))
  xq[0], wq[:, 0] = -128, -128        # the largest |sum|: 128^2 K
  xs = torch.from_numpy(rng.uniform(1e-3, 1e-1, m).astype(np.float32))
  ws = torch.from_numpy(rng.uniform(1e-3, 1e-1, n).astype(np.float32))
  args = [a.to(cuda) for a in (xq, wq, xs.to(xs_dtype), ws)]
  i8_kernel.reset_launch_counts()
  got = i8_kernel.int8_matmul(*args)
  assert i8_kernel.LAUNCHES["int8_matmul"] == 1
  assert torch.equal(got, i8_ref.int8_matmul_ref(*args))
  assert torch.equal(got.cpu(), i8_ref.int8_matmul_ref(
      xq, wq, xs.to(xs_dtype), ws))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CODEC_CASES, ids=str)
@pytest.mark.parametrize("k_terms", [1, 2])
def test_pow2_kernel_matches_plain_version(cuda, k_terms, case, dtype):
  m, k, n = case
  rng = np.random.RandomState(m + k + n + k_terms)
  x = _normal(rng, (m, k), cuda, dtype)
  w = _normal(rng, (k, n), cuda) * 0.05
  weights = p2.quantize_weights(w, k_terms)
  p2_kernel.reset_launch_counts()
  got = p2.pow2_matmul(x, weights)
  assert p2_kernel.LAUNCHES["pow2_matmul"] == 1
  assert _rel_err(got, p2.pow2_matmul_reference(x, weights)) <= 1e-5


@pytest.mark.parametrize("m", [1, 512])
@pytest.mark.parametrize("k_terms", [1, 2])
def test_pow2_kernel_is_deterministic_and_replays_in_a_cuda_graph(
    cuda, k_terms, m):
  """K4's decode path (a cluster launch) and tensor-core path: bit-equal
  run to run and under graph replay."""
  rng = np.random.RandomState(m + k_terms)
  x = _normal(rng, (m, 1024), cuda, torch.bfloat16)
  weights = p2.quantize_weights(_normal(rng, (1024, 3072), cuda) * 0.05,
                                k_terms)
  _replays_bit_equal(lambda: (p2.pow2_matmul(x, weights),))


@pytest.mark.parametrize("m,n", [(1, 3072), (512, 3072), (512, 1024)])
def test_int8_kernel_is_deterministic_and_replays_in_a_cuda_graph(cuda, m,
                                                                  n):
  """K3's decode path, its tensor-core path, and its tensor-core path with
  K split over a cluster: bit-equal run to run and under graph replay."""
  rng = np.random.RandomState(m + n)
  xq = torch.from_numpy(rng.randint(-128, 128, (m, 3072)).astype(np.int8))
  wq = torch.from_numpy(rng.randint(-128, 128, (3072, n)).astype(np.int8))
  xs = torch.from_numpy(rng.uniform(1e-3, 1e-1, m).astype(np.float32))
  ws = torch.from_numpy(rng.uniform(1e-3, 1e-1, n).astype(np.float32))
  args = [a.to(cuda) for a in (xq, wq, xs.to(torch.bfloat16), ws)]
  _replays_bit_equal(lambda: (i8_kernel.int8_matmul(*args),))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_on_the_card_equals_the_cpu(cuda, dtype):
  """Activation quantization is exact on both devices, so K3 on the card
  equals the plain version on the CPU bit for bit."""
  rng = np.random.RandomState(8)
  x = _normal(rng, (64, 1024), "cpu", dtype) * 3
  x[7] = 0
  w = _normal(rng, (1024, 3072), "cpu") * 0.05
  weights = i8.quantize_weights(w)
  on_card = i8.Int8Weights(weights.codes.to(cuda), weights.scale.to(cuda),
                           weights.k, weights.n)
  assert torch.equal(i8.quantize_weights(w.to(cuda)).codes.cpu(),
                     weights.codes)
  assert torch.equal(i8.int8_matmul(x.to(cuda), on_card).cpu(),
                     i8.int8_matmul(x, weights))


@pytest.mark.parametrize("pe_type", ["INT16", "INT8", "INT4", "LightPE-1",
                                     "LightPE-2"])
def test_pack_params_on_the_card_equals_the_cpu(cuda, pe_type):
  cfg = reduce_for_smoke(get_config("qwen3-0.6b"))
  gpu = build_model(cfg).init(0)
  cpu = build_model(cfg, device="cpu").from_state(
      {k: v.cpu() for k, v in gpu.state_dict().items()})
  policy = QuantPolicy(pe_type=pe_type)
  got = pack_params(convert.params_to_tree(cfg, gpu), policy)
  want = pack_params(convert.params_to_tree(cfg, cpu), policy)
  for name in ("wq", "wkv", "wo"):
    g, c = got["blocks"]["sub0"]["mix"][name], want["blocks"]["sub0"]["mix"][
        name]
    assert g["fmt"] == c["fmt"] and g["shape"] == c["shape"]
    assert torch.equal(g["codes"].cpu(), c["codes"])
    assert torch.equal(g["scale"].cpu().view(torch.int32),
                       c["scale"].view(torch.int32))


def test_codec_wrappers_refuse_what_the_kernels_do_not_take(cuda):
  x = torch.zeros((4, 64), dtype=torch.int8, device=cuda)
  w = torch.zeros((64, 8), dtype=torch.int8, device=cuda)
  ones = torch.ones(8, device=cuda)
  with pytest.raises(ValueError, match="expected x"):
    i8_kernel.int8_matmul(x, w[:32], torch.ones(4, device=cuda), ones)
  with pytest.raises(ValueError, match="is on cpu"):
    i8_kernel.int8_matmul(x, w, torch.ones(4), ones)
  with pytest.raises(ValueError, match="contiguous"):
    i8_kernel.int8_matmul(x, w.t().contiguous().t(),
                          torch.ones(4, device=cuda), ones)
  with pytest.raises(ValueError, match="w_scale"):
    i8_kernel.int8_matmul(x, w, torch.ones(4, device=cuda), ones.half())
  xf = torch.zeros((4, 64), device=cuda)
  codes = torch.zeros((64, 4), dtype=torch.uint8, device=cuda)
  with pytest.raises(ValueError, match="odd"):
    p2_kernel.pow2_matmul(xf, codes, torch.ones(7, device=cuda), 1)
  with pytest.raises(ValueError, match="codes"):
    p2_kernel.pow2_matmul(xf, codes, ones, 2)
  with pytest.raises(ValueError, match="k_terms"):
    p2_kernel.pow2_matmul(xf, codes, ones, 3)
  with pytest.raises(ValueError, match="x:"):
    p2_kernel.pow2_matmul(xf.half(), codes, ones, 1)


# ---------------------------------------------------------------------------
# the polynomial PPA models: the card's fixed-order sums equal the CPU's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def poly_models():
  """The paper's fit (degree 5, 240 designs a type, resnet20 + vgg16):
  126-monomial power and area models, 603-monomial latency models."""
  layers = get_network("resnet20") + get_network("vgg16")
  return PolynomialBackend.fit(layers=layers, degree=5, n_train=240,
                               device="cpu").models


def _poly_pair(models, cuda):
  return (PolynomialBackend(models, device=cuda),
          PolynomialBackend(models, device="cpu"))


@pytest.mark.parametrize("pe_type", ["FP32", "INT16", "LightPE-1",
                                     "LightPE-2"])
def test_poly_backend_on_the_card_equals_the_cpu(cuda, poly_models, pe_type):
  gpu, cpu = _poly_pair(poly_models, cuda)
  space = DesignSpace(pe_types=(pe_type,))
  layers = get_network("resnet20")
  cfgs = space.sample(300, seed=41)
  table = space.sample_table(3000, seed=42)
  for got, want in ((gpu.evaluate(cfgs, layers), cpu.evaluate(cfgs, layers)),
                    (gpu.evaluate_table(table, layers),
                     cpu.evaluate_table(table, layers))):
    for c in METRICS:
      np.testing.assert_array_equal(got.column(c), want.column(c), err_msg=c)
    assert np.array_equal(np.flatnonzero(got.pareto()),
                          np.flatnonzero(want.pareto()))


def test_poly_table_across_the_chunk_edge(cuda, poly_models):
  """One PE type's rows over more than one 32,768-design chunk: the card
  equals the CPU, and the rows past the edge equal the same rows
  evaluated alone."""
  gpu, cpu = _poly_pair(poly_models, cuda)
  layers = get_network("resnet20")
  table = DesignSpace(pe_types=("INT16",)).sample_table(33200, seed=43)
  got = gpu.evaluate_table(table, layers)
  want = cpu.evaluate_table(table, layers)
  tail = gpu.evaluate_table(table.select(slice(32768, None)), layers)
  for c in METRICS:
    np.testing.assert_array_equal(got.column(c), want.column(c), err_msg=c)
    np.testing.assert_array_equal(got.column(c)[32768:], tail.column(c))
  assert got.reference_index() == want.reference_index()


def test_poly_raw_sums_on_the_card_equal_the_cpu(cuda, poly_models):
  m = poly_models["INT16"].latency
  x = np.random.RandomState(44).uniform(1.0, 512.0, (4099, 14))
  got = m.raw_on(torch.from_numpy(x).to(cuda)).cpu()
  want = m.raw_on(torch.from_numpy(x))
  assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# guided search and the fault tolerance on the card: the search is host
# numpy over the card's bit-equal oracle, so card and CPU runs are
# identical; journals move between them; the watchdog's helper thread
# resolves a CUDA handle on its own device and stream
# ---------------------------------------------------------------------------

def _search_arch_accs(n=8):
  """``benchmarks/search_perf.py``'s smoke-scale architectures."""
  rng = np.random.RandomState(0)
  archs = [ArchChoice(tuple((int(rng.choice(reps)), int(rng.choice(chs)))
                            for reps, chs in SEARCH_SPACE))
           for _ in range(n)]
  return list(zip(archs, rng.uniform(0.5, 0.95, size=n)))


@pytest.mark.parametrize("mode", ["joint", "surrogate", "hw-only"])
def test_optimize_on_the_card_equals_the_cpu(cuda, mode):
  res = {}
  for dev in (cuda, "cpu"):
    session = ExplorationSession(TorchOracleBackend(device=dev),
                                 DesignSpace())
    if mode == "hw-only":
      res[str(dev)] = session.optimize(get_network("resnet20"), "resnet20",
                                       population=16, generations=6, seed=17)
    else:
      res[str(dev)] = session.optimize(
          arch_accs=_search_arch_accs(), population=16, generations=6,
          seed=7, surrogate=mode == "surrogate")
  g, c = res["cuda"], res["cpu"]
  cols = METRICS + (() if mode == "hw-only" else ("arch_id", "top1"))
  assert len(g["pareto"]) == len(c["pareto"])
  for col in cols:
    np.testing.assert_array_equal(g["pareto"].column(col),
                                  c["pareto"].column(col), err_msg=col)
  assert g.meta["hypervolume"] == c.meta["hypervolume"]
  assert g.meta["evaluations"] == c.meta["evaluations"]


def _no_wait(**kw):
  return ResiliencePolicy(retry=RetryPolicy(sleep=lambda s: None), **kw)


@pytest.mark.parametrize("written,resumed", [("cuda", "cpu"),
                                             ("cpu", "cuda")])
def test_a_journal_moves_between_the_card_and_the_cpu(cuda, tmp_path,
                                                      written, resumed):
  archs = (ArchChoice(((1, 40), (2, 96), (1, 160), (3, 320), (2, 512))),
           ArchChoice(((2, 64), (1, 80), (3, 256), (1, 384), (1, 320))),
           ArchChoice(((1, 48), (1, 112), (2, 192), (2, 448), (3, 384))))
  arch_accs = list(zip(archs, (0.61, 0.83, 0.77)))

  def run(dev, **kw):
    return stream_co_explore(
        TorchOracleBackend(device={"cuda": cuda}.get(dev, dev)),
        DesignSpace(), arch_accs,
        n_hw_per_type=45, seed=3, image_size=16, reducers=_joint_reducers(),
        chunk_size=40, **kw)

  want = run(resumed)
  with pytest.raises(ChunkError) as err:
    run(written, resume_from=tmp_path, policy=_no_wait(
        fault_plan=FaultPlan([Fault("kill", 9, "task")])))
  assert err.value.chunk_index == 9
  got = run(resumed, resume_from=tmp_path)
  assert got.meta["n_resumed_chunks"] == 9 - DISPATCH_AHEAD
  for name in ("pareto", "pareto3", "fig12", "top"):
    for col in METRICS + ("arch_id", "top1"):
      np.testing.assert_array_equal(got[name].column(col),
                                    want[name].column(col))
  np.testing.assert_array_equal(got["hist"]["counts"],
                                want["hist"]["counts"])


def test_a_killed_search_on_the_card_resumes_on_the_cpu(cuda, tmp_path):
  kw = dict(arch_accs=_search_arch_accs(), population=16, generations=6,
            seed=7)
  card = ExplorationSession(TorchOracleBackend(device=cuda), DesignSpace())
  cpu = ExplorationSession(TorchOracleBackend(device="cpu"), DesignSpace())
  want = card.optimize(**kw)
  with pytest.raises(ChunkError):
    card.optimize(resume_from=tmp_path, policy=_no_wait(
        fault_plan=FaultPlan([Fault("kill", 3, "task")])), **kw)
  got = cpu.optimize(resume_from=tmp_path, **kw)
  assert got.meta["n_resumed_chunks"] == 3.0
  for col in METRICS + ("arch_id", "top1"):
    np.testing.assert_array_equal(got["pareto"].column(col),
                                  want["pareto"].column(col))


def test_the_watchdog_resolves_a_cuda_handle_on_its_device_and_stream(cuda):
  backend = TorchOracleBackend(device=cuda)
  layers = tuple(get_network("resnet20")[:4])
  table = DesignSpace().sample_table(300, seed=5)
  plan = device_lib.build_plan(
      {"pareto": ParetoAccumulator(),
       "top": TopKAccumulator(5, by="energy_mj")}, joint=False)
  side = torch.cuda.Stream()
  with torch.cuda.stream(side):
    pend = backend.fused_eval_pending(table, layers, "net", plan,
                                      np.arange(len(table)))
  assert pend.device == torch.device("cuda", torch.cuda.current_device())
  assert pend.stream == side
  seen = {}

  class Probe:
    device, stream = pend.device, pend.stream

    def resolve(self):
      seen["device"] = torch.cuda.current_device()
      seen["stream"] = torch.cuda.current_stream()
      return pend.resolve()

  pol = _no_wait(resolve_timeout=30.0)
  chunk = pol._timed_resolve(Probe())
  assert seen["stream"] == side and seen["device"] == pend.device.index
  want = backend.fused_eval_pending(table, layers, "net", plan,
                                    np.arange(len(table))).resolve()
  for name in ("pareto", "top"):
    np.testing.assert_array_equal(chunk.payloads[name][2],
                                  want.payloads[name][2])
  assert pol.watchdogs.n_live() == 0


def test_an_injected_hang_on_the_card_demotes_to_the_card_rung(cuda):
  layers = get_network("resnet20")[:4]

  def run(policy):
    return stream_explore(
        TorchOracleBackend(device=cuda), DesignSpace(), layers, "net",
        n_per_type=40, seed=4, chunk_size=32, policy=policy,
        reducers={"pareto": ParetoAccumulator(),
                  "top": TopKAccumulator(5, by="energy_mj")})

  want = run(_no_wait(resolve_timeout=30.0))
  assert want.meta["n_retries"] == want.meta["n_demotions"] == 0.0
  pol = _no_wait(resolve_timeout=30.0,
                 fault_plan=FaultPlan([Fault("hang", 2, "device"),
                                       Fault("raise", 3, "device",
                                             times=3)]))
  got = run(pol)
  # chunk 3 dispatches while chunk 2 still waits in the window
  assert sorted(pol.demotions) == [(2, "fused-device", "resolve"),
                                   (3, "fused-device", "dispatch")]
  assert got.meta["n_leaked_watchdogs"] == 0.0
  for name in ("pareto", "top"):
    for col in METRICS:
      np.testing.assert_array_equal(got[name].column(col),
                                    want[name].column(col))
  dead = _no_wait(fault_plan=FaultPlan([Fault("raise", 1, "device",
                                              times=99)]))
  with pytest.raises(ChunkError) as err:
    run(dead)
  assert err.value.chunk_index == 1


# ---------------------------------------------------------------------------
# the worker pool, the fleet, the store and the service on the card
# ---------------------------------------------------------------------------

def _slice6_reducers():
  return {"pareto": ParetoAccumulator(),
          "pareto3": ParetoAccumulator(("latency_s", "energy_mj",
                                        "area_mm2")),
          "top": TopKAccumulator(9, by="energy_mj"),
          "stats": StatsAccumulator("power_mw"),
          "hist": HistogramAccumulator("area_mm2", 0.0, 200.0, bins=16)}


def _assert_bit_identical(got, want):
  for name in ("pareto", "pareto3", "top"):
    for col in METRICS:
      np.testing.assert_array_equal(got[name].column(col),
                                    want[name].column(col), err_msg=name)
  assert got["stats"] == want["stats"]
  np.testing.assert_array_equal(got["hist"]["counts"],
                                want["hist"]["counts"])


@pytest.mark.parametrize("workers", [2, 4])
def test_threaded_stream_on_the_card_equals_one_worker(cuda, workers):
  """Each worker thread dispatches on its own current stream; the fold
  stays in chunk-index order, so every reducer is the same bits, and K1
  counts once a chunk."""
  layers = get_network("resnet20")[:4]

  def run(w):
    kernel.reset_launch_counts()
    res = stream_explore(TorchOracleBackend(device=cuda), DesignSpace(),
                         layers, "net", n_per_type=3000, seed=6,
                         chunk_size=1024, reducers=_slice6_reducers(),
                         workers=w)
    torch.cuda.synchronize()
    return res, kernel.LAUNCHES["block_dominance_counts"]

  (one, k1_one), (many, k1_many) = run(1), run(workers)
  _assert_bit_identical(many, one)
  assert k1_one == k1_many == int(one.meta["n_chunks"])


def test_a_pool_of_the_card_pins_and_checks_on_the_cpu(cuda):
  """A pool of the card: chunks pinned to ``cuda:0`` (K1 included), the
  sentinel recomputing every chunk on the CPU with no mismatch, results
  the same bits as the pool-less stream; a co-exploration's factorization
  follows the pin."""
  from repro_torch.explore import DevicePool
  layers = get_network("resnet20")[:4]
  backend = TorchOracleBackend(device=cuda)
  kw = dict(n_per_type=2000, seed=8, chunk_size=1024)
  want = stream_explore(backend, DesignSpace(), layers, "net",
                        reducers=_slice6_reducers(), **kw)
  pool = DevicePool(sdc_check_every=1)
  assert pool.devices() == (torch.device("cuda", 0),)
  kernel.reset_launch_counts()
  got = stream_explore(backend, DesignSpace(), layers, "net",
                       reducers=_slice6_reducers(), pool=pool, **kw)
  torch.cuda.synchronize()
  _assert_bit_identical(got, want)
  assert got.meta["n_corruption_checks"] == got.meta["n_chunks"]
  assert got.meta["n_corruptions_detected"] == 0.0
  assert kernel.LAUNCHES["block_dominance_counts"] == got.meta["n_chunks"]

  rng = np.random.RandomState(3)
  archs = [ArchChoice(tuple((int(rng.choice(r)), int(rng.choice(c)))
                            for r, c in SEARCH_SPACE)) for _ in range(6)]
  arch_accs = list(zip(archs, rng.uniform(0.5, 0.95, len(archs))))

  def co(**extra):
    return stream_co_explore(
        backend, DesignSpace(), arch_accs, n_hw_per_type=30, seed=3,
        image_size=16, chunk_size=64,
        reducers={"pareto": ParetoAccumulator(("top1_err", "energy_mj",
                                               "area_mm2")),
                  "pareto3": ParetoAccumulator(("latency_s", "energy_mj",
                                                "area_mm2")),
                  "top": TopKAccumulator(6, by="energy_mj")}, **extra)

  solo, pooled = co(), co(pool=DevicePool(sdc_check_every=2))
  for name in ("pareto", "pareto3", "top"):
    for col in METRICS + ("arch_id",):
      np.testing.assert_array_equal(pooled[name].column(col),
                                    solo[name].column(col))
  assert pooled.meta["n_corruptions_detected"] == 0.0


def test_a_store_entry_from_the_card_serves_the_cpu(cuda, tmp_path):
  from repro_torch.explore import ResultStore, cached_stream_explore
  layers = get_network("resnet20")[:4]
  kw = dict(n_per_type=1500, seed=2, chunk_size=1024)
  card = cached_stream_explore(TorchOracleBackend(device=cuda),
                               DesignSpace(), layers, "net",
                               reducers=_slice6_reducers(),
                               store=ResultStore(tmp_path), **kw)
  hit = cached_stream_explore(TorchOracleBackend(device="cpu"),
                              DesignSpace(), layers, "net",
                              reducers=_slice6_reducers(),
                              store=ResultStore(tmp_path), **kw)
  cpu = stream_explore(TorchOracleBackend(device="cpu"), DesignSpace(),
                       layers, "net", reducers=_slice6_reducers(), **kw)
  assert hit.meta["store_hit"] == 1.0
  _assert_bit_identical(hit, card)
  for name in ("pareto", "pareto3", "top"):
    for col in METRICS:
      np.testing.assert_array_equal(hit[name].column(col),
                                    cpu[name].column(col))


def test_the_service_on_the_card_equals_solo_runs(cuda):
  """Two sessions (one with a 3-D front: K1 under the service) and a
  sick fused rung behind an open breaker, which sends chunks to the
  card's own ``device`` rung (H16), all equal their solo streams."""
  from repro_torch.explore import CircuitBreaker, ExplorationService
  layers = get_network("resnet20")[:4]
  kw = dict(n_per_type=2000, chunk_size=1024)

  def solo(seed):
    return stream_explore(TorchOracleBackend(device=cuda), DesignSpace(),
                          layers, "net", seed=seed,
                          reducers=_slice6_reducers(), **kw)

  svc = ExplorationService(TorchOracleBackend(device=cuda), slots=2)
  handles = {s: svc.submit_explore(DesignSpace(), layers, "net", seed=s,
                                   reducers=_slice6_reducers(), **kw)
             for s in (1, 2)}
  kernel.reset_launch_counts()
  svc.drain()
  torch.cuda.synchronize()
  assert kernel.LAUNCHES["block_dominance_counts"] == sum(
      h.result().meta["n_chunks"] for h in handles.values())
  for s, h in handles.items():
    _assert_bit_identical(h.result(), solo(s))

  inner = TorchOracleBackend(device=cuda)

  class SickFused:
    name = "sick-fused"
    device = inner.device

    def evaluate_table(self, *a, **k):
      return inner.evaluate_table(*a, **k)

    def fused_eval_pending(self, *a, **k):
      raise RuntimeError("device runtime wedged")

    def eval_pending(self, *a, **k):
      return inner.eval_pending(*a, **k)

  br = CircuitBreaker(threshold=2, cooldown=1000, jitter=0)
  svc = ExplorationService(SickFused(), slots=1,
                           retry=RetryPolicy(sleep=lambda s: None),
                           breaker=br)
  h = svc.submit_explore(DesignSpace(), layers, "net", seed=1,
                         reducers=_slice6_reducers(), **kw)
  svc.drain()
  res = h.result()
  assert res.meta["breaker_state"] == "open"
  assert res.meta["n_breaker_short_circuits"] > 0
  want = solo(1)
  for name in ("pareto", "pareto3", "top"):
    for col in METRICS:
      np.testing.assert_array_equal(res[name].column(col),
                                    want[name].column(col))


# ---------------------------------------------------------------------------
# the QAT CNNs and the supernet, card vs CPU (bounds as in
# tests/test_torch_cnn.py, H19-H20)
# ---------------------------------------------------------------------------

CNN_PE_TYPES = ("FP32", "INT16", "LightPE-1", "LightPE-2")
CNN_BOUNDS = {"FP32": (1e-4, 1e-5), "INT16": (1e-3, 1e-4),
              "LightPE-1": (2e-2, 2e-3), "LightPE-2": (2e-2, 2e-3)}
CNN_FP32_GRADS = 1e-4
CNN_LAYER = 1e-5
CNN_MASKED = ArchChoice(((1, 40), (2, 96), (1, 224), (3, 320), (2, 448)))


def _rel(got, want) -> float:
  got, want = got.detach().double().cpu(), want.detach().double().cpu()
  assert got.shape == want.shape
  return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _cnn_pair(kind, cuda):
  """The same random-init network on the CPU and on the card, a batch,
  and a forward taking (net, images, pe_type)."""
  from repro_torch.core import cnn
  from repro_torch.data import CifarLike, CifarLikeConfig
  if kind == "vgg":
    cpu = cnn.init_vgg_supernet(0, device="cpu")
    gpu = cnn.init_vgg_supernet(0, device=cuda)
    size, n = 8, 8
    fwd = lambda net, x, pe: net(x, CNN_MASKED, pe)
  else:
    cpu = cnn.init_resnet(0, 20, width=8, device="cpu")
    gpu = cnn.init_resnet(0, 20, width=8, device=cuda)
    size, n = 16, 16
    fwd = lambda net, x, pe: net(x, pe)
  x, y = CifarLike(CifarLikeConfig(image_size=size)).sample(n, 3)
  return cpu, gpu, torch.from_numpy(x), torch.from_numpy(y), fwd


@pytest.mark.parametrize("pe_type", CNN_PE_TYPES)
@pytest.mark.parametrize("kind", ["resnet20", "vgg"])
def test_cnn_logits_card_vs_cpu(cuda, kind, pe_type):
  """Logits and loss within the CPU tests' bounds; a quantized type's
  bound is at least twice the CPU's own largest move under three one-ulp
  jitters of the weights."""
  from repro_torch.core import cnn
  cpu, gpu, x, y, fwd = _cnn_pair(kind, cuda)
  assert all(torch.equal(a, b.cpu()) for a, b in
             zip(cpu.state_dict().values(), gpu.state_dict().values()))
  with torch.no_grad():
    want = fwd(cpu, x, pe_type)
    got = fwd(gpu, x.to(cuda), pe_type)
    b_logits, b_loss = CNN_BOUNDS[pe_type]
    loss = cnn.xent(want, y)
    if pe_type != "FP32":
      for seed in range(3):
        gen = torch.Generator().manual_seed(seed)
        moved = _cnn_pair(kind, cuda)[0]
        for p in moved.parameters():
          up = torch.rand(p.shape, generator=gen) < 0.5
          p.copy_(torch.nextafter(p, torch.where(up, torch.inf, -torch.inf)))
        m = fwd(moved, x, pe_type)
        b_logits = max(b_logits, 2 * _rel(m, want))
        b_loss = max(b_loss, 2 * _rel(cnn.xent(m, y), loss))
  assert _rel(got, want) <= b_logits
  assert _rel(cnn.xent(got, y.to(cuda)), loss) <= b_loss


def _tf32_allowed():
  """cuDNN's and cuBLAS's flags as a caller may leave them: TF32 on."""
  import contextlib
  stack = contextlib.ExitStack()
  stack.enter_context(torch.backends.cudnn.flags(
      enabled=True, benchmark=False, deterministic=False, allow_tf32=True))
  prev = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = True
  stack.callback(setattr, torch.backends.cuda.matmul, "allow_tf32", prev)
  return stack


def _fp32_grads(net, x, y, fwd, tf32=False):
  """Every leaf's FP32 gradient through ``cnn.value_and_grad``, or, for
  the control, the same forward with the backward run outside its guard
  under TF32 (cuDNN reads its flags when the backward runs)."""
  from repro_torch.core import cnn
  loss_fn = lambda: cnn.xent(fwd(net, x, "FP32"), y)
  if not tf32:
    return cnn.value_and_grad(net, loss_fn)[1]
  for p in net.parameters():
    p.grad = None
  with cnn.exact_f32():
    loss = loss_fn()
  with _tf32_allowed():
    loss.backward()
  return {n: p.grad for n, p in net.named_parameters()}


def _worst_leaf(got, want):
  worst = 0.0
  for name, w in want.items():
    if w is None or not w.abs().max() > 0:
      assert got[name] is None or not got[name].abs().max() > 0, name
      continue
    worst = max(worst, _rel(got[name], w))
  return worst


@pytest.mark.parametrize("kind", ["resnet20", "vgg"])
def test_cnn_fp32_grads_card_vs_cpu(cuda, kind):
  cpu, gpu, x, y, fwd = _cnn_pair(kind, cuda)
  want = _fp32_grads(cpu, x, y, fwd)
  got = _fp32_grads(gpu, x.to(cuda), y.to(cuda), fwd)
  assert _worst_leaf(got, want) <= CNN_FP32_GRADS


@pytest.mark.parametrize("kind", ["resnet20", "vgg"])
def test_cnn_fp32_grads_bound_sees_a_tf32_backward(cuda, kind):
  """The control of the test above (H19): the same backward with TF32
  allowed must break its bound."""
  cpu, gpu, x, y, fwd = _cnn_pair(kind, cuda)
  want = _fp32_grads(cpu, x, y, fwd)
  got = _fp32_grads(gpu, x.to(cuda), y.to(cuda), fwd, tf32=True)
  assert _worst_leaf(got, want) > CNN_FP32_GRADS


def _conv_layer(pe_type, dev):
  """One quantized 3x3 stride-2 conv forward and backward from fixed
  inputs, under ``exact_f32`` as ``cnn.value_and_grad`` runs them: its
  output and the gradients of its input and weight."""
  from repro_torch.core import cnn
  rng = np.random.RandomState(2)
  x = torch.from_numpy(np.maximum(rng.normal(size=(4, 16, 8, 8)), 0)
                       .astype(np.float32)).to(dev).requires_grad_()
  w = torch.from_numpy(rng.normal(0, 0.1, (16, 16, 3, 3)).astype(
      np.float32)).to(dev).requires_grad_()
  dy = torch.from_numpy(rng.normal(size=(4, 16, 4, 4)).astype(np.float32))
  with cnn.exact_f32():
    y = cnn.conv2d(cnn._maybe_fq_act(x, pe_type), cnn._maybe_fq(w, pe_type),
                   stride=2)
    y.backward(dy.to(dev))
  return y, x.grad, w.grad


@pytest.mark.parametrize("pe_type", CNN_PE_TYPES)
def test_quantized_conv_grads_card_vs_cpu(cuda, pe_type):
  for want, got in zip(_conv_layer(pe_type, "cpu"),
                       _conv_layer(pe_type, cuda)):
    assert _rel(got, want) <= CNN_LAYER


def test_sgd_update_card_vs_cpu_bit_equal(cuda):
  from repro_torch.train import optimizer as opt
  rng = np.random.RandomState(0)
  cfg = opt.SGDConfig(lr=0.05, steps_per_epoch=40, drops=(2, 3))
  shapes = {"w": (16, 8, 3, 3), "s": (16,), "head": (64, 10)}
  arrays = [{k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
             for k, s in shapes.items()} for _ in range(3)]
  result = []
  for dev in ("cpu", cuda):
    p, g, m = ({k: v.to(dev).clone() for k, v in a.items()} for a in arrays)
    state = {"step": 99, "mom": m}
    opt.sgd_update(cfg, p, g, state)
    result.append((p, state["mom"]))
  for want, got in zip(*result):
    for k in shapes:
      assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.parametrize("pe_type", ["FP32", "LightPE-2"])
def test_qat_training_reruns_identical_on_card(cuda, pe_type):
  """H19: deterministic cuDNN, TF32 off: two runs give the same bits."""
  from repro_torch.core import cnn
  from repro_torch.data import CifarLike, CifarLikeConfig
  from repro_torch.train import optimizer as opt
  data = CifarLike(CifarLikeConfig(image_size=16))
  runs = []
  for _ in range(2):
    net = cnn.init_resnet(0, 20, width=8, device=cuda)
    params = dict(net.named_parameters())
    cfg = opt.SGDConfig(lr=0.05, steps_per_epoch=40, drops=(2, 3))
    state = opt.sgd_init(params)
    losses = []
    for step in range(5):
      x, y = (torch.from_numpy(a).to(cuda)
              for a in data.sample(64, split_seed=step))
      loss, grads = cnn.value_and_grad(
          net, lambda: cnn.xent(net(x, pe_type), y))
      opt.sgd_update(cfg, params, grads, state)
      losses.append(float(loss))
    runs.append((losses, {k: v.detach().cpu() for k, v in params.items()}))
  assert runs[0][0] == runs[1][0]
  for k, v in runs[0][1].items():
    assert torch.equal(v, runs[1][1][k]), k


def test_supernet_card_vs_cpu(cuda):
  """The first step's loss (the same weights) within the FP32 loss bound;
  the later steps within 1e-3: on the CPU, moving every conv output by
  5e-7 of itself at random (the convs' measured rounding error against
  float64 on either device) moves this 3-step trajectory's losses by up
  to 1.6e-4."""
  from repro_torch.core.supernet import Supernet, SupernetConfig
  cfg = SupernetConfig(steps=3, batch=8, image_size=8)
  cpu, gpu = Supernet(cfg, device="cpu"), Supernet(cfg, device=cuda)
  assert gpu.params.head.device.type == cuda.type
  want, got = cpu.train(log_every=0), gpu.train(log_every=0)
  errs = [abs(g - w) / abs(w) for g, w in zip(got, want)]
  assert errs[0] <= 1e-5 and max(errs) <= 1e-3, (got, want)
  a, b = (s.sample_and_evaluate(n_archs=4, n_val=64) for s in (cpu, gpu))
  assert [x.stages for x, _ in a] == [x.stages for x, _ in b]
  assert max(abs(p - q) for (_, p), (_, q) in zip(a, b)) <= 2 / 64, (a, b)
