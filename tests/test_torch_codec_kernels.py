"""The port's codec matmuls (K3 ``int8_matmul``, K4 ``pow2_matmul``)
against the JAX package's Pallas kernels in interpret mode, and
``convert.packed_from_jax``.

On the CPU the port's wrappers run their plain torch versions; the CUDA
kernels themselves run only on a card (``tests/test_torch_gpu.py``).
Inputs are made with numpy from a seed and handed to both packages.
Tolerances: K3 is exact (atol 0: an int32 sum and two float32 multiplies
in one order); K4 within 1e-5 of the largest |output| at float32 and bf16
x alike (the plain version folds the scale into the weights, the Pallas
kernel multiplies after the K sum; bf16 x converts exactly to float32
before the dot).  The shapes are those of ``tests/test_kernels.py``, plus
M = 1.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels.int8_matmul import ops as ref_i8
from repro.kernels.int8_matmul.ref import int8_matmul_ref as ref_i8_plain
from repro.kernels.pow2_matmul import ops as ref_p2
from repro.kernels.pow2_matmul import ref as ref_p2_plain
from repro.quant import policy as ref_policy

from repro_torch import _build, convert
from repro_torch.core.quant import pow2_decode_codes
from repro_torch.kernels.int8_matmul import kernel as i8_kernel
from repro_torch.kernels.int8_matmul import ops as i8
from repro_torch.kernels.int8_matmul import ref as i8_ref
from repro_torch.kernels.pow2_matmul import kernel as p2_kernel
from repro_torch.kernels.pow2_matmul import ops as p2
from repro_torch.kernels.pow2_matmul import ref as p2_ref
from repro_torch.quant import QuantPolicy, pack_params
from test_torch_gpu import CODEC_CASES as CARD_CODEC_CASES

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def t(a) -> torch.Tensor:
  return torch.from_numpy(np.array(a, copy=True))


def same_input(x: np.ndarray, dtype: str):
  """x in ``dtype`` for both packages, with the same values."""
  jdt, tdt = DTYPES[dtype]
  xj = jnp.asarray(x, jdt)
  return xj, t(np.asarray(xj.astype(jnp.float32))).to(tdt)


def rel_err(got, want) -> float:
  got, want = np.asarray(got), np.asarray(want)
  return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

I8_SHAPES = [(5, 64, 70), (128, 128, 128), (200, 384, 250), (1, 64, 70),
             (1, 1024, 96)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", I8_SHAPES, ids=str)
def test_int8_matmul_equals_pallas(shape, dtype):
  m, k, n = shape
  rng = np.random.RandomState(m + n)
  x = rng.standard_normal((m, k)).astype(np.float32)
  w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
  if m > 1:
    x[m // 2] = 0.0           # an all-zero row: the 1e-12 clamp
  xj, xt = same_input(x, dtype)
  want = ref_i8.int8_matmul(xj, ref_i8.quantize_weights(jnp.asarray(w)),
                            interpret=True)
  weights = i8.quantize_weights(t(w))
  got = i8.int8_matmul(xt, weights)
  assert got.dtype == torch.float32 and got.shape == (m, n)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  np.testing.assert_array_equal(
      i8.int8_matmul_reference(xt, weights).numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_activations_equals_the_jitted_reference(dtype):
  """H4: a bf16 x stays bf16 between the steps, its scales too.  H11:
  both divisions are true divisions, as the reference's jitted K3 path
  computes them with XLA's algebraic simplifier off (``tests/conftest.py``
  sets it so; with it on, XLA folds ``absmax / 127.0`` into a multiply by
  float32 1/127)."""
  rng = np.random.RandomState(64)
  x = (rng.standard_normal((64, 1024)) * 10.0 ** rng.uniform(
      -6, 3, (64, 1))).astype(np.float32)
  x[3] = 0.0
  x[5] *= 1e-14
  xj, xt = same_input(x, dtype)
  want_c, want_s = jax.jit(ref_i8.quantize_activations)(xj)
  got_c, got_s = i8.quantize_activations(xt)
  assert got_s.dtype == xt.dtype
  np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
  np.testing.assert_array_equal(got_s.float().numpy(),
                                np.asarray(want_s.astype(jnp.float32)))


@pytest.mark.parametrize("shape", [(5, 64, 70), (128, 128, 128)], ids=str)
def test_int8_weights_equal_the_reference(shape):
  _, k, n = shape
  w = (np.random.RandomState(k).standard_normal((k, n)) * 0.1).astype(
      np.float32)
  want = ref_i8.quantize_weights(jnp.asarray(w))
  got = i8.quantize_weights(t(w))
  np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
  np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
  assert (got.k, got.n, got.hbm_bytes) == (want.k, want.n, want.hbm_bytes)


@pytest.mark.parametrize("xs_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 64, 70), (1, 3072, 16)], ids=str)
def test_int8_plain_version_is_exact_on_codes(shape, xs_dtype):
  """The float64 product is the exact int32 sum, even at the extreme codes
  (-128 x -128 over K = 3072), and the epilogue is the reference's."""
  m, k, n = shape
  rng = np.random.RandomState(k)
  xq = rng.randint(-128, 128, (m, k)).astype(np.int8)
  wq = rng.randint(-128, 128, (k, n)).astype(np.int8)
  xq[0] = -128
  wq[:, 0] = -128
  xs = rng.uniform(1e-3, 1e-1, m).astype(np.float32)
  ws = rng.uniform(1e-3, 1e-1, n).astype(np.float32)
  jdt, tdt = DTYPES[xs_dtype]
  xsj = jnp.asarray(xs, jdt)
  got = i8_ref.int8_matmul_ref(t(xq), t(wq), t(np.asarray(
      xsj.astype(jnp.float32))).to(tdt), t(ws))
  acc = xq.astype(np.int64) @ wq.astype(np.int64)
  assert acc[0, 0] == 128 * 128 * k
  want = ref_i8_plain(jnp.asarray(xq), jnp.asarray(wq), xsj, jnp.asarray(ws))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_end_to_end_close_to_float():
  rng = np.random.RandomState(3)
  x = rng.standard_normal((32, 256)).astype(np.float32)
  w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
  got = i8.int8_matmul(t(x), i8.quantize_weights(t(w)))
  ref = t(x) @ t(w)
  assert float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref)) < 0.02


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

P2_SHAPES = [(4, 96, 130), (128, 128, 128), (257, 300, 514), (1, 64, 64)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", P2_SHAPES, ids=str)
@pytest.mark.parametrize("k_terms", [1, 2])
def test_pow2_matmul_within_1e5_of_pallas(k_terms, shape, dtype):
  m, k, n = shape
  rng = np.random.RandomState(m * n + k_terms)
  x = rng.standard_normal((m, k)).astype(np.float32)
  w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
  xj, xt = same_input(x, dtype)
  ref_w = ref_p2.quantize_weights(jnp.asarray(w), k_terms=k_terms)
  want = np.asarray(ref_p2.pow2_matmul(xj, ref_w, interpret=True))
  weights = p2.quantize_weights(t(w), k_terms=k_terms)
  np.testing.assert_array_equal(weights.codes.numpy(),
                                np.asarray(ref_w.codes))
  np.testing.assert_array_equal(weights.scale.numpy(),
                                np.asarray(ref_w.scale))
  got = p2.pow2_matmul(xt, weights)
  assert got.dtype == torch.float32 and got.shape == (m, n)
  assert rel_err(got, want) < 1e-5
  plain = p2.pow2_matmul_reference(xt, weights)
  np.testing.assert_array_equal(plain.numpy(), got.numpy())


@pytest.mark.parametrize("k_terms", [1, 2])
def test_decode_weights_bit_equal(k_terms):
  rng = np.random.RandomState(7 + k_terms)
  w = (rng.standard_normal((40, 66)) * 0.05).astype(np.float32)
  ref_w = ref_p2.quantize_weights(jnp.asarray(w), k_terms=k_terms)
  want = ref_p2_plain.decode_weights(ref_w.codes, ref_w.scale, k_terms)
  got = p2_ref.decode_weights(t(np.asarray(ref_w.codes)),
                              t(np.asarray(ref_w.scale)), k_terms)
  assert got.dtype == torch.float32
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pow2_hbm_bytes_and_batched_leading_dims():
  rng = np.random.RandomState(1)
  w = (rng.standard_normal((64, 96)) * 0.1).astype(np.float32)
  for k_terms in (1, 2):
    got = p2.quantize_weights(t(w), k_terms)
    want = ref_p2.quantize_weights(jnp.asarray(w), k_terms)
    assert got.hbm_bytes == want.hbm_bytes
  out = p2.pow2_matmul(t(rng.standard_normal((2, 3, 64)).astype(np.float32)),
                       p2.quantize_weights(t(w), 1))
  assert out.shape == (2, 3, 96)
  out = i8.int8_matmul(t(rng.standard_normal((2, 3, 64)).astype(np.float32)),
                       i8.quantize_weights(t(w)))
  assert out.shape == (2, 3, 96)


# ---------------------------------------------------------------------------
# K4's CUDA design, rebuilt in plain torch (the kernel runs only on a card):
# its tile and split sizes are read from its source
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_terms", [1, 2])
def test_every_pow2_code_is_exact_in_bf16(k_terms):
  """All 16 k=1 and 128 k=2 codes decode to values that a bf16 round trip
  keeps bit for bit (so the tensor-core path's bf16 weights are exact),
  the reference's own decoded values."""
  codes = torch.arange(16 if k_terms == 1 else 128, dtype=torch.uint8)
  vals = pow2_decode_codes(codes, k_terms)
  assert vals.dtype == torch.float32
  assert torch.equal(vals.bfloat16().float().view(torch.int32),
                     vals.view(torch.int32))
  packed = codes.reshape(1, -1)
  if k_terms == 1:
    packed = packed.reshape(1, -1, 2)
    packed = (packed[..., 0] | (packed[..., 1] << 4)).to(torch.uint8)
  want = ref_p2_plain.decode_weights(jnp.asarray(packed.numpy()),
                                     jnp.ones(codes.numel()), k_terms)
  np.testing.assert_array_equal(vals.numpy(), np.asarray(want)[0])


def _kernel_order(x, weights):
  return p2_ref.pow2_matmul_kernel_order(
      x, weights.codes, weights.scale, weights.k_terms,
      decode_max_m=_build.csrc_constant("pow2_matmul", "kDecodeMaxM"),
      dec_tile_k=_build.csrc_constant("pow2_matmul", "kDecTK"),
      dec_lanes=(_build.csrc_constant("pow2_matmul", "kDecThreads")
                 // _build.csrc_constant("pow2_matmul", "kDecBN")),
      max_splits=_build.csrc_constant("pow2_matmul", "kMaxSplits"),
      tc_tile_k=_build.csrc_constant("pow2_matmul", "kTcBK"))


def test_k4_decode_threshold_matches_its_source():
  assert p2_kernel.DECODE_MAX_M == _build.csrc_constant("pow2_matmul",
                                                        "kDecodeMaxM")
  assert [p2_kernel.path(m, dt) for m, dt in (
      (1, torch.bfloat16), (16, torch.float32), (17, torch.bfloat16),
      (512, torch.float32))] == ["decode", "decode", "tensor-core",
                                 "cuda-core"]


def test_k3_decode_threshold_matches_its_source():
  assert i8_kernel.DECODE_MAX_M == _build.csrc_constant("int8_matmul",
                                                        "kDecodeMaxM")
  assert [i8_kernel.path(m) for m in (1, 16, 17, 512)] == [
      "decode", "decode", "tensor-core", "tensor-core"]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", P2_SHAPES + CARD_CODEC_CASES, ids=str)
@pytest.mark.parametrize("k_terms", [1, 2])
def test_pow2_kernel_order_within_1e5_of_pallas(k_terms, shape, dtype):
  """K4's order (the decode path's K split over a cluster and its fixed
  reduction order; bf16 tensor-core tiles; the scale after the K sum) is
  within 1e-5 of max |out| of the Pallas kernel, for the shapes of both
  files."""
  m, k, n = shape
  rng = np.random.RandomState(m + k + n + k_terms)
  x = rng.standard_normal((m, k)).astype(np.float32)
  w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
  xj, xt = same_input(x, dtype)
  want = np.asarray(ref_p2.pow2_matmul(
      xj, ref_p2.quantize_weights(jnp.asarray(w), k_terms=k_terms),
      interpret=True))
  got = _kernel_order(xt, p2.quantize_weights(t(w), k_terms=k_terms))
  assert got.dtype == torch.float32 and got.shape == (m, n)
  assert rel_err(got, want) < 1e-5


# ---------------------------------------------------------------------------
# the kernels' launch wrappers refuse CPU tensors
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_cpu_tensors():
  """A wrapper takes the plain version only in ``ops``; the launch
  wrappers themselves take CUDA tensors or raise."""
  x = torch.zeros((2, 8), dtype=torch.int8)
  w = torch.zeros((8, 4), dtype=torch.int8)
  with pytest.raises(ValueError, match="CUDA"):
    i8_kernel.int8_matmul(x, w, torch.ones(2), torch.ones(4))
  with pytest.raises(ValueError, match="CUDA"):
    p2_kernel.pow2_matmul(torch.zeros((2, 8)),
                          torch.zeros((8, 2), dtype=torch.uint8),
                          torch.ones(4), 1)
  assert i8_kernel.LAUNCHES == {"int8_matmul": 0}
  assert p2_kernel.LAUNCHES == {"pow2_matmul": 0}


# ---------------------------------------------------------------------------
# packed_from_jax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pe_type", ["FP32", "INT16", "INT8", "INT4",
                                     "LightPE-1", "LightPE-2"])
def test_packed_from_jax_carries_a_packed_tree(pe_type):
  rng = np.random.RandomState(2)
  tree = {"blocks": {"sub0": {
      "mix": {"wq": (rng.standard_normal((2, 16, 8)) * 0.1).astype(
          np.float32)},
      "mix_norm": {"scale": np.ones((2, 16), np.float32)}}},
      "embed": rng.standard_normal((32, 16)).astype(np.float32)}
  ref_packed = ref_policy.pack_params(
      tree, ref_policy.QuantPolicy(pe_type=pe_type))
  got = convert.packed_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       ref_packed))
  port = pack_params({"blocks": {"sub0": {
      "mix": {"wq": t(tree["blocks"]["sub0"]["mix"]["wq"])},
      "mix_norm": {"scale": t(tree["blocks"]["sub0"]["mix_norm"]["scale"])}}},
      "embed": t(tree["embed"])}, QuantPolicy(pe_type=pe_type))
  leaf, want = got["blocks"]["sub0"]["mix"]["wq"], port["blocks"]["sub0"][
      "mix"]["wq"]
  if pe_type == "FP32":
    assert torch.equal(leaf, want)
  else:
    assert set(leaf) == {"codes", "scale", "fmt", "shape"}
    assert leaf["fmt"] == want["fmt"] and leaf["shape"] == want["shape"]
    assert leaf["shape"] == (2, 16, 8) and isinstance(leaf["fmt"], str)
    for key in ("codes", "scale"):
      assert leaf[key].dtype == want[key].dtype
      assert torch.equal(leaf[key], want[key])
  assert torch.equal(got["embed"], t(tree["embed"]))
  assert torch.equal(got["blocks"]["sub0"]["mix_norm"]["scale"],
                     torch.ones((2, 16)))
