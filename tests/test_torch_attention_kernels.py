"""The port's attention kernels (K6 prefill flash attention, K5 int8-KV
decode attention) against the JAX package's Pallas kernels (interpret
mode) and plain jnp references, and the port's model attention against
the reference's.

On the CPU the port's wrappers run their plain torch versions; the CUDA
kernels themselves run only on a card (``tests/test_torch_gpu.py``).
Inputs are made with numpy from a seed and handed to both packages.
Tolerances: 2e-5 of the largest |output| for the kernels (as
``tests/test_kernels.py`` holds the Pallas kernels to their references:
float32 sums taken in another order), 2e-4 for the model paths (the
reference's own bound between its kernel and its model attention).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels.flash_attention import ops as ref_fa
from repro.kernels.quant_decode_attn import ops as ref_qda
from repro.models import attention as ref_attention

from repro_torch import _build
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.quant_decode_attn import kernel as qda_kernel
from repro_torch.kernels.quant_decode_attn import ops as qda
from repro_torch.kernels.quant_decode_attn import ref as qda_ref
from repro_torch.models import attention
from test_torch_gpu import DECODE_CASES as CARD_DECODE_CASES
from test_torch_gpu import FLASH_BWD_CASES as CARD_FLASH_BWD_CASES
from test_torch_gpu import FLASH_CASES as CARD_FLASH_CASES
from test_torch_gpu import _bwd_bound


def rel_err(got, want) -> float:
  got, want = np.asarray(got), np.asarray(want)
  return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def normal(rng, shape):
  return rng.standard_normal(shape).astype(np.float32)


# (b, s, h, hkv, d, causal, window): G = 1, 2 and 4, causal, windowed,
# non-causal and ragged S (not a multiple of the 32-row Pallas tiles)
FLASH_CASES = [
    (1, 96, 4, 2, 32, True, 0),
    (1, 96, 4, 4, 32, True, 0),
    (1, 96, 4, 2, 32, True, 40),
    (1, 80, 4, 2, 32, True, 0),
    (1, 96, 4, 2, 32, False, 0),
    (2, 70, 4, 1, 16, True, 24),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_plain_matches_reference_and_pallas(case):
  b, s, h, hkv, d, causal, window = case
  rng = np.random.RandomState(s + h + window)
  q = normal(rng, (b, s, h, d))
  k = normal(rng, (b, s, hkv, d))
  v = normal(rng, (b, s, hkv, d))
  got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal, window=window)
  assert got.dtype == torch.float32 and got.shape == (b, s, h, d)
  want = ref_fa.flash_attention_reference(q, k, v, causal=causal,
                                          window=window)
  pallas = ref_fa.flash_attention(q, k, v, causal=causal, window=window,
                                  interpret=True, bq=32, bk=32)
  assert rel_err(got.numpy(), want) < 2e-5
  assert rel_err(got.numpy(), pallas) < 2e-5


@pytest.mark.parametrize("window", [0, 40])
def test_model_flash_attention_matches_reference_model_path(window):
  """The port's model attention (K6's plain version on the CPU) == the
  reference's pure-JAX chunked model attention, in float32."""
  rng = np.random.RandomState(7)
  b, s, h, hkv, d = 1, 96, 4, 2, 32
  q = normal(rng, (b, s, h, d))
  k = normal(rng, (b, s, hkv, d))
  v = normal(rng, (b, s, hkv, d))
  got = attention.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), window=window)
  want = ref_attention.flash_attention(q, k, v, window=window, chunk_q=32,
                                       chunk_k=32)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                             atol=2e-4)


def quantized_cache(rng, b, hkv, s, d):
  k = normal(rng, (b, hkv, s, d))
  v = normal(rng, (b, hkv, s, d))
  codes = ref_qda.quantize_kv(jnp.asarray(k), jnp.asarray(v))
  return k, v, [np.array(c) for c in codes]


# (b, h, hkv, s, d, lengths): G = 1, 2 and 4; lengths 1, mid and S; a
# sequence that is not a multiple of the 32-position Pallas block
DECODE_CASES = [
    (1, 4, 2, 96, 32, (1,)),
    (1, 4, 2, 96, 32, (50,)),
    (1, 4, 2, 96, 32, (96,)),
    (1, 4, 4, 96, 32, (37,)),
    (2, 8, 2, 70, 16, (70, 9)),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_decode_plain_matches_reference_and_pallas(case):
  b, h, hkv, s, d, lengths = case
  rng = np.random.RandomState(b * s + h)
  q = normal(rng, (b, h, d))
  _, _, (kc, ks, vc, vs) = quantized_cache(rng, b, hkv, s, d)
  lens = np.asarray(lengths, np.int32)
  got = qda.quant_decode_attn(*(torch.from_numpy(a) for a in
                                (q, kc, ks, vc, vs, lens)))
  assert got.dtype == torch.float32 and got.shape == (b, h, d)
  want = ref_qda.quant_decode_attn_reference(q, kc, ks, vc, vs, lens)
  pallas = ref_qda.quant_decode_attn(q, kc, ks, vc, vs, lens,
                                     interpret=True, bs=32)
  assert rel_err(got.numpy(), want) < 2e-5
  assert rel_err(got.numpy(), pallas) < 2e-5


def test_decode_plain_gives_zero_not_nan_for_an_empty_cache():
  rng = np.random.RandomState(3)
  q = torch.from_numpy(normal(rng, (1, 4, 16)))
  _, _, codes = quantized_cache(rng, 1, 2, 40, 16)
  out = qda.quant_decode_attn(q, *(torch.from_numpy(c) for c in codes),
                              torch.zeros(1, dtype=torch.int32))
  assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("quant", [True, False])
def test_model_decode_attention_matches_reference(ring, quant):
  rng = np.random.RandomState(11)
  b, h, hkv, s, d = 2, 4, 2, 48, 16
  q = normal(rng, (b, h, d))
  k, v, (kc, ks, vc, vs) = quantized_cache(rng, b, hkv, s, d)
  lens = np.asarray([60, 17] if ring else [48, 17], np.int32)
  if quant:
    args = (q, kc, vc, lens, ks, vs)
  else:
    args = (q, k, v, lens, None, None)
  want = ref_attention.decode_attention(*args, ring=ring)
  got = attention.decode_attention(
      *(None if a is None else torch.from_numpy(a) for a in args), ring=ring)
  assert rel_err(got.numpy(), want) < 2e-5


def test_quantize_kv_codes_and_scales_equal_bit_for_bit():
  rng = np.random.RandomState(5)
  k = normal(rng, (2, 2, 33, 32)) * 3.0
  v = normal(rng, (2, 2, 33, 32))
  k[0, 0, 0] = 0.0                                    # an all-zero row
  ties = np.arange(32, dtype=np.float32) - 15.5       # x / scale on .5 ties
  ties[0] = 127.0                                     # scale == 1 exactly
  v[1, 1, 3] = ties
  k[1, 0, 5] = -ties
  got = qda.quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
  want = ref_qda.quantize_kv(jnp.asarray(k), jnp.asarray(v))
  for g, w in zip(got, want):
    w = np.asarray(w)
    assert g.numpy().dtype == w.dtype
    np.testing.assert_array_equal(g.numpy(), w)
  assert np.all(got[2].numpy()[1, 1, 3, 1:] == np.round(ties[1:]))


def test_kernel_wrappers_refuse_cpu_tensors():
  """The CUDA wrappers never run anything for a CPU tensor (the public
  ops take the plain version there); they raise before building."""
  q = torch.zeros((1, 64, 4, 32))
  kv = torch.zeros((1, 64, 2, 32))
  with pytest.raises(ValueError, match="CUDA tensor"):
    fa_kernel.flash_attention(q, kv, kv, 0.1)
  codes = torch.zeros((1, 2, 64, 32), dtype=torch.int8)
  scales = torch.zeros((1, 2, 64))
  with pytest.raises(ValueError, match="CUDA tensor"):
    qda_kernel.quant_decode_attn(q[:, 0], codes, scales, codes, scales,
                                 torch.ones(1, dtype=torch.int32), 0.1)
  assert fa_kernel.LAUNCHES["flash_attention"] == 0
  assert qda_kernel.LAUNCHES["quant_decode_attn"] == 0


# ---------------------------------------------------------------------------
# The numeric premises of the CUDA kernels' designs, rebuilt in plain torch
# (the kernels themselves run only on a card).  The tile, walker and split
# sizes are read from the kernels' sources, so the premises follow them.
# ---------------------------------------------------------------------------

def csrc_constant(kernel_module, name: str) -> int:
  """``constexpr int <name> = <n>;`` of the kernel's CUDA source."""
  return _build.csrc_constant(Path(kernel_module.__file__).parent.name, name)


@pytest.mark.parametrize("case", FLASH_CASES + CARD_FLASH_CASES, ids=str)
def test_flash_bf16_kernel_order_stays_within_tolerance(case):
  """K6's bf16 order (f32 scores of bf16 q and k scaled after, the
  kernel's walkers of key tiles, P as bf16 hi + lo, f32 sums) is within
  the card tests' 1e-4 of max |out| of the f32 plain version on the same
  bf16 inputs, for the shapes of both files."""
  b, s, h, hkv, d, causal, window = case
  rng = np.random.RandomState(s + h + d)
  q = torch.from_numpy(normal(rng, (b, s, h, d))).bfloat16()
  k = torch.from_numpy(normal(rng, (b, s, hkv, d))).bfloat16()
  v = torch.from_numpy(normal(rng, (b, s, hkv, d))).bfloat16()
  want = fa.flash_attention_reference(q, k, v, causal=causal, window=window)
  g = h // hkv

  def flat(x):  # (B, S, heads, D) -> (B * H, S, D), kv repeated per group
    x = torch.repeat_interleave(x, h // x.shape[2], dim=2)
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)
  got = fa_ref.flash_attention_bf16_order(
      flat(q), flat(k), flat(v), 1.0 / d ** 0.5, causal=causal,
      window=window, block_k=csrc_constant(fa_kernel, "kBK"),
      walkers=csrc_constant(fa_kernel, "kWalkers")
  ).reshape(b, h, s, d).permute(0, 2, 1, 3)
  assert g >= 1 and got.shape == want.shape
  assert rel_err(got.numpy(), want.numpy()) < 1e-4


def _chip_smoke_k6_bwd_cases():
  """``chip_smoke.py``'s bf16 ``[K6-bwd]`` shapes, as (b, s, h, hkv, d,
  causal, window)."""
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
  smoke = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(smoke)
  return [(b, s, h, hkv, d, True, window)
          for b, s, h, hkv, d, dt, window in smoke.K6_BWD_CASES
          if dt == "bfloat16"]


def _dout(rng, shape, kind):
  """The output gradient: f32 normal; bf16-exact, as on the training path
  (the model casts K6's output to bf16); or rows scaled over 1e-3..1e3."""
  x = torch.from_numpy(normal(rng, shape))
  if kind == "bf16":
    return x.bfloat16().float()
  if kind == "wide":
    rows = torch.from_numpy(10.0 ** rng.uniform(-3, 3, shape[:-1] + (1,)))
    return x * rows.float()
  return x


@pytest.mark.parametrize("kind", ["f32", "bf16", "wide"])
@pytest.mark.parametrize("case", sorted(set(
    CARD_FLASH_BWD_CASES + _chip_smoke_k6_bwd_cases())), ids=str)
def test_flash_bwd_bf16_kernel_order_stays_within_tolerance(case, kind):
  """K6's bf16 backward arithmetic (dO, P and dS as bf16 hi + lo, lo lo of
  P^T dO dropped, f32 sums in the kernels' steps, one bf16 rounding) is
  within the card tests' bound of the plain backward on the same bf16
  inputs, for the shapes of the card tests and ``chip_smoke.py``."""
  b, s, h, hkv, d, causal, window = case
  rng = np.random.RandomState(s + h + d + window)
  q = torch.from_numpy(normal(rng, (b, s, h, d))).bfloat16()
  k = torch.from_numpy(normal(rng, (b, s, hkv, d))).bfloat16()
  v = torch.from_numpy(normal(rng, (b, s, hkv, d))).bfloat16()
  dout = _dout(rng, (b, s, h, d), kind)
  out = fa.flash_attention_reference(q, k, v, causal=causal, window=window)
  lse = fa.flash_attention_lse_reference(q, k, causal=causal, window=window)
  want = fa.flash_attention_bwd_reference(q, k, v, out, dout, lse, causal,
                                          window)
  got = fa_ref.flash_attention_bwd_bf16_order(
      q, k, v, out, dout, lse, 1.0 / d ** 0.5, causal, window,
      step=csrc_constant(fa_kernel, "kBwdStep"))
  for name, x, y in zip(("dq", "dk", "dv"), got, want):
    assert x.dtype == torch.bfloat16 and x.shape == y.shape, name
    assert rel_err(x.float().numpy(), y.numpy()) < _bwd_bound(
        torch.bfloat16, s, h // hkv), name


@pytest.mark.parametrize("case", DECODE_CASES + CARD_DECODE_CASES + [
    (1, 4, 2, 300, 32, (0,)), (1, 4, 2, 8192, 32, (5000,))], ids=str)
def test_decode_split_and_merge_keeps_the_function(case):
  """K5's split over the sequence (the kernel's chunks dealt round-robin
  to its blocks, each with its online softmax; blocks with no chunk
  below the fill; the merge's rescaling) is within 1e-6 of max |out| of
  the plain version; length 0 gives exactly 0."""
  b, h, hkv, s, d, lengths = case
  g = h // hkv
  rng = np.random.RandomState(b * s + h + 1)
  q = torch.from_numpy(normal(rng, (b * hkv, g, d)))
  kc = torch.from_numpy(rng.randint(-128, 128, (b * hkv, s, d)).astype(
      np.int8))
  vc = torch.from_numpy(rng.randint(-128, 128, (b * hkv, s, d)).astype(
      np.int8))
  ks = torch.from_numpy(rng.uniform(1e-3, 3e-2, (b * hkv, s)).astype(
      np.float32))
  vs = torch.from_numpy(rng.uniform(1e-3, 3e-2, (b * hkv, s)).astype(
      np.float32))
  lens = torch.repeat_interleave(torch.tensor(lengths, dtype=torch.int32),
                                 hkv)
  want = qda_ref.quant_decode_attn_ref(q, kc, ks, vc, vs, lens,
                                       1.0 / d ** 0.5)
  got = qda_ref.quant_decode_attn_split(
      q, kc, ks, vc, vs, lens, 1.0 / d ** 0.5,
      csrc_constant(qda_kernel, "kSplit"),
      csrc_constant(qda_kernel, "kMaxSplits"))
  assert torch.isfinite(got).all()
  if not any(lengths):
    assert torch.equal(got, torch.zeros_like(got))
  else:
    assert rel_err(got.numpy(), want.numpy()) < 1e-6
