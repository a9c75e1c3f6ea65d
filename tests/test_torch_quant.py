"""The port's quantization codecs (``repro_torch.core.quant``,
``repro_torch.quant.policy``) against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.
Codes, scales, ``fmt`` and ``shape`` of ``pack_params`` are held byte for
byte, and ``fake_quant_params`` bit for bit, on the reference-shaped trees
of the reduced qwen3-0.6b and rwkv6-1.6b built by the reference's
``build_model(...).init``; the properties of ``tests/test_quant.py`` are
held on the port's own functions.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.core import quant as ref_quant
from repro.models.model import build_model as ref_build_model
from repro.quant import policy as ref_policy

from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import quant
from repro_torch.models import build_model
from repro_torch.quant import (QuantPolicy, deploy_bytes_per_param,
                               fake_quant_params, pack_params)

PE_TYPES = ("FP32", "INT16", "INT8", "INT4", "LightPE-1", "LightPE-2")
ARCHS = ("qwen3-0.6b", "rwkv6-1.6b")


def t(a) -> torch.Tensor:
  return torch.from_numpy(np.array(a, copy=True))


def same_bytes(got: torch.Tensor, want) -> bool:
  want = np.asarray(want)
  got = got.detach().numpy()
  return (got.dtype == want.dtype and got.shape == want.shape
          and got.tobytes() == want.tobytes())


def tree_to_torch(tree):
  if isinstance(tree, dict):
    return {k: tree_to_torch(v) for k, v in tree.items()}
  return t(tree)


def ref_np(tree):
  """A reference tree with its arrays as numpy (``fmt`` and ``shape`` of a
  packed leaf stay a str and a tuple)."""
  if isinstance(tree, dict):
    return {k: ref_np(v) for k, v in tree.items()}
  if isinstance(tree, (str, tuple)):
    return tree
  return np.asarray(tree)


def assert_trees_byte_equal(got, want, path=""):
  if isinstance(want, dict):
    assert isinstance(got, dict) and set(got) == set(want), path
    for k in want:
      assert_trees_byte_equal(got[k], want[k], f"{path}/{k}")
  elif isinstance(want, str):
    assert got == want, path
  elif isinstance(want, tuple):
    assert got == want, path
  else:
    assert same_bytes(got, want), path


_REF_TREES = {}


def ref_tree(arch):
  """The reference's reduced parameter tree as numpy arrays."""
  if arch not in _REF_TREES:
    model = ref_build_model(ref_reduce(ref_get_config(arch)))
    _REF_TREES[arch] = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(0)))
  return _REF_TREES[arch]


# ---------------------------------------------------------------------------
# the policy on whole model trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pe_type", PE_TYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_pack_params_byte_equal(arch, pe_type):
  want = ref_policy.pack_params(ref_tree(arch),
                                ref_policy.QuantPolicy(pe_type=pe_type))
  got = pack_params(tree_to_torch(ref_tree(arch)),
                    QuantPolicy(pe_type=pe_type))
  assert_trees_byte_equal(got, ref_np(want))
  if pe_type != "FP32":
    leaf = got["blocks"]["sub0"]["mix"]["wo"]
    assert leaf["fmt"] == {"INT16": "int16", "INT8": "int8", "INT4": "int4",
                           "LightPE-1": "pow2_1",
                           "LightPE-2": "pow2_2"}[pe_type]
    assert leaf["shape"] == tuple(ref_tree(arch)["blocks"]["sub0"]["mix"]
                                  ["wo"].shape)


@pytest.mark.parametrize("pe_type", PE_TYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_pack_params_through_the_port_model(arch, pe_type):
  """The port's model, turned back into the reference's tree by
  ``convert.params_to_tree``, packs to the reference's bytes (H8: a
  stacked leaf's scale spans every layer)."""
  cfg = reduce_for_smoke(get_config(arch))
  params = build_model(cfg, device="cpu").from_state(
      convert.params_from_jax(cfg, ref_tree(arch)))
  tree = convert.params_to_tree(cfg, params)
  assert_trees_byte_equal(tree, ref_tree(arch))
  want = ref_policy.pack_params(ref_tree(arch),
                                ref_policy.QuantPolicy(pe_type=pe_type))
  got = pack_params(tree, QuantPolicy(pe_type=pe_type))
  assert_trees_byte_equal(got, ref_np(want))


@pytest.mark.parametrize("pe_type", PE_TYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_fake_quant_params_bit_equal(arch, pe_type):
  """H6: the straight-through sum real + (quant - real), not quant."""
  want = ref_policy.fake_quant_params(
      ref_tree(arch), ref_policy.QuantPolicy(pe_type=pe_type))
  got = fake_quant_params(tree_to_torch(ref_tree(arch)),
                          QuantPolicy(pe_type=pe_type))
  assert_trees_byte_equal(got, ref_np(want))


@pytest.mark.parametrize("pe_type", PE_TYPES)
def test_deploy_bytes_per_param(pe_type):
  assert (deploy_bytes_per_param(pe_type)
          == ref_policy.deploy_bytes_per_param(pe_type))


def test_fake_quant_tree_only_matmuls():
  params = {"blocks": {"sub0": {"mix": {"wq": torch.ones((4, 4))},
                                "mix_norm": {"scale": torch.ones(4)}}}}
  out = fake_quant_params(params, QuantPolicy(pe_type="LightPE-1"))
  # norm untouched, wq quantized to pow2 grid
  assert torch.all(out["blocks"]["sub0"]["mix_norm"]["scale"] == 1.0)
  assert torch.all(out["blocks"]["sub0"]["mix"]["wq"] == 1.0)


def assert_scales_equal_but_flushed(got: torch.Tensor, want, bits):
  """H10: XLA on the CPU (and the TPU) flushes subnormal float32 results
  to zero.  An all-zero column's integer scale is tiny / qmax, a
  subnormal: the reference's is 0, the port keeps the IEEE value on the
  CPU and on the card.  Every other scale is held byte for byte."""
  want = np.asarray(want)
  got = got.numpy()
  assert got.shape == want.shape and got.dtype == want.dtype
  flushed = want == 0
  np.testing.assert_array_equal(got[~flushed].view(np.int32),
                                want[~flushed].view(np.int32))
  tiny_over_qmax = np.float32(np.finfo(np.float32).tiny) / np.float32(
      2 ** (bits - 1) - 1)
  assert tiny_over_qmax < np.finfo(np.float32).tiny   # subnormal
  np.testing.assert_array_equal(got[flushed], tiny_over_qmax)


@pytest.mark.parametrize("pe_type", PE_TYPES[1:])
def test_zero_rows_and_columns_pack_like_the_reference(pe_type):
  """All-zero output columns take the float32-tiny absmax (a pow2 scale of
  tiny, an integer scale of tiny / qmax, which the reference flushes to
  0); all-zero input rows take the codebook's nearest point to 0."""
  rng = np.random.RandomState(11)
  w = (rng.standard_normal((3, 16, 24)) * 0.1).astype(np.float32)
  w[:, :, 5] = 0.0
  w[1, 7, :] = 0.0
  w[:, 2, :] = 0.0
  tree = {"blocks": {"sub0": {"ffn": {"wi": w}}}, "embed": w[0]}
  want = ref_np(ref_policy.pack_params(
      tree, ref_policy.QuantPolicy(pe_type=pe_type)))
  got = pack_params(tree_to_torch(tree), QuantPolicy(pe_type=pe_type))
  leaf, want_leaf = got["blocks"]["sub0"]["ffn"]["wi"], want["blocks"][
      "sub0"]["ffn"]["wi"]
  assert leaf["scale"].shape == (1, 24)
  if pe_type.startswith("INT"):
    assert_scales_equal_but_flushed(leaf["scale"], want_leaf["scale"],
                                    int(pe_type[3:]))
    assert int(np.sum(want_leaf["scale"] == 0)) == 1
    leaf, want_leaf = dict(leaf), dict(want_leaf)
    del leaf["scale"], want_leaf["scale"]
    assert_trees_byte_equal(got["embed"], want["embed"])
  else:
    assert float(leaf["scale"][0, 5]) == np.finfo(np.float32).tiny
  assert_trees_byte_equal(leaf, want_leaf)
  codes = leaf["codes"]
  zero_row = codes[2] if pe_type != "INT4" else quant.unpack_int4(codes)[2]
  assert torch.equal(zero_row, torch.full_like(zero_row, {
      "INT16": 0, "INT8": 0, "INT4": 0, "LightPE-1": 0x77,
      "LightPE-2": 0o77}[pe_type]))


@pytest.mark.parametrize("pe_type", PE_TYPES)
def test_ste_gradient_is_identity(pe_type):
  rng = np.random.RandomState(3)
  w = rng.standard_normal((8, 8)).astype(np.float32)
  wt = t(w).requires_grad_(True)
  (quant.fake_quant_for_pe(wt, pe_type) * 2.0).sum().backward()
  want = jax.grad(lambda v: jnp.sum(
      ref_quant.fake_quant_for_pe(v, pe_type) * 2.0))(jnp.asarray(w))
  assert same_bytes(wt.grad, want)
  assert torch.all(wt.grad == 2.0)


# ---------------------------------------------------------------------------
# the quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
def test_codebook_is_the_reference_in_its_order(k):
  vals, codes = quant.pow2_codebook(k)
  ref_vals, ref_codes = ref_quant.pow2_codebook(k)
  assert same_bytes(vals, ref_vals) and same_bytes(codes, ref_codes)
  # every value is a sum of powers of two, 8 (k=1) or 36 (k=2) of them
  assert vals.min() >= 2.0 ** -quant.POW2_M_MAX and vals.max() <= 2.0
  assert len(vals) == (8 if k == 1 else 36)


def _midpoints(k):
  """Magnitudes exactly halfway between every two codebook values that
  are neighbours by size, and the values themselves."""
  vals = np.sort(np.asarray(ref_quant.pow2_codebook(k)[0], np.float64))
  mids = (vals[:-1] + vals[1:]) / 2   # exact in float32: at most 9 bits
  return np.concatenate([vals, mids, [0.0, 2.5, 1e-30]]).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2])
def test_midpoint_ties_follow_codebook_order(k):
  """H2: a magnitude at a midpoint takes the earlier codebook entry (k=1
  runs m = 0..7, values descending; k=2 runs in meshgrid order)."""
  mags = _midpoints(k)
  w = np.concatenate([mags, -mags])[None, :]
  one = np.ones((1, 1), np.float32)
  want = ref_quant.pow2_quantize(jnp.asarray(w), k=k, scale=jnp.asarray(one))
  got = quant.pow2_quantize(t(w), k=k, scale=t(one))
  assert same_bytes(got.codes, want.codes)
  if k == 1:   # 0.75 lies between 1 and 0.5: m = 0 comes first
    assert int(quant.pow2_quantize(torch.tensor([[0.75]]), k=1,
                                   scale=torch.ones(1, 1)).codes) == 0


@pytest.mark.parametrize("channel_axis", [0, 1, -1, None])
@pytest.mark.parametrize("k", [1, 2])
def test_pow2_quantize_matches_reference(k, channel_axis):
  rng = np.random.RandomState(20 + k)
  w = (rng.standard_normal((2, 12, 10)) * 0.3).astype(np.float32)
  w[0, 3] = 0.0
  want = ref_quant.pow2_quantize(jnp.asarray(w), k=k,
                                 channel_axis=channel_axis)
  got = quant.pow2_quantize(t(w), k=k, channel_axis=channel_axis)
  assert same_bytes(got.codes, want.codes)
  assert same_bytes(got.scale, want.scale)
  assert same_bytes(quant.pow2_dequantize(got),
                    ref_quant.pow2_dequantize(want))


def test_pow2_argmin_over_chunks_gives_the_same_codes(monkeypatch):
  """H9: the argmin taken over chunks of elements equals the one-shot
  argmin."""
  rng = np.random.RandomState(5)
  w = t((rng.standard_normal((40, 33)) * 0.2).astype(np.float32))
  whole = quant.pow2_quantize(w, k=2, channel_axis=1)
  monkeypatch.setattr(quant, "ARGMIN_CHUNK", 97)
  chunked = quant.pow2_quantize(w, k=2, channel_axis=1)
  assert torch.equal(whole.codes, chunked.codes)


@pytest.mark.parametrize("channel_axis", [0, 1, None])
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_int_quantize_matches_reference(bits, channel_axis):
  rng = np.random.RandomState(bits)
  w = (rng.standard_normal((16, 24)) * 0.2).astype(np.float32)
  w[:, 4] = 0.0
  want = ref_quant.int_quantize(jnp.asarray(w), bits=bits,
                                channel_axis=channel_axis)
  got = quant.int_quantize(t(w), bits=bits, channel_axis=channel_axis)
  assert same_bytes(got.codes, want.codes)
  assert_scales_equal_but_flushed(got.scale, want.scale, bits)
  assert same_bytes(quant.int_dequantize(got), ref_quant.int_dequantize(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 16])
def test_act_fake_quant_matches_reference(bits, dtype):
  """The reference's float32 tiny promotes a bf16 absmax to float32: the
  scale and rounding are float32, the result x's dtype."""
  rng = np.random.RandomState(bits + 1)
  x = (rng.standard_normal((6, 40)) * 3.0).astype(np.float32)
  xj = jnp.asarray(x, getattr(jnp, dtype))
  xt = t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
  want = ref_quant.act_fake_quant(xj, bits)
  got = quant.act_fake_quant(xt, bits)
  assert got.dtype == xt.dtype
  assert same_bytes(got.float(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("pe_type", PE_TYPES)
def test_act_fake_quant_for_pe(pe_type):
  rng = np.random.RandomState(9)
  x = rng.standard_normal((4, 32)).astype(np.float32)
  want = ref_quant.act_fake_quant_for_pe(jnp.asarray(x), pe_type)
  assert same_bytes(quant.act_fake_quant_for_pe(t(x), pe_type), want)


# properties of tests/test_quant.py, on the port

@pytest.mark.parametrize("k", [1, 2])
def test_pow2_roundtrip_idempotent(k):
  w = t(np.random.RandomState(0).standard_normal((32, 64)).astype(
      np.float32) * 0.1)
  q = quant.pow2_quantize(w, k=k)
  wh = quant.pow2_dequantize(q)
  q2 = quant.pow2_quantize(wh, k=k, scale=q.scale)
  assert torch.equal(q2.codes, q.codes)
  assert torch.equal(quant.pow2_dequantize(q2), wh)


def test_pow2_k2_better_than_k1():
  w = t(np.random.RandomState(1).standard_normal((64, 64)).astype(
      np.float32))
  e1 = (quant.pow2_dequantize(quant.pow2_quantize(w, 1)) - w).abs().mean()
  e2 = (quant.pow2_dequantize(quant.pow2_quantize(w, 2)) - w).abs().mean()
  assert e2 < e1


@pytest.mark.parametrize("k", [1, 2])
def test_pow2_quantize_is_nearest_codebook_point(k):
  """The chosen code minimizes |w/s - v| over the codebook."""
  w = t(np.random.RandomState(2).standard_normal(128).astype(np.float32))
  q = quant.pow2_quantize(w, k=k, channel_axis=None)
  vals = quant.pow2_codebook(k)[0].numpy()
  a = (w / q.scale).numpy()
  got = quant.pow2_decode_codes(q.codes, k).numpy()
  best = np.array([vals[np.argmin(np.abs(np.abs(x) - vals))] * np.sign(x)
                   for x in a])
  np.testing.assert_array_equal(got, best)


@pytest.mark.parametrize("k", [1, 2])
def test_pow2_decode_is_exact(k):
  """Every code decodes to the exact sum of powers of two it names."""
  codes = torch.arange(16 if k == 1 else 128, dtype=torch.uint8)
  got = quant.pow2_decode_codes(codes, k).numpy().astype(np.float64)
  c = codes.numpy().astype(np.int64)
  if k == 1:
    want = np.where(c & 8, -1.0, 1.0) * 2.0 ** -(c & 7)
  else:
    want = np.where(c & 64, -1.0, 1.0) * (2.0 ** -((c >> 3) & 7)
                                          + 2.0 ** -(c & 7))
  np.testing.assert_array_equal(got, want)
  assert same_bytes(quant.pow2_decode_codes(codes, k),
                    ref_quant.pow2_decode_codes(jnp.asarray(codes.numpy()),
                                                k))


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_int_error_bound(bits):
  w = t(np.random.RandomState(4).standard_normal((32, 32)).astype(
      np.float32))
  q = quant.int_quantize(w, bits)
  err = (quant.int_dequantize(q) - w).abs()
  # error bounded by scale/2 per element
  assert torch.all(err <= (q.scale / 2).expand_as(w) + 1e-7)


def test_int_bits_ordering():
  w = t(np.random.RandomState(5).standard_normal((64, 64)).astype(
      np.float32))
  errs = [float((quant.int_dequantize(quant.int_quantize(w, b)) - w)
                .abs().mean()) for b in (4, 8, 16)]
  assert errs[0] > errs[1] > errs[2]


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_nibble_roundtrip(seed):
  codes = np.random.RandomState(seed).randint(0, 16, (4, 16)).astype(
      np.uint8)
  packed = quant.pack_nibbles(t(codes))
  assert same_bytes(packed, ref_quant.pack_nibbles(jnp.asarray(codes)))
  # column 2j is the low nibble of byte j, column 2j+1 the high one
  assert torch.equal(packed & 0xF, t(codes[:, 0::2]))
  assert torch.equal(packed >> 4, t(codes[:, 1::2]))
  assert torch.equal(quant.unpack_nibbles(packed), t(codes))


@pytest.mark.parametrize("seed", range(5))
def test_int4_roundtrip(seed):
  codes = np.random.RandomState(seed).randint(-8, 8, (4, 16)).astype(
      np.int8)
  packed = quant.pack_int4(t(codes))
  assert same_bytes(packed, ref_quant.pack_int4(jnp.asarray(codes)))
  assert same_bytes(quant.unpack_int4(packed),
                    ref_quant.unpack_int4(jnp.asarray(packed.numpy())))
  assert torch.equal(quant.unpack_int4(packed), t(codes))


def test_quantized_records_are_frozen():
  q = quant.int_quantize(torch.ones(2, 2))
  with pytest.raises(dataclasses.FrozenInstanceError):
    q.bits = 4
