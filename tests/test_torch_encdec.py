"""Slice 8b of the port against the JAX package on the CPU: whisper-base's
encoder-decoder (``repro_torch.models.encdec``) at ``reduce_for_smoke``'s
size (2 encoder and 2 decoder layers, d_model 64, 32 encoder frames) in
float32, and K6's plain version with fewer or more keys than queries,
the cross-attention it runs.

Parameters come from the reference's ``init_params`` through
``convert.params_from_jax``, inputs from seeded numpy.  Bounds:

  * K6's plain version at S_q != S_k within 1e-6 of the largest |out| of
    the reference's ``flash_attention_reference`` masking (its queries
    padded to the keys' length, or its ragged keys masked by its
    ``seq_len``) and of the reference model's ``cross_attention``;
  * the encoder's states within 1e-5 of the largest |value|;
  * prefill and 3 decode steps within 1e-4 of the largest |logit| (1e-3
    over an int8 self-attention cache, ``tests/test_torch_zoo.py``'s
    bound), greedy tokens equal, the kept cross K/V within 1e-6; decode
    within 1e-4 of the prefill of the extended prompt; parameter counts
    equal;
  * the bf16 backward's plain model of its arithmetic, which walks only
    the pairs a mask keeps, bit-equal to its walk over every pair.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.kernels.flash_attention import ops as ref_fa_ops
from repro.kernels.flash_attention import ref as ref_fa_ref
from repro.models import attention as ref_attention
from repro.models import encdec as ref_encdec
from repro.models.model import build_model as ref_build_model

from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention, build_model, encdec, transformer

ARCH = "whisper-base"
KEY = jax.random.PRNGKey(0)


def rel_err(got, want) -> float:
  got, want = np.asarray(got), np.asarray(want)
  return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _cfgs(**changes):
  return (dataclasses.replace(ref_reduce(ref_get_config(ARCH)), **changes),
          dataclasses.replace(reduce_for_smoke(get_config(ARCH)), **changes))


def _np_tree(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _ref_and_port(**changes):
  rc, pc = _cfgs(**changes)
  ref_model = ref_build_model(rc)
  ref_params = ref_model.init(KEY)
  model = build_model(pc, device="cpu")
  params = model.from_state(convert.params_from_jax(pc,
                                                    _np_tree(ref_params)))
  return ref_model, ref_params, model, params


def _batch(cfg, b, s, seed):
  rng = np.random.RandomState(seed)
  return {"tokens": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
          "enc_frames": rng.standard_normal(
              (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}


def _torch(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# K6 with S_q != S_k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,sk", [(1, 70), (63, 64), (65, 64), (40, 1500),
                                   (130, 17)])
def test_plain_k6_takes_other_key_lengths_like_the_reference(sq, sk):
  """Non-causal GQA attention of S_q queries over S_k keys: the reference's
  ``flash_attention_reference`` at S = max(S_q, S_k), the queries padded
  (their extra rows dropped) or the keys padded and masked by the
  reference's own ``seq_len``, and the reference model's
  ``cross_attention``."""
  b, h, hkv, d = 2, 4, 2, 16
  rng = np.random.RandomState(sq + sk)
  q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
  k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
  v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
  got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
  assert got.shape == (b, sq, h, d) and got.dtype == torch.float32
  if sq <= sk:
    qp = np.pad(q, ((0, 0), (0, sk - sq), (0, 0), (0, 0)))
    want = np.asarray(ref_fa_ops.flash_attention_reference(
        qp, k, v, causal=False))[:, :sq]
  else:
    pad = ((0, 0), (0, sq - sk), (0, 0), (0, 0))
    kr, vr = (np.repeat(np.pad(t, pad), h // hkv, axis=2) for t in (k, v))

    def flat(t):
      return np.moveaxis(t, 2, 1).reshape(b * h, sq, d)
    want = np.asarray(ref_fa_ref.flash_attention_ref(
        flat(q), flat(kr), flat(vr), 1.0 / d ** 0.5, causal=False,
        seq_len=sk))
    want = np.moveaxis(want.reshape(b, h, sq, d), 1, 2)
  assert rel_err(got.numpy(), want) < 1e-6
  model_ref = ref_attention.cross_attention(q, k, v, chunk_q=32, chunk_k=32)
  model_got = attention.cross_attention(*map(torch.from_numpy, (q, k, v)))
  assert rel_err(model_got.numpy(), model_ref) < 1e-6
  lse = fa.flash_attention_lse_reference(torch.from_numpy(q),
                                         torch.from_numpy(k), causal=False)
  assert lse.shape == (b, h, sq)


def test_k6_refuses_what_it_does_not_take_at_other_key_lengths():
  """Causal and windowed attention compare a query's position with a
  key's: at S_q != S_k they raise, on the CPU as on the card; the
  backward at S_q != S_k names slice 8c, which brings it."""
  q = torch.zeros((1, 8, 2, 16))
  kv = torch.zeros((1, 12, 2, 16))
  for causal, window in ((True, 0), (False, 4), (True, 4)):
    with pytest.raises(ValueError, match="as many keys as queries"):
      fa.flash_attention(q, kv, kv, causal=causal, window=window)
    with pytest.raises(ValueError, match="as many keys as queries"):
      fa.flash_attention_reference(q, kv, kv, causal=causal, window=window)
  ctx = types.SimpleNamespace(
      saved_tensors=(q, kv, kv, torch.zeros((1, 8, 2, 16)),
                     torch.zeros((1, 2, 8))),
      causal=False, window=0, scale=0.25)
  with pytest.raises(NotImplementedError, match="slice 8c"):
    fa.FlashAttention.backward(ctx, torch.zeros((1, 8, 2, 16)))


def _bwd_bf16_order_full_walk(q, k, v, o, do, lse, sm_scale, causal, window,
                              step):
  """``fa_ref.flash_attention_bwd_bf16_order`` as it walked every (query,
  key) pair, the masked ones too: each stage's P and dS over all keys
  (dK, dV) or all queries (dQ), 16 rows deep at a time."""
  b, s, h, d = q.shape
  grp = h // k.shape[2]

  def heads_first(x):
    x = x.float().permute(0, 2, 1, 3)
    return torch.repeat_interleave(x, h // x.shape[1], dim=1)

  def split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()

  qf, kf, vf = heads_first(q), heads_first(k), heads_first(v)
  doh, dol = split(heads_first(do))
  delta = (heads_first(do) * heads_first(o)).sum(-1)
  lse = lse.float()
  pos = torch.arange(s)

  def p_ds(rows, cols):
    qpos, kpos = pos[rows][:, None], pos[cols][None, :]
    ok = torch.ones((qpos.shape[0], kpos.shape[1]), dtype=torch.bool)
    if causal:
      ok = ok & (qpos >= kpos)
    if window:
      ok = ok & (kpos > qpos - window)
    kt, vt = kf[:, :, cols].transpose(-1, -2), vf[:, :, cols].transpose(-1, -2)
    p = torch.where(ok, torch.exp(qf[:, :, rows] @ kt * sm_scale
                                  - lse[:, :, rows, None]), 0.0)
    dp = doh[:, :, rows] @ vt + dol[:, :, rows] @ vt
    return p, p * (dp - delta[:, :, rows, None])

  everything = slice(0, s)
  dk = torch.zeros((b, h, s, d))
  dv = torch.zeros((b, h, s, d))
  for q0 in range(0, s, step):
    p, ds = p_ds(slice(q0, q0 + step), everything)
    for c0 in range(0, p.shape[2], 16):
      rows = slice(q0 + c0, q0 + c0 + 16)
      ph, pl = split(p[:, :, c0:c0 + 16].transpose(-1, -2))
      sh, sl = split(ds[:, :, c0:c0 + 16].transpose(-1, -2))
      dv = dv + ph @ doh[:, :, rows]
      dk = dk + sh @ qf[:, :, rows]
      dv = dv + ph @ dol[:, :, rows]
      dk = dk + sl @ qf[:, :, rows]
      dv = dv + pl @ doh[:, :, rows]
  dq = torch.zeros((b, h, s, d))
  for k0 in range(0, s, step):
    _, ds = p_ds(everything, slice(k0, k0 + step))
    for c0 in range(0, ds.shape[3], 16):
      cols = slice(k0 + c0, k0 + c0 + 16)
      sh, sl = split(ds[:, :, :, c0:c0 + 16])
      dq = dq + sh @ kf[:, :, cols]
      dq = dq + sl @ kf[:, :, cols]

  def back(x, heads):
    x = x.reshape(b, heads, h // heads, s, d).sum(2)
    return x.permute(0, 2, 1, 3).to(torch.bfloat16)
  hkv = h // grp
  return back(dq * sm_scale, h), back(dk * sm_scale, hkv), back(dv, hkv)


@pytest.mark.parametrize("case", [
    (1, 100, 4, 2, 64, True, 0, 64), (2, 63, 4, 4, 32, True, 0, 32),
    (1, 130, 4, 1, 64, True, 48, 64), (1, 97, 2, 1, 128, True, 16, 32),
    (1, 513, 4, 2, 128, True, 0, 64), (1, 65, 2, 2, 64, False, 0, 64)],
    ids=str)
def test_bf16_order_backward_skips_only_masked_pairs(case):
  """``flash_attention_bwd_bf16_order`` walks only the pairs a causal or
  windowed mask keeps: bit for bit what the walk over every pair gives
  (the masked pairs add exact zeros), at causal, windowed and ragged
  shapes (S not a multiple of the stage or of 16)."""
  b, s, h, hkv, d, causal, window, step = case
  rng = np.random.RandomState(s + window)
  q, k, v = (torch.from_numpy(rng.standard_normal(
      (b, s, n, d)).astype(np.float32)).bfloat16() for n in (h, hkv, hkv))
  do = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
  out = fa.flash_attention_reference(q, k, v, causal=causal, window=window)
  lse = fa.flash_attention_lse_reference(q, k, causal=causal, window=window)
  args = (q, k, v, out, do, lse, 1.0 / d ** 0.5, causal, window, step)
  got = fa_ref.flash_attention_bwd_bf16_order(*args)
  want = _bwd_bf16_order_full_walk(*args)
  for name, x, y in zip(("dq", "dk", "dv"), got, want):
    assert x.dtype == y.dtype == torch.bfloat16 and x.shape == y.shape, name
    assert torch.equal(x.view(torch.int16), y.view(torch.int16)), name


# ---------------------------------------------------------------------------
# whisper-base, reduced
# ---------------------------------------------------------------------------

def test_whisper_param_count_and_leaves_match_reference():
  """Parameter counts (full and reduced) equal the reference's; every
  leaf of the reference's tree, ``enc_blocks`` and ``dec_blocks`` stacked
  on their layer axis, lands once in the port's state dict, in its shape,
  and comes back by ``params_to_tree`` bit for bit."""
  ref, port = ref_get_config(ARCH), get_config(ARCH)
  assert port.param_count() == ref.param_count()
  rc, pc = _cfgs()
  assert pc.param_count() == rc.param_count()
  ref_params = _np_tree(ref_encdec.init_params(rc, KEY))
  params = build_model(pc, device="cpu").init(0)
  assert isinstance(params, encdec.EncDec)
  n = sum(p.numel() for p in params.parameters())
  assert n == sum(a.size for a in jax.tree_util.tree_leaves(ref_params))
  state = convert.params_from_jax(pc, ref_params)
  assert set(state) == set(params.state_dict())
  for name, t in params.state_dict().items():
    assert state[name].shape == t.shape, name
  assert state["dec_blocks.1.cross_norm.scale"].dtype == torch.float32
  back = transformer.flatten(convert.params_to_tree(
      pc, build_model(pc, device="cpu").from_state(state)))
  want = transformer.flatten(ref_params)
  assert set(back) == set(want)
  for name, leaf in want.items():
    np.testing.assert_array_equal(back[name].numpy(), leaf, err_msg=name)


def test_encoder_matches_reference():
  """Sinusoidal positions and bidirectional attention blocks (K6's plain
  version, ``causal=False``)."""
  _, ref_params, model, params = _ref_and_port()
  frames = _batch(model.cfg, 2, 4, seed=2)["enc_frames"]
  rc, _ = _cfgs()
  want = ref_encdec.encode(ref_params, jnp.asarray(frames), rc)
  got = encdec.encode(params, torch.from_numpy(frames), model.cfg)
  assert rel_err(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("kv_quant", ["int8", "none"])
def test_whisper_prefill_and_decode_match_reference(kv_quant):
  """Logits within 1e-4 (1e-3 over an int8 self-attention cache) of the
  largest |logit| and the same greedy tokens for a prefill and 3 decode
  steps; the cross K/V the prefill keeps, (B, Hkv, T, D) in the model
  dtype, within 1e-6 of the reference's."""
  tol = 1e-4 if kv_quant == "none" else 1e-3
  ref_model, ref_params, model, params = _ref_and_port(kv_quant=kv_quant)
  batch = _batch(model.cfg, 2, 11, seed=1)
  ref_logits, ref_cache = ref_model.prefill(
      ref_params, {k: jnp.asarray(v) for k, v in batch.items()}, 32)
  logits, cache = model.prefill(params, _torch(batch), 32)
  assert rel_err(logits.numpy(), ref_logits) < 1e-4
  for l, c in enumerate(cache["layers"]):
    for key in ("cross_k", "cross_v"):
      want = ref_cache["layers"][key][l]
      assert c[key].shape == want.shape and c[key].dtype == torch.float32
      assert rel_err(c[key].numpy(), want) < 1e-6
  for step in range(3):
    nxt = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)
    assert np.array_equal(logits.argmax(-1).numpy(), nxt), step
    ref_logits, ref_cache = ref_model.decode_step(ref_params,
                                                  jnp.asarray(nxt), ref_cache)
    logits, cache = model.decode_step(params, torch.from_numpy(nxt), cache)
    assert rel_err(logits.numpy(), ref_logits) < tol, step
  assert cache["length"] == 14 and int(ref_cache["length"]) == 14


def test_whisper_decode_continues_prefill():
  """Decoding one token equals prefilling the extended prompt against the
  same frames (the port on its own)."""
  _, pc = _cfgs()
  model = build_model(pc, device="cpu")
  params = model.init(0)
  batch = _torch(_batch(pc, 2, 12, seed=3))
  logits, cache = model.prefill(params, batch, 32)
  nxt = logits.argmax(-1).to(torch.int32)
  step, _ = model.decode_step(params, nxt, cache)
  longer = dict(batch, tokens=torch.cat([batch["tokens"], nxt[:, None]], 1))
  full, _ = model.prefill(params, longer, 32)
  assert rel_err(step.numpy(), full.numpy()) < 1e-4
  fresh = model.init_cache(2, 32)
  assert fresh["layers"][0]["cross_k"].shape == (2, pc.n_kv_heads,
                                                 pc.encoder_seq, pc.head_dim)


def test_whisper_entry_points_say_what_it_takes(tmp_path):
  """Prefill takes a batch dict with the frames, not a tensor of tokens;
  the serving launcher (whose engine feeds tokens only, as the
  reference's) raises ValueError, and training names slice 8c."""
  _, pc = _cfgs()
  model = build_model(pc, device="cpu")
  params = model.init(0)
  with pytest.raises(ValueError, match="enc_frames"):
    model.prefill(params, torch.zeros((1, 4), dtype=torch.int64), 8)
  with pytest.raises(ValueError, match="encoder-decoder"):
    launch_serve.main(["--arch", ARCH, "--device", "cpu"])
  toks = torch.zeros((1, 4), dtype=torch.int64)
  with pytest.raises(NotImplementedError, match="slice 8c"):
    model.train_loss(params, {"tokens": toks, "labels": toks})
  with pytest.raises(NotImplementedError, match="slice 8c"):
    model.init(0, param_dtype="float32")
  with pytest.raises(NotImplementedError, match="slice 8c"):
    launch_train.main(["--arch", ARCH, "--device", "cpu", "--smoke",
                       "--steps", "1", "--ckpt-dir", str(tmp_path)])
