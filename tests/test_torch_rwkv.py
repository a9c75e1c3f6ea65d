"""The port's rwkv6-1.6b serving path against the JAX package: layernorm, K7's plain versions against the Pallas kernel (interpret mode)
and the sequential oracle, the RWKV-6 model's prefill and decode (reduced
for the CPU, float32), its recurrent cache, the serving engine's greedy
tokens and the launcher.

On the CPU the K7 wrapper runs its plain chunked version; the CUDA kernel
itself runs only on a card (``tests/test_torch_gpu.py``).  Inputs are made
with numpy from a seed and handed to both packages; model parameters come
from the reference's ``init`` through ``convert.params_from_jax``, with
every constant-initialized leaf perturbed so that the lerps, biases and
scales are exercised.  Tolerances, each with its reason:
  * K7's plain versions vs the Pallas kernel and the sequential oracle:
    2e-5 of the largest |value| (the reference's own bound between them:
    float32 sums taken in another order);
  * the port's chunked form vs the reference model's ``wkv6_chunked``:
    1e-6 (the same arithmetic, op for op);
  * per-token decode steps vs the chunked form: 1e-4 (the reference's);
  * logits, model vs model: 1e-4 of the largest |logit| (as the qwen3
    serving tests), argmax and engine tokens equal; caches 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.kernels.rwkv6_scan import ops as ref_wkv
from repro.models import common as ref_common
from repro.models import ssm as ref_ssm
from repro.models.model import build_model as ref_build_model
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro.serve.engine import ServeEngine as RefServeEngine

from repro_torch import _build, convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_scan import ops as wkv
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, common, ssm
from repro_torch.serve import EngineConfig, ServeEngine

ARCH = "rwkv6-1.6b"

# leaves the reference initializes to constants (ones, zeros, 0.5)
CONSTANT_LEAVES = ("mix", "cmix", "ln_x", "scale", "bias")


def rel_err(got, want) -> float:
  got, want = np.asarray(got), np.asarray(want)
  return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def perturbed(tree, seed: int = 11):
  """The reference's parameter tree as numpy, with every constant leaf
  replaced by a seeded draw around its constant."""
  rng = np.random.RandomState(seed)

  def leaf(path, a):
    a = np.asarray(a)
    name = getattr(path[-1], "key", "")
    if name in CONSTANT_LEAVES:
      a = a + rng.uniform(-0.3, 0.3, a.shape).astype(a.dtype)
    return a
  return jax.tree_util.tree_map_with_path(leaf, tree)


def ref_and_port(**overrides):
  """(ref model, ref params, port model, port params) at the smoke size,
  float32, sharing one perturbed parameter tree."""
  ref_cfg = ref_reduce(ref_get_config(ARCH), **overrides)
  cfg = reduce_for_smoke(get_config(ARCH), **overrides)
  ref_model = ref_build_model(ref_cfg)
  tree = perturbed(ref_model.init(jax.random.PRNGKey(0)))
  ref_params = jax.tree_util.tree_map(jnp.asarray, tree)
  model = build_model(cfg, device="cpu")
  params = model.from_state(convert.params_from_jax(cfg, tree))
  return ref_model, ref_params, model, params


def wkv_inputs(b, h, t, d, seed, w_min=None, s0=True):
  rng = np.random.RandomState(seed)
  r = rng.standard_normal((b, h, t, d)).astype(np.float32) * 0.5
  k = rng.standard_normal((b, h, t, d)).astype(np.float32) * 0.5
  v = rng.standard_normal((b, h, t, d)).astype(np.float32)
  if w_min is None:
    w = np.exp(-np.exp(rng.standard_normal((b, h, t, d)))).astype(np.float32)
  else:
    w = rng.uniform(w_min, 0.999, (b, h, t, d)).astype(np.float32)
  u = rng.standard_normal((h, d)).astype(np.float32) * 0.3
  state = (rng.standard_normal((b, h, d, d)).astype(np.float32) * 0.1
           if s0 else np.zeros((b, h, d, d), np.float32))
  return r, k, v, w, u, state


def torch_args(*arrays):
  return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# layernorm (the config is held to the reference in test_torch_serve.py)
# ---------------------------------------------------------------------------

def test_layernorm_matches_reference():
  rng = np.random.RandomState(0)
  x = (rng.standard_normal((3, 7, 64)) * 2 + 0.7).astype(np.float32)
  scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
  bias = rng.uniform(-0.5, 0.5, 64).astype(np.float32)
  cfg = reduce_for_smoke(get_config(ARCH))
  got = common.apply_norm(torch.from_numpy(scale), torch.from_numpy(x), cfg,
                          bias=torch.from_numpy(bias))
  want = ref_common.apply_norm({"scale": scale, "bias": bias}, x, cfg)
  assert got.dtype == torch.float32
  assert rel_err(got.numpy(), want) < 1e-6
  norm = common.Norm(cfg, "cpu")
  assert norm.bias.dtype == torch.float32 and not norm.bias.any()
  xb = torch.from_numpy(x).to(torch.bfloat16)
  assert norm(xb).dtype == torch.bfloat16
  np_cfg = dataclasses.replace(cfg, norm="layernorm_np")
  got = common.apply_norm(None, torch.from_numpy(x), np_cfg)
  want = ref_common.apply_norm({}, x, np_cfg)
  assert rel_err(got.numpy(), want) < 1e-6
  assert not list(common.Norm(np_cfg, "cpu").parameters())


# ---------------------------------------------------------------------------
# K7's plain versions
# ---------------------------------------------------------------------------

# (b, h, t, d, chunk): the reference kernel test's shapes (the second with
# a ragged T), and a ragged T of 40 with chunk 16
WKV_CASES = [(2, 4, 128, 64, 64), (1, 2, 100, 32, 32), (2, 3, 256, 64, 16),
             (1, 2, 40, 16, 16)]


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv6_plain_matches_pallas_and_oracle(case):
  b, h, t, d, chunk = case
  r, k, v, w, u, s0 = wkv_inputs(b, h, t, d, seed=sum(case))
  pallas_o, pallas_s = ref_wkv.wkv6(r, k, v, w, u, s0, interpret=True,
                                    chunk=chunk)
  oracle_o, oracle_s = ref_wkv.wkv6_reference(r, k, v, w, u, s0)
  got_o, got_s = wkv.wkv6(*torch_args(r, k, v, w, u, s0), chunk=chunk)
  seq_o, seq_s = wkv.wkv6_reference(*torch_args(r, k, v, w, u, s0))
  assert got_o.dtype == got_s.dtype == torch.float32
  assert got_o.shape == (b, h, t, d) and got_s.shape == (b, h, d, d)
  for o, s in ((pallas_o, pallas_s), (oracle_o, oracle_s)):
    assert rel_err(got_o.numpy(), o) < 2e-5
    assert rel_err(got_s.numpy(), s) < 2e-5
    assert rel_err(seq_o.numpy(), o) < 2e-5
    assert rel_err(seq_s.numpy(), s) < 2e-5


@pytest.mark.parametrize("s0", [True, False], ids=["s0", "zero_state"])
def test_wkv6_chunked_equals_the_reference_model_form(s0):
  """Strong decays (down to 0.05) and a ragged T; the port's chunked form
  is the reference model's ``ssm.wkv6_chunked`` op for op."""
  r, k, v, w, u, state = wkv_inputs(2, 3, 70, 16, seed=5, w_min=0.05, s0=s0)
  want_o, want_s = ref_ssm.wkv6_chunked(r, k, v, w, u, state, 16)
  got_o, got_s = wkv_ref.wkv6_chunked(*torch_args(r, k, v, w, u, state), 16)
  assert rel_err(got_o.numpy(), want_o) < 1e-6
  assert rel_err(got_s.numpy(), want_s) < 1e-6
  oracle_o, oracle_s = ref_wkv.wkv6_reference(r, k, v, w, u, state)
  assert rel_err(got_o.numpy(), oracle_o) < 2e-5
  assert rel_err(got_s.numpy(), oracle_s) < 2e-5
  if not s0:
    none_o, none_s = wkv.wkv6(*torch_args(r, k, v, w, u), chunk=16)
    assert torch.equal(none_o, got_o) and torch.equal(none_s, got_s)


def test_wkv6_decode_steps_equal_the_chunked_form():
  r, k, v, w, u, state = wkv_inputs(1, 2, 24, 32, seed=9)
  tr, tk, tv, tw, tu, ts = torch_args(r, k, v, w, u, state)
  s = ts
  outs = []
  for i in range(r.shape[2]):
    o, s = wkv.wkv6_decode_step(tr[:, :, i], tk[:, :, i], tv[:, :, i],
                                tw[:, :, i], tu, s)
    want_o, want_s = ref_wkv.wkv6_decode_step(
        r[:, :, i], k[:, :, i], v[:, :, i], w[:, :, i], u,
        state if i == 0 else want_s)
    assert rel_err(o.numpy(), want_o) < 1e-6
    outs.append(o)
  chunk_o, chunk_s = wkv.wkv6(tr, tk, tv, tw, tu, ts, chunk=8)
  np.testing.assert_allclose(torch.stack(outs, 2).numpy(), chunk_o.numpy(),
                             rtol=1e-4, atol=1e-4)
  np.testing.assert_allclose(s.numpy(), chunk_s.numpy(), rtol=1e-4,
                             atol=1e-4)
  assert rel_err(s.numpy(), want_s) < 1e-6


# K7's CUDA schedule rebuilt in plain torch (the kernel runs only on a
# card): its cluster size and sub-chunk rows are read from its source


def _split(r, k, v, w, u, s0, chunk, blocks=None):
  return wkv_ref.wkv6_split(
      *torch_args(r, k, v, w, u, s0), chunk,
      max_blocks=blocks or _build.csrc_constant("rwkv6_scan", "kMaxBlocks"),
      sub=_build.csrc_constant("rwkv6_scan", "kSub"))


def _hold_split_to_every_form(case, r, k, v, w, u, s0, blocks=None):
  """wkv6_split against the chunked form, the Pallas kernel in interpret
  mode and the sequential scan: within 2e-5 of the largest |value|, or,
  where the port's chunked form itself is further than that from a form,
  no further from it than the chunked form (1% slack).  At w = 1e-30 the
  log-decay form's la sums reach |la| in the thousands, where float32
  keeps them to about 1e-4 absolute and exp(la_last - la) inherits that:
  the two chunked forms then differ by 3e-5 in the state themselves."""
  b, h, t, d, chunk = case
  got = _split(r, k, v, w, u, s0, chunk, blocks)
  assert got[0].shape == (b, h, t, d) and got[1].shape == (b, h, d, d)
  assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
  chunked = wkv_ref.wkv6_chunked(*torch_args(r, k, v, w, u, s0), chunk)
  for form in (chunked,
               ref_wkv.wkv6(r, k, v, w, u, s0, interpret=True, chunk=chunk),
               wkv.wkv6_reference(*torch_args(r, k, v, w, u, s0))):
    for mine, ours, want in zip(got, chunked, form):
      want = np.asarray(want)
      bound = max(2e-5, 1.01 * rel_err(ours.numpy(), want))
      assert rel_err(mine.numpy(), want) < bound


# T longer than the cluster's 8 chunks: a block owns two or three
SPLIT_CASES = WKV_CASES + [(1, 2, 1100, 64, 64), (1, 3, 600, 32, 32)]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_wkv6_split_keeps_the_function(case):
  """K7's split over a cluster (contiguous chunk ranges, each range's
  state contribution, the state folded along the blocks in rank order)
  and its factorised sub-chunk scores keep the function."""
  b, h, t, d, _ = case
  _hold_split_to_every_form(case, *wkv_inputs(b, h, t, d, seed=sum(case)))


@pytest.mark.parametrize("blocks", [7, 5, 3])
def test_wkv6_split_keeps_the_function_at_every_cluster_size(blocks):
  """The kernel takes fewer blocks a cluster than its most where the card
  holds more clusters of them at once (18 chunks over 7 blocks: 3, 3, 3,
  3, 2, 2, 2); any count keeps the function."""
  case = (1, 2, 1100, 64, 64)
  b, h, t, d, _ = case
  _hold_split_to_every_form(case, *wkv_inputs(b, h, t, d, seed=blocks),
                            blocks=blocks)


@pytest.mark.parametrize("case", [(2, 4, 128, 64, 64), (1, 2, 1100, 64, 64),
                                  (1, 2, 300, 32, 32)], ids=str)
def test_wkv6_split_stays_finite_at_extreme_decays(case):
  """w drawn from 1e-30 (the clamp) up to 0.9999, with a tenth of the
  entries at either end: every exponent stays <= 0, so nothing
  overflows, and the split holds to every form within 2e-5."""
  b, h, t, d, _ = case
  r, k, v, w, u, s0 = wkv_inputs(b, h, t, d, seed=sum(case) + 1)
  rng = np.random.RandomState(sum(case))
  w = rng.uniform(1e-30, 0.9999, w.shape).astype(np.float32)
  pick = rng.uniform(size=w.shape)
  w[pick < 0.05] = 1e-30
  w[pick > 0.95] = 0.9999
  _hold_split_to_every_form(case, r, k, v, w, u, s0)


def test_wkv6_kernel_wrapper_refuses_cpu_tensors():
  r, k, v, w, u, state = torch_args(*wkv_inputs(1, 2, 8, 16, seed=1))
  with pytest.raises(ValueError, match="expected a CUDA tensor"):
    wkv_kernel.wkv6(r, k, v, w, u, state)
  with pytest.raises(ValueError, match="expected a CUDA tensor"):
    wkv_kernel.check_inputs(r, k, v, w, u, None, 64)
  assert wkv_kernel.LAUNCHES["wkv6"] == 0


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_params_from_jax_fills_every_rwkv_parameter_once():
  ref_model, ref_params, model, params = ref_and_port()
  tree = jax.tree_util.tree_map(np.asarray, ref_params)
  state = convert.params_from_jax(model.cfg, tree)
  assert set(state) == set(params.state_dict())
  ref_leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
  n_ref = sum(np.asarray(a).shape[0] if "blocks" in jax.tree_util.keystr(p)
              else 1 for p, a in ref_leaves)
  assert len(state) == n_ref                # one tensor per leaf per block
  mix = tree["blocks"]["sub0"]["mix"]
  np.testing.assert_array_equal(params.layers[1].mix.u.numpy(), mix["u"][1])
  np.testing.assert_array_equal(params.layers[0].mix.cm_wv.numpy(),
                                mix["cm_wv"][0])
  np.testing.assert_array_equal(params.final_norm.bias.numpy(),
                                tree["final_norm"]["bias"])
  np.testing.assert_array_equal(params.lm_head.numpy(), tree["lm_head"])
  bf16 = dataclasses.replace(model.cfg, dtype="bfloat16")
  state = convert.params_from_jax(bf16, tree)
  for leaf in ("wr", "wo", "w_lora_a", "w_lora_b", "cm_wk"):
    assert state[f"layers.0.mix.{leaf}"].dtype == torch.bfloat16, leaf
  for leaf in ("mix", "cmix", "w0", "u", "ln_x"):
    assert state[f"layers.0.mix.{leaf}"].dtype == torch.float32, leaf
  assert state["layers.0.ffn_norm.bias"].dtype == torch.float32
  assert state["lm_head"].dtype == torch.bfloat16


def test_init_is_seeded_and_shaped_like_reference():
  cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)),
                            dtype="bfloat16")
  model = build_model(cfg, device="cpu")
  a, b, c = model.init(0), model.init(0), model.init(1)
  for (name, ta), tb, tc in zip(a.state_dict().items(),
                                b.state_dict().values(),
                                c.state_dict().values()):
    assert torch.equal(ta, tb), name
    if name.split(".")[-1] not in CONSTANT_LEAVES:
      assert not torch.equal(ta, tc), name
  ref_params = ref_build_model(
      dataclasses.replace(ref_reduce(ref_get_config(ARCH)),
                          dtype="bfloat16")).init(jax.random.PRNGKey(0))
  state = convert.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                              ref_params))
  for name, t in a.state_dict().items():
    assert t.shape == state[name].shape and t.dtype == state[name].dtype
  w0 = a.layers[0].mix.w0
  assert abs(w0.mean().item() + 6.0) < 0.15 and abs(w0.std().item() - 0.3) < 0.1


def test_time_and_channel_mix_match_reference():
  ref_model, ref_params, model, params = ref_and_port()
  cfg = model.cfg
  x = np.random.RandomState(2).standard_normal((2, 21, 64)).astype(
      np.float32)
  p = ref_params["blocks"]["sub0"]["mix"]
  p0 = jax.tree_util.tree_map(lambda a: a[0], p)
  mix = params.layers[0].mix
  got = ssm.apply_rwkv_time_mix(mix, torch.from_numpy(x), cfg)[0]
  assert rel_err(got.numpy(), ref_ssm.apply_rwkv_time_mix(p0, x, cfg)) < 1e-5
  got = ssm.apply_rwkv_channel_mix(mix, torch.from_numpy(x), cfg)
  assert rel_err(got.numpy(),
                 ref_ssm.apply_rwkv_channel_mix(p0, x, cfg)) < 1e-5
  shifted = ssm._token_shift(torch.from_numpy(x))
  np.testing.assert_array_equal(shifted.numpy(),
                                np.asarray(ref_ssm._token_shift(x)))


@pytest.mark.parametrize("s", [24, 37])
def test_prefill_and_decode_match_reference(s):
  ref_model, ref_params, model, params = ref_and_port()
  b, max_len = 2, 64
  toks = np.random.RandomState(s).randint(0, model.cfg.vocab_size, (b, s))
  toks = toks.astype(np.int32)
  ref_logits, ref_cache = ref_model.prefill(ref_params,
                                            {"tokens": jnp.asarray(toks)},
                                            max_len)
  logits, cache = model.prefill(params, torch.from_numpy(toks), max_len)
  assert rel_err(logits.numpy(), ref_logits) < 1e-4
  assert cache["length"] == int(ref_cache["length"]) == s
  for step in range(3):
    nxt = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)
    assert np.array_equal(logits.argmax(-1).numpy(), nxt)
    ref_logits, ref_cache = ref_model.decode_step(ref_params,
                                                  jnp.asarray(nxt), ref_cache)
    logits, cache = model.decode_step(params, torch.from_numpy(nxt), cache)
    assert rel_err(logits.numpy(), ref_logits) < 1e-4, step
  assert np.array_equal(logits.argmax(-1).numpy(),
                        np.argmax(np.asarray(ref_logits), -1))
  for i, layer_cache in enumerate(cache["layers"]):
    for key in ("s", "tm_prev", "cm_prev"):
      want = np.asarray(ref_cache["layers"]["sub0"][key][i])
      assert layer_cache[key].shape == want.shape, key
      assert rel_err(layer_cache[key].numpy(), want) < 1e-5, (i, key)


def test_decode_continues_prefill():
  """Decoding one token after prefill(t[:n]) == prefill(t[:n + 1])'s last
  logits (the port on its own, as the reference's test_models holds
  itself)."""
  _, _, model, params = ref_and_port()
  toks = torch.from_numpy(
      np.random.RandomState(3).randint(0, 512, (2, 25)).astype(np.int32))
  logits, cache = model.prefill(params, toks[:, :24], 48)
  step, _ = model.decode_step(params, toks[:, 24], cache)
  full, _ = model.prefill(params, toks, 48)
  assert rel_err(step.numpy(), full.numpy()) < 1e-4


def test_cache_is_updated_in_place_with_a_host_int_length():
  _, _, model, params = ref_and_port()
  logits, cache = model.prefill(
      params, torch.zeros((1, 8), dtype=torch.int32), 32)
  layer = cache["layers"][0]
  tensors = {key: layer[key] for key in ("s", "tm_prev", "cm_prev")}
  before = {key: t.clone() for key, t in tensors.items()}
  assert cache["length"] == 8 and isinstance(cache["length"], int)
  _, cache2 = model.decode_step(params, logits.argmax(-1).to(torch.int32),
                                cache)
  assert cache2 is cache and cache["length"] == 9
  for key, t in tensors.items():
    assert cache["layers"][0][key] is t, key
    assert not torch.equal(t, before[key]), key
  empty = model.init_cache(2, 16)
  assert empty["length"] == 0 and len(empty["layers"]) == model.cfg.n_layers
  assert empty["layers"][0]["s"].shape == (2, 4, 16, 16)
  assert empty["layers"][0]["tm_prev"].dtype == torch.float32


PROMPT_LENGTHS = (5, 9, 16, 20, 12)


def test_engine_tokens_match_reference():
  ref_model, ref_params, model, params = ref_and_port()
  rng = np.random.RandomState(4)
  prompts = [rng.randint(0, 512, n) for n in PROMPT_LENGTHS]
  ecfg = dict(batch_slots=2, max_len=64, prompt_bucket=16)
  ref_engine = RefServeEngine(ref_model, ref_params, RefEngineConfig(**ecfg))
  engine = ServeEngine(model, params, EngineConfig(**ecfg), device="cpu")
  for e in (ref_engine, engine):
    for i, p in enumerate(prompts):
      e.submit(p, max_new_tokens=4 + i)
  want = ref_engine.run_until_drained()
  got = engine.run_until_drained()
  assert got == want
  assert [len(got[uid]) for uid in sorted(got)] == [4, 5, 6, 7, 8]


def test_launcher_serves_rwkv_on_the_cpu(capsys):
  results = launch_serve.main(["--arch", ARCH, "--device", "cpu",
                               "--requests", "3", "--new-tokens", "4"])
  assert sorted(results) == [1, 2, 3]
  assert all(len(toks) == 4 and all(0 <= t < 2048 for t in toks)
             for toks in results.values())
  assert "served 3 requests / 12 tokens" in capsys.readouterr().out


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  cfg = reduce_for_smoke(get_config(ARCH))
  with pytest.raises(RuntimeError, match="no CUDA device"):
    build_model(cfg)
  model = build_model(cfg, device="cpu")
  params = model.init(0)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    ServeEngine(model, params, EngineConfig())
  with pytest.raises(RuntimeError, match="no CUDA device"):
    launch_serve.main(["--arch", ARCH, "--requests", "1"])


@pytest.mark.parametrize("change", [dict(family="hybrid", attn_period=2)],
                         ids=str)
def test_rwkv_variants_still_to_port_name_their_slice(change):
  """A hybrid of attention and Mamba layers serves since slice 8b: it
  builds, inits and prefills; its training names slice 8c."""
  cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)), **change)
  model = build_model(cfg, device="cpu")
  params = model.init(0)
  assert [layer.kind for layer in params.layers] == ["attn", "mamba"]
  toks = torch.zeros((1, 8), dtype=torch.int64)
  logits, _ = model.prefill(params, toks, 16)
  assert bool(torch.isfinite(logits).all())
  with pytest.raises(NotImplementedError, match="slice 8c"):
    model.train_loss(params, {"tokens": toks, "labels": toks})


@pytest.mark.parametrize("change", [dict(n_experts=4, n_experts_active=2,
                                         d_ff_expert=32),
                                    dict(norm="layernorm_np")], ids=str)
def test_rwkv_variants_build_like_the_reference(change):
  """An rwkv layer marked MoE builds no ffn, as the reference's
  ``init_layer``; under ``layernorm_np`` its norms have no parameters:
  the port's leaves are the reference's, and prefill matches it."""
  cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)), **change)
  ref_cfg = dataclasses.replace(ref_reduce(ref_get_config(ARCH)), **change)
  ref_model = ref_build_model(ref_cfg)
  ref_params = ref_model.init(jax.random.PRNGKey(0))
  model = build_model(cfg, device="cpu")
  state = convert.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                              ref_params))
  assert set(state) == set(model.init(0).state_dict())
  assert not any(".ffn." in name for name in state)
  params = model.from_state(state)
  toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (1, 20))
  toks = toks.astype(np.int32)
  want, _ = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)}, 32)
  got, _ = model.prefill(params, torch.from_numpy(toks), 32)
  assert rel_err(got.numpy(), want) < 1e-4
