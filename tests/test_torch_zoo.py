"""Slice 8a of the port against the JAX package on the CPU: olmo-1b,
granite-34b, minitron-4b, mixtral-8x22b, qwen2-moe-a2.7b and pixtral-12b
at ``reduce_for_smoke`` sizes in float32 (the MoE layer itself is held in
``tests/test_torch_moe.py``).

Parameters come from the reference's ``init_params`` through
``convert.params_from_jax``, inputs from seeded numpy.  Bounds:

  * parameter counts equal the reference's, and the port model's leaves
    count them plus the norms' scales and biases (which the analytic
    count leaves out);
  * activations, norms and positions within 1e-6 of the reference's
    largest |value| (``mlp_act``'s gelu is the tanh form, as
    ``jax.nn.gelu``'s default);
  * prefill and decode logits within 1e-4 of the largest |logit|, greedy
    tokens equal (the bound ``tests/test_torch_serve.py`` holds qwen3 to);
    decode over an int8 cache within 1e-3, since a K or V value within
    float32 rounding of a code boundary may take the neighbouring code;
    decode within 1e-4 of the prefill of the extended prompt, for MoE
    with ``capacity_factor=8.0`` so that no token is dropped, as
    ``tests/test_models.py`` holds the reference;
  * the train loss within 1e-5 relative and each gradient leaf within
    1e-4 of its largest |value| in float32; bf16 (olmo-1b) within 2^-8
    and 8 x 2^-8 against the reference compiled with
    ``xla_allow_excess_precision`` off (qwen3's bounds,
    ``tests/test_torch_train.py`` and ``tests/test_torch_rwkv_train.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.models import common as ref_common
from repro.models import transformer as ref_tf
from repro.models.model import build_model as ref_build_model
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro.serve.engine import ServeEngine as RefServeEngine

from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, common, transformer
from repro_torch.serve import EngineConfig, ServeEngine

ZOO = ("olmo-1b", "granite-34b", "minitron-4b", "mixtral-8x22b",
       "qwen2-moe-a2.7b", "pixtral-12b")
KEY = jax.random.PRNGKey(0)
BF16_U = 2.0 ** -8


def rel_err(got, want) -> float:
  got, want = np.asarray(got), np.asarray(want)
  return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _cfgs(arch, **changes):
  return (dataclasses.replace(ref_reduce(ref_get_config(arch)), **changes),
          dataclasses.replace(reduce_for_smoke(get_config(arch)), **changes))


def _np_tree(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def ref_and_port(arch, **changes):
  """(ref model, ref params, port model, port params) at the smoke size."""
  rc, pc = _cfgs(arch, **changes)
  ref_model = ref_build_model(rc)
  ref_params = ref_model.init(KEY)
  model = build_model(pc, device="cpu")
  params = model.from_state(convert.params_from_jax(pc,
                                                    _np_tree(ref_params)))
  return ref_model, ref_params, model, params


def _tokens(cfg, b, s, seed):
  return np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                             (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs and components
# ---------------------------------------------------------------------------

def _norm_leaves(cfg) -> int:
  per = {"rmsnorm": 1, "layernorm": 2, "layernorm_np": 0}[cfg.norm]
  return per * cfg.d_model * (2 * cfg.n_layers + 1)


@pytest.mark.parametrize("arch", ZOO)
def test_param_count_matches_reference_and_the_models_leaves(arch):
  ref, port = ref_get_config(arch), get_config(arch)
  assert port.param_count() == ref.param_count()
  assert port.param_count(active_only=True) == \
      ref.param_count(active_only=True)
  rc, pc = _cfgs(arch)
  params = build_model(pc, device="cpu").init(0)
  n = sum(p.numel() for p in params.parameters())
  assert n == pc.param_count() + _norm_leaves(pc)
  ref_n = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
      ref_tf.init_params(rc, KEY)))
  assert n == ref_n


@pytest.mark.parametrize("variant", ["gelu", "relu2", "swiglu"])
def test_mlp_act_matches_reference(variant):
  x = np.linspace(-6, 6, 4001, dtype=np.float32)
  got = common.mlp_act(torch.from_numpy(x), variant).numpy()
  want = np.asarray(ref_common.mlp_act(jnp.asarray(x), variant))
  assert float(np.max(np.abs(got - want))) <= 1e-6 * max(
      1.0, float(np.max(np.abs(want))))
  if variant == "gelu":
    # the erf form is what torch gives by default: 4e-4 away on [-3, 3]
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert float(np.max(np.abs(erf - want))) > 1e-4


def test_norms_and_positions_match_reference():
  """olmo's non-parametric layernorm (no leaves), sinusoids, and the
  learned table's rows added at the positions."""
  rng = np.random.RandomState(0)
  x = (rng.standard_normal((2, 24, 64)) * 2 + 0.5).astype(np.float32)
  _, pc = _cfgs("olmo-1b")
  got = common.apply_norm(None, torch.from_numpy(x), pc)
  assert rel_err(got.numpy(), ref_common.apply_norm({}, x, pc)) < 1e-6
  assert common.make_norm_params(pc) == {}
  assert not list(common.Norm(pc, "cpu").parameters())
  for n, d in ((37, 64), (512, 128), (1, 16)):
    # torch's exp and XLA's can round a frequency to neighbouring floats,
    # and position p moves that ulp's error in the angle p times: within
    # n x 2^-23 of the reference's value, and within 1e-6 of the exact
    # sin and cos of the port's own float32 angles
    got = common.sinusoidal_positions(n, d).numpy()
    want = np.asarray(ref_common.sinusoidal_positions(n, d))
    assert float(np.max(np.abs(got - want))) <= n * 2.0 ** -23
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32)
                    * (-np.log(10000.0) / d)).numpy()
    ang = (np.arange(n, dtype=np.float32)[:, None] * div).astype(np.float64)
    exact = np.stack([np.sin(ang), np.cos(ang)], -1).reshape(n, d)
    assert float(np.max(np.abs(got - exact))) <= 1e-6
  table = rng.standard_normal((100, 64)).astype(np.float32)
  pos = np.arange(24)
  rc, pc = _cfgs("granite-34b")
  want = ref_tf._add_positions({"pos_embed": table}, jnp.asarray(x), pos, rc)
  got = transformer._add_positions(torch.from_numpy(table),
                                   torch.from_numpy(x), torch.from_numpy(pos),
                                   pc)
  assert rel_err(got.numpy(), want) < 1e-6
  sin_rc, sin_pc = (dataclasses.replace(c, pos_embed="sinusoidal")
                    for c in (rc, pc))
  want = ref_tf._add_positions({}, jnp.asarray(x), pos, sin_rc)
  got = transformer._add_positions(None, torch.from_numpy(x),
                                   torch.from_numpy(pos), sin_pc)
  assert rel_err(got.numpy(), want) < 1e-6


def test_params_from_jax_carries_every_8a_leaf():
  """MoE leaves (router, stacked experts, the shared MLP), a learned
  position table and the empty norm dicts: each of the reference's
  leaves lands once in the port's state dict."""
  for arch in ("qwen2-moe-a2.7b", "granite-34b", "olmo-1b"):
    rc, pc = _cfgs(arch)
    ref_params = _np_tree(ref_tf.init_params(rc, KEY))
    state = convert.params_from_jax(pc, ref_params)
    params = build_model(pc, device="cpu").init(0)
    assert set(state) == set(params.state_dict())
    for name, t in params.state_dict().items():
      assert state[name].shape == t.shape, name
    back = transformer.flatten(convert.params_to_tree(
        pc, build_model(pc, device="cpu").from_state(state)))
    want = transformer.flatten(ref_params)
    assert set(back) == set(want)
    for name, leaf in want.items():
      np.testing.assert_array_equal(back[name].numpy(), leaf, err_msg=name)
  assert "layers.0.ffn.shared.wg" in convert.params_from_jax(
      _cfgs("qwen2-moe-a2.7b")[1],
      _np_tree(ref_tf.init_params(_cfgs("qwen2-moe-a2.7b")[0], KEY)))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _codes_close(got, want):
  """int8 codes equal but where a K or V value lies within float32
  rounding of a code boundary: there the two packages' other summation
  orders may take the neighbouring code (one in mixtral's smoke cache
  here)."""
  diff = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
  assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("kv_quant", ["int8", "none"])
@pytest.mark.parametrize("arch", ZOO)
def test_prefill_and_decode_match_reference(arch, kv_quant):
  """Logits within 1e-4 of the largest |logit| with a float32 cache, and
  within 1e-3 (the int8-KV bound ``[serve-parity]`` holds the card to)
  with an int8 one, where a code one step off moves a logit by up to a
  few 1e-4 of the largest."""
  tol = 1e-4 if kv_quant == "none" else 1e-3
  ref_model, ref_params, model, params = ref_and_port(arch, kv_quant=kv_quant)
  toks = _tokens(model.cfg, 2, 24, seed=1)
  ref_logits, ref_cache = ref_model.prefill(
      ref_params, {"tokens": jnp.asarray(toks)}, 48)
  logits, cache = model.prefill(params, torch.from_numpy(toks), 48)
  assert rel_err(logits.numpy(), ref_logits) < 1e-4
  for step in range(3):
    nxt = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)
    assert np.array_equal(logits.argmax(-1).numpy(), nxt), step
    ref_logits, ref_cache = ref_model.decode_step(ref_params,
                                                  jnp.asarray(nxt), ref_cache)
    logits, cache = model.decode_step(params, torch.from_numpy(nxt), cache)
    assert rel_err(logits.numpy(), ref_logits) < tol, step
  if kv_quant == "int8":
    for i, layer_cache in enumerate(cache["layers"]):
      for key in ("k_codes", "v_codes"):
        _codes_close(layer_cache[key].numpy(),
                     ref_cache["layers"]["sub0"][key][i])


@pytest.mark.parametrize("arch", ZOO)
def test_decode_continues_prefill(arch):
  """Decoding one token equals prefilling the extended prompt (the port
  on its own, as the reference's tests/test_models.py holds itself; MoE
  with capacity_factor 8.0, so that no token is dropped)."""
  changes = dict(kv_quant="none")
  if get_config(arch).n_experts:
    changes["capacity_factor"] = 8.0
  _, pc = _cfgs(arch, **changes)
  model = build_model(pc, device="cpu")
  params = model.init(0)
  toks = torch.from_numpy(_tokens(pc, 2, 24, seed=3))
  logits, cache = model.prefill(params, toks, 48)
  nxt = logits.argmax(-1).to(torch.int32)
  step, _ = model.decode_step(params, nxt, cache)
  full, _ = model.prefill(params, torch.cat([toks, nxt[:, None]], 1), 48)
  assert rel_err(step.numpy(), full.numpy()) < 1e-4


def test_mixtral_ring_wraps_past_its_window():
  """mixtral's sliding window (32 at the smoke size) with a prompt of 40:
  prefill keeps the last 32 positions rolled into the ring, and decode
  writes at pos % 32 for 8 more steps, each against the reference."""
  ref_model, ref_params, model, params = ref_and_port("mixtral-8x22b",
                                                     kv_quant="int8")
  assert model.cfg.sliding_window == 32
  toks = _tokens(model.cfg, 1, 40, seed=2)
  ref_logits, ref_cache = ref_model.prefill(
      ref_params, {"tokens": jnp.asarray(toks)}, 96)
  logits, cache = model.prefill(params, torch.from_numpy(toks), 96)
  assert cache["layers"][0]["k_codes"].shape[2] == 32
  assert rel_err(logits.numpy(), ref_logits) < 1e-4
  for step in range(8):
    nxt = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)
    ref_logits, ref_cache = ref_model.decode_step(ref_params,
                                                  jnp.asarray(nxt), ref_cache)
    logits, cache = model.decode_step(params, torch.from_numpy(nxt), cache)
    assert rel_err(logits.numpy(), ref_logits) < 1e-4, step
  for key in ("k_codes", "v_codes"):
    _codes_close(cache["layers"][0][key].numpy(),
                 ref_cache["layers"]["sub0"][key][0])


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-34b"])
def test_engine_tokens_match_reference(arch):
  """The engine's greedy tokens through a MoE (one-token prefill groups
  and the dense decode path) and through learned positions."""
  ref_model, ref_params, model, params = ref_and_port(arch)
  rng = np.random.RandomState(4)
  prompts = [rng.randint(0, 512, n) for n in (5, 16, 9)]
  ecfg = dict(batch_slots=2, max_len=64, prompt_bucket=16)
  ref_engine = RefServeEngine(ref_model, ref_params, RefEngineConfig(**ecfg))
  engine = ServeEngine(model, params, EngineConfig(**ecfg), device="cpu")
  for e in (ref_engine, engine):
    for i, p in enumerate(prompts):
      e.submit(p, max_new_tokens=4 + i)
  assert engine.run_until_drained() == ref_engine.run_until_drained()


@pytest.mark.parametrize("arch", ZOO)
def test_serve_launcher_takes_every_8a_arch(arch, capsys):
  results = launch_serve.main(["--arch", arch, "--device", "cpu",
                               "--requests", "2", "--new-tokens", "2"])
  assert sorted(results) == [1, 2]
  assert all(len(t) == 2 for t in results.values())
  assert "served 2 requests" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_SMOKE = dict(d_model=128, n_layers=2, vocab_size=2048, attn_chunk=16,
                   loss_chunk_tokens=48)
BATCH, SEQ = 2, 32
# arch -> the overrides of its case: mixtral's groups of 16 give the
# train path four MoE groups
TRAIN_CASES = {"olmo-1b": {}, "granite-34b": {}, "minitron-4b": {},
               "qwen2-moe-a2.7b": {}, "pixtral-12b": {},
               "mixtral-8x22b": dict(moe_group_size=16)}


def _train_batch(cfg, seed=0):
  rng = np.random.RandomState(seed)
  batch = {"tokens": rng.randint(0, cfg.vocab_size, (BATCH, SEQ)),
           "labels": rng.randint(0, cfg.vocab_size, (BATCH, SEQ))}
  batch = {k: v.astype(np.int32) for k, v in batch.items()}
  if cfg.family == "vlm":
    batch["img_embeds"] = rng.standard_normal(
        (BATCH, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
  return batch


def _flat(tree):
  return {k: (v.detach().float().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v))
          for k, v in transformer.flatten(tree).items()}


def _assert_leaves_close(got, want, tol):
  fg, fw = _flat(got), _flat(want)
  assert set(fg) == set(fw)
  for k in fw:
    scale = float(np.abs(fw[k]).max())
    err = float(np.abs(fg[k] - fw[k]).max())
    assert err <= tol * scale, (k, err, scale)
    assert scale > 0, k


def _loss_and_grads(arch, dtype, compiled):
  rc, pc = _cfgs(arch, **TRAIN_SMOKE, **TRAIN_CASES[arch])
  rc, pc = (dataclasses.replace(c, dtype=dtype) for c in (rc, pc))
  ref_params = _np_tree(ref_tf.init_params(rc, KEY))
  batch = _train_batch(pc)
  fn = jax.value_and_grad(
      lambda p: ref_tf.train_loss(p, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, rc),
      has_aux=True)
  jp = jax.tree_util.tree_map(jnp.asarray, ref_params)
  if compiled:
    (want, want_m), want_g = jax.jit(fn).lower(jp).compile(
        compiler_options={"xla_allow_excess_precision": False})(jp)
  else:
    (want, want_m), want_g = fn(jp)
  model = build_model(pc, device="cpu")
  params = model.from_state(convert.params_from_jax(pc, ref_params,
                                                    dtype=torch.float32),
                            param_dtype="float32")
  got, got_m = model.train_loss(params, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
  named = dict(params.named_parameters())
  grads = torch.autograd.grad(got, list(named.values()))
  got_g = transformer.stack_blocks(pc, transformer.nest(dict(zip(named,
                                                                 grads))))
  return pc, (want, want_m, _np_tree(want_g)), (got, got_m, got_g)


@pytest.mark.parametrize("arch", sorted(TRAIN_CASES))
def test_train_loss_and_gradients_match_reference(arch):
  pc, (want, want_m, want_g), (got, got_m, got_g) = _loss_and_grads(
      arch, "float32", compiled=False)
  assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
  assert float(got_m["tokens"]) == float(want_m["tokens"]) == BATCH * SEQ
  aux, want_aux = float(got_m["aux"].detach()), float(want_m["aux"])
  assert abs(aux - want_aux) <= 1e-5 * abs(want_aux)
  assert (aux > 0) == bool(pc.n_experts)
  _assert_leaves_close(got_g, want_g, 1e-4)


def test_bf16_train_loss_and_gradients_match_reference():
  _, (want, _, want_g), (got, _, got_g) = _loss_and_grads(
      "olmo-1b", "bfloat16", compiled=True)
  assert abs(float(got.detach()) - float(want)) <= BF16_U * abs(float(want))
  _assert_leaves_close(got_g, want_g, 8 * BF16_U)


def test_vlm_image_prefix_is_masked_out_of_the_loss():
  """The image embeddings change the text's logits (they are attended
  to) but carry no label: the token count is the text's, and a loss
  over the text alone differs."""
  _, pc = _cfgs("pixtral-12b", **TRAIN_SMOKE)
  model = build_model(pc, device="cpu")
  params = model.init(0, param_dtype="float32")
  batch = {k: torch.from_numpy(v) for k, v in _train_batch(pc, 1).items()}
  loss, metrics = model.train_loss(params, batch)
  text, _ = model.train_loss(params, {k: batch[k]
                                      for k in ("tokens", "labels")})
  assert float(metrics["tokens"]) == BATCH * SEQ
  assert float(loss) != float(text)


def test_train_launcher_defaults_to_olmo(tmp_path):
  trainer = launch_train.main(["--device", "cpu", "--smoke", "--steps", "2",
                               "--ckpt-dir", str(tmp_path)])
  assert trainer.model.cfg.name == "olmo-1b" and trainer.step == 2
  assert all(np.isfinite(r["loss"]) for r in trainer.history)
