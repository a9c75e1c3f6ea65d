"""The port's serving path against the JAX package: configs, model
components, qwen3-0.6b prefill and decode (reduced for the CPU, float32),
the int8 cache, the serving engine's greedy tokens and its deadline
eviction.

Parameters come from the reference (``model.init(PRNGKey(0))``) through
``convert.params_from_jax``, so both packages run the same numbers.
Logits are held within 1e-4 of the largest |logit| (the bound the
reference holds its own decode-vs-prefill check to); cache codes and
greedy tokens are held equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import ALL_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.explore.service import Deadline as RefDeadline
from repro.models import common as ref_common
from repro.models.model import build_model as ref_build_model
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro.serve.engine import ServeEngine as RefServeEngine

from repro_torch import convert
from repro_torch.configs import get_config, list_archs, reduce_for_smoke
from repro_torch.explore.service import Deadline
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, common, transformer
from repro_torch.serve import EngineConfig, ServeEngine

ARCH = "qwen3-0.6b"
SERVED = ("qwen3-0.6b", "rwkv6-1.6b")   # the archs the port serves


def ref_and_port(kv_quant="int8", **overrides):
  """(ref model, ref params, port model, port params) at the smoke size."""
  ref_cfg = dataclasses.replace(ref_reduce(ref_get_config(ARCH), **overrides),
                                kv_quant=kv_quant)
  cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH), **overrides),
                            kv_quant=kv_quant)
  ref_model = ref_build_model(ref_cfg)
  ref_params = ref_model.init(jax.random.PRNGKey(0))
  model = build_model(cfg, device="cpu")
  params = model.from_state(convert.params_from_jax(
      cfg, jax.tree_util.tree_map(np.asarray, ref_params)))
  return ref_model, ref_params, model, params


def rel_err(got, want) -> float:
  got, want = np.asarray(got), np.asarray(want)
  return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


@pytest.mark.parametrize("arch", SERVED)
def test_config_is_a_copy(arch):
  for ref_cfg, cfg in (
      (ref_get_config(arch), get_config(arch)),
      (ref_reduce(ref_get_config(arch)), reduce_for_smoke(get_config(arch))),
      (ref_reduce(ref_get_config(arch), d_model=128, n_layers=4),
       reduce_for_smoke(get_config(arch), d_model=128, n_layers=4))):
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.padded_vocab == ref_cfg.padded_vocab
    assert cfg.block_pattern() == ref_cfg.block_pattern()
  assert list_archs() == list(SERVED)


@pytest.mark.parametrize("arch", sorted(set(ALL_ARCHS) - set(SERVED)))
def test_other_archs_name_the_slice_that_brings_them(arch):
  with pytest.raises(NotImplementedError, match="slice"):
    get_config(arch)


def test_unported_layer_kinds_raise():
  cfg = reduce_for_smoke(get_config(ARCH))
  for change in (dict(n_experts=4), dict(family="hybrid", attn_period=2),
                 dict(pos_embed="learned"), dict(norm="layernorm_np"),
                 dict(mlp_variant="gelu"), dict(family="encdec")):
    with pytest.raises(NotImplementedError, match="slice"):
      build_model(dataclasses.replace(cfg, **change), device="cpu")
  # qwen3 trains (tests/test_torch_train.py); rwkv6 training, which needs a
  # backward for K7, names slice 7c
  rwkv = reduce_for_smoke(get_config("rwkv6-1.6b"))
  model = build_model(rwkv, device="cpu")
  toks = torch.zeros((1, 8), dtype=torch.int64)
  with pytest.raises(NotImplementedError, match="slice 7c"):
    model.train_loss(model.init(0), {"tokens": toks, "labels": toks})
  with pytest.raises(NotImplementedError, match="slice 7c"):
    model.init(0, param_dtype="float32")


def test_common_components_match_reference():
  rng = np.random.RandomState(0)
  x = rng.standard_normal((2, 24, 4, 16)).astype(np.float32) * 3
  scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
  cfg = reduce_for_smoke(get_config(ARCH))
  pos = np.arange(24, dtype=np.int32)
  checks = [
      (common.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
       ref_common.rope(x, pos, 1e6)),
      (common.rope(torch.from_numpy(x[:, 0]), torch.full((2,), 37), 1e6),
       ref_common.rope(x[:, 0], jnp.full((2,), 37), 1e6)),
      (common.rms_head_norm(torch.from_numpy(x), torch.from_numpy(scale)),
       ref_common.rms_head_norm(x, scale)),
      (common.apply_norm(torch.from_numpy(scale), torch.from_numpy(x), cfg),
       ref_common.apply_norm({"scale": scale}, x, cfg)),
  ]
  for got, want in checks:
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) < 1e-6
  xb = torch.from_numpy(x).to(torch.bfloat16)
  assert common.rope(xb, torch.from_numpy(pos), 1e6).dtype == torch.bfloat16
  assert common.rms_head_norm(xb, torch.ones(16)).dtype == torch.bfloat16


def test_params_from_jax_fills_every_parameter_once():
  _, ref_params, model, params = ref_and_port()
  state = convert.params_from_jax(
      model.cfg, jax.tree_util.tree_map(np.asarray, ref_params))
  assert set(state) == set(params.state_dict())
  np.testing.assert_array_equal(params.embed.numpy(),
                                np.asarray(ref_params["embed"]))
  wq = np.asarray(ref_params["blocks"]["sub0"]["mix"]["wq"])
  np.testing.assert_array_equal(params.layers[1].mix.wq.numpy(), wq[1])
  bf16 = dataclasses.replace(model.cfg, dtype="bfloat16")
  state = convert.params_from_jax(
      bf16, jax.tree_util.tree_map(np.asarray, ref_params))
  assert state["layers.0.ffn.wi"].dtype == torch.bfloat16
  assert state["layers.0.mix.q_norm"].dtype == torch.float32
  np.testing.assert_array_equal(
      state["layers.0.ffn.wi"].float().numpy(),
      np.asarray(jnp.asarray(ref_params["blocks"]["sub0"]["ffn"]["wi"][0])
                 .astype(jnp.bfloat16).astype(jnp.float32)))


def test_init_is_seeded_and_shaped_like_reference():
  cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)),
                            dtype="bfloat16")
  model = build_model(cfg, device="cpu")
  a, b, c = model.init(0), model.init(0), model.init(1)
  for (name, ta), tb, tc in zip(a.state_dict().items(),
                                b.state_dict().values(),
                                c.state_dict().values()):
    assert torch.equal(ta, tb), name
    if "norm" not in name:
      assert not torch.equal(ta, tc), name
  ref_params = ref_build_model(
      dataclasses.replace(ref_reduce(ref_get_config(ARCH)),
                          dtype="bfloat16")).init(jax.random.PRNGKey(0))
  state = convert.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                              ref_params))
  for name, t in a.state_dict().items():
    assert t.shape == state[name].shape and t.dtype == state[name].dtype
  std = a.layers[0].mix.wq.float().std().item()
  assert abs(std - 1 / np.sqrt(cfg.d_model)) < 0.2 / np.sqrt(cfg.d_model)


@pytest.mark.parametrize("kv_quant", ["int8", "none"])
def test_prefill_and_decode_match_reference(kv_quant):
  ref_model, ref_params, model, params = ref_and_port(kv_quant)
  b, s, max_len = 2, 24, 48
  toks = np.random.RandomState(1).randint(0, model.cfg.vocab_size, (b, s))
  toks = toks.astype(np.int32)
  ref_logits, ref_cache = ref_model.prefill(ref_params,
                                            {"tokens": jnp.asarray(toks)},
                                            max_len)
  logits, cache = model.prefill(params, torch.from_numpy(toks), max_len)
  assert rel_err(logits.numpy(), ref_logits) < 1e-4
  assert cache["length"] == int(ref_cache["length"])
  for step in range(3):
    nxt = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)
    assert np.array_equal(logits.argmax(-1).numpy(), nxt)
    ref_logits, ref_cache = ref_model.decode_step(ref_params,
                                                  jnp.asarray(nxt), ref_cache)
    logits, cache = model.decode_step(params, torch.from_numpy(nxt), cache)
    assert rel_err(logits.numpy(), ref_logits) < 1e-4, step
  keys = ("k_codes", "v_codes") if kv_quant == "int8" else ("k", "v")
  for i, layer_cache in enumerate(cache["layers"]):
    for key in keys:
      want = np.asarray(ref_cache["layers"]["sub0"][key][i])
      got = layer_cache[key].numpy()
      if kv_quant == "int8":
        np.testing.assert_array_equal(got, want)
      else:
        assert rel_err(got, want) < 1e-5
  if kv_quant == "int8":
    for key in ("k_scale", "v_scale"):
      want = np.asarray(ref_cache["layers"]["sub0"][key][1])
      assert rel_err(cache["layers"][1][key].numpy(), want) < 1e-5


def test_ring_cache_matches_reference():
  """A sliding window shorter than the prompt: the rolled ring after
  prefill, then decode writes at ``pos % window``."""
  ref_model, ref_params, model, params = ref_and_port(sliding_window=16)
  toks = np.random.RandomState(2).randint(0, 512, (1, 21)).astype(np.int32)
  ref_logits, ref_cache = ref_model.prefill(ref_params,
                                            {"tokens": jnp.asarray(toks)}, 64)
  logits, cache = model.prefill(params, torch.from_numpy(toks), 64)
  assert rel_err(logits.numpy(), ref_logits) < 1e-4
  for _ in range(4):
    nxt = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)
    ref_logits, ref_cache = ref_model.decode_step(ref_params,
                                                  jnp.asarray(nxt), ref_cache)
    logits, cache = model.decode_step(params, torch.from_numpy(nxt), cache)
    assert rel_err(logits.numpy(), ref_logits) < 1e-4
  np.testing.assert_array_equal(
      cache["layers"][0]["k_codes"].numpy(),
      np.asarray(ref_cache["layers"]["sub0"]["k_codes"][0]))


def test_decode_continues_prefill():
  """Decoding one token == prefilling the extended prompt (the port on
  its own, as the reference's test_models holds itself)."""
  _, _, model, params = ref_and_port("none")
  toks = torch.from_numpy(
      np.random.RandomState(3).randint(0, 512, (2, 24)).astype(np.int32))
  logits, cache = model.prefill(params, toks, 48)
  nxt = logits.argmax(-1).to(torch.int32)
  step, _ = model.decode_step(params, nxt, cache)
  full, _ = model.prefill(params, torch.cat([toks, nxt[:, None]], 1), 48)
  assert rel_err(step.numpy(), full.numpy()) < 1e-4


PROMPT_LENGTHS = (5, 9, 16, 20, 12)


@pytest.mark.parametrize("kv_quant", ["int8", "none"])
def test_engine_tokens_match_reference(kv_quant):
  ref_model, ref_params, model, params = ref_and_port(kv_quant)
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


class FakeClock:
  def __init__(self):
    self.t = 100.0

  def __call__(self) -> float:
    return self.t


def _evicting_run(engine, deadline_type):
  clock = FakeClock()
  prompt = np.arange(3, 11)
  a = engine.submit(prompt, 8, deadline=deadline_type(10.0, clock))
  b = engine.submit(prompt, 8, deadline=deadline_type(5.0, clock))
  c = engine.submit(prompt, 3)
  first = engine.run_until_drained(max_steps=3)  # a decodes, b and c queue
  clock.t += 11.0                                # both deadlines pass
  rest = engine.run_until_drained()
  reqs = {r.uid: r for r in [*engine.queue, *engine.active] if r}
  return first, rest, engine.n_evicted, (a, b, c), reqs


def test_deadline_eviction_with_injected_clock():
  ref_model, ref_params, model, params = ref_and_port()
  ecfg = dict(batch_slots=1, max_len=64, prompt_bucket=16)
  engine = ServeEngine(model, params, EngineConfig(**ecfg), device="cpu")
  first, rest, n_evicted, (a, b, c), left = _evicting_run(engine, Deadline)
  assert first == {} and not left
  assert n_evicted == 2
  assert len(rest[a]) == 4            # a: prefill + 3 steps, then evicted
  assert rest[b] == []                # b: expired while queued
  assert len(rest[c]) == 3            # c: no deadline, served in full
  ref = RefServeEngine(ref_model, ref_params, RefEngineConfig(**ecfg))
  assert _evicting_run(ref, RefDeadline)[:3] == (first, rest, n_evicted)
  d = Deadline(2.0, FakeClock())
  assert d.remaining() == 2.0 and not d.expired()
  d.clock.t += 2.0
  assert d.expired()


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  cfg = reduce_for_smoke(get_config(ARCH))
  with pytest.raises(RuntimeError, match="no CUDA device"):
    build_model(cfg)
  model = build_model(cfg, device="cpu")
  assert model.device.type == "cpu"
  params = model.init(0)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    ServeEngine(model, params, EngineConfig())
  with pytest.raises(RuntimeError, match="no CUDA device"):
    launch_serve.main(["--requests", "1"])
  with pytest.raises(ValueError, match="lives on"):
    ServeEngine(model, params, EngineConfig(),
                device=torch.device("meta"))


def test_launcher_serves_on_the_cpu(capsys):
  results = launch_serve.main(["--device", "cpu", "--requests", "3",
                               "--new-tokens", "4"])
  assert sorted(results) == [1, 2, 3]
  assert all(len(toks) == 4 and all(0 <= t < 2048 for t in toks)
             for toks in results.values())
  assert "served 3 requests / 12 tokens" in capsys.readouterr().out


def test_cache_length_is_a_host_int_and_decode_updates_in_place():
  _, _, model, params = ref_and_port()
  logits, cache = model.prefill(
      params, torch.zeros((1, 8), dtype=torch.int32), 32)
  codes = cache["layers"][0]["k_codes"]
  assert cache["length"] == 8 and isinstance(cache["length"], int)
  before = codes[:, :, 8].clone()
  _, cache2 = model.decode_step(params, logits.argmax(-1).to(torch.int32),
                                cache)
  assert cache2 is cache and cache["length"] == 9
  assert cache["layers"][0]["k_codes"] is codes
  assert not torch.equal(codes[:, :, 8], before)
  assert transformer.lm_head_weight(params, model.cfg).shape == (
      model.cfg.d_model, model.cfg.padded_vocab)
