"""Slice 8b of the port against the JAX package on the CPU: jamba's Mamba
layer (``repro_torch.models.ssm``) and jamba-1.5-large's hybrid model at
``reduce_for_smoke``'s size (16 layers, d_model 64) in float32.

Parameters come from the reference's ``init_mamba`` and ``init_params``
(through ``convert.params_from_jax``), inputs from seeded numpy.  Bounds:

  * the conv, softplus and a decode step within 1e-6 of the reference's
    largest |value|;
  * the chunk scan within 1e-5 of max |y|: the port solves a chunk by a
    doubling scan, the reference by ``associative_scan``, so their sums
    of the same terms run in other orders;
  * ``apply_mamba`` and the prefill's cache (the state from the
    step-by-step recurrence, the conv window of pre-conv inputs) within
    1e-5 of the largest |value|, at lengths that are and are not chunk
    multiples, and shorter than the conv window;
  * the model's prefill and 3 decode steps within 1e-4 of the largest
    |logit| (1e-3 over an int8 cache, ``tests/test_torch_zoo.py``'s
    bound), greedy tokens equal; decode within 1e-4 of the prefill of
    the extended prompt (MoE at ``capacity_factor=8.0``, so that no token
    is dropped); parameter counts equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro.models.model import build_model as ref_build_model
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro.serve.engine import ServeEngine as RefServeEngine

from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, ssm, transformer
from repro_torch.serve import EngineConfig, ServeEngine

ARCH = "jamba-1.5-large"
KEY = jax.random.PRNGKey(0)


def rel_err(got, want) -> float:
  got, want = np.asarray(got), np.asarray(want)
  return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _cfgs(**changes):
  return (dataclasses.replace(ref_reduce(ref_get_config(ARCH)), **changes),
          dataclasses.replace(reduce_for_smoke(get_config(ARCH)), **changes))


def _np_tree(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _t(a) -> torch.Tensor:
  return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


@pytest.fixture(scope="module")
def mamba():
  """(reference cfg, port cfg, reference leaves, port leaves) of one Mamba
  layer at the smoke size, ``ssm_chunk`` 16."""
  rc, pc = _cfgs()
  ref_p = _np_tree(ref_ssm.init_mamba(KEY, rc))
  # perturb the leaves the reference initialises to constants, so that
  # each enters the comparison
  rng = np.random.RandomState(5)
  ref_p["conv_b"] = rng.standard_normal(ref_p["conv_b"].shape).astype(
      np.float32) * 0.1
  ref_p["d_skip"] = rng.uniform(0.5, 1.5, ref_p["d_skip"].shape).astype(
      np.float32)
  ref_p["norm"] = rng.uniform(0.5, 1.5, ref_p["norm"].shape).astype(
      np.float32)
  return rc, pc, ref_p, {k: _t(v) for k, v in ref_p.items()}


def _x(pc, b, l, seed):
  return np.random.RandomState(seed).standard_normal(
      (b, l, pc.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# the Mamba layer
# ---------------------------------------------------------------------------

def test_mamba_leaves_are_the_references(mamba):
  """MambaMix's leaves: the reference's names and shapes, the four
  projections in the model dtype, the rest float32; a's init is -(1..N)
  on every channel and dt's bias softplus^-1 of U(1e-3, 1e-1)."""
  _, pc, ref_p, _ = mamba
  mix = ssm.MambaMix(pc, "cpu", torch.bfloat16).init_(
      torch.Generator().manual_seed(0))
  leaves = dict(mix.named_parameters())
  assert {k: tuple(v.shape) for k, v in leaves.items()} == \
      {k: v.shape for k, v in ref_p.items()}
  for name, leaf in leaves.items():
    want = (torch.float32 if name in ssm.FLOAT32_LEAVES else torch.bfloat16)
    assert leaf.dtype == want, name
  # log(1..N): torch's log and XLA's may round to neighbouring floats
  np.testing.assert_allclose(mix.a_log.numpy(), ref_p["a_log"], rtol=1e-6,
                             atol=0)
  dt = torch.nn.functional.softplus(mix.dt_bias)
  assert 1e-3 <= float(dt.min()) and float(dt.max()) <= 1e-1 + 1e-6


def test_softplus_and_conv_match_reference(mamba):
  rc, pc, ref_p, p = mamba
  x = np.linspace(-30, 30, 2001, dtype=np.float32)
  assert rel_err(ssm._softplus(torch.from_numpy(x)).numpy(),
                 jax.nn.softplus(x)) < 1e-6
  for l in (1, 3, 20):
    u = _x(pc, 2, l, seed=l)[..., :8]
    w = ref_p["conv_w"][:, :8]
    want = ref_ssm._causal_depthwise_conv(u, w, ref_p["conv_b"][:8])
    got = ssm._causal_depthwise_conv(torch.from_numpy(u), p["conv_w"][:, :8],
                                     p["conv_b"][:8])
    assert rel_err(got.numpy(), want) < 1e-6


@pytest.mark.parametrize("chunk", [1, 4, 16])
def test_chunk_scan_matches_reference(chunk):
  """Three chunks of each size, the state carried across them: y within
  1e-5 of max |y|, with dt and A as the model draws them."""
  rng = np.random.RandomState(chunk)
  b, di, n, l = 2, 24, 16, 3 * chunk
  u = rng.standard_normal((b, l, di)).astype(np.float32)
  dt = rng.uniform(1e-3, 0.5, (b, l, di)).astype(np.float32)
  bm = rng.standard_normal((b, l, n)).astype(np.float32)
  cm = rng.standard_normal((b, l, n)).astype(np.float32)
  a = -np.broadcast_to(np.arange(1, n + 1, dtype=np.float32), (di, n)).copy()
  want = ref_ssm._ssm_chunk_scan(u, dt, bm, cm, a, chunk)
  got = ssm._ssm_chunk_scan(*map(torch.from_numpy, (u, dt, bm, cm, a)), chunk)
  assert rel_err(got.numpy(), want) < 1e-5
  # the doubling scan is the recurrence
  h, ys = np.zeros((b, di, n), np.float32), []
  for t in range(l):
    h = np.exp(dt[:, t, :, None] * a) * h + \
        (dt[:, t] * u[:, t])[..., None] * bm[:, t, None, :]
    ys.append(np.einsum("bdn,bn->bd", h, cm[:, t]))
  assert rel_err(got.numpy(), np.stack(ys, 1)) < 1e-5


@pytest.mark.parametrize("l", [1, 2, 16, 37])
def test_apply_mamba_and_its_cache_match_reference(mamba, l):
  """L ragged against the 16-token chunk (padded after the real tokens and
  cut back), and L = 1 and 2, shorter than the conv window of 3 (left-
  padded with zeros): the output, and the prefill's state and window
  against the reference's ``_mamba_final_state``."""
  rc, pc, ref_p, p = mamba
  x = _x(pc, 2, l, seed=10 + l)
  want = ref_ssm.apply_mamba(ref_p, x, rc)
  got = ssm.apply_mamba(p, torch.from_numpy(x), pc)
  assert rel_err(got.numpy(), want) < 1e-5
  out, cache = ssm.mamba_prefill(p, torch.from_numpy(x), pc)
  assert torch.equal(out, got)
  ref_cache = ref_tf._mamba_final_state(ref_p, x, rc)
  assert rel_err(cache["h"].numpy(), ref_cache["h"]) < 1e-5
  assert cache["conv"].shape == ref_cache["conv"].shape
  np.testing.assert_allclose(cache["conv"].numpy(), ref_cache["conv"],
                             rtol=1e-6, atol=1e-6)
  if l < pc.mamba_d_conv - 1:
    assert not cache["conv"][:, :pc.mamba_d_conv - 1 - l].any()


def test_mamba_decode_step_matches_reference(mamba):
  """One token against a seeded cache: the output and the updated state
  and window, the cache changed in place."""
  rc, pc, ref_p, p = mamba
  rng = np.random.RandomState(7)
  x = rng.standard_normal((3, pc.d_model)).astype(np.float32)
  h = rng.standard_normal((3, pc.d_inner, pc.mamba_d_state)).astype(
      np.float32)
  conv = rng.standard_normal((3, pc.mamba_d_conv - 1, pc.d_inner)).astype(
      np.float32)
  want, ref_cache = ref_ssm.mamba_decode_step(ref_p, x, {"h": h, "conv": conv},
                                              rc)
  cache = {"h": torch.from_numpy(h.copy()), "conv": torch.from_numpy(
      conv.copy())}
  h_ref = cache["h"]
  got, cache = ssm.mamba_decode_step(p, torch.from_numpy(x), cache, pc)
  assert cache["h"] is h_ref
  assert rel_err(got.numpy(), want) < 1e-6
  assert rel_err(cache["h"].numpy(), ref_cache["h"]) < 1e-6
  np.testing.assert_array_equal(cache["conv"].numpy(), ref_cache["conv"])
  fresh = ssm.init_mamba_cache(pc, 3)
  ref_fresh = ref_ssm.init_mamba_cache(rc, 3)
  for key in ("h", "conv"):
    assert tuple(fresh[key].shape) == ref_fresh[key].shape
    assert str(fresh[key].dtype).split(".")[-1] == str(ref_fresh[key].dtype)


# ---------------------------------------------------------------------------
# jamba-1.5-large, reduced
# ---------------------------------------------------------------------------

def _ref_and_port(**changes):
  rc, pc = _cfgs(**changes)
  ref_model = ref_build_model(rc)
  ref_params = ref_model.init(KEY)
  model = build_model(pc, device="cpu")
  params = model.from_state(convert.params_from_jax(pc,
                                                    _np_tree(ref_params)))
  return ref_model, ref_params, model, params


def _tokens(cfg, b, s, seed):
  return np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                             (b, s)).astype(np.int32)


def test_jamba_param_count_and_leaves_match_reference():
  """Parameter counts (full and reduced) equal the reference's; every
  leaf of the reference's tree lands once in the port's state dict, in
  its shape, and comes back by ``params_to_tree`` bit for bit."""
  ref, port = ref_get_config(ARCH), get_config(ARCH)
  assert port.param_count() == ref.param_count()
  assert port.param_count(active_only=True) == \
      ref.param_count(active_only=True)
  rc, pc = _cfgs()
  assert pc.param_count() == rc.param_count()
  ref_params = _np_tree(ref_tf.init_params(rc, KEY))
  params = build_model(pc, device="cpu").init(0)
  assert [layer.kind for layer in params.layers] == \
      ([kind for kind, _ in rc.block_pattern()] * rc.n_blocks)
  state = convert.params_from_jax(pc, ref_params)
  assert set(state) == set(params.state_dict())
  for name, t in params.state_dict().items():
    assert state[name].shape == t.shape, name
  assert state["layers.1.mix.a_log"].dtype == torch.float32
  back = transformer.flatten(convert.params_to_tree(
      pc, build_model(pc, device="cpu").from_state(state)))
  want = transformer.flatten(ref_params)
  assert set(back) == set(want)
  for name, leaf in want.items():
    np.testing.assert_array_equal(back[name].numpy(), leaf, err_msg=name)


@pytest.mark.parametrize("kv_quant", ["int8", "none"])
def test_jamba_prefill_and_decode_match_reference(kv_quant):
  """Logits within 1e-4 (1e-3 over an int8 cache) of the largest |logit|
  and the same greedy tokens for the prefill of 21 tokens (ragged against
  the 16-token chunk) and 3 decode steps; the mamba caches within 1e-5
  of the reference's after the prefill, and after the decode steps within
  the logits' bound (an int8 code one step off moves the hidden state
  the later layers take in)."""
  tol = 1e-4 if kv_quant == "none" else 1e-3
  ref_model, ref_params, model, params = _ref_and_port(kv_quant=kv_quant)
  toks = _tokens(model.cfg, 2, 21, seed=1)
  ref_logits, ref_cache = ref_model.prefill(
      ref_params, {"tokens": jnp.asarray(toks)}, 48)
  logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                48)
  assert rel_err(logits.numpy(), ref_logits) < 1e-4
  period = len(model.cfg.layer_kinds())

  def assert_caches_close(bound):
    for l, c in enumerate(cache["layers"]):
      if l % period:
        ref_c = ref_cache["layers"][f"sub{l % period}"]
        for key in ("h", "conv"):
          assert rel_err(c[key].numpy(), ref_c[key][l // period]) < bound
  assert_caches_close(1e-5)
  for step in range(3):
    nxt = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)
    assert np.array_equal(logits.argmax(-1).numpy(), nxt), step
    ref_logits, ref_cache = ref_model.decode_step(ref_params,
                                                  jnp.asarray(nxt), ref_cache)
    logits, cache = model.decode_step(params, torch.from_numpy(nxt), cache)
    assert rel_err(logits.numpy(), ref_logits) < tol, step
  assert_caches_close(max(tol, 1e-5))


def test_jamba_decode_continues_prefill():
  """Decoding one token equals prefilling the extended prompt (the port on
  its own: the cache's state from the step-by-step recurrence against
  the chunk scan's; MoE with capacity_factor 8.0)."""
  _, pc = _cfgs(kv_quant="none", capacity_factor=8.0)
  model = build_model(pc, device="cpu")
  params = model.init(0)
  toks = torch.from_numpy(_tokens(pc, 2, 24, seed=3))
  logits, cache = model.prefill(params, toks, 48)
  nxt = logits.argmax(-1).to(torch.int32)
  step, _ = model.decode_step(params, nxt, cache)
  full, _ = model.prefill(params, torch.cat([toks, nxt[:, None]], 1), 48)
  assert rel_err(step.numpy(), full.numpy()) < 1e-4


def test_jamba_engine_tokens_match_reference():
  """The serving engine's greedy tokens through the hybrid: prompts
  left-padded to the bucket, whose pad copies the mamba state takes in,
  as the reference's does."""
  ref_model, ref_params, model, params = _ref_and_port(kv_quant="int8")
  rng = np.random.RandomState(4)
  prompts = [rng.randint(0, 512, n) for n in (5, 16, 9)]
  ecfg = dict(batch_slots=2, max_len=64, prompt_bucket=16)
  ref_engine = RefServeEngine(ref_model, ref_params, RefEngineConfig(**ecfg))
  engine = ServeEngine(model, params, EngineConfig(**ecfg), device="cpu")
  for e in (ref_engine, engine):
    for i, p in enumerate(prompts):
      e.submit(p, max_new_tokens=3 + i)
  assert engine.run_until_drained() == ref_engine.run_until_drained()


def test_serve_launcher_takes_jamba(capsys):
  """``launch.serve`` serves one 8-layer block of jamba's pattern."""
  results = launch_serve.main(["--arch", ARCH, "--device", "cpu",
                               "--requests", "2", "--new-tokens", "2"])
  assert sorted(results) == [1, 2]
  assert all(len(t) == 2 for t in results.values())
  assert "served 2 requests" in capsys.readouterr().out
