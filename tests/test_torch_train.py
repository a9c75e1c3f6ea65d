"""The port's language-model training on the CPU, held to the reference
(``repro``) on the same weights and batches: the train forward and loss,
their gradients, K6's autograd function (its plain version here), AdamW
with float32 and int8 states, QAT's fake quantization of the stacked
tree, microbatching, checkpoints in both directions, the Trainer's
resume, the elastic mesh planner, the parameter and FLOP accounting and
the launcher.

Reduced qwen3 (``reduce_for_smoke``: 2 layers, d_model 128, 4 heads / 2
KV heads of 16, vocab 2,048), with 16-token attention chunks and 48-token
loss chunks so that both references walk several chunks and pad the
last; weights are the reference's ``init_params`` carried across by
``convert``.  Bounds:

  * float32 compute: the loss within 1e-5 relative, each gradient leaf
    within 1e-4 of its largest |value| (other summation orders);
  * bf16 compute: the loss within 2^-8 relative (bf16's unit roundoff),
    each gradient leaf within 8 x 2^-8 of its largest |value|: the two
    frameworks round activations to bf16 at different points (XLA rounds
    each elementwise op, torch's fused ops once), and a gradient sums
    products of such activations over the batch's tokens;
  * K6's CPU gradients (the plain version through autograd) against
    jax's gradient of the reference's chunked attention: 1e-5 of each
    gradient's largest |value|;
  * AdamW: ``_q8``/``_dq8`` bit-equal; the step's scalars (learning rate,
    bias corrections) within 1 ulp (H24: ``cos`` and ``pow`` are not
    correctly rounded); a step fed the reference's scalars bit-equal,
    parameters and moments, float32 and int8; ``global_norm`` within 1e-6
    relative (the port sums in float64);
  * fake quantization of the stacked tree (H23) bit-equal to the
    reference's under INT8, INT4, LightPE-1 and LightPE-2;
  * checkpoints: bit-equal in both directions.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.configs import reduce_for_smoke as ref_reduce
from repro.models import transformer as ref_tf
from repro.models.attention import flash_attention as ref_flash_attention
from repro.models.model import build_model as ref_build_model
from repro.quant.policy import QuantPolicy as RefQuantPolicy
from repro.quant.policy import fake_quant_params as ref_fake_quant_params
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro.train.fault_tolerance import ElasticMeshPlanner as RefPlanner

from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import (DataCursor, MarkovTokenStream,
                                        TokenStreamConfig, token_batches)
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, transformer
from repro_torch.quant import QuantPolicy
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts_lib
from repro_torch.train.fault_tolerance import ElasticMeshPlanner, StepFailure
from repro_torch.train.trainer import Trainer, TrainerConfig

SMOKE = dict(d_model=128, n_layers=2, vocab_size=2048, attn_chunk=16,
             loss_chunk_tokens=48)
BATCH, SEQ = 2, 40
KEY = jax.random.PRNGKey(0)
BF16_U = 2.0 ** -8


def _cfgs(dtype="float32"):
  ref = dataclasses.replace(ref_reduce(ref_get_config("qwen3-0.6b"), **SMOKE),
                            dtype=dtype)
  port = dataclasses.replace(
      reduce_for_smoke(get_config("qwen3-0.6b"), **SMOKE), dtype=dtype)
  return ref, port


def _np_tree(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
  """A nested dict's leaves by ``/``-joined path, as numpy float arrays."""
  out = {}
  for k, v in tree.items():
    path = f"{prefix}/{k}" if prefix else k
    if isinstance(v, dict):
      out.update(_flat(v, path))
    else:
      out[path] = (v.detach().float().numpy() if isinstance(v, torch.Tensor)
                   else np.asarray(v))
  return out


def _batch(seed=0, vocab=2048, b=BATCH, s=SEQ):
  rng = np.random.RandomState(seed)
  return {"tokens": rng.randint(0, vocab, (b, s)).astype(np.int32),
          "labels": rng.randint(0, vocab, (b, s)).astype(np.int32)}


def _torch_batch(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_params(cfg, ref_params, dtype=torch.float32, param_dtype="float32"):
  model = build_model(cfg, device="cpu")
  return model, model.from_state(
      convert.params_from_jax(cfg, ref_params, dtype=dtype),
      param_dtype=param_dtype)


def _grad_tree(cfg, params, loss):
  named = dict(params.named_parameters())
  grads = torch.autograd.grad(loss, list(named.values()))
  return transformer.stack_blocks(cfg, transformer.nest(dict(zip(named,
                                                                 grads))))


def _assert_leaves_close(got, want, tol):
  fg, fw = _flat(got), _flat(want)
  assert set(fg) == set(fw)
  for k in fw:
    scale = float(np.abs(fw[k]).max())
    err = float(np.abs(fg[k] - fw[k]).max())
    assert err <= tol * scale, (k, err, scale)


@pytest.fixture(scope="module")
def ref_params():
  rc, _ = _cfgs()
  return _np_tree(ref_tf.init_params(rc, KEY))


# ---------------------------------------------------------------------------
# the train forward, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype, remat", [("float32", True),
                                          ("float32", False),
                                          ("bfloat16", True)])
def test_train_loss_and_gradients_match_reference(ref_params, dtype, remat):
  rc, pc = _cfgs(dtype)
  batch = _batch()
  (want, want_m), want_g = jax.value_and_grad(
      lambda p: ref_tf.train_loss(p, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, rc,
                                  remat=remat), has_aux=True)(ref_params)
  model, params = _port_params(pc, ref_params)
  got, got_m = model.train_loss(params, _torch_batch(batch), remat=remat)
  loss_tol, grad_tol = ((1e-5, 1e-4) if dtype == "float32"
                        else (BF16_U, 8 * BF16_U))
  assert abs(float(got.detach()) - float(want)) <= \
      loss_tol * abs(float(want))
  assert float(got_m["tokens"]) == float(want_m["tokens"]) == BATCH * SEQ
  assert float(got_m["aux"]) == float(want_m["aux"]) == 0.0
  _assert_leaves_close(_grad_tree(pc, params, got), _np_tree(want_g),
                       grad_tol)


def test_every_trainable_leaf_gets_a_gradient(ref_params):
  """H21: attention's projections and qk-norms learn through K6's
  autograd function, not only ``wo`` and the layers outside attention."""
  _, pc = _cfgs()
  model, params = _port_params(pc, ref_params)
  loss, _ = model.train_loss(params, _torch_batch(_batch()))
  grads = _flat(_grad_tree(pc, params, loss))
  assert {"blocks/sub0/mix/wq", "blocks/sub0/mix/wkv",
          "blocks/sub0/mix/q_norm", "blocks/sub0/mix/k_norm"} <= set(grads)
  for name, g in grads.items():
    # each layer of a stacked leaf on its own
    assert all(np.abs(layer).max() > 0 for layer in
               (g if name.startswith("blocks") else [g])), name


@pytest.mark.parametrize("causal, window", [(True, 0), (True, 9),
                                            (False, 0)])
def test_attention_gradients_match_reference_chunked_attention(causal,
                                                               window):
  rng = np.random.RandomState(3)
  b, s, h, hkv, d = 2, 37, 4, 2, 16
  q, k, v = (rng.standard_normal(shape).astype(np.float32)
             for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
  dout = rng.standard_normal((b, s, h, d)).astype(np.float32)
  want_out, vjp = jax.vjp(
      lambda q, k, v: ref_flash_attention(q, k, v, causal=causal,
                                          window=window, chunk_q=16,
                                          chunk_k=16), q, k, v)
  want = vjp(jnp.asarray(dout))
  qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
  out = fa.flash_attention(qt, kt, vt, causal=causal, window=window)
  got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(dout))
  np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                             rtol=0, atol=1e-5 * np.abs(want_out).max())
  for g, w in zip(got, want):
    w = np.asarray(w)
    assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
  # the plain backward (the card's check of the backward kernel) from the
  # plain lse gives autograd's gradients
  lse = fa.flash_attention_lse_reference(qt.detach(), kt.detach(), causal,
                                         window)
  plain = fa.flash_attention_bwd_reference(
      qt.detach(), kt.detach(), vt.detach(), out.detach(),
      torch.from_numpy(dout), lse, causal, window)
  for g, p in zip(got, plain):
    assert float((g - p).abs().max()) <= 1e-5 * float(g.abs().max())


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _ulps(a, b) -> int:
  a, b = np.float32(a), np.float32(b)
  return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


@pytest.mark.parametrize("shape", [(3, 300), (256,), (2, 5, 513), (7,)])
def test_q8_codes_and_scales_are_the_reference_bits(shape):
  rng = np.random.RandomState(sum(shape))
  x = (rng.standard_normal(shape) * rng.uniform(1e-6, 10, shape[-1])
       ).astype(np.float32)
  x[..., :3] = 0.0
  codes, scale = opt_lib._q8(torch.from_numpy(x))
  want_codes, want_scale = ref_opt._q8(jnp.asarray(x))
  np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
  np.testing.assert_array_equal(scale.numpy(), np.asarray(want_scale))
  np.testing.assert_array_equal(
      opt_lib._dq8(codes, scale, shape).numpy(),
      np.asarray(ref_opt._dq8(want_codes, want_scale, shape)))


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_step_scalars_within_one_ulp_of_the_reference(schedule):
  cfg = opt_lib.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=40,
                            schedule=schedule)
  ref_cfg = ref_opt.AdamWConfig(**dataclasses.asdict(cfg))
  for step in range(1, 61):
    s = jnp.asarray(step, jnp.int32)
    assert _ulps(opt_lib.lr_at(cfg, step), ref_opt.lr_at(ref_cfg, s)) <= 1
    bc1, bc2 = opt_lib.bias_corrections(cfg, step)
    assert _ulps(bc1, 1.0 - ref_cfg.b1 ** s.astype(jnp.float32)) <= 1
    assert _ulps(bc2, 1.0 - ref_cfg.b2 ** s.astype(jnp.float32)) <= 1


def _adamw_case(quantize, seed=0):
  rng = np.random.RandomState(seed)
  # "d" is large enough that a float32 sqrt rounded the other way in
  # 0.7% of its results (torch's on the CPU) changes some parameters
  shapes = {"a": (4, 300), "b": (256,), "c": (3, 2, 70), "d": (64, 1000)}
  params = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}
  grads = {n: (rng.standard_normal(s) * 0.3).astype(np.float32)
           for n, s in shapes.items()}
  moments = [{n: (rng.standard_normal(s) * 0.01).astype(np.float32)
              for n, s in shapes.items()} for _ in range(2)]
  moments[1] = {n: m * m for n, m in moments[1].items()}
  cfg = opt_lib.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=9,
                            quantize_state=quantize, grad_clip=1.0)
  return cfg, params, grads, moments


@pytest.mark.parametrize("quantize", [False, True])
def test_adamw_step_fed_the_reference_scalars_is_bit_equal(quantize):
  cfg, params, grads, (m0, v0) = _adamw_case(quantize)
  ref_cfg = ref_opt.AdamWConfig(**dataclasses.asdict(cfg))
  step = 3
  if quantize:
    ref_m = {n: dict(zip(("codes", "scale"), ref_opt._q8(jnp.asarray(x))))
             for n, x in m0.items()}
    ref_v = {n: dict(zip(("codes", "scale"), ref_opt._q8(jnp.asarray(x))))
             for n, x in v0.items()}
  else:
    ref_m = {n: jnp.asarray(x) for n, x in m0.items()}
    ref_v = {n: jnp.asarray(x) for n, x in v0.items()}
  ref_state = {"step": jnp.asarray(step - 1, jnp.int32), "m": ref_m,
               "v": ref_v}
  jp = {n: jnp.asarray(x) for n, x in params.items()}
  jg = {n: jnp.asarray(x) for n, x in grads.items()}
  want_p, want_s, _ = ref_opt.adamw_update(ref_cfg, jp, jg, ref_state)
  # the reference's scalars, as its adamw_update computes them
  s = jnp.asarray(step, jnp.int32)
  lr = np.float32(ref_opt.lr_at(ref_cfg, s))
  gnorm = ref_opt.global_norm(jg)
  scale = jnp.minimum(1.0, ref_cfg.grad_clip / jnp.maximum(gnorm, 1e-12))
  bc1 = np.float32(1.0 - ref_cfg.b1 ** s.astype(jnp.float32))
  bc2 = np.float32(1.0 - ref_cfg.b2 ** s.astype(jnp.float32))

  def port_state(tree):
    return {n: ({k: torch.from_numpy(np.array(x)) for k, x in m.items()}
                if quantize else torch.from_numpy(np.array(m)))
            for n, m in tree.items()}
  m, v = port_state(ref_m), port_state(ref_v)
  for n, x in params.items():
    p = torch.from_numpy(x.copy())
    opt_lib.adamw_leaf_update(cfg, p, torch.from_numpy(grads[n]), m[n], v[n],
                              lr, torch.from_numpy(np.array(scale)),
                              bc1, bc2)
    np.testing.assert_array_equal(p.numpy(), np.asarray(want_p[n]))
  assert _flat({"m": m, "v": v}).keys() == _flat(
      {"m": want_s["m"], "v": want_s["v"]}).keys()
  for key, got in _flat({"m": m, "v": v}).items():
    np.testing.assert_array_equal(got, _flat(
        {"m": _np_tree(want_s["m"]), "v": _np_tree(want_s["v"])})[key])


@pytest.mark.parametrize("quantize", [False, True])
def test_adamw_update_tracks_the_reference(quantize):
  cfg, params, grads, _ = _adamw_case(quantize, seed=1)
  ref_cfg = ref_opt.AdamWConfig(**dataclasses.asdict(cfg))
  jp = {n: jnp.asarray(x) for n, x in params.items()}
  ref_state = ref_opt.adamw_init(ref_cfg, jp)
  tp = {n: torch.from_numpy(x.copy()) for n, x in params.items()}
  state = opt_lib.adamw_init(cfg, tp)
  for i in range(4):
    jg = {n: jnp.asarray(x * (i + 1)) for n, x in grads.items()}
    jp, ref_state, ref_m = ref_opt.adamw_update(ref_cfg, jp, jg, ref_state)
    _, state, m = opt_lib.adamw_update(
        cfg, tp, {n: torch.from_numpy(x * (i + 1)) for n, x in grads.items()},
        state)
    assert state["step"] == int(ref_state["step"]) == i + 1
    assert abs(float(m["grad_norm"]) - float(ref_m["grad_norm"])) <= \
        1e-6 * float(ref_m["grad_norm"])
    assert _ulps(m["lr"], ref_m["lr"]) <= 1
  for n in params:
    np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=0,
                               atol=1e-6)


def test_global_norm_matches_reference():
  rng = np.random.RandomState(2)
  leaves = [rng.standard_normal(s).astype(np.float32) * 3
            for s in ((100, 30), (7,), (2, 3, 4))]
  got = float(opt_lib.global_norm(torch.from_numpy(x) for x in leaves))
  want = float(ref_opt.global_norm([jnp.asarray(x) for x in leaves]))
  assert abs(got - want) <= 1e-6 * want
  assert float(opt_lib.global_norm([torch.full((4,), 100.0)])) == 200.0


# ---------------------------------------------------------------------------
# QAT and microbatching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pe_type", ["INT8", "INT4", "LightPE-1",
                                     "LightPE-2"])
def test_fake_quant_of_the_stacked_tree_is_the_reference_bits(ref_params,
                                                              pe_type):
  """H23: each output column's scale spans every layer, as the reference
  quantizes a ``blocks/sub{i}`` leaf stacked on ``n_blocks``."""
  rc, pc = _cfgs()
  model, params = _port_params(pc, ref_params)
  got = ts_lib.fake_quant_tree(model, transformer.param_tree(params),
                               QuantPolicy(pe_type=pe_type))
  want = ref_fake_quant_params(jax.tree_util.tree_map(jnp.asarray,
                                                      ref_params),
                               RefQuantPolicy(pe_type=pe_type))
  fg = _flat(transformer.stack_blocks(pc, got))
  fw = _flat(_np_tree(want))
  assert set(fg) == set(fw)
  for k in fw:
    np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
  # straight-through: the quantized leaves pass their gradient unchanged
  wq = got["layers"][1]["mix"]["wq"]
  (g,) = torch.autograd.grad(wq.sum(), [params.layers[1].mix.wq])
  assert torch.equal(g, torch.ones_like(g))


def test_qat_loss_and_gradients_match_reference(ref_params):
  rc, pc = _cfgs()
  batch = _batch(1)
  ref_tcfg = ref_ts.TrainConfig(quant=RefQuantPolicy(pe_type="LightPE-2"))
  ref_model = ref_build_model(rc)
  (want, _), want_g = jax.value_and_grad(
      lambda p: ref_ts.loss_fn(ref_model, ref_tcfg, p,
                               {k: jnp.asarray(v) for k, v in batch.items()}),
      has_aux=True)(ref_params)
  tcfg = ts_lib.TrainConfig(quant=QuantPolicy(pe_type="LightPE-2"))
  model, params = _port_params(pc, ref_params)
  got, _ = ts_lib.loss_fn(model, tcfg, transformer.param_tree(params),
                          _torch_batch(batch))
  assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
  _assert_leaves_close(_grad_tree(pc, params, got), _np_tree(want_g), 1e-4)


def _ref_and_port_states(tcfg_kw, quantize=False):
  rc, pc = _cfgs()
  opt_kw = dict(lr=1e-3, eps=1.0, weight_decay=0.0, warmup_steps=0,
                schedule="constant", quantize_state=quantize)
  ref_tcfg = ref_ts.TrainConfig(optimizer=ref_opt.AdamWConfig(**opt_kw),
                                **tcfg_kw)
  tcfg = ts_lib.TrainConfig(optimizer=opt_lib.AdamWConfig(**opt_kw),
                            **tcfg_kw)
  ref_model = ref_build_model(rc)
  ref_state = ref_ts.make_train_state(ref_model, ref_tcfg, KEY)
  model = build_model(pc, device="cpu")
  state = ts_lib.make_train_state(model, tcfg)
  convert.load_train_state(pc, _np_tree(ref_state), state)
  return rc, pc, ref_model, ref_tcfg, ref_state, model, tcfg, state


def test_microbatched_step_matches_reference():
  """Two microbatches accumulated in f32 and scaled by 1/2, then AdamW.
  ``eps`` = 1 makes the update smooth in the gradient (lr g / (|g| + 1)),
  so the parameters' move is held to the gradient's bound; with a tiny eps
  an element whose gradient is near 0 takes +-lr on the sign of noise
  (the checkpoint tests below share this optimizer)."""
  rc, pc, ref_model, ref_tcfg, ref_state, model, tcfg, state = \
      _ref_and_port_states(dict(microbatches=2))
  batch = _batch(2, b=4)
  before = _flat(_np_tree(ref_state["params"]))
  ref_new, ref_m = ref_ts.train_step(ref_model, ref_tcfg, ref_state,
                                     {k: jnp.asarray(v)
                                      for k, v in batch.items()})
  state, m = ts_lib.train_step(model, tcfg, state, _torch_batch(batch))
  assert abs(float(m["loss"]) - float(ref_m["loss"])) <= \
      1e-5 * float(ref_m["loss"])
  assert _ulps(m["lr"], ref_m["lr"]) <= 1
  assert state["opt"]["step"] == 1
  got = _flat(convert.train_state_to_tree(pc, state)["params"])
  want = _flat(_np_tree(ref_new["params"]))
  for k in want:
    # moves within 1e-4 of the largest, and a parameter may round to the
    # neighbour of the reference's when its move sits near a tie
    move = np.abs(want[k] - before[k]).max()
    assert np.all(np.abs(got[k] - want[k])
                  <= 1e-4 * move + np.spacing(np.abs(want[k]))), k


# ---------------------------------------------------------------------------
# checkpoints and the trainer
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_keeps_bits_and_dtypes(tmp_path):
  state = {"params": {"w": torch.arange(6.0).reshape(2, 3),
                      "h": torch.tensor([1.5, -2.25, 3e-3],
                                        dtype=torch.bfloat16)},
           "opt": {"step": np.asarray(7, np.int32),
                   "m": {"codes": torch.tensor([[-127, 0, 5]],
                                               dtype=torch.int8)}}}
  path = ckpt_lib.save_checkpoint(str(tmp_path), 7, state,
                                  extra={"data_step": 9})
  assert os.path.basename(path) == "ckpt_00000007.npz"
  step, restored, extra = ckpt_lib.restore_checkpoint(str(tmp_path))
  assert step == 7 and extra == {"data_step": 9}
  assert torch.equal(restored["params"]["h"], state["params"]["h"])
  np.testing.assert_array_equal(restored["params"]["w"],
                                np.arange(6.0).reshape(2, 3))
  np.testing.assert_array_equal(restored["opt"]["m"]["codes"],
                                [[-127, 0, 5]])
  assert int(restored["opt"]["step"]) == 7


def test_checkpoint_keeps_the_last_k(tmp_path):
  for s in range(6):
    ckpt_lib.save_checkpoint(str(tmp_path), s, {"w": np.zeros(2)}, keep=2)
  assert ckpt_lib.list_checkpoints(str(tmp_path)) == [4, 5]


def test_checkpoint_on_a_thread(tmp_path):
  ckpt_lib.save_checkpoint(str(tmp_path), 1, {"w": torch.ones(3)},
                           background=True)
  for thread in __import__("threading").enumerate():
    if thread.daemon and thread.is_alive() and thread.name != "MainThread":
      thread.join(timeout=30)
  assert ckpt_lib.list_checkpoints(str(tmp_path)) == [1]


def test_checkpoint_partial_write_ignored(tmp_path):
  ckpt_lib.save_checkpoint(str(tmp_path), 1, {"w": np.zeros(2)})
  # a crash mid-write leaves an .npz with no manifest: ignored
  (tmp_path / "ckpt_00000002.npz").write_bytes(b"x")
  assert ckpt_lib.list_checkpoints(str(tmp_path)) == [1]
  assert ckpt_lib.restore_checkpoint(str(tmp_path))[0] == 1


@pytest.mark.parametrize("quantize", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, quantize):
  rc, pc, ref_model, ref_tcfg, ref_state, model, tcfg, state = \
      _ref_and_port_states({}, quantize)
  ref_state, _ = ref_ts.train_step(ref_model, ref_tcfg, ref_state,
                                   {k: jnp.asarray(v)
                                    for k, v in _batch(3).items()})
  ref_ckpt.save_checkpoint(str(tmp_path), 1, ref_state,
                           extra={"data_step": 1})
  fresh = ts_lib.make_train_state(model, tcfg, seed=5)
  _, tree, _ = ckpt_lib.restore_checkpoint(str(tmp_path))
  convert.load_train_state(pc, tree, fresh)
  assert fresh["opt"]["step"] == 1
  got = _flat(convert.train_state_to_tree(pc, fresh))
  want = _flat(_np_tree(ref_state))
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("quantize", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path, quantize):
  rc, pc, ref_model, ref_tcfg, ref_state, model, tcfg, state = \
      _ref_and_port_states({}, quantize)
  state, _ = ts_lib.train_step(model, tcfg, state, _torch_batch(_batch(3)))
  ckpt_lib.save_checkpoint(str(tmp_path), 1,
                           convert.train_state_to_tree(pc, state))
  step, tree, _ = ref_ckpt.restore_checkpoint(str(tmp_path))
  assert step == 1
  restored = jax.tree_util.tree_map(jnp.asarray, tree)
  assert (jax.tree_util.tree_structure(restored)
          == jax.tree_util.tree_structure(ref_state))
  got = _flat(_np_tree(restored))
  want = _flat(convert.train_state_to_tree(pc, state))
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  # and the reference trains on from it
  _, m = ref_ts.train_step(ref_model, ref_tcfg, restored,
                           {k: jnp.asarray(v) for k, v in _batch(4).items()})
  assert np.isfinite(float(m["loss"]))


def test_reference_bf16_checkpoint_restores_in_the_port(tmp_path):
  """The reference writes bf16 leaves through ml_dtypes (numpy reads them
  as ``|V2``); the port restores their bits without ml_dtypes."""
  rc, pc = _cfgs()
  ref_tcfg = ref_ts.TrainConfig(param_dtype="bfloat16")
  ref_state = ref_ts.make_train_state(ref_build_model(rc), ref_tcfg, KEY)
  ref_ckpt.save_checkpoint(str(tmp_path), 0, ref_state)
  model = build_model(pc, device="cpu")
  state = ts_lib.make_train_state(
      model, ts_lib.TrainConfig(param_dtype="bfloat16"), seed=5)
  _, tree, _ = ckpt_lib.restore_checkpoint(str(tmp_path))
  convert.load_train_state(pc, tree, state)
  assert state["params"].embed.dtype == torch.bfloat16
  got = _flat(convert.train_state_to_tree(pc, state)["params"])
  want = _flat(_np_tree(jax.tree_util.tree_map(
      lambda x: x.astype(jnp.float32), ref_state["params"])))
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _trainer(cfg, ckpt_dir, **kw):
  stream = MarkovTokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size,
                                               branching=6))
  cursor = DataCursor()
  kw.setdefault("optimizer", opt_lib.AdamWConfig(lr=3e-3, warmup_steps=2,
                                                 total_steps=12))
  tcfg = ts_lib.TrainConfig(**kw)
  return Trainer(build_model(cfg, device="cpu"), tcfg,
                 TrainerConfig(ckpt_every=3, log_every=100,
                               ckpt_dir=str(ckpt_dir)),
                 token_batches(stream, 2, 24, cursor), cursor=cursor)


@pytest.mark.parametrize("quantize", [False, True])
def test_trainer_restart_resumes_bit_for_bit(tmp_path, quantize):
  _, pc = _cfgs()
  opt = dict(optimizer=opt_lib.AdamWConfig(lr=3e-3, warmup_steps=2,
                                           total_steps=12,
                                           quantize_state=quantize))
  whole = _trainer(pc, tmp_path / "whole", **opt)
  whole.run(12)
  first = _trainer(pc, tmp_path / "split", **opt)
  first.run(6)
  again = _trainer(pc, tmp_path / "split", **opt)
  assert again.maybe_restore()
  assert again.step == 6 and again.cursor.step == 6
  again.run(6)
  assert ([r["loss"] for r in again.history]
          == [r["loss"] for r in whole.history[6:]])
  for p, q in zip(again.state["params"].parameters(),
                  whole.state["params"].parameters()):
    assert torch.equal(p, q)


def test_a_step_that_failed_after_writing_is_not_retried(tmp_path,
                                                         monkeypatch):
  """H25: a failure before the first in-place write is retried from an
  untouched state; one after it raises at once."""
  _, pc = _cfgs()
  clean = _trainer(pc, tmp_path / "a")
  clean.run(2)
  flaky = _trainer(pc, tmp_path / "b")
  real_loss = flaky.model.train_loss
  fails = {"loss": 1}

  def loss_once_failing(*a, **kw):
    if fails["loss"]:
      fails["loss"] -= 1
      raise RuntimeError("transient")
    return real_loss(*a, **kw)
  monkeypatch.setattr(flaky.model, "train_loss", loss_once_failing)
  flaky.run(2)
  assert [r["loss"] for r in flaky.history] == \
      [r["loss"] for r in clean.history]

  real_leaf = opt_lib.adamw_leaf_update
  calls = {"n": 0}

  def leaf_failing_second(*a, **kw):
    calls["n"] += 1
    if calls["n"] == 2:
      raise RuntimeError("device fault")
    return real_leaf(*a, **kw)
  monkeypatch.setattr(opt_lib, "adamw_leaf_update", leaf_failing_second)
  with pytest.raises(opt_lib.PartialUpdateError):
    flaky.run(1)
  assert calls["n"] == 2 and flaky.step == 2
  monkeypatch.setattr(opt_lib, "adamw_leaf_update", real_leaf)
  monkeypatch.setattr(flaky.model, "train_loss",
                      lambda *a, **kw: (_ for _ in ()).throw(
                          RuntimeError("always")))
  with pytest.raises(StepFailure):
    flaky.run(1)


# ---------------------------------------------------------------------------
# the elastic mesh planner, accounting, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("devices", [208, 8, 256, 255, 17, 512, 4096])
@pytest.mark.parametrize("pods", [1, 2, 4])
def test_elastic_plans_match_reference(devices, pods):
  for mp, gb, bpd in ((16, 256, 16), (8, 96, 4), (1, 8, 8)):
    got = ElasticMeshPlanner(mp, gb, bpd).plan(devices, pods)
    want = RefPlanner(mp, gb, bpd).plan(devices, pods)
    if want is None:
      assert got is None
    else:
      assert dataclasses.astuple(got) == dataclasses.astuple(want)
      assert got.devices == want.devices


@pytest.mark.parametrize("arch", ref_list_archs())
def test_parameter_and_flop_accounting_match_reference(arch):
  ref = ref_get_config(arch)
  port = ModelConfig(**{f.name: getattr(ref, f.name)
                        for f in dataclasses.fields(ModelConfig)})
  assert port.param_count() == ref.param_count()
  assert port.param_count(active_only=True) == \
      ref.param_count(active_only=True)
  assert port.train_flops_per_token() == ref.train_flops_per_token()


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
  trainer = launch_train.main(["--device", "cpu", "--smoke", "--steps", "3",
                               "--ckpt-dir", str(tmp_path)])
  assert trainer.step == 3 and trainer.model.device.type == "cpu"
  assert trainer.model.cfg.n_layers == 4 and trainer.model.cfg.d_model == 128
  assert all(np.isfinite(r["loss"]) for r in trainer.history)
  assert "final loss" in capsys.readouterr().out
  tcfg = launch_train.recipe(200)
  assert (tcfg.optimizer.lr, tcfg.optimizer.warmup_steps,
          tcfg.optimizer.total_steps) == (3e-3, 20, 200)


@pytest.mark.parametrize("argv, match", [
    (["--model-parallel", "2"], "slice 7d"),
    (["--production-mesh"], "slice 7d"),
    (["--profile", "fsdp"], "slice 7d"),
    (["--arch", "olmo-1b"], "slice 8"),
])
def test_launcher_names_the_slice_of_what_it_lacks(argv, match):
  with pytest.raises(NotImplementedError, match=match):
    launch_train.main(["--device", "cpu", "--smoke", "--steps", "1", *argv])


def test_training_entry_points_default_to_cuda(monkeypatch, tmp_path):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    launch_train.main(["--smoke", "--steps", "1", "--ckpt-dir",
                       str(tmp_path)])
  _, pc = _cfgs()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    ts_lib.make_train_state(build_model(pc), ts_lib.TrainConfig())
