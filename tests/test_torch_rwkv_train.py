"""rwkv6 training in the port on the CPU, held to the reference (``repro``)
on the same inputs: the plain chunked backward of the WKV6 recurrence
(``ref.wkv6_chunked_bwd``, the algorithm K7's backward kernel runs),
``ops.wkv6``'s dispatch and gradient, the train loss and every gradient
of a reduced rwkv6, QAT's fake quantization of its stacked tree,
microbatching, checkpoints in both directions, the Trainer's resume and
the launcher; and a model trained, checkpointed, restored and served,
for qwen3 and rwkv6.

Inputs are made with numpy from a seed.  The reduced rwkv6 is
``reduce_for_smoke`` (2 layers, d_model 64, 4 heads of 16, d_ff 128,
vocab 512) with 48-token loss chunks and its 16-token WKV chunks, so
that a 40-token batch walks three chunks and pads the last; its weights
are the reference's ``init_params`` carried across by ``convert``, with
every constant leaf (the lerps, the group norm and the layer norms)
perturbed so that its gradient is exercised.  Bounds, each with its
reason:

  * the plain backward against autograd of the plain forward in float64:
    1e-10 of each gradient's largest |value| (the same function, no
    rounding to speak of);
  * in float32, against autograd of ``ref.wkv6_chunked`` and against
    ``jax.vjp`` of the reference's ``wkv6_chunked``: dr, dk, dv, du and
    ds0 within 1e-4 of each one's largest |value| (K7's bound: float32
    sums in other orders, and with w near the floor exponents near -70,
    whose rounding grows with them; each side is within 1e-5 of the
    float64 plain backward); dw, whose d log w = w dw sums down a chunk
    terms that cancel, within 1e-5 of ``dlogw_scale`` (the size of
    those terms) over w;
  * the model's loss and gradients in float32: the bounds
    ``tests/test_torch_train.py`` holds qwen3 to (loss 1e-5, each leaf
    within 1e-4 of its largest |value|);
  * with bf16 compute, the loss within 2^-8 and each gradient leaf within
    8 x 2^-8 of its largest |value| (qwen3's bounds), against the
    reference compiled with ``xla_allow_excess_precision`` off.  By
    default XLA may drop a bf16 rounding that is followed by a cast back
    to float32 (a residual sum entering a norm, say), so the compiled
    reference does not round where its source does; the port rounds every
    bf16 value, as the source and JAX's op-by-op evaluation do.  On the
    first batch here the default-compiled reference is 0.22 of a leaf's
    largest |value| from the same reference run op by op, since one
    head's first-token bonus term r_0 . (u k_0) is 0.0019, near the group
    norm's eps, and the norm amplifies every rounding upstream of it;
    with the flag off the two agree within 0.0134, and the port is
    within 0.0111 of it;
  * fake quantization of the stacked tree bit-equal; checkpoints
    bit-equal in both directions; a resumed run bit-identical.
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
from repro.quant.policy import QuantPolicy as RefQuantPolicy
from repro.quant.policy import fake_quant_params as ref_fake_quant_params
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts

from repro_torch import _build, convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.synthetic import (DataCursor, MarkovTokenStream,
                                        TokenStreamConfig, token_batches)
from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_scan import ops as wkv
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, transformer
from repro_torch.quant import QuantPolicy
from repro_torch.serve import EngineConfig, ServeEngine
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts_lib
from repro_torch.train.trainer import Trainer, TrainerConfig
from wkv_bwd_split import wkv6_bwd_split
from wkv_grad_scale import dlogw_scale

ARCH = "rwkv6-1.6b"
SMOKE = dict(loss_chunk_tokens=48)
BATCH, SEQ = 2, 40
KEY = jax.random.PRNGKey(0)
BF16_U = 2.0 ** -8
# leaves the reference initializes to constants (ones, zeros, 0.5)
CONSTANT_LEAVES = ("mix", "cmix", "ln_x", "scale", "bias")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
  """One intra-op thread for this file: its many small ops ran 50-80x
  slower (a 1 s launcher test took 86 s) with torch's pool spinning on
  cores that the suite's parallel workers oversubscribe."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the plain chunked backward
# ---------------------------------------------------------------------------

def _wkv_inputs(seed, b, h, t, d, tiny_w=False, dtype=np.float32,
                chunk=16):
  """r/k/v/w (B, H, T, D), u (H, D), s0, dO and the final state's gradient
  as numpy arrays.  w is exp(-exp(N(0, 1) - 1)), the model's form; with
  ``tiny_w`` it is near 1 (0.95 to 1) with, in each chunk and channel,
  one token at most near the floor (2e-30 to 1e-29, or 1e-30
  itself): a chunk's decays then stay above e^-88, so that the reference's
  gradient, whose masked pairs take exp of a positive exponent, stays
  finite."""
  rng = np.random.RandomState(seed)

  def normal(*shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(dtype)
  r, k, v = normal(b, h, t, d, scale=0.5), normal(b, h, t, d, scale=0.5), \
      normal(b, h, t, d)
  w = np.exp(-np.exp(rng.standard_normal((b, h, t, d)) - 1.0)).astype(dtype)
  if tiny_w:
    w = rng.uniform(0.95, 1.0, (b, h, t, d)).astype(dtype)
    for c in range(0, t, chunk):
      rows = rng.randint(c, min(c + chunk, t), (b, h, d))
      pick = rng.uniform(size=(b, h, d))
      tiny = np.where(pick < 0.3, np.float32(1e-30),
                      rng.uniform(2e-30, 1e-29, (b, h, d))).astype(dtype)
      keep = pick < 0.6
      bi, hi, di = np.nonzero(keep)
      w[bi, hi, rows[keep], di] = tiny[keep]
  return dict(r=r, k=k, v=v, w=w, u=normal(h, d, scale=0.3),
              s0=normal(b, h, d, d, scale=0.1), dout=normal(b, h, t, d),
              ds=normal(b, h, d, d, scale=0.1))


def _torch(arrays):
  return {n: torch.from_numpy(a) for n, a in arrays.items()}


def _autograd(x, chunk, with_ds=True):
  leaves = [x[n].clone().requires_grad_() for n in ("r", "k", "v", "w", "u",
                                                    "s0")]
  out, s_final = wkv_ref.wkv6_chunked(*leaves, chunk)
  return torch.autograd.grad((out, s_final), leaves,
                             (x["dout"], x["ds"] if with_ds
                              else torch.zeros_like(s_final)))


def _plain_bwd(x, chunk, with_ds=True):
  return wkv_ref.wkv6_chunked_bwd(x["r"], x["k"], x["v"], x["w"], x["u"],
                                  x["s0"], x["dout"],
                                  x["ds"] if with_ds else None, chunk)


def _assert_grads_close(got, want, x, chunk, tol, dw_tol):
  for name, g, wt in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
    g, wt = torch.as_tensor(np.array(g)).double(), \
        torch.as_tensor(np.array(wt)).double()
    assert g.shape == wt.shape, name
    assert bool(torch.isfinite(g).all()), name
    if name != "dw":
      err = float((g - wt).abs().max())
      assert err <= tol * float(wt.abs().max()), (name, err)
  scale = dlogw_scale(
      *(torch.as_tensor(np.array(x[n])) for n in ("r", "k", "v", "u",
                                                    "dout")),
      torch.as_tensor(np.array(want[0])), torch.as_tensor(np.array(
          want[1])), chunk).double()
  w = torch.as_tensor(np.array(x["w"])).double()
  dw_got = torch.as_tensor(np.array(got[3])).double()
  dw_want = torch.as_tensor(np.array(want[3])).double()
  ratio = float(((dw_got - dw_want).abs() * w / scale).max())
  assert ratio <= dw_tol, ratio


# (b, h, t, d, chunk): T ragged and a chunk multiple, chunks 16 and 64, D
# 16, 32 and 64
BWD_CASES = [(2, 3, 40, 16, 16), (1, 2, 64, 32, 64), (1, 2, 100, 64, 64),
             (2, 2, 48, 16, 16), (1, 3, 130, 32, 64), (1, 1, 1, 16, 16)]


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_plain_backward_is_autograd_in_float64(case):
  b, h, t, d, chunk = case
  x = _torch(_wkv_inputs(t + d, b, h, t, d, dtype=np.float64))
  _assert_grads_close(_plain_bwd(x, chunk), _autograd(x, chunk), x, chunk,
                      1e-10, 1e-10)


@pytest.mark.parametrize("tiny_w", [False, True])
@pytest.mark.parametrize("with_ds", [False, True])
@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_plain_backward_matches_autograd_in_float32(case, with_ds, tiny_w):
  b, h, t, d, chunk = case
  x = _torch(_wkv_inputs(t + d + 1, b, h, t, d, tiny_w, chunk=chunk))
  _assert_grads_close(_plain_bwd(x, chunk, with_ds),
                      _autograd(x, chunk, with_ds), x, chunk, 1e-4, 1e-5)


@pytest.mark.parametrize("tiny_w", [False, True])
@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_plain_backward_matches_the_reference_vjp(case, tiny_w):
  """Against ``jax.vjp`` of ``repro.models.ssm.wkv6_chunked``; with
  ``tiny_w`` some w are exactly the floor 1e-30, where both take half the
  gradient (``jnp.maximum``'s, ``torch.maximum``'s)."""
  b, h, t, d, chunk = case
  x = _wkv_inputs(t + d + 2, b, h, t, d, tiny_w, chunk=chunk)
  _, vjp = jax.vjp(lambda r, k, v, w, u, s0: ref_ssm.wkv6_chunked(
      r, k, v, w, u, s0, chunk), *(jnp.asarray(x[n]) for n in
                                   ("r", "k", "v", "w", "u", "s0")))
  want = [np.asarray(g) for g in vjp((jnp.asarray(x["dout"]),
                                      jnp.asarray(x["ds"])))]
  got = _plain_bwd(_torch(x), chunk)
  _assert_grads_close(got, want, x, chunk, 1e-4, 1e-5)


# (b, h, t, d, chunk): the kernel pads a chunk to 16, 32 or 64 rows and
# cuts it into 16-row sub-chunks; chunks 20 and 48 leave pad rows in a
# sub-chunk
SPLIT_CASES = BWD_CASES + [(1, 2, 70, 16, 20), (1, 2, 150, 16, 48)]


@pytest.mark.parametrize("tiny_w", [False, True])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_the_backward_kernels_schedule_keeps_the_function(case, tiny_w):
  """``wkv6_bwd_split``, the backward kernel's three launches (local
  sums, the folds across chunks, each chunk's gradients from S_c and dS_c
  with the plane factored by sub-chunks of the kernel's kPart rows) in
  plain torch, against the plain backward in float64: 1e-10 of each
  gradient's largest |value| (the same function; every exponent <= 0, so
  w at the floor gives no inf or nan)."""
  b, h, t, d, chunk = case
  part = _build.csrc_constant("rwkv6_scan", "kPart")
  x = _torch(_wkv_inputs(t + d + 3, b, h, t, d, tiny_w, dtype=np.float64,
                         chunk=chunk))
  args = [x[n] for n in ("r", "k", "v", "w", "u", "s0", "dout", "ds")]
  got = wkv6_bwd_split(*args, chunk, part)
  _assert_grads_close(got, _plain_bwd(x, chunk), x, chunk, 1e-10, 1e-10)


@pytest.mark.parametrize("b,h,t,d,chunk,nc", [
    (8, 32, 512, 64, 64, 8), (2, 4, 300, 64, 64, 5), (1, 2, 1, 16, 16, 1),
    (2, 3, 100, 32, 20, 5), (1, 1, 0, 64, 64, 0)])
def test_the_backward_kernels_scratch(b, h, t, d, chunk, nc):
  """The host's scratch for the backward's launches: per (batch, head)
  and chunk two D x D and two D floats (none without a chunk)."""
  assert wkv_kernel.bwd_scratch_floats(b, h, t, d, chunk) == \
      b * h * nc * (2 * d * d + 2 * d)


def test_the_floor_takes_half_the_gradient():
  w = torch.tensor([1e-30, 2e-30, 5e-31], requires_grad=True)
  (g,) = torch.autograd.grad(wkv_ref._log_w(w).sum(), [w])
  want = jax.grad(lambda x: jnp.sum(jnp.log(jnp.maximum(x, 1e-30))))(
      jnp.asarray(w.detach().numpy()))
  np.testing.assert_array_equal(g.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# ops.wkv6's dispatch on the CPU
# ---------------------------------------------------------------------------

def test_a_cpu_tensor_never_reaches_a_kernel(monkeypatch):
  def refuse(*a, **kw):
    raise AssertionError("a CPU tensor reached a kernel")
  monkeypatch.setattr(wkv_kernel, "wkv6", refuse)
  monkeypatch.setattr(wkv_kernel, "wkv6_bwd", refuse)
  monkeypatch.setattr(wkv.WKV6, "apply", refuse)
  x = _torch(_wkv_inputs(3, 1, 2, 20, 16))
  leaves = [x[n].requires_grad_() for n in ("r", "k", "v", "w", "u", "s0")]
  out, s_final = wkv.wkv6(*leaves, chunk=16)
  got = torch.autograd.grad((out, s_final), leaves, (x["dout"], x["ds"]))
  want = wkv.wkv6_bwd_reference(*(t.detach() for t in leaves), x["dout"],
                                x["ds"], chunk=16)
  _assert_grads_close(got, want, {n: t.detach() for n, t in x.items()},
                      16, 1e-4, 1e-5)
  with torch.no_grad():
    wkv.wkv6(*leaves, chunk=16)
  assert wkv_kernel.LAUNCHES == {"wkv6": 0, "wkv6_bwd": 0}


def test_gradcheck_of_the_plain_path_in_float64():
  x = _torch(_wkv_inputs(5, 1, 2, 7, 3, dtype=np.float64))
  leaves = tuple(x[n].requires_grad_() for n in ("r", "k", "v", "w", "u",
                                                  "s0"))
  assert torch.autograd.gradcheck(lambda *a: wkv.wkv6(*a, chunk=4), leaves)


def test_a_cuda_input_takes_the_kernels_in_every_case():
  """The CUDA branches of the dispatch: with a gradient asked for, WKV6;
  without, the forward kernel; both are the kernels' own wrappers, which
  refuse a CPU tensor."""
  x = _torch(_wkv_inputs(3, 1, 2, 20, 16))
  with pytest.raises(ValueError, match="expected a CUDA tensor"):
    wkv_kernel.wkv6_bwd(x["r"], x["k"], x["v"], x["w"], x["u"], x["s0"],
                        x["dout"])
  assert wkv._needs_grad(x["r"].requires_grad_(), None)
  with torch.no_grad():
    assert not wkv._needs_grad(x["r"])


# ---------------------------------------------------------------------------
# the model: loss, gradients, QAT, microbatching
# ---------------------------------------------------------------------------

def _cfgs(dtype="float32"):
  ref = dataclasses.replace(ref_reduce(ref_get_config(ARCH), **SMOKE),
                            dtype=dtype)
  port = dataclasses.replace(reduce_for_smoke(get_config(ARCH), **SMOKE),
                             dtype=dtype)
  return ref, port


def _np_tree(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(tree, seed=11):
  rng = np.random.RandomState(seed)

  def leaf(path, a):
    a = np.asarray(a)
    if getattr(path[-1], "key", "") in CONSTANT_LEAVES:
      a = a + rng.uniform(-0.3, 0.3, a.shape).astype(a.dtype)
    return a
  return jax.tree_util.tree_map_with_path(leaf, tree)


def _flat(tree, prefix=""):
  out = {}
  for k, v in tree.items():
    path = f"{prefix}/{k}" if prefix else k
    if isinstance(v, dict):
      out.update(_flat(v, path))
    else:
      out[path] = (v.detach().float().numpy() if isinstance(v, torch.Tensor)
                   else np.asarray(v))
  return out


def _batch(seed=0, vocab=512, b=BATCH, s=SEQ):
  rng = np.random.RandomState(seed)
  return {"tokens": rng.randint(0, vocab, (b, s)).astype(np.int32),
          "labels": rng.randint(0, vocab, (b, s)).astype(np.int32)}


def _torch_batch(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jnp_batch(batch):
  return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_params(cfg, ref_params, param_dtype="float32"):
  model = build_model(cfg, device="cpu")
  return model, model.from_state(
      convert.params_from_jax(cfg, ref_params, dtype=torch.float32),
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
  return _perturbed(ref_tf.init_params(rc, KEY))


def _ref_value_and_grad(ref_params, batch, cfg, remat):
  """The reference's loss, metrics and gradients, compiled so that every
  bf16 value its source rounds is rounded (see the module docstring)."""
  fn = jax.value_and_grad(
      lambda p: ref_tf.train_loss(p, _jnp_batch(batch), cfg, remat=remat),
      has_aux=True)
  params = jax.tree_util.tree_map(jnp.asarray, ref_params)
  (loss, metrics), grads = jax.jit(fn).lower(params).compile(
      compiler_options={"xla_allow_excess_precision": False})(params)
  return loss, metrics, _np_tree(grads)


@pytest.mark.parametrize("dtype, remat", [("float32", True),
                                          ("float32", False),
                                          ("bfloat16", True),
                                          ("bfloat16", False)])
def test_train_loss_and_gradients_match_reference(ref_params, dtype, remat):
  rc, pc = _cfgs(dtype)
  batch = _batch()
  want, want_m, want_g = _ref_value_and_grad(ref_params, batch, rc, remat)
  model, params = _port_params(pc, ref_params)
  got, got_m = model.train_loss(params, _torch_batch(batch), remat=remat)
  loss_tol, grad_tol = ((1e-5, 1e-4) if dtype == "float32"
                        else (BF16_U, 8 * BF16_U))
  assert abs(float(got.detach()) - float(want)) <= \
      loss_tol * abs(float(want))
  assert float(got_m["tokens"]) == float(want_m["tokens"]) == BATCH * SEQ
  assert float(got_m["aux"]) == float(want_m["aux"]) == 0.0
  _assert_leaves_close(_grad_tree(pc, params, got), want_g, grad_tol)


def test_every_trainable_leaf_gets_a_gradient(ref_params):
  """The time mix's projections, decay LoRA, bonus u and group norm learn
  through K7's gradient, each layer of each stacked leaf."""
  _, pc = _cfgs()
  model, params = _port_params(pc, ref_params)
  loss, _ = model.train_loss(params, _torch_batch(_batch()))
  grads = _flat(_grad_tree(pc, params, loss))
  assert {f"blocks/sub0/mix/{n}" for n in ("wr", "wk", "wv", "wg", "w0",
                                           "w_lora_a", "w_lora_b", "u",
                                           "ln_x", "mix")} <= set(grads)
  for name, g in grads.items():
    assert all(np.abs(layer).max() > 0 for layer in
               (g if name.startswith("blocks") else [g])), name


def test_trainable_leaves_keep_the_float32_ones(ref_params):
  """Under bf16 parameters the matmul weights, embedding and head are bf16
  and rwkv's lerps, decay base, bonus, group norm and the norms float32."""
  _, pc = _cfgs()
  _, params = _port_params(pc, ref_params, param_dtype="bfloat16")
  for name, p in params.named_parameters():
    assert p.requires_grad, name
    f32 = name.split(".")[-1] in ("mix", "w0", "u", "ln_x", "cmix", "scale",
                                  "bias")
    assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name


@pytest.mark.parametrize("pe_type", ["INT8", "INT4", "LightPE-1",
                                     "LightPE-2"])
def test_fake_quant_of_the_stacked_tree_is_the_reference_bits(ref_params,
                                                              pe_type):
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


def test_qat_loss_and_gradients_match_reference(ref_params):
  rc, pc = _cfgs()
  batch = _batch(1)
  ref_tcfg = ref_ts.TrainConfig(quant=RefQuantPolicy(pe_type="LightPE-2"))
  ref_model = ref_build_model(rc)
  (want, _), want_g = jax.value_and_grad(
      lambda p: ref_ts.loss_fn(ref_model, ref_tcfg, p, _jnp_batch(batch)),
      has_aux=True)(jax.tree_util.tree_map(jnp.asarray, ref_params))
  tcfg = ts_lib.TrainConfig(quant=QuantPolicy(pe_type="LightPE-2"))
  model, params = _port_params(pc, ref_params)
  got, _ = ts_lib.loss_fn(model, tcfg, transformer.param_tree(params),
                          _torch_batch(batch))
  assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
  _assert_leaves_close(_grad_tree(pc, params, got), _np_tree(want_g), 1e-4)


def _ref_and_port_states(tcfg_kw, quantize=False, param_dtype="float32"):
  rc, pc = _cfgs()
  opt_kw = dict(lr=1e-3, eps=1.0, weight_decay=0.0, warmup_steps=0,
                schedule="constant", quantize_state=quantize)
  ref_tcfg = ref_ts.TrainConfig(optimizer=ref_opt.AdamWConfig(**opt_kw),
                                param_dtype=param_dtype, **tcfg_kw)
  tcfg = ts_lib.TrainConfig(optimizer=opt_lib.AdamWConfig(**opt_kw),
                            param_dtype=param_dtype, **tcfg_kw)
  ref_model = ref_build_model(rc)
  ref_state = ref_ts.make_train_state(ref_model, ref_tcfg, KEY)
  model = build_model(pc, device="cpu")
  state = ts_lib.make_train_state(model, tcfg, seed=5)
  convert.load_train_state(pc, _np_tree(ref_state), state)
  return rc, pc, ref_model, ref_tcfg, ref_state, model, tcfg, state


def _ulps(a, b) -> int:
  return abs(int(np.float32(float(a)).view(np.int32))
             - int(np.float32(float(b)).view(np.int32)))


def test_microbatched_step_matches_reference():
  """Two microbatches accumulated in f32 and scaled by 1/2, then AdamW
  with eps 1 (``tests/test_torch_train.py`` says why)."""
  rc, pc, ref_model, ref_tcfg, ref_state, model, tcfg, state = \
      _ref_and_port_states(dict(microbatches=2))
  batch = _batch(2, b=4)
  before = _flat(_np_tree(ref_state["params"]))
  ref_new, ref_m = ref_ts.train_step(ref_model, ref_tcfg, ref_state,
                                     _jnp_batch(batch))
  state, m = ts_lib.train_step(model, tcfg, state, _torch_batch(batch))
  assert abs(float(m["loss"]) - float(ref_m["loss"])) <= \
      1e-5 * float(ref_m["loss"])
  assert _ulps(m["lr"], ref_m["lr"]) <= 1
  assert state["opt"]["step"] == 1
  got = _flat(convert.train_state_to_tree(pc, state)["params"])
  want = _flat(_np_tree(ref_new["params"]))
  assert set(got) == set(want)
  for k in want:
    move = np.abs(want[k] - before[k]).max()
    assert np.all(np.abs(got[k] - want[k])
                  <= 1e-4 * move + np.spacing(np.abs(want[k]))), k


# ---------------------------------------------------------------------------
# checkpoints, the trainer, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, quantize):
  rc, pc, ref_model, ref_tcfg, ref_state, model, tcfg, state = \
      _ref_and_port_states({}, quantize)
  ref_state, _ = ref_ts.train_step(ref_model, ref_tcfg, ref_state,
                                   _jnp_batch(_batch(3)))
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
  _, m = ref_ts.train_step(ref_model, ref_tcfg, restored,
                           _jnp_batch(_batch(4)))
  assert np.isfinite(float(m["loss"]))


def test_reference_bf16_checkpoint_restores_in_the_port(tmp_path):
  """The reference's bf16 state (its 2-D leaves in bf16, the lerps, u and
  ln_x among them) restores into the port's bf16 one, each value exact."""
  rc, pc = _cfgs()
  ref_state = ref_ts.make_train_state(
      ref_build_model(rc), ref_ts.TrainConfig(param_dtype="bfloat16"), KEY)
  ref_ckpt.save_checkpoint(str(tmp_path), 0, ref_state)
  state = ts_lib.make_train_state(
      build_model(pc, device="cpu"),
      ts_lib.TrainConfig(param_dtype="bfloat16"), seed=5)
  _, tree, _ = ckpt_lib.restore_checkpoint(str(tmp_path))
  convert.load_train_state(pc, tree, state)
  got = _flat(convert.train_state_to_tree(pc, state)["params"])
  want = _flat(_np_tree(jax.tree_util.tree_map(
      lambda x: x.astype(jnp.float32), ref_state["params"])))
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _trainer(cfg, ckpt_dir, **kw):
  stream = MarkovTokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size,
                                               branching=6))
  cursor = DataCursor()
  kw.setdefault("optimizer", opt_lib.AdamWConfig(lr=3e-3, warmup_steps=2,
                                                 total_steps=12))
  return Trainer(build_model(cfg, device="cpu"), ts_lib.TrainConfig(**kw),
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


def test_launcher_trains_rwkv6_on_the_cpu(tmp_path, capsys):
  trainer = launch_train.main(["--device", "cpu", "--smoke", "--arch", ARCH,
                               "--steps", "3", "--ckpt-dir", str(tmp_path)])
  cfg = trainer.model.cfg
  assert trainer.step == 3 and trainer.model.device.type == "cpu"
  assert cfg.name == ARCH and cfg.head_dim in wkv_kernel.HEAD_DIMS
  assert all(np.isfinite(r["loss"]) for r in trainer.history)
  assert "final loss" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# train, checkpoint, restore, serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", ARCH])
def test_train_then_serve(tmp_path, arch):
  """A reduced model (bf16 compute, float32 master weights) trains with the
  Trainer until its loss falls, checkpoints, and the checkpoint is
  restored as a serving model: its float32 leaves (norms, rwkv's lerps,
  decay base, bonus and group norm) arrive as the checkpoint's float32
  values, and ServeEngine's greedy tokens equal a prefill and decode of
  the restored weights."""
  cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                            dtype="bfloat16")
  stream = MarkovTokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size,
                                               branching=4))
  cursor = DataCursor()
  tcfg = ts_lib.TrainConfig(optimizer=opt_lib.AdamWConfig(
      lr=3e-3, warmup_steps=0, schedule="constant", weight_decay=0.0))
  trainer = Trainer(build_model(cfg, device="cpu"), tcfg,
                    TrainerConfig(total_steps=20, ckpt_every=20,
                                  log_every=100, ckpt_dir=str(tmp_path)),
                    token_batches(stream, 8, 48, cursor), cursor=cursor)
  hist = trainer.run(20)
  assert hist[-1]["loss"] < hist[0]["loss"]

  step, restored, _ = ckpt_lib.restore_checkpoint(str(tmp_path))
  assert step == 20
  model = build_model(cfg, device="cpu")
  params = model.from_state(convert.params_from_jax(cfg, restored["params"]))
  trained = dict(trainer.state["params"].named_parameters())
  for name, p in params.named_parameters():
    if p.dtype == torch.float32:
      assert torch.equal(p, trained[name].detach()), name
    else:
      assert p.dtype == torch.bfloat16
      assert torch.equal(p, trained[name].detach().bfloat16()), name
  ecfg = EngineConfig(batch_slots=2, max_len=64, prompt_bucket=16)
  prompts = [np.arange(10) % cfg.vocab_size,
             np.arange(3, 19) % cfg.vocab_size]
  engine = ServeEngine(model, params, ecfg, device="cpu")
  for prompt in prompts:
    engine.submit(prompt, max_new_tokens=5)
  served = engine.run_until_drained()
  for uid, prompt in enumerate(prompts, start=1):
    padded = np.concatenate([np.full(ecfg.prompt_bucket - len(prompt),
                                     prompt[0]), prompt]).astype(np.int32)
    logits, cache = model.prefill(params, torch.from_numpy(padded[None]),
                                  ecfg.max_len)
    want = [int(torch.argmax(logits[0]))]
    while len(want) < 5:
      logits, cache = model.decode_step(
          params, torch.tensor([want[-1]], dtype=torch.int32), cache)
      want.append(int(torch.argmax(logits[0])))
    assert served[uid] == want, (uid, served[uid], want)
