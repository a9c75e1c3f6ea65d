"""The port's QAT CNNs, SGD and weight-sharing supernet against the JAX
package on the CPU, from the reference's own initial parameters carried
across by ``convert.cnn_params_from_jax`` (the port's inits draw other
bits).

Bounds, fixed before these tests first ran (``max|d|`` is the largest
absolute difference, relative to the largest |value| of the reference's
tensor; a loss is relative to itself):

* ``conv2d``: bit-equal at the ResNet's strided shapes, where SAME pads
  0 before and 1 after (H17); at the other sizes 1e-6 (f32 sums in
  another order).  ``maxpool`` bit-equal; ``batch_norm`` 1e-5.
* weight and activation fake quantization from identical inputs:
  bit-equal; one quantized conv from identical inputs: 1e-5.
* whole networks (resnet20 at width 8, 16 px, batch 16; the VGG
  supernet under a masked arch, 8 px, batch 8), per PE type (H20: a conv
  output that differs in its last bit can move a per-tensor activation
  scale, and an activation near a rounding boundary then takes the next
  code):
    FP32       logits 1e-4, loss 1e-5, each gradient leaf 1e-4 (first
               1e-3; tightened below TF32's unit roundoff, 4.9e-4, so
               that a backward leaking TF32 on the card breaks it);
    INT16      logits 1e-3, loss 1e-4 (a flipped 16-bit code moves an
               activation by 1/32767 of its absmax);
    LightPE-*  logits 2e-2, loss 2e-3 (a flipped 8-bit code moves it by
               1/127, 0.8%; the bound admits a few such flips reaching a
               logit, where a wiring or padding fault moves logits by
               O(1)).
  The VGG's 8-bit logits first exceeded these (LightPE-1: 4.1e-2), and
  the reference moves its own by up to 5.3e-2 when its weights move by
  one ulp, so a quantized type's bounds are the larger of the numbers
  above and twice the reference's own largest move under three such
  jitters.  Its gradients are no measure there either (the reference's
  own leaves move by up to 7% under INT16 and 42% under LightPE-1: a
  flipped code in a sum that batch norm has nearly cancelled), so they
  are held layer by layer from identical inputs: a quantized conv's
  output and its input and weight gradients (through the
  straight-through estimator) within 1e-5; and the quantizers must see
  the reference's tensors, call by call (shapes, channel axes, and the
  first call's values bit for bit).
* ``sgd_lr_at`` equal in float32; ``sgd_update`` bit-equal from the same
  parameters, gradients and momenta.
* three steps of ``benchmarks/accuracy_experiments.py``'s QAT loop: each
  step's loss within the loss bound of its PE type, times 10 for the
  parameters' drift.
* the supernet (batch 8, image size 8): training losses 1e-4; the
  sampled architectures equal; accuracies on 64 validation images within
  2/64 (an argmax near a tie may flip).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cnn as ref_cnn
from repro.core.supernet import Supernet as RefSupernet
from repro.core.supernet import SupernetConfig as RefSupernetConfig
from repro.data.synthetic import CifarLike as RefCifarLike
from repro.data.synthetic import CifarLikeConfig as RefCifarLikeConfig
from repro.train import optimizer as ref_opt

from repro_torch import convert
from repro_torch.core import cnn, prng
from repro_torch.core.supernet import Supernet, SupernetConfig
from repro_torch.data import CifarLike, CifarLikeConfig
from repro_torch.train import optimizer as opt
from repro_torch.train import qat

PE_TYPES = ("FP32", "INT16", "LightPE-1", "LightPE-2")
BOUNDS = {"FP32": dict(logits=1e-4, loss=1e-5, grads=1e-4),
          "INT16": dict(logits=1e-3, loss=1e-4),
          "LightPE-1": dict(logits=2e-2, loss=2e-3),
          "LightPE-2": dict(logits=2e-2, loss=2e-3)}
IMAGE = 16
BATCH = 16
VGG_IMAGE = 8
VGG_BATCH = 8
MASKED = (cnn.ArchChoice(((1, 40), (2, 96), (1, 224), (3, 320), (2, 448))),
          cnn.ArchChoice(((2, 56), (1, 128), (3, 160), (1, 512), (1, 384))))


def rel_err(got, want) -> float:
  got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor)
                   else got, np.float64)
  want = np.asarray(want, np.float64)
  assert got.shape == want.shape
  return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def np_tree(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def port_net(kind, tree):
  net = (cnn.VGGSupernet() if kind == "vgg"
         else cnn.ResNet(int(kind[6:]), width=8))
  net.load_state_dict(convert.cnn_params_from_jax(np_tree(tree)))
  return net


@pytest.fixture(scope="module")
def batches():
  return {"resnet20": CifarLike(CifarLikeConfig(image_size=IMAGE)).sample(
              BATCH, 3),
          "vgg": CifarLike(CifarLikeConfig(image_size=VGG_IMAGE)).sample(
              VGG_BATCH, 3)}


@pytest.fixture(scope="module")
def ref_trees():
  key = jax.random.PRNGKey(0)
  return {"resnet20": ref_cnn.init_resnet(key, 20, 10, width=8),
          "vgg": jax.jit(ref_cnn.init_vgg_supernet, static_argnums=1)(key,
                                                                      10)}


def ref_forward(kind, arch, pe_type):
  if kind == "vgg":
    r, c = ref_cnn.arch_masks(arch)
    return functools.partial(ref_cnn.apply_vgg, pe_type=pe_type, r_use=r,
                             c_use=c)
  return functools.partial(ref_cnn.apply_resnet, depth=int(kind[6:]),
                           pe_type=pe_type)


def port_forward(net, arch, pe_type):
  if isinstance(net, cnn.VGGSupernet):
    return lambda x: net(x, arch, pe_type)
  return lambda x: net(x, pe_type)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

STRIDED = [(16, 3, 8, 16), (8, 3, 16, 32), (16, 1, 8, 16), (8, 1, 16, 32)]
OTHER = [(16, 3, 1, 8, 8), (15, 3, 2, 8, 16), (7, 3, 2, 4, 8),
         (15, 1, 2, 8, 16), (9, 3, 1, 3, 8), (5, 3, 3, 2, 4)]


def _conv_pair(size, k, stride, c_in, c_out, seed=0):
  rng = np.random.RandomState(seed)
  x = rng.normal(size=(4, size, size, c_in)).astype(np.float32)
  w = rng.normal(size=(k, k, c_in, c_out)).astype(np.float32)
  want = np.asarray(ref_cnn.conv2d(jnp.asarray(x), jnp.asarray(w), stride))
  got = cnn.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), stride)
  return got.permute(0, 2, 3, 1), want


@pytest.mark.parametrize("size,k,c_in,c_out", STRIDED)
def test_strided_conv_bit_equal(size, k, c_in, c_out):
  got, want = _conv_pair(size, k, 2, c_in, c_out)
  np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("size,k,stride,c_in,c_out", OTHER)
def test_conv_same_padding_other_sizes(size, k, stride, c_in, c_out):
  got, want = _conv_pair(size, k, stride, c_in, c_out)
  assert rel_err(got, want) <= 1e-6


@pytest.mark.parametrize("n,k,stride,want", [(16, 3, 2, (0, 1)),
                                             (15, 3, 2, (1, 1)),
                                             (16, 1, 2, (0, 0)),
                                             (16, 3, 1, (1, 1)),
                                             (5, 3, 3, (0, 1))])
def test_same_pads_as_xla(n, k, stride, want):
  assert cnn._same_pads(n, k, stride) == want


@pytest.mark.parametrize("size", [8, 7])
def test_maxpool_and_batch_norm(size):
  rng = np.random.RandomState(size)
  x = rng.normal(1.0, 2.0, size=(6, size, size, 5)).astype(np.float32)
  scale = rng.uniform(0.5, 2, 5).astype(np.float32)
  bias = rng.normal(size=5).astype(np.float32)
  xt = torch.from_numpy(x).permute(0, 3, 1, 2)
  np.testing.assert_array_equal(
      cnn.maxpool(xt).permute(0, 2, 3, 1).numpy(),
      np.asarray(ref_cnn.maxpool(jnp.asarray(x))))
  got = cnn.batch_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias))
  want = ref_cnn.batch_norm(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(bias))
  assert rel_err(got.permute(0, 2, 3, 1), want) <= 1e-5


@pytest.mark.parametrize("pe_type", PE_TYPES)
def test_quantized_conv_from_identical_inputs(pe_type, ref_trees):
  """A ResNet block's first conv under ``pe_type``: the fake-quantized
  weight and activation bit-equal, the conv within the f32 bound."""
  rng = np.random.RandomState(1)
  x = np.maximum(rng.normal(size=(4, 8, 8, 16)), 0).astype(np.float32)
  w = np.asarray(ref_trees["resnet20"]["blocks"][4]["w1"])   # 3x3x16x16
  wq = ref_cnn._maybe_fq(jnp.asarray(w), pe_type)
  xq = ref_cnn._maybe_fq_act(jnp.asarray(x), pe_type)
  wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
  xt = torch.from_numpy(x).permute(0, 3, 1, 2)
  got_wq, got_xq = cnn._maybe_fq(wt, pe_type), cnn._maybe_fq_act(xt, pe_type)
  np.testing.assert_array_equal(got_wq.permute(2, 3, 1, 0).numpy(),
                                np.asarray(wq))
  np.testing.assert_array_equal(got_xq.permute(0, 2, 3, 1).numpy(),
                                np.asarray(xq))
  got = cnn.conv2d(got_xq, got_wq, stride=2)
  assert rel_err(got.permute(0, 2, 3, 1), ref_cnn.conv2d(xq, wq, 2)) <= 1e-5


@pytest.mark.parametrize("pe_type", PE_TYPES)
@pytest.mark.parametrize("stride", [1, 2])
def test_quantized_conv_grads_from_identical_inputs(pe_type, stride,
                                                    ref_trees):
  """One quantized conv layer forward and backward: from the same input,
  weight and output gradient, its output and the gradients of its input
  and weight within 1e-5 (f32 sums in another order)."""
  rng = np.random.RandomState(2)
  x = np.maximum(rng.normal(size=(4, 8, 8, 16)), 0).astype(np.float32)
  w = np.asarray(ref_trees["resnet20"]["blocks"][4]["w1"])
  dy = rng.normal(size=(4, 8 // stride, 8 // stride, 16)).astype(np.float32)

  def ref_layer(x, w):
    return ref_cnn.conv2d(ref_cnn._maybe_fq_act(x, pe_type),
                          ref_cnn._maybe_fq(w, pe_type), stride)
  want, vjp = jax.vjp(ref_layer, jnp.asarray(x), jnp.asarray(w))
  want_dx, want_dw = vjp(jnp.asarray(dy))
  xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
  wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
  with cnn.exact_f32():
    got = cnn.conv2d(cnn._maybe_fq_act(xt, pe_type),
                     cnn._maybe_fq(wt, pe_type), stride)
    got.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
  assert rel_err(got.permute(0, 2, 3, 1), want) <= 1e-5
  assert rel_err(xt.grad.permute(0, 2, 3, 1), want_dx) <= 1e-5
  assert rel_err(wt.grad.permute(2, 3, 1, 0), want_dw) <= 1e-5


def test_head_quantizes_per_class_column():
  rng = np.random.RandomState(2)
  head = rng.normal(size=(32, 10)).astype(np.float32)
  for pe_type in PE_TYPES:
    np.testing.assert_array_equal(
        cnn._maybe_fq(torch.from_numpy(head), pe_type, channel_axis=-1)
        .numpy(), np.asarray(ref_cnn._maybe_fq(jnp.asarray(head), pe_type)))


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------

def test_converted_state_matches_the_modules(ref_trees):
  for kind, net in (("resnet20", cnn.ResNet(20, width=8)),
                    ("vgg", cnn.VGGSupernet())):
    state = convert.cnn_params_from_jax(np_tree(ref_trees[kind]))
    want = net.state_dict()
    assert sorted(state) == sorted(want)
    for k, v in state.items():
      assert v.shape == want[k].shape and v.dtype == torch.float32, k


@pytest.mark.parametrize("arch", [cnn.max_arch(), *MASKED],
                         ids=["max", "masked0", "masked1"])
def test_apply_vgg_fp32(arch, ref_trees, batches):
  x, _ = batches["vgg"]
  net = port_net("vgg", ref_trees["vgg"])
  want = ref_forward("vgg", arch, "FP32")(ref_trees["vgg"], jnp.asarray(x))
  with torch.no_grad():
    got = net(torch.from_numpy(x), arch)
  assert rel_err(got, want) <= BOUNDS["FP32"]["logits"]


def test_apply_resnet20_fp32(ref_trees, batches):
  x, _ = batches["resnet20"]
  want = ref_forward("resnet20", None, "FP32")(ref_trees["resnet20"],
                                               jnp.asarray(x))
  with torch.no_grad():
    got = port_net("resnet20", ref_trees["resnet20"])(torch.from_numpy(x))
  assert got.shape == (BATCH, 10)
  assert rel_err(got, want) <= BOUNDS["FP32"]["logits"]


def _jitter(tree, seed):
  """Every weight moved by one ulp, up or down at random."""
  rng = np.random.RandomState(seed)

  def one(a):
    a = np.asarray(a, np.float32)
    to = np.where(rng.rand(*a.shape) < 0.5, np.float32(np.inf),
                  np.float32(-np.inf))
    return jnp.asarray(np.nextafter(a, to))
  return jax.tree_util.tree_map(one, tree)


NETS = [("resnet20", None), ("vgg", MASKED[0])]


@pytest.mark.parametrize("pe_type", PE_TYPES)
@pytest.mark.parametrize("kind,arch", NETS)
def test_logits_and_loss(kind, arch, pe_type, ref_trees, batches):
  x, y = batches[kind]
  tree = ref_trees[kind]
  fwd = jax.jit(ref_forward(kind, arch, pe_type))
  logits = fwd(tree, jnp.asarray(x))
  loss = ref_cnn.xent(logits, jnp.asarray(y))
  with torch.no_grad():
    got = port_forward(port_net(kind, tree), arch, pe_type)(
        torch.from_numpy(x))
  b_logits, b_loss = BOUNDS[pe_type]["logits"], BOUNDS[pe_type]["loss"]
  if pe_type != "FP32":
    for seed in range(3):
      moved = fwd(_jitter(tree, seed), jnp.asarray(x))
      b_logits = max(b_logits, 2 * rel_err(moved, logits))
      b_loss = max(b_loss, 2 * rel_err(
          ref_cnn.xent(moved, jnp.asarray(y)), loss))
  assert rel_err(got, logits) <= b_logits
  assert rel_err(cnn.xent(got, torch.from_numpy(y)), loss) <= b_loss


@pytest.mark.parametrize("kind,arch", NETS)
def test_fp32_grads(kind, arch, ref_trees, batches):
  x, y = batches[kind]
  tree = ref_trees[kind]
  fwd = ref_forward(kind, arch, "FP32")
  loss, grads = jax.value_and_grad(
      lambda p: ref_cnn.xent(fwd(p, jnp.asarray(x)), jnp.asarray(y)))(tree)
  net = port_net(kind, tree)
  f = port_forward(net, arch, "FP32")
  got_loss, got_grads = cnn.value_and_grad(
      net, lambda: cnn.xent(f(torch.from_numpy(x)), torch.from_numpy(y)))
  assert rel_err(got_loss, loss) <= BOUNDS["FP32"]["loss"]
  want_grads = convert.cnn_params_from_jax(np_tree(grads))
  assert sorted(got_grads) == sorted(want_grads)
  for name, want in want_grads.items():
    got = got_grads[name]
    got = torch.zeros_like(want) if got is None else got
    if not want.abs().max() > 0:     # a masked channel or skipped repeat
      assert not got.abs().max() > 0, name
      continue
    assert rel_err(got, want) <= BOUNDS["FP32"]["grads"], name


def _recorder(module, name, calls, to_ref):
  inner = getattr(module, name)

  def wrapped(t, pe_type, *args, **kw):
    calls.append(to_ref(t, *args, **kw))
    return inner(t, pe_type, *args, **kw)
  return wrapped


@pytest.mark.parametrize("kind,arch", [("resnet20", None),
                                       ("vgg", cnn.max_arch())])
def test_quantizers_see_the_reference_tensors(kind, arch, ref_trees,
                                              batches, monkeypatch):
  """Which tensors each network fake-quantizes, in order: a weight's
  shape (HWIO) and channel axis, an activation's shape (NHWC), and the
  first activation's values, under INT16 (every non-FP32 type takes the
  same branches)."""
  x, _ = batches[kind]
  tree = ref_trees[kind]
  calls = {"ref": {"w": [], "a": []}, "port": {"w": [], "a": []}}

  def ref_w(t, channel_axis=0):
    return (tuple(t.shape), channel_axis % t.ndim == t.ndim - 1)

  def port_w(t, channel_axis=0):
    shape = tuple(t.shape)
    if t.ndim == 4:
      return (shape[2:] + shape[1::-1], channel_axis == 0)
    return shape, channel_axis % t.ndim == t.ndim - 1

  for side, mod, conv_w, to_nhwc in (
      ("ref", ref_cnn.quant_lib, ref_w, np.asarray),
      ("port", cnn.quant_lib, port_w,
       lambda t: t.detach().permute(0, 2, 3, 1).numpy())):
    monkeypatch.setattr(mod, "fake_quant_for_pe", _recorder(
        mod, "fake_quant_for_pe", calls[side]["w"], conv_w))
    monkeypatch.setattr(mod, "act_fake_quant_for_pe", _recorder(
        mod, "act_fake_quant_for_pe", calls[side]["a"],
        lambda t, to_nhwc=to_nhwc: to_nhwc(t)))
  ref_forward(kind, arch, "INT16")(tree, jnp.asarray(x))
  with torch.no_grad():
    port_forward(port_net(kind, tree), arch, "INT16")(torch.from_numpy(x))
  ref_calls, port_calls = calls["ref"], calls["port"]
  assert port_calls["w"] == ref_calls["w"]
  assert [a.shape for a in port_calls["a"]] == \
      [a.shape for a in ref_calls["a"]]
  if kind == "vgg":                  # the images
    np.testing.assert_array_equal(port_calls["a"][0], ref_calls["a"][0])
  else:                              # after the stem's conv
    assert rel_err(port_calls["a"][0], ref_calls["a"][0]) <= 1e-5
  n_convs = 21 if kind == "resnet20" else 13
  assert len(ref_calls["w"]) == n_convs + 1       # and the head
  assert len(ref_calls["a"]) == (18 if kind == "resnet20" else 13)


def test_xent_and_accuracy_with_ties():
  rng = np.random.RandomState(4)
  logits = rng.normal(size=(64, 10)).astype(np.float32)
  logits[::5, 3] = logits[::5, 7] = 9.0      # ties: the first index wins
  labels = rng.randint(0, 10, 64).astype(np.int32)
  labels[::10] = 3
  lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
  assert float(cnn.accuracy(lt, yt)) == float(
      ref_cnn.accuracy(jnp.asarray(logits), jnp.asarray(labels)))
  assert rel_err(cnn.xent(lt, yt),
                 ref_cnn.xent(jnp.asarray(logits), jnp.asarray(labels))) \
      <= 1e-6


def test_sample_arch_and_masks():
  key = prng.PRNGKey(5)
  arch = cnn.sample_arch(key)
  assert arch.stages == ref_cnn.sample_arch(jax.random.PRNGKey(5)).stages
  r, c = cnn.arch_masks(arch)
  rr, rc = ref_cnn.arch_masks(ref_cnn.ArchChoice(arch.stages))
  assert list(r) == np.asarray(rr).tolist()
  assert list(c) == np.asarray(rc).tolist()


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------

QAT_SGD = dict(lr=0.05, steps_per_epoch=40, drops=(2, 3))


@pytest.mark.parametrize("cfg", [{}, QAT_SGD,
                                 dict(lr=0.015, steps_per_epoch=50,
                                      drops=(3, 5), drop_factor=0.2)])
def test_sgd_lr_at_equal(cfg):
  pc, rc = opt.SGDConfig(**cfg), ref_opt.SGDConfig(**cfg)
  for step in range(0, 20_000, 37):
    want = np.asarray(ref_opt.sgd_lr_at(rc, jnp.asarray(step, jnp.int32)))
    got = opt.sgd_lr_at(pc, step)
    assert got.dtype == np.float32 and got == want, step


@pytest.mark.parametrize("start", [0, 79, 119, 500])
@pytest.mark.parametrize("nesterov", [True, False])
def test_sgd_update_bit_equal(start, nesterov):
  rng = np.random.RandomState(start)
  shapes = {"a": (3, 3, 4, 5), "b": (7,), "c": (5, 2)}
  p, g, m = ({k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3))
  cfg = dict(QAT_SGD, nesterov=nesterov)
  want_p, want_s, want_m = ref_opt.sgd_update(
      ref_opt.SGDConfig(**cfg), {k: jnp.asarray(v) for k, v in p.items()},
      {k: jnp.asarray(v) for k, v in g.items()},
      {"step": jnp.asarray(start, jnp.int32),
       "mom": {k: jnp.asarray(v) for k, v in m.items()}})
  params = convert.cnn_params_from_jax(p)
  state = convert.sgd_state_from_jax({"step": start, "mom": m})
  _, state, metrics = opt.sgd_update(
      opt.SGDConfig(**cfg), params, convert.cnn_params_from_jax(g), state)
  assert state["step"] == int(want_s["step"]) == start + 1
  assert metrics["lr"] == float(want_m["lr"])
  for got, want in ((params, want_p), (state["mom"], want_s["mom"])):
    want = convert.cnn_params_from_jax(np_tree(want))
    for k in shapes:
      np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())


def test_sgd_update_without_a_gradient_decays():
  p = {"w": torch.full((3,), 2.0)}
  state = opt.sgd_init(p)
  opt.sgd_update(opt.SGDConfig(lr=0.5, weight_decay=0.25), p, {"w": None},
                 state)
  want = ref_opt.sgd_update(
      ref_opt.SGDConfig(lr=0.5, weight_decay=0.25), {"w": jnp.full(3, 2.0)},
      {"w": jnp.zeros(3)}, ref_opt.sgd_init({"w": jnp.full(3, 2.0)}))[0]
  np.testing.assert_array_equal(p["w"].numpy(), np.asarray(want["w"]))


# ---------------------------------------------------------------------------
# the QAT loop and the supernet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pe_type", ["FP32", "LightPE-2"])
def test_three_qat_steps(pe_type, ref_trees):
  """``benchmarks/accuracy_experiments.py``'s ``_train_qat`` loop (resnet20
  at width 8, 16 px, batch 64, its SGD recipe), three steps a side; the
  port's through ``repro_torch.train.qat``'s trainer."""
  ref_data = RefCifarLike(RefCifarLikeConfig(image_size=IMAGE))
  data = CifarLike(CifarLikeConfig(image_size=IMAGE))
  fwd = ref_forward("resnet20", None, pe_type)
  grad = jax.jit(jax.value_and_grad(
      lambda p, x, y: ref_cnn.xent(fwd(p, x), y)))
  params = ref_trees["resnet20"]
  ocfg = ref_opt.SGDConfig(**QAT_SGD)
  ostate = ref_opt.sgd_init(params)
  assert qat.RECIPE_SGD == opt.SGDConfig(**QAT_SGD)
  _, port_step = qat.qat_trainer("resnet20", pe_type, "cpu", width=8,
                                 state=convert.cnn_params_from_jax(
                                     np_tree(params)))
  for step in range(3):
    x, y = ref_data.sample(64, split_seed=step)
    px, py = data.sample(64, split_seed=step)
    np.testing.assert_array_equal(px, x)
    want, g = grad(params, jnp.asarray(x), jnp.asarray(y))
    params, ostate, _ = ref_opt.sgd_update(ocfg, params, g, ostate)
    got = port_step(torch.from_numpy(px), torch.from_numpy(py))
    assert rel_err(got, want) <= 10 * BOUNDS[pe_type]["loss"], step


def test_train_qat_runs_the_recipe_on_the_cpu():
  """The recipe end to end at two steps: a loss a step, finite and the
  same on a rerun (the port's init is seeded), a top-1 in [0, 1]."""
  runs = [qat.train_qat("resnet20", "LightPE-2", "cpu", steps=2)
          for _ in range(2)]
  assert runs[0]["losses"] == runs[1]["losses"]
  assert runs[0]["acc"] == runs[1]["acc"]
  assert len(runs[0]["losses"]) == 2 and np.isfinite(runs[0]["losses"]).all()
  assert 0.0 <= runs[0]["acc"] <= 1.0 and runs[0]["event_ms"] is None


def test_supernet_train_and_evaluate():
  cfg = dict(steps=2, batch=8, image_size=8)
  ref = RefSupernet(RefSupernetConfig(**cfg))
  port = Supernet(SupernetConfig(**cfg), device="cpu")
  port.params.load_state_dict(convert.cnn_params_from_jax(
      np_tree(ref.params)))
  want_losses = ref.train(log_every=0)
  got_losses = port.train(log_every=0)
  assert len(got_losses) == 2
  for g, w in zip(got_losses, want_losses):
    assert abs(g - w) <= 1e-4 * abs(w)
  assert abs(port.evaluate(cnn.max_arch(), n_val=64)
             - ref.evaluate(ref_cnn.max_arch(), n_val=64)) <= 2 / 64
  got = port.sample_and_evaluate(n_archs=3, n_val=64)
  want = ref.sample_and_evaluate(n_archs=3, n_val=64)
  assert [a.stages for a, _ in got] == [a.stages for a, _ in want]
  for (_, ga), (_, wa) in zip(got, want):
    assert abs(ga - wa) <= 2 / 64


# ---------------------------------------------------------------------------
# devices and flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda: cnn.init_resnet(0, 20, width=8),
    lambda: cnn.init_vgg_supernet(0),
    lambda: Supernet(SupernetConfig(image_size=8)),
    lambda: qat.train_qat("resnet20", "FP32", steps=1)],
    ids=["resnet", "vgg", "supernet", "train_qat"])
def test_entry_points_default_to_cuda(make, monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="CUDA"):
    make()


def test_inits_are_seeded_and_distributed_as_the_reference():
  a = cnn.init_resnet(3, 20, width=8, device="cpu")
  b = cnn.init_resnet(3, 20, width=8, device="cpu")
  for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
    assert torch.equal(p, q), n
  w = a.blocks[8].w2.detach()
  assert abs(float(w.std()) - (2.0 / (9 * 32)) ** 0.5) < 0.1 * (
      2.0 / (9 * 32)) ** 0.5
  assert torch.equal(a.stem.scale, torch.ones(8))
  assert torch.equal(a.blocks[0].b1, torch.zeros(8))
  assert abs(float(a.head.detach().std()) - 0.01) < 0.003


def test_exact_f32_sets_and_restores_the_flags():
  before = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
  torch.backends.cuda.matmul.allow_tf32 = True
  try:
    with cnn.exact_f32():
      assert not torch.backends.cuda.matmul.allow_tf32
      assert not torch.backends.cudnn.allow_tf32
      assert torch.backends.cudnn.deterministic
      assert not torch.backends.cudnn.benchmark
    assert torch.backends.cuda.matmul.allow_tf32
  finally:
    torch.backends.cuda.matmul.allow_tf32 = before[0]
  assert (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
          torch.backends.cudnn.benchmark) == before[1:]
