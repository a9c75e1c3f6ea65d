"""The port's MoE (``repro_torch.models.ffn``) against the reference's
(``repro.models.ffn``) on seeded inputs, float32 on the CPU: top-k
routing (ties included), capacity, GShard dispatch with drops, the grouped
MoE and its dense single-token path, the Switch aux loss, QAT's fake
quantization and an int8 AdamW step on a MoE parameter tree, and the
grouping's refusal.

Weights are the reference's ``init_moe`` draws carried across as tensors.
Bounds: routing, dispatch and combine slots exactly equal (the same
softmax on the same logits, a stable sort for the reference's ``top_k``
order); outputs and the aux loss within 1e-5 of their largest |value|
(float32 einsums in other summation orders); fake quantization and the
AdamW step fed the reference's scalars bit-equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.models import ffn as ref_ffn
from repro.models import transformer as ref_tf
from repro.quant.policy import QuantPolicy as RefQuantPolicy
from repro.quant.policy import fake_quant_params as ref_fake_quant_params
from repro.train import optimizer as ref_opt

from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import build_model, ffn, transformer
from repro_torch.quant import QuantPolicy
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts_lib

KEY = jax.random.PRNGKey(0)
MOE_ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x22b")


def rel_err(got, want) -> float:
  got, want = np.asarray(got), np.asarray(want)
  return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _cfgs(arch, **changes):
  return (dataclasses.replace(ref_reduce(ref_get_config(arch)), **changes),
          dataclasses.replace(reduce_for_smoke(get_config(arch)), **changes))


def _moe_params(ref_cfg):
  """The reference's init_moe leaves as numpy and as port tensors."""
  ref = jax.tree_util.tree_map(np.asarray, ref_ffn.init_moe(KEY, ref_cfg))
  return ref, jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()),
                                     ref)


def _x(cfg, b, s, seed=0):
  return np.random.RandomState(seed).standard_normal(
      (b, s, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# routing and capacity
# ---------------------------------------------------------------------------

def test_route_topk_keeps_the_references_order_on_ties():
  """``jax.lax.top_k`` puts the lower index first on ties: [0.3, 0.2, 0.3,
  0.2] gives experts [0, 2]; a planted tie between the k-th and the
  (k+1)-th expert keeps the lower one."""
  rows = np.array([[0.3, 0.2, 0.3, 0.2], [1.0, 2.0, 2.0, 2.0],
                   [0.0, 0.0, 0.0, 0.0], [5.0, -1.0, 5.0, 5.0]],
                  np.float32)
  for k in (1, 2, 3):
    want_g, want_i = ref_ffn.route_topk(jnp.asarray(rows), k)
    got_g, got_i = ffn.route_topk(torch.from_numpy(rows), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert rel_err(got_g.numpy(), want_g) < 1e-6
  _, idx = ffn.route_topk(torch.from_numpy(rows[:1]), 2)
  assert idx.tolist() == [[0, 2]]


@pytest.mark.parametrize("k", [1, 2, 4])
def test_route_topk_matches_reference(k):
  logits = np.random.RandomState(k).standard_normal((3, 50, 8)).astype(
      np.float32) * 2
  want_g, want_i = jax.vmap(lambda lg: ref_ffn.route_topk(lg, k))(
      jnp.asarray(logits))
  got_g, got_i = ffn.route_topk(torch.from_numpy(logits), k)
  np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
  assert rel_err(got_g.numpy(), want_g) < 1e-6
  assert np.allclose(got_g.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("group, k, e, factor", [
    (512, 4, 60, 1.25), (512, 2, 8, 1.25), (64, 2, 4, 1.25), (3, 1, 8, 1.0),
    (100, 3, 7, 0.5), (4096, 4, 60, 8.0)])
def test_capacity_truncates_as_the_reference(group, k, e, factor):
  assert ffn._capacity(group, k, e, factor) == \
      ref_ffn._capacity(group, k, e, factor)


@pytest.mark.parametrize("cap", [1, 3, 7, 40])
def test_dispatch_and_combine_match_reference_with_drops(cap):
  """Slots are assigned rank by rank with the counts carried across
  ranks; at small capacities most of the second rank is dropped."""
  rng = np.random.RandomState(cap)
  g, e, k = 40, 6, 2
  logits = rng.standard_normal((g, e)).astype(np.float32)
  gates, idx = ref_ffn.route_topk(jnp.asarray(logits), k)
  want = ref_ffn._dispatch_combine(gates, idx, e, cap)
  got = ffn._dispatch_combine(torch.from_numpy(np.array(gates)),
                              torch.from_numpy(np.array(idx)).long(), e,
                              cap)
  np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
  np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
  assert abs(float(got[2]) - float(want[2])) <= 1e-7
  kept = int(got[0].sum())
  assert kept <= min(g * k, e * cap)
  if cap < 7:
    assert kept < g * k   # tokens were dropped
  # each kept (token, expert) pair takes one slot, no slot two tokens
  assert float(got[0].sum(dim=0).max()) <= 1.0


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch, changes", [
    ("qwen2-moe-a2.7b", {}), ("mixtral-8x22b", {}),
    ("qwen2-moe-a2.7b", dict(capacity_factor=0.5)),
    ("mixtral-8x22b", dict(mlp_variant="gelu")),
    ("qwen2-moe-a2.7b", dict(mlp_variant="relu2"))], ids=str)
def test_apply_moe_matches_reference(arch, changes):
  rc, pc = _cfgs(arch, **changes)
  ref_p, p = _moe_params(rc)
  x = _x(pc, 2, 64)   # two groups of 64
  want, want_aux = ref_ffn.apply_moe(ref_p, jnp.asarray(x), rc)
  got, aux = ffn.apply_moe(p, torch.from_numpy(x), pc)
  assert rel_err(got.numpy(), want) < 1e-5
  assert abs(float(aux) - float(want_aux)) <= 1e-5 * abs(float(want_aux))
  assert float(aux) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_routing_slots_are_the_references(arch):
  """The grouped path's gates, top-k and kept slots, group by group."""
  rc, pc = _cfgs(arch, capacity_factor=0.75)
  ref_p, p = _moe_params(rc)
  xg = _x(pc, 2, 64, seed=3).reshape(2, 64, pc.d_model)
  logits = np.einsum("gtd,de->gte", xg, ref_p["router"])
  cap = ref_ffn._capacity(64, rc.n_experts_active, rc.n_experts,
                          rc.capacity_factor)
  for g in range(2):
    gates, idx = ref_ffn.route_topk(jnp.asarray(logits[g]),
                                    rc.n_experts_active)
    want = ref_ffn._dispatch_combine(gates, idx, rc.n_experts, cap)
    got_gates, got_idx = ffn.route_topk(torch.from_numpy(logits[g]),
                                        pc.n_experts_active)
    got = ffn._dispatch_combine(got_gates, got_idx, pc.n_experts, cap)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert rel_err(got[1].numpy(), want[1]) < 1e-6
  del p


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_single_token_takes_the_dense_path(arch):
  """(B, 1, d) inputs (decode, a one-token prefill) run every expert and
  combine with the top-k gates, capacity-free, with no aux loss."""
  rc, pc = _cfgs(arch)
  ref_p, p = _moe_params(rc)
  x = _x(pc, 3, 1, seed=1)
  want, want_aux = ref_ffn.apply_moe(ref_p, jnp.asarray(x), rc)
  got, aux = ffn.apply_moe(p, torch.from_numpy(x), pc)
  assert rel_err(got.numpy(), want) < 1e-5
  assert float(aux) == float(want_aux) == 0.0
  dense, _ = ffn.apply_moe_dense(p, torch.from_numpy(x), pc)
  assert torch.equal(dense, got)


def test_moe_gradients_match_reference():
  """Through the router (gates and the aux loss) and every expert."""
  rc, pc = _cfgs("qwen2-moe-a2.7b", capacity_factor=0.75)
  ref_p, p = _moe_params(rc)
  x = _x(pc, 2, 64, seed=2)

  def ref_loss(params):
    out, aux = ref_ffn.apply_moe(params, jnp.asarray(x), rc)
    return jnp.sum(out * out) + 0.01 * aux
  want = jax.grad(ref_loss)(jax.tree_util.tree_map(jnp.asarray, ref_p))
  leaves = {k: v.requires_grad_(True) for k, v in
            transformer.flatten(p).items()}
  out, aux = ffn.apply_moe(transformer.nest(leaves), torch.from_numpy(x), pc)
  grads = torch.autograd.grad(torch.sum(out * out) + 0.01 * aux,
                              list(leaves.values()))
  flat_want = transformer.flatten(jax.tree_util.tree_map(np.asarray, want))
  for (name, _), g in zip(leaves.items(), grads):
    assert rel_err(g.numpy(), flat_want[name]) < 1e-4, name
    assert float(g.abs().max()) > 0, name


@pytest.mark.parametrize("b, s, group", [(2, 48, 64), (3, 10, 4),
                                         (1, 100, 64)])
def test_groups_that_do_not_divide_the_tokens_raise(b, s, group):
  """The reference asserts that its groups divide B * S; the port raises
  and never regroups (capacity competition depends on the grouping)."""
  _, pc = _cfgs("mixtral-8x22b", moe_group_size=group)
  _, p = _moe_params(_cfgs("mixtral-8x22b")[0])
  with pytest.raises(ValueError, match="MoE groups"):
    ffn.apply_moe(p, torch.zeros((b, s, pc.d_model)), pc)


# ---------------------------------------------------------------------------
# QAT and the optimizer on a MoE tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_tree():
  rc, pc = _cfgs("qwen2-moe-a2.7b")
  ref_params = jax.tree_util.tree_map(np.asarray,
                                      ref_tf.init_params(rc, KEY))
  model = build_model(pc, device="cpu")
  params = model.from_state(convert.params_from_jax(pc, ref_params),
                            param_dtype="float32")
  return rc, pc, model, params, ref_params


@pytest.mark.parametrize("pe_type", ["INT8", "LightPE-2"])
def test_fake_quant_of_a_moe_tree_is_the_reference_bits(moe_tree, pe_type):
  """Stacked experts (n_blocks, E, d_in, d_out) and the shared MLP are
  quantized as the reference quantizes them; the router is not."""
  _, pc, model, params, ref_params = moe_tree
  got = ts_lib.fake_quant_tree(model, transformer.param_tree(params),
                               QuantPolicy(pe_type=pe_type))
  want = ref_fake_quant_params(
      jax.tree_util.tree_map(jnp.asarray, ref_params),
      RefQuantPolicy(pe_type=pe_type))
  fg = transformer.flatten(transformer.stack_blocks(pc, got))
  fw = transformer.flatten(jax.tree_util.tree_map(np.asarray, want))
  assert set(fg) == set(fw)
  assert "blocks.sub0.ffn.shared.wg" in fg
  for k in fw:
    np.testing.assert_array_equal(fg[k].detach().numpy(), fw[k],
                                  err_msg=k)
  np.testing.assert_array_equal(fg["blocks.sub0.ffn.router"].detach(),
                                ref_params["blocks"]["sub0"]["ffn"]["router"])


def test_int8_adamw_step_on_a_moe_tree_is_bit_equal(moe_tree):
  """One step with int8 moments, fed the reference's scalars, on every
  leaf of a MoE model: parameters, codes and scales bit-equal after the
  port's per-layer leaves are stacked back on n_blocks."""
  rc, pc, _, params, ref_params = moe_tree
  cfg = opt_lib.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=9,
                            quantize_state=True)
  ref_cfg = ref_opt.AdamWConfig(**dataclasses.asdict(cfg))
  rng = np.random.RandomState(7)
  ref_grads = jax.tree_util.tree_map(
      lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32),
      ref_params)
  jp = jax.tree_util.tree_map(jnp.asarray, ref_params)
  ref_state = ref_opt.adamw_init(ref_cfg, jp)
  want_p, want_s, _ = ref_opt.adamw_update(
      ref_cfg, jp, jax.tree_util.tree_map(jnp.asarray, ref_grads),
      ref_state)
  s = jnp.asarray(1, jnp.int32)
  lr = np.float32(ref_opt.lr_at(ref_cfg, s))
  gnorm = ref_opt.global_norm(jax.tree_util.tree_map(jnp.asarray,
                                                     ref_grads))
  scale = torch.from_numpy(np.array(
      jnp.minimum(1.0, ref_cfg.grad_clip / jnp.maximum(gnorm, 1e-12))))
  bc1 = np.float32(1.0 - ref_cfg.b1 ** s.astype(jnp.float32))
  bc2 = np.float32(1.0 - ref_cfg.b2 ** s.astype(jnp.float32))
  named = {n: p.detach().clone() for n, p in params.named_parameters()}
  grads = convert.params_from_jax(pc, ref_grads, dtype=torch.float32)
  state = opt_lib.adamw_init(cfg, named)
  for n, p in named.items():
    opt_lib.adamw_leaf_update(cfg, p, grads[n], state["m"][n],
                              state["v"][n], lr, scale, bc1, bc2)

  def stacked(flat):
    return transformer.flatten(
        transformer.stack_blocks(pc, transformer.nest(flat)),
        is_leaf=lambda node: set(node) == {"codes", "scale"})
  got = {"p": stacked(named), "m": stacked(state["m"]),
         "v": stacked(state["v"])}
  want = {"p": transformer.flatten(jax.tree_util.tree_map(np.asarray,
                                                          want_p)),
          "m": transformer.flatten(jax.tree_util.tree_map(
              np.asarray, want_s["m"]),
              is_leaf=lambda node: set(node) == {"codes", "scale"}),
          "v": transformer.flatten(jax.tree_util.tree_map(
              np.asarray, want_s["v"]),
              is_leaf=lambda node: set(node) == {"codes", "scale"})}
  for part in ("p", "m", "v"):
    assert set(got[part]) == set(want[part])
    assert any("ffn.wi" in k for k in got[part])
    for k, leaf in want[part].items():
      if part == "p":
        np.testing.assert_array_equal(got[part][k].numpy(), leaf, err_msg=k)
        continue
      for key in ("codes", "scale"):
        np.testing.assert_array_equal(got[part][k][key].numpy(),
                                      np.asarray(leaf[key]),
                                      err_msg=f"{part} {k} {key}")
