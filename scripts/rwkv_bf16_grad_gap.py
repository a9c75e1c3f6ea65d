#!/usr/bin/env python3
"""How far a reduced rwkv6's bf16 train-loss gradients in the PyTorch port
sit from the JAX reference's, on the CPU, and how far the reference's own
evaluations sit from each other.

The model and weights are ``tests/test_torch_rwkv_train.py``'s: the
reference's ``init_params`` of ``reduce_for_smoke(rwkv6-1.6b)`` (2 layers,
d_model 64, 4 heads of 16) with its constant leaves perturbed, carried
across by ``convert``; compute in bf16, float32 master weights, batches of
2 x 40 random tokens, one batch a seed.  For each batch it prints, as
fractions of each leaf's largest |value| (the worst leaf), the gap of

  * the port from the reference compiled with ``xla_allow_excess_precision``
    off, which rounds every bf16 value its source rounds (the test's
    comparison, bound 8 x 2^-8);
  * the port from the reference compiled by default, where XLA may drop a
    bf16 rounding followed by a cast back to float32;
  * the default-compiled reference from the one with the flag off, and the
    reference run op by op (``jax.disable_jit``) from the one with the flag
    off;
  * the reference's bf16 gradient from its float32 one;

and the relative gap of the losses.  Run from the repository root (it
imports both packages):

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/rwkv_bf16_grad_gap.py
    ... --seeds 0 1 2 3 --no-remat
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.models import transformer as ref_tf
from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import build_model, transformer

ARCH = "rwkv6-1.6b"
CONSTANT_LEAVES = ("mix", "cmix", "ln_x", "scale", "bias")


def _cfgs(dtype):
  ref = ref_reduce(ref_get_config(ARCH), loss_chunk_tokens=48)
  port = reduce_for_smoke(get_config(ARCH), loss_chunk_tokens=48)
  return (dataclasses.replace(ref, dtype=dtype),
          dataclasses.replace(port, dtype=dtype))


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
                   else np.asarray(v, np.float32))
  return out


def _worst(got, want):
  return max((float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()),
              k) for k in want)


def _reference(params, batch, cfg, remat, mode):
  fn = jax.value_and_grad(
      lambda p: ref_tf.train_loss(p, batch, cfg, remat=remat), has_aux=True)
  if mode == "eager":
    with jax.disable_jit():
      (loss, _), grads = fn(params)
  else:
    options = ({"xla_allow_excess_precision": False} if mode == "exact"
               else {})
    (loss, _), grads = jax.jit(fn).lower(params).compile(
        compiler_options=options)(params)
  return float(loss), _flat(jax.tree_util.tree_map(np.asarray, grads))


def _port(ref_params, batch, cfg, remat):
  model = build_model(cfg, device="cpu")
  params = model.from_state(
      convert.params_from_jax(cfg, ref_params, dtype=torch.float32),
      param_dtype="float32")
  loss, _ = model.train_loss(
      params, {k: torch.from_numpy(v) for k, v in batch.items()},
      remat=remat)
  named = dict(params.named_parameters())
  grads = torch.autograd.grad(loss, list(named.values()))
  tree = transformer.stack_blocks(cfg, transformer.nest(dict(zip(named,
                                                                 grads))))
  return float(loss.detach()), _flat(tree)


def main() -> None:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
  ap.add_argument("--no-remat", action="store_true")
  args = ap.parse_args()
  remat = not args.no_remat
  rc, pc = _cfgs("bfloat16")
  rc32, _ = _cfgs("float32")
  ref_params = _perturbed(ref_tf.init_params(rc32, jax.random.PRNGKey(0)))
  jparams = jax.tree_util.tree_map(jnp.asarray, ref_params)
  for seed in args.seeds:
    rng = np.random.RandomState(seed)
    batch = {n: rng.randint(0, rc.vocab_size, (2, 40)).astype(np.int32)
             for n in ("tokens", "labels")}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    exact_loss, exact = _reference(jparams, jbatch, rc, remat, "exact")
    _, default = _reference(jparams, jbatch, rc, remat, "default")
    _, eager = _reference(jparams, jbatch, rc, remat, "eager")
    _, f32 = _reference(jparams, jbatch, rc32, remat, "exact")
    port_loss, port = _port(ref_params, batch, pc, remat)

    def show(gap):
      return f"{gap[0]:.4f} ({gap[1]})"
    print(f"batch {seed}, remat {remat}: loss port {port_loss:.7f}, "
          f"reference {exact_loss:.7f}, relative "
          f"{abs(port_loss - exact_loss) / abs(exact_loss):.3g}")
    print(f"  port - reference (excess precision off): "
          f"{show(_worst(port, exact))}")
    print(f"  port - reference (default compile): "
          f"{show(_worst(port, default))}")
    print(f"  reference default - excess precision off: "
          f"{show(_worst(default, exact))}")
    print(f"  reference op by op - excess precision off: "
          f"{show(_worst(eager, exact))}")
    print(f"  reference bf16 - float32: {show(_worst(exact, f32))}")


if __name__ == "__main__":
  main()
