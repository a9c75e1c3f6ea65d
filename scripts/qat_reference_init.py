#!/usr/bin/env python3
"""Table 2's accuracy recipe on the CPU, the JAX reference against the
PyTorch port started from the reference's own initial weights.

The port draws its initial weights from a torch generator, so its
accuracies on the card differ from the reference's by what a different
initialisation moves as well as by what the port computes differently.
This separates the two: for each PE type it runs the reference's recipe
(``benchmarks/accuracy_experiments.py::_train_qat``'s loop, 120 steps of
batch 64 and 512 validation images, with the reference's data, network
and SGD; by default resnet20 at width 8 and 16 px, its own sizes), then
the port's (``repro_torch.train.qat.train_qat``) on the CPU from the
reference's initial weights (``init_resnet`` or ``init_vgg_supernet`` at
``PRNGKey(0)``) carried across by ``convert.cnn_params_from_jax``, and
prints both accuracies.  With ``--jitter-seeds``, the reference trains
again from its initial weights moved by one ulp, up or down at random
(one run a seed): how far its own accuracy moves under the smallest
change of its start.  Run from the repository root (it imports both
packages):

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/qat_reference_init.py
    ... --kind vgg --image 32 --pe-types FP32     # a size of [accuracy] (b)
    ... --kind resnet56 --width 16 --image 32 --pe-types FP32 \
        --jitter-seeds 0 1
"""
from __future__ import annotations

import argparse
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import cnn as ref_cnn
from repro.core.pe import PAPER_PE_TYPES
from repro.data.synthetic import CifarLike, CifarLikeConfig
from repro.train import optimizer as ref_opt
from repro_torch import convert
from repro_torch.train.qat import RECIPE, train_qat


def ref_train_qat(kind: str, pe_type: str, tree, image: int) -> float:
  """``_train_qat``'s loop in the reference, line for line, from the
  initial parameters ``tree`` at ``image`` px (the benchmark fixes both:
  ``PRNGKey(seed)``'s init at width 8, and 16 px)."""
  data = CifarLike(CifarLikeConfig(n_classes=10, image_size=image,
                                   seed=RECIPE["seed"]))
  if kind == "vgg":
    r_use, c_use = ref_cnn.arch_masks(ref_cnn.max_arch())
    fwd = functools.partial(ref_cnn.apply_vgg, pe_type=pe_type,
                            r_use=r_use, c_use=c_use)
  else:
    fwd = functools.partial(ref_cnn.apply_resnet, depth=int(kind[6:]),
                            pe_type=pe_type)
  grad = jax.jit(jax.value_and_grad(lambda p, x, y: ref_cnn.xent(fwd(p, x),
                                                                 y)))
  ocfg = ref_opt.SGDConfig(lr=0.05, steps_per_epoch=40, drops=(2, 3))
  params, state = tree, ref_opt.sgd_init(tree)
  for step in range(RECIPE["steps"]):
    x, y = data.sample(RECIPE["batch"], split_seed=step)
    _, g = grad(params, jnp.asarray(x), jnp.asarray(y))
    params, state, _ = ref_opt.sgd_update(ocfg, params, g, state)
  xv, yv = data.sample(RECIPE["n_val"], split_seed=RECIPE["val_seed"])
  logits = jax.jit(fwd)(params, jnp.asarray(xv))
  return float(ref_cnn.accuracy(logits, jnp.asarray(yv)))


def jittered(tree, seed: int):
  """Every weight moved by one ulp, up or down at random."""
  rng = np.random.RandomState(seed)

  def one(a):
    a = np.asarray(a, np.float32)
    to = np.where(rng.rand(*a.shape) < 0.5, np.float32(np.inf),
                  np.float32(-np.inf))
    return jnp.asarray(np.nextafter(a, to))
  return jax.tree_util.tree_map(one, tree)


def main() -> None:
  ap = argparse.ArgumentParser()
  ap.add_argument("--kind", default="resnet20",
                  help="resnet<depth> or vgg (default resnet20)")
  ap.add_argument("--width", type=int, default=8,
                  help="a ResNet's width (default 8, the reference's)")
  ap.add_argument("--image", type=int, default=16,
                  help="image size in pixels (default 16, the reference's)")
  ap.add_argument("--pe-types", nargs="+", default=list(PAPER_PE_TYPES))
  ap.add_argument("--jitter-seeds", nargs="*", type=int, default=[])
  args = ap.parse_args()
  key = jax.random.PRNGKey(RECIPE["seed"])
  tree = (ref_cnn.init_vgg_supernet(key, 10) if args.kind == "vgg" else
          ref_cnn.init_resnet(key, int(args.kind[6:]), 10, width=args.width))
  state = convert.cnn_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             tree))
  print(f"{args.kind}, width {args.width}, {args.image} px, "
        f"{RECIPE['steps']} steps of batch {RECIPE['batch']}", flush=True)
  for pe_type in args.pe_types:
    t0 = time.perf_counter()
    ref_acc = ref_train_qat(args.kind, pe_type, tree, args.image)
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    port = train_qat(args.kind, pe_type, "cpu", width=args.width,
                     image=args.image, state=state)
    port_s = time.perf_counter() - t0
    print(f"{pe_type}: reference top-1 {ref_acc:.4f} ({ref_s:.1f} s); port "
          f"from the reference's initial weights top-1 {port['acc']:.4f}, "
          f"final loss {port['losses'][-1]:.6f} ({port_s:.1f} s); "
          f"difference {port['acc'] - ref_acc:+.4f}", flush=True)
    for seed in args.jitter_seeds:
      acc = ref_train_qat(args.kind, pe_type, jittered(tree, seed),
                          args.image)
      print(f"{pe_type}: reference from its initial weights moved by one "
            f"ulp (seed {seed}) top-1 {acc:.4f}, difference "
            f"{acc - ref_acc:+.4f}", flush=True)


if __name__ == "__main__":
  main()
