"""SGD with Nesterov momentum, the paper's CIFAR recipe (the SGD half of
``repro.train.optimizer``; AdamW and its int8 state codec come with slice
7b of the port).

Parameters, gradients and momenta are ``{name: tensor}`` mappings (a
module's ``named_parameters()``), updated in place under
``torch.no_grad()`` in the reference's order of operations, one rounding
each, so the same parameters and gradients give the same bits:

    g = g + wd * p;  mom = m * mom + g;  d = g + m * mom;  p = p - lr * d

Each product and sum is its own tensor operation (never ``add(alpha=)``,
``addcmul`` or ``torch.optim.SGD``'s foreach kernels, which may contract
a product and a sum into one FMA).  Weight decay applies to every leaf,
batch-norm scales and biases and masked channels included.  A parameter
without a gradient (a repeat the sampled subnet skipped) counts as a zero
gradient, as the reference's blend gives it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

Params = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SGDConfig:
  """The paper's recipe: momentum 0.9 Nesterov, wd 5e-4, lr 0.1 dropped 5x
  at epochs 60/120/160 over 200 epochs."""
  lr: float = 0.1
  momentum: float = 0.9
  nesterov: bool = True
  weight_decay: float = 5e-4
  drops: Tuple[int, ...] = (60, 120, 160)
  drop_factor: float = 0.2
  steps_per_epoch: int = 100


def sgd_init(params: Params) -> Dict:
  return {"step": 0,
          "mom": {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in params.items()}}


def sgd_lr_at(cfg: SGDConfig, step: int) -> np.float32:
  """The learning rate at ``step``, in float32: ``f32(lr)`` times
  ``f32(drop_factor)`` once per drop passed, each product rounded."""
  epoch = int(step) // max(cfg.steps_per_epoch, 1)
  lr = np.float32(cfg.lr)
  for d in cfg.drops:
    if epoch >= d:
      lr = lr * np.float32(cfg.drop_factor)
  return lr


@torch.no_grad()
def sgd_update(cfg: SGDConfig, params: Params,
               grads: Mapping[str, Optional[torch.Tensor]],
               state: Dict) -> Tuple[Params, Dict, Dict]:
  """One step in place; returns ``(params, state, {"lr": lr})``."""
  step = state["step"] + 1
  lr = float(sgd_lr_at(cfg, step))
  for name, p in params.items():
    g = grads.get(name)
    mom = state["mom"][name]
    wd = p.to(torch.float32) * cfg.weight_decay
    g = wd if g is None else g.to(torch.float32) + wd
    mom.mul_(cfg.momentum).add_(g)
    d = g + mom * cfg.momentum if cfg.nesterov else mom
    p.copy_(p.to(torch.float32) - d * lr)
  state["step"] = step
  return params, state, {"lr": lr}
