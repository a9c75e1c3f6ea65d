"""One training step of a language model (the port of
``repro.train.train_step``): QAT fake quantization, microbatched gradient
accumulation and the AdamW update.

There is no ``jit``: the step runs eagerly, and its state is the
trainable ``Transformer`` (``state["params"]``) plus the optimizer's
dict (``state["opt"]``), both updated in place.  Gradients come from
``torch.autograd.grad`` and never touch ``.grad``, so nothing is written
before the optimizer's update; an update that fails after its first write
raises :class:`repro_torch.train.optimizer.PartialUpdateError`, which the
trainer's retry wrapper does not retry (H25).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch

from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.quant.policy import QuantPolicy, fake_quant_params
from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
  optimizer: opt_lib.AdamWConfig = opt_lib.AdamWConfig()
  microbatches: int = 1          # gradient accumulation within the step
  remat: bool = True
  quant: QuantPolicy = QuantPolicy()
  # bf16 matmul weights (f32 Adam moments keep the accuracy)
  param_dtype: str = "float32"   # float32 | bfloat16


def make_train_state(model: Model, tcfg: TrainConfig, seed: int = 0) -> Dict:
  """Trainable parameters drawn from ``seed`` on the model's device and
  AdamW's zero state."""
  params = model.init(seed, param_dtype=tcfg.param_dtype)
  return {"params": params,
          "opt": opt_lib.adamw_init(tcfg.optimizer,
                                    dict(params.named_parameters()))}


def fake_quant_tree(model: Model, tree: transformer.Tree,
                    policy: QuantPolicy) -> transformer.Tree:
  """``fake_quant_params`` on a :func:`transformer.param_tree`: the layers
  are stacked into the reference's ``blocks/sub{i}`` leaves, quantized
  there (each output column's scale spans every layer, H23) and unstacked,
  with autograd through the stack and the straight-through estimator."""
  if not policy.enabled:
    return tree
  stacked = transformer.stack_blocks(model.cfg, tree)
  return transformer.unstack_blocks(model.cfg,
                                    fake_quant_params(stacked, policy))


def loss_fn(model: Model, tcfg: TrainConfig, tree: transformer.Tree,
            batch: Mapping[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
  q_tree = fake_quant_tree(model, tree, tcfg.quant)
  return model.train_loss(q_tree, batch, remat=tcfg.remat)


def _split_microbatches(batch: Mapping[str, torch.Tensor], n: int):
  b = next(iter(batch.values())).shape[0]
  if b % n:
    raise ValueError(f"a batch of {b} does not split into {n} microbatches")
  return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
          for i in range(n)]


def value_and_grad(model: Model, tcfg: TrainConfig, named: Dict,
                   batch: Mapping[str, torch.Tensor]):
  """(loss, metrics, gradients in ``named``'s order) of one batch."""
  loss, metrics = loss_fn(model, tcfg, transformer.nest(named), batch)
  grads = torch.autograd.grad(loss, list(named.values()))
  return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
          grads)


def train_step(model: Model, tcfg: TrainConfig, state: Dict,
               batch: Mapping[str, torch.Tensor]) -> Tuple[Dict, Dict]:
  """One optimizer step (with optional microbatch accumulation), in place;
  returns ``(state, metrics)`` with the loss left on the device."""
  named = dict(state["params"].named_parameters())
  if tcfg.microbatches <= 1:
    loss, metrics, grads = value_and_grad(model, tcfg, named, batch)
  else:
    # accumulated in f32 in microbatch order, then times 1 / n, as the
    # reference's scan does
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in named.values()]
    loss_sum = 0.0
    for mb in _split_microbatches(batch, tcfg.microbatches):
      loss, _, g = value_and_grad(model, tcfg, named, mb)
      for a, gi in zip(acc, g):
        a += gi
      loss_sum = loss_sum + loss
    inv = 1.0 / tcfg.microbatches
    grads = [a * inv for a in acc]
    loss = loss_sum * inv
    metrics = {}
  _, _, opt_metrics = opt_lib.adamw_update(
      tcfg.optimizer, named, dict(zip(named, grads)), state["opt"])
  return state, {**metrics, **opt_metrics, "loss": loss}
