"""Table 2's quantization-aware training recipe (the port of
``benchmarks/accuracy_experiments.py::_train_qat``): ``CifarLike`` at
seed 0, SGD at lr 0.05 with 40 steps an epoch and drops at epochs 2 and
3, 120 steps of batch 64 at ``split_seed=step``, then top-1 on 512
validation images at split 10,000,019, evaluated as one batch (batch
norm takes the batch's statistics, H18).

The network is ``"resnet<depth>"`` at a width, or ``"vgg"``, the
supernet at ``max_arch()``; it trains under one PE type's fake
quantization.  Its initial weights are the port's own draws from the
recipe's seed, or ``state``, a state dict that replaces them (the
reference's carried across by :func:`repro_torch.convert.cnn_params_from_jax`).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core import cnn
from repro_torch.data import CifarLike, CifarLikeConfig
from repro_torch.models.common import Device, resolve_device
from repro_torch.train import optimizer as opt

RECIPE = dict(steps=120, batch=64, n_val=512, val_seed=10_000_019, seed=0)
RECIPE_SGD = opt.SGDConfig(lr=0.05, steps_per_epoch=40, drops=(2, 3))


def qat_trainer(kind: str, pe_type: str, device: Device = None,
                width: int = 8,
                state: Optional[Mapping[str, torch.Tensor]] = None
                ) -> Tuple[Callable, Callable]:
  """The network the recipe trains, on CUDA unless ``device`` says
  otherwise: its forward ``fwd(images)`` and one step of the recipe's SGD,
  ``step(images, labels)``, which returns the loss left on the device."""
  dev = resolve_device(device, "QAT training")
  if kind == "vgg":
    net = cnn.init_vgg_supernet(RECIPE["seed"], 10, device=dev)
    arch = cnn.max_arch()
    fwd = lambda x: net(x, arch, pe_type)
  else:
    net = cnn.init_resnet(RECIPE["seed"], int(kind[6:]), 10, width=width,
                          device=dev)
    fwd = lambda x: net(x, pe_type)
  if state is not None:
    net.load_state_dict(state)
  params = dict(net.named_parameters())
  ostate = opt.sgd_init(params)

  def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    loss, grads = cnn.value_and_grad(net, lambda: cnn.xent(fwd(x), y))
    opt.sgd_update(RECIPE_SGD, params, grads, ostate)
    return loss
  return fwd, step


def train_qat(kind: str, pe_type: str, device: Device = None, width: int = 8,
              image: int = 16, steps: int = RECIPE["steps"],
              state: Optional[Mapping[str, torch.Tensor]] = None) -> Dict:
  """The recipe on CUDA unless ``device`` says otherwise.  The batches are
  drawn on the host before the loop (set-up); the loop keeps each step's
  loss on the device and reads them after it.  Returns ``acc`` (top-1),
  ``losses`` (every step's), and the loop's ms a step on the host clock
  (``host_ms``) and, on CUDA, between events (``event_ms``, else None)."""
  dev = resolve_device(device, "QAT training")
  data = CifarLike(CifarLikeConfig(n_classes=10, image_size=image,
                                   seed=RECIPE["seed"]))
  fwd, step = qat_trainer(kind, pe_type, dev, width, state)
  host = [data.sample(RECIPE["batch"], split_seed=i) for i in range(steps)]
  cuda = dev.type == "cuda"
  if cuda:
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
  t0 = time.perf_counter()
  losses = [step(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
            for x, y in host]
  if cuda:
    end.record()
    torch.cuda.synchronize()
  host_ms = (time.perf_counter() - t0) * 1e3 / steps
  xv, yv = (torch.from_numpy(a).to(dev) for a in data.sample(
      RECIPE["n_val"], split_seed=RECIPE["val_seed"]))
  with torch.no_grad():
    acc = float(cnn.accuracy(fwd(xv), yv))
  return dict(acc=acc, losses=[float(l) for l in losses], host_ms=host_ms,
              event_ms=start.elapsed_time(end) / steps if cuda else None)
