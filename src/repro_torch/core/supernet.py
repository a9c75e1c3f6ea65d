"""The weight-sharing VGG supernet over the Table-4 search space
(Sec. 4.5) and the architecture -> accelerator workload bridge of
co-exploration (the port of ``repro.core.supernet``).

Single-path one-shot training [Guo et al. 2020; Li & Talwalkar 2020]: each
batch trains one uniformly sampled sub-architecture with weights shared
with the largest network; after training, candidate architectures are
evaluated directly on a validation set, the paper's accuracy proxy for
co-exploration (110,592-point space, 1,000 sampled evaluations).

The reference jits one graph over dynamic ``(r_use, c_use)`` arrays; the
port runs eager with Python ints, so choosing a subnet costs no host
sync.  The validation set is evaluated as one batch (batch norm uses the
batch's statistics, H18) and kept on the device between architectures.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.cnn import (SPACE_SIZE, ArchChoice, accuracy,
                                  apply_vgg, init_vgg_supernet, sample_arch,
                                  value_and_grad, xent)
from repro_torch.core.dataflow import ConvLayer
from repro_torch.core.seeding import derive_seed
from repro_torch.data.synthetic import CifarLike, CifarLikeConfig
from repro_torch.models.common import Device, resolve_device
from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass
class SupernetConfig:
  n_classes: int = 10
  image_size: int = 16      # the reference's CPU size; the paper's is 32
  batch: int = 64
  steps: int = 300
  lr: float = 0.015
  seed: int = 0


class Supernet:
  """On CUDA unless ``device`` says otherwise; raises without a card."""

  def __init__(self, cfg: SupernetConfig, device: Device = None):
    self.cfg = cfg
    self.device = resolve_device(device, "the supernet")
    self.data = CifarLike(CifarLikeConfig(
        n_classes=cfg.n_classes, image_size=cfg.image_size, seed=cfg.seed))
    self.params = init_vgg_supernet(cfg.seed, cfg.n_classes,
                                    device=self.device)
    self.opt_cfg = opt_lib.SGDConfig(lr=cfg.lr, steps_per_epoch=50,
                                     drops=(3, 5), drop_factor=0.2)
    self.opt = opt_lib.sgd_init(dict(self.params.named_parameters()))
    self._val: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}

  def _tensors(self, imgs: np.ndarray, labels: np.ndarray):
    return (torch.from_numpy(imgs).to(self.device),
            torch.from_numpy(labels).to(self.device))

  def train(self, steps: Optional[int] = None,
            log_every: int = 50) -> List[float]:
    steps = steps or self.cfg.steps
    losses = []
    rng = np.random.RandomState(self.cfg.seed)
    params = dict(self.params.named_parameters())
    for step in range(steps):
      x, y = self._tensors(*self.data.sample(self.cfg.batch,
                                             split_seed=step))
      arch = sample_arch(prng.PRNGKey(rng.randint(2 ** 31)))
      loss, grads = value_and_grad(
          self.params, lambda: xent(apply_vgg(self.params, x, arch), y))
      opt_lib.sgd_update(self.opt_cfg, params, grads, self.opt)
      losses.append(float(loss))
      if log_every and (step + 1) % log_every == 0:
        print(f"supernet step {step + 1}: loss {np.mean(losses[-50:]):.3f}",
              flush=True)
    return losses

  def evaluate(self, arch: ArchChoice, n_val: int = 512,
               val_seed: int = 10_000_019) -> float:
    """Validation top-1 for one sub-architecture (weight sharing)."""
    if (n_val, val_seed) not in self._val:
      self._val[n_val, val_seed] = self._tensors(
          *self.data.sample(n_val, split_seed=val_seed))
    x, y = self._val[n_val, val_seed]
    with torch.no_grad():
      logits = apply_vgg(self.params, x, arch)
    return float(accuracy(logits, y))

  def sample_and_evaluate(self, n_archs: int = 100, n_val: int = 512,
                          seed: int = 1) -> List[Tuple[ArchChoice, float]]:
    """The paper's predictor: sample architectures, evaluate directly."""
    out = []
    for i in range(n_archs):
      arch = sample_arch(prng.PRNGKey(derive_seed("supernet-eval", seed, i)))
      out.append((arch, self.evaluate(arch, n_val)))
    return out


# ---------------------------------------------------------------------------
# arch -> accelerator workload bridge (for the co-exploration HW cost)
# ---------------------------------------------------------------------------

def arch_to_layers(arch: ArchChoice, image_size: int = 32,
                   in_ch: int = 3) -> List[ConvLayer]:
  """One 3x3 conv layer per repeat of each stage, the feature map halved
  between stages (the VGG plan's max-pool)."""
  layers: List[ConvLayer] = []
  a, c = image_size, in_ch
  for si, (reps, ch) in enumerate(arch.stages):
    for r in range(reps):
      layers.append(ConvLayer(f"s{si}r{r}", A=a, C=c, F=ch, K=3, S=1, P=1))
      c = ch
    a = max(a // 2, 1)
  return layers


def space_size() -> int:
  return SPACE_SIZE
