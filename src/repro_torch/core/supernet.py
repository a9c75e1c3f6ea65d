"""The architecture -> accelerator workload bridge of co-exploration (the
part of ``repro.core.supernet`` the joint sweep needs).  The
weight-sharing ``Supernet`` that scores architectures comes with slice
7; until then co-exploration takes the accuracies as given."""
from __future__ import annotations

from typing import List

from repro_torch.core.cnn import SPACE_SIZE, ArchChoice
from repro_torch.core.dataflow import ConvLayer


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
