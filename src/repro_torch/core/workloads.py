"""DNN workload definitions for QUIDAM's DSE (copy of
``repro.core.workloads``): the paper's evaluation networks — VGG-16,
ResNet-20/34/50/56 on CIFAR (32x32) and ImageNet (224x224) — as
row-stationary workload layer lists, and transformer GEMMs as 1x1-conv
workload layers."""
from __future__ import annotations

import math
from typing import List, Sequence

from repro_torch.core.dataflow import ConvLayer


# ---------------------------------------------------------------------------
# VGG-16
# ---------------------------------------------------------------------------

_VGG16_PLAN = [  # (channels, repeats) per stage; maxpool between stages
    (64, 2), (128, 2), (256, 3), (512, 3), (512, 3),
]


def vgg16(input_dim: int = 32, in_ch: int = 3,
          plan: Sequence = _VGG16_PLAN) -> List[ConvLayer]:
  layers: List[ConvLayer] = []
  a, c = input_dim, in_ch
  for stage, (f, reps) in enumerate(plan):
    for r in range(reps):
      layers.append(ConvLayer(f"conv{stage + 1}_{r + 1}", A=a, C=c, F=f,
                              K=3, S=1, P=1))
      c = f
    a = max(a // 2, 1)  # maxpool 2x2
  return layers


# ---------------------------------------------------------------------------
# ResNets
# ---------------------------------------------------------------------------

def resnet_cifar(depth: int, input_dim: int = 32) -> List[ConvLayer]:
  """CIFAR ResNet-(6n+2): 3 stages of n basic blocks, widths 16/32/64."""
  assert (depth - 2) % 6 == 0, "CIFAR ResNet depth must be 6n+2"
  n = (depth - 2) // 6
  layers = [ConvLayer("conv1", A=input_dim, C=3, F=16, K=3, S=1, P=1)]
  a, c = input_dim, 16
  for stage, f in enumerate((16, 32, 64)):
    for b in range(n):
      s = 2 if (stage > 0 and b == 0) else 1
      ds = 1 if (stage > 0 and b == 0) else 0
      layers.append(ConvLayer(f"s{stage}b{b}c1", A=a, C=c, F=f, K=3, S=s,
                              P=1, rs=1 - ds, ds=ds))
      a_out = (a + 2 - 3) // s + 1
      layers.append(ConvLayer(f"s{stage}b{b}c2", A=a_out, C=f, F=f, K=3,
                              S=1, P=1, rs=1, ds=0))
      if ds:
        layers.append(ConvLayer(f"s{stage}b{b}proj", A=a, C=c, F=f, K=1,
                                S=s, P=0, rs=0, ds=1))
      a, c = a_out, f
  return layers


def resnet34(input_dim: int = 224) -> List[ConvLayer]:
  """ImageNet ResNet-34: basic blocks, widths 64/128/256/512, [3,4,6,3]."""
  layers = [ConvLayer("conv1", A=input_dim, C=3, F=64, K=7, S=2, P=3)]
  a = (input_dim + 6 - 7) // 2 + 1
  a = (a + 2 - 3) // 2 + 1  # maxpool 3x3 /2
  c = 64
  for stage, (f, reps) in enumerate(((64, 3), (128, 4), (256, 6), (512, 3))):
    for b in range(reps):
      s = 2 if (stage > 0 and b == 0) else 1
      ds = 1 if (stage > 0 and b == 0) else 0
      layers.append(ConvLayer(f"s{stage}b{b}c1", A=a, C=c, F=f, K=3, S=s,
                              P=1, rs=1 - ds, ds=ds))
      a_out = (a + 2 - 3) // s + 1
      layers.append(ConvLayer(f"s{stage}b{b}c2", A=a_out, C=f, F=f, K=3,
                              S=1, P=1, rs=1))
      if ds:
        layers.append(ConvLayer(f"s{stage}b{b}proj", A=a, C=c, F=f, K=1,
                                S=s, P=0, ds=1))
      a, c = a_out, f
  return layers


def resnet50(input_dim: int = 224) -> List[ConvLayer]:
  """ImageNet ResNet-50: bottleneck blocks [3,4,6,3]."""
  layers = [ConvLayer("conv1", A=input_dim, C=3, F=64, K=7, S=2, P=3)]
  a = (input_dim + 6 - 7) // 2 + 1
  a = (a + 2 - 3) // 2 + 1
  c = 64
  for stage, (f, reps) in enumerate(((64, 3), (128, 4), (256, 6), (512, 3))):
    for b in range(reps):
      s = 2 if (stage > 0 and b == 0) else 1
      ds = 1 if b == 0 else 0
      layers.append(ConvLayer(f"s{stage}b{b}r", A=a, C=c, F=f, K=1, S=1,
                              P=0, rs=1 - ds, ds=ds))
      layers.append(ConvLayer(f"s{stage}b{b}c", A=a, C=f, F=f, K=3, S=s,
                              P=1, rs=1 - ds, ds=ds))
      a_out = (a + 2 - 3) // s + 1
      layers.append(ConvLayer(f"s{stage}b{b}e", A=a_out, C=f, F=4 * f, K=1,
                              S=1, P=0, rs=1 - ds, ds=ds))
      if ds:
        layers.append(ConvLayer(f"s{stage}b{b}proj", A=a, C=c, F=4 * f,
                                K=1, S=s, P=0, ds=1))
      a, c = a_out, 4 * f
  return layers


def resnet20(input_dim: int = 32) -> List[ConvLayer]:
  return resnet_cifar(20, input_dim)


def resnet56(input_dim: int = 32) -> List[ConvLayer]:
  return resnet_cifar(56, input_dim)


# ---------------------------------------------------------------------------
# transformer bridge: matmul -> 1x1 conv workload
# ---------------------------------------------------------------------------

def matmul_layer(name: str, tokens: int, d_in: int, d_out: int) -> ConvLayer:
  """A (tokens, d_in) @ (d_in, d_out) GEMM as a 1x1 conv over sqrt(tokens)^2
  positions (RS dataflow treats output positions uniformly)."""
  a = max(int(math.ceil(math.sqrt(tokens))), 1)
  return ConvLayer(name, A=a, C=d_in, F=d_out, K=1, S=1, P=0)


def lm_block_workload(name: str, tokens: int, d_model: int, n_heads: int,
                      n_kv: int, head_dim: int, d_ff: int,
                      gated: bool = True, n_experts_active: int = 1
                      ) -> List[ConvLayer]:
  """One transformer block's GEMMs as workload layers (per token batch)."""
  layers = [
      matmul_layer(f"{name}.q", tokens, d_model, n_heads * head_dim),
      matmul_layer(f"{name}.kv", tokens, d_model, 2 * n_kv * head_dim),
      matmul_layer(f"{name}.o", tokens, n_heads * head_dim, d_model),
  ]
  ff_mats = 3 if gated else 2
  for i in range(ff_mats):
    d_in = d_model if i < ff_mats - 1 else d_ff
    d_out = d_ff if i < ff_mats - 1 else d_model
    layers.append(matmul_layer(f"{name}.ffn{i}",
                               tokens * n_experts_active, d_in, d_out))
  return layers


# ---------------------------------------------------------------------------
# registry (paper networks)
# ---------------------------------------------------------------------------

def get_network(name: str) -> List[ConvLayer]:
  """Paper workloads: vgg16/resnet20/resnet56 (CIFAR), vgg16_imagenet,
  resnet34/resnet50 (ImageNet)."""
  table = {
      "vgg16": lambda: vgg16(32),
      "vgg16_imagenet": lambda: vgg16(224),
      "resnet20": lambda: resnet20(32),
      "resnet56": lambda: resnet56(32),
      "resnet34": lambda: resnet34(224),
      "resnet50": lambda: resnet50(224),
  }
  if name not in table:
    raise ValueError(f"unknown network {name!r}; known: {sorted(table)}")
  return table[name]()


# the paper's workload suites (Sec. 4.2)
CIFAR_SUITE = ("vgg16", "resnet20", "resnet56")
IMAGENET_SUITE = ("vgg16_imagenet", "resnet34", "resnet50")
