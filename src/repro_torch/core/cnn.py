"""The CNNs of the paper's accuracy experiments (the port of
``repro.core.cnn``): Conv-BN-ReLU VGG plans, channel- and
repeat-maskable for the weight-sharing supernet over the Table-4 search
space, and CIFAR-style basic-block ResNets, trained with the paper's SGD
recipe (:mod:`repro_torch.train.optimizer`) on the procedural
``CifarLike`` data under any QUIDAM PE type's fake quantization (FP32 /
INT16 / LightPE-1 / LightPE-2).

Layouts: images are NHWC at the API (as ``CifarLike`` returns them) and
permuted to NCHW once inside; conv weights are OIHW, so the reference's
per-output-channel weight quantization (``channel_axis=-1`` on HWIO) is
axis 0 here, and the ``(C, n_classes)`` head keeps -1.  Networks are
``nn.Module``\\ s (:class:`VGGSupernet`, :class:`ResNet`) whose state
names follow the reference's tree (``stages.<s>.<r>.w``,
``blocks.<i>.w1``, ``head``; :func:`repro_torch.convert.cnn_params_from_jax`
carries a reference tree across).  Inits draw from a CPU
``torch.Generator`` seeded by the caller, with the reference's
distributions, so the card and the CPU start from the same bits (not the
reference's: its draws come from jax keys).

Numerics the reference fixes and the port keeps:
  * ``padding="SAME"`` pads as XLA does: at stride 2 an even input gets 0
    rows before and 1 after (H17);
  * batch norm always uses the batch's mean and population variance, at
    training and at evaluation (no running statistics, H18): evaluate a
    validation set as one batch;
  * f32 convolutions and the head run with TF32 off and deterministic
    cuDNN algorithms, set inside the port's functions and restored on
    exit (:func:`exact_f32`, H19), so a rerun gives the same bits;
  * subnets are masked, never sliced: every conv runs at full width, so a
    weight's per-output-channel quantization scale sees every input
    channel.

:func:`sample_arch` draws from a jax-style key (:mod:`repro_torch.core.prng`),
bit for bit the reference's draw.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import prng
from repro_torch.core import quant as quant_lib
from repro_torch.models.common import Device, resolve_device


# ---------------------------------------------------------------------------
# numerics and primitives (NCHW activations, OIHW weights)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def exact_f32():
  """Plain f32 convolutions and matmuls (TF32 off) with deterministic,
  unbenchmarked cuDNN algorithms; the caller's flags come back on exit."""
  prev = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
      yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = prev


def conv_init(gen: torch.Generator, k: int, c_in: int,
              c_out: int) -> torch.Tensor:
  """He-normal ``(c_out, c_in, k, k)`` weights drawn from ``gen``."""
  fan_in = k * k * c_in
  return torch.randn((c_out, c_in, k, k), generator=gen,
                     dtype=torch.float32) * (2.0 / fan_in) ** 0.5


def _same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
  """XLA's SAME padding of one spatial dim: (before, after)."""
  out = -(-n // stride)
  total = max((out - 1) * stride + k - n, 0)
  return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
  """``x`` (N, C, H, W) by ``w`` (O, C, kh, kw); SAME pads as XLA does."""
  (t, b), (l, r) = (_same_pads(x.shape[2], w.shape[2], stride),
                    _same_pads(x.shape[3], w.shape[3], stride))
  if (t, l) == (b, r):
    pad = (t, l)
  else:
    x, pad = F.pad(x, (l, r, t, b)), 0
  with exact_f32():
    return F.conv2d(x, w, stride=stride, padding=pad)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
  """Batch statistics over (N, H, W), population variance; never running
  statistics (the reference has none)."""
  mean = torch.mean(x, dim=(0, 2, 3), keepdim=True)
  var = torch.mean(torch.square(x - mean), dim=(0, 2, 3), keepdim=True)
  return ((x - mean) * torch.rsqrt(var + eps) * scale[:, None, None]
          + bias[:, None, None])


def maxpool(x: torch.Tensor) -> torch.Tensor:
  """2x2, stride 2, VALID."""
  return F.max_pool2d(x, 2, 2)


def _maybe_fq(w: torch.Tensor, pe_type: str,
              channel_axis: int = 0) -> torch.Tensor:
  """Per-output-channel weight fake quant (axis 0 of OIHW; -1 for the
  head)."""
  if pe_type == "FP32":
    return w
  return quant_lib.fake_quant_for_pe(w, pe_type, channel_axis=channel_axis)


def _maybe_fq_act(x: torch.Tensor, pe_type: str) -> torch.Tensor:
  if pe_type == "FP32":
    return x
  return quant_lib.act_fake_quant_for_pe(x, pe_type)


def _head(x: torch.Tensor, head: torch.Tensor, pe_type: str) -> torch.Tensor:
  """Global average pool of (N, C, H, W), then the (C, n_classes) head."""
  with exact_f32():
    return torch.matmul(torch.mean(x, dim=(2, 3)),
                        _maybe_fq(head, pe_type, channel_axis=-1))


def _nchw(images: torch.Tensor) -> torch.Tensor:
  return images.permute(0, 3, 1, 2)


def _bn_params(c: int) -> Tuple[nn.Parameter, nn.Parameter]:
  return (nn.Parameter(torch.ones(c, dtype=torch.float32)),
          nn.Parameter(torch.zeros(c, dtype=torch.float32)))


# ---------------------------------------------------------------------------
# VGG (plan-parameterized; supernet-maskable)
# ---------------------------------------------------------------------------

# Table 4 search space: (repeat choices, channel choices) per stage.
SEARCH_SPACE: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...] = (
    ((1, 2), (40, 48, 56, 64)),
    ((1, 2), (80, 96, 112, 128)),
    ((1, 2, 3), (160, 192, 224, 256)),
    ((1, 2, 3), (320, 384, 448, 512)),
    ((1, 2, 3), (320, 384, 448, 512)),
)

MAX_PLAN = tuple((max(reps), max(chs)) for reps, chs in SEARCH_SPACE)
SPACE_SIZE = 1
for _reps, _chs in SEARCH_SPACE:
  SPACE_SIZE *= len(_reps) * len(_chs)         # = 110,592


@dataclasses.dataclass(frozen=True)
class ArchChoice:
  """One point of the Table-4 space: per-stage (repeats, channels)."""
  stages: Tuple[Tuple[int, int], ...]

  def as_plan(self) -> List[Tuple[int, int]]:
    return [(c, r) for (r, c) in self.stages]


def sample_arch(key: np.ndarray) -> ArchChoice:
  """A uniform draw from the space under a jax-style key
  (``prng.PRNGKey(seed)``): the reference's draw, bit for bit."""
  ks = prng.split(key, len(SEARCH_SPACE))
  stages = []
  for (reps, chs), k in zip(SEARCH_SPACE, ks):
    kr, kc = prng.split(k)
    r = reps[prng.randint(kr, 0, len(reps))]
    c = chs[prng.randint(kc, 0, len(chs))]
    stages.append((r, c))
  return ArchChoice(tuple(stages))


def max_arch() -> ArchChoice:
  return ArchChoice(MAX_PLAN)


class VGGSupernet(nn.Module):
  """The largest Table-4 network; subnets mask its channels and repeats.
  State: ``stages.<s>.<r>.{w,scale,bias}`` and ``head``."""

  def __init__(self, n_classes: int = 10, in_ch: int = 3):
    super().__init__()
    self.stages = nn.ModuleList()
    c_prev = in_ch
    for reps, c_out in MAX_PLAN:
      stage = nn.ModuleList()
      for _ in range(reps):
        scale, bias = _bn_params(c_out)
        stage.append(nn.ParameterDict({
            "w": nn.Parameter(torch.zeros(c_out, c_prev, 3, 3)),
            "scale": scale, "bias": bias}))
        c_prev = c_out
      self.stages.append(stage)
    self.head = nn.Parameter(torch.zeros(c_prev, n_classes))

  def forward(self, images: torch.Tensor, arch: ArchChoice,
              pe_type: str = "FP32") -> torch.Tensor:
    return apply_vgg(self, images, arch, pe_type)


def init_vgg_supernet(seed: int = 0, n_classes: int = 10, in_ch: int = 3,
                      device: Device = None) -> VGGSupernet:
  """Weights for the LARGEST config, drawn from ``seed``; on CUDA unless
  ``device`` says otherwise."""
  dev = resolve_device(device, "the VGG supernet")
  gen = torch.Generator().manual_seed(int(seed))
  net = VGGSupernet(n_classes, in_ch)
  with torch.no_grad():
    for stage in net.stages:
      for blk in stage:
        c_out, c_in = blk["w"].shape[:2]
        blk["w"].copy_(conv_init(gen, 3, c_in, c_out))
    net.head.copy_(torch.randn(net.head.shape, generator=gen) * 0.01)
  return net.to(dev)


def arch_masks(arch: ArchChoice) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
  """Per-stage repeats and channels in use, as Python ints: choosing a
  subnet costs no host sync."""
  return (tuple(r for (r, _) in arch.stages),
          tuple(c for (_, c) in arch.stages))


def apply_vgg(params: VGGSupernet, images: torch.Tensor, arch: ArchChoice,
              pe_type: str = "FP32") -> torch.Tensor:
  """images (B, H, W, 3) -> logits; masks the supernet per ``arch``.

  Every conv runs at full width and its ReLU output is multiplied by the
  stage's channel mask.  Repeat 0 always runs; the reference blends a
  later repeat as ``keep * y + (1 - keep) * x``, which is ``x`` itself
  when ``keep`` is 0, so a repeat past the arch's count is skipped (its
  parameters get no gradient, the reference's zero)."""
  r_use, c_use = arch_masks(arch)
  x = _nchw(images)
  for si, stage in enumerate(params.stages):
    c_max = stage[0]["w"].shape[0]
    cmask = None
    if c_use[si] < c_max:
      cmask = (torch.arange(c_max, device=x.device) < c_use[si]).to(
          x.dtype)[:, None, None]
    for r, blk in enumerate(stage):
      if r > 0 and r >= r_use[si]:
        break
      y = conv2d(_maybe_fq_act(x, pe_type), _maybe_fq(blk["w"], pe_type))
      y = torch.relu(batch_norm(y, blk["scale"], blk["bias"]))
      x = y if cmask is None else y * cmask
    if x.shape[2] > 1:
      x = maxpool(x)
  return _head(x, params.head, pe_type)


# ---------------------------------------------------------------------------
# CIFAR ResNets (reduced-width variants for the QAT accuracy studies)
# ---------------------------------------------------------------------------

class ResNet(nn.Module):
  """A CIFAR basic-block ResNet of ``depth`` = 6n + 2.  State:
  ``stem.{w,scale,bias}``, ``blocks.<i>.{w1,s1,b1,w2,s2,b2[,proj]}`` and
  ``head``."""

  def __init__(self, depth: int, n_classes: int = 10, width: int = 16,
               in_ch: int = 3):
    super().__init__()
    if (depth - 2) % 6:
      raise ValueError(f"a CIFAR ResNet's depth is 6n + 2, got {depth}")
    self.depth = depth
    n = (depth - 2) // 6
    scale, bias = _bn_params(width)
    self.stem = nn.ParameterDict({
        "w": nn.Parameter(torch.zeros(width, in_ch, 3, 3)),
        "scale": scale, "bias": bias})
    self.blocks = nn.ModuleList()
    c_prev = width
    for mult in (1, 2, 4):
      c = width * mult
      for _ in range(n):
        s1, b1 = _bn_params(c)
        s2, b2 = _bn_params(c)
        blk = nn.ParameterDict({
            "w1": nn.Parameter(torch.zeros(c, c_prev, 3, 3)),
            "s1": s1, "b1": b1,
            "w2": nn.Parameter(torch.zeros(c, c, 3, 3)),
            "s2": s2, "b2": b2})
        if c_prev != c:
          blk["proj"] = nn.Parameter(torch.zeros(c, c_prev, 1, 1))
        self.blocks.append(blk)
        c_prev = c
    self.head = nn.Parameter(torch.zeros(c_prev, n_classes))

  def forward(self, images: torch.Tensor,
              pe_type: str = "FP32") -> torch.Tensor:
    return apply_resnet(self, images, self.depth, pe_type)


def init_resnet(seed: int, depth: int, n_classes: int = 10, width: int = 16,
                in_ch: int = 3, device: Device = None) -> ResNet:
  """A ResNet drawn from ``seed``; on CUDA unless ``device`` says
  otherwise."""
  dev = resolve_device(device, "the ResNet")
  gen = torch.Generator().manual_seed(int(seed))
  net = ResNet(depth, n_classes, width, in_ch)
  with torch.no_grad():
    for name, p in net.named_parameters():
      if p.dim() == 4:
        c_out, c_in, k, _ = p.shape
        p.copy_(conv_init(gen, k, c_in, c_out))
    net.head.copy_(torch.randn(net.head.shape, generator=gen) * 0.01)
  return net.to(dev)


def apply_resnet(params: ResNet, images: torch.Tensor, depth: int,
                 pe_type: str = "FP32") -> torch.Tensor:
  """images (B, H, W, 3) -> logits.  The stem's input and a projection's
  input are not fake-quantized (the reference's choice)."""
  n = (depth - 2) // 6
  x = conv2d(_nchw(images), _maybe_fq(params.stem["w"], pe_type))
  x = torch.relu(batch_norm(x, params.stem["scale"], params.stem["bias"]))
  bi = 0
  for stage in range(3):
    for b in range(n):
      blk = params.blocks[bi]
      bi += 1
      stride = 2 if (stage > 0 and b == 0) else 1
      h = conv2d(_maybe_fq_act(x, pe_type), _maybe_fq(blk["w1"], pe_type),
                 stride=stride)
      h = torch.relu(batch_norm(h, blk["s1"], blk["b1"]))
      h = conv2d(_maybe_fq_act(h, pe_type), _maybe_fq(blk["w2"], pe_type))
      h = batch_norm(h, blk["s2"], blk["b2"])
      if "proj" in blk:
        x = conv2d(x, _maybe_fq(blk["proj"], pe_type), stride=stride)
      x = torch.relu(x + h)
  return _head(x, params.head, pe_type)


# ---------------------------------------------------------------------------
# loss/accuracy helpers and one differentiation
# ---------------------------------------------------------------------------

def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
  logz = torch.logsumexp(logits, dim=-1)
  gold = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
  return torch.mean(logz - gold)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
  """Top-1; ties go to the first index, as ``jnp.argmax``'s do."""
  return torch.mean((torch.argmax(logits, -1) == labels.long()).to(
      torch.float32))


def value_and_grad(model: nn.Module, loss_fn: Callable[[], torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, Optional[torch.Tensor]]]:
  """``loss_fn()``'s value and the gradient of every parameter of
  ``model`` (None where the loss does not reach it), forward and backward
  both under :func:`exact_f32`."""
  for p in model.parameters():
    p.grad = None
  with exact_f32():
    loss = loss_fn()
    loss.backward()
  return loss.detach(), {n: p.grad for n, p in model.named_parameters()}
