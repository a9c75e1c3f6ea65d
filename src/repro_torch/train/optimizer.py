"""Optimizers (the port of ``repro.train.optimizer``): AdamW, with
optional int8 block-quantized moments, which trains the language models,
and SGD with Nesterov momentum, the paper's CIFAR recipe, which trains
the QAT CNNs and the supernet.

Parameters, gradients and states are ``{name: tensor}`` mappings (a
module's ``named_parameters()``), updated in place under
``torch.no_grad()`` in the reference's order of operations, one rounding
each, so the same parameters and gradients give the same bits.  Each
product and sum is its own tensor operation (never ``add(alpha=)``,
``addcmul``, ``lerp``, ``torch.optim`` or the ``_foreach_*`` kernels,
which may contract a product and a sum into one FMA), and every division
by a number goes through ``exact.div``.

SGD's step:

    g = g + wd * p;  mom = m * mom + g;  d = g + m * mom;  p = p - lr * d

Weight decay applies to every leaf, batch-norm scales and biases and
masked channels included.  A parameter without a gradient (a repeat the
sampled subnet skipped) counts as a zero gradient, as the reference's
blend gives it.

AdamW's scalars (the learning rate and the bias corrections) are float32
numbers computed on the host from the step, as the reference computes
them in float32.  ``cos`` and ``pow`` are not correctly rounded, so each
library's may differ from XLA's by an ulp (H24): the cosine is the C
library's ``cosf``, and the powers numpy's, which are the ones XLA's CPU
code calls.  The gradient norm stays on the
device: it sums each leaf's float32 squares in float64, so the card and
the CPU agree on it to an ulp, and the clip factor is taken from it
there, so a step reads nothing back from the card.  Square roots are
correctly rounded (:func:`_sqrt`) on both.  An update that fails
after its first in-place write raises :class:`PartialUpdateError`, which
is not a ``RuntimeError``: ``retrying`` lets it through, so no retry
starts from a half-updated state (H25).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
from typing import Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import exact

Params = Mapping[str, torch.Tensor]

QUANT_BLOCK = 256


# ---------------------------------------------------------------------------
# block-wise int8 state codec
# ---------------------------------------------------------------------------

def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """f32 -> (int8 codes, per-block scales), blocked along the last dim:
  the codes keep the tensor's shape, the last dim padded to a multiple of
  ``QUANT_BLOCK``; a block's scale is max(absmax, 1e-12) / 127 and its
  codes round half to even, clipped to +-127."""
  last = x.shape[-1] if x.dim() else 1
  lead = tuple(x.shape[:-1])
  pad = (-last) % QUANT_BLOCK
  xb = F.pad(x.reshape(*lead, last), (0, pad)).reshape(*lead, -1,
                                                       QUANT_BLOCK)
  scale = exact.div(torch.clamp_min(xb.abs().amax(dim=-1, keepdim=True),
                                    1e-12), 127.0)
  codes = torch.clamp(torch.round(exact.div(xb, scale)), -127, 127)
  return codes.to(torch.int8).reshape(*lead, last + pad), scale[..., 0]


def _dq8(codes: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
  last = shape[-1] if len(shape) else 1
  xb = codes.reshape(*codes.shape[:-1], -1, QUANT_BLOCK).float()
  x = (xb * scale[..., None]).reshape(*codes.shape[:-1], -1)
  return x[..., :last].reshape(shape)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
  lr: float = 3e-4
  b1: float = 0.9
  b2: float = 0.95
  eps: float = 1e-8
  weight_decay: float = 0.1
  grad_clip: float = 1.0
  quantize_state: bool = False   # int8 block-wise m/v
  schedule: str = "cosine"       # cosine | constant | paper_cifar
  warmup_steps: int = 100
  total_steps: int = 10_000


class PartialUpdateError(Exception):
  """An in-place update failed after its first write: the state is half
  updated.  Not a ``RuntimeError``, so ``retrying`` does not retry it."""


@functools.lru_cache(maxsize=None)
def _cosf():
  """The C library's float32 ``cosf``, which XLA's CPU cos calls: numpy's
  float32 cos can be an ulp away from it, and ``1 + cos`` near -1 turns
  that ulp into several of the learning rate."""
  libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
  libm.cosf.restype = ctypes.c_float
  libm.cosf.argtypes = [ctypes.c_float]
  return libm.cosf


def lr_at(cfg: AdamWConfig, step: int) -> np.float32:
  """The learning rate at ``step``, in float32 as the reference's."""
  f32 = np.float32
  s = f32(step)
  warm = np.minimum(s / f32(max(cfg.warmup_steps, 1)), f32(1.0))
  if cfg.schedule == "constant":
    return f32(cfg.lr) * warm
  if cfg.schedule == "cosine":
    t = np.clip((s - f32(cfg.warmup_steps))
                / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                f32(0.0), f32(1.0))
    cos = f32(_cosf()(float(f32(np.pi) * t)))
    return f32(cfg.lr) * warm * f32(0.5) * (f32(1.0) + cos)
  raise ValueError(cfg.schedule)


def bias_corrections(cfg: AdamWConfig, step: int
                     ) -> Tuple[np.float32, np.float32]:
  """``1 - b1**step`` and ``1 - b2**step`` in float32."""
  f32 = np.float32
  return (f32(1.0) - f32(cfg.b1) ** f32(step),
          f32(1.0) - f32(cfg.b2) ** f32(step))


MomentState = Union[torch.Tensor, Dict[str, torch.Tensor]]


def adamw_init(cfg: AdamWConfig, params: Params) -> Dict:
  """Step 0 and zero moments: float32 like each parameter, or int8 codes
  with their block scales."""
  def zeros(p):
    z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    if cfg.quantize_state:
      codes, scale = _q8(z)
      return {"codes": codes, "scale": scale}
    return z

  return {"step": 0,
          "m": {n: zeros(p) for n, p in params.items()},
          "v": {n: zeros(p) for n, p in params.items()}}


def _sqrt(x: torch.Tensor) -> torch.Tensor:
  """The correctly rounded float32 square root, as XLA's and the card's
  are: torch's float32 sqrt on the CPU (its AVX-512 path) rounds about
  0.7% of its results the other way, its float64 sqrt does not, and a
  float64 root rounded to float32 is the correctly rounded float32 root."""
  return torch.sqrt(x.double()).float()


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
  """sqrt of the sum of squares, a 0-d float32 tensor on the tensors'
  device: each square in float32 (the reference's), their sum in float64,
  rounded to float32 before the square root."""
  total = None
  for t in tensors:
    part = torch.sum(torch.square(t.float()), dtype=torch.float64)
    total = part if total is None else total + part
  return _sqrt(total.float())


@torch.no_grad()
def adamw_leaf_update(cfg: AdamWConfig, p: torch.Tensor, g: torch.Tensor,
                      m: MomentState, v: MomentState, lr: float,
                      scale: Union[torch.Tensor, float], bc1: float,
                      bc2: float) -> None:
  """One leaf's AdamW step in place, given the step's scalars: the
  learning rate, the clip factor and the two bias corrections."""
  g = g.float() * scale
  if cfg.quantize_state:
    m_f = _dq8(m["codes"], m["scale"], p.shape)
    v_f = _dq8(v["codes"], v["scale"], p.shape)
  else:
    m_f, v_f = m, v
  m_new = m_f * cfg.b1 + g * (1 - cfg.b1)
  v_new = v_f * cfg.b2 + g * (1 - cfg.b2) * g
  mh = exact.div(m_new, float(bc1))
  vh = exact.div(v_new, float(bc2))
  pf = p.float()
  delta = mh / (_sqrt(vh) + cfg.eps) + pf * cfg.weight_decay
  p.copy_((pf - delta * float(lr)).to(p.dtype))
  if cfg.quantize_state:
    for state, new in ((m, m_new), (v, v_new)):
      codes, sc = _q8(new)
      state["codes"].copy_(codes)
      state["scale"].copy_(sc)
  else:
    m.copy_(m_new)
    v.copy_(v_new)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Params,
                 grads: Mapping[str, torch.Tensor],
                 state: Dict) -> Tuple[Params, Dict, Dict]:
  """One step in place; returns ``(params, state, {"lr", "grad_norm"})``
  (``grad_norm`` left on the device)."""
  step = state["step"] + 1
  lr = lr_at(cfg, step)
  gnorm = global_norm(grads[n] for n in params)
  scale: Union[torch.Tensor, float] = 1.0
  if cfg.grad_clip:
    scale = torch.clamp_max(
        exact.div(cfg.grad_clip, torch.clamp_min(gnorm, 1e-12)), 1.0)
  bc1, bc2 = bias_corrections(cfg, step)
  try:
    for name, p in params.items():
      adamw_leaf_update(cfg, p, grads[name], state["m"][name],
                        state["v"][name], lr, scale, bc1, bc2)
  except Exception as e:
    raise PartialUpdateError(
        f"AdamW step {step} failed after its first in-place write") from e
  state["step"] = step
  return params, state, {"lr": float(lr), "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# SGD + Nesterov (paper Sec. 4.3 CIFAR recipe)
# ---------------------------------------------------------------------------

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
