"""IEEE-exact division on tensors.

The exact sweep promises results bit-identical to numpy's separate-op
IEEE arithmetic.  Two torch forms of division break that promise:

  * ``python_float / tensor`` runs ``__rtruediv__`` as
    ``reciprocal(tensor) * python_float`` (two roundings);
  * on CUDA, dividing by a CPU scalar (a Python number or a 0-d CPU
    tensor) multiplies by the scalar's reciprocal instead of dividing,
    for true and for floor division alike.

Every division with a tensor operand therefore goes through :func:`div`
or :func:`floor_div`: a Python-number operand becomes a 0-d tensor on
the other operand's device (filled on the device, so no host sync), and
``torch.div`` then divides element by element in both cases.
"""
from __future__ import annotations

from typing import Union

import torch

Operand = Union[torch.Tensor, float, int]


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
  """``value`` as a 0-d tensor of ``like``'s dtype on ``like``'s device."""
  return torch.full((), value, dtype=like.dtype, device=like.device)


def _tensors(a: Operand, b: Operand):
  if not isinstance(a, torch.Tensor):
    a = _const(a, b)
  elif not isinstance(b, torch.Tensor):
    b = _const(b, a)
  return a, b


def div(a: Operand, b: Operand) -> torch.Tensor:
  """Correctly rounded ``a / b``; at least one operand is a tensor."""
  a, b = _tensors(a, b)
  return torch.div(a, b)


def floor_div(a: Operand, b: Operand) -> torch.Tensor:
  """numpy's float ``a // b`` (``fmod``-corrected floor of the quotient)."""
  a, b = _tensors(a, b)
  return torch.div(a, b, rounding_mode="floor")
