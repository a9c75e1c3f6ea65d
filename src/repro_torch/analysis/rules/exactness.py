"""Exactness pack (EXA*): the parity_max_rel_err == 0.0 contract on a card.

The exact device path is bit-identical to numpy because the parity-
critical modules restrict themselves to forms the probe
(``repro_torch.explore.device.probe_exactness``) finds exact on the card
and host-precompute everything else
(:func:`repro_torch.core.oracle.batch_inputs`).  The probe names seven
forms that differ from numpy on the card, and each has a rule here:

  F1, F3  ``float / tensor``, a Python-number or CPU-scalar divisor,
          floor division                                        EXA005
  F2, F6  torch's sqrt, CUDA's ceil(log2(words)), the other
          transcendentals                                       EXA002
  F4      forms that contract a multiply and an add (addcmul, lerp,
          torch.compile, the optimizers, ...)                   EXA006
  F5      top-k and unstable sorts on tied keys                 EXA007
  F7      data-dependent shapes (nonzero, unique, ...)          EXA008

A ``torch.`` call is a tensor op wherever it sits, so those rules look at
every ``torch.<op>(...)`` of their modules.  A method call or an operator
(``x.sum()``, ``a / b``, ``x ** 0.5``) is a tensor op only where its
operands are tensors, so those forms are checked in *array context*
(:mod:`._reach`): functions annotated with ``torch.Tensor``, the device
programs and what the batch oracle reaches.  The scalar oracle and the
host numpy of ``batch_inputs`` stay outside: they ARE the reference the
exact path is held to.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis import config
from repro_torch.analysis.engine import Finding, attr_chain
from repro_torch.analysis.registry import Rule, register
from repro_torch.analysis.rules._reach import (array_context_nodes, parents)

_UPPER = re.compile(r"^_?[A-Z][A-Z0-9_]*$")


def _exact_scope(rel: str) -> bool:
  """Modules held to EXA005-EXA007: the float64 modules and the f32
  bit-equal optimizer."""
  return rel in config.PARITY_CRITICAL or rel in config.BIT_EQUAL_F32


def _torch_op(node: ast.Call):
  """``op`` when the call is ``torch.<op>(...)`` or a deeper torch
  namespace (``torch.linalg.<op>``, ``torch.nn.functional.<op>``)."""
  chain = attr_chain(node.func)
  if len(chain) >= 2 and chain[0] == "torch":
    return chain[-1]
  return None


def _method(node: ast.Call):
  """``name`` for ``<expr>.name(...)`` on something that may be a tensor
  (not a call into torch's or a host module's namespace)."""
  if not isinstance(node.func, ast.Attribute):
    return None
  head = attr_chain(node.func)[0]
  if head == "torch" or head in config.HOST_MODULES:
    return None
  return node.func.attr


def _scalar(node: ast.AST) -> bool:
  """A pure Python-scalar expression: numeric literals, UPPER_CASE
  constants, ``math``'s constants and functions of them, and arithmetic
  on those."""
  if isinstance(node, ast.Constant):
    return isinstance(node.value, (int, float)) \
        and not isinstance(node.value, bool)
  if isinstance(node, ast.Name):
    return bool(_UPPER.match(node.id))
  if isinstance(node, ast.Attribute):
    return bool(_UPPER.match(node.attr)) or attr_chain(node)[0] == "math"
  if isinstance(node, ast.UnaryOp):
    return _scalar(node.operand)
  if isinstance(node, ast.BinOp):
    return _scalar(node.left) and _scalar(node.right)
  if isinstance(node, ast.Call):
    chain = attr_chain(node.func)
    return chain[0] == "math" and all(_scalar(a) for a in node.args)
  return False


def _host_number(node: ast.AST) -> bool:
  """An operand that is a Python number (or a 0-d tensor on the CPU)."""
  if _scalar(node):
    return True
  if isinstance(node, ast.Call):
    chain = attr_chain(node.func)
    if chain in (("float",), ("int",)):
      return True
    if len(chain) == 2 and chain[0] == "torch" \
        and chain[1] in config.SCALAR_TENSOR_FACTORIES \
        and not any(kw.arg == "device" for kw in node.keywords):
      return True
  return False


def _kw_true(node: ast.Call, name: str) -> bool:
  return any(kw.arg == name and isinstance(kw.value, ast.Constant)
             and kw.value.value is True for kw in node.keywords)


@register
class LowPrecision(Rule):
  id = "EXA001"
  pack = "exactness"
  summary = ("float32/half/bfloat16 dtype or cast in a float64 module "
             "(core/oracle, core/dataflow, core/ppa, core/exact, "
             "explore/device)")
  instead = "float64 end to end; low precision belongs outside these modules"

  def check_module(self, mod, ctx):
    if mod.rel not in config.PARITY_CRITICAL:
      return
    for node in ast.walk(mod.tree):
      hit = None
      if isinstance(node, ast.Attribute):
        chain = attr_chain(node)
        if len(chain) == 2 and (
            (chain[0] == "torch" and chain[1] in config.LOW_PRECISION_DTYPES)
            or (chain[0] in ("np", "numpy") and chain[1] == "float32")):
          hit = ".".join(chain)
      elif isinstance(node, ast.Call) and not node.args \
          and _method(node) in config.LOW_PRECISION_CASTS:
        hit = f".{node.func.attr}()"
      elif isinstance(node, ast.Constant) \
          and node.value in config.LOW_PRECISION_STRINGS:
        hit = repr(node.value)
      if hit is not None:
        yield Finding(self.id, mod.rel, node.lineno, node.col_offset,
                      f"{hit} in a float64 module: the exact contract is "
                      "float64 end to end (low-precision modes live outside "
                      "the parity-critical modules)")


@register
class DivergentTranscendental(Rule):
  id = "EXA002"
  pack = "exactness"
  summary = ("transcendental or sqrt that differs from numpy on the card "
             "(F2, F6): torch.<op>, a tensor method, or a fractional ** in "
             "a float64 module")
  instead = ("host-precompute the column in oracle.batch_inputs with "
             "numpy's expression")

  def check_module(self, mod, ctx):
    if mod.rel not in config.PARITY_CRITICAL:
      return
    in_ctx = array_context_nodes(mod, ctx)
    for node in ast.walk(mod.tree):
      if isinstance(node, ast.Call):
        op = _torch_op(node)
        name = f"torch.{op}" if op in config.DIVERGENT_OPS else None
        if name is None and node in in_ctx \
            and _method(node) in config.DIVERGENT_OPS:
          name = f"<tensor>.{node.func.attr}"
        if name is not None:
          yield Finding(
              self.id, mod.rel, node.lineno, node.col_offset,
              f"{name}(...) differs from numpy's bits on the card (the "
              "probe's F2/F6) — host-precompute it into the inputs bundle "
              "(oracle.batch_inputs) or justify with a suppression")
      elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Pow) \
          and node in in_ctx and not _scalar(node.left) \
          and isinstance(node.right, ast.Constant) \
          and isinstance(node.right.value, float) \
          and not float(node.right.value).is_integer():
        yield Finding(
            self.id, mod.rel, node.lineno, node.col_offset,
            f"`** {node.right.value}` on a tensor is a pow call, which "
            "differs from numpy's on the card — host-precompute "
            "(oracle.batch_inputs) or justify with a suppression")


@register
class ReassociatingReduction(Rule):
  id = "EXA003"
  pack = "exactness"
  summary = ("reduction/contraction whose accumulation order the library "
             "picks (.sum/.mean/.prod, torch.sum/matmul/einsum/linalg.*, "
             "@) in a float64 module")
  instead = ("a fixed-order fold (core/ppa.poly_sum), or a suppression "
             "where the result is integer-exact or outside the contract")

  def check_module(self, mod, ctx):
    if mod.rel not in config.PARITY_CRITICAL:
      return
    in_ctx = array_context_nodes(mod, ctx)
    for node in ast.walk(mod.tree):
      name = None
      if isinstance(node, ast.Call):
        chain = attr_chain(node.func)
        if _torch_op(node) is not None and (
            (len(chain) == 2 and chain[1] in config.REASSOCIATING_CALLS)
            or chain[:2] == ("torch", "linalg")):
          name = ".".join(chain) + "(...)"
        elif node in in_ctx \
            and _method(node) in config.REASSOCIATING_METHODS:
          name = f"<tensor>.{node.func.attr}(...)"
      elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult) \
          and node in in_ctx:
        name = "`@`"
      if name is not None:
        yield Finding(
            self.id, mod.rel, node.lineno, node.col_offset,
            f"{name} lets the library pick the accumulation order — "
            "bit-identity needs a fixed-order fold (or a justified "
            "suppression when the result is integer-exact / outside the "
            "parity contract)")


@register
class DivergentOpWithoutRef(Rule):
  id = "EXA004"
  pack = "exactness"
  summary = ("kernel.py/ops.py uses torch ops that differ from numpy but "
             "its package ships no ref.py plain version to pin them")
  instead = "a sibling ref.py the CPU tests hold to the reference"

  def check_module(self, mod, ctx):
    if not config.KERNEL_WRAPPER_RE.search(mod.rel):
      return
    uses = []
    for node in ast.walk(mod.tree):
      if isinstance(node, ast.Call):
        chain = attr_chain(node.func)
        if len(chain) >= 2 and chain[-1] in config.DIVERGENT_OPS \
            and chain[0] in ("torch", "F"):
          uses.append((node, ".".join(chain)))
    if not uses:
      return
    ref = mod.rel.rsplit("/", 1)[0] + "/ref.py"
    if not ctx.has_file(ref):
      node, name = uses[0]
      yield Finding(
          self.id, mod.rel, node.lineno, node.col_offset,
          f"kernel wrapper calls {name}(...) (differs from numpy) but has "
          "no sibling ref.py — every kernel's numerics are pinned by a "
          "plain version the CPU tests hold to the reference")


@register
class InexactDivision(Rule):
  id = "EXA005"
  pack = "exactness"
  summary = ("division outside core/exact.py (F1, F3): `/` or `//` on a "
             "tensor, torch.div & co with a Python-number or CPU-scalar "
             "operand, reciprocal()")
  instead = "exact.div(a, b) / exact.floor_div(a, b)"

  def _flag(self, mod, node, what):
    return Finding(
        self.id, mod.rel, node.lineno, node.col_offset,
        f"{what}: on the card a Python-number or CPU-scalar divisor "
        "becomes a multiply by its reciprocal, and float / tensor is "
        "reciprocal-then-multiply (the probe's F1/F3) — divide with "
        "repro_torch.core.exact.div / floor_div")

  def check_module(self, mod, ctx):
    if not _exact_scope(mod.rel) or mod.rel == config.EXACT_DIVISION_MODULE:
      return
    in_ctx = array_context_nodes(mod, ctx)
    for node in ast.walk(mod.tree):
      if isinstance(node, ast.BinOp) \
          and isinstance(node.op, (ast.Div, ast.FloorDiv)) \
          and node in in_ctx \
          and not (_scalar(node.left) and _scalar(node.right)):
        op = "/" if isinstance(node.op, ast.Div) else "//"
        yield self._flag(mod, node, f"`{op}` in array context")
      elif isinstance(node, ast.AugAssign) \
          and isinstance(node.op, (ast.Div, ast.FloorDiv)) \
          and node in in_ctx:
        yield self._flag(mod, node, "in-place division in array context")
      elif isinstance(node, ast.Call):
        op = _torch_op(node)
        meth = _method(node) if node in in_ctx else None
        if op in config.DIVISION_CALLS \
            or (meth or "").rstrip("_") in config.DIVISION_CALLS:
          operands = list(node.args[:2]) if op else list(node.args[:1])
          if any(_host_number(a) for a in operands):
            name = f"torch.{op}" if op else f"<tensor>.{meth}"
            yield self._flag(mod, node, f"{name}(...) with a host number")
        elif config.RECIPROCAL in (op, (meth or "").rstrip("_")):
          yield self._flag(mod, node, "reciprocal()")


def _maximal_attribute(mod, node: ast.Attribute) -> bool:
  up = parents(mod).get(node)
  return not (isinstance(up, ast.Attribute) and up.value is node)


@register
class FusedMultiplyAdd(Rule):
  id = "EXA006"
  pack = "exactness"
  summary = ("form that fuses a multiply and an add or picks its own order "
             "(F4): addcmul/addcdiv/lerp/addmm/addmv/addbmm/baddbmm/addr, "
             "add/sub with alpha=, torch._foreach_*, torch.optim, "
             "torch.compile, torch.jit.script/trace")
  instead = "a separate multiply and add per term, in the reference's order"

  def _flag(self, mod, node, name):
    return Finding(
        self.id, mod.rel, node.lineno, node.col_offset,
        f"{name} may contract a product and a sum into one FMA rounding or "
        "reorder the update (the probe's F4) — write each product and sum "
        "as its own tensor op, in the reference's order")

  def check_module(self, mod, ctx):
    if not _exact_scope(mod.rel):
      return
    in_ctx = array_context_nodes(mod, ctx)
    for node in ast.walk(mod.tree):
      if isinstance(node, ast.Call):
        op = _torch_op(node)
        meth = _method(node) if node in in_ctx else None
        base = (meth or "").rstrip("_")
        if op in config.FUSED_OPS or (op or "").startswith("_foreach_"):
          yield self._flag(mod, node, f"torch.{op}(...)")
        elif base in config.FUSED_OPS and meth in (base, base + "_"):
          yield self._flag(mod, node, f"<tensor>.{meth}(...)")
        elif (op in ("add", "sub") or base in ("add", "sub")) \
            and any(kw.arg == "alpha" for kw in node.keywords):
          yield self._flag(mod, node, "add/sub(..., alpha=)")
      elif isinstance(node, ast.Attribute) and _maximal_attribute(mod, node):
        chain = attr_chain(node)
        for prefix in config.FUSING_NAMESPACES:
          if chain[:len(prefix)] == prefix:
            yield self._flag(mod, node, ".".join(chain))
            break
      elif isinstance(node, ast.ImportFrom) and node.module:
        for a in node.names:
          full = tuple(node.module.split(".")) + (a.name,)
          if any(full[:len(p)] == p for p in config.FUSING_NAMESPACES):
            yield self._flag(mod, node, ".".join(full))


@register
class UnstableTies(Rule):
  id = "EXA007"
  pack = "exactness"
  summary = ("selection whose ties the library breaks (F5): torch.topk, "
             "kthvalue, sort/argsort without stable=True")
  instead = ("device._stable_topk_indices: torch.sort(key, stable=True)"
             ".indices[:k]")

  def check_module(self, mod, ctx):
    if not _exact_scope(mod.rel):
      return
    in_ctx = array_context_nodes(mod, ctx)
    for node in ast.walk(mod.tree):
      if not isinstance(node, ast.Call):
        continue
      op = _torch_op(node)
      meth = _method(node) if node in in_ctx else None
      name = None
      if op in config.UNSTABLE_SELECTIONS:
        name = f"torch.{op}"
      elif meth in config.UNSTABLE_SELECTIONS:
        name = f"<tensor>.{meth}"
      elif (op in config.SORTS or meth in config.SORTS) \
          and not _kw_true(node, "stable"):
        name = f"torch.{op}" if op else f"<tensor>.{meth}"
      if name is not None:
        yield Finding(
            self.id, mod.rel, node.lineno, node.col_offset,
            f"{name}(...) breaks ties in no set order on the card (the "
            "probe's F5), so fronts and top-k stop matching the host's "
            "lowest-index rule — use a stable sort "
            "(device._stable_topk_indices)")


@register
class HostSizedShape(Rule):
  id = "EXA008"
  pack = "exactness"
  summary = ("data-dependent output shape in array context (F7): "
             "torch.nonzero, masked_select, one-argument torch.where, "
             "torch.unique — the host waits for the card to learn the size")
  instead = "device._compact: a fixed-size scatter into a capped index list"

  def check_module(self, mod, ctx):
    in_ctx = array_context_nodes(mod, ctx)
    for node in ast.walk(mod.tree):
      if node not in in_ctx or not isinstance(node, ast.Call):
        continue
      op = _torch_op(node)
      meth = _method(node)
      name = None
      if op in config.HOST_SIZED_OPS:
        name = f"torch.{op}"
      elif meth in config.HOST_SIZED_OPS:
        name = f"<tensor>.{meth}"
      elif op == "where" and len(node.args) == 1 and not node.keywords:
        name = "torch.where(cond)"
      if name is not None:
        yield Finding(
            self.id, mod.rel, node.lineno, node.col_offset,
            f"{name}(...) has a data-dependent size, so the host waits for "
            "the card before the next chunk can dispatch (the probe's F7) "
            "— compact into a fixed-size index list (device._compact)")
