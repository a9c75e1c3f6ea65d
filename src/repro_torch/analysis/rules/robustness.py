"""Robustness pack (ROB*): failures must surface, not vanish.

The resilience layer (``explore/resilience.py``) gives every failure a
typed path: retryable errors re-execute through ``RetryPolicy``, rung
exhaustion demotes down the device->host ladder, and anything terminal
is journaled and re-raised as ``ChunkError`` with the failing chunk's
global index.  That accounting only works if exceptions actually reach
it — a bare ``except:`` or a handler that silently discards the error
hides faults from the retry/demotion counters and turns a diagnosable
chunk failure into a wrong-answer sweep.  These rules keep the
exploration stack's handlers honest.

The port adds the no-fallback rule (ROB004): a kernel's plain version
runs only because its tensor lies on the CPU, never because CUDA is
missing or a launch failed, so a card that cannot run the kernel raises
instead of quietly producing the CPU's numbers and timings.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import config
from repro_torch.analysis.engine import Finding, attr_chain
from repro_torch.analysis.registry import Rule, register
from repro_torch.analysis.rules._reach import enclosing_function, parents


def _in_robustness_scope(rel: str) -> bool:
  return rel.startswith(config.ROBUSTNESS_DIRS)


def _swallows(handler: ast.ExceptHandler) -> bool:
  """True when the handler body discards the exception without acting.

  A body counts as swallowing when every statement is ``pass``, ``...``,
  or a bare constant (docstring-style) — no re-raise, no logging, no
  fallback value, no state update.
  """
  for stmt in handler.body:
    if isinstance(stmt, ast.Pass):
      continue
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
      continue
    return False
  return True


@register
class BareExcept(Rule):
  id = "ROB001"
  pack = "robustness"
  summary = ("bare except / silently swallowed exception in the "
             "exploration stack")
  instead = ("catch a concrete type and re-raise, demote, or return an "
             "explicit sentinel")

  def check_module(self, mod, ctx):
    if not _in_robustness_scope(mod.rel):
      return
    for node in ast.walk(mod.tree):
      if not isinstance(node, ast.ExceptHandler):
        continue
      if node.type is None:
        yield Finding(
            self.id, mod.rel, node.lineno, node.col_offset,
            "bare 'except:' catches SystemExit/KeyboardInterrupt and "
            "hides the failure from the resilience layer's retry/"
            "demotion accounting; catch a concrete exception type and "
            "let everything else propagate to ChunkError")
      elif _swallows(node):
        yield Finding(
            self.id, mod.rel, node.lineno, node.col_offset,
            "exception handler discards the error without acting "
            "(body is only pass/...); re-raise, degrade to a fallback "
            "rung, or return an explicit sentinel so the failure stays "
            "visible to retry/demotion accounting")


def _has_timeout(call: ast.Call) -> bool:
  return any(kw.arg == "timeout" for kw in call.keywords)


@register
class UnboundedJoin(Rule):
  id = "ROB002"
  pack = "robustness"
  summary = ("unbounded thread/executor join or wait in the exploration "
             "stack")
  instead = "join(timeout)/wait(timeout=...) in a re-arming loop"

  def check_module(self, mod, ctx):
    """Flags waits that can block forever in ``explore/``:

    * zero-argument ``.join()`` — a hung worker (the exact failure the
      resilience watchdog exists for) wedges the caller with it; pass a
      timeout and handle the still-alive case,
    * zero-argument ``.wait()`` — an ``Event``/``Condition`` wait with
      no timeout never re-checks cancellation or deadlines,
    * ``wait(futures)`` (the ``concurrent.futures`` form) without a
      ``timeout=``/second positional — one lost future stalls the whole
      dispatch loop.

    String/path ``.join(parts)`` calls carry an argument, so only the
    thread-shaped zero-argument form is flagged.
    """
    if not _in_robustness_scope(mod.rel):
      return
    for node in ast.walk(mod.tree):
      if not isinstance(node, ast.Call):
        continue
      fn = node.func
      if isinstance(fn, ast.Attribute) and fn.attr in ("join", "wait") \
          and not node.args and not _has_timeout(node):
        yield Finding(
            self.id, mod.rel, node.lineno, node.col_offset,
            f"zero-argument .{fn.attr}() blocks forever if the other "
            "side hangs — the resilience layer's watchdog/cancellation "
            "never gets a chance; pass a timeout and re-check "
            "deadline/cancel state in a loop")
      elif (isinstance(fn, ast.Name) and fn.id == "wait"
            and len(node.args) < 2 and not _has_timeout(node)):
        yield Finding(
            self.id, mod.rel, node.lineno, node.col_offset,
            "concurrent.futures.wait without timeout= stalls the "
            "dispatch loop on a single lost future; use "
            "timeout=POOL_WAIT_SECONDS in a re-arming loop")


@register
class DirectDeviceEnumeration(Rule):
  id = "ROB003"
  pack = "robustness"
  summary = ("direct torch.cuda.device_count() outside "
             "explore/fleet.py::visible_devices")
  instead = "repro_torch.explore.fleet.visible_devices() or a DevicePool"

  def check_module(self, mod, ctx):
    """Flags ``torch.cuda.device_count()`` anywhere but
    ``explore/fleet.py::visible_devices`` (tree-wide, not just
    ``explore/``).  Direct enumeration hands code a device the fleet layer
    may have quarantined — a lost or silently-corrupting card looks
    exactly like a healthy one to ``device_count()``.  Go through
    ``repro_torch.explore.fleet.visible_devices()`` (or a ``DevicePool``)
    so placement stays health-aware.
    """
    for node in ast.walk(mod.tree):
      if not isinstance(node, ast.Call) \
          or attr_chain(node.func) != config.DEVICE_ENUM_CALL:
        continue
      fn = enclosing_function(mod, node)
      if mod.rel == config.DEVICE_ENUM_MODULE and fn is not None \
          and fn.name == config.DEVICE_ENUM_FUNCTION:
        continue
      yield Finding(
          self.id, mod.rel, node.lineno, node.col_offset,
          "direct torch.cuda.device_count() bypasses the fleet health "
          "registry (quarantined/lost cards look healthy); use "
          "repro_torch.explore.fleet.visible_devices() or a DevicePool")


def _exits(stmts) -> bool:
  """Does this branch raise or end the process?"""
  for stmt in stmts:
    for node in ast.walk(stmt):
      if isinstance(node, ast.Raise):
        return True
      if isinstance(node, ast.Call) \
          and attr_chain(node.func) in config.EXIT_CALLS:
        return True
  return False


def _guarding_if(mod, node: ast.AST):
  """The ``if``/``assert`` statement whose test holds ``node``, or None
  when ``node`` sits anywhere else (an assignment, a conditional
  expression, an argument)."""
  up = parents(mod)
  child, cur = node, up.get(node)
  while cur is not None and not isinstance(cur, ast.stmt):
    child, cur = cur, up.get(cur)
  if isinstance(cur, ast.If) and child is cur.test:
    return cur
  if isinstance(cur, ast.Assert):
    return cur
  return None


def _kernel_names(mod):
  """Local names bound to a kernel package's kernel/ops module (aliases)
  and to functions imported from one."""
  modules, funcs = {"_kernel"}, set()
  for node in ast.walk(mod.tree):
    if isinstance(node, ast.Import):
      for a in node.names:
        if config.KERNEL_MODULE_RE.search(a.name) and a.asname:
          modules.add(a.asname)
    elif isinstance(node, ast.ImportFrom) and node.module:
      for a in node.names:
        local = a.asname or a.name
        if config.KERNEL_MODULE_RE.search(f"{node.module}.{a.name}"):
          modules.add(local)
        elif config.KERNEL_MODULE_RE.search(node.module):
          funcs.add(local)
  return modules, funcs


def _launches_kernel(stmts, modules, funcs) -> bool:
  for stmt in stmts:
    for node in ast.walk(stmt):
      if not isinstance(node, ast.Call):
        continue
      chain = attr_chain(node.func)
      if (len(chain) >= 2 and chain[0] in modules) \
          or (len(chain) == 1 and chain[0] in funcs):
        return True
      f = node.func
      if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Call) \
          and attr_chain(f.value.func)[-1] == "_lib":
        return True
  return False


def _plain_call(node: ast.Call) -> bool:
  chain = attr_chain(node.func)
  return config.PLAIN_MODULE_ALIAS in chain[:-1] \
      or chain[-1].endswith(config.PLAIN_SUFFIX)


@register
class Fallback(Rule):
  id = "ROB004"
  pack = "robustness"
  summary = ("fallback to the CPU or a plain version: a "
             "torch.cuda.is_available() branch that neither raises nor "
             "exits, a _ref/*_ref call in an except handler, a try around "
             "a kernel launch whose handler returns")
  instead = ("pick the plain version by the tensor's device only "
             "(ops.py: `if x.device.type == 'cpu'`); raise otherwise")

  def check_module(self, mod, ctx):
    modules, funcs = _kernel_names(mod)
    in_handler = set()  # a plain call in nested handlers counts once
    for node in ast.walk(mod.tree):
      if isinstance(node, ast.Call) \
          and attr_chain(node.func) == config.CUDA_PROBE:
        guard = _guarding_if(mod, node)
        if guard is None or not (
            isinstance(guard, ast.Assert)
            or _exits(guard.body) or _exits(guard.orelse)):
          yield Finding(
              self.id, mod.rel, node.lineno, node.col_offset,
              "torch.cuda.is_available() chooses a path without raising "
              "or exiting on either branch: a missing card would silently "
              "run the CPU's version — raise (or exit) when CUDA is asked "
              "for and absent")
      elif isinstance(node, ast.ExceptHandler):
        for stmt in node.body:
          for n in ast.walk(stmt):
            if isinstance(n, ast.Call) and _plain_call(n) \
                and n not in in_handler:
              in_handler.add(n)
              yield Finding(
                  self.id, mod.rel, n.lineno, n.col_offset,
                  "plain version called in an except handler: a failed "
                  "kernel would silently answer with the CPU path — "
                  "let the error propagate")
      elif isinstance(node, ast.Try) \
          and _launches_kernel(node.body, modules, funcs):
        for handler in node.handlers:
          if any(isinstance(n, ast.Return)
                 for stmt in handler.body for n in ast.walk(stmt)):
            yield Finding(
                self.id, mod.rel, handler.lineno, handler.col_offset,
                "handler returns from a try around a kernel launch: a "
                "launch that fails would quietly hand back another "
                "result — let the error propagate")
