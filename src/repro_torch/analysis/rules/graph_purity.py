"""Graph-purity pack (JIT*): the device programs must stay pure device work.

The port's per-chunk programs (the closures ``device.make_eval_fn`` and
``make_joint_fn`` return, and everything they reach, see :mod:`._reach`)
run eagerly today, but their promise is the reference's jitted one:
survivors are "compacted into a fixed-size index list without a host
sync", so chunk ``i+1`` dispatches while chunk ``i`` still runs.  A host
read inside them (``.item()``, ``.cpu()``, a synchronize) stalls that
pipeline on every chunk, and any host side effect (a print, a global
write, host numpy on the inputs) would also break the CUDA-graph capture
the perf queue plans: a captured graph replays device work only.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import config
from repro_torch.analysis.engine import Finding, attr_chain
from repro_torch.analysis.registry import Rule, register
from repro_torch.analysis.rules._reach import program_nodes


@register
class PrintInProgram(Rule):
  id = "JIT001"
  pack = "graph-purity"
  summary = "print() inside a device program"
  instead = "report from the host side, after the chunk resolves"

  def check_module(self, mod, ctx):
    for node, fn in program_nodes(mod, ctx).values():
      if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
          and node.func.id == "print":
        yield Finding(self.id, mod.rel, node.lineno, node.col_offset,
                      f"print() in device program '{fn.name}' is host work "
                      "on every chunk and would not replay from a captured "
                      "graph — log on the host side once the chunk "
                      "resolves")


@register
class GlobalStateInProgram(Rule):
  id = "JIT002"
  pack = "graph-purity"
  summary = "global/nonlocal mutation inside a device program"
  instead = "thread state through arguments and return values"

  def check_module(self, mod, ctx):
    for node, fn in program_nodes(mod, ctx).values():
      if isinstance(node, (ast.Global, ast.Nonlocal)):
        kind = "global" if isinstance(node, ast.Global) else "nonlocal"
        yield Finding(self.id, mod.rel, node.lineno, node.col_offset,
                      f"{kind} statement in device program '{fn.name}': "
                      "host state a captured graph would not update; "
                      "thread state through arguments/returns instead")


@register
class HostNumpyInProgram(Rule):
  id = "JIT003"
  pack = "graph-purity"
  summary = "host numpy call inside a device program"
  instead = ("torch on the chunk's device, or a suppression for a "
             "constant computed from the plan alone")

  def check_module(self, mod, ctx):
    for node, fn in program_nodes(mod, ctx).values():
      if isinstance(node, ast.Call):
        chain = attr_chain(node.func)
        if chain[0] in ("np", "numpy") and len(chain) >= 2 \
            and chain[1] != "random":  # np.random is DET001's beat
          yield Finding(
              self.id, mod.rel, node.lineno, node.col_offset,
              f"host {'.'.join(chain)}(...) in device program "
              f"'{fn.name}' — host work on every chunk that a captured "
              "graph would freeze; use torch on the chunk's device, or "
              "justify (a constant of the plan) with a suppression")


@register
class HostSyncInProgram(Rule):
  id = "JIT004"
  pack = "graph-purity"
  summary = (".item()/.tolist()/.cpu()/.numpy()/synchronize() inside a "
             "device program")
  instead = ("keep values on the device; the pending chunk's resolve() "
             "copies them to the host")

  def check_module(self, mod, ctx):
    for node, fn in program_nodes(mod, ctx).values():
      if not isinstance(node, ast.Call) \
          or not isinstance(node.func, ast.Attribute):
        continue
      chain = attr_chain(node.func)
      if chain[-1] in config.HOST_COERCION_METHODS \
          and chain[0] not in config.HOST_MODULES:
        yield Finding(
            self.id, mod.rel, node.lineno, node.col_offset,
            f"host sync .{chain[-1]}(...) in device program '{fn.name}' "
            "waits for the card on every chunk (survivors must be "
            "compacted without a host sync) and cannot be captured in a "
            "CUDA graph — keep values on the device until the pending "
            "chunk resolves")
