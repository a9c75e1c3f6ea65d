"""Determinism pack (DET*): sweeps must be replayable from their seeds.

Every number the exploration stack produces is either a pure function of
a config table or derived from an explicitly seeded RNG; the streaming
engine's chunk-order-invariance proofs assume it.  These rules catch the
ways that silently stops being true: numpy's module-global RNG (as the
reference), and torch's hidden default generator, which every
``torch.rand*`` call and in-place ``Tensor.uniform_``-style fill draws
from unless handed ``generator=``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import config
from repro_torch.analysis.engine import Finding, attr_chain
from repro_torch.analysis.registry import Rule, register
from repro_torch.analysis.rules._reach import parents


def _in_determinism_scope(rel: str) -> bool:
  return rel.startswith(config.DETERMINISM_DIRS)


def _np_random_call(node: ast.Call):
  """('np'|'numpy', fn) when the call is np.random.<fn>(...), else None."""
  chain = attr_chain(node.func)
  if len(chain) == 3 and chain[0] in ("np", "numpy") \
      and chain[1] == "random":
    return chain[2]
  return None


def _has_generator(node: ast.Call) -> bool:
  return any(kw.arg == "generator" for kw in node.keywords)


def _torch_global_draw(node: ast.Call) -> str:
  """The name of a torch call that draws from (or seeds) the default
  generator, or ''."""
  chain = attr_chain(node.func)
  if chain[0] == "torch" and chain[-1] in ("manual_seed", "manual_seed_all"):
    return ".".join(chain)
  if _has_generator(node):
    return ""
  if len(chain) == 2 and chain[0] == "torch" \
      and chain[1] in config.TORCH_RNG_CALLS:
    return ".".join(chain)
  if isinstance(node.func, ast.Attribute) \
      and node.func.attr in config.TORCH_RNG_METHODS:
    return "<tensor>." + node.func.attr if chain[0] != "torch" \
        else ".".join(chain)
  return ""


@register
class GlobalRandom(Rule):
  id = "DET001"
  pack = "determinism"
  summary = ("call into a hidden global RNG: numpy's np.random.<fn>, or "
             "torch's default generator (torch.rand*/randperm/normal/"
             "bernoulli/multinomial, Tensor.uniform_-style fills without "
             "generator=, torch.manual_seed) in core/explore/kernels/data")
  instead = ("a seeded np.random.RandomState, or a torch.Generator seeded "
             "with .manual_seed(derive_seed(...)) passed as generator=")

  def check_module(self, mod, ctx):
    scoped = _in_determinism_scope(mod.rel)
    for node in ast.walk(mod.tree):
      if not isinstance(node, ast.Call):
        continue
      fn = _np_random_call(node)
      if fn is not None and fn not in config.SEEDED_RNG_FACTORIES:
        yield Finding(self.id, mod.rel, node.lineno, node.col_offset,
                      f"np.random.{fn}(...) draws from the process-global "
                      "RNG; construct a seeded np.random.RandomState / "
                      "default_rng and draw from it")
        continue
      name = _torch_global_draw(node) if scoped else ""
      if name:
        yield Finding(self.id, mod.rel, node.lineno, node.col_offset,
                      f"{name}(...) uses torch's process-global default "
                      "generator, which any other caller advances; draw "
                      "with generator= from a torch.Generator seeded by "
                      "repro_torch.core.seeding.derive_seed")


def _statement(mod, node: ast.AST) -> ast.AST:
  up = parents(mod)
  cur = node
  while cur in up and not isinstance(cur, ast.stmt):
    cur = up[cur]
  return cur


@register
class UnseededRngFactory(Rule):
  id = "DET002"
  pack = "determinism"
  summary = ("RNG constructed without a seed (entropy from the OS): "
             "np.random.RandomState()/default_rng(), torch.seed(), a "
             "torch.Generator(...) not seeded in the same statement")
  instead = ("np.random.RandomState(derive_seed(...)); "
             "torch.Generator(device=d).manual_seed(derive_seed(...))")

  def check_module(self, mod, ctx):
    for node in ast.walk(mod.tree):
      if not isinstance(node, ast.Call):
        continue
      fn = _np_random_call(node)
      if fn in ("RandomState", "default_rng") and not node.args \
          and not node.keywords:
        yield Finding(self.id, mod.rel, node.lineno, node.col_offset,
                      f"np.random.{fn}() without a seed pulls OS entropy; "
                      "pass an explicit seed (see "
                      "repro_torch.core.seeding.derive_seed)")
        continue
      chain = attr_chain(node.func)
      if chain == ("torch", "seed"):
        yield Finding(self.id, mod.rel, node.lineno, node.col_offset,
                      "torch.seed() reseeds the default generator from OS "
                      "entropy; seed a torch.Generator explicitly (see "
                      "repro_torch.core.seeding.derive_seed)")
      elif chain[-1] == "Generator" and chain[0] == "torch":
        stmt = _statement(mod, node)
        seeded = any(isinstance(n, ast.Call)
                     and isinstance(n.func, ast.Attribute)
                     and n.func.attr == "manual_seed"
                     for n in ast.walk(stmt))
        if not seeded:
          yield Finding(self.id, mod.rel, node.lineno, node.col_offset,
                        "torch.Generator(...) starts from a fixed default "
                        "seed shared by every unseeded generator; chain "
                        ".manual_seed(derive_seed(...)) in the same "
                        "statement")


@register
class WallClock(Rule):
  id = "DET003"
  pack = "determinism"
  summary = ("wall-clock read (time.time / datetime.now) in deterministic "
             "numeric code")
  instead = "time.perf_counter / time.monotonic for durations; seeds for inputs"

  def check_module(self, mod, ctx):
    if not _in_determinism_scope(mod.rel):
      return
    for node in ast.walk(mod.tree):
      if isinstance(node, ast.Call):
        chain = attr_chain(node.func)
        if len(chain) >= 2 and chain[-2:] in config.WALL_CLOCK_CALLS:
          yield Finding(self.id, mod.rel, node.lineno, node.col_offset,
                        f"wall-clock read {'.'.join(chain)}(...) in "
                        f"{mod.rel}: results must be a function of seeds "
                        "and configs only (monotonic perf counters for "
                        "throughput metadata are fine)")


@register
class SetOrderIteration(Rule):
  id = "DET004"
  pack = "determinism"
  summary = ("iteration over a set drives numeric work in hash order "
             "(string hashing is per-process randomized)")
  instead = "sorted(the_set), or a list/tuple"

  def _set_valued(self, node: ast.AST) -> bool:
    if isinstance(node, ast.Set):
      return True
    return isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
        and node.func.id in ("set", "frozenset")

  def check_module(self, mod, ctx):
    if not _in_determinism_scope(mod.rel):
      return
    iters = []
    for node in ast.walk(mod.tree):
      if isinstance(node, ast.For):
        iters.append(node.iter)
      elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
        iters.extend(gen.iter for gen in node.generators)
    for it in iters:
      if self._set_valued(it):
        yield Finding(self.id, mod.rel, it.lineno, it.col_offset,
                      "iterating a set: order is hash-dependent "
                      "(PYTHONHASHSEED) — wrap in sorted(...) or iterate "
                      "a list/tuple")


@register
class AdHocSeedArithmetic(Rule):
  id = "DET005"
  pack = "determinism"
  summary = ("arithmetic seed derivation at an RNG constructor or "
             "manual_seed (collision/overflow-prone) instead of derive_seed")
  instead = "repro_torch.core.seeding.derive_seed(label, *components)"

  def check_module(self, mod, ctx):
    for node in ast.walk(mod.tree):
      if not isinstance(node, ast.Call):
        continue
      chain = attr_chain(node.func)
      if chain[-1] not in config.SEED_SINKS:
        continue
      for arg in node.args:
        if isinstance(arg, ast.BinOp):
          yield Finding(
              self.id, mod.rel, arg.lineno, arg.col_offset,
              f"ad-hoc seed arithmetic feeding {'.'.join(chain)}: linear "
              "seed maps collide (seed*k+i meets seed'*k+i') and overflow "
              "platform int bounds — derive child seeds with "
              "repro_torch.core.seeding.derive_seed(label, *components)")
