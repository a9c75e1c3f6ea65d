"""Rule registry: every rule is a singleton with a stable id and pack.

A rule sees one module at a time (:meth:`Rule.check_module`) and, after
the walk, the whole tree (:meth:`Rule.check_tree`) for cross-file
contracts (kernel siblings, test references).  Rules yield raw findings;
the engine owns suppression, baselining and fingerprints.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Iterable, Iterator, Type

if TYPE_CHECKING:  # pragma: no cover - typing only
  from repro_torch.analysis.engine import Context, Finding, Module


class Rule:
  """One checkable invariant.  Subclasses set the class attributes and
  override one (or both) of the check hooks."""

  id: str = ""            # e.g. "EXA005"
  pack: str = ""          # "determinism" | "exactness" | "graph-purity" | ...
  summary: str = ""       # one-line catalog entry (README's rule table)
  instead: str = ""       # what to write instead (--list-rules, README)

  def check_module(self, mod: "Module", ctx: "Context"
                   ) -> Iterable["Finding"]:
    return ()

  def check_tree(self, ctx: "Context") -> Iterable["Finding"]:
    return ()


RULES: Dict[str, Rule] = {}


def register(cls: Type[Rule]) -> Type[Rule]:
  """Class decorator: instantiate and index the rule by id."""
  inst = cls()
  if not inst.id or not inst.pack:
    raise ValueError(f"rule {cls.__name__} must set id and pack")
  if inst.id in RULES:
    raise ValueError(f"duplicate rule id {inst.id}")
  RULES[inst.id] = inst
  return cls


def iter_rules() -> Iterator[Rule]:
  # The packs register themselves on import; pull them in here so direct
  # catalog queries (--list-rules) see the same set scan_paths does.
  import repro_torch.analysis.rules  # noqa: F401  (registration side effect)
  for rid in sorted(RULES):
    yield RULES[rid]
