"""Analysis engine: file walk, suppressions, fingerprints, baseline.

The port's own copy of ``repro.analysis.engine``, with the same
suppression marker, fingerprints and baseline format, so one baseline
file and one suppression syntax serve both trees.  It is pure stdlib
(``ast``, ``json``): it imports neither torch nor numpy, so the pass
runs on any runner, a CPU box without a card included.

Suppressions
------------
``# repro: ignore[EXA005]`` on a line suppresses those rule ids on that
line; a comment-only line suppresses them on the next line.  Multiple
ids separated by commas.  Suppressed findings never reach the report
(they are counted, for the summary line).

Baseline
--------
Grandfathered findings live in a checked-in JSON file keyed by content
fingerprints: ``sha256(rule : path : stripped-source-line : occurrence)``
— stable under line-number drift, invalidated the moment the offending
line's text changes.  Baselined findings are reported but do not fail
the run; baseline entries that no longer match anything are flagged as
stale so the file shrinks as code is fixed.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import re
from pathlib import Path, PurePosixPath
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

_SUPPRESS_RE = re.compile(r"#\s*repro:\s*ignore\[([A-Za-z0-9_,\s-]+)\]")
PARSE_ERROR_RULE = "ANA001"  # reserved id: unparseable source file


# ---------------------------------------------------------------------------
# data model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Finding:
  """One rule violation at one source location."""
  rule: str
  path: str               # posix, relative to the scan root
  line: int               # 1-based
  col: int                # 0-based
  message: str
  fingerprint: str = ""   # filled by the engine (content-addressed)
  baselined: bool = False

  def location(self) -> str:
    return f"{self.path}:{self.line}:{self.col + 1}"


class Module:
  """One parsed source file plus its suppression map."""

  def __init__(self, path: Path, rel: str, source: str):
    self.path = path
    self.rel = rel
    self.source = source
    self.lines = source.splitlines()
    self.tree: Optional[ast.AST] = None
    self.parse_error: Optional[SyntaxError] = None
    try:
      self.tree = ast.parse(source)
    except SyntaxError as e:  # surfaced as an ANA001 finding
      self.parse_error = e
    self._suppressions = self._parse_suppressions()

  def _parse_suppressions(self) -> Dict[int, Set[str]]:
    sup: Dict[int, Set[str]] = {}
    for i, text in enumerate(self.lines, start=1):
      m = _SUPPRESS_RE.search(text)
      if not m:
        continue
      ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
      before = text[:m.start()].strip()
      target = i if before else i + 1  # comment-only line guards the next
      sup.setdefault(target, set()).update(ids)
    return sup

  def suppressed(self, line: int, rule: str) -> bool:
    return rule in self._suppressions.get(line, ())

  def line_text(self, line: int) -> str:
    if 1 <= line <= len(self.lines):
      return self.lines[line - 1].strip()
    return ""


@dataclasses.dataclass
class Context:
  """Everything the rules can see: the scanned modules plus the test
  sources (for cross-file contracts like "has a gpu-marked test")."""
  root: Path
  modules: List[Module]
  tests: Dict[str, str]   # test filename -> source text ({} if no dir)
  tests_dir: Optional[Path] = None
  # per-scan memo of tree-wide analyses (the reachability graph)
  cache: Dict[str, object] = dataclasses.field(default_factory=dict)

  def module(self, rel: str) -> Optional[Module]:
    for m in self.modules:
      if m.rel == rel:
        return m
    return None

  def has_file(self, rel: str) -> bool:
    return (self.root / PurePosixPath(rel)).is_file()


@dataclasses.dataclass
class Report:
  """Scan outcome after suppression + baseline application."""
  findings: List[Finding]          # everything not inline-suppressed
  inline_suppressed: int
  stale_baseline: List[dict]       # baseline entries matching nothing

  @property
  def new(self) -> List[Finding]:
    return [f for f in self.findings if not f.baselined]

  @property
  def baselined(self) -> List[Finding]:
    return [f for f in self.findings if f.baselined]

  @property
  def ok(self) -> bool:
    return not self.new


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

class Baseline:
  """Checked-in grandfathered findings (see module docstring)."""

  VERSION = 1

  def __init__(self, entries: Optional[List[dict]] = None):
    self.entries = list(entries or [])

  @classmethod
  def load(cls, path: Path) -> "Baseline":
    data = json.loads(path.read_text())
    if data.get("version") != cls.VERSION:
      raise ValueError(f"unsupported baseline version {data.get('version')}"
                       f" in {path} (expected {cls.VERSION})")
    return cls(data.get("entries", []))

  @classmethod
  def from_findings(cls, findings: Sequence[Finding],
                    justification: str = "TODO: justify or fix"
                    ) -> "Baseline":
    return cls([{
        "fingerprint": f.fingerprint, "rule": f.rule, "path": f.path,
        "line": f.line, "message": f.message,
        "justification": justification,
    } for f in findings])

  def save(self, path: Path) -> None:
    path.write_text(json.dumps(
        {"version": self.VERSION, "entries": self.entries},
        indent=2, sort_keys=True) + "\n")

  def fingerprints(self) -> Set[str]:
    return {e["fingerprint"] for e in self.entries}


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

def _assign_fingerprints(findings: List[Finding],
                         modules: Dict[str, Module]) -> None:
  """Content-addressed ids: (rule, path, stripped line text, occurrence
  index among identical triples) — stable when unrelated lines shift."""
  seen: Dict[Tuple[str, str, str], int] = {}
  for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
    mod = modules.get(f.path)
    text = mod.line_text(f.line) if mod else ""
    key = (f.rule, f.path, text)
    occ = seen.get(key, 0)
    seen[key] = occ + 1
    raw = f"{f.rule}:{f.path}:{text}:{occ}"
    f.fingerprint = hashlib.sha256(raw.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# walking + scanning
# ---------------------------------------------------------------------------

def _iter_py_files(path: Path) -> Iterable[Path]:
  if path.is_file():
    yield path
    return
  for p in sorted(path.rglob("*.py")):
    if "__pycache__" not in p.parts:
      yield p


def _load_modules(paths: Sequence[Path]) -> Tuple[Path, List[Module]]:
  """Parse every .py under ``paths``; rel paths are taken against the
  first path (the scan root) so rule scopes like ``core/`` resolve."""
  root = paths[0] if paths[0].is_dir() else paths[0].parent
  modules = []
  for base in paths:
    for p in _iter_py_files(base):
      try:
        rel = p.relative_to(root).as_posix()
      except ValueError:
        rel = p.name
      modules.append(Module(p, rel, p.read_text()))
  return root, modules


def find_tests_dir(root: Path) -> Optional[Path]:
  """Auto-detect the repo's tests/ next to the scan root (walk up a few
  levels looking for a ``tests`` directory beside a ``pytest.ini`` or
  ``.git``)."""
  cur = root.resolve()
  for _ in range(5):
    cand = cur / "tests"
    if cand.is_dir() and any((cur / m).exists()
                             for m in ("pytest.ini", "setup.py",
                                       "pyproject.toml", ".git")):
      return cand
    if cur.parent == cur:
      break
    cur = cur.parent
  return None


def scan_paths(paths: Sequence[Path], tests_dir: Optional[Path] = None,
               baseline: Optional[Baseline] = None,
               rules: Optional[Iterable[str]] = None) -> Report:
  """Run every registered rule over ``paths``; apply suppressions and the
  baseline; return the :class:`Report`.

  ``tests_dir=None`` auto-detects (pass a non-existent path to disable).
  ``rules`` optionally restricts to a subset of rule ids.
  """
  from repro_torch.analysis import rules as _rules  # noqa: F401 (registers packs)
  from repro_torch.analysis.registry import RULES, iter_rules

  paths = [Path(p) for p in paths]
  root, modules = _load_modules(paths)
  if tests_dir is None:
    tests_dir = find_tests_dir(root)
  tests: Dict[str, str] = {}
  if tests_dir is not None and tests_dir.is_dir():
    tests = {p.name: p.read_text() for p in sorted(tests_dir.glob("*.py"))}
  ctx = Context(root=root, modules=modules, tests=tests, tests_dir=tests_dir)

  selected = list(iter_rules()) if rules is None \
      else [RULES[r] for r in rules]
  raw: List[Finding] = []
  for mod in modules:
    if mod.parse_error is not None:
      e = mod.parse_error
      raw.append(Finding(PARSE_ERROR_RULE, mod.rel, e.lineno or 1,
                         (e.offset or 1) - 1, f"syntax error: {e.msg}"))
      continue
    for rule in selected:
      raw.extend(rule.check_module(mod, ctx))
  for rule in selected:
    raw.extend(rule.check_tree(ctx))

  mod_by_rel = {m.rel: m for m in modules}
  kept: List[Finding] = []
  suppressed = 0
  for f in raw:
    mod = mod_by_rel.get(f.path)
    if mod is not None and mod.suppressed(f.line, f.rule):
      suppressed += 1
    else:
      kept.append(f)
  kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
  _assign_fingerprints(kept, mod_by_rel)

  stale: List[dict] = []
  if baseline is not None:
    fps = {f.fingerprint for f in kept}
    for f in kept:
      if f.fingerprint in baseline.fingerprints():
        f.baselined = True
    stale = [e for e in baseline.entries if e["fingerprint"] not in fps]
  return Report(findings=kept, inline_suppressed=suppressed,
                stale_baseline=stale)


# ---------------------------------------------------------------------------
# shared AST helpers (used by the rule packs)
# ---------------------------------------------------------------------------

def attr_chain(node: ast.AST) -> Tuple[str, ...]:
  """Dotted-name parts of a Name/Attribute chain, outermost first:
  ``np.random.RandomState`` -> ("np", "random", "RandomState");
  non-chains (calls, subscripts...) terminate with "?"."""
  parts: List[str] = []
  while isinstance(node, ast.Attribute):
    parts.append(node.attr)
    node = node.value
  if isinstance(node, ast.Name):
    parts.append(node.id)
  else:
    parts.append("?")
  return tuple(reversed(parts))


def walk_functions(tree: ast.AST):
  """Yield every (possibly nested) function definition node."""
  for node in ast.walk(tree):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
      yield node


def func_params(fn) -> Set[str]:
  a = fn.args
  names = [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
  if a.vararg:
    names.append(a.vararg.arg)
  if a.kwarg:
    names.append(a.kwarg.arg)
  return set(names)
