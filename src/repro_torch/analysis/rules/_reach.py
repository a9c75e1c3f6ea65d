"""Which functions of the port run on tensors, and which are device
programs?

The reference finds jit roots syntactically; the port has no tracer, so
its "traced" code is named by convention instead:

  * **device programs**: the nested functions returned by a builder in
    ``config.DEVICE_PROGRAM_BUILDERS`` (``make_eval_fn``/``make_joint_fn``
    return the per-chunk programs the backends run), and every function
    they reach;
  * **array context**: the device programs, every function reached from
    ``config.ARRAY_ROOTS`` (``oracle.characterize_batch`` and
    ``characterize_joint_dedup``), and any function that annotates a
    parameter or its return as ``torch.Tensor``; and, in any other
    function, the expressions on a value that comes from a torch
    constructor (``torch.zeros``, ``torch.from_numpy``, ...), from
    ``h2d`` or from ``.to(...)``, followed through the function's
    assignments in source order (``config.TENSOR_CONSTRUCTORS``).

Reachability follows plain calls across the scanned tree to fixpoint: a
``Name`` call to a function of the same module or one imported from the
scanned package (``from <pkg>.core.dataflow import f``), and
``alias.f(...)`` on an imported module of the package
(``from <pkg>.core import oracle``).  Method calls, functions passed as
values, memoized functions (``functools.cache``: their body runs once a
process, like a kernel library's build) and modules outside the scan
root are not followed.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis import config
from repro_torch.analysis.engine import Context, Module, attr_chain

FUNCTION_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)
_TENSOR_STR = re.compile(r"\bTensor\b")

FuncKey = Tuple[str, str]          # (module rel, function name)


def _modules_by_rel(ctx: Context) -> Dict[str, Module]:
  by_rel = ctx.cache.get("modules_by_rel")
  if by_rel is None:
    by_rel = ctx.cache["modules_by_rel"] = {m.rel: m for m in ctx.modules}
  return by_rel


def module_rel(dotted: str, level: int, importer: str,
               ctx: Context) -> Optional[str]:
  """Rel path of the scanned module an import names, or None when it
  lies outside the scan root (torch, numpy, the reference package)."""
  if level:
    base = importer.split("/")[:-1]
    if level > 1:
      base = base[:len(base) - (level - 1)]
    parts = base + (dotted.split(".") if dotted else [])
  else:
    parts = dotted.split(".")
    if parts[0] != ctx.root.name:
      return None
    parts = parts[1:]
  by_rel = _modules_by_rel(ctx)
  for cand in ("/".join(parts) + ".py", "/".join(parts + ["__init__.py"])):
    if cand in by_rel:
      return cand
  return None


def imports(mod: Module, ctx: Context
            ) -> Dict[str, Tuple[str, Optional[str]]]:
  """Local name -> (module rel, None) for an imported module of the
  scanned tree, (module rel, name) for an imported function."""
  out: Dict[str, Tuple[str, Optional[str]]] = {}
  for node in ast.walk(mod.tree):
    if isinstance(node, ast.Import):
      for a in node.names:
        rel = module_rel(a.name, 0, mod.rel, ctx)
        if rel and a.asname:
          out[a.asname] = (rel, None)
    elif isinstance(node, ast.ImportFrom):
      prefix = (node.module + ".") if node.module else ""
      for a in node.names:
        local = a.asname or a.name
        sub = module_rel(prefix + a.name, node.level, mod.rel, ctx)
        if sub:
          out[local] = (sub, None)
          continue
        rel = module_rel(node.module or "", node.level, mod.rel, ctx)
        if rel:
          out[local] = (rel, a.name)
  return out


def _functions(mod: Module) -> Dict[str, List[ast.AST]]:
  """The module-level functions by name: what a plain call from another
  function of the module (or an importer) can reach."""
  by_name: Dict[str, List[ast.AST]] = {}
  for node in mod.tree.body:
    if isinstance(node, FUNCTION_DEFS):
      by_name.setdefault(node.name, []).append(node)
  return by_name


def _index(ctx: Context):
  idx = ctx.cache.get("index")
  if idx is None:
    funcs = {m.rel: _functions(m) for m in ctx.modules if m.tree is not None}
    imps = {m.rel: imports(m, ctx) for m in ctx.modules if m.tree is not None}
    idx = ctx.cache["index"] = (funcs, imps)
  return idx


def callees(fn: ast.AST, rel: str, ctx: Context) -> Iterator[FuncKey]:
  """The (module, name) pairs ``fn`` calls that the scan can resolve."""
  funcs, imps = _index(ctx)
  local, imported = funcs.get(rel, {}), imps.get(rel, {})
  for node in ast.walk(fn):
    if not isinstance(node, ast.Call):
      continue
    f = node.func
    if isinstance(f, ast.Name):
      if f.id in local:
        yield rel, f.id
      elif f.id in imported and imported[f.id][1] is not None:
        yield imported[f.id]                                  # type: ignore
    elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
      target = imported.get(f.value.id)
      if target is not None and target[1] is None:
        yield target[0], f.attr


def _reach(ctx: Context, roots: Iterable[Tuple[str, ast.AST]]
           ) -> Set[ast.AST]:
  funcs, _ = _index(ctx)
  seen: Set[ast.AST] = set()
  todo = list(roots)
  while todo:
    rel, fn = todo.pop()
    if fn in seen:
      continue
    seen.add(fn)
    for crel, name in callees(fn, rel, ctx):
      for callee in funcs.get(crel, {}).get(name, ()):
        if callee not in seen and not _memoized(callee):
          todo.append((crel, callee))
  return seen


def _memoized(fn) -> bool:
  """``functools.cache``/``lru_cache``: the body runs once a process (a
  kernel library's build and load), not once a chunk."""
  return any(attr_chain(d.func if isinstance(d, ast.Call) else d)[-1]
             in ("cache", "lru_cache") for d in fn.decorator_list)


def _program_roots(ctx: Context) -> List[Tuple[str, ast.AST]]:
  funcs, _ = _index(ctx)
  roots = []
  for rel, builders in config.DEVICE_PROGRAM_BUILDERS.items():
    for name in builders:
      for builder in funcs.get(rel, {}).get(name, ()):
        returned = {r.value.id for r in ast.walk(builder)
                    if isinstance(r, ast.Return)
                    and isinstance(r.value, ast.Name)}
        roots.extend((rel, inner) for inner in ast.walk(builder)
                     if isinstance(inner, FUNCTION_DEFS)
                     and inner is not builder and inner.name in returned)
  return roots


def device_programs(ctx: Context) -> Set[ast.AST]:
  """FunctionDef nodes, tree-wide, reached from the device programs."""
  got = ctx.cache.get("device_programs")
  if got is None:
    got = ctx.cache["device_programs"] = _reach(ctx, _program_roots(ctx))
  return got


def _array_reached(ctx: Context) -> Set[ast.AST]:
  got = ctx.cache.get("array_reached")
  if got is None:
    funcs, _ = _index(ctx)
    roots = list(_program_roots(ctx))
    for rel, names in config.ARRAY_ROOTS.items():
      for name in names:
        roots.extend((rel, fn) for fn in funcs.get(rel, {}).get(name, ()))
    got = ctx.cache["array_reached"] = _reach(ctx, roots)
  return got


def _mentions_tensor(ann: Optional[ast.AST]) -> bool:
  if ann is None:
    return False
  for node in ast.walk(ann):
    if isinstance(node, (ast.Attribute, ast.Name)) \
        and attr_chain(node) in config.TENSOR_ANNOTATIONS:
      return True
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
        and _TENSOR_STR.search(node.value):
      return True
  return False


def annotated_as_tensor(fn) -> bool:
  a = fn.args
  params = a.posonlyargs + a.args + a.kwonlyargs + [
      p for p in (a.vararg, a.kwarg) if p is not None]
  return _mentions_tensor(fn.returns) \
      or any(_mentions_tensor(p.annotation) for p in params)


def array_context_functions(mod: Module, ctx: Context) -> Set[ast.AST]:
  """Functions of ``mod`` that run on tensors (see module docstring)."""
  reached = _array_reached(ctx)
  return {fn for fn in ast.walk(mod.tree) if isinstance(fn, FUNCTION_DEFS)
          and (fn in reached or annotated_as_tensor(fn))}


def _is_source(node: ast.AST) -> bool:
  """A call whose value is a tensor wherever it stands."""
  if not isinstance(node, ast.Call):
    return False
  chain = attr_chain(node.func)
  if len(chain) == 2 and chain[0] == "torch" \
      and chain[1] in config.TENSOR_CONSTRUCTORS:
    return True
  if chain and chain[-1] in config.TENSOR_TRANSFERS:
    return True
  return isinstance(node.func, ast.Attribute) \
      and node.func.attr in config.TENSOR_CASTS


def _tensor_valued(node: ast.AST, names: Set[str]) -> bool:
  """Whether ``node`` evaluates to a tensor, given the local ``names``
  known to hold one."""
  if isinstance(node, ast.Name):
    return node.id in names
  if _is_source(node):
    return True
  if isinstance(node, ast.BinOp):
    return _tensor_valued(node.left, names) \
        or _tensor_valued(node.right, names)
  if isinstance(node, ast.UnaryOp):
    return _tensor_valued(node.operand, names)
  if isinstance(node, ast.Subscript):
    return _tensor_valued(node.value, names)
  if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
    chain = attr_chain(node.func)
    if chain and chain[0] == "torch":
      return any(_tensor_valued(a, names) for a in node.args)
    return node.func.attr not in config.HOST_VALUE_METHODS \
        and _tensor_valued(node.func.value, names)
  return False


def _assigned_names(target: ast.AST) -> Iterator[str]:
  if isinstance(target, ast.Name):
    yield target.id
  elif isinstance(target, (ast.Tuple, ast.List)):
    for t in target.elts:
      yield from _assigned_names(t)


def tensor_value_nodes(fn: ast.AST) -> Set[ast.AST]:
  """The arithmetic, in-place arithmetic and method calls of ``fn`` on a
  tensor-valued expression: a torch constructor's, ``h2d``'s or ``.to``'s
  value, or a local name assigned one (followed in source order, twice
  round for loops)."""
  assigns = sorted((n for n in ast.walk(fn)
                    if isinstance(n, (ast.Assign, ast.AnnAssign,
                                      ast.AugAssign))
                    and n.value is not None),
                   key=lambda n: (n.lineno, n.col_offset))
  names: Set[str] = set()
  for _ in range(2):
    for a in assigns:
      if _tensor_valued(a.value, names):
        for t in (a.targets if isinstance(a, ast.Assign) else [a.target]):
          names.update(_assigned_names(t))
  return {n for n in ast.walk(fn)
          if (isinstance(n, (ast.BinOp, ast.Call))
              and _tensor_valued(n, names)
              and not (isinstance(n, ast.Call) and _is_source(n)))
          or (isinstance(n, ast.AugAssign)
              and _tensor_valued(n.target, names))}


def nodes_of(fns: Iterable[ast.AST]) -> Set[ast.AST]:
  """Every AST node inside the given functions."""
  nodes: Set[ast.AST] = set()
  for fn in fns:
    nodes.update(ast.walk(fn))
  return nodes


def array_context_nodes(mod: Module, ctx: Context) -> Set[ast.AST]:
  """Every node of the array-context functions of ``mod``, and the
  expressions on tensor values in its other functions."""
  key = ("array_context_nodes", mod.rel)
  got = ctx.cache.get(key)
  if got is None:
    fns = array_context_functions(mod, ctx)
    got = nodes_of(fns)
    for fn in ast.walk(mod.tree):
      if isinstance(fn, FUNCTION_DEFS) and fn not in fns:
        got |= tensor_value_nodes(fn)
    ctx.cache[key] = got
  return got


def program_nodes(mod: Module, ctx: Context) -> Dict[int, Tuple[ast.AST,
                                                                ast.AST]]:
  """id(node) -> (node, function) for every node of ``mod`` inside a
  device program (first function wins for nested ones)."""
  key = ("program_nodes", mod.rel)
  nodes = ctx.cache.get(key)
  if nodes is None:
    progs = device_programs(ctx)
    nodes = ctx.cache[key] = {}
    for fn in ast.walk(mod.tree):
      if fn in progs:
        for n in ast.walk(fn):
          nodes.setdefault(id(n), (n, fn))
  return nodes


def parents(mod: Module) -> Dict[ast.AST, ast.AST]:
  """Child -> parent map of ``mod``'s tree (built once per module)."""
  got = getattr(mod, "_parents", None)
  if got is None:
    got = {child: node for node in ast.walk(mod.tree)
           for child in ast.iter_child_nodes(node)}
    mod._parents = got  # type: ignore[attr-defined]
  return got


def enclosing_function(mod: Module, node: ast.AST):
  """The innermost function def containing ``node``, or None."""
  up = parents(mod)
  cur = up.get(node)
  while cur is not None and not isinstance(cur, FUNCTION_DEFS):
    cur = up.get(cur)
  return cur
