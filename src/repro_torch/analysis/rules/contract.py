"""Contract-structure pack (CON*): the shapes the port's guarantees hang
off of.

Every kernel package of the port carries its CUDA source (``csrc/``), the
launch wrappers (``kernel.py``), the public wrappers that pick the kernel
for a CUDA tensor and the plain version for a CPU one (``ops.py``), and
that plain version (``ref.py``); two tests close the triangle: a CPU
test holding ``ref.py`` to the reference's kernel, and a ``gpu``-marked
test launching the kernel against ``ref.py`` on the card.  Every
streaming reducer implements the fold/result merge surface the
chunk-order-invariance proofs quantify over, and any ``device_spec`` it
offers must speak one of the spec types ``explore.device.build_plan``
can compile.  These rules keep new kernels/reducers from shipping
without their contract half.
"""
from __future__ import annotations

import ast
from typing import Set, Tuple

from repro_torch.analysis import config
from repro_torch.analysis.engine import Finding, attr_chain
from repro_torch.analysis.registry import Rule, register


def _kernel_packages(ctx):
  for mod in ctx.modules:
    m = config.KERNEL_PATH_RE.search(mod.rel)
    if m:
      yield mod, m.group(1)


@register
class KernelSiblings(Rule):
  id = "CON001"
  pack = "contract"
  summary = "kernel.py without its ref.py + ops.py siblings and csrc/ sources"
  instead = ("kernels/<name>/{csrc/<name>.cu, kernel.py, ops.py, ref.py}")

  def check_tree(self, ctx):
    for mod, name in _kernel_packages(ctx):
      pkg = mod.rel.rsplit("/", 1)[0]
      missing = [s for s in config.KERNEL_SIBLINGS
                 if not ctx.has_file(f"{pkg}/{s}")]
      if not (ctx.root / pkg / config.KERNEL_SOURCES_DIR).is_dir():
        missing.append(config.KERNEL_SOURCES_DIR + "/")
      if missing:
        yield Finding(
            self.id, mod.rel, 1, 0,
            f"kernel package '{name}' is missing {', '.join(missing)}: "
            "every kernel ships its CUDA source (csrc/), a plain torch "
            "version (ref.py) and the public wrapper that picks between "
            "them by the tensor's device (ops.py) beside kernel.py")


def _test_facts(source: str) -> Tuple[Set[str], bool]:
  """(modules a test file imports, whether it carries the gpu marker)."""
  try:
    tree = ast.parse(source)
  except SyntaxError:
    return set(), False
  names: Set[str] = set()
  marked = False
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      names.update(a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
      names.add(node.module)
      names.update(f"{node.module}.{a.name}" for a in node.names)
    elif isinstance(node, ast.Attribute) and node.attr == config.GPU_MARKER:
      marked = marked or attr_chain(node)[-3:-1] == ("pytest", "mark")
  return names, marked


def _imports_package(imported: Set[str], package: str) -> bool:
  return any(m == package or m.startswith(package + ".") for m in imported)


@register
class KernelTests(Rule):
  id = "CON002"
  pack = "contract"
  summary = ("kernel package without its two tests: a CPU test_torch_*.py "
             "holding it to the reference's kernel, and a gpu-marked test")
  instead = ("tests/test_torch_<area>.py importing <pkg>.kernels.<name> and "
             "repro.kernels.<name>; a @pytest.mark.gpu test launching it")

  def check_tree(self, ctx):
    if ctx.tests_dir is None:
      return  # no tests tree in view: nothing to assert against
    parsed = {name: _test_facts(src) for name, src in ctx.tests.items()}
    for mod, name in _kernel_packages(ctx):
      port = f"{ctx.root.name}.kernels.{name}"
      ref = f"{config.REFERENCE_PACKAGE}.kernels.{name}"
      cpu = any(fname.startswith(config.PORT_TEST_PREFIX)
                and _imports_package(imp, port) and _imports_package(imp, ref)
                for fname, (imp, _) in parsed.items())
      gpu = any(marked and _imports_package(imp, port)
                for imp, marked in parsed.values())
      missing = [what for what, ok in (
          (f"a {config.PORT_TEST_PREFIX}*.py importing {port} and {ref}",
           cpu),
          (f"a @pytest.mark.{config.GPU_MARKER} test importing {port}", gpu))
          if not ok]
      if missing:
        yield Finding(
            self.id, mod.rel, 1, 0,
            f"kernel '{name}' has no {' and no '.join(missing)} under "
            f"{ctx.tests_dir}: its plain version must be held to the "
            "reference on the CPU and its kernel to the plain version on "
            "the card")


def _reducer_classes(mod):
  for node in ast.walk(mod.tree):
    if isinstance(node, ast.ClassDef) and any(
        isinstance(b, ast.Name) and b.id == config.REDUCER_BASE
        for b in node.bases):
      yield node


def _methods(cls):
  return {n.name: n for n in cls.body
          if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


@register
class ReducerSurface(Rule):
  id = "CON003"
  pack = "contract"
  summary = ("streaming reducer missing the fold/result merge surface "
             "the chunk-order-invariance guarantees quantify over")
  instead = "define fold(frame, indices) and result() on the Reducer"

  def check_module(self, mod, ctx):
    if mod.rel != config.STREAMING_MODULE:
      return
    for cls in _reducer_classes(mod):
      methods = _methods(cls)
      missing = [m for m in config.REDUCER_REQUIRED_METHODS
                 if m not in methods]
      if missing:
        yield Finding(
            self.id, mod.rel, cls.lineno, cls.col_offset,
            f"Reducer subclass '{cls.name}' does not define "
            f"{', '.join(missing)}: every accumulator must consume "
            "chunks (fold) and emit its merge (result) so any chunk "
            "partition folds to the same answer")


@register
class DeviceSpecShape(Rule):
  id = "CON004"
  pack = "contract"
  summary = ("device_spec() returning something explore.device.build_plan "
             "cannot compile")
  instead = "return a ParetoSpec/TopKSpec/StatsSpec/HistSpec, or None"

  def check_module(self, mod, ctx):
    if mod.rel != config.STREAMING_MODULE:
      return
    for cls in _reducer_classes(mod):
      spec_fn = _methods(cls).get("device_spec")
      if spec_fn is None:
        continue  # base default (None) => plain per-chunk fallback
      known = {n.id for n in ast.walk(spec_fn)
               if isinstance(n, ast.Name)} & config.DEVICE_SPEC_TYPES
      returns_none_only = all(
          r.value is None or (isinstance(r.value, ast.Constant)
                              and r.value.value is None)
          for r in ast.walk(spec_fn) if isinstance(r, ast.Return))
      if not known and not returns_none_only:
        yield Finding(
            self.id, mod.rel, spec_fn.lineno, spec_fn.col_offset,
            f"'{cls.name}.device_spec' must return one of "
            f"{sorted(config.DEVICE_SPEC_TYPES)} (what "
            "explore.device.build_plan compiles into the fused program) "
            "or None to opt out of fusion")


@register
class SearchSeedRouting(Rule):
  id = "CON005"
  pack = "contract"
  summary = ("guided-search RNG not seeded by a direct derive_seed call "
             "(same-seed bit-identity of optimize() hangs on labelled "
             "per-generation streams)")
  instead = "np.random.RandomState(derive_seed('search-gen', seed, g))"

  def check_module(self, mod, ctx):
    if mod.rel != config.SEARCH_MODULE:
      return
    for node in ast.walk(mod.tree):
      if not isinstance(node, ast.Call):
        continue
      chain = attr_chain(node.func)
      if chain[-1] not in config.SEED_SINKS:
        continue
      args = list(node.args) + [kw.value for kw in node.keywords]
      derived = any(
          isinstance(a, ast.Call)
          and attr_chain(a.func)[-1] == config.SEED_DERIVER
          for a in args)
      if not derived:
        yield Finding(
            self.id, mod.rel, node.lineno, node.col_offset,
            f"search proposal operators must seed '{chain[-1]}' with a "
            f"direct {config.SEED_DERIVER}(...) call (stricter than "
            "DET005: no pre-derived variables, no raw seeds) so every "
            "random stream is a labelled per-generation derivation and "
            "same-seed optimize() reruns stay bit-identical")
