"""repro_torch.analysis: the port's exactness lint.

Fixture trees mirror the port's layout (core/, explore/, kernels/,
train/) so the path-scoped rules apply to them unchanged.  Every rule
has a flagged and a clean fixture; the seeded-hazard cases edit copies of
the port's own modules back into each form the card's probe finds off
numpy's bits (F1-F7) and into both fallback forms, and expect exactly
that rule at that line.  For the rules the port shares with the
reference (``repro.analysis``), both engines must agree on findings,
fingerprints, JSON and one baseline file.  The self-scan at the bottom
holds ``src/repro_torch`` and ``chip_smoke.py`` clean modulo
``src/repro_torch/analysis/baseline.json``.
"""
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

from repro.analysis import Baseline as RefBaseline
from repro.analysis import scan_paths as ref_scan_paths
from repro.analysis.formats import to_json as ref_to_json

from repro_torch.analysis import RULES, Baseline, scan_paths
from repro_torch.analysis.formats import to_json
from repro_torch.analysis.registry import iter_rules

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
BASELINE = PORT / "analysis" / "baseline.json"
SMOKE = REPO / "chip_smoke.py"
ALL_IDS = sorted(r.id for r in iter_rules())


def write_tree(tmp_path, files, tests=None, name="pkg"):
  """Write a {relpath: source} fixture tree under a fresh root named
  ``name``; returns (root, tests dir or a nonexistent path)."""
  root = Path(tempfile.mkdtemp(dir=tmp_path)) / name
  for rel, src in files.items():
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(src)
  tdir = root.parent / ("tests" if tests is not None else "no_tests_dir")
  if tests is not None:
    tdir.mkdir(exist_ok=True)
    for fname, src in tests.items():
      (tdir / fname).write_text(src)
  return root, tdir


def run_tree(tmp_path, files, tests=None, **kw):
  root, tdir = write_tree(tmp_path, files, tests)
  return scan_paths([root], tests_dir=tdir, **kw)


def codes(report):
  return sorted(f.rule for f in report.findings)


# ---------------------------------------------------------------------------
# one flagged and one clean fixture per rule
# ---------------------------------------------------------------------------

KERNEL_PKG = {"kernels/foo/kernel.py": "def k(x): ...\n",
              "kernels/foo/ref.py": "def k_ref(x): ...\n",
              "kernels/foo/ops.py": "def k(x): ...\n",
              "kernels/foo/csrc/foo.cu": "// kernel\n"}

PROGRAM = ("import torch\n"
           "import numpy as np\n"
           "from pkg.core import oracle\n"
           "X = 0\n"
           "def make_eval_fn(layers, plan):\n"
           "  print('building')  # the builder runs once, on the host\n"
           "  def run(inputs):\n"
           "{body}"
           "    return oracle.characterize_batch(inputs, layers)\n"
           "  return run\n"
           "def resolve(t):\n"
           "  return t.item(), t.cpu(), np.asarray(t)\n")

# rule -> (flagged tree, number of findings, clean tree)
CASES = {
    "DET001": ({"core/x.py": "import numpy as np\nimport torch\n"
                             "a = np.random.rand(3)\n"
                             "b = torch.randn(3)\n"
                             "c = torch.empty(3).uniform_()\n"
                             "torch.manual_seed(0)\n"}, 4,
               {"core/x.py": "import numpy as np\nimport torch\n"
                             "rng = np.random.RandomState(0)\n"
                             "g = torch.Generator().manual_seed(0)\n"
                             "b = torch.randn(3, generator=g)\n"
                             "c = torch.empty(3).uniform_(generator=g)\n",
                "launch/x.py": "import torch\nb = torch.randn(3)\n"}),
    "DET002": ({"core/x.py": "import numpy as np\nimport torch\n"
                             "rng = np.random.default_rng()\n"
                             "torch.seed()\n"
                             "g = torch.Generator(device='cpu')\n"}, 3,
               {"core/x.py": "import numpy as np\nimport torch\n"
                             "rng = np.random.default_rng(5)\n"
                             "g = torch.Generator(device='cpu')"
                             ".manual_seed(3)\n"}),
    "DET003": ({"core/x.py": "import time\nt = time.time()\n"}, 1,
               {"core/x.py": "import time\nt = time.perf_counter()\n",
                "launch/x.py": "import time\nt = time.time()\n"}),
    "DET004": ({"explore/x.py": "out = [y for y in {1, 2, 3}]\n"}, 1,
               {"explore/x.py": "out = [y for y in sorted({1, 2, 3})]\n"}),
    "DET005": ({"data/x.py": "import numpy as np\n"
                             "def f(seed, i, g):\n"
                             "  g.manual_seed(seed + i)\n"
                             "  return np.random.RandomState(seed * 7 + i)\n"},
               2,
               {"data/x.py": "import numpy as np\n"
                             "from pkg.core.seeding import derive_seed\n"
                             "def f(seed, i, g):\n"
                             "  g.manual_seed(derive_seed('x', seed, i))\n"
                             "  return np.random.RandomState("
                             "derive_seed('x', seed, i))\n"}),
    "EXA001": ({"core/oracle.py": "import numpy as np\nimport torch\n"
                                  "def f(x):\n"
                                  "  a = x.float()\n"
                                  "  b = x.to(torch.float32)\n"
                                  "  c = np.float32(1)\n"
                                  "  d = x.to(torch.bfloat16)\n"
                                  "  return x.astype('float32')\n"}, 5,
               {"core/oracle.py": "import torch\n"
                                  "def f(x):\n"
                                  "  return x.to(torch.float64)\n",
                "train/x.py": "def f(x):\n  return x.float()\n"}),
    "EXA002": ({"core/oracle.py": "import torch\n"
                                  "def f(c: torch.Tensor):\n"
                                  "  return torch.sqrt(c) + c.log2() "
                                  "+ c ** 0.5\n"}, 3,
               {"core/oracle.py": "import math\nimport numpy as np\n"
                                  "import torch\n"
                                  "def host(x):\n"
                                  "  return np.log2(x) + math.sqrt(x) "
                                  "+ x ** 0.7\n"
                                  "def f(c: torch.Tensor):\n"
                                  "  return c * c + c ** 2\n"}),
    "EXA003": ({"core/dataflow.py": "import torch\n"
                                    "def f(v: torch.Tensor, w):\n"
                                    "  return (v.sum() + torch.matmul(v, w)"
                                    " + (v @ w) + torch.linalg.norm(v))\n"},
               4,
               {"core/dataflow.py": "import torch\n"
                                    "def host(xs):\n"
                                    "  return sum(xs) + xs.sum()\n"
                                    "def f(v: torch.Tensor):\n"
                                    "  acc = v[0]\n"
                                    "  for i in range(1, 3):\n"
                                    "    acc = acc + v[i]\n"
                                    "  return acc\n"}),
    "EXA004": ({"kernels/foo/kernel.py": "import torch\n"
                                         "def k(x):\n"
                                         "  return torch.exp(x)\n"}, 1,
               {"kernels/foo/kernel.py": "import torch\n"
                                         "def k(x):\n"
                                         "  return torch.exp(x)\n",
                "kernels/foo/ref.py": "def k_ref(x): ...\n"}),
    "EXA005": ({"core/oracle.py": "import torch\n"
                                  "def f(x: torch.Tensor, n):\n"
                                  "  a = 1.0 / x\n"
                                  "  b = x // 7.0\n"
                                  "  c = torch.div(x, 3.0)\n"
                                  "  d = x.reciprocal()\n"
                                  "  x /= n\n"
                                  "  return a + b + c + d\n"}, 5,
               {"core/oracle.py": "import math\nimport torch\n"
                                  "from pkg.core.exact import div\n"
                                  "SCALE = 4.0\n"
                                  "def f(x: torch.Tensor):\n"
                                  "  return div(1.0, x) * (2.0 / SCALE) "
                                  "* (math.pi / 3) + torch.div(x, x)\n"
                                  "def host(a, b):\n"
                                  "  return a / b\n",
                "core/exact.py": "import torch\n"
                                 "def div(a: torch.Tensor, b):\n"
                                 "  return torch.div(a, 2.0) / b\n"}),
    "EXA006": ({"train/optimizer.py":
                "import torch\n"
                "def step(p: torch.Tensor, g: torch.Tensor, m):\n"
                "  m.lerp_(g, 0.1)\n"
                "  p.addcmul_(g, g, value=-0.1)\n"
                "  q = torch.addmm(p, g, m)\n"
                "  p.add_(g, alpha=-0.1)\n"
                "  torch._foreach_add_([p], [g])\n"
                "  opt = torch.optim.SGD([p], lr=0.1)\n"
                "  return torch.compile(step)\n"}, 7,
               {"train/optimizer.py":
                "import torch\n"
                "def step(p: torch.Tensor, g: torch.Tensor, m):\n"
                "  m = m * 0.9 + g * 0.1\n"
                "  return p - m * 0.1\n",
                "models/x.py": "import torch\n"
                               "def f(p: torch.Tensor, g):\n"
                               "  return torch.addmm(p, g, g)\n"}),
    "EXA007": ({"explore/device.py": "import torch\n"
                                     "def f(key: torch.Tensor, k):\n"
                                     "  a = torch.topk(key, k).indices\n"
                                     "  b = torch.sort(key).indices\n"
                                     "  c = key.argsort()\n"
                                     "  return a, b, c\n"}, 3,
               {"explore/device.py": "import numpy as np\nimport torch\n"
                                     "def f(key: torch.Tensor, k):\n"
                                     "  a = torch.sort(key, stable=True)\n"
                                     "  return a, key.sort(stable=True)\n"
                                     "def host(xs):\n"
                                     "  xs.sort()\n"
                                     "  return np.argsort(xs, kind='stable')\n"}),
    "EXA008": ({"explore/device.py": "import torch\n"
                                     "def f(mask: torch.Tensor, v):\n"
                                     "  a = torch.nonzero(mask)\n"
                                     "  b = torch.where(mask)\n"
                                     "  c = v.unique()\n"
                                     "  d = torch.masked_select(v, mask)\n"
                                     "  return a, b, c, d\n"}, 4,
               {"explore/device.py": "import torch\n"
                                     "def f(mask: torch.Tensor, v):\n"
                                     "  return torch.where(mask, v, 0.0)\n"
                                     "def host(m):\n"
                                     "  return torch.nonzero(m)\n"}),
    "JIT001": ({"explore/device.py": PROGRAM.format(
                    body="    print('chunk')\n")}, 1,
               {"explore/device.py": PROGRAM.format(body="")}),
    "JIT002": ({"explore/device.py": PROGRAM.format(
                    body="    global X\n    X = 1\n")}, 1,
               {"explore/device.py": PROGRAM.format(body="")}),
    "JIT003": ({"explore/device.py": PROGRAM.format(
                    body="    _edges()\n") + "def _edges():\n"
                                            "  return np.linspace(0, 1, 5)\n",
                "core/oracle.py": "import numpy as np\n"
                                  "def characterize_batch(inputs, layers):\n"
                                  "  return np.zeros(3)\n"}, 2,
               {"explore/device.py": PROGRAM.format(body=""),
                "core/oracle.py": "import numpy as np\n"
                                  "def characterize_batch(inputs, layers):\n"
                                  "  return inputs\n"
                                  "def batch_inputs(table):\n"
                                  "  return np.zeros(3)\n"}),
    "JIT004": ({"explore/device.py": PROGRAM.format(
                    body="    n = inputs['x'].sum().item()\n"
                         "    h = inputs['x'].cpu()\n"
                         "    torch.cuda.synchronize()\n")}, 3,
               {"explore/device.py": PROGRAM.format(body="")}),
    "CON001": ({"kernels/foo/kernel.py": "def k(x): ...\n"}, 1, KERNEL_PKG),
    "CON002": (KERNEL_PKG, 1, KERNEL_PKG),
    "CON003": ({"explore/streaming.py": "class Reducer:\n  ...\n"
                                        "class Broken(Reducer):\n"
                                        "  def fold(self, frame, idx): ...\n"},
               1,
               {"explore/streaming.py": "class Reducer:\n  ...\n"
                                        "class Good(Reducer):\n"
                                        "  def fold(self, frame, idx): ...\n"
                                        "  def result(self): ...\n"}),
    "CON004": ({"explore/streaming.py": "class Reducer:\n  ...\n"
                                        "class Bad(Reducer):\n"
                                        "  def fold(self, frame, idx): ...\n"
                                        "  def result(self): ...\n"
                                        "  def device_spec(self):\n"
                                        "    return {'k': 3}\n"}, 1,
               {"explore/streaming.py": "class Reducer:\n  ...\n"
                                        "class Good(Reducer):\n"
                                        "  def fold(self, frame, idx): ...\n"
                                        "  def result(self): ...\n"
                                        "  def device_spec(self):\n"
                                        "    return TopKSpec('perf', 5, True)\n"
                                        "class OptOut(Reducer):\n"
                                        "  def fold(self, frame, idx): ...\n"
                                        "  def result(self): ...\n"
                                        "  def device_spec(self):\n"
                                        "    return None\n"}),
    "CON005": ({"explore/search.py": "import numpy as np\n"
                                     "from pkg.core.seeding import derive_seed\n"
                                     "def gen(seed, g):\n"
                                     "  s = derive_seed('search-gen', seed, g)\n"
                                     "  return np.random.RandomState(s)\n"},
               1,
               {"explore/search.py": "import numpy as np\n"
                                     "from pkg.core.seeding import derive_seed\n"
                                     "def gen(seed, g):\n"
                                     "  return np.random.RandomState(\n"
                                     "      derive_seed('search-gen', seed, g))\n",
                "explore/other.py": "import numpy as np\n"
                                    "def gen(seed):\n"
                                    "  return np.random.RandomState(seed)\n"}),
    "ROB001": ({"explore/eng.py": "def f():\n"
                                  "  try:\n    work()\n"
                                  "  except:\n    cleanup()\n"
                                  "  try:\n    work()\n"
                                  "  except ValueError:\n    pass\n"}, 2,
               {"explore/eng.py": "def f():\n"
                                  "  try:\n    return work()\n"
                                  "  except ValueError:\n    return None\n"
                                  "  except RuntimeError as e:\n"
                                  "    raise KeyError(str(e)) from e\n",
                "train/loop.py": "def f():\n"
                                 "  try:\n    work()\n"
                                 "  except:\n    pass\n"}),
    "ROB002": ({"explore/svc.py": "from concurrent.futures import wait\n"
                                  "def f(t, ev, pending):\n"
                                  "  t.join()\n"
                                  "  ev.wait()\n"
                                  "  wait(pending)\n"}, 3,
               {"explore/svc.py": "from concurrent.futures import wait\n"
                                  "def f(t, ev, parts, pending):\n"
                                  "  t.join(5.0)\n"
                                  "  ev.wait(timeout=0.05)\n"
                                  "  wait(pending, timeout=60.0)\n"
                                  "  return ','.join(parts)\n",
                "serve/loop.py": "def f(t):\n  t.join()\n"}),
    "ROB003": ({"launch/mesh.py": "import torch\n"
                                  "def mesh():\n"
                                  "  return torch.cuda.device_count()\n",
                "explore/fleet.py": "import torch\n"
                                    "def topology():\n"
                                    "  return torch.cuda.device_count()\n"},
               2,
               {"explore/fleet.py": "import torch\n"
                                    "def visible_devices():\n"
                                    "  n = torch.cuda.device_count()\n"
                                    "  if not n:\n"
                                    "    raise RuntimeError('no card')\n"
                                    "  return n\n",
                "launch/mesh.py": "from pkg.explore.fleet import "
                                  "visible_devices\n"
                                  "def mesh(registry):\n"
                                  "  return visible_devices(), "
                                  "registry.device_count()\n"}),
    "ROB004": ({"explore/pick.py":
                "import torch\n"
                "from pkg.kernels.foo import ops as foo_ops\n"
                "from pkg.kernels.foo import ref as _ref\n"
                "def pick():\n"
                "  return 'cuda' if torch.cuda.is_available() else 'cpu'\n"
                "def run(x):\n"
                "  if torch.cuda.is_available():\n"
                "    return foo_ops.k(x)\n"
                "  return _ref.k_ref(x)\n"
                "def guarded(x):\n"
                "  try:\n"
                "    return foo_ops.k(x)\n"
                "  except RuntimeError:\n"
                "    return _ref.k_ref(x)\n"}, 4,
               {"explore/pick.py":
                "import sys\nimport torch\n"
                "from pkg.kernels.foo import kernel as _kernel\n"
                "from pkg.kernels.foo import ref as _ref\n"
                "def resolve(d):\n"
                "  if d == 'cuda' and not torch.cuda.is_available():\n"
                "    raise RuntimeError('no card')\n"
                "  return d\n"
                "def main():\n"
                "  if not torch.cuda.is_available():\n"
                "    sys.exit('no CUDA device')\n"
                "def k(x):\n"
                "  if x.device.type == 'cpu':\n"
                "    return _ref.k_ref(x)\n"
                "  return _kernel.k(x)\n"
                "def launch(x):\n"
                "  try:\n"
                "    return _kernel.k(x)\n"
                "  except ValueError as e:\n"
                "    raise RuntimeError('launch failed') from e\n"}),
}

GOOD_KERNEL_TESTS = {
    "test_torch_foo.py": "from pkg.kernels.foo import ops\n"
                         "from repro.kernels.foo import ops as ref_ops\n",
    "test_torch_gpu.py": "import pytest\n"
                         "from pkg.kernels.foo import ops\n"
                         "pytestmark = pytest.mark.gpu\n"}
CASE_TESTS = {  # (tests for the flagged tree, tests for the clean tree)
    "CON002": ({"test_torch_foo.py": GOOD_KERNEL_TESTS["test_torch_foo.py"]},
               GOOD_KERNEL_TESTS),
}


def test_every_rule_has_fixtures():
  assert sorted(CASES) == ALL_IDS


@pytest.mark.parametrize("rid", sorted(CASES))
def test_rule_flags_its_fixture(tmp_path, rid):
  files, n, _ = CASES[rid]
  tests = CASE_TESTS.get(rid, (None, None))[0]
  rep = run_tree(tmp_path, files, tests=tests, rules=[rid])
  assert codes(rep) == [rid] * n, [f.location() + " " + f.message
                                   for f in rep.findings]


@pytest.mark.parametrize("rid", sorted(CASES))
def test_rule_passes_clean_fixture(tmp_path, rid):
  _, _, files = CASES[rid]
  tests = CASE_TESTS.get(rid, (None, None))[1]
  rep = run_tree(tmp_path, files, tests=tests, rules=[rid])
  assert codes(rep) == [], [f.location() + " " + f.message
                            for f in rep.findings]


# ---------------------------------------------------------------------------
# what array context and the device programs reach
# ---------------------------------------------------------------------------

class TestReach:

  def test_oracle_roots_reach_across_modules(self, tmp_path):
    # characterize_batch reaches dataflow's formulas through an import:
    # their `/` is array context although nothing there is annotated
    rep = run_tree(tmp_path, {
        "core/oracle.py": "from pkg.core.dataflow import simulate\n"
                          "def characterize_batch(inputs, layers):\n"
                          "  return simulate(inputs)\n",
        "core/dataflow.py": "def simulate(c):\n"
                            "  return _cycles(c)\n"
                            "def _cycles(c):\n"
                            "  return c['macs'] / c['n_pe']\n"
                            "def host(a, b):\n"
                            "  return a / b\n"}, rules=["EXA005"])
    assert [(f.path, f.line) for f in rep.findings] == [
        ("core/dataflow.py", 4)]

  def test_nested_functions_are_not_module_functions(self, tmp_path):
    # `slot(li)` calls the argument, not a `slot` nested in another
    # function of the module
    rep = run_tree(tmp_path, {
        "explore/device.py": "from pkg.core import dataflow\n"
                             "def make_joint_fn(plan):\n"
                             "  def run(inputs):\n"
                             "    return dataflow.accumulate(inputs, 3)\n"
                             "  return run\n",
        "core/dataflow.py": "import numpy as np\n"
                            "def accumulate(slot, n):\n"
                            "  return [slot(i) for i in range(n)]\n"
                            "def stack(c):\n"
                            "  def slot(li):\n"
                            "    return np.ascontiguousarray(c[li])\n"
                            "  return accumulate(slot, 2)\n"},
        rules=["JIT003"])
    assert codes(rep) == []

  def test_memoized_build_is_not_part_of_a_program(self, tmp_path):
    # a kernel library's cached build runs once a process, not a chunk
    rep = run_tree(tmp_path, {
        "explore/device.py": "import functools\n"
                             "@functools.cache\n"
                             "def _lib():\n"
                             "  print('building the kernels')\n"
                             "  return object()\n"
                             "def make_eval_fn(layers, plan):\n"
                             "  def run(inputs):\n"
                             "    return _lib()\n"
                             "  return run\n"}, rules=["JIT001"])
    assert codes(rep) == []

  def test_probe_outside_device_programs(self, tmp_path):
    # host reads in a function the programs never reach are fine
    rep = run_tree(tmp_path, {"explore/device.py": PROGRAM.format(body="")},
                   rules=["JIT003", "JIT004"])
    assert codes(rep) == []


# ---------------------------------------------------------------------------
# seeded hazards in copies of the port's own modules
# ---------------------------------------------------------------------------

SEEDED_FILES = ("explore/device.py", "core/oracle.py", "core/ppa.py",
                "train/optimizer.py", "kernels/pareto_front/ops.py")

# (rule, file, text, replacement, marker on the flagged line)
SEEDED = [
    ("EXA005", "core/oracle.py",
     "  decoder = div(6.0 * dec * bits_sqrt, 8.0)\n",
     "  decoder = 6.0 * dec * bits_sqrt / 8.0\n", "bits_sqrt / 8.0"),
    ("EXA002", "core/oracle.py",
     '                        c[f"bits_sqrt_{sp}"])\n',
     "                        torch.sqrt(c[sp] * c[bits_col]))\n",
     "torch.sqrt(c[sp]"),
    ("EXA007", "explore/device.py",
     "  return torch.sort(order_key, stable=True).indices[:k]\n",
     "  return torch.topk(-order_key, k).indices\n", "torch.topk(-order_key"),
    ("EXA008", "explore/device.py",
     "  idx.scatter_(0, slot, torch.arange(n, device=mask.device))\n",
     "  idx = torch.nonzero(mask)[:, 0]\n", "torch.nonzero(mask)"),
    ("EXA006", "train/optimizer.py",
     "  m_new = m_f * cfg.b1 + g * (1 - cfg.b1)\n",
     "  m_new = torch.addcmul(m_f * cfg.b1, g, torch.full_like(g, 1 - cfg.b1))\n",
     "torch.addcmul"),
    ("JIT004", "explore/device.py",
     '      out[name] = {"count": count, "idx": idx,\n',
     '      out[name] = {"count": count.item(), "idx": idx,\n',
     "count.item()"),
    # in an unannotated host function: a value from a torch constructor,
    # from h2d and from .to(device)
    ("EXA005", "explore/device.py",
     "    _PROBED[key] = report\n",
     "    scale = torch.zeros(3, dtype=torch.float64)\n"
     "    _PROBED[key] = report, scale / 3.0\n", "scale / 3.0"),
    ("EXA003", "explore/device.py",
     "    _PROBED[key] = report\n",
     "    edges = h2d(np.ones(3), key)\n"
     "    _PROBED[key] = report, edges.sum()\n", "edges.sum()"),
    ("EXA002", "explore/device.py",
     "    _PROBED[key] = report\n",
     "    got = report[\"x\"].to(device)\n"
     "    _PROBED[key] = report, got.exp()\n", "got.exp()"),
    ("ROB004", "kernels/pareto_front/ops.py",
     '  if obj.device.type == "cpu":\n    return _ref.dominance_counts_ref(obj)\n',
     '  if not torch.cuda.is_available():\n'
     '    return _ref.dominance_counts_ref(obj)\n',
     "torch.cuda.is_available()"),
    ("ROB004", "kernels/pareto_front/ops.py",
     "    counts = _kernel.block_dominance_counts(obj_t, block)\n",
     "    try:\n"
     "      counts = _kernel.block_dominance_counts(obj_t, block)\n"
     "    except RuntimeError:\n"
     "      counts = _ref.block_dominance_counts_ref(obj_t.T, block)\n",
     "_ref.block_dominance_counts_ref(obj_t.T"),
]


def _port_copy(tmp_path):
  root = Path(tempfile.mkdtemp(dir=tmp_path)) / "repro_torch"
  for rel in SEEDED_FILES:
    (root / rel).parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(PORT / rel, root / rel)
  return root


def _scan_copy(root):
  return scan_paths([root], tests_dir=root.parent / "no_tests_dir")


@pytest.mark.parametrize(
    "rule,rel,old,new,marker", SEEDED,
    ids=[f"{s[0]}-{s[4][:24]}" for s in SEEDED])
def test_seeded_hazard_flagged_at_its_line(tmp_path, rule, rel, old, new,
                                           marker):
  root = _port_copy(tmp_path)
  before = {f.fingerprint for f in _scan_copy(root).findings}
  src = (root / rel).read_text()
  assert src.count(old) == 1, f"{rel} no longer holds the seeded line"
  edited = src.replace(old, new)
  (root / rel).write_text(edited)
  line = edited[:src.index(old) + new.index(marker)].count("\n") + 1
  new_findings = [f for f in _scan_copy(root).findings
                  if f.fingerprint not in before]
  assert [(f.rule, f.path, f.line) for f in new_findings] == [
      (rule, rel, line)], [f.location() + " " + f.rule + " " + f.message
                           for f in new_findings]


def test_unedited_copies_are_clean(tmp_path):
  assert _scan_copy(_port_copy(tmp_path)).findings == []


# ---------------------------------------------------------------------------
# the port held against the reference on the rules they share
# ---------------------------------------------------------------------------

SHARED = ("DET001", "DET002", "DET003", "DET004", "DET005", "ROB001",
          "ROB002", "CON003", "CON005")

SHARED_TREE = {
    "core/rng.py": "import time\nimport numpy as np\n"
                   "v = np.random.rand(3)\n"
                   "w = np.random.normal(size=2)\n"
                   "rng = np.random.default_rng()\n"
                   "t = time.time()\n",
    "data/seeds.py": "import numpy as np\n"
                     "def f(seed, i):\n"
                     "  a = np.random.RandomState(seed * 7 + i)\n"
                     "  return a, np.random.RandomState()\n",
    "explore/loop.py": "from concurrent.futures import wait\n"
                       "def f(t, ev, pending):\n"
                       "  for x in {1, 2}:\n"
                       "    try:\n      work(x)\n"
                       "    except:\n      cleanup()\n"
                       "  try:\n    work()\n"
                       "  except ValueError:\n    pass\n"
                       "  t.join()\n  ev.wait()\n  wait(pending)\n",
    "explore/streaming.py": "class Reducer:\n  ...\n"
                            "class Broken(Reducer):\n"
                            "  def fold(self, frame, idx): ...\n",
    "explore/search.py": "import numpy as np\n"
                         "def gen(seed):\n"
                         "  return np.random.RandomState(seed)\n",
    "launch/clock.py": "import time\nt = time.time()\n",
}


def _both(tmp_path, rules):
  root, tdir = write_tree(tmp_path, SHARED_TREE)
  return (root, tdir, scan_paths([root], tests_dir=tdir, rules=rules),
          ref_scan_paths([root], tests_dir=tdir, rules=rules))


def _located(report):
  return [(f.rule, f.path, f.line, f.col, f.fingerprint)
          for f in report.findings]


def _port_json(report):
  # the port's messages name its own package where the reference's do
  return to_json(report).replace("repro_torch", "repro")


@pytest.mark.parametrize("rid", SHARED)
def test_shared_rule_agrees_with_reference(tmp_path, rid):
  _, _, port, ref = _both(tmp_path, [rid])
  assert port.findings, f"the shared fixture never triggers {rid}"
  assert _located(port) == _located(ref)
  assert _port_json(port) == ref_to_json(ref)


def test_shared_rules_agree_and_share_one_baseline(tmp_path):
  root, tdir, port, ref = _both(tmp_path, list(SHARED))
  assert sorted({f.rule for f in port.findings}) == sorted(SHARED)
  assert _located(port) == _located(ref)
  assert _port_json(port) == ref_to_json(ref)
  # a baseline written by either engine is accepted by both
  for i, (save, findings) in enumerate(((Baseline, port.findings),
                                        (RefBaseline, ref.findings))):
    path = tmp_path / f"baseline{i}.json"
    save.from_findings(findings, justification="fixture").save(path)
    for load, scan in ((Baseline, scan_paths), (RefBaseline, ref_scan_paths)):
      rep = scan([root], tests_dir=tdir, rules=list(SHARED),
                 baseline=load.load(path))
      assert rep.new == [] and rep.stale_baseline == [] \
          and len(rep.baselined) == len(port.findings)


# ---------------------------------------------------------------------------
# engine mechanics: suppressions, baseline, fingerprints, parse errors
# ---------------------------------------------------------------------------

BAD = ("import torch\n"
       "def f(x: torch.Tensor):\n"
       "  return torch.topk(x, 3)\n")


class TestEngine:

  def test_inline_suppression_same_line(self, tmp_path):
    rep = run_tree(tmp_path, {"explore/device.py": BAD.replace(
        "3)\n", "3)  # repro: ignore[EXA007] deliberate\n")})
    assert codes(rep) == [] and rep.inline_suppressed == 1

  def test_inline_suppression_previous_line(self, tmp_path):
    rep = run_tree(tmp_path, {"explore/device.py": BAD.replace(
        "  return", "  # repro: ignore[EXA007] deliberate\n  return")})
    assert codes(rep) == [] and rep.inline_suppressed == 1

  def test_wrong_id_does_not_suppress(self, tmp_path):
    rep = run_tree(tmp_path, {"explore/device.py": BAD.replace(
        "3)\n", "3)  # repro: ignore[EXA005] wrong rule\n")})
    assert codes(rep) == ["EXA007"]

  def test_baseline_round_trip(self, tmp_path):
    rep = run_tree(tmp_path, {"explore/device.py": BAD})
    assert len(rep.new) == 1
    path = tmp_path / "base.json"
    Baseline.from_findings(rep.findings, justification="legacy").save(path)
    assert json.loads(path.read_text())["version"] == 1
    rep2 = run_tree(tmp_path, {"explore/device.py": BAD},
                    baseline=Baseline.load(path))
    assert rep2.new == [] and len(rep2.baselined) == 1 and rep2.ok

  def test_baseline_goes_stale_when_line_changes(self, tmp_path):
    rep = run_tree(tmp_path, {"explore/device.py": BAD})
    base = Baseline.from_findings(rep.findings)
    rep2 = run_tree(tmp_path, {"explore/device.py":
                               BAD.replace("3)", "4)")}, baseline=base)
    assert len(rep2.new) == 1 and len(rep2.stale_baseline) == 1

  def test_fingerprint_stable_under_line_shift(self, tmp_path):
    rep1 = run_tree(tmp_path, {"explore/device.py": BAD})
    rep2 = run_tree(tmp_path, {"explore/device.py":
                               "# a new leading comment\n\n" + BAD})
    f1, f2 = rep1.findings[0], rep2.findings[0]
    assert f1.line != f2.line and f1.fingerprint == f2.fingerprint
    rep3 = run_tree(tmp_path, {"explore/device.py":
                               "# yet another comment\n\n\n" + BAD},
                    baseline=Baseline.from_findings([f2]))
    assert rep3.new == []

  def test_parse_error_is_a_finding(self, tmp_path):
    rep = run_tree(tmp_path, {"core/x.py": "def broken(:\n"})
    assert codes(rep) == ["ANA001"]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _cli(args, cwd=REPO):
  env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
  return subprocess.run([sys.executable, "-m", "repro_torch.analysis"] + args,
                        capture_output=True, text=True, env=env, cwd=cwd,
                        timeout=300)


def _bad_tree(tmp_path):
  bad = tmp_path / "explore"
  bad.mkdir()
  (bad / "device.py").write_text(BAD)


class TestCli:

  def test_bad_tree_fails_json(self, tmp_path):
    _bad_tree(tmp_path)
    r = _cli([str(tmp_path), "--baseline", "none", "--format", "json",
              "--tests-dir", "none"])
    assert r.returncode == 1
    data = json.loads(r.stdout)
    assert data["counts"]["new"] == 1 and not data["ok"]
    assert data["findings"][0]["rule"] == "EXA007"

  def test_sarif_output(self, tmp_path):
    _bad_tree(tmp_path)
    out = tmp_path / "out.sarif"
    r = _cli([str(tmp_path), "--baseline", "none", "--format", "sarif",
              "--output", str(out), "--tests-dir", "none"])
    assert r.returncode == 1
    doc = json.loads(out.read_text())
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "repro_torch.analysis"
    assert run["results"][0]["ruleId"] == "EXA007"
    assert sorted(r["id"] for r in run["tool"]["driver"]["rules"]) == ALL_IDS

  def test_list_rules_names_every_id(self):
    r = _cli(["--list-rules"])
    assert r.returncode == 0
    listed = re.findall(r"^([A-Z]{3}\d{3})\s", r.stdout, re.M)
    assert listed == ALL_IDS
    assert r.stdout.count("instead:") == len(ALL_IDS)

  def test_package_imports_no_torch_numpy_jax_or_reference(self):
    code = ("import sys\n"
            "from pathlib import Path\n"
            "import repro_torch.analysis, repro_torch.analysis.__main__\n"
            "from repro_torch.analysis import scan_paths\n"
            "scan_paths([Path('src/repro_torch/explore')])\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'torch', 'numpy', 'jax', 'repro'}))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# the contract itself: the port is clean modulo its checked-in baseline
# ---------------------------------------------------------------------------

_MARKER = re.compile(r"#\s*repro:\s*ignore\[([A-Za-z0-9_,\s-]+)\](.*)$")


class TestSelfScan:

  def test_port_clean_modulo_baseline(self):
    baseline = Baseline.load(BASELINE)
    assert len(baseline.entries) <= 5, \
        "baseline must stay near-empty; fix findings instead of banking them"
    for e in baseline.entries:
      assert e.get("justification", "").strip() not in (
          "", "TODO: justify or fix"), \
          f"baseline entry {e['fingerprint']} has no justification"
    rep = scan_paths([PORT, SMOKE], tests_dir=REPO / "tests",
                     baseline=baseline)
    assert rep.new == [], "\n".join(
        f"{f.location()} {f.rule} {f.message}" for f in rep.new)
    assert rep.stale_baseline == [], \
        "baseline entries match nothing — prune them"

  def test_every_suppression_names_a_rule_and_a_reason(self):
    seen = 0
    for path in sorted(PORT.rglob("*.py")) + [SMOKE]:
      for i, text in enumerate(path.read_text().splitlines(), start=1):
        m = _MARKER.search(text)
        if m is None or "analysis" in path.parts:
          continue
        seen += 1
        ids = {s.strip() for s in m.group(1).split(",")}
        where = f"{path.relative_to(REPO)}:{i}"
        assert ids <= set(RULES), f"{where} names unknown rules {ids}"
        assert m.group(2).strip(), f"{where} suppresses without a reason"
    assert seen > 0

  def test_cli_self_scan_exits_zero(self):
    r = _cli(["--strict-baseline"])
    assert r.returncode == 0, r.stdout + r.stderr
