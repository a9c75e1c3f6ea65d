"""Package-level guarantees of the PyTorch port: it stands alone (no jax,
nothing of the reference package), its copies of the reference's host
modules agree with the originals, and it never falls back from CUDA to
the CPU on its own."""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import pe as ref_pe
from repro.core import workloads as ref_workloads
from repro.core.ppa import HW_RANGES as REF_HW_RANGES
from repro.core.table import ConfigTable as RefConfigTable

from repro_torch import convert
from repro_torch.core import pe, workloads
from repro_torch.core.ppa import HW_RANGES
from repro_torch.explore import TorchOracleBackend

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py"))


def _imported_modules(path: Path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module or ""
    elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
          and node.func.id == "__import__" and node.args
          and isinstance(node.args[0], ast.Constant)):
      yield str(node.args[0].value)


def _forbidden(module: str) -> bool:
  root = module.split(".")[0]
  return root in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize(
    "path", PORT_FILES + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_reference(path):
  bad = [m for m in _imported_modules(path) if _forbidden(m)]
  assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("module", [
    "core/seeding.py", "train/__init__.py", "train/fault_tolerance.py",
    "explore/resilience.py", "explore/search.py", "core/prng.py",
    "core/cnn.py", "core/supernet.py", "data/synthetic.py",
    "train/optimizer.py", "train/qat.py"])
def test_the_scan_covers_the_guided_search_slice(module):
  assert REPO / "src" / "repro_torch" / module in PORT_FILES


def test_the_scan_sees_forbidden_imports(tmp_path):
  f = tmp_path / "mod.py"
  f.write_text("import jax.numpy as jnp\nfrom repro.core import oracle\n"
               "from repro_torch.core import oracle as ok\n")
  assert [m for m in _imported_modules(f) if _forbidden(m)] == [
      "jax.numpy", "repro.core"]


def test_backend_defaults_to_cuda_and_never_falls_back(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    TorchOracleBackend()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    TorchOracleBackend(device="cuda")
  assert TorchOracleBackend(device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_cuda():
  env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
  r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], env=env,
                     capture_output=True, text=True, timeout=300)
  assert r.returncode != 0
  assert '"ok"' not in r.stdout
  assert "no CUDA device" in r.stderr


def test_chip_smoke_refuses_to_run_alone(tmp_path):
  shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
  r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                     capture_output=True, text=True, timeout=300)
  assert r.returncode != 0
  assert r.stdout == ""


def test_pe_constants_are_a_copy():
  assert pe.PAPER_PE_TYPES == ref_pe.PAPER_PE_TYPES
  assert set(pe.PE_TYPES) == set(ref_pe.PE_TYPES)
  for name, ref_type in ref_pe.PE_TYPES.items():
    assert dataclasses.astuple(pe.PE_TYPES[name]) == \
        dataclasses.astuple(ref_type)
  assert pe.ENERGY_PJ == ref_pe.ENERGY_PJ
  assert HW_RANGES == REF_HW_RANGES


@pytest.mark.parametrize("name", ["vgg16", "vgg16_imagenet", "resnet20",
                                  "resnet56", "resnet34", "resnet50"])
def test_workloads_are_a_copy(name):
  want = [dataclasses.astuple(l) for l in ref_workloads.get_network(name)]
  got = [dataclasses.astuple(l) for l in workloads.get_network(name)]
  assert got == want
  layers = convert.layers_from_tuples(want)
  assert [l.macs for l in layers] == \
      [l.macs for l in ref_workloads.get_network(name)]


def test_table_from_columns_round_trip():
  ref = RefConfigTable.from_columns(
      ["INT16", "FP32", "INT16"],
      {"pe_rows": [8, 16, 32], "pe_cols": [10, 12, 14], "sp_if": [6, 8, 12],
       "sp_fw": [64, 96, 128], "sp_ps": [8, 12, 16],
       "gbuf_kb": [64, 96, 128], "bandwidth_gbps": [6.4, 12.8, 25.6]})
  from repro.core.table import COLUMNS
  cols = {name: getattr(ref, name) for name in COLUMNS + ("pe_code",)}
  got = convert.table_from_columns(cols, ref.pe_type_names)
  assert got.pe_type_names == ref.pe_type_names
  np.testing.assert_array_equal(got.pe_type_strings(), ref.pe_type_strings())
  for name in ref.PE_CONST_FIELDS:
    np.testing.assert_array_equal(got.pe_const(name), ref.pe_const(name))
  assert [dataclasses.astuple(c) for c in got.to_configs()] == \
      [dataclasses.astuple(c) for c in ref.to_configs()]
  with pytest.raises(ValueError, match="missing columns"):
    convert.table_from_columns({"pe_code": cols["pe_code"]}, ("INT16",))
