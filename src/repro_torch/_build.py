"""Build the package's CUDA kernels with nvcc at first use.

Every ``csrc/*.cu`` file under ``repro_torch/kernels`` compiles into its
own shared library with a plain C interface (loaded with ``ctypes``),
for Hopper (``sm_90a``).  Outputs go to ``build/kernels/`` at the root of
the checkout, under a name keyed on a hash of the source and the flags,
so an edited source rebuilds and an unchanged one loads straight away.
A missing ``nvcc`` or a failing build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

PACKAGE = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE.parents[1] / "build" / "kernels"

# where the CUDA toolkit puts nvcc when it is not on PATH
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> List[Path]:
  """Every CUDA source of the package, in a fixed order."""
  return sorted(PACKAGE.glob("kernels/*/csrc/*.cu"))


def _nvcc() -> str:
  path = shutil.which("nvcc")
  if path is None and DEFAULT_NVCC.exists():
    path = str(DEFAULT_NVCC)
  if path is None:
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "build only where the CUDA toolkit is installed")
  return path


def _target(src: Path) -> Path:
  digest = hashlib.sha256(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
  return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all() -> Dict[str, float]:
  """Compile every source whose library is missing, one nvcc process per
  source, all started together.  Returns seconds spent per source built
  (empty when everything was already built); ptxas' register and shared
  memory report lands beside each library as ``<lib>.log``."""
  todo = [s for s in sources() if not _target(s).exists()]
  if not todo:
    return {}
  nvcc = _nvcc()
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  t0 = time.perf_counter()
  procs = []
  for src in todo:
    out = _target(src)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    procs.append((src, out, tmp, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
  seconds: Dict[str, float] = {}
  errors = []
  for src, out, tmp, proc in procs:
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
      errors.append(f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                    f"{log}")
      continue
    os.replace(tmp, out)
    seconds[src.name] = time.perf_counter() - t0
  if errors:
    raise RuntimeError("\n".join(errors))
  return seconds


def build_log(name: str) -> str:
  """The compiler's report for ``csrc/<name>.cu`` (after a build)."""
  src = next(s for s in sources() if s.stem == name)
  log = _target(src).with_suffix(".log")
  return log.read_text() if log.exists() else ""


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
  """Registers and spill-store bytes of each kernel of ``csrc/<name>.cu``,
  by mangled name, from ptxas' report of its build."""
  found: Dict[str, Dict[str, int]] = {}
  kernel = None
  for line in build_log(name).splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
      kernel = m.group(1)
      found[kernel] = {}
      continue
    m = re.search(r"(\d+) bytes spill stores", line)
    if m and kernel:
      found[kernel]["spill_bytes"] = int(m.group(1))
    m = re.search(r"Used (\d+) registers", line)
    if m and kernel:
      found[kernel]["registers"] = int(m.group(1))
  return found


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
  """The shared library built from ``csrc/<name>.cu``, built if needed."""
  matches = [s for s in sources() if s.stem == name]
  if not matches:
    raise RuntimeError(f"no CUDA source named {name}.cu in repro_torch")
  build_all()
  return ctypes.CDLL(str(_target(matches[0])))


def csrc_constant(name: str, constant: str) -> int:
  """The value of ``constexpr int <constant> = <n>;`` in ``csrc/<name>.cu``,
  for plain versions that follow a kernel's tile and split sizes."""
  src = next(s for s in sources() if s.stem == name)
  found = re.findall(rf"constexpr int {constant} = (\d+);", src.read_text())
  if len(found) != 1:
    raise RuntimeError(f"{name}.cu defines {constant} {len(found)} times")
  return int(found[0])
