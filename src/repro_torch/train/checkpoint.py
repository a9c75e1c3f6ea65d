"""Checkpointing: atomic, resumable, keep-last-k, optionally written on a
thread (the port of ``repro.train.checkpoint``), in the reference's
format, so a checkpoint written by either package restores in the other.

Format: one ``ckpt_XXXXXXXX.npz`` holding every leaf of a nested dict
under its ``/``-joined path, and a ``ckpt_XXXXXXXX.json`` manifest (step,
extra, leaf names).  The archive goes to a temporary file and
``os.replace`` moves it into place, and the manifest is written after
it: a checkpoint without its manifest (a crash mid-write) is never
listed, so the latest listed one is always whole.

Leaves are numpy arrays or tensors (copied to the host before anything
is written).  A bfloat16 tensor is stored as the reference stores one
(``ml_dtypes``' bfloat16 through ``np.savez``): two raw bytes an element,
which numpy reads back as the void type ``|V2``; :func:`restore_checkpoint`
returns such a leaf as a bfloat16 tensor, with no ``ml_dtypes`` needed.
"""
from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_BF16_VOID = np.dtype("V2")


def _flatten(tree, path=()) -> Dict[str, Any]:
  if isinstance(tree, dict):
    out = {}
    for k, v in tree.items():
      out.update(_flatten(v, path + (str(k),)))
    return out
  return {"/".join(path): tree}


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
  root: Dict[str, Any] = {}
  for path, leaf in flat.items():
    parts = path.split("/")
    node = root
    for p in parts[:-1]:
      node = node.setdefault(p, {})
    node[parts[-1]] = leaf
  return root


def _to_host(leaf) -> np.ndarray:
  if isinstance(leaf, torch.Tensor):
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
      return t.view(torch.int16).numpy().view(_BF16_VOID)
    return t.numpy()
  return np.asarray(leaf)


def _from_host(a: np.ndarray):
  if a.dtype == _BF16_VOID:
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
  return a


def save_checkpoint(ckpt_dir: str, step: int, state: Dict,
                    extra: Optional[Dict] = None, keep: int = 3,
                    background: bool = False) -> str:
  """Atomically write checkpoint ``step``; prune to the newest ``keep``.
  With ``background`` the files are written on a thread after the leaves
  are on the host."""
  os.makedirs(ckpt_dir, exist_ok=True)
  host = {k: _to_host(v) for k, v in _flatten(state).items()}
  path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")

  def write():
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
      np.savez(f, **host)
    os.replace(tmp, path)
    manifest = {"step": step, "extra": extra or {},
                "leaves": sorted(host.keys())}
    mpath = os.path.join(ckpt_dir, f"ckpt_{step:08d}.json")
    with open(mpath + ".tmp", "w") as f:
      json.dump(manifest, f)
    os.replace(mpath + ".tmp", mpath)
    _prune(ckpt_dir, keep)

  if background:
    threading.Thread(target=write, daemon=True).start()
  else:
    write()
  return path


def _prune(ckpt_dir: str, keep: int) -> None:
  steps = list_checkpoints(ckpt_dir)
  for s in steps[:-keep] if keep else []:
    for ext in (".npz", ".json"):
      p = os.path.join(ckpt_dir, f"ckpt_{s:08d}{ext}")
      if os.path.exists(p):
        os.remove(p)


def list_checkpoints(ckpt_dir: str) -> List[int]:
  """Steps of the whole checkpoints (archive and manifest), ascending."""
  if not os.path.isdir(ckpt_dir):
    return []
  out = []
  for name in os.listdir(ckpt_dir):
    m = re.match(r"ckpt_(\d+)\.npz$", name)
    if m and os.path.exists(os.path.join(
        ckpt_dir, f"ckpt_{int(m.group(1)):08d}.json")):
      out.append(int(m.group(1)))
  return sorted(out)


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None
                       ) -> Tuple[int, Dict, Dict]:
  """The latest (or the given) checkpoint: ``(step, nested dict of numpy
  arrays, bfloat16 leaves as tensors, extra)``."""
  steps = list_checkpoints(ckpt_dir)
  if not steps:
    raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
  step = step if step is not None else steps[-1]
  with np.load(os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")) as data:
    flat = {k: _from_host(data[k]) for k in data.files}
  with open(os.path.join(ckpt_dir, f"ckpt_{step:08d}.json")) as f:
    manifest = json.load(f)
  return step, _unflatten(flat), manifest.get("extra", {})
