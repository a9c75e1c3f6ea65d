"""TorchOracleBackend: the exact synthesis oracle on a torch device.

The port of ``repro.explore.backend.VectorOracleBackend``'s device path.
Each chunk's inputs are built on the host (:func:`oracle.batch_inputs`),
packed into one pinned buffer and copied to the device without blocking;
the formulas and the fused reduction then run eagerly in float64 on the
device, and results come back through pinned buffers.  Results are
bit-identical to the reference's numpy path on every device that passes
:func:`repro_torch.explore.device.ensure_exact`, which the constructor
runs.

The backend runs on CUDA unless the caller asks for another device; it
never moves to the CPU on its own.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import oracle
from repro_torch.core.dataflow import AcceleratorConfig, ConvLayer
from repro_torch.core.table import ConfigTable
from repro_torch.explore import device as device_lib
from repro_torch.explore.frame import ResultFrame

Configs = Union[Sequence[AcceleratorConfig], ConfigTable]


class TorchOracleBackend:
  """The synthesis stand-in, array-at-a-time over ConfigTables, on one
  torch device (``"cuda"`` by default; tests pass ``device="cpu"``)."""
  name = "torch-oracle"
  prefers_table = True

  def __init__(self, chunk_size: int = 65536,
               device: Optional[Union[str, torch.device]] = None):
    if chunk_size <= 0:
      raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    self.device = torch.device("cuda" if device is None else device)
    if self.device.type == "cuda" and not torch.cuda.is_available():
      raise RuntimeError("TorchOracleBackend runs on CUDA by default and no "
                         "CUDA device is available; pass device='cpu' to "
                         "run on the CPU")
    self.chunk_size = chunk_size
    device_lib.ensure_exact(self.device)

  def _place(self, inputs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """One (columns, rows) float64 buffer holding every input column,
    on the device; returns per-column row views of it."""
    keys = sorted(inputs)
    n = len(next(iter(inputs.values())))
    # pinned on CUDA: the copy then runs without blocking the host, and
    # the caching allocator keeps the buffer until the copy is done
    pinned = self.device.type == "cuda"
    host = torch.empty((len(keys), n), dtype=torch.float64,
                       pin_memory=pinned)
    packed = host.numpy()
    for i, k in enumerate(keys):
      packed[i] = inputs[k]
    on_device = host.to(self.device, non_blocking=True) if pinned else host
    return {k: on_device[i] for i, k in enumerate(keys)}

  def _dispatch(self, table: ConfigTable, layers: Sequence[ConvLayer],
                plan=None):
    run = device_lib.make_eval_fn(tuple(layers), plan)
    return run(self._place(oracle.batch_inputs(table)))

  # -- one-shot evaluation ----------------------------------------------------

  def evaluate(self, cfgs: Configs, layers: Sequence[ConvLayer],
               network: str = "net") -> ResultFrame:
    """Config lists are converted to a table; the frame keeps whichever
    design-point representation came in."""
    if isinstance(cfgs, ConfigTable):
      return self.evaluate_table(cfgs, layers, network)
    cfgs = list(cfgs)
    frame = self.evaluate_table(ConfigTable.from_configs(cfgs), layers,
                                network)
    frame.cfgs = tuple(cfgs)
    return frame

  def evaluate_table(self, table: ConfigTable, layers: Sequence[ConvLayer],
                     network: str = "net") -> ResultFrame:
    n = len(table)
    lat = np.empty(n)
    pwr = np.empty(n)
    area = np.empty(n)
    lo = 0
    for chunk in table.chunks(self.chunk_size):
      l, p, a = (t.cpu().numpy() for t in self._dispatch(chunk, layers))
      hi = lo + len(chunk)
      lat[lo:hi], pwr[lo:hi], area[lo:hi] = l, p, a
      lo = hi
    return ResultFrame(lat, pwr, area, table.pe_type_strings(), (),
                       network, table=table)

  # -- streaming entry points: asynchronous dispatch --------------------------

  def eval_pending(self, table: ConfigTable, layers: Sequence[ConvLayer],
                   network: str, idx: np.ndarray) -> device_lib.PendingFrame:
    """Dispatch one streaming chunk; resolves to (frame, idx)."""
    return device_lib.PendingFrame(self._dispatch(table, layers), table, idx,
                                   network)

  def fused_eval_pending(self, table: ConfigTable,
                         layers: Sequence[ConvLayer], network: str,
                         plan: device_lib.DevicePlan,
                         idx: np.ndarray) -> device_lib.PendingFused:
    """Dispatch one fused evaluate+reduce chunk; resolves to per-reducer
    payloads with O(survivors) device->host transfer."""
    return device_lib.PendingFused(self._dispatch(table, layers, plan), plan,
                                   table, idx, network)
