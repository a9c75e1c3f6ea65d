"""Carry the sweep's state into the port: design points and workloads.

For this system the state is not weights but the design points (a
ConfigTable's columns) and the workload's layers.  Both arrive as plain
numpy arrays and tuples, so a caller holding the reference package's
objects hands over ``{name: getattr(table, name)}`` and
``dataclasses.astuple(layer)`` without this module importing it.
"""
from __future__ import annotations

from typing import Iterable, List, Mapping, Sequence

import numpy as np

from repro_torch.core.dataflow import ConvLayer
from repro_torch.core.table import COLUMNS, ConfigTable


def table_from_columns(cols: Mapping[str, np.ndarray],
                       pe_type_names: Sequence[str]) -> ConfigTable:
  """A ConfigTable from ``pe_code`` plus the knob columns
  (``pe_rows`` ... ``bandwidth_gbps``), with ``pe_code`` indexing
  ``pe_type_names``."""
  missing = {"pe_code", *COLUMNS} - set(cols)
  if missing:
    raise ValueError(f"missing columns {sorted(missing)}")
  return ConfigTable(pe_code=np.asarray(cols["pe_code"]),
                     pe_type_names=tuple(pe_type_names),
                     **{name: np.asarray(cols[name]) for name in COLUMNS})


def layers_from_tuples(layers: Iterable[Sequence]) -> List[ConvLayer]:
  """ConvLayers from ``(name, A, C, F, K, S, P, rs, ds)`` tuples (the
  field order of the reference's ConvLayer)."""
  return [ConvLayer(*fields) for fields in layers]
