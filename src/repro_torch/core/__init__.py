"""Host models of the QUIDAM accelerator: PE types, the RS dataflow
model, the synthesis oracle (scalar and batch), the polynomial PPA
models, workloads, the ConfigTable, and the ``dse`` compatibility
shim."""
from repro_torch.core.dataflow import AcceleratorConfig, ConvLayer
from repro_torch.core.pe import PAPER_PE_TYPES, PE_TYPES, pe_type
from repro_torch.core.table import ConfigTable

__all__ = [
    "AcceleratorConfig", "ConfigTable", "ConvLayer", "PAPER_PE_TYPES",
    "PE_TYPES", "pe_type",
]
