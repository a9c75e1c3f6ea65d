"""Host models of the QUIDAM accelerator: PE types, the RS dataflow
model (scalar, batch and joint), the synthesis oracle (scalar, batch and
joint), the polynomial PPA models, workloads, the ConfigTable and
JointTable, the QAT CNNs over the Table-4 search space (``cnn``), the
weight-sharing supernet and its workload bridge (``supernet``), the
jax-style PRNG that draws architectures (``prng``), and the ``dse`` and
``coexplore`` compatibility shims."""
from repro_torch.core.dataflow import AcceleratorConfig, ConvLayer
from repro_torch.core.pe import PAPER_PE_TYPES, PE_TYPES, pe_type
from repro_torch.core.table import ConfigTable

__all__ = [
    "AcceleratorConfig", "ConfigTable", "ConvLayer", "PAPER_PE_TYPES",
    "PE_TYPES", "pe_type",
]
