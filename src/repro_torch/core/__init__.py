"""Host models of the QUIDAM accelerator: PE types, the RS dataflow
model, the synthesis oracle, workloads and the ConfigTable."""
