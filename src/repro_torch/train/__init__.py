"""Training support of the port.  For now only the retry primitive of
:mod:`repro_torch.train.fault_tolerance`, which the exploration
resilience ladder is built on; the trainer comes with slice 7."""
