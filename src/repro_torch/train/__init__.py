"""Training support of the port.  For now only
:mod:`repro_torch.train.fault_tolerance`: the retry primitive the
exploration resilience ladder is built on, and the straggler monitor the
device fleet reads; the trainer comes with slice 7."""
