"""Training support of the port: :mod:`repro_torch.train.optimizer`, the
paper's SGD recipe that trains the QAT CNNs and the supernet,
:mod:`repro_torch.train.qat`, Table 2's training recipe, and
:mod:`repro_torch.train.fault_tolerance`, the retry primitive the
exploration resilience ladder is built on and the straggler monitor the
device fleet reads.  The LM trainer and AdamW come with slice 7b."""
