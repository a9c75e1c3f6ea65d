"""Training support of the port: :mod:`repro_torch.train.optimizer`
(AdamW, which trains the language models, and the paper's SGD recipe,
which trains the QAT CNNs and the supernet), :mod:`repro_torch.train.qat`
(Table 2's training recipe), :mod:`repro_torch.train.train_step`,
:mod:`repro_torch.train.checkpoint` and :mod:`repro_torch.train.trainer`
(the language-model trainer), and
:mod:`repro_torch.train.fault_tolerance` (the retry primitive, the
straggler monitor and the elastic mesh planner).  The language models
are qwen3 (attention, through K6 and its backward) and rwkv6 (through K7
and its backward)."""
