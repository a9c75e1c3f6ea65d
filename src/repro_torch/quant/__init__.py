"""Framework-level quantization policies (QAT + deploy codecs)."""
from repro_torch.quant.policy import (QuantPolicy, deploy_bytes_per_param,
                                      fake_quant_params, pack_params)
