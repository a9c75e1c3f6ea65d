"""Framework-level quantization policy: QUIDAM's PE-type axis applied to
a model's parameter tree (the port of ``repro.quant.policy``).

QAT path: ``fake_quant_params`` rewrites weight leaves with straight-through
fake quantization matching a PE type (FP32 / INT16 / INT8 / INT4 /
LightPE-1 / LightPE-2); the policy matches leaves by path pattern.

Deploy path: ``pack_params`` converts matmul weights to the packed codecs
consumed by ``kernels/pow2_matmul`` (K4) and ``kernels/int8_matmul`` (K3).

Both walk the reference-shaped tree: nested dicts with ``blocks/sub{i}``
leaves stacked on a leading ``n_blocks`` axis (``convert.params_to_tree``
builds it from the port's model).  A stacked leaf is quantized as one
``(n_blocks * d_in, d_out)`` matrix, so each output column's scale spans
every layer, as in the reference; packing layer by layer would give other
scales and other codes.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

from repro_torch.core import quant

Params = Any

# Param-path patterns considered "matmul weights" (quantizable). Norms,
# biases, embeddings and scalars stay full precision.
_PATTERNS = tuple(re.compile(p) for p in (
    r".*/(wq|wkv|wo|wi|wg|wr|wk|wv|cm_wk|cm_wv|cm_wr|in_proj|out_proj|"
    r"x_proj|dt_proj)$",
))


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
  pe_type: str = "FP32"            # no-op default

  @property
  def enabled(self) -> bool:
    return self.pe_type != "FP32"


def _matches(path: str) -> bool:
  return any(p.match(path) for p in _PATTERNS)


def _walk(params, fn, path=()):
  if isinstance(params, dict):
    return {k: _walk(v, fn, path + (str(k),)) for k, v in params.items()}
  return fn("/".join(path), params)


def fake_quant_params(params: Params, policy: QuantPolicy) -> Params:
  """QAT: replace weight leaves with fake-quantized versions (STE grads)."""
  if not policy.enabled:
    return params

  def maybe_q(path, leaf):
    if leaf.dim() < 2 or not _matches(path):
      return leaf
    # stacked block leaves: (layers, ..., d_in, d_out) -> channel axis -1
    return quant.fake_quant_for_pe(leaf, policy.pe_type, channel_axis=-1)

  return _walk(params, maybe_q)


def deploy_bytes_per_param(pe_type: str) -> float:
  """Device-memory bytes per weight under each deploy codec."""
  return {"FP32": 4.0, "INT16": 2.0, "INT8": 1.0, "INT4": 0.5,
          "LightPE-1": 0.5, "LightPE-2": 1.0}[pe_type]


def pack_params(params: Params, policy: QuantPolicy) -> Params:
  """Deploy: convert matmul weights to packed codecs (serving path).

  LightPE-1/INT4 -> packed nibbles; LightPE-2/INT8 -> uint8/int8 codes;
  INT16 -> int16 codes.  Quantized leaves become {"codes", "scale", "fmt",
  "shape"} with a float32 (1, d_out) scale, on the leaf's device.
  """
  if not policy.enabled:
    return params

  def pack(path, leaf):
    if leaf.dim() < 2 or not _matches(path):
      return leaf
    w2 = leaf.reshape(-1, leaf.shape[-1]) if leaf.dim() > 2 else leaf
    if policy.pe_type in ("LightPE-1", "LightPE-2"):
      k = 1 if policy.pe_type == "LightPE-1" else 2
      q = quant.pow2_quantize(w2, k=k, channel_axis=1)
      codes = quant.pack_nibbles(q.codes) if k == 1 else q.codes
      return {"codes": codes, "scale": q.scale, "fmt": f"pow2_{k}",
              "shape": tuple(leaf.shape)}
    bits = {"INT16": 16, "INT8": 8, "INT4": 4}[policy.pe_type]
    q = quant.int_quantize(w2, bits=bits, channel_axis=1)
    codes = quant.pack_int4(q.codes) if bits == 4 else q.codes
    return {"codes": codes, "scale": q.scale, "fmt": f"int{bits}",
            "shape": tuple(leaf.shape)}

  return _walk(params, pack)
