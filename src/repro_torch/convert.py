"""Carry the reference's state into the port: design points, workloads,
co-exploration's architectures and accuracies, model parameters (the
language models', and the CNNs' with their SGD momenta) and packed
deploy codecs; and the port's model back into the reference's tree
layout.

The sweep's state is the design points (a ConfigTable's columns) and the
workload's layers; co-exploration's adds (architecture, accuracy) pairs,
given as per-stage ``(repeats, channels)`` tuples and floats; a model's
is its parameter tree.  All arrive as plain
numpy arrays, tuples and dicts, so a caller holding the reference
package's objects hands over ``{name: getattr(table, name)}``,
``dataclasses.astuple(layer)`` or ``jax.tree_util.tree_map(np.asarray,
params)`` without this module importing it.  ``params_to_tree`` turns the
port's model into that same tree (its leaves stacked on ``n_blocks``), the
layout ``quant.pack_params`` walks.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cnn import ArchChoice
from repro_torch.core.dataflow import ConvLayer
from repro_torch.core.table import COLUMNS, ConfigTable
from repro_torch.models.common import model_dtype
from repro_torch.models.ssm import FLOAT32_LEAVES

_NORM_LEAVES = ("scale", "bias")


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


def arch_accs_from_plain(stages_list: Iterable[Sequence[Sequence[int]]],
                         accs: Iterable[float]
                         ) -> List[Tuple[ArchChoice, float]]:
  """Co-exploration's ``[(ArchChoice, accuracy)]`` from one per-stage
  ``((repeats, channels), ...)`` tuple and one float per architecture
  (``dataclasses.astuple(arch)[0]`` of a reference ArchChoice)."""
  stages_list, accs = list(stages_list), list(accs)
  if len(stages_list) != len(accs):
    raise ValueError(f"{len(stages_list)} architectures for {len(accs)} "
                     "accuracies")
  return [(ArchChoice(tuple((int(r), int(c)) for r, c in stages)), float(a))
          for stages, a in zip(stages_list, accs)]


# (module path in the port, path in a reference block's layer, is a
# matmul weight) for the attention-and-dense-MLP layer; the norms' leaves
# (scale, and bias for layernorm) are taken as the reference has them
_ATTN_LEAVES = (
    ("mix.wq", ("mix", "wq"), True),
    ("mix.wkv", ("mix", "wkv"), True),
    ("mix.wo", ("mix", "wo"), True),
    ("mix.q_norm", ("mix", "q_norm"), False),
    ("mix.k_norm", ("mix", "k_norm"), False),
    ("ffn.wi", ("ffn", "wi"), True),
    ("ffn.wg", ("ffn", "wg"), True),
    ("ffn.wo", ("ffn", "wo"), True),
)

# the same for the rwkv layer: every leaf of the reference's ``init_rwkv``
_RWKV_LEAVES = tuple(
    (f"mix.{name}", ("mix", name), name not in FLOAT32_LEAVES)
    for name in ("mix", "wr", "wk", "wv", "wg", "wo", "w0", "w_lora_a",
                 "w_lora_b", "u", "ln_x", "cmix", "cm_wr", "cm_wk", "cm_wv"))


def params_from_jax(cfg: ModelConfig,
                    params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """The port's ``Transformer`` state dict (CPU tensors) from the
  reference's parameter tree as numpy arrays, ``blocks`` leaves stacked on
  a leading ``n_blocks`` axis.

  Matmul weights, the embedding and the LM head are cast once to the model
  dtype (the reference casts its float32 copies at every use: the same
  rounding); norm scales and biases and rwkv's lerps, decay base, bonus
  and group-norm scale stay float32.
  """
  if cfg.family == "encdec":
    raise NotImplementedError("encoder-decoder models come with slice 8 of "
                              "the port")
  dt = model_dtype(cfg)

  def tensor(a, cast: bool) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    return t.to(dt) if cast else t

  state = {"embed": tensor(params["embed"], True)}
  for leaf, a in params["final_norm"].items():
    state[f"final_norm.{leaf}"] = tensor(a, False)
  if not cfg.tie_embeddings:
    state["lm_head"] = tensor(params["lm_head"], True)
  pattern = cfg.block_pattern()
  for b in range(cfg.n_blocks):
    for i, (kind, is_moe) in enumerate(pattern):
      if kind == "mamba" or is_moe:
        raise NotImplementedError(f"{'MoE' if is_moe else kind} layers "
                                  "come with slice 8 of the port")
      sub = params["blocks"][f"sub{i}"]
      layer = b * len(pattern) + i
      for norm in ("mix_norm", "ffn_norm"):
        for leaf, a in sub[norm].items():
          state[f"layers.{layer}.{norm}.{leaf}"] = tensor(a[b], False)
      leaves = _RWKV_LEAVES if kind == "rwkv" else _ATTN_LEAVES
      for name, (group, leaf), cast in leaves:
        if leaf in sub[group]:
          state[f"layers.{layer}.{name}"] = tensor(sub[group][leaf][b], cast)
  return state


def params_to_tree(cfg: ModelConfig, params: torch.nn.Module
                   ) -> Dict[str, Any]:
  """The reference-shaped parameter tree of the port's ``Transformer``:
  the inverse of ``params_from_jax``.  Each layer's ``layers.{l}.mix.wq``
  and the like is stacked back onto ``blocks/sub{i}/mix/wq`` of shape
  ``(n_blocks, d_in, d_out)``; tensors keep the model's dtypes and device
  (the stacks are new tensors, the rest are the model's own)."""
  state = params.state_dict()
  tree: Dict[str, Any] = {
      "embed": state["embed"],
      "final_norm": {leaf: state[f"final_norm.{leaf}"]
                     for leaf in _NORM_LEAVES
                     if f"final_norm.{leaf}" in state}}
  if not cfg.tie_embeddings:
    tree["lm_head"] = state["lm_head"]
  pattern = cfg.block_pattern()
  blocks = {}
  for i, (kind, _) in enumerate(pattern):
    layers = [b * len(pattern) + i for b in range(cfg.n_blocks)]

    def stack(name):
      return torch.stack([state[f"layers.{l}.{name}"] for l in layers])
    sub: Dict[str, Dict[str, torch.Tensor]] = {}
    for norm in ("mix_norm", "ffn_norm"):
      sub[norm] = {leaf: stack(f"{norm}.{leaf}") for leaf in _NORM_LEAVES
                   if f"layers.{layers[0]}.{norm}.{leaf}" in state}
    leaves = _RWKV_LEAVES if kind == "rwkv" else _ATTN_LEAVES
    for name, (group, leaf), _ in leaves:
      if f"layers.{layers[0]}.{name}" in state:
        sub.setdefault(group, {})[leaf] = stack(name)
    blocks[f"sub{i}"] = sub
  tree["blocks"] = blocks
  return tree


_PACKED_KEYS = {"codes", "scale", "fmt", "shape"}


def packed_from_jax(packed: Mapping[str, Any]) -> Dict[str, Any]:
  """The reference's ``pack_params`` tree (numpy arrays, e.g. through
  ``jax.tree_util.tree_map(np.asarray, ...)``) as CPU tensors, the layout
  the port's ``pack_params`` returns: a packed leaf keeps its codes'
  dtype (uint8, int8 or int16) and its float32 scale, with ``fmt`` a str
  and ``shape`` a tuple of ints; other leaves become tensors of their own
  dtype."""
  if isinstance(packed, Mapping):
    if set(packed) == _PACKED_KEYS:
      return {"codes": torch.from_numpy(np.array(packed["codes"],
                                                 copy=True)),
              "scale": torch.from_numpy(np.array(packed["scale"],
                                                 dtype=np.float32,
                                                 copy=True)),
              "fmt": str(packed["fmt"]),
              "shape": tuple(int(d) for d in packed["shape"])}
    return {k: packed_from_jax(v) for k, v in packed.items()}
  return torch.from_numpy(np.array(packed, copy=True))


def cnn_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """The state dict (float32 CPU tensors) of the port's ``VGGSupernet`` or
  ``ResNet`` from the reference's ``init_vgg_supernet`` or ``init_resnet``
  tree as numpy arrays: nested keys and list indices join with dots
  (``stages.0.1.w``, ``blocks.3.proj``, ``head``), conv weights turn from
  HWIO to OIHW, and the ResNet's ``stage<i>: None`` layout markers are
  dropped."""
  state: Dict[str, torch.Tensor] = {}

  def walk(node, prefix):
    items = (node.items() if isinstance(node, Mapping)
             else enumerate(node) if isinstance(node, (list, tuple))
             else None)
    if items is None:
      a = np.array(node, dtype=np.float32, copy=True)
      if a.ndim == 4:
        a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
      state[prefix] = torch.from_numpy(a)
      return
    for k, v in items:
      if v is not None:
        walk(v, f"{prefix}.{k}" if prefix else str(k))

  walk(tree, "")
  return state


def sgd_state_from_jax(state: Mapping[str, Any]) -> Dict[str, Any]:
  """The port's ``sgd_init``-shaped state from the reference's
  (``{"step", "mom"}``, the momentum tree as numpy arrays laid out as
  :func:`cnn_params_from_jax` lays out the parameters)."""
  return {"step": int(state["step"]),
          "mom": cnn_params_from_jax(state["mom"])}
