"""Carry the reference's state into the port: design points, workloads,
co-exploration's architectures and accuracies, model parameters (the
language models', with their AdamW moments, and the CNNs', with their SGD
momenta) and packed deploy codecs; and the port's model and training
state back into the reference's tree layout.

The sweep's state is the design points (a ConfigTable's columns) and the
workload's layers; co-exploration's adds (architecture, accuracy) pairs,
given as per-stage ``(repeats, channels)`` tuples and floats; a model's
is its parameter tree.  All arrive as plain
numpy arrays, tuples and dicts, so a caller holding the reference
package's objects hands over ``{name: getattr(table, name)}``,
``dataclasses.astuple(layer)`` or ``jax.tree_util.tree_map(np.asarray,
params)`` without this module importing it.  ``params_to_tree`` turns the
port's model into that same tree (its leaves stacked on ``n_blocks``), the
layout ``quant.pack_params`` walks; ``train_state_to_tree`` and
``load_train_state`` do the same for a trainer's state, the layout of the
reference's checkpoints.
"""
from __future__ import annotations

from typing import (Any, Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cnn import ArchChoice
from repro_torch.core.dataflow import ConvLayer
from repro_torch.core.table import COLUMNS, ConfigTable
from repro_torch.models import transformer
from repro_torch.models.common import model_dtype
from repro_torch.models.ssm import FLOAT32_LEAVES


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


# leaves that stay float32 in every model: the norms' scales and biases
# (in ``*_norm`` groups), qk-norm and rwkv's lerps, decay base, bonus and
# group-norm scale
_F32_LEAVES = frozenset(("q_norm", "k_norm") + FLOAT32_LEAVES)


def _stays_f32(name: str) -> bool:
  """Whether the state-dict leaf ``name`` keeps float32 whatever the
  model dtype (the rest are matmul weights, the embedding and the head)."""
  parts = name.split(".")
  return (len(parts) > 1 and parts[-2].endswith("norm")) or \
      parts[-1] in _F32_LEAVES


# an encoder-decoder's stacked leaves, and the config field counting them
_ENCDEC_STACKS = {"enc_blocks": "n_encoder_layers", "dec_blocks": "n_layers"}


def params_from_jax(cfg: ModelConfig, params: Mapping[str, Any],
                    dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, torch.Tensor]:
  """The port's ``Transformer`` (or, for an encoder-decoder, ``EncDec``)
  state dict (CPU tensors) from the reference's parameter tree as numpy
  arrays (or bfloat16 tensors, as a checkpoint restores them): a
  decoder's ``blocks`` leaves stacked on a leading ``n_blocks`` axis, an
  encoder-decoder's ``enc_blocks`` and ``dec_blocks`` on their layer axis.

  Matmul weights (a MoE's router, stacked (E, d_in, d_out) experts and
  shared MLP among them, a Mamba layer's four projections), the
  embedding, the LM head and a learned position table are cast once to
  ``dtype``: by default the model dtype, for serving (the reference casts
  its float32 copies at every use: the same rounding); float32 (or
  bfloat16) for a trainable model.  Norm scales and biases, rwkv's lerps,
  decay base, bonus and group-norm scale, and a Mamba layer's conv, dt
  bias, A, skip and output-norm leaves stay float32; a ``layernorm_np``
  norm's empty dict gives no entry.
  """
  dt = model_dtype(cfg) if dtype is None else dtype

  def tensor(a, cast: bool) -> torch.Tensor:
    t = (a.float() if isinstance(a, torch.Tensor) else
         torch.from_numpy(np.array(a, dtype=np.float32, copy=True)))
    return t.to(dt) if cast else t

  if cfg.family == "encdec":
    tree = dict(params)
    for key, n in _ENCDEC_STACKS.items():
      tree[key] = transformer._unzip(params[key], list, getattr(cfg, n))
  else:
    tree = transformer.unstack_blocks(cfg, params, unstack=list)
  flat = transformer.flatten(tree)
  return {name: tensor(a, not _stays_f32(name)) for name, a in flat.items()}


def params_to_tree(cfg: ModelConfig, params: torch.nn.Module
                   ) -> Dict[str, Any]:
  """The reference-shaped parameter tree of the port's ``Transformer``:
  the inverse of ``params_from_jax``.  Each layer's ``layers.{l}.mix.wq``
  and the like is stacked back onto ``blocks/sub{i}/mix/wq`` of shape
  ``(n_blocks, d_in, d_out)``; tensors keep the model's dtypes and device
  (the stacks are new tensors, the rest are the model's own).  An
  encoder-decoder's ``enc_blocks.{l}`` and ``dec_blocks.{l}`` leaves are
  stacked on their layer axis."""
  tree = transformer.nest(params.state_dict())
  if cfg.family != "encdec":
    return transformer.stack_blocks(cfg, tree)
  for key, n in _ENCDEC_STACKS.items():
    tree[key] = transformer._zip_map(
        torch.stack, [tree[key][str(l)] for l in range(getattr(cfg, n))])
  return tree


def _is_q8(node) -> bool:
  """An int8 AdamW moment: ``{"codes", "scale"}``."""
  return isinstance(node, Mapping) and set(node) == {"codes", "scale"}


def adamw_state_from_jax(cfg: ModelConfig, state: Mapping[str, Any]
                         ) -> Dict[str, Any]:
  """The port's AdamW state (``{"step", "m", "v"}``, moments keyed by the
  ``Transformer``'s parameter names, CPU tensors) from the reference's
  ``adamw_init``/``adamw_update`` state as numpy arrays: float32 moments,
  or int8 ``{"codes", "scale"}`` ones, their ``blocks`` leaves stacked on
  ``n_blocks``."""
  def moments(tree):
    flat = transformer.flatten(
        transformer.unstack_blocks(cfg, tree, unstack=list), is_leaf=_is_q8)
    return {name: ({"codes": torch.from_numpy(np.array(a["codes"],
                                                       dtype=np.int8)),
                    "scale": torch.from_numpy(np.array(a["scale"],
                                                       dtype=np.float32))}
                   if _is_q8(a) else
                   torch.from_numpy(np.array(a, dtype=np.float32)))
            for name, a in flat.items()}
  return {"step": int(state["step"]), "m": moments(state["m"]),
          "v": moments(state["v"])}


def train_state_to_tree(cfg: ModelConfig, state: Mapping[str, Any]
                        ) -> Dict[str, Any]:
  """A trainer's state (``{"params": Transformer, "opt": AdamW state}``)
  as the reference's: ``{"params", "opt": {"step", "m", "v"}}`` with the
  ``blocks`` leaves stacked on ``n_blocks`` (new tensors on the model's
  device; the step an int32 numpy scalar)."""
  def tree(named):
    return transformer.stack_blocks(cfg, transformer.nest(named))
  params = {n: p.detach() for n, p in state["params"].named_parameters()}
  opt = state["opt"]
  return {"params": tree(params),
          "opt": {"step": np.asarray(opt["step"], dtype=np.int32),
                  "m": tree(opt["m"]), "v": tree(opt["v"])}}


@torch.no_grad()
def load_train_state(cfg: ModelConfig, tree: Mapping[str, Any],
                     state: Dict[str, Any]) -> None:
  """Copy a reference-shaped train state (as :func:`train_state_to_tree`
  writes it, or the reference's own checkpoint) into ``state`` in place,
  each leaf cast to the live leaf's dtype and device.  Raises when a leaf
  is missing or the moments' form (float32 or int8) differs."""
  state["params"].load_state_dict(
      params_from_jax(cfg, tree["params"], dtype=torch.float32))
  opt = adamw_state_from_jax(cfg, tree["opt"])
  for key in ("m", "v"):
    live, new = state["opt"][key], opt[key]
    if set(live) != set(new):
      raise ValueError(f"the checkpoint's {key} has other leaves than the "
                       "model")
    for name, dst in live.items():
      src = new[name]
      if isinstance(dst, dict) != isinstance(src, dict):
        raise ValueError(f"{key}/{name}: the checkpoint's moments and the "
                         "optimizer's differ in form (float32 or int8)")
      if isinstance(dst, dict):
        dst["codes"].copy_(src["codes"])
        dst["scale"].copy_(src["scale"])
      else:
        dst.copy_(src)
  state["opt"]["step"] = opt["step"]


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
