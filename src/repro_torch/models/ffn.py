"""Feed-forward blocks: the dense MLP variants and the capacity-based MoE
(the port of ``repro.models.ffn``).

MoE is the reference's GShard/Switch capacity dispatch: tokens are cut
into groups of ``moe_group_size``, each group routes top-k with a
capacity of ``int(group * k * capacity_factor / E)`` slots an expert, and
dispatch and combine are one-hot einsums, differentiable end to end.  A
single-token input (decode, or a one-token prefill) takes the dense,
capacity-free path instead.  The reference has no ``pallas_call`` here:
on the card these are eager torch operations, as the reference's are
plain ``jnp``.

Functions take their weights as a mapping (``router``, ``wi``, ``wg``
for swiglu, ``wo``, ``shared``), so the serving modules and the training
forward's parameter tree share them.  Expert weights are stacked on a
leading expert axis, ``(E, d_in, d_out)``, the reference's layout.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (Device, dense_init, frozen, mlp_act,
                                       model_dtype)


def mlp(x: torch.Tensor, wi: torch.Tensor, wg: Optional[torch.Tensor],
        wo: torch.Tensor, variant: str) -> torch.Tensor:
  """swiglu ``(silu(x @ wg) * (x @ wi)) @ wo``, or ``act(x @ wi) @ wo``
  for gelu and relu2; each weight cast to x's dtype at use (a no-op for
  weights already stored in it)."""
  dt = x.dtype
  h = x @ wi.to(dt)
  if variant == "swiglu":
    h = F.silu(x @ wg.to(dt)) * h
  else:
    h = mlp_act(h, variant)
  return h @ wo.to(dt)


def apply_mlp(p: Mapping[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
  return mlp(x, p["wi"], p.get("wg"), p["wo"], cfg.mlp_variant)


class MLP(nn.Module):
  """Weights (d_in, d_out), the reference's layout: ``wi``, ``wg`` (swiglu
  only) and ``wo``, stored in the model dtype, or in ``dtype`` when given
  (a trainable model's)."""

  def __init__(self, cfg: ModelConfig, d_ff: int, device: Device = None,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.variant = cfg.mlp_variant
    d, dt = cfg.d_model, dtype or model_dtype(cfg)
    self.wi = frozen(torch.empty((d, d_ff), dtype=dt, device=device))
    self.wg = (frozen(torch.empty((d, d_ff), dtype=dt, device=device))
               if self.variant == "swiglu" else None)
    self.wo = frozen(torch.empty((d_ff, d), dtype=dt, device=device))

  def init_(self, gen: torch.Generator) -> "MLP":
    """Draw the reference's initialization (values differ: another RNG)."""
    d, d_ff = self.wi.shape
    self.wi.copy_(dense_init(gen, d, d_ff))
    if self.wg is not None:
      self.wg.copy_(dense_init(gen, d, d_ff))
    self.wo.copy_(dense_init(gen, d_ff, d, scale=0.5))
    return self

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return mlp(x, self.wi, self.wg, self.wo, self.variant)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _stacked_init(gen: torch.Generator, e: int, d_in: int, d_out: int,
                  scale: float = 1.0) -> torch.Tensor:
  """``e`` of :func:`dense_init`'s (d_in, d_out) draws, stacked."""
  return torch.stack([dense_init(gen, d_in, d_out, scale)
                      for _ in range(e)])


class MoE(nn.Module):
  """The reference's ``init_moe`` leaves: ``router`` (d, E), stacked
  expert weights ``wi``/``wg``/``wo`` (E, d_in, d_out) (``wg`` for swiglu
  only) and, with shared experts, a dense ``shared`` MLP of
  ``d_ff_shared``."""

  def __init__(self, cfg: ModelConfig, device: Device = None,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.cfg = cfg
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    dt = dtype or model_dtype(cfg)

    def weight(*shape):
      return frozen(torch.empty(shape, dtype=dt, device=device))
    self.router = weight(d, e)
    self.wi = weight(e, d, ff)
    self.wg = weight(e, d, ff) if cfg.mlp_variant == "swiglu" else None
    self.wo = weight(e, ff, d)
    self.shared = (MLP(cfg, cfg.d_ff_shared, device, dtype)
                   if cfg.n_shared_experts else None)

  def init_(self, gen: torch.Generator) -> "MoE":
    e, d, ff = self.wi.shape
    self.router.copy_(dense_init(gen, d, e, scale=0.1))
    self.wi.copy_(_stacked_init(gen, e, d, ff))
    self.wo.copy_(_stacked_init(gen, e, ff, d, scale=0.5))
    if self.wg is not None:
      self.wg.copy_(_stacked_init(gen, e, d, ff))
    if self.shared is not None:
      self.shared.init_(gen)
    return self

  def weights(self) -> Dict:
    """The leaves as the mapping :func:`apply_moe` takes."""
    p = {"router": self.router, "wi": self.wi, "wo": self.wo}
    if self.wg is not None:
      p["wg"] = self.wg
    if self.shared is not None:
      p["shared"] = {k: v for k, v in (("wi", self.shared.wi),
                                       ("wg", self.shared.wg),
                                       ("wo", self.shared.wo))
                     if v is not None}
    return p

  def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return apply_moe(self.weights(), x, self.cfg)


def _capacity(group: int, k: int, e: int, factor: float) -> int:
  """Slots an expert takes in a group; Python's ``int`` truncates, as the
  reference's does."""
  return max(int(group * k * factor / e), 1)


def route_topk(logits: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(..., E) router logits -> (gates (..., E) with only the top k
  nonzero, renormalized over them; top-k indices (..., k)).

  ``jax.lax.top_k`` puts the lower index first among equal values and
  ``torch.topk`` promises no order, so the experts come from a stable
  descending sort, which keeps the lower index first too."""
  probs = torch.softmax(logits.float(), dim=-1)
  top_vals, top_idx = torch.sort(probs, dim=-1, descending=True,
                                 stable=True)
  top_vals, top_idx = top_vals[..., :k], top_idx[..., :k]
  top_vals = top_vals / torch.clamp_min(
      torch.sum(top_vals, dim=-1, keepdim=True), 1e-9)
  gates = torch.zeros_like(probs).scatter(-1, top_idx, top_vals)
  return gates, top_idx


def _dispatch_combine(gates: torch.Tensor, top_idx: torch.Tensor, e: int,
                      cap: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """GShard position assignment within each group.

  gates (..., g, E), top_idx (..., g, k) -> (dispatch (..., g, E, cap)
  0/1 float32, combine (..., g, E, cap) float32, the mean fraction of a
  group routed to an expert).  Rank by rank, as the reference: a token's
  slot in its expert is the count of the group's earlier tokens sent
  there at this rank, plus every token sent there at the lower ranks;
  a token whose slot reaches ``cap`` is dropped."""
  g, k = gates.shape[-2], top_idx.shape[-1]
  lead = gates.shape[:-2]
  dispatch = torch.zeros((*lead, g, e, cap), dtype=torch.float32,
                         device=gates.device)
  combine = torch.zeros_like(dispatch)
  counts = torch.zeros((*lead, 1, e), dtype=torch.int64, device=gates.device)
  experts = torch.arange(e, device=gates.device)
  slots = torch.arange(cap, device=gates.device)
  for rank in range(k):
    idx = top_idx[..., rank]                                  # (..., g)
    # one-hots by comparison: F.one_hot checks its input's range on the
    # host, a sync a step on the card
    onehot = (idx[..., None] == experts).long()               # (..., g, E)
    pos = torch.cumsum(onehot, dim=-2) - 1 + counts
    counts = counts + torch.sum(onehot, dim=-2, keepdim=True)
    my_pos = torch.sum(pos * onehot, dim=-1)                  # (..., g)
    slot = (my_pos[..., None] == slots).float()   # zero past cap: dropped
    dis = onehot.float()[..., None] * slot[..., None, :]
    dispatch = dispatch + dis
    gate_r = torch.gather(gates, -1, idx[..., None])[..., 0]
    combine = combine + dis * gate_r[..., None, None]
  load = torch.mean(torch.sum(dispatch, dim=(-3, -1)) / max(g, 1), dim=-1)
  return dispatch, combine, load


def apply_moe_dense(p: Mapping, x: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Exact (capacity-free) MoE for single-token inputs: every expert on
  every token, combined with the renormalized top-k gates.  Decode reads
  every expert's weights anyway, so the extra FLOPs cost little."""
  d = x.shape[-1]
  dt = x.dtype
  flat = x.reshape(-1, d)
  logits = flat @ p["router"].to(dt)
  gates, _ = route_topk(logits, cfg.n_experts_active)          # (t, E)
  # (t, d) @ (E, d, f) broadcasts over the experts: one batched product
  # that reads each expert's weights in place, with no permuted copy
  h = flat @ p["wi"].to(dt)                                    # (E, t, f)
  if cfg.mlp_variant == "swiglu":
    h = F.silu(flat @ p["wg"].to(dt)) * h
  else:
    h = mlp_act(h, cfg.mlp_variant)
  eo = h @ p["wo"].to(dt)                                      # (E, t, d)
  out = torch.einsum("te,etd->td", gates.to(dt), eo).reshape(x.shape)
  if cfg.n_shared_experts:
    out = out + apply_mlp(p["shared"], x, cfg)
  return out, torch.zeros((), dtype=torch.float32, device=x.device)


def apply_moe(p: Mapping, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
  """x (B, S, d) -> (out, the Switch aux loss).  Capacity-grouped top-k;
  a (B, 1, d) input takes :func:`apply_moe_dense`.  Groups are
  ``min(moe_group_size, B * S)`` tokens and must divide B * S: capacity
  competition depends on the grouping, so nothing is regrouped."""
  if x.dim() == 3 and x.shape[1] == 1:
    return apply_moe_dense(p, x, cfg)
  b, s, d = x.shape
  dt = x.dtype
  gsz = min(cfg.moe_group_size, b * s)
  n_groups = (b * s) // gsz
  if n_groups * gsz != b * s:
    raise ValueError(f"{b} x {s} tokens do not split into MoE groups of "
                     f"{gsz} (moe_group_size {cfg.moe_group_size})")
  xg = x.reshape(n_groups, gsz, d)

  logits = xg @ p["router"].to(dt)
  gates, top_idx = route_topk(logits, cfg.n_experts_active)
  cap = _capacity(gsz, cfg.n_experts_active, cfg.n_experts,
                  cfg.capacity_factor)
  dispatch, combine, _ = _dispatch_combine(gates, top_idx, cfg.n_experts,
                                           cap)

  # aux load-balancing loss (Switch): E * sum_e f_e * p_e
  me = torch.mean(gates, dim=(0, 1))                          # (E,)
  ce = torch.mean(torch.sum(dispatch, dim=-1), dim=(0, 1))    # (E,)
  aux = cfg.n_experts * torch.sum(me * ce)

  expert_in = torch.einsum("gtec,gtd->gecd", dispatch.to(dt), xg)
  h = torch.einsum("gecd,edf->gecf", expert_in, p["wi"].to(dt))
  if cfg.mlp_variant == "swiglu":
    gate = torch.einsum("gecd,edf->gecf", expert_in, p["wg"].to(dt))
    h = F.silu(gate) * h
  else:
    h = mlp_act(h, cfg.mlp_variant)
  expert_out = torch.einsum("gecf,efd->gecd", h, p["wo"].to(dt))
  out = torch.einsum("gtec,gecd->gtd", combine.to(dt), expert_out)
  out = out.reshape(b, s, d)
  if cfg.n_shared_experts:
    out = out + apply_mlp(p["shared"], x, cfg)
  return out, aux
