"""State-space layers (the port of ``repro.models.ssm``): RWKV-6
("Finch") time mix and channel mix, and jamba's Mamba (selective SSM).

RWKV-6: parameters, token shift, the full-sequence path through K7
(prefill, and training through K7's autograd function) and the
per-token decode path.  Matmul weights are stored in the model dtype for
serving (the reference stores float32 and casts at every use: the same
rounding), or in a trainable model's ``param_dtype``, and every matmul
casts its weight to the activations' dtype at use, which for a serving
model's weights does nothing; ``w0``, ``u`` and ``ln_x`` stay float32 and
are used as float32; the ``mix``/``cmix`` lerps are stored float32 and
cast to the activations' dtype at use, as the reference does.  (Under
``param_dtype="bfloat16"`` the reference's ``make_train_state`` also
rounds the 2-D lerps, ``u`` and ``ln_x`` to bf16; the port keeps these
float32 leaves as serving keeps them.)  The functions take a layer's
leaves by name, from an :class:`RWKVMix` or from
:func:`transformer.param_tree`'s per-layer dict, so serving and training
run the same code.

Mamba (serving since slice 8b; its training comes with slice 8c): the
input projection, a causal depthwise conv, the data-dependent dt, B and
C, the diagonal selective scan in float32, jamba's RMSNorm on its output
before the ``silu(z)`` gate, and the output projection.  The reference's
scan is plain ``jnp`` (no ``pallas_call``), so on the card it is eager
torch: each ``ssm_chunk`` of the sequence is solved by a log-depth
doubling scan (the reference's ``associative_scan``), the state carried
from chunk to chunk.  Prefill leaves the cache the reference's
``_mamba_final_state`` leaves: the state from the step-by-step
recurrence, and the conv window of the last ``d_conv - 1`` inputs of the
conv.  Decode takes one token through the same recurrence.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.models.common import (Device, dense_init, frozen,
                                       model_dtype)

Cache = Dict[str, torch.Tensor]

# the float32 leaves of RWKVMix and MambaMix; every other leaf is a
# matmul weight
FLOAT32_LEAVES = ("mix", "w0", "u", "ln_x", "cmix",
                  "conv_w", "conv_b", "dt_bias", "a_log", "d_skip", "norm")


class RWKVMix(nn.Module):
  """One RWKV-6 layer's parameters: the time mix (r, k, v, g projections,
  the data-dependent decay's LoRA, the bonus u, the per-head group norm)
  and the channel mix (``cm_*``), the reference's ``init_rwkv`` leaves.
  The matmul weights are in the model dtype, or in ``dtype`` when given;
  the ``FLOAT32_LEAVES`` in float32."""

  def __init__(self, cfg: ModelConfig, device: Device = None,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    d, dff = cfg.d_model, cfg.d_ff
    h, hd = cfg.n_heads, cfg.head_dim
    e, rank, dt = h * hd, max(d // 16, 1), dtype or model_dtype(cfg)
    f32 = torch.float32

    def weight(*shape):
      return frozen(torch.empty(shape, dtype=dt, device=device))

    self.mix = frozen(torch.full((5, d), 0.5, dtype=f32, device=device))
    self.wr, self.wk, self.wv, self.wg = (weight(d, e) for _ in range(4))
    self.wo = weight(e, d)
    self.w0 = frozen(torch.empty(e, dtype=f32, device=device))
    self.w_lora_a = weight(d, rank)
    self.w_lora_b = weight(rank, e)
    self.u = frozen(torch.empty((h, hd), dtype=f32, device=device))
    self.ln_x = frozen(torch.ones((h, hd), dtype=f32, device=device))
    self.cmix = frozen(torch.full((2, d), 0.5, dtype=f32, device=device))
    self.cm_wr = weight(d, d)
    self.cm_wk = weight(d, dff)
    self.cm_wv = weight(dff, d)

  def init_(self, gen: torch.Generator) -> "RWKVMix":
    """Draw the reference's initialization (values differ: another RNG)."""
    d, e = self.wr.shape
    rank, dff = self.w_lora_a.shape[1], self.cm_wk.shape[1]
    self.mix.fill_(0.5)
    for wt in (self.wr, self.wk, self.wv, self.wg):
      wt.copy_(dense_init(gen, d, e))
    self.wo.copy_(dense_init(gen, e, d, scale=0.5))
    self.w0.copy_(-6.0 + 0.3 * torch.randn(
        e, generator=gen, dtype=torch.float32, device=gen.device))
    self.w_lora_a.copy_(dense_init(gen, d, rank))
    self.w_lora_b.copy_(dense_init(gen, rank, e, scale=0.1))
    self.u.copy_(0.3 * torch.randn(self.u.shape, generator=gen,
                                   dtype=torch.float32, device=gen.device))
    self.ln_x.fill_(1.0)
    self.cmix.fill_(0.5)
    self.cm_wr.copy_(dense_init(gen, d, d))
    self.cm_wk.copy_(dense_init(gen, d, dff))
    self.cm_wv.copy_(dense_init(gen, dff, d, scale=0.5))
    return self

  def __getitem__(self, name: str) -> torch.Tensor:
    """A leaf by name, as :func:`transformer.param_tree`'s dicts give it."""
    return getattr(self, name)


class MambaMix(nn.Module):
  """One Mamba layer's parameters, the reference's ``init_mamba`` leaves:
  ``in_proj`` (d, 2 d_inner) for x and the gate z, the depthwise
  ``conv_w`` (d_conv, d_inner) and ``conv_b``, ``x_proj`` (d_inner,
  dt_rank + 2 d_state) for dt, B and C, ``dt_proj`` (dt_rank, d_inner),
  ``dt_bias``, ``a_log`` (d_inner, d_state), ``d_skip``, ``out_proj``
  (d_inner, d) and jamba's output RMSNorm scale ``norm``; dt_rank is
  ``max(d // 16, 1)``.  The four projections are in the model dtype, or
  in ``dtype`` when given; the rest in float32 (the conv's leaves are cast
  to the activations' dtype at use, as the reference casts them)."""

  def __init__(self, cfg: ModelConfig, device: Device = None,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.mamba_d_state
    rank, dt = max(d // 16, 1), dtype or model_dtype(cfg)
    f32 = torch.float32

    def weight(*shape):
      return frozen(torch.empty(shape, dtype=dt, device=device))

    def leaf(*shape):
      return frozen(torch.empty(shape, dtype=f32, device=device))
    self.in_proj = weight(d, 2 * di)
    self.conv_w = leaf(cfg.mamba_d_conv, di)
    self.conv_b = frozen(torch.zeros(di, dtype=f32, device=device))
    self.x_proj = weight(di, rank + 2 * ds)
    self.dt_proj = weight(rank, di)
    self.dt_bias = leaf(di)
    self.a_log = leaf(di, ds)
    self.d_skip = frozen(torch.ones(di, dtype=f32, device=device))
    self.out_proj = weight(di, d)
    self.norm = frozen(torch.ones(di, dtype=f32, device=device))

  def init_(self, gen: torch.Generator) -> "MambaMix":
    """Draw the reference's initialization (values differ: another RNG):
    dt_bias is softplus^-1 of U(1e-3, 1e-1), A = -(1, ..., d_state) on
    every channel."""
    d, di = self.in_proj.shape[0], self.out_proj.shape[0]
    rank, ds = self.dt_proj.shape[0], self.a_log.shape[1]
    dev, f32 = gen.device, torch.float32
    self.in_proj.copy_(dense_init(gen, d, 2 * di))
    self.conv_w.copy_(0.2 * torch.randn(self.conv_w.shape, generator=gen,
                                        dtype=f32, device=dev))
    self.conv_b.zero_()
    self.x_proj.copy_(dense_init(gen, di, rank + 2 * ds))
    self.dt_proj.copy_(dense_init(gen, rank, di))
    u = torch.rand(di, generator=gen, dtype=f32, device=dev)
    self.dt_bias.copy_(torch.log(torch.expm1(1e-3 + (1e-1 - 1e-3) * u)))
    self.a_log.copy_(torch.log(torch.arange(1, ds + 1, dtype=f32,
                                            device=dev)).expand(di, ds))
    self.d_skip.fill_(1.0)
    self.out_proj.copy_(dense_init(gen, di, d, scale=0.5))
    self.norm.fill_(1.0)
    return self

  def __getitem__(self, name: str) -> torch.Tensor:
    """A leaf by name, as :func:`transformer.param_tree`'s dicts give it."""
    return getattr(self, name)


# a layer's leaves: the module, or its dict in a parameter tree
Leaves = Union[RWKVMix, MambaMix, Mapping[str, torch.Tensor]]


class _Sigmoid(torch.autograd.Function):
  """The reference's sigmoid as XLA evaluates it: 1 / (1 + e^-x) one op at
  a time, each rounded to x's dtype, and its gradient g (y (1 - y)), also
  one op at a time.  ``torch.sigmoid`` rounds once, and in bf16 that moves
  the gate and the channel mix's r by an ulp in about half their elements,
  which rwkv's group norm can amplify into the gradients."""

  @staticmethod
  def forward(ctx, x: torch.Tensor) -> torch.Tensor:
    y = torch.reciprocal(1 + torch.exp(-x))
    ctx.save_for_backward(y)
    return y

  @staticmethod
  def backward(ctx, g: torch.Tensor) -> torch.Tensor:
    (y,) = ctx.saved_tensors
    return g * (y * (1 - y))


def _silu(x: torch.Tensor) -> torch.Tensor:
  """``jax.nn.silu``'s rounding: x times the sigmoid above."""
  return x * _Sigmoid.apply(x)


def _token_shift(x: torch.Tensor) -> torch.Tensor:
  """x (B, L, d) -> the previous token at each position (zeros at t = 0)."""
  return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _rwkv_wkv_inputs(p: Leaves, x: torch.Tensor, x_prev: torch.Tensor):
  """The lerps and projections shared by prefill, training and decode: r,
  k, v, the gate g (x's dtype) and the decay w (float32)."""
  dt = x.dtype
  mix = p["mix"].to(dt)
  # x_prev - x once a lerp, as the reference writes it: in bf16 the
  # gradient then sums its parts in the reference's order
  xr, xk, xv, xg, xw = (x + (x_prev - x) * mix[i] for i in range(5))
  r, k, v = xr @ p["wr"].to(dt), xk @ p["wk"].to(dt), xv @ p["wv"].to(dt)
  g = _silu(xg @ p["wg"].to(dt))
  # data-dependent decay (the v6 "Finch" feature)
  lora = torch.tanh(xw @ p["w_lora_a"].to(dt)) @ p["w_lora_b"].to(dt)
  w = torch.exp(-torch.exp(p["w0"] + lora.float()))
  return r, k, v, g, w


def _group_norm(out: torch.Tensor, ln_x: torch.Tensor) -> torch.Tensor:
  """Per-head RMS norm of the WKV output over its last dim (eps 1e-6)."""
  var = torch.mean(out * out, dim=-1, keepdim=True)
  return out * torch.rsqrt(var + 1e-6) * ln_x


def apply_rwkv_time_mix(p: Leaves, x: torch.Tensor, cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """x (B, L, d) -> (time-mix output (B, L, d), final WKV state (B, H, D,
  D) float32), from a zero state; the recurrence runs K7 on the card, and
  K7's backward when a leaf or x needs a gradient."""
  b, l, _ = x.shape
  h, hd = cfg.n_heads, cfg.head_dim
  r, k, v, g, w = _rwkv_wkv_inputs(p, x, _token_shift(x))

  def heads(t):  # (B, L, H * hd) -> (B, H, L, hd), a view
    return t.view(b, l, h, hd).transpose(1, 2)

  out, s_final = wkv_ops.wkv6(heads(r), heads(k), heads(v), heads(w), p["u"],
                              chunk=cfg.ssm_chunk)
  out = _group_norm(out, p["ln_x"][None, :, None, :])
  out = out.transpose(1, 2).reshape(b, l, h * hd).to(x.dtype) * g
  return out @ p["wo"].to(x.dtype), s_final


def rwkv_channel_decode(p: Leaves, x: torch.Tensor, prev: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
  """The channel mix of x (..., d) given the previous token ``prev``."""
  dt = x.dtype
  cmix = p["cmix"].to(dt)
  xr = x + (prev - x) * cmix[0]
  xk = x + (prev - x) * cmix[1]
  r = _Sigmoid.apply(xr @ p["cm_wr"].to(dt))
  k = torch.square(torch.relu(xk @ p["cm_wk"].to(dt)))
  return r * (k @ p["cm_wv"].to(dt))


def apply_rwkv_channel_mix(p: Leaves, x: torch.Tensor,
                           cfg: ModelConfig) -> torch.Tensor:
  """x (B, L, d) -> (B, L, d)."""
  return rwkv_channel_decode(p, x, _token_shift(x), cfg)


def rwkv_decode_step(p: Leaves, x: torch.Tensor, cache: Cache,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
  """One token x (B, d) through the time mix only (the caller runs the
  channel mix with ``cm_prev``).  The cache {"s" (B, H, D, D) float32,
  "tm_prev" (B, d), "cm_prev" (B, d)} is updated in place."""
  b = x.shape[0]
  h, hd = cfg.n_heads, cfg.head_dim
  r, k, v, g, w = _rwkv_wkv_inputs(p, x, cache["tm_prev"])

  def heads(t):
    return t.reshape(b, h, hd).float()

  o, s_new = wkv_ops.wkv6_decode_step(heads(r), heads(k), heads(v),
                                      heads(w), p["u"], cache["s"])
  o = _group_norm(o, p["ln_x"][None])
  o = o.reshape(b, h * hd).to(x.dtype) * g
  cache["s"].copy_(s_new)
  cache["tm_prev"].copy_(x)
  return o @ p["wo"].to(x.dtype), cache


def init_rwkv_cache(cfg: ModelConfig, batch: int,
                    device: Device = None) -> Cache:
  dt = model_dtype(cfg)
  return {
      "s": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                       dtype=torch.float32, device=device),
      "tm_prev": torch.zeros((batch, cfg.d_model), dtype=dt, device=device),
      "cm_prev": torch.zeros((batch, cfg.d_model), dtype=dt, device=device),
  }


# ---------------------------------------------------------------------------
# Mamba (selective SSM, jamba flavour)
# ---------------------------------------------------------------------------

def _softplus(x: torch.Tensor) -> torch.Tensor:
  """``jax.nn.softplus``, log(1 + e^x) as ``logaddexp(x, 0)`` (torch's
  softplus returns x itself above a threshold)."""
  return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
  """x (B, L, C), w (K, C): the causal depthwise conv along L, its taps
  summed one at a time in x's dtype, as the reference sums them."""
  k, l = w.shape[0], x.shape[1]
  xp = F.pad(x, (0, 0, k - 1, 0))
  out = torch.zeros_like(x)
  for i in range(k):
    out = out + xp[:, i:i + l] * w[i]
  return out + b


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, in log2(T)
  doubling steps (Hillis-Steele): step ``off`` folds each t with t - off,
  the reference's combine (a1 a2, a2 b1 + b2)."""
  off, t = 1, a.shape[1]
  while off < t:
    b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
    a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
    off *= 2
  return b


def _ssm_chunk_scan(u: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
                    cmat: torch.Tensor, a: torch.Tensor,
                    chunk: int) -> torch.Tensor:
  """The diagonal selective SSM over u, dt (B, L, di) and B, C (B, L, N),
  float32, L a multiple of ``chunk``, with the state h (B, di, N) carried
  from chunk to chunk: h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t and y_t =
  h_t . C_t.  Returns y (B, L, di)."""
  b, l, di = u.shape
  n = bmat.shape[-1]
  h = torch.zeros((b, di, n), dtype=torch.float32, device=u.device)
  ys = []
  for c0 in range(0, l, chunk):
    rows = slice(c0, c0 + chunk)
    da = torch.exp(dt[:, rows, :, None] * a)                   # (B, C, di, N)
    dbu = (dt[:, rows] * u[:, rows])[..., None] * bmat[:, rows, None, :]
    # the carried state enters as a virtual step 0: h_0 = 1 * h + 0
    da = torch.cat([torch.ones_like(da[:, :1]), da], 1)
    dbu = torch.cat([h[:, None], dbu], 1)
    hs = _linear_scan(da, dbu)[:, 1:]
    ys.append(torch.einsum("bcdn,bcn->bcd", hs, cmat[:, rows]))
    h = hs[:, -1]
  return torch.cat(ys, 1)


def _mamba_inputs(p: Leaves, x: torch.Tensor, cfg: ModelConfig):
  """x (B, L, d) -> the conv's inputs (B, L, d_inner), the scan's u (the
  conv's output through silu) and the gate z in x's dtype, dt (B, L,
  d_inner) float32, and B, C (B, L, d_state) in x's dtype."""
  rank, ds, dtt = max(x.shape[-1] // 16, 1), cfg.mamba_d_state, x.dtype
  xs_in, z = (x @ p["in_proj"].to(dtt)).chunk(2, dim=-1)
  u = _silu(_causal_depthwise_conv(xs_in, p["conv_w"].to(dtt),
                                   p["conv_b"].to(dtt)))
  dt_in, bmat, cmat = (u @ p["x_proj"].to(dtt)).split([rank, ds, ds], -1)
  dt = _softplus((dt_in @ p["dt_proj"].to(dtt)).float() + p["dt_bias"])
  return xs_in, u, z, dt, bmat, cmat


def _gate_out(p: Leaves, y: torch.Tensor, u: torch.Tensor,
              z: torch.Tensor) -> torch.Tensor:
  """The scan's f32 output y plus the ``d_skip`` term (in f32), jamba's
  RMSNorm (eps 1e-6), the gate silu(z) in z's dtype, and out_proj."""
  y = y + u.float() * p["d_skip"]
  var = torch.mean(y * y, dim=-1, keepdim=True)
  y = y * torch.rsqrt(var + 1e-6) * p["norm"]
  y = y.to(z.dtype) * _silu(z)
  return y @ p["out_proj"].to(z.dtype)


def _mamba_scan_out(p: Leaves, u, z, dt, bmat, cmat,
                    cfg: ModelConfig) -> torch.Tensor:
  """The chunk scan over L padded after the real tokens to a multiple of
  ``ssm_chunk`` (the pad's zero dt keeps the state), cut back to L."""
  l = u.shape[1]
  pad = (-l) % cfg.ssm_chunk

  def padded(t):
    return F.pad(t.float(), (0, 0, 0, pad))
  y = _ssm_chunk_scan(padded(u), padded(dt), padded(bmat), padded(cmat),
                      -torch.exp(p["a_log"]), cfg.ssm_chunk)[:, :l]
  return _gate_out(p, y, u, z)


def apply_mamba(p: Leaves, x: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
  """x (B, L, d) -> (B, L, d), from a zero state (the reference's train
  and prefill path)."""
  _, u, z, dt, bmat, cmat = _mamba_inputs(p, x, cfg)
  return _mamba_scan_out(p, u, z, dt, bmat, cmat, cfg)


def mamba_prefill(p: Leaves, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Cache]:
  """x (B, L, d) -> (:func:`apply_mamba`'s output, the cache the
  reference's ``_mamba_final_state`` builds): "h" (B, d_inner, d_state)
  float32 from the recurrence taken one step at a time over the L tokens,
  and "conv" (B, d_conv - 1, d_inner), the last d_conv - 1 inputs of the
  conv, left-padded with zeros, in the model dtype."""
  xs_in, u, z, dt, bmat, cmat = _mamba_inputs(p, x, cfg)
  out = _mamba_scan_out(p, u, z, dt, bmat, cmat, cfg)
  k1 = cfg.mamba_d_conv - 1
  tail = xs_in[:, -k1:]
  conv = F.pad(tail, (0, 0, k1 - tail.shape[1], 0)).to(model_dtype(cfg))
  a = -torch.exp(p["a_log"])
  uf, bf = u.float(), bmat.float()
  h = torch.zeros((x.shape[0], u.shape[2], bf.shape[2]), dtype=torch.float32,
                  device=x.device)
  for t in range(x.shape[1]):
    h = torch.exp(dt[:, t, :, None] * a) * h + \
        (dt[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
  return out, {"h": h, "conv": conv}


def mamba_decode_step(p: Leaves, x: torch.Tensor, cache: Cache,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
  """One token x (B, d); the cache {"h" (B, d_inner, d_state) float32,
  "conv" (B, d_conv - 1, d_inner)} is updated in place."""
  rank, ds, dtt = max(x.shape[-1] // 16, 1), cfg.mamba_d_state, x.dtype
  xs, z = (x @ p["in_proj"].to(dtt)).chunk(2, dim=-1)
  conv_in = torch.cat([cache["conv"], xs[:, None]], 1)       # (B, K, di)
  u = _silu(torch.sum(conv_in * p["conv_w"].to(dtt), dim=1)
            + p["conv_b"].to(dtt))
  dt_in, bmat, cmat = (u @ p["x_proj"].to(dtt)).split([rank, ds, ds], -1)
  dt = _softplus((dt_in @ p["dt_proj"].to(dtt)).float() + p["dt_bias"])
  h = torch.exp(dt[..., None] * -torch.exp(p["a_log"])) * cache["h"] + \
      (dt * u.float())[..., None] * bmat.float()[:, None, :]
  y = torch.einsum("bdn,bn->bd", h, cmat.float())
  cache["h"].copy_(h)
  cache["conv"].copy_(conv_in[:, 1:])
  return _gate_out(p, y, u, z), cache


def init_mamba_cache(cfg: ModelConfig, batch: int,
                     device: Device = None) -> Cache:
  return {
      "h": torch.zeros((batch, cfg.d_inner, cfg.mamba_d_state),
                       dtype=torch.float32, device=device),
      "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, cfg.d_inner),
                          dtype=model_dtype(cfg), device=device),
  }
