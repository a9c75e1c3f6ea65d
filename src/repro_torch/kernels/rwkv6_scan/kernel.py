"""Launch wrappers for the CUDA chunked WKV6 kernel and its backward
(``csrc/rwkv6_scan.cu``, built and loaded through ``ctypes``).

The wrapper takes r/k/v (B, H, T, D) float32 or bf16 and w (B, H, T, D)
float32 in any strides whose last dim is contiguous (the model passes
(B, T, H, D) projections as transposed views), u (H, D) and an optional
s0 (B, H, D, D), float32 and contiguous, all on one CUDA device.  It
allocates the float32 outputs, launches on the current stream and raises
if the launch was refused.  The output is written in (B, T, H, D) memory
order and returned as its (B, H, T, D) view, so the model's move back to
(B, T, H, D) is free.  ``wkv6_bwd`` takes the same inputs and the
output's float32 gradient (any strides with a contiguous last dim) and
returns the gradients, dr/dk/dv/dw laid out as the output.  ``LAUNCHES``
counts the calls of each that launched: one a ``wkv6_bwd`` call, though
the backward is three kernels (a chunk's local sums, the folds across
chunks, a chunk's gradients) on the current stream.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch import _build

HEAD_DIMS = (16, 32, 64)
MAX_CHUNK = 64
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES: Dict[str, int] = {"wkv6": 0, "wkv6_bwd": 0}


def reset_launch_counts() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
  lib = _build.load("rwkv6_scan")
  p, i64 = ctypes.c_void_p, ctypes.c_int64
  lib.wkv6_forward.argtypes = [p] * 8 + [i64] * 20 + [ctypes.c_int, p]
  lib.wkv6_forward.restype = ctypes.c_int
  lib.wkv6_backward.argtypes = [p] * 15 + [i64] * 23 + [ctypes.c_int, p]
  lib.wkv6_backward.restype = ctypes.c_int
  lib.wkv6_bwd_last_blocks.argtypes = [p]
  lib.wkv6_bwd_last_blocks.restype = None
  return lib


def check_inputs(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor,
                 s0: Optional[torch.Tensor], chunk: int) -> None:
  """Raise ValueError on what the kernel does not take."""
  dev = r.device
  if dev.type != "cuda":
    raise ValueError(f"r: expected a CUDA tensor, got one on {dev}")
  for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
    if t.device != dev:
      raise ValueError(f"{name} is on {t.device}, r on {dev}")
    if t.dim() != 4 or t.stride(-1) != 1:
      raise ValueError(f"{name}: expected (B, H, T, D) with a contiguous "
                       f"last dim, got shape {tuple(t.shape)} strides "
                       f"{t.stride()}")
    if t.shape != r.shape:
      raise ValueError(f"{name} shape {tuple(t.shape)} does not match r "
                       f"{tuple(r.shape)}")
  for name, t in (("r", r), ("k", k), ("v", v)):
    if t.dtype not in DTYPES or t.dtype != r.dtype:
      raise ValueError(f"{name}: expected float32 or bfloat16 like r, got "
                       f"{t.dtype}")
  b, h, _, d = r.shape
  if d not in HEAD_DIMS:
    raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
  if not 1 <= chunk <= MAX_CHUNK:
    raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")
  state = [("w", w, tuple(r.shape)), ("u", u, (h, d))]
  if s0 is not None:
    state.append(("s0", s0, (b, h, d, d)))
  for name, t, shape in state:
    if t.device != dev:
      raise ValueError(f"{name} is on {t.device}, r on {dev}")
    if t.dtype != torch.float32:
      raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != shape:
      raise ValueError(f"{name}: expected shape {shape}, got "
                       f"{tuple(t.shape)}")
    if name != "w" and not t.is_contiguous():
      raise ValueError(f"{name} must be contiguous")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: Optional[torch.Tensor] = None,
         chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
  """K7: (B, H, T, D) inputs -> (out (B, H, T, D) float32, final state
  (B, H, D, D) float32); s0 None is a zero state."""
  check_inputs(r, k, v, w, u, s0, chunk)
  b, h, t, d = r.shape
  out = torch.empty((b, t, h, d), dtype=torch.float32, device=r.device)
  s_out = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
  with torch.cuda.device(r.device):
    stream = torch.cuda.current_stream().cuda_stream
    status = _lib().wkv6_forward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(),
        out.data_ptr(), s_out.data_ptr(),
        b, h, t, d, int(chunk),
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *w.stride()[:3],
        out.stride(0), out.stride(2), out.stride(1),
        int(r.dtype == torch.bfloat16), stream)
  if status != 0:
    raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {status}")
  LAUNCHES["wkv6"] += 1
  return out.permute(0, 2, 1, 3), s_out


def bwd_scratch_floats(b: int, h: int, t: int, d: int, chunk: int) -> int:
  """float32 elements of the backward's scratch buffer: per (batch, head)
  and chunk, U_c then S_c and W_c then dS_c (D x D each), e^lam_c and the
  chunk's share of du (D each)."""
  return b * h * -(-t // chunk) * (2 * d * d + 2 * d)


# the backward's three kernels, in launch order
BWD_KERNELS = ("wkv6_bwd_local_kernel", "wkv6_bwd_fold_kernel",
               "wkv6_bwd_grad_kernel")


def last_bwd_blocks() -> Dict[str, int]:
  """Blocks of each kernel that the last ``wkv6_bwd`` call on the card
  launched, as the C entry point recorded its grids (all 0 at T = 0)."""
  out = (ctypes.c_int64 * 3)()
  _lib().wkv6_bwd_last_blocks(out)
  return dict(zip(BWD_KERNELS, out))


def check_grad_inputs(r: torch.Tensor, dout: torch.Tensor,
                      ds_final: Optional[torch.Tensor]) -> None:
  """Raise ValueError on an output gradient the backward does not take."""
  b, h, _, d = r.shape
  if dout.device != r.device or dout.dtype != torch.float32:
    raise ValueError(f"dout: expected float32 on {r.device}, got "
                     f"{dout.dtype} on {dout.device}")
  if dout.shape != r.shape or dout.stride(-1) != 1:
    raise ValueError(f"dout: expected shape {tuple(r.shape)} with a "
                     f"contiguous last dim, got {tuple(dout.shape)} strides "
                     f"{dout.stride()}")
  if ds_final is not None and (
      ds_final.device != r.device or ds_final.dtype != torch.float32
      or tuple(ds_final.shape) != (b, h, d, d)
      or not ds_final.is_contiguous()):
    raise ValueError(f"ds_final: expected contiguous float32 of shape "
                     f"{(b, h, d, d)} on {r.device}")


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor],
             dout: torch.Tensor, ds_final: Optional[torch.Tensor] = None,
             chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, ...]:
  """K7's backward: the gradients (dr, dk, dv in r's dtype, dw float32,
  all (B, H, T, D) views of (B, T, H, D) memory; du (H, D) float32; ds0
  (B, H, D, D) float32) of ``wkv6``'s output and final state, given their
  gradients ``dout`` (float32) and ``ds_final`` (None is zero).  s0 None is
  a zero state.  Three kernel launches, counted as one: a chunk's local
  sums into a scratch buffer, the folds across chunks, a chunk's
  gradients.  Reruns give the same bits: every sum has a fixed order, du
  is written per (batch, head, chunk), summed over the chunks in order by
  the fold and over the batch here."""
  check_inputs(r, k, v, w, u, s0, chunk)
  check_grad_inputs(r, dout, ds_final)
  b, h, t, d = r.shape
  dev = r.device
  grads = [torch.empty((b, t, h, d), dtype=dt, device=dev)
           for dt in (r.dtype, r.dtype, r.dtype, torch.float32)]
  du = torch.empty((b, h, d), dtype=torch.float32, device=dev)
  ds0 = torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
  scratch = torch.empty((bwd_scratch_floats(b, h, t, d, int(chunk)),),
                        dtype=torch.float32, device=dev)
  g = grads[0]
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream().cuda_stream
    status = _lib().wkv6_backward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(),
        dout.data_ptr(), None if ds_final is None else ds_final.data_ptr(),
        *(x.data_ptr() for x in grads), du.data_ptr(), ds0.data_ptr(),
        scratch.data_ptr(), b, h, t, d, int(chunk),
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *w.stride()[:3],
        *dout.stride()[:3], g.stride(0), g.stride(2), g.stride(1),
        int(r.dtype == torch.bfloat16), stream)
  if status != 0:
    raise RuntimeError(f"wkv6 backward kernel launch failed: CUDA error "
                       f"{status}")
  LAUNCHES["wkv6_bwd"] += 1
  dr, dk, dv, dw = (x.permute(0, 2, 1, 3) for x in grads)
  return dr, dk, dv, dw, du.sum(dim=0), ds0
