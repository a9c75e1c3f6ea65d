"""The tolerance scale of WKV6's decay gradient, shared by the port's
tests of K7's backward (``test_torch_rwkv_train.py`` on the CPU,
``test_torch_gpu.py`` on the card) and by ``chip_smoke.py``'s ``[K7-bwd]``
phase."""
import torch
import torch.nn.functional as F


def dlogw_scale(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                u: torch.Tensor, dout: torch.Tensor, dr: torch.Tensor,
                dk: torch.Tensor, chunk: int) -> torch.Tensor:
  """The scale of dw's float32 rounding, (B, H, 1, D): w dw = d log w sums
  down a chunk terms as large as |r dr| + |k dk| + 2 |drd u r k| (d lp and
  d la before they cancel, drd_t = dO_t . v_t), which can be far larger
  than the sum; per channel, the largest chunk's sum of them.  Two float32
  computations of dw in other orders differ by a multiple of it over w."""
  b, h, t, d = r.shape
  r, k, v, dout, dr, dk = (x.float() for x in (r, k, v, dout, dr, dk))
  drd = torch.sum(dout * v, dim=-1, keepdim=True)
  terms = ((r * dr).abs() + (k * dk).abs()
           + 2 * (drd * u.float()[None, :, None, :] * r * k).abs())
  terms = F.pad(terms, (0, 0, 0, (-t) % chunk))
  return terms.view(b, h, -1, chunk, d).sum(3).amax(2, keepdim=True)
