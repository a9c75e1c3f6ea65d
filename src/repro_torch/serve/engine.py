"""Serving engine: prefill + decode with a fixed-slot scheduler (the port
of ``repro.serve.engine``).

  * a fixed pool of decode slots, one request per slot; each decode call
    has batch 1, as in the reference
  * per-request state (prompt, generated, remaining budget)
  * prompts are left-padded with their first token to a fixed bucket (an
    RWKV model's recurrent state takes in the pad copies, as the
    reference's does)
  * attention models: KV caches optionally int8-quantized
    (cfg.kv_quant): decode attention then runs K5 over the codes, prefill
    attention K6; RWKV-6 models: a recurrent state per slot, prefill
    through K7
  * per-request deadlines (:class:`repro_torch.explore.service.Deadline`):
    expired queued requests are evicted before prefill, expired active
    requests release their slot mid-decode
  * greedy argmax, first index on ties (as ``jnp.argmax``)

The reference's ``jax.jit`` calls are eager calls here, under
``torch.inference_mode()`` (the Model facade's).  The engine runs on CUDA
unless the caller passes ``device="cpu"``, and raises without a card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.explore.service import Deadline
from repro_torch.models.common import Device, resolve_device
from repro_torch.models.model import Model


@dataclasses.dataclass
class Request:
  uid: int
  prompt: np.ndarray            # (len,) int32
  max_new_tokens: int
  generated: List[int] = dataclasses.field(default_factory=list)
  done: bool = False
  submitted_at: float = 0.0
  finished_at: float = 0.0
  deadline: Optional[Deadline] = None
  expired: bool = False


@dataclasses.dataclass
class EngineConfig:
  batch_slots: int = 8
  max_len: int = 512
  prompt_bucket: int = 128
  greedy: bool = True


class ServeEngine:
  """Synchronous continuous-batching engine over a Model."""

  def __init__(self, model: Model, params, ecfg: EngineConfig,
               device: Device = None):
    self.device = resolve_device(device, "ServeEngine")
    if model.device != self.device:
      raise ValueError(f"the model lives on {model.device}, the engine on "
                       f"{self.device}")
    self.model = model
    self.params = params
    self.ecfg = ecfg
    self.queue: List[Request] = []
    self.active: List[Optional[Request]] = [None] * ecfg.batch_slots
    self.caches: List[Any] = [None] * ecfg.batch_slots
    self._decode = model.decode_step
    self._prefill = lambda p, b: model.prefill(p, b, ecfg.max_len)
    self._uid = 0
    self.n_evicted = 0

  # -- client API ---------------------------------------------------------
  def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
             deadline: Optional[Union[Deadline, float]] = None) -> int:
    """Enqueue a request; ``deadline`` (a Deadline, or seconds from now)
    bounds its total queue + decode time."""
    if deadline is not None and not isinstance(deadline, Deadline):
      deadline = Deadline(float(deadline))
    self._uid += 1
    self.queue.append(Request(self._uid, np.asarray(prompt, np.int32),
                              max_new_tokens, submitted_at=time.time(),
                              deadline=deadline))
    return self._uid

  def run_until_drained(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
    """Generated tokens per finished uid; evicted requests appear with
    whatever partial generation they had (``request.expired`` marks
    them: an eviction is an answer, not a hang)."""
    out: Dict[int, List[int]] = {}
    for _ in range(max_steps):
      if not self.queue and all(r is None for r in self.active):
        break
      finished = self._admit() + self._step()
      for r in finished:
        out[r.uid] = list(r.generated)
    return out

  # -- internals ----------------------------------------------------------
  def _evict(self, req: Request) -> Request:
    req.done = True
    req.expired = True
    req.finished_at = time.time()
    self.n_evicted += 1
    return req

  def _admit(self) -> List[Request]:
    evicted = []
    for slot in range(self.ecfg.batch_slots):
      if self.active[slot] is not None or not self.queue:
        continue
      req = self.queue.pop(0)
      if req.deadline is not None and req.deadline.expired():
        # expired while queued: never spend prefill on it
        evicted.append(self._evict(req))
        continue
      bucket = self.ecfg.prompt_bucket
      prompt = req.prompt[-bucket:]
      pad = bucket - len(prompt)
      # left-pad with the first token (prefill consumes the full bucket;
      # positions are absolute so generation continues at bucket length)
      padded = np.concatenate(
          [np.full(pad, prompt[0] if len(prompt) else 0, np.int32), prompt])
      tokens = torch.from_numpy(padded[None]).to(self.device)
      logits, cache = self._prefill(self.params, tokens)
      first = int(torch.argmax(logits[0]))
      req.generated.append(first)
      self.active[slot] = req
      self.caches[slot] = cache
    return evicted

  def _step(self) -> List[Request]:
    finished = []
    for slot, req in enumerate(self.active):
      if req is None:
        continue
      if req.deadline is not None and req.deadline.expired():
        # mid-decode expiry: release the slot, keep the partial output
        finished.append(self._evict(req))
        self.active[slot] = None
        self.caches[slot] = None
        continue
      tok = torch.tensor([req.generated[-1]], dtype=torch.int32,
                         device=self.device)
      logits, cache = self._decode(self.params, tok, self.caches[slot])
      self.caches[slot] = cache
      nxt = int(torch.argmax(logits[0]))
      req.generated.append(nxt)
      if len(req.generated) >= req.max_new_tokens:
        req.done = True
        req.finished_at = time.time()
        finished.append(req)
        self.active[slot] = None
        self.caches[slot] = None
    return finished
