"""The language-model trainer (the port of ``repro.train.trainer``): the
data pipeline, the eager train step, checkpoints and telemetry on one
device.

Every step is timed into the StragglerMonitor; checkpoints are atomic,
pruned and in the reference's format (``convert.train_state_to_tree``),
with the data cursor, so a restart resumes exactly; a retry wrapper
guards against transient step failures, and a step that failed after
writing the state (``PartialUpdateError``) is never retried.  A step
reads one number back from the device, its loss.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import tempfile
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.data.synthetic import DataCursor
from repro_torch.models.model import Model
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import train_step as ts_lib
from repro_torch.train.fault_tolerance import StragglerMonitor, retrying


@dataclasses.dataclass
class TrainerConfig:
  total_steps: int = 100
  log_every: int = 10
  ckpt_every: int = 50
  ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
  keep_ckpts: int = 3
  host_name: str = "host0"
  max_step_retries: int = 1


class Trainer:
  def __init__(self, model: Model, tcfg: ts_lib.TrainConfig,
               trainer_cfg: TrainerConfig,
               batches: Iterator[Dict[str, np.ndarray]],
               cursor: Optional[DataCursor] = None, seed: int = 0):
    self.model = model
    self.tcfg = tcfg
    self.cfg = trainer_cfg
    self.batches = batches
    self.cursor = cursor or DataCursor()
    self.monitor = StragglerMonitor()
    self.history: List[Dict[str, float]] = []
    self.state = ts_lib.make_train_state(model, tcfg, seed)
    self._step_fn = retrying(
        functools.partial(ts_lib.train_step, model, tcfg),
        max_retries=trainer_cfg.max_step_retries)
    self.step = 0

  # -- checkpoint integration --------------------------------------------
  def maybe_restore(self) -> bool:
    if not ckpt_lib.list_checkpoints(self.cfg.ckpt_dir):
      return False
    step, tree, extra = ckpt_lib.restore_checkpoint(self.cfg.ckpt_dir)
    convert.load_train_state(self.model.cfg, tree, self.state)
    self.step = step
    self.cursor.step = extra.get("data_step", step)
    return True

  def save(self) -> None:
    ckpt_lib.save_checkpoint(
        self.cfg.ckpt_dir, self.step,
        convert.train_state_to_tree(self.model.cfg, self.state),
        extra={"data_step": self.cursor.step}, keep=self.cfg.keep_ckpts)

  # -- the loop ------------------------------------------------------------
  def run(self, steps: Optional[int] = None) -> List[Dict[str, float]]:
    steps = steps if steps is not None else self.cfg.total_steps
    for _ in range(steps):
      batch = {k: torch.from_numpy(np.asarray(v)).to(self.model.device)
               for k, v in next(self.batches).items()}
      t0 = time.perf_counter()
      self.state, metrics = self._step_fn(self.state, batch)
      loss = float(metrics["loss"])
      dt = time.perf_counter() - t0
      self.monitor.record(self.cfg.host_name, dt)
      self.step += 1
      rec = {"step": self.step, "loss": loss, "sec": dt,
             "lr": float(metrics.get("lr", 0.0))}
      self.history.append(rec)
      if self.step % self.cfg.log_every == 0:
        print(f"step {self.step:5d} loss {loss:.4f} "
              f"({dt*1e3:.0f} ms)", flush=True)
      if self.cfg.ckpt_every and self.step % self.cfg.ckpt_every == 0:
        self.save()
    return self.history
