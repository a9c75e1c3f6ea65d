"""Training launcher on one device (the port of ``repro.launch.train``):
the reference's recipe, AdamW at lr 3e-3 with 20 warm-up steps and a
cosine decay over ``--steps``, on ``MarkovTokenStream`` batches
(branching 6), through :class:`repro_torch.train.trainer.Trainer`.
``--smoke`` shrinks the config so it runs anywhere.

  PYTHONPATH=src python -m repro_torch.launch.train --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \
      --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b

``--arch`` defaults to olmo-1b, the reference's default; every arch the
port serves (``configs.list_archs()``) trains but two: rwkv6-1.6b
through K7 and its backward (``--smoke`` gives it heads of 16, a size K7
takes), the others through K6 and its backward, a MoE's aux loss in the
loss, and a vlm on text (``train_loss`` takes ``img_embeds`` when a
caller gives them); jamba-1.5-large and whisper-base, which serve since
slice 8b, raise, naming slice 8c, which brings their training.
``--device`` defaults to ``cuda`` and the launcher raises without a
card.  The port trains on one device: ``--model-parallel`` above 1,
``--production-mesh`` and ``--profile fsdp`` raise, naming slice 7d.  The
run resumes from the newest checkpoint in ``--ckpt-dir`` when there is
one.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

from repro_torch.configs import ModelConfig, get_config, reduce_for_smoke
from repro_torch.data.synthetic import (DataCursor, MarkovTokenStream,
                                        TokenStreamConfig, token_batches)
from repro_torch.models.common import Device
from repro_torch.models.model import build_model
from repro_torch.models.transformer import check_trainable
from repro_torch.quant.policy import QuantPolicy
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts_lib
from repro_torch.train.trainer import Trainer, TrainerConfig

SLICE_7D = ("multi-device training (meshes, sharding, FSDP) comes with "
            "slice 7d of the port")


def recipe(steps: int, pe_type: str = "FP32") -> ts_lib.TrainConfig:
  """The reference launcher's TrainConfig for a run of ``steps``."""
  return ts_lib.TrainConfig(
      optimizer=opt_lib.AdamWConfig(lr=3e-3, warmup_steps=20,
                                    total_steps=steps),
      quant=QuantPolicy(pe_type=pe_type))


def make_trainer(cfg: ModelConfig, tcfg: ts_lib.TrainConfig, steps: int,
                 batch: int, seq: int, ckpt_dir: str,
                 device: Device = None) -> Trainer:
  """The launcher's Trainer: ``cfg`` on ``device`` (CUDA by default) from
  seed 0, fed ``MarkovTokenStream`` batches from a fresh cursor."""
  model = build_model(cfg, device=device)
  stream = MarkovTokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size,
                                               branching=6))
  cursor = DataCursor()
  return Trainer(model, tcfg,
                 TrainerConfig(total_steps=steps, log_every=20,
                               ckpt_every=100, ckpt_dir=ckpt_dir),
                 token_batches(stream, batch, seq, cursor), cursor=cursor,
                 seed=0)


def main(argv: Optional[List[str]] = None) -> Trainer:
  ap = argparse.ArgumentParser()
  ap.add_argument("--arch", default="olmo-1b")
  ap.add_argument("--steps", type=int, default=200)
  ap.add_argument("--batch", type=int, default=8)
  ap.add_argument("--seq", type=int, default=128)
  ap.add_argument("--pe-type", default="FP32")
  ap.add_argument("--smoke", action="store_true")
  ap.add_argument("--production-mesh", action="store_true",
                  help="build the 16x16 mesh (slice 7d)")
  ap.add_argument("--model-parallel", type=int, default=1)
  ap.add_argument("--profile", default="2d", choices=["2d", "fsdp"])
  ap.add_argument("--ckpt-dir", default=os.path.join(
      tempfile.gettempdir(), "repro_torch_launch_train"))
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)

  if (args.production_mesh or args.model_parallel > 1
      or args.profile == "fsdp"):
    raise NotImplementedError(SLICE_7D)
  cfg = get_config(args.arch)
  check_trainable(cfg)
  if args.smoke:
    cfg = reduce_for_smoke(cfg, d_model=128, n_layers=4, d_ff=256,
                           vocab_size=2048)
  trainer = make_trainer(cfg, recipe(args.steps, args.pe_type), args.steps,
                         args.batch, args.seq, args.ckpt_dir, args.device)
  trainer.maybe_restore()
  hist = trainer.run(args.steps - trainer.step)
  if hist:
    print(f"final loss {hist[-1]['loss']:.4f} after {trainer.step} steps "
          f"on {trainer.model.device}")
  return trainer


if __name__ == "__main__":
  main()
