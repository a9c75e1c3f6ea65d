#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card: the design-space sweep,
serving qwen3-0.6b with an int8 KV cache, serving rwkv6-1.6b, serving
and training the model zoo (qwen2-moe-a2.7b, olmo-1b and the rest),
serving whisper-base and jamba-1.5-large, and deploying qwen3-0.6b under
each PE type's codec.

Run from the root of a checkout on a machine with an H100 (or another
sm_90a card), the CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch`` (into ``build/``),
checks exact float64 arithmetic on the card, holds each kernel against
its plain torch version at its path's shapes and times both, runs the
paper's full design space at 1,000,000 designs through
``ExplorationSession(TorchOracleBackend()).explore(..., stream=True)``
and checks that sweep against the same code on the CPU.  The paper's own
method follows: polynomial PPA models fitted on the host (or loaded from
``build/ppa_models.npz``) and evaluated on the card through
``PolynomialBackend`` for fig 4, Table 2, speedup_dse (against the scalar
oracle) and a 1,000,000-design table sweep, held bit for bit against the
same code on the CPU.  HW x NN co-exploration follows: 1,000
architectures x 10,000 HW designs (10,000,000 pairs) streamed through
``ExplorationSession(TorchOracleBackend()).co_explore(..., stream=True)``
on the card, one block's stages, a smaller joint stream held against
the CPU, and the polynomial joint path.  Guided search follows: the
README's NSGA-II benchmark (24 architectures, population 48, 24
generations; guided, surrogate and random arms) through
``ExplorationSession(TorchOracleBackend()).optimize`` on the card, held
to the reference's record bit for bit, a HW-only search held card
against CPU, one generation's stages, and the fault tolerance on the
card (a search killed and resumed from its journal, injected device
faults demoted along the card's ladder, co-explorations resumed on the
card and on the CPU, an injected hang under the watchdog).  The
exploration service follows: ``benchmarks/service_perf.py``'s recipe
through ``ExplorationService`` with a ``ResultStore`` (a cold grid sweep,
a store hit, a delta sweep, chaos sessions) held to its record's counts
and a session whose 3-D front launches K1; the 1,000,000-design sweep
through a ``DevicePool`` of the card (with the silent-corruption sentinel
recomputing on the CPU, and a quarantined pool raising), a store entry
written on the card and loaded by a CPU process, the sweep on four worker
threads (and traced at one and four), and
``benchmarks/framework_perf.py``'s resilience benchmark at full scale
against its record.  The paper's model side follows:
Table 2's QAT recipe (``benchmarks/accuracy_experiments.py``, ported as
``repro_torch.train.qat``) trains
resnet20 at the reference's sizes under each paper PE type, twice, and
resnet20, resnet56 and the VGG supernet at the paper's widths and 32 px;
figs 10-11 put those accuracies beside the polynomial models' figures,
fig 12 co-explores architectures scored by the port's weight-sharing
supernet (the reference's recipe, then 1,000 architectures of a 32-px
supernet through the 10,000,000-pair stream), the card is held to the
CPU from the same weights, and figs 5-9 and Table 3 are printed beside
the reference's values.  Then it serves
eight requests with a full-width qwen3-0.6b (bf16, int8 KV cache, random
weights from seed 0) through ``ServeEngine``, twice, and holds a
two-layer float32 copy of the model on the card to the same model on the
CPU.  The same traffic then goes through a full-width rwkv6-1.6b (bf16,
random weights from seed 0; its prefill runs the WKV6 kernel K7), twice,
with the same two-layer card-vs-CPU check.  Last, the codec matmuls K3
(int8) and K4 (LightPE) are held against their plain versions, a
full-width, 28-layer qwen3-0.6b (bf16, seed 0) is packed with
``quant.pack_params`` under each PE type and every packed matmul leaf of
every layer runs through K3 or K4 at a decode and a prefill shape, and a
two-layer float32 copy is packed on the card and on the CPU and held
byte for byte.  Slice 8a's zoo follows the serving of qwen3 and rwkv6:
K6 and K5 at the zoo's heads (K5 at G = 3, 6 and 48), full-width
qwen2-moe-a2.7b at 6 of its 24 layers (60 experts top-4 and 4 shared;
bf16, int8 KV) serving the same eight requests twice, its two-layer float32 copy held card
against CPU with its MoE routing, olmo-1b, minitron-4b and pixtral-12b
at full width and depth, mixtral-8x22b and granite-34b at full width and
a cut depth served two requests each, and all six held card against CPU
at two layers and a narrower width.  Slice 8b's two archs follow: K6
with fewer or more keys than queries (whisper's cross-attention) against
its plain version, full-width, full-depth whisper-base (its encoder over
1,500 frames, cross-attention through K6) serving four requests through
``Model.prefill`` and ``decode_step`` twice, jamba-1.5-large at every
published width, one 8-layer period of its layers and 8 of its 16
experts, serving four requests through ServeEngine twice, and both held
card against CPU in float32 (jamba's mamba caches too).  Training
follows: K6's backward kernel is held against its plain version at the training shape and its
edges, qwen3-0.6b at full width and 8 of its layers (bf16 compute, f32
master weights) trains for the launcher's recipe of 200 steps of 8 x 512
tokens, a two-layer float32 copy is held card against CPU (loss,
gradients, one AdamW step), and a restart from a checkpoint is held bit
for bit against an uninterrupted run; then the launcher's recipe and
Trainer train its default arch, olmo-1b at full width and 4 of its 16
layers, for 200 steps of 8 x 512 tokens and 5 steps each with int8
optimizer states, LightPE-2 QAT and two microbatches, two layers of
full-width qwen2-moe-a2.7b train 5 steps, and olmo-1b, qwen2-moe-a2.7b,
granite-34b and pixtral-12b (with image embeddings) are held card
against CPU at two layers.  rwkv6 training follows: K7's backward kernel
against its plain version at the training shape and its edges,
rwkv6-1.6b at full width and 8 of its layers trained with the launcher's
recipe for 200 steps of 8 x 512 tokens and 5 under LightPE-2 QAT, and its
two-layer float32 copy held card against CPU.  Any failure raises, so
the exit code is non-zero; without a CUDA device, or without the package
beside it, the script stops before printing any result.  The last line
of its output is one JSON object
naming the device.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet: HBM3 bandwidth, the FP64 (non-tensor-core) rate
# (a float64 compare is counted as one FP64 operation), the dense bf16
# tensor-core rate and the float32 non-tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP64_PER_S = 34e12
PEAK_BF16_PER_S = 989e12
PEAK_FP32_PER_S = 67e12
PEAK_INT8_PER_S = 1979e12

K1_SHAPE = (3, 65536, 128)  # D, N (one sweep chunk), block
K2_SHAPE = (3, 4096)        # D, N (the survivor cap)
SWEEP_PER_TYPE = 250_000    # x 4 paper PE types = 1,000,000 designs
SWEEP_CHUNK = 65536

# the paper's method: the fit (benchmarks' settings, cached under build/),
# fig 4 and Table 2 at 250 designs a type, speedup_dse's 500 a type with
# seeds 31 + i and 20 scalar-oracle designs, and a 1,000,000-design table
# sweep; its first 65,536 rows go through the CPU in [poly-parity]
POLY_CACHE = ROOT / "build" / "ppa_models.npz"
POLY_FIT = dict(degree=5, n_train=240, seed=0)
POLY_FIG_PER_TYPE = 250
POLY_SPEEDUP_PER_TYPE = 500
POLY_ORACLE_DESIGNS = 20
POLY_PARITY_ROWS = 65536

# co-exploration: the README's streamed HW x NN sweep, nothing cut
# (``benchmarks/framework_perf.py``'s streaming benchmark, the record in
# results/BENCH_streaming.json): 1,000 Table-4 architectures from
# RandomState(0), accuracies uniform(0.5, 0.95), 2,500 HW designs a paper
# PE type (10,000,000 pairs), seed 3, image size 16, 262,144-pair blocks;
# its parity check (archs, HW a type, block size) on the card and the
# CPU; the polynomial joint path (archs, HW a type) and the sub-block of
# it that runs on the CPU too
CO_ARCHS = 1000
CO_HW_PER_TYPE = 2500
CO_SEED = 3
CO_IMAGE = 16
CO_CHUNK = 262144
CO_JOINT3 = ("top1_err", "energy_mj", "area_mm2")
CO_PARITY = (100, 500, 16384)
CO_POLY = (100, 250)
CO_POLY_PARITY_ARCHS = 10
CO_RECORD = ROOT / "results" / "BENCH_streaming.json"

# guided search: the README's benchmark (``benchmarks/search_perf.py``,
# its record results/BENCH_search.json), nothing cut: 24 Table-4
# architectures drawn as co_arch_accs draws them, population 48, 24
# generations, seed 7 (the random arm: one generation of the guided arm's
# budget, seed 8); the HW-only search of resnet20: population 48, 24
# generations, seed 17; the breakdown's journaled prefix; the generation
# [resilience] (a) kills
SEARCH = dict(n_archs=24, population=48, generations=24, seed=7)
SEARCH_OBJ = ("top1_err", "energy_mj", "area_mm2")
SEARCH_HW = dict(population=48, generations=24, seed=17)
SEARCH_RECORD = ROOT / "results" / "BENCH_search.json"
SEARCH_BREAKDOWN_GENS = 4
SEARCH_KILL_GEN = 12
BASE_COLS = ("latency_s", "power_mw", "area_mm2")
SEARCH_COLS = BASE_COLS + ("top1", "arch_id")
# fault tolerance: [parity]'s 100,000-design fused stream in 16,384-row
# chunks under a seeded plan of device faults; co-explorations killed at a
# block ([coexplore-parity]'s size, and a smaller one (archs, HW a type,
# block) resumed on the CPU); a small stream under the watchdog
RES_CHUNK = 16384
RES_FAULT_SEED = 3
RES_CO_KILL = 7
RES_CO_SMALL = (20, 100, 512)
RES_HANG = dict(n_per_type=2500, seed=9, chunk=4096)

# the result store, the service and the fleet: benchmarks/service_perf.py's
# recipe at full scale (its record results/BENCH_service.json): resnet20's
# first 4 layers, a grid taking this many values of each axis (the edit
# adds pe_rows' next value), 65,536-row chunks, 5,000 random designs a
# type in each chaos session; one more session, and the fleet's sentinel
# and quarantine runs, over [parity]'s 100,000-design stream with
# sweep_reducers() (its 3-D front runs K1); [store-parity]'s sweep (designs
# a type, seed, chunk), small enough for the CPU to recompute; [workers]'
# thread count; benchmarks/framework_perf.py::resilience_perf at full
# scale (its record results/BENCH_resilience.json): 200 archs from
# RandomState(0) x 500 HW a type, 65,536-pair blocks
SERVICE_RECORD = ROOT / "results" / "BENCH_service.json"
SERVICE_TAKE = {"pe_rows": 8, "pe_cols": 9, "sp_if": 8, "sp_fw": 8,
                "sp_ps": 7, "gbuf_kb": 7, "bandwidth_gbps": 1}
SERVICE_CHUNK = 65536
SERVICE_CHAOS_PER_TYPE = 5000
SERVICE_K1 = dict(n_per_type=25_000, seed=5, chunk=RES_CHUNK)
FLEET_SDC_EVERY = 4
STORE_PARITY = dict(n_per_type=5000, seed=11, chunk=4096)
WORKERS = 4
# [workers-trace] profiles half of [sweep]'s designs (8 chunks, twice
# the 4 workers' window): the profiler's post-processing grows with the
# launches it records
TRACE_PER_TYPE = SWEEP_PER_TYPE // 2
RES_PERF = dict(n_archs=200, n_hw_per_type=500, chunk=65536)
RES_PERF_RECORD = ROOT / "results" / "BENCH_resilience.json"

# the paper's model side: benchmarks/accuracy_experiments.py's QAT recipe
# (_train_qat, ported as repro_torch.train.qat.train_qat: CifarLike seed 0,
# SGD lr 0.05 with 40 steps an epoch and drops at epochs 2 and 3, 120
# steps of batch 64 at split_seed=step, 512 validation images at split
# 10,000,019 as one batch); (a) at its own
# sizes (resnet20 at width 8, 16 px), twice, beside its values on a host
# CPU (JAX 0.9.0: python -m benchmarks.run --suite accuracy --only table2;
# the port draws its own initial weights); (b) at the paper's widths and
# image size: width 16, 32 px, resnet20, resnet56 and the VGG supernet at
# max_arch(), for QAT_PAPER_STEPS steps, the only changes from (a)
QAT_REF_CPU = {"FP32": 0.941, "INT16": 0.938, "LightPE-1": 0.951,
               "LightPE-2": 0.965}
QAT_REF_TOL = 0.05
QAT_PAPER = (("resnet20", 16), ("resnet56", 16), ("vgg", 16))
QAT_PAPER_IMAGE = 32
# (b)'s steps, a third of the recipe's 120: the paper's widths run their
# path at a third of the cost, to keep the script well inside its time
# limit (the slowest host seen ran the whole script in 1,195 s)
QAT_PAPER_STEPS = 40
# the steps [accuracy-profile] traces: (network, PE type, width, px)
QAT_PROFILE = (("resnet20", "FP32", 8, 16), ("resnet20", "LightPE-2", 8, 16),
               ("resnet56", "LightPE-2", 16, 32), ("vgg", "LightPE-2", 16, 32))
# figs 10-11 (designs a type) and fig 12: (a) the reference's recipe
# (supernet, archs, validation images, HW designs a type), (b) the paper's
# scale: the 32-px supernet at its defaults (batch 64, 300 steps), 1,000
# archs on 512 images, [coexplore]'s stream (2,500 HW a type) at 32 px;
# and the reference's values on a host CPU (benchmarks/accuracy_
# experiments.py and benchmarks/paper_figures.py, JAX 0.9.0)
FIG1011_PER_TYPE = 150
FIG1011_REF_CPU = dict(
    ppa={"FP32": 0.63, "INT16": 1.00, "LightPE-1": 2.80, "LightPE-2": 2.51},
    energy={"FP32": 3.132, "INT16": 0.972, "LightPE-1": 0.262,
            "LightPE-2": 0.186},
    front_ppa="LightPE-1/LightPE-2", front_energy="LightPE-2")
FIG12_REF = dict(supernet=dict(steps=80, batch=32, image_size=16),
                 n_archs=12, n_val=256, n_hw_per_type=8)
FIG12_REF_CPU = dict(pairs=384, front_energy="LightPE-1/LightPE-2",
                     acc_range=(0.246, 0.555))
FIG12_PAPER = dict(supernet=dict(image_size=32), n_archs=1000, n_val=512,
                   n_hw_per_type=CO_HW_PER_TYPE, image_size=32)
# [accuracy-parity]: the card against the CPU from the same weights and
# batch: resnet20 at width 8 and the VGG supernet under a masked arch,
# both at 16 px and batch 64; 10 QAT steps; 3 supernet steps
ACC_PARITY_MASKED = ((1, 40), (2, 96), (1, 224), (3, 320), (2, 448))
ACC_PARITY_STEPS = 10
ACC_PARITY_SUPERNET_STEPS = 3
# bounds, card vs CPU (H20; tests/test_torch_cnn.py holds the port to the
# reference with the same numbers): (logits, loss) relative to the largest
# |value|; a quantized type's at least twice the CPU's own largest move
# under three one-ulp jitters of the weights; FP32 gradients per leaf; a
# quantized conv's output and gradients from identical inputs; the QAT
# losses a step; the supernet's losses
ACC_BOUNDS = {"FP32": (1e-4, 1e-5), "INT16": (1e-3, 1e-4),
              "LightPE-1": (2e-2, 2e-3), "LightPE-2": (2e-2, 2e-3)}
ACC_FP32_GRADS = 1e-4
ACC_LAYER = 1e-5
ACC_STEPS_BOUND = {"FP32": 1e-4, "LightPE-2": 2e-2}
ACC_SUPERNET_BOUND = 1e-4
# [paper-figs]: the reference's benchmarks/paper_figures.py on a host CPU
# (JAX 0.9.0): fig 5's best degrees and power MAPE/RMSPE a degree; figs
# 6-8's power, area and latency MAPE (%) and power and latency R^2 a PE
# type; fig 9's median and best perf/area and energy a network and type;
# Table 3's clocks (MHz)
PAPER_FIGS_REF_CPU = dict(
    fig5=dict(best_power=3, best_area=3, curve={
        1: (0.95, 1.27), 2: (0.34, 0.43), 3: (0.33, 0.41), 4: (0.34, 0.43),
        5: (0.42, 0.57), 6: (0.60, 1.07), 7: (0.83, 1.61), 8: (1.29, 3.20)}),
    fig6_8={"FP32": (0.61, 0.47, 24.15, 0.9992, 0.6685),
            "INT16": (0.52, 0.53, 23.24, 0.9997, 0.6925),
            "LightPE-1": (0.49, 0.55, 23.11, 0.9997, 0.6941),
            "LightPE-2": (0.53, 0.58, 23.11, 0.9998, 0.6943)},
    fig9={"vgg16": {"FP32": (0.14, 0.39, 13.020, 5.051),
                    "INT16": (0.28, 1.00, 3.445, 1.000),
                    "LightPE-1": (0.71, 2.13, 1.058, 0.359),
                    "LightPE-2": (0.59, 2.11, 1.278, 0.275)},
          "resnet20": {"FP32": (0.18, 0.63, 7.579, 3.132),
                       "INT16": (0.32, 1.00, 2.161, 0.972),
                       "LightPE-1": (0.93, 2.80, 0.565, 0.262),
                       "LightPE-2": (0.73, 2.51, 0.692, 0.186)},
          "resnet56": {"FP32": (0.19, 0.63, 7.072, 3.127),
                       "INT16": (0.33, 1.00, 2.040, 0.939),
                       "LightPE-1": (0.97, 2.84, 0.535, 0.249),
                       "LightPE-2": (0.76, 2.62, 0.674, 0.178)}},
    table3={"FP32": 275, "INT16": 284, "LightPE-1": 454, "LightPE-2": 434})

# serving: the K6 prefill shape (one 512-token bucket of qwen3-0.6b), the
# K5 decode shape (one slot's cache of 2,048 positions) and the traffic
K6_SHAPE = (1, 512, 16, 8, 128)       # B, S, H, Hkv, D
K6_WINDOW = 128
K5_SHAPE = (1, 16, 8, 2048, 128)      # B, H, Hkv, S, D
# lengths 1, 300, 544 (the positions a serving decode step reads: the
# 512-token prompt bucket plus 32 new tokens) and a full cache
K5_LENGTHS = (1, 300, 544, 2048)
K5_COLD_CACHES = 16                    # x 4.3 MB: more than the 50 MB L2
SERVE_REQUESTS = 8
SERVE_NEW_TOKENS = 32
SERVE_ENGINE = dict(batch_slots=4, max_len=2048, prompt_bucket=512)
PARITY_LAYERS = 2
# slice 8a: K6 and K5 at the zoo's (H, Hkv) beyond qwen3's: granite-34b's
# multi-query (48, 1), minitron-4b's (24, 8) and mixtral-8x22b's (48, 8);
# K5 (G = 3, 6, 48) over a 2,048-position cache at these lengths, cycling
# through caches of at least this many bytes in all (cold in the L2)
K6_ZOO_HEADS = ((48, 1), (24, 8), (48, 8))
K5_ZOO_HEADS = ((24, 8), (48, 8), (48, 1))
K5_ZOO_LENGTHS = (1, 300, 2048)
K5_COLD_BYTES = 64e6
# qwen2-moe-a2.7b served at full width and SERVE_MOE_LAYERS of its 24
# layers ([serve-moe]; all 24 took 35.2-40.2 s a phase, 12 took 23.9 s: a
# cut paying for slice 8b's phases in the script's time); the zoo
# served once each, 2 requests x 8 new tokens, at full width with the depth
# cut of each arch (None: all its layers; mixtral-8x22b's 56 layers of
# 8 x 16,384-wide experts are 281 GB of bf16 weights, granite-34b's 88
# layers 68.7 GB); each held card against CPU at 2 layers and the width
# below, the config's own heads and head dim kept
SERVE_MOE_ARCH = "qwen2-moe-a2.7b"
SERVE_MOE_LAYERS = 6
SERVE_ZOO = (("olmo-1b", None), ("minitron-4b", None), ("pixtral-12b", None),
             ("mixtral-8x22b", 4), ("granite-34b", 8))
SERVE_ZOO_REQUESTS = 2
SERVE_ZOO_NEW_TOKENS = 8
ZOO_ARCHS = ("olmo-1b", "granite-34b", "minitron-4b", "mixtral-8x22b",
             "qwen2-moe-a2.7b", "pixtral-12b")
ZOO_PARITY_WIDTH = dict(d_model=512, d_ff=1024, vocab_size=4096)
ZOO_PARITY_EXPERTS = dict(max_experts=8, d_ff_expert=512, d_ff_shared=1024)
ZOO_PARITY_WINDOW = 32   # mixtral's ring, shorter than every prompt
# slice 8b: K6 with S_q != S_k, whisper-base's cross-attention (H = Hkv =
# 8, D = 64, non-causal, B = the 4 requests of [serve-whisper]): queries
# of a decode-like row, the 64-row tile's edges and whisper's 448-token
# decoder context against its 1,500 encoder frames, and the encoder's own
# self-attention at S_q = S_k = 1,500
K6_CROSS = dict(b=4, h=8, hkv=8, d=64, sk=1500)
K6_CROSS_SQ = (1, 63, 65, 448, 1500)
# [serve-whisper]: full-width, full-depth whisper-base (bf16, int8 self-
# attention KV), 4 requests of enc_frames (4, 1,500, 512) and 16-token
# prompts from the seed, 32 decode steps, twice; [serve-whisper-parity] at
# 2 encoder and 2 decoder layers in float32
WHISPER_SERVE = dict(batch=4, prompt=16, steps=32, max_len=64, seed=30)
# [serve-jamba]: jamba-1.5-large at every published width, one 8-layer
# period of its 72 layers (attention + 7 mamba, MoE at 1, 3, 5, 7) and 8
# of its 16 experts (72 layers are 797 GB of bf16 weights, one period
# with 16 experts ~90 GB, with 8 ~52 GB), 4 requests through ServeEngine
# (64-token bucket, 16 new tokens), twice; [serve-jamba-parity] at one
# period and ZOO_PARITY_WIDTH in float32
JAMBA_CUT = dict(n_layers=8, n_experts=8)
JAMBA_REQUESTS = 4
JAMBA_NEW_TOKENS = 16
JAMBA_ENGINE = dict(batch_slots=4, max_len=128, prompt_bucket=64)
# training: K6's backward at the training shape (B = 8 sequences of 512
# tokens of qwen3-0.6b) in bf16 and f32, a window, ragged S and D = 64
# with G = 2; the launcher's run at full width; 5 steps of each variant;
# card vs CPU at 2 layers; a restart at 4 layers from a checkpoint every
# 3 steps
K6_BWD_CASES = ((8, 512, 16, 8, 128, "bfloat16", 0),
                (8, 512, 16, 8, 128, "float32", 0),
                (8, 512, 16, 8, 128, "bfloat16", 128),
                (2, 63, 16, 8, 128, "bfloat16", 0),
                (2, 65, 16, 8, 128, "bfloat16", 0),
                (2, 513, 16, 8, 128, "bfloat16", 0),
                (2, 300, 8, 4, 64, "bfloat16", 0),
                (2, 300, 8, 4, 64, "float32", 0))
# the bf16 backward's earlier design, f32 FMAs on the CUDA cores, on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md's kernel table): its time at
# B = 8, S = 512
K6_BWD_CUDA_CORE = {"ms": 2.1993}
# the launcher's recipe at 200 steps, its default, of 8 x 512 tokens: in
# 40 the reference's recipe (lr 3e-3, 20 warm-up steps, cosine decay) does
# not get a loss below the uniform guess at a 151,936-token vocab (PERF.md
# section 6)
TRAIN_RECIPE = dict(steps=200, batch=8, seq=512)
# [train]'s qwen3-0.6b runs 8 of its 28 layers (the recipe kept), to pay
# for slice 8a's phases in the script's time
TRAIN_QWEN3_LAYERS = 8
# [train-olmo]: the launcher's default arch, olmo-1b, with the same recipe
# and Trainer as [train], at full width and TRAIN_OLMO_LAYERS of its 16
# layers (all 16 through the launcher's main(argv) took 117.0-136.1 s a
# phase, 8 layers 59.9-69.6 s: a cut paying for slice 8b's phases in the
# script's time); the three 5-step variants run on the same cut
TRAIN_OLMO_ARCH = "olmo-1b"
TRAIN_OLMO_LAYERS = 4
TRAIN_VARIANT_STEPS = 5
TRAIN_PARITY_BATCH = (2, 128)
# [train-moe]: qwen2-moe-a2.7b at full width, 2 layers
TRAIN_MOE = dict(n_layers=2, steps=5, batch=8, seq=512)
# [train-parity] for slice 8a, 2 layers f32 card vs CPU: (arch, the width
# cut where the CPU's side at full width takes more than ~30 s: 2 layers
# of full-width qwen2-moe-a2.7b took 212.8 s, pixtral-12b at d_model 2,048
# 55.4 s, granite-34b 38.2 s, on the card's host; heads, head dim and
# experts kept); pixtral-12b's batch opens with n_image_tokens image
# embeddings
TRAIN_PARITY_ZOO = (
    ("olmo-1b", {}),
    ("qwen2-moe-a2.7b", dict(d_model=1024, d_ff_expert=512,
                             d_ff_shared=2048, vocab_size=32768)),
    ("granite-34b", dict(d_model=1024, d_ff=4096)),
    ("pixtral-12b", dict(d_model=1024, d_ff=4096, vocab_size=32768)))
# [train-rwkv-parity]'s bound on each gradient leaf, of its largest
# |value|.  An rwkv6 gradient is ill-conditioned where qwen3's is not: the
# per-head group norm divides a WKV output by its RMS, which is small for
# a head whose first token's bonus r_0 . (u k_0) nearly cancels, and so it
# amplifies the card's K7 forward rounding (within 1e-4 of the plain
# version's output) into the gradients upstream of it.  The card read
# 7.04e-4 of u's max from the plain CPU (H100 80GB HBM3, 700 W); the bound
# is about 4 x that, far below the O(1) a wrong kernel gives.
RWKV_PARITY_GRAD_TOL = 3e-3
# K7's backward's first design (one block per (batch, head), CUDA-core
# FMAs) on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md's kernel table): its
# time at B = 8, T = 512 bf16
K7_BWD_FIRST = {"ms": 1.8629}
TRAIN_RESUME = dict(n_layers=4, steps=12, ckpt_every=3, batch=8, seq=512)
# K7's backward: (B, T, H, D, chunk, dtype, s0 and ds_final, w down to
# 1e-30): the rwkv6-1.6b training shape in bf16 and f32, a ragged T with a
# state and its gradient, T = 2,048, head dims 32 and 16, and w at the
# floor
K7_BWD_CASES = ((8, 512, 32, 64, 64, "bfloat16", False, False),
                (8, 512, 32, 64, 64, "float32", False, False),
                (2, 300, 32, 64, 64, "bfloat16", True, False),
                (2, 2048, 32, 64, 64, "bfloat16", True, False),
                (2, 300, 8, 32, 32, "bfloat16", True, False),
                (2, 300, 8, 16, 16, "float32", True, False),
                (2, 300, 32, 64, 64, "bfloat16", True, True))
# rwkv6-1.6b's training run: TRAIN_RECIPE, then 5 steps under LightPE-2
# QAT; at full width and 8 of its 24 layers, to pay for slice 8a's phases
# in the script's time (at 24 layers the phase took 218.7 s of a
# 1,095.4-s run)
TRAIN_RWKV_LAYERS = 8
# K7 at the rwkv6-1.6b prefill shape (one 512-token bucket), a ragged T,
# and a T of more chunks than K7's cluster has blocks (4 chunks a block)
K7_SHAPE = (1, 512, 32, 64, 64)        # B, T, H, D, chunk
K7_RAGGED_T = 300
K7_LONG_T = 2048
# the codecs: K3 and K4 at qwen3-0.6b's ffn/wi (K, N), a decode token and
# the engine's prompt bucket, and a ragged shape (K3 also at the other
# three (K, N) of a layer: mix/wq and mix/wkv, mix/wo, ffn/wo); the matmul
# leaves of a layer; the PE types packed (FP32 is the no-op)
CODEC_KN = (1024, 3072)
CODEC_LAYER_KN = ((1024, 2048), (2048, 1024), (1024, 3072), (3072, 1024))
CODEC_MS = (1, 512)
CODEC_RAGGED = (5, 1000, 70)
CODEC_LEAVES = (("mix", "wq"), ("mix", "wkv"), ("mix", "wo"),
                ("ffn", "wi"), ("ffn", "wg"), ("ffn", "wo"))
CODEC_PE_TYPES = ("INT16", "INT8", "INT4", "LightPE-1", "LightPE-2")
CODEC_PARITY_M = 64


def log(msg: str = "") -> None:
  print(msg, flush=True)


def capture(fn, warmup: int = 2):
  """``fn`` captured as one CUDA graph, after ``warmup`` eager calls on a
  side stream (as capture asks); returns the graph and ``fn``'s result
  from the capture, which each replay rewrites."""
  import torch
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(warmup):
      fn()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    out = fn()
  return graph, out


def replay_ms(graph, samples: int = 25) -> float:
  """Median time of one replay of ``graph`` between CUDA events."""
  import torch
  graph.replay()
  torch.cuda.synchronize()
  times = []
  for _ in range(samples):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


def cuda_ms(fn, samples: int = 25, inner: int = 10) -> float:
  """Median device time of one ``fn()`` call: ``inner`` back-to-back calls
  are captured as one CUDA graph and its replays timed, so the host's
  launch cost, which is not the kernel's, is left out."""
  def calls():
    for _ in range(inner):
      fn()
  graph, _ = capture(calls)
  return replay_ms(graph, samples) / inner


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_FP64_PER_S):
  t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
  t_ops = n_ops / peak_ops * 1e3
  return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def timed_stage(rows, name, fn):
  """``fn()`` between two syncs; appends (name, host ms, ms between CUDA
  events around it on the stream, which include the gaps where the card
  waits for the host) to ``rows`` and returns ``fn``'s result."""
  import torch
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  t0 = time.perf_counter()
  start.record()
  out = fn()
  end.record()
  torch.cuda.synchronize()
  rows.append((name, (time.perf_counter() - t0) * 1e3,
               start.elapsed_time(end)))
  return out


def planted_objectives(d: int, n: int, seed: int):
  """Seeded float64 objectives with planted exact ties and duplicates."""
  import numpy as np
  rng = np.random.RandomState(seed)
  obj = rng.uniform(size=(n, d))
  obj[rng.randint(0, n, n // 8), 0] = 0.5           # ties on one axis
  dup = rng.randint(0, n, (n // 16, 2))
  obj[dup[:, 0]] = obj[dup[:, 1]]                    # duplicated points
  rows = rng.randint(0, n, n // 32)
  obj[rows] = np.round(obj[rows], 2)                 # coarse grid: more ties
  return obj


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_setup():
  import torch
  from repro_torch import _build
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
      f"python {sys.version.split()[0]}")
  log(f"[setup] card {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")
  t0 = time.perf_counter()
  built = _build.build_all()
  log(f"[build] {len(built)} source(s) compiled in "
      f"{time.perf_counter() - t0:.2f} s: {sorted(built)}")
  for src in _build.sources():
    text = _build.build_log(src.stem)
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
    spills = [line.strip() for line in text.splitlines()
              if any(int(n) for n in re.findall(r"(\d+) bytes spill", line))]
    log(f"[build] {src.name}: {len(regs)} kernels, at most "
        f"{max(regs, default=0)} registers a thread, "
        f"{'spills: ' + '; '.join(spills) if spills else 'no spills'}")
  return smi


def phase_probe():
  from repro_torch.explore import device as device_lib
  report = device_lib.ensure_exact("cuda")
  for name, ok in report["checks"].items():
    log(f"[probe] {name}: {'exact' if ok else 'NOT EXACT'}")
  for name, count in report["raw_mismatches"].items():
    log(f"[probe] avoided form {name}: {count} mismatches vs numpy")
  return report


def phase_kernels():
  """Each kernel vs its plain version on the card, at the sweep's shapes."""
  import torch
  from repro_torch.kernels.pareto_front import kernel, ops, ref
  results = {}
  d, n, block = K1_SHAPE
  obj = torch.from_numpy(planted_objectives(d, n, seed=1)).cuda()
  obj_t = ops._pad_feature_major(obj, block)
  got = kernel.block_dominance_counts(obj_t, block)
  want = ref.block_dominance_counts_ref(obj_t.T, block)
  torch.cuda.synchronize()
  err = int((got.long() - want.long()).abs().max())
  if err:
    raise AssertionError(f"K1 counts differ from the plain version: {err}")
  ms = cuda_ms(lambda: kernel.block_dominance_counts(obj_t, block))
  plain_ms = cuda_ms(lambda: ref.block_dominance_counts_ref(obj_t.T, block))
  b_ms, b_by = bound_ms(d * n * 8 + n * 4, n * block * 2 * d)
  results["block_dominance_counts"] = dict(
      name="block_dominance_counts (K1)", route="cuda",
      source="src/repro_torch/kernels/pareto_front/csrc/pareto_front.cu",
      replaces="src/repro/kernels/pareto_front/kernel.py:97",
      on_main_path=True, max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
      bound_ms=b_ms, bound_by=b_by, library_ms=None)
  log(f"[K1] D={d} N={n} block={block}: counts equal "
      f"({int((got == 0).sum())} block survivors); kernel {ms:.4f} ms, "
      f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

  d, n = K2_SHAPE
  obj = torch.from_numpy(planted_objectives(d, n, seed=2)).cuda()
  obj_t = ops._pad_feature_major(obj, kernel.PAIR_TILE)
  got = kernel.dominance_counts(obj_t)
  want = ref.dominance_counts_ref(obj)
  torch.cuda.synchronize()
  err = int((got.long() - want.long()).abs().max())
  if err:
    raise AssertionError(f"K2 counts differ from the plain version: {err}")
  again = kernel.dominance_counts(obj_t)
  if not torch.equal(got, again):
    raise AssertionError("K2 counts differ between two runs")
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  splits = kernel.pair_splits(obj_t.shape[1], sms)
  ms = cuda_ms(lambda: kernel.dominance_counts(obj_t))
  plain_ms = cuda_ms(lambda: ref.dominance_counts_ref(obj), inner=2)
  b_ms, b_by = bound_ms(d * n * 8 + n * 4, n * n * 2 * d)
  results["dominance_counts"] = dict(
      name="dominance_counts (K2)", route="cuda",
      source="src/repro_torch/kernels/pareto_front/csrc/pareto_front.cu",
      replaces="src/repro/kernels/pareto_front/kernel.py:75",
      on_main_path=False, max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
      bound_ms=b_ms, bound_by=b_by, library_ms=None)
  log(f"[K2] D={d} N={n}: counts equal ({int((got == 0).sum())} on the "
      f"front), a rerun equal; j tiles split {splits} ways "
      f"(pair_splits({obj_t.shape[1]}, {sms} SMs)): "
      f"{obj_t.shape[1] // kernel.PAIR_TILE} x {splits} blocks; kernel "
      f"{ms:.4f} ms (the first design, one block an i tile: 0.0888 ms), "
      f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
  return results


def sweep_reducers():
  from repro_torch.explore import (HistogramAccumulator, ParetoAccumulator,
                                   StatsAccumulator, TopKAccumulator)
  return {"pareto": ParetoAccumulator(),
          "pareto3": ParetoAccumulator(("latency_s", "energy_mj",
                                        "area_mm2")),
          "top": TopKAccumulator(100, by="energy_mj"),
          "stats": StatsAccumulator("perf_per_area"),
          "hist": HistogramAccumulator("area_mm2", 0.0, 200.0, bins=64)}


def phase_sweep(layers):
  """The main path: 1,000,000 designs of the paper's space, streamed."""
  import numpy as np
  import torch
  from repro_torch.explore import (DesignSpace, ExplorationSession,
                                   TorchOracleBackend)
  from repro_torch.kernels.pareto_front import kernel
  session = ExplorationSession(TorchOracleBackend(chunk_size=SWEEP_CHUNK),
                               DesignSpace())
  kernel.reset_launch_counts()
  res = session.explore(layers, "resnet20", n_per_type=SWEEP_PER_TYPE,
                        stream=True, reducers=sweep_reducers(),
                        chunk_size=SWEEP_CHUNK)
  torch.cuda.synchronize()
  launches = dict(kernel.LAUNCHES)
  m = res.meta
  log(f"[sweep] {res.n_rows} designs in {int(m['n_chunks'])} chunks, "
      f"{m['seconds']:.3f} s: {m['rows_per_sec']:.1f} rows/s; "
      f"rows_transferred/n_rows = "
      f"{m['rows_transferred'] / res.n_rows:.6f}; "
      f"n_overflows {int(m['n_overflows'])}; "
      f"n_demotions {int(m['n_demotions'])}")
  energy = res["top"].energy_mj
  log(f"[sweep] fronts: 2-D {len(res['pareto'])}, 3-D {len(res['pareto3'])}; "
      f"top-100 energy {energy[0]:.6g}..{energy[-1]:.6g} mJ; "
      f"perf/area mean {res['stats']['mean']:.6g}; "
      f"hist total {int(res['hist']['counts'].sum())}")
  log(f"[sweep] kernel launches during the sweep: {launches}")
  if res.n_rows != 4 * SWEEP_PER_TYPE:
    raise AssertionError(f"swept {res.n_rows} rows")
  if launches["block_dominance_counts"] != int(m["n_chunks"]):
    raise AssertionError("K1 did not launch once per chunk: "
                         f"{launches} for {int(m['n_chunks'])} chunks")
  if m["n_demotions"] != 0:
    raise AssertionError(f"{m['n_demotions']} demotions")
  if int(res["hist"]["counts"].sum()) != res.n_rows:
    raise AssertionError("histogram lost rows")
  for name in ("pareto", "pareto3", "top"):
    f = res[name]
    if not len(f) or not all(np.isfinite(f.column(c)).all() for c in
                             ("latency_s", "power_mw", "area_mm2")):
      raise AssertionError(f"{name}: empty or non-finite survivors")
  return res, launches


def phase_breakdown(layers):
  """Where one chunk's time goes.  Each stage runs between two syncs and
  reports its host wall time and the time between CUDA events around it
  on the stream (which includes the gaps where the card waits for the
  host).  The oracle formulas are also captured as one CUDA graph: its
  replay time is their device time without launch gaps."""
  import numpy as np
  import torch
  from repro_torch.core import oracle
  from repro_torch.explore import DesignSpace, TorchOracleBackend
  from repro_torch.explore import device as device_lib
  from repro_torch.explore.device import build_plan
  from repro_torch.explore.streaming import fold_chunk, new_counters
  backend = TorchOracleBackend(chunk_size=SWEEP_CHUNK)
  chunk = next(DesignSpace().iter_tables(SWEEP_PER_TYPE, seed=17,
                                         chunk_size=SWEEP_CHUNK))
  plan = build_plan(sweep_reducers(), joint=False)
  rows = []
  stage = lambda name, fn: timed_stage(rows, name, fn)

  for _ in range(2):  # the first pass warms caches; report the second
    rows.clear()
    inputs = stage("host batch_inputs", lambda: oracle.batch_inputs(chunk))
    placed = stage("pack + copy to device", lambda: backend._place(inputs))
    ch = stage("oracle formulas",
               lambda: oracle.characterize_batch(placed, layers))
    cols = stage("derive columns", lambda: device_lib._derive_columns(
        ch.latency_s[None, :], ch.power_mw[None, :], ch.area_mm2[None, :]))
    for name, spec in plan:
      one = device_lib.DevicePlan(specs=((name, spec),), cap=plan.cap)
      stage(f"reduce {name}", lambda: device_lib._reduce_outputs(
          cols, one, grouped=False))
    pend = stage("fused chunk (dispatch)", lambda: backend.fused_eval_pending(
        chunk, layers, "resnet20", plan, np.arange(len(chunk))))
    fused = stage("fused chunk (resolve)", pend.resolve)
    stage("host fold into the reducers", lambda: fold_chunk(
        sweep_reducers(), new_counters(), fused))
  for name, host_ms, event_ms in rows:
    log(f"[breakdown] {name}: host {host_ms:.3f} ms, events {event_ms:.3f} ms")

  graph, captured = capture(lambda: oracle.characterize_batch(placed,
                                                              layers))
  graph_ms = replay_ms(graph, samples=10)
  for f in ("latency_s", "power_mw", "area_mm2"):
    if not torch.equal(getattr(captured, f), getattr(ch, f)):
      raise AssertionError(f"graph replay changed {f}")
  eager_ms = next(e for name, _, e in rows if name == "oracle formulas")
  log(f"[breakdown] oracle formulas as one CUDA graph replay: {graph_ms:.3f} "
      f"ms on the card (eager: {eager_ms:.3f} ms between events, so the "
      f"card is busy {graph_ms / eager_ms:.1%} of that stage)")


def _frames_equal(a, b) -> bool:
  import numpy as np
  return (len(a) == len(b)
          and all(np.array_equal(a.column(c), b.column(c))
                  for c in ("latency_s", "power_mw", "area_mm2"))
          and np.array_equal(a.pe_type, b.pe_type))


def phase_parity(layers, sweep):
  """The card against the port's plain path on the CPU."""
  import numpy as np
  import torch
  from repro_torch.core.table import ConfigTable
  from repro_torch.explore import DesignSpace, TorchOracleBackend
  from repro_torch.explore.streaming import stream_explore
  from repro_torch.kernels.pareto_front import ops
  space = DesignSpace()
  chunks = space.iter_tables(SWEEP_PER_TYPE, seed=17, chunk_size=SWEEP_CHUNK)
  table = ConfigTable.concat([next(chunks), next(chunks)])
  gpu = TorchOracleBackend(chunk_size=SWEEP_CHUNK).evaluate_table(table,
                                                                  layers)
  cpu = TorchOracleBackend(chunk_size=SWEEP_CHUNK,
                           device="cpu").evaluate_table(table, layers)
  rel = max(float(np.max(np.abs(getattr(gpu, c) / getattr(cpu, c) - 1.0)))
            for c in ("latency_s", "power_mw", "area_mm2"))
  log(f"[parity] evaluate_table, first two sweep chunks ({len(table)} rows): "
      f"parity_max_rel_err = {rel!r}")
  if rel != 0.0 or not _frames_equal(gpu, cpu):
    raise AssertionError("cuda and cpu evaluate_table differ")

  streams = {}
  for dev in ("cuda", "cpu"):
    streams[dev] = stream_explore(
        TorchOracleBackend(chunk_size=SWEEP_CHUNK, device=dev), space, layers,
        "resnet20", n_per_type=25_000, seed=5, reducers=sweep_reducers(),
        chunk_size=SWEEP_CHUNK)
  g, c = streams["cuda"], streams["cpu"]
  for name in ("pareto", "pareto3", "top"):
    if not _frames_equal(g[name], c[name]):
      raise AssertionError(f"fused stream {name} differs between cuda and cpu")
  if not np.array_equal(g["hist"]["counts"], c["hist"]["counts"]):
    raise AssertionError("fused stream histograms differ")
  for k, v in c["stats"].items():
    if not abs(g["stats"][k] - v) <= 1e-12 * abs(v):
      raise AssertionError(f"stats {k}: {g['stats'][k]!r} vs {v!r}")
  log(f"[parity] 100,000-design fused stream: fronts "
      f"({len(g['pareto'])}, {len(g['pareto3'])}) and top-"
      f"{len(g['top'])} identical, histogram equal, stats within 1e-12")

  front = sweep["pareto3"]
  obj = torch.from_numpy(np.stack(
      [front.latency_s, front.energy_mj, front.area_mm2], axis=1)).cuda()
  counts = ops.dominance_counts(obj)
  if int(counts.max()) != 0:
    raise AssertionError("K2 finds a dominated point on the streamed front")
  log(f"[parity] K2: all {len(front)} points of the streamed 3-D front have "
      "dominance count 0")
  return rel


# ---------------------------------------------------------------------------
# the paper's method: polynomial PPA models evaluated on the card
# ---------------------------------------------------------------------------

def _check_frame(tag, frame, n):
  import numpy as np
  if len(frame) != n:
    raise AssertionError(f"{tag}: {len(frame)} rows, expected {n}")
  for c in ("latency_s", "power_mw", "area_mm2"):
    v = frame.column(c)
    if not (np.isfinite(v).all() and (v > 0).all()):
      raise AssertionError(f"{tag}: {c} not finite and positive")


def phase_poly(layers, sweep, smi):
  """The paper's own method on the card: fit (host numpy) or load the
  models, then fig 4, Table 2, speedup_dse and a 1,000,000-design table
  sweep, every prediction's features and sums on the card."""
  import torch
  from repro_torch.core.pe import PAPER_PE_TYPES
  from repro_torch.core.workloads import get_network
  from repro_torch.explore import (DesignSpace, ExplorationSession,
                                   OracleBackend, PolynomialBackend)
  t0 = time.perf_counter()
  backend = PolynomialBackend.fit_or_load(
      str(POLY_CACHE), layers=get_network("resnet20") + get_network("vgg16"),
      **POLY_FIT)
  cache = "hit" if backend.loaded_from else "miss"
  log(f"[poly] fit_ppa_models[all] degree={POLY_FIT['degree']} "
      f"n_train={POLY_FIT['n_train']} over resnet20 + vgg16, "
      f"{len(backend.pe_types)} PE types: {time.perf_counter() - t0:.3f} s "
      f"on the host, cache={cache}")
  sess = ExplorationSession(backend, DesignSpace())

  t0 = time.perf_counter()
  frame = sess.explore(layers, "resnet20", n_per_type=POLY_FIG_PER_TYPE)
  secs = time.perf_counter() - t0
  _check_frame("[poly] fig4", frame, 4 * POLY_FIG_PER_TYPE)
  ppa_n, en_n = frame.normalize(ref="best-int16")
  log(f"[poly] fig4 resnet20, {len(frame)} designs in {secs:.3f} s: "
      f"perf/area spread {ppa_n.max() / ppa_n.min():.1f}x, energy spread "
      f"{en_n.max() / en_n.min():.1f}x (paper: 5x and 35x+)")

  t0 = time.perf_counter()
  rows = []
  for net in ("vgg16", "resnet20", "resnet56"):
    f = sess.explore(get_network(net), net, n_per_type=POLY_FIG_PER_TYPE)
    _check_frame(f"[poly] table2 {net}", f, 4 * POLY_FIG_PER_TYPE)
    p_n, e_n = f.normalize(ref="best-int16")
    rows.append(f"{net}: " + ", ".join(
        f"{t} {p_n[f.by_type(t)].max():.2f}x/{e_n[f.by_type(t)].min():.3f}x"
        for t in PAPER_PE_TYPES))
  log(f"[poly] table2, best normalised perf/area / energy per PE type "
      f"({time.perf_counter() - t0:.3f} s): " + "; ".join(rows)
      + " (paper, vgg16: 5.7x/0.18x LightPE-1, 4.9x/0.20x LightPE-2)")

  cfgs = []
  for i, t in enumerate(PAPER_PE_TYPES):
    cfgs += sess.space.sample_type(t, POLY_SPEEDUP_PER_TYPE, seed=31 + i)
  t0 = time.perf_counter()
  speedup = sess.evaluate(cfgs, layers, "resnet20")
  t_model = (time.perf_counter() - t0) / len(cfgs)
  _check_frame("[poly] speedup_dse", speedup, len(cfgs))
  t0 = time.perf_counter()
  OracleBackend().evaluate(cfgs[:POLY_ORACLE_DESIGNS], layers, "resnet20")
  t_oracle = (time.perf_counter() - t0) / POLY_ORACLE_DESIGNS
  log(f"[poly] speedup_dse resnet20: model {t_model * 1e6:.2f} us/design "
      f"over {len(cfgs)} designs on the card, scalar oracle "
      f"{t_oracle * 1e6:.2f} us/design over {POLY_ORACLE_DESIGNS} on the "
      f"host: model/oracle speedup {t_oracle / t_model:.2f}x")

  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  big = sess.explore(layers, "resnet20", n_per_type=SWEEP_PER_TYPE, seed=17,
                     vectorized=True)
  secs = time.perf_counter() - t0
  _check_frame("[poly] sweep", big, 4 * SWEEP_PER_TYPE)
  peak = torch.cuda.max_memory_allocated() / 2**30
  log(f"[poly] table sweep resnet20, {len(big)} designs (one-shot "
      f"evaluate_table, 32,768-design chunks): {secs:.3f} s with sampling, "
      f"{len(big) / secs:.1f} designs/s ({big.meta['eval_seconds']:.3f} s "
      f"evaluating: {len(big) / big.meta['eval_seconds']:.1f} designs/s); "
      f"[sweep] exact oracle in this run: {sweep.meta['rows_per_sec']:.1f} "
      f"designs/s; peak device memory {peak:.2f} GiB; card: {smi}")
  phase_poly_breakdown(layers, backend, big.table)
  return {"backend": backend, "cfgs": cfgs, "speedup": speedup, "big": big}


def phase_poly_breakdown(layers, backend, table):
  """Where one 32,768-design chunk of the table sweep goes (INT16 rows),
  stage by stage as ``evaluate_table`` runs them; the fixed-order latency
  sum is also captured as one CUDA graph, whose replay is its device time
  without the host's launches."""
  import numpy as np
  import torch
  from repro_torch.core import ppa
  from repro_torch.explore.backend import gbuf_overheads_table
  m = backend.models["INT16"]
  dev = backend.device
  idx = np.flatnonzero(table.pe_type_strings() == "INT16")[:32768]
  lf = np.asarray([l.features() for l in layers], np.float64)
  rows = []
  stage = lambda name, fn: timed_stage(rows, name, fn)
  for _ in range(2):  # the first pass warms caches; report the second
    rows.clear()
    sub = stage("host: select the chunk", lambda: table.select(idx))
    x = stage("latency rows to the card", lambda: torch.cat([
        torch.as_tensor(sub.latency_hw_features(), device=dev)
        .repeat_interleave(len(lf), dim=0),
        torch.as_tensor(lf, device=dev).repeat(len(sub), 1)], dim=1))
    phi = stage("latency features (603 monomials)", lambda: (
        ppa.poly_features_t(x, m.latency.exponents, torch.as_tensor(
            m.latency.col_scale, device=dev))))
    coef = torch.as_tensor(m.latency.coef, device=dev)
    raw = stage("latency fixed-order sum", lambda: ppa.poly_sum(phi, coef))
    stage("latency: raw to host, exp, network sum", lambda: np.maximum(
        m.latency.finish(raw.cpu().numpy()), 1e-12).reshape(
            len(sub), len(lf)).sum(axis=1))
    stage("gbuf overheads (host batch_inputs + card)",
          lambda: gbuf_overheads_table(sub, dev))
    stage("power + area models", lambda: (m.predict_power_mw(sub, dev),
                                          m.predict_area_mm2(sub, dev)))
  total = sum(e for _, _, e in rows)
  for name, host_ms, event_ms in rows:
    log(f"[poly-breakdown] {name}: host {host_ms:.3f} ms, events "
        f"{event_ms:.3f} ms ({event_ms / total:.1%})")
  graph, captured = capture(lambda: ppa.poly_sum(phi, coef))
  graph_ms = replay_ms(graph, samples=10)
  if not torch.equal(captured, raw):
    raise AssertionError("graph replay changed the latency sums")
  eager_ms = next(e for n, _, e in rows if n == "latency fixed-order sum")
  log(f"[poly-breakdown] {len(idx)} designs x {len(lf)} layers = "
      f"{phi.shape[1]:,} latency rows, {phi.shape[0]} monomials: "
      f"{total:.3f} ms for the chunk; the fixed-order sum as one CUDA graph "
      f"replay {graph_ms:.3f} ms (eager {eager_ms:.3f} ms: the card busy "
      f"{graph_ms / eager_ms:.1%} of it)")


def phase_poly_parity(layers, poly):
  """The card's polynomial predictions against the same code on the CPU:
  speedup_dse's designs (list path) and the first rows of the 1M table
  sweep (table path) must be bit-equal, with equal 2-D fronts and the
  same best-INT16 design."""
  import numpy as np
  from repro_torch.explore import PolynomialBackend
  cpu = PolynomialBackend(poly["backend"].models, device="cpu")
  t0 = time.perf_counter()
  table = poly["big"].table.select(slice(0, POLY_PARITY_ROWS))
  pairs = {"speedup_dse list": (poly["speedup"],
                                cpu.evaluate(poly["cfgs"], layers,
                                             "resnet20")),
           f"first {POLY_PARITY_ROWS:,} sweep rows, table": (
               poly["big"].select(np.arange(POLY_PARITY_ROWS)),
               cpu.evaluate_table(table, layers, "resnet20"))}
  for name, (gpu, host) in pairs.items():
    if not _frames_equal(gpu, host):
      raise AssertionError(f"[poly-parity] {name}: card and CPU differ")
    fronts = [np.flatnonzero(f.pareto()) for f in (gpu, host)]
    if not np.array_equal(*fronts):
      raise AssertionError(f"[poly-parity] {name}: 2-D fronts differ")
    has_int16 = bool(gpu.by_type("INT16").any())
    if has_int16 and gpu.reference_index() != host.reference_index():
      raise AssertionError(f"[poly-parity] {name}: best-INT16 differs")
    log(f"[poly-parity] {name} ({len(gpu)} designs, "
        f"{', '.join(sorted(set(gpu.pe_type.tolist())))}): lat/pwr/area "
        f"bit-equal card vs CPU, 2-D front equal ({fronts[0].size} rows)"
        + (f", best-INT16 row {gpu.reference_index()} equal"
           if has_int16 else ""))
  log(f"[poly-parity] {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# co-exploration: every architecture x every HW design, streamed
# ---------------------------------------------------------------------------

def co_arch_accs(n: int):
  """``n`` Table-4 architectures and accuracies, drawn as
  ``benchmarks/framework_perf.py`` draws them (RandomState(0))."""
  import numpy as np
  from repro_torch.core.cnn import SEARCH_SPACE, ArchChoice
  rng = np.random.RandomState(0)
  archs = [ArchChoice(tuple((int(rng.choice(reps)), int(rng.choice(chs)))
                            for reps, chs in SEARCH_SPACE))
           for _ in range(n)]
  return list(zip(archs, (float(a) for a in rng.uniform(0.5, 0.95, n))))


def co_reducers():
  from repro_torch.explore import ParetoAccumulator, TopKAccumulator
  return {"pareto": ParetoAccumulator(CO_JOINT3),
          "top": TopKAccumulator(100, by="energy_mj")}


def co_parity_reducers():
  """[coexplore-parity]'s reducers: the joint front, a latency/energy/area
  front (K1's branch), Fig. 12's 2-D front, top-100, stats, a
  histogram."""
  from repro_torch.explore import (HistogramAccumulator, ParetoAccumulator,
                                   StatsAccumulator, TopKAccumulator)
  return {"pareto": ParetoAccumulator(CO_JOINT3),
          "pareto3": ParetoAccumulator(("latency_s", "energy_mj",
                                        "area_mm2")),
          "fig12": ParetoAccumulator(("top1_err", "energy_mj")),
          "top": TopKAccumulator(100, by="energy_mj"),
          "stats": StatsAccumulator("energy_mj"),
          "hist": HistogramAccumulator("top1_err", 0.0, 0.5, bins=16)}


def phase_coexplore(smi):
  """The co-exploration main path: 1,000 archs x 10,000 HW designs
  through ``ExplorationSession.co_explore(stream=True)`` on the card."""
  import numpy as np
  import torch
  from repro_torch.explore import (DesignSpace, ExplorationSession,
                                   TorchOracleBackend)
  from repro_torch.kernels.pareto_front import kernel, ops
  arch_accs = co_arch_accs(CO_ARCHS)
  session = ExplorationSession(TorchOracleBackend(chunk_size=CO_CHUNK),
                               DesignSpace())
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  kernel.reset_launch_counts()
  res = session.co_explore(arch_accs, n_hw_per_type=CO_HW_PER_TYPE,
                           seed=CO_SEED, image_size=CO_IMAGE, stream=True,
                           reducers=co_reducers(), chunk_size=CO_CHUNK)
  torch.cuda.synchronize()
  launches = dict(kernel.LAUNCHES)
  peak = torch.cuda.max_memory_allocated() / 2**30
  m = res.meta
  front, top = res["pareto"], res["top"]
  log(f"[coexplore] {res.n_rows} pairs ({CO_ARCHS} archs x "
      f"{4 * CO_HW_PER_TYPE} HW) in {int(m['n_chunks'])} blocks, "
      f"{m['seconds']:.3f} s: {m['rows_per_sec']:.1f} pairs/s; rows "
      f"transferred {int(m['rows_transferred'])}, fraction "
      f"{m['rows_transferred'] / res.n_rows:.6f}; n_overflows "
      f"{int(m['n_overflows'])}; peak device memory {peak:.3f} GiB; "
      f"card: {smi}")
  front_archs = sorted(set(front.extra["arch_id"].tolist()))
  log(f"[coexplore] joint front (top1_err, energy_mj, area_mm2) "
      f"{len(front)} points, archs {front_archs}; "
      f"top-{len(top)} energy {top.energy_mj[0]:.6g}.."
      f"{top.energy_mj[-1]:.6g} mJ")
  log(f"[coexplore] kernel launches during the sweep: {launches}")
  if CO_RECORD.is_file():
    ref = json.loads(CO_RECORD.read_text())
    log(f"[coexplore] results/BENCH_streaming.json (the reference's jax "
        f"device path on a CPU, commit {ref['provenance']['git_commit']}): "
        f"{ref['n_pairs']} pairs, rows transferred "
        f"{ref['device_transfer_rows']}, front {ref['pareto_front_size']} "
        f"points, top-{ref['top_k']}; this run: {res.n_rows}, "
        f"{int(m['rows_transferred'])}, {len(front)}, {len(top)}")
  if res.n_rows != CO_ARCHS * 4 * CO_HW_PER_TYPE:
    raise AssertionError(f"co-explored {res.n_rows} pairs")
  if len(top) != 100 or not len(front):
    raise AssertionError("empty front or short top-k")
  for name, f in (("front", front), ("top", top)):
    for c in ("latency_s", "power_mw", "area_mm2", "top1"):
      v = f.column(c)
      if not (np.isfinite(v).all() and (v > 0).all()):
        raise AssertionError(f"{name}: {c} not finite and positive")
  obj = torch.from_numpy(np.stack([front.column(c) for c in CO_JOINT3],
                                  axis=1)).cuda()
  if int(ops.dominance_counts(obj).max()) != 0:
    raise AssertionError("K2 finds a dominated point on the joint front")
  log(f"[coexplore] K2: all {len(front)} points of the joint front have "
      "dominance count 0")
  return arch_accs


def phase_coexplore_breakdown(arch_accs):
  """Where one 262,144-pair block goes (the first: 104 archs x 2,500
  FP32 HW rows), each stage between two syncs, host and event ms; the
  joint oracle is also captured as one CUDA graph."""
  import numpy as np
  import torch
  from repro_torch.core import oracle
  from repro_torch.core.dataflow import LayerStack
  from repro_torch.core.supernet import arch_to_layers
  from repro_torch.explore import DesignSpace, TorchOracleBackend
  from repro_torch.explore import device as device_lib
  from repro_torch.explore.streaming import fold_chunk, new_counters
  backend = TorchOracleBackend(chunk_size=CO_CHUNK)
  space = DesignSpace()
  hw = space.sample_type_table(space.pe_types[0], CO_HW_PER_TYPE,
                               seed=CO_SEED)
  a_sl, h_sl = next(hw.cross(len(arch_accs)).block_slices(CO_CHUNK))
  stack = LayerStack.from_layer_lists(
      [arch_to_layers(a, image_size=CO_IMAGE) for a, _ in arch_accs])
  unique_cols, slot_ids = stack.dedup_slots()
  block = stack.slice_archs(a_sl.start, a_sl.stop)
  sub = hw.select(h_sl)
  accs = np.asarray([acc for _, acc in arch_accs[a_sl]], np.float64)
  plan = device_lib.build_plan(co_reducers(), joint=True)
  idx = np.arange(block.n_archs * len(sub))
  rows = []
  stage = lambda name, fn: timed_stage(rows, name, fn)

  for _ in range(2):  # the first pass warms caches; report the second
    rows.clear()
    inputs = stage("host batch_inputs (HW rows)",
                   lambda: oracle.batch_inputs(sub))
    placed, (uc, sid), valid, accs_t = stage(
        "placement (inputs, distinct layers, slots, accuracies)",
        lambda: (backend._place(inputs),
                 backend.place_dedup((unique_cols, slot_ids[a_sl])),
                 device_lib.h2d(block.valid, backend.device),
                 device_lib.h2d(accs, backend.device)))
    ch = stage("joint oracle (distinct layers, eager)",
               lambda: oracle.characterize_joint_dedup(placed, uc, sid,
                                                       valid))
    lat = ch.latency_s
    cols = stage("derive columns", lambda: device_lib._derive_columns(
        lat, ch.power_mw[None, :].expand(lat.shape),
        ch.area_mm2[None, :].expand(lat.shape), accs=accs_t))
    for name, spec in plan:
      one = device_lib.DevicePlan(specs=((name, spec),), cap=plan.cap)
      stage(f"fused reduction {name}", lambda: device_lib._reduce_outputs(
          cols, one, grouped=True))
    pend = stage("fused block (dispatch)",
                 lambda: backend.fused_co_eval_pending(
                     sub, block, "coexplore", plan, idx, a_sl.start, accs,
                     tuple(a for a, _ in arch_accs),
                     dedup=(uc, sid)))
    fused = stage("fused block (resolve)", pend.resolve)
    stage("host fold into the reducers", lambda: fold_chunk(
        co_reducers(), new_counters(), fused))
  for name, host_ms, event_ms in rows:
    log(f"[coexplore-breakdown] {name}: host {host_ms:.3f} ms, events "
        f"{event_ms:.3f} ms")
  graph, captured = capture(lambda: oracle.characterize_joint_dedup(
      placed, uc, sid, valid))
  graph_ms = replay_ms(graph, samples=10)
  for f in ("latency_s", "energy_mj", "utilization", "power_mw",
            "area_mm2"):
    if not torch.equal(getattr(captured, f), getattr(ch, f)):
      raise AssertionError(f"graph replay changed {f}")
  eager_ms = next(e for name, _, e in rows if name.startswith("joint oracle"))
  log(f"[coexplore-breakdown] {block.n_archs} archs x {len(sub)} HW = "
      f"{block.n_archs * len(sub):,} pairs; the sweep's "
      f"{int(stack.valid.sum()):,} layer slots hold {len(unique_cols['A'])} "
      f"distinct layers: the joint oracle "
      f"as one CUDA graph replay {graph_ms:.3f} ms on the card (eager: "
      f"{eager_ms:.3f} ms between events, so the card is busy "
      f"{graph_ms / eager_ms:.1%} of that stage); fused survivors "
      f"{fused.n_transferred} rows")


def phase_coexplore_parity():
  """100 archs x 2,000 HW designs through the fused joint stream on the
  card and on the CPU: the joint oracle bit for bit, identical fronts
  (the K1 branch among them) and top-k, K1 once per block."""
  import numpy as np
  import torch
  from repro_torch.core import oracle
  from repro_torch.core.dataflow import LayerStack
  from repro_torch.core.supernet import arch_to_layers
  from repro_torch.explore import DesignSpace, TorchOracleBackend
  from repro_torch.explore import device as device_lib
  from repro_torch.explore.streaming import stream_co_explore
  from repro_torch.kernels.pareto_front import kernel
  n_archs, n_hw, chunk = CO_PARITY
  arch_accs = co_arch_accs(n_archs)
  space = DesignSpace()
  t0 = time.perf_counter()

  hw = space.sample_type_table(space.pe_types[0], n_hw, seed=CO_SEED)
  stack = LayerStack.from_layer_lists(
      [arch_to_layers(a, image_size=CO_IMAGE) for a, _ in arch_accs])
  joint = {}
  for dev in ("cuda", "cpu"):
    backend = TorchOracleBackend(device=dev)
    uc, sid = backend.place_dedup(stack.dedup_slots())
    joint[dev] = oracle.characterize_joint_dedup(
        backend._place(oracle.batch_inputs(hw)), uc, sid,
        device_lib.h2d(stack.valid, backend.device))
  fields = ("clock_mhz", "area_mm2", "power_mw", "latency_s", "energy_mj",
            "utilization")
  rel = max(float((getattr(joint["cuda"], f).cpu()
                   / getattr(joint["cpu"], f) - 1.0).abs().max())
            for f in fields)
  log(f"[coexplore-parity] joint oracle, {n_archs} archs x {n_hw} "
      f"{space.pe_types[0]} HW, card vs CPU: parity_max_rel_err = {rel!r} "
      f"over {', '.join(fields)}")
  if rel != 0.0:
    raise AssertionError("the joint oracle differs between cuda and cpu")

  streams = {}
  for dev in ("cuda", "cpu"):
    kernel.reset_launch_counts()
    streams[dev] = stream_co_explore(
        TorchOracleBackend(device=dev), space, arch_accs,
        n_hw_per_type=n_hw, seed=CO_SEED, image_size=CO_IMAGE,
        reducers=co_parity_reducers(), chunk_size=chunk)
    if dev == "cuda":
      torch.cuda.synchronize()
      k1 = kernel.LAUNCHES["block_dominance_counts"]
  g, c = streams["cuda"], streams["cpu"]
  for name in ("pareto", "pareto3", "fig12", "top"):
    same = len(g[name]) == len(c[name]) and all(
        np.array_equal(g[name].column(col), c[name].column(col))
        for col in ("latency_s", "power_mw", "area_mm2", "arch_id",
                    "top1"))
    if not same:
      raise AssertionError(f"joint stream {name} differs card vs CPU")
  if not np.array_equal(g["hist"]["counts"], c["hist"]["counts"]):
    raise AssertionError("joint stream histograms differ")
  for k, v in c["stats"].items():
    if not abs(g["stats"][k] - v) <= 1e-12 * abs(v):
      raise AssertionError(f"stats {k}: {g['stats'][k]!r} vs {v!r}")
  n_chunks = int(g.meta["n_chunks"])
  log(f"[coexplore-parity] fused joint stream, {g.n_rows} pairs in "
      f"{n_chunks} blocks: fronts joint {len(g['pareto'])}, "
      f"latency/energy/area {len(g['pareto3'])}, fig12 {len(g['fig12'])} "
      f"and top-{len(g['top'])} identical card vs CPU (arch_id, top1 "
      f"too), histogram equal, stats within 1e-12; K1 launches {k1} for "
      f"{n_chunks} blocks; n_overflows {int(g.meta['n_overflows'])}; "
      f"{time.perf_counter() - t0:.2f} s")
  if k1 != n_chunks:
    raise AssertionError(f"K1 launched {k1} times for {n_chunks} blocks")
  return {"k1_launches": k1, "n_chunks": n_chunks}


def phase_coexplore_poly(backend, smi):
  """The paper's method on the joint path: the fitted models of [poly]
  over 100 archs x 1,000 HW designs through
  ``PolynomialBackend.co_evaluate_table`` on the card; a sub-block on the
  CPU too, bit for bit; Fig. 12's normalisation and fronts."""
  import numpy as np
  from repro_torch.core import coexplore
  from repro_torch.explore import (DesignSpace, ExplorationSession,
                                   PolynomialBackend)
  n_archs, n_hw = CO_POLY
  arch_accs = co_arch_accs(n_archs)
  session = ExplorationSession(backend, DesignSpace())
  t0 = time.perf_counter()
  frame = session.co_explore(arch_accs, n_hw_per_type=n_hw, seed=CO_SEED,
                             image_size=CO_IMAGE, vectorized=True)
  secs = time.perf_counter() - t0
  _check_frame("[coexplore-poly]", frame, n_archs * 4 * n_hw)
  log(f"[coexplore-poly] {len(frame)} pairs ({n_archs} archs x {4 * n_hw} "
      f"HW) through PolynomialBackend.co_evaluate_table on the card: "
      f"{secs:.3f} s, {secs / len(frame) * 1e6:.2f} us/pair "
      f"({n_archs} fixed-order latency sums a PE type); card: {smi}")

  # the first PE type's HW (sampled with seed + 17 * 0, as in the sweep)
  # against the first archs, on the CPU: the card frame's first rows
  first_type = session.space.pe_types[0]
  cpu = ExplorationSession(PolynomialBackend(backend.models, device="cpu"),
                           DesignSpace(pe_types=(first_type,)))
  want = cpu.co_explore(arch_accs[:CO_POLY_PARITY_ARCHS], n_hw_per_type=n_hw,
                        seed=CO_SEED, image_size=CO_IMAGE, vectorized=True)
  got = frame.select(np.arange(len(want)))
  if not (_frames_equal(got, want) and np.array_equal(
      got.extra["arch_id"], want.extra["arch_id"])):
    raise AssertionError("[coexplore-poly] card and CPU differ")
  log(f"[coexplore-poly] {len(want)} pairs ({CO_POLY_PARITY_ARCHS} archs x "
      f"{n_hw} {first_type} HW): lat/pwr/area bit-equal card vs CPU")

  points = [coexplore.CoPoint(frame.config_at(i), frame.arch_at(i),
                              float(frame.extra["top1"][i]),
                              float(frame.latency_s[i]),
                              float(frame.power_mw[i]),
                              float(frame.area_mm2[i]))
            for i in range(len(frame))]
  fig = coexplore.normalize_and_front(points)
  log(f"[coexplore-poly] Fig. 12 (normalised to the min-energy and "
      f"min-area INT16 pairs): (top1_err, energy) front "
      f"{int(fig['front_energy'].sum())} points, (top1_err, area) front "
      f"{int(fig['front_area'].sum())} points, energy "
      f"{fig['energy'].min():.3f}x..{fig['energy'].max():.3f}x, area "
      f"{fig['area'].min():.3f}x..{fig['area'].max():.3f}x")


# ---------------------------------------------------------------------------
# guided search and its fault tolerance
# ---------------------------------------------------------------------------

def _kernel_modules():
  """Every hand kernel's launch-count module."""
  from repro_torch.kernels.flash_attention import kernel as fa_kernel
  from repro_torch.kernels.int8_matmul import kernel as i8_kernel
  from repro_torch.kernels.pareto_front import kernel as pf_kernel
  from repro_torch.kernels.pow2_matmul import kernel as p2_kernel
  from repro_torch.kernels.quant_decode_attn import kernel as qda_kernel
  from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
  return (pf_kernel, fa_kernel, qda_kernel, wkv_kernel, i8_kernel, p2_kernel)


def _reset_kernel_counts() -> None:
  for mod in _kernel_modules():
    mod.reset_launch_counts()


def _kernel_counts():
  import torch
  torch.cuda.synchronize()
  return {name: n for mod in _kernel_modules()
          for name, n in mod.LAUNCHES.items()}


def _counted(obj, method: str):
  """Count the calls of ``obj.method`` (wrapped as an instance
  attribute); returns the counter."""
  calls = {"n": 0}
  inner = getattr(obj, method)

  def call(*args, **kwargs):
    calls["n"] += 1
    return inner(*args, **kwargs)

  setattr(obj, method, call)
  return calls


def _no_wait_policy(**kw):
  from repro_torch.explore import ResiliencePolicy, RetryPolicy
  return ResiliencePolicy(retry=RetryPolicy(sleep=lambda s: None), **kw)


def _same_front(a, b, cols) -> bool:
  import numpy as np
  return len(a) == len(b) and all(
      np.array_equal(a.column(c), b.column(c)) for c in cols)


def _check_fault_free(tag, res) -> None:
  if res.meta["n_retries"] or res.meta["n_demotions"]:
    raise AssertionError(f"{tag}: {res.meta['n_retries']} retries, "
                         f"{res.meta['n_demotions']} demotions without a "
                         "fault")


def _search_kwargs():
  return dict(arch_accs=co_arch_accs(SEARCH["n_archs"]),
              objectives=SEARCH_OBJ, population=SEARCH["population"],
              seed=SEARCH["seed"])


def phase_search(smi):
  """The README's guided search: ``benchmarks/search_perf.py`` at full
  scale through ``ExplorationSession(TorchOracleBackend()).optimize`` on
  the card, nothing cut: the guided, surrogate and random arms and a
  same-seed rerun, held bit for bit to the reference's record."""
  import numpy as np
  import torch
  from repro_torch.explore import (DesignSpace, ExplorationSession,
                                   TorchOracleBackend)
  from repro_torch.explore.search import hypervolume, objective_matrix
  backend = TorchOracleBackend()
  calls = _counted(backend, "evaluate_table")
  session = ExplorationSession(backend, DesignSpace())
  kw = _search_kwargs()
  arms = {}

  def run(name, **extra):
    calls["n"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = session.optimize(**{**kw, **extra})
    torch.cuda.synchronize()
    arms[name] = (res, time.perf_counter() - t0, calls["n"])
    _check_fault_free(f"[search] {name}", res)
    return res

  _reset_kernel_counts()
  guided = run("guided", generations=SEARCH["generations"])
  budget = int(guided.meta["evaluations"])
  run("surrogate", generations=SEARCH["generations"], surrogate=True)
  run("random", population=budget, generations=1, seed=SEARCH["seed"] + 1)
  launches = _kernel_counts()
  run("rerun", generations=SEARCH["generations"])
  mats = {name: objective_matrix(arms[name][0]["pareto"], SEARCH_OBJ)
          for name in ("guided", "surrogate", "random")}
  union = np.concatenate(list(mats.values()), axis=0)
  lo, hi = union.min(axis=0), union.max(axis=0)
  ref = hi + 0.1 * np.maximum(hi - lo, 1e-12)
  hv = {name: hypervolume(m, ref) for name, m in mats.items()}
  ratio = hv["guided"] / max(hv["random"], 1e-300)
  sur_ratio = hv["surrogate"] / max(hv["random"], 1e-300)
  rerun = arms["rerun"][0]
  same = (_same_front(guided["pareto"], rerun["pareto"], SEARCH_COLS)
          and guided.meta["hypervolume"] == rerun.meta["hypervolume"])
  for name, (res, secs, n_calls) in arms.items():
    m = res.meta
    log(f"[search] {name}: {int(m['evaluations'])} evaluations in "
        f"{int(m['generations'])} generations, {secs:.3f} s "
        f"({m['evaluations'] / secs:.1f} evaluations/s, "
        f"{secs / m['generations'] * 1e3:.1f} ms a generation), "
        f"{n_calls} evaluate_table calls on the card, front "
        f"{len(res['pareto'])} points")
  log(f"[search] hv_guided {hv['guided']!r}, hv_surrogate "
      f"{hv['surrogate']!r}, hv_random {hv['random']!r}; ratios "
      f"{ratio:.3f} (guided) and {sur_ratio:.3f} (surrogate) vs random; "
      f"same-seed rerun identical: {same}; kernel launches in the three "
      f"arms: {launches}; card: {smi}")
  rec = json.loads(SEARCH_RECORD.read_text())
  got = {"evaluations": budget,
         "front_size_guided": len(guided["pareto"]),
         "front_size_surrogate": len(arms["surrogate"][0]["pareto"]),
         "front_size_random": len(arms["random"][0]["pareto"]),
         "hv_guided": hv["guided"], "hv_surrogate": hv["surrogate"],
         "hv_random": hv["random"]}
  want = {k: rec[k] for k in got}
  log(f"[search] results/BENCH_search.json (the reference on a CPU, "
      f"commit {rec['provenance']['git_commit']}, guided "
      f"{rec['guided_seconds']} s, surrogate {rec['surrogate_seconds']} s, "
      f"random {rec['random_seconds']} s): {want}; this run: {got}")
  if got != want:
    raise AssertionError("[search] differs from the reference's record")
  if ratio < 2.0:
    raise AssertionError(f"[search] guided/random hypervolume {ratio:.3f} "
                         "below the reference's 2x bar")
  if not same:
    raise AssertionError("[search] same-seed reruns differ")
  return guided


def phase_search_hw(layers):
  """HW-only guided search of resnet20 on the card, then the same search
  on the CPU: identical fronts, bit-equal hypervolume, one
  ``eval_pending`` dispatch a generation."""
  import torch
  from repro_torch.explore import (DesignSpace, ExplorationSession,
                                   TorchOracleBackend)
  gpu = TorchOracleBackend()
  dispatches = _counted(gpu, "eval_pending")
  res, secs = {}, {}
  for dev, backend in (("cuda", gpu),
                       ("cpu", TorchOracleBackend(device="cpu"))):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res[dev] = ExplorationSession(backend, DesignSpace()).optimize(
        layers, "resnet20", **SEARCH_HW)
    torch.cuda.synchronize()
    secs[dev] = time.perf_counter() - t0
    _check_fault_free(f"[search-hw] {dev}", res[dev])
  g, c = res["cuda"], res["cpu"]
  same = (_same_front(g["pareto"], c["pareto"], BASE_COLS)
          and g.meta["hypervolume"] == c.meta["hypervolume"]
          and g.meta["evaluations"] == c.meta["evaluations"])
  log(f"[search-hw] resnet20, population {SEARCH_HW['population']}, "
      f"{int(g.meta['generations'])} generations, seed {SEARCH_HW['seed']}: "
      f"{int(g.meta['evaluations'])} evaluations, front "
      f"{len(g['pareto'])} points, hypervolume {g.meta['hypervolume']!r}; "
      f"card {secs['cuda']:.3f} s ({dispatches['n']} eval_pending "
      f"dispatches), CPU {secs['cpu']:.3f} s; identical: {same}")
  if not same:
    raise AssertionError("[search-hw] card and CPU searches differ")
  if dispatches["n"] != int(g.meta["generations"]):
    raise AssertionError(f"[search-hw] {dispatches['n']} dispatches for "
                         f"{int(g.meta['generations'])} generations")


def _journal_state(jdir):
  """The one guided-search checkpoint under ``jdir``."""
  import pickle
  (path,) = Path(jdir).glob("sweep-*.pkl")
  with open(path, "rb") as f:
    return pickle.load(f)["state"]


def _generation_stages(space, evaluate, features, state, n_archs):
  """One surrogate-screened generation after a journaled run's last,
  stage by stage between syncs: (name, host ms, event ms) rows, and the
  generation's evaluate call (for profiling)."""
  import numpy as np
  from repro_torch.core.seeding import derive_seed
  from repro_torch.explore import ParetoAccumulator
  from repro_torch.explore import search as S
  population = SEARCH["population"]
  rows = []
  stage = lambda name, fn: timed_stage(rows, name, fn)
  card = S._cardinalities(space, n_archs)
  g = state["g_next"]
  rng = np.random.RandomState(derive_seed("search-gen", SEARCH["seed"], g))
  pop_genome, pop_obj = state["pop_genome"], state["pop_obj"]
  xs, ys = list(state["xs"]), list(state["ys"])

  def parents():
    rank = S.nondominated_ranks(pop_obj)
    return rank, S.crowding_distance(pop_obj, rank)

  def variation():
    cand = S._vary(pop_genome, rank, crowd, rng, card, population * 4, 0.9,
                   1.0 / card.shape[0])
    return S._repair(space, cand, rng, set(state["seen"]), card)

  def screen():
    models = S._fit_surrogates(np.concatenate(xs), np.concatenate(ys))
    table = S._decode_table(space, cand)
    arch = cand[:, -1] if n_archs is not None else None
    x = features(table, arch)
    pred = np.stack([m.predict(x) for m in models], axis=1)
    front, ref = S._screen_front(np.concatenate(ys))
    return cand[S._hv_gain_screen(pred, front, ref, population)]

  rank, crowd = stage("ranks + crowding of the parents", parents)
  cand = stage("variation + repair (4 x population)", variation)
  chosen = stage("surrogate fit + screen", screen)
  table = S._decode_table(space, chosen)
  arch = chosen[:, -1].copy() if n_archs is not None else None
  idx = np.arange(state["offset"], state["offset"] + len(chosen))

  def run_eval():
    out = evaluate(table, idx, arch)
    return out.resolve() if hasattr(out, "resolve") else out

  frame, idx = stage("evaluate", run_eval)
  acc = ParetoAccumulator(state["reducers"]["pareto"]["state"]["cols"])
  acc.restore(state["reducers"]["pareto"])
  stage("fold into the front", lambda: acc.fold(frame, idx))
  obj = S.objective_matrix(frame, acc.cols)

  def select():
    allo = np.concatenate([pop_obj, obj])
    r = S.nondominated_ranks(allo)
    c = S.crowding_distance(allo, r)
    return np.lexsort((np.arange(allo.shape[0]), -c, r))[:population]

  stage("ranks + crowding + survivor selection", select)
  return rows, run_eval


def phase_search_breakdown(layers):
  """Where one generation's time goes, joint and HW-only: a surrogate
  search journaled for a few generations, then the next generation's
  stages between syncs, host and event ms (the first pass warms
  caches; the second is reported)."""
  import shutil
  import tempfile
  import numpy as np
  from repro_torch.core.supernet import arch_to_layers
  from repro_torch.explore import (DesignSpace, ExplorationSession,
                                   TorchOracleBackend)
  from repro_torch.explore import search as S
  from repro_torch.explore.session import (hw_evaluator, joint_evaluator,
                                           joint_features)
  backend = TorchOracleBackend()
  calls = _counted(backend, "evaluate_table")
  dispatches = _counted(backend, "eval_pending")
  session = ExplorationSession(backend, DesignSpace())
  kw = _search_kwargs()
  archs = [a for a, _ in kw["arch_accs"]]
  accs = np.asarray([acc for _, acc in kw["arch_accs"]], np.float64)
  arch_layers = [arch_to_layers(a, image_size=32) for a in archs]
  cases = (
      ("joint", dict(kw), joint_evaluator(backend, archs, accs, arch_layers,
                                          "search"),
       joint_features(accs), len(archs)),
      ("hw-only", dict(layers=layers, network="resnet20",
                       population=SEARCH_HW["population"],
                       seed=SEARCH["seed"]),
       hw_evaluator(backend, layers, "resnet20"), S.default_features, None))
  root = ROOT / "build"
  root.mkdir(exist_ok=True)
  for tag, opt_kw, evaluate, features, n_archs in cases:
    jdir = tempfile.mkdtemp(prefix="search-breakdown-", dir=root)
    try:
      session.optimize(generations=SEARCH_BREAKDOWN_GENS, surrogate=True,
                       resume_from=jdir, **opt_kw)
      state = _journal_state(jdir)
    finally:
      shutil.rmtree(jdir)
    for _ in range(2):
      calls["n"] = dispatches["n"] = 0
      rows, run_eval = _generation_stages(session.space, evaluate, features,
                                          state, n_archs)
    total_host = sum(h for _, h, _ in rows)
    for name, host_ms, event_ms in rows:
      if name == "evaluate":
        eval_ms = event_ms
        name += (f" ({calls['n']} evaluate_table calls)" if n_archs
                 else f" ({dispatches['n']} eval_pending dispatch)")
      log(f"[search-breakdown] {tag} generation {state['g_next']}: {name}: "
          f"host {host_ms:.3f} ms, events {event_ms:.3f} ms")
    device_ms = _device_profile("search-breakdown", f"{tag} evaluate",
                                run_eval)
    busy = ("not measured" if device_ms is None
            else f"{device_ms / eval_ms:.1%} of its evaluate stage, "
            f"{device_ms / total_host:.1%} of the generation")
    log(f"[search-breakdown] {tag}: {total_host:.3f} ms a screened "
        f"generation on the host clock; the card is busy {busy}")


def _stream_results_equal(a, b, names) -> bool:
  import numpy as np
  return (all(_same_front(a[n], b[n], BASE_COLS) for n in names)
          and np.array_equal(a["hist"]["counts"], b["hist"]["counts"]))


def _stats_close(a, b) -> bool:
  return all(abs(a[k] - v) <= 1e-12 * abs(v) for k, v in b.items())


def phase_resilience(layers, guided):
  """The fault tolerance on the card: (a) the guided search killed at a
  generation and resumed from its journal; (b) [parity]'s fused stream
  under a seeded plan of device faults; (c) a co-exploration killed at a
  block and resumed on the card, and a smaller one resumed on the CPU;
  (d) an injected hang on a CUDA pending handle under the watchdog."""
  import shutil
  import tempfile
  import numpy as np
  import torch
  from repro_torch.explore import (ChunkError, DesignSpace,
                                   ExplorationSession, Fault, FaultPlan,
                                   TorchOracleBackend)
  from repro_torch.explore.device import build_plan
  from repro_torch.explore.streaming import (DISPATCH_AHEAD, explore_tasks,
                                             stream_co_explore,
                                             stream_explore)
  from repro_torch.kernels.pareto_front import kernel
  space = DesignSpace()
  root = ROOT / "build"
  root.mkdir(exist_ok=True)
  jroot = Path(tempfile.mkdtemp(prefix="resilience-", dir=root))
  try:
    # (a) the guided search, killed at a generation, resumed
    session = ExplorationSession(TorchOracleBackend(), space)
    kw = dict(_search_kwargs(), generations=SEARCH["generations"])
    kill = _no_wait_policy(fault_plan=FaultPlan(
        [Fault("kill", SEARCH_KILL_GEN, "task")]))
    try:
      session.optimize(policy=kill, resume_from=jroot / "a", **kw)
    except ChunkError as e:
      if e.chunk_index != SEARCH_KILL_GEN:
        raise
    else:
      raise AssertionError("[resilience] the injected kill did not fire")
    t0 = time.perf_counter()
    res = session.optimize(resume_from=jroot / "a", **kw)
    secs = time.perf_counter() - t0
    _check_fault_free("[resilience] (a) resumed", res)
    same = (_same_front(res["pareto"], guided["pareto"], SEARCH_COLS)
            and res.meta["hypervolume"] == guided.meta["hypervolume"]
            and res.meta["evaluations"] == guided.meta["evaluations"])
    log(f"[resilience] (a) guided search killed at generation "
        f"{SEARCH_KILL_GEN} (ChunkError), resumed in {secs:.3f} s: "
        f"n_resumed_chunks {int(res.meta['n_resumed_chunks'])}, "
        f"{int(res.meta['evaluations'])} evaluations, front "
        f"{len(res['pareto'])} points, identical to [search]'s guided arm: "
        f"{same}")
    if not same or res.meta["n_resumed_chunks"] != SEARCH_KILL_GEN:
      raise AssertionError("[resilience] (a) the resumed search differs")

    # (b) device faults on the fused stream: demotions to the card's
    # unfused rung, results unchanged
    backend = TorchOracleBackend(chunk_size=RES_CHUNK)

    def sweep(policy):
      kernel.reset_launch_counts()
      out = stream_explore(backend, space, layers, "resnet20",
                           n_per_type=25_000, seed=5,
                           reducers=sweep_reducers(), chunk_size=RES_CHUNK,
                           policy=policy)
      torch.cuda.synchronize()
      return out, kernel.LAUNCHES["block_dominance_counts"]

    clean, k1_clean = sweep(_no_wait_policy())
    _check_fault_free("[resilience] (b) fault-free", clean)
    n_chunks = int(clean.meta["n_chunks"])
    plan = FaultPlan.seeded(RES_FAULT_SEED, n_chunks, p_raise=0.5,
                            layer="device", times=3)
    pol = _no_wait_policy(fault_plan=plan)
    faulty, k1 = sweep(pol)
    rungs = [r.name for r in next(explore_tasks(
        backend, space, layers, "resnet20", 25_000, 5, "random", RES_CHUNK,
        sweep_reducers())).rungs]
    same = (_stream_results_equal(faulty, clean, ("pareto", "pareto3", "top"))
            and _stats_close(faulty["stats"], clean["stats"]))
    log(f"[resilience] (b) 100,000-design fused stream, {n_chunks} chunks, "
        f"ladder {rungs}: seeded plan of {len(plan.faults)} device faults "
        f"(3 failures each) at chunks {[f.chunk for f in plan.faults]}: "
        f"n_retries {int(faulty.meta['n_retries'])}, n_demotions "
        f"{int(faulty.meta['n_demotions'])} {pol.demotions}; K1 launches "
        f"{k1} (fault-free {k1_clean}); fronts, top-k and histogram "
        f"identical to the fault-free run, stats within 1e-12: {same}")
    if not same or not pol.demotions:
      raise AssertionError("[resilience] (b) faults changed the results")
    if any(name != "fused-device" for _, name, _ in pol.demotions) or \
        rungs != ["fused-device", "device"]:
      raise AssertionError("[resilience] (b) a demotion left the card")
    if k1 != n_chunks - len(pol.demotions):
      raise AssertionError(f"[resilience] (b) K1 launched {k1} times")

    # (c) a co-exploration killed at a block, resumed on the card; a
    # smaller one killed on the card, resumed on the CPU
    def co(dev, size, policy=None, jdir=None):
      n_archs, n_hw, chunk = size
      return stream_co_explore(
          TorchOracleBackend(device=dev), space, co_arch_accs(n_archs),
          n_hw_per_type=n_hw, seed=CO_SEED, image_size=CO_IMAGE,
          reducers=co_parity_reducers(), chunk_size=chunk, policy=policy,
          resume_from=jdir)

    names = ("pareto", "pareto3", "fig12", "top")
    for tag, size, resume_dev in (("card", CO_PARITY, "cuda"),
                                  ("CPU", RES_CO_SMALL, "cpu")):
      want = co(resume_dev, size, policy=_no_wait_policy())
      _check_fault_free(f"[resilience] (c) {tag}", want)
      jdir = jroot / f"c-{tag}"
      try:
        co("cuda", size, jdir=jdir, policy=_no_wait_policy(
            fault_plan=FaultPlan([Fault("kill", RES_CO_KILL, "task")])))
      except ChunkError as e:
        if e.chunk_index != RES_CO_KILL:
          raise
      else:
        raise AssertionError("[resilience] (c) the injected kill did not "
                             "fire")
      got = co(resume_dev, size, jdir=jdir)
      same = (_stream_results_equal(got, want, names)
              and _stats_close(got["stats"], want["stats"]))
      log(f"[resilience] (c) co-exploration {size[0]} archs x {size[1]} HW "
          f"a type, {int(want.meta['n_chunks'])} blocks of {size[2]}, killed "
          f"on the card at block {RES_CO_KILL}, resumed on the {tag}: "
          f"n_resumed_chunks {int(got.meta['n_resumed_chunks'])} (the "
          f"{DISPATCH_AHEAD} blocks in flight run again); fronts, top-k and "
          f"histogram identical to an uninterrupted {tag} run, stats within "
          f"1e-12: {same}")
      if not same or got.meta["n_resumed_chunks"] != \
          RES_CO_KILL - DISPATCH_AHEAD:
        raise AssertionError(f"[resilience] (c) the {tag} resume differs")

    # (d) an injected hang at a CUDA handle's resolution under the
    # watchdog, and the helper thread on the handle's device and stream
    backend = TorchOracleBackend(chunk_size=RES_HANG["chunk"])

    def small(policy):
      return stream_explore(backend, space, layers, "resnet20",
                            n_per_type=RES_HANG["n_per_type"],
                            seed=RES_HANG["seed"], reducers=sweep_reducers(),
                            chunk_size=RES_HANG["chunk"], policy=policy)

    calm = _no_wait_policy(resolve_timeout=30.0)
    want = small(calm)
    _check_fault_free("[resilience] (d) fault-free", want)
    pol = _no_wait_policy(resolve_timeout=30.0, fault_plan=FaultPlan(
        [Fault("hang", 1, "device")]))
    got = small(pol)
    same = _stream_results_equal(got, want, ("pareto", "pareto3", "top"))
    chunk = next(space.iter_tables(RES_HANG["n_per_type"],
                                   seed=RES_HANG["seed"],
                                   chunk_size=RES_HANG["chunk"]))
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
      pend = backend.fused_eval_pending(
          chunk, tuple(layers), "resnet20",
          build_plan(sweep_reducers(), joint=False), np.arange(len(chunk)))

    class Probe:
      device, stream = pend.device, pend.stream

      def resolve(self):
        self.seen = (torch.cuda.current_device(),
                     torch.cuda.current_stream())
        return pend.resolve()

    probe = Probe()
    calm._timed_resolve(probe)
    on_handle = (probe.seen[0] == pend.device.index
                 and probe.seen[1] == side)
    log(f"[resilience] (d) injected hang at chunk 1's resolution under a "
        f"30 s watchdog: demotions {pol.demotions}, results identical: "
        f"{same}; n_leaked_watchdogs {int(got.meta['n_leaked_watchdogs'])} "
        f"(fault-free {int(want.meta['n_leaked_watchdogs'])}); a helper "
        f"thread resolves on the handle's device and stream: {on_handle}")
    if (not same or pol.demotions != [(1, "fused-device", "resolve")]
        or got.meta["n_leaked_watchdogs"] or not on_handle):
      raise AssertionError("[resilience] (d) the watchdog path failed")
  finally:
    shutil.rmtree(jroot, ignore_errors=True)


# ---------------------------------------------------------------------------
# the result store, the exploration service, the fleet, the worker pool
# ---------------------------------------------------------------------------

class _K1Recorder:
  """While active, keeps the inputs and outputs of the first ``keep`` K1
  launches a path makes, so they can be held against the plain version
  after the path's launch counts are read (the holds launch nothing)."""

  def __init__(self, keep: int = 4):
    self.keep = keep
    self.records = []

  def __enter__(self):
    from repro_torch.kernels.pareto_front import kernel
    self._inner = kernel.block_dominance_counts

    def launch(obj_t, block):
      out = self._inner(obj_t, block)
      if len(self.records) < self.keep:
        self.records.append((obj_t.clone(), block, out.clone()))
      return out

    kernel.block_dominance_counts = launch
    return self

  def __exit__(self, *exc):
    from repro_torch.kernels.pareto_front import kernel
    kernel.block_dominance_counts = self._inner

  def hold(self, tag: str) -> int:
    """Max |kernel - plain| over the recorded launches (0 or raises)."""
    from repro_torch.kernels.pareto_front import ref
    if not self.records:
      raise AssertionError(f"{tag}: K1 never launched")
    err = max(int((out.long() - ref.block_dominance_counts_ref(
        obj_t.T, block).long()).abs().max())
        for obj_t, block, out in self.records)
    if err:
      raise AssertionError(f"{tag}: K1 differs from its plain version by "
                           f"{err}")
    return err


def _service_spaces():
  from repro_torch.core.ppa import HW_RANGES
  from repro_torch.explore import DesignSpace
  from repro_torch.explore.space import AXIS_ORDER
  axes = {name: HW_RANGES[name][:SERVICE_TAKE[name]] for name in AXIS_ORDER}
  edited = dict(axes)
  edited["pe_rows"] = HW_RANGES["pe_rows"][:SERVICE_TAKE["pe_rows"] + 1]
  return DesignSpace(axes=axes), DesignSpace(axes=edited)


def _results_identical(got, want) -> bool:
  """service_perf's identity: pareto and top-k, every metric column."""
  import numpy as np
  return all(
      np.array_equal(getattr(got["pareto"], c), getattr(want["pareto"], c))
      and np.array_equal(getattr(got["top"], c), getattr(want["top"], c))
      for c in BASE_COLS)


def phase_service(layers):
  """``benchmarks/service_perf.py``'s recipe on the card, nothing cut
  (its record results/BENCH_service.json): a cold full-grid sweep through
  ``ExplorationService`` with a store, the identical resubmission (a store
  hit), a one-axis edit (a delta sweep over the new subgrid) against the
  edited space from scratch, and two chaos sessions under seeded task
  faults and a shared breaker against solo runs; then one session over
  sweep_reducers() (its 3-D front runs K1), held to the solo stream."""
  import shutil
  import tempfile
  import numpy as np
  import torch
  from repro_torch.explore import (CircuitBreaker, DesignSpace,
                                   ExplorationService, FaultPlan,
                                   ParetoAccumulator, RetryPolicy,
                                   TopKAccumulator, TorchOracleBackend,
                                   stream_explore)
  from repro_torch.kernels.pareto_front import kernel
  record = json.loads(SERVICE_RECORD.read_text())
  base_space, edited_space = _service_spaces()
  small = layers[:4]

  def reducers():
    return {"pareto": ParetoAccumulator(("latency_s", "power_mw")),
            "top": TopKAccumulator(50, by="power_mw")}

  def backend():
    return TorchOracleBackend(chunk_size=SERVICE_CHUNK)

  def grid_submit(svc, space):
    return svc.submit_explore(space, small, "resnet20",
                              n_per_type=space.per_type_grid_size(),
                              method="grid", chunk_size=SERVICE_CHUNK,
                              reducers=reducers())

  def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0

  def drained(svc, space):
    h = grid_submit(svc, space)
    svc.drain()
    return h.result()

  sdir = Path(tempfile.mkdtemp(prefix="service-", dir=ROOT / "build"))
  try:
    svc = ExplorationService(backend(), slots=2, store=str(sdir))
    cold, cold_s = timed(lambda: drained(svc, base_space))
    hit, hit_s = timed(lambda: grid_submit(svc, base_space).result())
    delta, delta_s = timed(lambda: drained(svc, edited_space))
    scratch, scratch_s = timed(lambda: stream_explore(
        backend(), edited_space, small, network="resnet20",
        n_per_type=edited_space.per_type_grid_size(), method="grid",
        reducers=reducers(), chunk_size=SERVICE_CHUNK))
    service = svc.service_meta()
  finally:
    shutil.rmtree(sdir, ignore_errors=True)

  space = DesignSpace()
  refs = {s: stream_explore(backend(), space, small, network="resnet20",
                            n_per_type=SERVICE_CHAOS_PER_TYPE, seed=s,
                            reducers=reducers(), chunk_size=SERVICE_CHUNK)
          for s in (1, 2)}
  plan = FaultPlan.seeded(seed=5, n_chunks=16, p_raise=0.5, layer="task",
                          times=2)
  chaos = ExplorationService(backend(), slots=2,
                             retry=RetryPolicy(sleep=lambda s: None),
                             fault_plan=plan,
                             breaker=CircuitBreaker(threshold=2))

  def chaos_run():
    handles = {s: chaos.submit_explore(space, small, "resnet20",
                                       n_per_type=SERVICE_CHAOS_PER_TYPE,
                                       seed=s, chunk_size=SERVICE_CHUNK,
                                       reducers=reducers())
               for s in (1, 2)}
    chaos.drain()
    return {s: h.result() for s, h in handles.items()}

  sessions, chaos_s = timed(chaos_run)
  got = {"n_pairs": scratch.n_rows, "base_rows": cold.n_rows,
         "delta_rows": int(delta.meta.get("n_delta_rows", 0)),
         "store_hit_taken": hit.meta.get("store_hit") == 1.0,
         "store_hit_bit_identical": _results_identical(hit, cold),
         "delta_sweep_taken": delta.meta.get("delta_sweep") == 1.0,
         "delta_bit_identical": (_results_identical(delta, scratch)
                                 and delta.n_rows == scratch.n_rows),
         "chaos_sessions": len(sessions),
         "chaos_faults_fired": plan.n_fired,
         "chaos_bit_identical": all(_results_identical(sessions[s], refs[s])
                                    for s in sessions)}
  log("[service] port (record results/BENCH_service.json, the reference "
      "on a host CPU): " + "; ".join(f"{k} {v!r} ({record[k]!r})"
                                     for k, v in got.items()))
  log(f"[service] seconds a phase on the card: cold grid sweep "
      f"{cold_s:.4f} ({cold.n_rows} rows, {int(cold.meta['n_chunks'])} "
      f"chunks), store hit {hit_s:.6f}, delta sweep {delta_s:.4f} "
      f"({int(delta.meta['n_chunks'])} chunks), scratch {scratch_s:.4f}, "
      f"chaos {chaos_s:.4f} ({int(sum(r.meta['n_retries'] for r in sessions.values()))} "
      f"retries, {int(sum(r.meta['n_demotions'] for r in sessions.values()))} "
      f"demotions, breaker {sessions[1].meta['breaker_state']}); "
      f"store-hit speedup {cold_s / max(hit_s, 1e-9):.1f}x, delta "
      f"speedup {scratch_s / max(delta_s, 1e-9):.2f}x")
  log(f"[service] service_meta: " + ", ".join(
      f"{k} {v}" for k, v in service.items()
      if isinstance(v, (int, float))))
  differ = [k for k, v in got.items() if v != record[k]]
  if differ:
    raise AssertionError(f"[service] differs from its record in {differ}")

  # one more session: the 3-D front, so K1 runs under the service
  n, seed, chunk = (SERVICE_K1["n_per_type"], SERVICE_K1["seed"],
                    SERVICE_K1["chunk"])
  want = stream_explore(TorchOracleBackend(chunk_size=chunk), space, layers,
                        "resnet20", n_per_type=n, seed=seed,
                        reducers=sweep_reducers(), chunk_size=chunk)
  svc = ExplorationService(TorchOracleBackend(chunk_size=chunk), slots=2)
  kernel.reset_launch_counts()
  with _K1Recorder() as rec:
    t0 = time.perf_counter()
    h = svc.submit_explore(space, layers, "resnet20", n_per_type=n,
                           seed=seed, chunk_size=chunk,
                           reducers=sweep_reducers())
    svc.drain()
    res = h.result()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
  k1 = kernel.LAUNCHES["block_dominance_counts"]
  err = rec.hold("[service]")
  same = (_stream_results_equal(res, want, ("pareto", "pareto3", "top"))
          and _stats_close(res["stats"], want["stats"]))
  log(f"[service] a session over sweep_reducers(), {res.n_rows} designs in "
      f"{int(res.meta['n_chunks'])} chunks, {secs:.3f} s: K1 launches {k1}, "
      f"the first {len(rec.records)} held to the plain version (max "
      f"|diff| {err}); fronts, top-k and histogram identical to the solo "
      f"stream, stats within 1e-12: {same}")
  if not same or k1 != int(res.meta["n_chunks"]):
    raise AssertionError("[service] the K1 session differs")
  return {"k1_launches": k1, "k1_err": err,
          "ms": {"cold": cold_s * 1e3, "hit": hit_s * 1e3,
                 "delta": delta_s * 1e3, "scratch": scratch_s * 1e3,
                 "chaos": chaos_s * 1e3}}


def phase_fleet(layers, sweep, sweep_launches):
  """A ``DevicePool()`` of the card through ``stream_explore(...,
  pool=pool)`` over [sweep]'s sweep and reducers: bit-identical to
  [sweep], the same K1 launches; the sentinel (``sdc_check_every``) on
  the 100,000-design stream, its CPU recomputes matching; and the one
  device quarantined, which must raise ``ChunkError`` (H13)."""
  import numpy as np
  import torch
  from repro_torch.explore import (ChunkError, DesignSpace, DevicePool,
                                   TorchOracleBackend, stream_explore)
  from repro_torch.kernels.pareto_front import kernel
  space = DesignSpace()
  pool = DevicePool()
  backend = TorchOracleBackend(chunk_size=SWEEP_CHUNK)
  kernel.reset_launch_counts()
  with _K1Recorder() as rec:
    t0 = time.perf_counter()
    res = stream_explore(backend, space, layers, "resnet20",
                         n_per_type=SWEEP_PER_TYPE,
                         reducers=sweep_reducers(), chunk_size=SWEEP_CHUNK,
                         pool=pool)
    torch.cuda.synchronize()
    pooled_s = time.perf_counter() - t0
  k1 = kernel.LAUNCHES["block_dominance_counts"]
  err = rec.hold("[fleet]")
  same = (_stream_results_equal(res, sweep, ("pareto", "pareto3", "top"))
          and _stats_close(res["stats"], sweep["stats"]))
  exact_stats = res["stats"] == sweep["stats"]
  log(f"[fleet] DevicePool({[str(d) for d in pool.devices()]}) over "
      f"[sweep]'s {res.n_rows} designs in {int(res.meta['n_chunks'])} "
      f"chunks, {pooled_s:.3f} s ({res.n_rows / pooled_s:.1f} rows/s; "
      f"[sweep] "
      f"{sweep.meta['rows_per_sec']:.1f}): fronts, top-k and histogram "
      f"identical to [sweep], stats within 1e-12: {same} (bit for bit: "
      f"{exact_stats}); K1 launches {k1} ([sweep] "
      f"{sweep_launches['block_dominance_counts']}), the first "
      f"{len(rec.records)} held to the plain version (max |diff| {err})")
  if not same or k1 != sweep_launches["block_dominance_counts"]:
    raise AssertionError("[fleet] the pooled sweep differs from [sweep]")

  n, seed, chunk = (SERVICE_K1["n_per_type"], SERVICE_K1["seed"],
                    SERVICE_K1["chunk"])
  small = TorchOracleBackend(chunk_size=chunk)
  want = stream_explore(small, space, layers, "resnet20", n_per_type=n,
                        seed=seed, reducers=sweep_reducers(),
                        chunk_size=chunk)
  sentinel = DevicePool(sdc_check_every=FLEET_SDC_EVERY)
  t0 = time.perf_counter()
  got = stream_explore(small, space, layers, "resnet20", n_per_type=n,
                       seed=seed, reducers=sweep_reducers(),
                       chunk_size=chunk, pool=sentinel)
  secs = time.perf_counter() - t0
  same = (_stream_results_equal(got, want, ("pareto", "pareto3", "top"))
          and _stats_close(got["stats"], want["stats"]))
  log(f"[fleet] sdc_check_every={FLEET_SDC_EVERY} over the {got.n_rows}-"
      f"design stream ({int(got.meta['n_chunks'])} chunks), {secs:.3f} s: "
      f"{int(got.meta['n_corruption_checks'])} sentinel checks recomputed "
      f"on the CPU, {int(got.meta['n_corruptions_detected'])} mismatches; "
      f"results identical to the pool-less stream: {same}")
  if (not same or got.meta["n_corruption_checks"] < 1
      or got.meta["n_corruptions_detected"]):
    raise AssertionError("[fleet] the sentinel's CPU recompute differs")

  dead = DevicePool(breaker_cooldown=1000, breaker_jitter=0)
  dead.quarantine(0)
  try:
    stream_explore(small, space, layers, "resnet20", n_per_type=1000,
                   seed=seed, reducers=sweep_reducers(), chunk_size=chunk,
                   pool=dead)
  except ChunkError as e:
    log(f"[fleet] the one device quarantined: ChunkError ({e}); no host "
        "rung under a card backend (H13)")
  else:
    raise AssertionError("[fleet] a quarantined pool did not raise")
  counters = {"sweep": pool.counters(), "sentinel": sentinel.counters(),
              "quarantined": dead.counters()}
  log(f"[fleet] pool counters(): {counters}")
  return {"k1_launches": k1, "k1_err": err, "ms": pooled_s * 1e3}


def phase_store_parity(layers):
  """A store entry from a card run (``cached_stream_explore`` over
  sweep_reducers()), loaded by a fresh process on the CPU as a store hit
  and held to the card's results and to a CPU run."""
  import shutil
  import tempfile
  import numpy as np
  import torch
  from repro_torch.explore import (DesignSpace, ResultStore,
                                   TorchOracleBackend, cached_stream_explore)
  n, seed, chunk = (STORE_PARITY["n_per_type"], STORE_PARITY["seed"],
                    STORE_PARITY["chunk"])
  sdir = Path(tempfile.mkdtemp(prefix="store-parity-", dir=ROOT / "build"))
  try:
    card = cached_stream_explore(
        TorchOracleBackend(chunk_size=chunk), DesignSpace(), layers,
        "resnet20", n_per_type=n, seed=seed, reducers=sweep_reducers(),
        chunk_size=chunk, store=ResultStore(sdir))
    torch.cuda.synchronize()
    names = ("pareto", "pareto3", "top")
    np.savez(sdir / "card.npz", hist=card["hist"]["counts"],
             stats=np.asarray([card["stats"][k] for k in sorted(
                 card["stats"])]),
             **{f"{name}_{c}": card[name].column(c) for name in names
                for c in BASE_COLS})
    script = f"""
import sys
import numpy as np
sys.path.insert(0, {str(ROOT / 'src')!r})
sys.path.insert(0, {str(ROOT)!r})
from chip_smoke import sweep_reducers
from repro_torch.core.workloads import get_network
from repro_torch.explore import (DesignSpace, ResultStore,
                                 TorchOracleBackend, cached_stream_explore,
                                 stream_explore)
import torch
assert not torch.cuda.is_available()
kw = dict(n_per_type={n}, seed={seed}, chunk_size={chunk})
layers = get_network("resnet20")
hit = cached_stream_explore(TorchOracleBackend(device="cpu"), DesignSpace(),
                            layers, "resnet20", reducers=sweep_reducers(),
                            store=ResultStore({str(sdir)!r}), **kw)
assert hit.meta["store_hit"] == 1.0, hit.meta
cpu = stream_explore(TorchOracleBackend(device="cpu"), DesignSpace(), layers,
                     "resnet20", reducers=sweep_reducers(), **kw)
card = np.load({str(sdir / 'card.npz')!r})
for res in (hit, cpu):
  for name in {names!r}:
    for c in {BASE_COLS!r}:
      assert np.array_equal(res[name].column(c), card[name + "_" + c]), name
  assert np.array_equal(res["hist"]["counts"], card["hist"])
  got = np.asarray([res["stats"][k] for k in sorted(res["stats"])])
  assert np.all(np.abs(got - card["stats"]) <= 1e-12 * np.abs(card["stats"]))
print("STORE-PARITY", len(hit["pareto"]), len(hit["pareto3"]),
      len(hit["top"]), hit.n_rows)
"""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
  finally:
    shutil.rmtree(sdir, ignore_errors=True)
  if proc.returncode != 0 or "STORE-PARITY" not in proc.stdout:
    raise AssertionError(f"[store-parity] the CPU process failed:\n"
                         f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
  sizes = proc.stdout.split("STORE-PARITY")[1].split()
  log(f"[store-parity] {card.n_rows} designs swept on the card into a "
      f"store; a fresh CPU process ({secs:.2f} s) loaded the entry as a "
      f"store hit: fronts {sizes[0]} / {sizes[1]} and top-{sizes[2]} "
      f"identical to the card's and to its own CPU sweep, histogram equal, "
      f"stats within 1e-12")


def phase_workers(layers, sweep):
  """[sweep]'s sweep at ``workers=WORKERS`` on the card (each thread
  dispatches on its own current stream; folds in chunk-index order):
  bit-identical to ``workers=1``.  Runs 1, N, N, 1 and prints each
  time."""
  import torch
  from repro_torch.explore import (DesignSpace, TorchOracleBackend,
                                   stream_explore)
  from repro_torch.kernels.pareto_front import kernel
  times = []
  for workers in (1, WORKERS, WORKERS, 1):
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    res = stream_explore(TorchOracleBackend(chunk_size=SWEEP_CHUNK),
                         DesignSpace(), layers, "resnet20",
                         n_per_type=SWEEP_PER_TYPE,
                         reducers=sweep_reducers(), chunk_size=SWEEP_CHUNK,
                         workers=workers)
    torch.cuda.synchronize()
    times.append((workers, time.perf_counter() - t0))
    k1 = kernel.LAUNCHES["block_dominance_counts"]
    same = (_stream_results_equal(res, sweep, ("pareto", "pareto3", "top"))
            and res["stats"] == sweep["stats"])
    if not same or k1 != int(res.meta["n_chunks"]):
      raise AssertionError(f"[workers] workers={workers} differs from "
                           f"[sweep] (K1 {k1})")
  log(f"[workers] [sweep]'s {res.n_rows} designs at workers 1, {WORKERS}, "
      f"{WORKERS}, 1: " + ", ".join(f"{w}: {t:.3f} s" for w, t in times)
      + f"; every run bit-identical to [sweep], stats included; K1 once a "
      f"chunk in each")
  return times


# CUDA runtime calls by what they are: waits on the card, copies, the
# allocators, launches ([workers-trace])
RUNTIME_KINDS = (("sync", ("Synchronize", "cudaStreamWaitEvent")),
                 ("copy", ("cudaMemcpy",)),
                 ("alloc", ("cudaMalloc", "cudaFree", "cudaHostAlloc",
                            "cudaFreeHost", "cudaHostRegister")),
                 ("launch", ("cudaLaunchKernel",)))


def phase_workers_trace(layers):
  """[workers]'s slowdown traced, nothing changed: [sweep]'s stream (half
  its designs) at 1 and at ``WORKERS`` workers, each chunk task's
  dispatch timed on its thread (wall and the thread's own CPU time), the
  main thread's resolve and fold timed, and the run profiled: the CUDA
  runtime's calls (waits, copies, allocations, launches; CUPTI sees them
  on every thread) and the card's busy time.  A thread blocked on the GIL
  or a lock spends wall time and no CPU time; one in a synchronize or a
  copy shows in the runtime's calls."""
  import threading
  import torch
  from torch.profiler import ProfilerActivity, profile
  from repro_torch.explore import (DesignSpace, TorchOracleBackend,
                                   stream_explore)
  from repro_torch.explore import resilience, streaming
  real_call, real_fold = resilience.ChunkTask.__call__, streaming.fold_chunk
  medians = {}
  for workers in (1, WORKERS):
    spans, folds = [], []
    lock = threading.Lock()

    def call(task):
      t0, c0 = time.perf_counter(), time.thread_time()
      out = real_call(task)
      with lock:
        spans.append(((time.perf_counter() - t0) * 1e3,
                      (time.thread_time() - c0) * 1e3))
      return out

    def fold(*args):
      t0 = time.perf_counter()
      real_fold(*args)
      folds.append((time.perf_counter() - t0) * 1e3)

    resilience.ChunkTask.__call__, streaming.fold_chunk = call, fold
    torch.cuda.synchronize()
    try:
      with profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stream_explore(TorchOracleBackend(chunk_size=SWEEP_CHUNK),
                       DesignSpace(), layers, "resnet20",
                       n_per_type=TRACE_PER_TYPE, reducers=sweep_reducers(),
                       chunk_size=SWEEP_CHUNK, workers=workers)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
      resilience.ChunkTask.__call__, streaming.fold_chunk = real_call, \
          real_fold
    runtime, device_us = {}, 0.0
    for e in prof.key_averages():
      if e.device_type == torch.autograd.DeviceType.CUDA:
        device_us += e.self_device_time_total
        continue
      kind = next((k for k, words in RUNTIME_KINDS
                   if any(w in e.key for w in words)), None)
      if kind is not None:
        n, us = runtime.get(kind, (0, 0.0))
        runtime[kind] = (n + e.count, us + e.self_cpu_time_total)
    task_wall = statistics.median(w for w, _ in spans)
    task_cpu = statistics.median(c for _, c in spans)
    medians[workers] = (task_wall, task_cpu)
    log(f"[workers-trace] workers={workers}: {len(spans)} chunks in "
        f"{wall:.3f} s (profiled); a chunk's dispatch on its thread: wall "
        f"median {task_wall:.1f} ms, its thread's CPU time median "
        f"{task_cpu:.1f} ms ({task_cpu / task_wall:.0%}); over the chunks "
        f"{sum(w for w, _ in spans) / 1e3:.3f} s of thread wall time, "
        f"{sum(c for _, c in spans) / 1e3:.3f} s of CPU time; the main "
        f"thread's resolve + fold {sum(folds) / 1e3:.3f} s (median "
        f"{statistics.median(folds):.1f} ms a chunk); CUDA runtime calls "
        + ", ".join(f"{k} {n} calls {us / 1e3:.1f} ms"
                    for k, (n, us) in sorted(runtime.items()))
        + f"; the card busy {device_us / 1e3:.1f} ms "
        f"({device_us / 1e6 / wall:.1%} of the run)")
  (w1, c1), (wn, cn) = medians[1], medians[WORKERS]
  log(f"[workers-trace] at {WORKERS} workers a chunk's dispatch takes "
      f"{wn / w1:.2f}x the wall time and {cn / c1:.2f}x the CPU time it "
      "takes at 1 (medians)")


def phase_resilience_perf():
  """``benchmarks/framework_perf.py::resilience_perf`` at full scale on
  the card (its record results/BENCH_resilience.json): 200 archs x 500
  HW a type streamed in 65,536-pair blocks; (a) killed at block
  n_chunks // 2 and resumed from its journal; (b) healed under a seeded
  plan of task faults."""
  import shutil
  import tempfile
  import torch
  from repro_torch.explore import (ChunkError, DesignSpace,
                                   ExplorationSession, Fault, FaultPlan,
                                   ParetoAccumulator, TopKAccumulator,
                                   TorchOracleBackend)
  from repro_torch.explore.streaming import DISPATCH_AHEAD
  record = json.loads(RES_PERF_RECORD.read_text())
  arch_accs = co_arch_accs(RES_PERF["n_archs"])
  session = ExplorationSession(
      TorchOracleBackend(chunk_size=RES_PERF["chunk"]), DesignSpace())

  def sweep(**kw):
    return session.co_explore(
        arch_accs, n_hw_per_type=RES_PERF["n_hw_per_type"], seed=3,
        image_size=16, stream=True, chunk_size=RES_PERF["chunk"],
        reducers={"pareto": ParetoAccumulator(CO_JOINT3),
                  "top": TopKAccumulator(50, by="energy_mj")}, **kw)

  def timed(**kw):
    t0 = time.perf_counter()
    out = sweep(**kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0

  ref, healthy_s = timed()
  n_chunks = int(ref.meta["n_chunks"])
  kill_at = n_chunks // 2
  jdir = Path(tempfile.mkdtemp(prefix="resilience-perf-", dir=ROOT / "build"))
  try:
    killed = -1
    try:
      sweep(policy=_no_wait_policy(fault_plan=FaultPlan(
          [Fault("kill", kill_at, "task")])), resume_from=jdir)
    except ChunkError as e:
      killed = e.chunk_index
    resumed, resume_s = timed(resume_from=jdir)
  finally:
    shutil.rmtree(jdir, ignore_errors=True)
  plan = FaultPlan.seeded(7, n_chunks, p_raise=0.5, layer="task")
  healed, faulty_s = timed(policy=_no_wait_policy(fault_plan=plan))
  got = {"n_pairs": ref.n_rows, "n_chunks": n_chunks,
         "kill_at_chunk": kill_at, "killed_chunk_index": killed,
         "n_resumed_chunks": int(resumed.meta["n_resumed_chunks"]),
         "resume_bit_identical": _results_identical(resumed, ref),
         "injected_faults": len(plan.faults),
         "faults_fired": plan.n_fired,
         "n_retries": int(healed.meta["n_retries"]),
         "n_demotions": int(healed.meta["n_demotions"]),
         "healed_bit_identical": _results_identical(healed, ref)}
  log("[resilience-perf] port (record results/BENCH_resilience.json, the "
      "reference on a host CPU): " + "; ".join(
          f"{k} {v!r} ({record[k]!r})" for k, v in got.items()))
  log(f"[resilience-perf] n_resumed_chunks {got['n_resumed_chunks']}, not "
      f"the record's {record['n_resumed_chunks']}: a checkpoint holds only "
      f"folded blocks, and the {DISPATCH_AHEAD} blocks of the dispatch "
      f"window in flight at the kill were not folded, so they run again "
      f"(the reference's numpy path has no window); seconds on the card: "
      f"healthy {healthy_s:.4f}, resume {resume_s:.4f} "
      f"({resume_s / healthy_s:.3f} of healthy), healed {faulty_s:.4f} "
      f"({faulty_s / healthy_s:.3f})")
  want = dict((k, record[k]) for k in got)
  want["n_resumed_chunks"] = kill_at - DISPATCH_AHEAD
  if got != want:
    raise AssertionError(f"[resilience-perf] differs from its record: "
                         f"{got} vs {want}")


# ---------------------------------------------------------------------------
# the paper's model side: QAT CNNs, the supernet, Table 2's accuracy,
# figs 10-12 and the paper's remaining figures
# ---------------------------------------------------------------------------

def _events():
  import torch
  return (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))


def phase_accuracy_profile(smi):
  """Where a QAT step's time goes: one step's device operations and
  device time (``torch.profiler``) against the step between events."""
  import torch
  from repro_torch.data import CifarLike, CifarLikeConfig
  from repro_torch.train import qat
  for kind, pe_type, width, image in QAT_PROFILE:
    _, step = qat.qat_trainer(kind, pe_type, "cuda", width)
    x, y = (torch.from_numpy(a).cuda() for a in CifarLike(CifarLikeConfig(
        image_size=image)).sample(qat.RECIPE["batch"], split_seed=0))
    name = f"{kind} width {width}, {image} px, {pe_type}, one step"
    for _ in range(2):
      step(x, y)
    rows = []
    timed_stage(rows, "step", lambda: step(x, y))
    device_ms = _device_profile("accuracy", name, lambda: step(x, y))
    _, host_ms, event_ms = rows[0]
    log(f"[accuracy-profile] {name}: {host_ms:.2f} ms (host), "
        f"{event_ms:.2f} ms (events); the card busy "
        + (f"{device_ms / event_ms:.1%} of it" if device_ms else
           "not measured") + f"; card: {smi}")


def _qat_line(tag, r):
  from repro_torch.train.qat import RECIPE
  imgs = RECIPE["batch"] / (r["event_ms"] / 1e3)
  return (f"{tag}: top-1 {r['acc']:.4f}, loss {r['losses'][0]:.4f} -> "
          f"{r['losses'][-1]:.6f}; {r['host_ms']:.2f} ms a step (host), "
          f"{r['event_ms']:.2f} ms (events), {imgs:.1f} images/s")


def phase_accuracy(smi):
  """Table 2's accuracy columns: (a) the reference's sizes under each
  paper PE type, twice (deterministic cuDNN, TF32 off: identical runs,
  H19), each accuracy within QAT_REF_TOL of the reference's CPU value;
  (b) the paper's widths at 32 px."""
  import math
  from repro_torch.core.pe import PAPER_PE_TYPES
  t_phase = time.perf_counter()
  from repro_torch.train.qat import train_qat
  runs = [{t: train_qat("resnet20", t, "cuda") for t in PAPER_PE_TYPES}
          for _ in range(2)]
  for t in PAPER_PE_TYPES:
    a, b = runs[0][t], runs[1][t]
    log(_qat_line(f"[accuracy] (a) resnet20 width 8, 16 px, {t}", a)
        + f"; reference on a host CPU {QAT_REF_CPU[t]:.3f} (diff "
        f"{a['acc'] - QAT_REF_CPU[t]:+.4f}); rerun top-1 {b['acc']:.4f}, "
        f"final loss {b['losses'][-1]:.6f}, "
        f"{'identical' if a['losses'] == b['losses'] else 'DIFFERENT'}")
    if a["acc"] != b["acc"] or a["losses"] != b["losses"]:
      raise AssertionError(f"[accuracy] {t}: a rerun differs")
    if not abs(a["acc"] - QAT_REF_CPU[t]) <= QAT_REF_TOL:
      raise AssertionError(f"[accuracy] {t}: top-1 {a['acc']:.4f} is more "
                           f"than {QAT_REF_TOL} from the reference's "
                           f"{QAT_REF_CPU[t]}")
  log(f"[accuracy] (b) the paper's widths: width 16 (the VGG supernet at "
      f"max_arch(), its own widths), {QAT_PAPER_IMAGE} px, "
      f"{QAT_PAPER_STEPS} steps; nothing else changed from (a)")
  for kind, width in QAT_PAPER:
    for t in PAPER_PE_TYPES:
      r = train_qat(kind, t, "cuda", width=width, image=QAT_PAPER_IMAGE,
                    steps=QAT_PAPER_STEPS)
      log(_qat_line(f"[accuracy] (b) {kind}"
                    + (f" width {width}" if kind != "vgg" else " (VGG16 "
                       "plan)") + f", {QAT_PAPER_IMAGE} px, {t}", r))
      if not (all(math.isfinite(l) for l in r["losses"])
              and 0.0 <= r["acc"] <= 1.0):
        raise AssertionError(f"[accuracy] (b) {kind} {t}: not finite")
  log(f"[accuracy] {time.perf_counter() - t_phase:.1f} s; card: {smi}")
  return {t: r["acc"] for t, r in runs[0].items()}


def _poly_session():
  from repro_torch.core.workloads import get_network
  from repro_torch.explore import (DesignSpace, ExplorationSession,
                                   PolynomialBackend)
  backend = PolynomialBackend.fit_or_load(
      str(POLY_CACHE), layers=get_network("resnet20") + get_network("vgg16"),
      **POLY_FIT)
  return ExplorationSession(backend, DesignSpace())


def phase_fig10_11(accs, sess):
  """Figs 10-11: (a)'s accuracies against the best normalised perf/area
  and energy of each PE type (the reference's second ``_train_qat`` call
  is the same training as Table 2's, so its accuracies are reused), and
  the two 2-D fronts through ``pareto_mask``."""
  import numpy as np
  from repro_torch.core.pe import PAPER_PE_TYPES
  from repro_torch.core.workloads import get_network
  from repro_torch.explore import pareto_mask
  t0 = time.perf_counter()
  frame = sess.explore(get_network("resnet20"), "resnet20",
                       n_per_type=FIG1011_PER_TYPE)
  ppa_n, en_n = frame.normalize(ref="best-int16")
  pts = [(t, accs[t], float(ppa_n[frame.by_type(t)].max()),
          float(en_n[frame.by_type(t)].min())) for t in PAPER_PE_TYPES]
  err = np.asarray([1 - a for _, a, _, _ in pts])
  fronts = {}
  for name, col in (("ppa", [1.0 / p for _, _, p, _ in pts]),
                    ("energy", [e for _, _, _, e in pts])):
    mask = pareto_mask(np.stack([err, np.asarray(col)], 1))
    fronts[name] = "/".join(pts[i][0] for i in range(len(pts)) if mask[i])
  ref = FIG1011_REF_CPU
  log(f"[fig10-11] resnet20, {len(frame)} designs ({FIG1011_PER_TYPE} a "
      f"type) in {time.perf_counter() - t0:.3f} s: " + "; ".join(
          f"{t} acc {a:.4f} perf/area {p:.2f}x (reference "
          f"{ref['ppa'][t]:.2f}x) energy {e:.3f}x (reference "
          f"{ref['energy'][t]:.3f}x)" for t, a, p, e in pts))
  log(f"[fig10-11] front_ppa={fronts['ppa']} (reference "
      f"{ref['front_ppa']}), front_energy={fronts['energy']} (reference "
      f"{ref['front_energy']})")
  return fronts


def phase_fig12(smi, sess):
  """Fig 12: co-exploration scored by the port's supernet. (a) the
  reference's recipe through the polynomial session; (b) the 32-px
  supernet, 1,000 archs, and [coexplore]'s 10,000,000-pair stream at 32
  px through the exact oracle."""
  import numpy as np
  import torch
  from repro_torch.core.supernet import Supernet, SupernetConfig
  from repro_torch.explore import (DesignSpace, ExplorationSession,
                                   TorchOracleBackend)

  def supernet(cfg, n_archs, n_val, tag):
    sn = Supernet(SupernetConfig(**cfg))
    torch.cuda.synchronize()
    start, end = _events()
    t0 = time.perf_counter()
    start.record()
    losses = sn.train(log_every=0)
    end.record()
    torch.cuda.synchronize()
    steps = len(losses)
    train_ms = ((time.perf_counter() - t0) * 1e3 / steps,
                start.elapsed_time(end) / steps)
    start, end = _events()
    t0 = time.perf_counter()
    start.record()
    arch_accs = sn.sample_and_evaluate(n_archs=n_archs, n_val=n_val)
    end.record()
    torch.cuda.synchronize()
    eval_ms = ((time.perf_counter() - t0) * 1e3 / n_archs,
               start.elapsed_time(end) / n_archs)
    accs = [a for _, a in arch_accs]
    log(f"[fig12] {tag} supernet {cfg}: {steps} steps, loss "
        f"{losses[0]:.4f} -> {np.mean(losses[-10:]):.4f} (mean of the last "
        f"10), {train_ms[0]:.2f} ms a step (host), {train_ms[1]:.2f} ms "
        f"(events); {n_archs} archs on {n_val} images, {eval_ms[0]:.2f} ms "
        f"an arch (host), {eval_ms[1]:.2f} ms (events); accuracy "
        f"{min(accs):.3f}-{max(accs):.3f}")
    if not (all(np.isfinite(losses)) and len(arch_accs) == n_archs):
      raise AssertionError(f"[fig12] {tag}: non-finite losses")
    return arch_accs

  r = FIG12_REF
  arch_accs = supernet(r["supernet"], r["n_archs"], r["n_val"], "(a)")
  t0 = time.perf_counter()
  frame = sess.co_explore(arch_accs, n_hw_per_type=r["n_hw_per_type"])
  front = frame.pareto(cols=("top1_err", "energy_mj"))
  types = "/".join(sorted(set(str(t) for t in frame.pe_type[front])))
  accs = [a for _, a in arch_accs]
  ref = FIG12_REF_CPU
  log(f"[fig12] (a) co_explore (polynomial models) in "
      f"{time.perf_counter() - t0:.3f} s: {len(frame)} pairs (reference "
      f"{ref['pairs']}), front_energy_types={types} (reference "
      f"{ref['front_energy']}), acc_range={min(accs):.3f}-{max(accs):.3f} "
      f"(reference {ref['acc_range'][0]:.3f}-{ref['acc_range'][1]:.3f})")
  if len(frame) != ref["pairs"]:
    raise AssertionError(f"[fig12] (a) {len(frame)} pairs")

  p = FIG12_PAPER
  arch_accs = supernet(p["supernet"], p["n_archs"], p["n_val"], "(b)")
  session = ExplorationSession(TorchOracleBackend(chunk_size=CO_CHUNK),
                               DesignSpace())
  torch.cuda.synchronize()
  res = session.co_explore(arch_accs, n_hw_per_type=p["n_hw_per_type"],
                           seed=CO_SEED, image_size=p["image_size"],
                           stream=True, reducers=co_reducers(),
                           chunk_size=CO_CHUNK)
  torch.cuda.synchronize()
  m, front = res.meta, res["pareto"]
  types = sorted(set(front.pe_type.tolist()))
  log(f"[fig12] (b) {res.n_rows} pairs ({p['n_archs']} supernet-scored "
      f"archs x {4 * p['n_hw_per_type']} HW, {p['image_size']} px) in "
      f"{int(m['n_chunks'])} blocks, {m['seconds']:.3f} s: "
      f"{m['rows_per_sec']:.1f} pairs/s; joint front (top1_err, energy_mj, "
      f"area_mm2) {len(front)} points, PE types {'/'.join(types)}, archs "
      f"{len(set(front.extra['arch_id'].tolist()))}; card: {smi}")
  if res.n_rows != p["n_archs"] * 4 * p["n_hw_per_type"] or not len(front):
    raise AssertionError("[fig12] (b) wrong pair count or an empty front")


def _rel(got, want) -> float:
  got, want = got.detach().double().cpu(), want.detach().double().cpu()
  return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _jittered(net, seed):
  """A copy of ``net`` (on the CPU) with every weight moved by one ulp, up
  or down at random."""
  import copy
  import torch
  moved = copy.deepcopy(net)
  gen = torch.Generator().manual_seed(seed)
  with torch.no_grad():
    for p in moved.parameters():
      up = torch.rand(p.shape, generator=gen) < 0.5
      p.copy_(torch.nextafter(p, torch.where(up, torch.inf, -torch.inf)))
  return moved


def _conv_layer(x, w, dy, pe_type, device):
  """One quantized 3x3 stride-2 conv on ``device``, forward and backward
  from ``x``, ``w`` and the output gradient ``dy``, under ``exact_f32``
  as ``cnn.value_and_grad`` runs them: the output and the gradients of
  ``x`` and ``w``."""
  from repro_torch.core import cnn
  xt = x.detach().to(device).requires_grad_()
  wt = w.detach().to(device).requires_grad_()
  with cnn.exact_f32():
    o = cnn.conv2d(cnn._maybe_fq_act(xt, pe_type),
                   cnn._maybe_fq(wt, pe_type), 2)
    o.backward(dy.to(device))
  return o, xt.grad, wt.grad


def _tf32_backward_grads(net, loss_fn):
  """The control of the FP32 gradient check (H19): ``loss_fn``'s forward
  under ``exact_f32``, its backward with TF32 allowed, as a caller's
  flags may leave it (cuDNN and cuBLAS read their flags when the backward
  runs); every parameter's gradient."""
  import torch
  from repro_torch.core import cnn
  for p in net.parameters():
    p.grad = None
  with cnn.exact_f32():
    loss = loss_fn()
  prev = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = True
  try:
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=True):
      loss.backward()
  finally:
    torch.backends.cuda.matmul.allow_tf32 = prev
  return {n: p.grad for n, p in net.named_parameters()}


def phase_accuracy_parity():
  """The card against the CPU from one set of weights and one batch
  (H19-H20): logits and loss under each PE type, FP32 gradients per
  leaf, a quantized conv's output and gradients from identical inputs,
  one ``sgd_update`` bit for bit, 10 QAT steps, 3 supernet steps."""
  import numpy as np
  import torch
  from repro_torch.core import cnn
  from repro_torch.core.pe import PAPER_PE_TYPES
  from repro_torch.core.supernet import Supernet, SupernetConfig
  from repro_torch.data import CifarLike, CifarLikeConfig
  from repro_torch.train import optimizer as opt
  from repro_torch.train import qat
  t_phase = time.perf_counter()
  x, y = (torch.from_numpy(a) for a in CifarLike(CifarLikeConfig(
      image_size=16)).sample(qat.RECIPE["batch"], split_seed=3))
  masked = cnn.ArchChoice(ACC_PARITY_MASKED)
  for kind in ("resnet20", "vgg"):
    if kind == "vgg":
      make = lambda d: cnn.init_vgg_supernet(0, device=d)
      fwd = lambda net, pe, z: net(z, masked, pe)
    else:
      make = lambda d: cnn.init_resnet(0, 20, width=8, device=d)
      fwd = lambda net, pe, z: net(z, pe)
    cpu, gpu = make("cpu"), make("cuda")
    for pe in PAPER_PE_TYPES:
      with torch.no_grad():
        want, got = fwd(cpu, pe, x), fwd(gpu, pe, x.cuda())
        b_logits, b_loss = ACC_BOUNDS[pe]
        noise = (0.0, 0.0)
        if pe != "FP32":
          for seed in range(3):
            moved = fwd(_jittered(cpu, seed), pe, x)
            noise = (max(noise[0], _rel(moved, want)),
                     max(noise[1], _rel(cnn.xent(moved, y),
                                        cnn.xent(want, y))))
        b_logits, b_loss = max(b_logits, 2 * noise[0]), max(b_loss,
                                                            2 * noise[1])
        e_logits = _rel(got, want)
        e_loss = _rel(cnn.xent(got, y.cuda()), cnn.xent(want, y))
      line = (f"[accuracy-parity] {kind} {pe}: logits {e_logits:.3g} "
              f"(bound {b_logits:.3g}), loss {e_loss:.3g} (bound "
              f"{b_loss:.3g})")
      if pe != "FP32":
        line += (f"; the CPU's own move under a one-ulp weight jitter: "
                 f"logits {noise[0]:.3g}, loss {noise[1]:.3g}")
      if pe == "FP32":
        _, gw = cnn.value_and_grad(cpu, lambda: cnn.xent(fwd(cpu, pe, x), y))
        xg, yg = x.cuda(), y.cuda()
        _, gg = cnn.value_and_grad(gpu, lambda: cnn.xent(fwd(gpu, pe, xg),
                                                         yg))
        skipped = sorted(n for n, w in gw.items() if w is None)
        if sorted(n for n, g in gg.items() if g is None) != skipped:
          raise AssertionError(f"[accuracy-parity] {kind}: the card and the "
                               "CPU skip other repeats")
        worst = max((_rel(gg[n], w), n) for n, w in gw.items()
                    if w is not None and w.abs().max() > 0)
        gt = _tf32_backward_grads(gpu, lambda: cnn.xent(fwd(gpu, pe, xg),
                                                        yg))
        control = max(_rel(gt[n], w) for n, w in gw.items()
                      if w is not None and w.abs().max() > 0)
        line += (f"; gradients per leaf worst {worst[0]:.3g} ({worst[1]}; "
                 f"bound {ACC_FP32_GRADS:g}), {len(skipped)} leaves of "
                 "skipped repeats without a gradient on both; the control, "
                 f"the backward with TF32 allowed: worst {control:.3g} "
                 "(must break the bound)")
        if not (worst[0] <= ACC_FP32_GRADS < control):
          raise AssertionError(line)
      log(line)
      if not (e_logits <= b_logits and e_loss <= b_loss):
        raise AssertionError(line)
  rng = np.random.RandomState(2)
  xl = torch.from_numpy(np.maximum(rng.normal(
      size=(qat.RECIPE["batch"], 16, 8, 8)), 0).astype(np.float32))
  wl = torch.from_numpy(rng.normal(0, 0.1, (32, 16, 3, 3)).astype(np.float32))
  dy = torch.from_numpy(rng.normal(size=(qat.RECIPE["batch"], 32, 4, 4))
                        .astype(np.float32))
  for pe in PAPER_PE_TYPES:
    errs = [_rel(g, w) for w, g in zip(_conv_layer(xl, wl, dy, pe, "cpu"),
                                       _conv_layer(xl, wl, dy, pe, "cuda"))]
    log(f"[accuracy-parity] one quantized 3x3 stride-2 conv, {pe}, from "
        f"identical inputs: output {errs[0]:.3g}, input gradient "
        f"{errs[1]:.3g}, weight gradient {errs[2]:.3g} (bound {ACC_LAYER:g})")
    if not max(errs) <= ACC_LAYER:
      raise AssertionError(f"[accuracy-parity] quantized conv {pe}: {errs}")
  net = cnn.init_resnet(0, 20, width=8, device="cpu")
  _, grads = cnn.value_and_grad(net, lambda: cnn.xent(net(x, "LightPE-2"), y))
  ocfg = qat.RECIPE_SGD
  res = []
  for dev in ("cpu", "cuda"):
    p = {n: v.detach().to(dev).clone() for n, v in net.named_parameters()}
    st = {"step": 79, "mom": {n: g.to(dev) * 0.5 for n, g in grads.items()}}
    opt.sgd_update(ocfg, p, {n: g.to(dev) for n, g in grads.items()}, st)
    res.append((p, st["mom"]))
  same = all(torch.equal(g[n].cpu(), w[n]) for w, g in zip(*res)
             for n in w)
  log(f"[accuracy-parity] one sgd_update (step 80, lr "
      f"{opt.sgd_lr_at(ocfg, 80)}), card vs CPU: parameters and momenta "
      f"{'bit-equal' if same else 'DIFFERENT'}")
  if not same:
    raise AssertionError("[accuracy-parity] sgd_update differs")
  for pe, bound in ACC_STEPS_BOUND.items():
    a = qat.train_qat("resnet20", pe, "cpu", steps=ACC_PARITY_STEPS)
    b = qat.train_qat("resnet20", pe, "cuda", steps=ACC_PARITY_STEPS)
    worst = max(abs(g - w) / abs(w) for g, w in zip(b["losses"], a["losses"]))
    log(f"[accuracy-parity] {ACC_PARITY_STEPS} QAT steps, resnet20 {pe}: "
        f"losses card vs CPU worst {worst:.3g} (bound {bound:g}); last "
        f"{b['losses'][-1]:.6f} vs {a['losses'][-1]:.6f}")
    if not worst <= bound:
      raise AssertionError(f"[accuracy-parity] QAT steps {pe}: {worst}")
  cfg = SupernetConfig(steps=ACC_PARITY_SUPERNET_STEPS)
  a = Supernet(cfg, device="cpu").train(log_every=0)
  b = Supernet(cfg).train(log_every=0)
  worst = max(abs(g - w) / abs(w) for g, w in zip(b, a))
  log(f"[accuracy-parity] Supernet.train(steps={cfg.steps}) at "
      f"{cfg.image_size} px, batch {cfg.batch}: losses card vs CPU worst "
      f"{worst:.3g} (bound {ACC_SUPERNET_BOUND:g}); "
      f"{time.perf_counter() - t_phase:.1f} s")
  if not worst <= ACC_SUPERNET_BOUND:
    raise AssertionError(f"[accuracy-parity] supernet: {worst}")


def phase_paper_figs(sess):
  """The paper's remaining figures through the port, beside the
  reference's CPU values: fig 5 (degree selection), figs 6-8 (the
  models' accuracy on held-out designs, evaluated on the card), fig 9
  and Table 3."""
  import numpy as np
  from repro_torch.core import oracle, ppa
  from repro_torch.core.dataflow import AcceleratorConfig
  from repro_torch.core.pe import PAPER_PE_TYPES
  from repro_torch.core.workloads import get_network
  from repro_torch.explore import DesignSpace, PolynomialBackend, summary_stats
  ref = PAPER_FIGS_REF_CPU
  t0 = time.perf_counter()
  cfgs = DesignSpace(pe_types=("INT16",)).sample_type("INT16", 400, seed=0)
  x, p, a = ppa.power_area_dataset(cfgs)
  best_p, scores_p = ppa.select_degree(x, p, degrees=range(1, 9))
  best_a, _ = ppa.select_degree(x, a, degrees=range(1, 9))
  log(f"[paper-figs] fig 5 ({time.perf_counter() - t0:.3f} s, host): best "
      f"power degree {best_p}, area {best_a} (reference "
      f"{ref['fig5']['best_power']}, {ref['fig5']['best_area']}; paper 5); "
      "power MAPE/RMSPE a degree: " + ", ".join(
          f"d{d} {scores_p[d][0]:.2f}/{scores_p[d][1]:.2f} (reference "
          f"{ref['fig5']['curve'][d][0]:.2f}/{ref['fig5']['curve'][d][1]:.2f})"
          for d in sorted(scores_p)))
  layers = get_network("resnet20")
  space = DesignSpace()
  for t in PAPER_PE_TYPES:
    t0 = time.perf_counter()
    models = PolynomialBackend.fit(pe_types=(t,), degree=5, n_train=240,
                                   layers=layers, seed=7).models[t]
    test = space.sample_type(t, 120, seed=991)
    xt, pt, at = ppa.power_area_dataset(test)
    p_hat = models.predict_power_mw(test, "cuda")
    a_hat = models.predict_area_mm2(test, "cuda")
    lat_hat = models.predict_network_latency_s(test, layers, "cuda")
    lat = np.asarray([oracle.characterize(c, layers).latency_s for c in test])
    got = (ppa.mape(pt, p_hat), ppa.mape(at, a_hat), ppa.mape(lat, lat_hat),
           ppa.r2(pt, p_hat),
           ppa.r2(np.log(lat), np.log(np.maximum(lat_hat, 1e-12))))
    r = ref["fig6_8"][t]
    log(f"[paper-figs] figs 6-8 {t} ({time.perf_counter() - t0:.3f} s; fit "
        f"on the host, 120 held-out designs predicted on the card): power "
        f"MAPE {got[0]:.2f}% ({r[0]:.2f}%), area {got[1]:.2f}% ({r[1]:.2f}%),"
        f" latency {got[2]:.2f}% ({r[2]:.2f}%), power R^2 {got[3]:.4f} "
        f"({r[3]:.4f}), latency R^2 {got[4]:.4f} ({r[4]:.4f}) (reference "
        "in parentheses)")
    if not all(np.isfinite(got)):
      raise AssertionError(f"[paper-figs] figs 6-8 {t}: not finite")
  t0 = time.perf_counter()
  for net in ("vgg16", "resnet20", "resnet56"):
    frame = sess.explore(get_network(net), net, n_per_type=150)
    ppa_n, en_n = frame.normalize(ref="best-int16")
    rows = []
    for t in PAPER_PE_TYPES:
      s1 = summary_stats(ppa_n[frame.by_type(t)])
      s2 = summary_stats(en_n[frame.by_type(t)])
      r = ref["fig9"][net][t]
      rows.append(f"{t} perf/area median {s1['median']:.2f} ({r[0]:.2f}) "
                  f"max {s1['max']:.2f} ({r[1]:.2f}), energy median "
                  f"{s2['median']:.3f} ({r[2]:.3f}) min {s2['min']:.3f} "
                  f"({r[3]:.3f})")
    log(f"[paper-figs] fig 9 {net}: " + "; ".join(rows))
  log(f"[paper-figs] fig 9 in {time.perf_counter() - t0:.3f} s (reference in "
      "parentheses)")
  clocks = {t: oracle.clock_mhz(AcceleratorConfig(pe_type=t))
            for t in PAPER_PE_TYPES}
  log("[paper-figs] Table 3 clocks: " + ", ".join(
      f"{t} {clocks[t]:.0f} MHz ({ref['table3'][t]})" for t in PAPER_PE_TYPES)
      + " (reference in parentheses; paper 275/285/455/435)")
  if {t: round(c) for t, c in clocks.items()} != ref["table3"]:
    raise AssertionError(f"[paper-figs] Table 3 differs: {clocks}")


# ---------------------------------------------------------------------------
# serving: K6, K5, the engine, and the card against the CPU
# ---------------------------------------------------------------------------

def _randn(rng, shape, dtype):
  import numpy as np
  import torch
  return torch.from_numpy(rng.standard_normal(shape).astype("float32")).to(
      device="cuda", dtype=dtype)


def _live_pairs(s: int, causal: bool, window: int) -> int:
  """(query, key) pairs the mask keeps: the work the data needs."""
  total = 0
  for i in range(s):
    lo = max(0, i - window + 1) if window else 0
    total += (i + 1 if causal else s) - lo
  return total


def _reference_bf16_rounding(q, k, v):
  """Causal attention rounded where the reference's model attention
  rounds in bf16 (``models/attention.py``): q is scaled in bf16 and p is
  cast to bf16 before an f32-accumulated PV.  The reference takes keys in
  chunks of 512, so for S <= 512 its online softmax is this plain one."""
  import torch
  s, h, d = q.shape[1], q.shape[2], q.shape[3]
  g = h // k.shape[2]
  qs = (q * (1.0 / d ** 0.5)).float().transpose(1, 2)      # (B, H, S, D)
  kf = k.repeat_interleave(g, dim=2).float().transpose(1, 2)
  vf = v.repeat_interleave(g, dim=2).float().transpose(1, 2)
  scores = qs @ kf.transpose(-1, -2)
  mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
  scores = torch.where(mask, scores, -1e30)
  p = torch.exp(scores - scores.amax(-1, keepdim=True))
  out = (p.to(torch.bfloat16).float() @ vf) / p.sum(-1, keepdim=True)
  return out.transpose(1, 2).to(torch.bfloat16)


def _k6_case(rng, b, s, h, hkv, d, dtype, causal, window, label="", sk=None,
             tag="K6"):
  """K6 on seeded q (B, S, H, D) and k, v (B, Sk, Hkv, D), Sk = ``sk`` or
  S (v a strided view, as the model passes it) against its plain version
  at 1e-4 of the largest |out|, timed as a graph replay beside the plain
  version and SDPA (not timed with a window), with its bound; logs its
  ``[tag]`` line.  Returns (q, k, v, K6's output, the record for the
  kernels line)."""
  import torch
  import torch.nn.functional as F
  from repro_torch.kernels.flash_attention import ops as fa
  sk = s if sk is None else sk
  q = _randn(rng, (b, s, h, d), dtype)
  kv = _randn(rng, (b, sk, 2, hkv, d), dtype)
  k, v = kv[:, :, 0], kv[:, :, 1]   # strided views, as the model passes v
  got = fa.flash_attention(q, k, v, causal=causal, window=window)
  want = fa.flash_attention_reference(q, k, v, causal=causal, window=window)
  torch.cuda.synchronize()
  err = float((got - want).abs().max())
  scale = float(want.abs().max())
  if not err <= 1e-4 * scale:
    raise AssertionError(f"K6 differs from its plain version at H={h} "
                         f"Hkv={hkv} S={s} Sk={sk}: {err} (max |out| "
                         f"{scale})")
  ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                          window=window))
  plain_ms = cuda_ms(lambda: fa.flash_attention_reference(
      q, k, v, causal=causal, window=window), inner=2)
  es = q.element_size()
  n_bytes = (b * s * h * d + 2 * b * sk * hkv * d) * es + b * s * h * d * 4
  pairs = _live_pairs(s, causal, window) if sk == s else s * sk
  n_ops = 4 * pairs * b * h * d
  peak = PEAK_BF16_PER_S if dtype == torch.bfloat16 else PEAK_FP32_PER_S
  b_ms, b_by = bound_ms(n_bytes, n_ops, peak)
  lib_ms = None
  if not window:
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
  mask = (f"window {window}" if window else
          "causal" if causal else "full")
  mask_tag = f"{str(dtype).split('.')[-1]} {mask}"
  log(f"[{tag}] B={b} S={s}{f' Sk={sk}' if sk != s else ''} H={h} "
      f"Hkv={hkv}{label} D={d} {mask_tag}: max_abs_err "
      f"{err:.3g} (max |out| {scale:.3g}, tolerance 1e-4 of it); kernel "
      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
      f"({b_by}: {n_bytes / 1e6:.2f} MB, {n_ops / 1e9:.3f} GFLOP), "
      f"library (scaled_dot_product_attention) "
      f"{'%.4f ms' % lib_ms if lib_ms is not None else 'not timed (window)'}")
  return q, k, v, got, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def _k5_case(q, caches, n, label=""):
  """K5 over ``caches[0]`` at fill ``n`` against its plain version at 1e-4
  of the largest |out|, both timed over every cache in turn (cold in L2),
  with its bound; logs its ``[K5]`` line and returns its record."""
  import torch
  from repro_torch.kernels.quant_decode_attn import ops as qda
  b, h, d = q.shape
  _, hkv, s, _ = caches[0][0].shape
  lens = torch.full((b,), n, dtype=torch.int32, device="cuda")
  got = qda.quant_decode_attn(q, *caches[0], lens)
  want = qda.quant_decode_attn_reference(q, *caches[0], lens)
  torch.cuda.synchronize()
  err = float((got - want).abs().max())
  scale = float(want.abs().max())
  if not err <= 1e-4 * scale:
    raise AssertionError(f"K5 differs from its plain version at H={h} "
                         f"Hkv={hkv}, length {n}: {err} (max |out| {scale})")
  ms = cuda_ms(lambda: [qda.quant_decode_attn(q, *c, lens)
                        for c in caches], inner=1) / len(caches)
  plain_ms = cuda_ms(lambda: [qda.quant_decode_attn_reference(q, *c, lens)
                              for c in caches], inner=1) / len(caches)
  n_bytes = (b * h * d * 2 + 2 * b * hkv * n * (d + 4) + b * 4
             + b * h * d * 4)
  n_ops = 4 * b * h * n * d + 2 * b * hkv * n * d
  b_ms, b_by = bound_ms(n_bytes, n_ops, PEAK_FP32_PER_S)
  log(f"[K5] B={b} H={h} Hkv={hkv}{label} S={s} D={d} bf16 q, length {n}: "
      f"max_abs_err {err:.3g} (max |out| {scale:.3g}, tolerance 1e-4 of "
      f"it); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (each over "
      f"{len(caches)} caches in turn: cold in L2), bound {b_ms:.3g} ms "
      f"({b_by}: {n_bytes / 1e6:.3f} MB)")
  return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
              bound_by=b_by)


def _k5_caches(rng, b, hkv, s, d, count):
  """``count`` int8 caches (B, Hkv, S, D) of seeded K and V."""
  import torch
  from repro_torch.kernels.quant_decode_attn import ops as qda
  return [qda.quantize_kv(_randn(rng, (b, hkv, s, d), torch.float32),
                          _randn(rng, (b, hkv, s, d), torch.float32))
          for _ in range(count)]


def phase_attention_kernels():
  """K6 and K5 vs their plain versions on the card, at serving shapes."""
  import numpy as np
  import torch
  results = {}
  b, s, h, hkv, d = K6_SHAPE
  rng = np.random.RandomState(6)
  # the serving case, f32, a window, and full (non-causal) attention, where
  # every block walks every key tile
  for dtype, causal, window in ((torch.bfloat16, True, 0),
                                (torch.float32, True, 0),
                                (torch.bfloat16, True, K6_WINDOW),
                                (torch.bfloat16, False, 0)):
    q, k, v, got, record = _k6_case(rng, b, s, h, hkv, d, dtype, causal,
                                    window)
    if dtype == torch.bfloat16 and causal and not window:
      model_out = got.to(torch.bfloat16).float()   # as the model casts it
      ref_out = _reference_bf16_rounding(q, k, v).float()
      gap = float((model_out - ref_out).abs().max() / ref_out.abs().max())
      log(f"[K6] bf16 gap: the model's K6 attention in bf16 vs the same "
          f"attention rounded where the reference rounds (q scaled in bf16, "
          f"p cast to bf16 before PV): max |diff| / max |out| = {gap:.3g} "
          f"(bf16 keeps 8 bits: 2^-8 = 3.9e-3; failing above 3e-2)")
      if not gap <= 3e-2:
        raise AssertionError(f"K6's bf16 gap to the reference's rounding is "
                             f"{gap}")
      results["flash_attention"] = dict(
          name="flash_attention (K6)", route="cuda",
          source="src/repro_torch/kernels/flash_attention/csrc/"
                 "flash_attention.cu",
          replaces="src/repro/kernels/flash_attention/kernel.py:78",
          on_main_path=True, **record, redesigned="PR 15")

  b, h, hkv, s, d = K5_SHAPE
  q = _randn(rng, (b, h, d), torch.bfloat16)
  # In a decode step each layer's cache was last read a whole step ago, with
  # the other layers' caches and 1.2 GB of weights read since: K5 finds it
  # cold.  So the timings cycle through enough caches to overflow the
  # 50 MB L2 and count one call on each.
  caches = _k5_caches(rng, b, hkv, s, d, K5_COLD_CACHES)
  for n in K5_LENGTHS:
    record = _k5_case(q, caches, n)
    if n == s:
      results["quant_decode_attn"] = dict(
          name="quant_decode_attn (K5)", route="cuda",
          source="src/repro_torch/kernels/quant_decode_attn/csrc/"
                 "quant_decode_attn.cu",
          replaces="src/repro/kernels/quant_decode_attn/kernel.py:68",
          on_main_path=True, **record, library_ms=None,
          library_note="no single PyTorch call attends over int8 codes "
                       "with per-position scales",
          redesigned="PR 15")
  log("[K5] library: none (no single PyTorch call attends over int8 codes "
      "with per-position scales)")
  return results


def phase_attention_zoo():
  """K6 and K5 at slice 8a's heads: K6 bf16 causal at (H, Hkv) = (48, 1),
  (24, 8) and (48, 8), S = 512; K5 at G = 3, 6 and 48 (48 query heads on
  one kv head, in sub-groups of 8 on the grid) over a 2,048-position cache
  at lengths 1, 300 and 2,048, cycling through caches of
  ``K5_COLD_BYTES`` in all.  Returns {"K6": {"H/Hkv": record}, "K5":
  {"G": record}} for the kernels line."""
  import numpy as np
  import torch
  rng = np.random.RandomState(8)
  out = {"K6": {}, "K5": {}}
  b, s, _, _, d = K6_SHAPE
  for h, hkv in K6_ZOO_HEADS:
    *_, record = _k6_case(rng, b, s, h, hkv, d, torch.bfloat16, True, 0,
                          f" (G = {h // hkv})")
    out["K6"][f"{h}/{hkv}"] = record
  b, _, _, s, d = K5_SHAPE
  for h, hkv in K5_ZOO_HEADS:
    q = _randn(rng, (b, h, d), torch.bfloat16)
    cache_bytes = 2 * b * hkv * s * (d + 4)
    caches = _k5_caches(rng, b, hkv, s, d, max(
        K5_COLD_CACHES, math.ceil(K5_COLD_BYTES / cache_bytes)))
    for n in K5_ZOO_LENGTHS:
      record = _k5_case(q, caches, n, f" (G = {h // hkv})")
      if n == s:
        out["K5"][str(h // hkv)] = record
    del caches
  return out


def _k7_counts(b, t, h, d, elem_bytes, with_s0):
  """Bytes K7 must move (each input read once, each output written once)
  and the operations the WKV6 recurrence needs, whatever form computes it:
  per head and token, r S (2 D^2), w * S + k^T v (3 D^2) and the bonus
  (r . u k) v added to the output (5 D).  The chunked form's pairwise
  decays and exps are extra work of that form, not of the function."""
  n_bytes = (b * t * h * d * (3 * elem_bytes + 4 + 4) + h * d * 4
             + b * h * d * d * 4 * (2 if with_s0 else 1))
  n_ops = b * h * t * (5 * d * d + 5 * d)
  return n_bytes, n_ops


def phase_wkv_kernel():
  """K7 vs its plain chunked version on the card, at the rwkv6-1.6b
  prefill shape (bf16 and float32), at a ragged T with a nonzero initial
  state and at a T whose chunks outnumber the cluster's blocks.  Both
  compute in float32 and differ in the order of the sums and in how the
  decays' exps are factored: held to 1e-4 of the largest |value|."""
  import numpy as np
  import torch
  from repro_torch import _build
  from repro_torch.kernels.rwkv6_scan import ops as wkv
  from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
  results = {}
  b, t_full, h, d, chunk = K7_SHAPE
  rng = np.random.RandomState(7)
  for dtype, t, with_s0 in ((torch.bfloat16, t_full, False),
                            (torch.float32, t_full, False),
                            (torch.bfloat16, K7_RAGGED_T, True),
                            (torch.bfloat16, K7_LONG_T, True)):
    def heads(x):  # the model's (B, T, H * D) projections as (B, H, T, D)
      return x.view(b, t, h, d).transpose(1, 2)
    r, k, v = (heads(_randn(rng, (b, t, h * d), dtype) * sc)
               for sc in (0.5, 0.5, 1.0))
    # -log w log-normal around 0.05: mostly slow decays, as the model's
    # (w0 = -6 at init gives w = 0.9975), down to fast ones
    w = heads(torch.exp(-torch.exp(
        2.0 * _randn(rng, (b, t, h * d), torch.float32) - 3.0)))
    u = _randn(rng, (h, d), torch.float32) * 0.3
    s0 = _randn(rng, (b, h, d, d), torch.float32) * 0.1 if with_s0 else None
    s0_plain = s0 if with_s0 else torch.zeros((b, h, d, d), device="cuda")
    got_o, got_s = wkv.wkv6(r, k, v, w, u, s0, chunk=chunk)
    want_o, want_s = wkv_ref.wkv6_chunked(r, k, v, w, u, s0_plain, chunk)
    torch.cuda.synchronize()
    errs = [float((g - want).abs().max()) for g, want in
            ((got_o, want_o), (got_s, want_s))]
    scales = [float(want_o.abs().max()), float(want_s.abs().max())]
    if not all(e <= 1e-4 * sc for e, sc in zip(errs, scales)):
      raise AssertionError(f"K7 differs from its plain version: out "
                           f"{errs[0]} (max {scales[0]}), state {errs[1]} "
                           f"(max {scales[1]})")
    ms = cuda_ms(lambda: wkv.wkv6(r, k, v, w, u, s0, chunk=chunk))
    plain_ms = cuda_ms(lambda: wkv_ref.wkv6_chunked(r, k, v, w, u, s0_plain,
                                                    chunk), inner=2)
    n_bytes, n_ops = _k7_counts(b, t, h, d, r.element_size(), with_s0)
    b_ms, b_by = bound_ms(n_bytes, n_ops, PEAK_FP32_PER_S)
    tag = (f"{str(dtype).split('.')[-1]} r/k/v, f32 w, "
           f"{'nonzero' if with_s0 else 'zero'} s0, {-(-t // chunk)} chunks "
           f"a head over a cluster of up to "
           f"{_build.csrc_constant('rwkv6_scan', 'kMaxBlocks')} blocks")
    log(f"[K7] B={b} T={t} H={h} D={d} chunk={chunk}, {tag}: max_abs_err "
        f"out {errs[0]:.3g} (max |out| {scales[0]:.3g}), final state "
        f"{errs[1]:.3g} (max |state| {scales[1]:.3g}), tolerance 1e-4 of "
        f"each; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB at 3.35 TB/s, "
        f"{n_ops / 1e9:.3f} GFLOP at 67 TFLOP/s f32)")
    if dtype == torch.bfloat16 and t == t_full:
      results["wkv6"] = dict(
          name="wkv6 (K7)", route="cuda",
          source="src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
          replaces="src/repro/kernels/rwkv6_scan/kernel.py:82",
          on_main_path=True, max_abs_err=max(errs), ms=ms,
          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
          library_note="no single PyTorch call computes the WKV6 "
                       "recurrence")
  log("[K7] library: none (no single PyTorch call computes the WKV6 "
      "recurrence)")
  return results


def serve_prompts(vocab: int):
  import numpy as np
  rng = np.random.RandomState(0)
  lengths = rng.randint(64, 513, size=SERVE_REQUESTS)
  return [rng.randint(0, vocab, size=n) for n in lengths]


def _timed(fn, rows):
  """``fn`` with its host time and CUDA-event time recorded per call.  It
  synchronizes after the call; the engine reads the logits right after
  every call anyway, so the sync adds no wait of its own."""
  import torch

  def call(*args):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn(*args)
    end.record()
    torch.cuda.synchronize()
    rows.append(((time.perf_counter() - t0) * 1e3, start.elapsed_time(end)))
    return out
  return call


def _launch_counters():
  """The serving kernels' launch-count modules, by kernel name."""
  from repro_torch.kernels.flash_attention import kernel as fa_kernel
  from repro_torch.kernels.quant_decode_attn import kernel as qda_kernel
  from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
  return {"flash_attention": fa_kernel, "quant_decode_attn": qda_kernel,
          "wkv6": wkv_kernel}


def serve_once(model, params, prompts):
  import torch
  from repro_torch.serve import EngineConfig, ServeEngine
  engine = ServeEngine(model, params, EngineConfig(**SERVE_ENGINE))
  pre, dec = [], []
  engine._prefill = _timed(engine._prefill, pre)
  engine._decode = _timed(engine._decode, dec)
  for p in prompts:
    engine.submit(p, max_new_tokens=SERVE_NEW_TOKENS)
  counters = _launch_counters()
  for mod in counters.values():
    mod.reset_launch_counts()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  out = engine.run_until_drained()
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = {name: mod.LAUNCHES[name] for name, mod in counters.items()}
  return out, wall, pre, dec, launches


def _describe(cfg) -> str:
  if cfg.family == "ssm":
    return (f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.n_heads} wkv heads x {cfg.head_dim}, d_ff {cfg.d_ff}, "
            f"vocab {cfg.vocab_size} (padded {cfg.padded_vocab}), "
            f"{cfg.dtype}, {cfg.norm}, chunk {cfg.ssm_chunk}")
  moe = (f", {cfg.n_experts} experts of {cfg.d_ff_expert} top-"
         f"{cfg.n_experts_active}"
         + (f" + {cfg.n_shared_experts} shared ({cfg.d_ff_shared})"
            if cfg.n_shared_experts else "")
         + f", groups of {cfg.moe_group_size}" if cfg.n_experts else "")
  return (f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads x {cfg.head_dim}, "
          f"vocab {cfg.vocab_size} (padded {cfg.padded_vocab}), {cfg.dtype}, "
          f"kv_quant {cfg.kv_quant}{moe}")


def phase_serve():
  """The main path of serving: full-width qwen3-0.6b, bf16, int8 KV cache,
  eight requests through ServeEngine, twice."""
  import dataclasses
  from repro_torch.configs import get_config
  cfg = dataclasses.replace(get_config("qwen3-0.6b"), kv_quant="int8")
  want = {"flash_attention": cfg.n_layers * SERVE_REQUESTS,
          "quant_decode_attn": (cfg.n_layers * SERVE_REQUESTS
                                * (SERVE_NEW_TOKENS - 1)),
          "wkv6": 0}
  return serve_twice("serve", cfg, want)


def phase_serve_rwkv():
  """Serving rwkv6-1.6b at full width, bf16: the same eight requests
  through ServeEngine, twice; every prefill layer runs K7."""
  from repro_torch.configs import get_config
  cfg = get_config("rwkv6-1.6b")
  want = {"flash_attention": 0, "quant_decode_attn": 0,
          "wkv6": cfg.n_layers * SERVE_REQUESTS}
  return serve_twice("serve-rwkv", cfg, want)


def phase_serve_moe():
  """Slice 8a's serving main path: full-width qwen2-moe-a2.7b
  (``SERVE_MOE_LAYERS`` of its 24 layers, 60 routed experts top-4 and 4
  shared), bf16, int8 KV cache, the eight requests through ServeEngine,
  twice; each 512-token prefill bucket is one MoE group, each decode step
  the dense path."""
  import dataclasses
  from repro_torch.configs import get_config
  cfg = dataclasses.replace(get_config(SERVE_MOE_ARCH), kv_quant="int8",
                            n_layers=SERVE_MOE_LAYERS)
  want = {"flash_attention": cfg.n_layers * SERVE_REQUESTS,
          "quant_decode_attn": (cfg.n_layers * SERVE_REQUESTS
                                * (SERVE_NEW_TOKENS - 1)),
          "wkv6": 0}
  return serve_twice("serve-moe", cfg, want)


def serve_twice(tag, cfg, want):
  """``cfg`` served at full width from seed-0 weights: the eight requests
  through ServeEngine twice, each run's kernel launches held to ``want``
  and the rerun's tokens to the first run's.  Returns the first run's
  launches of the kernels this model runs."""
  import torch
  from repro_torch.models import build_model
  model = build_model(cfg)
  t0 = time.perf_counter()
  params = model.init(0)
  torch.cuda.synchronize()
  n_params = sum(p.numel() for p in params.parameters())
  log(f"[{tag}] {cfg.name}: {_describe(cfg)}; {n_params:,} parameters "
      f"initialised from seed 0 on the card in "
      f"{time.perf_counter() - t0:.2f} s")
  prompts = serve_prompts(cfg.vocab_size)
  log(f"[{tag}] {len(prompts)} requests, prompt lengths "
      f"{[len(p) for p in prompts]}, {SERVE_NEW_TOKENS} new tokens each, "
      f"engine {SERVE_ENGINE}")
  runs = []
  for run in (1, 2):
    torch.cuda.reset_peak_memory_stats()
    out, wall, pre, dec, launches = serve_once(model, params, prompts)
    runs.append(out)
    n_tokens = sum(len(t) for t in out.values())
    log(f"[{tag}] run {run}: {n_tokens} tokens in {wall:.3f} s = "
        f"{n_tokens / wall:.2f} tokens/s; prefill per request: host "
        f"{statistics.median(r[0] for r in pre):.3f} ms, events "
        f"{statistics.median(r[1] for r in pre):.3f} ms (medians of "
        f"{len(pre)}); decode per token: host "
        f"{statistics.median(r[0] for r in dec):.3f} ms, events "
        f"{statistics.median(r[1] for r in dec):.3f} ms (medians of "
        f"{len(dec)}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}")
    if launches != want:
      raise AssertionError(f"expected launches {want}, got {launches}")
    if sorted(out) != list(range(1, SERVE_REQUESTS + 1)) or any(
        len(t) != SERVE_NEW_TOKENS or not all(0 <= x < cfg.vocab_size
                                               for x in t)
        for t in out.values()):
      raise AssertionError(f"bad generations: {out}")
    if run == 1:
      main_launches = {k: n for k, n in launches.items() if want[k]}
  if runs[0] != runs[1]:
    raise AssertionError("a second run gave other tokens")
  log(f"[{tag}] the second run gave the same {SERVE_REQUESTS} x "
      f"{SERVE_NEW_TOKENS} tokens; first tokens: "
      f"{[runs[0][u][:4] for u in sorted(runs[0])][:3]}")
  phase_decode_graph(tag, model, params, prompts[0],
                     statistics.median(r[1] for r in dec))
  return main_launches


PROFILE_GROUPS = (("K5", ("qda_kernel",)),
                  ("K6", ("flash_bf16_kernel", "flash_f32_kernel")),
                  ("K6-bwd", ("bwd_delta_kernel", "bwd_dkdv_bf16_kernel",
                              "bwd_dq_bf16_kernel", "bwd_dkdv_f32_kernel",
                              "bwd_dq_f32_kernel")),
                  ("K7-bwd", ("wkv6_bwd",)),
                  ("K7", ("wkv6",)),
                  ("matmul", ("gemm", "gemv", "cutlass", "xmma", "cublas",
                              "nvjet")))
PROFILE_TOP = 8   # kernels listed by name, the most device time first
# spin kernels that open every profile window, left out of its sums
# (_device_profile).  On an H100 one whole run saw the profiler lose 21 to
# 62 of 128, more the later the profile, and another all of 256 at an
# [accuracy-profile] window; with 1,024 three whole runs measured every
# profile
PROFILE_LEAD = 1024


def _device_profile(tag, name, fn, by_group=None):
  """Device work of one ``fn()`` call by kernel group, from
  ``torch.profiler``: operation count and summed device time per group,
  also left in ``by_group`` (ms) when given.  Prints "not measured" when
  the profiler records no device time.

  Late in a long process the profiler loses the first device events of a
  session (a fresh process keeps them): a standalone backward call, two
  or three kernels, printed "not measured" there, and a full-width rwkv6
  step lost its first K7.  So ``PROFILE_LEAD`` spin kernels open the
  window and take the loss, and the count of them recorded says how many
  were lost.  The loss is a prefix of the session, so while one spin
  kernel is recorded every event of ``fn`` is; if none is, ``fn``'s
  events may be incomplete, and this prints "not measured" with the
  reason."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    for _ in range(PROFILE_LEAD):
      torch.cuda._sleep(1)
    fn()
    torch.cuda.synchronize()
  groups, kernels, spins = {}, [], 0
  for e in prof.key_averages():
    if e.device_type != torch.autograd.DeviceType.CUDA:
      continue
    if "spin_kernel" in e.key:
      spins += e.count
      continue
    if e.self_device_time_total <= 0:
      continue
    key = next((g for g, words in PROFILE_GROUPS
                if any(w in e.key.lower() for w in words)), "other")
    n, us = groups.get(key, (0, 0.0))
    groups[key] = (n + e.count, us + e.self_device_time_total)
    kernels.append((e.self_device_time_total, e.count, e.key))
  lost = (f" (the profiler lost {PROFILE_LEAD - spins} of the "
          f"{PROFILE_LEAD} lead kernels)" if spins < PROFILE_LEAD else "")
  if not groups or spins == 0:
    why = ("recorded no device time" if not groups else
           f"lost all {PROFILE_LEAD} lead kernels, so maybe some of the "
           "call's")
    log(f"[{tag}-profile] {name}: not measured (the profiler {why})")
    return
  total_n = sum(n for n, _ in groups.values())
  total_us = sum(us for _, us in groups.values())
  if by_group is not None:
    by_group.update({g: us / 1e3 for g, (_, us) in groups.items()})
  parts = "; ".join(f"{g} {n} ops {us / 1e3:.3f} ms ({us / total_us:.1%})"
                    for g, (n, us) in sorted(groups.items(),
                                             key=lambda kv: -kv[1][1]))
  log(f"[{tag}-profile] {name}: {total_n} device operations, "
      f"{total_us / 1e3:.3f} ms of device time: {parts}{lost}")
  for us, n, key in sorted(kernels, reverse=True)[:PROFILE_TOP]:
    log(f"[{tag}-profile]   {us / 1e3:.3f} ms in {n} x {key[:90]}")
  return total_us / 1e3


def phase_decode_graph(tag, model, params, prompt, eager_ms):
  """One decode step captured as a CUDA graph: its replay time is the
  step's device time without launch gaps, so replay / eager is the share
  of an eager step the card is busy."""
  import numpy as np
  import torch
  bucket = SERVE_ENGINE["prompt_bucket"]
  toks = np.concatenate([np.full(bucket - len(prompt), prompt[0]), prompt])
  toks = torch.from_numpy(toks[None].astype(np.int32)).cuda()
  _, cache = model.prefill(params, toks, SERVE_ENGINE["max_len"])
  tok = torch.zeros(1, dtype=torch.int32, device="cuda")

  def one_step():  # an attention step rewrites one slot, reads 513 positions
    cache["length"] = bucket
    return model.decode_step(params, tok, cache)[0]
  graph, logits = capture(one_step)
  graph_ms = replay_ms(graph, samples=10)
  # the step updates the cache in place (an rwkv state advances), so the
  # eager step and the replay it is held to start from one saved cache
  state = [t for layer in cache["layers"] for t in layer.values()]
  saved = [t.clone() for t in state]
  cache["length"] = bucket
  eager, _ = model.decode_step(params, tok, cache)
  with torch.inference_mode():  # the cache's tensors are inference tensors
    for t, s in zip(state, saved):
      t.copy_(s)
  graph.replay()
  torch.cuda.synchronize()
  diff = float((logits.float() - eager.float()).abs().max()
               / eager.float().abs().max())
  if diff > 1e-2:
    raise AssertionError(f"the captured decode step gives other logits: "
                         f"{diff}")
  log(f"[{tag}-breakdown] one decode step at length {bucket} as a CUDA graph "
      f"replay (logits within {diff:.3g} of the eager step's, relative): "
      f"{graph_ms:.3f} ms on the card; eager median {eager_ms:.3f} "
      f"ms between events, so the card is busy {graph_ms / eager_ms:.1%} of "
      "an eager step (the rest is launch overhead)")
  _device_profile(tag, f"one eager decode step at length {bucket}", one_step)
  _device_profile(tag, f"one {bucket}-token prefill",
                  lambda: model.prefill(params, toks, SERVE_ENGINE["max_len"]))


def phase_serve_parity():
  """Full-width qwen3-0.6b in float32, depth cut to two layers, int8 KV:
  the card against the CPU on the same weights, TF32 off.  Logits within
  1e-3 of the largest |logit|: a K or V value within an ulp of an int8
  rounding boundary can take the next code on the other device."""
  import dataclasses
  from repro_torch.configs import get_config
  cfg = dataclasses.replace(get_config("qwen3-0.6b"), kv_quant="int8",
                            dtype="float32", n_layers=PARITY_LAYERS)
  return serve_parity("serve-parity", cfg, "int8 KV", 1e-3)


def phase_serve_rwkv_parity():
  """Full-width rwkv6-1.6b in float32, depth cut to two layers: the card
  (K7) against the CPU (the plain chunked form) on the same weights, TF32
  off.  Logits within 1e-4 of the largest |logit|: no rounding boundary
  here, only other summation orders."""
  import dataclasses
  from repro_torch.configs import get_config
  cfg = dataclasses.replace(get_config("rwkv6-1.6b"), dtype="float32",
                            n_layers=PARITY_LAYERS)
  return serve_parity("serve-rwkv-parity", cfg, "K7 prefill", 1e-4)


@contextlib.contextmanager
def _recording_routing(calls):
  """Each MoE routing of the block inside, appended to ``calls``: its
  top-k experts, its dispatch slots and the least gap between a token's
  k-th and (k+1)-th router probability (how close a flip of its experts
  was); nothing when ``calls`` is None."""
  import torch
  from repro_torch.models import ffn
  if calls is None:
    yield
    return
  real_route, real_dc = ffn.route_topk, ffn._dispatch_combine

  def route(logits, k):
    gates, idx = real_route(logits, k)
    probs = torch.sort(torch.softmax(logits.float(), dim=-1), dim=-1,
                       descending=True).values
    calls.append({"idx": idx.cpu(), "gap": float(
        (probs[..., k - 1] - probs[..., k]).min())})
    return gates, idx

  def dispatch_combine(gates, idx, e, cap):
    out = real_dc(gates, idx, e, cap)
    calls[-1]["dispatch"] = out[0].cpu()
    return out
  ffn.route_topk, ffn._dispatch_combine = route, dispatch_combine
  try:
    yield
  finally:
    ffn.route_topk, ffn._dispatch_combine = real_route, real_dc


def serve_parity(tag, cfg, what, tol, routing=False, width="at full width"):
  """``cfg`` from seed-0 weights on the card and the same weights on the
  CPU, TF32 off: a bucketed prompt's prefill and 4 greedy decode steps
  (logits within ``tol`` of the largest |logit|, the same argmax), then
  the engine's greedy tokens for 2 requests x 8.  With ``routing`` the
  prefill's MoE routings (top-k experts, kept capacity slots) are held
  equal too, layer by layer; a mamba layer's cache (the state ``h`` and
  the conv window) is held within 1e-4 of its largest |value| after the
  prefill and after the decode steps."""
  import numpy as np
  import torch
  from repro_torch.models import build_model
  from repro_torch.models.transformer import layer_pattern
  from repro_torch.serve import EngineConfig, ServeEngine
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  gpu_model, cpu_model = build_model(cfg), build_model(cfg, device="cpu")
  gpu_params = gpu_model.init(0)
  cpu_params = cpu_model.from_state(
      {k: v.cpu() for k, v in gpu_params.state_dict().items()})
  prompts = serve_prompts(cfg.vocab_size)
  bucket = SERVE_ENGINE["prompt_bucket"]
  p = prompts[0]
  toks = torch.from_numpy(np.concatenate(
      [np.full(bucket - len(p), p[0]), p])[None].astype(np.int32))
  errs = []
  cpu_routes, gpu_routes = ([], []) if routing else (None, None)
  with _recording_routing(cpu_routes):
    want, cpu_cache = cpu_model.prefill(cpu_params, toks,
                                        SERVE_ENGINE["max_len"])
  with _recording_routing(gpu_routes):
    got, gpu_cache = gpu_model.prefill(gpu_params, toks.cuda(),
                                       SERVE_ENGINE["max_len"])
  if routing:
    same_idx = [torch.equal(a["idx"], c["idx"])
                for a, c in zip(gpu_routes, cpu_routes)]
    same_slots = [torch.equal(a["dispatch"], c["dispatch"])
                  for a, c in zip(gpu_routes, cpu_routes)]
    kept = [int(c["dispatch"].sum()) for c in cpu_routes]
    log(f"[{tag}] {cfg.name} prefill routing, {len(cpu_routes)} MoE "
        f"layers of {bucket} tokens, top-{cfg.n_experts_active} of "
        f"{cfg.n_experts}: "
        f"top-k experts card vs CPU equal {same_idx}, kept capacity slots "
        f"equal {same_slots} ({kept} of "
        f"{bucket * cfg.n_experts_active} token-expert pairs kept a layer); "
        f"the least gap between a token's k-th and (k+1)-th router "
        f"probability {['%.3g' % c['gap'] for c in cpu_routes]} (CPU)")
    n_moe = sum(is_moe for _, is_moe in layer_pattern(cfg))
    if len(cpu_routes) != n_moe or not (all(same_idx) and all(same_slots)):
      raise AssertionError("the card and the CPU route the MoE differently")
  errs.append(float((got.cpu() - want).abs().max() / want.abs().max()))
  same = [int(got.argmax()) == int(want.argmax())]

  def mamba_gaps():
    """Each mamba cache leaf's max |diff| / max |value|, card vs CPU."""
    return {key: max(float((g[key].cpu() - c[key]).abs().max()
                           / c[key].abs().max())
                     for g, c in zip(gpu_cache["layers"], cpu_cache["layers"])
                     if "conv" in c)
            for key in ("h", "conv")}
  has_mamba = any(kind == "mamba" for kind, _ in layer_pattern(cfg))
  gaps = [mamba_gaps()] if has_mamba else []
  for _ in range(4):
    nxt = want.argmax(-1).to(torch.int32)
    want, _ = cpu_model.decode_step(cpu_params, nxt, cpu_cache)
    got, _ = gpu_model.decode_step(gpu_params, nxt.cuda(), gpu_cache)
    errs.append(float((got.cpu() - want).abs().max() / want.abs().max()))
    same.append(int(got.argmax()) == int(want.argmax()))
  if has_mamba:
    gaps.append(mamba_gaps())
    n_mamba = sum(kind == "mamba" for kind, _ in layer_pattern(cfg))
    log(f"[{tag}] {cfg.name} mamba caches card vs CPU, max |diff| / max "
        f"|value| over the {n_mamba} mamba layers, after the prefill and "
        f"after 4 decode steps: "
        f"{[{k: f'{v:.3g}' for k, v in g.items()} for g in gaps]} "
        "(tolerance 1e-4)")
    if max(v for g in gaps for v in g.values()) > 1e-4:
      raise AssertionError("the card's and the CPU's mamba caches differ")
  runs = {}
  for device, model, params in (("cuda", gpu_model, gpu_params),
                                ("cpu", cpu_model, cpu_params)):
    engine = ServeEngine(model, params, EngineConfig(**SERVE_ENGINE),
                         device=device)
    for q in prompts[:2]:
      engine.submit(q, max_new_tokens=8)
    runs[device] = engine.run_until_drained()
  log(f"[{tag}] {cfg.name} {width}, float32, {cfg.n_layers} "
      f"layers, {what}, TF32 off: card vs CPU logits, prefill then 4 decode "
      f"steps, max |diff| / max |logit| = {[f'{e:.3g}' for e in errs]} "
      f"(tolerance {tol:g}); greedy tokens equal {same}; engine, 2 requests "
      f"x 8 tokens: {'equal' if runs['cuda'] == runs['cpu'] else 'DIFFERENT'}")
  if max(errs) > tol or not all(same) or runs["cuda"] != runs["cpu"]:
    raise AssertionError("the card and the CPU disagree on serving")
  return max(errs)


def phase_serve_moe_parity():
  """Full-width qwen2-moe-a2.7b in float32, 2 layers, int8 KV: the card
  against the CPU on the same weights, TF32 off, at the int8-KV bound
  (1e-3 of the largest |logit|); the prefill's top-k experts and kept
  capacity slots equal."""
  import dataclasses
  from repro_torch.configs import get_config
  cfg = dataclasses.replace(get_config(SERVE_MOE_ARCH), kv_quant="int8",
                            dtype="float32", n_layers=PARITY_LAYERS)
  return serve_parity("serve-moe-parity", cfg, "int8 KV, MoE", 1e-3,
                      routing=True)


def phase_serve_zoo():
  """Slice 8a's dense archs and mixtral at full width, bf16, int8 KV: two
  requests of [serve]'s traffic, 8 new tokens each, through ServeEngine,
  once an arch, with the depth cut of ``SERVE_ZOO``; K5 runs at each
  arch's own G (3, 4, 6, 48) and K6 at its heads."""
  import dataclasses
  import gc
  import torch
  from repro_torch.configs import get_config
  from repro_torch.models import build_model
  from repro_torch.serve import EngineConfig, ServeEngine
  counters = _launch_counters()
  for arch, depth in SERVE_ZOO:
    full = get_config(arch)
    cfg = dataclasses.replace(full, kv_quant="int8",
                              n_layers=depth or full.n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    engine = ServeEngine(model, params, EngineConfig(**SERVE_ENGINE))
    prompts = serve_prompts(cfg.vocab_size)[:SERVE_ZOO_REQUESTS]
    for p in prompts:
      engine.submit(p, max_new_tokens=SERVE_ZOO_NEW_TOKENS)
    for mod in counters.values():
      mod.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.LAUNCHES[name] for name, mod in counters.items()}
    want = {"flash_attention": cfg.n_layers * len(prompts),
            "quant_decode_attn": (cfg.n_layers * len(prompts)
                                  * (SERVE_ZOO_NEW_TOKENS - 1)),
            "wkv6": 0}
    n_tokens = sum(len(t) for t in out.values())
    log(f"[serve-zoo] {arch}: {_describe(cfg)}, {cfg.mlp_variant}, "
        f"{cfg.norm}, {cfg.pos_embed} positions"
        + (f", window {cfg.sliding_window}" if cfg.sliding_window else "")
        + f"; depth {cfg.n_layers} of {full.n_layers} layers"
        + (" (cut)" if depth else " (full)")
        + f"; {n_params:,} parameters from seed 0 in {t_init:.2f} s; "
        f"{len(prompts)} requests (prompts {[len(p) for p in prompts]}) x "
        f"{SERVE_ZOO_NEW_TOKENS} tokens: {n_tokens} tokens in {wall:.3f} s = "
        f"{n_tokens / wall:.2f} tokens/s; K6 launches "
        f"{launches['flash_attention']}, K5 launches "
        f"{launches['quant_decode_attn']} (G = "
        f"{cfg.n_heads // cfg.n_kv_heads}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; first tokens "
        f"{[out[u][:4] for u in sorted(out)]}")
    if launches != want:
      raise AssertionError(f"{arch}: expected launches {want}, got "
                           f"{launches}")
    if sorted(out) != list(range(1, len(prompts) + 1)) or any(
        len(t) != SERVE_ZOO_NEW_TOKENS or not all(0 <= x < cfg.vocab_size
                                                  for x in t)
        for t in out.values()):
      raise AssertionError(f"{arch}: bad generations: {out}")
    del engine, params, model
    gc.collect()
    torch.cuda.empty_cache()


def zoo_parity_config(arch):
  """``arch`` in float32 at 2 layers and ``ZOO_PARITY_WIDTH``'s width,
  its own heads and head dim, at most 8 experts, mixtral's window cut to
  ``ZOO_PARITY_WINDOW``, int8 KV."""
  import dataclasses
  from repro_torch.configs import get_config
  cfg = get_config(arch)
  changes = dict(ZOO_PARITY_WIDTH, dtype="float32", kv_quant="int8",
                 n_layers=PARITY_LAYERS)
  if cfg.n_experts:
    changes.update(n_experts=min(cfg.n_experts,
                                 ZOO_PARITY_EXPERTS["max_experts"]),
                   d_ff_expert=ZOO_PARITY_EXPERTS["d_ff_expert"])
    if cfg.n_shared_experts:
      changes["d_ff_shared"] = ZOO_PARITY_EXPERTS["d_ff_shared"]
  if cfg.sliding_window:
    changes["sliding_window"] = ZOO_PARITY_WINDOW
  return dataclasses.replace(cfg, **changes)


def phase_serve_zoo_parity():
  """Each of slice 8a's six archs, card against CPU (``serve_parity``) at
  ``zoo_parity_config``'s size: greedy tokens equal, logits within the
  int8-KV bound; mixtral's 32-position ring wraps in prefill and decode."""
  errs = {}
  for arch in ZOO_ARCHS:
    cfg = zoo_parity_config(arch)
    errs[arch] = serve_parity(
        "serve-zoo-parity", cfg,
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads x {cfg.head_dim}"
        + (f", {cfg.n_experts} experts of {cfg.d_ff_expert}"
           if cfg.n_experts else "")
        + (f", window {cfg.sliding_window} (the ring wraps)"
           if cfg.sliding_window else "") + ", int8 KV", 1e-3,
        routing=bool(cfg.n_experts),
        width=f"narrowed to d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}")
  return errs


def phase_k6_cross():
  """K6 at S_q != S_k, whisper-base's cross-attention (``K6_CROSS``,
  non-causal, bf16 and f32): S_q in ``K6_CROSS_SQ`` against 1,500 keys,
  and S_q = S_k = 1,500 (the encoder's self-attention), each held against
  the plain version and timed beside it and SDPA.  Returns {"S_q x S_k
  dtype": record} for the kernels line."""
  import numpy as np
  import torch
  rng = np.random.RandomState(81)
  c = K6_CROSS
  out = {}
  for dtype in (torch.bfloat16, torch.float32):
    for sq in K6_CROSS_SQ:
      *_, record = _k6_case(rng, c["b"], sq, c["h"], c["hkv"], c["d"], dtype,
                            False, 0, sk=c["sk"], tag="K6-cross")
      out[f"{sq}x{c['sk']} {str(dtype).split('.')[-1]}"] = record
  return out


def phase_serve_whisper(smi):
  """Full-width, full-depth whisper-base (6 encoder and 6 decoder layers,
  d_model 512, 8 heads, vocab 51,865; bf16, int8 self-attention KV) from
  seed-0 weights: 4 requests of seeded ``enc_frames`` (4, 1,500, 512) and
  16-token prompts through ``Model.prefill`` and 32 ``decode_step``s,
  twice, the tokens equal; K6 launches a prefill (the encoder's, the
  decoder's self- and cross-attention) and K5 launches a decode step
  held to their counts.  Returns the first run's launches as the counters
  read them (the prefill's and the decode steps' summed)."""
  import dataclasses
  import numpy as np
  import torch
  from repro_torch.configs import get_config
  from repro_torch.models import build_model
  w = WHISPER_SERVE
  cfg = dataclasses.replace(get_config("whisper-base"), kv_quant="int8")
  model = build_model(cfg)
  t0 = time.perf_counter()
  params = model.init(0)
  torch.cuda.synchronize()
  n_params = sum(p.numel() for p in params.parameters())
  log(f"[serve-whisper] {cfg.name}: {cfg.n_encoder_layers} encoder layers "
      f"over {cfg.encoder_seq} frames; decoder {_describe(cfg)}; "
      f"{cfg.mlp_variant}, {cfg.norm}; {n_params:,} parameters from seed 0 in "
      f"{time.perf_counter() - t0:.2f} s ({smi})")
  rng = np.random.RandomState(w["seed"])
  frames = torch.from_numpy(rng.standard_normal(
      (w["batch"], cfg.encoder_seq, cfg.d_model)).astype(np.float32)).cuda()
  prompt = torch.from_numpy(rng.randint(
      0, cfg.vocab_size, (w["batch"], w["prompt"])).astype(np.int32)).cuda()
  batch = {"tokens": prompt, "enc_frames": frames}
  counters = _launch_counters()
  per_prefill = {"flash_attention": cfg.n_encoder_layers + 2 * cfg.n_layers,
                 "quant_decode_attn": 0, "wkv6": 0}
  per_step = {"flash_attention": 0, "quant_decode_attn": cfg.n_layers,
              "wkv6": 0}
  runs = []
  for run in (1, 2):
    torch.cuda.reset_peak_memory_stats()
    pre, dec = [], []
    prefill = _timed(model.prefill, pre)
    step = _timed(model.decode_step, dec)
    for mod in counters.values():
      mod.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch, w["max_len"])
    launches = {name: mod.LAUNCHES[name] for name, mod in counters.items()}
    if launches != per_prefill:
      raise AssertionError(f"[serve-whisper] prefill launched {launches}, "
                           f"expected {per_prefill}")
    total = dict(launches)
    toks = [logits.argmax(-1)]
    for i in range(w["steps"]):
      for mod in counters.values():
        mod.reset_launch_counts()
      logits, cache = step(params, toks[-1].to(torch.int32), cache)
      got = {name: mod.LAUNCHES[name] for name, mod in counters.items()}
      if got != per_step:
        raise AssertionError(f"[serve-whisper] decode step {i} launched "
                             f"{got}, expected {per_step}")
      total = {k: total[k] + got[k] for k in total}
      toks.append(logits.argmax(-1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = torch.stack(toks, 1).cpu()
    if not bool(torch.isfinite(logits).all()) or out.shape != (
        w["batch"], w["steps"] + 1) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
      raise AssertionError(f"[serve-whisper] bad generations: {out}")
    runs.append(out)
    if run == 1:
      first = total
    n_tokens = out.numel()
    log(f"[serve-whisper] run {run}: {w['batch']} requests, enc_frames "
        f"{tuple(frames.shape)}, {w['prompt']}-token prompts, {n_tokens} "
        f"tokens (the prefill's and {w['steps']} decode steps') in "
        f"{wall:.3f} s = {n_tokens / wall:.2f} tokens/s; prefill host "
        f"{pre[0][0]:.3f} ms, events {pre[0][1]:.3f} ms; decode step host "
        f"{statistics.median(r[0] for r in dec):.3f} ms, events "
        f"{statistics.median(r[1] for r in dec):.3f} ms (medians of "
        f"{len(dec)}); launches a prefill {per_prefill['flash_attention']} "
        f"K6 ({cfg.n_encoder_layers} encoder, {cfg.n_layers} decoder self, "
        f"{cfg.n_layers} cross), a decode step {per_step['quant_decode_attn']}"
        f" K5 (cross-attention: the plain decode path); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
  if not torch.equal(runs[0], runs[1]):
    raise AssertionError("[serve-whisper] a second run gave other tokens")
  log(f"[serve-whisper] the second run gave the same {runs[0].numel()} "
      f"tokens; first tokens {runs[0][:, :4].tolist()}")
  return {k: first[k] for k in ("flash_attention", "quant_decode_attn")}


def phase_serve_whisper_parity():
  """whisper-base in float32 at 2 encoder and 2 decoder layers, its own
  width, int8 self-attention KV: the card against the CPU on the same
  seed-0 weights and inputs, TF32 off: prefill and 4 greedy decode
  steps' logits within 1e-3 of the largest |logit| (the int8-KV bound),
  greedy tokens equal, and the cross K/V the prefill keeps within 1e-4."""
  import dataclasses
  import numpy as np
  import torch
  from repro_torch.configs import get_config
  from repro_torch.models import build_model
  torch.backends.cuda.matmul.allow_tf32 = False
  w = WHISPER_SERVE
  cfg = dataclasses.replace(get_config("whisper-base"), kv_quant="int8",
                            dtype="float32", n_layers=PARITY_LAYERS,
                            n_encoder_layers=PARITY_LAYERS)
  gpu_model, cpu_model = build_model(cfg), build_model(cfg, device="cpu")
  gpu_params = gpu_model.init(0)
  cpu_params = cpu_model.from_state(
      {k: v.cpu() for k, v in gpu_params.state_dict().items()})
  rng = np.random.RandomState(w["seed"])
  batch = {"enc_frames": torch.from_numpy(rng.standard_normal(
               (w["batch"], cfg.encoder_seq, cfg.d_model)).astype(np.float32)),
           "tokens": torch.from_numpy(rng.randint(
               0, cfg.vocab_size, (w["batch"], w["prompt"])).astype(np.int32))}
  want, cpu_cache = cpu_model.prefill(cpu_params, batch, w["max_len"])
  got, gpu_cache = gpu_model.prefill(
      gpu_params, {k: v.cuda() for k, v in batch.items()}, w["max_len"])
  errs = [float((got.cpu() - want).abs().max() / want.abs().max())]
  same = [torch.equal(got.argmax(-1).cpu(), want.argmax(-1))]
  cross = max(float((g[key].cpu() - c[key]).abs().max() / c[key].abs().max())
              for g, c in zip(gpu_cache["layers"], cpu_cache["layers"])
              for key in ("cross_k", "cross_v"))
  for _ in range(4):
    nxt = want.argmax(-1).to(torch.int32)
    want, _ = cpu_model.decode_step(cpu_params, nxt, cpu_cache)
    got, _ = gpu_model.decode_step(gpu_params, nxt.cuda(), gpu_cache)
    errs.append(float((got.cpu() - want).abs().max() / want.abs().max()))
    same.append(torch.equal(got.argmax(-1).cpu(), want.argmax(-1)))
  log(f"[serve-whisper-parity] {cfg.name} at full width, float32, "
      f"{cfg.n_encoder_layers} + {cfg.n_layers} layers, int8 KV, TF32 off, "
      f"{w['batch']} requests: card vs CPU logits, prefill then 4 decode "
      f"steps, max |diff| / max |logit| = {[f'{e:.3g}' for e in errs]} "
      f"(tolerance 1e-3); greedy tokens equal {same}; the cross K/V max "
      f"|diff| / max |value| {cross:.3g} (tolerance 1e-4)")
  if max(errs) > 1e-3 or not all(same) or cross > 1e-4:
    raise AssertionError("the card and the CPU disagree on whisper-base")
  return max(errs)


def phase_serve_jamba(smi):
  """jamba-1.5-large at every published width (d_model 8,192, 64 heads and
  8 kv heads of 128, d_inner 16,384, d_state 16, d_conv 4, d_ff and
  d_ff_expert 24,576, vocab 65,536, top-2) cut to ``JAMBA_CUT``: bf16,
  int8 KV, seed-0 weights, ``JAMBA_REQUESTS`` requests through
  ServeEngine twice, the tokens equal, each run's K6 and K5 launches held
  to their counts.  Returns the first run's launches as the counters read
  them."""
  import dataclasses
  import gc
  import torch
  from repro_torch.configs import get_config
  from repro_torch.models import build_model
  from repro_torch.models.transformer import layer_pattern
  from repro_torch.serve import EngineConfig, ServeEngine
  full = get_config("jamba-1.5-large")
  cfg = dataclasses.replace(full, kv_quant="int8", **JAMBA_CUT)
  torch.cuda.reset_peak_memory_stats()
  model = build_model(cfg)
  t0 = time.perf_counter()
  params = model.init(0)
  torch.cuda.synchronize()
  n_params = sum(p.numel() for p in params.parameters())
  kinds = [f"{kind}{'+moe' if moe else ''}" for kind, moe in
           layer_pattern(cfg)]
  log(f"[serve-jamba] {cfg.name}: {_describe(cfg)}, d_inner {cfg.d_inner}, "
      f"d_state {cfg.mamba_d_state}, d_conv {cfg.mamba_d_conv}, d_ff "
      f"{cfg.d_ff}, ssm chunk {cfg.ssm_chunk}; layers {kinds}; cut: "
      f"{cfg.n_layers} of {full.n_layers} layers (one period of the "
      f"pattern), {cfg.n_experts} of {full.n_experts} experts; "
      f"{n_params:,} parameters ({n_params * 2 / 1e9:.1f} GB of bf16) from "
      f"seed 0 in {time.perf_counter() - t0:.2f} s ({smi})")
  prompts = serve_prompts(cfg.vocab_size)[:JAMBA_REQUESTS]
  counters = _launch_counters()
  n_attn = sum(kind == "attn" for kind, _ in layer_pattern(cfg))
  want = {"flash_attention": n_attn * len(prompts),
          "quant_decode_attn": n_attn * len(prompts) * (JAMBA_NEW_TOKENS - 1),
          "wkv6": 0}
  runs = []
  for run in (1, 2):
    engine = ServeEngine(model, params, EngineConfig(**JAMBA_ENGINE))
    pre, dec = [], []
    engine._prefill = _timed(engine._prefill, pre)
    engine._decode = _timed(engine._decode, dec)
    for p in prompts:
      engine.submit(p, max_new_tokens=JAMBA_NEW_TOKENS)
    for mod in counters.values():
      mod.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.LAUNCHES[name] for name, mod in counters.items()}
    n_tokens = sum(len(t) for t in out.values())
    log(f"[serve-jamba] run {run}: {len(prompts)} requests (prompts "
        f"{[len(p) for p in prompts]} in a {JAMBA_ENGINE['prompt_bucket']}"
        f"-token bucket) x {JAMBA_NEW_TOKENS} tokens: {n_tokens} tokens in "
        f"{wall:.3f} s = {n_tokens / wall:.2f} tokens/s; prefill per request "
        f"host {statistics.median(r[0] for r in pre):.3f} ms, events "
        f"{statistics.median(r[1] for r in pre):.3f} ms; decode per token "
        f"host {statistics.median(r[0] for r in dec):.3f} ms, events "
        f"{statistics.median(r[1] for r in dec):.3f} ms (medians of "
        f"{len(dec)}); K6 launches {launches['flash_attention']}, K5 "
        f"launches {launches['quant_decode_attn']} (G = "
        f"{cfg.n_heads // cfg.n_kv_heads}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches != want:
      raise AssertionError(f"[serve-jamba] expected launches {want}, got "
                           f"{launches}")
    if sorted(out) != list(range(1, len(prompts) + 1)) or any(
        len(t) != JAMBA_NEW_TOKENS or not all(0 <= x < cfg.vocab_size
                                              for x in t)
        for t in out.values()):
      raise AssertionError(f"[serve-jamba] bad generations: {out}")
    runs.append(out)
    if run == 1:
      first = {k: n for k, n in launches.items() if want[k]}
  if runs[0] != runs[1]:
    raise AssertionError("[serve-jamba] a second run gave other tokens")
  log(f"[serve-jamba] the second run gave the same {len(prompts)} x "
      f"{JAMBA_NEW_TOKENS} tokens; first tokens "
      f"{[runs[0][u][:4] for u in sorted(runs[0])]}")
  del engine, params, model
  gc.collect()
  torch.cuda.empty_cache()
  return first


def phase_serve_jamba_parity():
  """jamba-1.5-large in float32 at one 8-layer period and
  ``zoo_parity_config``'s width (8 experts of 512, int8 KV): the card
  against the CPU through ``serve_parity`` (logits, greedy tokens, the
  engine's tokens, the MoE routing) and its mamba caches."""
  import dataclasses
  cfg = dataclasses.replace(zoo_parity_config("jamba-1.5-large"),
                            n_layers=JAMBA_CUT["n_layers"])
  return serve_parity(
      "serve-jamba-parity", cfg,
      f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads x {cfg.head_dim}, "
      f"d_inner {cfg.d_inner}, {cfg.n_experts} experts of "
      f"{cfg.d_ff_expert}, int8 KV", 1e-3, routing=True,
      width=f"narrowed to d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}")


# ---------------------------------------------------------------------------
# training: K6's backward, qwen3-0.6b trained at full width through the
# launcher, the card against the CPU, a restart from a checkpoint
# ---------------------------------------------------------------------------

def _k6_bwd_bound(dtype, s: int, g: int) -> float:
  """The backward kernel's tolerance against its plain version, relative to
  each gradient's largest |value|, written before its first run: f32
  inputs 1e-5 (every product and sum is f32 in both, in other orders);
  bf16 inputs add the final bf16 rounding of dq, dk and dv, 2^-8 (bf16's
  unit roundoff), to f32 sums of at most S x G terms at 2^-24 each."""
  import torch
  if dtype == torch.float32:
    return 1e-5
  return 2.0 ** -8 + s * g * 2.0 ** -24


def phase_k6_backward():
  """K6's backward kernel against its plain version (``ref.py``'s dense
  formulas from the same lse) at the training shape and its edges, with
  its time (also with a bf16-exact dO, the training path's), bound, plain
  time, SDPA's backward as the yardstick, each kernel's device time,
  ptxas' registers and spills, and a rerun that must give the same
  bits."""
  import numpy as np
  import torch
  import torch.nn.functional as F
  from repro_torch.kernels.flash_attention import kernel as fa_kernel
  from repro_torch.kernels.flash_attention import ops as fa
  rng = np.random.RandomState(23)
  result = None
  for b, s, h, hkv, d, dt_name, window in K6_BWD_CASES:
    dtype = getattr(torch, dt_name)
    scale = 1.0 / d ** 0.5
    q = _randn(rng, (b, s, h, d), dtype)
    kv = _randn(rng, (b, s, 2, hkv, d), dtype)
    k, v = kv[:, :, 0], kv[:, :, 1]   # strided views, as the model's
    dout = _randn(rng, (b, s, h, d), torch.float32)
    out, lse = fa_kernel.flash_attention(q, k, v, scale, True, window,
                                         return_lse=True)
    got = fa_kernel.flash_attention_bwd(q, k, v, out, dout, lse, scale,
                                        True, window)
    again = fa_kernel.flash_attention_bwd(q, k, v, out, dout, lse, scale,
                                          True, window)
    want = fa.flash_attention_bwd_reference(q, k, v, out, dout, lse, True,
                                            window)
    lse_err = float((lse - fa.flash_attention_lse_reference(
        q, k, True, window)).abs().max())
    # the serving call (no lse) gives the same output bits
    same_out = torch.equal(out, fa_kernel.flash_attention(q, k, v, scale,
                                                          True, window))
    torch.cuda.synchronize()
    tol = _k6_bwd_bound(dtype, s, h // hkv)
    errs = [float((x.float() - y).abs().max() / y.abs().max())
            for x, y in zip(got, want)]
    abs_err = max(float((x.float() - y).abs().max())
                  for x, y in zip(got, want))
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    tag = (f"B={b} S={s} H={h} Hkv={hkv} D={d} {dt_name} causal"
           + (f" window {window}" if window else ""))
    line = (f"[K6-bwd] {tag}: dq, dk, dv max |diff| / max |value| "
            f"{', '.join(f'{e:.3g}' for e in errs)} (tolerance {tol:.3g}); "
            f"lse max |diff| {lse_err:.3g}; output with lse "
            f"{'bit-identical to' if same_out else 'DIFFERENT from'} "
            f"without; rerun {'bit-identical' if same else 'DIFFERENT'}")
    if max(errs) > tol or not (same and same_out) or not lse_err <= 1e-4:
      log(line)
      raise AssertionError(f"K6's backward fails at {tag}")
    if (b, s) != (8, 512):
      log(line)
      continue
    ms = cuda_ms(lambda: fa_kernel.flash_attention_bwd(
        q, k, v, out, dout, lse, scale, True, window), inner=3)
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, dout, lse, True, window), inner=1)
    es = q.element_size()
    n_bytes = (2 * b * s * h * d * es + 4 * b * s * hkv * d * es
               + 2 * b * s * h * d * 4 + b * h * s * 4)
    n_ops = 2.5 * 4 * _live_pairs(s, True, window) * b * h * d
    peak = PEAK_BF16_PER_S if dtype == torch.bfloat16 else PEAK_FP32_PER_S
    b_ms, b_by = bound_ms(n_bytes, n_ops, peak)
    lib_ms = None
    if not window:
      qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                    for x in (q, k, v))
      dt_ = dout.transpose(1, 2).to(dtype)

      def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

      def sdpa_forward():
        with torch.no_grad():
          return sdpa()
      # both as graph replays: between events the host's autograd calls
      # leave the card idle (0.195-0.457 ms in two runs)
      lib_ms = (cuda_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt),
                                                    dt_), inner=3)
                - cuda_ms(sdpa_forward, inner=3))
    exact = ""
    if dtype == torch.bfloat16:
      _device_profile("K6-bwd", f"one backward, {tag}",
                      lambda: fa_kernel.flash_attention_bwd(
                          q, k, v, out, dout, lse, scale, True, window))
      # the training path's dO is bf16-exact (the model casts K6's output
      # to bf16): its lo part is zero
      dout16 = dout.bfloat16().float()
      got16 = fa_kernel.flash_attention_bwd(q, k, v, out, dout16, lse, scale,
                                            True, window)
      want16 = fa.flash_attention_bwd_reference(q, k, v, out, dout16, lse,
                                                True, window)
      errs16 = [float((x.float() - y).abs().max() / y.abs().max())
                for x, y in zip(got16, want16)]
      ms16 = cuda_ms(lambda: fa_kernel.flash_attention_bwd(
          q, k, v, out, dout16, lse, scale, True, window), inner=3)
      exact = (f"; with a bf16-exact dO (the training path's) "
               f"{ms16:.4f} ms, dq, dk, dv max |diff| / max |value| "
               f"{', '.join(f'{e:.3g}' for e in errs16)}")
      if max(errs16) > tol:
        log(line + exact)
        raise AssertionError(f"K6's backward fails at {tag} with a "
                             "bf16-exact dO")
    fwd_ms = cuda_ms(lambda: fa_kernel.flash_attention(q, k, v, scale, True,
                                                      window))
    fwd_lse_ms = cuda_ms(lambda: fa_kernel.flash_attention(
        q, k, v, scale, True, window, return_lse=True))
    was = (f" (the CUDA-core design: {K6_BWD_CUDA_CORE['ms']} ms)"
           if dtype == torch.bfloat16 and not window else "")
    log(f"{line}; kernel {ms:.4f} ms{was}, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB, "
        f"{n_ops / 1e9:.3f} GFLOP at 2.5x the forward's), library "
        + (f"(scaled_dot_product_attention forward + backward minus "
           f"forward) {lib_ms:.4f} ms" if lib_ms is not None
           else "not timed (window)")
        + f"; the forward K6 at this shape {fwd_ms:.4f} ms without lse, "
        f"{fwd_lse_ms:.4f} ms with it{exact}")
    if dtype == torch.bfloat16 and not window:
      result = dict(
          name="flash_attention_bwd (K6 backward)", route="cuda",
          source="src/repro_torch/kernels/flash_attention/csrc/"
                 "flash_attention.cu",
          replaces="src/repro/models/attention.py:44 (XLA's gradient of "
                   "the chunked attention; no Pallas kernel has a "
                   "backward)",
          on_main_path=True, max_abs_err=abs_err, ms=ms,
          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
          library_ms=lib_ms)
  from repro_torch import _build
  for name, report in sorted(_build.ptxas_report("flash_attention").items()):
    short = re.search(r"\d+(bwd_\w+_kernel)(?:ILi(\d+)E)?", name)
    if short:
      kernel = short.group(1) + (f"<{short.group(2)}>" if short.group(2)
                                 else "")
      log(f"[K6-bwd] ptxas: {kernel}: {report.get('registers')} registers "
          f"a thread, {report.get('spill_bytes')} bytes of spill stores")
  return {"flash_attention_bwd": result}


def _nonzero_grad_leaves(model, tcfg, params, batch):
  """Each trainable leaf's gradient on one batch, layer by layer: the
  names whose gradient is all zero (H21: attention's projections must
  learn through K6's backward)."""
  from repro_torch.train import train_step as ts_lib
  named = dict(params.named_parameters())
  _, _, grads = ts_lib.value_and_grad(model, tcfg, named, batch)
  return [n for n, g in zip(named, grads) if not bool(g.abs().max() > 0)]


def _unigram_entropy(cfg) -> float:
  """Entropy (nats) of the launcher's token stream's stationary
  distribution: the best loss of a model that predicts each token's
  frequency and nothing of its predecessor."""
  import numpy as np
  from repro_torch.data.synthetic import MarkovTokenStream, TokenStreamConfig
  stream = MarkovTokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size,
                                               branching=6))
  v = cfg.vocab_size
  pi = np.full(v, 1.0 / v)
  flow = stream.weights[None, :]
  for _ in range(200):
    new = np.zeros(v)
    np.add.at(new, stream.successors.ravel(), (pi[:, None] * flow).ravel())
    pi = new
  nz = pi[pi > 0]
  return float(-(nz * np.log(nz)).sum())


def _train_batch(cfg, b, s, step=0):
  import torch
  from repro_torch.data.synthetic import MarkovTokenStream, TokenStreamConfig
  toks, labels = MarkovTokenStream(TokenStreamConfig(
      vocab_size=cfg.vocab_size, branching=6)).sample_batch(b, s, step)
  return {"tokens": torch.from_numpy(toks).cuda(),
          "labels": torch.from_numpy(labels).cuda()}


def _train_run(tag, smi, start, b, s):
  """One launcher-recipe training run on the card at batches of b x s:
  ``start(ckpt_dir)`` builds and runs the Trainer.  Checks finite losses,
  the last 5 below the first 5 and ln V, 2 K6 launches a layer a step (the
  forward and its remat recompute) and one K6-backward, and a nonzero
  gradient for every leaf; prints ms a step, tokens/s, the model-FLOPs
  share, peak memory and one step's device time by kernel group
  (``[{tag}-profile]``).  Returns (the kernel counts, the Trainer, its
  checkpoint directory)."""
  import tempfile
  import torch
  from repro_torch.train import train_step as ts_lib
  (ROOT / "build").mkdir(exist_ok=True)
  ckpt = tempfile.mkdtemp(prefix=f"{tag}_", dir=ROOT / "build")
  rows = []
  real_step = ts_lib.train_step
  ts_lib.train_step = _timed(real_step, rows)
  torch.cuda.reset_peak_memory_stats()
  _reset_kernel_counts()
  t0 = time.perf_counter()
  try:
    trainer = start(ckpt)
  finally:
    ts_lib.train_step = real_step
  wall = time.perf_counter() - t0
  counts = _kernel_counts()
  peak = torch.cuda.max_memory_allocated()
  cfg = trainer.model.cfg
  steps = len(trainer.history)
  losses = [r["loss"] for r in trainer.history]
  host = statistics.median(r[0] for r in rows[1:])
  ev = statistics.median(r[1] for r in rows[1:])
  tok_s = b * s / (ev / 1e3)
  mfu = cfg.train_flops_per_token() * tok_s / PEAK_BF16_PER_S
  n_params = sum(p.numel() for p in trainer.state["params"].parameters())
  log(f"[{tag}] {cfg.name}: {_describe(cfg)}, d_ff {cfg.d_ff}, "
      f"{cfg.mlp_variant}, {cfg.norm}, "
      f"{'tied' if cfg.tie_embeddings else 'untied'} embeddings, "
      f"{n_params:,} parameters (param_count {cfg.param_count():,}), f32 "
      f"master weights, bf16 compute, remat; {steps} steps of {b} x {s} "
      f"tokens in {wall:.1f} s (set-up included)")
  log(f"[{tag}] losses {losses[0]:.4f} -> {losses[-1]:.4f}: first 5 "
      f"{[round(x, 4) for x in losses[:5]]}, last 5 "
      f"{[round(x, 4) for x in losses[-5:]]}")
  log(f"[{tag}] step (median of steps 2-{steps}): host {host:.2f} ms, "
      f"events {ev:.2f} ms (first step {rows[0][0]:.1f} ms host); "
      f"{tok_s:,.1f} tokens/s; model FLOPs "
      f"{cfg.train_flops_per_token() / 1e9:.3f} GFLOP/token x tokens/s = "
      f"{mfu:.2%} of the bf16 dense peak (989 TFLOP/s); peak memory "
      f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB); launches {counts}; "
      f"card: {smi}")
  want = {"flash_attention": 2 * cfg.n_layers * steps,
          "flash_attention_bwd": cfg.n_layers * steps}
  if any(counts[k] != n for k, n in want.items()) or any(
      n for k, n in counts.items() if k not in want):
    raise AssertionError(f"expected K6 launches {want} (forward and its "
                         f"recompute, and the backward, a layer a step) and "
                         f"no other kernel, got {counts}")
  if not all(x == x and abs(x) < float("inf") for x in losses):
    raise AssertionError(f"a loss is not finite: {losses}")
  first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
  uniform, floor = math.log(cfg.vocab_size), _unigram_entropy(cfg)
  log(f"[{tag}] losses every 10 steps "
      f"{[round(x, 3) for x in losses[::10]]}; mean of the first 5 "
      f"{first:.4f}, of the last 5 {last:.4f} (fell by {first - last:.4f}; "
      f"tests/test_train.py asks 0.3 of its small model); the uniform guess "
      f"ln {cfg.vocab_size} = {uniform:.4f}, the stream's unigram entropy "
      f"{floor:.4f} (the floor without learning its {cfg.vocab_size:,} x 6 "
      "transitions)")
  if not last < min(first, uniform):
    raise AssertionError(f"the last 5 losses ({last:.4f}) are not below the "
                         f"first 5 ({first:.4f}) and the uniform guess "
                         f"({uniform:.4f}): the model did not learn the "
                         "tokens' frequencies")
  batch = _train_batch(cfg, b, s, step=1000)
  zero = _nonzero_grad_leaves(trainer.model, trainer.tcfg,
                              trainer.state["params"], batch)
  log(f"[{tag}] every one of the "
      f"{len(list(trainer.state['params'].parameters()))} trainable leaves "
      "gets a nonzero gradient" if not zero else f"ZERO GRADIENTS: {zero}")
  if zero:
    raise AssertionError(f"leaves without a gradient: {zero}")
  stage = []
  timed_stage(stage, "step", lambda: trainer.run(1))
  by_group = {}
  device_ms = _device_profile(tag, "one full-width step",
                              lambda: trainer.run(1), by_group)
  log(f"[{tag}-profile] one step: {stage[0][1]:.2f} ms (host), "
      f"{stage[0][2]:.2f} ms (events); the card busy "
      + (f"{device_ms / stage[0][2]:.1%} of it" if device_ms else
         "not measured")
      + "; K6 " + (f"{by_group['K6']:.3f} ms" if "K6" in by_group
                   else "not measured")
      + ", K6's backward "
      + (f"{by_group['K6-bwd']:.3f} ms" if "K6-bwd" in by_group
         else "not measured") + " of device time")
  return counts, trainer, ckpt


def phase_train(smi):
  """LM training at full width on qwen3-0.6b cut to ``TRAIN_QWEN3_LAYERS``
  of its 28 layers (bf16 compute, f32 master weights): the launcher's
  recipe and Trainer (``launch.train.make_trainer``), 200 steps of 8 x
  512 tokens."""
  import dataclasses
  import shutil
  import torch
  from repro_torch.configs import get_config
  from repro_torch.launch import train as launch_train
  cfg = dataclasses.replace(get_config("qwen3-0.6b"),
                            n_layers=TRAIN_QWEN3_LAYERS)
  steps, b, s = (TRAIN_RECIPE[k] for k in ("steps", "batch", "seq"))

  def start(ckpt):
    trainer = launch_train.make_trainer(cfg, launch_train.recipe(steps),
                                        steps, b, s, ckpt)
    trainer.run()
    return trainer
  counts, trainer, ckpt = _train_run("train", smi, start, b, s)
  del trainer
  torch.cuda.empty_cache()
  shutil.rmtree(ckpt, ignore_errors=True)
  return counts


def phase_train_olmo(smi):
  """Slice 8a's training main path: the launcher's default arch, olmo-1b,
  at full width and ``TRAIN_OLMO_LAYERS`` of its 16 layers
  (non-parametric layernorm, bf16 compute, f32 master weights) through
  the launcher's recipe and Trainer (``launch.train.make_trainer``), 200
  steps of 8 x 512 tokens; then 5 steps each of int8 optimizer states,
  LightPE-2 QAT and 2 microbatches."""
  import dataclasses
  import shutil
  import torch
  from repro_torch.configs import get_config
  from repro_torch.launch import train as launch_train
  cfg = dataclasses.replace(get_config(TRAIN_OLMO_ARCH),
                            n_layers=TRAIN_OLMO_LAYERS)
  steps, b, s = (TRAIN_RECIPE[k] for k in ("steps", "batch", "seq"))

  def start(ckpt):
    trainer = launch_train.make_trainer(cfg, launch_train.recipe(steps),
                                        steps, b, s, ckpt)
    trainer.run()
    return trainer
  counts, trainer, ckpt = _train_run("train-olmo", smi, start, b, s)
  n_params = sum(p.numel() for p in trainer.state["params"].parameters())
  del trainer
  torch.cuda.empty_cache()
  base = launch_train.recipe(TRAIN_VARIANT_STEPS)
  variants = (
      ("int8 optimizer states", dataclasses.replace(
          base, optimizer=dataclasses.replace(base.optimizer,
                                              quantize_state=True))),
      ("LightPE-2 QAT", launch_train.recipe(TRAIN_VARIANT_STEPS,
                                            "LightPE-2")),
      ("2 microbatches", dataclasses.replace(base, microbatches=2)))
  for name, tcfg in variants:
    torch.cuda.reset_peak_memory_stats()
    trainer = launch_train.make_trainer(cfg, tcfg, TRAIN_VARIANT_STEPS, b,
                                        s, ckpt)
    hist = trainer.run()
    opt = trainer.state["opt"]
    state_bytes = sum(t.numel() * t.element_size()
                      for key in ("m", "v") for leaf in opt[key].values()
                      for t in (leaf.values() if isinstance(leaf, dict)
                                else [leaf]))
    f32_bytes = 2 * 4 * n_params
    extra = (f"; optimizer state {state_bytes / 1e9:.3f} GB against "
             f"{f32_bytes / 1e9:.3f} GB in f32 ({f32_bytes / state_bytes:.2f}"
             "x less; the reference claims ~3.5x)"
             if tcfg.optimizer.quantize_state else "")
    losses = [r["loss"] for r in hist]
    log(f"[train-olmo] {name}: {len(hist)} steps, losses "
        f"{[round(x, 4) for x in losses]}, host ms a step "
        f"{statistics.median(r['sec'] for r in hist[1:]) * 1e3:.2f} "
        f"(median of steps 2-{len(hist)}), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB{extra}")
    if not all(x == x and abs(x) < float("inf") for x in losses):
      raise AssertionError(f"{name}: a loss is not finite: {losses}")
    del trainer, opt
    torch.cuda.empty_cache()
  shutil.rmtree(ckpt, ignore_errors=True)
  return counts


def phase_train_moe(smi):
  """qwen2-moe-a2.7b at full width, 2 layers, through the launcher's
  recipe and Trainer: 5 steps of 8 x 512 tokens (eight MoE groups of
  512).  Checks finite losses and aux losses, and a nonzero gradient for
  every leaf, the router, the stacked experts and the shared expert among
  them."""
  import dataclasses
  import shutil
  import tempfile
  import torch
  from repro_torch.configs import get_config
  from repro_torch.launch import train as launch_train
  from repro_torch.train import train_step as ts_lib
  r = TRAIN_MOE
  cfg = dataclasses.replace(get_config(SERVE_MOE_ARCH),
                            n_layers=r["n_layers"])
  ckpt = tempfile.mkdtemp(prefix="train_moe_", dir=ROOT / "build")
  aux, rows = [], []
  real_step = ts_lib.train_step
  timed = _timed(real_step, rows)

  def step(*args):
    state, metrics = timed(*args)
    aux.append(float(metrics["aux"]))
    return state, metrics
  torch.cuda.reset_peak_memory_stats()
  _reset_kernel_counts()
  ts_lib.train_step = step
  try:
    trainer = launch_train.make_trainer(cfg, launch_train.recipe(r["steps"]),
                                        r["steps"], r["batch"], r["seq"],
                                        ckpt)
    hist = trainer.run()
  finally:
    ts_lib.train_step = real_step
  counts = _kernel_counts()
  losses = [x["loss"] for x in hist]
  batch = _train_batch(cfg, r["batch"], r["seq"], step=1000)
  zero = _nonzero_grad_leaves(trainer.model, trainer.tcfg,
                              trainer.state["params"], batch)
  names = [n for n, _ in trainer.state["params"].named_parameters()]
  moe_leaves = [n for n in names if ".ffn." in n]
  ev = statistics.median(x[1] for x in rows[1:])
  log(f"[train-moe] {cfg.name}: {_describe(cfg)}, full width, "
      f"{cfg.n_layers} of 24 layers; {len(hist)} steps of {r['batch']} x "
      f"{r['seq']} tokens: losses {[round(x, 4) for x in losses]}, aux "
      f"losses {[round(x, 4) for x in aux]} (k = {cfg.n_experts_active} for a "
      f"balanced router that drops no token); "
      f"step (median of steps 2-{len(hist)}) {ev:.2f} ms between events; "
      f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
      f"launches {counts}; leaves with an all-zero gradient: "
      f"{zero or 'none'} of {len(names)} ({len(moe_leaves)} MoE leaves: "
      f"{sorted({n.split('.ffn.')[1] for n in moe_leaves})}); card: {smi}")
  want = {"flash_attention": 2 * cfg.n_layers * len(hist),
          "flash_attention_bwd": cfg.n_layers * len(hist)}
  if any(counts[k] != n for k, n in want.items()):
    raise AssertionError(f"expected K6 launches {want}, got {counts}")
  if not all(math.isfinite(x) for x in losses + aux) or zero:
    raise AssertionError("MoE training: a loss or aux loss is not finite, "
                         "or a leaf has no gradient")
  del trainer
  torch.cuda.empty_cache()
  shutil.rmtree(ckpt, ignore_errors=True)


def phase_train_parity(arch="qwen3-0.6b", tag="train-parity", changes=None):
  """``arch`` at full width (or with the width ``changes``), 2 layers, f32,
  TF32 off: the train loss, every gradient and one AdamW step (f32 and
  int8 states) on the card against the CPU from the same weights and
  batch; a vlm's batch opens with its ``n_image_tokens`` image
  embeddings.

  Each gradient leaf is held to 1e-4 of its largest |value|, and to
  ``RWKV_PARITY_GRAD_TOL`` for rwkv6 (see there)."""
  import dataclasses
  import numpy as np
  import torch
  from repro_torch.configs import get_config
  from repro_torch.core.cnn import exact_f32
  from repro_torch.models import build_model
  from repro_torch.train import optimizer as opt_lib
  from repro_torch.train import train_step as ts_lib
  cfg = dataclasses.replace(get_config(arch), dtype="float32",
                            n_layers=PARITY_LAYERS, **(changes or {}))
  tcfg = ts_lib.TrainConfig()
  gpu_model, cpu_model = build_model(cfg), build_model(cfg, device="cpu")
  gpu_params = gpu_model.init(0, param_dtype="float32")
  cpu_params = cpu_model.from_state(
      {k: v.cpu() for k, v in gpu_params.state_dict().items()},
      param_dtype="float32")
  batch = _train_batch(cfg, *TRAIN_PARITY_BATCH)
  if cfg.family == "vlm":
    batch["img_embeds"] = _randn(
        np.random.RandomState(12),
        (TRAIN_PARITY_BATCH[0], cfg.n_image_tokens, cfg.d_model),
        torch.float32)
  cpu_batch = {k: v.cpu() for k, v in batch.items()}
  ssm = cfg.family == "ssm"
  grad_tol = RWKV_PARITY_GRAD_TOL if ssm else 1e-4
  with exact_f32():
    _reset_kernel_counts()
    loss_g, _, grads_g = ts_lib.value_and_grad(
        gpu_model, tcfg, dict(gpu_params.named_parameters()), batch)
    counts = _kernel_counts()
    loss_c, _, grads_c = ts_lib.value_and_grad(
        cpu_model, tcfg, dict(cpu_params.named_parameters()), cpu_batch)
  names = [n for n, _ in gpu_params.named_parameters()]
  loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
  grad_errs = {n: float((g.cpu() - c).abs().max() / c.abs().max())
               for n, g, c in zip(names, grads_g, grads_c)}
  worst = max(grad_errs, key=grad_errs.get)
  zero = [n for n, g in zip(names, grads_g) if not bool(g.abs().max() > 0)]
  wkv = (f"; {counts['wkv6']} K7 and {counts['wkv6_bwd']} K7-backward "
         "launches on the card" if ssm else
         f"; {counts['flash_attention']} K6 and "
         f"{counts['flash_attention_bwd']} K6-backward launches on the card")
  width = ("at full width" if not changes else "narrowed to " + ", ".join(
      f"{k} {v}" for k, v in changes.items()) + f" ({cfg.n_heads} heads / "
      f"{cfg.n_kv_heads} kv heads x {cfg.head_dim} kept)")
  extra = (f", {cfg.n_image_tokens} image embeddings first"
           if "img_embeds" in batch else "")
  log(f"[{tag}] {cfg.name} {width}, float32, "
      f"{cfg.n_layers} layers, TF32 off, batch {TRAIN_PARITY_BATCH}{extra}: "
      f"loss card {float(loss_g):.7f} vs CPU {float(loss_c):.7f}, relative "
      f"{loss_err:.3g} (tolerance 1e-5); {len(names)} gradient leaves, "
      f"worst {worst} at {grad_errs[worst]:.3g} of its max |value| "
      f"(tolerance {grad_tol:g}); leaves with an all-zero gradient on the "
      f"card: {zero or 'none'}{wkv}")
  if loss_err > 1e-5 or grad_errs[worst] > grad_tol or zero:
    raise AssertionError("the card and the CPU disagree on training")
  # one AdamW step on each device from the same parameters, moments and
  # gradients (the CPU's): f32 moments, then int8 ones
  for quantize in (False, True):
    ocfg = opt_lib.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=40,
                               quantize_state=quantize)
    sides = {}
    for dev in ("cuda", "cpu"):
      params = {n: p.detach().to(dev).clone()
                for n, p in cpu_params.named_parameters()}
      state = opt_lib.adamw_init(ocfg, params)
      state["step"] = 20
      grads = {n: g.to(dev) for n, g in zip(names, grads_c)}
      _, state, metrics = opt_lib.adamw_update(ocfg, params, grads, state)
      sides[dev] = (params, state, metrics)
    (pg, sg, mg), (pc, sc, mc) = sides["cuda"], sides["cpu"]
    gn_ulps = abs(int(np.float32(float(mg["grad_norm"])).view(np.int32))
                  - int(np.float32(float(mc["grad_norm"])).view(np.int32)))
    same_p = all(torch.equal(pg[n].cpu(), pc[n]) for n in names)

    def leaves(st):
      return [t for key in ("m", "v") for leaf in st[key].values()
              for t in (leaf.values() if isinstance(leaf, dict) else [leaf])]
    same_s = all(torch.equal(a.cpu(), b)
                 for a, b in zip(leaves(sg), leaves(sc)))
    log(f"[{tag}] one adamw_update, {'int8' if quantize else 'f32'} "
        f"states, the CPU's gradients on both: global_norm card "
        f"{float(mg['grad_norm']):.9g} vs CPU {float(mc['grad_norm']):.9g} "
        f"({gn_ulps} ulp), lr_at {mg['lr']:.9g} vs {mc['lr']:.9g}; "
        f"parameters {'bit-equal' if same_p else 'DIFFERENT'}, "
        f"{'codes and scales' if quantize else 'moments'} "
        f"{'bit-equal' if same_s else 'DIFFERENT'}")
    if gn_ulps > 1 or mg["lr"] != mc["lr"] or not (same_p and same_s):
      raise AssertionError("AdamW differs between the card and the CPU")


def phase_train_resume():
  """A restart on the card: a Trainer with a checkpoint every 3 steps runs
  6 steps, a fresh one restores it and runs 6 more; its losses and
  parameters must equal 12 uninterrupted steps' bit for bit."""
  import dataclasses
  import shutil
  import tempfile
  import torch
  from repro_torch.configs import get_config
  from repro_torch.launch import train as launch_train
  r = TRAIN_RESUME
  cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=r["n_layers"])
  tcfg = launch_train.recipe(r["steps"])
  root = tempfile.mkdtemp(prefix="resume_", dir=ROOT / "build")

  def trainer(path, ckpt_every):
    t = launch_train.make_trainer(cfg, tcfg, r["steps"], r["batch"],
                                  r["seq"], os.path.join(root, path))
    t.cfg.ckpt_every = ckpt_every
    return t
  t0 = time.perf_counter()
  whole = trainer("whole", 0)
  whole.run(r["steps"])
  want_losses = [x["loss"] for x in whole.history]
  want = [p.detach().clone() for p in whole.state["params"].parameters()]
  del whole
  half = r["steps"] // 2
  first = trainer("split", r["ckpt_every"])
  first.run(half)
  del first
  t1 = time.perf_counter()
  again = trainer("split", r["ckpt_every"])
  restored = again.maybe_restore()
  t_restore = time.perf_counter() - t1
  again.run(r["steps"] - half)
  got_losses = [x["loss"] for x in again.history]
  same_p = all(torch.equal(p, q) for p, q in
               zip(again.state["params"].parameters(), want))
  size = sum(os.path.getsize(os.path.join(root, "split", f))
             for f in os.listdir(os.path.join(root, "split")))
  log(f"[train-resume] {cfg.name} at full width, {cfg.n_layers} layers: "
      f"{r['steps']} uninterrupted steps against {half} steps, a checkpoint "
      f"every {r['ckpt_every']}, then a fresh Trainer restored from step "
      f"{again.step - (r['steps'] - half)} (data cursor at "
      f"{again.cursor.step - (r['steps'] - half)}) in {t_restore:.2f} s "
      f"and {r['steps'] - half} more steps: losses "
      f"{'bit-identical' if got_losses == want_losses[half:] else 'DIFFERENT'}"
      f" {[round(x, 5) for x in got_losses]}, parameters "
      f"{'bit-identical' if same_p else 'DIFFERENT'}; checkpoints on disk "
      f"{size / 1e9:.2f} GB; {time.perf_counter() - t0:.1f} s")
  shutil.rmtree(root, ignore_errors=True)
  if not restored or got_losses != want_losses[half:] or not same_p:
    raise AssertionError("a restart does not resume bit for bit")


# ---------------------------------------------------------------------------
# rwkv6 training: K7's backward, the launcher at full width, the card
# against the CPU
# ---------------------------------------------------------------------------

def _k7_bwd_counts(b, t, h, d, elem_bytes, with_state):
  """Bytes K7's backward must move (r, k, v, w, dO, u read once, s0 and
  ds_final when given; dr, dk, dv, dw, du and ds0 written once) and its
  operations: twice the forward's (``_k7_counts``), the usual count of a
  backward."""
  n_bytes = (b * t * h * d * (3 * elem_bytes + 4 + 4 + 3 * elem_bytes + 4)
             + 2 * h * d * 4
             + b * h * d * d * 4 * (3 if with_state else 1))
  return n_bytes, 2 * _k7_counts(b, t, h, d, elem_bytes, with_state)[1]


def _k7_bwd_inputs(rng, b, t, h, d, dtype, with_state, tiny_w):
  import numpy as np
  import torch

  def heads(x):  # the model's (B, T, H * D) projections as (B, H, T, D)
    return x.view(b, t, h, d).transpose(1, 2)
  r, k, v = (heads(_randn(rng, (b, t, h * d), dtype) * sc)
             for sc in (0.5, 0.5, 1.0))
  w = heads(torch.exp(-torch.exp(
      2.0 * _randn(rng, (b, t, h * d), torch.float32) - 3.0)))
  if tiny_w:
    ws = rng.uniform(1e-30, 0.9999, (b, t, h * d)).astype(np.float32)
    pick = rng.uniform(size=ws.shape)
    ws[pick < 0.05] = 1e-30
    ws[pick > 0.95] = 0.9999
    w = heads(torch.from_numpy(ws).cuda())
  u = _randn(rng, (h, d), torch.float32) * 0.3
  s0 = _randn(rng, (b, h, d, d), torch.float32) * 0.1 if with_state else None
  # the output's gradient as the model hands it back: a (B, H, T, D) view
  # of (B, T, H, D) memory
  dout = heads(_randn(rng, (b, t, h * d), torch.float32))
  ds = _randn(rng, (b, h, d, d), torch.float32) * 0.1 if with_state else None
  return r, k, v, w, u, s0, dout, ds


def phase_k7_backward():
  """K7's backward kernel against its plain chunked version
  (``ref.wkv6_chunked_bwd``) at the training shape and its edges: each
  gradient's error against its bound, reruns bit-identical, and at the
  training shape its time as a graph replay, bound, plain time, each
  kernel's device time from the profiler and ptxas' registers and
  spills.  Bounds, written before the first run: dr, dk, dv, du and ds0
  within 1e-4 of each one's largest |value| (K7's forward's bound: f32
  sums in other orders and the factored decays), plus 2^-8 for the bf16
  dr, dk and dv (their final rounding); dw, whose d log w sums terms
  that cancel, within 1e-4 of ``dlogw_scale`` over w."""
  import numpy as np
  import torch
  from repro_torch import _build
  from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
  from repro_torch.kernels.rwkv6_scan import ops as wkv
  from wkv_grad_scale import dlogw_scale
  rng = np.random.RandomState(29)
  result = None
  for b, t, h, d, chunk, dt_name, with_state, tiny_w in K7_BWD_CASES:
    dtype = getattr(torch, dt_name)
    r, k, v, w, u, s0, dout, ds = _k7_bwd_inputs(rng, b, t, h, d, dtype,
                                                 with_state, tiny_w)
    got = wkv_kernel.wkv6_bwd(r, k, v, w, u, s0, dout, ds, chunk=chunk)
    again = wkv_kernel.wkv6_bwd(r, k, v, w, u, s0, dout, ds, chunk=chunk)
    blocks = wkv_kernel.last_bwd_blocks()
    want = wkv.wkv6_bwd_reference(r, k, v, w, u, s0, dout, ds, chunk=chunk)
    torch.cuda.synchronize()
    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    errs, parts = {}, []
    for name, x, y in zip(names, got, want):
      if name == "dw":
        continue
      tol = 1e-4 + (2.0 ** -8 if x.dtype == torch.bfloat16 else 0.0)
      errs[name] = (float((x.float() - y).abs().max()),
                    float(y.abs().max()), tol)
    scale = dlogw_scale(r, k, v, u, dout, want[0], want[1], chunk)
    dw_ratio = float(((got[3] - want[3]).abs() * w / scale).max())
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    # chunk-parallel: a block per (batch, head) and chunk in launches 1, 3
    per_chunk = b * h * -(-t // chunk)
    grid_ok = (blocks["wkv6_bwd_local_kernel"] == per_chunk
               and blocks["wkv6_bwd_grad_kernel"] == per_chunk)
    tag = (f"B={b} T={t} H={h} D={d} chunk={chunk} {dt_name} r/k/v"
           + (", s0 and ds_final" if with_state else "")
           + (", w down to 1e-30" if tiny_w else ""))
    line = (f"[K7-bwd] {tag}: max |diff| (max |value|, tolerance of it) "
            + ", ".join(f"{n} {e:.3g} ({m:.3g}, {tl:.3g})"
                        for n, (e, m, tl) in errs.items())
            + f"; dw max |diff| w / dlogw_scale {dw_ratio:.3g} (tolerance "
            f"1e-4); rerun {'bit-identical' if same else 'DIFFERENT'}")
    if (not finite or not same or dw_ratio > 1e-4 or not grid_ok
        or any(e > tl * m for e, m, tl in errs.values())):
      log(f"{line}; blocks a launch {blocks}")
      raise AssertionError(f"K7's backward fails at {tag}")
    if (b, t, h, d) != (8, 512, 32, 64):
      log(line)
      continue
    ms = cuda_ms(lambda: wkv_kernel.wkv6_bwd(r, k, v, w, u, s0, dout, ds,
                                             chunk=chunk), inner=3)
    plain_ms = cuda_ms(lambda: wkv.wkv6_bwd_reference(
        r, k, v, w, u, s0, dout, ds, chunk=chunk), inner=1)
    fwd_ms = cuda_ms(lambda: wkv_kernel.wkv6(r, k, v, w, u, s0,
                                             chunk=chunk))
    n_bytes, n_ops = _k7_bwd_counts(b, t, h, d, r.element_size(),
                                    with_state)
    b_ms, b_by = bound_ms(n_bytes, n_ops, PEAK_FP32_PER_S)
    log(f"{line}; kernel {ms:.4f} ms (the first design, one block per "
        f"(batch, head): {K7_BWD_FIRST['ms']} ms bf16), plain "
        f"{plain_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB at 3.35 TB/s, "
        f"{n_ops / 1e9:.3f} GFLOP at 67 TFLOP/s f32), library: none (no "
        f"PyTorch call computes the WKV6 recurrence's gradient); the "
        f"forward K7 at this shape {fwd_ms:.4f} ms; blocks a launch (as "
        "the C entry launched them) "
        + ", ".join(f"{k} {n:,}" for k, n in blocks.items()))
    if dtype == torch.bfloat16:
      _device_profile("K7-bwd", f"one backward, {tag}",
                      lambda: wkv_kernel.wkv6_bwd(r, k, v, w, u, s0, dout,
                                                  ds, chunk=chunk))
      result = dict(
          name="wkv6_bwd (K7 backward)", route="cuda",
          source="src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
          replaces="src/repro/models/ssm.py:225 (XLA's gradient of the "
                   "pure-jnp wkv6_chunked; no Pallas kernel has a "
                   "backward)",
          on_main_path=True,
          max_abs_err=max(e for e, _, _ in errs.values()), ms=ms,
          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
          library_note="no single PyTorch call computes the WKV6 "
                       "recurrence's gradient")
  for name, report in sorted(_build.ptxas_report("rwkv6_scan").items()):
    short = re.search(r"(wkv6_bwd_[a-z]+_kernel)I(\w*?)Li(\d+)E", name)
    if short:
      elem = ("bf16, " if "bfloat16" in short.group(2) else
              "f32, " if short.group(2) else "")
      log(f"[K7-bwd] ptxas: {short.group(1)}<{elem}{short.group(3)}>: "
          f"{report.get('registers')} registers a thread, "
          f"{report.get('spill_bytes')} bytes of spill stores")
  return {"wkv6_bwd": result}


def phase_train_rwkv(smi):
  """rwkv6 training's main path: the launcher's recipe and Trainer
  (``launch.train.make_trainer``) on rwkv6-1.6b at full width and
  ``TRAIN_RWKV_LAYERS`` of its 24 layers (bf16 compute, f32 master
  weights), 200 steps of 8 x 512 tokens; then one step's device
  operations and 5 steps under LightPE-2 QAT."""
  import dataclasses
  import shutil
  import tempfile
  import torch
  from repro_torch.configs import get_config
  from repro_torch.launch import train as launch_train
  from repro_torch.train import train_step as ts_lib
  (ROOT / "build").mkdir(exist_ok=True)
  ckpt = tempfile.mkdtemp(prefix="train_rwkv_", dir=ROOT / "build")
  steps, b, s = (TRAIN_RECIPE[k] for k in ("steps", "batch", "seq"))
  cfg = dataclasses.replace(get_config("rwkv6-1.6b"),
                            n_layers=TRAIN_RWKV_LAYERS)
  rows = []
  real_step = ts_lib.train_step
  ts_lib.train_step = _timed(real_step, rows)
  torch.cuda.reset_peak_memory_stats()
  _reset_kernel_counts()
  t0 = time.perf_counter()
  try:
    trainer = launch_train.make_trainer(cfg, launch_train.recipe(steps),
                                        steps, b, s, ckpt)
    trainer.run()
  finally:
    ts_lib.train_step = real_step
  wall = time.perf_counter() - t0
  counts = _kernel_counts()
  peak = torch.cuda.max_memory_allocated()
  steps = len(trainer.history)
  losses = [r["loss"] for r in trainer.history]
  host = statistics.median(r[0] for r in rows[1:])
  ev = statistics.median(r[1] for r in rows[1:])
  tok_s = b * s / (ev / 1e3)
  n_params = sum(p.numel() for p in trainer.state["params"].parameters())
  log(f"[train-rwkv] {cfg.name}: {_describe(cfg)}, "
      f"{n_params:,} parameters (param_count {cfg.param_count():,}), f32 "
      f"master weights, bf16 compute, remat; {steps} steps of {b} x {s} "
      f"tokens in {wall:.1f} s (set-up included)")
  log(f"[train-rwkv] losses {losses[0]:.4f} -> {losses[-1]:.4f}: first 5 "
      f"{[round(x, 4) for x in losses[:5]]}, last 5 "
      f"{[round(x, 4) for x in losses[-5:]]}; every 10 steps "
      f"{[round(x, 3) for x in losses[::10]]}")
  log(f"[train-rwkv] step (median of steps 2-{steps}): host {host:.2f} ms, "
      f"events {ev:.2f} ms (first step {rows[0][0]:.1f} ms host); "
      f"{tok_s:,.1f} tokens/s; model FLOPs "
      f"{cfg.train_flops_per_token() / 1e9:.3f} GFLOP/token x tokens/s = "
      f"{cfg.train_flops_per_token() * tok_s / PEAK_BF16_PER_S:.2%} of the "
      f"bf16 dense peak (989 TFLOP/s); peak memory {peak / 2**30:.2f} GiB "
      f"({peak / 1e9:.2f} GB); launches {counts}; card: {smi}")
  want = {"wkv6": 2 * cfg.n_layers * steps, "wkv6_bwd": cfg.n_layers * steps}
  if any(counts[k] != n for k, n in want.items()) or any(
      n for k, n in counts.items() if k not in want):
    raise AssertionError(f"expected K7 launches {want} (the forward and its "
                         f"recompute, and the backward, a layer a step) and "
                         f"no other kernel, got {counts}")
  if not all(x == x and abs(x) < float("inf") for x in losses):
    raise AssertionError(f"a loss is not finite: {losses}")
  first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
  uniform = math.log(cfg.vocab_size)
  log(f"[train-rwkv] mean of the first 5 losses {first:.4f}, of the last 5 "
      f"{last:.4f} (fell by {first - last:.4f}); the uniform guess ln "
      f"{cfg.vocab_size} = {uniform:.4f}")
  if not last < min(first, uniform):
    raise AssertionError(f"the last 5 losses ({last:.4f}) are not below the "
                         f"first 5 ({first:.4f}) and the uniform guess "
                         f"({uniform:.4f})")
  batch = _train_batch(cfg, b, s, step=1000)
  zero = _nonzero_grad_leaves(trainer.model, trainer.tcfg,
                              trainer.state["params"], batch)
  log(f"[train-rwkv] every one of the "
      f"{len(list(trainer.state['params'].parameters()))} trainable leaves "
      "gets a nonzero gradient" if not zero else f"ZERO GRADIENTS: {zero}")
  if zero:
    raise AssertionError(f"leaves without a gradient: {zero}")
  stage = []
  timed_stage(stage, "step", lambda: trainer.run(1))
  by_group = {}
  device_ms = _device_profile("train-rwkv", "one full-width step",
                              lambda: trainer.run(1), by_group)
  log(f"[train-rwkv-profile] one step: {stage[0][1]:.2f} ms (host), "
      f"{stage[0][2]:.2f} ms (events); the card busy "
      + (f"{device_ms / stage[0][2]:.1%} of it" if device_ms else
         "not measured")
      + "; K7 " + (f"{by_group['K7']:.3f} ms" if "K7" in by_group
                   else "not measured")
      + ", K7's backward " + (
          f"{by_group['K7-bwd']:.3f} ms ({by_group['K7-bwd'] / device_ms:.1%}"
          " of the step's device time)" if "K7-bwd" in by_group and device_ms
          else "not measured")
      + " of device time")
  del trainer
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  tcfg = launch_train.recipe(TRAIN_VARIANT_STEPS, "LightPE-2")
  trainer = launch_train.make_trainer(cfg, tcfg, TRAIN_VARIANT_STEPS, b, s,
                                      ckpt)
  hist = trainer.run()
  qat = [r["loss"] for r in hist]
  log(f"[train-rwkv] LightPE-2 QAT: {len(hist)} steps, losses "
      f"{[round(x, 4) for x in qat]}, host ms a step "
      f"{statistics.median(r['sec'] for r in hist[1:]) * 1e3:.2f} (median of "
      f"steps 2-{len(hist)}), peak memory "
      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
  if not all(x == x and abs(x) < float("inf") for x in qat):
    raise AssertionError(f"LightPE-2 QAT: a loss is not finite: {qat}")
  del trainer
  torch.cuda.empty_cache()
  shutil.rmtree(ckpt, ignore_errors=True)
  return counts


# ---------------------------------------------------------------------------
# the deploy codecs: K3, K4, qwen3-0.6b packed under each PE type, and the
# card against the CPU
# ---------------------------------------------------------------------------

def _int_mm_ms(xq, wq, epilogue=None):
  """Time of ``torch._int_mm`` on the same codes (the int32 product
  without the epilogue; with ``epilogue`` = (x_scale, w_scale), followed by
  K3's two f32 multiplies: the library route to K3's whole function), or
  why it refuses the shape."""
  import torch

  def call():
    acc = torch._int_mm(xq, wq)
    if epilogue is None:
      return acc
    xs, ws = epilogue
    return (acc.to(torch.float32) * xs.reshape(-1, 1).to(torch.float32)
            * ws.reshape(1, -1))
  try:
    return cuda_ms(call), None
  except RuntimeError as e:   # the library's own shape rules, not a check
    return None, str(e).splitlines()[0][:120]


def phase_codec_kernels():
  """K3 and K4 vs their plain versions on the card, on seeded codes, at
  qwen3-0.6b's ffn/wi shape (K3: each (K, N) of a layer) for a decode
  token and a 512-token prompt and at a ragged shape.  K3 must equal its
  plain version exactly; K4 is held to 1e-5 of the largest |out| (it
  multiplies by the scale after the K sum, the plain version folds it into
  the weights)."""
  import numpy as np
  import torch
  from repro_torch.kernels.int8_matmul import kernel as i8_kernel
  from repro_torch.kernels.int8_matmul import ref as i8_ref
  from repro_torch.kernels.pow2_matmul import kernel as p2_kernel
  from repro_torch.kernels.pow2_matmul import ref as p2_ref
  torch.backends.cuda.matmul.allow_tf32 = False
  results = {}
  k_dim, n_dim = CODEC_KN
  shapes = [(m, k_dim, n_dim) for m in CODEC_MS] + [CODEC_RAGGED]
  rng = np.random.RandomState(3)

  def dev(a):
    return torch.from_numpy(a).cuda()

  for m, k, n in [(m, k, n) for k, n in CODEC_LAYER_KN for m in CODEC_MS] + [
      CODEC_RAGGED]:
    xq = dev(rng.randint(-128, 128, (m, k)).astype(np.int8))
    wq = dev(rng.randint(-128, 128, (k, n)).astype(np.int8))
    ws = dev(rng.uniform(1e-4, 1e-2, n).astype(np.float32))
    lib_ms, lib_why = _int_mm_ms(xq, wq)
    for xs_dtype in (torch.float32, torch.bfloat16):
      xs = dev(rng.uniform(1e-3, 1e-1, m).astype(np.float32)).to(xs_dtype)
      got = i8_kernel.int8_matmul(xq, wq, xs, ws)
      want = i8_ref.int8_matmul_ref(xq, wq, xs, ws)
      torch.cuda.synchronize()
      err = float((got - want).abs().max())
      if not torch.equal(got, want):
        raise AssertionError(f"K3 differs from its plain version at "
                             f"{(m, k, n)}: max_abs_err {err}")
      ms = cuda_ms(lambda: i8_kernel.int8_matmul(xq, wq, xs, ws))
      plain_ms = cuda_ms(lambda: i8_ref.int8_matmul_ref(xq, wq, xs, ws),
                         inner=2)
      n_bytes = m * k + k * n + m * xs.element_size() + n * 4 + m * n * 4
      b_ms, b_by = bound_ms(n_bytes, 2 * m * n * k, PEAK_INT8_PER_S)
      whole_ms, _ = _int_mm_ms(xq, wq, epilogue=(xs, ws))
      lib = (f"{lib_ms:.4f} ms; yardstick of K3's whole function "
             f"(_int_mm then the two f32 multiplies) {whole_ms:.4f} ms"
             if lib_ms is not None
             else f"not timed: _int_mm refuses the shape ({lib_why})")
      log(f"[K3] M={m} K={k} N={n}, {str(xs_dtype).split('.')[-1]} x "
          f"scales, {i8_kernel.describe(m, k, n)}: max_abs_err {err:.3g} "
          f"(tolerance 0: equal); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}: {n_bytes / 1e6:.2f} MB, {2 * m * n * k / 1e9:.3f} GOP "
          f"at 1,979 TOP/s int8), library (torch._int_mm, the int32 "
          f"product without the epilogue) {lib}")
      if (m, k, n, xs_dtype) == (max(CODEC_MS), k_dim, n_dim,
                                 torch.bfloat16):
        results["int8_matmul"] = dict(
            name="int8_matmul (K3)", route="cuda",
            source="src/repro_torch/kernels/int8_matmul/csrc/int8_matmul.cu",
            replaces="src/repro/kernels/int8_matmul/kernel.py:39",
            on_main_path=True, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library_note="torch._int_mm on the same codes: the int32 "
                         "product without the scaled epilogue")

  for m, k, n in shapes:
    for k_terms in (1, 2):
      code_cols = n // 2 if k_terms == 1 else n
      codes = dev(rng.randint(0, 256 if k_terms == 1 else 128,
                              (k, code_cols)).astype(np.uint8))
      scale = dev(rng.uniform(1e-3, 1e-1, n).astype(np.float32))
      for dtype in (torch.float32, torch.bfloat16):
        x = _randn(rng, (m, k), dtype)
        got = p2_kernel.pow2_matmul(x, codes, scale, k_terms)
        want = p2_ref.pow2_matmul_ref(x, codes, scale, k_terms)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        if not err <= 1e-5 * top:
          raise AssertionError(f"K4 differs from its plain version at "
                               f"{(m, k, n)}, k={k_terms}: {err} (max |out| "
                               f"{top})")
        ms = cuda_ms(lambda: p2_kernel.pow2_matmul(x, codes, scale,
                                                   k_terms))
        plain_ms = cuda_ms(lambda: p2_ref.pow2_matmul_ref(
            x, codes, scale, k_terms), inner=2)
        w_dense = _randn(rng, (k, n), torch.bfloat16)
        x_dense = x.to(torch.bfloat16)
        dense_ms = cuda_ms(lambda: torch.matmul(x_dense, w_dense))
        n_bytes = (m * k * x.element_size() + codes.numel() + n * 4
                   + m * n * 4)
        peak = PEAK_BF16_PER_S if dtype == torch.bfloat16 else PEAK_FP32_PER_S
        b_ms, b_by = bound_ms(n_bytes, 2 * m * n * k, peak)
        log(f"[K4] M={m} K={k} N={n}, k={k_terms}, "
            f"{str(dtype).split('.')[-1]} x, {p2_kernel.path(m, dtype)} "
            f"path: max_abs_err {err:.3g} (max "
            f"|out| {top:.3g}, tolerance 1e-5 of it); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
            f"{n_bytes / 1e6:.2f} MB, {2 * m * n * k / 1e9:.3f} GFLOP at "
            f"{peak / 1e12:.0f} TFLOP/s); library: none; yardstick, not the "
            f"same function: dense bf16 torch.matmul {dense_ms:.4f} ms")
        if (m, k_terms, dtype) == (max(CODEC_MS), 2, torch.bfloat16):
          results["pow2_matmul"] = dict(
              name="pow2_matmul (K4)", route="cuda",
              source="src/repro_torch/kernels/pow2_matmul/csrc/"
                     "pow2_matmul.cu",
              replaces="src/repro/kernels/pow2_matmul/kernel.py:73",
              on_main_path=True, max_abs_err=err, ms=ms, plain_ms=plain_ms,
              bound_ms=b_ms, bound_by=b_by, library_ms=None,
              library_note="no PyTorch call decodes pow2 codes; dense bf16 "
                           f"torch.matmul at the same shape: {dense_ms:.4f} "
                           "ms (a yardstick, not the same function)")
  log("[K4] library: none (no PyTorch call decodes pow2 codes)")
  return results


def _packed_leaves(tree, path=()):
  """(path, leaf) of every packed leaf of a pack_params tree."""
  if isinstance(tree, dict) and "codes" in tree:
    yield "/".join(path), tree
  elif isinstance(tree, dict):
    for k, v in tree.items():
      yield from _packed_leaves(v, path + (k,))


def _codec_weights(leaf, layer: int, pe_type: str):
  """One layer's rows of a packed stacked leaf, wrapped for K3 or K4."""
  from repro_torch.kernels.int8_matmul import ops as i8
  from repro_torch.kernels.pow2_matmul import ops as p2
  _, d_in, d_out = leaf["shape"]
  codes = leaf["codes"][layer * d_in:(layer + 1) * d_in]
  scale = leaf["scale"].reshape(-1)
  if pe_type == "INT8":
    return i8.Int8Weights(codes, scale, d_in, d_out)
  return p2.Pow2Weights(codes, scale, 1 if pe_type == "LightPE-1" else 2,
                        d_in, d_out)


def _codec_ops(pe_type: str):
  """(kernel op, plain op, relative tolerance) of a PE type's matmul."""
  from repro_torch.kernels.int8_matmul import ops as i8
  from repro_torch.kernels.pow2_matmul import ops as p2
  if pe_type == "INT8":
    return i8.int8_matmul, i8.int8_matmul_reference, 0.0
  return p2.pow2_matmul, p2.pow2_matmul_reference, 1e-5


def phase_codecs():
  """The codecs' main path: the full qwen3-0.6b (28 layers, bf16, seed 0)
  as the reference-shaped tree, packed under each PE type; every layer's
  six matmul leaves through K3 (INT8) or K4 (LightPE-1, -2) on seeded bf16
  activations of a decode token and a 512-token prompt, each output held
  against its plain version.  INT16 and INT4 have no kernel in the
  reference either: packed and counted, not multiplied."""
  import numpy as np
  import torch
  from repro_torch import convert
  from repro_torch.configs import get_config
  from repro_torch.kernels.int8_matmul import kernel as i8_kernel
  from repro_torch.kernels.pow2_matmul import kernel as p2_kernel
  from repro_torch.models import build_model
  from repro_torch.quant import (QuantPolicy, deploy_bytes_per_param,
                                 pack_params)
  torch.backends.cuda.matmul.allow_tf32 = False
  cfg = get_config("qwen3-0.6b")
  t0 = time.perf_counter()
  tree = convert.params_to_tree(cfg, build_model(cfg).init(0))
  torch.cuda.synchronize()
  n_weights = sum(tree["blocks"]["sub0"][g][leaf].numel()
                  for g, leaf in CODEC_LEAVES)
  log(f"[codecs] {cfg.name}: {_describe(cfg)}; seed-0 weights as the "
      f"reference-shaped tree in {time.perf_counter() - t0:.2f} s: "
      f"{n_weights:,} matmul weights in 6 leaves of "
      f"{tuple(tree['blocks']['sub0']['ffn']['wi'].shape)} and the like")
  rng = np.random.RandomState(14)
  d_ins = sorted({tree["blocks"]["sub0"][g][leaf].shape[1]
                  for g, leaf in CODEC_LEAVES})
  acts = {(m, d): _randn(rng, (m, d), torch.bfloat16)
          for m in CODEC_MS for d in d_ins}
  counters = {"int8_matmul": i8_kernel, "pow2_matmul": p2_kernel}
  for mod in counters.values():
    mod.reset_launch_counts()
  torch.cuda.synchronize()
  t_path = time.perf_counter()
  for pe_type in CODEC_PE_TYPES:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    packed = pack_params(tree, QuantPolicy(pe_type=pe_type))
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    leaves = dict(_packed_leaves(packed))
    if sorted(leaves) != sorted(f"blocks/sub0/{g}/{leaf}"
                                for g, leaf in CODEC_LEAVES):
      raise AssertionError(f"{pe_type} packed {sorted(leaves)}")
    n_bytes = sum(p["codes"].numel() * p["codes"].element_size()
                  + 4 * p["scale"].numel() for p in leaves.values())
    log(f"[codecs] {pe_type}: packed in {pack_s:.3f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{n_bytes / n_weights:.6f} bytes per weight with the scales "
        f"(deploy_bytes_per_param {deploy_bytes_per_param(pe_type)}); "
        f"fmt {sorted({p['fmt'] for p in leaves.values()})}")
    if pe_type not in ("INT8", "LightPE-1", "LightPE-2"):
      continue
    op, plain, tol = _codec_ops(pe_type)
    t0 = time.perf_counter()
    worst, calls = 0.0, 0
    for layer in range(cfg.n_layers):
      for group, name in CODEC_LEAVES:
        weights = _codec_weights(packed["blocks"]["sub0"][group][name],
                                 layer, pe_type)
        for m in CODEC_MS:
          x = acts[(m, weights.k)]
          got, want = op(x, weights), plain(x, weights)
          if got.shape != (m, weights.n):
            raise AssertionError(f"{pe_type} layer {layer} {group}/{name}: "
                                 f"shape {tuple(got.shape)}")
          err = float((got - want).abs().max() / want.abs().max())
          calls += 1
          if not err <= tol:
            raise AssertionError(f"{pe_type} layer {layer} {group}/{name} "
                                 f"M={m}: {err} of max |out| (tolerance "
                                 f"{tol})")
          worst = max(worst, err)
    torch.cuda.synchronize()
    log(f"[codecs] {pe_type}: {calls} matmuls ({cfg.n_layers} layers x "
        f"{len(CODEC_LEAVES)} leaves x M in {CODEC_MS}, bf16 activations) "
        f"through {'K3' if pe_type == 'INT8' else 'K4'}, each held against its "
        f"plain version: worst max |diff| / max |out| {worst:.3g} "
        f"(tolerance {tol:g}); {time.perf_counter() - t0:.2f} s with the "
        "checks")
    del packed, leaves
  torch.cuda.synchronize()
  launches = {name: mod.LAUNCHES[name] for name, mod in counters.items()}
  want = {"int8_matmul": cfg.n_layers * len(CODEC_LEAVES) * len(CODEC_MS),
          "pow2_matmul": 2 * cfg.n_layers * len(CODEC_LEAVES)
                         * len(CODEC_MS)}
  log(f"[codecs] the path took {time.perf_counter() - t_path:.2f} s; "
      f"launches {launches}")
  if launches != want:
    raise AssertionError(f"expected launches {want}, got {launches}")
  return launches


def phase_codecs_parity():
  """Full-width qwen3-0.6b in float32, depth cut to two layers: packed on
  the card and on the CPU under all six PE types.  Codes, scales, fmt and
  shape must be byte-equal; K3 on the card must equal the plain version
  on the CPU exactly, K4 within 1e-5 of the largest |out|."""
  import dataclasses
  import numpy as np
  import torch
  from repro_torch import convert
  from repro_torch.configs import get_config
  from repro_torch.models import build_model
  from repro_torch.quant import QuantPolicy, pack_params
  torch.backends.cuda.matmul.allow_tf32 = False
  cfg = dataclasses.replace(get_config("qwen3-0.6b"), dtype="float32",
                            n_layers=PARITY_LAYERS)
  gpu_params = build_model(cfg).init(0)
  cpu_params = build_model(cfg, device="cpu").from_state(
      {k: v.cpu() for k, v in gpu_params.state_dict().items()})
  trees = {"cuda": convert.params_to_tree(cfg, gpu_params),
           "cpu": convert.params_to_tree(cfg, cpu_params)}
  rng = np.random.RandomState(15)
  acts = {d: _randn(rng, (CODEC_PARITY_M, d), torch.bfloat16).cpu()
          for d in sorted({trees["cpu"]["blocks"]["sub0"][g][leaf].shape[1]
                           for g, leaf in CODEC_LEAVES})}
  worst = {}
  for pe_type in ("FP32",) + CODEC_PE_TYPES:
    t0 = time.perf_counter()
    packed = {dev: pack_params(tree, QuantPolicy(pe_type=pe_type))
              for dev, tree in trees.items()}
    secs = time.perf_counter() - t0
    g, c = (dict(_packed_leaves(packed[d])) for d in ("cuda", "cpu"))
    if pe_type == "FP32":
      same = all(torch.equal(packed["cuda"]["blocks"]["sub0"][grp][name]
                             .cpu(), packed["cpu"]["blocks"]["sub0"][grp]
                             [name]) for grp, name in CODEC_LEAVES)
    else:
      same = sorted(g) == sorted(c) and len(g) == len(CODEC_LEAVES) and all(
          g[p]["fmt"] == c[p]["fmt"] and g[p]["shape"] == c[p]["shape"]
          and torch.equal(g[p]["codes"].cpu(), c[p]["codes"])
          and torch.equal(g[p]["scale"].cpu().view(torch.int32),
                          c[p]["scale"].view(torch.int32)) for p in c)
    if not same:
      raise AssertionError(f"{pe_type}: the card's packed tree differs from "
                           "the CPU's")
    line = (f"[codecs-parity] {pe_type}: packed on the card and on the CPU "
            f"in {secs:.2f} s, codes and scales byte-equal")
    if pe_type in ("INT8", "LightPE-1", "LightPE-2"):
      op, _, tol = _codec_ops(pe_type)
      errs = []
      for layer in range(cfg.n_layers):
        for group, name in CODEC_LEAVES:
          wc = _codec_weights(c[f"blocks/sub0/{group}/{name}"], layer,
                              pe_type)
          wg = _codec_weights(g[f"blocks/sub0/{group}/{name}"], layer,
                              pe_type)
          x = acts[wc.k]
          want = op(x, wc)             # the plain version: a CPU tensor
          got = op(x.cuda(), wg).cpu()  # the kernel
          errs.append(float((got - want).abs().max() / want.abs().max()))
      worst[pe_type] = max(errs)
      line += (f"; {len(errs)} matmuls at M={CODEC_PARITY_M}, card kernel "
               f"vs CPU plain version: max |diff| / max |out| "
               f"{worst[pe_type]:.3g} (tolerance {tol:g})")
      if not worst[pe_type] <= tol:
        raise AssertionError(line)
    log(line)
  return worst


def _phase(name, fn, *args):
  """``fn(*args)``, its wall time printed as ``[time] name``."""
  t0 = time.perf_counter()
  out = fn(*args)
  log(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
  return out


def main() -> int:
  if not (ROOT / "src" / "repro_torch").is_dir():
    sys.exit("chip_smoke.py: src/repro_torch is not beside this script; "
             "run it from a checkout of the repository")
  sys.path.insert(0, str(ROOT / "src"))
  sys.path.insert(0, str(ROOT / "tests"))  # [K7-bwd]'s wkv_grad_scale
  import torch
  if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device is available")
  from repro_torch.core.workloads import get_network
  t0 = time.perf_counter()
  smi = phase_setup()
  phase_probe()
  kernels = phase_kernels()
  layers = get_network("resnet20")
  sweep, launches = phase_sweep(layers)
  phase_breakdown(layers)
  phase_parity(layers, sweep)
  poly = phase_poly(layers, sweep, smi)
  phase_poly_parity(layers, poly)
  poly_backend = poly["backend"]
  del poly
  phase_coexplore_breakdown(phase_coexplore(smi))
  co_parity = phase_coexplore_parity()
  phase_coexplore_poly(poly_backend, smi)
  del poly_backend
  log(f"[time] [setup] through [coexplore-poly]: "
      f"{time.perf_counter() - t0:.1f} s")
  t_search = time.perf_counter()
  guided = phase_search(smi)
  phase_search_hw(layers)
  phase_search_breakdown(layers)
  phase_resilience(layers, guided)
  del guided
  log(f"[resilience] [search] through [resilience]: "
      f"{time.perf_counter() - t_search:.1f} s")
  t_service = time.perf_counter()
  service = phase_service(layers)
  fleet = phase_fleet(layers, sweep, launches)
  phase_store_parity(layers)
  phase_workers(layers, sweep)
  phase_workers_trace(layers)
  phase_resilience_perf()
  del sweep
  k1 = kernels["block_dominance_counts"]
  k1["launches_service"] = service["k1_launches"]
  k1["launches_fleet"] = fleet["k1_launches"]
  k1["max_abs_err"] = max(k1["max_abs_err"], float(service["k1_err"]),
                          float(fleet["k1_err"]))
  log(f"[resilience-perf] [service] through [resilience-perf]: "
      f"{time.perf_counter() - t_service:.1f} s")
  t_model = time.perf_counter()
  _reset_kernel_counts()
  accs = phase_accuracy(smi)
  phase_accuracy_profile(smi)
  model_sess = _poly_session()
  phase_fig10_11(accs, model_sess)
  phase_fig12(smi, model_sess)
  phase_accuracy_parity()
  phase_paper_figs(model_sess)
  del model_sess
  model_launches = _kernel_counts()
  log(f"[paper-figs] [accuracy] through [paper-figs]: "
      f"{time.perf_counter() - t_model:.1f} s; hand-kernel launches "
      f"{model_launches} (QAT and the supernet run convolutions, batch "
      "norm and fake quantization outside any of them; fig 12's joint "
      "front is a staircase)")
  t_serve = time.perf_counter()
  kernels.update(phase_attention_kernels())
  zoo_kernels = _phase("[K6] and [K5] at the zoo's heads", phase_attention_zoo)
  kernels["flash_attention"]["heads"] = zoo_kernels["K6"]
  kernels["quant_decode_attn"]["groups"] = zoo_kernels["K5"]
  launches.update(_phase("[serve]", phase_serve))
  _phase("[serve-parity]", phase_serve_parity)
  kernels.update(phase_wkv_kernel())
  launches.update(_phase("[serve-rwkv]", phase_serve_rwkv))
  _phase("[serve-rwkv-parity]", phase_serve_rwkv_parity)
  moe_launches = _phase("[serve-moe]", phase_serve_moe)
  kernels["flash_attention"]["launches_serve_moe"] = \
      moe_launches["flash_attention"]
  kernels["quant_decode_attn"]["launches_serve_moe"] = \
      moe_launches["quant_decode_attn"]
  _phase("[serve-moe-parity]", phase_serve_moe_parity)
  _phase("[serve-zoo]", phase_serve_zoo)
  _phase("[serve-zoo-parity]", phase_serve_zoo_parity)
  log(f"[time] [K6] through [serve-zoo-parity]: "
      f"{time.perf_counter() - t_serve:.1f} s")
  t_8b = time.perf_counter()
  k6 = kernels["flash_attention"]
  k5 = kernels["quant_decode_attn"]
  k6["cross"] = _phase("[K6-cross]", phase_k6_cross)
  whisper = _phase("[serve-whisper]", phase_serve_whisper, smi)
  k6["launches_serve_whisper"] = whisper["flash_attention"]
  k5["launches_serve_whisper"] = whisper["quant_decode_attn"]
  _phase("[serve-whisper-parity]", phase_serve_whisper_parity)
  jamba = _phase("[serve-jamba]", phase_serve_jamba, smi)
  k6["launches_serve_jamba"] = jamba["flash_attention"]
  k5["launches_serve_jamba"] = jamba["quant_decode_attn"]
  _phase("[serve-jamba-parity]", phase_serve_jamba_parity)
  log(f"[time] [K6-cross] through [serve-jamba-parity]: "
      f"{time.perf_counter() - t_8b:.1f} s")
  t_train = time.perf_counter()
  kernels.update(_phase("[K6-bwd]", phase_k6_backward))
  train_launches = _phase("[train]", phase_train, smi)
  launches["flash_attention_bwd"] = train_launches["flash_attention_bwd"]
  kernels["flash_attention"]["launches_train"] = \
      train_launches["flash_attention"]
  _phase("[train-parity]", phase_train_parity)
  _phase("[train-resume]", phase_train_resume)
  log(f"[train-resume] [K6-bwd] through [train-resume]: "
      f"{time.perf_counter() - t_train:.1f} s")
  t_zoo = time.perf_counter()
  olmo_launches = _phase("[train-olmo]", phase_train_olmo, smi)
  kernels["flash_attention"]["launches_train_olmo"] = \
      olmo_launches["flash_attention"]
  kernels["flash_attention_bwd"]["launches_train_olmo"] = \
      olmo_launches["flash_attention_bwd"]
  _phase("[train-moe]", phase_train_moe, smi)
  for arch, changes in TRAIN_PARITY_ZOO:
    _phase(f"[train-parity] {arch}", phase_train_parity, arch,
           "train-parity", changes)
  log(f"[train-parity] [train-olmo] through the zoo's [train-parity]: "
      f"{time.perf_counter() - t_zoo:.1f} s")
  t_rwkv = time.perf_counter()
  kernels.update(phase_k7_backward())
  rwkv_launches = _phase("[train-rwkv]", phase_train_rwkv, smi)
  launches["wkv6_bwd"] = rwkv_launches["wkv6_bwd"]
  kernels["wkv6"]["launches_train_rwkv"] = rwkv_launches["wkv6"]
  phase_train_parity("rwkv6-1.6b", "train-rwkv-parity")
  log(f"[train-rwkv-parity] [K7-bwd] through [train-rwkv-parity]: "
      f"{time.perf_counter() - t_rwkv:.1f} s")
  kernels.update(phase_codec_kernels())
  launches.update(phase_codecs())
  phase_codecs_parity()
  for name, entry in kernels.items():
    entry["launches"] = launches[name]
  log(f"[done] {time.perf_counter() - t0:.1f} s; each kernel held against "
      "its plain version on the card, with its launches during its path's "
      "run (K1, K2: the sweep; K5, K6: the first serve run, and in the "
      "first [serve-moe] run K5 "
      f"{kernels['quant_decode_attn']['launches_serve_moe']} and K6 "
      f"{kernels['flash_attention']['launches_serve_moe']} times, in "
      f"[serve-whisper]'s first run K6 {k6['launches_serve_whisper']} "
      f"(at S_q != S_k: its 6 cross-attention layers) and K5 "
      f"{k5['launches_serve_whisper']}, in [serve-jamba]'s K6 "
      f"{k6['launches_serve_jamba']} and K5 {k5['launches_serve_jamba']}; "
      "K6's "
      "backward: the [train] run, where K6 launched "
      f"{kernels['flash_attention']['launches_train']} times, and in "
      "[train-olmo] K6 "
      f"{kernels['flash_attention']['launches_train_olmo']} and its "
      f"backward {kernels['flash_attention_bwd']['launches_train_olmo']} "
      "times; K7: the first "
      "serve-rwkv run; K7's backward: the [train-rwkv] run, where K7 "
      f"launched {kernels['wkv6']['launches_train_rwkv']} times; K3, K4: "
      "the codecs run); on the co-exploration "
      f"path K1 launched {co_parity['k1_launches']} times in "
      f"[coexplore-parity] ({co_parity['n_chunks']} blocks), no kernel in "
      "[coexplore] (its joint front projects top1_err out: a staircase); "
      "guided search ranks on the host and launches none ([search]), K1 "
      "runs in [resilience]'s fused stream; on the service path K1 "
      f"launched {service['k1_launches']} times ([service]'s 3-D session), "
      f"on the fleet path {fleet['k1_launches']} times ([fleet]'s pooled "
      "sweep), each held there to its plain version:")
  log(json.dumps({"kernels": list(kernels.values())}))
  log(smi)
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      # repro: ignore[ROB003] the device line reports torch's own count
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
