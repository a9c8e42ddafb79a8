#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py                    # every phase, as a check
    python3 chip_smoke.py --phases kernels   # a subset, while iterating

Phases, in order, each printing one line:

  gpu      the card's name and power limit, as nvidia-smi reports them;
  build    builds the eleven kernel sources (sixteen kernels) from
           src/repro_torch/csrc, one nvcc each, all started together;
  kernels  holds each kernel against its plain PyTorch version on the card
           at its path's shapes (serving; for the four backward kernels,
           training at batch 8 x 512; the mLSTM scan at xlstm-125m's
           prefill, q [4,4,1024,384], chunk 256, f32, also from a state,
           and timed at the xlstm profile's 16 x 1024; the mLSTM scan's
           backward (#13b) at xlstm-125m's train shape, q [8,4,512,384],
           at [4,4,1024,384] and over one chunk, from a zero state and from
           a given one with the final carry's grads, timed at the train
           shape; the Mamba scan at
           jamba-v0.1-52b's, dt/x [4,1024,8192], N 16, timed also at the
           jamba profile's 16 x 1024; the Mamba scan's backward (#12b) at
           jamba-v0.1-52b's train shape, dt/dy [8,512,8192], N 16, chunk
           256, in f32 and bf16, from the zero state, from a given one
           with the final state's gradient and over 600 steps padded to
           768, timed in bf16 (a scan_bwd line with its times, bound and
           SFU floor); the SwiGLU backward #6 / #7 at jamba width, x/dy
           [4096,4096], F 14336, bf16, timed, and in f32 at 600 rows),
           in f32 and bf16 (the
           paged kernels also with int8 pools; the paged and backward
           attention kernels also at llama3.2-3b's head dim 128 with 24 / 8
           heads; the int8 kernels #10, #11 and the int8 pool write at the
           admission splice's tiles, the chunk append's gather and a decode
           tick, exactly), and times the kernel, the plain version and a
           PyTorch library yardstick for the same function where one call
           computes it (the port never calls it); flash attention, the
           fused SwiGLU forward and its backward run on the tensor cores
           in bf16 and on their SIMT kernels in f32, and are timed in both;
           flash attention also at jamba-v0.1-52b's 32 / 8 heads of 128,
           with a window in bf16; the dW kernel alone over the gradient
           kernel's scratch, and the whole FFN backward against the
           library's autograd through the same products; the split-KV
           flash-decode (#3) also at jamba-v0.1-52b's 32 / 8 heads of 128
           (checked in f32 and bf16, timed in bf16), #3 and #8 printing
           the split count each case used, and a second line of their
           device time with the split count forced to 2-16; the int8
           paged decode (#9) runs the same split kernel over int8 pools,
           checked also at gemma-2b's 8 / 1 heads of 256, and is in that
           line too; #1, #3, #6-#13, the int8 pool write and their
           yardsticks also on device time alone and with their host
           enqueue (``Timer``); #11 as the int8 chunk append calls it and
           #10 as the admission splice calls it, K and V in one launch;
           a scan_quant line has #12's, #10's and the pool write's times
           beside their bounds and #12's SFU floor; #4 and #5 also at
           gemma-2b's train shape (q/dO [8,8,512,256], k/v [8,1,512,256],
           causal; f32 and bf16, the SIMT kernels' 32-row tiles) beside
           SDPA's backward, and #3, #8 and #9 at granite-20b's decode shape
           (48 q heads on one kv head of 128: six head groups of 8; pools
           [2050,16,1,128]; bf16 and int8), a wide_groups line with their
           times, bounds (K/V bytes once) and library times; and the MoE
           family's shapes, a moe_shapes line: #1, #4 and #5 at
           mixtral-8x7b's window (q [1,32,4608,128], k/v [1,8,4608,128],
           causal, window 4096), #4 and #5 at qwen3-moe-30b-a3b's train
           shape (q [8,32,512,128], k/v [8,4,512,128]: G 8 on the bf16
           tensor cores), #3 over mixtral's ring after a wrap (k/v
           [16,4096,8,128], positions in ring order, window 4096);
  model    exanode-100m at full width in f32 with seeded weights: prefill
           and four decode ticks' logits, kernels on the card against the
           plain path on the CPU, over the dense cache and over paged pools
           in f32 and int8;
  serve    Runtime.create("exanode-100m", capacity=2048).engine(num_slots=16)
           serves 32 seeded requests in bf16, once cold as a warm-up and
           once warm on a fresh engine, with every kernel's launch counter
           zeroed just before the warm run and read just after;
  xlstm    xlstm-125m at full width with seeded weights: in f32, prefill
           logits of 2 prompts x 600 tokens (not a multiple of the 256
           chunk) and four decode ticks, the mLSTM kernel on the card
           against the plain path on the CPU; then
           Runtime.create("xlstm-125m", capacity=2048).engine(num_slots=16)
           serves the serve phase's 32 requests in bf16, cold and then warm
           with every launch counter zeroed just before, and fails unless
           mlstm_scan launched 9 times per prefill call;
  jamba    jamba-v0.1-52b at full width with seeded weights drawn on the
           card: in f32, a three-layer cut (mamba, mamba_moe, attn; about
           4.0 B parameters), prefill logits of 2 prompts x 600 tokens and
           four decode ticks, the kernels on the card against the plain
           path on the CPU; then one 8-layer period (about 13.3 B
           parameters) in bf16, Runtime.create(cfg, capacity=2048,
           param_dtype=bf16).engine(num_slots=16), serves the serve
           phase's 32 requests cold and then warm, every launch counter
           zeroed just before the warm run, and fails unless ssm_scan
           launched 7 times per prefill call and flash_attention,
           fused_ffn and decode_attention launched;
  dense    the dense family, qwen3-4b, gemma-2b and granite-20b: (a) each
           at full width cut to 2 layers, weights drawn on the card, in
           f32: prefill logits of 2 prompts x 600 tokens and four decode
           ticks over dense, paged and int8-paged KV, and one train step
           at batch 2 x 256 (loss, grads), the kernels on the card against
           the plain path on the CPU; (b) each served in bf16,
           Runtime.create(cfg, capacity=2048, param_dtype=bf16)
           .engine(num_slots=16), the serve phase's 32 requests over dense
           KV and the int8 paged pool, cold then warm, gemma-2b also
           once through the chunked-prefill scheduler: qwen3-4b at 12 of
           its 36 layers, gemma-2b at 6 of 18, granite-20b at 8 of 52
           (the time limit); (c) gemma-2b's
           bf16 training, 2 layers at batch 8 x 512, 20 steps, the loss
           falling; fails unless #4 / #5 ran at head dim 256, #3 / #8 / #9
           at G 48, and #2 in qwen3-4b's runs only;
  moe      the MoE family at full width, weights drawn on the card:
           qwen3-moe-30b-a3b (128 experts top-8) cut to 1 layer in f32
           against the CPU (prefill logits of 2 prompts x 600 tokens, decode
           ticks over dense, paged and int8 KV, a train step at 2 x 512,
           the routes recorded); cut to 4 of 48 layers in bf16 serving the
           serve phase's 32 requests over dense, paged and int8 KV, each
           twice on fresh engines with equal streams (the top-8 combine is
           a fixed-order sum), then the int8 pool through the scheduler at
           2 layers; 20 bf16 train steps of a 2-layer cut at 8 x 512;
           mixtral-8x7b (8 experts top-2, window 4096) cut to 4 of 32
           layers in bf16 serving the same requests twice on its dense
           ring buffer, and cut to 1 layer in f32 against the CPU at
           capacity 4608 with a 600-token and a 4200-token prompt (the
           prefill past the window, the ring rolled and wrapped), 16
           decode steps each; fails unless every check held, each run
           launched its kernels and #2 never launched;
  paged    the same 32 requests, those of 16-23 that are 256 tokens long
           opening with prompt 0's first 256 tokens, served dense,
           kv_layout="paged" and paged with kv_dtype="int8"
           (.engine(num_slots=16, block_size=16)), each cold and then warm;
           prints each run's figures and the share of token positions
           where paged matches dense and int8 matches paged; fails unless
           the int8 run launched #10 (admission splice) and the int8 pool
           write;
  sched    the chunked-prefill scheduler: in f32 at full width a 600-token
           prompt through model_chunk_prefill in chunks of 32 on dense,
           paged and int8 pools, logits on the card against the plain path
           on the CPU and the monolithic prefill; then exanode-100m at
           full width cut to 2 of its 12 layers, Runtime.create(cfg,
           capacity=2048, scheduler=True).engine(num_slots=16) with the
           reference's default knobs serves the paged phase's 32 requests
           in bf16, dense, paged and int8, cold and then warm, beside the
           monolithic engine's warm run of each layout at the same depth;
           fails unless no monolithic prefill ran, the pools
           drained and each layout's kernels launched (int8: the pool
           write and #11);
  train    exanode-100m at full width: in f32, one step's loss and every
           grad leaf with the kernels on the card against the plain path
           on the CPU, from the same seeded params and batch (2 x 512);
           then python -m repro_torch.launch.train's loop,
           Runtime.create("exanode-100m", shape_kind="train", seq_len=512),
           bf16 activations and f32 params, global batch 8, 20 cosine
           steps, every launch counter zeroed just before and read just
           after: per-step losses, step time p50, tokens/s and peak device
           memory; fails unless the loss falls and every kernel of the
           train path (flash forward and backward, fused SwiGLU forward
           and backward) launched;
  xlstm_train  xlstm-125m at full width: in f32, one step's loss and
           every grad leaf of one 4-layer period with the kernels on the
           card against the plain path on the CPU (batch 2 x 512); then
           for that period (4 of 12 layers: the time limit) python -m
           repro_torch.launch.train's loop, bf16 activations and f32
           params, batch 8 x 512, 20 cosine steps to peak lr 1e-3,
           every launch counter zeroed just before and read just after:
           losses, step time p50, tokens/s, peak memory; fails unless the
           loss falls and mlstm_scan and mlstm_scan_bwd launched; then
           torch.profiler over one more step: device time by group (mLSTM
           forward, mLSTM backward, cuBLAS, the rest: the eager sLSTM);
  jamba_train  jamba-v0.1-52b training at full width: in f32, one step's
           loss and every grad leaf of the jamba phase's three-layer cut
           (about 3.96 B parameters, drawn on the card), batch 1 x 600,
           the kernels on the card (#12 keeping its chunk starts, #12b,
           the flash and FFN backward kernels) against the plain path on
           the CPU; then python -m repro_torch.launch.train's loop over
           train_cut() (mamba, attn: 1,036,464,128 parameters), bf16
           activations and f32 params, batch 8 x 512, 20 cosine steps,
           every launch counter zeroed just before and read just after:
           losses, step time p50, tokens/s, peak memory, launches a step;
           fails unless the loss falls and ssm_scan, ssm_scan_bwd and the
           flash and FFN forward and backward kernels launched;
  ft       fault tolerance on one card, exanode-100m at full width on the
           serve cell: in f32 over dense, paged and int8 pools a clean
           run and one with scrub_every=1, health_every=4 and FT_PLAN (a
           retried transient fault, a retry exhaustion that evacuates in
           place, a KV and a params bit flip, each detected by the next
           scrub and its streams replayed), the streams equal but for
           printed divergences that are near-ties (top-2 margin <= 2e-3
           on the port's own path) or the greedy token of the request's
           replay path (``near_ties``); the plan in bf16 on the int8
           pool beside a clean and a scrubbed run (share of equal
           streams, ITL p50 with and without the scrub); an engine
           snapshot after 40 ticks through a file into a fresh engine;
           python -m repro_torch.launch.train, 4 bf16
           steps saving every 2, restarted twice from its checkpoints with
           equal losses; the time of one scrub of the full int8 pool, a
           params fingerprint (exanode-100m, gemma-2b) and a health check;
           fails if a run without a fault plan evacuated (so does every
           serve run) or a kernel of the path never launched.

  train_profile  torch.profiler over three more bf16 train steps: device
           time per step by kernel group and the device's idle share.
  xlstm_profile  where an xlstm-125m bf16 prefill (16 x 1024) and a decode
           tick (16 slots) spend their time: host wall of one mLSTM and one
           sLSTM layer, and torch.profiler over the whole prefill call and
           8 ticks (device time by kernel group, kernels launched, idle
           share against the unprofiled wall).
  sched_profile  where a scheduler tick spends its time on each layout:
           the unprofiled wall of 8 mixed ticks of the sched phase's
           serving, and torch.profiler over 8 more (device time by kernel
           group, kernels a tick, idle share).

  jamba_profile  where a bf16 jamba-v0.1-52b period spends a 16 x 1024
           prefill call and a decode tick (16 slots): torch.profiler by
           kernel group, device kernels launched, idle share against the
           unprofiled wall.

One more phase runs only when named: int8_cpu (the int8 pool's token
agreement on the card and through the plain versions on the CPU).

Then a line of each phase's wall seconds, one JSON line {"kernels":
[...]} and, last, {"ok": true, "device": ...}.  Any failed check raises
before the last line.  Without a CUDA
device, or without the repository beside it, the script fails.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import subprocess
import sys
import time
from pathlib import Path

PHASES = ("kernels", "model", "serve", "paged", "sched", "xlstm", "jamba",
          "dense", "moe", "train", "xlstm_train", "jamba_train", "ft",
          "train_profile",
          "xlstm_profile",
          "sched_profile", "jamba_profile")                      # the build always runs

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s, bf16 tensor-core FLOP/s
# and f32 FLOP/s outside the tensor cores (f32 work in f32: TF32 would
# round it).  "tfloat32" is the TF32 tensor-core rate: the bound of #13,
# whose f32 products run there (3xTF32, so its own work is 3x the FLOPs).
# Rates assume the full 700 W power limit.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tfloat32": 494.7e12}
# Exponentials (MUFU ex2) a clock an SM on compute capability 9.0 (CUDA C
# Programming Guide, arithmetic instruction throughput: exp2f); #12's SFU
# floor
SFU_PER_CLOCK = 16

# Tolerances: the reference's own (tests/test_kernels.py,
# tests/test_paged.py).  Backward kernels: in f32 the reference's grad
# tolerances (tests/test_kernels.py:115-180: flash 2e-4, FFN 1e-4); in
# bf16 its forward ones (flash 2e-2, FFN 3e-2), since kernel and plain
# version both accumulate in f32 and round the grads to bf16 once.  The
# FFN weight grads sum over all N rows, where the reference's tests had
# <= 256: their f32 tolerance is scaled by sqrt(N / 256) (``dw_tol``; the
# f32 rounding of an N-term sum grows as sqrt(N)).  Those bounds are
# absolute as well as relative, so where grads are small they could pass
# a zeroed or badly wrong grad: the backward kernels are also held to
# ||got - want|| / ||want|| <= BWD_REL_TOL, which scales with the values.
# Kernel and plain version round the same f32 sums once, so in bf16 the
# relative difference is below one bf16 step (2^-8); the bf16 FFN forward
# and dx kernels also round their [N, F] intermediate (h; dg, du) to bf16
# once between their two products, where the plain versions keep it in
# f32: about 2.5e-3 relative, still under the step.
TOL = {"flash_attention": {"float32": 2e-5, "bfloat16": 2e-2},
       "fused_ffn": {"float32": 1e-5, "bfloat16": 3e-2},
       "decode_attention": {"float32": 2e-5, "bfloat16": 2e-2},
       "paged_decode_attention": {"float32": 1e-5, "bfloat16": 2e-2},
       "paged_decode_attention_q8": {"float32": 1e-5, "bfloat16": 2e-2},
       "flash_attention_bwd_dq": {"float32": 2e-4, "bfloat16": 2e-2},
       "flash_attention_bwd_dkv": {"float32": 2e-4, "bfloat16": 2e-2},
       "fused_ffn_bwd_dx": {"float32": 1e-4, "bfloat16": 3e-2},
       "fused_ffn_bwd_dw": {"float32": 1e-4, "bfloat16": 3e-2},
       "mlstm_scan": {"float32": 2e-4},
       # the Mamba scan: the reference's kernel tolerance
       # (tests/test_kernels.py:84-85, 5e-5) on y and the final h; with
       # x, B and C in bf16 both sides read the same bf16 values into f32
       # and run the same f32 recurrence, so the f32 bound holds there too
       "ssm_scan": {"float32": 5e-5, "bfloat16": 5e-5},
       # the int8 kernels compute what their plain versions compute, with
       # the same f32 roundings: exact
       "quantize_int8": {"float32": 0.0},
       "dequantize_int8": {"float32": 0.0},
       "quantized_block_write": {"float32": 0.0}}
BWD_REL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# The mLSTM scan (f32 only): the reference's kernel tolerance
# (tests/test_kernels.py:69, 2e-4) on y and on the final carry, and
# ||err|| / ||want|| <= 1e-4 on each, as tests/test_torch_kernels.py holds it.
MLSTM_REL_TOL = 1e-4
# The mLSTM scan's backward (#13b, f32 only) against its plain version:
# every element within MLSTM_BWD_TOL of its output's largest value, and
# ||err|| / ||want|| <= BWD_REL_TOL["float32"] per output, as the flash
# backward's entries.  Not atol + rtol per element: dk and df_log are sums
# of large terms that cancel, where the plain version's own f32 rounding
# reaches 0.46x a 1e-3 atol + rtol against f64 at dh 384
# (tests/test_torch_kernels.py); their norms agree to ~3e-6.
MLSTM_BWD_TOL = 1e-4
# The Mamba scan's backward (#12b) against its plain version, each output:
# every element within SSM_BWD_TOL x max |want| and ||err|| / ||want||
# within it.  f32 outputs (ddt, dA, dh0, and dx, dB, dC with f32
# activations): 1e-4, as #13b; both sides rebuild the states from the
# forward kernel's kept starts, the kernel with ex2.approx (2 ulp).  The
# bf16 outputs (dx, dB, dC with bf16 activations) are rounded once from
# f32 sums taken in another order: a bf16 step, BWD_REL_TOL["bfloat16"].
SSM_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
MODEL_LOGITS_TOL = 1e-3
# The train phase's f32 step against the CPU: the reference's fast-path
# bounds (tests/test_train_fastpath.py:71-76), atol + rtol.  At full width
# the RMS grad element is about 3e-4, below that atol, so each leaf is also
# held to ||g_cuda - g_cpu|| / ||g_cpu|| <= TRAIN_GRAD_REL_TOL.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_GRAD_REL_TOL = 1e-4, 1e-3, 1e-4
# The bf16 run's mean loss over its last 5 of 20 steps must be this far
# below the mean over its first 5.  The reference gates its smoke run
# (64 x 256 widths, lr 3e-3, 30 steps) at 0.2 (tests/test_train_serve.py:
# 39).  At full width, with the launcher's default peak lr of 3e-4 and a
# 2-step warmup, the CPU rehearsal of this run (plain versions, bf16
# activations) fell by 0.0677 (10.8630 -> 10.7952), with single steps
# scattered by up to 0.04; at peak lr 3e-3 it rose.  The gate is half the
# rehearsal's drop.
TRAIN_LOSS_DROP = 0.03
# The int8 pool's greedy tokens must equal the bf16 paged run's on this
# share of token positions.  The reference's own gate is 0.95
# (BENCH_serve.json "quantized", CPU smoke runs with short streams).  At
# full width with seeded random weights and 64-token free-running streams
# in bf16, an NVIDIA H100 80GB HBM3 at 700 W gives 0.3247, and on the first
# 8 requests the plain versions on the CPU give 0.5371 where the card gives
# 0.5957 (--phases int8_cpu; PERF.md): the shortfall is the int8 cache's
# rounding flipping near-tied tokens, after which a stream diverges, not
# the kernel, whose logits the model phase holds within 1e-3 of the plain
# path.  A broken int8 path would match on about 1/64 (the prefill token).
INT8_MATCH_MIN = 0.25
# kernel -> (source in this repository, the TPU kernel it replaces)
SOURCES = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:67"),
    "fused_ffn": ("src/repro_torch/csrc/fused_ffn.cu",
                  "src/repro/kernels/fused_ffn.py:50"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:28"),
    "paged_decode_attention": ("src/repro_torch/csrc/paged_attention.cu",
                               "src/repro/kernels/paged_attention.py:75"),
    "paged_decode_attention_q8": ("src/repro_torch/csrc/paged_attention.cu",
                                  "src/repro/kernels/paged_attention.py:92"),
    "flash_attention_bwd_dq": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                               "src/repro/kernels/flash_attention.py:145"),
    "flash_attention_bwd_dkv": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                "src/repro/kernels/flash_attention.py:180"),
    "fused_ffn_bwd_dx": ("src/repro_torch/csrc/fused_ffn_bwd.cu",
                         "src/repro/kernels/fused_ffn.py:108"),
    "fused_ffn_bwd_dw": ("src/repro_torch/csrc/fused_ffn_bwd.cu",
                         "src/repro/kernels/fused_ffn.py:131"),
    "mlstm_scan": ("src/repro_torch/csrc/mlstm_scan.cu",
                   "src/repro/kernels/mlstm_scan.py:21"),
    # #13b, the backward of #13: the reference has no Pallas backward and
    # differentiates its jnp chunk math (src/repro/models/ssm.py:234)
    "mlstm_scan_bwd": ("src/repro_torch/csrc/mlstm_scan_bwd.cu",
                       "src/repro/kernels/mlstm_scan.py:21"),
    "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:32"),
    # #12b, the backward of #12: the reference has no Pallas backward and
    # differentiates its jnp chunk body (src/repro/models/ssm.py:94)
    "ssm_scan_bwd": ("src/repro_torch/csrc/ssm_scan_bwd.cu",
                     "src/repro/kernels/ssm_scan.py:32"),
    "quantize_int8": ("src/repro_torch/csrc/quant.cu",
                      "src/repro/kernels/quant.py:39"),
    "dequantize_int8": ("src/repro_torch/csrc/quant.cu",
                        "src/repro/kernels/quant.py:48"),
    # the int8 pool write runs #10's row math; it computes the reference's
    # jnp write, src/repro/models/attention.py:378 _quantized_block_write
    "quantized_block_write": ("src/repro_torch/csrc/quant.cu",
                              "src/repro/kernels/quant.py:39"),
}
TRAIN_KERNELS = ("flash_attention", "fused_ffn", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "fused_ffn_bwd_dx",
                 "fused_ffn_bwd_dw")
XLSTM_TRAIN_KERNELS = ("mlstm_scan", "mlstm_scan_bwd")
JAMBA_TRAIN_KERNELS = ("ssm_scan", "ssm_scan_bwd") + TRAIN_KERNELS


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Per-launch CUDA-event timing with L2 flushed between launches (the
    serving path meets weights and caches cold: its working set is many
    times the 50 MB L2).  ``ms`` records its start event right after the
    flush is enqueued, so a wrapper's host time (checks, allocations,
    launch calls) that outlasts the flush on the device is timed with its
    kernels: the time a caller waits.  ``device_ms`` runs a spin kernel of
    SPIN cycles (~1.1 ms) between the flush and the start event, so that
    the host has enqueued the call before the device reaches it: the
    device's work alone.  ``host_us`` times the enqueue on the host."""

    SPIN = 2_000_000       # past the slowest wrapper's host time

    def __init__(self, torch, iters: int):
        self.torch, self.iters = torch, iters
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, spin: bool = False) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(self.iters):
            self.flush.zero_()
            if spin:
                torch.cuda._sleep(self.SPIN)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            total += e0.elapsed_time(e1)
        return total / self.iters

    def device_ms(self, fn) -> float:
        return self.ms(fn, spin=True)

    def host_us(self, fn) -> float:
        """Median host microseconds to enqueue ``fn`` (its Python wrapper,
        checks, allocations and launch calls) while the device is busy."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(self.iters):
            torch.cuda._sleep(self.SPIN)
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
        return 1e6 * sorted(ts)[len(ts) // 2]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(nb: int, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes, t_ops = nb / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def dw_tol(rows: int, dtype: str) -> float:
    tol = TOL["fused_ffn_bwd_dw"][dtype]
    return tol * max(1.0, (rows / 256) ** 0.5) if dtype == "float32" else tol


def check(name: str, got, want, dtype: str, what: str, tol=None) -> float:
    """Max |got - want|; raises unless every element is within
    tol + tol * |want| (numpy's allclose with atol = rtol = tol; tol
    defaults to ``TOL[name][dtype]``)."""
    tol = TOL[name][dtype] if tol is None else tol
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool((err <= tol + tol * want.abs()).all()) or \
            not bool(got.isfinite().all()):
        raise AssertionError(f"{name} {what} {dtype}: max abs err "
                             f"{float(err.max()):.3g} over tol {tol}")
    return float(err.max())


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| in f32 (inf where want is 0 and got not)."""
    got, want = got.float(), want.float()
    num, den = float((got - want).norm()), float(want.norm())
    return num / den if den else (0.0 if num == 0 else float("inf"))


def check_grad(name: str, got, want, dtype: str, what: str,
               tol=None) -> dict:
    """``check`` and the relative bound BWD_REL_TOL[dtype]; returns the max
    abs err, the relative err and the largest |want|."""
    err = check(name, got, want, dtype, what, tol)
    rel = rel_err(got, want)
    if not rel <= BWD_REL_TOL[dtype]:
        raise AssertionError(f"{name} {what} {dtype}: ||err|| / ||want|| "
                             f"{rel:.3g} over {BWD_REL_TOL[dtype]}")
    return dict(err=err, rel=rel, max=float(want.float().abs().max()))


def worst(*rs: dict) -> dict:
    """The larger err and rel of several ``check_grad`` results."""
    return {k: max(r[k] for r in rs) for k in rs[0]}


def kernels_phase(torch, timer) -> dict:
    """Each kernel against its plain version; returns the JSON entries
    (without ``launches``) keyed by kernel name."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ffn as ffn
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    out = {}

    # flash attention: prefill of 4 prompts x 1024 tokens, q in the
    # [B,S,H,D] -> [B,H,S,D] view the model passes, grouped K/V; bf16 runs
    # on the tensor cores (head dims 64 and 128), f32 on the SIMT kernel.
    # Exanode-100m's 12 / 4 heads of 64, then jamba-v0.1-52b's attention
    # layer, 32 / 8 heads of 128.
    flash = {}
    for arch, (B, S, H, KV, D) in (("exanode", (4, 1024, 12, 4, 64)),
                                   ("jamba", (4, 1024, 32, 8, 128))):
        q32 = randn(B, S, H, D).transpose(1, 2)
        k32 = randn(B, S, KV, D).transpose(1, 2)
        v32 = randn(B, S, KV, D).transpose(1, 2)
        errs = {}
        for dt in (f32, bf16):
            q, k, v = (t.to(dt) for t in (q32, k32, v32))
            o, lse = fa.flash_attention(q, k, v, causal=True)
            wo, wlse = ref.ref_attention(q, k, v, causal=True)
            name = str(dt).split(".")[1]
            errs[name] = check("flash_attention", o, wo, name,
                               f"{arch} causal")
            check("flash_attention", lse, wlse, "float32",
                  f"{arch} causal lse {name}")
        for S2, causal, window in ((1024, True, 256), (1000, False, 0)):
            for dt in (f32, bf16):
                q, k, v = (t[:, :, :S2].to(dt) for t in (q32, k32, v32))
                o, _ = fa.flash_attention(q, k, v, causal=causal,
                                          window=window)
                wo, _ = ref.ref_attention(q, k, v, causal=causal,
                                          window=window)
                name = str(dt).split(".")[1]
                check("flash_attention", o, wo, name,
                      f"{arch} S={S2} causal={causal} window={window}")
        q, k, v = (t.to(bf16) for t in (q32, k32, v32))
        flops = 4 * B * H * D * S * (S + 1) / 2            # causal pairs only
        b_ms, b_by = bound(nbytes(q, k, v, q) + B * H * S * 4, flops,
                           "bfloat16")

        def kern():
            return fa.flash_attention(q, k, v, causal=True)

        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
        flash[arch] = dict(
            shape=f"q [{B},{H},{S},{D}] k/v [{B},{KV},{S},{D}] causal bf16 "
                  f"(route {fa.route(bf16, D)})",
            max_abs_err=errs["bfloat16"], max_abs_err_f32=errs["float32"],
            ms=timer.ms(kern), device_ms=timer.device_ms(kern),
            host_us=timer.host_us(kern),
            ms_f32=timer.ms(lambda: fa.flash_attention(q32, k32, v32,
                                                       causal=True)),
            plain_ms=timer.ms(lambda: ref.ref_attention(q, k, v,
                                                        causal=True)),
            bound_ms=b_ms, bound_by=b_by, library_ms=timer.ms(library),
            library_device_ms=timer.device_ms(library),
            library_host_us=timer.host_us(library),
            library="torch.nn.functional.scaled_dot_product_attention")
        del q32, k32, v32, q, k, v
    out["flash_attention"] = dict(flash["exanode"],
                                  jamba_width=flash["jamba"])

    # fused SwiGLU: prefill rows (4 x 1024) and one decode tick (16 slots)
    D, Fd = 768, 2048
    w32 = [randn(D, Fd, scale=D ** -0.5), randn(D, Fd, scale=D ** -0.5),
           randn(Fd, D, scale=Fd ** -0.5)]
    entries = {}
    for N in (4096, 16):
        x32 = randn(N, D)
        errs = {}
        for dt in (f32, bf16):
            x, wg, wu, wd = (t.to(dt) for t in [x32] + w32)
            name = str(dt).split(".")[1]
            errs[name] = check("fused_ffn", ffn.swiglu_ffn(x, wg, wu, wd),
                               ref.ref_swiglu_ffn(x, wg, wu, wd), name,
                               f"N={N}")
        x, wg, wu, wd = (t.to(bf16) for t in [x32] + w32)
        b_ms, b_by = bound(nbytes(x, wg, wu, wd, x), 6 * N * D * Fd,
                           "bfloat16")
        entries[N] = dict(
            shape=f"x [{N},{D}] Wg/Wu [{D},{Fd}] Wd [{Fd},{D}] bf16",
            max_abs_err=errs["bfloat16"], max_abs_err_f32=errs["float32"],
            ms=timer.ms(lambda: ffn.swiglu_ffn(x, wg, wu, wd)),
            ms_f32=timer.ms(lambda: ffn.swiglu_ffn(x32, *w32)),
            plain_ms=timer.ms(lambda: ref.ref_swiglu_ffn(x, wg, wu, wd)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=timer.ms(lambda: torch.matmul(
                F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu), wd)),
            library="three torch.matmul + torch.nn.functional.silu")
    # jamba-v0.1-52b's width (d_model 4096: 4-row blocks; d_ff 14336) at
    # a decode tick, 600 ragged rows and a 4 x 1024 prefill, each checked
    # and timed in bf16; in f32 the tolerance is scaled by sqrt(F / 512)
    # (the F-term f32 sums' rounding grows as sqrt(F))
    D, Fd = 4096, 14336
    w32 = [randn(D, Fd, scale=D ** -0.5), randn(D, Fd, scale=D ** -0.5),
           randn(Fd, D, scale=Fd ** -0.5)]
    jamba = {}
    for N in (16, 600, 4096):
        x32 = randn(N, D)
        errs = {}
        for dt in (f32, bf16):
            name = str(dt).split(".")[1]
            x, wg, wu, wd = (t.to(dt) for t in [x32] + w32)
            tol = TOL["fused_ffn"][name] * (
                (Fd / 512) ** 0.5 if dt == f32 else 1.0)
            errs[name] = check(
                "fused_ffn", ffn.swiglu_ffn(x, wg, wu, wd),
                ref.ref_swiglu_ffn(x, wg, wu, wd), name,
                f"D={D} F={Fd} N={N}", tol)
        b_ms, b_by = bound(nbytes(x, wg, wu, wd, x), 6 * N * D * Fd,
                           "bfloat16")
        jamba[f"N{N}"] = dict(
            shape=f"x [{N},{D}] Wg/Wu [{D},{Fd}] Wd [{Fd},{D}] bf16",
            max_abs_err=errs["bfloat16"], max_abs_err_f32=errs["float32"],
            ms=timer.ms(lambda: ffn.swiglu_ffn(x, wg, wu, wd)),
            ms_f32=timer.ms(lambda: ffn.swiglu_ffn(x32, *w32)),
            plain_ms=timer.ms(lambda: ref.ref_swiglu_ffn(x, wg, wu, wd)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=timer.ms(lambda: torch.matmul(
                F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu), wd)))
        del x, wg, wu, wd
    del w32
    out["fused_ffn"] = dict(entries[4096], decode=entries[16],
                            jamba_width=jamba)

    # flash-decode: 16 slots against a 2048-entry cache, part empty, at
    # exanode-100m's 12 / 4 heads of 64, jamba-v0.1-52b's 32 / 8 of 128
    # and granite-20b's 48 / 1 of 128 (six head groups of 8)
    decode = {}
    for arch, (KV, G, D) in (("exanode", (4, 3, 64)), ("jamba", (8, 4, 128)),
                             ("granite", (1, 48, 128))):
        decode[arch] = decode_case(torch, timer, gen, B=16, T=2048, KV=KV,
                                   G=G, D=D)
    out["decode_attention"] = dict(decode["exanode"],
                                   jamba_width=decode["jamba"],
                                   granite_width=decode["granite"])
    out.update(paged_kernels(torch, timer))
    out.update(backward_kernels(torch, timer))
    for name, rows in moe_kernel_shapes(torch, timer).items():
        out[name].update(rows)
    out.update(mlstm_kernel(torch, timer))
    out.update(mlstm_bwd_kernel(torch, timer))
    out.update(quant_kernels(torch, timer))
    out.update(ssm_kernel(torch, timer))
    out.update(ssm_bwd_kernel(torch, timer))
    for name, row in ffn_bwd_jamba_width(torch, timer).items():
        out[name]["jamba_width"] = row
    return out


def decode_inputs(torch, gen, B: int, T: int, KV: int, G: int, D: int):
    """B slots against a T-entry cache with seeded lengths 64-T: (lens,
    kv_pos, pos, q, k, v), q/k/v f32 on the card."""
    lens = torch.randint(64, T + 1, (B,), generator=gen, device="cuda")
    t_idx = torch.arange(T, device="cuda")
    kv_pos = torch.where(t_idx[None] < lens[:, None], t_idx[None],
                         -1).to(torch.int32).contiguous()
    pos = (lens - 1).to(torch.int32)
    q, k, v = (torch.randn(*s, generator=gen, device="cuda")
               for s in ((B, KV * G, D), (B, T, KV, D), (B, T, KV, D)))
    return lens, kv_pos, pos, q, k, v


def split_sweep(torch, gpu: str, iters: int,
                counts=(2, 3, 4, 6, 8, 12, 16)) -> str:
    """The kernels phase's second line: device-only time
    (``Timer.device_ms``) of the split kernels at the serve shapes in bf16
    (#3 at exanode-100m's and jamba-v0.1-52b's widths, #8, and #9 over
    the int8 pools with bf16 q) with the split count forced to each of
    ``counts``, beside the planner's own choice
    (``decode_attention.plan_splits``) and beside a contiguous read of the
    same valid K/V bytes (``torch.sum`` over that many bytes, read as
    bf16) on the same timer: what streaming those bytes costs after its
    L2 flush, whose 128 MB of zeros the reads must first write back."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    timer = Timer(torch, iters)
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for arch, (KV, G, D) in (("exanode", (4, 3, 64)), ("jamba", (8, 4, 128))):
        lens, kv_pos, pos, q, k, v = decode_inputs(torch, gen, 16, 2048, KV,
                                                   G, D)
        q, k, v = (t.to(bf16) for t in (q, k, v))
        cases[f"decode_attention {arch}"] = (
            functools.partial(da.decode_attention, q, k, v, kv_pos, pos),
            16 * KV, 2 * int(lens.sum()) * KV * D, bf16)
    c = paged_case(torch, KV=4, G=3, D=64, seed=3)
    a = (c["q"].to(bf16), c["kp"].to(bf16), c["vp"].to(bf16), c["pos_pool"],
         c["table"], c["pos"])
    elems = 2 * c["blocks"] * c["bs"] * 4 * 64
    cases["paged_decode_attention"] = (
        functools.partial(pa.paged_decode_attention, *a), 16 * 4, elems,
        bf16)
    cases["paged_decode_attention_q8 (int8 pools)"] = (
        functools.partial(pa.paged_decode_attention_q8, c["q"].to(bf16),
                          c["kq"], c["vq"], c["ks"], c["vs"], c["pos_pool"],
                          c["table"], c["pos"]), 16 * 4, elems, torch.int8)
    saved = da.TARGET_BLOCKS, da.SPLIT_ENTRIES
    parts = []
    try:
        for name, (fn, rows, elems, dtype) in cases.items():
            times = {"planner": timer.device_ms(fn)}
            for n in counts:
                da.TARGET_BLOCKS, da.SPLIT_ENTRIES = n * rows, 1 << 30
                da.plan_splits.cache_clear()
                times[n] = timer.device_ms(fn)
            da.TARGET_BLOCKS, da.SPLIT_ENTRIES = saved
            da.plan_splits.cache_clear()
            # the same bytes read as bf16 (PyTorch's int8 sum is no
            # streaming read: it widens every byte)
            x = torch.ones(elems, dtype=dtype, device="cuda").view(bf16)
            read = timer.device_ms(x.sum)
            parts.append(f"{name}: " + ", ".join(
                f"{n} {ms:.5f}" for n, ms in times.items())
                + f"; a read of its {nbytes(x) / 1e6:.1f} MB of valid K/V "
                  f"{read:.5f}")
            del x
    finally:
        da.TARGET_BLOCKS, da.SPLIT_ENTRIES = saved
        da.plan_splits.cache_clear()
    return ("split_sweep: device ms by forced split count, bf16, 16 slots, "
            "2048 entries; " + "; ".join(parts) + f" [{gpu}]")


def decode_case(torch, timer, gen, B: int, T: int, KV: int, G: int,
                D: int) -> dict:
    """#3 at B slots against a T-entry cache with seeded lengths 64-T:
    checked in f32 and bf16 against the plain version, timed in bf16 on
    all three timers beside the plain version and SDPA with the mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    H = KV * G
    lens, kv_pos, pos, q32, k32, v32 = decode_inputs(torch, gen, B, T, KV,
                                                     G, D)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dt) for t in (q32, k32, v32))
        name = str(dt).split(".")[1]
        errs[name] = check(
            "decode_attention", da.decode_attention(q, k, v, kv_pos, pos),
            ref.ref_decode_attention(q, k, v, kv_pos, pos), name,
            f"part-empty cache, {H} / {KV} heads of {D}")
    q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
    # the function reads only the valid K/V rows (every valid entry is at
    # or before its slot's pos): count those, not the whole cache, and
    # once, however many head groups read them
    valid = int(lens.sum())
    b_ms, b_by = bound(nbytes(q, kv_pos, pos, q)
                       + 2 * valid * KV * D * k.element_size(),
                       4 * H * D * valid, "bfloat16")
    mask = ((kv_pos >= 0) & (kv_pos <= pos[:, None]))[:, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    groups = da.head_groups(G)
    splits, split_len = da.plan_splits(B * KV * groups, T,
                                       da.tile_entries(D, k.element_size()))

    def kern():
        return da.decode_attention(q, k, v, kv_pos, pos)

    def library():
        return F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True)
    return dict(
        shape=f"q [{B},{H},{D}] k/v [{B},{T},{KV},{D}] bf16, "
              f"{valid} of {B * T} entries valid; {splits} splits of "
              f"{split_len}, {groups} head group{'s' if groups > 1 else ''}",
        splits=splits, split_len=split_len,
        max_abs_err=errs["bfloat16"], max_abs_err_f32=errs["float32"],
        ms=timer.ms(kern), device_ms=timer.device_ms(kern),
        host_us=timer.host_us(kern),
        plain_ms=timer.ms(lambda: ref.ref_decode_attention(q, k, v, kv_pos,
                                                           pos)),
        bound_ms=b_ms, bound_by=b_by, library_ms=timer.ms(library),
        library_device_ms=timer.device_ms(library),
        library_host_us=timer.host_us(library),
        library="torch.nn.functional.scaled_dot_product_attention")


def sfu_floor_ms(torch, exps: float) -> float:
    """The least time the card's special-function units take for ``exps``
    exponentials: SFU_PER_CLOCK a clock an SM, at the card's SM count and
    its highest SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    mhz = float(out.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 1e3 * exps / (SFU_PER_CLOCK * sms * mhz * 1e6)


def ssm_kernel(torch, timer) -> dict:
    """#12 against its plain version at jamba-v0.1-52b's full-width
    prefill shape, 4 prompts x 1024 tokens: dt [4,1024,8192] f32 and A
    [8192,16] f32 with x [4,1024,8192] and B/C [4,1024,16] in f32 and in
    bf16 (the serving dtype; timed there), the reference test's inputs
    (dt = softplus(N(0,1)), A = -exp(N(0,1))); y and the final h.  Timed
    on the ``ms``, ``device_ms`` and ``host_us`` timers there and at the
    jamba profile's 16 x 1024 (bf16).  The bound counts each input read
    once and y, h written once, and the operations these inputs need at
    f32's rate: per (b, t, d, n) the exp (one operation), dt·A, a·h,
    bx·B, the add and the FMA of y (two), and per (b, t, d) dt·x.  Beside
    it, on the ``scan_quant:`` line only, the SFU floor: one exp per
    (b, t, d, n) on the special-function units (``sfu_floor_ms``).  No
    single PyTorch call computes a selective scan, so there is no library
    yardstick."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as sk
    gen = torch.Generator(device="cuda").manual_seed(12)
    S, Di, N = 1024, 8192, 16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def inputs(B, dtype):
        dt = torch.nn.functional.softplus(randn(B, S, Di))
        A = -torch.exp(randn(Di, N))
        return (dt, randn(B, S, N).to(dtype), randn(B, S, N).to(dtype),
                randn(B, S, Di).to(dtype), A)

    errs = {}
    B = 4
    args32 = inputs(B, torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        args = args32[:1] + tuple(t.to(dtype) for t in args32[1:4]) \
            + args32[4:]
        y, h = sk.ssm_scan(*args)
        wy, wh = ref.ref_ssm_scan(*args)
        name = str(dtype).split(".")[1]
        errs[name] = max(check(sk.NAME, y, wy, name, "y"),
                         check(sk.NAME, h, wh, name, "h"))
    del args32, y, h, wy, wh

    def case(B: int) -> dict:
        args = inputs(B, torch.bfloat16)
        y, h = sk.ssm_scan(*args)
        flops = 7 * B * S * Di * N + B * S * Di
        b_ms, b_by = bound(nbytes(*args, y, h), flops, "float32")

        def kern():
            return sk.ssm_scan(*args)
        out = dict(
            shape=f"dt [{B},{S},{Di}] f32, x [{B},{S},{Di}] and B/C "
                  f"[{B},{S},{N}] bf16, A [{Di},{N}] f32 -> y f32, h "
                  f"[{B},{Di},{N}] f32 (a {B} x {S} jamba prefill, one "
                  f"layer)",
            ms=timer.ms(kern), device_ms=timer.device_ms(kern),
            host_us=timer.host_us(kern),
            plain_ms=timer.ms(lambda: ref.ref_ssm_scan(*args)),
            bound_ms=b_ms, bound_by=b_by, flops_counted=flops,
            exps_counted=B * S * Di * N)
        return out

    entry = case(4)
    entry.update(
        max_abs_err=errs["bfloat16"], max_abs_err_f32=errs["float32"],
        library_ms=None,
        library="none: no single PyTorch call computes a selective scan",
        jamba_profile_shape=case(16))
    return {sk.NAME: entry}


def check_ssm_bwd(got, want, what: str) -> tuple[float, float]:
    """Max |got - want| and ||got - want|| / ||want|| of one #12b output;
    raises unless every element is finite and within SSM_BWD_TOL of max
    |want|, and the relative error within it too (the tolerance of the
    output's dtype)."""
    tol = SSM_BWD_TOL[str(want.dtype).split(".")[1]]
    got, want = got.float(), want.float()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    rel = rel_err(got, want)
    if not bool(got.isfinite().all()) or not err <= tol * scale \
            or not rel <= tol:
        raise AssertionError(
            f"ssm_scan_bwd {what}: max abs err {err:.3g} over {tol} x max "
            f"|want| {scale:.3g}, or ||err|| / ||want|| {rel:.3g} over {tol}")
    return err, rel


def ssm_bwd_kernel(torch, timer) -> dict:
    """#12b, the Mamba scan's backward, against ``ref_ssm_scan_bwd`` on
    the card at jamba-v0.1-52b's train shape: dt [8,512,8192] f32, A
    [8192,16], chunk 256 (two chunks), x and B/C in f32 and in bf16 (the
    train path's dtype), the kernel phase's recipe (dt = softplus(N(0,1)),
    A = -exp(N(0,1))) and N(0, 1) cotangents, both sides fed the states #12
    kept at the chunk starts: from the zero state, from a given state with
    the final state's gradient, and over a padded length (600 steps in 768
    with dt = 0 and dy = 0 past 600, as the mixer pads: dx, dB and dC must
    be zero there).  Timed in bf16 from the zero state on the ``ms``,
    ``device_ms`` and ``host_us`` timers.

    The bound counts each input (dt, x, B, C, A, the kept starts, dy) and
    output (ddt, dx, dB, dC, dA) once, and the operations the function
    needs at f32's rate: per (b, t, d, n) the rebuilt a_t and h_{t-1} (the
    exp, dt·A, bx·B, the FMA of h: 5), the adjoint's FMA and a·g (3), and
    the terms of dA (4), ddt (4), dx, dB and dC (2 each) with their sums;
    per (b, t, d) dt·x and dx's product.  The SFU floor of one exp an
    element is on the ``scan_bwd:`` line.  No single PyTorch call computes
    it: no library yardstick."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as sk
    gen = torch.Generator(device="cuda").manual_seed(13)
    B, S, Di, N, L = 8, 512, 8192, 16, 256

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def inputs(S, dtype):
        dt = torch.nn.functional.softplus(randn(B, S, Di))
        return (dt, randn(B, S, N).to(dtype), randn(B, S, N).to(dtype),
                randn(B, S, Di).to(dtype), -torch.exp(randn(Di, N)))

    errs, rels = {}, {}

    def case(what, ins, h0=None, dh=None, dy=None):
        _, _, states = sk.ssm_scan(*ins, h0, chunk=L, keep=True)
        dy = randn(*ins[0].shape) if dy is None else dy
        got = sk.ssm_scan_bwd(*ins, h0, states, dy, dh=dh, chunk=L)
        want = ref.ref_ssm_scan_bwd(*ins, h0, states, dy, dh=dh, chunk=L)
        for name, g, w in zip(("ddt", "dx", "dB", "dC", "dA", "dh0"), got,
                              want):
            if w is not None:
                key = f"{what} {name}"
                errs[key], rels[key] = check_ssm_bwd(g, w, key)
        return states, dy, got

    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        case(f"{name} from zero", inputs(S, dtype))
        case(f"{name} from a state", inputs(S, dtype),
             h0=randn(B, Di, N), dh=randn(B, Di, N))
    cut, Sp = 600, 768
    ins = inputs(Sp, torch.bfloat16)
    ins[0][:, cut:] = 0.0
    dy = randn(B, Sp, Di)
    dy[:, cut:] = 0.0
    _, _, pad = case("bf16 600 of 768 padded", ins, dy=dy)
    if any(bool(g[:, cut:].any()) for g in pad[1:4]):
        raise AssertionError("ssm_scan_bwd: dx, dB or dC non-zero on the "
                             "pad steps")
    del ins, dy, pad
    ins = inputs(S, torch.bfloat16)
    states, dy, got = case("bf16 timed", ins)
    nb = nbytes(*ins, states, dy, *got[:5])
    elems = B * S * Di * N
    flops = 22 * elems + 2 * B * S * Di
    b_ms, b_by = bound(nb, flops, "float32")

    def kern():
        return sk.ssm_scan_bwd(*ins, None, states, dy, chunk=L)
    return {sk.NAME_BWD: dict(
        shape=f"dt/dy [{B},{S},{Di}] f32, x [{B},{S},{Di}] and B/C "
              f"[{B},{S},{N}] bf16, A [{Di},{N}], chunk {L}, from the zero "
              f"state (a jamba train step's Mamba layer at 8 x 512)",
        max_abs_err=max(errs.values()), max_abs_err_by_output=errs,
        rel_err_by_output=rels,
        ms=timer.ms(kern), device_ms=timer.device_ms(kern),
        host_us=timer.host_us(kern),
        plain_ms=timer.ms(lambda: ref.ref_ssm_scan_bwd(
            *ins, None, states, dy, chunk=L)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library="none: no single PyTorch call computes a selective scan's "
                "backward",
        flops_counted=flops, bytes_counted=nb, exps_counted=elems)}


def ffn_bwd_jamba_width(torch, timer) -> dict:
    """#6 and #7 at jamba-v0.1-52b's train shape, x/dy [4096,4096] (8 x
    512 tokens), d_ff 14336, bf16 (the tensor-core route), against the
    plain backward and timed (``ms``, ``device_ms``, ``host_us``) beside
    the library's matmuls; and in f32 at the jamba_train phase's f32 step,
    600 rows (the SIMT kernels: dx in 4-row blocks at d_model 4096, dW in
    4-wide F tiles), dx's tolerance scaled by sqrt(F / 512) as the
    forward's at this width (the F-term f32 sums' rounding grows as
    sqrt(F)).  Bounds as ``backward_kernels``' rows."""
    from repro_torch.kernels import fused_ffn as ffn
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(14)
    N, D, Fd = 4096, 4096, 14336

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    w32 = [randn(D, Fd, scale=D ** -0.5), randn(D, Fd, scale=D ** -0.5),
           randn(Fd, D, scale=Fd ** -0.5)]
    args32 = [randn(600, D)] + w32 + [randn(600, D)]
    want = ref.ref_swiglu_ffn_bwd(*args32)
    f32_dx = check_grad(ffn.NAME_BWD_DX, ffn.swiglu_ffn_bwd_dx(*args32),
                        want[0], "float32", "jamba width f32 N=600",
                        TOL["fused_ffn_bwd_dx"]["float32"]
                        * (Fd / 512) ** 0.5)
    f32_dw = worst(*(check_grad(ffn.NAME_BWD_DW, g, w, "float32",
                                "jamba width f32 N=600", dw_tol(600,
                                                                "float32"))
                     for g, w in zip(ffn.swiglu_ffn_bwd_dw(*args32),
                                     want[1:])))
    del args32, want
    x, dy = randn(N, D).to(torch.bfloat16), randn(N, D).to(torch.bfloat16)
    wg, wu, wd = (t.to(torch.bfloat16) for t in w32)
    del w32
    want = ref.ref_swiglu_ffn_bwd(x, wg, wu, wd, dy)
    what = f"jamba width bf16 N={N}"
    dx_err = check_grad(ffn.NAME_BWD_DX,
                        ffn.swiglu_ffn_bwd_dx(x, wg, wu, wd, dy), want[0],
                        "bfloat16", what)
    dw_err = worst(*(check_grad(ffn.NAME_BWD_DW, g, w, "bfloat16", what)
                     for g, w in zip(ffn.swiglu_ffn_bwd_dw(x, wg, wu, wd,
                                                           dy), want[1:])))
    del want
    pairs = ffn.swiglu_ffn_bwd_grads(x, wg, wu, wd, dy)
    hi = [t[0] for t in pairs]

    def path_dx():
        return ffn.swiglu_ffn_bwd_dx(x, wg, wu, wd, dy)

    def dw():
        return ffn.swiglu_ffn_bwd_dw_tc(x, dy, *pairs)

    def lib_dx():
        g, u, dh = x @ wg, x @ wu, dy @ wd.t()
        sg = torch.sigmoid(g)
        dg = dh * u * (sg + g * sg * (1 - sg))
        return dg @ wg.t() + (dh * g * sg) @ wu.t()

    def lib_dw():
        return x.t() @ hi[0], x.t() @ hi[1], hi[2].t() @ dy

    shape = f"x/dy [{N},{D}] Wg/Wu [{D},{Fd}] Wd [{Fd},{D}] bf16"
    dx_b, dx_by = bound(nbytes(x, wg, wu, wd, dy, x, *pairs),
                        5 * 2 * N * D * Fd, "bfloat16")
    dw_b, dw_by = bound(nbytes(x, dy, *hi, wg, wu, wd), 3 * 2 * N * D * Fd,
                        "bfloat16")
    rows = {
        ffn.NAME_BWD_DX: dict(
            shape=f"{shape}; the gradient kernel and the dx kernel",
            max_abs_err=dx_err["err"], rel_err=dx_err["rel"],
            max_abs_err_f32_n600=f32_dx["err"], rel_err_f32_n600=f32_dx["rel"],
            ms=timer.ms(path_dx), device_ms=timer.device_ms(path_dx),
            host_us=timer.host_us(path_dx),
            plain_ms=timer.ms(lambda: ref.ref_swiglu_ffn_bwd(x, wg, wu, wd,
                                                             dy)),
            bound_ms=dx_b, bound_by=dx_by, library_ms=timer.ms(lib_dx),
            library_device_ms=timer.device_ms(lib_dx)),
        ffn.NAME_BWD_DW: dict(
            shape=f"{shape}; the dW kernel alone over the gradient kernel's "
                  f"pairs [2,{N},{Fd}]",
            max_abs_err=dw_err["err"], rel_err=dw_err["rel"],
            max_abs_err_f32_n600=f32_dw["err"], rel_err_f32_n600=f32_dw["rel"],
            ms=timer.ms(dw), device_ms=timer.device_ms(dw),
            host_us=timer.host_us(dw),
            plain_ms=timer.ms(lambda: ref.ref_swiglu_ffn_bwd_dw(
                x, dy, *(t.float().sum(0) for t in pairs))),
            bound_ms=dw_b, bound_by=dw_by, library_ms=timer.ms(lib_dw),
            library_device_ms=timer.device_ms(lib_dw))}
    del x, dy, wg, wu, wd, pairs, hi
    torch.cuda.empty_cache()
    return rows


def scan_bwd_line(torch, entries: dict, gpu: str) -> str:
    """#12b's errors by output and times beside its bound and SFU floor,
    and #6 / #7 at jamba width beside their bounds and the library."""
    e = entries["ssm_scan_bwd"]
    worst_rel = max(e["rel_err_by_output"].values())
    parts = [f"ssm_scan_bwd {e['shape']}: {e['ms']:.4f} ms, device "
             f"{e['device_ms']:.4f}, host {e['host_us']:.1f} us, plain "
             f"{e['plain_ms']:.1f}; bound {e['bound_ms']:.4f} "
             f"{e['bound_by']}, SFU floor "
             f"{sfu_floor_ms(torch, e['exps_counted']):.4f}; max abs err "
             f"{e['max_abs_err']:.3g}, largest ||err|| / ||want|| "
             f"{worst_rel:.3g} (tol {SSM_BWD_TOL})"]
    for name in ("fused_ffn_bwd_dx", "fused_ffn_bwd_dw"):
        j = entries[name]["jamba_width"]
        parts.append(
            f"{name} at jamba width {j['shape']}: {j['ms']:.4f} ms, device "
            f"{j['device_ms']:.4f}, host {j['host_us']:.1f} us, plain "
            f"{j['plain_ms']:.3f}, library {j['library_ms']:.4f} (device "
            f"{j['library_device_ms']:.4f}); bound {j['bound_ms']:.4f} "
            f"{j['bound_by']}; err bf16 {j['max_abs_err']:.3g} (rel "
            f"{j['rel_err']:.3g}), f32 600 rows "
            f"{j['max_abs_err_f32_n600']:.3g} (rel "
            f"{j['rel_err_f32_n600']:.3g})")
    return "scan_bwd: " + " | ".join(parts) + f" [{gpu}]"


def mlstm_kernel(torch, timer) -> dict:
    """#13 against its plain version at xlstm-125m's prefill shapes, f32,
    chunk 256, the reference test's inputs (k scaled by dh^-0.5, f_log =
    log_sigmoid(N(0,1) + 2)): the kernels phase's 4 prompts x 1024 tokens,
    4 heads of dh 384 (y and the final (C, n, m); the second half again
    from the first half's carry), then the xlstm profile's prefill, 16 x
    1024; both timed on the ``ms`` and ``device_ms`` timers.

    The bound counts each input and output once and the operations these
    inputs need: q·k and P·v over the causal pairs of each chunk, the
    carry's q·Cᵀ and q·n in every chunk but the first (its carry is zero),
    and the C and n updates of every chunk, at the TF32 tensor-core rate,
    where the kernel's products run.  No single PyTorch call computes a
    chunkwise mLSTM, so there is no library yardstick."""
    from repro_torch.kernels import mlstm_scan as ml
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(6)
    H, S, dh, L = 4, 1024, 384, 256

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def case(B: int, state_check: bool) -> dict:
        q, v = randn(B, H, S, dh), randn(B, H, S, dh)
        k = randn(B, H, S, dh) * dh ** -0.5
        ig = randn(B, H, S)
        fl = torch.nn.functional.logsigmoid(randn(B, H, S) + 2.0)
        args = (q, k, v, ig, fl)
        y, carry = ml.mlstm_scan(*args, chunk=L)
        wy, wcarry = ref.ref_mlstm_scan(*args, chunk=L)
        checks = [("", (y,) + carry, (wy,) + wcarry)]
        if state_check:
            half = [t[:, :, S // 2:].contiguous() for t in args]
            _, first = ml.mlstm_scan(*(t[:, :, :S // 2].contiguous()
                                       for t in args), chunk=L)
            gy, gc = ml.mlstm_scan(*half, chunk=L, state=first)
            wy2, wc2 = ref.ref_mlstm_scan(*half, chunk=L, state=first)
            checks.append(("from a state ", (gy,) + gc, (wy2,) + wc2))
        errs, rels = {}, {}
        for what, gots, wants in checks:
            for name, g, w in zip(("y", "C", "n", "m"), gots, wants):
                key = what + name
                errs[key] = check("mlstm_scan", g, w, "float32",
                                  f"B={B} {key}")
                rels[key] = rel_err(g, w)
                if not rels[key] <= MLSTM_REL_TOL:
                    raise AssertionError(
                        f"mlstm_scan B={B} {key}: ||err|| / ||want|| "
                        f"{rels[key]:.3g} over {MLSTM_REL_TOL}")
        pairs = B * H * (S // L) * L * (L + 1) / 2
        flops = (4 * dh * pairs                           # q·k, P·v
                 + 2 * B * H * (S - L) * (dh * dh + dh)   # q·Cᵀ, q·n
                 + 2 * B * H * S * (dh * dh + dh))        # C, n updates
        nb = nbytes(*args, y, *carry)
        b_ms, b_by = bound(nb, flops, "tfloat32")

        def kern():
            return ml.mlstm_scan(*args, chunk=L)
        return dict(
            shape=f"q/k/v [{B},{H},{S},{dh}], chunk {L}, f32; final carry "
                  f"C [{B},{H},{dh},{dh}]",
            max_abs_err=max(errs.values()), max_abs_err_by_output=errs,
            rel_err_by_output=rels,
            ms=timer.ms(kern), device_ms=timer.device_ms(kern),
            plain_ms=timer.ms(lambda: ref.ref_mlstm_scan(*args, chunk=L)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=None,
            library="none: no single PyTorch call computes a chunkwise mLSTM",
            flops_counted=flops, bytes_counted=nb)

    entry = case(4, state_check=True)
    entry["xlstm_profile_shape"] = case(16, state_check=False)
    return {ml.NAME: entry}


def check_mlstm_bwd(got, want, what: str) -> tuple[float, float]:
    """Max |got - want| and ||got - want|| / ||want||; raises unless every
    element is finite and within MLSTM_BWD_TOL of max |want|, and the
    relative error within BWD_REL_TOL["float32"]."""
    got, want = got.float(), want.float()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    rel = rel_err(got, want)
    if not bool(got.isfinite().all()) or not err <= MLSTM_BWD_TOL * scale \
            or (scale and not rel <= BWD_REL_TOL["float32"]):
        raise AssertionError(
            f"mlstm_scan_bwd {what}: max abs err {err:.3g} over "
            f"{MLSTM_BWD_TOL} x max |want| {scale:.3g}, or ||err|| / "
            f"||want|| {rel:.3g} over {BWD_REL_TOL['float32']}")
    return err, rel


def mlstm_bwd_kernel(torch, timer) -> dict:
    """#13b, the mLSTM scan's backward, against ``ref_mlstm_scan_bwd`` on
    the card, both fed the forward kernel's y and kept tensors, f32, chunk
    256, the reference test's inputs and N(0, 1) cotangents: at the train
    shape (8 x 512: two chunks), at [4,4,1024,384] (four) and over one
    chunk (8 x 256), from the zero state; at 4 x 512 from the carry of a
    first call, with the final carry's grads (dC, dn, dm) given.  Timed at
    the train shape on the ``ms``, ``device_ms`` and ``host_us`` timers.

    The bound counts each input (q, k, v, dy, y, the gates, d and the kept
    carries) and output (dq, dk, dv, di, df_log) once, and the operations
    these inputs need at the TF32 tensor-core rate (as #13's): per chunk
    the five products over its causal pairs (S, dP, dv, dq, dk), and in
    every chunk but the first (whose carry is zero) the carry-in product
    dnum·C0 and its dC step, and the carry-out products V·dC1 and
    K·dC1ᵀ.  No single PyTorch call computes it: no library yardstick."""
    from repro_torch.kernels import mlstm_scan as ml
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(7)
    H, dh, L = 4, 384, 256

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def inputs(B: int, S: int) -> list:
        return [randn(B, H, S, dh), randn(B, H, S, dh) * dh ** -0.5,
                randn(B, H, S, dh), randn(B, H, S),
                torch.nn.functional.logsigmoid(randn(B, H, S) + 2.0)]

    errs, rels = {}, {}

    def case(what: str, B: int, S: int, state=None):
        ins = inputs(B, S)
        y, _, kept = ml.mlstm_scan(*ins, chunk=L, state=state, keep=True)
        dy = randn(B, H, S, dh)
        cot = {} if state is None else dict(
            dC=randn(B, H, dh, dh), dn=randn(B, H, dh), dm=randn(B, H))
        got = ml.mlstm_scan_bwd(*ins, y, kept, dy, chunk=L, state=state,
                                **cot)
        want = ref.ref_mlstm_scan_bwd(*ins, y, kept, dy, chunk=L,
                                      state=state, **cot)
        for name, g, w in zip(("dq", "dk", "dv", "di", "df", "dC", "dn",
                               "dm"), got, want):
            if w is not None:
                key = f"{what} {name}"
                errs[key], rels[key] = check_mlstm_bwd(g, w, key)
        return ins, y, kept, dy

    ins, y, kept, dy = case("8x512", 8, 512)
    case("4x1024", 4, 1024)
    case("8x256 one chunk", 8, 256)
    _, first = ml.mlstm_scan(*inputs(4, 512), chunk=L)
    case("4x512 from a state", 4, 512, first)
    B, S = 8, 512
    nc = S // L
    pairs = L * (L + 1) / 2
    flops = B * H * (10 * dh * pairs * nc + 8 * L * dh * dh * (nc - 1))
    nb = nbytes(*ins, y, dy, *kept) + nbytes(*ins[:3]) + 2 * nbytes(ins[3])
    b_ms, b_by = bound(nb, flops, "tfloat32")

    def kern():
        return ml.mlstm_scan_bwd(*ins, y, kept, dy, chunk=L)
    return {ml.NAME_BWD: dict(
        shape=f"q/k/v/dy [{B},{H},{S},{dh}], chunk {L}, f32, from the zero "
              f"state",
        max_abs_err=max(errs.values()), max_abs_err_by_output=errs,
        rel_err_by_output=rels,
        ms=timer.ms(kern), device_ms=timer.device_ms(kern),
        host_us=timer.host_us(kern),
        plain_ms=timer.ms(lambda: ref.ref_mlstm_scan_bwd(
            *ins, y, kept, dy, chunk=L)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library="none: no single PyTorch call computes a chunkwise mLSTM's "
                "backward",
        flops_counted=flops, bytes_counted=nb)}


def quant_kernels(torch, timer) -> dict:
    """The int8 kernels against their plain versions, exactly (tolerance
    0), at the serving path's shapes, then timed in bf16:

    * #10 quantize_int8 at [nb, 256] (nb 64 and 256, f32) and at the int8
      pool's admission splice: the (block column, kv head) tiles of one
      layer stack's prefill caches for a 16 x 1024 bucket, x [12, 16, 2048,
      4, 64] bf16, 64 columns of 16 (timed there on all three timers, one
      leaf and K and V in one launch as the splice calls it);
    * #11 dequantize_int8 at [256, 256] and as the chunk append's gather,
      one row of 128 blocks x 16 of [2050, 16, 4, 64] pools to bf16, K and
      V in one launch as the path calls it (timed there, on all three
      timers) and one leaf alone (timed too);
    * the int8 pool write at a decode tick (16 rows, ten slots on their
      own blocks, six inactive rows colliding on the trash block; timed
      there on all three timers) and at a 32-token chunk, K and V in one
      launch, three writes in a row; the trash block's payload is left out (its colliding
      writes land in no fixed order in the plain version's scatter).

    Each bound counts the bytes the function needs once: #10 the tiles'
    entries read and the payload and scales written; #11 the table's
    blocks and scales read and the gather written, per leaf; the write the
    new entries, bids and offsets read, and each touched block's payload
    and scales read and written.  Library yardsticks: #11 a torch.mul of
    the same 128 blocks' payload by their scales, stored contiguously (the
    function without the table's indirection), one a leaf; none for #10
    and the write: no single PyTorch call computes a per-row max-abs int8
    quantization."""
    from repro_torch.kernels import quant as qt
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf16 = torch.bfloat16
    out = {}

    def same(name, got, want, what):
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            check(name, g, w, "float32", what)
        return 0.0

    # #10
    for nb in (64, 256):
        x = torch.randn(nb, 256, generator=gen, device="cuda") \
            * torch.logspace(-3, 2, nb, device="cuda")[:, None]
        same(qt.NAME_QUANT, qt.quantize_rows(x), ref.ref_quantize_rows(x),
             f"[{nb}, 256] f32")
    R, B, T, KV, D, bs, nb = 12, 16, 2048, 4, 64, 16, 64
    x = torch.randn(R, B, T, KV, D, generator=gen, device="cuda").to(bf16)
    for n in (nb, 3):
        same(qt.NAME_QUANT, qt.quantize_rows(x, block_size=bs, nb=n),
             ref.ref_quantize_kv_tiles(x, bs, n), f"splice tiles nb={n}")
    xv = torch.randn(R, B, T, KV, D, generator=gen, device="cuda").to(bf16)
    pair = qt.quantize_rows((x, xv), block_size=bs, nb=nb)
    for got, leaf in zip(pair, (x, xv)):
        same(qt.NAME_QUANT, got, ref.ref_quantize_kv_tiles(leaf, bs, nb),
             "splice K and V in one launch")
    del pair
    used = R * B * nb * bs * KV * D
    b_ms, b_by = bound(used * 2 + used + R * B * nb * KV * 4,
                       3 * used, "float32")
    b2_ms, b2_by = bound(2 * (used * 2 + used + R * B * nb * KV * 4),
                         6 * used, "float32")

    def leaf():
        return qt.quantize_rows(x, block_size=bs, nb=nb)

    def both():
        return qt.quantize_rows((x, xv), block_size=bs, nb=nb)

    out[qt.NAME_QUANT] = dict(
        shape=f"prefill caches x [{R},{B},{T},{KV},{D}] bf16 -> {nb} "
              f"columns of {bs}: q int8 [{R},{B},{nb * bs},{KV},{D}], "
              f"scale [{R},{B},{nb},{KV}] (one leaf of a 16 x 1024 "
              f"admission splice); also [64|256, 256] f32",
        max_abs_err=0.0,
        ms=timer.ms(leaf), device_ms=timer.device_ms(leaf),
        host_us=timer.host_us(leaf),
        plain_ms=timer.ms(lambda: ref.ref_quantize_kv_tiles(x, bs, nb)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library="none: no single PyTorch call computes a per-row max-abs "
                "int8 quantization",
        k_and_v=dict(shape="K and V of that splice layer in one launch, as "
                           "the admission splice calls it",
                     ms=timer.ms(both), device_ms=timer.device_ms(both),
                     host_us=timer.host_us(both), bound_ms=b2_ms,
                     bound_by=b2_by))
    del xv

    # #11
    q = torch.randint(-127, 128, (256, 256), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand(256, generator=gen, device="cuda") * 0.05
    same(qt.NAME_DEQUANT, qt.dequantize_rows(q, s),
         ref.ref_dequantize_rows(q, s), "[256, 256]")
    N, M = 2050, 128
    pools = [torch.randint(-127, 128, (N, bs, KV, D), generator=gen,
                           device="cuda", dtype=torch.int8)
             for _ in range(2)]
    scales = [torch.rand(N, KV, generator=gen, device="cuda") * 0.05
              for _ in range(2)]
    table = (torch.randperm(N - 2, generator=gen, device="cuda")[:M] + 2) \
        .to(torch.int32)[None].contiguous()
    for dt in (torch.float32, bf16):
        same(qt.NAME_DEQUANT,
             qt.dequantize_rows(pools[0], scales[0], table, dt),
             ref.ref_dequantize_gather(pools[0], scales[0], table, dt),
             f"gather to {dt}")
        pair = qt.dequantize_rows(pools, scales, table, dt)
        for got, pool, scale in zip(pair, pools, scales):
            same(qt.NAME_DEQUANT, got,
                 ref.ref_dequantize_gather(pool, scale, table, dt),
                 f"K and V gather to {dt}")
    tbl = table[0].long()
    blocks = [x[tbl].contiguous() for x in pools]
    bscale = [x[tbl][:, None, :, None].contiguous() for x in scales]
    leaf = M * (bs * KV * D + KV * 4) + M * bs * KV * D * 2
    one_b = bound(leaf + M * 4, M * bs * KV * D, "float32")
    two_b = bound(2 * leaf + M * 4, 2 * M * bs * KV * D, "float32")

    def kern_one():
        return qt.dequantize_rows(pools[0], scales[0], table, bf16)

    def kern_two():
        return qt.dequantize_rows(pools, scales, table, bf16)

    def lib_one():
        return torch.mul(blocks[0], bscale[0])

    def lib_two():
        return torch.mul(blocks[0], bscale[0]), torch.mul(blocks[1],
                                                          bscale[1])

    def times(kern, plain, lib, b):
        return dict(ms=timer.ms(kern), device_ms=timer.device_ms(kern),
                    host_us=timer.host_us(kern), plain_ms=timer.ms(plain),
                    bound_ms=b[0], bound_by=b[1], library_ms=timer.ms(lib),
                    library_device_ms=timer.device_ms(lib),
                    library_host_us=timer.host_us(lib))

    out[qt.NAME_DEQUANT] = dict(
        shape=f"K and V pools [{N},{bs},{KV},{D}] int8 + scales [{N},{KV}], "
              f"table [1,{M}] -> 2 x [1,{M * bs},{KV},{D}] bf16 in one "
              f"launch (the int8 chunk append's gather, capacity 2048); "
              f"also one leaf, and [256, 256] -> f32",
        max_abs_err=0.0,
        **times(kern_two, lambda: [ref.ref_dequantize_gather(
            x, sc, table, bf16) for x, sc in zip(pools, scales)], lib_two,
            two_b),
        library="two torch.mul, one a leaf, of the same 128 blocks, stored "
                "contiguously, by their scales (no table indirection)",
        one_leaf=dict(
            shape=f"K alone -> [1,{M * bs},{KV},{D}] bf16",
            **times(kern_one, lambda: ref.ref_dequantize_gather(
                pools[0], scales[0], table, bf16), lib_one, one_b)))

    # the int8 pool write
    keep = torch.arange(N, device="cuda") != 1
    cases = {}
    for kind in ("decode", "chunk"):
        if kind == "decode":
            bids = [5, 9, 13, 17, 21, 25, 29, 33, 37, 41] + [1] * 6
            off = [0, 3, 15, 7, 0, 1, 2, 9, 11, 14, 0, 5, 5, 0, 8, 5]
        else:
            p = list(range(124, 152))
            bids = [1] * 4 + [40 + t // bs for t in p[4:]] + [1] * 4
            off = [t % bs for t in p] + [0] * 4
        bids_t = torch.tensor(bids, dtype=torch.int32, device="cuda")
        off_t = torch.tensor(off, dtype=torch.int32, device="cuda")
        pools = [torch.randint(-127, 128, (N, bs, KV, D), generator=gen,
                               device="cuda", dtype=torch.int8)
                 for _ in range(2)]
        scales = [torch.rand(N, KV, generator=gen, device="cuda") * 0.05
                  for _ in range(2)]
        plain_p = [t.clone() for t in pools]
        plain_s = [t.clone() for t in scales]
        news = [(torch.randn(len(bids), KV, D, generator=gen,
                             device="cuda") * 4).to(bf16) for _ in range(2)]
        for _ in range(3):
            qt.quantized_block_write(pools, scales, news, bids_t, off_t)
            for pp, ss, nn in zip(plain_p, plain_s, news):
                ref.ref_quantized_block_write(pp, ss, nn, bids_t, off_t)
            for i in range(2):
                check(qt.NAME_WRITE, pools[i][keep], plain_p[i][keep],
                      "float32", f"{kind} payload")
                check(qt.NAME_WRITE, scales[i], plain_s[i], "float32",
                      f"{kind} scales")
        cases[kind] = (pools, scales, news, bids_t, off_t,
                       len(set(bids) | {b for b, o in zip(bids, off)
                                        if o == 0} | {1}))
    pools, scales, news, bids_t, off_t, touched = cases["decode"]
    rows = bids_t.numel()
    b_ms, b_by = bound(2 * (nbytes(news[0]) + touched * (2 * bs * KV * D
                                                         + 2 * KV * 4))
                       + nbytes(bids_t, off_t),
                       2 * 4 * rows * KV * D, "float32")

    def plain_write():
        for pp, ss, nn in zip(pools, scales, news):
            ref.ref_quantized_block_write(pp, ss, nn, bids_t, off_t)

    def write():
        qt.quantized_block_write(pools, scales, news, bids_t, off_t)

    out[qt.NAME_WRITE] = dict(
        shape=f"K and V: {rows} new entries [{rows},{KV},{D}] bf16 into int8 "
              f"pools [{N},{bs},{KV},{D}] + scales [{N},{KV}], {touched} "
              f"distinct blocks touched (a decode tick, 16 slots); also a "
              f"32-token chunk",
        max_abs_err=0.0,
        ms=timer.ms(write), device_ms=timer.device_ms(write),
        host_us=timer.host_us(write),
        plain_ms=timer.ms(plain_write), bound_ms=b_ms, bound_by=b_by,
        library_ms=None,
        library="none: no single PyTorch call computes the int8 pool write",
        computes="the int8 pool write, src/repro/models/attention.py:378 "
                 "_quantized_block_write, on #10's row math")
    return out


def paged_case(torch, KV: int, G: int, D: int, seed: int, B: int = 16,
               bs: int = 16, M: int = 128, N: int = 2050) -> dict:
    """The serve shapes of the paged kernels: 16 slots with seeded chain
    lengths 64-2048 (block_size 16, 128 table columns, 2050 pool blocks
    taken in shuffled order), row 1 sharing row 0's first block, NULL
    table tails; f32 pools plus their int8 quantization (per block and kv
    head, max-abs / 127)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, M * bs + 1, B)
    table = np.zeros((B, M), np.int32)
    pos_pool = np.full((N, bs), -1, np.int32)
    free = list(rng.permutation(np.arange(2, N)))
    for b, L in enumerate(lens):
        for j in range(-(-int(L) // bs)):
            if b == 1 and j == 0:
                table[1, 0] = table[0, 0]        # one shared prefix block
                continue
            bid = table[b, j] = free.pop()
            t = np.arange(j * bs, (j + 1) * bs)
            pos_pool[bid] = np.where(t < L, t, -1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    H = KV * G
    kp, vp = (torch.randn(N, bs, KV, D, generator=gen, device="cuda")
              for _ in range(2))
    ks, vs = (x.abs().amax(dim=(1, 3)) / 127.0 for x in (kp, vp))
    kq, vq = (torch.round(x / s[:, None, :, None]).to(torch.int8)
              for x, s in ((kp, ks), (vp, vs)))
    dev = lambda a: torch.from_numpy(a).to("cuda")         # noqa: E731
    blocks = len(set(table[table != 0].tolist()))
    return dict(q=torch.randn(B, H, D, generator=gen, device="cuda"),
                kp=kp, vp=vp, kq=kq, vq=vq, ks=ks, vs=vs,
                pos_pool=dev(pos_pool), table=dev(table),
                pos=dev((lens - 1).astype(np.int32)), valid=int(lens.sum()),
                blocks=blocks, B=B, H=H, KV=KV, D=D, bs=bs, M=M, N=N)


def paged_kernels(torch, timer) -> dict:
    """The paged decode kernels against their plain versions (f32 and bf16
    pools, int8 pools with f32 and bf16 q; head dim 64 at exanode-100m's
    12 / 4 heads, 128 at llama3.2-3b's 24 / 8 and granite-20b's 48 / 1
    (six head groups of 8) and, for int8, 256 at gemma-2b's 8 / 1, which
    the int8 kernel's first version refused) and their times at the serve
    shapes and granite-20b's in the serving dtype (bf16; int8 pools with
    bf16 q).  Both run the split kernel: each names its plan."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    bf16 = torch.bfloat16

    def q8_args(c, dt):
        return (c["q"].to(dt), c["kq"], c["vq"], c["ks"], c["vs"],
                c["pos_pool"], c["table"], c["pos"])

    def f_args(c, dt):
        return (c["q"].to(dt), c["kp"].to(dt), c["vp"].to(dt),
                c["pos_pool"], c["table"], c["pos"])

    kernels = {pa.NAME: (pa.paged_decode_attention, ref.ref_paged_decode_attention,
                         f_args),
               pa.NAME_Q8: (pa.paged_decode_attention_q8,
                            ref.ref_paged_decode_attention_q8, q8_args)}
    c = paged_case(torch, KV=4, G=3, D=64, seed=3)
    wide = paged_case(torch, KV=8, G=3, D=128, seed=4)
    gemma = paged_case(torch, KV=1, G=8, D=256, seed=5)
    granite = paged_case(torch, KV=1, G=48, D=128, seed=6)
    out = {}
    for name, (kern, plain, args) in kernels.items():
        quant = name == pa.NAME_Q8
        errs = {}
        for case, what, suffix in (
                (c, "serve shapes", ""), (wide, "D=128, 24/8 heads", "_d128"),
                (gemma, "D=256, 8/1 heads", "_d256"),
                (granite, "D=128, 48/1 heads", "_g48")):
            if case is gemma and not quant:
                continue
            for dt in (torch.float32, bf16):
                a = args(case, dt)
                dname = str(dt).split(".")[1]
                tag = "_f32" if dt == torch.float32 else (
                    "_bf16" if suffix else "")
                errs[f"max_abs_err{tag}{suffix}"] = check(
                    name, kern(*a), plain(*a), dname, what)

        def timed(c, kern=kern, plain=plain, args=args, quant=quant):
            """The kernel at case ``c`` in bf16 on the three timers,
            beside its plain version, its bound and the library's gather +
            SDPA."""
            a = args(c, bf16)
            B, H, KV, D, bs, M = (c[k] for k in ("B", "H", "KV", "D", "bs",
                                                 "M"))
            pool_el = 1 if quant else 2
            # each distinct block that valid entries reach, read once (the
            # shared block once, and once however many head groups read
            # it): K and V rows, its positions and, for int8, its two
            # scale rows; plus q, out, the table and pos
            nb = (c["blocks"] * (2 * bs * KV * D * pool_el + 4 * bs
                                 + (8 * KV if quant else 0))
                  + 2 * nbytes(a[0]) + nbytes(c["table"], c["pos"]))
            b_ms, b_by = bound(nb, 4 * H * D * c["valid"], "bfloat16")
            tbl = c["table"].long()
            kv_pos = c["pos_pool"][tbl].reshape(B, M * bs)
            mask = ((kv_pos >= 0)
                    & (kv_pos <= c["pos"][:, None]))[:, None, None]

            def gathered(pool, scale):
                x = pool[tbl]
                if scale is not None:
                    x = (x.float() * scale[tbl][:, :, None, :, None]).to(bf16)
                return x.reshape(B, M * bs, KV, D).transpose(1, 2)

            def library():
                k = gathered(a[1], a[3] if quant else None)
                v = gathered(a[2], a[4] if quant else None)
                return F.scaled_dot_product_attention(
                    a[0][:, :, None], k, v, attn_mask=mask, enable_gqa=True)

            groups = da.head_groups(H // KV)
            splits, split_len = da.plan_splits(B * KV * groups, M * bs,
                                               da.tile_entries(D, 2), bs)
            plan = (f"{splits} splits of {split_len // bs} columns, "
                    f"{groups} head group{'s' if groups > 1 else ''}")

            def run():
                return kern(*a)
            return dict(
                shape=f"q [{B},{H},{D}] {'int8' if quant else 'bf16'} pools "
                      f"[{c['N']},{bs},{KV},{D}], table [{B},{M}], "
                      f"{c['valid']} valid entries in {c['blocks']} blocks, "
                      f"bf16 q; {plan}",
                splits=splits, split_len=split_len,
                ms=timer.ms(run), device_ms=timer.device_ms(run),
                host_us=timer.host_us(run),
                plain_ms=timer.ms(lambda: plain(*a)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=timer.ms(library),
                library_device_ms=timer.device_ms(library),
                library_host_us=timer.host_us(library),
                library=("two calls: the pools' block_table gather"
                         + (" with dequantization" if quant else "")
                         + " + torch.nn.functional."
                           "scaled_dot_product_attention with the "
                           "positional mask"))
        out[name] = dict(timed(c), **errs, granite_width=timed(granite))
    return out


def grad_errs(errs: dict, i: int) -> dict:
    """JSON fields of output ``i`` from ``{case: (check_grad, ...)}``: the
    bf16 case's max abs err, relative err and largest |want|, and each
    other case's max abs err and relative err."""
    bf = errs["bfloat16"][i]
    out = dict(max_abs_err=bf["err"], rel_err=bf["rel"],
               max_abs_want=bf["max"])
    for case, rs in errs.items():
        if case != "bfloat16":
            key = ("f32" if case == "float32" else
                   case if case.startswith("bf16_") else f"f32_{case}")
            out[f"max_abs_err_{key}"] = rs[i]["err"]
            out[f"rel_err_{key}"] = rs[i]["rel"]
    return out


def backward_kernels(torch, timer) -> dict:
    """The four backward kernels against the plain backward versions at the
    train path's shapes (exanode-100m, batch 8 x 512: attention q in the
    model's [B,S,H,D] -> [B,H,S,D] view, FFN rows 4096), f32 and bf16;
    attention also ragged with a window and at llama3.2-3b's 24 / 8 heads
    of dim 128 (f32 and bf16), the FFN at llama3.2-3b's widths in f32.
    Times in bf16, attention at both head dims.  The plain versions and
    the library yardsticks compute all of a pair's grads in one call, so
    each pair's two rows share those times."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ffn as ffn
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    def attn(B, S, H, KV, D):
        return (randn(B, S, H, D).transpose(1, 2),
                randn(B, S, KV, D).transpose(1, 2),
                randn(B, S, KV, D).transpose(1, 2),
                randn(B, S, H, D).transpose(1, 2))

    def attn_errs(q, k, v, do, dt: str, what: str, causal=True, window=0):
        kw = dict(causal=causal, window=window)
        o, lse = fa.flash_attention(q, k, v, **kw)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        wq, wk, wv = ref.ref_attention_bwd(q, k, v, o, lse, do, **kw)
        return (check_grad(fa.NAME_BWD_DQ, dq, wq, dt, what),
                worst(check_grad(fa.NAME_BWD_DKV, dk, wk, dt, what + " dk"),
                      check_grad(fa.NAME_BWD_DKV, dv, wv, dt, what + " dv")))

    B, S, H, KV, D = 8, 512, 12, 4, 64
    base = attn(B, S, H, KV, D)
    errs = {}
    for dt in (f32, bf16):
        name = str(dt).split(".")[1]
        errs[name] = attn_errs(*(t.to(dt) for t in base), name, "causal")
    for dt in ("float32", "bfloat16"):
        tag = "" if dt == "float32" else "bf16_"
        cut = (t[:, :, :500].to(getattr(torch, dt)) for t in base)
        errs[tag + "ragged"] = attn_errs(*cut, dt, "S=500 window=128",
                                         window=128)
    # llama3.2-3b's 24 / 8 heads of 128 at its train shape, batch 8 x 512
    wide = attn(8, 512, 24, 8, 128)
    errs["d128"] = attn_errs(*(t[:2] for t in wide), "float32",
                             "24/8 heads of dim 128")
    errs["bf16_d128"] = attn_errs(*(t.to(bf16) for t in wide), "bfloat16",
                                  "24/8 heads of dim 128")
    # gemma-2b's 8 / 1 heads of 256 at its train shape, batch 8 x 512:
    # the SIMT kernels' 32-row tiles, in f32 and bf16
    gemma = attn(8, 512, 8, 1, 256)
    errs["d256"] = attn_errs(*gemma, "float32", "8/1 heads of dim 256")
    errs["bf16_d256"] = attn_errs(*(t.to(bf16) for t in gemma), "bfloat16",
                                  "8/1 heads of dim 256")
    common = dict(plain="ref_attention_bwd (dq, dk, dv in one call)",
                  library="backward of torch.nn.functional."
                          "scaled_dot_product_attention with enable_gqa "
                          "(dq, dk, dv in one call)")

    def attn_times(q, k, v, do) -> dict:
        """#4 and #5 at one shape: each kernel's times, the two as the
        train path launches them, the plain backward and SDPA's backward,
        whose times both rows share."""
        B, H, S, D = q.shape
        o, lse = fa.flash_attention(q, k, v, causal=True)
        _, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do)
        pairs = B * H * S * (S + 1) / 2                 # causal pairs only
        stats = B * H * S * 4                           # one f32 per row
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                            enable_gqa=True)

        def library():
            return torch.autograd.grad(ol, (ql, kl, vl), do,
                                       retain_graph=True)

        def bwd():
            return fa.flash_attention_bwd(q, k, v, o, lse, do)
        shared = dict(
            plain_ms=timer.ms(lambda: ref.ref_attention_bwd(q, k, v, o, lse,
                                                            do)),
            library_ms=timer.ms(library),
            library_device_ms=timer.device_ms(library),
            library_host_us=timer.host_us(library),
            backward_ms=timer.ms(bwd), backward_device_ms=timer.device_ms(bwd),
            backward_host_us=timer.host_us(bwd),
            backward="flash_attention_bwd: the inputs checked once, #4 then "
                     "#5, as ops.FlashAttention.backward runs them")
        rows = {}
        for name, fn, nb, flops in (
                (fa.NAME_BWD_DQ,
                 lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do),
                 nbytes(q, k, v, o, do, q) + 2 * stats, 6 * D * pairs),
                (fa.NAME_BWD_DKV,
                 lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                    delta),
                 nbytes(q, k, v, do, k, v) + 2 * stats, 8 * D * pairs)):
            b_ms, b_by = bound(nb, flops, "bfloat16")
            rows[name] = dict(
                shape=f"q/dO [{B},{H},{S},{D}] k/v {list(k.shape)} causal "
                      f"bf16, q/k/v/dO strided [B,S,H,D] views (route "
                      f"{fa.route_bwd(q.dtype, D)})",
                ms=timer.ms(fn), device_ms=timer.device_ms(fn),
                host_us=timer.host_us(fn),
                bound_ms=b_ms, bound_by=b_by, **shared, **common)
        return rows

    out = attn_times(*(t.to(bf16) for t in base))
    d128 = attn_times(*(t.to(bf16) for t in wide))
    d256 = attn_times(*(t.to(bf16) for t in gemma))
    del wide, gemma
    for i, name in enumerate((fa.NAME_BWD_DQ, fa.NAME_BWD_DKV)):
        out[name].update(grad_errs(errs, i), d128=d128[name],
                         d256=d256[name])

    N, D, Fd = 4096, 768, 2048

    def ffn_args(N, D, Fd):
        return [randn(N, D), randn(D, Fd, scale=D ** -0.5),
                randn(D, Fd, scale=D ** -0.5), randn(Fd, D, scale=Fd ** -0.5),
                randn(N, D)]

    def ffn_errs(args, dt: str, what: str):
        want = ref.ref_swiglu_ffn_bwd(*args)
        dws = ffn.swiglu_ffn_bwd_dw(*args)
        tol = dw_tol(args[0].shape[0], dt)
        return (check_grad(ffn.NAME_BWD_DX, ffn.swiglu_ffn_bwd_dx(*args),
                           want[0], dt, what),
                worst(*(check_grad(ffn.NAME_BWD_DW, g, w, dt, what, tol)
                        for g, w in zip(dws, want[1:]))))

    base = ffn_args(N, D, Fd)
    errs = {str(dt).split(".")[1]: ffn_errs([t.to(dt) for t in base],
                                           str(dt).split(".")[1],
                                           f"N={N}")
            for dt in (f32, bf16)}
    errs["wide"] = ffn_errs(ffn_args(256, 3072, 8192), "float32",
                            "llama3.2-3b widths D=3072 F=8192, N=256")
    x, wg, wu, wd, dy = (t.to(bf16) for t in base)
    # #7 alone: the dW kernel against its plain version over the gradient
    # kernel's dg, du, h (hi, lo) pairs
    pairs = ffn.swiglu_ffn_bwd_grads(x, wg, wu, wd, dy)
    sums = [t.float().sum(0) for t in pairs]
    alone = worst(*(check_grad(ffn.NAME_BWD_DW, g, w, "bfloat16",
                               "dW kernel over the gradient kernel's pairs")
                    for g, w in zip(ffn.swiglu_ffn_bwd_dw_tc(x, dy, *pairs),
                                    ref.ref_swiglu_ffn_bwd_dw(x, dy, *sums))))

    def hidden():
        g, u, dh = x @ wg, x @ wu, dy @ wd.t()
        sg = torch.sigmoid(g)
        return g * sg, dh * g * sg, dh * u * (sg + g * sg * (1 - sg)), u

    def lib_dx():
        _, du, dg, _ = hidden()
        return dg @ wg.t() + du @ wu.t()

    hi = [t[0] for t in pairs]

    def lib_dw():            # three matmul over the same scratch (hi parts)
        return x.t() @ hi[0], x.t() @ hi[1], hi[2].t() @ dy

    # the library's whole backward: autograd through three matmul + silu
    xl, wgl, wul, wdl = (t.detach().requires_grad_() for t in (x, wg, wu, wd))
    yl = torch.matmul(F.silu(xl @ wgl) * (xl @ wul), wdl)

    def lib_bwd():
        return torch.autograd.grad(yl, (xl, wgl, wul, wdl), dy,
                                   retain_graph=True)

    shape = f"x/dy [{N},{D}] Wg/Wu [{D},{Fd}] Wd [{Fd},{D}] bf16"

    def path_dx():           # #6 as the train path runs it
        return ffn.swiglu_ffn_bwd_dx(x, wg, wu, wd, dy)

    def grads():             # its gradient kernel alone
        return ffn.swiglu_ffn_bwd_grads(x, wg, wu, wd, dy)

    # #6's work on the path: g, u, dh and dx (five products), reading x,
    # the weights and dy, writing dx and the dg, du, h pairs that #7 reads
    b_ms, b_by = bound(nbytes(x, wg, wu, wd, dy, x, *pairs),
                       5 * 2 * N * D * Fd, "bfloat16")
    out[ffn.NAME_BWD_DX] = dict(
        shape=f"{shape}; the gradient kernel (dg, du, h bf16 (hi, lo) pairs "
              f"[2,{N},{Fd}]) and the dx kernel over the hi planes",
        **grad_errs(errs, 0),
        ms=timer.ms(path_dx), device_ms=timer.device_ms(path_dx),
        host_us=timer.host_us(path_dx),
        grad_ms=timer.ms(grads), grad_device_ms=timer.device_ms(grads),
        ms_f32=timer.ms(lambda: ffn.swiglu_ffn_bwd_dx(*base)),
        plain_ms=timer.ms(lambda: ref.ref_swiglu_ffn_bwd(x, wg, wu, wd, dy)),
        bound_ms=b_ms, bound_by=b_by, library_ms=timer.ms(lib_dx),
        library_device_ms=timer.device_ms(lib_dx),
        plain="ref_swiglu_ffn_bwd (dx, dWg, dWu, dWd in one call)",
        library="five torch.matmul (g, u, dh recomputed; dg·Wgᵀ + du·Wuᵀ) "
                "+ the gate's elementwise ops",
        flops_counted="5 products of 2·N·D·F; bytes with the pairs written")
    # #7's function: xᵀ·dg, xᵀ·du, hᵀ·dy (three products) reading x, dy and
    # dg, du, h once each in bf16, writing the three grads.  The pair
    # design runs six (hi and lo parts) over the pairs; the TPU kernel
    # recomputed g, u, dh (six products over x, dy and the weights).
    grads_out = nbytes(wg, wu, wd)
    b_ms, b_by = bound(nbytes(x, dy, *hi) + grads_out, 3 * 2 * N * D * Fd,
                       "bfloat16")
    pair_ms, _ = bound(nbytes(x, dy, *pairs) + grads_out, 6 * 2 * N * D * Fd,
                       "bfloat16")
    tpu_ms, _ = bound(nbytes(x, wg, wu, wd, dy) + grads_out,
                      6 * 2 * N * D * Fd, "bfloat16")

    def dw():
        return ffn.swiglu_ffn_bwd_dw_tc(x, dy, *pairs)

    def bwd():
        return ffn.swiglu_ffn_bwd(x, wg, wu, wd, dy)
    out[ffn.NAME_BWD_DW] = dict(
        shape=f"{shape}; the dW kernel alone over dg, du, h bf16 (hi, lo) "
              f"pairs [2,{N},{Fd}]",
        **grad_errs(errs, 1), max_abs_err_alone=alone["err"],
        rel_err_alone=alone["rel"],
        ms=timer.ms(dw), device_ms=timer.device_ms(dw),
        host_us=timer.host_us(dw),
        ms_f32=timer.ms(lambda: ffn.swiglu_ffn_bwd_dw(*base)),
        plain_ms=timer.ms(lambda: ref.ref_swiglu_ffn_bwd_dw(x, dy, *sums)),
        bound_ms=b_ms, bound_by=b_by, bound_ms_pairs=pair_ms,
        bound_ms_tpu_kernel=tpu_ms,
        library_ms=timer.ms(lib_dw), library_device_ms=timer.device_ms(lib_dw),
        plain="ref_swiglu_ffn_bwd_dw (three f32 matmul over the pairs' sums)",
        library="three torch.matmul over the pairs' hi parts (xᵀ·dg, "
                "xᵀ·du, hᵀ·dy)",
        flops_counted="3 products of 2·N·D·F (bound_ms); the pairs' 6 "
                      "(bound_ms_pairs); the TPU kernel's 6 "
                      "(bound_ms_tpu_kernel)",
        backward_ms=timer.ms(bwd), backward_device_ms=timer.device_ms(bwd),
        backward_library_ms=timer.ms(lib_bwd),
        backward_library_device_ms=timer.device_ms(lib_bwd),
        backward="#6 + #7 (gradient, dx, dW kernels) against "
                 "torch.autograd.grad through three matmul + silu")
    return out


def window_pairs(S: int, W: int) -> int:
    """(query, key) pairs a causal S x S attention computes under a window
    of W (W <= 0: none): query i reads min(i + 1, W) keys."""
    if W <= 0 or W >= S:
        return S * (S + 1) // 2
    return W * (W + 1) // 2 + (S - W) * W


def moe_kernel_shapes(torch, timer) -> dict:
    """The shapes the MoE family brings to ported kernels, each checked in
    f32 and bf16 against its plain version and timed in bf16 on the three
    timers beside the plain version and the library's call: #1, #4 and #5
    at mixtral-8x7b's window (one 4608-token sequence, 32 / 8 heads of
    128, causal, window 4096: the first 512 queries see every earlier
    key, the rest 4096); #4 and #5 at qwen3-moe-30b-a3b's train shape
    (q/dO [8,32,512,128], k/v [8,4,512,128]: 8 q heads a kv head on the
    bf16 tensor cores); #3 over mixtral's ring after a wrap (16 slots, k/v
    [16,4096,8,128], each slot's positions in ring order: entry t holds
    the newest position p <= pos with p % 4096 == t).  Returns rows keyed
    by kernel name: ``mixtral_window``, ``qwen3_moe_g8``, ``ring``."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(29)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def attn(B, S, H, KV, D):
        """q, k, v, dO in the model's [B,S,H,D] -> [B,H,S,D] views."""
        return (randn(B, S, H, D).transpose(1, 2),
                randn(B, S, KV, D).transpose(1, 2),
                randn(B, S, KV, D).transpose(1, 2),
                randn(B, S, H, D).transpose(1, 2))

    def window_mask(S, W):
        i = torch.arange(S, device="cuda")
        m = i[None, :] <= i[:, None]
        return m & (i[None, :] > i[:, None] - W) if W else m

    def bwd_errs(q, k, v, do, dt, what, W):
        kw = dict(causal=True, window=W)
        o, lse = fa.flash_attention(q, k, v, **kw)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        wq, wk, wv = ref.ref_attention_bwd(q, k, v, o, lse, do, **kw)
        return (check_grad(fa.NAME_BWD_DQ, dq, wq, dt, what),
                worst(check_grad(fa.NAME_BWD_DKV, dk, wk, dt, what + " dk"),
                      check_grad(fa.NAME_BWD_DKV, dv, wv, dt, what + " dv")))

    def bwd_rows(q, k, v, do, W, errs, what) -> dict:
        """#4 and #5 at one shape in bf16: each kernel's times and bound,
        the plain backward's and SDPA's backward (with the window's mask
        where there is one), which both rows share."""
        B, H, S, D = q.shape
        kw = dict(causal=True, window=W)
        o, lse = fa.flash_attention(q, k, v, **kw)
        _, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)
        pairs = B * H * window_pairs(S, W)
        stats = B * H * S * 4
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa = (dict(attn_mask=window_mask(S, W)) if W
                else dict(is_causal=True))
        ol = F.scaled_dot_product_attention(ql, kl, vl, enable_gqa=True,
                                            **sdpa)

        def library():
            return torch.autograd.grad(ol, (ql, kl, vl), do,
                                       retain_graph=True)
        shared = dict(
            plain_ms=timer.ms(lambda: ref.ref_attention_bwd(q, k, v, o, lse,
                                                            do, **kw)),
            library_ms=timer.ms(library),
            library_device_ms=timer.device_ms(library),
            library_host_us=timer.host_us(library),
            plain="ref_attention_bwd (dq, dk, dv in one call)",
            library="backward of torch.nn.functional."
                    "scaled_dot_product_attention with enable_gqa"
                    + (" and the window's boolean mask" if W else "")
                    + " (dq, dk, dv in one call)")
        rows = {}
        for i, (name, fn, nb, flops) in enumerate((
                (fa.NAME_BWD_DQ,
                 lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw),
                 nbytes(q, k, v, o, do, q) + 2 * stats, 6 * D * pairs),
                (fa.NAME_BWD_DKV,
                 lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                    **kw),
                 nbytes(q, k, v, do, k, v) + 2 * stats, 8 * D * pairs))):
            b_ms, b_by = bound(nb, flops, "bfloat16")
            rows[name] = dict(
                shape=f"q/dO [{B},{H},{S},{D}] k/v {list(k.shape)} causal"
                      + (f" window {W}" if W else "") + f" bf16, {what} "
                      f"(route {fa.route_bwd(q.dtype, D)})",
                max_abs_err=errs["bfloat16"][i]["err"],
                rel_err=errs["bfloat16"][i]["rel"],
                max_abs_err_f32=errs["float32"][i]["err"],
                rel_err_f32=errs["float32"][i]["rel"],
                ms=timer.ms(fn), device_ms=timer.device_ms(fn),
                host_us=timer.host_us(fn), bound_ms=b_ms, bound_by=b_by,
                **shared)
        return rows

    out = {n: {} for n in ("flash_attention", fa.NAME_BWD_DQ,
                           fa.NAME_BWD_DKV, "decode_attention")}
    # mixtral-8x7b's window
    B, S, H, KV, D, W = 1, 4608, 32, 8, 128, 4096
    base = attn(B, S, H, KV, D)
    what = "mixtral-8x7b, window 4096 over 4608 positions"
    ferrs, berrs = {}, {}
    for dt in (f32, bf16):
        name = str(dt).split(".")[1]
        q, k, v, do = (t.to(dt) for t in base)
        o, lse = fa.flash_attention(q, k, v, causal=True, window=W)
        wo, wlse = ref.ref_attention(q, k, v, causal=True, window=W)
        ferrs[name] = check("flash_attention", o, wo, name, what)
        check("flash_attention", lse, wlse, "float32", f"{what} lse {name}")
        del o, lse, wo, wlse
        berrs[name] = bwd_errs(q, k, v, do, name, what, W)
        torch.cuda.empty_cache()
    q, k, v, do = (t.to(bf16) for t in base)
    mask = window_mask(S, W)

    def kern():
        return fa.flash_attention(q, k, v, causal=True, window=W)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    b_ms, b_by = bound(nbytes(q, k, v, q) + B * H * S * 4,
                       4 * D * B * H * window_pairs(S, W), "bfloat16")
    out["flash_attention"]["mixtral_window"] = dict(
        shape=f"q [{B},{H},{S},{D}] k/v [{B},{KV},{S},{D}] causal window "
              f"{W} bf16 (route {fa.route(bf16, D)})",
        max_abs_err=ferrs["bfloat16"], max_abs_err_f32=ferrs["float32"],
        ms=timer.ms(kern), device_ms=timer.device_ms(kern),
        host_us=timer.host_us(kern),
        plain_ms=timer.ms(lambda: ref.ref_attention(q, k, v, causal=True,
                                                    window=W)),
        bound_ms=b_ms, bound_by=b_by, library_ms=timer.ms(library),
        library_device_ms=timer.device_ms(library),
        library_host_us=timer.host_us(library),
        library="torch.nn.functional.scaled_dot_product_attention with the "
                "window's boolean mask")
    for name, row in bwd_rows(q, k, v, do, W, berrs, what).items():
        out[name]["mixtral_window"] = row
    del base, q, k, v, do, mask
    torch.cuda.empty_cache()

    # qwen3-moe-30b-a3b's train shape: G 8 at head dim 128
    base = attn(8, 512, 32, 4, 128)
    what = "qwen3-moe-30b-a3b, 32 / 4 heads (G 8)"
    errs = {str(dt).split(".")[1]: bwd_errs(*(t.to(dt) for t in base),
                                            str(dt).split(".")[1], what, 0)
            for dt in (f32, bf16)}
    for name, row in bwd_rows(*(t.to(bf16) for t in base), 0, errs,
                              what).items():
        out[name]["qwen3_moe_g8"] = row
    del base
    torch.cuda.empty_cache()

    # #3 over mixtral's ring after a wrap
    B, T, KV, G, D = 16, 4096, 8, 4, 128
    H = KV * G
    pos = torch.randint(T, 3 * T, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    t_idx = torch.arange(T, device="cuda", dtype=torch.int32)
    kv_pos = (pos[:, None] - (pos[:, None] - t_idx[None]) % T).contiguous()
    q32, k32, v32 = (randn(*s) for s in ((B, H, D), (B, T, KV, D),
                                          (B, T, KV, D)))
    errs = {}
    for dt in (f32, bf16):
        q, k, v = (t.to(dt) for t in (q32, k32, v32))
        name = str(dt).split(".")[1]
        errs[name] = check(
            "decode_attention",
            da.decode_attention(q, k, v, kv_pos, pos, window=W),
            ref.ref_decode_attention(q, k, v, kv_pos, pos, window=W), name,
            f"a wrapped ring of {T}, window {W}")
    q, k, v = (t.to(bf16) for t in (q32, k32, v32))
    live = (kv_pos <= pos[:, None]) & (kv_pos > pos[:, None] - W)
    valid = int(live.sum())
    b_ms, b_by = bound(nbytes(q, kv_pos, pos, q)
                       + 2 * valid * KV * D * k.element_size(),
                       4 * H * D * valid, "bfloat16")
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    groups = da.head_groups(G)
    splits, split_len = da.plan_splits(B * KV * groups, T,
                                       da.tile_entries(D, k.element_size()))

    def dkern():
        return da.decode_attention(q, k, v, kv_pos, pos, window=W)

    def dlib():
        return F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, attn_mask=live[:, None, None, :],
            enable_gqa=True)
    out["decode_attention"]["ring"] = dict(
        shape=f"q [{B},{H},{D}] k/v [{B},{T},{KV},{D}] bf16, a ring after "
              f"a wrap (pos {int(pos.min())}-{int(pos.max())}), window {W}: "
              f"{valid} of {B * T} entries attended; {splits} splits of "
              f"{split_len}",
        max_abs_err=errs["bfloat16"], max_abs_err_f32=errs["float32"],
        ms=timer.ms(dkern), device_ms=timer.device_ms(dkern),
        host_us=timer.host_us(dkern),
        plain_ms=timer.ms(lambda: ref.ref_decode_attention(
            q, k, v, kv_pos, pos, window=W)),
        bound_ms=b_ms, bound_by=b_by, library_ms=timer.ms(dlib),
        library_device_ms=timer.device_ms(dlib),
        library_host_us=timer.host_us(dlib),
        library="torch.nn.functional.scaled_dot_product_attention with the "
                "mask")
    return out


def moe_shapes_line(entries: dict, gpu: str) -> str:
    """The kernels phase's rows at the MoE family's shapes: each on the
    three timers beside its bound, the plain version and the library."""
    parts = []
    for name, key in (("flash_attention", "mixtral_window"),
                      ("flash_attention_bwd_dq", "mixtral_window"),
                      ("flash_attention_bwd_dkv", "mixtral_window"),
                      ("flash_attention_bwd_dq", "qwen3_moe_g8"),
                      ("flash_attention_bwd_dkv", "qwen3_moe_g8"),
                      ("decode_attention", "ring")):
        e = entries[name][key]
        parts.append(
            f"{name} {e['shape']}: {e['ms']:.4f} ms, device "
            f"{e['device_ms']:.4f}, host {e['host_us']:.1f} us; bound "
            f"{e['bound_ms']:.5f} {e['bound_by']}; plain {e['plain_ms']:.3f}"
            f"; library {e['library_ms']:.4f}, device "
            f"{e['library_device_ms']:.4f}; err bf16 {e['max_abs_err']:.3g}"
            f", f32 {e['max_abs_err_f32']:.3g}")
    return "moe_shapes: " + " | ".join(parts) + f" [{gpu}]"


def flash_bwd_line(entries: dict, gpu: str) -> str:
    """#4 and #5 at each head dim (64, 128 and gemma-2b's 256): device and
    host time of each kernel, the pair as the train path launches it, and
    SDPA's backward."""
    parts = []
    for key in (None, "d128", "d256"):
        dq, dkv = (entries[n] if key is None else entries[n][key]
                   for n in ("flash_attention_bwd_dq",
                             "flash_attention_bwd_dkv"))
        parts.append(
            f"{dq['shape']}: dq {dq['ms']:.4f} ms, device "
            f"{dq['device_ms']:.4f}, host {dq['host_us']:.1f} us; dkv "
            f"{dkv['ms']:.4f} ms, device {dkv['device_ms']:.4f}, host "
            f"{dkv['host_us']:.1f} us; both {dq['backward_ms']:.4f} "
            f"ms, device {dq['backward_device_ms']:.4f}, host "
            f"{dq['backward_host_us']:.1f} us; SDPA backward "
            f"{dq['library_ms']:.4f} ms, device "
            f"{dq['library_device_ms']:.4f}, host "
            f"{dq['library_host_us']:.1f} us; plain {dq['plain_ms']:.3f} "
            f"ms; bounds {dq['bound_ms']:.5f} / {dkv['bound_ms']:.5f}")
    return "flash_bwd: " + " | ".join(parts) + f" [{gpu}]"


def wide_groups_line(entries: dict, gpu: str) -> str:
    """#3, #8 and #9 at granite-20b's decode shape (48 q heads on one kv
    head: six head groups of 8): each kernel's times on the three timers,
    its error against the plain version, its bound (K/V bytes counted
    once) and the library's."""
    parts = []
    for n in ("decode_attention", "paged_decode_attention",
              "paged_decode_attention_q8"):
        e = entries[n]["granite_width"]
        err = (e["max_abs_err"] if n == "decode_attention"
               else entries[n]["max_abs_err_bf16_g48"])
        parts.append(
            f"{n} {e['shape']}: {e['ms']:.4f} ms, device "
            f"{e['device_ms']:.4f}, host {e['host_us']:.1f} us; bound "
            f"{e['bound_ms']:.5f} {e['bound_by']}; plain {e['plain_ms']:.3f}"
            f"; library {e['library_ms']:.4f}, device "
            f"{e['library_device_ms']:.4f}; bf16 err {err:.3g}")
    return "wide_groups: " + " | ".join(parts) + f" [{gpu}]"


def scan_quant_line(torch, entries: dict, gpu: str) -> str:
    """#12 at both prefill shapes and #10, its K-and-V launch and the int8
    pool write: each kernel's times on the three timers beside its bound
    (and #12's SFU floor, worked out here from the exps counted and kept
    off the kernels' JSON line, which holds no unmeasured time but the
    bound)."""
    parts = []
    scan = entries["ssm_scan"]
    for e in (scan, scan["jamba_profile_shape"]):
        parts.append(
            f"ssm_scan {e['shape']}: {e['ms']:.4f} ms, device "
            f"{e['device_ms']:.4f}, host {e['host_us']:.1f} us, plain "
            f"{e['plain_ms']:.1f}; bound "
            f"{e['bound_ms']:.4f} {e['bound_by']}, SFU floor "
            f"{sfu_floor_ms(torch, e['exps_counted']):.4f}")
    q = entries["quantize_int8"]
    for what, e in (("quantize_int8", q),
                    ("quantize_int8 K and V", q["k_and_v"]),
                    ("quantized_block_write",
                     entries["quantized_block_write"])):
        parts.append(f"{what}: {e['ms']:.4f} ms, device "
                     f"{e['device_ms']:.4f}, host {e['host_us']:.1f} us; "
                     f"bound {e['bound_ms']:.4f} {e['bound_by']}")
    return "scan_quant: " + " | ".join(parts) + f" [{gpu}]"


def leaf_paths(tree, pre: str = "") -> list:
    """"/a/b[0]"-style paths of a dict / list tree, in ``tree_leaves``
    order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k],
                                                            f"{pre}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in leaf_paths(t, f"{pre}[{i}]")]
    return [pre]


def f32_step_errs(torch, cfg, B: int, S: int, rel_tols: dict | None = None,
                  on_card: bool = False) -> tuple[dict, list]:
    """One f32 step of ``cfg`` (params from seed 0, drawn on the host, or
    with ``on_card`` on the card (``card_params``, quick for billions) and
    copied to the host; the synthetic batch of step 0, B x S): its loss
    and every grad leaf with the kernels on the card against the plain
    path on the CPU.  Returns ({"loss": max abs
    err, "grad": max abs grad err, "rel": largest leaf ||err|| / ||grad||
    held to TRAIN_GRAD_REL_TOL, "own_rel": that of the leaves ``rel_tols``
    names, "cpu_s" / "cuda_s": each side's wall seconds}, failures)
    against TRAIN_LOSS_TOL, TRAIN_GRAD_TOL and TRAIN_GRAD_REL_TOL; a leaf
    whose last path key is in ``rel_tols`` is held to its own relative
    bound there instead."""
    from repro_torch.data.pipeline import DataConfig, synthetic_batch, to_device
    from repro_torch.models.common import init_params, tree_leaves, tree_map
    from repro_torch.models.registry import model_specs
    from repro_torch.train.steps import value_and_grad
    cfg = cfg.scaled(dtype=torch.float32)
    if on_card:
        params = {"cuda": card_params(torch, cfg, torch.float32)}
        params["cpu"] = tree_map(lambda t: t.cpu(), params["cuda"])
    else:
        cpu_params = init_params(model_specs(cfg), seed=0)
        params = {dev: tree_map(lambda t: t.to(dev), cpu_params)
                  for dev in ("cpu", "cuda")}
    batch = synthetic_batch(DataConfig(cfg.vocab_size, S, B), 0)
    res, errs = {}, {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        res[dev] = value_and_grad(params.pop(dev), to_device(batch, dev),
                                  cfg)
        torch.cuda.synchronize()
        errs[f"{dev}_s"] = time.perf_counter() - t0
    loss_err = abs(float(res["cuda"][0]) - float(res["cpu"][0]))
    failed = []
    if not loss_err <= TRAIN_LOSS_TOL * (1 + abs(float(res["cpu"][0]))):
        failed.append(f"f32 loss differs by {loss_err:.3g}")
    grad_err = grad_rel = own_rel = 0.0
    rel_tols = rel_tols or {}
    for path, g, w in zip(leaf_paths(res["cpu"][2]),
                          tree_leaves(res["cuda"][2]),
                          tree_leaves(res["cpu"][2])):
        diff = (g.cpu() - w).abs()
        rel = rel_err(g.cpu(), w)
        grad_err = max(grad_err, float(diff.max()))
        if not bool((diff <= TRAIN_GRAD_TOL * (1 + w.abs())).all()):
            failed.append(f"f32 grad leaf {path} max abs err "
                          f"{float(diff.max()):.3g}")
        tol = rel_tols.get(path.rsplit("/", 1)[-1])
        if tol is None:
            tol, grad_rel = TRAIN_GRAD_REL_TOL, max(grad_rel, rel)
        else:
            own_rel = max(own_rel, rel)
        if not rel <= tol:
            failed.append(f"f32 grad leaf {path} ||err|| / ||grad|| "
                          f"{rel:.3g} over {tol}")
    errs.update(loss=loss_err, grad=grad_err, rel=grad_rel, own_rel=own_rel)
    return errs, failed


def bf16_train_run(torch, arch, kernels, steps: int = 20, B: int = 8,
                   S: int = 512, lr: float = 3e-4,
                   draw_on_device: bool = False) -> tuple[dict, list]:
    """python -m repro_torch.launch.train's loop for ``arch``: bf16
    activations, f32 params, batch B x S, ``steps`` cosine steps to peak
    ``lr`` (the launcher's default 3e-4, warmup 2), every
    launch counter zeroed just before and read just after (``arch`` a
    registry name or a config; ``draw_on_device`` draws the params on the
    card).  Returns
    ({"losses", "drop", "p50", "peak", "launches", "text"}, failures): the
    loss finite and falling by more than TRAIN_LOSS_DROP (first-5 minus
    last-5 mean), each of ``kernels`` launched."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_loop
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    _, hist = train_loop(arch, steps=steps, global_batch=B, seq_len=S, lr=lr,
                         draw_on_device=draw_on_device)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    p50 = float(np.median([h["seconds"] for h in hist]))
    drop = float(np.mean(losses[:5]) - np.mean(losses[-5:]))
    failed = []
    if not all(np.isfinite(losses)):
        failed.append("non-finite loss")
    if not drop > TRAIN_LOSS_DROP:
        failed.append(f"loss fell by {drop:.4f}, not more than "
                      f"{TRAIN_LOSS_DROP}")
    missing = [n for n in kernels if not launches[n]]
    if missing:
        failed.append(f"kernels of the train path never launched: {missing}")
    text = (f"bf16 activations, f32 params, global batch {B} x {S}, {steps} "
            f"cosine steps to peak lr {lr:g}: losses "
            f"{[round(x, 4) for x in losses]}; first-5 "
            f"minus last-5 mean {drop:.4f} (gate {TRAIN_LOSS_DROP}); step "
            f"p50 {p50 * 1e3:.1f} ms, {B * S / p50:.0f} tokens/s; peak "
            f"memory {peak / 2**30:.3f} GiB; launches {launches} "
            f"({steps} steps)")
    return dict(losses=losses, drop=drop, p50=p50, peak=peak,
                launches=launches, text=text), failed


def step_errs_text(errs: dict, what: str) -> str:
    return (f"{what}: loss err {errs['loss']:.3g}, max abs grad err "
            f"{errs['grad']:.3g}, largest leaf ||err|| / ||grad|| "
            f"{errs['rel']:.3g} (tol loss {TRAIN_LOSS_TOL}, grads "
            f"{TRAIN_GRAD_TOL} atol + rtol and {TRAIN_GRAD_REL_TOL} relative "
            f"per leaf)")


def train_phase(torch, gpu: str) -> tuple[str, dict]:
    """Full-width training: an f32 step's loss and grads on the card
    against the CPU, then the bf16 training run with the launch counters
    zeroed just before and read just after."""
    from repro_torch.configs import get_config
    errs, failed = f32_step_errs(torch, get_config("exanode-100m"), 2, 512)
    run, more = bf16_train_run(torch, "exanode-100m", TRAIN_KERNELS)
    failed += more
    line = (f"train: {step_errs_text(errs, 'exanode-100m f32, batch 2 x 512')}"
            f"; {run['text']} [{gpu}]")
    if failed:
        raise AssertionError(line + "\ntrain phase failed: "
                             + "; ".join(failed))
    return line, {n: run["launches"][n] for n in TRAIN_KERNELS}


# where an xlstm-125m train step's device time goes: the backward's five
# kernels first (their names contain no forward kernel's)
XLSTM_TRAIN_PROFILE_GROUPS = (
    ("mLSTM backward (#13b)", ("mlstm_bwd_",)),
    ("mLSTM forward (#13)", ("mlstm_carry_kernel", "mlstm_out_kernel")),
    ("cuBLAS GEMMs", ("gemm", "Gemm", "cutlass", "xmma", "nvjet")),
)


# The xlstm_train phase's f32 step runs one 4-layer period at full width,
# not the full depth: at the full depth the CPU's own grads move by 2-3%
# (largest leaf ||diff|| / ||grad||, every leaf below the top period)
# when the params are scaled by 1 + 1e-7 N(0, 1), past any f32 bound of
# 1e-4 (one period moves 1.5-2.2e-5 there; measured on an NVIDIA H100
# 80GB HBM3 machine at 700 W, CPU and card).
# Within it the leaves of the mLSTM that take their grad through the
# gates' di and df_log, summed over every token (w_if, b_if, and the conv
# feeding them), are held to ||err|| / ||grad|| <= 1e-3: df_log is a
# reverse cumsum over the chunk of terms that cancel, and two f32
# evaluations of the same scan backward on the same inputs (its plain
# version on the card and on the CPU) differ by 7.8e-5 of ||df_log||;
# the card's 3xTF32 forward moves its inputs by ~3e-6, and the gate
# leaves by 0.9-6.5e-4 over four runs (b_if 5.1e-4 to 1.1e-3, w_if 9e-5
# to 1.9e-4, conv_b 5.8e-5 to 1.25e-4; the same machine).  Every leaf keeps the
# elementwise TRAIN_GRAD_TOL, the others TRAIN_GRAD_REL_TOL.
XLSTM_GATE_GRAD_REL_TOL = 1e-3
XLSTM_TRAIN_REL_TOLS = {k: XLSTM_GATE_GRAD_REL_TOL
                        for k in ("w_if", "b_if", "conv_w", "conv_b")}
# The xlstm_train run's peak learning rate: at the launcher's default
# 3e-4 the loss fell 0.0269 in 20 steps (full depth), under
# TRAIN_LOSS_DROP.
XLSTM_TRAIN_LR = 1e-3
# The xlstm_train run and its profiled step run one full-width period
# (4 of xlstm-125m's 12 layers): at full depth its 20 eager-sLSTM steps
# took 174 of the whole script's 1080 s (8.7 s a step, on an NVIDIA H100
# 80GB HBM3 at 700 W), which with the moe phase left too little of the
# 1200 s limit.


def xlstm_train_phase(torch, gpu: str) -> tuple[str, dict]:
    """xlstm-125m training at full width: an f32 step's loss and grads
    of one full-width period (mlstm x3, slstm) on the card against the CPU
    (batch 2 x 512: two mLSTM chunks of 256, two sLSTM remat chunks), then
    the bf16 training run of that period with the launch counters zeroed
    just before and read just after, then ``profile_windows`` over one
    more bf16 step (8 x 512) by kernel group: mLSTM forward, mLSTM
    backward, cuBLAS and the rest, which is the eager sLSTM cell (its
    forward, its remat recompute and its autograd backward, a few small
    kernels a step and layer) and the elementwise glue."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_batch, to_device
    from repro_torch.models.common import LayerGroup
    from repro_torch.runtime import Runtime
    cfg = get_config("xlstm-125m")
    period = cfg.scaled(num_layers=4, groups=(LayerGroup(
        ("mlstm", "mlstm", "mlstm", "slstm"), 1),))
    errs, failed = f32_step_errs(torch, period, 2, 512,
                                 rel_tols=XLSTM_TRAIN_REL_TOLS)
    run, more = bf16_train_run(torch, period, XLSTM_TRAIN_KERNELS,
                               lr=XLSTM_TRAIN_LR)
    failed += more
    rt = Runtime.create(period, shape_kind="train", seq_len=512)
    state = rt.init_train_state()
    batch = to_device(synthetic_batch(DataConfig(rt.cfg.vocab_size, 512, 8),
                                      0), "cuda")
    parts = profile_windows(
        torch, {"step": (lambda: rt.train_step(state, batch), 1)},
        XLSTM_TRAIN_PROFILE_GROUPS, "xlstm_train")
    del rt, state
    torch.cuda.empty_cache()
    what = "xlstm-125m f32, one full-width period (4 layers), batch 2 x 512"
    line = (f"xlstm_train: {step_errs_text(errs, what)}; the mLSTM gate "
            f"leaves {sorted(XLSTM_TRAIN_REL_TOLS)} largest ||err|| / "
            f"||grad|| {errs['own_rel']:.3g} (tol "
            f"{XLSTM_GATE_GRAD_REL_TOL}); CPU side {errs['cpu_s']:.1f} s, "
            f"card {errs['cuda_s']:.1f} s; "
            f"one period (4 of 12 layers): {run['text']}; profile of one "
            f"bf16 step 8 x 512, "
            f"{parts[0]} [{gpu}]")
    if failed:
        raise AssertionError(line + "\nxlstm_train phase failed: "
                             + "; ".join(failed))
    return line, {n: run["launches"][n] for n in XLSTM_TRAIN_KERNELS}


# The jamba_train phase's bf16 run: 20 steps of train_cut() at 8 x 512 at
# the launcher's default peak lr, 3e-4.  scripts/jamba_lr_probe.py: the
# drop is 0.0335 at 3e-4, 0.0409 at 4e-4, 0.0559 at 5e-4 (a spike at step
# 10) and 0.0089 at 6e-4 (the loss rose to 11.92 by step 11); at 3e-4
# two calls gave the same losses to four decimals (an NVIDIA H100 80GB
# HBM3 at 700 W).
JAMBA_TRAIN_STEPS = 20


def jamba_train_phase(torch, gpu: str) -> tuple[str, dict]:
    """jamba-v0.1-52b training at full width: (a) one f32 step of the
    jamba phase's three-layer cut (mamba, mamba_moe, attn; about 3.96 B
    parameters, drawn on the card) at batch 1 x 600 (two 256-step chunks
    and a padded third: 600 is not a multiple of the chunk), its loss and
    every grad leaf with the kernels on the card (#12 keeping its chunk
    starts, #12b, the flash and FFN backward kernels in f32) against the
    plain path on the CPU, within TRAIN_LOSS_TOL, TRAIN_GRAD_TOL and
    TRAIN_GRAD_REL_TOL; (b) python -m repro_torch.launch.train's loop over
    ``train_cut()`` (mamba, attn: 1,036,464,128 parameters, the depth one
    card trains with f32 params and AdamW), bf16 activations, batch 8 x
    512, JAMBA_TRAIN_STEPS cosine steps to peak lr 3e-4, params drawn on
    the card, every
    launch counter zeroed just before and read just after.  Fails unless
    the loss falls by more than TRAIN_LOSS_DROP and every kernel of
    JAMBA_TRAIN_KERNELS launched.  The forward scan's launches are counted,
    not assumed: under remat "minimal" the backward reruns #12."""
    from repro_torch.configs.jamba_v0_1_52b import TRAIN_CUT, train_cut
    from repro_torch.models.common import LayerGroup
    cfg = train_cut().scaled(num_layers=len(JAMBA_CUT),
                             groups=(LayerGroup(JAMBA_CUT, 1),))
    errs, failed = f32_step_errs(torch, cfg, 1, XLSTM_PROMPT, on_card=True)
    torch.cuda.empty_cache()
    run, more = bf16_train_run(torch, train_cut(), JAMBA_TRAIN_KERNELS,
                               steps=JAMBA_TRAIN_STEPS, draw_on_device=True)
    failed += more
    torch.cuda.empty_cache()
    what = (f"jamba-v0.1-52b f32, the cut {'/'.join(JAMBA_CUT)} at full "
            f"width, batch 1 x {XLSTM_PROMPT}")
    per = {n: run["launches"][n] / JAMBA_TRAIN_STEPS
           for n in ("ssm_scan", "ssm_scan_bwd")}
    line = (f"jamba_train: {step_errs_text(errs, what)}; CPU side "
            f"{errs['cpu_s']:.1f} s, card {errs['cuda_s']:.1f} s; "
            f"train_cut() {'/'.join(TRAIN_CUT)} (1,036,464,128 params): "
            f"{run['text']}; a step launched ssm_scan {per['ssm_scan']:g} "
            f"and ssm_scan_bwd {per['ssm_scan_bwd']:g} times [{gpu}]")
    if failed:
        raise AssertionError(line + "\njamba_train phase failed: "
                             + "; ".join(failed))
    return line, {n: run["launches"][n] for n in JAMBA_TRAIN_KERNELS}


# kernel-name substrings -> the groups of the train profile
# #2's kernels: bf16 on the tensor cores (gate/up, down), f32 on the SIMT
# kernel, and the split reduce (which the bf16 dx kernel's split K, off
# the train path's shapes, also runs)
FFN_FWD_KERNELS = ("ffn_fwd_kernel", "ffn_gate_up_tc_kernel",
                   "ffn_down_tc_kernel", "ffn_reduce_kernel")
# #1: bf16 at head dims 64 and 128 on the tensor cores, else SIMT
FLASH_FWD_KERNELS = ("flash_fwd_kernel", "flash_fwd_tc_kernel")
# #3, #8 and #9: the split kernel (f32 on the CUDA cores, bf16 on
# mma.sync) over the dense, the paged or the int8 paged cache policy
DECODE_KERNELS = ("split_decode_kernel", "split_decode_mma_kernel")
PROFILE_GROUPS = (
    ("flash_attention (fwd)", FLASH_FWD_KERNELS),
    ("flash_attention_bwd_dq", ("flash_bwd_dq_kernel",
                                "flash_bwd_dq_tc_kernel")),
    ("flash_attention_bwd_dkv", ("flash_bwd_dkv_kernel",
                                 "flash_bwd_dkv_tc_kernel")),
    ("fused_ffn (fwd)", FFN_FWD_KERNELS),
    ("fused_ffn_bwd_dx", ("ffn_bwd_dx_kernel", "ffn_bwd_grad_tc_kernel",
                          "ffn_bwd_dx_tc_kernel")),
    ("fused_ffn_bwd_dw", ("ffn_bwd_dw_kernel", "ffn_bwd_dw_tc_kernel",
                          "ffn_dw_reduce_kernel")),
    ("cuBLAS GEMMs", ("gemm", "Gemm", "cutlass", "xmma", "nvjet")),
)


def device_events(prof) -> tuple[dict, int]:
    """Device microseconds by kernel name in a profile (user annotations
    left out: a trace may hold device-side copies of them, which span the
    kernels they enclose) and the number of device events.  The times are
    the union of the events' intervals: where two overlap (#13's output
    kernel starts inside the walk it depends on), the overlap counts once,
    for the event that started first, so the values sum to the time the
    device was busy."""
    from torch.autograd import DeviceType
    spans = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                    ev.name())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.device_type() == DeviceType.CUDA
                   and not ev.is_user_annotation())
    per, busy_to = {}, float("-inf")
    for start, end, name in spans:
        per[name] = per.get(name, 0) + max(0, end - max(start, busy_to)) / 1e3
        busy_to = max(busy_to, end)
    return per, len(spans)


def train_profile_phase(torch, gpu: str, steps: int = 3) -> str:
    """``torch.profiler`` over ``steps`` bf16 train
    steps (exanode-100m, batch 8 x 512, after one warm-up step and
    ``steps`` unprofiled ones): the device time of each kernel group per
    step, its share of the device time, the device's idle share (1 -
    device time / the unprofiled steps' host wall time, as the other
    profiles take it; one stream, so kernels do not overlap) and the host
    ops that take most of the profiled steps' CPU time (self time, which
    the profiler inflates).  Device time is the union of the trace's
    device events (kernels, copies, sets) but its user annotations: a
    trace may hold
    device-side copies of those (the autograd Functions' names), which
    span the kernels they enclose and would count them twice.  A device
    time above the profiled wall time raises."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import DataConfig, synthetic_batch, to_device
    from repro_torch.runtime import Runtime
    rt = Runtime.create("exanode-100m", shape_kind="train", seq_len=512)
    dcfg = DataConfig(rt.cfg.vocab_size, 512, 8)
    batches = [to_device(synthetic_batch(dcfg, i), "cuda")
               for i in range(2 * steps + 1)]
    state, _ = rt.train_step(rt.init_train_state(), batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[1:steps + 1]:
        state, _ = rt.train_step(state, b)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[steps + 1:]:
            state, _ = rt.train_step(state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    per, _ = device_events(prof)   # kernel name -> device us
    notes = sum(ev.duration_ns() / 1e3    # device-side annotations' us
                for ev in prof.profiler.kineto_results.events()
                if ev.device_type() == DeviceType.CUDA
                and ev.is_user_annotation())
    total = sum(per.values())
    if not total:
        raise AssertionError("train_profile: the profiler recorded no "
                             "device time")
    if total / 1e6 > wall:
        raise AssertionError(f"train_profile: device time {total / 1e3:.1f}"
                             f" ms exceeds the wall time "
                             f"{wall * 1e3:.1f} ms: {sorted(per)}")
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["other"] = 0.0
    for key, us in per.items():
        name = next((n for n, subs in PROFILE_GROUPS
                     if any(x in key for x in subs)), "other")
        if name == "other" and "flash_" in key:
            raise AssertionError(f"train_profile: flash kernel {key} falls "
                                 f"in no group")
        groups[name] += us
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return (f"train_profile: exanode-100m bf16 batch 8 x 512, {steps} "
            f"steps after one warm-up: wall {plain_wall / steps * 1e3:.1f} "
            f"ms a step unprofiled ({wall / steps * 1e3:.1f} profiled), "
            f"device time {total / steps / 1e3:.1f} ms a step, idle share "
            f"{1 - total / 1e6 / plain_wall:.4f} (device-side "
            f"annotations left out: {notes / steps / 1e3:.1f} ms a step); "
            f"host self CPU a profiled step: " + "; ".join(
                f"{e.key[:40]} {e.self_cpu_time_total / steps / 1e3:.2f} ms "
                f"({e.count // steps} calls)" for e in host[:6]) + "; "
            f"per step "
            f"by group: " + "; ".join(
                f"{n} {us / steps / 1e3:.2f} ms ({us / total:.4f})"
                for n, us in groups.items())
            + "; top kernels: " + "; ".join(
                f"{k[:60]} {us / steps / 1e3:.2f} ms" for k, us in top)
            + f" [{gpu}]")


XLSTM_PROFILE_GROUPS = (
    ("mlstm_scan", ("mlstm_carry_kernel", "mlstm_out_kernel")),
    ("cuBLAS GEMMs", ("gemm", "Gemm", "cutlass", "xmma", "nvjet")),
)


def profile_windows(torch, runs: dict, kernel_groups, what: str) -> list:
    """For each named window (fn, n) of ``runs``: the unprofiled wall of n
    calls (best of 2), then torch.profiler over n more: device time by
    kernel group (``kernel_groups``: (group, kernel-name substrings); the
    rest is "other"), device kernels a call, and the idle share 1 -
    device time / wall, the wall taken without the profiler (whose
    per-op cost inflates a host-bound loop).  One line part a window."""
    from torch.profiler import ProfilerActivity, profile
    parts = []
    for name, (fn, n) in runs.items():
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / n)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        per, count = device_events(prof)
        total = sum(per.values()) / n
        groups = {g: 0.0 for g, _ in kernel_groups}
        groups["other"] = 0.0
        for key, us in per.items():
            g = next((g for g, subs in kernel_groups
                      if any(x in key for x in subs)), "other")
            groups[g] += us / n
        w = min(walls)
        if not total:
            raise AssertionError(f"{what}: no device time in {name}")
        parts.append(
            f"{name}: wall {w * 1e3:.2f} ms (unprofiled, best of 2), device "
            f"time {total / 1e3:.2f} ms, idle share "
            f"{1 - total / 1e3 / (w * 1e3):.4f}, {count / n:.0f} device "
            f"kernels; by group " + ", ".join(
                f"{g} {us / 1e3:.2f} ms" for g, us in groups.items()))
    return parts


JAMBA_PROFILE_GROUPS = (
    ("ssm_scan", ("ssm_scan_kernel",)),
    ("fused_ffn", FFN_FWD_KERNELS),
    ("flash_attention", FLASH_FWD_KERNELS),
    ("decode_attention", DECODE_KERNELS),
    ("cuBLAS GEMMs", ("gemm", "Gemm", "cutlass", "xmma", "nvjet")),
)


def jamba_profile_phase(torch, gpu: str, ticks: int = 8) -> str:
    """Where one bf16 period of jamba-v0.1-52b spends a prefill call
    (16 x 1024, the serve run's largest) and a decode tick (16 slots), on
    the engine's serving params: ``profile_windows`` by kernel group (the
    MoE experts' and the projections' products are the cuBLAS GEMMs)."""
    import numpy as np
    from repro_torch.configs.jamba_v0_1_52b import one_period
    from repro_torch.runtime import Runtime
    period = one_period()
    rt = Runtime.create(period, capacity=2048, param_dtype=torch.bfloat16,
                        params=card_params(torch, period, torch.bfloat16))
    eng = rt.engine(num_slots=16)
    B, S = 16, 1024
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, rt.cfg.vocab_size, (B, S), dtype=np.int32)).to("cuda")
    batch = {"tokens": toks,
             "lengths": torch.full((B,), S, dtype=torch.int32,
                                   device="cuda")}
    runs = {"prefill": (lambda: eng._prefill(eng.params, batch), 1),
            "tick": (lambda: eng._decode(eng.params, eng._tok, eng.caches,
                                         eng._pos), ticks)}
    parts = profile_windows(torch, runs, JAMBA_PROFILE_GROUPS,
                            "jamba_profile")
    del eng, rt
    torch.cuda.empty_cache()
    return (f"jamba_profile: jamba-v0.1-52b one period bf16, slots 16, "
            f"capacity 2048; " + "; ".join(parts) + f" [{gpu}]")


def xlstm_profile_phase(torch, gpu: str, ticks: int = 8) -> str:
    """Where an xlstm-125m bf16 prefill and decode tick spend their time,
    on the engine's serving params (16 slots, capacity 2048):

    * host wall (synchronized, best of a few calls) of one mLSTM layer and
      one sLSTM layer, at the serve run's largest prefill batch (16 x 1024)
      and in one decode step over 16 slots, and the mLSTM kernel's own time
      in that prefill (CUDA events);
    * torch.profiler over one whole prefill call (16 x 1024) and over
      ``ticks`` decode ticks: device time by kernel group, device kernels
      launched, and the idle share 1 - device time / wall, the wall taken
      without the profiler (whose per-op cost inflates a host-bound
      loop)."""
    import numpy as np
    from repro_torch.kernels import mlstm_scan as ml
    from repro_torch.models import ssm
    from repro_torch.models.blocks import STATE_LEAVES, layer
    from repro_torch.runtime import Runtime
    rt = Runtime.create("xlstm-125m", capacity=2048)
    eng = rt.engine(num_slots=16)
    cfg, xl = rt.cfg, rt.cfg.xlstm
    lp = layer(eng.params["groups"][0], 0)
    B, S = 16, 1024
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(B, S, cfg.d_model, generator=gen,
                    device="cuda").to(cfg.dtype)

    def wall(fn, n: int) -> float:
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    state = {kind: tuple(eng.caches[0][sub][n][0] for n in STATE_LEAVES[kind])
             for kind, sub in (("mlstm", "sub0"), ("slstm", "sub3"))}
    mix = {"mlstm": lp["sub0"]["mixer"], "slstm": lp["sub3"]["mixer"]}
    layer_s = {
        ("prefill", "mlstm"): wall(lambda: ssm.mlstm(x, mix["mlstm"], cfg,
                                                     xl), 3),
        ("prefill", "slstm"): wall(lambda: ssm.slstm(x, mix["slstm"], cfg,
                                                     xl), 1),
        ("tick", "mlstm"): wall(lambda: ssm.mlstm_decode(
            x[:, :1], mix["mlstm"], cfg, xl, state["mlstm"]), 20),
        ("tick", "slstm"): wall(lambda: ssm.slstm_decode(
            x[:, :1], mix["slstm"], cfg, xl, state["slstm"]), 20)}
    dh = int(xl.mlstm_proj_factor * cfg.d_model) // cfg.num_heads
    q = torch.randn(B, cfg.num_heads, S, dh, generator=gen, device="cuda")
    ig = torch.randn(B, cfg.num_heads, S, generator=gen, device="cuda")
    fl = torch.nn.functional.logsigmoid(ig + 2.0)
    kernel_ms = Timer(torch, 5).ms(lambda: ml.mlstm_scan(
        q, q * dh ** -0.5, q, ig, fl, chunk=xl.chunk))

    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)).to("cuda")
    batch = {"tokens": toks,
             "lengths": torch.full((B,), S, dtype=torch.int32,
                                   device="cuda")}
    runs = {"prefill": (lambda: eng._prefill(eng.params, batch), 1),
            "tick": (lambda: eng._decode(eng.params, eng._tok, eng.caches,
                                         eng._pos), ticks)}
    parts = profile_windows(torch, runs, XLSTM_PROFILE_GROUPS,
                            "xlstm_profile")
    return (f"xlstm_profile: xlstm-125m bf16, slots 16; one layer's host "
            f"wall: prefill 16 x 1024 mLSTM "
            f"{layer_s[('prefill', 'mlstm')] * 1e3:.2f} ms (its mlstm_scan "
            f"kernel {kernel_ms:.3f} ms by CUDA events), sLSTM "
            f"{layer_s[('prefill', 'slstm')] * 1e3:.2f} ms; decode step "
            f"mLSTM {layer_s[('tick', 'mlstm')] * 1e3:.3f} ms, sLSTM "
            f"{layer_s[('tick', 'slstm')] * 1e3:.3f} ms (x 9 and x 3 a "
            f"model); " + "; ".join(parts) + f" [{gpu}]")


def model_phase(torch) -> str:
    """Full-width f32 logits: kernels on the card vs plain path on CPU."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.common import init_params, tree_map
    from repro_torch.models.registry import model_specs
    from repro_torch.runtime import Runtime
    cfg = get_config("exanode-100m").scaled(dtype=torch.float32)
    cpu_params = init_params(model_specs(cfg), seed=0)
    gpu_params = tree_map(lambda t: t.to("cuda"), cpu_params)
    sides = {dev: Runtime.create(cfg, capacity=256, device=dev, params=p)
             for dev, p in (("cpu", cpu_params), ("cuda", gpu_params))}
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 128),
                                             dtype=np.int32)
    logits, caches = {}, {}
    for dev, rt in sides.items():
        logits[dev], caches[dev] = rt.prefill(torch.from_numpy(toks).to(dev))
    errs = [float((logits["cuda"].cpu() - logits["cpu"]).abs().max())]
    nxt = logits["cpu"][:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = torch.full((2,), 128, dtype=torch.int32)
    for _ in range(4):
        for dev, rt in sides.items():
            logits[dev] = rt.decode_step(nxt.to(dev), caches[dev],
                                         pos.to(dev))
        errs.append(float((logits["cuda"].cpu() - logits["cpu"]).abs()
                          .max()))
        nxt = logits["cpu"][:, -1].argmax(-1).to(torch.int32)[:, None]
        pos = pos + 1
    if not max(errs) <= MODEL_LOGITS_TOL:
        raise AssertionError(f"model logits max abs err {errs} over "
                             f"{MODEL_LOGITS_TOL}")
    toks[1, :32] = toks[0, :32]                  # two shared pool blocks
    paged = {kv: paged_model_errs(torch, sides, toks, kv)
             for kv in ("f32", "int8")}
    for kv, res in paged.items():
        if not max(res["errs"]) <= MODEL_LOGITS_TOL:
            raise AssertionError(f"paged {kv} model logits max abs err "
                                 f"{res['errs']} over {MODEL_LOGITS_TOL}")
    fmt = lambda es: [float(f"{e:.3g}") for e in es]       # noqa: E731
    return (f"model: exanode-100m f32, 2 prompts x 128 tokens; max abs "
            f"logits err prefill {errs[0]:.3g}, decode ticks "
            f"{fmt(errs[1:])}; paged (block_size 16, two shared blocks): "
            f"pools spliced on the card against the CPU's, f32 max abs err "
            f"{paged['f32']['splice_err']:.3g}, int8 "
            f"{paged['int8']['stepped']:.3g} of values one step apart; "
            f"decode ticks from the CPU's pools, f32 pool "
            f"{fmt(paged['f32']['errs'])}, int8 pool "
            f"{fmt(paged['int8']['errs'])} against the int8 plain path "
            f"(tol {MODEL_LOGITS_TOL})")


def paged_model_errs(torch, sides: dict, toks, kv_dtype: str) -> dict:
    """Paged pools of ``kv_dtype`` after a prefill of ``toks``, then four
    paged decode ticks.  Each side prefills and splices its own pools; the
    card's are compared with the CPU's (positions equal; int8 payloads
    within one quantization step, the share of values a step apart
    reported).  The ticks then start both sides from the CPU's pools, so
    they decode from the same quantized numbers and the kernels are what
    is compared: max abs logits error per tick, card against CPU."""
    import numpy as np
    from repro_torch.models.common import tree_map
    from repro_torch.models.registry import model_paged_decode_step
    from repro_torch.serve import blockpool as bp
    rt = sides["cpu"]
    B, S, bs = toks.shape[0], toks.shape[1], 16
    M = rt.capacity // bs
    pool = bp.BlockPool(B * M + bp.NUM_RESERVED, bs, B, M,
                        max_entries=rt.capacity)
    dst = torch.from_numpy(np.stack([pool.admit(b, toks[b], -(-S // bs))
                                     for b in range(B)]))
    caches, logits = {}, {}
    for dev, side in sides.items():
        logits[dev], part = side.prefill(torch.from_numpy(toks).to(dev),
                                         last_only=True)
        caches[dev] = bp.paged_splice(
            bp.init_paged_cache(rt.cfg, pool.num_blocks, bs, kv_dtype,
                                device=dev), part, dst.to(dev))
    # the trash block takes colliding junk writes in no fixed order
    keep = torch.arange(pool.num_blocks) != bp.TRASH_BLOCK
    stepped, total, splice_err = 0, 0, 0.0
    for gc, gg in zip(caches["cpu"], caches["cuda"]):
        for name, sub in gc.items():
            for leaf, want in sub.items():
                got, want = gg[name][leaf].cpu()[:, keep], want[:, keep]
                if leaf == "pos":
                    if not torch.equal(got, want):
                        raise AssertionError("paged splice positions differ")
                    continue
                diff = (got.float() - want.float()).abs()
                if want.dtype == torch.int8:
                    if diff.max() > 1:
                        raise AssertionError(f"int8 {leaf} pools differ by "
                                             f"{int(diff.max())} steps")
                    stepped += int((diff > 0).sum())
                    total += diff.numel()
                else:
                    splice_err = max(splice_err, float(diff.max()))
    caches["cuda"] = tree_map(lambda t: t.to("cuda"), caches["cpu"])
    nxt = logits["cpu"][:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = torch.full((B,), S, dtype=torch.int32)
    errs = []
    for _ in range(4):
        bids = torch.tensor([pool.write_plan(b, True)[0] for b in range(B)],
                            dtype=torch.int32)
        table = torch.from_numpy(pool.table.copy())
        for dev, side in sides.items():
            logits[dev] = model_paged_decode_step(
                side.params, nxt.to(dev), caches[dev], rt.cfg,
                pos=pos.to(dev), block_table=table.to(dev),
                write_bids=bids.to(dev))
        errs.append(float((logits["cuda"].cpu() - logits["cpu"]).abs()
                          .max()))
        nxt = logits["cpu"][:, -1].argmax(-1).to(torch.int32)[:, None]
        pos = pos + 1
    return dict(errs=errs, splice_err=splice_err,
                stepped=stepped / total if total else 0.0)


def serve_run(torch, rt, prompts: list, new: int, **engine_kw) -> dict:
    """Serve ``prompts`` with ``new`` tokens each on a fresh
    ``rt.engine(num_slots=16, **engine_kw)``, every launch counter zeroed
    just before and read just after; raises unless every request finished
    with ``new`` tokens, and if a run without a fault plan (``injector``)
    evacuated."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Request
    eng = rt.engine(num_slots=16, **engine_kw)
    prefill, prefill_s = eng._prefill, [0.0]

    def timed_prefill(*args):
        t0 = time.perf_counter()
        res = prefill(*args)
        torch.cuda.synchronize()
        prefill_s[0] += time.perf_counter() - t0
        return res

    eng._prefill = timed_prefill
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=new))
    stats = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    if stats.finished != len(prompts) or any(len(r.generated) != new
                                             for r in eng.finished):
        counts = sorted(len(r.generated) for r in eng.finished)
        raise AssertionError(f"serve: {stats.summary}; token counts "
                             f"{counts}")
    if stats.evacuations and engine_kw.get("injector") is None:
        raise AssertionError(f"serve: a run without a fault plan evacuated "
                             f"({stats.summary}; {eng.ft_events})")
    return dict(eng=eng, wall=wall, prefill=prefill_s[0], launches=launches,
                streams={r.rid: r.generated for r in eng.finished})


def run_figures(run: dict) -> str:
    eng, wall, prefill_s = run["eng"], run["wall"], run["prefill"]
    stats, lat = eng.stats, eng.latency_summary()
    return (f"wall {wall:.3f} s of which prefill {prefill_s:.3f} s; decode "
            f"{stats.tokens_out / (wall - prefill_s):.1f} tok/s; TTFT p50 "
            f"{lat['ttft_p50'] * 1e3:.1f} ms p95 {lat['ttft_p95'] * 1e3:.1f}"
            f" ms; ITL p50 {lat['itl_p50'] * 1e3:.2f} ms p95 "
            f"{lat['itl_p95'] * 1e3:.2f} ms; evacuations {stats.evacuations}")


def serve_prompts(vocab: int) -> list:
    import numpy as np
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, int(n), dtype=np.int32)
            for n in rng.integers(64, 1025, 32)]


def serve_phase(torch, gpu: str) -> tuple[str, dict]:
    """Serves the 32 requests twice, each time on a fresh engine: first
    cold, as a warm-up that meets every prefill bucket and batch size of
    the run (allocator growth, cuBLAS set-up), then warm, with the launch
    counters zeroed just before.  The warm run's figures are the phase's;
    the cold run's wall and prefill are printed beside them."""
    from repro_torch.runtime import Runtime
    rt = Runtime.create("exanode-100m", capacity=2048)
    prompts, new = serve_prompts(rt.cfg.vocab_size), 64
    cold = serve_run(torch, rt, prompts, new)
    warm = serve_run(torch, rt, prompts, new)
    launches = warm["launches"]
    if not all(launches[n] for n in ("flash_attention", "fused_ffn",
                                     "decode_attention")):
        raise AssertionError(f"serve: a kernel never launched: {launches}")
    line = (f"serve: exanode-100m bf16 capacity=2048 slots=16, "
            f"{len(prompts)} requests x {new} new tokens, prompts 64-1024 "
            f"({warm['eng'].stats.summary}); warm run after one identical "
            f"cold run (cold: wall {cold['wall']:.3f} s, prefill "
            f"{cold['prefill']:.3f} s); {run_figures(warm)}; launches "
            f"{launches} [{gpu}]")
    return line, launches


XLSTM_PROMPT = 600       # 2 x 256 + 88: the last chunk is padded


def xlstm_phase(torch, gpu: str) -> tuple[str, dict]:
    """xlstm-125m at full width: (a) in f32, prefill logits of two
    600-token prompts at every position and four decode ticks, the
    mLSTM kernel on the card against the plain path on the CPU, within
    MODEL_LOGITS_TOL; (b) the serve phase's 32 requests served in bf16 on
    ``Runtime.create("xlstm-125m", capacity=2048).engine(num_slots=16)``,
    cold and then warm, every launch counter zeroed just before the warm
    run.  Fails unless mlstm_scan launched 9 times (once per mLSTM layer)
    per prefill call of the warm run."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.common import init_params, tree_map
    from repro_torch.models.registry import model_specs
    from repro_torch.runtime import Runtime
    cfg = get_config("xlstm-125m").scaled(dtype=torch.float32)
    cpu_params = init_params(model_specs(cfg), seed=0)
    sides = {dev: Runtime.create(cfg, capacity=2048, device=dev, params=p)
             for dev, p in (("cpu", cpu_params),
                            ("cuda", tree_map(lambda t: t.to("cuda"),
                                              cpu_params)))}
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                             (2, XLSTM_PROMPT), dtype=np.int32)
    logits, caches = {}, {}
    for dev, rt in sides.items():
        logits[dev], caches[dev] = rt.prefill(torch.from_numpy(toks).to(dev))
    errs = [float((logits["cuda"].cpu() - logits["cpu"]).abs().max())]
    nxt = logits["cpu"][:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = torch.full((2,), XLSTM_PROMPT, dtype=torch.int32)
    for _ in range(4):
        for dev, rt in sides.items():
            logits[dev] = rt.decode_step(nxt.to(dev), caches[dev],
                                         pos.to(dev))
        errs.append(float((logits["cuda"].cpu() - logits["cpu"]).abs()
                          .max()))
        nxt = logits["cpu"][:, -1].argmax(-1).to(torch.int32)[:, None]
        pos = pos + 1
    del sides, logits, caches
    fmt = [float(f"{e:.3g}") for e in errs]
    failed = []
    if not max(errs) <= MODEL_LOGITS_TOL:
        failed.append(f"f32 logits max abs err {fmt} over "
                      f"{MODEL_LOGITS_TOL}")

    rt = Runtime.create("xlstm-125m", capacity=2048)
    prompts, new = serve_prompts(rt.cfg.vocab_size), 64
    cold = serve_run(torch, rt, prompts, new)
    warm = serve_run(torch, rt, prompts, new)
    eng, launches = warm["eng"], warm["launches"]
    calls = eng.stats.prefill_calls
    if launches["mlstm_scan"] != 9 * calls or not calls:
        failed.append(f"mlstm_scan launched {launches['mlstm_scan']} times "
                      f"over {calls} prefill calls, not 9 per call")
    line = (f"xlstm: xlstm-125m f32, 2 prompts x {XLSTM_PROMPT} tokens; max "
            f"abs logits err prefill (every position) {fmt[0]}, decode "
            f"ticks {fmt[1:]} (tol {MODEL_LOGITS_TOL}); serve bf16 "
            f"capacity=2048 slots=16, {len(prompts)} requests x {new} new "
            f"tokens, prompts 64-1024 ({eng.stats.summary}); warm run after "
            f"one identical cold run (cold: wall {cold['wall']:.3f} s, "
            f"prefill {cold['prefill']:.3f} s); {run_figures(warm)}; state "
            f"bytes {eng.kv_cache_bytes()}; launches {launches} [{gpu}]")
    if failed:
        raise AssertionError(line + "\nxlstm phase failed: "
                             + "; ".join(failed))
    return line, launches


JAMBA_CUT = ("mamba", "mamba_moe", "attn")


@contextlib.contextmanager
def recorded_routes(torch):
    """Record every MoE routing decision (``models.moe._route``): device ->
    list of (top-k experts, the router probabilities sorted descending)."""
    from repro_torch.models import moe
    route, seen = moe._route, {}

    def wrapped(x, router_w, cfg):
        weights, top_e, aux = route(x, router_w, cfg)
        probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
        seen.setdefault(x.device.type, []).append(
            (top_e.cpu(), probs.sort(dim=-1, descending=True).values.cpu()))
        return weights, top_e, aux

    moe._route = wrapped
    try:
        yield seen
    finally:
        moe._route = route


def route_margin(seen: dict) -> str:
    """Where the card's and the CPU's expert choices first differ: the
    call, the token and the CPU's margin between the k-th and the
    (k+1)-th router probability there (a near-tie flips on rounding)."""
    for i, ((ge, _), (we, wp)) in enumerate(zip(seen["cuda"], seen["cpu"])):
        diff = (ge != we).any(-1).nonzero()
        if len(diff):
            t, k = int(diff[0]), ge.shape[-1]
            gap = float(wp[t, k - 1] - wp[t, k])
            return (f"first differing expert choice: MoE call {i}, token "
                    f"{t}, top-{k} margin {gap:.3g}")
    return "the expert choices agree on every MoE call"


def card_params(torch, cfg, dtype):
    """``cfg``'s params drawn on the card from seed 0 (13.3 B of them for
    one jamba period: a draw on the host would take minutes)."""
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import model_specs
    return init_params(model_specs(cfg), 0, dtype, "cuda",
                       draw_on_device=True)


def jamba_phase(torch, gpu: str) -> tuple[str, dict]:
    """jamba-v0.1-52b at full width, weights drawn on the card from seed 0:
    (a) in f32, a three-layer cut (mamba, mamba_moe, attn), prefill logits
    of two 600-token prompts at every position (not a multiple of the 256
    chunk: the mixer pads) and four decode ticks, the kernels on the card
    against the plain path on the CPU from the same weights, within
    MODEL_LOGITS_TOL; on a failure the line names the router-probability
    margin at the first expert choice where the two sides differ; (b) one
    8-layer period in bf16 serves the serve phase's 32 requests on
    ``Runtime.create(cfg, capacity=2048, param_dtype=bf16, params=
    card_params(...)).engine(num_slots=16)``, cold and then warm, every
    launch counter zeroed just before the warm run.  Fails unless
    ssm_scan launched 7 times (once per Mamba layer) per prefill call of
    the warm run and flash_attention, fused_ffn and decode_attention
    launched."""
    import numpy as np
    from repro_torch.configs.jamba_v0_1_52b import one_period
    from repro_torch.models.common import LayerGroup, tree_map
    from repro_torch.runtime import Runtime, recurrent_kinds
    from repro_torch.serve import kvcache
    cfg = one_period().scaled(num_layers=len(JAMBA_CUT),
                              groups=(LayerGroup(JAMBA_CUT, 1),),
                              dtype=torch.float32)
    gpu_params = card_params(torch, cfg, torch.float32)
    sides = {dev: Runtime.create(cfg, capacity=2048, device=dev, params=p)
             for dev, p in (("cuda", gpu_params),
                            ("cpu", tree_map(lambda t: t.cpu(),
                                             gpu_params)))}
    n_cut = sides["cpu"].num_params
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size,
                                              (2, XLSTM_PROMPT),
                                              dtype=np.int32)
    logits, caches = {}, {}
    t0 = time.perf_counter()
    with recorded_routes(torch) as seen:
        for dev, rt in sides.items():
            logits[dev], caches[dev] = rt.prefill(
                torch.from_numpy(toks).to(dev))
        errs = [float((logits["cuda"].cpu() - logits["cpu"]).abs().max())]
        nxt = logits["cpu"][:, -1].argmax(-1).to(torch.int32)[:, None]
        pos = torch.full((2,), XLSTM_PROMPT, dtype=torch.int32)
        for _ in range(4):
            for dev, rt in sides.items():
                logits[dev] = rt.decode_step(nxt.to(dev), caches[dev],
                                             pos.to(dev))
            errs.append(float((logits["cuda"].cpu() - logits["cpu"]).abs()
                              .max()))
            nxt = logits["cpu"][:, -1].argmax(-1).to(torch.int32)[:, None]
            pos = pos + 1
    f32_s = time.perf_counter() - t0
    margin = route_margin(seen)
    del sides, logits, caches, gpu_params, seen
    torch.cuda.empty_cache()
    fmt = [float(f"{e:.3g}") for e in errs]
    failed = []
    if not max(errs) <= MODEL_LOGITS_TOL:
        failed.append(f"f32 logits max abs err {fmt} over "
                      f"{MODEL_LOGITS_TOL} ({margin})")

    t0 = time.perf_counter()
    period = one_period()
    rt = Runtime.create(period, capacity=2048, param_dtype=torch.bfloat16,
                        params=card_params(torch, period, torch.bfloat16))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts, new = serve_prompts(rt.cfg.vocab_size), 64
    torch.cuda.reset_peak_memory_stats()
    cold = serve_run(torch, rt, prompts, new)
    warm = serve_run(torch, rt, prompts, new)
    peak = torch.cuda.max_memory_allocated()
    eng, launches = warm["eng"], warm["launches"]
    calls = eng.stats.prefill_calls
    mamba_layers = sum(recurrent_kinds(rt.cfg).values())      # 7 of 8
    if launches["ssm_scan"] != mamba_layers * calls or not calls:
        failed.append(f"ssm_scan launched {launches['ssm_scan']} times over "
                      f"{calls} prefill calls, not {mamba_layers} per call")
    missing = [n for n in ("flash_attention", "fused_ffn",
                           "decode_attention") if not launches[n]]
    if missing:
        failed.append(f"kernels of the path never launched: {missing}")
    line = (f"jamba: jamba-v0.1-52b f32 cut {'/'.join(JAMBA_CUT)} "
            f"({n_cut:,} params), 2 prompts x {XLSTM_PROMPT} tokens; max abs "
            f"logits err prefill (every position) {fmt[0]}, decode ticks "
            f"{fmt[1:]} (tol {MODEL_LOGITS_TOL}; {margin}; both sides "
            f"{f32_s:.1f} s); serve bf16 one period ({rt.num_params:,} "
            f"params, drawn on the card in {init_s:.1f} s) capacity=2048 "
            f"slots=16, {len(prompts)} requests x {new} new tokens, prompts "
            f"64-1024 ({eng.stats.summary}); warm run after one identical "
            f"cold run (cold: wall {cold['wall']:.3f} s, prefill "
            f"{cold['prefill']:.3f} s); {run_figures(warm)}; decode-state "
            f"bytes {eng.kv_cache_bytes()} (Mamba states "
            f"{kvcache.state_bytes_per_stream(rt.cfg)} a stream); peak "
            f"memory {peak / 2**30:.2f} GiB; launches {launches} [{gpu}]")
    del rt, cold, warm, eng
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(line + "\njamba phase failed: "
                             + "; ".join(failed))
    return line, launches


DENSE_ARCHS = ("qwen3-4b", "gemma-2b", "granite-20b")
DENSE_CUT = 2            # layers of the f32 check against the CPU
GRANITE_SERVE_LAYERS = 8   # of 52: 4.8 B params, 9.7 GB in bf16
# The bf16 serving depths (the time limit): qwen3-4b 12 of 36 layers,
# gemma-2b 6 of 18, granite-20b GRANITE_SERVE_LAYERS of 52.  With the
# jamba_train phase the whole script took 1253 s at full depth (PR 30's
# call 4 on an NVIDIA H100 80GB HBM3 at 700 W: the dense phase 260 s, of
# which qwen3-4b's four serve runs 51 s and gemma-2b's scheduled run 57).
DENSE_SERVE_LAYERS = {"qwen3-4b": 12, "gemma-2b": 6,
                      "granite-20b": GRANITE_SERVE_LAYERS}
DENSE_TRAIN_STEPS, DENSE_TRAIN_BATCH, DENSE_TRAIN_SEQ = 20, 8, 512
# what each dense config's runs must launch: #2 only where the FFN is
# SwiGLU (qwen3-4b; GeGLU stays plain, as in the reference), the flash
# backward at gemma-2b's head dim 256, the decode kernels at granite-20b's
# 48 q heads a kv head
DENSE_SERVE_KERNELS = {
    "dense": ("flash_attention", "decode_attention"),
    "int8": ("flash_attention", "paged_decode_attention_q8",
             "quantize_int8", "quantized_block_write"),
    "sched": ("decode_attention",)}


def dense_config(arch: str, **kw):
    """The registered config at full width cut to DENSE_SERVE_LAYERS[arch]
    layers (granite-20b's 52 do not fit one card's draw; the others: the
    time limit)."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import LayerGroup
    n = DENSE_SERVE_LAYERS[arch]
    cfg = get_config(arch).scaled(num_layers=n,
                                  groups=(LayerGroup(("attn",), n),))
    return cfg.scaled(**kw) if kw else cfg


def dense_f32_check(torch, arch: str) -> tuple[dict, dict]:
    """(a) of the dense phase for one config: ``f32_cut_check`` of its
    DENSE_CUT-layer cut at full width, the train step at batch 2 x 256."""
    from repro_torch.models.common import LayerGroup
    cfg = dense_config(arch, num_layers=DENSE_CUT,
                       groups=(LayerGroup(("attn",), DENSE_CUT),),
                       dtype=torch.float32)
    return f32_cut_check(torch, cfg, train_seq=256)


def f32_cut_check(torch, cfg, train_seq: int) -> tuple[dict, dict]:
    """A cut of a paged-capable config at full width in f32, weights drawn
    on the card and copied to the CPU; prefill logits of two
    XLSTM_PROMPT-token prompts at every position, four decode ticks over
    the dense cache, then over f32 and int8 paged pools
    (``paged_model_errs``), and one train step at batch 2 x ``train_seq``
    (loss, every grad leaf), the card's kernels against the plain path on
    the CPU.  With MoE blocks every routing decision of both sides is
    recorded, and the figures name where they first differ
    (``route_margin``).  Returns the figures and the launch counts of the
    card's side, zeroed just before."""
    import numpy as np
    from repro_torch.models.common import tree_map
    from repro_torch.runtime import Runtime
    gpu_params = card_params(torch, cfg, torch.float32)
    sides = {dev: Runtime.create(cfg, capacity=640, device=dev, params=p)
             for dev, p in (("cuda", gpu_params),
                            ("cpu", tree_map(lambda t: t.cpu(),
                                             gpu_params)))}
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size,
                                              (2, XLSTM_PROMPT),
                                              dtype=np.int32)
    torch.cuda.synchronize()
    routes = (recorded_routes(torch) if cfg.moe is not None
              else contextlib.nullcontext({}))
    with routes as seen:
        figs, launches = _f32_cut_runs(torch, cfg, sides, toks, train_seq)
    margin = route_margin(seen) if seen else ""
    if margin:
        figs["routes"] = margin
        figs["failed"] = [f"{b} ({margin})" for b in figs["failed"]]
    del sides, gpu_params, seen
    torch.cuda.empty_cache()
    return figs, launches


def _f32_cut_runs(torch, cfg, sides: dict, toks, train_seq: int):
    """The runs of ``f32_cut_check`` on both sides."""
    from repro_torch.data.pipeline import DataConfig, synthetic_batch, to_device
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.steps import value_and_grad
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, caches = {}, {}
    for dev, rt in sides.items():
        logits[dev], caches[dev] = rt.prefill(torch.from_numpy(toks).to(dev))
    errs = [float((logits["cuda"].cpu() - logits["cpu"]).abs().max())]
    nxt = logits["cpu"][:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = torch.full((2,), XLSTM_PROMPT, dtype=torch.int32)
    for _ in range(4):
        for dev, rt in sides.items():
            logits[dev] = rt.decode_step(nxt.to(dev), caches[dev],
                                         pos.to(dev))
        errs.append(float((logits["cuda"].cpu() - logits["cpu"]).abs()
                          .max()))
        nxt = logits["cpu"][:, -1].argmax(-1).to(torch.int32)[:, None]
        pos = pos + 1
    del logits, caches
    toks[1, :32] = toks[0, :32]                  # two shared pool blocks
    paged = {kv: paged_model_errs(torch, sides, toks, kv)
             for kv in ("f32", "int8")}
    batch = synthetic_batch(DataConfig(cfg.vocab_size, train_seq, 2), 0)
    res = {dev: value_and_grad(rt.params, to_device(batch, dev), cfg)
           for dev, rt in sides.items()}
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    loss_err = abs(float(res["cuda"][0]) - float(res["cpu"][0]))
    grad_err = grad_rel = 0.0
    bad = []
    for g, w in zip(tree_leaves(res["cuda"][2]), tree_leaves(res["cpu"][2])):
        diff = (g.cpu() - w).abs()
        grad_err = max(grad_err, float(diff.max()))
        grad_rel = max(grad_rel, rel_err(g.cpu(), w))
        if not bool((diff <= TRAIN_GRAD_TOL * (1 + w.abs())).all()):
            bad.append(f"grad leaf {tuple(w.shape)} max abs err "
                       f"{float(diff.max()):.3g}")
    if not loss_err <= TRAIN_LOSS_TOL * (1 + abs(float(res["cpu"][0]))):
        bad.append(f"loss differs by {loss_err:.3g}")
    for what, es in (("dense", errs), ("paged f32", paged["f32"]["errs"]),
                     ("paged int8", paged["int8"]["errs"])):
        if not max(es) <= MODEL_LOGITS_TOL:
            bad.append(f"{what} logits max abs err "
                       f"{[float(f'{e:.3g}') for e in es]} over "
                       f"{MODEL_LOGITS_TOL}")
    figs = dict(params=sides["cpu"].num_params, errs=errs, paged=paged,
                loss_err=loss_err, grad_err=grad_err, grad_rel=grad_rel,
                seconds=time.perf_counter() - t0, failed=bad)
    return figs, launches


def dense_phase(torch, gpu: str) -> tuple[str, dict]:
    """The dense family (qwen3-4b, gemma-2b, granite-20b).  (a) each at
    full width, DENSE_CUT layers, in f32 against the CPU
    (``dense_f32_check``: prefill and decode logits over dense, paged and
    int8 KV within MODEL_LOGITS_TOL, a train step's loss within
    TRAIN_LOSS_TOL and grads within TRAIN_GRAD_TOL).  (b) each served in
    bf16 with weights drawn on the card, qwen3-4b and gemma-2b at full
    depth, granite-20b at GRANITE_SERVE_LAYERS of 52 layers:
    ``Runtime.create(cfg, capacity=2048, param_dtype=bf16)`` serves the
    serve phase's 32 requests on 16 slots, dense KV and the int8 paged
    pool (block size 16), each cold and then warm, every launch counter
    zeroed just before each run; gemma-2b also once through the
    chunked-prefill scheduler, after those.  (c) gemma-2b's bf16 training at DENSE_CUT layers and
    batch 8 x 512 for 20 steps, the loss falling by more than
    TRAIN_LOSS_DROP.  Fails unless #4 / #5 launched in gemma-2b's (a) and
    (c) (head dim 256), #3, #8 and #9 in granite-20b's runs (G 48), #2 in
    qwen3-4b's and in no GeGLU config's."""
    import numpy as np
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_loop
    from repro_torch.models.common import LayerGroup, tree_leaves
    from repro_torch.runtime import Runtime
    parts, failed, total = [], [], {}

    def add(counts):
        for n, x in counts.items():
            total[n] = total.get(n, 0) + x

    for arch in DENSE_ARCHS:
        figs, launches = dense_f32_check(torch, arch)
        add(launches)
        failed += [f"{arch} f32: {b}" for b in figs["failed"]]
        need = ["flash_attention", "decode_attention",
                "paged_decode_attention", "paged_decode_attention_q8",
                "flash_attention_bwd_dq", "flash_attention_bwd_dkv"]
        if arch == "qwen3-4b":
            need += ["fused_ffn", "fused_ffn_bwd_dx", "fused_ffn_bwd_dw"]
        elif launches["fused_ffn"]:
            failed.append(f"{arch} f32: fused_ffn launched for GeGLU")
        missing = [n for n in need if not launches[n]]
        if missing:
            failed.append(f"{arch} f32: never launched {missing}")
        fmt = lambda es: [float(f"{e:.3g}") for e in es]    # noqa: E731
        parts.append(
            f"{arch} f32 {DENSE_CUT}-layer cut ({figs['params']:,} params), "
            f"2 prompts x {XLSTM_PROMPT}: logits err prefill "
            f"{figs['errs'][0]:.3g}, dense ticks {fmt(figs['errs'][1:])}, "
            f"paged f32 {fmt(figs['paged']['f32']['errs'])}, int8 "
            f"{fmt(figs['paged']['int8']['errs'])}; train step 2 x 256 loss "
            f"err {figs['loss_err']:.3g}, max abs grad err "
            f"{figs['grad_err']:.3g}, largest leaf ||err|| / ||grad|| "
            f"{figs['grad_rel']:.3g} ({figs['seconds']:.1f} s); launches "
            f"{ {n: x for n, x in launches.items() if x} }")

    for arch in DENSE_ARCHS:
        cfg = dense_config(arch)
        t0 = time.perf_counter()
        params = card_params(torch, cfg, torch.bfloat16)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prompts = serve_prompts(cfg.vocab_size)
        new = 64
        ways = {"dense": ({}, {}), "int8": (
            dict(kv_layout="paged", kv_dtype="int8"), dict(block_size=16))}
        if arch == "gemma-2b":
            ways["sched"] = (dict(scheduler=True), {})
        G = cfg.num_heads // cfg.num_kv_heads
        lines = []
        torch.cuda.reset_peak_memory_stats()
        for way, (kv, engine_kw) in ways.items():
            rt = Runtime.create(cfg, capacity=2048,
                                param_dtype=torch.bfloat16, params=params,
                                **kv)
            # the scheduler run comes after the two monolithic layouts'
            # cold and warm runs, which warmed the model: one run (~45 s
            # on the H100), not two
            cold = (None if way == "sched"
                    else serve_run(torch, rt, prompts, new, **engine_kw))
            warm = serve_run(torch, rt, prompts, new, **engine_kw)
            launches = warm["launches"]
            add(launches)
            need = list(DENSE_SERVE_KERNELS[way])
            if arch == "qwen3-4b":
                need.append("fused_ffn")
            elif launches["fused_ffn"]:
                failed.append(f"{arch} {way}: fused_ffn launched for GeGLU")
            missing = [n for n in need if not launches[n]]
            if missing:
                failed.append(f"{arch} {way}: never launched {missing}")
            if way == "sched" and warm["eng"].stats.prefill_calls:
                failed.append(f"{arch} sched: monolithic prefills ran")
            lines.append(
                f"{way}: " + (f"cold wall {cold['wall']:.3f} s prefill "
                              f"{cold['prefill']:.3f} s; warm " if cold
                              else "one run after the monolithic ones: ")
                + f"{run_figures(warm)}; launches "
                  f"{ {n: x for n, x in launches.items() if x} }")
            del rt, cold, warm
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(t.numel() for t in tree_leaves(params))
        del params
        torch.cuda.empty_cache()
        parts.append(
            f"{arch} bf16 serve, {cfg.num_layers} layers ({n_params:,} "
            f"params, drawn on the card in {init_s:.3f} s), capacity=2048 "
            f"slots=16, {len(prompts)} requests x {new} new tokens, G {G} "
            f"({da.head_groups(G)} head groups), head dim {cfg.head_dim}: "
            + "; ".join(lines) + f"; peak memory {peak / 2**30:.2f} GiB")

    cfg = dense_config("gemma-2b", num_layers=DENSE_CUT,
                       groups=(LayerGroup(("attn",), DENSE_CUT),))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    _, hist = train_loop(cfg, steps=DENSE_TRAIN_STEPS,
                         global_batch=DENSE_TRAIN_BATCH,
                         seq_len=DENSE_TRAIN_SEQ, log_every=DENSE_TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    add(launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    p50 = float(np.median([h["seconds"] for h in hist]))
    drop = float(np.mean(losses[:5]) - np.mean(losses[-5:]))
    if not all(np.isfinite(losses)) or not drop > TRAIN_LOSS_DROP:
        failed.append(f"gemma-2b train: loss fell by {drop:.4f}, not more "
                      f"than {TRAIN_LOSS_DROP}")
    missing = [n for n in ("flash_attention", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv") if not launches[n]]
    if missing or launches["fused_ffn"]:
        failed.append(f"gemma-2b train: launches {launches}")
    B, S = DENSE_TRAIN_BATCH, DENSE_TRAIN_SEQ
    parts.append(
        f"gemma-2b bf16 train, {DENSE_CUT} layers at full width, f32 params, "
        f"global batch {B} x {S}, {DENSE_TRAIN_STEPS} cosine steps: losses "
        f"{[round(x, 4) for x in losses]}; first-5 minus last-5 mean "
        f"{drop:.4f} (gate {TRAIN_LOSS_DROP}); step p50 {p50 * 1e3:.1f} ms, "
        f"{B * S / p50:.0f} tokens/s; peak memory {peak / 2**30:.3f} GiB; "
        f"launches { {n: x for n, x in launches.items() if x} }")
    line = "dense: " + " | ".join(parts) + f" [{gpu}]"
    if failed:
        raise AssertionError(line + "\ndense phase failed: "
                             + "; ".join(failed))
    return line, total


MOE_CUT = 2                 # layers of qwen3-moe's training
MOE_F32_CUT = 1             # layers of qwen3-moe's f32 check (the time limit)
# qwen3-moe's bf16 serving depth, 4 of 48 layers (3.1 B params), and the
# scheduler run's, 2: at 12 and 4 layers their seven runs took 77 of the
# moe phase's 180 s in PR 30's call 4 (the whole script 1253 s).
QWEN_MOE_SERVE_LAYERS = 4
QWEN_MOE_SCHED_LAYERS = 2
MIXTRAL_SERVE_LAYERS = 4    # of 32: 6.1 B params, 12 GB in bf16
# mixtral's f32 check: one layer at a capacity past the window (a ring of
# 4096), a prompt inside it and one past it, each decoded for some steps
MIXTRAL_F32_CAPACITY = 4608
MIXTRAL_F32_PROMPTS = (600, 4200)
MOE_DECODE_STEPS = 16
MOE_TRAIN_STEPS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 20, 8, 512
MOE_TRAIN_LR = 3e-4          # the launcher's default peak
# what each run of the moe phase must launch; no run launches #2 (every
# block is attn_moe, whose experts are torch.bmm)
MOE_KERNELS = {
    "dense": ("flash_attention", "decode_attention"),
    "paged": ("flash_attention", "paged_decode_attention"),
    "int8": ("flash_attention", "paged_decode_attention_q8",
             "quantize_int8", "quantized_block_write"),
    "sched": ("paged_decode_attention_q8", "quantized_block_write",
              "dequantize_int8"),
    "train": ("flash_attention", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv")}


def cut_params(params: dict, n: int) -> dict:
    """The first ``n`` layers of a stacked one-group parameter tree (views,
    no copy): the params of the same config cut to ``n`` layers."""
    from repro_torch.models.common import tree_map
    return dict(params, groups=[tree_map(lambda t: t[:n], g)
                                for g in params["groups"]])


def mixtral_ring_check(torch) -> tuple[dict, dict]:
    """mixtral-8x7b at full width cut to one layer, in f32, weights drawn
    on the card and copied to the CPU, capacity MIXTRAL_F32_CAPACITY (a
    ring of 4096 entries): each of MIXTRAL_F32_PROMPTS alone, prefill
    logits at every position, then MOE_DECODE_STEPS decode steps, the
    card's kernels against the plain path on the CPU.  The 4200-token
    prompt runs the prefill past the window (the flash forward masks, the
    cache keeps the last 4096 entries, rolled by 104 into ring order) and
    every decode step on a wrapped ring.  Returns the figures and the card
    side's launch counts."""
    import numpy as np
    from repro_torch.configs.mixtral_8x7b import cut
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_map
    from repro_torch.runtime import Runtime
    cfg = cut(1).scaled(dtype=torch.float32)
    gpu_params = card_params(torch, cfg, torch.float32)
    sides = {dev: Runtime.create(cfg, capacity=MIXTRAL_F32_CAPACITY,
                                 device=dev, params=p)
             for dev, p in (("cuda", gpu_params),
                            ("cpu", tree_map(lambda t: t.cpu(),
                                             gpu_params)))}
    figs = {"params": sides["cpu"].num_params, "errs": {}, "failed": []}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_routes(torch) as seen:
        for S in MIXTRAL_F32_PROMPTS:
            toks = np.random.default_rng(S).integers(0, cfg.vocab_size,
                                                     (1, S), dtype=np.int32)
            logits, caches = {}, {}
            for dev, rt in sides.items():
                logits[dev], caches[dev] = rt.prefill(
                    torch.from_numpy(toks).to(dev))
            errs = [float((logits["cuda"].cpu() - logits["cpu"]).abs()
                          .max())]
            ring = caches["cpu"][0]["sub0"]["pos"]
            if not torch.equal(caches["cuda"][0]["sub0"]["pos"].cpu(), ring):
                figs["failed"].append(f"{S}-token prompt: ring positions "
                                      f"differ")
            nxt = logits["cpu"][:, -1].argmax(-1).to(torch.int32)[:, None]
            pos = torch.full((1,), S, dtype=torch.int32)
            for _ in range(MOE_DECODE_STEPS):
                for dev, rt in sides.items():
                    logits[dev] = rt.decode_step(nxt.to(dev), caches[dev],
                                                 pos.to(dev))
                errs.append(float((logits["cuda"].cpu() - logits["cpu"])
                                  .abs().max()))
                nxt = logits["cpu"][:, -1].argmax(-1).to(torch.int32)[:, None]
                pos = pos + 1
            ring = caches["cpu"][0]["sub0"]["pos"]
            figs["errs"][S] = errs
            figs[f"ring_{S}"] = (f"T {ring.shape[-1]}, positions "
                                 f"{int(ring[ring >= 0].min())}-"
                                 f"{int(ring.max())}, "
                                 f"{'wrapped' if S >= ring.shape[-1] else 'unwrapped'}")
            if not max(errs) <= MODEL_LOGITS_TOL:
                figs["failed"].append(
                    f"{S}-token prompt: logits max abs err "
                    f"{[float(f'{e:.3g}') for e in errs]} over "
                    f"{MODEL_LOGITS_TOL}")
            del logits, caches
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    figs["routes"] = route_margin(seen)
    if figs["failed"]:
        figs["failed"] = [f"{b} ({figs['routes']})" for b in figs["failed"]]
    figs["seconds"] = time.perf_counter() - t0
    del sides, gpu_params, seen
    torch.cuda.empty_cache()
    return figs, launches


def moe_phase(torch, gpu: str) -> tuple[str, dict]:
    """The MoE family at full width, weights drawn on the card from seed 0.
    qwen3-moe-30b-a3b: (a) a MOE_F32_CUT-layer cut in f32 against the CPU
    (``f32_cut_check``: prefill and decode logits over dense, paged and
    int8 KV within MODEL_LOGITS_TOL, a train step at 2 x 512 within
    TRAIN_LOSS_TOL / TRAIN_GRAD_TOL); (b) QWEN_MOE_SERVE_LAYERS layers in
    bf16, ``Runtime.create(cfg, capacity=2048, param_dtype=bf16)`` serving
    the serve phase's 32 requests on 16 slots over dense KV, the paged
    pool and the int8 pool (block size 16), each twice on fresh engines:
    the two runs' streams must be equal (the top-8 combine is a fixed-order
    sum); then the int8 pool through the chunked-prefill scheduler (the
    reference's default knobs) at QWEN_MOE_SCHED_LAYERS layers; (c) the
    MOE_CUT-layer cut's bf16 training, batch 8 x 512, 20 cosine steps to
    the launcher's peak lr, the loss falling by more than TRAIN_LOSS_DROP.
    mixtral-8x7b: (d) MIXTRAL_SERVE_LAYERS layers in bf16 serving the same
    requests on its dense ring buffer (capacity 2048: a ring of 2048 that
    these prompts never wrap), twice, streams equal; (e)
    ``mixtral_ring_check`` (one layer in f32, a 4200-token prompt past the
    window).  Every launch counter is zeroed just before each run and read
    just after; fails unless each run launched its kernels
    (MOE_KERNELS), #2 never launched, and every check held."""
    from repro_torch.configs import mixtral_8x7b, qwen3_moe_30b_a3b
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.common import tree_leaves
    from repro_torch.runtime import Runtime
    parts, failed, total = [], [], {}
    fmt = lambda es: [float(f"{e:.3g}") for e in es]        # noqa: E731

    def add(counts, what, need):
        for n, x in counts.items():
            total[n] = total.get(n, 0) + x
        missing = [n for n in need if not counts[n]]
        if missing:
            failed.append(f"{what}: never launched {missing}")
        if counts["fused_ffn"]:
            failed.append(f"{what}: fused_ffn launched for an MoE stack")

    # (a) qwen3-moe, f32 cut against the CPU
    cut = qwen3_moe_30b_a3b.cut(MOE_F32_CUT).scaled(dtype=torch.float32)
    figs, launches = f32_cut_check(torch, cut, train_seq=MOE_TRAIN_SEQ)
    add(launches, "qwen3-moe f32", sorted(set(MOE_KERNELS["paged"]
                                              + MOE_KERNELS["int8"]
                                              + MOE_KERNELS["train"])))
    failed += [f"qwen3-moe f32: {b}" for b in figs["failed"]]
    parts.append(
        f"qwen3-moe-30b-a3b f32 {MOE_F32_CUT}-layer cut ({figs['params']:,} "
        f"params), 2 prompts x {XLSTM_PROMPT}: logits err prefill "
        f"{figs['errs'][0]:.3g}, dense ticks {fmt(figs['errs'][1:])}, paged "
        f"f32 {fmt(figs['paged']['f32']['errs'])}, int8 "
        f"{fmt(figs['paged']['int8']['errs'])}; train step 2 x "
        f"{MOE_TRAIN_SEQ} loss err {figs['loss_err']:.3g}, max abs grad err "
        f"{figs['grad_err']:.3g}, largest leaf ||err|| / ||grad|| "
        f"{figs['grad_rel']:.3g}; {figs['routes']} ({figs['seconds']:.1f} "
        f"s); launches { {n: x for n, x in launches.items() if x} }")

    # (b) qwen3-moe, bf16 serving
    cfg = qwen3_moe_30b_a3b.cut(QWEN_MOE_SERVE_LAYERS)
    prompts, new = serve_prompts(cfg.vocab_size), 64
    t0 = time.perf_counter()
    params = card_params(torch, cfg, torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    lines = []
    for way in ("dense", "paged", "int8"):
        rt = Runtime.create(cfg, capacity=2048, param_dtype=torch.bfloat16,
                            params=params, **SCHED_LAYOUTS[way])
        kw = {} if way == "dense" else dict(block_size=16)
        first = serve_run(torch, rt, prompts, new, **kw)
        second = serve_run(torch, rt, prompts, new, **kw)
        add(first["launches"], f"qwen3-moe {way}", MOE_KERNELS[way])
        add(second["launches"], f"qwen3-moe {way}", MOE_KERNELS[way])
        same = first["streams"] == second["streams"]
        if not same:
            share = match_share(first["streams"], second["streams"])
            failed.append(f"qwen3-moe {way}: two identical runs gave other "
                          f"streams (equal on {share:.4f} of positions)")
        lines.append(
            f"{way}: first wall {first['wall']:.3f} s prefill "
            f"{first['prefill']:.3f} s; second {run_figures(second)}; "
            f"streams of the two runs equal: {same}; launches "
            f"{ {n: x for n, x in second['launches'].items() if x} }")
        del rt, first, second
    peak = torch.cuda.max_memory_allocated()
    sched_cfg = qwen3_moe_30b_a3b.cut(QWEN_MOE_SCHED_LAYERS)
    rt = Runtime.create(sched_cfg, capacity=2048, param_dtype=torch.bfloat16,
                        params=cut_params(params, QWEN_MOE_SCHED_LAYERS),
                        scheduler=True, **SCHED_LAYOUTS["int8"])
    run = serve_run(torch, rt, prompts, new, block_size=16)
    add(run["launches"], "qwen3-moe sched", MOE_KERNELS["sched"])
    if run["eng"].stats.prefill_calls:
        failed.append("qwen3-moe sched: monolithic prefills ran")
    lines.append(
        f"int8 through the scheduler at {QWEN_MOE_SCHED_LAYERS} layers "
        f"(budget {run['eng'].sched.token_budget}, chunk "
        f"{run['eng'].sched.chunk_size}; one run after the monolithic ones):"
        f" {run_figures(run)}; launches "
        f"{ {n: x for n, x in run['launches'].items() if x} }")
    del rt, run
    G = cfg.num_heads // cfg.num_kv_heads
    parts.append(
        f"qwen3-moe-30b-a3b bf16 serve, {cfg.num_layers} of 48 layers "
        f"({sum(t.numel() for t in tree_leaves(params)):,} params, drawn "
        f"on the card in {init_s:.3f} s), 128 experts top-8, capacity=2048 "
        f"slots=16, {len(prompts)} requests x {new} new tokens, G {G} "
        f"({da.head_groups(G)} head group): " + "; ".join(lines)
        + f"; peak memory {peak / 2**30:.2f} GiB")
    del params
    torch.cuda.empty_cache()

    # (c) qwen3-moe, bf16 training
    run, more = bf16_train_run(
        torch, qwen3_moe_30b_a3b.cut(MOE_CUT), MOE_KERNELS["train"],
        steps=MOE_TRAIN_STEPS, B=MOE_TRAIN_BATCH, S=MOE_TRAIN_SEQ,
        lr=MOE_TRAIN_LR, draw_on_device=True)
    add(run["launches"], "qwen3-moe train", ())     # checked by the run
    failed += [f"qwen3-moe train: {b}" for b in more]
    parts.append(f"qwen3-moe-30b-a3b train, {MOE_CUT} layers at full width "
                 f"(params drawn on the card): {run['text']}")
    torch.cuda.empty_cache()

    # (d) mixtral, bf16 serving on its dense ring buffer
    cfg = mixtral_8x7b.cut(MIXTRAL_SERVE_LAYERS)
    prompts = serve_prompts(cfg.vocab_size)
    t0 = time.perf_counter()
    params = card_params(torch, cfg, torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    rt = Runtime.create(cfg, capacity=2048, param_dtype=torch.bfloat16,
                        params=params)
    first = serve_run(torch, rt, prompts, new)
    second = serve_run(torch, rt, prompts, new)
    peak = torch.cuda.max_memory_allocated()
    for r in (first, second):
        add(r["launches"], "mixtral dense", MOE_KERNELS["dense"])
    same = first["streams"] == second["streams"]
    if not same:
        failed.append("mixtral: two identical runs gave other streams")
    T = second["eng"].caches[0]["sub0"]["pos"].shape[2]
    parts.append(
        f"mixtral-8x7b bf16 serve, {cfg.num_layers} of 32 layers "
        f"({rt.num_params:,} params, drawn on the card in {init_s:.3f} s), "
        f"8 experts top-2, window {cfg.sliding_window}, capacity=2048 (a "
        f"ring of {T}) slots=16, {len(prompts)} requests x {new} new tokens "
        f"({second['eng'].stats.summary}): first wall {first['wall']:.3f} s "
        f"prefill {first['prefill']:.3f} s; second {run_figures(second)}; "
        f"streams of the two runs equal: {same}; launches "
        f"{ {n: x for n, x in second['launches'].items() if x} }; peak "
        f"memory {peak / 2**30:.2f} GiB")
    del rt, first, second, params
    torch.cuda.empty_cache()

    # (e) mixtral, f32 one-layer cut against the CPU past the window
    figs, launches = mixtral_ring_check(torch)
    add(launches, "mixtral f32", MOE_KERNELS["dense"])
    failed += [f"mixtral f32: {b}" for b in figs["failed"]]
    parts.append(
        f"mixtral-8x7b f32 1-layer cut ({figs['params']:,} params), capacity "
        f"{MIXTRAL_F32_CAPACITY}, one prompt at a time: " + "; ".join(
            f"{S} tokens ({figs[f'ring_{S}']} after {MOE_DECODE_STEPS} "
            f"steps): logits err prefill {es[0]:.3g}, decode {fmt(es[1:])}"
            for S, es in figs["errs"].items())
        + f" (tol {MODEL_LOGITS_TOL}; {figs['routes']}; both sides "
          f"{figs['seconds']:.1f} s); launches "
          f"{ {n: x for n, x in launches.items() if x} }")
    line = "moe: " + " | ".join(parts) + f" [{gpu}]"
    if failed:
        raise AssertionError(line + "\nmoe phase failed: "
                             + "; ".join(failed))
    return line, total


def match_share(a: dict, b: dict) -> float:
    """Share of token positions (every request, every new token) where two
    runs' greedy streams agree."""
    same = sum(x == y for rid in a for x, y in zip(a[rid], b[rid]))
    return same / sum(len(s) for s in a.values())


def paged_prompts(vocab: int) -> list:
    """The serve phase's prompts, requests 16-23 opening with prompt 0's
    first 256 tokens (16 shared blocks) where they are that long."""
    import numpy as np
    prompts = serve_prompts(vocab)
    for i in range(16, 24):
        if len(prompts[i]) >= 256:
            prompts[i] = np.concatenate([prompts[0][:256], prompts[i][256:]])
    return prompts


def paged_phase(torch, gpu: str) -> tuple[str, dict]:
    """``paged_prompts`` served dense, paged and paged int8, each once cold
    and once warm on a fresh engine.  The warm paged runs' launch counts
    are the paged kernels'.  A failed gate raises with every run's
    figures in its message."""
    from repro_torch.runtime import Runtime
    base = Runtime.create("exanode-100m", capacity=2048)
    prompts, new = paged_prompts(base.cfg.vocab_size), 64
    ways = {"dense": ({}, "decode_attention"),
            "paged": (dict(kv_layout="paged"), "paged_decode_attention"),
            "int8": (dict(kv_layout="paged", kv_dtype="int8"),
                     "paged_decode_attention_q8")}
    runs, lines, failed = {}, [], []
    for way, (kv, kernel) in ways.items():
        rt = Runtime.create("exanode-100m", capacity=2048,
                            params=base.params, **kv)
        engine_kw = dict(block_size=16) if kv else {}
        cold = serve_run(torch, rt, prompts, new, **engine_kw)
        warm = runs[way] = serve_run(torch, rt, prompts, new, **engine_kw)
        eng, launches = warm["eng"], warm["launches"]
        hits = eng.pool.prefix_hits if eng.paged else 0
        lines.append(f"{way}: cold wall {cold['wall']:.3f} s prefill "
                     f"{cold['prefill']:.3f} s; warm {run_figures(warm)}; "
                     f"launches {launches}; prefix_hits {hits}; "
                     f"kv_cache_bytes {eng.kv_cache_bytes()}")
        if not all(launches[n] for n in ("flash_attention", "fused_ffn",
                                         kernel)):
            failed.append(f"{way}: a kernel of its path never launched")
        if eng.paged and not hits > 0:
            failed.append(f"{way}: no prefix hits")
    int8_bytes = runs["int8"]["eng"].kv_cache_bytes()
    paged_bytes = runs["paged"]["eng"].kv_cache_bytes()
    if not int8_bytes < paged_bytes:
        failed.append(f"int8 pool {int8_bytes} B not below the bf16 pool's "
                      f"{paged_bytes} B")
    paged_dense = match_share(runs["paged"]["streams"],
                              runs["dense"]["streams"])
    int8_paged = match_share(runs["int8"]["streams"],
                             runs["paged"]["streams"])
    if not int8_paged >= INT8_MATCH_MIN:
        failed.append(f"int8 matches paged on {int8_paged:.4f} of token "
                      f"positions, below {INT8_MATCH_MIN}")
    for n in ("quantize_int8", "quantized_block_write"):
        if not runs["int8"]["launches"][n]:
            failed.append(f"int8: {n} never launched")
    launches = {n: sum(r["launches"][n] for r in (runs["paged"],
                                                   runs["int8"]))
                for n in ("paged_decode_attention",
                          "paged_decode_attention_q8", "quantize_int8",
                          "quantized_block_write")}
    line = (f"paged: exanode-100m bf16 capacity=2048 slots=16 block_size=16,"
            f" {len(prompts)} requests x {new} new tokens (requests 16-23 "
            f"open with prompt 0's first 256 tokens where that long); "
            + "; ".join(lines)
            + f"; paged matches dense on {paged_dense:.4f} of token "
              f"positions, int8 matches paged on {int8_paged:.4f} (gate "
              f"{INT8_MATCH_MIN}); int8 pool {int8_bytes} B vs bf16 pool "
              f"{paged_bytes} B [{gpu}]")
    if failed:
        raise AssertionError(line + "\npaged phase failed: "
                             + "; ".join(failed))
    return line, launches


SCHED_PROMPT, SCHED_CAPACITY = 600, 640  # f32 check: 19 chunks, last padded
SCHED_CHUNK = 32                         # the reference's default chunk
# The scheduler's serve runs (a cold and a warm one a layout, ~610 ticks
# each, host-bound) at 2 of exanode-100m's 12 layers, full width, beside
# monolithic runs at the same depth: at 12 layers they took 170 of the
# whole script's 765 s on the H100 (PR 28), at 4 about 87 of the sched
# phase's 106 s in PR 30's call 4, whose whole script took 1253 s.
SCHED_SERVE_LAYERS = 2
# per layout: the kernels a scheduler run must launch (the chunk attends in
# plain torch, as the reference's is jnp, so flash_attention does not run)
SCHED_KERNELS = {"dense": ("fused_ffn", "decode_attention"),
                 "paged": ("fused_ffn", "paged_decode_attention"),
                 "int8": ("fused_ffn", "paged_decode_attention_q8",
                          "quantized_block_write", "dequantize_int8")}
SCHED_LAYOUTS = {"dense": {}, "paged": dict(kv_layout="paged"),
                 "int8": dict(kv_layout="paged", kv_dtype="int8")}


def chunked_logits(torch, params, cfg, toks, layout: str, device) -> object:
    """``toks`` [1, S] through ``model_chunk_prefill`` in chunks of
    SCHED_CHUNK (the last padded with PAD_POS) into empty caches of
    SCHED_CAPACITY entries (paged: block size 16, the chain's blocks taken
    in reverse pool order); returns each chunk's last-token logits
    [chunks, Vp] on the CPU, and the caches."""
    import numpy as np
    from repro_torch.models.attention import PAD_POS
    from repro_torch.models.registry import model_chunk_prefill
    from repro_torch.serve import blockpool as bp
    from repro_torch.serve import kvcache
    S, C, bs = toks.shape[1], SCHED_CHUNK, 16
    M = SCHED_CAPACITY // bs
    if layout == "dense":
        caches = kvcache.init_cache(cfg, 1, SCHED_CAPACITY, device=device)
    else:
        caches = bp.init_paged_cache(
            cfg, M + bp.NUM_RESERVED, bs,
            "int8" if layout == "int8" else "f32", device=device)
        table = np.arange(M + bp.NUM_RESERVED - 1, bp.NUM_RESERVED - 1, -1,
                          dtype=np.int32)[None]
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    out = []
    for start in range(0, S, C):
        n = min(C, S - start)
        tok = np.zeros((1, C), np.int32)
        pos = np.full((1, C), PAD_POS, np.int32)
        tok[0, :n] = toks[0, start:start + n]
        pos[0, :n] = np.arange(start, start + n)
        paged = None
        if layout != "dense":
            bids = np.full((1, C), bp.TRASH_BLOCK, np.int32)
            bids[0, :n] = table[0, pos[0, :n] // bs]
            paged = {"block_table": dev(table), "write_bids": dev(bids)}
        logits = model_chunk_prefill(
            params, dev(tok), caches, cfg, positions=dev(pos),
            reset=torch.tensor([start == 0], device=device),
            last_index=dev(np.array([n - 1], np.int32)), paged=paged)
        out.append(logits[0, 0].float().cpu())
    return torch.stack(out), caches


@contextlib.contextmanager
def plain_int8_ops():
    """Inside: the int8 pool write and the dequantizing gather run their
    plain versions whatever the device (``kernels.ops`` dispatches CUDA
    tensors to the kernels), so the kernel path can be held against the
    plain path on the card itself."""
    from repro_torch.kernels import ops, ref
    saved = ops.quantized_block_write, ops.dequantize_gather

    def write(pools, scale_pools, news, write_bids, off):
        for pool, scale, new in zip(pools, scale_pools, news):
            ref.ref_quantized_block_write(pool, scale, new, write_bids, off)

    def gather(pools, scales, block_table, dtype):      # K and V
        return tuple(ref.ref_dequantize_gather(p, s, block_table, dtype)
                     for p, s in zip(pools, scales))

    ops.quantized_block_write = write
    ops.dequantize_gather = gather
    try:
        yield
    finally:
        ops.quantized_block_write, ops.dequantize_gather = saved


def sched_phase(torch, gpu: str) -> tuple[str, dict]:
    """The chunked-prefill scheduler.  (a) exanode-100m at full width in
    f32: a SCHED_PROMPT-token prompt through ``model_chunk_prefill`` in
    chunks of 32 over dense, paged and int8 pools; each chunk's last-token
    logits on the card within MODEL_LOGITS_TOL of the plain path on the
    CPU and of the monolithic prefill on the card at the same positions
    (dense, paged).  The int8 pool's logits are held within
    MODEL_LOGITS_TOL of the plain int8 path on the card, and its pools
    within one int8 code of the CPU's; their distances to the CPU's logits
    and to the monolithic prefill are printed (card and CPU products
    differ in the last bits, which moves some values to the next code).
    (b) ``Runtime.create(cfg, capacity=2048,
    scheduler=True).engine(num_slots=16)``, cfg exanode-100m at full width
    cut to SCHED_SERVE_LAYERS layers, with the reference's default knobs
    (token budget 256, chunk 32) serves the paged phase's 32 requests in
    bf16, dense, paged and int8 at block size 16, each cold and then warm
    with every launch counter zeroed just before; beside each, the
    monolithic engine's warm run of the same cut and layout (after a cold
    one) and the share of token positions where the two streams agree.
    Fails unless every request finishes, no
    monolithic prefill runs, the pools drain and every kernel of each
    layout's path launched (int8: the pool write and #11)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.common import LayerGroup, init_params, tree_map
    from repro_torch.models.registry import model_specs
    from repro_torch.runtime import Runtime
    from repro_torch.serve import blockpool as bp
    t_phase = time.perf_counter()
    cfg = get_config("exanode-100m").scaled(dtype=torch.float32)
    params = {"cpu": init_params(model_specs(cfg), seed=0)}
    params["cuda"] = tree_map(lambda t: t.to("cuda"), params["cpu"])
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                             (1, SCHED_PROMPT),
                                             dtype=np.int32)
    full, _ = Runtime.create(cfg, capacity=SCHED_CAPACITY,
                             params=params["cuda"]).prefill(
        torch.from_numpy(toks).to("cuda"))
    ends = [min(s + SCHED_CHUNK, SCHED_PROMPT) - 1
            for s in range(0, SCHED_PROMPT, SCHED_CHUNK)]
    full = full[0, ends].float().cpu()
    failed, f32 = [], {}
    for layout in SCHED_LAYOUTS:
        got, caches = {}, {}
        for dev, p in params.items():
            got[dev], caches[dev] = chunked_logits(torch, p, cfg, toks,
                                                   layout, dev)
        f32[layout] = [float((got["cuda"] - got["cpu"]).abs().max()),
                       float((got["cuda"] - full).abs().max())]
        if layout == "int8":
            # the card's f32 products differ from the CPU's in the last
            # bits, and a K/V value that close to a rounding boundary
            # takes the next int8 code, which every later chunk attends
            # to: hold the kernels against the plain int8 versions on the
            # card (same products, so the same codes), and the card's
            # payloads within one code of the CPU's
            with plain_int8_ops():
                plain, _ = chunked_logits(torch, params["cuda"], cfg, toks,
                                          layout, "cuda")
            f32[layout].append(float((got["cuda"] - plain).abs().max()))
            keep = torch.arange(caches["cpu"][0]["sub0"]["k"].shape[1]) \
                != bp.TRASH_BLOCK
            # the trash block holds the pads' entries, computed at
            # PAD_POS, whose RoPE angles (~1e9 rad) the two devices'
            # sin/cos round apart: junk no query reads, left out
            steps = max(
                int((g[leaf].cpu().int() - c[leaf].int())[:, keep]
                    .abs().max())
                for gg, cc in zip(caches["cuda"], caches["cpu"])
                for g, c in zip(gg.values(), cc.values())
                for leaf in ("k", "v"))
            f32[layout].append(steps)
            checks = [(f32[layout][2], "the plain int8 path on the card")]
            if steps > 1:
                failed.append(f"int8: pools {steps} codes from the CPU's")
        else:
            checks = [(f32[layout][0], "the CPU's"),
                      (f32[layout][1], "the monolithic prefill")]
        for err, what in checks:
            if not err <= MODEL_LOGITS_TOL:
                failed.append(f"{layout}: chunked logits {err:.3g} from "
                              f"{what}")
    del params, full
    f32_s = time.perf_counter() - t_phase

    scfg = get_config("exanode-100m").scaled(
        num_layers=SCHED_SERVE_LAYERS,
        groups=(LayerGroup(("attn",), SCHED_SERVE_LAYERS),))
    base = Runtime.create(scfg, capacity=2048)
    prompts, new = paged_prompts(base.cfg.vocab_size), 64
    lines, launches, mono = [], {}, {}
    for layout, kv in SCHED_LAYOUTS.items():
        engine_kw = dict(block_size=16) if kv else {}
        rt = Runtime.create(scfg, capacity=2048, params=base.params, **kv)
        serve_run(torch, rt, prompts, new, **engine_kw)
        mono[layout] = serve_run(torch, rt, prompts, new, **engine_kw)
        rt = Runtime.create(scfg, capacity=2048, params=base.params,
                            scheduler=True, **kv)
        cold = serve_run(torch, rt, prompts, new, **engine_kw)
        warm = serve_run(torch, rt, prompts, new, **engine_kw)
        eng, counts = warm["eng"], warm["launches"]
        for n, c in counts.items():
            launches[n] = launches.get(n, 0) + c
        share = match_share(warm["streams"], mono[layout]["streams"])
        lines.append(
            f"{layout}: cold wall {cold['wall']:.3f} s; warm "
            f"{eng.stats.summary}, {run_figures(warm)}; monolithic "
            f"({mono[layout]['eng'].stats.summary}) "
            f"{run_figures(mono[layout])}; streams equal to monolithic on "
            f"{share:.4f} of token positions; launches {counts}")
        if eng.stats.prefill_calls or not eng.stats.chunk_ticks:
            failed.append(f"{layout}: prefill_calls "
                          f"{eng.stats.prefill_calls}, chunk_ticks "
                          f"{eng.stats.chunk_ticks}")
        if eng.paged and eng.pool.used_blocks:
            failed.append(f"{layout}: {eng.pool.used_blocks} pool blocks "
                          f"still used")
        missing = [n for n in SCHED_KERNELS[layout] if not counts[n]]
        if missing:
            failed.append(f"{layout}: kernels of its path never launched: "
                          f"{missing}")
    line = (f"sched: exanode-100m f32, 1 prompt x {SCHED_PROMPT} tokens in "
            f"chunks of {SCHED_CHUNK}: max abs logits err against the CPU / "
            f"the monolithic prefill on the card: "
            + ", ".join(f"{k} {e[0]:.3g} / {e[1]:.3g}" for k, e in f32.items())
            + f"; int8 against the plain int8 path on the card "
              f"{f32['int8'][2]:.3g}, pools within {f32['int8'][3]} code(s) "
              f"of the CPU's (tol {MODEL_LOGITS_TOL}; int8 is held to the "
              f"plain path on the card and to one code) "
              f"[{f32_s:.1f} s]; serve bf16 {SCHED_SERVE_LAYERS} of 12 layers "
              f"capacity=2048 slots=16 "
              f"scheduler token_budget=256 chunk_size={SCHED_CHUNK}, "
              f"{len(prompts)} paged-phase requests x {new} new tokens; "
            + "; ".join(lines)
            + f"; phase wall {time.perf_counter() - t_phase:.1f} s [{gpu}]")
    if failed:
        raise AssertionError(line + "\nsched phase failed: "
                             + "; ".join(failed))
    return line, launches


SCHED_PROFILE_GROUPS = (
    ("fused_ffn", FFN_FWD_KERNELS),
    ("flash_attention", FLASH_FWD_KERNELS),   # not on the chunk path
    ("decode attention", DECODE_KERNELS),
    ("int8 kernels", ("quantize_rows_kernel", "dequantize_rows_kernel",
                      "block_write_kernel")),
    ("cuBLAS GEMMs", ("gemm", "Gemm", "cutlass", "xmma", "nvjet")),
)


def sched_profile_phase(torch, gpu: str, warm: int = 120,
                        ticks: int = 8) -> str:
    """Where a scheduler tick spends its time, per layout (dense, paged,
    int8 at block size 16), on ``Runtime.create("exanode-100m",
    capacity=2048, scheduler=True).engine(num_slots=16)`` serving the
    paged phase's requests in bf16: after ``warm`` ticks (a prompt in
    chunked prefill, some slots decoding), the wall of ``ticks`` ticks
    without the profiler (best of 2 windows), then torch.profiler over
    ``ticks`` more: device time by kernel group, device kernels a tick and
    the idle share 1 - device time / wall.  Every profiled tick is a mixed
    tick (decode + one 32-token chunk) while prompts wait."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime import Runtime
    from repro_torch.serve.engine import Request
    base = Runtime.create("exanode-100m", capacity=2048)
    prompts = paged_prompts(base.cfg.vocab_size)
    parts = []
    for layout, kv in SCHED_LAYOUTS.items():
        rt = Runtime.create("exanode-100m", capacity=2048,
                            params=base.params, scheduler=True, **kv)
        eng = rt.engine(num_slots=16, **(dict(block_size=16) if kv else {}))
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=64))
        for _ in range(warm):
            eng.tick()
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ticks):
                eng.tick()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / ticks)
        chunk0, decoding = eng.stats.chunk_ticks, sum(
            eng._decoding(s) for s in range(eng.num_slots))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(ticks):
                eng.tick()
            torch.cuda.synchronize()
        mixed = eng.stats.chunk_ticks - chunk0
        per, count = device_events(prof)
        total = sum(per.values()) / ticks
        if not total:
            raise AssertionError(f"sched_profile: no device time ({layout})")
        groups = {g: 0.0 for g, _ in SCHED_PROFILE_GROUPS}
        groups["other"] = 0.0
        for key, us in per.items():
            g = next((g for g, subs in SCHED_PROFILE_GROUPS
                      if any(x in key for x in subs)), "other")
            groups[g] += us / ticks
        w = min(walls)
        parts.append(
            f"{layout}: {mixed} of {ticks} profiled ticks mixed, "
            f"{decoding} slots decoding; wall {w * 1e3:.2f} ms a tick "
            f"(unprofiled, best of 2), device time {total / 1e3:.2f} ms, "
            f"idle share {1 - total / 1e3 / (w * 1e3):.4f}, "
            f"{count / ticks:.0f} device kernels a tick; by group "
            + ", ".join(f"{g} {us / 1e3:.2f} ms" for g, us in groups.items()))
    return (f"sched_profile: exanode-100m bf16 capacity=2048 slots=16 "
            f"scheduler token_budget=256 chunk_size={SCHED_CHUNK}, after "
            f"{warm} ticks of the paged phase's requests; "
            + "; ".join(parts) + f" [{gpu}]")


def int8_cpu_phase(torch, gpu: str, n_req: int = 8) -> str:
    """Not run by default: the int8 pool's greedy agreement with the bf16
    paged pool on the first ``n_req`` requests of ``paged_prompts``, on the
    card and, with the same weights, through the plain versions on the
    CPU, so a low share on the card can be told apart from a kernel
    fault."""
    from repro_torch.models.common import tree_map
    from repro_torch.runtime import Runtime
    base = Runtime.create("exanode-100m", capacity=2048)
    prompts, new = paged_prompts(base.cfg.vocab_size)[:n_req], 64
    params = {"cuda": base.params,
              "cpu": tree_map(lambda t: t.cpu(), base.params)}
    shares, walls = {}, {}
    for dev, p in params.items():
        streams = {}
        for kv in ("f32", "int8"):
            rt = Runtime.create("exanode-100m", capacity=2048, device=dev,
                                params=p, kv_layout="paged", kv_dtype=kv)
            run = serve_run(torch, rt, prompts, new, block_size=16)
            streams[kv], walls[(dev, kv)] = run["streams"], run["wall"]
        shares[dev] = match_share(streams["int8"], streams["f32"])
    return (f"int8_cpu: exanode-100m bf16, first {n_req} paged-phase "
            f"requests x {new} new tokens; int8 matches the bf16 paged pool "
            f"on {shares['cuda']:.4f} of token positions on the card and "
            f"{shares['cpu']:.4f} through the plain versions on the CPU "
            f"(walls {', '.join(f'{d} {k} {w:.1f} s' for (d, k), w in walls.items())}) [{gpu}]")


FT_SLOTS, FT_CAPACITY, FT_NEW = 16, 2048, 64
# the ft phase's fault plan (ft/inject.py grammar): a transient dispatch
# fault one retry absorbs, a retry exhaustion (3 fires > tick_retries=2)
# that evacuates in place, one KV bit flip and one params bit flip
FT_PLAN = ("tick=3,kind=raise;tick=9,kind=raise,times=3;"
           "tick=20,kind=corrupt,target=kv,seed=5;"
           "tick=30,kind=corrupt,target=params,seed=9")
FT_FLIP_MARGIN = 2e-3       # tests/test_torch_dense.py: a near-tie
FT_LAYOUTS = {"dense": {}, "paged": dict(kv_layout="paged"),
              "int8": dict(kv_layout="paged", kv_dtype="int8")}
# the launcher's first run and restarts: 4 bf16 steps saving every 2
FT_TRAIN_ARGS = ["--arch", "exanode-100m", "--steps", "4", "--batch", "8",
                 "--seq", "512", "--bf16-params", "--save-every", "2",
                 "--log-every", "1"]
FT_TRAIN_KW = dict(cfg="exanode-100m", steps=4, global_batch=8, seq_len=512,
                   save_every=2, log_every=1)
FT_KERNELS = ("flash_attention", "fused_ffn", "decode_attention",
              "paged_decode_attention", "paged_decode_attention_q8",
              "quantize_int8", "quantized_block_write") + TRAIN_KERNELS[2:]


def own_margin(torch, rt, prompt, stream: list, j: int, bs: int = 16):
    """(top-2 logit margin, top token) where ``stream[j]`` was sampled, on
    the port's own path for the request alone (its model's forward over
    the dense layout; prefill, splice and decode steps over ``rt``'s
    pool)."""
    import numpy as np
    from repro_torch.models import registry
    from repro_torch.serve import blockpool as pbp
    from repro_torch.serve.engine import serving_params
    cfg, dev = rt.cfg, rt.device
    params = serving_params(rt.params, cfg.dtype)
    with torch.no_grad():
        if rt.kv_layout == "dense":
            ctx = np.concatenate([prompt, np.asarray(stream[:j], np.int32)])
            logits = registry.model_forward(
                params, torch.from_numpy(ctx)[None].to(dev), cfg)
        else:
            M = -(-rt.capacity // bs)
            pool = pbp.BlockPool(M + 2, bs, 1, M, max_entries=rt.capacity)
            dst = pool.admit(0, prompt, -(-len(prompt) // bs))[None]
            logits, part = registry.model_prefill(
                params, torch.from_numpy(prompt)[None].to(dev), cfg,
                rt.capacity, last_only=True)
            caches = pbp.paged_splice(
                pbp.init_paged_cache(cfg, pool.num_blocks, bs, rt.kv_dtype,
                                     device=dev),
                part, torch.from_numpy(dst).to(dev))
            for t in range(j):
                bid = pool.write_plan(0, True)[0]
                logits = registry.model_paged_decode_step(
                    params, torch.tensor([[stream[t]]], dtype=torch.int32,
                                         device=dev), caches, cfg,
                    pos=torch.tensor([len(prompt) + t], dtype=torch.int32,
                                     device=dev),
                    block_table=torch.from_numpy(pool.table.copy()).to(dev),
                    write_bids=torch.tensor([bid], dtype=torch.int32,
                                            device=dev))
    top = torch.topk(logits[0, -1, :cfg.vocab_size].float(), 2)
    return (float(top.values[0] - top.values[1]), int(top.indices[0]))


@contextlib.contextmanager
def recorded_folds():
    """Record every replay's fold point, rid -> [len of the prefix folded
    into the prompt], while the engine folds (evacuation, corruption
    rollback, snapshot)."""
    from repro_torch.serve import engine as serve_engine
    fold, folds = serve_engine._fold_replay_prefix, {}

    def record(req):
        fold(req)
        folds.setdefault(req.rid, []).append(req.folded)
    serve_engine._fold_replay_prefix = record
    try:
        yield folds
    finally:
        serve_engine._fold_replay_prefix = fold


def near_ties(torch, rt, prompts, want: dict, got: dict, what: str,
              folds: dict) -> list:
    """Every stream of ``got`` equal to ``want``'s, or diverging first at a
    token j where either the clean path (the request alone: prompt, then
    decode) has a top-2 margin <= FT_FLIP_MARGIN, or the request was
    replayed before j and ``got[j]`` is the greedy token of its replay
    path (prompt and the prefix up to its last fold point f <= j
    prefilled, then decode).  The second covers a replay's requantization
    of the int8 pool, whose blocks an uninterrupted run fills one decode
    write at a time.  Returns each divergence with both paths' margins;
    raises on any other."""
    import numpy as np
    ties = []
    for rid, w in want.items():
        g = got[rid]
        if g == w:
            continue
        j = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        m, _ = own_margin(torch, rt, prompts[rid], g, j)
        f = max((x for x in folds.get(rid, []) if x <= j), default=0)
        rm = rtop = None
        if f:
            rm, rtop = own_margin(
                torch, rt, np.concatenate([prompts[rid],
                                           np.asarray(g[:f], np.int32)]),
                g[f:], j - f)
        tie = dict(rid=rid, token=j, got=g[j], clean=w[j],
                   margin=round(m, 6), replayed_from=f,
                   replay_margin=None if rm is None else round(rm, 6),
                   replay_top=rtop)
        if not (m <= FT_FLIP_MARGIN or rtop == g[j]):
            raise AssertionError(
                f"ft {what}: rid {rid} diverges at token {j} (got "
                f"{g[j:j + 4]}, clean {w[j:j + 4]}): clean-path margin "
                f"{m:.4g} over {FT_FLIP_MARGIN} and not its replay path's "
                f"token ({tie})")
        ties.append(tie)
    return ties


def check_ft_events(eng, what: str) -> dict:
    """The plan's faults all fired and were handled: the transient raise
    retried without an evacuation, the exhausted retries evacuated in
    place, each flip detected by the next scrub (latency <= 1 tick).
    Returns the evacuation latencies and detections."""
    from repro_torch.ft.inject import FaultInjector
    plan = FaultInjector.parse(FT_PLAN)
    ev = eng.ft_events
    if not all(f.fired for f in eng.injector.faults):
        raise AssertionError(f"ft {what}: a fault never fired: "
                             f"{eng.injector!r}")
    retries = [e for e in ev if e["event"] == "tick_retry"]
    evacs = [e for e in ev if e["event"] == "evacuate"]
    first = plan.faults[0].tick
    if not (any(e["tick"] == first for e in retries)
            and not any(e["tick"] == first for e in evacs)):
        raise AssertionError(f"ft {what}: the transient fault at tick "
                             f"{first} was not absorbed by a retry: {ev}")
    if len(evacs) != 1 or evacs[0]["tick"] != plan.faults[1].tick:
        raise AssertionError(f"ft {what}: expected one evacuation at tick "
                             f"{plan.faults[1].tick}: {evacs}")
    detected = {}
    for inj in (e for e in ev if e["event"] == "corrupt_inject"):
        hit = [e for e in ev if e["event"] == "corruption"
               and e["target"] == inj["target"] and e["tick"] >= inj["tick"]]
        if not hit or hit[0]["detect_latency_ticks"] > 1:
            raise AssertionError(f"ft {what}: the {inj['target']} flip at "
                                 f"tick {inj['tick']} was not detected "
                                 f"within one scrub: {ev}")
        detected[inj["target"]] = dict(
            tick=inj["tick"], detect_ticks=hit[0]["detect_latency_ticks"],
            streams=hit[0].get("streams"), regions=hit[0].get("regions"))
    if set(detected) != {"kv", "params"}:
        raise AssertionError(f"ft {what}: flips injected {sorted(detected)}"
                             f", expected kv and params")
    return dict(evac_s=[e["latency_s"] for e in evacs], detected=detected)


def straggler_peak(eng) -> str:
    """The largest tick ratio the straggler saw and its longest run of
    ticks over the warn ratio (a clean run must stay below the ladder)."""
    run = best = 0
    for r in eng.straggler.history:
        run = run + 1 if r.ratio >= eng.straggler.warn_ratio else 0
        best = max(best, run)
    peak = max((r.ratio for r in eng.straggler.history), default=0.0)
    return f"straggler peak {peak:.2f}x, {best} over {eng.straggler.warn_ratio}x"


def timed_ms(torch, fn, n: int = 5) -> float:
    """Median wall of ``fn`` (synchronized), ms, after one warm call."""
    import statistics
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def ft_train(torch, gpu: str) -> tuple[str, dict]:
    """python -m repro_torch.launch.train: 4 bf16 steps saving every 2,
    then two restarts through the launcher's loop with the launch counters
    zeroed: from the step-2 checkpoint (the state after step 2; steps
    count from 0 and save where step % 2 == 0, as the reference's loop
    does) and from the step-0 one.  Each resumed step's loss must equal
    the first run's to the 9 digits the launcher prints."""
    import os
    import re
    import shutil
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_loop
    root = Path(__file__).resolve().parent
    ckpt = root / "build" / "ft_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    args = FT_TRAIN_ARGS + ["--ckpt-dir", str(ckpt)]
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                       + args, cwd=root, capture_output=True, text=True,
                       timeout=600,
                       env={**os.environ, "PYTHONPATH": str(root / "src")})
    first_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"ft train: the launcher failed:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    first = {int(m.group(1)): m.group(2) for m in re.finditer(
        r"step\s+(\d+) loss=(\S+)", r.stdout)}
    saved = sorted(p.name for p in ckpt.iterdir())
    if saved != [f"step_{s:09d}" for s in (0, 2, 3)] or len(first) != 4:
        raise AssertionError(f"ft train: checkpoints {saved}, losses "
                             f"{first}:\n{r.stdout[-2000:]}")
    counts, resumed = {}, {}
    for drop in ((3,), (2, 3)):         # each restart saves step 3 again
        for s in drop:
            shutil.rmtree(ckpt / f"step_{s:09d}")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            _, hist = train_loop(param_dtype=torch.bfloat16,
                                 ckpt_dir=str(ckpt), **FT_TRAIN_KW)
        torch.cuda.synchronize()
        for k, v in ops.launch_counts().items():
            counts[k] = counts.get(k, 0) + v
        got = {h["step"]: f"{h['loss']:.9g}" for h in hist}
        resumed[min(got)] = got
        bad = {s: (l, first[s]) for s, l in got.items() if l != first[s]}
        if bad or not got:
            raise AssertionError(f"ft train: restarted losses differ from "
                                 f"the first run's: {bad} ({got})")
    shutil.rmtree(ckpt, ignore_errors=True)
    line = (f"first run {first} in {first_s:.1f} s (process included); "
            f"restart from the step-2 checkpoint {resumed[3]}, from the "
            f"step-0 one {resumed[1]}: equal")
    return line, counts


def ft_phase(torch, gpu: str) -> tuple[str, dict]:
    """Fault tolerance on one card, exanode-100m at full width on the
    serve cell (capacity 2048, 16 slots, the serve phase's 32 prompts,
    64 new tokens):

    1. in f32 over the dense, paged and int8 pools, a clean run and one
       with scrub_every=1, health_every=4 and ``FT_PLAN``: every fault
       handled (``check_ft_events``) and every stream the clean run's, or
       diverging only as ``near_ties`` allows, printed;
    2. the plan in bf16 on the int8 pool beside a clean run and a
       scrub_every=1 run without faults: the share of streams equal to
       the clean run's, ITL p50 with and without the scrub;
    3. snapshot() after 40 ticks of an f32 dense run, saved, loaded into a
       fresh engine and run to completion: the uninterrupted run's
       streams (divergences as ``near_ties`` allows, printed);
    4. ``ft_train``;
    5. the time of one scrub of the full bf16 int8 pool (every block
       full), of a params fingerprint of exanode-100m and of gemma-2b (bf16,
       drawn on the card), and of one health check.

    No run without a fault plan may evacuate (``serve_run``).  Every
    engine run and the
    train restarts zero the launch counters just before and add
    them up just after; the phase fails unless ``FT_KERNELS`` all
    launched."""
    import shutil
    import numpy as np
    from repro_torch.checkpoint.manager import EngineSnapshot
    from repro_torch.configs import get_config
    from repro_torch.ft import health, integrity
    from repro_torch.ft.inject import FaultInjector
    from repro_torch.kernels import ops
    from repro_torch.models.common import init_params, tree_leaves
    from repro_torch.models.registry import model_specs
    from repro_torch.runtime import Runtime
    from repro_torch.serve.engine import Request, serving_params

    counts: dict = {}

    def add(launches):
        for k, v in launches.items():
            counts[k] = counts.get(k, 0) + v

    def run(rt, plan=None, **kw):
        if plan is not None:
            kw.update(scrub_every=1, health_every=4,
                      injector=FaultInjector.parse(plan))
        if rt.kv_layout == "paged":
            kw.setdefault("block_size", 16)
        res = serve_run(torch, rt, prompts, FT_NEW, **kw)
        add(res["launches"])
        return res

    t_phase = time.perf_counter()
    f32 = get_config("exanode-100m").scaled(dtype=torch.float32)
    base = Runtime.create(f32, capacity=FT_CAPACITY)
    prompts = serve_prompts(base.cfg.vocab_size)
    parts, evac_s = [], []
    clean_f32 = {}
    for way, kv in FT_LAYOUTS.items():
        rt = Runtime.create(f32, capacity=FT_CAPACITY, params=base.params,
                            **kv)
        clean = clean_f32[way] = run(rt)
        with recorded_folds() as folds:
            faulted = run(rt, FT_PLAN)
        info = check_ft_events(faulted["eng"], f"f32 {way}")
        evac_s += info["evac_s"]
        ties = near_ties(torch, rt, prompts, clean["streams"],
                         faulted["streams"], f"f32 {way}", folds)
        parts.append(
            f"f32 {way}: clean ITL p50 "
            f"{clean['eng'].latency_summary()['itl_p50'] * 1e3:.2f} ms "
            f"({straggler_peak(clean['eng'])}); faulted "
            f"{faulted['eng'].stats.summary}, detections "
            f"{info['detected']}, streams equal but {ties}")

    bf = Runtime.create("exanode-100m", capacity=FT_CAPACITY,
                        **FT_LAYOUTS["int8"])
    run(bf)                                        # cold: warm-up
    clean, scrubbed = run(bf), run(bf, scrub_every=1)
    faulted = run(bf, FT_PLAN)
    info = check_ft_events(faulted["eng"], "bf16 int8")
    evac_s += info["evac_s"]
    share = sum(faulted["streams"][r] == clean["streams"][r]
                for r in clean["streams"]) / len(clean["streams"])
    itl = {n: r["eng"].latency_summary()["itl_p50"] * 1e3
           for n, r in (("clean", clean), ("scrub_every=1", scrubbed),
                        ("faulted", faulted))}
    parts.append(f"bf16 int8: ITL p50 {itl} ms; scrubbed run "
                 f"{scrubbed['eng'].stats.summary} "
                 f"({straggler_peak(scrubbed['eng'])}); faulted "
                 f"{faulted['eng'].stats.summary}, detections "
                 f"{info['detected']}; streams equal to the clean run's "
                 f"{share:.4f}")

    # warm restart: a snapshot after 40 ticks, through a file
    rt = Runtime.create(f32, capacity=FT_CAPACITY, params=base.params)
    snap_dir = Path(__file__).resolve().parent / "build" / "ft_snapshot"
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    first = rt.engine(num_slots=FT_SLOTS)
    for i, p in enumerate(prompts):
        first.submit(Request(rid=i, prompt=p, max_new_tokens=FT_NEW))
    for _ in range(40):
        first.tick()
    with recorded_folds() as folds:
        snap = first.snapshot()
    path = snap.save(str(snap_dir))
    second = rt.engine(num_slots=FT_SLOTS)
    n_req = second.load_snapshot(EngineSnapshot.load(path))
    second.run_to_completion()
    torch.cuda.synchronize()
    add(ops.launch_counts())
    if first.stats.evacuations or second.stats.evacuations:
        raise AssertionError(f"ft snapshot: a run without a fault plan "
                             f"evacuated ({first.ft_events}, "
                             f"{second.ft_events})")
    shutil.rmtree(snap_dir, ignore_errors=True)
    merged = {r.rid: r.generated for r in first.finished}
    merged.update({r.rid: r.generated for r in second.finished})
    if sorted(merged) != list(range(len(prompts))) or any(
            len(s) != FT_NEW for s in merged.values()):
        raise AssertionError(f"ft snapshot: streams lost ({len(merged)})")
    ties = near_ties(torch, rt, prompts, clean_f32["dense"]["streams"],
                     merged, "snapshot", folds)
    parts.append(f"snapshot after 40 ticks: {len(first.finished)} finished "
                 f"before, {n_req} requests restored into a fresh engine; "
                 f"streams equal the uninterrupted run's but {ties}")

    train_line, train_counts = ft_train(torch, gpu)
    add(train_counts)
    parts.append("train: " + train_line)

    # costs: one scrub of the full int8 pool, params fingerprints, health
    eng = scrubbed["eng"]
    full = np.full(eng.pool.num_blocks, eng.pool.block_size, np.int32)
    scrub_ms = timed_ms(torch, lambda: integrity.region_fingerprints(
        eng.caches, full))
    pool_mb = eng.kv_cache_bytes() / 2**20
    exa = serving_params(bf.params, bf.cfg.dtype)
    fp_exa = timed_ms(torch, lambda: integrity.tree_fingerprint(exa))
    exa_mb = sum(t.numel() * t.element_size()
                 for t in tree_leaves(exa)) / 2**20
    gcfg = get_config("gemma-2b")
    gemma = init_params(model_specs(gcfg), 0, torch.bfloat16, bf.device,
                        draw_on_device=True)
    fp_gemma = timed_ms(torch, lambda: integrity.tree_fingerprint(gemma))
    gemma_mb = sum(t.numel() * t.element_size()
                   for t in tree_leaves(gemma)) / 2**20
    del gemma
    health_ms = timed_ms(torch, lambda: health.check_devices([bf.device]))
    missing = [k for k in FT_KERNELS if not counts.get(k)]
    line = (f"ft: exanode-100m capacity={FT_CAPACITY} slots={FT_SLOTS}, "
            f"{len(prompts)} requests x {FT_NEW} new tokens, plan "
            f"{FT_PLAN!r}, scrub_every=1 health_every=4 tick_retries=2; "
            + "; ".join(parts)
            + f"; one scrub of the full bf16 int8 pool ({pool_mb:.0f} MiB, "
              f"{eng.pool.num_blocks} blocks): {scrub_ms:.3f} ms; params "
              f"fingerprint exanode-100m bf16 ({exa_mb:.0f} MiB) "
              f"{fp_exa:.3f} ms, gemma-2b bf16 ({gemma_mb:.0f} MiB) "
              f"{fp_gemma:.3f} ms; one health check {health_ms:.3f} ms; "
              f"evacuation latency {[round(s * 1e3, 1) for s in evac_s]} ms;"
              f" launches {counts}; phase {time.perf_counter() - t_phase:.1f}"
              f" s [{gpu}]")
    if missing:
        raise AssertionError(line + f"\nft phase failed: {missing} never "
                             f"launched")
    return line, counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}, or "
                         f"int8_cpu (not run by default)")
    ap.add_argument("--iters", type=int, default=10,
                    help="timed launches per kernel measurement")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build

    gpu = gpu_line()
    print(gpu, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s for "
          f"{', '.join(_build.SOURCES)} (nvcc, sm_90a)", flush=True)
    # f32 comparisons run in full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    entries = {}
    secs = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    if "kernels" in phases:
        entries = kernels_phase(torch, Timer(torch, args.iters))

        def wide(e):
            return (f"{e['ms']:.3f} ms (f32 {e['ms_f32']:.3f}, plain "
                    f"{e['plain_ms']:.3f}, library {e['library_ms']:.3f}, "
                    f"bound {e['bound_ms']:.4f} {e['bound_by']})")
        print("kernels: " + "; ".join(
            f"{n} {e['ms']:.3f} ms (plain {e['plain_ms']:.3f}, library "
            + ("none" if e["library_ms"] is None
               else f"{e['library_ms']:.3f}")
            + f", bound {e['bound_ms']:.4f} "
            f"{e['bound_by']}) err {e['max_abs_err']:.3g}"
            for n, e in entries.items()) + "; fused_ffn at jamba width "
            + "; ".join(f"{n} {wide(e)}" for n, e in
                        entries["fused_ffn"]["jamba_width"].items())
            + "; flash_attention at jamba width "
            + wide(entries["flash_attention"]["jamba_width"])
            + "; " + "; ".join(
                f"{n} {e['shape']}: device {e['device_ms']:.4f} ms, host "
                f"{e['host_us']:.1f} us (library device "
                f"{e['library_device_ms']:.4f}, host "
                f"{e['library_host_us']:.1f})"
                for n, e in (
                    ("decode_attention", entries["decode_attention"]),
                    ("decode_attention at jamba width",
                     entries["decode_attention"]["jamba_width"]),
                    ("paged_decode_attention",
                     entries["paged_decode_attention"]),
                    ("paged_decode_attention_q8",
                     entries["paged_decode_attention_q8"]),
                    ("dequantize_int8", entries["dequantize_int8"]),
                    ("dequantize_int8 one leaf",
                     entries["dequantize_int8"]["one_leaf"])))
            + f"; decode_attention at jamba width "
            f"{entries['decode_attention']['jamba_width']['ms']:.3f} ms "
            f"(plain "
            f"{entries['decode_attention']['jamba_width']['plain_ms']:.3f}, "
            f"library "
            f"{entries['decode_attention']['jamba_width']['library_ms']:.3f},"
            f" bound "
            f"{entries['decode_attention']['jamba_width']['bound_ms']:.4f})"
            + f"; tolerances {TOL} [{gpu}]", flush=True)
        print(flash_bwd_line(entries, gpu), flush=True)
        print(moe_shapes_line(entries, gpu), flush=True)
        print(wide_groups_line(entries, gpu), flush=True)
        print(scan_quant_line(torch, entries, gpu), flush=True)
        print(scan_bwd_line(torch, entries, gpu), flush=True)
        print(split_sweep(torch, gpu, args.iters), flush=True)
        secs["kernels"] = time.perf_counter() - t0
    if "model" in phases:
        t0 = time.perf_counter()
        print(model_phase(torch), flush=True)
        secs["model"] = time.perf_counter() - t0
    by_path = {}       # path -> that run's launch counts
    for path, run in (("serve", serve_phase),
                      ("paged", paged_phase), ("sched", sched_phase),
                      ("xlstm", xlstm_phase), ("jamba", jamba_phase),
                      ("dense", dense_phase), ("moe", moe_phase),
                      ("train", train_phase),
                      ("xlstm_train", xlstm_train_phase),
                      ("jamba_train", jamba_train_phase),
                      ("ft", ft_phase)):
        if path in phases:
            t0 = time.perf_counter()
            line, by_path[path] = run(torch, gpu)
            print(line, flush=True)
            secs[path] = time.perf_counter() - t0
    if "int8_cpu" in phases:
        t0 = time.perf_counter()
        print(int8_cpu_phase(torch, gpu), flush=True)
        secs["int8_cpu"] = time.perf_counter() - t0
    if "train_profile" in phases:
        t0 = time.perf_counter()
        print(train_profile_phase(torch, gpu), flush=True)
        secs["train_profile"] = time.perf_counter() - t0
    if "xlstm_profile" in phases:
        t0 = time.perf_counter()
        print(xlstm_profile_phase(torch, gpu), flush=True)
        secs["xlstm_profile"] = time.perf_counter() - t0
    if "sched_profile" in phases:
        t0 = time.perf_counter()
        print(sched_profile_phase(torch, gpu), flush=True)
        secs["sched_profile"] = time.perf_counter() - t0
    if "jamba_profile" in phases:
        t0 = time.perf_counter()
        print(jamba_profile_phase(torch, gpu), flush=True)
        secs["jamba_profile"] = time.perf_counter() - t0
    print("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in secs.items()}), flush=True)
    if entries:
        print(json.dumps({"kernels": [
            dict(name=n, route="cuda", source=SOURCES[n][0],
                 replaces=SOURCES[n][1],
                 launches=sum(c.get(n, 0) for c in by_path.values()),
                 launches_by_path={p: c[n] for p, c in by_path.items()
                                   if n in c},
                 kernel_ms=e["ms"], gpu=gpu, **e)
            for n, e in entries.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
