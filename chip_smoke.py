#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100, sm_90a) and the CUDA toolkit; imports
nothing of JAX and nothing of the JAX package. Phases, each of which
fails the run:

1. device   — name, capability (9, 0), power limit, nvcc and torch CUDA;
2. build    — compile every kernel under ``src/repro_torch/csrc`` with
              nvcc and time it; every source not built by this run (its
              library was cached) is compiled again into a temporary
              directory, so that ``-Xptxas -v`` (printed) covers every
              instantiation; any spill fails; every instantiation of the
              loaded libraries is read back through the CUDA driver API
              (``cuFuncGetAttribute``: registers, local bytes) and must
              match that log;
              count the tensor-core MMA and dp4a instructions in the SASS
              of K2, K4 and K5 (``cuobjdump -sass``): every instantiation
              needs >= 1 MMA, and K2's no dp4a; log every kernel's
              registers, instruction count and shared-memory loads per
              fp32 multiply (K1 and K3 included);
3. kernels  — each kernel against its plain PyTorch version on the card
              at the main path's shapes (ResNet-18 width 1.0, B = 256,
              F(4,3) Legendre, 9-bit Hadamard), plus F(6,3), F(2,3),
              canonical F(4,3), ragged Cin/T/Cout and K4 with the
              requant off: every output bit for bit, K4 also against
              K2 → K3 (fused == staged kernels); K1 and K2 at their edges
              (ragged T, T off K1's 256-window chunk, Cin 3 and 19, Cout
              45, n = 4/6/8, requant off/8/9 bits, K2 sums past 2^24) and
              K3 at its own (T·C off the chunk, 4 and 16, n = 4/6/8, base
              on and off, H on the 8- and 9-bit grids and raw past 2^24):
              bit for bit; K5 at the llama3.2-1b projection shapes
              (prefill M = 2048 and decode M = 8), ragged shapes (the
              predicated path, with and without split K), bf16 outputs and
              saturated sums past 2^24: bit for bit;
4. main     — ``repro_torch.launch.infer_resnet`` at width 1.0, batch
              256, 2 calibration steps: pack → calibrate → checkpoint →
              restore → serve fused and staged, its fused-vs-staged gate
              against the fp32 ``winograd_fp`` network, then stage 5's
              1-device mesh; launch counts read around it (K1–K4 > 0, K4
              14 per fused forward); then
              ``ops.q8_linear`` over the seven projections of one
              llama3.2-1b layer at M = 2048, its K5 launches read around
              it and its error against fp32 ``x @ w`` gated; the scale
              check: every call of the four int8 scale functions of
              ``kernels/ops.py`` in that run (``prepare_weights_int8``,
              ``scales_from_abs_max``, ``_hadamard_rq``, ``_requant``)
              recorded on the card and computed again on the CPU from
              the same inputs: the scales, the fp32 weight transforms
              and u_q bit for bit, and the scale elements and bits the
              reciprocal form ``tensor / host number`` would move on the
              card counted beside them;
5. times    — CUDA-event time of each kernel at each main-path shape
              beside its bound, its plain version and a library yardstick
              (cuDNN ``F.conv2d``, ``torch._int_mm``; the port calls
              neither), the floors of K1, K3 and K4's epilogue (their
              bitwise-order fp32 sandwich operations at 33.5 T
              instructions/s) and of the work K3 runs (the base change's
              zero terms left out), K2 under each count of positions a
              block, and fused images/s at B = 256;
6. train    — ``repro_torch.launch.train_resnet_qat`` at width 1.0, batch
              256, F(4,3) Legendre, flex, 9-bit Hadamard, 10 steps: every
              loss finite, every parameter, the flex matrices and the
              BatchNorm running statistics changed; ms per step, images/s
              and peak memory;
7. serve    — ``repro_torch.launch.serve`` at width 1.0 (F(4,3) Legendre,
              9-bit Hadamard), buckets 1/8/64/256, max wait 5 ms, the
              planner (tiles 2/4/6 × both bases × bits none/8/9, measured
              at bucket 256) and autotune on, 4,096 Poisson requests at
              4,000 requests/s: every request answered, 0 captures after
              warm-up, sampled served rows bit for bit with the eager
              forward of the same padded batch; a second, traced load of
              2,048 requests for the device's busy share under load and
              its time by kernel; launches read around it
              (K1–K4 > 0; per capture and replays); K4's tiles timed at
              buckets 64 and 256 per served layer shape beside the tile
              each bucket serves (tuned at calibration for bucket 256,
              at warm-up for the others); and the padded-parity
              check on the card: one int8 Winograd layer, a row served in
              a zero-padded bucket bit for bit the row served alone;
8. sharded  — sharded int8 serving over data × model meshes laid over the
              one card (``--host-devices``): per layer (the stem, Cin = 3,
              and an s0 conv, Cout 64: 32 a model shard), B = 256, F(4,3)
              in both bases, Hadamard off/8/9, on meshes (1,1), (2,1),
              (4,1), (1,2) and (2,2), plus the (4,2) mesh's 5-row slabs,
              ``ops.execute_int8_sharded`` bit for bit with single-device
              fused (calibrated) and staged (dynamic requant);
              ``repro_torch.launch.infer_resnet --host-devices 4`` at
              width 1.0, B = 256: stage 5's sharded logits bit for bit
              with single-device fused and its 0.05 gate, launches read
              around it; CUDA-event ms per forward on each mesh beside
              single-device fused, and per layer the slab copies, the
              gathers and the sharded call against the single-device
              call; ``launch/serve`` through a 2 × 2 mesh on the card
              (1,024 Poisson requests at a quarter of the mesh's eager
              bucket-64 images/s) with the serving gates; padded parity
              on a 2 × 2 mesh;
9. lm       — LM serving (``repro_torch.launch.steps.generate``: prefill
              → grow the cache → greedy decode), random bf16 weights
              drawn on the card from seed 0, batch 4, a 2,048-token
              prompt and 64 decode steps, at full width and full depth:
              recurrentgemma-2b (its quantized 1-D Toom-Cook conv on,
              F(4,4) Legendre, 9-bit Hadamard, counted per recurrent
              layer; the decode wraps its 2,048-slot ring buffer),
              llama3.2-1b, qwen2-moe-a2.7b, rwkv6-7b, internvl2-26b (256
              patch prefixes inside the 2,048) and hubert-xlarge
              (encoder: forward only). Each model is freed before the
              next. Cut: kimi-k2-1t-a32b, command-r-plus-104b and
              qwen1.5-32b do not fit one 80 GB card at full width; they
              share their code paths with the families above and the CPU
              tests run their tiny variants. Gates: every logit finite;
              per model at full width in fp32 (TF32 off) at depth 2 (3
              for the hybrid), Winograd conv off, prefill's last logits
              equal ``forward`` at that position and one decode step
              ``forward`` at the next (rtol 2e-2, atol 2e-3, the JAX
              package's ``test_prefill_matches_decode``; the MoE's
              capacity factor raised to n_experts / top_k so that no
              token drops, since capacity drops depend on the batch's
              token count); each family's tiny variant on the card
              against the CPU (weights drawn on the CPU): prefill and 8
              decode steps fed the CPU's greedy tokens, logits and every
              cache leaf at rtol = atol = 1e-4 (TF32 off), the hybrid's
              Winograd conv on the same inputs at the fake-quant tier of
              tests/test_torch_conv1d.py (at most 0.5 % of the outputs
              past 1e-4, each within one step of the output cast), the
              outputs on the card; the gates' and these weights scaled to each matrix's
              input width (ROADMAP.md, "Recorded differences"). Prints
              per model
              prefill tokens/s, decode ms a step (CUDA events), peak
              memory and the decode step's floor (its weight bytes over
              3.35 TB/s), and the device's busy share of a traced
              prefill and of 4 traced decode steps with their top kernels;
10. train   — LM training (``repro_torch.launch.steps.make_train_setup``:
              chunked CE, microbatched gradients, AdamW written in place),
              random bf16 weights drawn on the card from seed 0 with each
              config's moments (fp32 for these), synthetic Markov tokens
              (``batch_at``), batch 4 of 2,048 positions, microbatch 2,
              5 steps at lr 3e-4 with 1 warm-up step and 5 total (the
              JAX launcher's ``build_run``), TF32 off:
              recurrentgemma-2b (its quantized Toom-Cook conv on) and
              llama3.2-1b at full width and depth; qwen2-moe-a2.7b,
              rwkv6-7b, internvl2-26b and hubert-xlarge (frame targets)
              at full width and depth 2, so that every family's backward
              runs on the card in the time limit (rwkv6-7b's 7.6 B
              parameters, their gradients and moments do not fit one
              80 GB card at full depth). Each model is freed before the
              next. Prints per model ms a step (median of steps 2-5, CUDA
              events), tokens/s (positions of the batch), peak memory
              (steps 3-5),
              the device's busy share of one traced step and the
              launches of K1-K5 (0). Gates: every loss and grad norm
              finite; every parameter leaf whose second moment is nonzero
              after the first step with lr > 0 moved in that step, or
              else AdamW's nonzero fp32 update from that step's moments
              rounds back to each of its bf16 values (such leaves
              logged); at
              full width and depth 2 (the hybrid 3) in fp32, weights
              scaled to each matrix's input width as in phase 9, no MoE
              token dropped (capacity factor n_experts / top_k), the
              hybrid's conv off and the MoE's load-balancing loss zeroed
              (both depend on which rows share a batch: the conv's
              dynamic fake-quant scales, the aux loss's batch means), 2 x
              2 microbatched gradients equal the batch of 4's within
              1e-4 of 1 + each leaf's largest value (the fp32 tier of
              the CPU parity tests; the worst share of the largest is
              logged); each family's tiny variant,
              one train step on the card against the CPU: the loss, every
              gradient leaf and the updated parameters within rtol = atol
              = 1e-4 (the parameters where the gradient is above 1e-3 of
              its leaf's largest; elsewhere Adam's first step turns
              rounding noise into a full-size update, held at 2 lr), the
              hybrid with its conv off, and the conv's VJP on the CPU
              run's conv inputs held as tests/test_torch_lm_train.py
              holds it; llama3.2-1b's full-width train state (bf16
              parameters, fp32 moments, count) through ``save`` and
              ``restore`` bit for bit;
11. sharded — the LM over data × model meshes of logical devices laid
              over the one card (``launch.mesh.make_mesh_for(...,
              host_devices=)``): llama3.2-1b at full width and depth,
              bf16, fp32 moments, 3 train steps of B = 4 × 2,048,
              microbatch 2 (phase 10's run) on one device, a 1 × 1 mesh
              and ``make_mesh_for(4, model_parallel=2)``'s 2 × 2: ms a
              step, tokens/s, peak memory, one traced step's busy share
              and its copy/cast and cat kernels' share of device time,
              and what the split adds to them over one device; the
              1 × 1 mesh bit for bit with one device (loss, grad norm,
              every parameter and moment); the 2 × 2 train state saved
              and restored onto the 1 × 1 mesh bit for bit;
              ``compressed_grad_mean`` over the (2, 2, 2) pod × data ×
              model mesh's pod axis on llama3.2-1b's gradients, card bit
              for bit with the CPU; bf16 serving on the 2 × 2 mesh
              (prefill 2,048, 16 greedy steps) beside one device, and
              again with its row-parallel partials summed in fp32: token
              agreement, and at each sequence's first step apart the
              logit gap beside one device's top-2 margin, logged; at
              full width, depth 2 (the hybrid 3),
              fp32, weights scaled to input width, no MoE token dropped,
              the hybrid's conv and the MoE's aux loss on, one train step
              of each of the six families on 2 × 2 and qwen2-moe-a2.7b's
              on (2, 2, 2) with FSDP and moe_groups 4 within 1e-4 × (1 +
              each tensor's largest) of one device (loss, grad norm,
              parameters where the gradient is above 1e-3 of its
              leaf's largest, else 2 lr), each beside how far one ulp of
              the weights moves the one-device loss and grad norm (the
              hybrid's parameters at ``LM_SHARD_CONV_ULPS`` times the
              one-ulp share, a planted per-row-scale conv refused, and
              its first conv's input on 2 × 2 against one device); the
              fp32 prefill and one decode step (hubert: forward) on 2 × 2
              within phase 9's tolerance of one device; the decode cache
              a 2 × 2 mesh position holds (cut by heads over "model")
              beside the parent's placement, and serving peaks; one
              device with each column-parallel product as two half-width
              GEMMs (ROADMAP C8), the 2 × 1 and 1 × 2 meshes, one
              device with each product as two half-row GEMMs, and one
              device with each row-parallel product as two half-K bf16
              GEMMs added in bf16: greedy agreement with one device, with
              2 × 2 and with 1 × 2; w8a8 fake-quant
              linears served on 1 × 1 (bit for bit) and 2 × 2 (the
              relative error to the fp32 model within 0.05 of one
              device's, the JAX launcher's no-added-error gate); K1–K5
              launch 0 times;
12. dry run — ``launch.dryrun.cost_step`` of llama3.2-1b's train step
              (phase 10's run) on a 1 × 1 mesh under fake tensors on the
              CPU, then the real step on the card under
              ``FlopCounterMode``: the matmul FLOPs equal and the
              argument bytes equal the live parameters', moments',
              count's and batch's; the dry run's kernel-launching ops
              beside the traced step's device intervals, its bytes beside
              the step's time at 3.35 TB/s. Every phase's wall seconds
              are logged at the end.

Phase 5's device-busy share is the union of the trace's device intervals
over the traced window, so it cannot pass 100 %.

Prints the kernel table as one JSON line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line. Details go
to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM at its full 700 W (NVIDIA data sheet):
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
FP32_FLOP_S = 67e12
# fp32 instructions per second outside the tensor cores: an FMA counts as
# two of the 67 TFLOP/s, a lone multiply or add as one instruction
FP32_INSTR_S = FP32_FLOP_S / 2

BATCH = 256
WIDTH = 1.0
# The 14 Winograd convs of one ResNet-18 forward at width 1.0, 32x32:
# (name, tiles T, Cin, Cout, spatial H, count per forward)
LAYERS = [("stem", 64 * BATCH, 3, 64, 32, 1),
          ("s0", 64 * BATCH, 64, 64, 32, 4),
          ("s1", 16 * BATCH, 128, 128, 16, 3),
          ("s2", 4 * BATCH, 256, 256, 8, 3),
          ("s3", BATCH, 512, 512, 4, 3)]
TPU_KERNELS = {
    "input_transform": ("src/repro_torch/csrc/wino_transform.cu",
                        "src/repro/kernels/wino_transform.py:147"),
    "wino_gemm": ("src/repro_torch/csrc/wino_gemm.cu",
                  "src/repro/kernels/wino_gemm.py:222"),
    "output_transform": ("src/repro_torch/csrc/wino_transform.cu",
                         "src/repro/kernels/wino_transform.py:201"),
    "fused_gemm_output": ("src/repro_torch/csrc/fused_serve.cu",
                          "src/repro/kernels/fused_serve.py:152"),
    "q8_matmul": ("src/repro_torch/csrc/q8_matmul.cu",
                  "src/repro/kernels/q8_matmul.py:76"),
}
SERVING = ("input_transform", "wino_gemm", "output_transform",
           "fused_gemm_output")
# The seven projections of one llama3.2-1b decoder layer (d_model 2048,
# 32 query / 8 key-value heads of 64, d_ff 8192): name, K, N.
LLAMA_PROJ = [("q", 2048, 2048), ("k", 2048, 512), ("v", 2048, 512),
              ("o", 2048, 2048), ("gate", 2048, 8192), ("up", 2048, 8192),
              ("down", 8192, 2048)]
Q8_SHAPES = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
PREFILL_M, DECODE_M = 4 * 512, 8
TRAIN_STEPS = 10
# The serving phase: buckets, Poisson rate (about a fifth of the images/s
# phase 5's fused forward reaches at B = 256) and requests.
SERVE_BUCKETS = "1,8,64,256"
SERVE_RATE = 4000
SERVE_REQUESTS = 4096
# Tensor-core MMA and dp4a instructions in SASS (mma.sync s8 -> IMMA,
# wgmma -> *GMMA); shared-memory loads and fp32 multiplies
SASS_MMA = ("IMMA", "HMMA", "IGMMA", "HGMMA", "QGMMA")
SASS_DP4A = ("IDP.4A", "IDP4A")
SASS_LDS = ("LDS",)
SASS_FMUL = ("FMUL",)
# K1 and K2 at their edges: (m, base, requant bits, T, Cin, Cout). T*Cin
# off a multiple of 16 sends K1 to its byte stores; T = 301 leaves a
# partial 256-window chunk; Cin = 3 (the stem) and 19 are unaligned rows
# for K2; n = 4, 6, 8.
K12_EDGES = [(4, "legendre", 9, 1000, 19, 45),
             (4, "legendre", 8, 301, 64, 45),
             (4, "legendre", None, 1000, 3, 64),
             (2, "legendre", 9, 777, 19, 45),
             (2, "canonical", None, 1000, 3, 45),
             (6, "legendre", 8, 301, 64, 45),
             (6, "canonical", 9, 1000, 19, 130)]
# K3 at its edges: (m, base, H, T, C). H on the 8- or 9-bit grid, or
# (None) raw accumulators past 2^24 with the Hadamard stage off. T*C off a
# multiple of 4 sends K3 to its 4-byte staging; off a multiple of 16 and
# of the chunk (128 windows) leaves a ragged store tail;
# n = 4, 6, 8, the base on (legendre) and off (canonical).
K3_EDGES = [(4, "legendre", 9, 1000, 45),
            (4, "legendre", 8, 301, 45),
            (4, "canonical", None, 777, 19),
            (4, "legendre", None, 1000, 64),
            (2, "legendre", 9, 777, 19),
            (2, "canonical", 8, 1000, 3),
            (6, "legendre", 9, 301, 64),
            (6, "legendre", 8, 100, 45),
            (6, "canonical", None, 1000, 19)]
# K2 with saturated operands: P, M, K, N (|acc| past 2^24)
K2_SATURATED = [(16, 300, 1200, 64), (36, 100, 1100, 45)]
# Sharded serving (phase 8): meshes (data, model) over the one card
SHARD_MESHES = ((1, 1), (2, 1), (4, 1), (1, 2), (2, 2))
SHARD_HOST_DEVICES = 4
# Layers held bit for bit across the meshes, (name, input NHWC, Cout):
# the stem's Cin = 3 byte path, and an s0 conv whose Cout 64 leaves 32
# a shard at a model extent of 2; then the JAX package's small-slab
# regression: T = 18 tiles over a (4, 2) mesh, 5-row slabs.
SHARD_LAYERS = (("stem", (BATCH, 32, 32, 3), 64),
                ("s0", (BATCH, 32, 32, 64), 64))
SMALL_SLAB = ((2, 12, 12, 4), 8, (4, 2))
SHARD_SERVE_REQUESTS = 1024
# LM serving (phase 9): the models served at full width and depth, the
# batch, prompt and decode steps; the fp32 prefill/decode-vs-forward
# gates (batch, text tokens of the full sequence and of the prompt, the
# depth of each family) and the card-vs-CPU runs (tiny variants).
LM_MODELS = ("recurrentgemma-2b", "llama3.2-1b", "qwen2-moe-a2.7b",
             "rwkv6-7b", "internvl2-26b", "hubert-xlarge")
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 2048, 64
LM_GATE = dict(B=2, S=32, prompt=16, rtol=2e-2, atol=2e-3)
LM_GATE_DEPTH = {"hybrid": 3}
LM_TINY = dict(B=2, prompt=16, steps=8, tol=1e-4)
# LM training (phase 10): (arch, depth or None for full), the batch,
# positions, microbatch and steps (the JAX launcher's build_run: lr 3e-4,
# warm-up max(1, steps // 10)); the microbatch gate's positions; the
# card-vs-CPU step's batch and positions (tiny variants).
LM_TRAIN_MODELS = (("recurrentgemma-2b", None), ("llama3.2-1b", None),
                ("qwen2-moe-a2.7b", 2), ("rwkv6-7b", 2),
                ("internvl2-26b", 2), ("hubert-xlarge", 2))
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_MICRO, LM_TRAIN_STEPS = 4, 2048, 2, 5
LM_TRAIN_GATE_SEQ = 512
# microbatched against full-batch fp32 gradients, of each leaf's largest:
# rwkv6's 1/decay products came to 1.08e-4 on the card (NVIDIA H100 80GB
# HBM3, 700 W), the other families to 1.1e-5
LM_TRAIN_MICRO_TOL = 3e-4
LM_TRAIN_TINY = dict(B=4, S=24, tol=1e-4)
# Of the hybrid conv's channels, how many may have weight gradients off
# the fp32 tier (an abs-max STE mask flipped by an ulp of the transformed
# weights; tests/test_torch_lm_train.py, CONV_CHANNELS_OFF)
CONV_CHANNELS_OFF_SHARE = 6 / 64
# Sharded LM (phase 11): the model trained at full width and depth on the
# 2 x 2 and 1 x 1 meshes and served on the 2 x 2, its steps (B, positions
# and microbatch of phase 10) and decode steps; the fp32 gates'
# positions and tier (of 1 + each tensor's largest |value|).
LM_SHARD_ARCH = "llama3.2-1b"
LM_SHARD_STEPS = 3
LM_SHARD_DECODE = 16
LM_SHARD_GATE_SEQ = 512
LM_SHARD_TOL = 1e-4
# With the hybrid's quantized conv on, the share of held parameters past
# the tier may reach this multiple of the share that one ulp of every
# weight puts past it on one device. The phase reads both ends in every
# run: the sound 2 x 2 step and a planted batch-global fault, the conv
# with its scales taken per row, which the gate must refuse. On an NVIDIA
# H100 80GB HBM3 at 700 W: 6.05 % past (4.3x one ulp's 1.39 %) and, with
# the fault, 32.7 % (23.5x); 8x lies between them (PERF.md, PR 20).
LM_SHARD_CONV_ULPS = 8
# w8a8 fake-quant serving of llama3.2-1b over 2 x 2: the relative
# distance of its logits from one device's stays below this, and that of
# a planted fault, every row quantizing with its own activation scale,
# must lie above it (both read in every run). On an NVIDIA H100 80GB
# HBM3 at 700 W: 1.825e-2 sound, 5.785e-2 with the fault (PERF.md).
LM_SHARD_Q8_REL = 3e-2


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean CUDA-event time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def kernel_device_ms(fn, kernel: str, iters: int = 20) -> float:
    """Device time per call of ``fn()`` spent in kernels whose name holds
    ``kernel``, from the profiler: what back-to-back event timing hides
    where a call's host work outlasts its kernel (a decode-sized K5)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(v for k, v in device_ms_by_kernel(prof, iters).items()
               if kernel in k)


def graph_ms(fn, iters: int = 20) -> tuple:
    """``fn()`` captured into a CUDA graph (after two calls on a side
    stream): the mean CUDA-event time of a replay over ``iters``, its
    device time without the host's enqueue, and the graph."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return time_ms(g.replay, iters=iters, warmup=2), g


def replay_profile(g, iters: int = 10) -> dict:
    """A CUDA graph's replays under ``torch.profiler``, per replay: the
    device's busy time (union of its intervals), the window, the count of
    device intervals and the time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.metrics import device_busy
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            g.replay()
        torch.cuda.synchronize()
    busy, window = device_busy(prof)
    from torch.autograd import DeviceType
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    by_kernel = device_ms_by_kernel(prof, iters)
    return {"busy_ms": busy / iters, "window_ms": window / iters,
            "kernels": n / iters,
            "top_ms": dict(sorted(by_kernel.items(),
                                  key=lambda kv: -kv[1])[:12])}


def device_ms_by_kernel(prof, per: int = 1) -> dict:
    """Device time by kernel name (ms, divided by ``per``) from a
    ``torch.profiler`` run: device events only, since a CPU op repeats
    its kernels' time."""
    from torch.autograd import DeviceType
    by_kernel: dict = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3 / per
    return by_kernel


def sass_counts(lib: str) -> dict:
    """Per kernel function of a built library: its registers (``cuobjdump
    -res-usage``), its instructions, and among them its tensor-core MMA,
    dp4a, shared-memory load (LDS) and fp32 multiply (FMUL) instructions
    (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    regs: dict = {}
    fn = None
    for line in subprocess.run([str(cuobjdump), "-res-usage", lib],
                               capture_output=True, text=True,
                               check=True).stdout.splitlines():
        line = line.strip()
        if line.startswith("Function ") and line.endswith(":"):
            fn = line[len("Function "):-1]
        elif fn is not None and line.startswith("REG:"):
            regs[fn] = int(line.split()[0][len("REG:"):])
            fn = None
    text = subprocess.run([str(cuobjdump), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts: dict = {}
    fn = None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {"registers": regs.get(fn), "mma": 0, "dp4a": 0,
                          "lds": 0, "fmul": 0, "instructions": 0}
        elif fn is not None and "/*" in line:
            ins = line.split("*/", 1)[-1]
            if ins.strip(" ;"):
                counts[fn]["instructions"] += 1
            for key, names in (("mma", SASS_MMA), ("lds", SASS_LDS),
                               ("fmul", SASS_FMUL)):
                if any(f" {m}." in ins or f" {m} " in ins for m in names):
                    counts[fn][key] += 1
            if any(d in ins for d in SASS_DP4A):
                counts[fn]["dp4a"] += 1
    return counts


def ptxas_functions(log: str) -> dict:
    """Per function of an ``-Xptxas -v`` log: registers, stack frame and
    spill store/load bytes."""
    out: dict = {}
    fn = None
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line or \
                "Function properties for" in line:
            fn = line.split("'")[1] if "'" in line else line.split()[-1]
            out.setdefault(fn, {"registers": None, "stack": None,
                                "spill_stores": None, "spill_loads": None})
        elif fn is not None and "bytes stack frame" in line:
            # "N bytes stack frame, S bytes spill stores, L bytes spill
            # loads"
            w = line.replace(",", "").split()
            out[fn]["stack"] = int(w[0])
            out[fn]["spill_stores"] = int(w[4])
            out[fn]["spill_loads"] = int(w[8])
        elif fn is not None and line.startswith("ptxas info") and \
                "Used" in line and "registers" in line:
            w = line.split("Used", 1)[1].split()
            out[fn]["registers"] = int(w[0])
    return out


def fresh_build_logs(sources) -> dict:
    """``-Xptxas -v`` logs of ``sources`` compiled again, with the flags
    of ``_build``, into a temporary directory (one nvcc each, all
    started together): what a cached library's build printed."""
    from repro_torch.kernels import _build
    logs = {}
    with tempfile.TemporaryDirectory() as d:
        procs = {n: subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(Path(d) / f"lib{n}.so"), str(_build.CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for n in sources}
        for n, p in procs.items():
            logs[n] = p.communicate()[0]
            if p.returncode != 0:
                fail(f"fresh build of {n}.cu failed:\n{logs[n]}")
    return logs


def cuda_func_attributes(lib: str) -> dict:
    """Every kernel instantiation in a built library, as the CUDA driver
    sees it (``cuFuncGetAttribute``): its registers and its local memory
    bytes a thread, from the cubins the library holds (``cuobjdump
    -xelf``), loaded with ``cuModuleLoadData``."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    torch.zeros(1, device="cuda")           # the primary context, current
    cuobjdump = str(Path(_build.nvcc_path()).with_name("cuobjdump"))
    names = [ln.strip()[len("Function "):-1] for ln in subprocess.run(
        [cuobjdump, "-res-usage", lib], capture_output=True, text=True,
        check=True).stdout.splitlines()
        if ln.strip().startswith("Function ") and ln.strip().endswith(":")]
    cu = ctypes.CDLL("libcuda.so.1")
    out: dict = {}
    with tempfile.TemporaryDirectory() as d:
        subprocess.run([cuobjdump, "-xelf", "all", lib], cwd=d, check=True,
                       capture_output=True)
        for cubin in sorted(Path(d).glob("*.cubin")):
            mod = ctypes.c_void_p()
            rc = cu.cuModuleLoadData(ctypes.byref(mod), cubin.read_bytes())
            if rc != 0:
                fail(f"cuModuleLoadData({cubin.name}) returned {rc}")
            for name in names:
                fn = ctypes.c_void_p()
                if cu.cuModuleGetFunction(ctypes.byref(fn), mod,
                                          name.encode()) != 0:
                    continue
                regs, local = ctypes.c_int(), ctypes.c_int()
                # CU_FUNC_ATTRIBUTE_NUM_REGS = 4, _LOCAL_SIZE_BYTES = 3
                if cu.cuFuncGetAttribute(ctypes.byref(regs), 4, fn) or \
                        cu.cuFuncGetAttribute(ctypes.byref(local), 3, fn):
                    fail(f"cuFuncGetAttribute failed for {name}")
                out[name] = {"registers": regs.value,
                             "local_bytes": local.value}
            cu.cuModuleUnload(mod)
    missing = [n for n in names if n not in out]
    if missing:
        fail(f"{lib}: no cubin of the library holds {missing}")
    return out


def same_bits(a, b) -> bool:
    """Equal fp32 tensors bit for bit (+0 and -0 differ)."""
    import torch
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def sandwich_ops(ni: int, no: int) -> int:
    """fp32 multiplies and adds of one sandwich in its bitwise order
    (unrolled for ni <= 6, two contractions for ni = 8), none fused."""
    if ni <= 6:
        return no * no * (2 * ni * ni - 1)
    return no * ni * (2 * ni - 1) + no * no * (2 * ni - 1)


def epilogue_ops(n: int, m: int, changes_base: bool) -> int:
    """fp32 multiplies and adds of the output transform per (tile,
    channel), K3's and K4's epilogue alike: the rq (or deq) scale of each
    position and the sandwiches."""
    return n * n + (sandwich_ops(n, n) if changes_base else 0) + \
        sandwich_ops(n, m)


def legendre_zeros(cinvt) -> bool:
    """Whether C^-T is zero wherever the Legendre base change is
    (x^j enters P_a only for j <= a with a - j even): where it is, K3
    leaves the base change's zero terms out."""
    n = cinvt.shape[0]
    return all(float(cinvt[a, j]) == 0.0 for a in range(n) for j in range(n)
               if not (j <= a and (a - j) % 2 == 0))


def k3_ops(n: int, m: int, cinvt, changes_base: bool) -> int:
    """fp32 multiplies and adds K3 runs per (tile, channel) at n <= 6:
    the scales, the base change over its nonzero terms where C^-T has the
    Legendre zeros (each term made, multiplied and added: 3 per term, less
    one add per output), else in full, and the A sandwich in full."""
    if not (changes_base and n <= 6 and legendre_zeros(cinvt)):
        return epilogue_ops(n, m, changes_base)
    terms = sum(1 for a in range(n) for j in range(n)
                if j <= a and (a - j) % 2 == 0) ** 2
    return n * n + 3 * terms - n * n + sandwich_ops(n, m)


def input_ops(n: int, changes_base: bool) -> int:
    """fp32 multiplies and adds of K1's sandwiches per (tile, channel)."""
    return sandwich_ops(n, n) * (2 if changes_base else 1)


def infer_launches(out: dict) -> dict:
    """The launches one ``infer_resnet`` run must make: 14 Winograd convs
    a forward; calibration and staged/dynamic serving run K1 → K2 → K3,
    fused serving K1 → K4, and each stage-5 mesh K1 once and K4 once per
    slab a layer."""
    staged = out["calib_forwards"] + out["staged_forwards"] + \
        out["dynamic_forwards"]
    fw = out["sharded_forwards_per_mesh"]
    slabs = sum(a * b for a, b in (r["mesh"] for r in out["sharded"]))
    return {"input_transform": 14 * (staged + out["fused_forwards"]
                                     + fw * len(out["sharded"])),
            "wino_gemm": 14 * staged, "output_transform": 14 * staged,
            "fused_gemm_output": 14 * (out["fused_forwards"] + fw * slabs),
            "q8_matmul": 0}


def sharded_phase(dev) -> tuple:
    """Phase 8 (see the module docstring). Returns its report and the
    launches of its two main-path runs (stage 5 of ``infer_resnet`` and
    the ``launch/serve`` load)."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.checkpoint import restore
    from repro_torch.conv import ConvEngine, ConvPolicy
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.core.winograd import WinogradSpec
    from repro_torch.data.pipeline import cifar_batch_at
    from repro_torch.distributed.sharding import Placed, gather, shard
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import infer_resnet, serve
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import resnet as RN
    from repro_torch.models.param import init_params
    from repro_torch.serving import serve_padded

    rep: dict = {}
    gen = torch.Generator().manual_seed(8)

    # per layer, bit for bit on every mesh
    def layer_checks(name, xshape, cout, meshes, host):
        x = torch.randn(xshape, generator=gen).to(dev)
        w = (torch.randn((3, 3, xshape[3], cout), generator=gen)
             * 0.1).to(dev)
        n_checked = 0
        for base in ("canonical", "legendre"):
            spec0 = WinogradSpec(m=4, r=3, base=base)
            u_q, w_s = ops.prepare_weights_int8(w, spec0)
            tiles = ops._extract(x, 4, 3, spec0.n, "same")
            geom = ops._geometry(x.shape, 4, 3, "same")
            in_s = ops.scales_from_abs_max(ops._tiles_abs_max(tiles, spec0))
            for bits in (None, 8, 9):
                spec = WinogradSpec(m=4, r=3, base=base,
                                    quant=QuantConfig(hadamard_bits=bits))
                h = None
                if bits is not None:
                    _, a = ops.execute_int8(tiles, u_q, w_s, in_s, spec=spec,
                                            geom=geom, hadamard_bits=bits,
                                            with_stats=True)
                    h = a.reshape(-1, 1)
                ref = ops.execute_int8(tiles, u_q, w_s, in_s, h, spec=spec,
                                       geom=geom, hadamard_bits=bits,
                                       fused=True)
                ref_dyn = (ops.execute_int8(tiles, u_q, w_s, in_s, None,
                                            spec=spec, geom=geom,
                                            hadamard_bits=bits)
                           if bits is not None else None)
                for dd, dm in meshes:
                    mesh = make_serving_mesh(dd, dm, host_devices=host,
                                             device=dev)
                    ma = "model" if dm > 1 else None
                    y = ops.execute_int8_sharded(
                        tiles, u_q, w_s, in_s, h, spec=spec, geom=geom,
                        mesh=mesh, hadamard_bits=bits, model_axis=ma)
                    torch.cuda.synchronize()
                    if not same_bits(y, ref):
                        fail(f"sharded {name} {base} bits {bits} mesh "
                             f"{dd}x{dm}: differs from single-device fused "
                             f"(max |d| {float((y - ref).abs().max())})")
                    n_checked += 1
                    if bits is None:
                        continue
                    yd = ops.execute_int8_sharded(
                        tiles, u_q, w_s, in_s, None, spec=spec, geom=geom,
                        mesh=mesh, hadamard_bits=bits, model_axis=ma)
                    torch.cuda.synchronize()
                    if not same_bits(yd, ref_dyn):
                        fail(f"sharded dynamic {name} {base} bits {bits} "
                             f"mesh {dd}x{dm}: differs from single-device "
                             f"staged (max |d| "
                             f"{float((yd - ref_dyn).abs().max())})")
                    n_checked += 1
        return n_checked

    _build.reset_launches()
    checked = {}
    for name, xshape, cout in SHARD_LAYERS:
        checked[name] = layer_checks(name, xshape, cout, SHARD_MESHES,
                                     SHARD_HOST_DEVICES)
    xshape, cout, mesh_shape = SMALL_SLAB
    checked["small_slab"] = layer_checks("small slab", xshape, cout,
                                         (mesh_shape,), 8)
    rep["layer_checks"] = checked
    log(f"sharded per layer, bit for bit with single-device fused "
        f"(calibrated) and staged (dynamic requant), F(4,3) canonical and "
        f"legendre, Hadamard off/8/9: {checked} calls on meshes "
        f"{list(SHARD_MESHES)} over {SHARD_HOST_DEVICES} logical devices "
        f"(small slab: {xshape} → {cout} on a {mesh_shape} mesh of 8); "
        f"launches {dict(_build.LAUNCHES)}")

    # the network through infer_resnet's stage 5
    with tempfile.TemporaryDirectory() as ckpt:
        _build.reset_launches()
        out = infer_resnet.main(["--width", str(WIDTH), "--batch",
                                 str(BATCH), "--calib-steps", "2",
                                 "--ckpt-dir", ckpt, "--device", dev.type,
                                 "--host-devices", str(SHARD_HOST_DEVICES)])
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        rep["infer_resnet"] = out
        rep["infer_launches"] = launches
        rows = out["sharded"]
        if [tuple(r["mesh"]) for r in rows] != \
                list(infer_resnet.STAGE5_MESHES):
            fail(f"stage 5 ran meshes {[r['mesh'] for r in rows]}")
        want = infer_launches(out)
        if launches != want:
            fail(f"stage-5 run launches {launches}, expected {want}")
        for r in rows:
            log(f"stage 5 mesh {r['mesh'][0]}x{r['mesh'][1]}: "
                f"{r['ms']:.3f} ms a batch of {BATCH} (host clock, one "
                f"forward), {r['images_s']:.1f} images/s, bit for bit with "
                f"single-device fused {r['bitwise_vs_fused']}, rel vs fp "
                f"{r['rel_fp']:.4f} (fused {out['rel_fused_fp']:.4f})")
        log(f"stage-5 run launches: {launches}")

        # CUDA-event ms per forward on each mesh, single device beside it
        cfg = RN.ResNetConfig(
            width_mult=WIDTH,
            wino=WinogradSpec(m=4, r=3, base="legendre",
                              quant=QuantConfig(hadamard_bits=9)))
        params = init_params(RN.param_specs(cfg),
                             torch.Generator().manual_seed(0))
        state = init_params(RN.state_specs(cfg),
                            torch.Generator().manual_seed(1))
        model = RN.ResNet(cfg, params, state,
                          RN.make_engine(cfg, backend="direct", device=dev))
        single = RN.make_engine(cfg, backend="winograd_int8", device=dev)
        single.prepare(RN.conv_layers(model))
        tree, _ = restore(ckpt, single.state_template())
    single.import_state(tree)
    images = cifar_batch_at(10_000, BATCH, seed=0, device=dev)["images"]
    engines = {"single": single}
    for dd, dm in SHARD_MESHES:
        mesh = make_serving_mesh(dd, dm, host_devices=SHARD_HOST_DEVICES,
                                 device=dev)
        eng = RN.make_engine(cfg, backend="winograd_int8", mesh=mesh,
                             model_axis="model" if dm > 1 else None)
        eng.import_state(tree)
        engines[f"{dd}x{dm}"] = eng
    # per forward: eager calls back to back (the host's enqueue shows
    # where it is the longer), and replays of the forward captured in a
    # CUDA graph (device time only, as the serving loop runs it)
    fwd: dict = {}
    trace: dict = {}
    with torch.inference_mode():
        for b in (BATCH, 64, 1):
            for name, eng in engines.items():
                if b != BATCH and name not in ("single", "2x2"):
                    continue
                x = images[:b]
                key = f"{name} B={b}"
                fwd[key] = {"eager_ms": time_ms(lambda: model(x, eng),
                                                iters=10, warmup=2)}
                ms, g = graph_ms(lambda: model(x, eng))
                fwd[key]["graph_ms"] = ms
                if name in ("single", "2x2"):
                    trace[key] = replay_profile(g)
                del g
        torch.cuda.empty_cache()
    rep["forward_ms"] = fwd
    rep["forward_trace"] = trace
    log(f"sharded forward, ms a forward (CUDA events; eager: 10 calls back "
        f"to back; graph: 20 replays of it captured; every mesh on the one "
        f"card, so its slabs run one after another): "
        + ", ".join(f"{k} eager {v['eager_ms']:.3f} graph "
                    f"{v['graph_ms']:.3f}" for k, v in fwd.items()))
    for key, t in trace.items():
        log(f"sharded forward trace, {key}, a replay: device busy "
            f"{t['busy_ms']:.3f} ms (union) of a {t['window_ms']:.3f} ms "
            f"window, {t['kernels']:.0f} device intervals; top: "
            + ", ".join(f"{k[:60]} {v:.3f}" for k, v in
                        list(t["top_ms"].items())[:8]))

    # per layer, device time from CUDA-graph replays: the sharded call
    # against the single-device call, the slab copies and the gathers
    per_layer = []
    with torch.inference_mode():
        for lname, T, cin, cout, hw, count in LAYERS:
            spec = WinogradSpec(m=4, r=3, base="legendre",
                                quant=QuantConfig(hadamard_bits=9))
            x = torch.randn((BATCH, hw, hw, cin), generator=gen).to(dev)
            w = (torch.randn((3, 3, cin, cout), generator=gen) * 0.1).to(dev)
            u_q, w_s = ops.prepare_weights_int8(w, spec)
            tiles = ops._extract(x, 4, 3, spec.n, "same")
            geom = ops._geometry(x.shape, 4, 3, "same")
            in_s = ops.scales_from_abs_max(ops._tiles_abs_max(tiles, spec))
            _, a = ops.execute_int8(tiles, u_q, w_s, in_s, spec=spec,
                                    geom=geom, hadamard_bits=9,
                                    with_stats=True)
            h = a.reshape(-1, 1)
            xq = ops.quantize_input(tiles, in_s, spec=spec)
            t_single = graph_ms(lambda: ops.execute_int8(
                tiles, u_q, w_s, in_s, h, spec=spec, geom=geom,
                hadamard_bits=9, fused=True))[0]
            for dd, dm in SHARD_MESHES[1:]:
                mesh = engines[f"{dd}x{dm}"].mesh
                ma = "model" if dm > 1 else None
                pl = [Placed(t, mesh) for t in (w_s, in_s, h)]
                uq_p = Placed(u_q, mesh, ma, dim=2)

                def call():
                    return ops.execute_int8_sharded(
                        tiles, uq_p, *pl, spec=spec, geom=geom, mesh=mesh,
                        hadamard_bits=9, model_axis=ma)
                t_sh = graph_ms(call)[0]
                t_eager = time_ms(call, iters=10, warmup=2)
                t_copy = (graph_ms(lambda: shard(xq, mesh, "data", 1))[0]
                          if dd > 1 else 0.0)
                pieces = [[torch.empty((T // dd, cout // dm, 4, 4),
                                       device=dev) for _ in range(dm)]
                          for _ in range(dd)]
                t_gather = graph_ms(lambda: gather(
                    [gather(r, mesh, 1) for r in pieces], mesh, 0))[0]
                row = {"layer": lname, "count": count, "mesh": [dd, dm],
                       "T": T, "cin": cin, "cout": cout,
                       "single_ms": t_single, "sharded_ms": t_sh,
                       "sharded_eager_ms": t_eager,
                       "slab_copy_ms": t_copy, "gather_ms": t_gather,
                       "xq_bytes": int(xq.numel()),
                       "out_bytes": int(T * cout * 16 * 4)}
                per_layer.append(row)
                log(f"sharded layer {lname} (T {T}, {cin}→{cout}, x{count} "
                    f"a forward) mesh {dd}x{dm}, device ms (graph "
                    f"replays): call {t_sh:.4f} against single-device "
                    f"{t_single:.4f} (eager back to back {t_eager:.4f}); "
                    f"slab copies {t_copy:.4f} "
                    f"({row['xq_bytes'] / 1e6:.1f} MB of Xq), gathers "
                    f"{t_gather:.4f} ({row['out_bytes'] / 1e6:.1f} MB of "
                    f"output)")
            torch.cuda.empty_cache()
    rep["per_layer"] = per_layer
    for dd, dm in SHARD_MESHES[1:]:
        rows = [r for r in per_layer if r["mesh"] == [dd, dm]]

        def tot(k):
            return sum(r["count"] * r[k] for r in rows)
        log(f"sharded mesh {dd}x{dm}, per forward (count-weighted over the "
            f"14 layers, device ms): calls {tot('sharded_ms'):.3f} against "
            f"single-device {tot('single_ms'):.3f}, slab copies "
            f"{tot('slab_copy_ms'):.3f}, gathers {tot('gather_ms'):.3f}; "
            f"eager calls {tot('sharded_eager_ms'):.3f}")
    del engines, single, model
    torch.cuda.empty_cache()

    # launch/serve through a 2 x 2 mesh on the card, at a quarter of the
    # images/s of its bucket-64 graph replay
    rate = int(0.25 * 64 / (fwd["2x2 B=64"]["graph_ms"] / 1e3))
    rep["serve_rate"] = rate
    _build.reset_launches()
    sv = serve.main(["--width", str(WIDTH), "--buckets", "1,8,64",
                     "--max-wait-ms", "5", "--rate", str(rate),
                     "--requests", str(SHARD_SERVE_REQUESTS),
                     "--solo-requests", "8", "--calib-steps", "1",
                     "--calib-batch", "64", "--autotune",
                     "--mesh-devices", "2", "--model-devices", "2",
                     "--host-devices", str(SHARD_HOST_DEVICES),
                     "--device", dev.type])
    torch.cuda.synchronize()
    serve_launches = dict(_build.LAUNCHES)
    sv["launches"] = serve_launches
    replayed = {k: sum(per.get(k, 0) * sv["replays"][b]
                       for b, per in sv["launches_per_capture"].items())
                for k in SERVING}
    sv["launches_replayed"] = replayed
    rep["serve"] = sv
    log(f"sharded serve (2x2 mesh over the card, buckets 1/8/64, max wait "
        f"5 ms): {sv['requests']} Poisson requests at {rate}/s (a quarter "
        f"of 64 / the 2x2 bucket-64 graph replay) → "
        f"{sv['throughput_rps']:.1f}/s served, p50 {sv['p50_ms']:.3f} ms, "
        f"p99 {sv['p99_ms']:.3f} ms, mean batch {sv['mean_batch']:.2f}, "
        f"padding {100 * sv['padding_frac']:.1f}%, batches by bucket "
        f"{sv['batches_by_bucket']}, answered {sv['answered']}, captures "
        f"after warm-up {sv['compiles_after_warmup']}, rows checked "
        f"{sv['rows_checked']}; serve-alone {sv['solo_ms']:.3f} ms through "
        f"bucket 64, {sv['floor_ms']:.3f} ms through bucket 1; warm-up s "
        f"{sv['warmup_s']}; K4 tiles tuned at warm-up by slab T "
        f"{sv.get('warmup_tiles')}; launches {serve_launches}, per capture "
        f"{sv['launches_per_capture']}, replayed {replayed}")
    if sv["answered"] != SHARD_SERVE_REQUESTS or \
            sv["compiles_after_warmup"] != 0:
        fail(f"sharded serve: {sv['answered']} of {SHARD_SERVE_REQUESTS} "
             f"answered, {sv['compiles_after_warmup']} captures after "
             f"warm-up")
    if sorted(sv["rows_checked"]) != sorted(sv["buckets"]):
        fail(f"sharded serve: rows checked only in buckets "
             f"{sv['rows_checked']}")
    if any(serve_launches[k] <= 0 for k in SERVING) or \
            not replayed["fused_gemm_output"]:
        fail(f"sharded serve: launches {serve_launches}, replayed "
             f"{replayed}")

    # padded parity on a 2 x 2 mesh: one layer, a row served in a
    # zero-padded bucket bit for bit the row served alone
    mesh = make_serving_mesh(2, 2, host_devices=SHARD_HOST_DEVICES,
                             device=dev)
    eng1 = ConvEngine(WinogradSpec(m=4, r=3, base="legendre",
                                   quant=QuantConfig(hadamard_bits=9)),
                      ConvPolicy(backend="winograd_int8"), mesh=mesh,
                      model_axis="model")
    w1 = torch.randn((3, 3, 64, 64), generator=gen) * 0.1
    xs = torch.randn((8, 32, 32, 64), generator=gen).numpy()
    with torch.inference_mode():
        eng1.prepare([("c", w1)])
        with eng1.calibration():
            eng1.conv2d(torch.from_numpy(xs).to(dev), None, layer="c")

        def fwd1(x):
            return eng1.conv2d(x, None, layer="c")
        solo = [serve_padded(fwd1, xs[i:i + 1], 1, device=dev)[0]
                for i in range(8)]
        for n in (1, 2, 3, 5, 8):
            y = serve_padded(fwd1, xs[:n], 8, device=dev)
            for i in range(n):
                if not np.array_equal(y[i].view(np.int32),
                                      solo[i].view(np.int32)):
                    fail(f"sharded padded parity: n={n} row {i} differs "
                         f"from the row served alone")
    log("sharded padded parity on a 2x2 mesh, F(4,3) legendre 9-bit, one "
        "layer (8, 32, 32, 64) → 64: rows in zero-padded buckets of 8 bit "
        "for bit the rows served alone, n = 1, 2, 3, 5, 8")
    main_launches = {k: launches[k] + serve_launches[k] for k in launches}
    return rep, main_launches


def free_card() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def fan_in_scaled(params, model, cfg):
    """Each matrix scaled to the fan-in of its input width, the scale
    of the CPU parity tests. The init's fan-in is a stacked leaf's
    depth (1 for the hybrid's one group: std 1); there the hybrid's
    fp32 forward is ~1e-3 from fp64, and two fp32 orders of summation
    disagree as much (ROADMAP.md, "Recorded differences")."""
    from repro_torch.models.param import tree_paths
    for path, spec in tree_paths(model.param_specs(cfg)):
        if spec.init == "normal" and len(spec.shape) > 1:
            node = params
            for k in path[:-1]:
                node = node[k]
            node[path[-1]].mul_((spec.shape[0] / spec.shape[-2]) ** 0.5)
    return params


def traced(dev, fn, per: int, keep_all: bool = False) -> dict:
    """``fn()`` under the profiler: the device's busy share of the
    window, the count of device intervals and the top kernels, per
    ``per`` (with ``keep_all``, every kernel's time too)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.metrics import device_busy
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    busy, _ = device_busy(prof)
    window = e0.elapsed_time(e1)      # the events' window, not the trace's
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    by_kernel = device_ms_by_kernel(prof, per)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    out = {"busy_ms": busy / per, "window_ms": window / per,
           "busy_share": busy / window if window else 0.0,
           "device_intervals": n / per, "top_ms": dict(top),
           "read_s": time.perf_counter() - t1}
    if keep_all:
        out["all_ms"] = by_kernel
    return out


def lm_phase(dev, smi: str) -> dict:
    """Phase 9 (see the module docstring). Returns its report."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS, tiny_variant
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import batch_at
    from repro_torch.launch.steps import (generate, grow_cache,
                                          init_lm_params, make_serve_setup)
    from repro_torch.models import registry, rglru
    from repro_torch.models.param import init_params, tree_leaves, tree_map

    rep: dict = {"models": {}, "gates": {}, "card_vs_cpu": {}}
    mm = torch.backends.cuda.matmul
    tf32 = mm.allow_tf32
    mm.allow_tf32 = False     # fp32 means fp32 here (PyTorch's default)

    # 1. full width and depth, bf16: prefill -> grow -> greedy decode
    wino_calls = [0]
    wino_conv = rglru._depthwise_wino_conv

    def counted(*a, **k):
        wino_calls[0] += 1
        return wino_conv(*a, **k)
    for arch in LM_MODELS:
        cfg = ARCHS[arch]
        model = registry.get_model(cfg)
        free_card()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = init_lm_params(cfg, 0, dev)
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ps = tree_leaves(params)
        if not all(t.is_cuda for t in ps):
            fail(f"lm {arch}: parameters not on the card")
        n_params = sum(t.numel() for t in ps)
        w_bytes = sum(t.numel() * t.element_size() for t in ps)
        # a decode step reads every weight but the input-only ones: the
        # frontend projection, and an untied embedding table but for its
        # B rows (a tied one is the unembedding, read whole)
        skip = ["frontend_proj"] + ([] if cfg.tie_embeddings else ["embed"])
        dec_bytes = w_bytes - sum(params[k].numel() * params[k].element_size()
                                  for k in skip if k in params)
        if not cfg.tie_embeddings and "embed" in params:
            dec_bytes += LM_BATCH * cfg.d_model * params["embed"].element_size()
        r = {"params": n_params, "weight_bytes": w_bytes, "init_s": init_s,
             "init_peak_bytes": init_peak, "batch": LM_BATCH,
             "prompt": LM_PROMPT}
        batch = batch_at(cfg, LM_PROMPT, LM_BATCH, 0, mode="prefill",
                         device=dev)
        if cfg.is_encoder:
            with torch.inference_mode():
                model.forward(params, batch_at(cfg, 64, LM_BATCH, 1,
                                               mode="prefill", device=dev),
                              cfg)                      # warm-up
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                logits, _ = model.forward(params, batch, cfg)
                e1.record()
                torch.cuda.synchronize(dev)
            ms = e0.elapsed_time(e1)
            finite = bool(torch.isfinite(logits).all())
            if not logits.is_cuda or tuple(logits.shape) != (
                    LM_BATCH, LM_PROMPT, cfg.vocab):
                fail(f"lm {arch}: logits {tuple(logits.shape)} on "
                     f"{logits.device}")
            r.update(forward_ms=ms, tokens_s=LM_BATCH * LM_PROMPT / ms * 1e3)
            del logits
        else:
            run = RunConfig(model=cfg, seq_len=LM_PROMPT + LM_DECODE,
                            global_batch=LM_BATCH)
            warm = batch_at(cfg, cfg.n_prefix + 64, LM_BATCH, 1,
                            mode="prefill", device=dev)
            generate(run, params, warm, 2, device=dev)   # warm-up
            rglru._depthwise_wino_conv = counted
            wino_calls[0] = 0
            try:
                out = generate(run, params, batch, LM_DECODE, device=dev,
                               keep_logits=True)
            finally:
                rglru._depthwise_wino_conv = wino_conv
            lg = torch.stack(out["logits"])
            finite = bool(torch.isfinite(lg).all())
            if not lg.is_cuda or tuple(lg.shape) != (
                    LM_DECODE + 1, LM_BATCH, cfg.vocab):
                fail(f"lm {arch}: logits {tuple(lg.shape)} on {lg.device}")
            steps = sorted(out["decode_ms"])
            r.update(prefill_ms=out["prefill_ms"],
                     tokens_s=LM_BATCH * LM_PROMPT / out["prefill_ms"] * 1e3,
                     decode_ms_mean=sum(steps) / len(steps),
                     decode_ms_median=steps[len(steps) // 2],
                     decode_ms_first=out["decode_ms"][0],
                     decode_floor_ms=dec_bytes / HBM_BYTES_S * 1e3,
                     decode_weight_bytes=dec_bytes,
                     sample=out["tokens"][0, :8].tolist())
            # the device's share of a traced prefill and of 4 traced
            # decode steps (at the last positions of the run's cache)
            pre = make_serve_setup(run, "prefill", dev)
            dec = make_serve_setup(run, "decode", dev)
            r["prefill_trace"] = traced(dev, lambda: pre(params, batch), 1)
            cache, tok = out["cache"], out["tokens"][:, -1:]

            def four():
                for i in range(4):
                    pos = torch.full((LM_BATCH,), LM_PROMPT + LM_DECODE
                                     - 4 + i, dtype=torch.int32, device=dev)
                    dec(params, cache, tok, pos)
            r["decode_trace"] = traced(dev, four, 4)
            if cfg.use_winograd_conv:
                n_rec = sum(k == "rec" for _, k in
                            rglru.layer_params(params, cfg))
                r["winograd_convs"] = wino_calls[0]
                if wino_calls[0] != n_rec:
                    fail(f"lm {arch}: {wino_calls[0]} quantized Toom-Cook "
                         f"convs in prefill, {n_rec} recurrent layers")
                kv = out["cache"]["k"].shape[2]
                r["ring_slots"] = kv
                if LM_PROMPT + LM_DECODE <= kv:
                    fail(f"lm {arch}: decode did not wrap the ring buffer")
            del out, lg, cache, pre, dec, four    # the steps hold params
        r["finite"] = finite
        r["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        r["wall_s"] = time.perf_counter() - t0
        rep["models"][arch] = r
        if cfg.is_encoder:
            log(f"lm {arch}: {n_params / 1e9:.3f} B params; forward "
                f"B={LM_BATCH} S={LM_PROMPT} {r['forward_ms']:.2f} ms "
                f"({r['tokens_s']:.0f} tokens/s); peak "
                f"{r['peak_mem_bytes'] / 2**30:.2f} GiB; {smi}")
        else:
            log(f"lm {arch}: {n_params / 1e9:.3f} B params "
                f"({w_bytes / 1e9:.2f} GB); prefill B={LM_BATCH} "
                f"S={LM_PROMPT} {r['prefill_ms']:.2f} ms "
                f"({r['tokens_s']:.0f} tokens/s); decode "
                f"{r['decode_ms_median']:.3f} ms a step (median of "
                f"{LM_DECODE}; mean {r['decode_ms_mean']:.3f}, first "
                f"{r['decode_ms_first']:.3f}) against its floor "
                f"{r['decode_floor_ms']:.3f} ms "
                f"({dec_bytes / 1e9:.2f} GB of weights / 3.35 TB/s); "
                f"peak {r['peak_mem_bytes'] / 2**30:.2f} GiB serving, "
                f"{init_peak / 2**30:.2f} GiB drawing the weights "
                f"({init_s:.1f} s); {r['wall_s']:.1f} s in all"
                + (f"; {r['winograd_convs']} quantized Toom-Cook convs, "
                   f"ring of {r['ring_slots']} slots wrapped"
                   if "winograd_convs" in r else "") + f"; {smi}")
            for what in ("prefill_trace", "decode_trace"):
                tr = r[what]
                log(f"  {arch} {what.split('_')[0]} traced: device busy "
                    f"{tr['busy_ms']:.3f} of {tr['window_ms']:.3f} ms "
                    f"({100 * tr['busy_share']:.1f} %), "
                    f"{tr['device_intervals']:.0f} device intervals (trace "
                    f"read in {tr['read_s']:.1f} s); top "
                    + ", ".join(f"{k[:60]} {v:.3f}"
                                for k, v in tr["top_ms"].items()))
        if not finite:
            fail(f"lm {arch}: non-finite logits")
        del params, batch, ps
    free_card()

    # 2. fp32 at full width, reduced depth: prefill / decode vs forward
    t0 = time.perf_counter()
    g = LM_GATE
    for arch in LM_MODELS:
        cfg0 = ARCHS[arch]
        if cfg0.is_encoder:
            continue
        changes = dict(n_layers=LM_GATE_DEPTH.get(cfg0.family, 2),
                       param_dtype="float32", use_winograd_conv=False)
        if cfg0.n_experts:
            changes["capacity_factor"] = cfg0.n_experts / cfg0.top_k
        cfg = dataclasses.replace(cfg0, **changes)
        model = registry.get_model(cfg)
        params = fan_in_scaled(init_lm_params(cfg, 1, dev), model, cfg)
        S = g["S"] + cfg.n_prefix
        P = g["prompt"] + cfg.n_prefix
        full = batch_at(cfg, S, g["B"], 2, mode="prefill", device=dev)
        prompt = dict(full, tokens=full["tokens"][:, :g["prompt"]])
        with torch.inference_mode():
            ref, _ = model.forward(params, full, cfg)
            cache, last = model.prefill(params, prompt, cfg)
            cache = grow_cache(cfg, cache, g["B"], S)
            pos = torch.full((g["B"],), P, dtype=torch.int32, device=dev)
            nxt, _ = model.decode_step(
                params, cache, full["tokens"][:, g["prompt"]:][:, :1], pos,
                cfg)
        errs = {}
        for what, got, want in (("prefill", last, ref[:, P - 1]),
                                ("decode", nxt, ref[:, P])):
            d = (got - want).abs()
            errs[what] = float(d.max())
            if not bool((d <= g["atol"] + g["rtol"] * want.abs()).all()):
                fail(f"lm gate {arch} {what}: {errs[what]:.3e} off "
                     f"forward at position (rtol {g['rtol']}, atol "
                     f"{g['atol']})")
        rep["gates"][arch] = dict(depth=cfg.n_layers, **errs)
        log(f"lm gate {arch} (full width, depth {cfg.n_layers}, fp32, TF32 "
            f"off): prefill vs forward {errs['prefill']:.2e}, decode vs "
            f"forward {errs['decode']:.2e} (max abs)")
        del params, full, prompt, ref, cache, last, nxt
        free_card()

    rep["gates_wall_s"] = time.perf_counter() - t0
    log(f"lm gates: {rep['gates_wall_s']:.1f} s")

    # 3. card against CPU, tiny variants of each family
    t0 = time.perf_counter()
    t = LM_TINY
    # the six families, one model each (those served above)
    cases = [(a, {"use_winograd_conv": False}
              if ARCHS[a].use_winograd_conv else {}) for a in LM_MODELS]
    cases.append(("recurrentgemma-2b", {}))         # the conv on
    for arch, changes in cases:
        cfg = dataclasses.replace(tiny_variant(ARCHS[arch]), **changes)
        model = registry.get_model(cfg)
        p_cpu = fan_in_scaled(init_params(model.param_specs(cfg),
                                          torch.Generator().manual_seed(3)),
                              model, cfg)
        p_dev = tree_map(lambda x: x.to(dev), p_cpu)
        S = t["prompt"] + cfg.n_prefix
        b_cpu = batch_at(cfg, S, t["B"], 5, mode="prefill")
        b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
        name = arch + (" conv on" if cfg.use_winograd_conv else "")
        diffs = {}

        def close(what, got, want, tol=t["tol"]):
            if not got.is_cuda:
                fail(f"lm card-vs-CPU {name} {what}: not on the card")
            got = got.cpu().float()
            want = want.float()
            d = (got - want).abs()
            diffs[what] = float(d.max()) if d.numel() else 0.0
            if not bool((d <= tol + tol * want.abs()).all()):
                fail(f"lm card-vs-CPU {name} {what}: {diffs[what]:.3e} "
                     f"past rtol = atol = {tol}")
        if cfg.is_encoder:
            with torch.inference_mode():
                want, _ = model.forward(p_cpu, b_cpu, cfg)
                got, _ = model.forward(p_dev, b_dev, cfg)
            close("forward", got, want)
        elif cfg.use_winograd_conv:
            seen = []
            conv = rglru._conv1d

            def record(p, x, c):
                y = conv(p, x, c)
                seen.append((p, x, y))
                return y
            rglru._conv1d = record
            try:
                with torch.inference_mode():
                    model.prefill(p_cpu, b_cpu, cfg)
            finally:
                rglru._conv1d = conv
            # the same inputs on the card, at the fake-quant tier of
            # tests/test_torch_conv1d.py: each package sums the transforms
            # in its own order, which can flip a rounding step
            flips = []
            for i, (p, x, want) in enumerate(seen):
                with torch.inference_mode():
                    got = conv({k: v.to(dev) for k, v in p.items()},
                               x.to(dev), cfg)
                if not got.is_cuda:
                    fail(f"lm card-vs-CPU {name}: conv not on the card")
                d = (got.cpu() - want).abs()
                n = int((d > 1e-4 * (1 + want.abs())).sum())
                step = float(want.abs().max()) / 127 * (1 + 1e-4) + 1e-4
                flips.append(n)
                diffs[f"conv {i}"] = float(d.max())
                if n > 0.005 * d.numel() or float(d.max()) > step:
                    fail(f"lm card-vs-CPU {name} conv {i}: {n} of "
                         f"{d.numel()} outputs past 1e-4, by up to "
                         f"{float(d.max()):.3e} (one step {step:.3e})")
            rep["card_vs_cpu_conv_flips"] = flips
            diffs["convs"] = len(seen)
        else:
            run = RunConfig(model=cfg, seq_len=S + t["steps"],
                            global_batch=t["B"])
            o_cpu = generate(run, p_cpu, b_cpu, t["steps"], device="cpu",
                             keep_logits=True)
            o_dev = generate(run, p_dev, b_dev, t["steps"], device=dev,
                             teacher=o_cpu["tokens"][:, :t["steps"]].to(dev),
                             keep_logits=True)
            for i, (a, b) in enumerate(zip(o_dev["logits"], o_cpu["logits"])):
                close(f"logits {i}", a, b)
            for k in o_cpu["cache"]:
                close(f"cache {k}", o_dev["cache"][k], o_cpu["cache"][k])
        worst = max((v for k, v in diffs.items() if k != "convs"),
                    default=0.0)
        rep["card_vs_cpu"][name] = dict(diffs, worst=worst)
        log(f"lm card-vs-CPU {cfg.name}{' (conv on)' if cfg.use_winograd_conv else ''}: "
            + (f"{diffs['convs']} quantized Toom-Cook convs on the same "
               f"inputs, outputs past 1e-4: {rep['card_vs_cpu_conv_flips']}"
               f" of {seen[0][2].numel()} each, worst {worst:.2e}"
               if "convs" in diffs else
               f"{len(diffs)} tensors within 1e-4, worst {worst:.2e}"))
    rep["card_vs_cpu_wall_s"] = time.perf_counter() - t0
    log(f"lm card-vs-CPU: {rep['card_vs_cpu_wall_s']:.1f} s")
    mm.allow_tf32 = tf32
    return rep


@contextlib.contextmanager
def recording_scales():
    """Every call of the four int8 scale functions of ``kernels/ops.py``
    inside the block recorded (its inputs and the scales it returned),
    wherever the caller imported the function from: a dict name → list
    of records, for ``scale_check``."""
    from repro_torch.conv import engine, packing
    from repro_torch.kernels import ops
    calls = {k: [] for k in ("prepare_weights_int8", "scales_from_abs_max",
                             "_hadamard_rq", "_requant")}

    def recorded(name, fn):
        def call(*a, **k):
            out = fn(*a, **k)
            if name == "prepare_weights_int8":      # (w, spec)
                calls[name].append((a[0].detach().clone(), a[1],
                                    (out[0].clone(), out[1].clone())))
            elif name == "_requant":                # (hf, amax, bits)
                calls[name].append((a[1].clone(), a[2], out[1].clone()))
            elif name == "_hadamard_rq":            # (h_amax, bits)
                calls[name].append((a[0].clone(), a[1], out.clone()))
            else:                                   # (amax,)
                calls[name].append((a[0].clone(), out.clone()))
            return out
        return call
    with contextlib.ExitStack() as stack:
        for name in calls:
            wrapped = recorded(name, getattr(ops, name))
            for mod in (ops, engine, packing):
                if hasattr(mod, name):
                    stack.enter_context(mock.patch.object(mod, name,
                                                          wrapped))
        yield calls


def scale_check(records: dict) -> dict:
    """Phase 4's scale check (see the module docstring): each recorded
    card call of the four scale functions against the CPU on the same
    inputs, beside the parent's reciprocal form on the card. Fails on a
    scale the card computes otherwise than the CPU."""
    import torch
    from repro_torch.core.quantization import qmax
    from repro_torch.kernels import ops

    def bits_of(t):
        return t.detach().cpu().contiguous().view(torch.int32)

    def moved(a, b):
        """(elements, bits) where fp32 tensors a and b differ."""
        x = bits_of(a) ^ bits_of(b)
        n_bits = sum(bin(int(v) & 0xFFFFFFFF).count("1")
                     for v in x[x != 0].tolist())
        return int((x != 0).sum()), n_bits

    rep = {}

    def tally(name, old, new, cpu):
        r = rep.setdefault(name, {"calls": 0, "scales": 0,
                                  "moved_before": [0, 0],
                                  "moved_after": [0, 0]})
        r["calls"] += 1
        r["scales"] += cpu.numel()
        for key, card in (("moved_before", old), ("moved_after", new)):
            e, b = moved(card, cpu)
            r[key][0] += e
            r[key][1] += b
    for amax, out in records["scales_from_abs_max"]:
        old = torch.clamp_min(amax, 1e-12).reshape(-1, 1) / 127.0
        tally("scales_from_abs_max", old, out,
              ops.scales_from_abs_max(amax.cpu()))
    for h, bits, out in records["_hadamard_rq"]:
        old = torch.clamp_min(h.reshape(-1, 1), 1e-12) / qmax(bits)
        tally("_hadamard_rq", old, out, ops._hadamard_rq(h.cpu(), bits))
    for amax, bits, out in records["_requant"]:
        old = (torch.clamp_min(amax, 1e-12) / qmax(bits))[:, :, 0]
        cpu = ops._requant(torch.zeros_like(amax.cpu()), amax.cpu(), bits)[1]
        tally("_requant", old, out, cpu)
    w_rep = rep["prepare_weights_int8"] = {
        "calls": 0, "scales": 0, "transform_elements_apart": 0,
        "moved_before": [0, 0], "moved_after": [0, 0], "u_q_apart": 0}
    for w, spec, (u_q, s_w) in records["prepare_weights_int8"]:
        u_card = ops._transformed_weights(w, spec)
        u_cpu = ops._transformed_weights(w.cpu(), spec)
        uq_cpu, sw_cpu = ops.prepare_weights_int8(w.cpu(), spec)
        old = torch.clamp_min(u_card.abs().amax(dim=(1, 2), keepdim=True)
                              / 127.0, 1e-12).reshape(-1, 1)
        w_rep["calls"] += 1
        w_rep["scales"] += sw_cpu.numel()
        w_rep["transform_elements_apart"] += moved(u_card, u_cpu)[0]
        for key, card in (("moved_before", old), ("moved_after", s_w)):
            e, b = moved(card, sw_cpu)
            w_rep[key][0] += e
            w_rep[key][1] += b
        w_rep["u_q_apart"] += int((u_q.cpu() != uq_cpu).sum())
    for name, r in rep.items():
        log(f"scale check {name}: {r['calls']} calls of phase 4, "
            f"{r['scales']} scales; against the CPU on the same inputs, "
            f"the reciprocal form (tensor / host number) on the card moves "
            f"{r['moved_before'][0]} scales ({r['moved_before'][1]} bits), "
            f"the exact division {r['moved_after'][0]} "
            f"({r['moved_after'][1]} bits)"
            + (f"; the fp32 weight transforms {r['transform_elements_apart']}"
               f" elements apart, u_q {r['u_q_apart']} apart"
               if name == "prepare_weights_int8" else ""))
    for name, r in rep.items():
        if r["moved_after"][0] or r.get("transform_elements_apart") or \
                r.get("u_q_apart"):
            fail(f"scale check {name}: the card's scales differ from the "
                 f"CPU's: {r}")
        if not r["calls"]:
            fail(f"scale check {name}: not called in phase 4")
    return rep


def train_phase(dev, smi: str) -> dict:
    """Phase 10 (see the module docstring). Returns its report."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.checkpoint.checkpoint import restore, save
    from repro_torch.configs import ARCHS, tiny_variant
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import batch_at
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    from repro_torch.models import registry, rglru
    from repro_torch.models.param import init_params, tree_leaves, tree_map
    from repro_torch.optim.optimizer import adamw_init

    rep: dict = {"models": {}, "microbatch_gates": {}, "card_vs_cpu": {}}
    mm = torch.backends.cuda.matmul
    tf32 = mm.allow_tf32
    mm.allow_tf32 = False

    def build_run(cfg, **kw):
        # the JAX launcher's build_run: lr 3e-4, warm-up max(1, steps // 10)
        base = dict(model=cfg, seq_len=LM_TRAIN_SEQ, global_batch=LM_TRAIN_BATCH,
                    microbatch=LM_TRAIN_MICRO, lr=3e-4,
                    total_steps=LM_TRAIN_STEPS,
                    warmup_steps=max(1, LM_TRAIN_STEPS // 10))
        return RunConfig(**{**base, **kw})

    # 1. full width: 5 train steps of each model
    for arch, depth in LM_TRAIN_MODELS:
        cfg = ARCHS[arch]
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        free_card()
        t0 = time.perf_counter()
        run = build_run(cfg)
        params, opt = steps.init_train_state(run, 0, dev)
        ps = tree_leaves(params)
        if not all(t.is_cuda for t in ps + tree_leaves(opt)):
            fail(f"train {arch}: train state not on the card")
        n_params = sum(t.numel() for t in ps)
        setup = steps.make_train_setup(run, dev)
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        wino_calls = [0]
        wino_conv = rglru._depthwise_wino_conv

        def counted(*a, **k):
            wino_calls[0] += 1
            return wino_conv(*a, **k)
        rglru._depthwise_wino_conv = counted
        _build.reset_launches()
        losses, norms, ms = [], [], []
        moved_bad, swallowed, n_checked = [], [], 0
        try:
            for i in range(LM_TRAIN_STEPS):
                batch = batch_at(cfg, LM_TRAIN_SEQ, LM_TRAIN_BATCH, i, run.seed,
                                 device=dev)
                if i == 1:
                    before = [t.clone() for t in ps]
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                params, opt, met = setup.step_fn(params, opt, batch, i)
                e1.record()
                losses.append(met["loss"])
                norms.append(met["grad_norm"])
                if i == 1:
                    # the first step with lr > 0: every leaf whose second
                    # moment is nonzero (a nonzero gradient so far) moved,
                    # or else AdamW's fp32 update from this step's moments
                    # is nonzero and rounds back to every bf16 value
                    # (updates far below lr after clipping, next to eps)
                    lr = setup.lr_fn(i)
                    for t, b, m, v in zip(ps, before, tree_leaves(opt["m"]),
                                          tree_leaves(opt["v"])):
                        if not bool((v != 0).any()):
                            continue
                        n_checked += 1
                        if not torch.equal(t, b):
                            continue
                        c = i + 1
                        upd = (m / (1 - run.adam_b1 ** c)) / (torch.sqrt(
                            v / (1 - run.adam_b2 ** c)) + 1e-8) + \
                            run.weight_decay * b.float()
                        if torch.equal((b.float() - lr * upd).to(b.dtype),
                                       b) and bool((upd != 0).any()):
                            swallowed.append((tuple(t.shape),
                                              float(upd.abs().max())))
                        else:
                            moved_bad.append(tuple(t.shape))
                    del before
                    torch.cuda.reset_peak_memory_stats(dev)
                torch.cuda.synchronize(dev)
                ms.append(e0.elapsed_time(e1))
            peak = torch.cuda.max_memory_allocated(dev)
            calls = wino_calls[0]
            traced_step = traced(dev, lambda: setup.step_fn(
                params, opt, batch_at(cfg, LM_TRAIN_SEQ, LM_TRAIN_BATCH,
                                      LM_TRAIN_STEPS, run.seed, device=dev),
                LM_TRAIN_STEPS), 1)
        finally:
            rglru._depthwise_wino_conv = wino_conv
        launches = dict(_build.LAUNCHES)
        losses = [float(v) for v in losses]
        norms = [float(v) for v in norms]
        med = statistics.median(ms[1:])
        r = {"params": n_params, "depth": cfg.n_layers,
             "moment_dtype": run.moment_dtype, "init_s": init_s,
             "losses": losses, "grad_norms": norms, "step_ms": ms,
             "step_ms_median": med,
             "tokens_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / med * 1e3,
             "peak_mem_bytes": peak, "trace": traced_step,
             "launches": launches, "leaves_checked": n_checked,
             "leaves_below_bf16": swallowed,
             "winograd_convs": calls,
             "wall_s": time.perf_counter() - t0}
        rep["models"][arch] = r
        log(f"train {arch}: {n_params / 1e9:.3f} B params, depth "
            f"{cfg.n_layers}, B={LM_TRAIN_BATCH} S={LM_TRAIN_SEQ} microbatch "
            f"{LM_TRAIN_MICRO}, {run.moment_dtype} moments: {med:.2f} ms a "
            f"step (median of steps 2-{LM_TRAIN_STEPS}; all "
            f"{[round(v, 2) for v in ms]}), {r['tokens_s']:.0f} tokens/s, "
            f"peak {peak / 2**30:.2f} GiB (steps 3-{LM_TRAIN_STEPS}); losses "
            f"{[round(v, 4) for v in losses]}, grad norms "
            f"{[round(v, 3) for v in norms]}; traced step: device busy "
            f"{traced_step['busy_ms']:.1f} of {traced_step['window_ms']:.1f} "
            f"ms ({100 * traced_step['busy_share']:.1f} %), "
            f"{traced_step['device_intervals']:.0f} device intervals, top "
            + ", ".join(f"{k[:50]} {v:.1f}"
                        for k, v in traced_step["top_ms"].items())
            + f"; {n_checked - len(swallowed)} of {n_checked} leaves with "
            f"a gradient moved in step 2, the others' updates below bf16 "
            f"resolution {swallowed}; launches of K1-K5 {launches}"
            + (f"; {calls} quantized Toom-Cook convs" if cfg.use_winograd_conv
               else "") + f"; {r['wall_s']:.1f} s in all; {smi}")
        if not all(math.isfinite(v) for v in losses + norms):
            fail(f"train {arch}: losses {losses}, grad norms {norms}")
        if moved_bad or not n_checked:
            fail(f"train {arch}: {len(moved_bad)} of {n_checked} leaves with "
                 f"a gradient did not move in the first step with lr > 0, "
                 f"though their update does not round back: "
                 f"{moved_bad[:5]}")
        if any(launches.values()):
            fail(f"train {arch}: kernels launched {launches}")
        if cfg.use_winograd_conv and not calls:
            fail(f"train {arch}: the quantized Toom-Cook conv did not run")
        if arch == "llama3.2-1b":
            # the full-width train state through save and restore
            t1 = time.perf_counter()
            state = {"0": params, "1": opt}
            (ROOT / "build").mkdir(exist_ok=True)
            with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
                save(d, LM_TRAIN_STEPS, state)
                back, step = restore(d, state)
            same = step == LM_TRAIN_STEPS and all(
                a.dtype == b.dtype and torch.equal(a.cpu(), b)
                for a, b in zip(tree_leaves(state), tree_leaves(back)))
            dtypes = sorted({str(t.dtype) for t in tree_leaves(state)})
            r["checkpoint"] = {"bit_for_bit": same, "dtypes": dtypes,
                               "s": time.perf_counter() - t1}
            log(f"train {arch}: train state ({dtypes}) through save and "
                f"restore bit for bit: {same} "
                f"({r['checkpoint']['s']:.1f} s)")
            if not same:
                fail(f"train {arch}: the restored train state differs")
            del state, back
        del params, opt, ps, setup, traced_step
    free_card()

    # 2. fp32, full width, depth 2 (the hybrid 3): microbatched == full.
    # Two terms depend on which rows share a batch, in both packages: the
    # fake-quant conv's dynamic per-tensor scales (the conv is off here,
    # as in phase 9's gates) and the MoE's load-balancing loss, a product
    # of batch means (zeroed here; its share is logged beside the gate).
    from repro_torch.models import layers as lm_layers
    moe = lm_layers.moe

    def moe_without_aux(*a, **k):
        out, aux = moe(*a, **k)
        return out, aux * 0.0
    t0 = time.perf_counter()
    for arch, _ in LM_TRAIN_MODELS:
        cfg0 = ARCHS[arch]
        changes = dict(n_layers=3 if cfg0.family == "hybrid" else 2,
                       param_dtype="float32", use_winograd_conv=False)
        if cfg0.n_experts:
            changes["capacity_factor"] = cfg0.n_experts / cfg0.top_k
        cfg = dataclasses.replace(cfg0, **changes)
        model = registry.get_model(cfg)
        params = fan_in_scaled(steps.init_lm_params(cfg, 1, dev), model, cfg)
        batch = batch_at(cfg, LM_TRAIN_GATE_SEQ, LM_TRAIN_BATCH, 2, device=dev)
        run = build_run(cfg, seq_len=LM_TRAIN_GATE_SEQ)
        full = steps._loss_with_microbatch(
            model, cfg, dataclasses.replace(run, microbatch=None))
        micro = steps._loss_with_microbatch(model, cfg, run)
        aux_share = None
        if cfg.n_experts:
            aux_share = float(full(params, batch)[0]) - \
                float(micro(params, batch)[0])
            lm_layers.moe = moe_without_aux
        try:
            lf, gf = full(params, batch)
            lm, gm = micro(params, batch)
        finally:
            lm_layers.moe = moe
        worst, least = 0.0, math.inf
        for a, b in zip(tree_leaves(gm), tree_leaves(gf)):
            # relative to each leaf's largest value alone, so that an
            # accumulator missing a microbatch (half of every gradient)
            # fails on any leaf; a leaf of zeros must stay zeros
            d = float((a - b).abs().max())
            top = float(b.abs().max())
            worst = max(worst, d / top if top else d)
            least = min(least, top)
            if d > LM_TRAIN_MICRO_TOL * top:
                fail(f"train microbatch gate {arch}: a gradient leaf "
                     f"{d:.3e} apart, past {LM_TRAIN_MICRO_TOL} of its "
                     f"largest {top:.3e}")
        dl = abs(float(lm) - float(lf))
        if dl > 1e-4 * abs(float(lf)):
            fail(f"train microbatch gate {arch}: loss {float(lm)} against "
                 f"{float(lf)}")
        rep["microbatch_gates"][arch] = {"depth": cfg.n_layers,
                                         "worst_rel": worst, "loss": dl,
                                         "least_leaf_max": least,
                                         "loss_apart_with_aux": aux_share}
        log(f"train microbatch gate {arch} (full width, depth "
            f"{cfg.n_layers}, fp32, S={LM_TRAIN_GATE_SEQ}): 2 x 2 against the "
            f"batch of {LM_TRAIN_BATCH}: loss {dl:.2e} apart, gradients at "
            f"most {worst:.2e} of each leaf's largest (gate "
            f"{LM_TRAIN_MICRO_TOL}; the smallest leaf's largest {least:.3e})"
            + (f" (the MoE's aux loss zeroed; with it the losses are "
               f"{aux_share:.3e} apart)" if aux_share is not None else ""))
        del params, batch, gf, gm
        free_card()
    rep["microbatch_wall_s"] = time.perf_counter() - t0

    # 3. card against CPU: one train step of each family's tiny variant
    t0 = time.perf_counter()
    tt = LM_TRAIN_TINY
    for arch, _ in LM_TRAIN_MODELS:
        changes = {}
        if ARCHS[arch].use_winograd_conv:
            changes["use_winograd_conv"] = False
        if ARCHS[arch].n_experts:
            changes["capacity_factor"] = ARCHS[arch].n_experts / \
                ARCHS[arch].top_k
        cfg = dataclasses.replace(tiny_variant(ARCHS[arch]), **changes)
        model = registry.get_model(cfg)
        p_cpu = fan_in_scaled(init_params(model.param_specs(cfg),
                                          torch.Generator().manual_seed(3)),
                              model, cfg)
        p_dev = tree_map(lambda x: x.to(dev), p_cpu)
        run = build_run(cfg, seq_len=tt["S"], global_batch=tt["B"],
                        total_steps=10)
        b_cpu = batch_at(cfg, tt["S"], tt["B"], 1)
        b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
        grad_of = steps._loss_with_microbatch(model, cfg, run)
        l_cpu, g_cpu = grad_of(p_cpu, b_cpu)
        l_dev, g_dev = grad_of(p_dev, b_dev)
        o_cpu = adamw_init(p_cpu)
        o_dev = tree_map(lambda x: x.to(dev), o_cpu)
        lr = steps.make_train_setup(run, "cpu").lr_fn(1)
        steps.make_train_setup(run, "cpu").step_fn(p_cpu, o_cpu, b_cpu, 1)
        steps.make_train_setup(run, dev).step_fn(p_dev, o_dev, b_dev, 1)
        diffs = {}
        tol = tt["tol"]

        def close(what, got, want, where=None, floor=0.0):
            if not got.is_cuda:
                fail(f"train card-vs-CPU {arch} {what}: not on the card")
            got, want = got.cpu().float(), want.float()
            d = (got - want).abs()
            bound = tol * (1 + float(want.abs().max())) if want.numel() \
                else 0.0
            inside = d <= bound if where is None else \
                torch.where(where, d <= bound, d <= floor + bound)
            diffs[what] = float(d.max()) if d.numel() else 0.0
            if not bool(inside.all()):
                fail(f"train card-vs-CPU {arch} {what}: {diffs[what]:.3e} "
                     f"past {tol} of 1 + its largest")
        close("loss", l_dev, l_cpu)
        for k, (a, b) in enumerate(zip(tree_leaves(g_dev),
                                       tree_leaves(g_cpu))):
            close(f"grad {k}", a, b)
        for k, (a, b, g) in enumerate(zip(tree_leaves(p_dev),
                                          tree_leaves(p_cpu),
                                          tree_leaves(g_cpu))):
            # Adam's first step moves a parameter by ~lr whatever its
            # gradient's size: rounding noise may flip its sign
            above = g.abs() > 1e-3 * float(g.abs().max()) \
                if g.numel() else None
            close(f"param {k}", a, b, above, 2 * lr)
        worst_at = max(diffs, key=diffs.get)
        worst = diffs[worst_at]
        rep["card_vs_cpu"][arch] = {"worst": worst, "worst_at": worst_at,
                                    "tensors": len(diffs)}
        log(f"train card-vs-CPU {cfg.name}: one train step, {len(diffs)} "
            f"tensors (loss, gradients, updated parameters) within {tol}, "
            f"worst {worst:.2e} ({worst_at})")
        del p_cpu, p_dev, g_cpu, g_dev, o_cpu, o_dev

    # the hybrid's quantized Toom-Cook conv: its VJP on the CPU run's
    # conv inputs, card against CPU
    cfg = tiny_variant(ARCHS["recurrentgemma-2b"])
    model = registry.get_model(cfg)
    p_cpu = fan_in_scaled(init_params(model.param_specs(cfg),
                                      torch.Generator().manual_seed(3)),
                          model, cfg)
    seen = []
    conv = rglru._conv1d

    def record(p, x, c):
        seen.append((p, x.detach()))
        return conv(p, x, c)
    rglru._conv1d = record
    try:
        with torch.no_grad():
            model.forward(p_cpu, batch_at(cfg, tt["S"], tt["B"], 1,
                                          mode="prefill"), cfg)
    finally:
        rglru._conv1d = conv
    gen = torch.Generator().manual_seed(4)
    flips = []
    for i, (p, x) in enumerate(seen):
        ct = torch.randn(x.shape, generator=gen)
        grads = []
        for where in ("cpu", dev):
            tp = {k: v.detach().to(where).requires_grad_()
                  for k, v in p.items() if k in ("conv_w", "conv_b")}
            tx = x.to(where).requires_grad_()
            y = rglru._conv1d(tp, tx, cfg)
            grads.append(torch.autograd.grad(
                y, (tp["conv_w"], tp["conv_b"], tx), ct.to(where)))
        (w0, b0, x0), (w1, b1, x1) = grads
        if not x1.is_cuda:
            fail("train conv VJP: not on the card")
        for what, a, b in (("dx", x1, x0), ("db", b1, b0)):
            d = float((a.cpu() - b).abs().max())
            if d > LM_TRAIN_TINY["tol"] * (1 + float(b.abs().max())):
                fail(f"train conv VJP {i} {what}: {d:.3e} card vs CPU")
        d = (w1.cpu() - w0).abs().amax(0)
        off = d > LM_TRAIN_TINY["tol"] * (1 + w0.abs().amax(0))
        flips.append(int(off.sum()))
        if off.sum() > CONV_CHANNELS_OFF_SHARE * off.numel():
            fail(f"train conv VJP {i} dw: {int(off.sum())} of {off.numel()} "
                 f"channels off the fp32 tier")
    rep["conv_vjp_channels_off"] = flips
    log(f"train card-vs-CPU conv VJP: {len(seen)} quantized Toom-Cook "
        f"convs of the tiny hybrid on the CPU run's inputs, dx and db "
        f"within 1e-4, dw channels off the fp32 tier {flips} of "
        f"{cfg.d_rnn} each")
    if not seen:
        fail("train conv VJP: no conv ran")
    rep["card_vs_cpu_wall_s"] = time.perf_counter() - t0
    mm.allow_tf32 = tf32
    return rep

def copy_and_gather_ms(all_ms: dict) -> dict:
    """Of a traced step's device time by kernel: the copy and cast
    kernels (``.to`` between dtypes, ``contiguous``; a ``.to`` between
    logical devices of one card launches none) and the gathers
    (``torch.cat``'s kernels) in ms."""
    copies = sum(v for k, v in all_ms.items()
                 if ("copy" in k.lower() and "cat" not in k.lower()) or
                 "Memcpy" in k)
    gathers = sum(v for k, v in all_ms.items()
                  if "CatArray" in k or "cat_" in k.lower())
    return {"copies_ms": copies, "gathers_ms": gathers,
            "total_ms": sum(all_ms.values())}


def lm_shard_phase(dev, smi: str) -> dict:
    """Phase 11 (see the module docstring). Returns its report."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.checkpoint.checkpoint import restore, save
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import batch_at
    from repro_torch.distributed import compression, sharding as shd
    from repro_torch.distributed.sharding import gather_tree, place_tree
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry, rglru
    from repro_torch.models.param import tree_leaves, tree_map, tree_paths
    from repro_torch.optim.optimizer import adamw_init

    rep: dict = {"llama": {}, "train_gates": {}, "serve_gates": {}}
    mm = torch.backends.cuda.matmul
    tf32 = mm.allow_tf32
    mm.allow_tf32 = False
    mesh22 = make_mesh_for(4, 2, device=dev, host_devices=4)
    mesh11 = make_mesh_for(1, 1, device=dev)
    pod = make_mesh_for(8, 2, 4, device=dev, host_devices=8)
    if tuple(mesh22.shape.values()) != (2, 2) or \
            tuple(pod.shape.values()) != (2, 2, 2):
        fail(f"sharded LM meshes {mesh22.shape}, {pod.shape}")

    def build_run(cfg, **kw):
        base = dict(model=cfg, seq_len=LM_TRAIN_SEQ,
                    global_batch=LM_TRAIN_BATCH, microbatch=LM_TRAIN_MICRO,
                    lr=3e-4, total_steps=LM_SHARD_STEPS,
                    warmup_steps=max(1, LM_SHARD_STEPS // 10))
        return RunConfig(**{**base, **kw})

    def same(a, b) -> bool:
        a, b = (dict(enumerate(t)) if isinstance(t, list) else t
                for t in (a, b))
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(
            x.dtype == y.dtype and torch.equal(x, y.to(x.device))
            for x, y in zip(la, lb))

    # 1. llama3.2-1b at full width and depth, bf16: 3 steps one device,
    # on a 1 x 1 mesh and on a 2 x 2 mesh
    cfg = ARCHS[LM_SHARD_ARCH]
    run = build_run(cfg)

    def train(mesh):
        kw = {} if mesh is None else {"mesh": mesh}
        t0 = time.perf_counter()
        held = torch.cuda.memory_allocated(dev)   # another run's state
        params, opt = steps.init_train_state(run, 0, dev, **kw)
        setup = steps.make_train_setup(run, dev, **kw)
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        ms, losses, norms = [], [], []
        for i in range(LM_SHARD_STEPS):
            batch = batch_at(cfg, LM_TRAIN_SEQ, LM_TRAIN_BATCH, i, run.seed,
                             device=dev)
            if i == 1:
                torch.cuda.reset_peak_memory_stats(dev)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            params, opt, met = setup.step_fn(params, opt, batch, i)
            e1.record()
            torch.cuda.synchronize(dev)
            ms.append(e0.elapsed_time(e1))
            losses.append(met["loss"])
            norms.append(met["grad_norm"])
        peak = torch.cuda.max_memory_allocated(dev) - held
        med = statistics.median(ms[1:])
        return {"params": params, "opt": opt, "setup": setup,
                "losses": losses, "norms": norms,
                "r": {"init_s": init_s, "step_ms": ms, "step_ms_median": med,
                      "tokens_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / med * 1e3,
                      "peak_mem_bytes": peak,
                      "losses": [float(v) for v in losses],
                      "grad_norms": [float(v) for v in norms]}}

    def trace(out):
        t = traced(dev, lambda: out["setup"].step_fn(
            out["params"], out["opt"],
            batch_at(cfg, LM_TRAIN_SEQ, LM_TRAIN_BATCH, LM_SHARD_STEPS,
                     run.seed, device=dev), LM_SHARD_STEPS), 1, keep_all=True)
        cg = copy_and_gather_ms(t.pop("all_ms"))
        t.update(cg)
        t["copies_share"] = cg["copies_ms"] / max(cg["total_ms"], 1e-9)
        t["gathers_share"] = cg["gathers_ms"] / max(cg["total_ms"], 1e-9)
        out["r"]["trace"] = t

    t0 = time.perf_counter()
    free_card()
    one = train(None)
    free_card()
    m11 = train(mesh11)
    gathered = gather_tree({"0": m11["params"], "1": m11["opt"]})
    bits = (same(m11["losses"], one["losses"]) and
            same(m11["norms"], one["norms"]) and
            same(gathered, {"0": one["params"], "1": one["opt"]}))
    rep["llama"]["1x1_bit_for_bit"] = bits
    log(f"sharded LM {LM_SHARD_ARCH}: the 1 x 1 mesh's {LM_SHARD_STEPS} "
        f"steps bit for bit with one device (loss, grad norm, every "
        f"parameter and moment): {bits}")
    if not bits:
        fail("sharded LM: the 1 x 1 mesh's steps differ from one device's")
    del gathered
    trace(m11)
    rep["llama"]["1x1"] = m11["r"]
    del m11
    free_card()
    trace(one)
    rep["llama"]["single"] = one["r"]
    del one
    free_card()
    m22 = train(mesh22)
    trace(m22)
    rep["llama"]["2x2"] = m22["r"]
    # what the split adds in copy, cast and cat kernels over one device's
    # (its copies between cards are not measured: one card)
    tr1, tr4 = (rep["llama"][k]["trace"] for k in ("single", "2x2"))
    rep["llama"]["split_copy_cat_ms"] = \
        tr4["copies_ms"] + tr4["gathers_ms"] - tr1["copies_ms"] - \
        tr1["gathers_ms"]
    for name in ("single", "1x1", "2x2"):
        r = rep["llama"][name]
        tr = r["trace"]
        log(f"sharded LM {LM_SHARD_ARCH} train, {name}: {r['step_ms_median']:.2f} "
            f"ms a step (median of steps 2-{LM_SHARD_STEPS}; all "
            f"{[round(v, 2) for v in r['step_ms']]}), {r['tokens_s']:.0f} "
            f"tokens/s, peak {r['peak_mem_bytes'] / 2**30:.2f} GiB (above "
            f"what was held before the run), losses "
            f"{[round(v, 4) for v in r['losses']]}, grad norms "
            f"{[round(v, 3) for v in r['grad_norms']]}; traced step busy "
            f"{tr['busy_ms']:.1f} of {tr['window_ms']:.1f} ms "
            f"({100 * tr['busy_share']:.1f} %), {tr['device_intervals']:.0f} "
            f"device intervals; copy/cast kernels {tr['copies_ms']:.1f} ms "
            f"({100 * tr['copies_share']:.1f} % of device time), gathers "
            f"{tr['gathers_ms']:.1f} ms ({100 * tr['gathers_share']:.1f} %); "
            f"top " + ", ".join(f"{k[:40]} {v:.1f}"
                                for k, v in tr["top_ms"].items())
            + f"; {smi}")
    log(f"sharded LM {LM_SHARD_ARCH} train: the 2 x 2 split's copy, cast "
        f"and cat kernels beyond one device's "
        f"{rep['llama']['split_copy_cat_ms']:.1f} ms a step (one card: "
        f"copies between cards not measured)")
    if not all(math.isfinite(v) for v in rep["llama"]["2x2"]["losses"] +
               rep["llama"]["2x2"]["grad_norms"]):
        fail(f"sharded LM 2 x 2: {rep['llama']['2x2']}")

    # the 2 x 2 train state saved and restored onto the 1 x 1 mesh
    t1 = time.perf_counter()
    state = {"0": m22["params"], "1": m22["opt"]}
    whole = gather_tree(state, torch.device("cpu"))
    sh11 = steps.param_shardings(cfg, mesh11)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        save(d, LM_SHARD_STEPS, state)
        back, _ = restore(d, state, shardings={
            "0": sh11, "1": {"m": sh11, "v": sh11, "count": None}})
    ok = all(isinstance(t, shd.Sharded) and t.mesh is mesh11
             for t in tree_leaves(back["0"]))
    ok = ok and same(gather_tree(back, torch.device("cpu")), whole)
    rep["checkpoint_2x2_to_1x1"] = {"bit_for_bit": ok,
                                    "s": time.perf_counter() - t1}
    log(f"sharded LM {LM_SHARD_ARCH}: the 2 x 2 train state saved and "
        f"restored onto the 1 x 1 mesh bit for bit: {ok} "
        f"({rep['checkpoint_2x2_to_1x1']['s']:.1f} s)")
    if not ok:
        fail("sharded LM: the 2 x 2 checkpoint restored onto 1 x 1 differs")
    del back, whole

    # int8 gradient compression over the (2, 2, 2) mesh's pod axis: the
    # two halves of a batch as the two pods' gradients, card against CPU
    t1 = time.perf_counter()
    model = registry.get_model(cfg)
    lg = steps._loss_with_microbatch(
        model, cfg, dataclasses.replace(run, microbatch=None,
                                        global_batch=2), mesh22,
        steps._rules(mesh22, False))
    batch = batch_at(cfg, LM_TRAIN_SEQ, LM_TRAIN_BATCH, 7, run.seed,
                     device=dev)
    pods = [gather_tree(lg(m22["params"], {k: v[i:i + 2] for k, v in
                                           batch.items()})[1])
            for i in (0, 2)]
    errs = [tree_map(lambda t: t.float() * 1e-2, pods[1 - i])
            for i in range(2)]
    del m22, state
    free_card()
    got, got_err = compression.compressed_grad_mean(pods, errs, pod)
    cpu_pod = make_mesh_for(8, 2, 4, device="cpu", host_devices=8)
    want, want_err = compression.compressed_grad_mean(
        [tree_map(lambda t: t.cpu(), g) for g in pods],
        [tree_map(lambda t: t.cpu(), e) for e in errs], cpu_pod)
    ok = all(a.is_cuda for a in tree_leaves(got[0])) and all(
        same(tree_map(lambda t: t.cpu(), a), b)
        for a, b in zip(got + got_err, want + want_err))
    n_el = sum(t.numel() for t in tree_leaves(pods[0]))
    rep["compression"] = {"bit_for_bit": ok, "elements_a_pod": n_el,
                          "s": time.perf_counter() - t1}
    log(f"sharded LM: compressed_grad_mean over the (2, 2, 2) mesh's pod "
        f"axis on {LM_SHARD_ARCH}'s gradients ({n_el:,} a pod, bf16): card "
        f"bit for bit with the CPU, means and residuals: {ok} "
        f"({rep['compression']['s']:.1f} s)")
    if not ok:
        fail("sharded LM: compressed_grad_mean differs card vs CPU")
    del pods, errs, got, got_err, want, want_err
    free_card()

    # bf16 serving on the 2 x 2 mesh beside one device, and on the 2 x 2
    # mesh with its row-parallel partials computed and summed in fp32 and
    # cast once (as one device's GEMM accumulates): how much of the
    # greedy disagreement the bf16 partial sums make
    t1 = time.perf_counter()
    from repro_torch.models import layers as L
    per_block = L._per_block

    def fp32_partials(x, w, fn, x_dim, out_dim, after=None):
        dt = (x[0] if isinstance(x, list) else x).dtype
        if out_dim is not None or dt != torch.bfloat16:
            return per_block(x, w, fn, x_dim, out_dim, after)
        return per_block(x, w, lambda a, b: fn(a.float(), b.float()),
                         x_dim, None, after).to(dt)
    srun = RunConfig(model=cfg, seq_len=LM_PROMPT + LM_SHARD_DECODE,
                     global_batch=LM_BATCH)
    inputs = batch_at(cfg, LM_PROMPT, LM_BATCH, 0, mode="prefill",
                      device=dev)
    # C8: one device with every column-parallel product of the 2 x 2
    # mesh computed as the mesh computes it, two half-width GEMMs (the
    # row-parallel products whole)
    linear = L.linear
    col_ptrs: set = set()

    def split_columns(x, w, b=None, q8=False):
        if isinstance(w, torch.Tensor) and w.dim() == 2 and \
                w.untyped_storage().data_ptr() in col_ptrs:
            n = w.shape[-1] // 2
            y = torch.cat([x @ w[:, :n].contiguous(),
                           x @ w[:, n:].contiguous()], -1)
            return y if b is None else y + b.to(y.dtype)
        return linear(x, w, b, q8)
    def split_rows(x, w, b=None, q8=False):
        if isinstance(w, torch.Tensor) and w.dim() == 2 and \
                x.shape[0] % 2 == 0 and not q8:
            n = x.shape[0] // 2
            y = torch.cat([x[:n] @ w, x[n:] @ w], 0)
            return y if b is None else y + b.to(y.dtype)
        return linear(x, w, b, q8)
    row_ptrs: set = set()

    def split_k(x, w, b=None, q8=False):
        if isinstance(w, torch.Tensor) and w.dim() == 2 and \
                w.untyped_storage().data_ptr() in row_ptrs:
            k = w.shape[0] // 2
            y = x[..., :k] @ w[:k].contiguous()
            y = y + x[..., k:] @ w[k:].contiguous()
            return y if b is None else y + b.to(y.dtype)
        return linear(x, w, b, q8)
    sh22 = steps.param_shardings(cfg, mesh22)
    mesh21 = make_mesh_for(2, 1, device=dev, host_devices=2)
    mesh12 = make_mesh_for(2, 2, device=dev, host_devices=2)
    outs, peaks = {}, {}
    for name, mesh in (("single", None), ("2x2", mesh22),
                       ("2x2_fp32_partials", mesh22),
                       ("single_split_columns", None), ("2x1", mesh21),
                       ("1x2", mesh12), ("single_split_rows", None),
                       ("single_split_k", None)):
        params = (steps.init_lm_params(cfg, 0, dev) if mesh is None else
                  steps.init_lm_params(cfg, 0, mesh=mesh))
        if name == "2x2_fp32_partials":
            L._per_block = fp32_partials
        if name == "single_split_columns":
            col_ptrs.clear()
            for (path, t), (_, spec) in zip(
                    tree_paths(params), tree_paths(sh22)):
                sp = tuple(spec.spec)
                if (len(sp) == t.dim() and sp[-1] == "model") or (
                        path == ("embed",) and cfg.tie_embeddings and
                        sp and sp[0] == "model"):
                    col_ptrs.add(t.untyped_storage().data_ptr())
            L.linear = split_columns
        if name == "single_split_rows":
            L.linear = split_rows
        if name == "single_split_k":
            row_ptrs.clear()
            for (path, t), (_, spec) in zip(
                    tree_paths(params), tree_paths(sh22)):
                sp = tuple(spec.spec)
                if len(sp) == t.dim() and t.dim() >= 2 and \
                        sp[-2] == "model":
                    row_ptrs.add(t.untyped_storage().data_ptr())
            L.linear = split_k
        try:
            steps.generate(srun, params, inputs, 2, device=dev, mesh=mesh)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            outs[name] = steps.generate(srun, params, inputs,
                                        LM_SHARD_DECODE, device=dev,
                                        mesh=mesh, keep_logits=True)
            peaks[name] = torch.cuda.max_memory_allocated(dev) - held
        finally:
            L._per_block = per_block
            L.linear = linear
        del params
        if name != "2x2":
            outs[name].pop("cache")
        free_card()
    ref = outs["single"]
    sv = rep["llama"]["serve"] = {
        name: {"prefill_ms": o["prefill_ms"],
               "prefill_tok_s": LM_BATCH * LM_PROMPT / o["prefill_ms"] * 1e3,
               "decode_ms_median": statistics.median(o["decode_ms"])}
        for name, o in outs.items()}

    def margin(lg):
        top = lg.float().topk(2, -1).values
        return top[..., 0] - top[..., 1]
    # the first step apart of each sequence (a greedy decode follows its
    # own tokens after that, so the logits are compared up to it): the
    # largest logit gap there against one device's top-1 - top-2 margin
    for name in ("2x2", "2x2_fp32_partials"):
        o = outs[name]
        eq = o["tokens"] == ref["tokens"]
        seqs = []
        for b in range(LM_BATCH):
            k = int((~eq[b]).nonzero()[0]) if bool((~eq[b]).any()) else None
            at = k if k is not None else 0
            gap = float((o["logits"][at][b].float() -
                         ref["logits"][at][b].float()).abs().max())
            seqs.append({"first_step_apart": k, "gap_there": gap,
                         "margin_there": float(margin(ref["logits"][at][b]))})
        sv[name].update(
            greedy_agreement=float(eq.float().mean()), sequences=seqs,
            prefill_gap=float((o["logits"][0].float() -
                               ref["logits"][0].float()).abs().max()))
    o = outs["single_split_columns"]
    eq = o["tokens"] == ref["tokens"]
    seqs = []
    for b in range(LM_BATCH):
        k = int((~eq[b]).nonzero()[0]) if bool((~eq[b]).any()) else None
        at = k if k is not None else 0
        seqs.append({"first_step_apart": k, "gap_there": float(
            (o["logits"][at][b].float() - ref["logits"][at][b].float())
            .abs().max())})
    sv["c8_split_columns"] = {
        "greedy_agreement": float(eq.float().mean()), "sequences": seqs,
        "tokens_equal_2x2": bool(torch.equal(o["tokens"],
                                             outs["2x2"]["tokens"])),
        "agreement_with_2x2": float((o["tokens"] == outs["2x2"]["tokens"])
                                    .float().mean()),
        "prefill_gap": float((o["logits"][0].float() -
                              ref["logits"][0].float()).abs().max()),
        "prefill_gap_to_2x2": float((o["logits"][0].float() -
                                     outs["2x2"]["logits"][0].float())
                                    .abs().max())}
    for name in ("2x1", "1x2", "single_split_rows", "single_split_k"):
        o = outs[name]
        sv["c8_" + name] = {
            "greedy_agreement": float((o["tokens"] == ref["tokens"])
                                      .float().mean()),
            "agreement_with_2x2": float((o["tokens"] == outs["2x2"]["tokens"])
                                        .float().mean()),
            "agreement_with_1x2": float((o["tokens"] == outs["1x2"]["tokens"])
                                        .float().mean()),
            "prefill_gap_to_1x2": float((o["logits"][0].float() -
                                         outs["1x2"]["logits"][0].float())
                                        .abs().max()),
            "prefill_gap": float((o["logits"][0].float() -
                                  ref["logits"][0].float()).abs().max())}
        log(f"sharded LM {LM_SHARD_ARCH} serving, C8 bisection, {name}: "
            f"greedy tokens agree with one device at "
            f"{100 * sv['c8_' + name]['greedy_agreement']:.1f} %, with 2 x 2 "
            f"at {100 * sv['c8_' + name]['agreement_with_2x2']:.1f} %, with "
            f"1 x 2 at {100 * sv['c8_' + name]['agreement_with_1x2']:.1f} %;"
            f" prefill logits {sv['c8_' + name]['prefill_gap']:.3e} from one "
            f"device's, {sv['c8_' + name]['prefill_gap_to_1x2']:.3e} from "
            f"1 x 2's (bf16; {smi})")
    c8 = sv["c8_split_columns"]
    log(f"sharded LM {LM_SHARD_ARCH} serving, C8: one device with each "
        f"column-parallel product as two half-width GEMMs (bf16): greedy "
        f"tokens agree with one device at {100 * c8['greedy_agreement']:.1f}"
        f" % (2 x 2: {100 * sv['2x2']['greedy_agreement']:.1f} %), with "
        f"2 x 2 at {100 * c8['agreement_with_2x2']:.1f} % (all equal: "
        f"{c8['tokens_equal_2x2']}); prefill logits {c8['prefill_gap']:.3e}"
        f" from one device's, {c8['prefill_gap_to_2x2']:.3e} from 2 x 2's; "
        f"per sequence (first step apart, gap there): " + ", ".join(
            f"({q['first_step_apart']}, {q['gap_there']:.3e})"
            for q in seqs) + f"; {smi}")
    # A7.5: the decode cache a mesh position holds, against the parent's
    # placement (each row's whole cache at its first block's position)
    cache = outs["2x2"].pop("cache")
    at_pos: dict = {}
    whole_row = 0
    for name, t in cache.items():
        d = t.model_dim
        for key, blk in t.blocks.items():
            pos = (key[1], key[d] if d is not None else 0)
            at_pos[pos] = at_pos.get(pos, 0) + blk.numel() * \
                blk.element_size()
        whole_row += math.prod(t.shape) * t.dtype.itemsize // t.counts()[1]
    del cache
    sv["decode_cache"] = {
        "bytes_a_position": {f"{r},{b}": v for (r, b), v in at_pos.items()},
        "parent_bytes_a_row_first_block": whole_row, "peak_bytes": peaks}
    log(f"sharded LM {LM_SHARD_ARCH} serving, A7.5: 2 x 2 decode cache "
        f"(prompt {LM_PROMPT} + {LM_SHARD_DECODE} steps, B={LM_BATCH}) "
        f"bytes a mesh position {sorted(at_pos.items())} (cut by heads "
        f"over model); the parent placed each row's whole cache, "
        f"{whole_row:,} B, at its first block's position; serving peak "
        f"above the held weights: " + ", ".join(
            f"{k} {v / 2**30:.3f} GiB" for k, v in peaks.items())
        + f" (one card: every logical position on it); decode "
        f"{sv['2x2']['decode_ms_median']:.2f} ms a step on 2 x 2, "
        f"{sv['single']['decode_ms_median']:.2f} one device; {smi}")
    sv["prefill_margins"] = [float(v) for v in margin(ref["logits"][0])]
    top = float(ref["logits"][0].float().abs().max())
    sv["bf16_ulp_at_largest_logit"] = \
        torch.finfo(torch.bfloat16).eps * 2 ** math.floor(math.log2(top))
    for name in ("2x2", "2x2_fp32_partials"):
        v = sv[name]
        log(f"sharded LM {LM_SHARD_ARCH} serving, bf16, B={LM_BATCH}, prompt "
            f"{LM_PROMPT}, {LM_SHARD_DECODE} greedy steps, {name}: prefill "
            f"{v['prefill_ms']:.1f} ms (one device "
            f"{sv['single']['prefill_ms']:.1f}), decode "
            f"{v['decode_ms_median']:.2f} ms a step (one device "
            f"{sv['single']['decode_ms_median']:.2f}); greedy tokens agree "
            f"at {100 * v['greedy_agreement']:.1f} %; prefill logits at most "
            f"{v['prefill_gap']:.3e} apart; per sequence (first step apart, "
            f"largest logit gap there, one device's top-1 - top-2 margin "
            f"there): " + ", ".join(
                f"({q['first_step_apart']}, {q['gap_there']:.3e}, "
                f"{q['margin_there']:.3e})" for q in v["sequences"])
            + f" (logged, bf16)")
    log(f"sharded LM {LM_SHARD_ARCH} serving: one device's prefill top-1 - "
        f"top-2 margins {[f'{m:.3e}' for m in sv['prefill_margins']]}, "
        f"bf16 ulp at the largest logit {sv['bf16_ulp_at_largest_logit']:.3e}"
        f" ({time.perf_counter() - t1:.1f} s)")
    rep["llama_wall_s"] = time.perf_counter() - t0

    # 2. fp32 gates, full width, depth 2 (the hybrid 3), weights scaled to
    # input width, no MoE token dropped; the hybrid's conv and the MoE's
    # aux loss on
    t0 = time.perf_counter()
    tol = LM_SHARD_TOL
    conv_rows = [0]
    conv = rglru._depthwise_wino_conv_rows
    # the first conv's input of a run, by the run's name (set while a run
    # records): layer 0's ``x @ w_x`` of an input that is alike on every
    # mesh, so a difference there is the product's own rounding
    first_in: dict = {}
    recording = [None]

    def counted(xs, *a, **k):
        conv_rows[0] += len(xs) > 1
        if recording[0] is not None and recording[0] not in first_in:
            first_in[recording[0]] = torch.cat(
                [x.detach().float().to(dev) for x in xs])
        return conv(xs, *a, **k)

    def per_row(xs, *a, **k):
        """The planted fault: each row's conv with its own scales."""
        return [conv([x], *a, **k)[0] for x in xs]
    rglru._depthwise_wino_conv_rows = counted

    def gate_cfg(arch, **kw):
        c0 = ARCHS[arch]
        ch = dict(n_layers=3 if c0.family == "hybrid" else 2,
                  param_dtype="float32", **kw)
        if c0.n_experts:
            ch["capacity_factor"] = c0.n_experts / c0.top_k
        return dataclasses.replace(c0, **ch)

    problems = []

    def close(what, got, want, where=None, floor=0.0):
        d = (got.float() - want.float()).abs()
        bound = tol * (1 + float(want.float().abs().max())) \
            if want.numel() else 0.0
        inside = d <= bound if where is None else \
            torch.where(where, d <= bound, d <= floor + bound)
        worst = float(d.max()) if d.numel() else 0.0
        if not bool(inside.all()):
            problems.append(f"{what}: {worst:.3e} past {tol} of 1 + its "
                            f"largest")
        return worst

    def off_tier(got, want, grads, lr):
        """Of the parameters after one step: those whose gradient (here
        the first moment, its multiple) is above 1e-3 of its leaf's
        largest and lie past the tier, of how many such; those below it
        past 2 lr + the tier (Adam's first step moves any parameter by
        about lr); the largest distance."""
        n_off = n = n_low = 0
        worst = 0.0
        for a, b, g in zip(tree_leaves(got), tree_leaves(want),
                           tree_leaves(grads)):
            d = (a.float() - b.float()).abs()
            bound = tol * (1 + float(b.float().abs().max()))
            above = g.abs() > 1e-3 * float(g.abs().max())
            n_off += int((above & (d > bound)).sum())
            n_low += int((~above & (d > 2 * lr + bound)).sum())
            n += int(above.sum())
            worst = max(worst, float(d.max()))
        return n_off, n, n_low, worst

    def train_gate(arch, cfg, mesh, fsdp=False):
        """One step on ``mesh``, one on one device and one on one device
        with every weight one ulp off (how far fp32 rounding alone moves
        this model's step); where the quantized conv runs, also one step
        on ``mesh`` with the planted per-row-scale conv, which the gate
        must refuse."""
        model = registry.get_model(cfg)
        base = fan_in_scaled(steps.init_lm_params(cfg, 1, dev), model, cfg)
        run = build_run(cfg, seq_len=LM_SHARD_GATE_SEQ, fsdp=fsdp,
                        total_steps=10)
        batch = batch_at(cfg, LM_SHARD_GATE_SEQ, LM_TRAIN_BATCH, 2,
                         device=dev)
        sh = steps.param_shardings(cfg, mesh, fsdp=fsdp)
        conv_on = cfg.use_winograd_conv

        step_ms = []

        def mesh_step():
            p_sh = place_tree(tree_map(torch.clone, base), sh)
            o_sh = adamw_init(p_sh)
            fn = steps.make_train_setup(run, mesh=mesh).step_fn
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            _, _, m_sh = fn(p_sh, o_sh, batch, 1)
            e1.record()
            torch.cuda.synchronize(dev)
            step_ms.append(e0.elapsed_time(e1))
            p_sh = gather_tree(p_sh)
            free_card()
            return p_sh, m_sh
        first_in.clear()
        recording[0] = "mesh" if conv_on else None
        p_sh, m_sh = mesh_step()
        if conv_on:
            rglru._depthwise_wino_conv_rows = per_row
            try:
                recording[0] = None
                p_f, m_f = mesh_step()
            finally:
                rglru._depthwise_wino_conv_rows = counted
            # what multiplying w_x whole costs (ROADMAP C9): two more mesh
            # steps each way, w_x whole and column-parallel (the parent's)
            gate_u = rglru._rec_gate_u

            def column_parallel(p, x, cfg_, q8):
                h = rglru._apply_norm(p["ln_mix"], x, cfg_)
                gate = L._gelu(L.linear(h, p["rec"]["w_y"], q8=q8)
                               .float()).to(x.dtype)
                return gate, L.linear(h, p["rec"]["w_x"], q8=q8)
            timed = {}
            for name, fn in (("w_x whole", gate_u),
                             ("w_x column-parallel", column_parallel)):
                rglru._rec_gate_u = fn
                try:
                    del step_ms[:]
                    for _ in range(2):
                        mesh_step()
                    timed[name] = list(step_ms)
                finally:
                    rglru._rec_gate_u = gate_u
        one = steps.make_train_setup(run, dev).step_fn
        p_n = tree_map(lambda t: t * (1 + 2.0 ** -23), base)
        p_n, _, m_n = one(p_n, adamw_init(p_n), batch, 1)
        free_card()
        recording[0] = "one" if conv_on else None
        p1, o1, m1 = one(base, adamw_init(base), batch, 1)
        recording[0] = None
        lr = run.lr
        w = {"loss": close(f"{arch} loss", m_sh["loss"], m1["loss"]),
             "grad_norm": close(f"{arch} grad norm", m_sh["grad_norm"],
                                m1["grad_norm"]),
             "ulp_loss": abs(float(m_n["loss"]) - float(m1["loss"])),
             "ulp_grad_norm": abs(float(m_n["grad_norm"]) -
                                  float(m1["grad_norm"]))}
        off, n, low, w["params"] = off_tier(p_sh, p1, o1["m"], lr)
        ulp_off, _, _, w["ulp_params"] = off_tier(p_n, p1, o1["m"], lr)
        w.update(params_off=off, params_held=n, ulp_params_off=ulp_off,
                 loss_value=float(m1["loss"]), depth=cfg.n_layers,
                 mesh=dict(mesh.shape), fsdp=fsdp, mesh_step_ms=step_ms[0])
        # the parameters at the tier; where the fake-quant conv runs, the
        # products' own rounding on the mesh reaches the conv's casts and
        # STE masks, which flip, so there up to LM_SHARD_CONV_ULPS times
        # as many past it as one ulp of every weight puts past it on one
        # device, and the planted per-row-scale conv must be past that
        allowed = max(LM_SHARD_CONV_ULPS * ulp_off, n // 1000) \
            if conv_on else 0
        if low or off > allowed:
            problems.append(f"{arch} on {dict(mesh.shape)}: {off} of {n} "
                            f"parameters past {tol} of 1 + their leaf's "
                            f"largest (allowed {allowed}; one ulp of the "
                            f"weights: {ulp_off}), {low} past 2 lr")
        if conv_on:
            d = (first_in["mesh"] - first_in["one"]).abs()
            w["first_conv_input"] = {
                "max_abs": float(d.max()), "elements_apart": int(
                    (d > 0).sum()), "elements": d.numel(),
                "largest": float(first_in["one"].abs().max())}
            f_off, _, f_low, _ = off_tier(p_f, p1, o1["m"], lr)
            w["c9_step_ms"] = timed
            w.update(fault_params_off=f_off, fault_low=f_low,
                     fault_loss=abs(float(m_f["loss"]) - float(m1["loss"])),
                     fault_grad_norm=abs(float(m_f["grad_norm"]) -
                                         float(m1["grad_norm"])),
                     allowed=allowed)
            if f_off <= allowed and not f_low:
                problems.append(f"{arch} on {dict(mesh.shape)}: the gate "
                                f"passes the per-row-scale conv ({f_off} "
                                f"of {n} past, allowed {allowed})")
            del p_f
        return w

    def describe(w) -> str:
        out = (f"mesh step {w['mesh_step_ms']:.1f} ms (its first); "
               f"loss {w['loss']:.2e}, grad norm {w['grad_norm']:.2e} "
               f"apart (loss {w['loss_value']:.4f}); {w['params_off']} of "
               f"{w['params_held']:,} held parameters past the tier, worst "
               f"{w['params']:.2e}; one ulp of the weights on one device: "
               f"loss {w['ulp_loss']:.2e}, grad norm "
               f"{w['ulp_grad_norm']:.2e}, {w['ulp_params_off']} past the "
               f"tier (gate {tol} of 1 + the largest)")
        if "fault_params_off" in w:
            n = max(w["params_held"], 1)
            fi = w["first_conv_input"]
            out += "; mesh steps (ms) " + ", ".join(
                f"{k}: {[round(v, 1) for v in ms]}"
                for k, ms in w["c9_step_ms"].items())
            out += (f"; shares past: mesh {100 * w['params_off'] / n:.3f} %, "
                    f"one ulp {100 * w['ulp_params_off'] / n:.3f} %, planted "
                    f"per-row-scale conv {100 * w['fault_params_off'] / n:.3f}"
                    f" % ({w['fault_params_off']}; loss "
                    f"{w['fault_loss']:.2e}, grad norm "
                    f"{w['fault_grad_norm']:.2e} apart), allowed "
                    f"{w['allowed']} ({LM_SHARD_CONV_ULPS}x one ulp); the "
                    f"first conv's input (layer 0's x @ w_x) on the mesh: "
                    f"{fi['elements_apart']:,} of {fi['elements']:,} "
                    f"elements apart, at most {fi['max_abs']:.2e} (largest "
                    f"{fi['largest']:.2e})")
        return out

    # the lockstep conv: the rows' slabs against the whole batch on the
    # same inputs, bit for bit (every per-tensor scale over all rows)
    from repro_torch.core import winograd as W
    hcfg = ARCHS["recurrentgemma-2b"]
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((4, LM_SHARD_GATE_SEQ, hcfg.d_rnn), generator=gen,
                    device=dev)
    mats = W.make_matrices(hcfg.winograd)
    U = rglru._depthwise_wino_weights(
        torch.randn((hcfg.conv_width, hcfg.d_rnn), generator=gen,
                    device=dev), hcfg.winograd, mats)
    whole_y = rglru._depthwise_wino_conv(x, U, hcfg.winograd, mats)
    rows_y = torch.cat(rglru._depthwise_wino_conv_rows(
        list(x.split(1)), U, hcfg.winograd, mats))
    ok = torch.equal(whole_y, rows_y)
    rep["conv_rows_bit_for_bit"] = ok
    log(f"sharded LM: the quantized Toom-Cook conv over 4 rows' slabs "
        f"(full width, S={LM_SHARD_GATE_SEQ}) bit for bit with the whole "
        f"batch's conv: {ok}")
    if not ok:
        problems.append("the conv over rows differs from the whole batch's")
    try:
        for arch in LM_MODELS:
            cfg = gate_cfg(arch)
            w = train_gate(arch, cfg, mesh22)
            rep["train_gates"][arch] = w
            log(f"sharded LM train gate {arch} (full width, depth "
                f"{cfg.n_layers}, fp32, B={LM_TRAIN_BATCH} S="
                f"{LM_SHARD_GATE_SEQ}, microbatch {LM_TRAIN_MICRO}) on 2 x 2 "
                f"against one device: " + describe(w))
            free_card()
        cfg = gate_cfg("qwen2-moe-a2.7b", moe_groups=4)
        w = train_gate("qwen2-moe-a2.7b", cfg, pod, fsdp=True)
        rep["train_gates"]["qwen2-moe-a2.7b (2,2,2) fsdp"] = w
        log(f"sharded LM train gate qwen2-moe-a2.7b on (2, 2, 2) pod x data "
            f"x model, fsdp, moe_groups 4, depth 2, fp32: " + describe(w))
        free_card()
    finally:
        rglru._depthwise_wino_conv_rows = conv
    if not conv_rows[0]:
        fail("sharded LM: the quantized conv never ran over several rows")
    rep["conv_lockstep_calls"] = conv_rows[0]
    rep["train_gates_wall_s"] = time.perf_counter() - t0

    # 3. fp32 serving gates on the 2 x 2 mesh: prefill's last logits and
    # one decode step against one device, phase 9's tolerance
    t0 = time.perf_counter()
    g = LM_GATE
    for arch in LM_MODELS:
        cfg = gate_cfg(arch)
        model = registry.get_model(cfg)
        run = RunConfig(model=cfg, seq_len=g["S"], global_batch=g["B"])
        params = fan_in_scaled(steps.init_lm_params(cfg, 1, dev), model, cfg)
        p_sh = place_tree(tree_map(torch.clone, params),
                          steps.param_shardings(cfg, mesh22))
        worst = 0.0

        def hold(what, got, want):
            d = float((got - want).abs().max())
            if not torch.allclose(got, want, rtol=g["rtol"], atol=g["atol"]):
                problems.append(f"serve {arch} {what}: {d:.3e} apart")
            return d
        if cfg.is_encoder:
            batch = batch_at(cfg, g["S"], g["B"], 1, mode="prefill",
                             device=dev)
            with torch.inference_mode():
                want, _ = model.forward(params, batch, cfg)
                with shd.running(steps._rows(
                        mesh22, batch, steps._rules(mesh22, False))):
                    got, _ = model.forward(p_sh, batch, cfg)
            worst = hold("forward", got, want)
        else:
            inputs = batch_at(cfg, g["prompt"] + cfg.n_prefix, g["B"], 1,
                              mode="prefill", device=dev)
            a = steps.generate(run, params, inputs, 1, device=dev,
                               keep_logits=True)
            b = steps.generate(run, p_sh, inputs, 1, mesh=mesh22,
                               keep_logits=True)
            for i, (x, y) in enumerate(zip(b["logits"], a["logits"])):
                worst = max(worst, hold("prefill" if i == 0 else "decode",
                                        x, y))
        rep["serve_gates"][arch] = worst
        log(f"sharded LM serve gate {arch} (fp32, depth {cfg.n_layers}, "
            f"B={g['B']}, prompt {g['prompt']}): 2 x 2 "
            + ("forward" if cfg.is_encoder else "prefill and one decode step")
            + f" within rtol {g['rtol']}, atol {g['atol']} of one device, "
            f"worst {worst:.2e}")
        del params, p_sh
        free_card()
    # A7.6: w8a8 fake-quant linears served over 1 x 1 (bit for bit) and
    # 2 x 2 against one device: a rounding apart in an activation moves
    # its per-tensor scale, so every element may step by a quantum and
    # phase 9's elementwise tolerance does not hold; the gate is the
    # logits' relative distance, held below LM_SHARD_Q8_REL, above which
    # the planted per-row-scale fault must lie
    cfg = gate_cfg("llama3.2-1b", quantize_linears=True)
    model = registry.get_model(cfg)
    run = RunConfig(model=cfg, seq_len=g["S"], global_batch=g["B"])
    params = fan_in_scaled(steps.init_lm_params(cfg, 1, dev), model, cfg)
    inputs = batch_at(cfg, g["prompt"], g["B"], 1, mode="prefill",
                      device=dev)
    a = steps.generate(run, params, inputs, 1, device=dev, keep_logits=True)

    def rel(out):
        return max(float((x - y).norm() / y.norm())
                   for x, y in zip(out["logits"], a["logits"]))
    q8 = {}
    for name, mesh in (("1x1", mesh11), ("2x2", mesh22)):
        p_sh = place_tree(tree_map(torch.clone, params),
                          steps.param_shardings(cfg, mesh))
        b = steps.generate(run, p_sh, inputs, 1, mesh=mesh, keep_logits=True)
        q8[name] = {"rel": rel(b), "ok": all(
            torch.equal(x, y) for x, y in zip(b["logits"], a["logits"]))
            if name == "1x1" else rel(b) < LM_SHARD_Q8_REL}
        if name == "2x2":
            with mock.patch.object(shd.Rows, "lockstep_max",
                                   lambda self, t: t):
                f = steps.generate(run, p_sh, inputs, 1, mesh=mesh,
                                   keep_logits=True)
            q8["2x2"]["fault_rel"] = rel(f)
            q8["2x2"]["ok"] &= rel(f) > LM_SHARD_Q8_REL
        if not q8[name]["ok"]:
            problems.append(f"q8 serving on {name}: {q8[name]}, limit "
                            f"{LM_SHARD_Q8_REL}")
        del p_sh
    rep["serve_gates"]["llama3.2-1b q8"] = q8
    log(f"sharded LM serve gate llama3.2-1b with quantize_linears (w8a8 "
        f"fake-quant, fp32, depth {cfg.n_layers}, prefill and one decode "
        f"step): 1 x 1 bit for bit {q8['1x1']['ok']}; 2 x 2 logits "
        f"{q8['2x2']['rel']:.3e} from one device's (relative), the planted "
        f"per-row-scale fault {q8['2x2']['fault_rel']:.3e}, limit "
        f"{LM_SHARD_Q8_REL}: {q8['2x2']['ok']}")
    del params
    free_card()
    rep["serve_gates_wall_s"] = time.perf_counter() - t0
    rep["gate_failures"] = problems
    mm.allow_tf32 = tf32
    if problems:
        fail("sharded LM gates: " + "; ".join(problems))
    return rep


def dryrun_phase(dev, smi: str) -> dict:
    """Phase 12 (see the module docstring). Returns its report."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import batch_at
    from repro_torch.distributed.sharding import tree_blocks
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_mesh_for

    cfg = ARCHS[LM_SHARD_ARCH]
    run = RunConfig(model=cfg, seq_len=LM_TRAIN_SEQ,
                    global_batch=LM_TRAIN_BATCH, microbatch=LM_TRAIN_MICRO,
                    lr=3e-4, total_steps=10, warmup_steps=1)
    dry = dryrun.cost_step(run, "train", make_mesh_for(1, 1, device="cpu"))
    t = dry["tally"]
    mesh = make_mesh_for(1, 1, device=dev)
    params, opt = steps.init_train_state(run, 0, mesh=mesh)
    setup = steps.make_train_setup(run, mesh=mesh)
    batch = batch_at(cfg, LM_TRAIN_SEQ, LM_TRAIN_BATCH, 0, run.seed,
                     device=dev)
    live = sum(x.numel() * x.element_size() for x in
               tree_blocks(params) + tree_blocks(opt["m"]) +
               tree_blocks(opt["v"]) + [opt["count"]] + list(batch.values()))
    setup.step_fn(params, opt, batch, 0)          # warm
    torch.cuda.synchronize(dev)
    with FlopCounterMode(display=False) as fc:
        setup.step_fn(params, opt, batch, 1)
    card_flops = fc.get_total_flops()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    setup.step_fn(params, opt, batch, 2)
    e1.record()
    torch.cuda.synchronize(dev)
    step_ms = e0.elapsed_time(e1)
    tr = traced(dev, lambda: setup.step_fn(params, opt, batch, 3), 1)
    del params, opt, setup
    free_card()
    rep = {"dryrun_s": dry["seconds"], "dry": t.as_dict(),
           "dry_argument_bytes": dry["argument_bytes"],
           "live_argument_bytes": live, "card_flops": card_flops,
           "step_ms": step_ms, "device_intervals": tr["device_intervals"],
           "busy_share": tr["busy_share"],
           "bytes_at_hbm_rate_ms": t.bytes / HBM_BYTES_S * 1e3}
    log(f"dry run (phase 12) {LM_SHARD_ARCH} train step, B={LM_TRAIN_BATCH}"
        f" x {LM_TRAIN_SEQ}, microbatch {LM_TRAIN_MICRO}, 1 x 1 mesh, fake "
        f"tensors on the CPU in {dry['seconds']:.1f} s: matmul FLOPs "
        f"{t.matmul_flops:.6e} (card, FlopCounterMode over the real step: "
        f"{card_flops:.6e}); argument bytes {dry['argument_bytes']:,} (the "
        f"card's live parameters, moments, count and batch: {live:,}); "
        f"{t.launches:,} kernel-launching ops beside the traced step's "
        f"{tr['device_intervals']:.0f} device intervals; {t.bytes:.4e} "
        f"bytes read and written, {rep['bytes_at_hbm_rate_ms']:.1f} ms at "
        f"3.35 TB/s, beside the step's {step_ms:.1f} ms (busy "
        f"{100 * tr['busy_share']:.1f} %); {smi}")
    if card_flops != t.matmul_flops:
        fail(f"dry run: {t.matmul_flops} matmul FLOPs, the card's step "
             f"{card_flops}")
    if live != dry["argument_bytes"]:
        fail(f"dry run: {dry['argument_bytes']} argument bytes, the card's "
             f"live state {live}")
    return rep


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run it from the repo")
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.core.winograd import WinogradSpec
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fused_serve as fs
    from repro_torch.kernels import q8_matmul as q8
    from repro_torch.kernels import wino_gemm as wg
    from repro_torch.kernels import wino_transform as wt
    from repro_torch.launch import infer_resnet, train_resnet_qat
    from repro_torch.serving.metrics import device_busy

    report: dict = {}
    walls: dict = {}            # phase number -> its start (perf_counter)
    dev = torch.device("cuda")

    # 1. device -------------------------------------------------------------
    walls[1] = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"device {name}, capability {cap}, count "
        f"{torch.cuda.device_count()}; nvidia-smi: {smi}")
    log(f"nvcc: {nvcc[-1]}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    if cap != (9, 0):
        fail(f"capability {cap}: the kernels are built for sm_90a")
    report["device"] = {"name": name, "smi": smi, "nvcc": nvcc[-1],
                        "torch": torch.__version__}

    # 2. build --------------------------------------------------------------
    walls[2] = time.perf_counter()
    t0 = time.perf_counter()
    built = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"built {built} in {report['build_s']:.1f}s ({len(_build.SOURCES)} "
        f"nvcc processes in parallel)")
    # A cached library printed its -Xptxas -v log in the run that built
    # it: compile those sources again, so that every instantiation's
    # registers and spills are read in this run.
    cached = [n for n in _build.SOURCES if n not in built]
    t0 = time.perf_counter()
    ptxas_logs = dict(_build.BUILD_LOG)
    ptxas_logs.update(fresh_build_logs(cached))
    report["fresh_build_s"] = time.perf_counter() - t0
    log(f"libraries built by an earlier run: {cached}; compiled again "
        f"for their -Xptxas -v logs in {report['fresh_build_s']:.1f}s")
    spills, by_fn = [], {}
    for src in _build.SOURCES:
        text = ptxas_logs[src]
        for line in text.splitlines():   # kernel, registers, smem, spills
            if any(w in line for w in ("entry function", "Used", "spill",
                                       "warning")):
                log(f"  {src}: {line.strip()}")
            if "spill stores" in line and "0 bytes spill stores, 0 bytes " \
                    "spill loads" not in line:
                spills.append(f"{src}: {line.strip()}")
        by_fn.update(ptxas_functions(text))
    if spills:
        fail(f"register spills: {spills}")
    # Every instantiation of the loaded libraries, read back through the
    # CUDA driver API, must be one of the log's, with its registers and
    # its stack frame as local memory: the log is the loaded code's.
    attrs_by_src = report["cuda_func_attributes"] = {}
    for src in _build.SOURCES:
        attrs = cuda_func_attributes(str(_build._target(src)))
        attrs_by_src[src] = attrs
        for fn, a in attrs.items():
            p = by_fn.get(fn)
            log(f"  cuFuncGetAttribute {src} {fn[-60:]}: "
                f"{a['registers']} registers, {a['local_bytes']} local "
                f"bytes a thread")
            if p is None or p["registers"] != a["registers"] or \
                    p["stack"] != a["local_bytes"] or p["spill_stores"] or \
                    p["spill_loads"]:
                fail(f"{src} {fn}: cuFuncGetAttribute reads {a}, the "
                     f"ptxas log {p}")
    log(f"cuFuncGetAttribute of {sum(map(len, attrs_by_src.values()))} "
        f"instantiations match their ptxas logs: no spill anywhere")
    # Every kernel's SASS counts are logged before any gate can fail the
    # run, so that this script, copied into an older checkout, still
    # prints that checkout's counts.
    report["sass"] = {}
    for src, kernel in (("wino_transform", "input_transform_kernel"),
                        ("wino_transform", "output_transform_kernel"),
                        ("wino_gemm", "wino_gemm_kernel"),
                        ("fused_serve", "fused_kernel"),
                        ("q8_matmul", "q8_wgmma_kernel")):
        counts = {f: c for f, c in
                  sass_counts(str(_build._target(src))).items()
                  if kernel in f}
        report["sass"][kernel] = counts
        for f, c in counts.items():
            log(f"  SASS {src} {f[-60:]}: {c['registers']} registers, "
                f"{c['instructions']} instructions, {c['mma']} tensor-core "
                f"MMA, {c['dp4a']} dp4a, {c['lds']} LDS, {c['fmul']} FMUL, "
                f"{c['lds'] / max(c['fmul'], 1):.3f} LDS per FMUL")
    for kernel in ("wino_gemm_kernel", "fused_kernel", "q8_wgmma_kernel"):
        counts = report["sass"][kernel]
        if not counts or any(c["mma"] == 0 for c in counts.values()):
            fail(f"{kernel}: an instantiation has no tensor-core MMA "
                 f"instruction in its SASS ({counts})")
    if any(c["dp4a"] for c in report["sass"]["wino_gemm_kernel"].values()):
        fail(f"wino_gemm: an instantiation still uses dp4a "
             f"({report['sass']['wino_gemm_kernel']})")

    # 3. kernels against their plain versions -------------------------------
    walls[3] = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {k: 0.0 for k in TPU_KERNELS}

    def inputs(spec, T, cin, cout):
        n = spec.n
        P = n * n
        tiles = torch.randn((T, cin, n, n), generator=gen, device=dev)
        in_s = ops.scales_from_abs_max(ops._tiles_abs_max(tiles, spec))
        uq = torch.randint(-127, 128, (P, cin, cout), generator=gen,
                           device=dev, dtype=torch.int8)
        w_s = torch.rand((P, 1), generator=gen, device=dev) * 1e-2 + 1e-3
        return tiles, in_s, uq, in_s * w_s

    def check(spec, T, cin, cout, bits, label):
        o = ops._operands(spec, dev)
        cb, m = spec.changes_base, spec.m
        tiles, in_s, uq, deq = inputs(spec, T, cin, cout)
        xq = wt.input_transform(tiles, o["CinvT"], o["BPT"], in_s,
                                changes_base=cb)
        xq_p = wt.input_transform_plain(tiles, o["CinvT"], o["BPT"], in_s,
                                        changes_base=cb)
        acc = wg.wino_gemm(xq, uq)
        acc_p = wg.wino_gemm_plain(xq, uq)
        amax = (acc.float() * deq[:, :, None]).abs().amax(dim=(1, 2))
        rq = ops._hadamard_rq(amax, bits)
        hq = wg.wino_gemm(xq, uq, requant_bits=bits, deq=deq, rq=rq)
        hq_p = wg.wino_gemm_plain(xq, uq, bits, deq, rq)
        y3 = wt.output_transform(hq, rq, o["CinvT"], o["APT"], m=m,
                                 changes_base=cb)
        y3_p = wt.output_transform_plain(hq, rq, o["CinvT"], o["APT"], m=m,
                                         changes_base=cb)
        y4 = fs.fused_gemm_output(xq, uq, deq, rq, o["CinvT"], o["APT"], m=m,
                                  requant_bits=bits, changes_base=cb)
        y4_p = fs.fused_gemm_output_plain(xq, uq, deq, rq, o["CinvT"],
                                          o["APT"], m=m, requant_bits=bits,
                                          changes_base=cb)
        torch.cuda.synchronize()
        res = {}
        for k, (a, b) in {"input_transform": (xq, xq_p),
                          "wino_gemm": (acc, acc_p),
                          "wino_gemm_requant": (hq, hq_p)}.items():
            d = int((a.long() - b.long()).abs().max())
            res[k] = d
            if d != 0:
                fail(f"{label}: {k} differs from its plain version by {d}")
        for k, (a, b) in {"output_transform": (y3, y3_p),
                          "fused_gemm_output": (y4, y4_p),
                          "fused_vs_staged_kernels": (y4, y3)}.items():
            d = float((a - b).abs().max())
            res[k] = d
            if not same_bits(a, b):
                fail(f"{label}: {k} is not bit for bit (max |difference| "
                     f"{d})")
        errs["input_transform"] = max(errs["input_transform"],
                                      res["input_transform"])
        errs["wino_gemm"] = max(errs["wino_gemm"], res["wino_gemm"],
                                res["wino_gemm_requant"])
        errs["output_transform"] = max(errs["output_transform"],
                                       res["output_transform"])
        errs["fused_gemm_output"] = max(errs["fused_gemm_output"],
                                        res["fused_gemm_output"])
        log(f"{label}: Xq, int32 GEMM, requant plane, K3 and K4 bit for "
            f"bit with their plain versions, K4 with K2 → K3")
        return res

    main_spec = WinogradSpec(m=4, r=3, base="legendre",
                             quant=QuantConfig(hadamard_bits=9))
    report["checks"] = {}
    for lname, T, cin, cout, _, _ in LAYERS:
        report["checks"][lname] = check(main_spec, T, cin, cout, 9,
                                        f"F(4,3) legendre {lname} T={T} "
                                        f"Cin={cin} Cout={cout}")
    report["checks"]["f63"] = check(WinogradSpec(m=6, r=3, base="legendre"),
                                    4 * BATCH, 128, 128, 9,
                                    "F(6,3) legendre T=1024 C=128")
    report["checks"]["canonical"] = check(
        WinogradSpec(m=4, r=3, base="canonical"), 16 * BATCH, 128, 128, 8,
        "F(4,3) canonical 8-bit T=4096 C=128")
    # K4's edges: ragged Cin, T and Cout; n = 4; the requant off
    report["checks"]["ragged"] = check(main_spec, 1000, 19, 45, 9,
                                       "F(4,3) legendre T=1000 Cin=19 "
                                       "Cout=45")
    report["checks"]["f23"] = check(WinogradSpec(m=2, r=3, base="legendre"),
                                    4 * BATCH, 64, 200, 9,
                                    "F(2,3) legendre T=1024 Cin=64 Cout=200")
    for spec, T, cin, cout in ((main_spec, 16 * BATCH, 128, 128),
                               (WinogradSpec(m=6, r=3, base="legendre"),
                                BATCH, 512, 100)):
        o = ops._operands(spec, dev)
        tiles, in_s, uq, deq = inputs(spec, T, cin, cout)
        xq = wt.input_transform(tiles, o["CinvT"], o["BPT"], in_s)
        one = torch.ones_like(deq)
        y4 = fs.fused_gemm_output(xq, uq, deq, one, o["CinvT"], o["APT"],
                                  m=spec.m)
        y4_p = fs.fused_gemm_output_plain(xq, uq, deq, one, o["CinvT"],
                                          o["APT"], m=spec.m)
        torch.cuda.synchronize()
        label = f"K4 requant off F({spec.m},3) T={T} Cin={cin} Cout={cout}"
        d = float((y4 - y4_p).abs().max())
        errs["fused_gemm_output"] = max(errs["fused_gemm_output"], d)
        if not torch.equal(y4, y4_p):
            fail(f"{label}: differs from its plain version by {d}")
        log(f"{label}: bit for bit with its plain version")
        del tiles, xq, y4, y4_p

    # K1 and K2 at their edges
    report["checks"]["k12_edges"] = {}
    for m_, base, bits, T, cin, cout in K12_EDGES:
        spec = WinogradSpec(m=m_, r=3, base=base)
        o = ops._operands(spec, dev)
        cb = spec.changes_base
        tiles, in_s, uq, deq = inputs(spec, T, cin, cout)
        xq = wt.input_transform(tiles, o["CinvT"], o["BPT"], in_s,
                                changes_base=cb)
        xq_p = wt.input_transform_plain(tiles, o["CinvT"], o["BPT"], in_s,
                                        changes_base=cb)
        rq = None
        if bits is not None:
            amax = (wg.wino_gemm_plain(xq, uq).float()
                    * deq[:, :, None]).abs().amax(dim=(1, 2))
            rq = ops._hadamard_rq(amax, bits)
        h = wg.wino_gemm(xq, uq, requant_bits=bits, deq=deq, rq=rq)
        h_p = wg.wino_gemm_plain(xq, uq, bits, deq, rq)
        torch.cuda.synchronize()
        label = (f"K1/K2 edge F({m_},3) {base} T={T} Cin={cin} Cout={cout} "
                 f"requant {bits}, {wg.gemm_positions(spec.n ** 2, T, cout, cin)} "
                 f"positions a K2 block")
        d1 = int((xq.long() - xq_p.long()).abs().max())
        d2 = int((h.long() - h_p.long()).abs().max())
        report["checks"]["k12_edges"][label] = {"input_transform": d1,
                                                "wino_gemm": d2}
        errs["input_transform"] = max(errs["input_transform"], d1)
        errs["wino_gemm"] = max(errs["wino_gemm"], d2)
        if d1 or d2:
            fail(f"{label}: K1 differs by {d1}, K2 by {d2}")
        log(f"{label}: K1 and K2 bit for bit")
        del tiles, xq, xq_p, h, h_p
    # K3 at its edges
    report["checks"]["k3_edges"] = {}
    for m_, base, bits, T, C in K3_EDGES:
        spec = WinogradSpec(m=m_, r=3, base=base)
        o = ops._operands(spec, dev)
        P = spec.n ** 2
        if bits is None:     # raw accumulators, dequantized by deq
            h = torch.randint(-2 ** 30, 2 ** 30, (P, T, C), generator=gen,
                              device=dev, dtype=torch.int32)
            s = torch.rand((P, 1), generator=gen, device=dev) * 1.5e-10 \
                + 5e-11
        else:                # the requant grid, rescaled by rq
            qm = 2 ** (bits - 1) - 1
            h = torch.randint(-qm, qm + 1, (P, T, C), generator=gen,
                              device=dev, dtype=torch.int32)
            s = torch.rand((P, 1), generator=gen, device=dev) * 1e-2 + 1e-3
        y = wt.output_transform(h, s, o["CinvT"], o["APT"], m=m_,
                                changes_base=spec.changes_base)
        y_p = wt.output_transform_plain(h, s, o["CinvT"], o["APT"], m=m_,
                                        changes_base=spec.changes_base)
        torch.cuda.synchronize()
        label = (f"K3 edge F({m_},3) {base} H {bits or 'raw'} T={T} C={C} "
                 f"(T*C % 4 = {T * C % 4}, max |H| {int(h.abs().max())})")
        d = float((y - y_p).abs().max())
        report["checks"]["k3_edges"][label] = d
        errs["output_transform"] = max(errs["output_transform"], d)
        if not same_bits(y, y_p):
            fail(f"{label}: differs from its plain version by {d}")
        log(f"{label}: bit for bit")
        del h, y, y_p
    for P, M, K, N in K2_SATURATED:
        xs = torch.where(torch.rand((P, M, K), generator=gen, device=dev)
                         < 0.01, -127, 127).to(torch.int8)
        sign = torch.where(torch.arange(N, device=dev) % 2 == 1, -1, 1)
        ws = (torch.where(torch.rand((P, K, N), generator=gen, device=dev)
                          < 0.01, -127, 127) * sign).to(torch.int8)
        dq = torch.rand((P, 1), generator=gen, device=dev) * 1e-6 + 1e-7
        acc_p = wg.wino_gemm_plain(xs, ws)
        amax = float(acc_p.abs().max())
        rq = ops._hadamard_rq((acc_p.float() * dq[:, :, None]).abs()
                              .amax(dim=(1, 2)), 9)
        for bits in (None, 9):
            a = wg.wino_gemm(xs, ws, requant_bits=bits, deq=dq, rq=rq)
            b = wg.wino_gemm_plain(xs, ws, bits, dq, rq)
            torch.cuda.synchronize()
            label = (f"K2 saturated P={P} M={M} K={K} N={N} requant {bits}, "
                     f"max |acc| {amax:.4g}")
            d = int((a.long() - b.long()).abs().max())
            report["checks"]["k12_edges"][label] = {"wino_gemm": d}
            errs["wino_gemm"] = max(errs["wino_gemm"], d)
            if not amax > 2 ** 24 or d:
                fail(f"{label}: differs by {d} (|acc| must pass 2^24)")
            log(f"{label}: bit for bit")
        del xs, ws, acc_p

    def q8_inputs(M, K, N, saturated=False):
        if saturated:   # ±127, signs aligned: |acc| > 2^24, fp32 rounds
            xq = torch.where(torch.rand((M, K), generator=gen, device=dev)
                             < 0.02, -127, 127).to(torch.int8)
            xq[:, 0] = 126
            sign = torch.where(torch.arange(N, device=dev) % 2 == 1, -1, 1)
            wq = (torch.where(torch.rand((K, N), generator=gen, device=dev)
                              < 0.02, -127, 127) * sign).to(torch.int8)
            sx = torch.tensor([0.0137], device=dev)
            sw = torch.rand((N,), generator=gen, device=dev) * 0.02 + 1e-4
            return xq, wq, sx, sw
        xq = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                           dtype=torch.int8)
        sx = torch.rand((1,), generator=gen, device=dev) * 0.02 + 1e-3
        sw = torch.rand((N,), generator=gen, device=dev) * 0.02 + 1e-4
        return xq, wq, sx, sw

    q8_cases = [(M, K, N, torch.float32) for K, N in Q8_SHAPES
                for M in (PREFILL_M, DECODE_M)]
    q8_cases = [c + (False,) for c in q8_cases]
    # the predicated path (K, N not multiples of 16), with and without
    # split K; split K at N = 512; bf16; saturated sums past 2^24
    q8_cases += [(130, 100, 70, torch.float32, False),
                 (33, 1000, 24, torch.float32, False),
                 (PREFILL_M, 2048, 2048, torch.bfloat16, False),
                 (PREFILL_M, 2048, 512, torch.bfloat16, False),
                 (PREFILL_M, 8192, 2048, torch.float32, True),
                 (DECODE_M, 8192, 2048, torch.bfloat16, True)]
    report["checks"]["q8_matmul"] = {}
    for M, K, N, odt, sat in q8_cases:
        xq, wq, sx, sw = q8_inputs(M, K, N, sat)
        a = q8.q8_matmul(xq, wq, sx, sw, out_dtype=odt)
        b = q8.q8_matmul_plain(xq, wq, sx, sw, out_dtype=odt)
        torch.cuda.synchronize()
        d = float((a.float() - b.float()).abs().max())
        label = (f"K5 M={M} K={K} N={N} {str(odt).split('.')[-1]}"
                 f"{' saturated' if sat else ''} "
                 f"split {q8.q8_splits(M, N, K)}")
        report["checks"]["q8_matmul"][label] = d
        errs["q8_matmul"] = max(errs["q8_matmul"], d)
        if a.dtype != odt or not torch.equal(a, b):
            fail(f"{label}: differs from its plain version by {d}")
        log(f"{label}: bit for bit with its plain version")
    del gen

    # 4. main path ----------------------------------------------------------
    walls[4] = time.perf_counter()
    _build.reset_launches()
    with tempfile.TemporaryDirectory() as ckpt, \
            recording_scales() as scale_calls:
        out = infer_resnet.main(["--width", "1.0", "--batch", str(BATCH),
                                 "--calib-steps", "2", "--ckpt-dir", ckpt,
                                 "--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    report["main_path"] = out
    report["launches"] = launches
    log(f"serving path launches: {launches}")
    for k in SERVING:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the serving path")
    # on one card without --host-devices, stage 5 serves the 1-device mesh
    want = infer_launches(out)
    if launches != want:
        fail(f"serving-path launches {launches}, expected {want}")

    # the q8_linear path: one llama3.2-1b layer's projections, prefill
    gen = torch.Generator(device=dev).manual_seed(2)
    xs = {K: torch.randn((4, PREFILL_M // 4, K), generator=gen, device=dev)
          for K in {k for _, k, _ in LLAMA_PROJ}}
    ws = {nm: torch.randn((K, N), generator=gen, device=dev) / K ** 0.5
          for nm, K, N in LLAMA_PROJ}
    _build.reset_launches()
    ys = {nm: ops.q8_linear(xs[K], ws[nm]) for nm, K, _ in LLAMA_PROJ}
    torch.cuda.synchronize()
    q8_launches = dict(_build.LAUNCHES)
    log(f"q8_linear path launches: {q8_launches}")
    if q8_launches["q8_matmul"] != len(LLAMA_PROJ) or \
            any(q8_launches[k] for k in SERVING):
        fail(f"q8_linear path launches {q8_launches}, expected "
             f"q8_matmul {len(LLAMA_PROJ)} and nothing else")
    launches["q8_matmul"] = q8_launches["q8_matmul"]
    report["q8_linear_rel"] = {}
    for nm, K, N in LLAMA_PROJ:
        ref = xs[K] @ ws[nm]
        y = ys[nm]
        r = float((y - ref).norm() / ref.norm())
        report["q8_linear_rel"][nm] = r
        if tuple(y.shape) != (4, PREFILL_M // 4, N) or \
                not bool(torch.isfinite(y).all()) or not r < 0.05:
            fail(f"q8_linear {nm}: shape {tuple(y.shape)}, rel error {r} "
                 f"against fp32 x @ w")
    log("q8_linear rel error vs fp32 x @ w: " + ", ".join(
        f"{k} {v:.4f}" for k, v in report["q8_linear_rel"].items()))
    del xs, ws, ys, gen

    report["scale_check"] = scale_check(scale_calls)
    del scale_calls

    # 5. times --------------------------------------------------------------
    walls[5] = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1)
    o = ops._operands(main_spec, dev)
    P, m = main_spec.n ** 2, main_spec.m
    per = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": 0.0}
           for k in TPU_KERNELS}
    layer_times = {}
    for lname, T, cin, cout, hw, count in LAYERS:
        tiles, in_s, uq, deq = inputs(main_spec, T, cin, cout)
        xq = wt.input_transform(tiles, o["CinvT"], o["BPT"], in_s)
        acc = wg.wino_gemm(xq, uq)
        amax = (acc.float() * deq[:, :, None]).abs().amax(dim=(1, 2))
        rq = ops._hadamard_rq(amax, 9)
        hq = wg.wino_gemm(xq, uq, requant_bits=9, deq=deq, rq=rq)
        n = main_spec.n
        # bytes each function must move; operations in the least-work
        # (separable) form of the sandwiches, or the GEMM's 2·M·K·N
        sand = lambda ni, no: 2 * (no * ni * ni + no * no * ni)  # noqa: E731
        calls = {
            "input_transform": (
                lambda: wt.input_transform(tiles, o["CinvT"], o["BPT"],
                                           in_s),
                lambda: wt.input_transform_plain(tiles, o["CinvT"],
                                                 o["BPT"], in_s),
                T * cin * n * n * 4 + P * T * cin,
                T * cin * 2 * sand(n, n), FP32_FLOP_S, None),
            "wino_gemm": (
                lambda: wg.wino_gemm(xq, uq, requant_bits=9, deq=deq, rq=rq),
                lambda: wg.wino_gemm_plain(xq, uq, 9, deq, rq),
                P * T * cin + P * cin * cout + 4 * P * T * cout,
                2 * P * T * cin * cout, INT8_OPS_S, "int_mm"),
            "output_transform": (
                lambda: wt.output_transform(hq, rq, o["CinvT"], o["APT"],
                                            m=m),
                lambda: wt.output_transform_plain(hq, rq, o["CinvT"],
                                                  o["APT"], m=m),
                4 * P * T * cout + 4 * T * cout * m * m,
                T * cout * (sand(n, n) + sand(n, m)), FP32_FLOP_S, None),
            "fused_gemm_output": (
                lambda: fs.fused_gemm_output(xq, uq, deq, rq, o["CinvT"],
                                             o["APT"], m=m, requant_bits=9),
                lambda: fs.fused_gemm_output_plain(
                    xq, uq, deq, rq, o["CinvT"], o["APT"], m=m,
                    requant_bits=9),
                P * T * cin + P * cin * cout + 4 * T * cout * m * m,
                2 * P * T * cin * cout, INT8_OPS_S, "conv2d"),
        }
        rows = {}
        for k, (kern, plain, nbytes, nops, peak, lib) in calls.items():
            t_k = time_ms(kern)
            t_p = time_ms(plain, iters=3, warmup=1)
            b_ms = nbytes / HBM_BYTES_S * 1e3
            o_ms = nops / peak * 1e3
            t_l = None
            if lib == "conv2d":
                x = torch.randn((BATCH, cin, hw, hw), generator=gen,
                                device=dev)
                w = torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
                cudnn = torch.backends.cudnn
                with cudnn.flags(enabled=True, benchmark=False,
                                 deterministic=False, allow_tf32=False):
                    t_l = time_ms(lambda: F.conv2d(x, w, padding=1))
            elif lib == "int_mm":
                kp = -(-cin // 8) * 8        # _int_mm takes K % 8 == 0
                xa = torch.zeros((P, T, kp), dtype=torch.int8, device=dev)
                wa = torch.zeros((P, kp, cout), dtype=torch.int8,
                                 device=dev)
                xa[:, :, :cin] = xq
                wa[:, :cin, :] = uq

                def int_mm():
                    for p in range(P):
                        torch._int_mm(xa[p], wa[p])
                t_l = time_ms(int_mm)
            rows[k] = {"ms": t_k, "plain_ms": t_p, "bytes_ms": b_ms,
                       "ops_ms": o_ms, "bound_ms": max(b_ms, o_ms),
                       "library_ms": t_l, "bytes": nbytes, "ops": nops}
            acc_row = per[k]
            for f in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms"):
                acc_row[f] += count * rows[k][f]
            if t_l is not None:
                acc_row["library_ms"] += count * t_l
            log(f"time {lname:4s} {k:17s}: kernel {t_k:.4f} ms, bound "
                f"{max(b_ms, o_ms):.4f} ms ({'bytes' if b_ms >= o_ms else 'operations'}), "
                f"plain {t_p:.3f} ms, library "
                f"{'-' if t_l is None else f'{t_l:.4f} ms'}")
        # floors: the bitwise-order fp32 operations at the fp32 issue rate
        for k, key, nops_f in (
                ("input_transform", "floor_ms", T * cin * input_ops(n, True)),
                ("output_transform", "floor_ms",
                 T * cout * epilogue_ops(n, m, True)),
                ("fused_gemm_output", "epilogue_floor_ms",
                 T * cout * epilogue_ops(n, m, True))):
            f_ms = nops_f / FP32_INSTR_S * 1e3
            rows[k][key] = f_ms
            per[k][key] = per[k].get(key, 0.0) + count * f_ms
            log(f"time {lname:4s} {k:17s} floor (bitwise sandwiches, "
                f"{nops_f // (T * (cin if k == 'input_transform' else cout))}"
                f" fp32 ops per (t, c)): {f_ms:.4f} ms")
        # K3 runs fewer operations than the full order: its own work floor
        ops3 = k3_ops(n, m, o["CinvT"], True)
        w_ms = T * cout * ops3 / FP32_INSTR_S * 1e3
        rows["output_transform"]["work_floor_ms"] = w_ms
        per["output_transform"]["work_floor_ms"] = \
            per["output_transform"].get("work_floor_ms", 0.0) + count * w_ms
        log(f"time {lname:4s} output_transform  floor of the work it runs "
            f"({ops3} fp32 ops per (t, c)): {w_ms:.4f} ms")
        # K2 under each count of positions a block takes (the wrapper's
        # choice swapped)
        by_pb = {}
        for pb in wg.POSITIONS:
            with mock.patch.object(wg, "gemm_positions", lambda *_: pb):
                by_pb[pb] = time_ms(
                    lambda: wg.wino_gemm(xq, uq, requant_bits=9, deq=deq,
                                         rq=rq))
        rows["wino_gemm"]["by_positions"] = by_pb
        log(f"time {lname:4s} wino_gemm by positions a block (chosen "
            f"{wg.gemm_positions(P, T, cout, cin)}): " + ", ".join(
                f"{k}: {v:.4f} ms" for k, v in by_pb.items()))
        layer_times[lname] = rows
        del tiles, xq, acc, hq
    report["layer_times"] = layer_times
    for k in SERVING:
        r = per[k]
        log(f"per fused forward {k:17s}: kernel {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, library "
            f"{r['library_ms']:.4f} ms"
            + (f", epilogue floor {r['epilogue_floor_ms']:.4f} ms"
               if "epilogue_floor_ms" in r else "")
            + (f", floor {r['floor_ms']:.4f} ms" if "floor_ms" in r else "")
            + (f", work floor {r['work_floor_ms']:.4f} ms"
               if "work_floor_ms" in r else ""))

    # K5 at the llama3.2-1b projection shapes, prefill and decode
    gen = torch.Generator(device=dev).manual_seed(3)
    q8_rows = {}
    for M in (PREFILL_M, DECODE_M):
        for K, N in Q8_SHAPES:
            xq, wq, sx, sw = q8_inputs(M, K, N)
            nbytes = M * K + K * N + 4 + 4 * N + 4 * M * N
            b_ms = nbytes / HBM_BYTES_S * 1e3
            o_ms = 2 * M * K * N / INT8_OPS_S * 1e3
            t_k = time_ms(lambda: q8.q8_matmul(xq, wq, sx, sw))
            t_d = kernel_device_ms(lambda: q8.q8_matmul(xq, wq, sx, sw),
                                   "q8_wgmma_kernel")
            t_p = time_ms(lambda: q8.q8_matmul_plain(xq, wq, sx, sw),
                          iters=3, warmup=1)
            # torch._int_mm takes M > 16: a decode M is padded to 32 rows
            xa = torch.zeros((max(M, 32), K), dtype=torch.int8, device=dev)
            xa[:M] = xq
            t_l = time_ms(lambda: torch._int_mm(xa, wq))
            t_le = time_ms(lambda: torch._int_mm(xa, wq).float() * sx * sw)
            q8_rows[f"M={M} K={K} N={N}"] = {
                "ms": t_k, "device_ms": t_d, "plain_ms": t_p,
                "bytes_ms": b_ms, "ops_ms": o_ms,
                "bound_ms": max(b_ms, o_ms), "int_mm_ms": t_l,
                "int_mm_epilogue_ms": t_le}
            log(f"time K5 M={M:4d} K={K:4d} N={N:4d}: kernel {t_k:.4f} ms "
                f"(device {t_d:.4f} ms), bound {max(b_ms, o_ms):.4f} ms "
                f"({'bytes' if b_ms >= o_ms else 'operations'}), plain "
                f"{t_p:.3f} ms, _int_mm {t_l:.4f} ms, _int_mm + epilogue "
                f"{t_le:.4f} ms")
            del xq, wq, xa
    report["q8_times"] = q8_rows
    # K5 at the decode shapes under every split of K, the one q8_splits
    # picks among them (the wrapper with its split choice swapped): event
    # time of back-to-back calls and the kernel's device time per call
    sweep = {}
    for K, N in Q8_SHAPES:
        xq, wq, sx, sw = q8_inputs(DECODE_M, K, N)
        steps = -(-K // q8.TILE[2])
        row = {}
        for s_try in (1, 2, 4, 8, 16, 32):
            if s_try > steps:
                break
            with mock.patch.object(q8, "q8_splits", lambda *_: s_try):
                row[s_try] = {
                    "ms": time_ms(lambda: q8.q8_matmul(xq, wq, sx, sw)),
                    "device_ms": kernel_device_ms(
                        lambda: q8.q8_matmul(xq, wq, sx, sw),
                        "q8_wgmma_kernel")}
        sweep[f"M={DECODE_M} K={K} N={N}"] = row
        log(f"time K5 M={DECODE_M} K={K:4d} N={N:4d} by split of K "
            f"(chosen {q8.q8_splits(DECODE_M, N, K)}), events / device: "
            + ", ".join(f"{k}: {v['ms']:.4f} / {v['device_ms']:.4f} ms"
                        for k, v in row.items()))
        del xq, wq
    report["q8_split_sweep"] = sweep
    report["q8_layer_set"] = {}
    for M in (PREFILL_M, DECODE_M):
        tot = {f: sum(q8_rows[f"M={M} K={K} N={N}"][f]
                      for _, K, N in LLAMA_PROJ)
               for f in ("ms", "device_ms", "plain_ms", "bytes_ms", "ops_ms",
                         "bound_ms",
                         "int_mm_ms", "int_mm_epilogue_ms")}
        report["q8_layer_set"][M] = tot
        log(f"K5 over one llama3.2-1b layer's 7 projections at M={M}: "
            f"kernel {tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms, "
            f"plain {tot['plain_ms']:.3f} ms, _int_mm {tot['int_mm_ms']:.4f}"
            f" ms, _int_mm + epilogue {tot['int_mm_epilogue_ms']:.4f} ms")
    pre = report["q8_layer_set"][PREFILL_M]
    per["q8_matmul"] = {"ms": pre["ms"], "plain_ms": pre["plain_ms"],
                        "bound_ms": pre["bound_ms"],
                        "bytes_ms": pre["bytes_ms"], "ops_ms": pre["ops_ms"],
                        "library_ms": pre["int_mm_ms"]}
    del gen

    # fused serving throughput at B = 256, width 1.0
    from repro_torch.data.pipeline import cifar_batch_at
    from repro_torch.models import resnet as RN
    from repro_torch.models.param import init_params
    cfg = RN.ResNetConfig(width_mult=1.0, wino=main_spec)
    params = init_params(RN.param_specs(cfg),
                         torch.Generator().manual_seed(0))
    state = init_params(RN.state_specs(cfg),
                        torch.Generator().manual_seed(1))
    eng = RN.make_engine(cfg, backend="winograd_int8", device=dev)
    model = RN.ResNet(cfg, params, state, eng)
    with torch.inference_mode():
        eng.prepare(RN.conv_layers(model))
        with eng.calibration():
            model(cifar_batch_at(0, BATCH, device=dev)["images"])
        images = cifar_batch_at(1, BATCH, device=dev)["images"]
        fwd_ms = time_ms(lambda: model(images), iters=10, warmup=2)
        # one traced forward: device time by kernel, and the busy share
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(images)
            torch.cuda.synchronize()
    report["fused_forward_ms"] = fwd_ms
    report["images_per_s"] = BATCH / (fwd_ms / 1e3)
    log(f"fused serving, width 1.0, B={BATCH}: {fwd_ms:.3f} ms per forward, "
        f"{report['images_per_s']:.0f} images/s")
    by_kernel = device_ms_by_kernel(prof)
    busy_ms, window_ms = device_busy(prof)
    report["trace"] = {"device_ms_by_kernel": by_kernel,
                       "device_busy_ms": busy_ms,
                       "device_ms_summed": sum(by_kernel.values()),
                       "traced_window_ms": window_ms}
    if not by_kernel:
        log("trace: the profiler recorded no device time (not measured)")
    else:
        share = busy_ms / window_ms
        report["trace"]["busy_share"] = share
        if not 0.0 < share <= 1.0:
            fail(f"device-busy share {share} outside (0, 1]")
        log(f"trace of one fused forward: device busy {busy_ms:.3f} ms "
            f"(union of device intervals; their durations sum to "
            f"{sum(by_kernel.values()):.3f} ms) of a {window_ms:.3f} ms "
            f"traced window ({100 * share:.1f}% busy; event-timed forward "
            f"{fwd_ms:.3f} ms); top kernels:")
        for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
            log(f"  {v:8.3f} ms  {k[:100]}")

    # 6. train ---------------------------------------------------------------
    walls[6] = time.perf_counter()
    torch.cuda.empty_cache()
    tr = train_resnet_qat.main(["--width", "1.0", "--batch", str(BATCH),
                                "--steps", str(TRAIN_STEPS),
                                "--device", "cuda"])
    report["train"] = tr
    bad = [i for i, v in enumerate(tr["losses"]) if not math.isfinite(v)]
    if bad:
        fail(f"training losses not finite at steps {bad}: {tr['losses']}")
    still = [k for k, v in tr["param_change"].items() if not v > 0]
    flex = [k for k in tr["param_change"] if k.startswith("wino_flex.")]
    if still or len(flex) != 3:
        fail(f"parameters that did not change: {still}; flex {flex}")
    still = [k for k, v in tr["bn_change"].items() if not v > 0]
    if still:
        fail(f"BatchNorm running statistics that did not move: {still}")
    log(f"train, width 1.0, B={BATCH}, {TRAIN_STEPS} steps: losses "
        f"{[round(v, 4) for v in tr['losses']]}; {tr['step_ms']:.2f} ms per "
        f"step, {tr['images_per_s']:.0f} images/s trained, peak memory "
        f"{tr['peak_mem_bytes'] / 2**30:.2f} GiB; every parameter, the flex "
        f"matrices and the BN statistics changed")
    # where a training step's device time goes: two traced steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_resnet_qat.main(["--width", "1.0", "--batch", str(BATCH),
                               "--steps", "2", "--device", "cuda"])
        torch.cuda.synchronize()
    by_kernel = device_ms_by_kernel(prof, per=2)
    busy_ms, window_ms = device_busy(prof)
    report["train_trace"] = {"device_ms_by_kernel_per_step": by_kernel,
                             "device_busy_ms_per_step": busy_ms / 2,
                             "traced_window_ms": window_ms}
    if not by_kernel:
        log("train trace: the profiler recorded no device time "
            "(not measured)")
    else:
        log(f"train trace: device busy {busy_ms / 2:.2f} ms per step "
            f"(union of device intervals) in a {window_ms:.2f} ms traced "
            f"window of two steps and their set-up "
            f"({100 * busy_ms / window_ms:.1f}% busy; {tr['step_ms']:.2f} "
            f"ms per step untraced); top kernels per step:")
        for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
            log(f"  {v:8.3f} ms  {k[:100]}")

    # 7. serve ---------------------------------------------------------------
    walls[7] = time.perf_counter()
    torch.cuda.empty_cache()
    from repro_torch.launch import serve
    _build.reset_launches()
    t0 = time.perf_counter()
    sv = serve.main(["--width", "1.0", "--buckets", SERVE_BUCKETS,
                     "--max-wait-ms", "5", "--rate", str(SERVE_RATE),
                     "--requests", str(SERVE_REQUESTS),
                     "--solo-requests", "16", "--calib-steps", "2",
                     "--calib-batch", str(BATCH), "--plan", "--plan-tiles",
                     "2,4,6", "--plan-bases", "canonical,legendre",
                     "--plan-bits", "none,8,9", "--autotune",
                     "--trace-requests",
                     str(SERVE_REQUESTS // 2), "--device", "cuda"])
    torch.cuda.synchronize()
    sv["wall_s_total"] = time.perf_counter() - t0
    serve_launches = dict(_build.LAUNCHES)
    sv["launches"] = serve_launches
    replayed = {k: sum(per.get(k, 0) * sv["replays"][b]
                       for b, per in sv["launches_per_capture"].items())
                for k in SERVING}
    sv["launches_replayed"] = replayed
    report["serve"] = sv
    plan = sv["plan"]
    log(f"serve plan: {plan['describe']}; routes that differ from the "
        f"baseline F(4,3)/legendre/9b: {plan['differs_from_baseline']}")
    log(f"serve plan entries: {plan['entries']}")
    log(f"serve tuned K4 tiles at calibration (bucket {BATCH}): "
        f"{sv['tuned_tiles']}; at warm-up, by T: {sv['warmup_tiles']}")
    log(f"serve warm-up s per bucket (eager run + capture + replay): "
        f"{sv['warmup_s']}")
    log(f"serve-alone: {sv['solo_ms']:.3f} ms a request through bucket "
        f"{sv['buckets'][-1]}, {sv['floor_ms']:.3f} ms through bucket "
        f"{sv['buckets'][0]}")
    log(f"serve load: {sv['requests']} Poisson requests at "
        f"{sv['rate_rps']:.0f}/s → {sv['throughput_rps']:.1f}/s served, p50 "
        f"{sv['p50_ms']:.3f} ms, p99 {sv['p99_ms']:.3f} ms, mean batch "
        f"{sv['mean_batch']:.2f}, padding {100 * sv['padding_frac']:.1f}%, "
        f"in flight {100 * sv['in_flight_frac']:.1f}% (share of the wall "
        f"with a batch between dispatch and delivery), batches by bucket "
        f"{sv['batches_by_bucket']}, answered {sv['answered']}, captures "
        f"after warm-up {sv['compiles_after_warmup']}")
    log(f"serve rows bit for bit with the eager forward, batches checked "
        f"per bucket: {sv['rows_checked']}")
    tr = sv["trace"]
    log(f"serve traced load ({tr['requests']} more requests, profiler on): "
        f"device busy {tr['device_busy_ms']:.3f} ms (union) of a "
        f"{tr['window_ms']:.3f} ms window ({100 * tr['busy_share']:.1f}% "
        f"busy, {100 - 100 * tr['busy_share']:.1f}% idle) over "
        f"{tr['batches']} batches; device time by kernel:")
    for k, v in tr["top_kernels_ms"].items():
        log(f"  {v:8.3f} ms  {k[:100]}")
    if not 0.0 < tr["busy_share"] <= 1.0:
        fail(f"serve: device-busy share under load {tr['busy_share']}")
    log(f"serve launches (Python side: calibration, planner, autotune, "
        f"eager warm-up runs and captures): {serve_launches}; launches per "
        f"capture {sv['launches_per_capture']}, replays {sv['replays']}, "
        f"launches run by the replays {replayed}; {sv['wall_s_total']:.1f}s "
        f"in all")
    if sv["answered"] != SERVE_REQUESTS or sv["compiles_after_warmup"] != 0:
        fail(f"serve: {sv['answered']} of {SERVE_REQUESTS} answered, "
             f"{sv['compiles_after_warmup']} captures after warm-up")
    if sorted(sv["rows_checked"]) != sorted(sv["buckets"]):
        fail(f"serve: served rows checked only in buckets "
             f"{sv['rows_checked']}")
    for k in SERVING:
        if serve_launches[k] <= 0:
            fail(f"kernel {k} was not launched on the serving path")
    if not replayed["input_transform"] or not replayed["fused_gemm_output"]:
        fail(f"serve: the captured graphs hold no K1/K4 launch: {replayed}")
    # K4's tile per served layer shape at buckets 64 and 256: each T
    # serves the tile tuned at it (at calibration for bucket 256, the
    # calibration batch; at warm-up for the others), timed again here
    from repro_torch.conv.autotune import autotune_blocks
    from repro_torch.conv.planner import Plan
    served_plan = Plan.from_dict(plan["dict"])
    by_bucket: dict = {}
    for b in (64, 256):
        seen = {}
        for g in RN.layer_geoms(RN.ResNetConfig(width_mult=1.0), b):
            e = served_plan.get(g.layer)
            if e is None or not e.is_winograd:
                continue
            spec = e.spec()
            T = b * math.ceil(g.x_shape[1] / spec.m) \
                * math.ceil(g.x_shape[2] / spec.m)
            key = (e.describe(), T, g.cin, g.cout)
            if key not in seen:
                res = autotune_blocks(spec, T, g.cin, g.cout,
                                      hadamard_bits=e.hadamard_bits,
                                      device=dev)
                seen[key] = {
                    "entry": e.describe(), "T": T, "cin": g.cin,
                    "cout": g.cout, "fused_tile": list(res.default_tile),
                    "fastest": list(res.tile),
                    "us": {f"{t[0]}x{t[1]}": us for t, us in res.timings},
                    "layers": []}
            seen[key]["layers"].append(g.layer)
        by_bucket[b] = list(seen.values())
        for r in by_bucket[b]:
            layer = r["layers"][0]
            served_tile = (sv["tuned_tiles"][layer]
                           if sv["tuned_at_T"][layer] == r["T"]
                           else sv["warmup_tiles"][layer][r["T"]])
            r["served"] = list(served_tile)
            log(f"serve K4 tile at bucket {b}: {r['entry']} T {r['T']} "
                f"Cin {r['cin']} Cout {r['cout']} ({len(r['layers'])} "
                f"layers): served {served_tile}, fused_tile "
                f"{tuple(r['fused_tile'])}, "
                f"fastest {tuple(r['fastest'])}; µs a call "
                + ", ".join(f"{t} {us:.1f}" for t, us in r["us"].items()))
    sv["k4_tiles_by_bucket"] = by_bucket
    # padded parity on the card: one int8 Winograd layer, a row served in
    # a zero-padded bucket bit for bit the same row served alone
    from repro_torch.conv import ConvEngine, ConvPolicy
    from repro_torch.serving import serve_padded
    gen = torch.Generator().manual_seed(4)
    for base in ("canonical", "legendre"):
        eng1 = ConvEngine(WinogradSpec(m=4, r=3, base=base,
                                       quant=QuantConfig(hadamard_bits=9)),
                          ConvPolicy(backend="winograd_int8"), device=dev)
        w1 = torch.randn((3, 3, 64, 64), generator=gen) * 0.1
        xs = torch.randn((8, 32, 32, 64), generator=gen).numpy()
        _build.reset_launches()
        with torch.inference_mode():
            eng1.prepare([("c", w1)])
            with eng1.calibration():
                eng1.conv2d(torch.from_numpy(xs).to(dev), None, layer="c")

            def fwd1(x):
                return eng1.conv2d(x, None, layer="c")
            solo = [serve_padded(fwd1, xs[i:i + 1], 1, device=dev)[0]
                    for i in range(8)]
            for n in (1, 2, 3, 5, 8):
                y = serve_padded(fwd1, xs[:n], 8, device=dev)
                for i in range(n):
                    if not np.array_equal(y[i].view(np.int32),
                                          solo[i].view(np.int32)):
                        fail(f"padded parity {base}: n={n} row {i} differs "
                             f"from the row served alone")
        if not _build.LAUNCHES["fused_gemm_output"]:
            fail("padded parity ran without K4")
        log(f"padded parity on the card, F(4,3) {base} 9-bit, one layer "
            f"(8, 32, 32, 64) → 64: rows in zero-padded buckets of 8 bit "
            f"for bit the rows served alone, n = 1, 2, 3, 5, 8 "
            f"(launches {dict(_build.LAUNCHES)})")

    # 8. sharded -------------------------------------------------------------
    walls[8] = time.perf_counter()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["sharded"], sharded_launches = sharded_phase(dev)
    report["sharded"]["wall_s"] = time.perf_counter() - t0
    report["sharded_launches"] = sharded_launches
    log(f"phase 8 main-path launches (stage 5 run + sharded serve): "
        f"{sharded_launches}; {report['sharded']['wall_s']:.1f}s in all")

    # 9. lm ----------------------------------------------------------------
    walls[9] = time.perf_counter()
    t0 = time.perf_counter()
    _build.reset_launches()
    report["lm"] = lm_phase(dev, smi)
    report["lm"]["wall_s"] = time.perf_counter() - t0
    report["lm"]["launches"] = dict(_build.LAUNCHES)
    log(f"phase 9 (LM serving) {report['lm']['wall_s']:.1f}s; launches of "
        f"the five kernels (none lies on the LM path): "
        f"{report['lm']['launches']}")

    # 10. train -------------------------------------------------------------
    walls[10] = time.perf_counter()
    t0 = time.perf_counter()
    _build.reset_launches()
    report["train_lm"] = train_phase(dev, smi)
    report["train_lm"]["wall_s"] = time.perf_counter() - t0
    report["train_lm"]["launches"] = dict(_build.LAUNCHES)
    log(f"phase 10 (LM training) {report['train_lm']['wall_s']:.1f}s; "
        f"launches of the five kernels (none lies on the LM path): "
        f"{report['train_lm']['launches']}")

    # 11. sharded lm -------------------------------------------------------
    walls[11] = time.perf_counter()
    _build.reset_launches()
    report["shard_lm"] = lm_shard_phase(dev, smi)
    report["shard_lm"]["wall_s"] = time.perf_counter() - walls[11]
    report["shard_lm"]["launches"] = dict(_build.LAUNCHES)
    log(f"phase 11 (sharded LM) {report['shard_lm']['wall_s']:.1f}s; "
        f"launches of the five kernels (none lies on the LM path): "
        f"{report['shard_lm']['launches']}")
    if any(report["shard_lm"]["launches"].values()):
        fail(f"sharded LM: kernels launched {report['shard_lm']['launches']}")
    # 12. dry run ----------------------------------------------------------
    walls[12] = time.perf_counter()
    _build.reset_launches()
    report["dryrun"] = dryrun_phase(dev, smi)
    report["dryrun"]["launches"] = dict(_build.LAUNCHES)
    log(f"phase 12 (dry run) {time.perf_counter() - walls[12]:.1f}s")
    if any(report["dryrun"]["launches"].values()):
        fail(f"dry run: kernels launched {report['dryrun']['launches']}")
    walls[13] = time.perf_counter()
    report["phase_wall_s"] = {n: walls[n + 1] - walls[n]
                              for n in sorted(walls) if n + 1 in walls}
    log("phase wall seconds: " + ", ".join(
        f"{n}: {v:.1f}" for n, v in report["phase_wall_s"].items()))

    kernels = []
    for k, (src, replaces) in TPU_KERNELS.items():
        r = per[k]
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k] + sharded_launches[k],
            "max_abs_err": errs[k],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"]
            else "operations",
            "library_ms": r["library_ms"] if r["library_ms"] else None})
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
