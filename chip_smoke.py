#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase sharded    # card, build, that phase only
    python3 chip_smoke.py --phase decomposed # card, build, the 256^3 serial
                                             # cuda run, that phase only

Phases, each printed as JSON lines; any failure exits non-zero:

1. card      the card's name and power limit (nvidia-smi) and torch's name;
2. build     the CUDA kernels built from ``src/repro_torch/kernels/csrc``,
             one nvcc per source, all started together;
3. kernels   each hand-written kernel against its plain PyTorch version on
             the card, at its main-path shape (256^3; k = 2 sweeps for
             JACOBI_FUSED), an odd shape and a slot-batched call with
             distinct parameter rows, the farm's 4-slot 256^3 call and
             one rank's block of the decomposed phase, (128, 256, 256)
             serial and with 2 slots, under the tile autotuned for that
             block, each with a planted fault, a zeroed x-low plane
             (timed: the shapes of those paths' launches; JACOBI_FUSED also
             for k = 1..4 and for x extents about its segment length, each
             with a planted fault, a zeroed ghost face, that the check must
             reject); the four stencils must equal their plain versions
             bit for bit at every timed shape (every
             operation of theirs is rounded as written), and each plain
             stencil body on the card must equal the same body on the CPU
             bit for bit on a seeded 64^3 input;
             CUDA-event times of kernel (under the autotuned tile the
             main path launches) and plain version (the kernel's
             with the stream given a head start, so that its own device
             time is read, not its wrapper's host time) beside the least
             time the card could take (bytes over 3.35 TB/s or operations
             over the peak rate of their type, H100 SXM data-sheet peaks);
             FLASH_ATTENTION also with its log-sum-exp on each half of a
             4,096-row cache (``decode_lse_rank_slice``: a model rank's
             block of the sharded serving decode), each half's (out, lse)
             against the plain pair, the halves merged against the whole
             cache's decode, an lse off by log 2 rejected;
4. main      ``api.runtime(n=256, nz=256).run("cavity", steps=20)`` on the
             ``cuda`` backend with the launch counters reset just before,
             then on the ``torch`` backend; the two must agree, and the
             counts must be 20 x (1, 1, 40, 1); step wall time, the
             profiler's device-time split of one step, and peak memory;
5. farm      the ensemble farm at 256^3 through the front door:
             ``api.runtime(n=256, nz=256, n_slots=4)`` takes five cavity
             requests (Re 50..800, 6..14 steps; the fifth enters a
             reclaimed slot), evicts one mid-run, readmits it and drains;
             counts reset just before and read just after must be
             device_steps x (1, 1, 40, 1), every result must equal a
             serial ``cuda`` run bitwise, and the ``torch`` farm must
             agree; batched step time, sims x steps/s and peak memory;
6. durable   the same farm with telemetry (a JSON-lines trace), health,
             ``ckpt_dir`` and the job store on: the eviction spills to
             disk and is read back; results bitwise those of ``farm``,
             the same launch counts, a valid Chrome trace, health drains
             only at harvest boundaries.  Then a sixth request poisoned
             with dt = 50 must end ``diverged`` with a readable flight
             record while the others stay bitwise; then a store-backed
             process (256^3, 2 slots) is SIGKILLed after its first
             snapshot and this process recovers and drains its jobs,
             bitwise an uninterrupted run.  Overheads: the batched step
             with telemetry and health on against off, a health drain, the
             spill (ms, MB/s) and the restore, trace events, peak memory;
   perf      the performance accounting: each stencil under its
             autotuned tile (``core.autotune.tile_for``) against
             ``block_for`` at 256^3, serial and 4-slot, in turns (bitwise,
             and at most 2% slower); the serial run of ``main`` and the
             farm of ``farm`` again with telemetry on, bitwise theirs with
             the same launch counts, and their ``perf_report()`` rows
             (counted FLOPs and HBM bytes, roofline and measured seconds,
             utilization, bottleneck, the bytes by op class; the op-cost
             trace must launch nothing); ``report(perf=True)`` and the
             ``repro_perf_*`` gauges of ``prometheus_text(perf=True)``; and
             the durable farm's ``health_overhead_model`` beside its
             measured on/off cost;
   decomposed  the grid split over ranks that share the card, each a
             process started by ``launch.mesh.spawn`` with gloo (NCCL
             refuses two ranks on one device; the ghost strips go through
             pinned host buffers), ``backend="cuda"``: the main phase's
             256^3 cavity through ``api.runtime(mesh_shape=(2,),
             decomposition=((0, "shard"),))`` on 2 ranks, within 1e-5 of
             the main phase's serial state, 20 x (1, 1, 40, 1) launches on
             each rank and 20 x 20 JACOBI_FUSED with ``fused_sweeps=2``;
             each rank's padded blocks of the serial fields equal the
             serial padded field cut into blocks, bitwise, and a transport
             that swaps the sides' strips is rejected; the farm phase's
             five requests (one evicted and readmitted) through 4 slots on
             4 ranks, (slot 2, shard 2), each result bitwise the serial
             decomposed run of the first shard group; the bytes each rank
             booked a step as the reference's permute operands equal to
             ``halo_bytes_per_step`` (23,592,960; 44,564,480 fused;
             47,185,920 a farm step) and to the count-transport trace, an
             identity of the accounting, and the bytes it sent (strips with
             a receiver): rank 0's those of the trace at index 0, a shard
             line's together one rank's operands; a periodic axis
             exchanged with itself under NCCL at world size 1, bitwise;
             two NCCL ranks on the one card, and the error that ends them
             (recorded); step, exchange and busy times and peak memory
             per rank.  Then the job store on that mesh (its
             ``durable_mesh`` section): a store-backed (slot 2, shard 2)
             farm of 2 slots takes the durable phase's crash requests,
             evicts one once it has stepped (global rank 0, the store's
             one writer, writes its snapshot) and rank 0 SIGKILLs itself;
             the farm launch's ranks first recover those jobs through a
             meshed ``api.runtime(store=...)`` and drain them, each bitwise
             the uninterrupted meshed run with one ``result`` event, while
             the evicted job rerun from its payload with only its step0
             must differ; after the store-less drive they drive the five
             requests again through a store-backed mesh with telemetry,
             health and ``ckpt_dir`` on, the eviction a store snapshot:
             bitwise the store-less results with equal launch counts a
             rank, 5 ``done`` rows, ``load_result`` bitwise, one spill and
             one restore, the same job ids and statuses on every rank, and
             no store file open off rank 0;
   sharded   the LM trained over a mesh of 4 ranks that share the card
             (gloo, collectives through pinned host buffers): zamba2-1.2b
             at its published widths and 8 of 38 layers, seq 2,048,
             global batch 4, ``fsdp_tp`` over (data 2, model 2) (each rank
             16 of 32 heads, its blocks of the parameters and moments,
             its data index's 2 rows) against the single-process CUDA step
             on the same weights and batch (loss within 2e-2, every
             gathered gradient leaf within 5e-2 relative norm error and
             0.99 cosine), each of two planted faults rejected (one
             ``wo`` without its reduce over ``tp``; data-axis gradients
             not divided by |dp|), exactly 8 FLASH_ATTENTION and 16
             SSD_INTRA launches a rank a step; xlstm-125m's ``dp`` step
             over (pod 2, data 2), a row a rank, against the
             single-process step with a microbatch a row, and its int8
             error-feedback twin within 1e-4 (loss) and 5e-3 (params) of
             it, its gradient mean within 5e-2 relative norm error of the
             exact one, its residual carried over 2 steps and error
             feedback's identity at the second step within 1e-4 (the
             step given the residual against the step given none); GPipe
             over pod 4
             at D 2,048 against the sequential stack; the (1, 1) step
             under NCCL bitwise the local step; step, busy, collective
             calls, bytes and host ms, parameter and moment bytes and peak
             memory per rank; at most 180 s.  Then the same ranks serve
             the same zamba2 through ``ServingEngine(slots=4,
             max_seq=4096, shard=make_shard_cfg(mesh, cfg, 4))`` (a rank:
             2 slots and 2,048 positions of each KV cache): prompts of
             400, 1,500, 2,400 and 3,800 tokens, 8 new each,
             teacher-forced on the single-process CUDA engine run before
             the spawn (prefill and decode logits and every cache leaf's
             block within 5e-2 of its scale), the free run's token
             agreement, two planted faults rejected (partials averaged
             without their log-sum-exp weights; the new token written on
             every model rank), exactly 4 FLASH_ATTENTION a prefill
             (tensor-core route) and a decode step (split-K route with its
             log-sum-exp) and 8 SSD_INTRA a prefill, 268,435,456 KV bytes
             a rank; prefill and decode-step ms, collectives a decode
             step, busy share, peak memory; at most 60 s of its own.
             Then, in the same ranks, the sequence-parallel postures: the
             same zamba2 step with ``ssm_sp`` (a rank's Mamba2 blocks on
             its 2 rows x 1,024 tokens) against the same single-process
             step at the same bounds, ``no_halo`` and ``no_relay``
             rejected, 8 / 16 launches a rank a step; and qwen3-moe-235b-
             a22b at its published widths and 1 layer under ``a2a``
             (capacity factor 16: no drops), its drive the first the
             meshed dry run fits four ranks into (the step at seq 2,048 or
             1,024, else the MoE layer alone), held block by block against
             the same run under ``tp`` (and its MoE output rows, and its
             loss against the single-process one), ``return_order``
             rejected, the reckoning beside each rank's measured peak;
             ms, busy, collectives by kind, peak memory; at most 90 s of
             their own;
7. fused     the same farm with ``fused_sweeps=2``: 20 JACOBI_FUSED
             launches a step and no JACOBI_PRESSURE;
8. throughput  n=48 (Ghia's grid), 8 slots, 20 steps: the farm's
             sims x steps/s against eight serial runs;
9. physics   Taylor-Green, cavity divergence and Ghia bounds with the
             kernels, as the reference's tests hold its solver to them;
10. lm       zamba2-1.2b at its published widths (bf16 weights from
             ``init_params`` at seed 0, float32 caches) through
             ``ServingEngine(slots=4, max_seq=4096, backend="cuda")``: eight
             requests of 256..2000 prompt tokens and 32 new tokens each,
             drained, with the launch counters reset just before: 19
             FLASH_ATTENTION (tensor-core route) and 38 SSD_INTRA a prefill,
             19 FLASH_ATTENTION (split-K route) a decode step; prefill ms
             per bucket, decode-step ms, tokens/s, the device's busy share
             of a decode step (and FLASH_ATTENTION's part) and peak memory;
             then
             one prompt prefilled and decoded 4 steps teacher-forced on the
             ``cuda`` and the ``torch`` backends, whose logits must agree,
             and once more with a planted attention fault (every launch
             given 64 keys too few), which the check must reject.
11. train    zamba2-1.2b trained through ``train.step.make_train_step``
             and ``data.pipeline.PackedLMDataset``, FLASH_ATTENTION and
             SSD_INTRA forward under their autograd Functions (the
             plain versions' gradient backward).  (a) Gradient parity at
             the published widths, 4 layers (2 shared-block applications),
             2048 tokens: one loss + backward on the CUDA and the TORCH
             template from the same weights and batch; losses within 2e-2,
             every leaf's gradient within 5e-2 relative norm error and
             0.99 cosine, none zero where TORCH's is not; and a planted
             backward that drops q's gradient, which the check must reject.
             (b) All 38 layers, bf16, remat ``block``, 4096 tokens (train_4k),
             micro-batch 1 and 2 microbatches a step (a global batch of 2,
             cut from 256): one warm-up step, then 4 timed steps with the
             counters reset just before: exactly 2 x 19 x 2 FLASH_ATTENTION
             and 2 x 38 x 2 SSD_INTRA launches a step (remat runs each
             forward twice); finite losses, step ms, tokens/s, MFU, peak
             memory, the device's busy share of a profiled step, and the
             plain backward's time a region at these shapes.
12. moe      qwen3-moe-235b-a22b (4 of 94 layers) and kimi-k2-1t-a32b (1
             of 61) at their published widths (bf16 weights from
             ``init_params`` at seed 0, float32 caches), one after the
             other, through ``ServingEngine(slots=4, max_seq=4096,
             backend="cuda")``: 6 and 4 requests of 200..1500 prompt
             tokens and 16 new tokens each, drained, with the launch
             counters reset just before: exactly ``layers`` FLASH_ATTENTION
             launches a prefill (tensor-core route) and a decode step
             (split-K route; kimi's head dim is 112), no SSD_INTRA; the
             summed dropped fraction of each prefill; prefill ms per
             bucket, decode-step ms, tokens/s, the device's busy share of
             a decode step and the expert FFN's part of it (and alone, at
             the decode's buffer, beside its weights' bytes bound), init
             time and peak memory; two prefills of one prompt bitwise
             equal; then a 1,000-token prompt and 4 decode steps
             teacher-forced (the tokens, and each layer's input) on the
             ``cuda`` and ``torch`` templates: at least 0.98 of the
             (layer, token) top-k sets equal and the logits within 5e-2
             relative L2, and the planted attention fault rejected; the
             free-running runs reported beside (cuda against torch, and
             two plain versions against each other).
13. ssm      xlstm-125m at its published widths and depth (12 layers,
             sLSTM at 5 and 11; bf16 weights from ``init_params`` at seed
             0) through ``ServingEngine(slots=4, max_seq=4096,
             backend="cuda")``, the lm phase's eight requests, drained,
             with the launch counters reset just before: exactly 10
             SSD_INTRA launches a prefill (one a mLSTM layer, at G 4, R 1,
             N 384, P 385) and none a decode step, no FLASH_ATTENTION;
             prefill ms per bucket and the host time of its two sLSTM
             loops, decode-step ms, tokens/s, the device's busy share of a
             decode step, peak memory; two prefills of one prompt bitwise
             equal; then the lm phase's first prompt and 4 decode steps
             teacher-forced (the tokens, and each block's input) on the
             ``cuda`` and ``torch`` templates: each token row of every
             block's output and of every mLSTM layer's SSD output, and the
             logits, within 5e-2 relative L2, and the same run with one
             mLSTM layer's s_in zeroed rejected; the free-running runs
             (logits, greedy tokens) reported beside.
14. multimodal  FLASH_ATTENTION at the phase's shapes first (paligemma's
             1,024-row prefill with its 256-token prefix and 4-slot decode,
             head dim 256 over one kv head; the CUDA-core route at head dim
             256; musicgen's 1,500-frame prefill), each against its plain
             version with a planted fault, its lines joining the kernel
             summary.  Then paligemma-3b (18 layers, 8 heads of 256 over 1)
             and musicgen-large (48 layers, 32 heads of 64) at their
             published widths and depths (bf16 weights from ``init_params``
             at seed 0, float32 caches), one after the other, through
             ``ServingEngine(slots=4, max_seq=4096, backend="cuda")``: 6
             token prompts of 200..1500 tokens and 16 new tokens each,
             drained, with the launch counters reset just before: exactly
             ``layers`` FLASH_ATTENTION launches a prefill (tensor-core
             route) and a decode step (split-K route); prefill ms per
             bucket, decode-step ms, tokens/s, the device's busy share of a
             decode step, init and serving peak memory.  Then each arch's
             stub embeddings (``models.multimodal``) through
             ``model.prefill`` and 8 decode steps with the counters reset:
             paligemma's 256 patch embeddings before 768 text tokens (a
             1,024-row prefill, ``prefix_len`` 256), musicgen's 1,500 frame
             embeddings; the same launch counts and routes, the prefill
             timed and run twice (bitwise equal), and the CUDA template
             against TORCH teacher-forced in tokens and each block's input:
             the logits, each token row of every block's output and each
             (token, head) row of every attention output within 5e-2
             relative L2; a planted 64-key fault and, for paligemma, the
             prefill run causal only (``prefix_len`` 0) rejected, the
             latter by the prefix rows' attention outputs.
15. train   the ssm, vlm, audio and moe families trained as phase 11
             trains zamba2, one after the other, each printing a ``train``
             line with its ``arch``: (a) gradient parity of the CUDA template
             against TORCH (losses within 2e-2, every leaf within 5e-2
             relative norm error and 0.99 cosine; an sLSTM's ``bi``, whose
             gradient is zero in exact arithmetic, within 5e-2 of the
             largest leaf's norm) with a planted fault rejected by name:
             xlstm-125m whole at 1,024 tokens, with an SSD_INTRA backward
             that drops c_'s gradient (every mLSTM layer's wq must read
             zero); paligemma-3b at 4 of 18 layers (256 patch embeddings
             before 768 text tokens) and musicgen-large at 4 of 48 (1,500
             frame embeddings), with the zero-dq attention backward (every
             layer's wq zero); qwen3-moe-235b-a22b at 1 of 94 layers and
             1,024 tokens, TORCH first with each ``moe._route`` call's
             top-k ids recorded and the CUDA runs taking them in order
             (the remat recompute's calls included; the gates the
             router's own probabilities at them), the zero-dq fault caught
             on ``stack.layers.0.attn.wq``, and a free CUDA run's top-k
             agreement and gradients reported beside.  (b) Published
             widths, bf16, 4,096 tokens (paligemma after its 256 patch
             embeddings), micro-batch 1, AdamW's moments in
             ``launch.dryrun.train_plan``'s dtype (bf16 for qwen3-moe,
             float32 for the rest); full depth but qwen3-moe's 1 of 94
             layers; xlstm-125m one microbatch a step (no remat: exactly 10
             SSD_INTRA launches a step), paligemma-3b, musicgen-large and
             qwen3-moe two (remat ``block``: exactly 2 x 18 x 2, 2 x 48 x 2
             and 2 x 1 x 2 FLASH_ATTENTION launches a step, all on the
             tensor-core route); first the drive's exact configuration
             reckoned by ``launch.dryrun`` (it must fit the card), then one
             warm-up step, then 2 timed steps with the counters reset just
             before: finite losses, step ms, tokens/s, MFU, peak memory
             beside the dry run's argument and peak bytes (the argument
             bytes at most the measured peak, argument + peak within 25%
             of it; phase 11's
             zamba2 drive is reckoned the same way), the device's busy
             share of a profiled step, the plain backward's time a region
             at these shapes, and for xlstm the forward sLSTM loops' wall
             time within one more step.  Last a ``dryrun`` line: kimi-k2
             train_4k at 1 of 61 layers reckoned, which must not fit.

The kernel phase also holds FLASH_ATTENTION (the zamba2 prefill and decode
shapes and its 4096-token training forward, llama3-8b's GQA widths at
prefill and decode, qwen3-moe's GQA 16:1 and kimi-k2's head dim 112 at
prefill and decode and on the CUDA-core route, an odd shape with
``prefix_len`` and ``q_offset``, blind rows and valid lengths about a
split on the bf16 routes, a bf16-q float32-k/v prefill on the CUDA-core
route, paligemma-3b's training forward (4,352 rows, the 256-row
prefix, head dim 256 over one kv head) and qwen3-moe's (4,096 rows, 64
query heads over 4 kv heads of 128): every route of
``attention_cuda.route`` is launched and checked per query row, and a
planted fault of 64 missing keys must fail the same
check) and SSD_INTRA (the zamba2 prefills of 512, 1024 and 2048 tokens,
its 4096-token training forward (32 chunks) and an odd shape; the
xlstm-125m prefills of 512, 1024 and 2048 tokens and its 4096-token
training forward (32 chunks) on mLSTM-like inputs, N 200 / P 129 / L 48
and N 129 / P 385; each with a planted fault, one head's s_in zeroed)
against their plain versions, beside ``scaled_dot_product_attention``'s
time on the same inputs (``is_causal`` for a plain causal mask, else the
boolean mask; a yardstick only, the port never calls it).

The line before the last is the ``{"kernels": [...]}`` summary
(FLASH_ATTENTION's entry carries its prefill, decode, llama3 GQA,
training, moe and multimodal (head dim 256) cases side by side under
``cases`` and its head dims under ``head_dims``, the stencils and
JACOBI_FUSED their serial and farm calls, SSD_INTRA its three zamba2 and
three xlstm prefill lengths and both training shapes; ``launches_by_path``
includes the train, moe, ssm and multimodal phases' and each training
drive of phase 15); the last line is
``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the rest of the repository beside it,
the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N = 256                      # the main path's grid: N x N x N cells
STEPS = 20
SEED = 0
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_OPS_PER_S = 67e12        # H100 SXM data sheet, float32 outside tensor cores
BF16_OPS_PER_S = 989e12      # H100 SXM data sheet, dense bf16 tensor cores
TF32_OPS_PER_S = 495e12      # H100 SXM data sheet, dense TF32 tensor cores
SLEEP_CYCLES_PER_S = 1.98e9  # H100 SXM boost clock: a lower clock sleeps longer
# max|kernel - plain| <= KERNEL_RTOL * max(1, max|plain|): both compute the
# same float32 expression, a few ulp of the largest term where the order of
# operations differs (the stencils round every operation in the plain
# body's order and are held bitwise besides)
KERNEL_RTOL = 1e-5
# cuda vs torch backend after STEPS steps: per-step ulp differences stay
# bounded because the Jacobi iteration is contractive
PATH_RTOL = 1e-4

STENCILS = ("UPDATE_VELOCITY", "DIVERGENCE", "JACOBI_PRESSURE",
            "PROJECT_VELOCITY")
LM_KERNELS = ("FLASH_ATTENTION", "SSD_INTRA")
KERNELS = STENCILS + ("JACOBI_FUSED",) + LM_KERNELS
# launches a step: jacobi_iters = 40 sweeps, one by one or k = 2 at a time
PER_STEP = {"UPDATE_VELOCITY": 1, "DIVERGENCE": 1, "JACOBI_PRESSURE": 40,
            "PROJECT_VELOCITY": 1, "JACOBI_FUSED": 0, "FLASH_ATTENTION": 0,
            "SSD_INTRA": 0}
PER_STEP_FUSED = dict(PER_STEP, JACOBI_PRESSURE=0, JACOBI_FUSED=20)
FUSED_K = 2
REPLACES = {
    "UPDATE_VELOCITY": "src/repro/core/generator.py:213",
    "DIVERGENCE": "src/repro/core/generator.py:213",
    "JACOBI_PRESSURE": "src/repro/core/generator.py:213",
    "PROJECT_VELOCITY": "src/repro/core/generator.py:213",
    "JACOBI_FUSED": "src/repro/kernels/jacobi.py:79",
    "FLASH_ATTENTION": "src/repro/kernels/attention.py:61",
    "SSD_INTRA": "src/repro/kernels/ssd.py:70",
}
INSTANCE = {   # the 3DBLOCK template's instances, by body
    "UPDATE_VELOCITY": "src/repro/kernels/stencil3d.py:74",
    "DIVERGENCE": "src/repro/kernels/stencil3d.py:148",
    "JACOBI_PRESSURE": "src/repro/kernels/stencil3d.py:159",
    "PROJECT_VELOCITY": "src/repro/kernels/stencil3d.py:171",
    "JACOBI_FUSED": "src/repro/kernels/jacobi.py:56 (jacobi_fused)",
    "FLASH_ATTENTION": "src/repro/models/attention.py:52 and :100 "
                       "(__kernel__attention regions)",
    "SSD_INTRA": "src/repro/models/mamba2.py:150 (__kernel__ssd region)",
}
SOURCE = {name: "src/repro_torch/kernels/csrc/stencil3d.cu" for name in STENCILS}
SOURCE["JACOBI_FUSED"] = "src/repro_torch/kernels/csrc/jacobi.cu"
SOURCE["FLASH_ATTENTION"] = "src/repro_torch/kernels/csrc/attention.cu"
SOURCE["SSD_INTRA"] = "src/repro_torch/kernels/csrc/ssd.cu"

# the farm phases: five requests through four slots, one evicted after
# EVICT_AT steps and readmitted
FARM_SLOTS = 4
# one rank's block in the decomposed phase (256^3 split in two on x) and
# the slots a rank holds in its slots x shards farm (4 slots over 2)
DECOMP_LOCAL = (N // 2, N, N)
DECOMP_FARM_SLOTS = FARM_SLOTS // 2
FARM_RES = (50.0, 100.0, 200.0, 400.0, 800.0)
FARM_STEPS = (8, 12, 6, 10, 14)
EVICT, EVICT_AT = 1, 4
# the perf phase: a stencil under its autotuned tile may take at most this
# share of its time under block_for (both in the same run)
TILE_SLOWER_MAX = 1.02
# the durable phase: the farm's requests plus one poisoned with a time step
# far past the CFL limit; the crash run's store-backed process (2 slots,
# CRASH_STEPS a request), killed after its first snapshot
POISON_DT = 50.0
CRASH_RES, CRASH_STEPS = (80.0, 160.0, 240.0), 6
DURABLE_DIR = os.path.join(ROOT, "build", "durable")
# the host-bound end: Ghia's n=48 grid, eight slots, twenty steps
TP_N, TP_SLOTS, TP_STEPS = 48, 8, 20

# the LM serving path: zamba2-1.2b at published widths
LM_ARCH = "zamba2-1.2b"
LM_SLOTS, LM_MAX_SEQ, LM_REQUESTS, LM_NEW = 4, 4096, 8, 32
LM_PROMPT = (256, 2000)          # prompt lengths drawn in [lo, hi]
LM_PARITY_STEPS = 4
# cuda vs torch backend logits, relative to max|logits|: both compute in
# bf16 (8 significant bits); they differ only in the float32 summation
# order inside the two kernels, which can flip the bf16 rounding of an
# activation by one ulp (2^-8 relative).  Such flips enter the residual
# stream at each of the 38 Mamba layers and 19 attention applications and
# grow through the layers, so the logits may differ by a few percent of
# their scale; an error in a kernel (a wrong mask, a lost head, a wrong
# decay) moves them by their full scale.
LM_PARITY_RTOL = 5e-2
# FLASH_ATTENTION kernel vs plain, held per query row (one head's D
# values): |kernel - plain| <= ATTN_RTOL * max|plain row| + ATTN_ATOL.  bf16
# output: both round a float32 result to bf16, and a sum taken in another
# order may round to the neighbouring bf16 value, at most one bf16 ulp of
# the row's largest value (2^-7 relative).  float32 output: 2e-5 relative.
# The floor covers the float32 summation error itself, about 1e-7 of
# sum_j p_j |v_j| (~1) over up to 4096 terms.  A per-row limit matters
# because row scales differ tenfold: early causal rows average a few v rows
# (|out| ~ 3), long rows thousands (|out| ~ 0.03-0.1).
ATTN_RTOL = {"bfloat16": 2.0 ** -7, "float32": 2e-5}
ATTN_ATOL = 1e-5
# the planted fault each check must reject: the kernel alone given a valid
# key length 64 short (one 64-key tile dropped)
ATTN_FAULT_KEYS = 64
# SSD_INTRA kernel vs plain, float32: the decay exponents are differences
# of cumulative sums of up to 128 terms taken in another order
SSD_RTOL = 1e-4

# the training path: zamba2-1.2b at its published widths (bf16, block
# remat), train_4k's sequence (configs/shapes.py), micro-batch 1 and two
# microbatches a step: a global batch of 2, cut from train_4k's 256 to fit
# the run's time; one warm-up step, then TRAIN_STEPS timed
TRAIN_SEQ, TRAIN_MICRO, TRAIN_ACCUM = 4096, 1, 2
TRAIN_STEPS, TRAIN_LR = 4, 3e-4
# gradient parity: zamba2's widths at 4 Mamba layers (2 applications of the
# shared block), 2048 tokens, batch 1, one loss + backward on the CUDA and
# on the TORCH template.  Both compute in bf16 and differ in the kernels'
# float32 summation order, which can flip an activation's bf16 rounding by
# one ulp (2^-8); such flips pass through 4 layers into the loss (2e-2
# relative) and each gradient (relative norm error 5e-2, cosine 0.99).  A
# lost gradient (a region autograd cannot see through, a dropped head)
# zeroes a leaf or moves it by its full norm.
TRAIN_PARITY_LAYERS, TRAIN_PARITY_SEQ = 4, 2048
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL, TRAIN_GRAD_COS = 2e-2, 5e-2, 0.99

# the moe serving path: each config at its published widths, depth cut to
# fit one card (qwen3-moe: 4 of 94 layers, 22.4 GB of bf16 weights;
# kimi-k2: 1 of 61, 38.8 GB), served by 4 slots: (arch, layers, requests)
MOE_ARCHS = (("qwen3-moe-235b-a22b", 4, 6), ("kimi-k2-1t-a32b", 1, 4))
MOE_PROMPT, MOE_NEW = (200, 1500), 16
MOE_PARITY_PLEN = 1000
# CUDA vs TORCH templates, teacher-forced through a 1,000-token prefill and
# 4 decode steps from the same weights (tokens, and each layer's input:
# moe_parity).  The two differ in attention's bf16 rounding (one ulp of an
# activation, 2^-8), and routing is discrete: a token whose 8th and 9th
# expert are that close flips one expert, so the check is on the top-k
# sets (at least MOE_TOPK_AGREE of the (layer, token) sets equal) and on
# the logits' relative L2 error (at most MOE_LOGIT_REL: a flipped expert
# carries the smallest of 8 gates).  A lost key tile moves the last rows'
# attention, and with it their experts and logits, by far more.
MOE_TOPK_AGREE, MOE_LOGIT_REL = 0.98, 5e-2

# the ssm serving path: xlstm-125m at its published widths and depth (12
# layers: sLSTM at 5 and 11, mLSTM elsewhere), through the lm phase's
# engine and drive (LM_SLOTS, LM_MAX_SEQ, LM_REQUESTS, LM_PROMPT, LM_NEW)
SSM_ARCH = "xlstm-125m"

# the multimodal serving path: paligemma-3b (vlm) and musicgen-large (audio)
# at their published widths and depths, one after the other, through the
# moe phase's drive (MM_REQUESTS requests of MOE_PROMPT tokens, MOE_NEW new
# tokens each); then each arch's stub embeddings through model.prefill and
# MM_STEPS decode steps: paligemma's 256 patch embeddings before MM_TEXT
# text tokens, musicgen's MM_FRAMES frame embeddings (30 s at EnCodec's
# 50 Hz).  The parity check holds the CUDA template to the TORCH template
# at LM_PARITY_RTOL, teacher-forced in tokens and in each block's input.
MM_ARCHS = ("paligemma-3b", "musicgen-large")
MM_REQUESTS, MM_TEXT, MM_FRAMES, MM_STEPS = 6, 768, 1500, 8
# FLASH_ATTENTION at the phase's shapes: paligemma's prefill (8 query heads
# of 256 over one kv head, the 256-token bidirectional prefix) and 4-slot
# decode over the 4,096-row float32 cache, the CUDA-core route at head dim
# 256, and musicgen's 1,500-frame prefill (32 heads of 64), a sequence
# length no other case runs
MM_ATTN_CASES = [
    ("prefill_paligemma_d256", 1, 1024, 1024, 8, 1, 256, "bfloat16",
     "bfloat16", (True, 0, 256), None),
    ("decode_paligemma_d256", 4, 1, LM_MAX_SEQ, 8, 1, 256, "bfloat16",
     "float32", (False, 0, 0), (37, 1024, 2047, 4000)),
    ("cuda_core_d256", 1, 256, 256, 8, 1, 256, "float32", "float32",
     (True, 0, 0), None),
    ("prefill_musicgen", 1, MM_FRAMES, MM_FRAMES, 32, 32, 64, "bfloat16",
     "bfloat16", (True, 0, 0), None),
]

# the ssm, vlm and audio families' training drives (phase 15), each at its
# published widths and depth, bf16: (arch, layers of the gradient-parity
# run (None: all), its positions, microbatches a step).  Parity: xlstm-125m
# whole at 1,024 tokens; paligemma-3b at 4 of 18 layers, its 256 patch
# embeddings before 768 text tokens; musicgen-large at 4 of 48 layers,
# MM_FRAMES frame embeddings.  Steps at train_4k's 4,096 tokens (paligemma:
# after its 256 patch embeddings), micro-batch TRAIN_MICRO, one warm-up
# step then TRAIN_FAMILY_STEPS timed.
TRAIN_FAMILIES = (("xlstm-125m", None, 1024, 1),
                  ("paligemma-3b", 4, MM_TEXT, 2),
                  ("musicgen-large", 4, MM_FRAMES, 2),
                  ("qwen3-moe-235b-a22b", 1, 1024, 2))
TRAIN_FAMILY_STEPS = 2
# depth cut to fit one card, for the parity run and the steps alike:
# qwen3-moe trains 1 of its 94 layers (3.73 G parameters; two layers, 6.2 G,
# would not fit: launch.dryrun reckons each drive before it runs).  Its
# parity run takes TORCH's expert choices (forced_routing): routing is
# discrete, so a CUDA and a TORCH run that pick another expert for one
# token disagree on that expert's whole gradient.
TRAIN_DEPTH = {"qwen3-moe-235b-a22b": 1}
# each training drive's dry run (launch.dryrun at its exact configuration)
# against its measured max_memory_allocated: the argument bytes (weights,
# AdamW state, batch) at most the measurement, argument + peak within
# DRYRUN_MEMORY_RTOL of it (the allocator rounds blocks up and keeps a few
# small tensors the trace does not see, e.g. the data pipeline's)
DRYRUN_MEMORY_RTOL = 0.25
# the moe family's other config, reckoned and not run: kimi-k2 train_4k at
# one of 61 layers does not fit one card (sharded training over a mesh of
# cards waits for a machine with several)
KIMI_DRYRUN = ("kimi-k2-1t-a32b", 1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _wrappers():
    from repro_torch.kernels import (
        attention_cuda, jacobi_cuda, ssd_cuda, stencil3d_cuda,
    )

    return stencil3d_cuda, jacobi_cuda, attention_cuda, ssd_cuda


def reset_counts() -> None:
    for w in _wrappers():
        w.reset_launches()


def read_counts() -> dict:
    return {k: v for w in _wrappers() for k, v in w.LAUNCHES.items()}


def cuda_ms(fn, reps: int, warmup: int = 2, head_start: bool = False) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls, CUDA events.

    Without ``head_start`` a call whose host side (checks, allocations, the
    launch) takes longer than its kernels is timed at the host's pace.  With
    it, the stream first sleeps for twice the host's time to enqueue the
    calls (measured on one more call), so the host is ahead and the events
    bracket only device work: a kernel's own time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 0
    if head_start:
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        cycles = int((2 * reps * host_s + 1e-3) * SLEEP_CYCLES_PER_S)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if cycles:
        torch.cuda._sleep(cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    card = {"phase": "card", "nvidia_smi": smi,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(card)
    require(tuple(card["capability"]) == (9, 0),
            f"sm_90a kernels need a Hopper card, got {card['capability']}")
    return smi


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()          # one nvcc per source, all at once
    for w in _wrappers():
        w._lib()
    libs = {}
    for name, info in _build.build_info.items():
        libs[name] = {
            "nvcc_seconds": info["seconds"], "cached": info["cached"],
            "library": os.path.relpath(info["path"], ROOT),
            "ptxas": [ln.strip() for ln in info["log"].splitlines()
                      if "registers" in ln or "spill" in ln
                      or "Compiling entry" in ln or "smem" in ln]}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": libs})


# ---------------------------------------------------------------------------
def kernel_inputs(name, S, interior, gen, dev):
    """Random inputs of ``name`` padded as its descriptor declares."""
    import torch
    from repro_torch.kernels import stencil3d

    desc = stencil3d.DESCRIPTORS[name]
    batch = () if S is None else (S,)
    xs = []
    for var in desc.inputs:
        cached = var in desc.cached_inputs
        shape = tuple(n + ((lo + hi) if cached else 0) for n, lo, hi in
                      zip(interior, desc.halo_lo, desc.halo_hi))
        xs.append(torch.rand(batch + shape, generator=gen, device=dev) * 2 - 1)
    return xs


def param_rows(name, cfgs, dev):
    """(S, n_params) table from a list of CFDConfigs (one row each), built
    as the CUDA template builds it, with forcing set so that every
    parameter column is exercised."""
    import torch
    from repro_torch.core.generator import param_table
    from repro_torch.kernels import stencil3d

    desc = stencil3d.DESCRIPTORS[name]
    rows = []
    for s, c in enumerate(cfgs):
        vals = dict(dt=c.dt, h=c.h, nu=c.nu, omega=c.jacobi_omega,
                    fx=0.1 * (s + 1), fy=-0.05 * (s + 1), fz=0.02 * (s + 1))
        rows.append(param_table(desc, vals, None, dev,
                                columns=stencil3d.TABLES[name])[0])
    return torch.stack(rows)


def compare(name, inputs, table, tile=None, want_inputs=None):
    """The kernel on ``inputs`` (at ``tile``, else its default) against
    the plain version on ``want_inputs`` (default: the same inputs)."""
    import torch
    from repro_torch.kernels import stencil3d_cuda as sc

    got = sc.KERNELS[name](*inputs, table, tile=tile)
    want = sc.PLAIN[name](*(inputs if want_inputs is None else want_inputs),
                          table)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    tol = KERNEL_RTOL * max(1.0, scale)
    bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
    return err, tol, finite, bitwise, got


def plain_card_vs_cpu(name, dev):
    """The plain body on the card and on the CPU, one seeded 64^3 input of
    two slots: bit for bit the same (no division by a Python number
    becomes a reciprocal multiply on the card)."""
    import torch
    from repro_torch.cfd import cavity
    from repro_torch.kernels import stencil3d_cuda as sc

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    inputs = kernel_inputs(name, 2, (64, 64, 64), gen, dev)
    table = param_rows(name, [cavity.config(64, nz=64, re=re)
                              for re in (100.0, 400.0)], dev)
    card = sc.PLAIN[name](*inputs, table)
    cpu = sc.PLAIN[name](*(t.cpu() for t in inputs), table.cpu())
    card = card if isinstance(card, tuple) else (card,)
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
    emit({"phase": "kernel", "kernel": name, "case": "plain_card_vs_cpu",
          "interior": [64, 64, 64], "slots": 2, "bitwise": same,
          "max_abs_diff": max(float((a.cpu() - b).abs().max())
                              for a, b in zip(card, cpu))})
    require(same, f"{name}: the plain body on the card differs from the CPU")


def phase_kernels(dev):
    import torch
    from repro_torch.cfd import cavity
    from repro_torch.core import autotune
    from repro_torch.kernels import stencil3d, stencil3d_cuda as sc
    from repro_torch.launch import op_cost

    gen = torch.Generator(device=dev).manual_seed(SEED)
    main_cfg = cavity.config(N, nz=N)
    odd_cfgs = [cavity.config(5, nz=3)]
    batch_cfgs = [cavity.config(24, nz=18, re=re) for re in (50.0, 100.0, 400.0)]
    farm_cfgs = [cavity.config(N, nz=N, re=re) for re in FARM_RES[:FARM_SLOTS]]
    cases = [("main", None, (N, N, N), [main_cfg]),
             ("odd", None, (5, 7, 3), odd_cfgs),
             ("batched", 3, (24, 20, 18), batch_cfgs),
             # the farm's launch: four 256^3 slots (inputs from a generator
             # of their own, so that the other cases' inputs stay as they
             # were)
             ("farm", FARM_SLOTS, (N, N, N), farm_cfgs),
             # the decomposed phase's launches on one rank's block: 256^3
             # split in two on x, serial and the slots x shards farm's
             # 2 resident slots (the tile resolved at that local interior)
             ("decomposed", None, DECOMP_LOCAL, [main_cfg]),
             ("decomposed_farm", DECOMP_FARM_SLOTS, DECOMP_LOCAL,
              farm_cfgs[:DECOMP_FARM_SLOTS])]
    timed = ("main", "farm", "decomposed", "decomposed_farm")
    # the farm's and the decomposed cases' inputs come from generators of
    # their own, so that the other cases' inputs stay as they were
    farm_gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    decomp_gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    gens = {"farm": farm_gen, "decomposed": decomp_gen,
            "decomposed_farm": decomp_gen}
    results = {}
    for name in stencil3d.DESCRIPTORS:
        res = {"max_abs_err": 0.0, "cases": {}}
        for case, S, interior, cfgs in cases:
            inputs = kernel_inputs(name, S, interior, gens.get(case, gen),
                                   dev)
            table = param_rows(name, cfgs, dev)
            if S is None:
                table = table[0]
            decomposed = case.startswith("decomposed")
            # the path's launch: the tile autotuned for this interior
            tile = autotune.tile_for(stencil3d.DESCRIPTORS[name],
                                     interior).tile
            err, tol, finite, bitwise, outs = compare(
                name, inputs, table, tile if decomposed else None)
            line = {"phase": "kernel", "kernel": name, "case": case,
                    "slots": S or 1, "interior": list(interior),
                    "max_abs_diff": err, "tolerance": tol, "finite": finite,
                    "bitwise": bitwise}
            if decomposed:
                # the planted fault: the kernel alone given its first input
                # with the x-low plane zeroed must fail the comparison
                bad = [inputs[0].clone(), *inputs[1:]]
                bad[0][..., :1, :, :] = 0.0
                fault, _, _, fault_bitwise, _ = compare(name, bad, table, tile,
                                                        want_inputs=inputs)
                del bad
                line.update(planted_fault_max_abs_diff=fault)
                require(not fault_bitwise and fault > tol,
                        f"{name} ({case}): the check passed a zeroed x-low "
                        f"plane ({fault} <= {tol})")
            if case in timed:
                nbytes, ops = op_cost.stencil_cost(name, inputs, outs, table)
                kern = sc.KERNELS[name]
                plain = sc.PLAIN[name]
                line.update(
                    tile=list(tile),
                    kernel_ms=cuda_ms(lambda: kern(*inputs, table, tile=tile),
                                      reps=50, head_start=True),
                    plain_ms=cuda_ms(lambda: plain(*inputs, table), reps=5,
                                     warmup=1),
                    **bound(nbytes, ops, F32_OPS_PER_S), library_ms=None)
                res["cases"][case] = {k: line[k] for k in
                                      ("tile", "kernel_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")}
                if case == "main":
                    res.update({k: v for k, v in res["cases"][case].items()
                                if k != "tile"})
            emit(line)
            require(finite, f"{name} ({case}): non-finite output")
            require(err <= tol, f"{name} ({case}): max|kernel - plain| "
                                f"{err} > {tol}")
            if case in timed:
                require(bitwise, f"{name} ({case}): kernel and plain version "
                                 f"differ (max {err}), not bitwise")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            del inputs, outs
        results[name] = res
        plain_card_vs_cpu(name, dev)
    results["JACOBI_FUSED"] = jacobi_fused_cases(gen, dev)
    results["FLASH_ATTENTION"] = attention_cases(gen, dev)
    lse = attention_lse_case(torch.Generator(device=dev).manual_seed(SEED + 5),
                             dev)
    attn = results["FLASH_ATTENTION"]
    attn["cases"][LSE_CASE] = lse["case"]
    attn["max_abs_err"] = max(attn["max_abs_err"], lse["err"])
    results["SSD_INTRA"] = ssd_cases(gen, dev)
    torch.cuda.empty_cache()
    return results


def jacobi_fused_cases(gen, dev):
    """JACOBI_FUSED against ``jacobi_fused_ref`` on the card: the 256^3
    serial call (k = 2, timed), the fused farm's 4-slot call (timed), one
    rank's block of the decomposed phase, serial and at the slots x shards
    farm's 2 resident slots (timed), an odd
    shape, k = 1..4, x extents about the kernel's segment and a slot batch
    of three; and for each, a planted fault the check must reject (the
    kernel alone given p with its x-low ghost face of k planes zeroed)."""
    import torch
    from repro_torch.kernels import jacobi_cuda as jc
    from repro_torch.launch import op_cost

    h, omega = 1.0 / N, 1.0                   # the solver's h and omega
    seg = jc.SEGMENT
    cases = [("main", None, (N, N, N), FUSED_K),
             ("farm", FARM_SLOTS, (N, N, N), FUSED_K),
             ("decomposed", None, DECOMP_LOCAL, FUSED_K),
             ("decomposed_farm", DECOMP_FARM_SLOTS, DECOMP_LOCAL, FUSED_K),
             ("odd", None, (5, 7, 3), FUSED_K),
             *((f"k{k}", None, (37, 20, 45), k) for k in (1, 2, 3, 4)),
             *((f"x{nx}", None, (nx, 17, 33), FUSED_K)
               for nx in (1, seg - 1, seg, seg + 1)),
             ("batched", 3, (24, 20, 18), FUSED_K)]
    # the decomposed cases draw from a generator of their own, so that the
    # other cases' inputs stay as they were
    decomp_gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    res = {"max_abs_err": 0.0, "cases": {}}
    for case, S, interior, k in cases:
        batch = () if S is None else (S,)
        shape = batch + tuple(n + 2 * k for n in interior)
        g = decomp_gen if case.startswith("decomposed") else gen
        p = torch.rand(shape, generator=g, device=dev) * 2 - 1
        rhs = torch.rand(shape, generator=g, device=dev) * 2 - 1
        got = jc.jacobi_fused(p, rhs, h=h, omega=omega, sweeps=k)
        want = jc.jacobi_fused_plain(p, rhs, h=h, omega=omega, sweeps=k)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = KERNEL_RTOL * max(1.0, float(want.abs().max()))
        finite = bool(torch.isfinite(got).all())
        bad = p.clone()
        bad[..., :k, :, :] = 0.0
        fault = float((jc.jacobi_fused(bad, rhs, h=h, omega=omega, sweeps=k)
                       - want).abs().max())
        del bad
        line = {"phase": "kernel", "kernel": "JACOBI_FUSED", "case": case,
                "slots": S or 1, "interior": list(interior), "sweeps": k,
                "max_abs_diff": err, "tolerance": tol, "finite": finite,
                "planted_fault_max_abs_diff": fault}
        if case in ("main", "farm", "decomposed", "decomposed_farm"):
            nbytes, ops = op_cost.jacobi_fused_cost(p, rhs, got, k)
            line.update(
                kernel_ms=cuda_ms(lambda: jc.jacobi_fused(
                    p, rhs, h=h, omega=omega, sweeps=k), reps=50,
                    head_start=True),
                plain_ms=cuda_ms(lambda: jc.jacobi_fused_plain(
                    p, rhs, h=h, omega=omega, sweeps=k), reps=5, warmup=1),
                **bound(nbytes, ops, F32_OPS_PER_S), library_ms=None,
                blocks_per_sm=jc.blocks_per_sm(k), segment=seg)
            res["cases"][case] = {key: line[key] for key in
                                  ("slots", "kernel_ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
            if case == "main":
                res.update({key: line[key] for key in
                            ("kernel_ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")})
        emit(line)
        require(finite, f"JACOBI_FUSED ({case}): non-finite output")
        require(tuple(got.shape) == batch + interior,
                f"JACOBI_FUSED ({case}): shape {tuple(got.shape)}")
        require(err <= tol, f"JACOBI_FUSED ({case}): max|kernel - plain| "
                            f"{err} > {tol}")
        require(fault > tol, f"JACOBI_FUSED ({case}): the check passed a "
                             f"zeroed ghost face ({fault} <= {tol})")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        del p, rhs, got, want
    return res


def bound(nbytes: float, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak rate for their type, whichever is larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# FLASH_ATTENTION cases: (B, Sq, Sk, H, KH, D, q dtype, kv dtype,
# (causal, q_offset, prefix_len), valid lengths or None); the route each
# takes follows from (q dtype, kv dtype, Sq): attention_cuda.route
ATTN_CASES = [
    ("prefill", 1, 1024, 1024, 32, 32, 64, "bfloat16", "bfloat16",
     (True, 0, 0), None),
    ("decode", 4, 1, LM_MAX_SEQ, 32, 32, 64, "bfloat16", "float32",
     (False, 0, 0), (37, 1024, 2047, 4000)),
    ("gqa_llama3", 1, 512, 512, 32, 8, 128, "bfloat16", "bfloat16",
     (True, 0, 0), None),
    ("odd", 2, 77, 133, 8, 4, 64, "bfloat16", "bfloat16", (True, 56, 9),
     (133, 100)),
    # rows that see no key (q_offset < 0; valid 0) on the two bf16 routes
    ("blind_rows_bf16", 1, 70, 50, 2, 1, 64, "bfloat16", "bfloat16",
     (True, -20, 0), None),
    ("no_valid_key_bf16", 2, 3, 40, 2, 2, 32, "bfloat16", "bfloat16",
     (False, 0, 0), (0, 5)),
    # llama3-8b's widths at decode: 32 query heads over 8 kv heads, D 128
    ("decode_gqa_llama3", 4, 1, LM_MAX_SEQ, 32, 8, 128, "bfloat16",
     "float32", (False, 0, 0), (300, 1500, 2900, 4096)),
    # valid lengths about one 256-key split, and a single key
    ("decode_valid_edges", 4, 1, LM_MAX_SEQ, 32, 32, 64, "bfloat16",
     "float32", (False, 0, 0), (255, 256, 257, 1)),
    # the CUDA-core route kept for bf16 q with a float32 k/v at Sq > 8
    ("prefill_f32_kv", 1, 1024, 1024, 32, 32, 64, "bfloat16", "float32",
     (True, 0, 0), None),
    # the train phase's forward: zamba2-1.2b at train_4k's 4096 tokens
    ("train_4k", 1, TRAIN_SEQ, TRAIN_SEQ, 32, 32, 64, "bfloat16",
     "bfloat16", (True, 0, 0), None),
    # the moe phase's shapes: qwen3-moe's GQA 16:1 (64 query heads over 4
    # kv heads of 128) and kimi-k2's head dim 112 (64 over 8), a 1,024-token
    # prefill and a 4-slot decode over a 4,096-row float32 cache; and the
    # CUDA-core route at D 112 (float32 q, Sq > 8)
    ("prefill_gqa_qwen3moe", 1, 1024, 1024, 64, 4, 128, "bfloat16",
     "bfloat16", (True, 0, 0), None),
    ("decode_gqa_qwen3moe", 4, 1, LM_MAX_SEQ, 64, 4, 128, "bfloat16",
     "float32", (False, 0, 0), (37, 1024, 2047, 4000)),
    ("prefill_kimi_d112", 1, 1024, 1024, 64, 8, 112, "bfloat16",
     "bfloat16", (True, 0, 0), None),
    ("decode_kimi_d112", 4, 1, LM_MAX_SEQ, 64, 8, 112, "bfloat16",
     "float32", (False, 0, 0), (37, 1024, 2047, 4000)),
    ("cuda_core_d112", 1, 256, 256, 16, 2, 112, "float32", "float32",
     (True, 0, 0), None),
    # the train phase's paligemma-3b forward: its 256 patch embeddings
    # (the bidirectional prefix) before train_4k's 4,096 text tokens, 8
    # query heads of 256 over one kv head
    ("train_paligemma_d256", 1, TRAIN_SEQ + 256, TRAIN_SEQ + 256, 8, 1,
     256, "bfloat16", "bfloat16", (True, 0, 256), None),
    # phase 15's qwen3-moe-235b-a22b training forward: train_4k's 4,096
    # tokens, 64 query heads over 4 kv heads of 128
    ("train_qwen3_gqa16", 1, TRAIN_SEQ, TRAIN_SEQ, 64, 4, 128, "bfloat16",
     "bfloat16", (True, 0, 0), None),
    # the sharded phase's forward on one rank: zamba2's 16 of 32 heads (a
    # model rank's half), its data rank's 2 rows of 2,048 tokens
    ("train_rank_tp2", 2, 2048, 2048, 16, 16, 64, "bfloat16", "bfloat16",
     (True, 0, 0), None),
    # qwen3-moe's training forward on one rank of (data 2, model 2) under
    # a2a: 32 of 64 query heads over 2 of 4 kv heads of 128 (a model
    # rank's half), its data rank's 2 rows of 1,024 tokens (the sharded
    # phase's a2a drive runs the MoE layer alone: the meshed dry run
    # reckons the 1-layer step beyond the card with four ranks on it)
    ("train_rank_a2a", 2, 1024, 1024, 32, 2, 128, "bfloat16", "bfloat16",
     (True, 0, 0), None),
]
# the cases whose times the kernels line gives side by side
ATTN_HEADLINE = ("prefill", "decode", "gqa_llama3", "train_4k",
                 "prefill_gqa_qwen3moe", "decode_gqa_qwen3moe",
                 "prefill_kimi_d112", "decode_kimi_d112", "cuda_core_d112",
                 "train_paligemma_d256", "train_qwen3_gqa16",
                 "train_rank_tp2", "train_rank_a2a")


def attention_diff(got, want, dtype: str, roundings: int = 1):
    """max|got - want| and its largest share of the per-row tolerance
    roundings * ATTN_RTOL * max|want row| + ATTN_ATOL (a row: one query,
    one head); ``roundings``: the bf16 roundings ``got`` went through that
    ``want`` did not take (2 for attention merged from parts, each part's
    output rounded to bf16 before the merge rounds again)."""
    diff = (got.float() - want.float()).abs()
    tol = (roundings * ATTN_RTOL[dtype]
           * want.float().abs().amax(dim=-1, keepdim=True) + ATTN_ATOL)
    return float(diff.max()), float((diff / tol).max())


def attention_cases(gen, dev, cases=ATTN_CASES, headline=ATTN_HEADLINE):
    """FLASH_ATTENTION against its plain version (``full_mha`` on the
    TORCH template) at ``cases``' shapes (by default the lm path's prefill
    and decode shapes, llama3-8b's GQA widths, an odd shape and the edges
    of each route); each timed beside ``scaled_dot_product_attention`` on
    the same inputs and mask, the ``headline`` cases' times kept."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attention_cuda as ac
    from repro_torch.launch import op_cost
    from repro_torch.models.attention import MaskSpec

    res = {"max_abs_err": 0.0, "cases": {}}
    for (case, b, sq, sk, h, kh, d, qdt, kvdt, (causal, off, pre),
         valid) in cases:
        qdt_, kvdt_ = getattr(torch, qdt), getattr(torch, kvdt)
        path = ac.route(qdt_, kvdt_, sq)
        q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(qdt_)
        k, v = (torch.randn(b, sk, kh, d, generator=gen, device=dev)
                .to(kvdt_) for _ in range(2))
        vt = None if valid is None else torch.tensor(valid, device=dev)
        spec = MaskSpec(causal=causal, q_offset=off, prefix_len=pre)
        by_route = dict(ac.ROUTE_LAUNCHES)
        got = ac.flash_attention(q, k, v, spec, vt)
        took = {r: n - by_route[r] for r, n in ac.ROUTE_LAUNCHES.items()}
        want = ac.flash_attention_plain(q, k, v, spec, vt)
        torch.cuda.synchronize()
        err, share = attention_diff(got, want, qdt)
        finite = bool(torch.isfinite(got).all())
        # the planted fault: one 64-key tile short, in the kernel call only
        short = (sk - ATTN_FAULT_KEYS if vt is None
                 else (vt - ATTN_FAULT_KEYS).clamp(min=1))
        _, fault_share = attention_diff(
            ac.flash_attention(q, k, v, spec, short), want, qdt)
        mask = op_cost.attention_mask(b, sq, sk, causal, off, pre, vt, dev)
        nbytes, ops = op_cost.flash_attention_cost(q, k, mask, vt)
        # the library yardstick: SDPA (B, H, S, D) on k/v in q's dtype, with
        # is_causal for a plain causal mask (its fastest route) and the
        # explicit boolean mask for the rest
        qs = q.transpose(1, 2)
        ks, vs = (t.to(qdt_).transpose(1, 2) for t in (k, v))
        plain_causal = causal and off == 0 and pre == 0 and vt is None
        sdpa_kw = (dict(is_causal=True) if plain_causal
                   else dict(attn_mask=mask[:, None]))
        sdpa = lambda: F.scaled_dot_product_attention(
            qs, ks, vs, enable_gqa=h != kh, **sdpa_kw)
        lib_err = float((sdpa().transpose(1, 2).float()
                         - want.float()).abs().max())
        line = {"phase": "kernel", "kernel": "FLASH_ATTENTION", "case": case,
                "route": path,
                "shape": {"B": b, "Sq": sq, "Sk": sk, "H": h, "KH": kh,
                          "D": d}, "q_dtype": qdt, "kv_dtype": kvdt,
                "causal": causal, "q_offset": off, "prefix_len": pre,
                "valid": valid, "max_abs_diff": err,
                "share_of_row_tolerance": share,
                "planted_fault_share_of_row_tolerance": fault_share,
                "finite": finite, "sdpa_max_abs_diff": lib_err,
                "sdpa_mask": "is_causal" if plain_causal else "boolean",
                "kernel_ms": cuda_ms(lambda: ac.flash_attention(
                    q, k, v, spec, vt), reps=20, head_start=True),
                # back to back, at the host's pace where it is the slower
                "call_ms": cuda_ms(lambda: ac.flash_attention(
                    q, k, v, spec, vt), reps=20),
                "plain_ms": cuda_ms(lambda: ac.flash_attention_plain(
                    q, k, v, spec, vt), reps=3, warmup=1),
                "library_ms": cuda_ms(sdpa, reps=20, head_start=True),
                **bound(nbytes, ops, BF16_OPS_PER_S if qdt == "bfloat16"
                        else F32_OPS_PER_S)}
        emit(line)
        require(took == {r: int(r == path) for r in ac.ROUTES},
                f"FLASH_ATTENTION ({case}): launched {took}, not one {path}")
        require(finite, f"FLASH_ATTENTION ({case}): non-finite output")
        require(share <= 1.0, f"FLASH_ATTENTION ({case}): |kernel - plain| "
                              f"is {share} of its per-row tolerance")
        require(fault_share > 1.0,
                f"FLASH_ATTENTION ({case}): the check passed a kernel given "
                f"{ATTN_FAULT_KEYS} keys too few ({fault_share} of the "
                f"tolerance)")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if case in headline:
            res["cases"][case] = {key: line[key] for key in
                                  ("route", "kernel_ms", "call_ms",
                                   "plain_ms", "library_ms", "bound_ms",
                                   "bound_by", "max_abs_diff")}
        if case == "prefill":                  # the headline numbers
            res.update(res["cases"][case])
        del q, k, v, got, want, mask
    require({ac.route(getattr(torch, c[7]), getattr(torch, c[8]), c[2])
             for c in cases} == set(ac.ROUTES),
            "FLASH_ATTENTION: a route has no case")
    return res


# the sharded serving decode on one tp rank: zamba2's 32 query heads over
# 32 kv heads of 64, 4 slots, a 2,048-row half of the 4,096-row float32
# cache (model rank 1's block, positions 2,048..4,095), with each row's
# log-sum-exp; the valid lengths over the whole cache leave rows 0 and 1 no
# key in this half
LSE_CASE = "decode_lse_rank_slice"
LSE_SHAPE = (4, LM_MAX_SEQ, 32, 32, 64)          # B, Sk whole, H, KH, D
LSE_VALID = (37, 1024, 2500, 4000)


def attention_lse_case(gen, dev) -> dict:
    """FLASH_ATTENTION's decode with its log-sum-exp on each half of a
    cache, as the two ``tp`` ranks of the sharded serving decode take it
    (``models.attention.decode_mha_partial``): each half's (out, lse)
    against the plain pair per query row, the halves merged
    (``kernels.ref.merge_partials``) against the whole cache's plain
    decode, a log-sum-exp off by log 2 in one half rejected; the second
    half timed beside the same launch without the log-sum-exp, its bound
    and SDPA on the same half and mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attention_cuda as ac
    from repro_torch.kernels.attention import block_valid_len
    from repro_torch.kernels.ref import merge_partials
    from repro_torch.launch import op_cost
    from repro_torch.models.attention import MaskSpec, decode_mha_partial

    b, sk, h, kh, d = LSE_SHAPE
    half = sk // 2
    q = torch.randn(b, 1, h, d, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(b, sk, kh, d, generator=gen, device=dev)
            for _ in range(2))
    lens = torch.tensor(LSE_VALID, device=dev)
    spec = MaskSpec(causal=False)
    parts, shares, err = [], [], 0.0
    for j in range(2):
        kj, vj = k[:, j * half:(j + 1) * half], v[:, j * half:(j + 1) * half]
        by_route = dict(ac.ROUTE_LAUNCHES)
        got = decode_mha_partial(q, kj, vj, lens, j * half, template="CUDA")
        took = {r: n - by_route[r] for r, n in ac.ROUTE_LAUNCHES.items()}
        want = decode_mha_partial(q, kj, vj, lens, j * half,
                                  template="TORCH")
        torch.cuda.synchronize()
        require(took == {r: int(r == "split_k_decode") for r in ac.ROUTES},
                f"FLASH_ATTENTION ({LSE_CASE}): launched {took}")
        out_err, out_share = attention_diff(got[0], want[0], "bfloat16")
        lse_diff = (got[1] - want[1]).abs()
        lse_share = float((lse_diff / (ATTN_RTOL["bfloat16"]
                                       * want[1].abs() + ATTN_ATOL)).max())
        empty = block_valid_len(lens, j * half, half) == 0
        require(bool((got[1][empty] == -1e30).all())
                and bool(torch.isfinite(got[0]).all()),
                f"FLASH_ATTENTION ({LSE_CASE}): half {j}'s rows with no key "
                "do not report an lse of -1e30, or are not finite")
        shares.append({"out": out_share, "lse": lse_share,
                       "lse_max_abs_diff": float(lse_diff.max()),
                       "rows_with_no_key": int(empty.sum())})
        err = max(err, out_err)
        parts.append(got)
    outs, lses = (torch.stack(t) for t in zip(*parts))
    whole = ac.flash_attention_plain(q, k, v, spec, lens)
    merge_err, merge_share = attention_diff(merge_partials(outs, lses), whole,
                                            "bfloat16", roundings=2)
    off = lses.clone()
    off[0] += math.log(2.0)
    _, fault_share = attention_diff(merge_partials(outs, off), whole,
                                    "bfloat16", roundings=2)
    # the second half, timed: the launch with and without its lse
    kj, vj = k[:, half:], v[:, half:]
    valid = block_valid_len(lens, half, half)
    mask = op_cost.attention_mask(b, 1, half, False, 0, 0, valid, dev)
    nbytes, ops = op_cost.flash_attention_cost(q, kj, mask, valid, lse=True)
    qs, ks, vs = (t.to(torch.bfloat16).transpose(1, 2) for t in (q, kj, vj))
    sdpa = lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask[:, None])
    line = {"phase": "kernel", "kernel": "FLASH_ATTENTION", "case": LSE_CASE,
            "route": "split_k_decode",
            "shape": {"B": b, "Sq": 1, "Sk": half, "H": h, "KH": kh, "D": d,
                      "of_cache_rows": sk, "start": half},
            "valid_whole_cache": list(LSE_VALID),
            "valid_in_half": valid.tolist(), "halves": shares,
            "max_abs_diff": err, "merged_vs_whole_max_abs_diff": merge_err,
            "merged_share_of_row_tolerance": merge_share,
            "planted_fault": "lse + log 2 in the first half",
            "planted_fault_share_of_row_tolerance": fault_share,
            "kernel_ms": cuda_ms(lambda: ac.flash_attention(
                q, kj, vj, spec, valid, return_lse=True), reps=20,
                head_start=True),
            "kernel_ms_without_lse": cuda_ms(lambda: ac.flash_attention(
                q, kj, vj, spec, valid), reps=20, head_start=True),
            "plain_ms": cuda_ms(lambda: ac.flash_attention_plain(
                q, kj, vj, spec, valid, return_lse=True), reps=3, warmup=1),
            "library_ms": cuda_ms(sdpa, reps=20, head_start=True),
            **bound(nbytes, ops, BF16_OPS_PER_S)}
    emit(line)
    for j, sh in enumerate(shares):
        require(sh["out"] <= 1.0 and sh["lse"] <= 1.0,
                f"FLASH_ATTENTION ({LSE_CASE}): half {j} off its plain pair "
                f"({sh})")
    require(merge_share <= 1.0, f"FLASH_ATTENTION ({LSE_CASE}): the merged "
                                f"halves are {merge_share} of the tolerance "
                                "off the whole cache's decode")
    require(fault_share > 1.0, f"FLASH_ATTENTION ({LSE_CASE}): the check "
                               "passed an lse off by log 2")
    del q, k, v, kj, vj, outs, lses, whole, mask
    return {"err": max(err, merge_err),
            "case": {key: line[key] for key in
                     ("route", "kernel_ms", "kernel_ms_without_lse",
                      "plain_ms", "library_ms", "bound_ms", "bound_by",
                      "max_abs_diff")}}


# B nc L G R P N: the zamba2-1.2b prefills of 1024 (the headline), 512 and
# 2048 tokens (chunks of 128, one group, 64 heads of 64, state 64), an
# odd shape, and the train phase's 4096 tokens (32 chunks); the
# xlstm-125m prefills of 512, 1024 and 2048 tokens (its mLSTM: 4 heads as
# the groups, R 1, N 384 = the head dim, P 385 = v and the normalizer's
# ones column), the train phase's xlstm-125m forward at 4,096 tokens (32
# chunks), and two untimed odd shapes across N and P 128
SSD_CASES = [("prefill", (1, 8, 128, 1, 64, 64, 64)),
             ("prefill_512", (1, 4, 128, 1, 64, 64, 64)),
             ("prefill_2048", (1, 16, 128, 1, 64, 64, 64)),
             ("odd", (2, 3, 48, 1, 3, 16, 8)),
             ("train_4k", (1, TRAIN_SEQ // 128, 128, 1, 64, 64, 64)),
             ("prefill_xlstm_512", (1, 4, 128, 4, 1, 385, 384)),
             ("prefill_xlstm_1024", (1, 8, 128, 4, 1, 385, 384)),
             ("prefill_xlstm_2048", (1, 16, 128, 4, 1, 385, 384)),
             ("train_xlstm_4096", (1, TRAIN_SEQ // 128, 128, 4, 1, 385, 384)),
             ("odd_n200_p129_l48", (2, 3, 48, 2, 3, 129, 200)),
             ("odd_n129_p385", (1, 2, 128, 1, 2, 385, 129)),
             # an ssm_sp rank's block in the sharded phase: zamba2's 2 rows
             # x 1,024 of 2,048 tokens, the relayed state in s_in
             ("train_rank_ssm_sp", (2, 1024 // 128, 128, 1, 64, 64, 64))]


def mlstm_ssd_inputs(shape, gen, dev):
    """SSD_INTRA's inputs as an mLSTM layer makes them: v with the ones
    column, log_decay = log_sigmoid(3 + noise) (the forget bias 3),
    in_scale = exp(8 tanh(i / 8)) with i spread over the cap (up to e^8 =
    2,981), k / sqrt(N), and s_in the inter-chunk relay of the same inputs
    (``ssd_core``'s), so that the state term is of the output's scale."""
    import torch
    import torch.nn.functional as F

    bsz, nc, l, g, r, p, n = shape
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    x = rnd(bsz, nc, l, g, r, p)
    x[..., -1] = 1.0
    ld = F.logsigmoid(3.0 + rnd(bsz, nc, l, g, r))
    dt = torch.exp(8.0 * torch.tanh((rnd(bsz, nc, l, g, r) * 6 - 2) / 8))
    b_ = rnd(bsz, nc, l, g, n) / math.sqrt(n)
    c_ = rnd(bsz, nc, l, g, n)
    cum = torch.cumsum(ld, dim=2)
    w = torch.exp(cum[:, :, -1:] - cum) * dt
    sc = torch.einsum("bclgn,bclgr,bclgrp->bcgrnp", b_, w, x)
    s_in = torch.zeros_like(sc)
    for c in range(1, nc):
        s_in[:, c] = (s_in[:, c - 1] * torch.exp(cum[:, c - 1, -1])[..., None,
                                                                   None]
                      + sc[:, c - 1])
    return x, ld, dt, b_, c_, s_in


def ssd_cases(gen, dev):
    """SSD_INTRA against ``ssd_intra_reference`` at the zamba2-1.2b and
    xlstm-125m prefill shapes (timed), odd shapes; and for each, a planted
    fault the check must reject (the kernel alone given s_in with its last
    head zeroed; at R 1 every head's)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ssd_cuda as sc
    from repro_torch.launch import op_cost

    res = {"max_abs_err": 0.0, "cases": {}}
    for case, (bsz, nc, l, g, r, p, n) in SSD_CASES:
        if "xlstm" in case:
            args = mlstm_ssd_inputs((bsz, nc, l, g, r, p, n), gen, dev)
        else:
            rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                             device=dev)
            x = rnd(bsz, nc, l, g, r, p)
            ld = -F.softplus(rnd(bsz, nc, l, g, r))
            dt = F.softplus(rnd(bsz, nc, l, g, r))
            b_, c_ = rnd(bsz, nc, l, g, n), rnd(bsz, nc, l, g, n)
            s_in = rnd(bsz, nc, g, r, n, p) * 0.3
            args = (x, ld, dt, b_, c_, s_in)
        x, s_in = args[0], args[5]
        got = sc.ssd_intra(*args)
        want = sc.ssd_intra_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = SSD_RTOL * max(1.0, float(want.abs().max()))
        finite = bool(torch.isfinite(got).all())
        s_bad = s_in.clone()
        s_bad[:, :, :, -1] = 0.0
        fault = float((sc.ssd_intra(*args[:5], s_bad) - want).abs().max())
        del s_bad
        nbytes, ops = op_cost.ssd_intra_cost(args, got)
        line = {"phase": "kernel", "kernel": "SSD_INTRA", "case": case,
                "shape": dict(zip("B nc L G R P N".split(),
                                  (bsz, nc, l, g, r, p, n))),
                "max_abs_diff": err, "tolerance": tol,
                "share_of_tolerance": err / tol, "finite": finite,
                "planted_fault_max_abs_diff": fault}
        if not case.startswith("odd"):
            line.update(
                kernel_ms=cuda_ms(lambda: sc.ssd_intra(*args), reps=20,
                                  head_start=True),
                plain_ms=cuda_ms(lambda: sc.ssd_intra_plain(*args), reps=3,
                                 warmup=1),
                library_ms=None,
                # the products run on the tensor cores (TF32); the float32
                # CUDA-core bound of PRs 13-14 beside it
                **bound(nbytes, ops, TF32_OPS_PER_S),
                bound_ms_f32_cuda_cores=bound(nbytes, ops,
                                              F32_OPS_PER_S)["bound_ms"],
                heads_per_block=sc.heads_per_block(x))
            res["cases"][case] = {key: line[key] for key in
                                  ("kernel_ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by",
                                   "bound_ms_f32_cuda_cores",
                                   "heads_per_block")}
            if case == "prefill":
                res.update({key: line[key] for key in
                            ("kernel_ms", "plain_ms", "library_ms",
                             "bound_ms", "bound_by")})
        emit(line)
        require(finite, f"SSD_INTRA ({case}): non-finite output")
        require(err <= tol, f"SSD_INTRA ({case}): max|kernel - plain| "
                            f"{err} > {tol}")
        require(fault > tol, f"SSD_INTRA ({case}): the check passed a "
                             f"zeroed head state ({fault} <= {tol})")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        del args, got, want
    return res


# ---------------------------------------------------------------------------
def phase_main(kernel_results, dev):
    import torch
    from repro_torch import api
    from repro_torch.core.halo import exchange_pad
    from repro_torch.kernels import stencil3d_cuda as sc

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res_cuda = api.runtime(n=N, nz=N, backend="cuda", device=dev).run(
        "cavity", steps=STEPS, re=100.0)
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()

    reset_counts()
    t0 = time.perf_counter()
    res_torch = api.runtime(n=N, nz=N, backend="torch", device=dev).run(
        "cavity", steps=STEPS, re=100.0)
    torch.cuda.synchronize()
    torch_s = time.perf_counter() - t0
    torch_launches = read_counts()

    agree = agreement(res_cuda.state, res_torch.state, "cuda vs torch backend")
    del res_torch

    # step wall time and its device-time split, through the front door
    pr = api.runtime(n=N, nz=N, backend="cuda", device=dev).prepare("cavity", re=100.0)
    state = pr.state
    for _ in range(2):
        state = pr.step(state)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        state = pr.step(state)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    p_specs = pr.solver._specs("p")
    pad_ms = cuda_ms(lambda: exchange_pad(state["p"], (1, 1, 1), p_specs),
                     reps=20)
    split = profile_step(pr, state)
    kernel_sum = sum(PER_STEP[k] * kernel_results[k]["kernel_ms"]
                     for k in PER_STEP)

    expected = {k: STEPS * v for k, v in PER_STEP.items()}
    emit({"phase": "main", "grid": [N, N, N], "steps": STEPS,
          "launches": launches, "expected": expected,
          "torch_backend_launches": torch_launches,
          "cuda_run_s": cuda_s, "torch_run_s": torch_s,
          "agree": agree, "step_ms": step_ms,
          "kernel_ms_per_step": kernel_sum,
          "jacobi_pad_ms": pad_ms, "device_split_ms_per_step": split,
          "max_memory_allocated": peak,
          "ghia": res_cuda.diagnostics["ghia"]})
    require(launches == expected, f"launch counts {launches} != {expected}")
    require(all(v == 0 for v in torch_launches.values()),
            f"torch backend launched CUDA kernels: {torch_launches}")
    return launches, res_cuda.state


def agreement(got: dict, want: dict, what: str) -> dict:
    """Hold ``got`` to ``want`` within PATH_RTOL: velocity components to
    the flow's speed (vz stays ~0 in the z-periodic cavity), the pressure
    to its own magnitude.  Both must be finite and 256^3."""
    import torch

    agree = {}
    speed = max(float(want[f].abs().max()) for f in ("vx", "vy", "vz"))
    for f in ("vx", "vy", "vz", "p"):
        a, b = got[f], want[f]
        require(bool(torch.isfinite(a).all()), f"{what}: {f} not finite")
        require(bool(torch.isfinite(b).all()), f"{what}: {f} not finite")
        require(tuple(a.shape) == (N, N, N), f"{f} shape {tuple(a.shape)}")
        diff = float((a - b).abs().max())
        tol = PATH_RTOL * (float(b.abs().max()) if f == "p" else speed)
        agree[f] = {"max_abs_diff": diff, "tolerance": tol}
        require(diff <= tol, f"{what}: {f} differs by {diff} > {tol}")
    return agree


def profile_step(pr, state):
    """Device time of one step by kernel, summed in groups, from the
    profiler ("not measured" where it recorded no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pr.step(state)
        torch.cuda.synchronize()
    groups = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or not ev.self_device_time_total:
            continue
        low = ev.key.lower()
        key = next((tag for tag in ("update_velocity_kernel",
                                    "divergence_kernel",
                                    "jacobi_pressure_kernel",
                                    "project_velocity_kernel",
                                    "jacobi_fused_kernel",
                                    "cat", "flip", "fill")
                    if tag in low), "other")
        groups[key] = groups.get(key, 0.0) + ev.self_device_time_total / 1e3
    return groups or "not measured"


# ---------------------------------------------------------------------------
def drive_farm(dev, backend: str, **solver):
    """The farm's verbs at 256^3 through the front door: submit five
    requests into four slots, run, evict one mid-run, readmit it, drain."""
    from repro_torch import api

    rt = api.runtime(n=N, nz=N, n_slots=FARM_SLOTS, backend=backend,
                     device=dev, **solver)
    sids = [rt.submit("cavity", steps=steps, re=re)
            for re, steps in zip(FARM_RES, FARM_STEPS)]
    require(rt.poll(sids[-1])["status"] == "queued", "fifth request not queued")
    rt.services()[0].run(EVICT_AT)
    poll = rt.poll(sids[EVICT])
    require((poll["status"], poll["steps_done"]) == ("running", EVICT_AT),
            f"before eviction: {poll}")
    require(rt.evict(sids[EVICT]), "evict refused")
    require(rt.poll(sids[EVICT])["status"] == "evicted", "not evicted")
    require(rt.readmit(sids[EVICT]), "readmit refused")
    out = rt.drain()
    for sid, steps in zip(sids, FARM_STEPS):
        res = out[sid]
        require((res.terminated, res.steps_done) == ("steps", steps),
                f"{backend} farm sid {sid}: {res.terminated} after "
                f"{res.steps_done} steps ({res.error})")
    return rt, sids, out


def batched_step_ms(dev, **solver) -> float:
    """Host-clock time of one batched step with every slot resident."""
    import torch
    from repro_torch import api

    rt = api.runtime(n=N, nz=N, n_slots=FARM_SLOTS, backend="cuda",
                     device=dev, **solver)
    for re in FARM_RES[:FARM_SLOTS]:
        rt.submit("cavity", steps=1000, re=re)
    svc = rt.services()[0]
    svc.run(2)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    svc.run(reps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def farm_executor(dev, **solver):
    """The 256^3 4-slot farm's executor, one request admitted, not run."""
    from repro_torch import api

    rt = api.runtime(n=N, nz=N, n_slots=FARM_SLOTS, backend="cuda",
                     device=dev, **solver)
    rt.submit("cavity", steps=1, re=FARM_RES[0])
    return rt.services()[0].farm.exec


def phase_farm(dev, label: str, per_step: dict, **solver):
    """The 256^3 farm on the cuda backend, its counts, bitwise equality
    with serial cuda runs, and agreement with the torch backend's farm."""
    import torch
    from repro_torch import api

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    rt, sids, out = drive_farm(dev, "cuda", **solver)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    device_steps = rt.device_steps()
    expected = {k: device_steps * v for k, v in per_step.items()}
    require(launches == expected,
            f"{label}: launch counts {launches} != {expected}")
    del rt

    serial_rt = api.runtime(n=N, nz=N, backend="cuda", device=dev, **solver)
    for sid, re, steps in zip(sids, FARM_RES, FARM_STEPS):
        serial = serial_rt.run("cavity", steps=steps, re=re).state
        for f in ("vx", "vy", "vz", "p"):
            require(torch.equal(out[sid].state[f], serial[f]),
                    f"{label}: sid {sid} (Re {re}) field {f} differs from "
                    f"the serial cuda run by "
                    f"{float((out[sid].state[f] - serial[f]).abs().max())}")
        del serial
    reset_counts()
    t0 = time.perf_counter()
    _, _, torch_out = drive_farm(dev, "torch", **solver)
    torch.cuda.synchronize()
    torch_wall = time.perf_counter() - t0
    torch_launches = read_counts()
    require(all(v == 0 for v in torch_launches.values()),
            f"{label}: torch farm launched CUDA kernels: {torch_launches}")
    agree = {sid: agreement(out[sid].state, torch_out[sid].state,
                            f"{label}: cuda vs torch farm, sid {sid}")
             for sid in sids}
    del torch_out
    step_ms = batched_step_ms(dev, **solver)
    sim_steps = sum(FARM_STEPS)
    emit({"phase": label, "grid": [N, N, N], "slots": FARM_SLOTS,
          "requests": len(sids), "sim_steps": sim_steps,
          "device_steps": device_steps, "launches": launches,
          "expected": expected, "bitwise_vs_serial": True,
          "wall_s": wall, "sims_steps_per_s": sim_steps / wall,
          "torch_farm_wall_s": torch_wall,
          "batched_step_ms": step_ms,
          "batched_step_ms_per_slot": step_ms / FARM_SLOTS,
          "max_memory_allocated": peak,
          "agree_max_abs_diff": {
              f: max(a[f]["max_abs_diff"] for a in agree.values())
              for f in ("vx", "vy", "vz", "p")}})
    torch.cuda.empty_cache()
    return launches, [out[sid] for sid in sids]


# the crash run's store-backed process: the port only, on the card; it
# prints the non-port modules it loaded, then kills itself after its first
# snapshot (the eviction's)
CRASH_SCRIPT = r"""
import json, os, signal, sys
sys.path.insert(0, sys.argv[1])
from repro_torch import api

rt = api.runtime(n=int(sys.argv[3]), nz=int(sys.argv[3]), n_slots=2,
                 device=sys.argv[6], store={"path": sys.argv[2],
                                            "ttl_s": 1.0})
res = json.loads(sys.argv[4])
sids = [rt.submit("cavity", re=re, steps=int(sys.argv[5]), tag=f"crash{i}")
        for i, re in enumerate(res)]
svc = rt.services()[0]
svc.run(2)                      # two resident at step 2, one queued
assert rt.evict(sids[0])        # the first snapshot: the eviction's
svc.run(2)                      # the queued one takes the freed slot
bad = sorted(m for m in sys.modules if m in ("jax", "repro")
             or m.startswith(("jax.", "jaxlib", "repro.")))
print("SNAPSHOT", json.dumps(bad), flush=True)
os.kill(os.getpid(), signal.SIGKILL)
"""


def bitwise_results(got: dict, want: dict, what: str):
    import torch

    for f in ("vx", "vy", "vz", "p"):
        a, b = got[f], want[f]
        require(torch.equal(a, b), f"{what}: field {f} differs by "
                f"{float((a - b).abs().max())}")


def phase_durable(dev, farm_launches: dict, farm_results: list, smi: str):
    """The farm phase again with telemetry, health, ckpt_dir and the job
    store on; a poisoned request quarantined; a crash and its recovery."""
    import torch
    from repro_torch import api, obs
    from repro_torch.obs import perf

    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    os.makedirs(DURABLE_DIR)
    check_every = api.RuntimeConfig().check_every

    # 1. bitwise invisibility: the farm phase's requests and eviction
    part = os.path.join(DURABLE_DIR, "farm")
    trace_path = os.path.join(part, "trace.jsonl")
    os.makedirs(part)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    rt, sids, out = drive_farm(dev, "cuda", telemetry={"trace_path": trace_path},
                               health=True, ckpt_dir=part, store=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    require(launches == farm_launches,
            f"durable: launch counts {launches} != the farm's {farm_launches}")
    for sid, want in zip(sids, farm_results):
        bitwise_results(out[sid].state, want.state,
                        f"durable: sid {sid} against the farm phase")
    doc = rt.telemetry.trace.to_chrome()
    obs.validate_chrome_trace(doc)
    rt.telemetry.trace.close()
    with open(trace_path) as f:
        jsonl = sum(1 for _ in f)
    n_events = len(rt.telemetry.trace.events)
    require(jsonl == n_events, f"durable: {jsonl} trace lines, "
                               f"{n_events} events")
    farm = rt.services()[0].farm
    drains = rt.telemetry.metrics.get("health.drains") or 0
    boundaries = farm.device_steps // check_every
    require(drains <= boundaries,
            f"durable: {drains} health drains > {boundaries} boundaries")
    store = rt.store
    require(store.counts()["done"] == len(sids), f"durable: {store.counts()}")
    bitwise_results(rt.load_result(rt.job_id(sids[-1])), out[sids[-1]].state,
                    "durable: the stored result")
    timers = rt.telemetry.timers.snapshot()

    def section(name):
        node = timers.get(name, {})
        return node.get("total_s", 0.0), node.get("count", 0)

    spill_s, spills = section("service.evict_spill")
    restore_s, restores = section("service.readmit_restore")
    drain_s, drain_n = section("farm.health_drain")
    require(spills == 1 and restores == 1,
            f"durable: {spills} spills, {restores} restores")
    spilled = sum(t.numel() * t.element_size()
                  for t in out[sids[EVICT]].state.values())
    del rt, out, farm, store

    # 2. quarantine: a sixth request with dt far past the CFL limit
    part = os.path.join(DURABLE_DIR, "quarantine")
    qrt = api.runtime(n=N, nz=N, n_slots=FARM_SLOTS, backend="cuda",
                      device=dev, health=True, ckpt_dir=part, store=True)
    # more steps than one check interval: health drains at its boundaries
    bad = qrt.submit("cavity", steps=2 * check_every, re=100.0,
                     dt=POISON_DT, tag="poison")
    qsids = [qrt.submit("cavity", steps=steps, re=re)
             for re, steps in zip(FARM_RES, FARM_STEPS)]
    qout = qrt.drain()
    require(qout[bad].terminated == "diverged",
            f"durable: the poisoned run ended {qout[bad].terminated}")
    record = qrt.flight_record(qrt.job_id(bad))
    require(record["meta"]["tag"] == "poison"
            and record["frames"].shape[1] == len(obs.DIAG_COLUMNS)
            and {"vx", "vy", "vz", "p"} <= set(record["state"]),
            "durable: the flight record does not read back")
    for sid, want in zip(qsids, farm_results):
        require(qout[sid].terminated == "steps",
                f"durable: survivor {sid} ended {qout[sid].terminated}")
        bitwise_results(qout[sid].state, want.state,
                        f"durable: survivor {sid} against the farm phase")
    quarantine = {"terminated": qout[bad].terminated,
                  "steps_done": qout[bad].steps_done,
                  "cause": record["meta"]["cause"],
                  "flight_frames": int(record["frames"].shape[0])}
    del qrt, qout, record
    shutil.rmtree(part, ignore_errors=True)

    # 3. crash and resume: a store-backed process killed after its first
    # snapshot; this process recovers its jobs and drains them
    part = os.path.join(DURABLE_DIR, "crash")
    os.makedirs(part)
    store_path = os.path.join(part, "jobs.sqlite")
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", CRASH_SCRIPT, os.path.join(ROOT, "src"),
         store_path, str(N), json.dumps(CRASH_RES), str(CRASH_STEPS),
         dev.type],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    child_s = time.perf_counter() - t0
    snap_line = [ln for ln in child.stdout.splitlines()
                 if ln.startswith("SNAPSHOT")]
    require(child.returncode == -signal.SIGKILL and snap_line,
            f"durable: the crash run ended {child.returncode}:\n"
            f"{child.stdout[-2000:]}\n{child.stderr[-2000:]}")
    require(json.loads(snap_line[0].split(" ", 1)[1]) == [],
            f"durable: the crash run loaded {snap_line[0]}")
    time.sleep(1.5)                # its leases (1 s) expire
    t0 = time.perf_counter()
    crt = api.runtime(n=N, nz=N, n_slots=2, backend="cuda", device=dev,
                      store={"path": store_path, "ttl_s": 30.0})
    resumed = {j.tag: j.job_id for j in crt.jobs()}
    statuses = {j.tag: j.status for j in crt.jobs()}
    crt.drain()
    resume_s = time.perf_counter() - t0
    require(crt.store.counts()["done"] == len(CRASH_RES),
            f"durable: after recovery {crt.store.counts()}")
    ref = api.runtime(n=N, nz=N, n_slots=2, backend="cuda", device=dev)
    ref_sids = [ref.submit("cavity", re=re, steps=CRASH_STEPS)
                for re in CRASH_RES]
    ref_out = ref.drain()
    for i, sid in enumerate(ref_sids):
        bitwise_results(crt.load_result(resumed[f"crash{i}"]),
                        ref_out[sid].state,
                        f"durable: resumed crash{i} against an "
                        "uninterrupted run")
    del crt, ref, ref_out
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)

    # 4. what it costs: the batched step with telemetry and health on
    # against off (on first, then off, then on), one health drain's copy
    on_kw = dict(telemetry=True, health=True)
    step_ms = {"on": [batched_step_ms(dev, **on_kw)],
               "off": [batched_step_ms(dev)]}
    step_ms["on"].append(batched_step_ms(dev, **on_kw))
    drain_ms = drain_s / max(drain_n, 1) * 1e3
    # ... and what the op-cost model says it costs: one diagnostics pass a
    # check interval, counted on the two executors' real batched steps
    health = perf.health_overhead_model(farm_executor(dev),
                                        farm_executor(dev, **on_kw),
                                        check_every)
    require(health["status"] == "ok", f"durable: health model {health}")
    health["measured_overhead"] = (sum(step_ms["on"]) / len(step_ms["on"])
                                   / step_ms["off"][0] - 1.0)
    emit({"phase": "durable", "grid": [N, N, N], "slots": FARM_SLOTS,
          "card": smi, "launches": launches, "expected": farm_launches,
          "bitwise_vs_farm": True, "wall_s": wall,
          "trace_events": n_events, "trace_valid": True,
          "health_drains": drains, "harvest_boundaries": boundaries,
          "health_drain_ms": drain_ms,
          "evict_spill_ms": spill_s * 1e3, "evict_spill_mb": spilled / 1e6,
          "evict_spill_mb_per_s": spilled / 1e6 / max(spill_s, 1e-9),
          "readmit_restore_ms": restore_s * 1e3,
          "max_memory_allocated": peak,
          "batched_step_ms_on": step_ms["on"],
          "batched_step_ms_off": step_ms["off"],
          "health_overhead": health,
          "quarantine": quarantine, "quarantine_survivors_bitwise": True,
          "crash": {"child_s": child_s, "statuses_at_restart": statuses,
                    "recover_and_drain_s": resume_s,
                    "resumed_bitwise": True}})
    torch.cuda.empty_cache()
    return launches, health


def tiles_against_block_for(dev) -> dict:
    """Each stencil under its autotuned tile and under ``block_for`` at
    256^3, serial and at the farm's 4-slot launch: the outputs bit for bit,
    and the device times in turns (tuned, block_for, block_for, tuned)."""
    import torch
    from repro_torch.cfd import cavity
    from repro_torch.core import autotune
    from repro_torch.kernels import stencil3d, stencil3d_cuda as sc

    out = {}
    for name in STENCILS:
        tile = autotune.tile_for(stencil3d.DESCRIPTORS[name], (N,) * 3).tile
        kern = sc.KERNELS[name]
        row = {"tile": list(tile), "block_for": list(sc.block_for(N, N))}
        for case, S in (("serial", None), ("farm", FARM_SLOTS)):
            gen = torch.Generator(device=dev).manual_seed(SEED + 3)
            inputs = kernel_inputs(name, S, (N,) * 3, gen, dev)
            cfgs = [cavity.config(N, nz=N, re=re)
                    for re in FARM_RES[:S or 1]]
            table = param_rows(name, cfgs, dev)
            table = table if S else table[0]
            want, got = kern(*inputs, table), kern(*inputs, table, tile=tile)
            torch.cuda.synchronize()
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
            ms = {"tuned": [], "block_for": []}
            for which in ("tuned", "block_for", "block_for", "tuned"):
                t = tile if which == "tuned" else None
                ms[which].append(cuda_ms(lambda: kern(*inputs, table, tile=t),
                                         reps=50, head_start=True))
            tuned = sum(ms["tuned"]) / 2
            block_for = sum(ms["block_for"]) / 2
            row[case] = {"kernel_ms_tuned": ms["tuned"],
                         "kernel_ms_block_for": ms["block_for"],
                         "tuned_over_block_for": tuned / block_for,
                         "bitwise": bitwise}
            require(bitwise, f"perf: {name} ({case}) under the tile {tile} "
                             "differs from block_for")
            require(tuned <= TILE_SLOWER_MAX * block_for,
                    f"perf: {name} ({case}) under the tile {tile} takes "
                    f"{tuned:.4f} ms, block_for {block_for:.4f} ms")
            del inputs, want, got
        out[name] = row
    torch.cuda.empty_cache()
    return out


def perf_rows(rep) -> list:
    """The report's rows as the perf line gives them: the roofline join
    and each op class's share of the counted HBM bytes."""
    keys = ("name", "kind", "status", "flops", "hbm_bytes", "memory_s",
            "compute_s", "roofline_s", "measured_s", "invocations",
            "utilization", "bottleneck", "error")
    rows = []
    for d in rep.rows():
        row = {k: d[k] for k in keys}
        row["op_classes"] = {
            k: dict(v, bytes_share=v["bytes"] / d["hbm_bytes"])
            for k, v in d["op_classes"].items()}
        rows.append(row)
        require(d["status"] == "ok" and bool(d["measured_s"])
                and d["measured_s"] > 0 and d["bottleneck"] == "memory",
                f"perf: row {row}")
    return rows


def phase_perf(dev, smi: str, serial_state: dict, farm_launches: dict,
               farm_results: list, health: dict) -> dict:
    """The performance accounting on the card: the autotuned tiles against
    block_for; the serial 256^3 run and the 4-slot farm with telemetry on,
    bitwise those of the main and farm phases with the same launches, and
    their ``perf_report()`` rows (the trace launching nothing); the health
    model of the durable phase's farm beside its measured cost."""
    import torch
    from repro_torch import api
    from repro_torch.core import autotune

    tiles = tiles_against_block_for(dev)
    paths, runtimes = {}, {}
    torch.cuda.synchronize()
    reset_counts()
    rt = api.runtime(n=N, nz=N, backend="cuda", device=dev, telemetry=True)
    res = rt.run("cavity", steps=STEPS, re=100.0)
    torch.cuda.synchronize()
    paths["perf_serial"] = read_counts()
    expected = {k: STEPS * v for k, v in PER_STEP.items()}
    require(paths["perf_serial"] == expected,
            f"perf: serial launch counts {paths['perf_serial']} != {expected}")
    bitwise_results(res.state, serial_state,
                    "perf: the serial run with telemetry against the main "
                    "phase's")
    del res
    runtimes["serial"] = rt

    reset_counts()
    rt, sids, out = drive_farm(dev, "cuda", telemetry=True)
    torch.cuda.synchronize()
    paths["perf_farm"] = read_counts()
    require(paths["perf_farm"] == farm_launches,
            f"perf: farm launch counts {paths['perf_farm']} != "
            f"{farm_launches}")
    for sid, want in zip(sids, farm_results):
        bitwise_results(out[sid].state, want.state,
                        f"perf: farm sid {sid} against the farm phase")
    del out
    runtimes["farm"] = rt

    rows, trace_s = {}, {}
    for label, rt in runtimes.items():
        reset_counts()
        t0 = time.perf_counter()
        rep = rt.perf_report()
        trace_s[label] = time.perf_counter() - t0
        text = rt.report(perf=True)
        traced = read_counts()
        require(all(v == 0 for v in traced.values()),
                f"perf: the {label} trace launched {traced}")
        require("perf accounting" in text, f"perf: {label} report")
        require(rep.chip.name == "h100-sxm", f"perf: chip {rep.chip.name}")
        rows[label] = perf_rows(rep)
    kinds = [[r["kind"] for r in rows[k]] for k in ("serial", "farm")]
    require(kinds == [["serial-bin"], ["farm-step"]], f"perf: rows {kinds}")
    scrape = runtimes["farm"].services()[0].prometheus_text(perf=True)
    require("repro_perf_utilization" in scrape
            and "repro_perf_bottleneck" in scrape, "perf: the scrape")
    emit({"phase": "perf", "grid": [N, N, N], "slots": FARM_SLOTS,
          "card": smi, "tiles": tiles,
          "tile_cache": autotune.tile_cache_stats(),
          "serial": rows["serial"][0], "farm": rows["farm"][0],
          "trace_s": trace_s, "launches": paths,
          "bitwise_with_accounting": True, "health_overhead": health})
    del runtimes, rt
    gc.collect()          # the runtimes' reference cycles, before the next
    torch.cuda.empty_cache()    # phase reads its peak memory
    return paths


def phase_throughput(dev):
    """The host-bound end: eight requests of 20 steps at n=48 through an
    eight-slot farm, against eight serial runs of the same requests."""
    import torch
    from repro_torch import api

    res = [40.0 + 20.0 * i for i in range(TP_SLOTS)]

    def farm(steps):
        rt = api.runtime(n=TP_N, n_slots=TP_SLOTS, backend="cuda", device=dev)
        sids = [rt.submit("cavity", steps=steps, re=re) for re in res]
        out = rt.drain()
        torch.cuda.synchronize()
        return rt, [out[sid] for sid in sids]

    def serial(steps):
        rt = api.runtime(n=TP_N, backend="cuda", device=dev)
        outs = [rt.run("cavity", steps=steps, re=re) for re in res]
        torch.cuda.synchronize()
        return outs

    farm(2)                              # warm both paths
    serial(2)
    reset_counts()
    t0 = time.perf_counter()
    rt, farm_out = farm(TP_STEPS)
    farm_s = time.perf_counter() - t0
    launches = read_counts()
    t0 = time.perf_counter()
    serial_out = serial(TP_STEPS)
    serial_s = time.perf_counter() - t0
    expected = {k: rt.device_steps() * v for k, v in PER_STEP.items()}
    require(launches == expected,
            f"throughput: launch counts {launches} != {expected}")
    for a, b in zip(farm_out, serial_out):
        for f in ("vx", "vy", "vz", "p"):
            require(torch.equal(a.state[f], b.state[f]),
                    f"throughput: {a.tag} field {f} differs from serial")
    sim_steps = TP_SLOTS * TP_STEPS
    emit({"phase": "throughput", "grid": [TP_N, TP_N, 4], "slots": TP_SLOTS,
          "steps": TP_STEPS, "device_steps": rt.device_steps(),
          "launches": launches, "bitwise_vs_serial": True,
          "farm_s": farm_s, "serial_s": serial_s,
          "farm_sims_steps_per_s": sim_steps / farm_s,
          "serial_sims_steps_per_s": sim_steps / serial_s,
          "farm_over_serial": serial_s / farm_s})
    return launches


# ---------------------------------------------------------------------------
# the decomposed phase: ranks that share the card, joined by gloo (NCCL
# refuses two ranks on one device), each stepping its block of the grid
DECOMP = ((0, "shard"),)
DECOMP_DIR = os.path.join(ROOT, "build", "decomposed")
DECOMP_FIELDS = ("vx", "vy", "vz", "p")
DECOMP_TIMEOUT_S = 600.0
NCCL_PROBE_S = 90.0
DECOMP_RTOL = 1e-5           # tests/test_cfd.py's decomposed-vs-serial bound
# halo_bytes_per_step's figures for these drives (checked against the
# function in the phase): 256^3 split in two on x, its fused_sweeps=2
# twin, and a farm step with 2 resident slots a rank
DECOMP_BYTES = {"serial": 23_592_960, "fused": 44_564_480,
                "farm": 47_185_920}


# the job store on the mesh: the durable phase's crash requests through a
# (slot 2, shard 2) farm of 2 slots; the evicted one sits in slot 1, whose
# shard group's root is global rank 2, so the store gathers it to rank 0
CRASH_EVICT = 1
STORE_DIR = os.path.join(DECOMP_DIR, "store")


def _rank_device():
    import torch

    return torch.device("cuda", torch.cuda.current_device())


def _open_files_under(root: str) -> list:
    """The files under ``root`` that this process holds open."""
    names = []
    for fd in os.listdir("/proc/self/fd"):
        try:
            names.append(os.readlink(os.path.join("/proc/self/fd", fd)))
        except OSError:              # the listing's own descriptor
            pass
    return sorted(n for n in names if n.startswith(root))


def decomposed_crash_rank(store_path: str, marker: str) -> None:
    """One of four ranks on (slot 2, shard 2): the crash requests at 256^3
    through a store-backed farm of 2 slots; one is evicted once it has
    stepped (rank 0 writes its snapshot), the queued one takes its slot,
    and global rank 0 then SIGKILLs itself; the survivors wait in a
    barrier it never reaches."""
    import torch
    import torch.distributed as dist

    rt = _decomposed_runtime(_rank_device(), (2, 2), ("slot", "shard"),
                             n_slots=2,
                             store={"path": store_path, "ttl_s": 1.0})
    sids = [rt.submit("cavity", re=re, steps=CRASH_STEPS, tag=f"crash{i}")
            for i, re in enumerate(CRASH_RES)]
    svc = rt.services()[0]
    svc.run(2)
    require(rt.evict(sids[CRASH_EVICT]), "crash: evict refused")
    svc.run(2)
    if dist.get_rank() == 0:
        torch.cuda.synchronize()
        loaded = sorted(m for m in sys.modules if m in ("jax", "repro")
                        or m.startswith(("jax.", "jaxlib", "repro.")))
        with open(marker, "w") as f:
            json.dump({"loaded": loaded,
                       "polls": {f"crash{i}": rt.poll(s)
                                 for i, s in enumerate(sids)}}, f)
        os.kill(os.getpid(), signal.SIGKILL)
    dist.barrier()


def _decomposed_runtime(dev, mesh_shape, mesh_axes, **kw):
    from repro_torch import api

    return api.runtime(n=N, nz=N, backend="cuda", device=dev,
                       mesh_shape=mesh_shape, mesh_axes=mesh_axes,
                       decomposition=DECOMP, **kw)


def _swapped_transport():
    """A P2P transport that hands each ghost the other side's strip: the
    planted fault the ghost-fill check must reject."""
    from repro_torch.core.halo import P2PTransport

    class Swapped(P2PTransport):
        def start(self, link, periodic, to_hi, to_lo):
            wait = super().start(link, periodic, to_hi, to_lo)

            def swapped():
                lo, hi = wait()
                return hi, lo

            return swapped

    return Swapped()


def decomposed_serial_rank(serial_path: str) -> dict:
    """One of two ranks: the 256^3 cavity through the front door with x
    split in two (20 steps, then its fused_sweeps=2 twin), against the
    main phase's serial state; the ghost fill of the serial fields; one
    step's exchange bytes; step, exchange and busy times; peak memory."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.cfd.ns3d import NavierStokes3D
    from repro_torch.core.halo import exchange_pad

    dev = _rank_device()
    rank = dist.get_rank()
    serial = torch.load(serial_path, weights_only=True)
    out = {"rank": rank, "backend": dist.get_backend()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rt = _decomposed_runtime(dev, (2,), ("shard",))
    reset_counts()
    t0 = time.perf_counter()
    res = rt.run("cavity", steps=STEPS, re=100.0)
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    out["launches"] = read_counts()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["max_abs_diff"] = {}
    for f in DECOMP_FIELDS:
        a = res.state[f]
        require(bool(torch.isfinite(a).all()), f"rank {rank}: {f} not finite")
        require(tuple(a.shape) == (N, N, N), f"{f} shape {tuple(a.shape)}")
        out["max_abs_diff"][f] = float((a - serial[f]).abs().max())
    out["ghia"] = res.diagnostics["ghia"]
    del res

    rt_fused = _decomposed_runtime(dev, (2,), ("shard",),
                                   fused_sweeps=FUSED_K)
    reset_counts()
    res = rt_fused.run("cavity", steps=STEPS, re=100.0)
    out["fused_launches"] = read_counts()
    require(all(bool(torch.isfinite(res.state[f]).all())
                for f in DECOMP_FIELDS), "fused decomposed run not finite")
    del res

    # one step's exchange bytes, as this rank's transport booked them: the
    # strips as the reference's permute operands, and those sent
    steps_of = {}
    for label, runtime in (("serial", rt), ("fused", rt_fused)):
        pr = runtime.prepare("cavity", re=100.0)
        state = pr.step(pr.state)
        transport = pr.solver.driver.transport
        transport.reset()
        state = pr.step(state)
        out[f"{label}_step_bytes"] = transport.permute_operand_bytes
        out[f"{label}_step_sent_bytes"] = transport.sent_bytes
        steps_of[label] = (pr, state)

    # step, exchange and busy times of the serial decomposition
    pr, state = steps_of["serial"]
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        state = pr.step(state)
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) / reps * 1e3
    p_specs = pr.solver._specs("p")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        exchange_pad(state["p"], (1, 1, 1), p_specs)
    torch.cuda.synchronize()
    out["exchange_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    busy = device_busy(lambda: pr.step(state))
    out["busy"] = {k: busy[k] for k in ("wall_ms", "device_ms",
                                        "busy_share")}

    # the ghost fill: each padded block of the serial fields equals the
    # serial padded global field cut into blocks, bit for bit; strips
    # swapped between the sides must fail the same comparison
    whole = NavierStokes3D(dataclasses.replace(pr.solver.config,
                                               decomposition=()), dev)
    drv = pr.solver.driver
    sl = drv.block_slices()[0]
    out["ghost_fill_bitwise"], out["planted_rejected"] = {}, {}
    for f in DECOMP_FIELDS:
        glob = exchange_pad(serial[f].to(dev), (1, 1, 1), whole._specs(f))
        want = glob[sl.start:sl.stop + 2]
        block = drv.scatter(serial[f])
        specs = pr.solver._specs(f)
        got = exchange_pad(block, (1, 1, 1), specs)
        out["ghost_fill_bitwise"][f] = bool(torch.equal(got, want))
        link = specs[0].link
        bad_specs = (dataclasses.replace(specs[0], link=dataclasses.replace(
            link, transport=_swapped_transport())), *specs[1:])
        bad = exchange_pad(block, (1, 1, 1), bad_specs)
        # a field that is zero on the block (vz, in the z-invariant
        # cavity) moves nothing whichever side its strips land on
        if bool(block.abs().max() > 0):
            out["planted_rejected"][f] = not torch.equal(bad, want)
    return out


def _mesh_recovery(dev, crash_path: str) -> dict:
    """The crash's jobs recovered by a meshed runtime on the crash store
    and drained; then the uninterrupted meshed run of the same requests
    beside the planted fault (the evicted job rerun from its payload, its
    snapshot ignored but its step0 kept).  Fields on global rank 0."""
    import dataclasses

    import torch
    import torch.distributed as dist

    rank = dist.get_rank()
    out = {}
    reset_counts()
    t0 = time.perf_counter()
    crt = _decomposed_runtime(dev, (2, 2), ("slot", "shard"), n_slots=2,
                              store={"path": crash_path, "ttl_s": 30.0})
    out["recovered_rows"] = [(j.job_id, j.tag, j.status)
                             for j in crt.jobs()]
    crt.drain()
    torch.cuda.synchronize()
    out["recover_and_drain_s"] = time.perf_counter() - t0
    out["recover_launches"] = read_counts()
    out["recover_device_steps"] = crt.device_steps()
    out["crash_rows"] = [(j.job_id, j.tag, j.status, j.steps_done)
                         for j in crt.jobs()]
    job_of = {tag: jid for jid, tag, _ in out["recovered_rows"]}
    recovered = {tag: crt.load_result(jid) for tag, jid in job_of.items()}
    victim = job_of[f"crash{CRASH_EVICT}"]
    snap = crt.store.latest_snapshot(victim, "evict")
    payload = crt.store.get(victim).request()
    out["snapshot_step0"] = snap["steps_done"]
    del crt

    urt = _decomposed_runtime(dev, (2, 2), ("slot", "shard"), n_slots=2)
    usids = {f"crash{i}": urt.submit("cavity", re=re, steps=CRASH_STEPS)
             for i, re in enumerate(CRASH_RES)}
    usvc = urt.services()[0]
    fault = usvc.submit(dataclasses.replace(payload,
                                            step0=snap["steps_done"]))
    reset_counts()
    uout = urt.drain()
    torch.cuda.synchronize()
    out["uninterrupted_launches"] = read_counts()
    out["uninterrupted_device_steps"] = urt.device_steps()
    out["recovered_bitwise"], out["fault"] = {}, {}
    if rank == 0:
        for tag, sid in usids.items():
            out["recovered_bitwise"][tag] = all(
                torch.equal(recovered[tag][f], uout[sid].state[f])
                for f in DECOMP_FIELDS)
        good = uout[usids[f"crash{CRASH_EVICT}"]].state
        bad = usvc.farm.results[fault].state
        out["fault"] = {
            "rejected": any(not torch.equal(bad[f], good[f])
                            for f in DECOMP_FIELDS),
            "max_abs_diff": max(float((bad[f] - good[f]).abs().max())
                                for f in DECOMP_FIELDS)}
    del urt, uout, recovered
    return out


def _mesh_store_farm(dev, results: dict, sids: list) -> dict:
    """The five requests again through a store-backed mesh with
    telemetry, health and ``ckpt_dir`` on, the same eviction a store
    snapshot: held to the store-less drive's ``results`` on rank 0."""
    import torch
    import torch.distributed as dist

    rank = dist.get_rank()
    out = {}
    part = os.path.join(STORE_DIR, "farm")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srt = _decomposed_runtime(dev, (2, 2), ("slot", "shard"),
                              n_slots=FARM_SLOTS, telemetry=True,
                              health=True, ckpt_dir=part, store=True)
    reset_counts()
    t0 = time.perf_counter()
    ssids = [srt.submit("cavity", steps=steps, re=re)
             for re, steps in zip(FARM_RES, FARM_STEPS)]
    svc = srt.services()[0]
    svc.run(EVICT_AT)
    require(srt.evict(ssids[EVICT]), "store farm: evict refused")
    out["evicted_poll"] = srt.poll(ssids[EVICT])
    require(srt.readmit(ssids[EVICT]), "store farm: readmit refused")
    sres = srt.drain()
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = read_counts()
    out["device_steps"] = srt.device_steps()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["meta"] = {sid: (sres[sid].steps_done, sres[sid].terminated)
                   for sid in ssids}
    out["job_ids"] = [srt.job_id(sid) for sid in ssids]
    out["rows"] = [(j.job_id, j.status, j.steps_done) for j in srt.jobs()]
    out["polls"] = [srt.poll(sid) for sid in ssids]
    timers = srt.telemetry.timers.snapshot()
    for key, name in (("spill", "service.evict_spill"),
                      ("restore", "service.readmit_restore")):
        node = timers.get(name, {})
        out[f"{key}_ms"] = node.get("total_s", 0.0) * 1e3
        out[f"{key}s"] = node.get("count", 0)
    out["bitwise"] = out["load_result_bitwise"] = None
    loaded = {sid: srt.load_result(jid)
              for sid, jid in zip(ssids, out["job_ids"])}
    if rank == 0:
        out["bitwise"] = all(
            torch.equal(sres[a].state[f], results[b].state[f])
            for a, b in zip(ssids, sids) for f in DECOMP_FIELDS)
        out["load_result_bitwise"] = all(
            torch.equal(loaded[sid][f], sres[sid].state[f])
            for sid in ssids for f in DECOMP_FIELDS)
    out["holds_store"] = srt.store.local is not None
    out["owner"] = srt.store.owner
    out["open_store_files"] = _open_files_under(STORE_DIR)
    del srt, sres, loaded
    return out


def decomposed_farm_rank(serial_path: str, crash_path: str) -> dict:
    """One of four ranks on (slot 2, shard 2): first the crash's jobs
    recovered from its store and drained (``_mesh_recovery``); then the
    farm phase's five requests at 256^3 through four slots, one evicted
    and readmitted; the first shard group runs each request serially,
    decomposed the same way, and global rank 0 holds the farm's result
    to it; then the five again through a store-backed mesh
    (``_mesh_store_farm``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.cfd.ns3d import NavierStokes3D

    dev = _rank_device()
    rank = dist.get_rank()
    out = {"rank": rank, "durable_mesh": _mesh_recovery(dev, crash_path)}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rt = _decomposed_runtime(dev, (2, 2), ("slot", "shard"),
                             n_slots=FARM_SLOTS)
    reset_counts()
    t0 = time.perf_counter()
    sids = [rt.submit("cavity", steps=steps, re=re)
            for re, steps in zip(FARM_RES, FARM_STEPS)]
    svc = rt.services()[0]
    svc.run(EVICT_AT)
    require(rt.evict(sids[EVICT]), "evict refused")
    require(rt.poll(sids[EVICT])["status"] == "evicted", "not evicted")
    require(rt.readmit(sids[EVICT]), "readmit refused")
    results = rt.drain()
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = read_counts()
    out["device_steps"] = rt.device_steps()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["local_slots"] = list(svc.farm.exec.local_slots)
    transport = svc.farm.exec.solver.driver.transport
    out["shard_index"] = int(rt.mesh.get_coordinate()[1])
    out["farm_bytes"] = transport.permute_operand_bytes
    out["farm_sent_bytes"] = transport.sent_bytes
    out["meta"] = {sid: (results[sid].steps_done, results[sid].terminated)
                   for sid in sids}
    # the serial decomposed run of each request on the first shard group
    shard = rt.mesh["shard"]
    out["bitwise_vs_serial"] = {}
    if rt.mesh.get_coordinate()[0] == 0:
        for sid, re, steps in zip(sids, FARM_RES, FARM_STEPS):
            solver = NavierStokes3D(rt.configure("cavity", re=re), dev, shard)
            state, step = solver.init_state(), solver.make_step()
            for _ in range(steps):
                state = step(state)
            for f in DECOMP_FIELDS:
                whole = solver.driver.gather(state[f])
                if rank == 0:
                    got = results[sid].state[f]
                    out["bitwise_vs_serial"][f"{sid}/{f}"] = (
                        bool(torch.equal(got, whole)),
                        float((got - whole).abs().max()))
    out["durable_mesh"]["store_farm"] = _mesh_store_farm(dev, results, sids)
    return out


def nccl_self_rank() -> dict:
    """World size 1 under NCCL: a periodic axis decomposed over a
    one-rank mesh axis exchanges its strips with itself through NCCL; the
    pad must equal the plain periodic pad bitwise."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.halo import (
        AxisLink, AxisSpec, P2PTransport, exchange_pad,
    )
    from repro_torch.launch.mesh import make_mesh

    dev = _rank_device()
    mesh = make_mesh((1,), ("x",))
    transport = P2PTransport()
    link = AxisLink.from_mesh(mesh, "x", transport)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    u = torch.randn((64, 96, 32), generator=gen, device=dev)
    plain = [AxisSpec(array_axis=a, periodic=True) for a in range(3)]
    over = [AxisSpec(array_axis=0, mesh_axis="x", periodic=True, link=link),
            *plain[1:]]
    got = exchange_pad(u, (2, 1, 1), over)
    want = exchange_pad(u, (2, 1, 1), plain)
    torch.cuda.synchronize()
    return {"backend": dist.get_backend(), "bitwise": bool(torch.equal(got, want)),
            "permute_operand_bytes": transport.permute_operand_bytes,
            "sent_bytes": transport.sent_bytes}


def nccl_two_ranks_rank() -> float:
    """One of two NCCL ranks on one card: a first collective, which NCCL is
    expected to refuse (a duplicate device in one communicator)."""
    import torch
    import torch.distributed as dist

    t = torch.ones(1, device=_rank_device())
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return float(t)


def nccl_two_ranks_on_one_card(device: str) -> dict:
    """Why ranks that share the card use gloo: two NCCL ranks on it, and
    the lines of the error that ends the launch (recorded, not required:
    it probes the library, not the port)."""
    from repro_torch.launch.mesh import RankFailed, spawn

    try:
        sums = spawn(nccl_two_ranks_rank, 2, backend="nccl", device=device,
                     timeout_s=NCCL_PROBE_S)
    except RankFailed as e:
        keep = ("Duplicate GPU", "ncclInvalidUsage", "Error", "deadline",
                "exited with code")
        lines = [ln.strip() for ln in str(e).splitlines()
                 if any(k in ln for k in keep)]
        return {"refused": True, "message": lines[:6]}
    return {"refused": False, "sums": sums}


def durable_mesh_crash(device: str) -> dict:
    """The crash launch: ``decomposed_crash_rank`` in 4 gloo ranks on
    ``device``, which must end in ``RankFailed`` with rank 0's kill; the
    store's rows and leases as a restart finds them, once the leases
    have lapsed."""
    from repro_torch.jobs import JobStore
    from repro_torch.launch.mesh import RankFailed, spawn

    shutil.rmtree(STORE_DIR, ignore_errors=True)
    crash_path = os.path.join(STORE_DIR, "crash", "jobs.sqlite")
    marker = os.path.join(STORE_DIR, "crash", "killed.json")
    t0 = time.perf_counter()
    try:
        spawn(decomposed_crash_rank, 4, backend="gloo", device=device,
              args=(crash_path, marker), timeout_s=DECOMP_TIMEOUT_S)
        crash_end = None
    except RankFailed as e:
        crash_end = str(e).splitlines()[0]
    crash_s = time.perf_counter() - t0
    require(crash_end is not None and os.path.exists(marker),
            f"the crash launch ended {crash_end!r} without rank 0's kill")
    with open(marker) as f:
        killed = json.load(f)
    require(killed["loaded"] == [],
            f"the crash ranks loaded {killed['loaded']}")
    probe = JobStore(crash_path)
    at_restart = {j.tag: (j.status, probe.lease_of(j.job_id))
                  for j in probe.jobs()}
    crash_seq = probe.last_seq()
    probe.close()
    statuses = {tag: st for tag, (st, _) in at_restart.items()}
    require(statuses.get(f"crash{CRASH_EVICT}") == "evicted"
            and set(statuses.values()) <= {"running", "evicted"}
            and len(statuses) == len(CRASH_RES)
            and all(lease is not None for _, lease in at_restart.values()),
            f"the crash store at restart: {at_restart}")
    lapse = max(lease["expires_at"] for _, lease in at_restart.values())
    time.sleep(max(lapse - time.time(), 0.0) + 0.1)
    return {"path": crash_path, "seq": crash_seq, "launch_s": crash_s,
            "ended": crash_end, "polls_at_kill": killed["polls"],
            "statuses_at_restart": statuses}


def durable_mesh_checks(farm: list, crash: dict, smi: str) -> dict:
    """Hold the farm launch's ``durable_mesh`` reports to their contract
    (every drive's launches ``device_steps x PER_STEP``; the store-backed
    drive's equal to the store-less one's; the same rows, ids, polls and
    owner on every rank; the store open on rank 0 alone; recovery bitwise
    with one ``result`` event and one admission a job; the planted fault
    rejected) and return the phase line's ``durable_mesh`` section."""
    from repro_torch.jobs import JobStore

    head = farm[0]
    for r in farm:
        steps = r["device_steps"]
        dm = r["durable_mesh"]
        for drive in ("recover", "uninterrupted"):
            n = dm[f"{drive}_device_steps"]
            got = {k: v for k, v in dm[f"{drive}_launches"].items() if v}
            require(got == {k: n * v for k, v in PER_STEP.items() if v},
                    f"farm rank {r['rank']}: {drive} launches {got} over "
                    f"{n} steps")
        sf = dm["store_farm"]
        require(sf["launches"] == r["launches"]
                and sf["device_steps"] == steps,
                f"farm rank {r['rank']}: store-backed launches "
                f"{sf['launches']} != the store-less {r['launches']}")
        require(sf["meta"] == r["meta"], f"rank {r['rank']} store metadata")
        require(sf["spills"] == 1 and sf["restores"] == 1,
                f"rank {r['rank']}: {sf['spills']} spills, "
                f"{sf['restores']} restores")
        for key in ("job_ids", "rows", "polls", "evicted_poll", "owner"):
            require(sf[key] == head["durable_mesh"]["store_farm"][key],
                    f"rank {r['rank']}: store {key} {sf[key]}")
        for key in ("recovered_rows", "crash_rows", "snapshot_step0"):
            require(dm[key] == head["durable_mesh"][key],
                    f"rank {r['rank']}: {key} {dm[key]}")
        require(sf["holds_store"] == (r["rank"] == 0)
                and bool(sf["open_store_files"]) == (r["rank"] == 0),
                f"rank {r['rank']}: holds the store {sf['holds_store']}, "
                f"open {sf['open_store_files']}")
    dm, sf = head["durable_mesh"], head["durable_mesh"]["store_farm"]
    require(sf["bitwise"] and sf["load_result_bitwise"],
            f"store farm: bitwise {sf['bitwise']}, load_result "
            f"{sf['load_result_bitwise']}")
    require([row[1] for row in sf["rows"]] == ["done"] * len(FARM_RES)
            and sf["evicted_poll"]["status"] == "evicted",
            f"store farm rows {sf['rows']}")
    require(len(dm["recovered_bitwise"]) == len(CRASH_RES)
            and all(dm["recovered_bitwise"].values()),
            f"recovery vs the uninterrupted run: {dm['recovered_bitwise']}")
    require(dm["fault"]["rejected"],
            f"a recovery ignoring the snapshot passed: {dm['fault']}")
    require([row[2] for row in dm["crash_rows"]] == ["done"] * len(CRASH_RES),
            f"crash rows after recovery {dm['crash_rows']}")
    probe = JobStore(crash["path"])
    result_events = {j.tag: len(probe.events(j.job_id, event="result"))
                     for j in probe.jobs()}
    admits = {j.tag: len([e for e in probe.events(j.job_id,
                                                  after_seq=crash["seq"])
                          if e["event"] == "admit"]) for j in probe.jobs()}
    seq = crash["seq"]
    owners = [{e["owner"] for e in probe.events() if keep(e["seq"])}
              for keep in (lambda q: q <= seq, lambda q: q > seq)]
    probe.close()
    require(set(result_events.values()) == {1} and set(admits.values()) == {1}
            and [len(o) for o in owners] == [1, 1],
            f"crash store: result events {result_events}, admits after "
            f"the crash {admits}, owners {owners}")
    crash = {k: v for k, v in crash.items() if k not in ("path", "seq")}
    stores = [r["durable_mesh"]["store_farm"] for r in farm]
    return {
        "card": smi, "mesh": {"slot": 2, "shard": 2},
        "crash": dict(crash, ranks=4, slots=2, requests=len(CRASH_RES),
                      steps=CRASH_STEPS, leases_lapsed=True),
        "recovery": {
            "recover_and_drain_s_per_rank": [
                r["durable_mesh"]["recover_and_drain_s"] for r in farm],
            "device_steps": dm["recover_device_steps"],
            "snapshot_step0": dm["snapshot_step0"],
            "bitwise_vs_uninterrupted": dm["recovered_bitwise"],
            "result_events": result_events,
            "admits_after_crash": admits,
            "fault_ignoring_snapshot": dm["fault"]},
        "store_farm": {
            "telemetry": True, "health": True, "ckpt_dir": True,
            "bitwise_vs_storeless": sf["bitwise"],
            "load_result_bitwise": sf["load_result_bitwise"],
            "launches_equal_per_rank": True,
            "device_steps": sf["device_steps"], "rows": sf["rows"],
            "wall_s_per_rank": [x["wall_s"] for x in stores],
            "storeless_wall_s_per_rank": [r["wall_s"] for r in farm],
            "evict_spill_ms_per_rank": [x["spill_ms"] for x in stores],
            "readmit_restore_ms_per_rank": [x["restore_ms"]
                                            for x in stores],
            "store_open_on_rank_0_only": True,
            "max_memory_allocated_per_rank": [
                x["max_memory_allocated"] for x in stores]},
    }


def phase_decomposed(dev, smi: str, serial_state: dict) -> dict:
    """The grid split over ranks that share the card (gloo, ghost strips
    through pinned host memory): the serial 256^3 cavity on 2 ranks
    against the main phase's serial state, the ghost fill, the slots x
    shards farm on 4 ranks against serial decomposed runs, the exchange
    bytes against ``halo_bytes_per_step``, and NCCL at world size 1."""
    import torch
    from repro_torch.cfd import cavity
    from repro_torch.launch.mesh import spawn
    from repro_torch.obs import perf

    t_phase = time.perf_counter()
    os.makedirs(DECOMP_DIR, exist_ok=True)
    serial_path = os.path.join(DECOMP_DIR, "serial.pt")
    torch.save({f: serial_state[f] for f in DECOMP_FIELDS}, serial_path)
    torch.cuda.empty_cache()

    # the bytes the analytic model gives these drives, and the op-cost
    # trace's count with the count transport, before any rank runs
    cfgs = {"serial": (cavity.config(N, nz=N, decomposition=DECOMP),
                       {"shard": 2}, 1),
            "fused": (cavity.config(N, nz=N, decomposition=DECOMP,
                                    fused_sweeps=FUSED_K), {"shard": 2}, 1),
            "farm": (cavity.config(N, nz=N, decomposition=DECOMP),
                     {"slot": 2, "shard": 2}, FARM_SLOTS)}
    traced, traced_sent = {}, {}
    for label, (cfg, ext, slots) in cfgs.items():
        analytic = perf.halo_bytes_per_step(
            cfg, dict(DECOMP), ext,
            slots_local=perf._slots_local(slots, ext.get("slot", 1)))
        require(analytic == DECOMP_BYTES[label],
                f"{label}: halo_bytes_per_step {analytic} != "
                f"{DECOMP_BYTES[label]}")
        counts, _ = perf.decomposed_step_hlo(
            cfg, n_slots=slots, mesh_axes=tuple({"slot": 1, **ext}.items()))
        traced[label] = counts["permute_operand_bytes"]
        traced_sent[label] = counts["sent_bytes"]
        require(traced[label] == analytic,
                f"{label}: traced exchange bytes {traced[label]} != "
                f"{analytic}")

    device = f"cuda:{dev.index or 0}"
    t0 = time.perf_counter()
    serial = spawn(decomposed_serial_rank, 2, backend="gloo", device=device,
                   args=(serial_path,), timeout_s=DECOMP_TIMEOUT_S)
    serial_s = time.perf_counter() - t0
    expected = {k: STEPS * v for k, v in PER_STEP.items()}
    expected_fused = {k: STEPS * v for k, v in PER_STEP_FUSED.items()}
    for r in serial:
        launches = {k: v for k, v in r["launches"].items() if v}
        fused = {k: v for k, v in r["fused_launches"].items() if v}
        require(launches == {k: v for k, v in expected.items() if v},
                f"rank {r['rank']}: launch counts {launches} != {expected}")
        require(fused == {k: v for k, v in expected_fused.items() if v},
                f"rank {r['rank']}: fused launch counts {fused}")
        for f, d in r["max_abs_diff"].items():
            require(d <= DECOMP_RTOL, f"rank {r['rank']}: {f} differs from "
                    f"the serial cuda run by {d} > {DECOMP_RTOL}")
        require(all(r["ghost_fill_bitwise"].values()),
                f"rank {r['rank']}: ghost fill {r['ghost_fill_bitwise']}")
        require(r["planted_rejected"] and all(r["planted_rejected"].values()),
                f"rank {r['rank']}: swapped strips passed the check "
                f"{r['planted_rejected']}")
        require(r["serial_step_bytes"] == DECOMP_BYTES["serial"],
                f"rank {r['rank']}: {r['serial_step_bytes']} B a step")
        require(r["fused_step_bytes"] == DECOMP_BYTES["fused"],
                f"rank {r['rank']}: {r['fused_step_bytes']} B a fused step")
        require(r["backend"] == "gloo", f"backend {r['backend']}")
    # what crossed: rank 0 sends what the trace at index 0 sends, and the
    # two ranks together send one rank's operands (each strip toward the
    # wall has no receiver)
    for label in ("serial", "fused"):
        sent = [r[f"{label}_step_sent_bytes"] for r in serial]
        require(sent[0] == traced_sent[label],
                f"{label}: rank 0 sent {sent[0]} B, the trace {traced_sent[label]}")
        require(sum(sent) == DECOMP_BYTES[label] and min(sent) > 0,
                f"{label}: the ranks sent {sent} B, not {DECOMP_BYTES[label]}")

    # the job store on the mesh: a store-backed farm killed after its
    # first snapshot; the farm launch recovers its jobs first
    crash = durable_mesh_crash(device)

    t0 = time.perf_counter()
    farm = spawn(decomposed_farm_rank, 4, backend="gloo", device=device,
                 args=(serial_path, crash["path"]),
                 timeout_s=DECOMP_TIMEOUT_S)
    farm_s = time.perf_counter() - t0
    head = farm[0]
    for r in farm:
        steps = r["device_steps"]
        want = {k: steps * v for k, v in PER_STEP.items() if v}
        got = {k: v for k, v in r["launches"].items() if v}
        require(got == want, f"farm rank {r['rank']}: launches {got} != {want}")
        require(r["farm_bytes"] == steps * DECOMP_BYTES["farm"],
                f"farm rank {r['rank']}: {r['farm_bytes']} B over {steps} "
                "steps")
        require(r["meta"] == head["meta"], f"rank {r['rank']} metadata")
        if r["shard_index"] == 0:
            require(r["farm_sent_bytes"] == steps * traced_sent["farm"],
                    f"farm rank {r['rank']}: sent {r['farm_sent_bytes']} B")
    for line in ((0, 1), (2, 3)):          # each slot rank's shard line
        sent = [farm[i]["farm_sent_bytes"] for i in line]
        require(sum(sent) == farm[line[0]]["farm_bytes"],
                f"farm ranks {line}: sent {sent} B")
    for sid, steps in zip(head["meta"], FARM_STEPS):
        require(tuple(head["meta"][sid]) == (steps, "steps"),
                f"farm sid {sid}: {head['meta'][sid]}")
    require(len(head["bitwise_vs_serial"]) == len(FARM_STEPS) * 4
            and all(ok for ok, _ in head["bitwise_vs_serial"].values()),
            f"farm vs serial decomposed: {head['bitwise_vs_serial']}")

    durable_mesh = durable_mesh_checks(farm, crash, smi)
    durable_mesh["farm_launch_s"] = farm_s

    nccl = spawn(nccl_self_rank, 1, backend="nccl", device=device,
                 timeout_s=120.0)[0]
    require(nccl["bitwise"] and nccl["backend"] == "nccl",
            f"NCCL self exchange: {nccl}")
    nccl_shared = nccl_two_ranks_on_one_card(device)

    def drives(r):
        dm = r["durable_mesh"]
        return (r["launches"], dm["recover_launches"],
                dm["uninterrupted_launches"], dm["store_farm"]["launches"])

    launches = {k: sum(r["launches"][k] + r["fused_launches"][k]
                       for r in serial)
                + sum(d[k] for r in farm for d in drives(r))
                for k in serial[0]["launches"]}
    emit({"phase": "decomposed", "card": smi, "grid": [N, N, N],
          "decomposition": [list(p) for p in DECOMP],
          "backend": "gloo (ranks share cuda:0; strips via pinned host)",
          "serial": {
              "ranks": 2, "steps": STEPS, "spawn_s": serial_s,
              "max_abs_diff_vs_serial": {
                  f: max(r["max_abs_diff"][f] for r in serial)
                  for f in DECOMP_FIELDS},
              "tolerance": DECOMP_RTOL, "ghia": serial[0]["ghia"],
              "launches_per_rank": [r["launches"] for r in serial],
              "fused_launches_per_rank": [r["fused_launches"]
                                          for r in serial],
              "step_ms_per_rank": [r["step_ms"] for r in serial],
              "exchange_ms_per_rank": [r["exchange_ms"] for r in serial],
              "busy_per_rank": [r["busy"] for r in serial],
              "run_s_per_rank": [r["run_s"] for r in serial],
              "max_memory_allocated_per_rank": [
                  r["max_memory_allocated"] for r in serial],
              "ghost_fill_bitwise": serial[0]["ghost_fill_bitwise"],
              "planted_swap_rejected": serial[0]["planted_rejected"]},
          "farm": {
              "ranks": 4, "mesh": {"slot": 2, "shard": 2},
              "slots": FARM_SLOTS, "spawn_s": farm_s,
              "device_steps": head["device_steps"],
              "local_slots": [r["local_slots"] for r in farm],
              "wall_s_per_rank": [r["wall_s"] for r in farm],
              "sims_steps_per_s": sum(FARM_STEPS) / head["wall_s"],
              "bitwise_vs_serial_decomposed": True,
              "max_memory_allocated_per_rank": [
                  r["max_memory_allocated"] for r in farm]},
          # the permute operands equal halo_bytes_per_step by the same
          # accounting (an identity, not a measure of traffic); "sent" is
          # what each rank's transport handed to a neighbour
          "permute_operand_bytes_per_step": {
              "analytic": DECOMP_BYTES, "traced_meta": traced,
              "counted_serial": [r["serial_step_bytes"] for r in serial],
              "counted_fused": [r["fused_step_bytes"] for r in serial],
              "counted_farm": [r["farm_bytes"] / r["device_steps"]
                               for r in farm]},
          "sent_bytes_per_step": {
              "traced_meta_index_0": traced_sent,
              "serial": [r["serial_step_sent_bytes"] for r in serial],
              "fused": [r["fused_step_sent_bytes"] for r in serial],
              "farm": [r["farm_sent_bytes"] / r["device_steps"]
                       for r in farm]},
          "nccl_world_size_1": nccl,
          "nccl_two_ranks_one_card": nccl_shared,
          "durable_mesh": durable_mesh,
          "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# sharded: the LM trained over a mesh of ranks that share the card
# ---------------------------------------------------------------------------
# fsdp_tp: zamba2-1.2b at its published widths, 8 of 38 layers (4
# applications of the shared block), seq 2048, global batch 4 over
# (data 2, model 2): two rows a data rank, 16 of 32 heads a model rank
SHARD_ARCH, SHARD_LAYERS, SHARD_SEQ, SHARD_BATCH = "zamba2-1.2b", 8, 2048, 4
SHARD_MESH = ((2, 2), ("data", "model"))
# a rank's launches a step: remat "block" runs each group's forward twice
SHARD_PER_STEP = {"FLASH_ATTENTION": 2 * 4, "SSD_INTRA": 2 * 8}
# dp: xlstm-125m whole, one 512-token sequence a rank, over (pod 2, data 2);
# compressed across pods at the reference's bounds
# (tests/test_dist_equivalence.py)
DP_ARCH, DP_SEQ, DP_MESH = "xlstm-125m", 512, ((2, 2), ("pod", "data"))
EF_LOSS, EF_PARAMS = 1e-4, 5e-3
# the compressed gradient mean against the exact one, relative norm over the
# model: int8 rounds an element within half of max|g| / 127 (about 1% of a
# gradient's norm); a missing scale or a sum for the mean is off by 50% or
# more.  Error feedback's identity (a step given the residual e against the
# same step given none): mean(c) + mean(e_new) - mean(e) = mean(g) =
# mean(c') + mean(e'_new), to rounding and the backward's nondeterminism
# on the card; a residual not added or not returned is off by about the
# quantization error
EF_GRAD_REL, EF_IDENTITY = 5e-2, 1e-4
# GPipe over pod 4: the reference test's toy stack tanh(h @ w) at D 2048,
# at its 2e-4 / 2e-5
GPIPE_L, GPIPE_B, GPIPE_S, GPIPE_D, GPIPE_MB = 8, 8, 16, 2048, 4
GPIPE_RTOL, GPIPE_ATOL = 2e-4, 2e-5
SHARD_DIR = os.path.join(ROOT, "build", "sharded")
SHARD_TIMEOUT_S = 600.0
SHARDED_BUDGET_S = 180.0


def shard_cfg(layers: int = SHARD_LAYERS):
    import dataclasses

    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(SHARD_ARCH), num_layers=layers)


def param_bytes(lm) -> int:
    return sum(p.numel() * p.element_size() for p in lm.parameters())


class planted:
    """Inside the context one fault of the sharded step: ``wo``: the first
    ``wo`` of each forward (the first application of zamba2's shared block)
    keeps its partial sums, no all-reduce over ``tp``; ``divide``: the
    data-axis gradients are summed but not divided by |dp|."""

    def __init__(self, fault: str):
        self.fault = fault

    def __enter__(self):
        from repro_torch.models import blocks
        from repro_torch.train import step as step_lib

        self.saved = (blocks.wo_reduce, step_lib.data_mean)
        if self.fault == "wo":
            calls = []

            def faulty(y, shard):
                calls.append(1)
                return y if len(calls) % (2 * 4) == 1 else \
                    self.saved[0](y, shard)

            blocks.wo_reduce = faulty
        else:
            step_lib.data_mean = lambda grads, shard: None

    def __exit__(self, *exc):
        from repro_torch.models import blocks
        from repro_torch.train import step as step_lib

        blocks.wo_reduce, step_lib.data_mean = self.saved


def _gathered_grads(lm, mesh) -> dict:
    from repro_torch.dist import sharding

    return {n: sharding.full_tensor(p.grad, lm.placement[n], mesh)
            for n, p in lm.named_parameters()}


def _fsdp_model(cfg, shard, dev):
    from repro_torch.dist import sharding
    from repro_torch.models import model

    return sharding.shard_params(model.init_params(cfg, SEED, device=dev),
                                 cfg, shard)


def sharded_fsdp(ref_path: str, dev) -> dict:
    """zamba2's fsdp_tp step on (data 2, model 2) from ``init_params``'
    weights: rank 0 holds the gathered gradient against the single-process
    CUDA step's (saved at ``ref_path``), then the same step with each
    planted fault; launch counts, collective calls and bytes, step and
    busy times, peak memory."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import collectives, sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import step as step_lib

    rank = dist.get_rank()
    cfg = shard_cfg()
    mesh = make_mesh(*SHARD_MESH)
    shard = sharding.make_shard_cfg(mesh, cfg, SHARD_BATCH)
    batch = sharding.local_batch(
        train_batch(cfg, SHARD_SEQ, SHARD_BATCH, dev), mesh, shard)
    ref = torch.load(ref_path, map_location=dev) if rank == 0 else None
    out = {"rank": rank, "coord": collectives.coordinate(mesh)}
    torch.cuda.reset_peak_memory_stats()

    def one_step(fault=None):
        lm = _fsdp_model(cfg, shard, dev)
        opt = AdamW(lr=TRAIN_LR)
        state = opt.init(lm)
        step = step_lib.make_train_step(cfg, shard, opt)
        reset_counts()
        collectives.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if fault is None:
            lm, state, met = step(lm, state, batch)
        else:
            with planted(fault):
                lm, state, met = step(lm, state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts, stats = read_counts(), dict(collectives.STATS)
        grads = _gathered_grads(lm, mesh)
        parity = None
        if rank == 0:
            parity = grad_parity(grads, ref["grads"])
            parity["loss"], parity["ref_loss"] = float(met["loss"]), ref["loss"]
        del grads
        return lm, opt, state, step, ms, counts, stats, parity

    lm, opt, state, step, ms, counts, stats, parity = one_step()
    out.update(first_step_ms=ms, launches=counts, parity=parity,
               collective={"calls": stats["calls"], "bytes": stats["bytes"],
                           "ms": stats["seconds"] * 1e3},
               param_bytes=param_bytes(lm),
               moment_bytes=sum(t.numel() * t.element_size()
                                for d in (state.m, state.v)
                                for t in d.values()))
    # a second step (warm), timed, and a third under the profiler
    collectives.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm, state, _ = step(lm, state, batch)
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    out["collective_warm"] = {"calls": collectives.STATS["calls"],
                              "bytes": collectives.STATS["bytes"],
                              "ms": collectives.STATS["seconds"] * 1e3}
    busy = device_busy(lambda: step(lm, state, batch), cpu_ops=False)
    out["busy"] = {k: busy[k] for k in ("wall_ms", "device_ms", "busy_share",
                                        "flash_attention_ms", "ssd_intra_ms")}
    del lm, opt, state, step
    torch.cuda.empty_cache()
    out["faults"] = {}
    for fault in ("wo", "divide"):
        *_, f_parity = one_step(fault)
        out["faults"][fault] = f_parity
        torch.cuda.empty_cache()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


def rel_norm_error(got: dict, want: dict) -> float:
    """|got - want| / |want| over every tensor of ``want`` together."""
    import torch

    num = sum(float(torch.sum((got[n].double() - w.double()) ** 2))
              for n, w in want.items())
    den = sum(float(torch.sum(w.double() ** 2)) for w in want.values())
    return (num / den) ** 0.5


def step_gradient(opt, m_now: dict, m_before: dict, clip_scale) -> dict:
    """The gradient an AdamW step took, read back from its first moments:
    m_t = b1 · m_(t-1) + (1 - b1) · s_t · g_t, s_t the step's clip scale
    (the compressed mean stays float32, beside the parameters' bf16
    ``.grad``)."""
    return {n: (m.float() - opt.b1 * m_before[n].float())
            / ((1 - opt.b1) * float(clip_scale)) for n, m in m_now.items()}


def sharded_dp(ref_path: str, dev) -> dict:
    """xlstm-125m's dp step on (pod 2, data 2), a row a rank: exact
    (rank 0 holds its gradient against the single-process step on the
    4-row batch, a microbatch a row: ``row_mean_grads``), then compressed
    across pods, two steps, the second also given no residual; the
    compressed gradient mean against the exact one, and error feedback's
    identity at the second step."""
    import copy

    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import collectives, sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import step as step_lib

    rank = dist.get_rank()
    cfg = get_config(DP_ARCH)
    mesh = make_mesh(*DP_MESH)
    shard = sharding.make_shard_cfg(mesh, cfg, 4, mode="dp")
    batch = sharding.local_batch(train_batch(cfg, DP_SEQ, 4, dev), mesh,
                                 shard)
    out = {"rank": rank}
    runs = {}
    for compress in (False, True):
        lm = model.init_params(cfg, SEED, device=dev)
        opt = AdamW(lr=TRAIN_LR)
        state = opt.init(lm)
        step = step_lib._make_dp_train_step(cfg, shard, opt,
                                            compress_pod_grads=compress)
        zeros = {n: torch.zeros_like(m) for n, m in state.m.items()}
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm, state, met = step(lm, state, batch, None) if compress else \
            step(lm, state, batch)
        torch.cuda.synchronize()
        run = {"ms": (time.perf_counter() - t0) * 1e3,
               "launches": read_counts(), "loss": float(met["loss"]),
               "params": {n: p.detach().clone()
                          for n, p in lm.named_parameters()},
               "took": step_gradient(opt, state.m, zeros, met["clip_scale"])}
        del zeros
        if not compress and rank == 0:
            ref = torch.load(ref_path, map_location=dev)
            run["parity"] = grad_parity(
                {n: p.grad for n, p in lm.named_parameters()}, ref["grads"],
                zero=zero_grad_leaves(cfg))
            run["parity"]["ref_loss"] = ref["loss"]
        if compress:
            err = met["ef_err"]
            m1 = {n: m.clone() for n, m in state.m.items()}
            twin = copy.deepcopy((lm, state))
            tlm, tstate, tmet = step(*twin, batch, None)
            lm, state, met2 = step(lm, state, batch, err)
            run["ef_norms"] = [
                float(sum(torch.linalg.vector_norm(e) for e in err.values())),
                float(sum(torch.linalg.vector_norm(e)
                          for e in met2["ef_err"].values()))]
            run["carried_differs"] = any(
                not torch.equal(p, q) for p, q in zip(tlm.parameters(),
                                                      lm.parameters()))
            # the identity: both sides are the pods' mean of the second
            # step's gradient (the residuals averaged over the pods)
            flat = lambda ts: torch.cat([t.float().reshape(-1) for t in ts])
            pods = lambda t: collectives.all_reduce(t, mesh, "pod") / 2
            names = list(m1)
            took = step_gradient(opt, state.m, m1, met2["clip_scale"])
            carried = flat(took[n] for n in names) + pods(
                flat(met2["ef_err"][n] - err[n] for n in names))
            del took
            took = step_gradient(opt, tstate.m, m1, tmet["clip_scale"])
            fresh = flat(took[n] for n in names) + pods(
                flat(tmet["ef_err"][n] for n in names))
            run["ef_identity_rel"] = rel_norm_error({"all": carried},
                                                    {"all": fresh})
            del twin, tlm, tstate, m1, took, carried, fresh
        runs["compressed" if compress else "exact"] = run
        del lm, opt, state
    exact, comp = runs["exact"], runs["compressed"]
    out["exact"] = {k: v for k, v in exact.items()
                    if k not in ("params", "took")}
    out["compressed"] = {k: v for k, v in comp.items()
                         if k not in ("params", "took")}
    out["compressed"]["grad_rel_err"] = rel_norm_error(comp["took"],
                                                       exact["took"])
    out["compressed"]["loss_diff"] = abs(comp["loss"] - exact["loss"])
    out["compressed"]["param_max_abs_diff"] = max(
        float((comp["params"][n].float() - p.float()).abs().max())
        for n, p in exact["params"].items())
    torch.cuda.empty_cache()
    return out


def sharded_gpipe(dev) -> dict:
    """``gpipe_forward`` over pod 4 against the sequential stack."""
    import torch
    from repro_torch.dist import sharding
    from repro_torch.dist.pipeline_parallel import gpipe_forward, stage_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import ModelConfig

    mesh = make_mesh((4,), ("pod",))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ws = torch.randn((GPIPE_L, GPIPE_D, GPIPE_D), generator=gen,
                     device=dev) / GPIPE_D ** 0.5
    x = torch.randn((GPIPE_B, GPIPE_S, GPIPE_D), generator=gen, device=dev)
    cfg = ModelConfig(name="toy", family="dense", num_layers=GPIPE_L,
                      d_model=GPIPE_D, num_heads=16, num_kv_heads=16,
                      d_ff=4 * GPIPE_D, vocab_size=128)
    layer = lambda w, h: torch.tanh(h @ w)
    out = gpipe_forward(cfg, mesh, layer,
                        sharding.block(ws, stage_params(ws, mesh), mesh), x,
                        n_microbatch=GPIPE_MB)
    ref = x
    for i in range(GPIPE_L):
        ref = layer(ws[i], ref)
    err = (out - ref).abs()
    tol = GPIPE_ATOL + GPIPE_RTOL * ref.abs()
    return {"max_abs_err": float(err.max()),
            "within": bool((err <= tol).all())}


# ---------------------------------------------------------------------------
# sharded serving: the same ranks serve zamba2 over (data 2, model 2)
# ---------------------------------------------------------------------------
# zamba2-1.2b at its published widths and SHARD_LAYERS layers (4
# applications of the shared block), bf16, 4 slots of 4,096 positions: a
# rank holds its data index's 2 slots and its model index's 2,048
# positions of every KV cache; prompts of about 400 and 1,500 tokens (in
# model rank 0's half only) and 2,400 and 3,800 (across both halves)
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_NEW = 4, LM_MAX_SEQ, 8
SERVE_PROMPTS = (400, 1500, 2400, 3800)
SERVE_FAULTS = ("unweighted", "every_rank")
SERVE_FAULT_STEPS = 2
SERVE_BUDGET_S = 60.0
# the KV caches a rank holds: 4 applications x (k, v) x 4 slots x 4,096
# positions x 32 heads x 64 x 4 bytes (1,073,741,824 on one process), a
# quarter
SERVE_KV_BYTES = 268_435_456
SERVE_DIR_FILES = ("serve_ref.pt", "serve_caches.pt")


def serve_requests(cfg, new: int | None = None) -> list:
    """The sharded serving requests: SERVE_PROMPTS seeded prompts, ``new``
    (default SERVE_NEW) new tokens each."""
    import numpy as np
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(SEED + 7)
    return [Request(i, rng.integers(0, cfg.vocab_size, size=n),
                    max_new_tokens=new or SERVE_NEW)
            for i, n in enumerate(SERVE_PROMPTS)]


@contextlib.contextmanager
def served(forced=None):
    """Inside the context the engine's ``model.prefill`` and
    ``model.decode_step`` record their logits (float32, on the card) and
    the device-synchronised ms of each prefill; given ``forced`` (a (slots,)
    tensor of tokens a decode step), decode step n's logits come back with
    each slot's forced token on top, so that the engine takes it (teacher
    forcing).  Yields {"prefill": [...], "prefill_ms": [...], "decode":
    [...]}."""
    import torch
    from repro_torch.models import model

    prefill, decode = model.prefill, model.decode_step
    rec = {"prefill": [], "prefill_ms": [], "decode": []}

    def timed_prefill(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(*args, **kw)
        torch.cuda.synchronize()
        rec["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["prefill"].append(logits[:, -1].float())
        return logits, caches

    def forced_decode(*args, **kw):
        logits, caches = decode(*args, **kw)
        rec["decode"].append(logits[:, -1].float())
        if forced is not None:
            tok = forced[len(rec["decode"]) - 1].to(logits.device)
            logits = logits.clone()
            logits[torch.arange(logits.shape[0]), -1, tok] = float("inf")
        return logits, caches

    model.prefill, model.decode_step = timed_prefill, forced_decode
    try:
        yield rec
    finally:
        model.prefill, model.decode_step = prefill, decode


@contextlib.contextmanager
def serve_fault(fault: str):
    """Inside the context one fault of the meshed decode: ``unweighted``:
    the ranks' partials averaged without their log-sum-exp weights;
    ``every_rank``: the new token's k and v written on every ``tp`` rank
    (a rank that does not hold the position writes the nearest one of its
    block)."""
    import torch
    from repro_torch.models import blocks

    saved = (blocks.merge_partials, blocks.kv_owner)
    if fault == "unweighted":
        blocks.merge_partials = lambda outs, lses: outs.float().mean(0).to(
            outs.dtype)
    else:
        blocks.kv_owner = lambda pos, kv_block, size: (
            torch.ones_like(pos, dtype=torch.bool) if torch.is_tensor(pos)
            else True)
    try:
        yield
    finally:
        blocks.merge_partials, blocks.kv_owner = saved


def serving_reference(dev) -> dict:
    """The single-process CUDA engine on the sharded serving requests: its
    prefill and decode-step logits, its tokens (a (slots,) tensor a step),
    its outputs, and its final caches (saved apart: 1 GB)."""
    import torch
    from repro_torch.dist import sharding
    from repro_torch.models import model
    from repro_torch.serve.engine import ServingEngine

    cfg = shard_cfg()
    lm = model.init_params(cfg, SEED, device=dev)
    eng = ServingEngine(cfg, lm, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                        device=dev, backend="cuda")
    for r in serve_requests(cfg):
        eng.submit(r)
    with served() as rec:
        while eng.step():
            pass
    torch.cuda.synchronize()
    ref = {"prefill": [t.cpu() for t in rec["prefill"]],
           "decode": [t.cpu() for t in rec["decode"]],
           "tokens": [t.argmax(dim=-1).cpu() for t in rec["decode"]],
           "outputs": {r.rid: r.output for r in eng.finished},
           "kv_bytes": sum(t.numel() * t.element_size()
                           for t in sharding.tree_leaves(eng.caches["attn"]))}
    paths = [os.path.join(SHARD_DIR, f) for f in SERVE_DIR_FILES]
    torch.save(ref, paths[0])
    torch.save([t.cpu() for t in sharding.tree_leaves(eng.caches)],
               paths[1])
    del eng, lm
    torch.cuda.empty_cache()
    return {"paths": paths, "kv_bytes": ref["kv_bytes"],
            "outputs": ref["outputs"]}


def serve_cache_errors(caches, ref_leaves, cfg, shard, upto=None) -> list:
    """Each cache leaf of this rank against the matching block of the
    single-process engine's: max|diff| over LM_PARITY_RTOL * max|block|.
    ``upto`` (a run cut short): only the KV caches, at each slot's
    positions below ``upto[slot]``."""
    import torch
    from repro_torch.dist import sharding

    shares = []
    rows = sharding.local_rows(SERVE_SLOTS, shard)
    for j, (mine, whole) in enumerate(zip(sharding.tree_leaves(caches),
                                          ref_leaves)):
        kv = whole.dim() == 5
        if upto is not None and not kv:
            continue
        spec = sharding.cache_spec_tree(whole, cfg, shard.mesh, shard)
        want = sharding.block(whole, spec, shard.mesh).to(mine.device)
        diff = (mine.float() - want.float()).abs()
        if upto is not None:
            pos = torch.arange(mine.shape[2], device=mine.device)
            start = 0 if spec[2] is None else \
                sharding.kv_block(cfg, SERVE_MAX_SEQ, shard).start
            lim = torch.tensor(upto[rows], device=mine.device)
            keep = (pos[None] + start) < lim[:, None]           # (rows, S)
            diff = diff * keep[None, :, :, None, None]
        # a block nothing was written to holds zeros on both sides
        scale = max(float(want.float().abs().max()), 1e-30)
        shares.append(float(diff.max()) / (LM_PARITY_RTOL * scale))
        del want, diff
    return shares


def serve_logit_shares(rec, ref, rows) -> dict:
    """The recorded logits against the single-process engine's: each
    row's max|diff| over LM_PARITY_RTOL * max|row|, the worst of the
    prefills (this rank's slots) and of the decode steps (every slot)."""
    def share(got, want):
        want = want.to(got.device)
        tol = LM_PARITY_RTOL * want.abs().amax(dim=-1)
        return float(((got - want).abs().amax(dim=-1) / tol).max())

    pre = [share(g, w) for g, w in zip(rec["prefill"],
                                       ref["prefill"][rows])]
    dec = [share(g, w) for g, w in zip(rec["decode"], ref["decode"])]
    return {"prefill": max(pre, default=0.0), "decode": max(dec),
            "decode_by_step": dec}


def fault_share(res: dict) -> float:
    """A faulty run's largest share of its tolerance: the decode logits'
    or a KV cache block's (above 1: the check rejects it)."""
    return max([res["logit_shares"], *res["cache_shares"]])


def sharded_serve(ref_paths: list, dev) -> dict:
    """zamba2 through ``ServingEngine(shard=make_shard_cfg(mesh, cfg, 4))``
    over (data 2, model 2) on this rank: teacher-forced on the
    single-process engine's tokens, its logits and its cache blocks held
    against that engine's; launch counts, prefill and decode-step times,
    collectives a decode step, busy share, KV bytes held and peak memory;
    then a free run (its tokens against the single process's), and each
    planted fault, teacher-forced for SERVE_FAULT_STEPS steps."""
    import numpy as np
    import torch
    from repro_torch.dist import collectives, sharding
    from repro_torch.kernels import attention_cuda as ac
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.serve.engine import ServingEngine, _bucket

    t_job = time.perf_counter()
    cfg = shard_cfg()
    mesh = make_mesh(*SHARD_MESH)
    shard = sharding.make_shard_cfg(mesh, cfg, SERVE_SLOTS)
    ref = torch.load(ref_paths[0])
    ref_leaves = torch.load(ref_paths[1], mmap=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = model.init_params(cfg, SEED, device=dev)

    def engine(new=None):
        eng = ServingEngine(cfg, lm, slots=SERVE_SLOTS,
                            max_seq=SERVE_MAX_SEQ, shard=shard, device=dev,
                            backend="cuda")
        for r in serve_requests(cfg, new):
            eng.submit(r)
        return eng

    eng = engine()
    rows = eng.rows
    reset_counts()
    steps, stats = [], []
    with served(ref["tokens"]) as rec:
        while True:
            collectives.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            admitting = eng.table.n_queued
            if not eng.step():
                break
            torch.cuda.synchronize()
            steps.append(((time.perf_counter() - t0) * 1e3, admitting))
            stats.append(dict(collectives.STATS))
    launches, routes = read_counts(), dict(ac.ROUTE_LAUNCHES)
    n_pre, n_dec = len(rec["prefill"]), eng.steps
    logit = serve_logit_shares(rec, ref, slice(rows.start, rows.stop))
    cache = serve_cache_errors(eng.caches, ref_leaves, cfg, shard)
    kv_bytes = sum(t.numel() * t.element_size() for t in
                   sharding.tree_leaves(eng.caches["attn"]))
    decode_ms = sorted(ms for ms, adm in steps if not adm)
    quiet = [st for (ms, adm), st in zip(steps, stats) if not adm]
    buckets = [_bucket(n) for n in SERVE_PROMPTS[rows.start:rows.stop]]
    out = {"rank": torch.distributed.get_rank(),
           "coord": collectives.coordinate(mesh),
           "rows": [rows.start, rows.stop], "kv_block": list(eng.kv_block),
           "launches": launches, "routes": routes, "prefills": n_pre,
           "decode_steps": n_dec,
           "expected": {"FLASH_ATTENTION": 4 * (n_pre + n_dec),
                        "SSD_INTRA": SHARD_LAYERS * n_pre,
                        "tensor_core_prefill": 4 * n_pre,
                        "split_k_decode": 4 * n_dec, "cuda_core": 0},
           "logit_shares": logit, "cache_shares": cache,
           "prefill_ms_by_bucket": dict(zip(buckets, rec["prefill_ms"])),
           "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
           "decode_step_ms": decode_ms,
           "collective_decode_step": {
               "calls": quiet[-1]["calls"], "bytes": quiet[-1]["bytes"],
               "ms": quiet[-1]["seconds"] * 1e3},
           "kv_bytes": kv_bytes}
    del eng
    torch.cuda.empty_cache()
    # the free run, one decode step of it under the profiler
    eng = engine()
    eng.step()
    for _ in range(3):
        eng.step()
    busy = device_busy(eng.step, cpu_ops=False)
    eng.run_until_drained()
    got = {r.rid: r.output for r in eng.finished}
    pairs = [(a, b) for rid, want in ref["outputs"].items()
             for a, b in zip(got[rid], want)]
    out["free_run_token_agreement"] = sum(a == b for a, b in pairs) / len(
        pairs)
    out["busy"] = {k: busy[k] for k in ("wall_ms", "device_ms", "busy_share",
                                        "flash_attention_ms")}
    del eng
    torch.cuda.empty_cache()
    # each planted fault, teacher-forced for its first steps
    upto = np.array(SERVE_PROMPTS) + SERVE_FAULT_STEPS - 1
    out["faults"] = {}
    for fault in SERVE_FAULTS:
        eng = engine(SERVE_FAULT_STEPS)
        with serve_fault(fault), served(ref["tokens"]) as frec:
            eng.run_until_drained()
        out["faults"][fault] = {
            "logit_shares": serve_logit_shares(
                frec, ref, slice(rows.start, rows.stop))["decode"],
            "cache_shares": serve_cache_errors(eng.caches, ref_leaves, cfg,
                                               shard, upto)}
        del eng
        torch.cuda.empty_cache()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t_job
    return out


# ---------------------------------------------------------------------------
# the sequence-parallel postures in the same ranks
# ---------------------------------------------------------------------------
# ssm_sp: the fsdp job's drive (zamba2-1.2b, 8 layers, seq 2,048, global
# batch 4 over (data 2, model 2)) with each Mamba2 block sequence-parallel
# over model: a rank's Mamba2 layers see its 2 rows x 1,024 tokens; held
# against the fsdp job's single-process reference at the same bounds
SSM_SP_FAULTS = ("no_halo", "no_relay")
# a2a: qwen3-moe-235b-a22b at its published widths, 1 of 94 layers, no
# load-balance term (its gradient is the per-block mean under a2a, the
# batch's under tp), and the capacity factor E/k = 16: each expert's
# capacity then holds every token, so no assignment drops whatever the
# routing, and a2a and tp compute one function (at the reference's 8 the
# a2a blocks dropped 0.125% of their assignments at random init: a token
# repeated through a block sends its k rows to the same experts).  The
# drive is layer 0's MoE alone (router and experts under the fsdp_tp
# placements, forward and backward through moe_apply) at seq 1,024 and
# global batch 4, reckoned first on a (2, 2) counting mesh: the meshed
# dry run reckons the 1-layer fsdp_tp step at seq 2,048 and 1,024
# beyond the card with four ranks on it
A2A_ARCH = "qwen3-moe-235b-a22b"
A2A_CF = 16.0
A2A_SEQ, A2A_BATCH = 1024, 4
A2A_FAULTS = ("return_order",)
# each rank's CUDA context beside its tensors, and the spare kept
A2A_CONTEXT_BYTES, A2A_SPARE = 0.6e9, 1.1
# the MoE alone launches no kernel of the port
A2A_LAUNCHES = {"FLASH_ATTENTION": 0, "SSD_INTRA": 0}
SP_BUDGET_S = 90.0


def a2a_cfg(**kw):
    import dataclasses

    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(A2A_ARCH), num_layers=1,
                               capacity_factor=A2A_CF, router_aux_coef=0.0,
                               **kw)


class planted_sp:
    """Inside the context one fault of a sequence-parallel posture:
    ``no_halo``: model rank 1's conv prefix zeroed; ``no_relay``: every
    rank's incoming state zero; ``return_order``: the return all_to_all's
    blocks concatenated in the reverse source order."""

    def __init__(self, fault):
        self.fault = fault

    def __enter__(self):
        from repro_torch.models import mamba2, moe

        self.saved = (mamba2._conv_halo, mamba2._relay, moe._a2a_return)
        halo, relay, ret = self.saved
        if self.fault == "no_halo":
            mamba2._conv_halo = lambda xbc, shard, w: (
                halo(xbc, shard, w) * (shard.tp_rank() != 1))
        elif self.fault == "no_relay":
            mamba2._relay = lambda *a: relay(*a) * 0
        elif self.fault == "return_order":
            moe._a2a_return = lambda y, shard: ret(y, shard).flip(0)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import mamba2, moe

        mamba2._conv_halo, mamba2._relay, moe._a2a_return = self.saved


def collective_line(stats: dict) -> dict:
    """Calls, operand bytes and host ms of a step's collectives, and their
    calls, bytes and wire bytes by kind."""
    return {"calls": stats["calls"], "bytes": stats["bytes"],
            "ms": stats["seconds"] * 1e3,
            "by_kind": {k: dict(v) for k, v in stats["by_kind"].items()}}


def sp_step(step, lm, state, batch, fault=None, measure=False):
    """One train step (inside ``planted_sp(fault)``): (lm, state, metrics,
    launches, collectives, busy or None); ``measure`` runs it under the
    profiler (its wall time is the step's ms)."""
    import torch
    from repro_torch.dist import collectives

    box = {}

    def run():
        with planted_sp(fault):
            box["out"] = step(lm, state, batch)

    reset_counts()
    collectives.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    busy = device_busy(run, cpu_ops=False) if measure else None
    if not measure:
        run()
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    stats = collective_line(collectives.STATS)
    lm, state, met = box["out"]
    return lm, state, met, read_counts(), stats, ms, busy


def sharded_ssm_sp(ref_path: str, dev) -> dict:
    """The fsdp job's zamba2 step with ``ssm_sp``: rank 0 holds the gathered
    gradient against the same single-process CUDA step (``ref_path``),
    then each planted fault; launches, collectives, step ms (under the
    profiler), busy share and peak memory."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import collectives, sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import step as step_lib

    t_job = time.perf_counter()
    rank = dist.get_rank()
    cfg = shard_cfg()
    mesh = make_mesh(*SHARD_MESH)
    shard = sharding.make_shard_cfg(mesh, cfg, SHARD_BATCH, ssm_sp=True)
    batch = sharding.local_batch(
        train_batch(cfg, SHARD_SEQ, SHARD_BATCH, dev), mesh, shard)
    ref = torch.load(ref_path, map_location=dev) if rank == 0 else None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"rank": rank, "coord": collectives.coordinate(mesh),
           "faults": {}}
    for fault in (None, *SSM_SP_FAULTS):
        lm = _fsdp_model(cfg, shard, dev)
        opt = AdamW(lr=TRAIN_LR)
        step = step_lib.make_train_step(cfg, shard, opt)
        lm, state, met, counts, stats, ms, busy = sp_step(
            step, lm, opt.init(lm), batch, fault, measure=fault is None)
        grads = _gathered_grads(lm, mesh)
        parity = None
        if rank == 0:
            parity = grad_parity(grads, ref["grads"])
            parity["loss"], parity["ref_loss"] = float(met["loss"]), \
                ref["loss"]
        if fault is None:
            out.update(parity=parity, launches=counts, collective=stats,
                       step_ms=ms, busy={k: busy[k] for k in (
                           "wall_ms", "device_ms", "busy_share",
                           "flash_attention_ms", "ssd_intra_ms")})
        else:
            out["faults"][fault] = parity
        del lm, state, step, grads
        torch.cuda.empty_cache()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t_job
    return out


def moe_layer_run(lm, cfg, shard, x, cot, fault=None, backward=True):
    """The a2a drive's MoE alone: layer 0's router and experts gathered as
    their use takes them under the fsdp_tp placements, ``moe_apply`` on
    ``x`` (this rank's rows) and, with ``backward``, the gradient of
    sum(out · cot).  Returns (out, the dropped fraction)."""
    from repro_torch.dist import sharding
    from repro_torch.models import moe

    with planted_sp(fault), sharding.using(lm, sharding.gather_params(
            lm, shard, within="stack.layers.0.ffn.")):
        out, met = moe.moe_apply(lm.stack.layers[0].ffn, cfg, x, shard)
        if backward:
            (out.float() * cot).sum().backward()
    return out.detach(), met.dropped_frac


def layer_inputs(cfg, seq: int, gb: int, dev):
    """The MoE-alone drive's seeded x (gb, seq, d) in the compute dtype and
    its cotangent."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED)
    shape = (gb, seq, cfg.d_model)
    x = torch.randn(shape, generator=gen, device=dev).to(cfg.compute_dtype)
    return x, torch.randn(shape, generator=gen, device=dev)


def sharded_a2a(dev) -> dict:
    """qwen3-moe's MoE layer alone (:func:`moe_layer_run`) under
    ``moe_mode="tp"`` (this rank's gradient blocks and output rows kept on
    the host), then under ``a2a`` from the same weights and inputs (held
    block by block and row by row against tp's), then ``a2a`` with each
    planted fault (its forward, held row by row against tp's).  Launches,
    collectives, ms (under the profiler), busy share and peak memory."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import collectives, sharding
    from repro_torch.launch.mesh import make_mesh

    t_job = time.perf_counter()
    cfg = a2a_cfg()
    mesh = make_mesh(*SHARD_MESH)
    shards = {m: sharding.make_shard_cfg(mesh, cfg, A2A_BATCH, moe_mode=m)
              for m in ("tp", "a2a")}
    rows = sharding.local_rows(A2A_BATCH, shards["a2a"])
    x, cot = (t[rows].clone()
              for t in layer_inputs(cfg, A2A_SEQ, A2A_BATCH, dev))
    lm = _fsdp_model(cfg, shards["a2a"], dev)
    start = {n: p.detach().to("cpu", copy=True)
             for n, p in lm.named_parameters()}
    # the peak of the runs, beside what the dry run reckons for them (the
    # whole model drawn on the card before it is cut is not part of it)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"rank": dist.get_rank(), "coord": collectives.coordinate(mesh),
           "faults": {}}
    tp = None
    for mode, fault in (("tp", None), ("a2a", None),
                        *(("a2a", f) for f in A2A_FAULTS)):
        with torch.no_grad():
            for n, p in lm.named_parameters():
                p.copy_(start[n])
        lm.requires_grad_(True)
        for p in lm.parameters():
            p.grad = None
        xi = x.detach().requires_grad_(fault is None)
        box = {}

        def run():
            box["r"] = moe_layer_run(lm, cfg, shards[mode], xi, cot, fault,
                                     backward=fault is None)

        measure = mode == "a2a" and fault is None
        reset_counts()
        collectives.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        busy = device_busy(run, cpu_ops=False) if measure else None
        if not measure:
            run()
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts, stats = read_counts(), collective_line(collectives.STATS)
        y, dropped = box["r"]
        grads = {n: p.grad for n, p in lm.named_parameters()
                 if p.grad is not None}
        if xi.grad is not None:
            grads["x"] = xi.grad
        if mode == "tp":
            tp = {"y": y, "grads": {n: g.to("cpu", copy=True)
                                    for n, g in grads.items()}}
            out["tp"] = {"ms": ms, "collective": stats}
            continue
        res = {"dropped": float(dropped),
               "out_row_share": row_rel(y, tp["y"]) / LM_PARITY_RTOL}
        if fault is None:
            res.update(grad_parity(grads, {n: tp["grads"][n].to(dev)
                                           for n in grads}))
            out.update(parity=res, launches=counts, collective=stats, ms=ms,
                       busy={k: busy[k] for k in (
                           "wall_ms", "device_ms", "busy_share")})
        else:
            out["faults"][fault] = res
        del grads
        torch.cuda.empty_cache()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t_job
    return out


def fault_rejected(res: dict) -> bool:
    """Whether the a2a check rejects a run: an output row past its bound,
    or (the sound run's backward) a failing gradient block."""
    return res["out_row_share"] > 1.0 or bool(res.get("failing_leaves"))


def moe_layer_reckoning(cfg, mesh) -> dict:
    """(arguments, peak) bytes and collectives of :func:`moe_layer_run`,
    forward and backward, on one rank of ``mesh`` (a ``CountingMesh``)
    at A2A_SEQ × A2A_BATCH, traced on ``meta``: the rank holds its blocks
    of the whole 1-layer model, its rows of x and the cotangent."""
    import torch
    from repro_torch.dist import collectives, sharding
    from repro_torch.launch import op_cost
    from repro_torch.models import model

    shard = sharding.make_shard_cfg(mesh, cfg, A2A_BATCH, moe_mode="a2a")
    lm = sharding.shard_params(model.init_params(cfg, device="meta"), cfg,
                               shard)
    rows = sharding.local_rows(A2A_BATCH, shard)
    x, cot = (torch.empty((rows.stop - rows.start, A2A_SEQ, cfg.d_model),
                          dtype=dt, device="meta")
              for dt in (cfg.compute_dtype, torch.float32))
    args = sum(t.numel() * t.element_size()
               for t in (*lm.parameters(), x, cot))
    lm.requires_grad_(True)
    x.requires_grad_(True)
    collectives.reset_stats()
    with op_cost.OpCounter() as c:
        moe_layer_run(lm, cfg, shard, x, cot)
    booked = {k: dict(v) for k, v in collectives.STATS["by_kind"].items()}
    collectives.reset_stats()
    return {"argument_bytes": args, "peak_bytes": c.peak_bytes,
            "collectives": booked,
            "wire_bytes": sum(r["wire_bytes"] for r in booked.values())}


def a2a_sizing() -> dict:
    """The a2a drive's reckoning by the meshed dry run: the MoE layer alone
    on one rank of a (2, 2) counting mesh (:func:`moe_layer_reckoning`),
    which must fit the card with all four ranks on it (four ranks' bytes
    and contexts, with A2A_SPARE to spare)."""
    from repro_torch.core.rooflinemodel import resolve_chip
    from repro_torch.launch.mesh import CountingMesh

    hbm = resolve_chip("h100-sxm").hbm_bytes
    m = moe_layer_reckoning(a2a_cfg(), CountingMesh(*SHARD_MESH))
    rank_bytes = m["argument_bytes"] + m["peak_bytes"]
    need = 4 * (rank_bytes + A2A_CONTEXT_BYTES) * A2A_SPARE
    drive = {"seq": A2A_SEQ, "global_batch": A2A_BATCH,
             "rank_argument_bytes": m["argument_bytes"],
             "rank_peak_bytes": m["peak_bytes"], "rank_bytes": rank_bytes,
             "card_need_bytes": need, "card_bytes": hbm,
             "wire_bytes": m["wire_bytes"], "collectives": m["collectives"]}
    require(need <= hbm, f"a2a: the MoE layer alone does not fit four "
                         f"ranks on the card: {drive}")
    return drive


def a2a_memory(drive: dict, ranks: list) -> list:
    """Each rank's reckoned bytes (arguments + peak) beside its measured
    ``max_memory_allocated``."""
    return [{"rank": r["a2a"]["rank"], "reckoned": drive["rank_bytes"],
             "measured": r["a2a"]["max_memory_allocated"],
             "reckoned_over_measured": drive["rank_bytes"]
             / r["a2a"]["max_memory_allocated"]} for r in ranks]


def sharded_rank(ref_path: str, dp_ref_path: str, serve_paths: list
                 ) -> dict:
    """One of 4 gloo ranks on the card: the fsdp_tp, dp and GPipe drives,
    the serving job, then the sequence-parallel jobs (``ssm_sp``,
    ``a2a``)."""
    dev = _rank_device()
    t0 = time.perf_counter()
    out = {"fsdp": sharded_fsdp(ref_path, dev)}
    out["fsdp_s"] = time.perf_counter() - t0
    out["dp"] = sharded_dp(dp_ref_path, dev)
    out["gpipe"] = sharded_gpipe(dev)
    out["train_seconds"] = time.perf_counter() - t0
    out["serve"] = sharded_serve(serve_paths, dev)
    t1 = time.perf_counter()
    out["ssm_sp"] = sharded_ssm_sp(ref_path, dev)
    out["a2a"] = sharded_a2a(dev)
    out["sp_seconds"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    return out


def sharded_nccl_rank() -> dict:
    """World size 1 under NCCL: the (1, 1) fsdp_tp step of zamba2 at its
    widths and 2 layers against the LOCAL step, bitwise (parameters,
    gradients, metrics)."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.models.config import LOCAL
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import step as step_lib

    dev = _rank_device()
    cfg = shard_cfg(2)
    mesh = make_mesh((1, 1), ("data", "model"))
    shard = sharding.make_shard_cfg(mesh, cfg, 1)
    batch = train_batch(cfg, SHARD_SEQ, 1, dev)
    opt = AdamW(lr=TRAIN_LR)
    a = model.init_params(cfg, SEED, device=dev)
    a, _, ma = step_lib.make_train_step(cfg, LOCAL, opt)(a, opt.init(a),
                                                         batch)
    b = _fsdp_model(cfg, shard, dev)
    b, _, mb = step_lib.make_train_step(cfg, shard, opt)(
        b, opt.init(b), sharding.local_batch(batch, mesh, shard))
    torch.cuda.synchronize()
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    return {"backend": dist.get_backend(),
            "params_bitwise": all(torch.equal(pa[n], pb[n]) for n in pa),
            "grads_bitwise": all(torch.equal(pa[n].grad, pb[n].grad)
                                 for n in pa),
            "metrics_bitwise": all(torch.equal(ma[k], mb[k]) for k in ma)}


def row_mean_grads(cfg, lm, batch) -> tuple:
    """The dp step's gradient on one process: the mean over the batch's
    rows of each row's loss and gradient (summed in float32), as the dp
    ranks, a row each, average theirs — the single-process step with one
    microbatch a row."""
    import torch

    n = batch["targets"].shape[0]
    loss, acc = 0.0, None
    for i in range(n):
        l, g = train_grads(cfg, lm, {k: v[i:i + 1] for k, v in
                                     batch.items()}, "CUDA")
        loss += l / n
        if acc is None:
            acc = {k: torch.zeros(t.shape, dtype=torch.float32,
                                  device=t.device) for k, t in g.items()}
        for k, t in g.items():
            acc[k].add_(t.float())
    return loss, {k: t / n for k, t in acc.items()}


def serving_line(sv: list, serve_ref: dict, ref_s: float,
                 serve_s: float) -> dict:
    """The ``sharded`` line's ``serving`` section from the ranks' serving
    jobs ``sv``."""
    each = lambda key: [v[key] for v in sv]
    return {
        "arch": SHARD_ARCH, "layers": SHARD_LAYERS, "slots": SERVE_SLOTS,
        "max_seq": SERVE_MAX_SEQ, "mesh": SHARD_MESH,
        "prompt_lens": list(SERVE_PROMPTS), "new_tokens": SERVE_NEW,
        "engine": "ServingEngine(shard=make_shard_cfg(mesh, cfg, 4)), "
                  "teacher-forced on the single-process CUDA engine",
        "tolerance": {"logits_rtol": LM_PARITY_RTOL,
                      "cache_rtol": LM_PARITY_RTOL},
        "rows": each("rows"), "kv_block": each("kv_block"),
        "logit_shares": each("logit_shares"),
        "cache_shares": each("cache_shares"),
        "free_run_token_agreement": each("free_run_token_agreement"),
        "faults_rejected": {f: [fault_share(v["faults"][f]) for v in sv]
                            for f in SERVE_FAULTS},
        "launches_per_rank": each("launches"),
        "routes_per_rank": each("routes"),
        "prefills_per_rank": each("prefills"),
        "decode_steps": sv[0]["decode_steps"],
        "prefill_ms_by_bucket": each("prefill_ms_by_bucket"),
        "decode_step_ms_median": each("decode_step_ms_median"),
        "decode_step_ms": each("decode_step_ms"), "busy": each("busy"),
        "collective_decode_step": each("collective_decode_step"),
        "kv_bytes_per_rank": each("kv_bytes"),
        "single_process_kv_bytes": serve_ref["kv_bytes"],
        "max_memory_allocated": each("max_memory_allocated"),
        "seconds": {"single_process_ref": ref_s,
                    "rank_job": each("seconds"), "serving": serve_s,
                    "budget": SERVE_BUDGET_S}}


def check_serving(sv: list, serve_ref: dict) -> None:
    """The serving job's checks: parity, launches, KV bytes, the faults
    rejected."""
    for v in sv:
        who = f"sharded serving rank {v['rank']}"
        lg = v["logit_shares"]
        require(lg["prefill"] <= 1.0 and lg["decode"] <= 1.0,
                f"{who}: logits off the single-process engine's ({lg})")
        require(max(v["cache_shares"]) <= 1.0,
                f"{who}: cache blocks off the single-process engine's "
                f"({v['cache_shares']})")
        want = v["expected"]
        got = {**{k: v["launches"][k] for k in ("FLASH_ATTENTION",
                                                  "SSD_INTRA")},
               **v["routes"]}
        require(got == want, f"{who}: launches {got} != {want}")
        require(v["prefills"] == 2 and v["decode_steps"] == SERVE_NEW,
                f"{who}: {v['prefills']} prefills, {v['decode_steps']} "
                "decode steps")
        require(v["kv_bytes"] == SERVE_KV_BYTES and serve_ref["kv_bytes"]
                == 4 * SERVE_KV_BYTES,
                f"{who}: KV bytes {v['kv_bytes']} of "
                f"{serve_ref['kv_bytes']}")
    for f in SERVE_FAULTS:
        require(any(fault_share(v["faults"][f]) > 1.0 for v in sv),
                f"sharded serving: the planted fault {f!r} passed the check "
                "on every rank")


def phase_sharded(dev, smi: str) -> dict:
    """The LM trained over a mesh of 4 ranks that share the card (gloo:
    collectives through pinned host buffers): zamba2's fsdp_tp step
    against the single-process CUDA step, with two planted faults; the dp
    step of xlstm-125m, exact and compressed; GPipe; and NCCL at world
    size 1.  Then the same ranks serve zamba2 over (data 2, model 2)
    through the meshed ``ServingEngine``, held teacher-forced against the
    single-process CUDA engine, with two planted faults.  Then the
    sequence-parallel postures in the same ranks: zamba2's step with
    ``ssm_sp`` against the same single-process step (faults ``no_halo``,
    ``no_relay``), and qwen3-moe's MoE layer under ``a2a``, reckoned first
    by the meshed dry run (:func:`a2a_sizing`), against the same layer
    under ``tp`` block by block (fault ``return_order``)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import model

    t_phase = time.perf_counter()
    os.makedirs(SHARD_DIR, exist_ok=True)
    cfg = shard_cfg()
    refs = {}
    for label, c, seq, gb in (("fsdp", cfg, SHARD_SEQ, SHARD_BATCH),
                              ("dp", get_config(DP_ARCH), DP_SEQ, 4)):
        lm = model.init_params(c, SEED, device=dev).requires_grad_(True)
        batch = train_batch(c, seq, gb, dev)
        if label == "fsdp":
            loss, grads = train_grads(c, lm, batch, "CUDA")
        else:
            loss, grads = row_mean_grads(c, lm, batch)
        refs[label] = {"loss": loss, "param_bytes": param_bytes(lm),
                       "moment_bytes": 2 * sum(
                           p.numel() * 4 for p in lm.parameters()),
                       "path": os.path.join(SHARD_DIR, f"{label}_ref.pt")}
        torch.save({"loss": loss, "grads": grads}, refs[label]["path"])
        del lm, grads
        torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    serve_ref = serving_reference(dev)
    serve_ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    drive = a2a_sizing()
    sizing_s = time.perf_counter() - t0
    device = f"cuda:{dev.index or 0}"
    t0 = time.perf_counter()
    ranks = spawn(sharded_rank, 4, backend="gloo", device=device,
                  args=(refs["fsdp"]["path"], refs["dp"]["path"],
                        serve_ref["paths"]),
                  timeout_s=SHARD_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nccl = spawn(sharded_nccl_rank, 1, backend="nccl", device=device,
                 timeout_s=SHARD_TIMEOUT_S)[0]
    nccl_s = time.perf_counter() - t0

    head = ranks[0]
    fs = head["fsdp"]
    par = fs["parity"]
    seconds = time.perf_counter() - t_phase
    sv = [r["serve"] for r in ranks]
    serve_s = serve_ref_s + max(v["seconds"] for v in sv)
    sp_s = sizing_s + max(r["sp_seconds"] for r in ranks)
    train_s = seconds - serve_s - sp_s
    emit({"phase": "sharded", "card": smi,
          "fsdp_tp": {
              "arch": SHARD_ARCH, "layers": SHARD_LAYERS, "seq": SHARD_SEQ,
              "global_batch": SHARD_BATCH, "mesh": SHARD_MESH,
              "backend": "gloo (4 ranks share cuda:0; collectives via "
                         "pinned host)",
              "loss": par["loss"], "single_process_loss": par["ref_loss"],
              "tolerance": {"loss_rtol": TRAIN_LOSS_RTOL,
                            "grad_rel": TRAIN_GRAD_REL,
                            "grad_cos": TRAIN_GRAD_COS},
              "worst_rel_norm_err": par["worst_rel_norm_err"],
              "worst_cosine": par["worst_cosine"],
              "worst_leaves": par["worst_leaves"],
              "faults_rejected": {k: len(v["failing_leaves"])
                                  for k, v in fs["faults"].items()},
              "launches_per_rank_step": [r["fsdp"]["launches"]
                                         for r in ranks],
              "first_step_ms": [r["fsdp"]["first_step_ms"] for r in ranks],
              "step_ms": [r["fsdp"]["step_ms"] for r in ranks],
              "busy": [r["fsdp"]["busy"] for r in ranks],
              "collective_first_step": [r["fsdp"]["collective"]
                                        for r in ranks],
              "collective_step": [r["fsdp"]["collective_warm"]
                                  for r in ranks],
              "param_bytes_per_rank": [r["fsdp"]["param_bytes"]
                                       for r in ranks],
              "moment_bytes_per_rank": [r["fsdp"]["moment_bytes"]
                                        for r in ranks],
              "single_process_param_bytes": refs["fsdp"]["param_bytes"],
              "single_process_moment_bytes": refs["fsdp"]["moment_bytes"],
              "max_memory_allocated": [r["fsdp"]["max_memory_allocated"]
                                       for r in ranks]},
          "dp": {"arch": DP_ARCH, "seq": DP_SEQ, "mesh": DP_MESH,
                 "exact": head["dp"]["exact"],
                 "compressed": head["dp"]["compressed"],
                 "bounds": {"loss": EF_LOSS, "params": EF_PARAMS,
                            "grad_rel": EF_GRAD_REL,
                            "identity_rel": EF_IDENTITY}},
          "gpipe": {"stack": [GPIPE_L, GPIPE_B, GPIPE_S, GPIPE_D],
                    "microbatches": GPIPE_MB,
                    "max_abs_err": max(r["gpipe"]["max_abs_err"]
                                       for r in ranks),
                    "rtol": GPIPE_RTOL, "atol": GPIPE_ATOL},
          "serving": serving_line(sv, serve_ref, serve_ref_s, serve_s),
          "ssm_sp": ssm_sp_line(ranks, par),
          "a2a": a2a_line(ranks, drive),
          "nccl_world_size_1": nccl,
          "seconds": {"single_process_refs": ref_s, "spawn_4": spawn_s,
                      "rank_work": [r["seconds"] for r in ranks],
                      "rank_train_work": [r["train_seconds"] for r in ranks],
                      "spawn_nccl_1": nccl_s, "phase": seconds,
                      "training": train_s, "training_budget":
                      SHARDED_BUDGET_S, "serving": serve_s,
                      "serving_budget": SERVE_BUDGET_S,
                      "a2a_sizing": sizing_s,
                      "sequence_parallel": sp_s,
                      "sequence_parallel_budget": SP_BUDGET_S}})
    require(abs(par["loss"] - par["ref_loss"]) <=
            TRAIN_LOSS_RTOL * abs(par["ref_loss"]),
            f"sharded: loss {par['loss']} vs the single-process "
            f"{par['ref_loss']}")
    require(not par["failing_leaves"],
            f"sharded: gradients off the single-process step: "
            f"{par['failing_leaves'][:5]}")
    for fault, fp in fs["faults"].items():
        require(bool(fp["failing_leaves"]),
                f"sharded: the planted fault {fault!r} passed the gradient "
                "check")
    for r in ranks:
        got = {k: r["fsdp"]["launches"][k] for k in SHARD_PER_STEP}
        require(got == SHARD_PER_STEP,
                f"sharded rank {r['fsdp']['rank']}: launches {got} != "
                f"{SHARD_PER_STEP}")
        require(r["fsdp"]["launches"] == head["fsdp"]["launches"],
                "sharded: ranks launched differently")
        require(r["gpipe"]["within"], f"gpipe: {r['gpipe']}")
        comp = r["dp"]["compressed"]
        require(comp["loss_diff"] < EF_LOSS and
                comp["param_max_abs_diff"] < EF_PARAMS,
                f"dp compressed vs exact: {comp['loss_diff']}, "
                f"{comp['param_max_abs_diff']}")
        require(comp["grad_rel_err"] < EF_GRAD_REL,
                f"dp compressed gradient mean vs exact: "
                f"{comp['grad_rel_err']}")
        require(all(n > 0 for n in comp["ef_norms"])
                and comp["carried_differs"],
                f"dp: the EF residual {comp['ef_norms']} not carried")
        require(comp["ef_identity_rel"] < EF_IDENTITY,
                f"dp: error feedback's identity off by "
                f"{comp['ef_identity_rel']}")
    ex = head["dp"]["exact"]
    require(abs(ex["loss"] - ex["parity"]["ref_loss"]) <=
            TRAIN_LOSS_RTOL * abs(ex["parity"]["ref_loss"])
            and not ex["parity"]["failing_leaves"],
            f"dp exact vs the single-process step: {ex['parity']}")
    require(nccl["backend"] == "nccl" and nccl["params_bitwise"]
            and nccl["grads_bitwise"] and nccl["metrics_bitwise"],
            f"NCCL (1, 1) vs LOCAL: {nccl}")
    check_serving(sv, serve_ref)
    check_sequence_parallel(ranks)
    require(sp_s <= SP_BUDGET_S,
            f"sharded ssm_sp + a2a: {sp_s:.1f} s > {SP_BUDGET_S} s")
    require(train_s <= SHARDED_BUDGET_S,
            f"sharded training: {train_s:.1f} s > {SHARDED_BUDGET_S} s")
    require(serve_s <= SERVE_BUDGET_S,
            f"sharded serving: {serve_s:.1f} s > {SERVE_BUDGET_S} s")
    return (dict(head["fsdp"]["launches"]), dict(sv[0]["launches"]),
            dict(head["ssm_sp"]["launches"]), dict(head["a2a"]["launches"]))


def ssm_sp_line(ranks: list, fsdp_parity: dict) -> dict:
    """The ``sharded`` line's ``ssm_sp`` section."""
    each = lambda key: [r["ssm_sp"][key] for r in ranks]
    par = ranks[0]["ssm_sp"]["parity"]
    return {"arch": SHARD_ARCH, "layers": SHARD_LAYERS, "seq": SHARD_SEQ,
            "global_batch": SHARD_BATCH, "mesh": SHARD_MESH,
            "rank_block": [SHARD_BATCH // 2, SHARD_SEQ // 2],
            "loss": par["loss"], "single_process_loss": par["ref_loss"],
            "fsdp_job_loss": fsdp_parity["loss"],
            "worst_rel_norm_err": par["worst_rel_norm_err"],
            "worst_cosine": par["worst_cosine"],
            "worst_leaves": par["worst_leaves"],
            "faults_rejected": {f: len(p["failing_leaves"]) for f, p in
                                ranks[0]["ssm_sp"]["faults"].items()},
            "launches_per_rank_step": each("launches"),
            "step_ms": each("step_ms"), "busy": each("busy"),
            "collective_step": each("collective"),
            "max_memory_allocated": each("max_memory_allocated"),
            "seconds": each("seconds")}


def a2a_line(ranks: list, drive: dict) -> dict:
    """The ``sharded`` line's ``a2a`` section."""
    each = lambda key: [r["a2a"][key] for r in ranks]
    return {"arch": A2A_ARCH, "layers": 1, "capacity_factor": A2A_CF,
            "router_aux_coef": 0.0, "mesh": SHARD_MESH,
            "drive": "moe_layer", "seq": A2A_SEQ,
            "global_batch": A2A_BATCH, "sizing": drive,
            "parity_vs_tp_per_rank": [
                {k: r["a2a"]["parity"].get(k) for k in (
                    "worst_rel_norm_err", "worst_cosine", "worst_leaves",
                    "out_row_share", "dropped")} for r in ranks],
            "faults": {f: [r["a2a"]["faults"][f]["out_row_share"]
                           for r in ranks] for f in A2A_FAULTS},
            "launches_per_rank": each("launches"),
            "ms": each("ms"), "busy": each("busy"),
            "tp_ms": [r["a2a"]["tp"]["ms"] for r in ranks],
            "collective": each("collective"),
            "tp_collective": [r["a2a"]["tp"]["collective"] for r in ranks],
            "dryrun_memory": a2a_memory(drive, ranks),
            "seconds": each("seconds")}


def check_sequence_parallel(ranks: list) -> None:
    """The ssm_sp and a2a jobs' checks: parity, exact launches, faults."""
    sp = ranks[0]["ssm_sp"]
    par = sp["parity"]
    require(abs(par["loss"] - par["ref_loss"]) <=
            TRAIN_LOSS_RTOL * abs(par["ref_loss"]),
            f"ssm_sp: loss {par['loss']} vs the single-process "
            f"{par['ref_loss']}")
    require(not par["failing_leaves"],
            f"ssm_sp: gradients off the single-process step: "
            f"{par['failing_leaves'][:5]}")
    for fault, fp in sp["faults"].items():
        require(bool(fp["failing_leaves"]),
                f"ssm_sp: the planted fault {fault!r} passed the gradient "
                "check")
    for r in ranks:
        got = {k: r["ssm_sp"]["launches"][k] for k in SHARD_PER_STEP}
        require(got == SHARD_PER_STEP, f"ssm_sp rank {r['ssm_sp']['rank']}: "
                f"launches {got} != {SHARD_PER_STEP}")
        a = r["a2a"]
        got = {k: a["launches"][k] for k in A2A_LAUNCHES}
        require(got == A2A_LAUNCHES, f"a2a rank {a['rank']}: launches {got}"
                                     f" != {A2A_LAUNCHES}")
        require(a["collective"]["by_kind"].get("all_to_all", {}).get(
            "calls", 0) > 0, f"a2a rank {a['rank']}: no all_to_all")
        par = a["parity"]
        require(par["dropped"] == 0.0, f"a2a rank {a['rank']}: "
                f"{par['dropped']} of the assignments dropped")
        require(not fault_rejected(par),
                f"a2a rank {a['rank']}: off the tp run's: "
                f"{par['failing_leaves'][:5]}, output rows "
                f"{par['out_row_share']}")
    for fault in A2A_FAULTS:
        require(any(fault_rejected(r["a2a"]["faults"][fault])
                    for r in ranks),
                f"a2a: the planted fault {fault!r} passed the check on "
                "every rank")


# ---------------------------------------------------------------------------
def phase_physics(dev):
    import torch
    from repro_torch import api
    from repro_torch.cfd import cavity, taylor_green
    from repro_torch.kernels import stencil3d_cuda as sc

    sc.reset_launches()
    tg = taylor_green.run(n=32, steps=50, nu=0.1, overlap=False,
                          template="CUDA", device=dev)
    tg_launches = dict(sc.LAUNCHES)
    emit({"phase": "physics", "case": "taylor_green", **tg,
          "launches": tg_launches})
    for k in ("err_vx", "err_vy", "energy_rel_err"):
        require(tg[k] < 5e-3, f"Taylor-Green {k} = {tg[k]} >= 5e-3")
    require(tg["div_max"] < 1e-3, f"Taylor-Green div_max = {tg['div_max']}")
    require(all(v > 0 for v in tg_launches.values()),
            f"Taylor-Green did not run every kernel: {tg_launches}")

    solver, state, _ = cavity.run(n=16, t_end=0.5, jacobi_iters=40,
                                  template="CUDA", overlap=False,
                                  device=dev)
    walls = max(float(state["vx"][-1].abs().max()),
                float(state["vy"][:, -1].abs().max()))
    div = float(solver.divergence_of(state).abs().max())
    emit({"phase": "physics", "case": "cavity_n16", "wall_faces_max": walls,
          "div_max": div})
    require(walls == 0.0, f"cavity wall faces not zero: {walls}")
    require(div < 0.05, f"cavity divergence {div} >= 0.05")

    sc.reset_launches()
    t0 = time.perf_counter()
    res = api.runtime(n=48, device=dev).run("cavity", t_end=12.0, re=100.0)
    ghia = res.diagnostics["ghia"]
    emit({"phase": "physics", "case": "cavity_ghia_n48", "steps":
          res.steps_done, "seconds": time.perf_counter() - t0, **ghia,
          "launches": dict(sc.LAUNCHES)})
    require(ghia["u_rms"] < 0.035 and ghia["v_rms"] < 0.035,
            f"Ghia deviation too large: {ghia}")
    require(sc.LAUNCHES["JACOBI_PRESSURE"] == 40 * res.steps_done,
            "Ghia run did not go through the kernels")


# ---------------------------------------------------------------------------
def lm_requests(cfg, n: int = LM_REQUESTS, prompt=LM_PROMPT,
                new: int = LM_NEW):
    """``n`` seeded requests of ``prompt`` = (lo, hi) tokens, ``new`` new
    tokens each."""
    import numpy as np
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(SEED)
    lens = rng.integers(prompt[0], prompt[1] + 1, size=n)
    return [Request(i, rng.integers(0, cfg.vocab_size, size=int(m)),
                    max_new_tokens=new) for i, m in enumerate(lens)]


def device_busy(fn, cpu_ops: bool = True, ranges=()) -> dict:
    """Wall time of ``fn`` (ending in a synchronise) and the profiler's
    device kernel time inside it, FLASH_ATTENTION's and SSD_INTRA's part
    of it, and the device time inside each ``record_function`` range named
    in ``ranges``.  ``cpu_ops=False`` records only the device's activity
    (a training step's host ops would cost the profiler more than the
    step) and sums the device records as the profiler took them: a step
    with the sLSTM loop launches about a million kernels, whose event tree
    (``key_averages``) would take minutes to build."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu_ops
                                      else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    in_range = {}
    if cpu_ops:
        averages = prof.key_averages()
        # a range may also show as a device-side annotation: kept out of
        # the sum
        timed = [(ev.key, ev.self_device_time_total / 1e3) for ev in averages
                 if ev.device_type == DeviceType.CUDA
                 and ev.key not in ranges]
        # each range: its device-side span, or its host range's kernels
        for ev in averages:
            if ev.key in ranges:
                ms = (ev.self_device_time_total if ev.device_type ==
                      DeviceType.CUDA else ev.device_time_total) / 1e3
                in_range[ev.key] = max(in_range.get(ev.key, 0.0), ms)
    else:
        timed = [(ev.name(), (ev.end_ns() - ev.start_ns()) / 1e6)
                 for ev in prof.profiler.kineto_results.events()
                 if ev.device_type() == DeviceType.CUDA]
    busy = sum(ms for _, ms in timed)
    # FLASH_ATTENTION's three kernels (csrc/attention.cu)
    names = ("prefill_kernel", "decode_kernel", "flash_kernel")
    attn = sum(ms for key, ms in timed if any(name in key for name in names))
    ssd = sum(ms for key, ms in timed if "ssd_intra_kernel" in key)
    out = {f"{name}_ms": in_range.get(name) or "not measured"
           for name in ranges}
    return {"wall_ms": wall, "device_ms": busy, **out,
            "flash_attention_ms": attn if busy else "not measured",
            "ssd_intra_ms": ssd if busy else "not measured",
            "busy_share": busy / wall if busy else "not measured"}


def drive_engine(eng):
    """Drain ``eng`` step by step with the launch counters reset just
    before: per step (requests admitted, ms), the wall seconds, the
    launches and FLASH_ATTENTION's launches by route."""
    import torch
    from repro_torch.kernels import attention_cuda as ac

    reset_counts()
    steps, t_start = [], time.perf_counter()
    while True:
        queued = eng.table.n_queued
        t0 = time.perf_counter()
        if not eng.step():
            break
        torch.cuda.synchronize()
        steps.append((queued - eng.table.n_queued,
                      (time.perf_counter() - t0) * 1e3))
    return (steps, time.perf_counter() - t_start, read_counts(),
            dict(ac.ROUTE_LAUNCHES))


def phase_lm(dev):
    """zamba2-1.2b at published widths through the ported ServingEngine on
    the cuda backend, then cuda-vs-torch logit parity on one prompt."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model
    from repro_torch.models.transformer import n_attn_layers
    from repro_torch.serve.engine import ServingEngine, _bucket

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    lm = model.init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    n_attn, n_mamba = n_attn_layers(cfg), cfg.num_layers

    eng = ServingEngine(cfg, lm, slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                        device=dev, backend="cuda")
    reqs = lm_requests(cfg)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, wall, launches, routes = drive_engine(eng)
    peak = torch.cuda.max_memory_allocated()
    prefills, decode_steps = sum(a for a, _ in steps), eng.steps
    expected = dict.fromkeys(launches, 0)
    expected.update(FLASH_ATTENTION=n_attn * (prefills + decode_steps),
                    SSD_INTRA=n_mamba * prefills)
    done = {r.rid: r for r in eng.finished}
    tokens = sum(len(r.output) for r in done.values())
    require(len(done) == LM_REQUESTS and prefills == LM_REQUESTS,
            f"lm: {len(done)} of {LM_REQUESTS} requests finished")
    require(all(len(r.output) == LM_NEW and
                all(0 <= t < cfg.vocab_size for t in r.output)
                for r in done.values()), "lm: outputs of the wrong length")
    require(launches == expected, f"lm: launch counts {launches} != {expected}")
    # bf16 prefills on the tensor cores, decode steps split over keys
    expected_routes = {"tensor_core_prefill": n_attn * prefills,
                       "split_k_decode": n_attn * decode_steps,
                       "cuda_core": 0}
    require(routes == expected_routes,
            f"lm: FLASH_ATTENTION routes {routes} != {expected_routes}")
    decode_ms = sorted(ms for a, ms in steps if a == 0)

    # prefill time per bucket (one slot's cache rows), and the device's
    # busy share of a decode step with every slot resident
    buckets = sorted({_bucket(len(r.prompt)) for r in reqs})
    one = model.init_caches(cfg, 1, LM_MAX_SEQ, torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prefill_ms = {}
    for b in buckets:
        toks = torch.randint(0, cfg.vocab_size, (1, b), device=dev,
                             generator=gen)
        prefill_ms[b] = cuda_ms(lambda: model.prefill(
            lm, cfg, {"tokens": toks}, one, template="CUDA"), reps=3,
            warmup=1)
    del one
    for r in lm_requests(cfg)[:LM_SLOTS]:
        r.max_new_tokens = 1000
        eng.submit(r)
    eng.step()                                  # admit all four
    eng.step()
    busy = device_busy(eng.step)

    parity = lm_parity(cfg, lm, dev)
    emit({"phase": "lm", "arch": LM_ARCH, "params": n_params,
          "init_s": init_s, "slots": LM_SLOTS, "max_seq": LM_MAX_SEQ,
          "requests": LM_REQUESTS,
          "prompt_lens": [len(r.prompt) for r in reqs],
          "new_tokens": LM_NEW, "engine_steps": decode_steps,
          "prefills": prefills, "launches": launches, "expected": expected,
          "flash_attention_routes": routes,
          "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
          "prefill_ms_by_bucket": prefill_ms,
          "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
          "decode_step_ms_min": decode_ms[0],
          "decode_steps_timed": len(decode_ms),
          "decode_step_busy": busy, "max_memory_allocated": peak,
          "parity": parity,
          "first_tokens": {rid: done[rid].output[:8] for rid in sorted(done)}})
    require(all(p["max_abs_diff"] <= p["tolerance"] for p in parity),
            f"lm: cuda and torch backends disagree: {parity}")
    require(any(p["planted_fault_max_abs_diff"] > p["tolerance"]
                for p in parity),
            f"lm: the parity check passed a planted attention fault: {parity}")
    del eng, lm
    torch.cuda.empty_cache()
    return launches


def lm_parity(cfg, lm, dev):
    """One prompt prefilled, then LM_PARITY_STEPS decode steps, on the
    torch backend (choosing the tokens) and on the cuda backend fed the
    same tokens (teacher forcing, so a near-tie in argmax cannot fork the
    two runs); logits compared relative to max|logits|.  A third run, on
    the cuda backend with every FLASH_ATTENTION launch given
    ATTN_FAULT_KEYS keys too few, shows that the check rejects a fault of
    that size."""
    import torch
    from repro_torch.models import model

    prompt = torch.from_numpy(lm_requests(cfg)[0].prompt).to(dev)[None]
    plen = prompt.shape[1]

    def run(template, forced):
        caches = model.init_caches(cfg, 1, LM_MAX_SEQ, torch.float32, dev)
        logits, caches = model.prefill(lm, cfg, {"tokens": prompt}, caches,
                                       template=template)
        out, chosen = [logits[0, -1].float()], []
        for step in range(LM_PARITY_STEPS):
            tok = forced[step] if forced else int(out[-1].argmax())
            chosen.append(tok)
            logits, caches = model.decode_step(
                lm, cfg, torch.tensor([[tok]], device=dev), caches,
                plen + step, template=template)
            out.append(logits[0, -1].float())
        torch.cuda.synchronize()
        return out, chosen

    want, tokens = run("TORCH", None)
    got, _ = run("CUDA", tokens)
    with planted_short_attention():
        faulty, _ = run("CUDA", tokens)
    rows = []
    for i, (a, b, c) in enumerate(zip(got, want, faulty)):
        require(bool(torch.isfinite(a).all()), f"lm parity {i}: not finite")
        scale = float(b.abs().max())
        rows.append({"position": plen - 1 + i,
                     "max_abs_diff": float((a - b).abs().max()),
                     "tolerance": LM_PARITY_RTOL * scale,
                     "max_abs_logit": scale,
                     "rel_l2": float((a - b).norm() / b.norm()),
                     "argmax_equal": int(a.argmax()) == int(b.argmax()),
                     "planted_fault_max_abs_diff": float((c - b).abs().max()),
                     "planted_fault_rel_l2": float((c - b).norm() / b.norm())})
    return rows


def _zero_dq_fn():
    """The planted fault for the gradient-parity check: FLASH_ATTENTION's
    Function with a backward that drops q's gradient."""
    import torch
    from repro_torch.kernels import autograd

    base = autograd.FlashAttentionFn

    class ZeroDq(base):
        @staticmethod
        def backward(ctx, grad_out):
            dq, *rest = base.backward(ctx, grad_out)
            return (torch.zeros_like(dq), *rest)

    return ZeroDq


def _drop_dc_fn():
    """The planted fault for the ssm family's gradient-parity check:
    SSD_INTRA's Function with a backward that drops c_'s gradient (the
    mLSTM's q reaches the loss only through SSD_INTRA)."""
    import torch
    from repro_torch.kernels import autograd

    base = autograd.SSDIntraFn

    class DropDc(base):
        @staticmethod
        def backward(ctx, grad_out):
            *head, dc, ds_in, none = base.backward(ctx, grad_out)
            return (*head, torch.zeros_like(dc), ds_in, none)

    return DropDc


def train_regions(cfg) -> tuple:
    """(forwards a microbatch, attention regions, SSD regions) of ``cfg``'s
    training stack: remat ``block`` runs each layer's or group's forward
    twice; the ``ssm`` stack takes no remat (as the reference's)."""
    if cfg.family == "ssm":
        return 1, 0, cfg.num_layers - len(cfg.slstm_indices)
    require(cfg.remat == "block", f"train: remat {cfg.remat!r}, not block")
    if cfg.family == "hybrid":
        return 2, cfg.num_layers // cfg.attn_every, cfg.num_layers
    return 2, cfg.num_layers, 0


def train_grads(cfg, lm, batch, template):
    """(loss, {name: gradient, in its parameter's dtype}) of one
    ``loss_fn`` + backward."""
    import torch
    from repro_torch.models import model

    for p in lm.parameters():
        p.grad = None
    loss, _ = model.loss_fn(lm, cfg, batch, template=template)
    loss.backward()
    torch.cuda.synchronize()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in lm.named_parameters()}
    for p in lm.parameters():
        p.grad = None
    return float(loss.detach()), grads


def grad_parity(got: dict, want: dict, zero=()) -> dict:
    """Leaf by leaf: relative gradient-norm error and cosine of ``got``
    against ``want``, and the leaves that fail TRAIN_GRAD_REL /
    TRAIN_GRAD_COS or are zero where ``want``'s are not.  A leaf in
    ``zero`` (its gradient is zero in exact arithmetic: float32 noise on
    both templates) is held at TRAIN_GRAD_REL of the largest leaf's norm,
    with no cosine."""
    top = max(float(w.float().norm()) for w in want.values())
    worst_rel, worst_cos, bad, rels = 0.0, 1.0, [], {}
    for name, w in want.items():
        g, w = got[name].float(), w.float()
        wn, gn = float(w.norm()), float(g.norm())
        if name in zero:
            if float((g - w).norm()) > TRAIN_GRAD_REL * top:
                bad.append(f"{name}: {float((g - w).norm())} off a zero "
                           f"gradient")
            continue
        if wn == 0:
            continue
        if gn == 0:
            bad.append(f"{name}: zero")
            continue
        rel = float((g - w).norm()) / wn
        cos = float((g * w).sum()) / (gn * wn)
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
        rels[name] = rel
        if rel > TRAIN_GRAD_REL or cos < TRAIN_GRAD_COS:
            bad.append(f"{name}: rel {rel:.3g} cos {cos:.4f}")
    return {"worst_rel_norm_err": worst_rel, "worst_cosine": worst_cos,
            "worst_leaves": sorted(rels, key=rels.get)[-3:][::-1],
            "failing_leaves": bad}


def zero_grad_leaves(cfg) -> list:
    """The leaves whose gradient is zero in exact arithmetic: each sLSTM's
    ``bi`` (from a fresh state a shift of every input-gate logit is
    absorbed by the stabilizer m)."""
    if cfg.family != "ssm":
        return []
    return [f"stack.layers.{i}.bi" for i in cfg.slstm_indices]


def train_batch(cfg, seq: int, global_batch: int, dev, step: int = 0):
    """Batch ``step`` of ``PackedLMDataset(..., cfg)`` on the card: tokens
    (and, for paligemma, its patch embeddings; for musicgen, frame
    embeddings in their place) and targets."""
    import torch
    from repro_torch.data.pipeline import DataConfig, PackedLMDataset

    ds = PackedLMDataset(DataConfig(seed=SEED, vocab_size=cfg.vocab_size,
                                    seq_len=seq, global_batch=global_batch),
                         cfg)
    return {k: torch.from_numpy(v).to(dev) for k, v in ds.batch(step).items()}


def train_parity(dev, cfg, batch, fault, lost) -> dict:
    """(a) one loss + backward on the CUDA and the TORCH template from the
    same weights and batch; then once more on CUDA with ``fault`` =
    (attribute of ``kernels.autograd``, Function) swapped in, which the
    check must reject: each leaf in ``lost`` must read zero.  For the
    ``moe`` family TORCH runs first and the CUDA runs take its routing
    (:func:`forced_routing`); a free CUDA run's top-k agreement with it
    and its gradients are reported beside."""
    import torch
    from repro_torch.kernels import autograd
    from repro_torch.models import model, moe

    lm = model.init_params(cfg, SEED, device=dev).requires_grad_(True)
    routed = cfg.family == "moe"
    force = contextlib.nullcontext
    if routed:
        with recording(moe, "_route", lambda out: out[0]) as chosen:
            loss_torch, g_torch = train_grads(cfg, lm, batch, "TORCH")
        force = lambda: forced_routing(chosen)
    reset_counts()
    with force():
        loss_cuda, g_cuda = train_grads(cfg, lm, batch, "CUDA")
    launched = read_counts()
    if not routed:
        loss_torch, g_torch = train_grads(cfg, lm, batch, "TORCH")
    attr, planted = fault
    good = getattr(autograd, attr)
    setattr(autograd, attr, planted)
    try:
        with force():
            _, g_fault = train_grads(cfg, lm, batch, "CUDA")
    finally:
        setattr(autograd, attr, good)
    zero = zero_grad_leaves(cfg)
    ok = grad_parity(g_cuda, g_torch, zero)
    fault_found = grad_parity(g_fault, g_torch, zero)["failing_leaves"]
    del g_fault
    free = {}
    if routed:
        with recording(moe, "_route", lambda out: out[0]) as own:
            loss_free, g_free = train_grads(cfg, lm, batch, "CUDA")
        free = {"routing_forced": True, "route_calls": len(chosen),
                "free_running": {
                    "topk_sets_agree": topk_agreement(own, chosen),
                    "loss_rel_diff": abs(loss_free - loss_torch)
                    / abs(loss_torch),
                    **grad_parity(g_free, g_torch, zero)}}
        del g_free, own, chosen
    fwd, n_attn, n_ssd = train_regions(cfg)
    positions = sum(batch[k].shape[1] for k in ("tokens", "embeds",
                                                 "prefix_embeds")
                    if k in batch)
    out = {"layers": cfg.num_layers, "attn_regions": n_attn,
           "ssd_regions": n_ssd, "positions": positions,
           "loss_cuda": loss_cuda, "loss_torch": loss_torch,
           "loss_rel_diff": abs(loss_cuda - loss_torch) / abs(loss_torch),
           "leaves": len(g_torch), "zero_gradient_leaves": zero,
           "launches_cuda": launched, **ok, **free,
           "planted_fault": f"{attr}: {planted.__name__}",
           "planted_fault_failing_leaves": fault_found,
           "tolerances": {"loss_rel": TRAIN_LOSS_RTOL,
                          "grad_rel_norm": TRAIN_GRAD_REL,
                          "grad_cosine": TRAIN_GRAD_COS}}
    del lm, g_cuda, g_torch
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train_parity", "arch": cfg.name, **out})
    require(out["loss_rel_diff"] <= TRAIN_LOSS_RTOL,
            f"train parity {cfg.name}: losses {loss_cuda} (cuda) and "
            f"{loss_torch} (torch) differ by more than {TRAIN_LOSS_RTOL}")
    require(not ok["failing_leaves"],
            f"train parity {cfg.name}: gradients disagree: "
            f"{ok['failing_leaves'][:5]}")
    missed = [n for n in lost if f"{n}: zero" not in fault_found]
    require(not missed,
            f"train parity {cfg.name}: the check passed {out['planted_fault']}"
            f" on {missed[:5]} ({fault_found[:5]})")
    want = {"FLASH_ATTENTION": fwd * n_attn, "SSD_INTRA": fwd * n_ssd}
    require({k: launched[k] for k in want} == want,
            f"train parity {cfg.name}: launches {launched}, expected {want}")
    return out


def plain_backward_ms(cfg, dev, seq: int = TRAIN_SEQ, prefix: int = 0) -> dict:
    """Device time of one plain backward of each kernel's region on
    ``cfg``'s training path at its shapes (``seq`` positions, the first
    ``prefix`` bidirectional): what the Functions run, and what a backward
    kernel would replace."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.models import xlstm
    from repro_torch.models.attention import MaskSpec, chunked_mha

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    out = {}
    _, n_attn, n_ssd = train_regions(cfg)
    if n_attn:
        q, k, v = [rnd(1, seq, h, cfg.head_dim).to(torch.bfloat16)
                   .requires_grad_(True)
                   for h in (cfg.num_heads, cfg.num_kv_heads,
                             cfg.num_kv_heads)]
        o = chunked_mha(q, k, v, MaskSpec(causal=True, prefix_len=prefix),
                        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                        template="CUDA")
        g = torch.randn_like(o)
        out["FLASH_ATTENTION"] = cuda_ms(
            lambda: torch.autograd.grad(o, (q, k, v), g, retain_graph=True),
            reps=3, warmup=1)
        del q, k, v, o, g
    if n_ssd:
        chunk = cfg.ssm_chunk
        if cfg.family == "ssm":             # the mLSTM: heads as groups
            hd = xlstm._dims(cfg)[2]
            args = list(mlstm_ssd_inputs(
                (1, seq // chunk, chunk, cfg.num_heads, 1, hd + 1, hd), gen,
                dev))
        else:
            nc, heads = seq // chunk, cfg.ssm_heads
            p, n = cfg.ssm_head_dim, cfg.ssm_state
            args = [rnd(1, nc, chunk, 1, heads, p),
                    -F.softplus(rnd(1, nc, chunk, 1, heads)),
                    F.softplus(rnd(1, nc, chunk, 1, heads)),
                    rnd(1, nc, chunk, 1, n), rnd(1, nc, chunk, 1, n),
                    rnd(1, nc, 1, heads, n, p) * 0.3]
        args = [a.requires_grad_(True) for a in args]
        y = ops.ssd_intra(*args, template="CUDA")
        gy = torch.randn_like(y)
        out["SSD_INTRA"] = cuda_ms(
            lambda: torch.autograd.grad(y, args, gy, retain_graph=True),
            reps=3, warmup=1)
    return out


@contextlib.contextmanager
def timing(module, name: str, spent: list):
    """``module.name`` timed alone while inside: each call's wall time
    between synchronises, in ms, appended to ``spent``."""
    import torch

    fn = getattr(module, name)

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(module, name, timed)
    try:
        yield spent
    finally:
        setattr(module, name, fn)


def train_steps(dev, cfg, seq: int, accum: int, steps: int) -> dict:
    """``cfg`` at its published widths and depth (bf16 weights from
    ``init_params`` at seed 0) trained through ``make_train_step`` on
    ``PackedLMDataset(..., cfg)`` at ``seq`` positions, micro-batch
    TRAIN_MICRO and ``accum`` microbatches a step: one warm-up step, then
    ``steps`` timed with the launch counters reset just before, then one
    under the profiler (the device's busy share), and for the ``ssm``
    family one with each sLSTM layer's forward loop timed alone."""
    import torch
    from repro_torch.data.pipeline import DataConfig, PackedLMDataset, Prefetcher
    from repro_torch.kernels import attention_cuda as ac
    from repro_torch.launch.dryrun import train_plan
    from repro_torch.models import model, xlstm
    from repro_torch.models.config import LOCAL
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train.step import make_train_step

    t_start = time.perf_counter()
    global_batch = TRAIN_MICRO * accum
    torch.cuda.reset_peak_memory_stats()
    lm = model.init_params(cfg, SEED, device=dev)
    n_params = sum(p.numel() for p in lm.parameters())
    total = 1 + steps
    # the moments' dtypes from the plan (bf16 for a big model); the plan's
    # grad_accum is cut to ``accum`` for the run's time
    plan = train_plan(cfg)
    opt = AdamW(lr=warmup_cosine(TRAIN_LR, total // 10 + 1, total),
                m_dtype=plan["m_dtype"], v_dtype=plan["v_dtype"])
    opt_state = opt.init(lm)
    step_fn = make_train_step(cfg, LOCAL, opt, grad_accum=accum)
    ds = PackedLMDataset(DataConfig(seed=SEED, vocab_size=cfg.vocab_size,
                                    seq_len=seq, global_batch=global_batch),
                         cfg)
    it = Prefetcher(ds.iterate(0), depth=2)
    batches = lambda: {k: torch.from_numpy(v).to(dev)
                       for k, v in next(it).items()}

    def one_step():
        nonlocal lm, opt_state
        lm, opt_state, met = step_fn(lm, opt_state, batches())
        return met

    torch.cuda.synchronize()
    out = {"params": n_params, "setup_s": time.perf_counter() - t_start,
           "init_peak_memory": torch.cuda.max_memory_allocated(),
           "moments_dtype": str(plan["m_dtype"]),
           "plan_grad_accum": plan["grad_accum"]}
    t0 = time.perf_counter()
    met = one_step()                                   # warm-up
    torch.cuda.synchronize()
    out["warmup_step_s"] = time.perf_counter() - t0
    losses, step_ms = [float(met["loss"])], []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        met = one_step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    out.update(launches=read_counts(), routes=dict(ac.ROUTE_LAUNCHES),
               max_memory_allocated=torch.cuda.max_memory_allocated())
    # one more step under the profiler: the device's busy share
    t0 = time.perf_counter()
    out["step_busy"] = device_busy(
        lambda: losses.append(float(one_step()["loss"])), cpu_ops=False)
    out["profiled_step_s"] = time.perf_counter() - t0
    if cfg.family == "ssm":
        # the forward sLSTM loops (seq steps of eager ops each) timed alone
        # inside one more step, as the ssm phase times them in a prefill
        with timing(xlstm, "slstm_seq", []) as spent:
            t0 = time.perf_counter()
            losses.append(float(one_step()["loss"]))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        out["slstm_forward"] = {"step_wall_ms": wall,
                                "slstm_layers_ms": spent,
                                "slstm_share": sum(spent) / wall}
    it.close()
    med = sorted(step_ms)[len(step_ms) // 2]
    positions = seq + (cfg.num_prefix_tokens if cfg.family == "vlm" else 0)
    flops = model.model_flops_per_step(cfg, global_batch, positions)
    out.update(positions=positions, micro_batch=TRAIN_MICRO, grad_accum=accum,
               global_batch=global_batch, remat=cfg.remat, lr_peak=TRAIN_LR,
               losses=losses, step_ms=step_ms, step_ms_median=med,
               tokens_per_s=global_batch * positions / (med / 1e3),
               model_flops_per_step=flops,
               mfu=flops / (med / 1e3) / BF16_OPS_PER_S,
               busy_share_of_median_step=(
                   out["step_busy"]["device_ms"] / med
                   if out["step_busy"]["device_ms"] else "not measured"))
    return out


def reckon_drive(cfg, positions: int, accum: int) -> dict:
    """``launch.dryrun`` at a training drive's exact configuration
    (``cfg``'s depth, ``positions`` a sequence, micro-batch TRAIN_MICRO,
    ``accum`` microbatches), before the drive: it must fit the card."""
    from repro_torch.launch import dryrun

    art = dryrun.run_cell(
        cfg.name, "train_4k", verbose=False,
        cfg_overrides={"num_layers": cfg.num_layers},
        plan_overrides={"grad_accum": accum},
        shape_overrides={"seq_len": positions,
                         "global_batch": TRAIN_MICRO * accum})
    require(art["status"] == "ok",
            f"dry run {cfg.name}: {art.get('error')}")
    require(art["fits_hbm"], f"dry run {cfg.name}: {art['memory']} does "
                             f"not fit the card")
    return art


def dryrun_memory(art: dict, measured: int) -> tuple:
    """The drive's dry run (:func:`reckon_drive`) beside its measured
    ``max_memory_allocated``; returns (its line, what is wrong)."""
    mem = art["memory"]
    arg, peak = mem["argument_bytes"], mem["peak_bytes"]
    line = {"argument_bytes": arg, "argument_bytes_by_part":
            mem["argument_bytes_by_part"], "peak_bytes": peak,
            "argument_plus_peak": arg + peak,
            "max_memory_allocated": measured,
            "argument_share_of_measured": arg / measured,
            "reckoned_over_measured": (arg + peak) / measured,
            "fits_hbm": art["fits_hbm"], "plan": art["plan"],
            "trace_s": art["trace_s"]}
    wrong = []
    if arg > measured:
        wrong.append(f"dry run: argument bytes {arg} above the measured "
                     f"{measured}")
    if abs((arg + peak) / measured - 1) > DRYRUN_MEMORY_RTOL:
        wrong.append(f"dry run: argument + peak {arg + peak} not within "
                     f"{DRYRUN_MEMORY_RTOL} of the measured {measured}")
    return line, wrong


def check_train_steps(cfg, res: dict, steps: int) -> tuple:
    """The steps' expected launch counts (exact, FLASH_ATTENTION all on the
    tensor-core route), written into ``res``; returns (the per-step counts,
    what is wrong: launches, routes or non-finite losses)."""
    fwd, n_attn, n_ssd = train_regions(cfg)
    accum = res["grad_accum"]
    # the backward is the plain versions' gradient and launches nothing
    per_step = {"FLASH_ATTENTION": fwd * n_attn * accum,
                "SSD_INTRA": fwd * n_ssd * accum}
    expected = dict.fromkeys(res["launches"], 0)
    expected.update({k: v * steps for k, v in per_step.items()})
    routes = {"tensor_core_prefill": expected["FLASH_ATTENTION"],
              "split_k_decode": 0, "cuda_core": 0}
    res.update(expected=expected, expected_routes=routes)
    wrong = []
    if not all(math.isfinite(x) for x in res["losses"]):
        wrong.append(f"non-finite losses {res['losses']}")
    if res["launches"] != expected:
        wrong.append(f"launch counts {res['launches']} != {expected}")
    if res["routes"] != routes:
        wrong.append(f"FLASH_ATTENTION routes {res['routes']} != {routes}")
    return per_step, wrong


def phase_train(dev, smi: str):
    """zamba2-1.2b trained at its published widths through
    ``train.step.make_train_step`` and ``PackedLMDataset``: (a) gradient
    parity of the CUDA template against TORCH with a planted fault, then
    (b) one warm-up step and TRAIN_STEPS timed steps at train_4k's
    sequence, with the launch counters reset just before them."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config

    t_phase = time.perf_counter()
    pcfg = dataclasses.replace(get_config(LM_ARCH),
                               num_layers=TRAIN_PARITY_LAYERS)
    parity = train_parity(dev, pcfg, train_batch(pcfg, TRAIN_PARITY_SEQ, 1,
                                                 dev),
                          ("FlashAttentionFn", _zero_dq_fn()),
                          ["stack.shared_attn.attn.wq"])
    parts = {"parity_s": time.perf_counter() - t_phase}
    cfg = get_config(LM_ARCH)
    art = reckon_drive(cfg, TRAIN_SEQ, TRAIN_ACCUM)
    res = train_steps(dev, cfg, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS)
    per_step, wrong = check_train_steps(cfg, res, TRAIN_STEPS)
    reckoned, off = dryrun_memory(art, res["max_memory_allocated"])
    t0 = time.perf_counter()
    bwd = plain_backward_ms(cfg, dev)
    parts["plain_backward_s"] = time.perf_counter() - t0
    line = {"phase": "train", "arch": LM_ARCH, "card": smi,
            "params": res["params"],
            "seq": TRAIN_SEQ, "micro_batch": TRAIN_MICRO,
            "grad_accum": TRAIN_ACCUM, "global_batch": res["global_batch"],
            "reduced": "global batch 2, cut from train_4k's 256 to fit the "
                       "run's time; 1 warm-up and 4 timed steps",
            "remat": cfg.remat, "lr_peak": TRAIN_LR,
            "parity": parity, "warmup_step_s": res["warmup_step_s"],
            "losses": res["losses"], "step_ms": res["step_ms"],
            "step_ms_median": res["step_ms_median"],
            "tokens_per_s": res["tokens_per_s"],
            "model_flops_per_step": res["model_flops_per_step"],
            "mfu": res["mfu"],
            "max_memory_allocated": res["max_memory_allocated"],
            "dryrun_memory": reckoned,
            "moments_dtype": res["moments_dtype"],
            "launches": res["launches"], "expected": res["expected"],
            "launches_per_step": per_step,
            "flash_attention_routes": res["routes"],
            "step_busy": res["step_busy"],
            "busy_share_of_median_step": res["busy_share_of_median_step"],
            # one backward a region a microbatch: half the launches
            "plain_backward_ms": bwd,
            "plain_backward_ms_per_step": {
                k: bwd[k] * (v // 2) for k, v in per_step.items()},
            "seconds": time.perf_counter() - t_phase,
            "setup_s": res["setup_s"],
            "profiled_step_s": res["profiled_step_s"], **parts}
    emit(line)
    require(not wrong + off, f"train: {wrong + off}")
    gc.collect()
    torch.cuda.empty_cache()
    return res["launches"]


def train_family(dev, smi: str, arch: str, parity_layers, parity_tokens: int,
                 accum: int) -> dict:
    """One family's training drive (phase 15): gradient parity at
    ``parity_layers`` (None: all) and ``parity_tokens`` positions with its
    planted fault, then train_steps at TRAIN_SEQ and the plain backwards
    at that shape; one ``train`` line."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    published = cfg.num_layers
    if arch in TRAIN_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=TRAIN_DEPTH[arch])
    pcfg = (cfg if parity_layers is None
            else dataclasses.replace(cfg, num_layers=parity_layers))
    if cfg.family == "ssm":
        fault = ("SSDIntraFn", _drop_dc_fn())
        lost = [f"stack.layers.{i}.wq.w" for i in range(pcfg.num_layers)
                if i not in pcfg.slstm_indices]
    else:
        fault = ("FlashAttentionFn", _zero_dq_fn())
        lost = [f"stack.layers.{i}.attn.wq" for i in range(pcfg.num_layers)]
    parity = train_parity(dev, pcfg, train_batch(pcfg, parity_tokens, 1, dev),
                          fault, lost)
    parts = {"parity_s": time.perf_counter() - t_phase}
    prefix = cfg.num_prefix_tokens if cfg.family == "vlm" else 0
    art = reckon_drive(cfg, TRAIN_SEQ + prefix, accum)
    res = train_steps(dev, cfg, TRAIN_SEQ, accum, TRAIN_FAMILY_STEPS)
    per_step, wrong = check_train_steps(cfg, res, TRAIN_FAMILY_STEPS)
    t0 = time.perf_counter()
    bwd = plain_backward_ms(cfg, dev, TRAIN_SEQ + prefix, prefix)
    parts["plain_backward_s"] = time.perf_counter() - t0
    fwd = train_regions(cfg)[0]
    reckoned, off = dryrun_memory(art, res["max_memory_allocated"])
    cut = ([f"depth {cfg.num_layers} of {published} layers to fit one card"]
           if cfg.num_layers != published else [])
    line = {"phase": "train", "arch": arch, "family": cfg.family,
            "card": smi, "layers": cfg.num_layers,
            "published_layers": published, "seq": TRAIN_SEQ,
            "reduced": "; ".join(cut + [
                f"global batch {res['global_batch']}, cut from train_4k's "
                f"256 to fit the run's time",
                f"grad_accum {accum} of train_plan's "
                f"{res['plan_grad_accum']}",
                f"1 warm-up and {TRAIN_FAMILY_STEPS} timed steps"]),
            "parity": parity, **res,
            "launches_per_step": per_step,
            "dryrun_memory": reckoned,
            "plain_backward_ms": bwd,
            # one backward a region a microbatch
            "plain_backward_ms_per_step": {
                k: bwd[k] * (v // fwd) for k, v in per_step.items()
                if k in bwd},
            "seconds": time.perf_counter() - t_phase, **parts}
    emit(line)
    require(not wrong + off, f"train {arch}: {wrong + off}")
    gc.collect()
    torch.cuda.empty_cache()
    return res["launches"]


def phase_train_families(dev, smi: str) -> dict:
    """Phase 15: the ssm, vlm and audio families trained at their published
    widths and depths on the card, one after the other; each drive's
    launches by path."""
    import torch

    paths = {}
    for arch, layers, tokens, accum in TRAIN_FAMILIES:
        gc.collect()
        torch.cuda.empty_cache()
        paths[f"train_{arch}"] = train_family(dev, smi, arch, layers, tokens,
                                              accum)
    kimi_dryrun()
    return paths


def kimi_dryrun() -> None:
    """kimi-k2 train_4k at KIMI_DRYRUN's depth, reckoned by the dry run
    and not run: it must not fit the card."""
    from repro_torch.launch import dryrun

    arch, layers = KIMI_DRYRUN
    art = dryrun.run_cell(arch, "train_4k", verbose=False,
                          cfg_overrides={"num_layers": layers})
    emit({"phase": "dryrun", "reason": "kimi-k2's training reckoned on one "
          "card, not run (one layer does not fit one card; the fsdp_tp step "
          "over a mesh needs several cards)", "layers": layers,
          **{k: art.get(k) for k in (
              "arch", "shape", "status", "error", "plan", "seq_len",
              "global_batch", "traced_microbatches", "n_params",
              "n_active_params", "memory", "fits_hbm", "hbm_bytes_of_chip",
              "flops_per_device", "hbm_bytes_per_device", "trace_s")}})
    require(art["status"] == "ok", f"dryrun {arch}: {art.get('error')}")
    require(art["fits_hbm"] is False,
            f"dryrun {arch}: {layers} layer(s) reckoned to fit one card")


# ---------------------------------------------------------------------------
@contextlib.contextmanager
def recording(module, name: str, keep):
    """Inside the context, ``module.name`` also appends ``keep(result)`` of
    each call to the list the context yields."""
    fn, seen = getattr(module, name), []

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        seen.append(keep(out))
        return out

    setattr(module, name, wrapped)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def forced_routing(chosen: list):
    """Inside the context, the n-th call of ``moe._route`` takes the n-th
    of ``chosen``'s top-k ids (recorded from another run with
    :func:`recording`), its gates the router's own probabilities at them.
    Remat ``block`` calls ``_route`` again in the backward's recompute, in
    the same order in both runs, so call n of one run is call n of the
    other.  Yields the ids taken."""
    from repro_torch.models import moe

    route, taken = moe._route, []

    def forced(params, cfg, x2d, **kw):
        ids = chosen[len(taken)]
        taken.append(ids)
        return route(params, cfg, x2d, ids=ids, **kw)

    moe._route = forced
    try:
        yield taken
    finally:
        moe._route = route


def topk_agreement(got: list, want: list) -> float:
    """Share of the (call, token) top-k sets of ``got`` equal to
    ``want``'s (each a list of (T, k) id tensors, call by call)."""
    import torch

    same = total = 0
    for a, b in zip(got, want, strict=True):
        eq = torch.sort(a, 1).values == torch.sort(b, 1).values
        same += int(eq.all(dim=1).sum())
        total += b.shape[0]
    return same / total


@contextlib.contextmanager
def planted_short_attention():
    """The planted fault the parity checks must reject: inside the
    context, every FLASH_ATTENTION launch is given a valid key length
    ATTN_FAULT_KEYS short."""
    import torch
    from repro_torch.kernels import attention_cuda as ac

    launch = ac._launch

    def short(q, k, v, spec, valid, scale, return_lse=False):
        sk = k.shape[1]
        valid = (sk - ATTN_FAULT_KEYS if valid is None
                 else (valid - ATTN_FAULT_KEYS).clamp(min=1)
                 if torch.is_tensor(valid)
                 else max(1, valid - ATTN_FAULT_KEYS))
        return launch(q, k, v, spec, valid, scale, return_lse)

    ac._launch = short
    try:
        yield
    finally:
        ac._launch = launch


def moe_parity(cfg, lm, dev):
    """One MOE_PARITY_PLEN-token prompt prefilled, then LM_PARITY_STEPS
    decode steps on the TORCH template (choosing the tokens) and on the
    CUDA template, each MoE layer's top-k sets recorded.

    The checked CUDA run is teacher-forced in its tokens and in each
    layer's input: every attention block takes the TORCH run's input to
    that block (its KV cache rows then follow from the same inputs), so a
    layer's top-k sets and the logits differ from TORCH's by one
    application of the kernel, not by what earlier layers passed on.  Left
    free, the runs diverge by a cascade that any two correct attentions
    show: a near-tie flips one expert in layer 0, that token's residual
    changes, and the next layer's attention passes the change to every
    later token.  The free run is reported beside the checked one, with
    the same cascade between two plain versions (TORCH with its kv_chunk
    at 256 instead of the whole sequence: the online softmax over four
    chunks).  The checked run again with the planted attention fault,
    which the check must reject."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import model, moe, transformer

    rng = np.random.default_rng(SEED + 1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           size=MOE_PARITY_PLEN)).to(dev)[None]
    block = transformer._attn_block

    def run(template, tokens=None, inputs=None, run_cfg=cfg):
        seen = []                   # each attention block's input

        def forced_block(p, cfg_, x, shard, **kw):
            seen.append(x)
            if inputs is not None:
                x = inputs[len(seen) - 1]
            return block(p, cfg_, x, shard, **kw)

        transformer._attn_block = forced_block
        try:
            with recording(moe, "_route", lambda out: out[0]) as experts:
                caches = model.init_caches(run_cfg, 1, LM_MAX_SEQ,
                                           torch.float32, dev)
                logits, caches = model.prefill(lm, run_cfg,
                                               {"tokens": prompt}, caches,
                                               template=template)
                out, chosen = [logits[0, -1].float()], []
                for step in range(LM_PARITY_STEPS):
                    tok = tokens[step] if tokens else int(out[-1].argmax())
                    chosen.append(tok)
                    logits, caches = model.decode_step(
                        lm, run_cfg, torch.tensor([[tok]], device=dev),
                        caches, MOE_PARITY_PLEN + step, template=template)
                    out.append(logits[0, -1].float())
                torch.cuda.synchronize()
        finally:
            transformer._attn_block = block
        return {"logits": out, "tokens": chosen, "experts": experts,
                "inputs": seen}

    def compare(got, want):
        by_layer = [[0, 0] for _ in range(cfg.num_layers)]
        for i, (a, b) in enumerate(zip(got["experts"], want["experts"])):
            same = torch.sort(a, 1).values == torch.sort(b, 1).values
            by_layer[i % cfg.num_layers][0] += int(same.all(dim=1).sum())
            by_layer[i % cfg.num_layers][1] += b.shape[0]
        rel = [float((a - b).norm() / b.norm())
               for a, b in zip(got["logits"], want["logits"])]
        return {"topk_sets_agree": (sum(n for n, _ in by_layer)
                                    / sum(t for _, t in by_layer)),
                "topk_sets_agree_by_layer": [n / t for n, t in by_layer],
                "topk_sets": sum(t for _, t in by_layer),
                "logits_rel_l2": rel, "logits_rel_l2_max": max(rel),
                "argmax_equal": [int(a.argmax()) == int(b.argmax())
                                 for a, b in zip(got["logits"],
                                                 want["logits"])],
                "finite": all(bool(torch.isfinite(a).all())
                              for a in got["logits"])}

    want = run("TORCH")
    tokens, inputs = want["tokens"], want["inputs"]
    res = compare(run("CUDA", tokens, inputs), want)
    free = compare(run("CUDA", tokens), want)
    plain = compare(run("TORCH", tokens, run_cfg=dataclasses.replace(
        cfg, kv_chunk=256)), want)
    with planted_short_attention():
        fault = compare(run("CUDA", tokens, inputs), want)
    passes = lambda r: (r["finite"] and r["topk_sets_agree"] >= MOE_TOPK_AGREE
                        and r["logits_rel_l2_max"] <= MOE_LOGIT_REL)
    res.update(prompt_len=MOE_PARITY_PLEN, steps=LM_PARITY_STEPS,
               layer_inputs_forced=True, passes=passes(res),
               free_running=free, free_running_plain_vs_plain=plain,
               planted_fault=fault, planted_fault_passes=passes(fault))
    return res


def moe_serve(arch: str, layers: int, n_requests: int, dev, smi: str):
    """One moe config at its published widths, ``layers`` deep: served,
    checked and timed (phase 12)."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model, moe, transformer
    from repro_torch.serve.engine import ServingEngine, _bucket

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = model.init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in lm.parameters())

    eng = ServingEngine(cfg, lm, slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                        device=dev, backend="cuda")
    reqs = lm_requests(cfg, n_requests, MOE_PROMPT, MOE_NEW)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # each prefill's summed dropped fraction (stack_seq's metrics; a
    # decode step goes through stack_step, which returns none)
    with recording(transformer, "stack_seq",
                   lambda out: out[2].moe_dropped) as drops:
        steps, wall, launches, routes = drive_engine(eng)
    peak = torch.cuda.max_memory_allocated()
    prefills, decode_steps = sum(a for a, _ in steps), eng.steps
    expected = dict.fromkeys(launches, 0)
    expected["FLASH_ATTENTION"] = layers * (prefills + decode_steps)
    expected_routes = {"tensor_core_prefill": layers * prefills,
                       "split_k_decode": layers * decode_steps,
                       "cuda_core": 0}
    done = {r.rid: r for r in eng.finished}
    tokens = sum(len(r.output) for r in done.values())
    decode_ms = sorted(ms for a, ms in steps if a == 0)

    # prefill time per bucket (one slot's cache rows); the same prompt
    # prefilled twice must give the same logits bit for bit
    one = model.init_caches(cfg, 1, LM_MAX_SEQ, torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prefill_ms = {}
    for b in sorted({_bucket(len(r.prompt)) for r in reqs}):
        toks = torch.randint(0, cfg.vocab_size, (1, b), device=dev,
                             generator=gen)
        prefill_ms[b] = cuda_ms(lambda: model.prefill(
            lm, cfg, {"tokens": toks}, one, template="CUDA"), reps=3,
            warmup=1)
    prompt = torch.from_numpy(reqs[0].prompt).to(dev)[None]
    twice = []
    for _ in range(2):
        one.k.zero_()
        one.v.zero_()
        twice.append(model.prefill(lm, cfg, {"tokens": prompt}, one,
                                   template="CUDA")[0])
    deterministic = torch.equal(twice[0], twice[1])
    del one, twice

    # a decode step with every slot resident, under the profiler: the
    # device's busy share and the expert FFN's part of the device time
    for r in lm_requests(cfg, LM_SLOTS, MOE_PROMPT, MOE_NEW):
        r.max_new_tokens = 1000
        eng.submit(r)
    eng.step()                                  # admit all four
    eng.step()
    ffn = moe._expert_ffn

    def labelled(*args):
        with torch.profiler.record_function("expert_ffn"):
            return ffn(*args)

    moe._expert_ffn = labelled
    try:
        busy = device_busy(eng.step, ranges=("expert_ffn",))
    finally:
        moe._expert_ffn = ffn
    if busy["device_ms"] and busy["expert_ffn_ms"] != "not measured":
        busy["expert_ffn_share"] = busy["expert_ffn_ms"] / busy["device_ms"]
    # the expert FFN alone at the decode step's buffer (E, capacity(4), d),
    # beside the least time for its weights' bytes
    experts = lm.stack.layers[0].ffn.experts
    cap = moe._capacity(LM_SLOTS, cfg)
    xin = torch.zeros(cfg.num_experts, cap, cfg.d_model,
                      dtype=cfg.compute_dtype, device=dev)
    ffn_ms = cuda_ms(lambda: moe._expert_ffn(experts, xin,
                                             cfg.compute_dtype), reps=10)
    ffn_bytes = sum(t.numel() * t.element_size()
                    for t in (experts.gate, experts.up, experts.down))
    del eng, xin
    parity = moe_parity(cfg, lm, dev)

    line = {"phase": "moe", "arch": arch, "card": smi,
            "layers": layers, "published_layers": get_config(arch).num_layers,
            "reduced": f"depth {layers} of {get_config(arch).num_layers} "
                       "layers to fit one card; every width published",
            "params": n_params, "active_params_per_token":
                cfg.active_param_count(),
            "init_s": init_s, "init_max_memory_allocated": init_peak,
            "slots": LM_SLOTS, "max_seq": LM_MAX_SEQ,
            "requests": n_requests,
            "prompt_lens": [len(r.prompt) for r in reqs],
            "new_tokens": MOE_NEW, "engine_steps": decode_steps,
            "prefills": prefills, "launches": launches, "expected": expected,
            "flash_attention_routes": routes,
            "expected_routes": expected_routes,
            "prefill_moe_dropped": [float(d) for d in drops],
            "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "prefill_ms_by_bucket": prefill_ms,
            "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
            "decode_step_ms_min": decode_ms[0],
            "decode_steps_timed": len(decode_ms),
            "decode_step_busy": busy,
            "expert_ffn_decode_ms_a_layer": ffn_ms,
            "expert_ffn_decode_bound_ms_a_layer":
                ffn_bytes / HBM_BYTES_PER_S * 1e3,
            "max_memory_allocated": peak,
            "prefill_bitwise_deterministic": deterministic,
            "parity": parity,
            "first_tokens": {rid: done[rid].output[:8]
                             for rid in sorted(done)}}
    emit(line)
    require(len(done) == n_requests and prefills == n_requests,
            f"moe {arch}: {len(done)} of {n_requests} requests finished")
    require(all(len(r.output) == MOE_NEW and
                all(0 <= t < cfg.vocab_size for t in r.output)
                for r in done.values()),
            f"moe {arch}: outputs of the wrong length")
    require(launches == expected,
            f"moe {arch}: launch counts {launches} != {expected}")
    require(routes == expected_routes,
            f"moe {arch}: FLASH_ATTENTION routes {routes} != "
            f"{expected_routes}")
    require(len(drops) == prefills and all(
        0.0 <= float(d) < layers for d in drops),
        f"moe {arch}: prefill dropped fractions {drops}")
    require(deterministic, f"moe {arch}: two prefills of one prompt differ")
    require(parity["passes"], f"moe {arch}: cuda and torch templates "
                              f"disagree: {parity}")
    require(not parity["planted_fault_passes"],
            f"moe {arch}: the parity check passed a planted attention "
            f"fault: {parity['planted_fault']}")
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_moe(dev, smi: str):
    """Phase 12: the moe family at its published widths through the
    ported ServingEngine on the cuda backend, one config after the
    other; their launches summed."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    total: dict = {}
    for arch, layers, n in MOE_ARCHS:
        for k, v in moe_serve(arch, layers, n, dev, smi).items():
            total[k] = total.get(k, 0) + v
    return total


# ---------------------------------------------------------------------------
def row_rel(a, b) -> float:
    """The worst row's relative L2 error (a row: the last dimension), in
    float32."""
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())


def ssm_parity(cfg, lm, dev):
    """One prompt (the lm phase's first) prefilled, then LM_PARITY_STEPS
    decode steps on the TORCH template (choosing the tokens) and on the
    CUDA template, each block's input and output recorded.

    The checked CUDA run is teacher-forced in its tokens and in each
    block's input: every xLSTM block takes the TORCH run's input to that
    block, so each block's output differs from TORCH's by one application
    of the kernel (SSD_INTRA in the mLSTM prefills), not by what earlier
    blocks passed on.  The check holds the logits and each token row of
    every block's output to LM_PARITY_RTOL in relative L2.  The block
    outputs are what can see a fault, since with forced inputs the logits
    follow from the last block, an sLSTM; and a row at a time, since a
    chunk's incoming state weighs only on its first rows (the forget gate
    decays it by ~0.95 a step), which a norm over the whole prompt
    dilutes.  At random init an mLSTM cell's output is far below the
    RMSNorm's eps, so an mLSTM block adds little to the residual stream:
    the check also holds each (token, head) row of every mLSTM layer's SSD
    output (``ssd_core``'s y, which SSD_INTRA computes) to LM_PARITY_RTOL.  Beside it: the free-running runs (tokens forced, inputs
    free; and nothing forced, the greedy tokens' agreement).  Then the
    checked run again with one mLSTM layer's s_in zeroed (the first
    SSD_INTRA launch of the prefill), which the check must reject."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import model, xlstm

    prompt = torch.from_numpy(lm_requests(cfg)[0].prompt).to(dev)[None]
    plen = prompt.shape[1]
    names = ("mlstm_seq", "slstm_seq", "mlstm_step", "slstm_step")
    blocks = {name: getattr(xlstm, name) for name in names}
    core = xlstm.ssd_core

    def run(template, tokens=None, inputs=None):
        seen, outs, ssd = [], [], []

        def recorded_core(*args, **kw):
            y, final = core(*args, **kw)
            ssd.append(y)
            return y, final

        def forced(fn):
            def call(p, cfg_, x, *args, **kw):
                seen.append(x)
                if inputs is not None:
                    x = inputs[len(seen) - 1]
                out = fn(p, cfg_, x, *args, **kw)
                outs.append(out[0].float())
                return out
            return call

        for name in names:
            setattr(xlstm, name, forced(blocks[name]))
        xlstm.ssd_core = recorded_core
        try:
            caches = model.init_caches(cfg, 1, LM_MAX_SEQ, torch.float32,
                                       dev)
            logits, caches = model.prefill(lm, cfg, {"tokens": prompt},
                                           caches, template=template)
            out, chosen = [logits[0, -1].float()], []
            for step in range(LM_PARITY_STEPS):
                tok = tokens[step] if tokens else int(out[-1].argmax())
                chosen.append(tok)
                logits, caches = model.decode_step(
                    lm, cfg, torch.tensor([[tok]], device=dev), caches,
                    plen + step, template=template)
                out.append(logits[0, -1].float())
            torch.cuda.synchronize()
        finally:
            for name in names:
                setattr(xlstm, name, blocks[name])
            xlstm.ssd_core = core
        return {"logits": out, "tokens": chosen, "inputs": seen,
                "outputs": outs, "ssd": ssd}

    rel = lambda a, b: float((a - b).norm() / b.norm())

    def compare(got, want):
        logits = [rel(a, b) for a, b in zip(got["logits"], want["logits"])]
        blocks_ = [row_rel(a, b)
                   for a, b in zip(got["outputs"], want["outputs"])]
        return {"logits_rel_l2": logits, "logits_rel_l2_max": max(logits),
                "ssd_rows_rel_l2_max": max(
                    row_rel(a, b) for a, b in zip(got["ssd"], want["ssd"])),
                "block_rows_rel_l2_max": max(blocks_),
                "block_outputs_rel_l2_max": max(
                    rel(a, b) for a, b in zip(got["outputs"],
                                              want["outputs"])),
                "block_worst": int(max(range(len(blocks_)),
                                       key=blocks_.__getitem__)),
                "argmax_equal": [int(a.argmax()) == int(b.argmax())
                                 for a, b in zip(got["logits"],
                                                 want["logits"])],
                "finite": all(bool(torch.isfinite(a).all())
                              for a in got["logits"] + got["outputs"])}

    want = run("TORCH")
    tokens, inputs = want["tokens"], want["inputs"]
    res = compare(run("CUDA", tokens, inputs), want)
    free = compare(run("CUDA", tokens), want)
    greedy = run("CUDA")
    kernel = ops.ssd_intra
    calls = []

    def zeroed_s_in(x, log_decay, in_scale, b_, c_, s_in, template=None):
        calls.append(1)
        if len(calls) == 1:
            s_in = torch.zeros_like(s_in)
        return kernel(x, log_decay, in_scale, b_, c_, s_in,
                      template=template)

    ops.ssd_intra = zeroed_s_in
    try:
        fault = compare(run("CUDA", tokens, inputs), want)
    finally:
        ops.ssd_intra = kernel
    passes = lambda r: (r["finite"]
                        and r["logits_rel_l2_max"] <= LM_PARITY_RTOL
                        and r["block_rows_rel_l2_max"] <= LM_PARITY_RTOL
                        and r["ssd_rows_rel_l2_max"] <= LM_PARITY_RTOL)
    res.update(prompt_len=plen, steps=LM_PARITY_STEPS,
               block_inputs_forced=True, passes=passes(res),
               free_running=free,
               free_running_greedy_tokens_agree=sum(
                   a == b for a, b in zip(greedy["tokens"], tokens))
               / len(tokens),
               planted_fault=fault, planted_fault_passes=passes(fault))
    return res


def slstm_host_ms(cfg, lm, dev, b: int) -> dict:
    """One CUDA prefill of ``b`` tokens with each sLSTM layer's sequence
    (the loop over time: ``b`` steps of eager ops) timed alone, wall clock
    between synchronises; the prefill's wall time beside it."""
    import torch
    from repro_torch.models import model, xlstm

    toks = torch.zeros((1, b), dtype=torch.long, device=dev)
    caches = model.init_caches(cfg, 1, LM_MAX_SEQ, torch.float32, dev)
    with timing(xlstm, "slstm_seq", []) as spent:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(lm, cfg, {"tokens": toks}, caches, template="CUDA")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return {"prefill_wall_ms": wall, "slstm_layers_ms": spent,
            "slstm_share": sum(spent) / wall}


def phase_ssm(dev, smi: str):
    """Phase 13: xlstm-125m at its published widths and depth through the
    ported ServingEngine on the cuda backend: exact launch counts (10
    SSD_INTRA a prefill, none a decode step), two prefills bitwise equal,
    CUDA-vs-TORCH parity with a planted fault, and the times."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model
    from repro_torch.serve.engine import ServingEngine, _bucket

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(SSM_ARCH)
    n_mlstm = cfg.num_layers - len(cfg.slstm_indices)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = model.init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())

    eng = ServingEngine(cfg, lm, slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                        device=dev, backend="cuda")
    reqs = lm_requests(cfg)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, wall, launches, routes = drive_engine(eng)
    peak = torch.cuda.max_memory_allocated()
    prefills, decode_steps = sum(a for a, _ in steps), eng.steps
    expected = dict.fromkeys(launches, 0)
    expected["SSD_INTRA"] = n_mlstm * prefills
    done = {r.rid: r for r in eng.finished}
    tokens = sum(len(r.output) for r in done.values())
    decode_ms = sorted(ms for a, ms in steps if a == 0)

    # prefill time per bucket (one slot's cache rows), the sLSTM loop's
    # host time inside one prefill a bucket; the same prompt prefilled
    # twice must give the same logits bit for bit
    buckets = sorted({_bucket(len(r.prompt)) for r in reqs})
    one = model.init_caches(cfg, 1, LM_MAX_SEQ, torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prefill_ms, slstm = {}, {}
    for b in buckets:
        toks = torch.randint(0, cfg.vocab_size, (1, b), device=dev,
                             generator=gen)
        prefill_ms[b] = cuda_ms(lambda: model.prefill(
            lm, cfg, {"tokens": toks}, one, template="CUDA"), reps=2,
            warmup=1)
        slstm[b] = slstm_host_ms(cfg, lm, dev, b)
    prompt = torch.from_numpy(reqs[0].prompt).to(dev)[None]
    twice = []
    for _ in range(2):
        model.reset_caches(cfg, one)
        twice.append(model.prefill(lm, cfg, {"tokens": prompt}, one,
                                   template="CUDA")[0])
    deterministic = torch.equal(twice[0], twice[1])
    del one, twice

    # a decode step with every slot resident, under the profiler
    for r in lm_requests(cfg)[:LM_SLOTS]:
        r.max_new_tokens = 1000
        eng.submit(r)
    eng.step()                                  # admit all four
    eng.step()
    busy = device_busy(eng.step)
    del eng
    parity = ssm_parity(cfg, lm, dev)

    line = {"phase": "ssm", "arch": SSM_ARCH, "card": smi,
            "layers": cfg.num_layers, "slstm_layers": list(cfg.slstm_indices),
            "reduced": "nothing: every width and all 12 layers published",
            "params": n_params, "init_s": init_s,
            "slots": LM_SLOTS, "max_seq": LM_MAX_SEQ,
            "requests": LM_REQUESTS,
            "prompt_lens": [len(r.prompt) for r in reqs],
            "new_tokens": LM_NEW, "engine_steps": decode_steps,
            "prefills": prefills, "launches": launches, "expected": expected,
            "flash_attention_routes": routes,
            "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "prefill_ms_by_bucket": prefill_ms,
            "slstm_host_by_bucket": slstm,
            "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
            "decode_step_ms_min": decode_ms[0],
            "decode_steps_timed": len(decode_ms),
            "decode_step_busy": busy, "max_memory_allocated": peak,
            "prefill_bitwise_deterministic": deterministic,
            "parity": parity,
            "first_tokens": {rid: done[rid].output[:8]
                             for rid in sorted(done)}}
    emit(line)
    require(len(done) == LM_REQUESTS and prefills == LM_REQUESTS,
            f"ssm: {len(done)} of {LM_REQUESTS} requests finished")
    require(all(len(r.output) == LM_NEW and
                all(0 <= t < cfg.vocab_size for t in r.output)
                for r in done.values()), "ssm: outputs of the wrong length")
    require(launches == expected,
            f"ssm: launch counts {launches} != {expected}")
    require(deterministic, "ssm: two prefills of one prompt differ")
    require(parity["passes"], f"ssm: cuda and torch templates disagree: "
                              f"{parity}")
    require(not parity["planted_fault_passes"],
            f"ssm: the parity check passed a zeroed s_in: "
            f"{parity['planted_fault']}")
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
def mm_parity(cfg, lm, dev, batch, plen: int, prefix_len: int):
    """``batch`` (the stub embeddings, and paligemma's text tokens)
    prefilled, then MM_STEPS decode steps, on the TORCH template (choosing
    the tokens) and on the CUDA template, each attention block's input and
    output and each attention output recorded.

    The checked CUDA run is teacher-forced in its tokens and in each
    block's input, as in the moe and ssm phases, so each block differs
    from TORCH's by one application of the kernel.  The check holds the
    logits, each token row of every block's output and each (token, head)
    row of every attention output to LM_PARITY_RTOL in relative L2: at
    random init the logits alone can miss a fault.  Beside it the free
    run (tokens forced, block inputs free).  Planted faults, each run
    through the checked run, each to be rejected: every FLASH_ATTENTION
    launch given ATTN_FAULT_KEYS keys too few; and, where there is a
    prefix, the prefill's attention run causal only (``prefix_len`` 0),
    which the prefix rows' attention outputs must show."""
    import torch
    from repro_torch.models import blocks, model, transformer

    block = transformer._attn_block
    seq_attn, step_attn = blocks.chunked_mha, blocks.decode_mha

    def run(template, tokens=None, inputs=None, causal_only=False):
        seen, outs, attn = [], [], []

        def forced_block(p, cfg_, x, shard, **kw):
            seen.append(x)
            if inputs is not None:
                x = inputs[len(seen) - 1]
            out = block(p, cfg_, x, shard, **kw)
            outs.append(out[0])
            return out

        def recorded(fn):
            def call(*args, **kw):
                out = fn(*args, **kw)
                attn.append(out)
                return out
            return call

        def no_prefix(q, k, v, spec, *args, **kw):
            return seq_attn(q, k, v, spec._replace(prefix_len=0), *args, **kw)

        transformer._attn_block = forced_block
        blocks.chunked_mha = recorded(no_prefix if causal_only else seq_attn)
        blocks.decode_mha = recorded(step_attn)
        try:
            caches = model.init_caches(cfg, 1, LM_MAX_SEQ, torch.float32,
                                       dev)
            logits, caches = model.prefill(lm, cfg, batch, caches,
                                           template=template)
            out, chosen = [logits[0, -1].float()], []
            for step in range(MM_STEPS):
                tok = tokens[step] if tokens else int(out[-1].argmax())
                chosen.append(tok)
                logits, caches = model.decode_step(
                    lm, cfg, torch.tensor([[tok]], device=dev), caches,
                    plen + step, template=template)
                out.append(logits[0, -1].float())
            torch.cuda.synchronize()
        finally:
            transformer._attn_block = block
            blocks.chunked_mha, blocks.decode_mha = seq_attn, step_attn
        return {"logits": out, "tokens": chosen, "inputs": seen,
                "outputs": outs, "attention": attn}

    rel = lambda a, b: float((a - b).norm() / b.norm())

    def compare(got, want):
        logits = [rel(a, b) for a, b in zip(got["logits"], want["logits"])]
        pairs = list(zip(got["attention"], want["attention"]))
        prefill = [(a, b) for a, b in pairs if b.shape[1] == plen]
        return {"logits_rel_l2": logits, "logits_rel_l2_max": max(logits),
                "block_rows_rel_l2_max": max(
                    row_rel(a, b) for a, b in zip(got["outputs"],
                                                  want["outputs"])),
                "attention_rows_rel_l2_max": max(row_rel(a, b)
                                                 for a, b in pairs),
                "prefix_attention_rows_rel_l2_max": (max(
                    row_rel(a[:, :prefix_len], b[:, :prefix_len])
                    for a, b in prefill) if prefix_len else None),
                "attention_outputs": len(pairs),
                "prefill_attention_outputs": len(prefill),
                "argmax_equal": [int(a.argmax()) == int(b.argmax())
                                 for a, b in zip(got["logits"],
                                                 want["logits"])],
                "finite": all(bool(torch.isfinite(a).all())
                              for a in got["logits"] + got["outputs"])}

    want = run("TORCH")
    tokens, inputs = want["tokens"], want["inputs"]
    res = compare(run("CUDA", tokens, inputs), want)
    free = compare(run("CUDA", tokens), want)
    with planted_short_attention():
        faults = {"short_keys": compare(run("CUDA", tokens, inputs), want)}
    if prefix_len:
        faults["prefix_len_0"] = compare(
            run("CUDA", tokens, inputs, causal_only=True), want)
    passes = lambda r: (r["finite"]
                        and r["logits_rel_l2_max"] <= LM_PARITY_RTOL
                        and r["block_rows_rel_l2_max"] <= LM_PARITY_RTOL
                        and r["attention_rows_rel_l2_max"] <= LM_PARITY_RTOL)
    res.update(rtol=LM_PARITY_RTOL, prompt_len=plen, prefix_len=prefix_len,
               steps=MM_STEPS, block_inputs_forced=True, passes=passes(res),
               free_running=free, planted_faults=faults,
               planted_faults_pass={k: passes(v) for k, v in faults.items()})
    return res


def mm_embeddings(cfg, lm, dev) -> dict:
    """The arch's stub embeddings (``models.multimodal``) through
    ``model.prefill`` and MM_STEPS greedy ``decode_step``s on the CUDA
    template, with the launch counters reset just before: one
    FLASH_ATTENTION launch a layer a prefill (tensor-core route, the
    prefix bidirectional) and a decode step (split-K); the prefill timed
    and run twice (bitwise equal), then the parity check."""
    import numpy as np
    import torch
    from repro_torch.kernels import attention_cuda as ac
    from repro_torch.models import model, multimodal

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED + 2)
    if cfg.family == "vlm":
        text = rng.integers(0, cfg.vocab_size, size=(1, MM_TEXT))
        batch = {"prefix_embeds": multimodal.patch_embeddings(gen, cfg, 1),
                 "tokens": torch.from_numpy(text).to(dev)}
        prefix_len = cfg.num_prefix_tokens
        plen = prefix_len + MM_TEXT
    else:
        batch = {"embeds": multimodal.frame_embeddings(gen, cfg, 1,
                                                       MM_FRAMES)}
        prefix_len, plen = 0, MM_FRAMES
    fresh = lambda: model.init_caches(cfg, 1, LM_MAX_SEQ, torch.float32, dev)
    caches = fresh()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits, caches = model.prefill(lm, cfg, batch, caches, template="CUDA")
    torch.cuda.synchronize()
    prefill_wall_ms = (time.perf_counter() - t0) * 1e3
    prefill_routes = dict(ac.ROUTE_LAUNCHES)
    first = logits[0, -1].float()
    chosen, step_ms = [], []
    for step in range(MM_STEPS):
        tok = int(logits[0, -1].argmax())
        chosen.append(tok)
        t0 = time.perf_counter()
        logits, caches = model.decode_step(
            lm, cfg, torch.tensor([[tok]], device=dev), caches, plen + step,
            template="CUDA")
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches, routes = read_counts(), dict(ac.ROUTE_LAUNCHES)
    finite = bool(torch.isfinite(first).all()) and bool(
        torch.isfinite(logits).all())
    n = cfg.num_layers
    expected = dict.fromkeys(launches, 0)
    expected["FLASH_ATTENTION"] = n * (1 + MM_STEPS)
    expected_routes = {"tensor_core_prefill": n, "split_k_decode":
                       n * MM_STEPS, "cuda_core": 0}
    del caches
    one = fresh()
    prefill_ms = cuda_ms(lambda: model.prefill(lm, cfg, batch, one,
                                               template="CUDA"),
                         reps=3, warmup=1)
    twice = []
    for _ in range(2):
        model.reset_caches(cfg, one)
        twice.append(model.prefill(lm, cfg, batch, one, template="CUDA")[0])
    deterministic = torch.equal(twice[0], twice[1])
    del one, twice
    parity = mm_parity(cfg, lm, dev, batch, plen, prefix_len)
    res = {"input": sorted(batch), "prompt_len": plen,
           "prefix_len": prefix_len, "decode_steps": MM_STEPS,
           "launches": launches, "expected": expected,
           "flash_attention_routes": routes,
           "expected_routes": expected_routes,
           "prefill_flash_attention_routes": prefill_routes,
           "prefill_ms": prefill_ms, "prefill_wall_ms": prefill_wall_ms,
           "decode_step_ms": step_ms, "tokens": chosen, "finite": finite,
           "prefill_bitwise_deterministic": deterministic, "parity": parity}
    what = f"multimodal {cfg.name} embeddings"
    require(finite, f"{what}: non-finite logits")
    require(all(0 <= t < cfg.vocab_size for t in chosen),
            f"{what}: tokens outside the vocabulary")
    require(launches == expected,
            f"{what}: launch counts {launches} != {expected}")
    require(routes == expected_routes,
            f"{what}: FLASH_ATTENTION routes {routes} != {expected_routes}")
    require(deterministic, f"{what}: two prefills of one input differ")
    require(parity["passes"],
            f"{what}: cuda and torch templates disagree: {parity}")
    require(not any(parity["planted_faults_pass"].values()),
            f"{what}: the parity check passed a planted fault: "
            f"{parity['planted_faults_pass']}")
    if prefix_len:
        require(parity["planted_faults"]["prefix_len_0"]
                ["prefix_attention_rows_rel_l2_max"] > LM_PARITY_RTOL,
                f"{what}: the prefix rows passed a causal-only prefill")
    return res


def mm_serve(arch: str, dev, smi: str):
    """One multimodal arch at its published widths and depth: served on
    token prompts, checked and timed, then its embeddings path (phase
    14)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model
    from repro_torch.serve.engine import ServingEngine, _bucket

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = model.init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in lm.parameters())

    eng = ServingEngine(cfg, lm, slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                        device=dev, backend="cuda")
    reqs = lm_requests(cfg, MM_REQUESTS, MOE_PROMPT, MOE_NEW)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, wall, launches, routes = drive_engine(eng)
    peak = torch.cuda.max_memory_allocated()
    prefills, decode_steps = sum(a for a, _ in steps), eng.steps
    n = cfg.num_layers
    expected = dict.fromkeys(launches, 0)
    expected["FLASH_ATTENTION"] = n * (prefills + decode_steps)
    expected_routes = {"tensor_core_prefill": n * prefills,
                       "split_k_decode": n * decode_steps, "cuda_core": 0}
    done = {r.rid: r for r in eng.finished}
    tokens = sum(len(r.output) for r in done.values())
    decode_ms = sorted(ms for a, ms in steps if a == 0)

    # prefill time per bucket (one slot's cache rows)
    one = model.init_caches(cfg, 1, LM_MAX_SEQ, torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prefill_ms = {}
    for b in sorted({_bucket(len(r.prompt)) for r in reqs}):
        toks = torch.randint(0, cfg.vocab_size, (1, b), device=dev,
                             generator=gen)
        prefill_ms[b] = cuda_ms(lambda: model.prefill(
            lm, cfg, {"tokens": toks}, one, template="CUDA"), reps=3,
            warmup=1)
    del one
    # a decode step with every slot resident, under the profiler
    for r in lm_requests(cfg, LM_SLOTS, MOE_PROMPT, MOE_NEW):
        r.max_new_tokens = 1000
        eng.submit(r)
    eng.step()                                  # admit all four
    eng.step()
    busy = device_busy(eng.step)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    emb = mm_embeddings(cfg, lm, dev)

    line = {"phase": "multimodal", "arch": arch, "family": cfg.family,
            "card": smi, "layers": n,
            "reduced": f"nothing: every width and all {n} layers published",
            "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
            "params": n_params, "init_s": init_s,
            "init_max_memory_allocated": init_peak,
            "slots": LM_SLOTS, "max_seq": LM_MAX_SEQ,
            "requests": MM_REQUESTS,
            "prompt_lens": [len(r.prompt) for r in reqs],
            "new_tokens": MOE_NEW, "engine_steps": decode_steps,
            "prefills": prefills, "launches": launches, "expected": expected,
            "flash_attention_routes": routes,
            "expected_routes": expected_routes,
            "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "prefill_ms_by_bucket": prefill_ms,
            "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
            "decode_step_ms_min": decode_ms[0],
            "decode_steps_timed": len(decode_ms),
            "decode_step_busy": busy, "max_memory_allocated": peak,
            "embeddings": emb,
            "first_tokens": {rid: done[rid].output[:8]
                             for rid in sorted(done)}}
    emit(line)
    require(len(done) == MM_REQUESTS and prefills == MM_REQUESTS,
            f"multimodal {arch}: {len(done)} of {MM_REQUESTS} requests "
            "finished")
    require(all(len(r.output) == MOE_NEW and
                all(0 <= t < cfg.vocab_size for t in r.output)
                for r in done.values()),
            f"multimodal {arch}: outputs of the wrong length")
    require(launches == expected,
            f"multimodal {arch}: launch counts {launches} != {expected}")
    require(routes == expected_routes,
            f"multimodal {arch}: FLASH_ATTENTION routes {routes} != "
            f"{expected_routes}")
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    return {k: v + emb["launches"][k] for k, v in launches.items()}


def phase_multimodal(dev, smi: str, kernel_results: dict):
    """Phase 14: FLASH_ATTENTION at the multimodal shapes (head dim 256 on
    every route; its lines join the kernel summary), then paligemma-3b and
    musicgen-large at their published widths and depths, one after the
    other; their launches summed."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    cases = attention_cases(gen, dev, MM_ATTN_CASES,
                            [c[0] for c in MM_ATTN_CASES])
    from repro_torch.kernels import attention_cuda as ac

    attn = kernel_results["FLASH_ATTENTION"]
    attn["head_dims"] = list(ac.HEAD_DIMS)
    attn["cases"].update(cases["cases"])
    attn["max_abs_err"] = max(attn["max_abs_err"], cases["max_abs_err"])
    torch.cuda.empty_cache()
    total: dict = {}
    for arch in MM_ARCHS:
        for k, v in mm_serve(arch, dev, smi).items():
            total[k] = total.get(k, 0) + v
    return total


# ---------------------------------------------------------------------------
def main(argv: list) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("sharded", "decomposed"),
                    default=None,
                    help="run the card and build phases and this one only")
    only = ap.parse_args(argv).phase
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repository)

    t_start = time.perf_counter()
    smi = phase_card()
    phase_build()
    dev = torch.device("cuda")
    if only is not None:
        if only == "sharded":
            phase_sharded(dev, smi)
        else:
            from repro_torch import api

            serial_state = api.runtime(n=N, nz=N, backend="cuda",
                                       device=dev).run(
                "cavity", steps=STEPS, re=100.0).state
            phase_decomposed(dev, smi, serial_state)
        emit({"phase": "done", "only": only,
              "seconds": time.perf_counter() - t_start, "card": smi})
        return 0
    kernel_results = phase_kernels(dev)
    paths = {}
    paths["serial"], serial_state = phase_main(kernel_results, dev)
    paths["farm"], farm_results = phase_farm(dev, "farm", PER_STEP)
    paths["durable"], health = phase_durable(dev, paths["farm"],
                                             farm_results, smi)
    paths.update(phase_perf(dev, smi, serial_state, paths["farm"],
                            farm_results, health))
    paths["decomposed"] = phase_decomposed(dev, smi, serial_state)
    (paths["sharded"], paths["sharded_serving"], paths["sharded_ssm_sp"],
     paths["sharded_a2a"]) = phase_sharded(dev, smi)
    del farm_results, serial_state
    paths["farm_fused"], _ = phase_farm(dev, "farm_fused", PER_STEP_FUSED,
                                        fused_sweeps=FUSED_K)
    paths["throughput"] = phase_throughput(dev)
    phase_physics(dev)
    paths["lm"] = phase_lm(dev)
    paths["train"] = phase_train(dev, smi)
    paths["moe"] = phase_moe(dev, smi)
    paths["ssm"] = phase_ssm(dev, smi)
    paths["multimodal"] = phase_multimodal(dev, smi, kernel_results)
    paths.update(phase_train_families(dev, smi))
    # each kernel's launches on the path that carries it: the farm for the
    # four stencils, the fused-smoother farm for JACOBI_FUSED, the zamba2
    # serving path for FLASH_ATTENTION and SSD_INTRA
    carrier = {name: "farm" for name in STENCILS}
    carrier["JACOBI_FUSED"] = "farm_fused"
    carrier.update(dict.fromkeys(LM_KERNELS, "lm"))
    for name in KERNELS:
        require(paths[carrier[name]][name] > 0,
                f"{name} never launched on the {carrier[name]} path")
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCE[name],
        "replaces": REPLACES[name], "instance": INSTANCE[name],
        "launches": paths[carrier[name]][name],
        "launches_by_path": {k: v[name] for k, v in paths.items()},
        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
        **({key: r[key] for key in ("head_dims", "cases") if key in r}),
    } for name, r in kernel_results.items()]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "card": smi})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
