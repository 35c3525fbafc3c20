#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as JSON lines; any failure exits non-zero:

1. card      the card's name and power limit (nvidia-smi) and torch's name;
2. build     the CUDA kernels built from ``src/repro_torch/kernels/csrc``,
             one nvcc per source, all started together;
3. kernels   each hand-written kernel against its plain PyTorch version on
             the card, at its main-path shape (256^3; k = 2 sweeps for
             JACOBI_FUSED), an odd shape and a slot-batched call with
             distinct parameter rows, and the farm's 4-slot 256^3 call
             (timed: the shape of the farm's launches; JACOBI_FUSED also
             for k = 1..4 and for x extents about its segment length, each
             with a planted fault, a zeroed ghost face, that the check must
             reject); the four stencils must equal their plain versions
             bit for bit at 256^3, serial and at the 4-slot launch (every
             operation of theirs is rounded as written), and each plain
             stencil body on the card must equal the same body on the CPU
             bit for bit on a seeded 64^3 input;
             CUDA-event times of kernel (under the autotuned tile the
             main path launches) and plain version (the kernel's
             with the stream given a head start, so that its own device
             time is read, not its wrapper's host time) beside the least
             time the card could take (bytes over 3.35 TB/s or operations
             over the peak rate of their type, H100 SXM data-sheet peaks);
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

The kernel phase also holds FLASH_ATTENTION (the zamba2 prefill and decode
shapes and its 4096-token training forward, llama3-8b's GQA widths at
prefill and decode, qwen3-moe's GQA 16:1 and kimi-k2's head dim 112 at
prefill and decode and on the CUDA-core route, an odd shape with
``prefix_len`` and ``q_offset``, blind rows and valid lengths about a
split on the bf16 routes, and a bf16-q float32-k/v prefill on the CUDA-core
route: every route of ``attention_cuda.route`` is launched and checked per
query row, and a planted fault of 64 missing keys must fail the same
check) and SSD_INTRA (the zamba2 prefills of 512, 1024 and 2048 tokens,
its 4096-token training forward (32 chunks) and an odd shape; the
xlstm-125m prefills of 512, 1024 and 2048 tokens on mLSTM-like inputs, N
200 / P 129 / L 48 and N 129 / P 385; each with a planted fault, one
head's s_in zeroed)
against their plain versions, beside ``scaled_dot_product_attention``'s
time on the same inputs (``is_causal`` for a plain causal mask, else the
boolean mask; a yardstick only, the port never calls it).

The line before the last is the ``{"kernels": [...]}`` summary
(FLASH_ATTENTION's entry carries its prefill, decode, llama3 GQA,
training, moe and multimodal (head dim 256) cases side by side under
``cases`` and its head dims under ``head_dims``, the stencils and
JACOBI_FUSED their serial and farm calls, SSD_INTRA its three zamba2 and
three xlstm prefill lengths and its training shape; ``launches_by_path``
includes the train, moe, ssm and multimodal phases'); the last line is
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


def compare(name, inputs, table):
    import torch
    from repro_torch.kernels import stencil3d_cuda as sc

    got = sc.KERNELS[name](*inputs, table)
    want = sc.PLAIN[name](*inputs, table)
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
             ("farm", FARM_SLOTS, (N, N, N), farm_cfgs)]
    farm_gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    results = {}
    for name in stencil3d.DESCRIPTORS:
        res = {"max_abs_err": 0.0, "cases": {}}
        for case, S, interior, cfgs in cases:
            inputs = kernel_inputs(name, S, interior,
                                   farm_gen if case == "farm" else gen, dev)
            table = param_rows(name, cfgs, dev)
            if S is None:
                table = table[0]
            err, tol, finite, bitwise, outs = compare(name, inputs, table)
            line = {"phase": "kernel", "kernel": name, "case": case,
                    "slots": S or 1, "interior": list(interior),
                    "max_abs_diff": err, "tolerance": tol, "finite": finite,
                    "bitwise": bitwise}
            if case in ("main", "farm"):
                nbytes, ops = op_cost.stencil_cost(name, inputs, outs, table)
                kern = sc.KERNELS[name]
                plain = sc.PLAIN[name]
                # the main path's launch: the autotuned tile
                tile = autotune.tile_for(stencil3d.DESCRIPTORS[name],
                                         interior).tile
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
            if case in ("main", "farm"):
                require(bitwise, f"{name} ({case}): kernel and plain version "
                                 f"differ (max {err}), not bitwise")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            del inputs, outs
        results[name] = res
        plain_card_vs_cpu(name, dev)
    results["JACOBI_FUSED"] = jacobi_fused_cases(gen, dev)
    results["FLASH_ATTENTION"] = attention_cases(gen, dev)
    results["SSD_INTRA"] = ssd_cases(gen, dev)
    torch.cuda.empty_cache()
    return results


def jacobi_fused_cases(gen, dev):
    """JACOBI_FUSED against ``jacobi_fused_ref`` on the card: the 256^3
    serial call (k = 2, timed), the fused farm's 4-slot call (timed), an odd
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
             ("odd", None, (5, 7, 3), FUSED_K),
             *((f"k{k}", None, (37, 20, 45), k) for k in (1, 2, 3, 4)),
             *((f"x{nx}", None, (nx, 17, 33), FUSED_K)
               for nx in (1, seg - 1, seg, seg + 1)),
             ("batched", 3, (24, 20, 18), FUSED_K)]
    res = {"max_abs_err": 0.0, "cases": {}}
    for case, S, interior, k in cases:
        batch = () if S is None else (S,)
        shape = batch + tuple(n + 2 * k for n in interior)
        p = torch.rand(shape, generator=gen, device=dev) * 2 - 1
        rhs = torch.rand(shape, generator=gen, device=dev) * 2 - 1
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
        if case in ("main", "farm"):
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
]
# the cases whose times the kernels line gives side by side
ATTN_HEADLINE = ("prefill", "decode", "gqa_llama3", "train_4k",
                 "prefill_gqa_qwen3moe", "decode_gqa_qwen3moe",
                 "prefill_kimi_d112", "decode_kimi_d112", "cuda_core_d112")


def attention_diff(got, want, dtype: str):
    """max|got - want| and its largest share of the per-row tolerance
    ATTN_RTOL * max|want row| + ATTN_ATOL (a row: one query, one head)."""
    diff = (got.float() - want.float()).abs()
    tol = (ATTN_RTOL[dtype] * want.float().abs().amax(dim=-1, keepdim=True)
           + ATTN_ATOL)
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


# B nc L G R P N: the zamba2-1.2b prefills of 1024 (the headline), 512 and
# 2048 tokens (chunks of 128, one group, 64 heads of 64, state 64), an
# odd shape, and the train phase's 4096 tokens (32 chunks); the
# xlstm-125m prefills of 512, 1024 and 2048 tokens (its mLSTM: 4 heads as
# the groups, R 1, N 384 = the head dim, P 385 = v and the normalizer's
# ones column), and two untimed odd shapes across N and P 128
SSD_CASES = [("prefill", (1, 8, 128, 1, 64, 64, 64)),
             ("prefill_512", (1, 4, 128, 1, 64, 64, 64)),
             ("prefill_2048", (1, 16, 128, 1, 64, 64, 64)),
             ("odd", (2, 3, 48, 1, 3, 16, 8)),
             ("train_4k", (1, TRAIN_SEQ // 128, 128, 1, 64, 64, 64)),
             ("prefill_xlstm_512", (1, 4, 128, 4, 1, 385, 384)),
             ("prefill_xlstm_1024", (1, 8, 128, 4, 1, 385, 384)),
             ("prefill_xlstm_2048", (1, 16, 128, 4, 1, 385, 384)),
             ("odd_n200_p129_l48", (2, 3, 48, 2, 3, 129, 200)),
             ("odd_n129_p385", (1, 2, 128, 1, 2, 385, 129))]


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
    step)."""
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
    averages = prof.key_averages()
    # a range may also show as a device-side annotation: kept out of the sum
    events = [ev for ev in averages if ev.device_type == DeviceType.CUDA
              and ev.key not in ranges]
    busy = sum(ev.self_device_time_total for ev in events) / 1e3
    # each range: its device-side span, or its host range's kernels
    in_range = {}
    for ev in averages:
        if ev.key in ranges:
            ms = (ev.self_device_time_total if ev.device_type ==
                  DeviceType.CUDA else ev.device_time_total) / 1e3
            in_range[ev.key] = max(in_range.get(ev.key, 0.0), ms)
    # FLASH_ATTENTION's three kernels (csrc/attention.cu)
    names = ("prefill_kernel", "decode_kernel", "flash_kernel")
    attn = sum(ev.self_device_time_total for ev in events
               if any(name in ev.key for name in names)) / 1e3
    ssd = sum(ev.self_device_time_total for ev in events
              if "ssd_intra_kernel" in ev.key) / 1e3
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


def train_grads(cfg, lm, batch, template):
    """(loss, {name: float32 gradient}) of one ``loss_fn`` + backward."""
    import torch
    from repro_torch.models import model

    for p in lm.parameters():
        p.grad = None
    loss, _ = model.loss_fn(lm, cfg, batch, template=template)
    loss.backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.float() for n, p in lm.named_parameters()}
    for p in lm.parameters():
        p.grad = None
    return float(loss.detach()), grads


def grad_parity(got: dict, want: dict) -> dict:
    """Leaf by leaf: relative gradient-norm error and cosine of ``got``
    against ``want``, and the leaves that fail TRAIN_GRAD_REL /
    TRAIN_GRAD_COS or are zero where ``want``'s are not."""
    worst_rel, worst_cos, bad = 0.0, 1.0, []
    for name, w in want.items():
        g = got[name]
        wn, gn = float(w.norm()), float(g.norm())
        if wn == 0:
            continue
        if gn == 0:
            bad.append(f"{name}: zero")
            continue
        rel = float((g - w).norm()) / wn
        cos = float((g * w).sum()) / (gn * wn)
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
        if rel > TRAIN_GRAD_REL or cos < TRAIN_GRAD_COS:
            bad.append(f"{name}: rel {rel:.3g} cos {cos:.4f}")
    return {"worst_rel_norm_err": worst_rel, "worst_cosine": worst_cos,
            "failing_leaves": bad}


def train_parity(dev) -> dict:
    """(a) one loss + backward at zamba2's widths, 4 layers, on the CUDA and
    the TORCH template from the same weights and batch; then once more on
    CUDA with the planted zero-dq fault, which the check must reject."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, PackedLMDataset
    from repro_torch.kernels import autograd
    from repro_torch.models import model

    cfg = dataclasses.replace(get_config(LM_ARCH),
                              num_layers=TRAIN_PARITY_LAYERS)
    lm = model.init_params(cfg, SEED, device=dev).requires_grad_(True)
    ds = PackedLMDataset(DataConfig(seed=SEED, vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_PARITY_SEQ, global_batch=1))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch(0).items()}
    reset_counts()
    loss_cuda, g_cuda = train_grads(cfg, lm, batch, "CUDA")
    launched = read_counts()
    loss_torch, g_torch = train_grads(cfg, lm, batch, "TORCH")
    good = autograd.FlashAttentionFn
    autograd.FlashAttentionFn = _zero_dq_fn()
    try:
        _, g_fault = train_grads(cfg, lm, batch, "CUDA")
    finally:
        autograd.FlashAttentionFn = good
    ok, fault = grad_parity(g_cuda, g_torch), grad_parity(g_fault, g_torch)
    n_attn = cfg.num_layers // cfg.attn_every
    out = {"layers": cfg.num_layers, "attn_applications": n_attn,
           "seq": TRAIN_PARITY_SEQ, "loss_cuda": loss_cuda,
           "loss_torch": loss_torch,
           "loss_rel_diff": abs(loss_cuda - loss_torch) / abs(loss_torch),
           "leaves": len(g_torch), "launches_cuda": launched, **ok,
           "planted_fault_failing_leaves": fault["failing_leaves"],
           "tolerances": {"loss_rel": TRAIN_LOSS_RTOL,
                          "grad_rel_norm": TRAIN_GRAD_REL,
                          "grad_cosine": TRAIN_GRAD_COS}}
    del lm, g_cuda, g_torch, g_fault
    torch.cuda.empty_cache()
    require(out["loss_rel_diff"] <= TRAIN_LOSS_RTOL,
            f"train parity: losses {loss_cuda} (cuda) and {loss_torch} "
            f"(torch) differ by more than {TRAIN_LOSS_RTOL}")
    require(not ok["failing_leaves"],
            f"train parity: gradients disagree: {ok['failing_leaves'][:5]}")
    require(any(".attn.wq: zero" in f for f in fault["failing_leaves"]),
            "train parity: the check passed a FLASH_ATTENTION backward that "
            f"drops q's gradient ({fault['failing_leaves'][:5]})")
    # remat "block" runs each group's forward twice
    want = {"FLASH_ATTENTION": 2 * n_attn, "SSD_INTRA": 2 * cfg.num_layers}
    require({k: launched[k] for k in want} == want,
            f"train parity: launches {launched}, expected {want}")
    return out


def plain_backward_ms(cfg, dev) -> dict:
    """Device time of one plain backward of each kernel's region at the
    train phase's shapes (what the Functions run, and what a backward
    kernel would replace)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.models.attention import MaskSpec, chunked_mha

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    qkv = [rnd(1, TRAIN_SEQ, cfg.num_heads, cfg.head_dim).to(torch.bfloat16)
           .requires_grad_(True) for _ in range(3)]
    out = chunked_mha(*qkv, MaskSpec(causal=True), q_chunk=cfg.q_chunk,
                      kv_chunk=cfg.kv_chunk, template="CUDA")
    g = torch.randn_like(out)
    attn = cuda_ms(lambda: torch.autograd.grad(out, qkv, g,
                                               retain_graph=True),
                   reps=3, warmup=1)
    nc, heads = TRAIN_SEQ // cfg.ssm_chunk, cfg.ssm_heads
    p, n = cfg.ssm_head_dim, cfg.ssm_state
    args = [rnd(1, nc, cfg.ssm_chunk, 1, heads, p),
            -F.softplus(rnd(1, nc, cfg.ssm_chunk, 1, heads)),
            F.softplus(rnd(1, nc, cfg.ssm_chunk, 1, heads)),
            rnd(1, nc, cfg.ssm_chunk, 1, n), rnd(1, nc, cfg.ssm_chunk, 1, n),
            rnd(1, nc, 1, heads, n, p) * 0.3]
    args = [a.requires_grad_(True) for a in args]
    y = ops.ssd_intra(*args, template="CUDA")
    gy = torch.randn_like(y)
    ssd = cuda_ms(lambda: torch.autograd.grad(y, args, gy,
                                              retain_graph=True),
                  reps=3, warmup=1)
    return {"FLASH_ATTENTION": attn, "SSD_INTRA": ssd}


def phase_train(dev, smi: str):
    """zamba2-1.2b trained at its published widths through
    ``train.step.make_train_step`` and ``PackedLMDataset``: (a) gradient
    parity of the CUDA template against TORCH with a planted fault, then
    (b) one warm-up step and TRAIN_STEPS timed steps at train_4k's
    sequence, with the launch counters reset just before them."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, PackedLMDataset, Prefetcher
    from repro_torch.models import model
    from repro_torch.models.config import LOCAL
    from repro_torch.models.transformer import n_attn_layers
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    parity = train_parity(dev)
    parts = {"parity_s": time.perf_counter() - t_phase}
    cfg = get_config(LM_ARCH)
    require(cfg.remat == "block", f"train: remat {cfg.remat!r}, not block")
    global_batch = TRAIN_MICRO * TRAIN_ACCUM
    lm = model.init_params(cfg, SEED, device=dev)
    total = 1 + TRAIN_STEPS
    opt = AdamW(lr=warmup_cosine(TRAIN_LR, total // 10 + 1, total))
    opt_state = opt.init(lm)
    step_fn = make_train_step(cfg, LOCAL, opt, grad_accum=TRAIN_ACCUM)
    ds = PackedLMDataset(DataConfig(seed=SEED, vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_SEQ,
                                    global_batch=global_batch), cfg)
    it = Prefetcher(ds.iterate(0), depth=2)
    batches = lambda: {k: torch.from_numpy(v).to(dev)
                       for k, v in next(it).items()}

    def one_step():
        nonlocal lm, opt_state
        lm, opt_state, met = step_fn(lm, opt_state, batches())
        return met

    torch.cuda.synchronize()
    parts["setup_s"] = time.perf_counter() - t_phase - parts["parity_s"]
    t0 = time.perf_counter()
    met = one_step()                                   # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    losses, step_ms = [float(met["loss"])], []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        met = one_step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    # one more step under the profiler: the device's busy share
    t0 = time.perf_counter()
    busy = device_busy(lambda: losses.append(float(one_step()["loss"])),
                       cpu_ops=False)
    parts["profiled_step_s"] = time.perf_counter() - t0
    it.close()
    n_attn, n_mamba = n_attn_layers(cfg), cfg.num_layers
    # each microbatch runs every forward twice (remat "block"); the
    # backward is the plain versions' gradient and launches nothing
    per_step = {"FLASH_ATTENTION": 2 * n_attn * TRAIN_ACCUM,
                "SSD_INTRA": 2 * n_mamba * TRAIN_ACCUM}
    expected = dict.fromkeys(launches, 0)
    expected.update({k: v * TRAIN_STEPS for k, v in per_step.items()})
    med = sorted(step_ms)[len(step_ms) // 2]
    tokens = global_batch * TRAIN_SEQ
    flops = model.model_flops_per_step(cfg, global_batch, TRAIN_SEQ)
    t0 = time.perf_counter()
    bwd = plain_backward_ms(cfg, dev)
    parts["plain_backward_s"] = time.perf_counter() - t0
    line = {"phase": "train", "arch": LM_ARCH, "card": smi,
            "params": sum(p.numel() for p in lm.parameters()),
            "seq": TRAIN_SEQ, "micro_batch": TRAIN_MICRO,
            "grad_accum": TRAIN_ACCUM, "global_batch": global_batch,
            "reduced": "global batch 2, cut from train_4k's 256 to fit the "
                       "run's time; 1 warm-up and 4 timed steps",
            "remat": cfg.remat, "lr_peak": TRAIN_LR,
            "parity": parity, "warmup_step_s": warm_s, "losses": losses,
            "step_ms": step_ms, "step_ms_median": med,
            "tokens_per_s": tokens / (med / 1e3),
            "model_flops_per_step": flops,
            "mfu": flops / (med / 1e3) / BF16_OPS_PER_S,
            "max_memory_allocated": peak, "launches": launches,
            "expected": expected, "launches_per_step": per_step,
            "step_busy": busy,
            "busy_share_of_median_step": (busy["device_ms"] / med
                                          if busy["device_ms"] else
                                          "not measured"),
            # one backward a region a microbatch: half the launches
            "plain_backward_ms": bwd,
            "plain_backward_ms_per_step": {
                k: bwd[k] * (v // 2) for k, v in per_step.items()},
            "seconds": time.perf_counter() - t_phase, **parts}
    emit(line)
    require(all(math.isfinite(x) for x in losses),
            f"train: non-finite losses {losses}")
    require(launches == expected,
            f"train: launch counts {launches} != {expected}")
    del lm, opt_state, step_fn
    torch.cuda.empty_cache()
    return launches


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
def planted_short_attention():
    """The planted fault the parity checks must reject: inside the
    context, every FLASH_ATTENTION launch is given a valid key length
    ATTN_FAULT_KEYS short."""
    import torch
    from repro_torch.kernels import attention_cuda as ac

    launch = ac._launch

    def short(q, k, v, spec, valid, scale):
        sk = k.shape[1]
        valid = (sk - ATTN_FAULT_KEYS if valid is None
                 else (valid - ATTN_FAULT_KEYS).clamp(min=1)
                 if torch.is_tensor(valid)
                 else max(1, valid - ATTN_FAULT_KEYS))
        return launch(q, k, v, spec, valid, scale)

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

    fn, spent = xlstm.slstm_seq, []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0) * 1e3)
        return out

    toks = torch.zeros((1, b), dtype=torch.long, device=dev)
    caches = model.init_caches(cfg, 1, LM_MAX_SEQ, torch.float32, dev)
    xlstm.slstm_seq = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(lm, cfg, {"tokens": toks}, caches, template="CUDA")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        xlstm.slstm_seq = fn
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
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repository)

    t_start = time.perf_counter()
    smi = phase_card()
    phase_build()
    dev = torch.device("cuda")
    kernel_results = phase_kernels(dev)
    paths = {}
    paths["serial"], serial_state = phase_main(kernel_results, dev)
    paths["farm"], farm_results = phase_farm(dev, "farm", PER_STEP)
    paths["durable"], health = phase_durable(dev, paths["farm"],
                                             farm_results, smi)
    paths.update(phase_perf(dev, smi, serial_state, paths["farm"],
                            farm_results, health))
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
    sys.exit(main())
