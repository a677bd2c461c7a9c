"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/csrc/`, holds each
against its plain PyTorch version on the card at the serving paths'
shapes, serves 2048 AIDS-like pairs through
`simgnn_query_server(use_kernels=True)` in batches of 256 (the packed-sparse
path), forces the packed-dense and bucketed paths on one batch each, serves
2048 pairs of average degree 8 on the same auto server (the packed-dense
path, one `packed_pair` launch a request), and checks the scores against
the port's reference path on the card and its plain path on the CPU. Then it serves similarity search: a
`SimilaritySearchServer` indexes an 8192-graph corpus, answers exact and
two-stage (prefilter + rerank) top-10 queries, saves and reloads its index,
and is held against the same server on the CPU; and it forces the engine's
`embedding_cache` and `two_kernel` paths on one batch each. Then it serves
the MoE language model granite-moe-3b-a800m at full width and depth in
bf16 (4 prompts of 512 tokens, 16 greedy tokens) through `greedy_generate`
with the expert FFN in the `moe_experts` kernel, holds it against the same
model with the plain expert function on the card, and a 2-layer float32
model on the card against the CPU. Last (phases 12-17) it holds the
`flash_attn`, `wkv6` and `mamba_scan` kernels against their plain versions
at the served shapes, serves rwkv6-7b at full width and depth in bf16 (the
same 4 x 512-token prompts and 16 greedy tokens, one `wkv6` launch per
layer and step), runs granite's prefill on a 4096-token prompt (one
`flash_attn` launch per layer), runs Jamba's Mamba block at full width
(prefill and 16 decode steps), and holds 2-layer float32 rwkv6 and granite
models and the reduced Jamba hybrid on the card against the CPU. Phase 18
captures a latency profile of the SimGNN-AIDS paths `bucketed_mega`,
`packed_dense` and `packed_sparse` on the card (forced engines sharing one
`TraceRecorder`), fits the measured planner's cost model from it and
replays the workloads on an auto engine with `planner="measured"`
(printing its picks, predicted and measured ms, the pick-versus-best
share and the crossovers the fit implies; gating its scores). Phase 19
trains SimGNN-AIDS on the card through `ScoringEngine.loss_and_grad` and
`build_simgnn_train_step` (no CUDA kernel runs there), held against the
CPU, with the step's time split, its idle share and each backward rule
timed alone. Phase 20 runs the training launcher (`python -m
repro_torch.launch.train`) in a process killed at a step (exit 42) and a
second one that resumes it from its checkpoint, holds the final params
and AdamW state bit-equal to an uninterrupted run's on the card (and
restored onto the CPU), times a checkpoint's save and verified restore,
and runs the three examples (`repro_torch.examples`: quickstart,
two-stage simgnn_search with the kernels, serve_lm against the CPU).
Phase 21 serves seamless-m4t-large-v2 (the enc-dec model, 1.77 B
parameters) at full width and depth in bf16 through the enc-dec prefill
and decode steps (4 x 1024 frames with a 128-token decoder prompt and 16
tokens, and 1 x 1024 frames with a 2048-token prompt: one `flash_attn`
launch per decoder layer), gated against its full forward and a reduced
float32 model against the CPU; trains it for 5 steps through
`build_train_step` (remat, bf16 params, float32 AdamW); holds the loss
and every gradient with the LM kernels in the forward (their backward
through the plain versions) against plain autograd for reduced granite
(`flash_attn`, `moe_experts`), rwkv6 (`wkv6`) and the Jamba hybrid
(`mamba_scan`), timing each kernel's forward beside its backward through
plain; holds three train steps of reduced qwen1.5-4b, internvl2-2b and
seamless against the CPU; and runs the launcher in LM mode killed at a
step and resumed (bit-equal to an uninterrupted run) and the `train_lm`
example. Phase 22 serves SimGNN-AIDS device-sharded over 2 and 4 devices
(the first N cards, or N logical devices over cuda:0, each its own
stream, on a one-card machine; printed): the AIDS and average-degree-8
streams through `simgnn_query_server(runtime=...)` bitwise equal to the
unsharded server with one launch a non-empty shard, the collapse rung
under a `raise` and a `nan` fault at `sharded:<path>`, and the
span-split search server with both prefilter proxies bit-equal to one
span (a dead span served by the exact scan); it prints request wall ms
and device span at 1, 2 and 4 shards and each shard's kernel ms. Phase 23
trains SimGNN-AIDS device-sharded over the same 2 and 4 devices (each
span's forward and backward on its own stream, the grads summed on the
first device): `loss_and_grad` on both packed paths against the
unsharded card call, 20 train steps against the unsharded run, the
collapse rung under a `raise` and a `nan` fault at
`sharded:train:packed_sparse`, and the launcher at `--devices 2` killed
and resumed at 2 and at 4 devices; it prints the step ms, the
`loss_and_grad` ms and the idle share at 1, 2 and 4 devices. Phase 24
trains on the LM mesh (`build_train_step(cfg, rt)` on `make_test_mesh`
meshes of logical devices over cuda:0; params and AdamW state stored as
per-device blocks, one data-parallel replica a batch row on its stream):
seamless-m4t-large-v2 at full width and depth in bf16 on (2, 2), (1, 4),
(2, 1) and (1, 1) beside the unsharded step ((1, 4) and (2, 2) on model
rows of 4 and 2 members; losses within 2e-2 relative, the grad norms,
final params and first moments within MESH_LIMITS, (1, 1) bit-equal; step
ms, peak memory and idle share printed), reduced float32
granite (`moe_experts`, and `flash_attn` at 2048 tokens), rwkv6 (`wkv6`)
and the Jamba hybrid (`mamba_scan`) on (2, 2) against the same steps on
logical CPU devices, a `--mesh 2x2` launcher run killed and resumed
(bit-equal) whose last checkpoint is restored onto (4, 1), (1, 1) and no
mesh and resharded live onto (1, 4), the launcher at `--mesh single`
(256 logical devices) and the `elastic_restart` example. Phase 25
pipelines granite-moe-3b-a800m at full width and depth in bf16 with GPipe
(`distributed/pipeline.gpipe`): its 32 layer groups in 4 stages of 8 on a
("stage",) mesh of 4 logical devices over cuda:0 (the first 4 cards where
the machine has them; printed), each stage on its own stream running its
groups with remat, 4 x 2048 tokens embedded outside the pipeline in 4
microbatches (`moe_experts` and `flash_attn` in every stage), the loss on
the caller's device: y bit-equal to the stages applied microbatch by
microbatch on one stream (`distributed/pipeline.sequential`), every
gradient bit-equal to that run's and the stage params' and x's within
`PIPE_LIMITS` of it, a dropped-microbatch control beyond them; the last
layer's `moe_experts` and `flash_attn` arguments captured in the
pipelined run and each kernel held there against its plain version; the
value-and-grad ms, idle share (busy as the union over streams), peak
memory and the kernels with the most device time of both runs printed;
and a 4-stage reduced float32 granite against logical CPU devices. Phase
26 serves tensor-parallel over the mesh's `model` axis
(`distributed/tensor_parallel.py`, logical devices over cuda:0 or the
first cards): granite at full width and depth on (1, 4), (2, 2) and (1,
1) (the phase 8-11 prompts and tokens, phase 15's 4096-token prompt),
rwkv6-7b on (1, 4) and Jamba's Mamba block on (1, 4), each beside
unsharded serving: (1, 1) bit-equal, the other meshes' logits within
TP_LIMITS and a dropped-partial control beyond them, float32 models at
full width (rwkv6-7b also at full depth) within TP_F32_CHECKS, the four
LM kernels held against their plain versions at the shard shapes, and
(e) seamless-m4t-large-v2 uncut on the same meshes through the enc-dec
steps (4 x 1024 frames and a 128-token prompt; 1 x 1024 frames and a
2048-token prompt on (1, 4), `flash_attn` in every member's decoder
layers, member 0's last call held against its plain version and timed
beside SDPA): (1, 1) bit-equal, the other meshes within
TP_LIMITS["seamless"], a control beyond it, 4 + 4 float32 layers within
TP_F32_LIMIT; wall, peak memory and idle share printed per mesh. Phase 27 trains tensor-parallel over `model`: granite
at full width and depth, the mesh train step's value-and-grad (each
replica's `lm_loss` with remat on its model row) on (1, 4), (2, 2) and
(1, 1) beside unsharded ((1, 1) bit-equal, the loss and
the gradient tree within TPT_LIMITS, a dropped-partial control beyond
them), one float32 `build_train_step` step of granite, rwkv6-7b and
Jamba's layer 0 at full width on (1, 4) and (2, 2) within
TPT_F32_LIMITS (rwkv6-7b's gradients also in float64), the four LM
kernels held at the training shard shapes; wall, peak memory, idle
share and the kernels with the most device time printed per mesh; and
(d) seamless-m4t-large-v2 uncut, each replica's `encdec_loss` on its
model row (the encoder's layers, then the decoder's reading the members'
enc_out), 1 x 1024 frames and a 2048-token decoder sequence on (1, 4) and
(1, 1), 2 x on (2, 2) (`flash_attn` in every member's decoder layers),
beside unsharded: (1, 1) bit-equal, the loss and the gradient tree within
TPT_LIMITS["seamless"], a dropped-partial control beyond them, member 0's
last decoder `flash_attn` call held against its plain version and timed
beside SDPA, and 4 + 4 float32 layers in one `build_train_step` step on
(1, 4) and (2, 2) within TPT_F32_LIMIT. Phase 28 holds the dry run
(`launch/dryrun.py`: the port's own layout and steps on the meta device)
against the card, at full width: phases 24 (a), 26 and 27 (d) record the
bytes they place at each mesh position (seamless's param and AdamW
blocks on (2, 2) and (1, 4); granite's `TPLayout` member slices and the
`TPCache` of its prompt on (1, 4)) and the peak of seamless's
value-and-grad on (1, 4) and (1, 1); the dry run of the same cells must
place the same bytes at every position, to the byte, and predict that
peak within DRYRUN_RATIO; and the dry-run CLI runs once at full size on
256 logical meta devices (DRYRUN_CLI). The predictions and the CLI run in
processes started ahead of phase 27 (`_dryrun_ahead`), and phase 28
reads them.
Phases 4-7 pin `planner="threshold"`. The launcher processes that phases
20, 21 (e), 23 and 24 (c)-(d) check run ahead of phase 20, while nothing
else runs, in two rounds of five processes started together
(`_run_ahead`: their start-up is most of their time); 24 (a) profiles
its last step, and 24 (b) runs MESH_CASE_STEPS steps. Every failed check exits non-zero.

Output: per-kernel lines, the served requests' split into host stages and
device span, the search stages, a `{"kernels": [...]}` JSON line, the
card's name and power limit, and as the last line `{"ok": true, "device":
{...}}`. Kernel `ms` is the kernel's device time from `torch.profiler`
(mean of warm launches; both passes for the top-M scans, both launches of
a bf16 expert FFN call); the bf16 `moe_experts` and `flash_attn` calls run
tensor-core kernels, and each call's path and tiling is printed beside
the float32 FMA body's time at the same shape;
the wrapper call and the plain version are timed with CUDA events (warm,
median); `fused_gcn` is also timed launch by launch for the search phase
(each corpus bucket and each kind of query launch, with its launch
plan, summed over the phase's launches), so is `simgnn_head` (each
distinct batch size of the phase, with its launch plan: the tiled route
for SimGNN-AIDS, the warp route for the narrow F = 4 held in phase 3b),
`topm` (the dot scan) each distinct (Q, N, M, block_cols) launch of the
search phase with its plan (the select route at the served shape, the
sort route at M = N), its profiler and CUDA-graph times and its bound,
summed launch by launch, `topm_ntn` (the NTN scan) at the served shape
with its plan (the select route), its CUDA-graph time and a yardstick of
the plain composition (einsum, the FCN's matmuls, `torch.topk`: not one
call, so no `library_ms`), and `wkv6` at the decode shape
(T 1) from events around a CUDA graph of back-to-back launches, with each
`wkv6` call's plan printed, and `mamba_scan` at the Jamba block's decode
step (T 1) the same way; each `sparse_pair`, `packed_pair` and
`fused_pair` call of phase 3 prints its launch plan (one tile per 2-CTA
cluster, or for `packed_pair` the single route where the head's weights
fit no cluster layout; one pair per cluster of 2, 4 or 8 CTAs),
`packed_pair` is timed at the AIDS and the average-degree-8 request and
launch by launch over the dense stream, `fused_pair` is timed at bucket
64, at one
pair and at the oversize bucket 256, each with its bound, and each of the
forced bucketed request's `fused_pair` launches is timed alone and summed
launch by launch; phase 5 also serves auto requests of 1, 2 and 3 pairs
(the bucketed path, "too small" to pack; wall time and device span) and a
256-pair auto request with one 130-node pair (`packed_sparse` for the
rest, one `fused_pair` launch at bucket 256); the kernels line records
(`bit_identical`) whether `tools/sparse_pair_parent_check.py`,
`tools/packed_pair_parent_check.py`, `tools/fused_pair_parent_check.py`,
`tools/mamba_scan_parent_check.py`, `tools/simgnn_head_parent_check.py`
and `tools/topm_parent_check.py` (both scans), where they ran before in
the same checkout, found every case equal to the parent kernel's, and
`simgnn_head`'s, `topm`'s and `topm_ntn`'s entries their plan's route
(`plan_route`);
bounds come
from this run's inputs against the
H100 SXM peaks of 67 TFLOP/s float32 (989 TFLOP/s bf16 for the bf16
expert FFN and the bf16 attention) and 3.35 TB/s. The build phase fails
if `wkv6`, `fused_gcn`, `sparse_pair`, `fused_pair`, `mamba_scan`,
`simgnn_head`, `packed_pair`'s cluster route or the select route of
either top-M scan spills registers.
Each phase prints its seconds.
Details go to `chiprun_out/chip_smoke.json`. Needs a CUDA device; exits 2
without one.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PEAK_F32_FLOPS = 67e12       # H100 SXM float32, outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # H100 SXM bf16 tensor cores, dense
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
BATCH = 256
N_PAIRS = 2048
#: kernel-vs-plain tolerance on post-sigmoid scores, by kernel: the
#: parity bounds of tests/test_parity_matrix.py (f32).
ATOL = {"sparse_pair": 1e-6, "packed_pair": 1e-6, "fused_pair": 2e-5,
        "simgnn_head": 1e-6}
#: embeddings and top-M scores against their plain versions: float32 sums
#: in another order (top-M indices must be equal).
BODY_TOL = dict(rtol=1e-5, atol=1e-6)
REPLACES = {
    "sparse_pair": "src/repro/kernels/sparse_pair.py:94",
    "packed_pair": "src/repro/kernels/packed_pair.py:73",
    "fused_pair": "src/repro/kernels/fused_pair.py:67",
    "fused_gcn": "src/repro/kernels/fused_gcn.py:49",
    "simgnn_head": "src/repro/kernels/simgnn_head.py:37",
    "topm": "src/repro/kernels/retrieval.py:169",
    "topm_ntn": "src/repro/kernels/retrieval.py:197",
    "moe_experts": "src/repro/kernels/moe_experts.py:41",
    "flash_attn": "src/repro/kernels/flash_attn.py:88",
    "wkv6": "src/repro/kernels/wkv6.py:54",
    "mamba_scan": "src/repro/kernels/mamba_scan.py:61",
}
SOURCE = {"topm": "retrieval", "topm_ntn": "retrieval"}
#: profiler names of each kernel's launches where they are not
#: `<name>_kernel`: fused_pair's and packed_pair's cluster route and their
#: single route, simgnn_head's tiled route and its warp route, each top-M
#: scan's select route and its sort route's two passes
SYMBOLS = {"fused_pair": ("fused_pair_cluster_kernel", "fused_pair_kernel"),
           "packed_pair": ("packed_pair_cluster_kernel", "packed_pair_kernel"),
           "simgnn_head": ("simgnn_head_tiled_kernel", "simgnn_head_kernel"),
           "topm": ("topm_select_kernel", "topm_dot_block_kernel",
                    "topm_merge_kernel"),
           "topm_ntn": ("topm_ntn_select_kernel", "topm_ntn_block_kernel",
                        "topm_merge_kernel")}
#: the similarity-search phase: corpus rows, two-stage queries (one
#: prefilter call), exact queries, shortlist and result depth, and the
#: prefilter's column block (the default shard size, 256 rows).
SEARCH_CORPUS = 8192
SEARCH_QUERIES = 64
EXACT_QUERIES = 8
PREFILTER_M = 64
TOPK = 10
BLOCK_COLS = 256
#: the LM serving phase: the model, prompts of LM_PROMPT tokens for
#: LM_BATCH sequences, LM_NEW greedy tokens, and the parity matrix's bf16
#: band (tests/test_parity_matrix.py) for logits against the plain run.
#: The band is widened to twice the run's own floor when that is wider:
#: the floor is how far the plain run's logits lie from a run whose expert
#: FFN is computed in float64, i.e. what float32 sums in one valid order
#: do to bf16 logits through 32 layers (routing near-ties included); two
#: runs each within the floor of the float64 run are within twice it of
#: each other.
LM_ARCH = "granite-moe-3b-a800m"
LM_BATCH = 4
LM_PROMPT = 512
LM_NEW = 16
LM_BF16_BOUND = 2e-2
LM_F32_ATOL = 1e-4
#: phases 12-17: the recurrent and long-prompt paths. Kernel-vs-plain
#: bounds are the JAX kernel sweeps' (tests/test_kernels.py): the scans
#: rtol 1e-4 / atol 1e-5, flash attention rtol 2e-4 / atol 2e-5; outputs
#: rounded to bf16 get one bf16 ulp more.
RWKV_ARCH = "rwkv6-7b"
JAMBA_ARCH = "jamba-1.5-large-398b"
LONG_PROMPT = 4096
MAMBA_BATCH, MAMBA_PROMPT, MAMBA_STEPS = 2, 2048, 16
HYBRID_PROMPT, HYBRID_NEW = 2048, 8
#: phase 12's shapes: attention (B, T, S, H, KV, D) at granite's long
#: prompt, gemma2-9b's 8192 tokens (softcap 50, window 4096) and a ragged
#: GQA shape; wkv6 (B, T, H, K, V) at rwkv6-7b's serving shape; the scan
#: (B, T, Din, N) at Jamba's Mamba block.
FLASH_GRANITE = (1, LONG_PROMPT, LONG_PROMPT, 24, 8, 64)
FLASH_GEMMA, GEMMA_WINDOW = (1, 8192, 8192, 16, 8, 256), 4096
FLASH_RAGGED = (2, 333, 517, 12, 3, 80)
WKV_SERVED = (LM_BATCH, LM_PROMPT, 64, 64, 64)
MAMBA_SERVED = (MAMBA_BATCH, MAMBA_PROMPT, 16384, 16)
SCAN_TOL = dict(rtol=1e-4, atol=1e-5)
FLASH_TOL = dict(rtol=2e-4, atol=2e-5)
#: the kernels behind each of the two tensor-core wrappers, as the
#: profiler names them: bf16 calls launch the wgmma kernels (an expert FFN
#: call two of them, whose times are summed per call), float32 calls the
#: FMA bodies.
MOE_KERNELS = ("moe_up_wgmma_kernel", "moe_down_wgmma_kernel",
               "moe_expert_ffn_kernel")
FLASH_KERNELS = ("flash_attn_wgmma_kernel", "flash_attn_kernel")
#: phase 18: the measured planner's candidates, workloads (`search_pairs`
#: at each size and degree; None is the AIDS degree), recorded calls per
#: (workload, path) and the "near-best" margin of the printed pick share.
PLANNER_CANDIDATES = ("bucketed_mega", "packed_dense", "packed_sparse")
PLANNER_SIZES = (1, 4, 16, 64, 256)
PLANNER_DEGREES = (None, 6.0, 8.0)
PLANNER_REPS = 3
PLANNER_MARGIN = 1.10
#: phase 19: SimGNN training, `pair_stream(TRAIN_SEED, TRAIN_BATCH)`;
#: gradient leaves within GRAD_ATOL_F32 of the CPU (tests/test_grad.py),
#: params after TRAIN_STEPS steps within TRAIN_PARAM_BOUND of the CPU's.
TRAIN_SEED = 41
TRAIN_BATCH = 128
TRAIN_STEPS = 20
GRAD_ATOL_F32 = 1e-5
TRAIN_PARAM_BOUND = 1e-4
#: phase 20: the launcher's run (SimGNN-AIDS, its default 128-pair
#: batches), a checkpoint every LAUNCH_CKPT_EVERY steps, killed once step
#: LAUNCH_FAIL_AT has run.
LAUNCH_STEPS = 12
LAUNCH_CKPT_EVERY = 4
LAUNCH_FAIL_AT = 6
#: phase 21: seamless-m4t-large-v2 at full width and depth in bf16, served
#: at the speech-translation shape (ENCDEC_BATCH x ENCDEC_FRAMES frames, a
#: decoder prompt of ENCDEC_FRAMES / dec_seq_divisor = 128 tokens,
#: ENCDEC_NEW tokens) and with a 1 x ENCDEC_LONG_PROMPT-token decoder
#: prompt (one `flash_attn` launch per decoder layer), the logits' bound
#: against the full forward (a share of their largest magnitude, the
#: parity matrix's bf16 band) and the reduced float32 model's against the
#: CPU; ENCDEC_TRAIN_STEPS train steps of `batch_for_step(global_batch=
#: ENCDEC_TRAIN_BATCH, seq_len=ENCDEC_FRAMES)`; gradients through each LM
#: kernel (GRAD_CASES: arch, config changes, batch, tokens, the kernels it
#: runs and the kernels' bound from tests/test_torch_cuda.py); three train
#: steps on the card against the CPU for STEP_ARCHS (params within
#: STEP_PARAM_BOUND); the LM launcher killed after step LM_LAUNCH_FAIL_AT
#: of LM_LAUNCH_STEPS and resumed.
SEAMLESS_ARCH = "seamless-m4t-large-v2"
ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_NEW = 4, 1024, 16
ENCDEC_LONG_PROMPT = 2048
ENCDEC_TRAIN_STEPS, ENCDEC_TRAIN_BATCH = 5, 2
ENCDEC_BF16_SHARE = 2e-2
ENCDEC_F32_ATOL = 1e-6
GRAD_CASES = (("granite-moe-3b-a800m", {"moe_use_kernel": True}, 1, 2048,
               ("flash_attn", "moe_experts"), FLASH_TOL),
              ("rwkv6-7b", {}, 2, 64, ("wkv6",), SCAN_TOL),
              (JAMBA_ARCH, {}, 2, 64, ("mamba_scan",), SCAN_TOL))
STEP_ARCHS = ("qwen1.5-4b", "internvl2-2b", SEAMLESS_ARCH)
STEP_PARAM_BOUND = 1e-5
LM_LAUNCH_ARCH = "qwen1.5-4b"
LM_LAUNCH_STEPS, LM_LAUNCH_EVERY, LM_LAUNCH_FAIL_AT = 6, 2, 4
#: phase 22: device-sharded SimGNN-AIDS serving over SHARD_COUNTS devices
#: (logical devices over cuda:0 where the machine has fewer cards), the
#: AIDS and average-degree-8 streams in requests of BATCH pairs, and the
#: span-split search server over the phase-6 corpus and queries.
SHARD_COUNTS = (2, 4)
#: phase 23: device-sharded SimGNN-AIDS training over SHARD_COUNTS devices
#: on phase 19's batches (TRAIN_SEED, TRAIN_BATCH, TRAIN_STEPS): loss and
#: every gradient leaf within SHARD_GRAD_ATOL of the unsharded card call
#: (tests/test_sharded.py's gate), params after TRAIN_STEPS steps within
#: TRAIN_PARAM_BOUND of the unsharded run; the launcher at
#: SHARD_LAUNCH_DEVICES devices (phase 20's steps, checkpoints and kill)
#: resumed at that count (bit-equal) and at SHARD_RESUME_DEVICES (within
#: TRAIN_PARAM_BOUND).
SHARD_GRAD_ATOL = 1e-6
SHARD_LAUNCH_DEVICES, SHARD_RESUME_DEVICES = 2, 4
#: phase 24: the LM mesh. (a) seamless at full width and depth (bf16) on
#: MESH_SHAPES meshes of logical devices over cuda:0, MESH_STEPS steps of
#: phase 21 (b)'s batches, beside the unsharded step: losses within
#: MESH_LOSS_RTOL relative, (1, 1) bit-equal (losses, final params and
#: first moments), and every mesh's grad norms, final params and first
#: moments within MESH_LIMITS of the unsharded run's ((1, 4) and (2, 2)
#: train on model rows of 4 and 2 members, (2, 1) data-parallel); a
#: dropped-replica control (the unsharded step on the first replica's
#: rows alone) must exceed each of MESH_LIMITS. (b) MESH_CASES
#: (arch, config changes, batch, tokens, the kernels its forward
#: launches), reduced float32 on (2, 2), MESH_CASE_STEPS steps against the
#: same on logical CPU devices: params and moments within
#: STEP_PARAM_BOUND.
#: (c) the launcher at `--mesh 2x2` (phase 21's LM launcher run) killed
#: and resumed, its last checkpoint restored onto MESH_RESTORE_SHAPES and
#: resharded live onto (1, 4). (d) the launcher at `--mesh single` for
#: MESH_SINGLE_STEPS steps of MESH_SINGLE_BATCH sequences and the
#: elastic_restart example.
MESH_SHAPES = ((2, 2), (1, 4), (2, 1), (1, 1))
MESH_STEPS = 3
MESH_CASE_STEPS = 2
MESH_LOSS_RTOL = 2e-2
#: distances to the unsharded run (`_mesh_distances`): grad norms (largest
#: relative error over the steps), final params (L2 distance over the
#: unsharded run's L2 update from init) and first moments (relative L2).
#: Each limit is about the geometric mean of two readings on an H100
#: (PERF.md §6): the sound meshes' largest, 1.6e-4 / 0.12 / 1.3e-2, and
#: the dropped-replica control's, 0.41 / 0.87 / 0.59. The loss cannot
#: tell them apart (7.8e-5 and 1.0e-2, both under MESH_LOSS_RTOL).
MESH_LIMITS = {"grad_norm": 8e-3, "params": 0.33, "moment": 8.6e-2}
MESH_CASES = (("granite-moe-3b-a800m", {"moe_use_kernel": True}, 2, 2048,
               ("moe_experts", "flash_attn")),
              ("rwkv6-7b", {}, 4, 64, ("wkv6",)),
              (JAMBA_ARCH, {}, 4, 64, ("mamba_scan",)))
MESH_RESTORE_SHAPES = ((4, 1), (1, 1), None)
MESH_SINGLE_STEPS, MESH_SINGLE_BATCH = 3, 16
#: phase 25: GPipe (`distributed/pipeline.py`). (a) granite (LM_ARCH) at
#: full width and depth in bf16 with `moe_use_kernel`: its layer groups in
#: PIPE_STAGES stages on a ("stage",) mesh (the first PIPE_STAGES cards,
#: or logical devices over cuda:0), stage params stored as blocks laid out
#: by P("stage"); PIPE_BATCH x PIPE_TOKENS tokens of `batch_for_step`
#: (seed 17) embedded outside the pipeline, PIPE_MICRO microbatches, each
#: stage running its groups with remat; the loss `next_token_nll` of
#: `logits_from_hidden` on the caller's device. Gates: y and every
#: gradient bit-equal to the stages applied microbatch by microbatch on
#: one stream; the stage params' and x's gradients within PIPE_LIMITS
#: (relative L2) of that run, and the dropped-microbatch control (the last
#: microbatch left out of the loss) beyond each limit; the last layer's
#: `moe_experts` (bf16 wgmma) and `flash_attn` arguments from the
#: pipelined run held kernel against plain (`_pipe_held`). (b) LM_ARCH
#: reduced to PIPE_STAGES layer groups in float32, y and every gradient
#: leaf within PIPE_F32_BOUND (of the CPU tensor's largest |value|) of the
#: same call on logical CPU devices.
PIPE_STAGES, PIPE_BATCH, PIPE_TOKENS, PIPE_MICRO = 4, 4, 2048, 4
#: relative L2 distances to the stages in order (`_pipe_distances`). The
#: first readings on an H100 (PERF.md §6, GPipe) were 0.0 for both (the
#: gradients bit-equal) and 0.185 (params) / 0.590 (x) for the control;
#: each limit is the geometric mean of the control's reading and bf16's
#: unit roundoff 2**-9, the scale of a bf16 sum taken in another order.
PIPE_LIMITS = {"params": 1.9e-2, "x": 3.4e-2}
#: device activity names printed with the most summed time
PIPE_TOP = 6
PIPE_F32_BOUND = 1e-6
#: phase 26: tensor-parallel serving (`distributed/tensor_parallel.py`)
#: over logical devices of cuda:0 (the first cards where the machine has
#: them): granite (LM_ARCH) on TP_MESHES, rwkv6-7b and Jamba's layer 0 on
#: TP_CONTROL_MESH, beside unsharded serving. TP_LIMITS: each family's
#: relative-L2 limit on the bf16 logits (Jamba's block: on its update, y -
#: x) against unsharded, the geometric mean of a control's reading (the
#: same run on TP_CONTROL_MESH with one member's partial left out of the
#: last layer's row sums) and the floor's (unsharded serving with the
#: plain versions in place of the kernels, as far from the kernels' run as
#: two valid bf16 orders of the same sums get): granite 9.002e-2 and
#: 1.215e-2, rwkv6-7b 1.095e-1 and 3.990e-2, the block 5.700e-1 and
#: 2.904e-3 on an H100 at 700 W. bf16's 2^-9 is below that floor at full
#: depth, so it cannot stand for the sound reading. TP_F32_CHECKS: the
#: same comparison in float32, (layers, limit) at full width, prefill and
#: TP_F32_STEPS decode steps (the block: TP_F32_LIMIT at full width). At
#: 4 layers granite, rwkv6-7b and the block read 8.2e-7, 8.2e-6 and
#: 2.7e-6 against controls of 0.29, 0.29 and 0.54, so TP_F32_LIMIT holds
#: them near float32 rounding (granite stops there: at full depth a
#: float32 difference may flip a near-tied expert choice of its router).
#: rwkv6-7b also runs all its 32 layers, where depth carries float32
#: rounding up to a floor of 3.156e-3 (unsharded with the plain wkv6);
#: that limit is the geometric mean of the floor and the control's
#: 9.343e-2, as TP_LIMITS are, 5x from each (its bf16 gate: 1.25x).
TP_MESHES = ((1, 4), (2, 2), (1, 1))
TP_CONTROL_MESH = (1, 4)
TP_LIMITS = {"granite": 3.3e-2, "rwkv": 6.6e-2, "jamba": 4.1e-2,
             "seamless": 5.8e-2}
TP_F32_STEPS, TP_F32_LIMIT = 3, 1e-4
TP_F32_CHECKS = {"granite": ((4, TP_F32_LIMIT),),
                 "rwkv": ((4, TP_F32_LIMIT), (32, 1.7e-2))}
#: 26 (e): seamless-m4t-large-v2 (SEAMLESS_ARCH) uncut in bf16 on
#: TP_MESHES at phase 21's shape (ENCDEC_BATCH x ENCDEC_FRAMES frames, a
#: 128-token decoder prompt, ENCDEC_NEW tokens) beside unsharded serving,
#: and 1 x ENCDEC_FRAMES frames with an ENCDEC_LONG_PROMPT-token prompt on
#: TP_CONTROL_MESH (`flash_attn` in every member's decoder layers). No
#: kernel runs at the 128-token prompt, so TP_LIMITS["seamless"]'s floor
#: is the unsharded bf16 logits' relative L2 to an unsharded float32 run
#: of the same params; the control leaves the last member's partial out
#: of the last encoder layer's and the last decoder layer's row sums.
#: On an H100 at 700 W the floor read 3.056e-2 and the control 1.108e-1
#: (their geometric mean 5.819e-2), the meshes 2.465e-2-2.507e-2 and the
#: long prompt on TP_CONTROL_MESH 3.477e-2. TP_ED_F32_LAYERS encoder and
#: as many decoder layers in float32 at full width on TP_ED_F32_MESHES:
#: TP_F32_LIMIT (1.608e-6 and 1.619e-6, the control 0.3019).
TP_ED_F32_LAYERS = 4
TP_ED_F32_MESHES = (TP_CONTROL_MESH, (2, 2))
#: phase 27: tensor-parallel training (`lm.lm_loss` with a runtime and the
#: mesh `build_train_step` over `model`) over logical devices of cuda:0
#: (the first cards where the machine has them). (a) granite (LM_ARCH)
#: uncut in bf16 with `moe_use_kernel`: the mesh train step's
#: value-and-grad (`train.step._mesh_value_and_grad`: the batch split over
#: the replicas, each replica's `lm_loss` with remat on its model row) on
#: TPT_MESHES at (replicas) x TPT_TOKENS tokens (seed 29), each
#: beside the unsharded value_and_grad of the same batch: (1, 1) bit-equal
#: in the loss and every gradient; on the other meshes the loss's relative
#: error and the whole gradient tree's relative L2 within TPT_LIMITS; a
#: control on TPT_CONTROL_MESH (the last member's partial left out of the
#: last layer's row sums, in the forward and in its remat recompute)
#: beyond each limit, and the floor (unsharded with the plain versions in
#: place of the kernels) printed beside them; the last layer's
#: `moe_experts` and `flash_attn` calls of member 0 on TPT_CONTROL_MESH
#: held against their plain versions (`_pipe_held`). Each mesh's wall,
#: peak memory, idle share (busy the union over streams, device rows
#: only), its TPT_TOP kernels by device time and the device ms of
#: TPT_CLASSES are printed. (b) TPT_F32 (tag, arch, layers, batch,
#: tokens): one float32 `build_train_step` step at full width on (2, 2)
#: against the data-parallel (2, 1) and on (1, 4) against unsharded: the
#: loss, the grad norm and the update (new params - old) within
#: TPT_F32_LIMITS relative (L2 for the update), the control on (1, 4)
#: beyond them, the floor printed beside them; rwkv6-7b's value_and_grad
#: also in float64 (`_tpt_f64`, TPT_F32_LIMIT); rwkv6-7b and Jamba's
#: layer 0 at 256 tokens (the plain scan
#: backwards the kernels train with grow with T: ROADMAP Queue 2 B.6),
#: granite at 2048 (flash attention runs from CHUNK_THRESHOLD 2048 on);
#: Jamba's layer 0 is its Mamba block (d_inner 16384) with the dense
#: FFN at its 65536-id vocabulary (the whole float32 params and the
#: reference's update wait on the host, so that the card holds the mesh
#: step's copies). `wkv6` (H 16) and `mamba_scan` (Din 4096) are held
#: at the captured shard shapes against their plain versions. (d)
#: seamless-m4t-large-v2 (SEAMLESS_ARCH) uncut in bf16 as (a), each
#: replica's `encdec_loss` on its model row (the encoder's layers, then
#: the decoder's reading the members' enc_out), at (replicas) x
#: ENCDEC_FRAMES frames (`batch_for_step`, seed 37) and a TPT_TOKENS-token
#: decoder sequence drawn as its tokens are (`_tpt_ed_batch`), so that
#: `flash_attn` runs in every member's decoder layers: (1, 1) bit-equal,
#: TPT_LIMITS["seamless"], the control leaving the last member's partial
#: out of the last encoder layer's and the last decoder layer's row sums,
#: member 0's last decoder `flash_attn` call on TPT_CONTROL_MESH held
#: against its plain version and timed beside SDPA; TP_ED_F32_LAYERS
#: encoder and as many decoder layers in float32 at full width (2 x
#: ENCDEC_FRAMES frames, TPT_TOKENS tokens), one `build_train_step` step
#: on (1, 4) against unsharded and on (2, 2) against (2, 1) within
#: TPT_F32_LIMIT, the control beyond it.
TPT_MESHES = ((1, 4), (2, 2), (1, 1))
TPT_CONTROL_MESH = (1, 4)
TPT_TOKENS = 2048
#: the loss's relative error and the gradient tree's relative L2 of (a)
#: granite and (d) seamless: each the geometric mean of the control's
#: reading and the floor's on an H100 at 700 W (PERF.md §6), as phase 26
#: sets TP_LIMITS: granite's loss 1.423e-3 and 3.721e-5, grads 7.724e-2
#: and 3.850e-3; seamless's loss 1.675e-3 and 7.437e-6, grads 1.123e-1
#: and 4.071e-3
TPT_LIMITS = {"granite": {"loss": 2.3e-4, "grads": 1.7e-2},
              "seamless": {"loss": 1.1e-4, "grads": 2.1e-2}}
TPT_TOP = 6
#: kernel names of (c)'s question: which grows under a model row, the
#: redundant routing and dispatch or the gather backward
TPT_CLASSES = {
    "routing and dispatch": r"RadixSort|radix|[Ss]ort|scan_innermost|"
                            r"scan_outer|_scatter_gather_elementwise|"
                            r"index_elementwise",
    "gather backward": r"indexing_backward|index_put|embedding_backward|"
                       r"scatter_add"}
TPT_F32 = (("granite", LM_ARCH, 4, 2, 2048), ("rwkv", RWKV_ARCH, 4, 2, 256),
           ("jamba", JAMBA_ARCH, 1, 2, 256))
TPT_F32_LIMIT = 1e-4
#: each family's limits on the (loss, grad norm, update) relative
#: distances: TPT_F32_LIMIT where it parts the floor (two valid float32
#: runs: the unsharded step with the plain versions against the kernels')
#: from the control; elsewhere the geometric mean of the largest sound
#: tensor-parallel reading ((1, 4) or (2, 2)) and the control's on an
#: H100 at 700 W (PERF.md §6), the same room on both sides: rwkv6-7b's
#: grad norm ((1, 4) 1.896e-3, control 1.203e-1: 8x each side) and update
#: (7.051e-3, 6.231e-1: 9x), whose float32 gradients at random init are
#: ill-conditioned (the unsharded float32 gradient tree is 1.55e-3 from
#: float64; `_tpt_f64` holds its float64 gradients to TPT_F32_LIMIT), and
#: Jamba's update ((1, 4) 1.533e-4, control 1.083: 84x): the first AdamW
#: step divides by |g| + eps, which magnifies the rounding of gradients
#: near eps. (d)'s float32 seamless steps are held to TPT_F32_LIMIT.
TPT_F32_LIMITS = {
    "granite": dict.fromkeys(("loss", "grad_norm", "update"), TPT_F32_LIMIT),
    "rwkv": {"loss": TPT_F32_LIMIT, "grad_norm": 1.5e-2, "update": 6.6e-2},
    "jamba": {"loss": TPT_F32_LIMIT, "grad_norm": TPT_F32_LIMIT,
              "update": 1.3e-2}}
#: the tokens of `_tpt_f64`'s float64 run (the plain scan's loops grow
#: with T; float64 holds the arithmetic at any T: 2.950e-6 at 256 tokens
#: in `tools/tp_train_conditioning.py`, 4.732e-6 at 64 here)
TPT_F64_TOKENS = 64
#: phase 28: the dry run against the card. The dry run's prediction of
#: 27 (d)'s value-and-grad peak (the most bytes live at once over the
#: mesh: logical devices share the card, which measures the sum) must lie
#: within this band of the card's peak less the bytes resident before.
DRYRUN_RATIO = (0.8, 1.25)
#: 24 (a)'s and 27 (d)'s meshes that phase 28 dry-runs
DRYRUN_TRAIN_MESHES = ((2, 2), (1, 4))
DRYRUN_VG_MESHES = ((1, 4), (1, 1))
#: the CLI's run at full size on the (16, 16) production mesh: granite's
#: 24 heads (and 8 KV heads) do not split over 16 members of a model row,
#: so the port cannot lay its serving cells out there: the CLI records
#: the error and exits 1, as it must for such a cell (nothing is padded)
DRYRUN_CLI = ("--arch", LM_ARCH, "--shape", "decode_32k", "--mesh",
              "single")
DRYRUN_CLI_ERROR = "n_heads=24 does not split evenly over 16 members"
#: the backward rules' `torch.autograd.Function`s whose forward inputs a
#: card training step captures (both edge-list rules share one class, as
#: both packed-CSR rules do)
RULE_CLASSES = {"label_gather": "_LabelGather",
                "csr_aggregate_block_sym": "_CsrAggregate",
                "segment_att_pool_block": "_SegmentAttPool"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.simgnn_aids import CONFIG as CFG
    from repro_torch.core import batching
    from repro_torch.core.simgnn import SimGNNConfig, init_simgnn_params
    from repro_torch.data.graphs import (edit_graph, query_pairs,
                                         random_graph, search_pairs,
                                         zipf_corpus, zipf_query_stream)
    from repro_torch.kernels import build, ops, retrieval
    from repro_torch.kernels.fused_gcn import fused_gcn_att
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.fused_pair import (fused_pair_score,
                                                fused_pair_score_plain)
    from repro_torch.kernels.mamba_scan import mamba_selective_scan_state
    from repro_torch.kernels.moe_experts import moe_expert_ffn
    from repro_torch.kernels.packed_pair import (packed_pair_score,
                                                 packed_pair_score_plain)
    from repro_torch.kernels.simgnn_head import simgnn_head
    from repro_torch.kernels.sparse_pair import (sparse_pair_score,
                                                 sparse_pair_score_plain)
    from repro_torch.kernels.wkv6 import wkv6_state
    from repro_torch.serve.batching import simgnn_query_server

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    report: dict = {"card": smi, "torch": torch.__version__,
                    "cuda": torch.version.cuda}

    # ---- phase 2: build ------------------------------------------------
    phase = PhaseClock()
    t0 = time.perf_counter()
    out_dir = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f}s wall, nvcc "
          f"{build.last_build_seconds:.1f}s, into {out_dir}")
    spills = {}
    for name in build.SOURCES:
        log = (out_dir / f"{name}.log").read_text()
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        spills[name] = sum(int(ln.split("bytes spill stores")[0].split(
            ",")[-1]) for ln in log.splitlines() if "spill stores" in ln)
        print(f"ptxas {name}: {' | '.join(regs)}; spill stores "
              f"{spills[name]} bytes in all")
    report["ptxas_spill_store_bytes"] = spills
    for name in ("wkv6", "fused_gcn", "sparse_pair", "fused_pair",
                 "mamba_scan", "simgnn_head"):
        assert spills[name] == 0, f"{name} spills registers"
    # packed_pair: the cluster route; the single route is the replaced
    # kernel, unchanged (it stored 36 bytes to the stack before)
    packed_log = (out_dir / "packed_pair.log").read_text()
    report["packed_pair_registers"] = _registers(
        packed_log, r"(packed_pair_cluster_kernel|packed_pair_kernel)",
        lambda m: "cluster" if "cluster" in m.group(1) else "single")
    packed_spills = _entry_spills(packed_log)
    print("packed_pair registers by route: " + ", ".join(
        f"{k} {v}" for k, v in report["packed_pair_registers"].items())
        + "; spill stores by kernel: " + ", ".join(
            f"{k} {v} bytes" for k, v in packed_spills.items()))
    assert packed_spills["packed_pair_cluster_kernel"] == 0, \
        "packed_pair spills registers"
    report["fused_gcn_registers"] = _gcn_registers(
        (out_dir / "fused_gcn.log").read_text())
    print("fused_gcn registers by route: " + ", ".join(
        f"{k} {v}" for k, v in report["fused_gcn_registers"].items())
        + f"; spill stores {spills['fused_gcn']} bytes")
    report["wkv6_registers"] = _wkv_registers(
        (out_dir / "wkv6.log").read_text())
    print("wkv6 registers by instantiation (type, KMAX, VB): " + ", ".join(
        f"{k} {v}" for k, v in report["wkv6_registers"].items()))
    report["mamba_scan_registers"] = _mamba_registers(
        (out_dir / "mamba_scan.log").read_text())
    print("mamba_scan registers by instantiation (type, NMAX, exact N): "
          + ", ".join(f"{k} {v}"
                      for k, v in report["mamba_scan_registers"].items()))
    retrieval_log = (out_dir / "retrieval.log").read_text()
    report["topm_select_registers"] = _registers(
        retrieval_log, SELECT_KERNELS, _select_key)
    select_spills = _select_spills(retrieval_log)
    print("top-M select route registers (scan, keys a lane, width or "
          "head): " + ", ".join(
              f"{k} {v}" for k, v in report["topm_select_registers"].items())
          + "; spill stores: " + ", ".join(
              f"{k} {v} bytes" for k, v in select_spills.items()))
    assert len(select_spills) == 16 and not any(select_spills.values()), \
        "a top-M select route spills registers"
    report["simgnn_head_registers"] = _head_registers(
        (out_dir / "simgnn_head.log").read_text())
    print("simgnn_head registers by route (tiled: pairs a thread): "
          + ", ".join(f"{k} {v}"
                      for k, v in report["simgnn_head_registers"].items())
          + f"; spill stores {spills['simgnn_head']} bytes")
    phase("2 build")

    gen = torch.Generator().manual_seed(0)
    params = init_simgnn_params(gen, CFG, device=dev)
    narrow_cfg = SimGNNConfig(gcn_dims=(16, 8, 8, 4))
    narrow = init_simgnn_params(torch.Generator().manual_seed(1), narrow_cfg,
                                device=dev)
    # NTN K 40: a head whose weights fit no cluster layout at NB 64
    wide_head = init_simgnn_params(torch.Generator().manual_seed(3),
                                   SimGNNConfig(ntn_k=40), device=dev)

    def wargs(p):
        return p["gcn"], p["att"]["w"], p["ntn"], p["fcn"]

    # ---- phase 3: every kernel against its plain version ---------------
    pairs = query_pairs(1, BATCH)
    nb = ops.packed_node_budget(CFG.max_nodes)
    slots = max(8, nb // 4)
    deg = float(np.mean([g["avg_degree"] for pr in pairs for g in pr]))

    def packed_arrays(edge_budget, overflow_budget=8):
        packed, _ = batching.pack_pairs(
            pairs, nb, slots_per_tile=slots, with_edges=True,
            edge_budget=edge_budget, overflow_budget=overflow_budget,
            device=dev)
        e1, e2 = packed.edges.edges1, packed.edges.edges2
        o1, o2 = packed.edges.overflow1, packed.edges.overflow2
        # The arrays the ops wrappers hand the kernels: unpadded [T, ...].
        sparse = [x.contiguous() for x in (
            e1.senders, e1.weights, o1.senders, o1.receivers, o1.weights,
            packed.labels1, packed.mask1, packed.seg1,
            e2.senders, e2.weights, o2.senders, o2.receivers, o2.weights,
            packed.labels2, packed.mask2, packed.seg2, packed.pair_mask)]
        dense = [x.contiguous() for x in (
            packed.adj1, packed.labels1, packed.mask1, packed.seg1,
            packed.adj2, packed.labels2, packed.mask2, packed.seg2,
            packed.pair_mask)]
        return sparse, dense, packed

    sparse_in, dense_in, packed = packed_arrays(
        ops.packed_edge_budget(nb, deg))
    # packed_dense's own traffic: the first request of the average-degree-8
    # stream phase 5 serves; and the AIDS tiles with every adjacency a
    # random 0/1 matrix over all cells (rows cross graph boundaries)
    dense_stream = search_pairs(5, N_PAIRS, avg_degree=8.0)
    dk, _ = batching.pack_pairs(dense_stream[:BATCH], nb, slots_per_tile=slots,
                                device=dev)
    deg8_in = [x.contiguous() for x in (
        dk.adj1, dk.labels1, dk.mask1, dk.seg1, dk.adj2, dk.labels2, dk.mask2,
        dk.seg2, dk.pair_mask)]
    rewired_in = list(dense_in)
    for side in (0, 4):
        cells = torch.rand(dense_in[side].shape, generator=torch.Generator(
            ).manual_seed(side)) < 0.4
        rewired_in[side] = (cells.triu(1) | cells.triu(1).transpose(1, 2)
                            ).to(dev, torch.float32).contiguous()
    spill_in, _, spill_packed = packed_arrays(2 * nb)      # D=2: COO spill
    n_spill = int(spill_packed.edges.overflow1.edge_mask.sum()
                  + spill_packed.edges.overflow2.edge_mask.sum())
    assert n_spill > 0, "overflow case has no COO edges"
    ov_in, _, _ = packed_arrays(2 * nb, overflow_budget=128)
    buckets = batching.bucket_pairs(pairs, CFG.n_node_labels,
                                    allow_oversize=True, device=dev)
    rng = np.random.default_rng(7)
    big = random_graph(rng, 130)
    oversize = batching.bucket_pairs([(big, edit_graph(rng, big, 3))],
                                     CFG.n_node_labels, allow_oversize=True,
                                     device=dev)
    assert list(oversize) == [256], list(oversize)

    def fused_in(b):
        lhs, rhs, _ = b
        return [lhs.adj, lhs.feats, lhs.mask, rhs.adj, rhs.feats, rhs.mask]

    cases = {
        "sparse_pair": [
            ("main", sparse_pair_score, sparse_pair_score_plain, sparse_in,
             params),
            (f"overflow ({n_spill} COO edges)", sparse_pair_score,
             sparse_pair_score_plain, spill_in, params),
            ("narrow gcn (16,8,8,4)", sparse_pair_score,
             sparse_pair_score_plain, sparse_in, narrow),
            (f"E_ov {ov_in[2].shape[-1]}, D 2", sparse_pair_score,
             sparse_pair_score_plain, ov_in, params)],
        "packed_pair": [
            ("main", packed_pair_score, packed_pair_score_plain, dense_in,
             params),
            ("narrow gcn (16,8,8,4)", packed_pair_score,
             packed_pair_score_plain, dense_in, narrow),
            ("average-degree-8 request", packed_pair_score,
             packed_pair_score_plain, deg8_in, params),
            ("random 0/1 adjacency over all cells", packed_pair_score,
             packed_pair_score_plain, rewired_in, params),
            ("T 1", packed_pair_score, packed_pair_score_plain,
             [x[:1].contiguous() for x in dense_in], params),
            ("NTN K 40 (single route)", packed_pair_score,
             packed_pair_score_plain, dense_in, wide_head)],
        "fused_pair": [
            ("bucket 32", fused_pair_score, fused_pair_score_plain,
             fused_in(buckets[32]), params),
            ("bucket 64", fused_pair_score, fused_pair_score_plain,
             fused_in(buckets[64]), params),
            ("one pair at bucket 32", fused_pair_score,
             fused_pair_score_plain,
             [x[:1].contiguous() for x in fused_in(buckets[32])], params),
            ("oversize 130 nodes (bucket 256)", fused_pair_score,
             fused_pair_score_plain, fused_in(oversize[256]), params),
            ("narrow gcn (16,8,8,4)", fused_pair_score,
             fused_pair_score_plain, fused_in(buckets[32]), narrow)],
    }
    kernels = {}
    for name, runs in cases.items():
        worst = 0.0
        for label, kern, plain, arrays, prm in runs:
            got = kern(*arrays, *wargs(prm))
            want = plain(*arrays, *wargs(prm))
            torch.cuda.synchronize()
            assert got.shape == want.shape, (name, label, got.shape)
            assert torch.isfinite(got).all(), (name, label)
            err = float((got - want).abs().max())
            print(f"  {name} [{label}]: shape {tuple(got.shape)} max abs err "
                  f"{err:.3e} (bound {ATOL[name]:g})")
            if kern is sparse_pair_score:
                print(f"  sparse_pair plan [{label}]: "
                      f"{sparse_pair_score.last_plan.summary()}")
            if kern is fused_pair_score:
                print(f"  fused_pair plan [{label}]: "
                      f"{fused_pair_score.last_plan.summary()}")
            if kern is packed_pair_score:
                print(f"  packed_pair plan [{label}]: "
                      f"{packed_pair_score.last_plan.summary()}")
            assert err <= ATOL[name], (name, label, err)
            worst = max(worst, err)
        label, kern, plain, arrays, prm = runs[0] if name != "fused_pair" \
            else runs[1]
        timed = timings(lambda: kern(*arrays, *wargs(prm)),
                        lambda: plain(*arrays, *wargs(prm)),
                        SYMBOLS.get(name, f"{name}_kernel"))
        flops, nbytes = WORK[name](arrays, CFG)
        nbytes += param_bytes(params) + out_bytes(name, arrays)
        kernels[name] = record(name, worst, *timed, label, flops, nbytes)
    kernels["sparse_pair"].update(_sparse_plan_report(sparse_in, params))
    kernels["packed_pair"].update(_packed_plan_report(dense_in, deg8_in,
                                                      params))
    # fused_pair beside its bucket-64 entry: one pair (the latency case)
    # and the oversize 130-node pair, each with its bound and plan
    kernels["fused_pair"]["per_case"] = [
        _fused_launch_time(label, arrays, params)
        for label, _, _, arrays, _ in cases["fused_pair"][1:4]]
    kernels["fused_pair"]["bit_identical"] = _parent_check("fused_pair")

    phase("3 SimGNN kernels against their plain versions")

    # ---- phase 3b: the search kernels against their plain versions -----
    corpus = zipf_corpus(2, SEARCH_CORPUS)
    stream = zipf_query_stream(3, 2, n_corpus=16)
    queries = [next(stream)["query"] for _ in range(SEARCH_QUERIES)]
    kernels.update(search_kernels(params, narrow, corpus, queries, dev))
    phase("3b search kernels against their plain versions")

    # ---- phase 4: serve 2048 pairs through the packed-sparse path -------
    # Every path below is driven with all launch counts set to 0 just
    # before it and read just after; the comparisons above do not count.
    launched = {"sparse_pair": sparse_pair_score,
                "packed_pair": packed_pair_score,
                "fused_pair": fused_pair_score,
                "fused_gcn": fused_gcn_att, "simgnn_head": simgnn_head,
                "topm": retrieval.blocked_topm,
                "topm_ntn": retrieval.blocked_topm_ntn,
                "moe_experts": moe_expert_ffn,
                "flash_attn": flash_attention, "wkv6": wkv6_state,
                "mamba_scan": mamba_selective_scan_state}

    def reset_counts():
        for kern in launched.values():
            kern.launches = 0

    def read_counts():
        return {name: kern.launches for name, kern in launched.items()}

    # Phases 4-7 pin planner="threshold": their servers record traces, and
    # once every candidate had support a measured planner could steer a
    # later request off the path a phase checks (phase 18 drives it).
    stream = query_pairs(1, N_PAIRS)
    score = simgnn_query_server(params, CFG, use_kernels=True,
                                planner="threshold")
    cpu_score = simgnn_query_server(params, CFG, use_kernels=True,
                                    planner="threshold", device="cpu")
    ref_score = simgnn_query_server(params, CFG, path="reference",
                                    planner="threshold")
    timer = RequestTimer(score.engine)
    walls, first = [], None
    reset_counts()
    for i in range(0, N_PAIRS, BATCH):
        batch = stream[i:i + BATCH]
        before = sparse_pair_score.launches
        t0 = time.perf_counter()
        with timer:
            out = score(batch)
        walls.append(time.perf_counter() - t0)
        timer.stages[-1]["wall"] = walls[-1]
        plan = score.last_plan
        assert plan.path == "packed_sparse", plan.path
        assert plan.degraded_from == () and plan.attempts == 1, plan
        assert sparse_pair_score.launches > before
        assert out.shape == (len(batch),) and np.isfinite(out).all()
        if first is None:
            first = (batch, out)
    counts = read_counts()
    print(f"serve launches: {counts}")
    assert counts["sparse_pair"] == N_PAIRS // BATCH, counts
    served = {"sparse_pair": counts["sparse_pair"]}
    plan = sparse_pair_score.last_plan
    assert plan.route == "cluster" and plan.grid == 2 * \
        score.last_pack_stats["n_tiles"], plan
    print(f"serve: sparse_pair plan of the last request: {plan.summary()}")
    requests = N_PAIRS // BATCH
    batch, out = first
    err_ref = float(np.abs(out - ref_score(batch)).max())
    err_cpu = float(np.abs(out - cpu_score(batch)).max())
    print(f"serve: {requests} requests of {BATCH} pairs on "
          f"{score.last_plan.path} (planner=threshold); vs card reference "
          f"{err_ref:.3e}, vs CPU "
          f"plain path {err_cpu:.3e} (bound 1e-06)")
    assert err_ref <= 1e-6 and err_cpu <= 1e-6, (err_ref, err_cpu)
    steady = timer.stages[1:]
    mean = {k: statistics.fmean(s[k] for s in steady) for k in steady[0]}
    print(f"serve: {BATCH / mean['wall']:.1f} pairs/s over requests "
          f"2..{requests}; per request {1e3 * mean['wall']:.3f} ms wall, "
          f"{1e3 * mean['device']:.3f} ms device span of the scoring call "
          f"(idle share {1 - mean['device'] / mean['wall']:.4f}); first "
          f"request {1e3 * walls[0]:.3f} ms")
    other = mean["wall"] - sum(mean[k] for k in RequestTimer.STAGES)
    print("serve host stages per request (ms): " + ", ".join(
        f"{k} {1e3 * mean[k]:.3f}" for k in RequestTimer.STAGES) +
        f", other {1e3 * other:.3f}")
    report["serve"] = {"requests": requests, "batch": BATCH,
                       "per_request_s": timer.stages, "mean_s": mean,
                       "err_ref": err_ref, "err_cpu": err_cpu,
                       "pack_stats": score.last_pack_stats}

    phase("4 pair scoring served")

    # ---- phase 5: forced packed-dense and bucketed paths ----------------
    fused_calls: list = []
    real_fused = ops.fused_pair_score

    def recording_fused(*args):
        fused_calls.append(args)
        return real_fused(*args)

    forced_counts = {}
    for path, name in (("packed_dense", "packed_pair"),
                       ("bucketed_mega", "fused_pair")):
        forced = simgnn_query_server(params, CFG, path=path,
                                     planner="threshold")
        reset_counts()
        ops.fused_pair_score = recording_fused
        try:
            got = forced(batch)
        finally:
            ops.fused_pair_score = real_fused
        counts = read_counts()
        forced_counts[name] = counts[name]
        plan = forced.last_plan
        assert plan.path == path and plan.degraded_from == () \
            and plan.attempts == 1, plan
        assert counts[name] > 0 and sum(counts.values()) == counts[name], \
            (path, counts)
        err = float(np.abs(got - ref_score(batch)).max())
        print(f"forced {path} (planner=threshold): launches {counts}, vs "
              f"card reference {err:.3e} (bound {ATOL[name]:g})")
        assert err <= ATOL[name], (path, err)
    served["fused_pair"] = forced_counts["fused_pair"]
    kernels["packed_pair"]["forced_launches"] = forced_counts["packed_pair"]
    # each of the forced request's fused_pair launches alone, summed
    # launch by launch
    assert len(fused_calls) == served["fused_pair"], len(fused_calls)
    per_launch = [_fused_launch_time(
        f"forced launch {i}", list(args[:6]), params)
        for i, args in enumerate(fused_calls)]
    loss = sum(t["ms"] - t["bound_ms"] for t in per_launch)
    print(f"forced bucketed_mega: {len(per_launch)} fused_pair launches, "
          f"sum of launch ms {sum(t['ms'] for t in per_launch):.4f}, sum of "
          f"(time - bound) {loss:.4f} ms")
    kernels["fused_pair"]["forced_launches"] = per_launch
    kernels["fused_pair"]["forced_loss_ms"] = loss
    # packed_dense's served path: the average-degree-8 stream on auto
    report["dense_stream"], served["packed_pair"] = _dense_stream(
        score, cpu_score, ref_score, dense_stream, reset_counts, read_counts,
        params)
    kernels["packed_pair"]["dense_stream"] = {
        k: report["dense_stream"][k] for k in ("per_launch", "loss_ms")}
    report["small_calls"] = _small_calls(score, stream, ref_score,
                                         reset_counts, read_counts)
    report["oversize_request"] = _oversize_request(
        score, stream, ref_score, reset_counts, read_counts)

    phase("5 forced packed-dense and bucketed paths, the dense stream")

    # ---- phase 6: similarity search served on the card ----------------
    report["search"], counts = search_phase(
        params, corpus, queries, reset_counts, read_counts,
        {(t["graphs"], t["bucket"]): t
         for t in kernels["fused_gcn"]["per_launch"]})
    for name in ("fused_gcn", "simgnn_head", "topm", "topm_ntn"):
        served[name] = counts[name]
    kernels["topm"]["per_launch"] = report["search"]["topm_launches"]
    kernels["topm"]["loss_ms"] = report["search"]["topm_lost_ms"]
    phase("6 similarity search served")

    # ---- phase 7: the engine's embedding-cached and two-kernel paths ---
    for path, bound in (("embedding_cache", 1e-6), ("two_kernel", 2e-5)):
        forced = simgnn_query_server(params, CFG, path=path,
                                     planner="threshold")
        reset_counts()
        got = forced(batch)
        counts = read_counts()
        plan = forced.last_plan
        assert plan.path == path and plan.degraded_from == () \
            and plan.attempts == 1, plan
        assert counts["fused_gcn"] > 0 and counts["simgnn_head"] > 0 and \
            sum(counts.values()) == counts["fused_gcn"] + \
            counts["simgnn_head"], (path, counts)
        assert not forced.engine.counters, forced.engine.counters
        err = float(np.abs(got - ref_score(batch)).max())
        print(f"forced {path} (planner=threshold): launches {counts}, vs "
              f"card reference {err:.3e} (bound {bound:g})")
        assert err <= bound, (path, err)

    phase("7 forced embedding_cache and two_kernel paths")

    # ---- phases 8-11: MoE LM serving on the card ------------------------
    (kernels["moe_experts"], report["lm"], served["moe_experts"], granite,
     granite_cfg) = lm_phases(dev, reset_counts, read_counts)
    phase("8-11 granite-moe-3b-a800m serving")

    # ---- phases 12-17: the recurrent and long-prompt paths -------------
    kernels.update(lm_kernel_checks(dev))
    phase("12 (a) flash_attn, wkv6, mamba_scan against their plain versions")
    report["rwkv"], served["wkv6"] = rwkv_phases(dev, reset_counts,
                                                 read_counts, phase)
    report["long_prompt"], served["flash_attn"] = long_prompt_phase(
        dev, granite, granite_cfg, reset_counts, read_counts)
    del granite
    torch.cuda.empty_cache()
    phase("15 (d) granite prefill of a 4096-token prompt")
    report["mamba"], served["mamba_scan"] = mamba_block_phase(
        dev, reset_counts, read_counts)
    kernels["mamba_scan"]["decode_ms"] = report["mamba"]["scan_decode_ms"]
    phase("16 (e) Jamba's Mamba block at full width")
    report["hybrid"] = hybrid_phase(dev, reset_counts, read_counts)
    phase("17 (f) the reduced Jamba hybrid, card against CPU")

    # ---- phases 18-19: the measured planner and training, SimGNN-AIDS --
    report["planner"] = planner_phase(params, dev, reset_counts, read_counts)
    phase("18 the measured planner on the card")
    report["train"] = train_phase(params, dev, reset_counts, read_counts)
    phase("19 SimGNN training on the card")

    # ---- phase 20: the launcher, checkpoints and the examples ----------
    report["launcher_runs_ahead_s"] = _run_ahead()
    report["launcher"] = launcher_phase(dev, reset_counts, read_counts)
    phase("20 training launcher, checkpoints and examples on the card")

    # ---- phase 21: enc-dec serving and LM training ---------------------
    torch.cuda.empty_cache()
    report["encdec"] = encdec_phase(dev, reset_counts, read_counts)
    phase("21 seamless serving and training, LM training")

    # ---- phase 22: device-sharded SimGNN serving -----------------------
    torch.cuda.empty_cache()
    report["sharded"], counts = sharded_phase(params, corpus, queries,
                                              reset_counts, read_counts)
    for name, n in counts.items():
        served[name] += n
        kernels[name]["sharded_phase_launches"] = n
    phase("22 device-sharded SimGNN serving")

    # ---- phase 23: device-sharded SimGNN training ----------------------
    report["sharded_train"] = sharded_train_phase(params, dev, smi,
                                                  reset_counts, read_counts)
    phase("23 device-sharded SimGNN training")

    # ---- phase 24: the LM mesh and elastic resharding ------------------
    torch.cuda.empty_cache()
    report["lm_mesh"], counts = lm_mesh_phase(dev, smi, reset_counts,
                                              read_counts)
    for name, n in counts.items():
        served[name] += n
        kernels[name]["lm_mesh_phase_launches"] = n
    phase("24 the LM mesh and elastic resharding")

    # ---- phase 25: GPipe pipeline parallelism --------------------------
    torch.cuda.empty_cache()
    report["pipeline"], counts = pipeline_phase(dev, smi, reset_counts,
                                                read_counts)
    for name, n in counts.items():
        served[name] += n
        kernels[name]["pipeline_phase_launches"] = n
    phase("25 GPipe pipeline parallelism")

    # ---- phase 26: tensor-parallel serving ----------------------------
    torch.cuda.empty_cache()
    report["tensor_parallel"], counts = tp_phase(dev, smi, reset_counts,
                                                 read_counts)
    for name, n in counts.items():
        served[name] += n
        kernels[name]["tp_phase_launches"] = n
        kernels[name]["tp_shard_shapes"] = report["tensor_parallel"][
            "held_at_shard_shapes"][name]
    phase("26 tensor-parallel serving")

    # ---- phase 28's dry runs on the meta device, in processes of their
    # own while the card runs phase 27 (device-bound where it starts)
    ahead = _dryrun_ahead()

    # ---- phase 27: tensor-parallel training ---------------------------
    torch.cuda.empty_cache()
    report["tp_train"], counts = tp_train_phase(dev, smi, reset_counts,
                                                read_counts)
    for name, n in counts.items():
        served[name] += n
        kernels[name]["tp_train_phase_launches"] = n
    phase("27 tensor-parallel training")

    # ---- phase 28: the dry run against the card ------------------------
    torch.cuda.empty_cache()
    report["dryrun"] = dryrun_phase(dev, smi, report, ahead)
    phase("28 the dry run against the card")
    report["phase_s"] = phase.seconds

    for name, k in kernels.items():
        k["launches"] = served[name]
        assert k["launches"] > 0, name
        print(f"{name}: {k['launches']} launches on its path; kernel "
              f"{k['ms']:.4f} ms against a bound of "
              f"{k['bound_ms'] * 1e3:.3f} us ({k['bound_by']}), "
              f"{k['bound_ms'] / k['ms']:.2%} of the bound; max abs err "
              f"{k['max_abs_err']:.3e} ({k['err_bound']})")
    line = {"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "plan_route",
        "bit_identical", "tp_phase_launches", "tp_train_phase_launches")
        if key in k}
        for k in kernels.values()]}
    report["kernels"] = list(kernels.values())
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                        default=str))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _shard_runtime(n: int):
    """A tile runtime of `n` devices: the first n cards where the machine
    has them, else n logical devices over cuda:0 (armed here). Returns
    (runtime, "cards" or "logical")."""
    from repro_torch.distributed import sharding

    if torch.cuda.device_count() >= n:
        sharding.disarm_logical_devices()
        return sharding.tile_runtime(n), "cards"
    sharding.force_logical_device_count(n, "cuda:0")
    return sharding.tile_runtime(n), "logical"


def _served_sharded(tag, score, batches, want, n, kern, reset_counts,
                    read_counts) -> dict:
    """One stream's requests on a sharded server: each request planned on
    `n` devices without degradation, its pack stats the plan's, one
    `kern` launch a non-empty shard and no other launch, scores bitwise
    equal to the unsharded server's (`want`); wall ms and device span
    (RequestTimer) per request, and each shard's launch of the last
    request timed alone (kernel ms from the profiler, as phase 3)."""
    from repro_torch.kernels import ops

    name = "sparse_pair" if kern == "sparse_pair_score" else "packed_pair"
    real = getattr(ops, kern)
    calls = []

    def recording(*args):
        calls.append(args)
        return real(*args)

    timer = RequestTimer(score.engine)
    walls, shards = [], []
    reset_counts()
    setattr(ops, kern, recording)
    try:
        for batch, ref in zip(batches, want):
            calls.clear()
            before = read_counts()
            t0 = time.perf_counter()
            with timer:
                out = score(batch)
            walls.append(time.perf_counter() - t0)
            after = read_counts()
            plan, ps = score.last_plan, score.last_pack_stats
            assert plan.devices == n and plan.degraded_from == () \
                and plan.attempts == 1, (tag, plan)
            target, tb = ops.sharded_tile_plan(
                ps["tiles"], score.engine.node_budget, n,
                sparse=name == "sparse_pair")
            spans = ops.shard_spans(ps["tiles"], target, n)
            span = target // n
            assert ps["devices"] == n and ps["tiles_padded"] == target and \
                ps["device_occupancy"] == [
                    (hi - lo) / span for lo, hi in spans], (tag, ps)
            live = [hi - lo for lo, hi in spans if hi > lo]
            delta = {k: after[k] - before[k] for k in after}
            assert delta[name] == len(live) == sum(delta.values()), \
                (tag, delta, spans)
            assert [c[0].shape[0] for c in calls] == live, (tag, live)
            assert out.tobytes() == ref.tobytes(), \
                f"{tag}: sharded scores differ from the unsharded server's"
            shards = live
    finally:
        setattr(ops, kern, real)
    counts = read_counts()
    symbols = SYMBOLS.get(name, f"{name}_kernel")
    shard_ms, sources = [], []
    for c in calls:
        ms = kernel_device_ms(lambda c=c: real(*c), symbols)
        sources.append("profiler" if ms else "events")
        shard_ms.append(ms or time_cuda_batch(lambda c=c: real(*c)))
    del calls
    torch.cuda.synchronize()
    steady = timer.stages[1:]
    wall = statistics.fmean(walls[1:])
    device = statistics.fmean(st["device"] for st in steady)
    print(f"  {tag}: {len(walls)} requests of {BATCH} pairs bitwise equal "
          f"to unsharded; shards of the last request {shards} tiles "
          f"(tile block {tb}, {target} tiles padded); request {1e3 * wall:.3f} "
          f"ms wall, {1e3 * device:.3f} ms device span (requests 2..); each "
          f"shard's {name} launch alone "
          + ", ".join(f"{ms:.4f} ({src})"
                      for ms, src in zip(shard_ms, sources))
          + " ms (events: the profiler saw no device time; CUDA events "
          "around back-to-back wrapper calls)")
    return {"launches": counts, "wall_ms": 1e3 * wall,
            "device_span_ms": 1e3 * device, "walls_ms": [1e3 * x for x in
                                                        walls],
            "shard_tiles": shards, "shard_kernel_ms": shard_ms,
            "shard_kernel_ms_source": sources,
            "tiles_padded": target, "tile_block": tb}


def _unsharded(tag, score, batches) -> tuple[list, dict]:
    """The unsharded server's scores of each request, with its wall ms and
    device span (requests 2..), the phase's one-shard timing."""
    timer = RequestTimer(score.engine)
    outs, walls = [], []
    for batch in batches:
        t0 = time.perf_counter()
        with timer:
            outs.append(score(batch))
        walls.append(time.perf_counter() - t0)
        assert score.last_plan.devices == 1
    wall = statistics.fmean(walls[1:])
    device = statistics.fmean(st["device"] for st in timer.stages[1:])
    print(f"  {tag} unsharded: request {1e3 * wall:.3f} ms wall, "
          f"{1e3 * device:.3f} ms device span (requests 2..)")
    return outs, {"wall_ms": 1e3 * wall, "device_span_ms": 1e3 * device}


def sharded_phase(params, corpus, queries, reset_counts,
                  read_counts) -> tuple[dict, dict]:
    """Phase 22: device-sharded SimGNN-AIDS serving at N in SHARD_COUNTS
    devices (logical devices over cuda:0 on a one-card machine, printed).
    (a) The AIDS stream (`query_pairs(1, 2048)`, `packed_sparse`) and the
    average-degree-8 stream (`search_pairs(5, 2048, avg_degree=8.0)`,
    `packed_dense`) in requests of 256 through `simgnn_query_server(
    use_kernels=True, planner="threshold", runtime=...)`: scores bitwise
    equal to the same server without a runtime, plans on N devices, pack
    stats the plan's, one launch a non-empty shard. (b) A `raise` fault at
    `sharded:packed_sparse` and a `nan` fault at `sharded:packed_dense`
    each serve one request on one device, bitwise equal, with
    `errors:<path>@Nd` and `degraded_from` as in JAX. (c) The span-split
    `SimilaritySearchServer` over the corpus: 64 two-stage top-10 queries
    (`prefilter_m` 64) with each proxy equal to the one-span server's bit
    for bit, N span scans a call (N scan launches), and a dead span
    ("prefilter" fault) degrading to the exact scan. (d) Wall ms and
    device span of a request at 1, 2 and 4 shards and each shard's kernel
    ms, printed; nothing is gated on them. Returns (report, launch counts
    of the served runs)."""
    from repro_torch.configs.simgnn_aids import CONFIG as CFG
    from repro_torch.data.graphs import query_pairs, search_pairs
    from repro_torch.distributed import sharding
    from repro_torch.serve.batching import simgnn_query_server
    from repro_torch.serve.search import SimilaritySearchServer
    from repro_torch.testing import faults

    served: dict = {}

    def add(counts):
        for k, v in counts.items():
            served[k] = served.get(k, 0) + v

    streams = {
        "aids": (query_pairs(1, N_PAIRS), "packed_sparse",
                 "sparse_pair_score"),
        "degree8": (search_pairs(5, N_PAIRS, avg_degree=8.0),
                    "packed_dense", "packed_pair_score")}
    one = simgnn_query_server(params, CFG, use_kernels=True,
                              planner="threshold")
    rep: dict = {"cards": torch.cuda.device_count(), "streams": {},
                 "collapse": {}, "search": {}}
    want = {}
    reset_counts()
    for tag, (pairs, path, _) in streams.items():
        batches = [pairs[i:i + BATCH] for i in range(0, len(pairs), BATCH)]
        want[tag] = (batches, *_unsharded(tag, one, batches))
        assert one.last_plan.path == path, (tag, one.last_plan.reason)
        rep["streams"][tag] = {"1": want[tag][2]}
    add(read_counts())
    for n in SHARD_COUNTS:
        rt, kind = _shard_runtime(n)
        print(f"phase 22: {n} devices: " + (
            f"the first {n} cards" if kind == "cards" else
            f"{n} logical devices over cuda:0, a stream each"))
        rep.setdefault("device_kind", {})[n] = kind
        score = simgnn_query_server(params, CFG, use_kernels=True,
                                    planner="threshold", runtime=rt)
        for tag, (_, path, kern) in streams.items():
            batches, outs, _ = want[tag]
            r = _served_sharded(f"{tag} on {n} devices", score, batches,
                                outs, n, kern, reset_counts, read_counts)
            assert score.last_plan.path == path, score.last_plan.reason
            add(r.pop("launches"))
            rep["streams"][tag][str(n)] = r
        # (b) the collapse rung
        for tag, mode in (("aids", "raise"), ("degree8", "nan")):
            path = streams[tag][1]
            batch, ref = want[tag][0][0], want[tag][1][0]
            errors = score.engine.counters[f"errors:{path}@{n}d"]
            reset_counts()
            with faults.inject(f"sharded:{path}", mode, times=1) as fp:
                out = score(batch)
            add(read_counts())
            plan = score.last_plan
            assert fp.triggered == 1 and out.tobytes() == ref.tobytes(), \
                (tag, mode, "collapsed scores differ")
            assert plan.degraded_from == (f"{path}@{n}d",) and \
                plan.attempts == 2 and plan.devices == n, plan
            assert score.engine.counters[f"errors:{path}@{n}d"] == \
                errors + 1, dict(score.engine.counters)
            assert any(k.startswith(f"{path}@{n}d[")
                       for k in score.engine.health()["breakers"])
            rep["collapse"][f"{tag}/{n}"] = {
                "mode": mode, "degraded_from": list(plan.degraded_from),
                "counters": dict(score.engine.counters)}
            print(f"  collapse rung, {mode} at sharded:{path} on {n} "
                  f"devices: served single-device bitwise equal, "
                  f"degraded_from {plan.degraded_from}, counters "
                  f"{dict(score.engine.counters)}")
        del score
    # (c) the span-split search server
    base = SimilaritySearchServer(params, CFG, cache_size=16384)
    base.index(corpus)
    calib = base._calibration()
    exact = None
    for n in SHARD_COUNTS:
        rt, _ = _shard_runtime(n)
        srv = SimilaritySearchServer(params, CFG, cache_size=16384,
                                     runtime=rt)
        srv.index(corpus)
        assert srv.corpus_emb.tobytes() == base.corpus_emb.tobytes()
        assert srv.health()["prefilter"]["spans"] == n
        # the queries' embeddings cached on both servers: the timed calls
        # below are the two-stage path alone, as phase 6's second call
        srv.engine.embed_graphs(queries)
        base.engine.embed_graphs(queries)
        for proxy in ("linear", "ntn_exact"):
            scan = "topm" if proxy == "linear" else "topm_ntn"
            for s in (base, srv):
                s._calib = dict(calib, proxy=proxy)
            t0 = time.perf_counter()
            ref = base.search(queries, k=TOPK, mode="two_stage",
                              prefilter_m=PREFILTER_M)
            one_wall = time.perf_counter() - t0
            spans0 = srv.engine.counters["prefilter_span_scans"]
            reset_counts()
            t0 = time.perf_counter()
            got = srv.search(queries, k=TOPK, mode="two_stage",
                             prefilter_m=PREFILTER_M)
            wall = time.perf_counter() - t0
            counts = read_counts()
            add(counts)
            for (gi, gs), (wi, ws) in zip(got, ref):
                assert np.array_equal(gi, wi) and gs.tobytes() == \
                    ws.tobytes(), (n, proxy, "span search differs")
            assert srv.engine.counters["prefilter_span_scans"] - spans0 \
                == n and counts[scan] == n, (n, proxy, counts)
            plan = srv.engine.last_plan
            assert plan.devices == n and f"({n} span(s)" in plan.reason, \
                plan.reason
            rep["search"][f"{proxy}/{n}"] = {
                "wall_ms": 1e3 * wall, "one_span_wall_ms": 1e3 * one_wall,
                "launches": counts, "reason": plan.reason}
            print(f"  span search, {proxy} proxy, {n} spans: {SEARCH_QUERIES} "
                  f"two-stage top-{TOPK} queries equal to one span bit for "
                  f"bit, {counts[scan]} {scan} launches, {1e3 * wall:.3f} ms "
                  f"a call (one span {1e3 * one_wall:.3f}); {plan.reason}")
        if exact is None:
            exact = base.search(queries, k=TOPK, mode="exact")
        reset_counts()
        with faults.inject("prefilter", "raise", times=1) as fp:
            got = srv.search(queries, k=TOPK, mode="two_stage",
                             prefilter_m=PREFILTER_M)
        add(read_counts())
        assert fp.triggered == 1 and srv.stats.prefilter_degraded == \
            SEARCH_QUERIES, srv.stats.prefilter_degraded
        for (gi, gs), (wi, ws) in zip(got, exact):
            assert np.array_equal(gi, wi) and gs.tobytes() == ws.tobytes()
        print(f"  span search on {n} devices, a dead span: "
              f"{SEARCH_QUERIES} queries served by the exact scan "
              f"(prefilter_degraded {srv.stats.prefilter_degraded})")
        del srv
    sharding.disarm_logical_devices()
    # (d) timings at 1, 2 and 4 shards
    for tag, by_n in rep["streams"].items():
        print(f"  {tag} stream, request wall / device span ms by shards: "
              + "; ".join(f"{k}: {v['wall_ms']:.3f} / "
                          f"{v['device_span_ms']:.3f}"
                          for k, v in by_n.items()))
    rep["launches"] = served
    print(f"phase 22 launches: {served}")
    return rep, served


def _profile_idle(fn, host: bool = True,
                  by_name: dict | None = None) -> tuple[float, float, int]:
    """One call of `fn` under `torch.profiler`: wall s, device busy s as
    the union of every device activity's interval (the shards' streams
    overlap, so the sum of activity times could exceed the wall) and the
    count of device activities. `host=False` traces the device only (a
    step of tens of thousands of launches is read back in seconds, not
    minutes). `by_name`, where given, receives each device activity
    name's summed ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the kineto records themselves: `prof.events()` builds a Python
    # event tree first, seconds for the tens of thousands of a train step
    device = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    spans = sorted((e.start_ns(), e.end_ns()) for e in device)
    if by_name is not None:
        for e in device:
            by_name[e.name()] = by_name.get(e.name(), 0.0) + (
                e.end_ns() - e.start_ns()) / 1e6
    busy, end = 0, None
    for lo, hi in spans:
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return wall, busy / 1e9, len(spans)


#: launcher processes that ran ahead of the phases that check them
#: (`_run_ahead`): {command tuple: CompletedProcess}, the work directories
#: they left their checkpoints in, and each killed run's checkpoint
#: listing right after it exited
_AHEAD: dict = {}
_AHEAD_DIRS: set = set()
_AHEAD_LISTINGS: dict = {}


def _launcher_cmd(*args) -> list:
    return [sys.executable, "-m", "repro_torch.launch.train",
            *map(str, args)]


def _simgnn_cmd(ckpt_dir, *extra) -> list:
    """The SimGNN launcher with phase 20's steps and checkpoints."""
    return _launcher_cmd("--steps", LAUNCH_STEPS, "--ckpt-every",
                         LAUNCH_CKPT_EVERY, "--ckpt-dir", ckpt_dir,
                         "--log-every", 1, *extra)


def _lm_cmd(ckpt_dir, *extra) -> list:
    """The launcher in LM mode with phase 21 (e)'s steps and
    checkpoints."""
    return _launcher_cmd("--model", LM_LAUNCH_ARCH, "--reduced", "--steps",
                         LM_LAUNCH_STEPS, "--ckpt-every", LM_LAUNCH_EVERY,
                         "--log-every", 1, "--ckpt-dir", ckpt_dir, *extra)


def _single_cmd() -> list:
    """24 (d)'s launcher at `--mesh single`."""
    return _launcher_cmd("--model", LM_LAUNCH_ARCH, "--reduced", "--mesh",
                         "single", "--steps", MESH_SINGLE_STEPS, "--batch",
                         MESH_SINGLE_BATCH, "--log-every", 1)


def _procs(cmds, timeout: int = 600) -> list:
    """CompletedProcess records of `cmds`: those `_run_ahead` ran already
    (`ahead` True), the rest started together and waited for (any left at
    the time limit is killed). `wall_s` is each one's seconds from the
    start of its round to its exit being read."""
    out = [_AHEAD.pop(tuple(c), None) for c in cmds]
    procs = []
    try:
        t0 = time.perf_counter()
        for i, cmd in enumerate(cmds):
            if out[i] is None:
                procs.append((i, cmd, subprocess.Popen(
                    cmd, cwd=ROOT, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True,
                    env={**os.environ, "PYTHONPATH": str(ROOT / "src")})))
        for i, cmd, proc in procs:
            stdout, stderr = proc.communicate(timeout=timeout)
            out[i] = subprocess.CompletedProcess(cmd, proc.returncode,
                                                 stdout, stderr)
            out[i].wall_s, out[i].ahead = time.perf_counter() - t0, False
        return out
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _said(proc) -> None:
    print(f"  $ python -m repro_torch.launch.train {' '.join(proc.args[3:])}"
          f": exit {proc.returncode}"
          + (" (run ahead)" if proc.ahead else "") + "; last line: "
          + (proc.stdout.strip().splitlines() or [""])[-1])


def _launch_all(*runs) -> list:
    """`python -m repro_torch.launch.train` with phase 20's steps and
    checkpoints (`_simgnn_cmd`), one process for each `(ckpt_dir,
    *extra)` of `runs`, all started together (`_procs`). Returns their
    CompletedProcess records."""
    out = _procs([_simgnn_cmd(d, *extra) for d, *extra in runs], 300)
    for proc in out:
        _said(proc)
    return out


def _fresh(work: Path) -> None:
    """An empty `work` directory, unless launcher runs ahead of its phase
    (`_run_ahead`) left their checkpoints there."""
    import shutil

    if work in _AHEAD_DIRS:
        _AHEAD_DIRS.discard(work)
        return
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)


def _listing(ckpt_dir: Path) -> list:
    """The checkpoint names in `ckpt_dir` after its killed run: as
    `_run_ahead` saw them, else as they are now."""
    if str(ckpt_dir) in _AHEAD_LISTINGS:
        return _AHEAD_LISTINGS.pop(str(ckpt_dir))
    return sorted(p.name for p in ckpt_dir.iterdir())


def _run_ahead() -> float:
    """Phases 20, 21 (e), 23 (d) and 24 (c)-(d) check launcher runs in
    processes of their own, whose start-up takes most of their time. They
    run here, ahead of those phases, while this process only waits (no
    phase measures meanwhile), in two rounds of processes started
    together: the killed runs and `--mesh single`, then the resumed runs
    (phase 23's from copies of its killed run's directory). The phases
    take the records from `_AHEAD` (`_procs`) and the killed runs'
    listings (`_listing`), and check them as before. Returns its
    seconds."""
    import shutil

    t0 = time.perf_counter()
    sim, lm, sh, mesh = (ROOT / "build" / name for name in (
        "launcher_phase", "lm_launcher_phase", "sharded_train_phase",
        "lm_mesh_phase"))
    for work in (sim, lm, sh, mesh):
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        _AHEAD_DIRS.add(work)
    nd, md = str(SHARD_LAUNCH_DEVICES), str(SHARD_RESUME_DEVICES)
    first = [_simgnn_cmd(sim / "killed", "--simulate-failure",
                         LAUNCH_FAIL_AT),
             _lm_cmd(lm / "killed", "--simulate-failure", LM_LAUNCH_FAIL_AT),
             _simgnn_cmd(sh / "killed", "--devices", nd,
                         "--simulate-failure", LAUNCH_FAIL_AT),
             _lm_cmd(mesh / "killed", "--mesh", "2x2", "--simulate-failure",
                     LM_LAUNCH_FAIL_AT),
             _single_cmd()]
    done = _procs(first)
    for ckpt_dir in (sim / "killed", lm / "killed"):
        _AHEAD_LISTINGS[str(ckpt_dir)] = sorted(
            p.name for p in ckpt_dir.iterdir())
    for tag in ("at_same", "at_more"):
        shutil.copytree(sh / "killed", sh / tag)
    second = [_simgnn_cmd(sim / "killed"), _lm_cmd(lm / "killed"),
              _simgnn_cmd(sh / "at_same", "--devices", nd),
              _simgnn_cmd(sh / "at_more", "--devices", md),
              _lm_cmd(mesh / "killed", "--mesh", "2x2")]
    done += _procs(second)
    for cmd, proc in zip(first + second, done):
        proc.ahead = True
        _AHEAD[tuple(cmd)] = proc
    seconds = time.perf_counter() - t0
    print(f"the launcher runs of phases 20, 21 (e), 23 and 24 (c)-(d), run "
          f"ahead: {len(first)} processes at once, then {len(second)}: "
          f"{seconds:.1f} s")
    return seconds


def sharded_train_phase(params, dev, smi, reset_counts,
                        read_counts) -> dict:
    """Phase 23: device-sharded SimGNN-AIDS training at N in SHARD_COUNTS
    devices (logical devices over cuda:0 on a one-card machine, printed),
    on phase 19's batches (`pair_stream(TRAIN_SEED, TRAIN_BATCH)`).
    (a) `loss_and_grad` forced onto `packed_sparse` and `packed_dense`
    with `accum_steps` 1 and 4: loss and every gradient leaf within
    SHARD_GRAD_ATOL of the unsharded card call, planned on N devices
    without degradation, a repeat bit-equal. (b) TRAIN_STEPS steps of
    `build_simgnn_train_step` on an auto engine: params within
    TRAIN_PARAM_BOUND of the unsharded run's. (c) A `raise` and a `nan`
    fault at `sharded:train:packed_sparse`: the call served on one device,
    bit-equal to the unsharded call, with `packed_sparse@Nd` in
    `degraded_from` and its error counted. (d) The launcher at
    `--devices SHARD_LAUNCH_DEVICES` killed after step LAUNCH_FAIL_AT
    (exit 42) and resumed from its checkpoint at that count (final params
    and AdamW state bit-equal to an uninterrupted run) and at
    SHARD_RESUME_DEVICES (params within TRAIN_PARAM_BOUND). No scoring
    kernel may launch. Printed beside the card's name and power limit:
    the step ms (median of steps 2.., CUDA events), its `loss_and_grad`
    ms and the idle share of a profiled step at 1, 2 and 4 devices; no
    speed is claimed, since logical devices share one card."""
    import shutil

    from repro_torch.ckpt import manager as ckpt
    from repro_torch.configs.simgnn_aids import CONFIG as CFG
    from repro_torch.core.engine import ScoringEngine
    from repro_torch.data.graphs import pair_stream
    from repro_torch.distributed import sharding
    from repro_torch.launch import train as launch
    from repro_torch.params import tree_leaves
    from repro_torch.testing import faults
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import build_simgnn_train_step

    stream = pair_stream(TRAIN_SEED, TRAIN_BATCH, device="cpu")
    batches = [next(stream) for _ in range(TRAIN_STEPS)]
    pairs, target = batches[0]["pairs"], batches[0]["target"]
    rep: dict = {"card": smi, "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
                 "calls": {}, "steps_by_devices": {}, "collapse": {}}

    def run_steps(engine) -> tuple:
        """TRAIN_STEPS steps from `params`: (params, step ms,
        loss_and_grad ms, profiled wall s, busy s, device activities)."""
        events = []
        real = engine.loss_and_grad

        def timed(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = real(*args, **kw)
            end.record()
            events[-1]["fwd_bwd"] = (start, end)
            return out
        engine.loss_and_grad = timed
        step = build_simgnn_train_step(engine)
        p, st = engine.params, adamw_init(engine.params)
        try:
            for b in batches:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                events.append({})
                start.record()
                p, st, m = step(p, st, {"pairs": b["pairs"],
                                        "target": b["target"]})
                end.record()
                events[-1]["step"] = (start, end)
                assert "skipped" not in m and \
                    engine.last_plan.degraded_from == (), engine.last_plan
            torch.cuda.synchronize()
        finally:
            del engine.loss_and_grad
        wall, busy, n_act = _profile_idle(lambda: step(
            p, st, {"pairs": batches[-1]["pairs"],
                    "target": batches[-1]["target"]}))
        step_ms = [e["step"][0].elapsed_time(e["step"][1]) for e in events]
        fb_ms = [e["fwd_bwd"][0].elapsed_time(e["fwd_bwd"][1])
                 for e in events]
        return p, step_ms, fb_ms, wall, busy, n_act

    reset_counts()
    one = {path: ScoringEngine(params, CFG, path=path, device=dev)
           for path in ("packed_sparse", "packed_dense")}
    want = {(path, acc): eng.loss_and_grad(pairs, target, accum_steps=acc)
            for path, eng in one.items() for acc in (1, 4)}
    auto_one = ScoringEngine(params, CFG, device=dev)
    base = run_steps(auto_one)
    assert auto_one.last_plan.path == "packed_sparse", auto_one.last_plan
    by_n = {1: base}
    ref = auto_one.loss_and_grad(pairs, target)
    for n in SHARD_COUNTS:
        rt, kind = _shard_runtime(n)
        print(f"phase 23: {n} devices: " + (
            f"the first {n} cards" if kind == "cards" else
            f"{n} logical devices over cuda:0, a stream each"))
        # (a) loss_and_grad on both packed paths
        for path in ("packed_sparse", "packed_dense"):
            eng = ScoringEngine(params, CFG, path=path, device=dev,
                                runtime=rt)
            for acc in (1, 4):
                loss, grads = eng.loss_and_grad(pairs, target,
                                                accum_steps=acc)
                plan, ps = eng.last_plan, eng.last_pack_stats
                again = eng.loss_and_grad(pairs, target, accum_steps=acc)
                wl, wg = want[(path, acc)]
                err = max(abs(float(loss) - float(wl)), _tree_err(grads, wg))
                same = _bit_equal((loss, grads), again)
                assert plan.devices == n and plan.degraded_from == () and \
                    plan.attempts == 1 and ps["devices"] == n, (plan, ps)
                assert err <= SHARD_GRAD_ATOL and same, (path, n, acc, err,
                                                         same)
                assert all(g.is_cuda for g in tree_leaves(grads))
                rep["calls"][f"{path}/{n}/{acc}"] = {
                    "err": err, "repeat_bit_equal": same,
                    "tiles": ps["tiles"], "tiles_padded": ps["tiles_padded"]}
                print(f"  loss_and_grad {path} on {n} devices, accum_steps "
                      f"{acc}: loss {float(loss):.8f}; largest difference "
                      f"from the unsharded card call {err:.3e} (bound "
                      f"{SHARD_GRAD_ATOL:g}); repeat bit-equal {same}; "
                      f"{ps['tiles']} tiles padded to {ps['tiles_padded']}")
            del eng
        # (b) TRAIN_STEPS steps on an auto engine
        auto = ScoringEngine(params, CFG, device=dev, runtime=rt)
        by_n[n] = run_steps(auto)
        assert auto.last_plan.path == "packed_sparse" and \
            auto.last_plan.devices == n, auto.last_plan
        perr = _tree_err(by_n[n][0], base[0])
        print(f"  {TRAIN_STEPS} train steps on {n} devices: params against "
              f"the unsharded run's, largest difference {perr:.3e} (bound "
              f"{TRAIN_PARAM_BOUND:g})")
        assert perr <= TRAIN_PARAM_BOUND, perr
        rep["steps_by_devices"][n] = {"param_err": perr}
        # (c) the collapse rung
        for mode in ("raise", "nan"):
            errors = auto.counters[f"errors:train:packed_sparse@{n}d"]
            with faults.inject("sharded:train:packed_sparse", mode,
                               times=1) as fp:
                loss, grads = auto.loss_and_grad(pairs, target)
            plan = auto.last_plan
            same = _bit_equal((loss, grads), ref)
            assert fp.triggered == 1 and same, (mode, n)
            assert plan.degraded_from == (f"packed_sparse@{n}d",) and \
                plan.attempts == 2 and plan.devices == n, plan
            assert auto.counters[f"errors:train:packed_sparse@{n}d"] == \
                errors + 1, dict(auto.counters)
            rep["collapse"][f"{mode}/{n}"] = {
                "degraded_from": list(plan.degraded_from),
                "counters": dict(auto.counters)}
            print(f"  collapse rung, {mode} at sharded:train:packed_sparse "
                  f"on {n} devices: served on one device bit-equal to the "
                  f"unsharded call; degraded_from {plan.degraded_from}")
        del auto
    sharding.disarm_logical_devices()
    # (d) the launcher at SHARD_LAUNCH_DEVICES devices
    work = ROOT / "build" / "sharded_train_phase"
    _fresh(work)
    nd, md = str(SHARD_LAUNCH_DEVICES), str(SHARD_RESUME_DEVICES)
    try:
        killed, = _launch_all((work / "killed", "--devices", nd,
                               "--simulate-failure", str(LAUNCH_FAIL_AT)))
        assert killed.returncode == 42, killed.stdout + killed.stderr
        assert f"[train] {nd} devices: " in killed.stdout, killed.stdout
        last = LAUNCH_FAIL_AT // LAUNCH_CKPT_EVERY * LAUNCH_CKPT_EVERY
        for tag in ("at_same", "at_more"):
            if not (work / tag).exists():       # made by `_run_ahead`
                shutil.copytree(work / "killed", work / tag)
        same_n, more_n = _launch_all((work / "at_same", "--devices", nd),
                                     (work / "at_more", "--devices", md))
        for proc in (same_n, more_n):
            assert proc.returncode == 0, proc.stdout + proc.stderr
            assert f"[loop] resumed from step {last}" in proc.stdout, \
                proc.stdout
        straight = launch.main(["--steps", str(LAUNCH_STEPS),
                                "--ckpt-every", str(LAUNCH_CKPT_EVERY),
                                "--ckpt-dir", str(work / "straight"),
                                "--log-every", "1", "--devices", nd])
        like = (straight.params, straight.opt_state)
        got = ckpt.restore(str(work / "at_same"), LAUNCH_STEPS, like)
        same = _bit_equal(got, like)
        more = ckpt.restore(str(work / "at_more"), LAUNCH_STEPS, like)
        merr = _tree_err(more[0], straight.params)
        print(f"launcher at --devices {nd}: killed at step {LAUNCH_FAIL_AT} "
              f"(exit 42), resumed from step {last} at {nd} devices: final "
              f"params and AdamW state bit-equal to the uninterrupted run: "
              f"{same}; resumed at {md} devices: params within {merr:.3e} "
              f"(bound {TRAIN_PARAM_BOUND:g})")
        assert same and merr <= TRAIN_PARAM_BOUND, (same, merr)
        rep["launcher"] = {"bit_equal": same, "resume_at_more_err": merr,
                           "step_ms": [1e3 * r["sec_per_step"]
                                       for r in straight.history]}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    counts = read_counts()
    print(f"phase 23 launches of the scoring kernels: {counts}")
    assert not any(counts.values()), counts
    # the times, each beside the card
    for n, (_, step_ms, fb_ms, wall, busy, n_act) in sorted(by_n.items()):
        row = {"step_ms": step_ms, "loss_and_grad_ms": fb_ms,
               "step_ms_median": statistics.median(step_ms[1:]),
               "loss_and_grad_ms_median": statistics.median(fb_ms[1:]),
               "profiled_wall_s": wall, "device_busy_s": busy,
               "idle_share": 1 - busy / wall, "device_activities": n_act}
        rep["steps_by_devices"].setdefault(n, {}).update(row)
        print(f"  train step of {TRAIN_BATCH} pairs on {n} device(s) "
              f"[{smi}]: {row['step_ms_median']:.3f} ms (median of steps "
              f"2..{TRAIN_STEPS}, CUDA events), of which loss_and_grad "
              f"{row['loss_and_grad_ms_median']:.3f} ms; profiled step "
              f"wall {1e3 * wall:.3f} ms, device busy {1e3 * busy:.3f} ms "
              f"(union over streams; idle share {row['idle_share']:.4f}), "
              f"{n_act} device activities")
    return rep


# ------------------------------------------- phase 24: the LM mesh


def _mesh_runtime(shape, device):
    """`launch.mesh.mesh_runtime` of a (data, model) shape over `device`
    (None: no mesh); logical devices on a one-card machine."""
    from repro_torch.launch.mesh import mesh_runtime

    spec = "none" if shape is None else "x".join(map(str, shape))
    return mesh_runtime(spec, torch.device(device))[0]


def _placed(params, rt):
    from repro_torch.distributed import placement, sharding

    if rt.mesh is None:
        return params
    return placement.shard_tree(params, sharding.param_shardings(rt, params))


def _whole(tree) -> list:
    from repro_torch.distributed import placement
    from repro_torch.params import tree_leaves

    return [placement.gather(x) for x in tree_leaves(tree)]


def _same(a: list, b: list) -> bool:
    """Leaf lists bit-equal (compared on the first list's devices)."""
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y.to(x.device))
        for x, y in zip(a, b))


def _l2(leaves) -> float:
    return float(torch.sqrt(sum(torch.sum(torch.square(x.float()))
                                for x in leaves)))


def _mesh_distances(run: dict, ref: dict, init: list) -> dict:
    """A run's distances to the unsharded run `ref` (MESH_LIMITS' keys):
    grad norms, final params against the unsharded update, first
    moments."""
    gn = max(abs(a - b) / b for a, b in zip(run["grad_norm"],
                                           ref["grad_norm"]))
    params = _l2(a.float() - b.float() for a, b in zip(
        run["params"], ref["params"])) / _l2(
        a.float() - b.float() for a, b in zip(ref["params"], init))
    moment = _l2(a - b for a, b in zip(run["m"], ref["m"])) / _l2(ref["m"])
    return {"grad_norm": gn, "params": params, "moment": moment}


def _mesh_seamless(dev, smi) -> dict:
    """24 (a): seamless at full width and depth, MESH_STEPS steps of
    phase 21 (b)'s batches unsharded, on each of MESH_SHAPES, and the
    dropped-replica control."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.launch import step_analysis
    from repro_torch.models.init import init_params
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import build_train_step

    cfg = get_config(SEAMLESS_ARCH)
    init = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    batches = [_batch_on(batch_for_step(cfg, s,
                                        global_batch=ENCDEC_TRAIN_BATCH,
                                        seq_len=ENCDEC_FRAMES), dev)
               for s in range(MESH_STEPS)]
    rows = ENCDEC_TRAIN_BATCH // 2          # one replica's rows at data 2
    dropped = [{k: v[:rows] for k, v in b.items()} for b in batches]
    runs, same, ref = {}, None, None
    for shape in (None,) + MESH_SHAPES + ("dropped",):
        control = shape == "dropped"
        rt = _mesh_runtime(None if control else shape, "cuda:0")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params = _placed(init, rt)
        opt_state = adamw_init(params, cfg.opt_state_dtype)
        placed = (None if rt.mesh is None else step_analysis.placed_bytes(
            [params, opt_state], rt.mesh.size))
        step = build_train_step(cfg, rt)
        step_ms, losses, norms = [], [], []
        for i, batch in enumerate(dropped if control else batches):
            t0 = time.perf_counter()
            if control or i < MESH_STEPS - 1:
                params, opt_state, m = step(params, opt_state, batch)
            else:                   # the last step under the profiler
                out = []
                wall, busy, n_launch = _profile_idle(
                    lambda: out.append(step(params, opt_state, batch)),
                    host=False)
                params, opt_state, m = out.pop()
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            assert np.isfinite(losses[-1]), (shape, losses)
        peak = torch.cuda.max_memory_allocated()
        name = ("dropped" if control else "none" if shape is None
                else "x".join(map(str, shape)))
        out = {"params": _whole(params), "m": _whole(opt_state.m),
               "grad_norm": norms}
        del params, opt_state
        run = {"step_ms": step_ms, "losses": losses, "grad_norms": norms,
               "model_row": step.model_row, "placed_bytes": placed}
        if ref is None:
            ref = out
        else:
            run["distances"] = _mesh_distances(out, ref, _whole(init))
        if name == "1x1":
            same = (losses == runs["none"]["losses"]
                    and _same(out["params"], ref["params"])
                    and _same(out["m"], ref["m"]))
        del out
        runs[name] = run
        torch.cuda.empty_cache()
        if control:
            continue
        run.update({"peak_bytes": peak, "resident_bytes_before": base,
                    "profiled_wall_s": wall, "device_busy_s": busy,
                    "idle_share": 1 - busy / wall,
                    "device_activities": n_launch})
        print(f"seamless (a) on {name} [{smi}]: {MESH_STEPS} steps of "
              f"[{ENCDEC_TRAIN_BATCH}, {ENCDEC_FRAMES}] frames, bf16: "
              f"{statistics.median(step_ms[1:-1]):.3f} ms a step (median of "
              f"steps 2-{MESH_STEPS - 1}; first {step_ms[0]:.3f}; the last, "
              f"profiled, {step_ms[-1]:.3f}); peak memory "
              f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB over "
              f"the {base / 2**30:.2f} GiB resident before); profiled step "
              f"wall {1e3 * wall:.3f} ms, busy {1e3 * busy:.3f} ms (union "
              f"over streams), idle share {1 - busy / wall:.4f}, {n_launch} "
              f"device activities; losses {[round(x, 5) for x in losses]}")
    want = runs["none"]["losses"]
    for name, run in runs.items():
        rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], want))
        run["loss_rel_err"] = rel
    print(f"  (1, 1) bit-equal to unsharded (losses, final params, first "
          f"moments): {same}")
    for name, run in runs.items():
        if name != "none":
            print(f"  {name} (model row {run['model_row']}) against "
                  f"unsharded: loss rel err "
                  f"{run['loss_rel_err']:.3e} (limit {MESH_LOSS_RTOL:g}), "
                  + ", ".join(f"{k} {v:.3e} (limit {MESH_LIMITS[k]:g})"
                              for k, v in run["distances"].items()))
    for name, run in runs.items():
        if name == "dropped":
            assert all(run["distances"][k] > lim
                       for k, lim in MESH_LIMITS.items()), run["distances"]
        elif name != "none":
            assert run["loss_rel_err"] <= MESH_LOSS_RTOL, (name, run)
            assert all(run["distances"][k] <= lim
                       for k, lim in MESH_LIMITS.items()), (name, run)
    assert runs["1x4"]["model_row"] == 4 and runs["2x2"]["model_row"] == 2
    assert same
    return {"runs": runs, "bit_equal_1x1": same, "limits": MESH_LIMITS}


def _mesh_families(dev, reset_counts, read_counts) -> tuple[dict, dict]:
    """24 (b): MESH_CASES on (2, 2) over logical devices of the card
    against the same steps on logical CPU devices; the kernel launches of
    the card runs."""
    from repro_torch.configs import reduced_config
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.models.init import init_params
    from repro_torch.params import params_to
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import build_train_step

    rep, launches = {}, {}
    for arch, kw, batch, tokens, names in MESH_CASES:
        cfg = reduced_config(arch).with_(**kw)
        host = init_params(torch.Generator().manual_seed(11), cfg,
                           device="cpu")
        out = {}
        for device in ("cuda:0", "cpu"):
            rt = _mesh_runtime((2, 2), device)
            params = _placed(params_to(host, device), rt)
            opt_state = adamw_init(params)
            step = build_train_step(cfg, rt)
            if device != "cpu":
                reset_counts()
            losses = []
            for s in range(MESH_CASE_STEPS):
                params, opt_state, m = step(params, opt_state, batch_for_step(
                    cfg, s, global_batch=batch, seq_len=tokens))
                losses.append(float(m["loss"]))
            if device != "cpu":
                torch.cuda.synchronize()
                counts = read_counts()
            out[device] = (_whole((params, opt_state.m, opt_state.v)),
                           losses)
        err = max(float((a.cpu() - b).abs().max())
                  for a, b in zip(out["cuda:0"][0], out["cpu"][0]))
        loss_err = max(abs(a - b) for a, b in zip(out["cuda:0"][1],
                                                  out["cpu"][1]))
        ran = {k: v for k, v in counts.items() if v}
        print(f"families (b): reduced {arch} float32 on (2, 2), "
              f"{MESH_CASE_STEPS} steps of [{batch}, {tokens}] tokens: params "
              f"and moments within {err:.3e} of the CPU mesh run (bound "
              f"{STEP_PARAM_BOUND:g}), losses within {loss_err:.3e}; kernel "
              f"launches {ran}")
        assert err <= STEP_PARAM_BOUND and loss_err <= STEP_PARAM_BOUND, \
            (arch, err, loss_err)
        for name in names:
            assert counts[name] > 0, (arch, name)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        rep[arch] = {"param_err": err, "loss_err": loss_err,
                     "launches": ran}
    return rep, launches


def _mesh_elastic(dev) -> dict:
    """24 (c): the LM launcher at `--mesh 2x2` killed after step
    LM_LAUNCH_FAIL_AT (exit 42) and resumed in a second process, held
    bit-equal to an uninterrupted run in this process; its last
    checkpoint restored onto MESH_RESTORE_SHAPES and the live tree
    resharded from (2, 2) onto (1, 4), each bit-equal after gathering."""
    import shutil

    from repro_torch.ckpt import manager as ckpt
    from repro_torch.ckpt.reshard import (reshard_live, restore_on_mesh,
                                          train_state_shardings)
    from repro_torch.launch import train as launch
    from repro_torch.params import tree_leaves

    work = ROOT / "build" / "lm_mesh_phase"
    _fresh(work)
    try:
        killed = _launch_lm(work / "killed", "--mesh", "2x2",
                            "--simulate-failure", str(LM_LAUNCH_FAIL_AT))
        assert killed.returncode == 42, killed.stdout + killed.stderr
        assert "4 logical devices over cuda:0" in killed.stdout
        resumed = _launch_lm(work / "killed", "--mesh", "2x2")
        assert resumed.returncode == 0, resumed.stdout + resumed.stderr
        assert f"[loop] resumed from step {LM_LAUNCH_FAIL_AT}" in \
            resumed.stdout, resumed.stdout
        straight = launch.main(
            ["--model", LM_LAUNCH_ARCH, "--reduced", "--steps",
             str(LM_LAUNCH_STEPS), "--ckpt-every", str(LM_LAUNCH_EVERY),
             "--log-every", "1", "--mesh", "2x2", "--ckpt-dir",
             str(work / "straight")])
        like = (straight.params, straight.opt_state)
        want = _whole(like)
        final = ckpt.restore(str(work / "killed"), LM_LAUNCH_STEPS, like)
        same = _same(_whole(final), want)
        restored = {}
        for shape in MESH_RESTORE_SHAPES:
            tree = restore_on_mesh(str(work / "killed"), LM_LAUNCH_STEPS,
                                   like, train_state_shardings(
                                       _mesh_runtime(shape, "cuda:0"),
                                       straight.params))
            name = "none" if shape is None else "x".join(map(str, shape))
            restored[name] = _same(_whole(tree), want)
            assert all(x.is_cuda for x in _whole(tree))
        moved = reshard_live(like, train_state_shardings(
            _mesh_runtime((1, 4), "cuda:0"), straight.params))
        live = _same(_whole(moved), want) and {
            x.sharding.mesh.axis_sizes for x in tree_leaves(moved[0])} == {
            (1, 4)}
        step_ms = [1e3 * r["sec_per_step"] for r in straight.history]
        print(f"elastic (c): reduced {LM_LAUNCH_ARCH} at --mesh 2x2, killed "
              f"after step {LM_LAUNCH_FAIL_AT} (exit 42) and resumed: final "
              f"params and AdamW state bit-equal to the uninterrupted run: "
              f"{same}; its last checkpoint restored bit-equal onto "
              f"{restored}; resharded live (2, 2) -> (1, 4) bit-equal: "
              f"{live}; a step {statistics.median(step_ms[1:]):.3f} ms "
              f"(median of steps 1-{LM_LAUNCH_STEPS - 1}, loop timing)")
        assert same and all(restored.values()) and live
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"bit_equal": same, "restored": restored, "reshard_live": live,
            "step_ms": step_ms}


def _mesh_launcher_and_example(dev) -> dict:
    """24 (d): the launcher at `--mesh single` (256 logical devices over
    cuda:0) and the elastic_restart example on (2, 2) restored onto
    (4, 1)."""
    import io
    from contextlib import redirect_stdout

    from repro_torch.examples import elastic_restart

    proc, = _procs([_single_cmd()])
    single_s = proc.wall_s
    lines = proc.stdout.strip().splitlines()
    print(f"  $ python -m repro_torch.launch.train {' '.join(proc.args[3:])}"
          f": exit {proc.returncode} in {single_s:.1f} s"
          + (" (run ahead, beside 4 other launcher processes)"
             if proc.ahead else "") + "; "
          + " | ".join(lines[:1] + lines[-2:]))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "256 logical devices over cuda:0" in proc.stdout
    buf = io.StringIO()
    with redirect_stdout(buf):
        elastic_restart.main(["--mesh", "2x2", "--restore-mesh", "4x1"])
    out = buf.getvalue()
    print("  elastic_restart --mesh 2x2 --restore-mesh 4x1: " + " | ".join(
        ln for ln in out.splitlines() if not ln.startswith("[loop] strag")))
    assert "resumed and reached step 10" in out
    assert "restored step 10; max param diff after round trip: 0.0e+00" \
        in out
    return {"single_s": single_s, "single_stdout": lines[-4:],
            "example": out.splitlines()}


def lm_mesh_phase(dev, smi, reset_counts, read_counts) -> tuple[dict, dict]:
    """Phase 24: the LM mesh over logical devices of the card (a)-(d)
    above; each part prints its seconds. Returns (report, the kernel
    launches of (b), the path's run of the LM kernels)."""
    rep, clock = {"card": smi}, PhaseClock()
    rep["seamless"] = _mesh_seamless(dev, smi)
    clock("24 (a) seamless on the mesh")
    rep["families"], launches = _mesh_families(dev, reset_counts,
                                               read_counts)
    clock("24 (b) reduced families on (2, 2) against the CPU")
    rep["elastic"] = _mesh_elastic(dev)
    clock("24 (c) elastic restart and resharding")
    rep["launcher"] = _mesh_launcher_and_example(dev)
    clock("24 (d) --mesh single and the elastic_restart example")
    rep["seconds"] = clock.seconds
    return rep, launches



# ------------------------------------------------ phase 25: GPipe


def _pipe_mesh(n: int, kind: str = "cuda"):
    """A ("stage",) mesh of `n` members and which devices it took: on the
    card the first n cards where the machine has them, else n logical
    devices over cuda:0; on the CPU n logical CPU devices."""
    from repro_torch.distributed import sharding

    if kind == "cuda" and torch.cuda.device_count() >= n:
        return (sharding.lm_mesh((n,), ("stage",), "cuda"),
                f"the first {n} cards")
    over = "cuda:0" if kind == "cuda" else "cpu"
    with sharding.logical_devices(n, over):
        return (sharding.lm_mesh((n,), ("stage",), over),
                f"{n} logical devices over {over}")


def _pipe_blocks(groups, mesh, n: int):
    """Group stacks [G, ...] as [n, G / n, ...] ShardedTensors laid out by
    P("stage") (stage s's groups on member s), each block a leaf that
    requires grad."""
    from repro_torch.distributed import placement, sharding
    from repro_torch.params import tree_map

    spec = sharding.NamedSharding(mesh, sharding.P("stage"))

    def leaf(t):
        st = placement.shard(t.detach().reshape(n, t.shape[0] // n,
                                                *t.shape[1:]), spec)
        for b in st.blocks:
            b.requires_grad_()
        return st

    return tree_map(leaf, groups)


def _pipe_stage_fn(cfg, remat: bool):
    """A stage: its layer groups in order (`lm._run_groups`)."""
    from repro_torch.models import lm

    return lambda p, x: lm._run_groups({"groups": p}, cfg, x,
                                       positions=lm._positions(x),
                                       remat=remat)[0]


def _pipe_value_and_grad(run, stacked, x, loss_fn):
    """(y, loss, grads of every block then of x), synchronized."""
    from repro_torch.params import tree_leaves

    leaves = [b for st in tree_leaves(stacked) for b in st.blocks]
    y = run(stacked, x)
    loss = loss_fn(y)
    grads = torch.autograd.grad(loss, leaves + [x])
    torch.cuda.synchronize()
    return y.detach(), float(loss.detach()), [g.detach() for g in grads]


def _pipe_distances(grads, ref) -> dict:
    """Relative L2 distances of the stage params' grads (together) and of
    x's grad to `ref`'s (PIPE_LIMITS' keys)."""
    return {"params": _l2(a - b for a, b in zip(grads[:-1], ref[:-1]))
            / _l2(ref[:-1]),
            "x": _l2([grads[-1] - ref[-1]]) / _l2(ref[-1:])}


def _pipe_granite(dev, smi, reset_counts, read_counts) -> tuple[dict, dict]:
    """25 (a): granite pipelined at full width and depth against the
    stages in order; the main path's kernel launches (its first
    pipelined value-and-grad)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.distributed.pipeline import gpipe, sequential
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attention_plain)
    from repro_torch.kernels.moe_experts import (moe_expert_ffn,
                                                 moe_expert_ffn_plain)
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.init import init_params

    cfg = get_config(LM_ARCH).with_(moe_use_kernel=True)
    params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    mesh, where = _pipe_mesh(PIPE_STAGES)
    stacked = _pipe_blocks(params.pop("groups"), mesh, PIPE_STAGES)
    torch.cuda.empty_cache()
    tokens = torch.from_numpy(batch_for_step(
        cfg, 0, global_batch=PIPE_BATCH, seq_len=PIPE_TOKENS)[
            "tokens"]).to(dev)
    with torch.no_grad():
        x = lm.embed_tokens(params, cfg, tokens)
    x.requires_grad_()
    rows = PIPE_BATCH // PIPE_MICRO

    def loss_fn(y, keep=PIPE_BATCH):
        logits = lm.logits_from_hidden(params, cfg, y[:keep])
        return lm.next_token_nll(logits[:, :-1], tokens[:keep])

    fn = _pipe_stage_fn(cfg, remat=True)
    runs = {"pipelined": gpipe(fn, mesh, n_microbatches=PIPE_MICRO),
            "sequential": sequential(fn, mesh, n_microbatches=PIPE_MICRO)}
    print(f"gpipe (a) [{smi}]: {LM_ARCH} bf16, {cfg.n_groups} layer groups "
          f"in {PIPE_STAGES} stages over {where}, [{PIPE_BATCH}, "
          f"{PIPE_TOKENS}] tokens in {PIPE_MICRO} microbatches, remat")
    # each kernel's last forward call (one a layer and microbatch, before
    # the remat recompute): the last stage's last layer on the last
    # microbatch
    keep = {name: {"calls": {cfg.n_layers * PIPE_MICRO - 1}, "args": []}
            for name in ("moe_experts", "flash_attn")}
    restores = [_capture(moe_mod, "moe_expert_ffn", keep["moe_experts"]),
                _capture(layers_mod, "flash_attention", keep["flash_attn"])]
    try:
        torch.cuda.synchronize()
        reset_counts()
        y, loss, grads = _pipe_value_and_grad(runs["pipelined"], stacked, x,
                                              loss_fn)
        counts = read_counts()
    finally:
        for restore in restores:
            restore()
    held = _pipe_held(keep, moe_expert_ffn, moe_expert_ffn_plain,
                      flash_attention, flash_attention_plain, smi)
    ref_y, ref_loss, ref = _pipe_value_and_grad(runs["sequential"], stacked,
                                                x, loss_fn)
    same_y = torch.equal(y, ref_y)
    same_grads = all(torch.equal(a, b) for a, b in zip(grads, ref))
    dist = _pipe_distances(grads, ref)
    finite = bool(np.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    del y, ref_y, grads
    _, dropped_loss, dropped = _pipe_value_and_grad(
        runs["sequential"], stacked, x,
        lambda y: loss_fn(y, PIPE_BATCH - rows))
    control = _pipe_distances(dropped, ref)
    del dropped, ref
    torch.cuda.empty_cache()
    rep = {"mesh": where, "loss": loss, "sequential_loss": ref_loss,
           "dropped_loss": dropped_loss, "forward_bit_equal": same_y,
           "grads_bit_equal": same_grads, "held_at_path_shapes": held,
           "distances": dist, "control": control, "limits": PIPE_LIMITS,
           "launches": {k: v for k, v in counts.items() if v}}
    for name, run in runs.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _pipe_value_and_grad(run, stacked, x, loss_fn)
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        by_name: dict = {}
        wall, busy, n_act = _profile_idle(
            lambda run=run: _pipe_value_and_grad(run, stacked, x, loss_fn),
            host=False, by_name=by_name)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:PIPE_TOP]
        rep[name] = {"value_and_grad_ms": ms, "peak_bytes": peak,
                     "resident_bytes_before": base, "profiled_wall_s": wall,
                     "device_busy_s": busy, "idle_share": 1 - busy / wall,
                     "device_activities": n_act, "top_device_ms": top}
        print(f"  {name} [{smi}]: value and grad {ms:.3f} ms (warm, host "
              f"clock to a synchronize); peak memory {peak / 2**30:.2f} GiB "
              f"({(peak - base) / 2**30:.2f} GiB over the "
              f"{base / 2**30:.2f} GiB resident before); profiled wall "
              f"{1e3 * wall:.3f} ms, busy {1e3 * busy:.3f} ms (union over "
              f"streams), idle share {1 - busy / wall:.4f}, {n_act} device "
              f"activities; the most device time by name: " + "; ".join(
                  f"{k[:60]} {v:.1f} ms" for k, v in top))
    print(f"  forward bit-equal to the stages in order: {same_y}; every "
          f"gradient bit-equal: {same_grads}; loss "
          f"{loss:.6f} (in order {ref_loss:.6f}); grads against the stages "
          f"in order: " + ", ".join(
              f"{k} {v:.3e} (limit {PIPE_LIMITS[k]:g})"
              for k, v in dist.items())
          + "; the last microbatch dropped (loss "
          f"{dropped_loss:.6f}): " + ", ".join(
              f"{k} {v:.3e}" for k, v in control.items())
          + f"; launches {rep['launches']}")
    assert finite and same_y and same_grads, rep
    assert all(dist[k] <= lim for k, lim in PIPE_LIMITS.items()), rep
    assert all(control[k] > lim for k, lim in PIPE_LIMITS.items()), rep
    for name in ("moe_experts", "flash_attn"):
        assert counts[name] > 0, (name, counts)
    return rep, rep["launches"]


def _pipe_held(keep, moe, moe_plain, flash, flash_plain, smi) -> dict:
    """25 (a): the `moe_experts` and `flash_attn` arguments captured in
    the pipelined run, each kernel's output held against its plain
    version's: `moe_expert_ffn` within one bf16 ulp + BODY_TOL
    (`_bf16_excess`), `flash_attention` through float64 under FLASH_TOL
    (`_held_f64`). Returns each kernel's shapes and distances."""
    out = {}
    with torch.no_grad():
        (x, w_in, w_out), _ = keep["moe_experts"]["args"][0]
        x, w_in, w_out = (t.detach() for t in (x, w_in, w_out))
        got, want = moe(x, w_in, w_out), moe_plain(x, w_in, w_out)
        excess = _bf16_excess(got, want)
        err = float((got.float() - want.float()).abs().max())
        b, e, c, d = x.shape
        print(f"  moe_experts [{smi}] [pipelined granite, last layer, B {b} "
              f"E {e} C {c} D {d} F {w_out.shape[1]}, {x.dtype}]: max abs "
              f"err {err:.3e}, excess over one bf16 ulp + f32 bound "
              f"{excess:.3e}")
        assert torch.isfinite(got.float()).all() and excess <= 0, excess
        out["moe_experts"] = {"shape": [b, e, c, d, w_out.shape[1]],
                              "max_abs_err": err, "bf16_excess": excess}
        del x, w_in, w_out, got, want
        (q, k, v), kw = keep["flash_attn"]["args"][0]
        q, k, v = (t.detach() for t in (q, k, v))
        b, t, h, d = q.shape
        out["flash_attn"] = dict(
            shape=[b, t, h, k.shape[2], d],
            **_held_f64("flash_attn", f"pipelined granite, last layer, B {b} "
                        f"T {t} H {h} KV {k.shape[2]} D {d}, {q.dtype}",
                        flash(q, k, v, **kw), flash_plain(q, k, v, **kw),
                        _flash_f64(q, k, v, **kw), FLASH_TOL))
    torch.cuda.synchronize()
    return out


def _pipe_reduced(dev) -> dict:
    """25 (b): LM_ARCH reduced to PIPE_STAGES layer groups in
    float32, pipelined over logical devices of the card against the same
    call on logical CPU devices."""
    from repro_torch.configs import reduced_config
    from repro_torch.distributed.pipeline import gpipe
    from repro_torch.models.init import init_params
    from repro_torch.params import params_to

    cfg = reduced_config(LM_ARCH)
    cfg = cfg.with_(n_layers=PIPE_STAGES * cfg.group_size)
    host = init_params(torch.Generator().manual_seed(11), cfg, device="cpu")
    x_host = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (PIPE_MICRO, 64, cfg.d_model)).astype(np.float32))
    out = {}
    for kind in ("cuda", "cpu"):
        mesh, _ = _pipe_mesh(PIPE_STAGES, kind)
        device = mesh.devices[0]
        stacked = _pipe_blocks(params_to(host, device)["groups"], mesh,
                               PIPE_STAGES)
        x = x_host.to(device).requires_grad_()
        y, _, grads = _pipe_value_and_grad(
            gpipe(_pipe_stage_fn(cfg, remat=False), mesh,
                  n_microbatches=PIPE_MICRO), stacked, x,
            lambda y: torch.sum(y ** 2))
        out[kind] = [t.cpu() for t in (y, *grads)]
    err = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(out["cuda"], out["cpu"]))
    print(f"gpipe (b): reduced {LM_ARCH} float32, {PIPE_STAGES} "
          f"stages of one layer group, [{PIPE_MICRO}, 64] tokens: y and "
          f"every gradient leaf within {err:.3e} (of the CPU leaf's largest "
          f"|value|) of logical CPU devices (bound {PIPE_F32_BOUND:g})")
    assert err <= PIPE_F32_BOUND, err
    return {"rel_err": err}


def pipeline_phase(dev, smi, reset_counts, read_counts) -> tuple[dict, dict]:
    """Phase 25: GPipe (a) and (b) above; each part prints its seconds.
    Returns (report, the kernel launches of (a)'s main path)."""
    rep, clock = {"card": smi}, PhaseClock()
    rep["granite"], launches = _pipe_granite(dev, smi, reset_counts,
                                             read_counts)
    torch.cuda.empty_cache()
    clock("25 (a) granite pipelined at full width and depth")
    rep["reduced"] = _pipe_reduced(dev)
    clock("25 (b) reduced float32 granite, card against CPU")
    rep["seconds"] = clock.seconds
    return rep, launches

def _tp_runtime(shape):
    """(runtime, where its mesh lies) of a (data, model) mesh of `shape`
    on the card: the first cards where the machine has them, else logical
    devices over cuda:0."""
    from repro_torch.launch.mesh import mesh_runtime

    return mesh_runtime("x".join(map(str, shape)), torch.device("cuda"))


def _tp_rel(a, b, v: int) -> float:
    """Relative L2 distance of `a` from `b` over the first `v` entries of
    their last dim (the vocabulary's columns of logits)."""
    a, b = a[..., :v].float(), b[..., :v].float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


@contextmanager
def _tp_control(n_layers: int):
    """The control of phase 26: every `tp_apply_block` call of a layer
    n_layers - 1 (mod n_layers) leaves its row's last member's partial out
    of its row sums."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import lm

    real_block, real_sum = lm.tp_apply_block, tp.row_sum
    state = {"calls": 0, "drop": False}

    def block(*args, **kw):
        state["drop"] = state["calls"] % n_layers == n_layers - 1
        state["calls"] += 1
        try:
            return real_block(*args, **kw)
        finally:
            state["drop"] = False

    def row_sum(row, partials):
        if state["drop"] and row.size > 1:
            with torch.cuda.stream(row.streams[-1]):
                partials = list(partials[:-1]) + [
                    torch.zeros_like(partials[-1])]
        return real_sum(row, partials)

    lm.tp_apply_block, tp.row_sum = block, row_sum
    try:
        yield
    finally:
        lm.tp_apply_block, tp.row_sum = real_block, real_sum


def _tp_forced(params, cfg, rt, prompt, tokens, caches=False):
    """Prefill and `tokens.shape[1] - 1` decode steps fed `tokens` on `rt`
    (None: unsharded): ([the logits of each step], and with `caches` the
    caches after prefill and after the last step, assembled whole)."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.serve.step import build_decode_step, build_prefill_step

    prefill, decode = build_prefill_step(cfg, rt), build_decode_step(cfg, rt)
    whole = (lambda c: c) if rt is None else tp.gather_caches
    last, cache, pos = prefill(params, prompt)
    logits, kept = [last], []
    if caches:
        kept.append(whole(cache))
    for t in range(tokens.shape[1] - 1):
        last, cache, pos = decode(params, tokens[:, t:t + 1], cache, pos)
        logits.append(last)
    if caches:
        kept.append(whole(cache))
    torch.cuda.synchronize()
    return logits, kept


def _tp_timed(fn):
    """(fn(), wall s to a synchronize, peak bytes allocated, bytes
    allocated before)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, torch.cuda.max_memory_allocated(),
            base)


def _tp_idle(params, cfg, rt, prompt) -> dict:
    """A prefill and one decode step under the profiler (device only):
    wall, busy (the union over streams) and idle share."""
    from repro_torch.serve.step import build_decode_step, build_prefill_step

    prefill, decode = build_prefill_step(cfg, rt), build_decode_step(cfg, rt)

    def run():
        last, cache, pos = prefill(params, prompt)
        decode(params, torch.argmax(last, -1)[:, None], cache, pos)

    wall, busy, n = _profile_idle(run, host=False)
    return {"profiled_wall_s": wall, "device_busy_s": busy,
            "idle_share": 1 - busy / wall, "device_activities": n}


def _tp_tokens_gate(toks, ref_toks, ref_logits, delta, v) -> dict:
    """Greedy tokens equal to the unsharded run's up to the first step at
    which its top-2 margin is below 2 x `delta` (the largest |logit
    difference| seen); returns the counts."""
    compared, stops = 0, []
    for b in range(ref_toks.shape[0]):
        for t in range(ref_toks.shape[1]):
            top2 = torch.topk(ref_logits[t][b, :v].float(), 2).values
            margin = float(top2[0] - top2[1])
            if margin < 2 * delta:
                stops.append({"sequence": b, "step": t, "margin": margin})
                break
            assert int(toks[b, t]) == int(ref_toks[b, t]), (b, t, margin)
            compared += 1
    return {"compared": compared, "stops": stops}


@contextmanager
def _plain_versions(swaps):
    """Each (module, attribute, plain function) of `swaps` in place of the
    kernel wrapper for the `with` block."""
    real = [getattr(mod, attr) for mod, attr, _ in swaps]
    for mod, attr, plain in swaps:
        setattr(mod, attr, plain)
    try:
        yield
    finally:
        for (mod, attr, _), fn in zip(swaps, real):
            setattr(mod, attr, fn)


def _tp_f32(tag, cfg, prompt, tokens, plains, n_layers, limit) -> dict:
    """26 (a) / (b), float32: `cfg` at full width with `n_layers` layers
    in float32 on the card, prefill and TP_F32_STEPS decode steps fed
    `tokens`, on TP_CONTROL_MESH against unsharded: logits within `limit`
    (relative L2), the control beyond it, the floor (unsharded with
    `plains` in place of the kernels) printed beside them. The whole
    params go once the layout is cut (rwkv6-7b's are 30 GB in float32)."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models.init import init_params

    cfg32 = cfg.with_(n_layers=n_layers, dtype="float32",
                      param_dtype="float32")
    params = init_params(torch.Generator().manual_seed(1), cfg32,
                         device=prompt.device)
    toks = tokens[:, :TP_F32_STEPS + 1]
    ref, _ = _tp_forced(params, cfg32, None, prompt, toks)
    with _plain_versions(plains):
        plain, _ = _tp_forced(params, cfg32, None, prompt, toks)
    v = cfg.vocab_size
    floor = max(_tp_rel(a, b, v) for a, b in zip(plain, ref))
    rt, _ = _tp_runtime(TP_CONTROL_MESH)
    layout = tp.tp_layout(params, cfg32, rt)
    del params
    torch.cuda.empty_cache()
    got, _ = _tp_forced(layout, cfg32, rt, prompt, toks)
    with _tp_control(cfg32.n_layers):
        ctrl, _ = _tp_forced(layout, cfg32, rt, prompt, toks)
    dist = max(_tp_rel(a, b, v) for a, b in zip(got, ref))
    control = max(_tp_rel(a, b, v) for a, b in zip(ctrl, ref))
    print(f"  tp {tag} float32, {n_layers} layers at full width on "
          f"{TP_CONTROL_MESH}: logits rel L2 to unsharded {dist:.3e} "
          f"(prefill and {TP_F32_STEPS} decode steps), control "
          f"{control:.3e}, floor (unsharded with the plain versions) "
          f"{floor:.3e}, limit {limit:g} (the geometric mean of this "
          f"control and floor is {(control * floor) ** 0.5:.3e})")
    assert dist <= limit < control, (dist, control)
    del layout
    torch.cuda.empty_cache()
    return {"layers": n_layers, "distance": dist, "control": control,
            "floor": floor, "limit": limit}


def _tp_lm(tag, cfg, params, prompt, long, captures, plains, smi,
           reset_counts, read_counts, meshes) -> tuple[dict, dict, dict]:
    """26 (a) / (b): `cfg` served by `greedy_generate` unsharded and on each
    of `meshes` (4 x LM_PROMPT tokens and LM_NEW greedy tokens; with `long`
    also a 1 x LONG_PROMPT prefill), the TP runs counted; then the
    teacher-forced logits (every run fed the unsharded tokens) held to
    TP_LIMITS[tag], (1, 1) bit-equal to unsharded (logits, tokens,
    assembled caches), the greedy tokens to `_tp_tokens_gate`, a control on
    TP_CONTROL_MESH beyond the limit, and the floor (unsharded serving
    with `plains`, the plain versions, in place of the kernels) printed
    beside them. `captures` {kernel: (module, attribute, "greedy" or
    "long", call indices)} keeps those calls' arguments on
    TP_CONTROL_MESH. Returns (report, launches, captured arguments, the
    unsharded run's greedy tokens)."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch import step_analysis
    from repro_torch.params import tree_leaves
    from repro_torch.serve.step import build_prefill_step, greedy_generate

    v, n_layers, limit = cfg.vocab_size, cfg.n_layers, TP_LIMITS[tag]

    def greedy(p, rt):
        return greedy_generate(p, cfg, prompt, max_new=LM_NEW,
                               device=prompt.device, rt=rt)

    def long_prefill(p, rt):
        return build_prefill_step(cfg, rt)(p, long)[0]

    ref_toks, wall, peak, base = _tp_timed(lambda: greedy(params, None))
    ref_logits, ref_caches = _tp_forced(params, cfg, None, prompt, ref_toks,
                                        caches=True)
    ref_long = None if long is None else long_prefill(params, None)
    with _plain_versions(plains):
        plain, _ = _tp_forced(params, cfg, None, prompt, ref_toks)
        plain_long = None if long is None else long_prefill(params, None)
    floor = max([_tp_rel(a, b, v) for a, b in zip(plain, ref_logits)]
                + ([] if long is None else [_tp_rel(plain_long, ref_long,
                                                    v)]))
    del plain, plain_long
    rep = {"unsharded": {"generate_s": wall, "peak_bytes": peak,
                         "resident_bytes_before": base,
                         **_tp_idle(params, cfg, None, prompt)},
           "floor": floor}
    print(f"tp {tag} unsharded [{smi}]: greedy_generate of {LM_NEW} tokens "
          f"after {tuple(prompt.shape)} prompt tokens {wall:.3f} s, peak "
          f"{peak / 2**30:.2f} GiB ({base / 2**30:.2f} resident before); "
          f"prefill + one decode step profiled: idle share "
          f"{rep['unsharded']['idle_share']:.4f}; the floor (the same "
          f"steps with the plain versions in place of the kernels) "
          f"{floor:.3e} rel L2")
    launches, captured, dist, control = {}, {}, {}, None
    for shape in meshes:
        rt, where = _tp_runtime(shape)
        layout = tp.tp_layout(params, cfg, rt)
        m, rows = layout.model_size, len(layout.rows(prompt.shape[0]))
        keeps = {name: {"calls": set(calls), "args": []}
                 for name, (_, _, _, calls) in captures.items()}

        def counted(fn, when):
            restores = [_capture(mod, attr, keeps[name])
                        for name, (mod, attr, w, _) in captures.items()
                        if w == when and shape == TP_CONTROL_MESH]
            try:
                reset_counts()
                out = _tp_timed(fn)
                counts = read_counts()
            finally:
                for restore in restores:
                    restore()
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
            return out, counts

        (toks, wall, peak, base), counts = counted(
            lambda: greedy(layout, rt), "greedy")
        run = {"where": where, "generate_s": wall, "peak_bytes": peak,
               "resident_bytes_before": base,
               "launches": {k: n for k, n in counts.items() if n},
               **_tp_idle(layout, cfg, rt, prompt)}
        assert run["launches"] and all(
            n == n_layers * LM_NEW * m * rows
            for n in run["launches"].values()), (tag, shape, counts)
        logits, caches = _tp_forced(layout, cfg, rt, prompt, ref_toks,
                                    caches=shape == (1, 1))
        steps = [_tp_rel(a, b, v) for a, b in zip(logits, ref_logits)]
        delta = max(float((a[:, :v] - b[:, :v]).abs().max())
                    for a, b in zip(logits, ref_logits))
        run.update({"prefill_rel_l2": steps[0], "decode_rel_l2": steps[1:],
                    "max_abs_logit_diff": delta})
        if long is not None:
            (last, lwall, lpeak, _), lcounts = counted(
                lambda: long_prefill(layout, rt), "long")
            assert lcounts["flash_attn"] == n_layers * m, (shape, lcounts)
            run.update({"long_prefill_s": lwall, "long_peak_bytes": lpeak,
                        "long_rel_l2": _tp_rel(last, ref_long, v),
                        "long_launches": {k: n for k, n in lcounts.items()
                                          if n}})
        if shape == (1, 1):
            same = {"logits": all(torch.equal(a, b) for a, b in zip(
                        logits, ref_logits)),
                    "tokens": torch.equal(toks, ref_toks),
                    "caches": all(torch.equal(a, b) for a, b in zip(
                        tree_leaves(caches), tree_leaves(ref_caches))),
                    "long": long is None or torch.equal(last, ref_long)}
            run["bit_equal"] = same
            print(f"  tp {tag} {shape} bit-equal to unsharded: {same}")
            assert all(same.values()), same
        else:
            run["tokens"] = _tp_tokens_gate(toks, ref_toks, ref_logits,
                                            delta, v)
            dist[shape] = max(steps + ([run["long_rel_l2"]] if long
                                       is not None else []))
        if shape == TP_CONTROL_MESH:
            # what the layout and the prompt's cache hold at each position
            # (phase 28 holds the dry run to it)
            cache = build_prefill_step(cfg, rt)(layout, prompt)[1]
            run["placed_bytes"] = {
                "params": step_analysis.placed_bytes(layout,
                                                     layout.mesh.size),
                "cache": step_analysis.placed_bytes(cache,
                                                    layout.mesh.size)}
            del cache
            with _tp_control(n_layers):
                ctrl, _ = _tp_forced(layout, cfg, rt, prompt, ref_toks)
            control = max(_tp_rel(a, b, v) for a, b in zip(ctrl, ref_logits))
            del ctrl
            for name, keep in keeps.items():
                captured[name] = keep["args"]
        rep[str(shape)] = run
        print(f"  tp {tag} {shape} over {where} [{smi}]: greedy_generate "
              f"{wall:.3f} s (unsharded {rep['unsharded']['generate_s']:.3f}"
              f" s), peak {peak / 2**30:.2f} GiB ({base / 2**30:.2f} "
              f"resident before), idle share {run['idle_share']:.4f} "
              f"(prefill + one decode step profiled; unsharded "
              f"{rep['unsharded']['idle_share']:.4f}); launches "
              f"{run['launches']}; logits rel L2 to unsharded: prefill "
              f"{steps[0]:.3e}, decode max {max(steps[1:]):.3e}"
              + (f", 1 x {LONG_PROMPT} prefill {run['long_rel_l2']:.3e} "
                 f"({run['long_prefill_s']:.3f} s)" if long is not None
                 else "")
              + f"; max |logit diff| {delta:.3e}; tokens "
              f"{run.get('tokens', {}).get('compared', 'all')} compared")
        del layout, logits, caches
        torch.cuda.empty_cache()
    rep.update({"distances": {str(k): d for k, d in dist.items()},
                "control": control, "limit": limit,
                "control_floor_geomean": (control * floor) ** 0.5})
    print(f"  tp {tag}: distances {rep['distances']}, control (the last "
          f"member's partial left out of the last layer's row sums) "
          f"{control:.3e}, floor {floor:.3e}, limit {limit:g} (the "
          f"geometric mean of this control and floor is "
          f"{rep['control_floor_geomean']:.3e})")
    assert all(d <= limit for d in dist.values()), rep["distances"]
    assert control > limit, (control, limit)
    return rep, launches, captured, ref_toks


def _tp_granite(dev, smi, reset_counts, read_counts):
    """26 (a): granite uncut on TP_MESHES; `moe_experts` (prefill and the
    first decode step) and `flash_attn` (the long prompt) captured at the
    last layer's first member on TP_CONTROL_MESH."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.kernels.flash_attn import flash_attention_plain
    from repro_torch.kernels.moe_experts import moe_expert_ffn_plain
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.init import init_params

    cfg = get_config(LM_ARCH).with_(moe_use_kernel=True)
    params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    prompt = torch.from_numpy(batch_for_step(
        cfg, 0, global_batch=LM_BATCH, seq_len=LM_PROMPT,
        seed=17)["tokens"]).to(dev)
    long = torch.from_numpy(batch_for_step(
        cfg, 0, global_batch=1, seq_len=LONG_PROMPT, seed=23)["tokens"]
    ).to(dev)
    m, last = TP_CONTROL_MESH[1], cfg.n_layers - 1
    captures = {
        "moe_experts": (moe_mod, "moe_expert_ffn", "greedy",
                        (last * m, (cfg.n_layers + last) * m)),
        "flash_attn": (layers_mod, "flash_attention", "long", (last * m,))}
    plains = [(moe_mod, "moe_expert_ffn", moe_expert_ffn_plain),
              (layers_mod, "flash_attention", flash_attention_plain)]
    rep, launches, captured, fed = _tp_lm(
        "granite", cfg, params, prompt, long, captures, plains, smi,
        reset_counts, read_counts, TP_MESHES)
    del params
    torch.cuda.empty_cache()
    rep["float32"] = [_tp_f32("granite", cfg, prompt, fed, plains, n, lim)
                      for n, lim in TP_F32_CHECKS["granite"]]
    return rep, launches, captured


def _tp_rwkv(dev, smi, reset_counts, read_counts):
    """26 (b): rwkv6-7b uncut on TP_CONTROL_MESH; `wkv6` captured at the
    last layer's first member (prefill and the first decode step)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.kernels.wkv6 import wkv6_state_plain
    from repro_torch.models import rwkv6 as rwkv_mod
    from repro_torch.models.init import init_params

    cfg = get_config(RWKV_ARCH)
    params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    prompt = torch.from_numpy(batch_for_step(
        cfg, 0, global_batch=LM_BATCH, seq_len=LM_PROMPT,
        seed=17)["tokens"]).to(dev)
    m, last = TP_CONTROL_MESH[1], cfg.n_layers - 1
    captures = {"wkv6": (rwkv_mod, "wkv6_state", "greedy",
                         (last * m, (cfg.n_layers + last) * m))}
    plains = [(rwkv_mod, "wkv6_state", wkv6_state_plain)]
    rep, launches, captured, fed = _tp_lm(
        "rwkv", cfg, params, prompt, None, captures, plains, smi,
        reset_counts, read_counts, (TP_CONTROL_MESH,))
    del params
    torch.cuda.empty_cache()
    rep["float32"] = [_tp_f32("rwkv", cfg, prompt, fed, plains, n, lim)
                      for n, lim in TP_F32_CHECKS["rwkv"]]
    return rep, launches, captured


def _tp_block_runs(cfg, p, inputs, dev):
    """Jamba's layer 0 with params `p` over `inputs` [(x, positions)]
    (prefill, then the decode steps): (the unsharded run, the run on
    TP_CONTROL_MESH through `lm.tp_apply_block`, where its mesh lies, its
    model size); each run returns its outputs."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import lm

    kind, is_moe = cfg.layer_kinds()[0], cfg.layer_is_moe()[0]
    rt, where = _tp_runtime(TP_CONTROL_MESH)
    mesh = rt.lm_mesh
    m = mesh.shape[tp.RULE_AXIS]
    row_pos = [mesh.position({tp.RULE_AXIS: k}) for k in range(m)]
    ps = [tp.member_params(p, k, m, mesh.devices[q])
          for k, q in enumerate(row_pos)]

    @torch.inference_mode()
    def unsharded():
        ys, cache = [], None
        for h, at in inputs:
            y, cache, _ = lm.apply_block(p, h, cfg, kind, is_moe,
                                         positions=at, cache=cache)
            ys.append(y)
        return ys

    @torch.inference_mode()
    def sharded():
        ys, caches = [], None
        for h, at in inputs:
            row = tp.Row(mesh, row_pos, dev)
            out, caches, _ = lm.tp_apply_block(
                row, ps, row.put(h), cfg, kind, is_moe,
                positions=row.put(at), caches=caches)
            ys.append(row.take(out[0]))
            row.close()
        return ys

    return unsharded, sharded, where, m


def _tp_update_rel(ys, ref, inputs, d) -> float:
    """The largest relative L2 distance of a block's update (y - x) from
    the unsharded run's over the calls."""
    return max(_tp_rel(a.float() - h.float(), b.float() - h.float(), d)
               for a, b, (h, _) in zip(ys, ref, inputs))


def _tp_jamba(dev, smi, reset_counts, read_counts):
    """26 (c): Jamba's layer 0 (phase 16's Mamba block with its dense FFN,
    its weights and inputs) on TP_CONTROL_MESH through
    `lm.tp_apply_block`: a prefill of MAMBA_BATCH x MAMBA_PROMPT tokens and
    MAMBA_STEPS decode steps, beside `lm.apply_block`; the update (y - x)
    of every call held to TP_LIMITS["jamba"], a control beyond it, the
    floor (the unsharded block with the plain scan) printed; the same
    block in float32 held to TP_F32_LIMIT; `mamba_scan` captured at the
    first member (prefill and the first step). Returns (report,
    launches, captured arguments)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_scan import \
        mamba_selective_scan_state_plain
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models.init import _Draw, init_block
    from repro_torch.params import params_to

    cfg = get_config(JAMBA_ARCH)
    kind, is_moe = cfg.layer_kinds()[0], cfg.layer_is_moe()[0]
    p = init_block(_Draw(torch.Generator().manual_seed(3), dev), cfg, kind,
                   is_moe, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(8)
    d = cfg.d_model
    x = torch.randn((MAMBA_BATCH, MAMBA_PROMPT, d), device=dev,
                    generator=g).to(torch.bfloat16)
    steps = torch.randn((MAMBA_STEPS, MAMBA_BATCH, 1, d), device=dev,
                        generator=g).to(torch.bfloat16)
    pos = torch.arange(MAMBA_PROMPT, dtype=torch.int32,
                       device=dev).expand(MAMBA_BATCH, MAMBA_PROMPT)
    step_pos = torch.full((MAMBA_BATCH, 1), MAMBA_PROMPT, dtype=torch.int32,
                          device=dev)
    inputs = [(x, pos)] + [(s_, step_pos) for s_ in steps]
    unsharded, sharded, where, m = _tp_block_runs(cfg, p, inputs, dev)
    ref, wall_ref, peak_ref, _ = _tp_timed(unsharded)
    with _plain_versions([(mamba_mod, "mamba_selective_scan_state",
                           mamba_selective_scan_state_plain)]):
        floor = _tp_update_rel(unsharded(), ref, inputs, d)
    keep = {"calls": {0, m}, "args": []}
    restore = _capture(mamba_mod, "mamba_selective_scan_state", keep)
    try:
        reset_counts()
        got, wall, peak, base = _tp_timed(sharded)
        counts = read_counts()
    finally:
        restore()
    with _tp_control(1):
        control = _tp_update_rel(sharded(), ref, inputs, d)
    idle = {}
    for name, run in (("unsharded", unsharded), ("sharded", sharded)):
        wall_p, busy, n_act = _profile_idle(run, host=False)
        idle[name] = {"profiled_wall_s": wall_p, "device_busy_s": busy,
                      "idle_share": 1 - busy / wall_p,
                      "device_activities": n_act}
    assert counts["mamba_scan"] == len(inputs) * m and sum(
        counts.values()) == counts["mamba_scan"], counts
    assert all(torch.isfinite(y.float()).all() for y in got)
    dist = _tp_update_rel(got, ref, inputs, d)
    del ref, got
    # the same block in float32 (its first TP_F32_STEPS decode steps)
    p32 = params_to(p, dtype=torch.float32)
    in32 = [(h.float(), at) for h, at in inputs[:TP_F32_STEPS + 1]]
    un32, sh32, _, _ = _tp_block_runs(cfg, p32, in32, dev)
    ref32 = un32()
    dist32 = _tp_update_rel(sh32(), ref32, in32, d)
    with _tp_control(1):
        control32 = _tp_update_rel(sh32(), ref32, in32, d)
    rep = {"where": where, "unsharded_s": wall_ref,
           "unsharded_peak_bytes": peak_ref, "sharded_s": wall,
           "sharded_peak_bytes": peak, "resident_bytes_before": base,
           "launches": {k: n for k, n in counts.items() if n},
           "idle": idle,
           "distance": dist, "control": control, "floor": floor,
           "limit": TP_LIMITS["jamba"],
           "control_floor_geomean": (control * floor) ** 0.5,
           "float32": {"distance": dist32, "control": control32,
                       "limit": TP_F32_LIMIT}}
    print(f"  tp jamba block over {where} [{smi}]: prefill {MAMBA_BATCH} x "
          f"{MAMBA_PROMPT} + {MAMBA_STEPS} steps {wall:.3f} s (unsharded "
          f"{wall_ref:.3f} s), peak {peak / 2**30:.2f} GiB (unsharded "
          f"{peak_ref / 2**30:.2f}), idle share "
          f"{idle['sharded']['idle_share']:.4f} (unsharded "
          f"{idle['unsharded']['idle_share']:.4f}); launches "
          f"{rep['launches']}; the "
          f"update's rel L2 to unsharded {dist:.3e}, control {control:.3e}, "
          f"floor (the unsharded block with the plain scan) {floor:.3e}, "
          f"limit {TP_LIMITS['jamba']:g} (the geometric mean of this "
          f"control and floor is {rep['control_floor_geomean']:.3e}); "
          f"float32 (prefill and {TP_F32_STEPS} steps) {dist32:.3e}, "
          f"control {control32:.3e}, limit {TP_F32_LIMIT:g}")
    assert dist <= TP_LIMITS["jamba"] < control, rep
    assert dist32 <= TP_F32_LIMIT < control32, rep["float32"]
    del p, p32, ref32
    torch.cuda.empty_cache()
    return rep, rep["launches"], {"mamba_scan": keep["args"]}


def _tp_held(captured, smi) -> dict:
    """26 (d): each kernel held against its plain version on the arguments
    captured at its shard shapes, its plan printed, its time (profiler),
    the plain version's (CUDA events) and the bound."""
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attention_plain,
                                                flash_attention_plan)
    from repro_torch.kernels.mamba_scan import (
        mamba_selective_scan_state, mamba_selective_scan_state_plain)
    from repro_torch.kernels.moe_experts import (moe_expert_ffn,
                                                 moe_expert_ffn_plain,
                                                 moe_expert_ffn_plan)
    from repro_torch.kernels.wkv6 import wkv6_state, wkv6_state_plain

    def timed(name, label, kern, plain, symbols, flops, nbytes, peak):
        # the profiler can keep none of a kernel's launches (ROADMAP Queue
        # 2 D.3): CUDA events around back-to-back calls stand beside it
        ms = kernel_device_ms(kern, symbols)
        events_ms = time_cuda_batch(kern)
        plain_ms = time_cuda_batch(plain)
        bound = max(flops / peak, nbytes / PEAK_BYTES) * 1e3
        print(f"  {name} [{label}] [{smi}]: kernel {_ms(ms)} (profiler), "
              f"{events_ms:.4f} ms (CUDA events over 10 back-to-back "
              f"calls), plain {plain_ms:.4f} ms, bound {bound * 1e3:.3f} us")
        return {"label": label, "ms": ms, "events_ms": events_ms,
                "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "operations"
                if flops / peak >= nbytes / PEAK_BYTES else "bytes"}

    out: dict = {}
    with torch.inference_mode():
        for (args, _), phase in zip(captured["moe_experts"],
                                    ("prefill", "decode step 1")):
            b, e, c, d = args[0].shape
            f = args[2].shape[1]
            label = (f"granite {phase}, last layer, member 0: B {b} E {e} "
                     f"C {c} D {d} F {f}")
            got, want = moe_expert_ffn(*args), moe_expert_ffn_plain(*args)
            excess = _bf16_excess(got, want)
            plan = moe_expert_ffn_plan(*args)
            print(f"  moe_experts [{label}]: max abs err "
                  f"{float((got.float() - want.float()).abs().max()):.3e}, "
                  f"excess over one bf16 ulp + f32 bound {excess:.3e}; "
                  f"{_moe_tiling(plan)}")
            assert torch.isfinite(got.float()).all() and excess <= 0, excess
            out.setdefault("moe_experts", []).append(dict(
                excess=excess, plan=plan, **timed(
                    "moe_experts", label, lambda: moe_expert_ffn(*args),
                    lambda: moe_expert_ffn_plain(*args), MOE_KERNELS,
                    *_moe_work(b, e, c, d, f, 2), PEAK_BF16_FLOPS)))
        (q, k, v), kw = captured["flash_attn"][0]
        b, t, h, d = q.shape
        label = (f"granite 1 x {t} prefill, last layer, member 0: H {h} KV "
                 f"{k.shape[2]} D {d}")
        plan = flash_attention_plan(q, k, v)
        print(f"  flash_attn plan [{label}]: {plan}")
        out["flash_attn"] = [dict(plan=plan, **_held_f64(
            "flash_attn", label, flash_attention(q, k, v, **kw),
            flash_attention_plain(q, k, v, **kw), _flash_f64(q, k, v, **kw),
            FLASH_TOL), **timed(
            "flash_attn", label, lambda: flash_attention(q, k, v, **kw),
            lambda: flash_attention_plain(q, k, v, **kw), FLASH_KERNELS,
            *_flash_work(b, t, t, h, k.shape[2], d, 2, **kw),
            PEAK_BF16_FLOPS))]
        for (args, kw), phase in zip(captured["wkv6"],
                                     ("prefill", "decode step 1")):
            r = args[0]
            b, t, h, kd = r.shape
            label = (f"rwkv6-7b {phase}, last layer, member 0: B {b} T {t} "
                     f"H {h} K {kd}")
            plan = _print_wkv_plan(label, (b, t, h, kd, args[2].shape[-1]),
                                   r.dtype)
            got, want = wkv6_state(*args, **kw), wkv6_state_plain(*args, **kw)
            ref = _wkv6_f64(*args, **kw)
            held = {"o": _held_f64("wkv6", f"{label}: o", got[0], want[0],
                                   ref[0], SCAN_TOL),
                    "state": _held_f64("wkv6", f"{label}: state", got[1],
                                       want[1], ref[1], SCAN_TOL)}
            out.setdefault("wkv6", []).append(dict(
                plan=plan, held=held, **timed(
                    "wkv6", label, lambda: wkv6_state(*args, **kw),
                    lambda: wkv6_state_plain(*args, **kw), "wkv6_kernel",
                    *_wkv_work(b, t, h, kd, args[2].shape[-1], 2,
                               state=args[-1] is not None),
                    PEAK_F32_FLOPS)))
        for (args, kw), phase in zip(captured["mamba_scan"],
                                     ("prefill", "decode step 1")):
            dt = args[0]
            bsz, t, din = dt.shape
            n = args[2].shape[-1]
            label = (f"Jamba block {phase}, member 0: B {bsz} T {t} Din "
                     f"{din} N {n}")
            plan = _print_mamba_plan(label, (bsz, t, din, n), dt.dtype)
            got = mamba_selective_scan_state(*args, **kw)
            want = mamba_selective_scan_state_plain(*args, **kw)
            ref = _mamba_f64(*args, **kw)
            held = {"y": _held_f64("mamba_scan", f"{label}: y", got[0],
                                   want[0], ref[0], SCAN_TOL),
                    "state": _held_f64("mamba_scan", f"{label}: state",
                                       got[1], want[1], ref[1], SCAN_TOL)}
            out.setdefault("mamba_scan", []).append(dict(
                plan=plan, held=held, **timed(
                    "mamba_scan", label,
                    lambda: mamba_selective_scan_state(*args, **kw),
                    lambda: mamba_selective_scan_state_plain(*args, **kw),
                    "mamba_scan_kernel",
                    *_mamba_work(bsz, t, din, n, dt.element_size(),
                                 state=args[-1] is not None),
                    PEAK_F32_FLOPS)))
    torch.cuda.synchronize()
    return out


def _tp_ed_serve(params, cfg, rt, frames, prompt, tokens=None,
                 caches=False):
    """26 (e): the enc-dec steps on `rt` (None: unsharded), synchronized: a
    prefill of `frames` and `prompt` into a cache of the prompt's length
    plus the tokens, then decode steps fed `tokens` [B, n] (n - 1 steps;
    None: ENCDEC_NEW - 1 steps fed its own greedy tokens). Returns
    ([the logits of each step], enc_out, the greedy tokens [B, n], and
    with `caches` the caches after prefill and after the last step,
    assembled whole)."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.serve.step import build_decode_step, build_prefill_step

    prefill, decode = build_prefill_step(cfg, rt), build_decode_step(cfg, rt)
    whole = (lambda c: c) if rt is None else tp.gather_caches
    n = ENCDEC_NEW if tokens is None else tokens.shape[1]
    last, enc_out, cache, pos = prefill(params, frames, prompt,
                                        cache_len=prompt.shape[1] + n)
    logits, toks, kept = [last], [torch.argmax(last, -1)], []
    if caches:
        kept.append(whole(cache))
    for t in range(n - 1):
        fed = toks[-1][:, None] if tokens is None else tokens[:, t:t + 1]
        last, cache, pos = decode(params, fed, enc_out, cache, pos)
        logits.append(last)
        toks.append(torch.argmax(last, -1))
    if caches:
        kept.append(whole(cache))
    torch.cuda.synchronize()
    return logits, enc_out, torch.stack(toks, 1), kept


def _tp_ed_idle(params, cfg, rt, frames, prompt) -> dict:
    """A seamless prefill and one decode step under the profiler (device
    only): wall, busy (the union over streams) and idle share."""
    from repro_torch.serve.step import build_decode_step, build_prefill_step

    prefill, decode = build_prefill_step(cfg, rt), build_decode_step(cfg, rt)

    def run():
        last, enc_out, cache, pos = prefill(params, frames, prompt,
                                            cache_len=prompt.shape[1] + 1)
        decode(params, torch.argmax(last, -1)[:, None], enc_out, cache, pos)

    wall, busy, n = _profile_idle(run, host=False)
    return {"profiled_wall_s": wall, "device_busy_s": busy,
            "idle_share": 1 - busy / wall, "device_activities": n}


def _tp_ed_f32(cfg, frames, prompt, tokens) -> dict:
    """26 (e), float32: seamless at full width with TP_ED_F32_LAYERS
    encoder and decoder layers in float32, prefill and TP_F32_STEPS decode
    steps fed `tokens`, on TP_ED_F32_MESHES against unsharded: logits
    within TP_F32_LIMIT (relative L2), the control on TP_CONTROL_MESH
    beyond it."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models.init import init_params

    n = TP_ED_F32_LAYERS
    cfg32 = cfg.with_(n_layers=n, n_enc_layers=n, dtype="float32",
                      param_dtype="float32")
    params = init_params(torch.Generator().manual_seed(1), cfg32,
                         device=prompt.device)
    toks = tokens[:, :TP_F32_STEPS + 1]
    v, d = cfg.vocab_size, cfg.d_model
    ref, ref_enc, _, _ = _tp_ed_serve(params, cfg32, None, frames, prompt,
                                      toks)
    rep = {"layers": n, "limit": TP_F32_LIMIT}
    for shape in TP_ED_F32_MESHES:
        rt, _ = _tp_runtime(shape)
        layout = tp.tp_layout(params, cfg32, rt)
        got, enc, _, _ = _tp_ed_serve(layout, cfg32, rt, frames, prompt,
                                      toks)
        rep[str(shape)] = {
            "distance": max(_tp_rel(a, b, v) for a, b in zip(got, ref)),
            "enc_out_rel_l2": _tp_rel(enc, ref_enc, d)}
        if shape == TP_CONTROL_MESH:
            with _tp_control(n):
                ctrl, _, _, _ = _tp_ed_serve(layout, cfg32, rt, frames,
                                             prompt, toks)
            rep["control"] = max(_tp_rel(a, b, v)
                                 for a, b in zip(ctrl, ref))
        print(f"  tp seamless float32, {n} + {n} layers at full width on "
              f"{shape}: logits rel L2 to unsharded "
              f"{rep[str(shape)]['distance']:.3e} (prefill and "
              f"{TP_F32_STEPS} decode steps), enc_out "
              f"{rep[str(shape)]['enc_out_rel_l2']:.3e}; limit "
              f"{TP_F32_LIMIT:g}")
        del layout
        torch.cuda.empty_cache()
    print(f"  tp seamless float32 control on {TP_CONTROL_MESH} (the last "
          f"member's partial left out of the last layers' row sums): "
          f"{rep['control']:.3e}, beyond the limit {TP_F32_LIMIT:g}")
    del params
    torch.cuda.empty_cache()
    return rep


def _tp_ed_flash(captured, smi, where=None) -> dict:
    """26 (e) and 27 (d): member 0's last decoder layer `flash_attn` call
    on TP_CONTROL_MESH (the long prompt's prefill; `where` names another
    run), held against `flash_attention_plain` (through float64), its plan
    printed, and timed with CUDA events on a stream of its own beside the
    plain version and SDPA at the same shape (the profiler misses
    launches: ROADMAP Queue 2 D.3), with its bound."""
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attention_plain,
                                                flash_attention_plan)

    (q, k, v), kw = captured[0]
    b, t, h, d = q.shape
    kv = k.shape[2]
    where = where or f"seamless 1 x {t} decoder prefill, last layer, member 0"
    label = f"{where}: B {b} T {t} H {h} KV {kv} D {d}"
    plan = flash_attention_plan(q, k, v)
    print(f"  flash_attn plan [{label}]: {plan}")
    with torch.inference_mode():
        held = _held_f64("flash_attn", label, flash_attention(q, k, v, **kw),
                         flash_attention_plain(q, k, v, **kw),
                         _flash_f64(q, k, v, **kw), FLASH_TOL)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        torch.cuda.synchronize()
        own = torch.cuda.Stream()
        with torch.cuda.stream(own):
            ms = time_cuda_batch(lambda: flash_attention(q, k, v, **kw))
            plain_ms = time_cuda_batch(
                lambda: flash_attention_plain(q, k, v, **kw))
            sdpa_ms = time_cuda_batch(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
        torch.cuda.synchronize()
    flops, nbytes = _flash_work(b, t, t, h, kv, d, 2, **kw)
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    print(f"  flash_attn [{label}] [{smi}]: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA {sdpa_ms:.4f} ms (CUDA events over 10 "
          f"back-to-back calls on a stream of its own), bound "
          f"{bound * 1e3:.3f} us ({bound / ms:.2%} of it)")
    return {"label": label, "plan": plan, **held, "events_ms": ms,
            "plain_ms": plain_ms, "library_ms": sdpa_ms,
            "bound_ms": bound, "bound_by": "operations"
            if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"}


def _tp_seamless(dev, smi, reset_counts, read_counts):
    """26 (e): seamless-m4t-large-v2 uncut in bf16, served by the enc-dec
    steps unsharded and on each of TP_MESHES (ENCDEC_BATCH x
    ENCDEC_FRAMES frames, the 128-token prompt, ENCDEC_NEW greedy tokens),
    the runs counted (no kernel runs at that prompt); then the
    teacher-forced logits (every run fed the unsharded tokens) held to
    TP_LIMITS["seamless"], (1, 1) bit-equal to unsharded (logits, tokens,
    enc_out, assembled caches), the greedy tokens to `_tp_tokens_gate`, a
    control on TP_CONTROL_MESH beyond the limit, the floor (the unsharded
    bf16 logits against float32) printed beside them; on TP_CONTROL_MESH
    also the long prompt's prefill, every member launching `flash_attn`
    in each decoder layer, member 0's last call held and timed
    (`_tp_ed_flash`); and the float32 check (`_tp_ed_f32`). Returns
    (report, launches, the held `flash_attn` call)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import layers as layers_mod
    from repro_torch.models.init import init_params
    from repro_torch.params import params_to, tree_leaves
    from repro_torch.serve.step import build_prefill_step

    cfg = get_config(SEAMLESS_ARCH)
    # the control drops the partials of calls n_layers - 1 (mod n_layers):
    # the last encoder layer and the last decoder layer when both stacks
    # have n_layers layers
    assert cfg.n_enc_layers == cfg.n_layers, cfg
    v, n_layers, limit = cfg.vocab_size, cfg.n_layers, TP_LIMITS["seamless"]
    params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    batch = _batch_on(batch_for_step(cfg, 0, global_batch=ENCDEC_BATCH,
                                     seq_len=ENCDEC_FRAMES), dev)
    frames, prompt = batch["frames"], batch["tokens"]
    long_frames = _batch_on(batch_for_step(
        cfg, 1, global_batch=1, seq_len=ENCDEC_FRAMES), dev)["frames"]
    long_prompt = torch.from_numpy(np.random.default_rng(23).integers(
        0, cfg.vocab_size, (1, ENCDEC_LONG_PROMPT)).astype(np.int32)).to(dev)

    def long_prefill(p, rt):
        return build_prefill_step(cfg, rt)(p, long_frames, long_prompt)[0]

    _tp_ed_serve(params, cfg, None, frames, prompt)              # warm
    (ref_logits, ref_enc, ref_toks, ref_caches), wall, peak, base = \
        _tp_timed(lambda: _tp_ed_serve(params, cfg, None, frames, prompt,
                                       caches=True))
    ref_long, long_s, long_peak, _ = _tp_timed(
        lambda: long_prefill(params, None))
    p32 = params_to(params, dtype=torch.float32)
    f32, _, _, _ = _tp_ed_serve(p32, cfg.with_(
        dtype="float32", param_dtype="float32"), None, frames, prompt,
        ref_toks)
    del p32
    torch.cuda.empty_cache()
    floor = max(_tp_rel(a, b, v) for a, b in zip(ref_logits, f32))
    del f32
    rep = {"unsharded": {"serve_s": wall, "peak_bytes": peak,
                         "resident_bytes_before": base,
                         "long_prefill_s": long_s,
                         "long_peak_bytes": long_peak,
                         **_tp_ed_idle(params, cfg, None, frames, prompt)},
           "floor": floor}
    print(f"tp seamless unsharded [{smi}]: prefill of frames "
          f"{tuple(frames.shape)} and a {prompt.shape[1]}-token prompt and "
          f"{ENCDEC_NEW - 1} greedy decode steps {wall:.3f} s, peak "
          f"{peak / 2**30:.2f} GiB ({base / 2**30:.2f} resident before); "
          f"prefill + one decode step profiled: idle share "
          f"{rep['unsharded']['idle_share']:.4f}; 1 x {ENCDEC_LONG_PROMPT} "
          f"prefill {long_s:.3f} s; the floor (these bf16 logits against "
          f"a float32 run of the same params) {floor:.3e} rel L2")
    launches, dist, control, flash = {}, {}, None, None
    for shape in TP_MESHES:
        rt, where = _tp_runtime(shape)
        layout = tp.tp_layout(params, cfg, rt)
        m = layout.model_size
        reset_counts()
        (_, _, toks, _), wall, peak, base = _tp_timed(
            lambda: _tp_ed_serve(layout, cfg, rt, frames, prompt))
        counts = read_counts()
        assert not any(counts.values()), (shape, counts)
        run = {"where": where, "serve_s": wall, "peak_bytes": peak,
               "resident_bytes_before": base,
               **_tp_ed_idle(layout, cfg, rt, frames, prompt)}
        logits, enc_out, _, caches = _tp_ed_serve(
            layout, cfg, rt, frames, prompt, ref_toks,
            caches=shape == (1, 1))
        steps = [_tp_rel(a, b, v) for a, b in zip(logits, ref_logits)]
        delta = max(float((a[:, :v] - b[:, :v]).abs().max())
                    for a, b in zip(logits, ref_logits))
        run.update({"prefill_rel_l2": steps[0], "decode_rel_l2": steps[1:],
                    "enc_out_rel_l2": _tp_rel(enc_out, ref_enc,
                                              cfg.d_model),
                    "max_abs_logit_diff": delta})
        if shape == (1, 1):
            same = {"logits": all(torch.equal(a, b) for a, b in zip(
                        logits, ref_logits)),
                    "tokens": torch.equal(toks, ref_toks),
                    "enc_out": torch.equal(enc_out, ref_enc),
                    "caches": all(torch.equal(a, b) for a, b in zip(
                        tree_leaves(caches), tree_leaves(ref_caches)))}
            run["bit_equal"] = same
            print(f"  tp seamless {shape} bit-equal to unsharded: {same}")
            assert all(same.values()), same
        else:
            run["tokens"] = _tp_tokens_gate(toks, ref_toks, ref_logits,
                                            delta, v)
            dist[str(shape)] = max(steps)
        if shape == TP_CONTROL_MESH:
            with _tp_control(n_layers):
                ctrl, _, _, _ = _tp_ed_serve(layout, cfg, rt, frames,
                                             prompt, ref_toks)
            control = max(_tp_rel(a, b, v) for a, b in zip(ctrl, ref_logits))
            del ctrl
            keep = {"calls": {(n_layers - 1) * m}, "args": []}
            restore = _capture(layers_mod, "flash_attention", keep)
            try:
                reset_counts()
                last, lwall, lpeak, _ = _tp_timed(
                    lambda: long_prefill(layout, rt))
                lcounts = read_counts()
            finally:
                restore()
            assert lcounts["flash_attn"] == n_layers * m and sum(
                lcounts.values()) == lcounts["flash_attn"], lcounts
            for name, n in lcounts.items():
                launches[name] = launches.get(name, 0) + n
            run.update({"long_prefill_s": lwall, "long_peak_bytes": lpeak,
                        "long_rel_l2": _tp_rel(last, ref_long, v),
                        "long_launches": {k: n for k, n in lcounts.items()
                                          if n}})
            dist[f"{shape} long"] = run["long_rel_l2"]
            flash = keep["args"]
        rep[str(shape)] = run
        print(f"  tp seamless {shape} over {where} [{smi}]: serving "
              f"{wall:.3f} s (unsharded {rep['unsharded']['serve_s']:.3f} "
              f"s), peak {peak / 2**30:.2f} GiB ({base / 2**30:.2f} "
              f"resident before), idle share {run['idle_share']:.4f} "
              f"(prefill + one decode step profiled; unsharded "
              f"{rep['unsharded']['idle_share']:.4f}); logits rel L2 to "
              f"unsharded: prefill {steps[0]:.3e}, decode max "
              f"{max(steps[1:]):.3e}; enc_out {run['enc_out_rel_l2']:.3e}; "
              f"max |logit diff| {delta:.3e}; tokens "
              f"{run.get('tokens', {}).get('compared', 'all')} compared"
              + (f"; 1 x {ENCDEC_LONG_PROMPT} prefill "
                 f"{run['long_prefill_s']:.3f} s (unsharded {long_s:.3f} "
                 f"s), rel L2 {run['long_rel_l2']:.3e}, launches "
                 f"{run['long_launches']}" if "long_rel_l2" in run else ""))
        if shape != (1, 1):
            print(f"  tp seamless {shape} gate: {max(steps):.3e}"
                  + (f" (long prompt {run['long_rel_l2']:.3e})"
                     if "long_rel_l2" in run else "")
                  + f" against TP_LIMITS['seamless'] {limit:g}")
        del layout, logits, caches
        torch.cuda.empty_cache()
    rep.update({"distances": dist, "control": control, "limit": limit,
                "control_floor_geomean": (control * floor) ** 0.5})
    print(f"  tp seamless control on {TP_CONTROL_MESH} (the last member's "
          f"partial left out of the last encoder and decoder layers' row "
          f"sums): {control:.3e} against TP_LIMITS['seamless'] {limit:g}; "
          f"floor {floor:.3e}; the geometric mean of this control and "
          f"floor is {rep['control_floor_geomean']:.3e}")
    rep["float32"] = _tp_ed_f32(cfg, frames, prompt, ref_toks)
    del params
    torch.cuda.empty_cache()
    rep["flash_attn"] = _tp_ed_flash(flash, smi)
    del flash
    assert all(d <= limit for d in dist.values()), dist
    assert control > limit, (control, limit)
    f32 = rep["float32"]
    assert all(f32[str(s)]["distance"] <= TP_F32_LIMIT
               for s in TP_ED_F32_MESHES) and f32["control"] > TP_F32_LIMIT, \
        f32
    return rep, launches, rep["flash_attn"]


def tp_phase(dev, smi, reset_counts, read_counts) -> tuple[dict, dict]:
    """Phase 26: tensor-parallel serving, (a)-(e) above; each part prints
    its seconds. Returns (report, the kernel launches of the TP runs)."""
    rep, clock, launches, captured = {"card": smi}, PhaseClock(), {}, {}
    for key, part, title in (
            ("granite", _tp_granite, "26 (a) granite tensor-parallel"),
            ("rwkv", _tp_rwkv, "26 (b) rwkv6-7b tensor-parallel"),
            ("jamba", _tp_jamba, "26 (c) Jamba's Mamba block "
             "tensor-parallel")):
        rep[key], counts, kept = part(dev, smi, reset_counts, read_counts)
        captured.update(kept)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        clock(title)
    rep["held_at_shard_shapes"] = _tp_held(captured, smi)
    del captured
    torch.cuda.empty_cache()
    clock("26 (d) the kernels at their shard shapes")
    rep["seamless"], counts, flash = _tp_seamless(dev, smi, reset_counts,
                                                  read_counts)
    rep["held_at_shard_shapes"]["flash_attn"].append(flash)
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    clock("26 (e) seamless-m4t-large-v2 tensor-parallel")
    rep["launches"], rep["seconds"] = launches, clock.seconds
    return rep, {k: n for k, n in launches.items() if n}


# ------------------------------------ phase 27: tensor-parallel training


def _tpt_grads(params, cfg, batch, rt):
    """(loss, gradient leaves) of `lm.lm_loss` (`encdec.encdec_loss` for
    an enc-dec `cfg`) with remat, synchronized:
    unsharded `value_and_grad` (`rt` None), else the mesh train step's
    (`train.step._mesh_value_and_grad`: the batch split over the
    replicas, each replica's loss on its model row)."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.params import tree_leaves
    from repro_torch.train.step import _mesh_value_and_grad, value_and_grad

    if rt is None:
        loss, g = value_and_grad(params, cfg, batch)
    else:
        mesh = rt.lm_mesh
        loss, g = _mesh_value_and_grad(params, cfg, batch, mesh,
                                       rt.batch_axes,
                                       tp.train_row_size(cfg, mesh)[0])
    torch.cuda.synchronize()
    return loss, tree_leaves(g)


def _sq_dist(a: list, b: list, chunk: int = 1 << 26) -> tuple[float, float]:
    """(sum of squared differences, sum of squares of `b`) over leaf
    lists, `chunk` elements at a time in float32 (the bf16 leaves of
    granite's gradient are up to 4 GB), summed on `a`'s device in float64
    and read once; `b` may lie on the host."""
    num = den = torch.zeros((), dtype=torch.float64, device=a[0].device)
    for x, y in zip(a, b):
        x, y = x.reshape(-1), y.reshape(-1)
        for i in range(0, x.numel(), chunk):
            xs = x[i:i + chunk].float()
            ys = y[i:i + chunk].to(x.device, torch.float32)
            num = num + torch.sum(torch.square(xs - ys), dtype=torch.float64)
            den = den + torch.sum(torch.square(ys), dtype=torch.float64)
    return float(num), float(den)


def _tpt_dist(run, ref) -> dict:
    """TPT_LIMITS' keys of a (loss, grads) run against `ref`: the loss's
    relative error, the whole gradient tree's relative L2."""
    num, den = _sq_dist(run[1], ref[1])
    return {"loss": abs(float(run[0]) - float(ref[0])) / abs(float(ref[0])),
            "grads": (num / den) ** 0.5}


@contextmanager
def _tpt_control(n_groups: int):
    """The control of phase 27: every `tp_apply_block` call of the last
    layer group (told by its param views' offset into the group stack,
    so a remat recompute drops as the forward did) leaves its row's last
    member's partial out of its row sums. The configs here have groups
    of one layer."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import lm

    real_block, real_sum = lm.tp_apply_block, tp.row_sum
    state = {"drop": False, "dropped": 0}

    def block(row, ps, *args, **kw):
        scale = ps[0]["ln1"]["scale"]
        state["drop"] = (scale.storage_offset() // scale.numel()
                         == n_groups - 1)
        state["dropped"] += state["drop"]
        try:
            return real_block(row, ps, *args, **kw)
        finally:
            state["drop"] = False

    def row_sum(row, partials):
        if state["drop"] and row.size > 1:
            with torch.cuda.stream(row.streams[-1]):
                partials = list(partials[:-1]) + [
                    torch.zeros_like(partials[-1])]
        return real_sum(row, partials)

    lm.tp_apply_block, tp.row_sum = block, row_sum
    try:
        yield state
    finally:
        lm.tp_apply_block, tp.row_sum = real_block, real_sum


def _tpt_classes(by_name: dict) -> dict:
    """Summed device ms of the kernels of TPT_CLASSES' name patterns."""
    return {k: sum(v for name, v in by_name.items() if re.search(pat, name))
            for k, pat in TPT_CLASSES.items()}


def _tpt_bf16(tag, cfg, params, batches, plains, need, capture, smi,
              reset_counts, read_counts):
    """27 (a) and (d): the mesh train step's value-and-grad (`_tpt_grads`)
    of `cfg` in bf16 on TPT_MESHES at `batches[replicas]`, each beside the
    unsharded value_and_grad of the same batch under the device-only
    profiler: (1, 1) bit-equal, the others and the control on
    TPT_CONTROL_MESH measured against TPT_LIMITS[tag] (`_tpt_bf16_gate`
    holds them), the floor (unsharded with
    `plains` in place of the kernels) printed beside them; every kernel
    of `need` launched at least once a layer, member and replica. The
    calls `capture` names ({kernel: (module, attr)}) of member 0's last
    layer on TPT_CONTROL_MESH are kept. Returns (report, launches, {kernel:
    [(args, kwargs)]})."""
    limits = TPT_LIMITS[tag]
    refs, rep, launches, kept = {}, {"card": smi}, {}, {}

    def profiled(rt, b):
        """One value_and_grad on `rt` under the device-only profiler:
        ((loss, grads), its wall, peak memory, idle share and kernels)."""
        by_name, out = {}, []
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        wall, busy, n_act = _profile_idle(
            lambda: out.append(_tpt_grads(params, cfg, batches[b], rt)),
            host=False, by_name=by_name)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TPT_TOP]
        return out[0], {"wall_s": wall,
                        "peak_bytes": torch.cuda.max_memory_allocated(),
                        "resident_bytes_before": base, "device_busy_s": busy,
                        "idle_share": 1 - busy / wall,
                        "device_activities": n_act, "top_device_ms": top,
                        "classes_ms": _tpt_classes(by_name)}

    _tpt_grads(params, cfg, batches[1], None)      # warm-up
    for b in (1, 2):
        refs[b], rep[f"unsharded_b{b}"] = profiled(None, b)
        rep[f"unsharded_b{b}"]["loss"] = float(refs[b][0])
    with _plain_versions(plains):
        floor = _tpt_dist(_tpt_grads(params, cfg, batches[1], None),
                          refs[1])
    rep["floor"] = floor
    u = rep["unsharded_b1"]
    shape1 = {k: tuple(v.shape) for k, v in batches[1].items()}
    print(f"tp train ({tag}) {cfg.name} bf16 [{smi}]: unsharded "
          f"value_and_grad with remat, batch {shape1}: {u['wall_s']:.3f} s "
          f"(wall under the device-only profiler), peak "
          f"{u['peak_bytes'] / 2**30:.2f} GiB "
          f"({u['resident_bytes_before'] / 2**30:.2f} resident before), "
          f"idle share {u['idle_share']:.4f}; 2 replicas' batch: "
          f"{rep['unsharded_b2']['wall_s']:.3f} s; the floor (unsharded "
          f"with the plain versions): loss {floor['loss']:.3e}, grads "
          f"{floor['grads']:.3e} rel L2")
    dist, control = {}, None
    for shape in TPT_MESHES:
        rt, where = _tp_runtime(shape)
        b, m = shape
        keep = {name: {"calls": {(cfg.n_layers - 1) * m}, "args": []}
                for name in capture}
        restores = ([_capture(*capture[name], keep[name])
                     for name in capture]
                    if shape == TPT_CONTROL_MESH else [])
        try:
            reset_counts()
            run, entry = profiled(rt, b)
            counts = read_counts()
        finally:
            for restore in restores:
                restore()
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        ran = {k: n for k, n in counts.items() if n}
        assert all(ran.get(name, 0) >= cfg.n_layers * m * b
                   for name in need), (shape, ran)
        d = _tpt_dist(run, refs[b])
        finite = bool(torch.isfinite(run[0])) and all(
            bool(torch.isfinite(g).all()) for g in run[1])
        entry.update({"where": where, "launches": ran, "distance": d,
                      "finite": finite})
        if shape == (1, 1):
            same = torch.equal(run[0], refs[b][0]) and all(
                torch.equal(x, y) for x, y in zip(run[1], refs[b][1]))
            entry["bit_equal"] = same
            assert same and finite, entry
        else:
            dist[shape] = d
        del run
        torch.cuda.empty_cache()
        if shape == TPT_CONTROL_MESH:
            with _tpt_control(cfg.n_groups) as st:
                ctrl = _tpt_grads(params, cfg, batches[b], rt)
            control = _tpt_dist(ctrl, refs[b])
            entry["control_drops"] = st["dropped"]
            del ctrl
            torch.cuda.empty_cache()
            kept = {name: [(tuple(a.detach() if isinstance(a, torch.Tensor)
                                  else a for a in args), kw)
                           for args, kw in keep[name]["args"]]
                    for name in capture}
            del keep
        rep[str(shape)] = entry
        ub = rep[f"unsharded_b{b}"]
        print(f"  tp train ({tag}) {shape} over {where} [{smi}]: "
              f"value_and_grad {entry['wall_s']:.3f} s (unsharded "
              f"{ub['wall_s']:.3f} s), peak {entry['peak_bytes'] / 2**30:.2f}"
              f" GiB (unsharded {ub['peak_bytes'] / 2**30:.2f}), idle share "
              f"{entry['idle_share']:.4f} (unsharded "
              f"{ub['idle_share']:.4f}), {entry['device_activities']} "
              f"device activities; launches {ran}; loss rel err "
              f"{d['loss']:.3e}, grads rel L2 {d['grads']:.3e}"
              + (f"; bit-equal {entry['bit_equal']}" if shape == (1, 1)
                 else ""))
        print(f"    device ms by class: "
              + ", ".join(f"{k} {v:.1f} (unsharded {ub['classes_ms'][k]:.1f})"
                          for k, v in entry["classes_ms"].items())
              + "; most device time: " + "; ".join(
                  f"{k[:50]} {v:.1f} ms" for k, v in entry["top_device_ms"]))
    rep.update({"distances": {str(k): v for k, v in dist.items()},
                "control": control, "limits": limits,
                "control_floor_geomean": {
                    k: (control[k] * floor[k]) ** 0.5 for k in control}})
    print(f"  tp train ({tag}): control (the last member's partial left out "
          f"of the last layers' row sums) {control}, floor {floor}, limits "
          f"{limits} (the geometric means of this control and floor are "
          f"{rep['control_floor_geomean']})")
    return rep, launches, kept


def _tpt_bf16_gate(rep) -> None:
    """`_tpt_bf16`'s gates, checked once the part has printed all its
    readings: every mesh within the limits, the control beyond them."""
    limits = rep["limits"]
    for d in rep["distances"].values():
        assert all(d[k] <= limits[k] for k in limits), rep
    assert all(rep["control"][k] > limits[k] for k in limits), rep


def _tpt_granite(dev, smi, reset_counts, read_counts):
    """27 (a): granite uncut in bf16 (`_tpt_bf16`) at (replicas) x
    TPT_TOKENS tokens (seed 29); the last layer's `moe_experts` and
    `flash_attn` calls of member 0 on TPT_CONTROL_MESH held against their
    plain versions. Returns (report, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attention_plain)
    from repro_torch.kernels.moe_experts import (moe_expert_ffn,
                                                 moe_expert_ffn_plain)
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.init import init_params

    cfg = get_config(LM_ARCH).with_(moe_use_kernel=True)
    params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    batches = {b: _batch_on(batch_for_step(cfg, 0, global_batch=b,
                                           seq_len=TPT_TOKENS, seed=29),
                            dev) for b in (1, 2)}
    plains = [(moe_mod, "moe_expert_ffn", moe_expert_ffn_plain),
              (layers_mod, "flash_attention", flash_attention_plain)]
    rep, launches, kept = _tpt_bf16(
        "granite", cfg, params, batches, plains, ("moe_experts", "flash_attn"),
        {"moe_experts": (moe_mod, "moe_expert_ffn"),
         "flash_attn": (layers_mod, "flash_attention")},
        smi, reset_counts, read_counts)
    del params, batches
    torch.cuda.empty_cache()
    rep[str(TPT_CONTROL_MESH)]["held"] = _pipe_held(
        {name: {"args": args} for name, args in kept.items()},
        moe_expert_ffn, moe_expert_ffn_plain, flash_attention,
        flash_attention_plain, smi)
    _tpt_bf16_gate(rep)
    return rep, launches


def _tpt_ed_batch(cfg, b: int, dev) -> dict:
    """b x ENCDEC_FRAMES frames of `batch_for_step` (seed 37) and a
    TPT_TOKENS-token decoder sequence drawn as its tokens are (Zipf 1.3):
    its enc-dec batch ties the tokens to frames / 8, too few for
    `flash_attn`."""
    from repro_torch.data.tokens import batch_for_step

    frames = batch_for_step(cfg, 0, global_batch=b, seq_len=ENCDEC_FRAMES,
                            seed=37)["frames"]
    rng = np.random.default_rng(37)
    tokens = (rng.zipf(1.3, (b, TPT_TOKENS)) - 1) % cfg.vocab_size
    return _batch_on({"frames": frames, "tokens": tokens.astype(np.int32)},
                     dev)


def _tpt_seamless(dev, smi, reset_counts, read_counts):
    """27 (d): seamless-m4t-large-v2 uncut in bf16 (`_tpt_bf16`: each
    replica's `encdec_loss` on its model row, the encoder's layers and
    then the decoder's with the members' enc_out) at (replicas) x
    ENCDEC_FRAMES frames and TPT_TOKENS tokens (`_tpt_ed_batch`); member
    0's last decoder `flash_attn` call on TPT_CONTROL_MESH held against
    its plain version and timed beside SDPA (`_tp_ed_flash`); then the
    float32 steps (`_tpt_f32_steps`) of TP_ED_F32_LAYERS + TP_ED_F32_LAYERS
    layers at full width on 2 x ENCDEC_FRAMES frames and TPT_TOKENS
    tokens. Returns (report, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attention_plain
    from repro_torch.models import layers as layers_mod
    from repro_torch.models.init import init_params
    from repro_torch.params import params_to

    cfg = get_config(SEAMLESS_ARCH)
    # the control drops the partials of group n_groups - 1 of each stack:
    # the last encoder layer and the last decoder layer when both stacks
    # have n_layers groups of one layer
    assert cfg.n_enc_layers == cfg.n_layers == cfg.n_groups, cfg
    params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    batches = {b: _tpt_ed_batch(cfg, b, dev) for b in (1, 2)}
    plains = [(layers_mod, "flash_attention", flash_attention_plain)]
    rep, launches, kept = _tpt_bf16(
        "seamless", cfg, params, batches, plains, ("flash_attn",),
        {"flash_attn": (layers_mod, "flash_attention")}, smi, reset_counts,
        read_counts)
    del params, batches
    torch.cuda.empty_cache()
    rep["flash_attn"] = _tp_ed_flash(
        kept["flash_attn"], smi, f"seamless value_and_grad on "
        f"{TPT_CONTROL_MESH}, 1 x {TPT_TOKENS} decoder tokens, last decoder "
        f"layer, member 0")
    del kept
    n = TP_ED_F32_LAYERS
    cfg32 = cfg.with_(n_layers=n, n_enc_layers=n, dtype="float32",
                      param_dtype="float32")
    params = params_to(init_params(torch.Generator().manual_seed(1), cfg32,
                                   device=dev), "cpu")
    rep["float32"], counts, _ = _tpt_f32_steps(
        cfg32, params, _tpt_ed_batch(cfg32, 2, dev), plains, None,
        reset_counts, read_counts)
    for name, k in counts.items():
        launches[name] = launches.get(name, 0) + k
    out = rep["float32"]
    print(f"tp train (d) {cfg.name} float32, {n} + {n} layers at full "
          f"width, [2, {ENCDEC_FRAMES}] frames and [2, {TPT_TOKENS}] tokens, "
          f"one build_train_step step [{smi}]: "
          + "; ".join(f"{k}: loss {v['loss']:.3e}, grad norm "
                      f"{v['grad_norm']:.3e}, update {v['update']:.3e} rel"
                      + (f" ({v['wall_s']:.3f} s, peak "
                         f"{v['peak_bytes'] / 2**30:.2f} GiB, launches "
                         f"{v['launches']})" if "wall_s" in v else "")
                      for k, v in out.items())
          + f" (limit {TPT_F32_LIMIT:g}; (1, 4) and the floor against "
          "unsharded, (2, 2) against the data-parallel (2, 1))")
    del params
    torch.cuda.empty_cache()
    _tpt_bf16_gate(rep)
    keys = ("loss", "grad_norm", "update")
    for k, v in out.items():
        if k.endswith("control"):
            assert all(v[x] > TPT_F32_LIMIT for x in keys), (k, v)
        elif k != "floor":
            assert all(v[x] <= TPT_F32_LIMIT for x in keys), (k, v)
            assert v["launches"].get("flash_attn", 0) > 0, (k, v)
    return rep, launches


def _tpt_on(params, rt, dev):
    """Whole host `params` on `dev` (`rt` None) or laid out by the rules
    on `rt`'s mesh."""
    from repro_torch.params import params_to

    return params_to(params, dev) if rt is None else _placed(params, rt)


def _tpt_step(cfg, placed, batch, rt, control=False, host=False):
    """One `build_train_step` step of `cfg` on `rt` (None: unsharded)
    from `placed` (`_tpt_on`), under the control with `control`: (loss,
    grad norm, [new - old params] leaves, on the host with `host`, the
    step's model row). Nothing of `placed` is updated in place."""
    from repro_torch.distributed import placement
    from repro_torch.params import tree_leaves
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import build_train_step

    opt_state = adamw_init(placed)
    step = build_train_step(cfg, rt)
    if control:
        with _tpt_control(cfg.n_groups):
            new, _, m = step(placed, opt_state, batch)
    else:
        new, _, m = step(placed, opt_state, batch)
    del opt_state
    update = [placement.gather(a) - placement.gather(b)
              for a, b in zip(tree_leaves(new), tree_leaves(placed))]
    if host:
        update = [u.cpu() for u in update]
    torch.cuda.synchronize()
    return float(m["loss"]), float(m["grad_norm"]), update, step.model_row


def _tpt_f32(dev, smi, reset_counts, read_counts):
    """27 (b): float32 at full width, one `build_train_step` step of
    granite (4 layers), rwkv6-7b (4 layers) and Jamba's layer 0 (its
    Mamba block and dense FFN, one layer, its 65536-id vocabulary; the
    whole params and the reference's update wait on the host, so that one
    card holds the mesh step's copies): (2, 2) against the data-parallel
    (2, 1), (1, 4)
    against unsharded and the control, the floor (the unsharded step with
    the plain versions in place of the kernels) beside them; rwkv6-7b's
    value_and_grad in float64 too (`_tpt_f64`); `wkv6` and `mamba_scan`
    captured on (1, 4) and held against their plain versions. Every
    reading is printed before the gates. Returns (report, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.kernels.flash_attn import flash_attention_plain
    from repro_torch.kernels.mamba_scan import \
        mamba_selective_scan_state_plain
    from repro_torch.kernels.moe_experts import moe_expert_ffn_plain
    from repro_torch.kernels.wkv6 import wkv6_state_plain
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import rwkv6 as rwkv_mod
    from repro_torch.models.init import init_params
    from repro_torch.params import params_to

    plains = {"granite": [(moe_mod, "moe_expert_ffn", moe_expert_ffn_plain),
                          (layers_mod, "flash_attention",
                           flash_attention_plain)],
              "rwkv": [(rwkv_mod, "wkv6_state", wkv6_state_plain)],
              "jamba": [(mamba_mod, "mamba_selective_scan_state",
                         mamba_selective_scan_state_plain)]}
    need = {"granite": ("moe_experts", "flash_attn"), "rwkv": ("wkv6",),
            "jamba": ("mamba_scan",)}
    rep, launches, held = {"card": smi}, {}, {}
    for tag, arch, layers, b, t in TPT_F32:
        cfg = get_config(arch).with_(n_layers=layers, dtype="float32",
                                     param_dtype="float32")
        if tag == "jamba":
            cfg = cfg.with_(layer_pattern=("mamba",), moe_period=0)
        if tag == "granite":
            cfg = cfg.with_(moe_use_kernel=True)
        batch = batch_for_step(cfg, 0, global_batch=b, seq_len=t, seed=31)
        capture = {"rwkv": (rwkv_mod, "wkv6_state"),
                   "jamba": (mamba_mod, "mamba_selective_scan_state")}.get(tag)
        params = params_to(init_params(torch.Generator().manual_seed(1), cfg,
                                       device=dev), "cpu")
        out, counts, args = _tpt_f32_steps(cfg, params, batch, plains[tag],
                                           capture, reset_counts, read_counts)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        if args is not None:
            held[tag] = args
        rep[tag] = out
        print(f"tp train (b) {arch} float32, {layers} layer(s) at full width"
              f", [{b}, {t}] tokens, one build_train_step step [{smi}]: "
              + "; ".join(f"{k}: loss {v['loss']:.3e}, grad norm "
                          f"{v['grad_norm']:.3e}, update {v['update']:.3e} "
                          f"rel" + (f" ({v['wall_s']:.3f} s, peak "
                                    f"{v['peak_bytes'] / 2**30:.2f} GiB, "
                                    f"launches {v['launches']})"
                                    if "wall_s" in v else "")
                          for k, v in out.items())
              + f" (limits {TPT_F32_LIMITS[tag]}; (1, 4) and the floor "
              "against unsharded, (2, 2) against the data-parallel (2, 1))")
        if tag == "rwkv":
            rep["rwkv_float64"] = _tpt_f64(cfg, params, batch, dev, smi)
        del params
        torch.cuda.empty_cache()
    rep["held"] = _tpt_held(held, smi)
    keys = ("loss", "grad_norm", "update")
    for tag, *_ in TPT_F32:
        lim = TPT_F32_LIMITS[tag]
        for k, v in rep[tag].items():
            if k.endswith("control"):
                assert all(v[x] > lim[x] for x in keys), (tag, v, lim)
            elif k != "floor":
                assert all(v[x] <= lim[x] for x in keys), (tag, k, v, lim)
                assert all(v["launches"].get(name, 0) > 0
                           for name in need[tag]), (tag, k, v)
    f64 = rep["rwkv_float64"]
    assert f64["distance"]["grads"] <= TPT_F32_LIMIT < \
        f64["control"]["grads"], f64
    return rep, launches


def _tpt_step_dist(run, ref) -> dict:
    """TPT_F32_LIMITS' keys of a `_tpt_step` run against `ref`: the loss's
    and the grad norm's relative errors, the update's relative L2."""
    num, den = _sq_dist(run[2], ref[2])
    return {"loss": abs(run[0] - ref[0]) / abs(ref[0]),
            "grad_norm": abs(run[1] - ref[1]) / abs(ref[1]),
            "update": (num / den) ** 0.5}


def _tpt_f32_steps(cfg, params, batch, plains, capture, reset_counts,
                   read_counts):
    """27 (b) and (d): one float32 `build_train_step` step of `cfg` from
    host `params` on (1, 4) against unsharded and under the control, and
    on (2, 2) against the data-parallel (2, 1); the floor (the unsharded
    step with `plains` in place of the kernels) beside them. The reference
    update waits on the host. `capture` ((module, attr) or None) keeps
    member 0's call of the last layer on (1, 4). Returns ({run: distances,
    wall, peak, launches}, the launches of the sound meshes, the captured
    (args, kwargs) or None)."""
    dev = torch.device("cuda")
    n_layers = cfg.n_layers
    launches, held = {}, None
    ref = _tpt_step(cfg, _tpt_on(params, None, dev), batch, None, host=True)
    with _plain_versions(plains):
        out = {"floor": _tpt_step_dist(_tpt_step(
            cfg, _tpt_on(params, None, dev), batch, None), ref)}
    torch.cuda.empty_cache()
    for shape, control in (((1, 4), False), ((1, 4), True),
                           ((2, 1), False), ((2, 2), False)):
        if shape == (2, 1):
            del ref
            rt = _tp_runtime(shape)[0]
            ref = _tpt_step(cfg, _tpt_on(params, rt, dev), batch, rt,
                            host=True)
            torch.cuda.empty_cache()
            continue
        rt, where = _tp_runtime(shape)
        placed = _tpt_on(params, rt, dev)
        keep = {"calls": {(n_layers - 1) * 4}, "args": []}
        restore = (_capture(*capture, keep)
                   if capture and shape == (1, 4) and not control
                   else (lambda: None))
        try:
            reset_counts()
            run, wall, peak, _ = _tp_timed(
                lambda: _tpt_step(cfg, placed, batch, rt, control))
            counts = read_counts()
        finally:
            restore()
        assert run[3] == shape[1], (cfg.name, shape, run[3])
        key = f"{shape}" + (" control" if control else "")
        out[key] = {"where": where, **_tpt_step_dist(run, ref),
                    "wall_s": wall, "peak_bytes": peak,
                    "launches": {k: n for k, n in counts.items() if n}}
        if not control:
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
        if keep["args"]:
            held = keep["args"][0]
        del run, placed
        torch.cuda.empty_cache()
    del ref
    torch.cuda.empty_cache()
    return out, launches, held


def _tpt_f64(cfg, params, batch, dev, smi) -> dict:
    """27 (b): `cfg` (rwkv6-7b's float32 config) with `params` in float64
    and the plain wkv6 (the kernel is float32) on the first
    TPT_F64_TOKENS tokens of `batch`: value_and_grad of `lm_loss` on (1,
    4) and under the control against unsharded, the whole gradient tree's
    relative L2 (TPT_F32_LIMIT must part them: float32 cannot, its own
    rounding moves these gradients by 1.5e-3)."""
    from repro_torch.kernels.wkv6 import wkv6_state_plain
    from repro_torch.models import rwkv6 as rwkv_mod
    from repro_torch.params import params_to

    cfg64 = cfg.with_(dtype="float64", param_dtype="float64")
    params = params_to(params, dev, torch.float64)
    batch = {k: v[:, :TPT_F64_TOKENS] for k, v in _batch_on(batch,
                                                            dev).items()}
    rt, _ = _tp_runtime((1, 4))
    with _plain_versions([(rwkv_mod, "wkv6_state", wkv6_state_plain)]):
        ref = _tpt_grads(params, cfg64, batch, None)
        got = _tpt_dist(_tpt_grads(params, cfg64, batch, rt), ref)
        with _tpt_control(cfg64.n_groups):
            control = _tpt_dist(_tpt_grads(params, cfg64, batch, rt), ref)
    del params, ref
    torch.cuda.empty_cache()
    print(f"tp train (b) {cfg.name} float64 value_and_grad, {cfg.n_layers} "
          f"layers at full width, {TPT_F64_TOKENS} tokens [{smi}]: (1, 4) "
          f"against unsharded loss "
          f"{got['loss']:.3e}, grads {got['grads']:.3e} rel L2; control "
          f"{control['loss']:.3e}, {control['grads']:.3e} (limit "
          f"{TPT_F32_LIMIT:g} on the grads)")
    return {"distance": got, "control": control, "limit": TPT_F32_LIMIT}


def _tpt_held(held, smi) -> dict:
    """27 (b): `wkv6` (rwkv6-7b's last layer, member 0 of (1, 4)) and
    `mamba_scan` (Jamba's layer 0, member 0) on the captured arguments,
    each kernel against its plain version through a float64 run."""
    from repro_torch.kernels.mamba_scan import (
        mamba_selective_scan_state, mamba_selective_scan_state_plain)
    from repro_torch.kernels.wkv6 import wkv6_state, wkv6_state_plain

    out = {}
    with torch.no_grad():
        args, kw = held["rwkv"]
        args = [a.detach() if isinstance(a, torch.Tensor) else a
                for a in args]
        b, t, h, kd = args[0].shape
        label = f"rwkv6-7b float32, last layer, member 0: B {b} T {t} H {h}"
        got, want = wkv6_state(*args, **kw), wkv6_state_plain(*args, **kw)
        ref = _wkv6_f64(*args, **kw)
        out["wkv6"] = {"shape": [b, t, h, kd], **{
            part: _held_f64("wkv6", f"{label}: {part}", got[i], want[i],
                            ref[i], SCAN_TOL)
            for i, part in enumerate(("o", "state"))}}
        args, kw = held["jamba"]
        args = [a.detach() if isinstance(a, torch.Tensor) else a
                for a in args]
        bsz, t, din = args[0].shape
        label = (f"Jamba layer 0 float32, member 0: B {bsz} T {t} Din {din} "
                 f"N {args[2].shape[-1]}")
        got = mamba_selective_scan_state(*args, **kw)
        want = mamba_selective_scan_state_plain(*args, **kw)
        ref = _mamba_f64(*args, **kw)
        out["mamba_scan"] = {"shape": [bsz, t, din], **{
            part: _held_f64("mamba_scan", f"{label}: {part}", got[i],
                            want[i], ref[i], SCAN_TOL)
            for i, part in enumerate(("y", "state"))}}
    torch.cuda.synchronize()
    return out


def tp_train_phase(dev, smi, reset_counts, read_counts) -> tuple[dict, dict]:
    """Phase 27: tensor-parallel training, (a), (b) and (d) above; each
    part prints its seconds. Returns (report, the kernel launches of the
    tensor-parallel runs)."""
    rep, clock, launches = {"card": smi}, PhaseClock(), {}
    for key, part, title in (
            ("granite", _tpt_granite, "27 (a) granite tensor-parallel "
             "value_and_grad"),
            ("float32", _tpt_f32, "27 (b) float32 train steps"),
            ("seamless", _tpt_seamless, "27 (d) seamless-m4t-large-v2 "
             "tensor-parallel value_and_grad")):
        rep[key], counts = part(dev, smi, reset_counts, read_counts)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        torch.cuda.empty_cache()
        clock(title)
    rep["launches"], rep["seconds"] = launches, clock.seconds
    return rep, {k: n for k, n in launches.items() if n}


# -------------------------------------- phase 28: the dry run on the card


def _meta_mesh(shape):
    """A (data, model) test mesh of logical meta devices."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_test_mesh

    with sharding.logical_devices(shape[0] * shape[1], "meta"):
        return make_test_mesh(*shape, device="meta")


def _vg_batch(cfg, b: int, device) -> dict:
    """27 (d)'s batch shapes and dtypes (`_tpt_ed_batch`: float32 frames,
    int32 tokens) as empty tensors on `device`."""
    return {"frames": torch.empty((b, ENCDEC_FRAMES, cfg.d_model),
                                  dtype=torch.float32, device=device),
            "tokens": torch.empty((b, TPT_TOKENS), dtype=torch.int32,
                                  device=device)}


def dryrun_predictions() -> dict:
    """Phase 28's predictions, made on the meta device at full width (no
    card needed): the bytes that 24 (a)'s seamless cell places at each
    position of DRYRUN_TRAIN_MESHES (`dryrun.build_cell`: param blocks
    and AdamW state), that 26's granite serving cell places on
    TP_CONTROL_MESH (the `TPLayout` and the `TPCache` at LM_BATCH x
    LM_PROMPT), and 27 (d)'s value-and-grad on DRYRUN_VG_MESHES
    (`step_analysis.analyze`: its peak of live bytes)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch import dryrun, step_analysis
    from repro_torch.models.init import init_params
    from repro_torch.train.step import _mesh_value_and_grad

    t0 = time.perf_counter()
    out = {"seamless_train": {}, "granite_serve": {}, "seamless_vg": {}}
    cfg = get_config(SEAMLESS_ARCH)
    for shape in DRYRUN_TRAIN_MESHES:
        mesh = _meta_mesh(shape)
        _, held, _ = dryrun.build_cell(
            SEAMLESS_ARCH, {"kind": "train", "seq_len": ENCDEC_FRAMES,
                            "global_batch": ENCDEC_TRAIN_BATCH}, mesh)
        out["seamless_train"][str(shape)] = step_analysis.placed_bytes(
            [held["params"], held["opt_state"]], mesh.size)
    granite = get_config(LM_ARCH).with_(moe_use_kernel=True)
    mesh = _meta_mesh(TP_CONTROL_MESH)
    _, held, _ = dryrun.build_cell(
        LM_ARCH, {"kind": "decode", "seq_len": LM_PROMPT,
                  "global_batch": LM_BATCH}, mesh, cfg=granite)
    out["granite_serve"][str(TP_CONTROL_MESH)] = {
        k: step_analysis.placed_bytes(held[k], mesh.size)
        for k in ("params", "cache")}
    del held
    params = init_params(torch.Generator(), cfg, device="meta")
    for shape in DRYRUN_VG_MESHES:
        mesh = _meta_mesh(shape)
        rt = sharding.make_runtime(mesh)
        batch = _vg_batch(cfg, shape[0], "meta")
        got = step_analysis.analyze(lambda: _mesh_value_and_grad(
            params, cfg, batch, mesh, rt.batch_axes,
            tp.train_row_size(cfg, mesh)[0]), mesh.size)
        out["seamless_vg"][str(shape)] = {
            k: got[k] for k in ("peak_bytes", "peak_bytes_by_position",
                                "unattributed_peak_bytes", "flops",
                                "handoff_bytes", "seconds")}
    out["seconds"] = time.perf_counter() - t0
    return out


def _dryrun_predictions_main(path: str) -> int:
    """`python chip_smoke.py --dryrun-predictions PATH`: the predictions
    as JSON at PATH."""
    sys.path.insert(0, str(ROOT / "src"))
    Path(path).write_text(json.dumps(dryrun_predictions()))
    return 0


#: processes started ahead (`_dryrun_ahead`), stopped at exit if still up
_DRYRUN_PROCS: list = []


def _stop_ahead() -> None:
    for proc in _DRYRUN_PROCS:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _dryrun_ahead() -> dict:
    """Start phase 28's two processes: the predictions
    (`--dryrun-predictions`) and the dry-run CLI on DRYRUN_CLI, each
    writing under chiprun_out/."""
    import atexit

    out = ROOT / "chiprun_out" / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    started = {"t0": time.perf_counter(), "out": out}
    started["predict"] = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-predictions",
         str(out / "predictions.json")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    started["cli"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_CLI,
         "--out", str(out / "cli")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if not _DRYRUN_PROCS:
        atexit.register(_stop_ahead)
    _DRYRUN_PROCS.extend((started["predict"], started["cli"]))
    return started


def dryrun_measurements(dev, smi) -> dict:
    """What phases 24 (a), 26 and 27 (d) record for phase 28, measured
    alone (for a caller that runs phase 28 by itself): the placed bytes of
    seamless's params and AdamW state on DRYRUN_TRAIN_MESHES, of granite's
    layout and prompt cache on TP_CONTROL_MESH, and the peak of seamless's
    value-and-grad on DRYRUN_VG_MESHES after an unsharded warm-up."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.kernels import build
    from repro_torch.launch import step_analysis
    from repro_torch.models.init import init_params
    from repro_torch.serve.step import build_prefill_step
    from repro_torch.train.optimizer import adamw_init

    build.build_all()
    cfg = get_config(SEAMLESS_ARCH)
    params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    runs = {}
    for shape in DRYRUN_TRAIN_MESHES:
        rt = _mesh_runtime(shape, "cuda:0")
        placed = _placed(params, rt)
        opt_state = adamw_init(placed, cfg.opt_state_dtype)
        runs["x".join(map(str, shape))] = {"placed_bytes": (
            step_analysis.placed_bytes([placed, opt_state], rt.mesh.size))}
        del placed, opt_state
    seamless_tp = {}
    batch = _tpt_ed_batch(cfg, 1, dev)
    _tpt_grads(params, cfg, batch, None)                 # warm-up
    for shape in DRYRUN_VG_MESHES:
        rt, _ = _tp_runtime(shape)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = _tpt_grads(params, cfg, batch, rt)
        seamless_tp[str(shape)] = {
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "resident_bytes_before": base}
        del out
    del params, batch
    torch.cuda.empty_cache()
    granite = get_config(LM_ARCH).with_(moe_use_kernel=True)
    params = init_params(torch.Generator().manual_seed(0), granite,
                         device=dev)
    prompt = torch.from_numpy(batch_for_step(
        granite, 0, global_batch=LM_BATCH, seq_len=LM_PROMPT,
        seed=17)["tokens"]).to(dev)
    rt, _ = _tp_runtime(TP_CONTROL_MESH)
    layout = tp.tp_layout(params, granite, rt)
    cache = build_prefill_step(granite, rt)(layout, prompt)[1]
    n = layout.mesh.size
    granite_tp = {str(TP_CONTROL_MESH): {"placed_bytes": {
        "params": step_analysis.placed_bytes(layout, n),
        "cache": step_analysis.placed_bytes(cache, n)}}}
    del params, layout, cache
    torch.cuda.empty_cache()
    return {"lm_mesh": {"seamless": {"runs": runs}},
            "tensor_parallel": {"granite": granite_tp},
            "tp_train": {"seamless": seamless_tp}}


def dryrun_phase(dev, smi, report=None, ahead=None) -> dict:
    """Phase 28: the dry run against the card (module docstring).
    `report` holds what phases 24 (a), 26 and 27 (d) recorded (measured
    here by `dryrun_measurements` when None); `ahead` the processes of
    `_dryrun_ahead` (started here when None). Raises on a failed check."""
    if report is None:
        report = dryrun_measurements(dev, smi)
    if ahead is None:
        ahead = _dryrun_ahead()
    out, cli = ahead["out"], ahead["cli"]
    said, _ = ahead["predict"].communicate(timeout=1200)
    assert ahead["predict"].returncode == 0, said[-4000:]
    pred = json.loads((out / "predictions.json").read_text())
    cli_said, _ = cli.communicate(timeout=600)
    waited = time.perf_counter() - ahead["t0"]
    total = torch.cuda.get_device_properties(0).total_memory
    rep = {"card": smi, "total_memory": total,
           "predictions_s": pred["seconds"], "ahead_s": waited}
    print(f"dry run [{smi}]: the card's total_memory {total} bytes; the "
          f"predictions took {pred['seconds']:.1f} s on the host, in a "
          f"process started {waited:.1f} s before this phase read them")
    runs = report["lm_mesh"]["seamless"]["runs"]
    for shape in DRYRUN_TRAIN_MESHES:
        got = runs["x".join(map(str, shape))]["placed_bytes"]
        want = pred["seamless_train"][str(shape)]
        rep[f"seamless_train {shape}"] = {"placed": got, "dry_run": want}
        print(f"  24 (a) seamless on {shape}: params + AdamW bytes per "
              f"position placed {got}, dry run {want}: "
              f"{'equal' if got == want else 'DIFFER'}")
        assert got == want, (shape, got, want)
    got = report["tensor_parallel"]["granite"][str(TP_CONTROL_MESH)][
        "placed_bytes"]
    want = pred["granite_serve"][str(TP_CONTROL_MESH)]
    rep["granite_serve"] = {"placed": got, "dry_run": want}
    print(f"  26 granite on {TP_CONTROL_MESH}: TPLayout bytes per position "
          f"placed {got['params']}, dry run {want['params']}; TPCache "
          f"({LM_BATCH} x {LM_PROMPT}) placed {got['cache']}, dry run "
          f"{want['cache']}: {'equal' if got == want else 'DIFFER'}")
    assert got == want, (got, want)
    lo, hi = DRYRUN_RATIO
    for shape in DRYRUN_VG_MESHES:
        card = report["tp_train"]["seamless"][str(shape)]
        measured = card["peak_bytes"] - card["resident_bytes_before"]
        p = pred["seamless_vg"][str(shape)]
        ratio = measured / p["peak_bytes"]
        rep[f"seamless_vg {shape}"] = dict(p, measured_bytes=measured,
                                           ratio=ratio)
        print(f"  27 (d) seamless value_and_grad on {shape} [{smi}]: card "
              f"peak less resident {measured} bytes "
              f"({measured / 2**30:.3f} GiB), dry run {p['peak_bytes']} "
              f"({p['peak_bytes'] / 2**30:.3f} GiB; per position "
              f"{p['peak_bytes_by_position']}, unattributed "
              f"{p['unattributed_peak_bytes']}; {p['flops']:.4e} matmul "
              f"FLOPs, {p['handoff_bytes']} hand-off bytes; "
              f"{p['seconds']:.1f} s on meta): measured / predicted "
              f"{ratio:.4f} (band {lo}-{hi})")
        assert lo <= ratio <= hi, (shape, measured, p["peak_bytes"])
    name = "__".join(DRYRUN_CLI[1::2])
    rec = json.loads((out / "cli" / f"{name}.json").read_text())
    rep["cli"] = {"returncode": cli.returncode, "record": rec}
    print(f"  CLI `python -m repro_torch.launch.dryrun "
          f"{' '.join(DRYRUN_CLI)}` (256 logical meta devices, full size): "
          f"exit {cli.returncode}; record: n_devices {rec.get('n_devices')},"
          f" mesh {rec.get('mesh_shape')}, params_total "
          f"{rec.get('params_total')}, error {rec.get('error')}")
    assert cli.returncode == 1, cli_said[-4000:]
    assert DRYRUN_CLI_ERROR in rec["error"], rec
    assert rec["n_devices"] == 256 and rec["mesh_shape"] == [16, 16]
    assert rec["arch"] == LM_ARCH and rec["kind"] == "decode"
    assert rec["params_total"] > 0 and rec["skipped"] is False
    return rep


def record(name, worst, ms, ms_source, call_ms, plain_ms, label, flops,
           nbytes, err_bound=None, library_ms=None,
           peak_flops=PEAK_F32_FLOPS, **extra) -> dict:
    """One kernel's entry of the `kernels` line (launches filled in after
    the served paths ran), printed as it is recorded."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    k = {"name": name, "route": "cuda",
         "source": f"src/repro_torch/csrc/{SOURCE.get(name, name)}.cu",
         "replaces": REPLACES[name], "launches": 0, "max_abs_err": worst,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
         "library_ms": library_ms, "ms_source": ms_source,
         "call_ms": call_ms, "timed_case": label, "flops": flops,
         "bytes": nbytes,
         "err_bound": err_bound or f"atol {ATOL[name]:g}", **extra}
    print(f"{name}: max abs err {worst:.3e} ({k['err_bound']}); kernel "
          f"{ms:.4f} ms ({ms_source}), wrapper call {call_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms on [{label}]; bound "
          f"{k['bound_ms'] * 1e3:.3f} us set by {k['bound_by']} "
          f"({flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.4f} MB)")
    return k


def _sparse_plan_report(arrays, params) -> dict:
    """The packed-sparse launch plan at phase 3's main case, the clusters
    the card holds at once for it, and, where
    `tools/sparse_pair_parent_check.py` ran before in this checkout, whether
    every one of its cases was equal to the parent kernel's."""
    from repro_torch.kernels.sparse_pair import (max_clusters,
                                                 sparse_pair_score)

    sparse_pair_score(*arrays, params["gcn"], params["att"]["w"],
                      params["ntn"], params["fcn"])
    plan = sparse_pair_score.last_plan
    clusters = max_clusters(plan)
    tiles = arrays[0].shape[0]
    print(f"sparse_pair: plan at {tiles} tiles {plan.summary()}; the card "
          f"holds {clusters} clusters at once ({tiles} needed for one wave)")
    return {"plan": plan.summary(), "resident_clusters": clusters,
            "bit_identical": _parent_check("sparse_pair")}


def _parent_check(name: str, key: str = "equal"):
    """Where `tools/<name>_parent_check.py` ran before in this checkout,
    whether every one of its cases that records `key` was equal to the
    parent kernel's (None when it did not run)."""
    check = ROOT / "chiprun_out" / f"{name}_parent.json"
    if not check.exists():
        return None
    cases = [c for c in json.loads(check.read_text())["cases"] if key in c]
    print(f"{name}: parent check {sum(c[key] for c in cases)} of "
          f"{len(cases)} cases equal to the parent kernel's ({key})")
    return bool(cases) and all(c[key] for c in cases)


def _fused_launch_time(label, arrays, params) -> dict:
    """Kernel ms (profiler; events around back-to-back calls when it sees
    none), bound and plan of one `fused_pair_score` launch on these
    arrays."""
    from repro_torch.configs.simgnn_aids import CONFIG as CFG
    from repro_torch.kernels.fused_pair import fused_pair_score

    def fn():
        return fused_pair_score(*arrays, params["gcn"], params["att"]["w"],
                                params["ntn"], params["fcn"])

    ms = kernel_device_ms(fn, SYMBOLS["fused_pair"]) or time_cuda_batch(fn)
    flops, nbytes = WORK["fused_pair"](arrays, CFG)
    nbytes += param_bytes(params) + out_bytes("fused_pair", arrays)
    bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    pairs, bucket = arrays[0].shape[:2]
    plan = fused_pair_score.last_plan.summary()
    print(f"  fused_pair [{label}] {pairs} pair(s) at bucket {bucket}: "
          f"{ms:.4f} ms, bound {bound * 1e3:.3f} us ({bound / ms:.2%} of "
          f"it); plan: {plan}")
    return {"case": label, "pairs": pairs, "bucket": bucket, "ms": ms,
            "bound_ms": bound, "plan": plan}


def _packed_launch_time(label, arrays, params) -> dict:
    """Kernel ms (profiler; events around back-to-back calls when it sees
    none), bound and plan of one `packed_pair_score` launch on these
    arrays."""
    from repro_torch.configs.simgnn_aids import CONFIG as CFG
    from repro_torch.kernels.packed_pair import packed_pair_score

    def fn():
        return packed_pair_score(*arrays, params["gcn"], params["att"]["w"],
                                 params["ntn"], params["fcn"])

    ms = kernel_device_ms(fn, SYMBOLS["packed_pair"]) or time_cuda_batch(fn)
    flops, nbytes = WORK["packed_pair"](arrays, CFG)
    nbytes += param_bytes(params) + out_bytes("packed_pair", arrays)
    bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    tiles = arrays[0].shape[0]
    plan = packed_pair_score.last_plan.summary()
    print(f"  packed_pair [{label}] {tiles} tiles: {ms:.4f} ms, bound "
          f"{bound * 1e3:.3f} us ({bound / ms:.2%} of it); plan: {plan}")
    return {"case": label, "tiles": tiles, "ms": ms, "bound_ms": bound,
            "plan": plan}


def _packed_plan_report(aids, deg8, params) -> dict:
    """The packed-dense launch plan at phase 3's AIDS request, the clusters
    the card holds at once for it, the kernel's time and bound on the
    average-degree-8 request, and, where `tools/packed_pair_parent_check.py`
    ran before in this checkout, whether every one of its cases was equal
    to the parent kernel's."""
    from repro_torch.kernels.packed_pair import (max_clusters,
                                                 packed_pair_score)

    deg8_time = _packed_launch_time("average-degree-8 request", deg8, params)
    aids_time = _packed_launch_time("AIDS request", aids, params)
    plan = packed_pair_score.last_plan
    clusters = max_clusters(plan)
    tiles = aids[0].shape[0]
    print(f"packed_pair: plan at {tiles} tiles {plan.summary()}; the card "
          f"holds {clusters} clusters at once ({tiles} needed for one wave)")
    return {"plan": plan.summary(), "resident_clusters": clusters,
            "aids_request": aids_time, "deg8_request": deg8_time,
            "bit_identical": _parent_check("packed_pair")}


def _dense_stream(score, cpu_score, ref_score, stream, reset_counts,
                  read_counts, params) -> tuple[dict, int]:
    """The average-degree-8 stream in requests of BATCH pairs on the auto
    path: each request planned onto packed_dense without degradation, one
    `packed_pair` launch and no other, scores within 1e-6 of the card's
    reference path and the CPU plain path; pairs/s, wall ms, device span
    and host stages as phase 4, and each request's launch timed alone on
    its captured arrays, summed launch by launch. Returns (report,
    launches)."""
    from repro_torch.kernels import ops

    calls, real = [], ops.packed_pair_score

    def recording(*args):
        calls.append(args[:9])
        return real(*args)

    timer = RequestTimer(score.engine)
    walls, outs = [], []
    reset_counts()
    ops.packed_pair_score = recording
    try:
        for i in range(0, len(stream), BATCH):
            batch = stream[i:i + BATCH]
            before = read_counts()
            t0 = time.perf_counter()
            with timer:
                out = score(batch)
            walls.append(time.perf_counter() - t0)
            timer.stages[-1]["wall"] = walls[-1]
            after = read_counts()
            plan = score.last_plan
            assert plan.path == "packed_dense", (plan.path, plan.reason)
            assert plan.degraded_from == () and plan.attempts == 1, plan
            delta = {k: after[k] - before[k] for k in after}
            assert delta["packed_pair"] == 1 and sum(delta.values()) == 1, \
                delta
            assert out.shape == (len(batch),) and np.isfinite(out).all()
            outs.append((batch, out))
    finally:
        ops.packed_pair_score = real
    counts = read_counts()
    requests = len(outs)
    assert counts["packed_pair"] == requests == len(calls), counts
    errs = [(float(np.abs(out - ref_score(b)).max()),
             float(np.abs(out - cpu_score(b)).max())) for b, out in outs]
    worst_ref, worst_cpu = (max(e[i] for e in errs) for i in (0, 1))
    print(f"dense stream: {requests} requests of {BATCH} pairs, launches "
          f"{counts}; plan of the last: {plan.path} ({plan.reason}); worst "
          f"request vs card reference {worst_ref:.3e}, vs CPU plain path "
          f"{worst_cpu:.3e} (bound 1e-06)")
    assert worst_ref <= 1e-6 and worst_cpu <= 1e-6, (worst_ref, worst_cpu)
    steady = timer.stages[1:]
    mean = {k: statistics.fmean(st[k] for st in steady) for k in steady[0]}
    print(f"dense stream: {BATCH / mean['wall']:.1f} pairs/s over requests "
          f"2..{requests}; per request {1e3 * mean['wall']:.3f} ms wall, "
          f"{1e3 * mean['device']:.3f} ms device span of the scoring call "
          f"(idle share {1 - mean['device'] / mean['wall']:.4f}); first "
          f"request {1e3 * walls[0]:.3f} ms")
    other = mean["wall"] - sum(mean[k] for k in RequestTimer.STAGES)
    print("dense stream host stages per request (ms): " + ", ".join(
        f"{k} {1e3 * mean[k]:.3f}" for k in RequestTimer.STAGES) +
        f", other {1e3 * other:.3f}")
    per_launch = [_packed_launch_time(f"dense request {i}", list(args),
                                      params)
                  for i, args in enumerate(calls)]
    loss = sum(t["ms"] - t["bound_ms"] for t in per_launch)
    print(f"dense stream: {len(per_launch)} packed_pair launches, sum of "
          f"launch ms {sum(t['ms'] for t in per_launch):.4f}, sum of (time - "
          f"bound) {loss:.4f} ms")
    return {"requests": requests, "batch": BATCH,
            "per_request_s": timer.stages, "mean_s": mean,
            "err_ref": worst_ref, "err_cpu": worst_cpu,
            "pack_stats": score.last_pack_stats, "per_launch": per_launch,
            "loss_ms": loss}, counts["packed_pair"]


def _small_calls(score, stream, ref_score, reset_counts, read_counts,
                 repeats: int = 5) -> list:
    """Auto requests of 1, 2 and 3 pairs: the bucketed path ("too small"
    to pack) with every launch a `fused_pair` one, scores within 2e-5 of
    the card's reference path; median wall and device span of `repeats`
    warm requests."""
    out = []
    for k in (1, 2, 3):
        pairs = stream[:k]
        score(pairs)                                   # warm
        timer = RequestTimer(score.engine)
        walls = []
        reset_counts()
        for _ in range(repeats):
            t0 = time.perf_counter()
            with timer:
                got = score(pairs)
            walls.append(time.perf_counter() - t0)
        counts = read_counts()
        plan = score.last_plan
        assert plan.path == "bucketed_mega" and "too small" in plan.reason, \
            plan
        assert counts["fused_pair"] >= repeats and sum(counts.values()) == \
            counts["fused_pair"], counts
        err = float(np.abs(got - ref_score(pairs)).max())
        assert err <= ATOL["fused_pair"], (k, err)
        wall = statistics.median(walls)
        dev = statistics.median(st["device"] for st in timer.stages)
        print(f"small call of {k} pair(s): {plan.path} ({plan.reason}); "
              f"launches {counts['fused_pair']} in {repeats} requests; wall "
              f"{1e3 * wall:.3f} ms, device span {1e3 * dev:.4f} ms (median "
              f"of {repeats}); vs card reference {err:.3e} (bound "
              f"{ATOL['fused_pair']:g})")
        out.append({"pairs": k, "path": plan.path, "reason": plan.reason,
                    "launches": counts["fused_pair"], "repeats": repeats,
                    "wall_s": walls, "device_s": [st["device"] for st in
                                                  timer.stages],
                    "err_ref": err})
    return out


def _oversize_request(score, stream, ref_score, reset_counts,
                      read_counts) -> dict:
    """An auto 256-pair request whose last pair holds a 130-node graph:
    `packed_sparse` for the 255 others, one `fused_pair` launch at bucket
    256 for the oversize pair."""
    from repro_torch.data.graphs import edit_graph, random_graph
    from repro_torch.kernels.fused_pair import fused_pair_score

    rng = np.random.default_rng(7)
    big = random_graph(rng, 130)
    pairs = list(stream[:BATCH - 1]) + [(big, edit_graph(rng, big, 3))]
    score(pairs)                                       # warm
    reset_counts()
    t0 = time.perf_counter()
    got = score(pairs)
    wall = time.perf_counter() - t0
    counts = read_counts()
    plan = score.last_plan
    assert plan.path == "packed_sparse" and list(plan.over_idx) == [
        BATCH - 1], plan
    assert counts["fused_pair"] == 1 and counts["sparse_pair"] >= 1 and \
        sum(counts.values()) == counts["fused_pair"] + counts["sparse_pair"], \
        counts
    fp_plan = fused_pair_score.last_plan
    assert dict(fp_plan.layout).get("n") == 256, fp_plan
    want = ref_score(pairs)
    err_fit = float(np.abs(got[:-1] - want[:-1]).max())
    err_over = float(abs(got[-1] - want[-1]))
    assert err_fit <= ATOL["sparse_pair"] and err_over <= ATOL["fused_pair"], \
        (err_fit, err_over)
    print(f"oversize request: {plan.path} for {BATCH - 1} pairs, launches "
          f"{counts}; fused_pair at bucket 256 ({fp_plan.summary()}); wall "
          f"{1e3 * wall:.3f} ms; vs card reference {err_fit:.3e} (packed, "
          f"bound {ATOL['sparse_pair']:g}), {err_over:.3e} (oversize pair, "
          f"bound {ATOL['fused_pair']:g})")
    return {"path": plan.path, "launches": counts, "wall_s": wall,
            "err_fit": err_fit, "err_over": err_over,
            "fused_pair_plan": fp_plan.summary()}


def timings(kern, plain, symbols):
    """(kernel ms, its source, wrapper call ms, plain ms) of two thunks."""
    call_ms = time_cuda(kern)
    plain_ms = time_cuda(plain)
    ms = kernel_device_ms(kern, symbols)
    if ms is None:                  # the profiler saw no device time
        return call_ms, "events around the wrapper call", call_ms, plain_ms
    return ms, "profiler", call_ms, plain_ms


def _embed_work(a, feats, mask, cfg) -> tuple[float, int]:
    """Flops and bytes of one embedding launch: the dense layer-0 product
    on one-hot feats and the GCN stack on each graph's real nodes, the Att
    pooling; A', feats and mask read once, [B, F] written once."""
    n = mask.sum(-1).cpu().numpy()
    n_real, cells = float(n.sum()), float((n ** 2).sum())
    flops = (2 * n_real * cfg.n_node_labels * cfg.gcn_dims[0]
             + _gcn_flops(n_real, cells, cfg)
             + _head_flops(n_real, len(n), 0, cfg))
    nbytes = sum(x.numel() * x.element_size() for x in (a, feats, mask))
    return flops, nbytes + len(n) * cfg.gcn_dims[-1] * 4


def _head_work(b, params) -> tuple[float, int]:
    """Flops and bytes of one head launch on B pairs: the NTN, FCN and
    sigmoid of each pair; h1 and h2 [B, F] and the head's weights read
    once, [B] scores written once."""
    from repro_torch.configs.simgnn_aids import CONFIG as CFG

    nbytes = 2 * b * CFG.gcn_dims[-1] * 4 + b * 4 + param_bytes(
        {"ntn": params["ntn"], "fcn": params["fcn"]})
    return _head_flops(0, 0, b, CFG), nbytes


def _head_launch_time(h1, h2, params) -> dict:
    """Kernel ms (profiler; events around back-to-back calls when it sees
    none), bound and plan of one `simgnn_head` launch on these rows."""
    from repro_torch.kernels.simgnn_head import simgnn_head

    def fn():
        return simgnn_head(h1, h2, params["ntn"], params["fcn"])

    ms = (kernel_device_ms(fn, SYMBOLS["simgnn_head"])
          or time_cuda_batch(fn))
    flops, nbytes = _head_work(h1.shape[0], params)
    bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    return {"B": h1.shape[0], "ms": ms, "bound_ms": bound,
            "plan": simgnn_head.last_plan.summary()}


def _topm_launch_time(qv, corpus, m, block) -> dict:
    """Kernel ms (profiler; events around back-to-back calls when it sees
    none), CUDA-graph ms, bound and plan of one `blocked_topm` launch on
    these inputs."""
    from repro_torch.kernels import retrieval

    def fn():
        return retrieval.blocked_topm(qv, corpus, m, block_cols=block)

    ms = kernel_device_ms(fn, SYMBOLS["topm"]) or time_cuda_batch(fn)
    graph = time_cuda_graph(fn, 20)
    (q, f), n = qv.shape, corpus.shape[0]
    flops, nbytes = _topm_work(q, n, m, f)
    plan = retrieval.blocked_topm.last_plan
    return {"Q": q, "N": n, "M": m, "block": block, "ms": ms,
            "graph_ms": graph,
            "bound_ms": max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3,
            "route": plan.route, "plan": plan.summary()}


def _topm_work(q, n, m, f, k=0, fcn=()) -> tuple[float, int]:
    """Flops and bytes of one top-M scan: per (query, row) a dot of F, or
    K dots, the dq add and the FCN stack; the query operands and the
    corpus read once, [Q, M] scores and indices written once."""
    if k:
        per = 2 * k * f + k + 2 * sum(p["w"].numel() for p in fcn) + sum(
            p["b"].numel() for p in fcn)
        inputs = q * (k * f + k) + n * f
    else:
        per, inputs = 2 * f, q * f + n * f
    return float(q * n * per), 4 * inputs + 8 * q * m


def _gcn_plan(arrays, params) -> dict:
    """The launch plan of `fused_gcn_att` on these arrays (what the
    wrapper launches with), and the CTAs an SM holds for it by the CUDA
    runtime, which must cover what the plan counts on."""
    from repro_torch.kernels.fused_gcn import (device_limits, fused_gcn_plan,
                                               gcn_dims, occupancy)

    graphs, bucket, f0 = arrays[1].shape
    dims = gcn_dims(f0, params["gcn"], params["att"]["w"])
    plan = fused_gcn_plan(graphs, bucket, dims,
                          *device_limits(arrays[0].device.index))
    held = occupancy(plan)
    assert held >= plan.ctas_per_sm, (plan, held)
    return {"summary": plan.summary(), "route": plan.route,
            "grid": plan.grid, "threads": plan.threads,
            "ctas_per_sm": plan.ctas_per_sm, "runtime_ctas_per_sm": held,
            "smem_bytes": plan.smem_bytes, "stages": plan.stages}


def _gcn_launch_time(arrays, params) -> dict:
    """Kernel ms (profiler; events around back-to-back calls when it sees
    none), bound and plan of one `fused_gcn_att` launch on these arrays."""
    from repro_torch.configs.simgnn_aids import CONFIG as CFG
    from repro_torch.kernels.fused_gcn import fused_gcn_att

    def fn():
        return fused_gcn_att(*arrays, params["gcn"], params["att"]["w"])

    ms = kernel_device_ms(fn, ("fused_gcn_kernel",)) or time_cuda_batch(fn)
    flops, nbytes = _embed_work(*arrays, CFG)
    nbytes += param_bytes({"gcn": params["gcn"], "att": params["att"]})
    bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    graphs, bucket = arrays[0].shape[:2]
    plan = _gcn_plan(arrays, params)
    print(f"  fused_gcn launch of {graphs} graphs at bucket {bucket}: "
          f"{ms:.4f} ms, bound {bound * 1e3:.3f} us "
          f"({bound / ms:.2%} of it); plan: {plan['summary']} (the runtime "
          f"holds {plan['runtime_ctas_per_sm']} a SM)")
    return {"graphs": graphs, "bucket": bucket, "ms": ms, "bound_ms": bound,
            "plan": plan}


def search_kernels(params, narrow, corpus, queries, dev) -> dict:
    """Phase 3b: the embedding, head and both top-M kernels against their
    plain versions at the search path's shapes (the corpus's embed
    buckets, an oversize 130-node graph, the narrow config, B = N for the
    head, (Q, N, M) = (64, 8192, 64) for the scans, M = N and NaN rows);
    the embedding's bit-identity across batch companions and bucket width.
    Returns the four kernels' entries."""
    from repro_torch.configs.simgnn_aids import CONFIG as CFG
    from repro_torch.core.batching import bucket_for, pad_graphs
    from repro_torch.core.gcn import normalized_adjacency
    from repro_torch.data.graphs import random_graph
    from repro_torch.kernels import retrieval
    from repro_torch.kernels.fused_gcn import (fused_gcn_att,
                                               fused_gcn_att_plain)
    from repro_torch.kernels.simgnn_head import occupancy as head_occupancy
    from repro_torch.kernels.simgnn_head import (simgnn_head,
                                                 simgnn_head_plain)

    def embed_in(graphs, bucket):
        b = pad_graphs(graphs, CFG.n_node_labels, bucket, device=dev)
        return normalized_adjacency(b.adj, b.mask), b.feats, b.mask

    def gcn_w(p):
        return p["gcn"], p["att"]["w"]

    by_bucket: dict = {}
    for i, g in enumerate(corpus):
        by_bucket.setdefault(bucket_for(g["adj"].shape[0],
                                        allow_oversize=True), []).append(i)
    big = random_graph(np.random.default_rng(7), 130)
    cases = [(f"corpus bucket {b} ({len(ix)} graphs)",
              embed_in([corpus[i] for i in ix], b), params)
             for b, ix in sorted(by_bucket.items())]
    cases += [("oversize 130 nodes (bucket 256)", embed_in([big], 256),
               params),
              ("narrow gcn (16,8,8,4), bucket 32",
               embed_in([corpus[i] for i in by_bucket[32]], 32), narrow)]
    worst, emb = 0.0, torch.empty((len(corpus), CFG.gcn_dims[-1]),
                                  device=dev)
    for label, arrays, prm in cases:
        got = fused_gcn_att(*arrays, *gcn_w(prm))
        want = fused_gcn_att_plain(*arrays, *gcn_w(prm))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"  fused_gcn [{label}]: shape {tuple(got.shape)} max abs err "
              f"{err:.3e}")
        torch.testing.assert_close(got, want, **BODY_TOL)
        worst = max(worst, err)
        if prm is params and label.startswith("corpus"):
            bucket = int(label.split()[2])
            emb[torch.as_tensor(by_bucket[bucket], device=dev)] = got
    # Bit identity: one graph alone, among others, and in a wider bucket.
    g = corpus[by_bucket[32][0]]
    others = [corpus[i] for i in by_bucket[32][1:40]]
    rows = []
    for bucket, batch, at in ((32, [g], 0), (32, others + [g], len(others)),
                              (64, others[:7] + [g], 7),
                              (256, [g, big], 0)):
        rows.append(fused_gcn_att(*embed_in(batch, bucket),
                                  *gcn_w(params))[at])
    identical = all(torch.equal(r, rows[0]) for r in rows)
    print(f"  fused_gcn bit identity across batch companions and buckets "
          f"32/64/256: {identical}")
    assert identical
    main_in = cases[2][1]
    assert cases[2][0].startswith("corpus bucket 32")
    flops, nbytes = _embed_work(*main_in, CFG)
    nbytes += param_bytes({"gcn": params["gcn"], "att": params["att"]})
    out = {"fused_gcn": record(
        "fused_gcn", worst,
        *timings(lambda: fused_gcn_att(*main_in, *gcn_w(params)),
                 lambda: fused_gcn_att_plain(*main_in, *gcn_w(params)),
                 ("fused_gcn_kernel",)),
        cases[2][0], flops, nbytes, err_bound="rtol 1e-05, atol 1e-06",
        batch_bit_identical=identical)}
    # One launch of each corpus bucket (the index's launches) and of one
    # graph alone (an exact query's), timed for the search phase's
    # launch-by-launch sum.
    per_launch = []
    q = queries[0]
    for arrays in [a for label, a, prm in cases
                   if prm is params and label.startswith("corpus")] + [
            embed_in([q], bucket_for(q["adj"].shape[0],
                                     allow_oversize=True))]:
        per_launch.append(_gcn_launch_time(arrays, params))
    out["fused_gcn"]["per_launch"] = per_launch

    # The head at B = N: one query against the whole corpus.
    hq = torch.cat([fused_gcn_att(*embed_in([q], bucket_for(
        q["adj"].shape[0], allow_oversize=True)), *gcn_w(params))
        for q in queries])
    n, f = emb.shape
    h1 = hq[0].expand(n, f).contiguous()
    head_w = (params["ntn"], params["fcn"])
    rng = np.random.default_rng(11)
    nw = [torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))
          .to(dev) for _ in range(2)]
    worst, plans = 0.0, {}
    for label, (a, b), w in ((f"B = N = {n}", (h1, emb), head_w),
                             (f"narrow (F = 4), B = {n}", nw,
                              (narrow["ntn"], narrow["fcn"]))):
        err = float((simgnn_head(a, b, *w)
                     - simgnn_head_plain(a, b, *w)).abs().max())
        plans[label] = simgnn_head.last_plan
        print(f"  simgnn_head [{label}]: max abs err {err:.3e}; plan: "
              f"{plans[label].summary()}")
        assert err <= ATOL["simgnn_head"], (label, err)
        worst = max(worst, err)
    served = plans[f"B = N = {n}"]
    assert served.route == "tiled", served
    assert plans[f"narrow (F = 4), B = {n}"].route == "warp"
    held = head_occupancy(served)
    assert held >= served.ctas_per_sm, (served, held)
    print(f"  simgnn_head plan at B = N: {served.summary()} (the runtime "
          f"holds {held} a SM)")
    flops, nbytes = _head_work(n, params)
    out["simgnn_head"] = record(
        "simgnn_head", worst,
        *timings(lambda: simgnn_head(h1, emb, *head_w),
                 lambda: simgnn_head_plain(h1, emb, *head_w),
                 SYMBOLS["simgnn_head"]),
        f"B = N = {n}", flops, nbytes, plan=served.summary(),
        plan_route=served.route, runtime_ctas_per_sm=held,
        bit_identical=_parent_check("simgnn_head"))

    # Both top-M scans: the served shape, M = N, NaN rows.
    uq, dq = (torch.from_numpy(x).to(dev) for x in
              retrieval.collapse_query_ntn(params["ntn"], hq.cpu().numpy()))
    fcn = params["fcn"]
    small = emb[:300].clone()
    nan_rows = small.clone()
    nan_rows[[5, 77, 200]] = float("nan")
    scans = {
        "topm": (lambda c, m, blk: retrieval.blocked_topm(
            hq, c, m, block_cols=blk),
            lambda c, m: retrieval.blocked_topm_plain(hq, c, m),
            SYMBOLS["topm"], {}),
        "topm_ntn": (lambda c, m, blk: retrieval.blocked_topm_ntn(
            uq, dq, c, fcn, m, block_cols=blk),
            lambda c, m: retrieval.blocked_topm_ntn_plain(uq, dq, c, fcn, m),
            SYMBOLS["topm_ntn"], {"k": dq.shape[1], "fcn": fcn}),
    }
    for name, (kern, plain, symbols, work) in scans.items():
        worst = 0.0
        for label, c, m, blk in (
                (f"(Q, N, M) = ({SEARCH_QUERIES}, {n}, {PREFILTER_M})", emb,
                 PREFILTER_M, BLOCK_COLS),
                ("M = N = 300", small, 300, 64),
                ("NaN rows, M = N = 300", nan_rows, 300, 64)):
            (gs, gi), (ws, wi) = kern(c, m, blk), plain(c, m)
            torch.cuda.synchronize()
            same = torch.equal(gi, wi)
            err = float((gs - ws).abs().max())
            print(f"  {name} [{label}]: indices equal {same}, max abs err "
                  f"{err:.3e}")
            assert same and torch.isfinite(gs).all(), (name, label)
            torch.testing.assert_close(gs, ws, **BODY_TOL)
            worst = max(worst, err)
        flops, nbytes = _topm_work(SEARCH_QUERIES, n, PREFILTER_M, f, **work)
        if work:
            nbytes += param_bytes({"fcn": fcn})
        # The composition a later PR would race: not one call, so it is no
        # `library_ms`; kept as a yardstick.
        if name == "topm":
            def yard():
                return torch.topk(hq @ emb.T, PREFILTER_M, dim=1)
            what = "torch.topk(qv @ corpus.T, M)"
        else:
            def yard():
                x = torch.relu(torch.einsum(
                    "qkf,nf->qnk", uq.view(len(uq), -1, f), emb)
                    + dq[:, None, :])
                for i, layer in enumerate(fcn):
                    x = x @ layer["w"] + layer["b"]
                    if i + 1 < len(fcn):
                        x = torch.relu(x)
                return torch.topk(x[..., 0], PREFILTER_M, dim=1)
            what = "einsum, FCN matmuls, torch.topk"
        extra = {"yardstick_ms": time_cuda(yard), "yardstick": what}
        print(f"  {name} yardstick {what}: {extra['yardstick_ms']:.4f} ms")
        kern(emb, PREFILTER_M, BLOCK_COLS)
        plan = getattr(retrieval, "blocked_" + name).last_plan
        assert plan.route == "select" and plan.list_entries == 0, plan
        assert plan.scoring == ("dot" if name == "topm" else "ntn_served")
        held = retrieval.max_clusters(plan, f)
        assert held * plan.cluster >= plan.grid[0], (plan, held)
        extra.update(plan=plan.summary(), plan_route=plan.route,
                     resident_clusters=held,
                     graph_ms=time_cuda_graph(
                         lambda: kern(emb, PREFILTER_M, BLOCK_COLS), 20),
                     bit_identical=_parent_check(
                         "topm", "dot_equal" if name == "topm"
                         else "ntn_equal"))
        print(f"  {name} plan at the served shape: {plan.summary()} (the "
              f"card holds {held} clusters at once); CUDA graph "
              f"{extra['graph_ms']:.5f} ms a launch")
        out[name] = record(
            name, worst,
            *timings(lambda: kern(emb, PREFILTER_M, BLOCK_COLS),
                     lambda: plain(emb, PREFILTER_M), symbols),
            f"(Q, N, M) = ({SEARCH_QUERIES}, {n}, {PREFILTER_M}), block "
            f"{BLOCK_COLS}", flops, nbytes,
            err_bound="indices equal; scores rtol 1e-05, atol 1e-06",
            **extra)
    return out


class SpanTimer:
    """Device span of the engine's executor calls (embed, head,
    prefilter) from CUDA events around the `_FAULT_HOOK` seam, summed
    over a `with` block."""

    def __init__(self):
        self.events: list = []

    def _hook(self, site, thunk):
        if site == "profile":           # the trace record: host bookkeeping
            return thunk()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = thunk()
        end.record()
        self.events.append((start, end))
        return out

    def __enter__(self):
        from repro_torch.core import engine as engine_mod

        self._saved = engine_mod._FAULT_HOOK
        engine_mod._FAULT_HOOK = self._hook
        self.events = []
        return self

    def __exit__(self, *exc):
        from repro_torch.core import engine as engine_mod

        engine_mod._FAULT_HOOK = self._saved
        torch.cuda.synchronize()
        self.device_s = sum(s.elapsed_time(e) for s, e in self.events) / 1e3
        return False


def _same_ranking(got, want, scores) -> int:
    """Positions where two top-k index lists differ; each must be a near
    tie (the two rows' CPU scores within 1e-6). Returns their count."""
    swaps = 0
    for (gi, _), (wi, _), s in zip(got, want, scores):
        for a, b in zip(gi, wi):
            if a != b:
                assert abs(float(s[a]) - float(s[b])) <= 1e-6, (a, b)
                swaps += 1
    return swaps


def search_phase(params, corpus, queries, reset_counts, read_counts,
                 gcn_timed):
    """Phase 6: `SimilaritySearchServer` on the card. Index the corpus,
    serve exact and two-stage top-k queries, drive the prefilter kernel
    the calibration did not pick through `engine.prefilter_topm` at the
    same shapes, check M = N two-stage against exact and a save/load
    round trip bit for bit, and hold embeddings and rankings against the
    same server on the CPU. Each `fused_gcn` launch of the served run is
    recorded by (graphs, bucket); a kind that `gcn_timed` (phase 3b's
    per-launch times) lacks is timed on its recorded inputs, and the
    launches' time over their bounds is summed launch by launch. Returns
    (report, launch counts)."""
    import tempfile

    from repro_torch.configs.simgnn_aids import CONFIG as CFG
    from repro_torch.kernels import ops, retrieval
    from repro_torch.serve.search import SimilaritySearchServer

    srv = SimilaritySearchServer(params, CFG, cache_size=16384)
    n = len(corpus)
    gcn_calls: list = []
    head_calls: dict = {}
    real_gcn, real_head = ops.fused_gcn_att, ops.simgnn_head

    def recording_gcn(adj, feats, mask, *weights):
        gcn_calls.append((adj, feats, mask))
        return real_gcn(adj, feats, mask, *weights)

    def recording_head(h1, h2, *weights):
        calls = head_calls.setdefault(h1.shape[0], [])
        calls.append(None if calls else (h1, h2))
        return real_head(h1, h2, *weights)

    # The dot scan's launches, by shape, at the engine's seam (the scan
    # itself counts its launches through its own module global).
    topm_calls: dict = {}
    real_prefilter = srv.engine.prefilter_topm

    def recording_prefilter(qv, corpus, m, *, block_cols=None,
                            ntn_operands=None):
        if ntn_operands is None:
            kind = (len(qv), corpus.shape[0], min(m, corpus.shape[0]),
                    block_cols)
            calls = topm_calls.setdefault(kind, [])
            calls.append(None if calls else (qv, corpus))
        return real_prefilter(qv, corpus, m, block_cols=block_cols,
                              ntn_operands=ntn_operands)

    ops.fused_gcn_att = recording_gcn
    ops.simgnn_head = recording_head
    srv.engine.prefilter_topm = recording_prefilter
    reset_counts()
    timer = SpanTimer()
    with timer:
        t0 = time.perf_counter()
        emb = srv.index(corpus)
        index_s = time.perf_counter() - t0
    index_dev = timer.device_s
    exact, walls = [], []
    with timer:
        for q in queries[:EXACT_QUERIES]:
            t0 = time.perf_counter()
            exact.append(srv.topk(q, k=TOPK))
            walls.append(time.perf_counter() - t0)
    exact_dev = timer.device_s
    # Two-stage: one call serves every query (one prefilter launch). The
    # first call also embeds the queries and calibrates the proxy; the
    # second finds the queries cached, as a repeated query would.
    t0 = time.perf_counter()
    srv.search(queries, k=TOPK, mode="two_stage", prefilter_m=PREFILTER_M)
    first_two_s = time.perf_counter() - t0
    first_stages = {"embed_seconds": srv.stats.embed_seconds,
                    "calibrate_seconds": srv.stats.calibrate_seconds}
    keys = ("embed_seconds", "prefilter_seconds", "gather_seconds",
            "rerank_seconds", "topk_seconds")
    before = {k: getattr(srv.stats, k) for k in keys}
    with timer:
        t0 = time.perf_counter()
        two = srv.search(queries, k=TOPK, mode="two_stage",
                         prefilter_m=PREFILTER_M)
        two_s = time.perf_counter() - t0
    two_dev = timer.device_s
    stages = {k: getattr(srv.stats, k) - before[k] for k in keys}
    health = srv.health()
    proxy = health["prefilter"]["proxy"]
    # The other proxy's kernel, at the same shapes (the dot kernel on the
    # raw query embeddings when the exact NTN scan was picked).
    hq = srv.engine.embed_graphs(queries)
    ntn_ops = (retrieval.collapse_query_ntn(params["ntn"], hq)
               if proxy == "linear" else None)
    other = srv.engine.prefilter_topm(hq, srv.corpus_dev, PREFILTER_M,
                                      block_cols=BLOCK_COLS,
                                      ntn_operands=ntn_ops)
    assert other[1].shape == (SEARCH_QUERIES, PREFILTER_M)
    # M = N two-stage is the exact scan, bit for bit.
    ei, es = srv.topk(queries[0], k=TOPK)
    ti, ts = srv.topk(queries[0], k=TOPK, mode="two_stage", prefilter_m=n)
    m_eq_n = bool(np.array_equal(ei, ti) and es.tobytes() == ts.tobytes())
    counts = read_counts()
    ops.fused_gcn_att, ops.simgnn_head = real_gcn, real_head
    srv.engine.prefilter_topm = real_prefilter
    print(f"search launches: {counts}")
    kinds: dict = {}
    for arrays in gcn_calls:
        kinds.setdefault(tuple(arrays[0].shape[:2]), []).append(arrays)
    assert sum(map(len, kinds.values())) == counts["fused_gcn"], kinds.keys()
    gcn_lost, gcn_kinds = 0.0, []
    for kind, calls in sorted(kinds.items()):
        t = gcn_timed.get(kind) or _gcn_launch_time(calls[0], params)
        gcn_lost += len(calls) * (t["ms"] - t["bound_ms"])
        gcn_kinds.append(dict(t, launches=len(calls)))
    print("search fused_gcn launches (graphs x bucket: launches, ms): "
          + "; ".join(f"{k['graphs']} x {k['bucket']}: {k['launches']}, "
                      f"{k['ms']:.4f}" for k in gcn_kinds)
          + f"; time over the bound summed launch by launch "
          f"{gcn_lost:.4f} ms")
    for k in gcn_kinds:
        print(f"  search fused_gcn {k['graphs']} x {k['bucket']}: "
              f"{k['launches']} launch(es) of {k['ms']:.4f} ms, bound "
              f"{k['bound_ms'] * 1e3:.3f} us; plan: {k['plan']['summary']}")
    del gcn_calls, kinds
    assert sum(map(len, head_calls.values())) == counts["simgnn_head"]
    head_lost, head_kinds = 0.0, []
    for b, calls in sorted(head_calls.items()):
        t = _head_launch_time(*calls[0], params)
        head_lost += len(calls) * (t["ms"] - t["bound_ms"])
        head_kinds.append(dict(t, launches=len(calls)))
        print(f"  search simgnn_head B {b}: {len(calls)} launch(es) of "
              f"{t['ms']:.5f} ms, bound {t['bound_ms'] * 1e3:.3f} us "
              f"({t['bound_ms'] / t['ms']:.2%} of it); plan: {t['plan']}")
    print("search simgnn_head launches (B: launches, ms): " + "; ".join(
        f"{k['B']}: {k['launches']}, {k['ms']:.5f}" for k in head_kinds)
        + f"; time over the bound summed launch by launch "
        f"{head_lost:.4f} ms")
    del head_calls
    assert sum(map(len, topm_calls.values())) == counts["topm"]
    topm_lost, topm_kinds = 0.0, []
    for (q, n_rows, m, block), calls in sorted(topm_calls.items(),
                                               key=lambda kv: str(kv[0])):
        qv, corpus_dev = calls[0]
        t = _topm_launch_time(torch.as_tensor(qv, device=corpus_dev.device),
                              corpus_dev, m, block)
        topm_lost += len(calls) * (t["ms"] - t["bound_ms"])
        topm_kinds.append(dict(t, launches=len(calls)))
        print(f"  search topm (Q, N, M, block) = ({q}, {n_rows}, {m}, "
              f"{block}): {len(calls)} launch(es) of {t['ms']:.5f} ms "
              f"(CUDA graph {t['graph_ms']:.5f}), bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_ms'] / t['ms']:.2%} "
              f"of it); plan: {t['plan']}")
    print("search topm launches: time over the bound summed launch by "
          f"launch {topm_lost:.4f} ms")
    del topm_calls
    assert m_eq_n, "two-stage at M = N differs from the exact scan"
    c = srv.engine.counters
    assert srv.stats.prefilter_degraded == 0 and not c["prefilter_degraded"]
    assert not [k for k in c if k.startswith("errors:")], dict(c)
    assert not c["embed_dropped_graphs"] and srv.stats.failed_embeddings == 0
    with tempfile.TemporaryDirectory() as d:
        srv.save(d)
        fresh = SimilaritySearchServer(params, CFG, cache_size=16384)
        loaded = fresh.load(d, corpus)
        reload_ok = bool(loaded.tobytes() == emb.tobytes() and np.array_equal(
            fresh.topk(queries[1], k=TOPK)[0], srv.topk(queries[1], k=TOPK)[0]))
    assert reload_ok and fresh.stats.shards_recovered == 0
    # The same server on the CPU: the plain path.
    cpu = SimilaritySearchServer(params, CFG, cache_size=16384, device="cpu")
    cpu_emb = cpu.index(corpus)
    emb_err = float(np.abs(emb - cpu_emb).max())
    np.testing.assert_allclose(emb, cpu_emb, **BODY_TOL)
    cpu_exact = [cpu.topk(q, k=TOPK) for q in queries[:EXACT_QUERIES]]
    cpu_two = cpu.search(queries, k=TOPK, mode="two_stage",
                         prefilter_m=PREFILTER_M)
    assert cpu.health()["prefilter"]["proxy"] == proxy
    cpu_scores = [cpu.scores(q) for q in queries]
    swaps = (_same_ranking(exact, cpu_exact, cpu_scores)
             + _same_ranking(two, cpu_two, cpu_scores))
    rep = {"corpus": n, "index_s": index_s, "index_device_s": index_dev,
           "index_graphs_per_s": n / index_s,
           "exact_query_ms": [1e3 * w for w in walls],
           "exact_device_s": exact_dev,
           "first_two_stage_s": first_two_s,
           "first_two_stage_embed_and_calibrate_s": first_stages,
           "two_stage_s": two_s, "two_stage_device_s": two_dev,
           "two_stage_stages_s": stages, "proxy": proxy,
           "calibration": {k: health["prefilter"][k]
                           for k in ("r2", "recall_linear")},
           "m_eq_n_bit_identical": m_eq_n, "reload_bit_identical": reload_ok,
           "embedding_max_abs_err_vs_cpu": emb_err,
           "near_tie_swaps_vs_cpu": swaps, "launches": counts,
           "fused_gcn_launches": gcn_kinds,
           "fused_gcn_lost_ms": gcn_lost, "simgnn_head_launches": head_kinds,
           "simgnn_head_lost_ms": head_lost, "topm_launches": topm_kinds,
           "topm_lost_ms": topm_lost, "counters": dict(c)}
    exact_ms = statistics.median(rep["exact_query_ms"])
    print(f"search: index {n} graphs in {index_s:.3f} s "
          f"({n / index_s:.1f} graphs/s, device span {index_dev:.4f} s); "
          f"exact top-{TOPK} query {exact_ms:.3f} ms median "
          f"(idle share {1 - exact_dev / sum(walls):.4f}); two-stage "
          f"{SEARCH_QUERIES} queries in {1e3 * two_s:.3f} ms "
          f"({1e3 * two_s / SEARCH_QUERIES:.3f} ms per query, idle share "
          f"{1 - two_dev / two_s:.4f}); proxy {proxy}")
    print(f"search: first two-stage call {1e3 * first_two_s:.3f} ms "
          f"(cumulative embed {1e3 * first_stages['embed_seconds']:.3f} ms "
          f"incl. the index, calibrate "
          f"{1e3 * first_stages['calibrate_seconds']:.3f} ms)")
    print("search two-stage stages (ms per call): " + ", ".join(
        f"{k.replace('_seconds', '')} {1e3 * v:.3f}"
        for k, v in stages.items()))
    print(f"search checks: M = N bit-identical {m_eq_n}, reload "
          f"bit-identical {reload_ok}, embeddings vs CPU {emb_err:.3e}, "
          f"top-{TOPK} equal to the CPU server's but {swaps} near-tie "
          f"swaps, prefilter_degraded 0, no errors")
    return rep, counts


def _bf16_excess(got, want, tol=BODY_TOL) -> float:
    """max(|got - want| - bound) where the bound is one bf16 ulp of the
    value plus the float32 bound `tol` (by default rtol 1e-5, atol 1e-6)
    for sums taken in another order before the one rounding; <= 0
    passes."""
    want = want.float()
    _, ex = torch.frexp(want.abs())
    ulp = torch.ldexp(torch.ones_like(want), ex - 8)
    bound = ulp + tol["atol"] + tol["rtol"] * want.abs()
    return float(((got.float() - want).abs() - bound).max())


def _ms(ms) -> str:
    return "not traced" if ms is None else f"{ms:.4f} ms"


def _moe_tiling(plan) -> str:
    """One line for `moe_expert_ffn_plan`: the path and each launch's
    kernel, tile, CTAs and shared bytes."""
    return f"path {plan['path']}" + (" (swapped)" if plan["swapped"] else "") \
        + "; " + "; ".join(
            f"{s['kernel']} tile {s['tile'][0]} x {s['tile'][1]}, "
            f"{s['ctas']} CTAs, {s['smem_bytes']} B shared"
            for s in plan["launches"])


def _moe_work(b, e, c, d, f, elt) -> tuple[float, int]:
    """Flops and bytes of one expert-FFN launch: 6 B E C D F flops (x W_in
    is 4 B E C D F, h W_out 2 B E C F D), x read and y written once, both
    weights read once."""
    return 6.0 * b * e * c * d * f, (2 * b * e * c * d + 3 * e * d * f) * elt


def _profile_busy(fn, symbol=MOE_KERNELS):
    """Where one call of `fn` spends its time, from `torch.profiler`: wall
    s, device busy s (the sum of every device activity's own time; one
    stream, so activities do not overlap), the s of the kernels whose
    names contain `symbol` (a string or a tuple), the number of kernel
    launches the host made, and the five device activities that took
    longest (name, s, count). Only the device's rows are summed: an
    operator's row also carries the device time of the kernels it
    launched, which the kernels' own rows hold already."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = moe = 0.0
    launches, device = 0, []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if ev.device_type != DeviceType.CUDA:
            us = 0.0
        busy += us
        if any(s in ev.key for s in (
                (symbol,) if isinstance(symbol, str) else symbol)):
            moe += us
        if ev.key in ("cudaLaunchKernel", "cuLaunchKernel",
                      "cudaLaunchKernelExC", "cuLaunchKernelEx"):
            launches += ev.count
        if us > 0:
            device.append((ev.key[:80], us / 1e6, ev.count))
    device.sort(key=lambda t: -t[1])
    return wall, busy / 1e6, moe / 1e6, launches, device[:5]


def _expert_ffn_f64(x, w_in, w_out):
    """The expert FFN computed in float64, rounded once to x's dtype: the
    floor the served logits are compared against."""
    h = torch.einsum("...ecd,edf->...ecf", x.double(), w_in.double())
    gate, up = h.chunk(2, dim=-1)
    y = torch.einsum("...ecf,efd->...ecd", gate * torch.sigmoid(gate) * up,
                     w_out.double())
    return y.to(x.dtype)


def lm_phases(dev, reset_counts, read_counts):
    """Phases 8-11: granite-moe-3b-a800m served on the card.

    8 (a): the `moe_experts` kernel against its plain version at the
       served shapes (E 40, D 1536, F 512; B 4 with C 129 for a 512-token
       prefill and C 8 for a decode step), bf16 and float32, and an odd
       shape (B 3, E 7, C 13, D 200, F 36);
    9 (b): the main path: `greedy_generate` at full width and depth in
       bf16 (random weights from `torch.Generator` seed 0, drawn on the
       card), 4 prompts of 512 tokens from `batch_for_step(seed=17)`, 16
       new tokens, launch counts zeroed just before and read just after;
       then the steps timed alone, a profiled run for the idle share, and
       the same model with the plain expert function forced on the card
       (and, for the floor of that comparison, in float64);
    10 (c): a 2-layer float32 model at full width on the card (kernel)
       against the CPU (plain): last logits within LM_F32_ATOL;
    11 (d): the kernel's work, bound and time at the served shapes and at
       the 4096-token prompt's capacity (B 1, C 1025), the float32 FMA
       body's time beside the bf16 kernels', and the share of dispatch
       rows that hold a token.
    Returns (the kernel's entry, the phase report, main-path launches,
    the served params and config, which phase 15 reuses)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.kernels.moe_experts import (moe_expert_ffn,
                                                 moe_expert_ffn_plain,
                                                 moe_expert_ffn_plan)
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.init import init_params
    from repro_torch.params import params_to, tree_leaves
    from repro_torch.serve.step import (build_decode_step,
                                        build_prefill_step, greedy_generate)

    cfg = get_config(LM_ARCH).with_(moe_use_kernel=True)
    e, d, f, k = cfg.n_experts, cfg.d_model, cfg.d_ff_expert, cfg.top_k
    c_pre = moe_mod.moe_capacity(LM_PROMPT, e, k, cfg.capacity_factor)
    c_dec = moe_mod.moe_capacity(1, e, k, cfg.capacity_factor)
    c_long = moe_mod.moe_capacity(LONG_PROMPT, e, k, cfg.capacity_factor)
    rep: dict = {"arch": LM_ARCH, "batch": LM_BATCH, "prompt": LM_PROMPT,
                 "new_tokens": LM_NEW, "capacity": [c_pre, c_dec, c_long]}

    # ---- (a) the kernel against its plain version ----------------------
    g = torch.Generator(device=dev).manual_seed(5)

    def inputs(b, e_, c, d_, f_, dtype):
        x = torch.randn((b, e_, c, d_), device=dev, generator=g)
        w_in = torch.randn((e_, d_, 2 * f_), device=dev, generator=g) * 0.02
        w_out = torch.randn((e_, f_, d_), device=dev, generator=g) * (
            0.02 / cfg.n_layers ** 0.5)
        return [t.to(dtype) for t in (x, w_in, w_out)]

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("prefill bf16", (LM_BATCH, e, c_pre, d, f, bf16)),
             ("decode bf16", (LM_BATCH, e, c_dec, d, f, bf16)),
             ("prefill f32", (LM_BATCH, e, c_pre, d, f, f32)),
             ("decode f32", (LM_BATCH, e, c_dec, d, f, f32)),
             ("odd B 3 E 7 C 13 D 200 F 36, f32", (3, 7, 13, 200, 36, f32)),
             ("odd B 3 E 7 C 13 D 200 F 36, bf16", (3, 7, 13, 200, 36, bf16))]
    worst_bf16 = worst_f32 = 0.0
    worst_excess = float("-inf")
    held = {}
    for label, shape in cases:
        args = inputs(*shape)
        got = moe_expert_ffn(*args)
        want = moe_expert_ffn_plain(*args)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype, label
        assert torch.isfinite(got.float()).all(), label
        err = float((got.float() - want.float()).abs().max())
        plan = moe_expert_ffn_plan(*args)
        assert plan["path"] == ("wgmma" if shape[-1] == bf16 else "fma")
        print(f"  moe_experts [{label}]: {_moe_tiling(plan)}")
        if shape[-1] == bf16:
            excess = _bf16_excess(got, want)
            print(f"  moe_experts [{label}]: max abs err {err:.3e}, excess "
                  f"over one bf16 ulp + f32 bound {excess:.3e}")
            assert excess <= 0, (label, excess)
            worst_bf16, worst_excess = max(worst_bf16, err), max(
                worst_excess, excess)
        else:
            print(f"  moe_experts [{label}]: max abs err {err:.3e} (rtol "
                  f"1e-05, atol 1e-06)")
            torch.testing.assert_close(got, want, **BODY_TOL)
            worst_f32 = max(worst_f32, err)
        if not label.startswith("odd"):
            held[label] = args
    rep["kernel_vs_plain"] = {"max_abs_err_bf16": worst_bf16,
                              "max_abs_err_f32": worst_f32,
                              "bf16_excess_over_bound": worst_excess}

    # ---- (d) work and bound at the served shapes -----------------------
    # (the 4096-token prompt of phase 15 too: B 1, C = c_long)
    held["long prompt bf16"] = inputs(1, e, c_long, d, f, bf16)
    held["long prompt f32"] = inputs(1, e, c_long, d, f, f32)
    excess = _bf16_excess(moe_expert_ffn(*held["long prompt bf16"]),
                          moe_expert_ffn_plain(*held["long prompt bf16"]))
    print(f"  moe_experts [long prompt bf16, B 1 C {c_long}]: excess over "
          f"one bf16 ulp + f32 bound {excess:.3e}")
    assert excess <= 0, excess
    timed = {}
    for phase, b_, c in (("prefill", LM_BATCH, c_pre),
                         ("decode", LM_BATCH, c_dec),
                         ("long prompt", 1, c_long)):
        args, args32 = held[f"{phase} bf16"], held[f"{phase} f32"]
        flops, nbytes = _moe_work(b_, e, c, d, f, 2)
        ms, src, call_ms, plain_ms = timings(
            lambda: moe_expert_ffn(*args),
            lambda: moe_expert_ffn_plain(*args), MOE_KERNELS)
        fma_ms = kernel_device_ms(lambda: moe_expert_ffn(*args32),
                                  MOE_KERNELS)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES \
            * 1e3
        timed[phase] = {"ms": ms, "ms_source": src, "call_ms": call_ms,
                        "plain_ms": plain_ms, "flops": flops,
                        "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
                        "bound_by": "operations" if t_ops >= t_bytes
                        else "bytes", "plan": moe_expert_ffn_plan(*args),
                        "fma_f32_ms": fma_ms,
                        "events_ms": time_cuda_batch(
                            lambda: moe_expert_ffn(*args))}
        print(f"  moe_experts {phase} (B {b_}, C {c}): bf16 kernels "
              f"{ms:.4f} ms ({src}; events over 10 back-to-back calls "
              f"{timed[phase]['events_ms']:.4f} ms), wrapper {call_ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms; the float32 FMA body at the "
              f"same shape {_ms(fma_ms)}; bound "
              f"{timed[phase]['bound_ms'] * 1e3:.3f} us "
              f"({timed[phase]['bound_by']}: {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.3f} MB), {timed[phase]['bound_ms'] / ms:.2%} "
              f"of it")
    del held
    rep["kernel_times"] = timed
    pre = timed["prefill"]
    entry = record(
        "moe_experts", max(worst_bf16, worst_f32), pre["ms"],
        pre["ms_source"], pre["call_ms"], pre["plain_ms"],
        f"prefill bf16 (B, E, C, D, F) = ({LM_BATCH}, {e}, {c_pre}, {d}, "
        f"{f})", pre["flops"], pre["bytes"],
        err_bound="bf16: one bf16 ulp + (rtol 1e-05, atol 1e-06); f32: "
        "rtol 1e-05, atol 1e-06", peak_flops=PEAK_BF16_FLOPS,
        plan=pre["plan"], fma_f32_ms=pre["fma_f32_ms"],
        events_ms=pre["events_ms"], decode=timed["decode"],
        long_prompt=timed["long prompt"])

    # ---- (b) the main path: greedy_generate at full width and depth ----
    t0 = time.perf_counter()
    params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    rep["init_s"], rep["n_params"] = time.perf_counter() - t0, n_params
    prompt = torch.from_numpy(batch_for_step(
        cfg, 0, global_batch=LM_BATCH, seq_len=LM_PROMPT,
        seed=17)["tokens"]).to(dev)
    greedy_generate(params, cfg, prompt[:, :16], max_new=2,
                    device=dev)                                   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    toks = greedy_generate(params, cfg, prompt, max_new=LM_NEW, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"lm serve launches: {counts}")
    launches = counts["moe_experts"]
    assert launches == cfg.n_layers * LM_NEW, counts
    assert sum(counts.values()) == launches, counts
    assert toks.shape == (LM_BATCH, LM_NEW)
    assert int(toks.max()) < cfg.vocab_size and int(toks.min()) >= 0

    rep.update({"generate_s": gen_s,
                "tokens_per_s": LM_BATCH * LM_NEW / gen_s,
                "launches": counts})
    timed, kern_last = _serve_timings(params, cfg, prompt, LM_NEW,
                                      MOE_KERNELS)
    rep.update(timed)
    _print_serving("lm", "moe_experts", n_params, cfg, prompt, rep)
    prefill, decode = build_prefill_step(cfg), build_decode_step(cfg)

    # the same model with the plain expert function forced on the card,
    # and with the expert FFN in float64 (the floor of the comparison)
    fill = []

    def plain_expert(x, w_in, w_out):
        fill.append(float((x != 0).any(-1).float().mean()))
        return moe_expert_ffn_plain(x, w_in, w_out)

    saved = moe_mod.moe_expert_ffn
    before = read_counts()["moe_experts"]
    try:
        moe_mod.moe_expert_ffn = plain_expert
        last, caches, pos = prefill(params, prompt)
        plain_logits = [last]
        nxt = torch.argmax(last, -1)
        plain_toks = [nxt]
        for _ in range(LM_NEW - 1):
            logits, caches, pos = decode(params, nxt[:, None], caches, pos)
            nxt = torch.argmax(logits, -1)
            plain_logits.append(logits)
            plain_toks.append(nxt)
        del caches
        moe_mod.moe_expert_ffn = _expert_ffn_f64
        f64_last = prefill(params, prompt)[0]
    finally:
        moe_mod.moe_expert_ffn = saved
    assert read_counts()["moe_experts"] == before
    plain_toks = torch.stack(plain_toks, 1).to(torch.int32)
    v = cfg.vocab_size
    errs = {name: (a[:, :v] - b[:, :v]).abs() for name, a, b in (
        ("kernel_vs_plain", kern_last, plain_logits[0]),
        ("kernel_vs_f64", kern_last, f64_last),
        ("plain_vs_f64", plain_logits[0], f64_last))}
    floor = float(errs["plain_vs_f64"].max())
    bound = max(LM_BF16_BOUND, 2 * floor)
    for name, err in errs.items():
        print(f"lm prefill logits {name.replace('_', ' ')}: max abs err "
              f"{float(err.max()):.3e}, mean {float(err.mean()):.3e}, "
              f"{int((err > LM_BF16_BOUND).sum())} of {err.numel()} above "
              f"{LM_BF16_BOUND:g}")
    print(f"lm prefill logits bound: max({LM_BF16_BOUND:g}, 2 x floor "
          f"{floor:.3e}) = {bound:.3e} (logit std "
          f"{float(kern_last[:, :v].std()):.3f})")
    for name in ("kernel_vs_plain", "kernel_vs_f64"):
        assert float(errs[name].max()) <= bound, (name, bound)
    flips, compared = [], 0
    for b in range(LM_BATCH):
        for t in range(LM_NEW):
            top2 = torch.topk(plain_logits[t][b], 2).values
            margin = float(top2[0] - top2[1])
            if int(toks[b, t]) == int(plain_toks[b, t]):
                compared += 1
                continue
            assert margin <= bound, (b, t, margin)
            flips.append({"sequence": b, "step": t, "margin": margin})
            print(f"  token flip under the margin: sequence {b}, step {t}, "
                  f"plain top-2 margin {margin:.3e}; later steps of this "
                  f"sequence not compared")
            break
    print(f"lm tokens: {compared} equal to the plain run's, "
          f"{len(flips)} flips under the {bound:.3e} margin")
    prefill_err = float(errs["kernel_vs_plain"].max())
    share_pre = statistics.fmean(fill[:cfg.n_layers])
    share_dec = statistics.fmean(fill[cfg.n_layers:])
    print(f"dispatch rows holding a token: prefill {share_pre:.4f} of "
          f"B*E*C = {LM_BATCH * e * c_pre}, decode {share_dec:.4f} of "
          f"{LM_BATCH * e * c_dec}")
    rep.update({"prefill_logits_err_vs_plain": prefill_err,
                "prefill_logits_err": {n: {"max": float(e_.max()),
                                           "mean": float(e_.mean())}
                                       for n, e_ in errs.items()},
                "prefill_logits_bound": bound,
                "tokens_compared": compared, "flips": flips,
                "row_fill_prefill": share_pre, "row_fill_decode": share_dec})
    entry["row_fill"] = {"prefill": share_pre, "decode": share_dec}

    # ---- (c) float32, full width, 2 layers: card against CPU -----------
    cfg32 = cfg.with_(n_layers=2, param_dtype="float32", dtype="float32")
    p32 = init_params(torch.Generator().manual_seed(1), cfg32, device=dev)
    short = torch.from_numpy(batch_for_step(
        cfg32, 1, global_batch=2, seq_len=64, seed=17)["tokens"])
    step32 = build_prefill_step(cfg32)
    card_last = step32(p32, short.to(dev))[0]
    host_last = step32(params_to(p32, "cpu"), short)[0]
    err32 = float((card_last.cpu() - host_last).abs().max())
    print(f"lm float32 2 layers, 2 x 64 tokens: card (kernel) vs CPU "
          f"(plain) last logits max abs err {err32:.3e} "
          f"(bound {LM_F32_ATOL:g})")
    assert err32 <= LM_F32_ATOL, err32
    rep["f32_2layer_err_vs_cpu"] = err32
    del p32
    torch.cuda.empty_cache()
    return entry, rep, launches, params, cfg


class PhaseClock:
    """Prints the seconds each phase took since the previous call."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.seconds: dict = {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t0
        print(f"phase {name}: {now - self.t0:.1f} s")
        self.t0 = now


def _held(name, label, got, want, tol, bf16=False) -> float:
    """Hold a kernel's output against its plain version's: float32 within
    `tol`, bf16 within one bf16 ulp more. Prints; returns the max abs
    error."""
    assert got.shape == want.shape and got.dtype == want.dtype, (name, label)
    assert torch.isfinite(got.float()).all(), (name, label)
    err = float((got.float() - want.float()).abs().max())
    if bf16:
        excess = _bf16_excess(got, want, tol)
        print(f"  {name} [{label}]: max abs err {err:.3e}, excess over one "
              f"bf16 ulp + (rtol {tol['rtol']:g}, atol {tol['atol']:g}) "
              f"{excess:.3e}")
        assert excess <= 0, (name, label, excess)
    else:
        print(f"  {name} [{label}]: max abs err {err:.3e} (rtol "
              f"{tol['rtol']:g}, atol {tol['atol']:g})")
        torch.testing.assert_close(got, want, **tol)
    return err


def _held_f64(name, label, got, want, ref, tol) -> dict:
    """Hold a kernel's output on captured model inputs against its plain
    version's through a float64 run of the same arithmetic: the kernel's
    distance to the float64 result must be within twice the plain float32
    version's, plus the stated atol. (Model activations make the sums
    cancel, so an error relative to each output's own size is not the
    measure: both float32 versions are as far from float64 as float32
    sums in one valid order leave them.) Prints; returns the distances."""
    ref = ref.double()
    kern = float((got.double() - ref).abs().max())
    plain = float((want.double() - ref).abs().max())
    diff = float((got.float() - want.float()).abs().max())
    bound = 2 * plain + tol["atol"]
    print(f"  {name} [{label}]: kernel vs plain {diff:.3e}; against float64 "
          f"kernel {kern:.3e}, plain {plain:.3e} (bound 2 x plain + "
          f"{tol['atol']:g} = {bound:.3e}; output max "
          f"{float(ref.abs().max()):.3e})")
    assert torch.isfinite(got.float()).all(), (name, label)
    assert kern <= bound, (name, label, kern, bound)
    return {"kernel_vs_plain": diff, "kernel_vs_f64": kern,
            "plain_vs_f64": plain, "bound": bound}


def _wkv6_f64(r, k, v, w, u, s0=None):
    """The WKV recurrence in float64 (the floor of the captured-input
    check): (o, final state)."""
    b, t, h, kd = r.shape
    r, k, v, w, u = (x.double() for x in (r, k, v, w, u))
    s = (torch.zeros((b, h, kd, v.shape[-1]), dtype=torch.float64,
                     device=r.device) if s0 is None else s0.double())
    o = torch.empty(v.shape, dtype=torch.float64, device=r.device)
    for i in range(t):
        o[:, i] = torch.einsum("bhk,bhkv->bhv", r[:, i], s) + torch.sum(
            r[:, i] * u * k[:, i], -1, keepdim=True) * v[:, i]
        s = w[:, i][..., None] * s + k[:, i][..., None] * v[:, i][..., None, :]
    return o, s


def _mamba_f64(dt, x, b, c, a, d, h0=None):
    """The selective scan in float64 (the floor of the captured-input
    check): (y with D * x, final state)."""
    dt, x, b, c, a, d = (z.double() for z in (dt, x, b, c, a, d))
    h = (torch.zeros((x.shape[0], x.shape[2], a.shape[1]),
                     dtype=torch.float64, device=x.device)
         if h0 is None else h0.double())
    y = torch.empty(x.shape, dtype=torch.float64, device=x.device)
    for i in range(x.shape[1]):
        h = torch.exp(dt[:, i][..., None] * a) * h \
            + (dt[:, i] * x[:, i])[..., None] * b[:, i][:, None, :]
        y[:, i] = torch.einsum("bdn,bn->bd", h, c[:, i]) + d * x[:, i]
    return y, h


def _flash_f64(q, k, v, *, causal=True, window=None, softcap=None,
               rows=512):
    """Masked softmax attention in float64 over blocks of query rows (the
    floor of the captured-input check)."""
    t, h, d = q.shape[1:]
    s_len, group = k.shape[1], h // k.shape[2]
    k64 = k.double().repeat_interleave(group, dim=2)
    v64 = v.double().repeat_interleave(group, dim=2)
    kv_pos = torch.arange(s_len, device=q.device)[None, :]
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for t0 in range(0, t, rows):
        sc = torch.einsum("bthd,bshd->bhts", q[:, t0:t0 + rows].double(),
                          k64) * d ** -0.5
        if softcap is not None:
            sc = softcap * torch.tanh(sc / softcap)
        q_pos = torch.arange(t0, t0 + sc.shape[2], device=q.device)[:, None]
        mask = torch.ones_like(sc[0, 0], dtype=torch.bool)
        if causal:
            mask &= kv_pos <= q_pos
        if window is not None:
            mask &= (q_pos - kv_pos) < window
        p = torch.where(mask, torch.softmax(torch.where(mask, sc, -1e300),
                                            -1), 0.0)
        out[:, t0:t0 + rows] = torch.einsum("bhts,bshd->bthd", p, v64)
    return out


def time_cuda_graph(fn, iters: int = 50) -> float:
    """Mean ms per call of `fn` from CUDA events around one replay of a
    CUDA graph that holds `iters` calls back to back: a short kernel's
    device time without the host's gaps between launches."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _registers(log: str, entry: str, key) -> dict:
    """Registers of each kernel instantiation in a ptxas report whose
    entry name matches `entry`, keyed by key(match)."""
    import re

    regs, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*" + entry, line)
        if m:
            name = key(m)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name], name = int(m.group(1)), None
    return dict(sorted(regs.items()))


def _entry_spills(log: str) -> dict:
    """Spill-store bytes of each entry function of a ptxas report, keyed
    by the kernel's name."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?)\d", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name], name = int(m.group(1)), None
    return out


#: the select route's instantiations in a ptxas report: the dot scan's
#: `topm_select_kernel<R, FX>` and the NTN scan's
#: `topm_ntn_select_kernel<R, SERVED>`
SELECT_KERNELS = (r"topm_(ntn_)?select_kernelILi(\d)EL([ib])(\d+)E")


def _select_key(m) -> str:
    """The key "dot R r F f|any" or "ntn R r AIDS|any" of a select-route
    kernel name match."""
    if m.group(1):
        return f"ntn R {m.group(2)} {'AIDS' if m.group(4) == '1' else 'any'}"
    return f"dot R {m.group(2)} F {'any' if m.group(4) == '0' else m.group(4)}"


def _select_spills(log: str) -> dict:
    """Spill-store bytes of each select-route instantiation in the
    retrieval library's ptxas report, keyed as `_select_key`."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*" + SELECT_KERNELS, line)
        if m:
            name = _select_key(m)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name], name = int(m.group(1)), None
    return dict(sorted(out.items()))


def _elt(m) -> str:
    return "bf16" if "bfloat16" in m.group(1) else "f32"


def _gcn_registers(log: str) -> dict:
    """Registers of `fused_gcn_kernel<SCRATCH>` by route."""
    return _registers(log, r"fused_gcn_kernelILb(\d)E",
                      lambda m: "scratch" if m.group(1) == "1" else "shared")


def _head_registers(log: str) -> dict:
    """Registers of the warp route's kernel and of each
    `simgnn_head_tiled_kernel<PT>` instantiation, keyed "warp" and
    "tiled PT"."""
    return _registers(log, r"simgnn_head_(?:tiled_kernelILi(\d+)E|kernel)",
                      lambda m: f"tiled {m.group(1)}" if m.group(1)
                      else "warp")


def _wkv_registers(log: str) -> dict:
    """Registers of each `wkv6_kernel<Elt, KMAX, VB>` instantiation,
    keyed "bf16|f32 KMAX VB"."""
    return _registers(log, r"wkv6_kernelI(\w+?)Li(\d+)ELi(\d+)E",
                      lambda m: f"{_elt(m)} {m.group(2)} {m.group(3)}")


def _mamba_registers(log: str) -> dict:
    """Registers of each `mamba_scan_kernel<Elt, NMAX, FULL_N>`
    instantiation, keyed "bf16|f32 NMAX exact|pred"."""
    return _registers(
        log, r"mamba_scan_kernelI(\w+?)Li(\d+)ELb(\d)E",
        lambda m: f"{_elt(m)} {m.group(2)} "
        f"{'exact' if m.group(3) == '1' else 'pred'}")


def _print_mamba_plan(label, shape, dtype) -> dict:
    """Print and return what a `mamba_selective_scan_state` launch at
    (B, T, Din, N) runs."""
    from repro_torch.kernels.mamba_scan import mamba_scan_plan

    plan = mamba_scan_plan(*shape, dtype)
    print(f"  mamba_scan plan [{label}, {str(dtype).split('.')[-1]}]: "
          f"{plan['ctas']} CTAs of {plan['threads']} threads (one a "
          f"channel), TB {plan['tb']}, dt/x {plan['route']}, B/C "
          f"{plan['bc_route']}, {plan['state_rows']} state rows, NMAX "
          f"{plan['nmax']}{' (N 16 exactly)' if plan['exact_n'] else ''}, "
          f"{plan['smem_bytes']} shared bytes")
    return plan


def _print_wkv_plan(label, shape, dtype) -> dict:
    """Print and return what a `wkv6_state` launch at (B, T, H, K, V)
    runs."""
    from repro_torch.kernels.wkv6 import wkv6_plan

    plan = wkv6_plan(*shape, dtype)
    print(f"  wkv6 plan [{label}, {str(dtype).split('.')[-1]}]: "
          f"{plan['ctas']} CTAs of {plan['threads']} threads "
          f"({plan['vb']} value columns a CTA, {plan['cols_per_thread']} a "
          f"thread), TB {plan['tb']}, {plan['route']} staging, "
          f"{plan['smem_bytes']} shared bytes")
    return plan


def time_cuda_batch(fn, iters: int = 10) -> float:
    """Mean ms per call of `fn` from CUDA events around `iters` warm calls
    launched back to back (one synchronize at the end): a cross-check of
    the profiler's kernel time."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _flash_work(b, t, s, h, kv, d, elt, causal=True, window=None,
                **_) -> tuple[float, int]:
    """Flops and bytes of one attention call: 4 D flops per (head, query,
    kv) pair that the masks keep (QK^T and PV), q, k, v read once and o
    written once."""
    rows = np.arange(t)
    hi = np.minimum(rows, s - 1) if causal else np.full(t, s - 1)
    lo = np.maximum(rows - window + 1, 0) if window is not None \
        else np.zeros(t, np.int64)
    pairs = float(np.clip(hi - lo + 1, 0, None).sum())
    return 4.0 * b * h * d * pairs, (2 * b * t * h * d + 2 * b * s * kv * d) \
        * elt


def _wkv_work(b, t, h, kd, vd, elt, state=False) -> tuple[float, int]:
    """Flops and bytes of one wkv6 launch: per token and head r.S (2KV),
    the update w*S + k v^T (3KV), the bonus (3K) and its product with v
    (2V); r, k, v read once in their dtype, w and u in float32, o and the
    final state (and a given state) in float32."""
    flops = float(b * t * h) * (5 * kd * vd + 3 * kd + 2 * vd)
    nbytes = (b * t * h * (2 * kd + vd)) * elt + 4 * (
        b * t * h * kd + h * kd + b * t * h * vd + (2 if state else 1)
        * b * h * kd * vd)
    return flops, nbytes


def _mamba_work(bsz, t, din, n, elt, state=False) -> tuple[float, int]:
    """Flops and bytes of one scan launch: per (token, channel, state) the
    exp argument, the exp, a_bar*h, dt*x*B, the add and the C dot (2);
    per (token, channel) dt*x and D*x + y; dt and x read once in their
    dtype, B, C, A, D in float32, y and the final state (and a given
    state) in float32."""
    flops = float(bsz * t * din) * (7 * n + 3)
    nbytes = 2 * bsz * t * din * elt + 4 * (
        2 * bsz * t * n + din * n + din + bsz * t * din
        + (2 if state else 1) * bsz * din * n)
    return flops, nbytes


def lm_kernel_checks(dev) -> dict:
    """Phase 12 (a): `flash_attention`, `wkv6` and `mamba_selective_scan`
    against their plain versions on the card, bf16 and float32:

      flash: granite's prefill (B 1, T = S = 4096, H 24, KV 8, D 64,
        causal), gemma2-9b's (T = S = 8192, H 16, KV 8, D 256, softcap 50,
        without and with window 4096), and a ragged T != S shape; the SDPA
        call on granite's shape is the library yardstick;
      wkv6: the served shape (B 4, T 512, H 64, K = V 64) from a zero and
        a given state, a decode step (T 1), and an odd shape;
      mamba: Jamba's block (B 2, T 2048, Din 16384, N 16) from a zero and
        a given state, a decode step, and an odd shape.

    Inputs come from a seeded device generator at the model's scales.
    Returns the three kernels' entries (launches filled in later)."""
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attention_plain,
                                                flash_attention_plan)
    from repro_torch.kernels.mamba_scan import (
        mamba_selective_scan, mamba_selective_scan_plain,
        mamba_selective_scan_state, mamba_selective_scan_state_plain)
    from repro_torch.kernels.wkv6 import (wkv6, wkv6_plain, wkv6_state,
                                          wkv6_state_plain)

    g = torch.Generator(device=dev).manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=g) * scale

    out = {}
    # ---- flash_attention
    granite, gemma, odd = FLASH_GRANITE, FLASH_GEMMA, FLASH_RAGGED
    fcases = [
        ("granite 4096 causal, bf16", granite, bf16, dict(causal=True)),
        ("granite 4096 causal, f32", granite, f32, dict(causal=True)),
        ("gemma2 8192 softcap 50, bf16", gemma, bf16,
         dict(causal=True, softcap=50.0)),
        ("gemma2 8192 softcap 50 window 4096, bf16", gemma, bf16,
         dict(causal=True, window=GEMMA_WINDOW, softcap=50.0)),
        ("gemma2 8192 softcap 50 window 4096, f32", gemma, f32,
         dict(causal=True, window=GEMMA_WINDOW, softcap=50.0)),
        ("ragged T 333 S 517 H 12 KV 3 D 80 window 100 softcap 30, bf16",
         odd, bf16, dict(causal=True, window=100, softcap=30.0)),
        ("ragged T 333 S 517 H 12 KV 3 D 80 window 100 softcap 30, f32",
         odd, f32, dict(causal=True, window=100, softcap=30.0)),
        ("ragged T 333 S 517 not causal, f32", odd, f32, dict(causal=False)),
    ]
    worst, extra = 0.0, {}
    for label, (b, t, s, h, kv, d), dtype, kw in fcases:
        q = randn((b, t, h, d)).to(dtype)
        k, v = (randn((b, s, kv, d)).to(dtype) for _ in range(2))
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        plan = flash_attention_plan(q, k, v)
        assert plan["path"] == ("wgmma" if dtype == bf16 else "fma")
        print(f"  flash_attn [{label}]: path {plan['path']}, "
              f"{plan['kernel']}<DP {plan['dp']}>, {plan['ctas']} CTAs of "
              f"{plan['threads']} threads, {plan['smem_bytes']} B shared")
        worst = max(worst, _held("flash_attn", label, got, want, FLASH_TOL,
                                 bf16=dtype == bf16))
        if label.startswith("gemma2") and dtype == bf16:
            run = lambda: flash_attention(q, k, v, **kw)  # noqa: E731
            ms = kernel_device_ms(run, FLASH_KERNELS, iters=5)
            events_ms = time_cuda_batch(run, iters=5)
            q32, k32, v32 = (x.float() for x in (q, k, v))
            fma_ms = time_cuda_batch(
                lambda: flash_attention(q32, k32, v32, **kw), iters=3)
            del q32, k32, v32
            flops, nbytes = _flash_work(b, t, s, h, kv, d, 2, **kw)
            bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
            extra[label] = {"ms": ms, "events_ms": events_ms, "flops": flops,
                            "bytes": nbytes, "bound_ms": bound,
                            "fma_f32_events_ms": fma_ms}
            print(f"  flash_attn [{label}]: kernel {_ms(ms)} (profiler), "
                  f"{events_ms:.4f} ms (events over 5 back-to-back calls) "
                  f"against a bound of {bound * 1e3:.3f} us "
                  f"({flops / 1e9:.3f} GFLOP), {bound / events_ms:.2%} of "
                  f"it; the float32 FMA body on the same inputs "
                  f"{fma_ms:.4f} ms (events over 3 calls)")
        if label == fcases[0][0]:
            main = (q, k, v)
        del q, k, v, got, want
    q, k, v = main
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in main)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)

    library_ms = time_cuda(sdpa)
    sdpa_err = float((sdpa().transpose(1, 2).float()
                      - flash_attention_plain(q, k, v).float()).abs().max())
    print(f"  flash_attn yardstick scaled_dot_product_attention(is_causal, "
          f"enable_gqa) on granite's shape: {library_ms:.4f} ms, max abs "
          f"err against the plain version {sdpa_err:.3e}")
    flops, nbytes = _flash_work(*granite, 2, causal=True)
    q32, k32, v32 = (x.float() for x in main)
    fma_ms = kernel_device_ms(lambda: flash_attention(q32, k32, v32),
                              FLASH_KERNELS)
    print(f"  flash_attn [granite 4096 causal]: the float32 FMA body on the "
          f"same inputs {_ms(fma_ms)} (profiler)")
    del q32, k32, v32
    out["flash_attn"] = record(
        "flash_attn", worst,
        *timings(lambda: flash_attention(q, k, v),
                 lambda: flash_attention_plain(q, k, v), FLASH_KERNELS),
        "granite 4096 causal, bf16 (B 1, T = S 4096, H 24, KV 8, D 64)",
        flops, nbytes, library_ms=library_ms, peak_flops=PEAK_BF16_FLOPS,
        err_bound="f32: rtol 0.0002, atol 2e-05; bf16: one bf16 ulp more",
        sdpa_err_vs_plain=sdpa_err, gemma2=extra,
        plan=flash_attention_plan(q, k, v), fma_f32_ms=fma_ms,
        events_ms=time_cuda_batch(lambda: flash_attention(q, k, v)))
    del main, q, k, v, qt, kt, vt

    # ---- wkv6
    def wkv_in(b, t, h, kd, vd, dtype):
        r, k = (randn((b, t, h, kd), 0.5).to(dtype) for _ in range(2))
        v = randn((b, t, h, vd), 0.5).to(dtype)
        w = torch.sigmoid(randn((b, t, h, kd)))
        return r, k, v, w, randn((h, kd), 0.1), randn((b, h, kd, vd), 0.5)

    served = WKV_SERVED
    wcases = [("served bf16 r/k/v, zero state", served, bf16, False),
              ("served f32, zero state", served, f32, False),
              ("served bf16, given state", served, bf16, True),
              ("decode T 1 bf16, given state",
               (served[0], 1) + served[2:], bf16, True),
              ("odd B 3 T 37 H 5 K 24 V 40 f32, given state",
               (3, 37, 5, 24, 40), f32, True)]
    worst = 0.0
    for label, shape, dtype, with_state in wcases:
        _print_wkv_plan(label, shape, dtype)
        r, k, v, w, u, s0 = wkv_in(*shape, dtype)
        s0 = s0 if with_state else None
        if shape[1] == 1:
            decode = (r, k, v, w, u, s0)
        got, want = wkv6_state(r, k, v, w, u, s0), \
            wkv6_state_plain(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        worst = max(worst, _held("wkv6", label + ": o", got[0], want[0],
                                 SCAN_TOL),
                    _held("wkv6", label + ": final state", got[1], want[1],
                          SCAN_TOL))
        if dtype == bf16 and not with_state:     # the JAX entry: bf16 o
            worst = max(worst, _held("wkv6", label + ": wkv6() bf16 o",
                                     wkv6(r, k, v, w, u),
                                     wkv6_plain(r, k, v, w, u), SCAN_TOL,
                                     bf16=True))
            main = (r, k, v, w, u)
    flops, nbytes = _wkv_work(*served, 2)
    # the decode shape (T 1, given state): events around back-to-back
    # launches replayed from a CUDA graph (no host gaps), and the profiler
    dflops, dbytes = _wkv_work(served[0], 1, *served[2:], 2, state=True)
    dbound = max(dflops / PEAK_F32_FLOPS, dbytes / PEAK_BYTES) * 1e3
    decode_ms = {"events_graph": time_cuda_graph(
        lambda: wkv6_state(*decode)), "profiler": kernel_device_ms(
        lambda: wkv6_state(*decode), "wkv6_kernel"), "bound": dbound}
    print(f"  wkv6 decode (B 4, T 1, H 64, K = V 64, bf16, given state): "
          f"{decode_ms['events_graph']:.5f} ms (CUDA events around 50 "
          f"launches in a CUDA graph), {decode_ms['profiler']} ms "
          f"(profiler); bound {dbound * 1e3:.3f} us (bytes: "
          f"{dbytes / 1e6:.3f} MB)")
    out["wkv6"] = record(
        "wkv6", worst,
        *timings(lambda: wkv6_state(*main), lambda: wkv6_state_plain(*main),
                 "wkv6_kernel"),
        "served bf16 r/k/v, float32 w and o (B 4, T 512, H 64, K = V 64)",
        flops, nbytes, err_bound="rtol 0.0001, atol 1e-05 (bf16 o: one "
        "bf16 ulp more)", events_ms=time_cuda_batch(lambda: wkv6_state(*main)),
        decode_ms=decode_ms)
    print(f"  wkv6 served prefill: CUDA events around 10 back-to-back "
          f"calls {out['wkv6']['events_ms']:.4f} ms")
    del main, decode

    # ---- mamba_selective_scan
    def mamba_in(bsz, t, din, n, dtype):
        dt = torch.nn.functional.softplus(randn((bsz, t, din))) * 0.1
        x = randn((bsz, t, din))
        b, c = (randn((bsz, t, n), 0.5) for _ in range(2))
        a = -torch.exp(randn((din, n), 0.3))
        return (dt.to(dtype), x.to(dtype), b, c, a, randn((din,)),
                randn((bsz, din, n), 0.5))

    jamba = MAMBA_SERVED
    mcases = [("Jamba block f32, zero state", jamba, f32, False),
              ("Jamba block bf16 dt/x, zero state", jamba, bf16, False),
              ("Jamba block f32, given state", jamba, f32, True),
              ("decode T 1 f32, given state", (jamba[0], 1) + jamba[2:],
               f32, True),
              ("odd B 3 T 37 Din 200 N 5 bf16, given state", (3, 37, 200, 5),
               bf16, True)]
    worst = 0.0
    for label, shape, dtype, with_state in mcases:
        plan = _print_mamba_plan(label, shape, dtype)
        dt, x, b, c, a, d, h0 = mamba_in(*shape, dtype)
        h0 = h0 if with_state else None
        got = mamba_selective_scan_state(dt, x, b, c, a, d, h0)
        want = mamba_selective_scan_state_plain(dt, x, b, c, a, d, h0)
        torch.cuda.synchronize()
        worst = max(worst, _held("mamba_scan", label + ": y", got[0],
                                 want[0], SCAN_TOL),
                    _held("mamba_scan", label + ": final state", got[1],
                          want[1], SCAN_TOL))
        if dtype == bf16 and not with_state:     # the JAX entry: bf16 y
            worst = max(worst, _held(
                "mamba_scan", label + ": mamba_selective_scan() bf16 y",
                mamba_selective_scan(dt, x, b, c, a, d),
                mamba_selective_scan_plain(dt, x, b, c, a, d), SCAN_TOL,
                bf16=True))
        if label == mcases[0][0]:
            main, main_plan = (dt, x, b, c, a, d), plan
        del dt, x, b, c, a, d, h0, got, want
    flops, nbytes = _mamba_work(*jamba, 4)
    out["mamba_scan"] = record(
        "mamba_scan", worst,
        *timings(lambda: mamba_selective_scan_state(*main),
                 lambda: mamba_selective_scan_state_plain(*main),
                 "mamba_scan_kernel"),
        "Jamba block f32 (B 2, T 2048, Din 16384, N 16)", flops, nbytes,
        err_bound="rtol 0.0001, atol 1e-05 (bf16 y: one bf16 ulp more)",
        events_ms=time_cuda_batch(
            lambda: mamba_selective_scan_state(*main)), plan=main_plan,
        bit_identical=_parent_check("mamba_scan"))
    del main
    torch.cuda.empty_cache()
    return out


def _capture(module, name, keep):
    """Swap `module.name` for a wrapper that calls it and keeps its
    arguments in `keep` when `keep` asks for this call; returns the
    restore function."""
    real = getattr(module, name)
    calls = [0]

    def wrapper(*args, **kwargs):
        if calls[0] in keep["calls"]:
            keep["args"].append((args, kwargs))
        calls[0] += 1
        return real(*args, **kwargs)

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, real)


def _serve_timings(params, cfg, prompt, n_new, symbol):
    """Prefill and the decode steps timed alone (each ended by a
    synchronize), then a profiled `greedy_generate` and a profiled decode
    step; `symbol` names the kernel whose device time is split out.
    Returns (report entries, the prefill's last logits)."""
    from repro_torch.serve.step import (build_decode_step,
                                        build_prefill_step, greedy_generate)

    prefill, decode = build_prefill_step(cfg), build_decode_step(cfg)
    t0 = time.perf_counter()
    last, caches, pos = prefill(params, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    assert torch.isfinite(last).all()
    nxt = torch.argmax(last, -1)
    step_s = []
    for _ in range(n_new - 1):
        t0 = time.perf_counter()
        logits, caches, pos = decode(params, nxt[:, None], caches, pos)
        nxt = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    assert torch.isfinite(logits).all()
    wall, busy, kern_s, n_launch, top = _profile_busy(
        lambda: greedy_generate(params, cfg, prompt, max_new=n_new,
                                device=prompt.device), symbol)
    step_prof = _profile_busy(
        lambda: decode(params, nxt[:, None], caches, pos), symbol)
    b, s = prompt.shape
    decode_ms = 1e3 * statistics.fmean(step_s)
    return {"prefill_ms": 1e3 * prefill_s,
            "prefill_tokens_per_s": b * s / prefill_s,
            "decode_ms_per_step": decode_ms,
            "decode_step_ms": [1e3 * x for x in step_s],
            "decode_tokens_per_s": b / (decode_ms / 1e3),
            "profiled_wall_s": wall, "device_busy_s": busy,
            "idle_share": 1 - busy / wall, "kernel_s": kern_s,
            "host_kernel_launches": n_launch, "top_device": top,
            "decode_step_profile": dict(zip(
                ("wall_s", "device_busy_s", "kernel_s",
                 "host_kernel_launches", "top_device"), step_prof))}, last


def _print_serving(tag, kernel, n_params, cfg, prompt, rep):
    """The serving lines of one model: generate, prefill, decode, the
    profiled run's idle share and the kernel's share of it."""
    b, s = prompt.shape
    sp = rep["decode_step_profile"]
    print(f"{tag} serve: {cfg.name} ({n_params / 1e9:.3f} B params, bf16, "
          f"{cfg.n_layers} layers), {b} x {s}-token prompts, {LM_NEW} greedy "
          f"tokens in {rep['generate_s']:.3f} s ({rep['tokens_per_s']:.1f} "
          f"tokens/s); prefill {rep['prefill_ms']:.3f} ms "
          f"({rep['prefill_tokens_per_s']:.0f} prompt tokens/s), decode "
          f"{rep['decode_ms_per_step']:.3f} ms/step "
          f"({rep['decode_tokens_per_s']:.1f} tokens/s)")
    print(f"{tag} serve profiled run: wall {rep['profiled_wall_s']:.3f} s, "
          f"device busy {rep['device_busy_s']:.3f} s (idle share "
          f"{rep['idle_share']:.4f}), of which the {kernel} kernel "
          f"{rep['kernel_s']:.4f} s; {rep['host_kernel_launches']} kernel "
          f"launches by the host; one decode step: wall "
          f"{1e3 * sp['wall_s']:.3f} ms, device busy "
          f"{1e3 * sp['device_busy_s']:.3f} ms ({kernel} "
          f"{1e3 * sp['kernel_s']:.3f} ms), {sp['host_kernel_launches']} "
          f"kernel launches")
    print(f"{tag} serve profiled run, longest device activities: " + "; ".join(
        f"{name} {t:.4f} s x{c}" for name, t, c in rep["top_device"]))


def rwkv_phases(dev, reset_counts, read_counts, phase):
    """Phases 13-14.

    13 (b): the main path of this slice: rwkv6-7b at full width and depth
       in bf16 (random weights from `torch.Generator` seed 0, drawn on the
       card) serves 4 prompts of 512 tokens from `batch_for_step(seed=17)`
       through `greedy_generate`, 16 new tokens, launch counts zeroed just
       before and read just after (one `wkv6` launch per layer and step:
       512); then the steps timed alone and profiled, and one served
       prefill's last-layer `wkv6` inputs held kernel against plain;
    14 (c): 2 layers at full width in float32, prefill and one decode step
       on the card (kernel) against the CPU (plain): logits within
       LM_F32_ATOL.
    Returns (the phase report, main-path launches)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.kernels.wkv6 import wkv6_state, wkv6_state_plain
    from repro_torch.models import rwkv6 as rwkv_mod
    from repro_torch.models.init import init_params
    from repro_torch.params import params_to, tree_leaves
    from repro_torch.serve.step import (build_decode_step,
                                        build_prefill_step, greedy_generate)

    cfg = get_config(RWKV_ARCH)
    t0 = time.perf_counter()
    params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    rep: dict = {"arch": RWKV_ARCH, "batch": LM_BATCH, "prompt": LM_PROMPT,
                 "new_tokens": LM_NEW, "n_params": n_params,
                 "init_s": time.perf_counter() - t0}
    prompt = torch.from_numpy(batch_for_step(
        cfg, 0, global_batch=LM_BATCH, seq_len=LM_PROMPT,
        seed=17)["tokens"]).to(dev)
    greedy_generate(params, cfg, prompt[:, :16], max_new=2,
                    device=dev)                                   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    toks = greedy_generate(params, cfg, prompt, max_new=LM_NEW, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"rwkv serve launches: {counts}")
    hd = cfg.rwkv_head_dim
    rep["wkv6_plans"] = [
        _print_wkv_plan(label, (LM_BATCH, t, cfg.n_rwkv_heads, hd, hd),
                        torch.bfloat16)
        for label, t in (("rwkv6-7b prefill", LM_PROMPT),
                         ("rwkv6-7b decode", 1))]
    launches = counts["wkv6"]
    assert launches == cfg.n_layers * LM_NEW, counts
    assert sum(counts.values()) == launches, counts
    assert toks.shape == (LM_BATCH, LM_NEW)
    assert int(toks.max()) < cfg.vocab_size and int(toks.min()) >= 0
    rep.update({"generate_s": gen_s,
                "tokens_per_s": LM_BATCH * LM_NEW / gen_s,
                "launches": counts})
    rep.update(_serve_timings(params, cfg, prompt, LM_NEW, "wkv6_kernel")[0])
    _print_serving("rwkv", "wkv6", n_params, cfg, prompt, rep)

    # the last layer's wkv6 inputs in one served prefill, kernel vs plain
    keep = {"calls": {cfg.n_layers - 1}, "args": []}
    restore = _capture(rwkv_mod, "wkv6_state", keep)
    try:
        build_prefill_step(cfg)(params, prompt)
    finally:
        restore()
    (r, k, v, w, u, s0), _ = keep["args"][0]
    assert s0 is None and r.dtype == torch.bfloat16 and w.dtype == \
        torch.float32
    got, want = wkv6_state(r, k, v, w, u), wkv6_state_plain(r, k, v, w, u)
    ref = _wkv6_f64(r, k, v, w, u)
    torch.cuda.synchronize()
    rep["captured_layer_err"] = {
        "o": _held_f64("wkv6", f"served prefill, layer {cfg.n_layers - 1}: "
                       f"o", got[0], want[0], ref[0], SCAN_TOL),
        "state": _held_f64("wkv6", f"served prefill, layer "
                           f"{cfg.n_layers - 1}: final state", got[1],
                           want[1], ref[1], SCAN_TOL)}
    del params, keep, r, k, v, w, u, got, want, ref
    torch.cuda.empty_cache()
    phase("13 (b) rwkv6-7b serving at full width and depth")

    # ---- (c) float32, full width, 2 layers: card against CPU -----------
    cfg32 = cfg.with_(n_layers=2, param_dtype="float32", dtype="float32")
    p32 = init_params(torch.Generator().manual_seed(1), cfg32, device=dev)
    host = params_to(p32, "cpu")
    short = torch.from_numpy(batch_for_step(
        cfg32, 1, global_batch=2, seq_len=64, seed=17)["tokens"])
    prefill, decode = build_prefill_step(cfg32), build_decode_step(cfg32)
    for label, t in (("rwkv6 2-layer float32 prefill", short.shape[1]),
                     ("rwkv6 2-layer float32 decode", 1)):
        _print_wkv_plan(label, (short.shape[0], t, cfg.n_rwkv_heads, hd,
                                hd), torch.float32)
    errs = []
    for_card = prefill(p32, short.to(dev))
    for_host = prefill(host, short)
    errs.append(float((for_card[0].cpu() - for_host[0]).abs().max()))
    nxt = torch.argmax(for_host[0], -1)[:, None]
    card_dec = decode(p32, nxt.to(dev), *for_card[1:])[0]
    host_dec = decode(host, nxt, *for_host[1:])[0]
    errs.append(float((card_dec.cpu() - host_dec).abs().max()))
    print(f"rwkv float32 2 layers, 2 x 64 tokens: card (kernel) vs CPU "
          f"(plain) last logits max abs err {errs[0]:.3e}, after one decode "
          f"step {errs[1]:.3e} (bound {LM_F32_ATOL:g})")
    assert max(errs) <= LM_F32_ATOL, errs
    rep["f32_2layer_err_vs_cpu"] = {"prefill": errs[0], "decode": errs[1]}
    del p32, host, for_card, card_dec
    torch.cuda.empty_cache()
    phase("14 (c) rwkv6 2 layers float32, card against CPU")
    return rep, launches


def long_prompt_phase(dev, params, cfg, reset_counts, read_counts):
    """Phase 15 (d): granite-moe-3b-a800m (the params phase 9 drew) runs
    prefill on one prompt of 4096 tokens: every layer takes the
    long-prompt branch, one `flash_attn` launch each (and one
    `moe_experts`); the last layer's q/k/v are held kernel against plain.
    Then a 2-layer float32 granite at full width with a 2048-token prompt
    on the card (kernel) against the CPU (chunked plain attention):
    last logits within LM_F32_ATOL. Returns (report, launches)."""
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attention_plain)
    from repro_torch.models import layers as layers_mod
    from repro_torch.models.init import init_params
    from repro_torch.params import params_to
    from repro_torch.serve.step import build_prefill_step

    prompt = torch.from_numpy(batch_for_step(
        cfg, 0, global_batch=1, seq_len=LONG_PROMPT, seed=23)["tokens"]
    ).to(dev)
    prefill = build_prefill_step(cfg)
    prefill(params, prompt)                                       # warm-up
    keep = {"calls": {cfg.n_layers - 1}, "args": []}
    restore = _capture(layers_mod, "flash_attention", keep)
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        last = prefill(params, prompt)[0]
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        counts = read_counts()
    finally:
        restore()
    print(f"long prompt launches: {counts}")
    launches = counts["flash_attn"]
    assert launches == cfg.n_layers, counts
    assert counts["moe_experts"] == cfg.n_layers, counts
    assert sum(counts.values()) == 2 * cfg.n_layers, counts
    assert torch.isfinite(last).all()
    (q, k, v), kw = keep["args"][0]
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    err = _held_f64("flash_attn", f"served 4096-token prefill, layer "
                    f"{cfg.n_layers - 1}", got, want,
                    _flash_f64(q, k, v, **kw), FLASH_TOL)
    rep = {"arch": LM_ARCH, "prompt": LONG_PROMPT, "prefill_ms": 1e3 * pre_s,
           "prefill_tokens_per_s": LONG_PROMPT / pre_s, "launches": counts,
           "captured_layer_err": err}
    print(f"long prompt: {LM_ARCH} prefill of 1 x {LONG_PROMPT} tokens in "
          f"{1e3 * pre_s:.3f} ms ({LONG_PROMPT / pre_s:.0f} prompt "
          f"tokens/s)")
    del keep, q, k, v, got, want

    # ---- float32, full width, 2 layers, a long prompt: card vs CPU -----
    from repro_torch.models.layers import CHUNK_THRESHOLD

    cfg32 = cfg.with_(n_layers=2, param_dtype="float32", dtype="float32")
    p32 = init_params(torch.Generator().manual_seed(1), cfg32, device=dev)
    toks = torch.from_numpy(batch_for_step(
        cfg32, 1, global_batch=1, seq_len=CHUNK_THRESHOLD,
        seed=17)["tokens"])
    step32 = build_prefill_step(cfg32)
    before = flash_attention.launches
    card_last = step32(p32, toks.to(dev))[0]
    assert flash_attention.launches - before == cfg32.n_layers
    host_last = step32(params_to(p32, "cpu"), toks)[0]
    err32 = float((card_last.cpu() - host_last).abs().max())
    print(f"long prompt float32 2 layers, 1 x {CHUNK_THRESHOLD} tokens: card "
          f"(flash kernel) vs CPU (chunked plain) last logits max abs err "
          f"{err32:.3e} (bound {LM_F32_ATOL:g})")
    assert err32 <= LM_F32_ATOL, err32
    rep["f32_2layer_err_vs_cpu"] = err32
    del p32
    torch.cuda.empty_cache()
    return rep, launches


def mamba_block_phase(dev, reset_counts, read_counts):
    """Phase 16 (e): Jamba's first layer (a Mamba block with its dense
    FFN) at full width in bf16 through `lm.apply_block`: a prefill of
    B 2 x T 2048, then 16 single-token steps against the carried conv /
    ssm state (one `mamba_scan` launch each: 17). The prefill's and the
    first decode step's scan inputs are held kernel against plain.
    Returns (report, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_scan import (
        mamba_selective_scan_state, mamba_selective_scan_state_plain)
    from repro_torch.models import lm
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models.init import _Draw, init_block
    from repro_torch.params import tree_leaves

    cfg = get_config(JAMBA_ARCH)
    kind, is_moe = cfg.layer_kinds()[0], cfg.layer_is_moe()[0]
    assert kind == "mamba" and not is_moe
    p = init_block(_Draw(torch.Generator().manual_seed(3), dev), cfg, kind,
                   is_moe, torch.bfloat16)
    n_mamba = sum(t.numel() for t in tree_leaves(p["mamba"]))
    g = torch.Generator(device=dev).manual_seed(8)
    d = cfg.d_model
    x = torch.randn((MAMBA_BATCH, MAMBA_PROMPT, d), device=dev,
                    generator=g).to(torch.bfloat16)
    steps = torch.randn((MAMBA_STEPS, MAMBA_BATCH, 1, d), device=dev,
                        generator=g).to(torch.bfloat16)
    pos = torch.arange(MAMBA_PROMPT, dtype=torch.int32,
                       device=dev).expand(MAMBA_BATCH, MAMBA_PROMPT)
    step_pos = torch.full((MAMBA_BATCH, 1), MAMBA_PROMPT, dtype=torch.int32,
                          device=dev)

    def block(h, cache=None):
        return lm.apply_block(p, h, cfg, kind, is_moe,
                              positions=pos if cache is None else step_pos,
                              cache=cache)

    with torch.inference_mode():
        block(x[:, :64])                                          # warm-up
        keep = {"calls": {0, 1}, "args": []}
        restore = _capture(mamba_mod, "mamba_selective_scan_state", keep)
        try:
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            y, cache, _ = block(x)
            torch.cuda.synchronize()
            pre_s = time.perf_counter() - t0
            step_s = []
            for i in range(MAMBA_STEPS):
                t0 = time.perf_counter()
                y1, cache, _ = block(steps[i], cache)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
            counts = read_counts()
        finally:
            restore()
    print(f"mamba block launches: {counts}")
    launches = counts["mamba_scan"]
    assert launches == 1 + MAMBA_STEPS and sum(counts.values()) == launches
    assert y.shape == x.shape and y1.shape == steps[0].shape
    assert torch.isfinite(y.float()).all() and torch.isfinite(
        y1.float()).all()
    st = cache["mamba"]
    assert st["ssm"].dtype == torch.float32 and torch.isfinite(
        st["ssm"]).all()
    errs = {}
    for (args, kw), label in zip(keep["args"], ("prefill", "decode step 1")):
        assert (args[-1] is None) == (label == "prefill")
        _print_mamba_plan(f"Jamba block {label}",
                          (*args[0].shape, args[2].shape[-1]), args[0].dtype)
        got = mamba_selective_scan_state(*args, **kw)
        want = mamba_selective_scan_state_plain(*args, **kw)
        ref = _mamba_f64(*args, **kw)
        errs[label] = {
            "y": _held_f64("mamba_scan", f"Jamba block {label}: y", got[0],
                           want[0], ref[0], SCAN_TOL),
            "state": _held_f64("mamba_scan", f"Jamba block {label}: final "
                               f"state", got[1], want[1], ref[1], SCAN_TOL)}
    # one T = 1 launch on the captured decode-step inputs: events around a
    # CUDA graph of 50 back-to-back launches, and the profiler
    args, kw = keep["args"][1]
    dt = args[0]
    dflops, dbytes = _mamba_work(dt.shape[0], dt.shape[1], dt.shape[2],
                                 args[2].shape[-1], dt.element_size(),
                                 state=True)
    scan_decode = {
        "events_graph": time_cuda_graph(
            lambda: mamba_selective_scan_state(*args, **kw)),
        "profiler": kernel_device_ms(
            lambda: mamba_selective_scan_state(*args, **kw),
            "mamba_scan_kernel"),
        "bound": max(dflops / PEAK_F32_FLOPS, dbytes / PEAK_BYTES) * 1e3,
        "bound_by": "operations" if dflops / PEAK_F32_FLOPS
        >= dbytes / PEAK_BYTES else "bytes", "bytes": dbytes,
        "shape": [*dt.shape, args[2].shape[-1]], "dtype": str(dt.dtype)}
    print(f"mamba_scan decode launch (B {dt.shape[0]}, T 1, Din "
          f"{dt.shape[2]}, N {args[2].shape[-1]}, {dt.dtype}, given state): "
          f"{scan_decode['events_graph']:.5f} ms (CUDA events around 50 "
          f"launches in a CUDA graph), {scan_decode['profiler']} ms "
          f"(profiler); bound {scan_decode['bound'] * 1e3:.3f} us "
          f"({scan_decode['bound_by']}: {dbytes / 1e6:.3f} MB)")
    decode_ms = 1e3 * statistics.fmean(step_s)
    rep = {"arch": JAMBA_ARCH, "layer": "0 (mamba, dense FFN)",
           "mamba_params": n_mamba, "batch": MAMBA_BATCH,
           "prompt": MAMBA_PROMPT, "steps": MAMBA_STEPS,
           "prefill_ms": 1e3 * pre_s, "decode_ms_per_step": decode_ms,
           "decode_step_ms": [1e3 * s for s in step_s], "launches": counts,
           "captured_err": errs, "scan_decode_ms": scan_decode}
    print(f"mamba block: {JAMBA_ARCH} layer 0 ({n_mamba / 1e9:.3f} B Mamba "
          f"params, d_inner {cfg.mamba_d_inner}, N {cfg.mamba_d_state}, "
          f"dt_rank {cfg.dt_rank}, bf16): prefill {MAMBA_BATCH} x "
          f"{MAMBA_PROMPT} tokens {1e3 * pre_s:.3f} ms, decode "
          f"{decode_ms:.3f} ms/step over {MAMBA_STEPS} steps")
    del p, x, steps, cache, keep
    torch.cuda.empty_cache()
    return rep, launches


def hybrid_phase(dev, reset_counts, read_counts):
    """Phase 17 (f): the reduced Jamba hybrid (`reduced_config`: 16 layers
    of mamba, attention and MoE) in float32 with `moe_use_kernel`, params
    drawn on the CPU and copied: `greedy_generate` of 8 tokens after 2
    prompts of 2048 tokens (long enough for the flash kernel) on the card
    (kernels) and on the CPU (plain): tokens equal, prefill logits within
    LM_F32_ATOL. Returns the report."""
    from repro_torch.configs import reduced_config
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.models.init import init_params
    from repro_torch.params import params_to
    from repro_torch.serve.step import build_prefill_step, greedy_generate

    cfg = reduced_config(JAMBA_ARCH).with_(moe_use_kernel=True)
    host = init_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    card = params_to(host, dev)
    prompt = torch.from_numpy(batch_for_step(
        cfg, 0, global_batch=2, seq_len=HYBRID_PROMPT, seed=29)["tokens"])
    reset_counts()
    card_toks = greedy_generate(card, cfg, prompt, max_new=HYBRID_NEW,
                                device=dev)
    counts = read_counts()
    kinds = cfg.layer_kinds() * cfg.n_groups
    n_moe = sum(cfg.layer_is_moe()) * cfg.n_groups
    assert counts["mamba_scan"] == HYBRID_NEW * kinds.count("mamba"), counts
    assert counts["flash_attn"] == kinds.count("attn"), counts
    assert counts["moe_experts"] == HYBRID_NEW * n_moe, counts
    host_toks = greedy_generate(host, cfg, prompt, max_new=HYBRID_NEW,
                                device="cpu")
    same = bool(torch.equal(card_toks.cpu(), host_toks))
    step = build_prefill_step(cfg)
    err = float((step(card, prompt.to(dev))[0].cpu()
                 - step(host, prompt)[0]).abs().max())
    print(f"hybrid: reduced {JAMBA_ARCH} ({cfg.n_layers} layers: "
          f"{kinds.count('mamba')} mamba, {kinds.count('attn')} attention, "
          f"{n_moe} MoE; float32), 2 x {HYBRID_PROMPT}-token prompts, "
          f"{HYBRID_NEW} tokens: launches {counts}; tokens equal to the "
          f"CPU's {same}; prefill logits max abs err {err:.3e} (bound "
          f"{LM_F32_ATOL:g})")
    assert same and err <= LM_F32_ATOL, (same, err)
    return {"arch": JAMBA_ARCH, "layers": cfg.n_layers,
            "prompt": HYBRID_PROMPT, "new_tokens": HYBRID_NEW,
            "launches": counts, "tokens_equal": same,
            "prefill_logits_err_vs_cpu": err}


# ------------------------------------------------ phases 18-19: SimGNN-AIDS


def _workloads() -> list:
    """Phase 18's workloads: `search_pairs` at every size of PLANNER_SIZES
    and every degree of PLANNER_DEGREES (None: the AIDS degree)."""
    from repro_torch.data.graphs import search_pairs

    return [(f"n{n} deg {'aids' if d is None else d}",
             search_pairs(400 + 10 * i + j, n, avg_degree=d))
            for i, n in enumerate(PLANNER_SIZES)
            for j, d in enumerate(PLANNER_DEGREES)]


def _crossovers(model, rows, mean_nodes: float, degree: float,
                n_pairs: int = 256) -> dict:
    """The crossovers the fitted model implies, at the AIDS workload's mean
    nodes and degree: the pair counts (1..4096) where bucketed_mega is the
    argmin, and where packed_sparse is predicted faster than packed_dense
    at `n_pairs` pairs as a function of the degree (each prediction is
    linear in it: faster below or above the degree where they meet, or at
    no degree >= 0). Beside them, the measured ones: the workloads where
    each path had the fastest median."""
    from repro_torch.core.profile import trace_features

    def argmin(n):
        f = trace_features(n, mean_nodes, degree)
        return min(PLANNER_CANDIDATES, key=lambda p: model.predict(p, f))
    bucketed = [n for n in range(1, 4097) if argmin(n) == "bucketed_mega"]
    ws, wd = (model.weights[p] for p in ("packed_sparse", "packed_dense"))
    nodes = 2.0 * n_pairs * mean_nodes
    # predicted sparse - dense = b + a * degree
    a = (ws[3] - wd[3]) * nodes
    b = (ws[0] - wd[0]) + (ws[1] - wd[1]) * n_pairs + (ws[2] - wd[2]) * nodes
    meet = -b / a if a else None
    if meet is None:
        sparse = "at every degree" if b < 0 else "at no degree"
    elif a > 0:
        sparse = (f"below degree {meet:.3f}" if meet > 0
                  else "at no degree >= 0")
    else:
        sparse = (f"above degree {meet:.3f}" if meet > 0
                  else "at every degree >= 0")
    fastest = {p: [r["workload"] for r in rows if r["best"] == p]
               for p in PLANNER_CANDIDATES}
    return {"bucketed_argmin_pairs": (bucketed[0], bucketed[-1], len(bucketed))
            if bucketed else None,
            "sparse_faster_at_256": sparse, "degree_where_equal": meet,
            "measured_fastest": fastest,
            "at_mean_nodes": mean_nodes, "at_degree": degree}


def planner_phase(params, dev, reset_counts, read_counts) -> dict:
    """Phase 18: the measured planner on the card at SimGNN-AIDS width.

    Capture: one forced engine per candidate (`planner="threshold"`,
    `degrade=False`, `validation="off"`) shares one `TraceRecorder` that
    flushes into a temporary directory; each workload is scored once
    unrecorded (warm) and PLANNER_REPS times recorded. Fit: the profile is
    loaded back and fitted. Replay: a fresh auto engine with
    `planner="measured"` on the loaded recorder scores every workload;
    its pick, each path's predicted and measured median ms, the share of
    picks within PLANNER_MARGIN of the measured best, each path's median
    prediction error and the crossovers the fit implies are printed, not
    gated. Gates: the warm engine's scores equal the picked path's forced
    engine's bit for bit and the port's plain path on the CPU within
    1e-6, its reason names the cost model, nothing degraded."""
    import os
    import tempfile

    from repro_torch.configs.simgnn_aids import CONFIG as CFG
    from repro_torch.core.engine import ScoringEngine
    from repro_torch.core.profile import TraceRecorder, fit_cost_model

    workloads = _workloads()
    forced = {p: ScoringEngine(params, CFG, path=p, planner="threshold",
                               degrade=False, validation="off", device=dev)
              for p in PLANNER_CANDIDATES}
    walls: dict = {}
    outs: dict = {}
    with tempfile.TemporaryDirectory(prefix="profile") as tmp:
        path = os.path.join(tmp, "profile.jsonl")
        rec = TraceRecorder(path=path)
        reset_counts()
        for p, eng in forced.items():
            for name, pairs in workloads:
                eng.recorder = None
                eng.score(pairs)                    # warm, unrecorded
                eng.recorder = rec
                for _ in range(PLANNER_REPS):
                    n0 = rec.total_records
                    out = eng.score(pairs)
                    assert rec.total_records == n0 + 1, (p, name)
                    r = rec.records()[-1]
                    assert r.path == p and not r.degraded_from, r
                    walls.setdefault((name, p), []).append(r.wall_s)
                outs[(name, p)] = out
        capture_counts = read_counts()
        print(f"planner capture: {len(workloads)} workloads x "
              f"{len(PLANNER_CANDIDATES)} forced paths x {PLANNER_REPS} "
              f"recorded calls = {rec.total_records} records; launches "
              f"{capture_counts}")
        for name in ("sparse_pair", "packed_pair", "fused_pair"):
            assert capture_counts[name] > 0, capture_counts
        assert sum(capture_counts.values()) == sum(
            capture_counts[k] for k in ("sparse_pair", "packed_pair",
                                        "fused_pair")), capture_counts
        flushed = rec.flush()
        assert flushed == rec.total_records and \
            not rec.counters["flush_errors"], rec.counters
        loaded = TraceRecorder.load(path)
        assert loaded.total_records == flushed and \
            not loaded.counters["records_dropped"], loaded.counters
        t0 = time.perf_counter()
        model = fit_cost_model(loaded.records(),
                               min_support=ScoringEngine.PLANNER_MIN_SUPPORT)
        fit_ms = 1e3 * (time.perf_counter() - t0)
        print(f"planner fit: {fit_ms:.3f} ms for {model.n_records} records "
              f"(profile of {os.path.getsize(path)} bytes, format v2)")
        for p in PLANNER_CANDIDATES:
            w = model.weights[p]
            print(f"  {p}: support {model.support[p]}, residual_medape "
                  f"{model.residual_medape[p]:.4f}, weights " + ", ".join(
                      f"{f} {v:.6g}" for f, v in zip(
                          ("bias s", "s/pair", "s/node", "s/edge",
                           "s/embed"), w)))
        # the record call's cost alone: a scratch recorder, no flush
        scratch = TraceRecorder()
        t0 = time.perf_counter()
        for i in range(2000):
            scratch.record(kind="score", path="packed_sparse", n_pairs=256,
                           max_nodes=64, mean_nodes=25.6, avg_degree=2.1,
                           density=0.08, occupancy=0.8, wall_s=1e-3)
        record_us = 1e6 * (time.perf_counter() - t0) / 2000

        auto = ScoringEngine(params, CFG, recorder=loaded,
                             planner="measured", device=dev)
        cpu = {p: ScoringEngine(params, CFG, path=p, planner="threshold",
                                device="cpu") for p in PLANNER_CANDIDATES}
        rows, worst_cpu = [], 0.0
        reset_counts()
        for name, pairs in workloads:
            got = auto.score(pairs)
            plan = auto.last_plan
            assert "cost model" in plan.reason, (name, plan.reason)
            assert plan.degraded_from == () and plan.attempts == 1, plan
            assert set(plan.cost_estimates) == set(PLANNER_CANDIDATES), plan
            want = outs[(name, plan.path)]
            assert got.tobytes() == want.tobytes(), (name, plan.path)
            err = float(np.abs(got - cpu[plan.path].score(pairs)).max())
            assert err <= 1e-6, (name, plan.path, err)
            worst_cpu = max(worst_cpu, err)
            measured = {p: statistics.median(walls[(name, p)])
                        for p in PLANNER_CANDIDATES}
            rows.append({"workload": name, "pick": plan.path,
                         "pred_ms": {p: 1e3 * v for p, v in
                                     plan.cost_estimates.items()},
                         "measured_ms": {p: 1e3 * v for p, v in
                                         measured.items()},
                         "avg_degree": plan.stats.avg_degree,
                         "mean_nodes": plan.stats.mean_nodes})
        replay_counts = read_counts()
    print(f"planner replay: launches {replay_counts}")
    assert sum(replay_counts.values()) > 0
    for r in rows:
        best = min(r["measured_ms"], key=r["measured_ms"].get)
        r["best"] = best
        r["pick_over_best"] = r["measured_ms"][r["pick"]] / \
            r["measured_ms"][best]
        print(f"  {r['workload']} (degree {r['avg_degree']:.2f}): picks "
              f"{r['pick']} ({r['pick_over_best']:.3f}x the measured best, "
              f"{best}); predicted / measured ms " + ", ".join(
                  f"{p} {r['pred_ms'][p]:.3f} / {r['measured_ms'][p]:.3f}"
                  for p in PLANNER_CANDIDATES))
    share = statistics.fmean(r["pick_over_best"] <= PLANNER_MARGIN
                             for r in rows)
    err = {p: statistics.median(abs(r["pred_ms"][p] - r["measured_ms"][p])
                                / r["measured_ms"][p] for r in rows)
           for p in PLANNER_CANDIDATES}
    aids = [r for r in rows if r["workload"].endswith("aids")][-1]
    cross = _crossovers(model, rows, aids["mean_nodes"], aids["avg_degree"])
    print(f"planner replay: pick within {PLANNER_MARGIN:.2f}x of the "
          f"measured best on {share:.3f} of {len(rows)} workloads; median "
          f"|pred - measured| / measured " + ", ".join(
              f"{p} {v:.3f}" for p, v in err.items())
          + f"; vs the CPU plain path {worst_cpu:.3e} (bound 1e-06); scores "
          f"equal the picked path's forced engine bit for bit")
    span = cross["bucketed_argmin_pairs"]
    print(f"planner crossovers (fit, at mean nodes {aids['mean_nodes']:.2f},"
          f" degree {aids['avg_degree']:.2f}): bucketed_mega is the argmin "
          + (f"for {span[2]} pair counts in {span[0]}..{span[1]}" if span
             else "at no pair count in 1..4096")
          + f"; at 256 pairs packed_sparse is predicted faster than "
          f"packed_dense {cross['sparse_faster_at_256']}; measured fastest: "
          + "; ".join(f"{p} on {len(w)} workloads"
                      + (f" ({', '.join(w)})" if w else "")
                      for p, w in cross["measured_fastest"].items()))
    print(f"planner record: {record_us:.3f} us a record (ring append, "
          f"2000 records); fit {fit_ms:.3f} ms")
    return {"workloads": rows, "share_within_margin": share,
            "median_rel_err": err, "crossovers": cross,
            "model": model.snapshot(),
            "weights": {p: [float(x) for x in w]
                        for p, w in model.weights.items()},
            "fit_ms": fit_ms, "record_us": record_us,
            "capture_launches": capture_counts,
            "replay_launches": replay_counts, "err_cpu": worst_cpu}


def _tree_err(a, b) -> float:
    """Largest |a - b| over every leaf of two params / grads trees."""
    from repro_torch.params import tree_leaves

    return max(float((x.detach().cpu().float() - y.detach().cpu().float())
                     .abs().max()) for x, y in zip(tree_leaves(a),
                                                   tree_leaves(b)))


def _capture_rules(engine, pairs, target) -> dict:
    """One card `loss_and_grad` with every backward rule's forward inputs
    captured (the rules' `apply` wrapped, restored after): {rule: [args,
    ...]} in call order."""
    from repro_torch.kernels import common

    seen: dict = {}
    saved = {}
    for name, cls_name in RULE_CLASSES.items():
        cls = getattr(common, cls_name)
        saved[name] = cls.apply

        def wrap(*args, _name=name, _real=cls.apply):
            seen.setdefault(_name, []).append(tuple(
                a.detach() if isinstance(a, torch.Tensor) else a
                for a in args))
            return _real(*args)
        cls.apply = wrap
    try:
        engine.loss_and_grad(pairs, target)
    finally:
        for name, cls_name in RULE_CLASSES.items():
            getattr(common, cls_name).apply = saved[name]
    assert all(args[-1] is True for args in seen["csr_aggregate_block_sym"])
    return seen


def _time_backward(fn, args, diff, iters: int = 20) -> float:
    """Median ms of one backward pass of `fn(*args)` alone (CUDA events,
    warm), with grads of the args at `diff` and a fixed random
    cotangent."""
    leaves = [a.clone().requires_grad_(True) if i in diff else a
              for i, a in enumerate(args)]
    out = fn(*leaves)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0)
                    ).to(out.device)
    wanted = [leaves[i] for i in diff]
    torch.autograd.grad(out, wanted, g, retain_graph=True)     # warm
    times = []
    for _ in range(iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        torch.autograd.grad(out, wanted, g, retain_graph=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _rule_cases(seen) -> dict:
    """Each rule's timed call at the served shapes, the plain autograd of
    the same function, and its work: {rule: (custom fn, args, diff, plain
    fn, flops, bytes)}. The edge and overflow rules (not on the sparse
    training path) take the served CSR planes as an explicit edge list
    and the served overflow list."""
    from repro_torch.kernels import common

    lab = seen["label_gather"][0]
    csr = seen["csr_aggregate_block_sym"][0]
    pool = seen["segment_att_pool_block"][0]
    nbr, nbr_w, ov_snd, ov_rcv, ov_w, hw, _ = csr
    gb, n, f = hw.shape
    rcv = common._ell_receivers(nbr, n).contiguous()
    nnz = int((nbr_w != 0).sum())
    nnz_ov = int((ov_w != 0).sum())
    idx = 2                                     # bytes of an int16 plane
    csr_bytes = (nbr.numel() * idx + nbr_w.numel() * 4
                 + ov_snd.numel() * 2 * idx + ov_w.numel() * 4
                 + 2 * hw.numel() * 4)
    w, labels = lab
    m = labels.numel()
    h, mask, seg, att_w, p = pool
    live = int(mask.sum())
    p_live = int(torch.unique(seg[mask > 0] + p * torch.arange(
        gb, device=seg.device)[:, None].expand_as(seg)[mask > 0]).numel())

    def plain_csr(nbr, nbr_w, ov_snd, ov_rcv, ov_w, hw):
        return common._csr_aggregate(nbr, nbr_w, ov_snd, ov_rcv, ov_w, hw)

    def plain_pool(h, mask, seg, att_w):
        return common._seg_att_pool_from_onehot(
            h, mask, common.segment_onehot(seg, mask, p), att_w)
    return {
        "label_gather": (common.label_gather, (w, labels), (0,),
                         lambda w, labels: w.float()[labels.long()],
                         2.0 * m * w.shape[1],
                         labels.numel() * 4 + (m + w.shape[0]) *
                         w.shape[1] * 4),
        "csr_aggregate_block_sym": (
            common.csr_aggregate_block_sym, csr[:6], (5,), plain_csr,
            2.0 * (nnz + nnz_ov) * f, csr_bytes),
        "csr_aggregate_block": (
            common.csr_aggregate_block, csr[:6], (5,), plain_csr,
            2.0 * (nnz + nnz_ov) * f, csr_bytes),
        "edge_aggregate_block": (
            common.edge_aggregate_block, (nbr, rcv, nbr_w, hw), (3,),
            common._overflow_aggregate, 2.0 * nnz * f,
            nbr.numel() * 2 * idx + nbr_w.numel() * 4 + 2 * hw.numel() * 4),
        "overflow_aggregate_block": (
            common.overflow_aggregate_block, (ov_snd, ov_rcv, ov_w, hw),
            (3,), common._overflow_aggregate, 2.0 * nnz_ov * f,
            ov_snd.numel() * 2 * idx + ov_w.numel() * 4
            + 2 * hw.numel() * 4),
        "segment_att_pool_block": (
            lambda h, mask, seg, att_w: common.segment_att_pool_block(
                h, mask, seg, att_w, p), (h, mask, seg, att_w), (0, 3),
            plain_pool,
            # the backward of pooling, attention and the segment means over
            # live nodes (~3 x the forward's 7 flops a live (node, feature))
            # and the context product over live slots (3 x 2 P F^2)
            3.0 * (7.0 * live * f + 2.0 * p_live * f * f),
            (2 * h.numel() + mask.numel() + seg.numel() + 2 * att_w.numel()
             + gb * p * f) * 4),
    }


def train_phase(params, dev, reset_counts, read_counts) -> dict:
    """Phase 19: SimGNN training on the card at SimGNN-AIDS width.

    An auto engine on the card and one on the CPU from the same params;
    batches `pair_stream(TRAIN_SEED, batch=TRAIN_BATCH)`. Gates: the first
    batch plans `packed_sparse` (the AIDS degree is at most 4), loss within
    1e-6 relative and every gradient leaf within GRAD_ATOL_F32 of the CPU;
    `packed_dense` and `reference` forced once each with the same bounds;
    `accum_steps=4` equal to one shot within 1e-6; two card runs bit-equal;
    TRAIN_STEPS steps of `build_simgnn_train_step` within
    TRAIN_PARAM_BOUND of the CPU's params; no scoring kernel launched and
    no train rung degraded; a NaN target dropped and counted; a step with
    NaN injected at `train:packed_sparse` (and the rungs below it) skipped
    with params and state unchanged. Printed: the loss curve, step ms split
    by CUDA events into `loss_and_grad` and the optimizer half, the
    profiler's idle share, and each backward rule alone against its bound
    and plain autograd."""
    from repro_torch.configs.simgnn_aids import CONFIG as CFG
    from repro_torch.core.engine import ScoringEngine
    from repro_torch.data.graphs import pair_stream
    from repro_torch.params import tree_leaves
    from repro_torch.testing import faults
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import build_simgnn_train_step

    stream = pair_stream(TRAIN_SEED, TRAIN_BATCH, device="cpu")
    batches = [next(stream) for _ in range(TRAIN_STEPS)]
    pairs, target = batches[0]["pairs"], batches[0]["target"]
    card = ScoringEngine(params, CFG, device=dev)
    host = ScoringEngine(params, CFG, device="cpu")
    report: dict = {"batch": TRAIN_BATCH, "steps": TRAIN_STEPS}

    def held(tag, c_eng, h_eng, **kw):
        cl, cg = c_eng.loss_and_grad(pairs, target, **kw)
        hl, hg = h_eng.loss_and_grad(pairs, target, **kw)
        plan = c_eng.last_plan
        assert plan.path == h_eng.last_plan.path and \
            plan.degraded_from == () and h_eng.last_plan.degraded_from == (), \
            (plan, h_eng.last_plan)
        rel = abs(float(cl) - float(hl)) / abs(float(hl))
        gerr = _tree_err(cg, hg)
        print(f"train {tag}: plan {plan.path} ({plan.reason}); loss card "
              f"{float(cl):.8f}, CPU {float(hl):.8f} (relative "
              f"{rel:.3e}, bound 1e-06); largest gradient difference "
              f"{gerr:.3e} (bound {GRAD_ATOL_F32:g})")
        assert rel <= 1e-6 and gerr <= GRAD_ATOL_F32, (tag, rel, gerr)
        report[tag] = {"path": plan.path, "loss_rel": rel, "grad_err": gerr}
        return cl, cg

    reset_counts()
    loss1, grads1 = held("first step", card, host)
    assert card.last_plan.path == "packed_sparse", card.last_plan
    for path in ("packed_dense", "reference"):
        held(f"forced {path}",
             ScoringEngine(params, CFG, path=path, device=dev),
             ScoringEngine(params, CFG, path=path, device="cpu"))
    loss4, grads4 = card.loss_and_grad(pairs, target, accum_steps=4)
    acc = max(abs(float(loss4) - float(loss1)), _tree_err(grads4, grads1))
    print(f"train accumulation: accum_steps 4 against 1, largest "
          f"difference {acc:.3e} (bound 1e-06)")
    assert acc <= 1e-6, acc
    loss2, grads2 = card.loss_and_grad(pairs, target)
    same = torch.equal(loss1, loss2) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(grads1),
                                          tree_leaves(grads2)))
    print(f"train determinism: two card runs of one step bit-equal: {same}")
    assert same
    report["accum_err"], report["deterministic"] = acc, same

    # TRAIN_STEPS steps, card and CPU, from the same params
    events = []
    real = card.loss_and_grad

    def timed(*args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = real(*args, **kw)
        end.record()
        events[-1]["fwd_bwd"] = (start, end)
        return out
    card.loss_and_grad = timed
    step = build_simgnn_train_step(card)
    host_step = build_simgnn_train_step(host)
    cp, hp = card.params, host.params
    cs, hs = adamw_init(cp), adamw_init(hp)
    losses = []
    try:
        for b in batches:
            batch = {"pairs": b["pairs"], "target": b["target"]}
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            events.append({})
            start.record()
            cp, cs, m = step(cp, cs, batch)
            end.record()
            events[-1]["step"] = (start, end)
            assert "skipped" not in m and card.last_plan.degraded_from == (), \
                card.last_plan
            hp, hs, _ = host_step(hp, hs, batch)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
    finally:
        del card.loss_and_grad
    wall, busy, _, n_launch, top = _profile_busy(
        lambda: step(cp, cs, {"pairs": batches[-1]["pairs"],
                              "target": batches[-1]["target"]}), "none")
    counts = read_counts()
    print(f"train launches of the scoring kernels over the phase: {counts}")
    assert not any(counts.values()), counts
    step_ms = [e["step"][0].elapsed_time(e["step"][1]) for e in events]
    fb_ms = [e["fwd_bwd"][0].elapsed_time(e["fwd_bwd"][1]) for e in events]
    opt_ms = [s - f for s, f in zip(step_ms, fb_ms)]
    perr = _tree_err(cp, hp)
    print(f"train {TRAIN_STEPS} steps of {TRAIN_BATCH} pairs: loss curve "
          + ", ".join(f"{x:.5f}" for x in losses))
    print(f"train step (median of steps 2..{TRAIN_STEPS}, CUDA events): "
          f"{statistics.median(step_ms[1:]):.3f} ms, of which loss_and_grad "
          f"{statistics.median(fb_ms[1:]):.3f} ms and the optimizer half "
          f"{statistics.median(opt_ms[1:]):.3f} ms; first step "
          f"{step_ms[0]:.3f} ms")
    print(f"train profiled step: wall {1e3 * wall:.3f} ms, device busy "
          f"{1e3 * busy:.3f} ms (idle share {1 - busy / wall:.4f}), "
          f"{n_launch} kernel launches by the host; longest device "
          "activities: " + "; ".join(f"{name} {1e3 * t:.4f} ms x{c}"
                                     for name, t, c in top))
    print(f"train params after {TRAIN_STEPS} steps, card against CPU: "
          f"largest difference {perr:.3e} (bound {TRAIN_PARAM_BOUND:g})")
    assert perr <= TRAIN_PARAM_BOUND, perr
    report.update(losses=losses, step_ms=step_ms, loss_and_grad_ms=fb_ms,
                  optimizer_ms=opt_ms, profiled_wall_s=wall,
                  device_busy_s=busy, idle_share=1 - busy / wall,
                  host_kernel_launches=n_launch, top_device=top,
                  param_err=perr)

    # the skip path
    poisoned = np.array(target)
    poisoned[3] = np.nan
    card.counters.clear()
    card.loss_and_grad(pairs, poisoned)
    assert card.counters["nonfinite_targets"] == 1, card.counters
    before = [t.clone() for t in tree_leaves((cp, cs))]
    with faults.inject("train:packed_sparse", mode="nan") as fired, \
            faults.inject("train:packed_dense", mode="nan"), \
            faults.inject("train:reference", mode="nan"):
        sp, ss, sm = step(cp, cs, {"pairs": pairs, "target": target})
    unchanged = all(torch.equal(a, b) for a, b in zip(
        before, tree_leaves((sp, ss))))
    print(f"train skip path: a NaN target dropped and counted "
          f"(nonfinite_targets {card.counters['nonfinite_targets']}); NaN "
          f"injected at train:packed_sparse ({fired.triggered} call) and "
          f"the rungs below it (degraded_from "
          f"{card.last_plan.degraded_from}): skipped "
          f"{float(sm.get('skipped', 0))}, train_skipped_steps "
          f"{card.counters['train_skipped_steps']}, params and state "
          f"unchanged: {unchanged}")
    assert float(sm["skipped"]) == 1.0 and unchanged and fired.triggered
    report["skip"] = {"unchanged": unchanged,
                      "degraded_from": card.last_plan.degraded_from}

    # each backward rule alone at the served shapes
    seen = _capture_rules(card, pairs, target)
    rules = {}
    for name, (fn, args, diff, plain, flops, nbytes) in _rule_cases(
            seen).items():
        ms = _time_backward(fn, args, diff)
        plain_ms = _time_backward(plain, args, diff)
        bound_ms = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
        rules[name] = {"ms": ms, "plain_autograd_ms": plain_ms,
                       "bound_ms": bound_ms,
                       "bound_by": "operations" if flops / PEAK_F32_FLOPS
                       > nbytes / PEAK_BYTES else "bytes",
                       "calls_a_step": len(seen.get(name, ())),
                       "flops": flops, "bytes": nbytes,
                       "shape": [tuple(a.shape) for a in args
                                 if isinstance(a, torch.Tensor)]}
        print(f"  backward {name}: {ms:.4f} ms (median of 20, CUDA events), "
              f"plain autograd of the same function {plain_ms:.4f} ms, bound "
              f"{bound_ms * 1e3:.3f} us ({rules[name]['bound_by']}), "
              f"{rules[name]['calls_a_step']} calls a step; shapes "
              f"{rules[name]['shape']}")
    report["backward_rules"] = rules
    return report


def _bit_equal(a, b) -> bool:
    from repro_torch.params import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.cpu(), y.cpu()) for x, y in zip(la, lb))


def launcher_phase(dev, reset_counts, read_counts) -> dict:
    """Phase 20: the training launcher, checkpoints and the examples on the
    card, through the entry points a user runs.

    `python -m repro_torch.launch.train` (SimGNN-AIDS, 128-pair batches,
    LAUNCH_STEPS steps, a checkpoint every LAUNCH_CKPT_EVERY) runs in a
    process of its own with `--simulate-failure LAUNCH_FAIL_AT` and must
    exit with 42; a second process resumes it from its last checkpoint; an
    uninterrupted run goes through `launch.train.main` in this process.
    Gates: the resumed run's final checkpoint restores onto the card
    bit-equal to the uninterrupted run's params and AdamW state, and onto
    the CPU bit-equal too. Then `quickstart` (kernel scores within 1e-6 of
    the plain ones, the embedding and head kernels launched),
    `simgnn_search --kernels --topk 5 --corpus 1024 --mode two_stage` and
    `serve_lm` (tokens equal to the CPU's up to a flip under the CPU's
    top-2 margin LM_F32_ATOL) run on the card. Printed: the step ms
    (median, from the loop's own timing, which synchronizes on the loss),
    save and restore ms of the final checkpoint (median of 5, CUDA
    synchronized), its bytes, and each example's kernel launches."""
    import shutil

    from repro_torch.ckpt import manager as ckpt
    from repro_torch.configs import reduced_config
    from repro_torch.examples import quickstart, serve_lm, simgnn_search
    from repro_torch.launch import train as launch
    from repro_torch.models.init import init_params
    from repro_torch.params import params_to

    work = ROOT / "build" / "launcher_phase"
    _fresh(work)
    report: dict = {"steps": LAUNCH_STEPS, "ckpt_every": LAUNCH_CKPT_EVERY,
                    "fail_at": LAUNCH_FAIL_AT}
    try:
        killed, = _launch_all((work / "killed", "--simulate-failure",
                               str(LAUNCH_FAIL_AT)))
        assert killed.returncode == 42, killed.stdout + killed.stderr
        last = LAUNCH_FAIL_AT // LAUNCH_CKPT_EVERY * LAUNCH_CKPT_EVERY
        left = _listing(work / "killed")
        assert left == [f"step_{last:09d}"], left
        resumed, = _launch_all((work / "killed",))
        assert resumed.returncode == 0, resumed.stdout + resumed.stderr
        assert f"[loop] resumed from step {last}" in resumed.stdout, \
            resumed.stdout
        straight = launch.main(["--steps", str(LAUNCH_STEPS), "--ckpt-every",
                                str(LAUNCH_CKPT_EVERY), "--ckpt-dir",
                                str(work / "straight"), "--log-every", "1"])
        like = (straight.params, straight.opt_state)
        assert straight.params["att"]["w"].is_cuda
        final = ckpt.restore(str(work / "killed"), LAUNCH_STEPS, like)
        same = _bit_equal(final, like)
        on_host = ckpt.restore(str(work / "killed"), LAUNCH_STEPS,
                               params_to(like, "cpu"))
        host_same = _bit_equal(on_host, like) and not \
            on_host[0]["att"]["w"].is_cuda
        print(f"launcher: killed at step {LAUNCH_FAIL_AT} (exit 42), "
              f"resumed from step {last}; final params and AdamW state "
              f"bit-equal to the uninterrupted run's on the card: {same}, "
              f"restored onto the CPU bit-equal: {host_same}")
        assert same and host_same
        step_ms = [1e3 * r["sec_per_step"] for r in straight.history]
        saves, restores = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save(str(work / "timed"), LAUNCH_STEPS, like)
            saves.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            ckpt.restore(str(work / "timed"), LAUNCH_STEPS, like)
            torch.cuda.synchronize()
            restores.append(1e3 * (time.perf_counter() - t0))
        step_dir = work / "timed" / f"step_{LAUNCH_STEPS:09d}"
        nbytes = sum(p.stat().st_size for p in step_dir.iterdir())
        n_leaves = len(ckpt._flatten_with_paths(like)[0])
        print(f"launcher step (median of steps 1..{LAUNCH_STEPS - 1}, loop "
              f"timing): {statistics.median(step_ms[1:]):.3f} ms, first "
              f"step {step_ms[0]:.3f} ms; checkpoint of {n_leaves} leaves, "
              f"{nbytes} bytes: save {statistics.median(saves):.3f} "
              f"ms (min {min(saves):.3f}), verified restore onto the card "
              f"{statistics.median(restores):.3f} ms (min "
              f"{min(restores):.3f}); median of 5")
        report.update(bit_equal=same, host_bit_equal=host_same,
                      step_ms=step_ms, save_ms=saves, restore_ms=restores,
                      ckpt_bytes=nbytes, losses=[r["loss"] for r in
                                                 straight.history])

        reset_counts()
        quick = quickstart.main([])
        counts = read_counts()
        err = float((quick["scores_kernel"] - quick["scores"]).abs().max())
        print(f"quickstart on the card: kernel path against plain path, max "
              f"abs err {err:.3e} (bound 1e-06); launches {counts}")
        assert err <= 1e-6 and counts["fused_gcn"] and counts["simgnn_head"]
        report["quickstart"] = {"err": err, "launches": counts}

        reset_counts()
        search = simgnn_search.main(["--kernels", "--topk", "5", "--corpus",
                                     "1024", "--mode", "two_stage"])
        counts = read_counts()
        idx, scores = search["top"]
        st = search["server"].stats
        print(f"simgnn_search on the card: launches {counts}; recall "
              f"{st.recall_mean:.4f} over {st.recall_samples} samples")
        assert len(idx) == 5 and np.isfinite(scores).all()
        assert counts["fused_gcn"] and counts["simgnn_head"] and \
            counts["topm"] + counts["topm_ntn"]
        report["simgnn_search"] = {"launches": counts,
                                   "queries_per_s": search["queries_per_s"],
                                   "recall": st.recall_mean}

        lm_params = init_params(torch.Generator().manual_seed(0),
                                reduced_config("gemma2-9b"), device="cpu")
        card_lm = serve_lm.main([], params=lm_params)
        host_lm = serve_lm.main(["--device", "cpu"], params=lm_params)
        flips, compared = [], 0
        for b in range(card_lm["tokens"].shape[0]):
            for t in range(card_lm["tokens"].shape[1]):
                if card_lm["tokens"][b, t] == host_lm["tokens"][b, t]:
                    compared += 1
                    continue
                margin = float(host_lm["margins"][b, t])
                assert margin <= LM_F32_ATOL, (b, t, margin)
                flips.append({"sequence": b, "step": t, "margin": margin})
                break
        print(f"serve_lm on the card: {compared} tokens equal to the CPU's, "
              f"{len(flips)} flips under the {LM_F32_ATOL:g} margin")
        report["serve_lm"] = {"equal": compared, "flips": flips}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return report


# ------------------------------------------ phase 21: enc-dec, LM training


def _batch_on(batch: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _excess(got, want, tol) -> float:
    """max(|got - want| - (atol + rtol |want|)); <= 0 passes."""
    return float(((got.float() - want.float()).abs()
                  - tol["atol"] - tol["rtol"] * want.float().abs()).max())


def _encdec_serving(dev, cfg, params, reset_counts, read_counts) -> dict:
    """21 (a): seamless served at full width and depth in bf16; then the
    reduced float32 model on the card against the CPU."""
    from repro_torch.configs import reduced_config
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attention_plain)
    from repro_torch.models import encdec
    from repro_torch.models import layers as layers_mod
    from repro_torch.models.init import init_params
    from repro_torch.params import params_to
    from repro_torch.serve.step import build_decode_step, build_prefill_step

    prefill, decode = build_prefill_step(cfg), build_decode_step(cfg)
    batch = _batch_on(batch_for_step(cfg, 0, global_batch=ENCDEC_BATCH,
                                     seq_len=ENCDEC_FRAMES), dev)
    frames, prompt = batch["frames"], batch["tokens"]
    s = prompt.shape[1]
    cache_len = s + ENCDEC_NEW
    prefill(params, frames, prompt, cache_len=cache_len)        # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    last, enc_out, caches, pos = prefill(params, frames, prompt,
                                         cache_len=cache_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = read_counts()
    assert torch.isfinite(last).all()
    toks = [torch.argmax(last, -1)]
    step_s, first = [], None
    for _ in range(ENCDEC_NEW - 1):
        t0 = time.perf_counter()
        logits, caches, pos = decode(params, toks[-1][:, None], enc_out,
                                     caches, pos)
        toks.append(torch.argmax(logits, -1))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        assert torch.isfinite(logits).all()
        first = logits if first is None else first
    peak = torch.cuda.max_memory_allocated()
    wall, busy, _, n_launch, top = _profile_busy(
        lambda: decode(params, toks[-1][:, None], enc_out, caches, pos), ())
    # the first decode step against the full forward over prompt + token
    with torch.inference_mode():
        full, _ = encdec.forward_encdec(params, cfg, frames, torch.cat(
            [prompt, toks[0][:, None].to(prompt.dtype)], 1))
    v = cfg.vocab_size
    ref, got = full[:, -1, :v], first[:, :v]
    scale = float(ref.abs().max())
    full_err = float((got - ref).abs().max())
    decode_ms = 1e3 * statistics.median(step_s)
    total_s = prefill_s + sum(step_s)
    print(f"seamless (a): {SEAMLESS_ARCH} bf16, frames {tuple(frames.shape)}"
          f", decoder prompt {s}, {ENCDEC_NEW} tokens: prefill "
          f"{1e3 * prefill_s:.3f} ms, decode {decode_ms:.3f} ms a step "
          f"(median of {len(step_s)}; mean "
          f"{1e3 * statistics.fmean(step_s):.3f}), "
          f"{ENCDEC_BATCH / (decode_ms / 1e3):.1f} tokens/s decoding, "
          f"{ENCDEC_BATCH * ENCDEC_NEW / total_s:.1f} tokens/s end to end; "
          f"peak memory {peak / 2**30:.2f} GiB; prefill launches {counts}")
    print(f"  a profiled decode step: wall {1e3 * wall:.3f} ms, device "
          f"busy {1e3 * busy:.3f} ms, idle share {1 - busy / wall:.4f}, "
          f"{n_launch} kernel launches; top: {top[:3]}")
    print(f"  first decode step against the full forward over prompt + "
          f"token: max abs err {full_err:.3e}, bound "
          f"{ENCDEC_BF16_SHARE:g} x {scale:.3f}")
    assert full_err <= ENCDEC_BF16_SHARE * scale, (full_err, scale)
    rep = {"prefill_ms": 1e3 * prefill_s, "decode_ms_per_step": decode_ms,
           "decode_step_ms": [1e3 * x for x in step_s],
           "decode_tokens_per_s": ENCDEC_BATCH / (decode_ms / 1e3),
           "tokens_per_s": ENCDEC_BATCH * ENCDEC_NEW / total_s,
           "peak_bytes": peak, "decode_step_wall_s": wall,
           "decode_step_busy_s": busy, "idle_share": 1 - busy / wall,
           "decode_step_launches": n_launch, "prefill_launches": counts,
           "full_forward_err": full_err, "full_forward_scale": scale}
    del caches, enc_out, full

    # shape 2: a 2048-token decoder prompt (flash_attn in every layer)
    long_frames = _batch_on(batch_for_step(
        cfg, 1, global_batch=1, seq_len=ENCDEC_FRAMES), dev)["frames"]
    long_prompt = torch.from_numpy(np.random.default_rng(23).integers(
        0, cfg.vocab_size, (1, ENCDEC_LONG_PROMPT)).astype(np.int32)).to(dev)
    prefill(params, long_frames, long_prompt)                   # warm
    keep = {"calls": {0, cfg.n_layers - 1}, "args": []}
    restore = _capture(layers_mod, "flash_attention", keep)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        last, enc_out, caches, pos = prefill(params, long_frames,
                                             long_prompt)
        torch.cuda.synchronize()
        long_s = time.perf_counter() - t0
        long_counts = read_counts()
    finally:
        restore()
    t0 = time.perf_counter()
    logits, _, _ = decode(params, torch.argmax(last, -1)[:, None], enc_out,
                          caches, pos)
    torch.cuda.synchronize()
    long_step_s = time.perf_counter() - t0
    long_peak = torch.cuda.max_memory_allocated()
    print(f"seamless (a): 1 x {ENCDEC_FRAMES} frames, a "
          f"{ENCDEC_LONG_PROMPT}-token decoder prompt: prefill "
          f"{1e3 * long_s:.3f} ms, one decode step {1e3 * long_step_s:.3f} "
          f"ms, peak memory {long_peak / 2**30:.2f} GiB; launches "
          f"{long_counts}")
    assert long_counts["flash_attn"] == cfg.n_layers, long_counts
    assert torch.isfinite(last).all() and torch.isfinite(logits).all()
    # the decoder's first and last self-attention calls of that prefill,
    # kernel against plain on the captured tensors
    held = {}
    for layer, ((q, k, v), kw) in zip((0, cfg.n_layers - 1), keep["args"]):
        held[layer] = _held_f64(
            "flash_attn", f"seamless {ENCDEC_LONG_PROMPT}-token prefill, "
            f"decoder layer {layer}", flash_attention(q, k, v, **kw),
            flash_attention_plain(q, k, v, **kw), _flash_f64(q, k, v, **kw),
            FLASH_TOL)
    assert len(held) == 2, len(keep["args"])
    rep.update(long_prefill_ms=1e3 * long_s,
               long_decode_step_ms=1e3 * long_step_s,
               long_peak_bytes=long_peak, long_prefill_launches=long_counts,
               long_captured_flash=held)
    del caches, enc_out, keep

    # the reduced float32 model on the card against the CPU
    rcfg = reduced_config(SEAMLESS_ARCH)
    host = init_params(torch.Generator().manual_seed(5), rcfg, device="cpu")
    card = params_to(host, dev)
    rb = batch_for_step(rcfg, 0, global_batch=2, seq_len=64)
    rprefill, rdecode = build_prefill_step(rcfg), build_decode_step(rcfg)

    def serve(p, device):
        fr, tk = (torch.from_numpy(rb[k]).to(device)
                  for k in ("frames", "tokens"))
        lg, eo, cc, ps = rprefill(p, fr, tk, cache_len=tk.shape[1] + 8)
        out = [lg]
        for _ in range(7):
            lg, cc, ps = rdecode(p, torch.argmax(lg, -1)[:, None], eo, cc,
                                 ps)
            out.append(lg)
        return torch.stack([x[:, :rcfg.vocab_size].cpu() for x in out], 1)

    on_card, on_host = serve(card, dev), serve(host, "cpu")
    same = bool(torch.equal(on_card.argmax(-1), on_host.argmax(-1)))
    f32_err = float((on_card - on_host).abs().max())
    print(f"seamless (a): reduced float32 ({rcfg.n_layers} + "
          f"{rcfg.n_enc_layers} layers), prefill + 7 decode steps: tokens "
          f"equal to the CPU's {same}; logits max abs err {f32_err:.3e} "
          f"(bound {ENCDEC_F32_ATOL:g})")
    assert same and f32_err <= ENCDEC_F32_ATOL, (same, f32_err)
    rep.update(reduced_tokens_equal=same, reduced_logits_err=f32_err)
    return rep


def _encdec_training(dev, cfg, params) -> dict:
    """21 (b): ENCDEC_TRAIN_STEPS train steps of seamless at full width and
    depth (bf16 params, float32 AdamW state, remat on). Gates: the loss
    and gradient norm finite at every step, every leaf changed."""
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.params import tree_leaves
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import build_train_step

    init = tree_leaves(params)
    opt_state = adamw_init(params, cfg.opt_state_dtype)
    step = build_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, norms = [], [], []
    for s in range(ENCDEC_TRAIN_STEPS):
        batch = _batch_on(batch_for_step(cfg, s,
                                         global_batch=ENCDEC_TRAIN_BATCH,
                                         seq_len=ENCDEC_FRAMES), dev)
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        assert np.isfinite(losses[-1]) and np.isfinite(norms[-1]), (s, m)
    peak = torch.cuda.max_memory_allocated()
    unchanged = [i for i, (a, b) in enumerate(zip(init, tree_leaves(params)))
                 if torch.equal(a, b)]
    del init
    wall, busy, _, n_launch, top = _profile_busy(
        lambda: step(params, opt_state, batch), ())
    print(f"seamless (b): {ENCDEC_TRAIN_STEPS} train steps, frames "
          f"[{ENCDEC_TRAIN_BATCH}, {ENCDEC_FRAMES}, {cfg.d_model}], decoder "
          f"tokens [{ENCDEC_TRAIN_BATCH}, {tuple(batch['tokens'].shape)[1]}]"
          f", bf16 params, float32 AdamW, remat: "
          f"{statistics.median(step_ms[1:]):.3f} ms a step (median of steps "
          f"2-{ENCDEC_TRAIN_STEPS}; first {step_ms[0]:.3f}); peak memory "
          f"{peak / 2**30:.2f} GiB; losses "
          f"{[round(x, 4) for x in losses]}, gradient norms "
          f"{[round(x, 4) for x in norms]}; leaves unchanged "
          f"{len(unchanged)} of {len(tree_leaves(params))}")
    print(f"  a profiled step: wall {1e3 * wall:.3f} ms, device busy "
          f"{1e3 * busy:.3f} ms, idle share {1 - busy / wall:.4f}, "
          f"{n_launch} kernel launches; top: {top}")
    assert not unchanged, unchanged
    return {"step_ms": step_ms, "peak_bytes": peak, "losses": losses,
            "grad_norms": norms, "leaves": len(tree_leaves(params)),
            "profiled_wall_s": wall, "device_busy_s": busy,
            "idle_share": 1 - busy / wall, "launches": n_launch,
            "top_device": top}


def _kernel_grads(dev, reset_counts, read_counts) -> dict:
    """21 (c): a loss and every gradient with the LM kernels in the
    forward (their backward through the plain versions) against plain
    autograd (the plain versions swapped into the model) on the card, each
    GRAD_CASES config in float32; the kernels' launch counters must move.
    The value-and-grad times are of a second, warm run of each. Then each
    kernel's first captured call is timed: the kernel forward (no grad),
    the plain forward, and the backward through the plain version
    (`torch.autograd.grad` of the wrapper's output under grad)."""
    from repro_torch.configs import reduced_config
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import moe_experts as me
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import layers, mamba, moe, rwkv6
    from repro_torch.models.init import init_params
    from repro_torch.params import tree_leaves
    from repro_torch.train.step import value_and_grad

    sites = {"flash_attn": (layers, "flash_attention", fa.flash_attention,
                            fa.flash_attention_plain),
             "moe_experts": (moe, "moe_expert_ffn", me.moe_expert_ffn,
                             me.moe_expert_ffn_plain),
             "wkv6": (rwkv6, "wkv6_state", wk.wkv6_state,
                      wk.wkv6_state_plain),
             "mamba_scan": (mamba, "mamba_selective_scan_state",
                            ms.mamba_selective_scan_state,
                            ms.mamba_selective_scan_state_plain)}
    rep = {}
    for arch, kw, b, t, names, tol in GRAD_CASES:
        cfg = reduced_config(arch).with_(**kw)
        params = init_params(torch.Generator().manual_seed(7), cfg,
                             device=dev)
        batch = _batch_on(batch_for_step(cfg, 0, global_batch=b, seq_len=t),
                          dev)
        keep = {n: {"calls": {0}, "args": []} for n in names}
        restores = [_capture(sites[n][0], sites[n][1], keep[n])
                    for n in names]
        try:
            reset_counts()
            loss_k, grads_k = value_and_grad(params, cfg, batch,
                                             allow_unused=False)
            grads_k = tree_leaves(grads_k)
            counts = read_counts()
        finally:
            for restore in restores:
                restore()

        def timed():
            t0 = time.perf_counter()
            out = value_and_grad(params, cfg, batch,
                                 allow_unused=False)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        kern_s = timed()[1]
        for n in names:
            setattr(sites[n][0], sites[n][1], sites[n][3])
        try:
            (loss_p, grads_p), _ = timed()
            grads_p = tree_leaves(grads_p)
            plain_s = timed()[1]
        finally:
            for n in names:
                setattr(sites[n][0], sites[n][1], sites[n][2])
        loss_ex = _excess(loss_k, loss_p, tol)
        grad_ex = max(_excess(a, b_, tol) for a, b_ in zip(grads_k, grads_p))
        grad_err = max(float((a - b_).abs().max())
                       for a, b_ in zip(grads_k, grads_p))
        print(f"kernel gradients (c): reduced {arch} float32, tokens "
              f"[{b}, {t}]: launches {counts}; loss {float(loss_k):.6f} "
              f"against plain {float(loss_p):.6f} (excess {loss_ex:.3e}); "
              f"{len(grads_k)} gradients, max abs err {grad_err:.3e}, "
              f"excess over (rtol {tol['rtol']:g}, atol {tol['atol']:g}) "
              f"{grad_ex:.3e}; value and grad {1e3 * kern_s:.1f} ms with "
              f"the kernels, {1e3 * plain_s:.1f} ms plain")
        assert all(counts[n] > 0 for n in names), counts
        assert loss_ex <= 0 and grad_ex <= 0, (arch, loss_ex, grad_ex)
        entry = {"launches": counts, "loss_excess": loss_ex,
                 "grad_excess": grad_ex, "grad_err": grad_err,
                 "value_and_grad_ms": 1e3 * kern_s,
                 "plain_value_and_grad_ms": 1e3 * plain_s, "kernels": {}}
        for n in names:
            args, kwargs = keep[n]["args"][0]
            args = [a.detach() if isinstance(a, torch.Tensor) else a
                    for a in args]
            kernel, plain = sites[n][2], sites[n][3]
            with torch.no_grad():
                fwd_ms = time_cuda(lambda: kernel(*args, **kwargs))
                plain_ms = time_cuda(lambda: plain(*args, **kwargs))
            leaves = [a.clone().requires_grad_(True)
                      if isinstance(a, torch.Tensor) else a for a in args]
            out = kernel(*leaves, **kwargs)
            y = out[0] if isinstance(out, tuple) else out
            wrt = [a for a in leaves if isinstance(a, torch.Tensor)]
            g = torch.randn_like(y)
            bwd_ms = time_cuda(lambda: torch.autograd.grad(
                y, wrt, g, retain_graph=True), iters=10, warmup=1)
            shapes = [tuple(a.shape) for a in wrt]
            print(f"  {n}: shapes {shapes}: kernel forward {fwd_ms:.4f} ms,"
                  f" plain forward {plain_ms:.4f} ms, backward through the "
                  f"plain version {bwd_ms:.4f} ms; {counts[n]} launches in "
                  f"the step (forward and remat recompute)")
            entry["kernels"][n] = {"shapes": shapes, "forward_ms": fwd_ms,
                                   "plain_forward_ms": plain_ms,
                                   "plain_backward_ms": bwd_ms,
                                   "launches_a_step": counts[n]}
            del out, y, leaves, wrt
        rep[arch] = entry
    return rep


def _train_steps_against_cpu(dev) -> dict:
    """21 (d): three `build_train_step` steps of reduced float32 models on
    the card and on the CPU from the same params: params within
    STEP_PARAM_BOUND."""
    from repro_torch.configs import reduced_config
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.models.init import init_params
    from repro_torch.params import params_to, tree_leaves
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import build_train_step

    rep = {}
    for arch in STEP_ARCHS:
        cfg = reduced_config(arch)
        host = init_params(torch.Generator().manual_seed(11), cfg,
                           device="cpu")
        card = params_to(host, dev)
        step = build_train_step(cfg)
        ho, co = adamw_init(host), adamw_init(card)
        for s in range(3):
            batch = batch_for_step(cfg, s, global_batch=2, seq_len=64)
            host, ho, hm = step(host, ho, batch)
            card, co, cm = step(card, co, batch)
        err = max(float((a.cpu() - b).abs().max())
                  for a, b in zip(tree_leaves(card), tree_leaves(host)))
        loss_err = abs(float(cm["loss"]) - float(hm["loss"]))
        print(f"train steps (d): reduced {arch} float32, 3 steps of "
              f"{tuple(batch['tokens'].shape)} tokens"
              + (" with embeds" if "embeds" in batch else "")
              + (" and frames" if "frames" in batch else "")
              + f": params max abs err against the CPU {err:.3e} (bound "
              f"{STEP_PARAM_BOUND:g}); last loss err {loss_err:.3e}")
        assert err <= STEP_PARAM_BOUND, (arch, err)
        rep[arch] = {"param_err": err, "loss_err": loss_err}
    return rep


def _launch_lm(ckpt_dir: Path, *extra: str) -> subprocess.CompletedProcess:
    """The launcher in LM mode (`_lm_cmd`) in a process of its own."""
    proc, = _procs([_lm_cmd(ckpt_dir, *extra)], 300)
    _said(proc)
    return proc


def _lm_launcher(dev) -> dict:
    """21 (e): the launcher in LM mode killed after step LM_LAUNCH_FAIL_AT
    (exit 42), resumed in a second process, held bit-equal to an
    uninterrupted run in this process; then the `train_lm` example."""
    import shutil

    from repro_torch.ckpt import manager as ckpt
    from repro_torch.examples import train_lm
    from repro_torch.launch import train as launch

    work = ROOT / "build" / "lm_launcher_phase"
    _fresh(work)
    try:
        killed = _launch_lm(work / "killed", "--simulate-failure",
                            str(LM_LAUNCH_FAIL_AT))
        assert killed.returncode == 42, killed.stdout + killed.stderr
        left = _listing(work / "killed")
        assert left[-1] == f"step_{LM_LAUNCH_FAIL_AT:09d}", left
        resumed = _launch_lm(work / "killed")
        assert resumed.returncode == 0, resumed.stdout + resumed.stderr
        assert f"[loop] resumed from step {LM_LAUNCH_FAIL_AT}" in \
            resumed.stdout, resumed.stdout
        straight = launch.main(
            ["--model", LM_LAUNCH_ARCH, "--reduced", "--steps",
             str(LM_LAUNCH_STEPS), "--ckpt-every", str(LM_LAUNCH_EVERY),
             "--log-every", "1", "--ckpt-dir", str(work / "straight")])
        like = (straight.params, straight.opt_state)
        assert straight.params["embed"]["table"].is_cuda
        final = ckpt.restore(str(work / "killed"), LM_LAUNCH_STEPS, like)
        same = _bit_equal(final, like)
        step_ms = [1e3 * r["sec_per_step"] for r in straight.history]
        print(f"LM launcher (e): reduced {LM_LAUNCH_ARCH}, killed after step"
              f" {LM_LAUNCH_FAIL_AT} (exit 42) and resumed: final params and "
              f"AdamW state bit-equal to the uninterrupted run's on the card:"
              f" {same}; a step {statistics.median(step_ms[1:]):.3f} ms "
              f"(median of steps 1-{LM_LAUNCH_STEPS - 1}, loop timing)")
        assert same
        example = train_lm.main(["--steps", "4"])
        loss = example.history[-1]["loss"]
        print(f"  train_lm example on the card: 4 steps, last loss "
              f"{loss:.4f}")
        assert int(example.opt_state.step) == 4 and np.isfinite(loss)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"bit_equal": same, "step_ms": step_ms,
            "losses": [r["loss"] for r in straight.history],
            "example_loss": loss}


def encdec_phase(dev, reset_counts, read_counts) -> dict:
    """Phase 21: seamless-m4t-large-v2 served (a) and trained (b) at full
    width and depth on the card (random weights from `torch.Generator`
    seed 0, drawn on the card), gradients through each LM kernel against
    plain autograd (c), three train steps against the CPU (d), and the
    launcher's LM mode and the `train_lm` example (e). Each part prints
    its seconds."""
    from repro_torch.configs import get_config
    from repro_torch.models.init import init_params
    from repro_torch.params import tree_leaves

    rep, clock = {}, PhaseClock()
    cfg = get_config(SEAMLESS_ARCH)
    params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"seamless: {SEAMLESS_ARCH}, {cfg.n_enc_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size} padded to {cfg.vocab_padded}: {n_params} "
          f"parameters ({cfg.param_dtype})")
    rep["n_params"] = n_params
    rep["serving"] = _encdec_serving(dev, cfg, params, reset_counts,
                                     read_counts)
    clock("21 (a) seamless serving")
    torch.cuda.empty_cache()
    rep["training"] = _encdec_training(dev, cfg, params)
    del params
    torch.cuda.empty_cache()
    clock("21 (b) seamless training")
    rep["kernel_grads"] = _kernel_grads(dev, reset_counts, read_counts)
    clock("21 (c) gradients through the LM kernels")
    rep["train_steps"] = _train_steps_against_cpu(dev)
    clock("21 (d) train steps against the CPU")
    rep["launcher"] = _lm_launcher(dev)
    clock("21 (e) the LM launcher and train_lm")
    rep["seconds"] = clock.seconds
    return rep


class RequestTimer:
    """Where one served request's time goes, measured inside the request:
    the host clock around the engine's stages (plan = validation and
    workload stats; pack = FFD packing, A' edge planes on the sparse path,
    and the copy to the card; score = enqueueing the scoring call; unpack = copying the scores
    back, which waits for the card, and restoring request order), and the
    device span of the scoring call from CUDA events around the engine's
    executor seam (`_FAULT_HOOK`). Everything is restored on exit."""

    STAGES = ("plan", "pack", "score", "unpack")

    def __init__(self, engine):
        self.engine = engine
        self.stages: list[dict] = []
        self._events: list = []

    def _timed(self, name, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.stages[-1][name] += time.perf_counter() - t0
            return out
        return run

    def _hook(self, site, thunk):
        if site == "profile":           # the trace record: host bookkeeping
            return thunk()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = self._timed("score", thunk)()
        end.record()
        self._events.append((start, end))
        return out

    def __enter__(self):
        from repro_torch.core import batching
        from repro_torch.core import engine as engine_mod

        self.stages.append(dict.fromkeys(self.STAGES, 0.0))
        self._events = []
        self._saved = (engine_mod._FAULT_HOOK, batching.unpack_pair_scores,
                       batching.pack_pairs)
        engine_mod._FAULT_HOOK = self._hook
        batching.unpack_pair_scores = self._timed(
            "unpack", batching.unpack_pair_scores)
        batching.pack_pairs = self._timed("pack", batching.pack_pairs)
        self.engine.plan = self._timed("plan", type(self.engine).plan.__get__(
            self.engine))
        return self

    def __exit__(self, *exc):
        from repro_torch.core import batching
        from repro_torch.core import engine as engine_mod

        (engine_mod._FAULT_HOOK, batching.unpack_pair_scores,
         batching.pack_pairs) = self._saved
        del self.engine.plan
        torch.cuda.synchronize()
        self.stages[-1]["device"] = sum(s.elapsed_time(e)
                                        for s, e in self._events) / 1e3
        return False


def kernel_device_ms(fn, symbols, iters: int = 20) -> float | None:
    """Device time (ms) per call of `fn` of the CUDA kernels whose names
    contain one of `symbols` (a string or a tuple), from a `torch.profiler`
    trace of `iters` warm calls: each kernel's time is averaged over the
    launches the trace recorded (it can drop some: it kept 1 of 5 launches
    of a 25 ms kernel), and the kernels of one call are summed. None when
    the trace holds no device time for them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms, traced = 0.0, []
    for ev in prof.key_averages():
        if any(sym in ev.key for sym in (
                (symbols,) if isinstance(symbols, str) else symbols)):
            us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
            if us > 0 and ev.count:
                ms += us / ev.count / 1e3
                traced.append(ev.count)
    if any(n != iters for n in traced):
        print(f"  (the profiler traced {traced} of {iters} launches of "
              f"{symbols})")
    return ms if ms > 0 else None


def time_cuda(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median ms of `fn` on the card (CUDA events, warm)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------- work these inputs need

def _gcn_flops(n_real: float, agg_macs_per_f: float, cfg) -> float:
    """Flops of one side's GCN stack on n_real real nodes whose A' has
    `agg_macs_per_f` non-zeros (or dense cells) per feature column."""
    dims = cfg.feature_dims
    flops = 0.0
    for li, (fin, fout) in enumerate(zip(dims[:-1], dims[1:])):
        if li > 0:
            flops += 2 * n_real * fin * fout          # H·W
        flops += n_real * fout                        # + b (gather on layer 0)
        flops += 2 * agg_macs_per_f * fout            # A'·(HW)
    return flops


def _head_flops(n_real: float, graphs: int, pairs: int, cfg) -> float:
    """Att pooling on n_real nodes in `graphs` graphs + NTN/FCN of
    `pairs` live pairs."""
    f, k = cfg.gcn_dims[-1], cfg.ntn_k
    att = 6 * n_real * f + 2 * graphs * f * f
    dims = (k,) + tuple(cfg.fcn_dims) + (1,)
    head = 2 * (k * f * f + k * f + k * 2 * f) + 2 * sum(
        a * b for a, b in zip(dims[:-1], dims[1:]))
    return att + pairs * head


def _seg_sizes(mask, seg, pair_mask):
    m = mask.cpu().numpy()
    s = seg.cpu().numpy()
    p = pair_mask.shape[-1]
    return np.stack([((s == q) * m).sum(-1) for q in range(p)], -1)   # [T, P]


def _work_sparse(a, cfg):
    flops = 0.0
    pm = a[16]
    live = float(pm.sum())
    for side in (a[:8], a[8:16]):
        _, nw, _, _, ovw, _, mask, _ = side
        n_real = float(mask.sum())
        nnz = float((nw != 0).sum() + (ovw != 0).sum())
        flops += _gcn_flops(n_real, nnz, cfg) + _head_flops(n_real, live, 0,
                                                            cfg)
    flops += _head_flops(0, 0, live, cfg)
    return flops, sum(x.numel() * x.element_size() for x in a)


def _work_packed(a, cfg):
    flops = 0.0
    pm = a[8]
    live = float(pm.sum())
    for adj, _, mask, seg in (a[:4], a[4:8]):
        sizes = _seg_sizes(mask, seg, pm)
        n_real = float(sizes.sum())
        cells = float((sizes ** 2).sum())                  # per-graph blocks
        flops += 3 * cells                                  # normalization
        flops += _gcn_flops(n_real, cells, cfg) + _head_flops(n_real, live, 0,
                                                              cfg)
    flops += _head_flops(0, 0, live, cfg)
    return flops, sum(x.numel() * x.element_size() for x in a)


def _work_fused(a, cfg):
    flops = 0.0
    b = a[0].shape[0]
    for adj, feats, mask in (a[:3], a[3:]):
        n = mask.sum(-1).cpu().numpy()
        n_real = float(n.sum())
        cells = float((n ** 2).sum())
        flops += 3 * cells + 2 * n_real * cfg.n_node_labels * cfg.gcn_dims[0]
        flops += _gcn_flops(n_real, cells, cfg) + _head_flops(n_real, b, 0,
                                                              cfg)
    flops += _head_flops(0, 0, b, cfg)
    return flops, sum(x.numel() * x.element_size() for x in a)


WORK = {"sparse_pair": _work_sparse, "packed_pair": _work_packed,
        "fused_pair": _work_fused}


def param_bytes(params) -> int:
    from repro_torch.params import tree_leaves

    return sum(t.numel() * 4 for t in tree_leaves(params))


def out_bytes(name, arrays) -> int:
    if name == "fused_pair":
        return arrays[0].shape[0] * 4
    return arrays[-1].numel() * 4


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-predictions"]:
        sys.exit(_dryrun_predictions_main(sys.argv[2]))
    sys.exit(main())
