#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
with nvcc (one process per source, all at once), holds each kernel
against its plain PyTorch version on the card (K1 at each served model's
heads, and at gemma3's long-context shapes), then runs the port's
serving path for seven models at full width (four cut in depth for the
run's time), random bf16 weights from a seed: save the weights to scda and restore them bit-exactly, one prefill
of 4 × 512 tokens, and 4 requests served token by token (a 64-token
prompt, then 32 greedy tokens).

- qwen3-1.7b (28 layers, d_model 2048, vocab 151 936) through K1, flash
  attention: its prefill kernel in every prefill layer, its split-KV
  decode kernel in every decode step; a warm prefill is timed after the
  path.  Before it, its weights are also saved as a sharded scda set of 4
  shards and 2 parity files with chunk digests: restored onto the card
  bit-equal, restored again through the parity after two data shards are
  deleted, those two rebuilt to their original SHA-256; then the
  attention weights of 2 of the 28 layers are changed on the card and
  saved as a delta of the set, whose stored chunks must be the 1 MiB
  chunks that changed, and the chain restored bit-equal; then the port's
  ``scdatool`` (``repro_torch.tools``) over those files: the set's save
  is traced and ``stats --trace`` splits it by stage, ``fsck`` runs as
  ``python -m repro_torch.tools.cli`` in its own process, ``ls --json``,
  ``index --checksums`` and ``verify`` cover the set, a deleted data
  shard is named by ``verify`` and rebuilt by ``repair --rebuild`` to its
  SHA-256, ``verify --chain`` checks the delta, ``squash`` makes it one
  file that ``diff --logical`` finds equal to the delta and different
  from the set in exactly the stored leaves and that restores bit-equal,
  and ``stats`` counts the set's bytes; then 4 gloo
  ranks spawned on the one card (``repro_torch.distributed.ranks``)
  restore the weights' file onto the placement rules' DTensors
  (``distributed.sharding.params_shardings``) of the meshes (2, 2), (4,
  1) and (1, 4), every local shard held bit-equal against a host restore,
  and save them back with ``TorchDistComm``, each rank its own bytes
  (each file's SHA-256 must be the single-process file's); then restore
  it fully replicated and with P(("data", "model"), None) on the 2-D
  leaves, with the prefetch engine and without;
- falcon-mamba-7b (32 of its 64 Mamba1 layers, ``FALCON_SERVE_LAYERS``;
  d_model 4096, d_inner 8192, state 16, vocab 65 024; 7.27 GB of weights
  at 32 layers, 14.0 GB at 64) through the fused K2 selective
  scan, which every prefill layer launches and no decode step does; then
  each of its layers held at full width through the fused K2, the
  unfused K2 (decay and inc built in full) and the plain scan;
- zamba2-2.7b (54 Mamba2 layers, d_model 2560, d_inner 5120, 80 SSM heads
  of 64, state 64, vocab 32 000; one shared attention block of 32 / 32
  heads of head dim 80 applied after every 6 layers, 9 times, each with
  its own KV cache) through K1 at head dim 80: its prefill kernel in every
  application of a prefill, its decode kernel in every application of a
  decode step; then each application held at full width against the
  plain attention, and each Mamba2 layer's decode against its prefill;
- gemma3-4b (18 of its 34 layers, three 5:1 periods,
  ``GEMMA_SERVE_LAYERS``; d_model 2560, 8 / 4 heads of head dim 256, a
  1024-key window on 15 local layers and none on the 3 global ones, GeGLU
  10 240, vocab 262 144; 7.76 GB of weights at 34 layers) through K1 at
  head dim 256,
  as qwen3; then its window on the card: a prefill of 1 × 4096 tokens and
  32 decode steps of one request from a cache of 4160 keys whose K/V are
  seeded random values and whose position is set to 4064 (the reference
  has no prefill into a cache, and 4064 steps would take minutes), each
  held against the plain attention;
- granite-moe-3b-a800m (16 of its 32 layers, ``GRANITE_SERVE_LAYERS``;
  d_model 1536, 24 / 8 heads of head dim 64, 40 experts of SwiGLU 512,
  top-8, vocab 49 155; 6.60 GB of weights at 32 layers)
  through K1 at head dim 64, group 3, and the MoE block (plain torch: the
  reference has no kernel there): its layers held as gemma3's, and each
  layer's share of dropped expert assignments printed for the prefill and
  for a decode step, which runs with CUDA's sync debug mode raising;
- whisper-medium (24 encoder and 24 decoder layers, d_model 1024, 16 / 16
  heads of head dim 64, GELU 4096, vocab 51 865; 1.52 GB of weights)
  through K1 with and without the causal mask: 4 × 1500 seeded frame
  embeddings encoded (its audio frontend is a stub, as in the
  reference), a prefill of 4 × 448 decoder tokens on the same frames, and
  the 4 requests served with the encoder's output in their cache (its
  cross-attention through K1's decode kernel against all 1500 frames in
  every step: 48 launches a step); each encoder layer's attention and
  each decoder layer's self- and cross-attention held one by one;
- llava-next-mistral-7b (16 of its 32 layers, ``LLAVA_SERVE_LAYERS``;
  d_model 4096, 32 / 8 heads of head dim 128, SwiGLU 14 336, vocab 32 000;
  14.5 GB of weights at 32 layers) through K1: a
  prefill of 4 × (2880 seeded patch embeddings, projected by mm_proj,
  before 512 tokens) and 4 requests of text served (a decode step never
  sees the image, as in the reference), its layers held as gemma3's.

Then seven models train at full width (8192 tokens a step, f32 master
weights, AdamW), each through ``repro_torch.train.loop.train``: run 1 dies
after step 3's save, run 2 resumes bit-exactly.  All are cut
in depth (``*_TRAIN_LAYERS``) to keep the run's time well under its limit
and its disk footprint under 45 GiB.  qwen3-1.7b, cut to 2 of its 28
layers, trains through K1's forward and its backward (8 x 1024 tokens),
saving its state through the reference launcher's knobs
(REPRO_SCDA_SHARDS=4, REPRO_SCDA_PARITY=2, REPRO_SCDA_DELTA=1): step 3's
set loses a data shard after run 1, ``restore_latest`` reconstructs it
onto the card with run 1's checksums, the shard is rebuilt byte for
byte, and run 2's step-5 save is a sharded delta over step 3's set,
restored through its chain with run 2's checksums;
falcon-mamba-7b, cut to 2 of its 64 layers, through the fused K2 forward
and K2's backward kernel; zamba2-2.7b, cut to 6 of its 54 layers (one
group), through K1's forward and its
backward at head dim 80 in its shared-attention application
(each held against the plain backward in step 0, and one group's output
and gradients against the plain attention), its Mamba2 layers through
autograd of plain torch; gemma3-4b, cut to 6 of its 34 layers (one 5:1
period), on 2 x 4096 tokens so that its 1024-key window masks, through
K1's forward and its backward at head dim 256 with each layer's window
(each backward call held against the plain backward in step 0, the loss
and gradient norm against the plain attention); granite-moe-3b-a800m, cut
to 16 of its 32 layers, through K1's forward and its
backward at head dim 64, group 3, and its MoE layers through autograd of
plain torch (the loss with the reference's load-balance term);
whisper-medium, cut to 6 of its 24 encoder and 6 of its 24 decoder
layers, on 8 x (1500 frames + 448 tokens),
through K1's forward and its backward without the causal mask in its
encoder and cross-attention, from a data source that adds seeded frame
embeddings to the tokens; llava-next-mistral-7b, cut to 2 of its 32
layers, on 2 x (2880 patch embeddings + 1024 tokens), the loss over the
text alone.  The backward kernels are timed at each training shape and in
a profiled training step.

Each path is driven with the launch counts set to 0 just before it and
read just after.  Every phase asserts; any failure exits non-zero.  The
line before the last is a JSON object with each kernel's launches, error
and times; the last line is ``{"ok": true, "device": {...}}``.  No
fallback: without a GPU, or outside a checkout, it exits non-zero and
prints no result.  Needs about 45 GB free in the temporary directory
(granite-moe's training state, twice, while its final save commits;
gemma3's needs 33 GB, qwen3's two parity-protected sets 24 GB, llava's
18 GB; each path checks its own need first; qwen3's weights' set, 5.3
GB, and its delta are deleted before its serve path goes on).
``--kernels-only`` builds and checks the kernels and stops before the
model paths.

After the serve paths, the dry-run phase: a subprocess started at the
run's beginning (``--dryrun-predict``; it sees no GPU, and its ``fake``
process group never shares a process with the distributed phase's ranks)
traces on ``meta`` tensors qwen3-1.7b's prefill, its serve loop and a
2-layer train step (``repro_torch.analysis.costs``), and the production
cell qwen3-1.7b x decode_32k on 16 x 16 (``repro_torch.launch.dryrun``);
each predicted peak must be within 15 % of ``max_memory_allocated`` of the
same window on the card (the train step measured apart), and the phase
must take 20 s or less.  ``--dryrun-only`` builds the kernels, runs
qwen3's prefill and serve windows on random weights and the dry-run phase,
and stops.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
QWEN = "qwen3-1.7b"
FALCON = "falcon-mamba-7b"
ZAMBA = "zamba2-2.7b"
GEMMA = "gemma3-4b"
GRANITE = "granite-moe-3b-a800m"
WHISPER = "whisper-medium"
LLAVA = "llava-next-mistral-7b"
SEED = 0
PREFILL_B, PREFILL_S = 4, 512
SERVE_B, MAX_LEN, PROMPT_LEN, GEN_LEN = 4, 1024, 64, 32
DECODE_OFFSETS = (63, 95, 511, 1023)
#: K1's heads on the served paths: (q heads, kv heads, head dim).
K1_HEADS = {"qwen3-1.7b": (16, 8, 128), "zamba2-2.7b": (32, 32, 80),
            "gemma3-4b": (8, 4, 256),
            "granite-moe-3b-a800m": (24, 8, 64),
            "whisper-medium": (16, 16, 64),
            "llava-next-mistral-7b": (32, 8, 128)}
#: whisper's and llava's shapes on the card.  whisper: its encoder over
#: WHISPER_FRAMES frames (no causal mask), its decoder over WHISPER_TOKENS
#: tokens (its 448-token limit), the cross-attention from those tokens, or
#: from one in a decode step, to the frames.  llava: LLAVA_PATCHES image
#: positions (5 anyres tiles of 576) before LLAVA_TEXT text tokens in a
#: prefill.
WHISPER_FRAMES, WHISPER_TOKENS = 1500, 448
LLAVA_PATCHES, LLAVA_TEXT = 2880, 512
#: K1's prefill checks at each served model's heads: (Sq, Skv, causal),
#: B = PREFILL_B; qwen3's prefill of 4 x 512 for the others.  whisper also
#: has its cross-attention's decode (1 -> WHISPER_FRAMES keys) checked.
K1_PREFILLS = {
    WHISPER: ((WHISPER_FRAMES, WHISPER_FRAMES, False),
              (WHISPER_TOKENS, WHISPER_FRAMES, False),
              (WHISPER_TOKENS, WHISPER_TOKENS, True)),
    LLAVA: ((LLAVA_PATCHES + LLAVA_TEXT,) * 2 + (True,),),
}
#: gemma3's window on the card: a prefill of 1 x LONG_S tokens, and
#: LONG_STEPS decode steps of one request from a cache of LONG_CACHE keys
#: whose position is set to LONG_POS (its K/V seeded random values: the
#: reference has no prefill into a cache, and LONG_POS decode steps would
#: take minutes).
LONG_S = 4096
LONG_CACHE, LONG_POS, LONG_STEPS = 4160, 4064, 32

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12   # outside the tensor cores
#: Exponentials a second: 16 a clock on each SM's special function units
#: (Hopper's MUFU rate), 132 SMs, 1.98 GHz boost clock.
PEAK_EXP_PER_S = 132 * 16 * 1.98e9
#: falcon-mamba's bf16 checkpoint is 14.0 GB, llava's 14.5 GB; the
#: temporary directory must hold either.
DISK_NEED = 16e9

#: kernel vs plain version on the same inputs.  f32: the reference's own
#: kernel tolerance (tests/test_kernels.py TOL).  bf16: the same, as the
#: kernel rounds p to bf16 per 64-key tile and the plain version per
#: 512-key chunk, and the outputs are rounded to bf16 (2^-8 relative).
TOL_F32 = dict(rtol=2e-5, atol=2e-5)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
#: Full-model logits in bf16 (28 layers, bf16 residual stream), between
#: paths whose matmuls round at different shapes: decode vs prefill, and
#: the kernel vs the plain attention.
TOL_LOGITS = dict(rtol=5e-2, atol=1e-1)
#: K2 vs its plain version, f32 or bf16 inputs alike: both read the inputs
#: as f32 and round the state identically; only the order of the 16-term
#: sum over n differs (tests/test_kernels.py's scan tolerance).
TOL_SCAN = dict(rtol=1e-5, atol=1e-5)
#: falcon-mamba, held layer by layer on the same inputs (relative L2 error
#: of one Mamba1 layer's bf16 output).  The K2 path against the plain
#: scan: only y's sum order differs, so only rare bf16 roundings of y flip.
#: Prefill against 64 decode steps: every matmul rounds at another shape,
#: some 1e-2 in bf16.  End to end, 64 layers of random weights amplify
#: such differences until the logits decorrelate (the run prints how far),
#: so the logits of two rounding paths are reported, not held.
REL_LAYER_PLAIN = 1e-3
#: One attention block at full width (a zamba2 application, a gemma3
#: layer, prefill or decode): its bf16 output through K1 against the same
#: block through the plain attention on the same input (the kernel rounds
#: p to bf16 per 64-key tile or split, 32 at gemma3's head dim, the plain
#: version per 512-key chunk; then the bf16 output projection).
REL_APP = 1e-2
#: The fused K2 forward against mamba1_scan_plain: both build decay with
#: an accurate f32 exp of the same rounded product and inc with the same
#: two rounded products, and round the state identically; only the order of
#: y's sum over n differs (the unfused K2's TOL_SCAN).  K2's backward
#: against autograd of mamba1_scan_plain on f32 copies of the same inputs:
#: in f32 each gradient's largest error within SCAN_BWD_REL_MAX of its
#: largest element (sums over up to 8192 channels, or B S steps for dA, in
#: another order); for bf16 inputs dx, ddt, dB and dC (rounded to bf16 once)
#: by relative L2, dA (f32) as in f32.
SCAN_BWD_REL_MAX = 1e-4
SCAN_BWD_REL_BF16 = 1e-2
REL_LAYER_DECODE = 3e-2

#: K1's backward kernels by part: a part's kernels hold its substring.
BWD_PARTS = {"preprocess": "flash_bwd_preprocess", "dkdv": "flash_bwd_dkdv",
             "dq": "flash_bwd_dq"}
#: K1's backward against autograd of the plain version in f32 on the same
#: inputs.  f32: only the order of the sums differs.  bf16: the kernels
#: round P and dS to bf16 for their products and the gradients to bf16, so
#: each gradient is held by its relative L2 error.  The log-sum-exp the
#: forward writes: f32 from the same inputs, sum order and exp2 differ.
BWD_TOL_F32 = dict(rtol=1e-4, atol=1e-4)
BWD_REL_BF16 = 1e-2
#: K1's backward on a model's own activations (step 0 of a training path):
#: where the library's bf16 backward (SDPA) lies further than BWD_REL_BF16
#: from the f32 plain backward on the same inputs, K1 is held within
#: BWD_LIB_RATIO of the library's distance.  qwen3-1.7b's dq is such a case:
#: K1's and cuDNN's both up to 0.0112 from f32 in its layers, as dS
#: (rounded to bf16) sums to zero over keys that its normed q and k make
#: alike.
BWD_LIB_RATIO = 1.1
LSE_TOL = dict(rtol=1e-4, atol=1e-4)
#: The training paths, at full width, f32 master weights and AdamW moments,
#: bf16 compute, 8 × 1024 tokens a step, each cut in depth.  A path's time
#: is mostly its state's I/O (two saves and a restore of 12 B a
#: parameter).  With granite's paths and deeper training (qwen3 28,
#: falcon 16, zamba2 42 or 24, gemma3 12 layers) the run took 938.9 and
#: 1080.4 s to "done" on two H100 machines, against a 1200 s limit; at
#: qwen3 14, falcon 8, zamba2 12 and granite 16 layers 701.5 s, and
#: whisper's and llava's serve and train paths take about 210 s more, so
#: the earlier paths are cut again (qwen3 6 layers: 613,182,976
#: parameters; falcon 4: 687,591,424; zamba2 6, one group: 347,465,120).
#: qwen3's weights as a set and its training state as sets and deltas
#: (SET_KNOBS) took the run from 928.1 to 1053.2 s to "done" on an H100,
#: so falcon is cut to 2 layers (476,938,240), whisper to 6 + 6
#: (229,270,528) and llava to 2 (698,351,616): 825.6 s.  granite keeps
#: its 16: at 8 layers its step
#: 0's gradient norm through K1 lay 0.066 from the plain attention's
#: (4.932 vs 4.866), past TOL_TRAIN, where routing flips on near ties
#: part the two paths (at 16, 8.238 vs 8.162, within it).  The disk bounds
#: them too: two state files coexist while the final save commits, and the
#: run keeps its footprint under 45 GiB (falcon's at 64 layers would also
#: not fit the card: 112 GB at 16 B a parameter; zamba2's two at 54 layers
#: are 54.3 GB, gemma3's at 34 are 93.1 GB).  The distributed phase of
#: qwen3's weights (69 s in its first full run, a run of 1042.9 s to
#: "done" on an H100 machine that took 198.8 s over the kernel checks,
#: 35.1 s more than the machine of the 825.6 s run) cut qwen3's training
#: from 6 layers to 4 (512,510,976 parameters); the dry-run phase's run
#: reached "done" at 1142.0 s on an H100 machine whose kernel checks took
#: 220.5 s, which cut it to 2 (411,838,976).
TRAIN_B, TRAIN_S, TRAIN_CHUNK = 8, 1024, 256
#: The serve paths cut in depth, at full width, for the run's time: with
#: the scdatool phase (about 30 s) a final run on a slow H100 machine
#: reached "done" at 1205.1 s.  Half of falcon-mamba-7b's 64 layers and of
#: llava-next-mistral-7b's 32 (each halves a 14 GB save and restore), and
#: three of gemma3-4b's 5:1 periods of its 34 layers (15 local, 3 global):
#: 1150.9 s on another; then half of granite-moe-3b-a800m's 32 layers.
FALCON_SERVE_LAYERS = 32
GEMMA_SERVE_LAYERS = 18
LLAVA_SERVE_LAYERS = 16
GRANITE_SERVE_LAYERS = 16
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_DIE_AT = 6, 3, 3
#: The training paths' AdamW settings (``AdamWConfig``'s arguments).
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
QWEN_TRAIN_LAYERS = 2
FALCON_TRAIN_LAYERS = 2
#: zamba2's cut is in whole groups (1 of its 9, so 1 shared-attention
#: application).  Its device memory fits at 54 layers (a 53.6 GB peak).
ZAMBA_TRAIN_LAYERS = 6
#: gemma3-4b trains one whole 5:1 period (layers 0-4 local, 5 global), on
#: GEMMA_TRAIN_B x GEMMA_TRAIN_S tokens a step, the 8192 of the other
#: paths, so that its 1024-key window masks (at 1024 tokens it masks
#: nothing).
GEMMA_TRAIN_LAYERS = 6
GEMMA_TRAIN_B, GEMMA_TRAIN_S = 2, 4096
#: granite-moe-3b-a800m's two state files would be 39.6 GB each at its 32
#: layers; at 16, 20.2 GB (its state on the card 27.0 GB at 16 B a
#: parameter).
GRANITE_TRAIN_LAYERS = 16
#: whisper-medium trains WHISPER_TRAIN_LAYERS of its 24 encoder and of its
#: 24 decoder layers (a 2.75 GB state file; 9.1 GB at its full depth) on
#: TRAIN_B x (WHISPER_FRAMES frames + WHISPER_TOKENS tokens) a step.
WHISPER_TRAIN_LAYERS = 6
#: llava-next-mistral-7b trains LLAVA_TRAIN_LAYERS of its 32 layers on
#: LLAVA_TRAIN_B x (LLAVA_PATCHES image positions + LLAVA_TRAIN_TEXT text
#: tokens) a step, the loss over the text (its state file at 2 layers,
#: 698,351,616 parameters, 8.4 GB; at 4, 13.8 GB; at 32 layers 87.1 GB).
LLAVA_TRAIN_LAYERS = 2
LLAVA_TRAIN_B, LLAVA_TRAIN_TEXT = 2, 1024
#: One falcon layer at the training shape, kernel path against plain path
#: on the same inputs: its bf16 output as REL_LAYER_PLAIN, its bf16
#: gradients (each rounded once from f32 sums taken in another order) by
#: relative L2.
REL_LAYER_GRAD = 1e-2
#: One zamba2 group at the training shape (6 Mamba2 layers, then the shared
#: attention), K1 against the plain attention on the same inputs: the
#: output, the gradient at the application's input and the shared block's
#: gradients, which K1 reaches directly, as REL_LAYER_GRAD.  The Mamba2
#: layers' gradients and dL/du reach it only through the backward of 6
#: random bf16 Mamba2 layers, which amplifies the 1e-3 at the
#: application's input about 14 times (1.2e-2 to 1.5e-2), while either
#: path's bf16 gradients lie 0.2 to 0.3 (relative L2) from the group's f32
#: gradients: these are held against an f32 run of the group, the kernel
#: path's distance from it within GROUP_F32_RATIO of the plain path's.
GROUP_F32_RATIO = 1.1
#: Step 0's loss and global gradient norm through K1 against the same step
#: through the plain attention (up to 16 layers in bf16, the plain
#: version's rounding of p per 512-key chunk against the kernel's per 64
#: keys).
TOL_TRAIN = dict(rtol=1e-2, atol=1e-2)
#: qwen3-1.7b's weights and its training state as parity-protected scda
#: sets of SET_SHARDS data shards and SET_PARITY parity files.  The
#: weights' set loses the data shards SET_LOST, restores through the
#: parity and has them rebuilt; then the attention weights of DELTA_LAYERS
#: change, as a deploy of partly retrained weights would, and are saved as
#: a delta of the set.  The training path takes the layout through the
#: reference launcher's knobs, SET_KNOBS, and loses data shard
#: SET_LOST[0] of its step-3 set before run 2.
SET_SHARDS, SET_PARITY = 4, 2
SET_LOST = (1, 3)
DELTA_LAYERS = (5, 17)
#: The tools phase's target on the card, in seconds (printed beside its
#: time; not a hold).
TOOLS_BUDGET_S = 30.0
SET_KNOBS = {"REPRO_SCDA_SHARDS": str(SET_SHARDS),
             "REPRO_SCDA_PARITY": str(SET_PARITY), "REPRO_SCDA_DELTA": "1"}
#: qwen3-1.7b's weights as DTensors on DIST_RANKS spawned gloo ranks, all
#: on the one card: restored onto ``params_shardings`` of each mesh of
#: DIST_MESHES (axes DIST_AXES) and saved from there, and restored onto
#: DIST_EXTRA, with and without prefetch: the reference's third elastic
#: case (``tests/helpers/elastic_roundtrip.py:103``), P(("data",
#: "model"), None) on the 2-D leaves, and every leaf replicated.  The
#: runs of DIST_EXTRA[DIST_EXTRA_SPLIT[i]:DIST_EXTRA_SPLIT[i + 1]] follow
#: mesh i's save, so that the main process's hash of each saved file
#: (about 4 s) runs beside them.
DIST_RANKS = 4
DIST_AXES = ("data", "model")
DIST_MESHES = ((2, 2), (4, 1), (1, 4))
DIST_EXTRA = (("elastic", (2, 2), None), ("elastic", (2, 2), 0),
              ("replicated", (4, 1), None), ("replicated", (4, 1), 0))
DIST_EXTRA_SPLIT = (0, 2, 3, 4)
#: The model path under a mesh, in the distributed phase's ranks, on the
#: weights they restored: (a) TP + FSDP serving on MESH_TP, a
#: 4 x MESH_PROMPT prefill and MESH_DECODE decode steps from a seeded
#: cache of MESH_PROMPT positions; (b) sequence-parallel decode on
#: MESH_SP, one request, an SP_CACHE cache (SP_CACHE / 4 a rank),
#: MESH_DECODE steps from SP_START (the new token's owner moves from rank
#: 2 to rank 3, rank 3's shard starts wholly masked); (c) training
#: MESH_TRAIN_LAYERS layers at full width, step 0 on MESH_TP saved by its
#: run's closing save through the ranked manager, step 1 resumed on
#: MESH_SP.  Cuts to depth and steps (decode 8 -> 4 steps, training 3 ->
#: 2, for the run's time; (b) from 3070, so the owner still moves); each
#: is held against one device's run in the parent: the prefill's bf16
#: logits at TOL_LOGITS, the decode steps replayed in f32 at TOL_MESH_F32
#: (their largest sound error on an H100 was 2.1e-5), and (c) as
#: TOL_MESH_LOSS and TOL_MESH_UPDATE say.
MESH_TP, MESH_SP = (2, 2), (4, 1)
MESH_PROMPT, MESH_DECODE = 512, 4
SP_CACHE, SP_START = 4096, 3070
MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS = 2, 2
MESH_TRAIN_B, MESH_TRAIN_S = 4, 256
#: (c)'s optimizer: no warmup, so that step 0's update moves step 1's loss
#: (at the default 100 warmup steps its rate is 6e-6 and the move was
#: about 0.004 on an H100).
MESH_TRAIN_OPT = dict(total_steps=MESH_TRAIN_STEPS, warmup_steps=0)
TOL_MESH_F32 = dict(rtol=1e-3, atol=1e-3)
#: (c)'s losses against one device's: the mesh sums its bf16 products in
#: another order (1.6e-4 apart at step 0 on an H100).  The run also checks
#: that this is MESH_LOSS_MARGIN times smaller than what step 0's update
#: moves step 1's loss by (one device's loss of step 1's batch before the
#: update against after it), so that a lost or wrong update shows.
TOL_MESH_LOSS = dict(rtol=0.0, atol=2e-3)
MESH_LOSS_MARGIN = 10
#: (c)'s global gradient norm of each step and each leaf's update norm
#: (the norm of its parameters' change in the step) against one
#: device's.  AdamW's first steps move each weight by about the rate,
#: whatever its gradient's size: a leaf whose gradient is lost moves by
#: its weight decay alone.
TOL_MESH_UPDATE = dict(rtol=1e-2, atol=0.0)


_START = time.perf_counter()


def phase(name: str) -> None:
    """Mark the start of a phase with the run's elapsed seconds."""
    print(f"[{time.perf_counter() - _START:.1f} s] {name}", flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time of one ``fn()`` on the card's timeline, launch gaps
    included (CUDA events around ``iters`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of the kernels one ``fn()`` launches (the sum of
    their durations in a ``torch.profiler`` CUDA trace): what the card
    spends, without the host's launch overhead."""
    return sum(device_split_ms(fn, iters, warmup=warmup).values())


def device_split_ms(fn, iters: int, parts=(), warmup: int = 3):
    """Mean device time a ``fn()`` spends in the kernels whose names hold
    each of ``parts``, by part; without parts, ``{"": all its kernels}``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    rows, _ = profiled(torch, run)
    return {part: sum(e.self_device_time_total for e in rows
                      if part in e.key) / 1e3 / iters
            for part in (parts or ("",))}


#: Profiles taken, and those that came back with no device activity and
#: were taken again (printed at the end of the run).
PROFILES = {"taken": 0, "empty": 0}
#: Seconds of host idle inside each end of a profiler's window (see
#: ``profiled``).
PROFILE_PAD_S = 0.02


def profiled(torch, fn, tries: int = 3):
    """Run ``fn()`` once under ``torch.profiler`` (host and card
    activity); return the profile's device rows (kernels, copies, sets;
    operator rows and ranges a program marked are left out, as their
    device time repeats their kernels') and the run's time on the card's
    clock in ms (CUDA events around it).

    The trace keeps only the card's activity whose timestamps, put on
    the host's clock, fall inside the profiler's window, and that
    conversion is now and then off by milliseconds: the first kernels,
    or all of them, then fall before the window and are dropped.  So the
    run sits PROFILE_PAD_S inside the window at each end, and a profile
    that still recorded no device time is taken again, ``fn()`` run
    anew, up to ``tries`` times in all; the script fails if none did."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        PROFILES["taken"] += 1
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation]
        if sum(e.self_device_time_total for e in rows) > 0:
            return rows, start.elapsed_time(end)
        PROFILES["empty"] += 1
        print(f"profile {PROFILES['taken']} recorded no device time "
              f"(try {attempt + 1} of {tries})", flush=True)
    fail(f"the profiler recorded no device time in {tries} tries")


def timings(kernel, plain, library, iters: int):
    """Device and per-call times of the kernel, its plain version and the
    library yardstick (None where no library call computes the same
    function) on the same inputs."""
    few = max(2, iters // 10)
    return dict(ms=device_time_ms(kernel, iters),
                plain_ms=device_time_ms(plain, few),
                library_ms=None if library is None
                else device_time_ms(library, iters),
                call_ms=cuda_time_ms(kernel, iters),
                plain_call_ms=cuda_time_ms(plain, few),
                library_call_ms=None if library is None
                else cuda_time_ms(library, iters))


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_err(a, b) -> float:
    """Relative L2 error of ``a`` against ``b``."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def assert_close(a, b, tol, what: str) -> float:
    import torch
    err = max_err(a, b)
    ok = torch.allclose(a.float(), b.float(), **tol)
    check(ok, f"{what}: max abs err {err} exceeds {tol}")
    return err


# ---------------------------------------------------------------- phase 2 --
def kernel_checks(torch, fa):
    """K1 against its plain version: small f32 cases (prefill and decode,
    the decode kernel's split boundaries among them, head dims 64 to 256,
    unmasked over 1500 keys), then the main paths' bf16 shapes with times
    at each served model's heads (K1_HEADS): the prefill kernel at 4 × 512
    or the model's own shapes (K1_PREFILLS), the decode kernel at four
    offsets and whisper's cross-attention decode; then gemma3's
    long-context shapes.  Returns the per-shape measurement records,
    qwen3's first."""
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(SEED)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=cuda,
                           dtype=torch.float32).to(dtype)

    off = lambda v: torch.tensor(v, dtype=torch.int32, device=cuda)  # noqa
    # (B, H, Hkv, Sq, Skv, D, causal, window, q_offset)
    small = [
        (1, 2, 1, 37, 37, 64, True, None, 0),       # ragged Skv
        (2, 8, 2, 70, 70, 128, True, None, 0),      # GQA group 4
        (1, 16, 1, 9, 9, 128, True, None, 0),       # group 16
        (1, 4, 2, 20, 100, 32, False, None, 0),     # non-causal, Sq != Skv
        (1, 4, 4, 130, 130, 64, True, 16, 0),       # sliding window
        (2, 4, 2, 5, 40, 128, True, None, 30),      # q_offset > 0 (host int)
        (2, 4, 2, 5, 40, 128, True, None, off(30)),  # q_offset on device
        (3, 4, 2, 1, 300, 16, True, 64, off(157)),  # decode Sq = 1, window
        (1, 2, 1, 8, 8, 64, True, 0, 0),            # empty window: all zero
        # the decode kernel's split boundaries (64 keys a split) in a
        # 150-key cache, groups 1, 2 and 16, a window across a split
        (2, 4, 4, 1, 150, 64, True, None, off(0)),
        (2, 4, 2, 1, 150, 64, True, None, off(63)),
        (2, 4, 2, 1, 150, 64, True, None, off(64)),
        (2, 32, 2, 1, 150, 128, True, None, off(127)),
        (2, 4, 2, 1, 150, 128, True, 50, off(128)),
        (1, 16, 8, 1, MAX_LEN, 128, True, None, off(MAX_LEN - 1)),
        # head dim 80 (zamba2): prefill with group 1 and 4, a window, and
        # decode across split boundaries
        (2, 8, 8, 70, 70, 80, True, None, 0),
        (1, 8, 2, 100, 100, 80, True, 16, 0),
        (2, 4, 4, 5, 40, 80, True, None, off(30)),
        (2, 32, 32, 1, 150, 80, True, None, off(95)),
        (2, 4, 4, 1, MAX_LEN, 80, True, None, off(MAX_LEN - 1)),
        # head dim 256 (gemma3): prefill with group 2 and 16, a window over
        # several 32-key tiles, and decode across split boundaries, a
        # window across one
        (1, 8, 4, 70, 70, 256, True, None, 0),
        (1, 16, 1, 9, 9, 256, True, None, 0),
        (1, 8, 4, 100, 100, 256, True, 40, 0),
        (2, 8, 4, 1, 150, 256, True, None, off(63)),
        (2, 8, 4, 1, 150, 256, True, 50, off(128)),
        (1, 32, 2, 1, 150, 256, True, None, off(149)),
        # head dim 64 with group 3 (granite): a ragged prefill, and decode
        # across a split boundary
        (1, 24, 8, 70, 70, 64, True, None, 0),
        (2, 24, 8, 1, 150, 64, True, None, off(95)),
        # whisper's heads (group 1 of head dim 64) without the causal mask
        # over its 1500 frames (the last tile and split hold 28 keys), the
        # offset the host int 0 as its cross-attention passes it; llava's
        # (group 4 of head dim 128) in a ragged prefill
        (1, 16, 16, 37, 1500, 64, False, None, 0),
        (2, 16, 16, 1, 1500, 64, False, None, 0),
        (1, 32, 8, 70, 70, 128, True, None, 0),
    ]
    worst = 0.0
    for B, H, Hkv, Sq, Skv, D, causal, window, q_off in small:
        q = rand(B, Sq, H, D, dtype=torch.float32)
        k = rand(B, Skv, Hkv, D, dtype=torch.float32)
        v = rand(B, Skv, Hkv, D, dtype=torch.float32)
        kw = dict(causal=causal, window=window, q_offset=q_off)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        worst = max(worst, assert_close(
            got, want, TOL_F32,
            f"K1 f32 B{B} H{H}/{Hkv} Sq{Sq} Skv{Skv} D{D} {kw}"))
    print(f"K1 f32 cases: {len(small)} pass, max abs err {worst}")
    records = []
    for model, (H, Hkv, D) in K1_HEADS.items():
        records += k1_main_shapes(
            torch, fa, rand, off, model, H, Hkv, D,
            K1_PREFILLS.get(model, ((PREFILL_S, PREFILL_S, True),)),
            cross_kv=WHISPER_FRAMES if model == WHISPER else 0)
    records += k1_long_shapes(torch, fa, rand, off, *K1_HEADS[GEMMA])
    for r in records:
        print(f"K1 {r['kernel']} {r['shape']} ({r['model']}): err "
              f"{r['max_abs_err']} device ms "
              f"{r['ms']:.5f} plain {r['plain_ms']:.5f} sdpa "
              f"{r['library_ms']:.5f} bound {r['bound_ms']:.5f} "
              f"({r['bound_by']}); per call ms {r['call_ms']:.5f} plain "
              f"{r['plain_call_ms']:.5f} sdpa {r['library_call_ms']:.5f}"
              + (f"; sdpa took {r['library_backend']}"
                 if "library_backend" in r else ""))
    return records


def k1_main_shapes(torch, fa, rand, off, model, H, Hkv, D,
                   prefills=((PREFILL_S, PREFILL_S, True),), cross_kv=0):
    """K1 at a served model's heads, in bf16: the prefill kernel at each of
    ``prefills`` (Sq, Skv, causal; B = PREFILL_B) and the decode kernel at
    DECODE_OFFSETS of a MAX_LEN cache, and with ``cross_kv`` keys a
    cross-attention's decode (1 -> cross_kv, no mask, the offset the host
    int 0 as the model passes it), each held against its plain version and
    SDPA and timed beside them."""
    bf16 = torch.bfloat16
    sdpa = sdpa_gqa(torch)
    records = []

    # prefill: self-attention (causal) or attention to other positions
    # (the encoder's and a cross-attention's, Sq != Skv) in the model's
    # layout
    for Sq, Skv, causal in prefills:
        q = rand(PREFILL_B, Sq, H, D, dtype=bf16)
        k = rand(PREFILL_B, Skv, Hkv, D, dtype=bf16)
        v = rand(PREFILL_B, Skv, Hkv, D, dtype=bf16)
        kw = dict(causal=causal)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        seq = f"S{Sq}" if Sq == Skv else f"S{Sq}->{Skv}"
        what = f"{seq} {'causal' if causal else 'unmasked'}"
        err = assert_close(got, want, TOL_BF16, f"K1 bf16 prefill {what}")
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        lib = sdpa(qh, kh, vh, is_causal=causal)
        check(torch.allclose(lib.transpose(1, 2).float(), got.float(),
                             **TOL_BF16), f"SDPA yardstick disagrees "
              f"(prefill {what})")
        pairs = attended_pairs(Sq) if causal else Sq * Skv
        flops = 4 * PREFILL_B * H * D * pairs
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
        iters = 50 if pairs <= PREFILL_S * PREFILL_S else 20
        records.append(dict(
            shape=f"prefill B{PREFILL_B} {seq} H{H}/{Hkv} D{D} "
                  f"{'causal' if causal else 'unmasked'} bf16",
            kernel="flash_prefill_kernel", max_abs_err=err,
            **timings(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                      lambda: fa.flash_attention_plain(q, k, v, **kw),
                      lambda: sdpa(qh, kh, vh, is_causal=causal), iters),
            **bound(nbytes, flops, PEAK_BF16_FLOPS)))

    # decode: Sq = 1 against an S_max = 1024 cache at several offsets, and
    # a cross-attention's decode against all of cross_kv keys.  The caches
    # rotate over enough copies (> 50 MB L2) to be read cold, as a layer's
    # cache is in the model's step.
    copies = 16
    qd = rand(SERVE_B, 1, H, D, dtype=bf16)
    cases = [(MAX_LEN, pos) for pos in DECODE_OFFSETS]
    cases += [(cross_kv, None)] if cross_kv else []
    by_len = {}
    for Skv, pos in cases:
        if Skv not in by_len:
            by_len[Skv] = [(rand(SERVE_B, Skv, Hkv, D, dtype=bf16),
                            rand(SERVE_B, Skv, Hkv, D, dtype=bf16))
                           for _ in range(copies)]
        caches = by_len[Skv]
        # the self-attention's offset lives on the device; a
        # cross-attention passes the host int 0 and no mask
        kw = (dict(q_offset=off(pos)) if pos is not None
              else dict(causal=False, q_offset=0))
        live = Skv if pos is None else pos + 1
        kc, vc = caches[0]
        got = fa.flash_attention_cuda(qd, kc, vc, **kw)
        want = fa.flash_attention_plain(qd, kc, vc, **kw)
        what = f"pos{pos}" if pos is not None else f"cross Skv{Skv}"
        err = assert_close(got, want, TOL_BF16, f"K1 bf16 decode {what}")
        lib = sdpa(qd.transpose(1, 2), kc[:, :live].transpose(1, 2),
                   vc[:, :live].transpose(1, 2))
        check(torch.allclose(lib.transpose(1, 2).float(), got.float(),
                             **TOL_BF16), f"SDPA disagrees (decode {what})")
        it = iter(range(1 << 30))

        def kern():
            kc_, vc_ = caches[next(it) % copies]
            fa.flash_attention_cuda(qd, kc_, vc_, **kw)

        def plain():
            kc_, vc_ = caches[next(it) % copies]
            fa.flash_attention_plain(qd, kc_, vc_, **kw)

        def library():
            kc_, vc_ = caches[next(it) % copies]
            sdpa(qd.transpose(1, 2), kc_[:, :live].transpose(1, 2),
                 vc_[:, :live].transpose(1, 2))

        flops = 4 * SERVE_B * H * D * live
        nbytes = 2 * (2 * qd.numel() + 2 * SERVE_B * live * Hkv * D)
        records.append(dict(
            shape=(f"decode B{SERVE_B} Smax{MAX_LEN} pos{pos}"
                   if pos is not None else f"decode B{SERVE_B} cross "
                   f"Skv{Skv} unmasked") + f" H{H}/{Hkv} D{D} bf16",
            kernel="flash_decode_kernel",
            max_abs_err=err, **timings(kern, plain, library, 200),
            **bound(nbytes, flops, PEAK_BF16_FLOPS)))
    for r in records:
        r["model"] = model
    return records


def decode_lse_checks(torch, fa):
    """The decode kernel with its log-sum-exp (sequence-parallel decode's
    merge weights) against the plain decode and ``lse_plain``: f32 at head
    dims 64, 80, 128 and 256 with the query offset below 0 (every key
    masked: output 0, lse -inf), 0, inside the keys and past them,
    windowed and not; then bf16 at qwen3's heads over one rank's shard of
    (b)'s cache (SP_CACHE / 4 keys), timed with and without the lse beside
    the plain version.  Returns the records, the main shape's first."""
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(SEED + 5)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=cuda,
                           dtype=torch.float32).to(dtype)

    def hold(q, k, v, kw, tol, what):
        out, lse = fa.flash_attention_cuda(q, k, v, with_lse=True, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        want_lse = fa.lse_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = assert_close(out, want, tol, f"{what}: output")
        live = torch.isfinite(want_lse)
        check(torch.equal(live, torch.isfinite(lse)),
              f"{what}: lse is -inf elsewhere than lse_plain")
        if bool(live.any()):
            err = max(err, assert_close(lse[live], want_lse[live], LSE_TOL,
                                        f"{what}: lse"))
        return err

    worst, n = 0.0, 0
    S = 300
    for D in (64, 80, 128, 256):
        for pos in (-5, 0, 150, S - 1, S + 200):
            for window in (None, 64):
                q = rand(2, 1, 8, D, dtype=torch.float32)
                k = rand(2, S, 4, D, dtype=torch.float32)
                v = rand(2, S, 4, D, dtype=torch.float32)
                kw = dict(window=window, q_offset=torch.tensor(
                    pos, dtype=torch.int32, device=cuda))
                worst = max(worst, hold(q, k, v, kw, TOL_F32,
                                        f"K1 decode+lse f32 D{D} pos {pos} "
                                        f"window {window}"))
                n += 1
    print(f"K1 decode with lse, f32: {n} cases pass, max abs err {worst}")
    H, Hkv, D = K1_HEADS[QWEN]
    S = SP_CACHE // MESH_SP[0]
    bf16 = torch.bfloat16
    q = rand(1, 1, H, D, dtype=bf16)
    k = rand(1, S, Hkv, D, dtype=bf16)
    v = rand(1, S, Hkv, D, dtype=bf16)
    records = []
    for pos in (S - 1, S // 2, -S // 2):
        p = torch.tensor(pos, dtype=torch.int32, device=cuda)
        kw = dict(q_offset=p)
        err = hold(q, k, v, kw, TOL_BF16, f"K1 decode+lse bf16 pos {pos}")
        live = max(0, min(S, pos + 1))
        rec = dict(
            shape=f"decode+lse B1 Skv{S} (one rank's shard of {SP_CACHE}) "
                  f"q_offset {pos} H{H}/{Hkv} D{D} bf16",
            kernel="flash_decode_kernel (lse)", model=f"{QWEN}, SP decode",
            max_abs_err=err,
            no_lse_ms=device_time_ms(
                lambda: fa.flash_attention_cuda(q, k, v, **kw), 200),
            **timings(lambda: fa.flash_attention_cuda(q, k, v, with_lse=True,
                                                      **kw),
                      lambda: (fa.flash_attention_plain(q, k, v, **kw),
                               fa.lse_plain(q, k, v, **kw)), None, 200),
            **bound(2 * (2 * q.numel() + 2 * live * Hkv * D) + 4 * H,
                    4 * H * D * live, PEAK_BF16_FLOPS))
        records.append(rec)
        print(f"K1 {rec['shape']}: err {err} device ms {rec['ms']:.5f} "
              f"(without the lse {rec['no_lse_ms']:.5f}) plain "
              f"{rec['plain_ms']:.5f} bound {rec['bound_ms']:.5f} "
              f"({rec['bound_by']})")
    return records


def k1_long_shapes(torch, fa, rand, off, H, Hkv, D):
    """K1 at gemma3's long-context shapes in bf16: the prefill kernel over
    1 x LONG_S tokens with the local layers' window and without it (the
    global layers), and the decode kernel at the last position of a
    LONG_S cache (SERVE_B requests) with and without the window, each
    held against its plain version and SDPA, and timed beside SDPA with
    the backend SDPA took (a boolean mask for the windowed prefill; the
    window's keys, a view of the cache, for the windowed decode)."""
    from repro_torch.configs import get_config
    bf16 = torch.bfloat16
    sdpa = sdpa_gqa(torch)
    W, S = get_config(GEMMA).attn_window, LONG_S
    records = []
    q = rand(1, S, H, D, dtype=bf16)
    k = rand(1, S, Hkv, D, dtype=bf16)
    v = rand(1, S, Hkv, D, dtype=bf16)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    i = torch.arange(S, device=q.device)
    local = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < W)
    for window in (W, None):
        kw = dict(causal=True, window=window)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        err = assert_close(got, want, TOL_BF16,
                           f"K1 bf16 prefill 1 x {S} window {window}")
        lib_kw = (dict(attn_mask=local) if window
                  else dict(is_causal=True))

        def library():
            return sdpa(qh, kh, vh, **lib_kw)
        check(torch.allclose(library().transpose(1, 2).float(), got.float(),
                             **TOL_BF16),
              f"SDPA disagrees (prefill 1 x {S} window {window})")
        pairs = sum(min(p + 1, window or S) for p in range(S))
        records.append(dict(
            shape=f"prefill B1 S{S} H{H}/{Hkv} D{D} causal window "
                  f"{window} bf16", kernel="flash_prefill_kernel",
            max_abs_err=err, library_backend=library_backend(torch, library),
            **timings(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                      lambda: fa.flash_attention_plain(q, k, v, **kw),
                      library, 20),
            **bound(2 * (q.numel() + k.numel() + v.numel() + got.numel()),
                    4 * H * D * pairs, PEAK_BF16_FLOPS)))

    # decode at the last position of a full LONG_S cache; 4 copies of it
    # (67 MB each) rotate, so each is read cold
    copies, pos = 4, S - 1
    caches = [(rand(SERVE_B, S, Hkv, D, dtype=bf16),
               rand(SERVE_B, S, Hkv, D, dtype=bf16)) for _ in range(copies)]
    qd = rand(SERVE_B, 1, H, D, dtype=bf16)
    p = off(pos)
    for window in (W, None):
        lo = pos + 1 - (window or S)
        kw = dict(window=window, q_offset=p)
        kc, vc = caches[0]
        got = fa.flash_attention_cuda(qd, kc, vc, **kw)
        want = fa.flash_attention_plain(qd, kc, vc, **kw)
        err = assert_close(got, want, TOL_BF16,
                           f"K1 bf16 decode pos {pos} window {window}")
        it = iter(range(1 << 30))

        def run(fn):
            def call():
                kc_, vc_ = caches[next(it) % copies]
                return fn(kc_, vc_)
            return call

        def lib(kc_, vc_):
            return sdpa(qd.transpose(1, 2), kc_[:, lo:].transpose(1, 2),
                        vc_[:, lo:].transpose(1, 2))
        check(torch.allclose(lib(kc, vc).transpose(1, 2).float(),
                             got.float(), **TOL_BF16),
              f"SDPA disagrees (decode {pos} window {window})")
        live = pos + 1 - lo
        records.append(dict(
            shape=f"decode B{SERVE_B} Smax{S} pos{pos} H{H}/{Hkv} D{D} "
                  f"window {window} bf16", kernel="flash_decode_kernel",
            max_abs_err=err, library_backend=library_backend(
                torch, run(lib)),
            **timings(
                run(lambda a, b: fa.flash_attention_cuda(qd, a, b, **kw)),
                run(lambda a, b: fa.flash_attention_plain(qd, a, b, **kw)),
                run(lib), 200),
            **bound(2 * (2 * qd.numel() + 2 * SERVE_B * live * Hkv * D),
                    4 * SERVE_B * H * D * live, PEAK_BF16_FLOPS)))
    for r in records:
        r["model"] = f"{GEMMA}, long context"
    return records


def sdpa_gqa(torch):
    """PyTorch's fused attention with grouped kv heads: the timing
    yardstick only (the port never calls it).  Before torch 2.5 it has no
    ``enable_gqa``; there the kv heads are repeated inside the call."""
    f = torch.nn.functional.scaled_dot_product_attention
    if tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5):
        return lambda q, k, v, **kw: f(q, k, v, enable_gqa=True, **kw)

    def repeated(q, k, v, **kw):
        rep = q.shape[1] // k.shape[1]
        return f(q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1),
                 **kw)
    return repeated


def sdpa_masks(torch, Sq, Skv, causal=True, window=None, device="cuda"):
    """SDPA's keyword arguments for K1's masks (query offset 0): causal
    alone as ``is_causal``, a window as a boolean (Sq, Skv) mask."""
    if window is None:
        return dict(is_causal=causal)
    q_pos = torch.arange(Sq, device=device)[:, None]
    kv_pos = torch.arange(Skv, device=device)[None, :]
    mask = q_pos - kv_pos < window
    return dict(attn_mask=mask & (kv_pos <= q_pos) if causal else mask)


def attended_pairs(S: int, window=None) -> int:
    """(position, key) pairs a causal attention over S tokens computes,
    with a window of ``window`` keys or without."""
    w = S if window is None else window
    return sum(min(i + 1, w) for i in range(S))


def ptxas_summary(log: str):
    """One line per compiled kernel from nvcc's ``-Xptxas=-v`` log: its
    name and template arguments, registers, spills and static shared
    memory; and each of ptxas's performance warnings (wgmma serialized)."""
    name, spill = None, ""
    for line in log.splitlines():
        if "Potential Performance Loss" in line:
            what = line.split("Potential Performance Loss:", 1)[1]
            yield (f"{_kernel_name(line.split(chr(39))[1])}: WARNING"
                   f"{what.split(' for the function')[0]}")
        elif "Compiling entry function" in line:
            name = _kernel_name(line.split("'")[1])
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            yield f"{name}: {line.split('Used', 1)[1].strip()}; {spill}"
            name, spill = None, ""


def print_prefill_occupancy(log: str) -> None:
    """The bf16 prefill kernel's blocks an SM at each head dim, from its
    ptxas registers (65,536 a SM, allotted 8 a thread at a time, 128
    threads a block) and its shared memory (rows of D + 8 bf16: 4 tiles of
    64 keys, or at D 256 4 tiles of 32 keys and Q's 64 rows; 233,472 B a
    SM, 1 KB of it reserved a block)."""
    import re
    for line in ptxas_summary(log):
        m = re.match(r"flash_prefill_kernel<(\d+), (\d)>: (\d+) registers",
                     line)
        if m:
            D, regs = int(m.group(1)), int(m.group(3))
            rows, asked = (4 * 32 + 64, 2) if D > 128 else (4 * 64, 3)
            by_regs = 65536 // (-(-regs // 8) * 8 * 128)
            by_smem = 233472 // (rows * (D + 8) * 2 + 1024)
            print(f"  K1 prefill D {D} lse {m.group(2)}: {regs} registers: "
                  f"{by_regs} blocks an SM by registers, {by_smem} by shared "
                  f"memory (the launch bounds ask {asked})")


def _kernel_name(mangled: str) -> str:
    """``ns::kernel<dtype, D>`` from an Itanium-mangled kernel name: the
    last of the nested <length><name> parts, then the template arguments
    (a bf16 or f32 type, integers)."""
    import re
    i, parts = 3, []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    rest = mangled[i:]
    if not parts or not rest.startswith("I") or "EEv" not in rest:
        return parts[-1] if parts else mangled
    targs = rest[1:rest.index("EEv")]
    args = (["bf16"] if "bfloat16" in targs
            else ["f32"] if targs.startswith("f") else [])
    args += re.findall(r"L[ib](\d+)E", targs)   # ints, then bool flags
    return f"{parts[-1]}<{', '.join(args)}>"


def bound(nbytes: int, flops: int, peak_flops: float, exps: int = 0):
    """The least time for the work: bytes at the memory rate, or its
    operations, the larger of its flops at ``peak_flops`` and its
    exponentials at the SFU rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / peak_flops, exps / PEAK_EXP_PER_S) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, exps=exps)


def scan_checks(torch, ss, cfg):
    """K2 against its plain version: small cases, then the main path's
    shape (falcon-mamba's prefill: B=4, S=512, d_inner, N) with times."""
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(SEED)

    def inputs(B, S, d, N, dtype):
        def rand(*shape):
            return torch.randn(shape, generator=gen, device=cuda,
                               dtype=torch.float32)
        return (torch.sigmoid(rand(B, S, d, N)).to(dtype),
                (0.1 * rand(B, S, d, N)).to(dtype), rand(B, S, N).to(dtype))

    f32, bf16 = torch.float32, torch.bfloat16
    small = [(1, 1, 1, 1, f32),       # one step, one state
             (2, 37, 5, 3, f32),      # ragged S, N not a power of two
             (3, 70, 33, 8, f32),     # d that no block of 16 channels divides
             (1, 130, 7, 1, f32),     # one lane per channel
             (2, 20, 3, 32, f32),     # a channel fills a warp
             (2, 9, 100, 16, f32),    # the model's N
             (2, 41, 24, 16, bf16)]   # bf16 inputs, read as f32
    worst = 0.0
    for B, S, d, N, dtype in small:
        x = inputs(B, S, d, N, dtype)
        got = ss.ssm_scan_cuda(*x)
        want = ss.ssm_scan_plain(*x)
        torch.cuda.synchronize()
        worst = max(worst, assert_close(
            got, want, TOL_SCAN, f"K2 B{B} S{S} d{d} N{N} {dtype}"))
    print(f"K2 small cases: {len(small)} pass, max abs err {worst}")

    B, S, d, N = PREFILL_B, PREFILL_S, cfg.d_inner, cfg.ssm_state
    x = inputs(B, S, d, N, f32)
    got = ss.ssm_scan_cuda(*x)
    want = ss.ssm_scan_plain(*x)
    err = assert_close(got, want, TOL_SCAN, "K2 main shape")
    del want
    nbytes = 4 * (2 * B * S * d * N + B * S * N + B * S * d)
    flops = 4 * B * S * d * N   # two for h, two for y, per state element
    rec = dict(shape=f"prefill B{B} S{S} d{d} N{N} f32", max_abs_err=err,
               small_cases_max_abs_err=worst,
               **timings(lambda: ss.ssm_scan_cuda(*x),
                         lambda: ss.ssm_scan_plain(*x), None, 20),
               **bound(nbytes, flops, PEAK_F32_FLOPS))
    print(f"K2 {rec['shape']}: err {err} device ms {rec['ms']:.5f} plain "
          f"{rec['plain_ms']:.5f} bound {rec['bound_ms']:.5f} "
          f"({rec['bound_by']}, {nbytes} B); per call ms "
          f"{rec['call_ms']:.5f} plain {rec['plain_call_ms']:.5f}; no "
          f"library call computes it")
    return [rec]


def fused_cases(torch):
    """(B, S, d, N, dtype, lead) for the fused forward and the backward:
    ragged S (shorter than a stage, or no multiple of 16 or of a stage), N
    of 1, 2, 3, 8, 16 and 32 (every instantiation of both kernels), d that
    no block divides, bf16 and f32 (a bf16 case's backward is also held in
    f32, on the same values cast); B and C
    contiguous (lead None) or row slices of one (B, S, lead + 2N) tensor
    from element ``lead``: 5 misses TMA's 16-byte alignment (the threads'
    load path), 16 meets it where the rest of the case does."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [(1, 1, 1, 1, f32, None),      # one step, one state
            (2, 37, 5, 3, f32, None),     # ragged S, N not a power of two
            (3, 70, 33, 8, f32, 5),       # d no block divides, strided
            (1, 130, 7, 1, f32, None),    # one lane per channel
            (2, 20, 3, 32, f32, 5),       # 32 states
            (2, 9, 100, 16, f32, None),   # the model's N; TMA
            (1, 64, 300, 16, f32, 5),     # S a multiple of 16, many blocks
            (2, 41, 24, 16, bf16, 5),     # bf16 inputs, read as f32
            (1, 33, 17, 3, bf16, None),
            (2, 33, 24, 2, f32, 16),      # 2 states: too short a row for TMA
            (2, 45, 64, 16, bf16, 16),    # TMA: S past a stage
            (3, 70, 40, 8, f32, 16),      # TMA, d no block divides
            (1, 20, 96, 32, bf16, 16),    # TMA, 32 states, S within a stage
            (16, 5, 4096, 16, bf16, None),   # TMA, passes in the backward
            (16, 5, 4096, 16, f32, 5)]       # the threads' path, passes


def fused_inputs(torch, gen, B, S, d, N, dtype, lead):
    """x, dt, B, C, A as the model makes them (dt a softplus, A = -exp of
    log(1..N) per channel), x, dt, B, C in ``dtype``; B and C as row
    slices of one (B, S, lead + 2N) tensor from element ``lead`` (the
    model's x_proj output has lead dt_rank), or contiguous (lead None)."""
    cuda = torch.device("cuda")

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda,
                           dtype=torch.float32)
    x = rand(B, S, d).to(dtype)
    dt = torch.nn.functional.softplus(rand(B, S, d) - 1.0).to(dtype)
    if lead is not None:
        dbc = rand(B, S, lead + 2 * N).to(dtype)
        Bs, Cs = dbc[..., lead:lead + N], dbc[..., lead + N:]
    else:
        Bs, Cs = rand(B, S, N).to(dtype), rand(B, S, N).to(dtype)
    A = -torch.exp(torch.log(torch.arange(
        1, N + 1, device=cuda, dtype=torch.float32)).expand(d, N).contiguous()
        + 0.3 * rand(d, N))
    return x, dt, Bs, Cs, A


def dt_rank(cfg) -> int:
    """The Mamba1 block's dt rank: x_proj's output row holds dt_rank
    elements, then B and C (``repro_torch.models.ssm``)."""
    return max(1, cfg.d_model // 16)


def plan_text(plan) -> str:
    return (f"L {plan.lanes} ({plan.lane_states} states a lane), "
            f"{'TMA' if plan.tma else 'threads'} load path, "
            f"{plan.channels} channels a block in {plan.passes} pass(es), "
            f"grid {plan.grid}, {plan.smem_bytes} B shared")


def fused_scan_checks(torch, ss, cfg):
    """The fused K2 forward against mamba1_scan_plain on small cases, on
    both load paths (with its states against scan_states_plain), then the
    main path's shapes with times: falcon-mamba's prefill 4 x 512 and its
    training 8 x 1024 (with the states autograd keeps), d_inner, N, bf16,
    B and C slices of x_proj's output as the model has them (the TMA
    path)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst, paths = 0.0, {}
    for B, S, d, N, dtype, lead in fused_cases(torch):
        x, dt, Bs, Cs, A = fused_inputs(torch, gen, B, S, d, N, dtype, lead)
        want = ss.mamba1_scan_plain(x, dt, Bs, Cs, A)
        want_states = ss.scan_states_plain(x, dt, Bs, A)
        states = torch.full(ss.states_shape(B, S, d, N), float("nan"),
                            device="cuda")
        got = ss.ssm_scan_fused_cuda(x, dt, Bs, Cs, A, states=states)
        plan = ss.ssm_scan_fused_cuda.last_plan
        bare = ss.ssm_scan_fused_cuda(x, dt, Bs, Cs, A)
        torch.cuda.synchronize()
        what = (f"K2 fused B{B} S{S} d{d} N{N} {dtype} lead {lead} "
                f"P{plan.lane_states} tma {plan.tma}")
        check(torch.equal(got, bare), f"{what}: y depends on the states")
        worst = max(worst, assert_close(got, want, TOL_SCAN, what))
        worst = max(worst, assert_close(states, want_states, TOL_SCAN,
                                        f"{what} states"))
        key = (plan.lanes, plan.lane_states, plan.tma)
        paths[key] = paths.get(key, 0) + 1
    check({P for _, P, _ in paths} == {1 << k for k in range(6)}
          and {tma for _, _, tma in paths} == {False, True},
          f"K2 fused small cases miss a state size or a load path: "
          f"{sorted(paths)}")
    print(f"K2 fused small cases: {sum(paths.values())} pass (y and states) "
          f"over (L, states a lane, TMA) {sorted(paths.items())}, max abs "
          f"err {worst} (tol {TOL_SCAN})")

    records = []
    d, N = cfg.d_inner, cfg.ssm_state
    for label, B, S in (("prefill", PREFILL_B, PREFILL_S),
                        ("train", TRAIN_B, TRAIN_S)):
        x, dt, Bs, Cs, A = fused_inputs(torch, gen, B, S, d, N,
                                        torch.bfloat16, dt_rank(cfg))
        plan = ss.plan_fused(x, dt, Bs, Cs, A)
        check(plan.tma, f"K2 fused {label} shape: not the TMA load path")
        with_states = label == "train"
        states = torch.empty(ss.states_shape(B, S, d, N), device="cuda") \
            if with_states else None
        got = ss.ssm_scan_fused_cuda(x, dt, Bs, Cs, A, states=states)
        want = ss.mamba1_scan_plain(x, dt, Bs, Cs, A)
        err = assert_close(got, want, TOL_SCAN, f"K2 fused {label} shape")
        del want
        elems = B * S * d * N
        nbytes = (2 * 2 * B * S * d + 2 * 2 * B * S * N + 4 * d * N
                  + 4 * B * S * d + (states.numel() * 4 if with_states
                                     else 0))
        # per state element and step: dt A, dt x, (dt x) B, h's multiply
        # and add, y's multiply and add
        rec = dict(shape=f"{label} B{B} S{S} d{d} N{N} bf16"
                   + (" with states" if with_states else ""),
                   max_abs_err=err, small_cases_max_abs_err=worst,
                   lanes=plan.lanes, tma=plan.tma,
                   **timings(lambda: ss.ssm_scan_fused_cuda(
                       x, dt, Bs, Cs, A, states=states),
                       lambda: ss.mamba1_scan_plain(x, dt, Bs, Cs, A),
                       None, 20),
                   **bound(nbytes, 7 * elems, PEAK_F32_FLOPS, exps=elems))
        print(f"K2 fused {rec['shape']}: {plan_text(plan)}; err {err} device "
              f"ms {rec['ms']:.5f} plain {rec['plain_ms']:.5f} bound "
              f"{rec['bound_ms']:.5f} ({rec['bound_by']}: {elems} exp, "
              f"{nbytes} B); per call ms {rec['call_ms']:.5f} plain "
              f"{rec['plain_call_ms']:.5f}; no library call computes it")
        if with_states:   # what writing the states costs
            rec["no_states_ms"] = device_time_ms(
                lambda: ss.ssm_scan_fused_cuda(x, dt, Bs, Cs, A), 20)
            print(f"K2 fused {label} shape without states: device ms "
                  f"{rec['no_states_ms']:.5f}")
        records.append(rec)
        del x, dt, Bs, Cs, A, states, got
    return records


def hold_scan_grad(got, want, bf16: bool, what: str) -> float:
    """A K2 backward gradient against the f32 plain one: relative L2 for a
    bf16 gradient, else the largest error over the largest element."""
    import torch
    if bf16 and got.dtype == torch.bfloat16:
        rel = rel_err(got, want) if want.norm() > 0 else max_err(got, want)
        check(rel <= SCAN_BWD_REL_BF16, f"{what}: relative L2 {rel} > "
              f"{SCAN_BWD_REL_BF16}")
        return rel
    check(got.dtype == want.dtype, f"{what}: dtype {got.dtype}")
    scale = want.abs().max().item()
    rel = max_err(got, want) / scale if scale > 0 else max_err(got, want)
    check(rel <= SCAN_BWD_REL_MAX, f"{what}: max abs err over the largest "
          f"element {rel} > {SCAN_BWD_REL_MAX}")
    return rel


def scan_bwd_checks(torch, ss, ops, cfg):
    """K2's backward against autograd of mamba1_scan_plain (f32 copies of
    the inputs) on the fused cases, at every lanes a channel its plan
    takes and on both load paths, two calls bit-equal, bf16 dx and ddt
    equal to the f32 instantiation's rounded once (and that f32 result
    held at the f32 tolerance), autograd through ops.mamba1_scan; then
    falcon-mamba's training shape (bf16, B and C slices of x_proj's output:
    the TMA path) with its time beside its plain version's and the bound,
    split into the main kernel and the reductions."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    names = ("x", "dt", "B", "C", "A")

    def check_case(B, S, d, N, dtype, lead, hold_f32=True):
        x, dt, Bs, Cs, A = fused_inputs(torch, gen, B, S, d, N, dtype, lead)
        dy = torch.randn((B, S, d), generator=gen, device="cuda")
        states = torch.empty(ss.states_shape(B, S, d, N), device="cuda")
        ss.ssm_scan_fused_cuda(x, dt, Bs, Cs, A, states=states)
        leaves = [t.detach().float().requires_grad_()
                  for t in (x, dt, Bs, Cs, A)]
        want = torch.autograd.grad(ss.mamba1_scan_plain(*leaves), leaves, dy)
        got = ss.ssm_scan_bwd_cuda(x, dt, Bs, Cs, A, dy, states)
        plan = ss.ssm_scan_bwd_cuda.last_plan
        again = ss.ssm_scan_bwd_cuda(x, dt, Bs, Cs, A, dy, states)
        torch.cuda.synchronize()
        what = (f"K2 bwd B{B} S{S} d{d} N{N} {dtype} lead {lead} "
                f"L{plan.lanes} tma {plan.tma}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{what}: two calls differ")
        f32_errs = []
        if dtype == torch.bfloat16:
            # dx, ddt: the f32 sums rounded once; the f32 instantiation
            # (the same lanes) held at the f32 tolerance on these values
            # (on the small cases)
            f32 = ss.ssm_scan_bwd_cuda(*(t.float() for t in (x, dt, Bs, Cs)),
                                       A, dy, states)
            check(ss.ssm_scan_bwd_cuda.last_plan.lanes == plan.lanes,
                  f"{what}: the f32 instantiation took other lanes")
            check(all(torch.equal(g, w.to(dtype))
                      for g, w in zip(got[:2], f32[:2])),
                  f"{what}: bf16 dx, ddt differ from the f32 "
                  f"instantiation's rounded once")
            if hold_f32:
                f32_errs = [hold_scan_grad(g, w, False, f"{what} in f32 d{n}")
                            for n, g, w in zip(names, f32, want)]
        errs = [hold_scan_grad(g, w, dtype == torch.bfloat16, f"{what} d{n}")
                for n, g, w in zip(names, got, want)]
        return (plan, errs, f32_errs, [max_err(g, w)
                                       for g, w in zip(got, want)],
                (x, dt, Bs, Cs, A, dy, states))

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    paths = {}
    for case in fused_cases(torch):
        plan, errs, f32_errs, _, _ = check_case(*case)
        worst[case[4]] = max(worst[case[4]], *errs)
        worst[torch.float32] = max(worst[torch.float32], 0.0, *f32_errs)
        key = (plan.lanes, plan.lane_states, plan.tma)
        paths[key] = paths.get(key, 0) + 1
    check({(L, NL) for L, NL, _ in paths}
          == {(L, P // L) for P, L in ss.BWD_LANES.items()}
          and {tma for _, _, tma in paths} == {False, True},
          f"K2 bwd small cases miss an instantiation or a load path: "
          f"{sorted(paths)}")

    # autograd through the dispatcher: one forward and one backward call
    x, dt, Bs, Cs, A = fused_inputs(torch, gen, 2, 50, 40, 16,
                                    torch.float32, 5)
    dy = torch.randn((2, 50, 40), generator=gen, device="cuda")
    leaves = [t.detach().clone().requires_grad_() for t in (x, dt, Bs, Cs, A)]
    f0, b0 = ss.ssm_scan_fused_cuda.launches, ss.ssm_scan_bwd_cuda.launches
    y = ops.mamba1_scan(*leaves)
    check(y.grad_fn is not None, "ops.mamba1_scan output has no grad_fn")
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    check((ss.ssm_scan_fused_cuda.launches - f0,
           ss.ssm_scan_bwd_cuda.launches - b0)
          == (1, ss.BWD_LAUNCHES_PER_CALL),
          "autograd through ops.mamba1_scan did not call each kernel once")
    plain = [t.detach().clone().requires_grad_() for t in (x, dt, Bs, Cs, A)]
    want = torch.autograd.grad(ss.mamba1_scan_plain(*plain), plain, dy)
    for n, g, w in zip(names, grads, want):
        hold_scan_grad(g, w, False, f"K2 bwd through autograd d{n}")
    print(f"K2 bwd: {sum(paths.values())} cases pass over (L, states a lane, "
          f"TMA) {sorted(paths.items())}, two calls bit-equal, bf16 dx and "
          f"ddt the f32 sums rounded once; f32 max err over largest element "
          f"{worst[torch.float32]} (limit {SCAN_BWD_REL_MAX}); bf16 relative "
          f"L2 <= {worst[torch.bfloat16]} (limit {SCAN_BWD_REL_BF16}); "
          f"autograd through ops.mamba1_scan calls each wrapper once")

    # the training shape: falcon-mamba's 8 x 1024, d_inner, N, bf16
    B, S, d, N = TRAIN_B, TRAIN_S, cfg.d_inner, cfg.ssm_state
    plan, errs, _, abs_errs, (x, dt, Bs, Cs, A, dy, states) = check_case(
        B, S, d, N, torch.bfloat16, dt_rank(cfg), hold_f32=False)
    check(plan.tma, "K2 bwd train shape: not the TMA load path")
    elems = B * S * d * N
    nbytes = (2 * 2 * B * S * d + 2 * 2 * B * S * N + 4 * d * N   # inputs
              + 4 * B * S * d + 4 * states.numel()                # dy, states
              + 2 * 2 * B * S * d + 2 * 2 * B * S * N + 4 * d * N)  # grads
    # per state element and step: the recomputed step (5), g (2), its six
    # products and three sums into dA, ddt, dx, dB, dC and the carry
    rec = dict(shape=f"train B{B} S{S} d{d} N{N} bf16",
               kernel="ssm_scan_bwd_kernel + ssm_scan_bwd_reduce_kernel",
               lanes=plan.lanes, tma=plan.tma, passes=plan.passes,
               max_abs_err=max(abs_errs), err_dx_ddt_dB_dC_dA=errs,
               max_abs_err_dx_ddt_dB_dC_dA=abs_errs,
               small_cases_f32_err=worst[torch.float32],
               small_cases_bf16_rel_err=worst[torch.bfloat16],
               **timings(lambda: ss.ssm_scan_bwd_cuda(x, dt, Bs, Cs, A, dy,
                                                      states),
                         lambda: ss.mamba1_scan_bwd_plain(x, dt, Bs, Cs, A,
                                                          dy), None, 20),
               **bound(nbytes, 20 * elems, PEAK_F32_FLOPS, exps=elems))
    split = device_split_ms(lambda: ss.ssm_scan_bwd_cuda(
        x, dt, Bs, Cs, A, dy, states), 10, (*ss.BWD_KERNEL_NAMES, ""))
    rec.update(main_ms=split[ss.BWD_KERNEL_NAMES[0]],
               reduce_ms=split[ss.BWD_KERNEL_NAMES[1]])
    # the rest of the call: dB's and dC's casts to the inputs' dtype
    rec["rest_ms"] = split[""] - rec["main_ms"] - rec["reduce_ms"]
    print(f"K2 bwd {rec['shape']}: {plan_text(plan)}; dx, ddt, dB, dC "
          f"relative L2, dA max err over largest {errs} (max abs err "
          f"{abs_errs}); device ms {rec['ms']:.5f} (in another run of 10 "
          f"calls: main {rec['main_ms']:.5f}, reductions "
          f"{rec['reduce_ms']:.5f}, rest {rec['rest_ms']:.5f}) plain "
          f"{rec['plain_ms']:.5f} bound {rec['bound_ms']:.5f} "
          f"({rec['bound_by']}: {elems} exp, {nbytes} B); per call ms "
          f"{rec['call_ms']:.5f} plain {rec['plain_call_ms']:.5f}; no "
          f"library call computes it")
    return [rec]


def hold_grad(got, want, dtype, what: str) -> float:
    """A kernel gradient against the f32 plain one: f32 within BWD_TOL_F32,
    bf16 within BWD_REL_BF16 relative L2.  Returns the error held."""
    import torch
    if dtype == torch.float32:
        return assert_close(got, want, BWD_TOL_F32, what)
    check(got.dtype == dtype, f"{what}: dtype {got.dtype}")
    norm = want.float().norm().item()
    if norm == 0:
        check(max_err(got, want) == 0, f"{what}: nonzero where none is due")
        return 0.0
    rel = rel_err(got, want)
    check(rel <= BWD_REL_BF16, f"{what}: relative L2 {rel} > {BWD_REL_BF16}")
    return rel


def bwd_checks(torch, fa):
    """K1's forward log-sum-exp and its backward kernels against the plain
    versions (f32 and bf16; D 16, 32, 64, 80, 128, 256; groups 1 to 8;
    causal or not; a window; ragged S; a query offset), two calls
    bit-equal, then the backward at each training path's shape
    (bwd_train_shape): qwen3's record first, then zamba2's, then gemma3's
    at 2 x 4096 with its 1024-key window (its local layers) and without
    (its global ones), then granite's (24 / 8 heads of 64), whisper's
    three (8 x 1500 and 8 x 448 -> 1500 unmasked, 8 x 448 causal) and
    llava's (2 x 3904, 32 / 8 heads of 128)."""
    from repro_torch.configs import get_config
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(SEED + 3)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=cuda,
                           dtype=torch.float32).to(dtype)

    cases = [  # B, H, Hkv, Sq, Skv, D, causal, window, q_offset
        (2, 4, 2, 16, 16, 16, True, None, 0),       # the smoke configs' shape
        (1, 8, 8, 70, 70, 64, True, None, 0),       # group 1, ragged
        (1, 16, 2, 100, 100, 128, True, None, 0),   # group 8
        (1, 4, 2, 20, 100, 64, False, None, 0),     # non-causal, Sq != Skv
        (2, 4, 4, 130, 130, 64, True, 16, 0),       # sliding window
        (1, 4, 2, 200, 200, 128, True, 70, 0),      # window edge in a tile
        (2, 4, 2, 5, 40, 16, True, 8, 30),          # offset and window
        (1, 6, 2, 50, 50, 32, True, None, 0),       # group 3
        (1, 40, 8, 140, 140, 128, True, None, 0),   # group 5 (llama4-scout)
        (1, 48, 8, 160, 160, 128, True, 50, 0),     # group 6 (nemotron-4), window
        (1, 8, 2, 129, 257, 128, False, None, 0),   # ragged position and key blocks
        (2, 16, 8, 129, 257, 128, True, None, 128),  # q_offset > 0 at D 128
        (2, 16, 8, 300, 300, 128, True, None, 0),   # qwen3's heads, ragged
        (1, 32, 32, 300, 300, 80, True, None, 0),   # zamba2's heads, ragged
        (2, 4, 4, 130, 130, 80, True, 16, 0),       # head dim 80, window
        (1, 4, 2, 20, 100, 80, False, None, 0),     # head dim 80, Sq != Skv
        (2, 8, 8, 129, 257, 80, True, None, 128),   # head dim 80, q_offset
        (1, 8, 4, 300, 300, 256, True, None, 0),    # gemma3's heads, ragged
        (1, 8, 4, 200, 200, 256, True, 70, 0),      # head dim 256, window edge in a tile
        (1, 4, 2, 20, 100, 256, False, None, 0),    # head dim 256, Sq != Skv
        (2, 8, 4, 129, 257, 256, True, None, 128),  # head dim 256, q_offset
        (1, 24, 8, 140, 140, 64, True, None, 0),    # granite's heads, group 3
        (1, 16, 16, 100, 1500, 64, False, None, 0),  # whisper's cross-attention
        (1, 32, 8, 140, 140, 128, True, None, 0),   # llava's heads, group 4
    ]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    lse_worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, h, hkv, Sq, Skv, d, causal, window, q_off in cases:
            q, dout = (rand(B, Sq, h, d, dtype=dtype) for _ in range(2))
            k, v = (rand(B, Skv, hkv, d, dtype=dtype) for _ in range(2))
            kw = dict(causal=causal, window=window, q_offset=q_off)
            what = f"K1 bwd {dtype} B{B} H{h}/{hkv} Sq{Sq} Skv{Skv} D{d} {kw}"
            out, lse = fa.flash_attention_cuda(q, k, v, with_lse=True, **kw)
            lse_worst = max(lse_worst, assert_close(
                lse, fa.lse_plain(q, k, v, **kw), LSE_TOL, f"{what} lse"))
            got = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
            again = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{what}: two calls differ")
            want = fa.flash_attention_bwd_plain(q, k, v, dout, **kw)
            for name, g, w in zip("qkv", got, want):
                worst[dtype] = max(worst[dtype],
                                   hold_grad(g, w, dtype, f"{what} d{name}"))
            del got, again, want
    print(f"K1 bwd: {len(cases)} shapes x f32, bf16 pass, two calls "
          f"bit-equal; lse max abs err {lse_worst} (tol {LSE_TOL}); dq, dk, "
          f"dv f32 max abs err {worst[torch.float32]} (tol {BWD_TOL_F32}), "
          f"bf16 relative L2 <= {worst[torch.bfloat16]} (limit "
          f"{BWD_REL_BF16})")

    records = [bwd_train_shape(torch, fa, rand, model, *K1_HEADS[model])
               for model in (QWEN, ZAMBA)]   # the trained models' heads
    records += [bwd_train_shape(torch, fa, rand, GEMMA, *K1_HEADS[GEMMA],
                                B=GEMMA_TRAIN_B, S=GEMMA_TRAIN_S,
                                window=window)
                for window in (get_config(GEMMA).attn_window, None)]
    records.append(bwd_train_shape(torch, fa, rand, GRANITE,
                                   *K1_HEADS[GRANITE]))
    # whisper's training: the encoder (frames to frames), the
    # cross-attention (tokens to frames), both unmasked, and the decoder's
    # self-attention; llava's over its image and text positions
    for S, Skv, causal in ((WHISPER_FRAMES, WHISPER_FRAMES, False),
                           (WHISPER_TOKENS, WHISPER_FRAMES, False),
                           (WHISPER_TOKENS, WHISPER_TOKENS, True)):
        records.append(bwd_train_shape(torch, fa, rand, WHISPER,
                                       *K1_HEADS[WHISPER], S=S, Skv=Skv,
                                       causal=causal))
    records.append(bwd_train_shape(torch, fa, rand, LLAVA, *K1_HEADS[LLAVA],
                                   B=LLAVA_TRAIN_B,
                                   S=LLAVA_PATCHES + LLAVA_TRAIN_TEXT))
    return records + [dict(shape="checks", max_abs_err=worst[torch.float32],
                           bf16_rel_err=worst[torch.bfloat16],
                           lse_max_abs_err=lse_worst)]


def bwd_train_shape(torch, fa, rand, model, H, Hkv, D, B=TRAIN_B, S=TRAIN_S,
                    window=None, Skv=None, causal=True):
    """K1's backward at a training path's shape (B x S queries against Skv
    keys, S unless given, causal or unmasked, with ``window`` or none,
    bf16, ``model``'s heads): held against the plain version and SDPA's
    backward (the window as a boolean mask), two calls bit-equal, then
    timed beside the plain version, SDPA's backward and the bound, whole
    and by part; and K1's forward there."""
    bf16 = torch.bfloat16
    Skv = S if Skv is None else Skv
    kw = dict(window=window, causal=causal)
    label = (f"{model}{'' if window is None else f', window {window}'}"
             f"{'' if causal else f', unmasked, {S} -> {Skv}'}")
    q, dout = (rand(B, S, H, D, dtype=bf16) for _ in range(2))
    k, v = (rand(B, Skv, Hkv, D, dtype=bf16) for _ in range(2))
    out, lse = fa.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    assert_close(lse, fa.lse_plain(q, k, v, **kw), LSE_TOL,
                 f"K1 lse, train shape ({label})")
    got = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K1 bwd, train shape ({label}): two calls differ")
    want = fa.flash_attention_bwd_plain(q, k, v, dout, **kw)
    rels = [hold_grad(g, w, bf16, f"K1 bwd train shape ({label}) d{name}")
            for name, g, w in zip("qkv", got, want)]
    errs = [max_err(g, w) for g, w in zip(got, want)]
    del want, again
    sdpa = sdpa_gqa(torch)
    masks = sdpa_masks(torch, S, Skv, causal, window)
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    lib_out = sdpa(qh, kh, vh, **masks)
    doh = dout.transpose(1, 2)
    lib = torch.autograd.grad(lib_out, (qh, kh, vh), doh, retain_graph=True)
    for name, g, w in zip("qkv", got, lib):
        check(rel_err(g, w.transpose(1, 2)) <= BWD_REL_BF16,
              f"SDPA backward yardstick disagrees ({label}, d{name})")
    backend = library_backend(torch, lambda: torch.autograd.grad(
        lib_out, (qh, kh, vh), doh, retain_graph=True))
    # one product over the pairs the masks leave
    pairs = attended_pairs(S, window) if causal else S * Skv
    product = 2 * B * H * D * pairs
    flops = 5 * product
    nbytes = (2 * (3 * q.numel() + 2 * k.numel())   # q, o, dO, k, v read
              + 4 * lse.numel()                       # lse read
              + 2 * (q.numel() + 2 * k.numel()))      # dq, dk, dv written
    # each kernel's own work: the preprocess reads o and dO and writes
    # Delta; dK/dV computes 4 products and dQ 3 (S and dP twice), each
    # reading q, dO, k, v, lse and Delta and writing its gradients
    inputs = 2 * (2 * q.numel() + 2 * k.numel()) + 2 * 4 * lse.numel()
    split_bounds = dict(
        preprocess=bound(2 * 2 * q.numel() + 4 * lse.numel(),
                         2 * q.numel(), PEAK_BF16_FLOPS),
        dkdv=bound(inputs + 2 * 2 * k.numel(), 4 * product, PEAK_BF16_FLOPS),
        dq=bound(inputs + 2 * q.numel(), 3 * product, PEAK_BF16_FLOPS))
    split = device_split_ms(
        lambda: fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw),
        30, tuple(BWD_PARTS.values()))
    fwd_bound = bound(2 * (q.numel() + 2 * k.numel() + out.numel())
                      + 4 * lse.numel(), 2 * product, PEAK_BF16_FLOPS)
    with torch.no_grad():
        fwd_library_ms = device_time_ms(lambda: sdpa(qh, kh, vh, **masks), 50)
    rec = dict(
        shape=f"train B{B} S{S}{'' if Skv == S else f'->{Skv}'} H{H}/{Hkv} "
              f"D{D} {'causal' if causal else 'unmasked'}"
              f"{'' if window is None else f' window {window}'} bf16",
        model=model,
        kernel=" + ".join(
            ("flash_bwd_preprocess_kernel", "flash_bwd_dkdv_wide_kernel",
             "flash_bwd_dq_wide_kernel") if D == fa.BWD_WIDE
            else ("flash_bwd_preprocess_kernel", "flash_bwd_dkdv_kernel",
                  "flash_bwd_dq_kernel")), max_abs_err=max(errs),
        max_abs_err_dq_dk_dv=errs, rel_err_dq_dk_dv=rels,
        library=f"SDPA backward ({backend})",
        fwd_lse_ms=device_time_ms(
            lambda: fa.flash_attention_cuda(q, k, v, with_lse=True, **kw), 50),
        fwd_ms=device_time_ms(
            lambda: fa.flash_attention_cuda(q, k, v, **kw), 50),
        fwd_bound_ms=fwd_bound["bound_ms"], fwd_bound_by=fwd_bound["bound_by"],
        fwd_library_ms=fwd_library_ms,
        **{f"{part}_ms": split[name] for part, name in BWD_PARTS.items()},
        **{f"{part}_bound_ms": b["bound_ms"]
           for part, b in split_bounds.items()},
        **timings(lambda: fa.flash_attention_bwd_cuda(q, k, v, out, dout,
                                                      lse, **kw),
                  lambda: fa.flash_attention_bwd_plain(q, k, v, dout, **kw),
                  lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                              retain_graph=True), 30),
        **bound(nbytes, flops, PEAK_BF16_FLOPS))
    print(f"K1 bwd {rec['shape']} ({model}): dq, dk, dv relative L2 {rels} "
          f"(limit {BWD_REL_BF16}), max abs err {errs} vs the f32 plain gradient, "
          f"two calls bit-equal; device ms {rec['ms']:.5f} (3 kernels) plain "
          f"{rec['plain_ms']:.5f} {rec['library']} {rec['library_ms']:.5f} "
          f"bound {rec['bound_ms']:.5f} ({rec['bound_by']}, {flops} FLOP, "
          f"{nbytes} B); per call ms {rec['call_ms']:.5f} plain "
          f"{rec['plain_call_ms']:.5f} sdpa {rec['library_call_ms']:.5f}; "
          f"K1 forward with lse {rec['fwd_lse_ms']:.5f} ms, without "
          f"{rec['fwd_ms']:.5f} ms, bound {rec['fwd_bound_ms']:.5f} "
          f"({rec['fwd_bound_by']}), SDPA forward {fwd_library_ms:.5f} ms")
    print(f"K1 bwd split, train shape ({label}): " + "; ".join(
        f"{part} {rec[part + '_ms']:.5f} ms (bound "
        f"{rec[part + '_bound_ms']:.5f}, {split_bounds[part]['bound_by']})"
        for part in BWD_PARTS))
    return rec


def library_backend(torch, fn) -> str:
    """The names of the heaviest kernels that 5 calls of ``fn()`` launch:
    which of PyTorch's attention backends served it."""
    fn()

    def run():
        for _ in range(5):
            fn()
    rows, _ = profiled(torch, run)
    rows.sort(key=lambda e: -e.self_device_time_total)
    return "; ".join(e.key[:80] for e in rows[:3])


# ---------------------------------------------------------------- phase 3 --
def checkpoint_phase(torch, cfg, tmp, keep: bool = False):
    """Save the model's seeded bf16 weights and restore them onto the card
    bit-equal.  ``keep``: the file (with the reference's vendor) stays
    for a later phase, its path in the record's ``path``."""
    from repro_torch.checkpoint import save
    from repro_torch.checkpoint.pytree_io import (DEFAULT_VENDOR,
                                                  REFERENCE_VENDOR)
    from repro_torch.models import init_lm, param_bytes
    from repro_torch.serve import load_weights
    cuda = torch.device("cuda")
    params = init_lm(cfg, SEED, device=cuda, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    nbytes = param_bytes(params)
    path = os.path.join(tmp, f"{cfg.name}-bf16.scda")
    t0 = time.perf_counter()
    save(path, params, step=1000,
         vendor=REFERENCE_VENDOR if keep else DEFAULT_VENDOR)
    t_save = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    weights, step = load_weights(cfg, path, like=params, device=cuda)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    check(step == 1000, f"restored step {step}")
    n = hold_leaves(torch, weights, params, "the restore")
    if not keep:
        os.remove(path)
    print(f"checkpoint {cfg.name}: {n} leaves bit-equal, {nbytes} B of "
          f"weights, file {size} B, save {size / t_save / 1e6:.1f} MB/s "
          f"({t_save:.3f} s), restore {size / t_restore / 1e6:.1f} MB/s "
          f"({t_restore:.3f} s)")
    del params
    return weights, dict(weight_bytes=nbytes, file_bytes=size,
                         save_mb_s=size / t_save / 1e6,
                         restore_mb_s=size / t_restore / 1e6,
                         path=path if keep else None)


def sha256_file(path: str) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            block = fh.read(1 << 24)
            if not block:
                return h.hexdigest()
            h.update(block)


def set_files(path: str):
    """(data shard paths, parity file paths) of the set at ``path``."""
    from repro_torch.checkpoint.sharding import read_sharded_manifest
    doc = read_sharded_manifest(path)
    d = os.path.dirname(path)
    return ([os.path.join(d, s["file"]) for s in doc["shards"]],
            [os.path.join(d, p["file"])
             for p in (doc.get("parity") or {}).get("files", [])])


def ckpt_bytes(path: str) -> int:
    """A checkpoint's bytes on disk: a flat file's, or a set's manifest,
    data shards and parity files together."""
    from repro_torch.checkpoint import manifest, read_manifest
    if read_manifest(path).get("format") != manifest.SHARDED_FORMAT:
        return os.path.getsize(path)
    data, parity = set_files(path)
    return sum(os.path.getsize(p) for p in [path] + data + parity)


def changed_chunks(torch, old, new, chunk: int):
    """The indices of the ``chunk``-byte chunks whose bytes differ between
    two tensors of one shape and dtype, compared on the card."""
    a = old.reshape(-1).view(torch.uint8)
    b = new.reshape(-1).view(torch.uint8)
    full = a.numel() // chunk
    out = (a[:full * chunk].view(full, chunk)
           != b[:full * chunk].view(full, chunk)).any(dim=1)
    idx = out.nonzero().flatten().tolist()
    if a.numel() > full * chunk and not torch.equal(a[full * chunk:],
                                                    b[full * chunk:]):
        idx.append(full)
    return idx


def hold_leaves(torch, got, want, what: str) -> int:
    """Every tensor leaf of ``got`` on the card and bit-equal to
    ``want``'s; returns the number of leaves."""
    from repro_torch.checkpoint.pytree_io import flatten_named
    g, w = flatten_named(got)[0], flatten_named(want)[0]
    check([n for n, _ in g] == [n for n, _ in w], f"{what}: leaf names")
    for (name, a), (_, b) in zip(g, w):
        check(a.device.type == "cuda" and a.dtype == b.dtype
              and a.shape == b.shape, f"{what}: leaf {name} {a.dtype} "
              f"{tuple(a.shape)} on {a.device}")
        check(torch.equal(a.reshape(-1).view(torch.uint8),
                          b.reshape(-1).view(torch.uint8)),
              f"{what}: leaf {name} is not bit-equal")
    return len(w)


class _Spy:
    """Wraps ``owner.name`` while active: records each call's seconds and
    its positional arguments."""

    def __init__(self, owner, name: str):
        self.owner, self.name = owner, name
        self.calls = []

    def __enter__(self):
        real = getattr(self.owner, self.name)

        def spy(*args, **kwargs):
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            self.calls.append((time.perf_counter() - t0, args))
            return out
        self._patch = mock.patch.object(self.owner, self.name, spy)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def weights_set_phase(torch, cfg, weights, tmp):
    """qwen3's weights (on the card, bit-equal to the saved ones) as a set
    of SET_SHARDS shards and SET_PARITY parity files with chunk digests:
    restored onto the card; restored again, through the parity, after the
    data shards SET_LOST are deleted; those rebuilt to their original
    SHA-256; then the attention weights of DELTA_LAYERS changed on the card
    by a seeded update and saved as a delta of the set, whose stored chunks
    must be the 1 MiB chunks that changed, and the chain restored."""
    from repro_torch.checkpoint import layout, redundancy, restore, save
    from repro_torch.checkpoint import sharding
    from repro_torch.checkpoint.pytree_io import (DEFAULT_CHUNK_BYTES,
                                                  flatten_named)
    from repro_torch.models import param_bytes
    cuda = torch.device("cuda")
    nbytes = param_bytes(weights)
    d = os.path.join(tmp, "weights-set")
    os.makedirs(d)
    path = os.path.join(d, f"{cfg.name}.scda")
    rec = dict(shards=SET_SHARDS, parity=SET_PARITY, weight_bytes=nbytes)
    trace_path = os.path.join(d, "set-save-trace.json")

    with _Spy(redundancy, "write_parity_files") as parity_spy:
        t0 = time.perf_counter()
        save(path, weights, step=1000, shards=SET_SHARDS, parity=SET_PARITY,
             record_hashes=True, trace=trace_path)
        t_save = time.perf_counter() - t0
    data, parity = set_files(path)
    data_b = sum(os.path.getsize(p) for p in data)
    parity_b = sum(os.path.getsize(p) for p in parity)
    set_b = data_b + parity_b + os.path.getsize(path)
    t_parity = sum(s for s, _ in parity_spy.calls)
    rec.update(set_bytes=set_b, parity_bytes=parity_b,
               parity_share=parity_b / set_b, save_s=t_save,
               save_mb_s=set_b / t_save / 1e6, parity_s=t_parity,
               parity_mb_s=data_b / t_parity / 1e6)

    def timed_restore(p, like):
        t0 = time.perf_counter()
        got, step = restore(p, like=like, device=cuda)
        torch.cuda.synchronize()
        return got, step, time.perf_counter() - t0

    got, step, t = timed_restore(path, weights)
    check(step == 1000, f"the set restored step {step}")
    n = hold_leaves(torch, got, weights, "the set's restore")
    del got
    rec.update(restore_s=t, restore_mb_s=nbytes / t / 1e6)

    lost = [data[k] for k in SET_LOST]
    digests = {p: sha256_file(p) for p in lost}
    for p in lost:
        os.remove(p)
    health = redundancy.set_health(path)
    check(health[0] == "degraded-recoverable" and sorted(health[1])
          == sorted(map(os.path.basename, lost)), f"set health {health}")
    with _Spy(redundancy, "degraded_reader") as degraded:
        got, step, t = timed_restore(path, weights)
    rebuilt_from = sorted({args[2] for _, args in degraded.calls})
    check(rebuilt_from == sorted(map(os.path.basename, lost)),
          f"the degraded restore reconstructed {rebuilt_from}")
    hold_leaves(torch, got, weights, "the degraded restore")
    del got
    rec.update(degraded_restore_s=t, degraded_restore_mb_s=nbytes / t / 1e6)

    doc = sharding.read_sharded_manifest(path)
    rec["rebuild_s"] = []
    for p in lost:
        t0 = time.perf_counter()
        redundancy.rebuild_shard(path, doc, os.path.basename(p))
        rec["rebuild_s"].append(time.perf_counter() - t0)
        check(sha256_file(p) == digests[p],
              f"rebuilt {os.path.basename(p)} differs from the lost file")
    check(redundancy.set_health(path)[0] == "clean", "the rebuilt set")
    rec["rebuild_mb_s"] = [os.path.getsize(p) / s / 1e6
                           for p, s in zip(lost, rec["rebuild_s"])]

    # a partial retrain: the attention weights of two layers move
    gen = torch.Generator(device=cuda).manual_seed(SEED + 24)
    attn = dict(weights["layers"]["attn"])
    for part in ("wq", "wk", "wv", "wo"):
        t_ = attn[part].clone()
        for layer in DELTA_LAYERS:
            noise = torch.randn(t_[layer].shape, generator=gen, device=cuda)
            t_[layer] = (t_[layer].float() + 0.01 * noise).to(t_.dtype)
        attn[part] = t_
    new = dict(weights, layers=dict(weights["layers"], attn=attn))
    cb = DEFAULT_CHUNK_BYTES
    want = {name: changed_chunks(torch, a, b, cb) for (name, a), (_, b) in
            zip(flatten_named(weights)[0], flatten_named(new)[0])}
    dpath = os.path.join(d, f"{cfg.name}-delta.scda")
    t0 = time.perf_counter()
    ddoc = save(dpath, new, step=1001, shards=SET_SHARDS, parity=SET_PARITY,
                delta_base=(sharding.load_set(path), os.path.basename(path)))
    t_delta = time.perf_counter() - t0
    stored = {leaf["name"]: leaf["present"]
              for sd in ddoc["shard_docs"] for leaf in sd["leaves"]}
    check(stored == want, "the delta's stored chunks are not the changed "
          "ones: " + ", ".join(f"{k} {stored.get(k)} vs {v}"
                               for k, v in want.items()
                               if stored.get(k) != v)[:400])
    sizes = {leaf["name"]: layout.chunk_sizes(leaf["nbytes"], cb)
             for sd in ddoc["shard_docs"] for leaf in sd["leaves"]}
    stored_b = sum(sizes[k][c] for k, cs in stored.items() for c in cs)
    got, step, t = timed_restore(dpath, new)
    check(step == 1001, f"the delta restored step {step}")
    hold_leaves(torch, got, new, "the delta's chained restore")
    del got
    phase(f"{cfg.name}: scdatool over the set and its delta")
    rec["tools"] = tools_phase(torch, path, dpath, new, stored, trace_path,
                               lost[0], digests[lost[0]], nbytes)
    del new, attn
    rec.update(delta_s=t_delta, delta_mb_s=nbytes / t_delta / 1e6,
               delta_chunks=sum(map(len, stored.values())),
               delta_stored_bytes=stored_b, delta_stored_share=stored_b
               / nbytes, delta_set_bytes=ckpt_bytes(dpath),
               chain_restore_s=t, chain_restore_mb_s=nbytes / t / 1e6)
    shutil.rmtree(d)
    print(f"checkpoint set {cfg.name}: {n} leaves, {SET_SHARDS} shards + "
          f"{SET_PARITY} parity, {set_b} B (parity {parity_b} B, share "
          f"{rec['parity_share']:.4f}); save with digests "
          f"{rec['save_mb_s']:.1f} MB/s ({t_save:.3f} s, the parity pass "
          f"{t_parity:.3f} s, {rec['parity_mb_s']:.1f} MB/s of shards); "
          f"restore {rec['restore_mb_s']:.1f} MB/s ({rec['restore_s']:.3f} "
          f"s); without {len(lost)} data shards, degraded restore "
          f"{rec['degraded_restore_mb_s']:.1f} MB/s "
          f"({rec['degraded_restore_s']:.3f} s), bit-equal; rebuilt at "
          f"{[round(x, 1) for x in rec['rebuild_mb_s']]} MB/s "
          f"({[round(x, 3) for x in rec['rebuild_s']]} s), SHA-256 equal")
    print(f"checkpoint delta {cfg.name}: attention of layers {DELTA_LAYERS} "
          f"changed; {rec['delta_chunks']} chunks stored, the changed ones "
          f"({stored_b} B, stored share {rec['delta_stored_share']:.6f}; the "
          f"delta set {rec['delta_set_bytes']} B); save {t_delta:.3f} s "
          f"({rec['delta_mb_s']:.1f} MB/s of weights); chained restore "
          f"{rec['chain_restore_mb_s']:.1f} MB/s ({t:.3f} s), bit-equal")
    return rec


def scdatool(*argv: str):
    """The port's ``scdatool`` in this process: ``(exit code, stdout and
    stderr, seconds, bytes read)``, the bytes counted by a trace collector
    of its own (by the command's ``--timing`` line where it asks for
    one)."""
    import contextlib
    import io
    import re
    from repro_torch.core import trace
    from repro_torch.tools.cli import main
    buf, err = io.StringIO(), io.StringIO()
    tc = trace.TraceCollector()
    t0 = time.perf_counter()
    with trace.scoped(tc), contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(err):
        rc = main(list(argv))
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    counters = tc.metrics.snapshot()["counters"]
    read = counters.get("io.pread.bytes", 0) + counters.get(
        "io.preadv.bytes", 0)
    if "--timing" in argv:
        read = int(re.search(r"(\d+) bytes scanned", out).group(1))
    shown = " ".join(os.path.basename(a) for a in argv)
    print(f"  scdatool {shown}: exit {rc}, {seconds:.3f} s, {read} B read"
          + (f", {len(err.getvalue().splitlines())} lines on stderr"
             if err.getvalue() else ""))
    return rc, out + err.getvalue(), seconds, read


def _delta_steps(torch, run, path, dpath, new, stored) -> int:
    """The tools phase's delta steps: ``verify --chain`` of the delta at
    ``dpath``; the delta squashed, the same state as the delta by ``diff
    --logical`` and different from the set at ``path`` in exactly the
    leaves whose chunks it stored; the squashed file restored onto the
    card bit-equal to ``new``, then deleted.  Returns its size."""
    import re
    from repro_torch.checkpoint import restore
    # 6. the delta's chunks against their digests, base chain included
    out = run("verify", "--chain", "--timing", dpath)
    check("verified (chunk digests match across the chain)" in out,
          f"verify --chain: {out[-400:]}")

    # 7. the delta squashed: the same state as the delta, and it differs
    # from the set in exactly the leaves whose chunks the delta stored
    sq = os.path.join(os.path.dirname(path), "squashed.scda")
    run("squash", dpath, sq)
    out = run("diff", "--logical", dpath, sq)
    check("encode the same checkpoint state" in out, f"diff: {out[-400:]}")
    out = run("diff", "--logical", path, sq, want=1)
    named = {}
    for l in out.splitlines():
        m = re.match(r"leaf (\S+): (\d+)/\d+ chunks differ", l)
        if m:
            named[m.group(1)] = int(m.group(2))
        else:
            check(l.startswith("step: 1000 != 1001")
                  or "differ logically" in l, f"diff names {l!r}")
    want = {k: len(cs) for k, cs in stored.items() if cs}
    check(named == want, f"diff --logical named {named}, the delta "
          f"stored {want}")
    got, step = restore(sq, like=new, device=torch.device("cuda"))
    check(step == 1001, f"the squashed file restored step {step}")
    hold_leaves(torch, got, new, "the squashed file's restore")
    del got
    sq_bytes = os.path.getsize(sq)
    os.remove(sq)
    return sq_bytes


def io_by_stage(events, stages):
    """The io records of a Chrome trace, by the ``ckpt`` span of
    ``stages`` whose interval holds their start (``"outside"`` when none
    does): ``{stage: {op: (ms, bytes)}}``."""
    spans = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
             for e in events if e.get("ph") == "X" and e["cat"] == "ckpt"
             and e["name"] in stages]
    out = {}
    for e in events:
        if e.get("ph") != "X" or e["cat"] != "io":
            continue
        stage = next((n for t0, t1, n in spans if t0 <= e["ts"] <= t1),
                     "outside")
        ms, b = out.setdefault(stage, {}).get(e["name"], (0.0, 0))
        out[stage][e["name"]] = (ms + e.get("dur", 0.0) / 1e3,
                                 b + int((e.get("args") or {}).get(
                                     "bytes", 0)))
    return out


def tools_phase(torch, path, dpath, new, stored, trace_path, lost,
                lost_sha256, nbytes):
    """The port's ``scdatool`` (``repro_torch.tools``) over the set at
    ``path`` and its delta at ``dpath``, files at their full size: the
    traced save's split; ``fsck`` in its own process, beside ``verify
    --chain`` of the delta and the delta squashed, compared with ``diff
    --logical`` and restored onto the card bit-equal to ``new``; ``ls
    --json``; ``index --checksums`` and ``verify``; the data shard
    ``lost`` deleted, named by ``verify`` and rebuilt by ``repair
    --rebuild`` to its SHA-256; ``stats`` of the set.  Any command that
    fails fails the run."""
    import re
    from repro_torch.core import ScdaIndex, trace
    t_phase = time.perf_counter()
    name = os.path.basename(path)
    rec = {"commands": []}

    def run(*argv, want=0):
        rc, out, seconds, read = scdatool(*argv)
        check(rc == want, f"scdatool {' '.join(argv)} exited {rc}, not "
              f"{want}: {out[-400:]}")
        rec["commands"].append(dict(argv=[os.path.basename(a)
                                          for a in argv],
                                    seconds=seconds, bytes_read=read))
        return out

    # 1. the set's traced save, split by stage
    out = run("stats", "--trace", trace_path)
    print("  the set's save, traced:")
    for line in out.splitlines()[1:]:
        print(f"    {line}")
    summary = trace.summarize_chrome(trace.load_chrome(trace_path))
    rec["save_trace"] = dict(wall_us=summary["wall_us"],
                             io_calls=summary["io_calls"],
                             io_bytes=summary["io_bytes"],
                             stages=summary["stages"])
    check(summary["stages"].get("ckpt.write_archive", {}).get("calls")
          == SET_SHARDS, "the traced save shows no write_archive span a "
          "shard")
    rec["save_trace"]["io_by_stage"] = io_by_stage(
        trace.load_chrome(trace_path), ("write_archive", "parity_encode"))
    outside_ms = summary["wall_us"] / 1e3
    for stage in ("write_archive", "parity_encode", "outside"):
        ops = rec["save_trace"]["io_by_stage"].get(stage, {})
        if stage == "outside":
            head = (f"outside those spans: {outside_ms:.1f} ms of the "
                    f"save's {summary['wall_us'] / 1e3:.1f} ms (the chunk "
                    f"digests, the plan, the manifest)")
        else:
            span_ms = summary["stages"][f"ckpt.{stage}"]["total_us"] / 1e3
            outside_ms -= span_ms
            head = f"{stage}: {span_ms:.1f} ms"
        print(f"    {head}; its io: " + ", ".join(
            f"{op} {ms:.1f} ms ({b} B)" for op, (ms, b) in sorted(
                ops.items())))

    # 2. fsck as a user runs it, in its own process, beside steps 6 and
    # 7, which only read the set (most of its time is the interpreter's
    # start and torch's import)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.tools.cli", "fsck", "--timing",
         path], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    fsck = {}

    def wait_for_fsck():
        fsck["out"], fsck["err"] = proc.communicate()
        fsck["seconds"] = time.perf_counter() - t0
    waiter = threading.Thread(target=wait_for_fsck, daemon=True)
    waiter.start()
    try:
        sq_bytes = _delta_steps(torch, run, path, dpath, new, stored)
        waiter.join(timeout=300)
    finally:
        if proc.poll() is None:   # a failed step: stop the subprocess
            proc.kill()
            proc.wait()
    out = fsck.get("out", "")
    check(proc.returncode == 0 and "clean" in out and "CORRUPT" not in out,
          f"python -m repro_torch.tools.cli fsck exited {proc.returncode}: "
          f"{out[-400:]} {fsck.get('err', '')[-400:]}")
    read = int(re.search(r"(\d+) bytes scanned", out).group(1))
    work = float(re.search(r"fsck timing: ([0-9.]+) ms wall",
                           out).group(1)) / 1e3
    print(f"  python -m repro_torch.tools.cli fsck --timing {name}: exit 0, "
          f"{fsck['seconds']:.3f} s in its own process (its check "
          f"{work:.3f} s), {read} B read")
    rec["commands"].append(dict(argv=["fsck", "--timing", name],
                                seconds=fsck["seconds"], check_s=work,
                                bytes_read=read, subprocess=True))

    # 3. the set's table
    doc = json.loads(run("ls", "--json", path))["checkpoint"]
    check(doc.get("step") == 1000 and len(doc["shards"]) == SET_SHARDS
          and all(s.get("present") for s in doc["shards"]),
          f"ls --json: step {doc.get('step')}, shards {doc.get('shards')}")

    # 4. checksums recorded, then verified, for the manifest and every
    # data shard (what a manifest expands to)
    files = [path] + set_files(path)[0]
    run("index", "--checksums", path)
    out = run("verify", "--timing", path)
    verified = [l for l in out.splitlines() if "verified (" in l]
    check(len(verified) == len(files), f"verify: {len(verified)} of "
          f"{len(files)} files verified: {out[-400:]}")

    # 5. a lost data shard: named, rebuilt byte for byte, clean again
    os.remove(lost)
    out = run("verify", path, want=1)
    line = (f"{path}: set health: degraded-recoverable — lost "
            f"{os.path.basename(lost)}")
    check(line in out.splitlines(), f"verify of the degraded set: "
          f"{out[:400]}")
    run("repair", "--rebuild", path)
    check(sha256_file(lost) == lost_sha256,
          f"the rebuilt {os.path.basename(lost)} differs from the lost file")
    out = run("fsck", path)
    check("CORRUPT" not in out and "clean" in out, f"fsck: {out[-400:]}")

    # 8. stored and logical bytes of every file of the set
    docs = json.loads(run("stats", "--json", path))["files"]
    check(len(docs) == len(files), f"stats covers {len(docs)} files")
    leaf_logical = 0
    for fdoc in docs:
        payload = sum(e.payload_bytes for e in ScdaIndex.build(fdoc["file"]))
        check(fdoc["stored_bytes"] == fdoc["logical_bytes"] == payload,
              f"stats {fdoc['file']}: {fdoc['stored_bytes']} stored, "
              f"{fdoc['logical_bytes']} logical, {payload} payload")
        for row in fdoc["sections"]:
            check(not row["stored"] or f"{row['ratio']:.2f}" == "1.00",
                  f"stats {fdoc['file']} section {row['sec']}: ratio "
                  f"{row['ratio']}")
            if row["user"].startswith("leaf "):
                leaf_logical += row["logical"]
    check(leaf_logical == nbytes, f"the leaf sections hold {leaf_logical} "
          f"B of the {nbytes} B of weights")
    rec.update(phase_s=time.perf_counter() - t_phase,
               squashed_bytes=sq_bytes)
    print(f"scdatool phase: {len(rec['commands'])} commands in "
          f"{rec['phase_s']:.3f} s (budget {TOOLS_BUDGET_S:.0f} s), "
          f"{sum(c['bytes_read'] for c in rec['commands'])} B read; the "
          f"squashed file {sq_bytes} B")
    return rec


def hold_local_shards(torch, got, host, what: str) -> int:
    """Every leaf of ``got`` a DTensor whose local tensor is on this
    rank's card and bit-equal to the same slice of ``host`` (the whole
    values, on the host); returns the number of leaves."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.checkpoint.pytree_io import flatten_named
    named = flatten_named(got)[0]
    check(sorted(n for n, _ in named) == sorted(host), f"{what}: leaves")
    for name, t in named:
        check(isinstance(t, DTensor), f"{what}: {name} is no DTensor")
        local = t.to_local()
        check(local.device.type == "cuda", f"{what}: {name} on "
              f"{local.device}")
        lshape, off = compute_local_shape_and_global_offset(
            t.shape, t.device_mesh, t.placements)
        want = host[name][tuple(slice(o, o + n)
                                for o, n in zip(off, lshape))]
        want = want.to(local.device).reshape(-1).view(torch.uint8)
        check(torch.equal(local.reshape(-1).view(torch.uint8), want),
              f"{what}: {name}'s local shard is not bit-equal")
    return len(named)


def dist_rank(cfg, f0: str, d: str, saved, verdicts, mesh_ref):
    """One of DIST_RANKS spawned gloo ranks (on the card, ``spawn_ranks``):
    restore F0 onto each mesh's ``params_shardings``, hold every local
    shard against a host restore of F0, save with ``TorchDistComm``
    (rank 0 hands each file to the main process, which hashes and
    deletes it, and waits for its verdict before the next save), and
    restore onto DIST_EXTRA's targets, held the same way.  On MESH_TP's
    restored weights it runs the mesh part (a), on MESH_SP's replicated
    restore (b), and at the end (c) (``mesh_ref``: the tokens they
    replay).  Returns
    the timings, the bytes this rank owned in each save (what it wrote),
    the placement shares and the mesh parts' records."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint import restore, save
    from repro_torch.checkpoint.pytree_io import (REFERENCE_VENDOR,
                                                  _local_block,
                                                  flatten_named)
    from repro_torch.core.comm import TorchDistComm
    from repro_torch.distributed import sharding
    from repro_torch.models import init_lm
    clock = {"enter": time.time()}
    comm = TorchDistComm()
    rank = comm.rank
    abstract = init_lm(cfg, SEED, device="meta", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    host = dict(flatten_named(restore(f0)[0])[0])
    t_host = time.perf_counter() - t0
    clock["host"] = time.time()
    meshes = {s: init_device_mesh("cuda", s, mesh_dim_names=DIST_AXES)
              for s in DIST_MESHES}
    clock["meshes"] = time.time()
    rec = {"rank": rank, "device": f"cuda:{torch.cuda.current_device()}",
           "host_restore_s": t_host, "meshes": {}, "extra": {},
           "clock": clock}

    def timed(fn):
        comm.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        comm.barrier()
        return out, time.perf_counter() - t0

    def shares(targets):
        """The leaves' shares sharded on every mesh dim of size > 1, on
        some of them, and on none (replicated on every rank)."""
        counts = [0, 0, 0]
        leaves = [t for _, t in flatten_named(targets)[0]]
        for t in leaves:
            dims = [p.is_shard() for p, n in zip(t.placements,
                                                 t.device_mesh.shape)
                    if n > 1]
            counts[0 if all(dims) else 2 if not any(dims) else 1] += 1
        return [c / len(leaves) for c in counts]

    abstract_named, rebuild_abstract = flatten_named(abstract)

    def extra(case, shape, pf):
        mesh = meshes[shape]
        if case == "replicated":
            specs = {n: sharding.P() for n, _ in abstract_named}
        else:
            specs = {n: (sharding.P(DIST_AXES, None) if leaf.ndim == 2
                         else sharding.leaf_spec(mesh, n, leaf))
                     for n, leaf in abstract_named}
        targets = {n: sharding.target(mesh, specs[n], leaf)
                   for n, leaf in abstract_named}
        (got, step), t = timed(lambda: restore(f0, like=targets,
                                               prefetch_bytes=pf))
        check(step == 1000, f"{case}: restored step {step}")
        for name, spec in specs.items():
            check(list(got[name].placements)
                  == sharding.placements(mesh, spec),
                  f"{case}: {name}'s placements")
        t0 = time.perf_counter()
        hold_local_shards(torch, got, host, f"{case} on {shape}, "
                          f"prefetch_bytes={pf}")
        rec["extra"][(case, pf)] = dict(restore_s=t,
                                        hold_s=time.perf_counter() - t0,
                                        shares=shares(targets))
        if case == "replicated" and pf is None and shape == MESH_SP:
            # SP decode serves from weights whole on every rank: this
            # restore's
            weights = rebuild_abstract([got[n] for n, _ in abstract_named])
            with torch.no_grad():
                rec["mesh_sp"] = mesh_sp_part(torch, cfg, mesh, weights,
                                              mesh_ref["sp"])
            del weights, got
            gc.collect()
            torch.cuda.empty_cache()

    waiting = False
    for i, shape in enumerate(DIST_MESHES):
        mesh = meshes[shape]
        targets = sharding.params_shardings(mesh, abstract)
        (got, step), t_restore = timed(lambda: restore(f0, like=targets))
        check(step == 1000, f"mesh {shape}: restored step {step}")
        t0 = time.perf_counter()
        n = hold_local_shards(torch, got, host, f"mesh {shape}")
        t_hold = time.perf_counter() - t0
        if rank == 0 and waiting:   # the previous file is hashed and gone
            check(verdicts.get() is True, "a mesh's file is not F0")
        path = os.path.join(d, "m{}x{}.scda".format(*shape))
        _, t_save = timed(lambda: save(path, got, comm=comm, step=1000,
                                       vendor=REFERENCE_VENDOR))
        if rank == 0:
            saved.put(path)
            waiting = True
        written = 0
        for _, leaf in flatten_named(got)[0]:
            lshape, _, owned = _local_block(leaf)
            written += math.prod(lshape) * leaf.dtype.itemsize * owned
        rec["meshes"][shape] = dict(leaves=n, restore_s=t_restore,
                                    hold_s=t_hold, save_s=t_save,
                                    written=written,
                                    shares=shares(targets))
        with torch.no_grad():
            if shape == MESH_TP:
                rec["mesh_tp"] = mesh_tp_part(torch, cfg, mesh, got,
                                              mesh_ref["tp"])
        del got
        gc.collect()
        torch.cuda.empty_cache()   # the ranks share the card
        for run in DIST_EXTRA[DIST_EXTRA_SPLIT[i]:DIST_EXTRA_SPLIT[i + 1]]:
            extra(*run)
    if rank == 0 and waiting:
        check(verdicts.get() is True, "the last mesh's file is not F0")
    clock["mesh_train"] = time.time()
    rec["mesh_train"] = mesh_train_part(torch, cfg, d, meshes[MESH_TP],
                                        meshes[MESH_SP])
    from repro_torch.distributed import collectives
    rec["routed"] = collectives.routed_counts()
    dist.barrier()
    clock["exit"] = time.time()
    return rec


# ------------------------------------------------------------ mesh parts --
def mesh_prompt(torch, cfg):
    """(a)'s seeded prompts, 4 x MESH_PROMPT tokens on the card (the same
    in the parent and in every rank)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 27)
    return torch.randint(0, cfg.vocab, (PREFILL_B, MESH_PROMPT),
                         generator=gen, device="cuda", dtype=torch.int32)


def seeded_kv(torch, cfg, B, S, filled, seed):
    """A decode cache's (k, v), (L, B, S, Hkv, D) bf16 on the card: seeded
    normal values at positions [0, filled), zeros after."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim_)
    dtype = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    out = []
    for _ in range(2):
        t = torch.zeros(shape, dtype=dtype, device="cuda")
        for i in range(cfg.n_layers):   # a layer at a time: a small draw
            t[i, :, :filled] = torch.randn(
                (B, filled) + shape[3:], generator=gen,
                device="cuda").to(torch.bfloat16).to(dtype)
        out.append(t)
    return out


def decode_reference(torch, cfg, weights, B, S, filled, first, seed,
                     steps=MESH_DECODE, fed=None):
    """The single-device decode the mesh parts replay: a cache of S
    positions holding ``seeded_kv`` up to ``filled``, ``steps`` greedy
    steps from ``first`` (B, 1), or with ``fed`` (B, steps) those tokens.
    Returns the tokens fed (B, steps) and each step's logits, on the
    host, and the steps' times."""
    from repro_torch.models.lm import init_cache, serve_step
    cache = init_cache(cfg, B, S, device="cuda")
    k, v = seeded_kv(torch, cfg, B, S, filled, seed)
    cache["k"].copy_(k)
    cache["v"].copy_(v)
    del k, v
    cache["pos"].fill_(filled)
    tok = first if fed is None else fed[:, :1].to("cuda")
    given, logits, times = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = serve_step(cfg, weights, cache, tok)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        given.append(tok)
        logits.append(out.float().cpu())
        tok = (torch.argmax(out, dim=-1, keepdim=True).to(torch.int32)
               if fed is None else fed[:, len(given):len(given) + 1]
               .to("cuda"))
    return dict(fed=torch.cat(given, 1).cpu(), logits=logits, step_s=times)


def mesh_references(torch, cfg, weights):
    """What the mesh parts are held against, on one device in this
    process: (a)'s prefill logits and its decode, (b)'s decode, and (c)'s
    training losses (MESH_TRAIN_LAYERS layers, f32 master weights)."""
    from repro_torch.models.lm import cast_params
    from repro_torch.train.step import make_prefill_step
    t0 = time.perf_counter()
    prompt = mesh_prompt(torch, cfg)
    pre = make_prefill_step(cfg)(weights, {"tokens": prompt}).float()
    tp = decode_reference(
        torch, cfg, weights, PREFILL_B, MESH_PROMPT + MESH_DECODE,
        MESH_PROMPT, torch.argmax(pre, -1, keepdim=True).to(torch.int32),
        SEED + 28)
    tp["prefill"] = pre.cpu()
    sp = decode_reference(torch, cfg, weights, 1, SP_CACHE, SP_START,
                          prompt[:1, :1], SEED + 29)
    # the same steps in f32 (weights, cache and compute), the same tokens
    # fed: the mesh's arithmetic apart from bf16's rounding paths
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    w32 = cast_params(weights, torch.float32)
    tp["f32"] = decode_reference(
        torch, cfg32, w32, PREFILL_B, MESH_PROMPT + MESH_DECODE,
        MESH_PROMPT, None, SEED + 28, fed=tp["fed"])
    sp["f32"] = decode_reference(torch, cfg32, w32, 1, SP_CACHE, SP_START,
                                 None, SEED + 29, fed=sp["fed"])
    del w32
    # two rounding paths on one device: the first step with K1's decode
    # kernel and with the plain attention, on the same cache
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    with mock.patch.object(ops, "flash_attention", _plain_attention(fa_mod)):
        for part, B, S, filled, seed in (
                (tp, PREFILL_B, MESH_PROMPT + MESH_DECODE, MESH_PROMPT,
                 SEED + 28), (sp, 1, SP_CACHE, SP_START, SEED + 29)):
            part["plain"] = decode_reference(torch, cfg, weights, B, S,
                                             filled, None, seed, steps=1,
                                             fed=part["fed"])["logits"][0]
    ref = dict(tp=tp, sp=sp, train=mesh_train_reference(torch, cfg))
    gc.collect()
    torch.cuda.empty_cache()   # the f32 weights and caches: the ranks need the room
    ref["s"] = time.perf_counter() - t0
    return ref


def mesh_train_config(cfg):
    return dataclasses.replace(cfg, n_layers=MESH_TRAIN_LAYERS)


def mesh_train_data(cfg):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    return SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=MESH_TRAIN_S,
                                      global_batch=MESH_TRAIN_B, seed=SEED))


def snapshot(tree):
    """Every leaf of ``tree`` (DTensors or tensors) copied, by name."""
    from repro_torch.checkpoint.pytree_io import flatten_named
    return {n: t.detach().clone() for n, t in flatten_named(tree)[0]}


def update_norms(torch, new, old):
    """Each leaf's change from ``old`` (a :func:`snapshot`) to ``new``, as
    its norm, summed in f64 on one device."""
    from repro_torch.checkpoint.pytree_io import flatten_named
    return {n: float(torch.linalg.vector_norm(t.detach().double()
                                              - old[n].double()))
            for n, t in flatten_named(new)[0]}


def mesh_train_reference(torch, cfg):
    """(c)'s MESH_TRAIN_STEPS steps on one device: their losses, global
    gradient norms, each leaf's update norms and times, and the loss of
    step 1's batch on the weights before any update (what the loss hold
    would see if step 0's update were lost)."""
    from repro_torch.checkpoint.pytree_io import flatten_named
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import init_state
    from repro_torch.train.step import make_eval_step, make_train_step
    cfg = mesh_train_config(cfg)
    data = mesh_train_data(cfg)
    loss_chunk = min(256, MESH_TRAIN_S)
    with torch.inference_mode(False):
        state = init_state(cfg, SEED, "cuda")
        step_fn = make_train_step(cfg, AdamWConfig(**MESH_TRAIN_OPT),
                                  loss_chunk=loss_chunk)
        first = snapshot(state["params"])
        losses, gnorms, updates, times = [], [], [], []
        for step in range(MESH_TRAIN_STEPS):
            old = snapshot(state["params"]) if step else first
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, m = step_fn(state["params"], state["opt"],
                              data.sharded_batch(step, "cuda"))
            state = {"params": p, "opt": o}
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
            gnorms.append(float(m["grad_norm"]))
            updates.append(update_norms(torch, p, old))
            del old
        named, rebuild = flatten_named(state["params"])
        del state, p, o
        before = float(make_eval_step(cfg, loss_chunk)(
            rebuild([first[n] for n, _ in named]),
            data.sharded_batch(1, "cuda")))
        del first
    return dict(losses=losses, grad_norms=gnorms, update_norms=updates,
                step_s=times, step1_loss_before_update=before)


def rank_update_norms(torch, new, old):
    """:func:`update_norms` of DTensor trees, every rank's: the squares of
    each leaf's change in its owned blocks summed in f64, all-reduced."""
    import torch.distributed as dist
    from repro_torch.checkpoint.pytree_io import _local_block, flatten_named
    names, squares = [], []
    for name, t in flatten_named(new)[0]:
        names.append(name)
        change = (t.to_local().detach().double()
                  - old[name].to_local().double())
        squares.append(change.square().sum() if _local_block(t)[2]
                       else change.new_zeros(()))
    total = torch.stack(squares).cpu()
    dist.all_reduce(total)
    return {n: math.sqrt(v) for n, v in zip(names, total.tolist())}


def rank_checksums(torch, tree):
    """:func:`checksums` of a DTensor tree, every rank's: each leaf's
    owned blocks summed as integers (exact in any order), all-reduced."""
    import torch.distributed as dist
    from repro_torch.checkpoint.pytree_io import _local_block, flatten_named
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    names, sums = [], []
    for name, t in flatten_named(tree)[0]:
        names.append(name)
        local = t.to_local().detach()
        owned = _local_block(t)[2]
        sums.append(local.view(ints[t.element_size()]).to(torch.int64).sum()
                    if owned else torch.zeros((), dtype=torch.int64,
                                              device=local.device))
    total = torch.stack(sums).cpu()
    dist.all_reduce(total)
    return dict(zip(names, total.tolist()))


def _traffic_delta(before, after):
    return {k: [after[k][0] - before.get(k, [0, 0])[0],
                after[k][1] - before.get(k, [0, 0])[1]] for k in after}


def mesh_decode_part(torch, cfg, mesh, weights, ref, B, S, filled, seed,
                     sp_axis=None, steps=MESH_DECODE):
    """``ref``'s decode replayed on ``mesh``: a cache of DTensors with
    ``input_shardings``' placements (sequence-sharded for B = 1), the same
    seeded contents, the same tokens fed.  Returns the steps' logits (on
    rank 0), times, K1 launches (and those of the decode kernel with its
    log-sum-exp) and collective traffic a step."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models.lm import init_cache, serve_step
    sh.set_mesh(mesh, sp_decode_axis=sp_axis)
    cache = init_cache(cfg, B, S, device="cuda", mesh=mesh)
    full = seeded_kv(torch, cfg, B, S, filled, seed)
    for key, t in zip(("k", "v"), full):
        whole = sh.distribute(t, mesh, sh.P())
        cache[key].to_local().copy_(
            whole.redistribute(mesh, cache[key].placements).to_local())
    del full, whole
    cache["pos"].fill_(filled)
    fed = ref["fed"].to("cuda")
    k1 = flash_attention_cuda
    k1.launches = k1.decode_lse_launches = 0
    logits, times, traffic = [], [], []
    for i in range(steps):
        before = collectives.traffic()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = serve_step(cfg, weights, cache, fed[:, i:i + 1])
        out = out.full_tensor()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        traffic.append(_traffic_delta(before, collectives.traffic()))
        logits.append(out.float().cpu())
    local = cache["k"].to_local()
    rec = dict(step_s=times, launches=k1.launches,
               lse_launches=k1.decode_lse_launches, traffic=traffic,
               cache_block=list(local.shape),
               cache_placements=[str(p) for p in cache["k"].placements],
               routed=collectives.routed_counts())
    if mesh.get_rank() == 0:
        rec["logits"] = logits
    sh.set_mesh(None)
    return rec


def serving_weights(torch, sh, weights):
    """The restored weights as serving keeps them: gathered over the data
    axes once (FSDP without resharding after each forward), their model
    shards kept, so a step's collectives are tensor parallelism's alone.
    Returns them and the gather's seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sh.gather_data_axes(weights)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mesh_decode_both(torch, cfg, mesh, weights, ref, B, S, filled, seed,
                     sp_axis=None):
    """``mesh_decode_part`` in bf16, then again in f32 (the weights cast
    on each rank, the same tokens fed; ``ref["f32"]`` its reference)."""
    from repro_torch.models.lm import cast_params
    rec = mesh_decode_part(torch, cfg, mesh, weights, ref, B, S, filled,
                           seed, sp_axis=sp_axis)
    w32 = cast_params(weights, torch.float32)
    rec["f32"] = mesh_decode_part(
        torch, dataclasses.replace(cfg, dtype="float32"), mesh, w32,
        ref["f32"], B, S, filled, seed, sp_axis=sp_axis)
    del w32
    gc.collect()
    torch.cuda.empty_cache()   # four ranks share the card: hand it back
    return rec


def mesh_tp_part(torch, cfg, mesh, weights, ref):
    """(a): a 4 x MESH_PROMPT prefill and MESH_DECODE decode steps of
    qwen3-1.7b at full width on MESH_TP (FSDP over data, TP over model),
    on the weights restored onto ``params_shardings``, gathered over data
    once (``serving_weights``)."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.train.step import make_prefill_step
    t_part = time.perf_counter()
    sh.set_mesh(mesh)
    weights, unshard_s = serving_weights(torch, sh, weights)
    prompt = mesh_prompt(torch, cfg)
    batch = {"tokens": sh.distribute(prompt, mesh, sh.batch_spec(mesh, 2))}
    k1 = flash_attention_cuda
    k1.launches = 0
    before = collectives.traffic()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre = make_prefill_step(cfg)(weights, batch).full_tensor()
    torch.cuda.synchronize()
    rec = dict(prefill_s=time.perf_counter() - t0, unshard_s=unshard_s,
               prefill_launches=k1.launches,
               prefill_traffic=_traffic_delta(before, collectives.traffic()))
    if mesh.get_rank() == 0:
        rec["prefill"] = pre.float().cpu()
    rec["decode"] = mesh_decode_both(
        torch, cfg, mesh, weights, ref, PREFILL_B,
        MESH_PROMPT + MESH_DECODE, MESH_PROMPT, SEED + 28)
    del weights, pre, batch
    gc.collect()
    torch.cuda.empty_cache()
    rec["s"] = time.perf_counter() - t_part
    if mesh.get_rank() == 0:
        print(f"  [rank 0] (a) unshard {unshard_s:.3f} s, prefill "
              f"{rec['prefill_s']:.3f} s, decode steps s "
              f"{[round(x, 4) for x in rec['decode']['step_s']]}, f32 "
              f"{[round(x, 4) for x in rec['decode']['f32']['step_s']]}, "
              f"part {rec['s']:.3f} s", flush=True)
    return rec


def mesh_sp_part(torch, cfg, mesh, weights, ref):
    """(b): MESH_DECODE sequence-parallel decode steps of one request from
    position SP_START of an SP_CACHE cache sharded on the data axis, on
    weights whole on every rank (the replicated restore)."""
    from repro_torch.distributed import sharding as sh
    t0 = time.perf_counter()
    rec = mesh_decode_both(torch, cfg, mesh, weights, ref, 1, SP_CACHE,
                           SP_START, SEED + 29, sp_axis="data")
    sh.set_mesh(None)
    rec["s"] = time.perf_counter() - t0
    if mesh.get_rank() == 0:
        print(f"  [rank 0] (b) decode steps s "
              f"{[round(x, 4) for x in rec['step_s']]}, f32 "
              f"{[round(x, 4) for x in rec['f32']['step_s']]}, part "
              f"{rec['s']:.3f} s", flush=True)
    return rec


def mesh_train_part(torch, cfg, d, tp_mesh, sp_mesh):
    """(c): ``train`` on MESH_TP for its first step, which its closing save
    writes through the ranked manager; then ``train`` on MESH_SP resumes
    from the file (the restored state's checksums against the state
    saved) and runs the second of MESH_TRAIN_STEPS, dying after it as a
    killed job (no save).  Each step's loss, global gradient norm and
    leaves' update norms (from a snapshot of the weights it started
    from) are returned."""
    from repro_torch.checkpoint import manager as mgr_mod
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as sh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainLoopConfig, train
    t_part = time.perf_counter()
    cfg = mesh_train_config(cfg)
    ckpt_dir = os.path.join(d, "mesh-train")
    opt = AdamWConfig(**MESH_TRAIN_OPT)
    losses, times, sums, traffic = {}, {}, {}, {}
    gnorms, updates, last, start = {}, {}, {}, {}

    def on_step(step, state, metrics):
        losses[step] = float(metrics["loss"])
        torch.cuda.synchronize()
        times[step] = time.perf_counter() - last["t"]
        traffic[step] = _traffic_delta(last["traffic"],
                                       collectives.traffic())
        gnorms[step] = float(metrics["grad_norm"])
        updates[step] = rank_update_norms(torch, state["params"],
                                          start.pop("params"))
        if step == 0:
            sums["saved"] = rank_checksums(torch, state)
        last.update(t=time.perf_counter(), traffic=collectives.traffic())

    def run(mesh, total_steps, die_at):
        loop = TrainLoopConfig(total_steps=total_steps, ckpt_every=0,
                               ckpt_dir=ckpt_dir, ckpt_keep=1,
                               log_every=1000, seed=SEED)
        last.update(t=time.perf_counter(), traffic=collectives.traffic())
        t0 = time.perf_counter()
        try:
            train(cfg, loop, opt, data=mesh_train_data(cfg),
                  hooks={"on_step": on_step,
                         "should_die": lambda s: s == die_at},
                  device="cuda", mesh=mesh)
        except SystemExit:
            pass
        return time.perf_counter() - t0

    real_restore = mgr_mod.CheckpointManager.restore_or_init
    timing = {}

    def restore_or_init(self, init_fn, like=None, *, device=None):
        # the state a run starts from: its weights' snapshot, and on run
        # 2's resume onto MESH_SP's layout its checksums
        t0 = time.perf_counter()
        tree, step = real_restore(self, init_fn, like, device=device)
        torch.cuda.synchronize()
        if step >= 0:
            timing["restore_s"] = time.perf_counter() - t0
            check(step == 0, f"(c) resumed from step {step}")
            sums["restored"] = rank_checksums(torch, tree)
        start["params"] = snapshot(tree["params"])
        return tree, step

    with mock.patch.object(mgr_mod.CheckpointManager, "restore_or_init",
                           restore_or_init):
        run1_s = run(tp_mesh, 1, None)   # step 0, then its closing save
        path = os.path.join(ckpt_dir, f"step_{0:010d}.scda")
        file_bytes = os.path.getsize(path)
        run2_s = run(sp_mesh, MESH_TRAIN_STEPS, MESH_TRAIN_STEPS - 1)
    restore_s = timing["restore_s"]
    sh.set_mesh(None)
    if tp_mesh.get_rank() == 0:
        print(f"  [rank 0] (c) step s {[round(times[s], 3) for s in times]}, "
              f"runs {run1_s:.3f} + {run2_s:.3f} s, restore "
              f"{restore_s:.3f} s, part {time.perf_counter() - t_part:.3f} s",
              flush=True)
    return dict(losses=[losses[s] for s in range(MESH_TRAIN_STEPS)],
                grad_norms=[gnorms[s] for s in range(MESH_TRAIN_STEPS)],
                update_norms=[updates[s] for s in range(MESH_TRAIN_STEPS)],
                step_s=[times[s] for s in range(MESH_TRAIN_STEPS)],
                traffic=[traffic[s] for s in range(MESH_TRAIN_STEPS)],
                sums=sums, run1_s=run1_s, run2_s=run2_s,
                restore_s=restore_s, file_bytes=file_bytes,
                s=time.perf_counter() - t_part)


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def mesh_report(torch, cfg, ranks, ref):
    """Hold the ranks' mesh parts against the single-device references and
    print their times, launches and collective traffic.  Decode logits are
    held in f32 (weights, cache and compute: the mesh's arithmetic) at
    TOL_MESH_F32 and reported in bf16 beside a single-device control, the
    same step with K1 and with the plain attention: random bf16 layers
    part two rounding paths past TOL_LOGITS on this cache, on one device
    as on a mesh.  Training is held by its losses, gradient norms and
    update norms (TOL_MESH_LOSS, TOL_MESH_UPDATE)."""
    from repro_torch.distributed import collectives
    r0 = ranks[0]
    L = cfg.n_layers
    out = dict(reference_s=ref["s"])
    tp, sp, tr = r0["mesh_tp"], r0["mesh_sp"], r0["mesh_train"]
    missed = []

    def held(got, want, what, tol=TOL_LOGITS):
        """hold_logits's report, its verdict at ``tol`` kept for the end,
        so that every part prints before a miss fails the run."""
        err = hold_logits(got, want, False, what)
        if not torch.allclose(got.float(), want.float(), **tol):
            missed.append(what)
        return err

    def decode_holds(part, want, label, where):
        """The f32 steps held, the bf16 steps and the control reported."""
        f32 = [held(g, w, f"{label} decode step {i} in f32 on {where} vs "
                    f"one device in f32", TOL_MESH_F32)
               for i, (g, w) in enumerate(zip(part["f32"]["logits"],
                                              want["f32"]["logits"]))]
        bf16 = [hold_logits(g, w, False, f"{label} decode step {i} in bf16 "
                            f"on {where} vs one device")
                for i, (g, w) in enumerate(zip(part["logits"],
                                               want["logits"]))]
        control = hold_logits(want["plain"], want["logits"][0], False,
                              f"{label} control: step 0 on one device, "
                              f"plain attention vs K1")
        return dict(f32_max_abs_err=max(f32), bf16_max_abs_err=max(bf16),
                    bf16_rel_l2=[rel_err(g, w) for g, w in
                                 zip(part["logits"], want["logits"])],
                    control_max_abs_err=control,
                    control_rel_l2=rel_err(want["plain"],
                                           want["logits"][0]))

    print(f"mesh parts {cfg.name} ({len(ranks)} gloo ranks on one card; "
          f"collectives staged through host memory by this program: none; "
          f"DTensor's {list(collectives.ROUTED)} of CUDA tensors routed to "
          f"c10d's collectives on the card, calls on rank 0: "
          f"{r0['routed']}); single-device references in "
          f"{ref['s']:.3f} s")
    # (a)
    for r in ranks:
        a = r["mesh_tp"]
        check(a["prefill_launches"] == L,
              f"(a) prefill launched K1 {a['prefill_launches']} times on a "
              f"rank, expected {L}")
        for run in (a["decode"], a["decode"]["f32"]):
            check(run["launches"] == L * MESH_DECODE,
                  f"(a) decode launched K1 {run['launches']} times on a "
                  f"rank, expected {L * MESH_DECODE}")
    err = held(tp["prefill"], ref["tp"]["prefill"],
               f"(a) prefill logits on {MESH_TP} vs one device")
    dec = tp["decode"]
    holds = decode_holds(dec, ref["tp"], "(a)", MESH_TP)
    out["tp"] = dict(prefill_s=tp["prefill_s"], unshard_s=tp["unshard_s"],
                     prefill_max_abs_err=err, **holds,
                     decode_step_s=_median(dec["step_s"][1:]),
                     one_device_step_s=_median(ref["tp"]["step_s"][1:]),
                     launches_per_step=L, collective_bytes_per_step=sum(
                         v[1] for v in dec["traffic"][-1].values()),
                     traffic_per_step=dec["traffic"][-1],
                     prefill_traffic=tp["prefill_traffic"], s=tp["s"])
    print(f"  (a) TP + FSDP on {MESH_TP}: weights gathered over data once "
          f"in {tp['unshard_s']:.3f} s; prefill {PREFILL_B} x "
          f"{MESH_PROMPT} in {tp['prefill_s']:.3f} s ({L} K1 launches a "
          f"rank), logits max abs err {err} vs one device; {MESH_DECODE} "
          f"decode steps from {MESH_PROMPT} ({L} K1 launches a step a "
          f"rank), f32 max abs err {holds['f32_max_abs_err']} (held), bf16 "
          f"{holds['bf16_max_abs_err']} (control on one device "
          f"{holds['control_max_abs_err']}); step "
          f"{out['tp']['decode_step_s'] * 1e3:.3f} ms (one device "
          f"{out['tp']['one_device_step_s'] * 1e3:.3f} ms); collectives a "
          f"step on rank 0 {dec['traffic'][-1]} ([calls, bytes]); "
          f"prefill's {tp['prefill_traffic']}; part {tp['s']:.3f} s")
    # (b)
    for r in ranks:
        b = r["mesh_sp"]
        for run in (b, b["f32"]):
            check(run["launches"] == L * MESH_DECODE
                  and run["lse_launches"] == L * MESH_DECODE,
                  f"(b) a rank launched K1 {run['launches']} times, "
                  f"{run['lse_launches']} with the log-sum-exp; expected "
                  f"{L * MESH_DECODE} each")
        check(b["cache_block"][2] == SP_CACHE // MESH_SP[0],
              f"(b) a rank's cache block {b['cache_block']}")
    holds = decode_holds(sp, ref["sp"], "(b)", MESH_SP)
    out["sp"] = dict(**holds, decode_step_s=_median(sp["step_s"][1:]),
                     one_device_step_s=_median(ref["sp"]["step_s"][1:]),
                     lse_launches=sp["lse_launches"],
                     lse_launches_all_ranks=sum(r["mesh_sp"]["lse_launches"]
                                                for r in ranks),
                     collective_bytes_per_step=sum(
                         v[1] for v in sp["traffic"][-1].values()),
                     traffic_per_step=sp["traffic"][-1], s=sp["s"])
    print(f"  (b) SP decode on {MESH_SP}, B1, cache {SP_CACHE} "
          f"({SP_CACHE // MESH_SP[0]} a rank, {sp['cache_placements']}), "
          f"weights replicated: {MESH_DECODE} steps from {SP_START} (the "
          f"new token's owner moves from rank 2 to rank 3), {L} K1 "
          f"decode-with-LSE launches a step a rank; f32 max abs err "
          f"{holds['f32_max_abs_err']} (held), bf16 "
          f"{holds['bf16_max_abs_err']} (control on one device "
          f"{holds['control_max_abs_err']}); step "
          f"{out['sp']['decode_step_s'] * 1e3:.3f} ms (one device "
          f"{out['sp']['one_device_step_s'] * 1e3:.3f} ms); collectives a "
          f"step on rank 0 {sp['traffic'][-1]}; part {sp['s']:.3f} s")
    # (c)
    rt = ref["train"]
    want = rt["losses"]
    if tr["sums"]["saved"] != tr["sums"]["restored"]:
        missed.append("(c) the state restored onto (4, 1) differs from the "
                      "one saved on (2, 2)")
    check(len(tr["losses"]) == MESH_TRAIN_STEPS,
          f"(c) ran {len(tr['losses'])} steps")

    def within(g, w, tol):
        return abs(g - w) <= tol["atol"] + tol["rtol"] * abs(w)

    update_err = []
    for s, (g, w) in enumerate(zip(tr["losses"], want)):
        if not within(g, w, TOL_MESH_LOSS):
            missed.append(f"(c) step {s} loss {g} on the mesh vs {w} on one "
                          f"device")
        gn, wn = tr["grad_norms"][s], rt["grad_norms"][s]
        if not within(gn, wn, TOL_MESH_UPDATE):
            missed.append(f"(c) step {s} gradient norm {gn} on the mesh vs "
                          f"{wn} on one device")
        got_u, want_u = tr["update_norms"][s], rt["update_norms"][s]
        check(sorted(got_u) == sorted(want_u), f"(c) step {s}'s leaves")
        off = sorted(n for n in want_u
                     if not within(got_u[n], want_u[n], TOL_MESH_UPDATE))
        if off:
            missed.append(f"(c) step {s} update norms off one device's: "
                          f"{[(n, got_u[n], want_u[n]) for n in off]}")
        update_err.append(max(abs(got_u[n] - want_u[n]) / max(want_u[n],
                                                                1e-30)
                              for n in want_u))
    moved = rt["step1_loss_before_update"] - want[1]
    if abs(moved) < MESH_LOSS_MARGIN * TOL_MESH_LOSS["atol"]:
        missed.append(f"(c) step 0's update moved step 1's loss by {moved} "
                      f"on one device, under {MESH_LOSS_MARGIN} x the loss "
                      f"hold's {TOL_MESH_LOSS['atol']}")
    out["train"] = dict(losses=tr["losses"], one_device_losses=want,
                        grad_norms=tr["grad_norms"],
                        one_device_grad_norms=rt["grad_norms"],
                        update_norm_max_rel_err=update_err,
                        step1_loss_moved_by_update=moved,
                        step_s=tr["step_s"],
                        one_device_step_s=ref["train"]["step_s"],
                        traffic=tr["traffic"], file_bytes=tr["file_bytes"],
                        run1_s=tr["run1_s"], run2_s=tr["run2_s"],
                        restore_s=tr["restore_s"], s=tr["s"])
    print(f"  (c) training {MESH_TRAIN_LAYERS} of {cfg.n_layers} layers, "
          f"{MESH_TRAIN_B} x {MESH_TRAIN_S} tokens a step: step 0 on "
          f"{MESH_TP}, saved at its end through the ranked manager "
          f"({tr['file_bytes']} B), restored onto {MESH_SP} with the saved "
          f"checksums ({tr['restore_s']:.3f} s), step 1 there; losses "
          f"{tr['losses']} vs one device {want} (held at {TOL_MESH_LOSS}; "
          f"step 0's update moved step 1's loss by {moved} on one device); "
          f"gradient norms {tr['grad_norms']} vs {rt['grad_norms']}; "
          f"update norms of {len(rt['update_norms'][0])} leaves, largest "
          f"relative error a step {update_err} (held at "
          f"{TOL_MESH_UPDATE}); step s "
          f"{[round(x, 3) for x in tr['step_s']]} (one device "
          f"{[round(x, 3) for x in ref['train']['step_s']]}); collectives "
          f"a step on rank 0 {tr['traffic']}; runs {tr['run1_s']:.3f} + "
          f"{tr['run2_s']:.3f} s, part {tr['s']:.3f} s")
    print(f"  {smi_line()}")
    check(not missed, f"mesh parts: {missed}")
    return out


def dist_checkpoint_phase(torch, cfg, nbytes: int, f0: str, tmp, weights):
    """F0, qwen3's weights as one flat file with the reference's vendor
    (``checkpoint_phase``'s): DIST_RANKS gloo ranks on the card restore it
    onto each mesh of DIST_MESHES and save it from there (each file's
    SHA-256 must be F0's: hashed and deleted here while the ranks go on,
    so at most two such files exist at once), then restore it onto
    DIST_EXTRA, with and without prefetch; every local shard bit-equal to
    a host restore of F0.  F0 is deleted at the end.  The ranks also run
    the model path under a mesh (``mesh_tp_part``, ``mesh_sp_part``,
    ``mesh_train_part``), held here against one device's run on
    ``weights``, computed before the spawn."""
    import threading
    from repro_torch.distributed.ranks import spawn_ranks
    t_phase = time.perf_counter()
    mesh_ref = mesh_references(torch, cfg, weights)
    replay = {k: {"fed": mesh_ref[k]["fed"],
                  "f32": {"fed": mesh_ref[k]["f32"]["fed"]}}
              for k in ("tp", "sp")}
    d = os.path.join(tmp, "dist")
    os.makedirs(d)
    size = os.path.getsize(f0)
    ctx = torch.multiprocessing.get_context("spawn")
    saved, verdicts = ctx.SimpleQueue(), ctx.SimpleQueue()
    hashed, f0_hash = [], {}

    def hasher():
        # F0's digest while the ranks start, then each rank file's; a
        # verdict for every file, so that rank 0 never waits in vain
        t0 = time.perf_counter()
        try:
            digest = sha256_file(f0)
        except OSError as e:
            digest, f0_hash["error"] = None, repr(e)
        f0_hash["s"] = time.perf_counter() - t0
        for _ in DIST_MESHES:
            path = saved.get()
            try:
                ok = digest is not None and sha256_file(path) == digest
                os.remove(path)
            except OSError as e:
                ok = repr(e)
            hashed.append((os.path.basename(path), ok))
            verdicts.put(ok)

    thread = threading.Thread(target=hasher, daemon=True)
    thread.start()
    t0, spawned = time.perf_counter(), time.time()
    ranks = spawn_ranks(dist_rank, DIST_RANKS, cfg, f0, d, saved,
                        verdicts, replay, device="cuda")
    t_ranks, ended = time.perf_counter() - t0, time.time()
    thread.join(10)
    check(len(hashed) == len(DIST_MESHES)
          and all(ok is True for _, ok in hashed),
          f"the ranks' files against F0's SHA-256: {hashed}")
    shutil.rmtree(os.path.join(d, "mesh-train"), ignore_errors=True)
    check(not os.listdir(d), f"{d} holds {os.listdir(d)}")
    os.remove(f0)
    shutil.rmtree(d)
    r0 = ranks[0]
    t_hash = f0_hash["s"]
    rec = dict(ranks=DIST_RANKS, file_bytes=size, f0_hash_s=t_hash,
               ranks_s=t_ranks, meshes={}, extra={},
               host_restore_s=[r["host_restore_s"] for r in ranks])
    print(f"distributed checkpoints {cfg.name}: F0 {size} B (the "
          f"reference's vendor), SHA-256 in {t_hash:.3f} s; {DIST_RANKS} gloo "
          f"ranks on {[r['device'] for r in ranks]} (spawned and "
          f"run in {t_ranks:.3f} s; each restored F0 to the host in "
          f"{[round(r['host_restore_s'], 3) for r in ranks]} s)")
    clocks = [r["clock"] for r in ranks]
    rec["spans_s"] = dict(
        start=max(c["enter"] for c in clocks) - spawned,
        host_restore=max(c["host"] for c in clocks)
        - max(c["enter"] for c in clocks),
        meshes=max(c["meshes"] for c in clocks)
        - max(c["host"] for c in clocks),
        steps=max(c["mesh_train"] for c in clocks)
        - max(c["meshes"] for c in clocks),
        mesh_train=max(c["exit"] for c in clocks)
        - max(c["mesh_train"] for c in clocks),
        end=ended - max(c["exit"] for c in clocks))
    print("  the ranks' time, s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in rec["spans_s"].items())
        + " (start: spawn to the last rank's first step; end: its last "
          "step to the spawn's return)")
    for shape in DIST_MESHES:
        m = r0["meshes"][shape]
        written = [r["meshes"][shape]["written"] for r in ranks]
        check(sum(written) == nbytes, f"mesh {shape}: the ranks wrote "
              f"{written} B, the leaves hold {nbytes} B")
        key = "{}x{}".format(*shape)
        rec["meshes"][key] = dict(
            restore_s=m["restore_s"], restore_mb_s=size / m["restore_s"]
            / 1e6, save_s=m["save_s"], save_mb_s=size / m["save_s"] / 1e6,
            written=written, shares=m["shares"])
        print(f"  mesh {shape} {DIST_AXES}: restore "
              f"{rec['meshes'][key]['restore_mb_s']:.1f} MB/s "
              f"({m['restore_s']:.3f} s), {m['leaves']} local shards "
              f"bit-equal on every rank (held in {m['hold_s']:.3f} s); save "
              f"{rec['meshes'][key]['save_mb_s']:.1f} MB/s "
              f"({m['save_s']:.3f} s), SHA-256 equal to F0's; bytes "
              f"written by ranks 0-{DIST_RANKS - 1} {written}; leaves "
              f"sharded on every mesh dim, on some, on none: "
              f"{[round(x, 4) for x in m['shares']]}")
    for case, shape, pf in DIST_EXTRA:
        e = r0["extra"][(case, pf)]
        rec["extra"][f"{case}-pf{pf}"] = dict(
            restore_s=e["restore_s"], hold_s=e["hold_s"],
            restore_mb_s=size / e["restore_s"] / 1e6, shares=e["shares"])
        print(f"  {case} on {shape}, prefetch_bytes={pf}: restore "
              f"{size / e['restore_s'] / 1e6:.1f} MB/s of F0 "
              f"({e['restore_s']:.3f} s), every local shard bit-equal (held "
              f"in {e['hold_s']:.3f} s); leaves sharded on every mesh dim, "
              f"on some, on none: {[round(x, 4) for x in e['shares']]}")
    rec["mesh"] = mesh_report(torch, cfg, ranks, mesh_ref)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  {smi_line()}")
    print(f"distributed checkpoints phase: {rec['phase_s']:.3f} s")
    return rec


def lost_shard_check(torch, cfg, ckpt_dir, want_sums):
    """Run 1's step-3 set loses data shard SET_LOST[0] (moved aside):
    ``restore_latest`` onto the card must reconstruct it through the
    parity and give run 1's checksums; then the shard is rebuilt, byte for
    byte the file moved aside."""
    import filecmp
    from repro_torch.checkpoint import redundancy, sharding
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.checkpoint.pytree_io import flatten_named
    from repro_torch.train.loop import init_state
    path = os.path.join(ckpt_dir, f"step_{TRAIN_DIE_AT:010d}.scda")
    doc = sharding.read_sharded_manifest(path)
    check(len(doc["shards"]) == SET_SHARDS
          and (doc.get("parity") or {}).get("m") == SET_PARITY,
          f"step {TRAIN_DIE_AT} was saved as {len(doc['shards'])} shards, "
          f"parity {doc.get('parity')}")
    name = doc["shards"][SET_LOST[0]]["file"]
    lost = os.path.join(ckpt_dir, name)
    aside = os.path.join(os.path.dirname(ckpt_dir), name + ".moved")
    os.replace(lost, aside)
    with _Spy(redundancy, "degraded_reader") as degraded:
        t0 = time.perf_counter()
        mgr = CheckpointManager(ckpt_dir, keep=1)
        tree, step = mgr.restore_latest(like=init_state(cfg, SEED, "meta"),
                                        device="cuda")
        mgr.close()
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    check(step == TRAIN_DIE_AT and {args[2] for _, args in degraded.calls}
          == {name}, f"restore_latest gave step {step}, reconstructing "
          f"{[args[2] for _, args in degraded.calls]}")
    check(checksums(torch, tree) == want_sums,
          "the degraded restore is not bit-equal to step 3's state")
    state_b = sum(t.numel() * t.element_size()
                  for _, t in flatten_named(tree)[0])
    del tree
    t0 = time.perf_counter()
    redundancy.rebuild_shard(path, doc, name)
    t_rebuild = time.perf_counter() - t0
    check(filecmp.cmp(lost, aside, shallow=False),
          f"the rebuilt {name} differs from the lost file")
    size = os.path.getsize(aside)
    os.remove(aside)
    rec = dict(lost=name, degraded_restore_s=t_restore,
               degraded_restore_mb_s=state_b / t_restore / 1e6,
               rebuild_s=t_rebuild, rebuild_mb_s=size / t_rebuild / 1e6)
    print(f"train {cfg.name} set: without {name}, restore_latest through "
          f"the parity {t_restore:.3f} s ({rec['degraded_restore_mb_s']:.1f} "
          f"MB/s), checksums equal to run 1's; rebuilt {size} B in "
          f"{t_rebuild:.3f} s ({rec['rebuild_mb_s']:.1f} MB/s), byte-"
          f"identical")
    return rec


def delta_chain_check(torch, cfg, ckpt_dir, final_state):
    """Run 2's step-5 save: a set whose shards are deltas of depth 1
    planned over step 3's set, each chunk stored or referenced into step
    3's shards; retention (keep=1) keeps step 3's set exactly when a chunk
    is referenced; and a restore through the chain gives run 2's final
    checksums."""
    from repro_torch.checkpoint import layout, sharding
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.train.loop import init_state
    path = os.path.join(ckpt_dir, f"step_{TRAIN_STEPS - 1:010d}.scda")
    doc = sharding.load_set(path)
    bases = {b["file"] for sd in doc["shard_docs"]
             for b in (sd.get("delta") or {}).get("bases", [])}
    depth = sharding.chain_depth(doc)
    step3 = f"step_{TRAIN_DIE_AT:010d}"
    names = set(os.listdir(ckpt_dir))
    kept = sorted(n for n in names if n.startswith(step3))
    check(depth == 1 and all(sharding.is_shard_name(b) is not None
                             and b.startswith(step3) for b in bases),
          f"step {TRAIN_STEPS - 1}: depth {depth}, bases {sorted(bases)}")
    if bases:
        base_files = {os.path.basename(p) for p in sum(set_files(
            os.path.join(ckpt_dir, f"{step3}.scda")), [])}
        check(bases <= base_files and base_files <= names,
              f"retention dropped step {TRAIN_DIE_AT}'s set, which step "
              f"{TRAIN_STEPS - 1} references: {sorted(names)}")
    else:
        check(not kept, f"step {TRAIN_DIE_AT}'s set was kept, though no "
              f"chunk of step {TRAIN_STEPS - 1} references it: {kept}")
    total = stored = 0
    for sd in doc["shard_docs"]:
        for leaf in sd["leaves"]:
            sizes = layout.chunk_sizes(leaf["nbytes"],
                                       leaf["chunks"]["bytes"])
            total += leaf["nbytes"]
            stored += sum(sizes[c] for c in leaf["present"])
    t0 = time.perf_counter()
    mgr = CheckpointManager(ckpt_dir, keep=1)
    tree, step = mgr.restore(TRAIN_STEPS - 1,
                             like=init_state(cfg, SEED, "meta"),
                             device="cuda")
    mgr.close()
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    check(step == TRAIN_STEPS - 1
          and checksums(torch, tree) == checksums(torch, final_state),
          "the chained restore is not bit-equal to run 2's final state")
    del tree
    rec = dict(depth=depth, bases=sorted(bases), stored_bytes=stored,
               state_bytes=total, stored_share=stored / total,
               set_bytes=ckpt_bytes(path), base_kept=bool(kept),
               chain_restore_s=t, chain_restore_mb_s=total / t / 1e6)
    print(f"train {cfg.name} set: step {TRAIN_STEPS - 1} is a delta of "
          f"depth {depth} planned over step {TRAIN_DIE_AT}'s set, "
          f"referencing {sorted(bases) or 'none of its chunks'}; stored "
          f"{stored} of {total} B (share {stored / total:.6f}), its set "
          f"{rec['set_bytes']} B; step {TRAIN_DIE_AT}'s set "
          f"{'kept' if kept else 'dropped'} by retention (keep=1); restored "
          f"through the chain in {t:.3f} s ({rec['chain_restore_mb_s']:.1f} "
          f"MB/s), checksums equal to run 2's final state")
    return rec


# ------------------------------------------------------------ phases 4, 5 --
def attention_apps(cfg, decode: bool = False) -> int:
    """Applications of attention in one forward, or with ``decode`` in one
    decode step: a K1 launch each (a hybrid model applies its one shared
    block once a group of ``shared_attn_every`` layers; a Mamba1 model has
    none; an encdec forward runs its encoder layers and its decoder
    layers' self- and cross-attention, a decode step the decoder's
    two)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    if cfg.family == "encdec":
        return 2 * cfg.n_layers + (0 if decode else cfg.encoder_layers)
    return cfg.n_layers if cfg.has_attention else 0


def hold_logits(got, want, hold: bool, what: str) -> float:
    """Two paths' logits: held within TOL_LOGITS, or (``hold`` false)
    reported with whether they are within it.  Returns the max abs err."""
    import torch
    if hold:
        return assert_close(got, want, TOL_LOGITS, what)
    err = max_err(got, want)
    within = torch.allclose(got.float(), want.float(), **TOL_LOGITS)
    print(f"{what}: max abs err {err}, relative L2 {rel_err(got, want)} "
          f"(reported, not held; within {TOL_LOGITS}: {within})")
    return err


def prefill_phase(torch, cfg, weights, k1, hold: bool = True,
                  S: int = PREFILL_S, extra=None):
    """One prefill of 4 × S tokens (first call), with the batch's
    ``extra`` inputs (a vlm's image, an encdec model's frames): a K1
    launch per attention application, logits against the plain attention
    path (held within TOL_LOGITS, or reported where ``hold`` is false).
    Returns (record, tokens)."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.train.step import make_prefill_step
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, S),
                           generator=gen, device=cuda, dtype=torch.int32)
    batch = {"tokens": tokens, **(extra or {})}
    prefill = make_prefill_step(cfg)
    apps = attention_apps(cfg)
    before = k1.launches
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = prefill(weights, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(k1.launches - before == apps,
          f"prefill launched K1 {k1.launches - before} times, expected "
          f"{apps}")
    check(tuple(logits.shape) == (PREFILL_B, cfg.vocab)
          and bool(torch.isfinite(logits).all()), "prefill logits")
    with mock.patch.object(ops, "flash_attention",
                           _plain_attention(fa_mod)):
        plain = prefill(weights, batch)
    err = hold_logits(logits, plain, hold,
                      f"{cfg.name} prefill logits, kernel vs plain attention")
    print(f"prefill {cfg.name}: B{PREFILL_B} S{S} in "
          f"{dt * 1e3:.3f} ms (first call), {apps} K1 launches, peak memory "
          f"{peak} B, logits vs plain attention max abs err {err}")
    return dict(first_call_ms=dt * 1e3, peak_bytes=peak, start_bytes=start,
                vs_plain_max_abs_err=err,
                vs_plain_rel_err=rel_err(logits, plain)), tokens


def _plain_attention(fa_mod):
    def plain(q, k, v, *, causal=True, window=None, kv_chunk=512,
              q_offset=0):
        return fa_mod.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, kv_chunk=kv_chunk,
                                            q_offset=q_offset)
    return plain


def serve_phase(torch, cfg, weights, k1, hold: bool = True, enc_out=None,
                prefill_extra=None):
    """4 requests of 64 + 32 tokens (an encdec model's with the encoder's
    output ``enc_out`` in its cache): a K1 decode launch per attention
    application and step; the logits after the prompt against a prefill
    of it (with ``prefill_extra`` in its batch), and those of the
    prompt's last step and 4 decode steps against the plain attention
    path, held within TOL_LOGITS (or reported where ``hold`` is
    false)."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.serve import generate
    from repro_torch.train.step import make_prefill_step, make_serve_step
    cuda = torch.device("cuda")
    prompts = serve_prompts(torch, cfg)
    events, kept, counts = [], {}, []

    def on_step(i, logits):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        counts.append(k1.launches)
        if PROMPT_LEN - 1 <= i < PROMPT_LEN + 4:
            kept[i] = logits.clone()

    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    before = k1.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(cfg, weights, prompts, GEN_LEN, max_len=MAX_LEN,
                   enc_out=enc_out, on_step=on_step)
    tokens = out["tokens"].cpu()
    t_total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = PROMPT_LEN + GEN_LEN
    apps = attention_apps(cfg, decode=True)
    per_step = [b - a for a, b in zip([before] + counts[:-1], counts)]
    check(per_step == [apps] * steps,
          f"K1 launches per step {sorted(set(per_step))}, expected {apps}")
    check(int(out["cache"]["pos"]) == steps, "cache position")
    check(tuple(tokens.shape) == (SERVE_B, GEN_LEN)
          and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab,
          "generated tokens")
    times = step_times(events)

    # the logits after the prompt equal a prefill of the same 64 tokens;
    # not in the moe family, whose decode step routes its SERVE_B tokens
    # with the capacity of SERVE_B tokens (1 slot an expert for granite)
    # and drops assignments that a prefill's capacity keeps, as the
    # reference's step does: there they are reported
    pre = make_prefill_step(cfg)(weights, {"tokens": prompts,
                                           **(prefill_extra or {})})
    err_pre = hold_logits(out["prompt_logits"], pre,
                          hold and cfg.family != "moe",
                          f"{cfg.name} serve logits after the prompt vs "
                          f"prefill")

    # the plain attention path, fed the same tokens, gives the same logits
    step_fn = make_serve_step(cfg)
    from repro_torch.models import init_cache
    cache = init_cache(cfg, SERVE_B, MAX_LEN, device=cuda)
    if enc_out is not None:
        cache["enc_out"].copy_(enc_out)
    seq = torch.cat([prompts, out["tokens"][:, :4].to(cuda)], dim=1)
    err_plain = 0.0
    with mock.patch.object(ops, "flash_attention",
                           _plain_attention(fa_mod)):
        for i in range(PROMPT_LEN + 4):
            logits, cache = step_fn(weights, cache, seq[:, i:i + 1])
            if i in kept:
                err_plain = max(err_plain, hold_logits(
                    kept[i], logits, hold, f"{cfg.name} step {i} logits, "
                    f"kernel vs plain attention"))
    print_serve(cfg, times, t_total, peak, f"{apps} K1 launches per step")
    print(f"serve: logits after prompt vs prefill max abs err {err_pre}; "
          f"kernel vs plain attention over the prompt's last step and 4 "
          f"decode steps max abs err {err_plain}")
    for b in range(SERVE_B):
        print(f"  req{b}: {tokens[b, :12].tolist()}...")
    return dict(times, peak_bytes=peak, start_bytes=start,
                prompt_vs_prefill_max_abs_err=err_pre,
                vs_plain_max_abs_err=err_plain), out


def serve_prompts(torch, cfg):
    """The served requests' prompts, (SERVE_B, PROMPT_LEN) token ids from
    the seed."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    return torch.randint(0, cfg.vocab, (SERVE_B, PROMPT_LEN), generator=gen,
                         device="cuda", dtype=torch.int32)


def step_times(events):
    """Times of a served batch from one CUDA event per step (step i fed
    token i): the mean decode step, its median and the highest percentile
    with ten samples above it, the mean prompt step, and tokens/s."""
    decode_ms = events[PROMPT_LEN - 1].elapsed_time(events[-1]) / GEN_LEN
    durations = sorted(a.elapsed_time(b) for a, b in
                       zip(events[PROMPT_LEN - 1:-1], events[PROMPT_LEN:]))
    return dict(
        decode_ms=decode_ms,
        decode_step_p50_ms=durations[len(durations) // 2],
        decode_step_hi_ms=durations[len(durations) - 11],
        decode_step_hi_pct=100 * (len(durations) - 10) // len(durations),
        prompt_step_ms=events[0].elapsed_time(events[PROMPT_LEN - 1])
        / (PROMPT_LEN - 1),
        tokens_per_s=SERVE_B * 1e3 / decode_ms)


def print_serve(cfg, t, total_s: float, peak: int, launches: str) -> None:
    print(f"serve {cfg.name}: {SERVE_B} requests, prompt {PROMPT_LEN}, "
          f"{GEN_LEN} greedy tokens, max_len {MAX_LEN}: "
          f"{t['decode_ms']:.4f} ms/decode step (median "
          f"{t['decode_step_p50_ms']:.4f}, p{t['decode_step_hi_pct']} "
          f"{t['decode_step_hi_ms']:.4f} over {GEN_LEN} steps), "
          f"{t['prompt_step_ms']:.4f} ms/prompt step, "
          f"{t['tokens_per_s']:.1f} tokens/s, total {total_s:.3f} s, peak "
          f"memory {peak} B, {launches}")


def decode_breakdown(torch, cfg, weights, out, kernels, label: str,
                     steps: int = 4):
    """Where a decode step's time goes: ``steps`` more greedy steps on the
    served cache under the profiler — wall time per step, device busy
    time per step, the share of the kernels whose name holds one of
    ``kernels`` and the heaviest kernels."""
    from repro_torch.train.step import make_serve_step
    step_fn = make_serve_step(cfg)
    state = dict(cache=out["cache"],
                 tok=out["tokens"][:, -1:].to(torch.int32))

    def run():
        for _ in range(steps):
            logits, state["cache"] = step_fn(weights, state["cache"],
                                             state["tok"])
            state["tok"] = torch.argmax(logits, dim=-1,
                                        keepdim=True).to(torch.int32)
    prof_rows, wall = profiled(torch, run)
    wall /= steps
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
            for e in prof_rows]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    mine = sum(r[1] for r in rows if any(k in r[0] for k in kernels))
    print(f"decode step breakdown {cfg.name} (profiled, {steps} steps): "
          f"wall {wall:.4f} ms/step, device busy {busy:.4f} ms/step (idle "
          f"share {1 - busy / wall:.4f}), {label} {mine:.4f} ms/step, "
          f"{sum(r[2] for r in rows)} device activities per step")
    for name, ms, n in rows[:8]:
        print(f"  {ms:.4f} ms/step  x{n}  {name[:90]}")
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                kernel_ms=mine, activities=sum(r[2] for r in rows),
                top=[dict(kernel=r[0][:120], ms=r[1], calls=r[2])
                     for r in rows[:8]])


# ------------------------------------------------ the falcon-mamba path --
def _plain_fused(ss_mod):
    def plain(x, dt, Bs, Cs, A, *, chunk=256):
        return ss_mod.mamba1_scan_plain(x, dt, Bs, Cs, A, chunk=chunk)
    return plain


def _layer(tree, i):
    """Layer ``i``'s parameters: views of the stacked tensors."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def zero_counts(K) -> None:
    for k in K.values():
        k.launches = 0


def counts(K):
    return {name: k.launches for name, k in K.items()}


def check_counts(K, want, what: str):
    """Every kernel's launches since the counts were set to 0: those named
    in ``want`` as given there, every other kernel none."""
    got = counts(K)
    expect = {name: want.get(name, 0) for name in K}
    check(got == expect, f"{what}: launches {got}, expected {expect}")
    return got


def ssm_prefill_phase(torch, cfg, weights, kf):
    """One prefill of 4 × 512: a fused K2 launch per layer and finite
    logits; then the same prefill with the plain scan, and how far apart
    the two runs' logits end."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss_mod
    from repro_torch.train.step import make_prefill_step
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                           generator=gen, device=cuda, dtype=torch.int32)
    prefill = make_prefill_step(cfg)
    before = kf.launches
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = prefill(weights, {"tokens": tokens})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(kf.launches - before == cfg.n_layers,
          f"prefill launched the fused K2 {kf.launches - before} times, "
          f"expected {cfg.n_layers}")
    check(tuple(logits.shape) == (PREFILL_B, cfg.vocab)
          and bool(torch.isfinite(logits).all()), "prefill logits")
    with mock.patch.object(ops, "mamba1_scan", _plain_fused(ss_mod)):
        plain = prefill(weights, {"tokens": tokens})
    check(bool(torch.isfinite(plain).all()), "plain-scan prefill logits")
    rec = dict(first_call_ms=dt * 1e3, peak_bytes=peak,
               logits_abs_max=logits.float().abs().max().item(),
               vs_plain_max_abs_err=max_err(logits, plain),
               vs_plain_rel_err=rel_err(logits, plain))
    print(f"prefill {cfg.name}: B{PREFILL_B} S{PREFILL_S} in {dt * 1e3:.3f}"
          f" ms (first call), {cfg.n_layers} fused K2 launches, peak memory "
          f"{peak} B; logits (|max| {rec['logits_abs_max']}) vs the plain "
          f"scan after {cfg.n_layers} layers: max abs err "
          f"{rec['vs_plain_max_abs_err']}, relative L2 "
          f"{rec['vs_plain_rel_err']} (reported; held layer by layer)")
    return rec, tokens


def ssm_serve_phase(torch, cfg, weights, kf):
    """4 requests of 64 + 32 tokens: no decode step launches a kernel
    (decode is closed form); then a prefill of the same prompts (a fused
    K2 launch per layer), and how far its logits are from those after the
    prompt."""
    from repro_torch.serve import generate
    from repro_torch.train.step import make_prefill_step
    prompts = serve_prompts(torch, cfg)
    events, seen = [], []

    def on_step(i, logits):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        seen.append(kf.launches)

    torch.cuda.reset_peak_memory_stats()
    before = kf.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(cfg, weights, prompts, GEN_LEN, max_len=MAX_LEN,
                   on_step=on_step)
    tokens = out["tokens"].cpu()
    t_total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = PROMPT_LEN + GEN_LEN
    check(seen == [before] * steps, "a decode step launched the fused K2")
    check(int(out["cache"]["pos"]) == steps, "cache position")
    check(tuple(tokens.shape) == (SERVE_B, GEN_LEN)
          and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab,
          "generated tokens")
    check(bool(torch.isfinite(out["prompt_logits"]).all()),
          "logits after the prompt")
    times = step_times(events)

    pre = make_prefill_step(cfg)(weights, {"tokens": prompts})
    check(kf.launches - before == cfg.n_layers, f"prefill of the prompts "
          f"launched the fused K2 {kf.launches - before} times")
    err, rel = max_err(out["prompt_logits"], pre), rel_err(
        out["prompt_logits"], pre)
    print_serve(cfg, times, t_total, peak, "0 K2 launches per step")
    print(f"serve {cfg.name}: logits after the prompt vs a prefill of the "
          f"same {PROMPT_LEN} tokens after {cfg.n_layers} layers: max abs "
          f"err {err}, relative L2 {rel} (reported; held layer by layer)")
    for b in range(SERVE_B):
        print(f"  req{b}: {tokens[b, :12].tolist()}...")
    return dict(times, peak_bytes=peak, prompt_vs_prefill_max_abs_err=err,
                prompt_vs_prefill_rel_err=rel), out, prompts


def ssm_layer_checks(torch, cfg, weights, tokens, prompts):
    """Every Mamba1 layer at full width, all sides fed the same input: the
    block through the fused K2 against the block through the unfused K2
    (decay and inc built in full, ``fused=False``) and against the block
    through the plain scan, on the prefill's inputs (4 × 512); and 64
    decode steps against the fused block on the prompts' inputs (4 × 64),
    which holds the conv taps, the state and the bf16 rounding of decode
    against prefill.  Beside them a second residual stream runs on the
    plain scan alone; how far it is from the kernel stream at each depth
    shows what the layers make of rounding differences end to end."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss_mod
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SSM
    eps = cfg.norm_eps
    x = xq = weights["embed"][tokens]
    xp = weights["embed"][prompts]
    worst_plain = worst_k2 = worst_dec = max_dec = 0.0
    divergence = {}
    for i in range(cfg.n_layers):
        lp = _layer(weights["layers"], i)
        u = L.rms_norm(x, lp["ln1"], eps)
        h = SSM.ssm_block(lp["ssm"], u, cfg)
        hk = SSM.mamba1_block(lp["ssm"], u, d_state=cfg.ssm_state,
                              chunk=1024, fused=False)
        with mock.patch.object(ops, "mamba1_scan", _plain_fused(ss_mod)):
            hp = SSM.ssm_block(lp["ssm"], u, cfg)
            xq = xq + SSM.ssm_block(lp["ssm"], L.rms_norm(xq, lp["ln1"], eps),
                                    cfg)
        for what, got in (("fused K2", h), ("unfused K2", hk)):
            r = rel_err(got, hp)
            check(r <= REL_LAYER_PLAIN, f"layer {i}: {what} block vs plain "
                  f"scan, relative L2 {r} > {REL_LAYER_PLAIN}")
            worst_plain = max(worst_plain, r)
        worst_k2 = max(worst_k2, rel_err(h, hk))
        x = x + h
        if (i + 1) & i == 0 or i + 1 == cfg.n_layers:   # depths 1, 2, 4, ...
            divergence[i + 1] = rel_err(xq, x)

        up = L.rms_norm(xp, lp["ln1"], eps)
        hb = SSM.ssm_block(lp["ssm"], up, cfg)
        state = SSM.init_ssm_state(cfg, SERVE_B, up.dtype, device=up.device)
        outs = []
        for t in range(PROMPT_LEN):
            o, state = SSM.ssm_decode(lp["ssm"], up[:, t:t + 1], state, cfg)
            outs.append(o)
        hd = torch.cat(outs, 1)
        r = rel_err(hd, hb)
        check(r <= REL_LAYER_DECODE, f"layer {i}: {PROMPT_LEN} decode steps "
              f"vs fused block, relative L2 {r} > {REL_LAYER_DECODE}")
        worst_dec, max_dec = max(worst_dec, r), max(max_dec, max_err(hd, hb))
        xp = xp + hb
    print(f"falcon layers: all {cfg.n_layers} held at full width; fused and "
          f"unfused K2 blocks vs plain scan relative L2 <= {worst_plain} "
          f"(limit {REL_LAYER_PLAIN}), fused vs unfused <= {worst_k2}; "
          f"{PROMPT_LEN} decode steps vs fused block relative L2 <= "
          f"{worst_dec} (limit {REL_LAYER_DECODE}), max abs err {max_dec}")
    print("falcon streams, fused K2 vs plain scan end to end, relative L2 of "
          "the residual stream by depth: " + ", ".join(
              f"{k}: {v:.3g}" for k, v in divergence.items()))
    return dict(layers=cfg.n_layers, plain_rel_err=worst_plain,
                fused_vs_unfused_rel_err=worst_k2, decode_rel_err=worst_dec,
                decode_max_abs_err=max_dec, stream_divergence=divergence)


def ssm_prefill_profile(torch, cfg, weights, tokens, fused_names):
    """Where a warm prefill's time goes: its time unprofiled, then one
    profiled run split into the fused K2, the matmuls and the rest; peak
    memory."""
    from repro_torch.train.step import make_prefill_step
    prefill = make_prefill_step(cfg)
    batch = {"tokens": tokens}
    warm_ms = cuda_time_ms(lambda: prefill(weights, batch), 3, warmup=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof_rows, wall = profiled(torch, lambda: prefill(weights, batch))
    peak = torch.cuda.max_memory_allocated()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof_rows), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    mine = [r for r in rows if any(k in r[0] for k in fused_names)]
    k_ms, k_n = sum(r[1] for r in mine), sum(r[2] for r in mine)
    check(k_n == cfg.n_layers, f"profiled prefill shows {k_n} fused K2 "
          f"launches")
    gemm = sum(r[1] for r in rows if any(
        k in r[0] for k in ("gemm", "nvjet", "xmma", "cutlass")))
    print(f"prefill {cfg.name} breakdown: warm {warm_ms:.3f} ms; profiled "
          f"wall {wall:.3f} ms, device busy {busy:.3f} ms (idle share "
          f"{1 - busy / wall:.4f}); fused K2 {k_ms:.3f} ms "
          f"({k_ms / k_n:.4f} ms/layer), matmuls {gemm:.3f} ms, the rest "
          f"{busy - k_ms - gemm:.3f} ms; peak memory {peak} B")
    for name, ms, n in rows[:8]:
        print(f"  {ms:.4f} ms  x{n}  {name[:90]}")
    return dict(warm_ms=warm_ms, wall_ms=wall, busy_ms=busy,
                idle_share=1 - busy / wall, fused_k2_ms=k_ms,
                fused_k2_ms_per_layer=k_ms / k_n, gemm_ms=gemm,
                other_ms=busy - k_ms - gemm, peak_bytes=peak,
                top=[dict(kernel=r[0][:120], ms=r[1], calls=r[2])
                     for r in rows[:8]])


# ------------------------------------------------------------- the paths --
def qwen_path(torch, K, tmp):
    """qwen3-1.7b through K1; returns (K1 launches, serve record)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import KERNEL_NAMES
    cfg = get_config(QWEN)
    weights, ckpt = checkpoint_phase(torch, cfg, tmp, keep=True)
    phase(f"{QWEN} weights as a set")
    ckpt["set"] = weights_set_phase(torch, cfg, weights, tmp)
    phase(f"{QWEN} distributed checkpoints ({DIST_RANKS} ranks on one "
          f"H100)")
    ckpt["dist"] = dist_checkpoint_phase(torch, cfg, ckpt["weight_bytes"],
                                         ckpt.pop("path"), tmp, weights)
    zero_counts(K)                            # the main path starts
    prefill, tokens = prefill_phase(torch, cfg, weights, K["k1"])
    serve, out = serve_phase(torch, cfg, weights, K["k1"])
    expected = attention_apps(cfg) * (1 + 1 + PROMPT_LEN + GEN_LEN)
    launches = check_counts(K, dict(k1=expected), f"the {cfg.name} path")
    prefill.update(k1_prefill_profile(torch, cfg, weights, tokens,
                                      KERNEL_NAMES))
    serve.update(checkpoint=ckpt, prefill=prefill,
                 breakdown=decode_breakdown(torch, cfg, weights, out,
                                            KERNEL_NAMES, "K1"))
    return launches["k1"], serve


def k1_prefill_profile(torch, cfg, weights, tokens, k1_names, extra=None):
    """A warm prefill of ``tokens`` (with the batch's ``extra`` inputs)
    beside the first call: its time unprofiled, then one profiled run
    split into K1, the matmuls and the rest."""
    from repro_torch.train.step import make_prefill_step
    prefill = make_prefill_step(cfg)
    batch = {"tokens": tokens, **(extra or {})}
    warm_ms = cuda_time_ms(lambda: prefill(weights, batch), 5, warmup=2)
    prof_rows, wall = profiled(torch, lambda: prefill(weights, batch))
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof_rows]
    busy = sum(r[1] for r in rows)
    k1 = [r for r in rows if any(k in r[0] for k in k1_names)]
    k1_ms, k1_n = sum(r[1] for r in k1), sum(r[2] for r in k1)
    check(k1_n == attention_apps(cfg),
          f"profiled prefill shows {k1_n} K1 launches")
    gemm = sum(r[1] for r in rows if any(
        k in r[0] for k in ("gemm", "nvjet", "xmma", "cutlass", "sm90_")))
    print(f"prefill {cfg.name}: warm {warm_ms:.3f} ms; profiled wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms (idle share "
          f"{1 - busy / wall:.4f}), K1 {k1_ms:.4f} ms ({k1_ms / k1_n:.5f} "
          f"ms a launch), matmuls {gemm:.3f} ms, the rest "
          f"{busy - k1_ms - gemm:.3f} ms")
    rows.sort(key=lambda r: -r[1])
    for name, ms, n in rows[:8]:
        print(f"  {ms:.4f} ms  x{n}  {name[:90]}")
    return dict(warm_ms=warm_ms, profiled_wall_ms=wall, busy_ms=busy,
                idle_share=1 - busy / wall, k1_ms=k1_ms,
                k1_ms_per_layer=k1_ms / k1_n, gemm_ms=gemm,
                other_ms=busy - k1_ms - gemm)


def falcon_path(torch, K, tmp):
    """falcon-mamba-7b through the fused K2, then its layers held one by one
    through the fused K2, the unfused K2 and the plain scan.  Returns
    (fused K2 launches on the serve path, unfused K2 launches in the layer
    checks, serve record)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import FUSED_KERNEL_NAMES
    cfg = dataclasses.replace(get_config(FALCON),
                              n_layers=FALCON_SERVE_LAYERS)
    free = shutil.disk_usage(tmp).free
    check(free >= DISK_NEED, f"{tmp} has {free} B free; the {cfg.name} "
          f"checkpoint needs about {DISK_NEED:.0f} B")
    weights, ckpt = checkpoint_phase(torch, cfg, tmp)
    zero_counts(K)                            # the main path starts
    prefill, tokens = ssm_prefill_phase(torch, cfg, weights, K["k2_fused"])
    plan = K["k2_fused"].last_plan
    check(plan.tma, f"the {cfg.name} prefill's fused K2 took the threads' "
          f"load path")
    print(f"{cfg.name} prefill's fused K2: {plan_text(plan)}")
    serve, out, prompts = ssm_serve_phase(torch, cfg, weights,
                                          K["k2_fused"])
    # a launch per layer in the prefill of 4 x 512 and in the prefill of
    # the 64-token prompts; none in the 96 decode steps
    launches = check_counts(K, dict(k2_fused=2 * cfg.n_layers),
                            f"the {cfg.name} path")["k2_fused"]
    serve.update(checkpoint=ckpt, prefill=prefill,
                 breakdown=decode_breakdown(torch, cfg, weights, out,
                                            FUSED_KERNEL_NAMES, "K2"))
    zero_counts(K)                            # the layer checks start
    serve["layers"] = ssm_layer_checks(torch, cfg, weights, tokens, prompts)
    # each layer: the fused block twice (the prefill's and the prompts'
    # inputs), the unfused block once
    k2_launches = check_counts(
        K, dict(k2_fused=2 * cfg.n_layers, k2=cfg.n_layers),
        f"the {cfg.name} layer checks")["k2"]
    serve["prefill_profile"] = ssm_prefill_profile(torch, cfg, weights,
                                                   tokens, FUSED_KERNEL_NAMES)
    return launches, k2_launches, serve


# ------------------------------------------------------ the zamba2 path --
def hold_attention_block(torch, p, u, positions, window, kw, what: str,
                         causal: bool = True):
    """One attention block at full width on input ``u`` (causal, or an
    encoder's without the mask): K1's prefill kernel on the block's q, k,
    v held against the plain version (TOL_BF16), and the block through K1
    against the block through the plain attention (REL_APP).  Returns (the
    block's output through K1, the kernel's max abs err, the block's
    relative L2 error)."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    q, k, v = L._project_qkv(p, u, kw["n_heads"], kw["n_kv"],
                             kw["head_dim"], positions, kw["rope_base"],
                             kw["eps"])
    masks = dict(causal=causal, window=window)
    core = assert_close(
        fa_mod.flash_attention_cuda(q, k, v, **masks),
        fa_mod.flash_attention_plain(q, k, v, **masks), TOL_BF16,
        f"{what}: K1 vs plain on its q, k, v")
    h = L.attention_block(p, u, **masks, **kw)
    with mock.patch.object(ops, "flash_attention", _plain_attention(fa_mod)):
        hp = L.attention_block(p, u, **masks, **kw)
    r = rel_err(h, hp)
    check(r <= REL_APP, f"{what}: block through K1 vs plain attention, "
          f"relative L2 {r} > {REL_APP}")
    return h, core, r


def hold_attention_decode(torch, p, up, window, kw, what: str):
    """One attention block's PROMPT_LEN decode steps on ``up`` (K1's decode
    kernel into a MAX_LEN cache) held against its prefill
    (REL_LAYER_DECODE).  Returns (the prefill's output, the relative L2
    error, the max abs err)."""
    from repro_torch.models import layers as L
    hb = L.attention_block(p, up, window=window, **kw)
    kc = torch.zeros((up.shape[0], MAX_LEN, kw["n_kv"], kw["head_dim"]),
                     dtype=up.dtype, device=up.device)
    vc = torch.zeros_like(kc)
    outs = []
    for t in range(up.shape[1]):
        pos = torch.tensor(t, dtype=torch.int32, device=up.device)
        o, _, _ = L.attention_decode(p, up[:, t:t + 1], kc, vc, pos,
                                     window=window, **kw)
        outs.append(o)
    hd = torch.cat(outs, 1)
    r = rel_err(hd, hb)
    check(r <= REL_LAYER_DECODE, f"{what}: {up.shape[1]} decode steps vs its "
          f"prefill, relative L2 {r} > {REL_LAYER_DECODE}")
    return hb, r, max_err(hd, hb)


def hybrid_app_checks(torch, cfg, weights, tokens):
    """Each shared-attention application of the hybrid model at full
    width, kernel and plain attention fed the same input: the residual
    stream walks the groups on the prefill's tokens (4 × 512); at each
    application the K1 prefill kernel's output on the block's q, k, v is
    held against the plain version's (TOL_BF16) and the block's output
    through K1 against the block's through the plain attention
    (REL_APP).  On the prompts' stream (4 × 64) every Mamba2 layer and
    every application decoded token by token (the application through
    K1's decode kernel) is held against its prefill (REL_LAYER_DECODE).
    Beside them a second residual stream runs on the plain attention
    alone; how far it is from the kernel stream after each application
    shows what the layers make of rounding differences end to end."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SSM
    eps, E = cfg.norm_eps, cfg.shared_attn_every
    sa = weights["shared_attn"]
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
              head_dim=cfg.head_dim_, rope_base=cfg.rope_base, eps=eps)
    plain = _plain_attention(fa_mod)
    prompts = serve_prompts(torch, cfg)
    x = xq = weights["embed"][tokens]
    xp = weights["embed"][prompts]
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    worst_core = worst_app = worst_dec = max_dec = worst_ssm = 0.0
    divergence = {}

    def decoded(step, u, state):
        """``step`` over u's PROMPT_LEN tokens one at a time."""
        outs = []
        for t in range(PROMPT_LEN):
            o, state = step(u[:, t:t + 1], state, t)
            outs.append(o)
        return torch.cat(outs, 1)

    def ssm_step(lp):
        return lambda u, st, t: SSM.ssm_decode(lp["ssm"], u, st, cfg)

    for g in range(attention_apps(cfg)):
        for i in range(g * E, (g + 1) * E):
            lp = _layer(weights["layers"], i)
            x, xq = (s_ + SSM.ssm_block(
                lp["ssm"], L.rms_norm(s_, lp["ln1"], eps), cfg)
                for s_ in (x, xq))
            up = L.rms_norm(xp, lp["ln1"], eps)
            hb = SSM.ssm_block(lp["ssm"], up, cfg)
            hd = decoded(ssm_step(lp), up, SSM.init_ssm_state(
                cfg, SERVE_B, up.dtype, device=up.device))
            r = rel_err(hd, hb)
            check(r <= REL_LAYER_DECODE, f"layer {i}: {PROMPT_LEN} decode "
                  f"steps vs its prefill, relative L2 {r} > "
                  f"{REL_LAYER_DECODE}")
            worst_ssm = max(worst_ssm, r)
            xp = xp + hb
        h, core, r = hold_attention_block(
            torch, sa["attn"], L.rms_norm(x, sa["ln"], eps), positions, None,
            kw, f"application {g}")
        worst_core, worst_app = max(worst_core, core), max(worst_app, r)
        with mock.patch.object(ops, "flash_attention", plain):
            xq = xq + L.attention_block(sa["attn"],
                                        L.rms_norm(xq, sa["ln"], eps), **kw)
        x = x + h
        divergence[g + 1] = rel_err(xq, x)

        hb, r, m = hold_attention_decode(
            torch, sa["attn"], L.rms_norm(xp, sa["ln"], eps), None, kw,
            f"application {g}")
        worst_dec, max_dec = max(worst_dec, r), max(max_dec, m)
        xp = xp + hb
    print(f"{cfg.name} shared-attention applications: all "
          f"{attention_apps(cfg)} held at full width; K1 vs plain on each "
          f"application's q, k, v max abs err {worst_core} (tol {TOL_BF16}); "
          f"block through K1 vs plain attention relative L2 <= {worst_app} "
          f"(limit {REL_APP}); {PROMPT_LEN} decode steps vs prefill relative "
          f"L2 <= {worst_dec} (limit {REL_LAYER_DECODE}), max abs err "
          f"{max_dec}; all {cfg.n_layers} Mamba2 layers, {PROMPT_LEN} decode "
          f"steps vs prefill relative L2 <= {worst_ssm} (limit "
          f"{REL_LAYER_DECODE})")
    print(f"{cfg.name} streams, K1 vs plain attention end to end, relative "
          f"L2 of the residual stream after each application: " + ", ".join(
              f"{k}: {v:.3g}" for k, v in divergence.items()))
    return dict(applications=attention_apps(cfg), core_max_abs_err=worst_core,
                app_rel_err=worst_app, decode_rel_err=worst_dec,
                decode_max_abs_err=max_dec, ssm_decode_rel_err=worst_ssm,
                stream_divergence=divergence)


def zamba_path(torch, K, tmp):
    """zamba2-2.7b through K1 at head dim 80, then each of its
    shared-attention applications and Mamba2 layers held one by one.
    Returns (K1 launches on the serve path, serve record)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import KERNEL_NAMES
    cfg = get_config(ZAMBA)
    apps = attention_apps(cfg)
    weights, ckpt = checkpoint_phase(torch, cfg, tmp)
    zero_counts(K)                            # the main path starts
    # 54 random Mamba2 layers amplify rounding differences until two
    # paths' logits decorrelate (the application checks print how far), so
    # the whole-model logits are reported and the applications and layers
    # held one by one, as falcon-mamba's layers are
    prefill, tokens = prefill_phase(torch, cfg, weights, K["k1"], hold=False)
    serve, out = serve_phase(torch, cfg, weights, K["k1"], hold=False)
    launches = check_counts(
        K, dict(k1=apps * (1 + 1 + PROMPT_LEN + GEN_LEN)),
        f"the {cfg.name} path")
    prefill.update(k1_prefill_profile(torch, cfg, weights, tokens,
                                      KERNEL_NAMES))
    serve.update(checkpoint=ckpt, prefill=prefill,
                 breakdown=decode_breakdown(torch, cfg, weights, out,
                                            KERNEL_NAMES, "K1"))
    zero_counts(K)                            # the application checks start
    serve["applications"] = hybrid_app_checks(torch, cfg, weights, tokens)
    # each application: the kernel alone, the block on the prefill's and on
    # the prompts' inputs, and the prompts' decode steps
    check_counts(K, dict(k1=apps * (3 + PROMPT_LEN)),
                 f"the {cfg.name} application checks")
    return launches["k1"], serve


# ------------------------------------------------------ the gemma3 path --
def gemma_path(torch, K, tmp):
    """gemma3-4b through K1 at head dim 256: the serve cell as qwen3's, then
    its window on the card (``long_context_phase``).  Returns (K1 launches
    on both, serve record)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import KERNEL_NAMES
    from repro_torch.train.step import make_prefill_step
    cfg = dataclasses.replace(get_config(GEMMA), n_layers=GEMMA_SERVE_LAYERS)
    apps = attention_apps(cfg)
    weights, ckpt = checkpoint_phase(torch, cfg, tmp)
    zero_counts(K)                            # the main path starts
    # 34 random layers carry two rounding paths' logits 0.10-0.28 apart,
    # past TOL_LOGITS where qwen3's 28 held: the whole-model logits are
    # reported and each layer held, as zamba2's applications are
    prefill, tokens = prefill_phase(torch, cfg, weights, K["k1"], hold=False)
    serve, out = serve_phase(torch, cfg, weights, K["k1"], hold=False)
    launches = check_counts(K, dict(k1=apps * (1 + 1 + PROMPT_LEN + GEN_LEN)),
                            f"the {cfg.name} path")["k1"]
    zero_counts(K)                            # the long-context path starts
    long, long_tokens, start, fed = long_context_phase(torch, cfg, weights,
                                                       K["k1"])
    launches += check_counts(K, dict(k1=apps * (1 + LONG_STEPS)),
                             f"the {cfg.name} long-context path")["k1"]
    zero_counts(K)                            # the layer checks start
    serve["layers"] = dense_layer_checks(torch, cfg, weights, tokens)
    long["layers"] = dense_layer_checks(torch, cfg, weights, long_tokens,
                                        decode=False)
    long["decode_layers"] = long_decode_layer_checks(torch, cfg, weights,
                                                     start, fed)
    # each layer: the kernel alone and the block, on the prefill's and on
    # the long prefill's inputs; the block on the prompts' and their decode
    # steps; the long decode's steps
    check_counts(K, dict(k1=apps * (2 + 2 + 1 + PROMPT_LEN + LONG_STEPS)),
                 f"the {cfg.name} layer checks")
    prefill_long = make_prefill_step(cfg)
    long["prefill_warm_ms"] = cuda_time_ms(
        lambda: prefill_long(weights, {"tokens": long_tokens}), 3, warmup=1)
    print(f"{cfg.name} prefill 1 x {LONG_S}: warm "
          f"{long['prefill_warm_ms']:.3f} ms")
    prefill.update(k1_prefill_profile(torch, cfg, weights, tokens,
                                      KERNEL_NAMES))
    serve.update(checkpoint=ckpt, prefill=prefill, long_context=long,
                 breakdown=decode_breakdown(torch, cfg, weights, out,
                                            KERNEL_NAMES, "K1"))
    return launches, serve


def dense_layer_checks(torch, cfg, weights, tokens, decode: bool = True,
                       x0=None):
    """Each layer of a dense or moe model at full width, K1 and the plain
    attention fed the same input.  The residual stream walks the layers on
    ``tokens``; at each layer the K1 prefill kernel's output on the layer's
    q, k, v is held against the plain version's (TOL_BF16) and the
    attention block through K1 against the block through the plain
    attention (REL_APP), each with the layer's window.  With ``decode``, on
    the prompts' stream (4 × 64) each layer's attention decoded token by
    token (K1's decode kernel into a MAX_LEN cache) is held against its
    prefill (REL_LAYER_DECODE): the attention alone, as an MoE layer's
    decode step routes with another capacity than its prefill.  Beside
    them a second residual stream runs on the plain attention alone; how
    far it is from the kernel stream after each layer shows what the
    layers make of rounding differences end to end.  ``x0`` starts the
    residual stream instead of the embedded tokens (a vlm's: the image
    prefix before them)."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    eps, kw = cfg.norm_eps, LM._attn_kwargs(cfg)
    plain = _plain_attention(fa_mod)
    x = xq = weights["embed"][tokens] if x0 is None else x0
    B, S = x.shape[:2]
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    windows = LM._windows_per_layer(cfg, S)
    dec_windows = LM._windows_per_layer(cfg, MAX_LEN)
    prompts = serve_prompts(torch, cfg)
    xp = weights["embed"][prompts]
    worst_core = worst_block = worst_dec = max_dec = 0.0
    divergence = {}
    for i in range(cfg.n_layers):
        lp = _layer(weights["layers"], i)
        window = windows[i] if windows else None
        h, core, r = hold_attention_block(
            torch, lp["attn"], L.rms_norm(x, lp["ln1"], eps), positions,
            window, kw, f"layer {i} (window {window})")
        worst_core, worst_block = max(worst_core, core), max(worst_block, r)
        with mock.patch.object(ops, "flash_attention", plain):
            xq = xq + L.attention_block(
                lp["attn"], L.rms_norm(xq, lp["ln1"], eps), window=window,
                **kw)
        x = x + h
        x = x + LM._ffn(cfg, lp, L.rms_norm(x, lp["ln2"], eps))[0]
        xq = xq + LM._ffn(cfg, lp, L.rms_norm(xq, lp["ln2"], eps))[0]
        divergence[i + 1] = rel_err(xq, x)
        if not decode:
            continue
        hb, r, m = hold_attention_decode(
            torch, lp["attn"], L.rms_norm(xp, lp["ln1"], eps),
            dec_windows[i] if dec_windows else None, kw, f"layer {i}")
        worst_dec, max_dec = max(worst_dec, r), max(max_dec, m)
        xp = xp + hb
        xp = xp + LM._ffn(cfg, lp, L.rms_norm(xp, lp["ln2"], eps))[0]
    print(f"{cfg.name} layers on {B} x {S} tokens: all {cfg.n_layers} held at "
          f"full width; K1 vs plain on each layer's q, k, v max abs err "
          f"{worst_core} (tol {TOL_BF16}); block through K1 vs plain "
          f"attention relative L2 <= {worst_block} (limit {REL_APP})"
          + (f"; {PROMPT_LEN} decode steps vs prefill relative L2 <= "
             f"{worst_dec} (limit {REL_LAYER_DECODE}), max abs err {max_dec}"
             if decode else ""))
    print(f"{cfg.name} streams on {B} x {S} tokens, K1 vs plain attention end "
          f"to end, relative L2 of the residual stream after layers " +
          ", ".join(f"{k}: {v:.3g}" for k, v in divergence.items()
                    if k % 6 == 0 or k == cfg.n_layers))
    return dict(layers=cfg.n_layers, core_max_abs_err=worst_core,
                block_rel_err=worst_block,
                decode_rel_err=worst_dec if decode else None,
                decode_max_abs_err=max_dec if decode else None,
                stream_divergence=divergence)


def long_decode_layer_checks(torch, cfg, weights, cache, fed):
    """The long decode's steps layer by layer: the residual stream of each
    step walks the layers on the kernel path from the decode's starting
    ``cache`` and fed tokens; at each layer the attention through K1's
    decode kernel is held against the plain attention on the same input
    and cache (REL_APP; both write the same key and value at the step's
    position)."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    eps, kw = cfg.norm_eps, LM._attn_kwargs(cfg)
    plain = _plain_attention(fa_mod)
    windows = LM._windows_per_layer(cfg, LONG_CACHE)
    layers = [_layer(weights["layers"], j) for j in range(cfg.n_layers)]
    worst = 0.0
    for step, tok in enumerate(fed):
        pos = cache["pos"]
        x = weights["embed"][tok]
        for j, lp in enumerate(layers):
            u = L.rms_norm(x, lp["ln1"], eps)
            args = (lp["attn"], u, cache["k"][j], cache["v"][j], pos)
            h, _, _ = L.attention_decode(*args, window=windows[j], **kw)
            with mock.patch.object(ops, "flash_attention", plain):
                hp, _, _ = L.attention_decode(*args, window=windows[j], **kw)
            r = rel_err(h, hp)
            check(r <= REL_APP, f"long decode at pos {LONG_POS + step}, "
                  f"layer {j}: attention through K1 vs plain, relative L2 "
                  f"{r} > {REL_APP}")
            worst = max(worst, r)
            x = x + h
            x = x + L.mlp_block(lp["mlp"], L.rms_norm(x, lp["ln2"], eps),
                                cfg.mlp_type)
        cache["pos"] = pos + 1
    print(f"{cfg.name} long decode layers: {len(fed)} steps from pos "
          f"{LONG_POS} x {cfg.n_layers} layers held; attention through K1's "
          f"decode kernel vs plain relative L2 <= {worst} (limit {REL_APP})")
    return dict(steps=len(fed), rel_err=worst)


def greedy_agrees(got, plain) -> bool:
    """The kernel path's greedy token is the plain path's, or scores within
    TOL_LOGITS of the plain path's best (a near tie that either path's
    rounding may break)."""
    tok = int(got.argmax())
    best = plain.float().max()
    return float(plain[0, tok]) >= float(
        best - TOL_LOGITS["atol"] - TOL_LOGITS["rtol"] * best.abs())


def long_context_phase(torch, cfg, weights, k1):
    """gemma3's window on the card at full width.  A prefill of 1 x LONG_S
    tokens, whose local layers mask keys ``attn_window`` back: a K1 launch a
    layer.  Then LONG_STEPS greedy
    decode steps of one request from a cache of LONG_CACHE keys filled with
    seeded random bf16 K/V and its position set to LONG_POS, so the local
    layers' decode kernel skips the splits before the window: a K1 launch a
    layer and step; the plain attention path, fed the same tokens from the
    same cache, gives the same greedy token (or one within TOL_LOGITS of
    its best).  Both paths' logits are reported (``gemma_path`` holds the
    layers).  Returns (record, the prefill's tokens, the decode's starting
    cache, its fed tokens)."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.models import init_cache
    from repro_torch.train.step import make_prefill_step, make_serve_step
    cuda = torch.device("cuda")
    apps = attention_apps(cfg)
    gen = torch.Generator(device=cuda).manual_seed(SEED + 3)
    tokens = torch.randint(0, cfg.vocab, (1, LONG_S), generator=gen,
                           device=cuda, dtype=torch.int32)
    prefill = make_prefill_step(cfg)
    before = k1.launches
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = prefill(weights, {"tokens": tokens})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(k1.launches - before == apps, f"long prefill launched K1 "
          f"{k1.launches - before} times, expected {apps}")
    check(tuple(logits.shape) == (1, cfg.vocab)
          and bool(torch.isfinite(logits).all()), "long prefill logits")
    with mock.patch.object(ops, "flash_attention", _plain_attention(fa_mod)):
        plain = prefill(weights, {"tokens": tokens})
    err_pre = hold_logits(logits, plain, False, f"{cfg.name} prefill 1 x "
                          f"{LONG_S} logits, kernel vs plain attention")

    cache = init_cache(cfg, 1, LONG_CACHE, device=cuda)
    for name in ("k", "v"):
        for layer in cache[name]:
            layer.copy_(torch.randn(layer.shape, generator=gen, device=cuda))
    cache["pos"].fill_(LONG_POS)
    start = {name: t.clone() for name, t in cache.items()}
    step_fn = make_serve_step(cfg)
    tok = tokens[:, -1:]
    fed, kept, per_step, events = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    events.append(ev)
    for _ in range(LONG_STEPS):
        before = k1.launches
        fed.append(tok)
        logits, cache = step_fn(weights, cache, tok)
        per_step.append(k1.launches - before)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        kept.append(logits)
        tok = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    torch.cuda.synchronize()
    dec_peak = torch.cuda.max_memory_allocated()
    check(per_step == [apps] * LONG_STEPS,
          f"long decode: K1 launches per step {sorted(set(per_step))}, "
          f"expected {apps}")
    check(int(cache["pos"]) == LONG_POS + LONG_STEPS, "long cache position")
    step_ms = events[0].elapsed_time(events[-1]) / LONG_STEPS
    err_dec, same, ties = 0.0, 0, []
    cache = {name: t.clone() for name, t in start.items()}
    with mock.patch.object(ops, "flash_attention", _plain_attention(fa_mod)):
        for i in range(LONG_STEPS):
            plain, cache = step_fn(weights, cache, fed[i])
            err_dec = max(err_dec, hold_logits(
                kept[i], plain, False, f"{cfg.name} decode step at pos "
                f"{LONG_POS + i} of {LONG_CACHE}, kernel vs plain attention"))
            check(greedy_agrees(kept[i], plain),
                  f"{cfg.name} decode at pos {LONG_POS + i}: the kernel's "
                  f"greedy token scores below the plain path's best by more "
                  f"than {TOL_LOGITS}")
            if int(kept[i].argmax()) == int(plain.argmax()):
                same += 1
            else:
                ties.append(LONG_POS + i)
    local = sum(not cfg.layer_is_global(i) for i in range(cfg.n_layers))
    print(f"{cfg.name} long context: prefill 1 x {LONG_S} (window "
          f"{cfg.attn_window} on {local} of {cfg.n_layers} layers) "
          f"{dt * 1e3:.3f} ms first call, peak memory {peak} B, {apps} K1 "
          f"launches, logits vs plain attention max abs err {err_pre}; "
          f"{LONG_STEPS} "
          f"decode steps from pos {LONG_POS} of a {LONG_CACHE} cache: "
          f"{step_ms:.4f} ms/step, peak memory {dec_peak} B, {apps} K1 "
          f"launches a step, logits vs plain attention max abs err "
          f"{err_dec}, greedy tokens equal in {same} of {LONG_STEPS} steps "
          f"(near ties at {ties or 'none'})")
    return dict(prefill_first_call_ms=dt * 1e3, prefill_peak_bytes=peak,
                prefill_vs_plain_max_abs_err=err_pre, decode_ms=step_ms,
                decode_peak_bytes=dec_peak,
                decode_vs_plain_max_abs_err=err_dec,
                greedy_equal_steps=same, near_ties=ties), tokens, start, fed


# ---------------------------------------------------- the granite path --
def granite_path(torch, K, tmp):
    """granite-moe-3b-a800m through K1 at head dim 64, group 3, and the MoE
    block: the serve cell as qwen3's (the logits after the prompt reported
    against a prefill, not held: see serve_phase), then each layer held as
    gemma3's, and each MoE layer's share of dropped assignments in a
    prefill and in a decode step.  Returns (K1 launches, serve record)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import KERNEL_NAMES
    cfg = dataclasses.replace(get_config(GRANITE),
                              n_layers=GRANITE_SERVE_LAYERS)
    apps = attention_apps(cfg)
    weights, ckpt = checkpoint_phase(torch, cfg, tmp)
    zero_counts(K)                            # the main path starts
    # wherever K1's and the plain attention's roundings flip a near tie of
    # the router, a token goes to other experts: over 32 random bf16
    # layers the two residual streams part within a few layers, and the
    # logits with them, so the whole-model logits are reported and each
    # layer held, as gemma3's
    prefill, tokens = prefill_phase(torch, cfg, weights, K["k1"],
                                    hold=False)
    serve, out = serve_phase(torch, cfg, weights, K["k1"], hold=False)
    launches = check_counts(K, dict(k1=apps * (1 + 1 + PROMPT_LEN + GEN_LEN)),
                            f"the {cfg.name} path")["k1"]
    zero_counts(K)                            # the layer checks start
    serve["layers"] = dense_layer_checks(torch, cfg, weights, tokens)
    serve["dropped"] = moe_drop_shares(torch, cfg, weights, tokens, out)
    # each layer: the kernel alone and the block on the prefill's inputs,
    # the block on the prompts' and their decode steps; then a prefill and
    # a decode step
    check_counts(K, dict(k1=apps * (2 + 1 + PROMPT_LEN + 2)),
                 f"the {cfg.name} layer checks")
    prefill.update(k1_prefill_profile(torch, cfg, weights, tokens,
                                      KERNEL_NAMES))
    serve.update(checkpoint=ckpt, prefill=prefill,
                 breakdown=decode_breakdown(torch, cfg, weights, out,
                                            KERNEL_NAMES, "K1"))
    return launches, serve


def moe_drop_shares(torch, cfg, weights, tokens, out):
    """Each MoE layer's share of dropped expert assignments in the
    prefill of ``tokens`` (4 x 512: 512 slots an expert) and in one more
    decode step of the served requests (SERVE_B tokens: 1 slot an
    expert).  The decode step runs with CUDA's sync debug mode set to
    raise: it reads no device value on the host."""
    from repro_torch.models import layers as L
    from repro_torch.train.step import make_prefill_step, make_serve_step
    real, shares = L.moe_route, []

    def route(*args, **kw):
        r = real(*args, **kw)
        shares.append((~r.keep).float().mean())
        return r

    with mock.patch.object(L, "moe_route", route):
        make_prefill_step(cfg)(weights, {"tokens": tokens})
        prefill = torch.stack(shares).tolist()
        shares.clear()
        tok = out["tokens"][:, -1:].to(torch.int32)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            make_serve_step(cfg)(weights, out["cache"], tok)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        decode = torch.stack(shares).tolist()
    check(len(prefill) == len(decode) == cfg.n_layers,
          f"{len(prefill)}, {len(decode)} MoE calls, expected "
          f"{cfg.n_layers} each")
    caps = {n: L.moe_capacity(n, cfg.n_experts, cfg.experts_top_k,
                              cfg.capacity_factor)
            for n in (tokens.numel(), tok.numel())}
    for what, got, n in (("prefill", prefill, tokens.numel()),
                         ("decode step", decode, tok.numel())):
        print(f"{cfg.name} dropped expert assignments by layer, {what} of "
              f"{n} tokens (capacity {caps[n]} an expert): mean "
              f"{sum(got) / len(got):.4f}, " + ", ".join(
                  f"{x:.4f}" for x in got))
    print(f"{cfg.name} decode step under CUDA sync debug mode \"error\": no "
          f"host sync")
    return dict(prefill=prefill, decode=decode,
                capacity={str(n): c for n, c in caps.items()})


# ------------------------------------------------ the whisper path --
def seeded_embeds(torch, cfg, n: int, seed: int):
    """(PREFILL_B, n, d_model) seeded random embeddings in the compute
    dtype: whisper's frames or llava's patches (both models' frontends
    are stubs, as in the reference)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((PREFILL_B, n, cfg.d_model), generator=gen,
                       device="cuda").to(torch.bfloat16)


def hold_cross_attention(torch, cfg, p, u, enc_out, what: str):
    """One decoder layer's cross-attention at full width on input ``u``
    against the encoder's output: K1's prefill kernel on its q, k, v
    (no mask) held against the plain version (TOL_BF16), and the block
    through K1 against the block through the plain attention (REL_APP).
    Returns (the block's output through K1, the kernel's max abs err, the
    block's relative L2 error)."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    q = L._heads(u, p["wq"])
    k, v = L._heads(enc_out, p["wk"]), L._heads(enc_out, p["wv"])
    core = assert_close(
        fa_mod.flash_attention_cuda(q, k, v, causal=False),
        fa_mod.flash_attention_plain(q, k, v, causal=False), TOL_BF16,
        f"{what}: K1 vs plain on its q, k, v")
    h = LM._cross_attention(cfg, p, u, enc_out)
    with mock.patch.object(ops, "flash_attention", _plain_attention(fa_mod)):
        hp = LM._cross_attention(cfg, p, u, enc_out)
    r = rel_err(h, hp)
    check(r <= REL_APP, f"{what}: block through K1 vs plain attention, "
          f"relative L2 {r} > {REL_APP}")
    return h, core, r


def hold_cross_decode(torch, cfg, p, up, enc_out, what: str):
    """A cross-attention's PROMPT_LEN decode steps on ``up`` (K1's decode
    kernel, one query against every frame, as a serve step runs it) held
    against the block over all of ``up`` (REL_LAYER_DECODE).  Returns (the
    block's output, the relative L2 error, the max abs err)."""
    from repro_torch.models import lm as LM
    hb = LM._cross_attention(cfg, p, up, enc_out)
    hd = torch.cat([LM._cross_attention(cfg, p, up[:, t:t + 1], enc_out)
                    for t in range(up.shape[1])], 1)
    r = rel_err(hd, hb)
    check(r <= REL_LAYER_DECODE, f"{what}: {up.shape[1]} decode steps vs "
          f"its prefill, relative L2 {r} > {REL_LAYER_DECODE}")
    return hb, r, max_err(hd, hb)


def encdec_layer_checks(torch, cfg, weights, frames, tokens):
    """Each attention of the encoder-decoder at full width, K1 and the
    plain attention fed the same input.  The encoder's residual stream
    walks its layers on ``frames``: each layer's attention (no mask) held
    as a dense layer's (hold_attention_block).  The decoder's stream walks
    its layers on ``tokens`` against the encoder's output: each layer's
    self-attention held so, and its cross-attention by
    hold_cross_attention.  On the prompts' stream (4 × 64, against the
    same frames) each decoder layer's self-attention (K1's decode kernel
    into a MAX_LEN cache) and cross-attention (the decode kernel against
    every frame), decoded token by token, are held against their
    prefill (REL_LAYER_DECODE)."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    eps, kw = cfg.norm_eps, LM._attn_kwargs(cfg)
    worst = dict(core=0.0, block=0.0, decode=0.0, decode_max_abs=0.0)

    def held(out):
        h, core, r = out
        worst["core"] = max(worst["core"], core)
        worst["block"] = max(worst["block"], r)
        return h

    def decoded(out):
        hb, r, m = out
        worst["decode"] = max(worst["decode"], r)
        worst["decode_max_abs"] = max(worst["decode_max_abs"], m)
        return hb

    def positions(x):
        B, S = x.shape[:2]
        return torch.arange(S, device=x.device).expand(B, S)

    e = frames
    for i in range(cfg.encoder_layers):
        lp = _layer(weights["enc_layers"], i)
        u = L.rms_norm(e, lp["ln1"], eps)
        e = e + held(hold_attention_block(
            torch, lp["attn"], u, positions(u), None, kw,
            f"encoder layer {i}", causal=False))
        e = e + L.mlp_block(lp["mlp"], L.rms_norm(e, lp["ln2"], eps),
                            cfg.mlp_type)
    enc_out = L.rms_norm(e, weights["enc_norm"], eps)
    x = weights["embed"][tokens]
    xp = weights["embed"][serve_prompts(torch, cfg)]
    for i in range(cfg.n_layers):
        lp = _layer(weights["layers"], i)
        u = L.rms_norm(x, lp["ln1"], eps)
        x = x + held(hold_attention_block(
            torch, lp["attn"], u, positions(u), None, kw,
            f"decoder layer {i} self-attention"))
        xp = xp + decoded(hold_attention_decode(
            torch, lp["attn"], L.rms_norm(xp, lp["ln1"], eps), None, kw,
            f"decoder layer {i} self-attention"))
        what = f"decoder layer {i} cross-attention"
        x = x + held(hold_cross_attention(
            torch, cfg, lp["cross"], L.rms_norm(x, lp["ln_x"], eps), enc_out,
            what))
        xp = xp + decoded(hold_cross_decode(
            torch, cfg, lp["cross"], L.rms_norm(xp, lp["ln_x"], eps),
            enc_out, what))
        x = x + L.mlp_block(lp["mlp"], L.rms_norm(x, lp["ln2"], eps),
                            cfg.mlp_type)
        xp = xp + L.mlp_block(lp["mlp"], L.rms_norm(xp, lp["ln2"], eps),
                              cfg.mlp_type)
    print(f"{cfg.name} layers: all {cfg.encoder_layers} encoder layers' "
          f"attention (unmasked, {tuple(frames.shape[:2])}) and all "
          f"{cfg.n_layers} decoder layers' self- and cross-attention "
          f"({tuple(tokens.shape)} tokens) held at full width; K1 vs plain on "
          f"each one's q, k, v max abs err {worst['core']} (tol {TOL_BF16}); "
          f"block through K1 vs plain attention relative L2 <= "
          f"{worst['block']} (limit {REL_APP}); {PROMPT_LEN} decode steps vs "
          f"prefill (self- and cross-attention) relative L2 <= "
          f"{worst['decode']} (limit {REL_LAYER_DECODE}), max abs err "
          f"{worst['decode_max_abs']}")
    return dict(encoder_layers=cfg.encoder_layers, layers=cfg.n_layers,
                core_max_abs_err=worst["core"], block_rel_err=worst["block"],
                decode_rel_err=worst["decode"],
                decode_max_abs_err=worst["decode_max_abs"])


def whisper_path(torch, K, tmp):
    """whisper-medium through K1 at head dim 64, group 1, with and without
    the causal mask: seeded frames encoded (a K1 launch an encoder layer),
    a prefill of 4 × WHISPER_TOKENS decoder tokens on the same frames, 4
    requests served with the encoder's output in their cache, decode held
    against prefill; then each attention held one by one
    (encdec_layer_checks).  Returns (K1 launches, serve record)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import KERNEL_NAMES
    from repro_torch.models import encode
    cfg = get_config(WHISPER)
    apps, dec_apps = attention_apps(cfg), attention_apps(cfg, decode=True)
    weights, ckpt = checkpoint_phase(torch, cfg, tmp)
    frames = seeded_embeds(torch, cfg, cfg.max_source_len, SEED + 4)
    extra = {"enc_embeds": frames}
    zero_counts(K)                            # the main path starts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc_out = encode(cfg, weights, frames)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    check(K["k1"].launches == cfg.encoder_layers and tuple(enc_out.shape)
          == (PREFILL_B, cfg.max_source_len, cfg.d_model)
          and bool(torch.isfinite(enc_out).all()),
          f"encode: {K['k1'].launches} K1 launches, {tuple(enc_out.shape)}")
    print(f"encode {cfg.name}: {tuple(frames.shape)} frames in "
          f"{encode_ms:.3f} ms (first call), {cfg.encoder_layers} K1 "
          f"launches")
    prefill, tokens = prefill_phase(torch, cfg, weights, K["k1"],
                                    S=WHISPER_TOKENS, extra=extra)
    serve, out = serve_phase(torch, cfg, weights, K["k1"], enc_out=enc_out,
                             prefill_extra=extra)
    # the encoder, the prefill, the served steps and the prefill of the
    # prompts that the served logits are held against
    launches = check_counts(
        K, dict(k1=cfg.encoder_layers + apps + dec_apps
                * (PROMPT_LEN + GEN_LEN) + apps), f"the {cfg.name} path")
    zero_counts(K)                            # the layer checks start
    serve["layers"] = encdec_layer_checks(torch, cfg, weights, frames,
                                          tokens)
    # each encoder layer: the kernel alone and the block; each decoder
    # layer's self- and cross-attention: the kernel alone, the block, and
    # on the prompts' stream the block and its decode steps
    check_counts(K, dict(k1=cfg.encoder_layers * 2
                         + cfg.n_layers * 2 * (2 + 1 + PROMPT_LEN)),
                 f"the {cfg.name} layer checks")
    prefill.update(encode_first_call_ms=encode_ms,
                   **k1_prefill_profile(torch, cfg, weights, tokens,
                                        KERNEL_NAMES, extra))
    serve.update(checkpoint=ckpt, prefill=prefill,
                 breakdown=decode_breakdown(torch, cfg, weights, out,
                                            KERNEL_NAMES, "K1"))
    return launches["k1"], serve


# --------------------------------------------------- the llava path --
def llava_path(torch, K, tmp):
    """llava-next-mistral-7b through K1 at head dim 128, group 4: a
    prefill of 4 × (LLAVA_PATCHES seeded patch embeddings, projected by
    mm_proj, + LLAVA_TEXT tokens), 4 requests of text served (a decode
    step never sees the image, as in the reference: the logits after the
    prompt are held against a prefill of the prompt with an empty image),
    then each layer held one by one on the prefill's image and text, as
    gemma3's.  Returns (K1 launches, serve record)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import KERNEL_NAMES
    cfg = dataclasses.replace(get_config(LLAVA), n_layers=LLAVA_SERVE_LAYERS)
    check(cfg.num_patches == LLAVA_PATCHES, f"{cfg.name}: {cfg.num_patches} "
          f"patches")
    apps = attention_apps(cfg)
    free = shutil.disk_usage(tmp).free
    check(free >= DISK_NEED, f"{tmp} has {free} B free; the {cfg.name} "
          f"checkpoint needs about {DISK_NEED:.0f} B")
    weights, ckpt = checkpoint_phase(torch, cfg, tmp)
    patches = seeded_embeds(torch, cfg, cfg.num_patches, SEED + 5)
    extra = {"patch_embeds": patches}
    zero_counts(K)                            # the main path starts
    # over 4 x 3392 positions the plain version rounds p per 512-key chunk
    # and the kernel per 64 keys; through 32 random bf16 layers the two
    # prefills' logits part past TOL_LOGITS (0.166 max abs, relative L2
    # 0.035, in a run of these phases alone), so they are reported and
    # each layer held, as gemma3's; the served steps' logits, over 64 to
    # 68 text positions, are held
    prefill, tokens = prefill_phase(torch, cfg, weights, K["k1"],
                                    hold=False, S=LLAVA_TEXT, extra=extra)
    serve, out = serve_phase(torch, cfg, weights, K["k1"], prefill_extra={
        "patch_embeds": patches[:, :0]})
    launches = check_counts(K, dict(k1=apps * (1 + 1 + PROMPT_LEN + GEN_LEN)),
                            f"the {cfg.name} path")["k1"]
    zero_counts(K)                            # the layer checks start
    x0 = torch.cat([patches @ weights["mm_proj"], weights["embed"][tokens]],
                   dim=1)
    serve["layers"] = dense_layer_checks(torch, cfg, weights, tokens, x0=x0)
    # each layer: the kernel alone and the block on the prefill's inputs,
    # the block on the prompts' and their decode steps
    check_counts(K, dict(k1=apps * (2 + 1 + PROMPT_LEN)),
                 f"the {cfg.name} layer checks")
    prefill.update(k1_prefill_profile(torch, cfg, weights, tokens,
                                      KERNEL_NAMES, extra))
    serve.update(checkpoint=ckpt, prefill=prefill,
                 breakdown=decode_breakdown(torch, cfg, weights, out,
                                            KERNEL_NAMES, "K1"))
    return launches, serve


# ------------------------------------------------------ the training path --
def checksums(torch, tree):
    """An exact checksum of every leaf: the int64 sum of its bits read as
    integers of its own width, on the device."""
    from repro_torch.checkpoint.pytree_io import flatten_named
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    names, sums = [], []
    for name, t in flatten_named(tree)[0]:
        names.append(name)
        sums.append(t.detach().view(ints[t.element_size()]).to(
            torch.int64).sum())
    return dict(zip(names, torch.stack(sums).tolist()))


def train_step0_check(torch, cfg, data, required, plain=None):
    """Step 0 of the run, computed apart from it on the same weights and
    batch: the loss and every leaf's gradient norm through the kernels.
    Every leaf must have a finite nonzero gradient norm, those in
    ``required`` included.  With ``plain`` (the name of a function of
    ``ops`` and its plain version), the same again with it patched in, and
    the loss and global gradient norm of the two held within TOL_TRAIN.
    falcon-mamba and zamba2 pass none: their random layers may decorrelate
    two rounding paths end to end, so their layers (falcon) or groups
    (zamba2) and their gradients are held one by one instead
    (train_layer_check, train_group_check).  Every call of K1's backward
    in the step, one an attention application, is held against the plain
    backward on the same q, k, v and dO, with the call's masks (a window
    as a boolean mask for SDPA): within BWD_REL_BF16, or BWD_LIB_RATIO of
    SDPA's backward's distance where that is larger."""
    from repro_torch.checkpoint.pytree_io import flatten_named
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.models import init_lm, lm
    from repro_torch.train.step import EMBEDS
    cuda = torch.device("cuda")
    params = init_lm(cfg, SEED, device=cuda)
    batch = data.sharded_batch(0, cuda)
    named = flatten_named(params)[0]
    bwd_errs = []   # each backward call's dq, dk, dv: (K1, SDPA) relative L2
    windows = []    # each backward call's window
    sdpa = sdpa_gqa(torch)

    def held_bwd(q, k, v, out, dout, lse, **kw):
        got = fa_mod.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
        want = fa_mod.flash_attention_bwd_plain(q, k, v, dout, **kw)
        check(kw["q_offset"] == 0,
              f"step 0: a backward with a query offset SDPA does not take: {kw}")
        masks = sdpa_masks(torch, q.shape[1], k.shape[1], kw["causal"],
                           kw["window"], q.device)
        with torch.enable_grad():   # autograd runs backward in no-grad mode
            qkv = [t.transpose(1, 2).detach().requires_grad_()
                   for t in (q, k, v)]
            lib = torch.autograd.grad(sdpa(*qkv, **masks), qkv,
                                      dout.transpose(1, 2))
        errs = []
        for name, g, l_, w in zip("qkv", got, lib, want):
            r, r_lib = rel_err(g, w), rel_err(l_.transpose(1, 2), w)
            check(r <= max(BWD_REL_BF16, BWD_LIB_RATIO * r_lib),
                  f"step 0, backward call {len(bwd_errs)}: d{name} relative "
                  f"L2 {r} > {BWD_REL_BF16} and > {BWD_LIB_RATIO} x SDPA's "
                  f"{r_lib}")
            errs.append((r, r_lib))
        bwd_errs.append(errs)
        windows.append(kw["window"])
        return got

    embeds = {k: batch[k] for k in EMBEDS if k in batch}

    def loss_and_norms():
        leaves = [p.requires_grad_() for _, p in named]
        loss = lm.lm_loss(cfg, params, batch["tokens"], batch["labels"],
                          loss_chunk=TRAIN_CHUNK, **embeds)
        grads = torch.autograd.grad(loss, leaves)
        norms = torch.stack([g.float().norm() for g in grads]).tolist()
        return loss.item(), norms

    with mock.patch.object(ops, "flash_attention_bwd_cuda", held_bwd):
        loss, norms = loss_and_norms()
    apps = attention_apps(cfg)
    check(len(bwd_errs) == apps, f"step 0: {len(bwd_errs)} backward calls "
          f"held, expected {apps}")
    if apps:
        print(f"train {cfg.name} step 0: K1's backward in each of the {apps} "
              f"attention applications (last first) held against the plain "
              f"f32 backward on its q, k, v, dO (limit {BWD_REL_BF16}, or "
              f"{BWD_LIB_RATIO} x SDPA's backward's distance where larger): "
              f"dq, dk, dv relative L2, K1 (SDPA) " + "; ".join(
                  ", ".join(f"{r:.3g} ({r_lib:.3g})" for r, r_lib in e)
                  + ("" if w is None else f" [window {w}]")
                  for e, w in zip(bwd_errs, windows)))
    rec = dict(loss=loss, bwd_rel_err=bwd_errs, bwd_windows=windows)
    if plain is not None:
        with mock.patch.object(ops, *plain):
            loss_plain, norms_plain = loss_and_norms()
    del params
    gnorm = sum(n * n for n in norms) ** 0.5
    by_name = {name: n for (name, _), n in zip(named, norms)}
    bad = [k_ for k_, n in by_name.items()
           if not (n > 0 and n < float("inf"))]
    check(not bad, f"step 0: zero or non-finite gradient norms: {bad}")
    for name in required:
        check(name in by_name, f"no gradient for {name}")
    held = ""
    if plain is not None:
        gnorm_plain = sum(n * n for n in norms_plain) ** 0.5
        for what, a, b in (("loss", loss, loss_plain),
                           ("global gradient norm", gnorm, gnorm_plain)):
            check(abs(a - b) <= TOL_TRAIN["atol"] + TOL_TRAIN["rtol"] * abs(b),
                  f"step 0 {what}: kernels {a} vs plain {b} beyond "
                  f"{TOL_TRAIN}")
        rec.update(loss_plain=loss_plain, grad_norm_plain=gnorm_plain)
        held = (f" (plain {plain[0]}: loss {loss_plain}, global grad norm "
                f"{gnorm_plain}; held within {TOL_TRAIN})")
    print(f"train {cfg.name} step 0 (apart from the run, same weights and "
          f"batch): loss {loss} (ln vocab {math.log(cfg.vocab):.4f}), "
          f"global grad norm {gnorm}{held}; all {len(named)} leaves have "
          f"finite nonzero gradient norms; "
          + ", ".join(f"{k_.split('/')[-1]} {by_name[k_]:.4g}"
                      for k_ in required))
    rec.update(grad_norm=gnorm, leaf_grad_norms=by_name)
    return rec


def train_layer_check(torch, cfg, K):
    """One Mamba1 layer at full width and the training shape (8 x 1024),
    bf16 compute as in the run: its output, dL/du and every parameter's
    gradient through the fused K2 and its backward against the same
    through the plain scan, on the same weights, input and output
    gradient."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss_mod
    from repro_torch.models import cast_params, init_lm
    from repro_torch.models import ssm as SSM
    cuda = torch.device("cuda")
    bf16 = torch.bfloat16
    params = init_lm(dataclasses.replace(cfg, n_layers=1), SEED, device=cuda)
    lp = cast_params(_layer(params["layers"], 0)["ssm"], bf16)
    del params
    gen = torch.Generator(device=cuda).manual_seed(SEED + 6)
    u = torch.randn((TRAIN_B, TRAIN_S, cfg.d_model), generator=gen,
                    device=cuda).to(bf16)
    dout = torch.randn(u.shape, generator=gen, device=cuda).to(bf16)

    def run():
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in lp.items()}
        uu = u.clone().requires_grad_()
        out = SSM.ssm_block(leaves, uu, cfg)
        grads = torch.autograd.grad(out, [*leaves.values(), uu], dout)
        return out.detach(), dict(zip([*leaves, "u"], grads))

    zero_counts(K)
    out, grads = run()
    check_counts(K, dict(k2_fused=1, k2_bwd=ss_mod.BWD_LAUNCHES_PER_CALL),
                 "the layer check")
    with mock.patch.object(ops, "mamba1_scan", _plain_fused(ss_mod)):
        out_p, grads_p = run()
    r_out = rel_err(out, out_p)
    check(r_out <= REL_LAYER_PLAIN, f"train layer output: relative L2 "
          f"{r_out} > {REL_LAYER_PLAIN}")
    rels = {k: rel_err(g, grads_p[k]) for k, g in grads.items()}
    for k, r in rels.items():
        check(r <= REL_LAYER_GRAD, f"train layer d{k}: relative L2 {r} > "
              f"{REL_LAYER_GRAD}")
    print(f"train {cfg.name} layer check (one layer, B{TRAIN_B} S{TRAIN_S}, "
          f"bf16), fused K2 and its backward vs the plain scan: output "
          f"relative L2 {r_out} (limit {REL_LAYER_PLAIN}); gradients (limit "
          f"{REL_LAYER_GRAD}): " + ", ".join(f"d{k} {r:.3g}"
                                             for k, r in rels.items()))
    return dict(out_rel_err=r_out, grad_rel_err=rels)


def train_group_check(torch, cfg, K):
    """One hybrid group at full width and the training shape (8 x 1024),
    bf16 compute as in the run: its ``shared_attn_every`` Mamba2 layers,
    then one application of the shared attention block, through K1 and its
    backward and through the plain attention, on the same weights, input
    and output gradient, and the same through the plain attention in f32.
    Held: the output, the gradient at the application's input and the
    shared block's gradients by REL_LAYER_GRAD; the Mamba2 layers'
    gradients and dL/du by their distance from the f32 run
    (GROUP_F32_RATIO)."""
    import contextlib
    from repro_torch.checkpoint.pytree_io import flatten_named
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.models import cast_params, init_lm
    from repro_torch.models import lm
    cuda = torch.device("cuda")
    bf16 = torch.bfloat16
    E = cfg.shared_attn_every
    params = init_lm(dataclasses.replace(cfg, n_layers=E), SEED, device=cuda)
    group = {"layers": params["layers"], "shared_attn": params["shared_attn"]}
    del params
    gen = torch.Generator(device=cuda).manual_seed(SEED + 7)
    u = torch.randn((TRAIN_B, TRAIN_S, cfg.d_model), generator=gen,
                    device=cuda)
    dout = torch.randn(u.shape, generator=gen, device=cuda)

    def run(dtype, plain):
        named, rebuild = flatten_named(cast_params(group, dtype))
        leaves = [t.detach().clone().requires_grad_() for _, t in named]
        tree = rebuild(leaves)
        uu = u.to(dtype).requires_grad_()
        with (mock.patch.object(ops, "flash_attention",
                                _plain_attention(fa_mod))
              if plain else contextlib.nullcontext()):
            x = uu   # the layers, then the application on their output
            for lp in lm._unstack(tree["layers"], E):
                x, _ = lm._layer(cfg, lp, x, None, 512)
            out = lm._hybrid_group(cfg, [], tree["shared_attn"], x, 512)
            grads = torch.autograd.grad(out, [*leaves, uu, x],
                                        dout.to(dtype))
        return out.detach(), dict(zip([n for n, _ in named] + ["u", "x6"],
                                      grads))

    zero_counts(K)
    out, grads = run(bf16, plain=False)
    check_counts(K, dict(k1=1, k1_bwd=fa_mod.BWD_LAUNCHES_PER_CALL),
                 "the group check")
    out_p, grads_p = run(bf16, plain=True)
    out_f, grads_f = run(torch.float32, plain=True)
    r_out = rel_err(out, out_p)
    check(r_out <= REL_LAYER_GRAD, f"train group output: relative L2 "
          f"{r_out} > {REL_LAYER_GRAD}")
    rels = {k: (rel_err(g, grads_p[k]), rel_err(g, grads_f[k]),
                rel_err(grads_p[k], grads_f[k])) for k, g in grads.items()}
    direct = [k for k in rels if k == "x6" or k.startswith("shared_attn/")]
    check(len(direct) > 1, "the group check holds no gradient of the "
          "shared block")
    for k, (r, r_kf, r_pf) in rels.items():
        if k in direct:
            check(r <= REL_LAYER_GRAD, f"train group d{k}: relative L2 {r} "
                  f"> {REL_LAYER_GRAD}")
        else:
            check(r_kf <= GROUP_F32_RATIO * r_pf, f"train group d{k}: the "
                  f"kernel path's relative L2 from f32 {r_kf} > "
                  f"{GROUP_F32_RATIO} x the plain path's {r_pf}")
    print(f"train {cfg.name} group check ({E} Mamba2 layers and one "
          f"application, B{TRAIN_B} S{TRAIN_S}, bf16), K1 and its backward "
          f"vs the plain attention: output relative L2 {r_out} (limit "
          f"{REL_LAYER_GRAD}; either from f32 {rel_err(out, out_f):.3g}); "
          f"gradients, relative L2 K1 vs plain (K1 from f32, plain from "
          f"f32): " + ", ".join(f"d{k} {r:.3g} ({r_kf:.3g}, {r_pf:.3g})"
                                for k, (r, r_kf, r_pf) in rels.items())
          + f"; held: d{', d'.join(direct)} within {REL_LAYER_GRAD}, the "
          f"rest from f32 within {GROUP_F32_RATIO} x the plain path's")
    return dict(out_rel_err=r_out, grad_rel_err=rels)


def training_data(torch, cfg, B, S):
    """A training path's batches: the synthetic tokens, B x S a step, and
    for an encdec or vlm model seeded random frame or patch embeddings
    made on the card for each step (its frontend is a stub, and the
    token pipeline, as the reference's, yields tokens alone)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                          seed=SEED)
    extra = {"encdec": ("enc_embeds", cfg.max_source_len),
             "vlm": ("patch_embeds", cfg.num_patches)}.get(cfg.family)
    if extra is None:
        return SyntheticTokens(data_cfg)
    key, n = extra

    class WithEmbeds(SyntheticTokens):
        def sharded_batch(self, step, device):
            batch = super().sharded_batch(step, device)
            gen = torch.Generator(device=device).manual_seed(
                SEED * 1000 + step)
            batch[key] = torch.randn((B, n, cfg.d_model), generator=gen,
                                     device=device)
            return batch
    return WithEmbeds(data_cfg)


def train_flops(cfg, B, S):
    """One training step's FLOPs (forward and backward, no remat) on B
    sequences of S tokens, and the formula's text.  Attention counts
    6 H D per (query, key) pair of a causal layer, whose pairs are half of
    S^2, and 12 H D per pair of an unmasked one.  An encdec step runs its
    encoder (and its decoder's cross-attention keys and values) over the
    frames, the rest of the decoder over the tokens; a vlm step runs its
    layers over the image and the text, mm_proj over the image and the
    head over the text alone."""
    H, D, L = cfg.n_heads, cfg.head_dim_, cfg.n_layers
    if cfg.family not in ("encdec", "vlm"):
        return (B * S * (6 * cfg.active_param_count()
                         + 6 * attention_apps(cfg) * H * D * S),
                "(6 N + 6 A H D S) x tokens, N the active parameters (an "
                "MoE token's top-k experts, not the capacity buffers' "
                "slack), A the attention applications a step (the layers "
                "of a dense or MoE model, a hybrid's groups, none in "
                "Mamba1)")
    from repro_torch.models import init_lm, param_bytes
    meta = init_lm(cfg, device="meta")

    def n(tree):   # parameters of a subtree (f32 leaves)
        return param_bytes(tree) // 4
    if cfg.family == "vlm":
        P = cfg.num_patches
        return (B * (6 * n(meta["layers"]) * (P + S)
                     + 6 * n(meta["mm_proj"]) * P + 6 * n(meta["lm_head"]) * S
                     + 6 * L * H * D * (P + S) ** 2),
                "B (6 N_layers (P + S) + 6 N_mm_proj P + 6 N_head S + 6 L H "
                "D (P + S)^2), P image positions, S text tokens (the "
                "embedding gather not counted)")
    F = cfg.max_source_len
    cross = meta["layers"]["cross"]
    n_enc = (n(meta["enc_layers"]) + n(meta["enc_norm"]) + n(cross["wk"])
             + n(cross["wv"]))
    return (B * (6 * n_enc * F + 6 * (n(meta) - n_enc) * S
                 + 12 * cfg.encoder_layers * H * D * F * F
                 + 6 * L * H * D * S * S + 12 * L * H * D * S * F),
            "B (6 N_enc F + 6 N_dec S + 12 L_enc H D F^2 + 6 L H D S^2 + 12 "
            "L H D S F), F frames, S tokens, N_enc the encoder's and the "
            "cross-attention's key and value projections, N_dec the rest "
            "(the tied embedding as the head)")


def train_run(torch, cfg, loop, opt, spies, hooks, data):
    """One ``repro_torch.train.loop.train`` call on the card, on ``data``'s
    batches, with the checkpoint manager's snapshot, background write and
    restore timed."""
    from repro_torch.checkpoint import manager as mgr_mod
    from repro_torch.train.loop import train
    real_snapshot = mgr_mod.snapshot_to_host
    real_write = mgr_mod.CheckpointManager._write_and_commit
    real_restore = mgr_mod.CheckpointManager.restore_or_init

    def snapshot(tree, pinned=None):
        t0 = time.perf_counter()
        out = real_snapshot(tree, pinned)
        spies["snapshot_s"].append(time.perf_counter() - t0)
        return out

    def write(self, step, host_tree, aux_extra, use_delta=False):
        t0 = time.perf_counter()
        real_write(self, step, host_tree, aux_extra, use_delta)
        spies["write_s"].append(time.perf_counter() - t0)
        spies["file_bytes"].append(ckpt_bytes(self.path_for(step)))

    def restore_or_init(self, init_fn, like=None, *, device=None):
        t0 = time.perf_counter()
        tree, step = real_restore(self, init_fn, like, device=device)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if step >= 0:
            spies["restored"] = dict(
                step=step, s=dt, sums=checksums(torch, tree),
                file_bytes=ckpt_bytes(self.path_for(step)))
        spies["t_mark"] = time.perf_counter()
        return tree, step

    with mock.patch.object(mgr_mod, "snapshot_to_host", snapshot), \
            mock.patch.object(mgr_mod.CheckpointManager, "_write_and_commit",
                              write), \
            mock.patch.object(mgr_mod.CheckpointManager, "restore_or_init",
                              restore_or_init):
        return train(cfg, loop, opt, data=data, hooks=hooks, device="cuda")


def train_profile(torch, cfg, state, opt, data, parts, split=None):
    """One more step on the final state under the profiler: device busy
    time, idle share, each kernel's share (``parts``: label -> kernel
    names; ``split``: label -> one kernel of a part, printed apart), the
    matmuls, the heaviest kernels."""
    from repro_torch.train.step import make_train_step
    step_fn = make_train_step(cfg, opt, loss_chunk=TRAIN_CHUNK)
    batch = data.sharded_batch(TRAIN_STEPS, torch.device("cuda"))
    prof_rows, wall = profiled(
        torch, lambda: step_fn(state["params"], state["opt"], batch))
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof_rows), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)

    def share(names):
        mine = [r for r in rows if any(n in r[0] for n in names)]
        return sum(r[1] for r in mine), sum(r[2] for r in mine)

    shares = {label: share(names) for label, names in parts.items()}
    gemm_ms, _ = share(("gemm", "nvjet", "xmma", "cutlass", "sm90_"))
    rest = busy - sum(ms for ms, _ in shares.values()) - gemm_ms
    print(f"train {cfg.name} step breakdown (profiled, 1 step): wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms (idle share "
          f"{1 - busy / wall:.4f}); " + ", ".join(
              f"{label} {ms:.3f} ms in {n} launches ({ms / busy:.4f} of busy)"
              for label, (ms, n) in shares.items())
          + f", matmuls {gemm_ms:.3f} ms ({gemm_ms / busy:.4f}), the rest "
          f"{rest:.3f} ms")
    rec = dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
               parts={label: dict(ms=ms, launches=n)
                      for label, (ms, n) in shares.items()},
               gemm_ms=gemm_ms, other_ms=rest,
               top=[dict(kernel=r[0][:120], ms=r[1], calls=r[2])
                    for r in rows[:10]])
    if split:
        got = {label: share((name,)) for label, name in split.items()}
        print("  by kernel: " + "; ".join(
            f"{label} {ms:.3f} ms in {n} launches"
            for label, (ms, n) in got.items()))
        rec["split"] = {label: ms for label, (ms, _) in got.items()}
    for name, ms, n in rows[:10]:
        print(f"  {ms:.4f} ms  x{n}  {name[:90]}")
    return rec


def train_path(torch, cfg, K, per_step, parts, tmp, *, required, plain=None,
               split=None, part_check=None, B=TRAIN_B, S=TRAIN_S,
               sets=False):
    """``cfg`` trained at full width through ``train()`` on B x S tokens a
    step: run 1 dies after step 3's save commits, run 2 resumes from it
    bit-exactly and finishes steps 4 and 5 with a blocking save.
    ``per_step``: each kernel's launches a step (every other kernel
    launches none); ``required`` and ``plain``: train_step0_check's;
    ``part_check``: a check of one layer or group run before them
    (train_layer_check, train_group_check).  With ``sets`` both runs save
    parity-protected sets and deltas (SET_KNOBS): run 1's set loses a
    shard before run 2 (lost_shard_check), and step 5 is a delta of step
    3 (delta_chain_check).  Returns (launches of each kernel on the path,
    record)."""
    import statistics
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainLoopConfig
    # f32 master weights and two f32 moments: 12 B a parameter in a state
    # file, and while the final save commits two of them are on disk (as
    # sets, each with its parity: SET_PARITY / SET_SHARDS more)
    need = 2.2 * 12 * cfg.param_count() * (
        1 + SET_PARITY / SET_SHARDS if sets else 1)
    free = shutil.disk_usage(tmp).free
    check(free >= need, f"{tmp} has {free} B free; two state checkpoints "
          f"of {cfg.name} ({cfg.n_layers} layers) need about {need:.0f} B")
    data = training_data(torch, cfg, B, S)
    rec = dict(layers=cfg.n_layers)
    if part_check is not None:
        phase(f"{cfg.name} {part_check.__name__}")
        rec[part_check.__name__] = part_check(torch, cfg, K)
        gc.collect()
        torch.cuda.empty_cache()
    phase(f"{cfg.name} step 0 apart")
    rec["step0"] = train_step0_check(torch, cfg, data, required, plain)
    gc.collect()
    torch.cuda.empty_cache()

    ckpt_dir = os.path.join(tmp, f"train-{cfg.name}")
    loop = TrainLoopConfig(total_steps=TRAIN_STEPS,
                           ckpt_every=TRAIN_CKPT_EVERY, ckpt_dir=ckpt_dir,
                           ckpt_keep=1, log_every=1, seed=SEED)
    opt = AdamWConfig(**TRAIN_OPT)
    spies = dict(snapshot_s=[], write_s=[], file_bytes=[])
    steps = {}   # step -> (loss, seconds since the previous mark, counts)
    at_die = {}

    def on_step(step, state, metrics):
        now = time.perf_counter()
        steps[step] = (float(metrics["loss"]), now - spies["t_mark"],
                       counts(K))
        spies["t_mark"] = now
        if step == TRAIN_DIE_AT:
            at_die.update(checksums(torch, state))

    hooks = dict(on_step=on_step, should_die=lambda s: s == TRAIN_DIE_AT)
    torch.cuda.reset_peak_memory_stats()
    # the reference launcher's layout knobs, read by the manager
    with mock.patch.dict(os.environ, SET_KNOBS if sets else {}):
        phase(f"{cfg.name} run 1")
        zero_counts(K)                                   # the main path starts
        died = False
        try:
            train_run(torch, cfg, loop, opt, spies, hooks, data)
        except SystemExit as e:
            died = str(e) == f"injected failure at step {TRAIN_DIE_AT}"
        check(died, f"run 1 did not die at step {TRAIN_DIE_AT}")
        gc.collect()   # run 1's manager and state
        run1_files = sorted(os.listdir(ckpt_dir))
        check(f"step_{TRAIN_DIE_AT:010d}.scda" in run1_files,
              f"run 1 left {run1_files}")
        if sets:
            phase(f"{cfg.name} set without a shard")
            rec["lost_shard"] = lost_shard_check(torch, cfg, ckpt_dir, at_die)
            gc.collect()
            torch.cuda.empty_cache()
        phase(f"{cfg.name} run 2")
        out = train_run(torch, cfg, loop, opt, spies, dict(on_step=on_step),
                        data)
    want = {name: TRAIN_STEPS * per_step.get(name, 0) for name in K}
    launches = check_counts(K, want, f"the {cfg.name} training path")  # ends
    peak = torch.cuda.max_memory_allocated()
    out["manager"].close()

    check(out["start_step"] == TRAIN_DIE_AT, f"run 2 started at "
          f"{out['start_step']}, expected {TRAIN_DIE_AT}")
    restored = spies["restored"]
    check(restored["step"] == TRAIN_DIE_AT and restored["sums"] == at_die,
          "the restored state is not bit-equal to step 3's")
    check(sorted(steps) == list(range(TRAIN_STEPS)), f"steps {sorted(steps)}")
    losses = [steps[i][0] for i in range(TRAIN_STEPS)]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(abs(losses[0] - math.log(cfg.vocab)) <= 1.5,
          f"step 0 loss {losses[0]} is not within 1.5 of ln vocab")
    check(abs(losses[0] - rec["step0"]["loss"]) <= 1e-3,
          f"run's step 0 loss {losses[0]} vs the step apart "
          f"{rec['step0']['loss']}")
    prev = {name: 0 for name in K}
    for i in range(TRAIN_STEPS):   # a restore launches no kernel
        got = {name: steps[i][2][name] - prev[name] for name in K}
        check(got == {name: per_step.get(name, 0) for name in K},
              f"step {i} launched {got}, expected {per_step}")
        prev = steps[i][2]
    final = sorted(os.listdir(ckpt_dir))
    check(f"step_{TRAIN_STEPS - 1:010d}.scda" in final
          and (sets or f"step_{TRAIN_DIE_AT:010d}.scda" not in final),
          f"after the final save: {final}")
    if sets:
        phase(f"{cfg.name} step {TRAIN_STEPS - 1} through its chain")
        rec["delta"] = delta_chain_check(torch, cfg, ckpt_dir, out["state"])
        gc.collect()
        torch.cuda.empty_cache()

    # times: steps 1 to 5 (step 0 is the first call; no step's interval
    # holds a save: step 3's comes after its on_step)
    step_s = statistics.median(steps[i][1] for i in range(1, TRAIN_STEPS))
    tokens = B * S
    n_params = cfg.active_param_count()   # param_count() outside moe
    flops, formula = train_flops(cfg, B, S)
    mfu = flops / step_s / PEAK_BF16_FLOPS
    state_bytes = spies["file_bytes"][0]
    snap_s, write_s = spies["snapshot_s"], spies["write_s"]
    rec.update(
        losses=losses, step_s=[steps[i][1] for i in range(TRAIN_STEPS)],
        step_median_s=step_s, tokens_per_s=tokens / step_s, train_mfu=mfu,
        mfu_formula=f"{formula} / step time / 989e12, no remat counted",
        train_flops=flops, batch=B, seq_len=S,
        params=n_params, launches_per_step=per_step,
        snapshot_s=snap_s, write_s=write_s, file_bytes=spies["file_bytes"],
        write_mb_s=[b / s / 1e6 for b, s in zip(spies["file_bytes"],
                                                 write_s)],
        restore_s=restored["s"],
        restore_mb_s=restored["file_bytes"] / restored["s"] / 1e6,
        peak_bytes=peak)
    print(f"train {cfg.name} ({cfg.n_layers} layers): B{B} S{S} "
          f"loss_chunk {TRAIN_CHUNK}, {TRAIN_STEPS} steps in two runs; "
          f"losses {losses}; step time median {step_s * 1e3:.3f} ms over "
          f"steps 1-5 (all: {[round(s * 1e3, 3) for s in rec['step_s']]} "
          f"ms), {tokens / step_s:.1f} tokens/s, train_mfu {mfu:.4f} "
          f"({rec['mfu_formula']}, N {n_params}); launches per step "
          f"{per_step}; peak memory {peak} B")
    print(f"train {cfg.name} checkpoints: state file {state_bytes} B; "
          f"snapshot (sync) {snap_s} s; background write {write_s} s "
          f"({[round(x, 1) for x in rec['write_mb_s']]} MB/s); restore "
          f"{restored['s']:.3f} s ({rec['restore_mb_s']:.1f} MB/s); resumed "
          f"at step {out['start_step']}, {len(at_die)} leaves bit-equal")
    phase(f"{cfg.name} profiled step")
    rec["profile"] = train_profile(torch, cfg, out["state"], opt, data,
                                   parts, split)
    del out
    gc.collect()   # the state, the manager and its pinned host buffers
    torch.cuda.empty_cache()
    release_pinned_cache(torch)
    rec["host_peak_rss_bytes"] = peak_rss_bytes()
    print(f"train {cfg.name}: peak host RSS of the process so far "
          f"{rec['host_peak_rss_bytes']} B")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return launches, rec


def release_pinned_cache(torch) -> None:
    """Hand the pinned host blocks that PyTorch's caching host allocator
    keeps after their tensors are freed back to the system, as a new
    process would start: each training path snapshots its state into
    pinned buffers of its own sizes (each rounded up to a power of two),
    and a later path's restore reads its whole state into host memory."""
    for owner, name in ((torch.accelerator, "empty_host_cache"),
                        (torch._C, "_host_emptyCache")):
        if hasattr(owner, name):
            getattr(owner, name)()
            return
    fail("this PyTorch has no call that empties the pinned host cache")


def peak_rss_bytes() -> int:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def kernel_entry(name, source, replaces, names, launches, records, path,
                 extra=()):
    """One kernel's entry of the ``kernels`` line: the contract's keys from
    its first (main-path) record, then ``extra`` keys of that record."""
    head = records[0]
    return dict(
        name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/"
        f"{source}", replaces=replaces, kernel_names=list(names),
        launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in records), ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        **{key: head[key] for key in extra}, shapes=records, path=path)


# ------------------------------------------------------------ the dry-run --
#: The production cell the dry-run phase traces on the card's PyTorch.
DRYRUN_CELL = (QWEN, "decode_32k")
#: A predicted peak must be within this share of the measured one.
DRYRUN_HOLD = 0.15
#: The dry-run phase's own time (its predictions come from a subprocess
#: started at the run's beginning, beside the kernel checks), seconds.
DRYRUN_PHASE_S = 20.0


def dryrun_start():
    """Start ``chip_smoke.py --dryrun-predict`` in a subprocess that sees no
    GPU (the dry-run touches none, and its ``fake`` process group must not
    share a process with the distributed phase's ranks).  Returns (the
    process, its output file, its start time)."""
    out = tempfile.NamedTemporaryFile("w+", prefix="repro-dryrun-",
                                      suffix=".log", delete=False)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")] + [x for x in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if x]))
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--dryrun-predict"], stdout=out,
                            stderr=subprocess.STDOUT, env=env)
    return proc, out, time.perf_counter()


def dryrun_predict() -> int:
    """The ``--dryrun-predict`` subprocess: trace, on ``meta`` tensors on
    the host, the windows the run measures on the card, and one
    production cell, and print them as a line ``DRYRUN {json}``: qwen3's
    prefill of PREFILL_B x PREFILL_S at full depth, its serve loop (the
    serve phase's ``generate`` with its clones of 5 steps' logits), one
    training step at QWEN_TRAIN_LAYERS on TRAIN_B x TRAIN_S tokens (f32
    master weights, AdamW, remat), and ``trace_cell`` of DRYRUN_CELL on
    16 x 16."""
    os.nice(10)   # the run's own phases first where the cores are busy
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.analysis import costs
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as sp
    from repro_torch.optim.adamw import AdamWConfig, init, leaves
    from repro_torch.serve import generate
    from repro_torch.train.step import make_prefill_step, make_train_step
    cfg = get_config(QWEN)
    meta = dict(dtype=torch.int32, device="meta")
    out = {}

    def window(name, state, fn, *args, **kw):
        t0 = time.perf_counter()
        _, c = costs.count(fn, *args, **kw)
        held = costs.state_bytes(state, costs.ALLOC_ROUND)
        out[name] = dict(peak_bytes=held + c.temp_peak_bytes
                         + c.cublas_bytes, state_bytes=held,
                         step_bytes=c.temp_peak_bytes,
                         cublas_bytes=c.cublas_bytes,
                         flops=c.flops, kernel_calls=c.kernel_calls,
                         trace_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    params = sp.abstract_params(cfg, None, torch.bfloat16)
    tokens = torch.empty((PREFILL_B, PREFILL_S), **meta)
    window("prefill", leaves(params) + [tokens], make_prefill_step(cfg),
           params, {"tokens": tokens})
    prompts = torch.empty((SERVE_B, PROMPT_LEN), **meta)
    kept = {}

    def on_step(i, logits):   # serve_phase's
        if PROMPT_LEN - 1 <= i < PROMPT_LEN + 4:
            kept[i] = logits.clone()
    window("serve", leaves(params) + [prompts], generate, cfg, params,
           prompts, GEN_LEN, max_len=MAX_LEN, on_step=on_step)
    del params, kept
    small = dataclasses.replace(cfg, n_layers=QWEN_TRAIN_LAYERS)
    params = sp.abstract_params(small, None)
    opt = init(params)
    batch = {k: torch.empty((TRAIN_B, TRAIN_S), **meta)
             for k in ("tokens", "labels")}
    step = make_train_step(small, AdamWConfig(**TRAIN_OPT),
                           loss_chunk=TRAIN_CHUNK)
    window("train", leaves(params) + leaves(opt.mu) + leaves(opt.nu)
           + [opt.count] + list(batch.values()), step, params, opt, batch)
    out["cell"] = dryrun.trace_cell(*DRYRUN_CELL, False)
    out["torch"] = torch.__version__
    out["predict_s"] = time.perf_counter() - t0
    print("DRYRUN " + json.dumps(out))
    return 0


def train_window(torch):
    """One training step of qwen3 at QWEN_TRAIN_LAYERS on the card, as
    ``train_path``'s steps run (fresh f32 weights and AdamW state, a batch
    of TRAIN_B x TRAIN_S, TRAIN_OPT, loss chunk TRAIN_CHUNK), the peak
    memory of the step alone.  Returns (peak, allocated at its start)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.optim.adamw import AdamWConfig, init
    from repro_torch.train.step import make_train_step
    cfg = dataclasses.replace(get_config(QWEN), n_layers=QWEN_TRAIN_LAYERS)
    cuda = torch.device("cuda")
    params = init_lm(cfg, SEED, device=cuda)
    opt = init(params)
    batch = training_data(torch, cfg, TRAIN_B, TRAIN_S).sharded_batch(0, cuda)
    step = make_train_step(cfg, AdamWConfig(**TRAIN_OPT),
                           loss_chunk=TRAIN_CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    _, _, metrics = step(params, opt, batch)
    check(math.isfinite(float(metrics["loss"])), "the window's step loss")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del params, opt, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return peak, start


def dryrun_phase(torch, started, prefill, serve):
    """The dry-run's predictions held against this run's measurements:
    qwen3's prefill and serve-loop peaks (``prefill`` and ``serve``, the
    records of prefill_phase and serve_phase) and one training step's
    (:func:`train_window`) each within DRYRUN_HOLD of the
    ``max_memory_allocated`` of its window; a training step's counted
    FLOPs printed beside ``train_flops`` (not held: the count includes
    remat's recompute and K1's attended pairs); the production cell's
    record printed.  The phase (the wait for the subprocess, the training
    window and the holds) must take DRYRUN_PHASE_S or less."""
    proc, log, t_started = started
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log.seek(0)
    text = log.read()
    log.close()
    os.unlink(log.name)
    lines = [x for x in text.splitlines() if x.startswith("DRYRUN ")]
    check(rc == 0 and len(lines) == 1,
          f"the dry-run subprocess ended with {rc}:\n{text[-3000:]}")
    pred = json.loads(lines[0][len("DRYRUN "):])
    waited = time.perf_counter() - t0
    print(f"dry-run subprocess (PyTorch {pred['torch']}, no GPU): "
          f"{time.perf_counter() - t_started:.3f} s since it started beside "
          f"the kernel checks, its traces {pred['predict_s']:.3f} s; the "
          f"phase waited {waited:.3f} s for it")
    from repro_torch.analysis import costs
    cap = torch.cuda.get_device_properties(0).total_memory
    print(f"the card's total_memory {cap} B; the dry-run's capacity "
          f"(costs.HBM_BYTES) {costs.HBM_BYTES} B")
    train_peak, train_start = train_window(torch)
    measured = {"prefill": (prefill["peak_bytes"], prefill["start_bytes"]),
                "serve": (serve["peak_bytes"], serve["start_bytes"]),
                "train": (train_peak, train_start)}
    print(smi_line())
    worst = 0.0
    for name, (peak, start) in measured.items():
        p = pred[name]
        err = (p["peak_bytes"] - peak) / peak
        worst = max(worst, abs(err))
        print(f"dry-run {QWEN} {name}: predicted peak {p['peak_bytes']} B "
              f"(state {p['state_bytes']} + step {p['step_bytes']} + cuBLAS "
              f"{p['cublas_bytes']}; traced "
              f"in {p['trace_s']:.3f} s, kernels {p['kernel_calls']}), "
              f"measured max_memory_allocated {peak} B (allocated at the "
              f"window's start {start} B): {100 * err:+.2f} %")
    for name, (peak, _) in measured.items():
        p = pred[name]["peak_bytes"]
        check(abs(p - peak) <= DRYRUN_HOLD * peak,
              f"dry-run {name}: predicted peak {p} B is not within "
              f"{DRYRUN_HOLD:.0%} of the measured {peak} B")
    from repro_torch.configs import get_config
    small = dataclasses.replace(get_config(QWEN), n_layers=QWEN_TRAIN_LAYERS)
    flops, _ = train_flops(small, TRAIN_B, TRAIN_S)
    counted = pred["train"]["flops"]
    print(f"dry-run {QWEN} train step ({QWEN_TRAIN_LAYERS} layers, B{TRAIN_B} "
          f"S{TRAIN_S}): counted {counted:.0f} FLOP (matmuls and the "
          f"kernels' formulas, remat's recompute included) vs train_flops "
          f"{flops} (no remat, causal pairs as S^2/2): ratio "
          f"{counted / flops:.4f} (printed, not held)")
    cell = pred["cell"]
    print(f"dry-run production cell {' x '.join(DRYRUN_CELL)} on "
          f"{'x'.join(map(str, cell['mesh']))} ({cell['predicted']}): "
          + json.dumps(cell))
    dt = time.perf_counter() - t0
    print(f"dry-run phase: {dt:.3f} s (limit {DRYRUN_PHASE_S}); worst peak "
          f"error {100 * worst:.2f} % (hold {DRYRUN_HOLD:.0%})")
    check(dt <= DRYRUN_PHASE_S, f"the dry-run phase took {dt:.3f} s, over "
          f"{DRYRUN_PHASE_S} s")
    return dict(predicted=pred, measured=measured, phase_s=dt,
                worst_peak_error=worst)


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--kernels-only", action="store_true",
        help="build the kernels and run their checks and timings, then stop "
             "before the model paths (prints no result line)")
    parser.add_argument(
        "--mesh-only", action="store_true",
        help="build the kernels, check the decode kernel's log-sum-exp, "
             "then run qwen3's checkpoint and distributed phases with the "
             "mesh parts, and stop (prints no result line)")
    parser.add_argument(
        "--dryrun-only", action="store_true",
        help="build the kernels, run qwen3's prefill and serve windows on "
             "random weights and the dry-run phase, and stop (prints no "
             "result line)")
    parser.add_argument(
        "--tools-only", action="store_true",
        help="build the kernels, run qwen3's checkpoint and set phases with "
             "the scdatool phase, and stop (prints no result line)")
    parser.add_argument("--dryrun-predict", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.dryrun_predict:   # the dry-run phase's subprocess: no GPU
        return dryrun_predict()
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from the root of a repro checkout "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke test runs only on a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi_line())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    sys.stdout.flush()
    dryrun = dryrun_start()
    try:
        return run(torch, args, dryrun)
    finally:
        if dryrun[0].poll() is None:
            dryrun[0].kill()
            dryrun[0].wait()


def run(torch, args, dryrun) -> int:
    """The run after the GPU check: kernels, paths, the result lines."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss
    t0 = time.perf_counter()
    sources = [fa.SOURCE, fa.BWD_SOURCE, ss.SOURCE, ss.SOURCE_BWD]
    build.load_all(sources)
    print(f"built {', '.join(sources)} in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    spills = []
    for source in sources:
        for line in ptxas_summary(build.build_report(source)[1]):
            print(f"  ptxas {source}: {line}")
            if source in (ss.SOURCE, ss.SOURCE_BWD) and (
                    "ssm_scan_fused_kernel" in line
                    or "ssm_scan_bwd_kernel" in line) and (
                    "0 bytes spill stores, 0 bytes spill loads" not in line):
                spills.append(line.split(":")[0])
    print(f"ptxas spills in the fused K2 forward and K2 backward kernels: "
          f"{spills or 'none'}")
    print_prefill_occupancy(build.build_report(fa.SOURCE)[1])
    sys.stdout.flush()

    if args.tools_only:
        tmp = tempfile.mkdtemp(prefix="repro-torch-smoke-")
        try:
            with torch.inference_mode():
                cfg = get_config(QWEN)
                weights, _ = checkpoint_phase(torch, cfg, tmp)
                phase(f"{QWEN} weights as a set")
                weights_set_phase(torch, cfg, weights, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print("--tools-only: the other paths were not run")
        return 0
    phase("kernel checks")
    lse_records = decode_lse_checks(torch, fa)
    if args.mesh_only:
        tmp = tempfile.mkdtemp(prefix="repro-torch-smoke-")
        try:
            with torch.inference_mode():
                cfg = get_config(QWEN)
                weights, ckpt = checkpoint_phase(torch, cfg, tmp, keep=True)
                phase(f"{QWEN} distributed checkpoints and mesh parts")
                dist_checkpoint_phase(torch, cfg, ckpt["weight_bytes"],
                                      ckpt["path"], tmp, weights)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print("--mesh-only: the other paths were not run")
        return 0
    if args.dryrun_only:
        from repro_torch.models import init_lm
        cfg = get_config(QWEN)
        with torch.inference_mode():
            weights = init_lm(cfg, SEED, device="cuda", dtype=torch.bfloat16)
            prefill = prefill_phase(torch, cfg, weights,
                                    fa.flash_attention_cuda)[0]
            serve = serve_phase(torch, cfg, weights,
                                fa.flash_attention_cuda)[0]
            del weights
        gc.collect()
        torch.cuda.empty_cache()
        phase("dry-run")
        dryrun_phase(torch, dryrun, prefill, serve)
        print("--dryrun-only: the other paths were not run")
        return 0
    k1_records = kernel_checks(torch, fa)
    falcon = get_config(FALCON)
    k2_records = scan_checks(torch, ss, falcon)
    fused_records = fused_scan_checks(torch, ss, falcon)
    k2b_records = scan_bwd_checks(torch, ss, ops, falcon)
    bwd_records = bwd_checks(torch, fa)
    if args.kernels_only:
        print("kernel checks passed; --kernels-only: the model paths were "
              "not run")
        return 0

    K = dict(k1=fa.flash_attention_cuda, k1_bwd=fa.flash_attention_bwd_cuda,
             k2=ss.ssm_scan_cuda, k2_fused=ss.ssm_scan_fused_cuda,
             k2_bwd=ss.ssm_scan_bwd_cuda)
    qwen = dataclasses.replace(get_config(QWEN), n_layers=QWEN_TRAIN_LAYERS)
    falcon_train = dataclasses.replace(falcon, n_layers=FALCON_TRAIN_LAYERS)
    tmp = tempfile.mkdtemp(prefix="repro-torch-smoke-")
    try:
        with torch.inference_mode():
            phase(f"{QWEN} serve path")
            k1_launches, qwen_serve = qwen_path(torch, K, tmp)
            gc.collect()
            torch.cuda.empty_cache()   # qwen3's weights and cache are gone
            print(f"device memory allocated before {FALCON}: "
                  f"{torch.cuda.memory_allocated()} B")
            phase(f"{FALCON} serve path")
            fused_launches, k2_launches, falcon_serve = falcon_path(
                torch, K, tmp)
            gc.collect()
            torch.cuda.empty_cache()   # falcon's weights are gone
            print(f"device memory allocated before {ZAMBA}: "
                  f"{torch.cuda.memory_allocated()} B")
            phase(f"{ZAMBA} serve path")
            zamba_launches, zamba_serve = zamba_path(torch, K, tmp)
            gc.collect()
            torch.cuda.empty_cache()   # zamba2's weights are gone
            print(f"device memory allocated before {GEMMA}: "
                  f"{torch.cuda.memory_allocated()} B")
            phase(f"{GEMMA} serve path")
            gemma_launches, gemma_serve = gemma_path(torch, K, tmp)
            gc.collect()
            torch.cuda.empty_cache()   # gemma3's weights are gone
            print(f"device memory allocated before {GRANITE}: "
                  f"{torch.cuda.memory_allocated()} B")
            phase(f"{GRANITE} serve path")
            granite_launches, granite_serve = granite_path(torch, K, tmp)
            gc.collect()
            torch.cuda.empty_cache()   # granite's weights are gone
            print(f"device memory allocated before {WHISPER}: "
                  f"{torch.cuda.memory_allocated()} B")
            phase(f"{WHISPER} serve path")
            whisper_launches, whisper_serve = whisper_path(torch, K, tmp)
            gc.collect()
            torch.cuda.empty_cache()   # whisper's weights are gone
            print(f"device memory allocated before {LLAVA}: "
                  f"{torch.cuda.memory_allocated()} B")
            phase(f"{LLAVA} serve path")
            llava_launches, llava_serve = llava_path(torch, K, tmp)
        gc.collect()
        torch.cuda.empty_cache()   # llava's weights are gone
        phase(f"dry-run ({QWEN}'s windows, {' x '.join(DRYRUN_CELL)})")
        dryrun_phase(torch, dryrun, qwen_serve["prefill"],
                     qwen_serve)
        print(f"device memory allocated before training: "
              f"{torch.cuda.memory_allocated()} B")
        phase(f"{QWEN} training path ({QWEN_TRAIN_LAYERS} layers)")
        L = qwen.n_layers
        qwen_train_launches, qwen_train = train_path(
            torch, qwen, K, dict(k1=2 * L, k1_bwd=fa.BWD_LAUNCHES_PER_CALL * L),
            {"K1 forward": fa.KERNEL_NAMES, "K1 backward": fa.BWD_KERNEL_NAMES},
            tmp, required=[f"layers/attn/{part}" for part in
                           ("wq", "wk", "wv", "q_norm", "k_norm")],
            plain=("flash_attention", _plain_attention(fa)), split=BWD_PARTS,
            sets=True)
        print(f"device memory allocated before training {FALCON}: "
              f"{torch.cuda.memory_allocated()} B")
        phase(f"{FALCON} training path ({FALCON_TRAIN_LAYERS} layers)")
        L = falcon_train.n_layers
        # the fused forward twice a layer (the forward and the remat
        # recompute), its backward's kernels once
        falcon_train_launches, falcon_trained = train_path(
            torch, falcon_train, K,
            dict(k2_fused=2 * L, k2_bwd=ss.BWD_LAUNCHES_PER_CALL * L),
            {"K2 fused": ss.FUSED_KERNEL_NAMES,
             "K2 backward": ss.BWD_KERNEL_NAMES},
            tmp, required=[f"layers/ssm/{part}" for part in
                           ("A_log", "x_proj", "dt_proj", "dt_bias", "D",
                            "conv_w", "in_x", "in_z", "out_proj")],
            part_check=train_layer_check)
        for name in ("k2_fused", "k2_bwd"):
            plan = K[name].last_plan
            check(plan.tma, f"{FALCON} training's {name} took the threads' "
                  f"load path")
            print(f"{FALCON} training's {name}: {plan_text(plan)}")
        print(f"device memory allocated before training {ZAMBA}: "
              f"{torch.cuda.memory_allocated()} B")
        zamba = dataclasses.replace(get_config(ZAMBA),
                                    n_layers=ZAMBA_TRAIN_LAYERS)
        phase(f"{ZAMBA} training path ({ZAMBA_TRAIN_LAYERS} layers)")
        A = attention_apps(zamba)
        # K1's forward twice an application (the forward and the remat
        # recompute of its group), its backward's kernels once
        zamba_train_launches, zamba_trained = train_path(
            torch, zamba, K,
            dict(k1=2 * A, k1_bwd=fa.BWD_LAUNCHES_PER_CALL * A),
            {"K1 forward": fa.KERNEL_NAMES, "K1 backward": fa.BWD_KERNEL_NAMES},
            tmp, required=[f"shared_attn/attn/{part}" for part in
                           ("wq", "wk", "wv", "wo")]
            + ["shared_attn/ln"] + [f"layers/ssm/{part}" for part in
                                    ("A_log", "in_x", "in_dt", "D",
                                     "out_proj")],
            split=BWD_PARTS, part_check=train_group_check)
        gemma = dataclasses.replace(get_config(GEMMA),
                                    n_layers=GEMMA_TRAIN_LAYERS)
        check(not os.listdir(tmp), f"{tmp} holds {os.listdir(tmp)} before "
              f"training {GEMMA}")
        print(f"device memory allocated before training {GEMMA}: "
              f"{torch.cuda.memory_allocated()} B; {tmp} has "
              f"{shutil.disk_usage(tmp).free} B free")
        phase(f"{GEMMA} training path ({GEMMA_TRAIN_LAYERS} layers, "
              f"{GEMMA_TRAIN_B} x {GEMMA_TRAIN_S} tokens)")
        L = gemma.n_layers
        # as qwen3's: K1's forward twice a layer, its backward's kernels
        # once, each layer with its window (1024 keys, or none on layer 5)
        gemma_train_launches, gemma_trained = train_path(
            torch, gemma, K, dict(k1=2 * L, k1_bwd=fa.BWD_LAUNCHES_PER_CALL * L),
            {"K1 forward": fa.KERNEL_NAMES, "K1 backward": fa.BWD_KERNEL_NAMES},
            tmp, required=[f"layers/attn/{part}" for part in
                           ("wq", "wk", "wv", "q_norm", "k_norm")],
            plain=("flash_attention", _plain_attention(fa)), split=BWD_PARTS,
            B=GEMMA_TRAIN_B, S=GEMMA_TRAIN_S)
        granite = dataclasses.replace(get_config(GRANITE),
                                      n_layers=GRANITE_TRAIN_LAYERS)
        check(not os.listdir(tmp), f"{tmp} holds {os.listdir(tmp)} before "
              f"training {GRANITE}")
        print(f"device memory allocated before training {GRANITE}: "
              f"{torch.cuda.memory_allocated()} B; {tmp} has "
              f"{shutil.disk_usage(tmp).free} B free")
        phase(f"{GRANITE} training path ({GRANITE_TRAIN_LAYERS} layers)")
        L = granite.n_layers
        # as qwen3's: K1's forward twice a layer, its backward's kernels once
        granite_train_launches, granite_trained = train_path(
            torch, granite, K,
            dict(k1=2 * L, k1_bwd=fa.BWD_LAUNCHES_PER_CALL * L),
            {"K1 forward": fa.KERNEL_NAMES, "K1 backward": fa.BWD_KERNEL_NAMES},
            tmp, required=[f"layers/attn/{part}" for part in
                           ("wq", "wk", "wv", "wo")]
            + [f"layers/moe/{part}" for part in
               ("router", "w_gate", "w_up", "w_down")],
            plain=("flash_attention", _plain_attention(fa)), split=BWD_PARTS)
        whisper = dataclasses.replace(get_config(WHISPER),
                                      encoder_layers=WHISPER_TRAIN_LAYERS,
                                      n_layers=WHISPER_TRAIN_LAYERS)
        check(not os.listdir(tmp), f"{tmp} holds {os.listdir(tmp)} before "
              f"training {WHISPER}")
        print(f"device memory allocated before training {WHISPER}: "
              f"{torch.cuda.memory_allocated()} B; {tmp} has "
              f"{shutil.disk_usage(tmp).free} B free")
        phase(f"{WHISPER} training path ({whisper.encoder_layers} + "
              f"{whisper.n_layers} layers, {TRAIN_B} x ({WHISPER_FRAMES} "
              f"frames + {WHISPER_TOKENS} tokens))")
        A = attention_apps(whisper)
        # K1's forward twice a call (the forward and the remat recompute
        # of its layer), its backward's kernels once: each encoder layer's
        # attention, each decoder layer's self- and cross-attention
        whisper_train_launches, whisper_trained = train_path(
            torch, whisper, K,
            dict(k1=2 * A, k1_bwd=fa.BWD_LAUNCHES_PER_CALL * A),
            {"K1 forward": fa.KERNEL_NAMES, "K1 backward": fa.BWD_KERNEL_NAMES},
            tmp, required=[f"{stack}/{part}" for stack in
                           ("enc_layers/attn", "layers/attn", "layers/cross")
                           for part in ("wq", "wk", "wv", "wo")]
            + ["enc_norm", "layers/ln_x"],
            plain=("flash_attention", _plain_attention(fa)), split=BWD_PARTS,
            S=WHISPER_TOKENS)
        llava = dataclasses.replace(get_config(LLAVA),
                                    n_layers=LLAVA_TRAIN_LAYERS)
        check(not os.listdir(tmp), f"{tmp} holds {os.listdir(tmp)} before "
              f"training {LLAVA}")
        print(f"device memory allocated before training {LLAVA}: "
              f"{torch.cuda.memory_allocated()} B; {tmp} has "
              f"{shutil.disk_usage(tmp).free} B free")
        phase(f"{LLAVA} training path ({LLAVA_TRAIN_LAYERS} layers, "
              f"{LLAVA_TRAIN_B} x ({LLAVA_PATCHES} + {LLAVA_TRAIN_TEXT}) "
              f"positions)")
        L = llava.n_layers
        llava_train_launches, llava_trained = train_path(
            torch, llava, K,
            dict(k1=2 * L, k1_bwd=fa.BWD_LAUNCHES_PER_CALL * L),
            {"K1 forward": fa.KERNEL_NAMES, "K1 backward": fa.BWD_KERNEL_NAMES},
            tmp, required=["mm_proj", "lm_head"]
            + [f"layers/attn/{part}" for part in ("wq", "wk", "wv", "wo")],
            plain=("flash_attention", _plain_attention(fa)), split=BWD_PARTS,
            B=LLAVA_TRAIN_B, S=LLAVA_TRAIN_TEXT)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    phase("done")
    print(f"profiles: {PROFILES['taken']} taken, {PROFILES['empty']} of "
          f"them recorded no device time and were taken again")
    qwen_serve["train"] = qwen_train
    falcon_serve["train"] = falcon_trained
    zamba_serve["train"] = zamba_trained
    gemma_serve["train"] = gemma_trained
    granite_serve["train"] = granite_trained
    whisper_serve["train"] = whisper_trained
    llava_serve["train"] = llava_trained
    trained = (qwen_train_launches, zamba_train_launches,
               gemma_train_launches, granite_train_launches,
               whisper_train_launches, llava_train_launches)
    kernels = [
        kernel_entry("flash_attention", fa.SOURCE,
                     "src/repro/kernels/flash_attention.py:82",
                     fa.KERNEL_NAMES,
                     k1_launches + zamba_launches + gemma_launches
                     + granite_launches + whisper_launches + llava_launches
                     + sum(t["k1"] for t in trained),
                     k1_records, {QWEN: qwen_serve, ZAMBA: zamba_serve,
                                  GEMMA: gemma_serve,
                                  GRANITE: granite_serve,
                                  WHISPER: whisper_serve,
                                  LLAVA: llava_serve}),
        kernel_entry("flash_attention_decode_lse", fa.SOURCE,
                     "src/repro/kernels/flash_attention.py:82 (its decode, "
                     "merged over sequence shards as "
                     "src/repro/models/layers.py:238 merges them)",
                     fa.KERNEL_NAMES,
                     qwen_serve["checkpoint"]["dist"]["mesh"]["sp"][
                         "lse_launches_all_ranks"],
                     lse_records, qwen_serve["checkpoint"]["dist"]["mesh"],
                     extra=["no_lse_ms"]),
        kernel_entry("flash_attention_bwd", fa.BWD_SOURCE,
                     "none: the gradient of src/repro/models/layers.py:115 "
                     "by autodiff", fa.BWD_KERNEL_NAMES,
                     sum(t["k1_bwd"] for t in trained), bwd_records,
                     {QWEN: qwen_train, ZAMBA: zamba_trained,
                      GEMMA: gemma_trained, GRANITE: granite_trained,
                      WHISPER: whisper_trained, LLAVA: llava_trained},
                     extra=[f"{part}_ms" for part in BWD_PARTS]),
        kernel_entry("ssm_scan", ss.SOURCE,
                     "src/repro/kernels/ssm_scan.py:45", ss.KERNEL_NAMES,
                     k2_launches, k2_records, falcon_serve["layers"]),
        kernel_entry("ssm_scan_fused", ss.SOURCE,
                     "src/repro/kernels/ssm_scan.py:45 (its recurrence, in "
                     "the fused form of src/repro/models/ssm.py:120)",
                     ss.FUSED_KERNEL_NAMES,
                     fused_launches + falcon_train_launches["k2_fused"],
                     fused_records, falcon_serve, extra=["lanes", "tma"]),
        kernel_entry("ssm_scan_bwd", ss.SOURCE_BWD,
                     "none: the gradient of src/repro/models/ssm.py:120 "
                     "(_mamba1_core_fused) by autodiff", ss.BWD_KERNEL_NAMES,
                     falcon_train_launches["k2_bwd"], k2b_records,
                     falcon_trained,
                     extra=["main_ms", "reduce_ms", "lanes", "tma"])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
