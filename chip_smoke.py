"""Chip smoke test of the PyTorch/CUDA port: the quickest proof that it
builds, is right and serves on one NVIDIA card.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --decode-timing DIR BITS  # time DIR/src's decode kernels
    python3 chip_smoke.py --decode-ab PARENT   # PARENT, this, this, PARENT
    python3 chip_smoke.py --attn-ab PARENT     # the same for mla_decode, int8
    python3 chip_smoke.py --retrieval-ab PARENT   # the same for kernels 2, 3
    python3 chip_smoke.py --centroid-ab PARENT    # the same for kernel 5
    python3 chip_smoke.py --distributed        # phase 9 alone
    python3 chip_smoke.py --tensor-parallel    # phase 11 alone
    python3 chip_smoke.py --tp-train           # phase 12 alone
    python3 chip_smoke.py --fsdp               # phase 13 alone

Phases, one line each, every one fatal on failure:
  1. card: name and power limit (nvidia-smi) and torch's device name;
  2. build: every kernel from the sources in this checkout, one nvcc per
     source in parallel, with -Xptxas -v (registers, shared memory, spills);
  3. flash_decode_paged against its plain version at the serve, mid
     (2k) and long (4k-8k) contexts, under an 8192-position table whose
     later splits hold no live position (and lengths of 1), with a
     window across split boundaries, at page sizes 2, 5 and 48 (none
     divides 64) and -1 tails; and flash_decode (the dense cache) at the
     serve shape, ragged positions, the mid and long contexts, a long
     cache with its later splits empty, and small shapes (window>0, G=1,
     MQA, S a multiple of no tile); and flash_decode_spliced (no TPU
     kernel: chunk-KV decode, K rotated by each page's delta, dead slots
     masked), in bf16 and fp32, on an all-fresh table (which must also
     give flash_decode_paged's bits), one and several chunks with
     partial last pages, rows with different spliced leads and -1
     tails, page sizes 16, 48 and 2 (more runs of one delta in a chunk
     than its angle table holds), rope_fraction 0.5, a dead tail across
     a 64-position chunk, fresh chunks beside spliced ones in one split
     (checked against the kernel's split plan), rot = 64, 32, 16, 24
     and 0 at Dh=64 and 48 at Dh=128 (partners by shuffle or from
     shared memory), G = 1, 3, 5 and 8, and the serve, mid and long
     contexts, each line naming the paths it took; then all three at the
     new configs' G (3, 6, 7 and 48; 9 and 64 at the tiles' edges; past
     8 in bf16 and fp32): the serve lengths, an all-fresh and a spliced
     table, and granite-20b's G=48 at the long context and with a window
     across split boundaries; all atol=rtol=2e-3
     (fp32 output from bf16 K/V, sums in another order), one grid launch
     a call, equal bits from a second spliced call; then this slice's
     kernels, bf16 and fp32: flash_decode softcapped (50) at gemma2's
     global shape (KVH 16, G 2, Dh 128) at the serve and long lengths
     and past G = 8; gemma2's ring of 4096 slots through flash_decode
     against the full cache with window 4096 (below W - 1, at it,
     wrapped past 2W); flash_decode_quant (int8 K/V, bf16 scales) at
     gemma2's shape with a row at pos 0, bf16 and fp32 q, Dh = 32 and a
     window past G = 8; mla_decode at minicpm3's (H 40, R 256, Dr 32)
     and the reduced (H 4, R 32, Dr 16) shapes, serve and long, with pos
     0; then one reduced Llama-3 decode step and one full-width
     granite-moe MoE layer (4 and 64 tokens) on the card against the CPU
     (equal experts kept), and 12 serve_step steps of the reduced gemma2
     (kv_quant off and on; the rings wrap), minicpm3, rwkv6 and zamba2
     against the CPU; flash_decode at zamba2's shared attention (B 4,
     KVH 32, G 1, Dh 80, rows over 16 or 32 lanes), bf16 and fp32: the
     serve lengths, ragged positions, S 8192, a window across split
     boundaries and pos 0; and the full-width rwkv6-3b and zamba2-2.7b
     (fp32) prefill of 2 x 256 tokens (two chunks of 128), whose states
     and last logits must equal 256 serve_step steps from zeros within
     1e-3 of their scale;
  4. probe_topk_fused and ivf_topk against their plain versions at the
     serve shapes, at a small shape and at their edges (every page dead,
     one live page, every live page in one cluster, B=9, page sizes 48
     and 7, d=60 and a slab off a 16-byte boundary (the direct path),
     rows duplicated across pages): equal ids (by flat position among
     exact ties) and the same admitted clusters, scores within
     rtol=1e-4, equal bits from a second call; and centroid_scores,
     alone and through ops.centroid_probe (kernel + torch.topk), at the
     serve probe shape, an odd one (Nc and d multiples of neither 32
     nor 4), d=770 and 12288, B=1, 5 and 33, Nc=1, 1000 and 4096, every
     centroid invalid, a sliced query off a 16-byte boundary and
     valid=None: equal top-k ids, scores within rtol=1e-4;
  5. timing: centroid_scores at B=4, d=768 over Nc=1024 and 4096: the
     event mean, the device time a call (CUDA graph), the host us a
     call and the cold device time a call (a 64 MB write before each
     call), beside its bound, its plain version and q @ c.T +
     masked_fill_ (the one library call that computes its function)
     timed the same ways, then its aims;
  6. serving: repro_torch.launch.serve's TeleRAGServer at the full
     Llama-3-8B width over a 1M x 768 datastore, built once and served
     three times: fused retrieval with paged decode (flash_decode_paged
     and probe_topk_fused must launch), unfused retrieval (ivf_topk must
     launch, probe_topk_fused must not) and dense decode (flash_decode,
     flash_decode_paged never); the decode kernel of each serve must
     make exactly one grid launch per layer in every decode step; each
     serve's doc ids must match an exact host search and at least one
     round must hit the device.  Then a fourth serve, with chunk-KV
     splicing (chunk_serve: a chunk-less twin and the chunk serve on the
     event clock over one roomy pool; the store is the twin's docs,
     prefilled at full width): every doc must splice, some wave must
     splice, the doc ids must equal the twin's, the kv and chunk_kv
     ledgers must drain to 0, and flash_decode_spliced and
     flash_decode_paged must launch 32 times per step of the spliced and
     the other waves.  Each serve's flight-recorder stream (the chunk
     serve's twin's too) replays through the port's happens-before
     checker, repro_torch.analysis.check_recorder(drained=True; the
     chunk serve with kv and chunk_kv required to drain to 0): one line
     of counts each, any violation fatal.  Then one observation: one
     retrieval round fused against unfused, in alternating pairs, and
     each path's kernel alone on that buffer state.  Then, Llama-3-8B's
     weights freed, the other families on the same datastore and index,
     one model at a time: granite-moe-3b (MoE, 8 of 32 layers),
     granite-20b (MQA G=48, 8 of 52 layers; paged, then dense),
     nemotron-4-15b (8 of 32), internvl2-1b (12 of 24) and
     arctic-480b (full width, 2 of 35 layers), each fused with paged
     decode, and gemma2-27b (8 of 46 layers), minicpm3-4b (10 of 62),
     rwkv6-3b (8 of 32) and zamba2-2.7b (12 of 54), fused with dense
     decode (the arch cannot page): one decode grid per layer per step
     (flash_decode_paged, flash_decode over gemma2's rings and global
     layers, half each, mla_decode for MLA; zamba2's shared attention
     one flash_decode grid per group, 4 a step; rwkv6 none at all) and no
     other decode kernel, probe_topk_fused launched, the
     exact-search check, 0 invariant violations, ms/step and tokens/s
     printed; gemma2-27b's kv_quant steps (a wave of 1 + 32
     serve_step(kv_quant=True) steps of 4 rows from serve-like
     contexts, flash_decode_quant and flash_decode 23 grids a step each,
     then the same steps over a bf16 cache, 46 flash_decode grids a
     step: both ms/step and the logits' largest difference relative to
     their scale); and musicgen-large (not served: it decodes codebook tokens) for one
     wave of 33 serve_step_paged steps at full width from serve-like
     contexts, logits [B, 4, 2048] finite, flash_decode_paged alone
     launched, one grid per layer per step;
  7. kernel timing, after the serves, so that its CUDA graphs and
     8k-position inputs cannot touch their timing: probe_topk_fused and
     ivf_topk at the serve shapes, and both decode kernels at the serve,
     mid and long contexts, beside their bounds and plain versions,
     flash_decode also beside scaled_dot_product_attention (GQA,
     masked), each with three numbers: the event mean, the device time a
     call (a loop of launches in a CUDA graph) and the wrapper's host
     microseconds a call; the retrieval kernels must run exactly 2 and 1
     grids a call (profiler); then whether the aims are met; then
     flash_decode_spliced on an all-fresh table of kernel 1's lengths,
     beside flash_decode_paged in the same process and on a table of
     20-token spliced chunks, and its aims; then kernels 1, 4 and the
     spliced one at granite-20b's shape (KVH=1, G=48, Dh=128) at the
     serve and long contexts, flash_decode beside SDPA; then
     flash_decode softcapped and flash_decode_quant at gemma2's shape
     (S 128 and 8192, all live), gemma2's full ring of 4096 slots, and
     mla_decode at minicpm3's shape (S 128 and 8192) beside SDPA over
     [q_abs | q_pe] and [ckv | kpe] (fp32, one kv head); then
     flash_decode at zamba2's shape (KVH 32, G 1, Dh 80) at the serve
     lengths and S 8192, all live, beside SDPA (MHA, position mask);
  8. training, with the serves' state freed, through the training entry
     point repro_torch.launch.train.main: the "full" preset (Llama-3-8B
     at full width and depth, random bf16 weights from seed 0, the bf16
     AdamW moments its memory check picks) trains 4 steps (remat) on one
     repeated TokenStream batch of 2 x 512 tokens: one line a step
     (loss, grad norm, lr, ms, tokens/s), then ms/step, tokens/s and the
     peak of torch.cuda.max_memory_allocated; every loss finite and the
     last below the first.  Then where a step's time goes, on a model of
     its own built as main builds it (the update alone, a profiled
     step's device ms by aten op, one step each in turn at main's
     attention/loss chunks and at make_train_step's defaults).  Then
     every other family, one model at a time (each freed before the
     next), through init_training and make_train_step at main's chunks
     (remat), 3 steps on one repeated 2 x 512 batch, all at full width:
     granite-moe-3b-a800m and rwkv6-3b at 16 of 32 layers,
     musicgen-large (codebooks) at 24 of 48, internvl2-1b (its
     256-embedding image prefix) at 12 of 24, minicpm3-4b at 10 of 62,
     zamba2-2.7b at 12 of 54, gemma2-27b at 4 of 46 (2 local, 2
     global); one line each (ms/step, tokens/s, peak
     memory, moments, first and last loss; every loss finite, the last
     below the first; granite-moe's recompute routing every layer as
     its forward did).  Then the "100m" preset of llama3-8b and of
     zamba2-2.7b through main with --ckpt-dir: 4 steps uninterrupted,
     and a resume from the step-2 checkpoint alone; the resumed steps'
     metrics and the step-4 checkpoints equal to the bit; and that
     checkpoint restored into a fresh state (in place) and saved again,
     equal to the bit.  Training runs no hand-written kernel (the
     reference trains through jnp attention, with no Pallas kernel);
  9. the distributed layer (``--distributed`` runs it alone, the index
     built again with a reduced model): 9a make_manual_dp_train_step
     (uncompressed) over an NCCL world of 1 on launch/train's full
     Llama-3-8B (phase 8's weights, moments, attention chunk and
     repeated 2 x 512 batch), 3 steps: ms/step, peak memory, the losses,
     the first within 1e-4 of phase 8's first (only the loss chunk, 512
     against 128, differs), and the bf16 gradient all-reduce alone; 9b
     internvl2-1b at full width and depth over the same world: 3
     uncompressed DP steps against make_train_step with the same
     arguments from the same seed, every parameter and moment equal to
     the bit, then 3 compressed steps (losses finite and falling, the
     error feedback nonzero) and both all-reduces alone with their
     payload bytes; 9c two ranks sharing the card over gloo (NCCL takes
     one rank a device), one process each (--dist-rank): (i)
     sharded_device_search over every page of phase 6's index (trimmed
     to an even count; each rank reads its half from a file), 4
     queries, k 3, an all-true mask, each rank's kernel-3 launches
     counted from 0 just before and read after, the doc ids equal to
     kernel 3's over the whole slab in this process and the scores within
     6.1e-05; each rank's kernel-3 device ms on its half against its
     byte bound, the exchange and merge ms (the ranks share one card's
     bandwidth: not a two-card figure); (ii) internvl2-1b compressed DP
     steps on a global batch of 4, both ranks' parameters equal to the
     bit after each step, the int32 payload beside a bf16 all-reduce's;
     (iii) which collectives gloo takes on CUDA tensors (a finding);
 10. the launch tooling (repro_torch.launch; no run of its own, its meta
     traces on the host's CPU): (a) launch.env.validate() of this
     process, one line (a finding); (b) dryrun.dry_run_cell's per-card
     peak for each of phase 8's trainings at the shape it ran (2 x 512
     tokens, main's chunks, remat groups of 4, its moments and depth,
     a 1 x 1 mesh; one spawned process each) beside phase 8's
     max_memory_allocated less what was held at its reset, the aim
     (within 10% or 2 GB) printed met or NOT met; (c) the roofline's
     bound and model-FLOPs share for phase 8's Llama-3-8B step and a
     dense Llama-3-8B decode step (4 rows of 128 positions) beside the
     measured ms/step (phase 8; phase 6's dense serve); (d) the
     flash_decode, flash_decode_quant and mla_decode wrappers traced on
     meta (directly and in dry-run decode steps): no launch counter may
     move, and their card outputs on seeded phase-3 cases must equal the
     ones taken in phase 3, before any meta trace, bit for bit;
 11. tensor parallelism (``--tensor-parallel`` runs it alone):
     llama3-8b (8 of 32 layers) and granite-20b (4 of 52, MQA) in bf16,
     granite-moe-3b (8 of 32, experts split) in fp32, all at full
     width: the one-rank model on the card, then 2 and 4 gloo ranks
     sharing the card (--tp-rank, one process each), each holding its
     blocks of the same seeded weights (shard_model) and of the cache
     and slab (shard_cache): kernels 1 and 4 at the rank's head counts
     against their plain versions; serve_step_paged, serve_step and
     prefill with the rank's TPGroup, each rank's launches set to 0
     just before each step and read after (one kernel-1 grid a layer a
     paged step, one kernel-4 grid a dense step); logits, cache and
     slab blocks held to an fp32 run of the same weights on one rank:
     no further from it than the one-rank model, plus 3e-2 (bf16) or
     1e-3 (fp32) of the scale (the fp32 run's own move under a 1e-7
     move of its embeddings printed beside), an MoE step whose routing
     differs from the one-rank model's only at a near tie (1e-5 of
     router probability, in its first differing layer) not compared; kernels 1 and 4 alone at each rank shape
     (device ms a call beside the bound); ms a paged step with the
     collectives' share, on the host clock through gloo (a layout test,
     not a multi-card figure);
 12. tensor-parallel training (``--tp-train`` runs it alone): fp32
     llama3-8b (4 of 32 layers) and granite-moe-3b (8 of 32), full
     width, 2 steps of make_train_step on one rank on the card, then of
     make_tp_train_step over 2 gloo ranks on a (1, 2) mesh and 4 on a
     (1, 4) (llama3-8b) or (2, 2) (granite-moe) mesh with act_spec
     (--tpt-rank, one process each; each rank's blocks of the same
     seeded weights, the global batch of 2 x 128 tokens, each step from
     the one-rank run's parameters before it): in every step each
     rank's loss within rtol 1e-5 and grad norm 1e-4 of the one-rank
     step's, its parameter blocks after the step within 2e-4 but for the
     elements whose gradient was within 1e-4 of its leaf's max-abs of 0
     (their share printed), an MoE routing flip allowed only at a near
     tie (1e-5 of router probability, as in phase 11; that step alone
     not compared); ms a step with the collectives' share (host clock
     through gloo: a layout test) and each rank's max_memory_allocated
     over a step, which phase 10's check then sets beside dry_run_cell's
     rank-0 tensor-parallel train peak at the same shape (a finding).
     Training runs no hand-written kernel;
 13. FSDP (``--fsdp`` runs it alone; RULES_FSDP: every parameter's
     embed dim split over ``data`` as well as ``model``, gathered a
     layer at a time): the dry run's rank-0 peak of each training case
     printed first; then phase 12's training at 4 x 128 tokens (the
     (4, 1) mesh splits the batch four ways), fp32 llama3-8b (4 of 32
     layers) and granite-moe-3b (8 of 32) over 2 gloo ranks on (2, 1)
     and 4 on (2, 2) with act_spec, llama3-8b also on (4, 1)
     (--fsdp-rank), with phase 12's tolerances after every step and each
     rank's parameter and moment elements; then fp32 llama3-8b and
     granite-moe-3b (8 layers each) served on (2, 2) (serve_step_paged
     over every row, serve_step and prefill over the rank's data shard's
     rows), each rank held to a one-rank fp32 run within 1e-3 of the
     scale (an MoE near tie as in phase 11), one kernel-1 grid a layer a
     paged step and one kernel-4 grid a dense step on every rank; then
     each rank's max_memory_allocated beside the dry run's rank 0 (aim:
     within 5%, met or NOT met, a finding).
centroid_scores is on no serve path (the engine's probe is a GEMM and
torch.topk, as the reference's is an einsum and lax.top_k), so its
launches come from the check phase alone; the kernels JSON lists each
kernel's launches by path (fused, unfused, dense, chunk, the families,
tp2, tp4 and fsdp4 summed over the ranks) and in the checks.
The last three lines are the card line, the kernels JSON and
{"ok": true, "device": {...}}.  Exits non-zero without a card, and
outside the repository (it imports the port from ./src).

--decode-timing DIR BITS runs phase 7's decode timing alone (kernels 1
and 4 and the spliced kernel) on the port under DIR/src (any checkout of
this repository), saves the decode kernels' outputs on seeded inputs
to BITS and prints the timing as one JSON line; --decode-ab PARENT runs
it four times in turn, on PARENT, this checkout, this checkout and
PARENT, one process each (BITS under chiprun_out/decode_ab/), and
prints the numbers of each kernel and shape side by side with the aims
(the serve-shape and spliced aims judged against PARENT's device time,
kernels 1 and 4 unchanged within the runs' spread) and how many of the
decode kernels' outputs equal PARENT's bit for bit.
--attn-timing DIR BITS and --attn-ab PARENT do the same for mla_decode
at minicpm3's serve and long shapes (B 4, S 128 and 8192, bf16 cache)
and flash_decode_quant beside bf16 flash_decode at gemma2's (KVH 16,
G 2, Dh 128, softcap 50): the four numbers each, the aims printed met or
NOT met (never a non-zero exit for a missed aim), flash_decode_quant's
and bf16 flash_decode's output bits on seeded cases against PARENT's,
and mla_decode against its plain version.
--centroid-timing DIR and --centroid-ab PARENT do the same for
centroid_scores: phase 5's timing, warm and cold, with its aims.
--retrieval-timing DIR and --retrieval-ab PARENT do the same for
probe_topk_fused and ivf_topk: their phase-7 timing, then each alone on
phase 6's buffer state (the index built again, with a reduced model),
with the retrieval aims, the device-time aim judged on every run.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import functools
import gc
import json
import math
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
BF16_TC_FLOPS = 989e12           # H100 SXM bf16 on the tensor cores, dense

# the serve phase's pool: 4096 prefetch pages + 342 pages' worth of the
# batch-4, 128-token KV lease (67,108,864 bytes / 196,608)
POOL_PAGES = 4438

# kernel 1's mid and long-context cases (B=4, KVH=8, G=4, Dh=128, ps=16)
MID_LENGTHS = [2048, 1536, 1024, 512]
LONG_LENGTHS = [8192, 6144, 5000, 4096]

# kernel 4's cases (B=4, KVH=8, G=4, Dh=128): the dense serve's bucket
# (S=128) full and ragged, and the long context (S=8192)
SERVE_POS = [127] * 4
RAGGED_POS = [127, 96, 40, 7]
MID_POS = [2047, 1535, 1023, 511]
LONG_POS = [8191, 6143, 4999, 4095]

# the aims for the decode kernels (at the long context unless named)
AIM_DENSE_BOUND_SHARE = 0.40     # flash_decode: >= 40% of its byte bound
AIM_PAGED_MS = 0.1               # flash_decode_paged: <= 0.1 ms and
AIM_PAGED_OVER_DENSE = 2.0       # <= 2x flash_decode in the same run

# the aims for the spliced-decode kernel, in the same process as
# flash_decode_paged on the same lengths (at the long context unless named)
AIM_SPLICED_FRESH_OVER_PAGED = 1.05   # all-fresh table: <= 1.05x kernel 1
AIM_SPLICED_FRESH_BOUND_SHARE = 0.43  # and >= 43% of its byte bound
AIM_SPLICED_CHUNKS_OVER_PAGED = 1.35  # 20-token chunks: <= 1.35x kernel 1
AIM_SPLICED_SERVE_OVER_PAGED = 1.10   # serve shape, device time a call

# the aims of --attn-ab (this tree's mean device time a call, runs 2-3):
# flash_decode_quant at gemma2's long context <= 50% of its 0.0407 ms byte
# bound; mla_decode at minicpm3's long and serve shapes a third and half
# of the CUDA-core kernel's 0.1926 and 0.0395 ms; mla_decode within
# MLA_AIM_ERR of its plain version over the bf16 cache
AIM_QUANT_LONG_MS = 0.0814
AIM_MLA_LONG_MS = 0.0640
AIM_MLA_SERVE_MS = 0.0200
MLA_AIM_ERR = 2e-5

# the aims for centroid_scores (B=4, d=768; Nc=1024 and 4096, warm and cold)
AIM_CENTROID_COLD_BOUND_SHARE = 0.40  # cold at Nc=4096: >= 40% of the bound
CENTROID_TIMING = {"serve": 1024, "paper": 4096}   # Nc of each timing shape
FLUSH_BYTES = 64 << 20           # written before each cold call: > the 50 MB L2

# the aims for the retrieval kernels, at chip_smoke's serve shapes
AIM_IVF_MS = 0.305               # ivf_topk: >= 50% of its 0.1523 ms bound
AIM_PROBE_MS = 0.144             # probe_topk_fused: >= 40% of its 0.0574 ms
AIM_FUSED_OVER_UNFUSED_MS = 0.05  # fused alone - unfused alone, one state

# the chunk serve's pool (and its chunk-less twin's): the serve pool plus
# 8192 pages' worth (1.6 GB) of room for chunk pages, so neither serve
# stalls on the pool and the two form the same waves
CHUNK_POOL_PAGES = POOL_PAGES + 8192

# the train phase: launch/train's "full" preset (Llama-3-8B at full width
# and depth, bf16 weights and moments, remat), TRAIN_STEPS steps on one
# repeated batch of TRAIN_BATCH x TRAIN_SEQ tokens from the TokenStream
TRAIN_STEPS = 4
TRAIN_BATCH, TRAIN_SEQ = 2, 512
TRAIN_ARGS = ["--preset", "full", "--steps", str(TRAIN_STEPS), "--batch",
              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--warmup", "1",
              "--repeat-batch", "--log-every", "1", "--device", "cuda"]

# the checkpoint round trip: launch/train's "100m" preset of each of
# CKPT_ARCHS (zamba2: per-group LoRA, a shared block, [G, per] blocks),
# CKPT_STEPS steps with a checkpoint every CKPT_STEPS // 2
CKPT_STEPS = 4
CKPT_BATCH, CKPT_SEQ = 4, 256
CKPT_ARCHS = ("llama3-8b", "zamba2-2.7b")

# the other families' training in phase 8, one model at a time: (arch,
# layers or None for full depth), each through init_training and
# make_train_step at main's chunks, FAMILY_TRAIN_STEPS steps on one
# repeated TokenStream batch of TRAIN_BATCH x TRAIN_SEQ tokens; gemma2-27b
# (27.2 B) does not fit one card with its moments: 4 of 46 layers (2
# local, 2 global; 3.45 B) do; the others at half the depth they trained
# at before phase 13 (minicpm3-4b 10 of 62, granite-moe-3b and rwkv6-3b
# 16 of 32, musicgen-large 24 of 48, zamba2-2.7b 12 of 54, internvl2-1b
# 12 of 24), so that the script stays within its time: each took 25-43 s
# at the old depths, most of it outside the steps (the profiled step's
# events)
FAMILY_TRAINS = [("minicpm3-4b", 10), ("granite-moe-3b-a800m", 16),
                 ("rwkv6-3b", 16), ("musicgen-large", 24),
                 ("zamba2-2.7b", 12), ("internvl2-1b", 12),
                 ("gemma2-27b", 4)]
FAMILY_TRAIN_STEPS = 3

# the decode kernels' checks at the new configs' G and past 8 (phase 3):
# (label, KVH, G, Dh, rope fraction): granite-moe's 24/8 heads, nemotron's
# 48/8 with half rotary, internvl2's 14/2, granite-20b's MQA 48/1, and
# the edges of the tiles (a last tile of one row; 64 rows, the most)
G_CASES = [("granite-moe G=3", 8, 3, 64, 1.0), ("nemotron G=6", 8, 6, 128, 0.5),
           ("internvl2 G=7", 2, 7, 64, 1.0), ("granite-20b G=48", 1, 48, 128, 1.0),
           ("G=9, a last tile of one row", 2, 9, 32, 1.0), ("G=64", 1, 64, 64, 1.0)]
# granite-20b's decode shape (KVH, G, Dh), timed at the serve and long
# contexts in phase 7
G48 = (1, 48, 128)

# the depth of phase 6's family serves, cut so that the script, with
# phases 10-13, stays within its time: granite-20b, gemma2-27b and
# minicpm3-4b from 52, 46 and 62 layers (the full-depth serves took
# 20-37 s each, host-bound a layer a step); granite-moe-3b,
# nemotron-4-15b, rwkv6-3b (32 layers each) and zamba2-2.7b (54) since
# phase 11 (11-24 s each at full depth); each halved again, and
# internvl2-1b cut from 24, since phase 13 (the nine took 70 s)
FAMILY_SERVE_CUT = {"granite-20b": 8, "gemma2-27b": 8, "minicpm3-4b": 10,
                    "granite-moe-3b-a800m": 8, "nemotron-4-15b": 8,
                    "rwkv6-3b": 8, "zamba2-2.7b": 12, "internvl2-1b": 12}

# the other families' serves in phase 6, on the same datastore and index,
# each model built after the one before is freed: (arch, --layers cut or
# None for full depth, EngineConfig overrides of each serve).  arctic's
# 35 layers of 27.3 GB do not fit one card: 2 layers do (54.6 GB).
FAMILY_SERVES = [
    ("granite-moe-3b-a800m", FAMILY_SERVE_CUT["granite-moe-3b-a800m"], [{}]),
    ("granite-20b", FAMILY_SERVE_CUT["granite-20b"], [{}, {"paged_decode": False}]),
    ("nemotron-4-15b", FAMILY_SERVE_CUT["nemotron-4-15b"], [{}]),
    ("internvl2-1b", FAMILY_SERVE_CUT["internvl2-1b"], [{}]),
    ("arctic-480b", 2, [{}]),
    # dense decode whatever the engine asks (supports_paged_decode):
    # gemma2's rings and global layers through flash_decode, MLA's latent
    # cache through mla_decode
    ("gemma2-27b", FAMILY_SERVE_CUT["gemma2-27b"], [{}]),
    ("minicpm3-4b", FAMILY_SERVE_CUT["minicpm3-4b"], [{}]),
    # the recurrent families, dense as well: RWKV6 launches no decode
    # kernel, zamba2's shared attention one flash_decode grid a group
    ("rwkv6-3b", FAMILY_SERVE_CUT["rwkv6-3b"], [{}]),
    ("zamba2-2.7b", FAMILY_SERVE_CUT["zamba2-2.7b"], [{}]),
]
# musicgen (not served: the server decodes [n] tokens, it decodes [n, 4]):
# a wave as the serves run one, at full width: MUSICGEN_STEPS timed
# serve_step_paged steps (a wave's most) after one untimed step, for a
# batch of 4 rows whose contexts start at MUSICGEN_LENGTHS and end at
# kernel 1's serve lengths (128/97/40, and 33)
MUSICGEN_STEPS = 32
MUSICGEN_LENGTHS = [95, 64, 7, 0]

# gemma2-27b's global decode shape (KVH, G, Dh), its window and score
# softcap; minicpm3's MLA shape (H, R, Dr), its reduced config's, and the
# absorbed scores' 1/sqrt(qk_nope + qk_rope)
GEMMA2_SHAPE = (16, 2, 128)
GEMMA2_WINDOW = 4096
GEMMA2_SOFTCAP = 50.0
MLA_SHAPE = (40, 256, 32)
MLA_REDUCED = (4, 32, 16)
MLA_SCALE = 1.0 / math.sqrt(96)
# zamba2-2.7b's shared attention (KVH, G, Dh): kernel 4 at Dh = 80, timed
# at kernel 1's serve lengths (128/97/40/7: 272 live positions) and at the
# long context, every position live
ZAMBA2_SHAPE = (32, 1, 80)
ZAMBA2_SERVE_POS = [127, 96, 39, 6]
ZAMBA2_LONG_POS = [8191] * 4
# the recurrent families' full-width prefill against their token-by-token
# steps (phase 3): B x S tokens, two chunks of 128; fp32 weights, so the
# check is of the chunked form against the recurrence (sums in another
# order through 32 or 63 blocks), each state within PREFILL_TOL of its
# largest value
PREFILL_B, PREFILL_S = 2, 256
PREFILL_TOL = 1e-3
# gemma2's kv_quant steps (phase 6): a wave of GEMMA2_STEPS timed steps
# after one untimed, for 4 rows from these contexts, on int8 and bf16
GEMMA2_STEPS = 32
GEMMA2_LENGTHS = [95, 64, 7, 0]

# phase 9, the distributed layer: 9a and 9b DIST_STEPS DP steps each over
# an NCCL world of 1 on phase 8's 2 x 512 batch; 9c two ranks on the card
# over gloo: the sharded search (SEARCH_B queries, top SEARCH_K, ids equal
# to kernel 3's over the whole slab, scores within RET_SCORE_TOL, phase
# 4's largest kernel-3 error) and DIST_C_STEPS compressed internvl2-1b
# steps on a global batch of DIST_C_BATCH x TRAIN_SEQ
DIST_STEPS = 3
DIST_C_STEPS, DIST_C_BATCH = 2, 4
SEARCH_B, SEARCH_K = 4, 3
RET_SCORE_TOL = 6.1e-05
DIST_RANK_TIMEOUT = 600

# phase 11, tensor parallelism (RULES_DEFAULT over "model"): (arch, layers
# or None for full depth), full width, over TP_WORLDS gloo ranks sharing
# the card, each rank's blocks of the TP_SEED weights (llama3-8b and
# granite-20b in bf16, the serving dtype; granite-moe in fp32, so that no
# near tie in its 32 layers of top-8 routing turns on bf16 noise); a
# decode step for TP_B rows at TP_LENGTHS over a dense cache of TP_S
# positions and a slab of TP_PS-token pages, and a 2 x TP_PROMPT prefill;
# logits, caches and slabs held to an fp32 run of the same weights and
# inputs: as far from it as the one-rank model is, plus TP_TOL of the
# scale (two bf16 programs that sum in another order differ by more than
# 3% of the scale at full width; these random fp32 networks move 1e-5 -
# 1e-4 of their scale when their inputs move by 1e-7, which phase 11
# measures and prints); TP_TIMED paged steps timed
TP_CASES = [("llama3-8b", 8), ("granite-20b", 4), ("granite-moe-3b-a800m", 8)]
TP_DTYPE = {"llama3-8b": torch.bfloat16, "granite-20b": torch.bfloat16,
            "granite-moe-3b-a800m": torch.float32}
TP_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-3}
TP_WORLDS = (2, 4)
TP_SEED = 0
TP_B, TP_S, TP_PS, TP_PROMPT = 4, 256, 16, 128
TP_LENGTHS = [200, 97, 40, 7]
TP_TIMED = 5
# an MoE pick that differs from the one-rank model's must be a near tie:
# the two experts' router probabilities (the one-rank model's) this close
TP_TIE = 1e-5
TP_RANK_TIMEOUT = 300

# phase 12, tensor-parallel training (RULES_DEFAULT): (arch, layers), full
# width, fp32, TPT_STEPS steps of make_tp_train_step on one global batch
# of TPT_B x TPT_S tokens from TPT_SEED, against the one-rank
# make_train_step on the card, each step from the one-rank run's
# parameters before it (as tests/test_torch_tp_train.py runs each step
# from the reference's state), so that rounding cannot compound through
# the optimizer from one step into the next; (arch, world) -> ((data,
# model) mesh, act_spec): 2 ranks on (1, 2) without act_spec, 4 with it,
# on (2, 2) for granite-moe (its routing across data shards) and on (1, 4)
# for llama3-8b (four data replicas of its 15.4 GB of blocks, moments and
# gradients would not fit one card beside each other)
TPT_CASES = [("llama3-8b", 4), ("granite-moe-3b-a800m", 8)]
TPT_WORLDS = (2, 4)
TPT_MESH = {("llama3-8b", 2): ((1, 2), False), ("llama3-8b", 4): ((1, 4), True),
            ("granite-moe-3b-a800m", 2): ((1, 2), False),
            ("granite-moe-3b-a800m", 4): ((2, 2), True)}
TPT_B, TPT_S, TPT_STEPS, TPT_SEED = 2, 128, 2, 0
TPT_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TPT_KW = dict(attn_chunk=128, loss_chunk=64, remat=True, remat_group=2)

# phase 13, FSDP (RULES_FSDP: every embed dim split over data as well as
# model): phase 12's training (TPT_STEPS steps, TPT_S tokens a row, each
# step from the one-rank run's parameters before it) at FST_B rows, as
# the (4, 1) mesh splits the batch four ways: {world: [(arch, layers,
# (data, model) mesh, act_spec, first rank)]}, the two (2, 1) cases at
# once on ranks 0-1 and 2-3; then FSS_CASES' serve steps in fp32 on
# FSS_MESH (phase 11's inputs), against the one-rank fp32 run
FST_B = 4
FST_CASES = {4: [("llama3-8b", 4, (2, 1), False, 0),
                 ("granite-moe-3b-a800m", 8, (2, 1), False, 2),
                 ("llama3-8b", 4, (2, 2), True, 0),
                 ("granite-moe-3b-a800m", 8, (2, 2), True, 0),
                 ("llama3-8b", 4, (4, 1), False, 0)]}
FSS_CASES = [("llama3-8b", 8), ("granite-moe-3b-a800m", 8)]
FSS_MESH = (2, 2)

# serving configuration driven in phase 6 (full Llama-3-8B width; built
# once, served fused, unfused and with dense decode)
SERVE_ARGS = ["--arch", "llama3-8b", "--pipeline", "irg", "--requests", "8",
              "--batch", "4", "--vectors", "1048576", "--dim", "768",
              "--clusters", "1024", "--train-sample", "131072",
              "--page-size", "128", "--nprobe", "64", "--top-k", "3",
              "--buffer-pages", "4096", "--max-len", "128",
              "--max-steps", "32", "--device", "cuda"]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, text: str) -> None:
    print(f"[{name}] {text}", flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def capture(fn, calls: int):
    """A CUDA graph of ``calls`` calls of ``fn``, replayed once.  One call
    on the capture stream first makes the wrapper's per-stream workspace
    outside the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def replay_ms(graph, reps: int) -> float:
    """Milliseconds of ``reps`` replays of ``graph`` between two events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def device_ms(fn, calls: int = 50, reps: int = 5) -> float:
    """Device ms a call of ``fn``: ``calls`` calls captured in one CUDA
    graph and replayed ``reps`` times between two events, so no host
    time falls between the launches and no tracer runs in the process."""
    graph = capture(fn, calls)
    ms = replay_ms(graph, reps)
    del graph
    return ms / (reps * calls)


def cold_ms(fn, flush: torch.Tensor, calls: int = 20, reps: int = 7) -> float:
    """Device ms a call of ``fn`` with the L2 cache flushed before each
    call: a CUDA graph of ``calls`` pairs (write ``flush``, larger than
    the L2, then call) against one of ``calls`` writes alone, replayed in
    turn; the median difference over the calls."""
    both = capture(lambda: (flush.fill_(1.0), fn()), calls)
    alone = capture(lambda: flush.fill_(1.0), calls)
    diffs = [replay_ms(both, 1) - replay_ms(alone, 1) for _ in range(reps)]
    del both, alone
    return float(np.median(diffs)) / calls


def host_us(fn, calls: int = 200, blocks: int = 5) -> float:
    """Host microseconds a call of ``fn``: the wrapper's checks and its
    enqueue, timed without a synchronise inside a block of ``calls``
    calls; the median of ``blocks`` blocks, since the host's clock
    varies with its other load."""
    per_call = []
    for _ in range(blocks):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(per_call))


def three_times(fn, counted, iters: int) -> dict:
    """The event mean (ms) with the grid launches a call that the
    wrapper ``counted`` counts, the device time a call (ms, CUDA graph)
    and the host microseconds a call of ``fn``."""
    before = counted.launches
    ms = time_ms(fn, iters, warmup=3)
    grids = (counted.launches - before) / (iters + 3)
    return {"ms": ms, "grids_per_call": grids, "device_ms": device_ms(fn),
            "host_us": host_us(fn)}


def grids(fn, calls: int = 5) -> float:
    """Grids a call of ``fn`` runs on the card, by the profiler over
    ``calls`` calls, after a first call that makes the wrapper's
    per-stream workspace.  The tracer now and then loses device events
    (all of one profile, or one of ten) but never adds any, so the most
    of three profiles counts."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and not e.name.startswith(("Memcpy", "Memset"))))
    return max(counts) / calls


# -- kernel 1: flash_decode_paged ---------------------------------------------


def decode_case(B, KVH, G, Dh, ps, MB, lengths, seed, dtype=torch.bfloat16):
    """Paged decode inputs on the card: a slab larger than needed,
    non-contiguous slots per row, -1 tails past each row's length."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    NP = B * MB + 4
    q = torch.randn((B, KVH, G, Dh), generator=g, device="cuda").to(dtype)
    kp = torch.randn((NP, ps, KVH, Dh), generator=g, device="cuda").to(dtype)
    vp = torch.randn((NP, ps, KVH, Dh), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(NP, generator=g, device="cuda")[:B * MB].reshape(B, MB)
    bt = perm.to(torch.int32)
    for b, n in enumerate(lengths):
        bt[b, -(-n // ps):] = -1
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, lens


def bound(nbytes: float, flops: float, bf16_flops: float = 0.0):
    """(least ms, what bounds it): bytes over the memory rate against the
    operations over the peak rate for their operands' type: ``flops``
    with an fp32 operand over the fp32 rate, ``bf16_flops`` (products of
    two bf16 operands, exact in an fp32 sum; an fp32 operand times a bf16
    one counts as three, its exact bf16 pieces) over the tensor cores'
    bf16 rate; the two units run side by side, so the larger of their
    times."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = max(flops / FP32_FLOPS, bf16_flops / BF16_TC_FLOPS)
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def attn_flops(q, k, rows: int):
    """(fp32 flops, bf16 flops) of decode attention over ``rows`` live
    (position, kv-head) K/V rows: q.K and P.V, 2 * G * Dh each a row.
    q.K is a bf16 product where q and K are both bf16; P (fp32
    probabilities) makes P.V an fp32 one."""
    _, _, G, Dh = q.shape
    half = 2 * rows * G * Dh
    if q.dtype == k.dtype == torch.bfloat16:
        return half, half
    return 2 * half, 0


def decode_work(q, kp, bt, lens, window):
    """(bytes, fp32 flops, bf16 flops) this input needs: each live K/V
    row, q, the table and the lengths read once, the fp32 output written
    once."""
    B, KVH, G, Dh = q.shape
    ps = kp.shape[1]
    lens = lens.clamp(max=bt.shape[1] * ps)
    live = (lens.clamp(max=window) if window > 0 else lens).sum().item()
    nbytes = (2 * live * KVH * Dh * kp.element_size() + q.numel() * q.element_size()
              + bt.numel() * 4 + lens.numel() * 4 + q.numel() * 4)
    return (nbytes, *attn_flops(q, kp, live * KVH))


def check_decode(fd, ref, case, window, label):
    q, kp, vp, bt, lens = case
    before = fd.flash_decode_paged.launches
    out = fd.flash_decode_paged(q, kp, vp, bt, lens, window=window)
    want = ref.flash_decode_paged_ref(q, kp, vp, bt, lens, window)
    torch.cuda.synchronize()
    if fd.flash_decode_paged.launches != before + 1:
        fail(f"flash_decode_paged {label}: "
             f"{fd.flash_decode_paged.launches - before} grid launches, want 1")
    err = (out - want).abs().max().item()
    try:
        torch.testing.assert_close(out, want, atol=2e-3, rtol=2e-3)
    except AssertionError as e:
        fail(f"flash_decode_paged {label}: {e}")
    phase("check", f"flash_decode_paged {label}: shape {tuple(q.shape)} "
          f"ps={kp.shape[1]} window={window} max_abs_err={err:.3e} "
          "(atol=rtol=2e-3)")
    return err


# -- kernel 4: flash_decode (dense cache) -------------------------------------


def dense_case(B, S, KVH, G, Dh, pos, seed, dtype=torch.bfloat16,
               q_dtype=None):
    """Dense decode inputs on the card: q [B,KVH,G,Dh], k/v [B,S,KVH,Dh]
    and the new token's position per row."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, KVH, G, Dh), generator=g, device="cuda")
    k = torch.randn((B, S, KVH, Dh), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, KVH, Dh), generator=g, device="cuda").to(dtype)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    return q.to(q_dtype or dtype), k, v, pos


def dense_work(case, window):
    """(bytes, fp32 flops, bf16 flops) this input needs: each live K/V
    row, q and pos read once, the fp32 output written once."""
    q, k, _, pos = case
    B, KVH, G, Dh = q.shape
    S = k.shape[1]
    live = 0
    for p in pos.tolist():
        hi, lo = min(p + 1, S), (max(0, p + 1 - window) if window > 0 else 0)
        live += max(0, hi - lo)
    nbytes = (2 * live * KVH * Dh * k.element_size()
              + q.numel() * q.element_size() + pos.numel() * 4 + q.numel() * 4)
    return (nbytes, *attn_flops(q, k, live * KVH))


def check_dense(fd, ref, case, window, label):
    before = fd.flash_decode.launches
    out = fd.flash_decode(*case, window=window)
    want = ref.flash_decode_ref(*case, window)
    torch.cuda.synchronize()
    if fd.flash_decode.launches != before + 1:
        fail(f"flash_decode {label}: {fd.flash_decode.launches - before} grid "
             "launches, want 1")
    err = (out - want).abs().max().item()
    try:
        torch.testing.assert_close(out, want, atol=2e-3, rtol=2e-3)
    except AssertionError as e:
        fail(f"flash_decode {label}: {e}")
    q, k, _, pos = case
    phase("check", f"flash_decode {label}: q {tuple(q.shape)} {q.dtype}, k/v "
          f"{tuple(k.shape)} {k.dtype}, pos {pos.tolist()} window={window} "
          f"max_abs_err={err:.3e} (atol=rtol=2e-3)")
    return err


def sdpa(case):
    """The one PyTorch call that computes flash_decode on ``case`` (no
    window): scaled_dot_product_attention over the cache with GQA and the
    position mask, bf16 in and out, the port never calls it."""
    import torch.nn.functional as F
    q, k, v, pos = case
    B, KVH, G, Dh = q.shape
    S = k.shape[1]
    qs = q.reshape(B, KVH * G, 1, Dh)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(S, device="cuda")[None, :] <= pos[:, None])
    mask = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)


def decode_timing(fd, ref, smi: str) -> dict:
    """Both decode kernels at the serve, mid and long contexts: the three
    times of ``three_times``, the bound, the plain version's event mean
    and, for flash_decode, the library call's
    (SDPA; its error against the plain version is printed, not checked).
    Returns {kernel: {shape: numbers}}, one line printed for each."""
    t = {"flash_decode_paged": {}, "flash_decode": {}}
    paged = {"serve": ([128, 97, 40, 7], 8, 200), "mid": (MID_LENGTHS, 128, 100),
             "long": (LONG_LENGTHS, 512, 100)}
    for shape, (lengths, MB, iters) in paged.items():
        q, kp, vp, bt, lens = decode_case(4, 8, 4, 128, 16, MB, lengths, seed=1)
        r = three_times(lambda: fd.flash_decode_paged(q, kp, vp, bt, lens),
                        fd.flash_decode_paged, iters)
        r["bound_ms"], r["bound_by"] = bound(*decode_work(q, kp, bt, lens, 0))
        r["plain_ms"] = time_ms(lambda: ref.flash_decode_paged_ref(
            q, kp, vp, bt, lens), max(iters // 10, 5))
        r["library_ms"], r["lengths"] = None, lengths
        t["flash_decode_paged"][shape] = r
        phase("time", f"flash_decode_paged {shape} (lengths {lengths}): "
              + describe(r) + f" on {smi}")
        del q, kp, vp, bt, lens
    dense = {"serve": (128, SERVE_POS, 200), "mid": (2048, MID_POS, 100),
             "long": (8192, LONG_POS, 100)}
    for shape, (S, pos, iters) in dense.items():
        case = dense_case(4, S, 8, 4, 128, pos, seed=11)
        r = three_times(lambda: fd.flash_decode(*case), fd.flash_decode, iters)
        r["bound_ms"], r["bound_by"] = bound(*dense_work(case, 0))
        r["plain_ms"] = time_ms(lambda: ref.flash_decode_ref(*case),
                                max(iters // 10, 5))
        lib = sdpa(case)
        r["library_ms"] = time_ms(lib, iters)
        want = ref.flash_decode_ref(*case)
        r["library_err"] = (lib().float().reshape(want.shape) - want
                            ).abs().max().item()
        r["pos"] = pos
        t["flash_decode"][shape] = r
        phase("time", f"flash_decode {shape} (S={S}, pos {pos}): " + describe(r)
              + f", sdpa {r['library_ms']:.4f} ms (bf16, max_abs_err "
              f"{r['library_err']:.2e}) on {smi}")
        del case, lib, want
    torch.cuda.empty_cache()
    return t


def describe(r: dict) -> str:
    return (f"{r['ms']:.4f} ms (events), {r['device_ms']:.4f} ms device a "
            f"call ({r['grids_per_call']:g} grids), {r['host_us']:.1f} us "
            f"host a call, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}; "
            f"{r['bound_ms'] / r['ms']:.1%} of it)")


def decode_json(by_shape: dict) -> dict:
    """A decode kernel's numbers for the kernels JSON: the serve shape's
    at the top level, the mid and long contexts' under their own keys."""
    return {**by_shape["serve"], "mid_context": by_shape["mid"],
            "long_context": by_shape["long"]}


def decode_aims(t: dict, parent: dict = None) -> list:
    """(aim, met, numbers) for the decode timings ``t``: at the long
    context, flash_decode no slower than SDPA and at least 40% of its
    byte bound, flash_decode_paged at most 2x flash_decode and 0.1 ms;
    with ``parent`` (the parent tree's timings), each kernel's device
    time a call at the serve shape no higher than the parent's."""
    d, p = t["flash_decode"]["long"], t["flash_decode_paged"]["long"]
    cap = d["bound_ms"] / AIM_DENSE_BOUND_SHARE
    aims = [
        ("flash_decode at the long context: no slower than sdpa, >= 40% of "
         "the byte bound", d["ms"] <= d["library_ms"] and d["ms"] <= cap,
         f"{d['ms']:.4f} ms, sdpa {d['library_ms']:.4f} ms, 40% of the bound "
         f"is {cap:.4f} ms"),
        ("flash_decode_paged at the long context: <= 2x flash_decode, <= "
         f"{AIM_PAGED_MS} ms", p["ms"] <= min(AIM_PAGED_OVER_DENSE * d["ms"],
                                              AIM_PAGED_MS),
         f"{p['ms']:.4f} ms, flash_decode {d['ms']:.4f} ms")]
    for name in (("flash_decode", "flash_decode_paged") if parent else ()):
        mine, theirs = t[name]["serve"]["device_ms"], parent[name]["serve"]["device_ms"]
        aims.append((f"{name} at the serve shape: device time a call no higher "
                     "than the parent's", mine <= theirs,
                     f"{mine:.4f} ms against {theirs:.4f} ms"))
    return aims


# -- the spliced-decode kernel (no TPU kernel: the chunk-KV path) ------------


def chunk_rows(lengths):
    """Rows of 20-token chunks (two 16-token pages each, the second with
    12 dead slots) that fill each of ``lengths`` but its last 16-48
    positions, which fall on two fresh pages."""
    return [[20] * max(0, (n - 16) // 32) for n in lengths]


def spliced_case(B, KVH, G, Dh, ps, chunks, fresh, seed, dtype=torch.bfloat16,
                 tail=2):
    """Spliced decode inputs on the card: row b holds ``chunks[b]`` back
    to back at page boundaries, a positive entry a chunk of that many
    tokens (each page's delta its chunk's first layout position, its
    valid count the chunk's live tokens on it) and a negative entry -k
    k fresh pages (delta 0, valid ps), then ``fresh`` fresh pages, then
    ``tail`` -1 columns (valid 0).  The new token sits on the last fresh
    pages."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    npages = lambda c: -c if c < 0 else -(-c // ps)
    MB = max(sum(map(npages, row)) for row in chunks) + fresh + tail
    NP = B * MB + 4
    q = torch.randn((B, KVH, G, Dh), generator=g, device="cuda").to(dtype)
    kp = torch.randn((NP, ps, KVH, Dh), generator=g, device="cuda").to(dtype)
    vp = torch.randn((NP, ps, KVH, Dh), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(NP, generator=g, device="cuda")[:B * MB].reshape(
        B, MB).to(torch.int32).cpu()
    bt = torch.full((B, MB), -1, dtype=torch.int32)
    dl = torch.zeros((B, MB), dtype=torch.int32)
    vd = torch.zeros((B, MB), dtype=torch.int32)
    lens = []
    for b, row in enumerate(chunks):
        b0 = 0
        for c in row + [-fresh]:
            n = npages(c)
            bt[b, b0:b0 + n] = perm[b, b0:b0 + n]
            vd[b, b0:b0 + n] = ps
            if c > 0:
                dl[b, b0:b0 + n] = b0 * ps
                vd[b, b0 + n - 1] = c - (n - 1) * ps
            b0 += n
        lens.append((b0 - fresh) * ps + 1 + (7 * b + 3) % (fresh * ps))
    lens = torch.tensor(lens, dtype=torch.int32)
    return [q, kp, vp] + [t.cuda() for t in (bt, lens, dl, vd)]


def spliced_work(case):
    """(bytes, fp32 flops, bf16 flops) this input needs: each live K/V
    row (causal and inside its page's valid count), q and the four tables
    read once, the fp32 output written once; attention over every live
    row (``attn_flops``), where a row of a rotated page (delta != 0)
    also takes the rotation of its K (6 flops an element) and its q.K
    an fp32 operand."""
    q, kp, _, bt, lens, dl, vd = case
    B, KVH, G, Dh = q.shape
    ps = kp.shape[1]
    pos = torch.arange(bt.shape[1] * ps, device="cuda")
    live = ((pos[None, :] % ps < vd.repeat_interleave(ps, 1))
            & (pos[None, :] < lens[:, None]))
    rot = (live & (dl.repeat_interleave(ps, 1) != 0)).sum().item()
    live = live.sum().item()
    nbytes = (2 * live * KVH * Dh * kp.element_size()
              + q.numel() * q.element_size() + 3 * bt.numel() * 4
              + lens.numel() * 4 + q.numel() * 4)
    f32, bf16 = attn_flops(q, kp, (live - rot) * KVH)
    return (nbytes, f32 + (4 * G + 6) * rot * KVH * Dh, bf16)


def check_spliced(fd, ref, case, frac, label, theta=500_000.0):
    """The spliced kernel against its plain version: one grid launch a
    call, atol=rtol=2e-3, no NaN, and equal bits from a second call; an
    all-fresh table must also give flash_decode_paged's bits."""
    kw = dict(rope_fraction=frac, rope_theta=theta)
    before = fd.flash_decode_spliced.launches
    out = fd.flash_decode_spliced(*case, **kw)
    want = ref.flash_decode_spliced_ref(*case, **kw)
    torch.cuda.synchronize()
    if fd.flash_decode_spliced.launches != before + 1:
        fail(f"flash_decode_spliced {label}: "
             f"{fd.flash_decode_spliced.launches - before} grid launches, want 1")
    if torch.isnan(out).any():
        fail(f"flash_decode_spliced {label}: NaN in the output")
    err = (out - want).abs().max().item()
    try:
        torch.testing.assert_close(out, want, atol=2e-3, rtol=2e-3)
    except AssertionError as e:
        fail(f"flash_decode_spliced {label}: {e}")
    if not torch.equal(fd.flash_decode_spliced(*case, **kw), out):
        fail(f"flash_decode_spliced {label}: a second call gave other bits")
    fresh = bool((case[5] == 0).all() and (case[6][case[3] >= 0] == case[1].shape[1]).all())
    if fresh and not torch.equal(fd.flash_decode_paged(*case[:5]), out):
        fail(f"flash_decode_spliced {label}: all-fresh table, not "
             "flash_decode_paged's bits")
    q, kp = case[0], case[1]
    phase("check", f"flash_decode_spliced {label}: shape {tuple(q.shape)} "
          f"{kp.dtype} ps={kp.shape[1]} rope_fraction={frac} table "
          f"{tuple(case[3].shape)} lengths {case[4].tolist()[:4]} "
          f"max_abs_err={err:.3e} (atol=rtol=2e-3), equal bits twice"
          + (", = flash_decode_paged" if fresh else "") + "; "
          + splice_paths(fd, case, frac))
    return err


def splice_paths(fd, case, frac) -> str:
    """Which paths of the spliced kernel ``case`` takes: its chunks by
    mode, the angle-table runs against the table's room, and the partner
    exchange (the wrapper's plan)."""
    q, kp, bt = case[0], case[1], case[3]
    Dh, ps = q.shape[3], kp.shape[1]
    rot = int(Dh * frac) // 2 * 2
    dist, runs_max, _ = fd._splice_plan(Dh, kp.dtype == torch.bfloat16, rot)
    mode, runs = fd.spliced_chunks(bt, case[4], case[5], case[6], ps, rot)
    rotated = mode == fd.ROTATED
    inline = int((rotated & (runs > runs_max)).sum())
    return (f"chunks fresh {int((mode == fd.FRESH).sum())}, masked "
            f"{int((mode == fd.MASKED).sum())}, rotated {int(rotated.sum())} "
            f"({inline} with more runs than the table's {runs_max}); rot={rot}, "
            + (f"partners by shuffle (lane distance {dist})" if dist else
               "partners from shared memory" if rot else "no rotation"))


# kernel 1's timing shapes: (lengths, MB, iters) at the serve, mid and long
# contexts (B=4, KVH=8, G=4, Dh=128, ps=16)
PAGED_TIMING = {"serve": ([128, 97, 40, 7], 8, 200), "mid": (MID_LENGTHS, 128, 100),
                "long": (LONG_LENGTHS, 512, 100)}


def spliced_check_cases(dtype):
    """(label, rope fraction, case) of the spliced kernel's check phase in
    ``dtype`` (made one at a time: the long ones are large)."""
    yield "all-fresh table", 1.0, spliced_case(4, 8, 4, 128, 16, [[]] * 4, 8, 41, dtype)
    yield "one chunk a row", 1.0, spliced_case(4, 8, 4, 128, 16, [[21], [9], [33], [16]], 8, 42, dtype)
    yield ("several chunks, partial last pages", 1.0,
           spliced_case(4, 8, 4, 128, 16, [[21, 9, 40], [3], [17, 17], [1]], 8, 43, dtype))
    yield ("different spliced leads and -1 tails", 1.0,
           spliced_case(3, 2, 2, 64, 16, [[70], [], [5, 5, 5]], 2, 44, dtype, tail=5))
    yield "page size 48", 1.0, spliced_case(3, 2, 8, 64, 48, [[50, 100], [7], [150]], 3, 45, dtype)
    yield "rope_fraction 0.5", 0.5, spliced_case(3, 2, 2, 128, 16, [[21, 9], [5, 5, 5], []], 3, 46, dtype)
    yield ("a dead tail across a 64-position chunk", 1.0,
           spliced_case(2, 8, 4, 128, 16, [[65, 3], [129]], 4, 47, dtype))
    # fresh chunks beside spliced ones inside one split (2048 positions,
    # 32 rows: 128-position splits of two chunks)
    yield ("fresh and spliced chunks in one split", 1.0, spliced_case(
        4, 8, 4, 128, 16, [[-4, 20, 20, -4, 9, -4, 40, -8], [20] * 6 + [-8],
                           [-12, 33, -4], [5, -4, 64, -4]], 2, 49, dtype, tail=100))
    for frac, rot in ((1.0, 64), (0.5, 32), (0.25, 16), (0.375, 24), (0.0, 0)):
        yield (f"Dh=64, rot={rot}", frac, spliced_case(
            3, 2, 4, 64, 16, [[21, 9, 40], [17, 17], [3, -2, 30]], 3, 50 + rot, dtype))
    yield ("Dh=128, rot=48 (partners from shared memory)", 0.375, spliced_case(
        2, 4, 4, 128, 16, [[21, 9, 40], [17, 17, 5]], 3, 51, dtype))
    yield ("page size 2, chunks of 1-3 tokens (more runs than the table holds)", 1.0,
           spliced_case(2, 2, 4, 128, 2, [[1, 2, 3] * 12, [3, 1] * 20], 4, 52, dtype))
    for G in (1, 3, 5, 8):
        yield (f"G={G}", 1.0, spliced_case(
            3, 2, G, 128, 16, [[21, 9, 40], [5, 5], [33]], 4, 60 + G, dtype))
    for i, (ctx, (lengths, _, _)) in enumerate(PAGED_TIMING.items()):
        yield (f"{ctx} context (chunks of 20 tokens)", 1.0, spliced_case(
            4, 8, 4, 128, 16, chunk_rows(lengths), 2, 80 + i, dtype))


def spliced_checks(fd, ref) -> float:
    """Every case of the spliced kernel's check phase; the largest error.
    The fresh-beside-spliced case must put a fresh and a rotated chunk in
    one split of the kernel's plan."""
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = "bf16" if dtype == torch.bfloat16 else "fp32"
        for label, frac, case in spliced_check_cases(dtype):
            if label.startswith("fresh and spliced"):
                need_mixed_split(fd, case)
            errs.append(check_spliced(fd, ref, case, frac, f"{label}, {dn}"))
            del case
    torch.cuda.empty_cache()
    return max(errs)


def need_mixed_split(fd, case) -> None:
    """Fail unless some split of the kernel's plan for ``case`` holds a
    fresh chunk and a rotated one."""
    q, kp, bt = case[0], case[1], case[3]
    B, KVH = q.shape[:2]
    S = bt.shape[1] * kp.shape[1]
    split, _ = fd._splits(B * KVH, S, fd._sm_count(q.device.index))
    mode, _ = fd.spliced_chunks(bt, case[4], case[5], case[6], kp.shape[1],
                                q.shape[3])
    per = split // 64
    for row in mode.tolist():
        for s0 in range(0, len(row), per):
            if {fd.FRESH, fd.ROTATED} <= set(row[s0:s0 + per]):
                return
    fail(f"no split of {split} positions holds a fresh and a rotated chunk")


def spliced_timing(fd, ref, smi: str) -> dict:
    """The spliced kernel beside flash_decode_paged on an all-fresh table
    of kernel 1's timing lengths (the same bytes, so the same bound) at
    the serve, mid and long contexts: the three times of ``three_times``,
    flash_decode_paged's event mean and device time a call in the same
    process, the plain version's event mean, and the event mean and
    device time a call on a table of 20-token spliced chunks (the
    rotation and the masks at work).  No library call computes this
    function."""
    t = {}
    for shape, (lengths, MB, iters) in PAGED_TIMING.items():
        q, kp, vp, bt, lens = decode_case(4, 8, 4, 128, 16, MB, lengths, seed=1)
        dl = torch.zeros_like(bt)
        vd = torch.where(bt >= 0, 16, 0).to(torch.int32)
        args = (q, kp, vp, bt, lens, dl, vd)
        kw = dict(rope_theta=500_000.0)
        r = three_times(lambda: fd.flash_decode_spliced(*args, **kw),
                        fd.flash_decode_spliced, iters)
        r["bound_ms"], r["bound_by"] = bound(*spliced_work(args))
        r["plain_ms"] = time_ms(lambda: ref.flash_decode_spliced_ref(*args, **kw),
                                max(iters // 10, 5))
        paged = lambda: fd.flash_decode_paged(q, kp, vp, bt, lens)
        r["paged_ms"], r["paged_device_ms"] = time_ms(paged, iters), device_ms(paged)
        sp = spliced_case(4, 8, 4, 128, 16, chunk_rows(lengths), 2, 60)
        spliced = lambda: fd.flash_decode_spliced(*sp, **kw)
        r["spliced_table_ms"] = time_ms(spliced, iters)
        r["spliced_table_device_ms"] = device_ms(spliced)
        r["spliced_table_bound_ms"] = bound(*spliced_work(sp))[0]
        r["library_ms"], r["lengths"] = None, lengths
        t[shape] = r
        phase("time", f"flash_decode_spliced {shape} (all-fresh table, lengths "
              f"{lengths}): " + describe(r) + f"; flash_decode_paged "
              f"{r['paged_ms']:.4f} ms ({r['paged_device_ms']:.4f} device) in the "
              f"same process; on a table of 20-token spliced chunks "
              f"{r['spliced_table_ms']:.4f} ms ({r['spliced_table_device_ms']:.4f} "
              f"device; bound {r['spliced_table_bound_ms']:.5f} ms); no library "
              f"call; on {smi}")
        del q, kp, vp, bt, lens, dl, vd, args, sp
    torch.cuda.empty_cache()
    return t


def spliced_aims(t: dict, parent: dict = None) -> list:
    """(aim, met, numbers) for the spliced timings ``t`` (as
    ``spliced_timing`` returns them): against flash_decode_paged in the
    same process, at the long context on both tables and at the serve
    shape by device time; with ``parent`` (the parent tree's timings),
    faster than the parent's kernel at the long context on both tables
    (device time a call)."""
    lg, sv = t["long"], t["serve"]
    aims = [
        (f"flash_decode_spliced, all-fresh table, long context: <= "
         f"{AIM_SPLICED_FRESH_OVER_PAGED}x flash_decode_paged, >= "
         f"{AIM_SPLICED_FRESH_BOUND_SHARE:.0%} of the byte bound",
         lg["ms"] <= AIM_SPLICED_FRESH_OVER_PAGED * lg["paged_ms"]
         and lg["bound_ms"] / lg["ms"] >= AIM_SPLICED_FRESH_BOUND_SHARE,
         f"{lg['ms']:.4f} ms, flash_decode_paged {lg['paged_ms']:.4f} ms "
         f"({lg['ms'] / lg['paged_ms']:.3f}x), {lg['bound_ms'] / lg['ms']:.1%} "
         "of the bound"),
        (f"flash_decode_spliced, 20-token chunks, long context: <= "
         f"{AIM_SPLICED_CHUNKS_OVER_PAGED}x flash_decode_paged",
         lg["spliced_table_ms"] <= AIM_SPLICED_CHUNKS_OVER_PAGED * lg["paged_ms"],
         f"{lg['spliced_table_ms']:.4f} ms, flash_decode_paged "
         f"{lg['paged_ms']:.4f} ms ({lg['spliced_table_ms'] / lg['paged_ms']:.3f}x)"),
        (f"flash_decode_spliced at the serve shape: device time a call <= "
         f"{AIM_SPLICED_SERVE_OVER_PAGED}x flash_decode_paged's",
         sv["device_ms"] <= AIM_SPLICED_SERVE_OVER_PAGED * sv["paged_device_ms"],
         f"{sv['device_ms']:.4f} ms against {sv['paged_device_ms']:.4f} ms "
         f"({sv['device_ms'] / sv['paged_device_ms']:.3f}x)")]
    if parent:
        for key, table in (("device_ms", "all-fresh table"),
                           ("spliced_table_device_ms", "20-token chunks")):
            mine, theirs = t["long"][key], parent["long"][key]
            aims.append((f"flash_decode_spliced, {table}, long context: device "
                         "time a call lower than the parent's", mine < theirs,
                         f"{mine:.4f} ms against {theirs:.4f} ms"))
    return aims


def spliced_bits(fd) -> dict:
    """The spliced kernel's output on every check case (bf16 and fp32)
    and both timing tables at the three contexts, and kernels 1 and 4's
    at their timing shapes and at G = 1..8 (bf16 and fp32), by label: the
    same seeded inputs whichever tree's kernels run them."""
    out = {}
    for shape, (lengths, MB, _) in PAGED_TIMING.items():
        out[f"flash_decode_paged timing {shape}"] = fd.flash_decode_paged(
            *decode_case(4, 8, 4, 128, 16, MB, lengths, seed=1)).cpu()
    for shape, (S, pos) in (("serve", (128, SERVE_POS)), ("mid", (2048, MID_POS)),
                            ("long", (8192, LONG_POS))):
        out[f"flash_decode timing {shape}"] = fd.flash_decode(
            *dense_case(4, S, 8, 4, 128, pos, seed=11)).cpu()
    for G in range(1, 9):
        for dtype in (torch.bfloat16, torch.float32):
            out[f"flash_decode_paged G={G}, {dtype}"] = fd.flash_decode_paged(
                *decode_case(3, 2, G, 64, 16, 40, [600, 97, 7], seed=G, dtype=dtype),
                window=0 if G % 2 else 300).cpu()
            out[f"flash_decode G={G}, {dtype}"] = fd.flash_decode(
                *dense_case(3, 700, 2, G, 64, [699, 96, 7], seed=G, dtype=dtype),
                window=0 if G % 2 else 300).cpu()
    for dtype in (torch.bfloat16, torch.float32):
        for label, frac, case in spliced_check_cases(dtype):
            out[f"{label}, {dtype}"] = fd.flash_decode_spliced(
                *case, rope_fraction=frac, rope_theta=500_000.0).cpu()
            del case
    for shape, (lengths, MB, _) in PAGED_TIMING.items():
        q, kp, vp, bt, lens = decode_case(4, 8, 4, 128, 16, MB, lengths, seed=1)
        fresh = (q, kp, vp, bt, lens, torch.zeros_like(bt),
                 torch.where(bt >= 0, 16, 0).to(torch.int32))
        sp = spliced_case(4, 8, 4, 128, 16, chunk_rows(lengths), 2, 60)
        for table, case in (("all-fresh", fresh), ("20-token chunks", sp)):
            out[f"timing {shape}, {table}"] = fd.flash_decode_spliced(
                *case, rope_theta=500_000.0).cpu()
        del q, kp, vp, bt, lens, fresh, sp
    torch.cuda.empty_cache()
    return out


# -- the decode kernels at the new configs' G, past 8 in tiles ----------------


def g_checks(fd, ref) -> tuple:
    """Kernels 1, 4 and the spliced kernel against their plain versions at
    each G of G_CASES (bf16; fp32 too past 8 rows): the serve shape with
    ragged lengths, an all-fresh spliced table (flash_decode_paged's bits)
    and one of spliced chunks; then granite-20b's G=48 at the long
    context, with a window across split boundaries, and on 20-token
    chunks.  atol=rtol=2e-3, one grid a call.  Returns the largest error
    of each kernel."""
    errs = {"paged": [], "dense": [], "spliced": []}
    for i, (label, KVH, G, Dh, frac) in enumerate(G_CASES):
        for dtype in ((torch.bfloat16, torch.float32) if G > 8
                      else (torch.bfloat16,)):
            tag = f"{label}, {'bf16' if dtype == torch.bfloat16 else 'fp32'}"
            errs["paged"].append(check_decode(fd, ref, decode_case(
                4, KVH, G, Dh, 16, 8, [128, 97, 40, 7], seed=90 + i, dtype=dtype),
                0, f"{tag}, serve lengths"))
            errs["dense"].append(check_dense(fd, ref, dense_case(
                4, 128, KVH, G, Dh, RAGGED_POS, seed=110 + i, dtype=dtype), 0,
                f"{tag}, ragged positions"))
            for table, chunks in (("all-fresh table", [[]] * 3),
                                  ("spliced chunks", [[21, 9, 40], [5, 5], [33]])):
                errs["spliced"].append(check_spliced(fd, ref, spliced_case(
                    3, KVH, G, Dh, 16, chunks, 4, 130 + i, dtype), frac,
                    f"{tag}, {table}"))
    KVH, G, Dh = G48
    errs["paged"] += [
        check_decode(fd, ref, decode_case(4, KVH, G, Dh, 16, 512, LONG_LENGTHS,
                                          seed=97), 0, "granite-20b G=48 long context"),
        check_decode(fd, ref, decode_case(4, KVH, G, Dh, 16, 128, MID_LENGTHS,
                                          seed=98), 300,
                     "G=48, window across split boundaries")]
    errs["dense"] += [
        check_dense(fd, ref, dense_case(4, 8192, KVH, G, Dh, LONG_POS, seed=99), 0,
                    "granite-20b G=48 long context"),
        check_dense(fd, ref, dense_case(4, 2048, KVH, G, Dh, MID_POS, seed=100), 300,
                    "G=48, window across split boundaries")]
    errs["spliced"].append(check_spliced(fd, ref, spliced_case(
        4, KVH, G, Dh, 16, chunk_rows(LONG_LENGTHS), 2, 101), 1.0,
        "granite-20b G=48 long context, 20-token chunks"))
    torch.cuda.empty_cache()
    return tuple(max(errs[k]) for k in ("paged", "dense", "spliced"))


def g48_timing(fd, ref, smi: str) -> dict:
    """Kernels 1, 4 and the spliced kernel (all-fresh table) at
    granite-20b's decode shape (B=4, KVH=1, G=48, Dh=128, page size 16)
    at the serve and long contexts: the three times of ``three_times``,
    the bound (at the long context P.V's fp32 operations, q.K counted at
    the tensor cores' bf16 rate), the plain version's
    event mean and, for flash_decode, SDPA's.  Returns {kernel: {shape:
    numbers}}."""
    KVH, G, Dh = G48
    t = {"flash_decode_paged": {}, "flash_decode": {}, "flash_decode_spliced": {}}
    for shape in ("serve", "long"):
        lengths, MB, iters = PAGED_TIMING[shape]
        q, kp, vp, bt, lens = decode_case(4, KVH, G, Dh, 16, MB, lengths, seed=1)
        fresh = (q, kp, vp, bt, lens, torch.zeros_like(bt),
                 torch.where(bt >= 0, 16, 0).to(torch.int32))
        for name, fn, plain, work in (
                ("flash_decode_paged", lambda: fd.flash_decode_paged(q, kp, vp, bt, lens),
                 lambda: ref.flash_decode_paged_ref(q, kp, vp, bt, lens),
                 decode_work(q, kp, bt, lens, 0)),
                ("flash_decode_spliced", lambda: fd.flash_decode_spliced(*fresh),
                 lambda: ref.flash_decode_spliced_ref(*fresh), spliced_work(fresh))):
            r = three_times(fn, getattr(fd, name), iters)
            r["bound_ms"], r["bound_by"] = bound(*work)
            r["plain_ms"] = time_ms(plain, max(iters // 10, 5))
            r["library_ms"], r["lengths"] = None, lengths
            t[name][shape] = r
            phase("time", f"{name} granite-20b {shape} (KVH=1, G=48, lengths "
                  f"{lengths}{', all-fresh table' if 'spliced' in name else ''}): "
                  + describe(r) + f" on {smi}")
        del q, kp, vp, bt, lens, fresh
    for shape, (S, pos, iters) in (("serve", (128, SERVE_POS, 200)),
                                   ("long", (8192, LONG_POS, 100))):
        case = dense_case(4, S, KVH, G, Dh, pos, seed=11)
        r = three_times(lambda: fd.flash_decode(*case), fd.flash_decode, iters)
        r["bound_ms"], r["bound_by"] = bound(*dense_work(case, 0))
        r["plain_ms"] = time_ms(lambda: ref.flash_decode_ref(*case), max(iters // 10, 5))
        lib = sdpa(case)
        r["library_ms"] = time_ms(lib, iters)
        want = ref.flash_decode_ref(*case)
        r["library_err"] = (lib().float().reshape(want.shape) - want).abs().max().item()
        r["pos"] = pos
        t["flash_decode"][shape] = r
        phase("time", f"flash_decode granite-20b {shape} (KVH=1, G=48, S={S}, pos "
              f"{pos}): " + describe(r) + f", sdpa {r['library_ms']:.4f} ms (bf16, "
              f"max_abs_err {r['library_err']:.2e}) on {smi}")
        del case, lib, want
    torch.cuda.empty_cache()
    return t


# -- gemma2 and minicpm3: kernel 4 softcapped, over a ring and over int8
#    K/V, and the MLA decode kernel ---------------------------------------------


def quant_case(case):
    """``case`` (q, k, v, pos) with k and v quantized as the reference's
    ``quantize_heads`` does: (q, k int8, v int8, k_scale, v_scale, pos)."""
    from repro_torch.models.attention import quantize_heads
    q, k, v, pos = case
    kq, ks = quantize_heads(k)
    vq, vs = quantize_heads(v)
    return q, kq, vq, ks, vs, pos


def quant_work(qcase, window=0):
    """(bytes, fp32 flops, bf16 flops) of the int8 kernel on ``qcase``:
    each live K/V row at a byte an element and its two bf16 scales, q and
    pos read once, the fp32 output written once; the products as over a
    bf16 cache (the rows are bf16 values once dequantized)."""
    q, kq, _, _, _, pos = qcase
    B, KVH, G, Dh = q.shape
    S = kq.shape[1]
    live = sum(max(0, min(p + 1, S) - (max(0, p + 1 - window) if window > 0
                                       else 0)) for p in pos.tolist())
    nbytes = (2 * live * KVH * (Dh + 2) + q.numel() * q.element_size()
              + pos.numel() * 4 + q.numel() * 4)
    return (nbytes, *attn_flops(q, torch.empty(0, dtype=torch.bfloat16),
                                live * KVH))


def check_quant(fd, ref, qcase, window, cap, label):
    before = fd.flash_decode_quant.launches
    out = fd.flash_decode_quant(*qcase, window=window, softcap=cap)
    want = ref.flash_decode_quant_ref(*qcase, window=window, softcap=cap)
    torch.cuda.synchronize()
    if fd.flash_decode_quant.launches != before + 1:
        fail(f"flash_decode_quant {label}: "
             f"{fd.flash_decode_quant.launches - before} grid launches, want 1")
    err = (out - want).abs().max().item()
    try:
        torch.testing.assert_close(out, want, atol=2e-3, rtol=2e-3)
    except AssertionError as e:
        fail(f"flash_decode_quant {label}: {e}")
    q, kq, _, _, _, pos = qcase
    phase("check", f"flash_decode_quant {label}: q {tuple(q.shape)} {q.dtype}, "
          f"int8 k/v {tuple(kq.shape)}, pos {pos.tolist()} window={window} "
          f"softcap={cap} max_abs_err={err:.3e} (atol=rtol=2e-3)")
    return err


def check_softcap(fd, ref, case, window, label, cap=GEMMA2_SOFTCAP):
    before = fd.flash_decode.launches
    out = fd.flash_decode(*case, window=window, softcap=cap)
    want = ref.flash_decode_ref(*case, window, cap)
    torch.cuda.synchronize()
    if fd.flash_decode.launches != before + 1:
        fail(f"flash_decode softcap {label}: "
             f"{fd.flash_decode.launches - before} grid launches, want 1")
    err = (out - want).abs().max().item()
    try:
        torch.testing.assert_close(out, want, atol=2e-3, rtol=2e-3)
    except AssertionError as e:
        fail(f"flash_decode softcap {label}: {e}")
    q, k, _, pos = case
    phase("check", f"flash_decode softcap={cap} {label}: q {tuple(q.shape)} "
          f"{q.dtype}, k/v {tuple(k.shape)} {k.dtype}, pos {pos.tolist()} "
          f"window={window} max_abs_err={err:.3e} (atol=rtol=2e-3)")
    return err


def ring_case(pos, W, seed, dtype=torch.bfloat16):
    """gemma2's local layer: q and a ring of W slots [B, W, KVH, Dh] as
    decode leaves it (slot p % W holds the newest position of that
    residue), with the full cache it was cut from; (full case, ring
    case) for flash_decode with window W and over the ring at min(pos,
    W - 1) with no window."""
    KVH, G, Dh = GEMMA2_SHAPE
    S = max(pos) + 1
    q, k, v, p = dense_case(len(pos), S, KVH, G, Dh, pos, seed, dtype)
    ring_k = torch.zeros((len(pos), W, KVH, Dh), dtype=dtype, device="cuda")
    ring_v = torch.zeros_like(ring_k)
    for b, pb in enumerate(pos):
        t = torch.arange(max(0, pb - W + 1), pb + 1, device="cuda")
        ring_k[b, t % W], ring_v[b, t % W] = k[b, t], v[b, t]
    return (q, k, v, p), (q, ring_k, ring_v, torch.clamp(p, max=W - 1))


def check_ring(fd, ref, pos, seed, dtype, label):
    """The ring through kernel 4 against the plain version over the full
    cache with window W (softcap 50): the positions the ring holds."""
    W = GEMMA2_WINDOW
    full, ring = ring_case(pos, W, seed, dtype)
    out = fd.flash_decode(*ring, softcap=GEMMA2_SOFTCAP)
    want = ref.flash_decode_ref(*full, W, GEMMA2_SOFTCAP)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    try:
        torch.testing.assert_close(out, want, atol=2e-3, rtol=2e-3)
    except AssertionError as e:
        fail(f"ring {label}: {e}")
    phase("check", f"flash_decode over a ring of {W} slots {label}: pos "
          f"{pos} (attends at {ring[3].tolist()}), {dtype}, against the full "
          f"cache with window {W}: max_abs_err={err:.3e} (atol=rtol=2e-3)")
    return err


def mla_case(B, S, H, R, Dr, pos, seed, dtype=torch.bfloat16):
    """MLA decode inputs on the card: q_abs [B,H,R], q_pe [B,H,Dr] fp32,
    the latent cache ckv [B,S,R], kpe [B,S,Dr] in ``dtype``, pos [B]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q_abs = torch.randn((B, H, R), generator=g, device="cuda")
    q_pe = torch.randn((B, H, Dr), generator=g, device="cuda")
    ckv = torch.randn((B, S, R), generator=g, device="cuda").to(dtype)
    kpe = torch.randn((B, S, Dr), generator=g, device="cuda").to(dtype)
    return q_abs, q_pe, ckv, kpe, torch.tensor(pos, dtype=torch.int32,
                                                device="cuda")


def mla_work(case):
    """(bytes, fp32 flops, bf16 flops): each live latent row (ckv and
    kpe) read once, the queries and pos read once, the fp32 latent
    written once; scores 2 H (R + Dr) and P . ckv 2 H R flops a live row,
    each with an fp32 operand (q, P).  Over a bf16 cache such a product
    counts as three bf16 tensor-core products (exact bf16 pieces of the
    fp32 operand times the bf16 cache: the kernel's split product); over
    fp32 it is fp32 work."""
    q_abs, q_pe, ckv, kpe, pos = case
    B, H, R = q_abs.shape
    S, Dr = ckv.shape[1], kpe.shape[2]
    live = sum(min(p + 1, S) for p in pos.tolist())
    nbytes = (live * (R + Dr) * ckv.element_size() + q_abs.numel() * 4
              + q_pe.numel() * 4 + pos.numel() * 4 + q_abs.numel() * 4)
    flops = 2 * H * live * (2 * R + Dr)
    if ckv.dtype == torch.bfloat16:
        return nbytes, 0.0, 3.0 * flops
    return nbytes, flops, 0.0


def mla_fp32_rate_bound(case) -> float:
    """The MLA kernel's bound with every product at the fp32 rate (ms),
    as it stood while the kernel ran on the CUDA cores."""
    nbytes, f32, bf = mla_work(case)
    return bound(nbytes, f32 + bf / 3.0)[0]


def check_mla(mla, ref, case, label):
    before = mla.mla_decode.launches
    out = mla.mla_decode(*case, MLA_SCALE)
    want = ref.mla_decode_ref(*case, MLA_SCALE)
    torch.cuda.synchronize()
    if mla.mla_decode.launches != before + 1:
        fail(f"mla_decode {label}: {mla.mla_decode.launches - before} grid "
             "launches, want 1")
    err = (out - want).abs().max().item()
    try:
        torch.testing.assert_close(out, want, atol=2e-3, rtol=2e-3)
    except AssertionError as e:
        fail(f"mla_decode {label}: {e}")
    q_abs, _, ckv, kpe, pos = case
    phase("check", f"mla_decode {label}: q_abs {tuple(q_abs.shape)}, ckv "
          f"{tuple(ckv.shape)} kpe {tuple(kpe.shape)} {ckv.dtype}, pos "
          f"{pos.tolist()} max_abs_err={err:.3e} (atol=rtol=2e-3)")
    return err


def gemma2_mla_checks(fd, mla, ref) -> tuple:
    """Phase 3's checks of this slice's kernels, each against its plain
    version on the card, bf16 and fp32 caches: kernel 4 softcapped (50)
    at gemma2's global shape (KVH 16, G 2, Dh 128) at the serve and long
    lengths and past G = 8 in tiles; the ring of W = 4096 through kernel
    4 below W - 1, at it and wrapped past 2W; the int8 variant at
    gemma2's shape (a row at pos 0; bf16 and fp32 q; the reduced
    config's Dh = 32, int8 rows of 32 bytes; a window past G = 8); the
    MLA kernel at minicpm3's (H 40, R 256, Dr 32) and the reduced (H 4,
    R 32, Dr 16) shapes at the serve and long lengths with pos 0.
    Returns the largest error of (softcapped and ring, int8, MLA)."""
    KVH, G, Dh = GEMMA2_SHAPE
    cap, quant, mla_errs = [], [], []
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        cap += [
            check_softcap(fd, ref, dense_case(4, 128, KVH, G, Dh, RAGGED_POS,
                                              seed=140, dtype=dtype), 0,
                          f"gemma2 {tag} serve, ragged"),
            check_softcap(fd, ref, dense_case(4, 8192, KVH, G, Dh, LONG_POS,
                                              seed=141, dtype=dtype), 0,
                          f"gemma2 {tag} long context"),
            check_softcap(fd, ref, dense_case(3, 300, 2, 12, 64, [299, 100, 0],
                                              seed=142, dtype=dtype), 40,
                          f"{tag} G=12 (tiles), window 40")]
        cap += [check_ring(fd, ref, pos, 143 + i, dtype, f"{tag}, {label}")
                for i, (pos, label) in enumerate((
                    ([100, 3000, 4094, 0], "below W - 1"),
                    ([4095, 4095, 4095, 4095], "at W - 1"),
                    ([9000, 8192, 8500, 4096], "wrapped past 2W")))]
        for qd in ((torch.bfloat16, torch.float32) if dtype == torch.float32
                   else (torch.bfloat16,)):
            qtag = f"q {'bf16' if qd == torch.bfloat16 else 'fp32'}"
            quant += [
                check_quant(fd, ref, quant_case(dense_case(
                    4, 128, KVH, G, Dh, [127, 96, 40, 0], seed=150, dtype=dtype,
                    q_dtype=qd)), 0, GEMMA2_SOFTCAP, f"gemma2 serve, {qtag}"),
                check_quant(fd, ref, quant_case(dense_case(
                    4, 8192, KVH, G, Dh, [8191, 6143, 4999, 0], seed=151,
                    dtype=dtype, q_dtype=qd)), 0, GEMMA2_SOFTCAP,
                    f"gemma2 long context, {qtag}")]
        quant += [
            check_quant(fd, ref, quant_case(dense_case(
                3, 100, 4, 1, 32, [99, 3, 0], seed=152, dtype=dtype)), 0,
                GEMMA2_SOFTCAP, f"reduced gemma2 Dh=32, {tag}"),
            check_quant(fd, ref, quant_case(dense_case(
                3, 300, 2, 12, 64, [299, 100, 5], seed=153, dtype=dtype)), 20,
                0.0, f"G=12, window 20, no softcap, {tag}")]
        for (H, R, Dr), name in ((MLA_SHAPE, "minicpm3"), (MLA_REDUCED, "reduced")):
            mla_errs += [
                check_mla(mla, ref, mla_case(4, 128, H, R, Dr, [127, 96, 40, 0],
                                             seed=160, dtype=dtype),
                          f"{name} {tag} serve"),
                check_mla(mla, ref, mla_case(4, 8192, H, R, Dr,
                                             [8191, 6143, 4999, 0], seed=161,
                                             dtype=dtype),
                          f"{name} {tag} long context")]
    torch.cuda.empty_cache()
    return max(cap), max(quant), max(mla_errs)


def check_dense_family(ttf, get_arch, arch, kv_quant=False) -> None:
    """The reduced ``arch`` (gemma2: 4 layers, window 8; minicpm3: MLA),
    fp32, 12 ``serve_step`` steps on the card against the CPU: the
    logits within 2e-3 every step (gemma2's rings wrap)."""
    cfg = get_arch(arch).reduced()
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                            dtype=torch.float32)
    card = ttf.Transformer(cfg, {n: p.detach().cuda()
                                 for n, p in model.named_parameters()})
    B, S = 3, 16
    cc = ttf.init_cache(cfg, B, S, torch.float32, device="cpu", kv_quant=kv_quant)
    gcache = {n: t.cuda() for n, t in cc.items()}
    g = torch.Generator().manual_seed(2)
    pos = torch.tensor([0, 2, 3], dtype=torch.int32)
    err = 0.0
    for _ in range(12):
        tok = torch.randint(0, cfg.vocab_size, (B,), generator=g,
                            dtype=torch.int32)
        want, cc = ttf.serve_step(model, cc, {"token": tok, "pos": pos},
                                  kv_quant=kv_quant)
        got, gcache = ttf.serve_step(card, gcache, {"token": tok.cuda(),
                                                    "pos": pos.cuda()},
                                     kv_quant=kv_quant)
        torch.cuda.synchronize()
        try:
            torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)
        except AssertionError as e:
            fail(f"serve_step (reduced {arch}, kv_quant={kv_quant}) card vs "
                 f"CPU: {e}")
        err = max(err, (got.cpu() - want).abs().max().item())
        pos = pos + 1
    phase("check", f"serve_step (reduced {cfg.name}, fp32, kv_quant="
          f"{kv_quant}) card vs CPU, 12 steps: logits max_abs_err={err:.3e} "
          "(atol=rtol=2e-3)")


def gemma2_mla_timing(fd, mla, ref, smi: str) -> dict:
    """Phase 7's timing of this slice's kernels, at B = 4 with every
    position live: kernel 4 softcapped at gemma2's global shape (S 128
    and 8192), the int8 variant there, the ring of W = 4096 (kernel 4 at
    S 4096), and the MLA kernel at minicpm3's shape (S 128 and 8192):
    the three times of ``three_times``, the bound, the plain version's
    event mean and the library call where one PyTorch call computes the
    function (SDPA for MLA; none takes a softcap or int8 rows).  Returns
    {name: {shape: numbers}}."""
    import torch.nn.functional as F
    KVH, G, Dh = GEMMA2_SHAPE
    t = {"flash_decode_softcap": {}, "flash_decode_quant": {},
         "flash_decode_ring": {}, "mla_decode": {}}
    for shape, S, iters in (("serve", 128, 200), ("long", 8192, 100)):
        pos = [S - 1] * 4
        case = dense_case(4, S, KVH, G, Dh, pos, seed=170)
        r = three_times(lambda: fd.flash_decode(*case, softcap=GEMMA2_SOFTCAP),
                        fd.flash_decode, iters)
        r["bound_ms"], r["bound_by"] = bound(*dense_work(case, 0))
        r["plain_ms"] = time_ms(lambda: ref.flash_decode_ref(
            *case, 0, GEMMA2_SOFTCAP), max(iters // 10, 5))
        r["library_ms"], r["pos"] = None, pos
        t["flash_decode_softcap"][shape] = r
        phase("time", f"flash_decode softcap=50 gemma2 {shape} (KVH 16, G 2, "
              f"Dh 128, S={S}, all live): " + describe(r)
              + f", library none (SDPA takes no softcap) on {smi}")
        qcase = quant_case(case)
        r = three_times(lambda: fd.flash_decode_quant(
            *qcase, softcap=GEMMA2_SOFTCAP), fd.flash_decode_quant, iters)
        r["bound_ms"], r["bound_by"] = bound(*quant_work(qcase))
        r["plain_ms"] = time_ms(lambda: ref.flash_decode_quant_ref(
            *qcase, softcap=GEMMA2_SOFTCAP), max(iters // 10, 5))
        r["library_ms"], r["pos"] = None, pos
        r["bf16_over_int8"] = t["flash_decode_softcap"][shape]["device_ms"] / r["device_ms"]
        t["flash_decode_quant"][shape] = r
        phase("time", f"flash_decode_quant gemma2 {shape} (int8 K/V, S={S}, "
              "all live, softcap 50): " + describe(r)
              + f"; the bf16 cache's device time {r['bf16_over_int8']:.2f}x; "
              f"library none (no call dequantizes rows) on {smi}")
        del case, qcase
        mcase = mla_case(4, S, *MLA_SHAPE, pos, seed=171)
        r = three_times(lambda: mla.mla_decode(*mcase, MLA_SCALE),
                        mla.mla_decode, iters)
        r["bound_ms"], r["bound_by"] = bound(*mla_work(mcase))
        r["fp32_rate_bound_ms"] = mla_fp32_rate_bound(mcase)
        r["plain_ms"] = time_ms(lambda: ref.mla_decode_ref(*mcase, MLA_SCALE),
                                max(iters // 10, 5))
        want = ref.mla_decode_ref(*mcase, MLA_SCALE)
        r["max_abs_err"] = (mla.mla_decode(*mcase, MLA_SCALE) - want).abs().max().item()
        q_abs, q_pe, ckv, kpe, p = mcase
        H = q_abs.shape[1]
        qs = torch.cat([q_abs, q_pe], -1)[:, :, None]            # [B, H, 1, R+Dr]
        ks = torch.cat([ckv, kpe], -1).float()[:, None]          # [B, 1, S, R+Dr]
        vs = ckv.float()[:, None]
        mask = (torch.arange(S, device="cuda")[None, :] <= p[:, None])[:, None, None]
        lib = lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=MLA_SCALE, enable_gqa=True)
        try:
            r["library_ms"] = time_ms(lib, iters)
            r["library_err"] = (lib()[:, :, 0] - want).abs().max().item()
            libtxt = (f"sdpa (fp32, one kv head broadcast over {H}) "
                      f"{r['library_ms']:.4f} ms, max_abs_err "
                      f"{r['library_err']:.2e}")
        except RuntimeError as e:
            r["library_ms"], r["library_none"] = None, str(e).splitlines()[0]
            libtxt = f"library none (sdpa refused: {r['library_none']})"
        r["pos"] = pos
        t["mla_decode"][shape] = r
        phase("time", f"mla_decode minicpm3 {shape} (H 40, R 256, Dr 32, S={S}, "
              "bf16 cache, all live): " + describe(r) + f"; the fp32-rate bound "
              f"{r['fp32_rate_bound_ms']:.5f} ms "
              f"({r['fp32_rate_bound_ms'] / r['ms']:.1%} of it), max_abs_err "
              f"{r['max_abs_err']:.2e} against the plain version, {libtxt} on {smi}")
        del mcase, qs, ks, vs, mask, lib, want
    W = GEMMA2_WINDOW
    _, ring = ring_case([W + 100] * 4, W, seed=172)
    r = three_times(lambda: fd.flash_decode(*ring, softcap=GEMMA2_SOFTCAP),
                    fd.flash_decode, 100)
    r["bound_ms"], r["bound_by"] = bound(*dense_work(ring, 0))
    r["plain_ms"] = time_ms(lambda: ref.flash_decode_ref(*ring, 0, GEMMA2_SOFTCAP), 10)
    r["library_ms"] = None
    t["flash_decode_ring"]["long"] = r
    phase("time", f"flash_decode over gemma2's ring (W={W}, full, softcap 50): "
          + describe(r) + f", library none (SDPA takes no softcap) on {smi}")
    del ring
    torch.cuda.empty_cache()
    return t


def gemma2_quant_steps(ttf, model, counted: dict, smi: str) -> dict:
    """gemma2-27b at full width (the model phase 6 served): 1 +
    GEMMA2_STEPS ``serve_step`` steps of a batch of 4 over an int8 split
    cache (``kv_quant=True``: the global layers' K/V int8 with bf16
    scales, the local rings bf16), then the same steps, the same
    tokens, over a bf16 cache holding the same contexts (random K/V, the
    int8 cache its ``quantize_heads``), and over a bf16 cache holding
    the int8 contexts dequantized (``dequantize_heads``), rows from
    GEMMA2_LENGTHS in a 128-position bucket; ms/step over the last
    GEMMA2_STEPS of each (no profiler runs here: a profiled session
    before the serves after it may slow their host side).  Fails
    unless the logits are finite, the int8 run launches
    flash_decode_quant and flash_decode L/2 grids a step each and each
    bf16 run flash_decode L, and nothing else.  Prints the logits'
    largest difference relative to their scale between the runs.
    Returns the runs' launches and numbers."""
    from repro_torch.models.attention import dequantize_heads, quantize_heads
    cfg = model.cfg
    B, S = len(GEMMA2_LENGTHS), 128
    steps = 1 + GEMMA2_STEPS
    g = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (steps, B), device="cuda",
                         generator=g, dtype=torch.int32)
    bf16 = ttf.init_cache(cfg, B, S, torch.bfloat16, device="cuda")
    for t in bf16.values():
        t.normal_(generator=g)
    i8 = ttf.init_cache(cfg, B, S, torch.bfloat16, device="cuda", kv_quant=True)
    deq = {name: t.clone() for name, t in bf16.items()}
    for name in ("k_local", "v_local"):
        i8[name].copy_(bf16[name])
    for name in ("k_global", "v_global"):
        i8[name], i8[name + "_scale"] = quantize_heads(bf16[name])
        deq[name] = dequantize_heads(i8[name], i8[name + "_scale"])
    half = cfg.num_layers // 2
    out = {}
    logits = {}
    for run, cache, kvq in (("int8", i8, True), ("bf16", bf16, False),
                            ("dequantized", deq, False)):
        pos = torch.tensor(GEMMA2_LENGTHS, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0
        seen = []
        for i in range(steps):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            lg, cache = ttf.serve_step(model, cache, {"token": toks[i], "pos": pos},
                                       kv_quant=kvq)
            seen.append(lg.float())
            pos = pos + 1
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / GEMMA2_STEPS
        launches = {name: fn.launches for name, fn in counted.items()}
        want = ({"flash_decode_quant": steps * half, "flash_decode": steps * half}
                if kvq else {"flash_decode": steps * cfg.num_layers})
        if any(launches[n] != want.get(n, 0) for n in launches):
            fail(f"gemma2 {run} cache steps launched {launches}, want {want}")
        lg = torch.stack(seen)
        if not torch.isfinite(lg).all():
            fail(f"gemma2 {run} cache steps: logits not finite")
        logits[run] = lg
        out[run] = {"ms_per_step": ms, "launches": launches}
        phase("serve", f"gemma2-27b {run} cache ({cfg.num_layers} layers, full "
              f"width, kv_quant={kvq}): {steps} serve_step steps of batch {B} "
              f"from contexts {GEMMA2_LENGTHS}, {ms:.2f} ms/step over the last "
              f"{GEMMA2_STEPS}; launches {launches} on {smi}")
        del cache
    diff = {}
    for a, b in (("int8", "bf16"), ("int8", "dequantized"),
                 ("dequantized", "bf16")):
        x, y = logits[a], logits[b]
        rel = ((x - y).abs().amax(dim=(1, 2)) / y.abs().amax(dim=(1, 2))).tolist()
        same = (x.argmax(-1) == y.argmax(-1)).float().mean().item()
        diff[f"{a}_vs_{b}"] = {"max": max(rel), "step0": rel[0], "argmax_equal": same}
        phase("serve", f"gemma2-27b kv_quant: logits of the {a} cache against "
              f"the {b} cache's on the same tokens: largest difference "
              f"{max(rel):.3e} of their scale (step 0 {rel[0]:.3e}), greedy "
              f"tokens equal in {same:.1%} of {steps * B}")
    out["logits"] = diff
    out["logits_rel_diff"] = diff["int8_vs_bf16"]["max"]
    out["argmax_equal"] = diff["int8_vs_bf16"]["argmax_equal"]
    phase("serve", f"gemma2-27b kv_quant: int8 {out['int8']['ms_per_step']:.2f} "
          f"against bf16 {out['bf16']['ms_per_step']:.2f} ms/step on {smi}")
    del i8, bf16, deq, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- the recurrent families: kernel 4 at zamba2's Dh = 80, their prefill -------


def zamba2_checks(fd, ref) -> float:
    """Phase 3's checks of kernel 4 at zamba2's shared attention (B 4,
    KVH 32, G 1, Dh 80), bf16 and fp32, against its plain version at
    atol = rtol = 2e-3: the serve lengths, ragged positions, the long
    context (S 8192), a window across split boundaries and pos 0.
    Returns the largest error."""
    KVH, G, Dh = ZAMBA2_SHAPE
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        for i, (S, pos, window, label) in enumerate((
                (128, ZAMBA2_SERVE_POS, 0, "serve lengths"),
                (128, RAGGED_POS, 0, "ragged positions"),
                (8192, LONG_POS, 0, "long context"),
                (2048, MID_POS, 300, "window across split boundaries"),
                (128, [0] * 4, 0, "pos 0"))):
            errs.append(check_dense(fd, ref, dense_case(
                4, S, KVH, G, Dh, pos, seed=170 + i, dtype=dtype), window,
                f"zamba2 Dh=80 {tag} {label}"))
    torch.cuda.empty_cache()
    return max(errs)


def check_recurrent_prefill(ttf, get_arch, arch) -> None:
    """``arch`` (rwkv6-3b or zamba2-2.7b) at full width and depth, fp32
    weights from seed 0: ``prefill`` of PREFILL_B x PREFILL_S tokens (two
    chunks of 128) on the card, against PREFILL_S ``serve_step`` steps
    from a zero cache over the same tokens: every state of the prefill's
    cache (RWKV6's shifts and wkv states; zamba2's shared-block K/V, conv
    inputs and SSD states) and the last logits within PREFILL_TOL of
    their largest value."""
    cfg = get_arch(arch)
    t0 = time.perf_counter()
    model = ttf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda", dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S), generator=g,
                         device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits, cache = ttf.prefill(model, {"tokens": toks})
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    steps = ttf.init_cache(cfg, PREFILL_B, PREFILL_S, torch.float32,
                           device="cuda")
    for t in range(PREFILL_S):
        pos = torch.full((PREFILL_B,), t, dtype=torch.int32, device="cuda")
        last, steps = ttf.serve_step(model, steps, {"token": toks[:, t],
                                                    "pos": pos})
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    if sorted(cache) != sorted(steps):
        fail(f"{arch} prefill cache {sorted(cache)}, steps {sorted(steps)}")
    rel = {}
    for name, want in (*cache.items(), ("logits", logits)):
        got = last if name == "logits" else steps[name]
        if tuple(got.shape) != tuple(want.shape) or not torch.isfinite(want).all():
            fail(f"{arch} prefill {name}: shape {tuple(want.shape)} against "
                 f"{tuple(got.shape)}, or not finite")
        rel[name] = ((got.float() - want.float()).abs().max()
                     / want.float().abs().max().clamp(min=1e-30)).item()
    phase("check", f"{arch} prefill (full width, {cfg.num_layers} layers, fp32, "
          f"B={PREFILL_B} S={PREFILL_S}, chunks of {cfg.ssm.chunk_size}) "
          "against its serve_step steps from zeros: largest error / largest "
          "value " + ", ".join(f"{n} {e:.2e}" for n, e in rel.items())
          + f" (tolerance {PREFILL_TOL:g}); prefill {t2 - t1:.3f} s, "
          f"{PREFILL_S} steps {t3 - t2:.2f} s, built in {t1 - t0:.1f} s")
    bad = {n: e for n, e in rel.items() if not e <= PREFILL_TOL}
    if bad:
        fail(f"{arch} prefill against its steps: {bad} above {PREFILL_TOL}")
    del model, cache, steps, logits, last
    gc.collect()
    torch.cuda.empty_cache()


def zamba2_timing(fd, ref, smi: str) -> dict:
    """Phase 7's timing of kernel 4 at zamba2's shape (B 4, KVH 32, G 1,
    Dh 80, bf16) at the serve lengths and at S = 8192, every position
    live: the three times, the bound, the plain version and SDPA (MHA,
    the position mask)."""
    KVH, G, Dh = ZAMBA2_SHAPE
    t = {}
    for shape, (S, pos, iters) in {"serve": (128, ZAMBA2_SERVE_POS, 200),
                                   "long": (8192, ZAMBA2_LONG_POS, 100)}.items():
        case = dense_case(4, S, KVH, G, Dh, pos, seed=180)
        r = three_times(lambda: fd.flash_decode(*case), fd.flash_decode, iters)
        r["bound_ms"], r["bound_by"] = bound(*dense_work(case, 0))
        r["plain_ms"] = time_ms(lambda: ref.flash_decode_ref(*case),
                                max(iters // 10, 5))
        lib = sdpa(case)
        r["library_ms"] = time_ms(lib, iters)
        want = ref.flash_decode_ref(*case)
        r["library_err"] = (lib().float().reshape(want.shape) - want
                            ).abs().max().item()
        r["pos"] = pos
        t[shape] = r
        phase("time", f"flash_decode zamba2 {shape} (KVH 32, G 1, Dh 80, S={S}, "
              f"pos {pos}): " + describe(r) + f", sdpa {r['library_ms']:.4f} ms "
              f"(bf16, max_abs_err {r['library_err']:.2e}) on {smi}")
        del case, lib, want
    torch.cuda.empty_cache()
    return t


# -- the MoE layer and the other families ---------------------------------------


def check_moe_layer(get_arch) -> None:
    """One MoE layer of granite-moe at full width (d 1536, 40 experts
    top-8, d_ff 512; fp32 weights at the reference's init scales) on the
    card against the same function on CPU tensors, for a decode step's 4
    rows (capacity 1) and a 64-token group (capacity 16): equal selected
    experts and kept (token, expert) pairs, the output within 1e-4 of
    its scale (fp32 products in another order), the aux loss within
    1e-5."""
    from repro_torch.models import moe
    cfg = get_arch("granite-moe-3b-a800m")
    d, E, F = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert
    g = torch.Generator().manual_seed(12)
    p = {"router": torch.randn(d, E, generator=g) / math.sqrt(d),
         "w_up": torch.randn(E, d, F, generator=g) / math.sqrt(E),
         "w_gate": torch.randn(E, d, F, generator=g) / math.sqrt(E),
         "w_down": torch.randn(E, F, d, generator=g) / math.sqrt(E)}
    pc = {k: v.cuda() for k, v in p.items()}
    for T in (4, 64):
        x = torch.randn(T, d, generator=g)
        want, waux = moe.moe_forward(p, x, cfg)
        rw = moe.route(p["router"], x, cfg)
        got, gaux = moe.moe_forward(pc, x.cuda(), cfg)
        rg = moe.route(pc["router"], x.cuda(), cfg)
        torch.cuda.synchronize()
        if not (torch.equal(rg.experts.cpu(), rw.experts)
                and torch.equal(rg.keep.cpu(), rw.keep)):
            fail(f"MoE layer, {T} tokens: the card selects or keeps other "
                 "experts than the CPU")
        err = (got.cpu() - want).abs().max().item()
        scale = want.abs().max().item()
        if err > 1e-4 * scale or abs(gaux.item() - waux.item()) > 1e-5:
            fail(f"MoE layer, {T} tokens: card vs CPU max_abs_err {err:.3e} "
                 f"(scale {scale:.3e}), aux {gaux.item()} vs {waux.item()}")
        phase("check", f"MoE layer (granite-moe full width, fp32) card vs CPU, "
              f"{T} tokens, capacity {rw.capacity}: equal experts "
              f"({int(rw.keep.sum())} of {rw.keep.numel()} picks kept), "
              f"max_abs_err {err:.3e} of scale {scale:.3e} (<= 1e-4 of it), "
              f"aux {gaux.item():.6f}")


SERVE_FIELDS = ("device", "arch", "layers", "retrieval", "decode", "continuous",
                "requests", "hits", "misses", "rounds_with_hits", "decode_tokens",
                "decode_steps", "decode_s", "tokens_per_s", "lookahead",
                "decode_waves", "retrievals", "latency_s", "copy_ms",
                "copy_bytes", "wall_s", "index_s", "bytes_h2d",
                "retrieval_gap", "pressure_stall_s")


def check_serve(path: str, summary: dict) -> None:
    """What every serve of phase 6 must show: 3 doc ids a round for
    every request, retrieval equal to the exact host search (bf16 pages
    allow a score gap below 1e-2) and a round with device hits."""
    for rid, rows in summary["doc_ids"].items():
        if not rows or any(len(row) != 3 or min(row) < 0 for row in rows):
            fail(f"{path} serve, request {rid}: doc ids per round {rows}, "
                 "want 3 each")
    if not summary["retrieval_gap"] < 1e-2:
        fail(f"{path} serve disagrees with the exact host search: score "
             f"gap {summary['retrieval_gap']} (bf16 pages allow < 1e-2)")
    if summary["rounds_with_hits"] < 1:
        fail(f"{path} serve: no round had device hits")


def family_serves(serve, setup, counted: dict, smi: str, after=None) -> dict:
    """Phase 6's serves of the other families (FAMILY_SERVES) through the
    port's entry point, on ``setup``'s datastore and index: each model
    built (random bf16 weights from seed 0, at full width; a depth cut
    printed) after the one before is freed, then served fused with paged
    decode (and granite-20b again with dense decode; gemma2 and minicpm3
    decode dense whatever the engine asks, as do rwkv6 and zamba2).  Each
    serve must pass ``check_serve``, launch its decode kernel
    (flash_decode_paged, flash_decode, or mla_decode for MLA) exactly
    one grid per layer per step (zamba2: flash_decode one grid per
    group per step; rwkv6: no decode kernel at all) and
    ``probe_topk_fused``, and no kernel of another path, and
    replay through the happens-before checker with 0 violations; it
    prints ms/step and tokens/s.  ``after`` maps an arch to a function
    of its model run after its serves, whose result is kept under the
    arch's name.  Frees the last model and ``setup.model``.  Returns the
    launches by path and those results."""
    launches, extra = {}, {}
    setup.model = None
    for arch, layers, engines in FAMILY_SERVES:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        args = argparse.Namespace(**{**vars(setup.args), "arch": arch,
                                     "layers": layers})
        cfg, model = serve.build_model(args, setup.device)
        fam = dataclasses.replace(setup, args=args, arch=cfg, model=model)
        del model
        torch.cuda.synchronize()
        cfg = fam.arch
        phase("serve", f"{arch}: {cfg.num_layers} layers"
              + (f" (cut from {serve.get_arch(arch).num_layers})" if layers else "")
              + f", d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
              f"heads of {cfg.resolved_head_dim}, "
              + (f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} d_ff "
                 f"{cfg.moe.d_ff_expert}" if cfg.moe else
                 f"{'gated' if cfg.mlp_gated else 'plain'} {cfg.mlp_act} MLP "
                 f"d_ff {cfg.d_ff}")
              + f", vocab {cfg.vocab_size}: {sum(p.numel() for p in fam.model.parameters()) / 1e9:.3f} B "
              f"parameters, {torch.cuda.memory_allocated() / 1e9:.1f} GB on the "
              f"card, built in {time.perf_counter() - t0:.1f} s")
        for engine in engines:
            path = arch + (" dense" if engine.get("paged_decode") is False
                           else "")
            for fn in counted.values():
                fn.launches = 0
            summary = serve.serve(fam, **engine)
            launches[path] = {n: fn.launches for n, fn in counted.items()}
            phase("serve", json.dumps({"path": path, **{k: summary[k] for k in
                                                        SERVE_FIELDS}}))
            check_serve(path, summary)
            kind = serve.tf.family_kind(cfg)
            kernel = (None if kind == "rwkv6" else "mla_decode"
                      if cfg.attn_kind == "mla" else "flash_decode"
                      if summary["decode"] == "dense" else "flash_decode_paged")
            if kind == "zamba2":
                check_decode_launches(path, kernel, summary, launches[path],
                                      serve.tf.zamba2_groups(cfg)[0], "groups")
            elif kernel:
                check_decode_launches(path, kernel, summary, launches[path],
                                      cfg.num_layers)
            elif summary["decode_steps"] < 1:
                fail(f"{path} serve: no decode step")
            else:
                phase("check", f"{path} serve: no decode kernel in "
                      f"{summary['decode_steps']} steps (attention-free)")
            other = [n for n in counted if n not in (kernel, "probe_topk_fused")]
            if launches[path]["probe_topk_fused"] < 1 or any(
                    launches[path][n] for n in other):
                fail(f"the {path} serve launched {launches[path]}: want "
                     f"probe_topk_fused and {kernel or 'no decode kernel'} "
                     "only")
            phase("kernels", json.dumps({"path": path, **launches[path]}))
            check_invariants(path, summary)
            steps = summary["decode_steps"]
            phase("serve", f"{path}: {1e3 * summary['decode_s'] / steps:.2f} ms/step, "
                  f"{summary['tokens_per_s']:.1f} tokens/s ({summary['decode_tokens']} "
                  f"tokens in {steps} steps, {cfg.num_layers} layers), wall "
                  f"{summary['wall_s']:.2f} s on {smi}")
            del summary
        if after and arch in after:
            extra[arch] = after[arch](fam.model)
        fam.model = None
        del fam
    gc.collect()
    torch.cuda.empty_cache()
    return launches, extra


def musicgen_steps(ttf, get_arch, counted: dict, smi: str) -> dict:
    """musicgen-large at full width (48 layers, MHA: G = 1, 4 codebooks of
    2048): 1 + MUSICGEN_STEPS greedy ``serve_step_paged`` steps for a
    batch of 4 rows over a page slab of random bf16 K/V, the rows'
    contexts starting at MUSICGEN_LENGTHS, tokens [B, 4]; ms/step over
    the last MUSICGEN_STEPS.  The logits must be finite of shape [B, 4,
    2048], flash_decode_paged must launch one grid per layer per step and
    no other kernel may launch.  Returns the launches of every kernel in
    ``counted``, all counts set to 0 just before the steps and read just
    after."""
    cfg = get_arch("musicgen-large")
    model = ttf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    B, ps = len(MUSICGEN_LENGTHS), 16
    steps = 1 + MUSICGEN_STEPS
    MB = -(-(max(MUSICGEN_LENGTHS) + steps) // ps)
    nc = ttf.codebooks(cfg)
    g = torch.Generator(device="cuda").manual_seed(3)
    shape = (cfg.num_layers, B * MB, ps, cfg.num_kv_heads, cfg.resolved_head_dim)
    k = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    bt = torch.arange(B * MB, dtype=torch.int32, device="cuda").reshape(B, MB)
    lens = torch.tensor(MUSICGEN_LENGTHS, dtype=torch.int32, device="cuda")
    tok = torch.randint(0, cfg.vocab_size, (B, nc), device="cuda", generator=g,
                        dtype=torch.int32)
    torch.cuda.synchronize()
    for fn in counted.values():
        fn.launches = 0
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        logits, _, _ = ttf.serve_step_paged(model, k, v, bt, lens, {"token": tok})
        lens += 1
        tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / MUSICGEN_STEPS
    launches = {name: fn.launches for name, fn in counted.items()}
    n = launches["flash_decode_paged"]
    want = (B, nc, cfg.vocab_size)
    if tuple(logits.shape) != want or not torch.isfinite(logits).all():
        fail(f"musicgen: logits {tuple(logits.shape)} (want {want}), finite "
             f"{bool(torch.isfinite(logits).all())}")
    if n != steps * cfg.num_layers:
        fail(f"musicgen: flash_decode_paged made {n} grid launches in "
             f"{steps} steps, want {steps * cfg.num_layers}")
    if any(c for name, c in launches.items() if name != "flash_decode_paged"):
        fail(f"musicgen launched {launches}: want flash_decode_paged only")
    phase("serve", f"musicgen-large ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads: G=1, {nc} codebooks of "
          f"{cfg.vocab_size}): {steps} serve_step_paged steps of batch {B} "
          f"from contexts {MUSICGEN_LENGTHS}, logits {tuple(logits.shape)} "
          f"finite, {n} grid launches = {steps} x {cfg.num_layers}, "
          f"{ms:.2f} ms/step over the last {MUSICGEN_STEPS} on {smi}")
    del model, k, v, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- kernel 5: centroid_scores --------------------------------------------------


def centroid_case(B, d, Nc, invalid, seed):
    """Tie-free centroid-probe inputs on the card: gaussian queries and
    centroids, a share ``invalid`` of the centroids masked out."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, d), generator=g, device="cuda")
    cent = torch.randn((Nc, d), generator=g, device="cuda")
    valid = torch.rand((Nc,), generator=g, device="cuda") >= invalid
    return q, cent, valid


def centroid_work(case):
    """(bytes, flops) this input needs: the queries, the valid flags and
    every valid centroid row read once, the [B, Nc] scores written once;
    2 * d flops per (query, valid centroid)."""
    q, cent, valid = case
    B, d = q.shape
    Nc, nv = cent.shape[0], int(valid.sum().item())
    return (q.numel() * 4 + Nc + nv * d * 4 + B * Nc * 4), 2 * B * nv * d


def check_centroid(cp, ops, ref, case, nprobe, label):
    """Kernel 5 against its plain version: the scores within rtol=1e-4
    (fp32 dots summed in another order; atol=1e-6 sqrt(d) for the scores
    near 0), -inf where invalid, and through ops.centroid_probe the plain
    version's top-``nprobe`` ids and their scores (rtol=1e-4,
    atol=1e-6)."""
    q, cent, valid = case
    before = cp.centroid_scores.launches
    got = cp.centroid_scores(q, cent, valid)
    want = ref.centroid_probe_ref(cent, q, valid)
    gs, gi = ops.centroid_probe(cent, q, nprobe, valid=valid)
    ws, wi = torch.topk(want, nprobe, dim=-1)
    torch.cuda.synchronize()
    if cp.centroid_scores.launches != before + 2:
        fail(f"centroid_scores {label}: {cp.centroid_scores.launches - before} "
             "launches for two calls")
    if not torch.equal(gi, wi):
        fail(f"centroid_scores {label}: top-{nprobe} ids differ\n{gi}\n{wi}")
    try:   # a score near 0 keeps the rounding of its d products: atol 1e-6 sqrt(d)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * q.shape[1] ** 0.5)
        torch.testing.assert_close(gs, ws, rtol=1e-4, atol=1e-6)
    except AssertionError as e:
        fail(f"centroid_scores {label}: {e}")
    fin = torch.isfinite(want)
    err = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
    B, d = q.shape
    plan = cp._plan(B, d, cent.shape[0], cp._sm_count(q.device.index),
                    q.data_ptr() % 16 == 0 and cent.data_ptr() % 16 == 0)
    nv = cent.shape[0] if valid is None else int(valid.sum())
    phase("check", f"centroid_scores {label}: B={B} d={d} Nc={cent.shape[0]} "
          f"({cent.shape[0] - nv} invalid{', valid=None' if valid is None else ''}) "
          f"nprobe={nprobe}: top-k ids equal, max_abs_err={err:.3e} (rtol=1e-4); "
          f"{'16-byte' if plan.vec else '4-byte'} loads, groups of <= "
          f"{plan.group}, {plan.blocks} blocks of {plan.warps} warps, "
          f"{plan.qb} queries staged at once")
    return err


def centroid_checks(cp, ops, ref) -> float:
    """Every case of kernel 5's check phase; the largest error."""
    g = torch.Generator(device="cuda").manual_seed(31)
    flat = torch.randn((4 * 768 + 1,), generator=g, device="cuda")
    sliced = (flat[1:].view(4, 768), *centroid_case(1, 768, 1024, 0.1, 32)[1:])
    q, cent, _ = centroid_case(3, 256, 500, 0.0, 33)
    cases = [
        ("serve probe shape", centroid_case(4, 768, 1024, 0.0, 20), 64),
        ("odd shape", centroid_case(5, 30, 203, 0.15, 21), 9),
        ("d=770 (4-byte loads)", centroid_case(4, 770, 1024, 0.1, 22), 64),
        ("d=12288", centroid_case(2, 12_288, 300, 0.1, 23), 16),
        ("B=1", centroid_case(1, 768, 1024, 0.1, 24), 64),
        ("B=5", centroid_case(5, 768, 1024, 0.1, 25), 64),
        ("B=33", centroid_case(33, 768, 1024, 0.1, 26), 64),
        ("Nc=1", centroid_case(4, 768, 1, 0.0, 27), 1),
        ("Nc=1000", centroid_case(4, 768, 1000, 0.1, 28), 64),
        ("Nc=4096 (the paper's scale)", centroid_case(4, 768, 4096, 0.05, 29), 256),
        ("every centroid invalid", centroid_case(4, 768, 64, 1.0, 30), 8),
        ("a sliced query off a 16-byte boundary", sliced, 64),
        ("valid=None", (q, cent, None), 32),
    ]
    return max(check_centroid(cp, ops, ref, case, nprobe, label)
               for label, case, nprobe in cases)


def centroid_timing(cp, ref, smi: str) -> dict:
    """Kernel 5 at B=4, d=768 over Nc=1024 (the serve probe) and 4096
    (the paper's scale), every centroid valid: the three times of
    ``three_times``, the cold device time a call (L2 flushed before each
    call), the bound, the plain version's event mean, and the library
    call (q @ c.T then masked_fill_, full fp32; the port never calls it)
    timed the same three ways.  Returns {shape: numbers}."""
    flush = torch.empty((FLUSH_BYTES // 4,), device="cuda")
    t = {}
    for shape, Nc in CENTROID_TIMING.items():
        case = centroid_case(4, 768, Nc, 0.0, seed=20)
        q, cent, valid = case
        fn = lambda: cp.centroid_scores(q, cent, valid)
        r = three_times(fn, cp.centroid_scores, 200)
        r["cold_ms"] = cold_ms(fn, flush)
        r["bound_ms"], r["bound_by"] = bound(*centroid_work(case))
        r["plain_ms"] = time_ms(lambda: ref.centroid_probe_ref(cent, q, valid), 200)
        lib = lambda: (q @ cent.T).masked_fill_(~valid[None, :], float("-inf"))
        r["library_ms"] = time_ms(lib, 200)
        r["library_device_ms"] = device_ms(lib)
        r["library_cold_ms"] = cold_ms(lib, flush)
        r["shape"] = [4, 768, Nc]
        t[shape] = r
        phase("time", f"centroid_scores {shape} (B=4, d=768, Nc={Nc}): "
              + describe(r) + f", cold {r['cold_ms']:.4f} ms device a call "
              f"({r['bound_ms'] / r['cold_ms']:.1%} of the bound); q @ c.T + "
              f"masked_fill_ {r['library_ms']:.4f} ms (events), "
              f"{r['library_device_ms']:.4f} device, {r['library_cold_ms']:.4f} "
              f"cold; on {smi}")
        del case, q, cent, valid
    del flush
    torch.cuda.empty_cache()
    return t


def centroid_aims(t: dict, parent: list = None) -> list:
    """(aim, met, numbers) for kernel 5's timings ``t``: no slower than
    the library call in every mode (event mean, device time, cold) at
    both shapes; cold at the paper's scale at least 40% of the bound;
    with ``parent`` (the parent's timings, one per run), faster than the
    parent's kernel in every mode at both shapes, in every run."""
    modes = (("ms", "library_ms", "event mean"),
             ("device_ms", "library_device_ms", "device time a call"),
             ("cold_ms", "library_cold_ms", "cold device time a call"))
    aims = []
    for shape, r in t.items():
        for mine, lib, what in modes:
            aims.append((f"centroid_scores {shape}: {what} no slower than q @ c.T "
                         "+ masked_fill_", r[mine] <= r[lib],
                         f"{r[mine]:.4f} ms against {r[lib]:.4f} ms"))
    pp = t["paper"]
    aims.append((f"centroid_scores paper scale, cold: >= "
                 f"{AIM_CENTROID_COLD_BOUND_SHARE:.0%} of the bound",
                 pp["bound_ms"] / pp["cold_ms"] >= AIM_CENTROID_COLD_BOUND_SHARE,
                 f"{pp['cold_ms']:.4f} ms, bound {pp['bound_ms']:.5f} ms "
                 f"({pp['bound_ms'] / pp['cold_ms']:.1%})"))
    for shape in (t if parent else ()):
        for mine, _, what in modes:
            theirs = [p[shape][mine] for p in parent]
            aims.append((f"centroid_scores {shape}: {what} lower than the "
                         "parent's in every run", t[shape][mine] < min(theirs),
                         f"{t[shape][mine]:.4f} ms against "
                         + ", ".join(f"{x:.4f}" for x in theirs)))
    return aims


# -- kernel 2: probe_topk_fused -----------------------------------------------


def retrieval_case(B, d, Nc, P, ps, seed):
    """Tie-free fused-retrieval inputs on the card: gaussian queries,
    centroids and bf16 pages, unique ids with one padded page tail, and a
    random slot->cluster map with unsearchable (-1) slots."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, d), generator=g, device="cuda")
    cent = torch.randn((Nc, d), generator=g, device="cuda")
    valid = torch.rand((Nc,), generator=g, device="cuda") > 0.05
    pages = torch.randn((P, ps, d), generator=g, device="cuda").to(torch.bfloat16)
    pids = torch.randperm(P * ps, generator=g, device="cuda").to(torch.int32)
    pids = pids.reshape(P, ps)
    pids[0, ps // 2:] = -1
    pc = torch.randint(-1, Nc, (P,), generator=g, device="cuda",
                       dtype=torch.int32)
    return q, cent, valid, pages, pids, pc


def retrieval_work(ref, case, nprobe, k):
    """(bytes, flops) this input needs: queries, centroids, valid flags,
    the slot->cluster map, and the ids and vectors of every page some
    query admits, read once; each admitted (query, page) pair's dots."""
    q, cent, valid, pages, pids, pc = case
    B, d = q.shape
    P, ps = pids.shape
    s = ref.centroid_probe_ref(cent, q, valid)
    top_s, top_i = torch.topk(s, nprobe, dim=-1)
    lut = torch.zeros_like(s, dtype=torch.bool)
    lut.scatter_(1, top_i, torch.isfinite(top_s))
    adm = (pc >= 0)[None, :] & lut[:, pc.long().clamp(min=0)]     # [B, P]
    pages_any = adm.any(0).sum().item()
    pairs = adm.sum().item()
    nbytes = (q.numel() * 4 + cent.numel() * 4 + valid.numel() + P * 4
              + pages_any * ps * (d * pages.element_size() + 4) + B * k * 8)
    flops = 2 * B * cent.shape[0] * d + 2 * pairs * ps * d
    return nbytes, flops, pages_any


def stable_ids(scores, ids, k):
    """Ids of the top-k of masked scores [B, P * ps] by (score desc, flat
    position asc): the order the kernels and the Pallas kernels break
    exact ties in (torch.topk keeps no order among ties)."""
    top_s, top_p = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s, top_p = top_s[:, :k], top_p[:, :k]
    return torch.where(torch.isfinite(top_s), ids.reshape(-1)[top_p],
                       -1).to(torch.int32)


def masked_scores(pages, ids, mask, q):
    """q . x over every row of every page, -inf where the [B, P] mask
    does not admit the page or the row's id is -1."""
    P, ps, d = pages.shape
    s = q @ pages.reshape(P * ps, d).float().T
    ok = mask.repeat_interleave(ps, dim=1) & (ids.reshape(-1) >= 0)[None]
    return s.masked_fill(~ok, float("-inf"))


def check_retrieval(pt, ref, case, nprobe, k, label, ties=False):
    """Kernel 2 against its plain version: equal ids (by flat position
    among exact ties when ``ties``), equal admitted clusters, scores
    within rtol=1e-4; a second call must give equal bits."""
    out_s, out_i, out_adm = pt.probe_topk_fused(*case, nprobe=nprobe, k=k)
    want_s, want_i, want_adm = ref.probe_and_topk_ref(*case, nprobe, k)
    again = pt.probe_topk_fused(*case, nprobe=nprobe, k=k)
    torch.cuda.synchronize()
    q, cent, _, pages, pids, pc = case
    if ties:
        mask = (pc >= 0)[None, :] & want_adm[:, pc.long().clamp(min=0)]
        want_i = stable_ids(masked_scores(pages, pids, mask, q), pids, k)
    if not torch.equal(out_i, want_i):
        fail(f"probe_topk_fused {label}: ids differ\n{out_i}\n{want_i}")
    if not torch.equal(out_adm, want_adm):
        fail(f"probe_topk_fused {label}: admitted clusters differ")
    try:
        torch.testing.assert_close(out_s, want_s, rtol=1e-4, atol=1e-6)
    except AssertionError as e:
        fail(f"probe_topk_fused {label}: {e}")
    if not all(torch.equal(a, b) for a, b in zip(again, (out_s, out_i, out_adm))):
        fail(f"probe_topk_fused {label}: a second call gave other bits")
    fin = torch.isfinite(want_s)
    err = (out_s[fin] - want_s[fin]).abs().max().item() if fin.any() else 0.0
    phase("check", f"probe_topk_fused {label}: B={q.shape[0]} d={q.shape[1]} "
          f"Nc={cent.shape[0]} P={pages.shape[0]} ps={pages.shape[1]} "
          f"nprobe={nprobe} k={k}: ids and admitted clusters equal"
          f"{' (ties by flat position)' if ties else ''}, equal bits twice, "
          f"max_abs_err={err:.3e} (rtol=1e-4)")
    return err


def retrieval_edges(pt, ref):
    """Kernel 2 at its edges: every page dead, one live page, every live
    page in one cluster, B = 9, page sizes 48 and 7 with d = 60 (the
    direct path), and rows duplicated across pages (exact ties)."""
    errs = []
    for label, (B, d, Nc, P, ps, nprobe, k) in (
            ("every page dead", (4, 768, 256, 64, 128, 16, 3)),
            ("one live page", (4, 768, 256, 64, 128, 16, 3)),
            ("every live page in one cluster", (4, 768, 256, 300, 128, 8, 3)),
            ("B=9", (9, 768, 512, 200, 128, 32, 3)),
            ("page size 48", (4, 128, 64, 30, 48, 8, 5)),
            ("page size 7, d=60 (direct path)", (3, 60, 48, 40, 7, 9, 4)),
            ("rows duplicated across pages", (4, 256, 32, 40, 16, 8, 6))):
        q, cent, valid, pages, pids, pc = retrieval_case(B, d, Nc, P, ps,
                                                         seed=P + ps + d)
        best0 = int(torch.argmax(torch.where(valid, q[0] @ cent.T,
                                             float("-inf"))))
        if label == "every page dead":
            pc[:] = -1
        elif label == "one live page":
            pc[:] = -1
            pc[7] = best0
        elif label == "every live page in one cluster":
            pc[:] = -1
            pc[P // 3:P // 3 + 120] = best0
        elif label.startswith("rows duplicated"):
            pages[P - 1] = pages[0]
            pages[P // 2] = pages[3]
            pages[2, ps - 1] = pages[2, 0]
        case = (q, cent, valid, pages, pids, pc)
        errs.append(check_retrieval(pt, ref, case, nprobe, k, label,
                                    ties=label.startswith("rows duplicated")))
    return errs


# -- kernel 3: ivf_topk ---------------------------------------------------------


def ivf_case(B, d, P, ps, seed, admit=0.2, empty_row=False):
    """Tie-free unfused-retrieval inputs on the card: gaussian queries and
    bf16 pages, unique ids with one padded page tail, and a per-query
    page mask admitting about ``admit`` of the pages (none for query 0
    when ``empty_row``)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, d), generator=g, device="cuda")
    pages = torch.randn((P, ps, d), generator=g, device="cuda").to(torch.bfloat16)
    pids = torch.randperm(P * ps, generator=g, device="cuda").to(torch.int32)
    pids = pids.reshape(P, ps)
    pids[0, ps // 2:] = -1
    mask = torch.rand((B, P), generator=g, device="cuda") < admit
    if empty_row:
        mask[0] = False
    return pages, pids, mask, q


def ivf_work(case, k):
    """(bytes, flops, pages read) this input needs: queries and the mask,
    and the ids and vectors of every page some query admits, read once;
    the [B, k] outputs written once; each admitted (query, page) pair's
    dots."""
    pages, pids, mask, q = case
    B, d = q.shape
    P, ps = pids.shape
    pages_any = mask.any(0).sum().item()
    nbytes = (q.numel() * 4 + mask.numel()
              + pages_any * ps * (d * pages.element_size() + 4) + B * k * 8)
    return nbytes, 2 * mask.sum().item() * ps * d, pages_any


def check_ivf(it, ref, case, k, label, ties=False):
    """Kernel 3 against its plain version: equal ids (by flat position
    among exact ties when ``ties``), scores within rtol=1e-4; a second
    call must give equal bits."""
    out_s, out_i = it.ivf_topk(*case, k)
    want_s, want_i = ref.ivf_topk_ref(*case, k)
    again = it.ivf_topk(*case, k)
    torch.cuda.synchronize()
    pages, pids, mask, q = case
    if ties:
        want_i = stable_ids(masked_scores(pages, pids, mask, q), pids, k)
    if not torch.equal(out_i, want_i):
        fail(f"ivf_topk {label}: ids differ\n{out_i}\n{want_i}")
    try:
        torch.testing.assert_close(out_s, want_s, rtol=1e-4, atol=1e-6)
    except AssertionError as e:
        fail(f"ivf_topk {label}: {e}")
    if not (torch.equal(again[0], out_s) and torch.equal(again[1], out_i)):
        fail(f"ivf_topk {label}: a second call gave other bits")
    fin = torch.isfinite(want_s)
    err = (out_s[fin] - want_s[fin]).abs().max().item() if fin.any() else 0.0
    empty = int((~mask.any(1)).sum().item())
    phase("check", f"ivf_topk {label}: B={q.shape[0]} d={q.shape[1]} "
          f"P={pages.shape[0]} ps={pages.shape[1]} k={k}, "
          f"{mask.float().mean().item():.1%} of pages admitted, {empty} "
          f"query(ies) with none: ids equal"
          f"{' (ties by flat position)' if ties else ''}, equal bits twice, "
          f"max_abs_err={err:.3e} (rtol=1e-4)")
    return err


def ivf_edges(it, ref):
    """Kernel 3 at its edges: every page dead, one live page, page sizes
    48 and 7 with d = 60 and a slab off a 16-byte boundary (the direct
    path), rows duplicated across pages (exact ties), and B = 9 at
    d = 768 (two passes of queries)."""
    errs = []
    for label, (B, d, P, ps, k) in (
            ("every page dead", (4, 768, 64, 128, 3)),
            ("one live page", (4, 768, 64, 128, 3)),
            ("page size 48", (4, 128, 30, 48, 5)),
            ("page size 7, d=60 (direct path)", (3, 60, 40, 7, 4)),
            ("slab off a 16-byte boundary (direct path)", (4, 768, 40, 128, 3)),
            ("rows duplicated across pages", (4, 256, 24, 16, 6)),
            ("B=9 (two passes)", (9, 768, 120, 128, 3))):
        pages, pids, mask, q = ivf_case(B, d, P, ps, seed=P + ps + d,
                                        admit=0.3)
        if label == "every page dead":
            mask[:] = False
        elif label == "one live page":
            mask[:] = False
            mask[1:, 5] = True
        elif label.startswith("slab off"):
            buf = torch.empty(pages.numel() + 1, dtype=pages.dtype,
                              device="cuda")
            pages = buf[1:].view(P, ps, d).copy_(pages)
        elif label.startswith("rows duplicated"):
            pages[P - 1] = pages[0]
            pages[P // 2] = pages[3]
            pages[2, ps - 1] = pages[2, 0]
            mask[:, [0, 2, 3, P // 2, P - 1]] = True
        errs.append(check_ivf(it, ref, (pages, pids, mask, q), k, label,
                              ties=label.startswith("rows duplicated")))
    return errs


def retrieval_timing(pt, it, ref, smi: str) -> dict:
    """Kernels 2 and 3 at the serve shapes: the three times of
    ``three_times``, the grids a call (profiler), the bound, the plain
    version's event mean and the pages admitted.  Returns {kernel:
    numbers}, one line printed for each."""
    t = {}
    case = retrieval_case(4, 768, 1024, POOL_PAGES, 128, seed=4)
    fn = lambda: pt.probe_topk_fused(*case, nprobe=64, k=3)
    r = three_times(fn, pt.probe_topk_fused, 50)
    r["grids_per_call"] = grids(fn)
    nbytes, flops, r["pages_admitted"] = retrieval_work(ref, case, 64, 3)
    r["bound_ms"], r["bound_by"] = bound(nbytes, flops)
    r["plain_ms"] = time_ms(lambda: ref.probe_and_topk_ref(*case, 64, 3), 10)
    r["library_ms"] = None
    t["probe_topk_fused"] = r
    phase("time", f"probe_topk_fused ({r['pages_admitted']} of {POOL_PAGES} "
          "pages admitted): " + describe(r) + f" on {smi}")
    del case
    case = ivf_case(4, 768, POOL_PAGES, 128, seed=8)
    fn = lambda: it.ivf_topk(*case, 3)
    r = three_times(fn, it.ivf_topk, 50)
    r["grids_per_call"] = grids(fn)
    nbytes, flops, r["pages_admitted"] = ivf_work(case, 3)
    r["bound_ms"], r["bound_by"] = bound(nbytes, flops)
    r["plain_ms"] = time_ms(lambda: ref.ivf_topk_ref(*case, 3), 10)
    r["library_ms"] = None
    t["ivf_topk"] = r
    phase("time", f"ivf_topk ({r['pages_admitted']} of {POOL_PAGES} pages "
          "admitted): " + describe(r) + f" on {smi}")
    del case
    torch.cuda.empty_cache()
    return t


def retrieval_aims(t: dict, alone: dict = None, parent: list = None,
                   change: list = None) -> list:
    """(aim, met, numbers) for the retrieval timings ``t``: ivf_topk and
    probe_topk_fused event means at most AIM_IVF_MS and AIM_PROBE_MS;
    with ``alone`` (retrieval_ab's kernels alone), the fused kernel at
    most AIM_FUSED_OVER_UNFUSED_MS slower; with the ``parent`` and
    ``change`` runs' timings, each kernel's device time a call lower in
    every change run than in every parent run."""
    aims = []
    for name, cap in (("ivf_topk", AIM_IVF_MS), ("probe_topk_fused", AIM_PROBE_MS)):
        r = t[name]
        aims.append((f"{name} at the serve shape: event mean <= {cap} ms",
                     r["ms"] <= cap, f"{r['ms']:.4f} ms, "
                     f"{r['bound_ms'] / r['ms']:.1%} of its {r['bound_ms']:.4f} "
                     f"ms bound, {r['grids_per_call']:g} grids a call"))
    if alone:
        gap = alone["probe_topk_fused"] - alone["ivf_topk"]
        aims.append(("one buffer state, every probed cluster resident: "
                     "probe_topk_fused alone at most "
                     f"{AIM_FUSED_OVER_UNFUSED_MS} ms slower than ivf_topk alone",
                     gap <= AIM_FUSED_OVER_UNFUSED_MS,
                     f"{alone['probe_topk_fused']:.4f} against "
                     f"{alone['ivf_topk']:.4f} ms, {gap:+.4f} ms, "
                     f"{alone['pages_read']} pages read"))
    for name in (("probe_topk_fused", "ivf_topk") if parent else ()):
        mine = [r[name]["device_ms"] for r in change]
        theirs = [r[name]["device_ms"] for r in parent]
        aims.append((f"{name}: device time a call lower than the parent's in "
                     "every run", max(mine) < min(theirs),
                     f"{' '.join(f'{x:.4f}' for x in mine)} ms against "
                     f"{' '.join(f'{x:.4f}' for x in theirs)} ms"))
    return aims


# -- one retrieval round, fused against unfused -------------------------------


def retrieval_ab(serve, setup, reps=20):
    """Host-clock ms of one ``hybrid_retrieve`` call, fused against
    unfused, alternating which goes first, over one buffer state of the
    serve phase's pool in which every probed cluster of ``--batch``
    queries is resident (no host search runs).  Both must return the
    same doc ids and partition.  Returns the two lists of ms, the
    resident cluster count, and each path's kernel alone on that state
    (event mean and device time a call, ms) with the pages its mask
    admits."""
    from repro_torch.core.hybrid_search import hybrid_retrieve
    from repro_torch.core.ivf import probe
    from repro_torch.core.prefetch_buffer import PrefetchBuffer
    from repro_torch.kernels.ivf_topk import ivf_topk
    from repro_torch.kernels.probe_topk import probe_topk_fused

    args, index = setup.args, setup.index
    q = serve.make_queries(setup.store, args.batch, args.seed + 7)
    probed = probe(q, index, args.nprobe)
    buf = PrefetchBuffer(index.paged, POOL_PAGES, device=setup.device)
    buf.load_clusters(sorted(set(probed.ravel().tolist())))
    calls = {"fused": dict(fused=True, centroids=index.device_centroids),
             "unfused": dict(fused=False)}
    ms = {m: [] for m in calls}
    results = {}
    for rep in range(reps + 2):                   # 2 warm-up pairs
        for mode in (("fused", "unfused") if rep % 2 else ("unfused", "fused")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = hybrid_retrieve(buf, q, probed, k=args.top_k, **calls[mode])
            dt = (time.perf_counter() - t0) * 1e3
            if rep >= 2:
                ms[mode].append(dt)
            results[mode] = res
    a, b = results["fused"], results["unfused"]
    if not (np.array_equal(a.doc_ids, b.doc_ids)
            and a.hit_clusters == b.hit_clusters
            and a.missed_clusters == b.missed_clusters):
        fail("fused and unfused retrieval disagree over one buffer state")
    if any(a.missed_clusters):
        fail("retrieval A/B: a probed cluster is not resident")

    # each path's device search alone on this state
    dev, cents = setup.device, index.device_centroids
    qd = torch.as_tensor(q, dtype=torch.float32, device=dev)
    pages, page_ids, page_cluster = buf.device_view()
    valid = torch.ones((cents.shape[0],), dtype=torch.bool, device=dev)
    luts = np.zeros((len(q), cents.shape[0]), bool)
    for b, row in enumerate(probed):
        luts[b, row] = True
    pc = buf.slot_cluster
    mask = np.zeros((len(q), buf.num_pages), bool)
    mask[:, pc >= 0] = luts[:, pc[pc >= 0]]
    mask_d = torch.from_numpy(mask).to(dev)
    fused = lambda: probe_topk_fused(qd, cents, valid, pages, page_ids,
                                     page_cluster, nprobe=args.nprobe,
                                     k=args.top_k)
    unfused = lambda: ivf_topk(pages, page_ids, mask_d, qd, args.top_k)
    alone = {"probe_topk_fused": time_ms(fused, iters=50),
             "ivf_topk": time_ms(unfused, iters=50),
             "probe_topk_fused_device": device_ms(fused),
             "ivf_topk_device": device_ms(unfused),
             "pages_read": int(mask.any(0).sum())}
    return ms["fused"], ms["unfused"], sum(map(len, a.hit_clusters)), alone


def check_decode_launches(path, name, summary, counts, per_step,
                          unit="layers"):
    """The ``path`` serve's decode kernel ``name``: exactly ``per_step``
    grid launches in every decode step, one for each of ``per_step``
    ``unit`` (layers, or zamba2's groups; its splits combine inside the
    launch)."""
    steps = summary["decode_steps"]
    want = steps * per_step
    if steps < 1 or counts[name] != want:
        fail(f"{path} serve: {name} made {counts[name]} grid launches in "
             f"{steps} steps, want {want} ({per_step} {unit} x 1 grid a step)")
    phase("check", f"{path} serve: {name} {want} grid launches = {steps} "
          f"steps x {per_step} {unit} x 1 grid a call")


def chunk_serve(serve, setup, fused: dict, counted: dict) -> dict:
    """The fourth serve, with chunk-KV splicing, on ``serve.build``'s setup.

    A chunk-less fused serve and the chunk serve run as a pair on the
    event clock (``replay=True``) over one pool with room for every
    chunk (CHUNK_POOL_PAGES), so the two form the same waves and draw the
    same query rewrites: chunk pages in the pool and the spliced steps'
    own time would otherwise move the wave former, and with it which
    docs the rewritten queries retrieve.  The pair's first serve gives
    the doc ids; a ChunkKVStore over them is built with the port's
    full-width prefill (page size 16, clusters from the index's
    assignments); the same 8 irg requests are served again with
    chunk_kv=True.  Fails unless every retrieved doc splices (hit rate
    1.0), some wave splices, the doc ids equal the pair's first serve's,
    the kv and chunk_kv ledgers drain to 0, and the spliced kernel ran
    exactly 32 x (steps of spliced waves) times and flash_decode_paged 32
    x (the other steps).  Prints whether the doc ids also equal phase 6's
    fused serve's (a wall-clock serve on the tighter pool), and whether
    lookahead prefetched chunk pages (the aim).  Returns its launches."""
    from repro_torch.data.chunk_kv import (build_chunk_kv,
                                           cluster_map_from_assignments)
    layers = setup.arch.num_layers
    base = serve.serve(setup, replay=True, pool_pages=CHUNK_POOL_PAGES)
    docs = sorted({d for rows in base["doc_ids"].values() for row in rows
                   for d in row})
    if not docs or min(docs) < 0:
        fail(f"chunk serve: the chunk-less serve retrieved doc ids {docs}")
    t0 = time.perf_counter()
    store = build_chunk_kv(setup.model, docs, page_size=16,
                           cluster_of=cluster_map_from_assignments(
                               setup.index.assignments))
    build_s = time.perf_counter() - t0
    host_mb = sum(c.k.nbytes + c.v.nbytes for c in store.chunks.values()) / 2**20
    phase("chunk", f"store of {len(docs)} docs (every doc the chunk-less "
          f"serve retrieved), {store.total_pages()} pages of 16 tokens, "
          f"{host_mb:.1f} MiB of fp32 K+V on the host, built with the "
          f"full-width prefill in {build_s:.2f} s; the chunk-less serve: "
          f"{base['decode_steps']} steps, {base['wall_s']:.2f} s")
    for fn in counted.values():
        fn.launches = 0
    summary = serve.serve(setup, chunk_store=store, chunk_kv=True, replay=True,
                          pool_pages=CHUNK_POOL_PAGES)
    launches = {n: fn.launches for n, fn in counted.items()}
    ck = summary["chunk_kv"]
    waves = [w for w in summary["decode_waves"] if w["steps"]]
    spliced = sum(1 for w in waves if w["spliced"])
    steps, sp_steps = summary["decode_steps"], summary["spliced_steps"]
    phase("serve", json.dumps({"path": "chunk", **{k: summary[k] for k in (
        "device", "layers", "retrieval", "decode", "requests", "hits", "misses",
        "decode_tokens", "decode_steps", "spliced_steps", "decode_s",
        "tokens_per_s", "decode_waves", "retrievals", "wall_s",
        "retrieval_gap", "pressure_stall_s", "spliced_waves", "chunk_kv",
        "ledger_after_drain")}}))
    phase("chunk", f"chunk serve: wall {summary['wall_s']:.2f} s, "
          f"{1e3 * summary['decode_s'] / max(steps, 1):.2f} ms/step over "
          f"{steps} steps ({sp_steps} in spliced waves); waves with steps: "
          f"{spliced} spliced, {len(waves) - spliced} unspliced; chunk hits "
          f"{ck.get('hits')} misses {ck.get('misses')} (hit rate "
          f"{ck.get('hit_rate')}); spliced pages {ck.get('spliced_pages')}, "
          f"prefetched pages {ck.get('prefetched_pages')}; prefill tokens "
          f"avoided {ck.get('prefill_tokens_avoided')}; retrieval hits "
          f"{summary['hits']} misses {summary['misses']}; the chunk-less "
          f"pair serve {1e3 * base['decode_s'] / max(base['decode_steps'], 1):.2f} "
          "ms/step")
    rows = lambda s: [row for rid in sorted(s["doc_ids"]) for row in s["doc_ids"][rid]]
    same_fused = sum(a == b for a, b in zip(rows(summary), rows(fused)))
    phase("chunk", f"doc ids against phase 6's fused serve: {same_fused} of "
          f"{len(rows(summary))} retrieval rows equal ({len(rows(fused))} there)")
    if summary["doc_ids"] != base["doc_ids"]:
        fail("chunk serve: doc ids differ from the chunk-less serve's "
             f"({sum(a != b for a, b in zip(rows(summary), rows(base)))} rows)")
    if ck.get("hit_rate") != 1.0 or ck.get("misses"):
        fail(f"chunk serve: not every retrieved doc spliced: {ck}")
    if summary["spliced_waves"] < 1 or sp_steps < 1:
        fail(f"chunk serve: no wave spliced ({summary['spliced_waves']} waves)")
    if summary["ledger_after_drain"] != {"kv": 0, "chunk_kv": 0}:
        fail(f"chunk serve: ledger after draining {summary['ledger_after_drain']}")
    check_invariants("chunk-less twin", base)
    check_invariants("chunk", summary, must_drain=("kv", "chunk_kv"))
    if not summary["retrieval_gap"] < 1e-2:
        fail(f"chunk serve disagrees with the exact host search: score gap "
             f"{summary['retrieval_gap']}")
    want = {"flash_decode_spliced": layers * sp_steps,
            "flash_decode_paged": layers * (steps - sp_steps)}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"chunk serve: {name} made {launches[name]} grid launches, "
                 f"want {n} ({layers} layers x 1 grid x its steps)")
    if launches["probe_topk_fused"] < 1 or any(
            launches[n] for n in ("flash_decode", "ivf_topk", "centroid_scores",
                                  "flash_decode_quant", "mla_decode")):
        fail(f"chunk serve launched the wrong kernels: {launches}")
    phase("check", f"chunk serve: flash_decode_spliced {want['flash_decode_spliced']}"
          f" = {sp_steps} steps x {layers} layers, flash_decode_paged "
          f"{want['flash_decode_paged']} = {steps - sp_steps} steps x {layers}; "
          "hit rate 1.0, doc ids equal, ledgers drained to 0")
    phase("aim", f"lookahead prefetched chunk pages: "
          f"{'met' if ck.get('prefetched_pages', 0) > 0 else 'NOT met'} "
          f"({ck.get('prefetched_pages')} pages)")
    phase("kernels", json.dumps({"path": "chunk", **launches}))
    return launches


def check_model(ttf, get_arch):
    """One reduced Llama-3 decode step (fp32) through the kernel on the
    card against the same step through the plain version on the CPU:
    the slab write and the logits, atol=rtol=2e-3."""
    cfg = get_arch("llama3-8b").reduced()
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                            dtype=torch.float32)
    g = torch.Generator().manual_seed(6)
    B, ps, MB = 3, 4, 4
    NP = B * MB + 2
    shape = (cfg.num_layers, NP, ps, cfg.num_kv_heads, cfg.resolved_head_dim)
    k0, v0 = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    bt = torch.randperm(NP, generator=g)[:B * MB].reshape(B, MB).to(torch.int32)
    lens = torch.tensor([0, 3, 6], dtype=torch.int32)
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=g, dtype=torch.int32)
    want, wk, _ = ttf.serve_step_paged(model, k0.clone(), v0.clone(), bt, lens,
                                       {"token": tok})
    card = ttf.Transformer(cfg, {n: p.detach().cuda()
                                 for n, p in model.named_parameters()})
    got, gk, _ = ttf.serve_step_paged(card, k0.cuda(), v0.cuda(), bt.cuda(),
                                      lens.cuda(), {"token": tok.cuda()})
    torch.cuda.synchronize()
    try:
        torch.testing.assert_close(gk.cpu(), wk, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)
    except AssertionError as e:
        fail(f"serve_step_paged on the card vs the CPU: {e}")
    err = (got.cpu() - want).abs().max().item()
    phase("check", f"serve_step_paged (reduced {cfg.name}, fp32) card vs CPU: "
          f"logits {tuple(got.shape)} max_abs_err={err:.3e} (atol=rtol=2e-3)")


def check_invariants(path: str, summary: dict, **must) -> None:
    """Replay the ``path`` serve's flight-recorder stream through the
    port's happens-before checker in drained mode (``must``: owner
    categories that must end at zero); fails on any violation."""
    from repro_torch.analysis import check_recorder
    rep = check_recorder(summary["recorder"], drained=True, **must)
    phase("invariants", json.dumps({
        "path": path, "events": rep.checked_events,
        "violations": len(rep.violations), **rep.stats,
        "outstanding": rep.outstanding, **must}))
    if not rep.ok:
        fail(f"{path} serve: {rep.summary()}")


def train_phase(smi: str) -> dict:
    """launch/train's ``main`` at the ``full`` preset (TRAIN_ARGS): one
    line a logged step (loss, grad norm, lr, ms, tokens/s), then the
    peak memory.  Fails unless the memory check picked bf16 moments,
    every loss and grad norm is finite and the last loss is below the
    first."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import main, moment_dtype, preset_config
    cfg = preset_config(get_arch("llama3-8b"), "full")
    moments = moment_dtype(cfg, torch.device("cuda"))
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    phase("train", f"python -m repro_torch.launch.train {' '.join(TRAIN_ARGS)}"
          f": {cfg.name}, {cfg.num_layers} layers (no cut), d_model "
          f"{cfg.d_model}, {moments} moments; {held / 1e9:.3f} GB held from "
          "the earlier phases")
    t0 = time.perf_counter()
    rows = main(TRAIN_ARGS)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for r in rows:
        phase("train", json.dumps(r))
    losses = [r["loss"] for r in rows]
    steady = [r["ms"] for r in rows[1:]]
    out = {"layers": cfg.num_layers, "moments": moments, "losses": losses,
           "ms": [r["ms"] for r in rows], "steady_ms": sum(steady) / len(steady),
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * 1e3
           * len(steady) / sum(steady),
           "peak_bytes": peak, "held_bytes": held, "main_s": wall_s}
    phase("train", f"{out['steady_ms']:.1f} ms/step after the first "
          f"({rows[0]['ms']:.1f} ms), {out['tokens_per_s']:.0f} tokens/s, "
          f"peak {peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated), "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step, main {wall_s:.1f} s "
          f"with the build; on {smi}")
    if moments != "bfloat16" or len(rows) != TRAIN_STEPS:
        fail(f"train: {moments} moments, {len(rows)} logged steps")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in rows):
        fail(f"train: a loss or grad norm is not finite: {rows}")
    if not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall on the repeated batch: {losses}")
    gc.collect()
    torch.cuda.empty_cache()
    out.update(train_breakdown(smi))
    return out


def family_train(arch: str, layers, smi: str) -> dict:
    """One family's training on the card: the arch's config (full
    width; ``layers`` cuts the depth by ``dataclasses.replace``), its
    model and AdamW state from ``init_training`` (random bf16 weights
    from seed 0, the moment dtype ``launch/train``'s memory check
    picks), FAMILY_TRAIN_STEPS steps of ``make_train_step`` at main's
    chunks (attention 256, loss 128, remat) on one repeated TokenStream
    batch (an image prefix for internvl2, codebooks for musicgen).  One
    line: steps, ms/step after the first, tokens/s, peak memory, the
    moments, the first and last loss, and the device's busy ms in one
    more step under torch.profiler.  For MoE, backward's recompute
    must route each layer of the first step as its forward did.  Fails
    unless every loss and grad norm is finite and the last loss is below
    the first; an out-of-memory error fails the run."""
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch.train import moment_dtype, param_count
    from repro_torch.models import moe
    from repro_torch.training import (OptConfig, init_training,
                                      make_train_step)
    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    moments = moment_dtype(cfg, torch.device("cuda"))
    opt = OptConfig(warmup_steps=1, total_steps=FAMILY_TRAIN_STEPS,
                    moment_dtype=moments)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, state = init_training(cfg, opt,
                                 torch.Generator(device="cuda").manual_seed(0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in TokenStream(
        cfg, DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                        seed=0)).next_batch().items()}
    step = make_train_step(cfg, opt, attn_chunk=min(256, TRAIN_SEQ),
                           loss_chunk=128)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    routes, real_route = {}, moe.route

    def record(router, x, c, *tp):  # each layer's routings, by its router
        r = real_route(router, x, c, *tp)
        # detached: the gates' graph would hold the recompute's activations
        routes.setdefault(router.data_ptr(), []).append(
            (r.experts, r.weights.detach(), r.slot))
        return r

    rows = []
    for i in range(FAMILY_TRAIN_STEPS):
        if i == 0 and cfg.moe is not None:
            moe.route = record          # the first step's forward and recompute
        t1 = time.perf_counter()
        try:
            model, state, m = step(model, state, batch)
        finally:
            moe.route = real_route
        rows.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "ms": 1e3 * (time.perf_counter() - t1)})
    peak = torch.cuda.max_memory_allocated()
    # one more step under the profiler: the device's busy ms in a step
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(model, state, batch)
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t1)
    busy, by_op = _device_ms(prof)
    del model, state, batch, step, prof
    gc.collect()
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in rows]
    steady = [r["ms"] for r in rows[1:]]
    out = {"arch": arch, "layers": cfg.num_layers, "params": param_count(cfg),
           "moments": moments, "steps": len(rows), "losses": losses,
           "grad_norms": [r["grad_norm"] for r in rows],
           "ms": [r["ms"] for r in rows],
           "steady_ms": sum(steady) / len(steady),
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * 1e3 * len(steady)
           / sum(steady), "peak_bytes": peak, "held_bytes": held,
           "init_s": init_s,
           "profiled_ms": profiled_ms, "device_busy_ms": busy,
           "device_ms_by_op": dict(sorted(by_op.items(),
                                          key=lambda kv: -kv[1])[:4])}
    cut = (f"{cfg.num_layers} of {get_arch(arch).num_layers} layers" if layers
           else f"{cfg.num_layers} layers (no cut)")
    phase("train", f"{arch}: {cut}, d_model {cfg.d_model}, "
          f"{out['params'] / 1e9:.3f} B parameters, {moments} moments; "
          f"{len(rows)} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: "
          f"{out['steady_ms']:.1f} ms/step after the first "
          f"({rows[0]['ms']:.1f} ms), {out['tokens_per_s']:.0f} tokens/s, "
          f"peak {peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated), loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; a profiled step "
          f"{profiled_ms:.1f} ms wall, "
          + (f"device busy {busy:.1f} ms" if busy else
             "device time not measured (the profiler saw no kernel)")
          + f"; on {smi}")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in rows):
        fail(f"train {arch}: a loss or grad norm is not finite: {rows}")
    if not losses[-1] < losses[0]:
        fail(f"train {arch}: the loss did not fall on the repeated batch: "
             f"{losses}")
    if cfg.moe is not None:
        same = [len(c) == 2 and all(torch.equal(a, b)
                                    for a, b in zip(*c))
                for c in routes.values()]
        if len(routes) != cfg.num_layers or not all(same):
            fail(f"train {arch}: backward's recompute routed "
                 f"{same.count(False)} of {len(routes)} layers otherwise "
                 f"than the forward")
        out["routes_recomputed_alike"] = len(same)
        phase("train", f"{arch}: backward's recompute routed all "
              f"{len(same)} layers as the forward did (experts, gates, "
              "capacity slots)")
    return out


def _device_ms(prof) -> tuple:
    """(device ms of every kernel, device ms by the aten op that launched
    it) from a profile; both 0 / empty when the profiler saw no device
    activity."""
    busy, by_op = 0.0, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += getattr(e, "device_time_total", 0.0) / 1e3
        elif e.key.startswith("aten::"):
            ms = getattr(e, "self_device_time_total", 0.0) / 1e3
            if ms > 0:
                by_op[e.key] = ms
    return busy, by_op


def train_breakdown(smi: str) -> dict:
    """Where a train step's time goes: the full preset's model, state and
    step built as launch/train's ``main`` builds them for TRAIN_ARGS, one
    step (gradients allocated), then the global norm and the AdamW update
    alone on its gradients (one more update), then one step under
    torch.profiler (device busy ms, by the aten op that launched each
    kernel), then one step each in turn at main's attention and loss
    chunks (256, 128) and at make_train_step's defaults (1024, 512)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.training import (OptConfig, adamw_update, global_norm,
                                      init_training, make_train_step)
    cfg = get_arch("llama3-8b")
    opt = OptConfig(warmup_steps=1, total_steps=TRAIN_STEPS,
                    moment_dtype="bfloat16")
    model, state = init_training(cfg, opt,
                                 torch.Generator(device="cuda").manual_seed(0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in TokenStream(
        cfg, DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                        seed=0)).next_batch().items()}
    step = make_train_step(cfg, opt, attn_chunk=min(256, TRAIN_SEQ),
                           loss_chunk=128)
    step(model, state, batch)
    params = dict(model.named_parameters())
    grads = {n: p.grad for n, p in params.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    global_norm(grads.values())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(params, grads, state, opt)
    torch.cuda.synchronize()
    out = {"global_norm_ms": 1e3 * (t1 - t0),
           "update_ms": 1e3 * (time.perf_counter() - t1)}
    del grads          # else the next step's gradients come on top of these
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, state, batch)
        torch.cuda.synchronize()
        out["profiled_ms"] = 1e3 * (time.perf_counter() - t0)
    busy, by_op = _device_ms(prof)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:8]
    out.update(device_busy_ms=busy, device_ms_by_op=dict(top))
    phase("train", f"breakdown: update alone {out['update_ms']:.1f} ms "
          f"(global norm {out['global_norm_ms']:.1f} ms of it); one profiled "
          f"step {out['profiled_ms']:.1f} ms wall, "
          + (f"device busy {busy:.1f} ms" if busy else
             "device time not measured (the profiler saw no kernel)")
          + f"; on {smi}")
    phase("train", json.dumps({"device_ms_by_op": out["device_ms_by_op"]}))
    # main's chunks (the reference's launch/train: attention 256, loss 128)
    # against make_train_step's defaults (1024, 512), one step each in turn
    chunk_ms = {"256/128": [], "1024/512": []}
    for attn_chunk, loss_chunk in [(256, 128), (1024, 512)] * 2:
        other = make_train_step(cfg, opt, attn_chunk=min(attn_chunk, TRAIN_SEQ),
                                loss_chunk=loss_chunk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        other(model, state, batch)
        torch.cuda.synchronize()
        chunk_ms[f"{attn_chunk}/{loss_chunk}"].append(
            1e3 * (time.perf_counter() - t0))
    out["ms_by_chunks"] = chunk_ms
    phase("train", "one step in turn with attention/loss chunks "
          + "; ".join(f"{k}: {', '.join(f'{v:.1f}' for v in ms)} ms"
                      for k, ms in chunk_ms.items()) + f"; on {smi}")
    del model, state, batch, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _step_files(d: str, step: int) -> tuple:
    """(manifest, {file: array}) of checkpoint ``step`` in ``d``."""
    path = Path(d) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    return manifest, {f.name: np.load(f) for f in sorted(path.glob("*.npy"))}


def _files_differ(a: tuple, b: tuple) -> list:
    (ma, xa), (mb, xb) = a, b
    if ma != mb or sorted(xa) != sorted(xb):
        return ["manifest"]
    return [f for f in xa if not np.array_equal(xa[f], xb[f])]


def checkpoint_phase(arch: str) -> dict:
    """launch/train's ``main`` at ``arch``'s ``100m`` preset with --ckpt-dir:
    CKPT_STEPS steps uninterrupted (a checkpoint every CKPT_STEPS // 2),
    then a second run that finds only the uninterrupted run's middle
    checkpoint (as after a stop there) and resumes from it.  The resumed
    steps' loss, lr and grad norm equal the uninterrupted run's, and the
    two final checkpoints (weights, moments, step, data cursor) are
    equal to the bit.  Then the final checkpoint restored into a fresh
    state (in place: the template's own tensors come back) and saved
    again, equal to the bit.  Fails otherwise."""
    import shutil
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import main, param_count, preset_config
    from repro_torch.training import (OptConfig, init_training,
                                      restore_checkpoint, save_checkpoint)
    cfg = preset_config(get_arch(arch), "100m")
    mid = CKPT_STEPS // 2
    args = ["--preset", "100m", "--arch", arch, "--steps", str(CKPT_STEPS),
            "--batch",
            str(CKPT_BATCH), "--seq", str(CKPT_SEQ), "--ckpt-every",
            str(mid), "--log-every", "1", "--warmup", "1",
            "--device", "cuda"]
    drop = lambda rows: [{k: r[k] for k in ("step", "loss", "lr", "grad_norm")}
                         for r in rows]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        a, b, c = (str(Path(d) / x) for x in "abc")
        whole = main(args + ["--ckpt-dir", a])
        name = f"step_{mid:08d}"
        shutil.copytree(Path(a) / name, Path(b) / name)
        (Path(b) / "LATEST").write_text(name)
        resumed = main(args + ["--ckpt-dir", b])
        if drop(resumed) != drop(whole[mid:]):
            fail(f"checkpoint: the resumed steps differ: {drop(resumed)} "
                 f"against {drop(whole[mid:])}")
        final = _step_files(a, CKPT_STEPS)
        differ = _files_differ(final, _step_files(b, CKPT_STEPS))
        if differ:
            fail(f"checkpoint: the resumed run's step-{CKPT_STEPS} checkpoint "
                 f"differs from the uninterrupted run's: {differ[:5]}")
        model, state = init_training(
            cfg, OptConfig(), torch.Generator(device="cuda").manual_seed(1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, back = restore_checkpoint(a, {"params": model, "opt": state,
                                            "data": {"step": 0, "seed": 0}})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if back["params"] is not model or back["opt"] is not state:
            fail("checkpoint: restore_checkpoint did not restore in place")
        t0 = time.perf_counter()
        save_checkpoint(c, step, back)
        save_s = time.perf_counter() - t0
        differ = _files_differ(final, _step_files(c, CKPT_STEPS))
        if differ:
            fail(f"checkpoint: save(restore(x)) differs from x: {differ[:5]}")
        nbytes = sum(x.nbytes for x in final[1].values())
        del model, state, back
    out = {"arch": arch, "preset": cfg.name, "tensors": len(final[1]),
           "bytes": nbytes,
           "save_s": save_s, "restore_s": restore_s,
           "losses": [r["loss"] for r in whole],
           "resumed_losses": [r["loss"] for r in resumed]}
    phase("checkpoint", f"{cfg.name} ({param_count(cfg) / 1e6:.1f}M "
          f"parameters) through launch/train with --ckpt-dir: steps "
          f"{mid + 1}-{CKPT_STEPS} resumed from the step-{mid} checkpoint "
          f"equal to the uninterrupted run's (losses {out['resumed_losses']}),"
          f" the step-{CKPT_STEPS} checkpoints ({len(final[1])} files, "
          f"{nbytes / 1e6:.1f} MB) equal to the bit; restored in place in "
          f"{restore_s:.2f} s and saved again in {save_s:.2f} s, equal to "
          "the bit")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _steps(step, model, state, err, batch, n: int) -> list:
    """``n`` steps of a DP ``step`` (``err`` None: a ``make_train_step``
    step): one row each, loss, grad norm and host ms after the metrics'
    host read (which waits for the step)."""
    rows = []
    for _ in range(n):
        t0 = time.perf_counter()
        if err is None:
            model, state, m = step(model, state, batch)
        else:
            model, state, err, m = step(model, state, err, batch)
        rows.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "ms": 1e3 * (time.perf_counter() - t0)})
    return rows


def _steady_ms(rows) -> float:
    return sum(r["ms"] for r in rows[1:]) / max(len(rows) - 1, 1)


def _all_reduce_ms(grads, group=None) -> float:
    """Host ms of one averaging all-reduce of ``grads`` (SUM, then / W,
    as the uncompressed DP step does), synchronized on both sides."""
    import torch.distributed as dist
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g in grads.values():
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        g.div_(dist.get_world_size(group))
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def _compressed_ms(grads, err, group=None) -> float:
    """Host ms of one ``compressed_all_reduce`` of ``grads`` on a copy of
    ``err``, synchronized on both sides."""
    from repro_torch.distributed.compression import compressed_all_reduce
    err = {n: e.clone() for n, e in err.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compressed_all_reduce(grads, err, group)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def payload_bytes(params, compress: bool) -> int:
    """Bytes one rank hands a step's gradient all-reduce
    (``compression.payload_bytes`` of the parameters)."""
    from repro_torch.distributed import compression
    return compression.payload_bytes(
        [(p.numel(), p.element_size()) for p in params.values()], compress)


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def dp_llama(smi: str, phase8_loss) -> dict:
    """9a: ``make_manual_dp_train_step(compress=False)`` over a world of 1
    (NCCL) on launch/train's ``full`` Llama-3-8B (its weights from seed
    0, its bf16 moments, its attention chunk), DIST_STEPS steps on phase
    8's repeated 2 x 512 batch.  The first loss must be within 1e-4
    (relative) of the same loss at main's loss chunk (128, computed here
    without gradients) and of ``phase8_loss`` when given."""
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch.train import moment_dtype, preset_config
    from repro_torch.training import (OptConfig, init_training, make_loss_fn,
                                      make_manual_dp_train_step)
    cfg = preset_config(get_arch("llama3-8b"), "full")
    moments = moment_dtype(cfg, torch.device("cuda"))
    opt = OptConfig(warmup_steps=1, total_steps=DIST_STEPS,
                    moment_dtype=moments)
    _free()
    model, state = init_training(cfg, opt,
                                 torch.Generator(device="cuda").manual_seed(0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in TokenStream(
        cfg, DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                        seed=0)).next_batch().items()}
    with torch.no_grad():
        main_loss = float(make_loss_fn(cfg, attn_chunk=min(256, TRAIN_SEQ),
                                       loss_chunk=128)(model, batch)[0])
    step = make_manual_dp_train_step(cfg, opt, attn_chunk=min(256, TRAIN_SEQ))
    rows = _steps(step, model, state, {}, batch, DIST_STEPS)
    peak = torch.cuda.max_memory_allocated()
    grads = {n: p.grad for n, p in model.named_parameters()}
    ar_ms = _all_reduce_ms(grads)
    nbytes = sum(g.numel() * g.element_size() for g in grads.values())
    del model, state, batch, step, grads
    _free()
    losses = [r["loss"] for r in rows]
    out = {"arch": cfg.name, "layers": cfg.num_layers, "moments": moments,
           "losses": losses, "ms": [r["ms"] for r in rows],
           "steady_ms": _steady_ms(rows), "peak_bytes": peak,
           "main_chunk_loss": main_loss, "phase8_first_loss": phase8_loss,
           "all_reduce_ms": ar_ms, "all_reduce_bytes": nbytes}
    phase("dist", f"9a {cfg.name} ({cfg.num_layers} layers, full width, "
          f"{moments} moments) make_manual_dp_train_step(compress=False), "
          f"world 1 over nccl, {DIST_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens: {out['steady_ms']:.1f} ms/step after the first "
          f"({rows[0]['ms']:.1f} ms), peak {peak / 1e9:.2f} GB, loss "
          + " -> ".join(f"{x:.4f}" for x in losses) + f"; first loss against "
          f"loss chunk 128's {main_loss:.6f}"
          + (f" and phase 8's {phase8_loss:.6f}" if phase8_loss is not None
             else "") + f"; the bf16 gradient all-reduce ({nbytes / 1e9:.2f} "
          f"GB) {ar_ms:.2f} ms; on {smi}")
    refs = [main_loss] + ([phase8_loss] if phase8_loss is not None else [])
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"9a: losses not finite or not falling: {losses}")
    for want in refs:
        if abs(losses[0] - want) > 1e-4 * abs(want):
            fail(f"9a: first loss {losses[0]} is not within 1e-4 of {want}")
    return out


def dp_internvl2(smi: str) -> dict:
    """9b: internvl2-1b at full width and depth over a world of 1 (NCCL):
    DIST_STEPS uncompressed DP steps against ``make_train_step`` with the
    same arguments, each from seed 0's weights: every parameter equal to
    the bit.  Then DIST_STEPS compressed steps from seed 0: every loss
    finite and falling, the error feedback nonzero."""
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.distributed.compression import init_error_feedback
    from repro_torch.launch.train import moment_dtype
    from repro_torch.training import (OptConfig, init_training,
                                      make_manual_dp_train_step,
                                      make_train_step)
    cfg = get_arch("internvl2-1b")
    moments = moment_dtype(cfg, torch.device("cuda"))
    opt = OptConfig(warmup_steps=1, total_steps=DIST_STEPS,
                    moment_dtype=moments)
    batch = {k: torch.from_numpy(v).cuda() for k, v in TokenStream(
        cfg, DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                        seed=0)).next_batch().items()}
    chunk = min(256, TRAIN_SEQ)

    def fresh():
        return init_training(cfg, opt,
                             torch.Generator(device="cuda").manual_seed(0))

    _free()
    model_a, state_a = fresh()
    rows_a = _steps(make_train_step(cfg, opt, attn_chunk=chunk), model_a,
                    state_a, None, batch, DIST_STEPS)
    model_b, state_b = fresh()
    rows_b = _steps(make_manual_dp_train_step(cfg, opt, attn_chunk=chunk),
                    model_b, state_b, {}, batch, DIST_STEPS)
    pa, pb = dict(model_a.named_parameters()), dict(model_b.named_parameters())
    n_params = len(pa)
    differ = [n for n in pa if not torch.equal(pa[n], pb[n])]
    moments_differ = [n for n in pa for k in ("m", "v")
                      if not torch.equal(state_a[k][n], state_b[k][n])]
    del model_a, state_a, model_b, state_b, pa, pb
    _free()
    model, state = fresh()
    params = dict(model.named_parameters())
    err = init_error_feedback(params)
    rows_c = _steps(make_manual_dp_train_step(cfg, opt, compress=True,
                                              attn_chunk=chunk),
                    model, state, err, batch, DIST_STEPS)
    peak = torch.cuda.max_memory_allocated()
    err_max = max(float(e.abs().max()) for e in err.values())
    grads = {n: p.grad for n, p in params.items()}
    car_ms = _compressed_ms(grads, err)
    ar_ms = _all_reduce_ms(grads)
    wire = {"int32": payload_bytes(params, True),
            "bf16": payload_bytes(params, False)}
    del model, state, err, params, grads, batch
    _free()
    out = {"arch": cfg.name, "moments": moments,
           "train_step": {"losses": [r["loss"] for r in rows_a],
                          "steady_ms": _steady_ms(rows_a)},
           "dp": {"losses": [r["loss"] for r in rows_b],
                  "steady_ms": _steady_ms(rows_b)},
           "params_differ": differ, "moments_differ": moments_differ,
           "compressed": {"losses": [r["loss"] for r in rows_c],
                          "steady_ms": _steady_ms(rows_c),
                          "err_max_abs": err_max, "peak_bytes": peak},
           "compressed_all_reduce_ms": car_ms, "all_reduce_ms": ar_ms,
           "payload_bytes": wire}
    phase("dist", f"9b {cfg.name} ({cfg.num_layers} layers, full width, "
          f"{moments} moments), world 1 over nccl, {DIST_STEPS} steps each "
          f"from seed 0: make_train_step {out['train_step']['steady_ms']:.1f} "
          f"ms/step, the DP step {out['dp']['steady_ms']:.1f} ms/step, "
          f"{n_params - len(differ)} of {n_params} parameters equal to the bit (moments: {len(moments_differ)} "
          f"differ); compressed {out['compressed']['steady_ms']:.1f} ms/step, "
          f"loss " + " -> ".join(f"{x:.4f}" for x in out['compressed']['losses'])
          + f", error feedback max |e| {err_max:.3e}, peak {peak / 1e9:.2f} GB; "
          f"all-reduce alone: compressed {car_ms:.2f} ms ({wire['int32'] / 1e9:.3f}"
          f" GB of int32), bf16 {ar_ms:.2f} ms ({wire['bf16'] / 1e9:.3f} GB); "
          f"on {smi}")
    if differ or moments_differ:
        fail(f"9b: the DP step over one rank differs from make_train_step in "
             f"{differ} {moments_differ}")
    losses = out["compressed"]["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"9b: compressed losses not finite or not falling: {losses}")
    if not err_max > 0:
        fail("9b: the error feedback stayed 0")
    return out


def save_slab(paged, queries: np.ndarray, work: Path) -> dict:
    """The index's pages (bf16) and ids, trimmed to an even page count as
    ``examples/sharded_retrieval.py`` trims them, and ``queries``, as raw
    files under ``work`` that each rank reads its half of."""
    from repro_torch.core.prefetch_buffer import host_pages
    pages = host_pages(paged, torch.bfloat16, pin=True)     # serve's copy
    P = pages.shape[0] // 2 * 2
    pages[:P].view(torch.int16).numpy().tofile(work / "pages.bin")
    np.ascontiguousarray(paged.page_ids[:P]).tofile(work / "page_ids.bin")
    np.save(work / "queries.npy", queries.astype(np.float32))
    spec = {"pages": P, "page_size": int(pages.shape[1]),
            "dim": int(pages.shape[2]), "total_pages": int(pages.shape[0])}
    (work / "slab.json").write_text(json.dumps(spec))
    return spec


def _read_pages(work: Path, spec: dict, rows: slice):
    """Pages [rows] (bf16) and their ids from ``save_slab``'s files, on
    the card."""
    ps, d = spec["page_size"], spec["dim"]
    n = rows.stop - rows.start
    raw = np.fromfile(work / "pages.bin", dtype=np.int16, count=n * ps * d,
                      offset=rows.start * ps * d * 2)
    ids = np.fromfile(work / "page_ids.bin", dtype=np.int32, count=n * ps,
                      offset=rows.start * ps * 4)
    pages = torch.from_numpy(raw).view(torch.bfloat16).reshape(n, ps, d)
    return pages.cuda(), torch.from_numpy(ids).reshape(n, ps).cuda()


def counted_kernels() -> dict:
    """Every kernel wrapper's launch counter, by name."""
    from repro_torch.kernels import centroid_probe as cp
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ivf_topk as it
    from repro_torch.kernels import mla_decode as mla
    from repro_torch.kernels import probe_topk as pt
    return {"flash_decode_paged": fd.flash_decode_paged,
            "probe_topk_fused": pt.probe_topk_fused, "ivf_topk": it.ivf_topk,
            "flash_decode": fd.flash_decode,
            "centroid_scores": cp.centroid_scores,
            "flash_decode_spliced": fd.flash_decode_spliced,
            "flash_decode_quant": fd.flash_decode_quant,
            "mla_decode": mla.mla_decode}


def gloo_cuda_probe() -> dict:
    """Which collectives gloo takes on CUDA tensors here: each is called
    once on small CUDA tensors and its result checked; "ok", "wrong" or
    the exception it raises.  A finding, not a phase: no failure here
    stops the run."""
    import torch.distributed as dist
    W, r = dist.get_world_size(), dist.get_rank()
    dev = torch.device("cuda")

    def full(v, dt=torch.float32, n=4):
        return torch.full((n,), float(v), dtype=dt, device=dev)

    def ar(op, dt):
        t = full(r + 1, dt)
        dist.all_reduce(t, op=op)
        want = sum(range(1, W + 1)) if op == dist.ReduceOp.SUM else W
        return bool((t == want).all())

    def bcast():
        t = full(r + 5)
        dist.broadcast(t, src=0)
        return bool((t == 5).all())

    def gather_list():
        out = [full(-1) for _ in range(W)]
        dist.all_gather(out, full(r))
        return all(bool((o == i).all()) for i, o in enumerate(out))

    def gather_tensor():
        out = full(-1, n=4 * W)
        dist.all_gather_into_tensor(out, full(r))
        return bool((out.view(W, 4)[:, 0] == torch.arange(W, device=dev)).all())

    def reduce_scatter():
        out = full(-1)
        dist.reduce_scatter_tensor(out, full(1, n=4 * W))
        return bool((out == W).all())

    def all_to_all():
        out = full(-1, n=W)
        dist.all_to_all_single(out, full(r, n=W))
        return bool((out == torch.arange(W, device=dev)).all())

    probes = {"broadcast": bcast,
              "all_reduce SUM fp32": lambda: ar(dist.ReduceOp.SUM, torch.float32),
              "all_reduce MAX fp32": lambda: ar(dist.ReduceOp.MAX, torch.float32),
              "all_reduce SUM int32": lambda: ar(dist.ReduceOp.SUM, torch.int32),
              "all_reduce SUM bf16": lambda: ar(dist.ReduceOp.SUM, torch.bfloat16),
              "all_gather": gather_list, "all_gather_into_tensor": gather_tensor,
              "reduce_scatter_tensor": reduce_scatter,
              "all_to_all_single": all_to_all}
    out = {}
    for name, fn in probes.items():
        try:
            out[name] = "ok" if fn() else "wrong"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = f"raises {type(e).__name__}: {str(e).splitlines()[0][:120]}"
        torch.cuda.synchronize()
        dist.barrier()
    return out


def dist_rank_main(rank: int, world: int, init: str, work: Path) -> None:
    """One rank of 9c, on the card, over gloo: (i) ``sharded_device_search``
    over its half of the slab (kernel 3's launches counted from 0 just
    before, read just after), then kernel 3 alone on the half, the
    exchange alone and the merge, timed; (ii) internvl2-1b's compressed
    DP steps on a global batch of DIST_C_BATCH, each followed by the
    check that rank 1's parameters equal rank 0's to the bit, and the
    compressed all-reduce alone; (iii) which collectives gloo takes on
    CUDA tensors.  Writes ``work``/rank<rank>.json."""
    need_card()
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.core.hybrid_search import (_all_gather, page_shard,
                                                sharded_device_search)
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.distributed.compression import init_error_feedback
    from repro_torch.kernels import ops
    from repro_torch.launch.train import moment_dtype
    from repro_torch.training import (OptConfig, init_training,
                                      make_manual_dp_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    out = {"rank": rank}
    # (i) the sharded search over this rank's half
    spec = json.loads((work / "slab.json").read_text())
    rows = page_shard(spec["pages"])
    pages, ids = _read_pages(work, spec, rows)
    q = torch.from_numpy(np.load(work / "queries.npy")).cuda()
    mask = torch.ones(pages.shape[0], dtype=torch.bool, device="cuda")
    counted = counted_kernels()
    torch.cuda.synchronize()
    dist.barrier()
    for fn in counted.values():
        fn.launches = 0
    s, i = sharded_device_search(q, pages, ids, mask, k=SEARCH_K)
    torch.cuda.synchronize()
    out["launches"] = {n: fn.launches for n, fn in counted.items()}
    out["scores"], out["ids"] = s.cpu().tolist(), i.cpu().tolist()
    dist.barrier()
    out["kernel_ms"] = device_ms(lambda: ops.ivf_topk(pages, ids, mask, q,
                                                      SEARCH_K), calls=20)
    local = torch.cat([s, i.view(torch.float32)], dim=-1)
    times = []
    for _ in range(20):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _all_gather(local, None)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    out["exchange_ms"] = float(np.median(times))
    s_all = torch.randn((q.shape[0], world * SEARCH_K), device="cuda")
    out["merge_ms"] = time_ms(lambda: torch.sort(s_all, dim=-1, descending=True,
                                                 stable=True), 50)
    times = []
    for _ in range(10):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded_device_search(q, pages, ids, mask, k=SEARCH_K)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    out["search_ms"] = float(np.median(times))
    out["half_bytes"] = (pages.numel() * 2 + ids.numel() * 4 + mask.numel()
                         + q.numel() * 4 + 2 * q.shape[0] * SEARCH_K * 4)
    out["half_pages"] = pages.shape[0]
    del pages, ids, mask
    torch.cuda.empty_cache()
    # (ii) internvl2-1b, compressed, on a global batch of DIST_C_BATCH
    cfg = get_arch("internvl2-1b")
    opt = OptConfig(warmup_steps=1, total_steps=DIST_C_STEPS,
                    moment_dtype=moment_dtype(cfg, torch.device("cuda")))
    model, state = init_training(cfg, opt,
                                 torch.Generator(device="cuda").manual_seed(0))
    params = dict(model.named_parameters())
    err = init_error_feedback(params)
    batch = {k: torch.from_numpy(v).cuda() for k, v in TokenStream(
        cfg, DataConfig(global_batch=DIST_C_BATCH, seq_len=TRAIN_SEQ,
                        seed=0)).next_batch().items()}
    step = make_manual_dp_train_step(cfg, opt, compress=True,
                                     attn_chunk=min(256, TRAIN_SEQ))
    rows = []
    for _ in range(DIST_C_STEPS):
        dist.barrier()
        rows.extend(_steps(step, model, state, err, batch, 1))
        same = 0
        for p in params.values():
            theirs = p.detach().clone()
            dist.broadcast(theirs, src=0)
            same += bool(torch.equal(theirs, p.detach()))
        rows[-1]["params_equal_rank0"] = same
    out["train"] = rows
    out["params"] = len(params)
    out["payload_bytes"] = {"int32": payload_bytes(params, True),
                            "bf16": payload_bytes(params, False)}
    grads = {n: p.grad for n, p in params.items()}
    dist.barrier()
    out["compressed_all_reduce_ms"] = _compressed_ms(grads, err)
    out["err_max_abs"] = max(float(e.abs().max()) for e in err.values())
    del model, state, err, params, grads, batch, step
    torch.cuda.empty_cache()
    # (iii) gloo on CUDA tensors
    out["gloo_cuda"] = gloo_cuda_probe()
    dist.destroy_process_group()
    (work / f"rank{rank}.json").write_text(json.dumps(out))


def dist_two_ranks(smi: str, work: Path, spec: dict) -> dict:
    """9c: two ranks on the one card over gloo (``dist_rank_main``, one
    process each, the kernels built already): their search against
    kernel 3 over the whole slab in this process, their parameters equal
    after each compressed step.  The two ranks share one card's
    bandwidth: their times are not a two-card figure."""
    from repro_torch.kernels import ivf_topk as it
    pages, ids = _read_pages(work, spec, slice(0, spec["pages"]))
    q = torch.from_numpy(np.load(work / "queries.npy")).cuda()
    mask = torch.ones(pages.shape[0], dtype=torch.bool, device="cuda")
    want_s, want_i = it.ivf_topk(pages, ids, mask, q, SEARCH_K)
    want_s, want_i = want_s.cpu(), want_i.cpu()
    whole_ms = device_ms(lambda: it.ivf_topk(pages, ids, mask, q, SEARCH_K),
                         calls=20)
    whole_bytes = (pages.numel() * 2 + ids.numel() * 4 + mask.numel()
                   + q.numel() * 4 + 2 * q.shape[0] * SEARCH_K * 4)
    del pages, ids, mask
    _free()
    init = work / "pg"
    procs, logs = [], [work / f"rank{r}.log" for r in range(2)]
    t0 = time.perf_counter()
    try:
        for r in range(2):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-rank",
                     str(r), "2", str(init), str(work)],
                    stdout=log, stderr=subprocess.STDOUT))
        for r, p in enumerate(procs):
            if p.wait(timeout=DIST_RANK_TIMEOUT) != 0:
                fail(f"9c: rank {r} exited {p.returncode}:\n"
                     + logs[r].read_text()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
    for r in ranks:
        got_i = torch.tensor(r["ids"], dtype=torch.int32)
        err = float((torch.tensor(r["scores"]) - want_s).abs().max())
        if not torch.equal(got_i, want_i) or not err <= RET_SCORE_TOL:
            fail(f"9c: rank {r['rank']}'s sharded search differs from kernel 3 "
                 f"over the whole slab: ids {r['ids']} against "
                 f"{want_i.tolist()}, scores {err:.2e} apart")
        if r["launches"]["ivf_topk"] < 1:
            fail(f"9c: rank {r['rank']} launched no ivf_topk: {r['launches']}")
        for i, row in enumerate(r["train"]):
            if row["params_equal_rank0"] != r["params"]:
                fail(f"9c: after compressed step {i + 1} rank {r['rank']} holds "
                     f"{row['params_equal_rank0']} of {r['params']} parameters "
                     "equal to rank 0's")
        losses = [row["loss"] for row in r["train"]]
        if not all(math.isfinite(x) for x in losses):
            fail(f"9c: rank {r['rank']} losses not finite: {losses}")
    bound = [r["half_bytes"] / HBM_BYTES_PER_S * 1e3 for r in ranks]
    phase("dist", f"9c(i) sharded_device_search over {spec['pages']} of "
          f"{spec['total_pages']} pages ({spec['pages'] * spec['page_size']} "
          f"slots x {spec['dim']}, bf16; {spec['pages'] // 2} a rank), "
          f"{q.shape[0]} queries, k {SEARCH_K}, 2 ranks on one card over gloo: "
          f"doc ids equal to kernel 3's over the whole slab on both ranks, "
          f"scores within {RET_SCORE_TOL}; ivf_topk launches "
          f"{[r['launches']['ivf_topk'] for r in ranks]}; kernel 3 on a half "
          f"{[round(r['kernel_ms'], 4) for r in ranks]} ms device against its "
          f"byte bound {[round(b, 4) for b in bound]} ms; the whole slab in one "
          f"process {whole_ms:.4f} ms (bound "
          f"{whole_bytes / HBM_BYTES_PER_S * 1e3:.4f}); exchange (gloo "
          f"all-gather through the host) {[round(r['exchange_ms'], 3) for r in ranks]}"
          f" ms, merge {[round(r['merge_ms'], 4) for r in ranks]} ms, a whole "
          f"search {[round(r['search_ms'], 3) for r in ranks]} ms; the two ranks "
          f"share one card's bandwidth: not a two-card figure; on {smi}")
    phase("dist", f"9c(ii) internvl2-1b compressed DP steps, 2 ranks over gloo "
          f"on one card, global batch {DIST_C_BATCH} x {TRAIN_SEQ}: "
          + "; ".join(f"rank {r['rank']} loss "
                      + " -> ".join(f"{row['loss']:.4f}" for row in r["train"])
                      + f", ms/step {[round(row['ms'], 1) for row in r['train']]}"
                      for r in ranks)
          + f"; after each step all {ranks[1]['params']} parameters of rank 1 "
          f"equal rank 0's to the bit; payload a step {ranks[0]['payload_bytes']['int32'] / 1e9:.3f}"
          f" GB of int32 against {ranks[0]['payload_bytes']['bf16'] / 1e9:.3f} GB "
          f"for a bf16 all-reduce; the compressed all-reduce alone "
          f"{[round(r['compressed_all_reduce_ms'], 1) for r in ranks]} ms; on {smi}")
    phase("dist", "9c(iii) gloo on CUDA tensors: " + json.dumps(ranks[0]["gloo_cuda"]))
    return {"ranks": ranks, "whole_slab_ms": whole_ms,
            "whole_slab_bytes": whole_bytes, "rank_bytes_bound_ms": bound,
            "wall_s": wall_s}


def distributed_phase(smi: str, work: Path, spec: dict,
                      phase8_loss=None) -> dict:
    """Phase 9: 9a and 9b over an NCCL world of 1 (its group destroyed
    after), then 9c's two ranks over gloo."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{work / 'nccl'}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        out = {"9a": dp_llama(smi, phase8_loss), "9b": dp_internvl2(smi)}
    finally:
        dist.destroy_process_group()
    out["9c"] = dist_two_ranks(smi, work, spec)
    out["s"] = time.perf_counter() - t0
    phase("dist", f"phase 9 in {out['s']:.1f} s")
    return out


def distributed_main() -> None:
    """Phase 9 alone: the kernels built, the serve phase's index built
    again (with a reduced model), then ``distributed_phase``."""
    need_card()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card_line()
    phase("card", f"{smi} | torch: {torch.cuda.get_device_name(0)}")
    _build.build_all(_build.SOURCES)
    setup = serve.build(serve.parse_args(SERVE_ARGS + ["--reduced", "--quiet"]))
    with tempfile.TemporaryDirectory() as d:
        spec = save_slab(setup.index.paged, serve.make_queries(
            setup.store, SEARCH_B, setup.args.seed + 11), Path(d))
        del setup
        _free()
        out = distributed_phase(smi, Path(d), spec)
    print(smi)
    print(json.dumps({"distributed": {k: v for k, v in out.items()
                                      if k != "9c"}}))


# -- phase 11: tensor parallelism, 2 and 4 gloo ranks sharing the card -------


def tp_config(arch: str, layers):
    """``arch``'s full-width config, its depth cut to ``layers`` (None:
    full depth)."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def tp_inputs(cfg, dt: torch.dtype) -> dict:
    """Phase 11's inputs on the host, from TP_SEED: a decode step's
    tokens and positions for TP_B rows, a dense cache [L, TP_B, TP_S,
    KVH, Dh] and a slab [L, NP, TP_PS, KVH, Dh] of unit normals, a
    shuffled block table with -1 tails and lengths, a prompt [2,
    TP_PROMPT]; the caches in ``dt``."""
    g = torch.Generator().manual_seed(TP_SEED)
    L, KVH, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    MB = -(-max(TP_LENGTHS) // TP_PS) + 1
    NP = TP_B * MB + 2
    rand = lambda *s: torch.randn(s, generator=g).to(dt)
    bt = torch.randperm(NP, generator=g)[:TP_B * MB].reshape(TP_B, MB).to(
        torch.int32)
    for b, n in enumerate(TP_LENGTHS):
        bt[b, n // TP_PS + 1:] = -1
    tok = lambda *s: torch.randint(0, cfg.vocab_size, s, generator=g,
                                   dtype=torch.int32)
    return {"token": tok(TP_B), "pos": torch.tensor(TP_LENGTHS, dtype=torch.int32),
            "k": rand(L, TP_B, TP_S, KVH, Dh), "v": rand(L, TP_B, TP_S, KVH, Dh),
            "k_slab": rand(L, NP, TP_PS, KVH, Dh),
            "v_slab": rand(L, NP, TP_PS, KVH, Dh), "block_table": bt,
            "lengths": torch.tensor(TP_LENGTHS, dtype=torch.int32),
            "tokens": tok(2, TP_PROMPT)}


def tp_steps(ttf, model, inp: dict, counted: dict, tp=None,
             timed: bool = True) -> dict:
    """``serve_step_paged``, ``serve_step`` and ``prefill`` of ``model``
    once each on ``inp`` (a rank's blocks where ``tp``; the caches cast
    to the model's dtype), the launch counts set to 0 just before each
    and read just after; then, where ``timed``, ``TP_TIMED`` paged steps
    timed on the host clock, with the collectives' host seconds
    (``tp.timed``).  ``inp["dense_token"]``, where given, are the dense
    step's tokens (a data shard's rows; ``pos`` and the cache its rows
    too).  Returns the logits, caches and slabs on the host,
    an MoE model's routing in each step (every layer's picks and router
    probabilities), the launches and the ms a step."""
    import torch.distributed as dist

    from repro_torch.models import moe
    cuda = lambda t: t.cuda().to(model.dtype if t.is_floating_point()
                                 else t.dtype)
    out, launches = {}, {}
    kw = {} if tp is None else {"tp": tp}
    route, picks = moe.route, []

    def recorded(router, x, cfg, *tp):     # every MoE layer's routing
        r = route(router, x, cfg, *tp)
        picks.append((r.experts, r.probs))
        return r

    def counted_run(name, fn):
        torch.cuda.synchronize()
        if tp is not None:
            dist.barrier()
        for f in counted.values():
            f.launches = 0
        picks.clear()
        moe.route = recorded
        try:
            res = fn()
        finally:
            moe.route = route
        torch.cuda.synchronize()
        launches[name] = {n: f.launches for n, f in counted.items()}
        if picks:
            out[f"{name}/experts"] = torch.stack([e for e, _ in picks]).cpu()
            out[f"{name}/probs"] = torch.stack([p for _, p in picks]).cpu()
        return res

    with torch.no_grad():
        ks, vs = cuda(inp["k_slab"]), cuda(inp["v_slab"])
        bt, lens, tok = cuda(inp["block_table"]), cuda(inp["lengths"]), \
            cuda(inp["token"])
        logits, ks, vs = counted_run("paged", lambda: ttf.serve_step_paged(
            model, ks, vs, bt, lens, {"token": tok}, **kw))
        out.update({"paged/logits": logits.cpu(), "paged/k": ks.cpu(),
                    "paged/v": vs.cpu()})
        cache = {"k": cuda(inp["k"]), "v": cuda(inp["v"])}
        dtok = cuda(inp.get("dense_token", inp["token"]))
        logits, cache = counted_run("dense", lambda: ttf.serve_step(
            model, cache, {"token": dtok, "pos": cuda(inp["pos"])}, **kw))
        out.update({"dense/logits": logits.cpu(), "dense/k": cache["k"].cpu(),
                    "dense/v": cache["v"].cpu()})
        logits, cache = counted_run("prefill", lambda: ttf.prefill(
            model, {"tokens": cuda(inp["tokens"])}, attn_chunk=TP_PROMPT, **kw))
        out.update({"prefill/logits": logits.cpu(),
                    "prefill/k": cache["k"].cpu(), "prefill/v": cache["v"].cpu()})
        del cache
        if not timed:
            out["launches"] = launches
            return out
        for _ in range(2):                     # warm
            ttf.serve_step_paged(model, ks, vs, bt, lens, {"token": tok}, **kw)
        torch.cuda.synchronize()
        if tp is not None:
            dist.barrier()
            tp.timed, tp.seconds = True, 0.0
        t0 = time.perf_counter()
        for _ in range(TP_TIMED):
            ttf.serve_step_paged(model, ks, vs, bt, lens, {"token": tok}, **kw)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    out["ms"] = 1e3 * total / TP_TIMED
    out["coll_ms"] = 0.0 if tp is None else 1e3 * tp.seconds / TP_TIMED
    if tp is not None:
        tp.timed = False
    out["launches"] = launches
    return out


def tp_rank_main(rank: int, world: int, init: str, work: Path) -> None:
    """One rank of phase 11 over gloo on the card: for each of TP_CASES,
    its blocks of the seeded model (``shard_model``; the full model built
    one rank at a time), kernels 1 and 4 at its local head counts held
    against their plain versions (outside the counted runs), then
    ``tp_steps`` on its blocks of the cache and slab (``shard_cache``).
    Saves its outputs to ``work``/tp<world>_<rank>_<arch>.pt and writes
    ``work``/tp<world>_<rank>.json."""
    need_card()
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.distributed.sharding import MeshAxes
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    from repro_torch.models import transformer as ttf
    from repro_torch.serving.kv_cache import KVPageSlab
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    tp = tpm.TPGroup()
    mesh = MeshAxes(("model",), (world,))
    counted = counted_kernels()
    summary = {"rank": rank, "cases": {}}
    for arch, layers in TP_CASES:
        cfg = tp_config(arch, layers)
        dt = TP_DTYPE[arch]
        inp = torch.load(work / f"tp_in_{arch}.pt")
        t0 = time.perf_counter()
        for r in range(world):              # one full model on the card at once
            if r == rank:
                full = ttf.init_params(cfg, torch.Generator(
                    device="cuda").manual_seed(TP_SEED), device="cuda", dtype=dt)
                model = tpm.shard_model(full, cfg, mesh, rank=rank)
                del full
                _free()
            dist.barrier()
        build_s = time.perf_counter() - t0
        kvh = model.wk.shape[2]
        G = model.wq.shape[2] // kvh if not model.tp_layout.padded_heads \
            else cfg.num_heads // kvh
        Dh = cfg.resolved_head_dim
        err1 = check_decode(fd, ref, decode_case(TP_B, kvh, G, Dh, TP_PS, -(
            -max(TP_LENGTHS) // TP_PS) + 1, TP_LENGTHS, seed=40 + rank, dtype=dt),
            0, f"{arch} rank {rank} of {world}'s shape")
        err4 = check_dense(fd, ref, dense_case(TP_B, TP_S, kvh, G, Dh,
                                               TP_LENGTHS, seed=50 + rank,
                                               dtype=dt), 0,
                           f"{arch} rank {rank} of {world}'s shape")
        coord = (rank,)
        dense = tpm.shard_cache({"k": inp["k"], "v": inp["v"]}, cfg, mesh,
                                coord=coord)
        slab = tpm.shard_cache(KVPageSlab(k=inp["k_slab"], v=inp["v_slab"],
                                          page_size=TP_PS), cfg, mesh,
                               coord=coord)
        mine = dict(inp, k=dense["k"], v=dense["v"], k_slab=slab.k,
                    v_slab=slab.v)
        out = tp_steps(ttf, model, mine, counted, tp)
        torch.save({k: v for k, v in out.items() if isinstance(v, torch.Tensor)},
                   work / f"tp{world}_{rank}_{arch}.pt")
        summary["cases"][arch] = {
            "shape": [kvh, G, Dh], "dtype": str(dt).replace("torch.", ""),
            "err_paged_kernel": err1, "err_dense_kernel": err4,
            "launches": out["launches"], "ms": out["ms"],
            "coll_ms": out["coll_ms"], "build_s": build_s,
            "collectives": tp.calls}
        del model, dense, slab, mine, out
        _free()
    dist.destroy_process_group()
    (work / f"tp{world}_{rank}.json").write_text(json.dumps(summary))


def _near_tie(got: dict, one: dict, step: str, tokens: slice = None):
    """None where an MoE step routed every token as the one-rank model
    did; else, in the first layer whose picks differ, the largest gap
    between the one-rank model's router probabilities of the expert it
    took and the one the rank took (a near tie if tiny; later layers
    follow from the first difference).  ``tokens``: the rank's tokens
    among the one-rank model's (a data shard's), each layer's picks
    taken flat."""
    key = f"{step}/experts"
    if key not in got:
        return None
    mine, theirs, probs = one[key], got[key], one[f"{step}/probs"]
    if tokens is not None:
        mine, theirs = mine.flatten(1, -2)[:, tokens], theirs.flatten(1, -2)
        probs = probs.flatten(1, -2)[:, tokens]
    mine, theirs = mine.sort(-1).values, theirs.sort(-1).values
    if torch.equal(mine, theirs):
        return None
    first = int((mine != theirs).flatten(1).any(1).nonzero()[0])
    mine, theirs = mine[first], theirs[first]
    probs = probs[first]
    gap = 0.0
    for idx in (mine != theirs).any(-1).nonzero().tolist():
        a, b = set(mine[tuple(idx)].tolist()), set(theirs[tuple(idx)].tolist())
        p = probs[tuple(idx)]
        for e_mine, e_theirs in zip(sorted(a - b), sorted(b - a)):
            gap = max(gap, abs(float(p[e_mine] - p[e_theirs])))
    return gap


def _scale_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over want's largest value."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def tp_phase(smi: str, work: Path) -> dict:
    """Phase 11: for each of TP_CASES the one-rank model on the card (the
    seeded weights, ``tp_steps`` without a group) and, for a bf16 model,
    the same weights and inputs in fp32 (the exact run); then 2 and 4
    gloo ranks sharing the card (``tp_rank_main``, one process each):
    each rank's logits (every step) and its cache and slab blocks
    (``local_block`` over ``model``) as far from the exact run as the
    one-rank model is, plus TP_TOL of the scale; one kernel-1 grid a
    layer in its paged step and one kernel-4 grid a layer in its dense
    step.  Every case is printed before a failure ends the run.  Times
    are host milliseconds of ranks sharing one card through gloo: a
    layout test, not a multi-card figure."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.models import transformer as ttf
    t_phase = time.perf_counter()
    counted = counted_kernels()
    one, exact, spread, failures = {}, {}, {}, []
    for arch, layers in TP_CASES:
        cfg = tp_config(arch, layers)
        inp = tp_inputs(cfg, TP_DTYPE[arch])
        torch.save(inp, work / f"tp_in_{arch}.pt")
        model = ttf.init_params(cfg, torch.Generator(device="cuda").manual_seed(
            TP_SEED), device="cuda", dtype=TP_DTYPE[arch])
        one[arch] = tp_steps(ttf, model, inp, counted)
        if model.dtype != torch.float32:   # the same weights and inputs in fp32
            model = ttf.Transformer(cfg, {n: p.detach().float() for n, p in
                                          model.named_parameters()})
            exact[arch] = tp_steps(ttf, model, inp, counted, timed=False)
        else:
            exact[arch] = one[arch]
        # the fp32 network's own spread: its logits with the embeddings
        # moved by a relative 1e-7 (uniform noise from TP_SEED)
        g = torch.Generator(device="cuda").manual_seed(TP_SEED)
        model.embed.mul_(1 + (torch.rand(model.embed.shape, generator=g,
                                         device="cuda") - 0.5) * 2e-7)
        moved = tp_steps(ttf, model, inp, counted, timed=False)
        spread[arch] = max(_scale_err(moved[k], exact[arch][k])
                           for k in moved if k.endswith("/logits"))
        del model
        _free()
    result = {"one_rank_ms": {a: one[a]["ms"] for a in one},
              "fp32_spread": spread}
    for world in TP_WORLDS:
        init = work / f"tp{world}.pg"
        logs = [work / f"tp{world}_{r}.log" for r in range(world)]
        procs = []
        t0 = time.perf_counter()
        try:
            for r in range(world):
                with open(logs[r], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-rank",
                         str(r), str(world), str(init), str(work)],
                        stdout=log, stderr=subprocess.STDOUT))
            for r, p in enumerate(procs):
                if p.wait(timeout=TP_RANK_TIMEOUT) != 0:
                    fail(f"11: rank {r} of {world} exited {p.returncode}:\n"
                         + logs[r].read_text()[-3000:])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        ranks = [json.loads((work / f"tp{world}_{r}.json").read_text())
                 for r in range(world)]
        mesh = sh.MeshAxes(("model",), (world,))
        by_arch = {}
        for arch, layers in TP_CASES:
            cfg = tp_config(arch, layers)
            tol = TP_TOL[TP_DTYPE[arch]]
            # each output against the fp32 run of the same weights and
            # inputs: within the one-rank model's own distance from it
            # plus tol of its scale
            errs = {"logits": [0.0, 0.0], "cache": [0.0, 0.0]}
            flips = []
            for r, rk in enumerate(ranks):
                got = torch.load(work / f"tp{world}_{r}_{arch}.pt")
                flipped = set()
                for step in ("paged", "dense", "prefill"):
                    gap = _near_tie(got, one[arch], step)
                    if gap is None:
                        continue
                    flips.append((r, step, gap))
                    if gap <= TP_TIE:
                        flipped.add(step)      # a near tie: not compared
                    else:
                        failures.append(
                            f"{arch} over {world} ranks, rank {r}'s {step} "
                            f"routing differs from the one-rank model's, "
                            f"{gap:.3e} apart (more than {TP_TIE})")
                for key in got:
                    step, what = key.split("/")
                    if what in ("experts", "probs") or step in flipped:
                        continue
                    want, mine = exact[arch][key], one[arch][key]
                    if what != "logits":
                        axes = (tpm.SLAB_AXES if step == "paged"
                                else ttf.cache_axes(cfg)[what])
                        blk = sh.local_block(sh.spec_for(
                            axes, want.shape, mesh, sh.RULES_DEFAULT),
                            want.shape, mesh, (r,))
                        want, mine = want[blk], mine[blk]
                    e_tp, e_one = _scale_err(got[key], want), _scale_err(mine, want)
                    kind = "logits" if what == "logits" else "cache"
                    errs[kind] = [max(errs[kind][0], e_tp),
                                  max(errs[kind][1], e_one)]
                    if not e_tp <= e_one + tol:
                        failures.append(
                            f"{arch} over {world} ranks, rank {r}'s {key}: "
                            f"{e_tp:.3e} of the scale from the fp32 run, the "
                            f"one-rank model {e_one:.3e} (tolerance + {tol})")
                case = rk["cases"][arch]
                for step, name in (("paged", "flash_decode_paged"),
                                   ("dense", "flash_decode")):
                    if case["launches"][step][name] != cfg.num_layers:
                        failures.append(
                            f"{arch} rank {r} of {world}: {step} step launched "
                            f"{name} {case['launches'][step][name]} times, want "
                            f"one a layer ({cfg.num_layers})")
            cases = [rk["cases"][arch] for rk in ranks]
            by_arch[arch] = {
                "shape": cases[0]["shape"], "dtype": cases[0]["dtype"],
                "errs": errs, "tol": tol,
                "kernel_errs": [max(c["err_paged_kernel"], c["err_dense_kernel"])
                                for c in cases],
                "ms": [c["ms"] for c in cases],
                "coll_ms": [c["coll_ms"] for c in cases],
                "launches": {s: {n: sum(c["launches"][s][n] for c in cases)
                                 for n in counted} for s in ("paged", "dense",
                                                             "prefill")}}
            b = by_arch[arch]
            phase("tp", f"11 {arch} ({cfg.num_layers} layers, full width, "
                  f"{b['dtype']}) over {world} gloo ranks on one card: each "
                  f"rank's kernels at KVH {b['shape'][0]}, G {b['shape'][1]}, "
                  f"Dh {b['shape'][2]} (kernel 1 and 4 against their plain "
                  f"versions, max_abs_err {max(b['kernel_errs']):.3e}, "
                  f"atol=rtol=2e-3); logits of the paged, dense and prefill "
                  f"steps {errs['logits'][0]:.3e} of the scale from the fp32 "
                  f"run of the same weights (the one-rank model "
                  f"{errs['logits'][1]:.3e}; the fp32 run's own logits move "
                  f"{spread[arch]:.3e} under a 1e-7 relative move of its "
                  f"embeddings), cache and slab blocks "
                  f"{errs['cache'][0]:.3e} (one rank {errs['cache'][1]:.3e}; "
                  f"tolerance: the one-rank model's + {tol})"
                  + (f", MoE routing as the one-rank model's but at near "
                     f"ties (rank, step, probability gap) {flips}, those "
                     f"steps not compared" if flips else "")
                  + "; one kernel-1 grid a layer a paged step and one kernel-4 "
                  f"grid a dense step on every rank; "
                  f"ms a paged step {[round(x, 2) for x in b['ms']]} against "
                  f"{one[arch]['ms']:.2f} on one rank, collectives "
                  f"{[round(x, 2) for x in b['coll_ms']]} ms of it (host "
                  f"clock, gloo through the host, ranks sharing one card: a "
                  f"layout test, not a multi-card figure); on {smi}")
        result[f"tp{world}"] = {"wall_s": wall, "archs": by_arch}
    # kernels 1 and 4 alone at each rank shape, on this process alone
    from repro_torch.kernels import flash_decode as fd
    shapes = sorted({(tuple(b["shape"]), b["dtype"]) for w in TP_WORLDS
                     for b in result[f"tp{w}"]["archs"].values()})
    MB = -(-max(TP_LENGTHS) // TP_PS) + 1
    result["local"] = []
    for (kvh, G, Dh), dtn in shapes:
        dt = getattr(torch, dtn)
        pc = decode_case(TP_B, kvh, G, Dh, TP_PS, MB, TP_LENGTHS, seed=60,
                         dtype=dt)
        dc = dense_case(TP_B, TP_S, kvh, G, Dh, TP_LENGTHS, seed=61, dtype=dt)
        row = {"shape": [kvh, G, Dh], "dtype": dtn}
        for name, fn, work in (
                ("flash_decode_paged", lambda: fd.flash_decode_paged(*pc),
                 decode_work(pc[0], pc[1], pc[3], pc[4], 0)),
                ("flash_decode", lambda: fd.flash_decode(*dc),
                 dense_work(dc, 0))):
            b, by = bound(*work)
            row[name] = {"ms": device_ms(fn, calls=20), "bound_ms": b,
                         "bound_by": by}
        result["local"].append(row)
        phase("tp", f"11 kernels alone at a rank's shape KVH {kvh}, G {G}, Dh "
              f"{Dh} ({dtn}; B {TP_B}, lengths {TP_LENGTHS}): "
              + "; ".join(f"{n} {row[n]['ms']:.4f} ms device a call, bound "
                          f"{row[n]['bound_ms']:.5f} ms ({row[n]['bound_by']})"
                          for n in ("flash_decode_paged", "flash_decode"))
              + f"; on {smi}")
    result["s"] = time.perf_counter() - t_phase
    phase("tp", f"phase 11 in {result['s']:.1f} s")
    if failures:
        fail("11: " + "; ".join(failures))
    return result


def tp_main() -> None:
    """Phase 11 alone, the kernels built first."""
    need_card()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card_line()
    phase("card", f"{smi} | torch: {torch.cuda.get_device_name(0)}")
    _build.build_all(_build.SOURCES)
    with tempfile.TemporaryDirectory() as d:
        out = tp_phase(smi, Path(d))
    print(smi)
    print(json.dumps({"tensor_parallel": out}))


def tpt_batch(cfg, rows: int = TPT_B) -> dict:
    """Phase 12's (and 13's) global batch on the host, from TPT_SEED:
    tokens and labels [rows, TPT_S] uniform over the vocabulary."""
    g = torch.Generator().manual_seed(TPT_SEED)
    return {k: torch.randint(0, cfg.vocab_size, (rows, TPT_S), generator=g,
                             dtype=torch.int32) for k in ("tokens", "labels")}


def tpt_cases(world: int, fsdp: bool) -> list:
    """(arch, layers, (data, model) mesh, act_spec, first rank) of each
    training case that ``world`` ranks run, in turn: phase 12's TPT_MESH,
    or phase 13's FST_CASES.  A case runs on ranks [first, first + data
    x model), so cases in a row on other ranks run at once."""
    if fsdp:
        return FST_CASES[world]
    return [(a, layers) + TPT_MESH[(a, world)] + (0,)
            for a, layers in TPT_CASES]


def _case_key(arch: str, mesh) -> str:
    return f"{arch}@{mesh[0]}x{mesh[1]}"


def _forward_picks(moe, picks: list, layers: int):
    """(the real ``moe.route``, a wrapper of it that records each layer's
    picks [T, K] and router probabilities [T, E] of the step's forward
    into ``picks``: the first ``layers`` calls, so not the recompute;
    the recompute in backward routes the same tokens again)."""
    route = moe.route

    def recorded(router, x, cfg, *tp):
        r = route(router, x, cfg, *tp)
        if len(picks) < layers:
            picks.append((r.experts.reshape(-1, r.experts.shape[-1]),
                          r.probs.detach().reshape(-1, r.probs.shape[-1])))
        return r
    return route, recorded


def _tpt_groups(meshes, rank: int) -> dict:
    """{((data, model), first): (TPGroup, this rank's (data, model)
    coordinate, the group of the mesh's ranks)} for each mesh of
    ``meshes`` on ranks [first, first + data x model), every rank making
    every group: plain groups of the ``model`` and ``data`` axes; (None,
    None, None) for a rank off the mesh."""
    import torch.distributed as dist

    from repro_torch.distributed import tensor_parallel as tpm
    out = {}
    for (data, m), f in sorted(set(meshes)):
        mg = [dist.new_group([f + d * m + i for i in range(m)])
              for d in range(data)]
        dg = [dist.new_group([f + d * m + i for d in range(data)])
              for i in range(m)]
        every = dist.new_group(list(range(f, f + data * m)))
        r = rank - f
        out[((data, m), f)] = ((tpm.TPGroup(mg[r // m], data=dg[r % m]
                                            if data > 1 else None),
                                (r // m, r % m), every)
                               if 0 <= r < data * m else (None, None, None))
    return out


def _tpt_restore(params: dict, path: Path, block) -> None:
    """Overwrite ``params`` with their blocks (``block(name)``) of the
    one-rank run's parameters saved at ``path`` (memory-mapped)."""
    one = torch.load(path, mmap=True)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(one[n][block(n)])


def _tpt_gaps(params: dict, path: Path, block, leaf_max) -> tuple:
    """After a step: for each leaf, the largest |parameter - the one-rank
    run's after the same step| (``path``, memory-mapped; ``block(name)``
    the part this process holds) over the elements whose gradient is 0 or
    above 1e-4 of its leaf's max-abs (``leaf_max`` of this process's
    largest; where it is not, Adam's step is about +-lr whichever way
    the rounding points), with |gradient| / max-abs at that element;
    and the count of the elements left out."""
    one = torch.load(path, mmap=True)
    gaps, out = {}, 0
    with torch.no_grad():
        for n, p in params.items():
            g = p.grad.abs()
            gmax = leaf_max(g.max().reshape(1).clone())
            near = (g != 0) & (g <= 1e-4 * gmax)
            out += int(near.sum())
            d = (p - one[n][block(n)].to(p.device)).abs().masked_fill_(near, 0)
            at = int(d.argmax())
            gaps[n] = [float(d.flatten()[at]),
                       float(g.flatten()[at] / gmax.clamp(min=1e-30))]
    return gaps, out


def tpt_rank_main(rank: int, world: int, init: str, work: Path,
                  fsdp: bool = False) -> None:
    """One rank of phase 12 (or, ``fsdp``, phase 13) over gloo on the
    card: for each of ``tpt_cases(world, fsdp)``, its blocks (under
    RULES_DEFAULT, or RULES_FSDP: split over ``data`` too) of the seeded
    fp32 model (every rank's full model built at once) and zero
    moments, TPT_STEPS of ``make_tp_train_step`` on the case's mesh with
    ``act_spec`` as it says and the mesh's ``TPGroup``, step s > 0 from
    its blocks of the one-rank run's parameters after step s - 1
    (``work``/tpt_p<s-1>_<arch>.pt) and its own moments; each step timed
    (collectives' host seconds beside), its loss, grad norm and
    ``max_memory_allocated`` from its start, then ``_tpt_gaps`` against
    ``work``/tpt_p<s>_<arch>.pt.  Phase 13's ranks on FSS_MESH then run
    ``fss_rank`` (the FSDP serve steps).  Writes
    ``work``/tpt<world>_<rank>.json and its MoE picks."""
    need_card()
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.models import moe
    from repro_torch.models import transformer as ttf
    from repro_torch.training import (OptConfig, init_opt_state,
                                      make_tp_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    cases = tpt_cases(world, fsdp)
    serve = fsdp and world == math.prod(FSS_MESH)
    groups = _tpt_groups([c[2::2] for c in cases] + ([(FSS_MESH, 0)]
                                                      if serve else []), rank)
    rules = sh.RULES_FSDP if fsdp else sh.RULES_DEFAULT
    opt = OptConfig(**TPT_OPT)
    summary = {"rank": rank, "cases": {}}
    for arch, layers, (data, m), act, first in cases:
        tp, coord, every = groups[((data, m), first)]
        if tp is None:          # another case runs on this rank's ranks
            continue
        key = _case_key(arch, (data, m))
        cfg = tp_config(arch, layers)
        mesh = sh.MeshAxes(("data", "model"), (data, m))
        batch = {k: v.cuda() for k, v in
                 torch.load(work / f"tpt_in_{arch}.pt").items()}
        # every rank's full model on the card at once (a fp32 llama3-8b at
        # 4 layers is 7.7 GB), then its blocks
        full = ttf.init_params(cfg, torch.Generator(device="cuda").manual_seed(
            TPT_SEED), device="cuda", dtype=torch.float32)
        model = tpm.shard_model(full, cfg, mesh, rules, coord=coord)
        del full
        _free()
        dist.barrier(group=every)
        model.set_trainable()
        lay = model.tp_layout
        params = dict(model.named_parameters())
        state = init_opt_state(params, opt)
        step = make_tp_train_step(cfg, opt, act_spec=act, **TPT_KW)
        rows, picks = [], []
        for s in range(TPT_STEPS):
            if s:
                _tpt_restore(params, work / f"tpt_p{s - 1}_{arch}.pt",
                             lay.block)
            picks_s = []
            route, recorded = _forward_picks(moe, picks_s, cfg.num_layers)
            torch.cuda.synchronize()
            dist.barrier(group=every)
            torch.cuda.reset_peak_memory_stats()
            tp.timed, tp.seconds, tp.calls, tp.data_calls = True, 0.0, 0, 0
            moe.route = recorded
            t0 = time.perf_counter()
            try:
                model, state, met = step(model, state, batch, tp)
            finally:
                moe.route = route
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            tp.timed = False
            gaps, out = _tpt_gaps(params, work / f"tpt_p{s}_{arch}.pt",
                                  lay.block, tp.all_reduce_max)
            rows.append({"loss": float(met["loss"]),
                         "grad_norm": float(met["grad_norm"]), "ms": ms,
                         "coll_ms": 1e3 * tp.seconds, "calls": tp.calls,
                         "data_calls": tp.data_calls, "peak_bytes": peak,
                         "gaps": gaps, "left_out": out})
            if picks_s:
                picks.append([torch.stack([e for e, _ in picks_s]).cpu(),
                              torch.stack([p for _, p in picks_s]).cpu()])
        if picks:
            torch.save(picks, work / f"tpt{world}_{rank}_{key}_picks.pt")
        T = batch["tokens"].numel() // data     # the rank's tokens
        summary["cases"][key] = {
            "steps": rows, "elements": sum(p.numel() for p in params.values()),
            "moment_elements": sum(v.numel() for k in ("m", "v")
                                   for v in state[k].values()),
            "tokens": [tp.data_rank * T, (tp.data_rank + 1) * T]}
        del model, state, params, step
        _free()
    if serve:
        summary["serve"] = fss_rank(rank, world, work,
                                    groups[(FSS_MESH, 0)][:2])
    dist.destroy_process_group()
    (work / f"tpt{world}_{rank}.json").write_text(json.dumps(summary))


def _tpt_tie(picks, one, tokens) -> float | None:
    """None where a rank's forward of a step routed its tokens as the
    one-rank model's did; else, in the first layer whose picks differ,
    the largest gap between the one-rank model's router probabilities of
    the expert it took and the one the rank took."""
    e, (oe, op) = picks[0], one
    oe, op = oe[:, tokens[0]:tokens[1]], op[:, tokens[0]:tokens[1]]
    mine, theirs = oe.sort(-1).values, e.sort(-1).values
    if torch.equal(mine, theirs):
        return None
    first = int((mine != theirs).flatten(1).any(1).nonzero()[0])
    gap = 0.0
    for t in (mine[first] != theirs[first]).any(-1).nonzero().flatten():
        a, b = set(mine[first, t].tolist()), set(theirs[first, t].tolist())
        for x, y in zip(sorted(a - b), sorted(b - a)):
            gap = max(gap, abs(float(op[first, t, x] - op[first, t, y])))
    return gap


def _tpt_one(cfg, opt, batch: dict, work: Path, arch: str) -> tuple:
    """The one-rank run of phase 12 (or 13): the seeded fp32 model and
    zero moments, TPT_STEPS steps of ``make_train_step``, the parameters
    after step s saved to ``work``/tpt_p<s>_<arch>.pt.  Returns (each
    step's metrics, timing and peak; each step's MoE picks)."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as ttf
    from repro_torch.training import init_opt_state, make_train_step
    model = ttf.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        TPT_SEED), device="cuda", dtype=torch.float32).set_trainable()
    state = init_opt_state(dict(model.named_parameters()), opt)
    step = make_train_step(cfg, opt, **TPT_KW)
    rows, picks = [], []
    for s in range(TPT_STEPS):
        picks_s = []
        route, recorded = _forward_picks(moe, picks_s, cfg.num_layers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        moe.route = recorded
        t0 = time.perf_counter()
        try:
            model, state, met = step(model, state, batch)
        finally:
            moe.route = route
        torch.cuda.synchronize()
        rows.append({"loss": float(met["loss"]),
                     "grad_norm": float(met["grad_norm"]),
                     "ms": 1e3 * (time.perf_counter() - t0),
                     "peak_bytes": torch.cuda.max_memory_allocated()})
        if picks_s:
            picks.append([torch.stack([e for e, _ in picks_s]).cpu(),
                          torch.stack([p for _, p in picks_s]).cpu()])
        torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
                   work / f"tpt_p{s}_{arch}.pt")
    del model, state, step
    _free()
    return rows, picks


def _spawn_ranks(flag: str, world: int, work: Path, label: str) -> float:
    """Start ``world`` processes of ``chip_smoke.py flag RANK WORLD INIT
    WORK`` and wait for them; fail with a rank's log where one fails.
    Returns the wall seconds."""
    init = work / f"{flag.strip('-')}{world}.pg"
    logs = [work / f"{flag.strip('-')}{world}_{r}.log" for r in range(world)]
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), flag,
                     str(r), str(world), str(init), str(work)],
                    stdout=log, stderr=subprocess.STDOUT))
        for r, p in enumerate(procs):
            if p.wait(timeout=TP_RANK_TIMEOUT) != 0:
                fail(f"{label}: rank {r} of {world} exited {p.returncode}:\n"
                     + logs[r].read_text()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return time.perf_counter() - t0


def tp_train_phase(smi: str, work: Path, fsdp: bool = False) -> dict:
    """Phase 12 (or, ``fsdp``, phase 13's training): for each arch of
    the phase's cases the one-rank model on the card (the seeded fp32
    weights, ``make_train_step``, TPT_STEPS steps on the global batch of
    TPT_B, or FST_B, rows), its parameters after each step saved for the
    ranks, the model freed before they start.  Then the ranks of each
    world sharing the card (``tpt_rank_main``, one process each;
    ``tpt_cases``), each step from the one-rank run's parameters before
    it: in every step each rank's loss within 1e-5 and grad norm within
    1e-4 of the one-rank model's (relative), and each of its parameter
    blocks after the step within 2e-4 of the one-rank model's but for
    the elements whose gradient was within 1e-4 of its leaf's max-abs of
    0 (their share printed).  An MoE step whose forward routed a token
    otherwise than the one-rank model's on some rank is allowed only at
    a near tie (TP_TIE of router probability, as in phase 11), and that
    step's numbers are then not compared on any rank (the gradients'
    all-reduce carries the flip to every rank); the other steps are.
    Phase 13's world of FSS_MESH's size also serves (``fss_rank``,
    checked by ``fss_check``).  Times are host milliseconds of ranks
    sharing one card through gloo: a layout test, not a multi-card
    figure."""
    from repro_torch.training import OptConfig
    t_phase = time.perf_counter()
    n = "13" if fsdp else "12"
    rows_b = FST_B if fsdp else TPT_B
    worlds = sorted(FST_CASES) if fsdp else TPT_WORLDS
    opt = OptConfig(**TPT_OPT)
    one, failures = {}, []
    for arch, layers in dict.fromkeys(c[:2] for w in worlds
                                      for c in tpt_cases(w, fsdp)):
        cfg = tp_config(arch, layers)
        batch = tpt_batch(cfg, rows_b)
        torch.save(batch, work / f"tpt_in_{arch}.pt")
        rows, picks = _tpt_one(cfg, opt, {k: v.cuda() for k, v in
                                          batch.items()}, work, arch)
        one[arch] = {"steps": rows, "picks": picks}
    result = {"one_rank": {a: one[a]["steps"] for a in one}}
    if fsdp:
        result["serve_one_rank"] = fss_one(work)
    tol = {"loss": 1e-5, "grad_norm": 1e-4, "param": 2e-4}
    for world in worlds:
        wall = _spawn_ranks("--fsdp-rank" if fsdp else "--tpt-rank", world,
                            work, n)
        every = [json.loads((work / f"tpt{world}_{r}.json").read_text())
                 for r in range(world)]
        by_case = {}
        for arch, layers, (data, m), act, first in tpt_cases(world, fsdp):
            key = _case_key(arch, (data, m))
            cfg = tp_config(arch, layers)
            ref = one[arch]
            ranks = every[first:first + data * m]
            flips, skip = [], set()
            for r, rk in enumerate(ranks, start=first):
                if not ref["picks"]:
                    break
                got = torch.load(work / f"tpt{world}_{r}_{key}_picks.pt")
                for s in range(TPT_STEPS):
                    gap = _tpt_tie(got[s], ref["picks"][s],
                                   rk["cases"][key]["tokens"])
                    if gap is None:
                        continue
                    flips.append((r, s, gap))
                    skip.add(s)
                    if gap > TP_TIE:
                        failures.append(
                            f"{key} over {world} ranks, rank {r}'s step {s} "
                            f"routed otherwise than the one-rank model, "
                            f"{gap:.3e} apart (more than a near tie, "
                            f"{TP_TIE:g})")
            # each step's largest errors over the ranks: loss, grad norm
            # (relative), parameters (absolute) and the leaf, rank and
            # |gradient| / max-abs where that one lies
            errs = []
            for s in range(TPT_STEPS):
                want = ref["steps"][s]
                e = {"loss": 0.0, "grad_norm": 0.0, "param": 0.0,
                     "where": None, "compared": s not in skip}
                for r, rk in enumerate(ranks, start=first):
                    got = rk["cases"][key]["steps"][s]
                    for k in ("loss", "grad_norm"):
                        e[k] = max(e[k], abs(got[k] - want[k]) / abs(want[k]))
                    for name, (gap, rel) in got["gaps"].items():
                        if gap > e["param"]:
                            e["param"], e["where"] = gap, [name, r, rel]
                errs.append(e)
                if s in skip:
                    continue
                for k in tol:
                    if not e[k] <= tol[k]:
                        failures.append(
                            f"{key} over {world} ranks, step {s}: {k} "
                            f"{e[k]:.3e} from the one-rank model's (tolerance "
                            f"{tol[k]:g}{', ' + str(e['where']) if k == 'param' else ''})")
            cases = [rk["cases"][key] for rk in ranks]
            left = sum(st["left_out"] for c in cases for st in c["steps"])
            total = TPT_STEPS * sum(c["elements"] for c in cases)
            steady = [[st["ms"] for st in c["steps"][1:]] for c in cases]
            coll = [[st["coll_ms"] for st in c["steps"][1:]] for c in cases]
            ms = [sum(x) / len(x) for x in steady]
            cms = [sum(x) / len(x) for x in coll]
            b = by_case[key] = {
                "arch": arch, "layers": layers,
                "mesh": [data, m], "act_spec": act, "errs": errs, "tol": tol,
                "tie": TP_TIE, "flips": flips, "left_out": left,
                "elements": total, "ms": ms, "coll_ms": cms,
                "param_elements": [c["elements"] for c in cases],
                "moment_elements": [c["moment_elements"] for c in cases],
                "one_rank_ms": sum(st["ms"] for st in ref["steps"][1:])
                / max(len(ref["steps"]) - 1, 1),
                "one_rank_peak_bytes": max(st["peak_bytes"]
                                           for st in ref["steps"]),
                "peak_bytes": [max(st["peak_bytes"] for st in c["steps"])
                               for c in cases],
                "calls": [c["steps"][0]["calls"] for c in cases],
                "data_calls": [c["steps"][0]["data_calls"] for c in cases]}
            each = "; ".join(
                f"step {s}: " + (f"loss {e['loss']:.2e}, grad norm "
                                 f"{e['grad_norm']:.2e}, parameters "
                                 f"{e['param']:.2e} ({e['where'][0]})"
                                 if e["compared"] else "not compared (a flip)")
                for s, e in enumerate(errs))
            phase("tp", f"{n} {arch} ({cfg.num_layers} layers, full width, "
                  f"fp32{', RULES_FSDP' if fsdp else ''}) trained "
                  f"{TPT_STEPS} steps of {rows_b} x {TPT_S} "
                  f"tokens over {data * m} gloo ranks on a ({data}, {m}) mesh"
                  + (f" (ranks {first}-{first + data * m - 1} of {world})"
                     if data * m < world else "") + ", "
                  f"act_spec {'on' if act else 'off'}, each step from the "
                  f"one-rank model's parameters before it, against the "
                  f"one-rank make_train_step on the card: {each} (loss and "
                  f"grad norm relative, tolerances 1e-5 and 1e-4; parameters "
                  f"absolute, 2e-4, {left} of {total} element-steps "
                  f"({100 * left / total:.4f}%) left out: a gradient within "
                  f"1e-4 of its leaf's max-abs of 0)"
                  + (f"; MoE routing as the one-rank model's but at near ties "
                     f"(rank, step, gap) {flips}, within {TP_TIE:g}" if flips
                     else "; MoE routing as the one-rank model's"
                     if ref["picks"] else "")
                  + f"; {b['calls'][0]} model and {b['data_calls'][0]} data "
                  f"collectives a step a rank; "
                  + (f"parameter elements a rank {b['param_elements']} "
                     f"(moments {b['moment_elements']}); " if fsdp else "")
                  + f"ms a step "
                  f"{[round(x, 1) for x in ms]} against {b['one_rank_ms']:.1f} "
                  f"on one rank, collectives {[round(x, 1) for x in cms]} ms "
                  f"of it ({100 * sum(cms) / max(sum(ms), 1e-9):.0f}%; host "
                  "clock, gloo through the host, ranks sharing one card: a "
                  "layout test, not a multi-card figure); peak "
                  f"{[round(x / 1e9, 2) for x in b['peak_bytes']]} GB a rank, "
                  f"{b['one_rank_peak_bytes'] / 1e9:.2f} on one rank "
                  f"(max_memory_allocated over a step); on {smi}")
        result[f"tpt{world}"] = {"wall_s": wall, "cases": by_case}
        if fsdp and world == math.prod(FSS_MESH):
            result["serve"] = fss_check(smi, work, every,
                                        result["serve_one_rank"], failures)
    result["s"] = time.perf_counter() - t_phase
    phase("tp", f"phase {n} in {result['s']:.1f} s")
    if failures:
        fail(f"{n}: " + "; ".join(failures))
    return result


def tp_train_memory(smi: str, tpt: dict, fsdp: bool = False,
                    predicted: dict = None) -> list:
    """Phase 10's check of phase 12's (or 13's) memory, after the phase:
    ``dry_run_cell``'s rank-0 tensor-parallel (FSDP) train peak at the
    phase's shape (its mesh, ``act_spec``, chunks, fp32 weights and
    moments; ``predicted``, where it was taken before the run) beside
    each rank's measured ``max_memory_allocated`` over a step; the gap
    printed, and phase 13's 5% aim met or NOT met (a finding, not a
    failure)."""
    rows = []
    for world in (sorted(FST_CASES) if fsdp else TPT_WORLDS):
        for arch, layers, mesh, act, _ in tpt_cases(world, fsdp):
            key = _case_key(arch, mesh)
            b = tpt[f"tpt{world}"]["cases"][key]
            d = (predicted or {}).get(key) or _plan_check(
                tp_train_plan(arch, layers, mesh, act, fsdp)(), arch, mesh)
            pred = d["memory"]["peak_bytes"]
            meas = max(b["peak_bytes"])
            gap = pred / max(meas, 1) - 1
            rows.append({"case": key, "world": world, "mesh": b["mesh"],
                         "predicted_bytes": pred, "measured_bytes": b["peak_bytes"],
                         "gap": gap, "tp_program": d["tp_program"],
                         "rules": d["rules_used"]})
            aim = ("; aim within 5%: "
                   + ("met" if abs(gap) <= 0.05 else "NOT met") if fsdp else "")
            phase("launch", f"memory (phase {13 if fsdp else 12}) {arch} over "
                  f"{math.prod(mesh)} ranks ({tuple(b['mesh'])} mesh, act_spec "
                  f"{'on' if b['act_spec'] else 'off'}, {d['rules_used']}): "
                  f"dry run's rank 0 "
                  f"({d['tp_program']}) {pred / 1e9:.3f} GB (arguments "
                  f"{d['memory']['argument_bytes'] / 1e9:.3f} + temporaries "
                  f"{d['memory']['temp_bytes'] / 1e9:.3f}) against measured "
                  f"{[round(x / 1e9, 3) for x in b['peak_bytes']]} GB a rank: "
                  f"{100 * gap:+.1f}% of the largest{aim} (a finding, not a "
                  f"failure); on {smi}")
    return rows


def tp_train_plan(arch: str, layers: int, mesh, act: bool, fsdp: bool):
    """``dry_run_cell`` of a phase-12 (or 13) training case at its shape
    (rank 0's program under RULES_DEFAULT, or RULES_FSDP), as a call to
    make (``_plan_check`` its result)."""
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.distributed.sharding import MeshAxes
    from repro_torch.launch import dryrun
    rows = FST_B if fsdp else TPT_B
    return functools.partial(
        dryrun.dry_run_cell, arch, "phase13" if fsdp else "phase12",
        mesh=MeshAxes(("data", "model"), tuple(mesh)),
        cfg=tp_config(arch, layers),
        suite=ShapeSuite("phase13" if fsdp else "phase12", "train_step",
                         TPT_S, rows),
        attn_chunk=TPT_KW["attn_chunk"], loss_chunk=TPT_KW["loss_chunk"],
        remat_group=TPT_KW["remat_group"], param_dtype=torch.float32,
        variant={"accum": 1, "rules": "fsdp" if fsdp else "default",
                 "act_mode": "model" if act else "none"},
        verbose=False)


def _plan_check(d: dict, arch: str, mesh) -> dict:
    if d["status"] != "ok":
        fail(f"launch: dry run of {arch} on {tuple(mesh)}: {d.get('error')}")
    return d


def fss_one(work: Path) -> dict:
    """Phase 13's serving reference: for each of FSS_CASES the seeded
    fp32 model on one rank (``tp_steps`` without a group, untimed) on
    ``tp_inputs``, saved for the check; the model freed."""
    from repro_torch.models import transformer as ttf
    counted = counted_kernels()
    out = {}
    for arch, layers in FSS_CASES:
        cfg = tp_config(arch, layers)
        inp = tp_inputs(cfg, torch.float32)
        torch.save(inp, work / f"fss_in_{arch}.pt")
        model = ttf.init_params(cfg, torch.Generator(device="cuda").manual_seed(
            TP_SEED), device="cuda", dtype=torch.float32)
        res = tp_steps(ttf, model, inp, counted, timed=False)
        torch.save(res, work / f"fss_one_{arch}.pt")
        out[arch] = {"launches": res["launches"]}
        del model, res
        _free()
    return out


def _fss_rows(data: int, dc: int) -> dict:
    """A data shard's rows of phase 13's serve inputs: the dense step's
    of TP_B, the prompt's of 2."""
    return {"dense": slice(dc * TP_B // data, (dc + 1) * TP_B // data),
            "prefill": slice(dc * 2 // data, (dc + 1) * 2 // data)}


def fss_rank(rank: int, world: int, work: Path, group) -> dict:
    """A rank's FSDP serving in phase 13, on FSS_MESH with its ``TPGroup``
    and coordinate ``group``: for each of FSS_CASES its RULES_FSDP blocks
    of the seeded fp32 model (every rank's full model built at once),
    its data shard's rows and its block of the dense cache and of the
    slab (``shard_cache``), then ``tp_steps`` (launch counts set to 0
    just before each step and read after; a paged step runs every row
    on every data replica).  Saves its outputs to
    ``work``/fss_<rank>_<arch>.pt."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.models import transformer as ttf
    from repro_torch.serving.kv_cache import KVPageSlab
    tp, coord = group
    mesh = sh.MeshAxes(("data", "model"), FSS_MESH)
    counted = counted_kernels()
    out = {}
    for arch, layers in FSS_CASES:
        cfg = tp_config(arch, layers)
        inp = torch.load(work / f"fss_in_{arch}.pt")
        # every rank's full model at once (11.2 GB at 8 fp32 llama3-8b
        # layers), then its blocks
        full = ttf.init_params(cfg, torch.Generator(device="cuda").manual_seed(
            TP_SEED), device="cuda", dtype=torch.float32)
        model = tpm.shard_model(full, cfg, mesh, sh.RULES_FSDP, coord=coord)
        del full
        _free()
        dist.barrier()
        rows = _fss_rows(FSS_MESH[0], coord[0])
        dense = tpm.shard_cache({"k": inp["k"], "v": inp["v"]}, cfg, mesh,
                                sh.RULES_FSDP, coord=coord)
        slab = tpm.shard_cache(KVPageSlab(k=inp["k_slab"], v=inp["v_slab"],
                                          page_size=TP_PS), cfg, mesh,
                               sh.RULES_FSDP, coord=coord)
        mine = dict(inp, k=dense["k"], v=dense["v"], k_slab=slab.k,
                    v_slab=slab.v, dense_token=inp["token"][rows["dense"]],
                    pos=inp["pos"][rows["dense"]],
                    tokens=inp["tokens"][rows["prefill"]])
        tp.calls = tp.data_calls = 0
        res = tp_steps(ttf, model, mine, counted, tp, timed=False)
        torch.save({k: v for k, v in res.items() if isinstance(v, torch.Tensor)},
                   work / f"fss_{rank}_{arch}.pt")
        out[arch] = {"launches": res["launches"], "calls": tp.calls,
                     "data_calls": tp.data_calls,
                     "elements": sum(p.numel() for p in model.parameters())}
        del model, dense, slab, mine, res
        _free()
    return out


def fss_check(smi: str, work: Path, ranks: list, one: dict,
              failures: list) -> dict:
    """Phase 13's serve check: each rank's logits (its rows; a paged
    step's every row), cache and slab blocks (``local_block`` under
    RULES_FSDP) against the fp32 one-rank run of the same weights and
    inputs, within TP_TOL[fp32] of the scale, an MoE step whose routing
    differs only at a near tie (TP_TIE, in its first differing layer)
    not compared; one kernel-1 grid a layer a paged step and one kernel-4
    grid a dense step on every rank."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.models import transformer as ttf
    mesh = sh.MeshAxes(("data", "model"), FSS_MESH)
    data, m = FSS_MESH
    tol = TP_TOL[torch.float32]
    out = {}
    for arch, layers in FSS_CASES:
        cfg = tp_config(arch, layers)
        want_all = torch.load(work / f"fss_one_{arch}.pt")
        errs, flips = {"logits": 0.0, "cache": 0.0}, []
        for r, rk in enumerate(ranks):
            dc = r // m
            rows = _fss_rows(data, dc)
            got = torch.load(work / f"fss_{r}_{arch}.pt")
            flipped = set()
            for step in ("paged", "dense", "prefill"):
                # the rank's tokens: every row's (paged), its rows' one
                # token (dense) or TP_PROMPT (prefill)
                per = {"paged": 0, "dense": 1, "prefill": TP_PROMPT}[step]
                sl = (slice(None) if not per else slice(
                    rows[step].start * per, rows[step].stop * per))
                gap = _near_tie(got, want_all, step, sl)
                if gap is None:
                    continue
                flips.append((r, step, gap))
                if gap <= TP_TIE:
                    flipped.add(step)
                else:
                    failures.append(
                        f"FSDP {arch} rank {r}'s {step} routing differs from "
                        f"the one-rank model's, {gap:.3e} apart (more than "
                        f"{TP_TIE})")
            for key in got:
                step, what = key.split("/")
                if what in ("experts", "probs") or step in flipped:
                    continue
                want = want_all[key]
                if what == "logits":
                    if step != "paged":
                        want = want[rows[step]]
                else:
                    axes = (tpm.SLAB_AXES if step == "paged"
                            else ttf.cache_axes(cfg)[what])
                    want = want[sh.local_block(sh.spec_for(
                        axes, want.shape, mesh, sh.RULES_FSDP), want.shape,
                        mesh, (dc, r % m))]
                e = _scale_err(got[key], want)
                kind = "logits" if what == "logits" else "cache"
                errs[kind] = max(errs[kind], e)
                if not e <= tol:
                    failures.append(f"FSDP {arch} rank {r}'s {key}: {e:.3e} "
                                    f"of the scale from the one-rank run "
                                    f"(tolerance {tol})")
            case = rk["serve"][arch]
            for step, name in (("paged", "flash_decode_paged"),
                               ("dense", "flash_decode")):
                if case["launches"][step][name] != cfg.num_layers:
                    failures.append(
                        f"FSDP {arch} rank {r}: {step} step launched {name} "
                        f"{case['launches'][step][name]} times, want one a "
                        f"layer ({cfg.num_layers})")
        cases = [rk["serve"][arch] for rk in ranks]
        b = out[arch] = {
            "errs": errs, "tol": tol, "flips": flips,
            "calls": [c["calls"] for c in cases],
            "data_calls": [c["data_calls"] for c in cases],
            "elements": [c["elements"] for c in cases],
            "launches": {s: {n: sum(c["launches"][s][n] for c in cases)
                             for n in cases[0]["launches"][s]}
                         for s in ("paged", "dense", "prefill")}}
        phase("tp", f"13 {arch} ({cfg.num_layers} layers, full width, fp32, "
              f"RULES_FSDP) served over {data * m} gloo ranks on a {FSS_MESH} "
              f"mesh: logits of the paged, dense and prefill steps "
              f"{errs['logits']:.3e} of the scale from the one-rank fp32 run, "
              f"cache and slab blocks {errs['cache']:.3e} (tolerance {tol})"
              + (f", MoE routing as the one-rank model's but at near ties "
                 f"(rank, step, gap) {flips}, those steps not compared"
                 if flips else "")
              + f"; one kernel-1 grid a layer a paged step and one kernel-4 "
              f"grid a dense step on every rank (summed: "
              f"{b['launches']['paged']['flash_decode_paged']} and "
              f"{b['launches']['dense']['flash_decode']}); parameter "
              f"elements a rank {b['elements']}; {b['calls'][0]} model and "
              f"{b['data_calls'][0]} data collectives a rank over the three "
              f"steps (untimed: each step gathers the whole model through "
              f"gloo's host path); on {smi}")
    return out


def fsdp_phase(smi: str, work: Path) -> dict:
    """Phase 13: the dry run's rank-0 peak of each training case first
    (``tp_train_plan``, printed before the run), then
    ``tp_train_phase(fsdp=True)`` (training, and FSDP serving on
    FSS_MESH), then the ranks' measured peaks beside the predictions
    (``tp_train_memory``)."""
    cases = [c[:4] for w in sorted(FST_CASES) for c in FST_CASES[w]]
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(len(cases), os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        cells = list(pool.map(_call, [tp_train_plan(*c, True) for c in cases]))
    phase("launch", f"13: {len(cases)} dry runs in "
          f"{time.perf_counter() - t0:.1f} s (one process each)")
    predicted = {}
    for (arch, layers, mesh, act), d in zip(cases, cells):
        d = predicted[_case_key(arch, mesh)] = _plan_check(d, arch, mesh)
        phase("launch", f"13 prediction: {arch} ({layers} layers, fp32) on "
              f"a {tuple(mesh)} mesh, act_spec {'on' if act else 'off'}: dry "
              f"run's rank 0 ({d['tp_program']}, {d['rules_used']}) "
              f"{d['memory']['peak_bytes'] / 1e9:.3f} GB a rank (arguments "
              f"{d['memory']['argument_bytes'] / 1e9:.3f} + temporaries "
              f"{d['memory']['temp_bytes'] / 1e9:.3f})")
    out = tp_train_phase(smi, work, fsdp=True)
    out["memory"] = tp_train_memory(smi, out, fsdp=True, predicted=predicted)
    return out


def tpt_main() -> None:
    """Phase 12 alone (no kernel runs on its path), then phase 10's check
    of its memory."""
    need_card()
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card_line()
    phase("card", f"{smi} | torch: {torch.cuda.get_device_name(0)}")
    with tempfile.TemporaryDirectory() as d:
        out = tp_train_phase(smi, Path(d))
    out["memory"] = tp_train_memory(smi, out)
    print(smi)
    print(json.dumps({"tp_train": out}))


def fsdp_main() -> None:
    """Phase 13 alone, the kernels built first (its serve steps launch
    kernels 1 and 4)."""
    need_card()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card_line()
    phase("card", f"{smi} | torch: {torch.cuda.get_device_name(0)}")
    _build.build_all(_build.SOURCES)
    with tempfile.TemporaryDirectory() as d:
        out = fsdp_phase(smi, Path(d))
    print(smi)
    print(json.dumps({"fsdp": out}))


def _call(fn):
    """``fn()``, in a worker process."""
    return fn()


def meta_bits_cases() -> list:
    """Phase 10(d)'s seeded phase-3 cases: (name, wrapper, args, kwargs)
    of flash_decode (softcapped, gemma2's shape), flash_decode_quant and
    mla_decode (minicpm3's shape), each at the serve length."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import mla_decode as mla
    KVH, G, Dh = GEMMA2_SHAPE
    dense = dense_case(4, 128, KVH, G, Dh, RAGGED_POS, seed=140)
    quant = quant_case(dense_case(4, 128, KVH, G, Dh, [127, 96, 40, 0],
                                  seed=150))
    H, R, Dr = MLA_SHAPE
    lat = mla_case(4, 128, H, R, Dr, [127, 96, 40, 0], seed=160)
    return [("flash_decode", fd.flash_decode, dense,
             {"softcap": GEMMA2_SOFTCAP}),
            ("flash_decode_quant", fd.flash_decode_quant, quant,
             {"softcap": GEMMA2_SOFTCAP}),
            ("mla_decode", mla.mla_decode, lat + (MLA_SCALE,), {})]


def launch_phase(smi: str, train: dict, families: list, dense: dict,
                 bits_before: dict) -> dict:
    """Phase 10, the launch tooling on the card host (no training or
    serving of its own; the meta traces run on the host's CPU):
    (a) ``launch.env.validate()`` of this process, a finding;
    (b) ``dryrun.dry_run_cell``'s per-card peak for each of phase 8's
        trainings at the shape phase 8 ran (TRAIN_BATCH x TRAIN_SEQ,
        main's chunks, remat groups of 4, the moments it used, gemma2 at
        4 layers, a 1 x 1 mesh) beside phase 8's measured
        max_memory_allocated less what was held when it was reset; the
        aim: within 10% or 2 GB, printed met or NOT met;
    (c) the roofline's bound and model-FLOPs share for phase 8's
        Llama-3-8B step and a dense Llama-3-8B decode step (4 rows of
        128 positions, the dense serve's bucket) beside phase 6's dense
        serve's measured ms/step;
    (d) flash_decode, flash_decode_quant and mla_decode on their meta
        branches (their dry-run cells and direct calls under a counter):
        no launch counter moves, and their card outputs on seeded cases
        equal ``bits_before`` (taken before any meta trace) bit for bit.
    (d) fails the run; a missed (b) aim does not."""
    import dataclasses as dc
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.distributed.sharding import MeshAxes
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.launch import env as launch_env
    t0 = time.perf_counter()
    out = {"card": smi}
    diffs = launch_env.validate()
    out["env"] = [list(d) for d in diffs]
    phase("launch", "env: " + ("all recommendations active" if not diffs else
                               "; ".join(f"{k} = {have!r} (want {want!r})"
                                         for k, want, have in diffs))
          + " (a finding, not a failure)")

    cases = meta_bits_cases()
    counters = {name: fn for name, fn, _, _ in cases}
    launches0 = {n: fn.launches for n, fn in counters.items()}
    one = MeshAxes(("data", "model"), (1, 1))
    suite = ShapeSuite("phase8", "train_step", TRAIN_SEQ, TRAIN_BATCH)
    runs = [("llama3-8b", None, train)] + [
        (arch, layers, fam) for (arch, layers), fam in zip(FAMILY_TRAINS,
                                                           families)]
    out["memory"] = []
    # the meta traces are host work: one spawned process a training
    jobs = []
    for arch, layers, run in runs:
        cfg = get_arch(arch)
        if layers:
            cfg = dc.replace(cfg, num_layers=layers)
        jobs.append(functools.partial(
            dryrun.dry_run_cell, arch, "phase8", mesh=one, cfg=cfg,
            suite=suite, attn_chunk=min(256, TRAIN_SEQ), loss_chunk=128,
            remat_group=4, variant={
                "accum": 1, "moment_bf16": run["moments"] == "bfloat16"},
            verbose=False))
    t1 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(len(jobs), os.cpu_count() or 1),
            mp_context=ctx) as pool:
        cells = list(pool.map(_call, jobs))
    phase("launch", f"{len(jobs)} dry runs of phase 8's trainings in "
          f"{time.perf_counter() - t1:.1f} s ({min(len(jobs), os.cpu_count() or 1)} "
          "processes)")
    for (arch, layers, run), d in zip(runs, cells):
        cfg = get_arch(arch)
        if layers:
            cfg = dc.replace(cfg, num_layers=layers)
        if d["status"] != "ok":
            fail(f"launch: dry run of {arch}'s phase-8 training: "
                 f"{d.get('error')}")
        pred = d["memory"]["peak_bytes"]
        meas = run["peak_bytes"] - run["held_bytes"]
        met = abs(pred - meas) <= max(0.10 * meas, 2e9)
        row = {"arch": arch, "layers": cfg.num_layers,
               "moments": run["moments"], "predicted_bytes": pred,
               "argument_bytes": d["memory"]["argument_bytes"],
               "temp_bytes": d["memory"]["temp_bytes"],
               "measured_bytes": meas, "met": met,
               "trace_s": d["t_lower_s"]}
        out["memory"].append(row)
        if arch == "llama3-8b":
            out["train_roofline"] = d["roofline"]
        phase("launch", f"memory {arch} ({cfg.num_layers} layers, "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, {run['moments']} moments, "
              f"1 x 1 mesh): predicted {pred / 1e9:.2f} GB (arguments "
              f"{d['memory']['argument_bytes'] / 1e9:.2f} + temporaries "
              f"{d['memory']['temp_bytes'] / 1e9:.2f}) against measured "
              f"{meas / 1e9:.2f} GB (phase 8's max_memory_allocated "
              f"{run['peak_bytes'] / 1e9:.2f} less "
              f"{run['held_bytes'] / 1e9:.2f} held): "
              f"{100 * (pred / meas - 1):+.1f}%; aim within 10% or 2 GB: "
              f"{'met' if met else 'NOT met'} (traced in "
              f"{row['trace_s']:.1f} s; {smi})")

    # (c) the roofline beside the measured steps
    r = out["train_roofline"]
    ms = train["steady_ms"]
    phase("launch", f"roofline llama3-8b train step ({TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, 1 card): bound {1e3 * max(r['t_compute_s'], r['t_memory_s'], r['t_collective_s']):.2f} "
          f"ms ({r['bottleneck']}; compute {1e3 * r['t_compute_s']:.2f}, "
          f"memory {1e3 * r['t_memory_s']:.2f}), measured {ms:.1f} ms/step "
          f"(the bound is {100 * max(r['t_compute_s'], r['t_memory_s']) / (ms / 1e3):.1f}% of it); "
          f"model FLOPs {r['model_flops'] / 1e12:.2f} T = "
          f"{100 * r['model_flops'] / (ms / 1e3 * BF16_TC_FLOPS):.2f}% of the "
          f"measured step at the bf16 peak (counted FLOPs "
          f"{r['hlo_flops_global'] / 1e12:.2f} T); on {smi}")
    d = dryrun.dry_run_cell(
        "llama3-8b", "phase6", mesh=one,
        suite=ShapeSuite("phase6", "serve_step", 128, 4), verbose=False)
    if d["status"] != "ok":
        fail(f"launch: dry run of llama3-8b's decode step: {d.get('error')}")
    rd = d["roofline"]
    ms_dec = 1e3 * dense["decode_s"] / dense["decode_steps"]
    bound = max(rd["t_compute_s"], rd["t_memory_s"], rd["t_collective_s"])
    phase("launch", f"roofline llama3-8b dense decode step (4 rows, 128 "
          f"positions): bound {1e3 * bound:.3f} ms ({rd['bottleneck']}; "
          f"bytes {rd['hlo_bytes_global'] / 1e9:.2f} GB), measured "
          f"{ms_dec:.2f} ms/step in phase 6's dense serve (waves of 1-4 "
          f"rows): the bound is {100 * bound / (ms_dec / 1e3):.1f}% of it; model "
          f"FLOPs share {100 * rd['model_flops'] / (ms_dec / 1e3 * BF16_TC_FLOPS):.4f}% "
          f"at the bf16 peak; on {smi}")
    out["decode_roofline"] = rd
    out["decode_ms"] = ms_dec

    # (d) the three wrappers on meta directly, then the card's bits
    for name, fn, args, kw in cases:
        meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in args]
        c = op_cost.op_cost(lambda *a: fn(*a, **kw), *meta)
        if not c["flops"]:
            fail(f"launch: {name}'s meta branch counted no work")
    for arch, shape in (("gemma2-27b", "decode_32k"), ("minicpm3-4b",
                                                       "decode_32k")):
        d = dryrun.dry_run_cell(arch, shape, mesh=one,
                                suite=ShapeSuite(shape, "serve_step", 128, 4),
                                variant={"kv_quant": arch == "gemma2-27b"},
                                verbose=False)
        if d["status"] != "ok":
            fail(f"launch: dry run of {arch} decode: {d.get('error')}")
    moved = {n: fn.launches - launches0[n] for n, fn in counters.items()}
    if any(moved.values()):
        fail(f"launch: the meta traces moved launch counters: {moved}")
    same = {}
    for name, fn, args, kw in cases:
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        same[name] = bool(torch.equal(got, bits_before[name]))
    if not all(same.values()):
        fail(f"launch: card outputs after the meta traces differ: {same}")
    out["bits_equal"] = same
    phase("launch", "meta branches: flash_decode, flash_decode_quant and "
          "mla_decode traced on meta (directly and in the dry runs' decode "
          "steps): no launch counter moved; their card outputs on seeded "
          f"phase-3 cases equal the ones before, bit for bit: {same}")
    out["phase_s"] = time.perf_counter() - t0
    phase("launch", f"phase 10 took {out['phase_s']:.1f} s")
    return out


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def need_card() -> None:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; chip_smoke.py needs "
              "an NVIDIA card", flush=True)
        sys.exit(1)


def decode_timing_main(root: Path, bits: Path) -> None:
    """Phase 7's decode timing alone (kernels 1, 4 and the spliced one),
    on the port under ``root``/src; the decode kernels' outputs on the
    seeded inputs of ``spliced_bits`` are saved to ``bits``."""
    need_card()
    if not (root / "src" / "repro_torch").is_dir():
        fail(f"{root} holds no src/repro_torch")
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    smi = card_line()
    t = decode_timing(fd, ref, smi)
    t["flash_decode_spliced"] = spliced_timing(fd, ref, smi)
    torch.save(spliced_bits(fd), bits)
    print(json.dumps({"root": str(root), "card": smi, "timing": t}))


def unchanged(parent: list, change: list) -> tuple:
    """(met, allowance): the change's mean within the larger of either
    side's spread (max - min over its runs) and 2% of the parent's mean."""
    pm, cm = float(np.mean(parent)), float(np.mean(change))
    allow = max(max(parent) - min(parent), max(change) - min(change), 0.02 * pm)
    return abs(cm - pm) <= allow, allow


def decode_ab_main(parent: Path) -> None:
    """The decode timing of ``parent``, this checkout, this checkout and
    ``parent``, one process each, side by side, with the aims: those at
    the long context judged on this checkout's mean, the serve-shape and
    the spliced kernel's aims against the parent's mean device time,
    kernels 1 and 4 against the parent's within the runs' spread; then
    the decode kernels' output bits of each run against the parent's."""
    need_card()
    out = ROOT / "chiprun_out" / "decode_ab"
    out.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, root in enumerate((parent, ROOT, ROOT, parent), 1):
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--decode-timing", str(root),
                               str(out / f"bits_run{i}.pt")],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            fail(f"decode timing of {root}: exit {proc.returncode}\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        phase("ab", f"run {i}: {root} on {runs[-1]['card']}")
    names = ("flash_decode", "flash_decode_paged", "flash_decode_spliced")
    extra = ("paged_ms", "paged_device_ms", "spliced_table_ms",
             "spliced_table_device_ms")
    mean = lambda rs, name, shape, key: float(np.mean(
        [r["timing"][name][shape][key] for r in rs]))
    sides = {"parent": [runs[0], runs[3]], "change": [runs[1], runs[2]]}
    avg = {side: {name: {shape: {k: mean(rs, name, shape, k)
                                 for k in rs[0]["timing"][name][shape]
                                 if isinstance(rs[0]["timing"][name][shape][k], float)}
                         for shape in ("serve", "mid", "long")}
                  for name in names}
           for side, rs in sides.items()}
    for name in names:
        for shape in ("serve", "mid", "long"):
            for key in ("ms", "device_ms", "grids_per_call", "host_us") + (
                    extra if name == "flash_decode_spliced" else ()):
                vals = " | ".join(f"{r['timing'][name][shape][key]:.4f}" for r in runs)
                phase("ab", f"{name} {shape} {key}: runs 1-4 (parent, change, "
                      f"change, parent) {vals}")
    for side in ("change", "parent"):
        t = avg[side]
        for name in t:
            for shape in t[name]:
                t[name][shape]["bound_ms"] = runs[1]["timing"][name][shape]["bound_ms"]
    card = runs[1]["card"]
    aims = decode_aims(avg["change"], avg["parent"]) + spliced_aims(
        avg["change"]["flash_decode_spliced"], avg["parent"]["flash_decode_spliced"])
    for name in ("flash_decode", "flash_decode_paged"):
        for shape in ("serve", "mid", "long"):
            dev = [r["timing"][name][shape]["device_ms"] for r in runs]
            met, allow = unchanged([dev[0], dev[3]], [dev[1], dev[2]])
            aims.append((f"{name} {shape}: device time a call unchanged", met,
                         f"change {np.mean(dev[1:3]):.4f} ms, parent "
                         f"{np.mean([dev[0], dev[3]]):.4f} ms, allowed "
                         f"difference {allow:.4f} ms (the larger side's spread "
                         "or 2%)"))
    for aim, met, numbers in aims:
        phase("aim", f"{aim}: {'met' if met else 'NOT met'} ({numbers}; means "
              f"of runs 2-3 against runs 1 and 4; {card})")
    bits = [torch.load(out / f"bits_run{i}.pt") for i in range(1, 5)]
    for i in (1, 2):
        same, worst = 0, (0.0, None)
        for label, want in bits[0].items():
            got = bits[i][label]
            if torch.equal(got, want):
                same += 1
            else:
                d = (got - want).abs().max().item()
                worst = max(worst, (d, label), key=lambda w: w[0])
        phase("ab", f"decode kernels' output bits, run {i + 1} against run 1 "
              f"(the parent): {same} of {len(bits[0])} cases equal"
              + (f"; largest difference {worst[0]:.3e} ({worst[1]})" if worst[1] else ""))
    phase("ab", "decode kernels' output bits, run 4 against run 1 (parent "
          f"twice): {sum(torch.equal(bits[3][k], v) for k, v in bits[0].items())} "
          f"of {len(bits[0])} cases equal")
    print(json.dumps({"decode_ab": runs}))


def attn_bits(fd, mla) -> dict:
    """Outputs on seeded inputs, by label: flash_decode_quant on phase 3's
    int8 cases (gemma2's serve and long lengths with a row at pos 0,
    bf16 and fp32 q, the reduced Dh = 32, G = 12 with a window and no
    softcap) and at the timing shapes, bf16 flash_decode softcapped on
    the same K/V, and mla_decode at minicpm3's and the reduced shapes
    over bf16 and fp32 caches."""
    KVH, G, Dh = GEMMA2_SHAPE
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        for qd in ((torch.bfloat16, torch.float32) if dtype == torch.float32
                   else (torch.bfloat16,)):
            qtag = "q bf16" if qd == torch.bfloat16 else "q fp32"
            for S, pos, seed in ((128, [127, 96, 40, 0], 150),
                                 (8192, [8191, 6143, 4999, 0], 151)):
                case = dense_case(4, S, KVH, G, Dh, pos, seed=seed, dtype=dtype,
                                  q_dtype=qd)
                out[f"quant S={S} {tag} cache, {qtag}"] = fd.flash_decode_quant(
                    *quant_case(case), softcap=GEMMA2_SOFTCAP).cpu()
        out[f"quant reduced Dh=32 {tag}"] = fd.flash_decode_quant(*quant_case(
            dense_case(3, 100, 4, 1, 32, [99, 3, 0], seed=152, dtype=dtype)),
            softcap=GEMMA2_SOFTCAP).cpu()
        out[f"quant G=12 window 20 {tag}"] = fd.flash_decode_quant(*quant_case(
            dense_case(3, 300, 2, 12, 64, [299, 100, 5], seed=153, dtype=dtype)),
            window=20).cpu()
        for (H, R, Dr), name in ((MLA_SHAPE, "minicpm3"), (MLA_REDUCED, "reduced")):
            for S, pos in ((128, [127, 96, 40, 0]), (8192, [8191, 6143, 4999, 0])):
                out[f"mla {name} S={S} {tag}"] = mla.mla_decode(*mla_case(
                    4, S, H, R, Dr, pos, seed=160, dtype=dtype), MLA_SCALE).cpu()
    for S in (128, 8192):
        case = dense_case(4, S, KVH, G, Dh, [S - 1] * 4, seed=170)
        out[f"quant timing S={S}"] = fd.flash_decode_quant(
            *quant_case(case), softcap=GEMMA2_SOFTCAP).cpu()
        out[f"softcap timing S={S}"] = fd.flash_decode(
            *case, softcap=GEMMA2_SOFTCAP).cpu()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def attn_timing_main(root: Path, bits: Path) -> None:
    """Phase 7's timing of the softcapped, int8 and MLA kernels
    (``gemma2_mla_timing``) alone on the port under ``root``/src; the
    outputs of ``attn_bits`` are saved to ``bits``."""
    need_card()
    if not (root / "src" / "repro_torch").is_dir():
        fail(f"{root} holds no src/repro_torch")
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import mla_decode as mla
    from repro_torch.kernels import ref
    smi = card_line()
    t = gemma2_mla_timing(fd, mla, ref, smi)
    torch.save(attn_bits(fd, mla), bits)
    print(json.dumps({"root": str(root), "card": smi, "timing": t}))


def faster(parent: list, change: list) -> tuple:
    """(met, margin): the change's mean below the parent's by more than
    the larger side's spread (max - min over its runs)."""
    margin = max(max(parent) - min(parent), max(change) - min(change))
    return float(np.mean(parent)) - float(np.mean(change)) > margin, margin


def attn_ab_main(parent: Path) -> None:
    """``--attn-timing`` of ``parent``, this checkout, this checkout and
    ``parent``, one process each, side by side; the aims on the device
    time a call (means of runs 2-3 against runs 1 and 4, and the fixed
    aims), printed met or NOT met; then flash_decode_quant's and bf16
    flash_decode's output bits of each run against the parent's, and
    mla_decode's difference from the parent's (its error against the
    plain version is in the timing lines)."""
    need_card()
    out = ROOT / "chiprun_out" / "attn_ab"
    out.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, root in enumerate((parent, ROOT, ROOT, parent), 1):
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--attn-timing", str(root),
                               str(out / f"bits_run{i}.pt")],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            fail(f"attn timing of {root}: exit {proc.returncode}\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        phase("ab", f"run {i}: {root} on {runs[-1]['card']}")
    card = runs[1]["card"]
    names = ("mla_decode", "flash_decode_quant", "flash_decode_softcap")
    for name in names:
        for shape in ("serve", "long"):
            for key in ("ms", "device_ms", "grids_per_call", "host_us") + (
                    ("max_abs_err",) if name == "mla_decode" else ()):
                vals = " | ".join(f"{r['timing'][name][shape][key]:.4g}" for r in runs)
                phase("ab", f"{name} {shape} {key}: runs 1-4 (parent, change, "
                      f"change, parent) {vals}")
    dev = lambda name, shape: [r["timing"][name][shape]["device_ms"] for r in runs]
    aims = []
    for name, shape in (("flash_decode_quant", "long"), ("mla_decode", "long"),
                        ("mla_decode", "serve")):
        d = dev(name, shape)
        met, margin = faster([d[0], d[3]], [d[1], d[2]])
        aims.append((f"{name} {shape}: device time a call below the parent's by "
                     "more than the larger side's spread", met,
                     f"change {np.mean(d[1:3]):.4f} ms, parent "
                     f"{np.mean([d[0], d[3]]):.4f} ms, spread {margin:.4f} ms"))
    q, b = dev("flash_decode_quant", "long"), dev("flash_decode_softcap", "long")
    aims.append(("flash_decode_quant long: below bf16 flash_decode's device time "
                 "in the same processes", q[1] < b[1] and q[2] < b[2],
                 f"runs 2, 3: {q[1]:.4f} / {q[2]:.4f} ms against "
                 f"{b[1]:.4f} / {b[2]:.4f} ms"))
    bq = runs[1]["timing"]["flash_decode_quant"]["long"]["bound_ms"]
    for name, shape, cap in (("flash_decode_quant", "long", AIM_QUANT_LONG_MS),
                             ("mla_decode", "long", AIM_MLA_LONG_MS),
                             ("mla_decode", "serve", AIM_MLA_SERVE_MS)):
        mine = float(np.mean(dev(name, shape)[1:3]))
        extra = (f", {bq / mine:.1%} of the {bq:.4f} ms bound"
                 if name == "flash_decode_quant" else "")
        aims.append((f"{name} {shape}: device time a call <= {cap} ms", mine <= cap,
                     f"{mine:.4f} ms{extra}"))
    for shape in ("serve", "long"):
        errs = [runs[i]["timing"]["mla_decode"][shape]["max_abs_err"] for i in (1, 2)]
        aims.append((f"mla_decode {shape} (bf16 cache): within {MLA_AIM_ERR:g} of "
                     "the plain version", max(errs) <= MLA_AIM_ERR,
                     f"max_abs_err {max(errs):.2e}"))
    for aim, met, numbers in aims:
        phase("aim", f"{aim}: {'met' if met else 'NOT met'} ({numbers}; runs 2-3 "
              f"against runs 1 and 4; {card})")
    bits = [torch.load(out / f"bits_run{i}.pt") for i in range(1, 5)]
    for i in (1, 2, 3):
        for kind in ("quant", "softcap", "mla"):
            labels = [k for k in bits[0] if k.startswith(kind)]
            same = sum(torch.equal(bits[i][k], bits[0][k]) for k in labels)
            worst = max((bits[i][k] - bits[0][k]).abs().max().item() for k in labels)
            phase("ab", f"{kind} output bits, run {i + 1} against run 1 (the "
                  f"parent): {same} of {len(labels)} cases equal, largest "
                  f"difference {worst:.3e}")
    print(json.dumps({"attn_ab": runs}))


def retrieval_timing_main(root: Path) -> None:
    """Kernels 2 and 3 alone, on the port under ``root``/src: their three
    times at the serve shapes, then each alone on ``retrieval_ab``'s
    buffer state (its index built without the full-width model)."""
    need_card()
    if not (root / "src" / "repro_torch").is_dir():
        fail(f"{root} holds no src/repro_torch")
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import ivf_topk as it
    from repro_torch.kernels import probe_topk as pt
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card_line()
    t = retrieval_timing(pt, it, ref, smi)
    setup = serve.build(serve.parse_args(SERVE_ARGS + ["--reduced", "--quiet"]))
    fused_ms, unfused_ms, hits, alone = retrieval_ab(serve, setup)
    print(json.dumps({"root": str(root), "card": smi, "timing": t,
                      "alone": alone, "round_ms": {
                          "fused": float(np.median(fused_ms)),
                          "unfused": float(np.median(unfused_ms))}}))


def retrieval_ab_main(parent: Path) -> None:
    """``--retrieval-timing`` of ``parent``, this checkout, this checkout
    and ``parent``, one process each, side by side, with the aims: the
    event-mean aims on the means of this checkout's runs, the device-time
    aim on every run."""
    need_card()
    runs = []
    for i, root in enumerate((parent, ROOT, ROOT, parent), 1):
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--retrieval-timing", str(root)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            fail(f"retrieval timing of {root}: exit {proc.returncode}\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        phase("ab", f"run {i}: {root} on {runs[-1]['card']}")
    names = ("probe_topk_fused", "ivf_topk")
    for name in names:
        for key in ("ms", "device_ms", "grids_per_call", "host_us"):
            vals = " | ".join(f"{r['timing'][name][key]:.4f}" for r in runs)
            phase("ab", f"{name} serve shape {key}: runs 1-4 (parent, change, "
                  f"change, parent) {vals}")
        for key in (name, f"{name}_device"):
            vals = " | ".join(f"{r['alone'][key]:.4f}" for r in runs)
            phase("ab", f"{key} alone on the resident state "
                  f"({runs[1]['alone']['pages_read']} pages): runs 1-4 {vals}")
    for mode in ("fused", "unfused"):
        vals = " | ".join(f"{r['round_ms'][mode]:.3f}" for r in runs)
        phase("ab", f"one {mode} retrieval round, median ms: runs 1-4 {vals}")
    change = [runs[1], runs[2]]
    mean = lambda xs: float(np.mean(xs))
    avg = {name: {**runs[1]["timing"][name],
                  **{k: mean([r["timing"][name][k] for r in change])
                     for k in ("ms", "device_ms", "host_us")}}
           for name in names}
    alone = {**runs[1]["alone"], **{n: mean([r["alone"][n] for r in change])
                                    for n in names}}
    for aim, met, numbers in retrieval_aims(
            avg, alone, parent=[runs[0]["timing"], runs[3]["timing"]],
            change=[r["timing"] for r in change]):
        phase("aim", f"{aim}: {'met' if met else 'NOT met'} ({numbers}; means "
              f"of runs 2-3, against runs 1 and 4; {runs[1]['card']})")
    print(json.dumps({"retrieval_ab": runs}))


def centroid_timing_main(root: Path) -> None:
    """Phase 5's timing of kernel 5 alone, on the port under ``root``/src."""
    need_card()
    if not (root / "src" / "repro_torch").is_dir():
        fail(f"{root} holds no src/repro_torch")
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import centroid_probe as cp
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card_line()
    print(json.dumps({"root": str(root), "card": smi,
                      "timing": centroid_timing(cp, ref, smi)}))


def centroid_ab_main(parent: Path) -> None:
    """``--centroid-timing`` of ``parent``, this checkout, this checkout
    and ``parent``, one process each, side by side, with the aims on the
    means of this checkout's runs, against the parent's every run."""
    need_card()
    runs = []
    for i, root in enumerate((parent, ROOT, ROOT, parent), 1):
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--centroid-timing", str(root)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            fail(f"centroid timing of {root}: exit {proc.returncode}\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        phase("ab", f"run {i}: {root} on {runs[-1]['card']}")
    keys = ("ms", "device_ms", "host_us", "cold_ms", "library_ms",
            "library_device_ms", "library_cold_ms")
    for shape in CENTROID_TIMING:
        for key in keys:
            vals = " | ".join(f"{r['timing'][shape][key]:.4f}" for r in runs)
            phase("ab", f"centroid_scores {shape} {key}: runs 1-4 (parent, "
                  f"change, change, parent) {vals}")
    change = [runs[1]["timing"], runs[2]["timing"]]
    avg = {shape: {**change[0][shape], **{k: float(np.mean([c[shape][k] for c in change]))
                                          for k in keys}}
           for shape in CENTROID_TIMING}
    for aim, met, numbers in centroid_aims(
            avg, parent=[runs[0]["timing"], runs[3]["timing"]]):
        phase("aim", f"{aim}: {'met' if met else 'NOT met'} ({numbers}; means "
              f"of runs 2-3, against runs 1 and 4; {runs[1]['card']})")
    print(json.dumps({"centroid_ab": runs}))


def main() -> None:
    need_card()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import centroid_probe as cp
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.kernels import ivf_topk as it
    from repro_torch.kernels import mla_decode as mla
    from repro_torch.kernels import probe_topk as pt
    from repro_torch.launch import serve
    from repro_torch.models import transformer as ttf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1) card
    smi = card_line()
    kind = torch.cuda.get_device_name(0)
    phase("card", f"{smi} | torch: {kind}, {torch.cuda.device_count()} device(s), "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")

    # 2) build, one nvcc per source, all at once
    t0 = time.perf_counter()
    sources = _build.SOURCES
    logs = _build.build_all(sources, verbose=True, force=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                phase("build", f"{name}: {line.strip()}")
    phase("build", f"{len(sources)} kernels built for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")

    # 3) kernel 1 against its plain version
    serve_dec = decode_case(4, 8, 4, 128, 16, 8, [128, 97, 40, 7], seed=1)
    small_dec = decode_case(3, 2, 1, 32, 2, 5, [10, 3, 7], seed=2)
    err_dec = max(check_decode(fd, ref, serve_dec, 0, "serve shapes"),
                  check_decode(fd, ref, small_dec, 3, "small shape"))
    check_decode(fd, ref, decode_case(2, 2, 8, 64, 5, 4, [20, 13], seed=3,
                                      dtype=torch.float32), 0, "fp32 G=8 Dh=64")
    long_dec = decode_case(4, 8, 4, 128, 16, 512, LONG_LENGTHS, seed=7)
    err_dec = max(
        err_dec, check_decode(fd, ref, long_dec, 0, "long context"),
        check_decode(fd, ref, decode_case(4, 8, 4, 128, 16, 128, MID_LENGTHS,
                                          seed=22), 0, "mid context"),
        check_decode(fd, ref, decode_case(4, 8, 4, 128, 16, 512, [300, 64, 1000, 2],
                                          seed=23), 0,
                     "8192-position table, later splits empty"),
        check_decode(fd, ref, decode_case(4, 8, 4, 128, 16, 512, [1] * 4, seed=24),
                     0, "lengths of 1 under an 8192-position table"),
        check_decode(fd, ref, decode_case(4, 8, 4, 128, 16, 128, MID_LENGTHS,
                                          seed=25), 300,
                     "window across split boundaries"),
        check_decode(fd, ref, decode_case(3, 4, 4, 128, 48, 40, [1920, 700, 47],
                                          seed=26), 0, "page size 48"),
        check_decode(fd, ref, decode_case(2, 2, 8, 64, 48, 40, [1900, 130], seed=27,
                                          dtype=torch.float32), 250,
                     "fp32, page size 48, window"))
    del long_dec

    # kernel 4 against its plain version
    serve_dense = dense_case(4, 128, 8, 4, 128, SERVE_POS, seed=11)
    ragged_dense = dense_case(4, 128, 8, 4, 128, RAGGED_POS, seed=12)
    long_dense = dense_case(4, 8192, 8, 4, 128, LONG_POS, seed=13)
    err_dense = max(
        check_dense(fd, ref, serve_dense, 0, "serve shape"),
        check_dense(fd, ref, ragged_dense, 0, "ragged positions"),
        check_dense(fd, ref, long_dense, 0, "long context"),
        check_dense(fd, ref, dense_case(3, 100, 2, 1, 32, [99, 50, 0], seed=14),
                    9, "window, G=1, S=100"),
        check_dense(fd, ref, dense_case(2, 300, 1, 8, 64, [299, 130], seed=15,
                                        dtype=torch.float32), 0, "MQA, fp32"),
        check_dense(fd, ref, dense_case(3, 77, 2, 3, 128, [76, 20, 64], seed=16,
                                        q_dtype=torch.float32), 25,
                    "fp32 q over bf16 K/V, window, S=77"),
        check_dense(fd, ref, dense_case(2, 1000, 4, 2, 64, [999, 500], seed=17),
                    700, "window across splits, S=1000"),
        check_dense(fd, ref, dense_case(3, 90, 2, 1, 64, [89, 30, 0], seed=18,
                                        dtype=torch.float32), 12,
                    "fp32 G=1, window, S=90"),
        check_dense(fd, ref, dense_case(4, 128, 8, 4, 128, [0] * 4, seed=19),
                    0, "pos 0"),
        check_dense(fd, ref, dense_case(4, 2048, 8, 4, 128, MID_POS, seed=28),
                    0, "mid context"),
        check_dense(fd, ref, dense_case(4, 8192, 8, 4, 128, [0, 1, 300, 64],
                                        seed=29), 0, "S=8192, later splits empty"),
        check_dense(fd, ref, dense_case(4, 2048, 8, 4, 128, MID_POS, seed=30),
                    300, "mid context, window across split boundaries"))
    del serve_dense, ragged_dense, long_dense

    # 4) kernel 2 against its plain version
    serve_ret = retrieval_case(4, 768, 1024, POOL_PAGES, 128, seed=4)
    small_ret = retrieval_case(3, 60, 24, 18, 8, seed=5)
    err_ret = max(check_retrieval(pt, ref, serve_ret, 64, 3, "serve shapes"),
                  check_retrieval(pt, ref, small_ret, 7, 5, "small shape"),
                  *retrieval_edges(pt, ref))

    # kernel 3 against its plain version, at the same pool
    serve_ivf = ivf_case(4, 768, POOL_PAGES, 128, seed=8)
    small_ivf = ivf_case(3, 60, 18, 8, seed=9, admit=0.5, empty_row=True)
    err_ivf = max(check_ivf(it, ref, serve_ivf, 3, "serve shapes"),
                  check_ivf(it, ref, small_ivf, 5, "small shape"),
                  *ivf_edges(it, ref))
    del serve_ret, serve_ivf

    # kernel 5 against its plain version
    err_cent = centroid_checks(cp, ops, ref)

    # the spliced-decode kernel against its plain version
    err_spl = spliced_checks(fd, ref)

    # the three decode kernels at the new configs' G, past 8 in tiles
    g_dec, g_dense, g_spl = g_checks(fd, ref)
    err_dec, err_dense, err_spl = (max(err_dec, g_dec), max(err_dense, g_dense),
                                   max(err_spl, g_spl))

    # this slice's kernels: kernel 4 softcapped and over a ring, its int8
    # variant, the MLA kernel; then the reduced gemma2 and minicpm3 steps
    err_cap, err_quant, err_mla = gemma2_mla_checks(fd, mla, ref)
    err_dense = max(err_dense, err_cap)
    # this slice's: kernel 4 at zamba2's Dh = 80
    err_dense = max(err_dense, zamba2_checks(fd, ref))
    # phase 10(d)'s bits, taken before anything runs on the meta device
    bits_before = {name: fn(*args, **kw).clone()
                   for name, fn, args, kw in meta_bits_cases()}

    check_model(ttf, get_arch)
    check_moe_layer(get_arch)
    for arch, kv_quant in (("gemma2-27b", False), ("gemma2-27b", True),
                           ("minicpm3-4b", False), ("rwkv6-3b", False),
                           ("zamba2-2.7b", False)):
        check_dense_family(ttf, get_arch, arch, kv_quant)
    for arch in ("rwkv6-3b", "zamba2-2.7b"):
        check_recurrent_prefill(ttf, get_arch, arch)

    # 5) timing of kernel 5, warm and cold (kernels 2 and 3 come after the serves)
    cent_t = centroid_timing(cp, ref, smi)
    for aim, met, numbers in centroid_aims(cent_t):
        phase("aim", f"{aim}: {'met' if met else 'NOT met'} ({numbers}; {smi})")
    phase("aim", "centroid_scores: faster than the parent's in every mode: "
          "judged by --centroid-ab PARENT")

    # 6) serving through the port's entry point: one build, Llama-3-8B's
    #    serves, then the other families' models on the same index, each
    #    path's launch counts set to 0 just before it and read after
    counted = {"flash_decode_paged": fd.flash_decode_paged,
               "probe_topk_fused": pt.probe_topk_fused, "ivf_topk": it.ivf_topk,
               "flash_decode": fd.flash_decode,
               "centroid_scores": cp.centroid_scores,
               "flash_decode_spliced": fd.flash_decode_spliced,
               "flash_decode_quant": fd.flash_decode_quant,
               "mla_decode": mla.mla_decode}
    launches = {"check": {n: fn.launches for n, fn in counted.items()}}
    setup = serve.build(serve.parse_args(SERVE_ARGS))
    summaries = {}
    for path, engine in (("fused", {}), ("unfused", {"fused_retrieval": False}),
                         ("dense", {"paged_decode": False})):
        for fn in counted.values():
            fn.launches = 0
        summary = summaries[path] = serve.serve(setup, **engine)
        launches[path] = {n: fn.launches for n, fn in counted.items()}
        phase("serve", json.dumps({"path": path, **{k: summary[k] for k in
                                                    SERVE_FIELDS}}))
        check_serve(path, summary)
        check_decode_launches(path, "flash_decode" if path == "dense"
                              else "flash_decode_paged", summary,
                              launches[path], setup.arch.num_layers)
        phase("kernels", json.dumps({"path": path, **launches[path]}))
        check_invariants(path, summary)
    want = {"fused": ("flash_decode_paged", "probe_topk_fused"),
            "unfused": ("flash_decode_paged", "ivf_topk"),
            "dense": ("flash_decode", "probe_topk_fused")}
    never = {path: tuple(n for n in counted if n not in names)
             for path, names in want.items()}
    for path, names in want.items():
        if min(launches[path][n] for n in names) < 1:
            fail(f"a kernel of the {path} path never launched: {launches[path]}")
        if any(launches[path][n] for n in never[path]):
            fail(f"the {path} path launched one of {never[path]}: "
                 f"{launches[path]}")
    launches["chunk"] = chunk_serve(serve, setup, summaries["fused"], counted)
    fused_ms, unfused_ms, hits, alone = retrieval_ab(serve, setup)
    q = lambda xs, p: float(np.percentile(xs, p))
    phase("time", f"one retrieval round, {hits} probed clusters all resident, "
          f"{len(fused_ms)} alternating pairs: fused median {q(fused_ms, 50):.3f} "
          f"ms (IQR {q(fused_ms, 25):.3f}-{q(fused_ms, 75):.3f}), unfused "
          f"median {q(unfused_ms, 50):.3f} ms (IQR {q(unfused_ms, 25):.3f}-"
          f"{q(unfused_ms, 75):.3f}); unfused faster in "
          f"{sum(u < f for f, u in zip(fused_ms, unfused_ms))} pairs; "
          f"same doc ids and partition; the kernels alone on that state "
          f"({alone['pages_read']} pages read): probe_topk_fused "
          f"{alone['probe_topk_fused']:.4f} ms (device "
          f"{alone['probe_topk_fused_device']:.4f}), ivf_topk "
          f"{alone['ivf_topk']:.4f} ms (device {alone['ivf_topk_device']:.4f}); "
          f"on {smi}")
    # the other families, Llama-3-8B's weights freed first
    fam_launches, fam_extra = family_serves(
        serve, setup, counted, smi,
        after={"gemma2-27b": lambda model: gemma2_quant_steps(ttf, model,
                                                              counted, smi)})
    launches.update(fam_launches)
    quant = fam_extra["gemma2-27b"]
    launches["gemma2 kv_quant"] = quant["int8"]["launches"]
    launches["musicgen"] = musicgen_steps(ttf, get_arch, counted, smi)

    # 7) the retrieval and decode kernels' three times, after the serves
    ret_t = retrieval_timing(pt, it, ref, smi)
    for name, want in (("probe_topk_fused", 2), ("ivf_topk", 1)):
        if ret_t[name]["grids_per_call"] != want:
            fail(f"{name}: {ret_t[name]['grids_per_call']} grids a call, "
                 f"want {want}")
    for aim, met, numbers in retrieval_aims(ret_t, alone):
        phase("aim", f"{aim}: {'met' if met else 'NOT met'} ({numbers}; {smi})")
    phase("aim", "each retrieval kernel: device time a call lower than the "
          "parent's in every run: judged by --retrieval-ab PARENT")
    decode_t = decode_timing(fd, ref, smi)
    for aim, met, numbers in decode_aims(decode_t):
        phase("aim", f"{aim}: {'met' if met else 'NOT met'} ({numbers}; {smi})")
    spliced_t = spliced_timing(fd, ref, smi)
    for aim, met, numbers in spliced_aims(spliced_t):
        phase("aim", f"{aim}: {'met' if met else 'NOT met'} ({numbers}; {smi})")
    g48_t = g48_timing(fd, ref, smi)
    gm_t = gemma2_mla_timing(fd, mla, ref, smi)
    zamba2_t = zamba2_timing(fd, ref, smi)
    phase("aim", "each decode kernel at the serve shape: device time a call no "
          "higher than the parent's; kernels 1 and 4 unchanged; the spliced "
          "kernel faster than the parent's at the long context: judged by "
          "--decode-ab PARENT")

    # 8) training on one card, with the serves' state freed: Llama-3-8B
    #    through launch/train, then every other family, one at a time
    #    (phase 9's slab saved first, the index's pages and ids)
    dist_dir = tempfile.TemporaryDirectory()
    slab = save_slab(setup.index.paged, serve.make_queries(
        setup.store, SEARCH_B, setup.args.seed + 11), Path(dist_dir.name))
    del setup
    train = train_phase(smi)
    families = [family_train(arch, layers, smi)
                for arch, layers in FAMILY_TRAINS]
    ckpt = [checkpoint_phase(arch) for arch in CKPT_ARCHS]
    phase("train", json.dumps({"train": train, "families": families,
                               "checkpoint": ckpt, "card": smi}))

    # 9) the distributed layer: the DP step over an NCCL world of 1, then
    #    two ranks on the card over gloo (the sharded search over the
    #    index's slab, each rank's launches set to 0 just before it)
    dist_out = distributed_phase(smi, Path(dist_dir.name), slab,
                                 train["losses"][0])
    dist_dir.cleanup()
    launches["distributed"] = {n: sum(r["launches"][n] for r in
                                      dist_out["9c"]["ranks"]) for n in counted}
    phase("kernels", json.dumps({"path": "distributed",
                                 **launches["distributed"]}))

    # 10) the launch tooling: env, predicted against measured memory, the
    #     roofline beside the measured steps, the meta branches' bits
    launch = launch_phase(smi, train, families, summaries["dense"],
                          bits_before)
    phase("launch", json.dumps(launch))

    # 11) tensor parallelism: 2 and 4 gloo ranks sharing the card, each
    #     rank's launch counts set to 0 just before each step and read after
    with tempfile.TemporaryDirectory() as d:
        tp_out = tp_phase(smi, Path(d))
    for world in TP_WORLDS:
        launches[f"tp{world}"] = {
            n: sum(a["launches"][s][n] for a in tp_out[f"tp{world}"]["archs"]
                   .values() for s in ("paged", "dense", "prefill"))
            for n in counted}
        phase("kernels", json.dumps({"path": f"tp{world}",
                                     **launches[f"tp{world}"]}))
    tp_local = {name: [{"shape": r["shape"], "dtype": r["dtype"], **r[name]}
                       for r in tp_out["local"]]
                for name in ("flash_decode_paged", "flash_decode")}

    # 12) tensor-parallel training: 2 and 4 gloo ranks sharing the card
    #     against the one-rank train step; then phase 10's check of its
    #     ranks' memory against the dry run's rank 0
    with tempfile.TemporaryDirectory() as d:
        tpt_out = tp_train_phase(smi, Path(d))
    tpt_out["memory"] = tp_train_memory(smi, tpt_out)
    phase("tp", json.dumps({"tp_train": tpt_out}))

    # 13) FSDP: the dry run's rank-0 peaks first, then training over 2 and
    #     4 gloo ranks sharing the card, and the serve steps over 4, each
    #     rank's launch counts set to 0 just before each step and read after
    with tempfile.TemporaryDirectory() as d:
        fs_out = fsdp_phase(smi, Path(d))
    world = math.prod(FSS_MESH)
    launches[f"fsdp{world}"] = {
        n: sum(a["launches"][s].get(n, 0) for a in fs_out["serve"].values()
               for s in ("paged", "dense", "prefill")) for n in counted}
    phase("kernels", json.dumps({"path": f"fsdp{world}",
                                 **launches[f"fsdp{world}"]}))
    phase("tp", json.dumps({"fsdp": fs_out}))
    phase("done", f"{time.perf_counter() - t_start:.1f} s")

    kernels = [
        {"name": "flash_decode_paged", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode_paged.cu",
         "replaces": "src/repro/kernels/flash_decode.py:201",
         "launches": launches["fused"]["flash_decode_paged"],
         "launches_by_path": {p: c["flash_decode_paged"]
                              for p, c in launches.items()},
         "max_abs_err": err_dec, **decode_json(decode_t["flash_decode_paged"]),
         "granite20b": g48_t["flash_decode_paged"],
         "tp_local_shapes": tp_local["flash_decode_paged"]},
        {"name": "probe_topk_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/probe_topk.cu",
         "replaces": "src/repro/kernels/probe_topk.py:172",
         "launches": launches["fused"]["probe_topk_fused"],
         "launches_by_path": {p: c["probe_topk_fused"]
                              for p, c in launches.items()},
         "max_abs_err": err_ret, **ret_t["probe_topk_fused"],
         "alone_on_resident_state_ms": alone["probe_topk_fused"]},
        {"name": "ivf_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ivf_topk.cu",
         "replaces": "src/repro/kernels/ivf_topk.py:110",
         "launches": launches["unfused"]["ivf_topk"],
         "launches_by_path": {p: c["ivf_topk"] for p, c in launches.items()},
         "max_abs_err": err_ivf, **ret_t["ivf_topk"],
         "alone_on_resident_state_ms": alone["ivf_topk"]},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:88",
         "launches": launches["dense"]["flash_decode"],
         "launches_by_path": {p: c["flash_decode"] for p, c in launches.items()},
         "max_abs_err": err_dense, **decode_json(decode_t["flash_decode"]),
         "granite20b": g48_t["flash_decode"],
         "gemma2_softcap": gm_t["flash_decode_softcap"],
         "gemma2_ring": gm_t["flash_decode_ring"]["long"],
         "zamba2_dh80": zamba2_t,
         "tp_local_shapes": tp_local["flash_decode"]},
        {"name": "centroid_scores", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/centroid_scores.cu",
         "replaces": "src/repro/kernels/centroid_probe.py:42",
         "launches": launches["dense"]["centroid_scores"],
         "launches_by_path": {p: c["centroid_scores"]
                              for p, c in launches.items()},
         "max_abs_err": err_cent, **cent_t["serve"],
         "paper_scale": cent_t["paper"]},
        {"name": "flash_decode_spliced", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode_spliced.cu",
         "replaces": "none: no TPU kernel; the reference runs its jnp oracle "
                     "src/repro/kernels/ref.py:93 in every mode "
                     "(src/repro/kernels/ops.py:200)",
         "launches": launches["chunk"]["flash_decode_spliced"],
         "launches_by_path": {p: c["flash_decode_spliced"]
                              for p, c in launches.items()},
         "max_abs_err": err_spl, **decode_json(spliced_t),
         "granite20b": g48_t["flash_decode_spliced"]},
        {"name": "flash_decode_quant", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode_quant.cu",
         "replaces": "src/repro/kernels/flash_decode.py:88 over the int8 cache "
                     "that src/repro/models/attention.py:124 (attn_decode_quant) "
                     "dequantizes in jnp",
         "launches": launches["gemma2 kv_quant"]["flash_decode_quant"],
         "launches_by_path": {p: c.get("flash_decode_quant", 0)
                              for p, c in launches.items()},
         "max_abs_err": err_quant, **gm_t["flash_decode_quant"]["serve"],
         "long_context": gm_t["flash_decode_quant"]["long"],
         "kv_quant_steps": {k: quant[k] for k in ("int8", "bf16", "dequantized",
                                                  "logits")}},
        {"name": "mla_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mla_decode.cu",
         "replaces": "none: no TPU kernel; the reference attends over the "
                     "latent cache in jnp (src/repro/models/mla.py:91, "
                     "mla_decode)",
         "launches": launches["minicpm3-4b"]["mla_decode"],
         "launches_by_path": {p: c.get("mla_decode", 0)
                              for p, c in launches.items()},
         **gm_t["mla_decode"]["serve"], "max_abs_err": err_mla,
         "long_context": gm_t["mla_decode"]["long"]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--decode-timing":
        decode_timing_main(Path(sys.argv[2]).resolve(), Path(sys.argv[3]))
    elif len(sys.argv) == 3 and sys.argv[1] == "--decode-ab":
        decode_ab_main(Path(sys.argv[2]).resolve())
    elif len(sys.argv) == 4 and sys.argv[1] == "--attn-timing":
        attn_timing_main(Path(sys.argv[2]).resolve(), Path(sys.argv[3]))
    elif len(sys.argv) == 3 and sys.argv[1] == "--attn-ab":
        attn_ab_main(Path(sys.argv[2]).resolve())
    elif len(sys.argv) == 3 and sys.argv[1] == "--retrieval-timing":
        retrieval_timing_main(Path(sys.argv[2]).resolve())
    elif len(sys.argv) == 3 and sys.argv[1] == "--retrieval-ab":
        retrieval_ab_main(Path(sys.argv[2]).resolve())
    elif len(sys.argv) == 3 and sys.argv[1] == "--centroid-timing":
        centroid_timing_main(Path(sys.argv[2]).resolve())
    elif len(sys.argv) == 3 and sys.argv[1] == "--centroid-ab":
        centroid_ab_main(Path(sys.argv[2]).resolve())
    elif len(sys.argv) == 2 and sys.argv[1] == "--distributed":
        distributed_main()
    elif len(sys.argv) == 6 and sys.argv[1] == "--dist-rank":
        dist_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                       Path(sys.argv[5]))
    elif len(sys.argv) == 2 and sys.argv[1] == "--tensor-parallel":
        tp_main()
    elif len(sys.argv) == 6 and sys.argv[1] == "--tp-rank":
        tp_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                     Path(sys.argv[5]))
    elif len(sys.argv) == 2 and sys.argv[1] == "--tp-train":
        tpt_main()
    elif len(sys.argv) == 6 and sys.argv[1] == "--tpt-rank":
        tpt_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                      Path(sys.argv[5]))
    elif len(sys.argv) == 2 and sys.argv[1] == "--fsdp":
        fsdp_main()
    elif len(sys.argv) == 6 and sys.argv[1] == "--fsdp-rank":
        tpt_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                      Path(sys.argv[5]), fsdp=True)
    elif len(sys.argv) == 1:
        main()
    else:
        fail(f"usage: {sys.argv[0]} [--decode-timing DIR BITS | --decode-ab "
             "PARENT | --attn-timing DIR BITS | --attn-ab PARENT | "
             "--retrieval-timing DIR | --retrieval-ab PARENT | "
             "--centroid-timing DIR | --centroid-ab PARENT | --distributed | "
             "--tensor-parallel | --tp-train | --fsdp]")
