#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all at once), print ptxas's registers and spills,
   and count the tensor-core instructions (HGMMA, HMMA) in the flash,
   grouped-matmul and SSD-scan libraries' SASS where the toolkit has
   cuobjdump: the bf16 flash kernel and K7's prefill kernel must have
   HGMMA, K8's bf16 C·Bᵀ HMMA or HGMMA;
2. parity: hold each kernel against its plain PyTorch version on the card
   at several shapes, in bf16 and f32 (f32 references with TF32 off); the
   state-push kernels K1-K4 at the serve/stats size and a ragged one, K1
   also against the numpy host codec bitwise, K4 against its plain
   version's e4m3 cast bitwise; K7 (grouped matmul) at the decode, down
   projection and prefill shapes of deepseek-moe-16b, with all rows in one
   expert, with rows past the last group (which must come out zero), with
   fewer rows than one tile, at T on and one past the threshold between
   its two bf16 kernels, with groups starting inside a TMA box, with one
   empty expert among 64, with a quarter of 8,192 rows past the groups,
   at f 200, and at d 32 (streamed at any T) with one 300-row group and
   with rows past the groups, in bf16 (3e-2) and f32 (1e-4, the
   reference's gmm tolerance);
3. serve: run the launcher's main path, ``repro_torch.launch.serve.main``,
   on qwen1.5-0.5b at full width in bf16 with random weights from a seed
   (batch 4, prompt 512, 32 new tokens), with every launch counter set to
   0 just before and read just after.  The launcher runs one prefill and
   one decode step eagerly, captures each as a CUDA graph and replays the
   prefill graph once and the decode graph 31 times: the loop's launches
   (the replays') must equal the eager loop's exactly, and the warm-up's,
   read apart, one prefill's and one decode step's; each kernel must have
   launched.  Then the graphed loop's ids and every step's logits must
   equal the eager loop's (``_serve_once``, op by op from Python) on the
   same prompt bitwise;
4. reference: feed the same prompt and the generated tokens (teacher
   forcing) through the plain path (``backend="torch"``) and compare the
   logits of every step;
5. fan-out, for qwen1.5-0.5b, mamba2-130m and then zamba2-1.2b
   (2.18 GB a slot): ``serve.main`` with
   ``--faasm-requests 64 --state-wire int8``: every request a Faaslet
   call of the port's runtime that copies its parameters from pinned
   leaves into an executor slot's buffers and replays that slot's
   captured forward (K5 or K8), then pushes the shared serve/stats vector
   over the int8 wire (K1), counters zeroed just before; every request
   must succeed; the launches are held exactly: the serving loop's
   warm-up and the fan-out's warm-ups before each capture read apart,
   one forward's launches (K5 24, or K8 24, or K8 38 and K5 7) per
   replay, one replay per call and one for the build, K1 once per push;
   the stats equal the token histogram within the int8 bound and their
   sum the calls, no count lost; how a call's serve/stats time divides
   into pulls, int8 push and the rest is read from the wire spans of the
   wave's calls; the tokens the plain path's
   argmax (one forward per prompt, as the fan-out runs it) in at least
   90% of the requests and the kernel path's eager forward bitwise in
   all; req/s, p50/p99, the per-call copy (CUDA events on the slot's
   stream) and the capture time are logged, beside a 4-request wave of
   the eager fan-out (pageable leaves, the forward op by op) and one
   graphed call alone; then the Fig. 7 twin
   (``examples/inference_serving_torch.py``) at full width, 12 requests,
   both isolation modes and cold ratios: a container cold start must
   capture the forward again, a Faaslet cold start must not;
6. device plane: two hosts of the runtime; one pushes from a device
   replica (K1 on device tensors), the other's device replica catches up
   through a delta pull (K2); then the paper's other experiments through
   their twins, each with the counters zeroed just before it: the
   quickstart (its accumulated vector held), the chained matmul at n
   2,048 with 2 and 4 splits (rel-err < 1e-5 against numpy's B @ C),
   Fig. 6's HOGWILD SGD at RCV1's 47,236 features (4,096 examples, 8
   workers, 2 epochs) in both isolation modes on the exact and int8 wires,
   traced: accuracy above 0.5, the container's transfer and billable
   memory above the Faaslet's, K1's launches exactly the int8 encodes the
   wire.push and wire.pull spans record (16 pushes on the int8 wire); one
   worker on the card bitwise the same run on the CPU, both wires; the
   Fig. 9 twin (K1-K3 and K5-K8 at the reference's fixed f32 shapes, each
   held against its plain version, its launches exact); the Tab. 3 /
   Fig. 10 twin's rows with K1 counted per wire section; the dispatch
   twin with its floors reported, not held; then the chaos scenarios of
   ``tests/test_chaos.py`` with the tiers and runtime on the card: the
   chaos matrix's storms (seeds 0-2; two pushers, a subscriber and a
   polling puller under ``FaultPlan.random``), the global value the
   exact fault-free sum and every replica equal to it after one repair
   pull; one storm on the int8 wire at a 4,096-float key, within the
   int8 bound, K1 exactly once per int8 encode the wire spans record
   and K2 once per frame the puller's device replica took; a host
   killed mid-fan-out, every increment exactly once; and the codec-error
   fallback, the exact value with no K1 launch for the failed encode;
7. timing: each kernel's device time per call at the main path's shapes
   (K5 and K8 also at the fan-out's (1, 16) forward)
   (torch.profiler's CUDA trace; back-to-back call time by CUDA events is
   logged beside it) with its plain version's, that of one PyTorch library
   call computing the same function where there is one (a yardstick the
   port never calls; the kernel and it are timed by one method, CUDA
   events for both when a trace of either is not whole) and the card's
   bound for the work; each K6 row fails unless one call launches one
   kernel (one record a call in a whole profiler trace, one node in a
   CUDA graph of the call, a kernel); the state-push
   kernels also at 16 Mi elements, and one host-side encode of numpy
   operands beside the host codec; then the warm prefill and decode loop,
   eager and graphed side by side (one run each, and the capture
   time), and one profiled run of each for the device's busy share (its
   last ``PROFILE_STEPS`` decode steps, as every served model's);
8. moe serve: the launcher's main path on deepseek-moe-16b at full width
   (16.4 B parameters, bf16, random weights from the seed; batch 4,
   prompt 512, 32 new tokens), counters zeroed just before: the prefill
   takes the GShard einsum dispatch, every decode step the sorted path
   through K7 (3 calls in each of the 27 MoE layers), so K5 launches 28
   times, K6 28 x 31 and K7 27 x 3 x 31, counted by shape as 27 x 2 x
   31 at gate/up and 27 x 31 at down (the warm-up's one decode step held
   apart); the graphed loop held bitwise against the eager loop as in
   phase 3, whose router calls' expert sets are recorded (a replay runs
   no Python, and the two runs are bitwise one);
9. moe reference: the same prompt and generated tokens through the plain
   path, three ways.  bf16 rounds apart on the two paths, so a near-tie
   between the 6th and 7th expert can pick another expert; the token's
   later layers and, through attention, later tokens then drift apart.
   Free-running (the plain router picks its own experts): the share of
   (token, layer) sets routed apart and the argmax agreement are printed.
   Routing forced to the kernel path's experts: the argmax must agree on
   90% of all rows; the logits are printed.  Sublayer by sublayer (every
   attention and FFN call of a kernel-path run repeated on the plain path
   on the same input): every output within the bf16 kernel tolerance;
10. moe timing: K7 at the decode step's gate/up and down shapes (24
   rows against every MoE layer's real weights in turn, so that no call
   finds its weights in L2; each row carries its shape's launches from
   phase 8) and at the sorted-prefill shape (12,288 rows, all 64
   experts) as in phase 7, and K5 and K6 at the
   model's prefill and last decode step (D 128); then the
   warm MoE prefill and decode, and one profiled decode loop for the
   device's busy share;
11. ssm serve, for mamba2-130m and then zamba2-1.2b at full width (bf16,
   random weights from the seed; batch 4, prompt 512, 32 new tokens),
   counters zeroed just before: the prefill runs K8 (the SSD scan) once
   per Mamba layer, 24 and 38 times; zamba2's shared attention block adds
   K5 7 times in the prefill and K6 7 times per decode step; every other
   kernel launches no time (the warm-up held apart); the graphed loop
   held bitwise against the eager loop as in phase 3;
12. ssm reference: as phase 4, each model's teacher-forced logits against
   the plain path (held for mamba2-130m, reported for zamba2-1.2b, whose
   bf16 paths land ~0.15 apart), the argmax held for both; two correct
   plain paths in bf16 (the SSD by the sequential oracle and by the
   chunked scan) against each other, reported; the weights widened to
   f32, kernel path against plain path, held within the same 5e-2, and
   the bf16 kernel path no farther from those f32 logits than the bf16
   plain path plus 5e-2; every
   Mamba2 prefill, attention and MLP sublayer call of a kernel-path run
   repeated on the plain path on the same input, held within the bf16
   kernel tolerance;
13. ssm timing: K8 at both models' prefill shapes, with decays and step
   sizes as the models draw them, as in phase 7, and K5 and K6 at
   zamba2-1.2b's shared-block shapes (H 32); then each model's warm
   prefill and decode, and one profiled decode loop;
14. gqa serve, for qwen3-4b, granite-3-8b and starcoder2-7b at full width
   (4.0, 8.2 and 7.4 B parameters, bf16, random weights from the seed;
   batch 4, prompt 512, 32 new tokens), one model on the card at a time,
   as phases 3, 4 and 7: the drawn parameters counted against
   ``param_count()`` (plus starcoder2's output and MLP biases, which it
   leaves out); K5 exactly once per layer in the prefill and K6 once per
   layer and decode step, every other kernel no time; the graphed loop
   held bitwise against the eager loop; the teacher-forced logits against
   the plain path (reported, as zamba2-1.2b's: at 32-40 layers the bf16
   plain path itself lands farther than 5e-2 from the f32 logits; the
   argmax held); every attention and MLP sublayer call of a kernel-path
   run repeated on the plain path (3e-2); K5 and K6 timed at the model's
   grouped-query shape (H 32 over K 8, or H 36 over K 4; D 128) beside
   SDPA computing the same grouped function (``enable_gqa``, its kernels
   logged) and SDPA on K/V repeated to H heads; the warm decode loop;
   then, the graphs closed to make room, the weights widened to f32:
   kernel path against plain path (5e-2), and the bf16 kernel path no
   farther from those f32 logits than the bf16 plain path plus 5e-2;
15. training, qwen1.5-0.5b at full width at train_4k's sequence (4,096)
   and batch 4: K5's softmax statistics (each row's log-sum-exp) and
   ``FlashAttentionFn``'s gradients (K5 forward, the plain flash
   backward) against ``attention_ref`` and autograd through it at one
   layer's shape; one step on the kernel path against the plain path on
   the same weights and batch (widened to f32: losses within 1e-4, every
   gradient leaf within 1e-3 relative L2; bf16: losses within 3e-2, the
   leaves' relative L2 printed); the captured train step
   (``launch/train_graphs.py``) against the eager step of
   ``make_train_step`` from the same weights, optimizer state and batch:
   the loss, aux loss, gradient norm, every updated parameter and the
   optimizer state bitwise, and one step's launches in the graph's log,
   exact; then the main path, ``examples/train_lm_torch.py`` for 4 steps
   (8 before PR 29's depth cuts) through the captured step (step 0 eager, then one replay a step) with
   every counter zeroed just before: K5 exactly twice per layer and step
   (the forward and the remat recompute), per replay too, no other
   kernel, the loss finite at every step,
   every weight matrix moved, one more step's update bitwise equal to
   cast(p32 - lr g32) leaf by leaf; the step time (host clock ending in
   a sync), tokens/s, ``train_mfu`` (6 N T plus causal attention over
   the step time at 989 TFLOP/s), peak memory, the forward, backward
   and update by CUDA events, the profiled busy share; the graph
   captured again on the trained weights and one captured step beside
   one eager step by CUDA events, each one's busy share (the eager
   step's profiled kernels over each step's time), the captures' host
   time and the memory each holds; K5 timed at the
   training forward beside SDPA's forward, and the plain flash backward
   beside SDPA's backward;
16. training, mamba2-130m and then zamba2-1.2b at full width, as phase
   15 (the eager step timed, not profiled, and no split step):
   ``SSDScanFn`` (K8's forward, the plain chunked scan's backward) at
   one Mamba layer's training shape, y and the final state against
   ``ssd_chunked`` and every operand's gradient from one backward against
   autograd through it, at the models' decays (3e-2); zamba2's shared
   block also gets phase 15's K5 parity at H 32; the same holds, kernel
   path against plain path (zamba2 in two microbatches of 2 rows on both
   paths: the plain attention's scores at 32 heads and 4 rows do not fit
   beside its backward); the main path for 4 steps with K8 exactly twice
   per Mamba layer and step (48 and 76) and, for zamba2, K5 twice per
   shared-block application (14); the same reports; K8 timed at the
   training shape, the plain SSD backward's time per layer, and zamba2's
   K5 at its training forward beside SDPA;
17. families, whisper-tiny (encoder/decoder: 4 + 4 layers, H 6, D 64,
   cross-attention over 1,500 frames) and then internvl2-2b (VLM: 24
   layers, H 16 over K 8, D 128, 256 patch embeddings ahead of the
   prompt) at full width, bf16, random weights from the seed, batch 4,
   prompt 512, 32 new tokens, with the frames or patch embeddings the
   launcher draws after the prompt, one model on the card at a time, as
   phase 14: the parameters counted; K5 12 and 24 times a prefill
   (whisper: 4 encoder layers without a mask over 1,500 x 1,500, 4 causal
   decoder self-attentions, 4 cross-attentions of 512 queries over 1,500
   frames) and K6 8 and 24 times a decode step (whisper: self-attention
   over the 544-position cache and cross-attention over all 1,500 frames
   in each decoder layer), exact in all and by shape; the graphed loop
   bitwise against the eager loop; the teacher-forced logits against the
   plain path (held for whisper-tiny, reported for internvl2-2b, as the
   GQA decoders'; the argmax held for both); every K5 and K6 sublayer call
   repeated on the plain path (3e-2); K5 and K6 timed at every one of
   these shapes beside SDPA; the warm decode loop; the weights widened to
   f32, as phase 14;
18. training, the other families: whisper-tiny, internvl2-2b and
   qwen3-4b at full width (qwen3-4b on its first 4 of 36 layers: phase
   20 trains granite-3-8b's identical attention shape at full depth), as
   phase 15 (the eager step timed, not profiled, and no split step), one
   model on the card at a time:
   K5's statistics and ``FlashAttentionFn``'s gradients at every
   attention shape the model trains (whisper: the encoder's 1,500 x
   1,500 without a mask, the decoder's causal 4,096 and the
   cross-attention of 4,096 queries over 1,500 frames; internvl2-2b's
   4,096 positions at H 16 over K 8, D 128; qwen3-4b at H 32 over K 8);
   the kernel-path holds with the frames or patch embeddings in the batch
   (qwen3-4b in two microbatches of two rows on both paths); the main
   path, 4 steps, K5 exactly 24, 48 and 8 times a step, by shape too
   (whisper 8 at each of its three); the same reports, with K5
   and the plain flash backward timed at every one of these shapes beside
   SDPA.
19. mesh: (a) the dry-run (``repro_torch.launch.dryrun``) of
   qwen1.5-0.5b's train_4k on the 16x16 and 2x16x16 production meshes
   and its decode_32k on 16x16, each in a process of its own over torch's
   fake process group (256 or 512 ranks that exist as a world size only;
   the three run beside (b) and (c)): each ``ok`` with FLOPs per device
   above 0, the multi-pod train cell with collective bytes above 0, each
   cell's counts and roofline terms at the H100's data-sheet constants
   printed; (b) the counter (``distributed/cost_analysis.py``) over
   qwen1.5-0.5b's train step at phase 15's shape on one device, fake
   tensors, the kernel route: K5 counted exactly 48 times a step and the
   counted FLOPs no fewer than 6 N T, printed beside phase 15's measured
   step (FLOPs, bytes, the bound, measured over bound, the counted FLOPs
   beside ``train_mfu``'s, the estimated peak memory beside the measured;
   no second timed step); (c) a 1-rank NCCL group and a 1-device CUDA
   ``DeviceMesh``: qwen1.5-0.5b at full width placed from host leaves in
   the reference's layout by ``distributed.elastic.reshard_params`` under
   ``ShardingRules``, one SGD step through
   ``launch/steps.py::make_step_for_shape`` with every counter zeroed
   just before: K5 exactly 48 launches and no other kernel, the loss,
   every gradient leaf and every updated parameter bitwise the
   plain-tensor ``make_train_step``'s from the same host leaves and
   batch, ``to_host`` bitwise the host leaves; the group torn down after.
   A single card checks multi-device code on a 1-device mesh only; the
   production meshes exist here only as a fake group, and multi-rank
   numerics are held on the CPU (``tests/test_torch_distributed.py``).
20. training, granite-3-8b and starcoder2-7b at full width and depth (8.2
   B and 7.4 B parameters; run before phase 19), after qwen1.5-0.5b's
   loss over one fixed batch (30 steps of the example's captured step,
   constant lr 0.05: every loss finite, the last below the first, the
   drop printed beside the reference test's 0.5): for each model, K5's
   statistics and ``FlashAttentionFn``'s gradients at its attention shape
   (granite-3-8b's H 32 over K 8 is qwen3-4b's; starcoder2-7b's H 36 over
   K 4, G 9); the kernel path against the plain path in bf16 at full
   depth (four microbatches of one row, summed in bf16 on both paths: an
   f32 accumulator leaves no room for the plain attention), the loss
   within 3e-2 and every leaf's relative L2 reported; the f32 witness at
   full width on the first ``F32_HOLD_LAYERS`` (4) layers, loss 1e-4 and
   each leaf 1e-3 (at full depth it would take ~98 and ~89 GB); the
   captured step bitwise against the eager step, K5 exactly 80 and 64 a
   replay; the main path, 4 steps, as phase 15 (the eager step timed,
   not profiled), with peak memory allocated and reserved beside the
   card's; K5 and the plain flash backward timed at starcoder2-7b's shape
   (granite-3-8b's row is qwen3-4b's).

Phase 2 also holds K8 against its plain version (and the sequential
oracle) at both models' prefill shapes, in f32 at the reference's 1e-4
on the reference's test distributions and in bf16 at 3e-2, at the
models' own decays at 3e-2 (there the cumulative sums of dt*A reach -1e3,
and the plain version's f32 sums put it ~4e-4 off the exact scan, which
is printed beside K8's, whose sums are f64), at a ragged S, at
an S that shrinks the chunk to 32, at 16 carried chunks with an initial
state, with two groups of B and C, and at the reference's large decays
(finite).

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``.  Without a CUDA card, or run
outside the repository, it exits non-zero and prints no result.
``python3 chip_smoke.py parity`` stops after phase 2 and prints no result;
``python3 chip_smoke.py flash`` builds, holds the attention kernels
against their plain versions, times K5 at the five prefill shapes (as in
phases 7, 10, 13 and 14, with no launches counted) and stops: run it from two
checkouts in one call to compare two designs of K5.  ``python3
chip_smoke.py gmm`` builds, holds K7 against its plain version at every
phase-2 case in both dtypes, times it at the decode gate/up, decode down
and sorted-prefill shapes beside its plain version and ``grouped_mm``
(weights drawn at model scale, 64 x d x f in bf16, four tensors per shape
taken in turn), times each of its bf16 kernels forced at those shapes and
at a sweep of T (the evidence for the wrapper's threshold between them)
with its host time per call, and stops.  ``python3 chip_smoke.py
fanout`` builds, holds K5 and K8 against their plain versions, runs
phase 5 and times K5 and K8 at the fan-outs' shapes (and K6 at
zamba2-1.2b's fan-out run's decode step), and stops.  ``python3
chip_smoke.py
decode`` holds the attention kernels against their plain versions, times
K6 at the five served decode shapes beside SDPA (on one cache, and over
8 caches taken in turn so that each call reads HBM), lists the kernels one
call launches, and stops; ``python3 chip_smoke.py ssd`` holds K8 at every
phase-2 case, times it at both SSM prefill shapes with the time of each of
its kernels, and stops.  ``python3 chip_smoke.py train`` builds, holds the attention kernels,
runs phases 15 and 16 and stops; ``python3 chip_smoke.py trainfam``
the same for phase 18, and ``python3 chip_smoke.py traingqa`` for phase
20, each printing its kernels line.  ``python3 chip_smoke.py gqa``
builds, holds the attention kernels and runs phase 14 alone; ``python3
chip_smoke.py mesh`` the same for phase 19;
``python3 chip_smoke.py families`` the same for phase 17.  ``python3
chip_smoke.py paper`` builds, holds K1-K4 and runs the paper phase
(phase 6's second half) alone; ``python3 chip_smoke.py chaos`` the same
for the chaos scenarios.  ``python3 chip_smoke.py profile`` serves each of
the four models and prints the device time of one prefill and of one
decode step (profiler, two runs each) and the wall of each, of the eager
loop and, where the launcher has step graphs, of their replays, and
stops.  These three modes call
only the public entry points (the kernels build at first use), so that a
copy of this script in an earlier checkout (``git archive`` of it
unpacked under ``build/``) measures that checkout's kernels the same way:
to compare two trees, run the script from each in turns in one call.
The qwen phases run first; their model is freed before the 32.8 GB MoE
model is drawn on the card, and that before the SSM models; each training
phase frees its model before the next.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH, BATCH, PROMPT, NEW_TOKENS, SEED = "qwen1.5-0.5b", 4, 512, 32, 0
PROFILE_STEPS = 4          # decode steps a decode-only warm profile covers
WARM_RUNS = 1              # unprofiled runs of each warm serving loop
MOE_ARCH = "deepseek-moe-16b"
SSM_ARCHS = ("mamba2-130m", "zamba2-1.2b")
# the grouped-query decoders (qwen3-4b and granite-3-8b share H 32 over K 8)
GQA_ARCHS = ("qwen3-4b", "granite-3-8b", "starcoder2-7b")
# the last two families: whisper-tiny's encoder/decoder (4 + 4 layers, H 6,
# D 64, cross-attention over 1,500 frames) and internvl2-2b's VLM (24
# layers, H 16 over K 8, D 128, 256 patch embeddings ahead of the prompt)
FAMILY_ARCHS = ("whisper-tiny", "internvl2-2b")
# configs whose teacher-forced logits are reported, not held to LOGIT_TOL
# (every sublayer is held instead, and the logits in f32; see
# phase_sublayers, phase_ssm_witnesses and phase_f32_witness): their bf16
# plain path itself lands farther than LOGIT_TOL from the f32 logits
# (zamba2-1.2b 0.19; the GQA decoders, 32-40 layers deep, 0.054-0.092 on
# an H100), so the two bf16 paths cannot be held closer than that
# internvl2-2b (24 layers at d 2048, D 128, G 2) is reported with them
LOGITS_HELD = {"zamba2-1.2b": False, "qwen3-4b": False, "granite-3-8b": False,
               "starcoder2-7b": False, "internvl2-2b": False}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # the repo's kernel tolerances
GMM_TOL = {"float32": 1e-4, "bfloat16": 3e-2}   # the reference's gmm, bf16
SSD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}   # the reference's ssd, bf16
LOGIT_TOL = 5e-2                            # bf16 model tolerance (atol = rtol)
MIN_ARGMAX_AGREEMENT = 0.9                  # bf16 near-ties may flip a few
FANOUT_REQUESTS, FANOUT_WARM = 64, 8       # the wave; the launcher's warm-up
FANOUT_EAGER = 4                            # the eager wave beside it
FIG7_REQUESTS = 12                          # the Fig. 7 twin's requests
# the paper phase: Fig. 6 at RCV1's feature count (data/sparse.py imitates
# RCV1) and 4,096 examples; Fig. 8 at n 2,048
FIG6_FEATURES, FIG6_EXAMPLES, FIG6_WORKERS, FIG6_EPOCHS = 47_236, 4_096, 8, 2
FIG8_N, FIG8_SPLITS = 2048, (2, 4)
STATS_NUMEL = 151_936                       # serve/stats: the vocabulary
SP_BIG = 16 << 20                           # the state-push timing's 16 Mi
INT8_STEP = 1.01 / 127                      # int8 bound per unit push
# the chaos phase: tests/test_chaos.py's smoke seeds and storm length, and
# the int8 storm's key (16 KiB, above INT8_WIRE_MIN_BYTES)
CHAOS_SEEDS, CHAOS_ITERS, CHAOS_INT8_NUMEL = (0, 1, 2), 6, 4096
CHAOS_KEY = "w"
# H100 SXM published peaks (NVIDIA H100 datasheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12                    # the main path runs in bf16
FP32_FLOP_PER_S = 67e12                     # f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12                    # TF32 on the tensor cores

FLASH_CASES = [
    # B, Sq, Sk, H, K, D, causal, q_offset
    (4, 512, 512, 16, 16, 64, True, 0),      # the serving prefill
    (2, 100, 300, 8, 2, 64, True, 200),      # GQA G=4, q_offset, ragged tail
    (2, 77, 77, 8, 8, 128, False, 0),        # full attention, D 128
    (1, 64, 200, 8, 1, 128, True, 136),      # MQA
    (2, 33, 50, 4, 4, 32, True, 17),
    (2, 16, 40, 4, 2, 16, False, 0),
    (1, 16, 16, 16, 16, 64, True, 0),        # the fan-out's forward
    (4, 512, 512, 16, 16, 128, True, 0),     # deepseek-moe-16b's prefill
    (4, 512, 512, 32, 32, 64, True, 0),      # zamba2-1.2b's shared block
    (2, 200, 330, 8, 8, 128, True, 130),     # ragged tiles, q_offset, D 128
    (2, 150, 150, 16, 4, 128, True, 0),      # GQA G=4, D 128
    (2, 40, 50, 8, 2, 64, True, 10),         # fewer keys than one KV tile
    (1, 70, 20, 4, 4, 128, False, 0),
    (4, 512, 512, 32, 8, 128, True, 0),      # qwen3-4b's, granite-3-8b's: G 4
    (4, 512, 512, 36, 4, 128, True, 0),      # starcoder2-7b's prefill: G 9
    (4, 1500, 1500, 6, 6, 64, False, 0),     # whisper-tiny's encoder
    (4, 512, 512, 6, 6, 64, True, 0),        # whisper-tiny's decoder: H 6
    (4, 512, 1500, 6, 6, 64, False, 0),      # whisper-tiny's cross-attention
    (4, 768, 768, 16, 8, 128, True, 0),      # internvl2-2b's prefill: G 2
    (1, 16, 16, 32, 32, 64, True, 0),        # zamba2-1.2b's fan-out forward
]
# the bf16 parity case (causal, Sq = Sk = S, no offset), keyed (B, S, H,
# K, D), whose error the timing rows of K5 at that shape report
FLASH_ROWS = {
    (4, 512, 16, 16, 64): ("flash_attention",),
    (1, 16, 16, 16, 64): ("flash_attention[fan-out]",),
    (1, 16, 32, 32, 64): (f"flash_attention[fan-out {SSM_ARCHS[1]}]",),
    (4, 512, 16, 16, 128): (f"flash_attention[{MOE_ARCH}]",),
    (4, 512, 32, 32, 64): (f"flash_attention[{SSM_ARCHS[1]}]",),
    (4, 512, 32, 8, 128): tuple(f"flash_attention[{a}]"
                                for a in GQA_ARCHS[:2]),
    (4, 512, 36, 4, 128): (f"flash_attention[{GQA_ARCHS[2]}]",),
    (4, 512, 6, 6, 64): (f"flash_attention[{FAMILY_ARCHS[0]}]",),
    (4, 768, 16, 8, 128): (f"flash_attention[{FAMILY_ARCHS[1]}]",),
}
# the bf16 parity cases without a causal mask, keyed (B, Sq, Sk, H, K, D),
# whose error the timing rows of K5 at that shape report
FLASH_FULL_ROWS = {
    (4, 1500, 1500, 6, 6, 64): (f"flash_attention[{FAMILY_ARCHS[0]} "
                                f"encoder]",),
    (4, 512, 1500, 6, 6, 64): (f"flash_attention[{FAMILY_ARCHS[0]} "
                               f"cross]",),
}
DECODE_CASES = [
    # B, S, H, K, D, lengths
    (4, 544, 16, 16, 64, (513, 530, 543, 544)),  # the serving decode
    (4, 544, 16, 16, 128, (513, 530, 543, 544)),  # deepseek-moe-16b's
    (4, 544, 32, 32, 64, (1, 128, 129, 544)),    # zamba2-1.2b's shared block
    (3, 300, 16, 4, 128, (1, 150, 300)),         # GQA G=4, D 128
    (2, 1000, 8, 1, 64, (999, 37)),              # MQA, long cache
    (2, 64, 4, 2, 16, (1, 64)),
    (5, 100, 8, 8, 32, (3, 33, 64, 65, 100)),
    (3, 400, 16, 8, 64, (2, 128, 129)),          # G=2, split edges
    (2, 777, 36, 4, 128, (777, 300)),            # G=9: two head groups
    (4, 544, 32, 8, 128, (513, 530, 543, 544)),  # qwen3-4b's, granite-3-8b's
    (4, 544, 36, 4, 128, (513, 530, 543, 544)),  # starcoder2-7b's: G 9
    (4, 544, 6, 6, 64, (513, 530, 543, 544)),    # whisper-tiny's self-attention
    (4, 1500, 6, 6, 64, (1500,) * 4),            # its cross-attention: full
    (4, 800, 16, 8, 128, (769, 780, 799, 800)),  # internvl2-2b's: G 2, D 128
    (1, 18, 32, 32, 64, (17,)),      # zamba2-1.2b's fan-out run's serving loop
]
# the bf16 parity case, keyed (B, S, H, K, D), whose error the timing rows
# of K6 at that shape report
DECODE_ROWS = {
    (4, 544, 16, 16, 64): ("decode_attention",),
    (4, 544, 16, 16, 128): (f"decode_attention[{MOE_ARCH}]",),
    (4, 544, 32, 32, 64): (f"decode_attention[{SSM_ARCHS[1]}]",),
    (4, 544, 32, 8, 128): tuple(f"decode_attention[{a}]"
                                for a in GQA_ARCHS[:2]),
    (4, 544, 36, 4, 128): (f"decode_attention[{GQA_ARCHS[2]}]",),
    (4, 544, 6, 6, 64): (f"decode_attention[{FAMILY_ARCHS[0]}]",),
    (4, 1500, 6, 6, 64): (f"decode_attention[{FAMILY_ARCHS[0]} cross]",),
    (4, 800, 16, 8, 128): (f"decode_attention[{FAMILY_ARCHS[1]}]",),
    (1, 18, 32, 32, 64): (f"decode_attention[fan-out {SSM_ARCHS[1]}]",),
}


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, after the seconds since the script
    started: where the 1,200 s a run may take go."""
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Time per call of back-to-back calls, by CUDA events: the device's
    time where it is the bottleneck, the host's launch rate where not."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_events(prof):
    """The profiler's averages of work on the card (kernels, copies)."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def _trace(fn, iters: int = 20, warmup: int = 5, attempts: int = 3):
    """The device events of ``iters`` calls of ``fn`` in torch.profiler's
    CUDA trace.  The profiler loses kernel records at times (most traces of
    20 calls did, late in a full run, when they recorded from their first
    call), which would give too small a time and too few kernels per call:
    so each trace opens with a round of ``iters`` calls whose records are
    discarded (the profiler's own warm-up step), and a trace counts only
    when it holds device events and every kernel's records are a multiple
    of ``iters``.  Another is taken, up to ``attempts`` times; None when
    none came back whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):            # the warm-up round, then the window
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = device_events(prof)
        counts = [e.count for e in events]
        if events and all(c % iters == 0 for c in counts):
            return events
        log(f"  (trace {attempt + 1} of {attempts} incomplete: "
            f"{sum(counts)} device records for {iters} calls)")
    return None


def _profiled_ms(fn, iters: int = 20, warmup: int = 5, attempts: int = 3):
    """Device time per call: every kernel ``fn`` launches, summed from a
    whole trace (``_trace``) — the work's own time, whatever the host's
    launch overhead between calls; None when no trace came back whole."""
    events = _trace(fn, iters, warmup, attempts)
    if events is None:
        return None
    return sum(e.self_device_time_total for e in events) / iters / 1e3


def device_ms(fn, iters: int = 20, warmup: int = 5,
              attempts: int = 3) -> float:
    """Device time per call from the profiler (``_profiled_ms``); when no
    trace came back whole (on one card every trace of one row did), the
    time is taken by CUDA events instead (``queued_ms``) and logged as
    such."""
    ms = _profiled_ms(fn, iters, warmup, attempts)
    if ms is not None:
        return ms
    ms, how = queued_ms(fn, iters)
    log(f"  (device time from CUDA events instead, {how}: "
        f"{ms * 1e3:.2f}us per call)")
    return ms


def device_times(fns, iters: int = 20) -> tuple:
    """Device time per call of each of ``fns`` by one method: the
    profiler's (``_profiled_ms``) for all, or, when any of them gets no
    whole trace, CUDA events (``queued_ms``) for all, so that a kernel and
    its yardstick are timed alike.  Returns (times in ms, method)."""
    times = [_profiled_ms(fn, iters) for fn in fns]
    if all(t is not None for t in times):
        return times, "profiler"
    times = [queued_ms(fn, iters)[0] for fn in fns]
    log(f"  (a trace was not whole: {len(fns)} times from CUDA events "
        f"instead, {[round(t * 1e3, 2) for t in times]}us per call)")
    return times, "events"


def kernels_per_call(fn, iters: int = 20, attempts: int = 3):
    """Kernel name (cut to 60 characters) -> (records, device us) per call
    in a whole trace of ``fn`` (``_trace``); None when no trace came back
    whole."""
    events = _trace(fn, iters, attempts=attempts)
    if events is None:
        return None
    return {e.key[:60]: (e.count / iters,
                         round(e.self_device_time_total / iters, 2))
            for e in events}


CU_GRAPH_NODE_TYPE_KERNEL = 0          # CUgraphNodeType, cuda.h


def graph_node_types(fn) -> list:
    """The type of each node of a CUDA graph captured from one call of
    ``fn`` (after a call on the capture stream), read through the driver
    API: the work one call queues, whatever the profiler records."""
    import ctypes
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=s):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n))
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        types.append(t.value)
    graph.reset()
    return types


def queued_ms(fn, iters: int = 20, attempts: int = 3) -> tuple:
    """Time per call of ``iters`` calls queued behind a kernel that keeps
    the card asleep until the host has queued them all, by CUDA events
    around the calls: the card then runs them back to back, so the time is
    the device's, with the gaps of its own queue between kernels and
    without the host's launch time.  The card must still be asleep when
    the last call is queued (its start event not yet reached), else the
    sleep is made longer; a ``fn`` that waits for the card on the host
    never passes that test, and then the back-to-back time of the last
    attempt (an upper bound) is returned.  Returns (ms, how)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = 1 << 22
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    per_s = cycles / (start.elapsed_time(end) / 1e3)   # sleep cycles a second
    sleep = int(per_s * (2 * host_s + 1e-3))
    for _ in range(attempts):
        torch.cuda._sleep(sleep)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        asleep = not start.query()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        if asleep:
            return ms, f"{iters} calls queued behind a sleeping kernel"
        sleep *= 4
    return ms, f"{iters} calls back to back (the host waited for the card)"


def check_close(name: str, got, want, tol: float,
                rl2: float | None = None) -> float:
    """Max |got - want|; raises unless |got - want| <= tol + tol * |want|
    everywhere (the test suite's assert_allclose rule), and with ``rl2``
    unless ||got - want|| <= rl2 ||want|| too (logged beside the
    reference's RMS): where a typical |want| is near ``tol``, the first
    rule alone cannot see a wrong sum."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: got {tuple(got.shape)} {got.dtype}, "
                             f"want {tuple(want.shape)} {want.dtype}")
    got, want = got.detach(), want.detach()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite output")
    d = (got.float() - want.float()).abs()
    err = float(d.max())
    excess = float((d - (tol + tol * want.float().abs())).max())
    rel = ""
    if rl2 is not None:
        norm = float(want.float().norm())
        r = float(d.norm()) / max(norm, 1e-30)
        rel = (f", relative L2 {r:.3e} (held to {rl2:g}; the reference's "
               f"RMS {norm / want.numel() ** 0.5:.3e})")
        excess = max(excess, r - rl2)
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:g} abs + {tol:g} rel)"
        f"{rel} {'ok' if excess <= 0 else 'FAIL'}")
    if excess > 0:
        raise AssertionError(f"{name}: outside tolerance by {excess:.3e}")
    return err


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(_build.KERNELS)
    log(f"build: {', '.join(_build.KERNELS)} built in "
        f"{time.perf_counter() - t0:.1f}s into {_build.BUILD_DIR}")
    for name, text in sorted(_build.BUILD_LOG.items()):
        entry = "?"
        for line in text.splitlines():
            if "entry function" in line:     # mangled: drop the namespace
                entry = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "",
                               line.split("'")[1])
            elif "registers" in line:
                log(f"  ptxas {name}: {entry[:60]}: {line.split(':', 1)[1].strip()}")
            elif "stack frame" in line and not \
                    line.strip().startswith("0 bytes stack frame"):
                log(f"  ptxas {name}: {entry[:60]}: LOCAL MEMORY {line.strip()}")
            elif "warning" in line.lower() or "Performance" in line:
                log(f"  nvcc {name}: {line.strip()[:240]}")
    # the bf16 flash kernel and K7's prefill kernel must run on the tensor
    # cores through wgmma, K8's bf16 C·Bᵀ through mma.sync or wgmma: count
    # the wgmma (HGMMA) and mma.sync (HMMA) instructions in each library's
    # SASS
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not cuobjdump.exists():
        log("  sass: no cuobjdump in the toolkit; tensor-core use not counted")
        return
    for name, wgmma_only in (("flash_attention", True), ("moe_gmm", True),
                             ("ssd_scan", False)):
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(_build.library_path(name))],
            capture_output=True, text=True, timeout=120, check=True).stdout
        n_hgmma = len(re.findall(r"\bHGMMA\.", sass))
        n_hmma = len(re.findall(r"\bHMMA\.", sass))
        log(f"  sass {name}: {n_hgmma} HGMMA, {n_hmma} HMMA instructions")
        if n_hgmma == 0 and (wgmma_only or n_hmma == 0):
            raise AssertionError(f"{name}: no tensor-core instruction of the "
                                 f"kind it must have in its SASS")


def phase_parity() -> dict:
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"
    errs = {}
    log("parity: kernels against their plain versions on the card")
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        for (B, Sq, Sk, H, K, D, causal, off) in FLASH_CASES:
            q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dtype)
            k = torch.randn(B, Sk, K, D, generator=g, device=dev).to(dtype)
            v = torch.randn(B, Sk, K, D, generator=g, device=dev).to(dtype)
            got = flash_attention(q, k, v, causal=causal, q_offset=off)
            torch.cuda.synchronize()
            want = attention_ref(q, k, v, causal=causal, q_offset=off)
            torch.cuda.synchronize()
            err = check_close(f"flash {dtype} B{B} Sq{Sq} Sk{Sk} H{H} K{K} "
                              f"D{D} causal={causal} q_offset={off}",
                              got, want, tol)
            if dtype == torch.bfloat16 and causal and off == 0 and Sq == Sk:
                for name in FLASH_ROWS.get((B, Sq, H, K, D), ()):
                    errs[name] = err
            if dtype == torch.bfloat16 and not causal:
                for name in FLASH_FULL_ROWS.get((B, Sq, Sk, H, K, D), ()):
                    errs[name] = err
        for (B, S, H, K, D, lens) in DECODE_CASES:
            q = torch.randn(B, H, D, generator=g, device=dev).to(dtype)
            k = torch.randn(B, S, K, D, generator=g, device=dev).to(dtype)
            v = torch.randn(B, S, K, D, generator=g, device=dev).to(dtype)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            for b, n in enumerate(lens):         # garbage past the length
                k[b, n:] = 1e4
                v[b, n:] = -1e4
            got = decode_attention(q, k, v, lengths)
            torch.cuda.synchronize()
            want = decode_attention_ref(q, k, v, lengths)
            torch.cuda.synchronize()
            err = check_close(f"decode {dtype} B{B} S{S} H{H} K{K} D{D} "
                              f"lengths={lens}", got, want, tol)
            if dtype == torch.bfloat16:
                for name in DECODE_ROWS.get((B, S, H, K, D), ()):
                    errs[name] = err
    return errs


def _gmm_sizes(g, kind, T: int, E: int = 64):
    """Group sizes on the card: ``draws`` as one decode step's top-6 picks
    (T draws of 64 experts), ``skewed`` over 48 of the 64 experts (the
    others empty), ``hole`` draws over every expert but 32, ``one`` all
    rows in expert 17, ``tail`` three quarters of the rows in groups,
    ``tiny`` 2 + 3 rows; a list gives the sizes themselves."""
    import torch
    if not isinstance(kind, str):
        return torch.tensor(kind, dtype=torch.int32, device="cuda")
    if kind == "draws":
        e = torch.randint(0, E, (T,), generator=g, device="cuda")
    elif kind == "skewed":
        active = torch.randperm(E, generator=g, device="cuda")[:48]
        e = active[torch.randint(0, 48, (T,), generator=g, device="cuda")]
    elif kind == "hole":
        e = torch.randint(0, E - 1, (T,), generator=g, device="cuda")
        e = e + (e >= 32).long()
    elif kind == "one":
        e = torch.full((T,), 17, device="cuda")
    elif kind == "tail":
        e = torch.randint(0, E, (3 * T // 4,), generator=g, device="cuda")
    else:
        e = torch.tensor([3, 3, 40, 40, 40], device="cuda")
    return torch.bincount(e, minlength=E).to(torch.int32)


# a group starting at row 3, then at 520 and 531 (inside TMA boxes)
RAGGED_SIZES = [3, 517, 11] + [0] * 2 + [700] + [0] * 57 + [305]
GMM_CASES = [
    # name, T, d, f, group sizes
    ("decode gate/up", 24, 2048, 1408, "draws"),
    ("decode down", 24, 1408, 2048, "draws"),
    ("prefill", 12_288, 2048, 1408, "skewed"),
    ("one expert", 300, 2048, 1408, "one"),
    ("rows past the groups", 200, 512, 1408, "tail"),
    ("fewer rows than a tile", 5, 2048, 1408, "tiny"),
    ("T at the regime threshold", 63, 2048, 1408, "draws"),
    ("T one past the threshold", 64, 2048, 1408, "draws"),
    ("groups starting inside a TMA box", 1536, 2048, 1408, RAGGED_SIZES),
    ("64 experts, one empty in the middle", 4096, 2048, 1408, "hole"),
    ("large T, a quarter past the groups", 8192, 2048, 1408, "tail"),
    ("f 200, tensor cores", 2048, 512, 200, "draws"),
    ("f 200, streaming", 24, 512, 200, "draws"),
    ("one expert, streaming (d 32)", 300, 32, 1408, "one"),
    ("rows past the groups, streaming (d 32)", 200, 32, 1408, "tail"),
    ("a tile per row, streaming (the grid's extent)", 48, 2048, 1408,
     [1] * 47 + [0] * 17),
    ("a ragged tile per group, streaming (d 32)", 300, 32, 1408,
     [225] + [1] * 63),
]


def phase_parity_gmm() -> dict:
    """K7 against its plain version at deepseek-moe-16b's shapes; weights
    at the model's scale (fan-in^-0.5), so the f32 sums stay near 1."""
    import torch
    from repro_torch.kernels.moe_gmm import gmm, gmm_ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    errs = {}
    log("parity: K7 moe_gmm against its plain version")
    for dtype in (torch.bfloat16, torch.float32):
        tol = GMM_TOL[str(dtype).split(".")[1]]
        for name, T, d, f, kind in GMM_CASES:
            gs = _gmm_sizes(g, kind, T)
            x = torch.randn(T, d, generator=g, device="cuda").to(dtype)
            w = (torch.randn(64, d, f, generator=g, device="cuda")
                 * d ** -0.5).to(dtype)
            # leave NaNs where the output will be allocated: rows the
            # kernel does not write would show
            junk = torch.full((T, f), float("nan"), dtype=dtype, device="cuda")
            del junk
            got = gmm(x, w, gs)
            torch.cuda.synchronize()
            want = gmm_ref(x, w, gs)
            torch.cuda.synchronize()
            err = check_close(f"K7 {dtype} {name}: T{T} d{d} f{f}, "
                              f"{int((gs > 0).sum())} experts, "
                              f"{int(gs.sum())} rows in groups",
                              got, want, tol)
            row = {"decode gate/up": "moe_gmm", "decode down": "moe_gmm[down]",
                   "prefill": "moe_gmm[prefill]"}.get(name)
            if dtype == torch.bfloat16 and row:
                errs[row] = err
    return errs


SSD_CASES = [
    # name, Bt, S, H, P, G, N, initial state
    ("mamba2-130m prefill", 4, 512, 24, 64, 1, 128, True),
    ("zamba2-1.2b prefill", 4, 512, 64, 64, 1, 64, True),
    ("ragged S", 2, 1000, 8, 64, 1, 128, True),
    ("S 20 (chunk 32)", 2, 20, 8, 64, 1, 64, True),
    ("16 chunks", 1, 4096, 8, 64, 1, 64, True),
    ("G 2", 2, 300, 8, 32, 2, 32, True),
    ("mamba2-130m fan-out", 1, 16, 24, 64, 1, 128, False),
    ("zamba2-1.2b fan-out", 1, 16, 64, 64, 1, 64, False),
]


def _ssd_inputs(g, Bt, S, H, P, G, N, dtype, decays="reference",
                init=True):
    """SSD operands on the card.  ``reference``: the reference's test
    distributions (dt ~ U(0.01, 0.2), A ~ -U(0.5, 2)); ``model``: as the
    models draw them (dt = softplus of a unit normal, A = -U(1, 16));
    ``large``: the reference's overflow case (dt ~ U(0.5, 3), A -12 and
    -16).  x, B, C in ``dtype``; the rest f32."""
    import torch
    dev = "cuda"
    x = torch.randn(Bt, S, H, P, generator=g, device=dev).to(dtype)
    if decays == "reference":
        dt = torch.rand(Bt, S, H, generator=g, device=dev) * 0.19 + 0.01
        A = -(torch.rand(H, generator=g, device=dev) * 1.5 + 0.5)
    elif decays == "model":
        dt = torch.nn.functional.softplus(
            torch.randn(Bt, S, H, generator=g, device=dev))
        A = -(torch.rand(H, generator=g, device=dev) * 15 + 1)
    else:
        dt = torch.rand(Bt, S, H, generator=g, device=dev) * 2.5 + 0.5
        A = -torch.tensor([12.0, 16.0] * (H // 2), device=dev)
    B = torch.randn(Bt, S, G, N, generator=g, device=dev).to(dtype)
    C = torch.randn(Bt, S, G, N, generator=g, device=dev).to(dtype)
    D = torch.randn(H, generator=g, device=dev)
    st = torch.randn(Bt, H, P, N, generator=g, device=dev) if init else None
    return x, dt, A, B, C, D, st


def _ssd_chunk(S: int) -> int:
    return min(256, max(16, 1 << (S - 1).bit_length()))   # ops.ssd's rule


def _ssd_f64(x, dt, A, B, C, D, st):
    """The sequential recurrence in float64 on the card: how far each f32
    implementation is from the exact scan of the same f32 operands."""
    import torch
    rep = x.shape[2] // B.shape[2]
    xd, dtd, Ad = x.double(), dt.double(), A.double()
    Bd = B.double().repeat_interleave(rep, 2)
    Cd = C.double().repeat_interleave(rep, 2)
    state = (st.double() if st is not None else
             torch.zeros(*x.shape[:1], *x.shape[2:], B.shape[3],
                         dtype=torch.float64, device=x.device))
    ys = []
    for s in range(x.shape[1]):
        state = torch.exp(dtd[:, s] * Ad)[..., None, None] * state + \
            (dtd[:, s, :, None] * xd[:, s])[..., None] * Bd[:, s, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Cd[:, s]))
    return torch.stack(ys, 1) + D.double()[None, None, :, None] * xd


def phase_parity_ssd() -> dict:
    """K8 against its plain version (the chunked scan) and against the
    sequential oracle, on the same operands on the card."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd, ssd_chunked, ssd_ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    errs = {}
    log("parity: K8 ssd_scan against its plain version and the sequential "
        "oracle")
    runs = [(c, dtype, "reference") for c in SSD_CASES
            for dtype in (torch.float32, torch.bfloat16)]
    runs += [(c, dtype, "model") for c in SSD_CASES[:2]
             for dtype in (torch.float32, torch.bfloat16)]
    runs += [(("large decays", 1, 512, 2, 64, 1, 64, True), torch.float32,
              "large")]
    for (name, Bt, S, H, P, G, N, init), dtype, decays in runs:
        x, dt, A, B, C, D, st = _ssd_inputs(g, Bt, S, H, P, G, N, dtype,
                                            decays, init)
        y, final = ssd(x, dt, A, B, C, D, initial_state=st)
        torch.cuda.synchronize()
        tol = SSD_TOL[str(dtype).split(".")[1]]
        if decays == "model":
            tol = SSD_TOL["bfloat16"]      # summation order, see the docstring
        what = (f"K8 {dtype} {name}: Bt{Bt} S{S} H{H} P{P} G{G} N{N}, "
                f"{decays} decays")
        yc, fc = ssd_chunked(x, dt, A, B, C, D, st if init else
                             torch.zeros(Bt, H, P, N, device="cuda"),
                             _ssd_chunk(S))
        yr, fr = ssd_ref(x, dt, A, B, C, D, initial_state=st)
        torch.cuda.synchronize()
        if decays == "model" and dtype == torch.float32:
            exact = _ssd_f64(x, dt, A, B, C, D, st)
            rel = [float(((v.double() - exact).abs() / (1 + exact.abs())).max())
                   for v in (y, yc, yr)]
            log(f"  {what}: max |err| / (1 + |y|) against the f64 scan: "
                f"kernel {rel[0]:.2e}, plain {rel[1]:.2e}, oracle "
                f"{rel[2]:.2e} (reported)")
        err = check_close(what + ", y vs plain", y, yc, tol)
        check_close(what + ", final state vs plain", final, fc,
                    SSD_TOL["float32"] if decays != "model" else tol)
        check_close(what + ", y vs oracle", y, yr, tol)
        if dtype == torch.bfloat16 and decays == "reference":
            row = {"mamba2-130m prefill": "ssd_scan",
                   "zamba2-1.2b prefill": "ssd_scan[zamba2-1.2b]",
                   "mamba2-130m fan-out": "ssd_scan[fan-out]",
                   "zamba2-1.2b fan-out":
                       f"ssd_scan[fan-out {SSM_ARCHS[1]}]"}.get(name)
            if row is not None:
                errs[row] = err
    return errs


def launch_counters() -> dict:
    """Every kernel's launch counter, by the name its timing row carries."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.state_push import ops as sp_ops
    return {"flash_attention": flash_ops.LAUNCHES,
            "decode_attention": decode_ops.LAUNCHES,
            "moe_gmm": gmm_ops.LAUNCHES,
            "ssd_scan": ssd_ops.LAUNCHES,
            **{f"state_push.{k}": c for k, c in sp_ops.LAUNCHES.items()}}


def reset_launches() -> None:
    for c in launch_counters().values():
        c.reset()


def read_launches() -> dict:
    return {k: c.value for k, c in launch_counters().items()}


def split_launches(res, want_loop: dict, want_warm: dict) -> dict:
    """The launches of a ``serve.main`` run on the card (counters zeroed
    just before), split into its eager warm-up's (one prefill and one
    decode step on the capture stream, which the launcher keeps) and its
    loop's (the graphs' replays).  Each must equal its expectation
    exactly (a kernel left out of either fails here too), and the loop
    must have replayed one prefill graph and one decode graph per new
    token after the first.  Returns the loop's launches."""
    graphs = res["graphs"]
    total = read_launches()
    warm = {k: graphs.warmup_launches.count(c)
            for k, c in launch_counters().items()}
    loop = {k: total[k] - warm[k] for k in total}
    log(f"  launches of the loop {loop} (expected {want_loop}); of the "
        f"warm-up {warm} (expected {want_warm}); replays {graphs.replays}")
    if loop != want_loop:
        raise AssertionError(f"loop launches {loop}, expected {want_loop}")
    if warm != want_warm:
        raise AssertionError(f"warm-up launches {warm}, expected {want_warm}")
    if graphs.replays != {"prefill": 1, "decode": NEW_TOKENS - 1}:
        raise AssertionError(f"replays {graphs.replays}")
    return loop


def warmup_launches(want_loop: dict, prefill: dict) -> dict:
    """One prefill's and one decode step's launches (the warm-up's), from
    the loop's and the prefill's."""
    return {k: prefill.get(k, 0) + (n - prefill.get(k, 0)) // (NEW_TOKENS - 1)
            for k, n in want_loop.items()}


def close_graphs(res) -> None:
    """Free a served model's step graphs (graphs, then their pool)."""
    if res.get("graphs") is not None:
        res["graphs"].close()


def free_model(res) -> None:
    """Close a served model's graphs and let its weights leave the card."""
    import torch
    close_graphs(res)
    res.clear()
    gc.collect()
    torch.cuda.empty_cache()


def uncounted_biases(cfg) -> int:
    """The bias parameters ``ModelConfig.param_count()`` leaves out (it
    counts QKV biases only): the output projection's and the MLP's, per
    layer (starcoder2-7b has both)."""
    return cfg.n_layers * ((cfg.d_model if cfg.o_bias else 0) + (
        cfg.d_ff + cfg.d_model if cfg.mlp_bias else 0))


def phase_serve(arch: str = ARCH) -> tuple:
    """The launcher's main path on a dense decoder at full width, counters
    zeroed just before: K5 once per layer in the prefill, K6 once per
    layer and decode step; the drawn parameters counted against
    ``param_count()`` (plus ``uncounted_biases``)."""
    import torch
    from repro_torch.launch import serve
    log(f"serve: {arch} full width, bf16, batch {BATCH}, prompt {PROMPT}, "
        f"{NEW_TOKENS} new tokens")
    reset_launches()
    res = serve.main(["--arch", arch, "--batch", str(BATCH), "--prompt-len",
                      str(PROMPT), "--new-tokens", str(NEW_TOKENS),
                      "--device", "cuda", "--seed", str(SEED)],
                     keep_logits=True)
    cfg = res["cfg"]
    want = {k: 0 for k in launch_counters()}
    want.update({"flash_attention": cfg.n_layers,
                 "decode_attention": cfg.n_layers * (NEW_TOKENS - 1)})
    launches = split_launches(res, want, warmup_launches(
        want, {"flash_attention": cfg.n_layers}))
    gen, logits = res["gen"], res["logits"]
    if tuple(gen.shape) != (BATCH, NEW_TOKENS) or len(logits) != NEW_TOKENS:
        raise AssertionError(f"generated {tuple(gen.shape)}, "
                             f"{len(logits)} logits")
    for i, lg in enumerate(logits):
        if tuple(lg.shape) != (BATCH, cfg.vocab_size) or \
                not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"step {i}: bad logits {tuple(lg.shape)}")
    if not bool(((gen >= 0) & (gen < cfg.vocab_size)).all()):
        raise AssertionError("generated ids out of the vocabulary")
    n_params = sum(p.numel() for p in res["params"].parameters())
    want_params = cfg.param_count() + uncounted_biases(cfg)
    if n_params != want_params or res["params"].embed.dtype != torch.bfloat16:
        raise AssertionError(f"{n_params} parameters (param_count() "
                             f"{cfg.param_count()} + {uncounted_biases(cfg)} "
                             f"biases it leaves out), or not bf16")
    log(f"  {n_params / 1e6:.1f}M parameters (param_count() "
        f"{cfg.param_count()} + {uncounted_biases(cfg)} biases; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card); prefill "
        f"{res['prefill_s'] * 1e3:.2f}ms, decode {res['decode_s'] * 1e3:.2f}ms "
        f"(first run: {BATCH * (NEW_TOKENS - 1) / res['decode_s']:.1f} tok/s)")
    return res, launches


def phase_reference(res) -> list:
    """The kernel path's teacher-forced logits against the plain path's:
    within LOGIT_TOL where LOGITS_HELD says so (else reported), the argmax
    on MIN_ARGMAX_AGREEMENT of the rows.  Returns the plain path's logits
    per step."""
    from repro_torch.models import ExecConfig, build_model
    cfg, gen = res["cfg"], res["gen"]
    plain = build_model(cfg, ExecConfig(backend="torch"))
    ref_logits, _ = _teacher_run(res, plain)
    worst, excess, agree = _held(res["logits"], ref_logits, gen)
    within = sum(int(((g - w).abs() <= LOGIT_TOL * (1 + w.abs())).all(-1).sum())
                 for g, w in zip(res["logits"], ref_logits))
    held = LOGITS_HELD.get(cfg.name, True)
    log(f"reference {cfg.name}: kernel path vs plain path, teacher-forced "
        f"over {NEW_TOKENS} steps: max |dlogit| {worst:.4f} (max |logit| "
        f"{max(float(w.abs().max()) for w in ref_logits):.3f}; {within} of "
        f"{BATCH * NEW_TOKENS} rows within {LOGIT_TOL} abs + rel, "
        f"{'held' if held else 'reported'}), argmax agreement {agree:.3f}")
    if held and excess > 0:
        raise AssertionError(f"logits outside tolerance by {excess:.4f}")
    if agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"argmax agreement {agree:.3f} < "
                             f"{MIN_ARGMAX_AGREEMENT}")
    return ref_logits


def sdpa(q, k, v, **kw):
    """SDPA on (B, heads, S, D) operands, grouped (``enable_gqa``) where
    K/V have fewer heads than q, as K5 and K6 take them: the same
    function as the kernel's, on the same operands."""
    import torch.nn.functional as F
    if q.shape[1] != k.shape[1]:
        kw["enable_gqa"] = True
    return F.scaled_dot_product_attention(q, k, v, **kw)


def sdpa_kernels(fn) -> str:
    """The SDPA backend one call of ``fn`` ran, read off the names of the
    kernels in a whole profiler trace of it, and those kernels."""
    per_call = kernels_per_call(fn, iters=5)
    if per_call is None:
        return "unknown (no whole trace)"
    names = " ".join(per_call).lower()
    backend = ("cudnn" if "cudnn" in names else
               "flash" if "flash" in names else
               "efficient" if "fmha" in names or "mem_eff" in names else
               "math")
    return f"the {backend} backend ({per_call})"


def _library_times(kernel, q, k, v, **kw) -> tuple:
    """The kernel's and SDPA's device times by one method
    (``device_times``).  At a grouped-query shape (K/V with fewer heads
    than q), SDPA computes the grouped function (``sdpa``), and SDPA on
    K/V repeated to the query's heads (the copies made before the timed
    calls) is timed beside it, each with the kernels it ran, for the log.
    Returns (kernel ms, SDPA ms, method, note)."""
    import torch.nn.functional as F
    H, K = q.shape[1], k.shape[1]
    lib = lambda: sdpa(q, k, v, **kw)
    if H == K:
        (k_ms, lib_ms), how = device_times([kernel, lib])
        return k_ms, lib_ms, how, ""
    kr, vr = (x.repeat_interleave(H // K, dim=1) for x in (k, v))
    rep = lambda: F.scaled_dot_product_attention(q, kr, vr, **kw)
    (k_ms, lib_ms, rep_ms), how = device_times([kernel, lib, rep])
    return k_ms, lib_ms, how, (
        f"; SDPA with enable_gqa ran {sdpa_kernels(lib)}; SDPA on K/V "
        f"repeated to {H} heads took {rep_ms * 1e3:.2f}us and ran "
        f"{sdpa_kernels(rep)}")


def _flash_row(name, B, S, H, K, D, launches, errs, g, Sk=None,
               causal=True) -> tuple:
    """K5 at one layer's prefill call (bf16; causal with Sq = Sk = S, or
    without a mask over ``Sk`` keys): its kernels-line row (device time
    from the profiler, plain version, SDPA, bound), its back-to-back call
    time, the method and a note on SDPA (``_library_times``)."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    bf16, dev = torch.bfloat16, "cuda"
    Sk = S if Sk is None else Sk
    q = torch.randn(B, S, H, D, generator=g, device=dev).to(bf16)
    k = torch.randn(B, Sk, K, D, generator=g, device=dev).to(bf16)
    v = torch.randn(B, Sk, K, D, generator=g, device=dev).to(bf16)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    flops, nbytes = flash_ops.cost(B, S, Sk, H, K, D, causal, 2)
    kernel = lambda: flash_attention(q, k, v, causal=causal)
    back_to_back = call_ms(kernel)
    queued, how = queued_ms(kernel)
    log(f"  {name}: {queued * 1e3:.2f}us per call by CUDA events, {how}")
    k_ms, lib_ms, how, note = _library_times(kernel, qt, kt, vt,
                                             is_causal=causal)
    row = _row(
        name, "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:84", launches, errs,
        k_ms, device_ms(lambda: attention_ref(q, k, v, causal=causal),
                        iters=5),
        lib_ms, nbytes, flops)
    return row, back_to_back, how, note


def _log_flash_row(r, back_to_back, how, shape, note="") -> None:
    log(f"timing, K5 at {shape}: {r['ms'] * 1e3:.1f}us device, "
        f"{back_to_back * 1e3:.1f}us back-to-back, bound "
        f"{r['bound_ms'] * 1e3:.2f}us ({r['bound_by']}), plain "
        f"{r['plain_ms'] * 1e3:.1f}us, library {r['library_ms'] * 1e3:.1f}us "
        f"(SDPA; kernel and SDPA by the {how}), launches "
        f"{r['launches']}{note}")


def phase_timing_flash(res, launches: int, errs) -> list:
    """K5 at a served model's prefill shape (batch 4, prompt 512), named
    by the model, with the launches of its main-path run."""
    import torch
    cfg = res["cfg"]
    name = "flash_attention" if cfg.name == ARCH else \
        f"flash_attention[{cfg.name}]"
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    row, back_to_back, how, note = _flash_row(
        name, BATCH, PROMPT, H, K, D, {name: launches}, errs, g)
    _log_flash_row(row, back_to_back, how, f"{cfg.name}'s prefill (B "
                   f"{BATCH} S {PROMPT} H {H} K {K} D {D})", note)
    return [row]


def _decode_operands(g, B, S, H, K, D, n=None):
    """The last decode step of one layer: bf16 q, a cache of S positions
    with ``n`` (S - 1 unless given) valid in every row, the lengths, and
    SDPA's operands (the heads' axis second, a boolean mask)."""
    import torch
    bf16, dev = torch.bfloat16, "cuda"
    q = torch.randn(B, H, D, generator=g, device=dev).to(bf16)
    kc = torch.randn(B, S, K, D, generator=g, device=dev).to(bf16)
    vc = torch.randn(B, S, K, D, generator=g, device=dev).to(bf16)
    lengths = torch.full((B,), S - 1 if n is None else n, dtype=torch.int32,
                         device=dev)
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None]
    sdpa = (q[:, :, None], kc.transpose(1, 2).contiguous(),
            vc.transpose(1, 2).contiguous(), mask)
    return q, kc, vc, lengths, sdpa


def one_decode_kernel(kernel) -> str:
    """Holds that one call of K6 launches one kernel, ``decode_kernel``,
    and no other (no combine kernel): in a whole profiler trace, exactly
    one record a call of that kernel and none of another; and in a CUDA
    graph of one call, one node, a kernel.  Returns what it saw."""
    per_call = kernels_per_call(kernel)
    nodes = graph_node_types(kernel)
    if per_call is not None and (
            len(per_call) != 1 or "decode_kernel" not in next(iter(per_call))
            or next(iter(per_call.values()))[0] != 1.0):
        raise AssertionError(f"K6 launched {per_call} per call, not one "
                             f"decode_kernel")
    if nodes != [CU_GRAPH_NODE_TYPE_KERNEL]:
        raise AssertionError(f"K6's graph of one call has nodes of types "
                             f"{nodes}, not one kernel")
    return (f"{per_call if per_call is not None else 'no whole trace'} in "
            f"the profiler, 1 node in a CUDA graph")


def _decode_row(name, B, S, H, K, D, launches, errs, g, full=False) -> tuple:
    """K6 at one layer's last decode step (bf16, a cache of S positions,
    S - 1 valid, or all S with ``full``, as a cross-attention cache): its
    kernels-line row (kernel and SDPA timed by one method, plain version,
    bound), its back-to-back call time, the method, the kernels one call
    launched (``one_decode_kernel``) and a note on SDPA
    (``_library_times``)."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.decode_attention import ops as decode_ops
    n = S if full else S - 1
    q, kc, vc, lengths, (qt, kt, vt, mask) = _decode_operands(g, B, S, H, K,
                                                              D, n)
    flops, nbytes = decode_ops.cost(B, S, H, K, D, 2, n)
    kernel = lambda: decode_attention(q, kc, vc, lengths)
    back_to_back = call_ms(kernel)
    k_ms, lib_ms, how, note = _library_times(kernel, qt, kt, vt,
                                             attn_mask=mask)
    row = _row(
        name, "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:69", launches, errs,
        k_ms, device_ms(lambda: decode_attention_ref(q, kc, vc, lengths)),
        lib_ms, nbytes, flops)
    return row, back_to_back, how, one_decode_kernel(kernel), note


def phase_timing_decode(res, launches: int, errs) -> list:
    """K6 at a served model's last decode step (batch 4, a cache of
    prompt + new tokens), named by the model, with the launches of its
    main-path run."""
    import torch
    cfg = res["cfg"]
    name = "decode_attention" if cfg.name == ARCH else \
        f"decode_attention[{cfg.name}]"
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    row, back_to_back, how, per_call, note = _decode_row(
        name, BATCH, PROMPT + NEW_TOKENS, H, K, D, {name: launches}, errs, g)
    log(f"timing, K6 at {cfg.name}'s last decode step (B {BATCH} S "
        f"{PROMPT + NEW_TOKENS} H {H} K {K} D {D}): {row['ms'] * 1e3:.2f}us "
        f"device, {back_to_back * 1e3:.1f}us back-to-back, bound "
        f"{row['bound_ms'] * 1e3:.2f}us ({row['bound_by']}), plain "
        f"{row['plain_ms'] * 1e3:.1f}us, library "
        f"{row['library_ms'] * 1e3:.2f}us (SDPA, masked; kernel and SDPA by "
        f"the {how}), launches {row['launches']}; kernels per call: "
        f"{per_call}{note}")
    return [row]


def phase_timing_fanout(qwen_launches, ssm_launches, hybrid, errs) -> list:
    """K5 and K8 at the fan-out's (1, 16) forward (qwen1.5-0.5b's,
    mamba2-130m's and zamba2-1.2b's), with each fan-out's launches (its
    warm-ups and replays), and K6 at the decode step of the serving loop
    that zamba2-1.2b's fan-out run serves first (B 1, a cache of 18),
    with that loop's launches.  ``hybrid`` is zamba2-1.2b's
    ``phase_fanout`` result."""
    import torch
    from repro_torch.configs import get_config
    rows = phase_timing_fanout_flash(qwen_launches["flash_attention"], errs)
    rows += phase_timing_ssd({"cfg": get_config(SSM_ARCHS[0])},
                             ssm_launches["ssd_scan"], errs, Bt=1, S=16,
                             name="ssd_scan[fan-out]")
    r, launches = hybrid
    cfg = get_config(SSM_ARCHS[1])
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows += phase_timing_fanout_flash(launches["flash_attention"], errs, cfg)
    rows += phase_timing_ssd({"cfg": cfg}, launches["ssd_scan"], errs, Bt=1,
                             S=16, name=f"ssd_scan[fan-out {cfg.name}]")
    name = f"decode_attention[fan-out {cfg.name}]"
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    row, back_to_back, how, per_call, note = _decode_row(
        name, 1, 18, H, K, D, {name: r["loop_launches"]["decode_attention"]},
        errs, g)
    log(f"timing, K6 at {cfg.name}'s fan-out run's decode step (B 1 S 18 H "
        f"{H} K {K} D {D}): {row['ms'] * 1e3:.2f}us device, "
        f"{back_to_back * 1e3:.1f}us back-to-back, bound "
        f"{row['bound_ms'] * 1e3:.2f}us ({row['bound_by']}), plain "
        f"{row['plain_ms'] * 1e3:.1f}us, library "
        f"{row['library_ms'] * 1e3:.2f}us (SDPA, masked; by the {how}), "
        f"launches {row['launches']}; kernels per call: {per_call}{note}")
    return rows + [row]


def phase_timing_fanout_flash(launches: int, errs, cfg=None) -> list:
    """K5 at the fan-out's (1, 16) forward, qwen1.5-0.5b's unless ``cfg``
    (zamba2-1.2b's shared block)."""
    import torch
    from repro_torch.configs import get_config
    cfg = cfg or get_config(ARCH)
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    name = ("flash_attention[fan-out]" if cfg.name == ARCH
            else f"flash_attention[fan-out {cfg.name}]")
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    row, back_to_back, how, _ = _flash_row(name, 1, 16, H, K, D,
                                           {name: launches}, errs, g)
    _log_flash_row(row, back_to_back, how, f"the fan-out's forward (B 1 "
                   f"S 16 H {H} K {K} D {D})")
    return [row]


def phase_timing(res, launches, errs) -> list:
    """K5 and K6 at a dense decoder's prefill and last decode step."""
    rows = phase_timing_flash(res, launches["flash_attention"], errs)
    rows += phase_timing_decode(res, launches["decode_attention"], errs)
    return rows


def check_bound(name: str, got, want, bound: float) -> float:
    """Max |got - want|; raises above ``bound`` or on a non-finite value."""
    import torch
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    log(f"  {name}: max_abs_err {err:.3e} (bound {bound:.3e}) "
        f"{'ok' if err <= bound else 'FAIL'}")
    if err > bound:
        raise AssertionError(f"{name}: {err:.3e} above {bound:.3e}")
    return err


def _sp_rows(g, n: int, scale: float = 1.0):
    """Random local/base values of n f32 on the card, and their rows."""
    import torch
    from repro_torch.kernels.state_push import ops as sp
    eff = torch.randn(n, generator=g, device="cuda") * scale
    base = torch.randn(n, generator=g, device="cuda") * scale
    return eff, base, sp._to_rows(eff)[0], sp._to_rows(base)[0]


def phase_parity_state_push() -> dict:
    """K1-K4 against their plain versions at the serve/stats size and at a
    ragged size; K1 against the numpy host codec bitwise (codes, scales,
    residual), K4 against its plain version's e4m3 cast bitwise."""
    import numpy as np
    import torch
    from repro_torch.kernels.state_push import hostcodec
    from repro_torch.kernels.state_push import ops as sp
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    errs = {}
    log("parity: state-push kernels K1-K4 against their plain versions")
    for n in (STATS_NUMEL, 4097):
        eff, base, lr, br = _sp_rows(g, n)
        delta_max = float((eff - base).abs().max())
        for qmax in (127, 7):
            q, s, r = sp.quantize_rows(lr, br, qmax=qmax, with_residual=True)
            torch.cuda.synchronize()
            qh, sh, _, rh = hostcodec.encode_quant(
                eff.cpu().numpy(), base.cpu().numpy(), qmax=qmax)
            bitwise = (np.array_equal(q.cpu().numpy(), qh)
                       and np.array_equal(s.cpu().numpy(), sh)
                       and np.array_equal(r.reshape(-1)[:n].cpu().numpy(), rh))
            log(f"  K1 qmax {qmax} n {n}: codes, scales and residual "
                f"{'equal' if bitwise else 'DIFFER FROM'} the host codec's "
                f"bitwise")
            if not bitwise:
                raise AssertionError("K1 differs from the host codec")
            qp, spl, _ = sp.quantize_rows(lr, br, qmax=qmax, backend="torch")
            err = check_bound(f"K1 quantize_delta qmax {qmax} n {n} vs plain "
                              f"(dequantised)", q.float() * s,
                              qp.float() * spl, delta_max / qmax * 1.01)
            if n == STATS_NUMEL and qmax == 127:
                errs["state_push.quantize_delta"] = err
        lr8 = lr * 1e3                                # past +-448 unscaled
        q8, s8, _ = sp.quantize_rows(lr8, br, fp8=True)
        torch.cuda.synchronize()
        q8p, s8p, _ = sp.quantize_rows(lr8, br, fp8=True, backend="torch")
        bitwise = (torch.equal(q8.view(torch.uint8), q8p.view(torch.uint8))
                   and torch.equal(s8, s8p))
        log(f"  K4 n {n}: codes and scales "
            f"{'equal' if bitwise else 'DIFFER FROM'} the plain version's "
            f"bitwise")
        if not bitwise:
            raise AssertionError("K4 differs from its plain version")
        err = check_bound(f"K4 quantize_fp8 n {n} vs plain (dequantised)",
                          q8.float() * s8, q8p.float() * s8p, 0.0)
        if n == STATS_NUMEL:
            errs["state_push.quantize_fp8"] = err
        g_rows = lr.flip(0).contiguous()
        for codes, scales, kind in ((q, s, "int8"), (q8, s8, "e4m3")):
            out = sp.apply_rows(g_rows, codes, scales)
            torch.cuda.synchronize()
            err = check_close(f"K2 apply_delta {kind} n {n}", out,
                              sp.apply_rows(g_rows, codes, scales,
                                            backend="torch"),
                              TOL["float32"])
            if n == STATS_NUMEL:
                errs["state_push.apply_delta"] = max(
                    errs.get("state_push.apply_delta", 0.0), err)
        out = sp.push_rows(lr, br, g_rows)
        torch.cuda.synchronize()
        err = check_close(f"K3 push n {n}", out,
                          sp.push_rows(lr, br, g_rows, backend="torch"),
                          TOL["float32"])
        if n == STATS_NUMEL:
            errs["state_push.push"] = err
    return errs


def _per_forward(cfg) -> dict:
    """The kernels one (1, 16) forward of ``cfg`` launches: K5 once per
    attention layer, K8 once per Mamba layer, and the hybrid's K5 once
    per application of its shared block."""
    from repro_torch.models.ssm_stack import n_attn_apps
    if not cfg.ssm_state:
        return {"flash_attention": cfg.n_layers}
    apps = n_attn_apps(cfg)
    return {"ssd_scan": cfg.n_layers, **({"flash_attention": apps}
                                         if apps else {})}


def _stats_split(spans, stats_ms: float, calls: int) -> str:
    """How the wave's mean serve/stats time a call divides, from the wire
    spans of its last ``calls`` calls: the pulls (``wire.pull`` and
    ``wire.full_pull``, the tier's catch-up included), the int8 push
    (``wire.push``: the replica lock's wait, the encode and the apply),
    and the rest (the add, the handle's set-up, and the waits for the
    replica lock that a pull span does not cover)."""
    by_call = {}
    for x in spans:
        if x.call is not None and x.name in ("wire.pull", "wire.full_pull",
                                             "wire.push"):
            by_call.setdefault(x.call, []).append(x)
    wave = sorted(by_call)[-calls:]
    pull = sum(x.dur for c in wave for x in by_call[c]
               if x.name != "wire.push") * 1e3 / max(len(wave), 1)
    push = sum(x.dur for c in wave for x in by_call[c]
               if x.name == "wire.push") * 1e3 / max(len(wave), 1)
    full = sum(1 for c in wave for x in by_call[c]
               if x.name == "wire.full_pull")
    return (f"serve/stats {stats_ms:.2f}ms a call = pull {pull:.2f}ms "
            f"({full} full pulls or catch-ups in {len(wave)} calls) + int8 "
            f"push {push:.2f}ms + add and the rest "
            f"{stats_ms - pull - push:.2f}ms (wire spans of the wave's "
            f"calls)")


def _times(lat_ms) -> str:
    import numpy as np
    lat = np.asarray(lat_ms)
    return (f"p50 {np.percentile(lat, 50):.1f}ms, p99 "
            f"{np.percentile(lat, 99):.1f}ms")


def eager_fanout(res, leaves, payloads, n: int) -> dict:
    """The fan-out as it ran before its forward was captured, beside the
    graphed one: each call binds its parameters from pageable host leaves
    (``serve.bind_params``) and runs the forward op by op, on a stream of
    its own (so that CUDA events time its copy and forward alone), then
    pushes its token to serve/stats over the int8 wire.  FANOUT_WARM calls
    first (one an executor), then the first ``n`` of ``payloads`` timed as
    one wave."""
    import numpy as np
    import torch
    from repro_torch.core import FaasmRuntime, FunctionDef
    from repro_torch.launch import serve
    from repro_torch.state.ddo import VectorAsync
    model, cfg = res["model"], res["cfg"]
    times = []

    def infer(api):
        leaves_ = api.host.user_state(api.faaslet)["params"]
        tokens = torch.from_numpy(np.frombuffer(
            api.read_call_input(), np.int32).reshape(1, -1).copy())
        stream = torch.cuda.Stream()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with torch.cuda.stream(stream), torch.no_grad():
            ev[0].record()
            p = serve.bind_params(cfg, leaves_, torch.device("cuda"))
            ev[1].record()
            tok = int(model.logits(p, tokens.cuda())[0, -1].argmax())
            ev[2].record()
        ev[2].synchronize()
        times.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
        stats = VectorAsync(api, "serve/stats")
        stats.pull(track_delta=True)
        stats.add([tok], 1.0)
        stats.push_delta(wire="int8")
        api.write_call_output(np.int32(tok).tobytes())
        return 0

    rt = FaasmRuntime(n_hosts=1, capacity=FANOUT_WARM, device="cuda")
    try:
        VectorAsync.create(rt.global_tier, "serve/stats",
                           np.zeros(cfg.vocab_size, np.float32))
        rt.upload(FunctionDef("infer", infer,
                              init_fn=lambda api: {"params": leaves}))
        hint = ["serve/stats"]
        warm = rt.invoke_many("infer", payloads[:FANOUT_WARM],
                              state_hint=hint)
        if rt.wait_all(warm, timeout=300) != [0] * FANOUT_WARM:
            raise AssertionError("eager fan-out: a warm-up call failed")
        del times[:]
        payloads = payloads[:n]
        t0 = time.perf_counter()
        cids = rt.invoke_many("infer", payloads, state_hint=hint)
        rcs = rt.wait_all(cids, timeout=600)
        wall = time.perf_counter() - t0
        if rcs != [0] * len(payloads):
            raise AssertionError(f"eager fan-out return codes {rcs}")
        lat = [rt.call(c).latency * 1e3 for c in cids]
        tokens = [int(np.frombuffer(rt.output(c), np.int32)[0]) for c in cids]
    finally:
        rt.shutdown()
    h2d = float(np.mean([t[0] for t in times]))
    return {"rps": len(payloads) / wall, "lat_ms": lat, "tokens": tokens,
            "h2d_ms": h2d, "forward_ms": float(np.mean([t[1] for t in times]))}


def phase_fanout(arch: str) -> tuple:
    """The launcher's Faasm fan-out at full width: every request a Faaslet
    call of the port's runtime, replaying a captured forward (K5 or K8) on
    parameters copied from pinned leaves, serve/stats over the int8 wire
    (K1); then a short eager wave beside it and one call alone.  Returns
    (the fan-out's dict, its launches less the serving loop's)."""
    import numpy as np
    import torch
    from repro_torch import telemetry
    from repro_torch.launch import serve
    from repro_torch.launch.call_graphs import CallGraphs
    from repro_torch.models import ExecConfig, build_model
    log(f"fan-out: {arch} full width, {FANOUT_REQUESTS} requests of 16 "
        f"tokens, serve/stats on the int8 wire, each call a replay")
    t0 = time.perf_counter()
    reset_launches()
    tel = telemetry.enable()
    tel.take()
    try:
        res = serve.main(["--arch", arch, "--batch", "1", "--prompt-len",
                          "16", "--new-tokens", "2", "--faasm-requests",
                          str(FANOUT_REQUESTS), "--state-wire", "int8",
                          "--device", "cuda", "--seed", str(SEED)])
        torch.cuda.synchronize()
        spans = tel.take()
    finally:
        telemetry.disable()
    total = read_launches()
    cfg, r = res["cfg"], res["faasm"]
    counters = launch_counters()
    zero = {k: 0 for k in counters}
    per_fwd = dict(zero, **_per_forward(cfg))
    # the serving loop at batch 1: its warm-up (one prefill and one decode
    # step) and its replays (one prefill, one decode step) launch alike;
    # a decode step runs K6 wherever the prefill runs K5
    per_step = dict(per_fwd, decode_attention=per_fwd["flash_attention"])
    loop_warm = {k: res["graphs"].warmup_launches.count(c)
                 for k, c in counters.items()}
    fan_warm = {k: r["warmup_launches"].count(c) for k, c in counters.items()}
    close_graphs(res)
    log(f"  launches of the serving loop's warm-up {loop_warm}; of the "
        f"fan-out's {r['captures']} warm-ups before capture {fan_warm}")
    if loop_warm != per_step:
        raise AssertionError(f"serving loop warm-up launches {loop_warm}")
    if fan_warm != {k: n * r["captures"] for k, n in per_fwd.items()}:
        raise AssertionError(f"fan-out warm-up launches {fan_warm}")
    if r["shed"] or r["deadline_expired"] or None in r["tokens"]:
        raise AssertionError(f"fan-out: not every request served: shed "
                             f"{r['shed']}, expired {r['deadline_expired']}")
    calls = FANOUT_REQUESTS + FANOUT_WARM
    # every call replays once, and so does the build's warm call
    if r["replays"] != calls + 1 or not \
            1 <= r["captures"] == r["slots"] <= FANOUT_WARM:
        raise AssertionError(f"replays {r['replays']} (expected "
                             f"{calls + 1}), captures {r['captures']}, "
                             f"slots {r['slots']}")
    replayed = {k: total[k] - loop_warm[k] - fan_warm[k] for k in total}
    want = {k: per_step[k] + per_fwd[k] * r["replays"] for k in zero}
    log(f"  launches less the warm-ups' {replayed}; expected {want} with "
        f"state_push.quantize_delta >= {calls} (one per push)")
    k1 = "state_push.quantize_delta"
    if replayed[k1] < calls or \
            {k: n for k, n in replayed.items() if k != k1} != \
            {k: n for k, n in want.items() if k != k1}:
        raise AssertionError(f"fan-out launches {replayed}")
    tokens = r["tokens"] + r["warm_tokens"]
    hist = np.bincount(tokens, minlength=cfg.vocab_size).astype(np.float32)
    err = float(np.abs(r["stats"] - hist).max())
    bound = calls * INT8_STEP
    lost = calls - float(r["stats"].sum())
    log(f"  serve/stats vs the histogram of the {calls} returned tokens: "
        f"max |err| {err:.3e}, {calls} counts less the sum {lost:.3e} "
        f"(int8 bound {bound:.3e}: no count lost)")
    if r["stats"].shape != (cfg.vocab_size,) or err > bound or \
            abs(lost) > bound:
        raise AssertionError(f"serve/stats off the token histogram by "
                             f"{err}, its sum by {lost}")
    log("  " + _stats_split(spans, r["stats_ms"], FANOUT_REQUESTS))
    # each prompt's token by one (1, 16) forward on the card, as a call
    # runs it: the plain path's argmax (a batched forward would round its
    # GEMMs apart), and the kernel path's eager forward, which the
    # replayed graph must equal bitwise
    payloads = serve.fanout_payloads(cfg.vocab_size, FANOUT_REQUESTS, 16)
    prompts = [torch.tensor(np.frombuffer(p, np.int32)[None], device="cuda")
               for p in payloads]
    plain = build_model(cfg, ExecConfig(backend="torch"))
    with torch.no_grad():
        want_plain = [int(plain.logits(res["params"], t)[0, -1].argmax())
                      for t in prompts]
        want_eager = [int(res["model"].logits(res["params"], t)[0, -1]
                          .argmax()) for t in prompts]
    agree = float(np.mean(np.asarray(want_plain) == np.asarray(r["tokens"])))
    same = sum(a == b for a, b in zip(want_eager, r["tokens"]))
    log(f"  tokens vs the plain path's argmax: {agree:.3f} agree; vs the "
        f"kernel path's eager call: {same} of {FANOUT_REQUESTS} equal")
    if agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"fan-out token agreement {agree:.3f}")
    if same != FANOUT_REQUESTS:
        raise AssertionError("a replayed call's token differs from the "
                             "eager call's")
    gbps = r["param_bytes"] / r["param_h2d_ms"] / 1e6
    log(f"  graphed: {r['throughput_rps']:.2f} req/s, p50 {r['p50_ms']:.1f}"
        f"ms, p99 {r['p99_ms']:.1f}ms; per call (CUDA events on its slot's "
        f"stream, 8 at once) parameter copy {r['param_h2d_ms']:.2f}ms "
        f"({r['param_bytes'] / 1e9:.3f} GB, {gbps:.2f} GB/s), replay + "
        f"token {r['forward_ms']:.3f}ms, serve/stats push "
        f"{r['stats_ms']:.1f}ms, body {r['infer_ms']:.1f}ms; "
        f"{r['captures']} captures in {r['capture_ms']:.1f}ms (host, warm-up "
        f"and capture; {r['capture_ms'] / r['captures']:.1f}ms each); "
        f"state_push_mb {r['state_push_mb']:.3f}")
    # the same prompts through the eager fan-out, on a short wave
    leaves = serve.host_leaves(res["params"])
    e = eager_fanout(res, leaves, payloads, FANOUT_EAGER)
    same = sum(a == b for a, b in zip(e["tokens"], want_eager))
    log(f"  eager ({FANOUT_EAGER} requests, pageable leaves): "
        f"{e['rps']:.2f} req/s, {_times(e['lat_ms'])}; per call parameter "
        f"copy {e['h2d_ms']:.2f}ms ({r['param_bytes'] / e['h2d_ms'] / 1e6:.2f}"
        f" GB/s), forward + argmax {e['forward_ms']:.2f}ms; tokens equal to "
        f"the eager call's: {same} of {FANOUT_EAGER}")
    # one graphed call alone, with no other call on the card
    graphs = CallGraphs(res["model"], 1, "cuda")
    pinned = serve.HostLeaves(leaves, pin=True)
    prompt = np.frombuffer(payloads[0], np.int32)[None]
    alone = [graphs(pinned, prompt) for _ in range(3)][1:]
    graphs.close()
    log(f"  one graphed call alone (two, warm): parameter copy "
        f"{[round(a.h2d_ms, 3) for a in alone]}ms "
        f"({[round(r['param_bytes'] / a.h2d_ms / 1e6, 2) for a in alone]} "
        f"GB/s), replay + token {[round(a.forward_ms, 3) for a in alone]}ms")
    del res, pinned, leaves
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  fan-out {arch} in {time.perf_counter() - t0:.1f}s")
    r["loop_launches"] = {k: loop_warm[k] + per_step[k] for k in total}
    return r, {k: total[k] - loop_warm[k] - per_step[k] for k in total}


def phase_fig7() -> None:
    """The Fig. 7 twin (``examples/inference_serving_torch.py``) at full
    width, 12 requests, both isolation modes and cold ratios: a container
    cold start must have captured the forward again and a Faaslet cold
    start not; every run serves the same prompts, so the same tokens."""
    sys.path.insert(0, str(ROOT / "examples"))
    import inference_serving_torch as twin
    log(f"fig7: {ARCH} full width, {FIG7_REQUESTS} requests, faaslet and "
        f"container isolation, cold ratios 0 and 0.2")
    t0 = time.perf_counter()
    results = twin.main(["--requests", str(FIG7_REQUESTS), "--arch", ARCH])
    for r in results:
        log(f"  [{r['mode']} cold={r['cold_ratio']:.0%}] cold starts "
            f"{r['cold_starts']}, cache builds {r['misses']}, captures "
            f"{r['captures']} in {r['capture_ms']:.1f}ms; forced cold "
            f"starts: captures {r['cold_captures']}, ms "
            f"{[round(t, 1) for t in r['cold_ms']]}")
    by = {(r["mode"], r["cold_ratio"]): r for r in results}
    container, faaslet = by["container", 0.2], by["faaslet", 0.2]
    if not container["cold_captures"] or \
            min(container["cold_captures"]) < 1:
        raise AssertionError("a container cold start did not capture")
    if not faaslet["cold_captures"] or max(faaslet["cold_captures"]) != 0:
        raise AssertionError("a Faaslet cold start captured")
    if any(r["tokens"] != results[0]["tokens"] for r in results):
        raise AssertionError("the Fig. 7 runs served different tokens")
    log(f"  fig7 in {time.perf_counter() - t0:.1f}s")


def phase_device_plane() -> dict:
    """Two hosts of the runtime on the card: a call pushes from its device
    replica over the int8 wire (K1 on device tensors); the other host's
    device replica catches up through a delta pull (K2)."""
    import numpy as np
    import torch
    from repro_torch.core import FaasmRuntime, FunctionDef
    log(f"device plane: two hosts, a {STATS_NUMEL}-float key")
    rng = np.random.default_rng(SEED)
    init = rng.normal(size=STATS_NUMEL).astype(np.float32)
    upd = torch.from_numpy(
        (rng.normal(size=STATS_NUMEL) * 0.01).astype(np.float32)).cuda()
    reset_launches()
    rt = FaasmRuntime(n_hosts=2, capacity=2, device="cuda")
    try:
        gt = rt.global_tier
        gt.set("w", init.tobytes(), host="up")
        for h in rt.hosts.values():
            h.local_tier.pull("w")
            h.local_tier.to_device("w")

        def dev_push(api):
            dv = api.state_to_device("w", track_delta=True)
            api.state_update_device("w", dv + upd)
            api.push_state_delta("w", wire="int8")
            return 0

        rt.upload(FunctionDef("dev_push", dev_push))
        cid = rt.invoke("dev_push")
        if rt.wait(cid, timeout=120) != 0:
            raise AssertionError(f"dev_push failed: {rt.call(cid).error}")
        other = next(h for h in rt.hosts.values()
                     if h.id != rt.call(cid).host)
        moved = other.local_tier.pull("w", wire="int8")
        dev = other.local_tier.device_replica("w").value
        torch.cuda.synchronize()
        launches = read_launches()
        host = torch.from_numpy(np.frombuffer(gt.get("w", host="check"),
                                              np.float32).copy())
    finally:
        rt.shutdown()
    bound = float(upd.abs().max()) * INT8_STEP
    log(f"  pull moved {moved} B; launches {launches}")
    if dev.device.type != "cuda" or \
            launches["state_push.apply_delta"] < 1 or \
            launches["state_push.quantize_delta"] < 1:
        raise AssertionError(f"device plane launches {launches}")
    check_bound("device replica vs the global value", dev.cpu(), host, bound)
    check_bound("global value vs init + update", host,
                torch.from_numpy(init) + upd.cpu(), bound)
    return launches


def _wire_encodes(spans) -> tuple:
    """The int8 encodes a traced run made: wire.push spans of the int8
    wire (fenced ones too: they encode before the fence) and wire.pull
    spans that re-encoded a delta as int8."""
    pushes = sum(1 for x in spans
                 if x.name == "wire.push" and x.tags.get("wire") == "int8")
    pulls = sum(1 for x in spans
                if x.name == "wire.pull" and x.tags.get("wire") == "int8")
    return pushes, pulls


def _add(total: dict, part: dict) -> None:
    for k, n in part.items():
        total[k] = total.get(k, 0) + n


def phase_paper() -> dict:
    """The paper's other experiments through their twins on the card
    (``examples/*_torch.py``, ``benchmarks/bench_*_torch.py``), each with
    the counters zeroed just before it and read just after; returns the
    kernel launches of the phase, summed."""
    import numpy as np
    import torch
    from repro_torch import telemetry
    from repro_torch.data import make_sparse_dataset
    sys.path.insert(0, str(ROOT / "examples"))
    sys.path.insert(0, str(ROOT))
    import matmul_chained_torch
    import quickstart_torch
    import sgd_hogwild_torch
    from benchmarks import (bench_coldstart_torch, bench_dispatch_torch,
                            bench_micro_torch)
    t_phase = time.perf_counter()
    total = {}
    log("paper: the quickstart twin, two hosts, 8 chained workers")
    reset_launches()
    r = quickstart_torch.main([])
    want = np.zeros(8, np.float32)
    for i in range(8):
        want[i % 8] += i
    log(f"  quickstart: rc {r['rc']}, accumulated {r['final'].tolist()}, "
        f"transfer {r['transfer_bytes']} B")
    if r["rc"] != 0 or not np.array_equal(r["final"], want):
        raise AssertionError(f"quickstart value {r['final']}, want {want}")
    _add(total, read_launches())

    for splits in FIG8_SPLITS:
        reset_launches()
        r = matmul_chained_torch.main(["--n", str(FIG8_N),
                                       "--splits", str(splits)])
        log(f"  matmul n {FIG8_N} splits {splits}: rel-err "
            f"{r['rel_err']:.3e} (hold < 1e-5), wall {r['wall_s']:.3f}s, "
            f"transfer {r['transfer_bytes']} B")
        if not r["rel_err"] < 1e-5:
            raise AssertionError(f"matmul rel-err {r['rel_err']}")
        _add(total, read_launches())

    log(f"paper: Fig. 6 twin, {FIG6_FEATURES} features x {FIG6_EXAMPLES} "
        f"examples, {FIG6_WORKERS} workers x "
        f"{FIG6_EPOCHS} epochs, traced for the int8 encodes")
    t0 = time.perf_counter()
    X, y, _ = make_sparse_dataset(FIG6_FEATURES, FIG6_EXAMPLES, density=0.1,
                                  seed=0)
    log(f"  dataset in {time.perf_counter() - t0:.1f}s")
    tel = telemetry.enable()
    try:
        for wire in ("exact", "int8"):
            by = {}
            for mode in ("faaslet", "container"):
                reset_launches()
                tel.drain()
                t0 = time.perf_counter()
                r = sgd_hogwild_torch.run_mode(
                    mode, X, y, FIG6_WORKERS, FIG6_EPOCHS, 2, wire=wire,
                    device="cuda")
                torch.cuda.synchronize()
                got = read_launches()
                pushes, pulls = _wire_encodes(tel.drain())
                k1 = got["state_push.quantize_delta"]
                log(f"  [{mode:9s} {wire:5s}] run_mode "
                    f"{time.perf_counter() - t0:.1f}s, wall {r['wall_s']:.3f}s "
                    f"transfer {r['transfer_mb']:.6f}MB billable "
                    f"{r['billable_gbs']:.6e}GB-s hinge {r['hinge']:.4f} "
                    f"acc {r['acc']:.4f}; K1 {k1} launches, int8 encodes "
                    f"{pushes} pushed + {pulls} pulled")
                want_pushes = FIG6_WORKERS * FIG6_EPOCHS if wire == "int8" \
                    else 0
                if pushes != want_pushes or k1 != pushes + pulls:
                    raise AssertionError(
                        f"Fig. 6 {mode} {wire}: K1 {k1}, int8 pushes "
                        f"{pushes} (want {want_pushes}), pulls {pulls}")
                if not r["acc"] > 0.5:
                    raise AssertionError(f"Fig. 6 {mode} {wire}: accuracy "
                                         f"{r['acc']}")
                by[mode] = r
                _add(total, got)
            f, c = by["faaslet"], by["container"]
            log(f"  {wire}: container/faaslet transfer "
                f"{c['transfer_mb'] / f['transfer_mb']:.2f}x, billable "
                f"{c['billable_gbs'] / f['billable_gbs']:.1f}x, wall "
                f"{c['wall_s'] / f['wall_s']:.2f}x")
            if not (c["transfer_mb"] > f["transfer_mb"]
                    and c["billable_gbs"] > f["billable_gbs"]):
                raise AssertionError(f"Fig. 6 {wire}: no contrast")
    finally:
        telemetry.disable()
    for wire in ("exact", "int8"):
        reset_launches()
        t0 = time.perf_counter()
        card = sgd_hogwild_torch.run_mode("faaslet", X, y, 1, FIG6_EPOCHS, 2,
                                          wire=wire, device="cuda")
        got = read_launches()
        cpu = sgd_hogwild_torch.run_mode("faaslet", X, y, 1, FIG6_EPOCHS, 2,
                                         wire=wire, device="cpu")
        same = np.array_equal(card["weights"], cpu["weights"])
        log(f"  one worker, {wire}: weights on the card "
            f"{'equal' if same else 'DIFFER FROM'} the CPU run's bitwise; "
            f"hinge {card['hinge']:.6f} · {cpu['hinge']:.6f}, transfer "
            f"{card['transfer_mb']:.6f} · {cpu['transfer_mb']:.6f}MB; K1 "
            f"{got['state_push.quantize_delta']} launches; both runs in "
            f"{time.perf_counter() - t0:.1f}s")
        if not same:
            raise AssertionError(f"Fig. 6 one worker {wire}: the card's "
                                 f"weights differ from the CPU's")
        _add(total, got)
    del X, y

    log("paper: Fig. 9 twin (CUDA events, kernel vs plain vs library)")
    reset_launches()
    micro = bench_micro_torch.main([])
    got = {k: n for k, n in read_launches().items() if n}
    log(f"  launches {got} (the twin's count {micro.launches})")
    if got != micro.launches:
        raise AssertionError(f"Fig. 9 launches {got}, want {micro.launches}")
    _add(total, got)

    log("paper: Tab. 3 / Fig. 10 twin (bench_coldstart_torch.main)")
    reset_launches()
    cs = bench_coldstart_torch.main("cuda")
    got = read_launches()
    want_k1 = {("push", "exact"): 0, ("push", "int8"): 11,
               ("pull", "full"): 11, ("pull", "exact"): 11,
               ("pull", "int8"): 22}
    for (sec, mode), n in want_k1.items():
        seen = cs[sec][mode]["launches"]
        log(f"  {sec} {mode}: K1 {seen['quantize_delta']} (want {n}), K2 "
            f"{seen['apply_delta']}")
        if seen["quantize_delta"] != n:
            raise AssertionError(f"coldstart {sec} {mode}: K1 {seen}")
    seen = cs["pull"]["broadcast"]["launches"]
    log(f"  pull broadcast: K1 {seen['quantize_delta']} (11 pushes and one "
        f"re-encode per refresh that ran before its broadcast landed), K2 "
        f"{seen['apply_delta']}; pull bytes per refresh "
        f"{cs['pull']['broadcast']['pull_bytes_per_refresh']:.0f}")
    if not 11 <= seen["quantize_delta"] <= 22:
        raise AssertionError(f"coldstart pull broadcast: K1 {seen}")
    _add(total, got)

    log("paper: dispatch twin (the floors reported, not held: they measure "
        "the host's threads)")
    reset_launches()
    rs = bench_dispatch_torch.main(200, "cuda", hold_floors=False)
    met = bench_dispatch_torch.floors(rs[0])
    log(f"  faaslet: p99 {rs[0]['p99_ms']:.3f}ms (floor < 10: "
        f"{'met' if met['p99'] else 'MISSED'}), batch "
        f"{rs[0]['speedup']:.2f}x serial (floor >= 5: "
        f"{'met' if met['batch'] else 'MISSED'}); container p99 "
        f"{rs[1]['p99_ms']:.3f}ms, batch {rs[1]['speedup']:.2f}x")
    _add(total, read_launches())
    log(f"  paper phase in {time.perf_counter() - t_phase:.1f}s; launches "
        f"{ {k: n for k, n in total.items() if n} }")
    return total


def _chaos_view(tier, key: str = CHAOS_KEY):
    import numpy as np
    return tier.replica(key).buf.view(np.float32)


def chaos_storm(seed: int, n: int = 256, wire: str = "exact",
                n_iters: int = CHAOS_ITERS, device: str = "cuda") -> dict:
    """``tests/test_chaos.py``'s storm with the tiers on ``device``: two
    pusher tiers, a broadcast subscriber and a polling puller under
    ``FaultPlan.random(seed)``, each pusher adding 1 to its own element
    and pushing ``n_iters`` times.  On the exact wire the global value
    must be the fault-free sum exactly and every replica equal to it
    after one repair pull.  On the int8 wire (``n`` at least
    ``INT8_WIRE_MIN_BYTES / 4``) every push encodes on the card (K1) and
    the puller holds a device replica, synced after each of its int8
    delta pulls, so every frame it pulls is applied on the card (K2): the
    global value and every replica (the device one too) within the int8
    bound of the sum, K1 launched exactly once per int8 encode the wire
    spans record (pushes and pulls), K2 once per int8 frame the puller
    pulled, and each injected codec error a push that fell back to the
    exact wire with no K1 launch.  Raises on any failure; returns the
    plan's fired faults and the launches."""
    import threading
    import numpy as np
    import torch
    from repro_torch import faults, telemetry
    from repro_torch.state.kv import GlobalTier
    from repro_torch.state.local import LocalTier
    gt = GlobalTier(device=device)
    gt.set(CHAOS_KEY, np.zeros(n, np.float32).tobytes(), host="seed")
    pushers = []
    for i in range(2):
        t = LocalTier(f"push{i}", gt)
        t.pull(CHAOS_KEY)
        t.snapshot_base(CHAOS_KEY)
        pushers.append(t)
    sub = LocalTier("sub", gt)
    sub.pull(CHAOS_KEY)
    sub.subscribe(CHAOS_KEY)
    puller = LocalTier("puller", gt)
    puller.pull(CHAOS_KEY)
    quant = wire != "exact"
    if quant:
        puller.to_device(CHAOS_KEY)
    stop, errors = threading.Event(), []

    def push_loop(t, slot):
        try:
            for _ in range(n_iters):
                _chaos_view(t)[slot] += 1.0
                t.push_delta(CHAOS_KEY, wire=wire)
        except Exception as e:
            errors.append(e)

    def pull_loop():
        try:
            while not stop.is_set():
                puller.pull(CHAOS_KEY, wire=wire if quant else None)
                if quant:
                    puller.to_device(CHAOS_KEY)
                time.sleep(0.001)
        except Exception as e:
            errors.append(e)

    tel = telemetry.enable()
    tel.take()
    reset_launches()
    try:
        with faults.armed(faults.FaultPlan.random(seed)) as plan:
            threads = [threading.Thread(target=push_loop, args=(t, i))
                       for i, t in enumerate(pushers)]
            pt = threading.Thread(target=pull_loop)
            for th in threads + [pt]:
                th.start()
            for th in threads:
                th.join(timeout=60)
            stop.set()
            pt.join(timeout=60)
            gt.flush_broadcasts()
        if errors:
            raise AssertionError(f"storm {seed} ({wire}): {errors!r}")
        want = np.zeros(n, np.float32)
        want[0] = want[1] = n_iters
        got = np.frombuffer(gt.get(CHAOS_KEY, host="check"), np.float32)
        bound = 2 * n_iters * INT8_STEP if quant else 0.0
        err = float(np.abs(got - want).max())
        if err > bound:
            raise AssertionError(f"storm {seed} ({wire}): the global value "
                                 f"is {err} off the sum (bound {bound})")
        for t in (sub, puller, *pushers):
            t.pull(CHAOS_KEY, wire=wire if quant else None)
            e = float(np.abs(_chaos_view(t)[:n] - got).max())
            if e > bound:
                raise AssertionError(f"storm {seed} ({wire}): {t.host_id} "
                                     f"{e} off after a repair pull")
        if quant:
            dev = puller.to_device(CHAOS_KEY)
            e = float((dev.cpu() - torch.from_numpy(got.copy())).abs().max())
            if dev.device.type != device or e > bound:
                raise AssertionError(f"storm {seed}: the device replica "
                                     f"{e} off on {dev.device}")
        if device == "cuda":
            torch.cuda.synchronize()
        launches = read_launches()
        spans = tel.take()
    finally:
        telemetry.disable()
    pushes, pulls = _wire_encodes(spans)
    applied = sum(1 for x in spans if x.name == "wire.pull"
                  and x.tags.get("wire") == "int8"
                  and x.tags.get("puller") == "puller")
    fallbacks = sum(t.codec_fallbacks for t in pushers)
    fired = {p: plan.fired(p) for p in sorted({r.point for r in plan.rules})}
    out = {"fired": fired, "pushes": pushes, "pulls": pulls,
           "applied": applied, "fallbacks": fallbacks, "err": err,
           "launches": launches}
    if fallbacks != plan.fired("codec-error"):
        raise AssertionError(f"storm {seed}: {fallbacks} codec fallbacks, "
                             f"{plan.fired('codec-error')} codec errors")
    if quant and device == "cuda":
        k1 = launches["state_push.quantize_delta"]
        k2 = launches["state_push.apply_delta"]
        if k1 != pushes + pulls or k2 != applied or not pushes:
            raise AssertionError(f"storm {seed}: K1 {k1} for {pushes} + "
                                 f"{pulls} int8 encodes, K2 {k2} for "
                                 f"{applied} int8 frames pulled")
    return out


def chaos_kill_during_fanout(device: str = "cuda") -> dict:
    """``test_runtime_chaos_kill_during_fanout`` with the runtime on
    ``device``: 8 increments under ``FaultPlan.random(11)`` and a host
    killed mid-wave; each must land exactly once.  Returns the kernel
    launches of the scenario."""
    import numpy as np
    import torch
    from repro_torch import faults
    from repro_torch.core import FaasmRuntime, FunctionDef
    from repro_torch.state.ddo import VectorAsync
    reset_launches()
    rt = FaasmRuntime(n_hosts=3, capacity=1, backoff=0.001, device=device)
    try:
        VectorAsync.create(rt.global_tier, CHAOS_KEY,
                           np.zeros(8, np.float32))

        def inc(api):
            time.sleep(0.01)
            v = VectorAsync(api, CHAOS_KEY)
            v.pull(track_delta=True)
            v.add(0, 1.0)
            v.push_delta(wire="exact")
            return 0

        rt.upload(FunctionDef("inc", inc))
        with faults.armed(faults.FaultPlan.random(11)):
            cids = rt.invoke_many("inc", [b""] * 8, state_hint=[CHAOS_KEY])
            deadline = time.monotonic() + 5.0
            victim = None
            while victim is None and time.monotonic() < deadline:
                victim = next((h for h in rt.alive_hosts()
                               if h._inflight > 0), None)
            if victim is None:
                raise AssertionError("kill during fan-out: no busy host")
            rt.fail_host(victim.id)
            rcs = rt.wait_all(cids, timeout=60)
        got = float(np.frombuffer(rt.global_tier.get(CHAOS_KEY, host="c"),
                                  np.float32)[0])
        attempts = [rt.call(c).attempts for c in cids]
    finally:
        rt.shutdown()
    if device == "cuda":
        torch.cuda.synchronize()
    log(f"  kill during fan-out: host {victim.id} failed, return codes "
        f"{rcs}, attempts {attempts}, global {got} (want 8.0)")
    if rcs != [0] * 8 or got != 8.0:
        raise AssertionError(f"kill during fan-out: {rcs}, global {got}")
    return read_launches()


def chaos_codec_fallback(device: str = "cuda") -> dict:
    """``test_codec_error_falls_back_to_exact_wire`` on ``device``: an
    injected codec error on an int8 push re-pushes the same delta on the
    exact wire under the same fence token, with no K1 launch counted;
    the landed value is exact, and the token cannot be replayed.  An
    int8 push after it launches K1 once.  Returns the kernel launches of
    the scenario."""
    import numpy as np
    import torch
    from repro_torch import faults
    from repro_torch.state.kv import GlobalTier
    from repro_torch.state.local import INT8_WIRE_MIN_BYTES, LocalTier
    n = INT8_WIRE_MIN_BYTES // 4
    gt = GlobalTier(device=device)
    gt.set(CHAOS_KEY, np.zeros(n, np.float32).tobytes(), host="seed")
    p = LocalTier("push0", gt)
    p.pull(CHAOS_KEY)
    p.snapshot_base(CHAOS_KEY)
    _chaos_view(p)[:] += 1.0
    reset_launches()
    with faults.armed(faults.FaultPlan(seed=7).add("codec-error")) as plan:
        moved = p.push_delta(CHAOS_KEY, wire="int8", fence=("cc", 1, 1))
    if device == "cuda":
        torch.cuda.synchronize()
    k1 = read_launches()["state_push.quantize_delta"]
    got = np.frombuffer(gt.get(CHAOS_KEY, host="c"), np.float32)
    _chaos_view(p)[:] += 1.0
    replayed = p.push_delta(CHAOS_KEY, wire="exact", fence=("cc", 1, 1))
    after = np.frombuffer(gt.get(CHAOS_KEY, host="c"), np.float32)
    _chaos_view(p)[:] += 1.0
    p.push_delta(CHAOS_KEY, wire="int8")
    if device == "cuda":
        torch.cuda.synchronize()
    k1_next = read_launches()["state_push.quantize_delta"] - k1
    log(f"  codec fallback: fired {plan.fired('codec-error')}, fallbacks "
        f"{p.codec_fallbacks}, {moved} B on the exact wire, K1 {k1} for the "
        f"failed encode and {k1_next} for the next int8 push; a replayed "
        f"token moved {replayed} B")
    if (plan.fired("codec-error") != 1 or p.codec_fallbacks != 1
            or moved <= 0 or k1 != 0 or k1_next != 1 or replayed != 0
            or not np.array_equal(got, np.ones(n, np.float32))
            or not np.array_equal(after, got)):
        raise AssertionError("codec fallback did not hold")
    return read_launches()


def phase_chaos() -> dict:
    """The chaos suite's scenarios with the tiers and runtime on the card:
    the matrix's storms (seeds 0-2) on the exact wire, one storm on the
    int8 wire at a 4,096-float key (K1, K2), a host killed mid-fan-out and
    the codec-error fallback.  Returns the kernel launches of the phase."""
    t0 = time.perf_counter()
    total = {}
    log(f"chaos: storms {CHAOS_SEEDS} (256 floats, exact wire), one at "
        f"{CHAOS_INT8_NUMEL} floats on the int8 wire, tiers on the card")
    for seed in CHAOS_SEEDS:
        r = chaos_storm(seed)
        _add(total, r["launches"])
        log(f"  storm {seed} (exact): faults fired {r['fired']}; the global "
            f"value the exact sum, every replica equal after a repair pull")
    r = chaos_storm(CHAOS_SEEDS[0], CHAOS_INT8_NUMEL, "int8")
    _add(total, r["launches"])
    log(f"  storm {CHAOS_SEEDS[0]} (int8): faults fired {r['fired']}; "
        f"global max |err| {r['err']:.3e} (bound "
        f"{2 * CHAOS_ITERS * INT8_STEP:.3e}); int8 encodes {r['pushes']} "
        f"pushed + {r['pulls']} pulled, K1 "
        f"{r['launches']['state_push.quantize_delta']}; {r['applied']} int8 "
        f"frames pulled into the device replica, K2 "
        f"{r['launches']['state_push.apply_delta']}; {r['fallbacks']} codec "
        f"fallbacks")
    _add(total, chaos_kill_during_fanout())
    _add(total, chaos_codec_fallback())
    log(f"  chaos phase in {time.perf_counter() - t0:.1f}s; launches "
        f"{ {k: n for k, n in total.items() if n} }")
    return total


def phase_timing_state_push(launches, errs) -> list:
    """K1-K4 at the serve/stats shape (1,187 x 128 f32) and at 16 Mi
    elements: device time (profiler), plain version, bound; then one
    host-side encode of numpy operands beside the host codec."""
    import numpy as np
    import torch
    from repro_torch.kernels.state_push import hostcodec
    from repro_torch.kernels.state_push import ops as sp
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cost = lambda name: sp.cost(name, R)[::-1]          # (bytes, flops)
    rows, sizes = [], ((STATS_NUMEL, ""), (SP_BIG, "[16Mi]"))
    src = "src/repro_torch/kernels/csrc/state_push.cu"
    ref = "src/repro/kernels/state_push/kernel.py:"
    for n, tag in sizes:
        _, _, lr, br = _sp_rows(g, n)
        R = lr.shape[0]
        gr = lr.flip(0).contiguous()
        q, s, _ = sp.quantize_rows(lr, br)
        q8, s8, _ = sp.quantize_rows(lr, br, fp8=True)
        cases = [
            # name, replaces line, kernel, plain, library, bytes, flops
            ("quantize_delta", 60,
             lambda: sp.quantize_rows(lr, br, with_residual=True),
             lambda: sp.quantize_rows(lr, br, with_residual=True,
                                      backend="torch"),
             None, *cost("quantize_delta")),
            ("quantize_fp8", 78,
             lambda: sp.quantize_rows(lr, br, fp8=True, with_residual=True),
             lambda: sp.quantize_rows(lr, br, fp8=True, with_residual=True,
                                      backend="torch"),
             None, *cost("quantize_fp8")),
            ("apply_delta", 96, lambda: sp.apply_rows(gr, q, s),
             lambda: sp.apply_rows(gr, q, s, backend="torch"),
             lambda: torch.addcmul(gr, q, s),
             *cost("apply_delta")),
            ("push", 113, lambda: sp.push_rows(lr, br, gr),
             lambda: sp.push_rows(lr, br, gr, backend="torch"),
             None, *cost("push")),
        ]
        step = float((lr - br).abs().max()) * INT8_STEP
        for name, line, kernel, plain, library, nbytes, flops in cases:
            key = f"state_push.{name}"
            if tag:          # the size sweep: held here, run by no path
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                if name.startswith("quantize"):      # dequantised values
                    errs[key + tag] = check_bound(
                        key + tag, got[0].float() * got[1],
                        want[0].float() * want[1],
                        step if name == "quantize_delta" else 0.0)
                else:
                    errs[key + tag] = check_close(key + tag, got, want,
                                                  TOL["float32"])
            rows.append(_row(
                key + tag, src, ref + str(line),
                {key + tag: launches[key] if not tag else 0}, errs,
                device_ms(kernel), device_ms(plain, iters=5),
                device_ms(library) if library is not None else None,
                nbytes, flops, FP32_FLOP_PER_S))
    log("timing, state push (device time per call from the profiler):")
    for r in rows:
        lib = (f"{r['library_ms'] * 1e3:.2f}us" if r["library_ms"] is not None
               else "none")
        log(f"  {r['name']}: {r['ms'] * 1e3:.2f}us device, bound "
            f"{r['bound_ms'] * 1e3:.2f}us ({r['bound_by']}), plain "
            f"{r['plain_ms'] * 1e3:.2f}us, library {lib}, launches "
            f"{r['launches']}")
    for n, iters in ((STATS_NUMEL, 20), (SP_BIG, 3)):
        rng = np.random.default_rng(n)
        eff, base = (rng.normal(size=n).astype(np.float32) for _ in range(2))
        sp.encode_quant(eff, base, device="cuda")            # warm
        t0 = time.perf_counter()
        for _ in range(iters):
            sp.encode_quant(eff, base, device="cuda")
        t_card = (time.perf_counter() - t0) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            hostcodec.encode_quant(eff, base)
        t_host = (time.perf_counter() - t0) / iters
        log(f"  encode_quant of numpy operands, n {n}: on the card "
            f"{t_card * 1e3:.3f}ms per call (H2D + K1 + D2H), host codec "
            f"{t_host * 1e3:.3f}ms")
    return rows


def _row(name, source, replaces, launches, errs, ms, plain_ms, library_ms,
         nbytes, flops, flop_rate=BF16_FLOP_PER_S) -> dict:
    """One entry of the kernels line.  ``flops`` is a count at
    ``flop_rate``, or a list of (count, rate) terms whose times add."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    terms = flops if isinstance(flops, list) else [(flops, flop_rate)]
    t_ops = sum(n / rate for n, rate in terms) * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


class RoutingRecorder:
    """Wraps ``repro_torch.models.moe.router_topk`` (looked up by
    ``moe_apply`` at each call) to keep every call's top-k expert ids, in
    slot order, in call order.  With ``force`` (another run's recorded
    ids), each call routes to the forced ids instead, with gates taken
    from its own router probabilities at those ids and renormalised as
    ``router_topk`` does; its own choice is still recorded."""

    def __init__(self, force=None):
        self.calls, self.force = [], force

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._orig = moe.router_topk

        def wrapped(p, cfg, x2d):
            gates, idx, aux = self._orig(p, cfg, x2d)
            self.calls.append(idx)
            if self.force is None:
                return gates, idx, aux
            idx = self.force[len(self.calls) - 1]
            probs = torch.softmax(x2d.float() @ p.router, dim=-1)
            gates = probs.gather(1, idx.long())
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
            return gates, idx, aux

        moe.router_topk = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.router_topk = self._orig


def phase_moe_serve() -> tuple:
    import torch
    from repro_torch.launch import serve
    log(f"moe serve: {MOE_ARCH} full width, bf16, batch {BATCH}, prompt "
        f"{PROMPT}, {NEW_TOKENS} new tokens")
    reset_launches()
    res = serve.main(["--arch", MOE_ARCH, "--batch", str(BATCH),
                      "--prompt-len", str(PROMPT), "--new-tokens",
                      str(NEW_TOKENS), "--device", "cuda", "--seed",
                      str(SEED)], keep_logits=True)
    cfg = res["cfg"]
    n_moe = cfg.n_layers - cfg.first_k_dense
    want = {k: 0 for k in launch_counters()}
    want.update({"flash_attention": cfg.n_layers,
                 "decode_attention": cfg.n_layers * (NEW_TOKENS - 1),
                 "moe_gmm": 3 * n_moe * (NEW_TOKENS - 1)})
    launches = split_launches(res, want, warmup_launches(
        want, {"flash_attention": cfg.n_layers}))
    # K7 by shape, as its wrapper counted them: each decode step's gate and
    # up projections (d, f) and its down projection (f, d) in every layer;
    # the loop's are the counter's less the warm-up's one decode step
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    d, f = cfg.d_model, cfg.moe_d_ff
    warm = res["graphs"].warmup_launches.by_key(gmm_ops.LAUNCHES)
    by_shape = {k: n - warm.get(k, 0)
                for k, n in gmm_ops.LAUNCHES.by_key().items()}
    want_shape = {(d, f): 2 * n_moe * (NEW_TOKENS - 1),
                  (f, d): n_moe * (NEW_TOKENS - 1)}
    log(f"  K7 launches by (d, f) of the loop {by_shape} (expected "
        f"{want_shape}); of the warm-up {warm}")
    if warm != {(d, f): 2 * n_moe, (f, d): n_moe}:
        raise AssertionError(f"K7 warm-up launches by shape {warm}")
    if by_shape != want_shape:
        raise AssertionError(f"K7 launches by shape {by_shape}, expected "
                             f"{want_shape}")
    # the kernels line's K7 rows are by shape
    launches["moe_gmm"] = by_shape[(d, f)]
    launches["moe_gmm[down]"] = by_shape[(f, d)]
    gen, logits = res["gen"], res["logits"]
    if tuple(gen.shape) != (BATCH, NEW_TOKENS) or len(logits) != NEW_TOKENS:
        raise AssertionError(f"generated {tuple(gen.shape)}, "
                             f"{len(logits)} logits")
    for i, lg in enumerate(logits):
        if tuple(lg.shape) != (BATCH, cfg.vocab_size) or \
                not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"step {i}: bad logits {tuple(lg.shape)}")
    if not bool(((gen >= 0) & (gen < cfg.vocab_size)).all()):
        raise AssertionError("generated ids out of the vocabulary")
    params = res["params"]
    n_params = sum(p.numel() for p in params.parameters())
    if abs(n_params / 16.4e9 - 1) > 0.03 or \
            params.layers[0].moe.w_gate.dtype != torch.bfloat16:
        raise AssertionError(f"{n_params} parameters, expected 16.4 B bf16")
    log(f"  {n_params / 1e9:.3f}B parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB on the card); "
        f"prefill {res['prefill_s'] * 1e3:.2f}ms, decode "
        f"{res['decode_s'] * 1e3:.2f}ms (first run: "
        f"{BATCH * (NEW_TOKENS - 1) / res['decode_s']:.1f} tok/s)")
    return res, launches


def cache_len(cfg) -> int:
    """The serving cache's positions: a VLM's patch embeddings, the
    prompt and the new tokens."""
    from repro_torch.models import build_model
    return build_model(cfg).prefix_len + PROMPT + NEW_TOKENS


def _teacher_run(res, model, force=None) -> tuple:
    """``model``'s prefill and decode on the main-path run's prompt (and
    extra input) and generated tokens (teacher forcing): (logits per step,
    router calls)."""
    import torch
    params, tokens, gen = res["params"], res["tokens"], res["gen"]
    cache = model.init_cache(BATCH, cache_len(model.cfg), "cuda")
    with torch.no_grad(), RoutingRecorder(force) as rec:
        lg, cache, n = model.prefill(params, tokens, cache, res.get("extra"))
        out = [lg]
        for i in range(NEW_TOKENS - 1):
            idx = torch.full((BATCH,), n + i, dtype=torch.int32, device="cuda")
            lg, cache = model.decode_step(params, gen[:, i], cache, idx)
            out.append(lg)
    torch.cuda.synchronize()
    return out, rec.calls


def _sublayer_run(res) -> dict:
    """The kernel path once more on the main-path run's prompt and tokens,
    with every attention, FFN and Mamba2 prefill sublayer call repeated on
    the plain path on the same input (and a copy of the cache it reads):
    both see the same activations, so the router picks the same experts
    and only the kernels' rounding separates them.  (A Mamba2 decode step,
    ``mamba_step``, runs no kernel: both paths run the same code.)  The
    encoder/decoder's sublayers with a kernel are its encoder's attention,
    its decoder's self-attention in the prefill and decode and its
    cross-attention in both (K5 and K6); its MLP runs no kernel.
    Returns {sublayer: (calls, max |diff|, largest excess over
    TOL["bfloat16"] abs + rel)} and the run's logits per step."""
    from repro_torch.models import encdec, ssm_stack
    from repro_torch.models import transformer as tr
    tol, stats = TOL["bfloat16"], {}
    patched = [(tr, n) for n in ("attn_apply_prefill", "attn_apply_decode",
                                 "_ffn")] + \
        [(encdec, n) for n in ("attn_apply_full", "attn_apply_prefill",
                               "attn_apply_decode", "cross_attn_apply",
                               "cross_attn_decode")] + \
        [(ssm_stack, "mamba_apply_full")]
    orig = {(m, n): getattr(m, n) for m, n in patched}
    plain_ec = lambda ec: ec.with_overrides(backend="torch")

    def hold(kind, got, want):
        d = (got.float() - want.float()).abs()
        n, err, exc = stats.get(kind, (0, 0.0, -1.0))
        stats[kind] = (n + 1, max(err, float(d.max())), max(exc, float(
            (d - tol * (1 + want.float().abs())).max())))

    def attn(mod, name, kind):
        fn = orig[(mod, name)]

        def wrapped(p, cfg, ec, x, ck, cv, *args, **kw):
            ck0, cv0 = ck.clone(), cv.clone()
            out = fn(p, cfg, ec, x, ck, cv, *args, **kw)
            plain = fn(p, cfg, plain_ec(ec), x, ck0, cv0, *args, **kw)
            hold(kind, out[0], plain[0])
            return out
        return wrapped

    def same_input(mod, name, kind):
        fn = orig[(mod, name)]

        def wrapped(p, cfg, ec, *args, **kw):
            out = fn(p, cfg, ec, *args, **kw)
            hold(kind, out, fn(p, cfg, plain_ec(ec), *args, **kw))
            return out
        return wrapped

    def ffn(lp, cfg, ec, h):
        out = orig[(tr, "_ffn")](lp, cfg, ec, h)
        kind = ("moe" if isinstance(lp, tr.MoEBlock) else "dense mlp") + \
            (" decode" if h.shape[1] == 1 else " prefill")
        hold(kind, out[0], orig[(tr, "_ffn")](lp, cfg, plain_ec(ec), h)[0])
        return out

    def mamba(p, cfg, ec, x, **kw):
        fn = orig[(ssm_stack, "mamba_apply_full")]
        out = fn(p, cfg, ec, x, **kw)
        plain = fn(p, cfg, plain_ec(ec), x, **kw)
        if kw.get("return_state"):          # (y, (conv tail, SSD state))
            hold("mamba prefill", out[0], plain[0])
            hold("mamba prefill state", out[1][1], plain[1][1])
        else:
            hold("mamba prefill", out, plain)
        return out

    tr.attn_apply_prefill = attn(tr, "attn_apply_prefill",
                                 "attn_apply_prefill")
    tr.attn_apply_decode = attn(tr, "attn_apply_decode", "attn_apply_decode")
    tr._ffn = ffn
    encdec.attn_apply_full = same_input(encdec, "attn_apply_full",
                                        "encoder attention")
    encdec.attn_apply_prefill = attn(encdec, "attn_apply_prefill",
                                     "decoder self-attention prefill")
    encdec.attn_apply_decode = attn(encdec, "attn_apply_decode",
                                    "decoder self-attention decode")
    encdec.cross_attn_apply = same_input(encdec, "cross_attn_apply",
                                         "cross-attention prefill")
    encdec.cross_attn_decode = same_input(encdec, "cross_attn_decode",
                                          "cross-attention decode")
    ssm_stack.mamba_apply_full = mamba
    try:
        logits, _ = _teacher_run(res, res["model"])
    finally:
        for (m, n), fn in orig.items():
            setattr(m, n, fn)
    return stats, logits


def _flips(a_calls, b_calls, n_moe: int):
    """Per router call, which tokens got another top-k set; and the share
    of (token, layer) sets that differ in each MoE layer of the prefill."""
    import torch
    if len(a_calls) != len(b_calls) or len(a_calls) != n_moe * NEW_TOKENS:
        raise AssertionError(f"{len(a_calls)} and {len(b_calls)} router "
                             f"calls, expected {n_moe * NEW_TOKENS}")
    flips = [(a.sort(-1).values != b.sort(-1).values).any(-1)
             for a, b in zip(a_calls, b_calls)]
    share = sum(int(f.sum()) for f in flips) / sum(f.numel() for f in flips)
    per_layer = [float(f.float().mean()) for f in flips[:n_moe]]
    return flips, share, per_layer


def _any_flip(flips, shape):
    """Any flip over the layers of one step's router calls, as a (BATCH,
    ...) mask."""
    import torch
    return torch.stack(flips).reshape(shape).any(0)


def _held(got_steps, want_steps, gen, rows=None) -> tuple:
    """(max |dlogit| over the held rows, excess over LOGIT_TOL, argmax
    agreement over all rows); ``rows[i]`` picks the held rows of step i."""
    worst, excess, agree = 0.0, -1.0, 0
    for i, (got, want) in enumerate(zip(got_steps, want_steps)):
        ok = slice(None) if rows is None else rows[i]
        d = (got[ok] - want[ok]).abs()
        if d.numel():
            worst = max(worst, float(d.max()))
            excess = max(excess, float(
                (d - LOGIT_TOL * (1 + want[ok].abs())).max()))
        agree += int((want.argmax(-1) == gen[:, i].long()).sum())
    return worst, excess, agree / (BATCH * NEW_TOKENS)


def phase_moe_reference(res, kernel_routes) -> None:
    """The kernel path against the plain path, three ways.

    * Free-running (teacher-forced tokens): the plain router picks its own
      experts.  A near-tie that rounds the other way sends a token to
      another expert, which moves its hidden state by a gate times an
      expert difference; its later layers then route apart too, and
      attention carries the change to every later token.  Reported, not
      held (one bf16 ulp decides it): the share of (token, layer) sets
      routed apart, by layer, the logits of the rows whose own token was
      routed alike in every layer, and the argmax agreement.
    * Routing forced to the kernel path's expert ids (its own gates at
      those ids): no routing flip, but the kernels' rounding still grows
      through 28 layers.  Held: the argmax on MIN_ARGMAX_AGREEMENT of all
      rows; reported: the logits.
    * Sublayer by sublayer: every attention and FFN call of a kernel-path
      run repeated on the plain path on the same input.  Held: every
      output within TOL["bfloat16"] (the kernels' own bf16 tolerance).
    """
    import torch
    from repro_torch.models import ExecConfig, build_model
    cfg, gen = res["cfg"], res["gen"]
    n_moe = cfg.n_layers - cfg.first_k_dense
    total = BATCH * NEW_TOKENS
    plain = build_model(cfg, ExecConfig(backend="torch"))

    free_logits, free_routes = _teacher_run(res, plain)
    flips, share, per_layer = _flips(kernel_routes, free_routes, n_moe)
    # the logits row of step 0 is the prefill's last prompt token, of step
    # i + 1 decode step i's token
    own = [_any_flip(flips[:n_moe], (n_moe, BATCH, PROMPT))[:, -1]]
    own += [_any_flip(flips[n_moe * (i + 1):n_moe * (i + 2)], (n_moe, BATCH))
            for i in range(NEW_TOKENS - 1)]
    alike = [~f for f in own]
    n_alike = sum(int(a.sum()) for a in alike)
    worst, excess, free_agree = _held(res["logits"], free_logits, gen, alike)
    log(f"moe reference, free-running: routing differs in {share:.5f} of "
        f"the (token, layer) sets (prefill, by MoE layer: first "
        f"{per_layer[0]:.4f}, middle {per_layer[n_moe // 2]:.4f}, last "
        f"{per_layer[-1]:.4f}); {n_alike} of {total} rows' own token routed "
        f"alike in every layer, their max |dlogit| {worst:.4f} "
        f"({'within' if excess <= 0 else 'outside'} {LOGIT_TOL} abs + rel); "
        f"argmax agreement {free_agree:.3f}")
    del free_logits

    forced_logits, own_routes = _teacher_run(res, plain, force=kernel_routes)
    _, ties, _ = _flips(kernel_routes, own_routes, n_moe)
    worst, excess, agree = _held(res["logits"], forced_logits, gen)
    steps = [float((g - w).abs().max())
             for g, w in zip(res["logits"], forced_logits)]
    within = sum(int(((g - w).abs() <= LOGIT_TOL * (1 + w.abs())).all(-1).sum())
                 for g, w in zip(res["logits"], forced_logits))
    log(f"moe reference, routing forced to the kernel path's experts: the "
        f"plain router's own top-{cfg.experts_per_token} differs in "
        f"{ties:.5f} of the sets (near-ties under rounding); max |dlogit| "
        f"{worst:.4f} (prefill row {steps[0]:.4f}, decode rows up to "
        f"{max(steps[1:]):.4f}; max |logit| "
        f"{max(float(w.abs().max()) for w in forced_logits):.3f}); "
        f"{within} of {total} rows within {LOGIT_TOL} abs + rel; argmax "
        f"agreement {agree:.3f}")
    del forced_logits

    stats, rerun = _sublayer_run(res)
    again = max(float((a - b).abs().max()) for a, b in zip(rerun, res["logits"]))
    log(f"moe reference, the kernel path run again on the same tokens: max "
        f"|dlogit| {again:.3e} against the main-path run (0: deterministic); "
        f"sublayer by sublayer (same input on both paths; tol "
        f"{TOL['bfloat16']} abs + rel):")
    for kind, (n, err, exc) in stats.items():
        log(f"  {kind}: {n} calls, max |diff| {err:.3e} "
            f"{'ok' if exc <= 0 else 'FAIL'}")
    bad = [k for k, (_, _, exc) in stats.items() if exc > 0]
    if bad:
        raise AssertionError(f"sublayers outside tolerance: {bad}")
    if agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"routing-forced argmax agreement {agree:.3f} "
                             f"< {MIN_ARGMAX_AGREEMENT}")


def _grouped_mm(x, ws, gs):
    """One PyTorch call computing K7's function, where this PyTorch has it:
    ``torch.nn.functional.grouped_mm`` with the group ends as offsets, on
    the weight tensors ``ws`` in turn."""
    import itertools
    import torch
    import torch.nn.functional as F
    if not hasattr(F, "grouped_mm"):
        return None
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    nxt = itertools.cycle(ws).__next__
    return lambda: F.grouped_mm(x, nxt(), offs=offs)


def _gmm_row(name, x, ws, gs, launches, errs) -> dict:
    """K7's kernels-line row at one shape: device time (profiler), plain
    version, ``grouped_mm`` and the bound for this call's active experts.
    Each call takes the next of the weight tensors ``ws`` in turn, as the
    layers of a decode step do, so that no call finds the last one's
    weights in the 50 MB L2: at decode one call streams ~115 MB."""
    import itertools
    from repro_torch.kernels.moe_gmm import gmm, gmm_ref
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    T, d = x.shape
    E, f = ws[0].shape[0], ws[0].shape[2]
    active = int((gs > 0).sum())
    flops, nbytes = gmm_ops.cost(T, d, f, E, 2, active)
    nxt = itertools.cycle(ws).__next__
    kernel = lambda: gmm(x, nxt(), gs)
    library = _grouped_mm(x, ws, gs)
    lib_ms = None
    if library is not None:
        try:
            lib_ms = device_ms(library)
        except (RuntimeError, TypeError, ValueError) as exc:  # yardstick
            log(f"  grouped_mm refused these operands: {exc}")
    row = _row(name, "src/repro_torch/kernels/csrc/moe_gmm.cu",
               "src/repro/kernels/moe_gmm/kernel.py:37", {name: launches},
               errs, device_ms(kernel),
               device_ms(lambda: gmm_ref(x, nxt(), gs), iters=5), lib_ms,
               nbytes, flops)
    lib = (f"{lib_ms * 1e3:.1f}us (grouped_mm)" if lib_ms is not None
           else "none")
    log(f"  {name}: T {T} d {d} f {f}, {active} experts "
        f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP), "
        f"{len(ws)} weight tensors in turn: {row['ms'] * 1e3:.1f}us device, "
        f"{queued_ms(kernel)[0] * 1e3:.1f}us queued (CUDA events), "
        f"back-to-back {call_ms(kernel) * 1e3:.1f}us, bound "
        f"{row['bound_ms'] * 1e3:.1f}us ({row['bound_by']}), plain "
        f"{row['plain_ms'] * 1e3:.1f}us, library {lib}, launches "
        f"{row['launches']}")
    return row


def phase_timing_gmm(res, launches, errs) -> list:
    """K7 at the decode step's two shapes (24 rows against the real gate/up
    and down weights of every MoE layer, in turn) and at the sorted-prefill
    shape (12,288 rows over all 64 experts of every layer's gate weights)."""
    import torch
    cfg, layers = res["cfg"], [blk.moe for blk in res["params"].layers]
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    T_dec = BATCH * cfg.experts_per_token
    gate_up = [w for m in layers for w in (m.w_gate, m.w_up)]
    down = [m.w_down for m in layers]
    log("timing, K7 (device time per call from the profiler):")
    rows = []
    for name, T, ws, n in (
            ("moe_gmm", T_dec, gate_up, launches["moe_gmm"]),
            ("moe_gmm[down]", T_dec, down, launches["moe_gmm[down]"]),
            ("moe_gmm[prefill]", BATCH * PROMPT * cfg.experts_per_token,
             [m.w_gate for m in layers], 0)):
        gs = _gmm_sizes(g, "draws", T, cfg.n_experts)  # 12,288 rows: all 64
        x = torch.randn(T, ws[0].shape[1], generator=g, device="cuda").to(
            torch.bfloat16)
        rows.append(_gmm_row(name, x, ws, gs, n, errs))
    return rows


GMM_SHAPES = [   # deepseek-moe-16b: name, T, d, f
    ("moe_gmm", 24, 2048, 1408),                # decode gate/up
    ("moe_gmm[down]", 24, 1408, 2048),          # decode down
    ("moe_gmm[prefill]", 12_288, 2048, 1408),   # sorted prefill
]
GMM_SWEEP = (64, 128, 192, 256, 384, 512, 1024, 2048, 4096)   # T
GMM_TURNS = 4        # weight tensors per shape in the gmm mode (369 MB each)


def _host_us(fn, iters: int = 200) -> float:
    """Host time per call of ``fn``'s launches, without a sync between
    them (the card's queue takes them all): the wrapper's own cost."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return host / iters * 1e6


def phase_gmm_ab(errs) -> None:
    """K7 alone: the wrapper's choice at the three shapes as in the full
    run (weights drawn at model scale, 64 x d x f in bf16, four tensors per
    shape taken in turn, so the 33 GB model is never drawn and no call
    finds its weights in L2), then each bf16 kernel forced at those shapes
    (held against the plain version) and at a sweep of T at the gate
    shape, for the threshold between the regimes, with the host time per
    call of each."""
    import itertools
    import torch
    from repro_torch.kernels.moe_gmm import gmm_ref
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    tol = GMM_TOL["bfloat16"]
    weights = {}

    def weight(d, f):
        if (d, f) not in weights:
            weights[(d, f)] = [
                torch.randn(64, d, f, generator=g, device="cuda",
                            dtype=torch.bfloat16) * d ** -0.5
                for _ in range(GMM_TURNS)]
        return weights[(d, f)]

    def forced(x, ws, gs, what):
        """Each kernel forced on these operands: held, then timed."""
        out = []
        for regime in gmm_ops.REGIMES:
            if regime == "tc" and x.shape[0] < gmm_ops.TC_BOX:
                continue
            check_close(f"K7 {regime} {what}",
                        gmm_ops._gmm_cuda(x, ws[0], gs, regime),
                        gmm_ref(x, ws[0], gs), tol)
            nxt = itertools.cycle(ws).__next__
            run = lambda: gmm_ops._gmm_cuda(x, nxt(), gs, regime)
            out.append(f"{regime} {device_ms(run) * 1e3:.1f}us "
                       f"(host {_host_us(run):.1f}us/call)")
        log(f"  forced, {what}: {', '.join(out)}")

    log("timing, K7 alone (device time per call from the profiler):")
    for name, T, d, f in GMM_SHAPES:
        ws = weight(d, f)
        gs = _gmm_sizes(g, "draws", T)
        x = torch.randn(T, d, generator=g, device="cuda").to(torch.bfloat16)
        _gmm_row(name, x, ws, gs, 0, errs)
        forced(x, ws, gs, name)
    for T in GMM_SWEEP:
        gs = _gmm_sizes(g, "draws", T)
        x = torch.randn(T, 2048, generator=g, device="cuda").to(torch.bfloat16)
        log(f"  T {T}: the wrapper's plan {gmm_ops.plan(T, 2048, 1408, 64)}")
        forced(x, weight(2048, 1408), gs, f"T {T} d 2048 f 1408")


def _serve_once(model, params, tokens, decode_ctx=contextlib.nullcontext,
                prefill_ctx=contextlib.nullcontext, kept=None,
                extra=None, ctx_steps: int = NEW_TOKENS - 1) -> tuple:
    """Prefill + greedy decode of the kernel path, op by op from Python
    (the eager loop): (prefill s, s of the last ``ctx_steps`` decode
    steps, s of all decode steps); ``prefill_ctx`` wraps the prefill and
    ``decode_ctx`` those decode steps (a profiler); a list ``kept``
    receives every step's logits; ``extra`` is the family's extra
    input."""
    import torch
    with torch.no_grad(), contextlib.ExitStack() as stack:
        cache = model.init_cache(BATCH, cache_len(model.cfg), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prefill_ctx():
            lg, cache, n = model.prefill(params, tokens, cache, extra)
            tok = lg.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(NEW_TOKENS - 1):
            if i == NEW_TOKENS - 1 - ctx_steps:
                torch.cuda.synchronize()
                stack.enter_context(decode_ctx())
                t2 = time.perf_counter()
            if kept is not None:
                kept.append(lg)
            idx = torch.full((BATCH,), n + i, dtype=torch.int32, device="cuda")
            lg, cache = model.decode_step(params, tok, cache, idx)
            tok = lg.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if kept is not None:
            kept.append(lg)
        return t1 - t0, t3 - t2, t3 - t1


def _serve_graphed(graphs, tokens, decode_ctx=contextlib.nullcontext,
                   prefill_ctx=contextlib.nullcontext,
                   ctx_steps: int = NEW_TOKENS - 1) -> tuple:
    """The launcher's graphs replayed as ``_serve_once`` runs the eager
    loop (the same contexts and steps, no copy of a step's token):
    (prefill s, s of the last ``ctx_steps`` decode steps, s of all decode
    steps)."""
    import torch
    with torch.no_grad(), contextlib.ExitStack() as stack:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prefill_ctx():
            graphs.prefill(tokens)
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(NEW_TOKENS - 1):
            if i == NEW_TOKENS - 1 - ctx_steps:
                torch.cuda.synchronize()
                stack.enter_context(decode_ctx())
                t2 = time.perf_counter()
            graphs.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return t1 - t0, t3 - t2, t3 - t1


def replay_host_ms(graphs, tokens) -> tuple:
    """One graphed decode loop with the host's side timed apart: (ms the
    host takes to queue one decode replay, wall ms per decode step).
    Where the first nears the second, the host bounds the loop."""
    import torch
    with torch.no_grad():
        graphs.prefill(tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(NEW_TOKENS - 1):
            graphs.step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return ((t1 - t0) * 1e3 / (NEW_TOKENS - 1),
            (t2 - t0) * 1e3 / (NEW_TOKENS - 1))


def phase_graph_hold(res, record_routes: bool = False):
    """The launcher's graphed loop (``serve.main``'s run) against the eager
    loop (``_serve_once``) on the same weights and prompt: the generated
    ids and every step's logits bitwise equal, since both run the same
    kernels in the same order.  With ``record_routes``, returns the eager
    run's router calls (their expert ids), which are therefore the graphed
    run's: a replay runs no Python, so its routing is read off its eager
    twin."""
    import torch
    kept = []
    with RoutingRecorder() if record_routes else contextlib.nullcontext() \
            as rec:
        _serve_once(res["model"], res["params"], res["tokens"], kept=kept,
                    extra=res.get("extra"))
    ids = torch.stack([lg.argmax(-1).to(torch.int32) for lg in kept], 1)
    same_ids = torch.equal(ids, res["gen"])
    diff = max(float((a - b).abs().max())
               for a, b in zip(res["logits"], kept))
    same = [torch.equal(a, b) for a, b in zip(res["logits"], kept)]
    log(f"graphs {res['cfg'].name}: the graphed loop against the eager loop "
        f"on the same prompt: ids {'equal' if same_ids else 'DIFFER'}, "
        f"logits bitwise equal at {sum(same)} of {len(kept)} steps (max "
        f"|dlogit| {diff:.3e}); capture {res['capture_s'] * 1e3:.1f}ms")
    if not same_ids or len(same) != NEW_TOKENS or not all(same):
        raise AssertionError("the graphed loop differs from the eager loop")
    return rec.calls if record_routes else None


def _busy(prof) -> tuple:
    """(device ms, kernels, events) in a profiler trace."""
    events = device_events(prof)
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        raise RuntimeError("the profiler saw no device time")
    return busy_us / 1e3, sum(e.count for e in events), events


def phase_warm_serve(res) -> None:
    """Warm prefill and decode-loop times on the weights and prompt of the
    main-path run, of the eager loop (``_serve_once``) and of the
    launcher's graphs (``_serve_graphed``), both on the host's clock,
    ``WARM_RUNS`` each, then one run of each under torch.profiler for the
    device's busy share and the ops that hold it.  The profiler covers the loop's last
    ``PROFILE_STEPS`` decode steps alone (reading a trace of all 31 steps
    took 10-20 s a model; no warm prefill is profiled), beside the
    unprofiled runs' wall of the same steps (``WARM_RUNS`` more for the
    graphed loop).  The graphed profile replays the graphs as
    ``_serve_once`` runs the eager loop; it must hold one record for each
    node of the graphs it replays (counted by libcuda's
    ``cuGraphGetNodes`` on graphs of the same steps), or its trace is not
    whole and the graphed busy share is the eager profile's device ms
    over the graphed wall, logged so beside the graphed trace's own."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    model, params, tokens = res["model"], res["params"], res["tokens"]
    graphs, name, extra = res["graphs"], res["cfg"].name, res.get("extra")
    steps = NEW_TOKENS - 1
    k = PROFILE_STEPS                             # decode steps profiled
    runs = [_serve_once(model, params, tokens, extra=extra, ctx_steps=k)
            for _ in range(WARM_RUNS)]
    g_runs = [_serve_graphed(graphs, tokens) for _ in range(WARM_RUNS)]
    rate = lambda r: BATCH * steps / r[-1]        # the whole decode loop
    host = [replay_host_ms(graphs, tokens) for _ in range(2)]
    log(f"warm serve {name} ({WARM_RUNS} runs each), eager | graphed: "
        f"prefill ms "
        f"{[r[0] * 1e3 for r in runs]} | {[r[0] * 1e3 for r in g_runs]}, "
        f"decode tok/s {[rate(r) for r in runs]} | "
        f"{[rate(r) for r in g_runs]}; capture {res['capture_s'] * 1e3:.1f}ms"
        f"; host ms to queue a decode replay {[round(h[0], 4) for h in host]}"
        f" of {[round(h[1], 4) for h in host]} ms per step")
    out = {}
    for loop, serve_fn, warm_runs in (
            ("eager", lambda **kw: _serve_once(model, params, tokens,
                                               extra=extra, **kw), runs),
            ("graphed", lambda **kw: _serve_graphed(graphs, tokens, **kw),
             None)):
        if warm_runs is None:             # the graphed wall of the same k
            warm_runs = [serve_fn(ctx_steps=k) for _ in range(WARM_RUNS)]
        prof = profile(activities=[ProfilerActivity.CUDA])
        wall = serve_fn(decode_ctx=lambda: prof, ctx_steps=k)[1]
        busy_ms, n_kernels, events = _busy(prof)
        warm_wall = min(r[1] for r in warm_runs)
        out[loop] = (busy_ms, n_kernels, warm_wall, events)
        log(f"profile {name} {loop} (the last {k} of {steps} decode steps): "
            f"device busy {busy_ms:.1f}ms in {n_kernels} kernels "
            f"({n_kernels / k:.0f} per decode step); "
            f"{100 * busy_ms / 1e3 / warm_wall:.1f}% of the fastest "
            f"unprofiled run's {warm_wall * 1e3:.1f}ms wall (the same steps) "
            f"({wall * 1e3:.1f}ms under the profiler)")
        for e in sorted(events, key=lambda e: e.self_device_time_total,
                        reverse=True)[:8]:
            log(f"  {e.self_device_time_total / 1e3:8.2f}ms  {e.count:6d}x  "
                f"{e.key[:90]}")
    # what the replays queued, read off graphs of the same steps through
    # libcuda: a whole trace holds one record for each of their nodes
    with torch.no_grad():
        graphs.prefill(tokens)        # a position the decode step may write
        nodes = k * len(graph_node_types(graphs._decode_body))
    whole = out["graphed"][1] == nodes
    busy = out["graphed"][0] if whole else out["eager"][0]
    odd = {e.key[:50]: e.count for e in out["graphed"][3] if e.count % k}
    log(f"busy share {name}: eager "
        f"{100 * out['eager'][0] / 1e3 / out['eager'][2]:.1f}%, graphed "
        f"{100 * busy / 1e3 / out['graphed'][2]:.1f}% ("
        + ("a whole trace of the replays" if whole else
           "the replays' trace is not whole, so the eager profile's device "
           "ms over the graphed wall; the graphed trace's own: "
           f"{100 * out['graphed'][0] / 1e3 / out['graphed'][2]:.1f}%")
        + f"): {out['graphed'][1]} records against the graphs' {nodes} "
        f"nodes ({nodes / k} per step), the eager loop's "
        f"{out['eager'][1]}; records not a multiple of the steps: {odd}")


def phase_ssm_serve(arch: str) -> tuple:
    """The launcher's main path on an SSM config at full width, counters
    zeroed just before: K8 once per Mamba layer in the prefill; the
    hybrid's shared block adds K5 once per application in the prefill
    and K6 once per application and decode step."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models.ssm_stack import n_attn_apps
    log(f"ssm serve: {arch} full width, bf16, batch {BATCH}, prompt "
        f"{PROMPT}, {NEW_TOKENS} new tokens")
    reset_launches()
    res = serve.main(["--arch", arch, "--batch", str(BATCH), "--prompt-len",
                      str(PROMPT), "--new-tokens", str(NEW_TOKENS),
                      "--device", "cuda", "--seed", str(SEED)],
                     keep_logits=True)
    cfg = res["cfg"]
    apps = n_attn_apps(cfg)
    want = {k: 0 for k in launch_counters()}
    want.update({"ssd_scan": cfg.n_layers, "flash_attention": apps,
                 "decode_attention": apps * (NEW_TOKENS - 1)})
    launches = split_launches(res, want, warmup_launches(
        want, {"ssd_scan": cfg.n_layers, "flash_attention": apps}))
    gen, logits = res["gen"], res["logits"]
    if tuple(gen.shape) != (BATCH, NEW_TOKENS) or len(logits) != NEW_TOKENS:
        raise AssertionError(f"generated {tuple(gen.shape)}, "
                             f"{len(logits)} logits")
    for i, lg in enumerate(logits):
        if tuple(lg.shape) != (BATCH, cfg.vocab_size) or \
                not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"step {i}: bad logits {tuple(lg.shape)}")
    if not bool(((gen >= 0) & (gen < cfg.vocab_size)).all()):
        raise AssertionError("generated ids out of the vocabulary")
    params = res["params"]
    n_params = sum(p.numel() for p in params.parameters())
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    if n_params != cfg.param_count() + cfg.n_layers * (conv_ch + cfg.ssm_nheads) \
            or params.layers[0].mamba.w_in.dtype != torch.bfloat16 \
            or params.layers[0].mamba.A_log.dtype != torch.float32:
        raise AssertionError(f"{n_params} parameters, or wrong dtypes")
    log(f"  {n_params / 1e6:.1f}M parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB on the card); "
        f"prefill {res['prefill_s'] * 1e3:.2f}ms, decode "
        f"{res['decode_s'] * 1e3:.2f}ms (first run: "
        f"{BATCH * (NEW_TOKENS - 1) / res['decode_s']:.1f} tok/s)")
    return res, launches


def phase_ssm_witnesses(res, plain_logits) -> None:
    """Two more witnesses for an SSM model's reference phase, both on the
    main-path run's prompt and tokens (teacher forcing).  (1) Two correct
    plain paths in bf16: the plain path once more with the sequential
    oracle ``ssd_ref`` in place of the chunked scan, against the plain
    path; how far apart they land (reported) is what bf16 rounding in
    another summation order alone carries to the logits through this
    model's blocks.  (2) The model with its bf16 weights widened to f32:
    the kernel path against the plain path, held within LOGIT_TOL abs +
    rel, where a kernel that computed another function would stand out;
    and the bf16 kernel path held no farther from the f32 plain path than
    the bf16 plain path is, plus LOGIT_TOL."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    from repro_torch.models import ExecConfig, build_model
    cfg = res["cfg"]
    plain_ec = ExecConfig(backend="torch")
    chunked = ssd_ops.ssd_chunked
    ssd_ops.ssd_chunked = lambda x, dt, A, B, C, D, st, chunk: ssd_ref(
        x, dt, A, B, C, D, initial_state=st)
    try:
        oracle, _ = _teacher_run(res, build_model(cfg, plain_ec))
    finally:
        ssd_ops.ssd_chunked = chunked
    gap = max(float((a - b).abs().max()) for a, b in zip(oracle, plain_logits))
    log(f"  witness 1, two plain paths in bf16 (SSD by the sequential oracle "
        f"vs the chunked scan): max |dlogit| {gap:.4f}, argmax agreement "
        f"{_agree(oracle, plain_logits):.3f} (reported)")
    phase_f32_witness(res, plain_logits, "witness 2, ")


def phase_f32_witness(res, plain_logits, label: str = "") -> None:
    """The model with its bf16 weights widened to f32, on the main-path
    run's prompt and tokens (teacher forcing): the kernel path against the
    plain path, held within LOGIT_TOL abs + rel, where a kernel that
    computed another function would stand out; and the bf16 kernel path
    held no farther from the f32 plain path than the bf16 plain path
    (``plain_logits``) is, plus LOGIT_TOL."""
    import dataclasses
    import torch
    from repro_torch.models import ExecConfig, build_model
    from repro_torch.models.weights import params_class
    cfg, gen = res["cfg"], res["gen"]
    plain_ec = ExecConfig(backend="torch")
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = params_class(cfg32)(cfg32, device="cuda")
    with torch.no_grad():
        for p32, p in zip(params32.parameters(), res["params"].parameters()):
            p32.copy_(p)
    res32 = dict(res, params=params32)
    kernel32, _ = _teacher_run(res32, build_model(cfg32, res["model"].ec))
    plain32, _ = _teacher_run(res32, build_model(cfg32, plain_ec))
    worst, excess, _ = _held(kernel32, plain32, gen)
    to32 = [max(float((a - b).abs().max()) for a, b in zip(run, plain32))
            for run in (res["logits"], plain_logits)]
    log(f"  {label}weights widened to f32: kernel path vs plain path max "
        f"|dlogit| {worst:.3e} (held within {LOGIT_TOL} abs + rel), argmax "
        f"agreement {_agree(kernel32, plain32):.3f}; against the f32 plain "
        f"path the bf16 kernel path lands {to32[0]:.4f} away, the bf16 plain "
        f"path {to32[1]:.4f} (held: at most {LOGIT_TOL} farther)")
    del params32, res32
    if excess > 0:
        raise AssertionError(f"f32 logits outside tolerance by {excess:.4f}")
    if to32[0] > to32[1] + LOGIT_TOL:
        raise AssertionError(f"the bf16 kernel path lands {to32[0]:.4f} from "
                             f"the f32 logits, the plain path {to32[1]:.4f}")


def _agree(a_steps, b_steps) -> float:
    """The share of rows whose argmax two runs' logits per step agree on."""
    n = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
            for a, b in zip(a_steps, b_steps))
    return n / sum(a.shape[0] for a in a_steps)


def phase_sublayers(res) -> None:
    """Sublayer by sublayer on an SSM or dense model: every Mamba2 prefill,
    attention and MLP call of a kernel-path run repeated on the plain path
    on the same input, each output held within the bf16 kernel tolerance.
    zamba2-1.2b's logits are reported (LOGITS_HELD) and held here sublayer
    by sublayer, as the MoE model's are (phase 9); phase_ssm_witnesses
    and phase_f32_witness say whether their gap is rounding."""
    stats, rerun = _sublayer_run(res)
    again = max(float((a - b).abs().max()) for a, b in zip(rerun, res["logits"]))
    log(f"  the kernel path run again: max |dlogit| {again:.3e} against the "
        f"main-path run; sublayer by sublayer (same input on both paths; "
        f"tol {TOL['bfloat16']} abs + rel):")
    for kind, (n, err, exc) in stats.items():
        log(f"    {kind}: {n} calls, max |diff| {err:.3e} "
            f"{'ok' if exc <= 0 else 'FAIL'}")
    bad = [k for k, (_, _, exc) in stats.items() if exc > 0]
    if bad:
        raise AssertionError(f"sublayers outside tolerance: {bad}")


def phase_timing_ssd(res, launches: int, errs, Bt: int = BATCH,
                     S: int = PROMPT, name: str = None) -> list:
    """K8 at an SSM model's prefill shape, (``Bt``, ``S``) (one Mamba
    layer's call: bf16 x, B, C, zero initial state, the models' own
    decays), as row ``name`` (by default named by the model): device time
    (profiler), plain version, bound, and the launcher's grids.  No one
    PyTorch call computes the SSD scan, so there is no library time.  The
    bound's operations count the causal half (j <= i) of the intra-chunk
    products and what the function needs of each: C·Bᵀ depends on the
    group, not the head, so once per (batch, group, chunk) on B and C's
    own type (bf16 here: the tensor cores' rate); its product with dt·x
    and the two state terms, whose other operand is f32, per (batch, head,
    chunk).  Those f32 products run on the tensor cores as TF32 products
    of hi and lo parts, which keep f32's accuracy, and count at the TF32
    rate as many times as the kernel multiplies: three for the
    intra-chunk term (both operands f32), and for the two state terms
    three with f32 B and C, two with bf16 (exact in TF32: no lo part)."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ops import grids as ssd_grids
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    cfg = res["cfg"]
    H, P, G, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    Q = min(cfg.ssm_chunk, _ssd_chunk(S))
    x, dt, A, B, C, D, _ = _ssd_inputs(g, Bt, S, H, P, G, N,
                                       torch.bfloat16, "model", False)
    _, nbytes = ssd_ops.cost(Bt, S, H, P, G, N, Q, x.element_size())
    flops_cb, flops_intra, flops_state = ssd_ops.flop_parts(Bt, S, H, P, G,
                                                            N, Q)
    bf16 = B.dtype == torch.bfloat16
    cb_rate = BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S
    products = 3 * flops_intra + (2 if bf16 else 3) * flops_state
    if name is None:
        name = ("ssd_scan" if cfg.name == SSM_ARCHS[0]
                else f"ssd_scan[{cfg.name}]")
    kernel = lambda: ssd(x, dt, A, B, C, D, chunk=cfg.ssm_chunk)
    row = _row(name, "src/repro_torch/kernels/csrc/ssd_scan.cu",
               "src/repro/kernels/ssd_scan/kernel.py:76", {name: launches},
               errs, device_ms(kernel),
               device_ms(lambda: ssd(x, dt, A, B, C, D, chunk=cfg.ssm_chunk,
                                     backend="torch"), iters=5),
               None, nbytes, [(flops_cb, cb_rate),
                              (products, TF32_FLOP_PER_S)])
    log(f"timing, K8 at {name}: one {cfg.name} layer's call (Bt {Bt} S {S} H {H} "
        f"P {P} N {N} Q {Q}; C·Bᵀ {flops_cb / 1e9:.3f} GFLOP, f32 "
        f"{(flops_intra + flops_state) / 1e9:.2f} GFLOP ({products / 1e9:.2f}"
        f" as TF32 products), {nbytes / 1e6:.1f} MB; blocks (C·Bᵀ, state, "
        f"pass, outputs) {ssd_grids(Bt, S, H, P, G, N, Q)}): "
        f"{row['ms'] * 1e3:.1f}us device, back-to-back "
        f"{call_ms(kernel) * 1e3:.1f}us, bound {row['bound_ms'] * 1e3:.1f}us "
        f"({row['bound_by']}), plain {row['plain_ms'] * 1e3:.1f}us, library "
        f"none, launches {row['launches']}")
    return [row]


def phase_profile() -> None:
    """Device time of each served model's prefill and of its decode steps:
    the launcher's main path at full width (as phases 3, 8 and 11 run it,
    without their checks), then one warm run, then two profiled prefills
    and two profiled 31-step decode loops, every kernel's device time
    summed (torch.profiler), of the eager loop, and where the launcher
    has step graphs (``res["graphs"]``), of their replays too, with each
    loop's wall per prefill and per decode step (two warm runs) and the
    host's time to queue one decode replay.  It
    calls only the launcher and the models, so that a copy of this script
    in an earlier checkout measures that checkout's kernels the same
    way."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    for arch in (ARCH, MOE_ARCH, *SSM_ARCHS):
        res = serve.main(["--arch", arch, "--batch", str(BATCH),
                          "--prompt-len", str(PROMPT), "--new-tokens",
                          str(NEW_TOKENS), "--device", "cuda", "--seed",
                          str(SEED)])
        model, params, tokens = res["model"], res["params"], res["tokens"]
        loops = {"eager": lambda **kw: _serve_once(model, params, tokens,
                                                    **kw)}
        if res.get("graphs") is not None:
            loops["graphed"] = lambda **kw: _serve_graphed(res["graphs"],
                                                           tokens, **kw)
        for loop, serve_fn in loops.items():
            walls = [serve_fn() for _ in range(3)][1:]
            out = {}
            for part, steps in (("prefill", 1), ("decode", NEW_TOKENS - 1)):
                for _ in range(2):
                    prof = profile(activities=[ProfilerActivity.CUDA])
                    serve_fn(**{f"{part}_ctx": lambda: prof})
                    busy_us = sum(e.self_device_time_total
                                  for e in device_events(prof))
                    out.setdefault(part, []).append(busy_us / 1e3 / steps)
            extra = ""
            if loop == "graphed":
                host = [replay_host_ms(res["graphs"], tokens)[0]
                        for _ in range(2)]
                extra = (f"; capture {res['capture_s'] * 1e3:.1f}ms; host ms "
                         f"to queue a decode replay "
                         f"{[round(h, 4) for h in host]}")
            log(f"profile {arch} {loop}: device ms per prefill "
                f"{[round(t, 3) for t in out['prefill']]}, per decode step "
                f"{[round(t, 3) for t in out['decode']]}; wall ms per "
                f"prefill {[round(w[0] * 1e3, 3) for w in walls]}, per "
                f"decode step "
                f"{[round(w[1] * 1e3 / (NEW_TOKENS - 1), 3) for w in walls]}"
                + extra)
        close_graphs(res)
        del res, model, params, tokens, loops
        gc.collect()
        torch.cuda.empty_cache()


DECODE_SHAPES = [(ARCH, 16, 16, 64), (MOE_ARCH, 16, 16, 128),
                 (SSM_ARCHS[1], 32, 32, 64),   # served: name, H, K, D
                 (GQA_ARCHS[0], 32, 8, 128), (GQA_ARCHS[2], 36, 4, 128)]
DECODE_COLD = 8        # caches taken in turn for an L2-cold time (71-142 MB)


def phase_decode_ab() -> None:
    """K6 alone at the served decode shapes, held against its plain
    version and timed beside SDPA by one method in turns (kernel, SDPA,
    SDPA, kernel), once on one cache (L2-warm, as the kernel table's rows)
    and once over DECODE_COLD caches taken in turn (each call finds its
    cache in HBM, as the layers of a decode step do); and the kernels one
    call launches.  It calls only the public wrappers, so that a copy of
    this script in an earlier checkout times that checkout's K6."""
    import itertools
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    S = PROMPT + NEW_TOKENS
    log("timing, K6 alone (device time per call; kernel, SDPA in turns):")
    for arch, H, K, D in DECODE_SHAPES:
        ops = [_decode_operands(g, BATCH, S, H, K, D)
               for _ in range(DECODE_COLD)]
        q, kc, vc, lengths, (qt, kt, vt, mask) = ops[0]
        check_close(f"K6 {arch}", decode_attention(q, kc, vc, lengths),
                    decode_attention_ref(q, kc, vc, lengths), TOL["bfloat16"])
        kernel = lambda: decode_attention(q, kc, vc, lengths)
        lib = lambda: sdpa(qt, kt, vt, attn_mask=mask)
        nxt = itertools.cycle(ops).__next__
        cold_kernel = lambda: decode_attention(*nxt()[:4])
        cold_sdpa = lambda: (lambda o: sdpa(*o[4][:3], attn_mask=o[4][3]))(
            nxt())
        warm, how = device_times([kernel, lib, lib, kernel])
        cold, cold_how = device_times([cold_kernel, cold_sdpa, cold_sdpa,
                                       cold_kernel])
        us = lambda t: (f"kernel {t[0] * 1e3:.2f}/{t[3] * 1e3:.2f}, sdpa "
                        f"{t[1] * 1e3:.2f}/{t[2] * 1e3:.2f}")
        nbytes = 2 * (2 * q.numel() + 2 * BATCH * (S - 1) * K * D)
        log(f"  {arch} (B {BATCH} S {S} H {H} K {K} D {D}; bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e6:.2f}us): warm us {us(warm)} "
            f"({how}); cold us {us(cold)} ({cold_how}); kernels per call "
            f"{kernels_per_call(kernel)}")


def phase_ssd_ab() -> None:
    """K8 alone at both SSM prefill shapes and at the mamba2 fan-out's (1,
    16) forward (bf16, the models' decays, zero initial state, as phases
    13 and 7 time it), held against its plain version and timed twice,
    with the time of each kernel of a call.  It calls only the public
    wrapper, so that a copy of this script in an earlier checkout times
    that checkout's K8."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd, ssd_chunked
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    log("timing, K8 alone (device time per call, twice):")
    for arch, Bt, S in [(a, BATCH, PROMPT) for a in SSM_ARCHS] + \
            [(SSM_ARCHS[0], 1, 16)]:
        cfg = get_config(arch)
        H, P, G, N = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_ngroups,
                      cfg.ssm_state)
        Q = min(cfg.ssm_chunk, _ssd_chunk(S))
        x, dt, A, B, C, D, _ = _ssd_inputs(g, Bt, S, H, P, G, N,
                                           torch.bfloat16, "model", False)
        init = torch.zeros(Bt, H, P, N, device="cuda")
        want = ssd_chunked(x, dt, A, B, C, D, init, Q)
        got = ssd(x, dt, A, B, C, D, chunk=cfg.ssm_chunk)
        check_close(f"K8 {arch} y", got[0], want[0], SSD_TOL["bfloat16"])
        check_close(f"K8 {arch} final state", got[1], want[1],
                    SSD_TOL["bfloat16"])
        kernel = lambda: ssd(x, dt, A, B, C, D, chunk=cfg.ssm_chunk)
        t, how = device_times([kernel, kernel])
        log(f"  {arch} (Bt {Bt} S {S} H {H} P {P} G {G} N {N} Q "
            f"{Q}): {t[0] * 1e3:.1f}/{t[1] * 1e3:.1f}us ({how}); kernels "
            f"(per call, us): {kernels_per_call(kernel)}")


# ---------------------------------------------------------------------------
# Training: qwen1.5-0.5b, mamba2-130m and zamba2-1.2b at full width,
# train_4k's sequence, batch 4
# ---------------------------------------------------------------------------

TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_WARM = 4096, 4, 4, 2
# each training architecture: (arch, the main path's steps, its layers: 0
# for the config's own)
TRAIN_ARCHS = tuple((a, TRAIN_STEPS, 0) for a in (ARCH,) + SSM_ARCHS)
# phase 18: the other families at full width and depth, and qwen3-4b at
# full width on its first 4 of 36 layers: phase 20 trains granite-3-8b at
# full depth on the same attention shape (H 32 over K 8, D 128), so the
# cut buys phase 20's time inside the run's 1,200 s
FAMILY_TRAIN_ARCHS = (("whisper-tiny", TRAIN_STEPS, 0),
                      ("internvl2-2b", TRAIN_STEPS, 0),
                      ("qwen3-4b", TRAIN_STEPS, 4))
# phase 20: the two largest GQA decoders at full width and depth, 4 steps
# each: (arch, steps, the architecture whose K5 training row times the
# same shape, or None); granite-3-8b's attention (H 32 over K 8, D 128) is
# qwen3-4b's
GQA_TRAIN_ARCHS = (("granite-3-8b", 4, "qwen3-4b"),
                   ("starcoder2-7b", 4, None))
# their f32 witness runs at full width on the first F32_HOLD_LAYERS
# layers: at full depth its f32 weights, accumulator and one microbatch's
# gradients (12 B a parameter) would take ~98 and ~89 GB of the card's 80
F32_HOLD_LAYERS = 4
# the loss over one fixed batch (the reference's test_train_lm_loss_
# decreases at full width): qwen1.5-0.5b, the example's captured step,
# make_batch's step 0 every step, a constant SGD learning rate
FIXED_BATCH_STEPS, FIXED_BATCH_LR = 30, 0.05
TRAIN_LOSS_TOL = {"float32": 1e-4, "bfloat16": 3e-2}   # abs + rel
TRAIN_GRAD_RL2 = 1e-3        # each f32 gradient leaf, relative L2
# K5's output and FlashAttentionFn's gradients at a training shape (bf16),
# relative L2 beside TOL: over ~1,500 keys a typical |value| is ~3e-2
TRAIN_ATTN_RL2 = 1e-2


def train_shapes(cfg) -> dict:
    """K5's calls in one training forward of ``cfg`` at (B 4, S 4096), by
    the wrapper's launch key (Sq, Sk, H, K, D, causal), with their counts.
    Dense and VLM: one causal self-attention per layer (the VLM's 256
    patches and 3,840 text tokens make its 4,096 positions); the hybrid:
    one per shared-block application; whisper-tiny: the encoder's
    self-attention without a mask over the frames, then in each decoder
    layer the causal self-attention and the cross-attention over the
    frames; pure SSM: none."""
    from repro_torch.models.ssm_stack import n_attn_apps
    H, K, D, L, S = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers,
                     TRAIN_SEQ)
    if cfg.family == "encdec":
        F = cfg.n_frames
        return {(F, F, H, K, D, False): cfg.n_enc_layers,
                (S, S, H, K, D, True): L, (S, F, H, K, D, False): L}
    if cfg.family == "hybrid":
        return {(S, S, H, K, D, True): n_attn_apps(cfg)}
    return {} if cfg.ssm_state else {(S, S, H, K, D, True): L}


def _part(shape) -> str:
    """`` encoder`` or `` cross`` for whisper-tiny's unmasked shapes."""
    Sq, Sk, causal = shape[0], shape[1], shape[5]
    return "" if causal else " encoder" if Sq == Sk else " cross"


def _train_row(kernel: str, cfg, part: str = "") -> str:
    """A training row's name: ``flash_attention[train]`` for qwen1.5-0.5b
    (the first training row), else ``<kernel>[train <arch><part>]``."""
    return f"{kernel}[train]" if cfg.name == ARCH else \
        f"{kernel}[train {cfg.name}{part}]"


def _train_qkv(g, shape):
    """One attention call's operands at a training shape (Sq, Sk, H, K, D,
    causal) at batch 4 (bf16), and an upstream gradient."""
    import torch
    Sq, Sk, H, K, D, _ = shape
    shapes = [(TRAIN_BATCH, Sq, H, D), (TRAIN_BATCH, Sk, K, D),
              (TRAIN_BATCH, Sk, K, D), (TRAIN_BATCH, Sq, H, D)]
    return [torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
            for s in shapes]


def phase_train_parity(cfg, shape, name: str) -> dict:
    """K5's softmax statistics and ``FlashAttentionFn``'s gradients at one
    attention call's training shape of ``cfg`` (B 4, bf16; causal, or
    without a mask) against the plain version's (``attention_ref`` with
    its statistics, and autograd through it): the output and gradients at
    the bf16 kernel tolerance and within ``TRAIN_ATTN_RL2`` relative L2,
    the statistics (f32 sums of f32 products of the same bf16 operands) at
    the f32 one."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    q, k, v, do = _train_qkv(g, shape)
    Sq, Sk, H, K, D, causal = shape
    what = f"{cfg.name}{_part(shape)} train shape"
    log(f"train parity: K5 with statistics and FlashAttentionFn at "
        f"{cfg.name}'s{_part(shape)} B {TRAIN_BATCH} Sq {Sq} Sk {Sk} H {H} "
        f"K {K} D {D}, bf16, {'causal' if causal else 'no mask'}")
    out, lse = flash_ops._flash_cuda(q, k, v, causal, D ** -0.5, 0,
                                     stats=True)
    torch.cuda.synchronize()
    want, want_lse = attention_ref(q, k, v, causal=causal, return_stats=True)
    err = check_close(f"K5 output ({what})", out, want, TOL["bfloat16"],
                      TRAIN_ATTN_RL2)
    check_close(f"K5 statistics ({what})", lse, want_lse, TOL["float32"])
    del want, want_lse
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = flash_ops.LAUNCHES.value
    flash_attention(*xs, causal=causal).backward(do)
    torch.cuda.synchronize()
    if flash_ops.LAUNCHES.value != n0 + 1:
        raise AssertionError("FlashAttentionFn did not launch K5 once")
    ys = [t.clone().requires_grad_() for t in (q, k, v)]
    attention_ref(*ys, causal=causal).backward(do)
    for gname, a, b in zip(("dq", "dk", "dv"), xs, ys):
        check_close(f"FlashAttentionFn {gname} ({what})", a.grad, b.grad,
                    TOL["bfloat16"], TRAIN_ATTN_RL2)
    del xs, ys
    torch.cuda.empty_cache()
    return {name: err}


def _ssd_train_operands(g, cfg):
    """One Mamba layer's SSD operands of ``cfg`` at the training shape:
    bf16 x, B, C and f32 dt, A, D with the models' decays, as the layer
    hands them to ``ssd`` (no initial state)."""
    import torch
    H, P, G, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_ngroups, \
        cfg.ssm_state
    return _ssd_inputs(g, TRAIN_BATCH, TRAIN_SEQ, H, P, G, N, torch.bfloat16,
                       "model", False)[:6]


def phase_train_parity_ssd(cfg) -> dict:
    """``SSDScanFn`` at one Mamba layer's training shape of ``cfg``: y and
    the final state of its forward (one K8 launch) against
    ``ssd_chunked``, then dx, ddt, dA, dB, dC and dD from one backward of
    both outputs against autograd through ``ssd_chunked`` on the same
    operands and cotangents, at the tolerance in force at the models'
    decays (3e-2: the plain version's f32 sums are ~4e-4 off the exact
    scan there, K8's f64 sums are not)."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ssd, ssd_chunked
    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    ops = _ssd_train_operands(g, cfg)
    x = ops[0]
    Bt, S, H, P = x.shape
    N = ops[3].shape[3]
    Q = min(cfg.ssm_chunk, _ssd_chunk(S))
    tol = SSD_TOL["bfloat16"]
    gy = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)
    gf = torch.randn((Bt, H, P, N), generator=g, device="cuda")
    log(f"train parity: SSDScanFn at {cfg.name}'s Bt {Bt} S {S} H {H} P {P} "
        f"N {N} Q {Q}, bf16, the models' decays")
    xs = [t.clone().requires_grad_() for t in ops]
    n0 = ssd_ops.LAUNCHES.value
    y, final = ssd(*xs, chunk=cfg.ssm_chunk)
    torch.autograd.backward((y, final), (gy, gf))
    torch.cuda.synchronize()
    if ssd_ops.LAUNCHES.value != n0 + 1:
        raise AssertionError("SSDScanFn did not launch K8 once")
    ys = [t.clone().requires_grad_() for t in ops]
    yc, fc = ssd_chunked(*ys, torch.zeros_like(gf), Q)
    name = _train_row("ssd_scan", cfg)
    err = check_close(f"SSDScanFn y ({cfg.name} train shape)", y, yc, tol)
    check_close(f"SSDScanFn final state ({cfg.name} train shape)", final,
                fc, tol)
    torch.autograd.backward((yc, fc), (gy, gf))
    for gname, a, b in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), xs, ys):
        if a.grad.dtype != a.dtype:
            raise AssertionError(f"SSDScanFn {gname}: {a.grad.dtype}")
        check_close(f"SSDScanFn {gname} ({cfg.name} train shape)", a.grad,
                    b.grad, tol)
    del xs, ys, y, yc
    torch.cuda.empty_cache()
    return {name: err}


def _train_batch(cfg, step: int) -> dict:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import PipelineConfig, make_batch
    from repro_torch.launch.train import to_device
    shape = ShapeConfig("train_4k_b4", "train", TRAIN_SEQ, TRAIN_BATCH)
    return to_device(make_batch(cfg, shape, PipelineConfig(seed=SEED), step),
                     "cuda")


def _loss_and_grads(model, params, batch, n_micro: int = 1,
                    accum_dtype: str = "float32"):
    """The loss and every gradient leaf, in parameter order, of one step
    over ``batch`` in ``n_micro`` microbatches (``accumulate_grads``, as
    ``make_train_step`` takes them, summed in ``accum_dtype``)."""
    import torch
    from repro_torch.optim.grad_accum import accumulate_grads
    grads, loss, _ = accumulate_grads(model.loss, params, batch, n_micro,
                                      accum_dtype=getattr(torch, accum_dtype))
    return loss.detach(), list(grads.values())


def _hold_microbatches(cfg) -> tuple:
    """(microbatches, accumulator dtype) of the kernel-vs-plain hold.  The
    plain path's attention makes (B, H, S, S) f32 scores and keeps three
    of them for its backward, 4.3 GB each at qwen1.5-0.5b's 16 heads and 4
    rows; zamba2-1.2b's 32 heads take two microbatches of 2 rows on both
    paths (at 4 rows the plain path wants more than the card's 80 GB).
    Past 3 B parameters the scores get one row at a time: the f32 hold
    keeps f32 weights, the f32 accumulator and one microbatch's f32
    gradients (12 B a parameter, 48 GB at qwen3-4b's 4.0 B), the bf16
    hold bf16 weights, the accumulator and one microbatch's bf16 gradients
    (8 B a parameter with an f32 accumulator: the bf16 gradients are added
    into it without an f32 copy).  Past 6 B parameters (granite-3-8b's
    8.2 B, starcoder2-7b's 7.4 B) the bf16 hold sums its microbatches in
    bf16 on both paths (6 B a parameter, 49 GB at 8.2 B; with an f32
    accumulator, 65 GB and the plain attention's ~13 GB of one layer's
    backward would leave no room on the card), and the f32 hold runs at a
    cut depth (``F32_HOLD_LAYERS``)."""
    n = max(1, cfg.n_heads * TRAIN_BATCH // 64)
    params = cfg.param_count()
    return (TRAIN_BATCH if params > 3e9 else n,
            "bfloat16" if params > 6e9 else "float32")


def _first_layers(base, cfg):
    """The parameters of ``cfg`` (``base``'s config with fewer layers) in
    f32 on ``base``'s device, over ``base``'s leaves of the same names: the
    embedding, its first ``cfg.n_layers`` layers, the final norm and the
    unembedding, widened from ``base``'s dtype."""
    import torch
    f32 = cfg.with_overrides(dtype="float32", param_dtype="float32")
    out = type(base)(f32, device="meta").to_empty(
        device=next(base.parameters()).device)
    with torch.no_grad():
        for n, p in out.named_parameters():
            p.copy_(base.get_parameter(n))
    return out


def _zero_grad_leaves(cfg, names) -> dict:
    """The leaves whose gradient is zero in exact arithmetic, each with the
    leaf that scales it: without rotary positions a key bias adds q·bk to
    every score of a row alike, which the softmax ignores (the CPU tests
    hold the same leaves apart).  Maps each ``*.bk`` to its ``*.bq``."""
    if cfg.use_rope or not cfg.qkv_bias:
        return {}
    return {n: n[:-2] + "bq" for n in names if n.endswith(".bk")}


def phase_train_holds(cfg, f32_layers: int = 0) -> None:
    """One training step of ``cfg`` at full width (the example's
    execution config: remat full, loss chunks of 128; the microbatches and
    accumulator of ``_hold_microbatches``) on the kernel path and on the
    plain path (``backend="torch"``), on the same weights and batch: with
    the weights widened to f32 the losses within 1e-4 and
    every gradient leaf within 1e-3 relative L2 (a leaf whose gradient is
    zero, ``_zero_grad_leaves``, within 1e-3 of its sibling's norm on both
    paths); in bf16 the losses within 3e-2 and each leaf's relative L2
    reported.  With ``f32_layers`` the f32 hold (the witness) runs on the
    first ``f32_layers`` layers of the same weights, every width, head
    count, bias and norm of the config kept, and the bf16 hold at full
    depth.  The batch carries the
    frames or patch embeddings ``make_batch`` draws for the family.  The
    kernel path's leaves wait in host memory while the plain path runs,
    and come back one at a time for the comparison."""
    import torch
    from repro_torch.models import ExecConfig, build_model
    from repro_torch.models.weights import trainable
    batch = _train_batch(cfg, 0)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    base = build_model(cfg).init(gen)
    n_micro, accum = _hold_microbatches(cfg)
    for dtype in ("float32", "bfloat16"):
        hcfg = cfg.with_overrides(n_layers=f32_layers) if \
            f32_layers and dtype == "float32" else cfg
        dcfg = hcfg.with_overrides(dtype=dtype, param_dtype=dtype)
        if hcfg is not cfg:
            params = trainable(_first_layers(base, hcfg))
        else:
            params = trainable(base.to(getattr(torch, dtype)) if dtype ==
                               "float32" else base)
        acc = accum if dtype == "bfloat16" else "float32"
        depth = (f"{hcfg.n_layers} of {cfg.n_layers} layers: at full depth "
                 f"the f32 weights, accumulator and one microbatch's "
                 f"gradients would take {12 * cfg.param_count() / 1e9:.0f} "
                 f"GB" if hcfg is not cfg else f"{cfg.n_layers} layers")
        out = {}
        for backend in ("auto", "torch"):
            model = build_model(dcfg, ExecConfig(
                backend=backend, loss_chunk=min(TRAIN_SEQ, 128)))
            t0 = time.perf_counter()
            loss, grads = _loss_and_grads(model, params, batch, n_micro, acc)
            if backend == "auto":
                finite = all(bool(torch.isfinite(g).all()) for g in grads)
                grads = [g.cpu() for g in grads]
            out[backend] = loss, grads
            del grads
            torch.cuda.synchronize()
            log(f"  train step {cfg.name} {dtype} {backend} ({depth}): loss "
                f"{float(out[backend][0]):.6f} in "
                f"{time.perf_counter() - t0:.2f}s ({n_micro} microbatch"
                f"{'es' if n_micro > 1 else ''} of "
                f"{TRAIN_BATCH // n_micro} rows, summed in {acc}); peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            torch.cuda.reset_peak_memory_stats()
            gc.collect()
            torch.cuda.empty_cache()
        (lk, gk), (lp, gp) = out["auto"], out["torch"]
        tol = TRAIN_LOSS_TOL[dtype]
        names = [n for n, _ in params.named_parameters()]
        gk, gp = dict(zip(names, gk)), dict(zip(names, gp))
        zero = _zero_grad_leaves(cfg, names)
        rl2 = {n: float((gk[n].to(gp[n].device).float() - gp[n].float())
                        .norm() / gp[n].float().norm().clamp_min(1e-30))
               for n in names if n not in zero}
        # a zero leaf's gradient on either path, over its query-bias
        # sibling's on the plain path: round-off, held to the same 1e-3
        zr = {n: max(float(gk[n].float().norm()), float(gp[n].float().norm()))
              / float(gp[zero[n]].float().norm().clamp_min(1e-30))
              for n in zero}
        worst = max(rl2, key=rl2.get)
        log(f"train hold {cfg.name} {dtype} ({depth}): kernel path vs "
            f"plain path, loss "
            f"{float(lk):.6f} vs {float(lp):.6f} (|d| "
            f"{abs(float(lk) - float(lp)):.3e}, tol {tol:g} abs + rel); "
            f"gradient leaves' relative L2: max {rl2[worst]:.3e} ({worst}), "
            f"median {sorted(rl2.values())[len(rl2) // 2]:.3e}"
            + (f"; the {len(zr)} key biases' (zero: no rotary positions) "
               f"norm over their query bias's: max {max(zr.values()):.3e}"
               if zr else "")
            + (f" (held to {TRAIN_GRAD_RL2:g})" if dtype == "float32"
               else " (reported)"))
        if not finite or abs(float(lk) - float(lp)) > tol + tol * abs(float(lp)):
            raise AssertionError(f"train step {cfg.name} {dtype}: losses "
                                 f"{float(lk)} and {float(lp)}, or a "
                                 f"non-finite gradient")
        bad = [n for n, r in list(rl2.items()) + list(zr.items())
               if r > TRAIN_GRAD_RL2]
        if dtype == "float32" and bad:
            raise AssertionError(f"{cfg.name} gradients {bad[:4]}: relative "
                                 f"L2 {[rl2.get(n, zr.get(n)) for n in bad[:4]]}")
        del out, gk, gp
        if dtype == "float32":
            del params
            gc.collect()
            torch.cuda.empty_cache()
            if hcfg is cfg:            # the weights were widened in place
                base = build_model(cfg).init(
                    torch.Generator(device="cuda").manual_seed(SEED))
    del base
    gc.collect()
    torch.cuda.empty_cache()


def _log_launches(log, counters) -> tuple:
    """(launches by counter name, K5's by shape) in a ``LaunchLog``."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    return ({k: log.count(c) for k, c in counters.items()},
            log.by_key(flash_ops.LAUNCHES))


def phase_train_graph_hold(cfg) -> None:
    """The captured train step (``launch/train_graphs.py``) against the
    eager step of ``make_train_step``, the factory the launchers wrap, at
    the main path's execution config (remat full, loss chunks of 128, one
    microbatch, SGD with warmup_cosine(0.05)), full width, B 4, S 4096:
    from the same parameters, optimizer state and batch, one eager step
    (the captured step's warm-up, on its capture stream) and one replay
    of the captured step give the same loss, aux loss, gradient norm,
    every updated parameter and the optimizer state, bitwise.  The start
    waits in host memory and is put back in place before the capture; the
    eager results wait on the card (since the update holds no f32 copy of
    the model, granite-3-8b's weights, a second set and the graph's pool
    take ~57 GB), where the replay's are compared with them.  The
    graph's launch log holds one step's K5 and K8 launches exactly (by
    shape too), as many as the eager step counted, and the replay adds
    them to the counters."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train_graphs import GraphedTrainStep, written
    from repro_torch.models import ExecConfig, build_model
    from repro_torch.models.weights import trainable
    from repro_torch.optim import SGD, warmup_cosine
    shape = ShapeConfig("train_4k_b4", "train", TRAIN_SEQ, TRAIN_BATCH)
    model = build_model(cfg, ExecConfig(loss_chunk=min(TRAIN_SEQ, 128)))
    opt = SGD(lr=warmup_cosine(0.05, TRAIN_STEPS // 10 + 1, TRAIN_STEPS))
    params = trainable(model.init(
        torch.Generator(device="cuda").manual_seed(SEED), "cuda"))
    state = opt.init(params)
    batch = _train_batch(cfg, 0)
    want, want_shape = _train_launches(cfg, 1)
    counters = launch_counters()
    t0 = time.perf_counter()
    start = [t.detach().cpu() for t in written(params, state)]
    graphed = GraphedTrainStep(make_train_step(model, opt, shape), "cuda")
    reset_launches()
    p, s, m = graphed(params, state, batch)          # the eager warm-up
    torch.cuda.synchronize()
    eager = (read_launches(), flash_ops.LAUNCHES.by_key())
    eager_m = {k: v.clone() for k, v in m.items()}
    eager_t = [t.detach().clone() for t in written(p, s)]
    del p, s, m
    with torch.no_grad():
        for t, h in zip(written(params, state), start):
            t.copy_(h)
    del start
    reset_launches()
    p, s, m = graphed(params, state, batch)          # capture, one replay
    torch.cuda.synchronize()
    replayed = (read_launches(), flash_ops.LAUNCHES.by_key())
    log_launches = _log_launches(graphed.launches, counters)
    same_m = {k: torch.equal(v, eager_m[k]) for k, v in m.items()}
    bad = [i for i, (t, h) in enumerate(zip(written(p, s), eager_t))
           if not torch.equal(t.detach(), h)]
    n_leaves = len(eager_t)
    del eager_t
    log(f"  captured step hold {cfg.name}: one replay against one eager step "
        f"from the same start: loss {float(m['loss']):.6f} vs "
        f"{float(eager_m['loss']):.6f}, grad_norm {float(m['grad_norm']):.6f} "
        f"vs {float(eager_m['grad_norm']):.6f}; metrics bitwise {same_m}; "
        f"{n_leaves - len(bad)} of {n_leaves} parameter and optimizer-state "
        f"tensors bitwise; capture {graphed.capture_ms:.1f}ms host; launches "
        f"eager {eager[0]} (K5 by shape {eager[1]}), replay {replayed[0]}, "
        f"the graph's log {log_launches[0]} (expected {want}, K5 by shape "
        f"{want_shape}); {time.perf_counter() - t0:.1f}s")
    graphed.close()
    del graphed, p, s, m, params, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    if not all(same_m.values()) or bad:
        raise AssertionError(f"{cfg.name}: the captured step differs from "
                             f"the eager step: metrics {same_m}, tensors "
                             f"{bad[:8]} of {n_leaves}")
    for what, (got, by_shape) in (("eager", eager), ("replay", replayed),
                                  ("graph log", log_launches)):
        if got != want or by_shape != want_shape:
            raise AssertionError(f"{cfg.name} {what} launches {got}, K5 by "
                                 f"shape {by_shape}; expected {want}, "
                                 f"{want_shape}")


def _train_flops(cfg, params) -> float:
    """Model FLOP of one step: 6 N T for the weights, each weight counted
    over the tokens that pass it (the tied embedding once, as the
    unembedding; the hybrid's shared block once per application;
    whisper-tiny's encoder over the frames and its decoder and
    unembedding over the tokens; the VLM's layers over its 4,096
    positions and its unembedding over the 3,840 text tokens), plus 3
    times the forward of attention (QK^T and PV over the pairs of
    ``flash_attention/ops.py::causal_pairs``) at every shape of
    ``train_shapes`` and of the SSD scan's products
    (``ssd_scan/ops.py::flop_parts``) in each Mamba layer: the backward
    twice the forward; no remat recompute."""
    from repro_torch.kernels.flash_attention.ops import causal_pairs
    from repro_torch.kernels.ssd_scan.ops import flop_parts
    T = TRAIN_BATCH * TRAIN_SEQ
    n = sum(p.numel() for p in params.parameters())
    mamba_layers = cfg.n_layers if cfg.ssm_state else 0
    shapes = train_shapes(cfg)
    if cfg.family == "hybrid":
        n += (sum(shapes.values()) - 1) * sum(
            p.numel() for p in params.shared_block.parameters())
    weights = 6 * n * T
    if cfg.family in ("encdec", "vlm"):
        emb = params.embed.numel() + (0 if cfg.tie_embeddings else
                                      params.unembed.numel())
        if cfg.family == "encdec":
            enc = sum(p.numel() for p in params.encoder.parameters())
            weights = 6 * (enc * TRAIN_BATCH * cfg.n_frames + (n - enc) * T)
        else:
            text = TRAIN_BATCH * (TRAIN_SEQ - cfg.n_image_tokens)
            weights = 6 * ((n - emb) * T + emb * text)
    attn_fwd = sum(4 * sh[4] * sh[2] * TRAIN_BATCH
                   * causal_pairs(sh[0], sh[1], sh[5]) * c
                   for sh, c in shapes.items())         # D H B pairs
    ssd_fwd = sum(flop_parts(
        TRAIN_BATCH, TRAIN_SEQ, cfg.ssm_nheads, cfg.ssm_headdim,
        cfg.ssm_ngroups, cfg.ssm_state,
        min(cfg.ssm_chunk, _ssd_chunk(TRAIN_SEQ))) if mamba_layers else (0,))
    return weights + 3 * (attn_fwd + ssd_fwd * mamba_layers)


def _train_launches(cfg, steps: int) -> tuple:
    """Each kernel's launches in the training run, in all and K5's by
    shape: K5 and K8 twice per attention call (``train_shapes``) and
    Mamba layer and step, the forward and the remat recompute; nothing
    else."""
    by_shape = {sh: 2 * c * steps for sh, c in train_shapes(cfg).items()}
    want = {k: 0 for k in launch_counters()}
    want["flash_attention"] = sum(by_shape.values())
    want["ssd_scan"] = 2 * (cfg.n_layers if cfg.ssm_state else 0) * steps
    return want, by_shape


def _event_ms(fn) -> tuple:
    """(ms between CUDA events around one call of ``fn``, the host's ms
    until the call returned)."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    ev[0].record()
    fn()
    ev[1].record()
    host_ms = (time.perf_counter() - h0) * 1e3
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]), host_ms


def _profiled_step(fn) -> tuple:
    """One call of ``fn`` under torch.profiler, between CUDA events:
    (device busy ms, records, the events' ms, the device events).  The
    busy ms over the events' ms of the same call is a share of one run."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    with prof:
        ms, _ = _event_ms(fn)
    busy_ms, n, events = _busy(prof)
    return busy_ms, n, ms, events


def phase_train(smi: str, cfg, steps: int, light: bool = False) -> tuple:
    """The training main path: ``examples/train_lm_torch.py`` at full width
    (``cfg``'s architecture, random weights from the seed, train_4k's
    sequence of 4,096 at batch 4, SGD with warmup_cosine(0.05), remat
    full), ``steps`` steps through the captured step (step 0 eager, the
    capture, then one replay a step), every counter zeroed just before and
    read just after: K5 (each attention call of ``train_shapes``) and K8
    (each Mamba layer) launch exactly twice per call and step (forward
    and remat recompute), K5 by shape too, no other kernel launches, and
    the graph's log holds exactly one step's.  While the graph is held,
    one more step (the batch's copy and a replay) is timed between CUDA
    events and one is profiled, also between events: its device time over
    its own event time is a busy share of one run, which a record the
    profiler lost can only lower.  A copy of the trained weights waits on
    the card, and the graph is freed.  The loss
    must be finite at every step and every weight matrix (the embedding,
    attention, MLP and Mamba leaves of two or more axes) must have moved
    over the example's steps.  A leaf whose every element's f32 step
    stays under half a bf16 ulp keeps its value, as in the reference (the
    update is cast to bf16 with no f32 master copy): the unit norm scales
    do at lr 0.05.  So one more (eager) step holds the update itself:
    every leaf bitwise equal to the reference's rule, cast(p32 - lr g32),
    computed leaf by leaf, and each unmoved leaf's largest step is
    printed against half an ulp.  Then the step that was captured
    (``GraphedTrainStep.step``) runs eagerly, once between CUDA events
    and once profiled the same way, and one step of the same work with
    CUDA events around its forward, backward and update (``light``, as
    phases 16, 18 and 20 run it: the eager step timed, not profiled, and
    no split step).  A run that does not fit the card raises with its
    peak.
    Returns (the config, the run's launches, K5's by shape)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import ExecConfig, build_model
    from repro_torch.optim import SGD, warmup_cosine
    from repro_torch.launch.train_graphs import GraphedTrainStep
    sys.path.insert(0, str(ROOT / "examples"))
    import train_lm_torch as twin
    from repro_torch.kernels.flash_attention import ops as flash_ops
    arch = cfg.name
    log(f"train: {arch} full width, {cfg.n_layers} layers, via "
        f"examples/train_lm_torch.py, bf16, batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ}, {steps} steps")
    ckpt_dir = tempfile.mkdtemp(prefix="train_lm_torch_")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    depth = [] if cfg.n_layers == get_config(arch).n_layers else \
        ["--layers", str(cfg.n_layers)]
    reset_launches()
    try:
        res = twin.main(["--arch", arch, "--seq", str(TRAIN_SEQ), "--batch",
                         str(TRAIN_BATCH), "--steps", str(steps),
                         "--lr", "0.05", "--ckpt-every", "0", "--ckpt-dir",
                         ckpt_dir, "--device", "cuda"] + depth)
    except torch.cuda.OutOfMemoryError as e:
        raise AssertionError(
            f"train {arch}: does not fit the card: peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated, "
            f"{torch.cuda.max_memory_reserved() / 1e9:.2f} GB reserved of "
            f"{card_gb:.2f} GB") from e
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    launches = read_launches()
    by_shape = flash_ops.LAUNCHES.by_key()
    peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    peak_reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    held_gb = torch.cuda.memory_reserved() / 1e9
    if res["cfg"].n_layers != cfg.n_layers:
        raise AssertionError(f"the example trained {res['cfg'].n_layers} "
                             f"layers, not {cfg.n_layers}")
    params, state = res["params"], res["state"]
    graphed = res["step"]
    want, want_shape = _train_launches(cfg, steps)
    one, one_shape = _train_launches(cfg, 1)
    if not isinstance(graphed, GraphedTrainStep) or \
            graphed.replays != steps - 1:
        raise AssertionError(f"the example ran {graphed!r}, not the captured "
                             f"step replayed {steps - 1} times")
    per_replay = _log_launches(graphed.launches, launch_counters())
    capture_ms = graphed.capture_ms
    log(f"  launches {launches} (expected {want}: K5 and K8 forward and "
        f"remat recompute in each attention call and Mamba layer of "
        f"{steps} steps: step 0 eager, then {graphed.replays} replays of the "
        f"captured step); K5 by shape {by_shape} (expected {want_shape}); "
        f"per replay {per_replay[0]}, K5 by shape {per_replay[1]}; capture "
        f"{capture_ms:.1f}ms host")
    if launches != want or by_shape != want_shape or \
            per_replay != (one, one_shape):
        raise AssertionError(f"train launches {launches}, K5 by shape "
                             f"{by_shape}, per replay {per_replay}; expected "
                             f"{want}, {want_shape}, ({one}, {one_shape})")
    # the example's graph, still held: one more step (the batch's copy and
    # a replay) between CUDA events, then one under the profiler, also
    # between events, for a busy share of one run; a copy of the trained
    # weights waits for the check below
    trained = [p.detach().clone() for p in params.parameters()]
    batch = _train_batch(cfg, steps)
    g_ms, host_ms = _event_ms(lambda: graphed(params, state, batch))
    g_busy, g_n, g_prof_ms, _ = _profiled_step(
        lambda: graphed(params, state, batch))
    n_copies = len(graphed.batch)
    eager_step = graphed.step
    graphed.close()        # the graph's pool makes room for the initial weights
    del graphed, res["step"]
    gc.collect()
    torch.cuda.empty_cache()
    losses = [float(x) for x in res["losses"]]
    log(f"  loss by step: {[round(x, 5) for x in losses]}")
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train losses {losses}")
    init = build_model(cfg).init(        # the example's weights, seed 0
        torch.Generator(device="cuda").manual_seed(0))
    names = [n for n, _ in params.named_parameters()]
    same = [n for n, a, b in zip(names, trained, init.parameters())
            if torch.equal(a, b)]
    n_leaves = len(trained)
    del init, trained
    stuck = [n for n in same if params.get_parameter(n).ndim >= 2]
    if stuck:
        raise AssertionError(f"{len(stuck)} weight matrices did not change: "
                             f"{stuck[:4]}")
    log(f"  {n_leaves - len(same)} of {n_leaves} parameter leaves changed "
        f"over the example's {steps} steps, every weight matrix among them; "
        f"unchanged: {len(same)} "
        f"({sorted({n.rsplit('.', 2)[-2] + '.' + n.rsplit('.', 1)[-1] for n in same})})")
    flops = _train_flops(cfg, params)
    step_s = res["step_s"][TRAIN_WARM:]
    ms = [s * 1e3 for s in step_s]
    mean_s = sum(step_s) / len(step_s)
    tok = TRAIN_BATCH * TRAIN_SEQ
    log(f"train {arch}: step ms (host clock, batch made and copied, ending "
        f"in a sync; steps {TRAIN_WARM}-{steps - 1}) "
        f"{[round(x, 2) for x in ms]}, mean {mean_s * 1e3:.2f}; "
        f"{tok / mean_s:.1f} tokens/s; train_mfu {flops / mean_s / BF16_FLOP_PER_S:.4f} "
        f"({flops / 1e12:.2f} model TFLOP a step over 989 TFLOP/s); peak "
        f"memory {peak_gb:.2f} GB allocated above the {base_mem / 1e9:.2f} "
        f"GB held before, {peak_reserved_gb:.2f} GB reserved, of the card's "
        f"{card_gb:.2f} GB; {smi}")
    MEASURED[arch] = {"step_ms": mean_s * 1e3, "peak_gb": peak_gb,
                      "model_flops": flops}
    model = build_model(cfg, ExecConfig(loss_chunk=min(TRAIN_SEQ, 128)))
    opt = SGD(lr=warmup_cosine(0.05, steps // 10 + 1, steps))

    def step(batch, ev=None):
        mark = (lambda i: ev[i].record()) if ev else (lambda i: None)
        mark(0)
        loss, _ = model.loss(params, batch)
        mark(1)
        grads = torch.autograd.grad(loss, list(params.parameters()))
        mark(2)
        opt.update(dict(zip(names, grads)), state, params)
        mark(3)

    # the update of one step against the reference's rule, leaf by leaf
    before = [p.detach().clone() for p in params.parameters()]
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    lr = opt._lr(state.step)
    opt.update(dict(zip(names, grads)), state, params)
    ratio, wrong = {}, []
    with torch.no_grad():
        for (n, p), b, g in zip(params.named_parameters(), before, grads):
            step_f32 = lr * g.float()
            if not torch.equal(p, (b.float() - step_f32).to(p.dtype)):
                wrong.append(n)
            if n in same:
                half_ulp = torch.exp2(torch.floor(torch.log2(   # the smaller
                    b.float().abs().clamp_min(1e-30))) - 9)     # side's
                ratio[n] = float((step_f32.abs() / half_ulp).max())
    del before, grads
    if wrong:
        raise AssertionError(f"{len(wrong)} leaves not updated as "
                             f"cast(p32 - lr g32): {wrong[:4]}")
    log(f"  one more step: every leaf updated bitwise as cast(p32 - lr g32) "
        f"(lr {float(lr):.5f}); the unmoved leaves' largest step over half "
        f"a bf16 ulp (the smaller neighbour's): "
        f"{max(ratio.values()) if ratio else 0:.3f} "
        f"(below 1: the cast keeps them)")
    # the step that was captured, run eagerly (warm: the step above ran
    # the same work): once between CUDA events, once profiled
    torch.cuda.reset_peak_memory_stats()
    e_ms, _ = _event_ms(lambda: eager_step(params, state, batch))
    eager_gb = torch.cuda.max_memory_allocated() / 1e9
    eager_reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    e_busy, events = "not profiled (phases 16, 18, 20)", []
    if not light:
        e_busy, e_n, e_prof_ms, events = _profiled_step(
            lambda: eager_step(params, state, batch))
        e_busy = (f"{e_busy:.1f} of {e_prof_ms:.1f}ms = "
                  f"{100 * e_busy / e_prof_ms:.1f}% ({e_n} records)")
    log(f"train {arch} captured vs eager step (CUDA events, one step each, "
        f"B {TRAIN_BATCH} S {TRAIN_SEQ}, the example's step function both): "
        f"captured {g_ms:.2f}ms (the batch's copy and one replay; the "
        f"host's call returns after {host_ms:.2f}ms), eager {e_ms:.2f}ms, "
        f"captured/eager {g_ms / e_ms:.4f}; device busy in one profiled "
        f"step over its own CUDA-event ms: captured {g_busy:.1f} of "
        f"{g_prof_ms:.1f}ms = {100 * g_busy / g_prof_ms:.1f}% ({g_n} "
        f"records with the batch's {n_copies} copies), eager {e_busy}; a "
        f"record the profiler lost only lowers a share; "
        f"capture {capture_ms:.1f}ms host; "
        f"memory: {held_gb:.2f} GB reserved with the graph held (its pool, "
        f"the weights, the optimizer state), peak {peak_gb:.2f} GB allocated "
        f"over the example's run (warm-up and capture), eager step peak "
        f"{eager_gb:.2f} GB allocated, {eager_reserved_gb:.2f} GB reserved; "
        f"{smi}")
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:10]:
        log(f"  {e.self_device_time_total / 1e3:8.2f}ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    if not light:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        step(batch, ev)
        torch.cuda.synchronize()
        fwd, bwd, upd = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
        log(f"train {arch} one step by CUDA events: forward {fwd:.2f}ms, "
            f"backward (remat recompute included) {bwd:.2f}ms, SGD update "
            f"{upd:.2f}ms; {smi}")
    del model, params, state, res, eager_step
    gc.collect()
    torch.cuda.empty_cache()
    return cfg, launches, by_shape


def phase_timing_train(cfg, shape, launches: int, steps: int, errs,
                       smi: str) -> list:
    """K5 at one of ``cfg``'s training forward shapes (B 4, bf16, causal or
    without a mask, statistics written) beside SDPA's forward (grouped,
    ``enable_gqa``, where K/V have fewer heads), with that shape's
    launches in the main path's run; then the plain flash backward at
    that shape beside SDPA's backward (logged, not a kernel row)."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_bwd)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    name = _train_row("flash_attention", cfg, _part(shape))
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    q, k, v, do = _train_qkv(g, shape)
    Sq, Sk, H, K, D, causal = shape
    Bq = q.shape[0]
    scale = D ** -0.5
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    kernel = lambda: flash_ops._flash_cuda(q, k, v, causal, scale, 0,
                                           stats=True)
    (k_ms, lib_ms), how = device_times(
        [kernel, lambda: sdpa(qt, kt, vt, is_causal=causal)], iters=10)
    pairs = Bq * H * flash_ops.causal_pairs(Sq, Sk, causal)
    flops, nbytes = flash_ops.cost(Bq, Sq, Sk, H, K, D, causal, 2,
                                   stats=True)
    row = _row(name, "src/repro_torch/kernels/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/kernel.py:84",
               {name: launches}, errs, k_ms,
               device_ms(lambda: attention_ref(q, k, v, causal=causal),
                         iters=3),
               lib_ms, nbytes, flops)
    what = (f"{cfg.name}'s{_part(shape)} training forward (B {Bq} Sq {Sq} "
            f"Sk {Sk} H {H} K {K} D {D}, {'causal' if causal else 'no mask'}")
    log(f"timing, K5 at {what}, statistics written): {k_ms * 1e3:.1f}us "
        f"device, bound {row['bound_ms'] * 1e3:.2f}us ({row['bound_by']}), "
        f"plain {row['plain_ms'] * 1e3:.1f}us, library {lib_ms * 1e3:.1f}us "
        f"(SDPA forward; kernel and SDPA by the {how}), launches {launches} "
        f"({launches // steps} a step); {smi}")
    out, lse = kernel()
    o = sdpa(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2).contiguous()
    (b_ms, sb_ms), how = device_times(
        [lambda: flash_attention_bwd(q, k, v, out, lse, do, causal=causal),
         lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                     retain_graph=True)], iters=5)
    # q k v out dout dq dk dv, and the statistics
    b_bytes = 2 * (4 * q.numel() + 2 * (k.numel() + v.numel())) + \
        4 * Bq * H * Sq
    b_flops = 5 * 2 * D * pairs                       # S again, dV, dP, dQ, dK
    b_bound = max(b_bytes / HBM_BYTES_PER_S, b_flops / BF16_FLOP_PER_S) * 1e3
    calls = launches // steps // 2
    log(f"timing, the plain flash backward at {what}): {b_ms * 1e3:.1f}us "
        f"device ({calls} calls a step: {b_ms * calls:.1f}ms a step), bound "
        f"{b_bound * 1e3:.2f}us (operations), library {sb_ms * 1e3:.1f}us "
        f"(SDPA backward; both by the {how}); {smi}")
    return [row]


def phase_timing_train_ssd(cfg, launches: int, errs, smi: str) -> list:
    """K8 at one Mamba layer's training shape of ``cfg`` (Bt 4, S 4096,
    as ``phase_timing_ssd`` times the prefill), with the launches of the
    main path's run; then the plain SSD backward, ``SSDScanFn``'s (the
    chunked scan recomputed from the saved inputs and differentiated by
    autograd), at that shape (logged, not a kernel row; no library call
    computes it).  Its bound: the bytes of the operands, y's cotangent
    and the gradients, or twice the forward's products (each product's
    gradient is two products of its size) at the TF32 rate, the plain
    backward's operands being f32, whichever is longer."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd
    from repro_torch.kernels.ssd_scan.ops import flop_parts
    name = _train_row("ssd_scan", cfg)
    rows = phase_timing_ssd({"cfg": cfg}, launches, errs, Bt=TRAIN_BATCH,
                            S=TRAIN_SEQ, name=name)
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    xs = [t.requires_grad_() for t in _ssd_train_operands(g, cfg)]
    y, _ = ssd(*xs, chunk=cfg.ssm_chunk)
    gy = torch.randn(y.shape, generator=g, device="cuda").to(y.dtype)
    bwd = lambda: torch.autograd.grad(y, xs, gy, retain_graph=True)
    b_ms = device_ms(bwd, iters=3, warmup=2)
    Bt, S, H, P = xs[0].shape
    G, N = xs[3].shape[2], xs[3].shape[3]
    Q = min(cfg.ssm_chunk, _ssd_chunk(S))
    b_flops = 2 * sum(flop_parts(Bt, S, H, P, G, N, Q))
    b_bytes = 2 * sum(t.numel() * t.element_size() for t in xs) + \
        y.numel() * y.element_size()
    b_bound = max(b_bytes / HBM_BYTES_PER_S, b_flops / TF32_FLOP_PER_S) * 1e3
    per_step = launches // TRAIN_STEPS // 2
    log(f"timing, the plain SSD backward (SSDScanFn's) at {cfg.name}'s "
        f"training shape (Bt {Bt} S {S} H {H} P {P} N {N} Q {Q}): "
        f"{b_ms * 1e3:.1f}us device (once per Mamba layer: "
        f"{b_ms * per_step:.1f}ms a step), bound {b_bound * 1e3:.2f}us "
        f"({'operations' if b_flops / TF32_FLOP_PER_S >= b_bytes / HBM_BYTES_PER_S else 'bytes'}: "
        f"{b_flops / 1e9:.2f} GFLOP at the TF32 rate, {b_bytes / 1e6:.1f} MB), "
        f"library none; {smi}")
    del xs, y
    torch.cuda.empty_cache()
    return rows


def phase_gqa(arch: str, errs) -> list:
    """Phase 14 for one grouped-query decoder: its main path with exact
    launch counts, the graphed loop against the eager loop, the logits
    against the plain path and sublayer by sublayer, K5 and K6 at its
    shapes beside SDPA, the warm decode loop, the weights widened to f32
    (once its graphs are closed); then the model leaves the card.
    Returns its timing rows."""
    t0 = time.perf_counter()
    res, launches = phase_serve(arch)
    phase_graph_hold(res)
    plain_logits = phase_reference(res)
    phase_sublayers(res)
    rows = phase_timing(res, launches, errs)
    phase_warm_serve(res)
    close_graphs(res)         # room for the f32 copy beside the bf16 one
    phase_f32_witness(res, plain_logits)
    del plain_logits
    free_model(res)
    log(f"gqa {arch}: {time.perf_counter() - t0:.1f}s")
    return rows


def family_params(cfg) -> int:
    """The parameters a family-17 model holds: internvl2-2b exactly
    ``param_count()``; whisper-tiny's count leaves out the learned positions
    it counts (both packages' are sinusoidal) and adds the output and MLP
    biases and the encoder's ``ln_post`` that it does not count."""
    if cfg.family != "encdec":
        return cfg.param_count()
    d, mlp = cfg.d_model, cfg.d_ff + cfg.d_model
    return (cfg.param_count()
            - (cfg.n_frames + cfg.max_decoder_positions()) * d
            + cfg.n_enc_layers * (d + mlp) + cfg.n_layers * (2 * d + mlp)
            + 2 * d)


def family_shapes(cfg) -> tuple:
    """The K5 calls of one prefill and the K6 calls of one decode step, by
    the wrappers' launch keys ((Sq, Sk, H, K, D, causal) and (S, H, K, D))
    with their counts.  whisper-tiny: the encoder's self-attention without
    a mask over the frames, the decoder's causal self-attention and its
    cross-attention (Sq = the prompt, Sk = the frames) in each layer; each
    decode step self- and cross-attention (every sequence at all n_frames)
    in each decoder layer.  internvl2-2b: one causal self-attention per
    layer over the patches and the prompt; one K6 call per layer and
    step."""
    H, K, D, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    S = cache_len(cfg) - NEW_TOKENS                    # prefix + prompt
    if cfg.family == "encdec":
        F = cfg.n_frames
        return ({(F, F, H, K, D, False): cfg.n_enc_layers,
                 (S, S, H, K, D, True): L, (S, F, H, K, D, False): L},
                {(cache_len(cfg), H, K, D): L, (F, H, K, D): L})
    return {(S, S, H, K, D, True): L}, {(cache_len(cfg), H, K, D): L}


def phase_family_serve(arch: str) -> tuple:
    """The launcher's main path on whisper-tiny or internvl2-2b at full
    width (bf16, random weights from the seed; batch 4, prompt 512, 32 new
    tokens, with the launcher's frames or patch embeddings), counters
    zeroed just before: K5 and K6 held exactly, in all and by shape
    (``family_shapes``), the warm-up's one prefill and one decode step
    apart; the drawn parameters counted (``family_params``).  Returns the
    run and the loop's launches by kernel and by shape."""
    import torch
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve
    log(f"families: {arch} full width, bf16, batch {BATCH}, prompt {PROMPT}, "
        f"{NEW_TOKENS} new tokens")
    reset_launches()
    res = serve.main(["--arch", arch, "--batch", str(BATCH), "--prompt-len",
                      str(PROMPT), "--new-tokens", str(NEW_TOKENS),
                      "--device", "cuda", "--seed", str(SEED)],
                     keep_logits=True)
    cfg, graphs = res["cfg"], res["graphs"]
    prefill, step = family_shapes(cfg)
    n5, n6 = sum(prefill.values()), sum(step.values())
    want = {k: 0 for k in launch_counters()}
    want.update({"flash_attention": n5,
                 "decode_attention": n6 * (NEW_TOKENS - 1)})
    launches = split_launches(res, want, warmup_launches(
        want, {"flash_attention": n5}))
    by_shape = {}
    for c, per_call, calls in ((flash_ops.LAUNCHES, prefill, 1),
                               (decode_ops.LAUNCHES, step, NEW_TOKENS - 1)):
        warm = graphs.warmup_launches.by_key(c)
        loop = {k: n - warm.get(k, 0) for k, n in c.by_key().items()}
        want_loop = {k: n * calls for k, n in per_call.items()}
        log(f"  launches by shape {loop} (expected {want_loop}); of the "
            f"warm-up {warm} (expected {per_call})")
        if loop != want_loop or warm != per_call:
            raise AssertionError(f"launches by shape {loop}, warm-up {warm}")
        by_shape.update(loop)
    extra = res["extra"]
    want_extra = res["model"].extra_shape(BATCH)
    if tuple(extra.shape) != want_extra or extra.dtype != torch.bfloat16:
        raise AssertionError(f"extra input {tuple(extra.shape)} "
                             f"{extra.dtype}, expected {want_extra} bf16")
    gen, logits = res["gen"], res["logits"]
    if tuple(gen.shape) != (BATCH, NEW_TOKENS) or len(logits) != NEW_TOKENS:
        raise AssertionError(f"generated {tuple(gen.shape)}, "
                             f"{len(logits)} logits")
    for i, lg in enumerate(logits):
        if tuple(lg.shape) != (BATCH, cfg.vocab_size) or \
                not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"step {i}: bad logits {tuple(lg.shape)}")
    if not bool(((gen >= 0) & (gen < cfg.vocab_size)).all()):
        raise AssertionError("generated ids out of the vocabulary")
    n_params = sum(p.numel() for p in res["params"].parameters())
    if n_params != family_params(cfg) or \
            res["params"].embed.dtype != torch.bfloat16:
        raise AssertionError(f"{n_params} parameters, expected "
                             f"{family_params(cfg)}, or not bf16")
    log(f"  {n_params / 1e6:.1f}M parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB on the card); "
        f"prefill {res['prefill_s'] * 1e3:.2f}ms, decode "
        f"{res['decode_s'] * 1e3:.2f}ms (first run: "
        f"{BATCH * (NEW_TOKENS - 1) / res['decode_s']:.1f} tok/s)")
    return res, launches, by_shape


def phase_timing_family(res, by_shape, errs) -> list:
    """K5 at every prefill shape and K6 at every decode shape of a family-17
    model, beside SDPA, each row with its launches from the main path."""
    import torch
    cfg = res["cfg"]
    prefill, step = family_shapes(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    rows = []
    for (Sq, Sk, H, K, D, causal) in prefill:
        part = ("" if causal else " encoder" if Sq == Sk else " cross")
        name = f"flash_attention[{cfg.name}{part}]"
        row, back_to_back, how, note = _flash_row(
            name, BATCH, Sq, H, K, D,
            {name: by_shape[(Sq, Sk, H, K, D, causal)]}, errs, g, Sk=Sk,
            causal=causal)
        _log_flash_row(row, back_to_back, how, f"{cfg.name}'s{part or ''} "
                       f"prefill (B {BATCH} Sq {Sq} Sk {Sk} H {H} K {K} D {D}"
                       f"{'' if causal else ', no mask'})", note)
        rows.append(row)
    for (S, H, K, D) in step:
        full = S == cfg.n_frames and cfg.family == "encdec"
        name = f"decode_attention[{cfg.name}{' cross' if full else ''}]"
        row, back_to_back, how, per_call, note = _decode_row(
            name, BATCH, S, H, K, D, {name: by_shape[(S, H, K, D)]}, errs, g,
            full=full)
        log(f"timing, K6 at {cfg.name}'s last decode step{' (cross)' if full else ''} "
            f"(B {BATCH} S {S} H {H} K {K} D {D}, {S if full else S - 1} "
            f"valid): {row['ms'] * 1e3:.2f}us device, "
            f"{back_to_back * 1e3:.1f}us back-to-back, bound "
            f"{row['bound_ms'] * 1e3:.2f}us ({row['bound_by']}), plain "
            f"{row['plain_ms'] * 1e3:.1f}us, library "
            f"{row['library_ms'] * 1e3:.2f}us (SDPA, masked; kernel and SDPA "
            f"by the {how}), launches {row['launches']}; kernels per call: "
            f"{per_call}{note}")
        rows.append(row)
    return rows


def phase_family(arch: str, errs) -> list:
    """Phase 17 for whisper-tiny or internvl2-2b: its main path with exact
    launch counts, the graphed loop against the eager loop, the logits
    against the plain path (held, or reported per LOGITS_HELD), every K5
    and K6 call sublayer by sublayer, K5 and K6 at its shapes beside SDPA,
    the warm loop, the weights widened to f32; then the model leaves the
    card.  Returns its timing rows."""
    t0 = time.perf_counter()
    res, _, by_shape = phase_family_serve(arch)
    phase_graph_hold(res)
    plain_logits = phase_reference(res)
    phase_sublayers(res)
    rows = phase_timing_family(res, by_shape, errs)
    phase_warm_serve(res)
    close_graphs(res)
    phase_f32_witness(res, plain_logits)
    del plain_logits
    free_model(res)
    log(f"families {arch}: {time.perf_counter() - t0:.1f}s")
    return rows


def phase_training(spec: tuple, errs, smi: str, light: bool = False) -> list:
    """The training phase of one architecture, ``spec`` an entry of
    ``TRAIN_ARCHS`` or ``FAMILY_TRAIN_ARCHS``, at full width and the
    spec's depth: the kernels' training parity at each of its shapes, the
    kernel-path holds, the main path's run (``light``: see
    ``phase_train``) and its kernels' training rows, one per K5 shape."""
    from repro_torch.configs import get_config
    arch, steps, layers = spec
    cfg = get_config(arch)
    if layers:
        log(f"train: {arch} at full width on its first {layers} of "
            f"{cfg.n_layers} layers (phase 20 trains granite-3-8b's same "
            f"attention shape at full depth)")
        cfg = cfg.with_overrides(n_layers=layers)
    for shape in train_shapes(cfg):
        errs.update(phase_train_parity(
            cfg, shape, _train_row("flash_attention", cfg, _part(shape))))
    if cfg.ssm_state:
        errs.update(phase_train_parity_ssd(cfg))
    phase_train_holds(cfg)
    phase_train_graph_hold(cfg)
    cfg, launches, by_shape = phase_train(smi, cfg, steps, light)
    rows = []
    for shape, n in by_shape.items():
        rows += phase_timing_train(cfg, shape, n, steps, errs, smi)
    if launches["ssd_scan"]:
        rows += phase_timing_train_ssd(cfg, launches["ssd_scan"], errs, smi)
    return rows


def phase_train_fixed_batch(smi: str) -> None:
    """The reference's ``test_train_lm_loss_decreases`` at full width:
    qwen1.5-0.5b (random weights, seed 0) through the example's step
    (``make_step``) captured on the card (``train_graphs.for_device``),
    ``FIXED_BATCH_STEPS`` steps on one batch (``make_batch``'s step 0 each
    step, B 4, S 4096) with SGD at the constant learning rate
    ``FIXED_BATCH_LR``: every loss finite and the last below the first.
    The drop is reported beside the reference test's margin of 0.5 nats
    (which that test holds at the smoke config and lr 0.3)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train_graphs
    from repro_torch.models import ExecConfig, build_model
    from repro_torch.models.weights import trainable
    from repro_torch.optim import SGD
    sys.path.insert(0, str(ROOT / "examples"))
    import train_lm_torch as twin
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, ExecConfig(loss_chunk=min(TRAIN_SEQ, 128)))
    opt = SGD(lr=FIXED_BATCH_LR)
    params = trainable(model.init(
        torch.Generator(device="cuda").manual_seed(0), "cuda"))
    state = opt.init(params)
    step = train_graphs.for_device(twin.make_step(model, opt), "cuda")
    batch = _train_batch(cfg, 0)
    losses = []
    for _ in range(FIXED_BATCH_STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    replays = step.replays
    step.close()
    losses = [float(x) for x in losses]
    del step, params, state, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train {ARCH} on one fixed batch (make_batch step 0, B "
        f"{TRAIN_BATCH} S {TRAIN_SEQ}), {FIXED_BATCH_STEPS} steps of SGD at "
        f"a constant lr {FIXED_BATCH_LR} through the example's captured step "
        f"({replays} replays): loss {losses[0]:.5f} -> {losses[-1]:.5f}, a "
        f"drop of {losses[0] - losses[-1]:.5f} nats (the reference test's "
        f"margin: 0.5 at its smoke config, lr 0.3); every 5th: "
        f"{[round(x, 5) for x in losses[::5]]}; "
        f"{time.perf_counter() - t0:.1f}s; {smi}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"fixed-batch losses {losses}")


def phase_train_large(spec: tuple, errs, smi: str) -> list:
    """Phase 20 for one of ``GQA_TRAIN_ARCHS`` at full width and depth:
    K5's training parity and ``FlashAttentionFn``'s gradients at its
    attention shape; the kernel path against the plain path in bf16 at
    full depth, and the f32 witness on its first ``F32_HOLD_LAYERS``
    layers (``phase_train_holds``); the captured step bitwise against the
    eager step; the main path's run (``phase_train``, light) and its K5
    training row, unless another architecture's row times the same
    shape."""
    from repro_torch.configs import get_config
    arch, steps, row_of = spec
    cfg = get_config(arch)
    t0 = time.perf_counter()
    for shape in train_shapes(cfg):
        err = phase_train_parity(cfg, shape, _train_row("flash_attention",
                                                        cfg))
        if row_of is None:
            errs.update(err)
    phase_train_holds(cfg, f32_layers=F32_HOLD_LAYERS)
    phase_train_graph_hold(cfg)
    cfg, _, by_shape = phase_train(smi, cfg, steps, light=True)
    rows = []
    for shape, n in by_shape.items():
        if row_of is None:
            rows += phase_timing_train(cfg, shape, n, steps, errs, smi)
        else:
            log(f"timing: K5's training row at {arch}'s shape {shape} is "
                f"{row_of}'s ({_train_row('flash_attention', get_config(row_of))}"
                f", the same operands): no second row; its launches in "
                f"this run {n} ({n // steps} a step)")
    log(f"train {arch}: phase 20 took {time.perf_counter() - t0:.1f}s")
    return rows


MEASURED: dict = {}     # phase 15's step ms, peak GB, model FLOPs by arch
# phase 19: the dry-run's cells on the production meshes, (shape, multi-pod)
MESH_CELLS = (("train_4k", False), ("train_4k", True), ("decode_32k", False))


def start_mesh_dryrun() -> tuple:
    """Phase 19a, started: the dry-run (``repro_torch.launch.dryrun``) of
    qwen1.5-0.5b's train_4k on pod16x16 and pod2x16x16 and its decode_32k
    on pod16x16, each cell in a process of its own over torch's fake
    process group (256 or 512 ranks that exist as a world size only),
    the three at once and beside phases 19b and 19c.  Returns (the
    artifacts' directory, the processes)."""
    import os
    import tempfile
    out = tempfile.mkdtemp(prefix="dryrun_torch_")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return out, [(shape, multi, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", shape, "--mesh", "multi" if multi else "single",
         "--out", out, "--force"], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for shape, multi in MESH_CELLS]


def phase_mesh_dryrun(started: tuple) -> None:
    """Phase 19a, read: each cell must come back ``ok`` with FLOPs per
    device above 0, the multi-pod train cell with collective bytes above
    0; each cell's roofline line is printed.  These are counts at the
    H100's data-sheet constants, not times."""
    out, procs = started
    try:
        _read_mesh_cells(out, procs)
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _read_mesh_cells(out: str, procs) -> None:
    for shape, multi, proc in procs:
        _, err = proc.communicate(timeout=300)
        mesh = "pod2x16x16" if multi else "pod16x16"
        path = Path(out) / mesh / f"{ARCH}__{shape}.json"
        if proc.returncode or not path.exists():
            raise AssertionError(f"dry-run {mesh} {shape}: rc "
                                 f"{proc.returncode}: {err[-2000:]}")
        rec = json.loads(path.read_text())
        if rec["status"] != "ok" or not rec["flops_per_device"] > 0:
            raise AssertionError(f"dry-run {mesh} {shape}: {rec.get('error', rec)}")
        if multi and not rec["collective_bytes_per_device"] > 0:
            raise AssertionError(f"dry-run {mesh} {shape}: no collective bytes")
        r = rec["roofline"]
        log(f"mesh, dry-run (counts at H100 constants, fake group of "
            f"{rec['n_devices']} ranks) {mesh} {ARCH} {shape}: FLOPs/device "
            f"{rec['flops_per_device']:.4g}, bytes/device "
            f"{rec['bytes_per_device']:.4g}, collective bytes/device "
            f"{rec['collective_bytes_per_device']:.4g} "
            f"{rec['collectives']['counts']}, peak {rec['memory']['peak_bytes'] / 1e9:.2f} GB; "
            f"T_compute {r['t_compute_s'] * 1e3:.3f} ms, T_memory "
            f"{r['t_memory_s'] * 1e3:.3f} ms, T_collective "
            f"{r['t_collective_s'] * 1e3:.3f} ms, {r['dominant']}, useful "
            f"{r['useful_flops_ratio']:.3f}; traced in {rec['trace_s']} s")


def phase_mesh_count(smi: str) -> None:
    """Phase 19b: the counter (``distributed/cost_analysis.py``) over
    qwen1.5-0.5b's train step at phase 15's shape (B 4, S 4,096, remat
    full, loss chunks of 128, SGD; one device, the kernel route, fake
    tensors): K5 counted exactly 48 times a step (phase 15's held
    launches) and the counted FLOPs no fewer than 6 N T.  Printed beside
    phase 15's measured step (no second timed step): the FLOPs, bytes,
    the bound max(FLOPs / 989e12, bytes / 3.35e12), measured over bound,
    the counted FLOPs beside ``train_mfu``'s formula, and the estimated
    peak memory beside phase 15's."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import count_step
    from repro_torch.models import ExecConfig, build_model
    from repro_torch.optim import SGD
    cfg = get_config(ARCH)
    shape = ShapeConfig("train_b4", "train", TRAIN_SEQ, TRAIN_BATCH)
    model = build_model(cfg, ExecConfig(loss_chunk=min(TRAIN_SEQ, 128)))
    t0 = time.perf_counter()
    costs, arg_bytes, _ = count_step(model, None, shape, SGD(lr=0.05))
    n = cfg.param_count()
    floor = 6 * n * TRAIN_BATCH * TRAIN_SEQ
    k5 = costs.kernels.get("flash_attention", 0)
    want = 2 * cfg.n_layers
    if k5 != want or costs.kernels.keys() - {"flash_attention"}:
        raise AssertionError(f"counted kernel calls {costs.kernels}; K5 must "
                             f"be {want} a step and nothing else")
    if costs.flops < floor:
        raise AssertionError(f"counted {costs.flops:.4g} FLOPs under 6 N T "
                             f"= {floor:.4g}")
    bound_s = max(costs.flops / BF16_FLOP_PER_S, costs.bytes / HBM_BYTES_PER_S)
    got = MEASURED.get(ARCH)
    seen = ("phase 15 not run in this mode" if got is None else
            f"phase 15's step {got['step_ms']:.2f} ms = "
            f"{got['step_ms'] / 1e3 / bound_s:.2f}x the bound; its "
            f"train_mfu formula {got['model_flops'] / 1e12:.2f} TFLOP "
            f"(counted / formula {costs.flops / got['model_flops']:.3f}); "
            f"peak {got['peak_gb']:.2f} GB measured above the weights")
    log(f"mesh, counter over {ARCH}'s train step (B {TRAIN_BATCH} S "
        f"{TRAIN_SEQ}, one device, kernel route; traced in "
        f"{time.perf_counter() - t0:.1f} s): K5 {k5} a step (held), "
        f"{costs.flops / 1e12:.3f} TFLOP counted >= 6 N T "
        f"{floor / 1e12:.3f} (held), {costs.bytes / 1e9:.2f} GB moved, bound "
        f"{bound_s * 1e3:.2f} ms ({'operations' if costs.flops / BF16_FLOP_PER_S >= costs.bytes / HBM_BYTES_PER_S else 'bytes'}); "
        f"estimated peak {costs.peak_bytes / 1e9:.2f} GB above the "
        f"{arg_bytes / 1e9:.2f} GB of arguments; {seen}; {smi}")


class _GradTap:
    """An optimizer that keeps the gradients it is handed (a copy) and
    applies the wrapped optimizer's update."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return self.opt.update(grads, state, params)


def phase_mesh_step() -> None:
    """Phase 19c: a train step through a mesh on the card.  A 1-rank NCCL
    group and a 1-device CUDA ``DeviceMesh`` of axes (data, model);
    qwen1.5-0.5b at full width, its weights drawn from the seed and taken
    to the host in the reference's layout (``weights.to_jax_params``),
    placed from those host leaves by ``distributed.elastic.
    reshard_params`` under ``ShardingRules`` on the mesh; one SGD step
    through ``launch/steps.py::make_step_for_shape`` at phase 15's shape,
    every counter zeroed just before: K5 exactly 48 launches and no other
    kernel; the loss, every gradient leaf and every updated parameter
    bitwise equal to one step of ``make_train_step`` on plain tensors from
    the same host leaves and batch; ``to_host`` of the placed parameters
    bitwise the host leaves.  The group is torn down after."""
    import socket
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.elastic import reshard_params, to_host
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_step_for_shape, make_train_step
    from repro_torch.models import ExecConfig, build_model
    from repro_torch.models.weights import (from_jax_params, to_jax_params,
                                            trainable)
    from repro_torch.optim import SGD
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        cfg = get_config(ARCH)
        shape = ShapeConfig("train_b4", "train", TRAIN_SEQ, TRAIN_BATCH)
        model = build_model(cfg, ExecConfig(loss_chunk=min(TRAIN_SEQ, 128)))
        host = to_jax_params(model.init(
            torch.Generator(device="cuda").manual_seed(SEED)), cfg)
        mesh = make_mesh((1, 1), ("data", "model"))
        rules = ShardingRules(mesh, cfg)
        placed = trainable(reshard_params(host, cfg, mesh, rules=rules))
        back = to_host(placed)
        bad = [k for k, a, b in _host_pairs(host, back) if not a == b]
        if bad:
            raise AssertionError(f"to_host of the placed parameters differs "
                                 f"from the host leaves at {bad[:4]}")
        batch = _train_batch(cfg, 0)
        tap = _GradTap(SGD(lr=0.05))
        step, _ = make_step_for_shape(model, rules, shape, optimizer=tap)
        reset_launches()
        _, _, metrics = step(placed, tap.init(placed), batch)
        torch.cuda.synchronize()
        launches = read_launches()
        want = {k: 0 for k in launches}
        want["flash_attention"] = 2 * cfg.n_layers
        if launches != want:
            raise AssertionError(f"mesh step launches {launches}, expected "
                                 f"{want}")
        mesh_grads = {k: g.to_local() for k, g in tap.grads.items()}
        plain = trainable(from_jax_params(host, cfg, "cuda"))
        ptap = _GradTap(SGD(lr=0.05))
        _, _, pmetrics = make_train_step(model, ptap, shape)(
            plain, ptap.init(plain), batch)
        torch.cuda.synchronize()
        diff = [n for n in mesh_grads
                if not torch.equal(mesh_grads[n], ptap.grads[n])]
        diff += [n for (n, a), b in zip(placed.named_parameters(),
                                        plain.parameters())
                 if not torch.equal(a.to_local(), b)]
        if not torch.equal(metrics["loss"], pmetrics["loss"]) or diff:
            raise AssertionError(
                f"mesh step vs plain step: loss {float(metrics['loss'])} vs "
                f"{float(pmetrics['loss'])}; leaves apart: {diff[:6]}")
        log(f"mesh, one SGD step of {ARCH} at full width through a 1-device "
            f"CUDA mesh (data 1 x model 1, NCCL): K5 {launches['flash_attention']} "
            f"launches (held), loss {float(metrics['loss']):.5f} and all "
            f"{len(mesh_grads)} gradient leaves and updated parameters "
            f"bitwise the plain-tensor step's; to_host bitwise the host "
            f"leaves")
        del placed, plain, mesh_grads, tap, ptap
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()


def _host_pairs(a, b, path=""):
    """(path, leaf of a's bytes, leaf of b's bytes) over two host trees in
    the reference's layout."""
    import numpy as np
    if isinstance(a, dict):
        for k in a:
            yield from _host_pairs(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _host_pairs(x, y, f"{path}[{i}]")
    else:
        raw = lambda t: np.asarray(getattr(t, "bits", t)).tobytes()
        yield path, raw(a), raw(b)


def phase_mesh(smi: str) -> None:
    """Phase 19: the dry-run's production meshes (a, in processes of their
    own while b and c run), the counter beside phase 15's step (b), a
    train step through a 1-device mesh (c)."""
    t0 = time.perf_counter()
    started = start_mesh_dryrun()
    try:
        phase_mesh_count(smi)
        phase_mesh_step()
    except BaseException:
        for *_, proc in started[1]:          # stop what the phase started
            proc.kill()
            proc.wait()
        raise
    phase_mesh_dryrun(started)
    log(f"mesh: phase 19 took {time.perf_counter() - t0:.1f}s")


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run it from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    mode = argv[0] if argv else None
    if mode not in (None, "parity", "flash", "gmm", "decode", "ssd",
                    "profile", "fanout", "train", "trainfam", "traingqa",
                    "gqa", "paper", "families", "chaos",
                    "mesh") or len(argv) > 1:
        print(f"chip_smoke: arguments {argv}: none, or one of parity, flash, "
              f"gmm, decode, ssd, profile, fanout, train, trainfam, "
              f"traingqa, gqa, paper, families, chaos, mesh", file=sys.stderr)
        return 2
    parity_only = mode == "parity"        # a new kernel's first, short run
    flash_only = mode == "flash"          # K5 alone: A/B of its designs
    gmm_only = mode == "gmm"              # K7 alone: A/B of its designs
    t0 = time.perf_counter()
    smi = nvidia_smi()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")
    # K6 or K8 alone, and the profile, through the public entry points
    # only (kernels build at first use), so that a copy of this script run
    # from an earlier checkout measures that checkout's kernels
    if mode == "profile":
        phase_profile()
        log(smi)
        return 0
    if mode == "decode":
        phase_parity()
        phase_decode_ab()
        log(smi)
        return 0
    if mode == "ssd":
        phase_parity_ssd()
        phase_ssd_ab()
        log(smi)
        return 0
    phase_build()
    errs = phase_parity()
    if flash_only:
        from repro_torch.configs import get_config
        for arch in (ARCH, MOE_ARCH, SSM_ARCHS[1], GQA_ARCHS[0],
                     GQA_ARCHS[2]):
            phase_timing_flash({"cfg": get_config(arch)}, 0, errs)
        phase_timing_fanout_flash(0, errs)
        log(smi)
        return 0
    if mode == "gqa":                     # the grouped-query decoders alone
        rows = [r for arch in GQA_ARCHS for r in phase_gqa(arch, errs)]
        print(json.dumps({"kernels": rows}), flush=True)
        log(f"chip_smoke: {time.perf_counter() - t0:.1f}s")
        log(smi)
        return 0
    if mode == "families":                # whisper-tiny, internvl2-2b alone
        rows = [r for arch in FAMILY_ARCHS for r in phase_family(arch, errs)]
        print(json.dumps({"kernels": rows}), flush=True)
        log(f"chip_smoke: {time.perf_counter() - t0:.1f}s")
        log(smi)
        return 0
    if mode == "mesh":                    # phase 19 alone
        phase_mesh(smi)
        log(f"chip_smoke: {time.perf_counter() - t0:.1f}s")
        log(smi)
        return 0
    if mode == "train":                   # the training paths alone
        for spec in TRAIN_ARCHS:
            phase_training(spec, errs, smi, light=spec[0] != ARCH)
        log(smi)
        return 0
    if mode == "trainfam":                # phase 18 alone
        rows = [r for spec in FAMILY_TRAIN_ARCHS
                for r in phase_training(spec, errs, smi, light=True)]
        print(json.dumps({"kernels": rows}), flush=True)
        log(f"chip_smoke: {time.perf_counter() - t0:.1f}s")
        log(smi)
        return 0
    if mode == "traingqa":                # phase 20 alone
        phase_train_fixed_batch(smi)
        rows = [r for spec in GQA_TRAIN_ARCHS
                for r in phase_train_large(spec, errs, smi)]
        print(json.dumps({"kernels": rows}), flush=True)
        log(f"chip_smoke: {time.perf_counter() - t0:.1f}s")
        log(smi)
        return 0
    if gmm_only:
        errs.update(phase_parity_gmm())
        phase_gmm_ab(errs)
        log(smi)
        return 0
    if mode == "fanout":                  # the fan-outs and Fig. 7 alone
        errs.update(phase_parity_ssd())
        qwen = phase_fanout(ARCH)[1]
        ssm = phase_fanout(SSM_ARCHS[0])[1]
        hybrid = phase_fanout(SSM_ARCHS[1])
        phase_fig7()
        phase_timing_fanout(qwen, ssm, hybrid, errs)
        log(f"chip_smoke: {time.perf_counter() - t0:.1f}s")
        log(smi)
        return 0
    errs.update(phase_parity_state_push())
    if mode == "chaos":                   # the chaos scenarios alone
        phase_chaos()
        log(f"chip_smoke: {time.perf_counter() - t0:.1f}s")
        log(smi)
        return 0
    if mode == "paper":                   # the paper's experiments alone
        phase_paper()
        log(f"chip_smoke: {time.perf_counter() - t0:.1f}s")
        log(smi)
        return 0
    errs.update(phase_parity_gmm())
    errs.update(phase_parity_ssd())
    if parity_only:
        return 0
    res, launches = phase_serve()
    phase_graph_hold(res)
    phase_reference(res)
    _, fanout_launches = phase_fanout(ARCH)
    _, ssm_fanout_launches = phase_fanout(SSM_ARCHS[0])
    hybrid = phase_fanout(SSM_ARCHS[1])
    phase_fig7()
    plane_launches = phase_device_plane()
    paper_launches = phase_paper()
    chaos_launches = phase_chaos()
    # each kernel's launches from the runs of its paths: K5/K6 the serve
    # loop, K1 the three fan-outs, the paper and the chaos phases, K2 the
    # device plane, the paper phase (its Fig. 9 twin) and the chaos
    # phase, K3 the Fig. 9 twin alone; K4 (the fp8 wire tier, which needs
    # ml_dtypes) is on no path
    fanouts = (fanout_launches, ssm_fanout_launches, hybrid[1])
    for key, parts in (("state_push.quantize_delta",
                        fanouts + (paper_launches, chaos_launches)),
                       ("state_push.apply_delta", (plane_launches,
                                                   paper_launches,
                                                   chaos_launches)),
                       ("state_push.push", (paper_launches,))):
        launches[key] = sum(p.get(key, 0) for p in parts)
    rows = phase_timing(res, launches, errs)
    rows += phase_timing_fanout(fanout_launches, ssm_fanout_launches, hybrid,
                                errs)
    rows += phase_timing_state_push(launches, errs)
    phase_warm_serve(res)
    free_model(res)               # the qwen model leaves the card
    moe_res, moe_launches = phase_moe_serve()
    routes = phase_graph_hold(moe_res, record_routes=True)
    phase_moe_reference(moe_res, routes)
    del routes
    rows += phase_timing_gmm(moe_res, moe_launches, errs)
    rows += phase_timing_flash(moe_res, moe_launches["flash_attention"], errs)
    rows += phase_timing_decode(moe_res, moe_launches["decode_attention"],
                                errs)
    phase_warm_serve(moe_res)
    free_model(moe_res)           # the MoE model leaves the card
    for arch in SSM_ARCHS:
        res, ssm_launches = phase_ssm_serve(arch)
        phase_graph_hold(res)
        phase_ssm_witnesses(res, phase_reference(res))
        phase_sublayers(res)
        # one SSM model on the card at a time: time and profile it now
        rows += phase_timing_ssd(res, ssm_launches["ssd_scan"], errs)
        if ssm_launches["flash_attention"]:      # the hybrid's shared block
            rows += phase_timing_flash(res, ssm_launches["flash_attention"],
                                       errs)
            rows += phase_timing_decode(res, ssm_launches["decode_attention"],
                                        errs)
        phase_warm_serve(res)
        free_model(res)
    for arch in GQA_ARCHS:        # one at a time, each freed after its phase
        rows += phase_gqa(arch, errs)
    for arch in FAMILY_ARCHS:     # the same, the encoder/decoder and the VLM
        rows += phase_family(arch, errs)
    for spec in TRAIN_ARCHS:                         # phases 15 and 16
        rows += phase_training(spec, errs, smi, light=spec[0] != ARCH)
    for spec in FAMILY_TRAIN_ARCHS:                  # phase 18
        rows += phase_training(spec, errs, smi, light=True)
    phase_train_fixed_batch(smi)                     # phase 20
    for spec in GQA_TRAIN_ARCHS:
        rows += phase_train_large(spec, errs, smi)
    phase_mesh(smi)                                  # phase 19
    log(f"chip_smoke: {time.perf_counter() - t0:.1f}s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
