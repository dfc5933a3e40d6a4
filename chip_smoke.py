#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device and build: print the card's name and power limit, build the
   port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per source,
   in parallel), TF32 off for PyTorch's own products; print ptxas's
   registers and spills for the bf16 K2 kernels, K11's paged kernels
   (a spill there fails; head dims 64, 80 and 128) and the K10 kernels
   (its split pass too) and
   count the HGMMA instructions of all three with ``cuobjdump``, where the
   toolkit has it (a count of 0 fails);
2. every kernel against its plain PyTorch version on the card, at the main
   paths' shapes and at edge shapes (K1, K3-K9 bitwise; K2 to 2e-5 in f32
   and 2e-2 in bf16, the reference's tolerances, in bf16 over S from 1 to
   4096, head dims 64, 80 and 128 and head ratios 1, 4 and 8, and bitwise
   to itself run to run and across batch positions, with a NaN neighbour
   batch; K2 at head dim 80 again at zamba2's prefill shape, q, k and v
   (1, 512, 32, 80), in f32 and bf16, bitwise run to run, in a row of its
   own beside SDPA; K10 to 2e-5 on acc/l, m
   and l, its arithmetic being f32 whatever the input type, acc itself
   being a sum over up to 4096 keys, at eleven edge shapes in f32 and
   bf16, bitwise run to run, its split pass bitwise to the split's plain
   version; K3 at the main shape with the numpy table the serving path
   passes, under PyTorch's sync debug mode set to raise, so the call is
   shown to make no device sync, with a card-table call as the control
   that the mode sees one, then at six edge shapes with host and card
   tables, and an out-of-range host table refused before any launch),
   each timed with CUDA events beside
   its plain version and one PyTorch call computing the same function
   (timed only; the port never calls it).  The ring kernels K4-K8 run at
   2, 4 and 8 PEs, chunk lengths 1, 127, 5157 and the main shapes, every
   dtype each takes, roots 0, 3 and 7 and offsets 1 and 3, each check 20
   times over to catch ordering races, with every new output and flag
   block poisoned (NaN or the integer maximum) so that a stale read
   cannot find an earlier run's equal value; K8 also over 800 calls whose
   PE count changes every call (its counters persist across calls).  The bounds count each input
   read once and each output written once, and for K10 only the unmasked
   products, three TF32 products each at 495 TFLOP/s (its row also
   carries the f32 FMA bound and the split pass's time).  Rows also carry
   ``device_ms``, the device-only duration from ``torch.profiler``, and
   ``library_device_ms``, the library call's (K1 and ``copy_`` per store
   over the same 32-offset loop, K2 and SDPA at both K2 shapes, K3 and
   ``index_select``, K4 at a small chunk and at its main shape beside
   ``torch.roll``, K5 and ``expand`` + ``contiguous``, K6 and
   ``x.sum(0)``, K7 and ``expand_as`` + ``contiguous``, K8 (every device
   operation of one call, and its kernel alone) beside an empty
   cooperative launch, K9 and
   ``rows.sum(0)``, K10 at both ring shapes and its split pass; K7 also
   summed over one run of phase 4's broadcasts), measured after phase 6
   so that the profiler's hooks cannot slow the timed phases.  K1's row
   also carries the host cost of a call of its entry point that stores 0
   bytes (``cudaSetDevice``, then return) beside the same arguments into
   a function that makes no CUDA call;
3. the serving path: ``repro_torch.launch.serve --disagg --full``, qwen3-4b at
   its published widths and depth, 2 prefill + 2 decode PEs, 8 requests of
   512 tokens, 16 new tokens each, 3 slots per decode PE, 256 KV blocks of
   16 tokens.  Launch counts are zeroed just before and read just after;
   every kernel must have launched.  Every request's greedy tokens must
   equal, bitwise, the port's own single-PE baseline at the same shapes
   (``Engine.generate_in_slot``), and the scheduler's counters must balance;
4. the collectives path: ``repro_torch.launch.shmem_collectives --full``
   on 8 PEs at qwen3-4b's published widths, in f32 (the example's four
   steps, the tensor-parallel MLP at prefill and decode shapes against the
   engine backend and the unsharded MLP, the logits reduce, the bf16 layer
   broadcast, the hidden ppermute, and the ``Ishmem`` facade on a heap
   holding one bf16 MLP weight).  Launch counts are zeroed just before and
   read just after; K4-K8 must each have launched;
5. the fused serving path: phase 3's run with ``--fused-attn`` (per-block
   migration signals, first-block admission, per-block device waits before
   each decode step).  Launch counts zeroed before; K1-K3 must launch.
   Every request's tokens must equal phase 3's and the single-PE baseline
   bitwise, the counters balance, the completion queue ends empty, and the
   mean first-resident-block step must be strictly below phase 3's.  Then
   K11 (``fused_paged_attn``: device waits, then one launch of the paged
   kernel, which spins on the signal words and reads one layer's K/V
   through the slot table) on the pool that phase leaves, and on a copy
   whose unused blocks are NaN: exactly one K11 launch and no K3 or K2
   launch per call, bitwise equal to ``assemble`` + K2 at layers 0 and 35
   at qwen3-4b widths, within 2e-2 of its plain version; timed beside the
   route it replaces (device waits, K3 over every table block, K2), by
   events and on the device;
6. the ring attention path: ``serve.seq_parallel_report`` at qwen3-4b's
   attention widths (32 heads of 128), 8 PEs, S = 32768, f32: K/V shards
   rotate by work-group ``put_signal_nbi`` and device waits, one K10
   partial per causal (PE, shard) pair (exactly 36, each with one split
   pass), merged and held
   against K2 over the whole sequence within 5e-5; then once more at
   unit-scale inputs, where a mask error at a shard border would exceed
   that limit; then at the reference launcher's own demo widths (4 PEs,
   32 tokens, 4 heads of 32: K10 at hd 32, held to the plain causal
   attention since K2 takes no hd 32) and at zamba2-2.7b's (4 PEs, S =
   16384, 32 heads of 80: K10 at hd 80, held to K2 in f32), 10 partials
   each, within 5e-5;
7. the streamed serving path: phase 3's run with ``--stream-chunks 4``
   and ``--trace``: each request's 32 prompt blocks leave in 8
   installments against a pool stream-signal word, slot-less until the
   close binds a slot.  K1-K3 must launch; every request's tokens must
   equal phase 3's (tracing on against off), the installments number 64,
   the counters balance, the completion queue ends empty, every stream
   word is back on the free list, the mean modeled TTFD window
   (``ttfd_model_s``) is strictly below phase 3's, the Chrome trace
   validates and every request's chain passes through streaming, parked,
   migrating and decoding with no gap;
8. the shared-prefix serving path: the same shape at a 520-token prompt
   with ``--shared-prefix`` (every request a sample of one prompt; 520 is
   not a multiple of 16, so the first decode write copies the partial
   boundary block), stepped here through ``serve.build_disagg``: after
   every step each prefix-entry block resident at a decode PE must equal
   its home row bitwise (copy-on-write keeps it pristine).  K1-K3 must
   launch; 7 prefix hits, 8 copy-on-writes (the registrar's too), wire
   bytes saved, the counters balance, and every request's tokens equal
   the single-PE baseline at S = 520;
9. the dense-rehydrate serving path: phase 3's run with
   ``--dense-rehydrate`` (admission gathers the payloads into the slot
   bank, decode reads that): K1 and K2 must launch and K3 never; tokens
   equal to phase 3's;
10. the zamba2 serving path: phase 3's traffic served by zamba2-2.7b at
   its published widths and depth (54 layers: 45 Mamba2, 9 repeats of the
   weight-shared attention block of 32 heads of 80), bf16.  A block holds
   the two paged K/V leaves (737,280 words), a request's tail the 45
   Mamba2 states and conv windows (15,454,080 f32 words).  K1-K3 must
   launch (K2 at head dim 80); every request's tokens equal the single-PE
   baseline bitwise, and the counters balance;
11. phase 10 with ``--fused-attn``: tokens equal phase 10's, the mean
   first-resident-block step strictly below phase 10's; then K11 at head
   dim 80 on that pool, q (3, 528, 32, 80), as in phase 5 (bitwise equal
   to assemble + K2 at shared-attention repeats 0 and 8, on the pool and
   on a copy whose unused blocks are NaN), in a row of its own;
12. the xlstm serving path: the same traffic served by xlstm-125m at its
   published widths and depth (6 mLSTM, 6 sLSTM blocks): a tail-only
   migration (no paged leaf), so K1 launches and K2 and K3 never; tokens
   equal the single-PE baseline bitwise;
13-20. the seven remaining configurations at their published widths,
   bf16, each built with ``dataclasses.replace(cfg, num_layers=...)`` where
   it is cut and served through ``serve._build_disagg`` (``FAMILIES``):
   13 llama4-scout (MoE, 16 experts top-1 and a shared expert, 40/8 heads;
   8 of 48 layers), 14 arctic (128 experts top-2 and a dense residual,
   56/8 heads; 2 of 35 layers; 4 requests, 8 new tokens), 15 starcoder2
   (gelu MLP, 36/4 heads), 16 minitron (vocab 256,000), 17 h2o-danube
   (sliding window 4096, hd 120; 4 requests of 4,608 tokens, so the cache
   is a ring of 256 blocks a request, the pool three requests' tables),
   18 whisper (24 encoder and 24 decoder layers, 16 heads of 64; 432-token
   prompts and 1500 audio frames; its cross K/V, 73,728,000 f32 words a
   request, in the tail), 19 phase 18 with ``--fused-attn``, 20 the vision
   model (cross-attention every 5th layer over 1601 image tokens; 10 of
   100 layers).  Each holds its layout's block and tail words, launches K1
   and K3 (and K2, except 17, whose windowed prefill is plain, as the
   reference's), balances its counters, and serves every request bitwise
   equal to the single-PE baseline; 17 shows its ring wrapped (a kpos of
   4096 or more); 17, 18 and 20 hold every decode slot's tail in the pool
   bitwise to the packed tail of a fresh prefill of its last request; 19's
   tokens equal 18's, its mean first-resident-block step is below 18's,
   and then K11 runs at hd 64 on its pool, q (3, 448, 16, 64), as in
   phase 5, in a row of its own.  Each phase's weights are freed before
   the next is built.
21. training: ``repro_torch.train.trainer`` at qwen3-4b's published
   widths, depth cut to 4 of 36 layers (AdamW's f32 moments and four PEs'
   bf16 gradients of all 36 do not fit one card beside each other), bf16,
   AdamW, remat on, data-parallel over 4 simulated PEs (``--comms-backend
   shmem --comms-npes 4``), seq 512, global batch 8.  First step 1's DP
   law: the ring-reduced mean against one backward on the whole batch,
   within 2e-2 by relative L2 per leaf (each PE's gradient and each ring
   add round to bf16, where one backward rounds once), with one step's
   launches as the leaves predict (5 norm leaves through K4's
   pass-around, 3 puts each; 9 matrices through K6 then K5); then the
   same law in f32 at 1 layer within the reference's rtol 2e-4 / atol
   2e-6.  Then six steps with a checkpoint at step 3 into a temporary
   directory, under PyTorch's deterministic algorithms, launch counts
   zeroed just before: K4 90, K5 54 and K6 54 launches, and none of K1,
   K2, K3, K10 or K11; every loss and gradient norm finite, the last loss
   below the first; a run resumed from step 3 ends bitwise on the
   uninterrupted run's params and optimizer state.  It prints the wall
   per step, tokens per second, the peak memory, the device ms of K4, K5
   and K6 in one more step under ``torch.profiler`` beside the modeled
   reduce schedule, and rows of their own for K6 and K5 at the embedding
   leaf's gradient, rows (4, 4, 97,239,040) bf16
   (``ring_reduce_scatter_train``, ``ring_allgather_train``).
22. cross-pod serving: phase 3's run with ``--cross-pod`` (the decode PEs
   a second pod, so every migration drains through the host-proxy ring),
   then phase 5's with ``--cross-pod``: tokens bitwise phase 3's,
   ``bytes_dcn`` (``bytes_cross_pod``) equal to the bytes migrated, the
   ring's messages as predicted (24, 272), K1 launched as often as in
   phases 3 and 5 (the same stores by another route); then K11 on the
   fused run's pool, one launch, bitwise ``assemble`` + K2;
23. the fleet: ``--fleet --full``, 2 pods of 1 prefill + 2 decode PEs, 2
   slots each, 256 blocks, 512-token prompts, 16 new tokens, SLO
   admission, affinity routing, the launcher's three tenants (the api
   tenant's shared prefixes in 2 groups), ``--rate 1.2 --fleet-steps 16
   --stream-chunks 0 --seed 1`` (chosen on the CPU at reduced widths so
   that the run preempts, pulls a prefix across pods and completes at
   least 16 requests; 1-block installments never fill a slot, so no run
   with them can preempt).  Completed plus shed equals offered, resumes
   equal preemptions (at least 1), cross-pod bytes above 0, every
   completed request's tokens bitwise ``Engine.generate_in_slot`` for its
   prompt and budget, the pool drained to 0 blocks, and the step-level
   counts and K1-K3 launches as the CPU run predicts;
24. chaos: phase 23's traffic under ``--chaos
   'kill_pe=2@6,partition=3@12,kill_pod=pod1@20'``, phase 23's outputs
   the no-fault control: all three events fire, every request ends
   terminal, no completed request's tokens differ from the control's, at
   least one request recovers, the pool drains, the dead PEs' rows hold
   the poison bit for bit (NaN bits in the bf16 and f32 pools,
   ``iinfo.min + 1`` in int32), and no decode step's logits hold a NaN;
   the run carries ``--audit 1 --recorder 16`` (the postmortem dumps go to
   a temporary directory through ``ISHMEM_OBS_RECORDER_PATH``): no audit
   pass finds a violation, and each of the three faults writes one dump,
   validated as it is written;
25. the observability bundle on phase 23's fleet: ``--trace --metrics
   --audit 1 --recorder 16 --alerts``.  Tokens, ``report()`` and the
   step-level counts bitwise phase 23's (the off/on law on the card), 66
   metrics rows, no violation, the trace valid with one chain per
   request; prints the audit's wall a pass and a recorded tracer event's
   host cost from a timed loop of ``SpanTracer`` instants;
26. measured: phase 7's run (phase 3 streamed in 4-block installments)
   with ``--profile --calibration --trace``: tokens bitwise phase 3's,
   samples per scope (``serve_prefill``, ``serve_decode``,
   ``paged_attn``), the worst measured/modeled buckets, the measured
   track valid; then ``fit_tuning_table(sample_source="wallclock")``
   written to the temporary directory;
27. tuning: phase 3 under ``ISHMEM_TUNING_FILE`` (that table armed,
   ``source == "wallclock"``, tokens bitwise), under
   ``ISHMEM_FORCE_PATH=engine`` (tokens bitwise, no op whose path the
   chooser picks left on the direct path), and a 6-step fleet with
   ``--refit 4 --profile``: at least one re-fit from the card's samples,
   every finished request bitwise its single-PE baseline, the counts
   printed and not held (the wall-clock table steers the modeled clock
   SLO admission reads);
28. the dry-run held by the card (after phase 21): ``launch.dryrun.
   run_one`` on meta for qwen3-4b at its published widths and depth, the
   reference's prefill kind cut to batch 1 and 4096 tokens, then the same
   ``model.prefill`` on the card with real bf16 weights under
   ``roofline.counter.count()``: FLOPs, bytes, transcendentals, the
   collectives and every kernel's charge equal the meta record's exactly,
   K2 launches 36 times and nothing else, each of those 36 calls within
   2e-2 of K2's plain version on the path's own q, k and v, the last
   logits no farther (relative L2) from the same prefill with K2's plain
   version than 1.25 times the same prefill through SDPA is (at 36 bf16
   layers both part from it by about 2e-2), and the
   rise of ``memory_allocated`` while the arguments are built within 1% of
   the predicted argument bytes; then one dense ``decode_step`` against
   that cache (counts equal, no launch, the bytes resident above the
   prefill's baseline within 1% of its predicted arguments) and phase
   21's data-parallel train step (4 of 36 layers, 4 PEs; counts equal,
   arguments within 1%, K4-K6 launched as phase 21 predicts,
   ``collective_by_kind`` the ring formulas summed over the launches
   issued).  Each prints the median wall of 3 runs after a warm-up, the
   peak ``max_memory_allocated`` above the baseline its arguments were
   built on beside the predicted argument + temp, the roofline bound (its
   memory term each argument read and each output written once), its
   share of the wall, the MFU, and the eager implementation's counted
   traffic at HBM rate, beside the card's name and power limit (none of
   these gates the run);
29. the three policy fields (after 28): phase 28's prefill and decode
   step under ``attn_repeat_kv=1`` (counts equal the meta records made
   under that policy exactly, K2 launched 36 times and nothing else, each
   call with 32 K/V heads and within 2e-2 of its plain version, the
   prefill and decode logits no farther from the default run's than 1.25
   times phase 28's SDPA distance, the cache holding 8 K/V heads), under
   ``decode_onehot_update=1`` and under ``attn_impl=flash`` (logits,
   caches and launches bitwise the default run's); a one-layer train step
   under ``attn_impl=flash`` (its forward launches K2 once, and its
   gradient raises ``NotImplementedError`` naming K2's missing
   backward); then K2 as MHA at q/k/v (1, 4096, 32, 128) in a row of its
   own (``flash_attention_mha4k``) beside SDPA;
30. the four torch examples, each through ``main(["--device", "cuda"])``:
   the quickstart's printed values equal its CPU run's; the serving
   example's decode steps, migrations, migrated bytes, installments,
   prefix hits, mapped blocks and copy-on-writes equal its CPU run's, at
   the reference's temperatures and at ``--temperature 0``, where every
   token equals the CPU run's too; the collectives example's fcollect,
   broadcast and barrier equal their plain versions and its psum is
   within 1e-4 of the engine's; ``train_lm``'s loss is finite and falls.
   Each prints its K1/K2/K3/K5/K7/K8 launches and fails if it launched
   none of the kernels its path runs;
31. training at published widths and full depth: qwen3-4b at all 36
   layers with AdamW, and llama-3.2-vision-90b at one repeat unit (5 of
   100 layers) with Adafactor, each data-parallel over 2 PEs of one
   512-token sequence, 3 steps through ``trainer.train``.  Each is sized
   first on meta (``launch.dryrun.run_one``, arguments + temp; past 76 GiB
   it would train with ``--comms-backend none`` and say so), its K4-K6
   charges a step equal the count predicted from the leaf list, step 1's
   DP law holds by relative L2 within 2e-2 in bf16, every loss is finite,
   the launches are the prediction times the steps, and it prints wall
   per step, tokens/s and peak ``max_memory_allocated`` beside the meta
   prediction.  K6 then K5 then get rows at qwen3-4b's stacked w_gate
   gradient over 2 PEs (``ring_reduce_scatter_full``,
   ``ring_allgather_full``), bitwise their plain versions, beside
   ``x.sum(0)`` and ``expand`` + ``contiguous``; phase 21's K5/K6 rows
   are made here too, after the training phases.
Every ``ISHMEM_*`` variable is cleared at the start: the phases set the
knobs they test.  Phases 3, 5, 7-20 and 22-27 print their wall time and
peak device memory, and K1-K3's rows carry their launches in phases 7-20
and 22-27 (``launches_by_phase``; K11's in 22-27).  K2 also runs at the head ratios 5, 7 and 9 and
whisper's MHA at hd 64 in phase 2 (``check_flash_serving``), with rows of
its own at starcoder2's q (1, 512, 36, 128), k/v (1, 512, 4, 128)
(``flash_attention_gqa9``, phase 15's launches) and whisper's
(1, 432, 16, 64) (``flash_attention_hd64``, phase 18's).  K10 has rows
at hd 32 (``flash_partial_hd32``, q/k/v (1, 8, 4, 32)) and hd 80
(``flash_partial_hd80``, (1, 4096, 32, 80)) at phase 6's demo and zamba2
ring shapes, with their launches there.

K4-K6's rows carry their launches in phases 4, 21 and 28c
(``launches_by_phase``, 28c as ``28-train``; ``launches`` is phase 4's),
and the two phase-21 rows those of phases 21 and 28c.

K9 (``reduce_tile``) has no caller on these paths (only the reference's
benchmark and tests call it): its row sums its counts over the path
runs (phase 28c's train step included), and the check fails if that is
not 0.  K11 has none either (the
fused serving path reads through ``assemble``, as the reference's does):
its row's ``launches`` is phase 5's count, 0, beside its launches per
call; the head-dim-80 row of K11 likewise, phase 11's count, and the
head-dim-64 row phase 19's.  K2's
head-dim-80 row carries phase 10's launches.  K2's row also carries its
HGMMA count (``hgmma``) and a ``long`` record at q (1, 4096, 32, 128):
events, device ms, TFLOP/s and share of its operations bound beside
SDPA's events and device ms, and its launches in phase 28 (the row's
``phase_28`` holds that phase's measurements).  The line before
the last is the ``kernels`` JSON record; the last is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the repository
beside this file, it exits nonzero before printing any result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12,    # dense tensor cores
              "float32": 67e12}                       # FMA, no tensor cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2}             # tests/test_kernels.py

MAIN_ARGV = ["--disagg", "--full", "--arch", "qwen3-4b", "--seed", "0",
             "--prefill-pes", "2", "--decode-pes", "2", "--requests", "8",
             "--prompt-len", "512", "--max-new", "16", "--slots", "3",
             "--kv-blocks", "256", "--block-tokens", "16"]
COLL_ARGV = ["--full", "--arch", "qwen3-4b", "--npes", "8", "--seed", "0",
             "--prefill-tokens", "512", "--decode-batch", "8"]
FUSED_ARGV = MAIN_ARGV + ["--fused-attn"]
STREAM_ARGV = MAIN_ARGV + ["--stream-chunks", "4"]          # + --trace PATH
PREFIX_LEN = 520                     # 520 % 16 = 8: a partial boundary block
PREFIX_ARGV = MAIN_ARGV + ["--prompt-len", str(PREFIX_LEN), "--shared-prefix"]
DENSE_ARGV = MAIN_ARGV + ["--dense-rehydrate"]
ZAMBA_ARGV = [{"qwen3-4b": "zamba2-2.7b"}.get(a, a) for a in MAIN_ARGV]
ZAMBA_FUSED_ARGV = ZAMBA_ARGV + ["--fused-attn"]
XLSTM_ARGV = [{"qwen3-4b": "xlstm-125m"}.get(a, a) for a in MAIN_ARGV]
# zamba2 at 528 tokens: 2 paged leaves x 9 repeats x 16 tokens x 32 x 80,
# and 5 Mamba2 positions x 9 repeats x (80 x 64 x 64 state + 3 x 5248 conv)
ZAMBA_BLOCK_WORDS, ZAMBA_TAIL_WORDS = 737_280, 15_454_080
STREAM_CHUNKS = 8 * 8                # 32 prompt blocks in 8 installments
PREFIX_HITS, COW_COPIES = 7, 8       # the registrar reserves a COW block too
RING = dict(npes=8, prompt_len=32768, full=True, arch="qwen3-4b", seed=0)
RING_PARTIALS = 8 * 9 // 2           # causal (PE, shard) pairs
RING_TOL = 5e-5                      # tests/test_device.py ring attention
# phase 6 also runs the ring at the reference launcher's own demo widths
# (4 PEs, 32 tokens, 4 heads of 32: K2 takes no hd 32, so the check is the
# plain causal attention) and at zamba2-2.7b's (32 heads of 80, against K2
# in f32), 10 causal partials each
RING_DEMO = dict(npes=4, prompt_len=32, seed=0)
RING_ZAMBA = dict(npes=4, prompt_len=16384, full=True, arch="zamba2-2.7b",
                  seed=0)
RING4_PARTIALS = 4 * 5 // 2
SERVE_KERNELS = ("copy_into", "flash_attention", "paged_gather")
# phases 13-20: the seven remaining configurations at their published
# widths, bf16: (phase, label, arch, depth cut or None, traffic changes
# from phase 3's, block words, tail words).  llama4-scout keeps 8 of 48
# layers (about 35 GB of layers beside 4.1 GB of embeddings), arctic 2 of
# 35 (about 54 GB: 128 experts of 7168 x 4864 a layer), the vision model
# 10 of 100 (two units of 4 self-attention layers and a cross-attention
# layer).  h2o-danube serves 4608-token prompts, above its window of 4096,
# so its cache is a ring of 256 blocks a request (tail: the int32 kpos of
# 24 layers x 4096 slots) and its pool holds three requests' tables;
# whisper serves 432-token prompts (its decoder's context is 448) and
# carries each request's cross K/V, 24 layers x 1500 frames x 16 heads of
# 64, twice, in its f32 tail (295 MB).
FAMILIES = [
    ("13", "llama4-scout", "llama4-scout-17b-a16e", 8, {}, 262_144, 1),
    ("14", "arctic", "arctic-480b", 2, {"--requests": 4, "--max-new": 8},
     65_536, 1),
    ("15", "starcoder2", "starcoder2-7b", None, {}, 524_288, 1),
    ("16", "minitron", "minitron-8b", None, {}, 1_048_576, 1),
    ("17", "h2o-danube", "h2o-danube-3-4b", None,
     {"--requests": 4, "--prompt-len": 4608}, 737_280, 98_304),
    ("18", "whisper", "whisper-medium", None, {"--prompt-len": 432},
     786_432, 73_728_000),
    ("20", "llama-3.2-vision", "llama-3.2-vision-90b", 10, {}, 262_144,
     6_557_696),
]
DANUBE_TABLES = 3                    # requests' tables the ring pool holds
RING_KERNELS = ("remote_put", "ring_allgather", "ring_reduce_scatter",
                "push_broadcast", "barrier_push")
REPEATS = 20                         # each ring check, to catch races
# phase 21: training, qwen3-4b at published widths cut to 4 of 36 layers,
# 4 simulated PEs, seq 512, global batch 8 (2 sequences a PE), 6 steps, a
# checkpoint at step 3 and a resumed run to 6.  Each step reduces 14
# leaves: the 5 norm leaves (final_norm; norm1, norm2, q_norm, k_norm of
# the 4 stacked layers) are under 2 MiB x 4 PEs and take psum_overlap's
# pass-around, 3 K4 puts each at 4 PEs; the 9 matrices (embed, lm_head,
# wq, wk, wv, wo, w_gate, w_up, w_down) take K6 then K5.
TRAIN = dict(arch="qwen3-4b", npes=4, seq=512, batch=8, steps=6,
             ckpt_every=3)
TRAIN_LAYERS = 4
TRAIN_PER_STEP = {"remote_put": 5 * 3, "ring_reduce_scatter": 9,
                  "ring_allgather": 9}
TRAIN_KERNELS = tuple(TRAIN_PER_STEP)
TRAIN_NOT_LAUNCHED = ("copy_into", "flash_attention", "paged_gather",
                      "flash_partial", "flash_partial_split",
                      "fused_paged_attn")
TRAIN_EMBED_ELEMS = 151936 * 2560            # the embedding leaf
# bf16: each PE's gradient rounds to bf16 and the ring adds in bf16, where
# one backward rounds once (a bf16 ulp is 2^-8 of the value)
TRAIN_BF16_TOL = 2e-2
TRAIN_F32_RTOL, TRAIN_F32_ATOL = 2e-4, 2e-6  # tests/test_system.py
# phase 22: phases 3 and 5 across pods.  Ring messages: a barrier
# migration puts its 32 contiguous blocks as one coalesced run, then the
# tail and the header (3 puts a request); a fused one puts each of its 32
# blocks, the tail and the header alone (34); signals apply directly
CROSS_ARGV = MAIN_ARGV + ["--cross-pod"]
CROSS_FUSED_ARGV = FUSED_ARGV + ["--cross-pod"]
CROSS_MESSAGES = {"barrier": 8 * 3, "fused": 8 * 34}
# phases 23-24: the fleet.  PREDICTED holds the counts the same argv gives
# at reduced widths on the CPU (the step clock and the traffic do not
# depend on the widths; K2 launches 36 times a prefill at full depth)
FLEET_ARGV = ["--fleet", "--full", "--arch", "qwen3-4b", "--pods", "2",
              "--pod-prefill", "1", "--pod-decode", "2", "--slots", "2",
              "--kv-blocks", "256", "--block-tokens", "16", "--prompt-len",
              "512", "--max-new", "16", "--admission", "slo", "--router",
              "affinity", "--rate", "1.2", "--fleet-steps", "16",
              "--stream-chunks", "0", "--seed", "1"]
CHAOS_PLAN = "kill_pe=2@6,partition=3@12,kill_pod=pod1@20"
FLEET_PREDICTED = {
    "23": {"offered": 26, "completed": 26, "shed": 0, "preempts": 1,
           "elapsed_steps": 66, "prefills": 26, "delivered": 2,
           "copy_into": 1367, "flash_attention": 26 * 36,
           "paged_gather": 237},
    "24": {"offered": 26, "completed": 25, "shed": 1, "preempts": 1,
           "elapsed_steps": 180, "prefills": 28, "delivered": 0,
           "copy_into": 1390, "flash_attention": 28 * 36,
           "paged_gather": 213, "recovered_requests": 15, "remigrated": 2,
           "replayed_tokens": 6, "cancelled_ops": 74}}

# phase 28: the dry-run held by the card.  qwen3-4b at its published widths
# and depth, the reference's prefill kind with batch 32 -> 1 and sequence
# 32768 -> 4096 (one card's phase: prefill_32k's batch would need 152 GB of
# arguments); one dense decode step against that cache; phase 21's
# data-parallel train step (4 of 36 layers, 4 PEs, seq 512, batch 8)
DRY_ARCH = "qwen3-4b"
DRY_PREFILL = dict(name="prefill_4k_b1", kind="prefill", seq_len=4096,
                   global_batch=1)
DRY_DECODE = dict(DRY_PREFILL, name="decode_4k_b1", kind="decode")
DRY_TRAIN = dict(name="train_512_b8", kind="train", seq_len=TRAIN["seq"],
                 global_batch=TRAIN["batch"])
DRY_K2 = 36                          # K2 launches: one a layer
DRY_LIB_RATIO = 1.25                 # K2's logits spread against SDPA's
DRY_RUNS = 3                         # timed runs after a warm-up
ALLOC_TOL = 0.01                     # allocator rounding of the arguments
# phase 29: phase 28's prefill and decode under the reference's three
# policy fields.  attn_repeat_kv runs K2 as MHA (K/V heads 8 -> 32) and is
# held to its own meta records; the other two take the default's route, so
# they are held bitwise to it
POLICY_REPEAT = ["attn_repeat_kv=1"]
POLICY_SAME = (["decode_onehot_update=1"], ["attn_impl=flash"])
POLICY_FIELDS = (POLICY_REPEAT, *POLICY_SAME)
# phase 30: the four torch examples; the launches each prints, and those
# it must make on the card
EXAMPLE_K = {"copy_into": "K1", "flash_attention": "K2",
             "paged_gather": "K3", "ring_allgather": "K5",
             "push_broadcast": "K7", "barrier_push": "K8"}
EXAMPLE_NEEDS = {
    "quickstart": ("copy_into",),
    "serve_batch": ("copy_into", "flash_attention", "paged_gather"),
    "serve_batch --temperature 0": ("copy_into", "flash_attention",
                                    "paged_gather"),
    "shmem_collectives": ("ring_allgather", "push_broadcast",
                          "barrier_push"),
    "train_lm": ()}
SERVE_EXAMPLE_COUNTS = ("decode_steps", "migrations", "bytes_migrated",
                        "stream_chunks", "prefix_hits",
                        "blocks_prefix_shared", "cow_copies")
COLL_TOL = 1e-4                      # tests/test_comms_equiv.py
# phase 31: training at published widths and full depth (qwen3-4b, AdamW)
# and at one repeat unit of the vision model (Adafactor), data-parallel
# over 2 PEs of one 512-token sequence each, 3 steps, no checkpoint.  A
# configuration whose meta peak (arguments + temp) passes FULL_TRAIN_FIT
# trains with --comms-backend none instead (the card holds about 79 GiB)
FULL_TRAIN = [
    dict(label="qwen3-4b", arch="qwen3-4b", layers=None, npes=2, seq=512,
         batch=2, steps=3, why="no cut: all 36 layers"),
    dict(label="llama-3.2-vision-90b", arch="llama-3.2-vision-90b",
         layers=5, npes=2, seq=512, batch=2, steps=3,
         why="one repeat unit (4 self-attention layers and 1 "
             "cross-attention layer) of 100 layers: the whole model's "
             "bf16 weights are 169 GiB")]
FULL_TRAIN_FIT = 76 * 2**30
FULL_LEAF_ELEMS = 36 * 2560 * 9728   # qwen3-4b's stacked w_gate
COUNT_KEYS = ("flops", "bytes", "transcendental", "collective_bytes",
              "collective_by_kind", "n_collective_sites", "by_kernel")


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(torch, fn, *, iters: int = 20, per_call: int = 1) -> float:
    """Mean device milliseconds of one call: CUDA events around ``iters``
    runs of ``fn`` (each making ``per_call`` calls), after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * per_call)


@contextlib.contextmanager
def poisoned(torch, dev):
    """Within the block, every tensor that ``torch.empty`` hands out comes
    filled with NaN (floats) or the type's largest value (integers), by
    PyTorch's deterministic mode.  A ring kernel's output, landing slots and
    flags are such tensors, so a kernel that reads a word before its writer
    has stored it, or leaves a word unwritten, shows a wrong element instead
    of the equal value an earlier run left in the recycled block."""
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = True
    try:
        probe = torch.empty(5, device=dev), torch.empty(
            5, dtype=torch.int32, device=dev)
        if not (bool(probe[0].isnan().all()) and
                probe[1].tolist() == [2**31 - 1] * 5):
            fail("torch.empty does not poison new blocks in deterministic "
                 "mode: the repeated ring checks could not see stale reads")
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def device_ms(torch, fn, match, *, iters: int = 50, per_call=None):
    """Mean device-only milliseconds per launch of the kernels whose name
    contains ``match``, from ``torch.profiler`` over ``iters`` calls of
    ``fn``; with ``per_call`` = k, per k-th of one call of ``fn`` instead
    (k = 1: their total per call).  With ``match`` None, of everything
    ``fn`` runs on the device, per call unless ``per_call`` says otherwise.
    None when the profiler shows no device time for them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    if match is None and per_call is None:
        per_call = 1
    # late in a long run the profiler at times returns a session without
    # the device records (seen for the multi-ms kernels of phase 21): try
    # again before reporting none
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and (match is None or
                                                       match in evt.key):
                total_us += evt.self_device_time_total
                count += evt.count
        if count and total_us:
            if per_call:
                count = iters * per_call
            return total_us / 1e3 / count
    return None


def host_us(fn, *, iters: int = 20000) -> float:
    """Mean host microseconds of one call of ``fn`` (best of three runs)."""
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, time.perf_counter() - t0)
    return best / iters * 1e6


def check_copy(torch, rma_copy, _build, dev, deferred):
    """K1 at edge shapes (bitwise), then timed at the main path's block
    payload: 32 blocks of one request stored at distinct offsets, so the
    source and destination bytes exceed the 50 MB L2.  Its device time and
    ``copy_``'s are taken over the same 32-offset loop, per store.  The
    host cost of the entry's ``cudaSetDevice`` is read from a call that
    stores 0 bytes (``cudaSetDevice``, then return) beside a call with the
    same arguments into a function that makes no CUDA call."""
    gen = torch.Generator(device=dev).manual_seed(1)
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        for n, off in ((1, 3), (127, 129), (1179648, 1000), (1179648, 256)):
            row = (torch.randn(2_500_000, generator=gen, device=dev) * 50).to(dt)
            src = (torch.randn(n, generator=gen, device=dev) * 50).to(dt)
            got = rma_copy.copy_into(row.clone(), src, off)
            want = rma_copy.copy_into_plain(row.clone(), src, off)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"K1 copy_into differs from its plain version: {dt} "
                     f"n={n} offset={off}")
    n, blocks = 1179648, 32
    row = torch.zeros(blocks * n + 128, dtype=torch.bfloat16, device=dev)
    srcs = [torch.randn(n, generator=gen, device=dev).bfloat16()
            for _ in range(blocks)]
    offs = [b * n + 64 * (b % 2) for b in range(blocks)]

    def kernel():
        for src, off in zip(srcs, offs):
            rma_copy.copy_into(row, src, off)

    def plain():
        for src, off in zip(srcs, offs):
            rma_copy.copy_into_plain(row, src, off)

    def library():
        for src, off in zip(srcs, offs):
            row[off:off + n].copy_(src)

    kernel()
    want = row.clone()
    row.zero_()
    library()
    torch.cuda.synchronize()
    if not torch.equal(row, want):
        fail("K1 copy_into over the 32-offset loop differs from copy_")
    del want
    # the same five ctypes conversions into a library function that makes
    # no CUDA call: the error-string lookup, bound a second time with K1's
    # argument types (its extra arguments are ignored, its pointer result
    # read as an int and dropped)
    entry = _build.entries()["ishmem_copy_into"]
    probe = ctypes.CDLL(_build.lib()._name).ishmem_error_string
    probe.argtypes = _build.SIGNATURES["ishmem_copy_into"]
    probe.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    index = dev.index or 0
    set_device_us = host_us(lambda: entry(index, 0, 0, 0, stream))
    floor_us = host_us(lambda: probe(0, 0, 0, 0, stream))
    nbytes = 2 * n * 2
    out = {"name": "copy_into", "route": "cuda",
            "source": "src/repro_torch/csrc/rma_copy.cu",
            "replaces": "src/repro/kernels/rma_copy.py:46",
            "max_abs_err": 0.0,
            "ms": time_ms(torch, kernel, per_call=blocks),
            "plain_ms": time_ms(torch, plain, per_call=blocks),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(torch, library, per_call=blocks),
            "host_us_set_device_call": set_device_us,
            "host_us_same_args_no_cuda": floor_us,
            "shape": f"{n} bf16 words (one KV block payload) x {blocks} "
                     "offsets"}
    say(f"K1 host: a 0-byte store (cudaSetDevice, then return) "
        f"{set_device_us:.3f} us a call, the same arguments into a "
        f"function that makes no CUDA call {floor_us:.3f} us")
    deferred.append((out, "device_ms", kernel, "copy_kernel"))
    deferred.append((out, "library_device_ms", library, None,
                     {"per_call": blocks}))
    return out


K2_GRID_S = (1, 37, 63, 64, 65, 129, 512, 528, 1000, 4096)
K2_GRID_HEADS = ((32, 8), (8, 8), (8, 1))


def _qkv(torch, gen, dev, dt, B, S, H, Hkv, hd):
    return (torch.randn(B, S, H, hd, generator=gen, device=dev).to(dt),
            torch.randn(B, S, Hkv, hd, generator=gen, device=dev).to(dt),
            torch.randn(B, S, Hkv, hd, generator=gen, device=dev).to(dt))


def _flash_bound(B, S, H, Hkv, hd):
    """(bound ms, what bounds it, causal FLOPs) of K2 in bf16: q, k, v read
    once and o written once, against the causal QK^T and PV products --
    the work ``roofline/counter.py`` charges each K2 call."""
    from repro_torch.roofline import counter
    work = counter.flash_work(B, S, H, Hkv, hd, 2)
    flops = work["flops"]
    t_bytes = work["bytes"] / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS["bfloat16"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops)


def hgmma_count(_build, so, kernel):
    """HGMMA instructions in the kernels whose name holds ``kernel`` in the
    built library, by ``cuobjdump -sass``; None where the toolkit has no
    cuobjdump."""
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        name = re.search(r"Function : (\S+)", line)
        if name:
            inside = kernel in name.group(1)
        elif inside and "HGMMA" in line:
            count += 1
    return count


def check_flash(torch, flash_attn, dev, deferred):
    """K2 in f32 at S in {1, 37, 512}, GQA 32/8, hd 128 (the FMA kernel, to
    2e-5); in bf16 (the wgmma kernel, to 2e-2) over S in K2_GRID_S, hd in
    {64, 80, 128} and heads 32/8, 8/8 and 8/1, and at K11's B = 3, S = 528.
    Bitwise: two runs agree, and batch 0 of a B = 2 call whose batch 1 K
    and V are NaN is finite and equal to the same inputs at B = 1.  Timed
    at the main path's prefill shape (B=1, S=512, bf16) and at a long
    prefill, S = 4096."""
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(2)
    main_err, worst, cases = None, 0.0, 0
    grid = [(torch.float32, 1, S, 32, 8, 128) for S in (1, 37, 512)]
    grid += [(torch.bfloat16, 1, S, H, Hkv, hd) for S in K2_GRID_S
             for hd in (64, 80, 128) for H, Hkv in K2_GRID_HEADS]
    grid.append((torch.bfloat16, 3, 528, 32, 8, 128))
    for dt, B, S, H, Hkv, hd in grid:
        q, k, v = _qkv(torch, gen, dev, dt, B, S, H, Hkv, hd)
        got = flash_attn.flash_attention(q, k, v)
        want = flash_attn.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = TOL[str(dt).removeprefix("torch.")]
        bad = (~torch.isclose(got.float(), want.float(), rtol=tol,
                              atol=tol)).sum().item()
        shape = f"{dt} B={B} S={S} heads {H}/{Hkv} hd={hd}"
        if dt == torch.float32 or S in (1, 512, 4096) or B > 1:
            say(f"K2 {shape}: max|err| {err:.3e} (tol {tol})")
        if bad or not math.isfinite(err):
            fail(f"K2 flash_attention: {bad} elements outside {tol} "
                 f"({shape})")
        if dt == torch.bfloat16:
            worst, cases = max(worst, err), cases + 1
            if (B, S, H, Hkv, hd) == (1, 512, 32, 8, 128):
                main_err = err
        del q, k, v, got, want
    say(f"K2 bf16: {cases} shapes within {TOL['bfloat16']}, largest "
        f"max|err| {worst:.3e}")
    laws = 0
    for S, H, Hkv, hd in ((512, 32, 8, 128), (37, 8, 1, 64),
                          (1000, 8, 8, 128), (528, 32, 8, 64)):
        q, k, v = _qkv(torch, gen, dev, torch.bfloat16, 2, S, H, Hkv, hd)
        k[1], v[1] = float("nan"), float("nan")
        pair = flash_attn.flash_attention(q, k, v)
        alone = flash_attn.flash_attention(q[:1].contiguous(),
                                           k[:1].contiguous(),
                                           v[:1].contiguous())
        again = flash_attn.flash_attention(q, k, v)
        torch.cuda.synchronize()
        if not bool(pair[0].isfinite().all()):
            fail(f"K2 bf16: batch 0 not finite beside a NaN batch 1 (S={S}, "
                 f"heads {H}/{Hkv}, hd={hd})")
        if not torch.equal(pair[:1], alone):
            fail(f"K2 bf16: batch 0 of B=2 differs from B=1 (S={S}, heads "
                 f"{H}/{Hkv}, hd={hd})")
        if not torch.equal(pair[:1], again[:1]) or not torch.equal(
                pair[1].isnan(), again[1].isnan()):
            fail(f"K2 bf16: two runs differ (S={S}, heads {H}/{Hkv}, "
                 f"hd={hd})")
        laws += 1
    say(f"K2 bf16: {laws} shapes bitwise run to run and batch-invariant, "
        f"batch 0 finite beside a NaN batch")

    def row(B, S, H, Hkv, hd):
        q, k, v = _qkv(torch, gen, dev, torch.bfloat16, B, S, H, Hkv, hd)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        bound, by, flops = _flash_bound(B, S, H, Hkv, hd)
        # at S = 512 a call is shorter than its host launch cost, so the
        # events time the host: 200 calls average out its hiccups
        iters = 200 if S <= 512 else 20
        out = {"ms": time_ms(torch, lambda: flash_attn.flash_attention(
                   q, k, v), iters=iters),
               "plain_ms": time_ms(
                   torch, lambda: flash_attn.flash_attention_plain(q, k, v),
                   iters=20 if S <= 512 else 5),
               "bound_ms": bound, "bound_by": by,
               "library_ms": time_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True),
                   iters=iters),
               "shape": f"q ({B},{S},{H},{hd}) k/v ({B},{S},{Hkv},{hd}) "
                        "bf16", "flops": flops}
        deferred.append((out, "device_ms",
                         lambda: flash_attn.flash_attention(q, k, v),
                         "flash_fwd_wgmma"))
        deferred.append((out, "library_device_ms",
                         lambda: F.scaled_dot_product_attention(
                             qt, kt, vt, is_causal=True, enable_gqa=True),
                         None))
        return out

    out = row(1, 512, 32, 8, 128)        # the deferred timings fill it in
    out.update(name="flash_attention", route="cuda",
               source="src/repro_torch/csrc/flash_attn.cu",
               replaces="src/repro/kernels/flash_attn.py:62",
               max_abs_err=main_err, long=row(1, 4096, 32, 8, 128))
    return out


def check_flash80(torch, flash_attn, dev, deferred):
    """K2 at head dim 80, zamba2's shared attention at the serving path's
    prefill shape: q, k and v (1, 512, 32, 80), MHA, in f32 (the FMA
    kernel, to 2e-5) and bf16 (the wgmma kernel over tiles padded to 128
    columns, to 2e-2), each bitwise run to run; timed in bf16 beside its
    plain version and SDPA."""
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(80)
    B, S, H, hd = 1, 512, 32, 80
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(torch, gen, dev, dt, B, S, H, H, hd)
        got = flash_attn.flash_attention(q, k, v)
        again = flash_attn.flash_attention(q, k, v)
        want = flash_attn.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        name = str(dt).removeprefix("torch.")
        tol = TOL[name]
        errs[name] = float((got.float() - want.float()).abs().max())
        if not bool(torch.isclose(got.float(), want.float(), rtol=tol,
                                  atol=tol).all()) or \
                not bool(got.isfinite().all()):
            fail(f"K2 hd 80 {name}: max|err| {errs[name]:.3e} outside {tol}")
        if not torch.equal(got, again):
            fail(f"K2 hd 80 {name}: two runs differ")
        say(f"K2 {name} q/k/v ({B},{S},{H},{hd}): max|err| "
            f"{errs[name]:.3e} (tol {tol}), bitwise run to run")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bound, by, flops = _flash_bound(B, S, H, H, hd)
    out = {"name": "flash_attention_hd80", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attn.cu",
           "replaces": "src/repro/kernels/flash_attn.py:62",
           "max_abs_err": errs["bfloat16"],
           "max_abs_err_f32": errs["float32"],
           "ms": time_ms(torch, lambda: flash_attn.flash_attention(q, k, v),
                         iters=200),
           "plain_ms": time_ms(
               torch, lambda: flash_attn.flash_attention_plain(q, k, v)),
           "bound_ms": bound, "bound_by": by,
           "library_ms": time_ms(
               torch, lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True), iters=200),
           "shape": f"q/k/v ({B},{S},{H},{hd}) bf16", "flops": flops}
    deferred.append((out, "device_ms",
                     lambda: flash_attn.flash_attention(q, k, v),
                     "flash_fwd_wgmma"))
    deferred.append((out, "library_device_ms",
                     lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=True), None))
    return out


def check_flash_serving(torch, flash_attn, dev, deferred):
    """K2 in bf16 at the prefill shapes phases 13-20 give it: head ratios
    5, 7 and 9 at head dim 128 (llama4-scout 40/8, arctic 56/8, starcoder2
    36/4) at S = 512, and whisper's MHA of 16 heads of 64 at S = 432, each
    within 2e-2 of its plain version and bitwise run to run.  Two rows:
    starcoder2's and whisper's, timed beside the plain version and SDPA."""
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = {}
    for name, (S, H, Hkv, hd) in (
            ("gqa5", (512, 40, 8, 128)), ("gqa7", (512, 56, 8, 128)),
            ("flash_attention_gqa9", (512, 36, 4, 128)),
            ("flash_attention_hd64", (432, 16, 16, 64))):
        q, k, v = _qkv(torch, gen, dev, torch.bfloat16, 1, S, H, Hkv, hd)
        got = flash_attn.flash_attention(q, k, v)
        again = flash_attn.flash_attention(q, k, v)
        want = flash_attn.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = TOL["bfloat16"]
        shape = f"q (1,{S},{H},{hd}) k/v (1,{S},{Hkv},{hd}) bf16"
        if not bool(torch.isclose(got.float(), want.float(), rtol=tol,
                                  atol=tol).all()) or \
                not bool(got.isfinite().all()):
            fail(f"K2 {shape}: max|err| {err:.3e} outside {tol}")
        if not torch.equal(got, again):
            fail(f"K2 {shape}: two runs differ")
        say(f"K2 {shape} (heads {H // Hkv}:1): max|err| {err:.3e} (tol "
            f"{tol}), bitwise run to run")
        if not name.startswith("flash"):
            continue
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        bound, by, flops = _flash_bound(1, S, H, Hkv, hd)

        def k2(q=q, k=k, v=v):
            return flash_attn.flash_attention(q, k, v)

        def sdpa(qt=qt, kt=kt, vt=vt):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        out = {"name": name, "route": "cuda",
               "source": "src/repro_torch/csrc/flash_attn.cu",
               "replaces": "src/repro/kernels/flash_attn.py:62",
               "max_abs_err": err, "ms": time_ms(torch, k2, iters=200),
               "plain_ms": time_ms(torch, lambda: flash_attn.
                                   flash_attention_plain(q, k, v)),
               "bound_ms": bound, "bound_by": by,
               "library_ms": time_ms(torch, sdpa, iters=200),
               "shape": shape, "flops": flops}
        deferred.append((out, "device_ms", k2, "flash_fwd_wgmma"))
        deferred.append((out, "library_device_ms", sdpa, None))
        rows[name] = out
    return [rows["flash_attention_gqa9"], rows["flash_attention_hd64"]]


def _gather_cases(torch, gen, dev, R, data):
    """(label, data, host table) for K3's edge shapes: every table entry
    unmapped, one entry, the odd width 37 (4-byte units), a data base off
    the 16-byte grid (4-byte units), a row of one CTA's 32 KB and 16 bytes
    (a second CTA with one vector), and 264 entries at the main row width."""
    import numpy as np
    rng = np.random.default_rng(3)
    odd = torch.randn(10, 37, generator=gen, device=dev)
    flat = torch.randn(64 * 4096 + 1, generator=gen, device=dev)
    shifted = flat[1:].view(64, 4096)
    long_row = torch.randn(20, 16392, generator=gen, device=dev).bfloat16()
    many = rng.integers(0, R + 1, size=(8, 33)).astype(np.int32)
    return [
        ("all unmapped", data, np.full((3, 33), R, np.int32)),
        ("one entry", data, np.array([[R // 2]], np.int32)),
        ("odd width 37", odd, np.array([[3, 10], [10, 0]], np.int32)),
        ("base off the 16-byte grid", shifted,
         rng.integers(0, 65, size=(3, 9)).astype(np.int32)),
        ("row of one CTA's chunk + 16 bytes", long_row,
         rng.integers(0, 21, size=(4, 5)).astype(np.int32)),
        ("8 slots x 33 at the main width", data, many),
    ]


def check_gather(torch, ishmem_device, ops, dev, deferred):
    """K3 at the main path's pool row (256 blocks of 1,179,648 bf16 words)
    and table (3 slots x 33 entries), with unmapped entries, bitwise, with
    the table as the serving path passes it (a numpy array on the host,
    under PyTorch's sync debug mode set to raise, so the call is shown to
    make no device-to-host sync) and as a tensor on the card; then at
    K3's edge shapes, both ways.  Timed with the host table, as the
    serving path calls it, and with the card table (one sync a call)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    R, W, slots, nb = 256, 1179648, 3, 33
    data = torch.randn(R, W, generator=gen, device=dev).bfloat16()
    perm = torch.randperm(R, generator=gen, device=dev).to(torch.int32)
    table = torch.full((slots, nb), R, dtype=torch.int32, device=dev)
    table[0] = perm[:nb]
    table[1] = perm[nb:2 * nb]
    table[2, :10] = perm[2 * nb:2 * nb + 10]       # a partly mapped slot
    host = table.cpu().numpy()
    want = ishmem_device.paged_gather_plain(data, table)
    ishmem_device.paged_gather(data, host)          # warm the pinned pool
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ishmem_device.paged_gather(data, host)
        try:          # the control: a card table's range read is a sync
            ishmem_device.paged_gather(data, table)
            fail("PyTorch's sync debug mode missed the card table's sync")
        except RuntimeError:
            pass
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("K3 paged_gather (host table) differs from its plain version")
    if not torch.equal(ishmem_device.paged_gather(data, table), want):
        fail("K3 paged_gather (card table) differs from its plain version")
    del got, want
    cases = _gather_cases(torch, gen, dev, R, data)
    for label, d, tab in cases:
        want = ishmem_device.paged_gather_plain(
            d, torch.from_numpy(tab).to(dev))
        for kind, t in (("host", tab), ("card", torch.from_numpy(tab).to(dev))):
            got = ishmem_device.paged_gather(d, t)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"K3 paged_gather differs from its plain version: "
                     f"{label}, {kind} table")
    bad = host.copy()
    bad[0, 0] = R + 1
    before = ops.LAUNCHES["paged_gather"]
    try:
        ishmem_device.paged_gather(data, bad)
        fail("K3 took a host table entry outside [0, R]")
    except IndexError:
        pass
    if ops.LAUNCHES["paged_gather"] != before:
        fail("K3 launched before it refused a host table")
    say(f"K3: main shape bitwise with a host table (no device sync) and a "
        f"card table; {len(cases)} edge shapes bitwise both ways; an "
        f"out-of-range host table refused before any launch")

    padded = torch.cat([data, data.new_zeros(1, W)])
    idx = table.reshape(-1).long()
    mapped = int((table < R).sum())
    nbytes = (mapped + table.numel()) * W * 2 + table.numel() * 4
    out = {"name": "paged_gather", "route": "cuda",
           "source": "src/repro_torch/csrc/ishmem_device.cu",
           "replaces": "src/repro/kernels/ishmem_device.py:47",
           "max_abs_err": 0.0,
           "ms": time_ms(torch, lambda: ishmem_device.paged_gather(data,
                                                                    host)),
           "card_table_ms": time_ms(
               torch, lambda: ishmem_device.paged_gather(data, table)),
           "plain_ms": time_ms(
               torch, lambda: ishmem_device.paged_gather_plain(data, table)),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": time_ms(
               torch, lambda: torch.index_select(padded, 0, idx)),
           "shape": f"data ({R},{W}) bf16, host table ({slots},{nb}), "
                    f"{mapped} mapped"}
    deferred.append((out, "device_ms",
                     lambda: ishmem_device.paged_gather(data, host),
                     "paged_gather_kernel"))
    deferred.append((out, "library_device_ms",
                     lambda: torch.index_select(padded, 0, idx), None))
    return out


def _ring_cases(rc, rma_copy, P, n, dt, dev, gen, torch):
    """(label, kernel call, plain result) for every ring check at one
    (P, chunk length, dtype)."""
    x = (torch.randn(P, n, generator=gen, device=dev) * 50).to(dt)
    cases = [("K5 ring_allgather", lambda: rc.ring_allgather(x),
              rc.ring_allgather_plain(x))]
    for root in (r for r in (0, 3, 7) if r < P):
        cases.append((f"K7 push_broadcast root={root}",
                      lambda root=root: rc.push_broadcast(x, root),
                      rc.push_broadcast_plain(x, root)))
    for off in (1, 3):
        cases.append((f"K4 remote_put offset={off}",
                      lambda off=off: rma_copy.remote_put(
                          x, target_offset=off, work_items=128),
                      rma_copy.remote_put_plain(x, off)))
    if dt != torch.int32:
        xa = torch.randn(P, P, n, generator=gen, device=dev).to(dt)
        cases.append(("K6 ring_reduce_scatter",
                      lambda: rc.ring_reduce_scatter(xa),
                      rc.ring_reduce_scatter_plain(xa)))
    return cases


def check_ring(torch, rc, rma_copy, _build, dev, deferred):
    """K4-K8 against their plain versions, bitwise, each check repeated
    REPEATS times on poisoned output, landing and flag memory; then timed at
    the collectives path's main shapes (P=8) beside the plain version, the
    yardstick and the bound."""
    gen = torch.Generator(device=dev).manual_seed(4)
    checks = 0
    with poisoned(torch, dev):
        for P in (2, 4, 8):
            for n in (1, 127, 128 * 40 + 37):
                for dt in (torch.float32, torch.bfloat16, torch.int32):
                    for label, kernel, want in _ring_cases(
                            rc, rma_copy, P, n, dt, dev, gen, torch):
                        for _ in range(REPEATS):
                            got = kernel()
                            torch.cuda.synchronize()
                            if not torch.equal(got, want):
                                fail(f"{label} differs from its plain "
                                     f"version: P={P} n={n} {dt}")
                            checks += 1
            for _ in range(REPEATS):
                got = rc.barrier_push(P, device=dev)
                torch.cuda.synchronize()
                if got.tolist() != [1] * P:
                    fail(f"K8 barrier_push returned {got.tolist()} at P={P}")
                checks += 1
        # K8's counters persist under an epoch; a change of P zeroes them
        outs = [rc.barrier_push(1 + i % 8, device=dev) for i in range(800)]
        torch.cuda.synchronize()
        if not bool((torch.cat(outs) == 1).all()):
            fail("K8 barrier_push missed a PE over calls whose P changes")
        checks += len(outs)
    say(f"K4-K8 edge shapes: {checks} checks on poisoned memory, bitwise "
        "equal to the plain versions")

    P = 8
    hidden = torch.randn(P, 512 * 2560, generator=gen, device=dev)
    small = torch.randn(P, 2560, generator=gen, device=dev)
    shard = torch.randn(P, 163840, generator=gen, device=dev)
    rows = torch.randn(P, P, 163840, generator=gen, device=dev)
    leaf = torch.randn(P, 2560 * 9728, generator=gen,
                       device=dev).bfloat16()
    main = [
        ("remote_put", "K4", "src/repro/kernels/rma_copy.py:104",
         lambda: rma_copy.remote_put(hidden, target_offset=1,
                                     work_items=128),
         lambda: rma_copy.remote_put_plain(hidden, 1),
         lambda: torch.roll(hidden, 1, 0),
         2 * hidden.numel() * 4,
         "x (8, 1310720) f32: the prefill hidden (512, 2560) per PE"),
        ("ring_allgather", "K5", "src/repro/kernels/ring_collectives.py:67",
         lambda: rc.ring_allgather(shard), lambda: rc.ring_allgather_plain(shard),
         lambda: shard.unsqueeze(0).expand(P, *shard.shape).contiguous(),
         (P + P * P) * shard[0].numel() * 4,          # read x, write out
         "x (8, 163840) f32: the all-gather of the prefill RS+AG psum"),
        ("ring_reduce_scatter", "K6",
         "src/repro/kernels/ring_collectives.py:125",
         lambda: rc.ring_reduce_scatter(rows),
         lambda: rc.ring_reduce_scatter_plain(rows), lambda: rows.sum(0),
         (P * P + P) * rows[0, 0].numel() * 4,        # read x, write out
         "x (8, 8, 163840) f32: the reduce-scatter of the prefill psum"),
        ("push_broadcast", "K7", "src/repro/kernels/ring_collectives.py:186",
         lambda: rc.push_broadcast(leaf, 0),
         lambda: rc.push_broadcast_plain(leaf, 0),
         lambda: leaf[0].expand_as(leaf).contiguous(),
         (P + 1) * leaf[0].numel() * 2,
         "x (8, 24903680) bf16: one w_gate leaf, root 0"),
    ]
    rows_out = []
    for name, k, replaces, kernel, plain, library, nbytes, shape in main:
        want = plain()
        with poisoned(torch, dev):
            for _ in range(REPEATS):
                got = kernel()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"{k} {name} differs from its plain version at "
                         f"{shape}")
        del got, want
        rows_out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/ring_collectives.cu",
            "replaces": replaces, "max_abs_err": 0.0,
            "ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(torch, library), "shape": shape})
    deferred.append((rows_out[0], "device_ms",
                     lambda: rma_copy.remote_put(small, target_offset=1,
                                                 work_items=8),
                     "remote_put_kernel"))
    deferred.append((rows_out[1], "device_ms",
                     lambda: rc.ring_allgather(shard), "allgather_pull"))
    deferred.append((rows_out[1], "library_device_ms",
                     lambda: shard.unsqueeze(0).expand(
                         P, *shard.shape).contiguous(), None))
    deferred.append((rows_out[2], "device_ms",
                     lambda: rc.ring_reduce_scatter(rows),
                     "reduce_scatter_pull"))
    for row, case in zip(rows_out, main):        # at each main shape
        if row["name"] != "ring_allgather":      # K5's is taken above
            deferred.append((row, "library_device_ms", case[5], None))
    deferred.append((rows_out[0], "main_device_ms", main[0][3],
                     "remote_put_kernel"))
    deferred.append((rows_out[3], "device_ms",
                     lambda: rc.push_broadcast(leaf, 0), "broadcast_pull"))
    rows_out[0]["device_shape"] = "x (8, 2560) f32, work_items 8: " \
        "psum_overlap's small branch at decode"
    lib = _build.lib()

    def noop():
        rc_ = lib.ishmem_coop_noop(dev.index or 0, P,
                                   torch.cuda.current_stream().cuda_stream)
        if rc_:
            fail(f"empty cooperative launch failed: CUDA error {rc_}")

    barrier = {
        "name": "barrier_push", "route": "cuda",
        "source": "src/repro_torch/csrc/ring_collectives.cu",
        "replaces": "src/repro/kernels/ring_collectives.py:219",
        "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: rc.barrier_push(P, device=dev)),
        "plain_ms": time_ms(torch, lambda: rc.barrier_push_plain(P, dev)),
        "bound_ms": time_ms(torch, noop), "bound_by": "operations",
        "library_ms": None,
        "shape": "8 PEs; bound = one empty cooperative launch of 8 CTAs"}
    # every device operation of one call (a memset would show), and the
    # kernel alone
    deferred.append((barrier, "device_ms",
                     lambda: rc.barrier_push(P, device=dev), None))
    deferred.append((barrier, "kernel_device_ms",
                     lambda: rc.barrier_push(P, device=dev),
                     "barrier_kernel"))
    deferred.append((barrier, "noop_device_ms", noop, "noop_kernel"))
    return rows_out + [barrier]


def check_reduce_tile(torch, rt, dev, deferred):
    """K9 at T in {1, 2, 5, 8}, N in {128, 640, 1024}, every op and dtype,
    and with a base pointer off the 16-byte grid, bitwise; timed at the 8
    PE partials of the prefill hidden that the engine-path reduce folds,
    (8, 1310720) f32 sum."""
    gen = torch.Generator(device=dev).manual_seed(5)
    checks = 0
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        for op in ("sum", "max", "min", "prod"):
            scale = 3 if op == "prod" else 50
            for T in (1, 2, 5, 8):
                for N in (128, 640, 1024):
                    x = (torch.randn(T, N, generator=gen, device=dev)
                         * scale).to(dt)
                    got = rt.reduce_tile(x, op)
                    torch.cuda.synchronize()
                    if not torch.equal(got, rt.reduce_tile_plain(x, op)):
                        fail(f"K9 reduce_tile differs from its plain "
                             f"version: {dt} {op} T={T} N={N}")
                    checks += 1
            flat = (torch.randn(3 * 640 + 1, generator=gen, device=dev)
                    * scale).to(dt)
            x = flat[1:].view(3, 640)               # off the 16-byte grid
            if not torch.equal(rt.reduce_tile(x, op),
                               rt.reduce_tile_plain(x, op)):
                fail(f"K9 reduce_tile differs at an unaligned base: {dt} "
                     f"{op}")
            checks += 1
    say(f"K9 edge shapes: {checks} checks, bitwise equal to the plain "
        "version")
    rows = torch.randn(8, 1310720, generator=gen, device=dev)
    if not torch.equal(rt.reduce_tile(rows), rt.reduce_tile_plain(rows)):
        fail("K9 reduce_tile differs from its plain version at (8, 1310720)")
    out = {"name": "reduce_tile", "route": "cuda",
           "source": "src/repro_torch/csrc/reduce_tile.cu",
           "replaces": "src/repro/kernels/reduce_tile.py:39",
           "max_abs_err": 0.0,
           "ms": time_ms(torch, lambda: rt.reduce_tile(rows)),
           "plain_ms": time_ms(torch, lambda: rt.reduce_tile_plain(rows)),
           "bound_ms": 9 * rows[0].numel() * 4 / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes",
           "library_ms": time_ms(torch, lambda: rows.sum(0)),
           "shape": "rows (8, 1310720) f32, sum: the 8 PE partials of the "
                    "prefill hidden (512, 2560)"}
    deferred.append((out, "device_ms", lambda: rt.reduce_tile(rows),
                     "reduce_tile_kernel"))
    deferred.append((out, "library_device_ms", lambda: rows.sum(0), None))
    return out


def _partial_errs(torch, got, want, seen):
    """Largest |difference| of the raw acc, of the normalised acc/l, of m
    and of l on the rows that see a key, and whether each is within TOL
    float32.  acc is a sum of up to l weighted values, so its rounding
    grows with l: raw acc is held within TOL * (l + |acc|) per row, the
    others within TOL absolute and relative."""
    tol = TOL["float32"]
    (a, m, l), (pa, pm, pl) = got, want
    quads = ((a, pa, (tol * pl[..., None]).expand_as(pa)),
             (a / l[..., None], pa / pl[..., None], None), (m, pm, None),
             (l, pl, None))
    errs, ok = [], True
    for x, y, atol in quads:
        x, y = x[:, seen], y[:, seen]
        atol = tol if atol is None else atol[:, seen]
        errs.append(float((x - y).abs().max()) if x.numel() else 0.0)
        ok = ok and bool(((x - y).abs() <= atol + tol * y.abs()).all())
    return errs, ok


K10_EDGES = ((64, 64, 0, 0, 4, 128), (100, 37, 50, 10, 2, 64),
             (37, 100, 0, 20, 3, 128), (128, 128, 0, 128, 2, 128),
             (96, 160, 64, 0, 2, 64), (1, 1, 0, 0, 1, 128),
             (65, 33, 33, 0, 2, 128), (63, 31, 31, 0, 2, 64),
             (70, 45, 200, 100, 3, 128), (130, 257, 300, 0, 2, 64),
             (200, 200, 0, 0, 2, 128), (64, 64, 0, 0, 4, 32),
             (37, 100, 0, 20, 3, 32), (100, 37, 50, 10, 2, 80),
             (130, 257, 300, 0, 2, 80), (65, 33, 33, 0, 2, 80))


def _k10_timed(torch, dev_kern, dev, q, k, v, q_off, k_off, tag):
    """K10 on (1, Sh, H, hd) f32 shards at absolute offsets: held to its
    plain version on every row (all see a key), timed beside it and beside
    one call of the memory-efficient SDPA kernel with the offset mask as
    its bias and the log-sum-exp; the bound counts the unmasked products,
    three TF32 products each.  Returns (row, errs)."""
    _, Sh, H, hd = q.shape
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def kernel():
        return dev_kern.flash_partial(q, k, v, q_off=q_off, k_off=k_off)

    def plain():
        return dev_kern.flash_partial_plain(q, k, v, q_off=q_off,
                                            k_off=k_off)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    seen = torch.ones(Sh, dtype=torch.bool, device=dev)
    errs, ok = _partial_errs(torch, got, want, seen)
    say(f"K10 {tag} (1,{Sh},{H},{hd}) f32 q_off={q_off} k_off={k_off}: "
        f"max|err| acc {errs[0]:.3e} acc/l {errs[1]:.3e} m "
        f"{errs[2]:.3e} l {errs[3]:.3e} (l up to "
        f"{float(want[2].max()):.1f})")
    if not ok:
        fail(f"K10 flash_partial differs from its plain version at the "
             f"ring path's {tag} shape")
    qpos = q_off + torch.arange(Sh, device=dev)
    kpos = k_off + torch.arange(Sh, device=dev)
    visible = kpos[None, :] <= qpos[:, None]
    pairs = int(visible.sum()) * H
    bias = torch.zeros(Sh, Sh, device=dev).masked_fill(
        ~visible, float("-inf"))[None, None].expand(1, H, Sh, Sh)
    library_ms, why = None, ""
    try:
        out = torch.ops.aten._scaled_dot_product_efficient_attention(
            qt, kt, vt, bias, True)[0]
        lib_err = float((out.transpose(1, 2) -
                         got[0] / got[2][..., None]).abs().max())
        say(f"K10 {tag} library yardstick agrees to {lib_err:.3e} "
            f"(out vs acc/l)")
        library_ms = time_ms(torch, lambda: torch.ops.aten.
                             _scaled_dot_product_efficient_attention(
                                 qt, kt, vt, bias, True), iters=5)
    except RuntimeError as exc:          # the yardstick only
        why = str(exc).splitlines()[0]
        say(f"K10 {tag} library yardstick refused: {why}")
    del got, want
    flops = 4 * hd * pairs
    nbytes = (4 * Sh * H * hd + 2 * Sh * H) * 4   # q, k, v, acc; m, l
    t_ops = 3 * flops / PEAK_FLOPS["tf32"]        # three TF32 products
    t_fma = flops / PEAK_FLOPS["float32"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    row = {
        "ms": time_ms(torch, kernel, iters=5),
        "plain_ms": time_ms(torch, plain, iters=5),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "fma_bound_ms": max(t_fma, t_bytes) * 1e3,
        "library_ms": library_ms, "library_refused": why or None,
        "flops": flops, "shape": f"K10 {tag}, q_off {q_off}, k_off "
                                 f"{k_off}"}
    torch.cuda.empty_cache()
    return row, errs


def check_flash_partial_width(torch, dev_kern, dev, deferred, *, name, Sh,
                              H, hd, me, path):
    """K10 at another head dim, at the shapes of the phase-6 ring that runs
    it (``path``): PE ``me`` against shard 0, every key visible, f32.  A
    row of its own, with its device time taken last."""
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(1, Sh, H, hd, generator=gen, device=dev)
               for _ in range(3))
    row, errs = _k10_timed(torch, dev_kern, dev, q, k, v, me * Sh, 0, name)
    out = {"name": name, "route": "cuda",
           "source": "src/repro_torch/csrc/flash_partial.cu",
           "replaces": "src/repro/kernels/ishmem_device.py:213",
           "max_abs_err": max(errs[1], errs[2]), "raw_acc_err": errs[0],
           **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "fma_bound_ms", "flops")},
           "shape": f"q/k/v (1,{Sh},{H},{hd}) f32, PE {me} against shard "
                    f"0 (all keys visible), the shapes of {path}; "
                    "max_abs_err over acc/l and m",
           "split_ms": time_ms(torch, lambda: dev_kern.flash_partial_split(
               q, k, v), iters=10)}
    if row["library_refused"]:
        out["library_refused"] = row["library_refused"]
    deferred.append((out, "device_ms", lambda: dev_kern.flash_partial(
        q, k, v, q_off=me * Sh, k_off=0), "flash_partial_tf32"))
    say(f"{name} [{out['shape']}]: {out['ms']:.4f} ms by events, plain "
        f"{out['plain_ms']:.4f} ms, efficient SDPA {out['library_ms']} ms, "
        f"bound (3 x TF32) {out['bound_ms']:.5f} ms ({out['bound_by']}), "
        f"split pass {out['split_ms']:.4f} ms")
    return out


def check_flash_partial(torch, dev_kern, dev, deferred):
    """K10 at edge shapes (Sq != Skv, Sq and Skv off the 64-row and 32-key
    tiles and off 8, bf16, head dims 32, 64, 80 and 128, tiles whose rows
    see no
    key) against its plain version, and its split pass bitwise against the
    split's plain version; then at the ring path's shapes, 8 PEs over S =
    32768: one diagonal partial (PE 7's own shard) and one off-diagonal
    partial (PE 7 against shard 0), H = 32, hd = 128, f32, timed beside the
    plain version, the split pass alone, and one call of the
    memory-efficient SDPA kernel with the offset mask as its bias and the
    log-sum-exp (the same function: acc = out * l, lse = m + log l).  The
    bound is the split design's: three TF32 products per unmasked product
    at 495 TFLOP/s; the f32 FMA bound stands beside it."""
    gen = torch.Generator(device=dev).manual_seed(6)
    tol = TOL["float32"]
    for dt in (torch.float32, torch.bfloat16):
        for Sq, Skv, qo, ko, H, hd in K10_EDGES:
            q = torch.randn(1, Sq, H, hd, generator=gen, device=dev).to(dt)
            k = torch.randn(1, Skv, H, hd, generator=gen, device=dev).to(dt)
            v = torch.randn(1, Skv, H, hd, generator=gen, device=dev).to(dt)
            got = dev_kern.flash_partial(q, k, v, q_off=qo, k_off=ko)
            want = dev_kern.flash_partial_plain(q, k, v, q_off=qo, k_off=ko)
            torch.cuda.synchronize()
            seen = qo + torch.arange(Sq, device=dev) >= ko
            errs, ok = _partial_errs(torch, got, want, seen)
            blind = ~seen
            blind_ok = (bool((got[1][:, blind] == -1e30).all())
                        and bool((got[2][:, blind] == Skv).all())
                        and bool(torch.isclose(got[0][:, blind],
                                               want[0][:, blind], rtol=tol,
                                               atol=tol).all()))
            merged = float((dev_kern.merge_partials([got]) -
                            dev_kern.merge_partials([want])).abs().max())
            say(f"K10 {dt} Sq={Sq} Skv={Skv} q_off={qo} k_off={ko} H={H} "
                f"hd={hd}: max|err| acc {errs[0]:.3e} acc/l {errs[1]:.3e} m "
                f"{errs[2]:.3e} l {errs[3]:.3e} merged {merged:.3e}; "
                f"{int(blind.sum())} blind rows")
            if not (ok and blind_ok and merged <= tol):
                fail(f"K10 flash_partial differs from its plain version "
                     f"({dt}, Sq={Sq}, Skv={Skv}, offsets {qo}/{ko})")
            again = dev_kern.flash_partial(q, k, v, q_off=qo, k_off=ko)
            split = dev_kern.flash_partial_split(q, k, v)
            split_want = dev_kern.flash_partial_split_plain(q, k, v)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"K10 flash_partial: two runs differ ({dt}, Sq={Sq}, "
                     f"Skv={Skv}, offsets {qo}/{ko})")
            if not all(torch.equal(a, b) for a, b in zip(split, split_want)):
                fail(f"K10 split pass differs from its plain version ({dt}, "
                     f"Sq={Sq}, Skv={Skv}, H={H}, hd={hd})")
    say(f"K10: {2 * len(K10_EDGES)} edge shapes within {tol}, bitwise run "
        "to run, split pass bitwise")
    Sh, H, hd, me = 4096, 32, 128, 7
    q, k, v = (torch.randn(1, Sh, H, hd, generator=gen, device=dev)
               for _ in range(3))
    rows, worst, raw_acc = {}, 0.0, 0.0
    for tag, k_off in (("diag", me * Sh), ("offdiag", 0)):
        rows[tag], errs = _k10_timed(torch, dev_kern, dev, q, k, v,
                                     me * Sh, k_off, tag)
        worst = max(worst, errs[1], errs[2])
        raw_acc = max(raw_acc, errs[0])
    split_ms = time_ms(torch, lambda: dev_kern.flash_partial_split(q, k, v),
                       iters=10)
    off = rows["offdiag"]
    out = {"name": "flash_partial", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_partial.cu",
           "replaces": "src/repro/kernels/ishmem_device.py:213",
           "max_abs_err": worst, **{k: off[k] for k in (
               "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
           "shape": f"q/k/v (1,{Sh},{H},{hd}) f32, PE 7 against shard 0 "
                    "(all keys visible; 28 of the 36 ring partials are "
                    "off-diagonal); max_abs_err over acc/l and m of both "
                    "partials",
           "raw_acc_err": raw_acc, "fma_bound_ms": off["fma_bound_ms"],
           "split_ms": split_ms, "flops": off["flops"],
           "diag": rows["diag"]}
    if off["library_refused"]:
        out["library_refused"] = off["library_refused"]
    for row, k_off in ((out, 0), (rows["diag"], me * Sh)):
        deferred.append((row, "device_ms", lambda k_off=k_off: dev_kern.
                         flash_partial(q, k, v, q_off=me * Sh, k_off=k_off),
                         "flash_partial_tf32"))
    # the split pass's three kernels together, per call
    deferred.append((out, "split_device_ms",
                     lambda: dev_kern.flash_partial_split(q, k, v), None))
    say(f"K10 ring shapes: off-diagonal {off['ms']:.4f} ms, diagonal "
        f"{rows['diag']['ms']:.4f} ms by events, of which the split pass "
        f"{split_ms:.4f} ms; bounds (3 x TF32) {off['bound_ms']:.4f} / "
        f"{rows['diag']['bound_ms']:.4f} ms, f32 FMA "
        f"{off['fma_bound_ms']:.4f} / {rows['diag']['fma_bound_ms']:.4f} ms; "
        f"efficient SDPA {off['library_ms']} / {rows['diag']['library_ms']} "
        "ms")
    return out


def check_fused_paged_attn(torch, dev_kern, flash_attn, ops, sched, label):
    """K11 on the decode pool that a fused serving run (``label``) leaves:
    every slot of decode PE 2 mapped to a full request's table of blocks
    (which hold that run's K/V), the model's query heads over its first
    paged K/V leaf (qwen3-4b: 32 over 8 of 128; zamba2: 32 of 80), bf16.
    ``fused_paged_attn`` must launch the paged kernel once and neither K3
    nor K2, and equal ``assemble`` + K2 bitwise at the first and the last
    layer, on that pool and on a copy whose unused blocks are NaN; then it
    is held to its plain version (2e-2, bf16) and timed beside it and
    beside the route it replaces (device waits, K3 over every table block,
    K2: the port's K11 before this kernel)."""
    from repro_torch.core import device as device_mod
    from repro_torch.core.heap import TORCH_DTYPES
    from repro_torch.serve.paged_attn import PagedDecodeView
    pe = sched.decode_pes[0]
    pool, heap = sched.pool, sched.heap
    lay = pool.layout
    view = PagedDecodeView(pool, pe, len(sched.banks[pe].active))
    for s in range(view.num_slots):
        rid = 1_000_000 + s
        if pool.alloc(rid, lay.blocks_per_request) is None:
            fail("K11 check: the pool has no free table for a slot")
        heap = view.attach(heap, s, rid, fresh_ids=[])
    leaf = next(x for x in lay.paged if x.key == "k")
    gen = torch.Generator(device=heap.device).manual_seed(7)
    q = torch.randn(view.num_slots, leaf.width, sched.engine.cfg.num_heads,
                    leaf.hd, generator=gen, device=heap.device).to(
                        TORCH_DTYPES[lay.kv_dtype])
    wg = device_mod.work_group(sched.ctx, pe=pe)
    waits = [(pool.sig_ptr(s), 0) for s in range(view.num_slots)]
    cache = sched.banks[pe].cache
    table = view.table()
    unused = sorted(set(range(pool.num_blocks)) - set(table.ravel().tolist()))
    nan_pools = heap.pools[pool.data.dtype].clone()
    nan_pools[pe, pool.data.offset:pool.data.offset + pool.data.size].view(
        pool.num_blocks, lay.block_words)[unused] = float("nan")
    nan_heap = dataclasses.replace(
        heap, pools={**heap.pools, pool.data.dtype: nan_pools})
    per_call = None
    for label, h in ((label, heap),
                     (f"its copy with {len(unused)} unused blocks NaN",
                      nan_heap)):
        assembled = view.assemble(h, cache)
        for layer in (0, leaf.reps - 1):
            ops.reset_launches()
            _, got = dev_kern.fused_paged_attn(wg, h, view, q, layer=layer,
                                               waits=waits)
            per_call = {k: n for k, n in ops.LAUNCHES.items() if n}
            if per_call != {"fused_paged_attn": 1}:
                fail(f"K11 launched {per_call} in one call, not one "
                     "fused_paged_attn and no K3 or K2")
            k = assembled["blocks"][leaf.unit_idx]["k"][layer].contiguous()
            v = assembled["blocks"][leaf.unit_idx]["v"][layer].contiguous()
            want = flash_attn.flash_attention(q, k, v)
            torch.cuda.synchronize()
            if not torch.equal(got, want) or not bool(got.isfinite().all()):
                fail(f"K11 fused_paged_attn differs from assemble + K2 at "
                     f"layer {layer} on {label}")
        say(f"K11 fused_paged_attn: one launch a call, bitwise equal to "
            f"assemble + K2 at layers 0 and {leaf.reps - 1} on {label}: q "
            f"{tuple(q.shape)} {lay.kv_dtype} over {view.num_slots} x "
            f"{lay.blocks_per_request} blocks")
        del assembled
    del nan_heap, nan_pools
    torch.cuda.empty_cache()
    offs = lay.leaf_offsets
    v_leaf = next(x for x in lay.paged
                  if x.unit_idx == leaf.unit_idx and x.key == "v")

    def fused():
        return dev_kern.fused_paged_attn(wg, heap, view, q, waits=waits)[1]

    def plain():
        data = heap.read(pool.data, pe).reshape(pool.num_blocks,
                                                lay.block_words)
        return dev_kern.fused_paged_attn_plain(
            data, view.table(), q, k_off=offs[(leaf.unit_idx, "k")],
            v_off=offs[(leaf.unit_idx, "v")], leaf=leaf, layer=0,
            block_tokens=lay.block_tokens)

    def composed():
        # the port's K11 before this kernel: device waits, a work-group
        # get, K3 over every table block's payload, K2 on layer 0
        h = heap
        for sig_ptr, expected in waits:
            h, _, _ = device_mod.signal_wait_until(wg, h, sig_ptr, pe, "ge",
                                                   expected)
        data = device_mod.get_view(wg, h, pool.data, pe).reshape(
            pool.num_blocks, lay.block_words)
        pay = dev_kern.paged_gather(data, view.table())
        k, v = (lay.gathered_leaf(pay, x)[0] for x in (leaf, v_leaf))
        return flash_attn.flash_attention(q, k.contiguous(), v.contiguous())

    got, want, before = fused(), plain(), composed()
    torch.cuda.synchronize()
    if not torch.equal(got, before):
        fail("K11 differs from the K3 + K2 route it replaces at layer 0")
    err = float((got.float() - want.float()).abs().max())
    if not bool(torch.isclose(got.float(), want.float(), rtol=TOL[
            "bfloat16"], atol=TOL["bfloat16"]).all()):
        fail(f"K11 is {err:.3e} from its plain version, outside "
             f"{TOL['bfloat16']}")
    del got, want, before

    # the function's least bytes: q and out, and one layer's K and V of the
    # mapped blocks (a block payload holds all the layers'); its operations:
    # causal QK^T and PV over the assembled width
    width, nq = leaf.width, q.shape[2]
    nbytes = 2 * q.numel() * q.element_size() + \
        2 * view.num_slots * width * leaf.nkv * leaf.hd * q.element_size()
    flops = 4 * leaf.hd * nq * view.num_slots * width * (width + 1) // 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"]
    row = {"name": "fused_paged_attn", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attn.cu",
           "replaces": "src/repro/kernels/ishmem_device.py:116",
           "max_abs_err": err, "ms": time_ms(torch, fused),
           "plain_ms": time_ms(torch, plain, iters=5),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "launches_per_call": per_call,
           "before_ms": time_ms(torch, composed),
           "shape": f"q {tuple(q.shape)} bf16 over decode PE {pe}'s pool "
                    f"({pool.num_blocks} blocks of {lay.block_words} words)"}
    # device times, taken here, not last, so that the pool they read is
    # freed before phase 6: the kernel alone, every device operation of one
    # call (the table's copy too), and the route it replaces, whole and in
    # its K3 and K2 launches
    row["device_ms"] = device_ms(torch, fused, "paged_flash_wgmma", iters=20)
    row["call_device_ms"] = device_ms(torch, fused, None, iters=20)
    row["before_device_ms"] = device_ms(torch, composed, None, iters=20)
    row["before_device_ms_gather"] = device_ms(
        torch, composed, "paged_gather_kernel", iters=20)
    row["before_device_ms_flash"] = device_ms(torch, composed,
                                              "flash_fwd_wgmma", iters=20)
    for s in range(view.num_slots):
        pool.release(1_000_000 + s)
    return row


def _serve_phase(torch, ops, serve, argv, label):
    """Run the serving launcher with launch counts zeroed just before;
    returns (sched, launches, wall s, peak GiB)."""
    say(f"{label}: serve " + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched = serve.main(argv)
    torch.cuda.synchronize()
    return (sched, dict(ops.LAUNCHES), time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2**30)


def _balanced(sched, label, n=8):
    st = sched.stats
    counts = (st.prefills, st.migrations, st.admissions, st.evictions)
    if counts != (n,) * 4 or len(sched.ctx.pending) or \
            sched.pool.stats()["blocks_in_use"]:
        fail(f"{label}: counters {counts} do not balance, "
             f"{len(sched.ctx.pending)} ops stay pending or "
             f"{sched.pool.stats()['blocks_in_use']} blocks stay in use")


def _same_tokens(sched, want, label):
    for rid, req in sorted(sched.requests.items()):
        if req.out != want[rid]:
            fail(f"{label}: request {rid} tokens {req.out} != {want[rid]}")


def phase_stream(torch, ops, serve, export, barrier_out, barrier_ttfd):
    """Phase 7: phase 3's run with 4-block installments and the span
    tracer on.  Returns its launch counts."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        trace = str(Path(tmp) / "trace.json")
        sched, launches, wall, peak = _serve_phase(
            torch, ops, serve, STREAM_ARGV + ["--trace", trace],
            "streamed serving path")
        doc = json.loads(Path(trace).read_text())
    st = sched.stats
    ttfd = sum(st.ttfd_model_s) / len(st.ttfd_model_s)
    say(f"streamed serving path: {wall:.2f} s wall, {st.decode_steps} "
        f"decode steps, peak {peak:.1f} GiB; launches {launches}; "
        f"{st.stream_chunks} installments; mean modeled TTFD window "
        f"{ttfd * 1e6:.3f} us (phase 3: {barrier_ttfd * 1e6:.3f} us); trace "
        f"{len(doc['traceEvents'])} events")
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        fail(f"streamed serving path never launched {missing}")
    _balanced(sched, "streamed serving path")
    if st.stream_chunks != STREAM_CHUNKS:
        fail(f"{st.stream_chunks} installments, not {STREAM_CHUNKS}")
    if sched.pool.stats()["streams_active"]:
        fail("a stream-signal word never went back to the free list")
    if not ttfd < barrier_ttfd:
        fail(f"streamed mean TTFD window {ttfd} is not below phase 3's "
             f"{barrier_ttfd}")
    errors = export.validate(doc)
    if errors:
        fail(f"the streamed run's trace does not validate: {errors[:3]}")
    chains = export.request_chains_doc(doc)
    want = ["streaming", "parked", "migrating", "decoding"]
    for rid in range(8):
        phases = [e["phase"] for e in chains.get(rid, [])]
        if [p for p in phases if p in want] != want or \
                export.chain_gaps(chains[rid]):
            fail(f"request {rid}: chain {phases} does not pass through "
                 f"{want} without gaps")
    _same_tokens(sched, barrier_out, "streamed serving path (vs phase 3, "
                 "traced against untraced)")
    say("8/8 streamed requests bitwise equal to phase 3 (tracing on "
        "against off); 8 chains through streaming, parked, migrating, "
        "decoding")
    return launches


def phase_prefix(torch, ops, serve):
    """Phase 8: every request a sample of one 520-token prompt, stepped
    here so that the prefix entry's resident blocks are held to their home
    rows after every step.  Returns its launch counts."""
    say("shared-prefix serving path: serve " + " ".join(PREFIX_ARGV))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched, args = serve.build_disagg(PREFIX_ARGV)
    pool, checked, steps = sched.pool, 0, 0
    while not sched.done():
        if steps >= 10_000:
            fail("shared-prefix scheduler wedged")
        sched.step()
        steps += 1
        for entry in sched.prefix_index.values():
            for pe, ids in entry.resident.items():
                for bid in ids:
                    ptr = pool.block_ptr(bid)
                    if not torch.equal(sched.heap.read(ptr, pe),
                                       sched.heap.read(ptr, entry.home_pe)):
                        fail(f"step {steps}: prefix block {bid} at PE {pe} "
                             f"differs from its home row on PE "
                             f"{entry.home_pe}")
                    checked += 1
    serve.report_disagg(sched, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    st = sched.stats
    say(f"shared-prefix serving path: {wall:.2f} s wall (the pristine "
        f"checks included), {st.decode_steps} decode steps, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches "
        f"{launches}; {st.prefix_hits} prefix hits, "
        f"{st.blocks_prefix_shared} blocks mapped, {st.bytes_wire_saved} "
        f"wire B saved, {st.cow_copies} copy-on-writes; {checked} resident "
        f"prefix blocks held bitwise to their home rows")
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        fail(f"shared-prefix serving path never launched {missing}")
    _balanced(sched, "shared-prefix serving path")
    if (st.prefix_hits, st.cow_copies) != (PREFIX_HITS, COW_COPIES) or \
            not st.bytes_wire_saved > 0 or not checked:
        fail(f"prefix hits {st.prefix_hits} (want {PREFIX_HITS}), COW "
             f"copies {st.cow_copies} (want {COW_COPIES}), wire bytes saved "
             f"{st.bytes_wire_saved}, {checked} pristine checks")
    eng, base = sched.engine, {}
    for rid, req in sorted(sched.requests.items()):
        if req.slot not in base:
            base[req.slot] = eng.generate_in_slot(
                req.batch, sched.scfg, num_slots=args.slots, slot=req.slot)
        if req.out != base[req.slot]:
            fail(f"request {rid}: shared-prefix tokens {req.out} != "
                 f"single-PE baseline {base[req.slot]} at S = {PREFIX_LEN}")
    say(f"8/8 shared-prefix requests bitwise equal to the single-PE "
        f"baseline at S = {PREFIX_LEN}")
    return launches


def phase_dense(torch, ops, serve, barrier_out):
    """Phase 9: phase 3's run with dense-rehydrate admission: K3 must not
    launch.  Returns its launch counts."""
    sched, launches, wall, peak = _serve_phase(
        torch, ops, serve, DENSE_ARGV, "dense-rehydrate serving path")
    say(f"dense-rehydrate serving path: {wall:.2f} s wall, "
        f"{sched.stats.decode_steps} decode steps, peak {peak:.1f} GiB; "
        f"launches {launches}")
    if not (launches["copy_into"] and launches["flash_attention"]) or \
            launches["paged_gather"]:
        fail(f"dense-rehydrate path launched K1 {launches['copy_into']}, "
             f"K2 {launches['flash_attention']}, K3 "
             f"{launches['paged_gather']} times (want K1, K2 and no K3)")
    _balanced(sched, "dense-rehydrate serving path")
    _same_tokens(sched, barrier_out, "dense-rehydrate serving path (vs "
                 "phase 3)")
    say("8/8 dense-rehydrate requests bitwise equal to phase 3; no K3 "
        "launch")
    return launches


def _check_tokens(sched, label):
    """Every request's tokens bitwise equal to the single-PE baseline at
    the same shapes."""
    eng, slots = sched.engine, len(sched.banks[sched.decode_pes[0]].active)
    for rid, req in sorted(sched.requests.items()):
        base = eng.generate_in_slot(req.batch, sched.scfg, num_slots=slots,
                                    slot=req.slot)
        if base != req.out:
            fail(f"{label}: request {rid} tokens {req.out} != single-PE "
                 f"baseline {base}")
    _, logits, _ = eng.prefill_request(sched.requests[0].batch)
    if logits.shape != (1, eng.cfg.vocab_size) or \
            not bool(logits.isfinite().all()):
        fail(f"{label}: prefill logits not finite of shape (1, vocab)")
    n = len(sched.requests)
    say(f"{n}/{n} {label} requests bitwise equal to the single-PE baseline")


def _first_block(sched):
    st = sched.stats
    return sum(st.ttfd_first_block_steps) / len(st.ttfd_first_block_steps)


def phase_zamba(torch, ops, serve):
    """Phase 10: zamba2-2.7b at full widths and depth with phase 3's
    traffic.  Returns (tokens, mean first-block step, launches)."""
    sched, launches, wall, peak = _serve_phase(
        torch, ops, serve, ZAMBA_ARGV, "zamba2 serving path")
    lay = sched.pool.layout
    say(f"zamba2 serving path: {wall:.2f} s wall, "
        f"{sched.stats.decode_steps} decode steps, peak {peak:.1f} GiB; "
        f"launches K1 {launches['copy_into']}, K2 "
        f"{launches['flash_attention']}, K3 {launches['paged_gather']}; "
        f"layout: {len(lay.paged)} paged leaves of "
        f"{[(x.reps, x.nkv, x.hd) for x in lay.paged]}, {len(lay.tail)} "
        f"tail leaves, {lay.block_words} words a block, {lay.tail_words} "
        f"tail words a request")
    if (len(lay.paged), len(lay.tail), lay.block_words, lay.tail_words) != \
            (2, 10, ZAMBA_BLOCK_WORDS, ZAMBA_TAIL_WORDS) or \
            {(x.reps, x.hd) for x in lay.paged} != {(9, 80)}:
        fail("zamba2's pool layout is not 2 paged leaves of 9 x 80 and 10 "
             f"tail leaves of {ZAMBA_TAIL_WORDS} words")
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        fail(f"zamba2 serving path never launched {missing}")
    _balanced(sched, "zamba2 serving path")
    _check_tokens(sched, "zamba2")
    return ({rid: list(r.out) for rid, r in sched.requests.items()},
            _first_block(sched), launches)


def phase_zamba_fused(torch, ops, serve, ishmem_device, flash_attn,
                      zamba_out, zamba_fb):
    """Phase 11: phase 10 with ``--fused-attn``, then K11 at head dim 80 on
    its pool.  Returns (launches, K11's row)."""
    sched, launches, wall, peak = _serve_phase(
        torch, ops, serve, ZAMBA_FUSED_ARGV, "zamba2 fused serving path")
    fb = _first_block(sched)
    say(f"zamba2 fused serving path: {wall:.2f} s wall, "
        f"{sched.stats.decode_steps} decode steps, peak {peak:.1f} GiB; "
        f"launches K1 {launches['copy_into']}, K2 "
        f"{launches['flash_attention']}, K3 {launches['paged_gather']}; mean "
        f"first-resident-block step {fb:.3f} (phase 10: {zamba_fb:.3f})")
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        fail(f"zamba2 fused serving path never launched {missing}")
    _balanced(sched, "zamba2 fused serving path")
    if not fb < zamba_fb:
        fail(f"zamba2 fused mean first-block step {fb} is not below phase "
             f"10's {zamba_fb}")
    _same_tokens(sched, zamba_out, "zamba2 fused serving path (vs phase 10)")
    say("8/8 zamba2 fused requests bitwise equal to phase 10")
    row = check_fused_paged_attn(torch, ishmem_device, flash_attn, ops,
                                 sched, "phase 11's pool")
    row.update(name="fused_paged_attn_hd80",
               path="none: the fused serving path reads through assemble, "
                    "as the reference's does")
    say(f"fused_paged_attn (K11) hd 80 [{row['shape']}]: {row['ms']:.4f} ms "
        f"by events, device {row['device_ms']} ms, launches per call "
        f"{row['launches_per_call']}; bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}); plain {row['plain_ms']:.4f} ms; before "
        f"(device waits + K3 + K2) {row['before_ms']:.4f} ms, device "
        f"{row['before_device_ms']} ms; max|err| vs plain "
        f"{row['max_abs_err']:.3e}")
    return launches, row


def phase_xlstm(torch, ops, serve):
    """Phase 12: xlstm-125m at full widths and depth with phase 3's
    traffic: a tail-only migration.  Returns its launch counts."""
    sched, launches, wall, peak = _serve_phase(
        torch, ops, serve, XLSTM_ARGV, "xlstm serving path")
    lay = sched.pool.layout
    say(f"xlstm serving path: {wall:.2f} s wall, "
        f"{sched.stats.decode_steps} decode steps, peak {peak:.1f} GiB; "
        f"launches K1 {launches['copy_into']}, K2 "
        f"{launches['flash_attention']}, K3 {launches['paged_gather']}; "
        f"layout: {len(lay.paged)} paged leaves, {len(lay.tail)} tail "
        f"leaves, {lay.tail_words} tail words a request")
    if lay.paged or lay.kv_dtype != "float32" or \
            lay.blocks_per_request != 1:
        fail("xlstm's pool layout is not tail-only")
    if not launches["copy_into"] or launches["flash_attention"] or \
            launches["paged_gather"]:
        fail(f"xlstm serving path launched K1 {launches['copy_into']}, K2 "
             f"{launches['flash_attention']}, K3 {launches['paged_gather']} "
             "times (want K1 and no K2 or K3)")
    _balanced(sched, "xlstm serving path")
    _check_tokens(sched, "xlstm")
    return launches


def _family_argv(arch, changes):
    """Phase 3's traffic and flags with ``arch`` and ``changes``."""
    argv = [{"qwen3-4b": arch}.get(a, a) for a in MAIN_ARGV]
    for flag, value in changes.items():
        argv[argv.index(flag) + 1] = str(value)
    return argv


def _check_tails(torch, sched, label):
    """Every decode slot's tail in the pool, bitwise the packed tail of a
    fresh prefill of the last request admitted there: the cross K/V, or a
    ring's kpos, whose -1 is a NaN bit pattern in f32 that K1, the pool
    stores and the pack and unpack must carry as bits."""
    from repro_torch.serve import kvpool
    lay, eng, last = sched.pool.layout, sched.engine, {}
    for req in sched.requests.values():
        key = (req.decode_pe, req.slot)
        if key not in last or req.admit_step > last[key].admit_step:
            last[key] = req
    nan = 0
    for (pe, slot), req in sorted(last.items()):
        _, _, cache1 = eng.prefill_request(req.batch)
        want = kvpool.pack_tail(lay, cache1).view(torch.int32)
        got = sched.migrator.gather_tail(sched.heap, slot, pe).view(
            torch.int32)
        if not torch.equal(got, want):
            fail(f"{label}: the tail at PE {pe} slot {slot} is not request "
                 f"{req.rid}'s packed tail bit for bit")
        nan += int(got.view(torch.float32).isnan().sum())
    say(f"{label}: {len(last)} slots' tails ({lay.tail_words} words each, "
        f"{nan} NaN patterns among them) bitwise the packed tails of their "
        "last requests")


def phase_family(torch, ops, serve, spec, extra=(), *, dev):
    """One of phases 13-20: ``spec`` from FAMILIES served through
    ``serve._build_disagg`` at its published widths, with its depth cut
    (``dataclasses.replace(cfg, num_layers=...)``).  Weights are made
    first; launch counts are zeroed after them, just before the scheduler
    is built, and read when it has run.  Returns (scheduler, launches,
    wall s, peak GiB); the caller frees the scheduler and its weights."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import model
    from repro_torch.serve import kvpool
    phase, label, arch, depth, changes, block_words, tail_words = spec
    argv = _family_argv(arch, changes) + list(extra)
    args = serve.parse_args(argv)
    cfg = cfgbase.get_config(arch)
    cut = f"depth {depth} of {cfg.num_layers} layers" if depth else \
        f"depth {cfg.num_layers}, no cut"
    if depth:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    lay = kvpool.build_layout(cfg, args.prompt_len + args.max_new,
                              block_tokens=args.block_tokens)
    if lay.ring:                     # the pool holds three requests' tables
        args.kv_blocks = DANUBE_TABLES * lay.blocks_for_decode(
            args.prompt_len, args.max_new)
        argv[argv.index("--kv-blocks") + 1] = str(args.kv_blocks)
    say(f"phase {phase}, {label}: serve {' '.join(argv)} ({cut})")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    ops.reset_launches()
    t0 = time.perf_counter()
    sched = serve._build_disagg(args, cfg, params)
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    del params
    serve.report_disagg(sched, args)
    peak = torch.cuda.max_memory_allocated() / 2**30
    lay = sched.pool.layout
    say(f"phase {phase}, {label}: {wall:.2f} s wall ({t_init:.2f} s for the "
        f"weights before it), {sched.stats.decode_steps} decode steps, peak "
        f"{peak:.1f} GiB; launches K1 {launches['copy_into']}, K2 "
        f"{launches['flash_attention']}, K3 {launches['paged_gather']}; "
        f"layout: {len(lay.paged)} paged leaves, {len(lay.tail)} tail "
        f"leaves, {lay.block_words} words a block, {lay.tail_words} tail "
        f"words a request, {lay.blocks_per_request} blocks a request"
        f"{' (ring)' if lay.ring else ''}; {cut}; decode graph "
        f"{sched.stats.decode_graph.counter()}")
    if (lay.block_words, lay.tail_words) != (block_words, tail_words):
        fail(f"{label}: layout of {lay.block_words} block words and "
             f"{lay.tail_words} tail words, not {block_words} and "
             f"{tail_words}")
    want = {"copy_into", "paged_gather"} | (
        set() if cfg.attention == "swa" else {"flash_attention"})
    missing = [k for k in sorted(want) if launches[k] == 0]
    if missing:
        fail(f"{label} serving path never launched {missing}")
    _balanced(sched, f"{label} serving path", args.requests)
    return sched, launches, wall, peak


def phase_families(torch, ops, serve, ishmem_device, flash_attn, dev):
    """Phases 13-20.  Returns ({phase: launches}, K11's hd-64 row)."""
    mode_launches, k11 = {}, None
    for spec in FAMILIES:
        phase, label = spec[0], spec[1]
        sched, launches, wall, peak = phase_family(torch, ops, serve, spec,
                                                   dev=dev)
        mode_launches[phase] = launches
        lay = sched.pool.layout
        if lay.ring:
            # phase 17: windowed prefill (plain, as the reference's), and
            # the ring wrapped: position 4096 and on in slots 0 and on
            _, _, cache1 = sched.engine.prefill_request(
                sched.requests[0].batch)
            kmax = int(cache1["blocks"][0]["kpos"].max())
            if launches["flash_attention"] or kmax < lay.cache_width:
                fail(f"{label}: K2 launched {launches['flash_attention']} "
                     f"times (want 0) or the ring never wrapped (largest "
                     f"kpos {kmax}, width {lay.cache_width})")
            say(f"{label}: no K2 launch (windowed prefill); the ring "
                f"wrapped: largest kpos {kmax} over {lay.cache_width} slots")
            del cache1
        if lay.tail_words > 1:
            _check_tails(torch, sched, label)
        _check_tokens(sched, label)
        if phase == "18":
            out = {rid: list(r.out) for rid, r in sched.requests.items()}
            first_block = _first_block(sched)
            del sched
            gc.collect()
            torch.cuda.empty_cache()
            sched, launches, wall, peak = phase_family(
                torch, ops, serve, ("19",) + spec[1:], ["--fused-attn"],
                dev=dev)
            mode_launches["19"] = launches
            fb = _first_block(sched)
            say(f"phase 19, {label} fused: mean first-resident-block step "
                f"{fb:.3f} (phase 18: {first_block:.3f})")
            if not fb < first_block:
                fail(f"whisper fused mean first-block step {fb} is not "
                     f"below phase 18's {first_block}")
            _same_tokens(sched, out, "whisper fused serving path (vs phase "
                         "18)")
            say("8/8 whisper fused requests bitwise equal to phase 18")
            k11 = check_fused_paged_attn(torch, ishmem_device, flash_attn,
                                         ops, sched, "phase 19's pool")
            k11.update(name="fused_paged_attn_hd64",
                       path="none: the fused serving path reads through "
                            "assemble, as the reference's does")
            say(f"fused_paged_attn (K11) hd 64 [{k11['shape']}]: "
                f"{k11['ms']:.4f} ms by events, device {k11['device_ms']} "
                f"ms, launches per call {k11['launches_per_call']}; bound "
                f"{k11['bound_ms']:.4f} ms ({k11['bound_by']}); plain "
                f"{k11['plain_ms']:.4f} ms; before (device waits + K3 + K2) "
                f"{k11['before_ms']:.4f} ms, device "
                f"{k11['before_device_ms']} ms; max|err| vs plain "
                f"{k11['max_abs_err']:.3e}")
        del sched
        gc.collect()
        torch.cuda.empty_cache()
    return mode_launches, k11


def _rel_l2(torch, got, want) -> float:
    den = float(torch.linalg.vector_norm(want.float()))
    num = float(torch.linalg.vector_norm(got.float() - want.float()))
    return num / den if den else num


def _phase_ms(torch, fn, names):
    """Device milliseconds of one call of ``fn`` from ``torch.profiler``:
    {name: (ms summed over the kernels whose name contains it, their
    count)} for each of ``names``, and ``"all"``, every device operation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {name: [0.0, 0] for name in (*names, "all")}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        out["all"][0] += evt.self_device_time_total / 1e3
        out["all"][1] += evt.count
        for name in names:
            if name in evt.key:
                out[name][0] += evt.self_device_time_total / 1e3
                out[name][1] += evt.count
    return {k: tuple(v) for k, v in out.items()}


def check_train_rows(torch, rc, dev, deferred, *, P, elems, suffix, leaf,
                     phase):
    """K6 then K5 at a training gradient leaf of ``elems`` bf16 elements
    over ``P`` PEs, as ``ShmemOps`` lays it out, rows (P, P, elems / P):
    bitwise against the plain versions, timed beside them, ``x.sum(0)`` and
    ``expand`` + ``contiguous`` (device times with the other rows',
    last).  Rows ``ring_reduce_scatter_<suffix>`` and
    ``ring_allgather_<suffix>``."""
    k = elems // P
    gen = torch.Generator(device=dev).manual_seed(21)
    rows = torch.randn((P, P, k), generator=gen, device=dev,
                       dtype=torch.bfloat16)
    mine = rc.ring_reduce_scatter(rows)
    if not torch.equal(mine, rc.ring_reduce_scatter_plain(rows)):
        fail(f"K6 differs from its plain version at {leaf}")
    full = rc.ring_allgather(mine)
    if not torch.equal(full, rc.ring_allgather_plain(mine)):
        fail(f"K5 differs from its plain version at {leaf}")
    del full
    torch.cuda.empty_cache()
    nbytes = (P * P + P) * k * 2             # read x once, write out once
    out = []
    for name, k_id, replaces, kernel, plain, library, match, shape in (
            (f"ring_reduce_scatter_{suffix}", "K6",
             "src/repro/kernels/ring_collectives.py:125",
             lambda: rc.ring_reduce_scatter(rows),
             lambda: rc.ring_reduce_scatter_plain(rows),
             lambda: rows.sum(0), "reduce_scatter_pull",
             f"x ({P}, {P}, {k}) bf16: {leaf} reduce-scatter in {phase}"),
            (f"ring_allgather_{suffix}", "K5",
             "src/repro/kernels/ring_collectives.py:67",
             lambda: rc.ring_allgather(mine),
             lambda: rc.ring_allgather_plain(mine),
             lambda: mine.unsqueeze(0).expand(P, *mine.shape).contiguous(),
             "allgather_pull",
             f"x ({P}, {k}) bf16: {leaf} all-gather in {phase}")):
        row = {"name": name, "route": "cuda",
               "source": "src/repro_torch/csrc/ring_collectives.cu",
               "replaces": replaces, "max_abs_err": 0.0,
               "ms": time_ms(torch, kernel, iters=10),
               "plain_ms": time_ms(torch, plain, iters=3),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes",
               "library_ms": time_ms(torch, library, iters=10),
               "shape": shape}
        deferred.append((row, "device_ms", kernel, match, {"iters": 5}))
        deferred.append((row, "library_device_ms", library, None,
                         {"iters": 5}))
        say(f"{name} ({k_id}) [{shape}]: {row['ms']:.4f} ms by events; "
            f"plain {row['plain_ms']:.4f} ms; library "
            f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms "
            f"(bytes); bitwise equal to the plain version")
        out.append(row)
    return out


def phase_train(torch, ops, dev):
    """Phase 21: training at qwen3-4b's published widths, depth cut to
    TRAIN_LAYERS, data-parallel over 4 simulated PEs whose gradients reduce
    through ``ShmemOps`` (K4 for small leaves, K6 then K5 for large ones).
    Returns the training run's launches."""
    import os
    import tempfile
    from repro_torch.comms import api
    from repro_torch.configs import base as cfgbase
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models import model
    from repro_torch.train import checkpoint as ckpt_mod, optimizer, \
        train_step as ts, trainer, tree as tree_mod
    full = cfgbase.get_config(TRAIN["arch"])
    cfg = dataclasses.replace(full, num_layers=TRAIN_LAYERS)
    P = TRAIN["npes"]
    say("phase 21, training: reduced " + json.dumps({
        "arch": TRAIN["arch"], "num_layers": f"{full.num_layers} -> "
        f"{TRAIN_LAYERS}", "why": "AdamW's f32 moments and 4 PEs' bf16 "
        "grads of the whole model do not fit one card beside each other",
        "widths": "published", "dtype": cfg.param_dtype,
        "optimizer": cfg.optimizer, "remat": cfg.remat}))
    shmem = api.get_ops("shmem", npes=P)
    stream = TokenStream(DataConfig(cfg.vocab_size, TRAIN["seq"],
                                    TRAIN["batch"], seed=0), device=dev)
    batch0 = stream.batch(0)

    # ---- 1. step 1's DP law, bf16 at 4 layers, then f32 at 1 -------------
    params = model.init_params(cfg, seed=0, device=dev)
    nparams = sum(p.numel() for p in tree_mod.leaves(params))
    ops.reset_launches()
    _, mean = ts.dp_grads(params, cfg, batch0, shmem)
    torch.cuda.synchronize()
    law_launches = dict(ops.LAUNCHES)
    _, _, single = ts.value_and_grad(params, cfg, batch0)
    names = [k for k, _ in tree_mod.flatten(params)]
    errs = {n: _rel_l2(torch, a, b) for n, a, b in zip(names, mean, single)}
    worst = max(errs.items(), key=lambda kv: kv[1])
    say(f"phase 21 DP law (bf16, {TRAIN_LAYERS} layers, {nparams:,} "
        f"params): {len(names)} leaves, relative L2 of the ring-reduced "
        f"mean against one backward on the whole batch at most "
        f"{worst[1]:.3e} ({worst[0]}; bound {TRAIN_BF16_TOL}); launches "
        f"{ {k: law_launches[k] for k in TRAIN_KERNELS} }")
    if worst[1] > TRAIN_BF16_TOL:
        fail(f"phase 21 DP law: {worst[0]} is {worst[1]:.3e} from the "
             f"single-device gradient (bound {TRAIN_BF16_TOL})")
    if {k: law_launches[k] for k in TRAIN_KERNELS} != TRAIN_PER_STEP:
        fail(f"phase 21 DP step launched {law_launches}, not "
             f"{TRAIN_PER_STEP}")
    del params, mean, single
    torch.cuda.empty_cache()
    cfg1 = dataclasses.replace(cfg, num_layers=1, dtype="float32",
                               param_dtype="float32")
    params = model.init_params(cfg1, seed=1, device=dev)
    _, mean = ts.dp_grads(params, cfg1, batch0, shmem)
    _, _, single = ts.value_and_grad(params, cfg1, batch0)
    excess, where = -1.0, ""
    for n, a, b in zip([k for k, _ in tree_mod.flatten(params)], mean,
                       single):
        e = float(((a - b).abs() - (TRAIN_F32_ATOL +
                                    TRAIN_F32_RTOL * b.abs())).max())
        if e > excess:
            excess, where = e, n
    say(f"phase 21 DP law (f32, 1 layer): largest excess over rtol "
        f"{TRAIN_F32_RTOL} / atol {TRAIN_F32_ATOL} is {excess:.3e} ({where})")
    if excess > 0:
        fail(f"phase 21 f32 DP law: {where} exceeds rtol {TRAIN_F32_RTOL} / "
             f"atol {TRAIN_F32_ATOL} by {excess:.3e}")
    del params, mean, single
    torch.cuda.empty_cache()

    # ---- 2-4. six steps, a checkpoint at 3, a resumed run to 6 -----------
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        kw = dict(seq_len=TRAIN["seq"], global_batch=TRAIN["batch"],
                  log_every=1, comms_backend="shmem", comms_npes=P,
                  device=str(dev))
        logs = []
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params_a, state_a, hist = trainer.train(
            cfg, trainer.TrainConfig(steps=TRAIN["steps"],
                                     ckpt_every=TRAIN["ckpt_every"],
                                     ckpt_dir=tmp, **kw),
            log_fn=logs.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        for line in logs:
            say(f"phase 21: {line}")
        steps = [h["wall_s"] for h in hist]
        per_step = [b - a for a, b in zip([0.0] + steps, steps)]
        later = sorted(per_step[1:])[len(per_step[1:]) // 2]
        tokens = TRAIN["batch"] * TRAIN["seq"]
        say(f"phase 21 training: {wall:.2f} s for {TRAIN['steps']} steps "
            f"(checkpoints after steps {TRAIN['ckpt_every']} and "
            f"{TRAIN['steps']} included); "
            f"per step {[round(x, 3) for x in per_step]} s (median after "
            f"the first {later:.3f} s, {tokens / later:,.0f} tokens/s); peak "
            f"{peak:.1f} GiB; losses {[round(h['loss'], 4) for h in hist]}; "
            f"grad norms {[round(h['grad_norm'], 3) for h in hist]}; "
            f"launches {launches}")
        want = {k: n * TRAIN["steps"] for k, n in TRAIN_PER_STEP.items()}
        if {k: launches[k] for k in TRAIN_KERNELS} != want:
            fail(f"phase 21 launched {launches}, not {want}")
        stray = [k for k in TRAIN_NOT_LAUNCHED if launches[k]]
        if stray:
            fail(f"phase 21 launched {stray}, which training never calls")
        if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                   for h in hist) or not hist[-1]["loss"] < hist[0]["loss"]:
            fail(f"phase 21 losses {[h['loss'] for h in hist]} are not "
                 f"finite or do not fall")
        # resume from the step-3 checkpoint: drop the one the run wrote at
        # its end (the schedule spans the run's steps, so a 3-step run would
        # decay the lr differently)
        shutil.rmtree(os.path.join(tmp, f"step_{TRAIN['steps']:08d}"))
        t0 = time.perf_counter()
        params_c, state_c, hist_c = trainer.train(
            cfg, trainer.TrainConfig(steps=TRAIN["steps"], ckpt_dir=tmp,
                                     **kw), resume=True,
            log_fn=lambda *_: None)
        torch.cuda.synchronize()
        say(f"phase 21 resumed from step {ckpt_mod.latest_step(tmp)} to "
            f"{TRAIN['steps']} ({time.perf_counter() - t0:.2f} s with the "
            f"restore); losses {[round(h['loss'], 4) for h in hist_c]}")
        diff = [k for (k, a), b in zip(tree_mod.flatten((params_a, state_a)),
                                       tree_mod.leaves((params_c, state_c)))
                if not torch.equal(a, b)]
        if diff or hist_c[0]["step"] != TRAIN["ckpt_every"]:
            fail(f"phase 21: the resumed run differs from the uninterrupted "
                 f"one at {diff[:5]} ({len(diff)} leaves)")
        say("phase 21: the resumed run's params and optimizer state at step "
            f"{TRAIN['steps']} are bitwise the uninterrupted run's "
            "(deterministic algorithms on)")
        del params_c, state_c
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 5. the modeled schedule beside the measured reduce --------------
    t_block, t_nbi, nleaves = ts.grad_reduce_schedule(params_a, shmem)
    opt_cfg = optimizer.OptConfig(name=cfg.optimizer, lr=3e-4,
                                  warmup_steps=1, total_steps=TRAIN["steps"])
    step_fn = ts.make_dp_step(cfg, opt_cfg, shmem)
    prof = _phase_ms(torch, lambda: step_fn(params_a, state_a,
                                            stream.batch(TRAIN["steps"])),
                     ("remote_put_kernel", "reduce_scatter_pull",
                      "allgather_pull"))
    reduce_ms = sum(prof[k][0] for k in ("remote_put_kernel",
                                         "reduce_scatter_pull",
                                         "allgather_pull"))
    say(f"phase 21 one more step under torch.profiler: K4 "
        f"{prof['remote_put_kernel'][0]:.3f} ms ({prof['remote_put_kernel'][1]}"
        f" launches), K6 {prof['reduce_scatter_pull'][0]:.3f} ms "
        f"({prof['reduce_scatter_pull'][1]}), K5 "
        f"{prof['allgather_pull'][0]:.3f} ms ({prof['allgather_pull'][1]}); "
        f"the reduce {reduce_ms:.3f} ms device; every device operation of "
        f"the step {prof['all'][0]:.1f} ms; modeled reduce schedule "
        f"({nleaves} leaves, the reference's cost model at {P} PEs, ZeRO "
        f"shards): {t_block * 1e3:.3f} ms blocking, {t_nbi * 1e3:.3f} ms "
        f"pipelined (x{t_block / t_nbi:.2f})")
    del params_a, state_a, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _counts_equal(card, rec, label):
    """Fail unless the card run's counts are the meta record's, naming the
    aten ops whose counts differ."""
    want = rec["counted"]
    got = {k: card.summary()[k] for k in COUNT_KEYS}
    if got == want:
        return
    diff = [k for k in COUNT_KEYS if got[k] != want[k]]
    say(f"{label}: card {[(k, got[k]) for k in diff]} against the dry-run's "
        f"{[(k, want[k]) for k in diff]}")
    fail(f"{label}: the card's counts differ from the dry-run's in {diff}")


def _timed(torch, fn, runs=DRY_RUNS):
    """Median wall s of ``runs`` calls after a warm-up; no output is kept."""
    fn()
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return sorted(walls)[len(walls) // 2]


def _report(torch, analysis, label, rec, wall, peak, smi):
    mem = rec["memory"]
    pred = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    m = analysis.measured(rec, wall)
    t = analysis.terms(rec)
    say(f"phase 28 {label} ({smi}): median wall {wall * 1e3:.3f} ms of "
        f"{DRY_RUNS} after a warm-up; peak max_memory_allocated "
        f"{peak / 2**30:.3f} GiB beside the predicted argument + temp "
        f"{pred / 2**30:.3f} GiB; roofline bound {t['step_s'] * 1e3:.3f} ms "
        f"({t['dominant']}: compute {t['compute_s'] * 1e3:.3f}, memory "
        f"{t['memory_s'] * 1e3:.3f} (arguments read and outputs written "
        f"once), collective {t['collective_s'] * 1e3:.3f} ms), bound share "
        f"{m['bound_share']:.4f}, MFU {m['mfu']:.4f} (MODEL_FLOPS "
        f"{rec['model_flops']:.4e}; counted {rec['counted']['flops']:.4e} "
        f"FLOPs); the eager implementation's traffic "
        f"{rec['counted']['bytes']:.4e} bytes, "
        f"{t['eager_memory_s'] * 1e3:.3f} ms at HBM rate")
    return {"wall_ms": wall * 1e3, "peak_bytes": peak,
            "predicted_bytes": pred, "bound_ms": t["step_s"] * 1e3,
            "bound_by": t["dominant"], "bound_share": m["bound_share"],
            "mfu": m["mfu"], "eager_traffic_ms": t["eager_memory_s"] * 1e3}


def phase_dryrun(torch, ops, dev, smi):
    """Phase 28: the dry-run held by the card (module docstring).  Returns
    the launches of the prefill ("28") and of the train step ("28-train"),
    and the measurements."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.kernels import flash_attn, ring_collectives, rma_copy
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis, counter
    cfg = cfgbase.get_config(DRY_ARCH)
    prefill = cfgbase.ShapeSpec(**DRY_PREFILL)
    decode = cfgbase.ShapeSpec(**DRY_DECODE)
    say("phase 28, the dry-run on the card: reduced " + json.dumps({
        "arch": DRY_ARCH, "shape": "prefill_32k's kind: global batch 32 -> "
        "1, sequence 32768 -> 4096", "why": "one card's phase (prefill_32k "
        "needs 152 GiB of arguments)", "widths": "published",
        "num_layers": cfg.num_layers, "train": "phase 21's DP step, 4 of "
        "36 layers, 4 PEs, seq 512, batch 8"}))
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (a) prefill ------------------------------------------------------
    t0 = time.perf_counter()
    rec = dryrun.run_one(DRY_ARCH, prefill, "card", cfg=cfg)
    if rec["status"] != "ok":
        fail(f"phase 28 dry-run of the prefill: {rec['status']}")
    say(f"phase 28 prefill dry-run on meta in {time.perf_counter() - t0:.2f}"
        f" s: {rec['counted']['flops']:.6e} FLOPs, "
        f"{rec['counted']['bytes']:.6e} bytes, "
        f"{rec['counted']['transcendental']:.6e} transcendentals; "
        f"arguments {rec['memory']['argument_size_in_bytes']:,} B, temp "
        f"{rec['memory']['temp_size_in_bytes']:,} B, fits {rec['fits']}")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    fn, args = dryrun.build_step(cfg, prefill, device=dev, seed=0)
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - before
    want = rec["memory"]["argument_size_in_bytes"]
    say(f"phase 28 prefill arguments: memory_allocated rose {rise:,} B "
        f"while they were built; predicted {want:,} B "
        f"({rise / want - 1:+.5f})")
    if abs(rise - want) > ALLOC_TOL * want:
        fail(f"phase 28: the arguments took {rise} B, not the predicted "
             f"{want} B within {ALLOC_TOL}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with torch.no_grad(), counter.count() as card:
        logits, cache = fn(*args)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - before
    say(f"phase 28 prefill on the card under the counter: launches "
        f"{launches}; {card.n_ops} aten ops counted")
    _counts_equal(card, rec, "phase 28 prefill")
    if launches["flash_attention"] != DRY_K2 or \
            sum(launches.values()) != DRY_K2:
        fail(f"phase 28 prefill launched {launches}, not K2 {DRY_K2} times")
    # the same prefill with K2's plain version in its place
    kernel = flash_attn.flash_attention
    F = torch.nn.functional
    per_call = []

    def both(q, k, v):
        got, want = kernel(q, k, v), flash_attn.flash_attention_plain(q, k, v)
        tol = TOL["bfloat16"]
        per_call.append((float((got.float() - want.float()).abs().max()),
                         int((~torch.isclose(got.float(), want.float(),
                                             rtol=tol, atol=tol)).sum())))
        return got

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2).contiguous()
    outs = {}
    for name, impl in (("plain", flash_attn.flash_attention_plain),
                       ("sdpa", sdpa), ("both", both)):
        flash_attn.flash_attention = impl
        try:
            with torch.no_grad():
                outs[name] = fn(*args)[0]
        finally:
            flash_attn.flash_attention = kernel
    torch.cuda.synchronize()
    plain = outs["plain"]
    tol = TOL["bfloat16"]
    for name, other in (("K2", logits), ("SDPA", outs["sdpa"]),
                        ("K2 checked per call", outs["both"])):
        far = ~torch.isclose(other, plain, rtol=tol, atol=tol)
        say(f"phase 28 prefill logits {tuple(logits.shape)}, {name} route "
            f"against K2's plain version: relative L2 "
            f"{_rel_l2(torch, other, plain):.4e}, max|err| "
            f"{float((other - plain).abs().max()):.4e}, outside rtol=atol="
            f"{tol}: {int(far.sum())} of {plain.numel()}; |logit| max "
            f"{float(plain.abs().max()):.3f}, rms "
            f"{float(plain.pow(2).mean().sqrt()):.3f}")
    outside = sum(n for _, n in per_call)
    say(f"phase 28 prefill, K2 against its plain version at each of its "
        f"{len(per_call)} calls on the path's own q, k, v: max|err| "
        f"{max(e for e, _ in per_call):.4e}, elements outside {tol}: "
        f"{outside}")
    if len(per_call) != DRY_K2 or outside:
        fail(f"phase 28 prefill: K2 left {outside} elements outside {tol} "
             f"of its plain version over {len(per_call)} calls")
    # at 36 bf16 layers the logits of any two attention roundings part by
    # about 2e-2 (SDPA's route as much as K2's): K2's route may be no
    # farther from the plain route than DRY_LIB_RATIO x SDPA's
    rel, lib = (_rel_l2(torch, x, plain) for x in (logits, outs["sdpa"]))
    if logits.shape != (1, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()) or rel > DRY_LIB_RATIO * lib:
        fail(f"phase 28 prefill logits {tuple(logits.shape)} are {rel:.4e} "
             f"from the plain route's, more than {DRY_LIB_RATIO} x SDPA's "
             f"{lib:.4e}, or not finite")
    del plain, outs
    with torch.no_grad():
        wall = _timed(torch, lambda: fn(*args))
    out = {"prefill": _report(torch, analysis, "prefill", rec, wall, peak,
                              smi)}
    out["prefill"]["launches"] = launches
    out["prefill"]["k2_rel_l2"], out["prefill"]["sdpa_rel_l2"] = rel, lib

    # ---- (b) one dense decode step against that cache ---------------------
    rec_d = dryrun.run_one(DRY_ARCH, decode, "card", cfg=cfg)
    if rec_d["status"] != "ok":
        fail(f"phase 28 dry-run of the decode: {rec_d['status']}")
    params = args[0]
    token = logits.argmax(-1, keepdim=True).to(torch.int32)
    pos = torch.full((1,), prefill.seq_len - 1, dtype=torch.int32,
                     device=dev)
    del logits, args, fn
    from repro_torch.models import model

    def step():
        return model.decode_step(params, cfg, token, pos, cache)
    # measured against the baseline the prefill's arguments were built on:
    # what is resident now is the decode's arguments (the prefill's
    # weights and cache, the token and its position)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() - before
    want = rec_d["memory"]["argument_size_in_bytes"]
    say(f"phase 28 decode arguments: {resident:,} B resident above the "
        f"prefill's baseline; predicted {want:,} B "
        f"({resident / want - 1:+.5f})")
    if abs(resident - want) > ALLOC_TOL * want:
        fail(f"phase 28: the decode's arguments take {resident} B, not the "
             f"predicted {want} B within {ALLOC_TOL}")
    ops.reset_launches()
    with torch.no_grad(), counter.count() as card:
        dlogits, _ = step()
    torch.cuda.synchronize()
    dpeak = torch.cuda.max_memory_allocated() - before
    _counts_equal(card, rec_d, "phase 28 decode")
    if any(ops.LAUNCHES.values()) or not bool(torch.isfinite(dlogits).all()):
        fail(f"phase 28 decode launched {ops.LAUNCHES} or gave non-finite "
             f"logits")
    with torch.no_grad():
        wall = _timed(torch, step)
    out["decode"] = _report(torch, analysis, "decode", rec_d, wall, dpeak,
                            smi)
    del params, token, pos, cache, dlogits, _, step
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) phase 21's data-parallel train step ---------------------------
    cut = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS)
    train = cfgbase.ShapeSpec(**DRY_TRAIN)
    rec_t = dryrun.run_one(DRY_ARCH, train, "card", cfg=cut,
                           comms_npes=TRAIN["npes"])
    if rec_t["status"] != "ok":
        fail(f"phase 28 dry-run of the train step: {rec_t['status']}")
    before = torch.cuda.memory_allocated()
    fn, args = dryrun.build_step(cut, train, device=dev, seed=0,
                                 comms_npes=TRAIN["npes"])
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - before
    want = rec_t["memory"]["argument_size_in_bytes"]
    say(f"phase 28 train arguments: memory_allocated rose {rise:,} B; "
        f"predicted {want:,} B ({rise / want - 1:+.5f})")
    if abs(rise - want) > ALLOC_TOL * want:
        fail(f"phase 28: the train arguments took {rise} B, not {want} B")
    # every K4-K6 launch of the step, to sum the ring formulas over
    issued = []
    wrapped = {}
    for mod, name, kind in ((rma_copy, "remote_put", "collective-permute"),
                            (ring_collectives, "ring_allgather",
                             "all-gather"),
                            (ring_collectives, "ring_reduce_scatter",
                             "reduce-scatter")):
        real = getattr(mod, name)
        wrapped[(mod, name)] = real

        def logged(x, *a, _real=real, _kind=kind, **kw):
            issued.append((_kind, tuple(x.shape), x.element_size()))
            return _real(x, *a, **kw)
        setattr(mod, name, logged)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    try:
        with torch.no_grad(), counter.count() as card:
            fn(*args)
        torch.cuda.synchronize()
    finally:
        for (mod, name), real in wrapped.items():
            setattr(mod, name, real)
    tpeak = torch.cuda.max_memory_allocated() - before
    launches_t = dict(ops.LAUNCHES)
    _counts_equal(card, rec_t, "phase 28 train")
    sums = {}
    for kind, shape, itemsize in issued:
        P, nbytes = shape[0], math.prod(shape) * itemsize
        size = nbytes if kind == "all-gather" else nbytes // P
        sums[kind] = sums.get(kind, 0.0) + \
            P * counter._wire_bytes(kind, size, P)
    got = card.summary()["collective_by_kind"]
    say(f"phase 28 train: launches {launches_t}; collective_by_kind {got}; "
        f"the ring formulas over the {len(issued)} K4-K6 launches issued "
        f"{sums}")
    if got != sums or {k: n for k, n in launches_t.items() if n} != \
            {k: n for k, n in TRAIN_PER_STEP.items()}:
        fail(f"phase 28 train: collective_by_kind {got} is not the launches' "
             f"{sums}, or launches {launches_t} are not {TRAIN_PER_STEP}")
    wall = _timed(torch, lambda: fn(*args))
    out["train"] = _report(torch, analysis, "train", rec_t, wall, tpeak, smi)
    del fn, args
    gc.collect()
    torch.cuda.empty_cache()
    return {"28": launches, "28-train": launches_t}, out


def _same(torch, a, b) -> bool:
    """Two trees of tensors (dicts, lists, tuples) bitwise equal."""
    from repro_torch.train import tree as tree_mod
    la, lb = tree_mod.leaves(a), tree_mod.leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def phase_policy(torch, ops, dev, smi, deferred, dry):
    """Phase 29: phase 28's prefill and decode step under each of the three
    policy fields (module docstring).  ``dry`` is phase 28's measurements.
    Returns (the launches of the ``attn_repeat_kv`` prefill, K2's MHA row)."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.kernels import flash_attn
    from repro_torch.launch import dryrun, policy as policy_mod
    from repro_torch.models import model
    from repro_torch.roofline import counter
    from repro_torch.train import train_step as ts
    cfg = cfgbase.get_config(DRY_ARCH)
    prefill = cfgbase.ShapeSpec(**DRY_PREFILL)
    decode = cfgbase.ShapeSpec(**DRY_DECODE)
    say("phase 29, the policy fields on phase 28's qwen3-4b prefill "
        "(1 x 4096, 36 layers) and its decode step: "
        + ", ".join(" ".join(f) for f in POLICY_FIELDS))
    gc.collect()
    torch.cuda.empty_cache()
    fn, args = dryrun.build_step(cfg, prefill, device=dev, seed=0)
    params = args[0]
    pos = torch.full((1,), prefill.seq_len - 1, dtype=torch.int32,
                     device=dev)

    def run(fields):
        """Prefill then one decode step under ``fields``: (logits, cache,
        decode logits, new cache, prefill counts, decode counts, prefill
        launches)."""
        with policy_mod.use(policy_mod.parse_overrides(fields)), \
                torch.no_grad():
            ops.reset_launches()
            with counter.count() as card:
                logits, cache = fn(*args)
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            token = logits.argmax(-1, keepdim=True).to(torch.int32)
            with counter.count() as card_d:
                dlogits, dcache = model.decode_step(params, cfg, token, pos,
                                                    cache)
            torch.cuda.synchronize()
        return logits, cache, dlogits, dcache, card, card_d, launches

    base = run([])
    # ---- attn_repeat_kv: the card's counts against the meta records -------
    pol = policy_mod.parse_overrides(POLICY_REPEAT)
    recs = {}
    for shape in (prefill, decode):
        rec = dryrun.run_one(DRY_ARCH, shape, "card", cfg=cfg, policy=pol)
        if rec["status"] != "ok" or rec["policy"] != dataclasses.asdict(pol):
            fail(f"phase 29 dry-run of the {shape.kind} under "
                 f"{POLICY_REPEAT}: {rec['status']}")
        recs[shape.kind] = rec
    logits, cache, dlogits, dcache, card, card_d, launches = run(
        POLICY_REPEAT)
    _counts_equal(card, recs["prefill"], "phase 29 prefill under "
                  "attn_repeat_kv")
    _counts_equal(card_d, recs["decode"], "phase 29 decode under "
                  "attn_repeat_kv")
    k2 = recs["prefill"]["counted"]["by_kernel"]["flash_attention"]
    want_k2 = counter.flash_work(1, prefill.seq_len, cfg.num_heads,
                                 cfg.num_heads, cfg.hd, 2)
    if launches["flash_attention"] != DRY_K2 or \
            sum(launches.values()) != DRY_K2 or \
            k2["bytes"] != DRY_K2 * want_k2["bytes"]:
        fail(f"phase 29 prefill under attn_repeat_kv launched {launches}, "
             f"or K2 was charged {k2}, not {DRY_K2} MHA calls")
    # each K2 call as MHA, within 2e-2 of its plain version
    kernel, per_call = flash_attn.flash_attention, []

    def both(q, k, v):
        got, want = kernel(q, k, v), flash_attn.flash_attention_plain(q, k, v)
        tol = TOL["bfloat16"]
        per_call.append((k.shape[2], float((got.float() - want.float())
                                           .abs().max()),
                         int((~torch.isclose(got.float(), want.float(),
                                             rtol=tol, atol=tol)).sum())))
        return got
    flash_attn.flash_attention = both
    try:
        run(POLICY_REPEAT)
    finally:
        flash_attn.flash_attention = kernel
    heads = {h for h, _, _ in per_call}
    outside = sum(n for _, _, n in per_call)
    say(f"phase 29 attn_repeat_kv prefill: launches {launches}; counts "
        f"equal the meta records (prefill {card.n_ops}, decode "
        f"{card_d.n_ops} aten ops); K2 charged {k2['calls']} calls, "
        f"{k2['bytes']:,} B (MHA at Hkv = {cfg.num_heads}); {len(per_call)} "
        f"calls with K/V heads {sorted(heads)}, max|err| against the plain "
        f"version {max(e for _, e, _ in per_call):.4e}, elements outside "
        f"{TOL['bfloat16']}: {outside}")
    if len(per_call) != DRY_K2 or heads != {cfg.num_heads} or outside:
        fail(f"phase 29: K2 under attn_repeat_kv ran {len(per_call)} calls "
             f"with K/V heads {heads}, {outside} elements outside "
             f"{TOL['bfloat16']}")
    sdpa = dry["prefill"]["sdpa_rel_l2"]
    rel = _rel_l2(torch, logits, base[0])
    drel = _rel_l2(torch, dlogits, base[2])
    say(f"phase 29 attn_repeat_kv logits against the default run: prefill "
        f"relative L2 {rel:.4e} (bitwise {torch.equal(logits, base[0])}), "
        f"decode {drel:.4e}; gate {DRY_LIB_RATIO} x SDPA's {sdpa:.4e} "
        f"(phase 28); the cache keeps {cache['blocks'][0]['k'].shape[-2]} "
        f"K/V heads")
    if not (bool(torch.isfinite(logits).all()) and
            bool(torch.isfinite(dlogits).all())) or \
            max(rel, drel) > DRY_LIB_RATIO * sdpa or \
            cache["blocks"][0]["k"].shape[-2] != cfg.num_kv_heads:
        fail(f"phase 29 attn_repeat_kv: logits {rel:.4e} / {drel:.4e} from "
             f"the default run, above {DRY_LIB_RATIO} x {sdpa:.4e}, not "
             f"finite, or the cache holds repeated heads")
    del logits, cache, dlogits, dcache
    # ---- decode_onehot_update and attn_impl=flash: the default's route ----
    for fields in POLICY_SAME:
        got = run(fields)
        same = _same(torch, got[:4], base[:4])
        say(f"phase 29 {' '.join(fields)}: logits, cache, decode logits "
            f"and new cache bitwise the default run's: {same}; launches "
            f"{ {k: n for k, n in got[6].items() if n} }")
        if not same or got[6] != base[6]:
            fail(f"phase 29 {fields}: not bitwise the default run, or "
                 f"launches {got[6]} differ from {base[6]}")
        del got
    del base, fn, args, params
    gc.collect()
    torch.cuda.empty_cache()
    # ---- attn_impl=flash cannot train --------------------------------------
    one = dataclasses.replace(cfg, num_layers=1)
    params = model.init_params(one, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(29)
    toks = torch.randint(0, cfg.vocab_size, (1, 513), generator=gen,
                         device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with policy_mod.use(policy_mod.parse_overrides(["attn_impl=flash"])):
        ops.reset_launches()
        with torch.no_grad():
            loss, _ = model.train_loss(params, one, batch)
        fwd = dict(ops.LAUNCHES)
        try:
            ts.value_and_grad(params, one, batch)
        except NotImplementedError as err:
            reason = str(err)
        else:
            reason = None
    say(f"phase 29 attn_impl=flash in training (qwen3-4b, 1 layer, 512 "
        f"tokens): the forward launched K2 {fwd['flash_attention']} time(s), "
        f"loss {float(loss):.4f}; the train step raised "
        f"NotImplementedError: {reason}")
    if reason is None or "forward-only" not in reason or \
            fwd["flash_attention"] != 1 or not math.isfinite(float(loss)):
        fail("phase 29: a train step under attn_impl=flash did not raise "
             "NotImplementedError naming K2's missing backward, or its "
             "forward did not go through K2")
    del params, toks, batch
    torch.cuda.empty_cache()
    # ---- K2 as MHA at (1, 4096, 32, 128) -----------------------------------
    F = torch.nn.functional
    B, S, H, hd = 1, prefill.seq_len, cfg.num_heads, cfg.hd
    q, k, v = _qkv(torch, gen, dev, torch.bfloat16, B, S, H, H, hd)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bound, by, flops = _flash_bound(B, S, H, H, hd)
    got = flash_attn.flash_attention(q, k, v)
    want = flash_attn.flash_attention_plain(q, k, v)
    tol = TOL["bfloat16"]
    if not bool(torch.isclose(got.float(), want.float(), rtol=tol,
                              atol=tol).all()):
        fail("phase 29: K2 at (1, 4096, 32, 128) MHA is outside 2e-2 of its "
             "plain version")
    row = {"name": "flash_attention_mha4k", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attn.cu",
           "replaces": "src/repro/kernels/flash_attn.py:62",
           "max_abs_err": float((got.float() - want.float()).abs().max()),
           "ms": time_ms(torch, lambda: flash_attn.flash_attention(q, k, v)),
           "plain_ms": time_ms(torch, lambda: flash_attn.flash_attention_plain(
               q, k, v), iters=5),
           "bound_ms": bound, "bound_by": by, "flops": flops,
           "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True)),
           "shape": f"q/k/v ({B},{S},{H},{hd}) bf16, MHA: qwen3-4b's prefill "
                    "under attn_repeat_kv (phase 29)"}
    del got, want
    deferred.append((row, "device_ms",
                     lambda: flash_attn.flash_attention(q, k, v),
                     "flash_fwd_wgmma"))
    deferred.append((row, "library_device_ms",
                     lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=True), None))
    say(f"flash_attention_mha4k (K2) [{row['shape']}]: {row['ms']:.4f} ms by "
        f"events; plain {row['plain_ms']:.4f} ms; SDPA "
        f"{row['library_ms']:.4f} ms; bound {bound:.4f} ms ({by}); max|err| "
        f"{row['max_abs_err']:.3e} ({smi})")
    return launches, row


def _load_example(name):
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    if not path.is_file():
        fail(f"{path} not found: run from a checkout")
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *a, **kw):
    """``fn``'s result and the lines it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue().splitlines()


def _equal_values(a, b) -> bool:
    """Two example reports (dicts of numbers, strings, lists, numpy arrays)
    equal, value for value."""
    import numpy as np
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _equal_values(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal_values, a, b))
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and bool((a == b).all())
    return a == b


def phase_examples(torch, ops):
    """Phase 30: the four ``examples/torch_*.py`` on the card, each through
    ``main(["--device", "cuda"])`` (module docstring).  Returns {example:
    launches}."""
    launches = {}

    def on_card(name, mod, argv, **kw):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, lines = _quiet(mod.main, ["--device", "cuda"] + argv, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = dict(ops.LAUNCHES)
        return out, lines, wall

    def report(name, lines, wall):
        for line in lines:
            say(f"phase 30 {name}: {line}")
        got = {EXAMPLE_K[k]: n for k, n in launches[name].items()
               if k in EXAMPLE_K}
        say(f"phase 30 {name}: {wall:.2f} s wall on the card; launches "
            f"{got}")
        missing = [EXAMPLE_K[k] for k in EXAMPLE_NEEDS[name]
                   if not launches[name][k]]
        if missing:
            fail(f"phase 30 {name} never launched {missing}")

    # quickstart: every printed value equals the CPU run's
    mod = _load_example("torch_quickstart")
    card, lines, wall = on_card("quickstart", mod, [])
    report("quickstart", lines, wall)
    cpu, _ = _quiet(mod.main, ["--device", "cpu"])
    if not _equal_values(card, cpu):
        fail(f"phase 30 quickstart on the card printed {card}, the CPU run "
             f"{cpu}")
    say("phase 30 quickstart: every printed value equals the CPU run's")

    # serve_batch: counts that do not depend on the sampled tokens equal
    # the CPU run's; greedy, so do the tokens
    mod = _load_example("torch_serve_batch")
    for argv in ([], ["--temperature", "0"]):
        name = "serve_batch" + (" --temperature 0" if argv else "")
        card, lines, wall = on_card(name, mod, argv)
        report(name, lines, wall)
        cpu, _ = _quiet(mod.main, ["--device", "cpu"] + argv)
        counts = {act: {k: (card[act]["stats"][k], cpu[act]["stats"][k])
                        for k in SERVE_EXAMPLE_COUNTS}
                  for act in ("act2", "act3")}
        say(f"phase 30 {name}: (card, CPU) counts {counts}")
        if any(a != b for act in counts.values() for a, b in act.values()):
            fail(f"phase 30 {name}: the card's counts differ from the CPU "
                 f"run's: {counts}")
        if argv:
            toks = {arch: (card["act1"][arch]["generated"],
                           cpu["act1"][arch]["generated"])
                    for arch in mod.ACT1_ARCHS}
            toks.update({f"{act} {rid}": (card[act]["outs"][rid],
                                          cpu[act]["outs"].get(rid))
                         for act in ("act2", "act3")
                         for rid in card[act]["outs"]})
            diff = [k for k, (a, b) in toks.items()
                    if not _equal_values(a, b)]
            say(f"phase 30 {name}: tokens of {len(toks) - len(diff)} of "
                f"{len(toks)} generations equal the CPU run's")
            if diff:
                fail(f"phase 30 {name}: tokens differ from the CPU run's "
                     f"at {diff}")

    # shmem_collectives: its checks hold on the card
    mod = _load_example("torch_shmem_collectives")
    card, lines, wall = on_card("shmem_collectives", mod, [])
    report("shmem_collectives", lines, wall)
    if not (card["fcollect_ok"] and card["broadcast_ok"] and
            card["barrier_ok"] and card["barrier"] == [1] * 8 and
            card["psum_err"] <= COLL_TOL):
        fail(f"phase 30 shmem_collectives: fcollect {card['fcollect_ok']}, "
             f"broadcast {card['broadcast_ok']}, barrier {card['barrier']}, "
             f"psum |diff| {card['psum_err']:.3e} (limit {COLL_TOL})")

    # train_lm: its default run, a finite loss that falls
    mod = _load_example("torch_train_lm")
    card, lines, wall = on_card("train_lm", mod, [], log_fn=lambda *_: None)
    report("train_lm", lines, wall)
    losses = [h["loss"] for h in card["history"]]
    if not all(math.isfinite(x) for x in losses) or not card["decreased"]:
        fail(f"phase 30 train_lm: losses {losses} not finite or not falling")
    return launches


def _predicted_reduce(leaves, P):
    """K4/K5/K6 launches of one data-parallel step, from the leaf list:
    ``ShmemOps.psum_overlap`` passes a leaf of at most 2 MiB over all PEs
    around the ring (P - 1 K4 puts) and reduces a larger one by K6 then
    K5."""
    per = {"remote_put": 0, "ring_reduce_scatter": 0, "ring_allgather": 0}
    for leaf in leaves:
        if leaf.numel() * leaf.element_size() * P <= 2 * (1 << 20):
            per["remote_put"] += P - 1
        else:
            per["ring_reduce_scatter"] += 1
            per["ring_allgather"] += 1
    return per


def phase_full_train(torch, ops, dev, smi, spec):
    """One configuration of phase 31 (module docstring): sized on meta,
    the DP law of step 1, then ``spec["steps"]`` steps through
    ``trainer.train``.  Returns (launches of the run, its report)."""
    from repro_torch.comms import api
    from repro_torch.configs import base as cfgbase
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.launch import dryrun
    from repro_torch.models import model
    from repro_torch.train import optimizer, train_step as ts, trainer, \
        tree as tree_mod
    full = cfgbase.get_config(spec["arch"])
    cfg = full if spec["layers"] is None else dataclasses.replace(
        full, num_layers=spec["layers"])
    P, label = spec["npes"], spec["label"]
    shape = cfgbase.ShapeSpec(f"train_{spec['seq']}_b{spec['batch']}",
                              "train", spec["seq"], spec["batch"])
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = dryrun.run_one(spec["arch"], shape, "card", cfg=cfg, comms_npes=P)
    if rec["status"] != "ok":
        fail(f"phase 31 {label}: the meta record failed: {rec['status']}")
    mem = rec["memory"]
    pred = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    backend = "shmem" if pred <= FULL_TRAIN_FIT else "none"
    charged = {k: rec["counted"]["by_kernel"].get(k, {"calls": 0})["calls"]
               for k in TRAIN_KERNELS}
    say(f"phase 31 {label}: " + json.dumps({
        "arch": spec["arch"], "num_layers": f"{full.num_layers} -> "
        f"{cfg.num_layers}", "why": spec["why"], "widths": "published",
        "dtype": cfg.param_dtype, "optimizer": cfg.optimizer,
        "remat": cfg.remat, "params": cfg.param_count(), "npes": P,
        "seq": spec["seq"], "global_batch": spec["batch"]})
        + f"; sized on meta in {time.perf_counter() - t0:.1f} s: arguments "
        f"{mem['argument_size_in_bytes'] / 2**30:.2f} GiB + temp "
        f"{mem['temp_size_in_bytes'] / 2**30:.2f} GiB = {pred / 2**30:.2f} "
        f"GiB (limit {FULL_TRAIN_FIT / 2**30:.0f} GiB) -> comms backend "
        f"{backend}; K4-K6 charged a step {charged}")
    if backend == "none":
        say(f"phase 31 {label}: the DP step does not fit beside its "
            f"gradients' stacked copies, so it trains with --comms-backend "
            f"none; phase 21 keeps holding the DP law at {TRAIN_LAYERS} "
            f"layers; the DP law is skipped here")
    before = torch.cuda.memory_allocated()
    params = model.init_params(cfg, seed=0, device=dev)
    leaves = tree_mod.leaves(params)
    want = _predicted_reduce(leaves, P) if backend == "shmem" else {
        k: 0 for k in TRAIN_KERNELS}
    if backend == "shmem" and charged != want:
        fail(f"phase 31 {label}: the meta record charges {charged} a step, "
             f"the leaf list predicts {want}")
    shmem = api.get_ops("shmem", npes=P)
    stream = TokenStream(DataConfig(cfg.vocab_size, spec["seq"],
                                    spec["batch"], seed=0), device=dev)
    batch0 = stream.batch(0)
    t0 = time.perf_counter()
    batch0.update(stream.frontend(0, cfg, spec["batch"]))
    frontend_s = time.perf_counter() - t0
    law = None
    if backend == "shmem":
        ops.reset_launches()
        _, mean = ts.dp_grads(params, cfg, batch0, shmem)
        torch.cuda.synchronize()
        law_launches = {k: ops.LAUNCHES[k] for k in TRAIN_KERNELS}
        _, _, single = ts.value_and_grad(params, cfg, batch0)
        names = [k for k, _ in tree_mod.flatten(params)]
        errs = {n: _rel_l2(torch, a, b) for n, a, b in
                zip(names, mean, single)}
        law = max(errs.items(), key=lambda kv: kv[1])
        say(f"phase 31 {label} DP law ({cfg.param_dtype}, {len(names)} "
            f"leaves): relative "
            f"L2 of the ring-reduced mean against one backward on the whole "
            f"batch at most {law[1]:.3e} ({law[0]}; bound {TRAIN_BF16_TOL}); "
            f"launches {law_launches} (predicted {want})")
        if law[1] > TRAIN_BF16_TOL or law_launches != want:
            fail(f"phase 31 {label} DP law: {law[0]} is {law[1]:.3e} from "
                 f"the single-device gradient (bound {TRAIN_BF16_TOL}), or "
                 f"launches {law_launches} are not {want}")
        del mean, single
        torch.cuda.empty_cache()
    state = (params, optimizer.init(cfg.optimizer, params))
    del leaves
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    logs = []
    t0 = time.perf_counter()
    _, _, hist = trainer.train(cfg, trainer.TrainConfig(
        steps=spec["steps"], seq_len=spec["seq"], global_batch=spec["batch"],
        log_every=1, comms_backend=backend, comms_npes=P, device=str(dev)),
        log_fn=logs.append, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - before
    for line in logs:
        say(f"phase 31 {label}: {line}")
    steps = [h["wall_s"] for h in hist]
    per_step = [b - a for a, b in zip([0.0] + steps, steps)]
    later = sorted(per_step[1:])[len(per_step[1:]) // 2]
    tokens = spec["batch"] * spec["seq"]
    out = {"backend": backend, "wall_s": wall, "per_step_s": per_step,
           "median_after_first_s": later, "tokens_per_s": tokens / later,
           "peak_bytes": peak, "predicted_bytes": pred,
           "frontend_s": frontend_s, "losses": [h["loss"] for h in hist],
           "dp_law_rel_l2": None if law is None else law[1],
           "launches": {k: launches[k] for k in TRAIN_KERNELS},
           "card": smi}
    say(f"phase 31 {label} ({smi}): {wall:.2f} s for {spec['steps']} steps; "
        f"per step {[round(x, 3) for x in per_step]} s (median after the "
        f"first {later:.3f} s, {tokens / later:,.1f} tokens/s; the host's "
        f"frontend draw {frontend_s:.3f} s of each step); peak "
        f"max_memory_allocated {peak / 2**30:.2f} GiB above the phase's "
        f"baseline beside the predicted argument + temp {pred / 2**30:.2f} "
        f"GiB ({peak / pred - 1:+.4f}); losses "
        f"{[round(h['loss'], 4) for h in hist]}; launches {out['launches']}")
    steps_want = {k: n * spec["steps"] for k, n in want.items()}
    if out["launches"] != steps_want:
        fail(f"phase 31 {label} launched {out['launches']}, not {steps_want}")
    if not all(math.isfinite(h["loss"]) for h in hist) or \
            len(hist) != spec["steps"]:
        fail(f"phase 31 {label}: losses {out['losses']} not finite")
    del state, params, hist
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def _k11_on_pool(torch, dev_kern, flash_attn, ops, sched, label):
    """K11 once on the decode pool a fused run leaves (every slot of its
    first decode PE mapped to a full table), at layer 0: one launch, no K3
    or K2, bitwise ``assemble`` + K2.  Returns its launches."""
    from repro_torch.core import device as device_mod
    from repro_torch.core.heap import TORCH_DTYPES
    from repro_torch.serve.paged_attn import PagedDecodeView
    pe = sched.decode_pes[0]
    pool, heap = sched.pool, sched.heap
    lay = pool.layout
    view = PagedDecodeView(pool, pe, len(sched.banks[pe].active))
    for s in range(view.num_slots):
        if pool.alloc(1_000_000 + s, lay.blocks_per_request) is None:
            fail("K11 check: the pool has no free table for a slot")
        heap = view.attach(heap, s, 1_000_000 + s, fresh_ids=[])
    leaf = next(x for x in lay.paged if x.key == "k")
    gen = torch.Generator(device=heap.device).manual_seed(7)
    q = torch.randn(view.num_slots, leaf.width, sched.engine.cfg.num_heads,
                    leaf.hd, generator=gen, device=heap.device).to(
                        TORCH_DTYPES[lay.kv_dtype])
    wg = device_mod.work_group(sched.ctx, pe=pe)
    ops.reset_launches()
    _, got = dev_kern.fused_paged_attn(
        wg, heap, view, q, waits=[(pool.sig_ptr(s), 0)
                                  for s in range(view.num_slots)])
    launches = {k: n for k, n in ops.LAUNCHES.items() if n}
    assembled = view.assemble(heap, sched.banks[pe].cache)
    blk = assembled["blocks"][leaf.unit_idx]
    want = flash_attn.flash_attention(q, blk["k"][0].contiguous(),
                                      blk["v"][0].contiguous())
    torch.cuda.synchronize()
    if launches != {"fused_paged_attn": 1} or not torch.equal(got, want):
        fail(f"K11 on {label}: launches {launches}, or not bitwise "
             f"assemble + K2")
    say(f"K11 on {label}: one launch, bitwise assemble + K2 at layer 0")
    for s in range(view.num_slots):
        pool.release(1_000_000 + s)
    return launches["fused_paged_attn"]


def phase_cross_pod(torch, ops, serve, dev_kern, flash_attn, barrier_out,
                    want_k1):
    """Phase 22: phases 3 and 5 with the decode PEs in a second pod, every
    migration through the host-proxy ring.  ``want_k1`` holds phases 3's
    and 5's K1 launches.  Returns ({"22": ..., "22-fused": ...} launch
    counts, K11's launches on the fused run's pool)."""
    out, k11 = {}, 0
    for mode, argv in (("barrier", CROSS_ARGV), ("fused", CROSS_FUSED_ARGV)):
        label = f"cross-pod {mode} serving path"
        sched, launches, wall, peak = _serve_phase(torch, ops, serve, argv,
                                                   label)
        st, px = sched.stats, sched.migrator.proxy
        msgs = len(px.ring.delivered)
        say(f"{label}: {wall:.2f} s wall, {st.decode_steps} decode steps, "
            f"peak {peak:.1f} GiB; launches {launches}; {msgs} proxy "
            f"messages, {px.backpressure} backpressure drains; "
            f"{st.bytes_cross_pod} of {st.bytes_migrated} B cross-pod; "
            f"decode graph {st.decode_graph.counter()}")
        missing = [k for k in SERVE_KERNELS if launches[k] == 0]
        if missing:
            fail(f"{label} never launched {missing}")
        _balanced(sched, label)
        if st.bytes_cross_pod != st.bytes_migrated or not msgs or \
                msgs != CROSS_MESSAGES[mode] or px.ring.overwrite_errors:
            fail(f"{label}: {st.bytes_cross_pod} B cross-pod of "
                 f"{st.bytes_migrated}, {msgs} ring messages (want "
                 f"{CROSS_MESSAGES[mode]}), {px.ring.overwrite_errors} "
                 f"overwrites")
        if launches["copy_into"] != want_k1[mode]:
            fail(f"{label}: K1 launched {launches['copy_into']} times, not "
                 f"{want_k1[mode]} as across one pod")
        _same_tokens(sched, barrier_out, f"{label} (vs phase 3)")
        say(f"8/8 {label} requests bitwise equal to phase 3; K1 "
            f"{launches['copy_into']} as in one pod")
        out["22" if mode == "barrier" else "22-fused"] = launches
        if mode == "fused":
            k11 = _k11_on_pool(torch, dev_kern, flash_attn, ops, sched,
                               "phase 22's cross-pod fused pool")
        del sched
        torch.cuda.empty_cache()
    return out, k11


# phases 24-27: the observability bundle and the tuning knobs.  Signals,
# quiets, fences and scalar puts are recorded on the direct path whatever
# the tuning (as the reference records them); every other op's path is
# the chooser's, so ISHMEM_FORCE_PATH=engine leaves none of them direct
FIXED_PATH_OPS = {"p", "signal", "signal(pending)", "signal_wait", "quiet",
                  "fence", "device_signal_wait"}
OBS_ARGV = ["--metrics", "{tmp}/metrics.json", "--audit", "1",
            "--recorder", "16", "--alerts", "--trace", "{tmp}/trace.json"]
CHAOS_OBS_ARGV = ["--audit", "1", "--recorder", "16"]
# phase 26 streams as phase 7 does: phase 3's decode-side stores are nbi,
# priced when a later phase flushes them, so only the stream flushes give a
# profiled scope the model's pricing to hold its wall time against
MEASURED_ARGV = STREAM_ARGV + ["--profile", "{tmp}/prof.json",
                             "--calibration", "{tmp}/calibration.json",
                             "--trace", "{tmp}/trace.json"]
REFIT_FLEET_ARGV = FLEET_ARGV + ["--fleet-steps", "6", "--refit", "4",
                                 "--refit-min-samples", "16", "--profile"]
PROF_SCOPES = ("serve_prefill", "serve_decode", "paged_attn")


def _fleet_counts(fleet, rep, launches):
    pods = fleet.pods + fleet.dead_pods
    got = {"offered": rep["offered"], "completed": rep["completed"],
           "shed": rep["shed"], "preempts": rep["preempts"],
           "elapsed_steps": fleet.elapsed_steps,
           "prefills": sum(p.sched.stats.prefills for p in pods),
           "delivered": rep["proxy"]["delivered"],
           **{k: launches[k] for k in SERVE_KERNELS}}
    if "fault" in rep:
        got.update({k: rep["recovered"][k] for k in (
            "recovered_requests", "remigrated", "replayed_tokens")},
                   cancelled_ops=rep["fault"]["cancelled_ops"])
    return got


def _run_fleet_phase(torch, ops, serve, engine_mod, argv, label,
                     on_build=None):
    """Build the fleet for ``argv`` (``on_build(fleet)`` may instrument
    it), zero the launch counts, run its schedule, and read the counts;
    every decode step's logits are checked for a NaN on the card (one flag
    a step, read at the end).  Returns (fleet, specs, report, launches,
    wall s, peak GiB, parsed args)."""
    say(f"{label}: serve " + " ".join(argv))
    fleet, specs, args = serve.build_fleet(argv)
    if on_build is not None:
        on_build(fleet)
    nan_flags = []
    decode = engine_mod.model.decode_step

    def watched(*a, **k):
        logits, cache = decode(*a, **k)
        nan_flags.append(torch.isnan(logits).any())
        return logits, cache

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    engine_mod.model.decode_step = watched
    t0 = time.perf_counter()
    try:
        rep = fleet.run(specs)
        torch.cuda.synchronize()
    finally:
        engine_mod.model.decode_step = decode
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if not nan_flags or bool(torch.stack(nan_flags).any()):
        fail(f"{label}: a decode step's logits hold a NaN "
             f"({len(nan_flags)} steps)")
    return (fleet, specs, rep, launches, wall,
            torch.cuda.max_memory_allocated() / 2**30, args)


def _poisoned(torch, heap, pes):
    """True when every row of every pool at ``pes`` holds the poison bits:
    NaN (0x7FC0 bf16, 0x7FC00000 f32) or ``iinfo.min + 1``."""
    for pool in heap.pools.values():
        rows = pool[list(pes)]
        if rows.dtype == torch.bfloat16:
            ok = bool((rows.view(torch.int16) == 0x7FC0).all())
        elif rows.dtype == torch.float32:
            ok = bool((rows.view(torch.int32) == 0x7FC00000).all())
        else:
            ok = bool((rows == torch.iinfo(rows.dtype).min + 1).all())
        if not ok:
            return False
    return True


def phase_fleet(torch, ops, serve, engine_mod):
    """Phase 23: the fleet (module docstring).  Returns (its outputs by
    spec index, its report, its launches)."""
    fleet, specs, rep, launches, wall, peak, _ = _run_fleet_phase(
        torch, ops, serve, engine_mod, FLEET_ARGV, "fleet path")
    got = _fleet_counts(fleet, rep, launches)
    say(f"fleet path: {wall:.2f} s wall, peak {peak:.1f} GiB; launches "
        f"{launches}; counts {got}; wire {rep['wire']}; router "
        f"{rep['router']}; ring {rep['proxy']}")
    if rep["completed"] + rep["shed"] != rep["offered"] or \
            rep["completed"] < 16 or not \
            rep["resumes"] == rep["preempts"] >= 1 or \
            not rep["wire"]["bytes_cross_pod"] > 0:
        fail(f"fleet path: {rep['completed']} completed + {rep['shed']} "
             f"shed of {rep['offered']}, {rep['preempts']} preempts / "
             f"{rep['resumes']} resumes, {rep['wire']['bytes_cross_pod']} "
             f"B cross-pod")
    if fleet.pool.stats()["blocks_in_use"]:
        fail("fleet path: the pool did not drain")
    if got != FLEET_PREDICTED["23"]:
        fail(f"fleet path counts {got} differ from the CPU run's "
             f"{FLEET_PREDICTED['23']}")
    n, secs = _fleet_baseline(torch, fleet, "fleet path")
    say(f"{n}/{rep['completed']} completed fleet requests bitwise equal to "
        f"the single-PE baseline ({secs:.2f} s for the baseline); counts as "
        f"the CPU run predicts")
    outs = fleet.outputs()
    del fleet
    torch.cuda.empty_cache()
    return outs, rep, launches


def _fleet_baseline(torch, fleet, label):
    """Hold every finished request's tokens to ``Engine.generate_in_slot``
    for its prompt and budget; returns (requests held, seconds)."""
    from repro_torch.serve.scheduler import FINISHED
    t0 = time.perf_counter()
    n = 0
    for pod in fleet.pods:
        sched = pod.sched
        slots = len(sched.banks[sched.decode_pes[0]].active)
        for rid, req in sorted(sched.requests.items()):
            if req.state != FINISHED:
                continue
            base = sched.engine.generate_in_slot(
                req.batch, dataclasses.replace(sched.scfg,
                                              max_new_tokens=req.max_new),
                num_slots=slots, slot=req.slot)
            if base != req.out:
                fail(f"{label}: {pod.name} request {rid} tokens "
                     f"{req.out} != single-PE baseline {base}")
            n += 1
    torch.cuda.synchronize()
    return n, time.perf_counter() - t0


def _checked_dumps(fleet, export, reasons):
    """Validate every postmortem dump of the fleet's recorder as it is
    written (each overwrites the last); ``reasons`` collects them."""
    rec = fleet.obs.recorder
    write = rec.dump

    def dump(*a, **k):
        path = write(*a, **k)
        with open(path) as f:
            doc = json.load(f)
        errors = export.validate(doc)
        pm = doc["otherData"]["postmortem"]
        say(f"postmortem dump at step {pm['step']}: {pm['reason']}, "
            f"{len(doc['traceEvents'])} events, validation errors {errors}")
        if errors:
            fail(f"postmortem dump {pm['reason']} does not validate: "
                 f"{errors[:5]}")
        reasons.append(pm["reason"])
        return path
    rec.dump = dump


def phase_chaos(torch, ops, serve, engine_mod, export, control, tmp):
    """Phase 24: phase 23's traffic under CHAOS_PLAN, phase 23's outputs
    the control, with the auditors every step and a 16-step flight
    recorder whose dumps go to ``tmp``.  Returns its launches."""
    reasons = []
    os.environ["ISHMEM_OBS_RECORDER_PATH"] = str(tmp / "postmortem.json")
    try:
        fleet, specs, rep, launches, wall, peak, _ = _run_fleet_phase(
            torch, ops, serve, engine_mod,
            FLEET_ARGV + ["--chaos", CHAOS_PLAN] + CHAOS_OBS_ARGV,
            "chaos path",
            on_build=lambda f: _checked_dumps(f, export, reasons))
    finally:
        del os.environ["ISHMEM_OBS_RECORDER_PATH"]
    audit = fleet.obs.auditor.summary()
    say(f"chaos path audits: {audit['checks']} passes, "
        f"{audit['violations']} violations, "
        f"{audit['audit_seconds'] / max(1, audit['checks']) * 1e3:.3f} ms "
        f"of wall a pass; postmortem dumps {reasons}")
    if audit["violations"] or audit["checks"] != fleet.elapsed_steps:
        fail(f"chaos path audits: {audit}")
    want = ["fault:kill_pe:2", "fault:partition", "fault:kill_pod:pod1"]
    if reasons != want:
        fail(f"chaos path postmortem dumps {reasons}, not one per fault "
             f"{want}")
    got = _fleet_counts(fleet, rep, launches)
    flt = rep["fault"]
    say(f"chaos path: {wall:.2f} s wall, peak {peak:.1f} GiB; launches "
        f"{launches}; counts {got}; events {flt['events']}; dead PEs "
        f"{flt['dead_pes']}, dead pods {flt['dead_pods']}")
    fired = [e["kind"] for e in flt["events"] if e["kind"] != "heal"]
    if fired != ["kill_pe", "partition", "kill_pod"]:
        fail(f"chaos path: events {flt['events']}")
    from repro_torch.serve.scheduler import TERMINAL
    open_ = [(p.name, r.rid, r.state) for p in fleet.pods + fleet.dead_pods
             for r in p.sched.requests.values() if r.state not in TERMINAL]
    if open_:
        fail(f"chaos path: requests not terminal: {open_}")
    outs = fleet.outputs()
    wrong = [i for i, out in outs.items() if out and out != control[i]]
    if wrong:
        fail(f"chaos path: wrong tokens on surviving requests {wrong}")
    if not rep["recovered"]["recovered_requests"] >= 1:
        fail("chaos path: no request recovered")
    if fleet.pool.stats()["blocks_in_use"]:
        fail("chaos path: the pool did not drain")
    if not _poisoned(torch, fleet.heap, flt["dead_pes"]):
        fail(f"chaos path: a dead PE's rows of {flt['dead_pes']} lost the "
             f"poison bits")
    if got != FLEET_PREDICTED["24"]:
        fail(f"chaos path counts {got} differ from the CPU run's "
             f"{FLEET_PREDICTED['24']}")
    say(f"chaos path: {sum(1 for o in outs.values() if o)} completed "
        f"requests' tokens equal the control's, 0 wrong; dead rows "
        f"poisoned bit for bit; no NaN logits; counts as the CPU run "
        f"predicts; audits clean, one valid dump per fault")
    del fleet
    torch.cuda.empty_cache()
    return launches


def _tracer_event_cost(SpanTracer, n=200_000):
    """Host microseconds a recorded event costs: ``n`` instants with two
    arguments into a span tracer, as the serving hot paths emit them."""
    tr = SpanTracer(max_events=n + 1)
    t0 = time.perf_counter()
    for i in range(n):
        tr.instant("xfer", "cq", "core", "cq", bytes=i, path="direct")
    return (time.perf_counter() - t0) / n * 1e6


def phase_obs(torch, ops, serve, engine_mod, export, control, tmp):
    """Phase 25: phase 23's fleet with the bundle's deterministic parts on
    (trace, metrics, auditors every step, a 16-step recorder, burn-rate
    alerts).  Tokens, ``report()`` and the step-level counts must be phase
    23's bit for bit (the off/on law on the card); 66 metrics rows, no
    violation, a trace that validates with one chain per request.  Returns
    its launches."""
    outs23, rep23 = control
    argv = FLEET_ARGV + [a.format(tmp=tmp) for a in OBS_ARGV]
    reasons = []
    os.environ["ISHMEM_OBS_RECORDER_PATH"] = str(tmp / "postmortem.json")
    try:
        fleet, specs, rep, launches, wall, peak, args = _run_fleet_phase(
            torch, ops, serve, engine_mod, argv, "observed fleet path",
            on_build=lambda f: _checked_dumps(f, export, reasons))
    finally:
        del os.environ["ISHMEM_OBS_RECORDER_PATH"]
    obs = fleet.obs
    summary = rep.pop("obs")
    got = _fleet_counts(fleet, rep, launches)
    say(f"observed fleet path: {wall:.2f} s wall, peak {peak:.1f} GiB; "
        f"launches {launches}; counts {got}")
    if rep != rep23:
        diff = sorted(k for k in set(rep) | set(rep23)
                      if rep.get(k) != rep23.get(k))
        fail(f"observed fleet path: report() differs from phase 23's in "
             f"{diff}")
    if fleet.outputs() != outs23:
        fail("observed fleet path: tokens differ from phase 23's")
    if got != FLEET_PREDICTED["23"]:
        fail(f"observed fleet path counts {got} differ from phase 23's "
             f"{FLEET_PREDICTED['23']}")
    audit = summary["audit"]
    rows = len(obs.metrics.series)
    if rows != fleet.elapsed_steps or rows != FLEET_PREDICTED["23"][
            "elapsed_steps"] or audit["violations"] or \
            audit["checks"] != rows:
        fail(f"observed fleet path: {rows} metrics rows, audits {audit}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        serve.emit_obs(*args.obs_run)      # writes; an invalid trace raises
    emit_s = time.perf_counter() - t0
    with open(args.obs_run[1]) as f:
        doc = json.load(f)
    chains = export.request_chains_doc(doc)
    rids = {rid for _, rid in fleet.placements.values()}
    if set(chains) != rids or export.validate(doc):
        fail(f"observed fleet path: {len(chains)} chains for {len(rids)} "
             f"requests, validation {export.validate(doc)[:3]}")
    per_event = _tracer_event_cost(type(obs.tracer))
    say(f"observed fleet path: bitwise phase 23 (tokens, report, counts); "
        f"{rows} metrics rows; audits {audit['checks']} passes, 0 "
        f"violations, {audit['audit_seconds'] * 1e3:.1f} ms in all, "
        f"{audit['audit_seconds'] / audit['checks'] * 1e3:.3f} ms a pass; "
        f"trace {len(doc['traceEvents'])} events ({len(obs.tracer.events)} "
        f"recorded, {obs.tracer.dropped} dropped), {len(chains)} chains, "
        f"valid; alerts {len(summary['alerts']['alerts'])}; dumps "
        f"{reasons}; writing the outputs {emit_s:.2f} s; the tracer costs "
        f"{per_event:.3f} us of host time an event "
        f"({per_event * len(obs.tracer.events) / 1e6:.4f} s for this "
        f"run's events)")
    del fleet
    torch.cuda.empty_cache()
    return launches


def phase_measured(torch, ops, serve, export, barrier_out, tmp):
    """Phase 26: phase 3's run with the profiler, the calibration report
    and the trace: tokens bitwise phase 3's; samples per scope; the worst
    measured/modeled buckets; the measured track valid.  Then fits a
    wall-clock tuning table from the samples and writes it to ``tmp``.
    Returns (its launches, the table's path)."""
    argv = [a.format(tmp=tmp) for a in MEASURED_ARGV]
    say("measured serving path: serve " + " ".join(argv))
    sched, args = serve.build_disagg(argv)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        serve.report_disagg(sched, args)   # an invalid trace raises
    obs = args.obs_run[0]
    samples = obs.prof.samples
    say(f"measured serving path: {wall:.2f} s wall, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches "
        f"{launches}")
    _balanced(sched, "measured serving path")
    _same_tokens(sched, barrier_out, "measured serving path (vs phase 3)")
    for op in PROF_SCOPES:
        mine = [s for s in samples if s.op == op]
        if not mine:
            fail(f"measured serving path: no {op} sample")
        walls = sorted(s.wall_s for s in mine)
        say(f"  scope {op}: {len(mine)} samples, wall {sum(walls) * 1e3:.2f}"
            f" ms in all, median {walls[len(walls) // 2] * 1e3:.3f} ms, "
            f"modeled {sum(s.model_s for s in mine) * 1e3:.4f} ms in all")
    report = obs.calibration_report()
    for w in report["worst"][:4]:
        say(f"  calibration {w['op']} tier={w['tier']} "
            f"2^{w['size_bucket']}B wi={w['work_items']}: measured/modeled p50 "
            f"{w['ratio_p50']:.1f} (n={w['n']})")
    cov = report["coverage"]
    say(f"  calibration coverage: {cov}")
    with open(args.obs_run[1]) as f:
        doc = json.load(f)
    track = [e for e in doc["traceEvents"] if e.get("pid") == "measured"
             and e.get("ph") == "i"]
    if len(track) != len(samples) or export.validate(doc):
        fail(f"measured serving path: {len(track)} measured events for "
             f"{len(samples)} samples, validation {export.validate(doc)[:3]}")
    table = sched.ctx.fit_tuning_table(sample_source="wallclock")
    path = tmp / "tuning_wallclock.json"
    table.save(str(path))
    say(f"measured serving path: tokens bitwise phase 3's; {len(track)} "
        f"measured events valid; wall-clock table (source {table.source}): "
        f"{len(table.profiles)} profiles "
        f"{sorted('/'.join(map(str, k)) for k in table.profiles)}, "
        f"{len(table.cutovers)} cutovers -> {path.name}")
    if table.source != "wallclock" or not table.profiles:
        fail("measured serving path: no wall-clock profile fitted")
    del sched
    torch.cuda.empty_cache()
    return launches, path


def phase_tuning(torch, ops, serve, engine_mod, barrier_out, table_path):
    """Phase 27: phase 3 under ISHMEM_TUNING_FILE (phase 26's wall-clock
    table armed, tokens bitwise), under ISHMEM_FORCE_PATH=engine (tokens
    bitwise, no op whose path the chooser picks on the direct path), then
    a short fleet with ``--refit 4 --profile``: at least one re-fit from
    the card's measured samples, every finished request bitwise its
    single-PE baseline (the counts are printed, not held: the table steers
    the modeled clock that SLO admission reads).  Returns its launches by
    run."""
    runs = {}
    for var, val, label in (
            ("ISHMEM_TUNING_FILE", str(table_path), "tuning-file path"),
            ("ISHMEM_FORCE_PATH", "engine", "forced-engine path")):
        os.environ[var] = val
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                sched, launches, wall, peak = _serve_phase(
                    torch, ops, serve, MAIN_ARGV, label)
        finally:
            del os.environ[var]
        _balanced(sched, label)
        _same_tokens(sched, barrier_out, f"{label} (vs phase 3)")
        tuning = sched.ctx.tuning
        paths = sorted({(op, p) for op, p, _, _ in
                        sched.ctx.telemetry.buckets})
        say(f"{label}: {wall:.2f} s wall; launches {launches}; table "
            f"{getattr(tuning.table, 'source', None)}; force "
            f"{tuning.force_path}; (op, path) {paths}")
        if var == "ISHMEM_TUNING_FILE" and (
                tuning.table is None or tuning.table.source != "wallclock"):
            fail(f"{label}: the armed table is {tuning.table}")
        direct = {op for op, p in paths if p == "direct"}
        if var == "ISHMEM_FORCE_PATH" and not (
                direct <= FIXED_PATH_OPS
                and ("kvxfer_block", "engine") in paths):
            fail(f"{label}: ops left on the direct path: "
                 f"{sorted(direct - FIXED_PATH_OPS)}")
        runs[label] = launches
        del sched
        torch.cuda.empty_cache()
    fleet, specs, rep, launches, wall, peak, _ = _run_fleet_phase(
        torch, ops, serve, engine_mod, REFIT_FLEET_ARGV, "re-fit fleet path")
    obs = fleet.obs
    events = [(ev.step, ev.nsamples, ev.ncutovers, len(ev.changed))
              for ev in obs.refitter.history]
    got = _fleet_counts(fleet, rep, launches)
    say(f"re-fit fleet path: {wall:.2f} s wall, peak {peak:.1f} GiB; "
        f"counts {got} (not held); {len(obs.prof.samples)} measured "
        f"samples; re-fits (step, samples, cutovers, flips) {events}; "
        f"table source {getattr(fleet.ctx.tuning.table, 'source', None)}")
    if not events:
        fail("re-fit fleet path: no re-fit ran")
    n, secs = _fleet_baseline(torch, fleet, "re-fit fleet path")
    say(f"re-fit fleet path: {n}/{rep['completed']} finished requests "
        f"bitwise equal to the single-PE baseline ({secs:.2f} s)")
    runs["re-fit fleet path"] = launches
    del fleet
    torch.cuda.empty_cache()
    return runs


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    # the phases set the knobs they test themselves: a stray ISHMEM_* or
    # ISHMEM_OBS_* variable must not change what they check
    for name in [n for n in os.environ if n.startswith("ISHMEM_")]:
        del os.environ[name]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        run(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(torch, tmp: Path) -> None:
    """The phases (module docstring); ``tmp`` takes every file they
    write."""
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build, flash_attn, ishmem_device, ops, \
        reduce_tile, ring_collectives, rma_copy
    from repro_torch.launch import serve, shmem_collectives
    from repro_torch.obs import export
    from repro_torch.serve import engine as engine_mod

    # ---- 1. device and build ------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    say(f"torch {torch.__version__} (CUDA {torch.version.cuda}); kernels "
        f"built in {time.perf_counter() - t0:.1f} s -> {so.name}")
    entry = ""          # ptxas's report on the bf16 K2 and the K10 kernels
    for line in (so.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line
            continue
        hd = next((d for d in (128, 80, 32) if f"ILi{d}E" in entry), 64)
        if "flash_fwd_wgmma" in entry and ("setmaxnreg" in line or "spill"
                                           in line or "Used" in line):
            say(f"ptxas, bf16 K2 hd {hd}: {line.strip()}")
        elif "paged_flash_wgmma" in entry and ("spill" in line or "Used"
                                               in line):
            say(f"ptxas, K11 hd {hd}: {line.strip()}")
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            if spill and (int(spill[1]) or int(spill[2])):
                fail(f"the K11 kernel at hd {hd} spills: {line.strip()}")
        elif "flash_partial_tf32" in entry and ("spill" in line or "Used"
                                                in line):
            lo = "f32" if "Lb1E" in entry else "bf16"
            say(f"ptxas, K10 hd {hd} {lo}: {line.strip()}")
        elif "split_" in entry and ("spill" in line or "Used" in line):
            name = "split_vt" if "split_vt" in entry else "split_rows"
            dt = "bf16" if "bfloat16" in entry else "f32"
            say(f"ptxas, K10 split pass {name} {dt}: {line.strip()}")
    hgmma = {}
    for label, kernel in (("bf16 K2", "flash_fwd_wgmma"),
                          ("K11", "paged_flash_wgmma"),
                          ("K10", "flash_partial_tf32")):
        hgmma[label] = hgmma_count(_build, so, kernel)
        say(f"{label} kernels: {hgmma[label]} HGMMA instructions in the "
            "built library" if hgmma[label] is not None else
            f"{label} kernels: no cuobjdump, HGMMA not counted")
        if hgmma[label] == 0:
            fail(f"the {label} kernels hold no HGMMA instruction")

    # ---- 2. kernels against their plain versions ----------------------------
    deferred = []                    # device-only timings, taken last
    rows = [check_copy(torch, rma_copy, _build, dev, deferred),
            check_flash(torch, flash_attn, dev, deferred),
            check_flash80(torch, flash_attn, dev, deferred),
            *check_flash_serving(torch, flash_attn, dev, deferred),
            check_gather(torch, ishmem_device, ops, dev, deferred)]
    torch.cuda.empty_cache()
    rows += check_ring(torch, ring_collectives, rma_copy, _build, dev,
                       deferred)
    torch.cuda.empty_cache()
    rows += [check_reduce_tile(torch, reduce_tile, dev, deferred),
             check_flash_partial(torch, ishmem_device, dev, deferred),
             check_flash_partial_width(
                 torch, ishmem_device, dev, deferred,
                 name="flash_partial_hd32", Sh=8, H=4, hd=32, me=3,
                 path="phase 6's demo ring (4 PEs, 32 tokens)"),
             check_flash_partial_width(
                 torch, ishmem_device, dev, deferred,
                 name="flash_partial_hd80", Sh=4096, H=32, hd=80, me=3,
                 path="phase 6's zamba2 ring (4 PEs, 16384 tokens)")]
    for r in rows:
        lib_ms = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        say(f"{r['name']} [{r['shape']}]: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib_ms}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max|err| "
            f"{r['max_abs_err']}")
    torch.cuda.empty_cache()

    # ---- 3. the serving path ------------------------------------------------
    say("main path: serve " + " ".join(MAIN_ARGV) + " (depth 36, no cut)")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched = serve.main(MAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    say(f"main path: {wall:.2f} s wall, {sched.stats.decode_steps} decode "
        f"steps, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
        f"launches {launches}")
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        fail(f"serving path never launched {missing}")
    st = sched.stats
    counts = (st.prefills, st.migrations, st.admissions, st.evictions)
    ratio = sched.ctx.pending.stats.coalescing_ratio()
    say(f"SchedStats prefills/migrations/admissions/evictions = {counts}; "
        f"coalescing ratio {ratio:.2f}; decode graph "
        f"{st.decode_graph.counter()}")
    if counts != (8, 8, 8, 8) or not ratio > 1.0:
        fail("scheduler counters do not balance")
    if st.decode_graph.captures != 1 or st.decode_graph.eager_steps:
        fail("the paged decode step did not replay one captured graph")

    eng, slots = sched.engine, len(sched.banks[sched.decode_pes[0]].active)
    t0 = time.perf_counter()
    for rid, req in sorted(sched.requests.items()):
        base = eng.generate_in_slot(req.batch, sched.scfg, num_slots=slots,
                                    slot=req.slot)
        if base != req.out:
            fail(f"request {rid}: disaggregated tokens {req.out} != "
                 f"single-PE baseline {base}")
    torch.cuda.synchronize()
    say(f"8/8 requests bitwise equal to the single-PE baseline "
        f"({time.perf_counter() - t0:.2f} s for the baseline)")
    barrier_out = {rid: list(r.out) for rid, r in sched.requests.items()}
    barrier_fb = sum(st.ttfd_first_block_steps) / len(
        st.ttfd_first_block_steps)
    barrier_ttfd = sum(st.ttfd_model_s) / len(st.ttfd_model_s)
    _, logits, _ = eng.prefill_request(sched.requests[0].batch)
    if logits.shape != (1, sched.engine.cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"prefill logits not finite of shape (1, vocab): {logits.shape}")

    del sched, eng, logits
    torch.cuda.empty_cache()

    # ---- 4. the collectives path --------------------------------------------
    say("collectives path: shmem_collectives " + " ".join(COLL_ARGV))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = shmem_collectives.main(COLL_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    coll_launches = dict(ops.LAUNCHES)
    worst = max(report["max_abs_err"].items(), key=lambda kv: kv[1])
    say(f"collectives path: {wall:.2f} s wall, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches "
        f"{coll_launches}; {len(report['max_abs_err'])} checks, largest "
        f"|err| {worst[1]:.3e} ({worst[0]})")
    missing = [k for k in RING_KERNELS if coll_launches[k] == 0]
    if missing:
        fail(f"collectives path never launched {missing}")

    def collectives_quiet():
        with contextlib.redirect_stdout(io.StringIO()):
            shmem_collectives.main(COLL_ARGV)

    # K7's device time summed over one run of this path's broadcasts
    k7 = next(r for r in rows if r["name"] == "push_broadcast")
    deferred.append((k7, "path_device_ms", collectives_quiet,
                     "broadcast_pull", {"iters": 1, "per_call": 1}))

    # ---- 5. the fused serving path ------------------------------------------
    say("fused serving path: serve " + " ".join(FUSED_ARGV))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched = serve.main(FUSED_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fused_launches = dict(ops.LAUNCHES)
    st = sched.stats
    fused_fb = sum(st.ttfd_first_block_steps) / len(st.ttfd_first_block_steps)
    say(f"fused serving path: {wall:.2f} s wall, {st.decode_steps} decode "
        f"steps, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
        f"launches {fused_launches}; mean first-resident-block step "
        f"{fused_fb:.3f} (barrier protocol, phase 3: {barrier_fb:.3f})")
    missing = [k for k in SERVE_KERNELS if fused_launches[k] == 0]
    if missing:
        fail(f"fused serving path never launched {missing}")
    counts = (st.prefills, st.migrations, st.admissions, st.evictions)
    if counts != (8, 8, 8, 8) or len(sched.ctx.pending) or \
            not sched.fused_attn:
        fail(f"fused scheduler counters {counts} do not balance or "
             f"{len(sched.ctx.pending)} ops stay pending")
    if not fused_fb < barrier_fb:
        fail(f"fused mean first-block step {fused_fb} is not below the "
             f"barrier protocol's {barrier_fb}")
    eng, slots = sched.engine, len(sched.banks[sched.decode_pes[0]].active)
    for rid, req in sorted(sched.requests.items()):
        base = eng.generate_in_slot(req.batch, sched.scfg, num_slots=slots,
                                    slot=req.slot)
        if req.out != barrier_out[rid] or req.out != base:
            fail(f"request {rid}: fused tokens {req.out} != phase 3's "
                 f"{barrier_out[rid]} or the single-PE baseline {base}")
    say("8/8 fused requests bitwise equal to phase 3 and to the single-PE "
        "baseline")
    k11 = check_fused_paged_attn(torch, ishmem_device, flash_attn, ops, sched,
                                 "phase 5's pool")
    k11["path"] = "none: the fused serving path reads through assemble, " \
        "as the reference's does"
    rows.append(k11)
    say(f"fused_paged_attn (K11) [{k11['shape']}]: {k11['ms']:.4f} ms by "
        f"events, device {k11['device_ms']} ms (every device operation of "
        f"a call {k11['call_device_ms']}), launches per call "
        f"{k11['launches_per_call']}; bound {k11['bound_ms']:.4f} ms "
        f"({k11['bound_by']}); plain {k11['plain_ms']:.4f} ms; library none "
        f"(no one PyTorch call gathers through a block table and attends); "
        f"max|err| vs plain {k11['max_abs_err']:.3e}; before (device waits "
        f"+ K3 + K2): {k11['before_ms']:.4f} ms by events, device "
        f"{k11['before_device_ms']} ms (K3 {k11['before_device_ms_gather']}"
        f" + K2 {k11['before_device_ms_flash']})")
    del sched, eng
    torch.cuda.empty_cache()

    # ---- 6. the ring attention path -----------------------------------------
    say(f"ring attention path: serve.seq_parallel_report {RING}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ring = serve.seq_parallel_report(**RING, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ring_launches = dict(ops.LAUNCHES)
    say(f"ring attention path: {wall:.2f} s wall, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches "
        f"{ring_launches}; max|err| vs K2 {ring['max_abs_err']:.3e}")
    if ring_launches["flash_partial"] != RING_PARTIALS or \
            ring_launches["flash_partial_split"] != RING_PARTIALS or \
            ring["partials"] != RING_PARTIALS:
        fail(f"ring path launched flash_partial "
             f"{ring_launches['flash_partial']} times and its split pass "
             f"{ring_launches['flash_partial_split']}, not {RING_PARTIALS}")
    if not ring_launches["flash_attention"]:
        fail("ring path never launched K2 for its check")
    if not (ring["finite"] and ring["shape"] == (1, 32768, 32, 128)
            and ring["max_abs_err"] <= RING_TOL):
        fail(f"ring attention output {ring['shape']} (finite "
             f"{ring['finite']}) is {ring['max_abs_err']:.3e} from K2, "
             f"above {RING_TOL}")
    torch.cuda.empty_cache()
    # the demo's 0.1 scale flattens the softmax, so far along the sequence
    # one key masked wrongly at a shard border moves an output by less than
    # RING_TOL; at unit scale such an error stays above it
    ops.reset_launches()
    unit = serve.seq_parallel_report(**RING, scale=1.0, device=dev)
    torch.cuda.synchronize()
    unit_launches = dict(ops.LAUNCHES)
    say(f"ring attention path at unit-scale inputs: launches "
        f"{unit_launches}; max|err| vs K2 {unit['max_abs_err']:.3e}")
    if unit_launches["flash_partial"] != RING_PARTIALS or not (
            unit["finite"] and unit["max_abs_err"] <= RING_TOL):
        fail(f"ring attention at unit scale: {unit_launches['flash_partial']}"
             f" partials, {unit['max_abs_err']:.3e} from K2 (limit "
             f"{RING_TOL})")
    del unit
    torch.cuda.empty_cache()
    # the reference launcher's demo widths (hd 32), then zamba2's (hd 80)
    ring_widths = {}
    for label, kw, shape, against in (
            ("demo", RING_DEMO, (1, 32, 4, 32), "plain causal attention"),
            ("zamba2", RING_ZAMBA, (1, 16384, 32, 80), "single-PE flash")):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = serve.seq_parallel_report(**kw, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ring_widths[label] = dict(ops.LAUNCHES)
        say(f"ring attention path, {label} widths {kw}: {wall:.2f} s wall; "
            f"launches {ring_widths[label]}; max|err| vs {rep['against']} "
            f"{rep['max_abs_err']:.3e}")
        if ring_widths[label]["flash_partial"] != RING4_PARTIALS or \
                ring_widths[label]["flash_partial_split"] != RING4_PARTIALS:
            fail(f"ring attention at {label} widths: "
                 f"{ring_widths[label]['flash_partial']} partials, not "
                 f"{RING4_PARTIALS}")
        if not (rep["finite"] and rep["shape"] == shape
                and rep["against"] == against
                and rep["max_abs_err"] <= RING_TOL):
            fail(f"ring attention at {label} widths: {rep['shape']} "
                 f"(finite {rep['finite']}) is {rep['max_abs_err']:.3e} "
                 f"from the {rep['against']}, above {RING_TOL}")
        if (label == "zamba2") != bool(ring_widths[label]["flash_attention"]):
            fail(f"ring attention at {label} widths: K2 launched "
                 f"{ring_widths[label]['flash_attention']} times")
        del rep
        torch.cuda.empty_cache()

    # ---- 7-9. streamed, shared-prefix and dense-rehydrate serving ----------
    mode_launches = {"7": phase_stream(torch, ops, serve, export, barrier_out,
                                       barrier_ttfd)}
    torch.cuda.empty_cache()
    mode_launches["8"] = phase_prefix(torch, ops, serve)
    torch.cuda.empty_cache()
    mode_launches["9"] = phase_dense(torch, ops, serve, barrier_out)
    torch.cuda.empty_cache()

    # ---- 10-12. zamba2 (barrier and fused protocols) and xlstm serving ------
    zamba_out, zamba_fb, mode_launches["10"] = phase_zamba(torch, ops, serve)
    torch.cuda.empty_cache()
    mode_launches["11"], k11_80 = phase_zamba_fused(
        torch, ops, serve, ishmem_device, flash_attn, zamba_out, zamba_fb)
    rows.append(k11_80)
    torch.cuda.empty_cache()
    mode_launches["12"] = phase_xlstm(torch, ops, serve)
    torch.cuda.empty_cache()

    # ---- 13-20. the seven remaining configurations ---------------------------
    family_launches, k11_64 = phase_families(torch, ops, serve, ishmem_device,
                                             flash_attn, dev)
    mode_launches.update(family_launches)
    rows.append(k11_64)

    # ---- 22-24. cross-pod serving, the fleet, chaos --------------------------
    cross, k11_22 = phase_cross_pod(
        torch, ops, serve, ishmem_device, flash_attn, barrier_out,
        {"barrier": launches["copy_into"],
         "fused": fused_launches["copy_into"]})
    mode_launches.update(cross)
    fleet_out, fleet_rep, mode_launches["23"] = phase_fleet(
        torch, ops, serve, engine_mod)
    mode_launches["24"] = phase_chaos(torch, ops, serve, engine_mod, export,
                                      fleet_out, tmp)

    # ---- 25-27. the observability bundle, measured, the tuning knobs ------
    mode_launches["25"] = phase_obs(torch, ops, serve, engine_mod, export,
                                    (fleet_out, fleet_rep), tmp)
    mode_launches["26"], table_path = phase_measured(
        torch, ops, serve, export, barrier_out, tmp)
    tuning_runs = phase_tuning(torch, ops, serve, engine_mod, barrier_out,
                               table_path)
    for label, run_launches in zip(("27", "27-force", "27-refit"),
                                   tuning_runs.values()):
        mode_launches[label] = run_launches

    # ---- 21. training, data-parallel through the ring kernels -------------
    train_launches = phase_train(torch, ops, dev)

    # ---- 28. the dry-run held by the card ---------------------------------
    dry_launches, dry = phase_dryrun(torch, ops, dev, smi)
    mode_launches.update(dry_launches)

    # ---- 29. the three policy fields ----------------------------------------
    mode_launches["29"], mha = phase_policy(torch, ops, dev, smi, deferred,
                                            dry)
    rows.append(mha)

    # ---- 30. the four torch examples ---------------------------------------
    example_launches = phase_examples(torch, ops)
    for name, run_launches in example_launches.items():
        mode_launches[f"30 {name}"] = run_launches

    # ---- 31. training at full width and depth -------------------------------
    full_train = {}
    for spec in FULL_TRAIN:
        mode_launches[f"31 {spec['label']}"], full_train[spec["label"]] = \
            phase_full_train(torch, ops, dev, smi, spec)
    # the K5/K6 rows, made after the training phases so that their inputs
    # do not share the card with them
    rows += check_train_rows(
        torch, ring_collectives, dev, deferred, P=TRAIN["npes"],
        elems=TRAIN_EMBED_ELEMS, suffix="train", phase="phase 21",
        leaf="the embedding leaf's gradient")
    rows += check_train_rows(
        torch, ring_collectives, dev, deferred, P=FULL_TRAIN[0]["npes"],
        elems=FULL_LEAF_ELEMS, suffix="full", phase="phase 31",
        leaf="qwen3-4b's stacked w_gate gradient")

    # ---- device-only times of the short kernels (torch.profiler) -----------
    for row, key, fn, match, *kw in deferred:
        row[key] = device_ms(torch, fn, match, **(kw[0] if kw else {}))
        say(f"{row.get('name', row['shape'])} {key}: " + (
            "not measured" if row[key] is None else f"{row[key]:.5f} ms"))

    by_name = {r["name"]: r for r in rows}
    for r in (by_name["copy_into"], by_name["paged_gather"],
              by_name["ring_allgather"], by_name["push_broadcast"]):
        if r.get("device_ms"):
            r["bound_share"] = r["bound_ms"] / r["device_ms"]
        say(f"{r['name']} [{r['shape']}]: {r['ms']:.4f} ms by events, "
            f"device {r.get('device_ms')} ms ({r.get('bound_share')} of its "
            f"{r['bound_ms']:.4f} ms bound); library {r['library_ms']:.4f} ms "
            f"by events, device {r.get('library_device_ms')} ms")
    say(f"push_broadcast over the collectives path's "
        f"{coll_launches['push_broadcast']} launches: "
        f"{k7.get('path_device_ms')} ms device in all")
    k8 = by_name["barrier_push"]
    say(f"barrier_push (K8) [{k8['shape']}]: {k8['ms']:.4f} ms by events, "
        f"{k8['ms'] / k8['bound_ms']:.2f}x the empty launch's; device "
        f"{k8.get('device_ms')} ms over every device operation of a call "
        f"(kernel alone {k8.get('kernel_device_ms')}), empty launch "
        f"{k8.get('noop_device_ms')} ms")
    say(f"paged_gather with the card table (one sync a call): "
        f"{by_name['paged_gather']['card_table_ms']:.4f} ms by events")
    k2 = rows[1]
    k2["hgmma"] = hgmma["bf16 K2"]
    for name in ("flash_partial", "flash_partial_hd32", "flash_partial_hd80"):
        by_name[name]["hgmma"] = hgmma["K10"]
    k11["hgmma"] = k11_80["hgmma"] = k11_64["hgmma"] = hgmma["K11"]
    long = k2["long"]
    if long.get("device_ms"):
        long["tflops"] = long["flops"] / long["device_ms"] / 1e9
        long["bound_share"] = long["bound_ms"] / long["device_ms"]
    long["launches"] = mode_launches["28"]["flash_attention"]
    long["launches_in"] = "phase 28's full-depth qwen3-4b prefill"
    k2["phase_28"] = dry
    say(f"K2 bf16 {long['shape']}: {long['ms']:.4f} ms by events, device "
        f"{long.get('device_ms')} ms, {long.get('tflops')} TFLOP/s, "
        f"{long.get('bound_share')} of its {long['bound_ms']:.4f} ms bound "
        f"({long['bound_by']}); SDPA {long['library_ms']:.4f} ms by events, "
        f"device {long.get('library_device_ms')} ms; plain "
        f"{long['plain_ms']:.4f} ms")
    path_launches = {k: launches[k] for k in SERVE_KERNELS}
    path_launches.update({k: coll_launches[k] for k in RING_KERNELS})
    path_launches["flash_partial"] = ring_launches["flash_partial"]
    path_launches["flash_partial_hd32"] = ring_widths["demo"]["flash_partial"]
    path_launches["flash_partial_hd80"] = \
        ring_widths["zamba2"]["flash_partial"]
    path_launches["fused_paged_attn"] = fused_launches["fused_paged_attn"]
    path_launches["flash_attention_hd80"] = \
        mode_launches["10"]["flash_attention"]
    path_launches["fused_paged_attn_hd80"] = \
        mode_launches["11"]["fused_paged_attn"]
    path_launches["flash_attention_gqa9"] = \
        mode_launches["15"]["flash_attention"]
    path_launches["flash_attention_hd64"] = \
        mode_launches["18"]["flash_attention"]
    path_launches["fused_paged_attn_hd64"] = \
        mode_launches["19"]["fused_paged_attn"]
    by_name["flash_partial"]["split_launches"] = \
        ring_launches["flash_partial_split"]
    path_launches["reduce_tile"] = sum(
        run["reduce_tile"] for run in (launches, coll_launches,
                                       fused_launches, ring_launches,
                                       train_launches,
                                       *ring_widths.values(),
                                       *mode_launches.values()))
    if path_launches["reduce_tile"]:
        fail(f"K9 launched {path_launches['reduce_tile']} times on the "
             f"paths, which should not call it")
    for name in TRAIN_KERNELS:       # K4-K6: phases 4, 21, 28c, 30 and 31
        by_name[name]["launches_by_phase"] = {
            "4": coll_launches[name], "21": train_launches[name],
            **{phase: run[name] for phase, run in mode_launches.items()
               if phase == "28-train" or phase.startswith(("30", "31"))}}
    for name in ("ring_reduce_scatter", "ring_allgather"):
        path_launches[f"{name}_train"] = train_launches[name]
        by_name[f"{name}_train"]["launches_by_phase"] = {
            "21": train_launches[name],
            "28-train": mode_launches["28-train"][name]}
        path_launches[f"{name}_full"] = mode_launches["31 qwen3-4b"][name]
        by_name[f"{name}_full"]["launches_by_phase"] = {
            f"31 {label}": mode_launches[f"31 {label}"][name]
            for label in full_train}
    path_launches["flash_attention_mha4k"] = \
        mode_launches["29"]["flash_attention"]
    by_name["flash_attention_mha4k"]["launches_in"] = \
        "phase 29's full-depth qwen3-4b prefill under attn_repeat_kv"
    by_name["ring_reduce_scatter_full"]["phase_31"] = full_train
    for r in rows:
        r["launches"] = path_launches[r["name"]]
    for name in SERVE_KERNELS:
        by_name[name]["launches_by_phase"] = {
            phase: run[name] for phase, run in mode_launches.items()}
    k11["launches_by_phase"] = {
        phase: mode_launches[phase]["fused_paged_attn"]
        for phase in ("22", "22-fused", "23", "24", "25", "26", "27",
                      "27-force", "27-refit")}
    k11["launches_on_phase_22_pool"] = k11_22
    by_name["reduce_tile"]["path"] = "none: only the reference's " \
        "benchmark and tests call K9"
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
