#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA Hopper card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printing JSON lines (any failed check exits non-zero):

1. device    — the card's name and power limit (nvidia-smi), capability 9.0;
2. build     — compile every kernel from ``kernels/csrc`` (``flash_decode``,
               ``ssd_chunk``, ``ssd_chunk_bwd``), one ``nvcc`` per source,
               all started together;
3. kernels   — hold each kernel against its plain PyTorch version computed
               in fp32 on the same inputs, and time the kernel, the plain
               version and (where one exists) one PyTorch library call with
               CUDA events (median of 100 runs, L2 flushed before each run).
               ``flash_decode``: the CPU test cases, a length-1 row, a cache
               that is a strided view into a state buffer, every (D, G)
               pair built beyond D = 64 and 128 (gemma3's (320, 2) and
               (168, 2) among them) with empty spans, gemma3's global
               layer read through views of a full-width period's state
               buffer, and the serving shapes of qwen3-0.6b (full, random
               and the serve phase's lengths) and gemma3-4b (full and the
               serve mix's lengths; there SDPA runs on its math backend,
               named with each backend's time: the fused ones refuse
               D = 320 or the mask) and granite-moe-3b-a800m (G = 3 at
               D = 64: full and the serve mix's lengths, in bf16 on the
               full state buffer and in fp32 on a one-layer one) and
               zamba2-7b's shared block ((224, 1) on its K/V cache in the
               8 x 2048 state buffer beside 81 Mamba2 states) and
               internvl2-1b's layers ((64, 7)), with split count and
               scratch bytes; zamba2's and internvl2's caches also read
               through views of one full-width period's state buffer.
               ``ssd_chunk``: the CPU
               test cases (slow decay included, the tensor-core kernel's
               edge shapes, and B/C from two groups repeated over 16
               heads, zamba2's layout) and reduced mamba2-2.7b's chunk as
               examples/train_lm calls it in every dtype pair, mamba2-2.7b's
               prefill chunk (L=256, H=80, P=64, N=128, bf16, B/C one group
               at head stride 0) with the original and a slow decay, and
               zamba2-7b's (L=256, H=112, P=64, N=64, bf16, B/C from 2
               groups). ``flash_decode_paged`` (the same kernel reading K/V
               through a page table): pages of 16 KiB, 64 KiB and 1040 B,
               ascending and shuffled tables with null pages past the
               lengths, a length-1 row, an unmapped page inside a length,
               gemma3's (320, 2) whose rows straddle 1040-byte pages, in
               fp32 and bf16; bit-equal to ``flash_decode`` on the gathered
               cache at qwen3-0.6b's serving layout (its own paged plan,
               64 KiB pages, a shuffled table) and at granite's (64, 3);
               timed there beside its plain version, ``flash_decode`` on
               the gathered cache and the gather alone, and so at gemma3's
               ring (8, 4, 2, 320, 1024) and zamba2's shared block (8, 32,
               1, 224, 2048) from 64 KiB pages. Rings: ``flash_decode`` at
               ``lengths = min(pos + 1, T)`` after the model's ring write
               against the ring-masked plain core on a ring written
               apart, at T of 1 to 1024 before and past the wrap, one
               full-width gemma3 window layer decoded over 1,100 positions
               against ``attn_prefill``, and the timing at gemma3-4b's ring
               in its state buffer beside SDPA under the ring mask. Paged
               Mamba2 state: ``mamba_decode`` through a shuffled table
               equal to the symmetric step bit for bit (mamba2-2.7b and
               zamba2-7b, pages of 16 and 64 KiB);
4. parity    — a full-width 2-layer fp32 qwen3 engine served twice from one
               seed, with the kernel attention and with the plain
               attention: greedy tokens identical, logits within 1e-4; and
               every captured, arena-backed step of the first against the
               model's eager decode_step fed the same inputs (bit for bit
               expected, else within 1e-6);
5. serve     — ``repro_torch.launch.serve.run`` on full-width qwen3-0.6b (28
               layers, bf16) with 8 slots x 2048 positions and 8 requests: all
               finish, the state is one buffer of exactly the planned size that
               never moves, every decode step is a replay of the captured step,
               and its captured flash_decode launches x replays = decode steps
               x 28; the graph pool's bytes beside the planned arena;
6. profile   — the same engine on 8 more requests: 8 steady waves timed,
               8 more under torch.profiler (device time per wave, its share
               of the wall time, kernel launches per wave, top kernels);
7. serve_block — the serve phase's 8 requests at ``--block-size 8``: the
               host loop's tokens, one host sync per block, every wave a
               replay; the same requests again under the decode lint (no
               findings); then 8 steady blocks timed and 8 profiled;
8. prefill_parity — a full-width 2-layer fp32 mamba2 prefilled at 600 tokens
               (3 chunks, the last padded) with the kernel SSD core and with
               the plain one, at the random init's decay and at a slow one
               (the state carried between chunks far above the bar, and
               dropping it misses by over 100x the bar): last logits and
               both state leaves agree; then prefill(t[:n]) + 4 decode
               steps agrees with forward(t);
9. prefill   — full-width mamba2-2.7b (64 layers, bf16) prefills one request
               of 2048 tokens through ``ArenaExecutor``: ssd_chunk launched
               exactly 8 x 64 = 512 times, logits and caches equal to the
               eager prefill's, wall and kernel device time, and the planned
               prefill arena beside the allocator's peak above it and the
               eager prefill's peak;
10. serve_mamba — ``serve.run`` on full-width mamba2-2.7b with 8 slots and 8
               requests of 32 prompt + 64 new tokens: all finish, every
               decode step is a replay, and the state is one buffer of
               exactly the planned size that never moves;
11. parity_gemma3 — gemma3-4b at full width, cut to two layers (a window
               layer of 1024 and the global layer), fp32, 2 slots: a
               1,090-token prompt with 16 new tokens (the ring wraps) and
               two short requests, served as ``parity`` serves qwen3;
12. serve_gemma3 — ``serve.run`` on full-width gemma3-4b (34 layers, bf16)
               with the serve phase's slots and requests: all finish, the
               state is one buffer of exactly 1,635,778,560 B (29 rings of
               1024 positions, 5 global caches of 2048) that never moves,
               every decode step is a replay of one graph holding 34
               flash_decode launches (every layer: a ring is read at
               ``lengths = min(pos + 1, T)``); then 8 steady waves timed
               and 8 profiled;
13. prefill_gemma3 — full-width gemma3-4b prefills 2048 tokens through
               ``ArenaExecutor`` from its certified plan, equal to eager:
               four 512-query chunks per global layer, 1,536-key slices on
               the window layers; no kernel (attention prefill is plain, as
               in the reference);
14. parity_granite — granite-moe-3b-a800m at full width (40 experts top-8,
               24/8 heads of 64: flash_decode at (64, 3)), 2 layers, fp32,
               2 slots: a 700-token prompt and two short ones, served as
               ``parity`` serves qwen3;
15. serve_granite — ``serve.run`` on full-width granite (32 layers, bf16)
               with the serve phase's slots and requests: all finish, the
               state is one buffer of exactly 1,073,741,824 B that never
               moves, every decode step is a replay of one graph holding 32
               flash_decode launches; then 8 steady waves timed and 8
               profiled, and the profiled waves replayed eagerly from a
               snapshot of the state to read their routing (``moe_route``):
               the expert bytes a routed read would take beside the whole
               stacks the one-hot step reads;
16. prefill_granite — full-width granite prefills 2048 tokens through
               ``ArenaExecutor`` from its certified plan, equal to eager: 16
               groups of 128 tokens with capacity 32, the share of (token,
               expert) assignments dropped read through ``moe_route`` (above
               0); no kernel;
17. parity_llama4 — llama4-maverick-400b-a17b at full width cut to one
               period (a dense layer and a MoE layer of 128 experts top-1
               with a shared expert: 17,518,755,840 parameters), bf16, 2
               slots, 3 short requests: all finish, every captured step
               equals the eager one, 2 flash_decode launches at (128, 5) per
               replay, the state is the plan, the peak allocated after init;
18. parity_zamba2 — zamba2-7b at full width (the shared block at 7168,
               32 heads of 224: flash_decode at (224, 1); 2 SSM groups), its
               depth cut to one period (5 Mamba2 layers, one with the shared
               block), fp32, 2 slots, three short requests, served as
               ``parity`` serves qwen3: one flash_decode launch per replay;
19. serve_zamba2 — ``serve.run`` on full-width zamba2-7b (81 layers, bf16)
               with the serve phase's slots and requests: all finish, every
               decode step a replay of one graph holding 13 flash_decode
               launches (the shared block's insertions), the state one
               buffer of the leaves' 6,730,313,728 B plus alignment (13
               shared K/V caches, 81 Mamba2 states) that never moves; then
               8 steady waves timed and 8 profiled, and a roofline with both
               floors (the shared block read once, and at every insertion);
20. prefill_zamba2 — full-width zamba2-7b prefills 2048 tokens through
               ``ArenaExecutor`` from its certified plan, equal to eager:
               ssd_chunk launched 8 x 81 = 648 times (B/C from 2 groups);
21. parity_internvl2 — internvl2-1b at full width, its depth cut to 4
               of 24 layers (for the run's time limit; flash_decode at
               (64, 7)), fp32, 2 slots, a 300-token prompt and two short
               ones, served as ``parity`` serves qwen3;
22. serve_internvl2 — ``serve.run`` on full-width internvl2-1b: 24
               flash_decode launches per replay, the state exactly
               201,326,592 B; 8 steady waves timed and 8 profiled;
23. prefill_internvl2 — full-width internvl2-1b prefills 256 seeded image
               embeddings and 1,792 tokens through ``ArenaExecutor`` from
               its certified plan, equal to eager; no kernel;
24. parity_paged — engines served with 64 KiB pages and symmetric ones
               from one seed, fp32: a full-width 2-layer qwen3, gemma3-4b
               cut as in parity_gemma3 with the 1,090-token prompt
               (every ring wraps), a 2-layer mamba2-2.7b and a 2-layer
               zamba2-7b (one layer after the shared block): tokens and
               slot logs identical, logits bit-equal, every captured paged
               step bit-equal to the model's eager step on a pool of its
               own read through the engine's table, the caches gathered
               through the table byte-identical to the symmetric engine's;
               the last three also served paged with the plain cores,
               logits within 1e-4;
25. serve_paged — ``serve.run`` on full-width qwen3-0.6b at 8 slots x 2048
               with the serve phase's requests from a pool of 896 pages of
               64 KiB, just after a symmetric twin of the serve phase's
               engine: tokens equal to the twin's (and the serve phase's
               when it ran), one buffer of exactly
               58,785,792 B (against 939,524,096 B symmetric) that never
               moves, 896 pages live at the peak and none after the drain,
               a valid page log, every decode step a replay holding 28
               ``flash_decode_paged`` launches and no ``flash_decode``; the
               same requests in blocks of 8 (one host sync per block, then
               under the decode lint) and at a pool of 448 (at most 4 slots
               busy, more waves), tokens equal; tokens/s, device ms per
               steady wave, the device copies per wave by kind, the host time
               of one graph launch and the allocator's peak over a replay,
               beside the twin's, both timed at the same point of the run;
26. serve_bundle — compile → plan bundle → serve: full-width qwen3-0.6b at
               8 slots x 2048 (bf16), the symmetric bucket and the paged one
               (896 pages of 64 KiB), compiled by ``launch/compile`` on
               ``meta`` with their AOT programs, in two background
               processes that see no card (started before the build, they
               run beside the kernel phases), and published into
               manifests (wall time, bundle and pack bytes, records,
               certifier and bundle-lint findings), each also published
               without its program; then ``serve.run(... --plan-bundle
               DIR)`` from the bundles without programs:
               tokens equal to the serve and serve_paged phases' (twins
               served here when those did not run), ``plan_source``
               "bundle" and no warning, ``plan_calls`` and
               ``state_plan_calls`` 0 and ``trace_calls`` 1 over the
               engine's construction (its ``trace_s``), the state and the
               arena fixed, 8,764
               ``flash_decode`` (``flash_decode_paged``) launches as the
               twins', the allocator's peak over a replay 0 B, the cold
               start beside a plan-at-construction engine built right
               after it, and a steady window timed and profiled as the
               profile and serve_paged phases time theirs (device ms per
               wave beside theirs); then a planted mismatch (a bundle for blocks of 8
               handed to a host-loop engine) must come back planned at
               construction with the fingerprint-mismatch warning and the
               same tokens. One row per case (``--keep-going`` lists the
               failed cases; ``chip_faults.py``'s
               ``bundle_fingerprint_ignored`` must fail ``mismatch``);
27. serve_aot — the same two buckets served from the bundles that carry
               their AOT decode programs (``runtime/aot.py``): the program
               loaded, ``trace_calls``, ``plan_calls`` and
               ``state_plan_calls`` 0, as many captures as the twins,
               tokens and 8,764 launches equal to the twins', the
               allocator's peak over a replay 0 B; the cold start, capture
               seconds, program load seconds and pack bytes beside
               serve_bundle's engine (which traces: its trace seconds);
               then a planted stale pack (another torch version in its
               key) must be refused with the warning, traced once, the
               same tokens (``chip_faults.py``'s ``aot_key_ignored`` must
               fail ``stale`` and only it);
28. serve_pytree — ``serve.run(... --no-residency)`` on full-width
               qwen3-0.6b with the serve mix: the residency-off backend
               (the model's step run eagerly over the caches ``init_cache``
               returns, nothing captured, 28 ``flash_decode`` launches per
               step by the wrapper), tokens equal to the serve phase's, the
               caches 939,524,096 B, and the allocator's peak over the
               serve beside the resident engine's and its planned arena +
               state; then the paged bucket's bundle handed to a
               residency-off engine: the warning, symmetric state, the
               plans from the bundle and its program unused, tokens equal;
29. serve_paged_gemma3 — ``serve.run`` on full-width gemma3-4b at 8 slots x
               2048 from a pool of 18,880 pages of 64 KiB, in a fresh
               process of this script (no profiler session before its
               captures), just after a symmetric twin: tokens equal to the
               twin's and to serve_gemma3's, one buffer of exactly
               1,237,385,216 B that never moves, pages live at the peak and
               none after the drain, 34 ``flash_decode_paged`` launches per
               replay and no ``flash_decode``, the allocator's peak over a
               replay 0 B, admission's transient below the pool, the plan's
               carve and certify seconds, aten ops per step, and a steady
               wave of each engine timed and profiled alike; then, those
               engines freed, the bucket compiled into a manifest and the
               same mix served from it without its AOT program: tokens and
               10,642 launches equal, nothing planned or carved, one trace,
               the cold start, the resolve and the state plan seconds
               beside the plan-at-construction engine's, and a steady wave
               timed and profiled as that engine's was; then from it with
               its program: the program loaded, nothing traced, planned or
               carved, as many captures, tokens and 10,642 launches equal,
               the cold start, capture and program load seconds;
30. serve_paged_zamba2 — the same for zamba2-7b from 13,888 pages
               (910,229,504 B): 13 launches per replay, the 81 Mamba2
               layers gathering and putting their state through the table
               (no bundle);
31. smem      — for each kernel instantiation on the paths, the shared
               memory ``kernels/smem_plan.py`` plans for one CTA beside what
               the kernel requests at launch (its exported ``*_smem_bytes``
               query) and the device's opt-in limit: the plan fits, and plans
               no more than the kernel requests;
32. kernels_ssd_bwd — ``ssd_chunk_bwd`` (the backward of ``ssd_chunk``,
               ``csrc/ssd_chunk_bwd.cu``: bf16 x/B/C on the tensor-core
               kernel, fp32 on the CUDA-core one) against its plain version
               in float64 with random upstream gradients: single chunks (the
               CPU cases and reduced mamba2-2.7b's train_lm chunk in every
               dtype pair; mamba2-2.7b's and zamba2-7b's
               prefill chunks in fp32 and bf16, mamba2's at batch 2 in
               bf16) and chains of 2 chunks at the slow decay whose second
               chunk hands the first its state gradient; the autograd of
               ``repro_torch::ssd_chunk`` over the chain against autograd of
               the plain chunk; the kernel timed at both prefill shapes and
               at train_mamba2's call (batch 2) beside its bound, the plain
               version and its CTAs per SM (``chip_faults.py``'s
               ``ssd_bwd_tc_drops_state_chain`` must fail the bf16 chained
               cases and nothing else, ``ssd_bwd_drops_state_chain`` the
               fp32 ones);
33. train     — ``launch/train.run_training`` on full-width qwen3-0.6b
               (seq_len 512, batch 4, 8 AdamW steps), in a fresh process
               under ``torch.use_deterministic_algorithms`` (it launches
               no kernel of the port): while the kernels build, 4 steps
               that save a checkpoint (restored bitwise) and a resume to
               step 8; once the build is done, the uninterrupted 8 steps,
               timed: losses finite and falling, the resumed ones within
               1e-4 of them, grad_norm and lr per step, steps/s,
               tokens/s, the allocator's peak beside params + grads +
               moments;
34. train_mamba2 — full-width mamba2-2.7b (bf16, seq_len 512 = 2 chunks,
               batch 2) trained 4 steps through ``ssd_chunk`` and
               ``ssd_chunk_bwd``: 128 launches of each a step, read from
               the wrappers' counts; the gradients against the plain
               cores (fp32 with the depth cut to 8 layers, at the random
               init's decay and at the slow one over 3 chunks; then the
               bf16 model itself); the peak beside the reckoning; one step
               under ``torch.profiler`` (after every phase that captures a
               graph): device time by kernel, ``ssd_chunk_bwd``'s share of
               the step, the idle share; the same step with ``remat=True``
               (the same loss and gradients, 256 forward launches);
35. train_seamless — full-width seamless-m4t-medium (12 + 12 layers,
               bf16) trained 2 steps by ``run_training`` (seq_len 512,
               zero frames at 128, batch 2): losses finite, the decoder's
               parameters updated (zero frames give the encoder and the
               cross-attention no gradient), every leaf a gradient with
               random frames, the reference's parameter count.
36. dryrun    — (ROADMAP A15.2) ``launch/dryrun.run_one`` with the
               activation plan at (data=16, model=16), in a child
               process that sees no card and starts first (it traces
               beside the other phases): nemotron-4-340b and
               llama4-maverick-400b-a17b decode_32k, qwen3-0.6b train_4k;
               each row ok without a planner error, collective bytes above
               0, its per-device param bytes the sum this script takes of
               each leaf's local shard under the reference's specs (frozen
               in tests/data, held against the reference by
               tests/test_torch_mesh.py); each row's planned activations
               and peak under 80 GB, the train row with ``remat`` on (its
               periods recomputed in the backward, as the reference's dry
               run) and its scores split on T (q on heads, K/V on T where
               the 8 K/V heads do not divide model = 16).
37. sharded   — ``build_step``'s steps on DTensors on the card (a child
               process: NCCL, world 1, a (1, 1) mesh), after every timed
               phase: full-width qwen3-0.6b, 4 decode steps at 8 slots x
               2048 (28 ``flash_decode`` launches a step through the op's
               sharding rule), and full-width mamba2-2.7b, one 2048-token
               prefill (512 ``ssd_chunk`` launches); the train step with
               remat on full-width qwen3-0.6b at 512 x 4 and on mamba2-2.7b
               cut to 8 layers, fp32, at 512 x 2 (32 ``ssd_chunk`` launches,
               the forward's and the recompute's, and 16 ``ssd_chunk_bwd``);
               each bit-equal to the unsharded eager step (the train steps'
               loss, grad norm and every gradient leaf; else within 1e-6),
               the eager twins' launches counted apart.
38. rank_of_256 — rank 0's local program of full-width nemotron-4-340b
               decode_32k over the fake group of 256 ranks on the card (a
               child process): 2.64 GB of local params from a seed, 9.66
               GB of local K/V, one decode step, whose 96 layers each run
               ``flash_decode_lse`` on this rank's span of T (context
               parallel; the kernel at that span first held against its
               plain version, output and log-sum-exp, and timed beside one
               library call, ``aten._scaled_dot_product_efficient_attention``
               on K/V repeated to 96 heads, its log-sum-exp held against
               the kernel's); its
               output's local shape and 96 launches, the allocator's peak
               beside the dry run's ``arg_gb`` and ``planned_act_gb``, the
               step's kernel time (torch.profiler) and CUDA-event time,
               the attention cores; then rank 0's qwen3-0.6b train_4k step
               with remat (local batch 16 x 4,096), its allocator peak
               under 80 GB beside the dry run's ``arg_gb`` +
               ``planned_act_gb`` for that row. The fake group's
               collectives move nothing, so the steps' values are not
               checked.
39. examples  — the twins of the reference's examples
               (``repro_torch.examples``), each through its entry point, on
               the card, after every other phase: quickstart (MobileNet v1
               planned, ``my_model`` run out of its arena on ``cuda``,
               equal to eager); dynamic_shapes (three stages of one 6 MiB
               arena); paper_tables (every claim passes); serve_lm on
               full-width qwen3-0.6b (``--full``: 2,492 ``flash_decode``
               launches, 28 a step) and on reduced mamba2-2.7b, each
               printing the slot audit, live state equal to planned, every
               step a replay, its plan certified; train_lm on reduced
               qwen3-0.6b (200 steps, the final loss below ln(vocab) - 1,
               no kernel) and reduced mamba2-2.7b (50 steps of one
               128-token chunk at d_state 16, head dim 32, float32: 50
               ``ssd_chunk`` and 50 ``ssd_chunk_bwd`` launches, the final
               loss below the first; both kernels held against their
               plain versions at this call's shape in the kernels and
               kernels_ssd_bwd phases, case ``train_lm_mamba2``). One row
               per example.

Every engine is built with ``REPRO_STARTUP_LINT=1``, so its unified plan
(activation and state) is certified by ``analysis/soundness`` before it
captures or serves; the serve, serve_block and every serve_* phase print
it as a ``plan`` row (records, the certifier's seconds, findings: 0; the
paged plan's page pool included), and
the prefill phases certify the plan their executor runs from with
``certify_plan``. The profile, serve_block, serve_* (but serve_mamba) and
prefill phases print a ``roofline`` row: the step's FLOPs and least bytes
from ``launch/roofline.step_count`` (at the positions the profiled waves
read; a ring up to its window), its bound on this card, the device time
measured, their ratio (``roofline_share``) and the model FLOPs
utilisation (``mfu``).

Every path runs at its full depth (the parity phases and train_mamba2's
fp32 gradient check cut depth). The
kernel counts (each wrapper's launches plus each replayed graph's
captured launches per replay) are set to 0 just before each path (phases
5, 9, 10, 12, 13, 15, 16, 17, 19, 20, 22, 23, 25, each serve of 26 and
27, 28, 29 and each of its bundle serves, 30, 34's 4 steps, 37's four
sharded runs, 38's two steps, each serve_lm and train_lm of 39; 7, 24 and
34's gradient checks and 37's eager twins for their own checks) and read
just after it.
Every phase's row carries ``t_s``, the run's seconds when it was
printed.

Kernel bounds come from ``launch/roofline.kernel_bound``. The last four
lines are the run's total seconds, the card's name and power limit, the
per-kernel record (launches summed over the paths that run each kernel,
and by path) and the ``ok`` line. ``--phases`` runs a subset (no final lines), and
``--keep-going`` makes the kernels phase check every case before it fails
(``chip_faults.py`` uses both on copies of the tree with planted faults).
"""

from __future__ import annotations

import dataclasses
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

# kernel -> (route, source in the repo, the TPU kernel it replaces)
KERNELS = {
    "flash_decode": (
        "cuda",
        "src/repro_torch/kernels/csrc/flash_decode.cu",
        "src/repro/kernels/flash_decode.py:69",
    ),
    "ssd_chunk": (
        "cuda",
        "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "src/repro/kernels/ssd_chunk.py:49",
    ),
    # the backward of ssd_chunk (the reference differentiates its XLA scan;
    # the port's forward is a kernel, so its gradient is one too)
    "ssd_chunk_bwd": (
        "cuda",
        "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
        "src/repro/kernels/ssd_chunk.py:49",
    ),
    # flash_decode reading K/V through a page table (the template flag
    # PAGED of the same source)
    "flash_decode_paged": (
        "cuda",
        "src/repro_torch/kernels/csrc/flash_decode.cu",
        "src/repro/kernels/flash_decode.py:69",
    ),
}
# queries at 8x the cache's spread: scores of std 2 at any D, so the softmax
# is peaked and the output is O(0.1) even over 2048 positions
Q_STD = 4.0
DEVICE = "cuda"
# the flash_decode (D, G) pairs built beyond the powers of two at D = 64 and
# 128: gemma3-4b's (320, 2) and gemma3-27b's (168, 2) among them
NEW_PAIRS = ((168, 2), (192, 12), (224, 1), (320, 2), (64, 3), (64, 7), (128, 5))
# flash_decode's timing at gemma3-4b's and granite's serving shapes (the
# kernels phase)
GEMMA3_TIMING: dict = {}
GRANITE_TIMING: dict = {}
GRANITE = "granite-moe-3b-a800m"
# flash_decode's timing at zamba2-7b's shared block (D = 224, G = 1) and
# internvl2-1b's layers (D = 64, G = 7), and ssd_chunk's at zamba2's
# two-group prefill chunk (the kernels phase)
ZAMBA2_TIMING: dict = {}
INTERNVL2_TIMING: dict = {}
ZAMBA2_SSD_TIMING: dict = {}
ZAMBA2 = "zamba2-7b"
INTERNVL2 = "internvl2-1b"


# --keep-going: the kernels phase records failed cases here and fails at
# its end instead of at the first one
KEEP_GOING = False
FAILED_CASES: list[str] = []


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def fail_case(label: str, msg: str) -> None:
    if not KEEP_GOING:
        fail(msg)
    FAILED_CASES.append(label)


def emit(obj: dict) -> None:
    """Print one JSON row; a phase's row carries the run's seconds so far
    (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, runs: int = 100, warmup: int = 10) -> float:
    """Median device time of ``fn`` over ``runs`` launches, each after a
    write of 256 MiB that pushes its inputs out of the 50 MB L2 (as the
    serving loop finds them: 27 other layers run between two reads).

    A spin of ~0.5 ms is queued before each write, so the card is still
    busy when the host queues ``fn``: a Python launch path slower than the
    write would otherwise leave the card idle between the start event and
    the kernel, and that gap would be timed."""
    import torch

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=DEVICE)
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(runs):
        torch.cuda._sleep(1_000_000)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_device() -> tuple[str, str]:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "capability": list(cap), "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if cap != (9, 0):
        fail(f"capability {cap}: the kernels are built for sm_90a")
    from repro_torch.launch import roofline

    roofline.card(name)  # an unknown card has no bounds: it raises here
    return smi, name


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    sources = sorted({Path(src).stem for _, src, _ in KERNELS.values()})
    paths = build.build_all(sources)
    for name in sources:
        build.load(name)
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name, path in paths.items():
        log_path = path.with_suffix(".log")
        log = log_path.read_text() if log_path.exists() else ""
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
        ptxas[name] = {"instantiations": len(regs),
                       "max_registers": max(regs, default=None),
                       "spill_store_bytes_max": max(spills, default=0)}
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas,
          "flash_decode_by_instantiation": flash_decode_ptxas(
              paths["flash_decode"].with_suffix(".log")),
          "ssd_chunk_bwd_by_instantiation": ssd_bwd_ptxas(
              paths["ssd_chunk_bwd"].with_suffix(".log"))})


def flash_decode_ptxas(log_path) -> dict:
    """``-Xptxas -v``'s registers and spill stores of each flash_decode
    instantiation, keyed ``dtype/D/G[/paged]``, with the kernel it is
    (from the mangled name: ``flash_decode_split_kernel``, the CUDA cores,
    or ``flash_decode_tc_kernel``, the tensor cores, bf16 only)."""
    log = log_path.read_text() if log_path.exists() else ""
    out = {}
    for chunk in log.split("Compiling entry function")[1:]:
        m = re.search(r"flash_decode_split_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELb([01])E",
                      chunk)
        tc = re.search(r"flash_decode_tc_kernelILi(\d+)ELi(\d+)ELb([01])E", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        if (m is None and tc is None) or regs is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        if tc is not None:
            dtype, (d, g, paged), path = "bfloat16", tc.groups(), "tensor_core"
        else:
            dtype = "float32" if m.group(1) == "f" else "bfloat16"
            (d, g, paged), path = m.groups()[1:], "cuda_core"
        out[f"{dtype}/{d}/{g}{'/paged' if paged == '1' else ''}"] = {
            "path": path, "registers": int(regs.group(1)),
            "spill_store_bytes": int(spill.group(1)) if spill else 0}
    return out


def ssd_bwd_ptxas(log_path) -> dict:
    """``-Xptxas -v``'s registers, spill stores and stack frame of each
    ssd_chunk_bwd instantiation, keyed ``tc|cuda_core/x dtype/state
    dtype/P`` (from the kernel's mangled name)."""
    log = log_path.read_text() if log_path.exists() else ""
    dtype = {"f": "float32", "13__nv_bfloat16": "bfloat16"}
    t = "(f|13__nv_bfloat16)"
    out = {}
    for chunk in log.split("Compiling entry function")[1:]:
        tc = re.search(rf"ssd_chunk_bwd_tc_kernelI{t}Li(\d+)E", chunk)
        cc = re.search(rf"ssd_chunk_bwd_kernelI{t}{t}Li(\d+)E", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        if regs is None or (tc is None and cc is None):
            continue
        key = (f"tc/bfloat16/{dtype[tc.group(1)]}/{tc.group(2)}" if tc else
               f"cuda_core/{dtype[cc.group(1)]}/{dtype[cc.group(2)]}/{cc.group(3)}")
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        stack = re.search(r"(\d+) bytes stack frame", chunk)
        out[key] = {"registers": int(regs.group(1)),
                    "spill_store_bytes": int(spill.group(1)) if spill else 0,
                    "stack_frame_bytes": int(stack.group(1)) if stack else 0}
    return out


def _residency_cache(cfg, n_slots: int, max_len: int, gen):
    """A filled state buffer laid out by the port's StatePlan, and the
    cache views into it (what the served decode step hands the kernel)."""
    import torch

    from repro_torch.core.unified import plan_state, state_records_from_cache
    from repro_torch.models.transformer import init_cache
    from repro_torch.runtime.residency import StateResidency

    template = init_cache(cfg, n_slots, max_len, "meta")
    plan = plan_state(state_records_from_cache(template, n_slots=n_slots),
                      n_slots=n_slots, max_len=max_len)
    res = StateResidency(plan, template, n_slots=n_slots)
    buf = res.init_buffer(DEVICE)
    dt = getattr(torch, cfg.dtype)
    buf.view(dt).normal_(0.0, 0.5, generator=gen)
    return buf, res.views(buf)


def decode_kv(cfg, caches, period: int = 0):
    """The first K/V cache ``flash_decode`` reads in ``cfg``'s decode step,
    as views of period ``period`` in the state buffer, and its (KV, G, D):
    zamba2's shared block's (its heads are its own K/V heads), else the
    first global attention layer's."""
    from repro_torch.models.transformer import shared_head_dim

    for j, spec in enumerate(cfg.period):
        if spec.shared_attn:
            k, v = caches["period"][j]["shared"]
            return (k[period], v[period], cfg.shared_attn_heads, 1,
                    shared_head_dim(cfg))
    j = next(j for j, spec in enumerate(cfg.period)
             if spec.mixer == "attn" and spec.window is None)
    k, v = caches["period"][j]["attn"]
    return (k[period], v[period], cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
            cfg.resolved_head_dim)


def flash_decode_per_step(cfg) -> int:
    """``flash_decode`` launches in one decode step of ``cfg``: one per
    attention layer, global or ring, and one per insertion of the shared
    block."""
    return sum(int(spec.mixer == "attn") + int(spec.shared_attn)
               for spec in (*cfg.period * cfg.n_periods, *cfg.remainder))


def phase_kernels(card_name: str) -> dict:
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.ref import flash_decode_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    # (atol, rtol) against the plain version in fp32 on the same inputs:
    # fp32 summation order, and for bf16 one rounding of the output (at
    # most 2**-8 of it). The control is the plain version in q's dtype.
    tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 1e-2)}

    def rand(shape, dt, std=0.5):
        return (torch.randn(shape, generator=gen, device=DEVICE) * std).to(dt)

    def check(label, q, k, v, lengths):
        got = fd.flash_decode(q, k, v, lengths)
        want = flash_decode_ref(q.float(), k.float(), v.float(), lengths)
        control = flash_decode_ref(q, k, v, lengths)
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        atol, rtol = tol[q.dtype]
        ok = bool((err <= atol + rtol * want.abs()).all())
        emit({"phase": "kernels", "kernel": "flash_decode", "case": label,
              "dtype": str(q.dtype).removeprefix("torch."),
              "path": fd.kernel_path(q.dtype, q.shape[3], q.shape[2]),
              "max_abs_err": float(err.max()),
              "control_max_abs_err": float((control.float() - want).abs().max()),
              "max_abs_out": float(want.abs().max()),
              "atol": atol, "rtol": rtol, "ok": ok})
        if not ok:
            fail_case(f"flash_decode/{label}/{q.dtype}",
                      f"flash_decode {label}: max abs err {float(err.max())} "
                      f"over {atol} + {rtol} * |want|")
        return float(err.max())

    cases = [(2, 2, 2, 64, 256), (1, 1, 4, 128, 300), (3, 4, 1, 64, 128),
             (2, 1, 8, 64, 1024)]
    for dt in (torch.float32, torch.bfloat16):
        for B, KV, G, D, T in cases:
            q = rand((B, KV, G, D), dt, Q_STD)
            k, v = rand((B, T, KV, D), dt), rand((B, T, KV, D), dt)
            lengths = torch.randint(1, T + 1, (B,), generator=gen, device=DEVICE,
                                    dtype=torch.int32)
            check(f"B{B}_KV{KV}_G{G}_D{D}_T{T}", q, k, v, lengths)
        q = rand((2, 1, 2, 64), dt, Q_STD)
        k, v = rand((2, 256, 1, 64), dt), rand((2, 256, 1, 64), dt)
        lengths = torch.tensor([1, 256], dtype=torch.int32, device=DEVICE)
        check("length1_row", q, k, v, lengths)
        # a cache that is a view into a state buffer: batch stride = the
        # plan's slot stride, larger than T*KV*D
        small = dataclasses.replace(get_config("qwen3-0.6b"), n_periods=2,
                                    dtype=str(dt).removeprefix("torch."))
        _, caches = _residency_cache(small, 3, 96, gen)
        k, v = caches["period"][0]["attn"][0][1], caches["period"][0]["attn"][1][1]
        if k.stride(0) <= k.shape[1] * k.shape[2] * k.shape[3]:
            fail(f"strided case: batch stride {k.stride(0)} is not a slot stride")
        q = rand((3, 8, 2, 64), dt, Q_STD)
        lengths = torch.tensor([1, 50, 96], dtype=torch.int32, device=DEVICE)
        check("strided_residency_view", q, k, v, lengths)
        # every pair built beyond the powers of two at D = 64 and 128 (a
        # warp reads one position): 8 spans of 128, a length-1 row (seven
        # empty spans), a row one position into a span, a full row
        for D, G in NEW_PAIRS:
            B, KV, T = 3, 2, 1024
            q = rand((B, KV, G, D), dt, Q_STD)
            k, v = rand((B, T, KV, D), dt), rand((B, T, KV, D), dt)
            lengths = torch.tensor([1, 385, T], dtype=torch.int32, device=DEVICE)
            check(f"D{D}_G{G}_empty_spans", q, k, v, lengths)
        # the global layer of gemma3 (5 rings and a global cache), granite's
        # and internvl2's layer and zamba2's shared block (beside 6 Mamba2
        # states) read through views into the state buffer of one
        # full-width period at 3 x 96
        for arch in ("gemma3-4b", "gemma3-27b", GRANITE, ZAMBA2, INTERNVL2):
            one = dataclasses.replace(get_config(arch), n_periods=1, remainder=(),
                                      dtype=str(dt).removeprefix("torch."))
            _, caches = _residency_cache(one, 3, 96, gen)
            k, v, KV, G, D = decode_kv(one, caches)
            if k.stride(0) <= k.shape[1] * k.shape[2] * k.shape[3]:
                fail(f"{arch} view: batch stride {k.stride(0)} is not a slot stride")
            q = rand((3, KV, G, D), dt, Q_STD)
            lengths = torch.tensor([1, 50, 96], dtype=torch.int32, device=DEVICE)
            check(f"{arch}_residency_view", q, k, v, lengths)
            del caches

    # the serving shapes, on the serving layout: the first K/V cache read
    # (``decode_kv``) of full-width qwen3-0.6b's, gemma3-4b's, granite's,
    # zamba2's and internvl2's state buffers at 8 slots x 2048 positions,
    # bf16
    record = {}
    for arch, prefix, labels in (
        ("qwen3-0.6b", "", ("serving_full", "serving_random", "serve_mix")),
        ("gemma3-4b", "gemma3_", ("serving_full", "serve_mix")),
        (GRANITE, "granite_", ("serving_full", "serve_mix")),
        (ZAMBA2, "zamba2_", ("serving_full", "serve_mix")),
        (INTERNVL2, "internvl2_", ("serving_full", "serve_mix")),
    ):
        record.update(time_serving(card_name, gen, check, arch, prefix, labels))
    GEMMA3_TIMING.update(record["gemma3_serving_full"])
    GRANITE_TIMING.update(record["granite_serving_full"])
    ZAMBA2_TIMING.update(record["zamba2_serving_full"])
    INTERNVL2_TIMING.update(record["internvl2_serving_full"])
    # granite's serving shape in fp32, on a strided view of a one-layer
    # fp32 state buffer of 8 slots x 2048 positions
    one = dataclasses.replace(get_config(GRANITE), n_periods=1, dtype="float32")
    _, caches = _residency_cache(one, 8, 2048, gen)
    k, v = caches["period"][0]["attn"][0][0], caches["period"][0]["attn"][1][0]
    q = rand((8, one.n_kv_heads, one.n_heads // one.n_kv_heads, one.resolved_head_dim),
             torch.float32, Q_STD)
    check("granite_serving_full", q, k, v,
          torch.full((8,), 2048, dtype=torch.int32, device=DEVICE))
    check("granite_serve_mix", q, k, v,
          torch.linspace(33, 96, 8, device=DEVICE).round().to(torch.int32))
    del caches
    return record["serving_full"]


def sdpa_backends(call) -> tuple[str, dict]:
    """The SDPA backend the default dispatch runs ``call`` on, and each
    backend's time: the first of torch's own priority order that takes
    the inputs (a backend that refuses them raises under ``sdpa_kernel``;
    flash attention takes no attention mask and no D above 256)."""
    import warnings

    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    order = ([SDPBackend(i) for i in torch._C._get_sdp_priority_order()]
             if hasattr(torch._C, "_get_sdp_priority_order") else
             [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.MATH])
    ran, times = None, {}
    for backend in order:
        if backend.name in ("OVERRIDEABLE", "ERROR"):
            continue

        def under(b=backend):
            with sdpa_kernel(b):
                return call()

        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                under()
                torch.cuda.synchronize()
        except RuntimeError as e:
            times[backend.name] = f"refused: {str(e).splitlines()[0][:80]}"
            continue
        ran = ran or backend.name
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            times[backend.name] = cuda_time_ms(under, runs=30)
    return ran, times


def time_serving(card_name, gen, check, arch, prefix, labels) -> dict:
    """``flash_decode`` on the first K/V cache of ``arch``'s full-width
    state buffer at 8 slots x 2048 positions (bf16): checked, then timed
    beside its bound, its plain version and one SDPA call with
    ``enable_gqa=True``, at full lengths (``serving_full``), random ones
    and the serve phase's own (32 prompt + 64 new tokens: 33 to 96 of the
    2048 positions)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.ref import flash_decode_ref
    from repro_torch.launch.roofline import kernel_bound

    cfg = get_config(arch)
    B, T = 8, 2048
    buf, caches = _residency_cache(cfg, B, T, gen)
    k, v, KV, G, D = decode_kv(cfg, caches)
    q = (torch.randn((B, KV, G, D), generator=gen, device=DEVICE) * Q_STD).to(torch.bfloat16)
    lengths_of = {
        "serving_full": lambda: torch.full((B,), T, dtype=torch.int32, device=DEVICE),
        "serving_random": lambda: torch.randint(1, T + 1, (B,), generator=gen,
                                                device=DEVICE, dtype=torch.int32),
        "serve_mix": lambda: torch.linspace(33, 96, B, device=DEVICE).round().to(torch.int32),
    }
    record = {}
    for label in labels:
        lengths = lengths_of[label]()
        err = check(prefix + label, q, k, v, lengths)
        qs = q.reshape(B, KV * G, 1, D)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)  # (B, KV, T, D) views
        mask = (torch.arange(T, device=DEVICE)[None, :] < lengths[:, None])[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)

        lib_err = float((library().reshape(B, KV, G, D).float()
                         - flash_decode_ref(q.float(), k.float(), v.float(), lengths)
                         ).abs().max())
        before = fd.LAUNCHES
        ms = cuda_time_ms(lambda: fd.flash_decode(q, k, v, lengths))
        plain_ms = cuda_time_ms(lambda: flash_decode_ref(q, k, v, lengths))
        library_ms = cuda_time_ms(library)
        fd.LAUNCHES = before  # timing launches are not the main path's
        total_len = int(lengths.sum())
        bound = kernel_bound("flash_decode", {
            "B": B, "KV": KV, "G": G, "D": D, "T": T, "dtype": "bfloat16",
            "sum_lengths": total_len}, card_name=card_name)
        row = {"phase": "kernels", "kernel": "flash_decode", "timing": prefix + label,
               "arch": arch, "shape": [B, KV, G, D, T], "sum_lengths": total_len,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "library": "F.scaled_dot_product_attention(enable_gqa=True)",
               "library_max_abs_err": lib_err,
               "bound_ms": bound.bound_s * 1e3, "bound_by": bound.bound_by,
               "bytes": bound.min_bytes, "flops": bound.flops,
               "bytes_ms": bound.bytes_s * 1e3,
               "fp32_cuda_core_ms": bound.ops_s * 1e3, "max_abs_err": err,
               "n_split": fd.num_splits(B, KV, G, D, T, torch.bfloat16),
               "scratch_bytes": fd.scratch_bytes(B, KV, G, D, T, torch.bfloat16)}
        if prefix:
            row["library_backend"], row["library_ms_by_backend"] = sdpa_backends(library)
        emit(row)
        record[prefix + label] = row
    del buf, caches
    torch.cuda.empty_cache()
    return record


# ssd_chunk cases: (B, L, H, P, N), the decay and the SSM groups of B and C
# (None: B and C drawn per head); the CPU test cases of
# tests/test_torch_ssd.py, one group broadcast over the heads, two groups
# repeated over theirs (zamba2's layout), and reduced mamba2-2.7b's
# training chunk (the prefill chunks of mamba2-2.7b and zamba2-7b follow in
# phase_kernels_ssd)
SSD_CASES = {
    "kernels_0": ((2, 64, 2, 32, 16), "original", None),
    "kernels_1": ((1, 128, 4, 64, 128), "original", None),
    "kernels_2": ((2, 256, 1, 64, 64), "original", None),
    "ragged_L33": ((2, 33, 3, 64, 128), "original", None),
    "L1": ((3, 1, 2, 8, 4), "original", None),
    "slow_L256": ((1, 256, 4, 64, 128), "slow", None),
    "slow_L200_P8": ((2, 200, 3, 8, 4), "slow", None),
    "one_group_L96": ((1, 96, 4, 32, 16), "original", 1),
    "one_group_slow_L96": ((1, 96, 4, 32, 16), "slow", 1),
    # heads 0-7 read group 0's B and C, heads 8-15 group 1's
    "two_groups_L96": ((1, 96, 16, 32, 16), "slow", 2),
    # edges of the tensor-core kernel (bf16 x/B/C): one row in a 64-row tile
    # at P = 64; a ragged second row tile at P = 32, N = 40; N = 13, where x,
    # B and C (slices of one buffer with rows of 154 elements) are loaded
    # element by element, not by 16-byte copies
    "L1_P64": ((2, 1, 3, 64, 128), "slow", None),
    "ragged_L65_P32_N40": ((1, 65, 2, 32, 40), "slow", 1),
    "N13_L130": ((1, 130, 2, 64, 13), "slow", 1),
    # reduced mamba2-2.7b's chunk as examples/train_lm calls it (batch 4,
    # seq-len 128, one group at head stride 0)
    "train_lm_mamba2": ((4, 128, 16, 32, 16), "original", 1),
}
# (x/B/C dtype, state dtype): every pair the kernel builds. fp32; bf16 x
# with an fp32 state (as tests/test_kernels.py passes it); bf16 throughout
# (as the model does); fp32 x with a bf16 state
SSD_DTYPES = (("float32", "float32"), ("bfloat16", "float32"),
              ("bfloat16", "bfloat16"), ("float32", "bfloat16"))


def ssd_inputs(gen, B, L, H, P, N, decay, groups, x_dtype, state_dtype):
    """The distributions of tests/test_kernels.py ("original": dA =
    -exp(0.3 z)·dt, ~-0.7 per position) or dA uniform in [-0.02, -0.001]
    ("slow"). With ``groups``, x, B and C are slices of one (B, L,
    H·P + 2·groups·N) buffer, as the model's conv output, and B and C reach
    the heads as ``mamba_prefill`` hands them over (``ssm._heads``): one
    group through a head stride of 0, more through ``repeat_interleave``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.ssm import _heads

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    xd, sd = getattr(torch, x_dtype), getattr(torch, state_dtype)
    dt = F.softplus(randn(B, L, H))
    if decay == "slow":
        dA = -(torch.rand((B, L, H), generator=gen, device=DEVICE) * 0.019 + 0.001)
    else:
        dA = -torch.exp(randn(B, L, H) * 0.3) * dt
    if groups:
        GN = groups * N
        xbc = (randn(B, L, H * P + 2 * GN) * 0.5).to(xd)
        x = xbc[..., : H * P].unflatten(-1, (H, P))
        Bm = _heads(xbc[..., H * P : H * P + GN].unflatten(-1, (groups, N)), H)
        Cm = _heads(xbc[..., H * P + GN :].unflatten(-1, (groups, N)), H)
    else:
        x = (randn(B, L, H, P) * 0.5).to(xd)
        Bm = (randn(B, L, H, N) * 0.5).to(xd)
        Cm = (randn(B, L, H, N) * 0.5).to(xd)
    state = (randn(B, H, P, N) * 0.5).to(sd)
    return x, dt, dA, Bm, Cm, state


def phase_kernels_ssd(card_name: str) -> dict:
    """ssd_chunk against its plain version computed in fp32 on the same
    inputs. Bars, as atol + rtol·|want|: an fp32 output 1e-5 + 1e-5·|want|
    (fp32 summation order); a bf16 output adds one rounding to bf16, at
    most 2**-8·|want|. The control is the plain version in the working
    dtypes, which rounds its outputs once as well."""
    import torch

    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels.ref import ssd_chunk_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 1e-5 + 2.0**-8)}

    def check(label, inputs):
        x, dt, dA, Bm, Cm, state = inputs
        got = sc.ssd_chunk(*inputs)
        want = ssd_chunk_ref(x.float(), dt, dA, Bm.float(), Cm.float(), state.float())
        control = ssd_chunk_ref(*inputs)
        torch.cuda.synchronize()
        row = {"phase": "kernels", "kernel": "ssd_chunk", "case": label,
               "shape": list(x.shape) + [Bm.shape[-1]],
               "dtype": str(x.dtype).removeprefix("torch."),
               "state_dtype": str(state.dtype).removeprefix("torch.")}
        ok, worst = True, 0.0
        for name, g, w, c in zip(("y", "new_state"), got, want, control):
            err = (g.float() - w).abs()
            atol, rtol = tol[g.dtype]
            bar_ratio = float((err / (atol + rtol * w.abs())).max())
            row[name] = {"max_abs_err": float(err.max()),
                         "control_max_abs_err": float((c.float() - w).abs().max()),
                         "max_abs_out": float(w.abs().max()),
                         "err_over_bar": bar_ratio, "atol": atol, "rtol": rtol}
            ok = ok and bar_ratio <= 1.0
            worst = max(worst, float(err.max()))
        row["ok"] = ok
        emit(row)
        if not ok:
            fail_case(f"ssd_chunk/{label}/{row['dtype']}/{row['state_dtype']}",
                      f"ssd_chunk {label}: error over its bar ({row})")
        return worst

    for x_dtype, state_dtype in SSD_DTYPES:
        for label, (shape, decay, groups) in SSD_CASES.items():
            check(label, ssd_inputs(gen, *shape, decay, groups, x_dtype,
                                    state_dtype))

    # the prefill chunks of full-width mamba2-2.7b (one group, at head
    # stride 0) and zamba2-7b (two groups, repeated over their heads), as
    # mamba_prefill passes them
    from repro_torch.configs.base import get_config
    from repro_torch.launch.roofline import kernel_bound
    from repro_torch.models.ssm import ssm_dims

    record = {}
    for arch, label, decay in (("mamba2-2.7b", "prefill_original", "original"),
                               ("mamba2-2.7b", "prefill_slow", "slow"),
                               (ZAMBA2, "zamba2_prefill", "original")):
        cfg = get_config(arch)
        _, H, _ = ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim,
                           cfg.ssm_groups, cfg.ssm_state)
        B, L, P, N, G = 1, 256, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
        inputs = ssd_inputs(gen, B, L, H, P, N, decay, G, "bfloat16", "bfloat16")
        err = check(label, inputs)
        before = sc.LAUNCHES
        ms = cuda_time_ms(lambda: sc.ssd_chunk(*inputs))
        plain_ms = cuda_time_ms(lambda: ssd_chunk_ref(*inputs))
        sc.LAUNCHES = before  # timing launches are not the main path's
        # each input read once, each output written once; the causal half
        # of the L x L products. B and C are read as the call holds them:
        # one group at head stride 0 is one group's bytes, while
        # repeat_interleave makes a copy per head
        read_groups = 1 if G == 1 else H
        shape = {"B": B, "L": L, "H": H, "P": P, "N": N, "dtype": "bfloat16",
                 "state_dtype": "bfloat16"}
        bound = kernel_bound("ssd_chunk", {**shape, "groups": read_groups},
                             card_name=card_name)
        fp32_ms = kernel_bound("ssd_chunk", {
            "B": B, "L": L, "H": H, "P": P, "N": N, "dtype": "float32"},
            card_name=card_name).ops_s * 1e3
        flops_full = B * H * 2 * ((N + P) * L * L + 2 * L * P * N)
        row = {"phase": "kernels", "kernel": "ssd_chunk", "timing": label,
               "arch": arch, "shape": [B, L, H, P, N], "groups": G,
               "ms": ms, "plain_ms": plain_ms,
               "library_ms": None, "library": "none: no one PyTorch call",
               "bound_ms": bound.bound_s * 1e3, "bound_by": bound.bound_by,
               "bytes": bound.min_bytes, "flops": bound.flops,
               "flops_full_square": flops_full,
               "bytes_ms": bound.bytes_s * 1e3,
               "bf16_tensor_core_ms": bound.ops_s * 1e3,
               "fp32_cuda_core_ms": fp32_ms, "max_abs_err": err}
        if G > 1:
            row["bound_ms_if_b_c_read_per_group"] = kernel_bound(
                "ssd_chunk", {**shape, "groups": G}, card_name=card_name).bound_s * 1e3
        emit(row)
        record[label] = row
    ZAMBA2_SSD_TIMING.update(record["zamba2_prefill"])
    return record["prefill_original"]


# the kernel instantiations the paths run: flash_decode at qwen3-0.6b's
# heads (G=2, D=64), gemma3-4b's global heads (G=2, D=320), granite's
# (G=3, D=64), zamba2's shared block (G=1, D=224) and internvl2's (G=7,
# D=64) in bf16 (serve) and fp32 (parity), and llama4's (G=5, D=128) in
# bf16 (parity_llama4); ssd_chunk at mamba2-2.7b's (P=64, N=128) with bf16
# x/B/C and state (prefill) and in fp32 (prefill_parity), and at zamba2's
# (P=64, N=64) in bf16 (prefill_zamba2)
SMEM_CASES = (
    ("flash_decode", {"G": 2, "D": 64, "dtype": "bfloat16"}),
    ("flash_decode", {"G": 2, "D": 64, "dtype": "float32"}),
    ("flash_decode", {"G": 2, "D": 320, "dtype": "bfloat16"}),
    ("flash_decode", {"G": 2, "D": 320, "dtype": "float32"}),
    ("flash_decode", {"G": 3, "D": 64, "dtype": "bfloat16"}),
    ("flash_decode", {"G": 3, "D": 64, "dtype": "float32"}),
    ("flash_decode", {"G": 5, "D": 128, "dtype": "bfloat16"}),
    ("flash_decode", {"G": 1, "D": 224, "dtype": "bfloat16"}),
    ("flash_decode", {"G": 1, "D": 224, "dtype": "float32"}),
    ("flash_decode", {"G": 7, "D": 64, "dtype": "bfloat16"}),
    ("flash_decode", {"G": 7, "D": 64, "dtype": "float32"}),
    # nemotron's span (rank_of_256): bf16 on the tensor cores
    ("flash_decode", {"G": 12, "D": 192, "dtype": "bfloat16"}),
    ("flash_decode", {"G": 12, "D": 192, "dtype": "float32"}),
    ("ssd_chunk", {"P": 64, "N": 128, "dtype": "bfloat16", "state_dtype": "bfloat16"}),
    ("ssd_chunk", {"P": 64, "N": 128, "dtype": "float32", "state_dtype": "float32"}),
    ("ssd_chunk", {"P": 64, "N": 64, "dtype": "bfloat16", "state_dtype": "bfloat16"}),
    # the backward at mamba2-2.7b's (train_mamba2, bf16: the tensor-core
    # kernel; the fp32 cases of kernels_ssd_bwd and train_mamba2's fp32
    # gradient check: the CUDA-core kernel; a bf16 x with an fp32 state:
    # the tensor-core kernel's fp32 state tile) and zamba2-7b's shapes
    ("ssd_chunk_bwd", {"P": 64, "N": 128, "dtype": "bfloat16",
                       "state_dtype": "bfloat16"}),
    ("ssd_chunk_bwd", {"P": 64, "N": 128, "dtype": "bfloat16", "state_dtype": "float32"}),
    ("ssd_chunk_bwd", {"P": 64, "N": 128, "dtype": "float32", "state_dtype": "float32"}),
    ("ssd_chunk_bwd", {"P": 64, "N": 64, "dtype": "bfloat16", "state_dtype": "bfloat16"}),
)


def phase_smem() -> None:
    """Each instantiation's planned shared memory (one CTA's working set,
    ``kernels/smem_plan.py``) against what the kernel requests at launch
    and the device's opt-in limit: it fits, and the plan is no larger
    than the request (a smaller plan is reuse the kernel does not do)."""
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import smem_plan as sp
    from repro_torch.kernels import ssd_chunk as sc

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for kernel, shape in SMEM_CASES:
        if kernel == "flash_decode":
            kp = sp.plan_flash_decode_smem(**shape)
            requested = fd.smem_request_bytes(shape["G"], shape["D"],
                                              getattr(torch, shape["dtype"]))
        elif kernel == "ssd_chunk":
            kp = sp.plan_ssd_chunk_smem(**shape)
            requested = sc.smem_request_bytes(shape["P"], shape["N"],
                                              getattr(torch, shape["dtype"]),
                                              getattr(torch, shape["state_dtype"]))
        else:
            kp = sp.plan_ssd_chunk_bwd_smem(**shape)
            requested = sc.bwd_smem_request_bytes(shape["P"], shape["N"],
                                                  getattr(torch, shape["dtype"]),
                                                  getattr(torch, shape["state_dtype"]))
        planned = kp.plan.total_size
        row = {"phase": "smem", "kernel": kernel, **shape, "planned_bytes": planned,
               "requested_bytes": requested, "naive_bytes": kp.plan.naive_size,
               "optin_limit_bytes": limit, "model_budget_bytes": kp.budget,
               "fits": kp.fits and requested <= limit,
               "planned_minus_requested": planned - requested}
        if kernel == "flash_decode":
            dt = getattr(torch, shape["dtype"])
            row["path"] = fd.kernel_path(dt, shape["D"], shape["G"])
            row["ctas_per_sm"] = fd.ctas_per_sm(shape["G"], shape["D"], dt)
        if kernel == "ssd_chunk_bwd":
            row["ctas_per_sm"] = sc.bwd_ctas_per_sm(shape["P"], shape["N"],
                                                    getattr(torch, shape["dtype"]),
                                                    getattr(torch, shape["state_dtype"]))
        emit(row)
        if not row["fits"]:
            fail(f"smem: {kernel} {shape} does not fit ({row})")
        if planned > requested:
            fail(f"smem: {kernel} {shape} plans {planned} B, more than the "
                 f"{requested} B it requests: scratch the kernel does not have")
    if limit != sp.SMEM_BYTES:
        fail(f"smem: the card's opt-in limit is {limit} B, the model's {sp.SMEM_BYTES} B")


def phase_parity() -> None:
    """A full-width 2-layer fp32 qwen3 served three ways from one seed: the
    captured, arena-backed step with the kernel attention, the same with
    the plain attention, and, beside the first, the model's eager
    ``decode_step`` fed the same inputs at every step (admission steps
    included) on caches of its own. Logits of the captured step equal
    the eager step's (bit for bit expected, else within 1e-6) and the
    plain attention's within 1e-4; greedy tokens and slot logs are
    identical."""
    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_periods=2,
                              dtype="float32")
    requests = list(zip((3, 5, 8, 2, 6, 4), (6, 9, 4, 7, 5, 8)))
    run_parity("parity", cfg, requests, n_slots=4, max_len=128)


def gemma3_two_layers():
    """Full-width gemma3-4b cut to two layers, fp32: the first of its
    window layers (a ring of 1024) and its global layer, the two kinds of
    cache its period holds (the period's other four window layers are
    this one's twins)."""
    from repro_torch.configs.base import get_config

    cfg = get_config("gemma3-4b")
    return dataclasses.replace(cfg, n_periods=1, remainder=(), dtype="float32",
                               period=(cfg.period[0], cfg.period[-1]))


def phase_parity_gemma3() -> None:
    """gemma3-4b at full width, its depth cut to two layers
    (``gemma3_two_layers``: a window layer of 1024 and the global layer),
    fp32, 2 slots: one request of a
    1,090-token prompt and 16 new tokens, so every ring wraps, and two
    short ones, so a slot is reused. The same three ways as ``parity``.
    fp32, as qwen3's parity: in bf16 the plain attention rounds its scores
    to bf16 (the reference's cast point) where the kernel keeps fp32, so
    greedy tokens would test rounding, not the kernel; the bf16 kernel is
    held in the kernels phase and served in serve_gemma3."""
    run_parity("parity_gemma3", gemma3_two_layers(), [(1090, 16), (37, 20), (5, 12)],
               n_slots=2, max_len=1280)


def run_parity(phase: str, cfg, requests, *, n_slots: int, max_len: int,
               cores=("kernel", "plain")) -> dict:
    """Serve ``requests`` ((prompt length, new tokens) each) on ``cfg``
    with an engine per core of ``cores`` (the kernel core first), hold
    every captured step of the kernel-core engine against the eager
    ``decode_step``, and, with the plain core too, hold the two engines'
    logits, greedy tokens and slot logs together. Each engine's state is
    its plan, and each of its graphs holds one ``flash_decode`` launch
    per attention layer (ring or global) and shared-block insertion on
    the kernel core, none on the plain one. The row's ``launches`` are the engines' own (the warm-up run of
    each capture and the replays): the eager twin's launches are a
    check, counted apart in ``captured_vs_eager``. Returns the row."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.api import DecoderModel
    from repro_torch.runtime.engine import InferenceEngine

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = DecoderModel(cfg, DEVICE).init(gen)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    param_bytes = sum(t.numel() * t.element_size()
                      for t in torch.utils._pytree.tree_leaves(params))
    reset_launches()
    engines = {
        a: InferenceEngine(cfg, params, n_slots=n_slots, max_len=max_len,
                           device=DEVICE, cores=a)
        for a in cores
    }
    ek, ep = engines["kernel"], engines.get("plain")
    # the eager twin of the kernel engine
    eager = ek.model.init_cache(n_slots, max_len)
    twin = {"steps": 0, "bitwise": 0, "max_abs_diff": 0.0, "launches": 0}
    step_tokens, reset = ek._step_tokens, ek.state.reset

    def dev(a):
        return torch.from_numpy(np.array(a)).to(DEVICE)

    def checked_step(tokens, pos, active):
        got = step_tokens(tokens, pos, active)
        before = fd.LAUNCHES
        with torch.no_grad():
            want, _ = ek.model.decode_step(params, dev(tokens), eager, dev(pos),
                                           dev(active))
        # the twin's launches are the check's, not the path's
        twin["launches"] += fd.LAUNCHES - before
        fd.LAUNCHES = before
        diff = float((got - want).abs().max())
        twin["steps"] += 1
        twin["bitwise"] += int(torch.equal(got, want))
        twin["max_abs_diff"] = max(twin["max_abs_diff"], diff)
        if not bool(((got - want).abs() <= 1e-6 + 1e-6 * want.abs()).all()):
            fail(f"{phase}: captured step differs from the eager step by {diff}")
        return got

    def checked_reset(keep):
        reset(keep)
        ek.model.reset_slots(eager, dev(keep))

    ek._step_tokens, ek.state.reset = checked_step, checked_reset
    rng = np.random.default_rng(0)
    for n, new in requests:
        prompt = rng.integers(0, cfg.vocab, size=n).astype(np.int32)
        for e in engines.values():
            e.submit(prompt, max_new_tokens=new)
    worst = 0.0
    done = {a: {} for a in cores}
    while any(e.unfinished_requests() for e in engines.values()):
        for a, e in engines.items():
            done[a].update({r.request_id: r.tokens for r in e.step()})
        if ep is None or ek.last_logits is None or ep.last_logits is None:
            continue
        diff = np.abs(ek.last_logits - ep.last_logits)
        worst = max(worst, float(diff.max()))
        if not np.all(diff <= 1e-4 + 1e-4 * np.abs(ep.last_logits)):
            fail(f"{phase}: logits differ by {float(diff.max())} at wave {ek.waves}")
    if len(done["kernel"]) != len(requests) or any(
            len(done["kernel"][i]) != new for i, (_, new) in enumerate(requests)):
        fail(f"{phase}: {len(done['kernel'])} of {len(requests)} requests finished")
    if ep is not None:
        if done["kernel"] != done["plain"]:
            fail(f"{phase}: greedy tokens differ {done['kernel']} vs {done['plain']}")
        if ek.slot_log != ep.slot_log:
            fail(f"{phase}: slot logs differ {ek.slot_log} vs {ep.slot_log}")
    for leaf, want in zip(torch.utils._pytree.tree_leaves(ek.caches),
                          torch.utils._pytree.tree_leaves(eager)):
        if not torch.equal(leaf, want) and \
                float((leaf - want).abs().max()) > 1e-6 * (1 + float(want.abs().max())):
            fail(f"{phase}: the state differs from the eager twin's caches")
    if twin["steps"] != ek.decode_calls or ek.state.graphs["step"].replays != ek.decode_calls:
        fail(f"{phase}: {twin['steps']} checked steps, {ek.decode_calls} decode steps")
    launches = read_launches()
    n_global = flash_decode_per_step(cfg)
    per_replay, warmups, replayed = {}, 0, 0
    for a, e in engines.items():
        rep = e.memory_report
        if rep.state_live_bytes != rep.state_planned_bytes:
            fail(f"{phase}: {a} core's live state {rep.state_live_bytes} B, planned "
                 f"{rep.state_planned_bytes} B")
        want = n_global if a == "kernel" else 0
        for name, graph in e.state.graphs.items():
            per_replay[f"{a}/{name}"] = graph.launches["flash_decode"]
            if graph.launches["flash_decode"] != want:
                fail(f"{phase}: the {a} core's {name} graph holds {graph.launches} "
                     f"launches per replay, expected {want} flash_decode")
            warmups += want
            replayed += want * graph.replays
    if launches["flash_decode"] != replayed + warmups or fd.LAUNCHES != warmups:
        fail(f"{phase}: {launches} launches by the engines, expected {replayed} "
             f"replayed + {warmups} in the warm-up runs")
    row = {"phase": phase, "arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "cores": list(cores), "waves": ek.waves, "decode_steps": ek.decode_calls,
           "init_peak_allocated_gib": init_peak / 2**30, "param_bytes": param_bytes,
           "state_bytes": ek.memory_report.state_live_bytes,
           "launches": launches, "flash_decode_per_replay": per_replay,
           "flash_decode_warm_up": warmups,
           "captured_vs_eager": twin, "slot_log": ek.slot_log}
    if ep is not None:
        row["kernel_vs_plain_logits_max_abs_diff"] = worst
    windows = {spec.window for spec in cfg.period if spec.window}
    if windows:
        reached = [n + len(done["kernel"][i]) for i, (n, _) in enumerate(requests)]
        if max(reached) <= max(windows):
            fail(f"{phase}: no ring wrapped (positions {reached}, windows {windows})")
        row.update({"positions_reached": reached, "windows": sorted(windows)})
    row.update({"requests": [list(r) for r in requests],
                "first_tokens": {k: v[:6] for k, v in done["kernel"].items()}})
    row["ok"] = True
    emit(row)
    del engines, ek, ep, eager, params
    torch.cuda.empty_cache()
    return row


def reset_launches() -> None:
    from repro_torch.runtime import graphs

    graphs.reset_kernel_launches()


def read_launches() -> dict:
    """Every launch of each kernel since the reset: by its wrapper, plus
    the launches each replayed graph holds, once per replay."""
    from repro_torch.runtime import graphs

    return graphs.kernel_launches()


def wrapper_launches() -> dict:
    """The launches the wrappers made themselves: while an engine is
    built and serves, only the warm-up run before each capture."""
    from repro_torch.runtime import graphs

    return graphs.wrapper_launches()


def check_replayed(phase: str, stats: dict, kernel: str | None,
                   per_step: int | None = None) -> dict:
    """Every decode step of a serve run (counts reset before the engine
    was built) was a replay: the graphs' replays add up to the decode
    steps, nothing was captured while serving, the arena stayed put, and
    ``kernel`` ran ``per_step`` times per step (default: once per layer;
    gemma3: once per global layer), by replays, with the wrapper
    launching it only in the warm-up run of each capture. Returns the
    per-graph accounting."""
    graphs = stats["graphs"]
    replays = sum(g["replays"] for g in graphs.values())
    if replays != stats["decode_calls"]:
        fail(f"{phase}: {replays} graph replays for {stats['decode_calls']} "
             f"decode steps")
    if stats["capture_calls_while_serving"]:
        fail(f"{phase}: {stats['capture_calls_while_serving']} captures while serving")
    if stats["arena_ptr_before"] != stats["arena_ptr_after"]:
        fail(f"{phase}: the activation arena moved")
    per_step = stats["n_layers"] if per_step is None else per_step
    warmups = len(graphs)
    eager = wrapper_launches()
    want_eager = {k: (per_step * warmups if k == kernel else 0) for k in eager}
    if eager != want_eager:
        fail(f"{phase}: the wrappers launched {eager}, expected {want_eager} "
             f"(the warm-up run of each of the {warmups} captures)")
    if kernel is not None:
        held = {k: g["launches"][kernel] for k, g in graphs.items()}
        replayed = sum(held[k] * g["replays"] for k, g in graphs.items())
        if set(held.values()) != {per_step}:
            fail(f"{phase}: captured {kernel} launches per graph {held}, expected "
                 f"{per_step} per step")
        if replayed != stats["decode_calls"] * per_step or \
                read_launches()[kernel] != replayed + eager[kernel]:
            fail(f"{phase}: {replayed} replayed {kernel} launches, expected "
                 f"{stats['decode_calls']} decode steps x {per_step}")
    return {k: {"captured_launches": g["launches"], "replays": g["replays"]}
            for k, g in graphs.items()}


def graph_stats(stats: dict) -> dict:
    mib = 2**20
    return {
        "capture_calls": stats["capture_calls"],
        "capture_s": stats["capture_s"],
        "graph_pool_mib": stats["graph_pool_bytes"] / mib,
        "graph_capture_peak_mib": stats["graph_capture_peak_bytes"] / mib,
        "planned_activation_mib": stats["plan_total_bytes"] / mib,
        "allocator_replay_peak_mib": stats["allocator_step_peak_bytes"] / mib,
        "executor_in_place": stats["executor_in_place"],
        "executor_copied": stats["executor_copied"],
        "executor_copied_bytes": stats["executor_copied_bytes"],
    }


# the plans certified this run (the plan rows)
CERTIFIED: list[str] = []


def plan_row(label: str, stats: dict, warnings: tuple[str, ...] = ()) -> None:
    """A serve run's engine was built with the startup lint on: its
    unified plan (activation and state) was certified before it captured
    or served (an error would have raised in the engine). Its findings
    are exactly the ``warnings`` expected (codes), none by default."""
    if stats["startup_lint_findings"] is None:
        fail(f"plan: the {label} engine ran without its startup lint")
    found = sorted(stats["startup_lint_warnings"])
    if stats["startup_lint_findings"] != len(found) or found != sorted(warnings):
        fail(f"plan: {stats['startup_lint_findings']} findings on the {label} plan "
             f"(warnings {found}, expected {sorted(warnings)})")
    emit({"phase": "plan", "plan": label, "records": stats["plan_records"],
          "state_leaves": stats["state_leaves"],
          "certify_s": stats["startup_lint_s"],
          "findings": stats["startup_lint_findings"], "warnings": found, "ok": True})
    CERTIFIED.append(label)


def decode_roofline(label: str, engine, prof: dict, card_name: str,
                    extra: dict | None = None) -> dict:
    """The roofline of the profiled decode waves of ``engine``: each wave's
    FLOPs and least bytes at the positions it read (every slot active; a
    ring read up to its window), averaged over the waves, against the
    device time per wave measured."""
    import statistics as st

    import torch

    from repro_torch.core.unified import detect_state_axes
    from repro_torch.launch import roofline
    from repro_torch.models.api import ShapeSpec

    n, T = engine.n_slots, engine.max_len

    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    # the step's inputs besides the params and the caches
    inputs = (engine.model.rope_tables, meta((n, 1), torch.int32),
              meta((n,), torch.int32), meta((n,), torch.bool))
    axes = detect_state_axes(engine.model.init_cache, n_slots=n, max_len=T)

    rings = roofline.ring_windows(engine.cfg, engine.caches)

    def count(lengths):
        return roofline.step_count(engine.executor.trace, engine.params, inputs,
                                   state=engine.caches, axes=axes, lengths=lengths,
                                   rings=rings)

    first = prof["positions_first"]
    counts = [count([min(p + i + 1, T) for p in first]) for i in range(prof["waves"])]
    bounds = [c.bound(card_name) for c in counts]
    full = count(None)
    bound_ms = st.mean(b.bound_s for b in bounds) * 1e3
    device_ms = prof["device_ms_per_wave"]
    model_flops = roofline.model_flops(engine.cfg, ShapeSpec("decode", T, n, "decode"))
    row = {"phase": "roofline", "path": label, "waves": prof["waves"],
           "positions_read": [min(first) + 1, max(first) + prof["waves"]],
           "flops": st.mean(c.flops for c in counts),
           "min_bytes": st.mean(c.min_bytes for c in counts),
           "param_bytes": counts[0].param_bytes,
           "state_read_bytes": st.mean(c.state_read_bytes for c in counts),
           "state_write_bytes": counts[0].state_write_bytes,
           "output_bytes": counts[0].output_bytes,
           "bound_ms": bound_ms,
           "bound_by": sorted({b.bound_by for b in bounds}),
           "bound_ms_all_positions": full.bound(card_name).bound_s * 1e3,
           "min_bytes_all_positions": full.min_bytes,
           "device_ms": device_ms, "roofline_share": bound_ms / device_ms,
           "model_flops": model_flops,
           "mfu": roofline.mfu(model_flops, device_ms / 1e3, card_name),
           **(extra or {})}
    reread = roofline.shared_reread_bytes(engine.cfg, engine.params)
    if reread:
        # a second floor: the shared block read again at each of its other
        # insertions (it does not stay in L2 between them); the share is
        # read against the first, each parameter once (step_count)
        spec = roofline.card(card_name)
        again = roofline.Bound(round(row["flops"]), round(row["min_bytes"]) + reread,
                               spec.peak_flops, spec.hbm_bytes_per_s)
        row.update({"shared_insertions": roofline.shared_insertions(engine.cfg),
                    "shared_reread_bytes": reread,
                    "min_bytes_shared_at_every_insertion": again.min_bytes,
                    "bound_ms_shared_at_every_insertion": again.bound_s * 1e3,
                    "roofline_share_shared_at_every_insertion":
                        again.bound_s * 1e3 / device_ms,
                    "share_read_against": "bound_ms: each parameter read once"})
    emit(row)
    return row


# the serve phases' run: full-width qwen3-0.6b, 8 slots x 2048 positions,
# 8 requests of 32 prompt + 64 new tokens
SERVE_ARGS = [
    "--full", "--arch", "qwen3-0.6b", "--slots", "8", "--max-len", "2048",
    "--requests", "8", "--prompt-len", "32", "--max-new", "64", "--seed", "0",
]


def phase_serve() -> tuple[dict, object]:
    from repro_torch.launch import serve

    n_req, prompt_len, max_new = 8, 32, 64
    reset_launches()
    stats = serve.run(SERVE_ARGS)
    counts = read_launches()
    launches = counts["flash_decode"]
    toks = stats["tokens_per_request"]
    if stats["requests"] != n_req or any(len(t) != max_new for t in toks.values()):
        fail(f"serve: {stats['requests']} of {n_req} requests finished, "
             f"lengths {[len(t) for t in toks.values()]}")
    if not all(0 <= x < 151936 for t in toks.values() for x in t):
        fail("serve: a token outside the vocabulary")
    if not stats["last_logits_finite"]:
        fail("serve: non-finite logits")
    if stats["state_live_bytes"] != stats["state_planned_bytes"]:
        fail(f"serve: live state {stats['state_live_bytes']} B != planned "
             f"{stats['state_planned_bytes']} B")
    if stats["state_ptr_before"] != stats["state_ptr_after"]:
        fail("serve: the state buffer moved")
    replayed = check_replayed("serve", stats, "flash_decode")
    if stats["capture_calls"] != 1:
        fail(f"serve: {stats['capture_calls']} graphs captured, expected 1")
    plan_row("qwen3-0.6b serve (8 slots x 2048)", stats)
    emit({
        "phase": "serve", "arch": "qwen3-0.6b", "layers": stats["n_layers"],
        "requests": stats["requests"], "tokens": stats["tokens"],
        "waves": stats["waves"], "decode_steps": stats["decode_calls"],
        "host_syncs": stats["host_syncs"],
        "wall_s": stats["wall_s"], "tokens_per_s": stats["tokens_per_s"],
        "cold_start_s": stats["cold_start_s"],
        "launches": counts, "graphs": replayed, **graph_stats(stats),
        "activation_lower_bound_mib": stats["plan_lower_bound_bytes"] / 2**20,
        "activation_naive_mib": stats["plan_naive_bytes"] / 2**20,
        "state_mib": stats["state_live_bytes"] / 2**20,
        "decode_step_ops": stats["decode_step_ops"],
        "first_tokens": {k: v[:4] for k, v in list(toks.items())[:2]},
        "ok": True,
    })
    SERVE_NUMBERS.update(tokens=toks, tokens_per_s=stats["tokens_per_s"],
                         launches=launches, cold_start_s=stats["cold_start_s"],
                         state_plan_s=stats["state_plan_s"],
                         capture_calls=stats["capture_calls"],
                         serve_peak_bytes=stats["serve_peak_bytes"],
                         unified_bytes=stats["plan_total_bytes"]
                         + stats["state_planned_bytes"])
    return {"launches": launches, "tokens": toks}, stats["engine"]


def phase_serve_block(host_tokens: dict | None, card_name: str) -> dict:
    """The serve phase's 8 requests at ``--block-size 8``: the host loop's
    tokens, one host sync per block, every wave a replay of the captured
    wave graph; then the same requests again under the decode lint (no
    findings), then a steady window of full blocks, timed and profiled."""
    import numpy as np
    import torch

    from repro_torch.analysis import decode_lint
    from repro_torch.launch import serve

    reset_launches()
    stats = serve.run(SERVE_ARGS + ["--block-size", "8"])
    counts = read_launches()
    toks = stats["tokens_per_request"]
    if host_tokens is not None and toks != host_tokens:
        fail("serve_block: the block tokens differ from the host loop's")
    if stats["host_syncs"] != stats["blocks"]:
        fail(f"serve_block: {stats['host_syncs']} host syncs for {stats['blocks']} blocks")
    if stats["capture_calls"] != 2:
        fail(f"serve_block: {stats['capture_calls']} graphs captured, expected 2")
    if stats["state_ptr_before"] != stats["state_ptr_after"]:
        fail("serve_block: the state buffer moved")
    replayed = check_replayed("serve_block", stats, "flash_decode")
    plan_row("qwen3-0.6b serve_block (8 slots x 2048, blocks of 8)", stats)
    engine = stats["engine"]
    cfg = engine.cfg
    rng = np.random.default_rng(0)  # serve.run's prompts
    for _ in range(8):
        engine.submit(rng.integers(0, cfg.vocab, size=32).astype(np.int32),
                      max_new_tokens=64)
    again = {}

    def run():
        again.update({r.request_id - 8: r.tokens for r in engine.run_until_done()})

    findings = decode_lint.lint_run(engine, run)
    if findings:
        fail(f"serve_block: decode lint findings {[f.render() for f in findings]}")
    if again != toks:
        fail("serve_block: the linted run served other tokens")
    # a steady window: 8 slots decoding full blocks of 8 waves
    blocks, n_req = 8, 8
    for _ in range(n_req):
        engine.submit(rng.integers(0, cfg.vocab, size=4).astype(np.int32),
                      max_new_tokens=8 * (2 * blocks + 2))
    engine.step_block()  # admits every request
    prof, _ = serve.profile_waves(engine, blocks, blocks_of_waves=True)
    roof = decode_roofline("qwen3-0.6b steady block wave", engine, prof, card_name)
    engine.run_until_done()
    emit({
        "phase": "serve_block", "arch": cfg.name, "layers": stats["n_layers"],
        "block_size": stats["block_size"], "requests": stats["requests"],
        "tokens": stats["tokens"], "waves": stats["waves"],
        "decode_steps": stats["decode_calls"], "blocks": stats["blocks"],
        "host_syncs": stats["host_syncs"], "wall_s": stats["wall_s"],
        "tokens_per_s": stats["tokens_per_s"], "cold_start_s": stats["cold_start_s"],
        "launches": counts, "graphs": replayed, **graph_stats(stats),
        "tokens_equal_host_loop": host_tokens is not None,
        "decode_lint_findings": 0, "steady": prof, "ok": True,
    })
    del engine, stats
    torch.cuda.empty_cache()
    return roof


def phase_profile(engine, card_name: str) -> dict:
    """Where a steady wave's time goes, on the served engine: 8 requests
    more, then 8 waves timed by the host clock and 8 more under
    torch.profiler (every slot active in both)."""
    prof = steady_profile("profile", engine)
    emit({"phase": "profile", "decode_step_ops": len(engine.decode_graph.ops),
          "replays": engine.state.graphs["step"].replays, **prof, "ok": True})
    SERVE_NUMBERS.update(device_ms_per_wave=prof["device_ms_per_wave"])
    return decode_roofline("qwen3-0.6b steady host-loop wave", engine, prof, card_name)


def _mamba_model(n_periods: int | None, dtype: str, seed: int):
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models.api import DecoderModel

    cfg = get_config("mamba2-2.7b")
    if n_periods is not None:
        cfg = dataclasses.replace(cfg, n_periods=n_periods, dtype=dtype)
    model = DecoderModel(cfg, DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(seed))
    return cfg, model, params


def slow_decay(params) -> None:
    """A = -exp(A_log) in [-0.02, -0.001] on every Mamba2 layer, in place:
    dt·A per position as in the slow-decay kernel cases, so the state one
    chunk hands the next is far above the bars (at random init A is in
    [-16, -1] and the state forgets within a token or two)."""
    import torch

    for layer in params["period"]:
        a_log = layer["mamba"]["A_log"]
        a_log.copy_(torch.log(torch.linspace(0.001, 0.02, a_log.shape[-1],
                                             device=a_log.device)))


def _err_over_bar(got, want, atol: float, rtol: float) -> float:
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def phase_prefill_parity() -> None:
    """Full width, 2 layers, fp32 (matmuls in full fp32), at the random
    init's decay and at a slow one: the kernel SSD core against the plain
    one on one set of weights over 3 chunks, then the port's prefill +
    decode against its forward. With the slow decay, a control: the
    plain core with the incoming state of every chunk dropped must miss
    the final state by more than 100x the bar."""
    import torch

    from repro_torch.models import ssm
    from repro_torch.models.api import DecoderModel

    torch.backends.cuda.matmul.allow_tf32 = False
    S, n = 600, 596  # 3 chunks of 256, the last padded
    atol = rtol = 1e-4
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    for decay in ("original", "slow"):
        cfg, model, params = _mamba_model(2, "float32", 0)
        if decay == "slow":
            slow_decay(params)
        plain = DecoderModel(cfg, DEVICE, cores="plain")
        tokens = torch.randint(0, cfg.vocab, (1, S), generator=gen, device=DEVICE)
        with torch.no_grad():
            before = read_launches()["ssd_chunk"]
            got_logits, got_caches = model.prefill(params, {"tokens": tokens})
            launches = read_launches()["ssd_chunk"] - before
            want_logits, want_caches = plain.prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            if launches != 3 * cfg.n_layers:
                fail(f"prefill_parity: {launches} ssd_chunk launches, expected "
                     f"{3 * cfg.n_layers}")
            want_state = want_caches["period"][0]["mamba"][1]
            state_max = float(want_state.abs().max())
            diffs = {}
            for name, g, w in (
                ("last_logits", got_logits, want_logits),
                ("conv_state", got_caches["period"][0]["mamba"][0],
                 want_caches["period"][0]["mamba"][0]),
                ("ssm_state", got_caches["period"][0]["mamba"][1], want_state),
            ):
                err = (g - w).abs()
                diffs[name] = float(err.max())
                if not bool((err <= atol + rtol * w.abs()).all()):
                    fail(f"prefill_parity ({decay}): {name} differs by "
                         f"{float(err.max())}")
            control = None
            if decay == "slow":
                if state_max <= 1e3 * atol:
                    fail(f"prefill_parity: the slow-decay state ({state_max}) "
                         f"is not far above the bar")
                core = ssm.SSD["plain"]
                ssm.SSD["plain"] = lambda x, dt, dA, Bm, Cm, state: core(
                    x, dt, dA, Bm, Cm, torch.zeros_like(state))
                try:
                    _, forgot = plain.prefill(params, {"tokens": tokens})
                finally:
                    ssm.SSD["plain"] = core
                control = _err_over_bar(forgot["period"][0]["mamba"][1],
                                        want_state, atol, rtol)
                if control <= 100:
                    fail(f"prefill_parity: dropping the carried state moves the "
                         f"final state by only {control}x the bar")
            full, _ = model.forward(params, {"tokens": tokens})
            last, caches = model.prefill(params, {"tokens": tokens[:, :n]})
            steps = [(last, full[:, n - 1])]
            for i in range(n, S):
                logits, caches = model.decode_step(
                    params, tokens[:, i : i + 1], caches,
                    torch.full((1,), i, dtype=torch.int32, device=DEVICE))
                steps.append((logits, full[:, i]))
            worst = 0.0
            for i, (g, w) in enumerate(steps):
                err = (g - w).abs()
                worst = max(worst, float(err.max()))
                if not bool((err <= 2e-4 + 2e-4 * w.abs()).all()):
                    fail(f"prefill_parity ({decay}): cached step {i} differs from "
                         f"forward by {float(err.max())}")
        emit({"phase": "prefill_parity", "decay": decay, "layers": cfg.n_layers,
              "tokens": S, "ssd_chunk_launches": launches,
              "kernel_vs_plain_max_abs_diff": diffs, "ssm_state_max_abs": state_max,
              "dropped_state_err_over_bar": control,
              "prefill_decode_vs_forward_max_abs_diff": worst, "ok": True})
        del params, model, plain
        torch.cuda.empty_cache()


def phase_prefill(card_name: str) -> tuple[dict, dict]:
    """Full-width mamba2-2.7b (64 layers, bf16): one 2048-token request
    through ``ArenaExecutor`` (every intermediate at its planned offset in
    one arena, each ssd_chunk result copied into its slot), against the
    eager ``Model.prefill`` on the same weights and tokens."""
    cfg, model, params = _mamba_model(None, "bfloat16", 0)
    return run_prefill(card_name, cfg, model, params, "ssd_chunk")


def phase_prefill_gemma3(card_name: str) -> tuple[dict, dict]:
    """Full-width gemma3-4b (34 layers, bf16, random weights from a seed):
    one 2048-token request through ``ArenaExecutor`` from its certified
    plan, against the eager prefill: four 512-query chunks per global
    layer, 1,536-key slices per query chunk on the window layers, whose
    caches are the rings of the last 1024 positions. Attention prefill
    has no kernel (the reference's is plain XLA attention), so no kernel
    launches."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models.api import DecoderModel

    cfg = get_config("gemma3-4b")
    model = DecoderModel(cfg, DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    return run_prefill(card_name, cfg, model, params, None)


def run_prefill(card_name: str, cfg, model, params, kernel: str | None
                ) -> tuple[dict, dict]:
    """One 2048-token prefill of ``model`` through ``ArenaExecutor`` from
    a certified plan, against the eager prefill; ``kernel`` is the kernel
    it launches once per chunk per layer (None: no kernel at all)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.analysis import soundness
    from repro_torch.launch import roofline
    from repro_torch.launch.compile import plan_prefill, prefill_batch
    from repro_torch.models.api import ShapeSpec
    from repro_torch.runtime.executor import ArenaExecutor

    S = 2048
    mib = 2**20
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    # S positions: a VLM's seeded prefix embeddings, then tokens
    batch = prefill_batch(cfg, S, DEVICE)
    batch["tokens"].random_(0, cfg.vocab, generator=gen)
    if "prefix_embeds" in batch:
        batch["prefix_embeds"].normal_(generator=gen)
    tables = model.rope_tables
    t0 = time.perf_counter()
    _, meta_plan = plan_prefill(cfg, prefill_len=S)
    plan_s = time.perf_counter() - t0

    def prefill(p, tabs, b):
        return model.prefill(p, b, **tabs)

    t0 = time.perf_counter()
    executor = ArenaExecutor(prefill, params, tables, batch, device=DEVICE,
                             name=f"{cfg.name}-prefill{S}")
    executor_s = time.perf_counter() - t0
    # the plan the executor runs from, certified (plan_prefill certified
    # the meta trace's plan of the same records)
    t0 = time.perf_counter()
    findings = soundness.certify_plan(executor.plan)
    certify_s = time.perf_counter() - t0
    if findings:
        fail(f"plan: the prefill plan has findings {[f.render() for f in findings]}")
    emit({"phase": "plan", "plan": f"{cfg.name} prefill {S}",
          "records": len(executor.plan.records), "certify_s": certify_s,
          "findings": 0, "ok": True})
    CERTIFIED.append(f"{cfg.name} prefill {S}")
    arena_ptr = executor.arena.buf.data_ptr()
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # the arena included
        reset_launches()
        t0 = time.perf_counter()
        logits, caches = executor(params, tables, batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read_launches()
        peak_above_arena = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        want_logits, want_caches = model.prefill(params, batch)
        torch.cuda.synchronize()
        eager_peak = torch.cuda.max_memory_allocated() - base
        diffs, bitwise = {}, True
        for name, g, w in [("logits", logits, want_logits)] + [
                (f"cache{i}", g, w) for i, (g, w) in enumerate(zip(
                    torch.utils._pytree.tree_leaves(caches),
                    torch.utils._pytree.tree_leaves(want_caches)))]:
            bitwise = bitwise and torch.equal(g, w)
            diffs[name] = float((g.float() - w.float()).abs().max())
            if not bool(((g.float() - w.float()).abs()
                         <= 1e-6 + 1e-6 * w.float().abs()).all()):
                fail(f"prefill: the arena-backed {name} of {cfg.name} differs from "
                     f"eager by {diffs[name]}")
        finite = bool(torch.isfinite(logits.float()).all())
        cache_lens = sorted({int(x.shape[-3]) for x in
                             torch.utils._pytree.tree_leaves(caches) if x.dim() >= 4})
        del logits, caches, want_logits, want_caches
        t0 = time.perf_counter()
        executor(params, tables, batch)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model.prefill(params, batch)
        torch.cuda.synchronize()
        eager_warm_s = time.perf_counter() - t0
        # one prefill with the tracer on but discarded, then the one read:
        # a single traced run once missed a kernel's record on an H100
        # (511 of the 512 ssd_chunk launches)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                executor(params, tables, batch)
                torch.cuda.synchronize()
                prof.step()
    # the schedule's step annotation (ProfilerStep#) also lies on the
    # device timeline, across the whole step: it is no kernel
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
    device_us = sum(e.self_device_time_total for e in kernels)
    n_chunks = -(-S // 256)
    if kernel is None:
        if any(counts.values()):
            fail(f"prefill: {cfg.name} launched kernels {counts}, expected none")
    else:
        kernel_us = sum(e.self_device_time_total for e in kernels if kernel in e.key)
        kernel_count = sum(e.count for e in kernels if kernel in e.key)
        if counts[kernel] != n_chunks * cfg.n_layers:
            fail(f"prefill: {counts[kernel]} {kernel} launches, expected "
                 f"{n_chunks} chunks x {cfg.n_layers} layers")
        if kernel_count != n_chunks * cfg.n_layers or kernel_us <= 0:
            fail(f"prefill: the profiler saw {kernel_count} {kernel} kernels")
    if not finite:
        fail("prefill: non-finite logits")
    if device_us <= 0:
        fail("prefill: the profiler saw no device time")
    if executor.arena.buf.data_ptr() != arena_ptr:
        fail("prefill: the arena moved")
    if executor.plan.total_size != meta_plan.total_size:
        fail(f"prefill: the executor planned {executor.plan.total_size} B, the "
             f"meta trace {meta_plan.total_size} B")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    st = executor.stats
    row = {"phase": "prefill", "arch": cfg.name, "layers": cfg.n_layers,
           "tokens": S, "prefix_embeddings": cfg.n_prefix_tokens,
           "launches": counts, "first_wall_s": first_s,
           "warm_wall_s": warm_s, "tokens_per_s_warm": S / warm_s,
           "eager_warm_wall_s": eager_warm_s,
           "device_ms": device_us / 1e3}
    if kernel is not None:
        row.update({f"{kernel}_device_ms": kernel_us / 1e3,
                    f"{kernel}_us_per_launch": kernel_us / kernel_count})
    row.update({
           "device_kernel_launches": sum(e.count for e in kernels),
           "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                              for e in top},
           "traced_ops": len(executor.graph.ops), "plan_s": plan_s,
           "executor_build_s": executor_s,
           "planned_activation_mib": executor.plan.total_size / mib,
           "activation_lower_bound_mib": executor.plan.lower_bound / mib,
           "activation_naive_mib": executor.plan.naive_size / mib,
           "arena_mib": executor.arena.nbytes / mib,
           "allocator_peak_above_arena_mib": peak_above_arena / mib,
           "eager_allocator_peak_mib": eager_peak / mib,
           "executor_in_place": st.n_in_place, "executor_copied": st.n_copied,
           "executor_boundary": st.n_boundary,
           "executor_copied_mib_per_call": st.copied_bytes / mib,
           "cache_lengths": cache_lens,
           "equal_to_eager_bitwise": bitwise, "max_abs_diff_vs_eager": diffs,
           "ok": True})
    emit(row)
    count = roofline.step_count(executor.trace, params, (tables, batch))
    bound = count.bound(card_name)
    device_ms = device_us / 1e3
    model_flops = roofline.model_flops(cfg, ShapeSpec("prefill", S, 1, "prefill"))
    roof = {"phase": "roofline", "path": f"{cfg.name} prefill {S}",
            "flops": count.flops, "flops_by_op": count.flops_by_op,
            "min_bytes": count.min_bytes, "param_bytes": count.param_bytes,
            "output_bytes": count.output_bytes, "bound_ms": bound.bound_s * 1e3,
            "bound_by": bound.bound_by, "device_ms": device_ms,
            "roofline_share": bound.bound_s * 1e3 / device_ms,
            "model_flops": model_flops,
            "mfu": roofline.mfu(model_flops, device_ms / 1e3, card_name)}
    emit(roof)
    del params, model, executor
    torch.cuda.empty_cache()
    return row, roof


def phase_serve_mamba() -> None:
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models.ssm import ssm_dims

    cfg = get_config("mamba2-2.7b")
    n_req, prompt_len, max_new, slots = 8, 32, 64, 8
    reset_launches()
    stats = serve.run([
        "--full", "--arch", cfg.name, "--slots", str(slots), "--max-len", "2048",
        "--requests", str(n_req), "--prompt-len", str(prompt_len),
        "--max-new", str(max_new), "--seed", "0",
    ])
    counts = read_launches()
    toks = stats["tokens_per_request"]
    if stats["requests"] != n_req or any(len(t) != max_new for t in toks.values()):
        fail(f"serve_mamba: {stats['requests']} of {n_req} requests finished")
    if not all(0 <= x < cfg.vocab for t in toks.values() for x in t):
        fail("serve_mamba: a token outside the vocabulary")
    if not stats["last_logits_finite"]:
        fail("serve_mamba: non-finite logits")
    if stats["state_live_bytes"] != stats["state_planned_bytes"]:
        fail(f"serve_mamba: live state {stats['state_live_bytes']} B != planned "
             f"{stats['state_planned_bytes']} B")
    if stats["state_ptr_before"] != stats["state_ptr_after"]:
        fail("serve_mamba: the state buffer moved")
    replayed = check_replayed("serve_mamba", stats, None)
    plan_row("mamba2-2.7b serve (8 slots x 2048)", stats)
    _, H, conv_dim = ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim,
                              cfg.ssm_groups, cfg.ssm_state)
    itemsize = getattr(torch, cfg.dtype).itemsize
    raw = cfg.n_layers * ((cfg.ssm_conv - 1) * conv_dim
                          + H * cfg.ssm_head_dim * cfg.ssm_state) * itemsize * slots
    if not raw <= stats["state_planned_bytes"] < raw * 1.01:
        fail(f"serve_mamba: planned state {stats['state_planned_bytes']} B is "
             f"not the {raw} B of the leaves plus alignment")
    emit({
        "phase": "serve_mamba", "arch": cfg.name, "layers": stats["n_layers"],
        "requests": stats["requests"], "tokens": stats["tokens"],
        "waves": stats["waves"], "decode_steps": stats["decode_calls"],
        "wall_s": stats["wall_s"], "tokens_per_s": stats["tokens_per_s"],
        "cold_start_s": stats["cold_start_s"], "launches": counts,
        "host_syncs": stats["host_syncs"],
        "decode_step_ops": stats["decode_step_ops"],
        "graphs": replayed, **graph_stats(stats),
        "state_mib": stats["state_live_bytes"] / 2**20,
        "state_leaves_mib": raw / 2**20,
        "first_tokens": {k: v[:4] for k, v in list(toks.items())[:2]},
        "ok": True,
    })
    del stats
    torch.cuda.empty_cache()


# gemma3-4b's state at 8 slots x 2048 positions, bf16: 5 global layers of
# 2048 positions and 29 rings of 1024, 5,120 B of K+V per position
GEMMA3_STATE_BYTES = (5 * 8 * 2048 + 29 * 8 * 1024) * 5120  # 1,635,778,560


def phase_serve_gemma3(card_name: str) -> tuple[dict, dict]:
    """Full-width gemma3-4b (34 layers: 29 window layers of 1024, 5
    global layers) served by ``run_serve``: every decode step a replay of
    one graph holding 34 flash_decode launches (every layer: a ring is
    read at ``lengths = min(pos + 1, T)``), the state exactly
    1,635,778,560 B; its roofline reads the rings up to their window."""
    return run_serve("serve_gemma3", "gemma3-4b", card_name,
                     lambda b: b == GEMMA3_STATE_BYTES,
                     {"state_mib_if_every_layer_kept_2048": 34 * 8 * 2048 * 5120 / 2**20})


class RouteLog:
    """The routes ``models/moe.moe_route`` computes on real tensors while
    the log is open (a trace's fake or meta routes are not kept), up to
    ``limit`` calls: per call the (token, choice) assignments made, those
    kept, and the distinct experts that took one (read to the host: only
    eager, untimed calls are logged)."""

    def __init__(self, limit: int | None = None):
        self.limit = limit
        self.calls: list[dict] = []

    def __enter__(self) -> "RouteLog":
        from torch._subclasses.fake_tensor import is_fake

        from repro_torch.models import moe

        real = self._real = moe.moe_route

        def record(sel, gate, **kw):
            route = real(sel, gate, **kw)
            d = route.dispatch
            if (self.limit is None or len(self.calls) < self.limit) \
                    and d.device.type != "meta" and not is_fake(d):
                self.calls.append({"made": int(sel.sum()), "kept": int(route.kept),
                                   "experts": int((d.sum((0, 1, 2, 4)) > 0).sum())})
            return route

        moe.moe_route = record
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.models import moe

        moe.moe_route = self._real


def phase_parity_granite() -> None:
    """granite-moe-3b-a800m at full width (d_model 1536, 24/8 heads of 64,
    40 experts top-8 of d_ff 512), its depth cut to 2 layers, fp32, 2
    slots: a 700-token prompt with 16 new tokens and two short requests,
    served as ``parity`` serves qwen3 (flash_decode at (64, 3) against
    the plain attention, every captured step against eager)."""
    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config(GRANITE), n_periods=2, dtype="float32")
    run_parity("parity_granite", cfg, [(700, 16), (37, 20), (5, 12)], n_slots=2,
               max_len=1024)


# granite's state at 8 slots x 2048 positions, bf16: 32 layers x K and V x
# 8 slots x 2048 positions x 8 heads x 64 x 2 B
GRANITE_STATE_BYTES = 32 * 2 * 8 * 2048 * 8 * 64 * 2  # 1,073,741,824


def routed_expert_reads(engine, steps: list, snapshot, first: int) -> dict:
    """Replay ``steps`` (the decode steps' inputs, as the engine gave
    them to its captured step) eagerly from ``snapshot`` of the state
    buffer taken before the first of them, reading the routing of steps
    ``first`` onwards through ``moe_route``: the distinct experts per MoE
    layer and step, and the expert bytes a read of only those would
    take, beside the whole stacks the one-hot step reads. Whether the
    eager replay left the state as the captured steps did is reported;
    the state is put back as the served waves left it."""
    import numpy as np
    import torch

    from repro_torch.launch import roofline

    cfg = engine.cfg
    n_moe = sum(1 for spec in (*cfg.period * cfg.n_periods, *cfg.remainder)
                if spec.ffn == "moe")
    served = engine.state.buf.clone()
    engine.state.buf.copy_(snapshot)

    def dev(a):
        return torch.from_numpy(np.array(a)).to(engine.device)

    def replay(part):
        for tokens, pos, active in part:
            engine.model.decode_step(engine.params, dev(tokens), engine.caches,
                                     dev(pos), dev(active))

    with torch.no_grad():
        replay(steps[:first])
        with RouteLog() as log:
            replay(steps[first:])
    torch.cuda.synchronize()
    equal = bool(torch.equal(engine.state.buf, served))
    engine.state.buf.copy_(served)
    read = len(steps) - first
    if len(log.calls) != n_moe * read:
        fail(f"routes: {len(log.calls)} routes for {read} steps x {n_moe} layers")
    made = sum(c["made"] for c in log.calls)
    kept = sum(c["kept"] for c in log.calls)
    distinct = [c["experts"] for c in log.calls]
    per_step = [sum(distinct[i * n_moe:(i + 1) * n_moe]) for i in range(read)]
    whole = n_moe * roofline.expert_bytes(cfg)
    return {"steps": read, "assignments_made": made, "assignments_kept": kept,
            "distinct_experts_per_layer_mean": sum(distinct) / len(distinct),
            "distinct_experts_per_layer_max": max(distinct),
            "expert_bytes_read_whole_per_step": whole,
            "expert_bytes_routed_per_step": roofline.expert_bytes(cfg, 1)
            * sum(per_step) / len(per_step),
            "state_equal_after_eager_replay": equal}


def phase_serve_granite(card_name: str) -> tuple[dict, dict]:
    """``serve.run`` on full-width granite-moe-3b-a800m (32 layers of
    attention + MoE, bf16, random weights from a seed) with 8 slots x 2048
    positions and the qwen3 serve mix: all finish, every decode step is a
    replay of the one captured graph with 32 flash_decode launches at
    (64, 3), the state is one buffer of exactly 1,073,741,824 B that never
    moves; then 8 more requests for a steady window, 8 waves timed and 8
    profiled, their routing read by an eager replay (decode never drops:
    every assignment kept), and the roofline, whose bytes count every
    expert whole, as the one-hot step reads them."""
    import numpy as np
    import torch

    from repro_torch.launch import serve

    n_req, max_new = 8, 64
    reset_launches()
    stats = serve.run(["--full", "--arch", GRANITE, "--slots", "8", "--max-len", "2048",
                       "--requests", "8", "--prompt-len", "32", "--max-new", "64",
                       "--seed", "0"])
    counts = read_launches()
    engine = stats["engine"]
    cfg = engine.cfg
    toks = stats["tokens_per_request"]
    if stats["requests"] != n_req or any(len(t) != max_new for t in toks.values()):
        fail(f"serve_granite: {stats['requests']} of {n_req} requests finished, "
             f"lengths {[len(t) for t in toks.values()]}")
    if not all(0 <= x < cfg.vocab for t in toks.values() for x in t):
        fail("serve_granite: a token outside the vocabulary")
    if not stats["last_logits_finite"]:
        fail("serve_granite: non-finite logits")
    if not stats["state_live_bytes"] == stats["state_planned_bytes"] == GRANITE_STATE_BYTES:
        fail(f"serve_granite: live state {stats['state_live_bytes']} B, planned "
             f"{stats['state_planned_bytes']} B, expected {GRANITE_STATE_BYTES} B")
    if stats["state_ptr_before"] != stats["state_ptr_after"]:
        fail("serve_granite: the state buffer moved")
    replayed = check_replayed("serve_granite", stats, "flash_decode")
    if stats["capture_calls"] != 1:
        fail(f"serve_granite: {stats['capture_calls']} graphs captured, expected 1")
    plan_row("granite-moe-3b-a800m serve (8 slots x 2048)", stats)
    emit({
        "phase": "serve_granite", "arch": cfg.name, "layers": stats["n_layers"],
        "requests": stats["requests"], "tokens": stats["tokens"],
        "waves": stats["waves"], "decode_steps": stats["decode_calls"],
        "host_syncs": stats["host_syncs"], "wall_s": stats["wall_s"],
        "tokens_per_s": stats["tokens_per_s"], "cold_start_s": stats["cold_start_s"],
        "launches": counts, "graphs": replayed, **graph_stats(stats),
        "activation_lower_bound_mib": stats["plan_lower_bound_bytes"] / 2**20,
        "activation_naive_mib": stats["plan_naive_bytes"] / 2**20,
        "state_bytes": stats["state_live_bytes"],
        "state_mib": stats["state_live_bytes"] / 2**20,
        "decode_step_ops": stats["decode_step_ops"],
        "first_tokens": {k: v[:4] for k, v in list(toks.items())[:2]},
        "ok": True,
    })
    launches = counts["flash_decode"]
    # a steady window: 8 requests more, every slot active; the inputs of
    # every decode step of the window are kept, and the state before it
    waves = 8
    rng = np.random.default_rng(1)
    for _ in range(n_req):
        engine.submit(rng.integers(0, cfg.vocab, size=4).astype(np.int32),
                      max_new_tokens=2 * waves + 4)
    done = engine.step()  # admits every request
    snapshot = engine.state.buf.clone()
    steps, step_tokens = [], engine._step_tokens

    def kept_step(tokens, pos, active):
        steps.append((tokens.copy(), pos.copy(), active.copy()))
        return step_tokens(tokens, pos, active)

    engine._step_tokens = kept_step
    prof, finished = serve.profile_waves(engine, waves)
    engine._step_tokens = step_tokens
    if len(steps) != 2 * waves:
        fail(f"serve_granite: {len(steps)} decode steps in {2 * waves} waves")
    routes = routed_expert_reads(engine, steps, snapshot, waves)
    del snapshot
    done += finished + engine.run_until_done()
    if len(done) != n_req:
        fail(f"serve_granite: {len(done)} of {n_req} profiled requests finished")
    if not prof["device_ms_per_wave"] > 0:
        fail("serve_granite: the profiler saw no device time")
    if routes["assignments_kept"] != routes["assignments_made"] \
            or routes["assignments_made"] != waves * cfg.n_layers * 8 * cfg.top_k:
        fail(f"serve_granite: decode dropped assignments ({routes})")
    emit({"phase": "profile", "arch": cfg.name,
          "decode_step_ops": len(engine.decode_graph.ops),
          "replays": engine.state.graphs["step"].replays, **prof, "ok": True})
    roof = decode_roofline("granite-moe-3b-a800m steady host-loop wave", engine, prof,
                           card_name, extra={"experts": routes})
    del engine, stats
    torch.cuda.empty_cache()
    return {"launches": launches}, roof


def phase_prefill_granite(card_name: str) -> tuple[dict, dict]:
    """Full-width granite-moe-3b-a800m (32 layers, bf16): one 2048-token
    request through ``ArenaExecutor`` from its certified plan, against the
    eager prefill: 16 groups of 128 tokens per MoE layer, 32 slots per
    expert and group. The share of (token, expert) assignments dropped
    is read through ``moe_route`` in the eager prefill (the same router
    inputs), and is above 0: the capacity path ran at full width.
    Attention prefill has no kernel (plain, as in the reference)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models.api import DecoderModel

    cfg = get_config(GRANITE)
    model = DecoderModel(cfg, DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    with RouteLog(limit=cfg.n_layers) as log:
        row, roof = run_prefill(card_name, cfg, model, params, None)
    if len(log.calls) != cfg.n_layers:
        fail(f"prefill_granite: {len(log.calls)} routes read, expected {cfg.n_layers}")
    made = sum(c["made"] for c in log.calls)
    kept = sum(c["kept"] for c in log.calls)
    if made != cfg.n_layers * 2048 * cfg.top_k:
        fail(f"prefill_granite: {made} assignments made")
    share = 1 - kept / made
    if not share > 0:
        fail("prefill_granite: no assignment was dropped at capacity 32")
    emit({"phase": "prefill_granite", "groups": 2048 // 128, "group": 128,
          "capacity": 32, "assignments_made": made, "assignments_kept": kept,
          "dropped_share": share,
          "dropped_share_by_layer": [1 - c["kept"] / c["made"] for c in log.calls],
          "ok": True})
    return row, roof


# llama4-maverick-400b-a17b at full width, cut to one period: a dense layer
# and a MoE layer (128 experts top-1 and a shared expert)
LLAMA4_ONE_PERIOD_PARAMS = 17_518_755_840


def phase_parity_llama4() -> dict:
    """llama4 at full width (d_model 5120, 40/8 heads of 128, 128 experts
    of d_ff 8192 top-1, a shared expert), its depth cut to one period, in
    bf16 on 2 slots with 3 short requests: all finish, every captured
    step equals the eager one, each replay holds 2 flash_decode launches
    at (128, 5), the state is the plan (``run_parity``'s checks). The
    eager twin's steps give the routing: the one-hot step reads all 128
    experts for 2 tokens."""
    from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG
    from repro_torch.launch import roofline

    cfg = dataclasses.replace(CONFIG, n_periods=1)
    if roofline.count_params(cfg) != LLAMA4_ONE_PERIOD_PARAMS:
        fail(f"parity_llama4: {roofline.count_params(cfg)} parameters")
    with RouteLog() as log:
        row = run_parity("parity_llama4", cfg, [(6, 5), (9, 4), (4, 6)], n_slots=2,
                         max_len=64, cores=("kernel",))
    if row["captured_vs_eager"]["bitwise"] != row["captured_vs_eager"]["steps"]:
        fail(f"parity_llama4: captured steps not bit-equal to eager "
             f"({row['captured_vs_eager']})")
    distinct = [c["experts"] for c in log.calls]
    whole = roofline.expert_bytes(cfg)
    routed = roofline.expert_bytes(cfg, 1) * sum(distinct) / max(len(distinct), 1)
    emit({"phase": "parity_llama4_experts",
          "depth_cut": "one period of 24: a dense and a MoE layer",
          "parameters": roofline.count_params(cfg), "param_bytes": row["param_bytes"],
          "routed_steps": len(distinct),
          "distinct_experts_per_step_mean": sum(distinct) / max(len(distinct), 1),
          "param_bytes_read_per_step": row["param_bytes"],
          "param_bytes_if_routed": row["param_bytes"] - whole + routed, "ok": True})
    return {"launches": row["launches"]["flash_decode"]}


def phase_parity_zamba2() -> None:
    """zamba2-7b at full width (d_model 3584, Mamba2 with 2 SSM groups of
    64 states, the shared block at 7168 with 32 heads of 224:
    flash_decode at (224, 1)), its depth cut to one period (5 Mamba2
    layers and one with the shared block), fp32, 2 slots: three short
    requests, served as ``parity`` serves qwen3 (one flash_decode launch
    per replay)."""
    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config(ZAMBA2), n_periods=1, remainder=(),
                              dtype="float32")
    run_parity("parity_zamba2", cfg, [(40, 12), (9, 8), (5, 6)], n_slots=2,
               max_len=128)


def phase_parity_internvl2() -> None:
    """internvl2-1b at full width (14/2 heads of 64: flash_decode at (64,
    7)), its depth cut to 4 of its 24 layers (to keep the whole run in its
    time limit; serve_internvl2 runs all 24), fp32, 2 slots: a 300-token
    prompt and two short ones, served as ``parity`` serves qwen3 (decode
    has no image prefix, as in the reference engine)."""
    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config(INTERNVL2), n_periods=4, dtype="float32")
    run_parity("parity_internvl2", cfg, [(300, 16), (37, 12), (5, 10)], n_slots=2,
               max_len=512)


# zamba2-7b's state at 8 slots x 2048 positions, bf16, before alignment: 13
# shared K/V pairs of 2048 x 32 x 224, and 81 Mamba2 layers' conv windows (3
# x 7424) and states (112 x 64 x 64)
ZAMBA2_STATE_LEAF_BYTES = (13 * 2 * 2048 * 32 * 224
                           + 81 * (3 * 7424 + 112 * 64 * 64)) * 2 * 8  # 6,730,313,728
# internvl2-1b's: 24 layers x K and V x 8 slots x 2048 x 2 heads x 64 x 2 B
INTERNVL2_STATE_BYTES = 24 * 2 * 8 * 2048 * 2 * 64 * 2  # 201,326,592


# run_serve's tokens by arch, for the paged serves to hold theirs against
SERVE_TOKENS: dict = {}


def run_serve(phase: str, arch: str, card_name: str, state_ok,
              extra: dict | None = None) -> tuple[dict, dict]:
    """``serve.run`` on full-width ``arch`` (bf16, random weights from a
    seed) with 8 slots x 2048 positions and the qwen3 serve mix: all
    finish, every decode step is a replay of the one captured graph with
    ``flash_decode_per_step`` launches, the state is one buffer of
    exactly the planned size (``state_ok`` holds it to the leaves) that
    never moves; then 8 more requests for a steady window, 8 waves timed
    and 8 profiled, and the roofline. ``extra`` joins the phase's row."""
    import torch

    from repro_torch.launch import serve

    n_req, max_new = 8, 64
    reset_launches()
    stats = serve.run(["--full", "--arch", arch, "--slots", "8", "--max-len", "2048",
                       "--requests", "8", "--prompt-len", "32", "--max-new", "64",
                       "--seed", "0"])
    counts = read_launches()
    engine = stats["engine"]
    cfg = engine.cfg
    toks = stats["tokens_per_request"]
    SERVE_TOKENS[arch] = toks
    if stats["requests"] != n_req or any(len(t) != max_new for t in toks.values()):
        fail(f"{phase}: {stats['requests']} of {n_req} requests finished, "
             f"lengths {[len(t) for t in toks.values()]}")
    if not all(0 <= x < cfg.vocab for t in toks.values() for x in t):
        fail(f"{phase}: a token outside the vocabulary")
    if not stats["last_logits_finite"]:
        fail(f"{phase}: non-finite logits")
    if stats["state_live_bytes"] != stats["state_planned_bytes"] or \
            not state_ok(stats["state_planned_bytes"]):
        fail(f"{phase}: live state {stats['state_live_bytes']} B, planned "
             f"{stats['state_planned_bytes']} B")
    if stats["state_ptr_before"] != stats["state_ptr_after"]:
        fail(f"{phase}: the state buffer moved")
    per_step = flash_decode_per_step(cfg)
    replayed = check_replayed(phase, stats, "flash_decode", per_step=per_step)
    if stats["capture_calls"] != 1:
        fail(f"{phase}: {stats['capture_calls']} graphs captured, expected 1")
    plan_row(f"{arch} serve (8 slots x 2048)", stats)
    emit({
        "phase": phase, "arch": arch, "layers": stats["n_layers"],
        "flash_decode_per_step": per_step, "requests": stats["requests"],
        "tokens": stats["tokens"], "waves": stats["waves"],
        "decode_steps": stats["decode_calls"], "host_syncs": stats["host_syncs"],
        "wall_s": stats["wall_s"], "tokens_per_s": stats["tokens_per_s"],
        "cold_start_s": stats["cold_start_s"], "launches": counts,
        "graphs": replayed, **graph_stats(stats),
        "activation_lower_bound_mib": stats["plan_lower_bound_bytes"] / 2**20,
        "activation_naive_mib": stats["plan_naive_bytes"] / 2**20,
        "state_bytes": stats["state_live_bytes"],
        "state_mib": stats["state_live_bytes"] / 2**20,
        "decode_step_ops": stats["decode_step_ops"],
        "first_tokens": {k: v[:4] for k, v in list(toks.items())[:2]},
        **(extra or {}), "ok": True,
    })
    prof = steady_profile(phase, engine)
    emit({"phase": "profile", "arch": arch,
          "decode_step_ops": len(engine.decode_graph.ops),
          "replays": engine.state.graphs["step"].replays, **prof, "ok": True})
    roof = decode_roofline(f"{arch} steady host-loop wave", engine, prof, card_name)
    del engine, stats
    torch.cuda.empty_cache()
    return {"launches": counts["flash_decode"]}, roof


def phase_serve_zamba2(card_name: str) -> tuple[dict, dict]:
    """Full-width zamba2-7b (81 Mamba2 layers, 13 of them after the shared
    block; 7,006,114,816 parameters) served by ``run_serve``: 13
    flash_decode launches at (224, 1) per replay, its state (13 shared K/V
    caches and 81 Mamba2 states in one buffer) the leaves' 6,730,313,728 B
    plus alignment, and a roofline with both floors (the shared block
    read once, and at each of its 13 insertions)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import roofline

    if roofline.count_params(get_config(ZAMBA2)) != 7_006_114_816:
        fail(f"serve_zamba2: {roofline.count_params(get_config(ZAMBA2))} parameters")
    return run_serve("serve_zamba2", ZAMBA2, card_name,
                     lambda b: ZAMBA2_STATE_LEAF_BYTES <= b < ZAMBA2_STATE_LEAF_BYTES * 1.001)


def phase_serve_internvl2(card_name: str) -> tuple[dict, dict]:
    """Full-width internvl2-1b (24 layers) served by ``run_serve``: 24
    flash_decode launches at (64, 7) per replay, its state exactly
    201,326,592 B."""
    return run_serve("serve_internvl2", INTERNVL2, card_name,
                     lambda b: b == INTERNVL2_STATE_BYTES)


def phase_prefill_zamba2(card_name: str) -> tuple[dict, dict]:
    """Full-width zamba2-7b (81 layers, bf16): one 2048-token request
    through ``ArenaExecutor`` from its certified plan, against the eager
    prefill: ssd_chunk launched 8 chunks x 81 layers = 648 times, B and C
    reaching the 112 heads from 2 groups; the shared block's attention
    prefill (13 insertions, four 512-query chunks) is plain, as in the
    reference."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models.api import DecoderModel

    cfg = get_config(ZAMBA2)
    model = DecoderModel(cfg, DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    return run_prefill(card_name, cfg, model, params, "ssd_chunk")


def phase_prefill_internvl2(card_name: str) -> tuple[dict, dict]:
    """Full-width internvl2-1b (24 layers, bf16): one request of 256
    seeded image embeddings and 1,792 tokens (2048 positions) through
    ``ArenaExecutor`` from its certified plan, against the eager prefill;
    no kernel (attention prefill is plain, as in the reference)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models.api import DecoderModel

    cfg = get_config(INTERNVL2)
    model = DecoderModel(cfg, DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    return run_prefill(card_name, cfg, model, params, None)


# ------------------------------------------------------------------ paging
# the paged serve: 64 KiB pages, a pool of 896 (8 requests x 112 pages of
# 32 prompt + 64 new positions), one buffer of (896 + 1) x 65536 B
PAGE_SIZE = 65536
PAGE_POOL = 896
PAGED_BUFFER_BYTES = (PAGE_POOL + 1) * PAGE_SIZE  # 58,785,792
PAGED_ARGS = ["--page-size", str(PAGE_SIZE), "--page-pool", str(PAGE_POOL)]
# flash_decode_paged's timing at gemma3-4b's ring and zamba2-7b's shared
# block (the kernels phase)
PAGED_TIMING: dict = {}
# the serve and profile phases' tokens, tokens/s and device ms per wave,
# for serve_paged to check and report beside its own twin's
SERVE_NUMBERS: dict = {}
# flash_decode_paged's cases: (label, B, KV, G, D, T, page bytes, shuffled,
# lengths); the shuffled ones are chip_faults.py's must-fail cases of
# paged_table_ignored
PAGED_CASES = (
    ("paged_P16384_asc", 3, 2, 2, 64, 1024, 16384, False, (1, 385, 1024)),
    ("paged_P16384_shuffled", 3, 2, 2, 64, 1024, 16384, True, (1, 385, 1024)),
    ("paged_P65536_asc", 3, 4, 2, 64, 2048, 65536, False, (1, 700, 2048)),
    ("paged_P65536_shuffled", 3, 4, 2, 64, 2048, 65536, True, (1, 700, 2048)),
    ("paged_P1040_asc", 3, 2, 2, 64, 1024, 1040, False, (1, 385, 1024)),
    ("paged_P1040_shuffled", 3, 2, 2, 64, 1024, 1040, True, (1, 385, 1024)),
    # gemma3-4b's global layer: rows of 640 B (bf16) straddle 1040-byte pages
    ("paged_D320_G2_P1040_shuffled", 3, 2, 2, 320, 512, 1040, True, (1, 200, 512)),
    ("paged_D320_G2_P16384_shuffled", 3, 2, 2, 320, 512, 16384, True, (1, 200, 512)),
    ("paged_D64_G3_P65536_shuffled", 2, 8, 3, 64, 2048, 65536, True, (1, 2048)),
    # nemotron's (192, 12), bf16 on the tensor cores: 8 spans of 128, a row
    # one position into a tile of 64, a full row
    ("paged_D192_G12_P65536_shuffled", 3, 2, 12, 192, 1024, 65536, True, (1, 385, 1024)),
)
PAGED_MUST_FAIL = tuple(c[0] for c in PAGED_CASES if c[7])


def paged_pool(gen, B, KV, D, T, dt, page_bytes, lengths, shuffled, *,
               holes=False):
    """A page pool holding one layer's K and V for B slots: K at a 48-byte
    offset in the slot region, V 16 bytes past K's end, so neither starts
    on a page. Row b of the table maps the pages slot b's first
    ``lengths[b]`` positions touch, in ascending or shuffled physical
    order; the rest stay 0 (the null page). ``holes`` unmaps one page
    inside the length of the last slot (as a retired slot's stolen page
    reads: zeros through the null page). Returns the op's arguments
    before ``lengths``: (buf as ``dt``, table, k offset, v offset,
    position stride, head stride, T, page elements)."""
    import torch

    vec = 16 // dt.itemsize
    pe = page_bytes // dt.itemsize
    st, sh = KV * D, D
    k_off = 3 * vec
    v_off = k_off + T * st + vec
    pps = -(-(v_off + T * st) // pe)
    order = (torch.randperm(B * pps, generator=gen, device=DEVICE) if shuffled
             else torch.arange(B * pps, device=DEVICE)) + 1
    table = order.reshape(B, pps).to(torch.int32)
    for b, n in enumerate(lengths):
        need = torch.zeros(pps, dtype=torch.bool, device=DEVICE)
        for off in (k_off, v_off):
            need[off // pe:(off + n * st - 1) // pe + 1] = True
        table[b] = torch.where(need, table[b], 0)
    if holes:
        row = table[B - 1]
        mapped = row.nonzero().flatten()
        row[mapped[len(mapped) // 2]] = 0
    buf = (torch.randn(((B * pps + 1) * pe,), generator=gen, device=DEVICE) * 0.5).to(dt)
    buf[:pe] = 0
    return buf, table, k_off, v_off, st, sh, T, pe


def phase_kernels_paged(card_name: str) -> dict:
    """``flash_decode_paged`` against its plain version in fp32 on the same
    pool and table, at the ``flash_decode`` bars: page sizes of 16 KiB, 64
    KiB and 1040 B (a multiple of 16, not a power of two), fp32 and bf16,
    ascending and shuffled tables with null pages past the lengths, a
    length-1 row, a mapped hole inside a length, and gemma3's (320, 2)
    whose 640-byte rows straddle 1040-byte pages, and nemotron's (192, 12)
    (bf16 on the tensor cores). Then bit-equality with ``flash_decode`` on
    the cache gathered out of the pool at qwen3-0.6b's serving layout (its
    own paged plan: 64 KiB pages, the first layer's K and V of 28), at
    granite's (64, 3) and at nemotron's span, and the timing at qwen3's
    serving shape with a shuffled table: the kernel, its plain version,
    the symmetric kernel on the gathered cache and the gather alone."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.unified import (detect_state_axes, plan_paged_state,
                                          state_records_from_cache)
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.ref import flash_decode_paged_ref, paged_index
    from repro_torch.launch.roofline import kernel_bound
    from repro_torch.models.api import DecoderModel
    from repro_torch.runtime.paging import PagedStateResidency

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 1e-2)}

    def check(label, q, args, lengths):
        buf = args[0]
        got = fd.flash_decode_paged(q, buf, *args[1:], lengths)
        want = flash_decode_paged_ref(q.float(), buf.float(), *args[1:], lengths)
        control = flash_decode_paged_ref(q, buf, *args[1:], lengths)
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        atol, rtol = tol[q.dtype]
        ok = bool((err <= atol + rtol * want.abs()).all())
        emit({"phase": "kernels", "kernel": "flash_decode_paged", "case": label,
              "dtype": str(q.dtype).removeprefix("torch."),
              "path": fd.kernel_path(q.dtype, q.shape[3], q.shape[2]),
              "page_elems": args[-1], "pages_per_slot": args[1].shape[1],
              "max_abs_err": float(err.max()),
              "control_max_abs_err": float((control.float() - want).abs().max()),
              "max_abs_out": float(want.abs().max()),
              "atol": atol, "rtol": rtol, "ok": ok})
        if not ok:
            fail_case(f"flash_decode_paged/{label}/{q.dtype}",
                      f"flash_decode_paged {label}: max abs err {float(err.max())} "
                      f"over {atol} + {rtol} * |want|")
        return float(err.max())

    def gathered(args, KV, D):
        buf, table, k_off, v_off, st, sh, T, pe = args
        k = buf[paged_index(table, k_off, (st, sh, 1), (T, KV, D), pe)]
        v = buf[paged_index(table, v_off, (st, sh, 1), (T, KV, D), pe)]
        return k, v

    def bit_equal(label, q, args, lengths):
        """flash_decode_paged and flash_decode on the gathered cache: equal
        bit for bit (one kernel, other addresses)."""
        KV, D = q.shape[1], q.shape[3]
        k, v = gathered(args, KV, D)
        paged = fd.flash_decode_paged(q, *args, lengths)
        flat = fd.flash_decode(q, k, v, lengths)
        same = bool(torch.equal(paged, flat))
        emit({"phase": "kernels", "kernel": "flash_decode_paged",
              "bit_equal_to_flash_decode": label, "shape": list(q.shape),
              "path": fd.kernel_path(q.dtype, q.shape[3], q.shape[2]),
              "equal": same, "max_abs_diff": float((paged.float() - flat.float()).abs().max())})
        if not same:
            fail_case(f"flash_decode_paged/bit_equal/{label}",
                      f"flash_decode_paged {label}: not bit-equal to flash_decode "
                      f"on the gathered cache")

    for dt in (torch.float32, torch.bfloat16):
        for label, B, KV, G, D, T, page, shuffled, lengths in PAGED_CASES:
            args = paged_pool(gen, B, KV, D, T, dt, page, lengths, shuffled)
            q = (torch.randn((B, KV, G, D), generator=gen, device=DEVICE) * Q_STD).to(dt)
            check(label, q, args, torch.tensor(lengths, dtype=torch.int32,
                                               device=DEVICE))
        # a mapped hole inside a slot's length reads the null page's zeros
        args = paged_pool(gen, 3, 2, 64, 1024, dt, 16384, (1, 385, 1024), True,
                          holes=True)
        q = (torch.randn((3, 2, 2, 64), generator=gen, device=DEVICE) * Q_STD).to(dt)
        check("paged_P16384_shuffled_hole", q, args,
              torch.tensor((1, 385, 1024), dtype=torch.int32, device=DEVICE))

    # granite's (64, 3) at its serving shape, 64 KiB pages, shuffled
    B, KV, G, D, T = 8, 8, 3, 64, 2048
    lengths = torch.full((B,), T, dtype=torch.int32, device=DEVICE)
    args = paged_pool(gen, B, KV, D, T, torch.bfloat16, PAGE_SIZE, [T] * B, True)
    q = (torch.randn((B, KV, G, D), generator=gen, device=DEVICE) * Q_STD).to(torch.bfloat16)
    bit_equal("granite_serving_full", q, args, lengths)
    del args
    # nemotron's (192, 12) at one rank's span of decode_32k (the tensor-core
    # kernel), 64 KiB pages, shuffled: rows ending at a tile and a span edge
    B, KV, G, D, T = 8, 8, 12, 192, 2048
    rows = (1, 64, 65, 256, 257, 1500, 2047, T)
    lengths = torch.tensor(rows, dtype=torch.int32, device=DEVICE)
    args = paged_pool(gen, B, KV, D, T, torch.bfloat16, PAGE_SIZE, rows, True)
    q = (torch.randn((B, KV, G, D), generator=gen, device=DEVICE) * Q_STD).to(torch.bfloat16)
    check("nemotron_span_P65536_shuffled", q, args, lengths)
    bit_equal("nemotron_span", q, args, lengths)
    del args

    # qwen3-0.6b's serving layout: its own paged plan at 8 x 2048, bf16, the
    # default pool (every page mapped), the table a random permutation of it
    cfg = get_config("qwen3-0.6b")
    B, T = 8, 2048
    model = DecoderModel(cfg, "meta")
    template = model.init_cache(B, T, device="meta")
    plan = plan_paged_state(
        state_records_from_cache(template, n_slots=B), n_slots=B, max_len=T,
        page_size=PAGE_SIZE,
        axes=detect_state_axes(model.init_cache, n_slots=B, max_len=T))
    res = PagedStateResidency(plan, template, n_slots=B)
    pool = res.init_buffer(DEVICE)
    pool.view(torch.bfloat16).normal_(0.0, 0.5, generator=gen)
    pool[:PAGE_SIZE] = 0
    table = (torch.randperm(plan.n_pages_pool, generator=gen, device=DEVICE) + 1
             ).reshape(B, plan.pages_per_slot).to(torch.int32)
    k_leaf, v_leaf = (leaf[0] for leaf in res.bind(pool, table)["period"][0]["attn"])
    KV, G, D = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    st, sh, _ = k_leaf.strides
    args = (k_leaf.buf, table, k_leaf.offset, v_leaf.offset, st, sh, T,
            k_leaf.page_elems)
    q = (torch.randn((B, KV, G, D), generator=gen, device=DEVICE) * Q_STD).to(torch.bfloat16)
    record = {}
    for label, lengths in (
        ("serving_full", torch.full((B,), T, dtype=torch.int32, device=DEVICE)),
        ("serve_mix", torch.linspace(33, 96, B, device=DEVICE).round().to(torch.int32)),
    ):
        err = check(f"qwen3_{label}_shuffled", q, args, lengths)
        bit_equal(f"qwen3_{label}", q, args, lengths)
        k, v = gathered(args, KV, D)
        before = fd.PAGED_LAUNCHES, fd.LAUNCHES
        ms = cuda_time_ms(lambda: fd.flash_decode_paged(q, *args, lengths))
        plain_ms = cuda_time_ms(lambda: flash_decode_paged_ref(q, *args, lengths))
        symmetric_ms = cuda_time_ms(lambda: fd.flash_decode(q, k, v, lengths))
        gather_ms = cuda_time_ms(lambda: gathered(args, KV, D))
        fd.PAGED_LAUNCHES, fd.LAUNCHES = before  # timing launches are not the path's
        total_len = int(lengths.sum())
        bound = kernel_bound("flash_decode", {
            "B": B, "KV": KV, "G": G, "D": D, "T": T, "dtype": "bfloat16",
            "sum_lengths": total_len}, card_name=card_name)
        row = {"phase": "kernels", "kernel": "flash_decode_paged",
               "timing": label, "arch": cfg.name, "shape": [B, KV, G, D, T],
               "page_size": PAGE_SIZE, "table": "shuffled",
               "sum_lengths": total_len, "ms": ms, "plain_ms": plain_ms,
               "library_ms": None,
               "library": "none: no PyTorch call reads through a page table",
               "flash_decode_on_gathered_ms": symmetric_ms,
               "gather_ms": gather_ms,
               "bound_ms": bound.bound_s * 1e3, "bound_by": bound.bound_by,
               "bytes": bound.min_bytes, "max_abs_err": err,
               "n_split": fd.num_splits(B, KV, G, D, T, torch.bfloat16)}
        emit(row)
        record[label] = row
        del k, v
    del pool, table, args, res
    # gemma3-4b's ring (every length 1024, after the wrap) and zamba2-7b's
    # shared block at full lengths: one layer's K and V in a pool of 64 KiB
    # pages mapped by a shuffled table
    for label, arch, (KV, G, D, T) in (("gemma3_ring", "gemma3-4b", (4, 2, 320, 1024)),
                                       ("zamba2", ZAMBA2, (32, 1, 224, 2048))):
        lengths = torch.full((B,), T, dtype=torch.int32, device=DEVICE)
        args = paged_pool(gen, B, KV, D, T, torch.bfloat16, PAGE_SIZE, [T] * B, True)
        q = (torch.randn((B, KV, G, D), generator=gen, device=DEVICE) * Q_STD
             ).to(torch.bfloat16)
        err = check(f"{label}_P65536_shuffled", q, args, lengths)
        bit_equal(label, q, args, lengths)
        k, v = gathered(args, KV, D)
        before = fd.PAGED_LAUNCHES, fd.LAUNCHES
        ms = cuda_time_ms(lambda: fd.flash_decode_paged(q, *args, lengths))
        plain_ms = cuda_time_ms(lambda: flash_decode_paged_ref(q, *args, lengths))
        symmetric_ms = cuda_time_ms(lambda: fd.flash_decode(q, k, v, lengths))
        gather_ms = cuda_time_ms(lambda: gathered(args, KV, D))
        fd.PAGED_LAUNCHES, fd.LAUNCHES = before
        bound = kernel_bound("flash_decode", {
            "B": B, "KV": KV, "G": G, "D": D, "T": T, "dtype": "bfloat16",
            "sum_lengths": B * T}, card_name=card_name)
        row = {"phase": "kernels", "kernel": "flash_decode_paged", "timing": label,
               "arch": arch, "shape": [B, KV, G, D, T], "page_size": PAGE_SIZE,
               "table": "shuffled", "sum_lengths": B * T, "ms": ms,
               "plain_ms": plain_ms, "library_ms": None,
               "library": "none: no PyTorch call reads through a page table",
               "flash_decode_on_gathered_ms": symmetric_ms, "gather_ms": gather_ms,
               "bound_ms": bound.bound_s * 1e3, "bound_by": bound.bound_by,
               "bytes": bound.min_bytes, "max_abs_err": err,
               "n_split": fd.num_splits(B, KV, G, D, T, torch.bfloat16)}
        emit(row)
        PAGED_TIMING[label] = row
        del args, k, v
    torch.cuda.empty_cache()
    return record["serving_full"]


# flash_decode on gemma3-4b's rings (the kernels phase): a ring of T <= window
# slots is read at lengths = min(pos + 1, T), which is the ring mask
RING_TIMING: dict = {}
GEMMA3_WINDOW = 1024


def ring_positions(B: int, T: int, wrapped: bool, gen) -> "torch.Tensor":
    """Per-slot positions: past the first wrap (every length T, the new
    row overwriting an old one), or before it (a ring written as a
    global cache)."""
    import torch

    lo, hi = (T, 4 * T) if wrapped else (0, T)
    return torch.randint(lo, hi, (B,), generator=gen, device=DEVICE, dtype=torch.int32)


def ring_case(label, q, k, v, pos, window, k_new, v_new, tol) -> tuple[float, bool]:
    """One decode read of a ring: the new K/V rows written through the
    model's ring write (``attention._slot``, ``_write_kv``) and the ring read
    by ``flash_decode`` at ``lengths = min(pos + 1, T)``, against the plain
    version: a copy of the ring written at ``pos % T`` by plain indexing and
    read by the reference's ring-masked core (``attention.decode_attention``)
    in fp32. Returns (max abs err, ok); the caches are written in place."""
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import attention

    B, T, KV, D = k.shape
    G = q.shape[2]
    rows = torch.arange(B, device=DEVICE)
    k_ref, v_ref = k.float().clone(), v.float().clone()
    k_ref[rows, pos.long() % T] = k_new[:, 0].float()
    v_ref[rows, pos.long() % T] = v_new[:, 0].float()
    want = attention.decode_attention(q.float().reshape(B, 1, KV * G, D), k_ref, v_ref,
                                      pos, window)
    attention._write_kv(k, v, k_new, v_new, attention._slot(pos, T, window), None)
    lengths = torch.clamp(pos + 1, max=T).to(torch.int32)
    got = fd.flash_decode(q, k, v, lengths).reshape(B, 1, KV * G * D)
    torch.cuda.synchronize()
    err = (got.float() - want).abs()
    atol, rtol = tol[q.dtype]
    ok = bool((err <= atol + rtol * want.abs()).all())
    emit({"phase": "kernels", "kernel": "flash_decode", "case": label,
          "dtype": str(q.dtype).removeprefix("torch."), "T": T, "window": window,
          "positions": pos.tolist(), "max_abs_err": float(err.max()),
          "max_abs_out": float(want.abs().max()), "atol": atol, "rtol": rtol,
          "ok": ok})
    if not ok:
        fail_case(f"flash_decode/{label}/{q.dtype}",
                  f"flash_decode {label}: max abs err {float(err.max())} over "
                  f"{atol} + {rtol} * |want|")
    return float(err.max()), ok


def phase_kernels_ring(card_name: str) -> dict:
    """``flash_decode`` on sliding-window rings against the ring-masked
    plain core (``ring_case``): small rings (T of 1, 8, 64 under windows
    of T and more) at positions before and past their wraps, gemma3-4b's
    ring (8, 4, 2, 320, 1024) in every length wrapped; then one
    full-width gemma3 window layer decoded token by token through
    ``attn_decode_kernel`` over 1,100 positions against ``attn_prefill``
    of the same sequence (an implementation that keeps no ring); then the
    timing at gemma3-4b's serving layout (a ring of the 8 x 2048 state
    buffer, every length 1024 after the wrap) beside its bound, the plain
    core and SDPA under the ring mask."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.roofline import kernel_bound
    from repro_torch.models import attention

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 1e-2)}

    def rand(shape, dt, std=0.5):
        return (torch.randn(shape, generator=gen, device=DEVICE) * std).to(dt)

    def case(label, B, KV, G, D, T, window, wrapped, dt):
        k, v = rand((B, T, KV, D), dt), rand((B, T, KV, D), dt)
        q = rand((B, KV, G, D), dt, Q_STD)
        kn, vn = rand((B, 1, KV, D), dt), rand((B, 1, KV, D), dt)
        return ring_case(label, q, k, v, ring_positions(B, T, wrapped, gen), window,
                         kn, vn, tol)

    for dt in (torch.float32, torch.bfloat16):
        for T, window in ((1, 1), (8, 8), (8, 13), (64, 64), (64, 1024)):
            for wrapped in (False, True):
                case(f"ring_{'wrapped' if wrapped else 'unwrapped'}_T{T}_W{window}",
                     3, 2, 2, 64, T, window, wrapped, dt)
        case("ring_wrapped_D320_G2_T1024", 8, 4, 2, 320, GEMMA3_WINDOW, GEMMA3_WINDOW,
             True, dt)

    # one full-width gemma3 window layer, fp32: decode through the ring vs
    # attn_prefill over the whole sequence
    cfg = get_config("gemma3-4b")
    H, KV, D, S = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, 1100
    p = attention.attn_init(gen, (), cfg.d_model, H, KV, D, cfg.qk_norm, torch.float32,
                            DEVICE)
    kw = dict(n_heads=H, n_kv=KV, head_dim=D, theta=cfg.rope_theta, window=GEMMA3_WINDOW,
              eps=cfg.rms_eps)
    x = rand((1, S, cfg.d_model), torch.float32, 1.0)
    want, _ = attention.attn_prefill(p, x, **kw)
    ring = tuple(torch.zeros((1, GEMMA3_WINDOW, KV, D), device=DEVICE) for _ in range(2))
    got = torch.cat([attention.attn_decode_kernel(p, x[:, t:t + 1], ring, t, **kw)[0]
                     for t in range(S)], dim=1)
    err = (got - want).abs()
    ok = bool((err <= 1e-4 + 1e-4 * want.abs()).all())
    emit({"phase": "kernels", "kernel": "flash_decode", "case": "ring_decode_vs_prefill",
          "dtype": "float32", "positions": S, "window": GEMMA3_WINDOW,
          "max_abs_err": float(err.max()),
          "max_abs_err_after_wrap": float(err[:, GEMMA3_WINDOW:].max()),
          "atol": 1e-4, "rtol": 1e-4, "ok": ok})
    if not ok:
        fail_case("flash_decode/ring_decode_vs_prefill/torch.float32",
                  f"ring decode vs prefill: max abs err {float(err.max())}")
    del p, x, want, got, ring

    # the serving layout: gemma3-4b's first ring in the 8 x 2048 state
    # buffer (bf16), every slot past its wrap
    B, G = 8, H // KV
    buf, caches = _residency_cache(cfg, B, 2048, gen)
    k, v = (leaf[0] for leaf in caches["period"][0]["attn"])
    T = k.shape[1]
    q = rand((B, KV, G, D), torch.bfloat16, Q_STD)
    pos = ring_positions(B, T, True, gen)
    kn, vn = rand((B, 1, KV, D), torch.bfloat16), rand((B, 1, KV, D), torch.bfloat16)
    err, _ = ring_case("gemma3_ring_wrapped", q, k, v, pos, GEMMA3_WINDOW, kn, vn, tol)
    lengths = torch.clamp(pos + 1, max=T).to(torch.int32)
    q4 = q.reshape(B, 1, H, D)
    slot_pos = pos[:, None] - ((pos[:, None] - torch.arange(T, device=DEVICE)) % T)
    mask = ((slot_pos >= 0) & (slot_pos > pos[:, None] - GEMMA3_WINDOW))[:, None, None, :]
    qs, kt, vt = q4.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask, enable_gqa=True)

    lib_err = float((library().transpose(1, 2).reshape(B, 1, H * D).float()
                     - attention.decode_attention(q4.float(), k.float(), v.float(), pos,
                                                  GEMMA3_WINDOW)).abs().max())
    before = fd.LAUNCHES
    ms = cuda_time_ms(lambda: fd.flash_decode(q, k, v, lengths))
    plain_ms = cuda_time_ms(lambda: attention.decode_attention(q4, k, v, pos,
                                                               GEMMA3_WINDOW))
    backend, by_backend = sdpa_backends(library)
    library_ms = cuda_time_ms(library)
    fd.LAUNCHES = before  # timing launches are not the main path's
    bound = kernel_bound("flash_decode", {
        "B": B, "KV": KV, "G": G, "D": D, "T": T, "dtype": "bfloat16",
        "sum_lengths": int(lengths.sum())}, card_name=card_name)
    row = {"phase": "kernels", "kernel": "flash_decode", "timing": "gemma3_ring",
           "arch": cfg.name, "shape": [B, KV, G, D, T], "window": GEMMA3_WINDOW,
           "sum_lengths": int(lengths.sum()), "ms": ms, "plain_ms": plain_ms,
           "plain": "attention.decode_attention (the ring-masked plain core)",
           "library_ms": library_ms, "library_backend": backend,
           "library_ms_by_backend": by_backend,
           "library": "F.scaled_dot_product_attention(attn_mask=ring mask, "
                      "enable_gqa=True)",
           "library_max_abs_err": lib_err,
           "bound_ms": bound.bound_s * 1e3, "bound_by": bound.bound_by,
           "bytes": bound.min_bytes, "max_abs_err": err,
           "n_split": fd.num_splits(B, KV, G, D, T, torch.bfloat16)}
    emit(row)
    RING_TIMING.update(row)
    del buf, caches, k, v
    torch.cuda.empty_cache()
    return row


# Mamba2 states read and written through a shuffled page table (the
# kernels phase): (arch, page bytes); chip_faults.py's must-fail cases of
# state_put_ignores_table
STATE_PUT_CASES = (("mamba2-2.7b", 16384), ("mamba2-2.7b", PAGE_SIZE),
                   ("zamba2-7b", 16384), ("zamba2-7b", PAGE_SIZE))


def phase_kernels_state() -> None:
    """``mamba_decode`` on paged state against the symmetric step, bit for
    bit: one full-width period's state (mamba2-2.7b: one Mamba2 layer;
    zamba2-7b: six and the shared block's K/V) at 8 slots x 96, bf16, laid
    out by the engine's paged plan, its pool seeded and mapped by a
    shuffled table, and the same values in the symmetric plan's buffer.
    One decode of the last Mamba2 layer with two slots inactive: outputs
    equal, every leaf of the pool (the layer's conv window and state, and
    their neighbours on shared pages) gathered equal to the symmetric
    views, and the null page zero."""
    import torch
    import torch.utils._pytree as pytree

    from repro_torch.configs.base import get_config
    from repro_torch.core.unified import (detect_state_axes, iter_leaves,
                                          plan_paged_state, plan_state,
                                          state_records_from_cache)
    from repro_torch.kernels.ref import paged_index
    from repro_torch.models import ssm
    from repro_torch.models.api import DecoderModel
    from repro_torch.runtime.paging import PagedStateResidency
    from repro_torch.runtime.residency import StateResidency

    gen = torch.Generator(device=DEVICE).manual_seed(4)
    B, T = 8, 96
    active = torch.tensor([1, 1, 0, 1, 1, 0, 1, 1], dtype=torch.bool, device=DEVICE)
    for arch, page in STATE_PUT_CASES:
        cfg = dataclasses.replace(get_config(arch), n_periods=1, remainder=())
        model = DecoderModel(cfg, "meta")
        template = model.init_cache(B, T, device="meta")
        records = state_records_from_cache(template, n_slots=B)
        plan = plan_paged_state(records, n_slots=B, max_len=T, page_size=page,
                                axes=detect_state_axes(model.init_cache, n_slots=B,
                                                       max_len=T))
        res = PagedStateResidency(plan, template, n_slots=B)
        pool = res.init_buffer(DEVICE)
        table = (torch.randperm(plan.n_pages_pool, generator=gen, device=DEVICE) + 1
                 ).reshape(B, plan.pages_per_slot).to(torch.int32)
        sres = StateResidency(plan_state(records, n_slots=B, max_len=T), template,
                              n_slots=B)
        sbuf = sres.init_buffer(DEVICE)
        sbuf.view(torch.bfloat16).normal_(0.0, 0.5, generator=gen)
        views = sres.views(sbuf)
        # the symmetric values into the pool, by plain indexing through the table
        flat = pool.view(torch.bfloat16)
        values = dict(iter_leaves(views))
        for path, leaf in res.leaves(pool, table).items():
            idx = paged_index(table, leaf.offset, leaf.strides, leaf.shape,
                              leaf.page_elems)
            flat[idx] = values[path].movedim(1 if path.startswith("['period']") else 0, 0)
        j = max(i for i, spec in enumerate(cfg.period) if spec.mixer == "mamba")
        paged_layer = tuple(leaf[0] for leaf in res.bind(pool, table)["period"][j]["mamba"])
        sym_layer = tuple(leaf[0] for leaf in views["period"][j]["mamba"])
        p = ssm.mamba_init(gen, (), cfg.d_model, expand=cfg.ssm_expand,
                           head_dim=cfg.ssm_head_dim, ngroups=cfg.ssm_groups,
                           dstate=cfg.ssm_state, conv=cfg.ssm_conv,
                           dtype=torch.bfloat16, device=DEVICE)
        x = (torch.randn((B, 1, cfg.d_model), generator=gen, device=DEVICE)
             ).to(torch.bfloat16)
        kw = dict(expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                  ngroups=cfg.ssm_groups, dstate=cfg.ssm_state, conv=cfg.ssm_conv,
                  eps=cfg.rms_eps, active=active)
        with torch.no_grad():
            got, _ = ssm.mamba_decode(p, x, paged_layer, **kw)
            want, _ = ssm.mamba_decode(p, x, sym_layer, **kw)
        torch.cuda.synchronize()
        leaves_equal = all(
            torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))
            for a, b in zip(pytree.tree_leaves(res.gather(pool, table)),
                            pytree.tree_leaves(views), strict=True))
        null_zero = not bool(pool[:page].any())
        ok = bool(torch.equal(got, want)) and leaves_equal and null_zero
        label = f"state_put_{arch}_P{page}_shuffled"
        emit({"phase": "kernels", "kernel": "mamba_decode_paged", "case": label,
              "dtype": "bfloat16", "page_size": page, "pages_per_slot": plan.pages_per_slot,
              "layer": j, "outputs_equal": bool(torch.equal(got, want)),
              "leaves_byte_identical": leaves_equal, "null_page_zero": null_zero,
              "max_abs_err": float((got.float() - want.float()).abs().max()), "ok": ok})
        if not ok:
            fail_case(f"mamba_decode_paged/{label}",
                      f"{label}: the paged Mamba2 step differs from the symmetric one")
        del pool, table, sbuf, views, p
    torch.cuda.empty_cache()


def phase_parity_paged() -> None:
    """Paged engines (64 KiB pages) against symmetric ones from one seed
    (``run_parity_paged``): a full-width 2-layer fp32 qwen3; gemma3-4b at
    full width cut to two layers (``gemma3_two_layers``: a ring of 1024
    and a global cache), with the 1,090-token prompt of ``parity_gemma3``
    so the ring wraps;
    a 2-layer mamba2-2.7b; zamba2-7b cut to a Mamba2 layer and one after
    the shared block. The last three are also served with the plain
    cores (paged), whose logits are held within 1e-4 of the kernel's."""
    from repro_torch.configs.base import LayerSpec, get_config

    mix = list(zip((3, 5, 8, 2, 6, 4), (6, 9, 4, 7, 5, 8)))
    qwen3 = dataclasses.replace(get_config("qwen3-0.6b"), n_periods=2, dtype="float32")
    run_parity_paged(qwen3, mix, n_slots=4, max_len=128, plain=False)
    run_parity_paged(gemma3_two_layers(), [(1090, 16), (37, 20), (5, 12)], n_slots=2,
                     max_len=1280)
    mamba2 = dataclasses.replace(get_config("mamba2-2.7b"), n_periods=2, dtype="float32")
    run_parity_paged(mamba2, mix, n_slots=4, max_len=128)
    zamba2 = dataclasses.replace(
        get_config(ZAMBA2), n_periods=1, remainder=(), dtype="float32",
        period=(LayerSpec(mixer="mamba", ffn="none"),
                LayerSpec(mixer="mamba", ffn="none", shared_attn=True)))
    run_parity_paged(zamba2, mix, n_slots=4, max_len=128)


def run_parity_paged(cfg, requests, *, n_slots: int, max_len: int,
                     plain: bool = True) -> None:
    """``cfg`` served from one seed by a paged engine (64 KiB pages) and a
    symmetric one, both with the kernel cores, and beside the paged
    engine the model's eager ``decode_step`` on a pool of its own read
    through the engine's table: tokens and slot logs identical, logits
    bit-equal (the paged kernel is the symmetric one with other
    addresses, a paged Mamba2 layer the symmetric arithmetic on gathered
    rows), every captured paged step bit-equal to the eager paged step,
    the twin's pool byte-identical to the engine's, and the caches
    gathered through the table byte-identical to the symmetric engine's
    after the run. The paged graph holds one ``flash_decode_paged``
    launch per attention layer and shared-block insertion and no
    ``flash_decode``. With ``plain``, a third engine serves the same
    requests paged with the plain cores: the same tokens, logits within
    1e-4 + 1e-4·|plain|."""
    import numpy as np
    import torch

    from repro_torch.core.shared_objects import from_page_log
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.api import DecoderModel
    from repro_torch.runtime.engine import InferenceEngine

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = DecoderModel(cfg, DEVICE).init(gen)
    reset_launches()
    kw = dict(n_slots=n_slots, max_len=max_len, device=DEVICE)
    engines = {"paged": InferenceEngine(cfg, params, page_size=PAGE_SIZE, **kw),
               "symmetric": InferenceEngine(cfg, params, **kw)}
    if plain:
        engines["plain"] = InferenceEngine(cfg, params, page_size=PAGE_SIZE,
                                           cores="plain", **kw)
    ep, es = engines["paged"], engines["symmetric"]
    twin_buf = torch.zeros_like(ep.state.buf)
    twin = ep.residency.bind(twin_buf, ep.state.table)
    checked = {"steps": 0, "bitwise": 0}
    step_tokens, reset = ep._step_tokens, ep.state.reset

    def dev(a):
        return torch.from_numpy(np.array(a)).to(DEVICE)

    def checked_step(tokens, pos, active):
        got = step_tokens(tokens, pos, active)
        before = fd.PAGED_LAUNCHES
        with torch.no_grad():
            want, _ = ep.model.decode_step(params, dev(tokens), twin, dev(pos),
                                           dev(active))
        fd.PAGED_LAUNCHES = before  # the twin's launches are the check's
        checked["steps"] += 1
        checked["bitwise"] += int(torch.equal(got, want.float()))
        if not torch.equal(got, want.float()):
            fail(f"parity_paged {cfg.name}: captured paged step differs from the "
                 f"eager one by {float((got - want).abs().max())}")
        return got

    def checked_reset(keep):
        reset(keep)
        ep.residency.wipe(twin_buf, ep.state.table,
                          ep.state._table[~np.asarray(keep, dtype=bool)])

    ep._step_tokens, ep.state.reset = checked_step, checked_reset
    rng = np.random.default_rng(0)
    for n, new in requests:
        prompt = rng.integers(0, cfg.vocab, size=n).astype(np.int32)
        for e in engines.values():
            e.submit(prompt, max_new_tokens=new)
    done = {name: {} for name in engines}
    worst = 0.0
    while any(e.unfinished_requests() for e in engines.values()):
        for name, e in engines.items():
            done[name].update({r.request_id: r.tokens for r in e.step()})
        if ep.last_logits is None:
            continue
        if not np.array_equal(ep.last_logits, es.last_logits):
            fail(f"parity_paged {cfg.name}: logits differ by "
                 f"{float(np.abs(ep.last_logits - es.last_logits).max())} "
                 f"at wave {ep.waves}")
        if plain:
            want = engines["plain"].last_logits
            diff = np.abs(ep.last_logits - want)
            worst = max(worst, float(diff.max()))
            if not np.all(diff <= 1e-4 + 1e-4 * np.abs(want)):
                fail(f"parity_paged {cfg.name}: kernel and plain logits differ by "
                     f"{float(diff.max())} at wave {ep.waves}")
    if len(done["paged"]) != len(requests) or any(d != done["paged"] for d in done.values()):
        fail(f"parity_paged {cfg.name}: tokens differ {done}")
    if any(e.slot_log != ep.slot_log for e in engines.values()):
        fail(f"parity_paged {cfg.name}: slot logs differ")
    if checked["steps"] != ep.decode_calls or \
            ep.state.graphs["step"].replays != ep.decode_calls:
        fail(f"parity_paged {cfg.name}: {checked['steps']} checked steps, "
             f"{ep.decode_calls} decode steps")
    if not torch.equal(twin_buf, ep.state.buf):
        fail(f"parity_paged {cfg.name}: the eager twin's pool differs from the engine's")
    for a, b in zip(torch.utils._pytree.tree_leaves(ep.caches),
                    torch.utils._pytree.tree_leaves(es.caches), strict=True):
        if not torch.equal(a.contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8)):
            fail(f"parity_paged {cfg.name}: the gathered caches differ from the "
                 f"symmetric ones")
    per_step = flash_decode_per_step(cfg)
    held = {name: dict(e.state.graphs["step"].launches) for name, e in engines.items()}
    if held["paged"].get("flash_decode_paged", 0) != per_step or \
            held["paged"].get("flash_decode", 0) or \
            (plain and any(held["plain"].values())):
        fail(f"parity_paged {cfg.name}: the graphs hold {held}, expected {per_step} "
             f"flash_decode_paged launches in the paged kernel one and none else")
    for name, e in engines.items():
        if e.paged and e.state.pages_live:
            fail(f"parity_paged {cfg.name}: {e.state.pages_live} pages live after "
                 f"the drain ({name})")
    from_page_log(ep.page_log, state_plan=ep.memory_report.state_plan)
    row = {"phase": "parity_paged", "arch": cfg.name, "dtype": cfg.dtype,
           "layers": cfg.n_layers, "page_size": PAGE_SIZE,
           "pages_total": ep.state.pages_total,
           "pages_live_peak": ep.state.pages_live_peak,
           "allocated_bytes": ep.state.allocated_bytes,
           "symmetric_state_bytes": es.memory_report.state_live_bytes,
           "waves": ep.waves, "decode_steps": ep.decode_calls,
           "launches": read_launches(), "captured_per_replay": held,
           "captured_vs_eager": checked, "slot_log": ep.slot_log,
           "page_log_entries": len(ep.page_log),
           "first_tokens": {k: v[:6] for k, v in done["paged"].items()}}
    if plain:
        row["kernel_vs_plain_logits_max_abs_diff"] = worst
    windows = {spec.window for spec in cfg.period if spec.window}
    if windows:
        reached = [n + len(done["paged"][i]) for i, (n, _) in enumerate(requests)]
        if max(reached) <= max(windows):
            fail(f"parity_paged {cfg.name}: no ring wrapped (positions {reached})")
        row.update({"positions_reached": reached, "windows": sorted(windows)})
    emit({**row, "ok": True})
    del engines, ep, es, twin, twin_buf, params
    torch.cuda.empty_cache()


def graph_launch_ms(engine, replays: int = 8) -> float:
    """Host milliseconds one replay of the engine's step graph takes to
    launch (the host clock around ``CUDAGraph.replay`` alone, the card
    idle before it), every slot inactive, so the replays change nothing."""
    import torch

    engine.state._s.active.zero_()
    graph = engine.state.graphs["step"].graph
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(replays):
        graph.replay()
    launch = (time.perf_counter() - t0) / replays * 1e3
    torch.cuda.synchronize()
    return launch


def steady_profile(phase: str, engine) -> dict:
    """8 requests more on a served engine, then 8 steady waves timed and 8
    profiled (every slot active), as the profile phase does."""
    import numpy as np

    from repro_torch.launch import serve

    waves, n_req = 8, 8
    rng = np.random.default_rng(1)
    for _ in range(n_req):
        engine.submit(rng.integers(0, engine.cfg.vocab, size=4).astype(np.int32),
                      max_new_tokens=2 * waves + 4)
    done = engine.step()  # admits every request
    prof, finished = serve.profile_waves(engine, waves)
    done += finished + engine.run_until_done()
    if len(done) != n_req:
        fail(f"{phase}: {len(done)} of {n_req} profiled requests finished")
    if not prof["device_ms_per_wave"] > 0:
        fail(f"{phase}: the profiler saw no device time")
    return prof


def steady_pair(engines: dict, waves: int = 8) -> dict:
    """A steady window on each engine of ``engines`` (name -> engine), every
    slot active: 8 requests each, then ``waves`` waves of each timed by the
    host clock, all before any of them is profiled (a profiler session
    leaves costs on the host's later launches), then ``profile_waves`` on
    each. Returns name -> the profile, its ``wall_ms_per_wave`` the
    unprofiled timing and ``admission_peak_bytes`` the allocator's peak
    above what was allocated across the wave that admits the 8 requests
    (8 slot resets, 8 prefills through the captured step)."""
    import numpy as np
    import torch

    from repro_torch.launch import serve

    admission = {}
    for name, engine in engines.items():
        rng = np.random.default_rng(1)
        for _ in range(8):
            engine.submit(rng.integers(0, engine.cfg.vocab, size=4).astype(np.int32),
                          max_new_tokens=3 * waves + 4)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        engine.step()  # admits every request
        torch.cuda.synchronize()
        admission[name] = torch.cuda.max_memory_allocated() - base
    wall = {}
    for name, engine in engines.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(waves):
            engine.step()
        torch.cuda.synchronize()
        wall[name] = (time.perf_counter() - t0) * 1e3 / waves
    out = {}
    for name, engine in engines.items():
        prof, _ = serve.profile_waves(engine, waves)
        engine.run_until_done()
        if engine.unfinished_requests() or not prof["device_ms_per_wave"] > 0:
            fail(f"serve_paged: the {name} engine's steady window did not finish "
                 f"or the profiler saw no device time")
        out[name] = {**prof, "wall_ms_per_wave": wall[name],
                     "tokens_per_s": 8 * 1e3 / wall[name],
                     "admission_peak_bytes": admission[name]}
    return out


def phase_serve_paged() -> dict:
    """``serve.run`` on full-width qwen3-0.6b (28 layers, bf16) at 8 slots x
    2048 with the serve phase's requests, from a pool of 896 pages of 64
    KiB: tokens equal to the symmetric serve's, the buffer exactly
    58,785,792 B that never moves, 896 pages live at the peak and none
    after the drain, the page log a valid assignment, every decode step
    a replay holding 28 ``flash_decode_paged`` launches and no
    ``flash_decode``. Then the same requests in blocks of 8 (one host sync
    per block, then again under the decode lint: no findings), and at a
    pool of 448 (no more than 4 slots busy at once, more waves); tokens
    equal throughout. The symmetric engine it is held beside is served
    again here, just before the paged one, so both are timed under the
    same conditions (the serve phase's own numbers, when it ran, are
    reported too); then a steady window on each, timed, and profiled as
    in ``profile``."""
    import numpy as np
    import torch

    from repro_torch.analysis import decode_lint
    from repro_torch.core.shared_objects import from_page_log
    from repro_torch.launch import serve

    sym = serve.run(SERVE_ARGS)
    if SERVE_NUMBERS.get("tokens") not in (None, sym["tokens_per_request"]):
        fail("serve_paged: the symmetric twin served other tokens than the serve phase")
    reset_launches()
    stats = serve.run(SERVE_ARGS + PAGED_ARGS)
    counts = read_launches()
    engine = stats["engine"]
    toks = stats["tokens_per_request"]
    if toks != sym["tokens_per_request"]:
        fail("serve_paged: the paged tokens differ from the symmetric serve's")
    if stats["allocated_bytes"] != PAGED_BUFFER_BYTES:
        fail(f"serve_paged: the pool is {stats['allocated_bytes']} B, expected "
             f"{PAGED_BUFFER_BYTES}")
    if stats["state_ptr_before"] != stats["state_ptr_after"]:
        fail("serve_paged: the pool moved")
    if stats["pages_live_peak"] != PAGE_POOL or stats["state_pages_live"] != 0:
        fail(f"serve_paged: {stats['pages_live_peak']} pages live at the peak, "
             f"{stats['state_pages_live']} after the drain")
    from_page_log(engine.page_log, state_plan=engine.memory_report.state_plan)
    replayed = check_replayed("serve_paged", stats, "flash_decode_paged")
    SERVE_NUMBERS.update(paged_tokens=toks,
                         paged_launches=counts["flash_decode_paged"],
                         paged_cold_start_s=stats["cold_start_s"],
                         paged_state_plan_s=stats["state_plan_s"],
                         paged_capture_calls=stats["capture_calls"])
    if stats["capture_calls"] != 1:
        fail(f"serve_paged: {stats['capture_calls']} graphs captured, expected 1")
    # the pool is smaller than one slot's 1,792 pages: the certifier warns
    # that a max_len request would be refused, as the reference's does
    plan_row("qwen3-0.6b serve_paged (8 slots x 2048, 896 pages of 64 KiB)", stats,
             warnings=("paged-pool-short",))
    twin = sym["engine"]
    launch_ms = {"paged": graph_launch_ms(engine), "symmetric": graph_launch_ms(twin)}
    steady = steady_pair({"paged": engine, "symmetric": twin})
    # each admission's reset gathers only its slot's mapped pages (all 112
    # of them still mapped from the run), never the logical state
    SERVE_NUMBERS.update(paged_device_ms_per_wave=steady["paged"]["device_ms_per_wave"])
    if steady["paged"]["admission_peak_bytes"] > stats["allocated_bytes"]:
        fail(f"serve_paged: admission took {steady['paged']['admission_peak_bytes']} B "
             f"above the allocated, more than the {stats['allocated_bytes']} B pool")
    del engine, twin, sym["engine"]
    # blocks of 8: the same tokens, one host sync per block; then the same
    # requests again under the decode lint
    block = serve.run(SERVE_ARGS + PAGED_ARGS + ["--block-size", "8"])
    if block["tokens_per_request"] != toks:
        fail("serve_paged: the block tokens differ from the host loop's")
    if block["host_syncs"] != block["blocks"]:
        fail(f"serve_paged: {block['host_syncs']} host syncs for {block['blocks']} blocks")
    engine = block["engine"]
    blocks = block["blocks"]
    rng = np.random.default_rng(0)  # serve.run's prompts
    for _ in range(8):
        engine.submit(rng.integers(0, engine.cfg.vocab, size=32).astype(np.int32),
                      max_new_tokens=64)
    again = {}

    def run():
        again.update({r.request_id - 8: r.tokens for r in engine.run_until_done()})

    findings = decode_lint.lint_run(engine, run)
    if findings:
        fail(f"serve_paged: decode lint findings {[f.render() for f in findings]}")
    if again != toks:
        fail("serve_paged: the linted block run served other tokens")
    del engine, block
    # half the pool: at most 4 requests at once, more waves
    half = serve.run(SERVE_ARGS + ["--page-size", str(PAGE_SIZE), "--page-pool",
                                   str(PAGE_POOL // 2)])
    if half["tokens_per_request"] != toks:
        fail("serve_paged: the tokens at a pool of 448 differ")
    busy = max(sum(1 for _, a, f, _ in half["slot_log"] if a <= w <= f)
               for w in range(half["waves"]))
    if busy > 4 or half["waves"] <= stats["waves"]:
        fail(f"serve_paged: {busy} slots busy at once and {half['waves']} waves at "
             f"a pool of 448 ({stats['waves']} at 896)")
    row = {
        "phase": "serve_paged", "arch": "qwen3-0.6b", "layers": stats["n_layers"],
        "page_size": PAGE_SIZE, "page_pool": PAGE_POOL,
        "allocated_bytes": stats["allocated_bytes"],
        "symmetric_state_bytes": stats["state_planned_bytes"],
        "pages_live_peak": stats["pages_live_peak"],
        "requests": stats["requests"], "tokens": stats["tokens"],
        "waves": stats["waves"], "decode_steps": stats["decode_calls"],
        "host_syncs": stats["host_syncs"], "launches": counts, "graphs": replayed,
        **graph_stats(stats), "cold_start_s": stats["cold_start_s"],
        "tokens_per_s": stats["tokens_per_s"],
        "symmetric_tokens_per_s": sym["tokens_per_s"],
        "serve_phase_tokens_per_s": SERVE_NUMBERS.get("tokens_per_s"),
        "serve_phase_device_ms_per_wave": SERVE_NUMBERS.get("device_ms_per_wave"),
        "allocator_step_peak_bytes": stats["allocator_step_peak_bytes"],
        "symmetric_allocator_step_peak_bytes": sym["allocator_step_peak_bytes"],
        "graph_launch_ms": launch_ms, "blocks_of_8": blocks,
        # per steady wave: device ms, wall ms, events; the admitting wave's
        # allocator peak
        **{f"{k}_{name}": steady[name][k] for name in steady for k in (
            "device_ms_per_wave", "wall_ms_per_wave", "tokens_per_s",
            "kernel_launches_per_wave", "admission_peak_bytes")},
        "steady": steady,
        "pool_448": {"waves": half["waves"], "max_slots_busy": busy,
                     "pages_live_peak": half["pages_live_peak"]},
        "tokens_equal_symmetric": True, "decode_lint_findings": 0, "ok": True,
    }
    emit(row)
    del stats, half
    torch.cuda.empty_cache()
    return row


def phase_case(phase: str, case: str, checks: dict, row: dict) -> dict:
    """Emit one row of ``phase`` (serve_bundle, serve_aot, serve_pytree):
    the case's numbers and which of its ``checks`` (name -> passed)
    failed. A failed check fails the run, or under ``--keep-going`` is
    listed and fails it at the phase's end."""
    bad = [name for name, ok in checks.items() if not ok]
    row = {"phase": phase, "case": case, **row, "failed_checks": bad, "ok": not bad}
    emit(row)
    if bad:
        fail_case(case, f"{phase} {case}: failed {bad}")
    return row


def bundle_serve_checks(stats: dict, tokens: dict, kernel: str,
                        launches: int, counts: dict, traces: int = 1) -> dict:
    """What a bundle-served run must show: the twin's tokens, both plans
    from the bundle (no planner call, no state layout, ``traces`` traces:
    1 without a program, the executor's; 0 with one), the buffers fixed,
    the kernel launched as often as the plan-at-construction engine
    launched it, nothing allocated over a replay."""
    return {
        "tokens_equal": stats["tokens_per_request"] == tokens,
        "plan_source_bundle": stats["plan_source"] == "bundle",
        "no_bundle_warning": stats["bundle_warning"] is None,
        "plan_calls_0": stats["plan_calls"] == 0,
        "state_plan_calls_0": stats["state_plan_calls"] == 0,
        f"trace_calls_{traces}": stats["trace_calls"] == traces,
        "state_plan_s_none": stats["state_plan_s"] is None,
        "state_fixed": stats["state_ptr_before"] == stats["state_ptr_after"],
        "arena_fixed": stats["arena_ptr_before"] == stats["arena_ptr_after"],
        f"{kernel}_launches_equal": counts[kernel] == launches,
        "allocator_replay_peak_0": stats["allocator_step_peak_bytes"] == 0,
    }


def aot_checks(stats: dict, entry: str, capture_calls: int) -> dict:
    """What a run served from a bundle's AOT program must show beside
    ``bundle_serve_checks(..., traces=0)``: the program loaded (its one
    entry), no refusal, no trace timed, and as many CUDA graphs captured
    as the engine that traced its step (AOT removes the trace, not the
    capture)."""
    return {
        "aot_loaded": stats["aot_executables"] == [entry],
        "no_aot_warning": stats["aot_warning"] is None,
        "trace_s_none": stats["trace_s"] is None,
        "capture_calls_equal": stats["capture_calls"] == capture_calls,
    }


def serve_twins() -> None:
    """The serve and serve_paged phases' numbers (tokens, launches, cold
    start, captures) from twins served here when those phases did not
    run."""
    from repro_torch.launch import serve

    for prefix, extra, kernel in (("", [], "flash_decode"),
                                  ("paged_", PAGED_ARGS, "flash_decode_paged")):
        if f"{prefix}launches" in SERVE_NUMBERS:
            continue
        reset_launches()
        twin = serve.run(SERVE_ARGS + extra)
        SERVE_NUMBERS.update({
            f"{prefix}tokens": twin["tokens_per_request"],
            f"{prefix}launches": read_launches()[kernel],
            f"{prefix}cold_start_s": twin["cold_start_s"],
            f"{prefix}state_plan_s": twin["state_plan_s"],
            f"{prefix}capture_calls": twin["capture_calls"]})
        if not prefix:
            SERVE_NUMBERS.update(serve_peak_bytes=twin["serve_peak_bytes"],
                                 unified_bytes=twin["plan_total_bytes"]
                                 + twin["state_planned_bytes"])
        del twin


# page size (None: symmetric) -> the qwen3-0.6b bucket compiled with its AOT
# program: {"row" (compile_row), "aot" (its manifest), "plain" (the same
# bundle without the program, published alone), "file" (its bundle)}
QWEN3_BUCKETS: dict = {}
# the phases that serve the compiled qwen3-0.6b buckets
BUCKET_PHASES = ("serve_bundle", "serve_aot", "serve_pytree")
# name -> (process, its directory) of each bucket compiled in the background
# (start_compile)
COMPILES: dict = {}


def _bucket_dir(page) -> str:
    return "paged" if page else "symmetric"


def start_compile(name: str, arch: str, page_size: int | None = None,
                  pool: int | None = None) -> None:
    """Compile the full-width bucket of ``arch`` at 8 slots x 2048 (bf16;
    paged from ``pool`` pages of ``page_size`` bytes where given) with
    ``python -m repro_torch.launch.compile`` (its AOT program packed,
    loaded and linted) into the manifest ``aot`` of a fresh directory under
    ``build/``, in a background process that sees no card
    (``CUDA_VISIBLE_DEVICES`` empty: the compile traces on ``meta``).
    ``finish_compile(name)`` collects it; the run kills it and removes its
    directory if it ends first."""
    import atexit
    import shutil
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="bundles-", dir=ROOT / "build"))
    cmd = [sys.executable, "-m", "repro_torch.launch.compile", "--arch", arch, "--full",
           "--slots", "8", "--max-len", "2048", "--json", "--out", str(root / "aot")]
    if page_size:
        cmd += ["--page-size", str(page_size), "--page-pool", str(pool)]
    proc = subprocess.Popen(
        cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(ROOT / "src")})
    COMPILES[name] = (proc, root)

    def stop() -> None:
        proc.kill()
        proc.wait()
        shutil.rmtree(root, ignore_errors=True)

    atexit.register(stop)


def finish_compile(name: str, *start) -> dict:
    """Wait for the compile ``name`` of ``start_compile`` (started here
    with the arguments ``start`` if this process did not start it):
    ``{"root": its directory, "wall_s": the compile's wall seconds}``,
    which a child process gets as ``CHIP_SMOKE_BUNDLE`` (JSON)."""
    if name not in COMPILES:
        start_compile(name, *start)
    proc, root = COMPILES[name]
    out, err = proc.communicate(timeout=900)
    if proc.returncode:
        fail(f"the compile of {name} exited {proc.returncode}\n"
             f"{out[-2000:]}\n{err[-3000:]}")
    return {"root": str(root), "wall_s": json.loads(out.splitlines()[-1])["wall_s"]}


def start_qwen3_compiles() -> None:
    """The two full-width qwen3-0.6b buckets (symmetric, and paged from
    896 pages of 64 KiB), compiled in the background while the kernel and
    parity phases hold the card; ``main`` starts them when a phase of
    ``BUCKET_PHASES`` runs."""
    for page in (None, PAGE_SIZE):
        start_compile(f"qwen3-0.6b/{_bucket_dir(page)}", "qwen3-0.6b", page, PAGE_POOL)


def qwen3_buckets() -> dict:
    """The buckets of ``start_qwen3_compiles`` (started here if ``main`` did
    not), each compiled with its AOT program (``launch/compile``'s
    default: the program packed behind the lint gate, then loaded and
    audited by ``lint_executables``), and each bundle without its program
    published into another manifest, for serve_bundle, serve_aot and
    serve_pytree."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.artifact import BundleManifest, bucket_key, load_bundle

    if QWEN3_BUCKETS:
        return QWEN3_BUCKETS
    cfg = get_config("qwen3-0.6b")
    for page in (None, PAGE_SIZE):
        given = finish_compile(f"qwen3-0.6b/{_bucket_dir(page)}", "qwen3-0.6b", page,
                               PAGE_POOL)
        root = Path(given["root"])
        key = bucket_key(cfg, n_slots=8, max_len=2048, page_size=page)
        path = root / "aot" / BundleManifest(root / "aot").buckets()[key]["file"]
        BundleManifest(root / "plain").publish(
            key, dataclasses.replace(load_bundle(path), executables=None))
        QWEN3_BUCKETS[page] = {"row": compile_row(given["wall_s"], path),
                               "aot": root / "aot", "plain": root / "plain", "file": path}
    return QWEN3_BUCKETS


def cold_start_after(engine) -> float:
    """Seconds a plan-at-construction twin of ``engine`` (its params,
    bucket and serve configuration) takes to build, right after it served:
    the same point of the run, caches as warm. Built after the launch
    counts were read, then freed."""
    import torch

    from repro_torch.runtime.engine import InferenceEngine

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twin = InferenceEngine(engine.cfg, engine.params, n_slots=engine.n_slots,
                           max_len=engine.max_len, device=engine.device,
                           block_size=engine.block_size, page_size=engine.page_size,
                           page_pool=engine.page_pool)
    seconds = time.perf_counter() - t0
    del twin
    torch.cuda.empty_cache()
    return seconds


def compile_row(wall_s: float, path: Path) -> dict:
    """A compile's wall time, bundle bytes, records and findings (the
    certifier's and the bundle lint's, re-run on the published file: the
    codes of the certifier's warnings and the count of its errors)."""
    from repro_torch.analysis import bundle_lint, soundness
    from repro_torch.core.artifact import load_bundle

    bundle = load_bundle(path)
    certified = soundness.certify_bundle(bundle)
    pack = bundle.executables
    return {"compile_s": wall_s, "bundle_bytes": path.stat().st_size,
            # the AOT program's entries and bytes (the compile packed it,
            # and its gate loaded and linted it)
            "aot_entries": sorted(pack.entries) if pack else [],
            "aot_bytes": pack.nbytes if pack else 0,
            "records": len(bundle.plan.records),
            "state_bytes": bundle.state_plan.total_size,
            "activation_bytes": bundle.plan.total_size,
            "certify_errors": sum(f.severity == "error" for f in certified),
            "certify_warnings": sorted(f.code for f in certified
                                       if f.severity != "error"),
            "lint_findings": len(bundle_lint.lint_bundle_file(path))}


def phase_serve_bundle() -> dict:
    """compile → plan bundle → serve at full width: two qwen3-0.6b buckets
    (8 slots x 2048, bf16; symmetric, and paged from 896 pages of 64 KiB)
    compiled on ``meta`` and published into a manifest, then served
    WITHOUT their AOT programs (``qwen3_buckets``' plain manifest) through
    ``serve.run(... --plan-bundle DIR)``: tokens equal to the
    plan-at-construction serves' (the serve and serve_paged phases', or
    twins served here when those did not run), both plans from the bundle
    (``plan_calls`` and ``state_plan_calls`` 0, ``trace_calls`` 1), the
    state and the arena fixed, as many ``flash_decode`` /
    ``flash_decode_paged`` launches as the twins, the allocator's peak over
    a replay 0 B. Then a planted mismatch: a bundle published for blocks of
    8 handed to a host-loop engine must come back planned at construction
    with the fingerprint-mismatch warning and the same tokens (the check
    reads ``plan_source``, never only the tokens). One row per case."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.compile import compile_and_publish

    cfg = get_config("qwen3-0.6b")
    serve_twins()
    rows = {}
    for case, page in (("compile", None), ("compile_paged", PAGE_SIZE)):
        bucket = qwen3_buckets()[page]
        row = bucket["row"]
        # the pool of 896 cannot map one slot's 1,792 pages: the certifier
        # warns, as on serve_paged's plan row
        rows[case] = phase_case("serve_bundle", case, {
            "certify_errors_0": row["certify_errors"] == 0,
            "certify_warnings_expected": row["certify_warnings"] ==
            (["paged-pool-short"] if page else []),
            "lint_findings_0": row["lint_findings"] == 0,
            "aot_entry": row["aot_entries"] ==
            (["paged_decode"] if page else ["resident_decode"]),
        }, {"arch": cfg.name, "page_size": page, **row})
    for case, extra, kernel, prefix, label in (
            ("serve", [], "flash_decode", "", "qwen3-0.6b serve_bundle"),
            ("serve_paged", PAGED_ARGS, "flash_decode_paged", "paged_",
             "qwen3-0.6b serve_bundle paged")):
        manifest = qwen3_buckets()[PAGE_SIZE if extra else None]["plain"]
        reset_launches()
        stats = serve.run(SERVE_ARGS + extra + ["--plan-bundle", str(manifest)])
        counts = read_launches()
        want = SERVE_NUMBERS[f"{prefix}launches"]
        checks = bundle_serve_checks(stats, SERVE_NUMBERS[f"{prefix}tokens"],
                                     kernel, want, counts)
        checks["no_aot"] = stats["aot_executables"] == [] and stats["trace_s"] > 0
        check_replayed(f"serve_bundle {case}", stats, kernel)
        plan_row(f"{label} (8 slots x 2048, from its bundle)", stats,
                 warnings=("paged-pool-short",) if extra else ())
        built_after = cold_start_after(stats["engine"])
        # timed as the plan-at-construction engine was: the profile
        # phase's window, or serve_paged's steady pair
        steady = (steady_pair({"bundle": stats["engine"]})["bundle"] if extra
                  else steady_profile(f"serve_bundle {case}", stats["engine"]))
        SERVE_NUMBERS.update({f"bundle_{prefix}{k}": stats[k] for k in (
            "cold_start_s", "trace_s", "capture_s", "plan_resolve_s")})
        rows[case] = phase_case("serve_bundle", case, checks, {
            "arch": cfg.name, "page_size": PAGE_SIZE if extra else None,
            "plan_source": stats["plan_source"],
            "bundle_warning": stats["bundle_warning"],
            "trace_calls": stats["trace_calls"], "plan_calls": stats["plan_calls"],
            "state_plan_calls": stats["state_plan_calls"],
            "launches": counts, "launches_plan_at_construction": want,
            "cold_start_s": stats["cold_start_s"],
            "trace_s": stats["trace_s"], "capture_s": stats["capture_s"],
            "plan_resolve_s": stats["plan_resolve_s"],
            "state_plan_s": stats["state_plan_s"],
            # a plan-at-construction engine built right after it, and
            # the twin's (built at another point of the run)
            "cold_start_s_built_after": built_after,
            "cold_start_s_plan_at_construction":
                SERVE_NUMBERS[f"{prefix}cold_start_s"],
            "state_plan_s_plan_at_construction":
                SERVE_NUMBERS[f"{prefix}state_plan_s"],
            "allocator_step_peak_bytes": stats["allocator_step_peak_bytes"],
            "tokens_per_s": stats["tokens_per_s"],
            # a steady window of the bundle's engine, and of the
            # plan-at-construction engine's (profile / serve_paged)
            "device_ms_per_wave": steady["device_ms_per_wave"],
            "device_ms_per_wave_plan_at_construction":
                SERVE_NUMBERS.get(f"{prefix}device_ms_per_wave"),
        })
        del stats
        torch.cuda.empty_cache()
    # a planted mismatch: the bundle of another serve configuration
    # (blocks of 8) published for the same bucket key
    (ROOT / "build").mkdir(exist_ok=True)
    other = Path(tempfile.mkdtemp(prefix="bundles-", dir=ROOT / "build"))
    try:
        compile_and_publish(cfg, str(other), n_slots=8, max_len=2048, block_size=8,
                            aot=False)
        stats = serve.run(SERVE_ARGS + ["--plan-bundle", str(other)])
    finally:
        shutil.rmtree(other, ignore_errors=True)
    warning = stats["bundle_warning"] or ""
    rows["mismatch"] = phase_case("serve_bundle", "mismatch", {
        "plan_source_not_bundle": stats["plan_source"] in ("planned", "cache"),
        "fingerprint_mismatch_warning":
            warning.startswith("plan bundle fingerprint mismatch"),
        "planned_at_construction": stats["plan_calls"] == 1
        and stats["state_plan_calls"] == 1,
        "tokens_equal": stats["tokens_per_request"] == SERVE_NUMBERS["tokens"],
    }, {"arch": cfg.name, "compiled_block_size": 8, "served_block_size": 1,
        "plan_source": stats["plan_source"], "bundle_warning": warning,
        "plan_calls": stats["plan_calls"],
        "state_plan_calls": stats["state_plan_calls"]})
    del stats
    torch.cuda.empty_cache()
    if FAILED_CASES:
        fail(f"serve_bundle: {len(FAILED_CASES)} case(s) failed: {FAILED_CASES}")
    return rows


def phase_serve_aot() -> dict:
    """compile → plan bundle with its AOT decode program → serve: the two
    qwen3-0.6b buckets of ``qwen3_buckets`` (8 slots x 2048, bf16;
    symmetric, and paged from 896 pages of 64 KiB) served from the
    manifest that carries their programs through ``serve.run(...
    --plan-bundle DIR)``: the program loaded (``aot_executables``), and
    ``trace_calls``, ``plan_calls`` and ``state_plan_calls`` 0 over the
    engine's construction, as many captures as the twin's, tokens and
    ``flash_decode`` / ``flash_decode_paged`` launches equal to the
    twins' (8,764), the allocator's peak over a replay 0 B; the cold
    start, its capture seconds, the program's load seconds and the pack's
    bytes beside serve_bundle's engine (which traces once: its trace
    seconds). Then a planted stale pack (another torch version in its
    key) must be refused with the warning, traced once, and serve the
    same tokens (``chip_faults.py``'s ``aot_key_ignored`` must fail
    ``stale``, and only it). One row per case."""
    import torch

    from repro_torch.core.artifact import load_bundle, save_bundle
    from repro_torch.launch import serve

    serve_twins()
    rows = {}
    for case, extra, kernel, prefix, entry in (
            ("serve", [], "flash_decode", "", "resident_decode"),
            ("serve_paged", PAGED_ARGS, "flash_decode_paged", "paged_", "paged_decode")):
        bucket = qwen3_buckets()[PAGE_SIZE if extra else None]
        reset_launches()
        stats = serve.run(SERVE_ARGS + extra + ["--plan-bundle", str(bucket["aot"])])
        counts = read_launches()
        want = SERVE_NUMBERS[f"{prefix}launches"]
        checks = {**bundle_serve_checks(stats, SERVE_NUMBERS[f"{prefix}tokens"],
                                        kernel, want, counts, traces=0),
                  **aot_checks(stats, entry, SERVE_NUMBERS[f"{prefix}capture_calls"])}
        check_replayed(f"serve_aot {case}", stats, kernel)
        plan_row(f"qwen3-0.6b serve_aot{' paged' if extra else ''} (8 slots x 2048, "
                 f"from its bundle's program)", stats,
                 warnings=("paged-pool-short",) if extra else ())
        rows[case] = phase_case("serve_aot", case, checks, {
            "arch": "qwen3-0.6b", "page_size": PAGE_SIZE if extra else None,
            "aot_executables": stats["aot_executables"],
            "trace_calls": stats["trace_calls"], "plan_calls": stats["plan_calls"],
            "state_plan_calls": stats["state_plan_calls"],
            "capture_calls": stats["capture_calls"],
            "capture_calls_plan_at_construction": SERVE_NUMBERS[f"{prefix}capture_calls"],
            "launches": counts, "launches_plan_at_construction": want,
            "cold_start_s": stats["cold_start_s"], "trace_s": stats["trace_s"],
            "capture_s": stats["capture_s"], "aot_load_s": stats["aot_load_s"],
            "plan_resolve_s": stats["plan_resolve_s"],
            "aot_bytes": bucket["row"]["aot_bytes"],
            "bundle_bytes": bucket["row"]["bundle_bytes"],
            "compile_s_with_program": bucket["row"]["compile_s"],
            # serve_bundle's engine: the same bundle without its program
            **{f"{k}_traced": SERVE_NUMBERS.get(f"bundle_{prefix}{k}") for k in (
                "cold_start_s", "trace_s", "capture_s", "plan_resolve_s")},
            "allocator_step_peak_bytes": stats["allocator_step_peak_bytes"],
            "tokens_per_s": stats["tokens_per_s"],
        })
        del stats
        torch.cuda.empty_cache()
    # a planted stale pack: the symmetric bundle with another torch version
    # in its pack's key, served from its file
    bucket = qwen3_buckets()[None]
    bundle = load_bundle(bucket["file"])
    stale = bucket["file"].parent.parent / "stale.json"
    save_bundle(dataclasses.replace(bundle, executables=dataclasses.replace(
        bundle.executables, torch_version="0.0.0+stale")), stale)
    stats = serve.run(SERVE_ARGS + ["--plan-bundle", str(stale)])
    warning = stats["aot_warning"] or ""
    rows["stale"] = phase_case("serve_aot", "stale", {
        "refused_with_warning":
            warning.startswith("AOT executables were compiled under torch 0.0.0+stale"),
        "nothing_loaded": stats["aot_executables"] == [],
        "traced_once": stats["trace_calls"] == 1 and stats["trace_s"] is not None,
        "plans_from_the_bundle": stats["plan_source"] == "bundle"
        and stats["plan_calls"] == 0 and stats["state_plan_calls"] == 0,
        "tokens_equal": stats["tokens_per_request"] == SERVE_NUMBERS["tokens"],
    }, {"arch": "qwen3-0.6b", "aot_warning": warning,
        "aot_executables": stats["aot_executables"],
        "trace_calls": stats["trace_calls"], "plan_source": stats["plan_source"],
        "cold_start_s": stats["cold_start_s"], "trace_s": stats["trace_s"]})
    del stats
    torch.cuda.empty_cache()
    if FAILED_CASES:
        fail(f"serve_aot: {len(FAILED_CASES)} case(s) failed: {FAILED_CASES}")
    return rows


def phase_serve_pytree() -> dict:
    """The residency-off backend at full width: ``serve.run(...
    --no-residency)`` on qwen3-0.6b with the serve mix: the model's step
    run eagerly over the caches ``init_cache`` returns (owned by the
    caching allocator), nothing captured, every ``flash_decode`` launched
    by its wrapper (28 per step); tokens equal to the serve phase's,
    ``state_residency`` false, the caches 939,524,096 B, and the
    allocator's peak over the serve (above what was allocated before the
    engine) beside the resident engine's and its planned arena + state:
    the paper's planned-versus-allocator footprint. Then the paged bucket
    of ``qwen3_buckets`` handed to a residency-off engine: the warning,
    symmetric state of the same bytes, its plans from the bundle (its
    program unused), tokens equal."""
    import warnings

    import torch

    from repro_torch.launch import serve

    serve_twins()
    reset_launches()
    stats = serve.run(SERVE_ARGS + ["--no-residency"])
    counts = read_launches()
    eager = wrapper_launches()
    steps = stats["decode_calls"] * stats["n_layers"]
    checks = {
        "tokens_equal": stats["tokens_per_request"] == SERVE_NUMBERS["tokens"],
        "state_residency_false": stats["state_residency"] is False,
        "live_bytes": stats["state_live_bytes"] == QWEN3_STATE_BYTES,
        "nothing_captured": stats["capture_calls"] == 0 and not stats["graphs"],
        "flash_decode_eager_per_layer": counts["flash_decode"] == steps
        and eager["flash_decode"] == steps,
        "finite_logits": stats["last_logits_finite"],
    }
    plan_row("qwen3-0.6b serve_pytree (8 slots x 2048, residency off: accounting)",
             stats)
    row = {
        "case": "serve", "arch": "qwen3-0.6b", "layers": stats["n_layers"],
        "state_residency": stats["state_residency"],
        "state_live_bytes": stats["state_live_bytes"],
        "launches": counts, "decode_steps": stats["decode_calls"],
        "serve_peak_bytes": stats["serve_peak_bytes"],
        "resident_serve_peak_bytes": SERVE_NUMBERS.get("serve_peak_bytes"),
        # the eager step's own peak (its first step: the caching
        # allocator's first cuBLAS workspace included) beside the arena
        # the plan would give it
        "allocator_step_peak_bytes": stats["allocator_step_peak_bytes"],
        "planned_arena_bytes": stats["plan_total_bytes"],
        "planned_arena_plus_state_bytes": stats["plan_total_bytes"]
        + stats["state_planned_bytes"],
        "resident_planned_arena_plus_state_bytes": SERVE_NUMBERS.get("unified_bytes"),
        "cold_start_s": stats["cold_start_s"], "trace_s": stats["trace_s"],
        "tokens_per_s": stats["tokens_per_s"], "wall_s": stats["wall_s"],
    }
    rows = {"serve": phase_case("serve_pytree", "serve", checks, row)}
    launches = counts["flash_decode"]
    del stats
    torch.cuda.empty_cache()
    manifest = qwen3_buckets()[PAGE_SIZE]["aot"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        stats = serve.run(SERVE_ARGS + PAGED_ARGS + ["--no-residency", "--plan-bundle",
                                                     str(manifest)])
    said = [str(w.message) for w in caught if w.category is RuntimeWarning]
    rows["paged_bundle"] = phase_case("serve_pytree", "paged_bundle", {
        "paged_warning": said == ["paged state requires state residency; serving "
                                  "the symmetric allocator-owned pytree backend "
                                  "instead"],
        "symmetric_state": stats["page_size"] is None
        and stats["state_live_bytes"] == QWEN3_STATE_BYTES,
        "plans_from_the_bundle": stats["plan_source"] == "bundle"
        and stats["plan_calls"] == 0 and stats["state_plan_calls"] == 0,
        "program_unused": stats["aot_executables"] == [],
        "tokens_equal": stats["tokens_per_request"] == SERVE_NUMBERS["tokens"],
    }, {"arch": "qwen3-0.6b", "warnings": said, "plan_source": stats["plan_source"],
        "state_live_bytes": stats["state_live_bytes"],
        "serve_peak_bytes": stats["serve_peak_bytes"]})
    del stats
    torch.cuda.empty_cache()
    if FAILED_CASES:
        fail(f"serve_pytree: {len(FAILED_CASES)} case(s) failed: {FAILED_CASES}")
    return {"launches": launches, **rows}


# qwen3-0.6b's symmetric state at 8 slots x 2048: 28 layers x K and V x
# 8 slots x 2048 x 8 heads x 128 x 2 B
QWEN3_STATE_BYTES = 939_524_096


# the paged serves of every decoder family beyond qwen3: phase -> (arch,
# pool in 64 KiB pages, the buffer it makes, flash_decode_paged launches
# per step). The pools hold the serve mix: 8 requests of 96 positions map
# 2,360 pages each on gemma3 (its 29 rings fully live) and 1,736 on zamba2
PAGED_FAMILIES = {
    "serve_paged_gemma3": ("gemma3-4b", 18_880, 1_237_385_216, 34),
    "serve_paged_zamba2": (ZAMBA2, 13_888, 910_229_504, 13),
}


def start_fresh_process(phase: str, env: dict | None = None) -> subprocess.Popen:
    """Start ``phase`` in a child process of this script (with ``env``
    added to its environment): no torch.profiler session of this process
    precedes its captures (a graph captured after one runs its copy nodes
    on the copy engine), and the child sets what must be set before CUDA
    starts. ``finish_fresh_process`` collects it, and closes its standard
    input when it does (``wait_for_parent``); the run kills it if it ends
    first."""
    import atexit

    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--phases", phase, "--child"],
        cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env={**os.environ, **(env or {})})

    def stop() -> None:
        proc.kill()
        proc.wait()

    atexit.register(stop)
    return proc


def finish_fresh_process(phase: str, proc: subprocess.Popen, note: dict | None = None
                         ) -> dict:
    """Wait for a child of ``start_fresh_process`` and return its row. Its
    ``plan`` rows count as this run's. ``note`` is written to its standard
    input, which is then closed: what the child learns from
    ``wait_for_parent``."""
    try:
        stdout, stderr = proc.communicate(json.dumps(note or {}), timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    row = None
    for line in stdout.splitlines():
        if not line.startswith("{"):
            continue
        r = json.loads(line)
        if r.get("phase") == "plan":
            emit(r)
            CERTIFIED.append(r["plan"])
        elif r.get("phase") == phase:
            row = r
    if proc.returncode != 0 or row is None:
        fail(f"{phase}: its process exited {proc.returncode}\n"
             f"{stdout[-3000:]}\n{stderr[-3000:]}")
    emit(row)
    return row


def wait_for_parent() -> dict:
    """In a child of ``start_fresh_process``: block until the parent
    collects it (``finish_fresh_process``), and return the parent's note."""
    return json.loads(sys.stdin.read() or "{}")


def in_fresh_process(phase: str, env: dict | None = None) -> dict:
    return finish_fresh_process(phase, start_fresh_process(phase, env))


def phase_serve_paged_family(phase: str) -> dict:
    """``serve.run`` on full-width ``arch`` (bf16) at 8 slots x 2048 with
    the serve mix from a pool of 64 KiB pages (``PAGED_FAMILIES``), just
    after a symmetric twin: tokens equal to the twin's, one buffer of
    exactly the pool's bytes that never moves, pages live at the peak and
    none after the drain, a valid page log, every decode step a replay
    holding one ``flash_decode_paged`` launch per attention layer or
    shared-block insertion and no ``flash_decode``, the allocator's peak
    over a replay 0 B; then a steady window on each engine, timed and
    profiled alike (``steady_pair``), with the admission's transient below
    the pool's bytes. Reports the plan's carve and certify seconds and the
    aten ops per step."""
    import torch

    from repro_torch.core.shared_objects import from_page_log
    from repro_torch.launch import serve

    arch, pool, buffer_bytes, per_step = PAGED_FAMILIES[phase]
    args = ["--full", "--arch", arch, "--slots", "8", "--max-len", "2048",
            "--requests", "8", "--prompt-len", "32", "--max-new", "64", "--seed", "0"]
    sym = serve.run(args)
    reset_launches()
    stats = serve.run(args + ["--page-size", str(PAGE_SIZE), "--page-pool", str(pool)])
    counts = read_launches()
    engine = stats["engine"]
    toks = stats["tokens_per_request"]
    if toks != sym["tokens_per_request"] or len(toks) != 8:
        fail(f"{phase}: the paged tokens differ from the symmetric twin's")
    if stats["allocated_bytes"] != buffer_bytes:
        fail(f"{phase}: the pool is {stats['allocated_bytes']} B, expected {buffer_bytes}")
    if stats["state_ptr_before"] != stats["state_ptr_after"]:
        fail(f"{phase}: the pool moved")
    if not 0 < stats["pages_live_peak"] <= pool or stats["state_pages_live"] != 0:
        fail(f"{phase}: {stats['pages_live_peak']} pages live at the peak, "
             f"{stats['state_pages_live']} after the drain")
    if stats["allocator_step_peak_bytes"] != 0:
        fail(f"{phase}: the allocator's peak over a replay is "
             f"{stats['allocator_step_peak_bytes']} B")
    from_page_log(engine.page_log, state_plan=engine.memory_report.state_plan)
    replayed = check_replayed(phase, stats, "flash_decode_paged", per_step=per_step)
    if stats["capture_calls"] != 1:
        fail(f"{phase}: {stats['capture_calls']} graphs captured, expected 1")
    plan_row(f"{arch} {phase} (8 slots x 2048, {pool} pages of 64 KiB)", stats)
    twin = sym["engine"]
    steady = steady_pair({"paged": engine, "symmetric": twin})
    if not steady["paged"]["admission_peak_bytes"] < buffer_bytes:
        fail(f"{phase}: admission took {steady['paged']['admission_peak_bytes']} B "
             f"above the allocated, not below the {buffer_bytes} B pool")
    row = {
        "phase": phase, "arch": arch, "layers": stats["n_layers"],
        "page_size": PAGE_SIZE, "page_pool": pool,
        "allocated_bytes": stats["allocated_bytes"],
        "symmetric_state_bytes": sym["state_planned_bytes"],
        "pages_live_peak": stats["pages_live_peak"],
        "state_pages_live_after": stats["state_pages_live"],
        "flash_decode_paged_per_step": per_step,
        "requests": stats["requests"], "tokens": toks,
        "waves": stats["waves"], "decode_steps": stats["decode_calls"],
        "launches": counts, "graphs": replayed, **graph_stats(stats),
        "allocator_step_peak_bytes": stats["allocator_step_peak_bytes"],
        "symmetric_allocator_step_peak_bytes": sym["allocator_step_peak_bytes"],
        "decode_step_ops": stats["decode_step_ops"],
        "symmetric_decode_step_ops": sym["decode_step_ops"],
        "state_plan_s": stats["state_plan_s"],
        "symmetric_state_plan_s": sym["state_plan_s"],
        "certify_s": stats["startup_lint_s"], "cold_start_s": stats["cold_start_s"],
        "tokens_per_s": stats["tokens_per_s"],
        "symmetric_tokens_per_s": sym["tokens_per_s"],
        **{f"{k}_{name}": steady[name][k] for name in steady for k in (
            "device_ms_per_wave", "wall_ms_per_wave", "tokens_per_s",
            "kernel_launches_per_wave", "admission_peak_bytes")},
        "steady": steady, "tokens_equal_symmetric": True,
    }
    stats.pop("engine")
    del engine, twin, sym
    torch.cuda.empty_cache()
    if arch in BUNDLE_FAMILIES:
        row["bundle"] = serve_family_from_bundle(
            phase, args, pool, stats, counts, steady["paged"]["device_ms_per_wave"])
    row["ok"] = True
    emit(row)
    del stats
    torch.cuda.empty_cache()
    return row


# the paged families also served from a compiled bundle (serve_paged_family)
BUNDLE_FAMILIES = ("gemma3-4b",)


def serve_family_from_bundle(phase: str, args: list, pool: int, stats: dict,
                             counts: dict, device_ms_per_wave: float) -> dict:
    """The paged bucket of ``args``, compiled on ``meta`` with its AOT
    program in the background (``start_compile``: by the parent run beside
    the build, handed over as ``CHIP_SMOKE_BUNDLE``, or here where that is
    unset), and the same bundle without its program published beside it; then the same mix served twice, the
    plan-at-construction engine freed first: from the bundle without its
    program (one trace), then from the bundle with it (no trace). Each
    serve: tokens and ``flash_decode_paged`` launches equal to that
    engine's (``stats``, ``counts``), both plans from the bundle (nothing
    carved: ``state_plan_calls`` 0), the pool fixed, the allocator's peak
    over a replay 0 B; from the program also the program loaded and as
    many captures. Returns the no-program serve's row (the cold start, the
    resolve and the state plan seconds beside the plan-at-construction
    engine's, and the device ms of a steady wave beside that engine's
    ``device_ms_per_wave``) with the program's serve under ``"aot"``."""
    import shutil

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.artifact import BundleManifest, bucket_key, load_bundle
    from repro_torch.launch import serve

    cfg = get_config(args[args.index("--arch") + 1])
    paged_args = args + ["--page-size", str(PAGE_SIZE), "--page-pool", str(pool)]
    want = counts["flash_decode_paged"]
    if "CHIP_SMOKE_BUNDLE" in os.environ:
        given = json.loads(os.environ["CHIP_SMOKE_BUNDLE"])
    else:
        given = finish_compile(phase, cfg.name, PAGE_SIZE, pool)
    root = Path(given["root"])
    try:
        key = bucket_key(cfg, n_slots=8, max_len=2048, page_size=PAGE_SIZE)
        path = root / "aot" / BundleManifest(root / "aot").buckets()[key]["file"]
        compiled = compile_row(given["wall_s"], path)
        BundleManifest(root / "plain").publish(
            key, dataclasses.replace(load_bundle(path), executables=None))
        served = {}
        for name, traces in (("plain", 1), ("aot", 0)):
            reset_launches()
            got = serve.run(paged_args + ["--plan-bundle", str(root / name)])
            got_counts = read_launches()
            checks = bundle_serve_checks(got, stats["tokens_per_request"],
                                         "flash_decode_paged", want, got_counts,
                                         traces=traces)
            if name == "aot":
                checks.update(aot_checks(got, "paged_decode", stats["capture_calls"]))
            checks["certify_and_lint_findings_0"] = not compiled["certify_warnings"] \
                and compiled["certify_errors"] == compiled["lint_findings"] == 0
            check_replayed(f"{phase} bundle {name}", got, "flash_decode_paged",
                           per_step=PAGED_FAMILIES[phase][3])
            if not all(checks.values()):
                fail(f"{phase}: served from its bundle ({name}), failed "
                     f"{[k for k, ok in checks.items() if not ok]}")
            what = "its bundle's program" if name == "aot" else "its bundle"
            plan_row(f"{cfg.name} {phase} (8 slots x 2048, {pool} pages, from {what})",
                     got)
            out = {
                "plan_source": got["plan_source"],
                "trace_calls": got["trace_calls"], "plan_calls": got["plan_calls"],
                "state_plan_calls": got["state_plan_calls"], "launches": got_counts,
                "launches_plan_at_construction": want,
                "cold_start_s": got["cold_start_s"], "trace_s": got["trace_s"],
                "capture_s": got["capture_s"], "capture_calls": got["capture_calls"],
                "aot_executables": got["aot_executables"],
                "aot_load_s": got["aot_load_s"],
                "plan_resolve_s": got["plan_resolve_s"],
                "state_plan_s": got["state_plan_s"],
                "allocator_step_peak_bytes": got["allocator_step_peak_bytes"],
                "tokens_equal": True, "checks": sorted(checks),
            }
            if name == "plain":
                out["cold_start_s_built_after"] = cold_start_after(got["engine"])
                steady = steady_pair({"bundle": got["engine"]})["bundle"]
                out.update({
                    **compiled,
                    "device_ms_per_wave": steady["device_ms_per_wave"],
                    "device_ms_per_wave_plan_at_construction": device_ms_per_wave,
                    "cold_start_s_plan_at_construction": stats["cold_start_s"],
                    "trace_s_plan_at_construction": stats["trace_s"],
                    "capture_s_plan_at_construction": stats["capture_s"],
                    "state_plan_s_plan_at_construction": stats["state_plan_s"]})
            served[name] = out
            del got
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {**served["plain"], "aot": served["aot"]}


# ---------------------------------------------------------------- training

# ssd_chunk_bwd is held to its plain version computed in float64 on the
# same inputs by ``kernels/ref.ssd_chunk_bwd_tolerance`` (fp32 summation
# order, one rounding of a bf16 output; ddA's scale is what it sums). The
# fp32 plain version itself is 1.5-2.2x that bar off float64 on ddA at
# mamba2's shape with the slow decay, measured against |ddA|, and 0.04x
# against ddA's scale.

# single chunks of SSD_CASES: the last chunk of a sequence, whose state
# nothing reads (its upstream state gradient is zero, as autograd passes it)
SSD_BWD_CASES = ("kernels_2", "ragged_L33", "L1", "slow_L200_P8", "two_groups_L96",
                 "N13_L130", "ragged_L65_P32_N40", "train_lm_mamba2")
# the full-width prefill chunks: (arch, label)
SSD_BWD_ARCHS = (("mamba2-2.7b", "mamba2"), (ZAMBA2, "zamba2"))
# the kernel's timings, (arch, label): both prefill chunks (batch 1), and
# mamba2-2.7b's chunk as train_mamba2 calls it (batch 2)
SSD_BWD_TIMED = (*SSD_BWD_ARCHS, ("mamba2-2.7b", "mamba2_train"))
SSD_BWD_TIMING: dict = {}
# train_mamba2's gradients, kernel cores against plain cores, per leaf: max
# |a - b| over max |b|. fp32 (depth cut to 8 layers): the two backwards sum
# in other orders, and A_log's gradient sums ddA, which cancels (see
# ssd_chunk_bwd_scale), over the positions: 1.5e-4 between the plain
# backward and autograd on the CPU (2 layers), where dropping the state
# chain's decayed term moves a leaf by 0.22 at the slow decay. The fp32
# cases are the gate. bf16 (the whole 64-layer model): the cores' outputs
# differ by bf16 roundings (2**-8 of a value) that 64 layers carry into
# every leaf, 0.058 of a leaf's max on an H100; its bar was set above that
# measurement, and the planted state-chain fault passes it, so it detects
# only gross faults (a missing or garbage gradient)
GRAD_BAR = {"float32": 1e-2, "bfloat16": 0.1}
# remat: the same arithmetic run again
REMAT_BAR = 1e-6


def _ssd_bwd_row(label, got, want, control, inputs) -> dict:
    from repro_torch.kernels.ref import ssd_chunk_bwd_tolerance

    x, state = inputs[0], inputs[5]
    L = x.shape[1]
    row = {"phase": "kernels_ssd_bwd", "kernel": "ssd_chunk_bwd", "case": label,
           "shape": list(x.shape) + [inputs[3].shape[-1]],
           "dtype": str(x.dtype).removeprefix("torch."),
           "state_dtype": str(state.dtype).removeprefix("torch.")}
    ok, worst = True, 0.0
    for name, g, w, c in zip(("dx", "ddt", "ddA", "dB", "dC", "dstate"), got, want,
                             control):
        err = (g.double() - w).abs()
        bar_ratio = ssd_chunk_bwd_tolerance(name, g, w, L)
        row[name] = {"max_abs_err": float(err.max()),
                     "control_max_abs_err": float((c.double() - w).abs().max()),
                     "control_err_over_bar": ssd_chunk_bwd_tolerance(name, c, w, L),
                     "max_abs_out": float(w.abs().max()), "err_over_bar": bar_ratio}
        ok = ok and bar_ratio <= 1.0
        worst = max(worst, float(err.max()))
    row["ok"] = ok
    row["max_abs_err"] = worst
    emit(row)
    if not ok:
        fail_case(f"ssd_chunk_bwd/{label}/{row['dtype']}/{row['state_dtype']}",
                  f"ssd_chunk_bwd {label}: error over its bar ({row})")
    return row


def phase_kernels_ssd_bwd(card_name: str) -> dict:
    """ssd_chunk_bwd against ssd_chunk_bwd_ref computed in float64 on the
    same inputs (the plain version in the working dtypes as the control),
    with random upstream gradients: single chunks (SSD_BWD_CASES in every dtype pair, and the
    prefill chunks of mamba2-2.7b, one group at head stride 0, and
    zamba2-7b, two groups repeated over their heads, in fp32 and bf16) and,
    at those two shapes, chains of 2 chunks at the slow decay with a random
    gradient of the last state: the second chunk's dstate is the first
    chunk's upstream state gradient (the chained cases). Then the autograd
    of repro_torch::ssd_chunk over the chain (fp32) against torch.autograd
    of ssd_chunk_ref in float64, and the kernel timed beside its bound, the
    plain version and its CTAs per SM at both prefill shapes and at
    train_mamba2's call (mamba2's chunk at batch 2, checked first)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels.ref import ssd_chunk_bwd_ref, ssd_chunk_bwd_tolerance, \
        ssd_chunk_ref
    from repro_torch.launch.roofline import kernel_bound
    from repro_torch.models.ssm import _heads, ssm_dims

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(3)

    def randn_like(t):
        return (torch.randn(t.shape, generator=gen, device=DEVICE) * 0.5).to(t.dtype)

    def check(label, inputs, dy, dns):
        got = sc.ssd_chunk_bwd(*inputs, dy, dns)
        want = ssd_chunk_bwd_ref(*(t.double() for t in (*inputs, dy, dns)))
        control = ssd_chunk_bwd_ref(*inputs, dy, dns)
        torch.cuda.synchronize()
        return got, _ssd_bwd_row(label, got, want, control, inputs)

    for x_dtype, state_dtype in SSD_DTYPES:
        for label in SSD_BWD_CASES:
            shape, decay, groups = SSD_CASES[label]
            inputs = ssd_inputs(gen, *shape, decay, groups, x_dtype, state_dtype)
            check(label, inputs, randn_like(inputs[0]), torch.zeros_like(inputs[5]))

    record = {}
    for arch, name in SSD_BWD_ARCHS:
        cfg = get_config(arch)
        _, H, _ = ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim,
                           cfg.ssm_groups, cfg.ssm_state)
        P, N, G, L = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups, 256
        for dt_name in ("float32", "bfloat16"):
            inputs = ssd_inputs(gen, 1, L, H, P, N, "original", G, dt_name, dt_name)
            dy = randn_like(inputs[0])
            _, row = check(f"{name}_prefill", inputs, dy, torch.zeros_like(inputs[5]))
            if dt_name == "bfloat16":
                record[name] = (row, inputs, dy)
            # the chain: two chunks of one (B, 2L) draw, sliced as the model
            # slices its conv output
            x, dt, dA, Bm, Cm, state0 = ssd_inputs(gen, 1, 2 * L, H, P, N, "slow", G,
                                                   dt_name, dt_name)
            c1 = [t[:, :L] for t in (x, dt, dA, Bm, Cm)]
            c2 = [t[:, L:] for t in (x, dt, dA, Bm, Cm)]
            _, state1 = sc.ssd_chunk(*c1, state0)
            dy1, dy2 = randn_like(c1[0]), randn_like(c2[0])
            got2, _ = check(f"chain_{name}_chunk2", (*c2, state1), dy2,
                            randn_like(state0))
            check(f"chain_{name}_chunk1", (*c1, state0), dy1, got2[5])

        # autograd of the op over the chain against autograd of the plain
        # version, fp32; B and C drawn per group and broadcast as the model
        # does, so their gradients sum over the heads
        x, dt, dA, Bm, Cm, state0 = (t.detach() for t in ssd_inputs(
            gen, 1, 2 * L, H, P, N, "slow", G, "float32", "float32"))
        leaves = [t.clone().requires_grad_() for t in (x, dt, dA, state0)]
        groups = [t[:, :, ::H // G].clone().requires_grad_() for t in (Bm, Cm)]
        dys = [randn_like(x[:, :L]), randn_like(x[:, L:])]
        dns = randn_like(state0)

        def loss(core, dtype=torch.float32):
            xx, ddt, ddA, st = (t.to(dtype) for t in leaves)
            Bh, Ch = (_heads(g.to(dtype), H) for g in groups)
            total, s = 0.0, st
            for c in range(2):
                sl = slice(c * L, (c + 1) * L)
                y, s = core(xx[:, sl], ddt[:, sl], ddA[:, sl], Bh[:, sl], Ch[:, sl], s)
                total = total + (y * dys[c].to(dtype)).sum()
            return total + (s * dns.to(dtype)).sum()

        wrt = [*leaves, *groups]
        got = torch.autograd.grad(loss(sc.ssd_chunk), wrt)
        want = torch.autograd.grad(loss(ssd_chunk_ref, torch.float64), wrt)
        torch.cuda.synchronize()
        row = {"phase": "kernels_ssd_bwd", "kernel": "ssd_chunk_bwd",
               "case": f"chain_{name}_autograd", "dtype": "float32",
               "state_dtype": "float32", "groups": G}
        ok = True
        for leaf, g, w in zip(("x", "dt", "dA", "state", "B", "C"), got, want):
            ratio = ssd_chunk_bwd_tolerance(leaf, g, w, L)
            row[leaf] = {"max_abs_err": float((g.double() - w).abs().max()),
                         "max_abs_out": float(w.abs().max()), "err_over_bar": ratio}
            ok = ok and ratio <= 1.0
        row["ok"] = ok
        emit(row)
        if not ok:
            fail_case(f"ssd_chunk_bwd/{row['case']}/float32/float32",
                      f"ssd_chunk_bwd: autograd over the chain off its bar ({row})")

    # train_mamba2's call: mamba2's chunk at batch 2
    cfg = get_config("mamba2-2.7b")
    _, H, _ = ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim,
                       cfg.ssm_groups, cfg.ssm_state)
    inputs = ssd_inputs(gen, 2, 256, H, cfg.ssm_head_dim, cfg.ssm_state, "original",
                        cfg.ssm_groups, "bfloat16", "bfloat16")
    dy = randn_like(inputs[0])
    _, row = check("mamba2_train", inputs, dy, torch.zeros_like(inputs[5]))
    record["mamba2_train"] = (row, inputs, dy)

    # timing at the prefill chunks and the training call, bf16, as the
    # training path calls it
    for arch, name in SSD_BWD_TIMED:
        row, inputs, dy = record[name]
        dns = randn_like(inputs[5])
        B, L, H, P = inputs[0].shape
        N = inputs[3].shape[-1]
        G = get_config(arch).ssm_groups
        before = sc.BWD_LAUNCHES
        ms = cuda_time_ms(lambda: sc.ssd_chunk_bwd(*inputs, dy, dns))
        plain_ms = cuda_time_ms(lambda: ssd_chunk_bwd_ref(*inputs, dy, dns))
        sc.BWD_LAUNCHES = before  # timing launches are not the main path's
        # B and C read as the call holds them: one group at head stride 0 is
        # one group's bytes, repeat_interleave makes a copy per head
        shape = {"B": B, "L": L, "H": H, "P": P, "N": N, "dtype": "bfloat16",
                 "state_dtype": "bfloat16"}
        bound = kernel_bound("ssd_chunk_bwd", {**shape, "groups": 1 if G == 1 else H},
                             card_name=card_name)
        timing = {"phase": "kernels_ssd_bwd", "kernel": "ssd_chunk_bwd",
                  "timing": name, "arch": arch, "shape": [B, L, H, P, N],
                  "groups": G, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                  "library": "none: no one PyTorch call computes it",
                  "bound_ms": bound.bound_s * 1e3, "bound_by": bound.bound_by,
                  "bytes": bound.min_bytes, "flops": bound.flops,
                  "bytes_ms": bound.bytes_s * 1e3,
                  "bf16_tensor_core_ms": bound.ops_s * 1e3,
                  "fp32_cuda_core_ms": kernel_bound("ssd_chunk_bwd", {
                      "B": B, "L": L, "H": H, "P": P, "N": N, "dtype": "float32"},
                      card_name=card_name).ops_s * 1e3,
                  "max_abs_err": row["max_abs_err"],
                  "ctas": B * H * (2 * (((L + 63) // 64 + 1) // 2) + (2 if P == 64 else 1)),
                  "ctas_per_sm": sc.bwd_ctas_per_sm(P, N, torch.bfloat16, torch.bfloat16),
                  "workspace_bytes": sc.bwd_workspace_bytes(B, H, torch.bfloat16)}
        if G > 1:
            per_group = kernel_bound("ssd_chunk_bwd", {**shape, "groups": G},
                                     card_name=card_name)
            timing["bound_ms_if_b_c_read_per_group"] = per_group.bound_s * 1e3
            timing["bytes_if_b_c_read_per_group"] = per_group.min_bytes
        emit(timing)
        SSD_BWD_TIMING[name] = timing
    return SSD_BWD_TIMING["mamba2"]


def _bits_equal(a, b) -> bool:
    import torch

    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def phase_train(card_name: str) -> dict:
    """Full-width qwen3-0.6b trained by ``launch/train.run_training``
    (seq_len 512, batch 4, 8 AdamW steps, weights from
    ``torch.Generator().manual_seed(0)``), in a fresh process of this
    script under ``torch.use_deterministic_algorithms`` (cuBLAS's
    workspace fixed before CUDA starts): the losses finite and the last
    below the first, grad_norm and lr per step, steps/s and tokens/s, the
    allocator's peak beside params + grads + moments; and 4 steps that
    save a checkpoint at step 4 (the restored tensors bitwise equal to the
    saved ones) and a run resumed from it to step 8, its losses within the
    reference's 1e-4 of the uninterrupted run's. The resume runs first,
    beside the parent's kernel build; the uninterrupted, timed run waits
    until the parent has built (``wait_for_parent``), so no nvcc shares
    the host with its steps."""
    import shutil

    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import get_config
    from repro_torch.launch.roofline import count_params
    from repro_torch.launch.train import run_training
    from repro_torch.models.api import for_config
    from repro_torch.tree_util import leaves

    torch.use_deterministic_algorithms(True)
    arch, kw = "qwen3-0.6b", dict(reduced=False, seq_len=512, batch=4, log_every=1)
    cfg = get_config(arch)
    n_params = sum(t.numel() for t in leaves(for_config(cfg, "meta").init(None)))
    path = ROOT / "build" / "train_ckpt" / "qwen3"
    saved = {}
    first4 = run_training(arch, steps=4, ckpt_path=str(path), save_every=4, out=saved, **kw)
    like = (saved["params"], saved["opt_state"])
    t0 = time.perf_counter()
    restored, meta = ckpt.restore(str(path), like)
    restore_s = time.perf_counter() - t0
    bitwise = all(_bits_equal(a, b) for a, b in zip(leaves(restored), leaves(like)))
    ckpt_bytes = (path.parent / "qwen3.npz").stat().st_size
    del saved, like, restored
    resumed = run_training(arch, steps=8, ckpt_path=str(path), **kw)
    shutil.rmtree(path.parent, ignore_errors=True)
    note = wait_for_parent()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    full = run_training(arch, steps=8, **kw)
    peak = torch.cuda.max_memory_allocated() - base
    walls = [h["wall_s"] for h in full]
    steady = statistics.median(walls[1:])
    diffs = [abs(a["loss"] - b["loss"]) for a, b in zip(full[4:], resumed)]
    losses = [h["loss"] for h in full]
    reckoned = n_params * (2 + 2 + 8)
    checks = {
        "losses_finite": all(math.isfinite(x) for x in losses),
        "loss_falls": losses[-1] < losses[0],
        "restored_bitwise": bitwise,
        "meta_step_4": meta == {"step": 4},
        "resumed_steps": len(resumed) == 4,
        "resumed_within_1e-4": bool(diffs) and max(diffs) < 1e-4,
    }
    row = {"phase": "train", "arch": arch, "seq_len": 512, "batch": 4, "steps": 8,
           "card": card_name, "deterministic": True,
           "loss": losses, "ce": [h["ce"] for h in full],
           "grad_norm": [h["grad_norm"] for h in full], "lr": [h["lr"] for h in full],
           "step_wall_s": walls, "steps_per_s": 1.0 / steady,
           # the kernel build (when this run has one) ended before the
           # timed steps began; the bucket compiles (no card) still running
           "timed_after_build": note.get("built_before", False),
           "background_compiles_at_timing": note.get("background_compiles"),
           "tokens_per_s": 4 * 512 / steady,
           "peak_allocated_bytes": peak, "params": n_params,
           "count_params": count_params(cfg),
           "reckoned_params_grads_moments_bytes": reckoned,
           "peak_over_reckoned": peak / reckoned,
           "checkpoint_bytes": ckpt_bytes, "restore_s": restore_s,
           "first_four_loss": [h["loss"] for h in first4],
           "resumed_loss": [h["loss"] for h in resumed],
           "resume_max_abs_diff": max(diffs) if diffs else None,
           "checks": checks, "ok": all(checks.values())}
    emit(row)
    if not row["ok"]:
        fail(f"train: checks failed: {[k for k, v in checks.items() if not v]}")
    return row


def _grad_gap(got, want) -> dict:
    """Per leaf of two grads trees: max |got - want| over max |want|."""
    from repro_torch.core.unified import iter_leaves

    gaps = {}
    for (path, g), (_, w) in zip(iter_leaves(got), iter_leaves(want)):
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        gaps[path] = err / scale if scale > 0 else err
    return gaps


def profile_train_step(step_fn, params, opt_state, batch, steady_s: float
                       ) -> tuple[dict, object, object]:
    """One train step under ``torch.profiler`` (host clock around it,
    synchronised): device time by kernel name, ``ssd_chunk_bwd``'s and
    ``ssd_chunk``'s device time, launches and shares, and the idle share,
    1 - device time over the profiled step's wall and over ``steady_s``,
    the unprofiled steps' median. One stream, so the device times do not
    overlap. Returns the summary and the stepped params and state."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)

    def of(pred):
        chosen = [e for e in events if pred(e.key)]
        return (sum(e.self_device_time_total for e in chosen) / 1e3,
                sum(e.count for e in chosen))

    bwd_ms, bwd_n = of(lambda k: "ssd_chunk_bwd" in k)
    fwd_ms, fwd_n = of(lambda k: "ssd_chunk_" in k and "bwd" not in k)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    return {"loss": loss, "wall_s": wall, "steady_wall_s": steady_s,
            "device_ms": device_us / 1e3, "device_events": sum(e.count for e in events),
            "idle_share": 1 - device_us / 1e6 / wall,
            "idle_share_of_steady_step": 1 - device_us / 1e6 / steady_s,
            "ssd_chunk_bwd_ms": bwd_ms, "ssd_chunk_bwd_launches": bwd_n,
            "ssd_chunk_bwd_share_of_device": bwd_ms * 1e3 / device_us,
            "ssd_chunk_bwd_share_of_step": bwd_ms / 1e3 / wall,
            "ssd_chunk_ms": fwd_ms, "ssd_chunk_launches": fwd_n,
            "top_kernels_ms": {e.key[:100]: e.self_device_time_total / 1e3 for e in top},
            "top_kernels_count": {e.key[:100]: e.count for e in top}}, params, opt_state


def phase_train_mamba2(card_name: str) -> dict:
    """Full-width mamba2-2.7b (64 layers, bf16) trained on the card through
    ``ssd_chunk`` and its hand-written backward: seq_len 512 (2 chunks of
    256, so the state gradient crosses a chunk), batch 2. First the
    gradients of one step on the kernel cores against the same model on
    ``cores="plain"`` (same params and batch), per leaf (``GRAD_BAR``): in
    fp32 with the depth cut to 8 layers, at the random init's decay and,
    for a gradient that crosses two chunk boundaries through a decay that
    keeps it, at the slow decay over 3 chunks (768 tokens, batch 1); then
    the trained model itself, bf16 and 64 layers. Then 4 AdamW steps with
    the launches of both kernels
    read per step from the wrappers' counts (64 layers x 2 chunks = 128
    forward and 128 backward), losses finite, the allocator's peak beside
    params + grads + moments; then the same step with ``remat=True`` gives
    the remat-off loss and gradients (each period's forward run again in
    the backward: 256 forward launches)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.train import make_batch, make_loss_fn, make_train_step, \
        value_and_grad
    from repro_torch.models.api import DecoderModel
    from repro_torch.optim import adamw
    from repro_torch.tree_util import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mamba2-2.7b")
    kernel, plain = DecoderModel(cfg, DEVICE), DecoderModel(cfg, DEVICE, cores="plain")
    params = kernel.init(torch.Generator(device=DEVICE).manual_seed(0))
    n_params = sum(t.numel() for t in leaves(params))

    def batch_of(seq_len, batch, step=0):
        pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                        global_batch=batch))
        return make_batch(cfg, pipe.batch_at(step), DEVICE)

    # ---- the gradients, kernel cores against plain cores: the fp32 model
    # cut to 8 layers at the random init's decay (2 chunks) and at the slow
    # one (3 chunks: the state gradient crosses two chunk boundaries and
    # keeps its size), then the trained model itself (bf16, 64 layers)
    grad_rows = {}
    cut = dataclasses.replace(cfg, n_periods=8, dtype="float32")
    for label, seq_len, batch, dtype in (("grads_fp32", 512, 2, "float32"),
                                         ("grads_fp32_slow", 768, 1, "float32"),
                                         ("grads_bf16", 512, 2, "bfloat16")):
        if dtype == "float32":
            cores = [DecoderModel(cut, DEVICE, cores=c) for c in ("kernel", "plain")]
            p = cores[0].init(torch.Generator(device=DEVICE).manual_seed(1))
            if label.endswith("_slow"):
                slow_decay(p)
        else:
            cores, p = [kernel, plain], params
        b = batch_of(seq_len, batch)
        reset_launches()
        loss_k, _, g_k = value_and_grad(make_loss_fn(cores[0], remat=False), p, b)
        counts = read_launches()
        loss_p, _, g_p = value_and_grad(make_loss_fn(cores[1], remat=False), p, b)
        torch.cuda.synchronize()
        gaps = _grad_gap(g_k, g_p)
        del g_k, g_p
        worst = max(gaps, key=gaps.get)
        want_launches = cores[0].cfg.n_layers * (seq_len // 256)
        bar = GRAD_BAR[dtype]
        row = {"phase": "train_mamba2", "kernel": "ssd_chunk_bwd",
               "case": f"train_mamba2_{label}", "dtype": dtype,
               "layers": cores[0].cfg.n_layers, "seq_len": seq_len, "batch": batch,
               "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
               "launches": {"ssd_chunk": counts["ssd_chunk"],
                            "ssd_chunk_bwd": counts["ssd_chunk_bwd"]},
               "worst_leaf": worst, "worst_gap": gaps[worst], "bar": bar,
               "gaps": gaps}
        row["ok"] = (gaps[worst] <= bar
                     and counts["ssd_chunk"] == counts["ssd_chunk_bwd"] == want_launches
                     and math.isfinite(row["loss_kernel"]))
        emit(row)
        grad_rows[label] = row
        if not row["ok"]:
            fail_case(f"train_mamba2_{label}/{dtype}", f"train_mamba2 {label}: {row}")
        del p
        torch.cuda.empty_cache()

    # ---- 4 AdamW steps
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=4)
    opt_state = adamw.init_state(params)
    step_fn = make_train_step(kernel, opt_cfg, remat=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    steps = []
    reset_launches()
    for step in range(4):
        b = batch_of(512, 2, step)
        before = read_launches()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, b)
        metrics = {k: float(v) for k, v in metrics.items()}
        wall = time.perf_counter() - t0
        after = read_launches()
        steps.append({**metrics, "wall_s": wall,
                      "ssd_chunk": after["ssd_chunk"] - before["ssd_chunk"],
                      "ssd_chunk_bwd": after["ssd_chunk_bwd"] - before["ssd_chunk_bwd"]})
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    # ---- one step under torch.profiler; no phase after this one captures a
    # graph, whose copies a profiler session would move onto the copy engine
    walls = [s["wall_s"] for s in steps]
    steady = statistics.median(walls[1:])
    profiled, params, opt_state = profile_train_step(step_fn, params, opt_state,
                                                     batch_of(512, 2, 5), steady)
    # ---- remat: the same loss and gradients
    b = batch_of(512, 2, 4)
    loss_off, _, g_off = value_and_grad(make_loss_fn(kernel, remat=False), params, b)
    before = read_launches()
    loss_on, _, g_on = value_and_grad(make_loss_fn(kernel, remat=True), params, b)
    after = read_launches()
    remat_gap = max(_grad_gap(g_on, g_off).values())
    del g_on, g_off
    reckoned = n_params * (2 + 2 + 8)
    checks = {
        "losses_finite": all(math.isfinite(s["loss"]) for s in steps),
        "launches_per_step": all(s["ssd_chunk"] == 128 and s["ssd_chunk_bwd"] == 128
                                 for s in steps),
        "remat_loss_equal": float(loss_on) == float(loss_off),
        "remat_grads": remat_gap <= REMAT_BAR,
        "remat_launches": (after["ssd_chunk"] - before["ssd_chunk"] == 256
                           and after["ssd_chunk_bwd"] - before["ssd_chunk_bwd"] == 128),
    }
    row = {"phase": "train_mamba2", "arch": "mamba2-2.7b", "seq_len": 512, "batch": 2,
           "card": card_name, "steps": steps, "step_wall_s": walls,
           "steps_per_s": 1.0 / steady, "tokens_per_s": 2 * 512 / steady,
           "launches": {"ssd_chunk": launches["ssd_chunk"],
                        "ssd_chunk_bwd": launches["ssd_chunk_bwd"]},
           "peak_allocated_bytes": peak, "allocated_before_steps": base,
           "params": n_params, "reckoned_params_grads_moments_bytes": reckoned,
           "peak_over_reckoned": peak / reckoned,
           "remat": {"loss": float(loss_on), "loss_off": float(loss_off),
                     "max_grad_gap": remat_gap,
                     "ssd_chunk": after["ssd_chunk"] - before["ssd_chunk"],
                     "ssd_chunk_bwd": after["ssd_chunk_bwd"] - before["ssd_chunk_bwd"]},
           "grad_checks": {k: v["ok"] for k, v in grad_rows.items()},
           "profile": profiled, "checks": checks, "ok": all(checks.values())}
    emit(row)
    if not row["ok"]:
        fail(f"train_mamba2: checks failed: {[k for k, v in checks.items() if not v]}")
    del params, opt_state
    torch.cuda.empty_cache()
    return row


def phase_train_seamless(card_name: str) -> dict:
    """Full-width seamless-m4t-medium (12 encoder + 12 decoder layers,
    bf16) trained 2 steps by ``run_training``: seq_len 512 with zero
    frames at 512 // 4 = 128, batch 2. Losses finite, every parameter
    leaf updated but those of the encoder and the cross-attention, which
    zero frames leave without a gradient; with seeded random frames every
    leaf gets one; the parameter count against the reference's
    (``count_params``: 715,339,776; the tree adds its 63,488 norm
    scales)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch.roofline import count_params
    from repro_torch.launch.train import run_training
    from repro_torch.models.api import for_config
    from repro_torch.tree_util import leaves

    from repro_torch.core.unified import iter_leaves
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.train import make_batch, make_loss_fn, value_and_grad

    arch = "seamless-m4t-medium"
    cfg = get_config(arch)
    first = for_config(cfg, DEVICE).init(torch.Generator().manual_seed(0))
    n_params = sum(t.numel() for t in leaves(first))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = {}
    hist = run_training(arch, steps=2, reduced=False, seq_len=512, batch=2,
                        log_every=1, out=out)
    peak = torch.cuda.max_memory_allocated() - base
    # zero frames (the stub frontend's, as the reference feeds them) give
    # the encoder and the cross-attention no gradient, and bf16 rounds
    # their weight decay (lr·wd = 2e-5 of a value) away: those leaves may
    # stay, every other one moves
    still = [path for (path, a), b in zip(iter_leaves(first), leaves(out["params"]))
             if torch.equal(a, b)]
    del first
    cut = ("['enc']", "['ln_enc']", "['dec']['xattn']", "['dec']['ln_x']")
    # with seeded random frames every leaf gets a finite, nonzero gradient
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=2))
    b = make_batch(cfg, pipe.batch_at(0), DEVICE)
    b["frames"] = torch.randn(b["frames"].shape, device=DEVICE,
                              generator=torch.Generator(device=DEVICE).manual_seed(0)
                              ).to(b["frames"].dtype)
    _, _, grads = value_and_grad(make_loss_fn(for_config(cfg, DEVICE), remat=False),
                                 out["params"], b)
    no_grad = [path for path, g in iter_leaves(grads)
               if not (bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0)]
    del grads
    losses = [h["loss"] for h in hist]
    checks = {"losses_finite": all(math.isfinite(x) for x in losses),
              "params_updated": all(p.startswith(cut) for p in still),
              "every_leaf_has_a_gradient_with_random_frames": no_grad == [],
              "count_params": count_params(cfg) == 715_339_776}
    row = {"phase": "train_seamless", "arch": arch, "seq_len": 512, "frames": 128,
           "batch": 2, "card": card_name, "loss": losses,
           "grad_norm": [h["grad_norm"] for h in hist], "lr": [h["lr"] for h in hist],
           "step_wall_s": [h["wall_s"] for h in hist], "params": n_params,
           "count_params": count_params(cfg),
           "leaves": len(leaves(out["params"])), "leaves_unchanged": still,
           "leaves_without_gradient_with_random_frames": no_grad,
           "peak_allocated_bytes": peak,
           "reckoned_params_grads_moments_bytes": n_params * 12,
           "checks": checks, "ok": all(checks.values())}
    emit(row)
    if not row["ok"]:
        fail(f"train_seamless: checks failed: {[k for k, v in checks.items() if not v]}")
    del out
    torch.cuda.empty_cache()
    return row


# the multi-device phases (ROADMAP A15.2): each in a child process of its
# own, since a process has one default process group
DRYRUN_ROWS = (("nemotron-4-340b", "decode_32k"),
               ("llama4-maverick-400b-a17b", "decode_32k"),
               ("qwen3-0.6b", "train_4k"))
MESH_PHASES = ("dryrun", "sharded", "rank_of_256")


# the reference's per-leaf param specs at (data=16, model=16) of the
# DRYRUN_ROWS archs, frozen as data (tests/test_torch_mesh.py holds the
# file against the JAX reference's own rules)
REFERENCE_SPECS = ROOT / "tests" / "data" / "reference_param_specs_16x16.json"
ITEMSIZE = {"bfloat16": 2, "float32": 4, "int32": 4}
# a row's planned activations and peak must fit one 80 GB card
ROW_LIMIT_GB = 80.0


def reference_param_bytes(arch: str, sizes: dict) -> int:
    """One rank's param bytes at full width under the reference's specs
    (``REFERENCE_SPECS``), summed leaf by leaf here: rank 0's shard of
    each leaf (a dim split k ways keeps ceil(n / k)) times its item size.
    Nothing of the port's rules enters it."""
    total = 0
    for _path, shape, dtype, spec in json.loads(REFERENCE_SPECS.read_text())[arch]:
        n = 1
        for dim, e in zip(shape, spec):
            axes = [] if e is None else [e] if isinstance(e, str) else e
            n *= -(-dim // math.prod(sizes[a] for a in axes))
        total += n * ITEMSIZE[dtype]
    return total


def phase_dryrun() -> dict:
    """``launch/dryrun.run_one`` at (data=16, model=16) with the activation
    plan, in a child process that sees no card (``CUDA_VISIBLE_DEVICES``
    empty; the fake group stands for the 256 ranks): nemotron-4-340b and
    llama4-maverick-400b-a17b decode_32k, qwen3-0.6b train_4k. Each row
    must be ``ok`` without a planner error, with collective bytes above 0
    and its per-device param bytes equal to ``reference_param_bytes`` (the
    reference's specs, frozen in the checkout); each row's planned
    activations and peak must stay under ``ROW_LIMIT_GB``, and the train
    row must recompute its periods (``remat``, as the reference's dry
    run). Where qwen3's 8 K/V heads do not divide model = 16, q is split
    on heads and K/V on T, and the softmax and the PV product reduce
    across the ranks, so the train row's plan is a device's need."""
    from repro_torch.launch.dryrun import run_one

    rows, ok = [], True
    for arch, shape in DRYRUN_ROWS:
        row = run_one(arch, shape, activation_plan=True)
        want = reference_param_bytes(arch, {"data": 16, "model": 16})
        checks = {"status_ok": row.get("status") == "ok",
                  "no_planner_error": "planner_error" not in row,
                  "param_bytes_are_the_references": row.get("param_bytes") == want,
                  "collectives": row.get("coll_gb", 0) > 0}
        checks["planned_act_under_limit"] = \
            row.get("planned_act_gb", math.inf) < ROW_LIMIT_GB
        checks["peak_under_limit"] = row.get("peak_mem_gb", math.inf) < ROW_LIMIT_GB
        if shape.startswith("train"):
            checks["remat"] = row.get("remat") is True
        ok &= all(checks.values())
        rows.append({**{k: row.get(k) for k in (
            "arch", "shape", "mesh", "status", "error", "wall_s", "param_bytes",
            "param_gb", "opt_gb", "cache_gb", "batch_gb", "arg_gb", "planned_act_gb",
            "peak_mem_gb", "attention_core", "hlo_gflops", "hbm_gb", "coll_gb",
            "collective_counts", "collective_bytes_by_kind", "compute_s", "memory_s",
            "collective_s", "dominant", "model_flops_ratio", "graph_nodes",
            "planner_total_gb", "planner_lb_gb", "planner_naive_gb", "planner_strategy",
            "state_total_gb", "state_live_gb", "planner_error", "remat",
            "largest_tensors")},
            "param_bytes_reference": want, "checks": checks, "representative": True})
    row = {"phase": "dryrun", "mesh": "16x16", "rows": rows, "ok": ok}
    emit(row)
    if not ok:
        fail(f"dryrun: {[(r['arch'], r['checks']) for r in rows]}")
    return row


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _parity(got, want) -> dict:
    """PERF.md §2's parity rule: bit for bit expected, else within 1e-6."""
    import torch

    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    return {"bit_equal": equal, "max_abs_err": err, "ok": equal or err <= 1e-6}


def phase_sharded(card_name: str) -> dict:
    """The sharded steps of ``launch/dryrun.build_step`` on the card: NCCL,
    world 1, a (data=1, model=1) mesh, DTensors over real full-width
    tensors from a seed. qwen3-0.6b, 8 slots x 2048 positions (a cache
    filled from the seed, the slots at their own positions, one inactive):
    4 decode steps, each 28 ``flash_decode`` launches through the op's
    sharding rule (its 8 K/V heads divide model = 1, so the kernel runs);
    mamba2-2.7b: one 2048-token prefill, 512 ``ssd_chunk`` launches (64
    layers x 8 chunks); the train step with remat (``sharded_train``) on
    qwen3-0.6b and on mamba2-2.7b cut to 8 layers. Each against the
    unsharded eager step on the same inputs by PERF.md §2's parity rule;
    the eager twins' launches are counted apart."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch.dryrun import build_step, cores_taken
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models import attention
    from repro_torch.models.api import ShapeSpec, for_config
    from repro_torch.tree_util import leaves

    mesh = init_mesh((1, 1), ("data", "model"), "cuda",
                     init_method=f"tcp://localhost:{_free_port()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"phase": "sharded", "card": card_name, "mesh": "1x1 (nccl)"}
    # ---- qwen3-0.6b: 4 decode steps
    arch, B, T, N = "qwen3-0.6b", 8, 2048, 4
    cfg = get_config(arch)
    model = for_config(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    cache = model.init_cache(B, T)
    for leaf in leaves(cache):
        leaf.normal_(0.0, 0.5, generator=gen)
    pos = torch.tensor([16, 300, 511, 1024, 1500, 1800, 2000, 2040], dtype=torch.int32,
                       device="cuda")
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    active[2] = False
    tokens = torch.randint(0, cfg.vocab, (N, B, 1), generator=gen, device="cuda",
                           dtype=torch.int32)
    step, _ = build_step(arch, "decode", mesh, cfg=cfg,
                         shape=ShapeSpec("decode", T, B, "decode"), device="cuda")
    # the shards are copies: the eager twin steps on ``cache`` itself
    local = list(step.shard((params, tokens[0], cache, pos, active, model.rope_tables)))
    reset_launches()
    want = []
    for i in range(N):
        logits, _ = model.decode_step(params, tokens[i], cache, pos + i, active)
        want.append(logits)
    torch.cuda.synchronize()
    eager = read_launches()["flash_decode"]
    reset_launches()
    attention.CORES.clear()
    got = []
    for i in range(N):
        if i:
            local[1] = step.shard_input(1, tokens[i])
            local[3] = step.shard_input(3, pos + i)
        got.append(step.gather(step.fn(*local)))
    torch.cuda.synchronize()
    n = read_launches()["flash_decode"]
    core = cores_taken(attention.CORES)
    par = _parity(got, want)
    cache_par = _parity(leaves(local[2]), leaves(cache))
    per_step = flash_decode_per_step(cfg)
    out["qwen3_decode"] = {
        "slots": B, "max_len": T, "steps": N, "attention_core": core,
        "flash_decode_launches": n, "expected": N * per_step,
        "eager_twin_launches": eager, "logits": par, "cache": cache_par,
        "ok": par["ok"] and cache_par["ok"] and n == N * per_step
        and core == "kernel"}
    del params, cache, local, got, want
    torch.cuda.empty_cache()
    # ---- mamba2-2.7b: one 2048-token prefill
    arch, S = "mamba2-2.7b", 2048
    cfg = get_config(arch)
    model = for_config(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, S), generator=gen, device="cuda",
                                     dtype=torch.int32)}
    reset_launches()
    want_logits, want_caches = model.prefill(params, batch)
    torch.cuda.synchronize()
    eager = read_launches()["ssd_chunk"]
    step, _ = build_step(arch, "prefill", mesh, cfg=cfg,
                         shape=ShapeSpec("prefill", S, 1, "prefill"), device="cuda")
    local = step.shard((params, batch, model.rope_tables))
    del params
    reset_launches()
    logits, caches = step.gather(step.fn(*local))
    torch.cuda.synchronize()
    n = read_launches()["ssd_chunk"]
    par = _parity([logits], [want_logits])
    cache_par = _parity(leaves(caches), leaves(want_caches))
    out["mamba2_prefill"] = {
        "tokens": S, "ssd_chunk_launches": n, "expected": cfg.n_layers * (S // 256),
        "eager_twin_launches": eager, "logits": par, "caches": cache_par,
        "ok": par["ok"] and cache_par["ok"] and n == cfg.n_layers * (S // 256)}
    del local, logits, caches, want_logits, want_caches
    torch.cuda.empty_cache()
    # ---- the train step with remat (the reference's dry-run step):
    # qwen3-0.6b at the train phase's 512 x 4, and mamba2-2.7b cut to 8
    # periods in fp32 (train_mamba2's gradient gate) at its 512 x 2: per
    # step 2 x 8 layers x 2 chunks = 32 ssd_chunk launches (the forward,
    # then each period's recompute in the backward) and 16 ssd_chunk_bwd
    out["qwen3_train"] = sharded_train(mesh, get_config("qwen3-0.6b"), 512, 4)
    cut = dataclasses.replace(get_config("mamba2-2.7b"), n_periods=8, dtype="float32")
    out["mamba2_train"] = sharded_train(mesh, cut, 512, 2, want_launches={
        "ssd_chunk": 2 * 8 * 2, "ssd_chunk_bwd": 8 * 2})
    train_launches = out["mamba2_train"]["launches"]
    out["launches"] = {"flash_decode": out["qwen3_decode"]["flash_decode_launches"],
                       "ssd_chunk": n,
                       "ssd_chunk_train": train_launches["ssd_chunk"],
                       "ssd_chunk_bwd_train": train_launches["ssd_chunk_bwd"]}
    out["ok"] = all(out[k]["ok"] for k in ("qwen3_decode", "mamba2_prefill",
                                           "qwen3_train", "mamba2_train"))
    emit(out)
    if not out["ok"]:
        fail(f"sharded: {out}")
    import torch.distributed as dist

    dist.destroy_process_group()
    return out


def sharded_train(mesh, cfg, seq_len: int, batch: int,
                  want_launches: dict | None = None) -> dict:
    """One AdamW step of ``build_step``'s train step (remat on) on ``cfg``
    at full width, weights from a seed, the train phases' token stream,
    against the unsharded eager step with remat (``make_train_step``) on
    the same params and batch, by PERF.md §2's parity rule: the loss, the
    grad norm and every gradient leaf (each side's AdamW first moment over
    (1 - b1) and its clip scale: one step from zero moments), the new
    params reported. The SSD kernels' launches of the sharded step, read
    just after it, must be ``want_launches``; the eager twin's are
    counted apart."""
    import torch

    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.dryrun import build_step
    from repro_torch.launch.train import make_batch, make_train_step
    from repro_torch.models.api import ShapeSpec, for_config
    from repro_torch.optim import adamw
    from repro_torch.tree_util import leaves, tree_map

    model = for_config(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=batch))
    b = make_batch(cfg, pipe.batch_at(0), "cuda")
    opt_cfg = adamw.AdamWConfig()

    def gradients(opt_state, metrics):
        scale = torch.clamp(opt_cfg.grad_clip / (metrics["grad_norm"] + 1e-9), max=1.0)
        return [m / ((1 - opt_cfg.b1) * scale) for m in leaves(opt_state["m"])]

    reset_launches()
    eager = make_train_step(model, opt_cfg, remat=True)(
        tree_map(torch.clone, params), adamw.init_state(params), b)
    torch.cuda.synchronize()
    eager_launches = read_launches()
    step, _ = build_step(cfg.name, "train", mesh, cfg=cfg,
                         shape=ShapeSpec("train", seq_len, batch, "train"),
                         device="cuda", opt_cfg=opt_cfg)
    local = step.shard((params, adamw.init_state(params), b, model.rope_tables))
    del params
    reset_launches()
    t0 = time.perf_counter()
    got = step.gather(step.fn(*local))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    metrics = _parity([got[2]["loss"], got[2]["grad_norm"]],
                      [eager[2]["loss"], eager[2]["grad_norm"]])
    grads = _parity(gradients(got[1], got[2]), gradients(eager[1], eager[2]))
    new_params = _parity(leaves(got[0]), leaves(eager[0]))
    launches = {k: counts[k] for k in ("ssd_chunk", "ssd_chunk_bwd")}
    row = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "seq_len": seq_len, "batch": batch, "remat": step.remat,
           "loss": float(got[2]["loss"]), "loss_eager": float(eager[2]["loss"]),
           "grad_norm": float(got[2]["grad_norm"]),
           "loss_and_grad_norm": metrics, "gradients": grads, "params": new_params,
           "leaves": len(leaves(got[1]["m"])), "launches": launches,
           "expected_launches": want_launches or {"ssd_chunk": 0, "ssd_chunk_bwd": 0},
           "eager_twin_launches": {k: eager_launches[k] for k in launches},
           "wall_s": wall}
    row["ok"] = (step.remat and metrics["ok"] and grads["ok"]
                 and launches == row["expected_launches"])
    del local, got, eager
    torch.cuda.empty_cache()
    return row


def lse_library_call(q, k, v, kernel_lse) -> dict:
    """One PyTorch call computing ``flash_decode_lse``'s function at full
    lengths: ``aten._scaled_dot_product_efficient_attention`` with
    ``compute_log_sumexp``, on q as (B, KV·G, 1, D) and K/V repeated to
    KV·G heads before the timed region (the repeat timed apart). Its
    log-sum-exp is held against the kernel's (``kernel_lse``, (B, KV, G))
    within 1e-3 + 1e-4·|lse|."""
    import torch

    B, KV, G, D = q.shape
    T = k.shape[1]

    def repeat(t):
        return t.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)

    repeat_ms = cuda_time_ms(lambda: (repeat(k), repeat(v)), runs=30)
    qh, kh, vh = q.reshape(B, KV * G, 1, D), repeat(k), repeat(v)

    def call():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            qh, kh, vh, None, True)

    outs = call()
    # the first query row's lse (the call pads rows to 32)
    lse = outs[1].float().reshape(B, KV * G, -1)[..., 0].reshape(B, KV, G)
    gap = (lse - kernel_lse).abs()
    lse_ok = bool((gap <= 1e-3 + 1e-4 * kernel_lse.abs()).all())
    ms = cuda_time_ms(call)
    return {"call": "aten._scaled_dot_product_efficient_attention", "ms": ms,
            "repeat_ms": repeat_ms,
            "bytes_read": (qh.numel() + kh.numel() + vh.numel()) * q.element_size(),
            "shape": [B, KV * G, 1, D, T], "lse_max_abs_gap": float(gap.max()),
            "lse_ok": lse_ok}


def lse_at_span(gen, shape: tuple) -> tuple:
    """bf16 q, K and V at ``shape`` (B, KV, G, D, T; B <= 8) drawn from
    ``gen``, and ``flash_decode_lse`` held against its plain version on
    them at rows of lengths 0, 1, 129, 700, 1500, 2047, T and 0 (the
    output at the bf16 bar, the log-sum-exp within 1e-4 + 1e-5·|want|):
    ``(q, k, v, check)``, ``check`` the lengths, the errors and ``ok``."""
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.ref import flash_decode_lse_ref

    B, KV, G, D, T = shape
    q = (torch.randn((B, KV, G, D), generator=gen, device="cuda") * Q_STD
         ).to(torch.bfloat16)
    k, v = ((torch.randn((B, T, KV, D), generator=gen, device="cuda") * 0.5
             ).to(torch.bfloat16) for _ in range(2))
    mix = torch.tensor([0, 1, 129, 700, 1500, 2047, T, 0][:B], dtype=torch.int32,
                       device="cuda")
    out, lse = fd.flash_decode_lse(q, k, v, mix)
    want_out, want_lse = flash_decode_lse_ref(q.float(), k.float(), v.float(), mix)
    torch.cuda.synchronize()
    err = (out.float() - want_out).abs()
    lse_err = (lse - want_lse).abs()
    ok = bool((err <= 1e-3 + 1e-2 * want_out.abs()).all()) and bool(
        (lse_err <= 1e-4 + 1e-5 * want_lse.abs()).all())
    return q, k, v, {"lengths_checked": mix.tolist(), "max_abs_err": float(err.max()),
                     "lse_max_abs_err": float(lse_err.max()), "ok": ok}


def phase_rank_of_256(card_name: str, note: dict) -> dict:
    """Rank 0's local program of full-width nemotron-4-340b decode_32k on
    (data=16, model=16), run on the card over the fake group of 256 ranks
    (a collective there returns without moving data, so the values are
    not checked): its local params drawn from a seed (2.64 GB), its local
    K/V (9.66 GB) and one decode step. Its 8 K/V heads do not divide
    model = 16, so the cache's T is split and each of the 96 layers runs
    ``flash_decode_lse`` on this rank's span of 2,048 positions
    (``models/attention.flash_decode_context_parallel``). First the kernel
    at that shape is held against its plain version on the same inputs
    (the output at the bf16 bar, the log-sum-exp within 1e-4 + 1e-5·|want|;
    rows of length 0 included) and timed beside its bound. Checks the
    step completes with the output's local shape and launches the kernel
    once a layer; records the allocator's peak over the step beside the
    dry run's ``arg_gb`` and ``planned_act_gb`` for the same row
    (``note``, from the dryrun phase), the step's device time (the
    kernels' sum under torch.profiler, and CUDA events around it) and the
    attention cores taken."""
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.ref import flash_decode_lse_ref
    from repro_torch.launch.dryrun import build_step, cores_taken
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.launch.roofline import kernel_bound
    from repro_torch.models import attention
    from repro_torch.models.api import INPUT_SHAPES, for_config
    from repro_torch.tree_util import tree_map

    mesh = init_mesh((16, 16), ("data", "model"), "cuda", backend="fake")
    nemotron = note.get("nemotron-4-340b", {})
    step, _ = build_step("nemotron-4-340b", "decode_32k", mesh, device="cuda")
    cfg = step.ctx.cfg
    gen = torch.Generator(device="cuda").manual_seed(0)

    def draw(meta):
        t = torch.empty(meta.shape, dtype=meta.dtype, device="cuda")
        if t.is_floating_point():
            return t.normal_(0.0, 0.02, generator=gen)
        return t

    params_l, token_l, cache_l, pos_l, active_l, tables_l = step.inputs
    # the kernel at one rank's span: (8 slots, 8 K/V heads, 12, 192) over
    # 2,048 positions, bf16
    B, KV = token_l.shape[0], cfg.n_kv_heads
    G, D = cfg.n_heads // KV, cfg.resolved_head_dim
    T = INPUT_SHAPES["decode_32k"].seq_len // mesh.size(1)
    before = fd.LAUNCHES
    q, k, v, check = lse_at_span(gen, (B, KV, G, D, T))
    full = torch.full((B,), T, dtype=torch.int32, device="cuda")
    ms = cuda_time_ms(lambda: fd.flash_decode_lse(q, k, v, full))
    plain_ms = cuda_time_ms(lambda: flash_decode_lse_ref(q, k, v, full))
    _, kernel_lse = fd.flash_decode_lse(q, k, v, full)
    fd.LAUNCHES = before  # the check's and the timing's launches are not the step's
    library = lse_library_call(q, k, v, kernel_lse)
    bound = kernel_bound("flash_decode", {"B": B, "KV": KV, "G": G, "D": D, "T": T,
                                          "dtype": "bfloat16"}, card_name=card_name)
    kernel = {"kernel": "flash_decode_lse", "shape": [B, KV, G, D, T],
              "path": fd.kernel_path(q.dtype, D, G),
              "n_split": fd.num_splits(B, KV, G, D, T, q.dtype),
              **check, "ms": ms, "plain_ms": plain_ms,
              "library_ms": library["ms"], "library": library,
              "bound_ms": bound.bound_s * 1e3, "bound_by": bound.bound_by,
              "ok": check["ok"] and library["lse_ok"]}
    del q, k, v, full, kernel_lse
    torch.cuda.empty_cache()

    vocab = step.shapes[0]["embed"].shape[0]
    inputs = [tree_map(draw, params_l), None, tree_map(draw, cache_l), None, None, None]
    inputs[1] = torch.randint(0, vocab, tuple(token_l.shape), generator=gen,
                              device="cuda", dtype=torch.int32)
    inputs[3] = torch.randint(0, 32767, tuple(pos_l.shape), generator=gen,
                              device="cuda", dtype=torch.int32)
    inputs[4] = torch.ones(tuple(active_l.shape), dtype=torch.bool, device="cuda")
    inputs[5] = for_config(cfg, "cuda").rope_tables
    torch.cuda.synchronize()
    args_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    attention.CORES.clear()
    logits = step.fn(*inputs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()["flash_decode"]
    core = cores_taken(attention.CORES)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        start.record()
        logits = step.fn(*inputs)
        end.record()
        torch.cuda.synchronize()
    kernel_us = sum(e.self_device_time_total for e in prof.key_averages())
    want_shape = (8, vocab // 16)
    per_step = flash_decode_per_step(cfg)
    local_shape = list(logits.shape)
    del inputs, logits
    torch.cuda.empty_cache()
    train = rank0_train_step(mesh, note.get("qwen3-0.6b", {}))
    row = {"phase": "rank_of_256", "card": card_name, "arch": "nemotron-4-340b",
           "shape": "decode_32k", "mesh": "16x16 (fake group, rank 0)",
           "values_checked": False,
           "why_not_values": "the fake group's collectives leave their outputs unwritten",
           "local_logits_shape": local_shape, "want_shape": list(want_shape),
           "inputs_gb": args_bytes / 1e9, "peak_gb": peak / 1e9,
           "peak_over_inputs_gb": (peak - args_bytes) / 1e9,
           "dryrun_arg_gb": nemotron.get("arg_gb"),
           "dryrun_planned_act_gb": nemotron.get("planned_act_gb"),
           "dryrun_peak_mem_gb": nemotron.get("peak_mem_gb"),
           "device_kernel_ms": kernel_us / 1e3, "event_ms": start.elapsed_time(end),
           "attention_core": core, "launches": launches,
           "expected_launches": per_step, "kernel_at_span": kernel,
           "qwen3_train_4k": train,
           "ok": tuple(local_shape) == want_shape and launches == per_step
           and core == "kernel: context-parallel" and check["ok"] and train["ok"]}
    emit(row)
    if not row["ok"]:
        fail(f"rank_of_256: local logits {tuple(local_shape)} (want {want_shape}), "
             f"{launches} flash_decode launches (want {per_step}), core {core!r}, "
             f"kernel at the span {kernel}, qwen3 train_4k {train}")
    return row


def rank0_train_step(mesh, note: dict) -> dict:
    """Rank 0's local program of full-width qwen3-0.6b train_4k on the fake
    group of 256 ranks (``mesh``), on the card: the local params from a
    seed, zero moments, a local batch of 16 x 4,096 tokens, one AdamW
    step with remat. Its 8 K/V heads do not divide model = 16, so K/V
    are split on T and the softmax and the PV product reduce across the
    ranks. Checks that the step completes with its params' local shapes
    and an allocator peak under ``ROW_LIMIT_GB``, recorded beside the dry
    run's ``arg_gb`` + ``planned_act_gb`` for the row (``note``). The
    fake group's collectives move nothing, so no value is checked."""
    import torch

    from repro_torch.launch.dryrun import build_step
    from repro_torch.models.api import for_config
    from repro_torch.tree_util import leaves, tree_map

    step, _ = build_step("qwen3-0.6b", "train_4k", mesh, device="cuda")
    cfg = step.ctx.cfg
    gen = torch.Generator(device="cuda").manual_seed(1)
    params_l, opt_l, batch_l, _ = step.inputs
    params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="cuda"
                                            ).normal_(0.0, 0.02, generator=gen), params_l)
    opt = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device="cuda"), opt_l)
    batch = tree_map(lambda t: torch.randint(0, cfg.vocab, tuple(t.shape), generator=gen,
                                             device="cuda", dtype=t.dtype), batch_l)
    tables = for_config(cfg, "cuda").rope_tables
    torch.cuda.synchronize()
    args_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    new_params, _, metrics = step.fn(params, opt, batch, tables)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    shapes_kept = [tuple(t.shape) for t in leaves(new_params)] == \
        [tuple(t.shape) for t in leaves(params_l)]
    planned = (note.get("arg_gb") or 0) + (note.get("planned_act_gb") or 0)
    row = {"arch": "qwen3-0.6b", "shape": "train_4k", "remat": step.remat,
           "local_batch": list(batch_l["tokens"].shape),
           "values_checked": False, "inputs_gb": args_bytes / 1e9,
           "peak_gb": peak / 1e9, "peak_over_inputs_gb": (peak - args_bytes) / 1e9,
           "dryrun_arg_gb": note.get("arg_gb"),
           "dryrun_planned_act_gb": note.get("planned_act_gb"),
           "dryrun_arg_plus_planned_gb": planned, "wall_s": wall,
           "metrics_keys": sorted(metrics), "params_local_shapes_kept": shapes_kept,
           "ok": step.remat and shapes_kept and peak / 1e9 < ROW_LIMIT_GB}
    del params, opt, batch, new_params
    torch.cuda.empty_cache()
    return row


def run_mesh_child(phases: set) -> None:
    """A child of ``start_fresh_process`` running one multi-device phase:
    ``dryrun`` sees no card; ``sharded`` and ``rank_of_256`` wait until the
    parent collects them (its kernels built, its timed phases done)."""
    if "dryrun" in phases:
        phase_dryrun()
        return
    # the parent collects this child at the end of its run: import what the
    # phase runs first, so that the imports are not on the run's path
    import torch  # noqa: F401

    from repro_torch.launch import dryrun, mesh  # noqa: F401
    from repro_torch.models import api, attention  # noqa: F401
    note = wait_for_parent()
    smi, card_name = phase_device()
    phase_build()
    if "sharded" in phases:
        phase_sharded(card_name)
    else:
        phase_rank_of_256(card_name, note)


def _quiet(fn, *args):
    """``fn(*args)`` with its printed lines kept (returned beside its
    result and its seconds) rather than printed: the examples' output
    would push the run's rows out of the end of the log."""
    import contextlib
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue().splitlines(), time.perf_counter() - t0


def example_row(name: str, seconds: float, checks: dict, **fields) -> dict:
    row = {"phase": "examples", "example": name, "seconds": seconds, **fields,
           "checks": checks, "ok": all(checks.values())}
    emit(row)
    if not row["ok"]:
        fail(f"examples: {name} failed {[k for k, v in checks.items() if not v]}")
    return row


def example_serve(label: str, argv: list[str], kernel: str | None) -> dict:
    """``examples/serve_lm.main(argv)`` on the card, the launch counts set
    to 0 just before it and read just after: every request finished, the
    slot audit line printed for the engine's slots, live state equal to
    planned, every decode step a replay, ``kernel`` launched once a layer
    a step (``check_replayed``), and the plan certified."""
    import gc

    import torch

    from repro_torch.examples import serve_lm

    reset_launches()
    stats, lines, seconds = _quiet(serve_lm.main, argv)
    launches = read_launches()
    replayed = check_replayed(f"examples {label}", stats, kernel)
    audit = [ln for ln in lines if ln.startswith("slot audit:")]
    want_audit = (f"slot audit: {stats['requests']} requests over "
                  f"{stats['engine'].n_slots} slots, no interval overlap")
    live = next((ln for ln in lines if ln.startswith("--- live device state:")), "")
    checks = {
        "on_the_card": stats["device"].startswith("cuda"),
        "all_requests_served": stats["requests"] == 8,
        "slot_audit_printed": audit == [want_audit],
        "unified_plan_printed": "unified plan " in live and "residency on" in live,
        "live_state_is_planned": stats["state_live_bytes"] == stats["state_planned_bytes"],
        "logits_finite": stats["last_logits_finite"],
    }
    plan_row(f"{label} (examples/serve_lm)", stats)
    row = example_row(
        label, seconds, checks, argv=argv, requests=stats["requests"],
        tokens=stats["tokens"], waves=stats["waves"],
        decode_steps=stats["decode_calls"], tokens_per_s=stats["tokens_per_s"],
        slot_log=stats["slot_log"], slot_audit=audit,
        state_planned_bytes=stats["state_planned_bytes"],
        state_live_bytes=stats["state_live_bytes"], launches=launches,
        graphs=replayed)
    del stats  # the engine, its state and its graphs
    gc.collect()
    torch.cuda.empty_cache()
    return row


def example_train(label: str, argv: list[str], launches_per_step: dict,
                  loss_check: tuple, **fields) -> dict:
    """``examples/train_lm.main(argv)`` on the card (reduced config), the
    launch counts set to 0 just before it and read just after: each
    kernel in ``launches_per_step`` launched that many times a step, the
    others never; ``loss_check`` is a (name, test of the losses) pair.
    Returns the launches."""
    from repro_torch.examples import train_lm

    reset_launches()
    hist, lines, seconds = _quiet(train_lm.main, argv)
    launches = read_launches()
    steps = int(argv[argv.index("--steps") + 1])
    want = {k: launches_per_step.get(k, 0) * steps for k in launches}
    losses = [h["loss"] for h in hist]
    name, test = loss_check
    example_row(label, seconds, {
        "steps_run": len(hist) == steps,
        "losses_finite": all(math.isfinite(x) for x in losses),
        "launches": launches == want,
        name: test(losses),
    }, argv=argv, first_loss=losses[0], final_loss=losses[-1], launches=launches,
        expected_launches=want,
        step_wall_s_median=statistics.median(h["wall_s"] for h in hist),
        final_line=lines[-1] if lines else None, **fields)
    return launches


def phase_examples(card_name: str) -> dict:
    """The twins of the reference's five examples and of its Tables 1-2
    (``repro_torch.examples``), each through the entry point a user
    calls, on the card: quickstart's arena executor on ``cuda`` held
    against eager; dynamic_shapes' four stages; paper_tables with every
    claim passing (pure planning: tests/test_torch_examples.py holds its
    rows to the reference's strategies); serve_lm on full-width
    qwen3-0.6b (``flash_decode`` once a layer a step) and on reduced
    mamba2-2.7b, each printing its slot audit with live state equal to
    planned; train_lm on reduced qwen3-0.6b for 200 steps (final loss
    below ln(vocab) - 1) and reduced mamba2-2.7b for 50 (d_state 16, head
    dim 32, float32: one 128-token chunk a step through ``ssd_chunk`` and
    ``ssd_chunk_bwd``; the final loss below the first). Returns each
    kernel's launches by example."""
    import torch

    from repro_torch.configs.base import get_reduced
    from repro_torch.examples import dynamic_shapes, paper_tables, quickstart

    t0 = time.perf_counter()
    res, lines, seconds = _quiet(quickstart.main, ["--device", DEVICE])
    example_row("quickstart", seconds, {
        "on_the_card": res["device"].startswith("cuda") and res["output"].is_cuda,
        "output_matches_eager": res["max_abs_err"] <= 1e-5 * float(res["output"].abs().max()),
        "arena_below_naive": res["arena_bytes"] < res["naive_peak_bytes"],
    }, lines=lines, arena_bytes=res["arena_bytes"],
        naive_peak_bytes=res["naive_peak_bytes"], max_abs_err=res["max_abs_err"])

    res, lines, seconds = _quiet(dynamic_shapes.main)
    example_row("dynamic_shapes", seconds, {
        "four_lines": len(lines) == 4,
        "one_arena_of_6_mib": res["stage_bytes"] == [6 * 2**20] * 3,
        "staging_cost_nothing": res["overhead_vs_oneshot"] == 1.0,
    }, lines=lines)

    res, lines, seconds = _quiet(paper_tables.main)
    example_row("paper_tables", seconds, {
        "every_claim_passes": res["failures"] == [],
    }, failures=res["failures"],
        claims=[ln for ln in lines if ln.startswith(("PASS", "FAIL"))][-1:],
        searched_order_mb={n: t["searched_order"] for n, t in res["table2"].items()})

    launches: dict[str, dict[str, int]] = {}
    qwen3 = example_serve("qwen3-0.6b serve_lm --full",
                          ["--arch", "qwen3-0.6b", "--full"], "flash_decode")
    launches["flash_decode"] = {"qwen3-0.6b examples/serve_lm --full":
                                qwen3["launches"]["flash_decode"]}
    example_serve("mamba2-2.7b serve_lm", ["--arch", "mamba2-2.7b"], None)

    ln_vocab = math.log(get_reduced("qwen3-0.6b").vocab)
    example_train("qwen3-0.6b train_lm (reduced, 200 steps)",
                  ["--arch", "qwen3-0.6b", "--steps", "200"], {},
                  ("final_loss_below_ln_vocab_minus_1",
                   lambda losses: losses[-1] < ln_vocab - 1), ln_vocab=ln_vocab)

    cfg = get_reduced("mamba2-2.7b")
    per_step = {"ssd_chunk": cfg.n_layers, "ssd_chunk_bwd": cfg.n_layers}
    counts = example_train(
        "mamba2-2.7b train_lm (reduced, 50 steps)",
        ["--arch", "mamba2-2.7b", "--steps", "50"], per_step,
        ("final_loss_below_first", lambda losses: losses[-1] < losses[0]),
        shape={"ssm_state": cfg.ssm_state, "ssm_head_dim": cfg.ssm_head_dim,
               "chunk": 128, "dtype": cfg.dtype})
    for name in per_step:
        launches[name] = {"mamba2-2.7b examples/train_lm (reduced)": counts[name]}
    emit({"phase": "examples", "card": card_name, "seconds": time.perf_counter() - t0,
          "launches": launches, "ok": True})
    torch.cuda.empty_cache()
    return launches


PHASES = ("device", "build", "kernels", "parity", "serve", "profile",
          "serve_block", "prefill_parity", "prefill", "serve_mamba",
          "parity_gemma3", "serve_gemma3", "prefill_gemma3", "parity_granite",
          "serve_granite", "prefill_granite", "parity_llama4", "parity_zamba2",
          "serve_zamba2", "prefill_zamba2", "parity_internvl2", "serve_internvl2",
          "prefill_internvl2", "parity_paged", "serve_paged", "serve_bundle",
          "serve_aot", "serve_pytree", "serve_paged_gemma3", "serve_paged_zamba2",
          "smem", "kernels_ssd_bwd", "train", "train_mamba2", "train_seamless",
          "dryrun", "sharded", "rank_of_256", "examples")


T0 = time.perf_counter()
# phases that need no kernel of the port built (a child running only
# them skips the build)
NO_KERNEL_PHASES = {"train", "dryrun"}


def main() -> None:
    global KEEP_GOING
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %(default)s (device and "
                         "build always run)")
    ap.add_argument("--keep-going", action="store_true",
                    help="check every kernel case before failing")
    ap.add_argument("--child", action="store_true",
                    help="run a serve_paged_<family> phase in this process (the "
                         "whole run starts each in a child process)")
    args = ap.parse_args()
    phases = set(args.phases.split(",")) | {"device", "build"}
    if phases - set(PHASES):
        fail(f"unknown phases {sorted(phases - set(PHASES))}")
    KEEP_GOING = args.keep_going
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no src/repro_torch)")
    sys.path.insert(0, str(ROOT / "src"))
    if args.child and phases & set(MESH_PHASES):
        run_mesh_child(phases)
        return
    smi, card_name = phase_device()
    # the multi-device phases' children: the dry run traces on the host
    # beside everything else; the sharded runs import now and touch the
    # card only when collected, after every timed phase
    mesh_children = {
        phase: start_fresh_process(phase, env={"CUDA_VISIBLE_DEVICES": ""}
                                   if phase == "dryrun" else None)
        for phase in MESH_PHASES if phase in phases and not args.child}
    if phases & set(BUCKET_PHASES):
        start_qwen3_compiles()
    # the paged families' bundles compile beside the build and the kernel
    # phases, timed on the card alone, as qwen3's do: off the serve phases
    for phase, (arch, pool, *_) in PAGED_FAMILIES.items():
        if phase in phases and arch in BUNDLE_FAMILIES and not args.child:
            start_compile(phase, arch, PAGE_SIZE, pool)
    train = None
    if "train" in phases and not args.child:
        # qwen3's training launches no kernel of the port: its fresh
        # process (cuBLAS's workspace fixed before CUDA starts, as
        # torch.use_deterministic_algorithms asks) runs its checkpoint
        # resume while the kernels build, which keeps the card idle, and
        # its timed steps once the build is done
        train = start_fresh_process("train", env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    # every engine built below certifies its unified plan before it serves
    os.environ["REPRO_STARTUP_LINT"] = "1"
    built = bool(phases - {"device", "build"} - NO_KERNEL_PHASES)
    if built:
        phase_build()
    if train is not None:
        running = sum(proc.poll() is None for proc, _ in COMPILES.values())
        finish_fresh_process("train", train, {"built_before": built,
                                              "background_compiles": running})
    timing = {}
    if "kernels" in phases:
        timing["flash_decode"] = phase_kernels(card_name)
        timing["ssd_chunk"] = phase_kernels_ssd(card_name)
        timing["flash_decode_paged"] = phase_kernels_paged(card_name)
        phase_kernels_ring(card_name)
        phase_kernels_state()
        emit({"phase": "kernels", "checked": list(KERNELS),
              "failed_cases": FAILED_CASES})
        if FAILED_CASES:
            fail(f"{len(FAILED_CASES)} kernel case(s) over their bars: {FAILED_CASES}")
    if "kernels_ssd_bwd" in phases:
        timing["ssd_chunk_bwd"] = phase_kernels_ssd_bwd(card_name)
        emit({"phase": "kernels_ssd_bwd", "failed_cases": FAILED_CASES})
    # kernel -> path -> its launches in that path's run
    launches: dict[str, dict[str, int]] = {name: {} for name in KERNELS}
    if "parity" in phases:
        phase_parity()
    host_tokens = None
    roofs = []
    if "serve" in phases:
        serve, engine = phase_serve()
        launches["flash_decode"]["qwen3-0.6b serve"] = serve["launches"]
        host_tokens = serve["tokens"]
        if "profile" in phases:
            roofs.append(phase_profile(engine, card_name))
        del engine
    if "serve_block" in phases:
        roofs.append(phase_serve_block(host_tokens, card_name))
    if "prefill_parity" in phases:
        phase_prefill_parity()
    if "prefill" in phases:
        row, roof = phase_prefill(card_name)
        launches["ssd_chunk"]["mamba2-2.7b prefill"] = row["launches"]["ssd_chunk"]
        roofs.append(roof)
    if "serve_mamba" in phases:
        phase_serve_mamba()
    if "parity_gemma3" in phases:
        phase_parity_gemma3()
    if "serve_gemma3" in phases:
        serve_g, roof = phase_serve_gemma3(card_name)
        launches["flash_decode"]["gemma3-4b serve"] = serve_g["launches"]
        roofs.append(roof)
    if "prefill_gemma3" in phases:
        _, roof = phase_prefill_gemma3(card_name)
        roofs.append(roof)
    if "parity_granite" in phases:
        phase_parity_granite()
    if "serve_granite" in phases:
        serve_m, roof = phase_serve_granite(card_name)
        launches["flash_decode"]["granite-moe-3b-a800m serve"] = serve_m["launches"]
        roofs.append(roof)
    if "prefill_granite" in phases:
        _, roof = phase_prefill_granite(card_name)
        roofs.append(roof)
    if "parity_llama4" in phases:
        launches["flash_decode"]["llama4 one period (parity_llama4)"] = \
            phase_parity_llama4()["launches"]
    if "parity_zamba2" in phases:
        phase_parity_zamba2()
    if "serve_zamba2" in phases:
        serve_z, roof = phase_serve_zamba2(card_name)
        launches["flash_decode"]["zamba2-7b serve"] = serve_z["launches"]
        roofs.append(roof)
    if "prefill_zamba2" in phases:
        row, roof = phase_prefill_zamba2(card_name)
        launches["ssd_chunk"]["zamba2-7b prefill"] = row["launches"]["ssd_chunk"]
        roofs.append(roof)
    if "parity_internvl2" in phases:
        phase_parity_internvl2()
    if "serve_internvl2" in phases:
        serve_v, roof = phase_serve_internvl2(card_name)
        launches["flash_decode"]["internvl2-1b serve"] = serve_v["launches"]
        roofs.append(roof)
    if "prefill_internvl2" in phases:
        _, roof = phase_prefill_internvl2(card_name)
        roofs.append(roof)
    if "parity_paged" in phases:
        phase_parity_paged()
    if "serve_paged" in phases:
        launches["flash_decode_paged"]["qwen3-0.6b serve_paged"] = \
            phase_serve_paged()["launches"]["flash_decode_paged"]
    if "serve_bundle" in phases:
        bundles = phase_serve_bundle()
        launches["flash_decode"]["qwen3-0.6b serve_bundle"] = \
            bundles["serve"]["launches"]["flash_decode"]
        launches["flash_decode_paged"]["qwen3-0.6b serve_bundle paged"] = \
            bundles["serve_paged"]["launches"]["flash_decode_paged"]
    if "serve_aot" in phases:
        aot = phase_serve_aot()
        launches["flash_decode"]["qwen3-0.6b serve_aot"] = \
            aot["serve"]["launches"]["flash_decode"]
        launches["flash_decode_paged"]["qwen3-0.6b serve_aot paged"] = \
            aot["serve_paged"]["launches"]["flash_decode_paged"]
    if "serve_pytree" in phases:
        launches["flash_decode"]["qwen3-0.6b serve_pytree"] = \
            phase_serve_pytree()["launches"]
    for phase, (arch, *_) in PAGED_FAMILIES.items():
        if phase not in phases:
            continue
        if args.child:
            phase_serve_paged_family(phase)
            continue
        row = in_fresh_process(phase, {"CHIP_SMOKE_BUNDLE": json.dumps(
            finish_compile(phase))} if phase in COMPILES else None)
        want = SERVE_TOKENS.get(arch)
        if want is not None and row["tokens"] != {str(k): v for k, v in want.items()}:
            fail(f"{phase}: the paged tokens differ from the symmetric serve phase's")
        launches["flash_decode_paged"][f"{arch} {phase}"] = \
            row["launches"]["flash_decode_paged"]
        if "bundle" in row:
            launches["flash_decode_paged"][f"{arch} {phase} bundle"] = \
                row["bundle"]["launches"]["flash_decode_paged"]
            launches["flash_decode_paged"][f"{arch} {phase} bundle aot"] = \
                row["bundle"]["aot"]["launches"]["flash_decode_paged"]
    if "train" in phases and args.child:
        phase_train(card_name)
    if "train_mamba2" in phases:
        row = phase_train_mamba2(card_name)
        for name in ("ssd_chunk", "ssd_chunk_bwd"):
            launches[name]["mamba2-2.7b train_mamba2"] = row["launches"][name]
    if "train_seamless" in phases:
        phase_train_seamless(card_name)
    if "dryrun" in mesh_children:
        dry = finish_fresh_process("dryrun", mesh_children["dryrun"])
        note = {r["arch"]: r for r in dry["rows"]
                if r["arch"] in ("nemotron-4-340b", "qwen3-0.6b")}
    else:
        note = {}
    if "sharded" in mesh_children:
        row = finish_fresh_process("sharded", mesh_children["sharded"])
        launches["flash_decode"]["qwen3-0.6b sharded decode"] = \
            row["launches"]["flash_decode"]
        launches["ssd_chunk"]["mamba2-2.7b sharded prefill"] = row["launches"]["ssd_chunk"]
        launches["ssd_chunk"]["mamba2-2.7b sharded train step (remat, 8 layers)"] = \
            row["launches"]["ssd_chunk_train"]
        launches["ssd_chunk_bwd"]["mamba2-2.7b sharded train step (remat, 8 layers)"] = \
            row["launches"]["ssd_chunk_bwd_train"]
    lse_span = None
    if "rank_of_256" in mesh_children:
        row = finish_fresh_process("rank_of_256", mesh_children["rank_of_256"], note)
        launches["flash_decode"]["nemotron-4-340b rank 0 of 256 decode (T split)"] = \
            row["launches"]
        lse_span = row["kernel_at_span"]
    if FAILED_CASES:
        fail(f"{len(FAILED_CASES)} case(s) over their bars: {FAILED_CASES}")
    if "smem" in phases:
        phase_smem()
    if "examples" in phases:
        for name, by_path in phase_examples(card_name).items():
            launches[name].update(by_path)
    if phases != set(PHASES):
        return
    if len(CERTIFIED) != 24 or len(roofs) != 11:
        fail(f"certified plans {CERTIFIED}, roofline rows {len(roofs)}: "
             f"expected 24 and 11")
    import torch

    print(f"chip_smoke: {time.perf_counter() - T0:.1f} s in all", flush=True)
    print(smi, flush=True)
    # one row per kernel: its launches on every path that runs it (the
    # counts read after each path), its timing at qwen3-0.6b's serving
    # shape (flash_decode) or mamba2-2.7b's chunk (ssd_chunk); flash_decode
    # adds its timing at gemma3-4b's, granite's, zamba2's and internvl2's
    # serving shapes, ssd_chunk at zamba2's two-group chunk
    rows = []
    for name, (route, source, replaces) in KERNELS.items():
        row = {"name": name, "route": route, "source": source,
               "replaces": replaces, "launches": sum(launches[name].values()),
               "launches_by_path": launches[name],
               "max_abs_err": timing[name]["max_abs_err"], "ms": timing[name]["ms"],
               "plain_ms": timing[name]["plain_ms"],
               "bound_ms": timing[name]["bound_ms"],
               "bound_by": timing[name]["bound_by"],
               "library_ms": timing[name]["library_ms"]}
        if name == "flash_decode_paged":
            row.update({k: timing[name][k] for k in (
                "library", "flash_decode_on_gathered_ms", "gather_ms", "page_size",
                "table")})
            for arch, label in (("gemma3_4b_ring", "gemma3_ring"), ("zamba2_7b", "zamba2")):
                row[arch] = {k: PAGED_TIMING[label][k] for k in (
                    "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "flash_decode_on_gathered_ms", "gather_ms", "max_abs_err")}
        if name == "flash_decode":
            row["gemma3_4b_ring"] = {k: RING_TIMING[k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_backend", "max_abs_err")}
            # flash_decode_lse at rank 0's span of nemotron-4-340b's decode
            # (rank_of_256: the tensor-core kernel)
            row["nemotron_lse_span"] = {k: lse_span[k] for k in (
                "shape", "path", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err", "lse_max_abs_err")}
            for arch, timing_of in (("gemma3_4b", GEMMA3_TIMING),
                                    ("granite_moe_3b", GRANITE_TIMING),
                                    ("zamba2_7b", ZAMBA2_TIMING),
                                    ("internvl2_1b", INTERNVL2_TIMING)):
                row[arch] = {k: timing_of[k] for k in (
                    "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "library_backend", "max_abs_err")}
        elif name == "ssd_chunk":
            row["zamba2_7b"] = {k: ZAMBA2_SSD_TIMING[k] for k in (
                "shape", "groups", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")}
        elif name == "ssd_chunk_bwd":
            row["ctas_per_sm"] = timing[name]["ctas_per_sm"]
            for arch, label in (("zamba2_7b", "zamba2"), ("train_mamba2_call", "mamba2_train")):
                row[arch] = {k: SSD_BWD_TIMING[label][k] for k in (
                    "shape", "groups", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "max_abs_err", "ctas_per_sm")}
        rows.append(row)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
