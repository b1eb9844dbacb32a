#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA Hopper card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printing JSON lines (any failed check exits non-zero):

1. device    — the card's name and power limit (nvidia-smi), capability 9.0;
2. build     — compile every kernel from ``kernels/csrc``, one ``nvcc`` per
               source, all started together;
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
               heads, zamba2's layout) in every dtype pair, mamba2-2.7b's
               prefill chunk (L=256, H=80, P=64, N=128, bf16, B/C one group
               at head stride 0) with the original and a slow decay, and
               zamba2-7b's (L=256, H=112, P=64, N=64, bf16, B/C from 2
               groups);
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
11. parity_gemma3 — gemma3-4b at full width, one period (5 window layers
               of 1024 and a global layer), fp32, 2 slots: a 1,090-token
               prompt with 16 new tokens (every ring wraps) and two short
               requests, served as ``parity`` serves qwen3;
12. serve_gemma3 — ``serve.run`` on full-width gemma3-4b (34 layers, bf16)
               with the serve phase's slots and requests: all finish, the
               state is one buffer of exactly 1,635,778,560 B (29 rings of
               1024 positions, 5 global caches of 2048) that never moves,
               every decode step is a replay of one graph holding 5
               flash_decode launches (the global layers; window layers run
               the plain attention, as in the reference); then 8 steady
               waves timed and 8 profiled;
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
21. parity_internvl2 — internvl2-1b at full width and depth (24 layers,
               flash_decode at (64, 7)), fp32, 2 slots, a 300-token prompt
               and two short ones, served as ``parity`` serves qwen3;
22. serve_internvl2 — ``serve.run`` on full-width internvl2-1b: 24
               flash_decode launches per replay, the state exactly
               201,326,592 B; 8 steady waves timed and 8 profiled;
23. prefill_internvl2 — full-width internvl2-1b prefills 256 seeded image
               embeddings and 1,792 tokens through ``ArenaExecutor`` from
               its certified plan, equal to eager; no kernel;
24. smem      — for each kernel instantiation on the paths, the shared
               memory ``kernels/smem_plan.py`` plans for one CTA beside what
               the kernel requests at launch (its exported ``*_smem_bytes``
               query) and the device's opt-in limit: the plan fits, and plans
               no more than the kernel requests.

Every engine is built with ``REPRO_STARTUP_LINT=1``, so its unified plan
(activation and state) is certified by ``analysis/soundness`` before it
captures or serves; the serve, serve_block and every serve_* phase print
it as a ``plan`` row (records, the certifier's seconds, findings: 0), and
the prefill phases certify the plan their executor runs from with
``certify_plan``. The profile, serve_block, serve_* (but serve_mamba) and
prefill phases print a ``roofline`` row: the step's FLOPs and least bytes
from ``launch/roofline.step_count`` (at the positions the profiled waves
read; a ring up to its window), its bound on this card, the device time
measured, their ratio (``roofline_share``) and the model FLOPs
utilisation (``mfu``).

Every path runs at its full depth (the parity phases cut depth). The
kernel counts (each wrapper's launches plus each replayed graph's
captured launches per replay) are set to 0 just before each path (phases
5, 9, 10, 12, 13, 15, 16, 17, 19, 20, 22, 23; 7 for its own check) and
read just after it.

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
    paths = build.build_all(list(KERNELS))
    for name in KERNELS:
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
              paths["flash_decode"].with_suffix(".log"))})


def flash_decode_ptxas(log_path) -> dict:
    """``-Xptxas -v``'s registers and spill stores of each flash_decode
    instantiation, keyed ``dtype/D/G`` (from the kernel's mangled name)."""
    log = log_path.read_text() if log_path.exists() else ""
    out = {}
    for chunk in log.split("Compiling entry function")[1:]:
        m = re.search(r"flash_decode_split_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        if m is None or regs is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        dtype = "float32" if m.group(1) == "f" else "bfloat16"
        out[f"{dtype}/{m.group(2)}/{m.group(3)}"] = {
            "registers": int(regs.group(1)),
            "spill_store_bytes": int(spill.group(1)) if spill else 0}
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
    global attention layer and one per insertion of the shared block."""
    return sum(1 for spec in (*cfg.period * cfg.n_periods, *cfg.remainder)
               if (spec.mixer == "attn" and spec.window is None) or spec.shared_attn)


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
               "n_split": fd.num_splits(B, KV, T),
               "scratch_bytes": fd.scratch_bytes(B, KV, G, D, T)}
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
# repeated over theirs (zamba2's layout), and the prefill chunks of
# mamba2-2.7b and zamba2-7b
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
    ("ssd_chunk", {"P": 64, "N": 128, "dtype": "bfloat16", "state_dtype": "bfloat16"}),
    ("ssd_chunk", {"P": 64, "N": 128, "dtype": "float32", "state_dtype": "float32"}),
    ("ssd_chunk", {"P": 64, "N": 64, "dtype": "bfloat16", "state_dtype": "bfloat16"}),
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
        else:
            kp = sp.plan_ssd_chunk_smem(**shape)
            requested = sc.smem_request_bytes(shape["P"], shape["N"],
                                              getattr(torch, shape["dtype"]),
                                              getattr(torch, shape["state_dtype"]))
        planned = kp.plan.total_size
        row = {"phase": "smem", "kernel": kernel, **shape, "planned_bytes": planned,
               "requested_bytes": requested, "naive_bytes": kp.plan.naive_size,
               "optin_limit_bytes": limit, "model_budget_bytes": kp.budget,
               "fits": kp.fits and requested <= limit,
               "planned_minus_requested": planned - requested}
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


def phase_parity_gemma3() -> None:
    """gemma3-4b at full width, its depth cut to one period (5 window
    layers of 1024 and a global layer), fp32, 2 slots: one request of a
    1,090-token prompt and 16 new tokens, so every ring wraps, and two
    short ones, so a slot is reused. The same three ways as ``parity``.
    fp32, as qwen3's parity: in bf16 the plain attention rounds its scores
    to bf16 (the reference's cast point) where the kernel keeps fp32, so
    greedy tokens would test rounding, not the kernel; the bf16 kernel is
    held in the kernels phase and served in serve_gemma3."""
    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config("gemma3-4b"), n_periods=1, remainder=(),
                              dtype="float32")
    run_parity("parity_gemma3", cfg, [(1090, 16), (37, 20), (5, 12)], n_slots=2,
               max_len=1280)


def run_parity(phase: str, cfg, requests, *, n_slots: int, max_len: int,
               cores=("kernel", "plain")) -> dict:
    """Serve ``requests`` ((prompt length, new tokens) each) on ``cfg``
    with an engine per core of ``cores`` (the kernel core first), hold
    every captured step of the kernel-core engine against the eager
    ``decode_step``, and, with the plain core too, hold the two engines'
    logits, greedy tokens and slot logs together. Each engine's state is
    its plan, and each of its graphs holds one ``flash_decode`` launch
    per global attention layer and shared-block insertion on the kernel
    core, none on the plain one. The row's ``launches`` are the engines' own (the warm-up run of
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
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd_chunk as sc

    return {"flash_decode": fd.LAUNCHES, "ssd_chunk": sc.LAUNCHES}


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


def plan_row(label: str, stats: dict) -> None:
    """A serve run's engine was built with the startup lint on: its
    unified plan (activation and state) was certified before it captured
    or served (a finding would have raised in the engine)."""
    if stats["startup_lint_findings"] is None:
        fail(f"plan: the {label} engine ran without its startup lint")
    if stats["startup_lint_findings"]:
        fail(f"plan: {stats['startup_lint_findings']} findings on the {label} plan")
    emit({"phase": "plan", "plan": label, "records": stats["plan_records"],
          "state_leaves": stats["state_leaves"],
          "certify_s": stats["startup_lint_s"],
          "findings": stats["startup_lint_findings"], "ok": True})
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
        fail(f"profile: {len(done)} of {n_req} requests finished")
    if not prof["device_ms_per_wave"] > 0:
        fail("profile: the profiler saw no device time")
    emit({"phase": "profile", "decode_step_ops": len(engine.decode_graph.ops),
          "replays": engine.state.graphs["step"].replays, **prof, "ok": True})
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
    one graph whose flash_decode launches are the 5 global layers', the
    state exactly 1,635,778,560 B; its roofline reads the rings up to
    their window."""
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
    """internvl2-1b at full width and depth (24 layers, 14/2 heads of 64:
    flash_decode at (64, 7)), fp32, 2 slots: a 300-token prompt and two
    short ones, served as ``parity`` serves qwen3 (decode has no image
    prefix, as in the reference engine)."""
    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config(INTERNVL2), dtype="float32")
    run_parity("parity_internvl2", cfg, [(300, 16), (37, 12), (5, 10)], n_slots=2,
               max_len=512)


# zamba2-7b's state at 8 slots x 2048 positions, bf16, before alignment: 13
# shared K/V pairs of 2048 x 32 x 224, and 81 Mamba2 layers' conv windows (3
# x 7424) and states (112 x 64 x 64)
ZAMBA2_STATE_LEAF_BYTES = (13 * 2 * 2048 * 32 * 224
                           + 81 * (3 * 7424 + 112 * 64 * 64)) * 2 * 8  # 6,730,313,728
# internvl2-1b's: 24 layers x K and V x 8 slots x 2048 x 2 heads x 64 x 2 B
INTERNVL2_STATE_BYTES = 24 * 2 * 8 * 2048 * 2 * 64 * 2  # 201,326,592


def run_serve(phase: str, arch: str, card_name: str, state_ok,
              extra: dict | None = None) -> tuple[dict, dict]:
    """``serve.run`` on full-width ``arch`` (bf16, random weights from a
    seed) with 8 slots x 2048 positions and the qwen3 serve mix: all
    finish, every decode step is a replay of the one captured graph with
    ``flash_decode_per_step`` launches, the state is one buffer of
    exactly the planned size (``state_ok`` holds it to the leaves) that
    never moves; then 8 more requests for a steady window, 8 waves timed
    and 8 profiled, and the roofline. ``extra`` joins the phase's row."""
    import numpy as np
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
    # a steady window: 8 requests more, every slot active
    waves = 8
    rng = np.random.default_rng(1)
    for _ in range(n_req):
        engine.submit(rng.integers(0, cfg.vocab, size=4).astype(np.int32),
                      max_new_tokens=2 * waves + 4)
    done = engine.step()  # admits every request
    prof, finished = serve.profile_waves(engine, waves)
    done += finished + engine.run_until_done()
    if len(done) != n_req:
        fail(f"{phase}: {len(done)} of {n_req} profiled requests finished")
    if not prof["device_ms_per_wave"] > 0:
        fail(f"{phase}: the profiler saw no device time")
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


PHASES = ("device", "build", "kernels", "parity", "serve", "profile",
          "serve_block", "prefill_parity", "prefill", "serve_mamba",
          "parity_gemma3", "serve_gemma3", "prefill_gemma3", "parity_granite",
          "serve_granite", "prefill_granite", "parity_llama4", "parity_zamba2",
          "serve_zamba2", "prefill_zamba2", "parity_internvl2", "serve_internvl2",
          "prefill_internvl2", "smem")


T0 = time.perf_counter()


def main() -> None:
    global KEEP_GOING
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %(default)s (device and "
                         "build always run)")
    ap.add_argument("--keep-going", action="store_true",
                    help="check every kernel case before failing")
    args = ap.parse_args()
    phases = set(args.phases.split(",")) | {"device", "build"}
    if phases - set(PHASES):
        fail(f"unknown phases {sorted(phases - set(PHASES))}")
    KEEP_GOING = args.keep_going
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no src/repro_torch)")
    sys.path.insert(0, str(ROOT / "src"))
    smi, card_name = phase_device()
    # every engine built below certifies its unified plan before it serves
    os.environ["REPRO_STARTUP_LINT"] = "1"
    phase_build()
    timing = {}
    if "kernels" in phases:
        timing["flash_decode"] = phase_kernels(card_name)
        timing["ssd_chunk"] = phase_kernels_ssd(card_name)
        emit({"phase": "kernels", "checked": list(KERNELS),
              "failed_cases": FAILED_CASES})
        if FAILED_CASES:
            fail(f"{len(FAILED_CASES)} kernel case(s) over their bars: {FAILED_CASES}")
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
    if "smem" in phases:
        phase_smem()
    if phases != set(PHASES):
        return
    if len(CERTIFIED) != 12 or len(roofs) != 11:
        fail(f"certified plans {CERTIFIED}, roofline rows {len(roofs)}: "
             f"expected 12 and 11")
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
        if name == "flash_decode":
            for arch, timing_of in (("gemma3_4b", GEMMA3_TIMING),
                                    ("granite_moe_3b", GRANITE_TIMING),
                                    ("zamba2_7b", ZAMBA2_TIMING),
                                    ("internvl2_1b", INTERNVL2_TIMING)):
                row[arch] = {k: timing_of[k] for k in (
                    "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "library_backend", "max_abs_err")}
        else:
            row["zamba2_7b"] = {k: ZAMBA2_SSD_TIMING[k] for k in (
                "shape", "groups", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")}
        rows.append(row)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
