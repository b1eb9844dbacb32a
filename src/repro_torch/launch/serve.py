"""Serving entry point: batched-request inference with the planned engine.

Thin twin of the reference's ``repro.launch.serve`` serving path: build
the model (random weights from ``--seed``), start the
:class:`~repro_torch.runtime.engine.InferenceEngine` on the card, submit
``--requests`` prompts, serve them to completion, and print the memory
report, tokens/s and the slot log.

    PYTHONPATH=src python -m repro_torch.launch.serve --full \\
        --slots 8 --max-len 2048 --requests 8 --prompt-len 32 --max-new 64
    PYTHONPATH=src python -m repro_torch.launch.serve --full \\
        --arch mamba2-2.7b --slots 8 --requests 8 --prompt-len 32 --max-new 64
    PYTHONPATH=src python -m repro_torch.launch.serve --full \\
        --arch granite-moe-3b-a800m --slots 8 --max-len 2048 --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --full \\
        --arch zamba2-7b --slots 8 --max-len 2048 --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --full --block-size 8 \\
        --sample --temperature 0.8 --top-k 50

``--page-size B`` serves the paged state backend (pages of B bytes,
``--page-pool`` of them) for every arch: K/V caches, global, ring or the
shared block's, and Mamba2 states are written and read through the page
table. On the CPU, e.g.::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --page-size 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch zamba2-7b --page-size 1024

``--block-size K`` runs K decode waves per host sync with on-device
sampling; ``--sample`` draws with ``--temperature``/``--top-k`` instead
of the greedy argmax (on the host in the host loop, on the device in
blocks), seeded by ``--seed``.

``--arch`` takes the ported archs (qwen3-0.6b, mamba2-2.7b, gemma3-4b,
gemma3-27b, granite-moe-3b-a800m, zamba2-7b, internvl2-1b;
nemotron-4-340b and llama4-maverick-400b-a17b without ``--full``);
prompts go token by token through the decode step, as in the reference
(internvl2's decode has no image prefix, as in the reference engine).

``--plan-bundle PATH`` serves from a compiled plan artifact, a bundle
file or a manifest directory from ``launch/compile.py`` (nearest
admissible bucket unless ``--exact-bucket``): the engine then runs no
planner and lays no state out, and falls back to planning at
construction with a one-line warning when the bundle does not fit.
``--compile-first`` compiles the bucket into ``--plan-bundle`` (default
``plan_artifacts/torch``) before the engine starts, and
``--compare-cold-start`` also builds a plan-at-construction engine and
prints both cold starts. E.g.::

    PYTHONPATH=src python -m repro_torch.launch.compile --arch qwen3-0.6b \
        --full --slots 8 --max-len 2048 --out plan_artifacts/torch
    PYTHONPATH=src python -m repro_torch.launch.serve --full --slots 8 \
        --max-len 2048 --plan-bundle plan_artifacts/torch --compare-cold-start

A bundle compiled with its AOT decode program (``launch/compile.py``'s
default; ``--no-aot`` leaves it out) also gives the engine its step's
program: the engine then traces nothing (``trace_calls`` 0, ``trace_s``
None, ``aot_executables`` names the program) and still captures its
CUDA graphs.

``--no-residency`` (or ``REPRO_STATE_RESIDENCY=off``) serves the pytree
backend: caches owned by the caching allocator and the model's step run
eagerly, with the plans kept as accounting (``state_residency`` false);
a paged bucket then serves symmetric state with one warning.

``--device cpu`` runs on the CPU (tests); the default is the card, and
without one the engine raises.
"""

from __future__ import annotations

import argparse
import gc
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.analysis import counters
from repro_torch.configs.base import ARCH_IDS, get_config, get_reduced
from repro_torch.core.shared_objects import from_page_log, from_slot_log
from repro_torch.core.unified import PlanSession
from repro_torch.models.api import DecoderModel
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.engine import InferenceEngine


def run(argv: list[str] | None = None) -> dict:
    """Parse args, serve, return a stats dict (``chip_smoke.py`` and the
    tests call this directly). Its ``engine`` is the engine that served,
    idle and ready for more requests."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="the arch's full config (default: its reduced one)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the prompts")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--block-size", type=int, default=1,
                    help="decode waves per host sync (1 = single-wave host "
                         "loop; K > 1 = block decode with on-device "
                         "sampling and stop detection)")
    ap.add_argument("--sample", action="store_true",
                    help="temperature/top-k sampling instead of greedy "
                         "argmax")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=None,
                    help="retire a request when it emits this token")
    ap.add_argument("--page-size", type=int, default=None,
                    help="serve the PAGED state backend: per-slot page "
                         "tables over a pool of fixed pages of this many "
                         "bytes")
    ap.add_argument("--page-pool", type=int, default=None,
                    help="physical pool page count for --page-size "
                         "(default: slots x pages-per-slot)")
    ap.add_argument("--no-residency", action="store_true",
                    help="serve the pytree state backend (allocator-owned "
                         "caches, the step run eagerly; default: the "
                         "REPRO_STATE_RESIDENCY knob, on)")
    ap.add_argument("--plan-bundle", default=None,
                    help="precompiled plan artifact: a bundle file or a "
                         "manifest directory from launch/compile.py")
    ap.add_argument("--exact-bucket", action="store_true",
                    help="disable nearest-bucket auto-selection (serve "
                         "only an exact (slots, max_len, dtype) match)")
    ap.add_argument("--compile-first", action="store_true",
                    help="run the plan compiler into --plan-bundle (default "
                         "plan_artifacts/torch) before starting the engine")
    ap.add_argument("--compare-cold-start", action="store_true",
                    help="also time a plan-at-construction engine so the "
                         "artifact's cold-start win is printed side by side")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    bundle_dir = args.plan_bundle
    if args.compile_first:
        from repro_torch.launch.compile import DEFAULT_BUNDLE_DIR, compile_and_publish

        bundle_dir = bundle_dir or DEFAULT_BUNDLE_DIR
        t0 = time.perf_counter()
        res = compile_and_publish(
            cfg, bundle_dir, n_slots=args.slots, max_len=args.max_len,
            command="launch/serve.py --compile-first",
            block_size=args.block_size, greedy=not args.sample,
            temperature=args.temperature, top_k=args.top_k,
            page_size=args.page_size, page_pool=args.page_pool,
        )
        print(f"compiled plan bundle in {time.perf_counter() - t0:.2f}s: "
              f"{res.bundle.summary()}")
    session = None
    if bundle_dir is not None:
        if Path(bundle_dir).is_dir():
            session = PlanSession.from_manifest(bundle_dir,
                                                nearest=not args.exact_bucket)
        else:
            session = PlanSession.from_bundle(bundle_dir)
    print(f"initializing {cfg.name} ({cfg.n_layers}L d={cfg.d_model}, "
          f"{cfg.dtype}) on {device}...")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = DecoderModel(cfg, device).init(gen)

    def build(session):
        return InferenceEngine(
            cfg, params, n_slots=args.slots, max_len=args.max_len, device=device,
            greedy=not args.sample, sample_seed=args.seed,
            temperature=args.temperature, top_k=args.top_k, eos_id=args.eos_id,
            block_size=args.block_size, page_size=args.page_size,
            page_pool=args.page_pool, session=session,
            state_residency=False if args.no_residency else None,
        )

    before_engine = _allocated(device)
    with counters.capture("trace_calls", "plan_calls", "state_plan_calls") as cap:
        t0 = time.perf_counter()
        engine = build(session)
        cold_start_s = time.perf_counter() - t0
        built = cap.deltas()
    report = engine.memory_report
    trace = ("program from the bundle" if report.aot_executables
             else f"trace {report.trace_s:.3f}s")
    work = (f"{trace} + state allocation + capture; plans from the bundle"
            if report.plan_source == "bundle"
            else f"{trace} + plan + state allocation + capture")
    print(f"--- engine cold start: {cold_start_s:.3f}s (plan source: "
          f"{report.plan_source}; {work}; state residency "
          f"{'on' if report.state_residency else 'off'}) ---")
    if report.bundle_warning:
        print(f"--- WARNING: {report.bundle_warning} ---")
    if report.aot_warning:
        print(f"--- WARNING: {report.aot_warning} ---")
    if report.aot_executables:
        print(f"--- AOT decode program(s) {list(report.aot_executables)} loaded "
              f"in {report.aot_load_s:.3f}s ---")
    if engine.max_len != args.max_len:
        print(f"--- bucket auto-selection: requested max_len={args.max_len} "
              f"-> serving the compiled len={engine.max_len} bucket ---")
    if engine.n_slots != args.slots:
        print(f"--- bucket auto-selection: requested slots={args.slots} "
              f"-> serving the compiled slots={engine.n_slots} pool ---")
    cold_start_noartifact_s = None
    if args.compare_cold_start and report.plan_source == "bundle":
        _sync(device)
        t0 = time.perf_counter()
        build(None)
        cold_start_noartifact_s = time.perf_counter() - t0
        print(f"--- cold start without the artifact: "
              f"{cold_start_noartifact_s:.3f}s "
              f"({cold_start_noartifact_s / max(cold_start_s, 1e-9):.1f}x "
              f"the bundle's) ---")

    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        engine.submit(
            rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new,
        )
    state_ptr = _ptr(engine.state.buf)
    arena_ptr = _ptr(engine.activation_arena and engine.activation_arena.buf)
    replays0 = {k: g.replays for k, g in engine.state.graphs.items()}
    t0 = time.perf_counter()
    with counters.capture("host_syncs", "capture_calls") as cap:
        done = engine.run_until_done()
        _sync(device)
    wall = time.perf_counter() - t0
    # the caching allocator's peak over the serve above what was allocated
    # before the engine was built (its state, arena, graph pool and each
    # step's transients; None on the CPU)
    serve_peak_bytes = (torch.cuda.max_memory_allocated(device) - before_engine
                        if device.type == "cuda" else None)
    host_syncs = cap.delta("host_syncs")
    report = engine.memory_report
    print("--- memory report (the paper's planner on the decode step) ---")
    print(report.summary())
    print(f"--- live device state: {report.state_live_bytes} B (planned "
          f"{report.state_planned_bytes} B, unified plan "
          f"{engine.unified_plan.total_size} B, residency "
          f"{'on' if report.state_residency else 'off'}) ---")
    toks = sum(len(r.tokens) for r in done)
    print(f"--- served {len(done)} requests, {toks} tokens in {wall:.3f}s "
          f"({toks / wall:.1f} tok/s, {engine.waves} waves, "
          f"{engine.decode_calls} decode steps, {host_syncs} host syncs, "
          f"{engine.n_blocks} blocks) ---")
    for r in done[:3]:
        print(f"req {r.request_id}: waves [{r.admitted_wave},{r.finished_wave}] "
              f"tokens {r.tokens[:8]}...")
    # slot-reuse audit: the engine's slot log is a §4 shared-objects
    # assignment (slots = objects, requests = tensors); from_slot_log
    # raises if any two requests overlapped on one slot
    audit = from_slot_log(engine.slot_log, state_plan=report.state_plan)
    print(f"slot log (slot, admitted, finished, rid): {engine.slot_log}")
    print(f"slot audit: {len(audit.assignment)} requests over "
          f"{engine.n_slots} slots, no interval overlap")
    final_report = engine.memory_report
    pages_total = final_report.state_pages_total
    pages_live = final_report.state_pages_live
    pages_peak = None
    if engine.paged:
        sp = report.state_plan
        pages_peak = engine.state.pages_live_peak
        # page-reuse audit, one level below the slot log: pool pages are
        # the shared objects; raises if the allocator ever double-assigned
        # a live page
        page_audit = from_page_log(engine.page_log, state_plan=sp)
        print(f"paged state: pool {pages_total} x {sp.page_size} B pages "
              f"(+1 null), peak live {pages_peak} "
              f"({pages_peak * sp.page_size} B = "
              f"{pages_peak / max(pages_total, 1):.0%} of the pool), "
              f"live now {pages_live}")
        print(f"page audit: {len(page_audit.assignment)} (request, page) "
              f"residencies over {pages_total} pool pages, no interval "
              f"overlap")
    n_ops = len(engine.decode_graph.ops)
    print(f"decode step: {n_ops} traced aten ops ({n_ops / cfg.n_layers:.1f} "
          f"per layer)")
    return {
        "device": str(device),
        "plan_source": report.plan_source,
        "bundle_warning": report.bundle_warning,
        # the counters' deltas over the engine's construction
        **built,
        "plan_resolve_s": report.plan_resolve_s,
        "state_residency": report.state_residency,
        "aot_executables": list(report.aot_executables),
        "aot_warning": report.aot_warning,
        "aot_load_s": report.aot_load_s,
        "trace_s": report.trace_s,
        "cold_start_noartifact_s": cold_start_noartifact_s,
        "requests": len(done),
        "tokens": toks,
        "tokens_per_request": {r.request_id: list(r.tokens) for r in done},
        "waves": engine.waves,
        "decode_calls": engine.decode_calls,
        "wall_s": wall,
        "tokens_per_s": toks / wall if wall > 0 else None,
        "host_syncs": host_syncs,
        "blocks": engine.n_blocks,
        "block_size": engine.block_size,
        "capture_calls": report.capture_calls,
        "capture_calls_while_serving": cap.delta("capture_calls"),
        "capture_s": report.capture_s,
        "graph_pool_bytes": report.graph_pool_bytes,
        "graph_capture_peak_bytes": report.graph_capture_peak_bytes,
        "executor_in_place": report.executor_in_place,
        "executor_copied": report.executor_copied,
        "executor_copied_bytes": (engine.executor.stats.copied_bytes
                                  if engine.executor is not None else 0),
        # kernel launches each graph holds, and its replays while serving
        "graphs": {
            k: {"launches": dict(g.launches), "replays": g.replays - replays0[k]}
            for k, g in engine.state.graphs.items()
        },
        "slot_log": list(engine.slot_log),
        "cold_start_s": cold_start_s,
        "n_layers": cfg.n_layers,
        "plan_total_bytes": report.activation_plan.total_size,
        "plan_lower_bound_bytes": report.activation_plan.lower_bound,
        "plan_naive_bytes": report.activation_plan.naive_size,
        "plan_records": len(report.activation_plan.records),
        "state_leaves": len(report.state_plan.leaves),
        "startup_lint_s": report.startup_lint_s,
        "state_plan_s": report.state_plan_s,
        "startup_lint_findings": report.startup_lint_findings,
        "startup_lint_warnings": list(report.startup_lint_warnings),
        "allocator_step_peak_bytes": report.allocator_step_peak_bytes,
        "serve_peak_bytes": serve_peak_bytes,
        "state_planned_bytes": report.state_planned_bytes,
        "state_live_bytes": report.state_live_bytes,
        # the state buffer's bytes (under paging the null page and the
        # pool; with residency off the caches')
        "allocated_bytes": (engine.state.buf.numel() if engine.state.buf is not None
                            else report.state_live_bytes),
        "page_size": final_report.state_page_size,
        "state_pages_total": pages_total,
        "state_pages_live": pages_live,
        "pages_live_peak": pages_peak,
        "page_log": engine.page_log,
        "state_ptr_before": state_ptr,
        "state_ptr_after": _ptr(engine.state.buf),
        "arena_ptr_before": arena_ptr,
        "arena_ptr_after": _ptr(engine.activation_arena
                                and engine.activation_arena.buf),
        "last_logits_finite": bool(
            engine.last_logits is not None and np.isfinite(engine.last_logits).all()
        ),
        "decode_step_ops": n_ops,
        "engine": engine,
    }


def _allocated(device: torch.device) -> int | None:
    """The caching allocator's bytes in use on ``device``, its peak reset
    to them (None on the CPU). Unreachable objects are collected first:
    tensors of an earlier engine freed later would make a baseline that
    the serve's peak does not exceed."""
    if device.type != "cuda":
        return None
    gc.collect()
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def _ptr(buf) -> int | None:
    """A buffer's address (None without one: residency off)."""
    return None if buf is None else buf.data_ptr()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_waves(engine: InferenceEngine, waves: int, *,
                  blocks_of_waves: bool = False) -> tuple[dict, list]:
    """Serve ``waves`` waves timed by the host clock, then ``waves`` more
    under ``torch.profiler``; returns a summary — wall time per wave
    without the profiler, device time per wave (summed kernel and copy
    time; one stream, so they do not overlap) and its share of the
    unprofiled wall time, kernel launches per wave and the kernels that
    took the most device time — and the requests that finished. The
    waves must be alike (every slot active throughout). With
    ``blocks_of_waves`` each unit is one ``step_block`` of the engine's
    full block size, and the summary is per block (and per wave).
    ``positions_first`` is each slot's position at the first profiled
    wave."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if engine.device.type != "cuda":
        raise RuntimeError("profile_waves measures the card: the engine is not on CUDA")

    step = engine.step_block if blocks_of_waves else engine.step
    per = engine.block_size if blocks_of_waves else 1
    active = len(engine._active)
    finished = []
    _sync(engine.device)
    t0 = time.perf_counter()
    for _ in range(waves):
        finished += step()
    _sync(engine.device)
    wall_us = (time.perf_counter() - t0) * 1e6
    # each slot's position at the first profiled wave (the step at position
    # p reads p + 1 cache positions)
    positions_first = [int(p) for p in engine._slot_pos]
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(waves):
            finished += step()
        _sync(engine.device)
    profiled_wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    n = waves * per
    return {
        "waves": n,
        "positions_first": positions_first,
        "wall_ms_per_wave": wall_us / 1e3 / n,
        "tokens_per_s": active * n / (wall_us / 1e6),
        "profiled_wall_ms_per_wave": profiled_wall_us / 1e3 / n,
        "device_ms_per_wave": device_us / 1e3 / n,
        "device_busy_share": device_us / wall_us,
        "kernel_launches_per_wave": sum(e.count for e in kernels) / n,
        "top_kernels_ms_per_wave": {
            e.key[:60]: e.self_device_time_total / 1e3 / n for e in top
        },
    }, finished


def main(argv: list[str] | None = None) -> dict:
    return run(argv)


if __name__ == "__main__":
    main()
