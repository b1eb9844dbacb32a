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
    PYTHONPATH=src python -m repro_torch.launch.serve --full --block-size 8 \\
        --sample --temperature 0.8 --top-k 50

``--block-size K`` runs K decode waves per host sync with on-device
sampling; ``--sample`` draws with ``--temperature``/``--top-k`` instead
of the greedy argmax (on the host in the host loop, on the device in
blocks), seeded by ``--seed``.

``--arch`` takes the ported archs (qwen3-0.6b, mamba2-2.7b); prompts go
token by token through the decode step, as in the reference.

``--device cpu`` runs on the CPU (tests); the default is the card, and
without one the engine raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.analysis import counters
from repro_torch.configs.base import ARCH_IDS, get_config, get_reduced
from repro_torch.models.api import DecoderModel
from repro_torch.runtime.engine import InferenceEngine, resolve_device


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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    print(f"initializing {cfg.name} ({cfg.n_layers}L d={cfg.d_model}, "
          f"{cfg.dtype}) on {device}...")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = DecoderModel(cfg, device).init(gen)
    t0 = time.perf_counter()
    engine = InferenceEngine(
        cfg, params, n_slots=args.slots, max_len=args.max_len, device=device,
        greedy=not args.sample, sample_seed=args.seed,
        temperature=args.temperature, top_k=args.top_k, eos_id=args.eos_id,
        block_size=args.block_size,
    )
    cold_start_s = time.perf_counter() - t0
    print(f"--- engine cold start: {cold_start_s:.3f}s (trace + plan + "
          f"state allocation + capture) ---")

    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        engine.submit(
            rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new,
        )
    state_ptr = engine.state.buf.data_ptr()
    arena_ptr = engine.activation_arena.buf.data_ptr()
    replays0 = {k: g.replays for k, g in engine.state.graphs.items()}
    t0 = time.perf_counter()
    with counters.capture("host_syncs", "capture_calls") as cap:
        done = engine.run_until_done()
        _sync(device)
    wall = time.perf_counter() - t0
    host_syncs = cap.delta("host_syncs")
    report = engine.memory_report
    print("--- memory report (the paper's planner on the decode step) ---")
    print(report.summary())
    print(f"--- live device state: {report.state_live_bytes} B (planned "
          f"{report.state_planned_bytes} B) ---")
    toks = sum(len(r.tokens) for r in done)
    print(f"--- served {len(done)} requests, {toks} tokens in {wall:.3f}s "
          f"({toks / wall:.1f} tok/s, {engine.waves} waves, "
          f"{engine.decode_calls} decode steps, {host_syncs} host syncs, "
          f"{engine.n_blocks} blocks) ---")
    for r in done[:3]:
        print(f"req {r.request_id}: waves [{r.admitted_wave},{r.finished_wave}] "
              f"tokens {r.tokens[:8]}...")
    print(f"slot log (slot, admitted, finished, rid): {engine.slot_log}")
    n_ops = len(engine.decode_graph.ops)
    print(f"decode step: {n_ops} traced aten ops ({n_ops / cfg.n_layers:.1f} "
          f"per layer)")
    return {
        "device": str(device),
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
        "executor_copied_bytes": engine.executor.stats.copied_bytes,
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
        "allocator_step_peak_bytes": report.allocator_step_peak_bytes,
        "state_planned_bytes": report.state_planned_bytes,
        "state_live_bytes": report.state_live_bytes,
        "state_ptr_before": state_ptr,
        "state_ptr_after": engine.state.buf.data_ptr(),
        "arena_ptr_before": arena_ptr,
        "arena_ptr_after": engine.activation_arena.buf.data_ptr(),
        "last_logits_finite": bool(
            engine.last_logits is not None and np.isfinite(engine.last_logits).all()
        ),
        "decode_step_ops": n_ops,
        "engine": engine,
    }


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
    full block size, and the summary is per block (and per wave)."""
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


def main() -> None:
    run()


if __name__ == "__main__":
    main()
