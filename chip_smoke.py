#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA Hopper card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printing one JSON line (any failed check exits non-zero):

1. device   — the card's name and power limit (nvidia-smi), capability 9.0;
2. build    — compile every kernel of the served path from ``kernels/csrc``;
3. kernels  — hold each kernel against its plain PyTorch version computed
              in fp32 on the same inputs (the CPU test cases, a length-1 row,
              a cache that is a strided view into a state buffer, and the
              serving shape), and time the kernel, the plain version and one
              PyTorch library call with CUDA events (median of 100 runs, L2
              flushed before each run);
4. parity   — a full-width 2-layer fp32 engine served twice from one seed,
              with the kernel attention and with the plain attention: greedy
              tokens identical, logits within 1e-4;
5. serve    — ``repro_torch.launch.serve.run`` on full-width qwen3-0.6b (28
              layers, bf16) with 8 slots x 2048 positions and 8 requests: all
              finish, the state is one buffer of exactly the planned size that
              never moves, and the kernel ran on every layer of every step;
6. profile  — the same engine on 8 more requests: 8 steady waves timed,
              8 more under torch.profiler (device time per wave, its share
              of the wall time, kernel launches per wave, top kernels).

The last three lines are the card's name and power limit, the per-kernel
record and the ``ok`` line.
"""

from __future__ import annotations

import dataclasses
import json
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
}
FP32_CUDA_CORE_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
# queries at 8x the cache's spread: scores of std 2 at any D, so the softmax
# is peaked and the output is O(0.1) even over 2048 positions
Q_STD = 4.0
DEVICE = "cuda"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def peak_bandwidth(name: str) -> float:
    """Published HBM bandwidth (bytes/s) of the card nvidia-smi names."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name:
        return 3.35e12  # SXM
    fail(f"no published memory bandwidth known for {name!r}")
    return 0.0


def cuda_time_ms(fn, runs: int = 100, warmup: int = 10) -> float:
    """Median device time of ``fn`` over ``runs`` launches, each after a
    write of 256 MiB that pushes its inputs out of the 50 MB L2 (as the
    serving loop finds them: 27 other layers run between two reads)."""
    import torch

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=DEVICE)
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_device() -> tuple[str, float]:
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
    return smi, peak_bandwidth(name)


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
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})


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


def phase_kernels(peak_bw: float) -> dict:
    import torch
    import torch.nn.functional as F

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
            fail(f"flash_decode {label}: max abs err {float(err.max())} over "
                 f"{atol} + {rtol} * |want|")
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

    # the serving shape, on the serving layout: layer 0 of full-width
    # qwen3-0.6b's state buffer at 8 slots x 2048 positions, bf16
    cfg = get_config("qwen3-0.6b")
    B, T = 8, 2048
    KV, D = cfg.n_kv_heads, cfg.resolved_head_dim
    G = cfg.n_heads // KV
    buf, caches = _residency_cache(cfg, B, T, gen)
    k, v = caches["period"][0]["attn"][0][0], caches["period"][0]["attn"][1][0]
    q = rand((B, KV, G, D), torch.bfloat16, Q_STD)
    record = {}
    for label, lengths in (
        ("serving_full", torch.full((B,), T, dtype=torch.int32, device=DEVICE)),
        ("serving_random", torch.randint(1, T + 1, (B,), generator=gen,
                                         device=DEVICE, dtype=torch.int32)),
    ):
        err = check(label, q, k, v, lengths)
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
        itemsize = q.element_size()
        nbytes = (total_len * KV * D * 2 * itemsize + 2 * q.numel() * itemsize
                  + lengths.numel() * 4)
        flops = 4 * total_len * KV * G * D
        bytes_ms = nbytes / peak_bw * 1e3
        ops_ms = flops / FP32_CUDA_CORE_FLOPS * 1e3
        row = {"phase": "kernels", "kernel": "flash_decode", "timing": label,
               "shape": [B, KV, G, D, T], "sum_lengths": total_len,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "library": "F.scaled_dot_product_attention(enable_gqa=True)",
               "library_max_abs_err": lib_err,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes": nbytes, "flops": flops, "max_abs_err": err}
        emit(row)
        record[label] = row
    del buf, caches
    emit({"phase": "kernels", "checked": list(KERNELS)})
    return record["serving_full"]


def phase_parity() -> None:
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models.api import DecoderModel
    from repro_torch.runtime.engine import InferenceEngine

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_periods=2,
                              dtype="float32")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = DecoderModel(cfg, DEVICE).init(gen)
    engines = {
        a: InferenceEngine(cfg, params, n_slots=4, max_len=128, device=DEVICE,
                           attention=a)
        for a in ("kernel", "plain")
    }
    rng = np.random.default_rng(0)
    for n, new in zip((3, 5, 8, 2, 6, 4), (6, 9, 4, 7, 5, 8)):
        prompt = rng.integers(0, cfg.vocab, size=n).astype(np.int32)
        for e in engines.values():
            e.submit(prompt, max_new_tokens=new)
    worst = 0.0
    ek, ep = engines["kernel"], engines["plain"]
    done = {"kernel": {}, "plain": {}}
    while ek.unfinished_requests() or ep.unfinished_requests():
        for a, e in engines.items():
            done[a].update({r.request_id: r.tokens for r in e.step()})
        if ek.last_logits is None or ep.last_logits is None:
            continue
        diff = np.abs(ek.last_logits - ep.last_logits)
        worst = max(worst, float(diff.max()))
        if not np.all(diff <= 1e-4 + 1e-4 * np.abs(ep.last_logits)):
            fail(f"parity: logits differ by {float(diff.max())} at wave {ek.waves}")
    if done["kernel"] != done["plain"] or len(done["kernel"]) != 6:
        fail(f"parity: greedy tokens differ {done['kernel']} vs {done['plain']}")
    if ek.slot_log != ep.slot_log:
        fail(f"parity: slot logs differ {ek.slot_log} vs {ep.slot_log}")
    emit({"phase": "parity", "layers": cfg.n_layers, "waves": ek.waves,
          "logits_max_abs_diff": worst, "slot_log": ek.slot_log, "ok": True})


def phase_serve() -> tuple[dict, object]:
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch import serve

    n_req, prompt_len, max_new = 8, 32, 64
    fd.LAUNCHES = 0
    stats = serve.run([
        "--full", "--arch", "qwen3-0.6b", "--slots", "8", "--max-len", "2048",
        "--requests", str(n_req), "--prompt-len", str(prompt_len),
        "--max-new", str(max_new), "--seed", "0",
    ])
    launches = fd.LAUNCHES
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
    if launches != stats["decode_calls"] * stats["n_layers"]:
        fail(f"serve: {launches} flash_decode launches, expected "
             f"{stats['decode_calls']} decode steps x {stats['n_layers']} layers")
    emit({
        "phase": "serve", "arch": "qwen3-0.6b", "layers": stats["n_layers"],
        "requests": stats["requests"], "tokens": stats["tokens"],
        "waves": stats["waves"], "decode_steps": stats["decode_calls"],
        "wall_s": stats["wall_s"], "tokens_per_s": stats["tokens_per_s"],
        "cold_start_s": stats["cold_start_s"],
        "flash_decode_launches": launches,
        "planned_activation_mib": stats["plan_total_bytes"] / 2**20,
        "activation_lower_bound_mib": stats["plan_lower_bound_bytes"] / 2**20,
        "activation_naive_mib": stats["plan_naive_bytes"] / 2**20,
        "allocator_step_peak_mib": stats["allocator_step_peak_bytes"] / 2**20,
        "state_mib": stats["state_live_bytes"] / 2**20,
        "first_tokens": {k: v[:4] for k, v in list(toks.items())[:2]},
        "ok": True,
    })
    return {"launches": launches}, stats["engine"]


def phase_profile(engine) -> None:
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
          **prof, "ok": True})


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no src/repro_torch)")
    smi, peak_bw = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    phase_build()
    timing = phase_kernels(peak_bw)
    phase_parity()
    serve, engine = phase_serve()
    phase_profile(engine)
    import torch

    route, source, replaces = KERNELS["flash_decode"]
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "flash_decode", "route": route, "source": source,
        "replaces": replaces, "launches": serve["launches"],
        "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
