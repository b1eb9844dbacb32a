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
               that is a strided view into a state buffer, and the serving
               shape at full, random and the serve phase's lengths (with
               its split count and scratch bytes). ``ssd_chunk``: the CPU
               test cases (slow decay included, and the tensor-core
               kernel's edge shapes) in every dtype pair, and mamba2-2.7b's
               prefill chunk (L=256, H=80, P=64, N=128, bf16, B/C one group
               at head stride 0) with the original and a slow decay;
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
               exactly the planned size that never moves.

Every path runs at its full depth. The kernel counts (each wrapper's
launches plus each replayed graph's captured launches per replay) are set
to 0 just before each path (phases 5, 9, 10; 7 for its own check) and read
just after it.

The last three lines are the card's name and power limit, the per-kernel
record and the ``ok`` line. ``--phases`` runs a subset (no final lines), and
``--keep-going`` makes the kernels phase check every case before it fails
(``chip_faults.py`` uses both on copies of the tree with planted faults).
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
    "ssd_chunk": (
        "cuda",
        "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "src/repro/kernels/ssd_chunk.py:49",
    ),
}
FP32_CUDA_CORE_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
BF16_TENSOR_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
# queries at 8x the cache's spread: scores of std 2 at any D, so the softmax
# is peaked and the output is O(0.1) even over 2048 positions
Q_STD = 4.0
DEVICE = "cuda"


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
        # the serve phase's own lengths: 32 prompt + 64 new tokens per slot,
        # so 33 to 96 positions of the 2048
        ("serve_mix", torch.linspace(33, 96, B, device=DEVICE).round().to(torch.int32)),
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
               "bytes": nbytes, "flops": flops, "max_abs_err": err,
               "n_split": fd.num_splits(B, KV, T),
               "scratch_bytes": fd.scratch_bytes(B, KV, G, D, T)}
        emit(row)
        record[label] = row
    del buf, caches
    return record["serving_full"]


# ssd_chunk cases: (B, L, H, P, N) and the decay; the CPU test cases of
# tests/test_torch_ssd.py, one group broadcast over the heads, and the
# prefill chunk of mamba2-2.7b
SSD_CASES = {
    "kernels_0": ((2, 64, 2, 32, 16), "original", False),
    "kernels_1": ((1, 128, 4, 64, 128), "original", False),
    "kernels_2": ((2, 256, 1, 64, 64), "original", False),
    "ragged_L33": ((2, 33, 3, 64, 128), "original", False),
    "L1": ((3, 1, 2, 8, 4), "original", False),
    "slow_L256": ((1, 256, 4, 64, 128), "slow", False),
    "slow_L200_P8": ((2, 200, 3, 8, 4), "slow", False),
    "one_group_L96": ((1, 96, 4, 32, 16), "original", True),
    "one_group_slow_L96": ((1, 96, 4, 32, 16), "slow", True),
    # edges of the tensor-core kernel (bf16 x/B/C): one row in a 64-row tile
    # at P = 64; a ragged second row tile at P = 32, N = 40; N = 13, where x,
    # B and C (slices of one buffer with rows of 154 elements) are loaded
    # element by element, not by 16-byte copies
    "L1_P64": ((2, 1, 3, 64, 128), "slow", False),
    "ragged_L65_P32_N40": ((1, 65, 2, 32, 40), "slow", True),
    "N13_L130": ((1, 130, 2, 64, 13), "slow", True),
}
# (x/B/C dtype, state dtype): every pair the kernel builds. fp32; bf16 x
# with an fp32 state (as tests/test_kernels.py passes it); bf16 throughout
# (as the model does); fp32 x with a bf16 state
SSD_DTYPES = (("float32", "float32"), ("bfloat16", "float32"),
              ("bfloat16", "bfloat16"), ("float32", "bfloat16"))


def ssd_inputs(gen, B, L, H, P, N, decay, one_group, x_dtype, state_dtype):
    """The distributions of tests/test_kernels.py ("original": dA =
    -exp(0.3 z)·dt, ~-0.7 per position) or dA uniform in [-0.02, -0.001]
    ("slow"). With ``one_group``, x, B and C are slices of one (B, L,
    H·P + 2N) buffer, as the model's conv output, and B and C reach the
    heads through a head stride of 0."""
    import torch
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    xd, sd = getattr(torch, x_dtype), getattr(torch, state_dtype)
    dt = F.softplus(randn(B, L, H))
    if decay == "slow":
        dA = -(torch.rand((B, L, H), generator=gen, device=DEVICE) * 0.019 + 0.001)
    else:
        dA = -torch.exp(randn(B, L, H) * 0.3) * dt
    if one_group:
        xbc = (randn(B, L, H * P + 2 * N) * 0.5).to(xd)
        x = xbc[..., : H * P].unflatten(-1, (H, P))
        Bm = xbc[..., H * P : H * P + N][:, :, None].expand(B, L, H, N)
        Cm = xbc[..., H * P + N :][:, :, None].expand(B, L, H, N)
    else:
        x = (randn(B, L, H, P) * 0.5).to(xd)
        Bm = (randn(B, L, H, N) * 0.5).to(xd)
        Cm = (randn(B, L, H, N) * 0.5).to(xd)
    state = (randn(B, H, P, N) * 0.5).to(sd)
    return x, dt, dA, Bm, Cm, state


def phase_kernels_ssd(peak_bw: float) -> dict:
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
        for label, (shape, decay, one_group) in SSD_CASES.items():
            check(label, ssd_inputs(gen, *shape, decay, one_group, x_dtype,
                                    state_dtype))

    # the prefill chunk of full-width mamba2-2.7b, as mamba_prefill passes it
    from repro_torch.configs.base import get_config
    from repro_torch.models.ssm import ssm_dims

    cfg = get_config("mamba2-2.7b")
    _, H, _ = ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim,
                       cfg.ssm_groups, cfg.ssm_state)
    B, L, P, N = 1, 256, cfg.ssm_head_dim, cfg.ssm_state
    record = {}
    for decay in ("original", "slow"):
        label = f"prefill_{decay}"
        inputs = ssd_inputs(gen, B, L, H, P, N, decay, True, "bfloat16", "bfloat16")
        err = check(label, inputs)
        before = sc.LAUNCHES
        ms = cuda_time_ms(lambda: sc.ssd_chunk(*inputs))
        plain_ms = cuda_time_ms(lambda: ssd_chunk_ref(*inputs))
        sc.LAUNCHES = before  # timing launches are not the main path's
        x, dt, dA, Bm, Cm, state = inputs
        # each input read once (B and C: the one group), each output written once
        nbytes = (2 * x.numel() * x.element_size() + 2 * dt.numel() * 4
                  + 2 * B * L * N * Bm.element_size()
                  + 2 * state.numel() * state.element_size())
        pairs = L * (L + 1) // 2  # the causal half of the L x L products
        flops = B * H * 2 * ((N + P) * pairs + 2 * L * P * N)
        flops_full = B * H * 2 * ((N + P) * L * L + 2 * L * P * N)
        bytes_ms = nbytes / peak_bw * 1e3
        ops_ms = flops / BF16_TENSOR_FLOPS * 1e3
        row = {"phase": "kernels", "kernel": "ssd_chunk", "timing": label,
               "shape": [B, L, H, P, N], "ms": ms, "plain_ms": plain_ms,
               "library_ms": None, "library": "none: no one PyTorch call",
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes": nbytes, "flops": flops,
               "flops_full_square": flops_full,
               "bytes_ms": bytes_ms, "bf16_tensor_core_ms": ops_ms,
               "fp32_cuda_core_ms": flops / FP32_CUDA_CORE_FLOPS * 1e3,
               "max_abs_err": err}
        emit(row)
        record[label] = row
    return record["prefill_original"]


def phase_parity() -> None:
    """A full-width 2-layer fp32 qwen3 served three ways from one seed: the
    captured, arena-backed step with the kernel attention, the same with
    the plain attention, and, beside the first, the model's eager
    ``decode_step`` fed the same inputs at every step (admission steps
    included) on caches of its own. Logits of the captured step equal
    the eager step's (bit for bit expected, else within 1e-6) and the
    plain attention's within 1e-4; greedy tokens and slot logs are
    identical."""
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
                           cores=a)
        for a in ("kernel", "plain")
    }
    ek, ep = engines["kernel"], engines["plain"]
    # the eager twin of the kernel engine
    eager = ek.model.init_cache(4, 128)
    twin = {"steps": 0, "bitwise": 0, "max_abs_diff": 0.0}
    step_tokens, reset = ek._step_tokens, ek.state.reset

    def dev(a):
        return torch.from_numpy(np.array(a)).to(DEVICE)

    def checked_step(tokens, pos, active):
        got = step_tokens(tokens, pos, active)
        with torch.no_grad():
            want, _ = ek.model.decode_step(params, dev(tokens), eager, dev(pos),
                                           dev(active))
        diff = float((got - want).abs().max())
        twin["steps"] += 1
        twin["bitwise"] += int(torch.equal(got, want))
        twin["max_abs_diff"] = max(twin["max_abs_diff"], diff)
        if not bool(((got - want).abs() <= 1e-6 + 1e-6 * want.abs()).all()):
            fail(f"parity: captured step differs from the eager step by {diff}")
        return got

    def checked_reset(keep):
        reset(keep)
        ek.model.reset_slots(eager, dev(keep))

    ek._step_tokens, ek.state.reset = checked_step, checked_reset
    rng = np.random.default_rng(0)
    for n, new in zip((3, 5, 8, 2, 6, 4), (6, 9, 4, 7, 5, 8)):
        prompt = rng.integers(0, cfg.vocab, size=n).astype(np.int32)
        for e in engines.values():
            e.submit(prompt, max_new_tokens=new)
    worst = 0.0
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
    for leaf, want in zip(torch.utils._pytree.tree_leaves(ek.caches),
                          torch.utils._pytree.tree_leaves(eager)):
        if not torch.equal(leaf, want) and \
                float((leaf - want).abs().max()) > 1e-6 * (1 + float(want.abs().max())):
            fail("parity: the state differs from the eager twin's caches")
    if twin["steps"] != ek.decode_calls or ek.state.graphs["step"].replays != ek.decode_calls:
        fail(f"parity: {twin['steps']} checked steps, {ek.decode_calls} decode steps")
    emit({"phase": "parity", "layers": cfg.n_layers, "waves": ek.waves,
          "decode_steps": ek.decode_calls,
          "kernel_vs_plain_logits_max_abs_diff": worst,
          "captured_vs_eager": twin, "slot_log": ek.slot_log, "ok": True})


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


def check_replayed(phase: str, stats: dict, kernel: str | None) -> dict:
    """Every decode step of a serve run (counts reset before the engine
    was built) was a replay: the graphs' replays add up to the decode
    steps, nothing was captured while serving, the arena stayed put, and
    ``kernel`` ran once per layer per step, by replays, with the wrapper
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
    layers, warmups = stats["n_layers"], len(graphs)
    eager = wrapper_launches()
    want_eager = {k: (layers * warmups if k == kernel else 0) for k in eager}
    if eager != want_eager:
        fail(f"{phase}: the wrappers launched {eager}, expected {want_eager} "
             f"(the warm-up run of each of the {warmups} captures)")
    if kernel is not None:
        held = {k: g["launches"][kernel] for k, g in graphs.items()}
        replayed = sum(held[k] * g["replays"] for k, g in graphs.items())
        if set(held.values()) != {layers}:
            fail(f"{phase}: captured {kernel} launches per graph {held}, expected "
                 f"{layers} (one per layer)")
        if replayed != stats["decode_calls"] * layers or \
                read_launches()[kernel] != replayed + eager[kernel]:
            fail(f"{phase}: {replayed} replayed {kernel} launches, expected "
                 f"{stats['decode_calls']} decode steps x {layers} layers")
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


def phase_serve_block(host_tokens: dict | None) -> None:
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
          "replays": engine.state.graphs["step"].replays, **prof, "ok": True})


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


def phase_prefill() -> dict:
    """Full-width mamba2-2.7b (64 layers, bf16): one 2048-token request
    through ``ArenaExecutor`` (every intermediate at its planned offset in
    one arena, each ssd_chunk result copied into its slot), against the
    eager ``Model.prefill`` on the same weights and tokens."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.launch.compile import plan_prefill
    from repro_torch.runtime.executor import ArenaExecutor

    S = 2048
    mib = 2**20
    cfg, model, params = _mamba_model(None, "bfloat16", 0)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (1, S), generator=gen, device=DEVICE)
    t0 = time.perf_counter()
    _, meta_plan = plan_prefill(cfg, prefill_len=S)
    plan_s = time.perf_counter() - t0

    def prefill(p, t):
        return model.prefill(p, {"tokens": t})

    t0 = time.perf_counter()
    executor = ArenaExecutor(prefill, params, tokens, device=DEVICE,
                             name=f"{cfg.name}-prefill{S}")
    executor_s = time.perf_counter() - t0
    arena_ptr = executor.arena.buf.data_ptr()
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # the arena included
        reset_launches()
        t0 = time.perf_counter()
        logits, caches = executor(params, tokens)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read_launches()
        peak_above_arena = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        want_logits, want_caches = model.prefill(params, {"tokens": tokens})
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
                fail(f"prefill: the arena-backed {name} differs from eager by "
                     f"{diffs[name]}")
        finite = bool(torch.isfinite(logits.float()).all())
        del logits, caches, want_logits, want_caches
        t0 = time.perf_counter()
        executor(params, tokens)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        eager_warm_s = time.perf_counter() - t0
        # one prefill with the tracer on but discarded, then the one read:
        # a single traced run once missed a kernel's record on an H100
        # (511 of the 512 ssd_chunk launches)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                executor(params, tokens)
                torch.cuda.synchronize()
                prof.step()
    # the schedule's step annotation (ProfilerStep#) also lies on the
    # device timeline, across the whole step: it is no kernel
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
    device_us = sum(e.self_device_time_total for e in kernels)
    ssd_us = sum(e.self_device_time_total for e in kernels if "ssd_chunk" in e.key)
    ssd_count = sum(e.count for e in kernels if "ssd_chunk" in e.key)
    n_chunks = -(-S // 256)
    if counts["ssd_chunk"] != n_chunks * cfg.n_layers:
        fail(f"prefill: {counts['ssd_chunk']} ssd_chunk launches, expected "
             f"{n_chunks} chunks x {cfg.n_layers} layers")
    if not finite:
        fail("prefill: non-finite logits")
    if ssd_count != n_chunks * cfg.n_layers or ssd_us <= 0:
        fail(f"prefill: the profiler saw {ssd_count} ssd_chunk kernels")
    if executor.arena.buf.data_ptr() != arena_ptr:
        fail("prefill: the arena moved")
    if executor.plan.total_size != meta_plan.total_size:
        fail(f"prefill: the executor planned {executor.plan.total_size} B, the "
             f"meta trace {meta_plan.total_size} B")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    st = executor.stats
    row = {"phase": "prefill", "arch": cfg.name, "layers": cfg.n_layers,
           "tokens": S, "launches": counts, "first_wall_s": first_s,
           "warm_wall_s": warm_s, "tokens_per_s_warm": S / warm_s,
           "eager_warm_wall_s": eager_warm_s,
           "device_ms": device_us / 1e3, "ssd_chunk_device_ms": ssd_us / 1e3,
           "ssd_chunk_us_per_launch": ssd_us / ssd_count,
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
           "equal_to_eager_bitwise": bitwise, "max_abs_diff_vs_eager": diffs,
           "ok": True}
    emit(row)
    del params, model, executor
    torch.cuda.empty_cache()
    return row


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


PHASES = ("device", "build", "kernels", "parity", "serve", "profile",
          "serve_block", "prefill_parity", "prefill", "serve_mamba")


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
    smi, peak_bw = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    phase_build()
    timing = {}
    if "kernels" in phases:
        timing["flash_decode"] = phase_kernels(peak_bw)
        timing["ssd_chunk"] = phase_kernels_ssd(peak_bw)
        emit({"phase": "kernels", "checked": list(KERNELS),
              "failed_cases": FAILED_CASES})
        if FAILED_CASES:
            fail(f"{len(FAILED_CASES)} kernel case(s) over their bars: {FAILED_CASES}")
    launches = {}
    if "parity" in phases:
        phase_parity()
    host_tokens = None
    if "serve" in phases:
        serve, engine = phase_serve()
        launches["flash_decode"] = serve["launches"]
        host_tokens = serve["tokens"]
        if "profile" in phases:
            phase_profile(engine)
        del engine
    if "serve_block" in phases:
        phase_serve_block(host_tokens)
    if "prefill_parity" in phases:
        phase_prefill_parity()
    if "prefill" in phases:
        launches["ssd_chunk"] = phase_prefill()["launches"]["ssd_chunk"]
    if "serve_mamba" in phases:
        phase_serve_mamba()
    if phases != set(PHASES):
        return
    import torch

    print(smi, flush=True)
    emit({"kernels": [{
        "name": name, "route": route, "source": source, "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": timing[name]["max_abs_err"], "ms": timing[name]["ms"],
        "plain_ms": timing[name]["plain_ms"], "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"],
    } for name, (route, source, replaces) in KERNELS.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
