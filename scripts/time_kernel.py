#!/usr/bin/env python3
"""Time one hand-written kernel of one or more checkouts of the port on
one card, in turns.

    python3 scripts/time_kernel.py ssd_chunk_bwd [TREE ...]
    python3 scripts/time_kernel.py flash_decode_lse [--splits 4,16] [TREE ...]

Each TREE is the root of a checkout (the directory that holds
``src/repro_torch``; default: this checkout) whose wrapper has this
checkout's interface (``num_splits(B, KV, G, D, T, dtype)`` since the
tensor-core ``flash_decode``). Each run is a process of its
own that builds only that tree's source of the kernel (into the tree's
``build/torch_ext``), checks it as ``chip_smoke.py`` does and times it
with ``chip_smoke.cuda_time_ms`` (medians of 100 launches, the L2 flushed
before each). The trees run in the order given and then in reverse (A,
B, B, A), to compare two versions within one call. Prints the card's name
and power limit, then one JSON line per run with the build's
``-Xptxas -v`` registers and spills. Needs one card.

``ssd_chunk_bwd`` (``csrc/ssd_chunk_bwd.cu``): its bf16 gradients at
mamba2-2.7b's prefill chunk against the plain backward in float64
(``kernels/ref.ssd_chunk_bwd_tolerance``), timed at the shapes of the
kernels_ssd_bwd phase: mamba2-2.7b's and zamba2-7b's prefill chunks and
train_mamba2's call (mamba2's chunk at batch 2).

``flash_decode_lse`` (``csrc/flash_decode.cu``) at one rank's span of
nemotron-4-340b's decode_32k on (data=16, model=16), (B, KV, G, D, T) =
(8, 8, 12, 192, 2048) bf16: held against its plain version as
rank_of_256 holds it (``chip_smoke.lse_at_span``), the paged kernel
bit-equal to it on the cache gathered out of a shuffled pool of 64 KiB
pages, two calls bit-equal; timed at full lengths at the tree's own split
(``num_splits``) and at each split of ``--splits`` (the wrapper's
``num_splits`` replaced for those calls), beside its bound
(``launch/roofline.kernel_bound``) and two yardsticks: the kernel after a
flush that reads 256 MiB instead of writing it (``ms_clean_l2``: the
written flush leaves the L2 full of dirty lines, which a 100 MB read
writes back, ~50 MB more traffic), and one PyTorch read of the same K and
V (``read_ms``: ``torch.sum`` of each).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SSD_BWD_SHAPES = (("mamba2-2.7b", "mamba2", 1), ("zamba2-7b", "zamba2", 1),
                  ("mamba2-2.7b", "mamba2_train", 2))
LSE_SHAPE = (8, 8, 12, 192, 2048)


def ssd_chunk_bwd_row(splits: list[int]) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels.ref import ssd_chunk_bwd_ref, ssd_chunk_bwd_tolerance
    from repro_torch.models.ssm import ssm_dims

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    build.load("ssd_chunk_bwd")
    row = {"ptxas": cs.ssd_bwd_ptxas(
        build.library_path("ssd_chunk_bwd").with_suffix(".log"))}
    for arch, label, batch in SSD_BWD_SHAPES:
        cfg = get_config(arch)
        _, H, _ = ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim, cfg.ssm_groups,
                           cfg.ssm_state)
        inputs = cs.ssd_inputs(gen, batch, 256, H, cfg.ssm_head_dim, cfg.ssm_state,
                               "original", cfg.ssm_groups, "bfloat16", "bfloat16")
        dy = (torch.randn(inputs[0].shape, generator=gen, device="cuda") * 0.5).bfloat16()
        dns = (torch.randn(inputs[5].shape, generator=gen, device="cuda") * 0.5).bfloat16()
        got = sc.ssd_chunk_bwd(*inputs, dy, dns)
        want = ssd_chunk_bwd_ref(*(t.double() for t in (*inputs, dy, dns)))
        ratio = max(ssd_chunk_bwd_tolerance(n, g, w, 256) for n, g, w in zip(
            ("dx", "ddt", "ddA", "dB", "dC", "dstate"), got, want))
        row[label] = {"shape": [batch, 256, H, cfg.ssm_head_dim, cfg.ssm_state],
                      "ms": cs.cuda_time_ms(lambda: sc.ssd_chunk_bwd(*inputs, dy, dns)),
                      "err_over_bar": ratio}
    row["ok"] = all(row[label]["err_over_bar"] <= 1 for _, label, _ in SSD_BWD_SHAPES)
    return row


def clean_time_ms(fn, runs: int = 100, warmup: int = 10) -> float:
    """``chip_smoke.cuda_time_ms`` with a flush that reads 256 MiB, so the
    L2 holds clean lines of the flush buffer when ``fn`` starts."""
    import statistics

    import torch

    flush = torch.zeros(256 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(runs):
        torch.cuda._sleep(1_000_000)
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def flash_decode_lse_row(splits: list[int]) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.ref import paged_index
    from repro_torch.launch.roofline import kernel_bound

    B, KV, G, D, T = LSE_SHAPE
    build.load("flash_decode")
    ptxas = cs.flash_decode_ptxas(build.library_path("flash_decode").with_suffix(".log"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, check = cs.lse_at_span(gen, LSE_SHAPE)

    rows = (1, 64, 65, 256, 257, 1500, 2047, T)
    lengths = torch.tensor(rows, dtype=torch.int32, device="cuda")
    args = cs.paged_pool(gen, B, KV, D, T, torch.bfloat16, cs.PAGE_SIZE, rows, True)
    buf, table, k_off, v_off, st, sh, _, pe = args
    kg, vg = (buf[paged_index(table, off, (st, sh, 1), (T, KV, D), pe)]
              for off in (k_off, v_off))
    paged_equal = bool(torch.equal(fd.flash_decode_paged(q, *args, lengths),
                                   fd.flash_decode(q, kg, vg, lengths)))
    twice_equal = bool(torch.equal(fd.flash_decode(q, kg, vg, lengths),
                                   fd.flash_decode(q, kg, vg, lengths)))
    del args, buf, kg, vg

    full = torch.full((B,), T, dtype=torch.int32, device="cuda")
    own = fd.num_splits(B, KV, G, D, T, q.dtype)
    ms = {}
    num_splits = fd.num_splits
    try:
        for n in [own] + [n for n in splits if n != own]:
            fd.num_splits = lambda *_, n=n: n
            ms[n] = cs.cuda_time_ms(lambda: fd.flash_decode_lse(q, k, v, full))
    finally:
        fd.num_splits = num_splits
    bound = kernel_bound("flash_decode", {"B": B, "KV": KV, "G": G, "D": D, "T": T,
                                          "dtype": "bfloat16"},
                         card_name=torch.cuda.get_device_name(0))
    return {"shape": list(LSE_SHAPE), "path": fd.kernel_path(q.dtype, D, G),
            "ptxas": {key: val for key, val in ptxas.items() if "/192/12" in key},
            **check, "paged_bit_equal": paged_equal, "bit_equal_twice": twice_equal,
            "ok": check["ok"] and paged_equal and twice_equal,
            "n_split": own, "ms": ms[own], "ms_by_split": ms,
            "ms_clean_l2": clean_time_ms(lambda: fd.flash_decode_lse(q, k, v, full)),
            "read_ms": cs.cuda_time_ms(lambda: (k.sum(), v.sum())),
            "bound_ms": bound.bound_s * 1e3, "bound_by": bound.bound_by}


KERNELS = {"ssd_chunk_bwd": ssd_chunk_bwd_row, "flash_decode_lse": flash_decode_lse_row}


def child(kernel: str, tree: Path, splits: list[int]) -> dict:
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_kernel: no card")
    return {"tree": str(tree), "kernel": kernel, **KERNELS[kernel](splits),
            "card": torch.cuda.get_device_name(0)}


def main() -> None:
    if len(sys.argv) == 5 and sys.argv[1] == "--child":
        splits = [int(n) for n in sys.argv[4].split(",") if n]
        print(json.dumps(child(sys.argv[2], Path(sys.argv[3]).resolve(), splits)),
              flush=True)
        return
    ap = argparse.ArgumentParser()
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--splits", default="",
                    help="flash_decode_lse: more splits to time, e.g. 4,16")
    ap.add_argument("trees", nargs="*")
    args = ap.parse_args()
    trees = [Path(t).resolve() for t in args.trees] or [ROOT]
    for tree in trees:
        if not (tree / "src" / "repro_torch").is_dir():
            raise SystemExit(f"time_kernel: {tree} holds no src/repro_torch")
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    failed = False
    for tree in trees + trees[::-1]:
        out = subprocess.run([sys.executable, __file__, "--child", args.kernel, str(tree),
                              args.splits], capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            failed = True
            print(json.dumps({"tree": str(tree), "exit": out.returncode,
                              "stderr": out.stderr[-3000:]}), flush=True)
            continue
        row = json.loads(out.stdout.strip().splitlines()[-1])
        failed |= not row["ok"]
        print(json.dumps(row), flush=True)
    if failed:
        raise SystemExit("time_kernel: a run failed")


if __name__ == "__main__":
    main()
