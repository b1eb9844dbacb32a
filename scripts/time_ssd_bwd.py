#!/usr/bin/env python3
"""Time the backward SSD kernel of one or more checkouts of the port on
one card, in turns.

    python3 scripts/time_ssd_bwd.py [TREE ...]   # default: this checkout

Each TREE is the root of a checkout (the directory that holds
``src/repro_torch``). Each run is a process of its own that builds only
that tree's ``csrc/ssd_chunk_bwd.cu`` (into the tree's
``build/torch_ext``), checks its bf16 gradients at mamba2-2.7b's prefill
chunk against the plain backward in float64
(``kernels/ref.ssd_chunk_bwd_tolerance``) and times the kernel as
``chip_smoke.py``'s kernels_ssd_bwd does (its inputs and its
``cuda_time_ms``: medians of 100 launches, the L2 flushed before each)
at the same three shapes: mamba2-2.7b's and zamba2-7b's prefill chunks
and train_mamba2's call (mamba2's chunk at batch 2). The trees run in
the order given and then in reverse (A, B, B, A), to compare two
versions within one call. Prints the card's name and power limit, then
one JSON line per run (with the build's ``-Xptxas -v`` registers and
spills of each tensor-core instantiation). Needs one card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (("mamba2-2.7b", "mamba2", 1), ("zamba2-7b", "zamba2", 1),
          ("mamba2-2.7b", "mamba2_train", 2))


def child(tree: Path) -> dict:
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels.ref import ssd_chunk_bwd_ref, ssd_chunk_bwd_tolerance
    from repro_torch.models.ssm import ssm_dims

    if not torch.cuda.is_available():
        raise SystemExit("time_ssd_bwd: no card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    build.load("ssd_chunk_bwd")
    row = {"tree": str(tree),
           "ptxas": cs.ssd_bwd_ptxas(build.library_path("ssd_chunk_bwd").with_suffix(".log"))}
    for arch, label, batch in SHAPES:
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
    return row


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print(json.dumps(child(Path(sys.argv[2]).resolve())), flush=True)
        return
    trees = [Path(t).resolve() for t in sys.argv[1:]] or [ROOT]
    for tree in trees:
        if not (tree / "src" / "repro_torch").is_dir():
            raise SystemExit(f"time_ssd_bwd: {tree} holds no src/repro_torch")
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    failed = False
    for tree in trees + trees[::-1]:
        out = subprocess.run([sys.executable, __file__, "--child", str(tree)],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            failed = True
            print(json.dumps({"tree": str(tree), "exit": out.returncode,
                              "stderr": out.stderr[-3000:]}), flush=True)
            continue
        print(out.stdout.strip().splitlines()[-1], flush=True)
    if failed:
        raise SystemExit("time_ssd_bwd: a run failed")


if __name__ == "__main__":
    main()
