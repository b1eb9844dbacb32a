"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 perfbench/run.py --workload granite-moe-3b.chat --seed 7 \\
        --seconds 51 --trace 0

Run from the root of a checkout. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines of standard
error). Without a CUDA card, or with fewer cards than the cell asks
for, it exits with 3 and prints no result; if the process holds JAX or
the JAX package once the window has closed, it exits with 4.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_IMPORT = time.monotonic()
ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# transformers, where installed, would load JAX by itself
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness, spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s), "
                    f"found {n}")
        return 3
    age = harness.process_age_s()
    t_start = time.monotonic() - age if age is not None else T_IMPORT
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=t_start)
    bad = forbidden_modules()
    if bad:
        harness.log(f"perfbench: the process holds {bad} after the window")
        return 4
    res, extra = out["result"], out["extra"]
    harness.log("perfbench: " + json.dumps(extra, default=str))
    print(json.dumps(res), flush=True)
    for name, c in res["checks"].items():
        harness.log(f"check {name}: {c['value']} ({c['rule']}, limit {c['limit']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
