"""Readings for a cell's correctness limit, many seeds in one process.

    python3 perfbench/calibrate.py --workload zamba2-7b.decode \\
        --seeds 11,12,13 --seconds 30

For each seed: a whole run of the cell (``harness.run_cell``: weights
drawn anew from the seed into the same tensors, a new engine, the
window, the reference), then the control: the same reference in float8
e4m3 (W8A8, ``reference.py``), its greedy tokens put in the served
tokens' place at the same positions of the same prompts and judged by
the same comparison against the cell's limits. One JSON line a seed:
the program's numbers and ``correct``, the control's numbers and
``correct``, and the run's end-to-end numbers. Not run by the benchmark
itself.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness, spec, weights

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        harness.log("calibrate: no CUDA card")
        return 3
    params = weights.allocate(cell.config["repro_arch"], "cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        out = harness.run_cell(cell, seed, args.seconds, False, device="cuda",
                               params=params, control=not args.no_control,
                               t_start=t)
        res, extra = out["result"], out["extra"]
        g = extra["gaps"] or {}
        c = g.get("control") or {}
        print(json.dumps({
            "workload": args.workload, "seed": seed, "correct": res["correct"],
            "control_correct": (out["control"] or {}).get("correct"),
            "widest_gap": g.get("widest_gap"), "mean_gap": g.get("mean_gap"),
            "control_widest_gap": c.get("widest_gap"),
            "control_mean_gap": c.get("mean_gap"),
            "tokens_compared": g.get("tokens"), "argmax_agree": g.get("argmax_agree"),
            "control_argmax_agree": c.get("argmax_agree"),
            "per_request": g.get("per_request"),
            "control_per_request": c.get("per_request"),
            "sampled": extra["sampled"], "finished": extra["finished"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "reference_s": extra["reference_s"], "run_s": time.monotonic() - t,
            "memory_peak_bytes": res["device"]["memory_peak_bytes"],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
