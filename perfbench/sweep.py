"""One open-loop sweep of a cell's arrival rate, to find its knee.

    python3 perfbench/sweep.py --workload granite-moe-3b.chat \\
        --rates 0.6,0.8,1.0 --seconds 30 --seeds 5,6

One engine (weights from the first seed) serves a window at each rate
in turn for each traffic seed (the cell's mix with ``rate_per_s``
replaced), and is drained between windows. One JSON line a seed and
rate: tokens/s, the mean and 95th percentile of the time to first
token (a request with none by the window's end counts the end), how
many requests were due, how many had their first token, and the backlog
at the end (due and still waiting for a slot). The knee is the highest
rate whose backlog stays bounded on every seed; the mix's
``rate_per_s`` is then set by hand from it. Not run by the benchmark
itself.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    ap.add_argument("--rates", required=True, help="comma-separated, requests/s")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="1", help="comma-separated")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from perfbench import harness, spec, traffic, weights

    cell = spec.cell(args.workload)
    if cell.traffic["loop"] != "open" or not torch.cuda.is_available():
        harness.log("sweep: needs an open-loop cell and a CUDA card")
        return 3
    a = cell.config["repro_arch"]
    seeds = [int(s) for s in args.seeds.split(",")]
    params = weights.make(a, traffic.seed64(seeds[0], 0), "cuda")
    server = harness.Server(harness.build_engine(cell, params, "cuda"))
    harness.warm_up(server, seeds[0], int(a["vocab"]))
    runs = [(seed, float(r)) for seed in seeds for r in args.rates.split(",")]
    for seed, rate in runs:
        c = dataclasses.replace(cell, traffic=dict(cell.traffic, rate_per_s=rate))
        server.recs.clear()
        win = harness.serve_window(server, c, seed, args.seconds, False, None)
        e2e = harness.end_to_end(win, True)
        firsts = [r.times[0] - r.due for r in win.recs.values()
                  if r.times and r.times[0] <= win.end]
        waiting = sum(1 for r in win.recs.values() if r.admit_call is None)
        print(json.dumps({
            "seed": seed, "rate_per_s": rate, "tokens_per_s": e2e["tokens_per_s"],
            "ttft_mean_ms": e2e["ttft_mean_ms"],
            "ttft_p95_ms": float(np.percentile(e2e["ttfts"], 95)) * 1e3,
            "due": len(win.offers), "first_token_by_end": len(firsts),
            "sent": len(win.recs), "waiting_for_slot_at_end": waiting,
            "not_sent_at_end": len(win.offers) - len(win.recs),
            "itl_p95_ms": e2e["itl_p95_ms"]}), flush=True)
        t = time.monotonic()
        while server.inflight:
            server.step()
        harness.log(f"drained in {time.monotonic() - t:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
