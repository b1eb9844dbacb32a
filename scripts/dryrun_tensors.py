#!/usr/bin/env python3
"""The largest tensors of one rank's traced sharded step, for one or
more checkouts of the port, on the CPU (no card: the fake process group
stands for the production mesh).

    python3 scripts/dryrun_tensors.py [--arch qwen3-0.6b] [--shape train_4k]
        [--top 10] [TREE ...]

Each TREE is the root of a checkout (the directory that holds
``src/repro_torch``; default: this checkout). Each runs in a process of
its own, which imports that tree's ``launch/dryrun``, builds the step
with ``build_step`` at (data=16, model=16), traces it with
``trace_step`` and plans it as ``run_one`` does. Prints one JSON line a
tree: the torch version, the trace's seconds, the planned activation
bytes (``plan_graph(mode="offsets", strategy="auto")`` over
``trace/fx_liveness``) and the ``--top`` largest kinds of tensor the
program makes (views, inputs and outputs aside), largest first, each
``[bytes, op, shape, dtype, count]`` (as ``run_one``'s
``largest_tensors``, which a parent checkout may lack). A tree whose ``build_step`` takes ``remat`` traces
its default (the train step with remat on); ``--no-remat`` asks it off.
Both checkouts of a comparison read the same torch.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r"""
import collections, inspect, json, sys, time
import torch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.trace.fx_liveness import trace_from_graph_module
from repro_torch.core.planner import plan_graph

arch, shape, top, remat = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4] == "1"
kw = {"remat": remat} if "remat" in inspect.signature(dryrun.build_step).parameters else {}
t0 = time.perf_counter()
step, why = dryrun.build_step(arch, shape, make_production_mesh(), **kw)
gm = dryrun.trace_step(step)
trace_s = time.perf_counter() - t0
trace = trace_from_graph_module(gm, name=f"{arch}-{shape}")
op = {tid: str(node.target) for node, tids in trace.produced.items() for tid in tids}
g = trace.graph
kinds = collections.Counter((t.nbytes, op[tid], tuple(t.shape), t.dtype)
                            for tid, t in g.tensors.items()
                            if tid in op and tid not in g.boundary_ids)
made = sorted(kinds.items(), key=lambda kv: (-kv[0][0], kv[0][1], kv[0][2]))[:top]
plan = plan_graph(g, mode="offsets", strategy="auto")
print("ROW " + json.dumps({
    "torch": torch.__version__, "arch": arch, "shape": shape, "remat": kw.get("remat"),
    "trace_s": trace_s, "graph_nodes": len(gm.graph.nodes),
    "planned_act_gb": plan.total_size / 1e9,
    "largest_tensors": [[b, o, list(sh), dt, n] for (b, o, sh, dt), n in made]}),
      flush=True)
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", default=[str(ROOT)])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--no-remat", action="store_true")
    args = ap.parse_args()
    bad = 0
    for tree in args.trees:
        src = Path(tree).resolve() / "src"
        out = subprocess.run(
            [sys.executable, "-c", _CHILD, args.arch, args.shape, str(args.top),
             "0" if args.no_remat else "1"],
            cwd=src.parent, env={**os.environ, "PYTHONPATH": str(src),
                                 "CUDA_VISIBLE_DEVICES": ""},
            capture_output=True, text=True)
        rows = [line[4:] for line in out.stdout.splitlines() if line.startswith("ROW ")]
        if out.returncode or not rows:
            bad += 1
            print(json.dumps({"tree": tree, "error": out.stderr[-2000:]}), flush=True)
            continue
        print(json.dumps({"tree": tree, **json.loads(rows[0])}), flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
