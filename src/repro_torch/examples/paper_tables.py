"""Reproduce the paper's Table 1 (Shared Objects) and Table 2 (Offsets)
and print them side by side with the published numbers.

Twin of the reference's ``examples/paper_tables.py`` and of the
``benchmarks/tables.py`` it imports: the same strategies, rows, CSV
header and claims, on the port's copies of the planners and the six
evaluation networks. For each network, run all our strategies + prior
work + bounds, print MB beside the paper's reported numbers, and
validate the paper's qualitative claims; exit 1 if one fails.

Table 2 additionally carries a ``searched_order (ours, 12 MiB TPU
budget)`` row per network — the planned footprint after the
memory-aware order/fusion search (core/order_search,
core/fusion_search), a column the paper leaves as §7.1 future work;
validate_paper_claims checks it never loses to the fixed-order plan and
strictly shrinks >= 3 of the 6 networks. That row's fusion search is
given the reference's default scratch budget
(``REFERENCE_FUSION_BUDGET``, its TPU VMEM model), so the row and the
claims are the reference's, and the claim line names that budget. At the
port's own default budget, one H100 CTA's shared memory less its reserve
(``kernels/smem_plan.fusion_scratch_budget``, 117,760 B), no tensor of
these networks fits, nothing fuses, and the search shrinks none of the
six: the claim would fail there (tests/test_torch_examples.py holds that
result). The ``us_per_call`` column is the planner's host time, which
varies from run to run.

    PYTHONPATH=src python -m repro_torch.examples.paper_tables
"""

from __future__ import annotations

import time

from repro_torch.core import baselines, offsets, shared_objects
from repro_torch.core.fusion_search import fusion_search
from repro_torch.core.order_search import search_order
from repro_torch.core.plan_io import PlanCache
from repro_torch.core.records import (
    naive_consumption,
    offsets_lower_bound,
    shared_objects_lower_bound,
)
from repro_torch.models.convnets import (
    PAPER_NETWORKS,
    PAPER_TABLE1,
    PAPER_TABLE2,
)

MB = 2**20
# the reference's default fusion budget: its TPU VMEM model (16 MiB of a
# v5e core's VMEM less a 4 MiB pipeline reserve), a planning constant of
# the reference, not a property of the card
REFERENCE_FUSION_BUDGET = 12 * 2**20
HEADER = "table,network,strategy,ours_mb,paper_mb,us_per_call"


def _records():
    return {name: fn().usage_records() for name, fn in PAPER_NETWORKS.items()}


def table1_shared_objects(emit=print) -> dict:
    recs = _records()
    strategies = {
        "greedy_by_size": shared_objects.greedy_by_size,
        "greedy_by_size_improved": shared_objects.greedy_by_size_improved,
        "greedy_by_breadth": shared_objects.greedy_by_breadth,
        "tflite_greedy (Lee'19)": baselines.tflite_greedy_in_order,
        "min_cost_flow (Lee'19)": baselines.min_cost_flow_assignment,
    }
    out: dict = {}
    emit(HEADER)
    for net, rs in recs.items():
        for sname, fn in strategies.items():
            t0 = time.perf_counter()
            total = fn(rs).total_size / MB
            dt = (time.perf_counter() - t0) * 1e6
            key = sname.split(" ")[0]
            paper = PAPER_TABLE1.get(key, {}).get(net, "")
            emit(f"table1,{net},{sname},{total:.3f},{paper},{dt:.0f}")
            out.setdefault(net, {})[sname] = total
        lb = shared_objects_lower_bound(rs) / MB
        nv = naive_consumption(rs) / MB
        emit(f"table1,{net},lower_bound,{lb:.3f},{PAPER_TABLE1['lower_bound'][net]},0")
        emit(f"table1,{net},naive,{nv:.3f},{PAPER_TABLE1['naive'][net]},0")
        out[net]["lower_bound"] = lb
        out[net]["naive"] = nv
    return out


def table2_offsets(emit=print) -> dict:
    recs = _records()
    strategies = {
        "greedy_by_size": offsets.greedy_by_size_offsets,
        "greedy_by_breadth": offsets.greedy_by_breadth_offsets,
        "tflite_greedy (Lee'19)": baselines.tflite_greedy_in_order_offsets,
        "strip_packing (Sekiyama'18)": baselines.strip_packing_bestfit,
    }
    out: dict = {}
    search_cache = PlanCache()
    emit(HEADER)
    for net, rs in recs.items():
        for sname, fn in strategies.items():
            t0 = time.perf_counter()
            total = fn(rs).total_size / MB
            dt = (time.perf_counter() - t0) * 1e6
            key = sname.split(" ")[0]
            paper = PAPER_TABLE2.get(key, {}).get(net, "")
            emit(f"table2,{net},{sname},{total:.3f},{paper},{dt:.0f}")
            out.setdefault(net, {})[sname] = total
        # beyond the paper (§7.1): memory-aware order + fusion search over
        # the graph, every candidate planned through the plan cache; the
        # paper has no such column, so paper_mb is blank
        g = PAPER_NETWORKS[net]()
        t0 = time.perf_counter()
        order_res = search_order(g, iters=300, seed=0, cache=search_cache)
        fusion_res = fusion_search(g, cache=search_cache,
                                   local_budget=REFERENCE_FUSION_BUDGET)
        searched = min(
            order_res.plan.total_size, fusion_res.plan.total_size
        ) / MB
        dt = (time.perf_counter() - t0) * 1e6
        emit(f"table2,{net},searched_order (ours, 12 MiB TPU budget),"
             f"{searched:.3f},,{dt:.0f}")
        out[net]["searched_order"] = searched
        # the search's own fixed-order baseline (auto portfolio) — the
        # honest comparator for "did the SEARCH shrink the plan"
        out[net]["fixed_order_auto"] = order_res.baseline_plan.total_size / MB
        lb = offsets_lower_bound(rs) / MB
        nv = naive_consumption(rs) / MB
        emit(f"table2,{net},lower_bound,{lb:.3f},{PAPER_TABLE2['lower_bound'][net]},0")
        emit(f"table2,{net},naive,{nv:.3f},{PAPER_TABLE2['naive'][net]},0")
        out[net]["lower_bound"] = lb
        out[net]["naive"] = nv
    return out


def validate_paper_claims(t1: dict, t2: dict, emit=print) -> list[str]:
    """The paper's qualitative claims, checked against OUR graphs."""
    failures = []

    def check(cond, msg):
        emit(("PASS " if cond else "FAIL ") + msg)
        if not cond:
            failures.append(msg)

    # §6: Offsets Greedy-by-Size achieves the lower bound on all nets
    # except DeepLab v3 (within 8% there).
    for net in t2:
        gbs, lb = t2[net]["greedy_by_size"], t2[net]["lower_bound"]
        if net == "deeplab_v3":
            check(gbs <= 1.10 * lb, f"t2 {net}: GBS within 10% of LB ({gbs:.3f} vs {lb:.3f})")
        else:
            check(abs(gbs - lb) < 1e-6, f"t2 {net}: GBS == LB ({gbs:.3f} vs {lb:.3f})")
    # abstract: up to ~10.5x smaller than naive (we check >5x somewhere)
    best_red = max(t2[n]["naive"] / t2[n]["greedy_by_size"] for n in t2)
    check(best_red > 5.0, f"t2 best reduction vs naive = {best_red:.1f}x (paper: up to 10.5x)")
    # §4.4: GBS-Improved never worse than GBS for shared objects
    for net in t1:
        check(
            t1[net]["greedy_by_size_improved"] <= t1[net]["greedy_by_size"] + 1e-9,
            f"t1 {net}: GBS-I <= GBS",
        )
    # our strategies never lose to the naive baseline
    for net in t1:
        check(t1[net]["greedy_by_size_improved"] <= t1[net]["naive"], f"t1 {net} <= naive")
    # beyond paper: the planner-driven order/fusion search never loses to
    # the fixed-order plan, and strictly shrinks the arena on most nets.
    # Strictness is judged against the search's OWN fixed-order auto
    # baseline, not GBS — strategy choice alone must not count as a win.
    strict = 0
    for net in t2:
        srch, base = t2[net]["searched_order"], t2[net]["fixed_order_auto"]
        check(srch <= base + 1e-9, f"t2 {net}: searched <= fixed-order plan")
        strict += srch < base - 1e-9
    check(strict >= 3, f"searched order/fusion strictly improves {strict}/6 nets "
                       f"(need >= 3) at the reference's 12 MiB TPU fusion budget")
    return failures


def main(emit=print) -> dict:
    """Both tables and the claims; returns them with the failed claims."""
    t1 = table1_shared_objects(emit)
    t2 = table2_offsets(emit)
    return {"table1": t1, "table2": t2, "failures": validate_paper_claims(t1, t2, emit)}


if __name__ == "__main__":
    raise SystemExit(1 if main()["failures"] else 0)
