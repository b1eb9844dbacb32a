"""Core memory-planning library of the port (the paper's contribution),
a copy of the reference's ``repro.core``.

Public API:
    unified      — the planning facade: ``plan(PlanSpec) -> UnifiedPlan``
                   covering the activation half (MemoryPlan) and the
                   cross-step slot/KV state half (StatePlan, paged or
                   symmetric) under one fingerprint and one total;
                   PlanSession is the one plan source an engine serves
                   from (a bundle manifest, one bundle, or a spec)
    artifact     — PlanBundle + BundleManifest: compiled plans as
                   fingerprinted, content-addressed serving artifacts
    records      — usage records, profiles, breadths, lower bounds
    interval_set — shared overlap engine: DisjointIntervalSet,
                   IntervalTree, BestFitArena
    shared_objects — Greedy-by-Size / -Improved / Greedy-by-Breadth (paper §4)
    offsets      — Greedy-by-Size / Greedy-by-Breadth offsets (paper §5)
    baselines    — naive, TFLite Greedy, min-cost flow, strip packing
    extensions   — Greedy-by-Conflict, best-of-all offsets
    planner      — MemoryPlan facade (auto strategy selection per paper §6)
    plan_io      — versioned plan JSON + content-addressed plan cache (disk
                   tier under ``REPRO_TORCH_PLAN_CACHE_DIR``)
    reference    — FROZEN seed implementations (the differential oracle)
    validate     — the O(n²) plan validators
    optimal      — exact branch-and-bound (beyond paper)
    dynamic      — online offsets for dynamic shapes
    order_search — topological-order search over REAL cached plans (§7.1)
    fusion_search — MAFAT-style fusion search over graph partitions, its
                   budget from the Hopper shared-memory model
                   (``kernels/smem_plan``)

The contracts (oracle against fast strategy, plan-cache keying) are the
reference's: see ``repro.core``.
"""

from repro_torch.core.fusion_search import (
    FusionSearchResult,
    fuse_groups,
    fusion_search,
)
from repro_torch.core.graph import Graph, GraphBuilder, Op, TensorSpec
from repro_torch.core.interval_set import BestFitArena, DisjointIntervalSet, IntervalTree
from repro_torch.core.order_search import (
    IncrementalRecords,
    OrderSearchResult,
    memory_aware_topo_order,
    search_order,
    simulated_annealing_order,
)
from repro_torch.core.plan_io import (
    PLAN_FORMAT_VERSION,
    PLANNER_REVISION,
    PlanCache,
    load_plan,
    plan_from_json,
    plan_signature,
    plan_to_json,
    save_plan,
)
from repro_torch.core.planner import (
    MemoryPlan,
    OFFSET_STRATEGIES,
    SHARED_OBJECT_STRATEGIES,
    plan_graph,
    plan_records,
)
from repro_torch.core.records import (
    TensorUsageRecord,
    align,
    make_records,
    naive_consumption,
    offsets_lower_bound,
    operator_breadths,
    operator_profiles,
    positional_maximums,
    shared_objects_lower_bound,
)
from repro_torch.core.unified import (
    PagedStatePlan,
    PlanSession,
    PlanSpec,
    Resolution,
    StatePlan,
    StateRecord,
    UnifiedPlan,
    detect_state_axes,
    plan,
    plan_paged_state,
    plan_state,
    state_records_from_cache,
)

__all__ = [
    "PagedStatePlan",
    "PlanSession",
    "PlanSpec",
    "Resolution",
    "StatePlan",
    "StateRecord",
    "UnifiedPlan",
    "detect_state_axes",
    "plan",
    "plan_paged_state",
    "plan_state",
    "state_records_from_cache",
    "FusionSearchResult",
    "fuse_groups",
    "fusion_search",
    "Graph",
    "GraphBuilder",
    "Op",
    "TensorSpec",
    "IncrementalRecords",
    "OrderSearchResult",
    "memory_aware_topo_order",
    "search_order",
    "simulated_annealing_order",
    "BestFitArena",
    "DisjointIntervalSet",
    "IntervalTree",
    "PLAN_FORMAT_VERSION",
    "PLANNER_REVISION",
    "PlanCache",
    "load_plan",
    "plan_from_json",
    "plan_signature",
    "plan_to_json",
    "save_plan",
    "MemoryPlan",
    "OFFSET_STRATEGIES",
    "SHARED_OBJECT_STRATEGIES",
    "plan_graph",
    "plan_records",
    "TensorUsageRecord",
    "align",
    "make_records",
    "naive_consumption",
    "offsets_lower_bound",
    "operator_breadths",
    "operator_profiles",
    "positional_maximums",
    "shared_objects_lower_bound",
]
