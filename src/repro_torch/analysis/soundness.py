"""Plan soundness certifier — the fast, independent twin of ``core/validate``.

Re-derives the paper's safety constraint from first principles: two
tensors may share bytes only if their usage intervals are disjoint
(arXiv 2001.03288 §3–§4). Where ``core/validate`` proves it by an O(n²)
pairwise sweep, this module proves it with an O(n log n) time/address
sweep-line, so it scales to the full-graph sizes ROADMAP item 4 targets
(a 50k-record plan certifies in well under 5 s).

Independence is the point: this file shares **zero code** with
``core/interval_set.py`` or the planners. Liveness, breadths, positional
maximums and the disjointness proof are all re-derived locally — a bug in
a planner (or in the shared interval machinery every planner sits on)
cannot hide behind a matching bug here. ``tests/test_analysis_soundness``
differential-matches every verdict against the oracle across the
220-graph corpus, and ``tests/test_analysis_mutation`` proves seeded
corruptions are caught.

Sweep-line argument (offsets): walk operator time; keep the address
intervals of live tensors in a sorted structure that is pairwise
disjoint. A tensor leaving at ``last_op`` is removed at ``last_op + 1``
*before* arrivals at that step (closed usage intervals). When a tensor
arrives, only its would-be neighbors in address order can overlap it —
for a pairwise-disjoint set sorted by start, starts and ends sort
together, so any member starting at or below the newcomer ends at or
below the predecessor, and any member starting above begins at or above
the successor. One predecessor check + one successor check per arrival.

Every certifier returns a list of :class:`~repro_torch.analysis.findings.Finding`
(empty = certified) instead of raising, so callers can aggregate across
buckets and report all defects at once.
"""

from __future__ import annotations

import math
from bisect import bisect_left, bisect_right
from typing import TYPE_CHECKING, Sequence

from repro_torch.analysis.findings import Finding
from repro_torch.core.unified import dtype_itemsize

if TYPE_CHECKING:  # structural types only; no planner code is executed
    from repro_torch.core.planner import MemoryPlan
    from repro_torch.core.records import TensorUsageRecord
    from repro_torch.core.shared_objects import SharedObjectsAssignment
    from repro_torch.core.unified import StatePlan, UnifiedPlan

PASS = "soundness"


def _leaf_nbytes(leaf) -> int:
    """Byte size of one state-plan leaf. JSON round-tripped plans carry
    dtype NAMES; the port's ``dtype_itemsize`` knows ``bfloat16``, which
    plain numpy does not."""
    return math.prod(leaf.shape) * dtype_itemsize(leaf.dtype)


def _finding(code: str, message: str, where: str = "") -> Finding:
    return Finding(pass_name=PASS, code=code, message=message, where=where)


# --------------------------------------------------------------- sweep set


class _SweepSet:
    """Sorted set of disjoint address intervals, chunked for O(√-ish)
    inserts without external deps.

    Items are ``(offset, end, tensor_id)`` tuples in natural tuple order.
    A flat ``bisect.insort`` list degrades to O(n) memmove per insert when
    tens of thousands of tensors are simultaneously live; splitting into
    bounded chunks (≤ ``2 * CHUNK``) keeps every insert's shift local
    while lookups stay one bisect over chunk heads + one inside a chunk.
    """

    CHUNK = 512

    def __init__(self) -> None:
        self._chunks: list[list[tuple[int, int, int]]] = []
        self._heads: list[tuple[int, int, int]] = []  # _chunks[i][0], cached

    def __len__(self) -> int:
        return sum(len(c) for c in self._chunks)

    def _chunk_index(self, item: tuple[int, int, int]) -> int:
        ci = bisect_right(self._heads, item) - 1
        return 0 if ci < 0 else ci

    def add(self, item: tuple[int, int, int]) -> tuple[
        tuple[int, int, int] | None, tuple[int, int, int] | None
    ]:
        """Insert ``item``; return its (predecessor, successor) so the
        caller can run the two disjointness checks."""
        if not self._chunks:
            self._chunks.append([item])
            self._heads.append(item)
            return None, None
        ci = self._chunk_index(item)
        chunk = self._chunks[ci]
        pos = bisect_left(chunk, item)
        if pos > 0:
            pred = chunk[pos - 1]
        elif ci > 0:
            pred = self._chunks[ci - 1][-1]
        else:
            pred = None
        if pos < len(chunk):
            succ = chunk[pos]
        elif ci + 1 < len(self._chunks):
            succ = self._chunks[ci + 1][0]
        else:
            succ = None
        chunk.insert(pos, item)
        if pos == 0:
            self._heads[ci] = item
        if len(chunk) > 2 * self.CHUNK:
            mid = len(chunk) // 2
            self._chunks[ci : ci + 1] = [chunk[:mid], chunk[mid:]]
            self._heads[ci : ci + 1] = [chunk[0], chunk[mid]]
        return pred, succ

    def remove(self, item: tuple[int, int, int]) -> None:
        if not self._chunks:
            raise KeyError(f"interval not present: {item}")
        ci = self._chunk_index(item)
        chunk = self._chunks[ci]
        pos = bisect_left(chunk, item)
        if pos >= len(chunk) or chunk[pos] != item:
            raise KeyError(f"interval not present: {item}")
        chunk.pop(pos)
        if not chunk:
            del self._chunks[ci]
            del self._heads[ci]
        elif pos == 0:
            self._heads[ci] = chunk[0]


# ------------------------------------------------------- offsets certifier


def certify_offsets(
    records: Sequence["TensorUsageRecord"],
    offsets: dict[int, int],
    total_size: int,
    *,
    label: str = "offsets",
) -> list[Finding]:
    """Certify a flat-arena offset plan: coverage, bounds, and — via the
    sweep-line — that no two simultaneously-live tensors overlap in the
    arena. Mirrors every constraint ``core/validate.check_offsets``
    asserts, with independently re-derived liveness and lower bound."""
    findings: list[Finding] = []
    ids = {r.tensor_id for r in records}
    if set(offsets) != ids:
        findings.append(
            _finding(
                "coverage",
                f"offsets cover {len(offsets)} of {len(ids)} tensors "
                f"(missing {sorted(ids - set(offsets))[:5]}, "
                f"extra {sorted(set(offsets) - ids)[:5]})",
                label,
            )
        )
        return findings  # per-tensor checks below need full coverage

    # events: (time, kind) — removals (kind 0) at last_op + 1 run before
    # additions (kind 1) at the same step: closed usage intervals
    events: list[tuple[int, int, "TensorUsageRecord"]] = []
    naive = 0
    for r in records:
        off = offsets[r.tensor_id]
        if off < 0:
            findings.append(
                _finding(
                    "negative-offset",
                    f"tensor {r.tensor_id} at offset {off} < 0",
                    label,
                )
            )
        if off + r.size > total_size:
            findings.append(
                _finding(
                    "arena-spill",
                    f"tensor {r.tensor_id} spans [{off}, {off + r.size}) past "
                    f"arena end {total_size}",
                    label,
                )
            )
        naive += r.size
        events.append((r.first_op, 1, r))
        events.append((r.last_op + 1, 0, r))
    events.sort(key=lambda e: (e[0], e[1], e[2].tensor_id))

    active = _SweepSet()
    breadth = 0
    lower_bound = 0
    reported: set[tuple[int, int]] = set()
    for _t, kind, rec in events:
        interval = (offsets[rec.tensor_id], offsets[rec.tensor_id] + rec.size,
                    rec.tensor_id)
        if kind == 0:
            active.remove(interval)
            breadth -= rec.size
            continue
        pred, succ = active.add(interval)
        breadth += rec.size
        lower_bound = max(lower_bound, breadth)
        for other in (pred, succ):
            if other is None:
                continue
            o_off, o_end, o_id = other
            if o_off < interval[1] and interval[0] < o_end:
                pair = (min(o_id, rec.tensor_id), max(o_id, rec.tensor_id))
                if pair not in reported:
                    reported.add(pair)
                    findings.append(
                        _finding(
                            "arena-collision",
                            f"simultaneously-live tensors "
                            f"{rec.tensor_id}@[{interval[0]}, {interval[1]}) "
                            f"and {o_id}@[{o_off}, {o_end}) share bytes",
                            label,
                        )
                    )

    if not lower_bound <= total_size <= naive:
        findings.append(
            _finding(
                "bounds",
                f"total {total_size} outside [{lower_bound}, {naive}] "
                f"(max operator breadth, naive sum)",
                label,
            )
        )
    return findings


# ------------------------------------------------ shared-objects certifier


def _positional_maximums_sum(records: Sequence["TensorUsageRecord"]) -> int:
    """Paper §4.1's lower bound, re-derived locally: at every operator,
    rank the live sizes in non-increasing order; the bound is the sum over
    ranks of the maximum size seen at that rank."""
    n_ops = 0 if not records else 1 + max(r.last_op for r in records)
    profiles: list[list[int]] = [[] for _ in range(n_ops)]
    for r in records:
        for op in range(r.first_op, r.last_op + 1):
            profiles[op].append(r.size)
    maxima: list[int] = []
    for sizes in profiles:
        sizes.sort(reverse=True)
        for rank, size in enumerate(sizes):
            if rank == len(maxima):
                maxima.append(size)
            elif size > maxima[rank]:
                maxima[rank] = size
    return sum(maxima)


def certify_shared_objects(
    records: Sequence["TensorUsageRecord"],
    asn: "SharedObjectsAssignment",
    *,
    label: str = "shared-objects",
) -> list[Finding]:
    """Certify a shared-objects plan: coverage, per-object interval
    disjointness (sorted scan instead of the oracle's pairwise loop),
    exact object sizing, and the §4.1 bound."""
    findings: list[Finding] = []
    by_id = {r.tensor_id: r for r in records}
    if set(asn.assignment) != set(by_id):
        findings.append(
            _finding(
                "coverage",
                f"assignment covers {len(asn.assignment)} of "
                f"{len(by_id)} tensors",
                label,
            )
        )
        return findings

    # intra-object disjointness: sort each object's intervals by first_op;
    # a collision is exactly "next starts before the running max last ends"
    members: dict[int, list[tuple[int, int, int]]] = {}
    max_assigned: dict[int, int] = {}
    for tid, oid in asn.assignment.items():
        r = by_id[tid]
        members.setdefault(oid, []).append((r.first_op, r.last_op, tid))
        if r.size > max_assigned.get(oid, 0):
            max_assigned[oid] = r.size
    for oid, intervals in members.items():
        intervals.sort()
        running_last = -1
        running_tid = -1
        for first, last, tid in intervals:
            if first <= running_last:
                findings.append(
                    _finding(
                        "object-collision",
                        f"tensors {running_tid} and {tid} overlap in time "
                        f"but share object {oid}",
                        label,
                    )
                )
            if last > running_last:
                running_last, running_tid = last, tid

    for obj in asn.objects:
        want = max_assigned.get(obj.object_id, obj.size)
        if obj.size != want:
            findings.append(
                _finding(
                    "object-size-mismatch",
                    f"object {obj.object_id} sized {obj.size} but its "
                    f"largest assigned tensor is {want}",
                    label,
                )
            )

    lb = _positional_maximums_sum(records)
    naive = sum(r.size for r in records)
    if not lb <= asn.total_size <= naive:
        findings.append(
            _finding(
                "bounds",
                f"total {asn.total_size} outside [{lb}, {naive}] "
                f"(positional maximums, naive sum)",
                label,
            )
        )
    return findings


# ----------------------------------------------------- state-plan certifier


def certify_state_plan(
    sp: "StatePlan", *, label: str = "state"
) -> list[Finding]:
    """Certify the cross-step state layout: per-leaf alignment/sizing,
    in-slot disjointness (sorted scan), slot-stride containment, and the
    symmetric total. Leaf sizes are re-derived from shape × dtype, so a
    corrupted ``slot_nbytes`` cannot self-certify."""
    findings: list[Finding] = []
    if sp.alignment <= 0:
        findings.append(
            _finding("state-alignment", f"alignment {sp.alignment} <= 0", label)
        )
        return findings
    if sp.total_size != sp.n_slots * sp.slot_stride:
        findings.append(
            _finding(
                "state-total-mismatch",
                f"total {sp.total_size} != {sp.n_slots} slots x "
                f"{sp.slot_stride} stride",
                label,
            )
        )
    if sp.slot_stride % sp.alignment:
        findings.append(
            _finding(
                "state-stride-unaligned",
                f"slot stride {sp.slot_stride} not a multiple of "
                f"{sp.alignment}",
                label,
            )
        )
    spans: list[tuple[int, int, str]] = []
    for leaf in sp.leaves:
        where = f"{label}:{leaf.path}"
        nbytes = _leaf_nbytes(leaf)
        if nbytes % sp.n_slots:
            findings.append(
                _finding(
                    "state-indivisible",
                    f"{nbytes} B not divisible across {sp.n_slots} slots",
                    where,
                )
            )
            continue
        per_slot = nbytes // sp.n_slots
        want = -(-per_slot // sp.alignment) * sp.alignment
        if leaf.slot_nbytes != want:
            findings.append(
                _finding(
                    "state-leaf-size",
                    f"slot_nbytes {leaf.slot_nbytes} != aligned per-slot "
                    f"payload {want} ({per_slot} B)",
                    where,
                )
            )
        if leaf.offset < 0 or leaf.offset % sp.alignment:
            findings.append(
                _finding(
                    "state-leaf-unaligned",
                    f"offset {leaf.offset} not {sp.alignment}-aligned "
                    f"and non-negative",
                    where,
                )
            )
        if leaf.offset + max(leaf.slot_nbytes, per_slot) > sp.slot_stride:
            findings.append(
                _finding(
                    "state-leaf-spill",
                    f"leaf [{leaf.offset}, "
                    f"{leaf.offset + max(leaf.slot_nbytes, per_slot)}) spills "
                    f"past slot stride {sp.slot_stride}",
                    where,
                )
            )
        spans.append(
            (leaf.offset, leaf.offset + max(leaf.slot_nbytes, per_slot, 1),
             leaf.path)
        )
    spans.sort()
    for (a_off, a_end, a_path), (b_off, _b_end, b_path) in zip(
        spans, spans[1:]
    ):
        if b_off < a_end:
            findings.append(
                _finding(
                    "state-leaf-collision",
                    f"leaves {a_path!r} and {b_path!r} overlap within the "
                    f"slot ([{a_off}, {a_end}) vs offset {b_off})",
                    label,
                )
            )
    if getattr(sp, "page_size", None) is not None:
        findings += _certify_paged_state(sp, label=label)
    return findings


def _certify_paged_state(sp, *, label: str) -> list[Finding]:
    """The paged extras over :func:`certify_state_plan`'s symmetric
    checks (duck-typed — any plan carrying ``page_size`` qualifies, so a
    deserialized bundle certifies without importing planner classes):
    the physical pool really is ``n_pages_pool`` disjoint, page-aligned,
    in-bounds pages; the token spans re-derive to each leaf's per-slot
    payload; a pool too small to map even one full slot is flagged."""
    findings: list[Finding] = []
    if sp.page_size <= 0:
        findings.append(
            _finding(
                "paged-page-size", f"page size {sp.page_size} <= 0", label
            )
        )
        return findings  # every pool check below divides by it
    if sp.n_pages_pool < 1:
        findings.append(
            _finding(
                "paged-pool-empty",
                f"page pool holds {sp.n_pages_pool} pages — no request "
                f"can ever be admitted",
                label,
            )
        )
    pages_per_slot = -(-sp.slot_stride // sp.page_size)
    if 0 < sp.n_pages_pool < pages_per_slot:
        findings.append(
            Finding(
                pass_name=PASS,
                code="paged-pool-short",
                message=(
                    f"pool of {sp.n_pages_pool} pages cannot map one "
                    f"full slot ({pages_per_slot} pages/slot) — "
                    f"max_len requests will be refused"
                ),
                where=label,
                severity="warning",
            )
        )
    if len(sp.page_offsets) != sp.n_pages_pool:
        findings.append(
            _finding(
                "paged-pool-empty",
                f"{len(sp.page_offsets)} page offsets for a pool of "
                f"{sp.n_pages_pool}",
                label,
            )
        )
    phys_total = (sp.n_pages_pool + 1) * sp.page_size
    seen: dict[int, int] = {0: -1}  # offset -> pool index (null page = -1)
    for i, off in enumerate(sp.page_offsets):
        if off < 0 or off % sp.page_size:
            findings.append(
                _finding(
                    "paged-page-unaligned",
                    f"pool page {i} at offset {off} not page-aligned and "
                    f"non-negative",
                    label,
                )
            )
        if off + sp.page_size > phys_total:
            findings.append(
                _finding(
                    "paged-page-spill",
                    f"pool page {i} spans [{off}, {off + sp.page_size}) "
                    f"past physical end {phys_total}",
                    label,
                )
            )
        if off in seen:
            other = "the null page" if seen[off] < 0 else f"page {seen[off]}"
            findings.append(
                _finding(
                    "paged-page-collision",
                    f"pool page {i} at offset {off} collides with {other}",
                    label,
                )
            )
        else:
            seen[off] = i
    if len(sp.token_spans) != len(sp.leaves):
        findings.append(
            _finding(
                "paged-span-size",
                f"{len(sp.token_spans)} token spans for {len(sp.leaves)} "
                f"leaves",
                label,
            )
        )
        return findings
    for leaf, span in zip(sp.leaves, sp.token_spans):
        if span is None:
            continue
        where = f"{label}:{leaf.path}"
        nbytes = _leaf_nbytes(leaf)
        if nbytes % max(sp.n_slots, 1):
            continue  # already reported as state-indivisible
        n_chunks, n_rows, row_nbytes = span
        if n_chunks * n_rows * row_nbytes != nbytes // sp.n_slots:
            findings.append(
                _finding(
                    "paged-span-size",
                    f"token span {span} covers "
                    f"{n_chunks * n_rows * row_nbytes} B, leaf carries "
                    f"{nbytes // sp.n_slots} B/slot",
                    where,
                )
            )
    return findings


# ---------------------------------------------------------------- drivers


def certify_plan(plan: "MemoryPlan", *, label: str | None = None) -> list[Finding]:
    """Certify one activation :class:`MemoryPlan` (offsets + optional
    shared-objects provenance)."""
    where = label or f"{plan.graph_name}[{plan.strategy}]"
    findings = certify_offsets(
        plan.records, plan.offsets, plan.total_size, label=where
    )
    if plan.shared_objects is not None:
        findings += certify_shared_objects(
            plan.records, plan.shared_objects, label=where
        )
    return findings


def certify_unified(
    up: "UnifiedPlan", *, label: str = "unified"
) -> list[Finding]:
    """Certify every half of a :class:`UnifiedPlan` (activation, state,
    and — when planned — the prefill activation arena)."""
    findings: list[Finding] = []
    if up.activation is not None:
        findings += certify_plan(up.activation, label=f"{label}:activation")
    if up.state is not None:
        findings += certify_state_plan(up.state, label=f"{label}:state")
    if up.prefill is not None:
        findings += certify_plan(up.prefill, label=f"{label}:prefill")
    return findings


__all__ = [
    "certify_offsets",
    "certify_shared_objects",
    "certify_state_plan",
    "certify_plan",
    "certify_unified",
]
