"""Shared Objects strategies (paper §4).

Each intermediate tensor is assigned exactly one *shared object* (reusable
buffer). No two tensors with intersecting usage intervals may share an
object; an object's size is the max of its assigned tensor sizes. Objective:
minimize the total size of all shared objects.

Three strategies from the paper:
* ``greedy_by_breadth``      — §4.2, Algorithm 1
* ``greedy_by_size``         — §4.3, Algorithm 2
* ``greedy_by_size_improved``— §4.4 (staged by positional maximums +
  smallest-gap pairing inside a stage)

All return a :class:`SharedObjectsAssignment`.

Complexity: the paper's naive formulation is O(k·n²). Here every
per-object overlap/gap query goes through
:class:`repro_torch.core.interval_set.DisjointIntervalSet` (one ``bisect``, the
paper's "interval tree" refinement made exact: an object's intervals are
disjoint, so only the query's immediate neighbor can conflict) and object
*selection* walks a pool kept sorted by ``(size, object_id)`` instead of
scanning every object. Results are byte-identical to the frozen oracle in
:mod:`repro_torch.core.reference` — tie-breaking is preserved exactly — which
``tests/test_differential_planner.py`` enforces.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
from typing import Callable, Sequence

from repro_torch.core.interval_set import DisjointIntervalSet
from repro_torch.core.records import (
    TensorUsageRecord,
    operator_breadths,
    operator_profiles,
    positional_maximums,
)


@dataclasses.dataclass
class SharedObject:
    object_id: int
    size: int
    interval_set: DisjointIntervalSet = dataclasses.field(
        default_factory=DisjointIntervalSet
    )

    @property
    def intervals(self) -> list[tuple[int, int, int]]:
        """Assigned (first_op, last_op, tensor_id), sorted by first_op."""
        return list(self.interval_set)

    def fits(self, rec: TensorUsageRecord) -> bool:
        """True iff ``rec``'s interval intersects no assigned interval."""
        return not self.interval_set.overlaps(rec.first_op, rec.last_op)

    def assign(self, rec: TensorUsageRecord) -> None:
        self.interval_set.add(rec.first_op, rec.last_op, rec.tensor_id)
        if rec.size > self.size:
            self.size = rec.size

    def gap_to(self, rec: TensorUsageRecord) -> int:
        """Smallest idle gap this object would have right before/after
        ``rec``'s interval (paper §4.4's pairing criterion). Infinite-ish if
        the object is empty."""
        return self.interval_set.smallest_gap(rec.first_op, rec.last_op)


@dataclasses.dataclass
class SharedObjectsAssignment:
    strategy: str
    objects: list[SharedObject]
    # tensor_id -> object_id
    assignment: dict[int, int]

    @property
    def total_size(self) -> int:
        return sum(o.size for o in self.objects)

    def object_of(self, tensor_id: int) -> SharedObject:
        return self.objects[self.assignment[tensor_id]]


def _new_assignment(strategy: str) -> SharedObjectsAssignment:
    return SharedObjectsAssignment(strategy=strategy, objects=[], assignment={})


def _create_object(asn: SharedObjectsAssignment, rec: TensorUsageRecord) -> SharedObject:
    obj = SharedObject(object_id=len(asn.objects), size=rec.size)
    asn.objects.append(obj)
    return obj


class _ObjectPool:
    """Objects kept sorted ascending by ``(size, object_id)``.

    Selection rules become ordered scans from a bisect point instead of
    full sweeps; the scan still stops at the first *fitting* object, so the
    worst case matches the naive loop but the common case touches O(1)
    objects after an O(log k) bisect.
    """

    __slots__ = ("_keys", "_objs")

    def __init__(self) -> None:
        self._keys: list[tuple[int, int]] = []
        self._objs: list[SharedObject] = []

    def add(self, obj: SharedObject) -> None:
        k = (obj.size, obj.object_id)
        i = bisect.bisect_left(self._keys, k)
        self._keys.insert(i, k)
        self._objs.insert(i, obj)

    def remove(self, obj: SharedObject) -> None:
        i = bisect.bisect_left(self._keys, (obj.size, obj.object_id))
        del self._keys[i]
        del self._objs[i]

    def smallest_fitting(self, rec: TensorUsageRecord) -> SharedObject | None:
        """Smallest (then lowest-id) object with size >= rec.size that fits
        — the Greedy-by-Size selection (all pool sizes >= rec.size there)
        and the first branch of Greedy-by-Breadth's ``is_better``."""
        start = bisect.bisect_left(self._keys, (rec.size, -1))
        for i in range(start, len(self._objs)):
            if self._objs[i].fits(rec):
                return self._objs[i]
        return None

    def largest_smaller_fitting(self, rec: TensorUsageRecord) -> SharedObject | None:
        """Largest (then lowest-id) object with size < rec.size that fits —
        Greedy-by-Breadth's grow-the-biggest fallback branch."""
        i = bisect.bisect_left(self._keys, (rec.size, -1)) - 1
        while i >= 0:
            if self._objs[i].fits(rec):
                best = self._objs[i]
                # equal-size ties break on LOWEST object id (the oracle
                # scans ids ascending and only replaces on strictly-larger
                # size); walk the tie run down to find it
                j = i - 1
                while j >= 0 and self._objs[j].size == best.size:
                    if self._objs[j].fits(rec):
                        best = self._objs[j]
                    j -= 1
                return best
            i -= 1
        return None


def _pool_select_is_better(
    asn: SharedObjectsAssignment, pool: _ObjectPool, rec: TensorUsageRecord
) -> SharedObject:
    """The paper's ``is_better`` object choice (§4.2 L.11–17) with pool
    bookkeeping: smallest fitting object >= size_t, else grow the largest
    smaller one, else create. Shared by greedy_by_breadth and
    extensions.greedy_by_conflict — the tie-break contract with the frozen
    oracle lives in exactly one place."""
    best = pool.smallest_fitting(rec)
    if best is not None:
        best.assign(rec)
        return best
    best = pool.largest_smaller_fitting(rec)
    if best is None:
        best = _create_object(asn, rec)
        best.assign(rec)
    else:
        pool.remove(best)  # assign() below may grow its size
        best.assign(rec)
    pool.add(best)
    return best


def greedy_by_size(
    records: Sequence[TensorUsageRecord],
) -> SharedObjectsAssignment:
    """Paper §4.3, Algorithm 2.

    Tensors in non-increasing size order; assign the smallest suitable
    object (all suitable objects are >= size_t since sizes are
    non-increasing); create a new object if none is suitable.
    """
    asn = _new_assignment("greedy_by_size")
    pool = _ObjectPool()
    order = sorted(records, key=lambda r: (-r.size, r.first_op, r.tensor_id))
    for rec in order:
        best = pool.smallest_fitting(rec)
        if best is None:
            best = _create_object(asn, rec)
            pool.add(best)
        # sizes arrive non-increasing, so assign() never grows an object
        # here and the pool order stays valid
        best.assign(rec)
        asn.assignment[rec.tensor_id] = best.object_id
    return asn


def greedy_by_breadth(
    records: Sequence[TensorUsageRecord],
) -> SharedObjectsAssignment:
    """Paper §4.2, Algorithm 1.

    Operators in non-increasing breadth order; within each operator's
    profile, unassigned tensors largest-first. Object choice (paper's
    ``is_better`` logic, L.11–17):
      * prefer suitable objects with size >= size_t, smallest such;
      * else (all suitable objects smaller) take the largest and grow it;
      * else create a new object.
    """
    asn = _new_assignment("greedy_by_breadth")
    pool = _ObjectPool()
    breadths = operator_breadths(records)
    profiles = operator_profiles(records)
    op_order = sorted(range(len(breadths)), key=lambda i: (-breadths[i], i))
    for op_idx in op_order:
        for rec in profiles[op_idx]:  # already sorted by size desc
            if rec.tensor_id in asn.assignment:
                continue
            best = _pool_select_is_better(asn, pool, rec)
            asn.assignment[rec.tensor_id] = best.object_id
    return asn


def _stages_by_positional_maximums(
    records: Sequence[TensorUsageRecord],
) -> list[list[TensorUsageRecord]]:
    """Split records into stages (paper §4.4): stage boundaries at the
    distinct positional-maximum values, descending. Stage 2i collects
    tensors with size == pm_i; stage 2i+1 those with pm_{i+1} < size < pm_i.
    (Equivalently: group by the interval of pm values the size falls in.)

    One pointer walk over the size-descending record order — every record
    size is <= pm_0 (each tensor is live somewhere, so the global maximum
    size IS a positional maximum), so peeling the == and the in-between
    runs per pm is an exact linear merge of the oracle's per-pm filters.
    """
    pms = sorted(set(positional_maximums(records)), reverse=True)
    recs = sorted(records, key=lambda r: (-r.size, r.first_op, r.tensor_id))
    stages: list[list[TensorUsageRecord]] = []
    i, n = 0, len(recs)
    for k, pm in enumerate(pms):
        eq: list[TensorUsageRecord] = []
        while i < n and recs[i].size == pm:
            eq.append(recs[i])
            i += 1
        if eq:
            stages.append(eq)
        lo = pms[k + 1] if k + 1 < len(pms) else 0
        mid: list[TensorUsageRecord] = []
        while i < n and lo < recs[i].size < pm:
            mid.append(recs[i])
            i += 1
        if mid:
            stages.append(mid)
    return stages


def greedy_by_size_improved(
    records: Sequence[TensorUsageRecord],
) -> SharedObjectsAssignment:
    """Paper §4.4: Greedy-by-Size staged by positional maximums; inside a
    stage, repeatedly pick the (tensor, suitable object) pair with the
    smallest idle gap; tensors with no suitable object get new objects
    last (largest first).

    The paper claims the improvements give "better or the same result"
    than plain Greedy-by-Size; staging is a heuristic, so we guarantee the
    claim by construction: return whichever of (staged, plain) is smaller.
    """
    staged = _greedy_by_size_improved_staged(records)
    plain = greedy_by_size(records)
    if plain.total_size < staged.total_size:
        plain = SharedObjectsAssignment(
            strategy="greedy_by_size_improved",
            objects=plain.objects,
            assignment=plain.assignment,
        )
        return plain
    return staged


def _greedy_by_size_improved_staged(
    records: Sequence[TensorUsageRecord],
) -> SharedObjectsAssignment:
    asn = _new_assignment("greedy_by_size_improved")
    for stage in _stages_by_positional_maximums(records):
        _assign_stage_pairs(asn, stage)
    return asn


def _assign_stage_pairs(
    asn: SharedObjectsAssignment, stage: list[TensorUsageRecord]
) -> None:
    """One §4.4 stage through a lazily-invalidated min-heap of
    (gap, pending rank, object id) pairs instead of the oracle's full
    (pending x objects) rescan per assignment.

    Why the heap order IS the oracle's tie-break: the oracle scans pending
    in list order and ``asn.objects`` in id order, replacing only on a
    strictly smaller gap — its pick is the lexicographic minimum over
    (gap, pending position, object id). The stage list arrives sorted by
    ``(-size, first_op, tensor_id)`` and the oracle's in-stage re-sort
    uses the same key (a stable no-op), so pending position == rank in
    ``stage``, and the heap's tuple order reproduces the pick exactly.

    Why lazy invalidation is sound: an object only ever GAINS intervals,
    so a pair's gap is non-increasing over a stage (and ``fits`` never
    flips back to True). Every gap change is caused by an insertion into
    the pair's enclosing idle window, and each insertion re-pushes exact
    entries for exactly the pending records inside the two windows it
    split — so every live pair always has one exact entry queued, stale
    entries are strictly gap-high, and a popped entry whose stored gap no
    longer matches can be discarded outright.
    """
    n = len(stage)
    if not n:
        return
    alive = [True] * n
    n_alive = n
    # window index: ranks ordered by first_op (ties by rank), so "pending
    # records fully inside an idle window" is one bisect + a bounded scan
    by_first = sorted(range(n), key=lambda r: (stage[r].first_op, r))
    first_keys = [stage[r].first_op for r in by_first]
    heap: list[tuple[int, int, int]] = []
    objs = asn.objects

    def push_window(obj: SharedObject, lo: int, hi: int) -> None:
        # exact-gap entries for every alive record fully inside the open
        # idle window (lo, hi) of ``obj`` (sentinel-bounded at the edges)
        i = bisect.bisect_right(first_keys, lo)
        oid = obj.object_id
        while i < len(first_keys) and first_keys[i] < hi:
            r = by_first[i]
            if alive[r]:
                rec = stage[r]
                if rec.last_op < hi:
                    heapq.heappush(heap, (obj.gap_to(rec), r, oid))
            i += 1

    if objs:
        # Seed pairs against the objects earlier stages built. Two exact
        # enumerations of the same fitting pairs — pick the cheaper side:
        # rec-major probes every (rec, object) once; window-major walks
        # each object's idle windows (better when objects carry many
        # intervals and the stage is small).
        n_windows = sum(len(o.interval_set) + 1 for o in objs)
        if n * len(objs) <= n_windows:
            for r in range(n):
                rec = stage[r]
                for obj in objs:
                    if obj.fits(rec):
                        heapq.heappush(
                            heap, (obj.gap_to(rec), r, obj.object_id)
                        )
        else:
            for obj in objs:
                lo = -(1 << 60)
                for start, end, _ in obj.interval_set:
                    push_window(obj, lo, start)
                    lo = end
                push_window(obj, lo, 1 << 60)

    rank_ptr = 0  # lowest possibly-alive rank (ranks die monotonically
    #               under the no-pair branch; heap picks can skip around)
    while n_alive:
        picked: tuple[int, SharedObject] | None = None
        while heap:
            gap, r, oid = heapq.heappop(heap)
            if not alive[r]:
                continue
            obj = objs[oid]
            rec = stage[r]
            if not obj.fits(rec):
                continue
            if obj.gap_to(rec) != gap:
                continue  # stale-high; the exact entry is still queued
            picked = (r, obj)
            break
        if picked is None:
            # No suitable existing object for any pending tensor: open a
            # new object for the largest pending tensor (== lowest alive
            # rank), then resume pairing (remaining tensors may fit it).
            while not alive[rank_ptr]:
                rank_ptr += 1
            r = rank_ptr
            rec = stage[r]
            obj = _create_object(asn, rec)
        else:
            r, obj = picked
            rec = stage[r]
        obj.assign(rec)
        asn.assignment[rec.tensor_id] = obj.object_id
        alive[r] = False
        n_alive -= 1
        if n_alive:
            lo, hi = obj.interval_set.neighbors(rec.first_op, rec.last_op)
            push_window(obj, lo, rec.first_op)
            push_window(obj, rec.last_op, hi)


def from_slot_log(
    slot_log: Sequence[tuple[int, int, int, int]],
    *,
    n_slots: int | None = None,
    slot_size: int = 1,
    state_plan=None,
) -> SharedObjectsAssignment:
    """Build the §4-style assignment from a serving slot log
    (``(slot, first_wave, last_wave, request_id)`` tuples, as recorded by
    the engine): slots are the shared objects, requests the tensors, the
    decode wave the operator index. Raises ``ValueError`` if two requests
    overlap on one slot — this is the runtime audit of the cross-step
    :class:`~repro_torch.core.unified.StatePlan`'s shared-objects claim.

    Pass ``state_plan`` to audit against the plan the engine actually
    serves from — ``n_slots`` and ``slot_size`` then come from the plan's
    own slot regions (bucket auto-selection may serve a wider pool than a
    caller requested, so deriving them from the plan is the only
    assignment that cannot disagree with the live layout)."""
    if state_plan is not None:
        n_slots = state_plan.n_slots
        slot_size = state_plan.bytes_per_slot
    if n_slots is None:
        raise ValueError("from_slot_log needs n_slots or a state_plan")
    asn = SharedObjectsAssignment(
        strategy="slot_log",
        objects=[SharedObject(object_id=s, size=slot_size) for s in range(n_slots)],
        assignment={},
    )
    for slot, first, last, rid in slot_log:
        if not 0 <= slot < n_slots:
            raise ValueError(f"request {rid}: slot {slot} outside [0, {n_slots})")
        obj = asn.objects[slot]
        # closed wave intervals; the engine frees a slot at the END of its
        # finishing wave and admits at the start of the next, so legal
        # hand-offs never share a wave and plain overlap is a violation
        if obj.interval_set.overlaps(first, last):
            raise ValueError(
                f"request {rid}: interval [{first}, {last}] overlaps an "
                f"earlier request on slot {slot}"
            )
        obj.interval_set.add(first, last, rid)
        asn.assignment[rid] = slot
    return asn


def from_page_log(
    page_log: Sequence[tuple[int, int, int, int]],
    *,
    n_pages: int | None = None,
    page_size: int = 1,
    state_plan=None,
) -> SharedObjectsAssignment:
    """Build the page-granular §4-style assignment from a serving page
    log (``(page, first_wave, last_wave, request_id)`` tuples, as
    recorded by the paged state backend): POOL PAGES are the shared
    objects, request-page holds the tensors, the decode wave the
    operator index. The twin of :func:`from_slot_log` one level down —
    it proves no page served two requests at overlapping waves, i.e.
    the runtime page allocator never double-assigned a live page.

    Pass ``state_plan`` (a :class:`~repro_torch.core.unified.PagedStatePlan`)
    to derive ``n_pages``/``page_size`` from the plan the engine
    actually serves from. Physical page indices are 1-based (0 is the
    reserved null page, which is never allocated and must never appear
    in a log). Assignment keys are ``(request_id, page)`` — one request
    legitimately holds many pages."""
    if state_plan is not None:
        n_pages = state_plan.n_pages_pool
        page_size = state_plan.page_size
    if n_pages is None:
        raise ValueError("from_page_log needs n_pages or a paged state_plan")
    asn = SharedObjectsAssignment(
        strategy="page_log",
        objects=[
            SharedObject(object_id=p, size=page_size)
            for p in range(1, n_pages + 1)
        ],
        assignment={},
    )
    by_id = {obj.object_id: obj for obj in asn.objects}
    for page, first, last, rid in page_log:
        obj = by_id.get(page)
        if obj is None:
            raise ValueError(
                f"request {rid}: page {page} outside the pool [1, {n_pages}]"
                + (" (0 is the reserved null page)" if page == 0 else "")
            )
        # closed wave intervals, same hand-off rule as from_slot_log:
        # freed at the END of the finishing wave, reallocatable at the
        # start of the next — sharing a wave is a double assignment
        if obj.interval_set.overlaps(first, last):
            raise ValueError(
                f"request {rid}: interval [{first}, {last}] overlaps an "
                f"earlier occupant on page {page}"
            )
        obj.interval_set.add(first, last, rid)
        asn.assignment[(rid, page)] = page
    return asn


STRATEGIES: dict[str, Callable[[Sequence[TensorUsageRecord]], SharedObjectsAssignment]] = {
    "greedy_by_size": greedy_by_size,
    "greedy_by_size_improved": greedy_by_size_improved,
    "greedy_by_breadth": greedy_by_breadth,
}
