"""Shared interval-overlap engine for the planning core.

Every strategy in this package reduces to two queries over closed integer
intervals ``[first_op, last_op]`` (the paper's tensor usage intervals):

* "does this interval overlap anything already placed *here*?"
* "which already-placed tensors overlap this interval?"

The seed implementations answered both with per-object/per-record linear
walks (the paper's O(k·n²) inner loop). This module centralizes the three
data structures that make every strategy O(n log n)-ish; the frozen naive
versions live on in :mod:`repro_torch.core.reference` as the differential-test
oracle.

* :class:`DisjointIntervalSet` — the intervals assigned to one shared
  object are pairwise disjoint *by construction* (that is the shared-object
  invariant), so sorted-by-start order is a total order and only the
  immediate predecessor/successor of a query interval can matter:
  overlap and smallest-gap queries are a single ``bisect``, O(log n).

* :class:`IntervalTree` — a balanced interval tree (treap with
  deterministic pseudo-random priorities) augmented with the maximum
  endpoint of each subtree, over *arbitrary* mutually-overlapping
  intervals. ``overlapping(first, last)`` enumerates the m intersecting
  entries in O(m log n) by pruning subtrees whose ``max_end`` ends before
  the query.

* :class:`BestFitArena` — the shared offset allocator built on
  :class:`IntervalTree`: places records one at a time at the best-fit
  (paper Algorithm 3) or first-fit (Sekiyama'18 strip packing) gap among
  the already-placed, lifetime-overlapping tensors. Gap-scan order and
  tie-breaking are byte-identical to the oracle's full scan — it merely
  skips the records that the oracle's ``rec.overlaps(x)`` filter would
  have discarded anyway.
"""

from __future__ import annotations

import bisect
from typing import Any, Iterator

import numpy as _np

_INF = 1 << 60

# Overlap count at which BestFitArena.find_offset switches from the
# per-record Python gap scan to the numpy batch path. Dense graphs (long
# activation lifetimes — the prefill regime) cross it and stay ~flat per
# query; sparse decode graphs never do and keep the cheap tree walk. Per-
# arena override via BestFitArena(vector_threshold=...): 0 forces the
# vectorized path (differential tests), a huge value disables it.
VECTOR_THRESHOLD = 1024

_MASK64 = (1 << 64) - 1
_GAMMA = 0x9E3779B97F4A7C15  # splitmix64 increment


class DisjointIntervalSet:
    """Sorted set of pairwise-disjoint closed intervals ``[first, last]``.

    The caller guarantees disjointness (``add`` only after ``overlaps``
    returned False); under that invariant start order == end order, so
    every query is one predecessor lookup.
    """

    __slots__ = ("_starts", "_ends", "_items")

    def __init__(self) -> None:
        self._starts: list[int] = []
        self._ends: list[int] = []
        self._items: list[Any] = []

    def __len__(self) -> int:
        return len(self._starts)

    def __iter__(self) -> Iterator[tuple[int, int, Any]]:
        return iter(zip(self._starts, self._ends, self._items))

    def add(self, first: int, last: int, item: Any = None) -> None:
        idx = bisect.bisect_left(self._starts, first)
        self._starts.insert(idx, first)
        self._ends.insert(idx, last)
        self._items.insert(idx, item)

    def overlaps(self, first: int, last: int) -> bool:
        """True iff ``[first, last]`` intersects any stored interval.

        Only the stored interval with the greatest start <= ``last`` can
        intersect: anything starting later begins past the query, anything
        earlier ends before it (disjointness orders the ends too).
        """
        idx = bisect.bisect_right(self._starts, last) - 1
        return idx >= 0 and self._ends[idx] >= first

    def smallest_gap(self, first: int, last: int) -> int:
        """Smallest idle gap adjacent to ``[first, last]`` (paper §4.4's
        pairing criterion), assuming the query overlaps nothing stored.
        ``_INF``-ish when the set is empty / has no neighbor on either side.
        """
        best = _INF
        i = bisect.bisect_left(self._starts, first) - 1
        if i >= 0:
            best = first - self._ends[i] - 1
        j = bisect.bisect_right(self._starts, last)
        if j < len(self._starts):
            best = min(best, self._starts[j] - last - 1)
        return best

    def neighbors(self, first: int, last: int) -> tuple[int, int]:
        """``(pred_end, succ_start)`` of the intervals flanking
        ``[first, last]`` — which may itself be stored or merely storable
        (disjoint from everything). Sentinels ``-_INF`` / ``_INF`` stand in
        for a missing flank, so the pair always bounds the idle window
        around the query."""
        i = bisect.bisect_left(self._starts, first) - 1
        pred = self._ends[i] if i >= 0 else -_INF
        j = bisect.bisect_right(self._starts, last)
        succ = self._starts[j] if j < len(self._starts) else _INF
        return pred, succ


class _Node:
    __slots__ = ("first", "last", "item", "prio", "left", "right", "max_end")

    def __init__(self, first: int, last: int, item: Any, prio: int):
        self.first = first
        self.last = last
        self.item = item
        self.prio = prio
        self.left: "_Node | None" = None
        self.right: "_Node | None" = None
        self.max_end = last


def _update(n: _Node) -> None:
    m = n.last
    if n.left is not None and n.left.max_end > m:
        m = n.left.max_end
    if n.right is not None and n.right.max_end > m:
        m = n.right.max_end
    n.max_end = m


def _rotate_right(y: _Node) -> _Node:
    x = y.left
    assert x is not None
    y.left = x.right
    x.right = y
    _update(y)
    _update(x)
    return x


def _rotate_left(x: _Node) -> _Node:
    y = x.right
    assert y is not None
    x.right = y.left
    y.left = x
    _update(x)
    _update(y)
    return y


class IntervalTree:
    """Balanced interval tree (treap, max-endpoint augmented).

    Keys are interval starts; priorities come from a deterministic
    splitmix64 stream so identical insertion sequences build identical
    trees (plan results must be reproducible across runs).
    """

    __slots__ = ("_root", "_n", "_state")

    def __init__(self) -> None:
        self._root: _Node | None = None
        self._n = 0
        self._state = 0

    def __len__(self) -> int:
        return self._n

    def _next_prio(self) -> int:
        self._state = (self._state + _GAMMA) & _MASK64
        z = self._state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        return z ^ (z >> 31)

    def insert(self, first: int, last: int, item: Any = None) -> None:
        self._n += 1
        self._root = self._insert(self._root, first, last, item, self._next_prio())

    def _insert(
        self, node: _Node | None, first: int, last: int, item: Any, prio: int
    ) -> _Node:
        if node is None:
            return _Node(first, last, item, prio)
        if first < node.first:
            node.left = self._insert(node.left, first, last, item, prio)
            if node.left.prio < node.prio:
                node = _rotate_right(node)
            else:
                _update(node)
        else:
            node.right = self._insert(node.right, first, last, item, prio)
            if node.right.prio < node.prio:
                node = _rotate_left(node)
            else:
                _update(node)
        return node

    def overlapping(self, first: int, last: int) -> list[Any]:
        """All stored items whose interval intersects ``[first, last]``.

        Prunes on ``max_end`` (left descents) and on key order (right
        descents): O(log n + m·log n) worst case, O(log n + m) typical.
        """
        out: list[Any] = []
        node = self._root
        stack: list[_Node] = []
        while node is not None or stack:
            while node is not None and node.max_end >= first:
                stack.append(node)
                node = node.left
            if not stack:
                break
            node = stack.pop()
            if node.first <= last:
                if node.last >= first:
                    out.append(node.item)
                node = node.right
            else:
                # every key in the right subtree is >= node.first > last
                node = None
        return out


class BestFitArena:
    """Incremental offset allocator shared by every offsets strategy.

    Reproduces the paper's Algorithm 3 gap search exactly: scan the
    already-placed, lifetime-overlapping records in increasing
    (offset, tensor_id) order; best-fit takes the smallest gap that fits
    (first such gap on ties), first-fit (``first_fit=True``) takes the
    lowest; either appends after the rightmost overlapping record when no
    gap fits.

    Two byte-identical engines answer the same query. The scalar path
    (tree walk + Python scan) wins when few placed records overlap the
    query; once a query sees >= ``vector_threshold`` overlapping records
    the next queries run the numpy batch path — one boolean lifetime mask
    over all placed records, a ``lexsort`` by (offset, tensor_id), and a
    prefix-max gap scan — whose per-query cost is a handful of
    vectorized passes instead of m sort comparisons in Python. The
    overlap count observed by either engine feeds the same estimate, so
    an arena moves between them as its density changes and the choice
    stays deterministic for a given placement sequence.
    """

    __slots__ = (
        "offsets", "total", "first_fit", "vector_threshold", "_tree",
        "_rows", "_n", "_firsts", "_lasts", "_offs", "_sizes", "_ids",
        "_last_overlap",
    )

    def __init__(
        self, *, first_fit: bool = False, vector_threshold: int | None = None
    ):
        self.offsets: dict[int, int] = {}
        self.total = 0
        self.first_fit = first_fit
        self.vector_threshold = (
            VECTOR_THRESHOLD if vector_threshold is None else vector_threshold
        )
        self._tree = IntervalTree()
        # placement log: cheap append-only rows until the vector path
        # first engages (sparse arenas never pay for columns they never
        # query), then (offset, tensor_id)-sorted int64 numpy columns
        # maintained incrementally
        self._rows: list[tuple[int, int, int, int, int]] | None = []
        self._n = 0
        self._firsts = None
        self._lasts = None
        self._offs = None
        self._sizes = None
        self._ids = None
        self._last_overlap = 0

    def __len__(self) -> int:
        return len(self._tree)

    def find_offset(self, rec) -> int:
        """The offset ``rec`` would get; does not place it."""
        if self._last_overlap >= self.vector_threshold:
            if self._rows is not None:
                self._build_columns()
            return self._find_offset_vector(rec)
        over = self._tree.overlapping(rec.first_op, rec.last_op)
        self._last_overlap = len(over)
        offsets = self.offsets
        over.sort(key=lambda r: (offsets[r.tensor_id], r.tensor_id))
        prev = 0
        best: int | None = None
        smallest: int | None = None
        size = rec.size
        for x in over:
            x_off = offsets[x.tensor_id]
            gap = x_off - prev
            if gap >= size:
                if self.first_fit:
                    return prev
                if smallest is None or gap < smallest:
                    smallest = gap
                    best = prev
            end = x_off + x.size
            if end > prev:
                prev = end
        return prev if best is None else best

    def _find_offset_vector(self, rec) -> int:
        """Numpy twin of the scalar gap scan. The columns are kept sorted
        by (offset, tensor_id) at insertion time, so the lifetime-masked
        compress is already in the scalar scan order — no per-query sort.
        Same running ``prev`` (a shifted prefix-max of placement ends —
        every end is positive, so max(0, ...) is the prefix-max itself),
        same first-occurrence tie-breaks (``argmin``/first candidate)."""
        np = _np
        n = self._n
        if n == 0:
            self._last_overlap = 0
            return 0
        mask = (self._firsts[:n] <= rec.last_op) & (
            self._lasts[:n] >= rec.first_op
        )
        m = int(np.count_nonzero(mask))
        self._last_overlap = m
        if m == 0:
            return 0
        offs = self._offs[:n][mask]
        cum = np.maximum.accumulate(offs + self._sizes[:n][mask])
        prev = np.empty(m, np.int64)
        prev[0] = 0
        prev[1:] = cum[:-1]
        gaps = offs - prev
        cand = np.flatnonzero(gaps >= rec.size)
        if cand.size == 0:
            return int(cum[-1])
        if self.first_fit:
            return int(prev[cand[0]])
        return int(prev[cand[np.argmin(gaps[cand])]])

    def place(self, rec) -> int:
        """Find the gap for ``rec``, place it there, return its offset."""
        off = self.find_offset(rec)
        self.place_at(rec, off)
        return off

    def place_at(self, rec, off: int) -> None:
        """Record ``rec`` at a caller-chosen offset (fixed placements)."""
        self.offsets[rec.tensor_id] = off
        self._tree.insert(rec.first_op, rec.last_op, rec)
        if self._rows is not None:
            self._rows.append(
                (rec.first_op, rec.last_op, off, rec.size, rec.tensor_id)
            )
        else:
            self._append_column(rec, off)
        end = off + rec.size
        if end > self.total:
            self.total = end

    def _build_columns(self) -> None:
        """One-time switch from the append-only log to sorted columns,
        at the first vector-path query."""
        rows = self._rows
        assert rows is not None
        self._rows = None
        self._n = len(rows)
        if not rows:
            return
        cols = _np.asarray(rows, _np.int64).T
        order = _np.lexsort((cols[4], cols[2]))
        self._firsts = _np.ascontiguousarray(cols[0][order])
        self._lasts = _np.ascontiguousarray(cols[1][order])
        self._offs = _np.ascontiguousarray(cols[2][order])
        self._sizes = _np.ascontiguousarray(cols[3][order])
        self._ids = _np.ascontiguousarray(cols[4][order])

    def _append_column(self, rec, off: int) -> None:
        """Insert the placement into the columns at its (offset,
        tensor_id) rank — a searchsorted + one vectorized shift per
        column, so vector queries never sort."""
        n = self._n
        if self._firsts is None:
            cap = 256
            self._firsts = _np.empty(cap, _np.int64)
            self._lasts = _np.empty(cap, _np.int64)
            self._offs = _np.empty(cap, _np.int64)
            self._sizes = _np.empty(cap, _np.int64)
            self._ids = _np.empty(cap, _np.int64)
        elif n + 1 > len(self._firsts):
            for name in ("_firsts", "_lasts", "_offs", "_sizes", "_ids"):
                old = getattr(self, name)
                new = _np.empty(2 * n, _np.int64)
                new[:n] = old[:n]
                setattr(self, name, new)
        lo = int(_np.searchsorted(self._offs[:n], off, side="left"))
        hi = int(_np.searchsorted(self._offs[:n], off, side="right"))
        pos = lo + int(
            _np.searchsorted(self._ids[lo:hi], rec.tensor_id, side="left")
        )
        for arr, val in (
            (self._firsts, rec.first_op),
            (self._lasts, rec.last_op),
            (self._offs, off),
            (self._sizes, rec.size),
            (self._ids, rec.tensor_id),
        ):
            arr[pos + 1 : n + 1] = arr[pos:n]
            arr[pos] = val
        self._n = n + 1
