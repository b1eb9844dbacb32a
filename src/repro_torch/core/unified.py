"""Unified planning facade: one ``plan()`` over both of the paper's halves
(copy of the reference's ``core/unified.py`` up to its plan sessions).

* intra-step activation sharing — Offset Calculation / Shared Objects
  over the tensor usage records of one step (§4–§5, ``core/planner``);
* cross-step shared-objects state — the per-slot caches reused across
  requests, §4 applied above the kernel level where slots are the shared
  objects and requests are the tensors.

:class:`PlanSpec` is one planning request over both halves,
:func:`plan` plans it (the activation half optionally through the
memory-aware order/fusion search) and returns a :class:`UnifiedPlan`
under one fingerprint and one ``total_size``. :func:`plan_state` lays the
per-slot caches out in ``n_slots`` symmetric slot regions and
:func:`plan_paged_state` at page granularity; :func:`detect_state_axes`
finds each cache leaf's slot and token axes by evaluating ``init_cache``
on ``meta`` tensors. The layout code is the reference's, so a port
``StatePlan`` equals the JAX one field for field.

:func:`state_records_from_cache` is the twin of the reference's
``state_records_from_pytree``: it walks the port's cache structure (a
nested dict/tuple of tensors) and names each leaf with the path string
``jax.tree_util.keystr`` would give it, e.g. ``"['period'][0]['attn'][0]"``.

Every fingerprint here is the content fingerprint of the spec (the
reference's ``_spec_fingerprint``): the config-level decode fingerprint
that bundles share comes with plan sessions and bundles (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import TYPE_CHECKING, Any, Iterator, Sequence

import numpy as np

from repro_torch.core import plan_io
from repro_torch.core.interval_set import BestFitArena
from repro_torch.core.records import DEFAULT_ALIGNMENT, TensorUsageRecord, align

if TYPE_CHECKING:
    from repro_torch.core.fusion_search import FusionSearchResult
    from repro_torch.core.graph import Graph
    from repro_torch.core.order_search import OrderSearchResult
    from repro_torch.core.planner import MemoryPlan
    from repro_torch.runtime.arena import ArenaLayout

# Instrumentation: total state-plan constructions this process.
STATE_PLAN_CALLS = 0

STATE_STRATEGY = "slots_as_shared_objects"
PAGED_STATE_STRATEGY = "paged_shared_objects"


@dataclasses.dataclass(frozen=True)
class StateRecord:
    """One cross-step state tensor (a cache leaf): its identity and full
    (all-slot) byte size. The per-slot share is ``nbytes / n_slots`` —
    every leaf carries the slot batch dimension, so the division is exact
    (checked by :func:`plan_state`)."""

    path: str  # key path, e.g. "['period'][0]['attn'][1]"
    shape: tuple[int, ...]
    dtype: str
    nbytes: int


@dataclasses.dataclass(frozen=True)
class StateLeaf:
    """A :class:`StateRecord` placed inside one slot region: aligned
    per-slot byte size + concrete offset within the slot."""

    path: str
    shape: tuple[int, ...]
    dtype: str
    slot_nbytes: int  # aligned per-slot bytes
    offset: int  # byte offset within a slot region


@dataclasses.dataclass(frozen=True)
class LeafView:
    """One (slot, leaf) cell of the state arena, fully addressed: where
    its bytes live (``offset``), how many are payload (``used_nbytes``,
    the unaligned per-slot share) and how many are reserved
    (``slot_nbytes``, the aligned bounds-contract size)."""

    tensor_id: int  # dense: slot * n_leaves + leaf_index
    slot: int
    leaf_index: int
    path: str
    dtype: str
    offset: int  # absolute byte offset in the state buffer
    used_nbytes: int  # payload bytes of the per-slot share (unaligned)
    slot_nbytes: int  # planned slot bytes (aligned; bounds enforcement)


@dataclasses.dataclass
class StatePlan:
    """Slot/KV shared-objects layout with concrete offsets (paper §4 at
    the request level). ``n_slots`` identical slot regions of
    ``slot_stride`` bytes; leaf ``l`` of slot ``s`` lives at
    ``s * slot_stride + leaves[l].offset``."""

    n_slots: int
    max_len: int
    alignment: int
    leaves: list[StateLeaf]
    slot_stride: int
    total_size: int
    strategy: str = STATE_STRATEGY

    @property
    def bytes_per_slot(self) -> int:
        return self.slot_stride

    def offset_of(self, slot: int, path: str) -> int:
        if not 0 <= slot < self.n_slots:
            raise IndexError(f"slot {slot} outside [0, {self.n_slots})")
        for leaf in self.leaves:
            if leaf.path == path:
                return slot * self.slot_stride + leaf.offset
        raise KeyError(f"no state leaf at path {path!r}")

    def flat_entries(self) -> list[tuple[int, int, StateLeaf, int]]:
        """(tensor_id, slot, leaf, absolute_offset) tuple view over
        :meth:`leaf_view_spec` — same cells, legacy tuple shape."""
        return [
            (v.tensor_id, v.slot, self.leaves[v.leaf_index], v.offset)
            for v in self.leaf_view_spec()
        ]

    def leaf_view_spec(self) -> "list[LeafView]":
        """One :class:`LeafView` per (slot, leaf) cell, with absolute
        offsets and both the payload and the planned (aligned) byte
        sizes. The state arena and the residency views are built from
        this one spec, so they cannot disagree on where a leaf's bytes
        live."""
        views: list[LeafView] = []
        n_leaves = len(self.leaves)
        for slot in range(self.n_slots):
            base = slot * self.slot_stride
            for i, leaf in enumerate(self.leaves):
                nbytes = math.prod(leaf.shape) * dtype_itemsize(leaf.dtype)
                views.append(
                    LeafView(
                        tensor_id=slot * n_leaves + i,
                        slot=slot,
                        leaf_index=i,
                        path=leaf.path,
                        dtype=leaf.dtype,
                        offset=base + leaf.offset,
                        used_nbytes=nbytes // self.n_slots,
                        slot_nbytes=leaf.slot_nbytes,
                    )
                )
        return views

    def summary(self) -> str:
        return (
            f"state[{self.strategy}]: {self.total_size / 2**20:.3f} MiB "
            f"({self.n_slots} slots x {self.slot_stride / 2**20:.3f} MiB, "
            f"{len(self.leaves)} leaves, len {self.max_len})"
        )


def dtype_itemsize(name: str) -> int:
    """Bytes per element of a dtype name (numpy has no ``bfloat16``)."""
    return 2 if name == "bfloat16" else np.dtype(name).itemsize


def dtype_name(dtype: Any) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` — the name numpy/ml_dtypes
    give the same type on the reference side."""
    return str(dtype).removeprefix("torch.")


def iter_leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) over a nested dict/tuple/list, in the order and with
    the path strings of ``jax.tree_util.tree_flatten_with_path`` +
    ``keystr``: dict keys sorted, ``['key']`` for dict entries, ``[i]``
    for sequence entries."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaves(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from iter_leaves(x, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def state_records_from_cache(tree: Any, *, n_slots: int) -> list[StateRecord]:
    """Derive :class:`StateRecord`\\ s from a cache structure of tensors
    (any device, ``meta`` included — only shapes and dtypes are read)."""
    records = []
    for path, leaf in iter_leaves(tree):
        shape = tuple(int(d) for d in leaf.shape)
        records.append(
            StateRecord(
                path=path,
                shape=shape,
                dtype=dtype_name(leaf.dtype),
                nbytes=math.prod(shape) * leaf.element_size(),
            )
        )
    del n_slots  # divisibility is checked where the layout is built
    return records


def plan_state(
    records: Sequence[StateRecord],
    *,
    n_slots: int,
    max_len: int,
    alignment: int = DEFAULT_ALIGNMENT,
) -> StatePlan:
    """Lay out the cross-step state: per-slot shares packed
    size-descending (deterministic: ties break on path), each aligned, in
    ``n_slots`` symmetric regions. Objective as in §4 — total size of all
    shared objects — is ``n_slots * slot_stride`` by symmetry."""
    global STATE_PLAN_CALLS
    STATE_PLAN_CALLS += 1
    placed: list[StateLeaf] = []
    offset = 0
    for rec in sorted(records, key=lambda r: (-r.nbytes, r.path)):
        if rec.nbytes % n_slots:
            raise ValueError(
                f"state leaf {rec.path!r}: {rec.nbytes} B not divisible by "
                f"{n_slots} slots — every cross-step leaf must carry the "
                f"slot batch dimension"
            )
        slot_nbytes = align(rec.nbytes // n_slots, alignment)
        placed.append(
            StateLeaf(
                path=rec.path,
                shape=rec.shape,
                dtype=rec.dtype,
                slot_nbytes=slot_nbytes,
                offset=offset,
            )
        )
        offset += slot_nbytes
    stride = align(offset, alignment)
    return StatePlan(
        n_slots=n_slots,
        max_len=max_len,
        alignment=alignment,
        leaves=placed,
        slot_stride=stride,
        total_size=n_slots * stride,
    )


@dataclasses.dataclass
class PagedStatePlan(StatePlan):
    """Page-granular cross-step state layout (ROADMAP open item 2): the
    *logical* layout is exactly the symmetric :class:`StatePlan` —
    ``n_slots`` regions of ``slot_stride`` bytes, same leaves, same
    ``total_size`` — but physical storage is a pool of ``n_pages_pool``
    fixed ``page_size``-byte pages plus one reserved all-zero *null page*
    at physical index 0. A per-slot page table (``pages_per_slot`` int32
    entries, physical page indices; 0 = unmapped → null page) maps each
    logical page of the slot region onto the pool, so resident state
    scales with *live* tokens: a slot at cache length ``L`` only needs
    the pages intersecting its live byte spans (:meth:`pages_needed`).

    ``token_spans`` records, per leaf (aligned with ``leaves``), how the
    per-slot byte range decomposes along the token axis:
    ``(n_chunks, n_rows, row_nbytes)`` — rows ``>= L`` of every chunk are
    dead at length ``L`` — or ``None`` for leaves that are fully live at
    any length (length-independent SSM state, sliding-window caches).

    ``total_size`` stays the logical ``n_slots * slot_stride`` (it is the
    §4 objective the symmetric certifiers and arena layouts reason
    about); the device buffer a paged backend allocates is
    :attr:`phys_total_size`.
    """

    page_size: int = 0
    n_pages_pool: int = 0
    # physical byte offset of each pool page (page i+1 — the null page is
    # implicit at offset 0), as carved by the interval engine
    page_offsets: list[int] = dataclasses.field(default_factory=list)
    token_spans: list[tuple[int, int, int] | None] = dataclasses.field(
        default_factory=list
    )

    @property
    def pages_per_slot(self) -> int:
        return -(-self.slot_stride // self.page_size)

    @property
    def n_pages_total(self) -> int:
        return self.n_pages_pool + 1

    @property
    def phys_total_size(self) -> int:
        return self.n_pages_total * self.page_size

    def live_spans(self, length: int) -> list[tuple[int, int]]:
        """Byte spans within one slot region that are live at cache
        length ``length`` (leaf payloads only; alignment padding is dead
        on both the symmetric and the paged path)."""
        spans: list[tuple[int, int]] = []
        for leaf, span in zip(self.leaves, self.token_spans):
            used = (
                math.prod(leaf.shape) * dtype_itemsize(leaf.dtype)
                // self.n_slots
            )
            if span is None:
                spans.append((leaf.offset, leaf.offset + used))
                continue
            n_chunks, n_rows, row_nbytes = span
            live = min(max(length, 0), n_rows) * row_nbytes
            if live == 0:
                continue
            for k in range(n_chunks):
                base = leaf.offset + k * n_rows * row_nbytes
                spans.append((base, base + live))
        return spans

    def pages_needed(self, length: int) -> tuple[int, ...]:
        """Logical page indices (within ``[0, pages_per_slot)``) a slot
        must have mapped to serve a request at cache length ``length``."""
        page = self.page_size
        need: set[int] = set()
        for a, b in self.live_spans(length):
            need.update(range(a // page, (b - 1) // page + 1))
        return tuple(sorted(need))

    def live_bytes(self, length: int) -> int:
        """Physical pool bytes one slot holds at cache length ``length``."""
        return len(self.pages_needed(length)) * self.page_size

    def summary(self) -> str:
        return (
            f"state[{self.strategy}]: {self.total_size / 2**20:.3f} MiB "
            f"logical ({self.n_slots} slots x "
            f"{self.slot_stride / 2**20:.3f} MiB), pool "
            f"{self.n_pages_pool} x {self.page_size} B pages "
            f"({self.phys_total_size / 2**20:.3f} MiB physical, "
            f"{len(self.leaves)} leaves, len {self.max_len})"
        )


def detect_state_axes(
    init_cache, *, n_slots: int, max_len: int
) -> dict[str, tuple[int, int | None]]:
    """Shape-differencing probe for the paged planner: evaluate
    ``init_cache(n_slots, max_len, device="meta")`` (shape level — no
    memory is allocated) at the bucket shape, at an alternate cache
    length, and at an alternate slot count, and identify each leaf's
    slot-batch axis and token axis as the unique axis that tracks the
    varied parameter. Returns ``path -> (slot_axis, token_axis | None)``
    in full-shape axes, keyed by the ``keystr``-identical paths of
    :func:`iter_leaves`; ``None`` marks a leaf whose extent does not
    follow ``max_len`` (length-independent SSM state, sliding-window
    caches) — such leaves are conservatively treated as fully live by
    the paged plan."""

    def shapes(ns: int, ml: int) -> dict[str, tuple[int, ...]]:
        tree = init_cache(ns, ml, device="meta")
        return {
            path: tuple(int(d) for d in leaf.shape)
            for path, leaf in iter_leaves(tree)
        }

    alt_len = max_len + 8
    alt_slots = n_slots + 1
    base = shapes(n_slots, max_len)
    by_len = shapes(n_slots, alt_len)
    by_slots = shapes(alt_slots, max_len)
    axes: dict[str, tuple[int, int | None]] = {}
    for path, shape in base.items():
        s_shape = by_slots.get(path)
        l_shape = by_len.get(path)
        if (
            s_shape is None or l_shape is None
            or len(s_shape) != len(shape) or len(l_shape) != len(shape)
        ):
            raise ValueError(
                f"state leaf {path!r}: cache structure changes with the "
                f"bucket shape — cannot derive a paged layout"
            )
        slot_ax = [
            i for i, (a, b) in enumerate(zip(shape, s_shape)) if a != b
        ]
        if (
            len(slot_ax) != 1
            or shape[slot_ax[0]] != n_slots
            or s_shape[slot_ax[0]] != alt_slots
        ):
            raise ValueError(
                f"state leaf {path!r}: no unambiguous slot batch axis "
                f"({shape} vs {s_shape} at {alt_slots} slots)"
            )
        tok_ax = [
            i for i, (a, b) in enumerate(zip(shape, l_shape)) if a != b
        ]
        token: int | None = None
        if (
            len(tok_ax) == 1
            and shape[tok_ax[0]] == max_len
            and l_shape[tok_ax[0]] == alt_len
        ):
            token = tok_ax[0]
        axes[path] = (slot_ax[0], token)
    return axes


def plan_paged_state(
    records: Sequence[StateRecord],
    *,
    n_slots: int,
    max_len: int,
    page_size: int,
    page_pool: int | None = None,
    axes: dict[str, tuple[int, int | None]] | None = None,
    alignment: int = DEFAULT_ALIGNMENT,
) -> PagedStatePlan:
    """Lay out the cross-step state at page granularity: the symmetric
    per-slot leaf packing of :func:`plan_state` becomes the *logical*
    layout, the physical pool is carved into ``page_pool`` fixed-size
    pages (default ``n_slots * pages_per_slot`` — enough to map every
    slot fully, so the default pool can never refuse an admission the
    symmetric plan would accept) by the interval engine
    (:class:`~repro_torch.core.interval_set.BestFitArena`: every page is a
    whole-serving-lifetime record, so best-fit packs them end to end
    after the reserved null page at offset 0), and per-leaf token spans
    from ``axes`` (see :func:`detect_state_axes`) record which bytes are
    live at a given cache length."""
    if page_size <= 0:
        raise ValueError(f"page_size must be positive, got {page_size}")
    base = plan_state(
        records, n_slots=n_slots, max_len=max_len, alignment=alignment
    )
    token_spans: list[tuple[int, int, int] | None] = []
    for leaf in base.leaves:
        slot_ax, tok_ax = (axes or {}).get(leaf.path, (0, None))
        if tok_ax is None:
            token_spans.append(None)
            continue
        per_slot_shape = tuple(
            d for i, d in enumerate(leaf.shape) if i != slot_ax
        )
        tok = tok_ax - (1 if slot_ax < tok_ax else 0)
        n_chunks = math.prod(per_slot_shape[:tok]) if tok else 1
        n_rows = per_slot_shape[tok]
        row_nbytes = (
            math.prod(per_slot_shape[tok + 1:])
            * dtype_itemsize(leaf.dtype)
        )
        token_spans.append((int(n_chunks), int(n_rows), int(row_nbytes)))

    pages_per_slot = -(-base.slot_stride // page_size)
    n_pool = (
        page_pool if page_pool is not None else n_slots * pages_per_slot
    )
    if n_pool < 1:
        raise ValueError(
            f"page pool must hold at least one page, got {n_pool}"
        )
    arena = BestFitArena()
    # null page first: physical offset 0 is the reserved all-zero page
    arena.place(
        TensorUsageRecord(first_op=0, last_op=0, size=page_size, tensor_id=0)
    )
    page_offsets = [
        arena.place(
            TensorUsageRecord(
                first_op=0, last_op=0, size=page_size, tensor_id=i + 1
            )
        )
        for i in range(n_pool)
    ]
    phys_total = (n_pool + 1) * page_size
    seen: set[int] = {0}
    for i, off in enumerate(page_offsets):
        if off % page_size or off in seen or off + page_size > phys_total:
            raise ValueError(
                f"page carving produced an unusable offset {off} for pool "
                f"page {i} (page_size {page_size}, pool {n_pool})"
            )
        seen.add(off)
    return PagedStatePlan(
        n_slots=n_slots,
        max_len=max_len,
        alignment=alignment,
        leaves=base.leaves,
        slot_stride=base.slot_stride,
        total_size=base.total_size,
        strategy=PAGED_STATE_STRATEGY,
        page_size=page_size,
        n_pages_pool=n_pool,
        page_offsets=page_offsets,
        token_spans=token_spans,
    )


def state_plan_to_obj(sp: StatePlan) -> dict:
    obj = {
        "n_slots": sp.n_slots,
        "max_len": sp.max_len,
        "alignment": sp.alignment,
        "slot_stride": sp.slot_stride,
        "total_size": sp.total_size,
        "strategy": sp.strategy,
        "leaves": [
            [l.path, list(l.shape), l.dtype, l.slot_nbytes, l.offset]
            for l in sp.leaves
        ],
    }
    if isinstance(sp, PagedStatePlan):
        obj["page_size"] = sp.page_size
        obj["n_pages_pool"] = sp.n_pages_pool
        obj["page_offsets"] = list(sp.page_offsets)
        obj["token_spans"] = [
            list(s) if s is not None else None for s in sp.token_spans
        ]
    return obj


def state_plan_from_obj(obj: dict) -> StatePlan:
    leaves = [
        StateLeaf(
            path=p, shape=tuple(shape), dtype=dt, slot_nbytes=nb, offset=off
        )
        for p, shape, dt, nb, off in obj["leaves"]
    ]
    if "page_size" in obj:
        return PagedStatePlan(
            n_slots=obj["n_slots"],
            max_len=obj["max_len"],
            alignment=obj["alignment"],
            leaves=leaves,
            slot_stride=obj["slot_stride"],
            total_size=obj["total_size"],
            strategy=obj["strategy"],
            page_size=obj["page_size"],
            n_pages_pool=obj["n_pages_pool"],
            page_offsets=list(obj["page_offsets"]),
            token_spans=[
                tuple(s) if s is not None else None
                for s in obj["token_spans"]
            ],
        )
    return StatePlan(
        n_slots=obj["n_slots"],
        max_len=obj["max_len"],
        alignment=obj["alignment"],
        leaves=leaves,
        slot_stride=obj["slot_stride"],
        total_size=obj["total_size"],
        strategy=obj["strategy"],
    )


# ------------------------------------------------------------ spec + plan


@dataclasses.dataclass
class PlanSpec:
    """One planning request, covering both halves.

    Activation input is the ``graph`` (preferred — enables ``search``) or
    raw ``records``; the cross-step half is ``state_records`` (omit for an
    activation-only plan). ``n_slots``/``max_len`` are the bucket
    identity, and join the fingerprint."""

    graph: "Graph | None" = None
    records: Sequence[TensorUsageRecord] | None = None
    state_records: Sequence[StateRecord] | None = None
    # prefill half (optional): the full-sequence forward graph at
    # ``prefill_len`` tokens — long activation lifetimes, the regime where
    # the paper's strategies diverge most. Planned with the same strategy
    # portfolio as the decode half (no order/fusion search — the search
    # knobs target the decode graph); ``prefill_len`` joins the bucketed
    # fingerprint (None-canonicalized, so decode-only specs are unchanged)
    prefill_graph: "Graph | None" = None
    prefill_len: int | None = None
    # bucket identity
    n_slots: int | None = None
    max_len: int | None = None
    # serve-loop identity (joins the fingerprint): block size
    # + sampling knobs when the bucket targets the scan-block decode path,
    # page_size/page_pool when it targets the paged state backend;
    # None = the default single-wave greedy host loop
    serve_params: dict | None = None
    # paged state (None = symmetric max_len slot regions): fixed page size
    # in bytes, pool size in pages (None = n_slots * pages_per_slot), and
    # the per-leaf (slot_axis, token_axis) map from detect_state_axes
    page_size: int | None = None
    page_pool: int | None = None
    state_token_axes: dict | None = None
    # strategy / search knobs
    mode: str = "offsets"
    strategy: str = "auto"
    alignment: int = DEFAULT_ALIGNMENT
    search: bool = False
    search_iters: int = 300
    fusion_rounds: int = 40
    # plan-cache control
    cache: "plan_io.PlanCache | None" = None
    use_cache: bool = True
    graph_name: str = "records"


@dataclasses.dataclass
class SearchOutcome:
    """Search-path by-products that serving artifacts don't carry whole:
    the pre-search plan and the full order/fusion results."""

    greedy_plan: "MemoryPlan"
    order: "OrderSearchResult"
    fusion: "FusionSearchResult"


@dataclasses.dataclass
class UnifiedPlan:
    """Both halves of a serving bucket's memory plan under one fingerprint
    and one ``total_size``. ``activation`` may be None for a state-only
    spec (and vice versa)."""

    activation: "MemoryPlan | None"
    state: StatePlan | None
    fingerprint: str
    # searched-order / fusion provenance for the activation half (same
    # semantics as PlanBundle.order / .fusion_groups)
    order: list[int] | None = None
    fusion_groups: list[list[int]] | None = None
    provenance: dict = dataclasses.field(default_factory=dict)
    # search by-products; never serialized (bundles keep provenance only)
    search: SearchOutcome | None = None
    # planned prefill activation arena (PlanSpec.prefill_graph) — never
    # summed into total_size: prefill and decode are temporally disjoint,
    # so the prefill arena aliases the decode arena's address space
    prefill: "MemoryPlan | None" = None

    @property
    def total_size(self) -> int:
        total = 0
        if self.activation is not None:
            total += self.activation.total_size
        if self.state is not None:
            total += self.state.total_size
        return total

    @property
    def peak_activation_size(self) -> int:
        """Peak transient-arena demand across both phases (decode step vs
        full-sequence prefill, whichever arena is larger)."""
        act = self.activation.total_size if self.activation else 0
        pre = self.prefill.total_size if self.prefill else 0
        return max(act, pre)

    def arena_layouts(self) -> "tuple[ArenaLayout | None, ArenaLayout | None]":
        """Materialization view: (activation layout, state layout) — both
        arenas from this one object."""
        from repro_torch.runtime.arena import ArenaLayout

        return (
            ArenaLayout.from_plan(self.activation)
            if self.activation is not None
            else None,
            ArenaLayout.from_state_plan(self.state)
            if self.state is not None
            else None,
        )

    def summary(self) -> str:
        lines = []
        if self.activation is not None:
            lines.append(self.activation.summary())
        if self.state is not None:
            lines.append(self.state.summary())
        if self.prefill is not None:
            lines.append(f"prefill {self.prefill.summary()}")
        lines.append(
            f"unified footprint: {self.total_size / 2**20:.3f} MiB "
            f"[{self.fingerprint[:12]}]"
        )
        return "\n".join(lines)


def _spec_fingerprint(spec: PlanSpec, records, state_records) -> str:
    """Content fingerprint of a spec: everything the unified output
    depends on."""
    payload = {
        "planner_revision": plan_io.PLANNER_REVISION,
        "mode": spec.mode,
        "strategy": spec.strategy,
        "search": spec.search,
        "records": plan_io.canonical_records(records) if records else None,
        "state": [
            [r.path, list(r.shape), r.dtype, r.nbytes]
            for r in (state_records or [])
        ],
        "n_slots": spec.n_slots,
        "max_len": spec.max_len,
    }
    if spec.serve_params:
        payload["serve_params"] = spec.serve_params
    if spec.page_size:
        payload["page_size"] = spec.page_size
        payload["page_pool"] = spec.page_pool
    if spec.prefill_len:
        payload["prefill_len"] = spec.prefill_len
    text = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(text.encode()).hexdigest()


def plan(spec: PlanSpec) -> UnifiedPlan:
    """THE planning entry point: activation half (with optional
    order/fusion search) + cross-step state half, one fingerprint, one
    total. Every other planner API is a wrapper over this."""
    from repro_torch.core import planner

    records = None
    if spec.records is not None:
        records = list(spec.records)
    elif spec.graph is not None:
        records = spec.graph.usage_records(spec.alignment)
    if records is None and spec.state_records is None:
        raise ValueError(
            "empty PlanSpec: provide an activation graph/records, "
            "state_records, or both"
        )

    activation: "MemoryPlan | None" = None
    order: list[int] | None = None
    groups: list[list[int]] | None = None
    outcome: SearchOutcome | None = None
    provenance: dict = {}
    if records is not None:
        graph_name = spec.graph.name if spec.graph is not None else spec.graph_name
        activation = planner._plan_records_impl(
            records,
            mode=spec.mode,
            strategy=spec.strategy,
            graph_name=graph_name,
            cache=spec.cache,
            use_cache=spec.use_cache,
        )
        if spec.search:
            if spec.graph is None:
                raise ValueError("search=True needs a graph, not raw records")
            from repro_torch.core.fusion_search import fusion_search
            from repro_torch.core.order_search import search_order

            search_cache = (
                spec.cache if spec.cache is not None else plan_io.PlanCache()
            )
            order_res = search_order(
                spec.graph, iters=spec.search_iters, seed=0,
                strategy=spec.strategy, cache=search_cache,
            )
            fusion_res = fusion_search(
                spec.graph, strategy=spec.strategy,
                max_rounds=spec.fusion_rounds, cache=search_cache,
            )
            outcome = SearchOutcome(
                greedy_plan=activation, order=order_res, fusion=fusion_res
            )
            # both searches honor the never-worse contract; take the smaller
            if fusion_res.plan.total_size < activation.total_size and (
                fusion_res.plan.total_size <= order_res.plan.total_size
            ):
                activation = fusion_res.plan
                groups = [list(g) for g in fusion_res.groups]
            elif order_res.plan.total_size < activation.total_size:
                activation = order_res.plan
                order = list(order_res.order)
            provenance["search_stats"] = {
                **order_res.provenance(),
                **fusion_res.provenance(),
                "order_iters": spec.search_iters,
                "fusion_rounds": spec.fusion_rounds,
            }
        provenance.update(
            {
                "strategy_requested": spec.strategy,
                "search": spec.search,
                "records": len(records),
                "greedy_total_bytes": (
                    outcome.greedy_plan.total_size
                    if outcome is not None
                    else activation.total_size
                ),
                "searched_total_bytes": (
                    min(
                        outcome.order.plan.total_size,
                        outcome.fusion.plan.total_size,
                    )
                    if outcome is not None
                    else None
                ),
            }
        )
        if spec.graph is not None:
            provenance["graph_ops"] = len(spec.graph.ops)

    prefill: "MemoryPlan | None" = None
    if spec.prefill_graph is not None:
        prefill = planner._plan_records_impl(
            spec.prefill_graph.usage_records(spec.alignment),
            mode=spec.mode,
            strategy=spec.strategy,
            graph_name=spec.prefill_graph.name,
            cache=spec.cache,
            use_cache=spec.use_cache,
        )
        provenance["prefill_total_bytes"] = prefill.total_size
        provenance["prefill_records"] = len(prefill.records)
        if spec.prefill_len:
            provenance["prefill_len"] = spec.prefill_len

    state: StatePlan | None = None
    if spec.state_records is not None:
        if spec.n_slots is None or spec.max_len is None:
            raise ValueError("state_records need n_slots and max_len")
        if spec.page_size:
            state = plan_paged_state(
                spec.state_records,
                n_slots=spec.n_slots,
                max_len=spec.max_len,
                page_size=spec.page_size,
                page_pool=spec.page_pool,
                axes=spec.state_token_axes,
                alignment=spec.alignment,
            )
            provenance["page_size"] = state.page_size
            provenance["page_pool"] = state.n_pages_pool
        else:
            state = plan_state(
                spec.state_records,
                n_slots=spec.n_slots,
                max_len=spec.max_len,
                alignment=spec.alignment,
            )
        provenance["state_total_bytes"] = state.total_size
        provenance["state_leaves"] = len(state.leaves)

    fingerprint = _spec_fingerprint(spec, records, spec.state_records)

    return UnifiedPlan(
        activation=activation,
        state=state,
        fingerprint=fingerprint,
        order=order,
        fusion_groups=groups,
        provenance=provenance,
        search=outcome,
        prefill=prefill,
    )


