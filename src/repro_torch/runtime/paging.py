"""Paged state: the engine's cross-step state in a pool of fixed pages,
addressed through per-slot page tables (ROADMAP A10).

Port of the reference's ``runtime/paging.py``. The *logical* layout is
the symmetric :class:`~repro_torch.core.unified.StatePlan`'s: the same
leaves at the same offsets inside a slot region of ``slot_stride``
bytes. The physical storage is a :class:`~repro_torch.core.unified.PagedStatePlan`
pool of ``n_pages_pool`` pages plus the all-zero null page at physical
index 0, and row b of the page table maps slot b's region page by page
(0 = unmapped, read as zeros through the null page). A slot holds only
the pages its request's cache length touches, so live state follows
live tokens instead of ``n_slots * slot_stride``.

* :class:`PagedStateResidency` binds the cache structure to the plan
  with the reference's checks, and gives each leaf, of any kind and
  dtype (K/V caches, global, ring or the shared block's; Mamba2 conv
  windows and SSM states), a page address (``models/paged.PagedLeaf``:
  its element offset in a slot region, its strides and the page size in
  elements). The decode step's K/V write (``models/attention.py``) and
  ``repro_torch::flash_decode_paged`` read that address and the table,
  and a Mamba2 layer gathers and puts its own two runs
  (``models/ssm.py``); nothing on the served step builds a whole-region
  view. :meth:`PagedStateResidency.gather` is the reference's ``unpack``
  (every leaf gathered through the table), for inspection, the tests
  and the plain cores only.
* :class:`PagedResidentState` is the serving backend: the
  :class:`~repro_torch.runtime.residency.ResidentState` steps (captured
  CUDA graphs on the card) over the pool buffer and ONE persistent int32
  device table, plus the reference's page bookkeeping: allocate on
  admit, free on retire, a page log for
  ``shared_objects.from_page_log``.

The reference rebuilds its device table on every mapping change and
runs a whole-region gather and scatter around every decode wave
(``unpack``/``pack``). Here the device table is written in place from
the host table at admission only and is never reallocated, so captured
graphs keep reading it; the step writes each new K/V row through it and
the kernel reads through it.

**Byte identity with the symmetric backend** (the reference's
discipline, kept as it is): retirement frees a slot's pages but leaves
its table row (lazy invalidation), so a retired slot's stale bytes stay
readable as the symmetric backend's do; re-admission takes the slot's
own stale pages first, then never-mapped ones, and steals another
retired slot's stale page last, clearing that slot's entry. Reset at
admission zeroes every page the slot still maps, stale ones included,
as the symmetric backend wipes the whole region; the host table names
those pages, so the wipe touches them and no others.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.unified import PagedStatePlan
from repro_torch.models.paged import PagedLeaf
from repro_torch.runtime.residency import (ResidentState, StateResidency, _rebuild,
                                          _slot_axis)


class PagedOutOfPagesError(RuntimeError):
    """Admission would exceed the page pool. Carries the numbers a
    caller needs to decide (wait for retirements vs reject): pages the
    request needs, pages currently free, pages live across active slots,
    and the bucket's total pool size."""

    def __init__(self, *, pages_needed: int, pages_free: int, pages_live: int,
                 pages_total: int):
        self.pages_needed = pages_needed
        self.pages_free = pages_free
        self.pages_live = pages_live
        self.pages_total = pages_total
        super().__init__(
            f"paged admission refused: request needs {pages_needed} "
            f"page(s) but only {pages_free} of the bucket's {pages_total} "
            f"pool pages are free ({pages_live} live across active slots)"
        )


class PagedStateResidency(StateResidency):
    """The :class:`~repro_torch.runtime.residency.StateResidency` binding
    with page-table addressing. The logical layout is the symmetric
    plan's, so the base class's checks (paths, dtypes, per-slot bytes,
    the slot stride) hold as they are; on top of them the table must
    cover the slot region, the pool's pages must tile physical pages
    ``1..n_pages_pool``, and the page size must be whole elements of
    every leaf dtype."""

    def __init__(self, state_plan: PagedStatePlan, template: Any, *, n_slots: int,
                 layout=None):
        if not isinstance(state_plan, PagedStatePlan):
            raise TypeError(
                f"PagedStateResidency needs a PagedStatePlan, got "
                f"{type(state_plan).__name__}"
            )
        super().__init__(state_plan, template, n_slots=n_slots, layout=layout)
        self.paged_plan = plan = state_plan
        if plan.slot_stride > plan.pages_per_slot * plan.page_size:
            raise ValueError(
                "page table does not cover the slot region: "
                f"{plan.pages_per_slot} x {plan.page_size} B "
                f"< stride {plan.slot_stride} B"
            )
        phys = sorted(o // plan.page_size for o in plan.page_offsets)
        if phys != list(range(1, plan.n_pages_pool + 1)):
            raise ValueError("paged plan's page offsets do not tile the physical pool")
        # path -> (dtype, offset, per-slot shape, strides), in elements of
        # the leaf dtype, inside one slot region
        self.addresses: dict[str, tuple] = {}
        for path, shape, strides, offset, dt in self._bindings:
            if plan.page_size % dt.itemsize:
                raise ValueError(
                    f"state leaf {path!r}: page size {plan.page_size} B is not "
                    f"whole {dt} elements"
                )
            axis = _slot_axis(path)
            self.addresses[path] = (
                dt, offset, shape[:axis] + shape[axis + 1:],
                strides[:axis] + strides[axis + 1:],
            )

    @property
    def phys_total_size(self) -> int:
        return self.paged_plan.phys_total_size

    def init_buffer(self, device) -> torch.Tensor:
        """A fresh zeroed pool: the null page and every pool page."""
        return torch.zeros((self.phys_total_size,), dtype=torch.uint8, device=device)

    def leaves(self, buf: torch.Tensor, table: torch.Tensor) -> dict[str, PagedLeaf]:
        """path -> the leaf's :class:`~repro_torch.models.paged.PagedLeaf`
        (one view of ``buf`` per dtype, shared by the leaves of that
        dtype)."""
        views: dict[torch.dtype, torch.Tensor] = {}
        leaves = {}
        for path, (dt, offset, shape, strides) in self.addresses.items():
            if dt not in views:
                views[dt] = buf.view(dt)
            leaves[path] = PagedLeaf(views[dt], table, offset, shape, strides,
                                     self.paged_plan.page_size // dt.itemsize)
        return leaves

    def bind(self, buf: torch.Tensor, table: torch.Tensor) -> Any:
        """The cache structure with a :class:`PagedLeaf` per leaf."""
        return _rebuild(self.template, self.leaves(buf, table))

    def gather(self, buf: torch.Tensor, table: torch.Tensor) -> Any:
        """The cache structure gathered through the table (the reference's
        ``unpack``), each leaf on its slot axis. Unmapped pages read as
        zeros."""
        return _rebuild(self.template, {
            path: leaf.gather().movedim(0, _slot_axis(path))
            for path, leaf in self.leaves(buf, table).items()})

    def wipe(self, buf: torch.Tensor, table: torch.Tensor, rows: np.ndarray) -> None:
        """Zero, through the table, every page that the host table ``rows``
        of the slots being reset map (:meth:`PagedLeaf.wipe`)."""
        for leaf in self.leaves(buf, table).values():
            leaf.wipe(rows)


class PagedResidentState(ResidentState):
    """Serving backend: the pool buffer and the device page table are the
    step's state (its ``inputs``), read and written by every step, and
    the host keeps the authoritative table and the page bookkeeping.

    Same steps as :class:`~repro_torch.runtime.residency.ResidentState`
    (the engine is oblivious to the indirection), plus the page
    lifecycle the engine's admission drives: :meth:`allocate_slot`
    before a slot is reset and prefilled, :meth:`free_slot` when it
    retires."""

    def __init__(self, model, residency: PagedStateResidency, device):
        self.binding = residency
        self.plan = plan = residency.paged_plan
        n = residency.n_slots
        # the host-authoritative table (0 = null page) and its device twin,
        # written in place at admission only: captured graphs hold its
        # address
        self._table = np.zeros((n, plan.pages_per_slot), np.int32)
        self.table = torch.zeros((n, plan.pages_per_slot), dtype=torch.int32,
                                 device=device)
        super().__init__(model, residency, device)
        # free pool as physical page indices (ascending: a deterministic
        # assignment order), page -> (slot, logical index) for EVERY mapped
        # page (live or stale), and the live set: pages of active slots
        self._free: list[int] = sorted(o // plan.page_size for o in plan.page_offsets)
        self._owner: dict[int, tuple[int, int]] = {}
        self._live: set[int] = set()
        self._page_admit: dict[int, int] = {}  # page -> admitted wave
        self._slot_rid: dict[int, int] = {}
        # page occupancy intervals, the page-granular twin of the engine's
        # slot_log: (page, admitted_wave, finished_wave, rid)
        self.page_log: list[tuple[int, int, int, int]] = []
        self.pages_live_peak = 0

    def _inputs(self, residency) -> dict:
        return {"buf": self.buf, "table": self.table}

    @property
    def caches(self) -> Any:
        """The cache structure gathered through the table (inspection only;
        the served step never builds it)."""
        return self.binding.gather(self.buf, self.table)

    # ------------------------------------------------- page lifecycle
    @property
    def pages_total(self) -> int:
        return self.plan.n_pages_pool

    @property
    def pages_live(self) -> int:
        return len(self._live)

    def slot_pages(self, slot: int) -> list[int]:
        """The physical pages ``slot`` holds LIVE (mapped and counted
        against the pool; stale mappings of a retired slot excluded)."""
        return sorted(int(p) for p in self._table[slot] if p and int(p) in self._live)

    def allocate_slot(self, slot: int, needed_len: int, *, rid: int, wave: int) -> int:
        """Map the pages ``slot`` needs to serve a request whose cache
        never grows past ``needed_len`` rows. Returns the number of pages
        now live for the slot; raises :class:`PagedOutOfPagesError`,
        changing NOTHING, when the free pool cannot cover the need.

        Assignment order (the reference's): the slot's own stale pages
        first, never-mapped free pages next, stolen stale pages of other
        retired slots last, each group in ascending physical order."""
        need = self.plan.pages_needed(needed_len)
        free_set = set(self._free)
        assigned: dict[int, int] = {}
        for j in need:
            p = int(self._table[slot, j])
            if p and p in free_set:  # (1) stale-self: still mapped here
                assigned[j] = p
                free_set.discard(p)
        remaining = [j for j in need if j not in assigned]
        avail = sorted(free_set)
        pool = ([p for p in avail if p not in self._owner]
                + [p for p in avail if p in self._owner])
        if len(remaining) > len(pool):
            raise PagedOutOfPagesError(
                pages_needed=len(need), pages_free=len(self._free),
                pages_live=len(self._live), pages_total=self.plan.n_pages_pool,
            )
        dirty = False
        for j, p in zip(remaining, pool):
            old = self._owner.get(p)
            if old is not None:  # (3) steal: clear the stale owner's entry
                self._table[old[0], old[1]] = 0
            self._table[slot, j] = p
            self._owner[p] = (slot, j)
            assigned[j] = p
            dirty = True
        taken = set(assigned.values())
        self._free = sorted(set(self._free) - taken)
        for p in taken:
            self._live.add(p)
            self._page_admit[p] = wave
        self._slot_rid[slot] = rid
        self.pages_live_peak = max(self.pages_live_peak, len(self._live))
        if dirty:
            self._put(self.table, self._table)
        return len(taken)

    def free_slot(self, slot: int, wave: int) -> list[int]:
        """Return a retired slot's live pages to the free pool and log
        their occupancy intervals. The table row is NOT cleared (lazy
        invalidation), so the device table needs no write and the retired
        slot's stale bytes stay readable, as the symmetric backend's."""
        released = self.slot_pages(slot)
        rid = self._slot_rid.get(slot, -1)
        for p in released:
            self._live.discard(p)
            self.page_log.append((p, self._page_admit.pop(p), wave, rid))
        self._free = sorted(set(self._free) | set(released))
        return released

    # ------------------------------------------------------------ steps
    def reset(self, keep) -> None:
        """Zero every page the slots where ``keep`` is False still map,
        stale ones included (``transformer.reset_slots`` on the paged
        leaves). The host table says which pages those are, so only they
        are touched."""
        rows = self._table[~np.asarray(keep, dtype=bool)]
        self.binding.wipe(self.buf, self.table, rows)

    @property
    def live_bytes(self) -> int:
        """Pool bytes holding live state, ``pages_live * page_size``."""
        return len(self._live) * self.plan.page_size

    @property
    def allocated_bytes(self) -> int:
        """The physical buffer: the null page and the whole pool."""
        return self.buf.numel() * self.buf.element_size()
