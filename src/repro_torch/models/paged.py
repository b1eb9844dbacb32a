"""A paged cache leaf as the decode step sees it (ROADMAP A10).

A leaf of a paged cache is an address, not a tensor: the engine's pool
of pages viewed as the leaf dtype, the page table (n_slots,
pages_per_slot) int32 (0 = the all-zero null page), and where the leaf
lies in a slot region. The decode step writes its new K/V rows, global
or ring, through the table (:func:`kv_rows`) and reads the cache with
``repro_torch::flash_decode_paged``, or, in the plain cores, through
:meth:`PagedLeaf.gather`. A Mamba2 layer reads its conv window and SSM
state with :meth:`PagedLeaf.gather` and writes them back whole with
:meth:`PagedLeaf.put`, one layer's runs at a time. The pool, the table
and the page bookkeeping belong to the serving backend
(``runtime/paging.py``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.kernels.ref import paged_index


@dataclasses.dataclass(frozen=True)
class PagedLeaf:
    """One cache leaf (or one layer of a stacked leaf): the pool ``buf``
    viewed as the leaf dtype, the device ``table`` (n_slots,
    pages_per_slot) int32, and where the leaf lies in a slot region, in
    elements: ``offset``, the per-slot ``shape`` and its ``strides``,
    which are C-ordered (a stacked leaf's first axis is its layers), so
    the leaf is one run of the slot region. ``page_elems`` is the page
    size in elements."""

    buf: torch.Tensor
    table: torch.Tensor
    offset: int
    shape: tuple[int, ...]
    strides: tuple[int, ...]
    page_elems: int

    def __post_init__(self):
        c_order = tuple(math.prod(self.shape[i + 1:]) for i in range(len(self.shape)))
        if tuple(self.strides) != c_order:
            raise ValueError(f"a paged leaf is C-ordered in its slot region: shape "
                             f"{self.shape}, strides {self.strides}")

    def __getitem__(self, i: int) -> "PagedLeaf":
        """Layer ``i`` of a leaf stacked over the periods."""
        return dataclasses.replace(self, offset=self.offset + i * self.strides[0],
                                   shape=self.shape[1:], strides=self.strides[1:])

    def _runs(self) -> list[tuple[int, int, int, int]]:
        """The leaf's page runs in a slot region: ``(p0, p1, c0, c1)``,
        logical pages ``[p0, p1)`` each holding the leaf's elements at
        ``[c0, c1)`` of the page. The first and last pages hold the leaf
        in part (a neighbouring leaf, or the next layer of a stacked one,
        may hold the rest), the pages between them whole."""
        pe = self.page_elems
        a = self.offset
        b = a + math.prod(self.shape)
        first, last = a // pe, (b - 1) // pe
        runs = [(first, first + 1, a - first * pe, min(b - first * pe, pe))]
        if last > first + 1:
            runs.append((first + 1, last, 0, pe))
        if last > first:
            runs.append((last, last + 1, 0, b - last * pe))
        return runs

    def gather(self) -> torch.Tensor:
        """The leaf gathered through the table, ``(B, *shape)``: every
        slot's pages of the leaf's runs in one index, then the leaf's
        elements out of them. Unmapped pages read as zeros."""
        pe, B = self.page_elems, self.table.shape[0]
        runs = self._runs()
        p0, p1, c0 = runs[0][0], runs[-1][1], runs[0][2]
        pages = self.buf.view(-1, pe)[self.table[:, p0:p1].long()]
        run = pages.reshape(B, -1)[:, c0:c0 + math.prod(self.shape)]
        return run.reshape((B,) + self.shape)

    def put(self, values: torch.Tensor) -> None:
        """The inverse of :meth:`gather`: ``values`` ``(B, *shape)`` of the
        leaf dtype, written through the table into every slot's runs. The
        pages between the first and the last are written whole; a partial
        page is read, the leaf's elements ``[c0, c1)`` replaced, and
        written back whole, so a neighbour's bytes on it stay as they
        were. The transient is those partial pages. An inactive slot's
        rows must be what :meth:`gather` read: a page that resolves to the
        null page then gets back the zeros it holds (the duplicate indices
        there all carry zeros)."""
        pe, B = self.page_elems, self.table.shape[0]
        pool = self.buf.view(-1, pe)
        flat = values.reshape(B, -1)
        i = 0
        for p0, p1, c0, c1 in self._runs():
            n = (p1 - p0) * (c1 - c0)
            part = flat[:, i:i + n].reshape(B, p1 - p0, c1 - c0)
            i += n
            idx = self.table[:, p0:p1].long()
            if c1 - c0 < pe:
                old = pool[idx]
                part = torch.cat([old[..., :c0], part, old[..., c1:]], dim=-1)
            pool[idx] = part

    def wipe(self, rows: np.ndarray) -> None:
        """``transformer.reset_slots`` through the page table, for the
        slots whose HOST table rows ``rows`` (k, pages_per_slot) are
        given: every element of the leaf that they map is multiplied by 0
        (as the symmetric backend's ``mul_``, so a negative value leaves
        -0.0), stale mappings included. Only those slots' mapped pages
        are gathered, the first and last pages of the run in part, so the
        transient is at most the pages they map, never the logical
        state. A physical page is mapped by one table entry at most, so
        no page is indexed twice."""
        pool = self.buf.view(-1, self.page_elems)
        for p0, p1, c0, c1 in self._runs():
            pages = rows[:, p0:p1]
            pages = pages[pages != 0].astype(np.int64)
            if not pages.size:
                continue
            idx = torch.from_numpy(pages)
            if pool.is_cuda:  # queued without waiting, as the engine's inputs
                idx = idx.pin_memory()
            idx = idx.to(pool.device, non_blocking=True)
            pool[idx, c0:c1] = pool[idx, c0:c1].mul_(0)


def kv_rows(k: PagedLeaf, v: PagedLeaf, positions: torch.Tensor) -> torch.Tensor:
    """Physical element indices of each slot's K and V rows at
    ``positions[b]``: ``(B, 2, row)`` int64, ``row`` the elements of one
    position. A row is one run of logical elements, ``offset + p·row +
    [0, row)``, so both leaves' rows are one ``paged_index`` over per-slot
    offsets. No explicit dtype conversion: int32 operands reach int64 by
    promotion (a conversion in the traced step costs the executor a copy,
    B1.2), and ``positions · row`` stays in int32, below 2³¹ for any cache
    of fewer than 2³¹ elements a layer."""
    T, row = k.shape[0], math.prod(k.shape[1:])
    if k.shape != v.shape or k.table is not v.table:
        raise ValueError("K and V must be leaves of one shape and table")
    if T * row >= 2**31:
        raise ValueError(f"a paged layer of {T} x {row} elements passes int32")
    leaf = torch.arange(2, device=k.table.device) * (v.offset - k.offset) + k.offset
    offsets = (positions * row)[:, None] + leaf  # (B, 2), int64
    return paged_index(k.table, offsets, (1,), (row,), k.page_elems)
