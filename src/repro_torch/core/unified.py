"""Cross-step state planning (copy of the state half of the reference's
``core/unified.py``).

The per-slot KV caches are laid out as a Shared-Objects instance above
the kernel level (paper §4 where slots are the shared objects and
requests are the tensors): :func:`plan_state` packs every cache leaf's
per-slot share into ``n_slots`` symmetric slot regions, and
:meth:`StatePlan.leaf_view_spec` addresses every (slot, leaf) cell. The
layout code is the reference's, so a port ``StatePlan`` equals the JAX
one field for field.

:func:`state_records_from_cache` is the twin of the reference's
``state_records_from_pytree``: it walks the port's cache structure (a
nested dict/tuple of tensors) and names each leaf with the path string
``jax.tree_util.keystr`` would give it, e.g. ``"['period'][0]['attn'][0]"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Sequence

import numpy as np

from repro_torch.core.records import DEFAULT_ALIGNMENT, align

# Instrumentation: total state-plan constructions this process.
STATE_PLAN_CALLS = 0

STATE_STRATEGY = "slots_as_shared_objects"


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
