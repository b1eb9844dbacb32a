"""Flat memory arena materializing an Offset Calculation plan (paper §5).

Port of the reference's ``runtime/arena.py``: one ``torch.uint8`` tensor
of ``total_size`` bytes; every tensor of a plan is a zero-copy view at
its planned offset — allocate once, reuse across the whole inference and
across inferences.

* :class:`ArenaLayout` — offsets + per-tensor slot sizes + total, from an
  activation :class:`~repro_torch.core.planner.MemoryPlan` or from the
  cross-step :class:`~repro_torch.core.unified.StatePlan`;
* :class:`DeviceArena` — the layout's bounds-checked view contract over
  a buffer the caller holds (the engine's state residency);
* :class:`Arena` — one owned buffer with the same view contract.

Unlike the reference's jax arena, views here alias the buffer: writing
through a view writes the arena's bytes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Mapping

import torch

from repro_torch.runtime.device import resolve_device

if TYPE_CHECKING:
    from repro_torch.core.planner import MemoryPlan
    from repro_torch.core.unified import StatePlan


@dataclasses.dataclass(frozen=True)
class ArenaLayout:
    """Everything an arena needs: where each tensor lives and how big the
    buffer is. ``sizes`` are the *planned slot* sizes (alignment-rounded)
    used for bounds enforcement."""

    total_size: int
    offsets: Mapping[int, int]  # tensor_id -> byte offset
    sizes: Mapping[int, int]  # tensor_id -> planned slot bytes

    @staticmethod
    def from_plan(plan: "MemoryPlan") -> "ArenaLayout":
        return ArenaLayout(
            total_size=plan.total_size,
            offsets=dict(plan.offsets),
            sizes={r.tensor_id: r.size for r in plan.records},
        )

    @staticmethod
    def from_state_plan(state: "StatePlan") -> "ArenaLayout":
        """Cross-step state arena: one dense tensor id per (slot, leaf)
        pair, addressed through :meth:`StatePlan.leaf_view_spec`. State
        regions are all live at once, so they must also be disjoint."""
        offsets: dict[int, int] = {}
        sizes: dict[int, int] = {}
        for view in state.leaf_view_spec():
            offsets[view.tensor_id] = view.offset
            sizes[view.tensor_id] = view.slot_nbytes
        layout = ArenaLayout(
            total_size=state.total_size, offsets=offsets, sizes=sizes
        )
        layout.validate()
        layout.validate_disjoint()
        return layout

    def validate(self) -> None:
        """Every planned slot must lie inside the buffer."""
        for tid, off in self.offsets.items():
            size = self.sizes.get(tid, 0)
            if off < 0 or off + size > self.total_size:
                raise ValueError(
                    f"tensor {tid}: slot [{off}, {off + size}) outside "
                    f"arena of {self.total_size} B"
                )

    def validate_disjoint(self) -> None:
        """No two planned slots may share bytes (state layouts only:
        activation layouts alias on purpose)."""
        spans = sorted(
            (off, off + self.sizes.get(tid, 0), tid)
            for tid, off in self.offsets.items()
        )
        for (s1, e1, t1), (s2, e2, t2) in zip(spans, spans[1:]):
            if s2 < e1:
                raise ValueError(
                    f"state regions overlap: tensor {t1} [{s1}, {e1}) and "
                    f"tensor {t2} [{s2}, {e2}) share bytes"
                )


class DeviceArena:
    """The layout's bounds-checked view contract over a flat ``uint8``
    buffer the caller passes in."""

    def __init__(self, layout: ArenaLayout):
        layout.validate()
        self.layout = layout
        self._sizes = layout.sizes

    @property
    def nbytes(self) -> int:
        return max(self.layout.total_size, 1)

    def allocate(self, device) -> torch.Tensor:
        """A fresh zeroed buffer of the arena's full size."""
        return torch.zeros((self.nbytes,), dtype=torch.uint8, device=device)

    def check(self, tensor_id: int, nbytes: int) -> int:
        """The tensor's offset, after checking that ``nbytes`` fit its
        planned slot and the arena (an oversized view would silently alias
        the NEXT tensor's planned slot)."""
        off = self.layout.offsets[tensor_id]
        if nbytes > self._sizes[tensor_id]:
            raise ValueError(
                f"tensor {tensor_id}: view of {nbytes} B exceeds planned "
                f"{self._sizes[tensor_id]} B"
            )
        if off + nbytes > self.layout.total_size:
            raise ValueError(
                f"tensor {tensor_id}: view [{off}, {off + nbytes}) exceeds "
                f"arena of {self.layout.total_size} B"
            )
        return off

    def view(self, buf: torch.Tensor, tensor_id: int, shape, dtype) -> torch.Tensor:
        """The tensor's planned bytes in ``buf`` as a ``shape``/``dtype``
        view (no copy)."""
        nbytes = math.prod(shape) * dtype.itemsize
        off = self.check(tensor_id, nbytes)
        return buf[off : off + nbytes].view(dtype).view(tuple(shape))

    def strided_view(self, buf: torch.Tensor, tensor_id: int, shape, stride,
                     dtype) -> torch.Tensor:
        """The tensor's planned bytes in ``buf`` as a view of ``shape``
        with element strides ``stride`` (a traced value's layout, dense
        or permuted). The bytes it spans from its first element to its
        last must fit the planned slot, or this raises."""
        shape, stride = tuple(int(n) for n in shape), tuple(int(s) for s in stride)
        if len(shape) != len(stride) or any(s < 0 for s in stride):
            raise ValueError(f"tensor {tensor_id}: bad strides {stride} for {shape}")
        span = 0 if 0 in shape else 1 + sum((n - 1) * s for n, s in zip(shape, stride))
        nbytes = span * dtype.itemsize
        off = self.check(tensor_id, nbytes)
        return buf[off : off + nbytes].view(dtype).as_strided(shape, stride)

    def store(self, buf: torch.Tensor, tensor_id: int, value: torch.Tensor) -> torch.Tensor:
        """Copy ``value`` into its planned slot; returns the view."""
        dst = self.view(buf, tensor_id, value.shape, value.dtype)
        dst.copy_(value)
        return dst


class Arena:
    """One owned buffer on ``device`` with the :class:`DeviceArena` view
    contract (the activation arena the engine materializes). ``device``
    None is the card (``resolve_device``: it raises without one)."""

    def __init__(self, layout: "ArenaLayout | MemoryPlan", device=None):
        if not isinstance(layout, ArenaLayout):
            layout = ArenaLayout.from_plan(layout)
        self._arena = DeviceArena(layout)
        self.layout = layout
        self.buf = self._arena.allocate(resolve_device(device))

    @property
    def nbytes(self) -> int:
        return self.buf.numel()

    def view(self, tensor_id: int, shape, dtype) -> torch.Tensor:
        return self._arena.view(self.buf, tensor_id, shape, dtype)

    def strided_view(self, tensor_id: int, shape, stride, dtype) -> torch.Tensor:
        return self._arena.strided_view(self.buf, tensor_id, shape, stride, dtype)

    def store(self, tensor_id: int, value: torch.Tensor) -> torch.Tensor:
        return self._arena.store(self.buf, tensor_id, value)
