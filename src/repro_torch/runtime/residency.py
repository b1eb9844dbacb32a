"""Plan-backed state residency: the engine's cross-step state in ONE
device buffer, laid out by the :class:`~repro_torch.core.unified.StatePlan`.

Port of the reference's ``runtime/residency.py``:

* :class:`StateResidency` binds a cache structure to a StatePlan's
  leaf-view spec and validates the binding completely (path sets, dtypes,
  per-slot byte sizes, the slot axis extent, the slot stride), so a stale
  or foreign plan fails at construction instead of corrupting state;
* :class:`ResidentState` is the serving backend built on it.

Each cache leaf is a ZERO-COPY strided view into the one ``uint8``
buffer: the buffer reinterpreted as the leaf dtype, then ``as_strided``
at the plan's offsets, with the slot axis striding by the plan's slot
stride. The decode step writes the new K/V into those views in place,
so the reference's per-step unpack/pack copy has no counterpart here,
and slot reset is an in-place masked multiply. Live state bytes equal
``StatePlan.total_size`` for the engine's whole lifetime.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core.unified import StatePlan, dtype_name, iter_leaves
from repro_torch.runtime.arena import ArenaLayout, DeviceArena


def _slot_axis(path: str) -> int:
    """Which leaf axis carries the slot (request batch) dimension: leaves
    under ``"period"`` are stacked over ``n_periods`` first, so slots are
    axis 1; everything else carries slots on axis 0 (reference
    ``residency.py:126``)."""
    return 1 if path.startswith("['period']") else 0


def _rebuild(template: Any, leaves: dict[str, torch.Tensor], prefix: str = "") -> Any:
    """``template``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves, f"{prefix}[{k!r}]") for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return tuple(
            _rebuild(v, leaves, f"{prefix}[{i}]") for i, v in enumerate(template)
        )
    return leaves[prefix]


class StateResidency:
    """Bind a cache structure to a StatePlan's leaf-view spec.

    ``template`` may hold tensors on any device, ``meta`` included — only
    structure, shapes and dtypes are read."""

    def __init__(
        self,
        state_plan: StatePlan,
        template: Any,
        *,
        n_slots: int,
        layout: ArenaLayout | None = None,
    ):
        if state_plan.n_slots != n_slots:
            raise ValueError(
                f"state plan lays out {state_plan.n_slots} slots, engine "
                f"serves {n_slots}"
            )
        self.state_plan = state_plan
        self.n_slots = n_slots
        self.template = template
        if layout is None:
            layout = ArenaLayout.from_state_plan(state_plan)
        self.arena = DeviceArena(layout)

        views_by_path: dict[str, list] = {}
        for view in state_plan.leaf_view_spec():
            views_by_path.setdefault(view.path, []).append(view)
        leaves = list(iter_leaves(template))
        tmpl_paths = {p for p, _ in leaves}
        if tmpl_paths != set(views_by_path):
            missing = sorted(tmpl_paths - set(views_by_path))
            extra = sorted(set(views_by_path) - tmpl_paths)
            raise ValueError(
                f"state plan does not cover this cache structure: "
                f"{len(missing)} leaf(s) unplanned {missing[:3]}, "
                f"{len(extra)} planned leaf(s) absent {extra[:3]}"
            )

        # per-leaf binding: (path, shape, strides, storage offset, dtype),
        # strides and offset in elements of the leaf dtype
        self._bindings = []
        stride = state_plan.slot_stride
        for path, leaf in leaves:
            axis = _slot_axis(path)
            shape = tuple(int(d) for d in leaf.shape)
            if axis >= len(shape) or shape[axis] != n_slots:
                raise ValueError(
                    f"state leaf {path!r}: expected {n_slots} slots on "
                    f"axis {axis} of shape {shape}"
                )
            dt = leaf.dtype
            per_slot_shape = shape[:axis] + shape[axis + 1 :]
            per_slot_nbytes = math.prod(per_slot_shape) * dt.itemsize
            views = sorted(views_by_path[path], key=lambda v: v.slot)
            for v in views:
                if v.dtype != dtype_name(dt):
                    raise ValueError(
                        f"state leaf {path!r}: plan dtype {v.dtype} != "
                        f"cache dtype {dtype_name(dt)}"
                    )
                if v.used_nbytes != per_slot_nbytes:
                    raise ValueError(
                        f"state leaf {path!r}: plan expects "
                        f"{v.used_nbytes} B/slot, cache carries "
                        f"{per_slot_nbytes} B/slot"
                    )
                if v.offset != views[0].offset + v.slot * stride:
                    raise ValueError(
                        f"state leaf {path!r}: slot {v.slot} is not one slot "
                        f"stride ({stride} B) after slot {v.slot - 1}"
                    )
                self.arena.check(v.tensor_id, per_slot_nbytes)
            base, slot_step = views[0].offset, stride
            if base % dt.itemsize or slot_step % dt.itemsize:
                raise ValueError(
                    f"state leaf {path!r}: offsets not multiples of "
                    f"{dt.itemsize} B"
                )
            # C-order strides of one slot's share, with the slot axis
            # inserted at `axis` striding by the slot stride
            inner = [1] * len(per_slot_shape)
            for i in range(len(per_slot_shape) - 2, -1, -1):
                inner[i] = inner[i + 1] * per_slot_shape[i + 1]
            strides = inner[:axis] + [slot_step // dt.itemsize] + inner[axis:]
            self._bindings.append(
                (path, shape, tuple(strides), base // dt.itemsize, dt)
            )

    @property
    def total_size(self) -> int:
        return self.state_plan.total_size

    def init_buffer(self, device) -> torch.Tensor:
        """A fresh zeroed state buffer (the models' ``init_cache`` contract
        is all-zero state)."""
        return self.arena.allocate(device)

    def views(self, buf: torch.Tensor) -> Any:
        """The cache structure as zero-copy strided views into ``buf``."""
        leaves = {
            path: buf.view(dt).as_strided(shape, strides, offset)
            for path, shape, strides, offset, dt in self._bindings
        }
        return _rebuild(self.template, leaves)


class ResidentState:
    """Serving backend: the cross-step state is ONE buffer of exactly
    ``StatePlan.total_size`` bytes, and the cache the decode step reads
    and writes is a set of views into it."""

    def __init__(self, model, residency: StateResidency, device):
        self.model = model
        self.buf = residency.init_buffer(device)
        self.caches = residency.views(self.buf)

    def decode(self, params, tokens, pos, active):
        logits, _ = self.model.decode_step(params, tokens, self.caches, pos, active)
        return logits

    def reset(self, keep: torch.Tensor) -> None:
        self.model.reset_slots(self.caches, keep)

    @property
    def live_bytes(self) -> int:
        return self.buf.numel() * self.buf.element_size()
