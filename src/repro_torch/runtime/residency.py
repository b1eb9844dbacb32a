"""Plan-backed state residency: the engine's cross-step state in ONE
device buffer, laid out by the :class:`~repro_torch.core.unified.StatePlan`.

Port of the reference's ``runtime/residency.py``:

* :class:`StateResidency` binds a cache structure to a StatePlan's
  leaf-view spec and validates the binding completely (path sets, dtypes,
  per-slot byte sizes, the slot axis extent, the slot stride), so a stale
  or foreign plan fails at construction instead of corrupting state;
* :class:`ResidentState` is the serving backend built on it: it runs
  the decode step through the arena executor (``runtime/executor.py``),
  as captured CUDA graphs on the card (``runtime/graphs.py``), and it
  runs blocks of decode waves with on-device sampling
  (:func:`_block_wave`, :class:`BlockOut`; reference
  ``residency.py:281-372``).

Each cache leaf is a ZERO-COPY strided view into the one ``uint8``
buffer: the buffer reinterpreted as the leaf dtype, then ``as_strided``
at the plan's offsets, with the slot axis striding by the plan's slot
stride. The decode step writes the new K/V into those views in place,
so the reference's per-step unpack/pack copy has no counterpart here,
and slot reset is an in-place masked multiply. Live state bytes equal
``StatePlan.total_size`` for the engine's whole lifetime.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core.unified import StatePlan, dtype_name, iter_leaves
from repro_torch.runtime import graphs
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


@dataclasses.dataclass
class BlockOut:
    """One dispatched block's per-wave outputs, on their way to the host:
    the token chosen at each wave and whether the slot emitted it, copied
    without a host sync. The post-block carry (tokens, positions, stop
    flags, budgets, keys) stays in the block wave's static inputs on the
    device, where the next block chains off it."""

    wave_tokens: torch.Tensor  # (K, n_slots) int32 on the host
    emitted: torch.Tensor  # (K, n_slots) bool on the host
    ready: Any = None  # CUDA event recorded after the copies (None on the CPU)

    def fetch(self) -> tuple[np.ndarray, np.ndarray]:
        """Wait for the copies (the block's one host sync) and return
        them as numpy arrays."""
        if self.ready is not None:
            self.ready.synchronize()
        return self.wave_tokens.numpy(), self.emitted.numpy()


def _block_wave(decode, sampler, tokens, pos, active, done, budget, keys, eos):
    """One block wave: decode at ``active & ~done``, then the sampler's
    on-device token selection and stop bookkeeping. Inactive and frozen
    slots keep their token and position, so the cache write stays
    idempotent for them, the same invariant the host loop relies on.
    Returns the carry and the wave's (token, emitted) rows."""
    step_active = active & torch.logical_not(done)
    logits = decode(tokens, pos, step_active)
    keys, tokens, pos, done, budget = sampler.advance(
        logits, keys, tokens, pos, step_active, done, budget, eos
    )
    return (tokens, pos, done, budget, keys), (tokens[:, 0], step_active)


class _Static:
    """Named device tensors a step reads and writes in place."""

    def __init__(self, **tensors: torch.Tensor):
        self.__dict__.update(tensors)


class ResidentState:
    """Serving backend: the cross-step state is ONE buffer of exactly
    ``StatePlan.total_size`` bytes, and the cache the decode step reads
    and writes is a set of views into it.

    :meth:`start` binds the arena executor that runs the decode step.
    Every step then reads static input tensors that :meth:`decode` and
    :meth:`decode_block` fill from the host. On the card each kind of
    step is a :class:`~repro_torch.runtime.graphs.CapturedStep`, replayed:
    the host-loop step (logits out, admission steps included) and, with
    ``block_size > 1``, one block wave (decode, the sampler, and a write
    of row ``k`` of the block's outputs, ``k`` a device counter), so a
    block of K waves is K replays of one graph whatever K is. On the CPU
    the same functions run eagerly."""

    def __init__(self, model, residency: StateResidency, device):
        self.model = model
        self.device = torch.device(device)
        self.buf = residency.init_buffer(self.device)
        self.caches = residency.views(self.buf)
        self.graphs: dict[str, Any] = {}
        self.pool = None
        # set by analysis/decode_lint: raise on any host sync while a
        # block's waves are replayed
        self.sync_guard = False

    # ------------------------------------------------------------- bind
    def start(self, executor, params, tables, sampler, *, n_slots: int,
              block_size: int) -> None:
        """Build the static inputs and, on the card, capture the steps.
        ``tables`` are the model's constant inputs (``rope_tables``)."""
        n, dev = n_slots, self.device
        caches = self.caches

        def decode(tokens, pos, active):
            logits, _ = executor(params, tables, tokens, caches, pos, active)
            return logits

        self._s = s = _Static(
            tokens=torch.zeros((n, 1), dtype=torch.int32, device=dev),
            pos=torch.zeros((n,), dtype=torch.int32, device=dev),
            active=torch.zeros((n,), dtype=torch.bool, device=dev),
        )

        def step():
            return decode(s.tokens, s.pos, s.active).float()

        self._step = step
        self._wave = None
        if block_size > 1:
            self._w = w = _Static(
                tokens=torch.zeros((n, 1), dtype=torch.int32, device=dev),
                pos=torch.zeros((n,), dtype=torch.int32, device=dev),
                active=torch.zeros((n,), dtype=torch.bool, device=dev),
                done=torch.zeros((n,), dtype=torch.bool, device=dev),
                budget=torch.zeros((n,), dtype=torch.int32, device=dev),
                keys=torch.zeros((n, 2), dtype=torch.int64, device=dev),
                eos=torch.full((), -1, dtype=torch.int32, device=dev),
                k=torch.zeros((1,), dtype=torch.int64, device=dev),
                wave_tokens=torch.zeros((block_size, n), dtype=torch.int32,
                                        device=dev),
                emitted=torch.zeros((block_size, n), dtype=torch.bool, device=dev),
            )

            def wave():
                (tokens, pos, done, budget, keys), (tok, emitted) = _block_wave(
                    decode, sampler, w.tokens, w.pos, w.active, w.done,
                    w.budget, w.keys, w.eos,
                )
                w.tokens.copy_(tokens)
                w.pos.copy_(pos)
                w.done.copy_(done)
                w.budget.copy_(budget)
                w.keys.copy_(keys)
                w.wave_tokens.index_copy_(0, w.k, tok[None])
                w.emitted.index_copy_(0, w.k, emitted[None])
                w.k.add_(1)

            self._wave = wave
        if dev.type == "cuda":
            # every slot inactive: the warm-up run leaves the state as it is
            self.pool = graphs.GraphPool(dev)
            self.graphs["step"] = graphs.CapturedStep(step, self.pool, name="step")
            self._step = self.graphs["step"].replay
            if self._wave is not None:
                self.graphs["wave"] = graphs.CapturedStep(self._wave, self.pool,
                                                          name="wave")
                self._wave = self.graphs["wave"].replay

    # ------------------------------------------------------------- host
    def _put(self, dst: torch.Tensor, arr) -> None:
        """Copy a host array into a static input without waiting: from a
        fresh pinned copy on the card (the host keeps editing its arrays
        while the copy may be in flight)."""
        src = torch.from_numpy(np.array(arr))
        if self.device.type == "cuda":
            src = src.pin_memory()
        dst.copy_(src.reshape(dst.shape), non_blocking=True)

    def _to_host(self, src: torch.Tensor) -> torch.Tensor:
        """A host copy of ``src``, queued without waiting (into pinned
        memory on the card)."""
        if self.device.type != "cuda":
            return src.clone()
        dst = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        dst.copy_(src, non_blocking=True)
        return dst

    def _copied(self):
        """An event after the copies queued so far (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    # ------------------------------------------------------------ steps
    def decode(self, tokens, pos, active) -> torch.Tensor:
        """One host-loop step (a replay on the card): float32 logits
        (n_slots, vocab) on the device, valid until the next step."""
        s = self._s
        self._put(s.tokens, tokens)
        self._put(s.pos, pos)
        self._put(s.active, active)
        return self._step()

    def fetch_logits(self, logits: torch.Tensor) -> np.ndarray:
        """The step's logits on the host (a host sync)."""
        host, ev = self._to_host(logits), self._copied()
        if ev is not None:
            ev.synchronize()
        return host.numpy()

    def init_keys(self, keys: torch.Tensor) -> torch.Tensor:
        """Set the block wave's per-slot keys; returns the device keys,
        which the waves then advance in place."""
        self._w.keys.copy_(keys)
        return self._w.keys

    def decode_block(self, tokens, pos, active, budget, eos: int, *,
                     length: int) -> BlockOut:
        """``length`` block waves from the host's tokens, positions,
        active mask and budgets, stop flags cleared. Returns without a
        host sync."""
        w = self._w
        self._put(w.tokens, tokens)
        self._put(w.pos, pos)
        self._put(w.active, active)
        self._put(w.budget, budget)
        self._put(w.eos, np.int32(eos))
        w.done.zero_()
        return self.continue_block(length=length)

    def continue_block(self, *, length: int) -> BlockOut:
        """``length`` more block waves off the carry the last block left
        on the device (no host input at all)."""
        w = self._w
        w.k.zero_()
        guard = self.sync_guard and self.device.type == "cuda"
        if guard:
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(length):
                self._wave()
            out = BlockOut(wave_tokens=self._to_host(w.wave_tokens[:length]),
                           emitted=self._to_host(w.emitted[:length]),
                           ready=self._copied())
        finally:
            if guard:
                torch.cuda.set_sync_debug_mode(mode)
        return out

    def reset(self, keep) -> None:
        """Zero the state of the slots where ``keep`` is False."""
        dev_keep = torch.empty((len(keep),), dtype=torch.bool, device=self.device)
        self._put(dev_keep, keep)
        self.model.reset_slots(self.caches, dev_keep)

    @property
    def live_bytes(self) -> int:
        return self.buf.numel() * self.buf.element_size()
