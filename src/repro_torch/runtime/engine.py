"""Inference engine: plan-once memory management + batched greedy serving.

Port of the reference's ``runtime/engine.py`` on its main path. At
construction the engine:

1. traces the decode step into usage records (``trace/fx_liveness``) and
   plans them with the ``auto`` offsets portfolio (paper §5–§6), then
   materializes that activation plan as one arena on the device;
2. lays the per-slot caches (attention K/V, Mamba2 conv window and SSM
   state) out with ``plan_state`` and serves them from ONE flat device
   buffer of exactly ``StatePlan.total_size`` bytes
   (``runtime/residency.py``): the cache the decode step reads and
   writes is a set of zero-copy views into it, and a recycled slot is
   zeroed before its next request;
3. runs continuous batching with the single-wave host loop: fixed
   ``n_slots``, admit from the queue on free (the prompt goes token by
   token through the decode step at the slot's own position), step all
   active slots each wave, take the greedy argmax on the host, retire on
   EOS / token budget / max_len.

The decode step's own intermediates still come from PyTorch's caching
allocator; ``memory_report`` sets the allocator's peak over one decode
step beside the planned activation total. (Running the step out of the
arena is ROADMAP A4.) Left for later slices, each raising
``NotImplementedError``: plan sessions and bundles, paged state, block
decode and sampling.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.planner import MemoryPlan, plan_graph
from repro_torch.core.unified import StatePlan, plan_state, state_records_from_cache
from repro_torch.models.api import DecoderModel
from repro_torch.runtime.arena import Arena, ArenaLayout
from repro_torch.runtime.residency import ResidentState, StateResidency
from repro_torch.trace.fx_liveness import trace_graph

# Decode-phase host synchronization points, module-wide (the reference's
# counter): +1 per host-loop wave — the one logits fetch of that wave.
HOST_SYNCS = 0


def resolve_device(device) -> torch.device:
    """``None`` means the card. Without one that is an error, not a
    silent move to the CPU: pass ``device="cpu"`` to run there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card unless asked "
                "for the CPU (pass device='cpu')"
            )
        return torch.device("cuda")
    return torch.device(device)


class WavesExhaustedError(RuntimeError):
    """``run_until_done`` ran out of its wave budget with requests still
    active or queued; ``unfinished`` carries them."""

    def __init__(self, msg: str, unfinished: "list[Request]"):
        super().__init__(msg)
        self.unfinished = unfinished


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    admitted_wave: int = -1  # wave at which the request took a slot
    tokens: list[int] = dataclasses.field(default_factory=list)
    finished_wave: int = -1


@dataclasses.dataclass
class MemoryReport:
    activation_plan: MemoryPlan
    # exact per-slot state bytes — the StatePlan's slot region size
    cache_bytes_per_slot: int
    n_slots: int
    state_plan: StatePlan
    # the whole cross-step state is ONE buffer of exactly the planned size
    state_live_bytes: int
    # the caching allocator's peak over one decode step, above what was
    # allocated before it (None on the CPU, or before the first step);
    # the reference reports XLA's temp allocation here
    allocator_step_peak_bytes: int | None = None

    @property
    def state_planned_bytes(self) -> int:
        return self.state_plan.total_size

    @property
    def unified_total_bytes(self) -> int:
        return self.activation_plan.total_size + self.state_plan.total_size

    def summary(self) -> str:
        lines = [self.activation_plan.summary()]
        if self.allocator_step_peak_bytes is not None:
            lines.append(
                f"caching-allocator peak over one decode step: "
                f"{self.allocator_step_peak_bytes / 2**20:.3f} MiB"
            )
        lines.append(self.state_plan.summary())
        lines.append(
            f"unified footprint (activation + state): "
            f"{self.unified_total_bytes / 2**20:.3f} MiB"
        )
        lines.append(
            f"state residency: ON — live device state "
            f"{self.state_live_bytes / 2**20:.3f} MiB in one plan-backed "
            f"allocation"
        )
        lines.append(
            f"KV/state cache: {self.cache_bytes_per_slot / 2**20:.3f} MiB/slot "
            f"x {self.n_slots} slots"
        )
        return "\n".join(lines)


def _later(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(f"{what} comes with {slice_}")


class InferenceEngine:
    def __init__(
        self,
        cfg: ArchConfig,
        params: dict,
        *,
        n_slots: int = 4,
        max_len: int = 256,
        device=None,
        greedy: bool = True,
        # retire a slot when it emits this token (None = length-only)
        eos_id: int | None = None,
        # the cores of the decode step: "kernel" (served) or "plain"
        # (parity checks only)
        cores: str = "kernel",
        session=None,
        page_size: int | None = None,
        block_size: int = 1,
    ):
        if session is not None:
            raise _later("session= (plan sessions and bundles)",
                         "the compile/artifact slice (ROADMAP A12)")
        if page_size:
            raise _later("page_size (paged state)", "the paging slice (ROADMAP A10)")
        if block_size != 1:
            raise _later("block_size > 1 (scan-block decode)",
                         "the block-decode slice (ROADMAP A11)")
        if not greedy:
            raise _later("greedy=False (sampling)", "the block-decode slice (ROADMAP A11)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = DecoderModel(cfg, self.device, cores=cores)
        self.params = params
        self.eos_id = None if eos_id is None else int(eos_id)
        self.n_slots = n_slots
        self.max_len = max_len

        # --- cross-step state: plan the slot/KV layout from a shape-only
        # template, then allocate the ONE buffer and bind the views
        template = self.model.init_cache(n_slots, max_len, device="meta")
        state_plan = plan_state(
            state_records_from_cache(template, n_slots=n_slots),
            n_slots=n_slots, max_len=max_len,
        )
        self.state_layout = ArenaLayout.from_state_plan(state_plan)
        self.residency = StateResidency(
            state_plan, template, n_slots=n_slots, layout=self.state_layout
        )
        self.state = ResidentState(self.model, self.residency, self.device)

        # --- activation half: trace the decode step once (fake tensors:
        # nothing runs, nothing is allocated) and plan it
        tok0 = torch.zeros((n_slots, 1), dtype=torch.int32, device=self.device)
        pos0 = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        act0 = torch.ones((n_slots,), dtype=torch.bool, device=self.device)
        model = self.model

        def _decode_fn(p, freqs, t, c, pos, act):
            return model.decode_step(p, t, c, pos, act, rope_freqs=freqs)

        graph = trace_graph(
            _decode_fn, params, model.rope_freqs, tok0, self.state.caches,
            pos0, act0, name=f"{cfg.name}-decode",
        )
        self.decode_graph = graph
        plan = plan_graph(graph, mode="offsets", strategy="auto")
        # allocate-once deployment of the activation plan
        self.activation_arena = Arena(ArenaLayout.from_plan(plan), self.device)
        self._memory_report = MemoryReport(
            activation_plan=plan,
            cache_bytes_per_slot=state_plan.bytes_per_slot,
            n_slots=n_slots,
            state_plan=state_plan,
            state_live_bytes=self.state.live_bytes,
        )

        # serving state — per-slot positions (continuous batching: every
        # slot advances at its own position in ONE decode call per wave)
        self._queue: list[Request] = []
        self._active: dict[int, Request] = {}  # slot -> request
        self._slot_pos = np.zeros(n_slots, np.int32)
        self._slot_tokens = np.zeros((n_slots, 1), np.int32)
        self._wave = 0
        # slot occupancy intervals: (slot, first_wave, last_wave, request_id)
        self.slot_log: list[tuple[int, int, int, int]] = []
        self._next_rid = 0
        # decode-step calls (admission steps included) and the last wave's
        # logits as fetched to the host
        self.decode_calls = 0
        self.last_logits: np.ndarray | None = None

    # ------------------------------------------------------------ admin
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, np.asarray(prompt, np.int32), max_new_tokens))
        return rid

    @property
    def caches(self):
        """The live cache structure: views into the one state buffer."""
        return self.state.caches

    @property
    def memory_report(self) -> MemoryReport:
        return self._memory_report

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        # a fresh host copy per call: the engine keeps mutating its numpy
        # mirrors while the copy to the card may still be in flight (pinned
        # memory lets it run without waiting for the stream)
        t = torch.from_numpy(np.array(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _step_tokens(self, tokens: np.ndarray, pos: np.ndarray,
                     active: np.ndarray) -> torch.Tensor:
        measure = (
            self.device.type == "cuda"
            and self._memory_report.allocator_step_peak_bytes is None
        )
        if measure:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            base = torch.cuda.memory_allocated(self.device)
        with torch.no_grad():
            logits = self.state.decode(
                self.params, self._to_device(tokens), self._to_device(pos),
                self._to_device(active),
            )
        self.decode_calls += 1
        if measure:
            torch.cuda.synchronize(self.device)
            self._memory_report.allocator_step_peak_bytes = (
                torch.cuda.max_memory_allocated(self.device) - base
            )
        return logits

    def _admit(self) -> None:
        free = [s for s in range(self.n_slots) if s not in self._active]
        while free and self._queue:
            slot = free.pop(0)
            req = self._queue.pop(0)
            req.admitted_wave = self._wave
            self._active[slot] = req
            # per-slot prefill: feed prompt tokens through the decode step
            # at this slot's own position; other slots are NOT advanced
            # (their cache rows are rewritten with what they hold)
            self._slot_pos[slot] = 0
            only_this = np.zeros(self.n_slots, bool)
            only_this[slot] = True
            # wipe the recycled slot's state
            with torch.no_grad():
                self.state.reset(self._to_device(~only_this))
            for t in req.prompt[:-1]:
                self._slot_tokens[slot, 0] = t
                self._step_tokens(self._slot_tokens, self._slot_pos, only_this)
                self._slot_pos[slot] += 1
            self._slot_tokens[slot, 0] = req.prompt[-1]

    def _finished(self, req: Request, slot: int, nxt: int) -> bool:
        """The retirement rule: EOS, exhausted new-token budget, or the
        context limit."""
        return (
            (self.eos_id is not None and nxt == self.eos_id)
            or len(req.tokens) >= req.max_new_tokens
            or int(self._slot_pos[slot]) >= self.max_len - 1
        )

    # ------------------------------------------------------------ serve
    def step(self) -> list[Request]:
        """One decode wave over all active slots; returns finished reqs."""
        global HOST_SYNCS
        self._admit()
        if not self._active:
            return []
        active = np.zeros(self.n_slots, bool)
        for s in self._active:
            active[s] = True
        logits = self._step_tokens(self._slot_tokens, self._slot_pos, active)
        # the wave's one host sync: fetch (n_slots, vocab) logits
        self.last_logits = logits.float().cpu().numpy()
        HOST_SYNCS += 1
        finished: list[Request] = []
        for slot, req in list(self._active.items()):
            nxt = int(self.last_logits[slot].argmax())
            req.tokens.append(nxt)
            self._slot_tokens[slot, 0] = nxt
            self._slot_pos[slot] += 1
            if self._finished(req, slot, nxt):
                req.finished_wave = self._wave
                self.slot_log.append(
                    (slot, req.admitted_wave, self._wave, req.request_id)
                )
                finished.append(req)
                del self._active[slot]
        self._wave += 1
        return finished

    @property
    def waves(self) -> int:
        return self._wave

    def unfinished_requests(self) -> list[Request]:
        return list(self._active.values()) + list(self._queue)

    def run_until_done(
        self, max_waves: int = 10_000, *, raise_on_exhausted: bool = False
    ) -> list[Request]:
        """Serve until queue and slots drain (or ``max_waves`` decode
        waves run). Exhausting the wave budget with work remaining warns —
        or raises :class:`WavesExhaustedError` under
        ``raise_on_exhausted=True``."""
        done: list[Request] = []
        for _ in range(max_waves):
            done.extend(self.step())
            if not self._active and not self._queue:
                break
        if self._active or self._queue:
            msg = (
                f"run_until_done exhausted max_waves={max_waves} with "
                f"{len(self._active)} active and {len(self._queue)} queued "
                f"request(s) unfinished"
            )
            if raise_on_exhausted:
                raise WavesExhaustedError(msg, self.unfinished_requests())
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return done
