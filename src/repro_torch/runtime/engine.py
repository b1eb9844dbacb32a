"""Inference engine: plan-once memory management + batched serving.

Port of the reference's ``runtime/engine.py`` on its main path. At
construction the engine:

1. lays the per-slot caches (attention K/V, Mamba2 conv window and SSM
   state) out with ``plan_state`` and serves them from ONE flat device
   buffer of exactly ``StatePlan.total_size`` bytes
   (``runtime/residency.py``): the cache the decode step reads and
   writes is a set of zero-copy views into it, and a recycled slot is
   zeroed before its next request;
2. traces the decode step into usage records, plans them with the
   ``auto`` offsets portfolio (paper §5–§6) and materializes the plan as
   one activation arena, inside an :class:`ArenaExecutor`
   (``runtime/executor.py``) that runs the step with every intermediate
   at its planned offset;
3. on the card, captures that step as CUDA graphs (``runtime/graphs.py``):
   the host-loop step and, with ``block_size > 1``, one block wave. Every
   decode step after that is a replay, and its activation memory is the
   planned arena.

It then runs continuous batching: fixed ``n_slots``, admit from the queue
on free (the prompt goes token by token through the decode step at the
slot's own position), step all active slots each wave, retire on EOS /
token budget / max_len. ``block_size=1`` is the single-wave host loop
(greedy argmax or a numpy draw on the host, one host sync per wave);
``block_size=K > 1`` runs up to K waves per host sync with on-device
sampling and stop detection (the reference's scan-block decode).

Left for later slices, each raising ``NotImplementedError``: plan
sessions and bundles (ROADMAP A12) and paged state (A10).
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.planner import MemoryPlan
from repro_torch.core.unified import StatePlan, plan_state, state_records_from_cache
from repro_torch.models.api import DecoderModel
from repro_torch.runtime.arena import ArenaLayout
from repro_torch.runtime.executor import ArenaExecutor
from repro_torch.runtime.residency import BlockOut, ResidentState, StateResidency
from repro_torch.runtime.sampling import SamplingParams, TokenSampler, host_probs

# Decode-phase host synchronization points, module-wide (the reference's
# counter): +1 per host-loop wave (its logits fetch), +1 per block
# absorbed (its tokens fetch).
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
class _Inflight:
    """A dispatched-but-not-absorbed block: its outputs on their way to
    the host, the wave span it covers, the slot->request snapshot at
    dispatch time, and the PREDICTED per-slot waves remaining after it
    (budget/max_len only — EOS can shorten a slot's run but never extend
    it), which is what the chained dispatch sizes the next block from
    without a host sync."""

    out: BlockOut
    base_wave: int
    length: int
    slots: dict[int, "Request"]
    rem_after: dict[int, int]


@dataclasses.dataclass
class MemoryReport:
    activation_plan: MemoryPlan
    # exact per-slot state bytes — the StatePlan's slot region size
    cache_bytes_per_slot: int
    n_slots: int
    state_plan: StatePlan
    # the whole cross-step state is ONE buffer of exactly the planned size
    state_live_bytes: int
    # the caching allocator's peak over one decode step (a replay on the
    # card), above what was allocated before it (None on the CPU, or
    # before the first step); the reference reports XLA's temp
    # allocation here
    allocator_step_peak_bytes: int | None = None
    # the CUDA graphs' private pool: the device bytes its segments hold
    # beyond the arena and the state, and the allocator's peak during the
    # captures (None on the CPU)
    graph_pool_bytes: int | None = None
    graph_capture_peak_bytes: int | None = None
    # the executor's producing nodes: written by out= into their arena
    # slot, or copied into it after the op (the custom ops among them)
    executor_in_place: int = 0
    executor_copied: int = 0
    # CUDA graphs captured for this engine, and the seconds they took
    capture_calls: int = 0
    capture_s: float | None = None

    @property
    def state_planned_bytes(self) -> int:
        return self.state_plan.total_size

    @property
    def unified_total_bytes(self) -> int:
        return self.activation_plan.total_size + self.state_plan.total_size

    def summary(self) -> str:
        lines = [self.activation_plan.summary()]
        lines.append(
            f"arena executor: {self.executor_in_place} nodes written in "
            f"place, {self.executor_copied} copied into the arena"
        )
        if self.capture_calls:
            lines.append(
                f"CUDA graphs: {self.capture_calls} captured in "
                f"{self.capture_s:.3f}s, pool {self.graph_pool_bytes / 2**20:.3f} "
                f"MiB (capture peak "
                f"{self.graph_capture_peak_bytes / 2**20:.3f} MiB)"
            )
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
        sample_seed: int | None = 0,
        temperature: float = 1.0,
        top_k: int = 0,
        # retire a slot when it emits this token (None = length-only)
        eos_id: int | None = None,
        # decode waves per host sync: 1 = the single-wave host loop (host
        # sampling, the oracle); K > 1 = block decode with on-device
        # sampling + stop detection
        block_size: int = 1,
        # the cores of the decode step: "kernel" (served) or "plain"
        # (parity checks only)
        cores: str = "kernel",
        session=None,
        page_size: int | None = None,
    ):
        if session is not None:
            raise _later("session= (plan sessions and bundles)",
                         "the compile/artifact slice (ROADMAP A12)")
        if page_size:
            raise _later("page_size (paged state)", "the paging slice (ROADMAP A10)")
        self.block_size = int(block_size)
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.sampling = SamplingParams(
            greedy=greedy, temperature=float(temperature), top_k=int(top_k)
        )
        self.greedy = greedy
        self.temperature = self.sampling.temperature
        self.top_k = self.sampling.top_k
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = DecoderModel(cfg, self.device, cores=cores)
        self.params = params
        self.eos_id = None if eos_id is None else int(eos_id)
        self.n_slots = n_slots
        self.max_len = max_len
        # ONE engine-owned generator for the host loop's draws
        self._sampler = np.random.default_rng(sample_seed)
        self._sample_seed = sample_seed

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
        # nothing runs, nothing is allocated), plan it, and allocate its
        # arena inside the executor that runs the step out of it
        tok0 = torch.zeros((n_slots, 1), dtype=torch.int32, device=self.device)
        pos0 = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        act0 = torch.ones((n_slots,), dtype=torch.bool, device=self.device)
        model = self.model

        def _decode_fn(p, freqs, t, c, pos, act):
            return model.decode_step(p, t, c, pos, act, rope_freqs=freqs)

        self.executor = ArenaExecutor(
            _decode_fn, params, model.rope_freqs, tok0, self.state.caches,
            pos0, act0, device=self.device, name=f"{cfg.name}-decode",
        )
        self.decode_graph = self.executor.graph
        plan = self.executor.plan
        self.activation_arena = self.executor.arena

        # --- the steps: static inputs, and on the card their CUDA graphs
        self._token_sampler = TokenSampler(self.sampling, max_len=max_len)
        t0 = time.perf_counter()
        self.state.start(self.executor, params, model.rope_freqs,
                         self._token_sampler, n_slots=n_slots,
                         block_size=self.block_size)
        capture_s = time.perf_counter() - t0
        captured = list(self.state.graphs.values())
        stats = self.executor.stats
        self._memory_report = MemoryReport(
            activation_plan=plan,
            cache_bytes_per_slot=state_plan.bytes_per_slot,
            n_slots=n_slots,
            state_plan=state_plan,
            state_live_bytes=self.state.live_bytes,
            graph_pool_bytes=(self.state.pool.reserved_bytes()
                              if self.state.pool is not None else None),
            graph_capture_peak_bytes=(max(g.capture_peak_bytes for g in captured)
                                      if captured else None),
            executor_in_place=stats.n_in_place,
            executor_copied=stats.n_copied,
            capture_calls=len(captured),
            capture_s=capture_s if captured else None,
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
        # decode steps run (admission steps and block waves included), the
        # last host-loop wave's logits as fetched to the host, the block
        # wave's per-slot keys (set at the first block) and the blocks
        # absorbed
        self.decode_calls = 0
        self.last_logits: np.ndarray | None = None
        self._keys = None
        self.n_blocks = 0

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
        logits = self.state.decode(tokens, pos, active)
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
                self.state.reset(~only_this)
            for t in req.prompt[:-1]:
                self._slot_tokens[slot, 0] = t
                self._step_tokens(self._slot_tokens, self._slot_pos, only_this)
                self._slot_pos[slot] += 1
            self._slot_tokens[slot, 0] = req.prompt[-1]

    def _sample_token(self, row: np.ndarray) -> int:
        """Greedy argmax, or a draw from the engine-owned generator (so
        consecutive draws — e.g. two slots in one wave — are independent,
        while a fixed ``sample_seed`` keeps whole runs reproducible).
        Probabilities come from the float64 ``sampling.host_probs``."""
        if self.greedy:
            return int(row.argmax())
        p = host_probs(row, temperature=self.temperature, top_k=self.top_k)
        return int(self._sampler.choice(len(p), p=p))

    def _finished(self, req: Request, slot: int, nxt: int) -> bool:
        """The retirement oracle, shared by the host loop and the block
        absorber (the on-device stop detection mirrors exactly this):
        EOS, exhausted new-token budget, or the context limit."""
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
        # the wave's one host sync: fetch (n_slots, vocab) float32 logits
        self.last_logits = self.state.fetch_logits(logits)
        HOST_SYNCS += 1
        finished: list[Request] = []
        for slot, req in list(self._active.items()):
            nxt = self._sample_token(self.last_logits[slot])
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

    # ----------------------------------------------------- block serve
    def _ensure_keys(self):
        if self._keys is None:
            seed = (
                self._sample_seed
                if self._sample_seed is not None
                else int(np.random.default_rng().integers(2**31 - 1))
            )
            self._keys = self.state.init_keys(
                self._token_sampler.init_keys(seed, self.n_slots, self.device)
            )
        return self._keys

    def _remaining_waves(self) -> dict[int, int]:
        """Per-active-slot PREDICTABLE waves left (new-token budget and
        max_len; EOS can only shorten a run, never extend it)."""
        rem = {}
        for slot, req in self._active.items():
            budget = req.max_new_tokens - len(req.tokens)
            len_cap = max((self.max_len - 1) - int(self._slot_pos[slot]), 1)
            rem[slot] = max(min(budget, len_cap), 1)
        return rem

    def _plan_block(self, waves_left: int | None = None) -> int:
        """This block's length K: capped by the LONGEST predictable
        remaining run (no all-frozen tail waves) and — when requests are
        queued — by the SHORTEST one, so predictable finishes land on the
        block's last wave and admission happens at exactly the same wave
        as the single-wave host loop (the differential-test schedule
        contract). A mid-block EOS still freezes its slot until the block
        ends; with a non-empty queue that defers the slot's re-admission
        by < block_size waves (the one scheduling deviation from the
        host loop — tokens are unaffected)."""
        rem = self._remaining_waves()
        k = min(self.block_size, max(rem.values()))
        if self._queue:
            k = min(k, min(rem.values()))
        if waves_left is not None:
            k = min(k, waves_left)
        return max(k, 1)

    def _dispatch_block(self, k: int) -> _Inflight:
        """Launch K block waves WITHOUT a host sync. The inputs are copied
        into the wave's static inputs from fresh host copies — the host
        keeps editing its numpy mirrors while the block is in flight."""
        active = np.zeros(self.n_slots, bool)
        budget = np.zeros(self.n_slots, np.int32)
        rem = self._remaining_waves()
        for slot, req in self._active.items():
            active[slot] = True
            budget[slot] = req.max_new_tokens - len(req.tokens)
        self._ensure_keys()
        out = self.state.decode_block(
            self._slot_tokens, self._slot_pos, active, budget,
            -1 if self.eos_id is None else self.eos_id, length=k,
        )
        self.decode_calls += k
        return _Inflight(
            out=out, base_wave=self._wave, length=k, slots=dict(self._active),
            rem_after={s: max(r - k, 0) for s, r in rem.items()},
        )

    def _dispatch_chained(self, prev: _Inflight, k: int) -> _Inflight:
        """Launch the NEXT block off the in-flight block's device carry —
        no host sync between the two dispatches. Only valid when nothing
        is queued (the carry's ``done`` mask already freezes every slot
        that finished mid-stream, and no admission can be pending)."""
        out = self.state.continue_block(length=k)
        self.decode_calls += k
        return _Inflight(
            out=out, base_wave=prev.base_wave + prev.length, length=k,
            slots=prev.slots,
            rem_after={s: max(r - k, 0) for s, r in prev.rem_after.items()},
        )

    def _absorb_block(self, inflight: _Inflight) -> list[Request]:
        """Fetch one block's per-wave outputs (THE one host sync per
        block) and replay them through the host bookkeeping — the same
        retirement oracle as the host loop, wave by wave, so slot_log
        intervals and finish waves mean the same thing in both modes."""
        global HOST_SYNCS
        HOST_SYNCS += 1
        self.n_blocks += 1
        toks, emitted = inflight.out.fetch()
        finished: list[Request] = []
        for k in range(inflight.length):
            wave = inflight.base_wave + k
            for slot, req in inflight.slots.items():
                if self._active.get(slot) is not req or not emitted[k, slot]:
                    continue
                nxt = int(toks[k, slot])
                req.tokens.append(nxt)
                self._slot_tokens[slot, 0] = nxt
                self._slot_pos[slot] += 1
                if self._finished(req, slot, nxt):
                    req.finished_wave = wave
                    self.slot_log.append(
                        (slot, req.admitted_wave, wave, req.request_id)
                    )
                    finished.append(req)
                    del self._active[slot]
        self._wave = inflight.base_wave + inflight.length
        return finished

    def step_block(self) -> list[Request]:
        """One synchronous block: admit, dispatch K waves, absorb.
        (``run_until_done`` pipelines these — it chains the next block's
        dispatch before fetching the previous block's results whenever
        the queue is empty.)"""
        self._admit()
        if not self._active:
            return []
        return self._absorb_block(self._dispatch_block(self._plan_block()))

    def _run_blocks(self, max_waves: int) -> list[Request]:
        done: list[Request] = []
        waves_left = max_waves
        inflight: _Inflight | None = None
        while True:
            if inflight is None:
                self._admit()
                if not self._active or waves_left <= 0:
                    break
                k = self._plan_block(waves_left)
                inflight = self._dispatch_block(k)
                waves_left -= k
            # async admission/retirement: with nothing queued, no host
            # decision can change the next block's inputs — chain its
            # dispatch off the in-flight carry BEFORE fetching, so the
            # absorb below overlaps device compute
            nxt: _Inflight | None = None
            if not self._queue and waves_left > 0:
                rem = [r for r in inflight.rem_after.values() if r > 0]
                if rem:
                    k2 = min(self.block_size, max(rem), waves_left)
                    nxt = self._dispatch_chained(inflight, k2)
                    waves_left -= k2
            done.extend(self._absorb_block(inflight))
            inflight = nxt
            if inflight is None and not self._active and not self._queue:
                break
        return done

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
        if self.block_size <= 1:
            for _ in range(max_waves):
                done.extend(self.step())
                if not self._active and not self._queue:
                    break
        else:
            done.extend(self._run_blocks(max_waves))
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
