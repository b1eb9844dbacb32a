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

With ``page_size`` the state is PAGED (``runtime/paging.py``, the
reference's ``page_size``/``page_pool``): the state plan is
``plan_paged_state`` over the axes ``detect_state_axes`` finds, the
buffer is a pool of ``page_pool`` pages (default: enough to map every
slot fully) plus the null page, admission maps the pages a request's
cache length touches before it takes a slot (head-of-line: a request
that does not fit waits for a retirement, and with no slot active
``PagedOutOfPagesError`` propagates), and retirement frees them. Every
family pages: the decode step writes and reads the K/V caches, global,
ring or the shared block's, through the page table, and a Mamba2 layer
gathers its conv window and SSM state through it and puts them back.

With ``session=PlanSession.from_manifest(dir)`` (or ``.from_bundle``)
the engine serves a bundle that ``launch/compile.py`` published: after
the config-level fingerprint check it takes both halves from the bundle,
so neither the planner nor the state layout runs (``plan_calls`` and
``state_plan_calls`` stay 0). A bundle that carries the AOT decode
program (``runtime/aot.py``) also gives the executor its program, so
nothing is traced (``trace_calls`` 0; ``MemoryReport.aot_executables``
names it); the CUDA graphs are captured all the same, one per graph, as
a captured graph cannot be serialized: AOT removes the trace, not the
capture. With ``PlanSession(verify_graph=True)`` the engine also traces
the step and holds its structural fingerprint against the bundle's
(``trace_calls`` 1). A pack that ``load_executables`` refuses warns one
line (``MemoryReport.aot_warning``) and the step is traced as without
one. Without a pack the engine traces the decode step once, as the
executor's program (the reference pays that as jit tracing), and holds
the trace's structural fingerprint against the bundle's before the plan
reaches the executor. A mismatch, an unusable bundle, or a searched
activation plan (another order or fusion groups; the executor runs
program order) falls back to planning at construction with a one-line
``MemoryReport.bundle_warning``; it never raises.

With ``state_residency=False`` (or ``REPRO_STATE_RESIDENCY=off``) the
pytree backend serves (``runtime/residency.PytreeState``): the caches
``init_cache`` returns, owned by the caching allocator, and the model's
step run eagerly, the baseline the planner is measured against. The
unified plan is still made or loaded, on a ``meta`` twin of the program
(nothing is allocated for it), and kept as accounting; no activation
arena is allocated. A bundle still serves its plans (``plan_source``
"bundle"), but its AOT program is not used: the eager step has no
entry. A paged bucket serves the symmetric pytree backend with one
warning.

With ``startup_lint=True`` (or ``REPRO_STARTUP_LINT=1``) the engine
certifies its unified plan (activation and state, the paged extras
included) with ``analysis/soundness.certify_unified`` before it captures
or serves anything, and refuses a plan with findings (``LintGateError``).
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from repro_torch.analysis import soundness
from repro_torch.analysis.findings import LintGateError, Report
from repro_torch.configs.base import ArchConfig
from repro_torch.core import plan_io, unified
from repro_torch.core.artifact import (PlanBundle, decode_fingerprint,
                                      graph_fingerprint, serve_fingerprint)
from repro_torch.core.graph import Graph
from repro_torch.core.planner import MemoryPlan, plan_graph
from repro_torch.core.unified import (PagedStatePlan, PlanSession, PlanSpec, StatePlan,
                                     detect_state_axes, plan_paged_state, plan_state,
                                     state_plan_to_obj, state_records_from_cache)
from repro_torch.models.api import DecoderModel
from repro_torch.runtime.aot import decode_entry, inputs_mismatch, load_executables
from repro_torch.runtime.arena import ArenaLayout
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.executor import ArenaExecutor
from repro_torch.runtime.paging import (PagedOutOfPagesError, PagedResidentState,
                                       PagedStateResidency)
from repro_torch.runtime.residency import (BlockOut, PytreeState, ResidentState,
                                          StateResidency, residency_enabled)
from repro_torch.runtime.sampling import SamplingParams, TokenSampler, host_probs
from repro_torch.trace.fx_liveness import FxTrace, trace_fx

# Decode-phase host synchronization points, module-wide (the reference's
# counter): +1 per host-loop wave (its logits fetch), +1 per block
# absorbed (its tokens fetch).
HOST_SYNCS = 0


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
    # exact per-slot state bytes — the StatePlan's slot region size; under
    # paging the live-page bytes per active slot (``engine.memory_report``
    # refreshes it)
    cache_bytes_per_slot: int
    n_slots: int
    state_plan: StatePlan
    # the whole cross-step state is ONE buffer of exactly the planned size
    state_live_bytes: int
    # where the plan came from: "bundle" (compiled artifact: no planner
    # call, no state layout), "cache" (plan cache hit) or "planned"
    plan_source: str = "planned"
    # one-line reason when a requested bundle could not be used and the
    # engine fell back to plan-at-construction
    bundle_warning: str | None = None
    # the seconds the session took to resolve the plan (None: no session)
    plan_resolve_s: float | None = None
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
    # the startup lint (soundness.certify_unified) over the unified plan:
    # its seconds and findings (None when it did not run), and the codes
    # of its warnings (an error refuses the plan): a paged pool smaller
    # than one slot's pages warns "paged-pool-short"
    startup_lint_s: float | None = None
    startup_lint_findings: int | None = None
    startup_lint_warnings: tuple[str, ...] = ()
    # the seconds the state plan took (under paging: the axis probe and
    # the carve of the page pool); None when the bundle supplied it
    state_plan_s: float | None = None
    # paged state (None on the symmetric backend): the pool's pages, the
    # pages held by active slots, and the page size
    state_pages_total: int | None = None
    state_pages_live: int | None = None
    state_page_size: int | None = None
    # False: the pytree backend serves (allocator-owned caches, the step
    # run eagerly); the activation plan is then accounting, no arena is
    # allocated, and the state plan is the layout the resident backend
    # would hold
    state_residency: bool = True
    # the bundle's AOT decode programs the engine loaded (their names), the
    # one-line reason a pack was refused, and the seconds the load took
    aot_executables: tuple[str, ...] = ()
    aot_warning: str | None = None
    aot_load_s: float | None = None
    # the seconds spent tracing the decode step at construction (None:
    # no trace ran, the program came from the bundle)
    trace_s: float | None = None

    @property
    def state_planned_bytes(self) -> int:
        return self.state_plan.total_size

    @property
    def unified_total_bytes(self) -> int:
        return self.activation_plan.total_size + self.state_plan.total_size

    def summary(self) -> str:
        lines = [self.activation_plan.summary()]
        if self.bundle_warning:
            lines.append(f"WARNING: {self.bundle_warning}")
        if self.aot_warning:
            lines.append(f"WARNING: {self.aot_warning}")
        if self.plan_source == "bundle":
            lines.append(
                "activation + state plans served from a precompiled bundle"
            )
        if self.aot_executables:
            lines.append(
                f"AOT decode program(s) loaded from the bundle in "
                f"{self.aot_load_s:.3f}s: {', '.join(self.aot_executables)} "
                f"(no trace)"
            )
        elif self.trace_s is not None:
            lines.append(f"decode step traced in {self.trace_s:.3f}s")
        elif self.plan_source == "cache":
            lines.append("activation plan served from the plan cache")
        if self.state_residency:
            lines.append(
                f"arena executor: {self.executor_in_place} nodes written in "
                f"place, {self.executor_copied} copied into the arena"
            )
        else:
            lines.append(
                "activation arena: planned, not allocated (state residency "
                "off: the step runs eagerly on the caching allocator)"
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
        if not self.state_residency:
            lines.append(
                f"state residency: OFF — live device state "
                f"{self.state_live_bytes / 2**20:.3f} MiB in allocator-owned "
                f"caches (the state plan is accounting)"
            )
        elif self.state_pages_total is not None:
            live = self.state_pages_live or 0
            page = self.state_page_size or 0
            lines.append(
                f"paged state: {live}/{self.state_pages_total} pool pages "
                f"live ({live * page / 2**20:.3f} MiB of "
                f"{self.state_planned_bytes / 2**20:.3f} MiB logical)"
            )
            lines.append(
                f"state residency: ON (paged) — live device state "
                f"{self.state_live_bytes / 2**20:.3f} MiB across "
                f"page-table-mapped pool pages"
            )
        else:
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


def _session_from_legacy_kwargs(
    session: PlanSession | None,
    *,
    plan_strategy: str | None,
    activation_graph: Graph | None,
    plan_bundle: "PlanBundle | str | Path | None",
    verify_bundle: bool | None,
) -> PlanSession | None:
    """Deprecated-kwarg shim (the reference's): the pre-session
    plan-source kwargs map onto a PlanSession. ``plan_bundle`` keeps its
    historical exact-bucket semantics (``nearest=False``); new callers get
    auto-selection through ``PlanSession.from_manifest``."""
    # explicitly-passed OLD DEFAULTS are semantic no-ops, not deprecated
    # usage — callers migrating incrementally must be able to combine
    # them with session= (the downstream spec/verify defaults reproduce
    # them exactly)
    if plan_strategy == "auto":
        plan_strategy = None
    if verify_bundle is False:
        verify_bundle = None
    legacy = {
        "plan_strategy": plan_strategy,
        "activation_graph": activation_graph,
        "plan_bundle": plan_bundle,
        "verify_bundle": verify_bundle,
    }
    used = [k for k, v in legacy.items() if v is not None]
    if not used:
        return session
    if session is not None:
        raise ValueError(
            f"pass either session= or the deprecated {used} kwargs, not both"
        )
    warnings.warn(
        f"InferenceEngine({', '.join(used)}=...) is deprecated; pass "
        f"session=PlanSession.from_manifest(dir) / .from_bundle(b) / "
        f".from_spec(PlanSpec(...)) instead",
        DeprecationWarning,
        stacklevel=3,
    )
    verify = bool(verify_bundle)
    if plan_bundle is not None:
        if not isinstance(plan_bundle, PlanBundle) and Path(plan_bundle).is_dir():
            return PlanSession.from_manifest(
                plan_bundle, nearest=False, verify_graph=verify
            )
        return PlanSession.from_bundle(plan_bundle, verify_graph=verify)
    return PlanSession.from_spec(
        PlanSpec(graph=activation_graph, strategy=plan_strategy or "auto")
    )


def plan_state_half(model: DecoderModel, *, n_slots: int, max_len: int,
                    page_size: int | None = None,
                    page_pool: int | None = None) -> StatePlan:
    """Lay the per-slot caches out from a shape-only (``meta``) template:
    ``plan_state``, or with ``page_size`` ``plan_paged_state`` over the
    axes ``detect_state_axes`` finds (each counted in
    ``unified.STATE_PLAN_CALLS``)."""
    template = model.init_cache(n_slots, max_len, device="meta")
    records = state_records_from_cache(template, n_slots=n_slots)
    if page_size:
        return plan_paged_state(
            records, n_slots=n_slots, max_len=max_len, page_size=page_size,
            page_pool=page_pool,
            axes=detect_state_axes(model.init_cache, n_slots=n_slots,
                                   max_len=max_len),
        )
    return plan_state(records, n_slots=n_slots, max_len=max_len)


def _sorted_keys(tree):
    """``tree`` with every dict's keys in sorted order (the leaves are the
    same tensors): the step's flat inputs, hence its traced graph, then
    do not depend on the order a caller built the params in."""
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_sorted_keys(v) for v in tree)
    return tree


@dataclasses.dataclass
class DecodeProgram:
    """The served decode step and what it runs on: the residency binding
    of the state plan, the state backend holding the one state buffer,
    the step function and its arguments (params, RoPE tables, tokens,
    the state inputs, positions, the active mask). The engine traces it
    as its executor's program, and ``launch/compile.py`` traces the same
    program on ``meta``, so a compiled bundle has the records the
    engine's executor traces."""

    residency: StateResidency
    state: ResidentState
    fn: Callable
    args: tuple
    name: str

    @property
    def params(self):
        """The params as the program takes them (keys sorted)."""
        return self.args[0]

    def trace(self) -> FxTrace:
        return trace_fx(self.fn, *self.args, name=self.name)


def decode_program(model: DecoderModel, params, state_plan: StatePlan, *,
                   n_slots: int, max_len: int, device) -> DecodeProgram:
    """Bind ``state_plan`` to the model's cache structure, allocate its
    state buffer on ``device`` (``meta`` allocates nothing) and build the
    decode step over it: the state inputs are views of the flat state
    buffer, or under paging the pool buffer and the page table, which each
    layer reads through ``PagedStateResidency.bind``. A plan that does not
    bind this cache structure raises ``ValueError``."""
    template = model.init_cache(n_slots, max_len, device="meta")
    paged = isinstance(state_plan, PagedStatePlan)
    residency_cls, backend = ((PagedStateResidency, PagedResidentState) if paged
                              else (StateResidency, ResidentState))
    residency = residency_cls(state_plan, template, n_slots=n_slots,
                              layout=ArenaLayout.from_state_plan(state_plan))
    state = backend(model, residency, device)
    tok0 = torch.zeros((n_slots, 1), dtype=torch.int32, device=device)
    pos0 = torch.zeros((n_slots,), dtype=torch.int32, device=device)
    act0 = torch.ones((n_slots,), dtype=torch.bool, device=device)

    if paged:
        bind = residency.bind

        def fn(p, tables, t, c, pos, act):
            # the pool and the table are the step's state inputs; each
            # layer gets its leaves' page addresses over them
            logits, _ = model.decode_step(p, t, bind(c["buf"], c["table"]),
                                          pos, act, **tables)
            return logits, c
    else:
        def fn(p, tables, t, c, pos, act):
            return model.decode_step(p, t, c, pos, act, **tables)

    return DecodeProgram(residency, state, fn,
                         (_sorted_keys(params), model.rope_tables, tok0, state.inputs,
                          pos0, act0),
                         name=f"{model.cfg.name}-decode")


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
        # the plan source: a compiled manifest, one bundle, or a spec
        # (None = trace and plan at construction)
        session: PlanSession | None = None,
        # paged state (None = symmetric max_len slot regions): the page
        # size in bytes and the pool size in pages (None = enough to map
        # every slot fully); joins the serve fingerprint so paged and
        # symmetric bundles for the same bucket never cross-match
        page_size: int | None = None,
        page_pool: int | None = None,
        # None -> the REPRO_STATE_RESIDENCY env knob (default: on); off
        # serves the pytree backend (runtime/residency.PytreeState)
        state_residency: bool | None = None,
        # certify the unified plan at startup with the static analyzer
        # (analysis/soundness); None -> the REPRO_STARTUP_LINT env knob
        # (default: off), as in the reference
        startup_lint: bool | None = None,
        # deprecated plan-source kwargs — use session=PlanSession...
        plan_strategy: str | None = None,
        activation_graph: Graph | None = None,
        plan_bundle: "PlanBundle | str | Path | None" = None,
        verify_bundle: bool | None = None,
    ):
        if cfg.family == "audio":
            raise NotImplementedError("engine drives decoder-only archs")
        session = _session_from_legacy_kwargs(
            session,
            plan_strategy=plan_strategy,
            activation_graph=activation_graph,
            plan_bundle=plan_bundle,
            verify_bundle=verify_bundle,
        )
        if session is not None and not isinstance(session, PlanSession):
            raise TypeError(
                f"session must be a PlanSession, got {type(session).__name__}")
        self.session = session
        self.page_size = None if not page_size else int(page_size)
        self.page_pool = None if page_pool is None else int(page_pool)
        if self.page_size is not None:
            if self.page_size <= 0:
                raise ValueError(f"page_size must be positive, got {page_size}")
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
        if self.page_size is not None and self.device.type == "cuda" \
                and cores == "kernel" and self.page_size % 16:
            # flash_decode_paged loads 16-byte chunks, each inside one page
            raise ValueError(f"page_size {self.page_size}: the card's paged kernel "
                             f"takes whole 16-byte multiples")
        self.cfg = cfg
        self.model = DecoderModel(cfg, self.device, cores=cores)
        self.params = params
        self.eos_id = None if eos_id is None else int(eos_id)
        # the part of the serve config that shapes the captured graphs —
        # joins the decode fingerprint (None = default greedy host loop)
        self._serve_params = serve_fingerprint(
            block_size=self.block_size, greedy=greedy,
            temperature=self.temperature, top_k=self.top_k,
            page_size=self.page_size, page_pool=self.page_pool,
        )
        # ONE engine-owned generator for the host loop's draws
        self._sampler = np.random.default_rng(sample_seed)
        self._sample_seed = sample_seed

        # --- the unified plan for this serving bucket. The session is the
        # single plan source: a compiled bundle carries BOTH halves behind
        # one fingerprint check, so neither the planner nor the state
        # layout runs. Nearest-bucket selection may hand back a longer
        # max_len or a wider slot pool; the engine serves that bucket. Any
        # mismatch or load failure falls back to plan-at-construction with
        # a one-line warning, never an error.
        resolution = (
            session.resolve(cfg, n_slots=n_slots, max_len=max_len,
                            serve_params=self._serve_params, cores=cores)
            if session is not None else None
        )
        self.max_len = resolution.max_len if resolution is not None else max_len
        if resolution is not None and resolution.n_slots:
            n_slots = resolution.n_slots
        self.n_slots = n_slots
        bundle = resolution.bundle if resolution is not None else None
        resolved = resolution.unified if resolution is not None else None
        bundle_warning = resolution.warning if resolution is not None else None
        spec = resolution.spec if resolution is not None else None
        if resolved is not None and (resolved.order is not None
                                     or resolved.fusion_groups is not None):
            what = "order" if resolved.order is not None else "fusion groups"
            bundle_warning = (
                f"plan {'bundle' if bundle is not None else 'spec'} carries a "
                f"searched activation plan ({what}); the arena executor runs "
                f"the decode step in program order (ROADMAP A24), so planned "
                f"at construction instead")
            bundle = resolved = None

        def fallback(warning: str) -> None:
            nonlocal bundle, resolved, bundle_warning
            bundle, resolved, bundle_warning = None, None, warning

        # residency off: the decode program is built (and traced) on meta,
        # for the accounting plan only, and the pytree backend serves
        resident = residency_enabled(state_residency)
        if resident:
            prog_model, prog_params, prog_device = self.model, params, self.device
        else:
            prog_model = DecoderModel(cfg, "meta", cores=cores)
            prog_params, prog_device = prog_model.init(None), "meta"

        # --- cross-step state: the bundle's layout, or the state planned
        # here (counted); then the ONE buffer and the decode step over it
        program = state_plan_s = None
        if resolved is not None and resolved.state is not None:
            try:
                program = decode_program(prog_model, prog_params, resolved.state,
                                         n_slots=n_slots, max_len=self.max_len,
                                         device=prog_device)
            except (TypeError, ValueError) as e:
                fallback(f"plan bundle unusable (its state plan does not bind "
                         f"this cache: {e}); planned at construction instead")
        state_from_source = program is not None

        def program_here() -> DecodeProgram:
            nonlocal state_plan_s
            t0 = time.perf_counter()
            sp = plan_state_half(self.model, n_slots=n_slots, max_len=self.max_len,
                                 page_size=self.page_size, page_pool=self.page_pool)
            state_plan_s = time.perf_counter() - t0
            if program is not None and state_plan_to_obj(sp) == state_plan_to_obj(
                    program.residency.state_plan):
                return program
            return decode_program(prog_model, prog_params, sp, n_slots=n_slots,
                                  max_len=self.max_len, device=prog_device)

        if program is None:
            program = program_here()

        # --- the bundle's AOT decode program (resident backends only: the
        # pytree step has no entry). A refused pack warns one line and the
        # step is traced as without one
        aot: dict[str, FxTrace] = {}
        trace = aot_warning = aot_load_s = None
        if resident and bundle is not None and bundle.executables is not None:
            t0 = time.perf_counter()
            aot, aot_warning = load_executables(bundle, device=self.device)
            aot_load_s = time.perf_counter() - t0
            trace = aot.get(decode_entry(isinstance(resolved.state, PagedStatePlan)))
            why = trace is not None and inputs_mismatch(trace, program.args)
            if why:
                aot, trace, aot_warning = {}, None, (
                    f"AOT executable does not take this engine's step ({why}); "
                    f"falling back to tracing the decode step")
            if aot_warning:
                warnings.warn(aot_warning, RuntimeWarning, stacklevel=2)
        verify = self.session is not None and self.session.verify_graph
        trace_s = 0.0

        def traced(prog: DecodeProgram) -> FxTrace:
            nonlocal trace_s
            t0 = time.perf_counter()
            tr = prog.trace()
            trace_s += time.perf_counter() - t0
            return tr

        # --- activation half: the loaded program, or the decode step traced
        # ONCE (fake tensors: nothing runs, nothing is allocated) into the
        # executor's program. A bundle's plan is used only if the trace is
        # the graph it was compiled from (structural fingerprint; a loaded
        # program was held against it at load, a fresh trace is held here),
        # a spec's only if it covers the trace's records
        if trace is None or verify:
            fresh_trace = traced(program)
            trace = trace or fresh_trace
            if resolved is not None and resolved.activation is not None:
                if bundle is not None:
                    fresh = graph_fingerprint(fresh_trace.graph)
                    if bundle.graph_fingerprint != fresh:
                        fallback(
                            f"plan bundle graph fingerprint mismatch (bundle "
                            f"{str(bundle.graph_fingerprint)[:12]}, traced "
                            f"{fresh[:12]} — model code changed since compile?); "
                            f"planned at construction instead")
                        aot, trace = {}, fresh_trace
                elif plan_io.canonical_records(resolved.activation.records) != \
                        plan_io.canonical_records(fresh_trace.graph.usage_records()):
                    fallback("plan spec's activation plan does not cover the traced "
                             "decode step's records; planned at construction instead")
                if resolved is None and state_from_source:
                    # both halves fall back: the state is laid out here too,
                    # and the program stands if that layout is the bundle's
                    replanned = program_here()
                    if replanned is not program:
                        program, trace = replanned, traced(replanned)
        activation = resolved.activation if resolved is not None else None
        state_plan = program.residency.state_plan
        self.state_layout = program.residency.arena.layout
        strategy = spec.strategy if spec is not None else "auto"
        if resident:
            self.residency, self.state = program.residency, program.state
            self.executor = ArenaExecutor(
                program.fn, *program.args, device=self.device, name=program.name,
                trace=trace, plan=activation, strategy=strategy,
            )
            plan = self.executor.plan
            self.activation_arena = self.executor.arena
            step_params = program.params
        else:
            if isinstance(state_plan, PagedStatePlan):
                # the pytree backend has no page indirection: tokens are the
                # same, the state is symmetric and the page plan accounting
                warnings.warn(
                    "paged state requires state residency; serving the "
                    "symmetric allocator-owned pytree backend instead",
                    RuntimeWarning, stacklevel=2)
            # nothing runs in an activation arena: the plan is accounting
            self.residency = self.executor = self.activation_arena = None
            plan = activation if activation is not None else plan_graph(
                trace.graph, mode="offsets", strategy=strategy, alignment=64)
            self.state = PytreeState(self.model, n_slots=n_slots,
                                     max_len=self.max_len, device=self.device)
            step_params = _sorted_keys(params)
        self.decode_graph = trace.graph
        if bundle is not None:
            plan_source = "bundle"
        else:
            plan_source = "cache" if plan.cache_hit else "planned"
        self.plan_bundle = bundle
        # both halves under one fingerprint: the config-level one, shared
        # with the bundle compiled for this bucket
        self.unified_plan = unified.UnifiedPlan(
            activation=plan, state=state_plan,
            fingerprint=(
                resolved.fingerprint if resolved is not None
                else decode_fingerprint(cfg, n_slots=n_slots, max_len=self.max_len,
                                        serve_params=self._serve_params,
                                        cores=cores)
            ),
        )
        lint_s = lint_findings = None
        lint_warnings: tuple[str, ...] = ()
        if (
            startup_lint
            if startup_lint is not None
            else os.environ.get("REPRO_STARTUP_LINT", "").lower()
            in ("1", "on", "true")
        ):
            t0 = time.perf_counter()
            report = Report().extend(
                soundness.certify_unified(
                    self.unified_plan, label=f"{cfg.name}-startup"
                ),
                checked=f"{cfg.name}-startup",
            )
            lint_s, lint_findings = time.perf_counter() - t0, len(report.findings)
            lint_warnings = tuple(f.code for f in report.warnings)
            if not report.ok():
                raise LintGateError(
                    report, context="startup lint refused the unified plan"
                )

        # --- the steps: static inputs, and on the card their CUDA graphs
        model = self.model
        self._token_sampler = TokenSampler(self.sampling, max_len=self.max_len)
        t0 = time.perf_counter()
        self.state.start(self.executor, step_params, model.rope_tables,
                         self._token_sampler, n_slots=n_slots,
                         block_size=self.block_size)
        capture_s = time.perf_counter() - t0
        captured = list(self.state.graphs.values())
        stats = self.executor.stats if self.executor is not None else None
        self._memory_report = MemoryReport(
            activation_plan=plan,
            cache_bytes_per_slot=0 if self.paged else state_plan.bytes_per_slot,
            n_slots=n_slots,
            state_plan=state_plan,
            state_live_bytes=self.state.live_bytes,
            plan_source=plan_source,
            bundle_warning=bundle_warning,
            plan_resolve_s=resolution.resolve_s if resolution is not None else None,
            graph_pool_bytes=(self.state.pool.reserved_bytes()
                              if self.state.pool is not None else None),
            graph_capture_peak_bytes=(max(g.capture_peak_bytes for g in captured)
                                      if captured else None),
            executor_in_place=stats.n_in_place if stats is not None else 0,
            executor_copied=stats.n_copied if stats is not None else 0,
            capture_calls=len(captured),
            capture_s=capture_s if captured else None,
            startup_lint_s=lint_s,
            state_plan_s=state_plan_s,
            startup_lint_findings=lint_findings,
            startup_lint_warnings=lint_warnings,
            state_pages_total=self.state.pages_total if self.paged else None,
            state_pages_live=0 if self.paged else None,
            state_page_size=self.page_size if self.paged else None,
            state_residency=self.state.residency,
            aot_executables=tuple(sorted(aot)),
            aot_warning=aot_warning,
            aot_load_s=aot_load_s,
            trace_s=trace_s or None,
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
        """The live cache structure: views into the one state buffer, or
        under paging the caches gathered through the page table."""
        return self.state.caches

    @property
    def paged(self) -> bool:
        """Whether the paged backend serves (a paged bucket with residency
        off serves the symmetric pytree backend)."""
        return isinstance(self.state, PagedResidentState)

    @property
    def memory_report(self) -> MemoryReport:
        """The planned-vs-live report. Under paging the live fields are
        refreshed on access: ``cache_bytes_per_slot`` is the live-page
        bytes per active slot, and ``state_pages_live`` and
        ``state_live_bytes`` follow the pool."""
        rep = self._memory_report
        if not self.paged:
            return rep
        return dataclasses.replace(
            rep,
            cache_bytes_per_slot=self.state.live_bytes // max(len(self._active), 1),
            state_pages_live=self.state.pages_live,
            state_live_bytes=self.state.live_bytes,
        )

    @property
    def page_log(self) -> list[tuple[int, int, int, int]]:
        """Page occupancy intervals ``(page, admitted_wave, finished_wave,
        request_id)``, the page-granular twin of ``slot_log`` (empty on
        the symmetric backend), audited by ``shared_objects.from_page_log``."""
        return list(getattr(self.state, "page_log", []))

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
            if self.paged:
                # allocate before admitting: map the pages the head request
                # needs (its cache never grows past prompt + budget, capped
                # by the bucket) before touching any slot state. A refused
                # allocation changes nothing: with active slots, admission
                # waits for a retirement (FIFO head of line, so the schedule
                # stays deterministic); with none, the whole pool is free,
                # the request can never fit, and the error propagates
                req = self._queue[0]
                needed = min(len(req.prompt) + req.max_new_tokens, self.max_len)
                try:
                    self.state.allocate_slot(free[0], needed, rid=req.request_id,
                                             wave=self._wave)
                except PagedOutOfPagesError:
                    if self._active:
                        break
                    raise
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
                if self.paged:
                    self.state.free_slot(slot, self._wave)
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
                    if self.paged:
                        self.state.free_slot(slot, wave)
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
