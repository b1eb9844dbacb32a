"""Plan compiler: decode graph -> unified memory plan -> bundle.

Twin of the reference's ``launch/compile.py``, the offline half of the
compile → artifact → serve pipeline. For one ``(arch, n_slots, max_len,
dtype)`` serving bucket it:

1. lays the cross-step state out (``plan_state``, or ``plan_paged_state``
   under ``--page-size``) and traces the decode step the engine serves —
   the same program (``runtime/engine.decode_program``: the same step
   function over views of the flat state buffer, or the pool and page
   table, with the same strides and cores) — on ``meta`` tensors, so
   nothing is drawn, computed or allocated and no device is needed: a
   full-width config compiles on any machine;
2. submits ONE :class:`~repro_torch.core.unified.PlanSpec` to the unified
   facade for the activation half (with ``--search`` also the memory-aware
   order annealing and the fusion search) and, with ``--prefill-len``,
   traces and plans the full-sequence prefill too;
3. gates the result (default on; ``--no-lint`` skips it): the soundness
   certifier proves the activation arena and the state layout
   collision-free, and the bundle self-lint checks fingerprint/shape
   coherence — error findings refuse the publish (``LintGateError``);
4. packs the traced decode program (``runtime/aot.py``: the trace of
   step 1 exported and saved without its example inputs) into the
   bundle's ``executables`` (default on; ``--no-aot`` skips it), behind
   the lint gate, and audits the pack after serialization
   (``analysis/decode_lint.lint_executables``: it loads, it is the
   bundle's graph, no host transfer, the state written in place); error
   findings refuse the publish;
5. publishes a fingerprinted v4 :class:`~repro_torch.core.artifact.PlanBundle`
   into a content-addressed manifest directory that
   ``InferenceEngine(session=PlanSession.from_manifest(dir))`` and
   ``launch/serve.py --plan-bundle`` serve from with no planner call, no
   state layout and, with the pack, no trace.

The reference's XLA temp measurement has no counterpart (the caching
allocator's peak over one step is the engine's
``allocator_step_peak_bytes``). A bundle whose activation plan was
searched (another order, or fusion groups) is published as in the
reference, but an engine refuses it and plans at construction, since its
executor runs program order (ROADMAP A24).

``--all`` sweeps every selected arch × ``--slots-list`` × ``--max-lens``
(× ``--dtypes``) into one manifest.

``trace_prefill_graph`` / ``plan_prefill`` trace and plan the prefill of
ONE request (batch 1) at ``prefill_len`` tokens, VLM prefix included, on
``meta`` tensors; every prefill plan ``plan_prefill`` returns has been
certified by ``analysis/soundness.certify_plan``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.compile --arch qwen3-0.6b \
        --full --slots 8 --max-len 2048 [--page-size 65536 --page-pool 896] \
        [--search] [--no-aot] [--out plan_artifacts/torch]
    PYTHONPATH=src python -m repro_torch.launch.compile --all \
        --slots-list 2 4 --max-lens 64 128 256
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shlex
import sys
import time

import torch

from repro_torch.analysis import bundle_lint, soundness
from repro_torch.analysis.findings import LintGateError, Report
from repro_torch.configs.base import ARCH_IDS, PORTED_ARCH_IDS, ArchConfig, get_config, get_reduced
from repro_torch.core.artifact import (
    BundleManifest,
    PlanBundle,
    bucket_key,
    graph_fingerprint,
    serve_fingerprint,
)
from repro_torch.core.fusion_search import FusionSearchResult
from repro_torch.core.graph import Graph
from repro_torch.core.order_search import OrderSearchResult
from repro_torch.core.plan_io import PlanCache
from repro_torch.core.planner import MemoryPlan, plan_graph
from repro_torch.core.unified import PagedStatePlan, PlanSpec, UnifiedPlan
from repro_torch.core.unified import plan as plan_unified
from repro_torch.models.api import DecoderModel
from repro_torch.trace.fx_liveness import trace_graph

# the port's own manifest: the reference's bucket keys have the same
# format, so one shared directory would let either package's publish
# overwrite the other's entry
DEFAULT_BUNDLE_DIR = "plan_artifacts/torch"


@dataclasses.dataclass
class CompileResult:
    bundle: PlanBundle
    graph: Graph
    unified: UnifiedPlan
    greedy_plan: MemoryPlan
    order_result: OrderSearchResult | None
    fusion_result: FusionSearchResult | None
    wall_s: float

    @property
    def searched_total(self) -> int:
        return self.bundle.plan.total_size

    def summary(self) -> str:
        lines = [self.bundle.summary()]
        if self.order_result is not None and self.fusion_result is not None:
            evals = (
                self.order_result.evaluations + self.fusion_result.evaluations
            )
            hits = (
                self.order_result.cache_hits + self.fusion_result.cache_hits
            )
            lines.append(
                f"search: {evals} plan calls "
                f"({hits / max(evals, 1):.0%} cache hits), "
                f"order {self.order_result.plan.total_size / 2**20:.3f} MiB, "
                f"fused {self.fusion_result.plan.total_size / 2**20:.3f} MiB "
                f"({self.fusion_result.n_fused_groups} groups)"
            )
        lines.append(f"compile wall: {self.wall_s:.2f}s")
        return "\n".join(lines)


def _decode_program(cfg: ArchConfig, *, n_slots: int, max_len: int,
                    page_size: int | None = None, page_pool: int | None = None,
                    cores: str = "kernel"):
    """The engine's decode program for this bucket on ``meta``: the state
    plan (``runtime/engine.plan_state_half``) and the step over its views
    (``runtime/engine.decode_program``), with shape-only parameters."""
    from repro_torch.runtime.engine import decode_program, plan_state_half

    if cfg.family == "audio":
        raise NotImplementedError("compile targets decoder-only archs")
    model = DecoderModel(cfg, "meta", cores=cores)
    state_plan = plan_state_half(model, n_slots=n_slots, max_len=max_len,
                                 page_size=page_size, page_pool=page_pool)
    return decode_program(model, model.init(None), state_plan, n_slots=n_slots,
                          max_len=max_len, device="meta")


def trace_decode_graph(
    cfg: ArchConfig, *, n_slots: int, max_len: int,
    page_size: int | None = None, page_pool: int | None = None,
    cores: str = "kernel",
) -> Graph:
    """Shape-level trace of the decode step on ``meta`` — the graph (hence
    the usage records and the plan) the engine's executor traces with real
    weights on the card, since only shapes, dtypes and strides reach the
    tracer."""
    return _decode_program(cfg, n_slots=n_slots, max_len=max_len,
                           page_size=page_size, page_pool=page_pool,
                           cores=cores).trace().graph


def compile_decode_plan(
    cfg: ArchConfig,
    *,
    n_slots: int,
    max_len: int,
    strategy: str = "auto",
    search: bool = False,
    search_iters: int = 300,
    fusion_rounds: int = 40,
    cache: PlanCache | None = None,
    block_size: int = 1,
    greedy: bool = True,
    temperature: float = 1.0,
    top_k: int = 0,
    page_size: int | None = None,
    page_pool: int | None = None,
    prefill_len: int | None = None,
    lint: bool = True,
    cores: str = "kernel",
    aot: bool = True,
) -> CompileResult:
    """Trace → unified plan (both halves) → lint gate → bundle, in memory.

    ``block_size``/``greedy``/``temperature``/``top_k`` and the paged
    knobs are the serving bucket's serve-loop configuration: they join the
    bundle fingerprint (``artifact.serve_fingerprint``), so a bundle
    compiled for the block path self-invalidates against a host-loop
    engine and vice versa; ``cores`` joins it when not ``"kernel"``. The
    decode body traced for planning is the same graph the block wave
    runs.

    ``prefill_len`` additionally traces and plans the full-sequence
    prefill at that many tokens; ``prefill_len`` then joins the
    fingerprint and the bucket key (``|pf{S}``). ``aot`` packs the traced
    decode program into the bundle (``runtime/aot.py``)."""
    wall0 = time.perf_counter()
    serve_params = serve_fingerprint(
        block_size=block_size, greedy=greedy,
        temperature=temperature, top_k=top_k,
        page_size=page_size, page_pool=page_pool,
    )
    program = _decode_program(cfg, n_slots=n_slots, max_len=max_len,
                              page_size=page_size, page_pool=page_pool, cores=cores)
    trace = program.trace()
    graph = trace.graph
    state_plan = program.residency.state_plan
    prefill_graph = (
        trace_prefill_graph(cfg, prefill_len=prefill_len)
        if prefill_len else None
    )
    # the activation half through the facade; the state half was laid out
    # above, before the trace (the step reads the state through views
    # whose strides come from the layout), so it joins here
    unified = plan_unified(PlanSpec(
        graph=graph,
        cfg=cfg,
        n_slots=n_slots,
        max_len=max_len,
        serve_params=serve_params,
        strategy=strategy,
        search=search,
        search_iters=search_iters,
        fusion_rounds=fusion_rounds,
        cache=cache,
        page_size=page_size,
        page_pool=page_pool,
        prefill_graph=prefill_graph,
        prefill_len=prefill_len,
        cores=cores,
    ))
    provenance = {
        "tool": "repro_torch.launch.compile",
        **unified.provenance,
        "cores": cores,
        "state_total_bytes": state_plan.total_size,
        "state_leaves": len(state_plan.leaves),
    }
    if isinstance(state_plan, PagedStatePlan):
        provenance["page_size"] = state_plan.page_size
        provenance["page_pool"] = state_plan.n_pages_pool
    if serve_params:
        provenance["serve_params"] = serve_params
    unified = dataclasses.replace(unified, state=state_plan, provenance=provenance)
    best_plan = unified.activation
    bundle = PlanBundle(
        fingerprint=unified.fingerprint,
        graph_fingerprint=graph_fingerprint(graph),
        arch=cfg.name,
        n_slots=n_slots,
        max_len=max_len,
        dtype=cfg.dtype,
        plan=best_plan,
        state_plan=state_plan,
        n_layers=cfg.n_layers,
        d_model=cfg.d_model,
        order=unified.order,
        fusion_groups=unified.fusion_groups,
        provenance=provenance,
        prefill_plan=unified.prefill,
        prefill_len=prefill_len or 0,
    )
    if lint:
        # the pre-publish gate: soundness certification (sweep-line,
        # independent of every planner) + bundle self-coherence
        report = Report()
        report.extend(soundness.certify_bundle(bundle), checked="soundness")
        report.extend(
            bundle_lint.lint_bundle(bundle, serve_params=serve_params),
            checked="bundle_lint",
        )
        if not report.ok():
            raise LintGateError(
                report,
                context=f"refusing to publish "
                f"{bucket_key(cfg, n_slots=n_slots, max_len=max_len, page_size=page_size, prefill_len=prefill_len)}",
            )
    if aot:
        # behind the lint gate: an unsound plan is refused before its
        # program is exported
        from repro_torch.runtime.aot import build_decode_executables

        pack = build_decode_executables(cfg, state_plan, n_slots=n_slots,
                                        max_len=max_len, cores=cores,
                                        program=program, trace=trace)
        bundle = dataclasses.replace(bundle, executables=pack)
        if lint:
            # post-serialization audit: the program must load, be the
            # bundle's graph, and keep the step's invariants
            from repro_torch.analysis import decode_lint

            report = Report().extend(decode_lint.lint_executables(bundle),
                                     checked="decode_lint:executables")
            if not report.ok():
                raise LintGateError(
                    report,
                    context=f"refusing to publish AOT executables for "
                    f"{bucket_key(cfg, n_slots=n_slots, max_len=max_len, page_size=page_size, prefill_len=prefill_len)}",
                )
    outcome = unified.search
    return CompileResult(
        bundle=bundle,
        graph=graph,
        unified=unified,
        greedy_plan=outcome.greedy_plan if outcome is not None else best_plan,
        order_result=outcome.order if outcome is not None else None,
        fusion_result=outcome.fusion if outcome is not None else None,
        wall_s=time.perf_counter() - wall0,
    )


def compile_and_publish(
    cfg: ArchConfig,
    out_dir: str,
    *,
    n_slots: int,
    max_len: int,
    command: str | None = None,
    **kwargs,
) -> CompileResult:
    res = compile_decode_plan(cfg, n_slots=n_slots, max_len=max_len, **kwargs)
    BundleManifest(out_dir).publish(
        bucket_key(cfg, n_slots=n_slots, max_len=max_len,
                   page_size=kwargs.get("page_size"),
                   prefill_len=kwargs.get("prefill_len")),
        res.bundle,
        command=command,
    )
    return res


def sweep_buckets(
    archs: list[str],
    out_dir: str,
    *,
    full: bool = False,
    slots_list: list[int],
    max_lens: list[int],
    dtypes: list[str] | None = None,
    command: str | None = None,
    emit=print,
    explicit_archs: bool = False,
    dropped: list | None = None,
    **kwargs,
) -> list[CompileResult]:
    """The fleet sweep behind ``--all``: every (arch × slots × max_len ×
    dtype) bucket into ONE manifest, plans shared through one PlanCache.

    No silent caps: every arch or bucket the sweep drops is logged with
    its reason (and collected into ``dropped`` when the caller passes a
    list — ``(what, reason)`` pairs), and the sweep ends with a one-line
    drop summary. Archs the port does not build (at this width) are
    skipped unless listed explicitly (``explicit_archs=True``): the sweep
    then attempts them, so the drop reason is the real failure."""
    cache = kwargs.pop("cache", None) or PlanCache()
    results: list[CompileResult] = []
    drops: list[tuple[str, str]] = dropped if dropped is not None else []
    for arch in archs:
        try:
            base = get_config(arch) if full else get_reduced(arch)
        except NotImplementedError as e:
            drops.append((arch, str(e)))
            emit(f"skip {arch}: {e}")
            continue
        if base.family == "audio" and not explicit_archs:
            reason = (
                "audio (encoder-decoder) arch — decode compile path is "
                "decoder-only; pass it via --archs to attempt anyway"
            )
            drops.append((arch, reason))
            emit(f"skip {arch}: {reason}")
            continue
        for dtype in dtypes or [base.dtype]:
            cfg = (
                base if dtype == base.dtype
                else dataclasses.replace(base, dtype=dtype)
            )
            for n_slots in slots_list:
                for max_len in max_lens:
                    key = bucket_key(
                        cfg, n_slots=n_slots, max_len=max_len,
                        page_size=kwargs.get("page_size"),
                        prefill_len=kwargs.get("prefill_len"),
                    )
                    try:
                        res = compile_and_publish(
                            cfg, out_dir, n_slots=n_slots, max_len=max_len,
                            command=command, cache=cache, **kwargs,
                        )
                    except NotImplementedError as e:
                        # an un-plannable arch — drop THE BUCKET, loudly
                        drops.append((key, str(e)))
                        emit(f"skip {key}: {e}")
                        continue
                    emit(
                        f"{key}"
                        f": {res.bundle.total_size / 2**20:.3f} MiB unified "
                        f"({res.wall_s:.2f}s)"
                    )
                    results.append(res)
    if drops:
        emit(
            f"dropped {len(drops)} arch(es)/bucket(s): "
            + ", ".join(what for what, _ in drops)
        )
    return results


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="compile decode-graph memory plans into serving bundles "
                    "(traced on meta tensors: no device needed)"
    )
    ap.add_argument("--arch", choices=ARCH_IDS,
                    help="one arch (or use --all)")
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x slots x max-len) bucket into "
                         "one manifest; restrict archs with --archs")
    ap.add_argument("--archs", nargs="*", choices=ARCH_IDS, default=None,
                    help="arch subset for --all (default: every arch the "
                         "port serves)")
    ap.add_argument("--full", action="store_true",
                    help="compile the full config (default: reduced)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--slots-list", type=int, nargs="*", default=None,
                    help="slot counts for --all (default: --slots)")
    ap.add_argument("--max-lens", type=int, nargs="*", default=None,
                    help="max_len grid for --all (default: --max-len)")
    ap.add_argument("--dtypes", nargs="*", default=None,
                    help="dtype overrides for --all (default: each "
                         "config's own dtype)")
    ap.add_argument("--strategy", default="auto")
    ap.add_argument("--search", action="store_true",
                    help="run the order/fusion search on the decode graph")
    ap.add_argument("--iters", type=int, default=300,
                    help="order-search annealing iterations")
    ap.add_argument("--fusion-rounds", type=int, default=40)
    ap.add_argument("--block-size", type=int, default=1,
                    help="serve-loop block size the bundle is compiled "
                         "for (joins the fingerprint; 1 = host loop)")
    ap.add_argument("--sample", action="store_true",
                    help="compile for temperature/top-k sampling instead "
                         "of greedy (joins the fingerprint)")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=None,
                    help="compile a PAGED bucket: carve slot state into "
                         "fixed pages of this many bytes (joins the "
                         "fingerprint and the bucket key)")
    ap.add_argument("--page-pool", type=int, default=None,
                    help="physical pool page count for --page-size "
                         "(default: n_slots x pages-per-slot)")
    ap.add_argument("--prefill-len", type=int, default=None,
                    help="ALSO trace + plan the full-sequence prefill "
                         "activation arena at this many tokens (joins the "
                         "fingerprint and the bucket key as |pf{S}); "
                         "default: decode-only bundle")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the pre-publish static-analysis gate "
                         "(soundness certifier + bundle self-lint)")
    ap.add_argument("--no-aot", action="store_true",
                    help="skip packing the traced decode program into the "
                         "bundle (an engine served from it traces its step)")
    ap.add_argument("--out", default=DEFAULT_BUNDLE_DIR,
                    help="bundle manifest directory")
    ap.add_argument("--json", action="store_true",
                    help="emit a machine-readable summary line")
    args = ap.parse_args(argv)
    if bool(args.arch) == bool(args.all):
        ap.error("pass exactly one of --arch or --all")

    command = shlex.join(sys.argv if argv is None else ["compile", *argv])
    knobs = dict(
        strategy=args.strategy, search=args.search,
        search_iters=args.iters, fusion_rounds=args.fusion_rounds,
        block_size=args.block_size, greedy=not args.sample,
        temperature=args.temperature, top_k=args.top_k,
        page_size=args.page_size, page_pool=args.page_pool,
        prefill_len=args.prefill_len, lint=not args.no_lint,
        aot=not args.no_aot,
    )
    if args.all:
        results = sweep_buckets(
            list(args.archs or PORTED_ARCH_IDS), args.out,
            full=args.full,
            slots_list=args.slots_list or [args.slots],
            max_lens=args.max_lens or [args.max_len],
            dtypes=args.dtypes,
            command=command,
            explicit_archs=args.archs is not None,
            dropped=(dropped := []),
            **knobs,
        )
        print(f"published {len(results)} bucket(s) to {args.out}/")
        if args.json:
            print(json.dumps({
                "buckets": len(results),
                "unified_total_bytes": [r.bundle.total_size for r in results],
                "dropped": dropped,
                "wall_s": round(sum(r.wall_s for r in results), 3),
            }))
        return

    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    res = compile_and_publish(cfg, args.out, n_slots=args.slots,
                              max_len=args.max_len, command=command, **knobs)
    print(res.summary())
    key = bucket_key(cfg, n_slots=args.slots, max_len=args.max_len,
                     page_size=args.page_size, prefill_len=args.prefill_len)
    print(f"published to {args.out}/ (bucket {key})")
    if args.json:
        print(json.dumps({
            "arch": args.arch,
            "full": args.full,
            "n_slots": args.slots,
            "max_len": args.max_len,
            "page_size": args.page_size,
            "prefill_len": args.prefill_len,
            "prefill_total_bytes": (
                res.bundle.prefill_plan.total_size
                if res.bundle.prefill_plan else None
            ),
            "greedy_total_bytes": res.greedy_plan.total_size,
            "bundle_total_bytes": res.bundle.plan.total_size,
            "state_total_bytes": (
                res.bundle.state_plan.total_size
                if res.bundle.state_plan else None
            ),
            "unified_total_bytes": res.bundle.total_size,
            "records": len(res.bundle.plan.records),
            "aot_executables": (sorted(res.bundle.executables.entries)
                                if res.bundle.executables else []),
            "aot_bytes": (res.bundle.executables.nbytes
                          if res.bundle.executables else 0),
            "searched": args.search,
            "wall_s": round(res.wall_s, 3),
        }))


def prefill_batch(cfg: ArchConfig, prefill_len: int, device) -> dict:
    """The batch of one request of ``prefill_len`` positions, zeros on
    ``device``: with a VLM prefix, ``n_prefix_tokens`` embeddings and the
    rest as tokens (at least one), as the reference's ``input_specs``
    counts them (``api.py:97-98``)."""
    P = cfg.n_prefix_tokens
    batch = {"tokens": torch.zeros((1, max(prefill_len - P, 1)), dtype=torch.int64,
                                   device=device)}
    if P:
        batch["prefix_embeds"] = torch.zeros((1, P, cfg.d_model),
                                             dtype=getattr(torch, cfg.dtype),
                                             device=device)
    return batch


def trace_prefill_graph(cfg: ArchConfig, *, prefill_len: int) -> Graph:
    """The usage-record graph of ``Model.prefill`` on one request of
    ``prefill_len`` positions (``prefill_batch``). The graph is the one
    the same call traces with real weights: only shapes and dtypes reach
    the tracer."""
    if prefill_len < 1:
        raise ValueError(f"prefill_len must be >= 1, got {prefill_len}")
    model = DecoderModel(cfg, "meta")
    params = model.init(None)

    def prefill(p, tables, batch):
        return model.prefill(p, batch, **tables)

    return trace_graph(prefill, params, model.rope_tables,
                       prefill_batch(cfg, prefill_len, "meta"),
                       name=f"{cfg.name}-prefill{prefill_len}")


def plan_prefill(cfg: ArchConfig, *, prefill_len: int) -> tuple[Graph, MemoryPlan]:
    """Trace the prefill, plan its activations with the paper's planner
    (offsets mode and the ``auto`` portfolio, as the reference's
    ``--prefill-len``) and certify the plan; findings raise."""
    graph = trace_prefill_graph(cfg, prefill_len=prefill_len)
    plan = plan_graph(graph, mode="offsets", strategy="auto")
    report = Report().extend(soundness.certify_plan(plan), checked=graph.name)
    if not report.ok():
        raise LintGateError(report, context="the prefill plan is not sound")
    return graph, plan


if __name__ == "__main__":
    main()
