"""Multi-device dry run: one rank's program of every (arch × shape × mesh).

Counterpart of the reference's ``launch/dryrun.py``, device-free as that
one is. The reference forces 512 placeholder CPU devices, compiles the
sharded step with XLA and reads ``memory_analysis()`` and the HLO. Here
one process stands for every rank of the production mesh through the
fake process group (``launch/mesh.init_mesh(..., backend="fake")``,
made in ``run_one``, never at import), and the step is traced with
``make_fx`` on fake tensors: nothing is materialised.

    single pod : (data=16, model=16)        = 256 cards
    multi-pod  : (pod=2, data=16, model=16) = 512 cards

``build_step(arch, shape_name, mesh)`` returns a ``Step``: a function of
one rank's local shards, the meta local inputs, their partition specs
(``launch/mesh.ShardingCtx``, the reference's rules) and their global
shapes. Inside, the function wraps its inputs with ``DTensor.from_local``,
runs the model on DTensors with ``constrain = ctx.constrain`` at the
reference's sites (under ``mesh.sharded_ops``), and returns local
tensors (``.to_local()``). Its three kinds:

* train: forward, ``torch.autograd.grad``, and AdamW on the local shards
  with the global grad norm summed over the ranks (a sharded DTensor's
  rows are never sliced: that would gather it); each period is
  recomputed in the backward (``remat``, as the reference's dry run),
  its recompute under the same steering as the forward;
* prefill: logits and the caches at the reference's cache shardings;
* decode: one token; the cache is written in place on each rank's shard,
  the counterpart of the reference's donated cache.

The same functions run on real shards (``Step.shard`` splits full
tensors; ``Step.gather`` joins the outputs), on gloo ranks on the CPU
and on NCCL ranks on the card.

``run_one`` traces the step and prints the reference's row where its keys
mean something (``launch/roofline.Roofline.row``: the counts of
``launch/fx_analysis.analyze`` over the per-device graph). What stands in
for the keys it drops:

* ``temp_gb`` (XLA's temporaries) -> ``planned_act_gb``: the per-device
  graph through ``trace/fx_liveness`` and
  ``plan_graph(mode="offsets", strategy="auto")``;
* ``arg_gb``: the local params, optimizer state, cache and batch (split
  into ``param_gb``, ``opt_gb``, ``cache_gb`` and ``batch_gb``);
* ``peak_mem_gb``: the two added; ``largest_tensors``: the ten largest
  kinds of tensor the rank's program makes (``[bytes, op, shape, dtype,
  count]``), and ``remat`` whether a train step recomputes its periods;
* ``xla_flops_per_dev`` / ``xla_bytes_per_dev`` -> ``hlo_gflops`` /
  ``hbm_gb``, counted over the traced graph (no XLA here);
* ``attention_core``: the attention cores the traced step's layers took
  (``models/attention.CORES``, read after the trace): in decode
  ``"kernel"`` (``flash_decode`` on its shard), or ``"kernel:
  context-parallel"`` where the ``kv_heads`` rule splits the cache's T
  (K/V heads that do not divide ``model``): ``flash_decode_lse`` on each
  rank's span, merged across the ranks; ``"plain"`` in train and
  prefill (the chunked attention); ``"none"`` without attention.

``--activation-plan`` adds the reference's planner keys (and, for decode,
the state plan); ``--search`` the order/fusion search.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch nemotron-4-340b \\
        --shape decode_32k [--multi-pod] [--activation-plan] [--json out.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --activation-plan
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import sys
import time
import traceback
from typing import Any, Callable

import torch

from repro_torch.configs.base import ARCH_IDS, ArchConfig, get_config
from repro_torch.launch import fx_analysis
from repro_torch.launch.mesh import (ShardingCtx, clear_sharding_caches,
                                     contiguous_stride, make_production_mesh,
                                     make_test_mesh, sharded_ops)
from repro_torch.launch.roofline import Roofline, model_flops
from repro_torch.launch.train import make_loss_fn, value_and_grad
from repro_torch.models import attention
from repro_torch.models.api import INPUT_SHAPES, ShapeSpec, for_config
from repro_torch.optim import adamw
from repro_torch.tree_util import leaves, tree_map


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


@dataclasses.dataclass
class Step:
    """One sharded step: ``fn(*local_inputs)`` -> local outputs."""

    kind: str
    fn: Callable
    inputs: tuple  # one rank's shards, on meta
    specs: tuple  # the inputs' partition specs, same trees
    shapes: tuple  # the inputs' global tensors, on meta
    ctx: ShardingCtx
    remat: bool = False  # a train step recomputes each period in its backward
    out_placements: Any = None  # the last call's outputs: (placements, shape)

    @property
    def mesh(self):
        return self.ctx.mesh

    def shard(self, full: tuple) -> tuple:
        """This rank's shards of ``full`` (trees like ``shapes``), copies
        of their own (a train step updates its shards in place, and a
        replicated shard would otherwise be ``full``'s tensor itself)."""
        return tuple(self.shard_input(i, t) for i, t in enumerate(full))

    def shard_input(self, i: int, full):
        """This rank's shards of the step's input ``i`` alone (the next
        token and positions of a decode step whose cache stays)."""
        from torch.distributed.tensor import distribute_tensor

        def one(t, s, g):
            if tuple(t.shape) != tuple(g.shape):
                raise ValueError(f"a {tuple(t.shape)} tensor for a step input of "
                                 f"{tuple(g.shape)}")
            return distribute_tensor(t, self.mesh, self.ctx.placements(s)
                                     ).to_local().clone()

        return tree_map(one, full, self.specs[i], self.shapes[i])

    def gather(self, out):
        """The whole tensors of the outputs ``fn`` returned (a collective:
        every rank calls it)."""
        from torch.distributed.tensor import DTensor

        def whole(t, where):
            placements, shape = where
            if not placements:  # a plain tensor: the same on every rank
                return t
            return DTensor.from_local(t, self.mesh, placements, run_check=False,
                                      shape=shape, stride=contiguous_stride(shape)
                                      ).full_tensor()

        return tree_map(whole, out, self.out_placements)


def _record(out):
    """Local tensors of DTensor outputs, and their (placements, shape)."""
    from torch.distributed.tensor import DTensor

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    def where(t):
        if isinstance(t, DTensor):
            return (tuple(t.placements), tuple(t.shape))
        return ((), tuple(t.shape))

    return tree_map(local, out), tree_map(where, out)


def cores_taken(counts) -> str:
    """The attention cores a step's layers took (``attention.CORES`` read
    after it), joined; ``"none"`` where no layer attends."""
    return " + ".join(sorted(counts)) or "none"


def build_step(arch: str, shape_name: str, mesh, *, seq_parallel: bool = False,
               cfg: ArchConfig | None = None, shape: ShapeSpec | None = None,
               device="meta", opt_cfg: adamw.AdamWConfig | None = None,
               remat: bool = True):
    """Returns (Step, None) or (None, reason). ``cfg`` and ``shape``
    override the registry's (reduced configs and small shapes in tests);
    ``device`` holds the model's constant tables (``meta`` for the dry
    run, the card or the CPU for a real run); ``remat`` recomputes each
    period of a train step in its backward, as the reference's
    ``make_train_step(..., remat=True)``."""
    from torch.distributed.tensor import DTensor

    clear_sharding_caches()
    cfg = cfg or get_config(arch)
    shape = shape or INPUT_SHAPES[shape_name]
    model = for_config(cfg, device)
    ok, why = model.supports_shape(shape)
    if not ok:
        return None, why
    ctx = ShardingCtx(mesh, cfg, seq_parallel=seq_parallel)
    constrain = ctx.constrain
    meta = for_config(cfg, "meta")
    params = meta.init(None)
    p_specs = ctx.param_shardings(params)
    tables = model.rope_tables
    t_specs = ctx.replicated(tables)

    def local(t, spec):
        return torch.empty(ctx.local_shape(t.shape, spec), dtype=t.dtype,
                           device="meta")

    def wrap(tree, specs, shapes):
        return tree_map(lambda t, s, g: DTensor.from_local(
            t, mesh, ctx.placements(s), run_check=False, shape=g.shape,
            stride=contiguous_stride(g.shape)), tree, specs, shapes)

    B = shape.global_batch
    if shape.kind == "train":
        opt_cfg = opt_cfg or adamw.AdamWConfig()
        batch = meta.input_specs(shape)
        opt = adamw.init_state(params)
        o_specs = {"step": (), "m": p_specs, "v": p_specs}
        b_specs = ctx.batch_shardings(batch)
        shapes = (params, opt, batch, tables)
        specs = (p_specs, o_specs, b_specs, t_specs)

        def train_step(params_l, opt_l, batch_l, tables_l):
            p = wrap(params_l, p_specs, params)
            b = wrap(batch_l, b_specs, batch)
            tb = wrap(tables_l, t_specs, tables)
            with sharded_ops():
                # the recompute re-enters this mode (models/layers.remat_call)
                loss_fn = make_loss_fn(model, remat, constrain, **tb)
                loss, metrics, grads = value_and_grad(loss_fn, p, b)
                # each gradient on its param's shards (pending sums reduced)
                grads = tree_map(lambda g, s: g.redistribute(mesh, ctx.placements(s)),
                                 grads, p_specs)
                sq = None
                for g in leaves(grads):
                    part = torch.sum(torch.square(g.float()))
                    sq = part if sq is None else sq + part
                gnorm = torch.sqrt(sq.full_tensor())
                metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                           for k, v in {"loss": loss, **metrics}.items()}
            grads_l = tree_map(lambda g: g.to_local(), grads)
            new_p, new_o, om = adamw.apply_updates(opt_cfg, params_l, grads_l, opt_l,
                                                   gnorm=gnorm)
            out = (new_p, new_o, {**metrics, **om})
            step.out_placements = (
                tree_map(lambda t, s: (ctx.placements(s), tuple(t.shape)), params,
                         p_specs),
                tree_map(lambda t, s: (ctx.placements(s), tuple(t.shape)), opt,
                         o_specs),
                tree_map(lambda t: ((), tuple(t.shape)), out[2]))
            return out

        fn = train_step
    elif shape.kind == "prefill":
        batch = meta.input_specs(shape)
        b_specs = ctx.batch_shardings(batch)
        shapes = (params, batch, tables)
        specs = (p_specs, b_specs, t_specs)

        def prefill_step(params_l, batch_l, tables_l):
            p = wrap(params_l, p_specs, params)
            b = wrap(batch_l, b_specs, batch)
            tb = wrap(tables_l, t_specs, tables)
            with sharded_ops():
                logits, caches = model.prefill(p, b, constrain=constrain, **tb)
                c_specs = ctx.cache_shardings(caches)
                caches = tree_map(lambda c, s: c.redistribute(mesh, ctx.placements(s)),
                                  caches, c_specs)
            out, step.out_placements = _record((logits, caches))
            return out

        fn = prefill_step
    else:
        caches = meta.init_cache(B, shape.seq_len, device="meta")
        c_specs = ctx.cache_shardings(caches)
        token = torch.empty((B, 1), dtype=torch.int32, device="meta")
        pos = torch.empty((B,), dtype=torch.int32, device="meta")
        active = torch.empty((B,), dtype=torch.bool, device="meta")
        vec = ctx.batch_shardings(pos)
        shapes = (params, token, caches, pos, active, tables)
        specs = (p_specs, ctx.batch_shardings(token), c_specs, vec, vec, t_specs)

        def serve_step(params_l, token_l, caches_l, pos_l, active_l, tables_l):
            args = [wrap(t, s, g) for t, s, g in zip(
                (params_l, token_l, caches_l, pos_l, active_l, tables_l), specs, shapes)]
            p, tok, c, ps, act, tb = args
            with sharded_ops():
                logits, _ = model.decode_step(p, tok, c, ps, act, constrain=constrain,
                                              **tb)
            out, step.out_placements = _record(logits)
            return out

        fn = serve_step
    inputs = tuple(tree_map(local, g, s) for g, s in zip(shapes, specs))
    step = Step(shape.kind, fn, inputs, specs, shapes, ctx,
                remat=remat and shape.kind == "train")
    return step, None


def trace_step(step: Step):
    """``make_fx`` of the step over fake tensors (gradients on for train):
    one rank's aten program with its collectives, without dead nodes."""
    from torch.fx.experimental.proxy_tensor import make_fx

    with torch.set_grad_enabled(step.kind == "train"):
        gm = make_fx(step.fn, tracing_mode="fake")(*step.inputs)
    # DTensor's own bookkeeping may trace tensors nothing reads (on torch
    # 2.11, an empty tensor of a cache's global shape per wrap): not the
    # rank's memory. In-place writes and collectives are kept.
    gm.graph.eliminate_dead_code()
    gm.recompile()
    return gm


def planner_report(graph, plan, search: bool = False, state_pytree=None,
                   n_slots: int | None = None, max_len: int = 0) -> dict:
    """The reference's planner keys of ``plan``, the paper's planner over
    the per-device ``graph``; for decode the cross-step cache is laid out
    too."""
    out = {
        "planner_total_gb": plan.total_size / 1e9,
        "planner_lb_gb": plan.lower_bound / 1e9,
        "planner_naive_gb": plan.naive_size / 1e9,
        "planner_strategy": plan.strategy,
        "planner_records": len(plan.records),
        "plan_cache_hit": plan.cache_hit,
        "plan_wall_s": plan.plan_wall_s,
    }
    if state_pytree is not None and n_slots:
        from repro_torch.core.unified import plan_state, state_records_from_cache

        records = state_records_from_cache(state_pytree, n_slots=n_slots)
        state = plan_state(records, n_slots=n_slots, max_len=max_len)
        live = sum(r.nbytes for r in records)
        out.update({
            "state_total_gb": state.total_size / 1e9,
            "state_live_gb": live / 1e9,
            "state_plan_overhead": round(state.total_size / max(live, 1), 6),
            "state_leaves": len(state.leaves),
            "unified_total_gb": (plan.total_size + state.total_size) / 1e9,
        })
    if search:
        from repro_torch.core.fusion_search import fusion_search
        from repro_torch.core.order_search import search_order
        from repro_torch.core.plan_io import PlanCache

        cache = PlanCache()
        order_res = search_order(graph, iters=300, seed=0, cache=cache)
        fusion_res = fusion_search(graph, max_rounds=40, cache=cache)
        best = min(order_res.plan.total_size, fusion_res.plan.total_size)
        hits = order_res.cache_hits + fusion_res.cache_hits
        evals = hits + order_res.cache_misses + fusion_res.cache_misses
        out.update({
            "searched_total_gb": best / 1e9,
            "search_delta_gb": (plan.total_size - best) / 1e9,
            "search_fused_groups": fusion_res.n_fused_groups,
            "search_plan_calls": evals,
            "search_cache_hit_rate": round(hits / max(evals, 1), 4),
            "search_wall_s": round(order_res.wall_s + fusion_res.wall_s, 3),
        })
    return out


def largest_tensors(trace, n: int = 10) -> list[list]:
    """The ``n`` largest kinds of tensor one rank's traced program makes
    (views, inputs and outputs aside), largest first: ``[bytes, op,
    shape, dtype, count]``, the tensors of one op, shape and dtype
    counted together."""
    op = {tid: str(node.target) for node, tids in trace.produced.items()
          for tid in tids}
    g = trace.graph
    kinds = collections.Counter(
        (t.nbytes, op[tid], tuple(t.shape), t.dtype) for tid, t in g.tensors.items()
        if tid in op and tid not in g.boundary_ids)
    top = sorted(kinds.items(), key=lambda kv: (-kv[0][0], kv[0][1], kv[0][2]))[:n]
    return [[nbytes, o, list(shape), dt, count]
            for (nbytes, o, shape, dt), count in top]


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            seq_parallel: bool = False, activation_plan: bool = False,
            search: bool = False, *, cfg: ArchConfig | None = None,
            shape: ShapeSpec | None = None, mesh_shape=None,
            remat: bool = True, on_graph: Callable | None = None) -> dict:
    """One row: trace the sharded step of ``arch`` at ``shape_name`` on the
    production mesh (or ``mesh_shape``: ``(sizes, axes)``) and count it;
    a train step recomputes its periods in the backward unless ``remat``
    is false. ``on_graph(gm)``, if given, sees the traced program."""
    if mesh_shape is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    else:
        mesh = make_test_mesh(*mesh_shape, backend="fake")
    sizes = tuple(mesh.shape)
    mesh_name = "x".join(str(s) for s in sizes)
    t0 = time.perf_counter()
    cfg = cfg or get_config(arch)
    shape = shape or INPUT_SHAPES[shape_name]
    step, why = build_step(arch, shape_name, mesh, seq_parallel=seq_parallel,
                           cfg=cfg, shape=shape, remat=remat)
    if step is None:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    attention.CORES.clear()
    gm = trace_step(step)
    core = cores_taken(attention.CORES)
    if on_graph is not None:
        on_graph(gm)
    cost = fx_analysis.analyze(gm)
    n_dev = math.prod(sizes)
    parts = {"param": _nbytes(step.inputs[0]), "opt": 0, "cache": 0, "batch": 0}
    if step.kind == "train":
        parts["opt"] = _nbytes(step.inputs[1])
        parts["batch"] = _nbytes(step.inputs[2])
    elif step.kind == "prefill":
        parts["batch"] = _nbytes(step.inputs[1])
    else:
        parts["cache"] = _nbytes(step.inputs[2])
        parts["batch"] = _nbytes((step.inputs[1], step.inputs[3], step.inputs[4]))
    arg = sum(parts.values()) + _nbytes(step.inputs[-1])
    from repro_torch.core.planner import plan_graph
    from repro_torch.trace.fx_liveness import trace_from_graph_module

    name = f"{arch}-{shape_name}-{mesh_name}"
    trace = trace_from_graph_module(gm, name=name)
    graph = trace.graph
    plan = plan_graph(graph, mode="offsets", strategy="auto")
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    out_vals = [a.meta.get("val") for a in out_node.all_input_nodes]
    out_b = sum(v.numel() * v.element_size() for v in out_vals
                if isinstance(v, torch.Tensor))
    rl = Roofline(arch=arch, shape=shape_name, mesh=mesh_name, flops=cost.flops,
                  bytes_accessed=cost.bytes, collective_bytes=cost.collective_bytes,
                  collectives=cost, model_flops=model_flops(cfg, shape) / n_dev,
                  peak_memory_bytes=float(arg + plan.total_size))
    out = {
        "status": "ok",
        **rl.row(),
        "wall_s": time.perf_counter() - t0,
        "arg_gb": arg / 1e9,
        "param_bytes": parts["param"],
        **{f"{k}_gb": v / 1e9 for k, v in parts.items()},
        "out_gb": out_b / 1e9,
        "planned_act_gb": plan.total_size / 1e9,
        "remat": step.remat,
        "largest_tensors": largest_tensors(trace),
        "attention_core": core,
        "collective_counts": cost.collective_counts,
        "collective_bytes_by_kind": cost.collective_bytes_by_kind,
        "graph_nodes": len(gm.graph.nodes),
    }
    if activation_plan or search:
        try:
            decode = shape.kind == "decode"
            out.update(planner_report(
                graph, plan, search=search,
                state_pytree=step.inputs[2] if decode else None,
                n_slots=_local_batch(step) if decode else None,
                max_len=shape.seq_len))
        except Exception as e:  # a planner failure must not sink the row
            out["planner_error"] = f"{type(e).__name__}: {e}"
    return out


def _local_batch(step: Step) -> int:
    """One rank's slots of a decode step (its token shard's batch)."""
    return step.inputs[1].shape[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--activation-plan", action="store_true",
                    help="add the planner's keys (and the decode state plan)")
    ap.add_argument("--search", action="store_true",
                    help="also run the memory-aware order/fusion search "
                         "over each traced graph (implies --activation-plan)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    combos = []
    if args.all:
        for a in ARCH_IDS:
            for s in INPUT_SHAPES:
                combos.append((a, s, False))
                combos.append((a, s, True))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required (or --all)")
        combos = [(args.arch, args.shape, args.multi_pod)]

    results = []
    for arch, shape, mp in combos:
        try:
            res = run_one(arch, shape, mp, seq_parallel=args.seq_parallel,
                          activation_plan=args.activation_plan, search=args.search)
        except Exception as e:  # a dry-run failure is a bug in the port
            res = {
                "arch": arch, "shape": shape,
                "mesh": "2x16x16" if mp else "16x16",
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:],
            }
        results.append(res)
        print(json.dumps(res, default=str))
        sys.stdout.flush()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1, default=str)
    n_bad = sum(r["status"] == "error" for r in results)
    print(f"# {len(results)} combos, {n_bad} errors", file=sys.stderr)
    sys.exit(1 if n_bad else 0)


if __name__ == "__main__":
    main()
