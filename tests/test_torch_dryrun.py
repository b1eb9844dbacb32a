"""``repro_torch.launch.dryrun`` without a GPU: every arch's reduced
config through its sharded train, prefill and decode steps on a (2, 4)
fake mesh, and full-width qwen3-0.6b decode_32k on the production
(16, 16) mesh. The fake group is process-global, so ONE subprocess
traces every row and prints them; each arch is a case that reads its
rows; reduced qwen3's train row at S = 128 comes with remat on and off,
and under two planted faults. A row's per-device param bytes must be
the sum of each leaf's local shard under the reference's own
``param_spec`` (``repro.launch.mesh`` on a stub mesh, over the
reference's ``jax.eval_shape`` of its init, in a loop of this file's),
its cache bytes the local cache's, and its activation plan the port's
planner's over the per-device graph."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import base as jax_configs  # noqa: E402
from repro.launch import mesh as jax_mesh  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.launch.mesh import ShardingCtx, map_with_path  # noqa: E402
from repro_torch.models.api import ShapeSpec, for_config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESH = ((2, 4), ("data", "model"))
SMALL = {"train": ShapeSpec("train", 64, 8, "train"),
         "prefill": ShapeSpec("prefill", 64, 8, "prefill"),
         "decode": ShapeSpec("decode", 128, 8, "decode")}

_SCRIPT = """
import json, sys
from repro_torch.configs.base import ARCH_IDS, get_reduced
from repro_torch.launch.dryrun import run_one
from repro_torch.models.api import ShapeSpec
small = {k: ShapeSpec(*v) for k, v in json.loads(sys.argv[1]).items()}
for arch in ARCH_IDS:
    for kind, shape in small.items():
        row = run_one(arch, kind, activation_plan=True, cfg=get_reduced(arch),
                      shape=shape, mesh_shape=((2, 4), ("data", "model")))
        print("ROW " + json.dumps(row, default=str), flush=True)
row = run_one("qwen3-0.6b", "decode_32k", activation_plan=True)
print("ROW " + json.dumps(row, default=str), flush=True)

# reduced qwen3's train step at S = 128 (T != head_dim): its 2 K/V heads do
# not divide model = 4, as qwen3's 8 do not divide 16. The control, then
# two planted faults: the recompute dropped, the split softmax gathered.
import torch
import repro_torch.launch.mesh as mesh_mod
import repro_torch.models.transformer as transformer
cfg, S = get_reduced("qwen3-0.6b"), 128
B_l = 8 // 2  # one rank's batch on data = 2
whole = B_l * cfg.n_heads * S * S

def scan(gm):
    # nodes with every key position last and every query head's rows
    out = []
    for n in gm.graph.nodes:
        v = n.meta.get("val")
        if isinstance(v, torch.Tensor) and v.dim() and v.shape[-1] == S \
                and v.numel() >= whole:
            out.append([str(n.target), list(v.shape)])
    return out

def qwen_row(name, remat=True):
    found = []
    row = run_one("qwen3-0.6b", "train", activation_plan=True, cfg=cfg,
                  shape=ShapeSpec("train", S, 8, "train"),
                  mesh_shape=((2, 4), ("data", "model")), remat=remat,
                  on_graph=lambda gm: found.extend(scan(gm)))
    row["whole_score_nodes"] = found
    print("QWEN " + json.dumps({"case": name, **row}, default=str), flush=True)

qwen_row("control")
qwen_row("control_no_remat", remat=False)
keep = transformer.remat_call
transformer.remat_call = lambda fn, *args: fn(*args)  # dryrun_no_remat
qwen_row("dryrun_no_remat")
transformer.remat_call = keep

class _Gathered:  # dryrun_gather_scores: DTensor's own softmax gathers
    apply = staticmethod(lambda x, dim: torch.softmax(x, dim))

mesh_mod._SplitSoftmax = _Gathered
qwen_row("dryrun_gather_scores")
"""


@pytest.fixture(scope="module")
def rows():
    small = {k: [s.name, s.seq_len, s.global_batch, s.kind] for k, s in SMALL.items()}
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT, json.dumps(small)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = [json.loads(line[4:]) for line in out.stdout.splitlines()
           if line.startswith("ROW ")]
    rows = {(r["arch"], r["shape"], r["mesh"]): r for r in got}
    for line in out.stdout.splitlines():
        if line.startswith("QWEN "):
            r = json.loads(line[5:])
            rows[("qwen3 S=128", r["case"])] = r
    return rows


class _Stub:
    def __init__(self, shape):
        self.shape = shape
        self.size = math.prod(shape.values())


def _reference_param_bytes(jcfg, sizes) -> int:
    """One rank's param bytes under the reference's ``param_spec`` on a
    stub mesh of ``sizes``: rank 0's shard of each leaf (a dim split k
    ways keeps ceil(n / k)) times its item size."""
    ctx = jax_mesh.ShardingCtx(_Stub(sizes), jcfg)
    params = jax.eval_shape(lambda: JaxModel.for_config(jcfg).init(
        jax.random.PRNGKey(0)))
    total = 0
    for p, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
        n = 1
        for dim, e in zip(x.shape, ctx.param_spec(path, x)):
            axes = () if e is None else (e,) if isinstance(e, str) else tuple(e)
            n *= -(-dim // math.prod(sizes[a] for a in axes))
        total += n * x.dtype.itemsize
    return total


def _cache_bytes(ctx, cache) -> int:
    from repro_torch.tree_util import tree_map

    out = []
    tree_map(lambda c, s: out.append(
        math.prod(ctx.local_shape(c.shape, s)) * c.element_size()),
        cache, ctx.cache_shardings(cache))
    return sum(out)


def _check(row, cfg, jcfg, shape, sizes):
    assert row["status"] == "ok", row
    assert "planner_error" not in row, row["planner_error"]
    ctx = ShardingCtx(_Stub(sizes), cfg)
    model = for_config(cfg, "meta")
    params = model.init(None)
    assert row["param_bytes"] == _reference_param_bytes(jcfg, sizes)
    assert row["coll_gb"] > 0 and sum(row["collective_counts"].values()) > 0
    assert row["planned_act_gb"] > 0
    assert row["planner_total_gb"] == row["planned_act_gb"]
    assert row["peak_mem_gb"] == pytest.approx(row["arg_gb"] + row["planned_act_gb"])
    assert row["hlo_gflops"] > 0 and row["hbm_gb"] > 0
    if shape.kind == "train":
        # AdamW's m and v in fp32 on the params' shards, and the step
        n = sum(math.prod(ctx.local_shape(x.shape, ctx.param_spec(p, x)))
                for p, x in _paths(params))
        assert row["opt_gb"] == pytest.approx((8 * n + 4) / 1e9, rel=0, abs=1e-12)
    if shape.kind == "decode":
        cache = model.init_cache(shape.global_batch, shape.seq_len, device="meta")
        cb = _cache_bytes(ctx, cache)
        assert row["cache_gb"] == pytest.approx(cb / 1e9, rel=0, abs=1e-12)
        assert row["state_live_gb"] == pytest.approx(cb / 1e9, rel=0, abs=1e-12)
    return ctx


def _paths(tree):
    out = []
    map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_step_of_the_reduced_arch_on_a_fake_2x4_mesh(rows, arch):
    cfg = get_reduced(arch)
    for kind, shape in SMALL.items():
        row = rows[(arch, kind, "2x4")]
        ctx = _check(row, cfg, jax_configs.get_reduced(arch), shape,
                     {"data": 2, "model": 4})
        core = row["attention_core"]
        if cfg.family == "ssm":
            assert core == "none"
        elif kind != "decode":
            assert core == "plain"
        elif arch == "zamba2-7b":
            # only the shared block attends: its 4 heads divide model = 4
            assert core == "kernel"
        else:
            # reduced K/V heads (2) do not divide model = 4: the kv_heads
            # rule splits T, and each rank runs the kernel on its span
            assert ctx.activation_spec(torch.empty(8, 128, 2, 64, device="meta"),
                                       "kv_heads")[1] == "model"
            assert core == "kernel: context-parallel"


def test_full_width_qwen3_decode_32k_on_16x16(rows):
    row = rows[("qwen3-0.6b", "decode_32k", "16x16")]
    cfg = get_config("qwen3-0.6b")
    ctx = _check(row, cfg, jax_configs.get_config("qwen3-0.6b"),
                 ShapeSpec("decode_32k", 32768, 128, "decode"), {"data": 16, "model": 16})
    # 8 K/V heads on model = 16: context parallel, the kernel on each span
    assert row["attention_core"] == "kernel: context-parallel"
    assert row["dominant"] in ("memory", "collective", "compute")
    # 28 layers of K and V at (8 local slots, 32768, 8 heads, hd / 16), bf16
    hd = cfg.resolved_head_dim // 16
    assert row["cache_gb"] == pytest.approx(28 * 2 * 8 * 32768 * 8 * hd * 2 / 1e9)
    assert ctx.batch_axis_for(128) == ("data",)


def _remat_lowers_the_plan(on: dict, off: dict) -> bool:
    return on["remat"] and not off["remat"] and \
        on["planned_act_gb"] < off["planned_act_gb"]


def _scores_stay_split(row: dict) -> bool:
    return row["attention_core"] == "plain" and not row["whole_score_nodes"]


def test_reduced_qwen3_train_keeps_its_scores_split_and_recomputes(rows):
    """Reduced qwen3's train row on the fake (2, 4) mesh: its 2 K/V heads do
    not divide model = 4 (as qwen3's 8 do not divide 16), so q is split on
    heads and K/V on T. The row reports remat on; no node of the traced
    program holds every query head and every key position of a score
    (the softmax reduces across the T shards); its planned activations
    are below the same row's without remat. Each check fails on the
    planted fault meant for it: the recompute dropped (the plan is the
    one without remat), the split softmax replaced by DTensor's (which
    gathers the scores)."""
    on, off = rows[("qwen3 S=128", "control")], rows[("qwen3 S=128", "control_no_remat")]
    for r in (on, off):
        _check(r, get_reduced("qwen3-0.6b"), jax_configs.get_reduced("qwen3-0.6b"),
               ShapeSpec("train", 128, 8, "train"), {"data": 2, "model": 4})
    assert on["remat"] is True
    assert _remat_lowers_the_plan(on, off), (on["planned_act_gb"], off["planned_act_gb"])
    assert _scores_stay_split(on), on["whole_score_nodes"][:4]
    assert _scores_stay_split(off), off["whole_score_nodes"][:4]
    dropped = rows[("qwen3 S=128", "dryrun_no_remat")]
    assert dropped["remat"] and not _remat_lowers_the_plan(dropped, off)
    gathered = rows[("qwen3 S=128", "dryrun_gather_scores")]
    assert not _scores_stay_split(gathered)
