"""The port's sharded steps on four real ranks against the reference's
unsharded functions.

One spawn of four gloo processes on the CPU (they meet through a
``FileStore`` in ``tmp_path``, never a fixed port) runs, for each of nine
reduced archs and on the meshes (data=2, model=2) and (data=1, model=4),
``launch/dryrun.build_step``'s three steps on real shards: one AdamW
train step (each period recomputed in the backward, as the reference's
dry run builds it; for reduced qwen3 and mamba2 on (1, 4) also the same
step without remat), a prefill, and four decode steps writing the cache in
place on each rank's shard. At model = 4 the reduced K/V heads (2) do not
divide, so the ``kv_heads`` rule splits the cache's T and the decode step
runs ``repro_torch::flash_decode_lse`` on each rank's span and merges the
ranks by their log-sum-exps (context parallel); at model = 2 it runs
``repro_torch::flash_decode`` through its sharding rule (the CPU ops are
their plain versions). Rank 0 gathers the outputs. Meanwhile this process
runs the reference's ``jax.value_and_grad`` of ``make_loss_fn``, its
``prefill`` and four ``decode_step`` calls on the same params (the
reference's, bridged through numpy) and inputs (numpy, seeded).

Bars (PERF.md §2's train bars, fp32: the ranks' reductions reorder
sums): the loss and the grad norm 1e-5 relative; a gradient leaf 1e-4
of its largest entry (read back from AdamW's first moment, which after
one step from zero is (1 - b1) · clip · g); the prefill's last logits and
every cache leaf, and each decode step's logits, 1e-4 of the largest
entry.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_reduced as jax_get_reduced  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models.api import Model  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-0.6b", "mamba2-2.7b", "gemma3-4b", "granite-moe-3b-a800m", "zamba2-7b",
         "internvl2-1b", "seamless-m4t-medium", "nemotron-4-340b",
         "llama4-maverick-400b-a17b"]
MESHES = ["2x2", "1x4"]
# archs whose sharded train step (remat on, as the reference's dry run)
# is also held to the same step without remat, on the mesh where reduced
# qwen3's 2 K/V heads do not divide model (K/V split on T)
REMAT_TWINS = ["qwen3-0.6b", "mamba2-2.7b"]
REMAT_MESH = "1x4"
SEQ, BATCH, CACHE, STEPS = 16, 4, 32, 4
POS = np.array([3, 5, 7, 9], dtype=np.int32)
ACTIVE = np.array([True, True, False, True])
TOL = 1e-4
B1 = 0.9  # AdamWConfig().b1

_WORKER = r"""
import os, sys, torch
import torch.distributed as dist
from repro_torch.configs.base import get_reduced
from repro_torch.launch.dryrun import build_step, cores_taken
from repro_torch.launch.mesh import init_mesh
from repro_torch.models import attention
from repro_torch.models.api import ShapeSpec, for_config
from repro_torch.optim import adamw
from repro_torch.tree_util import tree_map

rank, root = int(sys.argv[1]), sys.argv[2]
REMAT_TWINS, REMAT_MESH = sys.argv[8].split(","), sys.argv[9]
torch.set_num_threads(1)
store = dist.FileStore(os.path.join(root, "store"), 4)
dist.init_process_group("gloo", store=store, rank=rank, world_size=4)
meshes = {"2x2": init_mesh((2, 2), ("data", "model"), "cpu"),
          "1x4": init_mesh((1, 4), ("data", "model"), "cpu")}
S, B, T, N = (int(x) for x in sys.argv[3:7])
opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=20)
for arch in sys.argv[7].split(","):
    data = torch.load(os.path.join(root, f"in_{arch}.pt"))
    cfg = get_reduced(arch)
    model = for_config(cfg, "cpu")
    tables = model.rope_tables
    for name, mesh in meshes.items():
        out = {}
        kw = dict(cfg=cfg, device="cpu", opt_cfg=opt)
        step, _ = build_step(arch, "train", mesh, shape=ShapeSpec("t", S, B, "train"), **kw)
        params = data["params"]
        local = step.shard((params, adamw.init_state(params), data["train"], tables))
        res = step.gather(step.fn(*local))
        out["train"] = {"m": res[1]["m"], "metrics": res[2], "remat": step.remat}
        if arch in REMAT_TWINS and name == REMAT_MESH:  # every activation kept
            step, _ = build_step(arch, "train", mesh, shape=ShapeSpec("t", S, B, "train"),
                                 remat=False, **kw)
            local_twin = step.shard((params, adamw.init_state(params), data["train"], tables))
            out["train_no_remat"] = {"with": res, "without": step.gather(step.fn(*local_twin))}
        step, _ = build_step(arch, "prefill", mesh, shape=ShapeSpec("p", S, B, "prefill"), **kw)
        res = step.gather(step.fn(*step.shard((params, data["prefill"], tables))))
        out["prefill"] = {"logits": res[0], "caches": res[1]}
        step, _ = build_step(arch, "decode", mesh, shape=ShapeSpec("d", T, B, "decode"), **kw)
        cache = model.init_cache(B, T, device="cpu")
        pos, active = data["pos"], data["active"]
        local = list(step.shard((params, data["tokens"][0], cache, pos, active, tables)))
        logits = []
        attention.CORES.clear()
        for i in range(N):
            if i:  # the next token and positions; the cache shards stay
                local[1] = step.shard_input(1, data["tokens"][i])
                local[3] = step.shard_input(3, pos + i)
            logits.append(step.gather(step.fn(*local)))
        out["decode"] = {"logits": logits, "core": cores_taken(attention.CORES)}
        if rank == 0:
            torch.save(out, os.path.join(root, f"out_{arch}_{name}.pt"))
dist.destroy_process_group()
print("done", rank)
"""


def _batch(cfg, seed: int):
    """The step's batch at SEQ positions: a VLM's text is shortened by its
    prefix, as the reference's ``input_specs`` shortens it."""
    text = max(SEQ - cfg.n_prefix_tokens, 1)
    raw = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=text, global_batch=BATCH)
                        ).batch_at(seed)
    rng = np.random.default_rng(seed)
    b = dict(raw)
    if cfg.n_prefix_tokens:
        b["prefix_embeds"] = rng.standard_normal(
            (BATCH, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (BATCH, SEQ // cfg.enc_len_ratio, cfg.d_model)).astype(np.float32)
    return b


def _torch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    refs, procs = {}, []
    inputs = {}
    for arch in ARCHS:
        jcfg, cfg = jax_get_reduced(arch), get_reduced(arch)
        jmodel = Model.for_config(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        np_params = jax.tree_util.tree_map(np.asarray, jparams)
        train_b = _batch(cfg, 0)
        pre_b = {k: v for k, v in _batch(cfg, 1).items() if k != "labels"}
        tokens = np.random.default_rng(7).integers(0, cfg.vocab, (STEPS, BATCH, 1)
                                                   ).astype(np.int32)
        torch.save({"params": params_from_numpy(cfg, np_params, "cpu"),
                    "train": _torch(train_b), "prefill": _torch(pre_b),
                    "tokens": [torch.from_numpy(t) for t in tokens],
                    "pos": torch.from_numpy(POS), "active": torch.from_numpy(ACTIVE)},
                   root / f"in_{arch}.pt")
        inputs[arch] = (jmodel, jparams, train_b, pre_b, tokens)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    args = [str(SEQ), str(BATCH), str(CACHE), str(STEPS), ",".join(ARCHS),
            ",".join(REMAT_TWINS), REMAT_MESH]
    for rank in range(4):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(rank), str(root), *args], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    # the reference's unsharded functions while the ranks run
    for arch, (jmodel, jparams, train_b, pre_b, tokens) in inputs.items():
        loss_fn = jax_train.make_loss_fn(jmodel, remat=False)
        (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in train_b.items()})
        logits, caches = jax.jit(jmodel.prefill)(
            jparams, {k: jnp.asarray(v) for k, v in pre_b.items()})
        cache = jmodel.init_cache(BATCH, CACHE)
        step = jax.jit(lambda p, t, c, pos, a: jmodel.decode_step(p, t, c, pos, active=a))
        dec = []
        for i in range(STEPS):
            lg, cache = step(jparams, jnp.asarray(tokens[i]), cache,
                             jnp.asarray(POS + i), jnp.asarray(ACTIVE))
            dec.append(np.asarray(lg))
        refs[arch] = {"loss": float(loss), "grads": jax.tree_util.tree_leaves(grads),
                      "logits": np.asarray(logits),
                      "caches": jax.tree_util.tree_leaves(caches), "decode": dec}
    errs = []
    for p in procs:
        out, err = p.communicate(timeout=900)
        errs.append(err)
        assert p.returncode == 0, err[-4000:]
    return root, refs


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _leaves(tree):
    from repro_torch.tree_util import leaves

    return leaves(tree)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_the_sharded_train_step_is_the_references(runs, arch, mesh):
    root, refs = runs
    out = torch.load(root / f"out_{arch}_{mesh}.pt")["train"]
    ref = refs[arch]
    met = out["metrics"]
    np.testing.assert_allclose(float(met["loss"]), ref["loss"], rtol=1e-5)
    gnorm = float(np.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float64))))
                              for g in ref["grads"])))
    np.testing.assert_allclose(float(met["grad_norm"]), gnorm, rtol=1e-5)
    scale = min(1.0, 1.0 / (float(met["grad_norm"]) + 1e-9))  # grad_clip 1.0
    m = _leaves(out["m"])
    assert len(m) == len(ref["grads"])
    for i, (mi, g) in enumerate(zip(m, ref["grads"])):
        _close(mi / ((1 - B1) * scale), g, f"grad leaf {i}")


@pytest.mark.parametrize("arch", REMAT_TWINS)
def test_the_sharded_remat_step_is_the_step_without_remat(runs, arch):
    """The recompute runs under the forward's steering: the step with remat
    gives what the step that keeps every activation gives, bit for bit
    expected, else within 1e-6 (PERF.md §2's parity rule)."""
    root, _ = runs
    out = torch.load(root / f"out_{arch}_{REMAT_MESH}.pt")
    assert out["train"]["remat"]
    pair = out["train_no_remat"]
    got, want = _leaves(pair["with"]), _leaves(pair["without"])
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        if not torch.equal(g, w):
            err = float((g.double() - w.double()).abs().max())
            assert err <= 1e-6, (i, err)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_the_sharded_prefill_is_the_references(runs, arch, mesh):
    root, refs = runs
    out = torch.load(root / f"out_{arch}_{mesh}.pt")["prefill"]
    _close(out["logits"], refs[arch]["logits"], "logits")
    caches = _leaves(out["caches"])
    assert len(caches) == len(refs[arch]["caches"])
    for i, (c, w) in enumerate(zip(caches, refs[arch]["caches"])):
        _close(c, w, f"cache leaf {i}")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_four_sharded_decode_steps_are_the_references(runs, arch, mesh):
    root, refs = runs
    out = torch.load(root / f"out_{arch}_{mesh}.pt")["decode"]
    for i, (got, want) in enumerate(zip(out["logits"], refs[arch]["decode"])):
        _close(got, want, f"decode step {i}")
    cfg = get_reduced(arch)
    if cfg.family == "ssm":
        assert out["core"] == "none"
    elif mesh == "1x4" and arch != "zamba2-7b":
        # 2 K/V heads on model = 4: T split, the kernel on each span
        assert out["core"] == "kernel: context-parallel"
    else:
        assert out["core"] == "kernel"
