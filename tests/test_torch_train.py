"""The port's training path against the reference's.

``data/pipeline.py`` (a copy), ``optim/adamw.py``, ``checkpoint/ckpt.py``
and ``launch/train.py`` against ``repro.data``, ``repro.optim``,
``repro.checkpoint`` and ``repro.launch.train``, on the same numpy-seeded
inputs and the reference's params bridged through numpy:
* the token pipeline's batches, for several steps and for 2 hosts;
* ``apply_updates`` over 5 steps, fp32 and bf16 params, a gradient clip
  that bites, warmup and the cosine;
* checkpoints round-trip, and cross between the packages both ways,
  bf16 leaves included; a mismatched tree raises;
* one train step of each of seven reduced archs (dense, SSM, sliding
  window, MoE with drops, hybrid, VLM, enc-dec; fp32): the loss, ce, aux,
  grad_norm, lr and every gradient leaf against ``jax.value_and_grad``
  of the reference's ``make_loss_fn``; the SSM layers' backward is
  ``repro_torch::ssd_chunk``'s registered one;
* 5 train steps from bridged params track the reference's jitted steps;
* ``remat=True`` gives the remat-off gradients;
* ``run_training``'s loss falls and its resume is exact, as
  ``tests/test_substrate.py`` checks the reference's; the CLI.

Tolerances (fp32): losses and metrics 1e-5 relative; a gradient leaf
1e-4 of its largest entry (summation order through a few layers, and the
SSD chunk's prefix sum, which the port takes in float64 and the
reference in fp32); AdamW's fp32 leaves 1e-6, a bf16 leaf one bf16
rounding (2**-8) where the two fp32 updates round to neighbours; params
after 5 steps 1e-4 of the leaf's largest entry plus 1% of the summed lr
(Adam moves an element whose gradients are at the noise level by an
arbitrary share of lr).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jax_ckpt  # noqa: E402
from repro.configs.base import get_reduced as jax_get_reduced  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models.api import Model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.bridge import (opt_state_from_numpy, params_from_numpy,  # noqa: E402
                                tensor_from_numpy, tree_to_numpy)
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.api import for_config  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree_util import leaves, tree_map  # noqa: E402

ARCHS = ["qwen3-0.6b", "mamba2-2.7b", "gemma3-4b", "granite-moe-3b-a800m", "zamba2-7b",
         "internvl2-1b", "seamless-m4t-medium"]
SEQ, BATCH = 32, 2
GRAD_TOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bf16(a: np.ndarray) -> np.ndarray:
    """The raw bits ``tree_to_numpy`` hands back, as the reference's type."""
    return a.view(jnp.bfloat16) if a.dtype == np.uint16 else a


def _cfgs(arch):
    jcfg, cfg = jax_get_reduced(arch), get_reduced(arch)
    if arch == "granite-moe-3b-a800m":
        # capacity below the mean load: the dispatch drops assignments
        jcfg = dataclasses.replace(jcfg, capacity_factor=0.5)
        cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    return jcfg, cfg


def _batches(cfg, step: int, seq=SEQ, batch=BATCH):
    """One pipeline batch for both packages; random (seeded) VLM prefix
    embeddings and audio frames, so every parameter gets a gradient."""
    raw = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
                        ).batch_at(step)
    rng = np.random.default_rng(step)
    b = dict(raw)
    if cfg.n_prefix_tokens:
        b["prefix_embeds"] = rng.standard_normal(
            (batch, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (batch, seq // cfg.enc_len_ratio, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()})


# ------------------------------------------------------------ the pipeline


@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 0), (2, 1)])
def test_pipeline_batches_are_the_references(n_hosts, host_id):
    kw = dict(vocab=512, seq_len=16, global_batch=4, seed=3, n_hosts=n_hosts,
              host_id=host_id)
    got, want = TokenPipeline(DataConfig(**kw)), JaxTokenPipeline(JaxDataConfig(**kw))
    for step in (0, 1, 7, 100):
        g, w = got.batch_at(step), want.batch_at(step)
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    for g, w, _ in zip(got, want, range(3)):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])


# ----------------------------------------------------------------- AdamW


def _tree(rng):
    return {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "stack": (rng.standard_normal((2, 4)).astype(np.float32) * 3,),
            "b16": rng.standard_normal((7,)).astype(np.float32)}


def test_apply_updates_tracks_the_reference_over_5_steps():
    """fp32 and bf16 leaves, gradients whose norm the clip of 0.5 cuts,
    2 warmup steps and the cosine to step 5; params, both moments, the
    step, grad_norm and lr after every step."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=0.5)
    jcfg = jax_adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=0.5)
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jparams = {**{k: jnp.asarray(v) for k, v in p0.items() if k != "stack"},
               "stack": (jnp.asarray(p0["stack"][0]),)}
    jparams["b16"] = jparams["b16"].astype(jnp.bfloat16)
    params = tree_map(lambda a: tensor_from_numpy(a, "cpu"), _np_tree(jparams))
    jstate = jax_adamw.init_state(jparams)
    state = adamw.init_state(params)
    for step in range(5):
        g = _tree(rng)
        jg = {"w": jnp.asarray(g["w"]), "stack": (jnp.asarray(g["stack"][0]),),
              "b16": jnp.asarray(g["b16"]).astype(jnp.bfloat16)}
        tg = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), jg)
        tg["b16"] = tg["b16"].to(torch.bfloat16)
        jparams, jstate, jm = jax_adamw.apply_updates(jcfg, jparams, jg, jstate)
        params, state, m = adamw.apply_updates(cfg, params, tg, state)
        assert float(jm["grad_norm"]) > 0.5  # the clip bites
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert np.float32(m["lr"]) == pytest.approx(np.float32(jm["lr"]), rel=1e-6)
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        for got, want in zip(leaves((params, state["m"], state["v"])),
                             jax.tree_util.tree_leaves((jparams, jstate["m"], jstate["v"]))):
            want = np.asarray(want.astype(jnp.float32))
            tol = 2.0**-8 if got.dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=1e-7)
        assert params["b16"].dtype == torch.bfloat16
        assert state["m"]["b16"].dtype == torch.float32


@pytest.mark.parametrize("step", [0, 1, 2, 5, 7, 10, 11])
def test_schedule_is_the_references_float32(step):
    cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=3, total_steps=10)
    got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = jax_adamw.schedule(jax_adamw.AdamWConfig(lr=3e-4, warmup_steps=3,
                                                    total_steps=10),
                              jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6)


# ----------------------------------------------------------- checkpoints


def _ckpt_trees():
    rng = np.random.default_rng(1)
    jtree = ({"a": jnp.asarray(rng.standard_normal((3, 2)).astype(np.float32)),
              "b": {"c": jnp.asarray(rng.standard_normal(4)).astype(jnp.bfloat16),
                    "d": (jnp.arange(3, dtype=jnp.int32),)}},
             {"step": jnp.asarray(5, jnp.int32)})
    ttree = tree_map(lambda a: torch.from_numpy(np.asarray(a.astype(jnp.float32))), jtree)
    ttree[0]["b"]["c"] = ttree[0]["b"]["c"].to(torch.bfloat16)
    ttree[0]["b"]["d"] = (ttree[0]["b"]["d"][0].to(torch.int32),)
    ttree[1]["step"] = ttree[1]["step"].to(torch.int32)
    return jtree, ttree


def test_checkpoint_round_trip_and_structure(tmp_path):
    _, tree = _ckpt_trees()
    path = os.path.join(tmp_path, "ck")
    ckpt.save(path, tree, meta={"step": 42})
    like = tree_map(torch.zeros_like, tree)
    restored, meta = ckpt.restore(path, like)
    assert meta == {"step": 42}
    for a, b in zip(leaves(restored), leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError):
        ckpt.restore(path, ({"x": tree[0]["a"]}, tree[1]))


def _ref_restore(path, like):
    """The reference's restore: (tree, meta), or the error it raises."""
    try:
        return jax_ckpt.restore(path, like)
    except ValueError as e:  # numpy 2.0 / ml_dtypes 0.5 cannot cast |V2 to bf16
        return repr(e)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """Both packages write the same files for one tree: the same arrays
    (a bf16 leaf as 2-byte void holding its bits) and the same meta with
    the same keys. The port restores the reference's checkpoint, bf16
    included; the reference restores the port's as it restores its own
    (a tree without bf16 leaves; its restore of a bf16 leaf raises on its
    own files too under this numpy, ROADMAP's reference caveats)."""
    jtree, ttree = _ckpt_trees()
    ckpt.save(os.path.join(tmp_path, "port"), ttree, meta={"step": 3})
    jax_ckpt.save(os.path.join(tmp_path, "ref"), jtree, meta={"step": 3})
    with open(os.path.join(tmp_path, "port.npz.meta.json")) as f:
        assert f.read() == open(os.path.join(tmp_path, "ref.npz.meta.json")).read()
    port, ref = (np.load(os.path.join(tmp_path, n + ".npz")) for n in ("port", "ref"))
    assert sorted(port.files) == sorted(ref.files)
    for k in ref.files:
        assert port[k].dtype == ref[k].dtype and port[k].tobytes() == ref[k].tobytes()
    assert ref["arr_1"].dtype == np.dtype("V2")  # ['b']['c'], the bf16 leaf
    np.testing.assert_array_equal(port["arr_1"].view(jnp.bfloat16),
                                  np.asarray(jtree[0]["b"]["c"]))
    got, meta = ckpt.restore(os.path.join(tmp_path, "ref"), tree_map(torch.zeros_like, ttree))
    assert meta == {"step": 3}
    for a, b in zip(leaves(got), leaves(ttree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    like = jax.tree_util.tree_map(jnp.zeros_like, jtree)
    assert str(_ref_restore(os.path.join(tmp_path, "port"), like)) == \
        str(_ref_restore(os.path.join(tmp_path, "ref"), like))
    # without the bf16 leaf the reference restores the port's file
    jtree[0]["b"]["c"] = jtree[0]["b"]["c"].astype(jnp.float32)
    ttree[0]["b"]["c"] = ttree[0]["b"]["c"].float()
    ckpt.save(os.path.join(tmp_path, "port32"), ttree, meta={"step": 4})
    want, meta = jax_ckpt.restore(os.path.join(tmp_path, "port32"),
                                  jax.tree_util.tree_map(jnp.zeros_like, jtree))
    assert meta == {"step": 4}
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -------------------------------------------------- the step, arch by arch


@pytest.fixture(scope="module", params=ARCHS)
def arch_setup(request):
    jcfg, cfg = _cfgs(request.param)
    jmodel = Model.for_config(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, _np_tree(jparams), "cpu")
    return request.param, jcfg, cfg, jmodel, jparams, params


def test_one_train_step_matches_the_reference(arch_setup):
    """loss, ce, aux, grad_norm, lr and every gradient leaf of one step
    against jax.value_and_grad of the reference's make_loss_fn."""
    arch, jcfg, cfg, jmodel, jparams, params = arch_setup
    jb, tb = _batches(cfg, 0)
    jloss_fn = jax_train.make_loss_fn(jmodel, remat=False)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(jparams, jb)
    loss, met, grads = train.value_and_grad(
        train.make_loss_fn(for_config(cfg, "cpu"), remat=False), params, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]), rtol=1e-5, atol=1e-7)
    if arch == "granite-moe-3b-a800m":
        assert float(met["aux"]) > 0
    jpaths = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    got = leaves(grads)
    assert len(got) == len(jpaths)
    for g, (path, w) in zip(got, jpaths):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_TOL * scale, (jax.tree_util.keystr(path), err, scale)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=20)
    _, _, om = adamw.apply_updates(opt, tree_map(torch.clone, params), grads,
                                   adamw.init_state(params))
    _, _, jom = jax_adamw.apply_updates(
        jax_adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=20), jparams, jgrads,
        jax_adamw.init_state(jparams))
    np.testing.assert_allclose(float(om["grad_norm"]), float(jom["grad_norm"]), rtol=1e-5)
    assert float(om["lr"]) == pytest.approx(float(jom["lr"]), rel=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-2.7b"])
def test_five_steps_track_the_references_jitted_steps(arch):
    """make_train_step from the same params and optimizer state (the
    reference's, bridged) over 5 pipeline batches: the losses, grad norms
    and, at the end, every param leaf."""
    jcfg, cfg = _cfgs(arch)
    jmodel = Model.for_config(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jstate = jax_adamw.init_state(jparams)
    params = params_from_numpy(cfg, _np_tree(jparams), "cpu")
    state = opt_state_from_numpy(cfg, _np_tree(jstate), "cpu")
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    jstep = jax.jit(jax_train.make_train_step(jmodel, jax_adamw.AdamWConfig(**opt),
                                              remat=False))
    step = train.make_train_step(for_config(cfg, "cpu"), adamw.AdamWConfig(**opt),
                                 remat=False)
    for i in range(5):
        jb, tb = _batches(cfg, i)
        jparams, jstate, jm = jstep(jparams, jstate, jb)
        params, state, m = step(params, state, tb)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
    assert int(state["step"]) == 5
    # Adam moves an element by up to ~lr a step whatever its gradient's
    # size, so an element whose gradients sit at the noise level may move
    # by other shares of lr in the two packages: 1% of the lr summed
    lr_sum = sum(float(jax_adamw.schedule(jax_adamw.AdamWConfig(**opt), jnp.asarray(t)))
                 for t in range(1, 6))
    for g, w in zip(leaves(params), jax.tree_util.tree_leaves(jparams)):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()) + 1e-2 * lr_sum, err


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b", "seamless-m4t-medium"])
def test_remat_gives_the_remat_off_gradients(arch):
    _, cfg = _cfgs(arch)
    model = for_config(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    _, tb = _batches(cfg, 1)
    out = [train.value_and_grad(train.make_loss_fn(model, remat=r), params, tb)
           for r in (False, True)]
    assert float(out[0][0]) == float(out[1][0])
    for a, b in zip(leaves(out[0][2]), leaves(out[1][2])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_tree_to_numpy_hands_back_the_references_arrays():
    jcfg, cfg = _cfgs("qwen3-0.6b")
    jparams = Model.for_config(dataclasses.replace(jcfg, dtype="bfloat16")).init(
        jax.random.PRNGKey(0))
    params = params_from_numpy(dataclasses.replace(cfg, dtype="bfloat16"),
                               _np_tree(jparams), "cpu")
    back = jax.tree_util.tree_map(_bf16, tree_to_numpy(params))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jparams)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))


# ------------------------------------------------------------- the loop


def test_run_training_loss_decreases():
    hist = train.run_training("qwen3-0.6b", steps=12, seq_len=64, batch=4, device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert set(hist[0]) == {"loss", "ce", "aux", "grad_norm", "lr", "wall_s"}


def test_run_training_checkpoint_resume_is_exact(tmp_path):
    """save at step 4, resume, and match the uninterrupted run within the
    reference's 1e-4; the restored tensors equal the saved ones."""
    path = os.path.join(tmp_path, "ck")
    kw = dict(seq_len=32, batch=2, device="cpu")
    full = train.run_training("qwen3-0.6b", steps=8, **kw)
    saved = {}
    train.run_training("qwen3-0.6b", steps=4, ckpt_path=path, save_every=4, out=saved,
                       **kw)
    like = (saved["params"], saved["opt_state"])
    restored, meta = ckpt.restore(path, tree_map(torch.zeros_like, like))
    assert meta == {"step": 4}
    for a, b in zip(leaves(restored), leaves(like)):
        assert torch.equal(a, b)
    resumed = train.run_training("qwen3-0.6b", steps=8, ckpt_path=path, **kw)
    assert len(resumed) == 4
    for a, b in zip(full[4:], resumed):
        assert abs(a["loss"] - b["loss"]) < 1e-4


@pytest.mark.parametrize("arch", ["internvl2-1b", "seamless-m4t-medium"])
def test_run_training_feeds_the_stub_frontends(arch):
    """zero prefix embeddings (VLM) and zero frames at seq_len //
    enc_len_ratio (enc-dec), as the reference's run_training feeds them."""
    cfg = get_reduced(arch)
    raw = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)).batch_at(0)
    b = train.make_batch(cfg, raw, "cpu")
    if cfg.n_prefix_tokens:
        assert b["prefix_embeds"].shape == (2, cfg.n_prefix_tokens, cfg.d_model)
    else:
        assert b["frames"].shape == (2, 16 // cfg.enc_len_ratio, cfg.d_model)
    hist = train.run_training(arch, steps=2, seq_len=16, batch=2, device="cpu")
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_cli_runs_on_the_cpu_and_needs_the_card_by_default(capsys):
    hist = train.main(["--arch", "qwen3-0.6b", "--device", "cpu", "--steps", "2",
                       "--seq-len", "16", "--batch", "2"])
    assert len(hist) == 2 and "final loss" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "qwen3-0.6b", "--steps", "1"])
