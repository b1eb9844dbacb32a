"""The port's sharding rules (``repro_torch.launch.mesh``) against the
reference's (``repro.launch.mesh``), rule for rule, on the production
meshes' shapes: every param leaf of the ten archs at full width, every
activation tag over a grid of shapes with and without sequence
parallelism, every family's cache tree, and the DTensor placements a
spec turns into. The rules read only ``mesh.shape``, so both sides run
on stub meshes (as ``tests/test_mesh_rules.py`` does); nothing here makes
a process group."""

from __future__ import annotations

import itertools
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch  # noqa: E402

from repro.configs.base import ARCH_IDS  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.launch import mesh as jax_mesh  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch.mesh import ShardingCtx, map_with_path  # noqa: E402
from repro_torch.models.api import for_config  # noqa: E402
from repro_torch.tree_util import leaves, tree_map  # noqa: E402


class _Stub:
    def __init__(self, shape: dict):
        self.shape = shape
        self.size = 1
        for n in shape.values():
            self.size *= n


MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


class _Arr:
    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(shape)


def _ctxs(arch, mesh, seq_parallel=False):
    return (ShardingCtx(_Stub(MESHES[mesh]), get_config(arch), seq_parallel),
            jax_mesh.ShardingCtx(_Stub(MESHES[mesh]), jax_get_config(arch),
                                 seq_parallel))


def _jax_specs(ctx, tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)

    def path_str(p):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)

    return {path_str(p): tuple(ctx.param_spec(path_str(p), x)) for p, x in flat}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_spec_is_the_references_on_every_leaf(arch, mesh):
    ours, theirs = _ctxs(arch, mesh)
    jparams = jax.eval_shape(lambda: JaxModel.for_config(jax_get_config(arch)).init(
        jax.random.PRNGKey(0)))
    params = for_config(get_config(arch), "meta").init(None)
    got = {}
    map_with_path(lambda p, x: got.__setitem__(p, (ours.param_spec(p, x),
                                                   tuple(x.shape))), params)
    want = _jax_specs(theirs, jparams)
    assert sorted(got) == sorted(want)
    jshapes = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    for p, x in flat:
        jshapes["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)] = \
            tuple(x.shape)
    for path, (spec, shape) in got.items():
        assert shape == jshapes[path], path
        assert spec == want[path], (path, spec, want[path])
    # the rules shard something on each axis at full width
    used = {e for s, _ in got.values() for e in s if e}
    assert {"data", "model"} <= used


# the reference's per-leaf param specs at (data=16, model=16) of the dry
# run's three full-width rows, frozen as data: chip_smoke.py's dryrun
# phase sums one rank's param bytes from it, a check the port's own rules
# cannot pass by agreeing with themselves. Rewrite it with
# ``PYTHONPATH=src python tests/test_torch_mesh.py``.
FROZEN = Path(__file__).parent / "data" / "reference_param_specs_16x16.json"
FROZEN_ARCHS = ("nemotron-4-340b", "llama4-maverick-400b-a17b", "qwen3-0.6b")


def _reference_table(arch: str) -> list:
    """[path, global shape, dtype, spec] of every param leaf, the spec's
    entries as JSON (null, an axis, or a list of axes)."""
    theirs = jax_mesh.ShardingCtx(_Stub(MESHES["16x16"]), jax_get_config(arch))
    jparams = jax.eval_shape(lambda: JaxModel.for_config(jax_get_config(arch)).init(
        jax.random.PRNGKey(0)))
    out = []
    for p, x in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
        spec = [e if e is None or isinstance(e, str) else list(e)
                for e in theirs.param_spec(path, x)]
        out.append([path, list(x.shape), str(x.dtype), spec])
    return sorted(out)


@pytest.mark.parametrize("arch", FROZEN_ARCHS)
def test_the_frozen_reference_specs_are_the_references(arch):
    assert json.loads(FROZEN.read_text())[arch] == _reference_table(arch)


SHAPES = {
    "hidden": [(256, 4096, 1024), (16, 1, 1024), (1, 8192, 18432), (32, 17, 5120),
               (128, 32768, 4096)],
    "ffn": [(256, 4096, 3072), (16, 1, 73728), (32, 100, 12), (1, 1, 16)],
    "heads": [(32, 128, 40, 128), (32, 128, 32, 128), (1, 1, 16, 64), (7, 3, 96, 192)],
    "kv_heads": [(32, 4096, 8, 128), (32, 4096, 16, 128), (128, 32768, 8, 192),
                 (1, 524288, 4, 256), (4, 8, 2, 64), (16, 15, 2, 64)],
    "ssm_heads": [(8, 2048, 80, 64), (8, 2048, 12, 64), (256, 4096, 112, 64)],
    "experts": [(8, 1, 128, 5, 5120), (8, 4, 40, 13, 1536), (1, 1, 4, 1, 256)],
    "experts_ff": [(8, 1, 128, 5, 8192), (8, 4, 40, 13, 512), (8, 4, 40, 13, 500)],
    "logits": [(256, 4096, 151936), (32, 256206), (16, 1, 8), (128, 202048),
               (1, 5, 256000)],
}


@pytest.mark.parametrize("seq_parallel", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("tag", sorted(SHAPES) + ["unknown"])
def test_activation_spec_is_the_references_for_every_tag(tag, mesh, seq_parallel):
    ours, theirs = _ctxs("qwen3-0.6b", mesh, seq_parallel)
    for shape in SHAPES.get(tag, [(8, 4, 2)]):
        got = ours.activation_spec(_Arr(shape), tag)
        want = theirs.activation_spec(_Arr(shape), tag)
        assert (got is None) == (want is None), (tag, shape)
        if got is not None:
            assert got == tuple(want), (tag, shape, got, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_axis_is_the_references(mesh):
    ours, theirs = _ctxs("qwen3-0.6b", mesh)
    for b in (1, 2, 7, 16, 32, 48, 128, 256, 512, 1024):
        assert ours.batch_axis_for(b) == theirs.batch_axis_for(b), b


CACHES = [(a, b, t) for a in ARCH_IDS for b, t in ((128, 32768), (1, 524288), (16, 64))]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,batch,cache_len", CACHES)
def test_cache_shardings_are_the_references(arch, batch, cache_len, mesh,
                                            monkeypatch):
    # the reference wraps each spec in a NamedSharding of a real mesh;
    # the stub mesh has none, so the test reads the spec itself
    monkeypatch.setattr(jax_mesh, "NamedSharding", lambda m, spec: spec)
    ours, theirs = _ctxs(arch, mesh)
    jcache = jax.eval_shape(
        lambda: JaxModel.for_config(jax_get_config(arch)).init_cache(batch, cache_len))
    cache = for_config(get_config(arch), "meta").init_cache(batch, cache_len,
                                                           device="meta")
    want = jax.tree_util.tree_leaves(
        theirs.cache_shardings(jcache),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    specs = ours.cache_shardings(cache)
    got = [b.spec for b in leaves(tree_map(lambda c, s: _Box(s), cache, specs))]
    assert [tuple(x.shape) for x in leaves(cache)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jcache)]
    assert got == [tuple(w) for w in want]


class _Box:
    """A spec held as one leaf (a spec is itself a tuple)."""

    def __init__(self, spec):
        self.spec = spec


PLACEMENT_CASES = [
    ("16x16", ("data", None, "model"), (32, 7, 64)),
    ("16x16", (None, "model", None, None), (8, 32768, 8, 192)),
    ("2x16x16", (("pod", "data"), None, None), (256, 4096, 1024)),
    ("2x16x16", ("data", None), (32, 5)),
    ("2x16x16", (None, "model"), (4, 256206)),  # the uneven vocab of logits
    ("16x16", (), ()),
]


@pytest.mark.parametrize("mesh,spec,shape", PLACEMENT_CASES)
def test_placements_and_local_shapes(mesh, spec, shape):
    from torch.distributed.tensor import Replicate, Shard

    ctx = ShardingCtx(_Stub(MESHES[mesh]), get_config("qwen3-0.6b"))
    pl = ctx.placements(spec)
    assert len(pl) == len(MESHES[mesh])
    for axis, p in zip(MESHES[mesh], pl):
        dims = [d for d, e in enumerate(spec) if e == axis or (
            isinstance(e, tuple) and axis in e)]
        assert p == (Shard(dims[0]) if dims else Replicate())
    local = ctx.local_shape(shape, spec)
    for d, (n, k) in enumerate(zip(shape, local)):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else (e,) if isinstance(e, str) else e
        ways = 1
        for a in axes:
            ways *= MESHES[mesh][a]
        # torch.chunk's first chunk, the one rank 0 holds
        assert k == -(-n // ways) == torch.empty(n, device="meta").chunk(ways)[0].shape[0]


def test_a_pod_and_data_dim_splits_pod_major():
    """(pod, data) on one dim is Shard(d) on both mesh dims in mesh order,
    so rank (p, d, ·) holds chunk p·16 + d, as in the reference's layout."""
    from torch.distributed.tensor import Replicate, Shard

    ctx = ShardingCtx(_Stub(MESHES["2x16x16"]), get_config("qwen3-0.6b"))
    assert ctx.placements((("pod", "data"), None)) == (Shard(0), Shard(0), Replicate())
    assert ctx.batch_axis_for(64) == ("pod", "data")
    assert ctx.local_shape((64, 3), (("pod", "data"), None)) == (2, 3)


@pytest.mark.parametrize("arch", ["nemotron-4-340b", "llama4-maverick-400b-a17b"])
def test_one_ranks_share_of_the_two_big_archs(arch):
    """The per-device param bytes at 16 x 16: the sum of each leaf's local
    shard under the reference's rules (2.64 GB for nemotron, 3.16 GB for
    llama4, bf16)."""
    ctx = ShardingCtx(_Stub(MESHES["16x16"]), get_config(arch))
    params = for_config(get_config(arch), "meta").init(None)
    total = []
    map_with_path(lambda p, x: total.append(
        torch.Size(ctx.local_shape(x.shape, ctx.param_spec(p, x))).numel()
        * x.element_size()), params)
    want = {"nemotron-4-340b": 2_641_600_512, "llama4-maverick-400b-a17b": 3_163_660_800}
    assert sum(total) == want[arch]


@pytest.mark.parametrize("combo", list(itertools.product((1, 2, 3, 4), (1, 2, 4, 8))))
def test_view_groups_keep_a_leading_shard_only(combo):
    """``mesh._keeps_shard``: a view keeps a split dim only where the dim
    leads its group and the group's leading output dim divides."""
    from repro_torch.launch.mesh import _keeps_shard

    kv, k = combo
    # (B, S, KV*hd) -> (B, S, KV, hd): the split features keep their shard
    # when KV divides k ways, or when KV is 1 (a size-1 dim joins no split)
    assert _keeps_shard((8, 8, kv * 64), (8, 8, kv, 64), 2, k) == (
        kv % k == 0 or kv == 1)
    # the batch dim is left alone by the split of the last dim
    assert _keeps_shard((8, 8, kv * 64), (8, 8, kv, 64), 0, k)
    # merging (B, S) keeps a batch shard, never a sequence one
    assert _keeps_shard((8, 8, 16), (64, 16), 0, k)
    assert not _keeps_shard((8, 8, 16), (64, 16), 1, k)


if __name__ == "__main__":
    FROZEN.parent.mkdir(exist_ok=True)
    archs = [f"{json.dumps(a)}: [\n" + ",\n".join(json.dumps(r) for r in _reference_table(a))
             + "\n]" for a in FROZEN_ARCHS]
    FROZEN.write_text("{\n" + ",\n".join(archs) + "\n}\n")
