"""``repro_torch.launch.fx_analysis``: the counterparts of
``tests/test_hlo_analysis.py`` over traced fx programs. A product counts
2·M·N·K; an unrolled 4-layer step counts 4 × one layer (the port has no
loop to multiply, where the reference's scan has a trip count); the
collectives of a DTensor program traced on a fake group count their
operand bytes by kind; ``trace/fx_liveness`` reads a ``wait_tensor`` as
the collective's own tensor. The fake group is made in a fixture and
taken down after the module, so no other test sees it."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from repro_torch.launch.fx_analysis import analyze  # noqa: E402


def _trace(fn, *args):
    return make_fx(fn, tracing_mode="fake")(*args)


@pytest.mark.parametrize("mnk", [(128, 256, 64), (7, 3, 5), (1, 4096, 1024)])
def test_a_product_counts_2mnk_flops_and_its_bytes(mnk):
    M, N, K = mnk
    gm = _trace(lambda a, b: a @ b, torch.empty(M, K), torch.empty(K, N))
    cost = analyze(gm)
    assert cost.flops == 2 * M * N * K
    assert cost.bytes == 4 * (M * K + K * N + M * N)
    assert cost.collective_bytes == 0 and cost.collective_counts == {}


def test_a_batched_product_counts_every_batch():
    gm = _trace(lambda a, b: torch.bmm(a, b), torch.empty(6, 8, 16),
                torch.empty(6, 16, 32))
    assert analyze(gm).flops == 2 * 6 * 8 * 32 * 16


def _stack(n):
    def step(x, ws):
        for w in ws[:n]:
            x = torch.relu(x @ w)
        return x
    return step


@pytest.mark.parametrize("n", [1, 2, 4])
def test_an_unrolled_stack_counts_each_layer(n):
    """In place of the reference's scan trip test: a Python loop unrolls
    in the trace, so n layers count n times one layer."""
    x = torch.empty(32, 64)
    ws = [torch.empty(64, 64) for _ in range(4)]
    one = analyze(_trace(_stack(1), x, ws))
    cost = analyze(_trace(_stack(n), x, ws))
    assert cost.flops == n * one.flops == n * 2 * 32 * 64 * 64
    assert cost.bytes == n * one.bytes


def test_views_move_no_bytes():
    gm = _trace(lambda a: (a + 1).view(8, 32).t().unsqueeze(0), torch.empty(256))
    cost = analyze(gm)
    # the add reads 256 floats and writes 256; the views after it move
    # nothing
    assert cost.bytes == 2 * 256 * 4


def test_the_custom_ops_count_their_formulas():
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_lse
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    from repro_torch.launch.roofline import flash_decode_flops, ssd_chunk_flops

    q, k = torch.empty(2, 4, 3, 64), torch.empty(2, 128, 4, 64)
    lengths = torch.ones(2, dtype=torch.int32)
    gm = _trace(lambda q, k, v, n: flash_decode(q, k, v, n), q, k, k, lengths)
    assert analyze(gm).flops == flash_decode_flops(tuple(q.shape), tuple(k.shape))
    gm = _trace(lambda q, k, v, n: flash_decode_lse(q, k, v, n), q, k, k, lengths)
    assert analyze(gm).flops == flash_decode_flops(tuple(q.shape), tuple(k.shape))
    x = torch.empty(1, 16, 2, 8)
    dt = torch.empty(1, 16, 2)
    bm = torch.empty(1, 16, 2, 4)
    st = torch.empty(1, 2, 8, 4)
    gm = _trace(lambda *a: ssd_chunk(*a), x, dt, dt, bm, bm, st)
    assert analyze(gm).flops == ssd_chunk_flops(tuple(x.shape), tuple(st.shape))


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_mesh

    assert not dist.is_initialized()
    m = init_mesh((2, 4), ("data", "model"), "cpu", backend="fake")
    yield m
    dist.destroy_process_group()


def _toy(mesh):
    """x (8, 16) batch-split on data; y = x @ w1 column-parallel on model
    (no collective); z = y @ w2 row-parallel: a pending sum, reduced over
    model (all-reduce); x gathered over data (all-gather); the pending
    sum of a second product scattered over model (reduce-scatter)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    def fn(x_l, w1_l, w2_l):
        x = DTensor.from_local(x_l, mesh, (Shard(0), Replicate()), run_check=False)
        w1 = DTensor.from_local(w1_l, mesh, (Replicate(), Shard(1)), run_check=False)
        w2 = DTensor.from_local(w2_l, mesh, (Replicate(), Shard(0)), run_check=False)
        y = x @ w1
        z = (y @ w2).redistribute(mesh, (Shard(0), Replicate()))
        xg = x.redistribute(mesh, (Replicate(), Replicate()))
        p = DTensor.from_local(z.to_local(), mesh, (Shard(0), Partial()),
                               run_check=False)
        s = p.redistribute(mesh, (Shard(0), Shard(1)))
        return z.to_local(), xg.to_local(), s.to_local()

    return fn


def test_collectives_count_their_operand_bytes_by_kind(mesh):
    gm = _trace(_toy(mesh), torch.empty(4, 16), torch.empty(16, 8), torch.empty(8, 16))
    cost = analyze(gm)
    f4 = 4
    # all-reduce of z's local pending sum (4, 16); all-gather of x's
    # shard (4, 16); reduce-scatter of the (4, 16) pending sum
    assert cost.collective_counts == {"all-reduce": 1, "all-gather": 1,
                                      "reduce-scatter": 1}
    assert cost.collective_bytes_by_kind == {"all-reduce": 4 * 16 * f4,
                                             "all-gather": 4 * 16 * f4,
                                             "reduce-scatter": 4 * 16 * f4}
    assert cost.collective_bytes == 3 * 4 * 16 * f4
    # the local products: (4, 16) @ (16, 8) and (4, 8) @ (8, 16)
    assert cost.flops == 2 * 4 * 8 * 16 + 2 * 4 * 16 * 8


def test_a_wait_is_the_collectives_tensor_in_the_liveness_graph(mesh):
    from repro_torch.trace.fx_liveness import trace_from_graph_module

    gm = _trace(_toy(mesh), torch.empty(4, 16), torch.empty(16, 8), torch.empty(8, 16))
    tr = trace_from_graph_module(gm, name="toy")
    waits = [n for n in gm.graph.nodes if "wait_tensor" in str(n.target)]
    assert waits
    for w in waits:
        src = w.args[0]
        assert "_c10d_functional" in str(src.target)
        assert tr.node_tid[w] == tr.node_tid[src]
        assert w not in tr.produced and src in tr.produced
