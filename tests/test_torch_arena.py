"""The port's activation arena against ``repro.runtime.arena``.

Both arenas are built from the same usage records planned by each
package's own planner (the planner tests hold those plans
byte-identical); stores into planned offsets must leave the same bytes
in both buffers, and both must refuse the same out-of-bounds views.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import graph_gen  # noqa: E402
from repro.core import planner as jax_planner  # noqa: E402
from repro.runtime.arena import Arena as JaxArena  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.records import TensorUsageRecord  # noqa: E402
from repro_torch.runtime.arena import Arena, ArenaLayout  # noqa: E402


def _plans(kind, seed):
    records = graph_gen.generate(kind, seed)
    want = jax_planner.plan_records(records, strategy="auto", use_cache=False)
    got = planner.plan_records(
        [TensorUsageRecord(r.first_op, r.last_op, r.size, r.tensor_id)
         for r in records],
        strategy="auto",
    )
    return got, want


@pytest.mark.parametrize("kind", sorted(graph_gen.GENERATORS))
def test_stores_leave_the_reference_bytes(kind):
    plan, jplan = _plans(kind, 3)
    arena, jarena = Arena(plan, "cpu"), JaxArena(jplan)
    assert arena.nbytes == jarena.nbytes == max(plan.total_size, 1)
    rng = np.random.default_rng(0)
    # in op order, as an executor writes them: later tensors overwrite
    # the bytes of dead ones that share their offsets
    for r in sorted(plan.records, key=lambda r: (r.first_op, r.tensor_id)):
        value = rng.integers(0, 256, size=r.size, dtype=np.uint8)
        jarena.store(r.tensor_id, value)
        got = arena.store(r.tensor_id, torch.from_numpy(value))
        assert np.array_equal(got.numpy(), value)
    assert np.array_equal(arena.buf.numpy(), jarena.buf)


def test_views_alias_the_buffer_and_are_bounds_checked():
    plan, jplan = _plans("chain", 0)
    arena, jarena = Arena(ArenaLayout.from_plan(plan), "cpu"), JaxArena(jplan)
    r = max(plan.records, key=lambda r: r.size)
    n = r.size // 4
    view = arena.view(r.tensor_id, (n,), torch.float32)
    view.fill_(1.5)
    off = plan.offsets[r.tensor_id]
    assert np.array_equal(arena.buf[off : off + 4 * n].view(torch.float32).numpy(),
                          np.full(n, 1.5, np.float32))
    too_big = (r.size + 1,)
    with pytest.raises(ValueError):
        jarena.view(r.tensor_id, too_big, np.uint8)
    with pytest.raises(ValueError):
        arena.view(r.tensor_id, too_big, torch.uint8)
    # a slot that would run past the end of the buffer is refused when
    # the layout is built
    bad = ArenaLayout(total_size=r.size - 1, offsets={0: 0}, sizes={0: r.size})
    with pytest.raises(ValueError):
        Arena(bad, "cpu")


def test_an_arena_with_no_device_is_on_the_card():
    """No device means the card: without one, a RuntimeError, never a
    silent move to the CPU; ``"cpu"`` asks for the CPU."""
    plan, _ = _plans(sorted(graph_gen.GENERATORS)[0], 3)
    assert Arena(plan, "cpu").buf.device.type == "cpu"
    if torch.cuda.is_available():
        assert Arena(plan).buf.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Arena(plan)
