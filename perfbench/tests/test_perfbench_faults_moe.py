"""The harness's ``correct`` on a tiny MoE cell on the CPU: true on the
program as it is, false under each fault the cell can have (one chip:
no exchange between chips to leave out). It drives everything of a run
but the look for a card."""

import pytest

from perfbench import harness
from perfbench.tests.faults import planted
from perfbench.tests.helpers import one_thread, tiny_cell

SEED = 2**31 + 99


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch",
                                   "token_altered"])
def test_correct_comes_out_false_under_each_fault(fault):
    cell = tiny_cell("moe", "open", like="granite-moe-3b.chat")
    with planted(fault), one_thread():
        out = harness.run_cell(cell, SEED, 3.0, False, device="cpu")
    res = out["result"]
    assert res["checks"]["finished_requests"]["value"] >= 2
    assert res["correct"] is (fault is None), out["extra"]["gaps"]
    assert list(res)[-1] == "checks"
