"""As ``test_perfbench_faults_moe.py``, on a tiny zamba2-like hybrid in a
closed loop: Mamba2 layers and the shared attention block."""

import pytest

from perfbench import harness
from perfbench.tests.faults import planted
from perfbench.tests.helpers import one_thread, tiny_cell

SEED = 2**31 + 7


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch",
                                   "token_altered"])
def test_correct_comes_out_false_under_each_fault(fault):
    cell = tiny_cell("hybrid", "closed", like="zamba2-7b.decode")
    with planted(fault), one_thread():
        out = harness.run_cell(cell, SEED, 3.0, True, device="cpu")
    res = out["result"]
    assert res["checks"]["finished_requests"]["value"] >= 2
    assert res["correct"] is (fault is None), out["extra"]["gaps"]
    if fault is None:
        assert "planned_mib" in res["metrics"]
