"""The control at a size a test run holds: the reference computed in
float8 e4m3 (W8A8), its tokens put in the program's place, comes out
not correct by the harness's own comparison, where the program's own
tokens come out correct.

The tiny cells read smaller gaps than the cells' own sizes, so each has
a limit of its own here, set by the same rule from 8 seeds on the CPU
(seeds 2**31 + 1 .. 2**31 + 8, 3-s windows): tiny MoE, closed loop,
mean gap: the program at most 3.3e-4, the control at least 1.32e-3;
tiny hybrid, closed loop: widest gap 0.0325 against 0.377, mean gap
6.7e-4 against 0.0201. (The tiny open-loop MoE separates by less than
3x, as the chat cell's mean gap does at its own size, and is left out.)"""

import pytest

from perfbench import harness
from perfbench.tests.helpers import one_thread, tiny_cell


@pytest.mark.parametrize("arch,like,limits,seed", [
    ("moe", "granite-moe-3b.decode", {"mean_logit_gap": 7e-4}, 2**31 + 2),
    ("hybrid", "zamba2-7b.decode", {"max_logit_gap": 0.1, "mean_logit_gap": 4e-3},
     2**31 + 7),
])
def test_the_control_comes_out_not_correct(arch, like, limits, seed):
    cell = tiny_cell(arch, "closed", like=like, limits=limits)
    with one_thread():
        out = harness.run_cell(cell, seed, 3.0, False, device="cpu", control=True)
    g = out["extra"]["gaps"]
    assert out["result"]["correct"] is True, g
    # the same comparison, with the control's tokens in the served ones' place
    assert out["control"]["correct"] is False, g["control"]
    assert set(out["control"]["checks"]) == set(out["result"]["checks"])
    assert out["control"]["failed"] >= 1
