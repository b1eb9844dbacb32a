"""The harness on the card at a tiny size: a traced run through the
captured decode steps and the hand-written kernels comes out correct
and reads every per-layer metric from its profiled slice. Skips without
a CUDA card; on the card:

    PYTHONPATH=src python -m pytest -q perfbench/tests/test_perfbench_card.py
"""

import pytest

from perfbench import harness
from perfbench.tests.helpers import tiny_cell

torch = pytest.importorskip("torch")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("arch,loop,like", [("moe", "open", "granite-moe-3b.chat"),
                                            ("hybrid", "closed", "zamba2-7b.decode")])
def test_a_traced_run_on_the_card(cuda, arch, loop, like):
    cell = tiny_cell(arch, loop, like=like)
    out = harness.run_cell(cell, 2**31 + 5, 3.0, True, device=cuda)
    res = out["result"]
    assert res["correct"], out["extra"]["gaps"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    want = {m["name"] for m in cell.per_layer}
    assert want <= set(res["metrics"]), sorted(want - set(res["metrics"]))
    roofline = [v["value"] for k, v in res["metrics"].items()
                if k.split(".")[0] == "flash_decode_roofline"]
    assert len(roofline) == 1 and 0 < roofline[0] <= 105
    assert res["breakdown"]["device_ops"]
