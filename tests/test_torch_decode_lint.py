"""The port's decode lint and counters registry on a CPU engine.

Each check of ``analysis/decode_lint.lint_run`` passes on a clean run
(host loop and blocks) and fails on its planted fault: a state buffer or
an arena that moves during the run, and a capture while serving. The
host-sync check needs the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import counters, decode_lint  # noqa: E402
from repro_torch.analysis.findings import Finding, Report  # noqa: E402
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.models.api import DecoderModel  # noqa: E402
from repro_torch.runtime import graphs  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402


@pytest.fixture(scope="module")
def params():
    cfg = get_reduced("qwen3-0.6b")
    return cfg, DecoderModel(cfg, "cpu").init(torch.Generator().manual_seed(0))


def _engine(params, block_size):
    cfg, p = params
    eng = InferenceEngine(cfg, p, n_slots=2, max_len=32, device="cpu",
                          block_size=block_size)
    rng = np.random.default_rng(0)
    for n in (3, 5, 2):
        eng.submit(rng.integers(0, cfg.vocab, size=n).astype(np.int32),
                   max_new_tokens=4)
    return eng


@pytest.mark.parametrize("block_size", [1, 4])
def test_a_clean_run_has_no_findings(params, block_size):
    eng = _engine(params, block_size)
    findings = decode_lint.lint_run(eng, eng.run_until_done)
    assert findings == []
    assert not eng.unfinished_requests()
    assert not eng.state.sync_guard  # the guard is off after the run
    report = Report().extend(findings, checked="qwen3-reduced")
    assert report.ok(strict=True)


def _codes(findings):
    return [f.code for f in findings]


@pytest.mark.parametrize("block_size", [1, 4])
def test_a_moved_state_buffer_is_found(params, block_size):
    eng = _engine(params, block_size)

    def run():
        eng.run_until_done()
        eng.state.buf = eng.state.buf.clone()

    findings = decode_lint.lint_run(eng, run)
    assert _codes(findings) == ["state-buffer-moved"]
    assert all(isinstance(f, Finding) and f.severity == "error" for f in findings)


def test_a_moved_arena_is_found(params):
    eng = _engine(params, 4)

    def run():
        eng.run_until_done()
        eng.activation_arena.buf = eng.activation_arena.buf.clone()

    assert _codes(decode_lint.lint_run(eng, run)) == ["arena-moved"]


@pytest.mark.parametrize("block_size", [1, 4])
def test_a_capture_while_serving_is_found(params, block_size):
    eng = _engine(params, block_size)

    def run():
        eng.run_until_done()
        graphs.CAPTURE_CALLS += 1

    findings = decode_lint.lint_run(eng, run)
    assert _codes(findings) == ["capture-after-warmup"]
    assert "1 CUDA graph capture" in findings[0].message


def test_other_errors_of_the_run_are_not_findings(params):
    eng = _engine(params, 4)

    def run():
        raise RuntimeError("not a sync")

    with pytest.raises(RuntimeError, match="not a sync"):
        decode_lint.lint_run(eng, run)
    assert not eng.state.sync_guard


def test_findings_module_is_the_reference_copy():
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "src"
    assert (root / "repro_torch/analysis/findings.py").read_bytes() == (
        root / "repro/analysis/findings.py").read_bytes()


@pytest.mark.parametrize("name", sorted(counters.REGISTRY))
def test_every_counter_resolves_and_counts(params, name):
    assert isinstance(counters.read(name), int)
    with counters.capture(name) as cap:
        assert cap.delta(name) == 0


def test_counters_over_an_engine_construction_and_run(params):
    cfg, p = params
    with counters.capture() as cap:
        eng = InferenceEngine(cfg, p, n_slots=2, max_len=32, device="cpu",
                              block_size=3)
        eng.submit(np.arange(4, dtype=np.int32), max_new_tokens=6)
        eng.run_until_done()
    d = cap.deltas()
    assert (d["trace_calls"], d["plan_calls"], d["state_plan_calls"]) == (1, 1, 1)
    assert d["host_syncs"] == eng.n_blocks == 2  # 6 waves in blocks of 3
    assert d["capture_calls"] == 0  # nothing is captured on the CPU
