"""The port's bundle audit (``repro_torch.analysis.bundle_lint``), its CLI
and the publish gate, against the reference's.

Two manifests of the same three reduced qwen3 buckets (slots 2 × lens
{16, 32} and slots 4 × len 16: the (4, 32) cell missing, one coverage
gap), one compiled by each package. Each of the reference's planted
faults (an edited bundle file, an index tamper, a missing file, a stale
fingerprint, a state-slots mismatch, an unknown version, a complete grid
checked strictly) is applied to both, and the port's finding codes must
be the reference's. The port's publish gate refuses a bundle whose
activation plan overlaps, and publishes nothing.
"""

import dataclasses
import json
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import bundle_lint as jax_bundle_lint  # noqa: E402
from repro.analysis.lint import main as jax_lint_main  # noqa: E402
from repro.configs.base import get_reduced as jax_get_reduced  # noqa: E402
from repro.core import artifact as jax_artifact  # noqa: E402
from repro.launch import compile as jax_compile  # noqa: E402
from repro_torch.analysis import bundle_lint  # noqa: E402
from repro_torch.analysis.findings import LintGateError  # noqa: E402
from repro_torch.analysis.lint import main as lint_main  # noqa: E402
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.core import artifact  # noqa: E402
from repro_torch.launch import compile as compile_mod  # noqa: E402

ARCH = "qwen3-0.6b"
BUCKETS = [(2, 16), (2, 32), (4, 16)]


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    """"port" and "jax" -> the same three buckets, published by each, both
    without AOT packs (the port's are held in ``test_torch_aot.py``)."""
    port = tmp_path_factory.mktemp("port")
    jax_dir = tmp_path_factory.mktemp("jax")
    for n_slots, max_len in BUCKETS:
        compile_mod.compile_and_publish(get_reduced(ARCH), str(port),
                                        n_slots=n_slots, max_len=max_len,
                                        aot=False)
        jax_compile.compile_and_publish(jax_get_reduced(ARCH), str(jax_dir),
                                        n_slots=n_slots, max_len=max_len,
                                        measure_xla=False, aot=False)
    return {"port": port, "jax": jax_dir}


def _copy(src: Path, dst: Path) -> Path:
    shutil.copytree(src, dst)
    return dst


def _index(d: Path) -> dict:
    return json.loads((d / "manifest.json").read_text())


def _write_index(d: Path, obj: dict) -> None:
    (d / "manifest.json").write_text(json.dumps(obj))


def _first(d: Path) -> tuple[str, dict]:
    return sorted(_index(d)["buckets"].items())[0]


# ---------------------------------------------- manifest-level faults


def _edit_file(d):
    path = d / _first(d)[1]["file"]
    obj = json.loads(path.read_text())
    obj["max_len"] += 1
    path.write_text(json.dumps(obj))


def _tamper_index(d):
    idx = _index(d)
    key = sorted(idx["buckets"])[0]
    idx["buckets"][key]["fingerprint"] = "0" * 64
    idx["buckets"][key]["total_size"] += 7
    _write_index(d, idx)


def _remove_file(d):
    (d / _first(d)[1]["file"]).unlink()


def _complete_grid(d):
    idx = _index(d)
    idx["buckets"] = {k: v for k, v in idx["buckets"].items() if "slots4" not in k}
    _write_index(d, idx)


MANIFEST_FAULTS = {"pristine": lambda d: None, "edited_file": _edit_file,
                   "index_tamper": _tamper_index, "missing_file": _remove_file,
                   "complete_grid": _complete_grid}


def _codes(report):
    return sorted({f.code for f in report.findings})


@pytest.mark.parametrize("fault", list(MANIFEST_FAULTS))
def test_manifest_findings_are_the_references(manifests, tmp_path, fault):
    got_dir = _copy(manifests["port"], tmp_path / "port")
    want_dir = _copy(manifests["jax"], tmp_path / "jax")
    MANIFEST_FAULTS[fault](got_dir)
    MANIFEST_FAULTS[fault](want_dir)
    got = bundle_lint.lint_manifest(got_dir)
    want = jax_bundle_lint.lint_manifest(want_dir)
    assert _codes(got) == _codes(want)
    assert len(got.errors) == len(want.errors)
    assert len(got.warnings) == len(want.warnings)
    for strict in ([], ["--strict"]):
        assert lint_main([*strict, "bundles", str(got_dir)]) == \
            jax_lint_main([*strict, "bundles", str(want_dir)])
    if fault == "pristine":
        assert _codes(got) == ["coverage-gap"] and "slots4|len32" in got.warnings[0].message


# ------------------------------------------------ bundle-level faults


def _stale(b):
    return dataclasses.replace(b, fingerprint="f" * 64)


def _state_slots(b):
    return dataclasses.replace(
        b, state_plan=dataclasses.replace(b.state_plan, n_slots=b.state_plan.n_slots + 1))


def _state_len(b):
    return dataclasses.replace(
        b, state_plan=dataclasses.replace(b.state_plan, max_len=b.state_plan.max_len * 2))


def _prefill_meta(b):
    return dataclasses.replace(b, prefill_len=32)


BUNDLE_FAULTS = {"none": lambda b: b, "stale_fingerprint": _stale,
                 "state_slots_mismatch": _state_slots,
                 "state_len_mismatch": _state_len, "prefill_meta": _prefill_meta}


@pytest.mark.parametrize("fault", list(BUNDLE_FAULTS))
def test_bundle_findings_are_the_references(manifests, fault):
    got = artifact.load_bundle(manifests["port"] / _first(manifests["port"])[1]["file"])
    want = jax_artifact.load_bundle(manifests["jax"] / _first(manifests["jax"])[1]["file"])
    got_codes = {f.code for f in bundle_lint.lint_bundle(BUNDLE_FAULTS[fault](got))}
    want_codes = {f.code for f in jax_bundle_lint.lint_bundle(BUNDLE_FAULTS[fault](want))}
    assert got_codes == want_codes
    if fault == "none":
        assert got_codes == set()


def test_the_references_bundle_is_stale_to_the_port(manifests):
    """The port's freshness check recomputes the port's fingerprint: a
    bundle the reference published is stale to it, as the engine refuses
    it by fingerprint."""
    want = jax_artifact.load_bundle(manifests["jax"] / _first(manifests["jax"])[1]["file"])
    port_view = artifact.bundle_from_json(jax_artifact.bundle_to_json(want))
    assert {f.code for f in bundle_lint.lint_bundle(port_view)} == {"fingerprint-stale"}


@pytest.mark.parametrize("version", [99, 1])
def test_format_versions_are_the_references(manifests, tmp_path, version):
    codes = {}
    for pkg, lint in (("port", bundle_lint), ("jax", jax_bundle_lint)):
        src = manifests[pkg] / _first(manifests[pkg])[1]["file"]
        obj = json.loads(src.read_text())
        obj["format_version"] = version
        path = tmp_path / f"{pkg}.json"
        path.write_text(json.dumps(obj))
        codes[pkg] = {f.code for f in lint.lint_bundle_file(path)}
    assert codes["port"] == codes["jax"]
    assert ("format-unknown" in codes["port"]) == (version == 99)


def test_executable_coherence_only_with_a_pack(manifests):
    got = artifact.load_bundle(manifests["port"] / _first(manifests["port"])[1]["file"])
    assert got.executables is None
    pack = artifact.ExecutablePack(
        platform="", jax_version="0.0.test",
        entries={"pytree_decode": artifact.ExecutableEntry(b"x", "0" * 64, 1)})
    codes = {f.code for f in bundle_lint.lint_bundle(
        dataclasses.replace(got, executables=pack))}
    assert codes == {"executable-key-missing", "executable-missing",
                     "executable-corrupt"}


# ---------------------------------------------------------- the gate


def test_the_publish_gate_refuses_a_planted_overlap(monkeypatch, tmp_path):
    """Every activation tensor planted at offset 0: the certifier finds the
    overlaps and nothing is published; ``lint=False`` publishes."""
    real = compile_mod.plan_unified

    def overlapping(spec):
        up = real(spec)
        act = dataclasses.replace(
            up.activation, offsets={t: 0 for t in up.activation.offsets})
        return dataclasses.replace(up, activation=act)

    monkeypatch.setattr(compile_mod, "plan_unified", overlapping)
    out = tmp_path / "refused"
    cfg = get_reduced(ARCH)
    with pytest.raises(LintGateError) as exc:
        compile_mod.compile_and_publish(cfg, str(out), n_slots=2, max_len=16)
    assert "refusing to publish" in str(exc.value)
    assert {f.code for f in exc.value.report.errors} == {"arena-collision"}
    assert not out.exists() or not any(out.iterdir())
    res = compile_mod.compile_and_publish(cfg, str(out), n_slots=2, max_len=16,
                                          lint=False)
    assert (out / "manifest.json").is_file() and res.bundle.state_plan is not None
    assert lint_main(["bundles", str(out)]) == 1  # the CLI finds it too


def test_cli_json_and_usage_exit_codes(manifests, capsys):
    assert lint_main(["--json", "bundles", str(manifests["port"])]) == 0
    obj = json.loads(capsys.readouterr().out)
    assert obj["errors"] == 0 and obj["warnings"] == 1
    assert obj["findings"][0]["code"] == "coverage-gap"
    assert lint_main(["--strict", "bundles", str(manifests["port"])]) == 1
    assert lint_main(["decode", "no-such-arch", "--device", "cpu"]) == 2
    assert lint_main(["all", "--manifest", str(manifests["port"]),
                      "--archs", "qwen3-0.6b", "--device", "cpu", "--block", "4"]) == 0
