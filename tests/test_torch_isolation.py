"""The port stands alone: no module of ``repro_torch`` and neither root
script of the card (``chip_smoke.py``, ``chip_faults.py``) imports JAX
or anything of the reference package."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke, chip_faults
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print("modules=%d" % len(list(
    pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))))
print("leaked=" + ",".join(leaked))
"""


def test_importing_the_port_loads_no_jax_and_no_reference():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}"},
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    result = dict(line.split("=", 1) for line in out.stdout.splitlines() if "=" in line)
    assert int(result["modules"]) >= 20
    assert result["leaked"] == "", f"imported: {result['leaked']}"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_torch)|from\s+(jax|jaxlib|repro)\b(?!_torch))",
    re.MULTILINE,
)


SOURCES = sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")) + [
    "chip_smoke.py", "chip_faults.py"]


@pytest.mark.parametrize("path", SOURCES)
def test_no_source_imports_jax_or_the_reference(path):
    assert not _FORBIDDEN.findall((ROOT / path).read_text()), path


@pytest.mark.parametrize(
    "path",
    ["src/repro_torch/configs/mamba2_2_7b.py", "src/repro_torch/kernels/ssd_chunk.py",
     "src/repro_torch/models/ssm.py", "src/repro_torch/launch/compile.py"],
)
def test_the_mamba2_modules_are_checked(path):
    assert path in SOURCES


@pytest.mark.parametrize(
    "path",
    ["src/repro_torch/runtime/executor.py", "src/repro_torch/runtime/graphs.py",
     "src/repro_torch/runtime/sampling.py", "src/repro_torch/analysis/counters.py",
     "src/repro_torch/analysis/decode_lint.py", "src/repro_torch/analysis/findings.py",
     "src/repro_torch/core/plan_io.py"],
)
def test_the_captured_serving_modules_are_checked(path):
    assert path in SOURCES
