"""The port stands alone: no module of ``repro_torch`` and no script of
the card (``chip_smoke.py``, ``chip_faults.py``,
``scripts/time_kernel.py``) and no other script (``scripts/dryrun_tensors.py``) imports
JAX or anything of the reference package."""

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
                if k.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
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
    "chip_smoke.py", "chip_faults.py", "scripts/time_kernel.py",
    "scripts/dryrun_tensors.py"]


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


@pytest.mark.parametrize(
    "path",
    ["src/repro_torch/core/shared_objects.py", "src/repro_torch/core/baselines.py",
     "src/repro_torch/core/extensions.py", "src/repro_torch/core/optimal.py",
     "src/repro_torch/core/reference.py", "src/repro_torch/core/validate.py",
     "src/repro_torch/core/dynamic.py", "src/repro_torch/core/order_search.py",
     "src/repro_torch/core/fusion_search.py", "src/repro_torch/core/__init__.py",
     "src/repro_torch/analysis/soundness.py", "src/repro_torch/analysis/__init__.py",
     "src/repro_torch/models/convnets.py", "src/repro_torch/kernels/smem_plan.py",
     "src/repro_torch/launch/roofline.py"],
)
def test_the_planning_core_modules_are_checked(path):
    assert path in SOURCES


@pytest.mark.parametrize(
    "path",
    ["src/repro_torch/models/moe.py", "src/repro_torch/configs/granite_moe_3b_a800m.py",
     "src/repro_torch/configs/llama4_maverick_400b_a17b.py"],
)
def test_the_moe_modules_are_checked(path):
    assert path in SOURCES


@pytest.mark.parametrize(
    "path",
    ["src/repro_torch/core/artifact.py", "src/repro_torch/core/unified.py",
     "src/repro_torch/launch/compile.py", "src/repro_torch/launch/serve.py",
     "src/repro_torch/analysis/bundle_lint.py", "src/repro_torch/analysis/lint.py",
     "src/repro_torch/runtime/engine.py", "src/repro_torch/runtime/aot.py",
     "src/repro_torch/runtime/residency.py"],
)
def test_the_plan_bundle_modules_are_checked(path):
    assert path in SOURCES


def test_no_source_imports_ml_dtypes():
    """The card machine has no ml_dtypes: the port sizes bfloat16 itself."""
    pattern = re.compile(r"^\s*(import|from)\s+ml_dtypes\b", re.MULTILINE)
    assert not [p for p in SOURCES if pattern.search((ROOT / p).read_text())]


@pytest.mark.parametrize("name", ["gemma3_4b.py", "gemma3_27b.py", "nemotron_4_340b.py",
                                  "granite_moe_3b_a800m.py",
                                  "llama4_maverick_400b_a17b.py", "zamba2_7b.py",
                                  "internvl2_1b.py", "seamless_m4t_medium.py"])
def test_the_copied_configs_are_the_references_byte_for_byte(name):
    """Copied with only the import path changed."""
    want = (ROOT / "src" / "repro" / "configs" / name).read_text().replace(
        "from repro.configs.base import", "from repro_torch.configs.base import")
    got = (PORT / "configs" / name).read_text()
    assert got == want
    assert f"src/repro_torch/configs/{name}" in SOURCES


def test_the_copied_pipeline_is_the_references_byte_for_byte():
    """``data/pipeline.py`` is pure numpy, copied whole (it imports nothing
    of the reference, so not even an import path changes)."""
    want = (ROOT / "src" / "repro" / "data" / "pipeline.py").read_text()
    assert (PORT / "data" / "pipeline.py").read_text() == want


@pytest.mark.parametrize(
    "path",
    ["src/repro_torch/launch/train.py", "src/repro_torch/optim/adamw.py",
     "src/repro_torch/checkpoint/ckpt.py", "src/repro_torch/data/pipeline.py",
     "src/repro_torch/models/encdec.py", "src/repro_torch/tree_util.py",
     "src/repro_torch/configs/seamless_m4t_medium.py"],
)
def test_the_training_modules_are_checked(path):
    assert path in SOURCES



@pytest.mark.parametrize(
    "path",
    ["src/repro_torch/launch/mesh.py", "src/repro_torch/launch/dryrun.py",
     "src/repro_torch/launch/fx_analysis.py", "src/repro_torch/launch/roofline.py",
     "src/repro_torch/configs/nemotron_4_340b.py"],
)
def test_the_multi_device_modules_are_checked(path):
    assert path in SOURCES


def test_the_dry_run_makes_no_process_group_at_import():
    """The fake group is made in ``run_one``, never when the module is
    imported (the reference's import-time ``XLA_FLAGS`` has no
    counterpart)."""
    probe = ("import torch.distributed as dist, repro_torch.launch.dryrun, "
             "repro_torch.launch.mesh; print(dist.is_initialized())")
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize(
    "path",
    ["src/repro_torch/examples/__init__.py", "src/repro_torch/examples/quickstart.py",
     "src/repro_torch/examples/dynamic_shapes.py",
     "src/repro_torch/examples/paper_tables.py", "src/repro_torch/examples/serve_lm.py",
     "src/repro_torch/examples/train_lm.py"],
)
def test_the_example_modules_are_checked(path):
    assert path in SOURCES
