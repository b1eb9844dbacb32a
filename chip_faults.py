#!/usr/bin/env python3
"""Plant faults in a copy of the ``ssd_chunk`` CUDA kernel and show that
``chip_smoke.py``'s kernel checks catch them. Needs one card.

    python3 chip_faults.py        # from the repository root

For each fault below, the port (``src/repro_torch``) and ``chip_smoke.py``
are copied to ``build/faults/<fault>/`` (ignored by git), the fault is
planted in the copy's ``csrc/ssd_chunk.cu`` by one text substitution, and
the copy runs ``chip_smoke.py --phases kernels --keep-going``: every
kernel case is checked, and the failed ssd_chunk cases are listed. The unplanted kernel is run the same way first, as the control.

Prints one JSON line per run, then a summary line; exits non-zero if the
control fails a case or a fault passes every slow-decay case or the
slow-decay prefill shape.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL = Path("src/repro_torch/kernels/csrc/ssd_chunk.cu")

# fault -> (text in ssd_chunk.cu, its replacement)
FAULTS = {
    # y without the incoming state's contribution
    "drop_y_inter": (
        "const float v = acc[k] + expf(static_cast<float>(cum[i])) * inter[k];",
        "const float v = acc[k];",
    ),
    # the new state without state * exp(total)
    "drop_state_decay": (
        "store(nsb + idx, s0 * decay + acc[a]);",
        "store(nsb + idx, acc[a] + 0.f * s0 * decay);",
    ),
    # the causal mask lets position i see position i + 1
    "mask_j_eq_i_plus_1": (
        "const bool keep = j <= i && i < L;",
        "const bool keep = j <= i + 1 && j < L && i < L;",
    ),
}
# cases every fault must fail (in every dtype)
MUST_FAIL = ("slow_L256", "slow_L200_P8", "one_group_slow_L96", "prefill_slow")


def run(name: str, fault: tuple[str, str] | None) -> dict:
    dst = ROOT / "build" / "faults" / name
    if dst.exists():
        shutil.rmtree(dst)
    dst.mkdir(parents=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch")
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    if fault is not None:
        src = (dst / KERNEL).read_text()
        old, new = fault
        if src.count(old) != 1:
            raise SystemExit(f"chip_faults: {name}: the text to replace is not "
                             f"in {KERNEL} exactly once")
        (dst / KERNEL).write_text(src.replace(old, new))
    out = subprocess.run(
        [sys.executable, "chip_smoke.py", "--phases", "kernels", "--keep-going"],
        cwd=dst, capture_output=True, text=True, timeout=900,
    )
    cases, build = [], None
    for line in out.stdout.splitlines():
        if not line.startswith("{"):
            continue
        row = json.loads(line)
        if row.get("phase") == "build":
            build = row
        if row.get("kernel") == "ssd_chunk" and "case" in row:
            cases.append(row)
    if not cases:
        raise SystemExit(f"chip_faults: {name}: no case ran\n{out.stdout}\n{out.stderr}")
    failed = [f"{r['case']}/{r['dtype']}/{r['state_dtype']}" for r in cases if not r["ok"]]
    passed = [f"{r['case']}/{r['dtype']}/{r['state_dtype']}" for r in cases if r["ok"]]
    worst = {
        f"{r['case']}/{r['dtype']}/{r['state_dtype']}": max(
            r["y"]["err_over_bar"], r["new_state"]["err_over_bar"])
        for r in cases
    }
    row = {"fault": name, "cases": len(cases), "failed": len(failed),
           "passed_cases": passed, "err_over_bar": worst,
           "ptxas": build and build.get("ptxas"), "exit": out.returncode}
    print(json.dumps(row), flush=True)
    return row


def main() -> None:
    if not (ROOT / KERNEL).is_file():
        raise SystemExit(f"chip_faults: {ROOT} is not a checkout of the repository")
    control = run("control", None)
    results = {name: run(name, fault) for name, fault in FAULTS.items()}
    problems = []
    if control["failed"]:
        problems.append(f"the unplanted kernel failed {control['failed']} case(s)")
    for name, row in results.items():
        for case in row["passed_cases"]:
            if case.split("/")[0] in MUST_FAIL:
                problems.append(f"{name} passed {case}")
    print(json.dumps({"faults": {n: {"failed": r["failed"], "of": r["cases"]}
                                 for n, r in results.items()},
                      "problems": problems}), flush=True)
    if problems:
        raise SystemExit("chip_faults: FAILED: " + "; ".join(problems))


if __name__ == "__main__":
    main()
