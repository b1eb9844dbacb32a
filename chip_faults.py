#!/usr/bin/env python3
"""Plant faults in copies of the CUDA kernels and show that
``chip_smoke.py``'s kernel checks catch them. Needs one card.

    python3 chip_faults.py        # from the repository root
    python3 chip_faults.py --faults b_c_one_group   # the control and one fault

For each fault below, the port (``src/repro_torch``) and ``chip_smoke.py``
are copied to ``build/faults/<fault>/`` (ignored by git), the fault is
planted in the copy's kernel source by text substitutions, and the copy
runs ``chip_smoke.py --phases kernels --keep-going``: every kernel case is
checked, and the failed cases of the planted kernel are listed. The
unplanted kernels are run the same way first, as the control.

``ssd_chunk.cu`` holds two kernels, the tensor-core one (bf16 x/B/C) and
the CUDA-core one (fp32 x/B/C); each ``ssd_chunk`` fault except
``drop_lo`` is planted in both (``b_c_one_group`` in the host entry both
share). ``flash_decode.cu`` builds ``flash_decode`` and
``flash_decode_paged`` from one kernel: a ``flash_decode`` fault's run
lists the cases of both, and ``paged_table_ignored`` is planted in the
paged address only.

Prints one JSON line per run, then a summary line; exits non-zero if the
control fails a case, a fault fails no case, or a fault passes one of its
``must_fail`` cases (in any dtype).
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = Path("src/repro_torch/kernels/csrc")

# fault -> (kernel, [(text in csrc/<kernel>.cu, its replacement), ...],
#           cases it must fail in every dtype)
SLOW_CASES = ("slow_L256", "slow_L200_P8", "one_group_slow_L96", "prefill_slow")
# qwen3's serving shape, and granite-moe's (64, 3): 8 spans of 128 with
# empty ones, and its serving shape
FD_MUST_FAIL = ("serving_full", "D64_G3_empty_spans", "granite_serving_full")
# flash_decode_paged's cases with a shuffled table (chip_smoke.py's
# PAGED_CASES and the qwen3 serving layout)
PAGED_SHUFFLED = ("paged_P16384_shuffled", "paged_P65536_shuffled",
                  "paged_P1040_shuffled", "paged_D320_G2_P1040_shuffled",
                  "paged_D320_G2_P16384_shuffled", "paged_D64_G3_P65536_shuffled",
                  "paged_P16384_shuffled_hole", "qwen3_serving_full_shuffled",
                  "qwen3_serve_mix_shuffled")
FAULTS = {
    # y without the incoming state's contribution
    "drop_y_inter": ("ssd_chunk", [
        ("const float v = acc[k] + expf(static_cast<float>(cum[i])) * inter[k];",
         "const float v = acc[k];"),
        ("for (int e = 0; e < 4; ++e) acc[t][e] *= e < 2 ? e_top : e_bot;",
         "for (int e = 0; e < 4; ++e) acc[t][e] *= 0.f;"),
    ], SLOW_CASES),
    # the new state without state * exp(total)
    "drop_state_decay": ("ssd_chunk", [
        ("store(nsb + idx, s0 * decay + acc[a]);",
         "store(nsb + idx, acc[a] + 0.f * s0 * decay);"),
        ("store(nsb + idx, s0 * decay + acc[t][e]);",
         "store(nsb + idx, acc[t][e] + 0.f * s0 * decay);"),
    ], SLOW_CASES),
    # the causal mask lets position i see position i + 1
    "mask_j_eq_i_plus_1": ("ssd_chunk", [
        ("const bool keep = j <= i && i < L;",
         "const bool keep = j <= i + 1 && j < L && i < L;"),
        ("const bool keep_w = j <= i && i < L;",
         "const bool keep_w = j <= i + 1 && j < L && i < L;"),
    ], SLOW_CASES),
    # every head reads head 0's B and C (their head strides taken as 0): one
    # group still reads right, two groups do not (zamba2's layout)
    "b_c_one_group": ("ssd_chunk", [
        ("for (int i = 0; i < kStrides; ++i) st.v[i] = strides[i];",
         "for (int i = 0; i < kStrides; ++i) st.v[i] = i == 12 || i == 16 ? 0 : strides[i];"),
    ], ("two_groups_L96", "zamba2_prefill")),
    # W, the decayed x and an fp32 state fed as hi + mid only (tensor cores)
    "drop_lo": ("ssd_chunk", [
        ("const __nv_bfloat162 l = __floats2bfloat162_rn(ra - mf.x, rb - mf.y);",
         "const __nv_bfloat162 l = __floats2bfloat162_rn(0.f, 0.f);"),
    ], ()),
    # the merge leaves out the partial of the last span of T
    "drop_last_span": ("flash_decode", [
        ("for (int s = 0; s < n_split; ++s) {",
         "for (int s = 0; s < n_split - 1; ++s) {"),
        ("for (int s = 0; s < n_split; ++s) o += __ldcg(acc + s * G * D + idx) * sm_w[s * G + g];",
         "for (int s = 0; s < n_split - 1; ++s) o += __ldcg(acc + s * G * D + idx) * sm_w[s * G + g];"),
    ], FD_MUST_FAIL),
    # the merge weighs every partial by 1, not by exp(m_s - m)
    "merge_weight_one": ("flash_decode", [
        ("const float weight = expf(sm_w[s * G + g] - mx);",
         "const float weight = 1.f;"),
    ], FD_MUST_FAIL),
    # the paged kernel takes a slot's pages as consecutive from its first
    # table entry, as if the table were the identity past it: an ascending
    # table still reads right, a shuffled one does not
    "paged_table_ignored": ("flash_decode", [
        ("return buf + static_cast<int64_t>(__ldg(row + page)) * pe + (e - page * pe);",
         "return buf + (static_cast<int64_t>(__ldg(row)) + page) * pe + (e - page * pe);"),
    ], PAGED_SHUFFLED),
}


def label(row: dict) -> str:
    if row["kernel"].startswith("flash_decode"):
        return f"{row['case']}/{row['dtype']}"
    return f"{row['case']}/{row['dtype']}/{row['state_dtype']}"


def run(name: str, fault: tuple | None) -> dict:
    dst = ROOT / "build" / "faults" / name
    if dst.exists():
        shutil.rmtree(dst)
    dst.mkdir(parents=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch")
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    kernel = None
    if fault is not None:
        kernel, subs, _ = fault
        path = dst / CSRC / f"{kernel}.cu"
        src = path.read_text()
        for old, new in subs:
            if src.count(old) != 1:
                raise SystemExit(f"chip_faults: {name}: {old!r} is not in "
                                 f"{kernel}.cu exactly once")
            src = src.replace(old, new)
        path.write_text(src)
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
        # a source's kernels: flash_decode.cu builds flash_decode_paged too
        if "case" in row and row.get("kernel", "").startswith(kernel or ""):
            cases.append(row)
    if not cases:
        raise SystemExit(f"chip_faults: {name}: no case ran\n{out.stdout}\n{out.stderr}")
    failed = [label(r) for r in cases if not r["ok"]]
    passed = [label(r) for r in cases if r["ok"]]
    worst = {label(r): max(r["y"]["err_over_bar"], r["new_state"]["err_over_bar"])
             for r in cases if r["kernel"] == "ssd_chunk"}
    row = {"fault": name, "kernel": kernel, "cases": len(cases),
           "failed": len(failed), "failed_cases": failed, "passed_cases": passed,
           "err_over_bar": worst, "ptxas": build and build.get("ptxas"),
           "exit": out.returncode}
    print(json.dumps(row), flush=True)
    return row


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--faults", default=",".join(FAULTS),
                    help="comma-separated subset of %(default)s (the control "
                         "always runs)")
    names = ap.parse_args().faults.split(",")
    if set(names) - set(FAULTS):
        raise SystemExit(f"chip_faults: unknown faults {sorted(set(names) - set(FAULTS))}")
    if not (ROOT / CSRC / "ssd_chunk.cu").is_file():
        raise SystemExit(f"chip_faults: {ROOT} is not a checkout of the repository")
    control = run("control", None)
    results = {name: run(name, FAULTS[name]) for name in names}
    problems = []
    if control["failed"]:
        problems.append(f"the unplanted kernels failed {control['failed']} case(s)")
    for name, row in results.items():
        if not row["failed"]:
            problems.append(f"{name} failed no case")
        must_fail = FAULTS[name][2]
        for case in row["passed_cases"]:
            if case.split("/")[0] in must_fail:
                problems.append(f"{name} passed {case}")
    print(json.dumps({"faults": {n: {"failed": r["failed"], "of": r["cases"]}
                                 for n, r in results.items()},
                      "problems": problems}), flush=True)
    if problems:
        raise SystemExit("chip_faults: FAILED: " + "; ".join(problems))


if __name__ == "__main__":
    main()
