#!/usr/bin/env python3
"""Plant faults in copies of the CUDA kernels and of the paged decode
path, and show that ``chip_smoke.py``'s kernel checks catch them. Needs
one card.

    python3 chip_faults.py        # from the repository root
    python3 chip_faults.py --faults b_c_one_group   # the control and one fault

For each fault below, the port (``src/repro_torch``) and ``chip_smoke.py``
are copied to ``build/faults/<fault>/`` (ignored by git), the fault is
planted in the copy's source by text substitutions (a kernel source, or
a module of the decode step), and the copy runs ``chip_smoke.py --phases
kernels --keep-going``: every kernel case is checked, and the failed
cases of the planted kernel (or of the checks that run the planted
module) are listed. The unplanted tree is run the same way first, as the
control.

``ssd_chunk.cu`` holds two kernels, the tensor-core one (bf16 x/B/C) and
the CUDA-core one (fp32 x/B/C); each ``ssd_chunk`` fault except
``drop_lo`` is planted in both (``b_c_one_group`` in the host entry both
share). ``drop_lo`` is planted in ``ssd_tc.cuh``'s ``split3``, which the
tensor-core kernels of the forward and the backward share; it is judged
on the forward's rows (the kernels phase runs no backward). ``flash_decode.cu`` builds ``flash_decode`` and
``flash_decode_paged`` from two kernels (the CUDA-core one and, for bf16
at (192, 12), the tensor-core one) that share the merge and the paged
address: a ``flash_decode`` fault's run lists the cases of both ops, and
``paged_table_ignored`` is planted in the paged address only. ``ring_clamped`` (``models/attention.py``) writes a
ring's new K/V row at ``min(pos, T - 1)`` in place of ``pos % T``: the
wrapped-ring cases must fail, rings before their wrap read right.
``state_put_ignores_table`` (``models/paged.py``) puts a Mamba2 layer's
state into logical pages as if the page table were the identity: the
shuffled paged Mamba2 cases must fail. ``bundle_fingerprint_ignored``
(``core/unified.py``) makes a plan session's fingerprint comparison
always true: it is run through the ``serve_bundle`` phase (the control
too, when it is asked for), whose planted mismatch (a bundle for blocks
of 8 handed to a host-loop engine) must fail while the bundles that fit
still serve. ``aot_key_ignored`` (``runtime/aot.py``) makes the AOT
loader take a pack whatever torch version its key names: it is run
through the ``serve_aot`` phase, whose planted stale pack must fail while
the packs that fit still serve. ``ssd_bwd_tc_drops_state_chain``
and ``ssd_bwd_drops_state_chain`` (``ssd_chunk_bwd.cu``) drop
exp(total)·dns from the state gradient the backward hands the chunk
before, in its tensor-core kernel (bf16 x/B/C) and in its CUDA-core one
(fp32): each is run through the ``kernels_ssd_bwd`` and ``train_mamba2``
phases, where the first must fail the bf16 chained cases and nothing
else (train_mamba2's bf16 gradient bar lets it pass), the second the
fp32 chained cases, the fp32 autograd over the chain and the 3-chunk
slow-decay gradient check, and nothing else. A fault run through a phase
other than kernels must fail exactly its ``must_fail`` cases; a
``must_fail`` entry with a ``/`` names one dtype's case
(``case/dtype[/state_dtype]``), one without it the case in every dtype.

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

# fault -> (the kernel rows it is judged on (or the phase, for a phase
#           other than kernels), the file planted (in src/repro_torch),
#           [(text in the file, its replacement), ...], cases it must fail
#           in every dtype)
SLOW_CASES = ("slow_L256", "slow_L200_P8", "one_group_slow_L96", "prefill_slow")
# qwen3's serving shape, and granite-moe's (64, 3): 8 spans of 128 with
# empty ones, and its serving shape; nemotron's (192, 12) with 8 spans of
# 128 (bf16 on the tensor-core kernel, fp32 on the CUDA-core one)
FD_MUST_FAIL = ("serving_full", "D64_G3_empty_spans", "granite_serving_full",
                "D192_G12_empty_spans")
# flash_decode_paged's cases with a shuffled table (chip_smoke.py's
# PAGED_CASES and the qwen3 serving layout)
PAGED_SHUFFLED = ("paged_P16384_shuffled", "paged_P65536_shuffled",
                  "paged_P1040_shuffled", "paged_D320_G2_P1040_shuffled",
                  "paged_D320_G2_P16384_shuffled", "paged_D64_G3_P65536_shuffled",
                  "paged_D192_G12_P65536_shuffled", "nemotron_span_P65536_shuffled",
                  "paged_P16384_shuffled_hole", "qwen3_serving_full_shuffled",
                  "qwen3_serve_mix_shuffled", "gemma3_ring_P65536_shuffled",
                  "zamba2_P65536_shuffled")
# the ring cases past their wrap (chip_smoke.py's phase_kernels_ring)
RING_WRAPPED = ("ring_wrapped_T8_W8", "ring_wrapped_T8_W13", "ring_wrapped_T64_W64",
                "ring_wrapped_T64_W1024", "ring_wrapped_D320_G2_T1024",
                "ring_decode_vs_prefill", "gemma3_ring_wrapped")
# the paged Mamba2 steps (chip_smoke.py's STATE_PUT_CASES)
STATE_PUT = tuple(f"state_put_{arch}_P{page}_shuffled"
                  for arch in ("mamba2-2.7b", "zamba2-7b") for page in (16384, 65536))
# the backward's chained cases, a chunk whose upstream state gradient is
# not zero (chip_smoke.py's kernels_ssd_bwd), by the kernel that runs them:
# bf16 x/B/C the tensor-core kernel; fp32 the CUDA-core one, with the fp32
# autograd over the chain and the 3-chunk fp32 gradient check at the slow
# decay (train_mamba2)
SSD_BWD_CHAIN_BF16 = tuple(f"chain_{arch}_{part}/bfloat16/bfloat16"
                           for arch in ("mamba2", "zamba2") for part in ("chunk2", "chunk1"))
SSD_BWD_CHAIN_FP32 = tuple(f"chain_{arch}_{part}/float32/float32"
                           for arch in ("mamba2", "zamba2")
                           for part in ("chunk2", "chunk1", "autograd")) + (
    "train_mamba2_grads_fp32_slow/float32",)
SSD, FD = "kernels/csrc/ssd_chunk.cu", "kernels/csrc/flash_decode.cu"
SSD_TC, SSD_BWD = "kernels/csrc/ssd_tc.cuh", "kernels/csrc/ssd_chunk_bwd.cu"
FAULTS = {
    # y without the incoming state's contribution
    "drop_y_inter": ("ssd_chunk", SSD, [
        ("const float v = acc[k] + expf(static_cast<float>(cum[i])) * inter[k];",
         "const float v = acc[k];"),
        ("for (int e = 0; e < 4; ++e) acc[t][e] *= e < 2 ? e_top : e_bot;",
         "for (int e = 0; e < 4; ++e) acc[t][e] *= 0.f;"),
    ], SLOW_CASES),
    # the new state without state * exp(total)
    "drop_state_decay": ("ssd_chunk", SSD, [
        ("store(nsb + idx, s0 * decay + acc[a]);",
         "store(nsb + idx, acc[a] + 0.f * s0 * decay);"),
        ("store(nsb + idx, s0 * decay + acc[t][e]);",
         "store(nsb + idx, acc[t][e] + 0.f * s0 * decay);"),
    ], SLOW_CASES),
    # the causal mask lets position i see position i + 1
    "mask_j_eq_i_plus_1": ("ssd_chunk", SSD, [
        ("const bool keep = j <= i && i < L;",
         "const bool keep = j <= i + 1 && j < L && i < L;"),
        ("const bool keep_w = j <= i && i < L;",
         "const bool keep_w = j <= i + 1 && j < L && i < L;"),
    ], SLOW_CASES),
    # every head reads head 0's B and C (their head strides taken as 0): one
    # group still reads right, two groups do not (zamba2's layout)
    "b_c_one_group": ("ssd_chunk", SSD, [
        ("for (int i = 0; i < kStrides; ++i) st.v[i] = strides[i];",
         "for (int i = 0; i < kStrides; ++i) st.v[i] = i == 12 || i == 16 ? 0 : strides[i];"),
    ], ("two_groups_L96", "zamba2_prefill")),
    # W, the decayed x and an fp32 state fed as hi + mid only (tensor cores)
    "drop_lo": ("ssd_chunk", SSD_TC, [
        ("const __nv_bfloat162 l = __floats2bfloat162_rn(ra - mf.x, rb - mf.y);",
         "const __nv_bfloat162 l = __floats2bfloat162_rn(0.f, 0.f);"),
    ], ()),
    # the merge leaves out the partial of the last span of T
    "drop_last_span": ("flash_decode", FD, [
        ("for (int s = 0; s < n_split; ++s) {",
         "for (int s = 0; s < n_split - 1; ++s) {"),
        ("for (int s = 0; s < n_split; ++s) o += __ldcg(acc + s * G * D + idx) * sm_w[s * G + g];",
         "for (int s = 0; s < n_split - 1; ++s) o += __ldcg(acc + s * G * D + idx) * sm_w[s * G + g];"),
        # the tensor-core path's sum (merge_spans_wide)
        ("for (int s = 0; s != n_split; ++s) {",
         "for (int s = 0; s != n_split - 1; ++s) {"),
    ], FD_MUST_FAIL),
    # the merge weighs every partial by 1, not by exp(m_s - m)
    "merge_weight_one": ("flash_decode", FD, [
        ("const float weight = expf(sm_w[s * G + g] - mx);",
         "const float weight = 1.f;"),
    ], FD_MUST_FAIL),
    # the paged kernel takes a slot's pages as consecutive from its first
    # table entry, as if the table were the identity past it: an ascending
    # table still reads right, a shuffled one does not
    "paged_table_ignored": ("flash_decode", FD, [
        ("return buf + static_cast<int64_t>(__ldg(row + page)) * pe + (e - page * pe);",
         "return buf + (static_cast<int64_t>(__ldg(row)) + page) * pe + (e - page * pe);"),
    ], PAGED_SHUFFLED),
    # a ring written at min(pos, T - 1), as a global cache is: past the
    # wrap every new row lands on the last slot
    "ring_clamped": ("flash_decode", "models/attention.py", [
        ("return pos_b % T if window is not None else torch.clamp(pos_b, max=T - 1)",
         "return torch.clamp(pos_b, max=T - 1)"),
    ], RING_WRAPPED),
    # a Mamba2 layer's state put into logical pages, the table ignored
    "state_put_ignores_table": ("mamba_decode_paged", "models/paged.py", [
        ("idx = self.table[:, p0:p1].long()",
         "idx = torch.arange(p0, p1, device=self.table.device).expand(B, -1)"),
    ], STATE_PUT),
    # a plan session takes any bundle its lookup finds, whatever its
    # fingerprint: the mismatch case must fail
    "bundle_fingerprint_ignored": ("serve_bundle", "core/unified.py", [
        ("        if bundle.fingerprint != expect:\n",
         "        if False:  # planted: the fingerprint is ignored\n"),
    ], ("mismatch",)),
    # the loader takes a pack whatever torch version its key names: the
    # planted stale pack must fail, and nothing else
    "aot_key_ignored": ("serve_aot", "runtime/aot.py", [
        ("    if pack.torch_version != torch.__version__:\n",
         "    if False:  # planted: the torch version is ignored\n"),
    ], ("stale",)),
    # dstate without exp(total)·dns: the state gradient a chunk hands the
    # one before it loses what came from the chunks after it. A chunk whose
    # upstream state gradient is zero (the last one) is unchanged, and so
    # is a chain whose decay leaves exp(total) below fp32 resolution. In the
    # tensor-core kernel (bf16 x/B/C), then in the CUDA-core one (fp32)
    "ssd_bwd_tc_drops_state_chain": ("ssd_chunk_bwd", SSD_BWD, [
        ("store(dsb + pp * N + n, fmaf(etot, d0, acc[u][e]));",
         "store(dsb + pp * N + n, acc[u][e] + 0.f * etot * d0);"),
    ], SSD_BWD_CHAIN_BF16),
    "ssd_bwd_drops_state_chain": ("ssd_chunk_bwd", SSD_BWD, [
        ("store(dsb + p * N + n, fmaf(etot, d0, dsa[a][c]));",
         "store(dsb + p * N + n, dsa[a][c] + 0.f * etot * d0);"),
    ], SSD_BWD_CHAIN_FP32),
}
# the phases other than kernels that faults are run through
PHASE_OF = {"serve_bundle": "serve_bundle", "serve_aot": "serve_aot",
            "ssd_chunk_bwd": "kernels_ssd_bwd,train_mamba2"}


def named(label: str, entries) -> bool:
    """Whether a case label (``case/dtype[/state_dtype]``) is among
    ``must_fail`` entries: an entry with a ``/`` names that label, one
    without it the case in every dtype."""
    return any(label == e or label.split("/")[0] == e for e in entries)


def label(row: dict) -> str:
    if "dtype" not in row:
        return row["case"]
    if "state_dtype" not in row:
        return f"{row['case']}/{row['dtype']}"
    return f"{row['case']}/{row['dtype']}/{row['state_dtype']}"


def judged(row: dict) -> str:
    """What a case row is judged as: its kernel, or its phase."""
    return row.get("kernel") or row.get("phase", "")


def run(name: str, fault: tuple | None, phases: str = "kernels") -> dict:
    dst = ROOT / "build" / "faults" / name
    if dst.exists():
        shutil.rmtree(dst)
    dst.mkdir(parents=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch")
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    kernel = None
    if fault is not None:
        kernel, planted, subs, _ = fault
        path = dst / "src" / "repro_torch" / planted
        src = path.read_text()
        for old, new in subs:
            if src.count(old) != 1:
                raise SystemExit(f"chip_faults: {name}: {old!r} is not in "
                                 f"{planted} exactly once")
            src = src.replace(old, new)
        path.write_text(src)
    if fault is not None:
        phases = PHASE_OF.get(kernel, "kernels")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py", "--phases", phases, "--keep-going"],
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
        if "case" in row and judged(row).startswith(kernel or ""):
            cases.append(row)
    if not cases:
        raise SystemExit(f"chip_faults: {name}: no case ran\n{out.stdout}\n{out.stderr}")
    failed = [label(r) for r in cases if not r["ok"]]
    passed = [label(r) for r in cases if r["ok"]]
    worst = {label(r): max(r["y"]["err_over_bar"], r["new_state"]["err_over_bar"])
             for r in cases if r.get("kernel") == "ssd_chunk"}
    row = {"fault": name, "kernel": kernel, "phases": phases, "cases": len(cases),
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
    control = run("control", None, ",".join(sorted(
        {PHASE_OF.get(FAULTS[n][0], "kernels") for n in names})))
    results = {name: run(name, FAULTS[name]) for name in names}
    problems = []
    if control["failed"]:
        problems.append(f"the unplanted kernels failed {control['failed']} case(s)")
    for name, row in results.items():
        if not row["failed"]:
            problems.append(f"{name} failed no case")
        must_fail = FAULTS[name][3]
        for case in row["passed_cases"]:
            if named(case, must_fail):
                problems.append(f"{name} passed {case}")
        if FAULTS[name][0] in PHASE_OF:
            extra = sorted(c for c in row["failed_cases"] if not named(c, must_fail))
            if extra:
                problems.append(f"{name} failed {extra} beside its {list(must_fail)}")
    print(json.dumps({"faults": {n: {"failed": r["failed"], "of": r["cases"]}
                                 for n, r in results.items()},
                      "problems": problems}), flush=True)
    if problems:
        raise SystemExit("chip_faults: FAILED: " + "; ".join(problems))


if __name__ == "__main__":
    main()
