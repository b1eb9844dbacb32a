"""Audit published plan bundles and their manifest index.

Twin of the reference's ``analysis/bundle_lint.py``, with its finding
codes. A :class:`~repro_torch.core.artifact.BundleManifest` directory is
the serving fleet's source of truth — a stale or incoherent entry
silently degrades every engine that resolves through it (a fingerprint
miss falls back to plan-at-construction on every cold start). This pass
re-derives what the index claims:

* **content addressing** — ``bundle-<sha16>.json`` must be named by the
  sha256 of its canonical encoding (error);
* **index coherence** — every bucket entry's file exists, loads, and its
  ``fingerprint`` / ``total_size`` / ``unified_total`` match the bundle
  document; the bucket key's shape fields match the bundle's own (error);
* **fingerprint freshness** — the stored fingerprint is recomputed as the
  port's ``decode_fingerprint`` from the current config registry, the
  revisions, and the cores recorded in the bundle's provenance; a
  mismatch means the bundle predates a revision (or the config changed,
  or the reference published it) and will be refused at serving time —
  recompile (error);
* **format drift** — v1/v2/v3 documents load through their shims
  (warnings); unknown newer versions are errors;
* **executable coherence** — only when a bundle carries an AOT pack: a
  port pack (``runtime/aot.py``) against its runtime + torch-version +
  device-type key and the port's one entry
  (``artifact.port_executable_entries``), a reference pack against its
  platform + jax-version key and the reference's entry set; both against
  the entries' stored sha256/nbytes. Loading the port's program is
  ``decode_lint.lint_executables``' job;
* **bucket coverage gaps** — within one (arch, layers, width, dtype)
  family the sweep grid should be the full cross product of its observed
  slot counts and cache lengths (warning).

Plan *soundness* (offsets/state collisions) is
:func:`repro_torch.analysis.soundness.certify_bundle`'s job; the CLI and
the publish gate run both.
"""

from __future__ import annotations

import hashlib
import json
import warnings
from pathlib import Path

from repro_torch.analysis.findings import Finding, Report

PASS = "bundle_lint"


def _finding(code, message, where="", severity="error") -> Finding:
    return Finding(
        pass_name=PASS, code=code, message=message, where=where,
        severity=severity,
    )


def _config_candidates(bundle):
    """Current configs that could have produced this bundle: the full and
    reduced variants of its arch (they share ``cfg.name``), with the
    bundle's dtype applied (sweeps compile dtype variants)."""
    import dataclasses

    from repro_torch.configs.base import get_config, get_reduced

    out = []
    for getter in (get_config, get_reduced):
        try:
            cfg = getter(bundle.arch)
        except (KeyError, ValueError, NotImplementedError):
            continue
        if cfg.dtype != bundle.dtype:
            cfg = dataclasses.replace(cfg, dtype=bundle.dtype)
        if (cfg.n_layers, cfg.d_model) == (bundle.n_layers, bundle.d_model):
            out.append(cfg)
    return out


def lint_bundle(
    bundle, *, label: str = "", serve_params: dict | None = None
) -> list[Finding]:
    """Coherence checks on one loaded bundle: current-revision
    fingerprint freshness and internal shape consistency."""
    from repro_torch.core.artifact import decode_fingerprint

    findings: list[Finding] = []
    where = label or f"{bundle.arch}|slots{bundle.n_slots}|len{bundle.max_len}"

    if serve_params is None:
        serve_params = (bundle.provenance or {}).get("serve_params")
    candidates = _config_candidates(bundle)
    if not candidates:
        findings.append(
            _finding(
                "unknown-config",
                f"no current config named {bundle.arch!r} with "
                f"L{bundle.n_layers}/d{bundle.d_model} — freshness "
                f"unverifiable (foreign or renamed architecture)",
                where,
                severity="warning",
            )
        )
    elif not any(
        decode_fingerprint(
            cfg,
            n_slots=bundle.n_slots,
            max_len=bundle.max_len,
            serve_params=serve_params,
            prefill_len=bundle.prefill_len or None,
            cores=(bundle.provenance or {}).get("cores", "kernel"),
        )
        == bundle.fingerprint
        for cfg in candidates
    ):
        findings.append(
            _finding(
                "fingerprint-stale",
                "stored fingerprint does not match a recomputation from "
                "the current config + PIPELINE/PLANNER revisions — the "
                "bundle predates a revision bump or config change (or "
                "another runtime published it) and every engine resolving "
                "it will fall back; recompile",
                where,
            )
        )

    if bundle.state_plan is None:
        findings.append(
            _finding(
                "no-state-plan",
                "bundle carries no cross-step state plan (format v1 shim) "
                "— serving engines must re-plan the state half",
                where,
                severity="warning",
            )
        )
    elif bundle.state_plan.n_slots != bundle.n_slots:
        findings.append(
            _finding(
                "state-slots-mismatch",
                f"state plan lays out {bundle.state_plan.n_slots} slots, "
                f"bundle bucket says {bundle.n_slots}",
                where,
            )
        )
    if (
        bundle.state_plan is not None
        and bundle.state_plan.max_len != bundle.max_len
    ):
        findings.append(
            _finding(
                "state-len-mismatch",
                f"state plan is for cache length "
                f"{bundle.state_plan.max_len}, bundle bucket says "
                f"{bundle.max_len}",
                where,
            )
        )
    plan_page = getattr(bundle.state_plan, "page_size", None)
    serve_page = (serve_params or {}).get("page_size")
    if bundle.state_plan is not None and plan_page != serve_page:
        findings.append(
            _finding(
                "paged-meta-mismatch",
                f"serve config says page_size={serve_page}, state plan "
                f"carries page_size={plan_page} — a paged engine "
                f"resolving this bucket would bind the wrong backend",
                where,
            )
        )

    # v4 prefill coherence: the bucket's prefill_len and the carried
    # prefill plan must agree — a plan without its length (or vice versa)
    # means the fingerprint and the bucket key disagree about what was
    # compiled
    if bool(bundle.prefill_len) != (bundle.prefill_plan is not None):
        findings.append(
            _finding(
                "prefill-meta-mismatch",
                f"bundle says prefill_len={bundle.prefill_len} but "
                f"{'carries no' if bundle.prefill_plan is None else 'carries a'} "
                f"prefill plan — prefill metadata and payload disagree",
                where,
            )
        )

    pack = bundle.executables
    if pack is not None:
        from repro_torch.core.artifact import (expected_executable_entries,
                                              port_executable_entries)

        if pack.is_port:
            # the port's pack: runtime + torch version + the program's device
            key = {"torch_version": pack.torch_version,
                   "device_type": pack.device_type}
            expected = port_executable_entries(paged=bool(serve_page))
        else:
            key = {"platform": pack.platform, "jax_version": pack.jax_version}
            block = int((serve_params or {}).get("block_size", 1))
            expected = expected_executable_entries(block, paged=bool(serve_page))
        if not all(key.values()):
            shown = " ".join(f"{k}={v!r}" for k, v in key.items())
            findings.append(
                _finding(
                    "executable-key-missing",
                    f"AOT pack records {shown} — without every key a "
                    f"serving process cannot refuse a stale or "
                    f"cross-platform executable",
                    where,
                )
            )
        missing = sorted(set(expected) - set(pack.entries))
        if missing:
            findings.append(
                _finding(
                    "executable-missing",
                    f"AOT pack is incomplete for this bucket's serve "
                    f"configuration: missing {missing} — an engine "
                    f"refuses the pack and traces (the port) or "
                    f"lazy-compiles (the reference) at serving time; "
                    f"recompile",
                    where,
                )
            )
        for name, entry in sorted(pack.entries.items()):
            if (
                hashlib.sha256(entry.payload).hexdigest() != entry.sha256
                or entry.nbytes != len(entry.payload)
            ):
                findings.append(
                    _finding(
                        "executable-corrupt",
                        f"AOT executable {name!r} payload does not match "
                        f"its stored sha256/nbytes — corrupted or edited "
                        f"in place",
                        where,
                    )
                )
    return findings


def lint_bundle_file(path: str | Path, *, label: str = "") -> list[Finding]:
    """One ``bundle-*.json`` on disk: format version, content address,
    then :func:`lint_bundle` on the loaded document."""
    from repro_torch.core.artifact import (
        BUNDLE_FORMAT_VERSION,
        bundle_from_obj,
        bundle_to_json,
    )

    path = Path(path)
    where = label or path.name
    try:
        obj = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        return [
            _finding(
                "unreadable-bundle",
                f"cannot read bundle document: {e}",
                where,
            )
        ]
    version = obj.get("format_version") if isinstance(obj, dict) else None
    if version == 1:
        findings = [
            _finding(
                "format-drift",
                "format v1 document (activation half only) — cannot match "
                "a current engine's fingerprint; recompile",
                where,
                severity="warning",
            )
        ]
    elif version == 2:
        findings = [
            _finding(
                "format-drift",
                "format v2 document (no AOT executables, no prefill "
                "plan) — still serves; recompile for a v4 document",
                where,
                severity="warning",
            )
        ]
    elif version == 3:
        findings = [
            _finding(
                "format-drift",
                "format v3 document (no planned prefill arena) — still "
                "serves; recompile with --prefill-len "
                "to carry the full-sequence prefill plan",
                where,
                severity="warning",
            )
        ]
    elif version != BUNDLE_FORMAT_VERSION:
        return [
            _finding(
                "format-unknown",
                f"unsupported format version {version!r} (this build reads "
                f"1-{BUNDLE_FORMAT_VERSION})",
                where,
            )
        ]
    else:
        findings = []
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            bundle = bundle_from_obj(obj)
    except Exception as e:
        findings.append(
            _finding("unreadable-bundle", f"document does not load: {e}",
                     where)
        )
        return findings

    # content address: the filename commits to the canonical bytes
    if version == BUNDLE_FORMAT_VERSION and path.name.startswith("bundle-"):
        sha = hashlib.sha256(bundle_to_json(bundle).encode()).hexdigest()
        want = f"bundle-{sha[:16]}.json"
        if path.name != want:
            findings.append(
                _finding(
                    "content-address-mismatch",
                    f"file is named {path.name} but its canonical content "
                    f"hashes to {want} — edited in place or corrupted",
                    where,
                )
            )
    findings.extend(lint_bundle(bundle, label=where))
    return findings


def _coverage_gaps(keys: list[str]) -> list[Finding]:
    """Within each (arch, layers, width, dtype) family, report missing
    cells of the observed slots × max_len grid."""
    from repro_torch.core.artifact import parse_bucket_key

    families: dict[tuple, set[tuple[int, int]]] = {}
    for key in keys:
        got = parse_bucket_key(key)
        if got is None:
            continue
        # paged/symmetric and prefill/decode-only buckets are separate
        # families: their grids are swept (and served) independently
        fam = (
            got["arch"], got["n_layers"], got["d_model"], got["dtype"],
            got.get("page_size"), got.get("prefill_len"),
        )
        families.setdefault(fam, set()).add((got["n_slots"], got["max_len"]))
    findings = []
    for fam, cells in sorted(
        families.items(), key=lambda kv: tuple(map(str, kv[0]))
    ):
        slots = sorted({s for s, _ in cells})
        lens = sorted({l for _, l in cells})
        missing = [
            (s, l) for s in slots for l in lens if (s, l) not in cells
        ]
        if missing:
            page = f"|page{fam[4]}" if fam[4] else ""
            findings.append(
                _finding(
                    "coverage-gap",
                    f"sweep grid incomplete: compiled slots {slots} x "
                    f"lens {lens} but missing "
                    f"{['slots%d|len%d' % m for m in missing]}",
                    f"{fam[0]}|L{fam[1]}|d{fam[2]}|{fam[3]}{page}",
                    severity="warning",
                )
            )
    return findings


def lint_manifest(directory: str | Path) -> Report:
    """Audit a whole manifest directory: the index against the bundle
    files, every reachable bundle document, and the sweep coverage."""
    from repro_torch.core.artifact import (
        BundleManifest,
        bundle_bucket_key,
        load_bundle,
    )

    report = Report()
    directory = Path(directory)
    manifest = BundleManifest(directory)
    try:
        buckets = manifest.buckets()
    except Exception as e:
        return report.extend(
            [_finding("index-unreadable", f"manifest index unusable: {e}",
                      str(directory))],
            checked=str(directory),
        )

    seen_files: set[str] = set()
    for key, entry in sorted(buckets.items()):
        fname = entry.get("file", "")
        fpath = directory / fname
        if not fpath.is_file():
            report.extend(
                [_finding("missing-file",
                          f"index points at {fname} which does not exist",
                          key)],
                checked=key,
            )
            continue
        findings = []
        if fname not in seen_files:
            seen_files.add(fname)
            findings += lint_bundle_file(fpath, label=fname)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                bundle = load_bundle(fpath)
        except Exception:
            report.extend(findings, checked=key)
            continue  # unreadable: already reported by lint_bundle_file
        if entry.get("fingerprint") != bundle.fingerprint:
            findings.append(
                _finding(
                    "index-fingerprint-mismatch",
                    f"index fingerprint {str(entry.get('fingerprint'))[:12]} "
                    f"!= bundle {bundle.fingerprint[:12]}",
                    key,
                )
            )
        if entry.get("total_size") != bundle.plan.total_size:
            findings.append(
                _finding(
                    "index-total-mismatch",
                    f"index total_size {entry.get('total_size')} != plan "
                    f"{bundle.plan.total_size}",
                    key,
                )
            )
        if (
            "unified_total" in entry
            and entry["unified_total"] != bundle.total_size
        ):
            findings.append(
                _finding(
                    "index-total-mismatch",
                    f"index unified_total {entry['unified_total']} != "
                    f"bundle {bundle.total_size}",
                    key,
                )
            )
        canonical = bundle_bucket_key(bundle)
        if canonical is not None and canonical != key:
            findings.append(
                _finding(
                    "bucket-key-mismatch",
                    f"index key does not match the bundle's own shape "
                    f"fields ({canonical})",
                    key,
                )
            )
        report.extend(findings, checked=key)

    report.extend(_coverage_gaps(list(buckets)), checked="coverage")
    return report


__all__ = [
    "lint_bundle",
    "lint_bundle_file",
    "lint_manifest",
]
