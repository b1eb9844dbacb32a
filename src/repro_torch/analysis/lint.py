"""``python -m repro_torch.analysis.lint`` — one CLI over the passes.

Twin of the reference's ``analysis/lint.py``. Subcommands::

    bundles PATH             audit a manifest dir (or one bundle file):
                             bundle_lint coherence + soundness certification
                             of every reachable plan + the AOT decode
                             program of each port pack, loaded
                             (``decode_lint.lint_executables``)
    decode ARCH [ARCH...]    serve a few requests on each architecture's
                             reduced engine under the port's live decode
                             lint (``decode_lint.lint_run``)
    all --manifest PATH --archs A,B
                             both of the above in one run

The reference's ``decode`` lowers the compiled decode step and reads its
HLO; the port's decode lint reads a serving engine instead (no host sync
inside a block, the state and the arena never move, no capture after
warm-up), so ``decode`` builds the engine on ``--device`` — the card by
default; ``--device cpu`` runs it eagerly, where nothing is captured.

Exit codes: ``0`` clean, ``1`` findings (errors; warnings too under
``--strict``), ``2`` usage or internal failure. ``--json`` emits the
machine-readable report on stdout instead of rendered lines.
"""

from __future__ import annotations

import argparse
import json
import sys
import warnings
from pathlib import Path

from repro_torch.analysis.findings import Report


def _certify(report: Report, bundle, name: str, label: str | None) -> None:
    """Soundness of the bundle's plans and, for a port pack, the audit of
    its loaded decode program."""
    from repro_torch.analysis import decode_lint, soundness

    report.extend(soundness.certify_bundle(bundle, label=label),
                  checked=f"soundness:{name}")
    if bundle.executables is not None and bundle.executables.is_port:
        report.extend(decode_lint.lint_executables(bundle),
                      checked=f"decode_lint:executables:{name}")


def _lint_bundles_path(path: Path) -> Report:
    from repro_torch.analysis import bundle_lint
    from repro_torch.core.artifact import BundleManifest, load_bundle

    if path.is_dir():
        report = bundle_lint.lint_manifest(path)
        seen: set[str] = set()
        try:
            buckets = BundleManifest(path).buckets()
        except Exception:
            return report  # index-unreadable already reported
        for key, entry in sorted(buckets.items()):
            fname = entry.get("file", "")
            if fname in seen:
                continue
            seen.add(fname)
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", DeprecationWarning)
                    bundle = load_bundle(path / fname)
            except Exception:
                continue  # unreadable: bundle_lint reported it
            _certify(report, bundle, key, key)
        return report
    report = Report()
    report.extend(bundle_lint.lint_bundle_file(path), checked=str(path))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            bundle = load_bundle(path)
    except Exception:
        return report
    _certify(report, bundle, path.name, None)
    return report


def _lint_decode(
    archs: list[str], *, n_slots: int, max_len: int, block: int | None,
    greedy: bool, device: str | None,
) -> Report:
    """Each arch's reduced engine (random weights from seed 0) serves
    ``n_slots + 1`` requests, so a slot is reused, under
    ``decode_lint.lint_run``: in blocks of ``block`` waves, or the host
    loop with ``block`` None."""
    import numpy as np
    import torch

    from repro_torch.analysis import decode_lint
    from repro_torch.configs.base import get_reduced
    from repro_torch.models.api import DecoderModel
    from repro_torch.runtime.device import resolve_device
    from repro_torch.runtime.engine import InferenceEngine

    dev = resolve_device(device)
    report = Report()
    for arch in archs:
        cfg = get_reduced(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        engine = InferenceEngine(
            cfg, DecoderModel(cfg, dev).init(gen), n_slots=n_slots,
            max_len=max_len, device=dev, greedy=greedy, block_size=block or 1,
        )
        rng = np.random.default_rng(0)
        for _ in range(n_slots + 1):
            engine.submit(rng.integers(0, cfg.vocab, size=4).astype(np.int32),
                          max_new_tokens=max(min(max_len - 6, 2 * (block or 1)), 1))
        label = f"{arch}|slots{n_slots}|len{max_len}|block{block or 1}"
        report.extend(
            decode_lint.lint_run(engine, engine.run_until_done, label=label),
            checked=f"decode_lint:{label}",
        )
    return report


def _emit(report: Report, args) -> int:
    if args.json:
        print(json.dumps(report.to_obj(), indent=1, sort_keys=True))
    else:
        print(report.render())
    return 0 if report.ok(strict=args.strict) else 1


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="static analysis over plan bundles and the live decode loop",
    )
    parser.add_argument(
        "--strict", action="store_true",
        help="fail (exit 1) on warnings, not just errors",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="emit the machine-readable findings report",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_b = sub.add_parser(
        "bundles", help="audit a manifest directory or one bundle file"
    )
    p_b.add_argument("path", type=Path)

    def add_decode_opts(p):
        p.add_argument("--slots", type=int, default=2)
        p.add_argument("--max-len", type=int, default=32)
        p.add_argument(
            "--block", type=int, default=8,
            help="decode waves per block to serve under the lint "
                 "(0 = the host loop)",
        )
        p.add_argument(
            "--sampled", action="store_true",
            help="serve with on-device sampling instead of greedy",
        )
        p.add_argument(
            "--device", default=None,
            help="torch device of the engines (default: the CUDA card)",
        )

    p_d = sub.add_parser(
        "decode", help="serve each arch's reduced engine under the decode lint"
    )
    p_d.add_argument("archs", nargs="+")
    add_decode_opts(p_d)

    p_a = sub.add_parser("all", help="bundles + decode in one run")
    p_a.add_argument("--manifest", type=Path, required=True)
    p_a.add_argument(
        "--archs", default="",
        help="comma-separated architectures for the decode pass",
    )
    add_decode_opts(p_a)

    args = parser.parse_args(argv)
    try:
        if args.cmd == "bundles":
            return _emit(_lint_bundles_path(args.path), args)
        block = None if getattr(args, "block", 0) == 0 else args.block
        decode = dict(n_slots=args.slots, max_len=args.max_len, block=block,
                      greedy=not args.sampled, device=args.device)
        if args.cmd == "decode":
            return _emit(_lint_decode(args.archs, **decode), args)
        report = _lint_bundles_path(args.manifest)
        archs = [a for a in args.archs.split(",") if a]
        if archs:
            report.merge(_lint_decode(archs, **decode))
        return _emit(report, args)
    except Exception as e:  # usage/internal failure, not a finding
        print(f"lint failed: {type(e).__name__}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
