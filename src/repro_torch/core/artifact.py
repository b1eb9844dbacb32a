"""Plan bundles: ahead-of-time compiled memory plans as serving artifacts.

Twin of the reference's ``core/artifact.py``. The paper's planner is an
ahead-of-time optimization — "the memory manager needs to run only once
before the first inference" (§5). A :class:`PlanBundle` carries what a
serving process needs to lay out both halves of its memory without
running a planning strategy or a state layout:

* the chosen :class:`~repro_torch.core.planner.MemoryPlan` of the decode
  step (usage records, strategy, offsets, total size) through ``plan_io``;
* the cross-step :class:`~repro_torch.core.unified.StatePlan` (symmetric
  slot regions or a page pool), so one artifact round-trips a full
  :class:`~repro_torch.core.unified.UnifiedPlan` (:func:`unified_from_bundle`);
* the searched order / fusion partition when ``launch/compile.py
  --search`` found a smaller plan than program order (the port's
  executor runs program order, so an engine refuses such a bundle and
  plans at construction);
* two fingerprints: the config-level :func:`decode_fingerprint`, checked
  before anything is traced, and the structural :func:`graph_fingerprint`
  of the traced decode step, which the engine compares with its own trace
  of the step before it hands the plan to its executor;
* an optional prefill plan (``--prefill-len``), carried as metadata.

Bundles are stored content-addressed under a directory managed by
:class:`BundleManifest`: the file is named by the sha256 of its canonical
JSON (byte-deterministic — ``plan_wall_s`` is zeroed at publish time),
and ``manifest.json`` maps bucket keys (``arch|layers|d_model|slots|len|
dtype[|page][|pf]``) to bundle files. Loaders reject unknown newer format
versions; older ones load through shims with one ``DeprecationWarning``.
A truncated or garbage ``manifest.json`` is quarantined (renamed
``manifest.json.corrupt-<ts>``) and the index rebuilt from the
``bundle-*.json`` files on disk.

Where the port departs from the reference on purpose:

* :func:`decode_fingerprint` adds ``"runtime": "repro_torch"`` to the
  reference's payload, and ``"cores"`` when the engine's cores are not
  ``"kernel"``. The configs are field for field the reference's, so
  without the marker a bundle the reference published would match the
  port's fingerprint while its activation plan covers a jaxpr's records,
  not the fx graph's; with it such a bundle is refused by fingerprint and
  the engine plans at construction;
* the port's own AOT pack (``runtime/aot.py``) is keyed by
  ``runtime: "repro_torch"``, the torch version and the device type its
  program was traced on (``meta``: the loader retargets it), where the
  reference keys its pack by platform and jax version. Its one entry is
  the decode program (:func:`port_executable_entries`). A reference
  bundle's pack keeps its own key and is carried as opaque bytes:
  encoded, decoded and linted, never deserialised or run.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import hashlib
import json
import os
import re
import time
import warnings
from pathlib import Path
from typing import TYPE_CHECKING, Any

from repro_torch.core import plan_io
from repro_torch.core.unified import (
    StatePlan,
    UnifiedPlan,
    state_plan_from_obj,
    state_plan_to_obj,
)

if TYPE_CHECKING:
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core.graph import Graph
    from repro_torch.core.planner import MemoryPlan

# v2: + state_plan (cross-step slot/KV layout), + n_layers/d_model (the
# bucket-key shape fields, so a manifest index can be rebuilt from bundle
# files alone)
# v3: + executables (AOT-serialized decode functions: the reference's,
# platform + jax-version keyed, or the port's programs, runtime +
# torch-version keyed)
# v4: + prefill_plan/prefill_len (the planned prefill activation arena —
# long-lifetime full-sequence regime — compiled alongside the decode
# plan; the prefill shape joins the fingerprint and the bucket key)
BUNDLE_FORMAT_VERSION = 4

# What ``decode_fingerprint`` hashes is versioned SEPARATELY from the
# bundle container: the v2->v3 rev only ADDS the executable payload (the
# graph-shaping inputs are untouched), so v2 bundles must keep
# fingerprint-matching a v3 engine and degrade to lazy compile — not fall
# all the way back to plan-at-construction. Bump this only when the
# fingerprint *payload itself* changes meaning.
FINGERPRINT_SCHEMA_VERSION = 2

# The manifest index schema is versioned separately: v1 manifest dirs
# remain readable across the bundle v1->v2 rev (their per-bucket entries
# just point at bundles a v2 engine will refuse by fingerprint).
MANIFEST_FORMAT_VERSION = 1

# Revision of the trace→plan pipeline semantics. Part of every
# fingerprint: bump it when the tracer, graph extraction, or any MODEL
# IMPLEMENTATION (``models/``) may produce a different decode graph for
# the same config, so previously compiled bundles self-invalidate. The
# engine also compares the stored ``graph_fingerprint`` with its own
# trace of the step, which catches a code change this constant missed.
# Planner output changes are covered by ``plan_io.PLANNER_REVISION``.
PIPELINE_REVISION = 1


# ------------------------------------------------------------ fingerprints


def _sha(payload: Any) -> str:
    text = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(text.encode()).hexdigest()


def serve_fingerprint(
    *,
    block_size: int = 1,
    greedy: bool = True,
    temperature: float = 1.0,
    top_k: int = 0,
    page_size: "int | None" = None,
    page_pool: "int | None" = None,
) -> "dict | None":
    """Canonical serve-loop payload for :func:`decode_fingerprint`: the
    sampling knobs + block size that shape the captured serving graphs
    (the block wave's graph holds the on-device sampler), and the
    paged-state knobs (the page table is
    a decode input whose shape — and the physical buffer size — follow
    ``page_size``/``page_pool``). Returns ``None`` for the default
    single-wave greedy host loop so default fingerprints — and every
    pre-existing bundle — are unchanged. Greedy canonicalizes
    ``temperature``/``top_k`` away (they do not shape the greedy graph);
    the sample seed never joins (it is a traced key argument, not graph
    structure)."""
    if greedy:
        temperature, top_k = 1.0, 0
    if block_size == 1 and greedy and not page_size:
        return None
    payload = {
        "block_size": int(block_size),
        "greedy": bool(greedy),
        "temperature": float(temperature),
        "top_k": int(top_k),
    }
    if page_size:
        payload["page_size"] = int(page_size)
        if page_pool is not None:
            payload["page_pool"] = int(page_pool)
    return payload


def decode_fingerprint_payload(
    cfg: "ArchConfig",
    *,
    n_slots: int,
    max_len: int,
    serve_params: "dict | None" = None,
    prefill_len: "int | None" = None,
    cores: str = "kernel",
) -> dict:
    """What :func:`decode_fingerprint` hashes: the reference's payload
    (the architecture config minus ``source``, the bucket, the
    pipeline/planner revisions, the :func:`serve_fingerprint` payload and
    ``prefill_len`` when set) plus ``"runtime": "repro_torch"`` and, when
    the decode step's cores are not ``"kernel"``, ``"cores"`` (the plain
    cores trace another graph)."""
    cfg_obj = dataclasses.asdict(cfg)
    cfg_obj.pop("source", None)
    payload = {
        "format_version": FINGERPRINT_SCHEMA_VERSION,
        "pipeline_revision": PIPELINE_REVISION,
        "planner_revision": plan_io.PLANNER_REVISION,
        "config": cfg_obj,
        "n_slots": n_slots,
        "max_len": max_len,
        "runtime": "repro_torch",
    }
    if serve_params:
        payload["serve_params"] = serve_params
    if prefill_len:
        payload["prefill_len"] = int(prefill_len)
    if cores != "kernel":
        payload["cores"] = cores
    return payload


def decode_fingerprint(
    cfg: "ArchConfig",
    *,
    n_slots: int,
    max_len: int,
    serve_params: "dict | None" = None,
    prefill_len: "int | None" = None,
    cores: str = "kernel",
) -> str:
    """Hash of everything that shapes the decode-step graph, computable in
    microseconds — no trace, no planner (:func:`decode_fingerprint_payload`).
    ``serve_params`` and ``prefill_len`` join only when set, so bundles
    compiled for one serving configuration self-invalidate under
    another."""
    return _sha(decode_fingerprint_payload(
        cfg, n_slots=n_slots, max_len=max_len, serve_params=serve_params,
        prefill_len=prefill_len, cores=cores,
    ))


def graph_fingerprint(graph: "Graph") -> str:
    """Structural hash of a traced graph: op names and tensor wiring in
    execution order, tensor byte sizes, boundary set. Two graphs with the
    same fingerprint yield identical usage records, hence identical plans."""
    return _sha(
        {
            "ops": [
                [op.name, list(op.inputs), list(op.outputs)]
                for op in graph.ops
            ],
            "tensors": sorted(
                (t.tensor_id, t.nbytes) for t in graph.tensors.values()
            ),
            "boundary": sorted(graph.boundary_ids),
        }
    )


def bucket_key(
    cfg: "ArchConfig", *, n_slots: int, max_len: int,
    page_size: "int | None" = None,
    prefill_len: "int | None" = None,
) -> str:
    """Human-readable manifest index for an (arch, n_slots, max_len, dtype
    [, page_size][, prefill_len]) serving bucket. Layer count / width
    distinguish full configs from their ``reduced()`` variants, which
    share ``cfg.name``; paged buckets carry a ``|page{P}`` suffix so a
    paged and a symmetric compile of the same shape coexist in one
    manifest; prefill-carrying buckets add ``|pf{S}`` (the planned prefill
    sequence length). The fingerprint (stored alongside) remains the
    actual correctness guard."""
    key = (
        f"{cfg.name}|L{cfg.n_layers}|d{cfg.d_model}"
        f"|slots{n_slots}|len{max_len}|{cfg.dtype}"
    )
    if page_size:
        key += f"|page{int(page_size)}"
    if prefill_len:
        key += f"|pf{int(prefill_len)}"
    return key


_BUCKET_KEY_RE = re.compile(
    r"(?P<arch>.+)\|L(?P<n_layers>\d+)\|d(?P<d_model>\d+)"
    r"\|slots(?P<n_slots>\d+)\|len(?P<max_len>\d+)\|(?P<dtype>[^|]+?)"
    r"(\|page(?P<page_size>\d+))?(\|pf(?P<prefill_len>\d+))?"
)


def parse_bucket_key(key: str) -> dict | None:
    """Inverse of :func:`bucket_key`: the structured bucket, or None for a
    foreign/hand-made key (bucket auto-selection skips those).
    ``page_size`` is None for symmetric buckets; ``prefill_len`` is None
    for decode-only buckets."""
    m = _BUCKET_KEY_RE.fullmatch(key)
    if m is None:
        return None
    out: dict[str, Any] = m.groupdict()
    for field in ("n_layers", "d_model", "n_slots", "max_len"):
        out[field] = int(out[field])
    for field in ("page_size", "prefill_len"):
        out[field] = int(out[field]) if out[field] is not None else None
    return out


def bundle_bucket_key(bundle: PlanBundle) -> str | None:
    """Reconstruct the canonical bucket key from a bundle's own fields —
    the manifest-rebuild path. None for bundles that predate the shape
    fields (v1 shims, hand-built test bundles)."""
    if not bundle.n_layers or not bundle.d_model:
        return None
    key = (
        f"{bundle.arch}|L{bundle.n_layers}|d{bundle.d_model}"
        f"|slots{bundle.n_slots}|len{bundle.max_len}|{bundle.dtype}"
    )
    page_size = getattr(bundle.state_plan, "page_size", None)
    if page_size:
        key += f"|page{int(page_size)}"
    if bundle.prefill_len:
        key += f"|pf{int(bundle.prefill_len)}"
    return key


# ------------------------------------------------------------- executables


def _payload_sha(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


@dataclasses.dataclass
class ExecutableEntry:
    """One AOT-serialized decode function: the reference's compiled
    executable (carried opaque) or the port's exported program."""

    payload: bytes
    sha256: str  # of payload — integrity check before deserialization
    nbytes: int  # == len(payload); surfaced in docs/lint size reporting


def executable_entry(payload: bytes) -> ExecutableEntry:
    return ExecutableEntry(
        payload=payload, sha256=_payload_sha(payload), nbytes=len(payload)
    )


# the ``runtime`` key of a pack the port wrote
PORT_RUNTIME = "repro_torch"


@dataclasses.dataclass
class ExecutablePack:
    """The v3 AOT half: serialized decode functions and the key a loader
    refuses a stale pack by. The reference's pack is keyed by the
    platform and jax version it was compiled under; the port's by
    ``runtime`` (``"repro_torch"``), the torch version and the device
    type its program was traced on. The port's program is an exported
    aten graph whose custom ops dispatch by the tensors' device at run
    time and whose kernels are built at first use, so nothing in it is
    specific to a card's compute capability and none is recorded."""

    entries: dict[str, ExecutableEntry]
    platform: str | None = None  # the reference's backend at compile time
    jax_version: str | None = None
    runtime: str | None = None  # PORT_RUNTIME for the port's packs
    torch_version: str | None = None
    device_type: str | None = None

    @property
    def nbytes(self) -> int:
        return sum(e.nbytes for e in self.entries.values())

    @property
    def is_port(self) -> bool:
        return self.runtime == PORT_RUNTIME

    @property
    def key(self) -> str:
        """The pack's key in one line, for summaries and warnings."""
        if self.runtime is not None:
            return f"{self.runtime} torch {self.torch_version} on {self.device_type}"
        return f"{self.platform} jax {self.jax_version}"


def executables_to_obj(pack: ExecutablePack) -> dict:
    if pack.runtime is not None:
        key = {"runtime": pack.runtime, "torch_version": pack.torch_version,
               "device_type": pack.device_type}
    else:
        key = {"platform": pack.platform, "jax_version": pack.jax_version}
    return {
        **key,
        "entries": {
            name: {
                "payload_b64": base64.b64encode(entry.payload).decode(
                    "ascii"
                ),
                "sha256": entry.sha256,
                "nbytes": entry.nbytes,
            }
            for name, entry in sorted(pack.entries.items())
        },
    }


def block_entry_name(backend: str, length: int) -> str:
    """Pack entry name for a scan-block executable
    (``resident_block_4``, ``pytree_block_4``, ...)."""
    return f"{backend}_block_{int(length)}"


def expected_executable_entries(
    block_size: int = 1, *, paged: bool = False
) -> list[str]:
    """The entry names a complete REFERENCE pack carries for one serving
    bucket (the port's: :func:`port_executable_entries`): decode + reset
    for BOTH state backends (residency is a serving-time
    knob the compile step cannot predict; paged buckets pair the paged
    backend with the pytree fallback), plus the full-size scan block on
    block-mode buckets (tail blocks have engine-chosen shorter lengths
    and lazy-compile)."""
    backend = "paged" if paged else "resident"
    names = [
        "pytree_decode",
        "pytree_reset",
        f"{backend}_decode",
        f"{backend}_reset",
    ]
    if block_size > 1:
        names.append(block_entry_name(backend, block_size))
        names.append(block_entry_name("pytree", block_size))
    return sorted(names)


def port_executable_entries(*, paged: bool = False) -> list[str]:
    """The entry names of a complete port pack: ONE decode program,
    ``resident_decode`` or under paging ``paged_decode``. The port's
    slot reset and block wave are eager code around that program (the
    block wave is captured as a CUDA graph at construction), and its
    residency-off backend runs the model's step eagerly, so no entry
    stands for them."""
    return ["paged_decode" if paged else "resident_decode"]


def executables_from_obj(obj: dict) -> ExecutablePack:
    entries = {}
    for name, e in obj.get("entries", {}).items():
        entries[name] = ExecutableEntry(
            payload=base64.b64decode(e["payload_b64"]),
            sha256=e["sha256"],
            nbytes=e["nbytes"],
        )
    if "runtime" in obj:
        return ExecutablePack(
            entries=entries, runtime=obj["runtime"],
            torch_version=obj["torch_version"], device_type=obj["device_type"],
        )
    return ExecutablePack(
        platform=obj["platform"],
        jax_version=obj["jax_version"],
        entries=entries,
    )


# ----------------------------------------------------------------- bundles


@dataclasses.dataclass
class PlanBundle:
    """One compiled decode-graph memory plan, ready to serve from.

    ``plan.plan_wall_s`` is normalized to 0.0 so the canonical encoding is
    byte-deterministic (content addressing stays stable across recompiles
    of an unchanged graph).
    """

    fingerprint: str  # decode_fingerprint of the compiled bucket
    graph_fingerprint: str  # structural hash of the traced graph
    arch: str
    n_slots: int
    max_len: int
    dtype: str
    plan: "MemoryPlan"
    # searched-order op permutation (original index order) when order
    # search won; None when the default program order was kept
    order: list[int] | None = None
    # fusion partition (contiguous op-index groups) when fusion won
    fusion_groups: list[list[int]] | None = None
    # deterministic compile-time metadata: tool, strategy, search stats,
    # greedy-vs-searched footprints, the decode step's cores
    provenance: dict = dataclasses.field(default_factory=dict)
    # v2: cross-step slot/KV state layout — None only in v1-shim bundles
    state_plan: StatePlan | None = None
    # v2: bucket-key shape fields (reduced() variants share cfg.name), so
    # the manifest index is rebuildable from bundle files alone; 0 means
    # "unknown" (v1-shim bundles, hand-built test bundles)
    n_layers: int = 0
    d_model: int = 0
    # v3: AOT-serialized decode functions — the port's decode program
    # (``runtime/aot.py``; ``launch/compile.py --no-aot`` leaves None),
    # or a reference pack, carried opaque
    executables: ExecutablePack | None = None
    # v4: the planned prefill activation arena (full-sequence forward at
    # ``prefill_len`` tokens — the long-lifetime regime) — None in
    # v1/v2/v3-shim bundles and decode-only compiles (prefill_len 0)
    prefill_plan: "MemoryPlan | None" = None
    prefill_len: int = 0

    @property
    def total_size(self) -> int:
        """Unified footprint: activation arena + cross-step state. The
        prefill arena is NOT summed in — prefill and decode never run
        concurrently in one slot's lifetime, so the prefill arena aliases
        the decode arena's address space (the peak activation demand is
        ``max(plan, prefill_plan)``, see :attr:`peak_activation_size`)."""
        return self.plan.total_size + (
            self.state_plan.total_size if self.state_plan is not None else 0
        )

    @property
    def peak_activation_size(self) -> int:
        """Peak transient-arena demand across both phases: the decode-step
        arena and (when planned) the prefill arena, whichever is larger."""
        prefill = (
            self.prefill_plan.total_size
            if self.prefill_plan is not None else 0
        )
        return max(self.plan.total_size, prefill)

    def summary(self) -> str:
        searched = self.provenance.get("searched_total_bytes")
        greedy = self.provenance.get("greedy_total_bytes")
        extra = ""
        if searched is not None and greedy is not None:
            extra = (
                f" (greedy {greedy / 2**20:.3f} MiB -> "
                f"searched {searched / 2**20:.3f} MiB)"
            )
        state = ""
        if self.state_plan is not None:
            state = (
                f" + state {self.state_plan.total_size / 2**20:.3f} MiB "
                f"= {self.total_size / 2**20:.3f} MiB unified"
            )
        aot = ""
        if self.executables is not None:
            aot = (
                f" + {len(self.executables.entries)} AOT executable(s) "
                f"({self.executables.nbytes / 2**20:.3f} MiB, "
                f"{self.executables.key})"
            )
        prefill = ""
        if self.prefill_plan is not None:
            prefill = (
                f" + prefill[{self.prefill_len}] "
                f"{self.prefill_plan.total_size / 2**20:.3f} MiB "
                f"[{self.prefill_plan.strategy}]"
            )
        return (
            f"bundle {self.arch} slots={self.n_slots} len={self.max_len} "
            f"{self.dtype}: {self.plan.total_size / 2**20:.3f} MiB "
            f"[{self.plan.strategy}]{extra}{state}{prefill}{aot}"
        )


def unified_from_bundle(bundle: PlanBundle) -> UnifiedPlan:
    """A v2 bundle round-trips a full UnifiedPlan: activation offsets +
    cross-step state offsets under the bundle's fingerprint. v1-shim
    bundles yield ``state=None`` (the engine plans that half itself)."""
    return UnifiedPlan(
        activation=bundle.plan,
        state=bundle.state_plan,
        prefill=bundle.prefill_plan,
        fingerprint=bundle.fingerprint,
        order=bundle.order,
        fusion_groups=bundle.fusion_groups,
        provenance=dict(bundle.provenance),
    )


def bundle_to_obj(bundle: PlanBundle) -> dict:
    plan = dataclasses.replace(bundle.plan, plan_wall_s=0.0)
    return {
        "format_version": BUNDLE_FORMAT_VERSION,
        "fingerprint": bundle.fingerprint,
        "graph_fingerprint": bundle.graph_fingerprint,
        "arch": bundle.arch,
        "n_layers": bundle.n_layers,
        "d_model": bundle.d_model,
        "n_slots": bundle.n_slots,
        "max_len": bundle.max_len,
        "dtype": bundle.dtype,
        "plan": plan_io.plan_to_obj(plan),
        "state_plan": (
            state_plan_to_obj(bundle.state_plan)
            if bundle.state_plan is not None
            else None
        ),
        "order": bundle.order,
        "fusion_groups": bundle.fusion_groups,
        "provenance": bundle.provenance,
        "executables": (
            executables_to_obj(bundle.executables)
            if bundle.executables is not None
            else None
        ),
        "prefill_len": bundle.prefill_len,
        "prefill_plan": (
            plan_io.plan_to_obj(
                dataclasses.replace(bundle.prefill_plan, plan_wall_s=0.0)
            )
            if bundle.prefill_plan is not None
            else None
        ),
    }


def bundle_from_obj(obj: dict) -> PlanBundle:
    if not isinstance(obj, dict):
        raise ValueError(
            f"plan bundle must be a JSON object, got {type(obj).__name__}"
        )
    version = obj.get("format_version")
    if version == 1:
        # v1 shim: no state plan, no bucket shape fields. The bundle
        # loads, but its fingerprint hashed fingerprint-schema v1 — a
        # current engine's expectation never matches, so fallback
        # semantics are preserved (plan-at-construction, one-line
        # warning).
        warnings.warn(
            "loading plan-bundle format v1 (activation half only); "
            "recompile with launch/compile.py for a v4 bundle carrying "
            "the cross-step state plan",
            DeprecationWarning,
            stacklevel=2,
        )
    elif version == 2:
        # v2 shim: both plan halves, no executables and no prefill plan.
        # The fingerprint schema is unchanged across v2->v4, so the bundle
        # still matches its bucket and serves.
        warnings.warn(
            "loading plan-bundle format v2 (no AOT decode executables); "
            "recompile with launch/compile.py for a v4 bundle",
            DeprecationWarning,
            stacklevel=2,
        )
    elif version == 3:
        # v3 shim: decode plans (and the reference's executables) but no
        # prefill plan. The fingerprint schema is unchanged across v3->v4
        # (prefill_len is None-canonicalized out of decode-only
        # fingerprints), so the bundle still matches its bucket and
        # serves. A warning, never a refusal.
        warnings.warn(
            "loading plan-bundle format v3 (no planned prefill arena); "
            "recompile with launch/compile.py --prefill-len for a v4 "
            "bundle that carries the full-sequence prefill plan",
            DeprecationWarning,
            stacklevel=2,
        )
    elif version != BUNDLE_FORMAT_VERSION:
        raise ValueError(
            f"unsupported plan-bundle format version {version!r} "
            f"(this build reads versions 1-{BUNDLE_FORMAT_VERSION})"
        )
    state_obj = obj.get("state_plan")
    exec_obj = obj.get("executables")
    prefill_obj = obj.get("prefill_plan")
    return PlanBundle(
        fingerprint=obj["fingerprint"],
        graph_fingerprint=obj["graph_fingerprint"],
        arch=obj["arch"],
        n_slots=obj["n_slots"],
        max_len=obj["max_len"],
        dtype=obj["dtype"],
        plan=plan_io.plan_from_obj(obj["plan"]),
        order=obj["order"],
        fusion_groups=obj["fusion_groups"],
        provenance=obj["provenance"] or {},
        state_plan=state_plan_from_obj(state_obj) if state_obj else None,
        n_layers=obj.get("n_layers", 0),
        d_model=obj.get("d_model", 0),
        executables=executables_from_obj(exec_obj) if exec_obj else None,
        prefill_plan=plan_io.plan_from_obj(prefill_obj) if prefill_obj else None,
        prefill_len=obj.get("prefill_len", 0) or 0,
    )


def bundle_to_json(bundle: PlanBundle) -> str:
    """Canonical encoding: sorted keys, fixed separators — byte-stable."""
    return json.dumps(
        bundle_to_obj(bundle), sort_keys=True, separators=(",", ":")
    )


def bundle_from_json(text: str) -> PlanBundle:
    return bundle_from_obj(json.loads(text))


def save_bundle(bundle: PlanBundle, path: str | Path) -> None:
    Path(path).write_text(bundle_to_json(bundle))


def load_bundle(path: str | Path) -> PlanBundle:
    return bundle_from_json(Path(path).read_text())


# ---------------------------------------------------------------- manifest

MANIFEST_NAME = "manifest.json"


@contextlib.contextmanager
def _locked(lock_path: Path):
    """Advisory exclusive lock (flock) held for a manifest index update.
    Degrades to unlocked on platforms/filesystems without flock — the
    rename below is still atomic, only lost-update protection is lost."""
    try:
        import fcntl
    except ImportError:
        yield
        return
    try:
        fh = open(lock_path, "a+")
    except OSError:
        yield  # e.g. read-only manifest dir: degrade to unlocked
        return
    with fh:
        try:
            fcntl.flock(fh, fcntl.LOCK_EX)
        except OSError:
            yield
            return
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


class BundleManifest:
    """A directory of content-addressed bundle files + a bucket index.

    Layout::

        <dir>/manifest.json            # {"format_version", "buckets": {...}}
        <dir>/bundle-<sha16>.json      # canonical PlanBundle documents

    ``buckets`` maps :func:`bucket_key` strings to
    ``{"file", "fingerprint", "total_size", "created_unix", "command"}``.
    Timestamps and the compile command live here (mutable index), never in
    the bundle payload (immutable, content-addressed).
    """

    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        # memo for pre-`unified_total` index entries whose bundles could
        # not be read during the one-shot index upgrade below
        self._legacy_totals: dict[str, int] = {}
        # the upgrade runs at most once per handle even when it cannot
        # persist (read-only manifest dir)
        self._upgraded = False

    @property
    def manifest_path(self) -> Path:
        return self.dir / MANIFEST_NAME

    def _read_index(self, *, locked: bool = False) -> dict:
        """Parse the index; a corrupt one is quarantined and rebuilt from
        the bundle files (see :meth:`_quarantine_and_rebuild`). The
        rebuild rewrites ``manifest.json``, so it must hold the same lock
        ``publish()`` serializes through — callers already inside the
        lock pass ``locked=True`` (flock is per-open-file-description:
        re-acquiring on a fresh fd would self-deadlock)."""
        index, reason = self._try_parse_index()
        if reason is None:
            return index
        if locked:
            return self._quarantine_and_rebuild(reason)
        with _locked(self.dir / ".manifest.lock"):
            # re-read first: a concurrent publish/rebuild may have fixed
            # the index while we waited on the lock
            index, reason = self._try_parse_index()
            if reason is None:
                return index
            return self._quarantine_and_rebuild(reason)

    def _try_parse_index(self) -> tuple[dict | None, str | None]:
        """(index, None) on success, (None, reason) on a corrupt index —
        the bundle files are the durable record, so corruption must not
        crash publish()/lookup()."""
        try:
            obj = json.loads(self.manifest_path.read_text())
        except FileNotFoundError:
            return (
                {"format_version": MANIFEST_FORMAT_VERSION, "buckets": {}},
                None,
            )
        except json.JSONDecodeError:
            # truncated/garbage index (killed writer, disk hiccup)
            return None, "unparseable JSON"
        if not isinstance(obj, dict) or not isinstance(
            obj.get("buckets"), dict
        ):
            return None, "not a bucket index"
        if obj.get("format_version") != MANIFEST_FORMAT_VERSION:
            raise ValueError(
                f"unsupported manifest format version "
                f"{obj.get('format_version')!r} in {self.manifest_path}"
            )
        return obj, None

    def _quarantine_and_rebuild(self, reason: str) -> dict:
        """Rename the corrupt index aside and rebuild it from the
        ``bundle-*.json`` files on disk. v2 bundles carry their bucket
        shape fields, so their canonical keys are reconstructible;
        unreadable or pre-v2 files are skipped (their buckets are lost
        from the index but the files stay on disk)."""
        quarantine = self.manifest_path.with_name(
            f"{MANIFEST_NAME}.corrupt-{int(time.time())}"
        )
        try:
            self.manifest_path.replace(quarantine)
        except OSError:
            quarantine = None
        index = {"format_version": MANIFEST_FORMAT_VERSION, "buckets": {}}
        for path in sorted(self.dir.glob("bundle-*.json")):
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", DeprecationWarning)
                    bundle = load_bundle(path)
            except Exception:
                continue  # not a readable bundle; leave it alone
            key = bundle_bucket_key(bundle)
            if key is None:
                continue  # v1 shim: bucket shape fields unknown
            index["buckets"][key] = {
                "file": path.name,
                "fingerprint": bundle.fingerprint,
                "total_size": bundle.plan.total_size,
                "unified_total": bundle.total_size,
                "strategy": bundle.plan.strategy,
                "created_unix": path.stat().st_mtime,
                "command": None,
                "rebuilt_from": reason,
            }
        warnings.warn(
            f"manifest index {self.manifest_path} was corrupt ({reason}); "
            + (f"quarantined to {quarantine.name} and " if quarantine else "")
            + f"rebuilt {len(index['buckets'])} bucket(s) from bundle files",
            RuntimeWarning,
            stacklevel=3,
        )
        tmp = self.manifest_path.with_suffix(f".tmp{os.getpid()}")
        try:
            tmp.write_text(json.dumps(index, sort_keys=True, indent=1))
            tmp.replace(self.manifest_path)
        except OSError:
            pass  # read-only dir: serve the rebuilt index from memory
        return index

    def buckets(self) -> dict[str, dict]:
        return self._read_index()["buckets"]

    def publish(
        self, key: str, bundle: PlanBundle, *, command: str | None = None
    ) -> Path:
        """Write ``bundle`` content-addressed and point ``key`` at it.
        Recompiles of an unchanged graph rewrite the same file. The index
        read-modify-write is serialized through an advisory file lock so
        concurrent compiles into one manifest (fleet sweeps, parallel
        ``serve --compile-first``) cannot drop each other's buckets, then
        lands via an atomic same-directory rename."""
        self.dir.mkdir(parents=True, exist_ok=True)
        text = bundle_to_json(bundle)
        sha = hashlib.sha256(text.encode()).hexdigest()
        path = self.dir / f"bundle-{sha[:16]}.json"
        if not path.exists():
            path.write_text(text)
        with _locked(self.dir / ".manifest.lock"):
            index = self._read_index(locked=True)
            index["buckets"][key] = {
                "file": path.name,
                "fingerprint": bundle.fingerprint,
                "total_size": bundle.plan.total_size,
                "unified_total": bundle.total_size,
                "strategy": bundle.plan.strategy,
                "created_unix": time.time(),
                "command": command,
            }
            tmp = self.manifest_path.with_suffix(f".tmp{os.getpid()}")
            tmp.write_text(json.dumps(index, sort_keys=True, indent=1))
            tmp.replace(self.manifest_path)
        return path

    def lookup(self, key: str) -> PlanBundle | None:
        entry = self.buckets().get(key)
        if entry is None:
            return None
        return load_bundle(self.dir / entry["file"])

    # an unreadable bundle must LOSE the smallest-footprint ranking (0
    # would win it and hijack selection from every valid bucket)
    _UNRANKABLE = 1 << 62

    def _unified_total(self, key: str, entry: dict) -> int:
        """The bucket's unified footprint (activation + state) for the
        admission tie-break. Indexed since the v2 manifest revision;
        entries still missing it after :meth:`_upgrade_legacy_index`
        (unreadable bundles) rank last via the per-handle memo."""
        if isinstance(entry.get("unified_total"), int):
            return entry["unified_total"]
        fname = entry.get("file")
        if fname in self._legacy_totals:
            return self._legacy_totals[fname]
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                total = load_bundle(self.dir / fname).total_size
        except Exception:
            total = self._UNRANKABLE
        self._legacy_totals[fname] = total
        return total

    def _upgrade_legacy_index(self) -> dict:
        """One-shot upgrade of a pre-``unified_total`` index: load each
        legacy bundle ONCE, stamp its unified footprint into the entry,
        and persist the index — so bucket auto-selection stops re-reading
        every bundle file on every :meth:`lookup_nearest`. Best-effort on
        a read-only manifest dir: the computed totals are then served
        from the per-handle memo instead. Returns the (possibly upgraded)
        index."""
        with _locked(self.dir / ".manifest.lock"):
            index = self._read_index(locked=True)
            changed = False
            for entry in index["buckets"].values():
                if isinstance(entry.get("unified_total"), int):
                    continue
                fname = entry.get("file", "")
                try:
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore", DeprecationWarning)
                        total = load_bundle(self.dir / fname).total_size
                except Exception:
                    # unreadable: memoize the loss, keep the entry legacy
                    # so a later repair is picked up
                    self._legacy_totals[fname] = self._UNRANKABLE
                    continue
                entry["unified_total"] = total
                self._legacy_totals[fname] = total
                changed = True
            if changed:
                tmp = self.manifest_path.with_suffix(f".tmp{os.getpid()}")
                try:
                    tmp.write_text(
                        json.dumps(index, sort_keys=True, indent=1)
                    )
                    tmp.replace(self.manifest_path)
                except OSError:
                    pass  # read-only dir: totals live in the memo
        self._upgraded = True
        return index

    def lookup_nearest(
        self, cfg: "ArchConfig", *, n_slots: int, max_len: int,
        page_size: "int | None" = None,
    ) -> tuple[str, PlanBundle] | None:
        """Bucket auto-selection: the exact bucket if compiled, else the
        smallest-footprint admissible compiled bucket. Admissible means
        identical arch/layers/width/dtype/page_size with
        ``max_len >= requested`` (a longer cache serves any shorter
        request) AND ``n_slots >= requested`` (slots are the §4 shared
        objects — a bigger pool is admissible, just wasteful); paged and
        symmetric buckets are distinct families and never substitute for
        each other, while a prefill-carrying bucket (``|pf{S}``) IS
        admissible for a decode-only request — the extra prefill plan is
        inert metadata on the decode path. Ties break on the smallest
        unified footprint (activation + state), then the smallest
        (max_len, n_slots, prefill_len) for determinism. None when no
        admissible bucket exists."""
        exact = bucket_key(
            cfg, n_slots=n_slots, max_len=max_len, page_size=page_size
        )
        buckets = self.buckets()
        if exact in buckets:
            return exact, load_bundle(self.dir / buckets[exact]["file"])
        if not self._upgraded and any(
            not isinstance(e.get("unified_total"), int)
            for e in buckets.values()
        ):
            buckets = self._upgrade_legacy_index()["buckets"]
        want = parse_bucket_key(exact)
        wild = {"max_len": 0, "n_slots": 0, "prefill_len": 0}
        best: tuple[tuple[int, int, int, int], str] | None = None
        for key, entry in buckets.items():
            got = parse_bucket_key(key)
            if got is None:
                continue
            if {**got, **wild} != {**want, **wild}:
                continue
            if got["max_len"] < max_len or got["n_slots"] < n_slots:
                continue
            rank = (
                self._unified_total(key, entry),
                got["max_len"],
                got["n_slots"],
                got["prefill_len"] or 0,
            )
            if best is None or rank < best[0]:
                best = (rank, key)
        if best is None:
            return None
        return best[1], load_bundle(self.dir / buckets[best[1]]["file"])


def _describe_buckets(manifest: BundleManifest, limit: int = 12) -> str:
    """The compiled bucket keys, for miss messages — a common fleet
    misconfiguration (wrong --slots, unswept max_len) should read as
    'these buckets exist, yours does not', not as a perf mystery."""
    try:
        keys = sorted(manifest.buckets())
    except Exception:
        return "manifest index unreadable"
    if not keys:
        return "manifest is empty"
    shown = ", ".join(keys[:limit])
    more = f", ... ({len(keys) - limit} more)" if len(keys) > limit else ""
    return f"compiled buckets: {shown}{more}"


def resolve_bundle(
    source: "PlanBundle | str | Path",
    cfg: "ArchConfig",
    *,
    n_slots: int,
    max_len: int,
    nearest: bool = False,
    page_size: "int | None" = None,
) -> PlanBundle:
    """Accept what a serving caller naturally has: a loaded bundle, a path
    to one bundle file, or a manifest directory (looked up by bucket key;
    with ``nearest=True`` the lookup auto-selects the smallest-footprint
    admissible compiled bucket — ``max_len`` and ``n_slots`` both
    >= requested, same ``page_size`` family). Raises
    ``FileNotFoundError``/``ValueError`` on missing or unreadable sources
    — a manifest miss lists the bucket keys that DO exist; fingerprint
    verification is the caller's job (the engine checks and falls
    back)."""
    if isinstance(source, PlanBundle):
        return source
    path = Path(source)
    if path.is_dir():
        key = bucket_key(
            cfg, n_slots=n_slots, max_len=max_len, page_size=page_size
        )
        manifest = BundleManifest(path)
        if nearest:
            found = manifest.lookup_nearest(
                cfg, n_slots=n_slots, max_len=max_len, page_size=page_size
            )
            if found is not None:
                return found[1]
        else:
            bundle = manifest.lookup(key)
            if bundle is not None:
                return bundle
        raise FileNotFoundError(
            f"no {'admissible ' if nearest else ''}bundle for bucket "
            f"{key!r} in manifest {path}; {_describe_buckets(manifest)}"
        )
    return load_bundle(path)
