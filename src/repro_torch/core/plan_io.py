"""Deterministic plan artifacts + content-addressed plan cache.

Two concerns, one module:

**Serialization** — a :class:`repro_torch.core.planner.MemoryPlan` round-trips
through a versioned, canonical JSON document (sorted keys, no whitespace
variance), so plans can be diffed, committed as golden files, and shipped
to a serving process that never runs the planner. ``PLAN_FORMAT_VERSION``
bumps on any schema change; loaders reject unknown versions rather than
guessing.

**Caching** — planning is pure: the result is fully determined by the
record set (sizes already alignment-rounded), the mode, and the strategy
name. :func:`plan_signature` hashes exactly those inputs (sha256 over the
canonical encoding, prefixed with the format version so cache entries
self-invalidate when serialization changes), and :class:`PlanCache` maps
signature -> plan, in memory and optionally on disk (one
``<signature>.json`` per plan under ``cache_dir``; set the
``REPRO_TORCH_PLAN_CACHE_DIR`` environment variable to give the default cache a
disk tier: the port's own name for the reference's ``REPRO_PLAN_CACHE_DIR``,
so that neither package ever serves a plan the other cached). ``plan_records``/``plan_graph`` consult the cache, which makes
repeat engine construction, auto-strategy sweeps, and outer search loops
(MAFAT-style fusing search, budget-driven tiling enumeration) near-free.

Key properties of the signature scheme:
* alignment is captured *through the record sizes* — ``plan_graph`` with a
  different alignment produces different sizes, hence a different key;
* ``strategy="auto"`` is keyed with its evaluated portfolio spelled out
  (``planner._cache_strategy_key`` produces ``"auto[a,b,...]"``), so
  adding a strategy to a portfolio invalidates cached auto plans while
  auto and a pinned strategy never share an entry;
* every key includes :data:`PLANNER_REVISION` — bump it when any strategy
  implementation may change its output, and persisted caches
  self-invalidate without a schema change;
* graph names are NOT part of the key — two graphs with identical records
  share one entry (the cached plan is re-labelled on the way out).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path
from typing import TYPE_CHECKING, Sequence

from repro_torch.core.records import TensorUsageRecord
from repro_torch.core.shared_objects import SharedObject, SharedObjectsAssignment

if TYPE_CHECKING:  # planner imports this module; avoid the import cycle
    from repro_torch.core.planner import MemoryPlan

PLAN_FORMAT_VERSION = 1

# Bump whenever ANY strategy implementation may produce different output
# for the same inputs (new tie-breaking, algorithm changes, bug fixes).
# It is part of every plan signature, so persisted disk caches
# (REPRO_TORCH_PLAN_CACHE_DIR) self-invalidate on planner upgrades instead of
# silently serving plans a current run would no longer produce.
PLANNER_REVISION = 1


# ----------------------------------------------------------- serialization


def _records_to_obj(records: Sequence[TensorUsageRecord]) -> list[list[int]]:
    return [[r.first_op, r.last_op, r.size, r.tensor_id] for r in records]


def _records_from_obj(obj: Sequence[Sequence[int]]) -> list[TensorUsageRecord]:
    return [
        TensorUsageRecord(first_op=f, last_op=l, size=s, tensor_id=t)
        for f, l, s, t in obj
    ]


def _shared_objects_to_obj(asn: SharedObjectsAssignment) -> dict:
    return {
        "strategy": asn.strategy,
        "objects": [
            {"object_id": o.object_id, "size": o.size, "intervals": o.intervals}
            for o in asn.objects
        ],
        "assignment": {str(tid): oid for tid, oid in asn.assignment.items()},
    }


def _shared_objects_from_obj(obj: dict) -> SharedObjectsAssignment:
    objects = []
    for o in obj["objects"]:
        so = SharedObject(object_id=o["object_id"], size=o["size"])
        for f, l, tid in o["intervals"]:
            so.interval_set.add(f, l, tid)
        objects.append(so)
    return SharedObjectsAssignment(
        strategy=obj["strategy"],
        objects=objects,
        assignment={int(t): oid for t, oid in obj["assignment"].items()},
    )


def plan_to_obj(plan: "MemoryPlan") -> dict:
    return {
        "format_version": PLAN_FORMAT_VERSION,
        "graph_name": plan.graph_name,
        "strategy": plan.strategy,
        "records": _records_to_obj(plan.records),
        "offsets": {str(t): off for t, off in plan.offsets.items()},
        "total_size": plan.total_size,
        "lower_bound": plan.lower_bound,
        "naive_size": plan.naive_size,
        "plan_wall_s": plan.plan_wall_s,
        "shared_objects": (
            _shared_objects_to_obj(plan.shared_objects)
            if plan.shared_objects is not None
            else None
        ),
    }


def plan_from_obj(obj: dict) -> "MemoryPlan":
    from repro_torch.core.planner import MemoryPlan

    version = obj.get("format_version")
    if version != PLAN_FORMAT_VERSION:
        raise ValueError(
            f"unsupported plan format version {version!r} "
            f"(this build reads version {PLAN_FORMAT_VERSION})"
        )
    so = obj.get("shared_objects")
    return MemoryPlan(
        graph_name=obj["graph_name"],
        strategy=obj["strategy"],
        records=_records_from_obj(obj["records"]),
        offsets={int(t): off for t, off in obj["offsets"].items()},
        total_size=obj["total_size"],
        lower_bound=obj["lower_bound"],
        naive_size=obj["naive_size"],
        plan_wall_s=obj["plan_wall_s"],
        shared_objects=_shared_objects_from_obj(so) if so is not None else None,
    )


def plan_to_json(plan: "MemoryPlan") -> str:
    """Canonical encoding: sorted keys, fixed separators — byte-stable."""
    return json.dumps(plan_to_obj(plan), sort_keys=True, separators=(",", ":"))


def plan_from_json(text: str) -> "MemoryPlan":
    return plan_from_obj(json.loads(text))


def save_plan(plan: "MemoryPlan", path: str | Path) -> None:
    Path(path).write_text(plan_to_json(plan))


def load_plan(path: str | Path) -> "MemoryPlan":
    return plan_from_json(Path(path).read_text())


# ------------------------------------------------------------- signatures


def canonical_records(
    records: Sequence[TensorUsageRecord],
) -> list[tuple[int, int, int, int]]:
    """Producer-order-independent canonical form, shared by every content
    key over a record set: the plan-cache signature, the unified-plan
    spec fingerprint, and the executor's precompiled-plan identity check.
    """
    return sorted((r.tensor_id, r.first_op, r.last_op, r.size) for r in records)


def plan_signature(
    records: Sequence[TensorUsageRecord], *, mode: str, strategy: str
) -> str:
    """Content hash of everything the planner's output depends on.

    Records are keyed in ``tensor_id`` order so producer iteration order
    does not fragment the cache. Sizes are post-alignment, so alignment
    changes re-key automatically.
    """
    canon = canonical_records(records)
    payload = json.dumps(
        {
            "format_version": PLAN_FORMAT_VERSION,
            "planner_revision": PLANNER_REVISION,
            "mode": mode,
            "strategy": strategy,
            "records": canon,
        },
        sort_keys=True,
        separators=(",", ":"),
    )
    return hashlib.sha256(payload.encode()).hexdigest()


# ------------------------------------------------------------------ cache


def _env_max_disk_bytes() -> int | None:
    """Size cap for the disk tier from ``REPRO_TORCH_PLAN_CACHE_MAX_BYTES``
    (re-read per put, like the cache dir itself); unset/invalid/<=0
    disables eviction."""
    raw = os.environ.get("REPRO_TORCH_PLAN_CACHE_MAX_BYTES")
    if not raw:
        return None
    try:
        val = int(raw)
    except ValueError:
        return None
    return val if val > 0 else None


class PlanCache:
    """signature -> MemoryPlan, memory-first with an optional disk tier.

    The disk tier stores one canonical-JSON file per plan, named by
    signature, so it is safe to share between processes (writes go through
    a same-directory temp file + atomic rename). Under outer-search sweeps
    it would grow without bound, so every put enforces a size cap
    (``max_disk_bytes`` or ``REPRO_TORCH_PLAN_CACHE_MAX_BYTES``) by evicting
    oldest-mtime entries first — best-effort like the writes themselves:
    entries deleted concurrently by another process are simply skipped.
    """

    def __init__(
        self,
        cache_dir: str | Path | None = None,
        max_disk_bytes: int | None = None,
    ):
        self._mem: dict[str, "MemoryPlan"] = {}
        self.cache_dir = Path(cache_dir) if cache_dir else None
        self.max_disk_bytes = max_disk_bytes
        # running upper bound on the disk tier's size, so a sweep of puts
        # under the cap stays O(1) per put: the directory is only rescanned
        # when the estimate crosses the cap (None = unknown, scan next put)
        self._disk_bytes_estimate: int | None = None
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._mem)

    @property
    def stats(self) -> dict[str, int]:
        return {"hits": self.hits, "misses": self.misses, "entries": len(self._mem)}

    def _disk_path(self, key: str) -> Path | None:
        return self.cache_dir / f"{key}.json" if self.cache_dir else None

    def get(self, key: str) -> "MemoryPlan | None":
        plan = self._mem.get(key)
        if plan is None:
            path = self._disk_path(key)
            if path is not None:
                # read directly instead of exists()+read: another process
                # may delete entries between the check and the read
                try:
                    plan = plan_from_json(path.read_text())
                except FileNotFoundError:
                    plan = None
                except (OSError, ValueError, KeyError, json.JSONDecodeError):
                    plan = None  # unreadable/stale/foreign: treat as miss
                else:
                    self._mem[key] = plan
        if plan is None:
            self.misses += 1
            return None
        self.hits += 1
        return _copy_plan(plan)

    def put(self, key: str, plan: "MemoryPlan") -> None:
        self._mem[key] = _copy_plan(plan)
        path = self._disk_path(key)
        if path is not None:
            # the disk tier is best-effort: a full/unwritable cache dir
            # must not fail the planning call that already succeeded
            try:
                path.parent.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".tmp{os.getpid()}")
                text = plan_to_json(plan)
                tmp.write_text(text)
                tmp.replace(path)
            except OSError:
                pass
            else:
                self._evict_disk(keep=path, written_bytes=len(text))

    def _evict_disk(self, keep: Path, written_bytes: int) -> None:
        """Shrink the disk tier to the size cap, oldest mtime first. The
        just-written entry is never evicted (even if it alone exceeds the
        cap). Best-effort: stat/unlink races with other processes are
        ignored, never surfaced to the planning call.

        The directory is only rescanned when the running estimate crosses
        the cap — a sustained sweep writing under the cap costs O(1) per
        put, not a full glob+stat of every entry. The estimate cannot see
        other processes' writes; that is acceptable for a best-effort cap
        (each writer still bounds its own contribution, and every scan
        re-syncs to the directory's true size)."""
        limit = (
            self.max_disk_bytes
            if self.max_disk_bytes is not None
            else _env_max_disk_bytes()
        )
        if limit is None or self.cache_dir is None:
            return
        if self._disk_bytes_estimate is not None:
            self._disk_bytes_estimate += written_bytes
            if self._disk_bytes_estimate <= limit:
                return
        entries = []  # (mtime, size, path)
        try:
            for p in self.cache_dir.glob("*.json"):
                try:
                    st = p.stat()
                except OSError:
                    continue  # deleted by another process mid-scan
                entries.append((st.st_mtime, st.st_size, p))
        except OSError:
            return
        total = sum(size for _, size, _ in entries)
        if total > limit:
            for _, size, p in sorted(entries):
                if p == keep:
                    continue
                try:
                    p.unlink(missing_ok=True)
                except OSError:
                    continue
                total -= size
                if total <= limit:
                    break
        self._disk_bytes_estimate = total

    def clear(self) -> None:
        self._mem.clear()
        self.hits = 0
        self.misses = 0


def _copy_plan(plan: "MemoryPlan") -> "MemoryPlan":
    """Isolating copy: callers may re-label or mutate what they get back,
    the cached original must stay pristine. Records are frozen ->
    shareable; offsets are copied; the shared-objects graph is mutable
    (``assign`` grows objects in place), so it is rebuilt through its own
    serializer rather than shared."""
    so = plan.shared_objects
    if so is not None:
        so = _shared_objects_from_obj(_shared_objects_to_obj(so))
    return dataclasses.replace(
        plan,
        records=list(plan.records),
        offsets=dict(plan.offsets),
        shared_objects=so,
    )


_default_cache: PlanCache | None = None
_default_cache_dir: str | None = None


def default_cache() -> PlanCache:
    """The process-wide cache. ``REPRO_TORCH_PLAN_CACHE_DIR`` is re-read on every
    call (not frozen at import time), so setting it after importing
    ``repro_torch.core`` still enables the disk tier; changing it swaps in a
    fresh cache for the new directory."""
    global _default_cache, _default_cache_dir
    env = os.environ.get("REPRO_TORCH_PLAN_CACHE_DIR") or None
    if _default_cache is None or env != _default_cache_dir:
        _default_cache = PlanCache(env)
        _default_cache_dir = env
    return _default_cache
