"""The port's plan bundles (``repro_torch.core.artifact``) against the
reference's ``repro.core.artifact``.

* bucket keys, their parse and the serve-loop payload equal to the
  reference's on every arch the port builds (full and reduced configs);
* the port's ``decode_fingerprint`` payload without its ``runtime`` and
  ``cores`` keys hashes to exactly the reference's fingerprint of the same
  config and bucket, and the port's fingerprint never equals it;
* ``graph_fingerprint`` equal on one hand-built graph;
* the reference's ``tests/test_artifact.py`` scenarios on the port's
  codec and manifest: round trips, byte determinism, version shims,
  fingerprint sensitivity, publish/lookup/dedup, corruption quarantine,
  ``lookup_nearest`` (max_len, slots, tie-break, legacy upgrade),
  ``resolve_bundle`` misses, concurrent publishes;
* a bundle the reference wrote, with its AOT pack, loads in the port and
  re-encodes byte for byte (the pack carried opaque).
"""

import dataclasses
import hashlib
import json
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import get_reduced as jax_get_reduced  # noqa: E402
from repro.core import artifact as jax_artifact  # noqa: E402
from repro.core.graph import GraphBuilder as JaxGraphBuilder  # noqa: E402
from repro_torch.configs.base import PORTED_ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.core import artifact  # noqa: E402
from repro_torch.core.artifact import (BUNDLE_FORMAT_VERSION, BundleManifest,  # noqa: E402
                                       ExecutablePack, PlanBundle, bucket_key,
                                       bundle_bucket_key, bundle_from_json,
                                       bundle_from_obj, bundle_to_json, bundle_to_obj,
                                       decode_fingerprint, executable_entry,
                                       expected_executable_entries, graph_fingerprint,
                                       load_bundle, parse_bucket_key, resolve_bundle,
                                       save_bundle, serve_fingerprint,
                                       unified_from_bundle)
from repro_torch.core.graph import GraphBuilder  # noqa: E402
from repro_torch.core.planner import plan_records  # noqa: E402
from repro_torch.core.unified import StateRecord, plan_state  # noqa: E402

ARCH = "qwen3-0.6b"
REDUCED_ONLY = ("nemotron-4-340b", "llama4-maverick-400b-a17b")
# (arch, full): every config the port builds
CONFIGS = [(a, True) for a in PORTED_ARCH_IDS] + [
    (a, False) for a in (*PORTED_ARCH_IDS, *REDUCED_ONLY)]
BUCKETS = [dict(n_slots=2, max_len=64), dict(n_slots=8, max_len=2048),
           dict(n_slots=8, max_len=2048, page_size=65536),
           dict(n_slots=4, max_len=128, prefill_len=48),
           dict(n_slots=4, max_len=128, page_size=1024, prefill_len=48)]
SERVE = [dict(), dict(block_size=8), dict(greedy=False, temperature=0.8, top_k=20),
         dict(page_size=65536, page_pool=896), dict(page_size=1024),
         dict(block_size=4, greedy=False, page_size=4096, page_pool=3)]


def _cfgs(arch, full):
    if full:
        return get_config(arch), jax_get_config(arch)
    return get_reduced(arch), jax_get_reduced(arch)


# ---------------------------------------------------- against the reference


@pytest.mark.parametrize("arch,full", CONFIGS)
def test_bucket_keys_are_the_references(arch, full):
    cfg, jcfg = _cfgs(arch, full)
    for bucket in BUCKETS:
        key = bucket_key(cfg, **bucket)
        assert key == jax_artifact.bucket_key(jcfg, **bucket)
        assert parse_bucket_key(key) == jax_artifact.parse_bucket_key(key)


@pytest.mark.parametrize("knobs", SERVE)
def test_serve_fingerprint_is_the_references(knobs):
    assert serve_fingerprint(**knobs) == jax_artifact.serve_fingerprint(**knobs)


@pytest.mark.parametrize("arch,full", CONFIGS)
def test_decode_fingerprint_is_the_references_in_its_own_domain(arch, full):
    cfg, jcfg = _cfgs(arch, full)
    for bucket in BUCKETS:
        page_size = bucket.get("page_size")
        for knobs in (dict(), dict(block_size=8, page_size=page_size)):
            kw = dict(n_slots=bucket["n_slots"], max_len=bucket["max_len"],
                      serve_params=serve_fingerprint(**knobs) if knobs else None,
                      prefill_len=bucket.get("prefill_len"))
            want = jax_artifact.decode_fingerprint(jcfg, **kw)
            for cores in ("kernel", "plain"):
                payload = artifact.decode_fingerprint_payload(cfg, cores=cores, **kw)
                assert payload.pop("runtime") == "repro_torch"
                assert payload.pop("cores", "kernel") == cores
                assert artifact._sha(payload) == want
                assert decode_fingerprint(cfg, cores=cores, **kw) != want
            assert decode_fingerprint(cfg, **kw) != decode_fingerprint(
                cfg, cores="plain", **kw)


def _tiny(builder_cls, scale: int = 1):
    b = builder_cls("tiny")
    x = b.input((4 * scale, 4), "x")
    h = b.op("matmul", [x], (4 * scale, 8))
    g = b.op("gelu", [h], (4 * scale, 8))
    out = b.op("proj", [g, h], (4 * scale, 2))
    b.mark_output(out)
    return b.build()


@pytest.mark.parametrize("scale", [1, 2])
def test_graph_fingerprint_is_the_references(scale):
    assert graph_fingerprint(_tiny(GraphBuilder, scale)) == \
        jax_artifact.graph_fingerprint(_tiny(JaxGraphBuilder, scale))


# ------------------------------------------- the reference's scenarios


def _state_plan(n_slots=2, max_len=64):
    return plan_state(
        [StateRecord(path="['kv']", shape=(n_slots, 8), dtype="float32",
                     nbytes=n_slots * 8 * 4),
         StateRecord(path="['ssm']", shape=(n_slots, 4), dtype="float32",
                     nbytes=n_slots * 4 * 4)],
        n_slots=n_slots, max_len=max_len,
    )


def _bundle(cfg=None, n_slots=2, max_len=64, **overrides) -> PlanBundle:
    cfg = cfg or get_reduced(ARCH)
    g = _tiny(GraphBuilder)
    plan = plan_records(g.usage_records(), graph_name=g.name, use_cache=False)
    fields = dict(
        fingerprint=decode_fingerprint(cfg, n_slots=n_slots, max_len=max_len),
        graph_fingerprint=graph_fingerprint(g),
        arch=cfg.name, n_slots=n_slots, max_len=max_len, dtype=cfg.dtype,
        plan=plan, state_plan=_state_plan(n_slots=n_slots, max_len=max_len),
        n_layers=cfg.n_layers, d_model=cfg.d_model,
        order=[0, 2, 1], fusion_groups=[[0], [1, 2]],
        provenance={"tool": "test", "greedy_total_bytes": plan.total_size},
    )
    fields.update(overrides)
    return PlanBundle(**fields)


def _pack() -> ExecutablePack:
    return ExecutablePack(
        platform="cpu", jax_version="0.0.test",
        entries={n: executable_entry(f"payload-{n}".encode())
                 for n in expected_executable_entries()},
    )


def test_bundle_json_round_trip_is_byte_deterministic():
    b = _bundle()
    text = bundle_to_json(b)
    b2 = bundle_from_json(text)
    assert bundle_to_obj(b2) == bundle_to_obj(b)
    assert bundle_to_json(b2) == text
    assert b2.order == [0, 2, 1] and b2.fusion_groups == [[0], [1, 2]]
    assert b2.plan.offsets == b.plan.offsets
    slow = dataclasses.replace(b, plan=dataclasses.replace(b.plan, plan_wall_s=1.23))
    assert bundle_to_json(slow) == text
    up = unified_from_bundle(b2)
    assert up.fingerprint == b.fingerprint and up.state == b.state_plan
    assert up.total_size == b.total_size == b.plan.total_size + b.state_plan.total_size
    assert "unified" in b.summary()
    assert b2.executables is None  # the port writes none


def test_bundle_rejects_unknown_version():
    obj = bundle_to_obj(_bundle())
    obj["format_version"] = BUNDLE_FORMAT_VERSION + 1
    with pytest.raises(ValueError, match="format version"):
        bundle_from_obj(obj)


def test_an_executable_pack_round_trips_opaque():
    b = _bundle(executables=_pack())
    text = bundle_to_json(b)
    b2 = bundle_from_json(text)
    assert bundle_to_json(b2) == text
    entry = b2.executables.entries["resident_decode"]
    assert entry.payload == b"payload-resident_decode"
    assert entry.sha256 == hashlib.sha256(entry.payload).hexdigest()
    assert "AOT executable" in b.summary()


@pytest.mark.parametrize("version,dropped", [
    (1, ("state_plan", "n_layers", "d_model", "executables")),
    (2, ("executables",)),
    (3, ("prefill_plan", "prefill_len")),
])
def test_older_versions_load_through_their_shims(version, dropped):
    obj = bundle_to_obj(_bundle())
    obj["format_version"] = version
    for key in dropped:
        obj.pop(key, None)
    with pytest.deprecated_call(match=f"format v{version}"):
        b = bundle_from_obj(json.loads(json.dumps(obj)))
    assert (b.state_plan is None) == (version == 1)
    assert (bundle_bucket_key(b) is None) == (version == 1)
    assert b.prefill_plan is None


def test_bucket_key_parses_and_rebuilds():
    cfg = get_reduced(ARCH)
    key = bucket_key(cfg, n_slots=2, max_len=64)
    assert parse_bucket_key(key) == {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_slots": 2, "max_len": 64, "dtype": cfg.dtype,
        "page_size": None, "prefill_len": None,
    }
    assert parse_bucket_key("free-form-key") is None
    assert bundle_bucket_key(_bundle(cfg)) == key
    assert bundle_bucket_key(dataclasses.replace(_bundle(cfg), prefill_len=48)) == \
        key + "|pf48"


@pytest.mark.parametrize("change", ["n_slots", "max_len", "d_model", "arch",
                                    "serve", "prefill", "cores"])
def test_decode_fingerprint_covers_graph_shaping_inputs(change):
    cfg = get_reduced(ARCH)
    kw = dict(n_slots=2, max_len=64)
    fp = decode_fingerprint(cfg, **kw)
    assert fp == decode_fingerprint(cfg, **kw)
    assert fp == decode_fingerprint(dataclasses.replace(cfg, source="elsewhere"), **kw)
    other = {
        "n_slots": lambda: decode_fingerprint(cfg, n_slots=4, max_len=64),
        "max_len": lambda: decode_fingerprint(cfg, n_slots=2, max_len=128),
        "d_model": lambda: decode_fingerprint(
            dataclasses.replace(cfg, d_model=cfg.d_model * 2), **kw),
        "arch": lambda: decode_fingerprint(get_reduced("mamba2-2.7b"), **kw),
        "serve": lambda: decode_fingerprint(
            cfg, serve_params=serve_fingerprint(block_size=8), **kw),
        "prefill": lambda: decode_fingerprint(cfg, prefill_len=32, **kw),
        "cores": lambda: decode_fingerprint(cfg, cores="plain", **kw),
    }[change]()
    assert other != fp


def test_manifest_publish_lookup_and_dedup(tmp_path):
    cfg = get_reduced(ARCH)
    man = BundleManifest(tmp_path)
    key = bucket_key(cfg, n_slots=2, max_len=64)
    b = _bundle(cfg)
    path = man.publish(key, b, command="pytest")
    assert path.exists()
    assert bundle_to_obj(man.lookup(key)) == bundle_to_obj(b)
    assert man.lookup("no-such-bucket") is None
    alias = key + "|alias"
    assert man.publish(alias, b, command="pytest") == path
    assert len(list(tmp_path.glob("bundle-*.json"))) == 1
    entries = man.buckets()
    assert entries[key]["file"] == entries[alias]["file"]
    assert entries[key]["command"] == "pytest"
    assert entries[key]["unified_total"] == b.total_size


@pytest.mark.parametrize("garbage", ['{"format_version": 1, "buck', "[]",
                                     '"not an index"'])
def test_manifest_corruption_is_quarantined_and_rebuilt(tmp_path, garbage):
    cfg = get_reduced(ARCH)
    man = BundleManifest(tmp_path)
    k64, k128 = (bucket_key(cfg, n_slots=2, max_len=n) for n in (64, 128))
    b64, b128 = (_bundle(cfg, n_slots=2, max_len=n) for n in (64, 128))
    man.publish(k64, b64)
    man.publish(k128, b128)
    (tmp_path / "manifest.json").write_text(garbage)
    with pytest.warns(RuntimeWarning, match="rebuilt 2 bucket"):
        buckets = man.buckets()
    assert set(buckets) == {k64, k128}
    assert buckets[k64]["fingerprint"] == b64.fingerprint
    assert list(tmp_path.glob("manifest.json.corrupt-*"))
    k32 = bucket_key(cfg, n_slots=2, max_len=32)
    man.publish(k32, _bundle(cfg, n_slots=2, max_len=32))
    assert set(man.buckets()) == {k32, k64, k128}
    assert bundle_to_obj(man.lookup(k128)) == bundle_to_obj(b128)


def test_manifest_rejects_newer_index_version(tmp_path):
    (tmp_path / "manifest.json").write_text(
        json.dumps({"format_version": 99, "buckets": {}}))
    with pytest.raises(ValueError, match="format version"):
        BundleManifest(tmp_path).buckets()


def _publish(man, cfg, buckets):
    for n_slots, max_len in buckets:
        man.publish(bucket_key(cfg, n_slots=n_slots, max_len=max_len),
                    _bundle(cfg, n_slots=n_slots, max_len=max_len))


# (compiled (slots, len) buckets, requested (slots, len), the bucket
# served or None): exact hits win, else the smallest admissible unified
# footprint; smaller pools, shorter caches and other dtypes never serve
NEAREST = [
    ([(2, 64), (2, 128), (2, 256)], (2, 128), (2, 128)),
    ([(2, 64), (2, 128), (2, 256)], (2, 96), (2, 128)),
    ([(2, 64), (2, 128), (2, 256)], (2, 32), (2, 64)),
    ([(2, 64), (2, 128), (2, 256)], (2, 512), None),
    ([(2, 64), (2, 128), (2, 256)], (4, 64), None),
    ([(4, 64), (8, 64)], (2, 64), (4, 64)),
    ([(4, 64), (8, 64), (2, 64)], (2, 64), (2, 64)),
    ([(4, 64), (8, 64)], (3, 63), (4, 64)),
    ([(2, 128), (8, 64)], (2, 64), (2, 128)),  # the leaner longer bucket
]


@pytest.mark.parametrize("compiled,want,served", NEAREST)
def test_lookup_nearest(tmp_path, compiled, want, served):
    cfg = get_reduced(ARCH)
    man = BundleManifest(tmp_path)
    _publish(man, cfg, compiled)
    got = man.lookup_nearest(cfg, n_slots=want[0], max_len=want[1])
    if served is None:
        assert got is None
        return
    key, b = got
    assert (b.n_slots, b.max_len) == served
    assert key == bucket_key(cfg, n_slots=served[0], max_len=served[1])
    other = dataclasses.replace(cfg, dtype="bfloat16")
    assert man.lookup_nearest(other, n_slots=want[0], max_len=want[1]) is None


def test_lookup_nearest_ranks_an_unreadable_bundle_last(tmp_path):
    cfg = get_reduced(ARCH)
    man = BundleManifest(tmp_path)
    _publish(man, cfg, [(2, 128), (8, 64)])
    index = json.loads((tmp_path / "manifest.json").read_text())
    index["buckets"][bucket_key(cfg, n_slots=4, max_len=64)] = {
        "file": "bundle-missing.json", "fingerprint": "x"}
    (tmp_path / "manifest.json").write_text(json.dumps(index))
    key, b = man.lookup_nearest(cfg, n_slots=2, max_len=64)
    assert (b.n_slots, b.max_len) == (2, 128), key


def test_lookup_nearest_upgrades_a_legacy_index_once(tmp_path, monkeypatch):
    cfg = get_reduced(ARCH)
    _publish(BundleManifest(tmp_path), cfg, [(2, 64), (2, 128)])
    index = json.loads((tmp_path / "manifest.json").read_text())
    for entry in index["buckets"].values():
        del entry["unified_total"]
    (tmp_path / "manifest.json").write_text(json.dumps(index))
    _, b = BundleManifest(tmp_path).lookup_nearest(cfg, n_slots=2, max_len=96)
    assert b.max_len == 128
    ondisk = json.loads((tmp_path / "manifest.json").read_text())
    assert all(isinstance(e["unified_total"], int) for e in ondisk["buckets"].values())
    loads = []
    real = artifact.load_bundle
    monkeypatch.setattr(artifact, "load_bundle", lambda p: (loads.append(p), real(p))[1])
    _, b = BundleManifest(tmp_path).lookup_nearest(cfg, n_slots=2, max_len=96)
    assert b.max_len == 128 and len(loads) == 1


def test_resolve_bundle_miss_lists_compiled_buckets(tmp_path):
    cfg = get_reduced(ARCH)
    k64 = bucket_key(cfg, n_slots=2, max_len=64)
    BundleManifest(tmp_path).publish(k64, _bundle(cfg))
    for nearest, slots, max_len in ((False, 8, 64), (True, 2, 512)):
        with pytest.raises(FileNotFoundError) as exc:
            resolve_bundle(tmp_path, cfg, n_slots=slots, max_len=max_len,
                           nearest=nearest)
        assert k64 in str(exc.value) and "compiled buckets" in str(exc.value)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="manifest is empty"):
        resolve_bundle(empty, cfg, n_slots=2, max_len=64)


def test_resolve_bundle_accepts_bundle_file_and_dir(tmp_path):
    cfg = get_reduced(ARCH)
    b = _bundle(cfg)
    assert resolve_bundle(b, cfg, n_slots=2, max_len=64) is b
    f = tmp_path / "one.json"
    save_bundle(b, f)
    assert bundle_to_obj(load_bundle(f)) == bundle_to_obj(b)
    assert bundle_to_obj(resolve_bundle(f, cfg, n_slots=2, max_len=64)) == \
        bundle_to_obj(b)
    man_dir = tmp_path / "bundles"
    BundleManifest(man_dir).publish(bucket_key(cfg, n_slots=2, max_len=64), b)
    assert bundle_to_obj(resolve_bundle(man_dir, cfg, n_slots=2, max_len=64)) == \
        bundle_to_obj(b)
    with pytest.raises(FileNotFoundError, match="no bundle"):
        resolve_bundle(man_dir, cfg, n_slots=8, max_len=64)


def test_concurrent_publish_keeps_every_bucket(tmp_path):
    """Publishers racing on one manifest (each with its own handle and its
    own descriptor on the lock file) lose no bucket."""
    cfg = get_reduced(ARCH)
    max_lens = [32, 48, 64, 96, 128, 192, 256, 384]

    def publish(max_len):
        BundleManifest(tmp_path).publish(
            bucket_key(cfg, n_slots=2, max_len=max_len),
            _bundle(cfg, n_slots=2, max_len=max_len), command="worker")
        return max_len

    with ThreadPoolExecutor(max_workers=4) as pool:
        assert sorted(pool.map(publish, max_lens)) == max_lens
    buckets = BundleManifest(tmp_path).buckets()
    for m in max_lens:
        entry = buckets[bucket_key(cfg, n_slots=2, max_len=m)]
        assert (tmp_path / entry["file"]).exists() and entry["command"] == "worker"


def test_a_reference_bundle_with_its_pack_reencodes_byte_for_byte(tmp_path):
    """A document the reference wrote (its AOT pack included) loads in the
    port and encodes to the same canonical bytes: the pack is carried
    opaque, and the manifest of either package reads the other's file."""
    from repro.core.graph import GraphBuilder as JGB
    from repro.core.planner import plan_records as jax_plan_records
    from repro.core.unified import StateRecord as JStateRecord
    from repro.core.unified import plan_state as jax_plan_state

    jcfg = jax_get_reduced(ARCH)
    g = _tiny(JGB)
    plan = jax_plan_records(g.usage_records(), graph_name=g.name, use_cache=False)
    sp = jax_plan_state([JStateRecord("['kv']", (2, 8), "float32", 64)],
                        n_slots=2, max_len=64)
    jb = jax_artifact.PlanBundle(
        fingerprint=jax_artifact.decode_fingerprint(jcfg, n_slots=2, max_len=64),
        graph_fingerprint=jax_artifact.graph_fingerprint(g), arch=jcfg.name,
        n_slots=2, max_len=64, dtype=jcfg.dtype, plan=plan, state_plan=sp,
        n_layers=jcfg.n_layers, d_model=jcfg.d_model,
        executables=jax_artifact.ExecutablePack(
            platform="cpu", jax_version="0.0.test",
            entries={n: jax_artifact.executable_entry(b"x" * 7)
                     for n in jax_artifact.expected_executable_entries()}))
    key = jax_artifact.bucket_key(jcfg, n_slots=2, max_len=64)
    path = jax_artifact.BundleManifest(tmp_path).publish(key, jb)
    got = BundleManifest(tmp_path).lookup(key)
    assert bundle_to_json(got) == jax_artifact.bundle_to_json(jb) == path.read_text()
    assert sorted(got.executables.entries) == jax_artifact.expected_executable_entries()
    # its fingerprint is the reference's, which the port never computes
    cfg = get_reduced(ARCH)
    assert got.fingerprint != decode_fingerprint(cfg, n_slots=2, max_len=64)
