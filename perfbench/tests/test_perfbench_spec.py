"""``BENCHMARK.json`` and the name-based lookup agree, and the file keeps
to the benchmark's contract."""

import json
import re

import pytest

from perfbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files_by_name(w):
    cell = spec.cell(w["name"])
    assert cell.config["repro_arch"]["name"]
    assert cell.traffic["loop"] in ("open", "closed")
    assert 0 < cell.limits["max_logit_gap"]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert 1 <= len(w["why"]) <= 200
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    # each per-layer metric of the cell moves an end-to-end metric it reports
    for m in cell.per_layer:
        assert m["moves"] in names


def test_names_are_unique_and_well_formed():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"] == f"perfbench/configs/{c['name']}.json"
    assert c["source"].startswith("https://")
    cfg = spec.load_json(spec.config_file(c["name"]))
    assert cfg["source"] == c["source"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_zamba2_keeps_every_number_of_its_published_config():
    """The published config.json (Zyphra/Zamba2-7B-Instruct), as the
    model-configs catalog reads it; nothing is reduced."""
    cfg = spec.load_json(spec.config_file("zamba2-7b"))
    published = {"hidden_size": 3584, "num_hidden_layers": 81,
                 "num_attention_heads": 32, "num_key_value_heads": 32,
                 "attention_head_dim": 224, "attention_hidden_size": 7168,
                 "ffn_hidden_size": 14336, "intermediate_size": 14336,
                 "mamba_d_state": 64, "mamba_headdim": 64, "mamba_ngroups": 2,
                 "mamba_expand": 2, "mamba_d_conv": 4, "n_mamba_heads": 112,
                 "vocab_size": 32000, "rms_norm_eps": 1e-5, "rope_theta": 10000,
                 "num_mem_blocks": 2}
    for k, v in published.items():
        assert cfg[k] == v, k
    a = cfg["repro_arch"]
    layers = a["period"] * a["n_periods"] + a["remainder"]
    assert len(layers) == cfg["num_hidden_layers"]
    assert sum(1 for s in layers if s.get("shared_attn")) == len(cfg["hybrid_layer_ids"])
    assert (a["d_model"], a["ssm_state"], a["ssm_groups"], a["d_ff"], a["vocab"],
            a["rms_eps"]) == (3584, 64, 2, 14336, 32000, 1e-5)
    assert 2 * a["d_model"] // a["shared_attn_heads"] == cfg["attention_head_dim"]


def test_granite_keeps_its_published_widths():
    cfg = spec.load_json(spec.config_file("granite-moe-3b"))
    a = cfg["repro_arch"]
    assert (a["d_model"], a["n_heads"], a["n_kv_heads"], a["head_dim"], a["d_ff"],
            a["n_experts"], a["top_k"], a["vocab"], a["n_periods"]) == \
        (cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"],
         cfg["hidden_size"] // cfg["num_attention_heads"], cfg["intermediate_size"],
         cfg["num_local_experts"], cfg["num_experts_per_tok"], cfg["vocab_size"],
         cfg["num_hidden_layers"])


def test_metrics():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in E2E_SOURCES and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"][0]["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["source"] in SOURCES and UNIT.match(m["unit"])
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert spec.metric_file(m["name"]).exists()
        assert callable(spec.metric_reader(m["name"]))
        layers.add(m["layer"])
    # the whole step's share of the peak stands beside the kernel's roofline
    assert any("mfu" in m["name"].split("_") for m in BENCH["per_layer"])


def test_every_data_file_is_used():
    used = {w["traffic"] for w in BENCH["workloads"]}
    assert {p.stem for p in (spec.HERE / "traffic").glob("*.json")} == used
    assert {p.stem for p in (spec.HERE / "limits").glob("*.json")} == \
        {w["name"] for w in BENCH["workloads"]}
    assert {p.stem for p in (spec.HERE / "metrics").glob("*.py")} == \
        {m["name"] for m in BENCH["per_layer"]}


def test_the_run_budget_fits_24_cells():
    t = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (t + 60) + 24 * 2 * 90 + 1200 <= 43200
