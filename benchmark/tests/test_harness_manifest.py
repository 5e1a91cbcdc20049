"""BENCHMARK.json against the benchmark's contract, and the discovery of
configurations, mixes, metrics and references by name."""

import json
import re
import sys

import pytest

from benchmark import harness, manifest
from benchmark.manifest import HERE, ROOT

MAN = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def test_top_level_keys_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 << 10
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
        assert not p.endswith("_torch")
    assert len(MAN["command"]) <= 32
    assert all(LINE.match(w) for w in MAN["command"])
    assert MAN["command"][1].startswith(MAN["paths"][0] + "/")


def test_run_seconds_fits_a_full_check():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in MAN["configs"]]
    names += [c["name"] for c in MAN["workloads"]]
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    names += [m["name"] for m in metrics]
    for n in names:
        assert NAME.match(n), n
    for c in MAN["workloads"]:
        assert NAME.match(c["config"]) and NAME.match(c["traffic"])
        assert LINE.match(c["why"])
    for c in MAN["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in MAN["per_layer"]:
        assert LINE.match(m["layer"])
    assert len(set(n for n in names)) == len(names)


def test_entries_have_just_the_contracts_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for c in MAN["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert c["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    four = sum(c["chips"] == 4 for c in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for c in MAN["workloads"]:
        own = [m["name"] for m in manifest.metrics_for(MAN, c["name"],
                                                       False)]
        assert "setup_s" in own and len(own) >= 2
        layer = manifest.metrics_for(MAN, c["name"], True)
        assert layer
        for m in layer:
            assert m["moves"] in own


def test_files_found_by_name():
    files = set()
    for c in MAN["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("benchmark/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = manifest.config(MAN, c["name"])
        assert cfg["name"] == c["name"]
        assert manifest.reference(cfg["reference"]).expected_profiles
    for c in MAN["workloads"]:
        assert c["config"] in {x["name"] for x in MAN["configs"]}
        assert manifest.traffic(c["traffic"])["name"] == c["traffic"]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)
        for w in m.get("workloads", []):
            manifest.cell(MAN, w)
    # Every reader is named by the manifest; a mix may wait for its cell
    # (longtail, with node-192's configuration, is kept for a later one).
    used = {m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]}
    assert {p.stem for p in (HERE / "metrics").glob("*.py")} == used
    assert ({p.stem for p in (HERE / "traffic").glob("*.json")}
            >= {c["traffic"] for c in MAN["workloads"]})


def test_discovery_misses_loudly():
    with pytest.raises(KeyError):
        manifest.cell(MAN, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        manifest.reader("no_such_metric")


@pytest.mark.parametrize("name,bad", [
    ("parca_agent_tpu_torch", False), ("parca_agent_tpu_torch.cli", False),
    ("parca_agent_tpu", True), ("parca_agent_tpu.aggregator", True),
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax", True),
    ("jaxtyping", False), ("parca_agent_tpux", False)])
def test_forbidden_modules_compare_top_level_names(monkeypatch, name, bad):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in harness.forbidden_modules()) is bad


def test_config_files_are_json_objects():
    for c in MAN["configs"]:
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert isinstance(cfg.get("assumed"), dict)
        assert cfg["aggregator"]["overflow"] == "sketch"
