"""Every cell, configuration and metric of BENCHMARK.json resolves to its
files by name, and the manifest keeps to the contract's shape."""

import json
import re

import pytest

from port_bench.core import manifest

MANIFEST = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = manifest.resolve_cell(cell)
    assert c.config["backbone"] and c.traffic["driver"]
    assert manifest.driver(c.traffic["driver"]).run
    assert c.limits and all(isinstance(v, (int, float)) for v in c.limits.values())
    names = {m.name for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer and all(m.moves in names for m in c.per_layer)
    for key, _ in c.traffic["end_to_end"].items():
        assert key in names


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_reader_loads(metric):
    assert callable(manifest.reader(metric))
    assert manifest.reader(metric)({"mode": None, "trace": None}) is None


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert entry["file"].startswith("port_bench/configs/")
    cfg = json.loads((manifest.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert any(w["config"] == entry["name"] for w in MANIFEST["workloads"])


def test_contract_shape():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["paths"] == ["port_bench"] and 1 <= m["run_seconds"] <= 51
    all_names = ([c["name"] for c in m["configs"]] + CELLS
                 + [e["name"] for e in m["end_to_end"] + m["per_layer"]])
    assert all(NAME.match(n) for n in all_names) and len(set(all_names)) == len(all_names)
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    for e in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert set(e.get("workloads", CELLS)) <= set(CELLS)
    for e in m["per_layer"]:
        assert e["moves"] in e2e
        for cell in e["workloads"]:  # every listed cell reports the metric it moves
            assert cell in e2e[e["moves"]].get("workloads", CELLS)
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs) and all(w["chips"] == 1 for w in m["workloads"])
    assert len(json.dumps(m)) < 64 * 1024
