"""Every cell, configuration, traffic mix, limit and metric of
BENCHMARK.json is found by its name, and the manifest keeps to the
contract's shape."""

import json
import re

import pytest

from portbench import harness

M = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in M["workloads"]]
METRICS = [m["name"] for m in M["end_to_end"] + M["per_layer"]]


def test_manifest_keys_and_names():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["command"][:3] == ["python3", "-m", "portbench.run"]
    assert M["paths"] == ["portbench"]
    names = CELLS + METRICS + [c["name"] for c in M["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in M["workloads"]]:
        assert NAME.match(n), n
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(M)) < 64 * 1024


UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keep_the_contract_shape(section):
    for e in M[section]:
        assert set(e) - {"workloads"} == KEYS[section], e
        for k in ("why", "layer", "source"):
            if k in e:
                assert _line(e[k]), e
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for w in e.get("workloads", []):
            assert w in CELLS
    for word in M["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    w = harness.cell(M, cell)
    cfg = harness.config(M, w["config"])
    tr = harness.traffic(w["traffic"])
    lim = harness.limits(cell)
    drv = harness.driver(tr["driver"])
    assert cfg["name"] == w["config"]
    assert hasattr(drv, "make") and lim and all(v >= 0 for v in lim.values())
    assert w["chips"] == 1
    e2e = harness.metrics_of(M, cell, "end_to_end")
    layer = harness.metrics_of(M, cell, "per_layer")
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2 and layer
    reported = {m["name"] for m in e2e}
    for m in layer:
        assert m["moves"] in reported


@pytest.mark.parametrize("cell", CELLS)
def test_cell_has_a_small_cut_and_its_faults(cell):
    from portbench.tests.conftest import small

    w = harness.cell(M, cell)
    cut = small(M, cell)
    assert cut and set(cut) <= set(harness.config(M, w["config"]))
    tr = harness.traffic(w["traffic"])
    assert {"state_unchanged", "half_batch", "altered_answer"} <= set(
        harness.driver(tr["driver"]).faults(tr))


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_and_name_list(name):
    mod = harness.metric_reader(name)
    assert callable(mod.read)
    src = (harness.PKG / "metrics" / f"{name}.py").read_text()
    if f"{name}.names" in src:
        assert harness.metric_names(harness.PKG / "metrics" / f"{name}.names")


def test_per_layer_metric_of_one_layer_name():
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for group in layers.values():
        assert len(group) <= 2
