"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
from __future__ import annotations

import importlib
import re

import pytest

from perfbench.lib import harness
from perfbench.tests import smallrun

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
B = smallrun.bench()
CELLS = [w["name"] for w in B["workloads"]]


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def reported_e2e(cell: str):
    return [m["name"] for m in B["end_to_end"]
            if harness.applies(m, cell, [])]


def test_top_level_keys_and_size():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    raw = (smallrun.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51


def test_command_and_paths():
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (smallrun.ROOT / p).is_dir()
    assert 1 <= len(B["command"]) <= 32
    for word in B["command"]:
        assert one_line(word) and not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in B["paths"])


def test_names_units_and_keys():
    seen = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"])
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in B[group]]
        assert len(names) == len(set(names)), group


def test_every_cell_reports_enough():
    four = [w for w in B["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(B["workloads"]) // 4)
    for cell in CELLS:
        e2e = reported_e2e(cell)
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(harness.applies(m, cell, e2e) for m in B["per_layer"])
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}


def test_per_layer_moves_is_reported_where_read():
    e2e = {m["name"] for m in B["end_to_end"]}
    for m in B["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", CELLS):
            assert m["moves"] in reported_e2e(cell), (m["name"], cell)


@pytest.mark.parametrize("cfg", B["configs"], ids=lambda c: c["name"])
def test_config_file_loads_by_name(cfg):
    assert any(cfg["file"].startswith(p + "/") for p in B["paths"])
    data = harness.load_json(smallrun.ROOT / cfg["file"])
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    from perfbench.reference.oracles import load
    assert hasattr(load(data["design_model"]), "formula")
    files = [c["file"] for c in B["configs"]]
    assert files.count(cfg["file"]) == 1


@pytest.mark.parametrize("traffic", sorted({w["traffic"]
                                            for w in B["workloads"]}))
def test_traffic_file_loads_by_name(traffic):
    data = harness.load_json(harness.BENCH / "traffic" / f"{traffic}.json")
    driver = importlib.import_module(f"perfbench.drivers.{data['driver']}")
    for fn in ("setup", "window", "check", "control_checks"):
        assert callable(getattr(driver, fn))
    assert data["limits"] and all(v >= 0 for v in data["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in B["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    assert callable(harness.load_reader(metric))


def test_applies_follows_workloads_then_moves():
    m = {"name": "x", "moves": "a"}
    assert harness.applies(m, "c", ["a"]) and not harness.applies(m, "c", [])
    assert harness.applies(dict(m, workloads=["c"]), "c", [])
    assert not harness.applies(dict(m, workloads=["d"]), "c", ["a"])
