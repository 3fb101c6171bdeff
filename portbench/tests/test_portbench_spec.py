"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files found by name, and every per-layer metric's ``moves`` reported by
each of its cells."""

import json
import re

import pytest

from portbench.harness import HERE, ROOT, load_benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
# every run with --trace 0 reports these
REPORTED = {"diar_audio_s_per_s", "setup_s"}


@pytest.fixture(scope="module")
def bench():
    return load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_names_and_units(bench, section):
    names = [entry["name"] for entry in bench[section]]
    assert len(names) == len(set(names))
    for entry in bench[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(entry) <= KEYS[section] | extra
        assert NAME.match(entry["name"])
        if "unit" in entry:
            assert UNIT.match(entry["unit"])
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in entry and section in ("configs", "workloads",
                                            "per_layer"):
                value = entry[key]
                assert 1 <= len(value) <= 200 and "\n" not in value \
                    and "\t" not in value


def test_cells_find_their_files(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for cell in bench["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert cell["chips"] == 1
        entry = configs[cell["config"]]
        assert (ROOT / entry["file"]).is_file()
        assert (HERE / "configs" / f"{entry['name']}.py").is_file()
        assert (HERE / "traffic" / f"{cell['traffic']}.json").is_file()
        config = json.loads((ROOT / entry["file"]).read_text())
        assert set(entry["reduced"]) <= set(config)
    for metric in bench["per_layer"]:
        assert (HERE / "metrics" / f"{metric['name']}.py").is_file()


def test_end_to_end_bounds(bench):
    names = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in names
    for metric in bench["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_moves_is_reported_by_every_listed_cell(bench):
    cells = {c["name"] for c in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert set(e2e) == REPORTED
    for metric in bench["per_layer"]:
        assert metric["moves"] in e2e
        listed = metric.get("workloads", sorted(cells))
        assert set(listed) <= cells
        reporters = e2e[metric["moves"]].get("workloads", sorted(cells))
        assert set(listed) <= set(reporters)
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")


def test_shares_are_named_as_the_contract_asks(bench):
    for metric in bench["per_layer"]:
        if metric["unit"] == "%" and "roofline" in metric["name"]:
            assert metric["name"].endswith("_roofline")
    assert any("mfu" in m["name"] for m in bench["per_layer"])
