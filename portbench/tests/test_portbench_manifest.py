"""BENCHMARK.json against the benchmark's contract, and discovery of
every configuration, traffic mix and per-layer metric by its name."""

import importlib
import json
import re

import pytest

from portbench import harness, traffic

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.manifest()
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source",
                   "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_names_units_and_keys(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(set(names)) == len(names)
    for e in BENCH[section]:
        assert set(e) <= ENTRY_KEYS[section], e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key], (e["name"], key)


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def reported(metric: dict) -> list[str]:
    return metric.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in reported(m)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(w["name"] in reported(m) for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_moves_names_an_end_to_end_metric_of_each_of_its_cells(metric):
    m = {x["name"]: x for x in BENCH["per_layer"]}[metric]
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for cell in reported(m):
        assert cell in reported(e2e[m["moves"]])
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")


def test_layers_of_one_name_are_spelled_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    text = (harness.ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in text, layer


def test_cells_configs_and_mixes_resolve_by_name():
    configs = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        cell, config, mix = harness.load_cell(w["name"], BENCH)
        assert (harness.ROOT / config["dna"]).exists()
        assert (harness.ROOT / config["lncrna"]).exists()
        assert mix["records_per_job"] <= len(
            traffic.raw_records(harness.ROOT / config["dna"]))
        harness.params_of(config)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("portbench/configs/")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_are_found_by_name(metric):
    mod = importlib.import_module(f"portbench.metrics.{metric}")
    assert callable(mod.read)


def test_four_chip_cells_are_at_most_a_quarter():
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_params_of_skips_the_ports_own_flags():
    """`--tpu-<name> <value>` pairs go to cli.main alone; every other
    flag the reference's table lacks is refused."""
    p = harness.params_of({"flags": ["--tpu-stream", "on", "-c", "4000",
                                     "--tpu-engine", "torch"]})
    assert p.cut_length == 4000
    assert harness.params_of({"flags": ["--tpu-stream", "on"]}) == \
        harness.params_of({"flags": []})
    with pytest.raises(ValueError, match="-X"):
        harness.params_of({"flags": ["--tpu-stream", "on", "-X", "1"]})
