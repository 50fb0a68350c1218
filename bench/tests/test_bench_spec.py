"""BENCHMARK.json and the files it names: everything is found by name, and
names, units and entries keep to the benchmark's contract."""

import json
import re

import pytest

from bench.harness import spec
from bench.reference.arch import Arch

BENCH = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
WIDTHS = re.compile(r"(^hidden_size$|intermediate_size|latent|state_size|proj|_dim$|_rank$"
                    r"|experts_per_tok|expan)")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_and_names(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) <= KEYS[section], e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            if text is not None:
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_finds_its_files():
    for cell in BENCH["workloads"]:
        assert cell["chips"] == 1
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        config = spec.config(BENCH, cell["config"])
        mix = spec.mix(cell["traffic"])
        kind = spec.kind_module(mix["kind"])
        assert all(hasattr(kind, f) for f in ("setup", "window", "check"))
        assert spec.limits(cell["name"])
        Arch.from_config(config)
        for trace in (False, True):
            for m in spec.metrics_for(BENCH, cell["name"], trace):
                assert callable(spec.metric_reader(m["name"]))


def test_each_cell_reports_enough():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for cell in BENCH["workloads"]:
        mine = {m["name"] for m in spec.metrics_for(BENCH, cell["name"], False)}
        assert "setup_s" in mine and len(mine) >= 2
        layer = spec.metrics_for(BENCH, cell["name"], True)
        assert layer
        for m in layer:
            assert m["moves"] in mine, (cell["name"], m["name"])
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    cells = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def test_metrics_of_a_layer_share_its_name():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"train step", "serve fns", "kernels", "device"}
    assert all(m["name"].endswith("_roofline") for m in BENCH["per_layer"]
               if m["layer"] == "kernels")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    config = spec.config(BENCH, entry["name"])
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key) and not WIDTHS.search(key), key
        assert key in config
    assert config["assumed"] and config["deployment"]


def test_command_stays_inside_paths():
    cmd = BENCH["command"]
    assert len(cmd) <= 32 and cmd[1].startswith("bench/")
    assert not any(w.startswith("/") or ".." in w for w in cmd)
