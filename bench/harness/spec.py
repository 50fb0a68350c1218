"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<config>.json``, a traffic mix
``mixes/<traffic>.json`` (its ``kind`` names the module
``kinds/<kind>.py``), a cell's limits ``limits/<cell>.json`` and a metric
``metrics/<metric>.py``; a metric ``<name>.<part>`` without a file of its
own (one quantity split by the cells it is read in, as
``train_tokens_per_s.moe``) is read by ``metrics/<name>.py``. A later cell,
mix or metric is new files and new entries, never an edit."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _entry(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _entry(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    entry = _entry(bench["configs"], name, "configuration")
    with open(ROOT / entry["file"]) as f:
        return json.load(f)


def mix(name: str) -> dict:
    with open(BENCH / "mixes" / f"{name}.json") as f:
        return json.load(f)


def limits(cell_name: str) -> dict:
    with open(BENCH / "limits" / f"{cell_name}.json") as f:
        return json.load(f)["limits"]


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a cell reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``; an entry
    without ``workloads`` belongs to every cell."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell_name in m.get("workloads", [cell_name])]


def _load_file(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``read(run) -> float | None`` of ``metrics/<name>.py``, or of the
    file of the longest dotted prefix of ``name`` that has one."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = BENCH / "metrics" / (".".join(parts[:n]) + ".py")
        if path.exists():
            return _load_file(path, f"bench_metric_{name}").read
    raise FileNotFoundError(f"no reader for metric {name!r} under {BENCH / 'metrics'}")


def kind_module(kind: str):
    """The module ``kinds/<kind>.py``: ``setup``, ``window``, ``check``."""
    return _load_file(BENCH / "kinds" / f"{kind}.py", f"bench_kind_{kind}")
