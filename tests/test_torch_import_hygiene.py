"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the ``repro`` package, and
importing every port module loads neither."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and _forbidden(str(arg.value)):
                bad.append(arg.value)
    assert not bad, f"{path.name} imports {bad}"


def test_importing_every_port_module_loads_neither_jax_nor_repro():
    modules = sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts).removesuffix(
            ".__init__"
        )
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _loaded_forbidden(scenario, fm_frac, spec, db):
    """A custom runner: which forbidden packages its process has loaded."""
    return {"pid": os.getpid(),
            "forbidden": sorted(m for m in sys.modules if _forbidden(m))}


def test_spawned_fanout_workers_load_neither_jax_nor_repro():
    """The experiment API's spawned workers import the port alone: the job
    (the port's specs, the policy classes, this runner) pulls in nothing
    of JAX or the JAX package."""
    from repro_torch.sim import api

    rs = api.run(
        api.Experiment(scenarios=[api.Scenario(name=f"s{i}", runner=_loaded_forbidden)
                                  for i in range(2)]),
        parallelism=2, mp_start_method="spawn", scenario_timeout=120.0, device="cpu",
    )
    assert rs.fanout is not None
    for payload in rs.results():
        assert payload["pid"] != os.getpid()
        assert payload["forbidden"] == []


# TUNA010 for the port: the timing engine measures the interval cost model,
# so it is built of none of the engines that run it, and its replays are
# seeded, never timed by a wall clock
TIMING = sorted((PORT / "timing").glob("*.py"))
_INTERVAL_ENGINES = ("repro_torch.sim.engine", "repro_torch.sim.sweep",
                     "repro_torch.sim.torch_engine")
_WALL_CLOCKS = {"time", "time_ns", "perf_counter", "perf_counter_ns", "monotonic",
                "monotonic_ns", "process_time", "process_time_ns", "clock_gettime",
                "now", "utcnow"}


@pytest.mark.parametrize("path", TIMING, ids=lambda p: str(p.relative_to(REPO)))
def test_timing_engine_stays_independent(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
            if node.module in ("time", "datetime"):
                bad += [f"from {node.module} import {a.name}" for a in node.names]
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            owner = getattr(node.func.value, "id", None) or getattr(node.func.value, "attr", None)
            if owner in ("time", "datetime") and node.func.attr in _WALL_CLOCKS:
                bad.append(f"{owner}.{node.func.attr}()")
        bad += [n for n in names
                if any(n == m or n.startswith(m + ".") for m in _INTERVAL_ENGINES)]
    assert not bad, f"{path.name}: {bad}"


def test_importing_the_timing_engine_loads_no_interval_engine():
    code = (
        "import sys\n"
        "import repro_torch.timing\n"
        f"bad = sorted(m for m in sys.modules if m in {_INTERVAL_ENGINES!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
