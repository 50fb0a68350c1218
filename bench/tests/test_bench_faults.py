"""A whole run past the look for a card, on a small copy of each cell on
the CPU, with the timed path broken underneath: ``correct`` comes out false
for every fault the cell can have (a step that leaves its state as it was,
half of the batch left out with the mean over the rest, a token or answer
altered where it is produced; there is no exchange between cards to leave
out)."""

import subprocess
import sys
from pathlib import Path

import pytest

from bench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
FAULTS = [
    ("deepseek-moe-16b-l8.train-2k", "state_unchanged"),
    ("deepseek-moe-16b-l8.train-2k", "half_batch"),
    ("qwen3-1.7b.train-4k", "state_unchanged"),
    ("qwen3-1.7b.train-4k", "half_batch"),
    ("qwen3-1.7b.decode-32k", "token_altered"),
    ("qwen3-1.7b.decode-32k", "state_unchanged"),
]
CELLS = sorted({c for c, _ in FAULTS})


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_is_not_correct(cell, fault):
    """The fault fails a number that the sound run of the same seed passes
    (at this size the sound run can read over a limit set at the cell's
    own size, the float32 distance of a tiny model being larger)."""
    sound = tiny.run(cell)["checks"]
    out = tiny.run(cell, fault=fault)
    assert out["correct"] is False
    caught = [k for k, c in out["checks"].items()
              if c["value"] > c["limit"] and sound[k]["value"] <= sound[k]["limit"]]
    assert caught, (sound, out["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_reports_its_fields(cell):
    out = tiny.run(cell)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) >= {"setup_s"} and len(out["metrics"]) >= 2
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert all(c["value"] >= 0 for c in out["checks"].values())


def test_no_card_no_result():
    r = subprocess.run([sys.executable, "bench/run.py", "--workload", "qwen3-1.7b.decode-32k",
                        "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout == ""
