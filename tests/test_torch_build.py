"""Kernel builds are safe when processes build at once (the experiment
API's fan-out workers), on the CPU with a fake ``nvcc`` that copies its
source to its output.

Two processes build the same sources against one build directory. The
faster one publishes first and then watches every path its ``build``
returned until the slower one has published too: no path may vanish in
between (a sweep of stale libraries must not take the one another process
just published), and the stale library of another digest is gone.
"""

import json
import os
import stat
import subprocess
import sys
import textwrap
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
N_SOURCES = 12

FAKE_NVCC = """\
#!{python}
import os, shutil, sys, time
args = sys.argv[1:]
time.sleep(float(os.environ["FAKE_NVCC_SLEEP"]))
shutil.copyfile(args[-1], args[args.index("-o") + 1])
"""

WORKER = """
import json, os, sys, time
from pathlib import Path
from repro_torch.kernels import _build

_build.CSRC = Path(sys.argv[1])
_build.BUILD_DIR = Path(sys.argv[2])
role, go, done, out = sys.argv[3], Path(sys.argv[4]), Path(sys.argv[5]), Path(sys.argv[6])
Path(str(out) + ".ready").write_text("ready")
while not go.exists():
    time.sleep(0.001)
paths = _build.build()
missing_at_return = [str(p) for p in paths.values() if not p.exists()]
vanished = set()
if role == "fast":
    # watch until the slow builder has published everything
    deadline = time.time() + 60
    while not done.exists() and time.time() < deadline:
        for p in paths.values():
            if not os.path.exists(p):
                vanished.add(str(p))
else:
    done.write_text("done")
out.write_text(json.dumps({"paths": [str(p) for p in paths.values()],
                           "missing_at_return": missing_at_return,
                           "vanished": sorted(vanished)}))
"""


def test_concurrent_builds_keep_every_returned_library(tmp_path):
    csrc, build_dir, bin_dir = tmp_path / "csrc", tmp_path / "build", tmp_path / "cuda" / "bin"
    for d in (csrc, build_dir, bin_dir):
        d.mkdir(parents=True)
    for i in range(N_SOURCES):
        (csrc / f"k{i}.cu").write_text(f"// source {i}\n")
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    stale = build_dir / "libk0-0000000000000000.so"  # another digest's library
    stale.write_text("old")
    go, done = tmp_path / "go", tmp_path / "done"
    procs = {}
    for role, delay in (("fast", "0.2"), ("slow", "1.5")):
        env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
               "CUDA_HOME": str(tmp_path / "cuda"), "FAKE_NVCC_SLEEP": delay}
        procs[role] = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(WORKER), str(csrc), str(build_dir), role,
             str(go), str(done), str(tmp_path / f"{role}.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.time() + 120
    while time.time() < deadline and not all(
            (tmp_path / f"{role}.json.ready").exists() for role in procs):
        time.sleep(0.01)
    go.write_text("go")  # both interpreters up and waiting: they start together
    for role, proc in procs.items():
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, f"{role}: {out}"
    results = {role: json.loads((tmp_path / f"{role}.json").read_text()) for role in procs}
    assert results["fast"]["paths"] == results["slow"]["paths"]
    assert len(results["fast"]["paths"]) == N_SOURCES
    for role, res in results.items():
        assert res["missing_at_return"] == [], role
        assert res["vanished"] == [], role
        assert all(Path(p).exists() for p in res["paths"]), role
    assert not stale.exists()
    # the libraries are the sources, and no temporary file is left over
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(
        Path(p).name for p in results["fast"]["paths"])
