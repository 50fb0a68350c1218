"""Build the port's CUDA sources into shared libraries, at first CUDA use.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, which the kernel's
wrapper loads with :mod:`ctypes`. Nothing here runs when a module is
imported: the CPU tests import every module on machines without ``nvcc``.

The libraries go into ``src/repro_torch/_build/`` (listed in
``.gitignore``), named by a digest of the source, the shared headers and
the flags, so an edited source is rebuilt and an unchanged one is reused.
:func:`build` starts one ``nvcc`` for each source that needs it, all at
once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register/spill report) of each source built by this
# process, by source name
build_log: dict[str, str] = {}


def nvcc_path() -> str:
    """The ``nvcc`` of ``$CUDA_HOME`` (default ``/usr/local/cuda``), else
    the one on ``PATH``."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels are built with it at first use"
        )
    return found


def sources() -> list[str]:
    """Names of every CUDA source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile each named source (default: all) whose library is missing.

    Returns ``{name: library path}``. Raises with nvcc's output when any
    compile fails.
    """
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        for stale in BUILD_DIR.glob(f"lib{name}-*.so"):
            stale.unlink()
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """C function ``symbol`` of ``csrc/<name>.cu``'s library, typed. Pass
    every pointer, and the stream, as ``ctypes.c_void_p``: an untyped
    argument goes through ctypes as a 32-bit int and cuts a pointer."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def device_address(name: str, t) -> int:
    """The address a kernel of ``csrc/<name>.cu`` dereferences for tensor
    ``t``: its data pointer on the card, or, for a CPU tensor, the device
    address of its pinned host memory, read through unified virtual
    addressing. A CPU tensor that is not pinned, and mapped for the device,
    raises: there is no staging copy behind a kernel."""
    if t.device.type == "cuda":
        return t.data_ptr()
    query = function(name, f"{name}_host_device_ptr", [ctypes.c_void_p],
                     ctypes.c_ulonglong)
    addr = query(t.data_ptr())
    if not addr:
        raise ValueError(
            f"{name}: a host operand must be pinned memory the device can "
            "address (allocate it with pin_memory=True)"
        )
    return int(addr)


def to_device(t, dev):
    """Small host operand ``t`` (indices, lengths) on the card. The copy
    goes through pinned memory, so it does not wait for the stream; the
    pinned allocator keeps the buffer until the copy has run."""
    if t.device.type == "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)
