"""The run's surroundings: cache directories inside the checkout, the card,
the JAX check, seeds and the card's power limit."""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def set_cache_dirs(root: Path) -> None:
    """Kernel and build caches at fixed paths inside the checkout, so that
    only a checkout's first run builds (the port's own libraries go to
    ``src/repro_torch/_build/``, a fixed path of the checkout too)."""
    cache = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's, the JAX
    package's or the JAX benchmarks' (compared whole: ``repro_torch`` is not
    ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def subseed(seed: int, *parts) -> int:
    """A 63-bit seed for one purpose, from the run's seed."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def power_limit_w():
    """The card's power limit in watts (``nvidia-smi``), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
