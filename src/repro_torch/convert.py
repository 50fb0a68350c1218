"""Carry state across from the JAX package as plain arrays and dicts.

The port imports nothing of :mod:`repro`. What crosses between the two
packages is plain data: numpy arrays, numbers, strings and dicts of them.
These functions turn such data into the port's objects, and read the same
plain data off any object shaped like a trace, so the tests can feed the
same inputs to both packages.

* a trace: ``{"name", "rss_pages", "num_threads", "slow_pages",
  "intervals": [{"pages", "counts", "touches", "ops", "rand_frac"}, ...]}``;
* a performance database: records ``{"config": {ConfigVector fields},
  "fm_fracs", "times"}``;
* a tuner configuration: the :class:`~repro_torch.core.tuner.TunerConfig`
  fields;
* a KV page configuration and a hardware tier profile: their dataclass
  fields;
* a page pool: a numpy array, whose bfloat16 (``ml_dtypes``, as the JAX
  package's host pool holds it) crosses as its ``uint16`` bits.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.perfdb import PerfDB, PerfRecord
from repro_torch.core.telemetry import ConfigVector
from repro_torch.core.trace import IntervalAccess, Trace
from repro_torch.core.tuner import TunerConfig
from repro_torch.serving.kv_cache import KVPageConfig
from repro_torch.sim.costmodel import HardwareProfile


def trace_dict(trace) -> dict:
    """The plain-data form of any trace-shaped object (the port's
    :class:`~repro_torch.core.trace.Trace` or the JAX package's)."""
    return {
        "name": trace.name,
        "rss_pages": int(trace.rss_pages),
        "num_threads": int(trace.num_threads),
        "slow_pages": (
            None if trace.slow_pages is None else np.asarray(trace.slow_pages)
        ),
        "intervals": [
            {
                "pages": np.asarray(ia.pages),
                "counts": np.asarray(ia.counts),
                "touches": np.asarray(ia.touches),
                "ops": float(ia.ops),
                "rand_frac": float(ia.rand_frac),
            }
            for ia in trace
        ],
    }


def trace_from_dict(d: dict) -> Trace:
    """A port :class:`~repro_torch.core.trace.Trace` from its plain form."""
    slow = d.get("slow_pages")
    return Trace(
        name=d["name"],
        rss_pages=int(d["rss_pages"]),
        intervals=[
            IntervalAccess(
                pages=iv["pages"],
                counts=iv["counts"],
                ops=iv["ops"],
                rand_frac=iv.get("rand_frac", 1.0),
                touches=iv.get("touches"),
            )
            for iv in d["intervals"]
        ],
        num_threads=int(d.get("num_threads", 1)),
        slow_pages=None if slow is None else np.asarray(slow, dtype=np.int64),
    )


def config_from_dict(d: dict) -> ConfigVector:
    """A :class:`~repro_torch.core.telemetry.ConfigVector` from its fields."""
    return ConfigVector(**d)


def perfdb_from_records(records) -> PerfDB:
    """A built :class:`~repro_torch.core.perfdb.PerfDB` from plain records
    ``{"config": {...}, "fm_fracs": array, "times": array}``, in order."""
    db = PerfDB()
    for r in records:
        db.add(
            PerfRecord(
                config=config_from_dict(r["config"]),
                fm_fracs=np.asarray(r["fm_fracs"], dtype=np.float64),
                times=np.asarray(r["times"], dtype=np.float64),
            )
        )
    db.build()
    return db


def tuner_config_from_dict(d: dict) -> TunerConfig:
    """A :class:`~repro_torch.core.tuner.TunerConfig` from its fields."""
    return TunerConfig(**d)


def kv_page_config_from_dict(d: dict) -> KVPageConfig:
    """A :class:`~repro_torch.serving.kv_cache.KVPageConfig` from its
    fields (``dtype`` by name, e.g. ``"bfloat16"``)."""
    return KVPageConfig(**d)


def hardware_profile_from_dict(d: dict) -> HardwareProfile:
    """A :class:`~repro_torch.sim.costmodel.HardwareProfile` from its
    fields."""
    return HardwareProfile(**d)


def pool_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A page pool as a CPU tensor with the same bits. A bfloat16 array
    (numpy has no bfloat16 of its own) is read through its ``uint16``
    view."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def pool_bits(t: torch.Tensor) -> np.ndarray:
    """The raw bits of a pool as a numpy array (``uint16`` for a 2-byte
    dtype such as bfloat16, the array itself otherwise), for exact
    comparison with the JAX package's pools."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
        return t.numpy().view(np.uint16)
    return t.numpy()
