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
* a fleet arbitration policy: the
  :class:`~repro_torch.fleet.arbiter.ArbiterSpec` fields (a fault model
  crosses through :meth:`repro_torch.sim.faults.FaultSpec.from_dict`, a
  fleet's tenant traces as traces);
* a KV page configuration and a hardware tier profile: their dataclass
  fields;
* a page pool: a numpy array, whose bfloat16 (``ml_dtypes``, as the JAX
  package's host pool holds it) crosses as its ``uint16`` bits;
* model parameters: the JAX ``init_model`` pytree as nested dicts of numpy
  arrays, each block group's leaves stacked on a leading ``G`` axis, which
  the port unstacks into one dict a layer (bfloat16 again as ``uint16``
  bits on the way back);
* an AdamW state: ``{"m", "v", "step"}``, ``m`` and ``v`` laid out as the
  parameters (float32 or bfloat16), ``step`` an int32 scalar.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.perfdb import PerfDB, PerfRecord
from repro_torch.core.telemetry import ConfigVector
from repro_torch.core.trace import IntervalAccess, Trace
from repro_torch.core.tuner import TunerConfig
from repro_torch.fleet.arbiter import ArbiterSpec
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
                "writes": (
                    None if getattr(ia, "writes", None) is None
                    else np.asarray(ia.writes)
                ),
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
                writes=iv.get("writes"),
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


def arbiter_spec_from_dict(d: dict) -> ArbiterSpec:
    """A :class:`~repro_torch.fleet.arbiter.ArbiterSpec` from its fields."""
    return ArbiterSpec(**d)


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


def _model_tensor(a) -> torch.Tensor:
    return pool_from_numpy(np.asarray(a))


def _group_slice(tree, g: int):
    """Group ``g``'s slice of each leaf of a stacked dict, nested dicts (an
    MoE FFN's ``shared`` MLP) included."""
    if isinstance(tree, dict):
        return {k: _group_slice(v, g) for k, v in tree.items()}
    return _model_tensor(np.asarray(tree)[g])


def _group_stack(trees: list):
    """The inverse of :func:`_group_slice`: the layers' leaves stacked."""
    if isinstance(trees[0], dict):
        return {k: _group_stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([pool_bits(t) for t in trees])


_LAYER_PARTS = ("ln1", "mix", "ln2", "ffn", "lnx", "xattn")


def _layers_from_groups(groups: dict, n_groups: int, group_size: int) -> list:
    """Group ``g``'s block ``i`` as layer ``g * group_size + i``: its
    ``b{i}_{part}`` entries, sliced at ``g``, as the layer's ``part``."""
    return [{part: _group_slice(groups[f"b{i}_{part}"], g)
             for part in _LAYER_PARTS if f"b{i}_{part}" in groups}
            for g in range(n_groups) for i in range(group_size)]


def _groups_from_layers(layers: list, n_groups: int, group_size: int) -> dict:
    """The inverse of :func:`_layers_from_groups`."""
    groups = {}
    for i in range(group_size):
        for part in layers[i]:
            groups[f"b{i}_{part}"] = _group_stack(
                [layers[g * group_size + i][part] for g in range(n_groups)])
    return groups


def model_params_from_jax(tree: dict, cfg) -> dict:
    """The port's parameters (CPU tensors) from the JAX package's
    ``init_model`` pytree given as numpy arrays. Group ``g``'s block ``i``
    becomes layer ``g * len(block_pattern) + i``: its ``b{i}_ln1``,
    ``b{i}_mix``, ``b{i}_ln2``, ``b{i}_ffn`` and, for an encoder arch's
    cross-attention, ``b{i}_lnx`` and ``b{i}_xattn`` entries, sliced at
    ``g``, become the layer's ``ln1``, ``mix``, ``ln2``, ``ffn``, ``lnx``
    and ``xattn``. The ``encoder`` subtree (its ``groups`` stacked over
    ``encoder_layers``, one block each) becomes ``{"layers", "final_norm",
    "pos_embed"}`` the same way."""
    params = {
        "embed": _model_tensor(tree["embed"]),
        "final_norm": {k: _model_tensor(v) for k, v in tree["final_norm"].items()},
        "layers": _layers_from_groups(tree["groups"], cfg.num_groups, cfg.group_size),
    }
    if "lm_head" in tree:
        params["lm_head"] = _model_tensor(tree["lm_head"])
    if "encoder" in tree:
        enc = tree["encoder"]
        params["encoder"] = {
            "layers": _layers_from_groups(enc["groups"], cfg.encoder_layers, 1),
            "final_norm": {k: _model_tensor(v) for k, v in enc["final_norm"].items()},
            "pos_embed": _model_tensor(enc["pos_embed"]),
        }
    return params


def params_from_model(params: dict, cfg) -> dict:
    """The inverse of :func:`model_params_from_jax`: the JAX pytree layout
    as numpy arrays (layers stacked per group again; bfloat16 as ``uint16``
    bits)."""
    tree = {
        "embed": pool_bits(params["embed"]),
        "final_norm": {k: pool_bits(v) for k, v in params["final_norm"].items()},
        "groups": _groups_from_layers(params["layers"], cfg.num_groups, cfg.group_size),
    }
    if "lm_head" in params:
        tree["lm_head"] = pool_bits(params["lm_head"])
    if "encoder" in params:
        enc = params["encoder"]
        tree["encoder"] = {
            "groups": _groups_from_layers(enc["layers"], cfg.encoder_layers, 1),
            "final_norm": {k: pool_bits(v) for k, v in enc["final_norm"].items()},
            "pos_embed": pool_bits(enc["pos_embed"]),
        }
    return tree


def opt_state_from_jax(state: dict, cfg) -> dict:
    """The port's AdamW state (CPU tensors) from the JAX package's
    ``adamw().init`` / ``update`` state given as numpy arrays: ``m`` and
    ``v`` unstacked as :func:`model_params_from_jax` unstacks the weights."""
    return {
        "m": model_params_from_jax(state["m"], cfg),
        "v": model_params_from_jax(state["v"], cfg),
        "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32),
    }


def opt_state_to_jax(state: dict, cfg) -> dict:
    """The inverse of :func:`opt_state_from_jax`: the JAX layout as numpy
    arrays (bfloat16 state as ``uint16`` bits)."""
    return {
        "m": params_from_model(state["m"], cfg),
        "v": params_from_model(state["v"], cfg),
        "step": np.asarray(int(state["step"]), dtype=np.int32),
    }
