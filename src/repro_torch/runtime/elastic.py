"""Elastic scaling: rebuild the device grid when the device pool changes
(counterpart of :mod:`repro.runtime.elastic`).

When a host is drained (straggler, failure) or capacity is added, the job
re-forms: pick the largest (data x model) grid that fits the surviving
devices while keeping the model axis intact (the tensor-parallel degree is
fixed by the sharding strategy; data parallelism shrinks or grows), and
restore the checkpointed state onto the new grid. The global batch is kept
by rescaling the per-replica batch (the counter-based data makes this
exact). The JAX package builds an XLA ``Mesh``; the port's grid is a numpy
array of ``torch.device`` with the same axis names.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class ElasticPlan:
    data: int
    model: int
    dropped_devices: int
    per_replica_batch: int


@dataclass(frozen=True)
class DeviceGrid:
    """``devices`` (data, model) of ``torch.device``, axes ``axis_names``."""

    devices: np.ndarray
    axis_names: tuple = ("data", "model")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def plan_mesh(
    n_devices: int,
    model_parallel: int,
    global_batch: int,
    max_data: int | None = None,
) -> ElasticPlan:
    """Largest data axis that (a) fits the devices at fixed TP degree and
    (b) divides the global batch."""
    if n_devices < model_parallel:
        raise ValueError(
            f"need at least {model_parallel} devices for the model axis, "
            f"have {n_devices}"
        )
    data = n_devices // model_parallel
    while data > 1 and (global_batch % data != 0):
        data -= 1
    if max_data:
        data = min(data, max_data)
    used = data * model_parallel
    return ElasticPlan(
        data=data,
        model=model_parallel,
        dropped_devices=n_devices - used,
        per_replica_batch=global_batch // data,
    )


class ElasticMeshManager:
    """Holds the current device grid; re-plans it on membership change."""

    def __init__(self, model_parallel: int, global_batch: int):
        self.model_parallel = model_parallel
        self.global_batch = global_batch
        self.mesh = None
        self.plan = None

    def build(self, devices=None) -> DeviceGrid:
        """The grid over ``devices`` (default: every CUDA device)."""
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        self.plan = plan_mesh(len(devices), self.model_parallel, self.global_batch)
        used = self.plan.data * self.plan.model
        grid = np.empty(used, dtype=object)
        grid[:] = devices[:used]
        self.mesh = DeviceGrid(grid.reshape(self.plan.data, self.plan.model))
        return self.mesh

    def on_membership_change(self, surviving_devices) -> DeviceGrid:
        """Re-plan after losing or gaining devices; the caller restores the
        state onto the new grid from a checkpoint."""
        return self.build(surviving_devices)
