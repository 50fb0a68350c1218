from repro_torch.runtime.elastic import ElasticMeshManager
from repro_torch.runtime.fault_tolerance import StepWatchdog, StragglerMonitor, retry_step

__all__ = [
    "StepWatchdog",
    "retry_step",
    "StragglerMonitor",
    "ElasticMeshManager",
]
