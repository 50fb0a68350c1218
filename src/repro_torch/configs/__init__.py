"""Architecture registry of the port: ``get_config(name)``
(counterpart of :mod:`repro.configs`)."""

from repro_torch.configs.registry import (
    ARCHS,
    PORTED_ARCHS,
    SHAPES,
    ShapeSpec,
    arch_shape_cells,
    get_config,
)

__all__ = ["ARCHS", "PORTED_ARCHS", "SHAPES", "ShapeSpec", "arch_shape_cells",
           "get_config"]
