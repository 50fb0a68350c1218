"""Analytic roofline of the port (counterpart of :mod:`repro.roofline`):
per-(config, shape) FLOPs and HBM bytes, and the terms on one H100 SXM.
``hlo_stats`` is not ported: it parses XLA's HLO, which the port has not."""

from repro_torch.roofline.analytic import cell_flops, cell_hbm_bytes, forward_flops
from repro_torch.roofline.report import HW, HWConsts, roofline_terms

__all__ = ["HW", "HWConsts", "cell_flops", "cell_hbm_bytes", "forward_flops",
           "roofline_terms"]
