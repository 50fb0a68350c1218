"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version and a launch counter (counterpart of :mod:`repro.kernels`).

CUDA sources live in ``repro_torch/csrc/`` and are built by
:mod:`repro_torch.kernels._build` at first CUDA use, never at import.
"""
