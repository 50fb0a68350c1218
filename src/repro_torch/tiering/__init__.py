"""Tiering of the port: the slice pool's control plane and the TPP policy
parameters the device sweep step reads (counterpart of
:mod:`repro.tiering`)."""
