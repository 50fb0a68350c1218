"""Tiering of the port: the standalone page pool the KV cache runs on, the
sweep's slice-pool control plane, and the TPP policy parameters the
device sweep step reads (counterpart of :mod:`repro.tiering`)."""
