"""Simulator of the port: cost model, workloads, the device sweep step,
the batched sweeps and the experiment API (counterpart of
:mod:`repro.sim`)."""
