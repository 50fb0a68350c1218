"""Tuna core, ported: telemetry, micro-benchmark generator, performance
database, tuner and watermark controller (counterpart of :mod:`repro.core`).
Host-side numpy code, copied so that the port never imports ``repro``."""
