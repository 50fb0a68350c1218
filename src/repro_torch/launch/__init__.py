"""Launch entry points of the port (counterpart of :mod:`repro.launch`):
serving on one card so far."""
