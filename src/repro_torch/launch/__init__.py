"""Launch entry points of the port (counterpart of :mod:`repro.launch`):
serving and training on one card."""
