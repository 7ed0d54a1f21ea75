"""Serving steps of the port (the twin of :mod:`repro.serve`)."""
