"""Command-line drivers of the port (the twin of :mod:`repro.launch`)."""
