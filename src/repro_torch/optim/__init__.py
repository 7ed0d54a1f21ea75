"""AdamW for the port (the twin of :mod:`repro.optim`)."""
