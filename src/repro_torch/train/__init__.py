"""Training: steps, checkpoints and the FALCON trainer (the twin of :mod:`repro.train`)."""
